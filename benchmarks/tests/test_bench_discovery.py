"""The harness finds every piece of a cell by its name, BENCHMARK.json keeps
to the benchmark's contract, and a new cell, configuration, mix and
per-layer metric are new files and new entries only."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from benchmarks import harness

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in SPEC["end_to_end"])
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"])
        layers.setdefault(m["layer"], m["layer"])
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(SPEC["workloads"]) // 4)
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_finds_its_files_and_reports_what_it_should(cell):
    c = harness.find_cell(cell)
    assert c.driver().setup and c.driver().window and c.driver().check
    assert c.generator()
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert Path(harness.HERE / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=[m["name"] for m in SPEC["per_layer"]])
def test_each_reader_declares_what_benchmark_json_says(metric):
    r = harness.reader(metric["name"])
    assert r.LAYER == metric["layer"] and r.MOVES == metric["moves"]
    assert all(w.startswith(r.FAMILY) for w in metric["workloads"])


def test_a_new_cell_is_new_files_and_entries_only(tmp_path):
    """Copy the benchmark, add a dummy configuration, mix, cell, driver and
    per-layer metric as new files and entries, and run the dummy cell (on
    the CPU, past the look for a card) through the unchanged harness."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmarks").rglob("*") if p.is_file()}
    spec = dict(SPEC)
    spec["configs"] = SPEC["configs"] + [{"name": "dummy-config", "source": "https://example.org",
                                          "file": "benchmarks/configs/dummy-config.json",
                                          "reduced": [], "why": "a test"}]
    spec["workloads"] = SPEC["workloads"] + [{"name": "dummy-cell", "config": "dummy-config",
                                              "traffic": "dummy-mix", "chips": 1, "why": "a test"}]
    spec["end_to_end"] = SPEC["end_to_end"] + [{"name": "dummies_per_s", "unit": "dummies/s",
                                                "better": "higher", "bound": 0.05,
                                                "source": "host_clock",
                                                "workloads": ["dummy-cell"]}]
    spec["per_layer"] = SPEC["per_layer"] + [{"name": "dummy.count", "unit": "count",
                                              "better": "lower", "source": "program_counter",
                                              "layer": "dummy", "moves": "dummies_per_s",
                                              "workloads": ["dummy-cell"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    b = root / "benchmarks"
    (b / "configs" / "dummy-config.json").write_text('{"size": 3}')
    (b / "traffic" / "dummy-mix.json").write_text('{"generator": "dummy", "n": 5}')
    (b / "traffic" / "dummy.py").write_text("def items(mix):\n    return list(range(mix['n']))\n")
    (b / "workloads" / "dummy-cell.json").write_text('{"driver": "dummy", "limits": {"gap": 0}}')
    (b / "drivers" / "dummy.py").write_text(textwrap.dedent("""
        import time

        def setup(ctx):
            return {"items": ctx.cell.generator().items(ctx.cell.traffic)}

        def window(st, ctx):
            ctx.window_started(time.perf_counter())
            return {"attempted": len(st["items"]), "failed": 0, "seconds": 1.0,
                    "metrics": {"dummies_per_s": float(len(st["items"]))},
                    "records": {"count": ctx.cell.config["size"]}}

        def check(st, ctx):
            return {"gap": (0, ctx.cell.settings["limits"]["gap"])}
    """))
    (b / "metrics" / "dummy.count.py").write_text(
        'LAYER = "dummy"\nMOVES = "dummies_per_s"\nFAMILY = "dummy"\n\n'
        'def read(records):\n    return records["count"]\n')
    code = textwrap.dedent("""
        import json, time, torch
        from benchmarks.run import run_cell
        out = [run_cell("dummy-cell", 5, 1.0, t, False, torch.device("cpu"),
                        t_process=time.perf_counter()) for t in (False, True)]
        print(json.dumps(out))
    """)
    done = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    plain, traced = json.loads(done.stdout.strip().splitlines()[-1])
    assert plain["correct"] and plain["metrics"]["dummies_per_s"]["value"] == 5.0
    assert set(plain["metrics"]) == {"dummies_per_s", "setup_s"}
    assert traced["metrics"] == {"dummy.count": {"value": 3, "unit": "count"}}
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} changed"
