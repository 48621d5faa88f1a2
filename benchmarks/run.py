"""Run one cell of the benchmark once.

    python3 -m benchmarks.run --workload NAME --seed N --seconds S --trace 0|1

Everything the cell needs is found by its name in ``BENCHMARK.json`` and the
files under ``benchmarks/`` (see ``benchmarks/harness.py``).  Set-up makes
the inputs on the device from the seed and warms every shape the window
uses; the window measures for ``--seconds``; then the program's outputs are
held to the plain reference under ``benchmarks/reference/``.  The last
lines on standard error give each number compared beside its limit; the
last line on standard output is the result as one JSON object.

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a torch.profiler trace of a stretch of the window.
``--control 1`` puts the reference held in bfloat16 in the program's place
in the comparison, which has to come out not correct (the check of the
check; the benchmark's timed runs never pass it).
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # noqa: E402  (set-up runs from process start)

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


class Context:
    """What a driver is given: the cell, the run's arguments, the device."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, control: bool,
                 device, t_process: float):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.control, self.device = trace, control, device
        self.t_process = t_process
        self.t_window = None
        self.notes: dict = {}  # set-up's parts and other readings, beside the result

    def window_started(self, t: float) -> None:
        self.t_window = t


def run_cell(name: str, seed: int, seconds: float, trace: bool, control: bool, device,
             cell=None, t_process: float | None = None) -> dict:
    """Set-up, window and check of one cell on ``device``; returns the
    result object (without the device's own description)."""
    import torch

    from benchmarks import harness

    cell = cell or harness.find_cell(name)
    ctx = Context(cell, seed, seconds, trace, control, device,
                  T_PROCESS if t_process is None else t_process)
    drv = cell.driver()
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    state = drv.setup(ctx)
    gc.collect()  # set-up's garbage goes now, not inside the window
    before = harness.host_sample()
    win = drv.window(state, ctx)
    after = harness.host_sample()
    setup_s = ctx.t_window - ctx.t_process
    ctx.notes["window_cpu_s"] = after["cpu_s"] - before["cpu_s"]
    ctx.notes["host_load"] = after["load"]
    if before["steal_s"] is not None and after["steal_s"] is not None:
        ctx.notes["host_steal_s"] = after["steal_s"] - before["steal_s"]
    found = harness.forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {found}: no run may load JAX or the JAX package")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    t_check = time.perf_counter()
    compared = drv.check(state, ctx)
    ctx.notes["check_s"] = time.perf_counter() - t_check
    correct = all(v <= lim for v, lim in compared.values())
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        rec = win["records"]
        values = {}
        if rec is not None:
            for m in cell.per_layer:
                v = harness.reader(m["name"]).read(rec)
                if v is not None:
                    values[m["name"]] = v
    else:
        values = dict(win["metrics"], setup_s=setup_s)
    result = {
        "correct": correct,
        "attempted": win["attempted"],
        "failed": win["failed"],
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
        "memory_peak_bytes": peak,
        "window_s": win["seconds"],
        "setup_s": setup_s,
        "notes": dict(ctx.notes, live_surfels=win.get("live_surfels")),
    }
    rec = win["records"] if trace else None
    if rec is not None:
        for key, name in (("busy_s", "busy_s"), ("window_s", "traced_window_s"),
                          ("breakdown", "breakdown")):
            if key in rec:
                result[name] = rec[key]
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmarks import harness

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); {n} found",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   bool(args.control), device, cell=cell)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        device_info["busy_s"] = res.get("busy_s", 0.0)
        device_info["window_s"] = res.get("traced_window_s", 0.0)
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"], "device": device_info}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["window_s"] = res["window_s"]
    line["notes"] = dict(res["notes"], card=power_limit())
    line["compared"] = res["compared"]
    for k, c in res["compared"].items():
        print(f"compared {k} = {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def power_limit() -> str | None:
    """The card's name and power limit from ``nvidia-smi``, as a note beside
    the numbers (None where it cannot be read)."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
