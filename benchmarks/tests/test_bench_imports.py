"""No run loads JAX or the JAX package (top-level names compared whole: the
port's name begins with the JAX package's), and the references load nothing
of the port."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmarks import harness


def modules_after(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_of_every_cell_loads_no_jax():
    names = modules_after(
        "from benchmarks.tests.tiny_cells import run_tiny\n"
        "for c in ('fuse-explore', 'render-views'):\n"
        "    assert run_tiny(c)['correct']\n")
    assert "surfelmapping_tpu_torch" in names
    assert not set(names) & set(harness.FORBIDDEN)


def test_the_references_load_nothing_of_the_port():
    names = modules_after(
        "import benchmarks.reference.mapping.step, benchmarks.reference.mapping.splat\n")
    assert "surfelmapping_tpu_torch" not in names
    assert not set(names) & set(harness.FORBIDDEN)


def test_the_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["surfelmapping_tpu_torch.ops", "jaxtyping"]) == []
    assert harness.forbidden_modules(["surfelmapping_tpu.ops", "jax.numpy", "flax"]) == \
        ["flax", "jax", "surfelmapping_tpu"]
