"""The ``spade-dp4`` cell on the CPU at a tiny size (two gloo ranks,
``tiny_spade.py``): an honest run is correct; a program with a fault, or
in TF32 (``--control 1``), is not; a program without the cell's iteration
function fails at once; the reference loads nothing of the port."""

from __future__ import annotations

import time

import pytest
import torch

from benchmarks import harness
from benchmarks.run import run_cell
from benchmarks.tests.test_bench_imports import modules_after
from benchmarks.tests.tiny_cells import SEED
from benchmarks.tests.tiny_spade import run_tiny_spade, tiny_spade_cell


def test_an_honest_run_is_correct():
    res = run_tiny_spade()
    assert res["correct"], res["compared"]
    assert res["attempted"] >= 8 and res["metrics"]["frames_per_s"]["value"] > 0
    assert res["compared"]["param_mismatch"]["value"] == 0


@pytest.mark.parametrize("fault, caught_by", [
    ("local_bn", "step_rel_err"), ("drop_rank", "step_rel_err"), ("no_vgg", "step_rel_err"),
    ("no_update", "step_rel_err"), ("half_lr", "step_rel_err"), ("no_flip", "rows_mismatch")])
def test_a_fault_in_the_program_is_not_correct(fault, caught_by, monkeypatch):
    drv = harness.find_cell("spade-dp4").driver()
    monkeypatch.setattr(drv, "RANK_MODULE", "benchmarks.tests.spade_faults")
    monkeypatch.setenv("SPADE_FAULT", fault)
    res = run_tiny_spade()
    assert not res["correct"], res["compared"]
    assert res["compared"][caught_by]["value"] > res["compared"][caught_by]["limit"]


def test_a_setting_the_program_does_not_take_fails_at_once(monkeypatch):
    cell = tiny_spade_cell()
    cell.config["model"]["g_lr"] = 2e-4
    with pytest.raises(SystemExit, match="g_lr"):
        run_cell("spade-dp4", SEED, 0.5, False, False, torch.device("cpu"), cell=cell)


def test_the_tf32_control_is_not_correct():
    res = run_tiny_spade(control=True)
    assert not res["correct"], res["compared"]


def test_a_program_without_the_iteration_fails_at_once(monkeypatch):
    from surfelmapping_tpu_torch import spade_train

    monkeypatch.delattr(spade_train, "train_iteration")
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="train_iteration"):
        run_tiny_spade()
    assert time.perf_counter() - t0 < 60


def test_the_spade_reference_loads_nothing_of_the_port():
    names = modules_after("import benchmarks.reference.spade, benchmarks.spade_flops\n")
    assert "surfelmapping_tpu_torch" not in names
    assert not set(names) & set(harness.FORBIDDEN)
