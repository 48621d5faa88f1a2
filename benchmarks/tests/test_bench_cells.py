"""Whole runs of each cell on the CPU at a tiny size: a sound run is
correct; the control (the reference held in bfloat16 in the program's
place) and each fault planted under the timed path are not."""

from __future__ import annotations

import os

import pytest
import torch

from benchmarks.tests.tiny_cells import run_tiny

CELLS = ("fuse-explore", "render-views")


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_leaves_nothing_in_dev_shm(name):
    before = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()
    res = run_tiny(name)
    after = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert all(c["value"] == 0 and c["limit"] == 0 for c in res["compared"].values())
    assert after <= before
    names = set(res["metrics"])
    assert "setup_s" in names and len(names) >= 2


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    res = run_tiny(name, control=True)
    assert not res["correct"]
    assert res["compared"]["start_mismatch"]["value"] > 0


def _step_returns_state_unchanged(monkeypatch):
    from surfelmapping_tpu_torch import pipeline

    real = pipeline._fusion_step

    def unchanged(smap, *args, **kwargs):
        _, filtered, dropped, stats = real(smap.clone(), *args, **kwargs)
        return smap, filtered, dropped, stats

    monkeypatch.setattr(pipeline, "_fusion_step", unchanged)


def _half_the_frame_left_out(monkeypatch):
    from surfelmapping_tpu_torch import pipeline

    real = pipeline.preprocess_frame

    def half(depth, semantic, cam, params):
        out = real(depth, semantic, cam, params)
        out[:, out.shape[1] // 2:] = 0.0
        return out

    monkeypatch.setattr(pipeline, "preprocess_frame", half)


def _a_surfel_altered(monkeypatch):
    from surfelmapping_tpu_torch import pipeline

    real = pipeline.fuse_append_map

    def altered(smap, at, assoc):
        smap, dropped = real(smap, at, assoc)
        smap.px[1] += 1e-3
        return smap, dropped

    monkeypatch.setattr(pipeline, "fuse_append_map", altered)


def _a_pixel_altered(monkeypatch):
    from surfelmapping_tpu_torch import views

    real = views.render_u8

    def altered(out):
        rgb, sem = real(out)
        rgb = rgb.clone()
        rgb[rgb.shape[0] // 2, rgb.shape[1] // 2, 0] ^= 1
        return rgb, sem

    monkeypatch.setattr(views, "render_u8", altered)


FAULTS = [("fuse-explore", _step_returns_state_unchanged),
          ("fuse-explore", _half_the_frame_left_out),
          ("fuse-explore", _a_surfel_altered),
          ("render-views", _step_returns_state_unchanged),
          ("render-views", _a_pixel_altered)]


@pytest.mark.parametrize("name,plant", FAULTS, ids=[f"{n}-{p.__name__[1:]}" for n, p in FAULTS])
def test_a_fault_under_the_timed_path_is_not_correct(name, plant, monkeypatch):
    plant(monkeypatch)
    res = run_tiny(name)
    assert not res["correct"], res["compared"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_run_on_the_card_is_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time

    from benchmarks.run import run_cell
    from benchmarks.tests.tiny_cells import SEED, tiny_cell

    res = run_cell(name, SEED, 0.5, False, False, torch.device("cuda", 0),
                   cell=tiny_cell(name), t_process=time.perf_counter())
    assert res["correct"], res["compared"]
