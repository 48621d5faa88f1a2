"""The generators make the same inputs from the same seed, other inputs
from another, and every seed the same work in another order."""

from __future__ import annotations

import numpy as np
import torch

from benchmarks import harness
from benchmarks.tests.tiny_cells import SEED, tiny_cell

DRIVE = harness.load_module(harness.HERE / "traffic" / "drive.py")
VIEWS = harness.load_module(harness.HERE / "traffic" / "views.py")


def drive(seed):
    cell = tiny_cell("fuse-explore")
    return DRIVE.Drive(cell.config, cell.traffic, seed, torch.device("cpu"))


def test_the_drive_is_the_same_for_a_seed_and_differs_between_seeds():
    a, b, c = drive(SEED), drive(SEED), drive(SEED + 1)
    for x, y in ((a.rgb, b.rgb), (a.depth, b.depth), (a.sem, b.sem)):
        assert torch.equal(x, y)
    assert not torch.equal(a.depth, c.depth)
    assert a.depth.dtype == torch.int32 and int(a.depth.max()) <= 65535
    f = a.frame(a.period + 3)
    assert torch.equal(f[1], a.depth[3]) and f[3][2, 3] == np.float32((a.period + 3) * a.step)


def test_every_seed_draws_the_same_boxes():
    cell = harness.find_cell("fuse-explore")
    period_m = cell.traffic["period_frames"] * cell.traffic["step_m"]
    layouts = [DRIVE.box_layout(cell.config["scene"], period_m, np.random.default_rng(s))
               for s in (1, 2, 2**40)]
    kinds = [sorted((h, k) for _, h, k in boxes) for boxes in layouts]
    assert kinds[0] == kinds[1] == kinds[2]
    assert [b[0] for b in layouts[0]] != [b[0] for b in layouts[1]]


def test_the_view_stream_is_the_same_for_a_seed():
    base = [np.eye(4, dtype=np.float32) for _ in range(5)]
    mix = harness.find_cell("render-views").traffic
    a = [VIEWS.NovelViews(base, mix, SEED).next() for _ in range(3)]
    s = VIEWS.NovelViews(base, mix, SEED)
    b = [s.next() for _ in range(3)]
    assert np.array_equal(a[0], b[0]) and not np.array_equal(b[0], b[1])
    assert np.all(np.abs(b[1][[0, 2], 3]) <= [2.0, 1.0])
