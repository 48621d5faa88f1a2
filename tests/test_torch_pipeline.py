"""Port parity, the whole slice: the port's SurfelMapper (on the CPU, so
every kernel's plain version runs) against the JAX SurfelMapper on the same
synthetic frames, plus the port-only counterparts of the mapper invariants
in tests/test_fusion.py.

Per-frame stats and counts must be identical, and map columns match as in
tests/test_torch_active.py.  The JAX mapper runs with jit disabled, op by
op: inside a jitted step XLA's CPU compiler contracts multiply-adds into
FMAs, and at the reference's fuse_thresh_factor = 0 the merge gate
|pz*lam - d*lam| <= 0 and the conflict test d*lam - z*lam > 0 are
exact-equality tests that such a contraction flips (the default scene's
frame 2 merges one surfel op by op and none jitted).  Op by op, XLA rounds
each product as PyTorch does.  With index_factor = 1 every surfel wins at
most one pixel, so marks are unique and the fuse race of
surfelmapping_tpu/ops/active.py:615-620 cannot arise.
"""

import os

import jax
import numpy as np
import pytest
import torch

from surfelmapping_tpu.config import MapConfig as JMapConfig
from surfelmapping_tpu.config import PipelineParams as JParams
from surfelmapping_tpu.io.synthetic import SyntheticScene as JScene
from surfelmapping_tpu.io.synthetic import tiny_cam as jtiny_cam
from surfelmapping_tpu.pipeline import SurfelMapper as JMapper
from surfelmapping_tpu_torch import build_map, convert
from surfelmapping_tpu_torch.config import MapConfig, PipelineParams
from surfelmapping_tpu_torch.io.synthetic import SyntheticScene, tiny_cam
from surfelmapping_tpu_torch.ops.fusion import compact
from surfelmapping_tpu_torch.pipeline import SurfelMapper
from surfelmapping_tpu_torch.surfels import COLUMNS, empty_map, load_map, pack_records, save_map

PARAM_SETS = {"default": {}, "merging": {"fuse_thresh_factor": 0.05}}


def _stats(d):
    return {k: int(v) for k, v in d.items()}


def compare_maps(tmap, jmap, n):
    for k in COLUMNS:
        got = tmap.column(k)[:n].numpy()
        want = np.asarray(getattr(jmap, k))[:n]
        if k == "colorsem":
            np.testing.assert_array_equal(got, want.view(np.int32), err_msg=k)
        elif k in ("nx", "ny", "nz"):  # unit-vector entries
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", list(PARAM_SETS))
@jax.disable_jit()
def test_pipeline_matches_jax(name):
    kw = PARAM_SETS[name]
    jm = JMapper(jtiny_cam(), JParams(**kw), JMapConfig(capacity=1 << 16))
    tm = SurfelMapper(tiny_cam(), PipelineParams(**kw), MapConfig(capacity=1 << 16),
                      device="cpu")
    scene = JScene(jtiny_cam())
    history = []
    for i in range(5):
        frame = scene.frame(i)
        history.append(frame)
        want, got = jm.process_frame(*frame), tm.process_frame(*frame)
        assert _stats(got) == _stats(want), f"frame {i}"
    n = jm.count
    assert tm.count == n > 0
    compare_maps(tm.smap, jm.smap, n)
    if name == "merging":
        assert max(int(tm.process_frame(*scene.frame(5))["merged"]),
                   int(jm.process_frame(*scene.frame(5))["merged"])) > 0
        n = jm.count
        assert tm.count == n
        compare_maps(tm.smap, jm.smap, n)
    else:
        # the backward cleanPoints replay
        for _, d, s, T in reversed(history):
            jm.clean_points(d, s, T)
            tm.clean_points(d, s, T)
        assert tm.count == jm.count
        compare_maps(tm.smap, jm.smap, jm.count)


@jax.disable_jit()
def test_state_carried_from_jax_continues_identically():
    """convert.mapper_state_from_numpy: a port mapper started from the JAX
    mapper's state takes the next frames exactly as the JAX mapper does."""
    jm = JMapper(jtiny_cam(), JParams(), JMapConfig(capacity=1 << 16))
    scene = JScene(jtiny_cam())
    for i in range(3):
        jm.process_frame(*scene.frame(i))
    cols = {k: np.asarray(getattr(jm._smap, k)) for k in COLUMNS}
    tm = SurfelMapper(tiny_cam(), PipelineParams(), MapConfig(capacity=1 << 16), device="cpu")
    convert.mapper_state_from_numpy(tm, cols, int(jm._smap.count), np.asarray(jm.last_depth),
                                    np.asarray(jm.last_pose), jm.tick)
    assert tm.count == jm.count
    for i in (3, 4):
        frame = scene.frame(i)
        assert _stats(tm.process_frame(*frame)) == _stats(jm.process_frame(*frame))
    compare_maps(tm.smap, jm.smap, jm.count)


def make_mapper(cam=None, capacity=1 << 16, **kw):
    return SurfelMapper(cam or tiny_cam(), PipelineParams(), MapConfig(capacity=capacity),
                        device="cpu", **kw)


def test_first_frame_creates_no_surfels():
    m = make_mapper()
    stats = m.process_frame(*SyntheticScene(m.cam).frame(0))
    assert m.count == 0 and stats.get("first_frame")


def test_count_conservation_across_frames():
    m = make_mapper()
    scene = SyntheticScene(m.cam)
    prev = 0
    for i in range(4):
        stats = m.process_frame(*scene.frame(i))
        if i >= 1:
            assert int(stats["count"]) == prev - int(stats["removed"]) + int(stats["new"])
        prev = m.count


def test_reset_takes_the_initialize_path():
    m = make_mapper()
    scene = SyntheticScene(m.cam)
    for i in range(2):
        m.process_frame(*scene.frame(i))
    m.reset()
    stats = m.process_frame(*scene.frame(2))
    assert stats.get("initialized") and stats["count"] == m.count > 0
    assert int(m.process_frame(*scene.frame(3))["count"]) == m.count


def test_compact_drops_nonpositive_conf_and_preserves_order():
    smap = empty_map(16, "cpu")
    n = 6
    smap.px[:n] = torch.arange(n, dtype=torch.float32) * 3.0
    smap.conf[:n] = torch.tensor([1.0, -0.1, 2.0, 0.0, 0.5, 3.0])
    smap.count = torch.tensor(n, dtype=torch.int32)
    for prefix in (None, 8):
        out = compact(smap.clone(), prefix=prefix)
        assert int(out.count) == 4
        assert out.px[:4].tolist() == [0.0, 6.0, 12.0, 15.0]
        assert float(out.column("conf")[4:].sum()) == 0


def test_map_checkpoint_roundtrip(tmp_path):
    m = make_mapper()
    scene = SyntheticScene(m.cam)
    for i in range(3):
        m.process_frame(*scene.frame(i))
    path = os.path.join(tmp_path, "map.bin")
    save_map(m.smap, path, start_id=0, end_id=2)
    loaded, s0, s1 = load_map(path, "cpu")
    assert (s0, s1) == (0, 2)
    assert int(loaded.count) == m.count
    a = pack_records(m.smap).numpy()[: m.count]
    b = pack_records(loaded).numpy()[: int(loaded.count)]
    assert a.tobytes() == b.tobytes()
    raw = open(path, "rb").read()
    assert len(raw) == 12 + m.count * 48
    assert int(np.frombuffer(raw[:4], "<u4")[0]) == m.count
    # the mapper's own checkpoint entry points
    m2 = make_mapper()
    assert m2.load_map(path) == (0, 2)
    assert m2.count == m.count and m2.tick == 3


def test_capacity_growth_replays_frame():
    """Overflow must grow the buffer and lose nothing."""
    m = make_mapper(capacity=64)  # absurdly small
    scene = SyntheticScene(m.cam)
    for i in range(3):
        m.process_frame(*scene.frame(i))
    assert m.count > 64
    assert m.smap.capacity > 64
    assert m.events["capacity_growths"] > 0


def test_active_budget_overflow_is_replayed_exactly():
    """A too-small active-block budget never silently truncates a frame's
    working set: the window verify replays with a grown budget, and the map
    equals that of a run that never overflowed."""
    cam = tiny_cam()
    params = PipelineParams(fuse_thresh_factor=0.05, stereo_border=0.0)
    scene = SyntheticScene(cam, step=0.4)

    def run(active_blocks):
        m = SurfelMapper(cam, params,
                         MapConfig(capacity=1 << 16, block_size=256, active_blocks=active_blocks),
                         sync_every=64, device="cpu")
        for i in range(8):
            m.process_frame(*scene.frame(i))
        _ = m.count  # sync point: verifies the window and repairs overflows
        return m

    small, big = run(1), run(1024)
    assert small.active_blocks > 1 and small.events["replays"] > 0
    a, b = small.smap, big.smap
    assert int(a.count) == int(b.count)
    n = int(a.count)
    for col in COLUMNS:
        assert torch.equal(a.column(col)[:n], b.column(col)[:n]), col


def test_build_map_cli(tmp_path, capsys):
    out = str(tmp_path / "m.bin")
    assert build_map.main(["--synthetic", "3", "--synthetic-cam", "small", "--device", "cpu",
                           "--out", out, "--fuse-thresh", "0.05", "--clean",
                           "--capacity", str(1 << 16)]) == 0
    n = int(np.frombuffer(open(out, "rb").read(4), "<u4")[0])
    assert n > 0
    assert f"saved: {n} surfels from 3 frames" in capsys.readouterr().out

