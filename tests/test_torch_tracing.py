"""The port's span and counter recorder (``utils/tracing.py``) on the CPU:
off it records nothing and hands out one shared object; under a
torch.profiler (or after ``enable``) the mapper's frames and the renderer's
views record their spans, nested as the calls are, in the profiler's trace
and on its clock; the map is the same either way; and the summary's self
and wait times add up."""

from __future__ import annotations

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from surfelmapping_tpu_torch import build_map, load_map
from surfelmapping_tpu_torch.config import MapConfig, PipelineParams
from surfelmapping_tpu_torch.io.synthetic import SyntheticScene, tiny_cam
from surfelmapping_tpu_torch.ops import splat
from surfelmapping_tpu_torch.pipeline import SurfelMapper
from surfelmapping_tpu_torch.surfels import COLUMNS
from surfelmapping_tpu_torch.utils import tracing

CAM = tiny_cam(128, 96)
STAGES = ("fuse.preprocess_frame", "fuse.remove_movings", "fuse.plan_active_blocks",
          "fuse.gather_active", "fuse.conflict_active", "fuse.index_active",
          "fuse.associate_active", "fuse.fuse_append_map")


@pytest.fixture(autouse=True)
def _fresh_recorder():
    tracing.enable(False)
    tracing.clear()
    yield
    tracing.enable(False)
    tracing.clear()


@pytest.fixture(scope="module")
def frames():
    scene = SyntheticScene(CAM)
    return [scene.frame(i) for i in range(4)]


def fuse(frames, sync_every: int = 2) -> SurfelMapper:
    m = SurfelMapper(CAM, PipelineParams(fuse_thresh_factor=0.05), MapConfig(capacity=1 << 16),
                     sync_every=sync_every, device="cpu")
    for f in frames:
        m.process_frame(*f)
    return m


def inside(recs, root):
    return [r for r in recs if r.root_id == root.root_id and r is not root
            and root.start_ns <= r.start_ns and r.end_ns <= root.end_ns]


def test_off_the_recorder_hands_out_one_object_and_records_nothing(frames):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tracing.span("fuse.frame") is tracing.span("render.view", 3)
    m = fuse(frames)
    _ = m.count
    splat.render_view(m.smap, frames[2][3], CAM, block_size=32, start_blocks=4, device="cpu")
    tracing.count("render.budget_retries")
    assert tracing.records() == []
    assert tracing.RING >= 65536


def test_a_profiler_turns_the_spans_on_and_enable_does_too():
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled
        with tracing.span("probe"):
            pass
    with tracing.span("off"):
        pass
    assert [r.name for r in tracing.records()] == ["probe"]
    tracing.enable()  # from an empty ring
    with tracing.span("probe"):
        tracing.count("probe.count", 2)
    tracing.enable(False)
    with tracing.span("off"):
        pass
    assert [(r.name, r.n) for r in tracing.records()] == [("probe.count", 2), ("probe", None)]


def test_each_frame_is_a_root_with_its_stages_in_order_and_the_sync_waits(frames):
    with profile(activities=[ProfilerActivity.CPU]):
        m = fuse(frames)
    recs = tracing.records()
    roots = [r for r in recs if r.name == "fuse.frame"]
    assert [r.root_id for r in roots] == list(range(len(frames))) and m.tick == len(frames)
    assert all(r.parent_id == -1 for r in roots)
    for root in roots[1:]:  # frame 0 only seeds the reference depth
        spans = inside(recs, root)
        stages = sorted((r for r in spans if r.name in STAGES), key=lambda r: r.start_ns)
        assert [r.name for r in stages] == list(STAGES)
        assert all(r.parent_id == root.span_id for r in stages)
        assert [r.name for r in spans if r.parent_id == root.span_id][0] == "fuse.upload"
    # sync_every=2: frames 2 and 3 hold the window's sync, which reads the device once
    syncs = [r for r in recs if r.name == "fuse.sync"]
    assert [r.root_id for r in syncs] == [0, 2]
    for s in syncs:
        waits = [r for r in inside(recs, s) if r.name == "wait"]
        assert len(waits) == 1 and waits[0].parent_id == s.span_id


def test_the_spans_are_in_the_profilers_trace_on_its_clock(frames):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fuse(frames[:2])
    t0 = prof.profiler.kineto_results.trace_start_ns()
    recs = tracing.records()
    by_name = collections.defaultdict(list)
    for e in prof.events():
        by_name[e.name].append(t0 + int(e.time_range.start * 1e3))
    for name in ("fuse.frame", "fuse.upload", "fuse.associate_active", "fuse.sync", "wait"):
        mine = sorted(tracing.epoch_ns(r.start_ns) for r in recs if r.name == name)
        theirs = sorted(by_name[name])
        assert len(mine) == len(theirs) > 0, name
        assert max(abs(a - b) for a, b in zip(mine, theirs)) < 5e6, name


def test_the_map_is_the_same_with_tracing_on_and_off(frames):
    off = fuse(frames).smap
    tracing.enable()
    on = fuse(frames).smap
    assert len(tracing.records()) > 0
    assert torch.equal(off.count, on.count)
    for k in COLUMNS:
        assert torch.equal(off.column(k), on.column(k)), k


def test_the_retry_counter_counts_the_renders_the_budget_truncated(frames):
    smap = fuse(frames).smap
    tracing.enable()
    out = splat.render_view(smap, frames[2][3], CAM, block_size=32, start_blocks=4,
                            device="cpu")
    recs = tracing.records()
    (view,) = [r for r in recs if r.name == "render.view"]
    counted = sum(r.n for r in inside(recs, view) if r.name == "render.budget_retries")
    assert out["budget_retries"] > 0 and counted == out["budget_retries"]
    assert [r.name for r in inside(recs, view)].count("wait") == out["budget_retries"] + 1
    assert [r.name for r in inside(recs, view)].count("render.k1") == out["budget_retries"] + 1


def test_the_summary_gives_self_and_wait_time(monkeypatch):
    ms = 1_000_000
    ring = collections.deque([  # (name, start, end, id, parent, root, n): exit order
        ("wait", 2 * ms, 3 * ms, 2, 1, 7, None),
        ("fuse.sync", 1 * ms, 5 * ms, 1, 0, 7, None),
        ("render.budget_retries", 6 * ms, 6 * ms, -1, 0, 7, 2),
        ("fuse.frame", 0, 10 * ms, 0, -1, 7, None),
    ])
    monkeypatch.setattr(tracing, "_ring", ring)
    rows = {line.split()[0]: line.split()[1:] for line in tracing.summary().splitlines()[1:]}
    assert rows["fuse.frame"] == ["1", "10.000", "10.000", "6.000", "1.000"]
    assert rows["fuse.sync"] == ["1", "4.000", "4.000", "3.000", "1.000"]
    assert rows["wait"] == ["1", "1.000", "1.000", "1.000", "1.000"]
    assert rows["count"] == ["render.budget_retries", "2"]


def test_the_clis_print_the_summary_with_profile(tmp_path, capsys):
    out = str(tmp_path / "m.bin")
    assert build_map.main(["--synthetic", "3", "--synthetic-cam", "small", "--device", "cpu",
                           "--out", out, "--profile"]) == 0
    text = capsys.readouterr().out
    assert "fuse.frame" in text and "fuse.associate_active" in text and "wait" in text
    assert load_map.main([out, "--synthetic", "--synthetic-cam", "small", "--num", "2",
                          "--device", "cpu", "--out", str(tmp_path / "novel"),
                          "--profile"]) == 0
    text = capsys.readouterr().out
    assert "render.view" in text and "render.to_u8" in text and "fuse.frame" not in text
    with tracing.span("after"):
        pass
    assert "after" not in {r.name for r in tracing.records()}  # the CLIs leave tracing off
