"""The readers of the program's spans and counts (``fuse.host_ms_per_frame``,
``fuse.wait_ms_per_frame``, ``render.wait_ms_per_view``,
``render.retries_per_view``) on a recorder filled by hand, on one filled by
the program's own spans, and on a program without the recorder."""

from __future__ import annotations

import pytest

from benchmarks import harness
from surfelmapping_tpu_torch.utils import tracing

MS = 1_000_000
R = tracing.Record


def frame(tick: int, t0: int, wait_ms: int) -> list:
    """A 10 ms frame whose sync waits ``wait_ms``, in the recorder's order."""
    sid = 10 * tick
    return [R("wait", t0 + 2 * MS, t0 + (2 + wait_ms) * MS, sid + 2, sid + 1, tick, None),
            R("fuse.sync", t0 + MS, t0 + 9 * MS, sid + 1, sid, tick, None),
            R("fuse.frame", t0, t0 + 10 * MS, sid, -1, tick, None)]


def view(root: int, t0: int, retries: int) -> list:
    """A 20 ms view that waits 5 ms for each of its 1 + ``retries`` renders."""
    sid = 1000 + 10 * root
    recs = []
    for i in range(retries + 1):
        recs.append(R("wait", t0 + (1 + 6 * i) * MS, t0 + (6 + 6 * i) * MS, sid + 1 + i, sid,
                      root, None))
        if i < retries:
            recs.append(R("render.budget_retries", t0 + (6 + 6 * i) * MS,
                          t0 + (6 + 6 * i) * MS, -1, sid, root, 1))
    return recs + [R("render.view", t0, t0 + 20 * MS, sid, -1, root, None)]


def read(name: str, items: int):
    return harness.reader(name).read({"items": items})


def test_the_readers_take_the_last_roots_and_what_lies_inside_them(monkeypatch):
    recs = frame(0, 0, 7)  # before the traced stretch: not read
    recs += frame(1, 100 * MS, 1) + frame(2, 200 * MS, 3)
    recs += view(0, 300 * MS, 3)  # an earlier root id 0 at another time
    recs += view(1, 400 * MS, 0) + view(2, 500 * MS, 1)
    recs += [R("wait", 600 * MS, 601 * MS, 5000, -1, 9, None)]  # outside any root
    monkeypatch.setattr(tracing, "records", lambda: list(recs))
    assert read("fuse.wait_ms_per_frame", 2) == pytest.approx(2.0)
    assert read("fuse.host_ms_per_frame", 2) == pytest.approx(8.0)
    assert read("render.wait_ms_per_view", 2) == pytest.approx(7.5)
    assert read("render.retries_per_view", 2) == pytest.approx(0.5)
    assert read("fuse.wait_ms_per_frame", 3) == pytest.approx(11 / 3)
    assert read("render.retries_per_view", 4) is None  # fewer roots than items


def test_the_readers_read_the_programs_own_spans():
    import torch

    tracing.enable()
    try:
        for tick in range(3):
            with tracing.span("fuse.frame", tick):
                with tracing.span("fuse.sync"):
                    tracing.read_back(torch.arange(3))
        for _ in range(2):
            with tracing.span("render.view"):
                tracing.count("render.budget_retries")
                tracing.read_back(torch.zeros((), dtype=torch.int32))
    finally:
        tracing.enable(False)
    recs = tracing.records()
    waits = [r.end_ns - r.start_ns for r in recs if r.name == "wait"]
    frames = [r.end_ns - r.start_ns for r in recs if r.name == "fuse.frame"]
    assert read("fuse.wait_ms_per_frame", 3) == pytest.approx(sum(waits[:3]) / 3e6)
    assert read("fuse.host_ms_per_frame", 3) == pytest.approx(
        (sum(frames) - sum(waits[:3])) / 3e6)
    assert read("render.wait_ms_per_view", 2) == pytest.approx(sum(waits[3:]) / 2e6)
    assert read("render.retries_per_view", 2) == 1.0
    tracing.clear()


@pytest.mark.parametrize("name", ["fuse.host_ms_per_frame", "fuse.wait_ms_per_frame",
                                  "render.wait_ms_per_view", "render.retries_per_view"])
def test_a_program_without_the_recorder_reads_as_nothing(monkeypatch, name):
    monkeypatch.delattr(tracing, "records")
    assert read(name, 64) is None
    monkeypatch.setattr(tracing, "records", lambda: [], raising=False)
    assert read(name, 64) is None
