"""The correctness tap's choice of sync windows: one drawn from all the
complete windows it watched, and the last whose edge grew, compacted or
replayed the map."""

from __future__ import annotations

from benchmarks.mapping import CHECKED_EVENTS, WindowTap


class FakeMapper:
    """A mapper whose sync windows are ``every`` frames long: ``_chk`` is a
    new object at each window's first frame; ``grow_at`` names the frames at
    which a capacity growth happens."""

    def __init__(self, every: int = 2, grow_at=()):
        self.every, self.grow_at = every, set(grow_at)
        self.events = {k: 0 for k in CHECKED_EVENTS}
        self._chk = None

    def frame(self, t: int) -> None:
        if t % self.every == 0:
            self._chk = object()
        if t in self.grow_at:
            self.events["capacity_growths"] += 1


def watch(tap: WindowTap, mapper: FakeMapper, ticks) -> None:
    for t in ticks:
        mapper.frame(t)
        tap.after_frame(t)


def test_the_drawn_window_is_any_complete_window_not_only_the_early_ones():
    starts = set()
    for seed in range(300):
        m = FakeMapper()
        tap = WindowTap(m, seed=seed + 2**33, collect=True)
        watch(tap, m, range(24))  # windows start at 0, 2, ..., 22; the last is open
        starts.add(tap.drawn[0])
    assert starts == set(range(0, 22, 2))


def test_the_last_window_across_a_growth_is_kept():
    m = FakeMapper(grow_at=(5, 17))
    tap = WindowTap(m, seed=7, collect=True)
    watch(tap, m, range(24))
    start, end, _, _ = tap.event
    assert (start, end) == (16, 18)
    assert tap.event in tap.pairs and tap.drawn in tap.pairs


def test_follow_drops_the_open_window_and_the_first_state_is_the_second_sync():
    m = FakeMapper()
    tap = WindowTap(m, seed=3, collect=False)
    watch(tap, m, range(5))
    assert tap.first_end == 2 and tap.drawn is None  # not collecting yet
    m2 = FakeMapper(grow_at=(1,))
    tap.follow(m2)
    watch(tap, m2, range(1, 6))  # frame 1 opens no window; 2 and 4 do
    assert tap.seen == 1 and tap.drawn[:2] == (2, 4)
    assert tap.event is None  # the growth at frame 1 was before any watched window
