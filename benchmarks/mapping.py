"""What the mapping cells share: the program's mapper built from a
configuration file, the tap that keeps the mapper's own copies of its map at
chosen sync windows, and the comparison of those maps with the reference.

The program's state is judged by the reference following it: the reference
cannot fuse a whole drive of hundreds of frames in less time than a window.
So it checks two things apart.  The start: the first sync window fused from
an empty map by the reference alone, against the program's map at its
second sync.  Stretches: of the watched drive's complete sync windows, one
drawn by the seed from all of them, and the last whose edge grew, compacted
or replayed the map, each fused by the reference from the program's own map
at the window's start (the mapper's by-value copy, which it keeps for its
replays) and compared with the program's map at the next window's start.
Maps compare by their live surfels in slot order, bit for bit: compaction
and growth change slots, not content.
"""

from __future__ import annotations

import dataclasses
import random

CHECKED_EVENTS = ("replays", "compacts", "capacity_growths")


def program_mapper(config: dict, device):
    """The program's ``SurfelMapper`` at the configuration's settings."""
    from surfelmapping_tpu_torch.config import CameraIntrinsics, MapConfig, PipelineParams
    from surfelmapping_tpu_torch.pipeline import SurfelMapper

    return SurfelMapper(CameraIntrinsics(**config["camera"]),
                        PipelineParams(**config["pipeline"]), MapConfig(**config["map"]),
                        sync_every=config["sync_every"], device=device)


class WindowTap:
    """Watches a mapper's sync windows frame by frame (a window starts where
    the mapper takes its by-value copy ``_chk`` of the map) and keeps:

      * ``first_state``: the map at the start of the second window, with
        ``first_end``, that window's first frame;
      * ``pairs``: (first frame, end frame, map before, map after) of one
        complete window drawn by ``seed`` from all those watched while
        collecting (a reservoir of one), and of the last such window across
        whose end the mapper grew, compacted or replayed.

    ``follow`` points it at a mapper (a new one, or the same again) and
    starts collecting; an open window is dropped, never kept half-seen."""

    def __init__(self, mapper, seed: int, collect: bool):
        self.mapper, self.collect = mapper, collect
        self.rng = random.Random(seed)
        self.cur = None
        self.first_state = self.first_end = None
        self.seen = 0
        self.drawn = self.event = None

    @property
    def pairs(self) -> list[tuple]:
        if self.drawn is self.event:
            return [] if self.drawn is None else [self.drawn]
        return [p for p in (self.drawn, self.event) if p is not None]

    def events(self) -> tuple:
        return tuple(self.mapper.events[k] for k in CHECKED_EVENTS)

    def follow(self, mapper) -> None:
        self.mapper, self.cur, self.collect = mapper, None, True

    def after_frame(self, tick: int) -> None:
        chk = self.mapper._chk
        if chk is None or (self.cur is not None and chk is self.cur[1]):
            return
        if self.cur is not None:
            start, before, events = self.cur
            if self.first_state is None:
                self.first_state, self.first_end = chk, tick
            if self.collect:
                self.seen += 1
                pair = (start, tick, before, chk)
                if self.rng.randrange(self.seen) == 0:
                    self.drawn = pair
                if events != self.events():
                    self.event = pair
        self.cur = (tick, chk, self.events())

    def close(self) -> None:
        """Stop watching: drop the open window's copy."""
        self.cur = None


def reference_settings(config: dict):
    from benchmarks.reference.mapping import config as rc

    cam = rc.CameraIntrinsics(**config["camera"])
    mc = rc.MapConfig(**config["map"])
    return cam, rc.PipelineParams(**config["pipeline"]), mc


def as_reference(smap, clone: bool = False):
    """The program's map tensors as the reference's map type."""
    from benchmarks.reference.mapping.surfels import SurfelMap

    return SurfelMap(**{f.name: (getattr(smap, f.name).clone() if clone
                                 else getattr(smap, f.name))
                        for f in dataclasses.fields(SurfelMap)})


def as_program(smap):
    """A reference map as the program's map type (no copy)."""
    from surfelmapping_tpu_torch.surfels import SurfelMap

    return SurfelMap(**{f.name: getattr(smap, f.name) for f in dataclasses.fields(SurfelMap)})


def check_fusion(tap: WindowTap, frame_at, config: dict, device, control: bool,
                 keep_start: bool = False) -> tuple[dict, dict]:
    """The start and the stretches: ({name: surfels that differ}, notes).
    The notes give each checked stretch as (first frame, end frame, capacity
    at its start, capacity at its end) and, with ``keep_start``, the
    reference's own map of the start (``start_map``).  With ``control`` the
    reference held in bfloat16 takes the program's place."""
    from benchmarks.reference.mapping.step import drive, record_mismatch
    from benchmarks.reference.mapping.surfels import empty_map

    cam, params, mc = reference_settings(config)
    if tap.first_state is None or not tap.pairs:
        raise RuntimeError("the drive held too few sync windows to check")

    def run(start_map, ticks, ctl=False):
        return drive(start_map, frame_at, ticks, cam, params, mc.block_size, control=ctl)

    def fresh():
        return empty_map(mc.rounded_capacity(mc.capacity), device)

    first = range(1, tap.first_end)
    ref = run(fresh(), first)
    actual = run(fresh(), first, True) if control else as_reference(tap.first_state)
    out = {"start_mismatch": record_mismatch(actual, ref)}
    notes = {"checked_windows": [], "start_map": ref if keep_start else None}
    del ref, actual
    total = 0
    for start, end, before, after in tap.pairs:
        notes["checked_windows"].append([start, end, before.capacity, after.capacity])
        ref = run(as_reference(before, clone=True), range(start, end))
        actual = (run(as_reference(before, clone=True), range(start, end), True) if control
                  else as_reference(after))
        total += record_mismatch(actual, ref)
        del ref, actual
    out["window_mismatch"] = total
    return out, notes
