"""Driver ``fuse``: a closed-loop drive through the program's mapper, as laps
of one fixed stretch of the drive.

Set-up makes the traffic's drive on the device, fuses its prefix through
``SurfelMapper.process_frame``, ends on the mapper's sync and keeps the
mapper by value: every lap starts from that copy.  A lap drives the
``lap_frames`` frames after the prefix, one ``process_frame`` each, and ends
on the mapper's own sync, so every frame's work is done.  Set-up drives one
lap, which builds and warms every kernel, shape and growth the window uses;
the window drives laps until ``--seconds`` have passed and its lap is over.
Each lap does the same work whatever the program's speed (a faster program
does not drive further into a larger map), so ``frames_per_s``, the frames
of the window's laps over its seconds, follows the program's speed alone.
The copy that starts each lap is made inside the window.  The traced run
traces ``trace_frames`` frames from frame ``trace_from_frame`` of a lap.
"""

from __future__ import annotations

import copy
import dataclasses
import time

import torch

from benchmarks import mapping
from benchmarks.harness import Tracer

LAP_EVENTS = mapping.CHECKED_EVENTS + ("budget_growths",)


@dataclasses.dataclass
class State:
    drive: object
    start: object  # the mapper after the prefix, by value
    mapper: object
    tap: mapping.WindowTap
    first: int  # the lap's first frame
    lap_events: list


def stage_targets():
    """Ranges for the traced run: the calls into the host driver and into
    each stage of the fusion step."""
    from surfelmapping_tpu_torch import pipeline

    stages = ("preprocess_frame", "remove_movings", "plan_active_blocks", "gather_active",
              "conflict_active", "index_active", "associate_active", "fuse_append_map")
    return [(pipeline.SurfelMapper, {"process_frame": "process_frame",
                                     "_refresh_counts": "sync",
                                     "_maybe_grow_cached": "growth",
                                     "_compact_now": "compaction"}),
            (pipeline, {s: s for s in stages})]


def lap(st: State, ctx, watch: bool, tracer: Tracer | None = None) -> int:
    """One lap from the kept copy; returns its frames.  With ``watch`` the
    tap follows the lap's mapper; with ``tracer`` a stretch of it is traced."""
    mix = ctx.cell.traffic
    st.tap.close()
    st.mapper = None  # the last lap's map goes before the copy is made
    st.mapper = copy.deepcopy(st.start)
    if watch:
        st.tap.follow(st.mapper)
    n = mix["lap_frames"]
    at = mix["trace_from_frame"]
    t = 0
    while t < n:
        if tracer is not None and not tracer.done and t == at:
            with tracer.stretch():
                for _ in range(tracer.items):
                    step(st, watch, t)
                    t += 1
            continue
        step(st, watch, t)
        t += 1
    _ = st.mapper.count  # the mapper's own sync ends the lap
    return n


def step(st: State, watch: bool, t: int) -> None:
    before = dict(st.mapper.events)
    st.mapper.process_frame(*st.drive.frame(st.first + t))
    if watch:
        st.tap.after_frame(st.first + t)
    else:
        changed = [k for k in LAP_EVENTS if st.mapper.events[k] != before[k]]
        if changed:
            st.lap_events.append([t] + changed)


def setup(ctx) -> State:
    cell = ctx.cell
    mix = cell.traffic
    if mix["trace_from_frame"] + mix["trace_frames"] > mix["lap_frames"]:
        raise ValueError("the traced stretch has to lie inside a lap")
    t_gen = time.perf_counter()
    drive = cell.generator().Drive(cell.config, mix, ctx.seed, ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    t_fuse = time.perf_counter()
    ctx.notes["generate_s"] = t_fuse - t_gen
    mapper = mapping.program_mapper(cell.config, ctx.device)
    prefix = mix["prefix_frames"]
    tap = mapping.WindowTap(mapper, seed=ctx.seed, collect=False)
    for t in range(prefix):
        mapper.process_frame(*drive.frame(t))
        tap.after_frame(t)
    prefix_live = mapper.count  # the prefix ends on the mapper's sync
    st = State(drive, mapper, None, tap, prefix, [])
    t_lap = time.perf_counter()
    ctx.notes["prefix_s"] = t_lap - t_fuse
    lap(st, ctx, watch=False)  # the warm lap
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    ctx.notes["warm_lap_s"] = time.perf_counter() - t_lap
    ctx.notes["lap_events"] = st.lap_events
    ctx.notes["lap_live_surfels"] = [prefix_live, st.mapper.count]
    return st


def window(st: State, ctx) -> dict:
    tracer = Tracer(ctx.cell.traffic["trace_frames"], stage_targets()) if ctx.trace else None
    frames = 0
    lap_s = []
    t0 = time.perf_counter()
    ctx.window_started(t0)
    while True:
        t_lap = time.perf_counter()
        frames += lap(st, ctx, watch=True, tracer=tracer)
        lap_s.append(time.perf_counter() - t_lap)
        if time.perf_counter() - t0 >= ctx.seconds and (tracer is None or tracer.done):
            break
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    seconds = time.perf_counter() - t0
    st.tap.close()
    ctx.notes["lap_s"] = lap_s
    return {"attempted": frames, "failed": 0, "seconds": seconds,
            "metrics": {"frames_per_s": frames / seconds},
            "records": None if tracer is None else tracer.records,
            "live_surfels": st.mapper.count}


def check(st: State, ctx) -> dict:
    """Frees the program's mapper, then holds its kept maps to the
    reference: {name: (value, limit)}."""
    st.mapper = st.start = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    found, notes = mapping.check_fusion(st.tap, st.drive.frame, ctx.cell.config, ctx.device,
                                        ctx.control)
    ctx.notes["checked_windows"] = notes["checked_windows"]
    return {k: (v, ctx.cell.settings["limits"][k]) for k, v in found.items()}
