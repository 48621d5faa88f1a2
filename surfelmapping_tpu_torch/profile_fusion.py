"""Where the main path's time goes on the card, for fusion or rendering.

    python -m surfelmapping_tpu_torch.profile_fusion [--render]

Runs bench.py's operating point (KITTI resolution, capacity 1<<24, a frozen
512-block active budget, sync_every 32) on synthetic frames staged on the
card: 60 frames untimed, 10 frames timed by the host clock (between two
syncs), then 10 more frames under ``torch.profiler``
with each stage of the fusion step in its own range.  Prints one JSON line:
wall ms per frame (unprofiled), device busy ms per frame (the sum of kernel
times) and the device's idle share (profiled window), for each stage its
host time, the time of the kernels it launched and its span on the card's
timeline, and the kernels with the most device time.  Needs a CUDA card.

With ``--render`` it fuses 100 frames instead (the ~4.4 M-surfel map of
chip_smoke.py's main phase) and profiles the render path the same way, per
view: random novel views (seed 0) through render_view(method="fast") with
the cull budget fed forward, 2 views untimed, 10 timed, 10 profiled, each
render stage in its own range (cull, centres, K1, dilation, decode).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import pipeline
from .config import MapConfig, PipelineParams
from .io.synthetic import SyntheticScene, kitti_cam
from .ops import splat
from .tools.timing import card_line

WARM, WINDOW, TOP = 60, 10, 15
STAGES = ("preprocess_frame", "remove_movings", "plan_active_blocks", "gather_active",
          "conflict_active", "index_active", "associate_active", "fuse_append_map")
# render stages: the functions splat.render_view reaches through the module
RENDER_STAGES = {"cull_for_render": "cull", "fast_candidates": "centres",
                 "zbuffer_argmin": "k1", "_dilate": "dilation", "_decode": "decode"}


@contextlib.contextmanager
def stage_ranges(module, names: dict):
    """Wrap each function ``module`` calls by one of ``names`` (name ->
    range label) in a profiler range."""
    saved = {name: getattr(module, name) for name in names}

    def ranged(label, fn):
        def call(*args, **kwargs):
            with record_function(f"stage:{label}"):
                return fn(*args, **kwargs)
        return call

    try:
        for name, fn in saved.items():
            setattr(module, name, ranged(names[name], fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def fused_mapper(cam, frames_total: int):
    """A mapper at bench.py's operating point and its staged frames."""
    mapper = pipeline.SurfelMapper(
        cam, PipelineParams(),
        MapConfig(capacity=1 << 24, active_blocks=512, freeze_active_budget=True),
        sync_every=32,
    )
    scene = SyntheticScene(cam, step=0.8)
    return mapper, scene, [mapper.stage_frame(*scene.frame(i)) for i in range(frames_total)]


def profile_window(step, items, sync, module, names: dict) -> tuple[float, float, object]:
    """Host ms per item of ``step`` over the first half of ``items``
    unprofiled, then over the second half under the profiler with ``names``
    ranged; ``sync`` waits for the device before and after each window."""
    w = len(items) // 2
    sync()
    t0 = time.perf_counter()
    for it in items[:w]:
        step(it)
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3 / w
    with stage_ranges(module, names), profile(activities=[ProfilerActivity.CPU,
                                                          ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for it in items[w:]:
            step(it)
        sync()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / w
    return wall_ms, prof_wall_ms, prof


def report(prof, w: int, wall_ms: float, prof_wall_ms: float, unit: str, **extra) -> None:
    """Print the profile as one JSON line, per ``unit`` (frame or view)."""
    cuda_type = torch.autograd.DeviceType.CUDA
    kernels, stages = [], {}
    for e in prof.key_averages():
        if e.key.startswith("stage:"):
            st = stages.setdefault(e.key[6:], {})
            if e.device_type == cuda_type:  # the range as the card's timeline saw it
                st["device_span_ms"] = e.device_time_total / 1e3 / w
            else:  # the host range, and the kernels launched inside it
                st["host_ms"] = e.cpu_time_total / 1e3 / w
                st["kernel_ms"] = e.device_time_total / 1e3 / w
        elif e.device_type == cuda_type:
            kernels.append((e.key, e.self_device_time_total / 1e3 / w, e.count / w))
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    print(json.dumps({
        "card": card_line(), **extra, "window": w,
        f"wall_ms_per_{unit}": wall_ms, f"profiled_wall_ms_per_{unit}": prof_wall_ms,
        f"device_busy_ms_per_{unit}": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / prof_wall_ms),
        "stages": stages,
        f"kernel_launches_per_{unit}": sum(k[2] for k in kernels),
        "kernels": [{"name": k[0][:120], f"device_ms_per_{unit}": k[1],
                     f"launches_per_{unit}": k[2]} for k in kernels[:TOP]],
    }), flush=True)


def profile_fusion() -> None:
    cam = kitti_cam()
    n, w = WARM, WINDOW
    mapper, _, frames = fused_mapper(cam, n + 2 * w)
    for f in frames[:n]:
        mapper.process_frame(*f)
    # the mapper's own sync: the host read that closes its window
    wall_ms, prof_wall_ms, prof = profile_window(
        lambda f: mapper.process_frame(*f), frames[n:], lambda: mapper.count,
        pipeline, {s: s for s in STAGES})
    report(prof, w, wall_ms, prof_wall_ms, "frame", frames_before=n,
           live_surfels=mapper.count)


def profile_render() -> None:
    from .views import random_novel_views

    cam = kitti_cam()
    mapper, scene, frames = fused_mapper(cam, 100)
    for f in frames:
        mapper.process_frame(*f)
    smap = mapper.smap
    views = random_novel_views([scene.pose(i) for i in range(100)], 2 + 2 * WINDOW, seed=0)
    hint = None

    def render(view):
        nonlocal hint
        out = splat.render_view(smap, view, cam, start_blocks=hint)
        hint = int(out["n_active_blocks"]) + 1

    for v in views[:2]:
        render(v)
    wall_ms, prof_wall_ms, prof = profile_window(render, views[2:], torch.cuda.synchronize,
                                                 splat, RENDER_STAGES)
    report(prof, WINDOW, wall_ms, prof_wall_ms, "view", live_surfels=mapper.count,
           map_capacity=smap.capacity, resolution=f"{cam.width}x{cam.height}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--render", action="store_true",
                    help="profile the render path instead of fusion")
    args = ap.parse_args(argv)
    if args.render:
        profile_render()
    else:
        profile_fusion()
    return 0


if __name__ == "__main__":
    sys.exit(main())
