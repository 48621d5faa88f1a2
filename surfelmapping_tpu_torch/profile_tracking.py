"""Where the tracked frame's time goes on the card.

    python -m surfelmapping_tpu_torch.profile_tracking

Profiles the tracked frame as ``build_map --icp --ba`` runs it
(build_map.Tracker: ICP 5 iterations, a 5-frame BA window, odometry weight
1e4) in the JAX package's tracking experiment (tools/record_parity.py: the
box-corridor scene, fuse_thresh_factor 0.05, capacity 1<<21) at KITTI size,
with a 0.02 m/frame random walk on the input poses: 20 frames untimed, 5
timed by the host clock, then 5 under ``torch.profiler`` with the
active-table gather, ICP's stages, BA's stages and process_frame each in its
own range.  Prints one JSON line: wall ms per frame (unprofiled), device
busy ms per frame (the sum of kernel times) and the device's idle share
(profiled window), for each stage its host time, the time of the kernels it
launched and its span on the card's timeline, the kernels with the most
device time, and K1's launches per frame.  Needs a CUDA card.  Fusion and
rendering have their own spans (``build_map --profile``, ``load_map
--profile``) and the benchmark's traced cells; tracking has neither yet.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import ba, build_map, icp, pipeline
from .config import MapConfig, PipelineParams
from .io.synthetic import corridor_scene, kitti_cam
from .ops.zbuf import KERNEL as K1
from .tools.timing import card_line

TOP = 15
TRACK_WARM, TRACK_WINDOW = 20, 5
# tracking stages, by the module whose namespace the calls go through
ICP_STAGES = {"preprocess_for_icp": "icp_preprocess", "refine_pose": "icp_total",
              "index_active": "icp_index_k1", "associate": "icp_associate",
              "_normal_equations": "icp_normal_equations", "_gauss_newton_step": "icp_solve",
              "_best_step": "icp_step_search"}
BA_STAGES = {"subsample_frame": "ba_subsample", "refine_window": "ba_refine_total",
             "_frame_to_map_block": "ba_frame_block_with_k1", "_odometry_edge": "ba_odometry",
             "_assemble_and_solve": "ba_solve", "marginalize_oldest": "ba_marginalize"}


@contextlib.contextmanager
def stage_ranges(*targets):
    """For each (module or object, {name: range label}) in ``targets``, wrap
    the function it reaches by that name in a profiler range."""
    saved = [(obj, name, getattr(obj, name), label)
             for obj, names in targets for name, label in names.items()]

    def ranged(label, fn):
        def call(*args, **kwargs):
            with record_function(f"stage:{label}"):
                return fn(*args, **kwargs)
        return call

    try:
        for obj, name, fn, label in saved:
            setattr(obj, name, ranged(label, fn))
        yield
    finally:
        for obj, name, fn, _ in saved:
            setattr(obj, name, fn)


def profile_window(step, items, sync, *targets) -> tuple[float, float, object]:
    """Host ms per item of ``step`` over the first half of ``items``
    unprofiled, then over the second half under the profiler with the
    ``targets`` of :func:`stage_ranges` ranged; ``sync`` waits for the device
    before and after each window."""
    w = len(items) // 2
    sync()
    t0 = time.perf_counter()
    for it in items[:w]:
        step(it)
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3 / w
    with stage_ranges(*targets), profile(activities=[ProfilerActivity.CPU,
                                                          ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for it in items[w:]:
            step(it)
        sync()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / w
    return wall_ms, prof_wall_ms, prof


def report(prof, w: int, wall_ms: float, prof_wall_ms: float, **extra) -> None:
    """Print the profile as one JSON line, per frame."""
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
        elif e.device_type == cuda_type and not getattr(e, "is_user_annotation", False):
            # the device side of the host's ranges (the port's own spans) is no kernel
            kernels.append((e.key, e.self_device_time_total / 1e3 / w, e.count / w))
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    print(json.dumps({
        "card": card_line(), **extra, "window": w,
        "wall_ms_per_frame": wall_ms, "profiled_wall_ms_per_frame": prof_wall_ms,
        "device_busy_ms_per_frame": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / prof_wall_ms),
        "stages": stages,
        "kernel_launches_per_frame": sum(k[2] for k in kernels),
        "kernels": [{"name": k[0][:120], "device_ms_per_frame": k[1],
                     "launches_per_frame": k[2]} for k in kernels[:TOP]],
    }), flush=True)


def profile_tracking() -> None:
    cam = kitti_cam()
    mapper = pipeline.SurfelMapper(cam, PipelineParams(fuse_thresh_factor=0.05),
                                   MapConfig(capacity=1 << 21))
    tracker = build_map.Tracker(mapper, icp=True, ba_window=5, ba_odo_weight=1e4)
    scene = corridor_scene(cam)
    noise = build_map.RandomWalkNoise(0.02)
    frames = []
    for i in range(TRACK_WARM + 2 * TRACK_WINDOW):
        rgb, depth, sem, pose = scene.frame(i)
        frames.append((i, rgb, depth, sem, noise(pose)))
    for f in frames[:TRACK_WARM]:
        tracker.step(*f)
    mapper_stages = {"active_table": "active_table", "process_frame": "process_frame"}
    k1_before = K1.launches
    wall_ms, prof_wall_ms, prof = profile_window(
        lambda f: tracker.step(*f), frames[TRACK_WARM:], torch.cuda.synchronize,
        (icp, ICP_STAGES), (ba, BA_STAGES), (mapper, mapper_stages))
    report(prof, TRACK_WINDOW, wall_ms, prof_wall_ms, frames_before=TRACK_WARM,
           live_surfels=mapper.count, resolution=f"{cam.width}x{cam.height}",
           k1_launches_per_frame=(K1.launches - k1_before) / (2 * TRACK_WINDOW))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.parse_args(argv)
    profile_tracking()
    return 0


if __name__ == "__main__":
    sys.exit(main())
