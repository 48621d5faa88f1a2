"""Where the main path's time goes on the card.

    python -m surfelmapping_tpu_torch.profile_fusion

Runs bench.py's operating point (KITTI resolution, capacity 1<<24, a frozen
512-block active budget, sync_every 32) on synthetic frames staged on the
card: 60 frames untimed, 10 frames timed by the host clock (between two
syncs), then 10 more frames under ``torch.profiler``
with each stage of the fusion step in its own range.  Prints one JSON line:
wall ms per frame (unprofiled), device busy ms per frame (the sum of kernel
times) and the device's idle share (profiled window), for each stage its
host time, the time of the kernels it launched and its span on the card's
timeline, and the kernels with the most device time.  Needs a CUDA card.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import pipeline
from .config import MapConfig, PipelineParams
from .io.synthetic import SyntheticScene, kitti_cam

WARM, WINDOW, TOP = 60, 10, 15
STAGES = ("preprocess_frame", "remove_movings", "plan_active_blocks", "gather_active",
          "conflict_active", "index_active", "associate_active", "fuse_append_map")


@contextlib.contextmanager
def stage_ranges():
    """Wrap each stage the fusion step calls in a profiler range."""
    saved = {name: getattr(pipeline, name) for name in STAGES}

    def ranged(name, fn):
        def call(*args, **kwargs):
            with record_function(f"stage:{name}"):
                return fn(*args, **kwargs)
        return call

    try:
        for name, fn in saved.items():
            setattr(pipeline, name, ranged(name, fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(pipeline, name, fn)


def main() -> int:
    cam = kitti_cam()
    mapper = pipeline.SurfelMapper(
        cam, PipelineParams(),
        MapConfig(capacity=1 << 24, active_blocks=512, freeze_active_budget=True),
        sync_every=32,
    )
    scene = SyntheticScene(cam, step=0.8)
    n, w = WARM, WINDOW
    frames = [mapper.stage_frame(*scene.frame(i)) for i in range(n + 2 * w)]
    for f in frames[:n]:
        mapper.process_frame(*f)
    _ = mapper.count
    t0 = time.perf_counter()
    for f in frames[n:n + w]:
        mapper.process_frame(*f)
    _ = mapper.count
    wall_ms = (time.perf_counter() - t0) * 1e3 / w

    with stage_ranges(), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames[n + w:]:
            mapper.process_frame(*f)
        _ = mapper.count
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / w

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
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps(dict(
        card=card, frames_before=n, window=w, live_surfels=mapper.count,
        wall_ms_per_frame=wall_ms, profiled_wall_ms_per_frame=prof_wall_ms,
        device_busy_ms_per_frame=busy_ms,
        device_idle_share=max(0.0, 1.0 - busy_ms / prof_wall_ms),
        stages=stages,
        kernel_launches_per_frame=sum(k[2] for k in kernels),
        kernels=[dict(name=k[0][:120], device_ms_per_frame=k[1], launches_per_frame=k[2])
                 for k in kernels[:TOP]],
    )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
