"""Mapping entry point of the port (the root ``build_map.py``'s counterpart,
reference build_map.cpp, headless).

Usage:
    python -m surfelmapping_tpu_torch.build_map --synthetic N [--out MAP.bin]
        [--synthetic-cam kitti|small] [--capacity C] [--sync-every K]
        [--fuse-thresh F] [--clean] [--profile] [--device cuda|cpu]

Fuses N frames of the procedural scene, optionally replays the backward
cleanPoints pass (build_map.cpp:306-326), and writes the map in the
reference's binary format.  It runs on the CUDA card unless ``--device cpu``
is given.  (Dataset input, ICP/BA, the GUI and the sharded engine are not
ported yet.)
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time as _time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--synthetic", type=int, required=True, metavar="N",
                    help="fuse N procedural frames")
    ap.add_argument("--synthetic-cam", choices=["kitti", "small"], default="kitti",
                    help="full KITTI resolution or a 256x128 smoke-test camera")
    ap.add_argument("--out", default=None, help="output map path")
    ap.add_argument("--capacity", type=int, default=1 << 22)
    ap.add_argument("--sync-every", type=int, default=8,
                    help="frames between host syncs")
    ap.add_argument("--fuse-thresh", type=float, default=None,
                    help="override surfel fuse distance threshold factor")
    ap.add_argument("--clean", action="store_true", help="run backward cleanPoints")
    ap.add_argument("--profile", action="store_true", help="print stage timings")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from .config import MapConfig, PipelineParams
    from .io.synthetic import SyntheticScene, kitti_cam, tiny_cam
    from .pipeline import SurfelMapper

    params = PipelineParams()
    if args.fuse_thresh is not None:
        params = dataclasses.replace(params, fuse_thresh_factor=args.fuse_thresh)
    # >100 px wide so the 80 px stereo border still ingests columns
    cam = tiny_cam(256, 128) if args.synthetic_cam == "small" else kitti_cam()
    scene = SyntheticScene(cam)
    mapper = SurfelMapper(cam, params, MapConfig(capacity=args.capacity),
                          sync_every=args.sync_every, device=args.device)

    t0 = _time.perf_counter()
    history = []
    for i in range(args.synthetic):
        rgb, depth, sem, pose = scene.frame(i)
        mapper.process_frame(rgb, depth, sem, pose)
        history.append((i, depth, sem, pose))
        if (i + 1) % 20 == 0:
            fps = (i + 1) / (_time.perf_counter() - t0)
            print(f"frame {i}: surfels={mapper.count} fps={fps:.2f}", flush=True)

    if args.clean:
        print("running backward cleanPoints pass ...")
        for _, depth, sem, pose in reversed(history):
            mapper.clean_points(depth, sem, pose)
        print(f"after clean: surfels={mapper.count}")

    out = args.out or _time.strftime("surfel_map_%m_%d_%H:%M:%S.bin")
    end_id = history[-1][0] if history else 0
    mapper.save_map(out, 0, end_id)
    dt = _time.perf_counter() - t0
    n = len(history)
    print(f"{out} saved: {mapper.count} surfels from {n} frames "
          f"({n / dt:.2f} fps, {mapper.device})")
    if args.profile:
        print(mapper.stopwatch.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
