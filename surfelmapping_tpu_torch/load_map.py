"""Simulation entry point of the port (the root ``load_map.py``'s
counterpart, reference load_map.cpp, headless).

Loads a saved surfel map and renders novel-view image/semantic PNG pairs for
simulator data generation:

    python -m surfelmapping_tpu_torch.load_map MAP.bin --calib DIR|--synthetic
        [--synthetic-cam kitti|small] [--mode random|s|paired|overview]
        [--num N] [--out DIR] [--seed S] [--footprint F] [--device cuda|cpu]
        [--profile]

Modes (load_map.cpp:114-287):
  paired:   render at the poses of the mapped id range;
  random:   +-2 m x, +-1 m z, +-15 deg yaw perturbations of random frames;
  s:        "S"-shaped sinusoidal sweep along the trajectory (drops the first
            4 frames when acquiring, load_map.cpp:223-229);
  overview: lifted chase-camera fly-through of the whole trajectory
            (load_map.cpp:254-287).

The intrinsics and the poses of the mapped id range come from a KITTI-layout
dataset directory (``--calib DIR``: its calibration and ``pose.txt``, no
image is read) or from the procedural scene (``--synthetic``, also the
default without ``--calib``).  Renders on the CUDA card unless
``--device cpu`` is given.  ``--profile`` records the renderer's spans and
prints their summary (``utils/tracing.summary``: wall, self and wait ms per
span, and the cull-budget retries).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("map", help="binary surfel map (reference format)")
    ap.add_argument("--calib", default=None,
                    help="dataset dir for intrinsics+poses")
    ap.add_argument("--synthetic", action="store_true",
                    help="poses and intrinsics of the procedural scene")
    ap.add_argument("--synthetic-cam", choices=["kitti", "small"], default="kitti",
                    help="full KITTI resolution or a 256x128 smoke-test camera")
    ap.add_argument("--mode", choices=["paired", "random", "s", "overview"],
                    default="random")
    ap.add_argument("--num", type=int, default=20)
    ap.add_argument("--out", default="output/novel")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--footprint", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--profile", action="store_true",
                    help="record the renderer's spans and print their summary")
    args = ap.parse_args(argv)

    from .pipeline import resolve_device
    from .surfels import load_map as load_map_file
    from .utils import tracing
    from .views import acquire_images, overview_views, random_novel_views, s_shaped_views

    dev = resolve_device(args.device)
    # loaded at its raw count; acquire_images pads it to whole cull blocks once
    smap, start_id, end_id = load_map_file(args.map, dev)
    print(f"loaded {int(smap.count)} surfels, frames [{start_id}, {end_id}]")

    if args.synthetic or not args.calib:
        from .io.synthetic import SyntheticScene, kitti_cam, tiny_cam

        cam = tiny_cam(256, 128) if args.synthetic_cam == "small" else kitti_cam()
        scene = SyntheticScene(cam)
        base_views = [scene.pose(i) for i in range(start_id, max(end_id + 1, start_id + 2))]
    else:
        from .io.kitti import KittiReader

        reader = KittiReader(args.calib)
        cam = reader.cam
        base_views = [reader.poses[i] for i in range(start_id, end_id + 1)]

    if args.mode == "paired":
        views = [np.asarray(v, np.float32) for v in base_views]
        out_dir = args.out.replace("novel", "paired")
        first_id = start_id
    elif args.mode == "random":
        views = random_novel_views(base_views, args.num, seed=args.seed)
        out_dir = args.out
        first_id = 0
    elif args.mode == "s":
        views = s_shaped_views(base_views, period=float(args.num) * 3)[4:]
        out_dir = args.out
        first_id = start_id + 4
    else:
        views = overview_views(base_views)
        out_dir = args.out.replace("novel", "overview")
        first_id = start_id

    print(f"rendering {len(views)} views -> {out_dir} ({dev})")
    tracing.enable(args.profile)
    try:
        acquire_images(smap, views, out_dir, cam, start_id=first_id,
                       footprint=args.footprint, device=dev)
    finally:
        tracing.enable(False)
    print("done")
    if args.profile:
        print(tracing.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
