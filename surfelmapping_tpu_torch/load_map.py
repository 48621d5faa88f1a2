"""Simulation entry point of the port (the root ``load_map.py``'s
counterpart, reference load_map.cpp, headless).

Loads a saved surfel map and renders novel-view image/semantic PNG pairs for
simulator data generation:

    python -m surfelmapping_tpu_torch.load_map MAP.bin --synthetic
        [--synthetic-cam kitti|small] [--mode random|s|paired|overview]
        [--num N] [--out DIR] [--seed S] [--footprint F] [--device cuda|cpu]

Modes (load_map.cpp:114-287):
  paired:   render at the poses of the mapped id range;
  random:   +-2 m x, +-1 m z, +-15 deg yaw perturbations of random frames;
  s:        "S"-shaped sinusoidal sweep along the trajectory (drops the first
            4 frames when acquiring, load_map.cpp:223-229);
  overview: lifted chase-camera fly-through of the whole trajectory
            (load_map.cpp:254-287).

The poses and intrinsics come from the procedural scene (``--synthetic``).
Dataset input (``--calib``) needs the KITTI reader, which is not ported yet,
and is refused.  Renders on the CUDA card unless ``--device cpu`` is given.
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
                    help="dataset dir for intrinsics+poses (not ported yet)")
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
    args = ap.parse_args(argv)
    if args.calib:
        raise NotImplementedError(
            "--calib needs the KITTI dataset reader (io/kitti), which the port "
            "does not have yet; use --synthetic")

    from .io.synthetic import SyntheticScene, kitti_cam, tiny_cam
    from .pipeline import resolve_device
    from .surfels import load_map as load_map_file
    from .views import acquire_images, overview_views, random_novel_views, s_shaped_views

    dev = resolve_device(args.device)
    # loaded at its raw count; acquire_images pads it to whole cull blocks once
    smap, start_id, end_id = load_map_file(args.map, dev)
    print(f"loaded {int(smap.count)} surfels, frames [{start_id}, {end_id}]")

    cam = tiny_cam(256, 128) if args.synthetic_cam == "small" else kitti_cam()
    scene = SyntheticScene(cam)
    base_views = [scene.pose(i) for i in range(start_id, max(end_id + 1, start_id + 2))]

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
    acquire_images(smap, views, out_dir, cam, start_id=first_id,
                   footprint=args.footprint, device=dev)
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
