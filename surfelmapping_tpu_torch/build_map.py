"""Mapping entry point of the port (the root ``build_map.py``'s counterpart,
reference build_map.cpp, headless).

Usage:
    python -m surfelmapping_tpu_torch.build_map --synthetic N [--out MAP.bin]
        [--synthetic-cam kitti|small] [--capacity C] [--sync-every K]
        [--fuse-thresh F] [--clean] [--profile] [--device cuda|cpu]
        [--icp] [--ba] [--ba-window K] [--ba-odo-weight W] [--pose-noise SIGMA]

Fuses N frames of the procedural scene, optionally tracking each frame's
pose with frame-to-model ICP and/or windowed bundle adjustment against the
map, optionally replays the backward cleanPoints pass
(build_map.cpp:306-326), and writes the map in the reference's binary
format.  ``--pose-noise`` perturbs the input poses with a seeded random walk
and the run prints the trajectory error against the scene's true poses.  It
runs on the CUDA card unless ``--device cpu`` is given.  (Dataset input, the
GUI and the sharded engine are not ported yet.)
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time as _time

import numpy as np


class RandomWalkNoise:
    """Random-walk pose noise of ``sigma`` m per frame from
    ``default_rng(seed)``: each frame multiplies the drift by a random
    translation, and the pose becomes pose @ drift."""

    def __init__(self, sigma: float, seed: int = 0):
        self.sigma = sigma
        self.rng = np.random.default_rng(seed)
        self.drift = np.eye(4, dtype=np.float32)

    def __call__(self, pose) -> np.ndarray:
        dT = np.eye(4, dtype=np.float32)
        dT[:3, 3] = self.rng.normal(0, self.sigma, 3)
        self.drift = self.drift @ dT
        return np.asarray(pose, np.float32) @ self.drift


class Tracker:
    """Per frame: refine the input pose against the map (ICP, then BA with
    ICP's pose as its odometry) and fuse the frame at the refined pose.

    Tracking runs on the mapper's gathered in-frustum active table, once the
    map holds surfels.  The table is gathered at the newest frame's input
    pose; the BA window's older frames reuse it, which assumes consecutive
    frusta overlap heavily (true at KITTI frame spacing)."""

    def __init__(self, mapper, icp: bool = False, ba_window: int = 0,
                 ba_odo_weight: float = 1e4):
        from .ba import WindowedBA

        self.mapper = mapper
        self.icp = icp
        self.ba = (WindowedBA(mapper.cam, mapper.params, window=ba_window,
                              odo_weight=ba_odo_weight, device=mapper.device)
                   if ba_window else None)
        self.inliers: list[dict] = []  # per tracked frame

    def step(self, fid: int, rgb, depth, sem, pose) -> np.ndarray:
        """Track and fuse one frame; returns the pose it was fused at."""
        from .icp import preprocess_for_icp, refine_pose

        m = self.mapper
        if (self.icp or self.ba is not None) and m.count > 0:
            _, depth_t, sem_t, pose_t = m.stage_frame(None, depth, sem, pose)
            depth_m = preprocess_for_icp(depth_t, sem_t, m.cam, m.params)
            at = m.active_table(pose_t)
            seen = {}
            if self.icp:
                refined, diag = refine_pose(at, depth_m, pose_t, m.cam, m.params)
                pose = refined.cpu().numpy()
                seen["icp"] = int(diag["inliers"])
            if self.ba is not None:
                self.ba.push(depth_m, pose, at=at, time=float(fid))
                pose = self.ba.refine(at, time=float(fid))
                seen["ba"] = self.ba.last_diag["inliers"]
            self.inliers.append(seen)
        m.process_frame(rgb, depth, sem, pose)
        return np.asarray(pose, np.float32)


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
    ap.add_argument("--icp", action="store_true",
                    help="refine poses with frame-to-model ICP")
    ap.add_argument("--ba", action="store_true",
                    help="refine poses with windowed bundle adjustment (odometry "
                         "source = ICP when --icp is also given, else the input poses)")
    ap.add_argument("--ba-window", type=int, default=5)
    ap.add_argument("--ba-odo-weight", type=float, default=1e4)
    ap.add_argument("--pose-noise", type=float, default=0.0, metavar="SIGMA",
                    help="perturb input poses with random-walk noise (m/frame)")
    ap.add_argument("--profile", action="store_true", help="print stage timings")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from .config import MapConfig, PipelineParams
    from .io.synthetic import SyntheticScene, kitti_cam, tiny_cam
    from .metrics import absolute_trajectory_error
    from .pipeline import SurfelMapper

    params = PipelineParams()
    if args.fuse_thresh is not None:
        params = dataclasses.replace(params, fuse_thresh_factor=args.fuse_thresh)
    # >100 px wide so the 80 px stereo border still ingests columns
    cam = tiny_cam(256, 128) if args.synthetic_cam == "small" else kitti_cam()
    scene = SyntheticScene(cam)
    mapper = SurfelMapper(cam, params, MapConfig(capacity=args.capacity),
                          sync_every=args.sync_every, device=args.device)
    tracker = Tracker(mapper, icp=args.icp, ba_window=args.ba_window if args.ba else 0,
                      ba_odo_weight=args.ba_odo_weight)
    noise = RandomWalkNoise(args.pose_noise) if args.pose_noise else None

    t0 = _time.perf_counter()
    history, gt_poses = [], []
    for i in range(args.synthetic):
        rgb, depth, sem, pose = scene.frame(i)
        gt_poses.append(pose)
        if noise is not None:
            pose = noise(pose)
        pose = tracker.step(i, rgb, depth, sem, pose)
        history.append((i, depth, sem, pose))
        if (i + 1) % 20 == 0:
            fps = (i + 1) / (_time.perf_counter() - t0)
            print(f"frame {i}: surfels={mapper.count} fps={fps:.2f}", flush=True)

    if history and (args.icp or args.ba or args.pose_noise):
        ate = absolute_trajectory_error(np.stack([h[3] for h in history]), np.stack(gt_poses))
        print(f"ATE (rmse vs input gt): {ate['rmse']:.4f} m "
              f"(mean {ate['mean']:.4f}, max {ate['max']:.4f})")

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
