"""Mapping entry point of the port (the root ``build_map.py``'s counterpart,
reference build_map.cpp).

Usage:
    python -m surfelmapping_tpu_torch.build_map DIR [--frames N] [--sub-level L]
        [--decoder native|pil] [--out MAP.bin] [--capacity C] [--sync-every K]
        [--fuse-thresh F] [--clean] [--profile] [--device cuda|cpu]
        [--icp] [--ba] [--ba-window K] [--ba-odo-weight W] [--pose-noise SIGMA]
        [--gui | --gui-snapshots SNAPDIR] [--gui-render-every N]
        [--devices D [--timeout S]]
    python -m surfelmapping_tpu_torch.build_map --synthetic N
        [--synthetic-cam kitti|small] [...the same options]

Fuses the frames of a KITTI-layout dataset directory (io/kitti.py: RGB,
depth PNGs in mm, semantics, ``pose.txt``), or N frames of the procedural
scene, optionally tracking each frame's pose with frame-to-model ICP and/or
windowed bundle adjustment against the map, optionally replays the backward
cleanPoints pass (build_map.cpp:306-326), and writes the map in the
reference's binary format with the first and last frame ids.
``--frames N`` stops at frame id N; ``--sub-level L`` reads every 2**L-th
pixel with the intrinsics divided by 2**L (an odd size is padded with
holes: the engine's checkerboard needs even sizes, where the JAX CLI
refuses them).  ``--decoder`` picks the PNG decoder: the native libpng
library (built with g++ at first use; raises where it cannot be built) or
PIL.  ``--pose-noise`` perturbs the input poses with a seeded random walk
and the run prints the trajectory error against the input poses.
``--gui`` opens the viewer (gui.py; keys s save, c clean, r reset,
v novel view into output/novel, l local model, q quit), ``--gui-snapshots``
writes its figure as PNGs every ``--gui-render-every`` frames, and each of
those frames renders the model panels on the card.  Runs on the CUDA card
unless ``--device cpu`` is given.

``--devices D`` (D > 1) runs the block-sharded engine (parallel/sharded.py)
in D ranks, one process each, launched by this command: NCCL ranks, one per
card, or with ``--device cpu`` D gloo ranks on the CPU.  With fewer cards
than D and no ``--device cpu`` it raises.  Every rank reads the same frames;
ICP/BA run on rank 0 against the gathered active table and its pose is
broadcast; ``--clean`` gathers the shards once and replays on the
single-card mapper; ``--gui`` runs on rank 0 and its keys are broadcast;
rank 0 prints and writes the map.  ``--timeout`` bounds the job: when it
passes, or when one rank fails, every rank is killed.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time as _time

import numpy as np
import torch

from .utils import tracing


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
                 ba_odo_weight: float = 1e4, comm=None):
        from .ba import WindowedBA

        self.mapper = mapper
        # a sharded mapper's ranks: rank 0 refines, every rank fuses its pose
        self.comm = comm
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
            at = m.active_table(pose_t)  # collective on a sharded mapper
            if self.comm is None or self.comm.rank == 0:
                depth_m = preprocess_for_icp(depth_t, sem_t, m.cam, m.params)
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
            if self.comm is not None:
                # every rank fuses rank 0's pose, bit for bit
                t = torch.as_tensor(np.asarray(pose, np.float32), device=m.device).contiguous()
                pose = self.comm.broadcast(t, 0).cpu().numpy()
        m.process_frame(rgb, depth, sem, pose)
        return np.asarray(pose, np.float32)


def pad_to_even(cam):
    """A camera of even width and height, as the active-block engine's
    checkerboard needs, and a function that pads a frame's images to it
    with holes (depth 0, which makes no surfel) on the right and bottom.
    An odd size comes from ``--sub-level`` (KITTI's 1226x370 at level 1 is
    613x185)."""
    ph, pw = cam.height % 2, cam.width % 2
    if not (ph or pw):
        return cam, lambda *images: images
    even = dataclasses.replace(cam, width=cam.width + pw, height=cam.height + ph)

    def pad(*images):
        return tuple(np.pad(a, ((0, ph), (0, pw)) + ((0, 0),) * (a.ndim - 2))
                     for a in images)

    return even, pad


def dataset_frames(reader, frames: int | None):
    """(frame id, rgb, depth, semantic, pose) of a KittiReader, stopping at
    frame id ``frames`` when it is given."""
    while (f := reader.get_next()) is not None:
        if frames and f.frame_id >= frames:
            return
        yield f.frame_id, f.rgb, f.depth, f.semantic, f.pose


def gui_step(gui, mapper, history: list, frame: tuple, render_every: int,
             n_novel: int) -> int:
    """The viewer's share of one frame (the root build_map.py:182-298):
    every ``render_every`` frames the model panel (the map, or with 'l' the
    frame's local model) and the map panel are rendered on the card; then
    the panels update and the keys act: s saves the map, c runs the
    backward clean over the history, r resets the map, v renders a novel
    view into output/novel.  Returns the count of novel views taken."""
    from .gui import panel_renders

    fid, rgb, depth, sem, pose = frame
    render = map_render = None
    if len(history) % render_every == 0 and mapper.count > 0:
        render, map_render = panel_renders(mapper, mapper.smap, rgb, depth, sem, pose,
                                           gui.map_view_pose(pose), local=gui.show_local)
    gui.update(rgb, np.asarray(depth, np.float32) / 1000.0, sem, render,
               status=f"frame {fid}  surfels={int(mapper.last_stats['count'])}",
               pose=pose, map_render=map_render,
               capacity_used=mapper._cached_tail, capacity_total=mapper._smap.capacity)
    if gui.want_save:
        gui.want_save = False
        path = _time.strftime("surfel_map_%m_%d_%H:%M:%S.bin")
        mapper.save_map(path, history[0][0], fid)
        print(f"saved {path}")
    if gui.want_clean:
        gui.want_clean = False
        for _, d, s, p in reversed(history):
            mapper.clean_points(d, s, p)
        print(f"cleaned: surfels={mapper.count}")
    if gui.want_reset:
        gui.want_reset = False
        mapper.reset()
        print("map reset")
    if gui.want_novel:
        gui.want_novel = False
        from .views import acquire_images, random_novel_views

        views = random_novel_views([h[3] for h in history], 1, seed=n_novel)
        acquire_images(mapper.smap, views, "output/novel", mapper.cam, start_id=n_novel,
                       device=mapper.device)
        n_novel += 1
        print(f"acquired novel view {n_novel}")
    gui.wait_if_paused()
    return n_novel


_KEYS = ("quit", "want_save", "want_clean", "want_reset", "want_novel")


def gui_step_sharded(gui, mapper, history: list, frame: tuple, render_every: int,
                     n_novel: int) -> tuple[int, bool]:
    """:func:`gui_step` on a sharded mapper, on every rank: ``gui`` is the
    viewer on rank 0 and None elsewhere.  The map gathers (collective) at the
    render cadence, and rank 0 renders.  The status and the capacity bar
    show the live count and the true cursors of the last sync (the JAX loop
    shows its worst-case estimate, build_map.py:252-254), read without a
    sync: the ranks sync together or not at all.  Rank 0's keys reach every
    rank by a broadcast, and every rank acts on them (c prints that the
    sharded engine cleans only at the end, as the JAX loop does).  Returns
    (the count of novel views taken, quit)."""
    from .gui import panel_renders

    comm = mapper.comm
    fid, rgb, depth, sem, pose = frame
    render = map_render = smap = None
    if len(history) % render_every == 0 and mapper.count > 0:  # a sync on every rank
        smap = mapper.smap()
        if gui is not None:
            render, map_render = panel_renders(mapper, smap, rgb, depth, sem, pose,
                                               gui.map_view_pose(pose))
    if gui is not None:
        gui.update(rgb, np.asarray(depth, np.float32) / 1000.0, sem, render,
                   status=f"frame {fid}  surfels={mapper.live}", pose=pose,
                   map_render=map_render, capacity_used=int(mapper.tails.sum()),
                   capacity_total=mapper.capacity)
        gui.wait_if_paused()
    keys = torch.tensor([int(bool(getattr(gui, k, False))) for k in _KEYS],
                        dtype=torch.int32, device=mapper.device)
    keys = dict(zip(_KEYS, comm.broadcast(keys, 0).tolist()))
    if gui is not None:
        for k in _KEYS[1:]:
            setattr(gui, k, False)
    if keys["want_save"]:
        path = _time.strftime("surfel_map_%m_%d_%H:%M:%S.bin")
        mapper.save_map(path, history[0][0], fid)
        if gui is not None:
            print(f"saved {path}")
    if keys["want_clean"] and gui is not None:
        print("clean: the sharded engine cleans at the end of a run (--clean)")
    if keys["want_reset"]:
        mapper.reset()
        if gui is not None:
            print("map reset")
    if keys["want_novel"]:
        from .views import acquire_images, random_novel_views

        smap = mapper.smap()
        if gui is not None:
            views = random_novel_views([h[3] for h in history], 1, seed=n_novel)
            acquire_images(smap, views, "output/novel", mapper.cam, start_id=n_novel,
                           device=mapper.device)
            print(f"acquired novel view {n_novel + 1}")
        n_novel += 1
    return n_novel, bool(keys["quit"])


def main(argv=None) -> int:
    from .io.kitti import DECODERS

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dataset", nargs="?", help="KITTI-layout dataset directory")
    ap.add_argument("--frames", type=int, default=None,
                    help="stop at this frame id (dataset input)")
    ap.add_argument("--sub-level", type=int, default=0,
                    help="read every 2**L-th pixel, intrinsics / 2**L (dataset input)")
    ap.add_argument("--decoder", choices=DECODERS, default="native",
                    help="PNG decoder of the dataset: the native libpng library "
                         "(raises where it cannot be built) or PIL")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="fuse N procedural frames instead of a dataset")
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
    ap.add_argument("--gui", action="store_true",
                    help="interactive viewer (keys: space pause, . step, s save, "
                         "c clean, r reset, v novel view, l local model, m cycle "
                         "model view, q quit); headless environments write PNG "
                         "snapshots instead")
    ap.add_argument("--gui-snapshots", default=None, metavar="DIR",
                    help="write the viewer's figure into DIR instead of a window")
    ap.add_argument("--gui-render-every", type=int, default=10,
                    help="render the model panels (and snapshot) every N frames")
    ap.add_argument("--profile", action="store_true",
                    help="record the mapper's spans and print their summary (tracing.summary)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--devices", type=int, default=1, metavar="D",
                    help="run the block-sharded engine in D ranks (D > 1): NCCL ranks on "
                         "D cards, or gloo ranks on the CPU with --device cpu")
    ap.add_argument("--timeout", type=float, default=86400.0,
                    help="seconds after which a multi-rank job is killed, every rank")
    args = ap.parse_args(argv)
    if not args.synthetic and not args.dataset:
        ap.error("dataset directory or --synthetic N required")
    if args.devices > 1 and "RANK" not in os.environ:
        from .parallel.distributed import launch_ranks

        return launch_ranks(f"{__package__}.build_map",
                            list(sys.argv[1:] if argv is None else argv), args.devices,
                            args.device, args.timeout)
    comm = None
    if args.devices > 1:
        from .parallel.distributed import initialize, shutdown

        comm = initialize(timeout_s=args.timeout)
        if comm.size != args.devices:
            raise RuntimeError(f"--devices {args.devices} in a job of {comm.size} ranks")
    tracing.enable(args.profile)
    try:
        return run(args, comm)
    finally:
        tracing.enable(False)
        if comm is not None:
            shutdown()


def run(args, comm) -> int:
    """The mapping run of :func:`main`'s parsed ``args``: on one card
    (``comm`` None) or as one rank of a sharded job."""
    from .config import MapConfig, PipelineParams
    from .metrics import absolute_trajectory_error
    from .parallel.sharded import ShardedMapper
    from .pipeline import SurfelMapper
    from .surfels import resize_map

    lead = comm is None or comm.rank == 0
    say = print if lead else (lambda *a, **k: None)
    params = PipelineParams()
    if args.fuse_thresh is not None:
        params = dataclasses.replace(params, fuse_thresh_factor=args.fuse_thresh)
    reader = None
    if args.synthetic:
        from .io.synthetic import SyntheticScene, kitti_cam, tiny_cam

        # >100 px wide so the 80 px stereo border still ingests columns
        cam = tiny_cam(256, 128) if args.synthetic_cam == "small" else kitti_cam()
        scene = SyntheticScene(cam)
        frames = ((i, *scene.frame(i)) for i in range(args.synthetic))
    else:
        from .io.kitti import KittiReader

        reader = KittiReader(args.dataset, sub_level=args.sub_level, decoder=args.decoder)
        cam = reader.cam
        say(f"dataset {args.dataset}: {len(reader)} frames, {cam.width}x{cam.height}, "
            f"decoder {reader.decoder}")
        frames = dataset_frames(reader, args.frames)
    cam, pad = pad_to_even(cam)
    if comm is None:
        mapper = SurfelMapper(cam, params, MapConfig(capacity=args.capacity),
                              sync_every=args.sync_every, device=args.device)
    else:
        mapper = ShardedMapper(comm, cam, params, capacity=args.capacity,
                               sync_every=args.sync_every, device=args.device)
    tracker = Tracker(mapper, icp=args.icp, ba_window=args.ba_window if args.ba else 0,
                      ba_odo_weight=args.ba_odo_weight, comm=comm)
    noise = RandomWalkNoise(args.pose_noise) if args.pose_noise else None
    use_gui = bool(args.gui or args.gui_snapshots)
    gui = None
    if use_gui and lead:
        from .gui import MappingGUI

        gui = MappingGUI(cam, snapshot_dir=args.gui_snapshots,
                         snapshot_every=args.gui_render_every)

    t0 = _time.perf_counter()
    history, gt_poses = [], []
    n_novel, stop = 0, False
    for fid, rgb, depth, sem, pose in frames:
        if stop:
            break
        rgb, depth, sem = pad(rgb, depth, sem)
        gt_poses.append(pose)
        if noise is not None:
            pose = noise(pose)
        pose = tracker.step(fid, rgb, depth, sem, pose)
        history.append((fid, depth, sem, pose))
        if len(history) % 20 == 0:
            count = mapper.count
            say(f"frame {fid}: surfels={count} "
                f"fps={len(history) / (_time.perf_counter() - t0):.2f}", flush=True)
        frame = (fid, rgb, depth, sem, pose)
        if use_gui and comm is None:
            n_novel = gui_step(gui, mapper, history, frame, args.gui_render_every, n_novel)
            stop = gui.quit
        elif use_gui:
            n_novel, stop = gui_step_sharded(gui, mapper, history, frame,
                                             args.gui_render_every, n_novel)
    if reader is not None:
        reader.close()
    if gui is not None:
        gui.close()

    if history and (args.icp or args.ba or args.pose_noise):
        ate = absolute_trajectory_error(np.stack([h[3] for h in history]), np.stack(gt_poses))
        say(f"ATE (rmse vs input gt): {ate['rmse']:.4f} m "
            f"(mean {ate['mean']:.4f}, max {ate['max']:.4f})")

    if args.clean:
        say("running backward cleanPoints pass ...")
        if comm is not None:
            # a backward batch pass over the finished map: gather the shards
            # once and replay on the single-card mapper (rank 0)
            gathered = mapper.smap()
            if not lead:
                return 0
            mapper = SurfelMapper(cam, params, MapConfig(capacity=args.capacity),
                                  sync_every=args.sync_every, device=mapper.device)
            cap = mapper.map_config.rounded_capacity(max(int(gathered.count), args.capacity))
            mapper.smap = resize_map(gathered, cap)
            mapper._refresh_counts()
        for _, depth, sem, pose in reversed(history):
            mapper.clean_points(depth, sem, pose)
        say(f"after clean: surfels={mapper.count}")

    out = args.out or _time.strftime("surfel_map_%m_%d_%H:%M:%S.bin")
    start_id = history[0][0] if history else 0
    end_id = history[-1][0] if history else 0
    mapper.save_map(out, start_id, end_id)  # collective on a sharded mapper
    dt = _time.perf_counter() - t0
    n = len(history)
    ranks = "" if comm is None else f", {comm.size} ranks"
    say(f"{out} saved: {mapper.count} surfels from {n} frames "
        f"({n / dt:.2f} fps, {mapper.device}{ranks})")
    if args.profile:
        say(tracing.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
