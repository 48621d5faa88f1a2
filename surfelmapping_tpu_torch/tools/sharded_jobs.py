"""Rank programs of the sharded engine's multi-process jobs: each is one
rank's side of a job that ``parallel.distributed.spawn_ranks`` (or
``spawn_cpu_processes``) launches, and each writes what its caller checks
into ``--out``.

    python -m surfelmapping_tpu_torch.tools.sharded_jobs JOB --out DIR [options]

Jobs (the tests in tests/test_torch_sharded.py and chip_smoke.py's
``sharded`` phase launch them):
  step         frames of the sharded step from a state read from ``--state``
               (a JAX ShardedMapState's numpy columns, the settings and the
               frames to run); each rank writes its shard and its per-frame
               stats
  mapper       ShardedMapper over ``--frames`` frames of a 128x64 scene with
               the growth, replay and compaction settings given; rank 0
               writes the gathered map and the mapper's events
  replay       the budget replay: one ShardedMapper with ``--budgets`` active
               blocks each (1 then 64); each rank writes both shards
  ba           BA's cross-rank reduction: the window's pixels dealt over the
               ranks, refine_window(group=...) beside the one-rank refine
  distributed  an all-reduce, three frames of the sharded step, the
               gathered map and save_checkpoint read back
  viewer       build_map's sharded viewer step with the viewer on rank 0,
               beside the same loop with no viewer on any rank; each rank
               writes both runs' shards and events
  kitti        the sharded engine at KITTI resolution on the card: frames/s
               over windows, the card's busy time, the collectives' bytes and
               time per frame, the kernels' launches per frame, the gathered
               map's records

A CPU rank runs one torch thread (the ranks share the machine).  No JAX is
imported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import convert
from ..config import MapConfig, PipelineParams
from ..io.synthetic import SyntheticScene, kitti_cam, tiny_cam
from ..parallel.distributed import Comm, allgather_state, initialize, save_checkpoint, shutdown
from ..parallel.sharded import ShardedMapper, gather_sharded_map, make_sharded_step
from ..pipeline import SurfelMapper, resolve_device, stage_frame
from ..surfels import COLUMNS, SurfelMap, load_map, pack_records

CPU = torch.device("cpu")


def records(smap) -> np.ndarray:
    """A map's live records, f32[count, 12] in the reference layout."""
    return pack_records(smap)[: int(smap.count)].cpu().numpy()


def dealt_state(path, ranks: int, capacity: int, fuse_thresh: float, frames: int = 3,
                first: int = 3, steps: int = 3) -> tuple[np.ndarray, int]:
    """Write a start state for the step job to ``path``: a one-card map after
    ``frames`` frames of tiny_cam(128, 64) (the port on the CPU), dealt
    round-robin into ``ranks`` shards as a JAX ShardedMapState's columns of
    ``capacity`` slots, with the mapper's last depth and pose and the
    settings and frames (``first``, ``steps``) to run.  Returns (counts, the
    map's count)."""
    cam = tiny_cam(128, 64)
    m = SurfelMapper(cam, PipelineParams(fuse_thresh_factor=fuse_thresh),
                     MapConfig(capacity=1 << 14), device="cpu")
    scene = SyntheticScene(cam)
    for i in range(frames):
        m.process_frame(*scene.frame(i))
    cols, n = convert.map_to_numpy(m.smap)
    S = capacity // ranks
    full = {k: np.zeros(capacity, v.dtype) for k, v in cols.items()}
    counts = np.zeros(ranks, np.int32)
    for d in range(ranks):
        idx = np.arange(d, n, ranks)
        counts[d] = len(idx)
        for k in cols:
            full[k][d * S:d * S + len(idx)] = cols[k][idx]
    # the columns as the port's shards carry them back
    full, counts = convert.sharded_to_numpy(convert.sharded_from_numpy(full, counts, CPU))
    np.savez(path, **full, counts=counts, width=cam.width, height=cam.height,
             fuse_thresh=fuse_thresh, active_blocks=8, block_size=512, first=first,
             frames=steps, last_depth=m.last_depth.numpy(), last_pose=m.last_pose.numpy())
    return counts, n


def job_step(comm: Comm, a) -> None:
    """The sharded step over the frames ``a.state`` names, from its shard."""
    dev = resolve_device(a.device)
    z = np.load(a.state)
    cols = {k: z[k] for k in COLUMNS}
    state = convert.sharded_from_numpy(cols, z["counts"], dev, rank=comm.rank)
    cam = tiny_cam(int(z["width"]), int(z["height"]))
    params = PipelineParams(fuse_thresh_factor=float(z["fuse_thresh"]))
    step = make_sharded_step(comm, cam, params, int(z["active_blocks"]), int(z["block_size"]))
    scene = SyntheticScene(cam)
    last_depth = torch.from_numpy(z["last_depth"]).to(dev)
    last_pose = torch.from_numpy(z["last_pose"]).to(dev)
    rows = []
    for i in range(int(z["first"]), int(z["first"]) + int(z["frames"])):
        rgb, depth, sem, pose = stage_frame(dev, *scene.frame(i))
        state, last_depth, stats = step(state, depth, rgb, sem, pose, last_depth, last_pose,
                                        float(i))
        last_pose = pose
        rows.append(torch.cat([stats.vec, stats.new[None]]).cpu().numpy())
    out, counts = convert.sharded_to_numpy([state])
    np.savez(Path(a.out) / f"rank{comm.rank}.npz", count=counts[0], stats=np.stack(rows),
             last_depth=last_depth.cpu().numpy(), **out)


def job_mapper(comm: Comm, a) -> None:
    """tests/test_sharded.py's long run: ShardedMapper on ``a.frames`` frames."""
    cam = tiny_cam(128, 64)
    params = PipelineParams(stereo_border=0.0, fuse_thresh_factor=a.fuse_thresh)
    sm = ShardedMapper(comm, cam, params, capacity=a.capacity, active_blocks=a.active_blocks,
                       block_size=a.block_size, sync_every=a.sync_every,
                       compact_dead_frac=a.compact_dead_frac, device=a.device)
    scene = SyntheticScene(cam, step=a.scene_step)
    dropped = 0
    for i in range(a.frames):
        stats = sm.process_frame(*scene.frame(i))
        if "dropped" in stats:
            dropped += int(stats["dropped"])
        if a.dump_frames:
            dump_prefixes(comm, sm, Path(a.out) / f"frame{i}.npz")
    count = sm.count
    smap = sm.smap()
    if comm.rank == 0:
        np.savez(Path(a.out) / "mapper.npz", records=records(smap), count=count,
                 capacity=sm.capacity, dropped=dropped, tails=sm.tails,
                 **{f"event_{k}": v for k, v in sm.events.items()})


def dump_prefixes(comm: Comm, sm: ShardedMapper, path) -> None:
    """After a sync (every rank), rank 0 writes every shard's prefix,
    tombstones kept, concatenated in rank order (the global-id order), with
    the mapper's last depth, last pose and tick: the map a single card
    holds if its slots run in the sharded engine's global-id order."""
    _ = sm.count  # a sync, on every rank
    parts = allgather_state(sm.state, comm)
    if comm.rank == 0:
        cols, _ = convert.map_to_numpy(gather_prefixes(parts))
        np.savez(path, **cols, last_depth=sm.last_depth.cpu().numpy(),
                 last_pose=sm.last_pose.cpu().numpy(), tick=sm.tick)


def gather_prefixes(parts) -> SurfelMap:
    """Every shard's prefix (``allgather_state``'s parts), tombstones kept,
    concatenated in rank order into one map with one spare slot."""
    cols = {k: torch.cat([p.smap.column(k)[: int(p.smap.count)] for p in parts]
                         + [parts[0].smap.column(k).new_zeros(1)]) for k in COLUMNS}
    n = cols["px"].shape[0] - 1
    return SurfelMap(**cols, count=torch.tensor(n, dtype=torch.int32, device=cols["px"].device))


def job_replay(comm: Comm, a) -> None:
    """tests/test_sharded.py's budget replay, once per budget in ``a.budgets``."""
    dev = resolve_device(a.device)
    cam = tiny_cam(128, 64)
    params = PipelineParams(stereo_border=0.0, fuse_thresh_factor=0.05)
    out = {}
    for budget in a.budgets:
        sm = ShardedMapper(comm, cam, params, capacity=1 << 14, active_blocks=budget,
                           block_size=32, sync_every=8, device=dev)
        scene = SyntheticScene(cam, step=0.5)
        for i in range(8):
            sm.process_frame(*scene.frame(i))
        sm._sync()
        cols, counts = convert.sharded_to_numpy([sm.state])
        out.update({f"b{budget}_{k}": v for k, v in cols.items()})
        out[f"b{budget}_count"] = counts[0]
        out[f"b{budget}_active_blocks"] = sm.active_blocks
        out[f"b{budget}_live"] = sm.count
    np.savez(Path(a.out) / f"rank{comm.rank}.npz", **out)


# tests/test_ba.py's scene and window settings
BA_BOXES = (((-4.0, 0.6, 11.0), (1.0, 1.0, 1.5)), ((0.5, 0.7, 18.0), (1.2, 0.9, 1.0)),
            ((-2.0, 0.4, 24.0), (1.0, 1.2, 1.0)))
BA_PARAMS = dict(fuse_thresh_factor=0.05, smooth_radius=1, stereo_border=0.0)
BA_WIN = dict(window=4, stride=2, iters=2, odo_weight=300.0)


def job_ba(comm: Comm, a) -> None:
    """Every rank fuses tests/test_ba.py's scene and pushes the same window;
    rank r keeps the window's pixels p with p % D == r (the per-frame sums
    partition exactly) and refines with the cross-rank reduction; rank 0
    also refines the whole window on its own."""
    import dataclasses

    from .. import ba, icp
    from ..ops.active import table_from_map
    from ..surfels import resize_map

    dev = resolve_device(a.device)
    cam = tiny_cam()
    params = PipelineParams(**BA_PARAMS)
    scene = SyntheticScene(cam, step=0.4, car_center=(4.5, 0.8, 13.0), extra_boxes=BA_BOXES)
    mapper = SurfelMapper(cam, params, MapConfig(capacity=1 << 17), device=dev)
    for i in range(a.frames):
        mapper.process_frame(*scene.frame(i))
    at = table_from_map(resize_map(mapper.smap, -(-mapper.count // 2048) * 2048))
    w = ba.WindowedBA(cam, params, **BA_WIN, device=dev)
    rng = np.random.default_rng(3)
    for i in range(4, 8):
        _, d, s, T = scene.frame(i)
        T_odo = T.astype(np.float32).copy()
        T_odo[2, 3] += rng.normal(0, 0.03)
        depth = icp.preprocess_for_icp(torch.from_numpy(d.astype(np.int32)).to(dev),
                                       torch.from_numpy(s.astype(np.int32)).to(dev), cam,
                                       params)
        w.push(depth, T_odo, at=at, time=float(i))
    win = w.win
    lane = torch.arange(win.valid.shape[1], device=dev) % comm.size
    mine = dataclasses.replace(win, valid=win.valid & (lane[None, :] == comm.rank))
    kw = dict(stride=BA_WIN["stride"], iters=BA_WIN["iters"], odo_weight=BA_WIN["odo_weight"])
    got, diag = ba.refine_window(mine, at, 7.0, cam, params, group=comm, **kw)
    out = dict(poses=got.poses.cpu().numpy(), inliers=int(diag["inliers"]))
    if comm.rank == 0:
        ref, ref_diag = ba.refine_window(win, at, 7.0, cam, params, **kw)
        out.update(ref_poses=ref.poses.cpu().numpy(), ref_inliers=int(ref_diag["inliers"]))
    np.savez(Path(a.out) / f"rank{comm.rank}.npz", **out)


def job_distributed(comm: Comm, a) -> None:
    """tests/distributed_worker.py's job on the port's runtime."""
    dev = resolve_device(a.device)
    x = comm.all_reduce(torch.tensor([float(comm.rank)], device=dev), "sum")
    if float(x) != sum(range(comm.size)):
        raise AssertionError(f"all-reduce gave {float(x)}")
    cam = tiny_cam(64, 32)
    params = PipelineParams(stereo_border=0.0)
    from ..parallel.sharded import empty_sharded

    state = empty_sharded(1 << 13, comm.size, comm.rank, dev)
    step = make_sharded_step(comm, cam, params, active_blocks=4, block_size=128)
    scene = SyntheticScene(cam)
    last_depth = torch.zeros(cam.shape, dtype=torch.float32, device=dev)
    last_pose = stage_frame(dev, None, None, None, scene.pose(0))[3]
    for i in range(1, 4):
        rgb, depth, sem, pose = stage_frame(dev, *scene.frame(i))
        state, last_depth, stats = step(state, depth, rgb, sem, pose, last_depth, last_pose,
                                        float(i))
        last_pose = pose
    s = stats.as_dict()
    count, dropped = int(s["count"]), int(s["dropped"])
    if count <= 0 or dropped:
        raise AssertionError(f"count {count}, dropped {dropped}")
    full = gather_sharded_map(allgather_state(state, comm))
    if int(full.count) != count:
        raise AssertionError(f"gathered {int(full.count)} of {count}")
    path = str(Path(a.out) / "map.bin")
    save_checkpoint(state, comm, path)
    if comm.rank == 0:
        loaded, _, _ = load_map(path, CPU)
        if int(loaded.count) != count:
            raise AssertionError(f"checkpoint holds {int(loaded.count)} of {count}")
    print(f"rank {comm.rank}: OK count={count}", flush=True)


def job_viewer(comm: Comm, a) -> None:
    """build_map's sharded viewer loop twice: with ``MappingGUI`` writing
    snapshots on rank 0 (None elsewhere), and with no viewer on any rank,
    at the mapper job's settings (a small budget replays, the capacity
    grows, tombstones compact).  The viewer must leave the ranks' syncs,
    replays and growth as they are, so the two runs end bit for bit equal."""
    from ..build_map import gui_step_sharded
    from ..gui import MappingGUI

    dev = resolve_device(a.device)
    cam = tiny_cam(128, 64)
    params = PipelineParams(stereo_border=0.0, fuse_thresh_factor=a.fuse_thresh)
    out = {}
    for run in ("viewer", "none"):
        sm = ShardedMapper(comm, cam, params, capacity=a.capacity,
                           active_blocks=a.active_blocks, block_size=a.block_size,
                           sync_every=a.sync_every, compact_dead_frac=a.compact_dead_frac,
                           device=dev)
        gui = None
        if run == "viewer" and comm.rank == 0:
            gui = MappingGUI(cam, snapshot_dir=str(Path(a.out) / "snapshots"),
                             snapshot_every=3)
        scene = SyntheticScene(cam, step=a.scene_step)
        history = []
        for i in range(a.frames):
            frame = scene.frame(i)
            sm.process_frame(*frame)
            history.append((i, *frame[1:]))
            gui_step_sharded(gui, sm, history, (i, *frame), 3, 0)
        if gui is not None:
            gui.close()
        out[f"{run}_live"] = sm.count
        cols, counts = convert.sharded_to_numpy([sm.state])
        out.update({f"{run}_{k}": v for k, v in cols.items()})
        out[f"{run}_count"] = counts[0]
        out.update({f"{run}_event_{k}": v for k, v in sm.events.items()})
    np.savez(Path(a.out) / f"rank{comm.rank}.npz", **out)


def collective_ms(comm: Comm, shapes: list[tuple[torch.dtype, int, str]], device,
                  reps: int = 20) -> float:
    """The card's time for one frame's collectives (``shapes``: dtype,
    length, op), by the host clock over ``reps`` rounds with the queue
    drained before and after."""
    bufs = [(torch.zeros(n, dtype=dt, device=device), op) for dt, n, op in shapes]
    calls, nbytes = comm.calls, comm.bytes
    for b, op in bufs:  # warm
        comm.all_reduce(b, op)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        for b, op in bufs:
            comm.all_reduce(b, op)
    torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) * 1e3 / reps
    comm.calls, comm.bytes = calls, nbytes  # the run's counters stay the run's
    return ms


def kitti_run(comm: Comm, frames: list, capacity: int, sync_every: int, warm: int,
              window: int) -> tuple[dict, object]:
    """ShardedMapper on this rank's staged KITTI-size ``frames``, at
    chip_smoke's main-phase settings (512 active blocks of 2048 slots):
    frames/s over windows of ``window`` frames after ``warm`` (a sync at each
    edge), the card's busy ms over the last window (torch.profiler; that
    window's frames/s carry the profiler's cost and are marked), the
    K1/K2 launches and the collectives' calls and bytes per fused frame, the
    time of one frame's collectives, and the gathered map.  Returns (that
    dict, the gathered map)."""
    from torch.profiler import ProfilerActivity, profile

    from ..ops import preprocess_stencil, zbuf

    dev = frames[0][0].device
    cam, params = kitti_cam(), PipelineParams()
    sm = ShardedMapper(comm, cam, params, capacity=capacity, active_blocks=512,
                       block_size=2048, sync_every=sync_every, device=dev)
    kernels = (zbuf.KERNEL, preprocess_stencil.KERNEL)
    for k in kernels:
        k.launches = 0
    comm.calls = comm.bytes = 0
    edges = list(range(warm, len(frames) + 1, window))
    windows, prof, t0 = [], None, None
    with profile(activities=[ProfilerActivity.CUDA]):  # CUPTI's first start takes seconds
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize(dev)
    torch.cuda.synchronize(dev)
    t_run = time.perf_counter()
    for i, f in enumerate(frames):
        if i in edges[:-1]:
            _ = sm.count  # a sync
            t0 = time.perf_counter()
            if i == edges[-2]:
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.__enter__()
        sm.process_frame(*f)
        if i + 1 in edges[1:]:
            _ = sm.count
            torch.cuda.synchronize(dev)
            w = dict(frames=f"{i + 1 - window}-{i + 1}", fps=window / (time.perf_counter() - t0))
            if i + 1 == edges[-1]:
                prof.__exit__(None, None, None)
                cuda = torch.autograd.DeviceType.CUDA
                w["profiled"] = True
                w["wall_ms"] = window / w["fps"] * 1e3
                w["busy_ms"] = sum(e.self_device_time_total for e in prof.key_averages()
                                   if e.device_type == cuda
                                   and not getattr(e, "is_user_annotation", False)) / 1e3
            windows.append(w)
    run_s = time.perf_counter() - t_run
    fused = len(frames) - 1  # frame 0 only seeds
    launches = {k.name: k.launches for k in kernels}
    calls, nbytes = comm.calls, comm.bytes
    P = cam.height * cam.width
    per_frame = [(torch.int32, P, "min"), (torch.int32, P, "min"),
                 (torch.uint8, P // 2, "max"), (torch.int32, 3 + 3 * comm.size, "sum")]
    out = dict(rank=comm.rank, ranks=comm.size, backend=comm.backend, frames=len(frames),
               run_s=run_s, windows=windows, count=sm.count, capacity=sm.capacity,
               events=sm.events, launches=launches,
               launches_per_fused_frame={k: v / fused for k, v in launches.items()},
               collective_calls_per_frame=calls / fused,
               collective_bytes_per_frame=nbytes / fused,
               collective_ms_per_frame=collective_ms(comm, per_frame, dev),
               max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    return out, sm.smap()


def job_kitti(comm: Comm, a) -> None:
    """kitti_run on the frames of chip_smoke's main phase (the synthetic
    scene at KITTI resolution, step 0.8), generated and staged by each
    rank; rank 0 writes the gathered map's records."""
    dev = torch.device("cuda", torch.cuda.current_device())
    scene = SyntheticScene(kitti_cam(), step=0.8)
    frames = [stage_frame(dev, *scene.frame(i)) for i in range(a.frames)]
    out, smap = kitti_run(comm, frames, a.capacity, a.sync_every, a.warm, a.window)
    if comm.rank == 0:
        np.save(Path(a.out) / "records.npy", records(smap))
    print("RESULT " + json.dumps(out), flush=True)


JOBS = {"step": job_step, "mapper": job_mapper, "replay": job_replay, "ba": job_ba,
        "distributed": job_distributed, "viewer": job_viewer, "kitti": job_kitti}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("job", choices=sorted(JOBS))
    ap.add_argument("--out", required=True, help="directory for the job's results")
    ap.add_argument("--state", help="step: the start state (.npz)")
    ap.add_argument("--device", default=None,
                    help="the ranks' device (default: the CUDA card; an NCCL rank's own)")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--fuse-thresh", type=float, default=0.0)
    ap.add_argument("--capacity", type=int, default=1 << 13)
    ap.add_argument("--active-blocks", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--sync-every", type=int, default=4)
    ap.add_argument("--compact-dead-frac", type=float, default=0.2)
    ap.add_argument("--scene-step", type=float, default=0.6)
    ap.add_argument("--budgets", type=int, nargs="+", default=[1, 64])
    ap.add_argument("--dump-frames", action="store_true",
                    help="mapper: write the shards' prefixes in rank order after each frame")
    ap.add_argument("--warm", type=int, default=4, help="kitti: frames before the windows")
    ap.add_argument("--window", type=int, default=12, help="kitti: frames per window")
    a = ap.parse_args(argv)
    if a.device == "cpu":
        torch.set_num_threads(1)
    comm = initialize()
    try:
        os.makedirs(a.out, exist_ok=True)
        JOBS[a.job](comm, a)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
