#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (surfelmapping_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  device   card name, count, ``nvidia-smi`` name and power limit
  build    both kernels built from the sources in the checkout (one nvcc per
           source, started together), with ptxas' register/shared/spill lines
  k1       the z-buffer kernel vs its plain version at the index map's shapes
           (P = 453,620 pixels, A = 1,048,576 candidates): exact
  k2       the preprocess stencil kernel vs its plain version on 370x1226
           frames: atol 1e-4
  small    the main path on a 128x96 camera, on the card vs on the CPU
           (plain versions): identical per-frame stats, maps to 1e-5
  main     the main path at KITTI resolution (1226x370): 100 synthetic frames
           through SurfelMapper.process_frame at bench.py's operating point,
           frames/s per window, kernel launch counts, map checks
  holds    the kernels vs their plain versions on the main path's own state
Then the card's ``nvidia-smi`` line, one JSON line of per-kernel numbers, and
the final ``{"ok": true, ...}`` line.  Any failure raises (exit code != 0)
and nothing more is printed.  Without a CUDA card it exits with code 1.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
INT32_MAX = 2**31 - 1


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` on the card by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def phase_k1(dev, zbuf_mod) -> dict:
    """K1 against its plain version at the index map's shapes."""
    P, A, nv = 453_620, 1 << 20, 700_001
    rng = np.random.default_rng(SEED)
    zkey = rng.integers(100, 1 << 30, A).astype(np.int32)
    fpix = rng.integers(0, P, A).astype(np.int32)
    inval = rng.uniform(size=A) < 0.3
    zkey[inval] = INT32_MAX
    fpix[inval] = P
    # min-id tie: three candidates with one key on one pixel, nothing nearer
    fpix[fpix == 4242] = P
    zkey[[5, 17, 123_456]] = 77
    fpix[[5, 17, 123_456]] = 4242
    zk = torch.from_numpy(zkey).to(dev)
    fp = torch.from_numpy(fpix).to(dev)
    # candidates past n_valid keep valid-looking keys: the kernel must not
    # read them (the plain version masks them out)
    slot_valid = torch.arange(A, device=dev) < nv

    zb, ib = zbuf_mod.zbuffer_argmin(zk, fp, P, slot_valid)
    zr, ir = zbuf_mod.zbuffer_argmin_plain(zk, fp, P, slot_valid)
    torch.cuda.synchronize()
    if not (torch.equal(zb, zr) and torch.equal(ib, ir)):
        raise AssertionError(f"k1: kernel != plain on {int((zb != zr).sum())} keys, "
                             f"{int((ib != ir).sum())} ids")
    if int(zb[4242]) != 77 or int(ib[4242]) != 5:
        raise AssertionError(f"k1: tie pixel gave ({int(zb[4242])}, {int(ib[4242])})")
    max_err = max(int((zb.long() - zr.long()).abs().max()), int((ib.long() - ir.long()).abs().max()))

    # library yardstick: one scatter_reduce_ of the packed (key << 32 | id)
    valid = slot_valid & (zk != INT32_MAX)
    pix = torch.where(valid, fp, P).long()
    vals = (zk.long() << 32) | torch.arange(A, device=dev)
    empty = torch.full((P + 1,), (INT32_MAX << 32) | INT32_MAX, dtype=torch.int64, device=dev)
    lib = empty.scatter_reduce(0, pix, vals, "amin")[:P]
    if not (torch.equal((lib >> 32).int(), zr) and torch.equal((lib & 0xFFFFFFFF).int(), ir)):
        raise AssertionError("k1: library yardstick disagrees")

    ms = cuda_ms(lambda: zbuf_mod.zbuffer_argmin(zk, fp, P, slot_valid), 50)
    plain_ms = cuda_ms(lambda: zbuf_mod.zbuffer_argmin_plain(zk, fp, P, slot_valid), 20)
    library_ms = cuda_ms(lambda: empty.scatter_reduce(0, pix, vals, "amin"), 20)
    bound_ms = (8.0 * nv + 8.0 * P) / HBM_BYTES_PER_S * 1e3
    r = dict(P=P, A=A, n_valid=nv, exact=True, max_abs_err=max_err, ms=ms,
             plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms)
    emit("k1", **r)
    return r


def k2_ops_per_pixel(radius: int) -> int:
    """f32 operations per pixel: 3 per smooth tap (multiply, two adds),
    2 per support tap (subtract, compare) in two passes, one divide."""
    taps = (2 * radius + 1) ** 2
    return 3 * taps + 2 * 2 * 8 + 1


def phase_k2(dev, cam, params) -> dict:
    """K2 against its plain version on KITTI-sized synthetic frames."""
    from surfelmapping_tpu_torch.io.synthetic import SyntheticScene
    from surfelmapping_tpu_torch.ops.preprocess import metricize_depth, stencil_chain_plain
    from surfelmapping_tpu_torch.ops.preprocess_stencil import preprocess_stencil

    rng = np.random.default_rng(SEED)
    cases = [(SyntheticScene(cam), 3), (SyntheticScene(cam, noise_mm=40.0), 7)]
    worst, flips = 0.0, 0
    for scene, idx in cases:
        _, depth, sem, _ = scene.frame(idx, rng)
        metric = metricize_depth(torch.from_numpy(depth.astype(np.int32)).to(dev), cam, params)
        semantic = torch.from_numpy(sem.astype(np.int32)).to(dev)
        got = preprocess_stencil(metric, semantic, cam, params)
        ref = stencil_chain_plain(metric, semantic, cam, params)
        torch.cuda.synchronize()
        worst = max(worst, float((got - ref).abs().max()))
        flips += int(((got == 0) != (ref == 0)).sum())
        kept = float((ref > 0).float().mean())
        if not 0.05 < kept < 0.999:
            raise AssertionError(f"k2: degenerate test frame (kept {kept})")
    if worst > 1e-4:
        raise AssertionError(f"k2: max |kernel - plain| = {worst} > 1e-4 "
                             f"({flips} zero/non-zero flips)")
    P = cam.height * cam.width
    ms = cuda_ms(lambda: preprocess_stencil(metric, semantic, cam, params), 50)
    plain_ms = cuda_ms(lambda: stencil_chain_plain(metric, semantic, cam, params), 5, 1)
    ops = P * k2_ops_per_pixel(params.smooth_radius)
    bytes_ = 12.0 * P
    bound_ms = max(bytes_ / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    bound_by = "operations" if ops / F32_OPS_PER_S > bytes_ / HBM_BYTES_PER_S else "bytes"
    r = dict(H=cam.height, W=cam.width, max_abs_err=worst, zero_nonzero_flips=flips,
             ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
             f32_ops=ops)
    emit("k2", **r)
    return r


def phase_small(dev) -> None:
    """The main path on a tiny camera: the card vs the CPU's plain versions."""
    from surfelmapping_tpu_torch.config import MapConfig, PipelineParams
    from surfelmapping_tpu_torch.io.synthetic import SyntheticScene, tiny_cam
    from surfelmapping_tpu_torch.pipeline import SurfelMapper

    cam = tiny_cam(128, 96)
    params = PipelineParams(fuse_thresh_factor=0.05)
    scene = SyntheticScene(cam, step=0.4)
    mappers = [SurfelMapper(cam, params, MapConfig(capacity=1 << 16), device=d)
               for d in (dev, "cpu")]
    for i in range(5):
        frame = scene.frame(i)
        st = [{k: int(v) for k, v in m.process_frame(*frame).items()} for m in mappers]
        if st[0] != st[1]:
            raise AssertionError(f"small: frame {i} stats differ card {st[0]} cpu {st[1]}")
    n = mappers[0].count
    if n != mappers[1].count or n == 0:
        raise AssertionError(f"small: counts {n} vs {mappers[1].count}")
    a, b = mappers[0].smap, mappers[1].smap
    for k in ("px", "py", "pz", "conf", "init_t", "last_t", "radius"):
        np.testing.assert_allclose(a.column(k)[:n].cpu().numpy(), b.column(k)[:n].numpy(),
                                   rtol=1e-5, err_msg=k)
    for k in ("nx", "ny", "nz"):  # unit vectors: error relative to length 1
        np.testing.assert_allclose(a.column(k)[:n].cpu().numpy(), b.column(k)[:n].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    if not torch.equal(a.column("colorsem")[:n].cpu(), b.column("colorsem")[:n]):
        raise AssertionError("small: colorsem bits differ")
    emit("small", frames=5, count=n, stats_equal=True)


def map_checks(smap, scene) -> dict:
    """The fused map lies on the synthetic scene: finite values, unit
    normals, ground surfels at y = ground_y, wall surfels at |x| = wall_x."""
    from surfelmapping_tpu_torch.ops.colors import decode_color

    n = int(smap.count)
    cols = {k: smap.column(k)[:n] for k in ("px", "py", "pz", "nx", "ny", "nz", "radius", "conf")}
    finite = all(bool(torch.isfinite(v).all()) for v in cols.values())
    nlen = torch.sqrt(cols["nx"] ** 2 + cols["ny"] ** 2 + cols["nz"] ** 2)
    unit = bool(((nlen - 1).abs() < 1e-4).all())
    _, sem = decode_color(smap.column("colorsem")[:n])
    ground, walls = sem == 0, sem == 2
    g_ok = float(((cols["py"][ground] - scene.ground_y).abs() < 0.15).float().mean())
    w_ok = float(((cols["px"][walls].abs() - scene.wall_x).abs() < 0.3).float().mean())
    r = dict(n=n, finite=finite, unit_normals=unit, ground_surfels=int(ground.sum()),
             ground_within_15cm=g_ok, wall_surfels=int(walls.sum()), wall_within_30cm=w_ok)
    if not (finite and unit and n > 0 and g_ok > 0.99 and w_ok > 0.99):
        raise AssertionError(f"main: map checks failed {r}")
    return r


def phase_main(dev, cam, params, kernels, smi: str) -> tuple:
    """bench.py's operating point on the port's entry points."""
    from surfelmapping_tpu_torch.config import MapConfig
    from surfelmapping_tpu_torch.io.synthetic import SyntheticScene
    from surfelmapping_tpu_torch.pipeline import SurfelMapper

    mapper = SurfelMapper(
        cam, params,
        MapConfig(capacity=1 << 24, active_blocks=512, freeze_active_budget=True),
        sync_every=32,
    )
    scene = SyntheticScene(cam, step=0.8)
    t0 = time.perf_counter()
    frames = [mapper.stage_frame(*scene.frame(i)) for i in range(100)]
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    windows, t_start = [], None
    t_run = time.perf_counter()
    for i, frame in enumerate(frames):
        if i in (10, 40, 80):
            _ = mapper.count  # sync
            t_start = time.perf_counter()
        mapper.process_frame(*frame)
        if i + 1 in (30, 60, 100):
            surfels = mapper.count  # sync: the window's work is done
            dt = time.perf_counter() - t_start
            lo = i + 1 - 20
            windows.append(dict(frames=f"{lo}-{i + 1}", fps=20 / dt, surfels=surfels,
                                card=smi))
    run_s = time.perf_counter() - t_run
    launches = {k.name: k.launches for k in kernels}
    emit("main", resolution=f"{cam.width}x{cam.height}", frames=100,
         staging_s=stage_s, run_s=run_s, windows=windows, live_count=mapper.count,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         events=mapper.events, launches=launches, card=smi)
    if launches["preprocess_stencil"] < 100 or launches["zbuffer_argmin"] < 99:
        raise AssertionError(f"main: kernels not on the path: {launches}")
    emit("main_map", **map_checks(mapper.smap, scene))
    return mapper, frames, launches


def phase_holds(dev, mapper, frames, zbuf_mod) -> None:
    """The kernels vs their plain versions on the main path's own state."""
    from surfelmapping_tpu_torch.ops.active import index_candidates
    from surfelmapping_tpu_torch.ops.preprocess import (
        metricize_depth, preprocess_frame, stencil_chain_plain)
    from surfelmapping_tpu_torch.ops.transforms import invert_se3

    cam, params = mapper.cam, mapper.params
    rgb, depth, sem, pose = frames[-1]
    at = mapper.active_table(pose)
    zkey, fpix = index_candidates(at, invert_se3(pose), float(mapper.tick), cam, params)
    P = cam.height * cam.width
    zb, ib = zbuf_mod.zbuffer_argmin(zkey, fpix, P, at.slot_valid)
    zr, ir = zbuf_mod.zbuffer_argmin_plain(zkey, fpix, P, at.slot_valid)
    n_valid = int(at.slot_valid.sum())
    if not (torch.equal(zb, zr) and torch.equal(ib, ir)):
        raise AssertionError("holds: k1 differs on the mapper's active table")
    k1_ms = cuda_ms(lambda: zbuf_mod.zbuffer_argmin(zkey, fpix, P, at.slot_valid), 50)
    k1_plain_ms = cuda_ms(lambda: zbuf_mod.zbuffer_argmin_plain(zkey, fpix, P, at.slot_valid), 20)

    got = preprocess_frame(depth, sem, cam, params)
    ref = stencil_chain_plain(metricize_depth(depth, cam, params), sem, cam, params)
    err = float((got - ref).abs().max())
    if err > 1e-4:
        raise AssertionError(f"holds: k2 differs by {err}")
    emit("holds", k1_table_slots=at.size, k1_n_valid=n_valid,
         k1_pixels_hit=int((ib != INT32_MAX).sum()), k1_exact=True, k1_ms=k1_ms,
         k1_plain_ms=k1_plain_ms, k2_max_abs_err=err)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the port itself; in a directory without it this import fails
    from surfelmapping_tpu_torch.config import PipelineParams
    from surfelmapping_tpu_torch.io.synthetic import kitti_cam
    from surfelmapping_tpu_torch.ops import preprocess_stencil as k2_mod
    from surfelmapping_tpu_torch.ops import zbuf as zbuf_mod
    from surfelmapping_tpu_torch.ops.cuda_lib import build_all
    from surfelmapping_tpu_torch.ops.transforms import full_precision_matmul

    full_precision_matmul()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = smi_line()
    emit("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    kernels = [zbuf_mod.KERNEL, k2_mod.KERNEL]
    t0 = time.perf_counter()
    build_all(kernels)
    build_s = time.perf_counter() - t0
    ptxas = {k.name: [ln.strip() for ln in k.build_log.splitlines()
                      if "registers" in ln or "spill" in ln or "smem" in ln]
             for k in kernels}
    emit("build", seconds=build_s, ptxas=ptxas)

    cam, params = kitti_cam(), PipelineParams()
    k1 = phase_k1(dev, zbuf_mod)
    k2 = phase_k2(dev, cam, params)
    phase_small(dev)
    mapper, frames, launches = phase_main(dev, cam, params, kernels, smi)
    phase_holds(dev, mapper, frames, zbuf_mod)

    table = [
        dict(name="zbuffer_argmin", route="cuda", source=zbuf_mod.KERNEL.repo_source,
             replaces="surfelmapping_tpu/ops/pallas_zbuf.py:188",
             launches=launches["zbuffer_argmin"], max_abs_err=k1["max_abs_err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by="bytes", library_ms=k1["library_ms"]),
        dict(name="preprocess_stencil", route="cuda", source=k2_mod.KERNEL.repo_source,
             replaces="surfelmapping_tpu/ops/pallas_preprocess.py:188",
             launches=launches["preprocess_stencil"], max_abs_err=k2["max_abs_err"],
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None),
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
