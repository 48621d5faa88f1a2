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
  outres   the probe kernels P1 (pallas_zbuf) and P2 (outres) vs their plain
           version at the TPU probes' shapes (P = 453,620 and 1,814,480,
           A = 1,048,576 in random order, a min-id tie planted): exact; K1
           timed at the renderer's 4-class shape
  render   the render path at KITTI resolution: 20 random novel views of the
           main phase's ~4.4 M-surfel map through render_view(method="fast"),
           views/s, per-view cull sizes, budget retries, coverage, memory
  render_holds  on one of those views: K1 vs its plain version on the view's
           own candidates (exact), fast vs exact renderer, and a render at a
           mapping pose vs that input frame
  probes   the probe entry points (tools.probe_pallas_zbuf,
           tools.probe_zbuf_variants), which run P1 and P2
Each path (main, render, probes) is driven with every launch count set to 0
just before it and read just after.
Then the card's ``nvidia-smi`` line, one JSON line of per-kernel numbers, and
the final ``{"ok": true, ...}`` line.  Any failure raises (exit code != 0)
and nothing more is printed.  Without a CUDA card it exits with code 1.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import sys
import time

import numpy as np
import torch

# the port itself: in a directory without it this import fails
from surfelmapping_tpu_torch.tools.timing import HBM_BYTES_PER_S, cuda_ms
from surfelmapping_tpu_torch.tools.timing import card_line as smi_line

SEED = 0
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
INT32_MAX = 2**31 - 1


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


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


def reset_counts(counters) -> None:
    for c in counters:
        c.launches = 0


def read_counts(counters) -> dict:
    return {c.name: c.launches for c in counters}


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
    reset_counts(kernels)
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
    launches = read_counts(kernels)
    emit("main", resolution=f"{cam.width}x{cam.height}", frames=100,
         staging_s=stage_s, run_s=run_s, windows=windows, live_count=mapper.count,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         events=mapper.events, launches=launches, card=smi)
    if launches["preprocess_stencil"] < 100 or launches["zbuffer_argmin"] < 99:
        raise AssertionError(f"main: kernels not on the path: {launches}")
    emit("main_map", **map_checks(mapper.smap, scene))
    return mapper, scene, frames, launches


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


def phase_outres(dev, zbuf_mod, outres_mod) -> dict:
    """P1 and P2 against their plain version at the TPU probes' shapes,
    exact, with a min-id tie planted; K1 timed at the renderer's shape."""
    from surfelmapping_tpu_torch.tools.timing import bound_ms, packed_scatter_min

    A = 1 << 20
    rng = np.random.default_rng(SEED)
    res = {}
    for name, P in (("outres", 453_620), ("outres", 4 * 453_620), ("pallas_zbuf", 453_632),
                    ("zbuffer_argmin", 4 * 453_620)):
        zkey = rng.integers(100, 1 << 30, A).astype(np.int32)
        fpix = rng.integers(0, P, A).astype(np.int32)
        fpix[fpix == 4242] = 4243
        zkey[[5, 17, 123_456]] = 77
        fpix[[5, 17, 123_456]] = 4242
        zk = torch.from_numpy(zkey).to(dev)
        fp = torch.from_numpy(fpix).to(dev)
        if name == "zbuffer_argmin":  # K1 at the renderer's 4-class shape
            n_pix, every = P, torch.ones(A, dtype=torch.bool, device=dev)
            zb, ib = zbuf_mod.zbuffer_argmin(zk, fp, P, every)
            zr, ir = zbuf_mod.zbuffer_argmin_plain(zk, fp, P, every)
            kernel = lambda: zbuf_mod.zbuffer_argmin(zk, fp, P, every)  # noqa: E731
            plain = lambda: zbuf_mod.zbuffer_argmin_plain(zk, fp, P, every)  # noqa: E731
        else:
            if name == "outres":
                n_pix, entry = outres_mod.outres_pixels(P), outres_mod.P2
                zb, ib = outres_mod.outres(zk, fp, P)
            else:
                n_pix, entry = P, outres_mod.P1
                zb, ib = (t.reshape(-1) for t in outres_mod.pallas_zbuf(zk, fp, P))
            ref = outres_mod.zbuffer_outres_plain(zk, fp, n_pix)
            zr, ir = ref[:zb.shape[0], 1], ref[:zb.shape[0], 0]
            kernel = lambda: outres_mod.zbuffer_outres(zk, fp, n_pix, entry)  # noqa: E731
            plain = lambda: outres_mod.zbuffer_outres_plain(zk, fp, n_pix)  # noqa: E731
        torch.cuda.synchronize()
        if not (torch.equal(zb, zr) and torch.equal(ib, ir)):
            raise AssertionError(f"outres: {name} P={P}: kernel != plain on "
                                 f"{int((zb != zr).sum())} keys, {int((ib != ir).sum())} ids")
        if (int(zb[4242]), int(ib[4242])) != (77, 5):
            raise AssertionError(f"outres: {name} P={P}: tie pixel gave "
                                 f"({int(zb[4242])}, {int(ib[4242])})")
        library, (lz, li) = packed_scatter_min(zk, fp, P)
        if not (torch.equal(lz, zr[:P]) and torch.equal(li, ir[:P])):
            raise AssertionError(f"outres: {name} P={P}: library yardstick disagrees")
        max_err = max(int((zb.long() - zr.long()).abs().max()),
                      int((ib.long() - ir.long()).abs().max()))
        r = dict(P=P, A=A, buffer_pixels=n_pix, exact=True, max_abs_err=max_err,
                 empty_pixels=int((ib == INT32_MAX).sum()),
                 ms=cuda_ms(kernel, 50), plain_ms=cuda_ms(plain, 20),
                 library_ms=cuda_ms(library, 20), bound_ms=bound_ms(A, n_pix))
        res[f"{name}_{P}"] = r
    emit("outres", **res)
    return res


def phase_render(dev, mapper, scene, counters, smi: str) -> tuple:
    """The render path: 20 random novel views (seed 0) of the main phase's
    map at KITTI resolution through render_view(method="fast"), the cull
    budget fed forward from view to view as views.acquire_images does."""
    from surfelmapping_tpu_torch.ops.splat import render_view
    from surfelmapping_tpu_torch.views import random_novel_views

    cam = mapper.cam
    smap = mapper.smap  # compacted (one sync)
    views = random_novel_views([scene.pose(i) for i in range(100)], 20, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    hint, per_view = None, []
    for v in views:
        t0 = time.perf_counter()
        out = render_view(smap, v, cam, start_blocks=hint)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n_act = int(out["n_active_blocks"])
        hint = n_act + 1
        per_view.append(dict(ms=ms, n_active_blocks=n_act, candidates=n_act * 2048,
                             budget_retries=out["budget_retries"],
                             large_overflow=int(out["large_overflow"]),
                             **render_checks(out, smap.capacity, cam)))
    launches = read_counts(counters)
    median_ms = statistics.median(p["ms"] for p in per_view[2:])  # after 2 warm-up views
    r = dict(resolution=f"{cam.width}x{cam.height}", views=len(views), map_surfels=mapper.count,
             map_capacity=smap.capacity, views_per_s=1e3 / median_ms, median_view_ms=median_ms,
             max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
             per_view=per_view, card=smi)
    emit("render", **r)
    if launches["zbuffer_argmin"] < len(views):
        raise AssertionError(f"render: K1 launched {launches['zbuffer_argmin']} times "
                             f"for {len(views)} views")
    return views, per_view, launches


def render_checks(out: dict, capacity: int, cam) -> dict:
    """A rendered view is well formed: image shapes, holes where the id is
    -1, finite depth in (1, 200) m on hits, classes of the scene, map ids."""
    H, W = cam.height, cam.width
    rgb, sem, depth, ids = (out[k] for k in ("rgb", "semantic", "depth", "id"))
    hit = ids >= 0
    ok = (tuple(rgb.shape) == (H, W, 3) and tuple(sem.shape) == (H, W)
          and bool(torch.equal(hit, sem > 0))
          and bool(torch.isfinite(depth).all() and torch.isfinite(rgb).all())
          and bool(((depth > 1.0) & (depth < 200.0))[hit].all())
          and bool((depth[~hit] == 0).all())
          and set(torch.unique(sem).tolist()) <= {0, 1, 3, 11, 14}
          and bool((ids < capacity).all()))
    coverage = float(hit.float().mean())
    if not ok or coverage < 0.05:
        raise AssertionError(f"render: malformed view (coverage {coverage})")
    return dict(coverage=coverage)


def phase_render_holds(dev, mapper, scene, view, n_active: int, zbuf_mod) -> None:
    """On one rendered view: K1 vs its plain version on the view's own
    candidates, the fast renderer vs the exact one, and a render at a
    mapping pose vs that input frame."""
    from surfelmapping_tpu_torch.metrics import psnr, render_vs_frame_psnr
    from surfelmapping_tpu_torch.ops.splat import cull_for_render, fast_candidates, render_view

    cam = mapper.cam
    smap = mapper.smap
    G = smap.capacity // 2048
    budget = 1
    while budget < n_active:  # render_view's budget for this view
        budget *= 2
    budget = G if budget >= G // 2 else budget
    vt = torch.as_tensor(view, device=dev)
    culled, _, n_act = cull_for_render(smap, vt, cam, budget, 2048, margin=7)
    key, cflat, classes, _ = fast_candidates(culled, vt, cam)
    slot_valid = torch.arange(culled.capacity, device=dev) < int(n_act) * 2048
    P = len(classes) * cam.height * cam.width
    zb, ib = zbuf_mod.zbuffer_argmin(key, cflat, P, slot_valid)
    zr, ir = zbuf_mod.zbuffer_argmin_plain(key, cflat, P, slot_valid)
    if not (torch.equal(zb, zr) and torch.equal(ib, ir)):
        raise AssertionError("render_holds: k1 differs on the view's candidates")
    k1_ms = cuda_ms(lambda: zbuf_mod.zbuffer_argmin(key, cflat, P, slot_valid), 50)
    k1_plain_ms = cuda_ms(lambda: zbuf_mod.zbuffer_argmin_plain(key, cflat, P, slot_valid), 20)

    fast = render_view(smap, view, cam, start_blocks=n_active + 1, method="fast")
    exact = render_view(smap, view, cam, start_blocks=n_active + 1, method="exact")
    hf = (fast["semantic"] > 0).cpu().numpy()
    he = (exact["semantic"] > 0).cpu().numpy()
    both = he & hf
    p_fast = psnr(fast["rgb"].cpu().numpy(), exact["rgb"].cpu().numpy(), both)
    z_exact = exact["depth"].cpu().numpy()
    derr = np.abs(fast["depth"].cpu().numpy() - z_exact)
    # tests/test_render.py's 0.05 m depth limit was set on a camera of focal
    # length 100 px whose map holds surfels nearer than 6 m.  A splat spans
    # ~1.4 px wherever it was made, and its ray/plane depth changes by
    # z^2 / (f * camera height) per pixel on the ground, so the limit carries
    # over to the mutual hits nearer than 6 m * sqrt(f / 100) (16 m at KITTI)
    near = both & (z_exact < 6.0 * np.sqrt(cam.fx / 100.0))
    r = dict(k1_table_slots=culled.capacity, k1_n_valid=int(n_act) * 2048,
             k1_pixels_hit=int((ib != INT32_MAX).sum()), k1_exact=True, k1_ms=k1_ms,
             k1_plain_ms=k1_plain_ms, coverage_fast=float(hf.mean()),
             coverage_exact=float(he.mean()), exact_hits_also_fast=float(both.sum() / he.sum()),
             fast_vs_exact_psnr=p_fast, median_depth_diff=float(np.median(derr[both])),
             median_rel_depth_diff=float(np.median(derr[both] / z_exact[both])),
             near_hits=int(near.sum()), median_depth_diff_near=float(np.median(derr[near])))
    if not (abs(r["coverage_fast"] - r["coverage_exact"]) < 0.05
            and r["exact_hits_also_fast"] >= 0.9 and p_fast > 25.0
            and r["near_hits"] > 1000 and r["median_depth_diff_near"] < 0.05):
        raise AssertionError(f"render_holds: fast vs exact out of limits {r}")

    rgb, _, _, pose = scene.frame(99)
    p_frame, hit_frac = render_vs_frame_psnr(mapper, rgb, pose)
    r.update(paired_frame=99, paired_psnr=p_frame, paired_hit_fraction=hit_frac)
    emit("render_holds", **r)
    if not p_frame > 20.0:
        raise AssertionError(f"render_holds: render at the mapping pose has PSNR {p_frame}")


def phase_probes(counters) -> dict:
    """The probe entry points, which run P1 and P2 (and K1 beside them)."""
    from surfelmapping_tpu_torch.tools import probe_pallas_zbuf, probe_zbuf_variants

    reset_counts(counters)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        probe_pallas_zbuf.main(["--iters", "10"])
        probe_zbuf_variants.main(["--iters", "10"])
    launches = read_counts(counters)
    emit("probes", launches=launches,
         lines=[json.loads(line) for line in buf.getvalue().splitlines()])
    if launches["pallas_zbuf"] < 1 or launches["outres"] < 1:
        raise AssertionError(f"probes: P1/P2 not launched: {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from surfelmapping_tpu_torch.config import PipelineParams
    from surfelmapping_tpu_torch.io.synthetic import kitti_cam
    from surfelmapping_tpu_torch.ops import preprocess_stencil as k2_mod
    from surfelmapping_tpu_torch.ops import zbuf as zbuf_mod
    from surfelmapping_tpu_torch.ops import zbuf_outres as outres_mod
    from surfelmapping_tpu_torch.ops.cuda_lib import build_all
    from surfelmapping_tpu_torch.ops.transforms import full_precision_matmul

    full_precision_matmul()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = smi_line()
    emit("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    kernels = [zbuf_mod.KERNEL, k2_mod.KERNEL, outres_mod.KERNEL]
    counters = kernels + [outres_mod.P1, outres_mod.P2]
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
    probe = phase_outres(dev, zbuf_mod, outres_mod)
    phase_small(dev)
    mapper, scene, frames, fusion = phase_main(dev, cam, params, counters, smi)
    phase_holds(dev, mapper, frames, zbuf_mod)
    views, per_view, render = phase_render(dev, mapper, scene, counters, smi)
    phase_render_holds(dev, mapper, scene, views[0], per_view[0]["n_active_blocks"], zbuf_mod)
    probes = phase_probes(counters)
    emit("paths", launches=dict(main=fusion, render=render, probes=probes))
    p1, p2 = probe["pallas_zbuf_453632"], probe["outres_1814480"]

    table = [
        dict(name="zbuffer_argmin", route="cuda", source=zbuf_mod.KERNEL.repo_source,
             replaces="surfelmapping_tpu/ops/pallas_zbuf.py:188",
             launches=fusion["zbuffer_argmin"] + render["zbuffer_argmin"],
             max_abs_err=k1["max_abs_err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by="bytes", library_ms=k1["library_ms"]),
        dict(name="preprocess_stencil", route="cuda", source=k2_mod.KERNEL.repo_source,
             replaces="surfelmapping_tpu/ops/pallas_preprocess.py:188",
             launches=fusion["preprocess_stencil"], max_abs_err=k2["max_abs_err"],
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None),
        dict(name="pallas_zbuf", route="cuda", source=outres_mod.KERNEL.repo_source,
             replaces="tools/probe_pallas_zbuf.py:94", launches=probes["pallas_zbuf"],
             max_abs_err=p1["max_abs_err"], ms=p1["ms"], plain_ms=p1["plain_ms"],
             bound_ms=p1["bound_ms"], bound_by="bytes", library_ms=p1["library_ms"]),
        dict(name="outres", route="cuda", source=outres_mod.KERNEL.repo_source,
             replaces="tools/probe_zbuf_variants.py:66", launches=probes["outres"],
             max_abs_err=p2["max_abs_err"], ms=p2["ms"], plain_ms=p2["plain_ms"],
             bound_ms=p2["bound_ms"], bound_by="bytes", library_ms=p2["library_ms"]),
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
