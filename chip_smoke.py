#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (surfelmapping_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  device   card name, count, ``nvidia-smi`` name and power limit
  build    the kernels built from the sources in the checkout (one nvcc per
           source, started together), with ptxas' register/shared/spill
           lines, K2's CTAs per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
           and its SASS instructions per smooth tap (cuobjdump -sass), and
           the shared-memory atomics in P1/P2's resolve pass (its SASS)
  k1       the z-buffer kernel vs its plain version, exact, at the index
           map's shape (P = 453,620 pixels, A = 1,048,576 candidates,
           n_valid = 700,001; also n_valid = 0 and A) and at the renderer's
           (P = 1,814,480, all A valid); its device launches per call (the
           profiler); warm and cold-L2 times beside the library call on the
           candidates K1 really scatters
  k2       the preprocess stencil kernel vs its plain version, bit for bit:
           370x1226 KITTI frames, shapes off the tile, radii 0, 1, 3, 6,
           stereo borders 0 and 80, one class everywhere, the class INT32_MIN
  small    the main path on a 128x96 camera, on the card vs on the CPU
           (plain versions): identical per-frame stats, every map column
           bit for bit; the pose math (compose, invert_se3, transforms.acos)
           bit for bit on random inputs, beside the torch ops it replaced
  small_reference  the reference-form fusion ops on a 128x96 camera, card
           vs CPU from one map: build_index_map -> associate -> fuse_active
           -> append_flat, record for record; index_resolve (the three-op
           z-buffer) against K1 on the card at the index map's shape
           (P = 453,620, A = 2^20, random keys and many ties), exact
  main     the main path at KITTI resolution (1226x370): 100 synthetic frames
           through SurfelMapper.process_frame at bench.py's operating point,
           frames/s per window, kernel launch counts, map checks
  holds    the kernels vs their plain versions on the main path's own state
  associate  the association kernel vs its plain version, every column bit
           for bit: tools/assoc_cases.py's cases (tombstones, padding, empty
           and stray index pixels, sky and moving classes, index_factor 1
           and 2, 1226x370) and the main path's own last frame; timed there
           warm and cold beside its bytes bound and the plain version
  outres   the probe kernels P1 (pallas_zbuf) and P2 (outres) vs their plain
           version at the TPU probes' shapes (P = 453,620 and 1,814,480,
           A = 1,048,576 in random order, a min-id tie planted), then at both
           shapes in block order, all in one tile and with signed keys
           (INT32_MIN among them), and through zbuffer_outres with a ragged A,
           A = 0 and all keys INT32_MAX: exact; each case warm and cold
           beside the library call, with device launches per call
  render   the render path at KITTI resolution: 20 random novel views of the
           main phase's ~4.4 M-surfel map through render_view(method="fast"),
           views/s, per-view cull sizes, budget retries, coverage, memory
  render_holds  on one of those views: K1 vs its plain version on the view's
           own candidates (exact), fast vs exact renderer, and a render at a
           mapping pose vs that input frame
  dilate   the dilation kernel vs the plain loop, bit for bit: at the
           renderer's shape (370x1226, classes 1, 2, 3, 5) on
           tools/dilate_cases.py's cases and on that view's own K1 buffers;
           timed there warm and cold beside its bytes bound and the loop
  cull     the cull's visibility kernel vs its plain form, bit for bit: on
           tools/cull_cases.py's cases (2^20 slots, blocks of 32, 256 and
           2048) and at the render cell's shape, the main map's columns
           padded with dead slots to 2^26 (G = 32,768 blocks of 2048), from
           each of the render phase's views; timed there warm and cold
           beside its bytes bound (16 B a slot) and the plain form
  probes   the probe entry points (tools.probe_pallas_zbuf,
           tools.probe_zbuf_variants), which run P1 and P2
  small_icp  tracking on a 128x96 camera, on the card vs on the CPU (plain
           versions) from the same map and window: refine_pose and
           refine_window within 1e-5 m and 1e-5 rad, inliers within 0.1%
  icp_ba   the tracking path at KITTI resolution through build_map's Tracker,
           as the JAX package's experiment ran it (tools/record_parity.py):
           40 frames of the box-corridor scene with a 0.02 m/frame random
           walk on the input poses (seed 0), ICP alone and ICP + BA (window 5,
           odometry weight 1e4); ATE of the input poses, of ICP and of
           ICP+BA, frames/s, inliers, K1 launches per tracked frame
  icp_holds  K1 vs its plain version on an ICP iteration's own candidates
           from the icp_ba map (exact), beside its bound and the library call
  small_spade  the SPADE generator at ngf 16, crop 64, batch 2 (aspect 1.0
           and 3.25, and the VAE path with a style image and from z = 0) on
           the card vs the CPU from the same weights: the image before its
           tanh within 1e-4 of its largest magnitude; the nearest resize
           card vs CPU at every ratio the generator takes
  spade    the SPADE serving chain at full width (ngf 64, seeded weights) on
           the render phase's 20 novel views of the main map: render_view
           (K1) -> u8 label -> spade_test.enhance_frame -> composite with the
           render's semantic, at the KITTI inference geometry (crop 1248,
           aspect 3.25: 384x1248) and the CLI default (crop 256: 256x256);
           enhanced frames/s, the generator's card time per image beside its
           float32 bound (FLOPs from the layer shapes), launches, memory,
           the card's idle share and top kernels over 4 frames of the chain,
           and the host ms of the chain's profiler ranges
  small_spade_train  one D step and one G step (ngf 16, crop 64, batch 2,
           num_d 2, n_layers_d 4, VGG on; without and with the VAE) on the
           card vs the CPU from the same variables and batch: losses within
           1e-4 relative, stored SN u/sigma and BN statistics within 1e-5,
           gradients (Adam's mu) within 1e-4 of each leaf, in float64
  spade_train  SPADE training at the CLI's defaults (ngf 64, crop 256,
           batch 1, VGG on) on 12 K1 renders of the main map paired with
           the scene's RGB: spade_train for 2 epochs x 10 steps, a resume,
           spade_test from the checkpoint; wall ms per iteration, each
           step's card ms and launches vs its float32 bound, idle share,
           memory, first and last losses
  spade_dp  SPADE data-parallel training at the same width on those K1
           renders, two gloo ranks sharing the card: (a) a D and a G step
           over the two ranks held against one process on the same batch,
           the ranks' states bit-identical; (b) spade_train --devices 2, a
           resume, the checkpoint read back bit for bit; (c) wall ms per
           iteration at one process and two ranks, the gradient and batch
           norm collectives' bytes and ms, idle share, memory per rank
  kitti_dir  the dataset path at KITTI resolution: the main phase's 100 frames
           written as a KITTI-layout directory (PNGs, calibration, poses),
           decoded bit-equal (PIL, or the native libpng library where it
           builds), build_map DIR's map equal record for record to a
           mapper's at the reader's poses, --frames and --sub-level, the
           map IO, load_map --calib paired renders, tools/run_e2e, the
           viewer's card work; frames/s beside the main phase's windows,
           decode and upload ms per frame, the card's idle share
  sharded  the sharded engine (parallel/sharded.py) at KITTI resolution on
           the main phase's first 36 frames: (a) one rank over NCCL, its map
           equal to a single-card SurfelMapper's (count, sorted records bit
           for bit); (b) two gloo ranks sharing the card (the port's
           launcher), the same count and >= 99% of the records; frames/s per
           window, the card's busy share, the collectives' bytes and ms per
           frame, K1 and K2 launches per rank and frame
Each path (main, render, probes, icp_ba, spade, spade_train, kitti_dir, sharded) is driven with every launch
count set to 0 just before it and read just after; spade_dp runs no kernel of the port.  Kernel times are by CUDA events
(tools/timing.py), warm in L2: ``ms`` and ``library_ms`` over calls issued
back to back (the larger of the host's and the card's time per call);
``ms_device`` and ``library_ms_device`` with the host's launches queued
ahead (the card's time alone); ``*_device_cold`` the same with L2 flushed
by a 64 MB write before each call.
Then the card's ``nvidia-smi`` line, one JSON line of per-kernel numbers, and
the final ``{"ok": true, ...}`` line.  Any failure raises (exit code != 0)
and nothing more is printed.  Without a CUDA card it exits with code 1.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# the port itself: in a directory without it this import fails
from surfelmapping_tpu_torch.ops import active
from surfelmapping_tpu_torch.tools.compare import (flat, float32_gradients_held,
                                                   float32_steps_held, gap_summary, grad_gaps,
                                                   step_gaps)
from surfelmapping_tpu_torch.tools.timing import HBM_BYTES_PER_S, cuda_ms, cuda_ms_cold
from surfelmapping_tpu_torch.tools.timing import card_line as smi_line

SEED = 0
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
TRAIN_WARM, TRAIN_TIMED = 4, 64  # spade_train: iterations before and in its timed window (even)
DP_WARM, DP_TIMED = 4, 16  # spade_dp: the same, for each job (even)
# spade_train's kernels by kind, the first pattern that matches a kernel's name: cuDNN's
# direct and implicit-GEMM convolutions, its FFT convolutions (the transforms and the
# complex float2 GEMVs between them), real GEMVs (the spectral norms' power steps)
TRAIN_KERNEL_GROUPS = (("fft_conv", r"fft|float2"),
                       ("conv_gemm", r"conv|gemm|cudnn|cutlass|sm80_|sm90_|xmma|winograd"),
                       ("gemv", r"gemv"))
INT32_MAX = 2**31 - 1


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def device_events(prof) -> list:
    """The card's own events (kernels, copies, fills) of a torch.profiler
    run, without the device side of the host's profiler ranges."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.key_averages()
            if e.device_type == cuda and not getattr(e, "is_user_annotation", False)]


def device_profile(fn, calls: int = 8, tries: int = 3) -> tuple[int, float]:
    """What one call of ``fn`` puts on the card: torch.profiler's count of
    kernels over ``calls`` calls, per call, rounded (a trace now and then
    drops a kernel of a single call), and their device ms per call.

    The profiler loses events now and then: on the H100 one trace in about
    a hundred came back with next to none, and once a probe kernel's trace
    came back with half of them.  So two traces are taken and the one with
    more events is kept; every ``fn`` measured here launches at least one
    kernel per call, so a trace with fewer events than ``calls`` is printed
    as a loss and taken again, up to ``tries`` traces.  A trace that stays
    short is returned as it is, and the caller's launch check fails on it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    traces = []
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        traces.append((sum(e.count for e in events), events))
        if traces[-1][0] < calls:
            emit("profiler", lost_trace=attempt, of=tries, events=traces[-1][0], calls=calls)
        elif len(traces) >= 2:
            break
    n_events, events = max(traces, key=lambda t: t[0])
    return (round(n_events / calls),
            sum(e.self_device_time_total for e in events) / 1e3 / calls)


def k1_case(dev, P: int, A: int, invalid: float):
    """A candidates over P pixels in random order (seed 0); an ``invalid``
    share with key INT32_MAX sent to pixel P, as index_candidates sends
    them; a min-id tie planted on pixel 4242."""
    rng = np.random.default_rng(SEED)
    zkey = rng.integers(100, 1 << 30, A).astype(np.int32)
    fpix = rng.integers(0, P, A).astype(np.int32)
    inval = rng.uniform(size=A) < invalid
    zkey[inval] = INT32_MAX
    fpix[inval] = P
    fpix[fpix == 4242] = P
    zkey[[5, 17, 123_456]] = 77
    fpix[[5, 17, 123_456]] = 4242
    return torch.from_numpy(zkey).to(dev), torch.from_numpy(fpix).to(dev)


def phase_k1(dev, zbuf_mod) -> dict:
    """K1 against its plain version at the index map's and the renderer's
    shapes, with a device n_valid; the library call gets only the
    candidates K1 scatters, selected before it is timed."""
    A = 1 << 20
    res = {}
    for shape, P, nv, invalid in (("index", 453_620, 700_001, 0.3),
                                  ("render", 4 * 453_620, A, 0.0)):
        zk, fp = k1_case(dev, P, A, invalid)
        checks = (0, A, nv) if shape == "index" else (nv,)
        for n in checks:  # n_valid = 0, A, mid: exact against the plain version
            n_valid = torch.tensor(n, dtype=torch.int32, device=dev)
            packed = zbuf_mod.zbuffer_argmin_packed(zk, fp, P, n_valid)
            zb, ib = zbuf_mod.key_id_views(packed)
            zr, ir = zbuf_mod.zbuffer_argmin_plain(zk, fp, P, n_valid)
            torch.cuda.synchronize()
            if not (torch.equal(zb, zr) and torch.equal(ib, ir)):
                raise AssertionError(f"k1 {shape} n_valid={n}: kernel != plain on "
                                     f"{int((zb != zr).sum())} keys, {int((ib != ir).sum())} ids")
            want = (77, 5) if n > 123_456 else (INT32_MAX, INT32_MAX)
            if (int(zb[4242]), int(ib[4242])) != want:
                raise AssertionError(f"k1 {shape} n_valid={n}: tie pixel gave "
                                     f"({int(zb[4242])}, {int(ib[4242])})")
        max_err = max(int((zb.long() - zr.long()).abs().max()),
                      int((ib.long() - ir.long()).abs().max()))
        launches = device_profile(lambda: zbuf_mod.zbuffer_argmin_packed(zk, fp, P, n_valid))[0]

        # library yardstick: one scatter_reduce_ of the packed (key << 32 | id)
        # of the candidates K1 scatters, selected here, outside the timing
        ids = torch.arange(A, device=dev)
        sel = (ids < nv) & (zk != INT32_MAX) & (fp >= 0) & (fp < P)
        pix, vals = fp[sel].long(), ((zk.long() << 32) | ids)[sel]
        empty = torch.full((P,), (INT32_MAX << 32) | INT32_MAX, dtype=torch.int64, device=dev)
        library = lambda: empty.scatter_reduce(0, pix, vals, "amin")  # noqa: E731
        if not torch.equal(library(), packed):
            raise AssertionError(f"k1 {shape}: library yardstick disagrees")

        kernel = lambda: zbuf_mod.zbuffer_argmin_packed(zk, fp, P, n_valid)  # noqa: E731
        res[shape] = dict(
            P=P, A=A, n_valid=nv, scattered=int(sel.sum()), exact=True, max_abs_err=max_err,
            device_launches_per_call=launches, ms=cuda_ms(kernel, 50),
            ms_device=cuda_ms(kernel, 50, hold=True), ms_device_cold=cuda_ms_cold(kernel, 20),
            plain_ms=cuda_ms(lambda: zbuf_mod.zbuffer_argmin_plain(zk, fp, P, n_valid), 20),
            library_ms=cuda_ms(library, 50), library_ms_device=cuda_ms(library, 50, hold=True),
            library_ms_device_cold=cuda_ms_cold(library, 20),
            bound_ms=(8.0 * nv + 8.0 * P) / HBM_BYTES_PER_S * 1e3)
        if launches != 2:
            raise AssertionError(f"k1 {shape}: {launches} device launches per call, not 2")
    emit("k1", **res)
    return res


def sass_opcodes(kernel, function: str, modifiers: bool = False) -> collections.Counter:
    """Opcode counts of the first function whose mangled name contains
    ``function`` in a kernel's built library (``cuobjdump -sass``); with
    ``modifiers``, each opcode with its modifiers (``ATOMS.CAS.64``)."""
    from surfelmapping_tpu_torch.ops.cuda_lib import nvcc_path

    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(kernel.library_path())],
                          check=True, capture_output=True, text=True, timeout=120).stdout
    op = r"[A-Z][A-Z0-9_]*(?:\.[A-Z0-9_]+)*" if modifiers else r"[A-Z][A-Z0-9_]*"
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        if function in fn.split("\n", 1)[0]:
            return collections.Counter(
                re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?(" + op + ")", fn))
    raise AssertionError(f"build: no function {function} in the SASS of {kernel.name}")


def k2_design(k2_mod, radius: int) -> dict:
    """K2's occupancy and its SASS instructions per smooth tap: the radius-R
    kernel's instructions less the radius-0 kernel's, over the (2R+1)^2 - 1
    taps that R adds to each of a thread's pixels."""
    occ = k2_mod.occupancy(radius)
    h, w = occ["tile"]
    pixels_per_thread = (h + 2) * (w + 2) // occ["threads_per_cta"]
    big = sass_opcodes(k2_mod.KERNEL, f"stencil_kernelILi{radius}E")
    small = sass_opcodes(k2_mod.KERNEL, "stencil_kernelILi0E")
    taps = ((2 * radius + 1) ** 2 - 1) * pixels_per_thread
    delta = big - small
    return dict(**occ, smooth_pixels_per_thread=pixels_per_thread,
                sass_instructions=sum(big.values()),
                sass_instructions_per_tap=(sum(big.values()) - sum(small.values())) / taps,
                sass_per_tap_by_opcode={k: v / taps for k, v in delta.most_common(8)})


def k2_ops_per_pixel(radius: int) -> int:
    """f32 operations per pixel: 3 per smooth tap (multiply, two adds),
    2 per support tap (subtract, compare) in two passes, one divide."""
    taps = (2 * radius + 1) ** 2
    return 3 * taps + 2 * 2 * 8 + 1


def phase_k2(dev, cam, params) -> dict:
    """K2 against its plain version, bit for bit, on KITTI-sized synthetic
    frames and on the stencil cases of io/synthetic.py."""
    from surfelmapping_tpu_torch.config import CameraIntrinsics, PipelineParams
    from surfelmapping_tpu_torch.io.synthetic import STENCIL_CASES, SyntheticScene, stencil_frame
    from surfelmapping_tpu_torch.ops.preprocess import metricize_depth, stencil_chain_plain
    from surfelmapping_tpu_torch.ops.preprocess_stencil import preprocess_stencil

    rng = np.random.default_rng(SEED)
    cases = []
    for scene, idx in ((SyntheticScene(cam), 3), (SyntheticScene(cam, noise_mm=40.0), 7)):
        _, depth, sem, _ = scene.frame(idx, rng)
        metric = metricize_depth(torch.from_numpy(depth.astype(np.int32)).to(dev), cam, params)
        cases.append((f"kitti {idx}", metric, torch.from_numpy(sem.astype(np.int32)).to(dev),
                      cam, params))
    for H, W, border, radius, cls in STENCIL_CASES:
        depth, sem = stencil_frame(H, W, np.random.default_rng(SEED), cls)
        c = CameraIntrinsics(fx=100.0, fy=100.0, cx=W / 2, cy=H / 2, width=W, height=H)
        cases.append((f"{H}x{W} border {border} R {radius} class {cls}",
                      torch.from_numpy(depth).to(dev), torch.from_numpy(sem).to(dev), c,
                      PipelineParams(stereo_border=border, smooth_radius=radius)))
    max_err = 0.0
    for name, metric, semantic, c, p in cases:
        got = preprocess_stencil(metric, semantic, c, p)
        ref = stencil_chain_plain(metric, semantic, c, p)
        torch.cuda.synchronize()
        max_err = max(max_err, float((got - ref).abs().max()))
        if not torch.equal(got, ref):
            raise AssertionError(f"k2 {name}: kernel != plain on {int((got != ref).sum())} "
                                 f"pixels, max {float((got - ref).abs().max())}")
        if not 0.05 < float((ref > 0).float().mean()) < 0.999:
            raise AssertionError(f"k2: degenerate test frame {name}")
    _, metric, semantic, _, _ = cases[1]
    P = cam.height * cam.width
    kernel = lambda: preprocess_stencil(metric, semantic, cam, params)  # noqa: E731
    ops = P * k2_ops_per_pixel(params.smooth_radius)
    bytes_ = 12.0 * P
    bound_ms = max(bytes_ / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    bound_by = "operations" if ops / F32_OPS_PER_S > bytes_ / HBM_BYTES_PER_S else "bytes"
    r = dict(H=cam.height, W=cam.width, cases=len(cases), bit_equal=True, max_abs_err=max_err,
             ms=cuda_ms(kernel, 100), ms_device=cuda_ms(kernel, 100, hold=True),
             ms_device_cold=cuda_ms_cold(kernel, 20),
             plain_ms=cuda_ms(lambda: stencil_chain_plain(metric, semantic, cam, params), 5, 1),
             bound_ms=bound_ms, bound_by=bound_by, f32_ops=ops)
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
    # every column bit for bit: the fusion path divides by device tensors
    # and takes correctly rounded square roots (ROADMAP Queue 3 names the
    # ops that may still differ in the last bit on other inputs)
    a, b = mappers[0].smap, mappers[1].smap
    for k in ("px", "py", "pz", "nx", "ny", "nz", "conf", "init_t", "last_t", "radius",
              "colorsem"):
        if not torch.equal(a.column(k)[:n].cpu(), b.column(k)[:n]):
            raise AssertionError(f"small: column {k} differs on "
                                 f"{int((a.column(k)[:n].cpu() != b.column(k)[:n]).sum())} surfels")
    diffs = last_bit_differences(dev)
    emit("small", frames=5, count=n, stats_equal=True, map_bit_equal=True,
         last_bit_differences=diffs)
    port_ops = ("transforms.acos of 2^20", "compose of 200", "invert_se3 of 200")
    if any(diffs[k] for k in port_ops):
        raise AssertionError(f"small: the port's pose math differs card vs CPU: {diffs}")


def pose_gap(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(largest translation difference in m, largest rotation angle in rad)
    between two pose stacks; the angle from the skew part of Ra^T Rb."""
    a, b = a.cpu().double(), b.cpu().double()
    dR = a[..., :3, :3].transpose(-1, -2) @ b[..., :3, :3]
    skew = torch.stack([dR[..., 2, 1] - dR[..., 1, 2], dR[..., 0, 2] - dR[..., 2, 0],
                        dR[..., 1, 0] - dR[..., 0, 1]], dim=-1) / 2
    return (float((a[..., :3, 3] - b[..., :3, 3]).abs().max()),
            float(torch.asin(torch.clamp(skew.norm(dim=-1), max=1.0)).max()))


def phase_small_icp(dev) -> None:
    """Tracking on a 128x96 camera: the same map (fused on the CPU) and the
    same window on the card and on the CPU."""
    from surfelmapping_tpu_torch import ba, convert, icp
    from surfelmapping_tpu_torch.config import MapConfig, PipelineParams
    from surfelmapping_tpu_torch.io.synthetic import SyntheticScene, tiny_cam
    from surfelmapping_tpu_torch.ops.active import table_from_map
    from surfelmapping_tpu_torch.pipeline import SurfelMapper

    # tests/test_ba.py's scene: fronto-parallel boxes; no stereo border, so
    # the whole 128-px width ingests
    cam, params = tiny_cam(128, 96), PipelineParams(fuse_thresh_factor=0.05, stereo_border=0.0)
    scene = SyntheticScene(cam, step=0.4, car_center=(4.5, 0.8, 13.0), extra_boxes=(
        ((-4.0, 0.6, 11.0), (1.0, 1.0, 1.5)), ((0.5, 0.7, 18.0), (1.2, 0.9, 1.0)),
        ((-2.0, 0.4, 24.0), (1.0, 1.2, 1.0))))
    mapper = SurfelMapper(cam, params, MapConfig(capacity=1 << 16), device="cpu")
    for i in range(5):
        mapper.process_frame(*scene.frame(i))
    smap = mapper.smap

    def depth_on(d, dv, s):
        return icp.preprocess_for_icp(torch.from_numpy(d.astype(np.int32)).to(dv),
                                      torch.from_numpy(s.astype(np.int32)).to(dv), cam, params)

    _, d, s, T = scene.frame(5)
    T0 = torch.from_numpy(T.copy())
    T0[0, 3] += 0.05
    T0[2, 3] -= 0.08
    icp_out = []
    for dv in (dev, "cpu"):
        pose, diag = icp.refine_pose(smap.to(dv), depth_on(d, dv, s), T0.to(dv), cam, params)
        icp_out.append((pose, int(diag["inliers"])))
    win = ba.WindowedBA(cam, params, window=4, stride=2, device="cpu")
    at = table_from_map(smap)
    rng = np.random.default_rng(SEED)
    for i in range(2, 6):
        _, d, s, T = scene.frame(i)
        T = T.copy()
        T[2, 3] += rng.normal(0, 0.03)
        win.push(depth_on(d, "cpu", s), T, at=at, time=float(i))
    arrays, nv = convert.window_to_numpy(win.win)
    ba_out = []
    for dv in (dev, "cpu"):
        got, diag = ba.refine_window(convert.window_from_numpy(arrays, nv, dv),
                                     table_from_map(smap.to(dv)), 5.0, cam, params, stride=2)
        ba_out.append((got.poses, int(diag["inliers"])))
    r = {}
    for name, ((card, n_card), (cpu, n_cpu)) in (("refine_pose", icp_out),
                                                 ("refine_window", ba_out)):
        t_gap, r_gap = pose_gap(card, cpu)
        r[name] = dict(translation_gap_m=t_gap, rotation_gap_rad=r_gap, inliers_card=n_card,
                       inliers_cpu=n_cpu)
        if not (t_gap < 1e-5 and r_gap < 1e-5 and n_cpu > 100
                and abs(n_card - n_cpu) <= 0.001 * n_cpu):
            raise AssertionError(f"small_icp: {name} card vs CPU out of tolerance {r[name]}")
    emit("small_icp", map_surfels=int(smap.count), **r)


def random_poses(n: int, rng) -> torch.Tensor:
    """n random rigid poses (orthonormal rotations, translations in +-20 m)."""
    out = np.zeros((n, 4, 4), np.float32)
    for T in out:
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        q[:, 0] *= np.sign(np.linalg.det(q))
        T[:3, :3], T[:3, 3], T[3, 3] = q, rng.uniform(-20, 20, 3), 1.0
    return torch.from_numpy(out)


def last_bit_differences(dev) -> dict:
    """Card vs CPU on random inputs (seed 0): the pose products and the
    arccos of the port (transforms.compose/invert_se3 as FMA chains,
    transforms.acos in float64), which must agree in every bit, beside the
    torch ops they replaced (ROADMAP Queue 3): elements or products that
    differ."""
    from surfelmapping_tpu_torch.ops import transforms as tf

    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.uniform(-1.0, 1.0, 1 << 20).astype(np.float32))
    A, B = random_poses(200, rng), random_poses(200, rng)

    def per_product(fn, *args):
        card = torch.stack([fn(*(a.to(dev) for a in t)).cpu() for t in zip(*args)])
        cpu = torch.stack([fn(*t) for t in zip(*args)])
        return int((card != cpu).flatten(1).any(1).sum())

    return {"transforms.acos of 2^20": int((tf.acos(x.to(dev)).cpu() != tf.acos(x)).sum()),
            "compose of 200": per_product(tf.compose, A, B),
            "invert_se3 of 200": per_product(tf.invert_se3, A),
            "torch.arccos of 2^20 (replaced)":
                int((torch.arccos(x.to(dev)).cpu() != torch.arccos(x)).sum()),
            "torch.matmul of 200 (replaced)": per_product(torch.matmul, A, B)}


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


def window_fps(mapper, next_frame, n: int = 100) -> tuple[list, dict]:
    """Feed ``n`` frames (``next_frame(i)`` -> process_frame's arguments) to
    ``mapper``, as phase_main does: frames/s by the host clock over frames
    10-30, 40-60 and 80-100 (a sync at each edge); over frames 60-80 the
    profiler's card busy time against that window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    windows, idle, t_start, prof = [], {}, None, None
    for i in range(n):
        if i in (10, 40, 60, 80):
            _ = mapper.count  # sync
            t_start = time.perf_counter()
            if i == 60:
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.__enter__()
        mapper.process_frame(*next_frame(i))
        if i + 1 in (30, 60, 80, 100):
            surfels = mapper.count  # sync: the window's work is done
            dt = time.perf_counter() - t_start
            if i + 1 == 80:
                torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                busy = sum(e.self_device_time_total for e in device_events(prof)) / 1e3
                idle = dict(frames="60-80", wall_ms=dt * 1e3, busy_ms=busy,
                            idle_share=max(0.0, 1.0 - busy / (dt * 1e3)))
            else:
                windows.append(dict(frames=f"{i - 19}-{i + 1}", fps=20 / dt, surfels=surfels))
    return windows, idle


def phase_main(dev, cam, params, kernels, smi: str) -> tuple:
    """bench.py's operating point on the port's entry points: 100 frames
    staged on the card first, then fused (window_fps)."""
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
    host = [scene.frame(i) for i in range(100)]  # kept for the kitti_dir phase
    frames = [mapper.stage_frame(*f) for f in host]
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    t_run = time.perf_counter()
    windows, idle = window_fps(mapper, lambda i: frames[i], len(frames))
    run_s = time.perf_counter() - t_run
    launches = read_counts(kernels)
    emit("main", resolution=f"{cam.width}x{cam.height}", frames=100,
         staging_s=stage_s, run_s=run_s, windows=windows, idle=idle, live_count=mapper.count,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         events=mapper.events, launches=launches, card=smi)
    if (launches["preprocess_stencil"] < 100 or launches["zbuffer_argmin"] < 99
            or launches["associate_merge"] < 99):
        raise AssertionError(f"main: kernels not on the path: {launches}")
    emit("main_map", **map_checks(mapper.smap, scene))
    return mapper, scene, host, frames, launches, dict(windows=windows, idle=idle)


def phase_holds(dev, mapper, frames, zbuf_mod) -> None:
    """The kernels vs their plain versions on the main path's own state: the
    active table of the last frame's pose with the n_valid that the fusion
    step hands K1."""
    from surfelmapping_tpu_torch.ops.active import (
        gather_active, index_candidates, plan_active_blocks, valid_prefix)
    from surfelmapping_tpu_torch.ops.preprocess import (
        metricize_depth, preprocess_frame, stencil_chain_plain)
    from surfelmapping_tpu_torch.ops.transforms import invert_se3

    cam, params = mapper.cam, mapper.params
    rgb, depth, sem, pose = frames[-1]
    smap, B = mapper.smap, mapper.map_config.block_size
    T_inv = invert_se3(pose)
    budget = min(mapper.active_blocks, smap.capacity // B)  # the fusion step's
    blk, n_active = plan_active_blocks(smap, T_inv, cam, params, budget, B)
    if int(n_active) > budget:
        raise AssertionError(f"holds: {int(n_active)} active blocks over the budget {budget}")
    at = gather_active(smap, blk, B)
    n_valid = valid_prefix(n_active, blk.shape[0], B)
    if int(n_valid) != int(at.slot_valid.sum()):
        raise AssertionError("holds: n_valid is not the table's valid prefix")
    zkey, fpix = index_candidates(at, T_inv, float(mapper.tick), cam, params)
    P = cam.height * cam.width
    zb, ib = zbuf_mod.zbuffer_argmin(zkey, fpix, P, n_valid)
    zr, ir = zbuf_mod.zbuffer_argmin_plain(zkey, fpix, P, at.slot_valid)
    if not (torch.equal(zb, zr) and torch.equal(ib, ir)):
        raise AssertionError("holds: k1 differs on the mapper's active table")
    kernel = lambda: zbuf_mod.zbuffer_argmin_packed(zkey, fpix, P, n_valid)  # noqa: E731
    k1_ms, k1_ms_device = cuda_ms(kernel, 50), cuda_ms(kernel, 50, hold=True)
    k1_ms_device_cold = cuda_ms_cold(kernel, 20)
    k1_plain_ms = cuda_ms(lambda: zbuf_mod.zbuffer_argmin_plain(zkey, fpix, P, n_valid), 20)

    got = preprocess_frame(depth, sem, cam, params)
    ref = stencil_chain_plain(metricize_depth(depth, cam, params), sem, cam, params)
    if not torch.equal(got, ref):
        raise AssertionError(f"holds: k2 differs on {int((got != ref).sum())} pixels")
    emit("holds", k1_table_slots=at.size, k1_n_valid=int(n_valid),
         k1_pixels_hit=int((ib != INT32_MAX).sum()), k1_exact=True, k1_ms=k1_ms,
         k1_ms_device=k1_ms_device, k1_ms_device_cold=k1_ms_device_cold,
         k1_plain_ms=k1_plain_ms, k2_bit_equal=True)


def associate_bytes(args) -> float:
    """The association stage's least device bytes on ``args``: each depth
    pixel read once; each checkerboard pixel's colour, class and F x F
    index entries; the 9 table attributes (36 B) of each distinct slot
    read; and the 12 AssocFlat columns written (52 B)."""
    depth, _, _, index, _, _, _, _, cam, params = args
    n = cam.height * cam.width // 2
    windows = torch.stack([active.checkerboard_flat(index[wj::params.index_factor,
                                                          wi::params.index_factor])
                           for wi in range(params.index_factor)
                           for wj in range(params.index_factor)])
    slots = torch.unique(torch.where(windows >= 0, windows, 0)).numel()
    return 4.0 * depth.numel() + n * (12.0 + 4.0 + 8.0 * windows.shape[0] + 52.0) + 36.0 * slots


def phase_associate(dev, mapper, frames) -> dict:
    """The association kernel against its plain version, bit for bit: on
    tools/assoc_cases.py's cases, and on the main path's own state (the
    last frame's depth after remove_movings, the active table after the
    conflict pass, the index image from K1); timed there, beside its
    bytes bound, the plain version and its device launches per call."""
    from surfelmapping_tpu_torch.ops.preprocess import preprocess_frame, remove_movings
    from surfelmapping_tpu_torch.ops.transforms import compose, invert_se3
    from surfelmapping_tpu_torch.tools.assoc_cases import (CASES, association_case,
                                                           differing_columns)

    def held(name, args):
        got = active.associate_active(*args)
        want = active.associate_active_plain(*args)
        bad = differing_columns(got, want)
        if bad:
            raise AssertionError(f"associate {name}: kernel != plain on {bad} entries")
        return want

    for case in CASES:
        held(case, association_case(case, dev))

    cam, params, B = mapper.cam, mapper.params, mapper.map_config.block_size
    (rgb, depth, sem, pose), (_, last_raw, last_sem, last_pose) = frames[-1], frames[-2]
    smap, T_inv = mapper.smap, invert_se3(pose)
    last_depth = preprocess_frame(last_raw, last_sem, cam, params)
    depth_m = remove_movings(preprocess_frame(depth, sem, cam, params), sem, last_depth,
                             compose(invert_se3(last_pose), pose), cam, params)
    budget = min(mapper.active_blocks, smap.capacity // B)
    blk, n_active = active.plan_active_blocks(smap, T_inv, cam, params, budget, B)
    at, _ = active.conflict_active(active.gather_active(smap, blk, B), depth_m, sem, T_inv, cam,
                                   params, params.near_clip, params.far_clip,
                                   params.fuse_thresh_factor, False)
    index = active.index_active(at, T_inv, float(mapper.tick), cam, params,
                                active.valid_prefix(n_active, blk.shape[0], B))
    args = (depth_m, rgb, sem, index, at, pose, T_inv, float(mapper.tick), cam, params)
    want = held("main path", args)
    kernel = lambda: active.associate_active(*args)  # noqa: E731
    plain = lambda: active.associate_active_plain(*args)  # noqa: E731
    launches = device_profile(kernel)[0]
    if launches != 1:
        raise AssertionError(f"associate: {launches} device launches per call, not 1")
    # the plain version's ~470 launches outlast a hold: its card time is the profiler's
    plain_launches, plain_ms_device = device_profile(plain, calls=4)
    bytes_ = associate_bytes(args)
    r = dict(H=cam.height, W=cam.width, cases=len(CASES) + 1, bit_equal=True,
             table_slots=at.size, merged=int((want.mark >= 0).sum()),
             new=int((want.mark == -1).sum()), device_launches_per_call=launches,
             ms=cuda_ms(kernel, 100), ms_device=cuda_ms(kernel, 100, hold=True),
             ms_device_cold=cuda_ms_cold(kernel, 20),
             plain_ms=cuda_ms(plain, 20), plain_ms_device=plain_ms_device,
             plain_device_launches_per_call=plain_launches,
             bytes=bytes_, bound_ms=bytes_ / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    emit("associate", **r)
    return r


def phase_outres(dev, outres_mod) -> dict:
    """P1 and P2 against their plain version, exact: at the TPU probes'
    shapes with a min-id tie planted; then, through the entry points at both
    shapes, candidates in block order (pixels ascending), all in one tile
    (the worst skew: one resolve block takes all 2^20) and signed keys with
    INT32_MIN; through zbuffer_outres, a candidate count that is not a
    multiple of a bin span, none, and all keys INT32_MAX.  Each case timed
    warm and cold beside the library call, with the kernel's device
    launches per call."""
    from surfelmapping_tpu_torch.tools.timing import (
        bound_ms, ordered_candidates, packed_scatter_min)

    A = 1 << 20
    rng = np.random.default_rng(SEED)
    cases = []
    for name, P in (("outres", 453_620), ("outres", 4 * 453_620), ("pallas_zbuf", 453_632)):
        zkey = rng.integers(100, 1 << 30, A).astype(np.int32)
        fpix = rng.integers(0, P, A).astype(np.int32)
        fpix[fpix == 4242] = 4243
        zkey[[5, 17, 123_456]] = 77
        fpix[[5, 17, 123_456]] = 4242
        cases.append((f"{name}_{P}", name, P, True,
                      torch.from_numpy(zkey).to(dev), torch.from_numpy(fpix).to(dev)))
    for order in ("block", "one_tile", "signed"):
        for name, P in (("pallas_zbuf", 453_632), ("outres", 4 * 453_620)):
            zk, fp = ordered_candidates(np.random.default_rng(SEED), P, A, order, dev)
            cases.append((f"{name}_{P}_{order}", name, P, False, zk, fp))
    zk, fp = ordered_candidates(np.random.default_rng(SEED), 453_632, A, "random", dev)
    ragged = A - 8192 + 1003  # neither a multiple of the bin span nor of 4
    cases += [("ragged_a", "direct", 453_632, False, zk[:ragged], fp[:ragged]),
              ("a_zero", "direct", 453_632, False, zk[:0], fp[:0]),
              ("all_invalid", "direct", 453_632, False, torch.full_like(zk, INT32_MAX), fp)]

    res = {}
    for label, name, P, tie, zk, fp in cases:
        if name == "outres":
            n_pix, entry = outres_mod.outres_pixels(P), outres_mod.P2
            zb, ib = outres_mod.outres(zk, fp, P)
        elif name == "pallas_zbuf":
            n_pix, entry = P, outres_mod.P1
            zb, ib = (t.reshape(-1) for t in outres_mod.pallas_zbuf(zk, fp, P))
        else:
            n_pix, entry = P, outres_mod.P2
            out = outres_mod.zbuffer_outres(zk, fp, n_pix, entry)
            zb, ib = out[:, 1], out[:, 0]
        ref = outres_mod.zbuffer_outres_plain(zk, fp, n_pix)
        zr, ir = ref[:zb.shape[0], 1], ref[:zb.shape[0], 0]
        torch.cuda.synchronize()
        if not (torch.equal(zb, zr) and torch.equal(ib, ir)):
            raise AssertionError(f"outres: {label}: kernel != plain on "
                                 f"{int((zb != zr).sum())} keys, {int((ib != ir).sum())} ids")
        if tie and (int(zb[4242]), int(ib[4242])) != (77, 5):
            raise AssertionError(f"outres: {label}: tie pixel gave "
                                 f"({int(zb[4242])}, {int(ib[4242])})")
        if label in ("a_zero", "all_invalid") and not bool((ref == INT32_MAX).all()):
            raise AssertionError(f"outres: {label}: a pixel was written")
        P_lib = min(P, n_pix)
        library, (lz, li) = packed_scatter_min(zk, fp, P_lib)
        if not (torch.equal(lz, zr[:P_lib]) and torch.equal(li, ir[:P_lib])):
            raise AssertionError(f"outres: {label}: library yardstick disagrees")
        max_err = max(int((zb.long() - zr.long()).abs().max()),
                      int((ib.long() - ir.long()).abs().max()))
        kernel = lambda: outres_mod.zbuffer_outres(zk, fp, n_pix, entry)  # noqa: E731
        plan = outres_mod.outres_plan(zk.shape[0], n_pix)
        r = dict(P=P, A=zk.shape[0], buffer_pixels=n_pix, tile=plan.tile, tiles=plan.tiles,
                 bin_blocks=plan.bin_blocks, exact=True, max_abs_err=max_err,
                 empty_pixels=int((ib == INT32_MAX).sum()),
                 plain_ms=cuda_ms(lambda: outres_mod.zbuffer_outres_plain(zk, fp, n_pix), 5),
                 bound_ms=bound_ms(zk.shape[0], n_pix), ms=cuda_ms(kernel, 50),
                 ms_device=cuda_ms(kernel, 50, hold=True), ms_device_cold=cuda_ms_cold(kernel, 20),
                 device_launches_per_call=device_profile(kernel)[0],
                 library_ms=cuda_ms(library, 20), library_ms_device=cuda_ms(library, 50, hold=True),
                 library_ms_device_cold=cuda_ms_cold(library, 20))
        if r["device_launches_per_call"] != (2 if zk.shape[0] else 1):
            raise AssertionError(f"outres: {label}: {r['device_launches_per_call']} device "
                                 "launches per call")
        res[label] = r
    emit("outres", **res)
    return res


def outres_row(name: str, replaces: str, probe: dict, P: int, launches: int,
               source: str) -> dict:
    """The kernels line's row of a probe entry point: its random case at
    the probe's shape, with the device times of the block-order and
    one-tile cases beside; max_abs_err over every outres case."""
    r = probe[f"{name}_{P}"]
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "ms_device", "ms_device_cold",
            "library_ms_device", "library_ms_device_cold", "device_launches_per_call")
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=max(c["max_abs_err"] for c in probe.values()), bound_by="bytes",
                **{k: r[k] for k in keys},
                **{f"ms_device_{order}": probe[f"{name}_{P}_{order}"]["ms_device"]
                   for order in ("block", "one_tile")})


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
    if min(launches[k] for k in ("zbuffer_argmin", "disc_dilate", "visible_blocks")) < len(views):
        raise AssertionError(f"render: K1, the dilation and the cull launched "
                             f"{launches['zbuffer_argmin']}, {launches['disc_dilate']} and "
                             f"{launches['visible_blocks']} times for {len(views)} views")
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


def view_candidates(dev, mapper, view, n_active: int) -> tuple:
    """What render_view hands K1 for ``view`` of the mapper's map: (culled
    map, keys, class-buffer pixels, classes, n_valid, n_active blocks)."""
    from surfelmapping_tpu_torch.ops.active import valid_prefix
    from surfelmapping_tpu_torch.ops.splat import cull_for_render, fast_candidates

    cam, smap = mapper.cam, mapper.smap
    G = smap.capacity // 2048
    budget = 1
    while budget < n_active:  # render_view's budget for this view
        budget *= 2
    budget = G if budget >= G // 2 else budget
    vt = torch.as_tensor(view, device=dev)
    culled, _, n_act = cull_for_render(smap, vt, cam, budget, 2048, margin=7)
    key, cflat, classes, _ = fast_candidates(culled, vt, cam)
    return culled, key, cflat, classes, valid_prefix(n_act, budget, 2048), n_act


def phase_render_holds(dev, mapper, scene, view, n_active: int, zbuf_mod) -> None:
    """On one rendered view: K1 vs its plain version on the view's own
    candidates, the fast renderer vs the exact one, and a render at a
    mapping pose vs that input frame."""
    from surfelmapping_tpu_torch.metrics import psnr, render_vs_frame_psnr
    from surfelmapping_tpu_torch.ops.splat import render_view

    cam = mapper.cam
    smap = mapper.smap
    culled, key, cflat, classes, nv, n_act = view_candidates(dev, mapper, view, n_active)
    slot_valid = torch.arange(culled.capacity, device=dev) < int(n_act) * 2048
    P = len(classes) * cam.height * cam.width
    zb, ib = zbuf_mod.zbuffer_argmin(key, cflat, P, nv)
    zr, ir = zbuf_mod.zbuffer_argmin_plain(key, cflat, P, slot_valid)
    if not (torch.equal(zb, zr) and torch.equal(ib, ir)):
        raise AssertionError("render_holds: k1 differs on the view's candidates")
    kernel = lambda: zbuf_mod.zbuffer_argmin_packed(key, cflat, P, nv)  # noqa: E731
    k1_ms, k1_ms_device = cuda_ms(kernel, 50), cuda_ms(kernel, 50, hold=True)
    k1_ms_device_cold = cuda_ms_cold(kernel, 20)
    k1_plain_ms = cuda_ms(lambda: zbuf_mod.zbuffer_argmin_plain(key, cflat, P, nv), 20)

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
    r = dict(k1_table_slots=culled.capacity, k1_n_valid=int(nv),
             k1_pixels_hit=int((ib != INT32_MAX).sum()), k1_exact=True, k1_ms=k1_ms,
             k1_ms_device=k1_ms_device, k1_ms_device_cold=k1_ms_device_cold,
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


def phase_dilate(dev, mapper, view, n_active: int) -> dict:
    """The dilation kernel against the plain loop, bit for bit, at the
    renderer's shape: on tools/dilate_cases.py's cases and on ``view``'s own
    K1 class buffers; timed there, beside its bytes bound (each class
    buffer read once, the merged plane written once), the plain loop and
    the device launches of each per call."""
    from surfelmapping_tpu_torch.ops import splat
    from surfelmapping_tpu_torch.ops.disc_dilate import disc_dilate
    from surfelmapping_tpu_torch.ops.zbuf import zbuffer_argmin_packed
    from surfelmapping_tpu_torch.tools.dilate_cases import CASES, dilate_case

    cam = mapper.cam
    H, W = cam.height, cam.width

    def held(name, packed, classes):
        got = disc_dilate(packed, classes)
        want = splat.dilate_plain(packed, classes)
        if not torch.equal(got, want):
            raise AssertionError(f"dilate {name}: kernel != plain on "
                                 f"{int((got != want).sum())} pixels")

    for case in CASES:
        held(case, dilate_case(case, 4, H, W, seed=SEED, device=dev), (1, 2, 3, 5))
    _, key, cflat, classes, nv, _ = view_candidates(dev, mapper, view, n_active)
    packed = zbuffer_argmin_packed(key, cflat, len(classes) * H * W, nv).view(len(classes), H, W)
    held("view", packed, classes)
    kernel = lambda: disc_dilate(packed, classes)  # noqa: E731
    plain = lambda: splat.dilate_plain(packed, classes)  # noqa: E731
    launches = device_profile(kernel)[0]
    if launches != 1:
        raise AssertionError(f"dilate: {launches} device launches per call, not 1")
    plain_launches, plain_ms_device = device_profile(plain, calls=4)
    bytes_ = 8.0 * (len(classes) + 1) * H * W
    r = dict(H=H, W=W, classes=list(classes), cases=len(CASES) + 1, bit_equal=True,
             centres=int((packed != splat.EMPTY_WORD).sum()),
             device_launches_per_call=launches,
             ms=cuda_ms(kernel, 100), ms_device=cuda_ms(kernel, 100, hold=True),
             ms_device_cold=cuda_ms_cold(kernel, 20),
             plain_ms=cuda_ms(plain, 20), plain_ms_device=plain_ms_device,
             plain_device_launches_per_call=plain_launches,
             bytes=bytes_, bound_ms=bytes_ / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    emit("dilate", **r)
    return r


def phase_cull(dev, mapper, views) -> dict:
    """The cull's visibility kernel against its plain form, bit for bit: on
    tools/cull_cases.py's cases, and at the render cell's shape (2^26
    slots, G = 32,768 blocks of 2048: the main map's columns padded with
    dead slots) from each of ``views``, as render_view culls them; timed
    there on the first view beside its bytes bound (px, py, pz and conf
    read once, one byte written per block), the plain form and the device
    launches of each per call."""
    import torch.nn.functional as F

    from surfelmapping_tpu_torch.ops.transforms import invert_se3
    from surfelmapping_tpu_torch.ops.visible_blocks import visible_blocks, visible_blocks_plain
    from surfelmapping_tpu_torch.tools.cull_cases import CASES, MARGIN, MAX_DEPTH, cull_case

    N, B, margin = 1 << 26, 2048, 7  # render_view's margin: footprint 5 + 2
    cam, smap = mapper.cam, mapper.smap
    if smap.capacity > N:
        raise AssertionError(f"cull: the main map's {smap.capacity} slots exceed {N}")
    cols = [F.pad(smap.column(k), (0, N - smap.capacity)) for k in ("px", "py", "pz", "conf")]
    mismatches, calls = 0, 0
    for case in CASES:
        for bs in (32, 256, 2048):
            c = cull_case(case, 1 << 20, bs, seed=SEED, device=dev)
            T_inv = invert_se3(c.view)
            got = visible_blocks(*c.columns(), T_inv, c.cam, bs, MAX_DEPTH, MARGIN)
            want = visible_blocks_plain(*c.columns(), T_inv, c.cam, bs, MAX_DEPTH, MARGIN)
            mismatches += int((got != want).sum())
            calls += 1
    visible = []
    for v in views:
        T_inv = invert_se3(torch.as_tensor(v, dtype=torch.float32, device=dev))
        got = visible_blocks(*cols, T_inv, cam, B, 200.0, margin)
        want = visible_blocks_plain(*cols, T_inv, cam, B, 200.0, margin)
        mismatches += int((got != want).sum())
        visible.append(int(want.sum()))
    if mismatches:
        raise AssertionError(f"cull: kernel != plain on {mismatches} blocks")
    T_inv = invert_se3(torch.as_tensor(views[0], dtype=torch.float32, device=dev))
    kernel = lambda: visible_blocks(*cols, T_inv, cam, B, 200.0, margin)  # noqa: E731
    plain = lambda: visible_blocks_plain(*cols, T_inv, cam, B, 200.0, margin)  # noqa: E731
    launches = device_profile(kernel)[0]
    if launches != 1:
        raise AssertionError(f"cull: {launches} device launches per call, not 1")
    plain_launches, plain_ms_device = device_profile(plain, calls=4)
    bytes_ = 16.0 * N + N // B
    ms_device = cuda_ms(kernel, 50, hold=True)
    bound_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    r = dict(slots=N, blocks=N // B, live=mapper.count, cases=calls, views=len(views),
             mismatches=mismatches, visible_blocks=visible, device_launches_per_call=launches,
             ms=cuda_ms(kernel, 50), ms_device=ms_device, ms_device_cold=cuda_ms_cold(kernel, 20),
             plain_ms=cuda_ms(plain, 10), plain_ms_device=plain_ms_device,
             plain_device_launches_per_call=plain_launches, bytes=bytes_, bound_ms=bound_ms,
             bound_by="bytes", bound_share=bound_ms / ms_device)
    emit("cull", **r)
    return r


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


def phase_icp_ba(dev, counters, smi: str) -> tuple:
    """The tracking path through build_map's Tracker, as the JAX package's
    KITTI-resolution ICP/BA experiment ran it (tools/record_parity.py): 40
    frames of its box-corridor scene, fuse_thresh_factor 0.05, capacity
    1 << 21, a 0.02 m/frame random walk on the input poses (seed 0); ICP
    alone, then ICP + BA (window 5, odometry weight 1e4).  The frames are
    ray-cast on the host before the clock starts."""
    from surfelmapping_tpu_torch.build_map import RandomWalkNoise, Tracker
    from surfelmapping_tpu_torch.config import MapConfig, PipelineParams
    from surfelmapping_tpu_torch.io.synthetic import corridor_scene, kitti_cam
    from surfelmapping_tpu_torch.metrics import absolute_trajectory_error
    from surfelmapping_tpu_torch.pipeline import SurfelMapper

    cam, params = kitti_cam(), PipelineParams(fuse_thresh_factor=0.05)
    scene = corridor_scene(cam)
    frames = [scene.frame(i) for i in range(40)]
    noise = RandomWalkNoise(0.02)
    noisy = [noise(f[3]) for f in frames]
    gt = np.stack([f[3] for f in frames])
    res = {"resolution": f"{cam.width}x{cam.height}", "frames": len(frames),
           "input_ate": absolute_trajectory_error(np.stack(noisy), gt)}
    launches, last = {}, None
    for name, window in (("icp", 0), ("icp_ba", 5)):
        mapper = SurfelMapper(cam, params, MapConfig(capacity=1 << 21))
        tracker = Tracker(mapper, icp=True, ba_window=window, ba_odo_weight=1e4)
        torch.cuda.synchronize()
        reset_counts(counters)
        t0 = time.perf_counter()
        poses = [tracker.step(i, rgb, depth, sem, noisy[i])
                 for i, (rgb, depth, sem, _) in enumerate(frames)]
        _ = mapper.count  # sync: the last frame's fusion is done
        dt = time.perf_counter() - t0
        counts = read_counts(counters)
        tracked = len(tracker.inliers)
        k1 = counts["zbuffer_argmin"]
        r = dict(ate=absolute_trajectory_error(np.stack(poses), gt), frames_per_s=len(frames) / dt,
                 seconds=dt, tracked_frames=tracked, k1_launches=k1,
                 k1_launches_per_tracked_frame=k1 / max(tracked, 1), launches=counts,
                 live_surfels=mapper.count)
        for key in ("icp", "ba"):
            seen = [x[key] for x in tracker.inliers if key in x]
            if seen:
                r[f"mean_{key}_inliers"] = float(np.mean(seen))
        res[name] = r
        launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
        last = (mapper, noisy[-1])
    res["card"] = smi
    emit("icp_ba", **res)
    limit = 0.5 * res["input_ate"]["rmse"]
    for name in ("icp", "icp_ba"):
        r = res[name]
        if not (np.isfinite(r["ate"]["rmse"]) and r["ate"]["rmse"] <= limit):
            raise AssertionError(f"icp_ba: {name} ATE rmse {r['ate']['rmse']} over {limit}")
        if r["k1_launches"] < 5 * r["tracked_frames"] or r["tracked_frames"] < 30:
            raise AssertionError(f"icp_ba: {name}: K1 launched {r['k1_launches']} times for "
                                 f"{r['tracked_frames']} tracked frames")
    return launches, last


def phase_icp_holds(dev, mapper, pose, zbuf_mod) -> None:
    """K1 vs its plain version on the candidates of the first ICP iteration
    of the icp_ba run's last frame: the table gathered at that frame's
    input pose, with the time and n_valid that refine_pose takes."""
    from surfelmapping_tpu_torch.ops.active import index_candidates
    from surfelmapping_tpu_torch.ops.transforms import invert_se3

    cam, params = mapper.cam, mapper.params
    pose = torch.from_numpy(pose).to(dev)
    at = mapper.active_table(pose)
    n_valid = at.slot_valid.sum(dtype=torch.int32)
    t = torch.max(torch.where(at.slot_valid, at.last_t, 0.0))
    zkey, fpix = index_candidates(at, invert_se3(pose), t, cam, params)
    P = cam.height * cam.width
    zb, ib = zbuf_mod.zbuffer_argmin(zkey, fpix, P, n_valid)
    zr, ir = zbuf_mod.zbuffer_argmin_plain(zkey, fpix, P, at.slot_valid)
    if not (torch.equal(zb, zr) and torch.equal(ib, ir)):
        raise AssertionError("icp_holds: k1 differs on the ICP iteration's candidates")
    kernel = lambda: zbuf_mod.zbuffer_argmin_packed(zkey, fpix, P, n_valid)  # noqa: E731
    # the library call of phase_k1 on the candidates K1 scatters here
    nv = int(n_valid)
    ids = torch.arange(zkey.shape[0], device=dev)
    sel = (ids < nv) & (zkey != INT32_MAX) & (fpix >= 0) & (fpix < P)
    pix, vals = fpix[sel].long(), ((zkey.long() << 32) | ids)[sel]
    empty = torch.full((P,), (INT32_MAX << 32) | INT32_MAX, dtype=torch.int64, device=dev)
    library = lambda: empty.scatter_reduce(0, pix, vals, "amin")  # noqa: E731
    if not torch.equal(library(), kernel()):
        raise AssertionError("icp_holds: library yardstick disagrees")
    emit("icp_holds", k1_table_slots=at.size, k1_n_valid=nv,
         k1_pixels_hit=int((ib != INT32_MAX).sum()), k1_scattered=int(sel.sum()), k1_exact=True,
         k1_ms=cuda_ms(kernel, 50), k1_ms_device=cuda_ms(kernel, 50, hold=True),
         k1_plain_ms=cuda_ms(lambda: zbuf_mod.zbuffer_argmin_plain(zkey, fpix, P, n_valid), 20),
         k1_bound_ms=(8.0 * nv + 8.0 * P) / HBM_BYTES_PER_S * 1e3, k1_bound_by="bytes",
         k1_library_ms=cuda_ms(library, 50), k1_library_ms_device=cuda_ms(library, 50, hold=True))


def random_bn_stats(tree: dict, rng) -> None:
    """Every BatchNorm_0 of a flax ``batch_stats`` tree to mean ~ N(0, 0.1)
    and var ~ U(0.5, 2), in place."""
    for k, v in tree.items():
        if k == "BatchNorm_0":
            v["mean"] = rng.normal(0, 0.1, v["mean"].shape).astype(np.float32)
            v["var"] = rng.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)
        elif isinstance(v, dict):
            random_bn_stats(v, rng)


def phase_small_spade(dev) -> None:
    """The generator at ngf 16, crop 64, batch 2 on the card and on the CPU
    from the same converted weights (random running statistics, the init's
    u): aspect 1.0 and 3.25 from labels off the generator's grid, and the
    VAE path (encoder + fc_vae) with a style image and from z = 0.  The
    image before its tanh must agree within 1e-4 of its largest magnitude,
    so that a saturated tanh hides nothing.  Then the nearest resize card
    vs CPU at every ratio the generator takes, here and at the spade
    phase's geometries."""
    from surfelmapping_tpu_torch.models.pix2pix import SpadeConfig, SpadeTrainer, init_variables
    from surfelmapping_tpu_torch.models.spade import latent_hw, resize_nearest

    rng = np.random.default_rng(SEED)
    res = {}
    for name, cfg, (H, W) in (
            ("aspect_1.0", SpadeConfig(ngf=16, crop_size=64), (70, 70)),
            ("aspect_3.25", SpadeConfig(ngf=16, crop_size=64, aspect_ratio=3.25), (40, 130)),
            ("vae", SpadeConfig(ngf=16, ndf=16, crop_size=64, use_vae=True), (70, 70))):
        v = init_variables(cfg, SEED)
        random_bn_stats(v["batch_stats"], rng)
        models = [SpadeTrainer(cfg, variables=v, device=d) for d in (dev, "cpu")]
        label = torch.from_numpy(rng.uniform(-1, 1, (2, H, W, 3)).astype(np.float32))
        style = torch.from_numpy(rng.uniform(-1, 1, (2, 90, 120, 3)).astype(np.float32))
        cases = (("vae_style", style), ("vae_prior", None)) if cfg.use_vae else ((name, None),)
        for case, real in cases:
            card, cpu = (m.infer_logits(label, real).cpu() for m in models)
            err, scale = float((card - cpu).abs().max()), float(cpu.abs().max())
            r = dict(label=[H, W], output=list(cpu.shape[1:3]), max_abs_err=err,
                     max_abs_cpu=scale, rel_err=err / scale,
                     unsaturated_share=float((torch.tanh(cpu).abs() < 0.99).float().mean()))
            res[case] = r
            if not (bool(torch.isfinite(card).all()) and err <= 1e-4 * scale):
                raise AssertionError(f"small_spade: {case} card vs CPU out of tolerance {r}")
    pairs = set()
    for hw, crop, aspect in (((70, 70), 64, 1.0), ((40, 130), 64, 3.25),
                             ((370, 1226), 1248, 3.25), ((370, 1226), 256, 1.0)):
        sh, sw = latent_hw(crop, aspect)
        for k in range(6):  # the label to each block's grid, and the 2x upsamples
            pairs.add((hw, (sh << k, sw << k)))
            if k:
                pairs.add(((sh << (k - 1), sw << (k - 1)), (sh << k, sw << k)))
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 400, 1300)).astype(np.float32))
    for (H, W), (h, w) in sorted(pairs):
        src = x[..., :H, :W].contiguous()
        if not torch.equal(resize_nearest(src.to(dev), h, w).cpu(), resize_nearest(src, h, w)):
            raise AssertionError(f"small_spade: nearest resize {H}x{W} -> {h}x{w} differs")
    emit("small_spade", **res, nearest_ratios_equal=len(pairs))


def layer_flops(module: torch.nn.Module, forward) -> int:
    """Floating-point operations (2 per multiply-add) of ``module``'s
    convolutions and dense layers in ``forward()``, counted from the layer
    shapes (run it on the meta device)."""
    macs = 0

    def count(mod, _, out):
        nonlocal macs
        if isinstance(mod, torch.nn.Conv2d):
            macs += out.numel() * mod.in_channels // mod.groups * math.prod(mod.kernel_size)
        else:
            macs += out.numel() * mod.in_features

    hooks = [m.register_forward_hook(count) for m in module.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    forward()
    for h in hooks:
        h.remove()
    return 2 * macs


def generator_flops(cfg, H: int, W: int) -> int:
    """The generator's FLOPs on one H x W label."""
    from surfelmapping_tpu_torch.models.spade import build_modules

    gen, _ = build_modules(cfg, "meta")
    return layer_flops(gen, lambda: gen.logits(torch.empty(1, 3, H, W, device="meta")))


def train_step_flops(cfg, batch: int) -> dict:
    """Float32 FLOPs of one D step and one G step at ``cfg.crop_size``,
    from the layer shapes: a forward that takes no gradient counts once; a
    backward costs a forward for the gradient of the layer's input and one
    for its weights.  D step: G forward + D forward and both backwards on
    the 2B fake+real batch.  G step: G (and encoder) forward and both
    backwards, D forward and its input gradient on the 2B batch, VGG19's
    forward and input gradient on the fake, its forward on the real."""
    from surfelmapping_tpu_torch.models.losses import VGG19Features
    from surfelmapping_tpu_torch.models.pix2pix import discriminator
    from surfelmapping_tpu_torch.models.spade import build_modules

    B, S = batch, cfg.crop_size
    img = lambda n, c=3: torch.empty(n, c, S, S, device="meta")  # noqa: E731
    gen, enc = build_modules(cfg, "meta")
    z = torch.empty(B, cfg.z_dim, device="meta") if enc is not None else None
    g = layer_flops(gen, lambda: gen.logits(img(B), z))
    e = layer_flops(enc, lambda: enc(img(B))) if enc is not None else 0
    d_mod = discriminator(cfg, "meta")
    d = layer_flops(d_mod, lambda: d_mod(img(2 * B, 6)))
    vgg = VGG19Features("meta")
    v = layer_flops(vgg, lambda: vgg(img(B))) if cfg.use_vgg else 0
    return {"d_step": g + e + 3 * d, "g_step": 3 * (g + e) + 2 * d + 3 * v,
            "generator": g, "encoder": e, "discriminator": d, "vgg19": v}


class RecordingModel:
    """A SpadeTrainer for enhance_frame that keeps the generator's last
    output for the checks."""

    def __init__(self, model):
        self.model, self.device, self.last = model, model.device, None

    def infer(self, label, real=None):
        self.last = self.model.infer(label, real)
        return self.last


def spade_checks(fake: torch.Tensor, label: np.ndarray, sem: np.ndarray,
                 final: np.ndarray) -> dict:
    """An enhanced frame is right: the generator's output finite and in
    [-1, 1]; the composite keeps every rendered pixel where the semantic is
    not 0, bit for bit, and takes the GAN pixel wherever it is 0."""
    from surfelmapping_tpu_torch.spade_test import fake_to_u8

    finite = bool(torch.isfinite(fake).all())
    peak = float(fake.abs().max())
    hole = sem == 0
    gan = fake_to_u8(fake, *label.shape[:2])
    kept = bool(np.array_equal(final[~hole], label[~hole]))
    filled = bool(np.array_equal(final[hole], gan[hole]))
    if not (finite and peak <= 1.0 and kept and filled and final.shape == label.shape):
        raise AssertionError(f"spade: bad frame (finite {finite}, max |x| {peak}, rendered "
                             f"pixels kept {kept}, holes from the GAN {filled})")
    return dict(hole_share=float(hole.mean()),
                unsaturated_share=float((fake.abs() < 0.99).float().mean()))


def phase_spade(dev, mapper, views, counters, smi: str) -> dict:
    """The LADS serving chain at full width on the render phase's 20 views:
    render_view (K1) -> the u8 label (views.render_u8, as acquire_images
    makes it) -> spade_test.enhance_frame (what the CLI runs per frame) ->
    composite with the render's semantic.  ngf 64 with seeded weights and
    running statistics 0/1, at the KITTI inference geometry (crop 1248,
    aspect 3.25) and at the CLI default (crop 256).  The generator's card
    time is the profiler's kernel time per image; the card's idle share is
    its kernel time over 4 frames of the chain, read under the profiler,
    against the same 4 frames' wall time without it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from surfelmapping_tpu_torch.models.pix2pix import SpadeConfig, SpadeTrainer, init_variables
    from surfelmapping_tpu_torch.ops.splat import render_view
    from surfelmapping_tpu_torch.spade_test import enhance_frame, unit_batch
    from surfelmapping_tpu_torch.views import render_u8

    cam, smap = mapper.cam, mapper.smap
    t0 = time.perf_counter()
    variables = init_variables(SpadeConfig(ngf=64), SEED)  # the crop changes no weight
    init_s = time.perf_counter() - t0
    res, k1 = {"card": smi, "init_s": init_s}, 0
    for name, cfg in (("kitti_384x1248", SpadeConfig(ngf=64, crop_size=1248, aspect_ratio=3.25)),
                      ("cli_256x256", SpadeConfig(ngf=64, crop_size=256))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = RecordingModel(SpadeTrainer(cfg, variables))  # the card by default
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0

        def chain(view, hint):
            with record_function("chain.render"):
                out = render_view(smap, view, cam, start_blocks=hint)
            with record_function("chain.label_to_host"):
                label, sem = (t.cpu().numpy() for t in render_u8(out))
            return enhance_frame(model, label, sem), label, sem, int(out["n_active_blocks"]) + 1

        def frames_ms(hint, n=4):  # wall ms per frame of views[:n], from the same hint
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for v in views[:n]:
                hint = chain(v, hint)[3]
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        reset_counts(counters)
        hint, per_view = None, []
        for v in views:
            t0 = time.perf_counter()
            final, label, sem, hint = chain(v, hint)
            ms = (time.perf_counter() - t0) * 1e3
            per_view.append(dict(ms=ms, **spade_checks(model.last[0], label, sem, final)))
        launches = read_counts(counters)
        k1 += launches["zbuffer_argmin"]
        if launches["zbuffer_argmin"] < len(views):
            raise AssertionError(f"spade: K1 launched {launches['zbuffer_argmin']} times for "
                                 f"{len(views)} views")
        median_ms = statistics.median(p["ms"] for p in per_view[2:])  # after 2 warm-up views
        peak = torch.cuda.max_memory_allocated()

        lab = unit_batch(label, dev)  # the last view's label, as enhance_frame hands it over
        gen = lambda: model.model.infer(lab)  # noqa: E731
        gen_launches, gen_ms_device = device_profile(gen, calls=3)
        flops = generator_flops(cfg, *label.shape[:2])
        bound_ms = flops / F32_OPS_PER_S * 1e3
        wall_ms = frames_ms(hint)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall_ms_profiled = frames_ms(hint)
        kernels = sorted(((e.key, e.self_device_time_total / 1e3 / 4, e.count / 4)
                          for e in device_events(prof)), key=lambda k: -k[1])
        busy_ms = sum(k[1] for k in kernels)
        host_ms = {e.key: e.cpu_time_total / 1e3 / 4 for e in prof.key_averages()
                   if e.key.startswith("chain.")
                   and e.device_type == torch.autograd.DeviceType.CPU}
        res[name] = dict(
            output=list(model.last.shape[1:3]), label=list(label.shape[:2]), views=len(views),
            frames_per_s=1e3 / median_ms, median_frame_ms=median_ms, load_s=load_s,
            generator_ms_device=gen_ms_device, generator_ms=cuda_ms(gen, 10),
            generator_flops=flops, f32_bound_ms=bound_ms,
            share_of_f32_bound=bound_ms / gen_ms_device,
            launches_per_image=gen_launches, launches=launches,
            device_busy_ms_per_frame=busy_ms, wall_ms_per_frame=wall_ms,
            device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
            wall_ms_per_frame_profiled=wall_ms_profiled,
            device_idle_share_profiled=max(0.0, 1.0 - busy_ms / wall_ms_profiled),
            max_memory_allocated=peak, above_start=peak - base,
            unsaturated_share=statistics.mean(p["unsaturated_share"] for p in per_view),
            cudnn_benchmark=torch.backends.cudnn.benchmark,
            cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
            top_kernels=[dict(name=k[:100], device_ms_per_frame=t, launches_per_frame=c)
                         for k, t, c in kernels[:8]],
            host_ms_per_frame_profiled=host_ms, per_view=per_view)
        del model
    emit("spade", **res)
    return {"zbuffer_argmin": k1}


def spread(ms: list) -> dict:
    """Percentiles of a list of times."""
    q = statistics.quantiles(ms, n=10)
    return dict(min=min(ms), p10=q[0], median=statistics.median(ms), p90=q[-1], max=max(ms),
                stdev=statistics.stdev(ms))


def host_cpu() -> dict:
    """The host's CPU, the cores this process may run on and the load
    average, for host-clock numbers read across machines: /proc/cpuinfo's
    first processor (model name or vendor, family, model, clock), lscpu's
    model name where lscpu exists, and the widest vector ISA PyTorch's CPU
    kernels use."""
    keys = ("model name", "vendor_id", "cpu family", "model", "stepping", "cpu MHz")
    info = {}
    try:
        for ln in Path("/proc/cpuinfo").read_text().split("\n\n")[0].splitlines():
            k, _, v = ln.partition(":")
            if k.strip() in keys:
                info[k.strip()] = v.strip()
    except OSError:
        pass
    model = None
    try:
        lscpu = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=10).stdout
        model = next((ln.split(":", 1)[1].strip() for ln in lscpu.splitlines()
                      if ln.startswith("Model name")), None)
    except (OSError, subprocess.SubprocessError):
        pass
    return dict(cpuinfo=info, lscpu_model=model, isa=torch.backends.cpu.get_cpu_capability(),
                cores=len(os.sched_getaffinity(0)), loadavg=os.getloadavg())


def phase_small_spade_train(dev) -> None:
    """One D step and one G step of the GAN, each from the same converted
    variables (seeded init, random BN running statistics) and the same
    batch, on the card and on the CPU: ngf 16, ndf 16, crop 64, batch 2,
    num_d 2, n_layers_d 4, VGG19 on (random init); without and with the
    VAE (fixed noise).  Held, in float32 (the path that ships): the losses
    within 1e-4 relative; the SN u and sigma and the BN running statistics
    the step stored within 1e-5 of each array's largest magnitude; the
    gradients (Adam's mu after the step, b1 = 0) within 1e-3 of each
    leaf's scale (compare.grad_gaps), the VAE's G step as
    compare.float32_gradients_held says (a rounding flips a choice ahead
    of its losses on the H100, and every generator leaf moves).  Held in float64
    (TrainState.to), where no rounding flips a choice: the losses within
    1e-4 relative and the gradients within 1e-9 of each leaf's scale."""
    from surfelmapping_tpu_torch.models.pix2pix import (SpadeConfig, SpadeTrainer,
                                                        init_state_numpy)

    rng = np.random.default_rng(SEED)
    res = {}
    for use_vae in (False, True):
        cfg = SpadeConfig(ngf=16, ndf=16, crop_size=64, num_d=2, n_layers_d=4, use_vae=use_vae)
        tree = init_state_numpy(cfg)
        random_bn_stats(tree["g_batch_stats"], rng)
        label, real = (torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32))
                       for _ in range(2))
        noise = torch.from_numpy(rng.normal(0, 1, (2, cfg.z_dim))) if use_vae else None
        out = {}
        for dtype in (torch.float32, torch.float64):
            for where, d in (("card", dev), ("cpu", "cpu")):
                for step in ("d_step", "g_step"):
                    tr = SpadeTrainer(cfg, device=d)
                    st, logs = getattr(tr, step)(tr.state_from_numpy(tree).to(dtype),
                                                 label.to(dtype), real.to(dtype), noise=noise)
                    out[dtype, where, step] = (tr.state_to_numpy(st),
                                               {k: float(v) for k, v in logs.items()})
        case = {}
        for step, net in (("d_step", "d"), ("g_step", "g")):
            r = {}
            for dtype in (torch.float32, torch.float64):
                (card, card_logs), (cpu, cpu_logs) = (out[dtype, w, step] for w in ("card", "cpu"))
                name = str(dtype)[6:]
                r[f"loss_rel_err_{name}"] = max(abs(card_logs[k] - cpu_logs[k]) / abs(cpu_logs[k])
                                                for k in cpu_logs)
                r[f"grad_{name}"] = gap_summary(
                    grad_gaps(*(t[f"{net}_opt"]["inner_state"]["0"]["mu"] for t in (card, cpu))))
                st_card, st_cpu = (flat(t[f"{net}_batch_stats"]) for t in (card, cpu))
                r[f"stored_err_{name}"] = max(
                    float(np.abs(st_card[k] - st_cpu[k]).max())
                    / max(float(np.abs(st_cpu[k]).max()), 1e-30) for k in st_cpu)
                r[f"finite_{name}"] = all(math.isfinite(v) for v in card_logs.values())
            r["losses"] = out[torch.float32, "card", step][1]
            case[step] = r
            if not (r["finite_float32"] and r["finite_float64"]
                    and r["loss_rel_err_float32"] <= 1e-4 and r["loss_rel_err_float64"] <= 1e-4
                    and r["stored_err_float32"] <= 1e-5
                    and float32_gradients_held(r["grad_float32"], use_vae and net == "g")
                    and r["grad_float64"]["max"] <= 1e-9):
                emit("small_spade_train", **res, failed={"vae" if use_vae else "plain": case})
                raise AssertionError(f"small_spade_train: {'vae' if use_vae else 'plain'} {step} "
                                     f"card vs CPU out of tolerance {r}")
        res["vae" if use_vae else "plain"] = case
    emit("small_spade_train", **res)


def phase_spade_train(dev, mapper, scene, counters, smi: str, root: Path) -> dict:
    """SPADE training at the JAX CLI's defaults (ngf 64, ndf 64, crop 256,
    batch 1, num_d 2, n_layers_d 4, VGG19 on with random init, d_steps_per_g
    2) on views of the main phase's map: render_view (K1) -> the u8 label
    (views.render_u8) at the poses of 12 of its fused frames, the scene's
    RGB there as the real images, both as PNGs.  Then the port's spade_train
    CLI for 2 epochs x 10 steps, a resume with --continue-train for one
    more epoch of decay (epochs 2 and 3 from the cursor iter.txt records),
    and spade_test on one view from the written checkpoint; the PNGs stay
    under ``root`` (label/, image/) for the spade_dp phase.  Held: every
    loss finite, the G and D params moved, the checkpoint read back bit for
    bit, the enhanced frame keeps the rendered pixels where the semantic is
    not 0.  Measured on the resumed state, in the CLI's pattern (a D step
    each iteration, a G step every second): the wall ms per iteration over
    TRAIN_TIMED iterations after TRAIN_WARM, with its spread, its two
    halves and the host's time to enqueue an iteration (the host's CPU
    model beside them), each step's card time and launches from the
    profiler, the card's idle share (card ms per iteration over wall ms),
    each step's float32 bound (train_step_flops over 67 TFLOP/s), the
    kernels of one iteration with a G step (the top ten, and the card time
    and launches of each TRAIN_KERNEL_GROUPS kind),
    peak memory, and the losses of the first and last logged iterations."""
    from PIL import Image

    from surfelmapping_tpu_torch import spade_test, spade_train
    from surfelmapping_tpu_torch.models.checkpoint import load_train_state, packb
    from surfelmapping_tpu_torch.models.data import PairedRenderDataset
    from surfelmapping_tpu_torch.models.pix2pix import (SpadeConfig, SpadeTrainer,
                                                        init_state_numpy)
    from surfelmapping_tpu_torch.ops.splat import render_view
    from surfelmapping_tpu_torch.views import render_u8

    cfg = SpadeConfig()  # the CLI's defaults: ngf 64, ndf 64, crop 256, num_d 2, 4 layers
    ids = list(range(4, 100, 8))  # 12 fused frames
    reset_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    res = {"card": smi, "frames": ids}
    dirs = {k: root / k for k in ("label", "image", "semantic", "enhanced")}
    for d in list(dirs.values())[:3]:
        d.mkdir()
    t0 = time.perf_counter()
    for i in ids:
        rgb, _, _, pose = scene.frame(i)
        label, sem = (t.cpu().numpy() for t in render_u8(render_view(mapper.smap, pose,
                                                                     mapper.cam)))
        name = f"{i:06d}.png"
        Image.fromarray(label).save(dirs["label"] / name)
        Image.fromarray(sem).save(dirs["semantic"] / name)
        Image.fromarray(rgb).save(dirs["image"] / name)
    res["render_s"] = time.perf_counter() - t0
    ckpt = root / "ckpt"
    argv = ["--label-dir", str(dirs["label"]), "--image-dir", str(dirs["image"]),
            "--niter", "1", "--niter-decay", "1", "--steps-per-epoch", "10",
            "--log-every", "1", "--display-every", "10", "--ckpt-dir", str(ckpt)]
    for run, extra in (("train", []), ("resume", ["--continue-train"])):
        if run == "resume":
            argv[argv.index("--niter-decay") + 1] = "2"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as log:
            rc = spade_train.main(argv + extra)
        torch.cuda.synchronize()
        res[f"{run}_s"] = time.perf_counter() - t0
        if rc != 0 or (run == "resume" and "restored checkpoint" not in log.getvalue()):
            raise AssertionError(f"spade_train: the {run} run failed (rc {rc})")
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    lines = [ln for ln in (ckpt / "loss_log.txt").read_text().splitlines()
             if ln.startswith("(epoch")]
    losses = [{k.rstrip(":"): float(v) for k, v in zip(ln.split(")")[1].split()[::2],
                                                      ln.split(")")[1].split()[1::2])}
              for ln in lines]
    res.update(logged_iterations=len(losses), first_losses=losses[0], last_losses=losses[-1],
               last_g_losses=[d for d in losses if "g_total" in d][-1])
    finite = all(math.isfinite(v) for d in losses for v in d.values())

    raw = (ckpt / "latest.msgpack").read_bytes()
    res["checkpoint_bytes"] = len(raw)
    trainer = SpadeTrainer(cfg)  # the card
    state = trainer.state_from_numpy(load_train_state(str(ckpt / "latest.msgpack")))
    round_trip = packb(trainer.state_to_numpy(state)) == raw
    init = init_state_numpy(cfg)  # the CLI's init
    moved = {net: sum(not np.array_equal(a, flat(init[f"{net}_params"])[k])
                      for k, a in flat(load_train_state(str(ckpt / "latest.msgpack"))
                                       [f"{net}_params"]).items())
             for net in ("g", "d")}
    del raw
    res.update(params_moved=moved, checkpoint_round_trip=round_trip, step=state.step,
               g_adam_count=state.g_opt.count, d_adam_count=state.d_opt.count)

    ds = PairedRenderDataset(str(dirs["label"]), str(dirs["image"]), crop_size=cfg.crop_size,
                             load_size=int(cfg.crop_size * 1.12), seed=1)
    batches = [tuple(torch.from_numpy(a) for a in b)
               for b in ds.batches(1, TRAIN_WARM + TRAIN_TIMED)]

    def iteration(i, lab, img):
        trainer.d_step(state, lab, img)
        if i % 2 == 0:
            trainer.g_step(state, lab, img)

    wall, host = [], []
    for i, (lab, img) in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        iteration(i, lab, img)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    wall, host = wall[TRAIN_WARM:], host[TRAIN_WARM:]
    lab, img = batches[0]
    d_launch, d_ms = device_profile(lambda: trainer.d_step(state, lab, img), calls=3)
    g_launch, g_ms = device_profile(lambda: trainer.g_step(state, lab, img), calls=3)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        iteration(0, lab, img)  # a D step and a G step
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in device_events(prof)), key=lambda k: -k[1])
    groups = {}
    for k, t, c in kernels:
        g = next((g for g, pat in TRAIN_KERNEL_GROUPS if re.search(pat, k, re.I)), "other")
        ms, n = groups.get(g, (0.0, 0))
        groups[g] = (ms + t, n + c)
    res["d_and_g_step_kernels"] = dict(
        device_ms=sum(k[1] for k in kernels), launches=sum(k[2] for k in kernels),
        groups={g: dict(device_ms=t, launches=n) for g, (t, n) in groups.items()},
        top=[dict(name=k[:100], device_ms=t, launches=c) for k, t, c in kernels[:10]])
    flops = train_step_flops(cfg, 1)
    busy = d_ms + g_ms / 2
    wall_ms = statistics.mean(wall)
    half = len(wall) // 2
    res.update(
        host_cpu=host_cpu(), timed_iterations=len(wall),
        wall_ms_per_iteration=wall_ms, wall_ms_spread=spread(wall),
        wall_ms_per_iteration_halves=[statistics.mean(wall[:half]),
                                      statistics.mean(wall[half:])],
        wall_ms_with_g_step=spread(wall[::2]), wall_ms_d_step_only=spread(wall[1::2]),
        host_ms_per_iteration=statistics.mean(host), host_ms_spread=spread(host),
        iterations_per_s=1e3 / wall_ms, d_step_ms_device=d_ms, g_step_ms_device=g_ms,
        d_step_launches=d_launch, g_step_launches=g_launch,
        launches_per_iteration=d_launch + g_launch / 2,
        host_us_per_launch=statistics.mean(host) * 1e3 / (d_launch + g_launch / 2),
        flops=flops,
        d_step_f32_bound_ms=flops["d_step"] / F32_OPS_PER_S * 1e3,
        g_step_f32_bound_ms=flops["g_step"] / F32_OPS_PER_S * 1e3,
        share_of_f32_bound=(flops["d_step"] + flops["g_step"]) / F32_OPS_PER_S * 1e3
        / (d_ms + g_ms),
        device_busy_ms_per_iteration=busy, device_idle_share=max(0.0, 1.0 - busy / wall_ms),
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    del trainer, state

    name = f"{ids[0]:06d}.png"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = spade_test.main(["--ckpt", str(ckpt / "latest.msgpack"), "--label-dir",
                              str(dirs["label"]), "--semantic-dir", str(dirs["semantic"]),
                              "--out", str(dirs["enhanced"]), "--limit", "1"])
    final, label, sem = (np.asarray(Image.open(dirs[k] / name))
                         for k in ("enhanced", "label", "semantic"))
    kept = bool(rc == 0 and final.shape == label.shape
                and np.array_equal(final[sem != 0], label[sem != 0]))
    res.update(enhanced=name, hole_share=float((sem == 0).mean()), rendered_pixels_kept=kept)
    launches = read_counts(counters)
    res["launches"] = launches
    emit("spade_train", **res)
    if not (finite and moved["g"] and moved["d"] and round_trip and kept):
        raise AssertionError(f"spade_train: losses finite {finite}, params moved {moved}, "
                             f"checkpoint round trip {round_trip}, rendered pixels kept {kept}")
    if launches["zbuffer_argmin"] < len(ids):
        raise AssertionError(f"spade_train: K1 launched {launches['zbuffer_argmin']} times "
                             f"for {len(ids)} labels")
    return {"zbuffer_argmin": launches["zbuffer_argmin"]}


def spade_dp_job(root: Path, ranks: int) -> tuple[list, bytes, float]:
    """tools/spade_dp_jobs ``steps`` at the CLI's defaults, float32, on the
    spade_train phase's PNGs under ``root``: a global batch of 2 over
    ``ranks`` gloo ranks sharing the card (NCCL refuses two ranks on one
    GPU), a D step and a G step, then DP_WARM + DP_TIMED iterations.
    Returns each rank's JSON line in rank order, rank 0's state file after
    the two steps (every rank's is checked to be the same bytes), and the
    job's seconds."""
    from surfelmapping_tpu_torch.parallel import distributed

    out = root / f"dp{ranks}"
    cmd = distributed.python_module(
        "surfelmapping_tpu_torch.tools.spade_dp_jobs", "steps", "--out", str(out),
        "--label-dir", str(root / "label"), "--image-dir", str(root / "image"), "--batch", "2",
        "--timed", str(DP_WARM + DP_TIMED), "--warm", str(DP_WARM))
    t0 = time.perf_counter()
    distributed.spawn_ranks(cmd, ranks, "gloo", timeout=600)
    job_s = time.perf_counter() - t0
    lines = [json.loads((out / f"rank{r}.json").read_text()) for r in range(ranks)]
    raw = [(out / f"rank{r}.msgpack").read_bytes() for r in range(ranks)]
    if any(r != raw[0] for r in raw) or not all(ln["ranks_identical"] for ln in lines):
        raise AssertionError(f"spade_dp: the {ranks} ranks' states differ")
    return lines, raw[0], job_s


def phase_spade_dp(root: Path, smi: str) -> None:
    """SPADE data-parallel training at the CLI's defaults (ngf 64, ndf 64,
    crop 256, num_d 2, n_layers_d 4, VGG19 on) on the spade_train phase's
    K1-rendered label and image PNGs under ``root``, two gloo ranks sharing
    the card.  It runs no kernel of the port: its labels are the
    spade_train phase's K1 renders, counted there.
      (a) Hold: a D step and a G step on a global batch of 2, one image per
          rank, against one process on the same batch on the card, as
          compare.float32_steps_held holds them (the global losses within
          1e-4 relative, the gradients by compare.float32_gradients_held in
          its flipped form, the stored SN and BN state within 1e-5, the
          parameters within 2 lr); both ranks' states the same bytes, and
          the same by a checksum all-reduced with MIN and MAX; 1 collective
          in the D step, 37 (one per batch norm forward and backward, and
          the gradients) in the G step.
      (b) CLI: ``python -m surfelmapping_tpu_torch.spade_train --devices 2
          --batch 2`` in two gloo ranks for 3 iterations, then resumed with
          --continue-train for one more epoch of decay: rank 0's checkpoint
          reads back bit for bit, the logged losses are finite, the Adam
          counts are the iterations'.
      (c) Timing, one process (batch 2) and two ranks (1 image each) in the
          CLI's pattern: wall ms per iteration over DP_TIMED iterations
          after DP_WARM, with its spread; each rank's busy ms per iteration
          (torch.profiler) and the card's idle share; the gradient
          collective's bytes and ms per D and per G step, the batch norms'
          collectives per G step (count, bytes, ms; the ms replayed by
          sharded_jobs.collective_ms); the peak memory per rank."""
    from surfelmapping_tpu_torch.models.checkpoint import load_train_state, packb, unpackb
    from surfelmapping_tpu_torch.models.pix2pix import SpadeConfig, SpadeTrainer
    from surfelmapping_tpu_torch.parallel import distributed

    cfg = SpadeConfig()
    res = {"card": smi, "host_cpu": host_cpu()}
    one, one_raw, one_s = spade_dp_job(root, 1)
    two, two_raw, two_s = spade_dp_job(root, 2)
    gaps = step_gaps(unpackb(two_raw), unpackb(one_raw), two[0]["logs"], one[0]["logs"])
    held = float32_steps_held(gaps)
    calls = {k: v["calls"] for k, v in two[0]["collectives"].items()}
    held = held and calls == {"d_step": 1, "g_step": 2 * two[0]["spade_norms"] + 1}
    res["hold"] = dict(gaps, losses_one_process=one[0]["logs"], losses_two_ranks=two[0]["logs"],
                       collective_calls=calls, ranks_bit_identical=True)
    del one_raw, two_raw

    ckpt = root / "dp_ckpt"
    argv = ["--label-dir", str(root / "label"), "--image-dir", str(root / "image"),
            "--batch", "2", "--devices", "2", "--niter", "1", "--niter-decay", "0",
            "--steps-per-epoch", "3", "--log-every", "1", "--display-every", "2",
            "--ckpt-dir", str(ckpt), "--timeout", "600"]
    cli = {}
    for run, extra in (("train", []), ("resume", ["--continue-train"])):
        if run == "resume":
            argv[argv.index("--niter-decay") + 1] = "1"
        t0 = time.perf_counter()
        out = distributed.spawn_ranks(distributed.python_module(
            "surfelmapping_tpu_torch.spade_train", *argv, *extra), 2, "gloo", timeout=600)
        cli[f"{run}_s"] = time.perf_counter() - t0
        if "2 ranks over gloo" not in out[0].stdout or (
                run == "resume" and "restored checkpoint" not in out[0].stdout):
            raise AssertionError(f"spade_dp: the CLI's {run} run: {out[0].stdout[-2000:]}")
    lines = [ln for ln in (ckpt / "loss_log.txt").read_text().splitlines()
             if ln.startswith("(epoch")]
    losses = [float(v) for ln in lines for v in ln.split(")")[1].split()[1::2]]
    raw = (ckpt / "latest.msgpack").read_bytes()
    trainer = SpadeTrainer(cfg)  # the card
    state = trainer.state_from_numpy(load_train_state(str(ckpt / "latest.msgpack")))
    cli.update(logged_iterations=len(lines), losses_finite=all(map(math.isfinite, losses)),
               checkpoint_round_trip=packb(trainer.state_to_numpy(state)) == raw,
               iter_txt=(ckpt / "iter.txt").read_text().split(),
               g_adam_count=state.g_opt.count, d_adam_count=state.d_opt.count,
               images=len(os.listdir(ckpt / "web" / "images")))
    del trainer, state, raw
    res["cli"] = cli

    n_d, n_g = two[0]["d_params"], two[0]["g_params"]
    grad_bytes = {"d_step": (n_d + 1) * 4, "g_step": (n_g + 4) * 4}  # the logs ride along
    bn_bytes = two[0]["collectives"]["g_step"]["bytes"] - grad_bytes["g_step"]
    wall = statistics.mean(r["wall_ms"] for r in two)
    res["timing"] = dict(
        one_process=dict(wall_ms=one[0]["wall_ms"], wall_ms_spread=spread(one[0]["wall_ms_all"]),
                         busy_ms=one[0]["busy_ms_per_iteration"],
                         profiled_wall_ms=one[0]["profiled_wall_ms"],
                         top_kernels=one[0]["top_kernels"],
                         device_idle_share=1 - one[0]["busy_ms_per_iteration"] / one[0]["wall_ms"],
                         max_memory_allocated=one[0]["max_memory_allocated"], job_s=one_s),
        two_ranks=dict(wall_ms=wall, wall_ms_spread=[spread(r["wall_ms_all"]) for r in two],
                       busy_ms=[r["busy_ms_per_iteration"] for r in two],
                       profiled_wall_ms=[r["profiled_wall_ms"] for r in two],
                       top_kernels=two[0]["top_kernels"],
                       device_idle_share=1 - sum(r["busy_ms_per_iteration"] for r in two) / wall,
                       max_memory_allocated=[r["max_memory_allocated"] for r in two],
                       job_s=two_s),
        g_params=n_g, d_params=n_d, spade_norms=two[0]["spade_norms"],
        grad_collective_bytes=grad_bytes,
        grad_collective_ms=dict(d_step=two[0]["collective_ms"]["d_grad"],
                                g_step=two[0]["collective_ms"]["g_grad"]),
        batch_norm_collectives_per_g_step=dict(
            count=two[0]["collectives"]["g_step"]["calls"] - 1, bytes=bn_bytes,
            ms=two[0]["collective_ms"]["g_batch_norms"]))
    emit("spade_dp", **res)
    if not (held and cli["losses_finite"] and cli["checkpoint_round_trip"]
            and cli["g_adam_count"] == 6 and cli["d_adam_count"] == 9):
        raise AssertionError(f"spade_dp: held {held}, CLI {cli}")


def phase_small_reference(dev, zbuf_mod) -> None:
    """The reference-form fusion ops on a 128x96 camera, on the card vs on
    the CPU, from one map (three frames fused on the CPU): the full-map
    index map (build_index_map), association (associate), the fuse scatter
    into the map viewed as a table (fuse_active) and the tail append
    (append_flat), record for record; then index_resolve (the three-op
    z-buffer) against K1 on the card at the index map's shape, exact."""
    from surfelmapping_tpu_torch.config import MapConfig, PipelineParams
    from surfelmapping_tpu_torch.io.synthetic import SyntheticScene, tiny_cam
    from surfelmapping_tpu_torch.ops import active
    from surfelmapping_tpu_torch.ops.association import associate
    from surfelmapping_tpu_torch.ops.colors import encode_color
    from surfelmapping_tpu_torch.ops.index_map import build_index_map
    from surfelmapping_tpu_torch.ops.preprocess import preprocess_frame
    from surfelmapping_tpu_torch.ops.transforms import invert_se3
    from surfelmapping_tpu_torch.pipeline import SurfelMapper, stage_frame
    from surfelmapping_tpu_torch.surfels import pack_records

    cam, params = tiny_cam(128, 96), PipelineParams(fuse_thresh_factor=0.05)
    scene = SyntheticScene(cam, step=0.4)
    base = SurfelMapper(cam, params, MapConfig(capacity=1 << 14), device="cpu")
    for i in range(3):
        base.process_frame(*scene.frame(i))
    runs = {}
    for d in (dev, torch.device("cpu")):
        smap = base.smap.clone().to(d)
        rgb, depth, sem, pose = stage_frame(d, *scene.frame(3))
        depth_f = preprocess_frame(depth, sem, cam, params)
        T_inv = invert_se3(pose)
        idx = build_index_map(smap, T_inv, 3.0, cam, params)
        res = associate(depth_f, rgb, sem, idx, smap, pose, T_inv, 3.0, cam, params)
        cb = active.checkerboard_flat
        flat = active.AssocFlat(
            x=cb(res.pos[..., 0]), y=cb(res.pos[..., 1]), z=cb(res.pos[..., 2]),
            conf=cb(res.conf), colorsem=encode_color(cb(res.rgb), cb(res.sem)),
            init_t=cb(res.init_t), last_t=cb(res.last_t), nx=cb(res.normal[..., 0]),
            ny=cb(res.normal[..., 1]), nz=cb(res.normal[..., 2]), radius=cb(res.radius),
            mark=cb(res.mark).long())
        table = active.fuse_active(active.table_from_map(smap), flat)
        fused, dropped = active.append_flat(active.map_from_table(table, smap.count.clone()),
                                            flat)
        runs[d.type] = dict(index=idx.cpu(), mark=res.mark.cpu(), dropped=int(dropped),
                            pos=res.pos.cpu(), normal=res.normal.cpu(),
                            records=pack_records(fused)[:int(fused.count)].cpu())
    a, b = runs["cuda"], runs["cpu"]
    for k in ("index", "mark", "pos", "normal", "records"):
        if not torch.equal(a[k].view(torch.int32) if a[k].is_floating_point() else a[k],
                           b[k].view(torch.int32) if b[k].is_floating_point() else b[k]):
            raise AssertionError(f"small_reference: {k} differs card vs CPU")
    n_rec = a["records"].shape[0]
    merged, new = int((a["mark"] >= 0).sum()), int((a["mark"] == -1).sum())
    if not (merged and new and a["dropped"] == 0 == b["dropped"]):
        raise AssertionError(f"small_reference: merged {merged} new {new} dropped "
                             f"{a['dropped']}/{b['dropped']}")

    # index_resolve vs K1 at the index map's shape, random keys and many ties
    P, A = 453_620, 1 << 20
    resolved = {}
    for case in ("random", "ties"):
        zkey, fpix = k1_case(dev, P, A, 0.33)
        if case == "ties":
            zkey = torch.where(zkey == INT32_MAX, zkey, zkey % 64)
        ids = torch.arange(A, dtype=torch.int32, device=dev)
        want = active.index_resolve(zkey, fpix, ids, P, empty_to_minus1=False)
        _, got = zbuf_mod.zbuffer_argmin(zkey, fpix, P)
        if not torch.equal(got, want):
            raise AssertionError(f"small_reference: K1 differs from index_resolve ({case}) on "
                                 f"{int((got != want).sum())} pixels")
        resolved[case] = int((want != INT32_MAX).sum())
    emit("small_reference", camera="128x96", records=n_rec, merged=merged, new=new,
         card_equals_cpu=True, index_resolve_equals_k1=True, k1_pixels_hit=resolved)


# The least share of the single card's records that the two-rank map holds
# bit for bit: the sound runs (NVIDIA H100 80GB HBM3, 700.00 W) hold
# 0.9999989 (2 records of 1,797,147 differ, by the depth-key tie rule); a
# fault in a few frames' merges on one rank moves thousands.
RECORDS_SHARED_TWO_RANKS = 0.99995


def phase_sharded(dev, cam, params, host: list, main_rate: dict, smi: str,
                  n_frames: int = 36) -> dict:
    """The sharded engine at KITTI resolution on the main phase's first
    ``n_frames`` frames (ShardedMapper at the main phase's settings: 512
    active blocks of 2048 slots, a sync every 10 frames), against a
    single-card SurfelMapper at the same settings on the same frames:
      (a) one rank over NCCL (this process, a process group of one): its
          gathered map equals the single card's, count and sorted records
          bit for bit;
      (b) two ranks sharing the card over gloo (NCCL refuses two ranks on
          one GPU), launched by the port's launcher: the same count and at
          most ~90 records (a share of 0.99995) that differ from the single
          card's bit for bit (a depth-key tie resolves to the smallest global
          id, rank * S + slot, where the single card takes the smallest
          slot; sound runs differ in 2 of ~1.8 M records, 0.9999989), K1
          and K2 launched in both ranks every frame.
    Each prints frames/s over its windows (frames 6-16, 16-26) beside the
    main phase's, the card's busy share over frames 26-36 under the
    profiler (both ranks' busy time over the wall time for (b)), the
    collectives' bytes and time per frame, and K1's and K2's launches per
    rank and frame.  Returns the launches of both runs, summed."""
    from surfelmapping_tpu_torch.config import MapConfig
    from surfelmapping_tpu_torch.parallel import distributed
    from surfelmapping_tpu_torch.pipeline import SurfelMapper
    from surfelmapping_tpu_torch.surfels import pack_records
    from surfelmapping_tpu_torch.tools import sharded_jobs

    capacity, sync, warm, window = 1 << 24, 10, 6, 10
    single = SurfelMapper(cam, params, MapConfig(capacity=capacity, active_blocks=512,
                                                 freeze_active_budget=True), sync_every=sync)
    frames = [single.stage_frame(*f) for f in host[:n_frames]]
    for f in frames:
        single.process_frame(*f)
    want = pack_records(single.smap)[:single.count].cpu().numpy()
    res = {"card": smi, "frames": n_frames, "single_count": single.count,
           "main_windows": main_rate["windows"]}
    del single

    with tempfile.TemporaryDirectory() as tmp:
        comm = distributed.initialize(backend="nccl", init_method=f"file://{tmp}/rendezvous",
                                      rank=0, world_size=1)
        try:
            one, smap = sharded_jobs.kitti_run(comm, frames, capacity, sync, warm, window)
            got = pack_records(smap)[:int(smap.count)].cpu().numpy()
        finally:
            distributed.shutdown()
    if one["count"] != res["single_count"] or got.shape != want.shape:
        raise AssertionError(f"sharded (a): {one['count']} surfels vs {res['single_count']}")
    rows = lambda r: r.view(np.int32)[np.lexsort(r.view(np.int32).T[::-1])]  # noqa: E731
    if not np.array_equal(rows(got), rows(want)):
        raise AssertionError("sharded (a): the one-rank map differs from the single card's")
    res["nccl_one_rank"] = dict(one, records_bit_equal=True)

    with tempfile.TemporaryDirectory() as tmp:
        cmd = distributed.python_module(
            "surfelmapping_tpu_torch.tools.sharded_jobs", "kitti", "--out", tmp,
            "--frames", str(n_frames), "--capacity", str(capacity), "--sync-every", str(sync),
            "--warm", str(warm), "--window", str(window))
        t0 = time.perf_counter()
        results = distributed.spawn_ranks(cmd, 2, "gloo", timeout=300)
        job_s = time.perf_counter() - t0
        two = [json.loads(ln[len("RESULT "):]) for r in results
               for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
        got = np.load(Path(tmp) / "records.npy")
    if len(two) != 2 or any(t["count"] != res["single_count"] for t in two):
        raise AssertionError(f"sharded (b): counts {[t['count'] for t in two]} vs "
                             f"{res['single_count']}")
    a_rows = collections.Counter(map(bytes, got.view(np.int32)))
    b_rows = collections.Counter(map(bytes, want.view(np.int32)))
    share = sum((a_rows & b_rows).values()) / max(len(want), 1)
    if got.shape != want.shape or share < RECORDS_SHARED_TWO_RANKS:
        raise AssertionError(f"sharded (b): {share:.5f} of the records shared")
    fused = n_frames - 1
    for t in two:
        if (t["launches"]["zbuffer_argmin"] < fused
                or t["launches"]["preprocess_stencil"] < n_frames):
            raise AssertionError(f"sharded (b): rank {t['rank']} launches {t['launches']}")
    if (one["launches"]["zbuffer_argmin"] < fused
            or one["launches"]["preprocess_stencil"] < n_frames):
        raise AssertionError(f"sharded (a): launches {one['launches']}")
    last = [t["windows"][-1] for t in two]
    res["gloo_two_ranks"] = dict(
        job_s=job_s, records_shared=share, ranks=two,
        card_busy_share=sum(w["busy_ms"] for w in last) / max(w["wall_ms"] for w in last))
    res["nccl_one_rank"]["card_busy_share"] = (one["windows"][-1]["busy_ms"]
                                               / one["windows"][-1]["wall_ms"])
    emit("sharded", **res)
    return {k: one["launches"][k] + sum(t["launches"][k] for t in two)
            for k in one["launches"]}


def map_file(path: str) -> tuple[list, np.ndarray]:
    """A reference-format map file's (count, start_id, end_id) and its
    records as int32 words."""
    raw = Path(path).read_bytes()
    head = np.frombuffer(raw[:12], "<i4").tolist()
    return head, np.frombuffer(raw[12:], "<i4").reshape(head[0], 12)


def phase_kitti_dir(dev, cam, params, scene, host: list, main_rate: dict, counters,
                    smi: str) -> dict:
    """The dataset path at KITTI resolution: the main phase's 100 frames
    (SyntheticScene(kitti_cam(), step=0.8)) written as a KITTI-layout
    directory (io/kitti.write_kitti_dir: RGB, u16 mm depth and semantic
    PNGs, times, calibration, pose @ inv(T20)), then on the card:
      1. the reader decodes every frame bit-equal to the scene's arrays, with
         the native decoder where its library builds on this machine (g++
         and libpng's header), else PIL — the decoder is named;
      2. ``build_map DIR`` (its main(argv), the CLI's defaults) writes the map
         of a SurfelMapper with the same settings fed the scene's arrays at
         the reader's poses, record for record; K2 >= 100 and K1 >= 99
         launches; the main phase's map checks;
      3. ``--frames 50`` ends at id 49; ``--sub-level 1`` fuses 613x185
         frames (padded to 614x186) with the intrinsics halved into a
         non-empty map;
      4. the Python map IO (and the native one where it builds) save and
         load the ~4.4 M-surfel map to the same records and bytes, timed;
      5. ``load_map MAP --calib DIR --mode paired`` writes a PNG pair per
         frame, each covering more than half of the pixels its frame saw
         (depth in [near, far) outside the stereo border); paired views/s;
      6. tools/run_e2e passes (build_map -> load_map x4 -> spade_train ->
         spade_test -> move_data at KITTI resolution);
      7. the viewer: with matplotlib, ``build_map DIR --frames 20
         --gui-snapshots D --gui-render-every 5``; without it, the loop's
         card work directly (gui.panel_renders: the local model and the
         map at the frame's pose, the map at the map-view pose);
    and the dataset path's frames/s (reader -> SurfelMapper at the main
    phase's settings, so what differs is the decode and the upload) over
    the main phase's windows (printed beside them), with the card's idle
    share over frames 60-80, the decoder's host ms per frame and the
    upload's (stage_frame of a frame's host arrays, to a synchronize)."""
    import importlib.util
    from PIL import Image

    from surfelmapping_tpu_torch import build_map, load_map, surfels
    from surfelmapping_tpu_torch.config import MapConfig
    from surfelmapping_tpu_torch.gui import map_view_pose, panel_renders
    from surfelmapping_tpu_torch.io import kitti, native
    from surfelmapping_tpu_torch.pipeline import SurfelMapper
    from surfelmapping_tpu_torch.tools import run_e2e

    why = native.missing_toolchain()
    decoder = "native" if why is None else "pil"
    res = {"card": smi, "decoder": decoder,
           "native_library": "builds here" if why is None else f"not built: {why.splitlines()[0]}"}
    n = len(host)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        seq = str(root / "seq")
        t0 = time.perf_counter()
        kitti.write_kitti_dir(seq, cam, host)
        res["write_s"] = time.perf_counter() - t0

        reader = kitti.KittiReader(seq, decoder=decoder)
        decode_ms, equal = [], 0
        for want in host:
            t0 = time.perf_counter()
            f = reader.get_next()
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            equal += all(np.array_equal(a, b) and a.dtype == b.dtype
                         for a, b in zip((f.rgb, f.depth, f.semantic), want[:3]))
        reader.close()
        poses = reader.poses
        res.update(frames=n, resolution=f"{cam.width}x{cam.height}", decoded_bit_equal=equal,
                   decode_ms_per_frame=spread(decode_ms))
        if equal != n or reader.cam != cam:
            raise AssertionError(f"kitti_dir: {equal} of {n} frames decoded bit-equal, "
                                 f"camera {reader.cam}")

        reset_counts(counters)
        map_path = str(root / "map.bin")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as log:
            rc = build_map.main([seq, "--out", map_path, "--decoder", decoder])
        cli_s = time.perf_counter() - t0
        cli = read_counts(counters)
        ref = SurfelMapper(cam, params, MapConfig(capacity=1 << 22), sync_every=8)
        for (rgb, depth, sem, _), pose in zip(host, poses):
            ref.process_frame(rgb, depth, sem, pose)
        ref_path = str(root / "ref.bin")
        ref.save_map(ref_path, 0, n - 1)
        (head, rec), (ref_head, ref_rec) = map_file(map_path), map_file(ref_path)
        same = head == ref_head == [ref.count, 0, n - 1] and np.array_equal(rec, ref_rec)
        res.update(cli_s=cli_s, cli_fps=n / cli_s, cli_launches=cli, map_header=head,
                   cli_map_equals_mapper_at_reader_poses=same,
                   cli_names_decoder=f"decoder {decoder}" in log.getvalue())
        if rc != 0 or not same or not res["cli_names_decoder"]:
            raise AssertionError(f"kitti_dir: build_map rc {rc}, map header {head} vs "
                                 f"{ref_head}, records equal {same}")
        if cli["preprocess_stencil"] < n or cli["zbuffer_argmin"] < n - 1:
            raise AssertionError(f"kitti_dir: kernels not on the dataset path: {cli}")
        res["map"] = map_checks(ref.smap, scene)
        del ref

        f50, fsub = str(root / "f50.bin"), str(root / "sub.bin")
        with contextlib.redirect_stdout(io.StringIO()) as log:
            rc50 = build_map.main([seq, "--frames", "50", "--out", f50, "--decoder", decoder])
            rcsub = build_map.main([seq, "--sub-level", "1", "--out", fsub,
                                    "--decoder", decoder])
        half = kitti.KittiReader(seq, sub_level=1).cam
        res.update(frames_50_header=map_file(f50)[0], sub_level_1_header=map_file(fsub)[0],
                   sub_level_1_camera=[half.width, half.height, half.fx, half.cx])
        size = (cam.width >> 1, cam.height >> 1)  # 613x185 at KITTI's 1226x370
        if (rc50 != 0 or res["frames_50_header"][1:] != [0, 49] or rcsub != 0
                or res["sub_level_1_header"][0] == 0 or (half.width, half.height) != size
                or half.fx != cam.fx / 2 or half.cy != cam.cy / 2
                or "%dx%d" % size not in log.getvalue()):
            raise AssertionError(f"kitti_dir: --frames/--sub-level: {res}")

        io_s = {}
        t0 = time.perf_counter()
        smap, s0, s1 = surfels.load_map(map_path, dev)
        torch.cuda.synchronize()
        io_s["python_load"] = time.perf_counter() - t0
        py_path = str(root / "py.bin")
        t0 = time.perf_counter()
        surfels.save_map(smap, py_path, s0, s1)
        io_s["python_save"] = time.perf_counter() - t0
        io_equal = Path(py_path).read_bytes() == Path(map_path).read_bytes()
        if why is None:
            nat_path = str(root / "native.bin")
            t0 = time.perf_counter()
            nat_rec, a, b = native.load_map_native(map_path)
            io_s["native_load"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            native.save_map_native(nat_path, nat_rec, a, b)
            io_s["native_save"] = time.perf_counter() - t0
            io_equal = (io_equal and (a, b) == (s0, s1)
                        and np.array_equal(nat_rec.view(np.int32), rec)
                        and Path(nat_path).read_bytes() == Path(map_path).read_bytes())
        res.update(map_io_s=io_s, map_io_surfels=int(smap.count), map_io_equal=io_equal)
        del smap
        if not io_equal:
            raise AssertionError(f"kitti_dir: map IO differs {io_s}")

        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = load_map.main([map_path, "--calib", seq, "--mode", "paired",
                                "--out", str(root / "novel")])
        paired_s = time.perf_counter() - t0
        names = sorted(os.listdir(root / "paired" / "image"))
        seen_share, hit_share = [], []
        for i, (_, depth, _, _) in enumerate(host):
            sem = np.asarray(Image.open(root / "paired" / "semantic" / f"{i:06d}.png")) > 0
            d = depth.astype(np.float32) / 1000.0
            seen = (d >= params.near_clip) & (d < params.far_clip)
            seen[:, :int(params.stereo_border)] = False
            seen_share.append(float((sem & seen).sum() / seen.sum()))
            hit_share.append(float(sem.mean()))
        res.update(paired_views=len(names), paired_views_per_s=len(names) / paired_s,
                   paired_covered_of_seen=spread(seen_share), paired_hit_share=spread(hit_share))
        if rc != 0 or names != [f"{i:06d}.png" for i in range(n)] or min(seen_share) <= 0.5:
            raise AssertionError(f"kitti_dir: paired renders {len(names)}, coverage of the "
                                 f"seen pixels {min(seen_share)}")

        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = run_e2e.main(["--workdir", str(root / "e2e")])
        e2e = json.loads((root / "e2e" / "e2e.json").read_text())
        res["run_e2e"] = dict(ok=rc == 0 and e2e["ok"], s=time.perf_counter() - t0,
                              hops={k: {kk: vv for kk, vv in v.items() if kk != "dir"}
                                    for k, v in e2e["hops"].items()})
        if not res["run_e2e"]["ok"]:
            raise AssertionError(f"kitti_dir: run_e2e {e2e}")

        if importlib.util.find_spec("matplotlib") is not None:
            snaps = root / "snaps"
            with contextlib.redirect_stdout(io.StringIO()):
                rc = build_map.main([seq, "--frames", "20", "--gui-snapshots", str(snaps),
                                     "--gui-render-every", "5", "--out", str(root / "g.bin"),
                                     "--decoder", decoder])
            res["gui"] = dict(ran="build_map --gui-snapshots", snapshots=len(os.listdir(snaps)))
            gui_ok = rc == 0 and res["gui"]["snapshots"] == 4
        else:
            mapper = SurfelMapper(cam, params, MapConfig(capacity=1 << 22), sync_every=8)
            covered = []
            for i in range(20):
                rgb, depth, sem, _ = host[i]
                mapper.process_frame(rgb, depth, sem, poses[i])
                if (i + 1) % 5 == 0:
                    for local in (False, True):
                        out, map_out = panel_renders(mapper, mapper.smap, rgb, depth, sem,
                                                     poses[i], map_view_pose(poses[i]), local)
                        covered.append([float((o["id"] >= 0).float().mean())
                                        for o in (out, map_out)])
            res["gui"] = dict(ran="direct (no matplotlib): local_model + render_view at the "
                                  "frame and map-view poses", renders=2 * len(covered),
                              hit_shares=covered)
            gui_ok = all(min(c) > 0.05 for c in covered)
        if not gui_ok:
            raise AssertionError(f"kitti_dir: viewer {res['gui']}")

        mapper = SurfelMapper(cam, params, MapConfig(capacity=1 << 24, active_blocks=512,
                                                     freeze_active_budget=True), sync_every=32)
        reader = kitti.KittiReader(seq, decoder=decoder)

        def next_frame(i):
            f = reader.get_next()
            return f.rgb, f.depth, f.semantic, f.pose

        windows, idle = window_fps(mapper, next_frame, n)
        reader.close()
        stage_ms = []
        for rgb, depth, sem, pose in host[:20]:
            t0 = time.perf_counter()
            mapper.stage_frame(rgb, depth, sem, pose)
            torch.cuda.synchronize()
            stage_ms.append((time.perf_counter() - t0) * 1e3)
        res.update(windows=windows, idle=idle, main=main_rate,
                   upload_ms_per_frame=spread(stage_ms))
        del mapper
    launches = read_counts(counters)
    res["launches"] = launches
    emit("kitti_dir", **res)
    return {k: launches[k] for k in ("zbuffer_argmin", "preprocess_stencil")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from surfelmapping_tpu_torch.config import PipelineParams
    from surfelmapping_tpu_torch.io.synthetic import kitti_cam
    from surfelmapping_tpu_torch.ops import associate_merge as assoc_mod
    from surfelmapping_tpu_torch.ops import disc_dilate as dilate_mod
    from surfelmapping_tpu_torch.ops import preprocess_stencil as k2_mod
    from surfelmapping_tpu_torch.ops import visible_blocks as cull_mod
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

    kernels = [zbuf_mod.KERNEL, k2_mod.KERNEL, outres_mod.KERNEL, assoc_mod.KERNEL,
               dilate_mod.KERNEL, cull_mod.KERNEL]
    counters = kernels + [outres_mod.P1, outres_mod.P2]
    t0 = time.perf_counter()
    build_all(kernels)
    build_s = time.perf_counter() - t0
    ptxas = {k.name: [ln.strip() for ln in k.build_log.splitlines()
                      if "registers" in ln or "spill" in ln or "smem" in ln]
             for k in kernels}
    cam, params = kitti_cam(), PipelineParams()
    k2_build = k2_design(k2_mod, params.smooth_radius)
    outres_atoms = {op: n for op, n in sass_opcodes(outres_mod.KERNEL, "resolve_tiles",
                                                     modifiers=True).items()
                    if op.startswith("ATOM")}
    emit("build", seconds=build_s, ptxas=ptxas, k2=k2_build,
         outres_resolve_shared_atomics=outres_atoms)

    k1 = phase_k1(dev, zbuf_mod)
    k2 = phase_k2(dev, cam, params)
    probe = phase_outres(dev, outres_mod)
    phase_small(dev)
    phase_small_reference(dev, zbuf_mod)
    phase_small_icp(dev)
    mapper, scene, host, frames, fusion, main_rate = phase_main(dev, cam, params, counters, smi)
    phase_holds(dev, mapper, frames, zbuf_mod)
    assoc = phase_associate(dev, mapper, frames)
    views, per_view, render = phase_render(dev, mapper, scene, counters, smi)
    phase_render_holds(dev, mapper, scene, views[0], per_view[0]["n_active_blocks"], zbuf_mod)
    dilate = phase_dilate(dev, mapper, views[0], per_view[0]["n_active_blocks"])
    cull = phase_cull(dev, mapper, views)
    phase_small_spade(dev)
    enhance = phase_spade(dev, mapper, views, counters, smi)
    phase_small_spade_train(dev)
    with tempfile.TemporaryDirectory() as tmp:
        training = phase_spade_train(dev, mapper, scene, counters, smi, Path(tmp))
        phase_spade_dp(Path(tmp), smi)
    probes = phase_probes(counters)
    tracking, (icp_mapper, icp_pose) = phase_icp_ba(dev, counters, smi)
    phase_icp_holds(dev, icp_mapper, icp_pose, zbuf_mod)
    dataset = phase_kitti_dir(dev, cam, params, scene, host, main_rate, counters, smi)
    reset_counts(counters)
    sharded = phase_sharded(dev, cam, params, host, main_rate, smi)
    emit("paths", launches=dict(main=fusion, render=render, probes=probes, icp_ba=tracking,
                                spade=enhance, spade_train=training, kitti_dir=dataset,
                                sharded=sharded))

    k1i, k1r = k1["index"], k1["render"]
    table = [
        # index map's shape first; the renderer's shape in the *_render keys
        dict(name="zbuffer_argmin", route="cuda", source=zbuf_mod.KERNEL.repo_source,
             replaces="surfelmapping_tpu/ops/pallas_zbuf.py:188",
             launches=(fusion["zbuffer_argmin"] + render["zbuffer_argmin"]
                       + tracking["zbuffer_argmin"] + enhance["zbuffer_argmin"]
                       + training["zbuffer_argmin"] + dataset["zbuffer_argmin"]
                       + sharded["zbuffer_argmin"]),
             max_abs_err=max(k1i["max_abs_err"], k1r["max_abs_err"]),
             ms=k1i["ms"], plain_ms=k1i["plain_ms"], bound_ms=k1i["bound_ms"],
             bound_by="bytes", library_ms=k1i["library_ms"], ms_device=k1i["ms_device"],
             ms_device_cold=k1i["ms_device_cold"], library_ms_device=k1i["library_ms_device"],
             library_ms_device_cold=k1i["library_ms_device_cold"],
             device_launches_per_call=k1i["device_launches_per_call"],
             ms_render=k1r["ms"], ms_device_render=k1r["ms_device"],
             ms_device_cold_render=k1r["ms_device_cold"], plain_ms_render=k1r["plain_ms"],
             bound_ms_render=k1r["bound_ms"], library_ms_render=k1r["library_ms"],
             library_ms_device_render=k1r["library_ms_device"],
             library_ms_device_cold_render=k1r["library_ms_device_cold"]),
        dict(name="preprocess_stencil", route="cuda", source=k2_mod.KERNEL.repo_source,
             replaces="surfelmapping_tpu/ops/pallas_preprocess.py:188",
             launches=(fusion["preprocess_stencil"] + dataset["preprocess_stencil"]
                       + sharded["preprocess_stencil"]),
             max_abs_err=k2["max_abs_err"],
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None, ms_device=k2["ms_device"],
             ms_device_cold=k2["ms_device_cold"], ctas_per_sm=k2_build["ctas_per_sm"],
             sass_instructions_per_tap=k2_build["sass_instructions_per_tap"]),
        dict(name="associate_merge", route="cuda", source=assoc_mod.KERNEL.repo_source,
             replaces=None, launches=fusion["associate_merge"], max_abs_err=0.0,
             ms=assoc["ms"], plain_ms=assoc["plain_ms"], bound_ms=assoc["bound_ms"],
             bound_by="bytes", library_ms=None, ms_device=assoc["ms_device"],
             ms_device_cold=assoc["ms_device_cold"]),
        dict(name="disc_dilate", route="cuda", source=dilate_mod.KERNEL.repo_source,
             replaces=None, launches=render["disc_dilate"], max_abs_err=0.0,
             ms=dilate["ms"], plain_ms=dilate["plain_ms"], bound_ms=dilate["bound_ms"],
             bound_by="bytes", library_ms=None, ms_device=dilate["ms_device"],
             ms_device_cold=dilate["ms_device_cold"]),
        dict(name="visible_blocks", route="cuda", source=cull_mod.KERNEL.repo_source,
             replaces=None, launches=render["visible_blocks"], max_abs_err=0.0,
             ms=cull["ms"], plain_ms=cull["plain_ms"], bound_ms=cull["bound_ms"],
             bound_by="bytes", library_ms=None, ms_device=cull["ms_device"],
             ms_device_cold=cull["ms_device_cold"]),
        outres_row("pallas_zbuf", "tools/probe_pallas_zbuf.py:94", probe, 453_632,
                   probes["pallas_zbuf"], outres_mod.KERNEL.repo_source),
        outres_row("outres", "tools/probe_zbuf_variants.py:66", probe, 4 * 453_620,
                   probes["outres"], outres_mod.KERNEL.repo_source),
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
