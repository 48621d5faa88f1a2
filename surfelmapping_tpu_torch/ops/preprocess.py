"""Depth-map preprocessing (counterpart of surfelmapping_tpu/ops/preprocess.py).

Reference pass order per frame (src/SurfelMapping.cpp:133-158,253-365):
  1. metricize   (depth_metric.frag)  u16 mm -> f32 m, clip + stereo border
  2. support     (depth_filter.frag, diffThresh=0.15)
  3. smooth      (depth_smooth.frag, 13x13 same-class Gaussian)
  4. support     (depth_filter.frag, diffThresh=0.1)
  5. movings     (depth_movings.frag) cull moving-object pixels vs last frame

The functions here are the plain PyTorch versions, one tensor op per tap.
On the card, :func:`preprocess_frame` runs passes 2-4 as one hand-written
kernel (ops/preprocess_stencil.py); on the CPU it runs these.

Convention: pixel (row j, col i) has continuous coordinates x = i + 0.5,
y = j + 0.5 (src/GlobalModel.cpp:66-73, src/FeedbackBuffer.cpp:43-59).
"""

from __future__ import annotations

import math

import torch

from ..config import CameraIntrinsics, PipelineParams


def _shift(img: torch.Tensor, dy: int, dx: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Shifted view of a 2D image: out[j,i] = img[j+dy, i+dx].

    Returns (shifted, inbounds_mask).  Out-of-bounds reads return the
    clamped-edge value (GL_CLAMP_TO_EDGE) and the mask records whether the
    source pixel was in-bounds, so callers can reproduce the reference's
    explicit boundary ``continue``s."""
    H, W = img.shape
    rows = torch.arange(H, device=img.device) + dy
    cols = torch.arange(W, device=img.device) + dx
    shifted = img.index_select(0, rows.clamp(0, H - 1)).index_select(1, cols.clamp(0, W - 1))
    inb = ((rows >= 0) & (rows < H))[:, None] & ((cols >= 0) & (cols < W))[None, :]
    return shifted, inb


def metricize_depth(
    depth_raw_mm: torch.Tensor, cam: CameraIntrinsics, params: PipelineParams
) -> torch.Tensor:
    """u16 millimetre depth -> metric f32, zeroing out-of-range values and the
    left stereo margin (depth_metric.frag; uniforms src/SurfelMapping.cpp:254-266)."""
    d = depth_raw_mm.to(torch.float32)
    lo = params.near_clip * 1000.0
    hi = (params.far_clip - 0.001) * 1000.0
    valid = (d > lo) & (d < hi)
    metric = torch.where(valid, d / 1000.0, 0.0)
    cols = torch.arange(cam.width, dtype=torch.float32, device=d.device) + 0.5
    in_border = cols < params.stereo_border
    return torch.where(in_border[None, :], 0.0, metric)


def support_filter(
    depth: torch.Tensor,
    semantic: torch.Tensor,
    params: PipelineParams,
    diff_thresh: float,
) -> torch.Tensor:
    """Keep a depth pixel only if >= 7 of its 8 neighbours are within
    ``diff_thresh`` and share its semantic class; zero sky/person/rider and
    out-of-range depths (depth_filter.frag)."""
    p = params
    removed = (
        (depth <= p.near_clip)
        | (depth >= p.filter_cap_depth)
        | (semantic == p.sky_class)
        | (semantic == p.person_class)
        | (semantic == p.rider_class)
    )
    support = torch.zeros(depth.shape, dtype=torch.int32, device=depth.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            dk, inb = _shift(depth, dy, dx)
            ck, _ = _shift(semantic, dy, dx)
            ok = inb & (torch.abs(dk - depth) < diff_thresh) & (ck == semantic)
            support = support + ok.to(torch.int32)
    keep = (~removed) & (support >= p.filter_support_min)
    return torch.where(keep, depth, 0.0)


def smooth_weight(dy: int, dx: int, params: PipelineParams) -> float:
    """Tap weight exp(-(dy^2+dx^2) * sigPix), taken in double precision and
    used as float32 (the sigma quirk: PipelineParams.smooth_sig_pix)."""
    return math.exp(-((dy * dy + dx * dx) * params.smooth_sig_pix))


def smooth_depth(
    depth: torch.Tensor,
    semantic: torch.Tensor,
    cam: CameraIntrinsics,
    params: PipelineParams,
) -> torch.Tensor:
    """13x13 Gaussian smoothing restricted to same-class, in-range neighbours
    right of the stereo border; sky and out-of-range centers are zeroed
    (depth_smooth.frag).  Taps sum dy outer, dx inner."""
    p = params
    removed = (
        (depth <= p.near_clip)
        | (depth >= p.filter_cap_depth)
        | (semantic == p.sky_class)
    )
    cols = torch.arange(cam.width, dtype=torch.float32, device=depth.device) + 0.5
    # neighbour texX < stereoBorder/cols is skipped (depth_smooth.frag:51)
    col_ok = (cols >= p.stereo_border)[None, :].expand(depth.shape).contiguous()
    R = p.smooth_radius
    num = torch.zeros(depth.shape, dtype=torch.float32, device=depth.device)
    den = torch.zeros_like(num)
    cnt = torch.zeros(depth.shape, dtype=torch.int32, device=depth.device)
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            dk, inb = _shift(depth, dy, dx)
            ck, _ = _shift(semantic, dy, dx)
            cb, _ = _shift(col_ok, dy, dx)
            ok = (
                inb
                & cb
                & (dk > p.near_clip)
                & (dk < p.filter_cap_depth)
                & (ck == semantic)
            )
            w = smooth_weight(dy, dx, p)
            okf = ok.to(torch.float32)
            num = num + okf * dk * w
            den = den + okf * w
            cnt = cnt + ok.to(torch.int32)
    smoothed = torch.where(cnt > 0, num / torch.clamp(den, min=1e-30), 0.0)
    return torch.where(removed, 0.0, smoothed)


def stencil_chain_plain(
    metric: torch.Tensor,
    semantic: torch.Tensor,
    cam: CameraIntrinsics,
    params: PipelineParams,
) -> torch.Tensor:
    """support(t1) -> smooth -> support(t2): the plain version of the
    preprocess stencil kernel."""
    filtered = support_filter(metric, semantic, params, params.filter_diff_thresh_1)
    smoothed = smooth_depth(filtered, semantic, cam, params)
    return support_filter(smoothed, semantic, params, params.filter_diff_thresh_2)


def remove_movings(
    depth: torch.Tensor,
    semantic: torch.Tensor,
    depth_last: torch.Tensor,
    T_curr_to_last: torch.Tensor,
    cam: CameraIntrinsics,
    params: PipelineParams,
) -> torch.Tensor:
    """Cull pixels of movable classes whose reprojection into the previous
    frame disagrees with the previous depth by > move_thresh
    (depth_movings.frag; uniforms src/SurfelMapping.cpp:336-365)."""
    p = params
    H, W = depth.shape
    x = (torch.arange(W, dtype=torch.float32, device=depth.device) + 0.5)[None, :].expand(H, W)
    y = (torch.arange(H, dtype=torch.float32, device=depth.device) + 0.5)[:, None].expand(H, W)

    movable = (semantic >= p.movable_class_lo) & (semantic <= p.movable_class_hi)
    border_or_invalid = (x < p.stereo_border) | (depth <= p.near_clip)

    # reproject into the last frame
    X = (x - cam.cx) * depth / cam.fx
    Y = (y - cam.cy) * depth / cam.fy
    R = T_curr_to_last[:3, :3]
    t = T_curr_to_last[:3, 3]
    Xl = R[0, 0] * X + R[0, 1] * Y + R[0, 2] * depth + t[0]
    Yl = R[1, 0] * X + R[1, 1] * Y + R[1, 2] * depth + t[1]
    Zl = R[2, 0] * X + R[2, 1] * Y + R[2, 2] * depth + t[2]
    safe_z = torch.where(torch.abs(Zl) < 1e-12, 1e-12, Zl)
    ul = cam.fx * Xl / safe_z + cam.cx
    vl = cam.fy * Yl / safe_z + cam.cy

    out_of_last = (
        (Zl <= p.near_clip)
        | (Zl >= p.filter_cap_depth)
        | (ul < p.stereo_border)
        | (ul > W)
        | (vl < 0)
        | (vl > H)
    )

    # nearest-texel lookup of last depth at (ul, vl)
    ui = torch.clamp(torch.floor(ul).to(torch.int64), 0, W - 1)
    vi = torch.clamp(torch.floor(vl).to(torch.int64), 0, H - 1)
    d_last = depth_last[vi, ui]

    moving = torch.abs(Zl - d_last) > p.move_thresh

    cull = movable & (~border_or_invalid) & (~out_of_last) & moving
    return torch.where(cull, 0.0, depth)


def preprocess_frame(
    depth_raw_mm: torch.Tensor,
    semantic: torch.Tensor,
    cam: CameraIntrinsics,
    params: PipelineParams,
) -> torch.Tensor:
    """Stages 1-4 (everything except movings, which needs the last frame).

    Returns the DEPTH_FILTERED image after the second support pass; it both
    becomes the next frame's LAST image (src/SurfelMapping.cpp:244) and,
    after :func:`remove_movings`, the fusion depth.  Stages 2-4 run in the
    stencil kernel on the card and as :func:`stencil_chain_plain` on the CPU.
    """
    from .preprocess_stencil import preprocess_stencil

    metric = metricize_depth(depth_raw_mm, cam, params)
    return preprocess_stencil(metric, semantic, cam, params)
