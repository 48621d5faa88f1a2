"""The fused preprocess stencil: the CUDA kernel's wrapper (counterpart of
surfelmapping_tpu/ops/pallas_preprocess.py:preprocess_stencil_tpu).

support filter (t1) -> gated smooth -> support filter (t2) on the
metricized depth.  A CPU tensor goes to the plain version
(ops/preprocess.py:stencil_chain_plain); a CUDA tensor goes to the kernel in
``csrc/preprocess_stencil.cu`` (or the wrapper raises).  The kernel takes
the tap weights as launch parameters.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import CameraIntrinsics, PipelineParams
from .cuda_lib import CudaKernel, ptr, require_cuda, stream_handle
from .preprocess import smooth_weight, stencil_chain_plain

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
KERNEL = CudaKernel(
    "preprocess_stencil", "preprocess_stencil.cu",
    {
        "preprocess_stencil_max_radius": (_I, []),
        "preprocess_stencil_launch": (
            _I, [_P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _I, _I, _I, _I, _I, _P, _P]
        ),
        "preprocess_stencil_occupancy": (_I, [_I, _IP, _IP, _IP, _IP]),
    },
    # the smooth's multiply-adds must round like the plain version's
    extra_flags=("-fmad=false",),
)


def _weight_table(params: PipelineParams, r_max: int) -> np.ndarray:
    """f32[(2*r_max+1)^2] tap weights, dy outer (zero beyond the radius)."""
    n = 2 * r_max + 1
    w = np.zeros((n, n), np.float32)
    R = params.smooth_radius
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            w[dy + r_max, dx + r_max] = smooth_weight(dy, dx, params)
    return w.reshape(-1)


@functools.lru_cache(maxsize=8)
def _launch_args(params: PipelineParams) -> tuple[np.ndarray, tuple]:
    """The launch's arguments that depend on ``params`` alone: the weight
    table (kept alive here) and the thresholds, classes, radius and the
    table's address, made once per ``params``."""
    r_max = KERNEL.lib().preprocess_stencil_max_radius()
    if params.smooth_radius > r_max:
        raise ValueError(f"smooth_radius {params.smooth_radius} > {r_max}, "
                         "the kernel's largest radius")
    w = _weight_table(params, r_max)
    p = params
    return w, (p.near_clip, p.filter_cap_depth, p.stereo_border,
               p.filter_diff_thresh_1, p.filter_diff_thresh_2, p.filter_support_min,
               p.smooth_radius, p.sky_class, p.person_class, p.rider_class, w.ctypes.data)


def occupancy(radius: int) -> dict:
    """The radius-``radius`` kernel's CTAs per SM (from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), threads per CTA and
    output tile."""
    vals = [ctypes.c_int() for _ in range(4)]
    KERNEL.check(KERNEL.lib().preprocess_stencil_occupancy(
        radius, *(ctypes.byref(v) for v in vals)))
    blocks, threads, tile_h, tile_w = (v.value for v in vals)
    return dict(ctas_per_sm=blocks, threads_per_cta=threads, tile=[tile_h, tile_w])


def preprocess_stencil(
    metric: torch.Tensor,
    semantic: torch.Tensor,
    cam: CameraIntrinsics,
    params: PipelineParams,
) -> torch.Tensor:
    """support(t1) -> gated smooth -> support(t2) on ``metric`` f32[H,W]
    with classes ``semantic`` i32[H,W]; returns the DEPTH_FILTERED f32[H,W]."""
    if metric.device.type == "cpu":
        return stencil_chain_plain(metric, semantic, cam, params)
    H, W = cam.height, cam.width
    require_cuda(metric, "metric", torch.float32, (H, W))
    require_cuda(semantic, "semantic", torch.int32, (H, W))
    if semantic.device != metric.device:
        raise ValueError(f"semantic is on {semantic.device}, metric on {metric.device}")
    _, args = _launch_args(params)
    dev = metric.device
    out = torch.empty_like(metric)
    with torch.cuda.device(dev):
        rc = KERNEL.lib().preprocess_stencil_launch(
            ptr(metric), ptr(semantic), ptr(out), H, W, *args, stream_handle(dev))
    KERNEL.check(rc)
    KERNEL.launches += 1
    return out
