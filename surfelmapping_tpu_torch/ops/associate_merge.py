"""The association stage in one CUDA kernel: the wrapper of
``csrc/associate_merge.cu``.

The kernel computes :func:`ops.active.associate_active_plain` (the
checkerboard candidates, the index-window search against the active table,
the merge and the world transform) in one launch, bit for bit.  It replaces
no TPU kernel: the JAX stage is plain XLA.  ``ops.active.associate_active``
calls :func:`associate_merge` for CUDA tensors and the plain version for CPU
tensors; this wrapper raises on anything else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..config import CameraIntrinsics, PipelineParams
from ..utils import tracing
from .cuda_lib import CudaKernel, ptr, require_cuda, stream_handle
from .frame_surfels import SQRT2

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "associate_merge", "associate_merge.cu",
    {"associate_merge_args_size": (_I, []), "associate_merge_launch": (_I, [_P, _P])},
    # every product and sum must round as the plain version's separate ops do
    extra_flags=("-fmad=false",),
)

_POINTERS = ("depth", "rgb", "sem", "index", "x", "y", "z", "conf", "colorsem", "nx", "ny",
             "nz", "radius", "pose", "t_inv", "out", "mark")
_FLOATS = ("fx", "fy", "cx", "cy", "mean_focal", "sqrt2", "near_clip", "far_clip", "conf_new",
           "fuse_thresh", "merge_normal_angle", "merge_radius_factor", "time")


class _Args(ctypes.Structure):
    """The kernel's ``AssociateMergeArgs``, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS] + [("A", ctypes.c_longlong)]
                + [(n, ctypes.c_int) for n in ("H", "W", "F")]
                + [(n, ctypes.c_float) for n in _FLOATS])


# the table's columns the kernel reads, in the kernel's order, with dtypes
_TABLE = (("x", torch.float32), ("y", torch.float32), ("z", torch.float32),
          ("conf", torch.float32), ("colorsem", torch.int32), ("nx", torch.float32),
          ("ny", torch.float32), ("nz", torch.float32), ("radius", torch.float32))
# AssocFlat's columns in the kernel's output rows (colorsem holds int32 bits)
OUT_COLS = ("x", "y", "z", "conf", "colorsem", "init_t", "last_t", "nx", "ny", "nz", "radius")


@functools.cache
def _lib():
    lib = KERNEL.lib()
    if lib.associate_merge_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError("associate_merge: the kernel's Args and the wrapper's differ")
    return lib


def associate_merge(depth: torch.Tensor, rgb: torch.Tensor, semantic: torch.Tensor,
                    index_image: torch.Tensor, at, pose: torch.Tensor, T_inv: torch.Tensor,
                    time: float, cam: CameraIntrinsics, params: PipelineParams,
                    fuse_thresh: float) -> dict[str, torch.Tensor]:
    """``associate_active_plain``'s columns from one kernel launch: a dict
    of AssocFlat's fields, each flat [H*W/2] in lattice order.  ``at`` is
    the ActiveTable; depth f32[H,W], rgb f32[H,W,3], semantic i32[H,W],
    index_image i64[H*F, W*F] (active slots, -1 empty), pose and T_inv
    f32[4,4], all on one card and contiguous."""
    H, W, F = cam.height, cam.width, params.index_factor
    if H % 2 or W % 2:
        raise ValueError(f"associate_merge needs even dims, got {H}x{W}")
    A = at.x.shape[0]
    if A == 0:
        raise ValueError("associate_merge: the active table is empty")
    dev = depth.device
    checks = [(depth, "depth", torch.float32, (H, W)), (rgb, "rgb", torch.float32, (H, W, 3)),
              (semantic, "semantic", torch.int32, (H, W)),
              (index_image, "index_image", torch.int64, (H * F, W * F)),
              (pose, "pose", torch.float32, (4, 4)), (T_inv, "T_inv", torch.float32, (4, 4))]
    checks += [(getattr(at, c), c, dt, (A,)) for c, dt in _TABLE]
    for t, name, dtype, shape in checks:
        require_cuda(t, name, dtype, shape)
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, depth on {dev}")
    N = H * W // 2
    out = torch.empty((len(OUT_COLS), N), dtype=torch.int32, device=dev)
    mark = torch.empty(N, dtype=torch.int64, device=dev)
    p = params
    args = _Args(ptr(depth), ptr(rgb), ptr(semantic), ptr(index_image),
                 *(ptr(getattr(at, c)) for c, _ in _TABLE), ptr(pose), ptr(T_inv), ptr(out),
                 ptr(mark), A, H, W, F, cam.fx, cam.fy, cam.cx, cam.cy,
                 (cam.fx + cam.fy) / 2.0, SQRT2, p.near_clip, p.far_clip, p.conf_new,
                 fuse_thresh, p.merge_normal_angle, p.merge_radius_factor, time)
    with torch.cuda.device(dev):
        rc = _lib().associate_merge_launch(ctypes.byref(args), stream_handle(dev))
    KERNEL.check(rc)
    KERNEL.launches += 1
    tracing.count("fuse.associate_kernel")
    cols = dict(zip(OUT_COLS, out.view(torch.float32).unbind(0)))
    cols["colorsem"] = out[OUT_COLS.index("colorsem")]
    return dict(cols, mark=mark)
