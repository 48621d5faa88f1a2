"""The render cull's visibility pass in one CUDA kernel: the wrapper of
``csrc/visible_blocks.cu``, and the plain form it is held to.

A block of the map is visible from a view if one of its slots is live
(conf > 0), lies between the depth limits (1 < z < max_depth) and projects
within ``margin`` px of the image.  :func:`visible_blocks_plain` computes
that mask as eager PyTorch ops over every slot; the kernel computes it in
one launch, bit for bit.  It replaces no TPU kernel: the JAX cull is plain
XLA.  ``ops.splat.cull_for_render`` calls :func:`visible_blocks` for CUDA
tensors and the plain form for CPU tensors; this wrapper raises on anything
else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..config import CameraIntrinsics
from ..utils import tracing
from .active import block_any
from .cuda_lib import CudaKernel, ptr, require_cuda, stream_handle
from .transforms import project_planar

TILE = 1024  # the kernel's kTile: the slots one pass of a CTA covers

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "visible_blocks", "visible_blocks.cu",
    {"visible_blocks_args_size": (_I, []), "visible_blocks_tile": (_I, []),
     "visible_blocks_launch": (_I, [_P, _P])},
    # every product and sum must round as the plain form's separate ops do
    extra_flags=("-fmad=false",),
)

_COLUMNS = ("px", "py", "pz", "conf")
_FLOATS = ("fx", "fy", "cx", "cy", "max_depth", "u_lo", "u_hi", "v_lo", "v_hi")


class _Args(ctypes.Structure):
    """The kernel's ``VisibleBlocksArgs``, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _COLUMNS + ("t_inv", "out")]
                + [("n", ctypes.c_longlong), ("block", ctypes.c_int), ("vec", ctypes.c_int)]
                + [(n, ctypes.c_float) for n in _FLOATS])


def _takes_block_size(block_size: int) -> bool:
    """Whether the kernel takes blocks of ``block_size`` slots: whole
    multiples of its tile, or divisors of the tile that 4 divides."""
    if block_size >= TILE:
        return block_size % TILE == 0
    return block_size >= 4 and block_size % 4 == 0 and TILE % block_size == 0


def visible_blocks_plain(px: torch.Tensor, py: torch.Tensor, pz: torch.Tensor,
                         conf: torch.Tensor, T_inv: torch.Tensor, cam: CameraIntrinsics,
                         block_size: int, max_depth: float, margin: float) -> torch.Tensor:
    """The cull's gate over every slot (f32[G * block_size] columns, T_inv
    world to camera), reduced per block: bool[G]."""
    _, _, z, u, v = project_planar(T_inv, px, py, pz, cam)
    vis = (
        (conf > 0.0)
        & (z > 1.0)
        & (z < max_depth)
        & (u >= -margin)
        & (u <= cam.width + margin)
        & (v >= -margin)
        & (v <= cam.height + margin)
    )
    return block_any(vis, block_size)


@functools.cache
def _lib():
    lib = KERNEL.lib()
    if lib.visible_blocks_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError("visible_blocks: the kernel's Args and the wrapper's differ")
    if lib.visible_blocks_tile() != TILE:
        raise RuntimeError("visible_blocks: the kernel's tile and the wrapper's differ")
    return lib


def visible_blocks(px: torch.Tensor, py: torch.Tensor, pz: torch.Tensor, conf: torch.Tensor,
                   T_inv: torch.Tensor, cam: CameraIntrinsics, block_size: int,
                   max_depth: float, margin: float) -> torch.Tensor:
    """:func:`visible_blocks_plain` from one kernel launch: the four columns
    f32[G * block_size] and T_inv f32[4, 4] contiguous on one card; returns
    a new bool[G]."""
    n = px.shape[0] if px.dim() == 1 else -1
    cols = (px, py, pz, conf)
    for t, name in zip(cols, _COLUMNS):
        require_cuda(t, name, torch.float32, (n,))
    require_cuda(T_inv, "T_inv", torch.float32, (4, 4))
    dev = px.device
    for t, name in zip(cols[1:] + (T_inv,), _COLUMNS[1:] + ("T_inv",)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, px on {dev}")
    if not _takes_block_size(block_size):
        raise ValueError(f"visible_blocks: block size {block_size} is neither a multiple of "
                         f"{TILE} nor a divisor of it that 4 divides")
    if n == 0 or n % block_size:
        raise ValueError(f"visible_blocks: {n} slots are not whole blocks of {block_size}")
    out = torch.empty(n // block_size, dtype=torch.bool, device=dev)
    vec = all(t.data_ptr() % 16 == 0 for t in cols)
    args = _Args(*(ptr(t) for t in cols), ptr(T_inv), ptr(out), n, block_size, int(vec),
                 cam.fx, cam.fy, cam.cx, cam.cy, max_depth, -margin, cam.width + margin,
                 -margin, cam.height + margin)
    with torch.cuda.device(dev):
        rc = _lib().visible_blocks_launch(ctypes.byref(args), stream_handle(dev))
    KERNEL.check(rc)
    KERNEL.launches += 1
    tracing.count("render.cull_kernel")
    return out
