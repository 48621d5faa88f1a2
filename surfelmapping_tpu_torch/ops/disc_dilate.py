"""The fast renderer's dilation in one CUDA kernel: the wrapper of
``csrc/disc_dilate.cu``, and the disc stamps that the kernel and the plain
loop (:func:`ops.splat.dilate_plain`) both read.

The kernel computes ``dilate_plain`` (per pixel, the smallest packed word
(key << 32) | id among the centres whose class disc covers it) in one
launch, bit for bit.  It replaces no TPU kernel: the JAX dilation is plain
XLA.  ``ops.splat._dilate`` calls :func:`disc_dilate` for CUDA tensors and
the plain loop for CPU tensors; this wrapper raises on anything else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils import tracing
from .cuda_lib import CudaKernel, ptr, require_cuda, stream_handle

MAX_CLASSES, MAX_ROWS = 8, 1024  # the kernel's DiscTable arrays

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "disc_dilate", "disc_dilate.cu",
    {"disc_dilate_table_size": (_I, []), "disc_dilate_max_radius": (_I, []),
     "disc_dilate_launch": (_I, [_P, _P, _P, _I, _I, _P])},
)


def disc_stamps(R: int) -> tuple[tuple[int, int], ...]:
    """The disc stamp of radius ``R``: the offsets (dj, di) with
    dj^2 + di^2 <= (R + 0.5)^2, row by row (9, 21, 37, 97 for R = 1, 2, 3,
    5).  A stamp (dj, di) takes the centre at (y - dj, x - di) into pixel
    (y, x)."""
    return tuple((dj, di) for dj in range(-R, R + 1) for di in range(-R, R + 1)
                 if dj * dj + di * di <= (R + 0.5) ** 2)


class _Table(ctypes.Structure):
    """The kernel's ``DiscTable``, field for field."""

    _fields_ = [("nc", ctypes.c_int), ("radius", ctypes.c_int * MAX_CLASSES),
                ("row0", ctypes.c_int * MAX_CLASSES), ("lo", ctypes.c_byte * MAX_ROWS),
                ("hi", ctypes.c_byte * MAX_ROWS)]


@functools.cache
def stamp_table(classes: tuple[int, ...]) -> _Table:
    """The classes' :func:`disc_stamps` as the kernel reads them: for each
    class R, its rows dj = -R..R, each the run of offsets [lo, hi]."""
    if not 1 <= len(classes) <= MAX_CLASSES:
        raise ValueError(f"disc_dilate takes 1 to {MAX_CLASSES} classes, got {classes}")
    if any(not isinstance(R, int) or not 0 <= R <= 127 for R in classes):
        raise ValueError(f"disc_dilate takes radii 0 to 127, got {classes}")
    if sum(2 * R + 1 for R in classes) > MAX_ROWS:
        raise ValueError(f"disc_dilate takes at most {MAX_ROWS} stamp rows, got {classes}")
    t = _Table(nc=len(classes))
    row = 0
    for c, R in enumerate(classes):
        t.radius[c], t.row0[c] = R, row
        stamps = disc_stamps(R)
        for dj in range(-R, R + 1):
            dis = [di for sj, di in stamps if sj == dj]
            if dis != list(range(dis[0], dis[-1] + 1)):
                raise ValueError(f"disc_stamps({R}) row {dj} is not one run")
            t.lo[row], t.hi[row] = dis[0], dis[-1]
            row += 1
    return t


@functools.cache
def _lib():
    lib = KERNEL.lib()
    if lib.disc_dilate_table_size() != ctypes.sizeof(_Table):
        raise RuntimeError("disc_dilate: the kernel's DiscTable and the wrapper's differ")
    return lib


@functools.cache
def max_radius(device: torch.device) -> int:
    """The largest class radius whose tile and halo fit ``device``'s shared
    memory."""
    with torch.cuda.device(device):
        return _lib().disc_dilate_max_radius()


def disc_dilate(packed: torch.Tensor, classes: tuple[int, ...]) -> torch.Tensor:
    """``dilate_plain`` from one kernel launch: ``packed`` i64[NC, H, W]
    (K1's class buffers, NC = len(classes)), contiguous on a card; returns a
    new i64[H, W] plane of the merged words."""
    if packed.dim() != 3:
        raise ValueError(f"packed: expected shape (NC, H, W), got {tuple(packed.shape)}")
    _, H, W = packed.shape
    require_cuda(packed, "packed", torch.int64, (len(classes), H, W))
    table = stamp_table(tuple(classes))
    dev = packed.device
    if max(classes) > max_radius(dev):
        raise ValueError(f"disc_dilate: radius {max(classes)} > {max_radius(dev)}, "
                         "the largest whose halo fits the card's shared memory")
    out = torch.empty((H, W), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().disc_dilate_launch(ctypes.byref(table), ptr(packed), ptr(out), H, W,
                                       stream_handle(dev))
    KERNEL.check(rc)
    KERNEL.launches += 1
    tracing.count("render.dilate_kernel")
    return out
