"""Scatter-argmin z-buffer behind the index map: the CUDA kernel's wrapper
and its plain PyTorch version (counterpart of
surfelmapping_tpu/ops/pallas_zbuf.py:zbuffer_argmin_auto).

Given A candidates, each with a monotone int32 depth key (INT32_MAX =
invalid) and a flat target pixel in [0, P] (P = discard), find per pixel the
minimum key and the minimum candidate index among the key minimisers.
Empty pixels return (INT32_MAX, INT32_MAX).

A CPU tensor goes to :func:`zbuffer_argmin_plain`; a CUDA tensor goes to the
kernel in ``csrc/zbuffer_argmin.cu`` (or the wrapper raises).
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_lib import CudaKernel, ptr, require_cuda, stream_handle
from .index_map import INT32_MAX

_P = ctypes.c_void_p
KERNEL = CudaKernel(
    "zbuffer_argmin", "zbuffer_argmin.cu",
    {"zbuffer_argmin_launch": (ctypes.c_int, [_P, _P, _P, ctypes.c_int64,
                                              ctypes.c_int64, _P, _P, _P, _P])},
)


def zbuffer_argmin_plain(
    zkey: torch.Tensor, fpix: torch.Tensor, num_pix: int, slot_valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The 3-op semantics of pallas_zbuf.py:93-102 (scatter-min key, winner
    gather, scatter-min index) on a P+1 buffer whose spare slot P takes the
    discarded candidates.  Candidates outside ``slot_valid`` do not exist."""
    P = num_pix
    key = torch.where(slot_valid, zkey, INT32_MAX)
    pix = torch.where((fpix >= 0) & (fpix < P), fpix, P).long()
    zbuf = torch.full((P + 1,), INT32_MAX, dtype=torch.int32, device=zkey.device)
    zbuf.scatter_reduce_(0, pix, key, "amin")
    win = (key != INT32_MAX) & (key == zbuf[pix])
    ids = torch.arange(zkey.shape[0], dtype=torch.int32, device=zkey.device)
    idbuf = torch.full((P + 1,), INT32_MAX, dtype=torch.int32, device=zkey.device)
    idbuf.scatter_reduce_(0, torch.where(win, pix, P), ids, "amin")
    return zbuf[:P], idbuf[:P]


def check_valid_prefix(slot_valid: torch.Tensor) -> None:
    """The kernel reads only the first n_valid = sum(slot_valid) candidates,
    so the valid slots must form a prefix (slot_valid non-increasing)."""
    if bool((slot_valid[1:] & ~slot_valid[:-1]).any()):
        raise ValueError("zbuffer_argmin: slot_valid is not a prefix — valid "
                         "candidates must come first")


def zbuffer_argmin(
    zkey: torch.Tensor, fpix: torch.Tensor, num_pix: int, slot_valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (zbuf i32[P], idbuf i32[P]).

    ``slot_valid`` (bool[A]) must be a prefix: the kernel streams only the
    first sum(slot_valid) candidates, a bound it reads on the device."""
    if zkey.device.type == "cpu":
        check_valid_prefix(slot_valid)
        return zbuffer_argmin_plain(zkey, fpix, num_pix, slot_valid)
    A = zkey.shape[0]
    require_cuda(zkey, "zkey", torch.int32, (A,))
    require_cuda(fpix, "fpix", torch.int32, (A,))
    require_cuda(slot_valid, "slot_valid", torch.bool, (A,))
    dev = zkey.device
    n_valid = slot_valid.sum(dtype=torch.int32)
    packed = torch.empty(num_pix, dtype=torch.int64, device=dev)
    zbuf = torch.empty(num_pix, dtype=torch.int32, device=dev)
    idbuf = torch.empty(num_pix, dtype=torch.int32, device=dev)
    lib = KERNEL.lib()
    with torch.cuda.device(dev):
        rc = lib.zbuffer_argmin_launch(
            ptr(zkey), ptr(fpix), ptr(n_valid), A, num_pix,
            ptr(packed), ptr(zbuf), ptr(idbuf), stream_handle(dev),
        )
    KERNEL.check(rc)
    KERNEL.launches += 1
    return zbuf, idbuf
