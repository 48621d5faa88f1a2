"""Scatter-argmin z-buffer behind the index map and the fast renderer: the
CUDA kernel's wrapper and its plain PyTorch version (counterpart of
surfelmapping_tpu/ops/pallas_zbuf.py:zbuffer_argmin).

Given A candidates, each with a monotone int32 depth key (INT32_MAX =
invalid) and a flat target pixel in [0, P] (P = discard), find per pixel the
minimum key and the minimum candidate index among the key minimisers.
Empty pixels return (INT32_MAX, INT32_MAX).

The result lives in one int64[P] buffer of packed words (key << 32) | id
(:func:`zbuffer_argmin_packed`); :func:`zbuffer_argmin` returns its key and
id planes as strided int32 views (:func:`key_id_views`).

Which candidates exist is given by ``valid``:
  * ``None``: all A;
  * a 0-d integer tensor ``n_valid``: the first n_valid, as the JAX kernel's
    ``n_valid`` (the main paths pass the count they already hold, so the
    card reads it without a reduction);
  * a bool[A] prefix mask ``slot_valid`` (tests and chip_smoke): the card
    counts it with one reduction; the CPU checks that it is a prefix.

A CPU tensor goes to :func:`zbuffer_argmin_plain`; a CUDA tensor goes to the
kernel in ``csrc/zbuffer_argmin.cu`` (or the wrapper raises).
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_lib import CudaKernel, ptr, require_cuda, stream_handle
from .index_map import INT32_MAX

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "zbuffer_argmin", "zbuffer_argmin.cu",
    {"zbuffer_argmin_launch": (_I, [_P, _P, _P, _I, _I, _P, _P])},
)


def _slot_mask(valid: torch.Tensor | None, A: int, device) -> torch.Tensor:
    """``valid`` in any of its three forms as a bool[A] mask."""
    if valid is None:
        return torch.ones(A, dtype=torch.bool, device=device)
    if valid.dim() == 0:
        return torch.arange(A, device=device) < valid.to(device)
    return valid


def zbuffer_argmin_plain(
    zkey: torch.Tensor, fpix: torch.Tensor, num_pix: int,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The 3-op semantics of pallas_zbuf.py:93-102 (scatter-min key, winner
    gather, scatter-min index) on a P+1 buffer whose spare slot P takes the
    discarded candidates.  Candidates outside ``valid`` do not exist.
    Returns (zbuf i32[P], idbuf i32[P])."""
    P = num_pix
    key = torch.where(_slot_mask(valid, zkey.shape[0], zkey.device), zkey, INT32_MAX)
    pix = torch.where((fpix >= 0) & (fpix < P), fpix, P).long()
    zbuf = torch.full((P + 1,), INT32_MAX, dtype=torch.int32, device=zkey.device)
    zbuf.scatter_reduce_(0, pix, key, "amin")
    win = (key != INT32_MAX) & (key == zbuf[pix])
    ids = torch.arange(zkey.shape[0], dtype=torch.int32, device=zkey.device)
    idbuf = torch.full((P + 1,), INT32_MAX, dtype=torch.int32, device=zkey.device)
    idbuf.scatter_reduce_(0, torch.where(win, pix, P), ids, "amin")
    return zbuf[:P], idbuf[:P]


def key_id_views(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(key, id) int32 planes of int64 words (key << 32) | id, as strided
    views (the words are little-endian: the id is the low half)."""
    halves = packed.view(torch.int32).view(-1, 2)
    return halves[:, 1], halves[:, 0]


def check_valid_prefix(slot_valid: torch.Tensor) -> None:
    """The kernel reads only the first n_valid = sum(slot_valid) candidates,
    so the valid slots must form a prefix (slot_valid non-increasing)."""
    if bool((slot_valid[1:] & ~slot_valid[:-1]).any()):
        raise ValueError("zbuffer_argmin: slot_valid is not a prefix — valid "
                         "candidates must come first")


def zbuffer_argmin_packed(
    zkey: torch.Tensor, fpix: torch.Tensor, num_pix: int,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """The z-buffer as int64[P] packed words (key << 32) | id; an empty
    pixel is (INT32_MAX << 32) | INT32_MAX."""
    if zkey.device.type == "cpu":
        if valid is not None and valid.dim() == 1:
            check_valid_prefix(valid)
        zbuf, idbuf = zbuffer_argmin_plain(zkey, fpix, num_pix, valid)
        return (zbuf.long() << 32) | idbuf.long()
    A = zkey.shape[0]
    if A >= 2**31 or num_pix >= 2**31:
        raise ValueError(f"zbuffer_argmin: {A} candidates, {num_pix} pixels; both "
                         "must fit in int32")
    require_cuda(zkey, "zkey", torch.int32, (A,))
    require_cuda(fpix, "fpix", torch.int32, (A,))
    dev = zkey.device
    if fpix.device != dev:
        raise ValueError(f"fpix is on {fpix.device}, zkey on {dev}")
    n_valid = None
    if valid is not None:
        if valid.dim() == 1:
            require_cuda(valid, "slot_valid", torch.bool, (A,))
            valid = valid.sum(dtype=torch.int32)
        require_cuda(valid, "n_valid", torch.int32, ())
        if valid.device != dev:
            raise ValueError(f"n_valid is on {valid.device}, zkey on {dev}")
        n_valid = valid
    packed = torch.empty(num_pix, dtype=torch.int64, device=dev)
    lib = KERNEL.lib()
    with torch.cuda.device(dev):
        rc = lib.zbuffer_argmin_launch(
            ptr(zkey), ptr(fpix), None if n_valid is None else ptr(n_valid), A, num_pix,
            ptr(packed), stream_handle(dev),
        )
    KERNEL.check(rc)
    KERNEL.launches += 1
    return packed


def zbuffer_argmin(
    zkey: torch.Tensor, fpix: torch.Tensor, num_pix: int,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (zbuf i32[P], idbuf i32[P]), strided views of the packed
    words of :func:`zbuffer_argmin_packed`."""
    return key_id_views(zbuffer_argmin_packed(zkey, fpix, num_pix, valid))
