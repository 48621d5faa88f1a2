"""The scatter-argmin z-buffer in its plain three-op form (frozen from
``surfelmapping_tpu_torch/ops/zbuf.py:zbuffer_argmin_plain`` at commit
dd68e64): per pixel the minimum depth key, and among the candidates that
hold it the smallest index.  Empty pixels hold (INT32_MAX, INT32_MAX); a
pixel outside [0, P) is discarded.  Only the first ``n_valid`` candidates
exist, where given."""

from __future__ import annotations

import torch

from .index_map import INT32_MAX


def zbuffer_argmin(zkey: torch.Tensor, fpix: torch.Tensor, num_pix: int,
                   n_valid: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (key i32[P], id i32[P])."""
    P = num_pix
    dev = zkey.device
    key = zkey
    if n_valid is not None:
        key = torch.where(torch.arange(zkey.shape[0], device=dev) < n_valid, zkey, INT32_MAX)
    pix = torch.where((fpix >= 0) & (fpix < P), fpix, P).long()
    zbuf = torch.full((P + 1,), INT32_MAX, dtype=torch.int32, device=dev)
    zbuf.scatter_reduce_(0, pix, key, "amin")
    win = (key != INT32_MAX) & (key == zbuf[pix])
    ids = torch.arange(zkey.shape[0], dtype=torch.int32, device=dev)
    idbuf = torch.full((P + 1,), INT32_MAX, dtype=torch.int32, device=dev)
    idbuf.scatter_reduce_(0, torch.where(win, pix, P), ids, "amin")
    return zbuf[:P], idbuf[:P]


def zbuffer_argmin_packed(zkey: torch.Tensor, fpix: torch.Tensor, num_pix: int,
                          n_valid: torch.Tensor | None = None) -> torch.Tensor:
    """The z-buffer as int64 words (key << 32) | id."""
    zbuf, idbuf = zbuffer_argmin(zkey, fpix, num_pix, n_valid)
    return (zbuf.long() << 32) | idbuf.long()


def key_id_views(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(key, id) int32 planes of int64 words (key << 32) | id."""
    halves = packed.view(torch.int32).view(-1, 2)
    return halves[:, 1], halves[:, 0]
