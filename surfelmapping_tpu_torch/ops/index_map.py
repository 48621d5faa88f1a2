"""Depth keys for the index map's z-buffer (counterpart of
surfelmapping_tpu/ops/index_map.py:38-44).

Pixel convention: a point projected to continuous (u, v) lands in pixel
(ceil(u)-1, ceil(v)-1), the GL point-rasterization rule for size-1 points.
"""

from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1


def _depth_key(z: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Monotonic int32 key for positive-float depth ordering; invalid -> MAX.
    The key is the float's bit pattern: for z > 0 it is >= 0 and orders
    like z."""
    key = z.to(torch.float32).view(torch.int32)
    return torch.where(valid, key, INT32_MAX)
