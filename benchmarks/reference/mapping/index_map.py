"""Frozen copy of ``surfelmapping_tpu_torch/ops/index_map.py`` at commit
dd68e64, trimmed to what the benchmark's reference needs.  The monotone
int32 depth key of the z-buffers.
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
