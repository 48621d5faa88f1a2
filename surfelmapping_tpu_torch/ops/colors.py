"""Color/semantic bit-packing (counterpart of surfelmapping_tpu/ops/colors.py).

The reference packs (semantic << 24 | r << 16 | g << 8 | b) into the bit
pattern of one float (src/Shaders/color.glsl:19-37).  The port keeps that
packed value as **int32 bits** in every structure (map, active table,
association records): a class-0 color with r < 128 packs to a subnormal
float32, and any float arithmetic or comparison under flush-to-zero would
destroy it.  Bits become a float only at the checkpoint boundary, by
``Tensor.view(torch.float32)``.
"""

from __future__ import annotations

import torch


def encode_color(rgb: torch.Tensor, semantic: torch.Tensor) -> torch.Tensor:
    """Pack [..., 3] float rgb in [0,1] + [...] integer semantic into int32
    bits (sem << 24 | r << 16 | g << 8 | b), color.glsl:19-26 including the
    round-half-to-even quantization of each channel."""
    q = torch.round(torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.int32)
    return (
        (semantic.to(torch.int32) << 24)
        | (q[..., 0] << 16)
        | (q[..., 1] << 8)
        | q[..., 2]
    )


def decode_color(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`encode_color` on int32 bits: returns (rgb float
    [...,3] in [0,1], semantic int32 [...]); color.glsl:28-37."""
    sem = (packed >> 24) & 0xFF
    r = (packed >> 16) & 0xFF
    g = (packed >> 8) & 0xFF
    b = packed & 0xFF
    rgb = torch.stack([r, g, b], dim=-1).to(torch.float32) / 255.0
    return rgb, sem
