"""Frozen copy of ``surfelmapping_tpu_torch/ops/colors.py`` at commit dd68e64,
trimmed to what the benchmark's reference needs.  Colour and class packed as
int32 bits (sem << 24 | r << 16 | g << 8 | b).
"""

from __future__ import annotations

import torch

from .transforms import device_scalar


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
    return unit_rgb(torch.stack([r, g, b], dim=-1)), sem


def unit_rgb(levels: torch.Tensor) -> torch.Tensor:
    """Integer colour levels 0..255 as float32 in [0, 1], divided by a
    device tensor: PyTorch's CUDA division by a Python scalar multiplies by
    its reciprocal, which rounds half of the 256 levels differently from the
    CPU and from XLA."""
    return levels.to(torch.float32) / device_scalar(255.0, levels.device)


# Cityscapes-style 19-class train-id palette of the reference's semantic
# surfel rendering (src/GlobalModel.cpp:718-736) and GUI semantic display
# (src/Shaders/show_semantic.frag); uint8 [19, 3].
