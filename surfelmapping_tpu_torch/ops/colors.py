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
SEMANTIC_PALETTE = torch.tensor(
    [
        [128, 64, 128],   # 0  road
        [244, 35, 232],   # 1  sidewalk
        [70, 70, 70],     # 2  building
        [102, 102, 156],  # 3  wall
        [190, 153, 153],  # 4  fence
        [153, 153, 153],  # 5  pole
        [250, 170, 30],   # 6  traffic light
        [220, 220, 0],    # 7  traffic sign
        [107, 142, 35],   # 8  vegetation
        [152, 251, 152],  # 9  terrain
        [70, 130, 180],   # 10 sky
        [220, 20, 60],    # 11 person
        [255, 0, 0],      # 12 rider
        [0, 0, 142],      # 13 car
        [0, 0, 70],       # 14 truck
        [0, 60, 100],     # 15 bus
        [0, 80, 100],     # 16 train
        [0, 0, 230],      # 17 motorcycle
        [119, 11, 32],    # 18 bicycle
    ],
    dtype=torch.uint8,
)


def semantic_to_rgb(semantic: torch.Tensor) -> torch.Tensor:
    """Map class ids to palette colors for visualization (uint8 [..., 3]);
    ids outside the palette clamp to its ends."""
    palette = SEMANTIC_PALETTE.to(semantic.device)
    idx = torch.clamp(semantic.to(torch.int64), 0, palette.shape[0] - 1)
    return palette[idx]
