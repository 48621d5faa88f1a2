"""The work the kernels are credited with, from each call's own sizes, and
the peaks of the card (NVIDIA H100 SXM data sheet).  Kept with the
benchmark, so a change to a kernel does not change the work it is held to.

Bytes count each input byte read once and each output byte written once,
whatever the kernel reads again.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores


def k1_bytes(valid: int, pixels: int, count_given: bool) -> int:
    """K1 (the scatter-argmin z-buffer): the valid candidates' int32 key and
    int32 pixel, the 0-d int32 count where one is given, and one int64
    packed (key << 32 | id) word written per pixel."""
    return 8 * valid + (4 if count_given else 0) + 8 * pixels


def k1_seconds(valid: int, pixels: int, count_given: bool) -> float:
    """K1's least time: it moves bytes and computes next to nothing."""
    return k1_bytes(valid, pixels, count_given) / HBM_BYTES_PER_S


def k2_ops_per_pixel(radius: int) -> int:
    """K2 (the preprocess stencil): float32 operations per pixel, 3 per
    smooth tap (multiply, two adds), 2 per support tap (subtract, compare)
    in two passes, one divide (copied from chip_smoke.k2_ops_per_pixel, commit
    dd68e64)."""
    taps = (2 * radius + 1) ** 2
    return 3 * taps + 2 * 2 * 8 + 1


def k2_bytes(pixels: int, radius: int) -> int:
    """The f32 metric depth and i32 class read, the f32 filtered depth
    written, and the f32 tap weights read."""
    return 12 * pixels + 4 * (2 * radius + 1) ** 2


def k2_seconds(pixels: int, radius: int) -> float:
    """K2's least time: the larger of its operations and its bytes bounds."""
    return max(k2_ops_per_pixel(radius) * pixels / F32_OPS_PER_S,
               k2_bytes(pixels, radius) / HBM_BYTES_PER_S)
