"""SE(3) helpers on planar point columns (counterpart of
surfelmapping_tpu/ops/transforms.py:32-73).

Poses are f32[4,4] tensors, camera-to-world unless suffixed ``_inv``.  The
JAX package runs its matmuls at ``Precision.HIGHEST``; the counterpart here is
plain float32 with TF32 disabled (``torch.backends.cuda.matmul.allow_tf32 =
False``, set by :func:`full_precision_matmul`, which the mapper calls): a
TF32 product keeps ~10 mantissa bits, several cm at 10-30 m scene scale.
"""

from __future__ import annotations

import functools

import torch


def full_precision_matmul() -> None:
    """Run float32 matmuls in full float32 (no TF32) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False


def transform_planar(T: torch.Tensor, x, y, z):
    """Rigid transform on planar point columns -> (x', y', z')."""
    R, t = T[:3, :3], T[:3, 3]
    return (
        R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + t[0],
        R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + t[1],
        R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + t[2],
    )


def rotate_planar(T: torch.Tensor, x, y, z):
    """Rotation-only transform on planar vector columns -> (x', y', z')."""
    R = T[:3, :3]
    return (
        R[0, 0] * x + R[0, 1] * y + R[0, 2] * z,
        R[1, 0] * x + R[1, 1] * y + R[1, 2] * z,
        R[2, 0] * x + R[2, 1] * y + R[2, 2] * z,
    )


def ieee_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device.  The card's
    ``sqrtf`` rounds correctly, as XLA's does; PyTorch's vectorised float32
    sqrt on the CPU does not (one ulp off on some inputs), so on the CPU it
    is taken in float64, whose rounding back to float32 is exact."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


@functools.lru_cache(maxsize=64)
def _device_scalar(value: float, device: torch.device) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=device)


def device_scalar(value: float, device) -> torch.Tensor:
    """``value`` as a 0-d float32 tensor on ``device`` (cached; never write
    to it), to divide by.  PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which rounds differently from a true
    division on the CPU and in XLA; division by a device tensor is a true
    IEEE division on every device."""
    return _device_scalar(float(value), torch.device(device))


def normalize_planar(x, y, z):
    """Unit-normalize planar vector columns (safe at zero length)."""
    n = torch.clamp(ieee_sqrt(x * x + y * y + z * z), min=1e-12)
    return x / n, y / n, z / n


def invert_se3(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform."""
    R = T[:3, :3]
    t = T[:3, 3]
    Ti = torch.eye(4, dtype=T.dtype, device=T.device)
    Ti[:3, :3] = R.T
    Ti[:3, 3] = -torch.matmul(R.T, t)
    return Ti


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Full-precision 4x4 pose composition A @ B."""
    return torch.matmul(A, B)
