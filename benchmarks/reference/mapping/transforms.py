"""Frozen copy of ``surfelmapping_tpu_torch/ops/transforms.py`` at commit
dd68e64, trimmed to what the benchmark's reference needs.  SE(3) helpers:
planar transforms, the k-ordered FMA pose product in float64, true IEEE
division by device scalars, a correctly rounded sqrt on the CPU.
"""

from __future__ import annotations

import functools

import torch


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


def fma_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """float32 ``A @ B`` ([..., n, k] @ [..., k, m]) as the k-ordered FMA
    chain acc = fma(A[:, k], B[k, :], acc), the same bits on every device.
    Each fma is emulated in float64: the product of two float32 values is
    exact there, and eager float64 multiply and add are separate IEEE
    operations that nothing contracts."""
    prod = A.to(torch.float64).unsqueeze(-1) * B.to(torch.float64).unsqueeze(-3)
    acc = prod[..., 0, :].to(torch.float32)
    for k in range(1, A.shape[-1]):
        acc = (prod[..., k, :] + acc.to(torch.float64)).to(torch.float32)
    return acc


def _rounded_once(fn, x: torch.Tensor) -> torch.Tensor:
    return fn(x.to(torch.float64)).to(torch.float32)


def acos(x: torch.Tensor) -> torch.Tensor:
    """float32 arccos, taken in float64 and rounded once: the card's and the
    CPU's float32 ``arccos`` round differently."""
    return _rounded_once(torch.arccos, x)


def invert_se3(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    Ti = torch.zeros_like(T)
    Ti[..., 3, 3] = 1.0
    Ti[..., :3, :3] = Rt
    Ti[..., :3, 3] = -fma_matmul(Rt, T[..., :3, 3:])[..., 0]
    return Ti


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Full-precision 4x4 pose composition A @ B."""
    return fma_matmul(A, B)
