"""SE(3) helpers (counterpart of surfelmapping_tpu/ops/transforms.py).

Poses are f32[4,4] tensors, camera-to-world unless suffixed ``_inv``; the
pose helpers also take leading batch dimensions.  The JAX package runs its
matmuls at ``Precision.HIGHEST``.  Its small products (4x4 poses, 3x3
rotations, points by a rotation) are, on the CPU, a k-ordered float32 FMA
chain, as is PyTorch's CPU ``matmul`` of one small matrix (its batched
``matmul`` is not fused, and cuBLAS orders the sum its own way).
:func:`fma_matmul` computes that chain on every device, so the card, the
CPU and XLA give the same bits.  The large products (ICP's normal
equations) are plain float32 with TF32 disabled
(``torch.backends.cuda.matmul.allow_tf32 = False``, set by
:func:`full_precision_matmul`): a TF32 product keeps ~10 mantissa bits,
several cm at 10-30 m scene scale.  Transcendentals of the pose math
(:func:`acos`, sin, cos) are taken in float64 and rounded once, because the
card's and the CPU's float32 versions round differently.
"""

from __future__ import annotations

import functools

import torch


def full_precision_matmul() -> None:
    """Run float32 matmuls and cuDNN convolutions in full float32 (no TF32)
    on the card.  cuDNN takes TF32 for float32 convolutions by default, and
    the SPADE generator's card output is held against the CPU's at 1e-4 of
    its scale, which ~10 mantissa bits per product do not keep."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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


def safe_divisor(d: torch.Tensor) -> torch.Tensor:
    """``d`` with |d| < 1e-12 replaced by 1e-12, the guard before dividing
    by a depth or a plane's denominator."""
    return torch.where(torch.abs(d) < 1e-12, 1e-12, d)


def project_pixels(x, y, z, cam):
    """The pinhole projection of camera-frame planar points: continuous
    pixel coordinates (u, v) = (fx x / z + cx, fy y / z + cy), with the
    depth guarded by :func:`safe_divisor`."""
    safe_z = safe_divisor(z)
    return cam.fx * x / safe_z + cam.cx, cam.fy * y / safe_z + cam.cy


def project_planar(T_inv: torch.Tensor, x, y, z, cam):
    """Planar points into the camera ``T_inv`` (world-to-camera) and onto
    its image: (x', y', z', u, v)."""
    x, y, z = transform_planar(T_inv, x, y, z)
    return (x, y, z) + project_pixels(x, y, z, cam)


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


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 rigid transform to [..., 3] points."""
    return fma_matmul(pts, T[:3, :3].T) + T[:3, 3]


def rotate_vectors(T: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Apply only the rotation part of a 4x4 transform to [..., 3] vectors."""
    return fma_matmul(vecs, T[:3, :3].T)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of [..., 3] products, in index order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of [..., 3] vectors."""
    return ieee_sqrt(dot3(v, v))


def safe_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize [..., 3] vectors without NaN on zero vectors."""
    return v / torch.clamp(norm3(v), min=eps)[..., None]


def _hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew matrices [w]x."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], z], dim=-1),
    ], dim=-2)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map from [..., 6] twists (v, w) to [..., 4, 4] transforms."""
    v, w = xi[..., :3], xi[..., 3:]
    wnorm = norm3(w)
    theta = torch.clamp(wnorm, min=1e-12)[..., None, None]
    K = _hat(w) / theta
    s = _rounded_once(torch.sin, theta)
    c = _rounded_once(torch.cos, theta)
    KK = fma_matmul(K, K)
    eye3 = _eye(3, xi)
    R = eye3 + s * K + (1.0 - c) * KK
    V = eye3 + ((1.0 - c) / theta) * K + ((theta - s) / theta) * KK
    small = (wnorm < 1e-8)[..., None, None]
    R = torch.where(small, eye3, R)
    V = torch.where(small, eye3, V)
    T = _eye(4, xi).expand(xi.shape[:-1] + (4, 4)).clone()
    T[..., :3, :3] = R
    T[..., :3, 3] = fma_matmul(V, v[..., None])[..., 0]
    return T


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """Logarithm map: [..., 4, 4] rigid transforms -> [..., 6] twists (v, w),
    guarded at theta -> 0 (KITTI-scale increments never approach pi)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = acos(cos_theta)
    skew = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                        R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    s = _rounded_once(torch.sin, theta)
    small = theta < 1e-6
    factor = torch.where(small, 0.5, theta / torch.clamp(2.0 * s, min=1e-12))
    w = factor[..., None] * skew
    K = _hat(w)
    th = torch.clamp(theta, min=1e-12)
    KK = fma_matmul(K, K)
    # V^{-1} = I - K/2 + (1/theta^2)(1 - theta sin / (2(1-cos))) K^2
    coef = torch.where(
        small, 1.0 / 12.0,
        (1.0 - th * s / (2.0 * torch.clamp(1.0 - cos_theta, min=1e-12))) / (th * th))
    Vinv = _eye(3, T) - 0.5 * K + coef[..., None, None] * KK
    v = fma_matmul(Vinv, t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def adjoint_se3(T: torch.Tensor) -> torch.Tensor:
    """[..., 6, 6] adjoint for (v, w)-ordered twists: [[R, [t]x R], [0, R]]."""
    R = T[..., :3, :3]
    top = torch.cat([R, fma_matmul(_hat(T[..., :3, 3]), R)], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def solve_pos(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.linalg.solve(A, B, assume_a="pos")`` for [n, n] A and [n]
    or [n, k] B, through Cholesky, with no host sync.  Where A is not
    positive definite JAX's factor holds NaN and so does its solution; here
    the factor holds garbage, so the solution is set to NaN explicitly."""
    L, info = torch.linalg.cholesky_ex(A)
    X = torch.cholesky_solve(B if B.dim() == 2 else B[:, None], L)
    X = torch.where(info == 0, X, torch.nan)
    return X if B.dim() == 2 else X[:, 0]
