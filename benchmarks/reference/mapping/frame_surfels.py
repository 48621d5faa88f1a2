"""Frozen copy of ``surfelmapping_tpu_torch/ops/frame_surfels.py`` at commit
dd68e64, trimmed to what the benchmark's reference needs.  Per-pixel
candidate surfels of a preprocessed frame: back-projection, central-
difference normals, the radius model, the 1/2 checkerboard.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import CameraIntrinsics, PipelineParams
from .colors import encode_color
from .preprocess import _shift
from .transforms import device_scalar, ieee_sqrt

SQRT2 = 1.41421356237


def pixel_grid(cam: CameraIntrinsics, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Continuous pixel-center coordinates x=[H,W] (col+0.5), y=[H,W] (row+0.5)."""
    H, W = cam.height, cam.width
    x = (torch.arange(W, dtype=torch.float32, device=device) + 0.5)[None, :].expand(H, W)
    y = (torch.arange(H, dtype=torch.float32, device=device) + 0.5)[:, None].expand(H, W)
    return x, y


def backproject(depth: torch.Tensor, cam: CameraIntrinsics):
    """Depth image -> camera-frame vertex component images (X, Y, Z)
    (geometry.glsl getVertex: X=(x-cx)z/fx, Y=(y-cy)z/fy, Z=z)."""
    x, y = pixel_grid(cam, depth.device)
    fx, fy = device_scalar(cam.fx, depth.device), device_scalar(cam.fy, depth.device)
    X = (x - cam.cx) * depth / fx
    Y = (y - cam.cy) * depth / fy
    return X, Y, depth


def central_normals(depth: torch.Tensor, cam: CameraIntrinsics):
    """Central-difference normal component images (nx, ny, nz)
    (geometry.glsl getNormal: n = normalize(cross(Vxb - Vxf, Vyb - Vyf))).

    Boundary pixels reproduce the GL texture clamp: the depth sample clamps
    to the edge texel while the unclamped pixel coordinate (x±1, y±1) is used
    for back-projection."""
    x, y = pixel_grid(cam, depth.device)
    fx, fy = device_scalar(cam.fx, depth.device), device_scalar(cam.fy, depth.device)

    def vertex_at(dy: int, dx: int):
        d, _ = _shift(depth, dy, dx)  # clamped depth sample
        xs = x + dx  # unclamped coordinate, as the shader passes x±1
        ys = y + dy
        return (xs - cam.cx) * d / fx, (ys - cam.cy) * d / fy, d

    lx, ly, lz = vertex_at(0, -1)
    rx, ry, rz = vertex_at(0, 1)
    ux, uy, uz = vertex_at(-1, 0)
    dx_, dy_, dz_ = vertex_at(1, 0)
    ax, ay, az = lx - rx, ly - ry, lz - rz          # del_x
    bx, by, bz = ux - dx_, uy - dy_, uz - dz_       # del_y
    cx = ay * bz - az * by
    cy = az * bx - ax * bz
    cz = ax * by - ay * bx
    n = torch.clamp(ieee_sqrt(cx * cx + cy * cy + cz * cz), min=1e-12)
    return cx / n, cy / n, cz / n


def surfel_radius(depth: torch.Tensor, norm_z: torch.Tensor, cam: CameraIntrinsics) -> torch.Tensor:
    """Disc radius r = min(2*(z*sqrt2/meanFocal), (z*sqrt2/meanFocal)/|nz|)
    (surfels.glsl:19-32), meanFocal = (fx+fy)/2."""
    mean_focal = device_scalar((cam.fx + cam.fy) / 2.0, depth.device)
    radius = depth * SQRT2 / mean_focal
    return torch.minimum(2.0 * radius, radius / torch.clamp(torch.abs(norm_z), min=1e-12))


def checkerboard(cam: CameraIntrinsics, device) -> torch.Tensor:
    """The reference's 1/2-sparse pixel mask (int(x)+int(y)) % 2 == 1
    (surfel_feedback.vert:39, data.vert:88)."""
    r = torch.arange(cam.height, device=device)[:, None]
    c = torch.arange(cam.width, device=device)[None, :]
    return (r + c) % 2 == 1


def neighbours_nonzero(depth: torch.Tensor) -> torch.Tensor:
    """data.vert:33-52 checkNeighbours: all 4 axis neighbours have nonzero
    depth, testing the edge-clamped texel at the image border."""
    ok = torch.ones(depth.shape, dtype=torch.bool, device=depth.device)
    for dy, dx in ((0, -1), (-1, 0), (0, 1), (1, 0)):
        d, _ = _shift(depth, dy, dx)
        ok = ok & (d != 0.0)
    return ok


@dataclasses.dataclass
class FrameSurfels:
    """Dense per-pixel candidate surfels in the CAMERA frame (planar [H,W]
    tensors; colorsem is the packed int32 color + class)."""

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor
    radius: torch.Tensor
    conf: torch.Tensor
    colorsem: torch.Tensor
    sem: torch.Tensor       # i32[H,W] (kept unpacked: the association gate reads it)
    valid: torch.Tensor     # bool[H,W]


def feedback_surfels(
    depth: torch.Tensor,
    rgb: torch.Tensor,
    semantic: torch.Tensor,
    cam: CameraIntrinsics,
    params: PipelineParams,
) -> FrameSurfels:
    """The FeedbackBuffer pass (surfel_feedback.vert/.geom +
    src/FeedbackBuffer.cpp:85-145): camera-frame surfels for every valid
    pixel, validity = z>0 && z<maxDepth && checkerboard.  ``rgb`` is
    f32[H,W,3] in [0,1]."""
    px, py, pz = backproject(depth, cam)
    nx, ny, nz = central_normals(depth, cam)
    radius = surfel_radius(depth, nz, cam)
    sem = semantic.to(torch.int32)
    valid = (depth > 0.0) & (depth < params.far_clip) & checkerboard(cam, depth.device)
    return FrameSurfels(
        px=px, py=py, pz=pz,
        nx=nx, ny=ny, nz=nz,
        radius=radius,
        conf=torch.full(depth.shape, params.conf_new, dtype=torch.float32,
                        device=depth.device),
        colorsem=encode_color(rgb, sem),
        sem=sem,
        valid=valid,
    )


def association_candidates(
    depth: torch.Tensor,
    rgb: torch.Tensor,
    semantic: torch.Tensor,
    cam: CameraIntrinsics,
    params: PipelineParams,
) -> FrameSurfels:
    """The candidate half of data.vert (lines 59-113): same geometry as
    feedback_surfels with the stricter validity gate
    checkNeighbours && d>minDepth && d<maxDepth && checkerboard."""
    fs = feedback_surfels(depth, rgb, semantic, cam, params)
    valid = (
        neighbours_nonzero(depth)
        & (depth > params.near_clip)
        & (depth < params.far_clip)
        & checkerboard(cam, depth.device)
    )
    return dataclasses.replace(fs, valid=valid)


def ray_geometry(cam: CameraIntrinsics, device):
    """Per-pixel unit-plane ray components (xl, yl) and length lambda
    (data.vert:65-71); the z component is identically 1."""
    x, y = pixel_grid(cam, device)
    xl = (x - cam.cx) / device_scalar(cam.fx, device)
    yl = (y - cam.cy) / device_scalar(cam.fy, device)
    lam = ieee_sqrt(xl * xl + yl * yl + 1.0)
    return xl, yl, lam
