"""Novel-view trajectory generators and image acquisition (counterpart of
surfelmapping_tpu/views.py).

Counterparts of the reference's simulator data-generation paths:
  * random perturbed views (load_map.cpp:132-173): +-2 m lateral, +-1 m
    longitudinal, +-15 deg yaw around randomly chosen trajectory frames;
  * "S"-shaped sinusoidal sweep (load_map.cpp:176-215);
  * overview fly-through (load_map.cpp:254-287);
  * acquireImages: render each view and write paired image/semantic PNGs
    with 6-digit names (src/SurfelMapping.cpp:378-434).
The generators are numpy; poses are camera-to-world f32[4,4].
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .config import CameraIntrinsics
from .surfels import SurfelMap


def _yaw_about_minus_y(theta: float) -> np.ndarray:
    """Rotation of theta about the (0,-1,0) axis (the reference's yaw axis,
    load_map.cpp:160)."""
    c, s = np.cos(theta), np.sin(theta)
    # axis (0,-1,0): equals rotation of -theta about +y
    R = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], dtype=np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    return T


def _translate(x: float, y: float, z: float) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [x, y, z]
    return T


def random_novel_views(
    base_views: list[np.ndarray] | np.ndarray,
    num: int,
    seed: int = 0,
    max_x: float = 2.0,
    max_z: float = 1.0,
    max_yaw_deg: float = 15.0,
) -> list[np.ndarray]:
    """Random perturbations of random base frames (load_map.cpp:132-173;
    the reference generates 100*novelViewNum views)."""
    rng = np.random.default_rng(seed)
    base = np.asarray(base_views)
    out = []
    for _ in range(num):
        v = base[rng.integers(0, len(base))]
        x_off = rng.uniform(-max_x, max_x)
        z_off = rng.uniform(-max_z, max_z)
        theta = np.deg2rad(rng.uniform(-max_yaw_deg, max_yaw_deg))
        T = _translate(x_off, 0.0, z_off) @ _yaw_about_minus_y(theta)
        out.append((v @ T).astype(np.float32))
    return out


def s_shaped_views(
    base_views: list[np.ndarray] | np.ndarray,
    period: float,
    max_trans: float = 2.0,
    max_yaw_deg: float = 15.0,
) -> list[np.ndarray]:
    """Sinusoidal lateral sweep along the trajectory keyed by cumulative
    travelled distance (load_map.cpp:176-215; the reference uses
    period = 3 * novelViewNum)."""
    base = np.asarray(base_views)
    max_theta = np.deg2rad(max_yaw_deg)
    out = []
    total = 0.0
    last_t = base[0][:3, 3]
    for v in base:
        t = v[:3, 3]
        total += float(np.linalg.norm(t - last_t))
        last_t = t
        x_off = np.sin(total / period) * max_trans
        theta = -np.cos(total / period) * max_theta
        T = _translate(x_off, 0.0, 0.0) @ _yaw_about_minus_y(theta)
        out.append((v @ T).astype(np.float32))
    return out


def overview_views(
    base_views: list[np.ndarray] | np.ndarray,
    lift: float = 5.0,
    back: float = 1.0,
) -> list[np.ndarray]:
    """Overview fly-through: one lifted chase camera per trajectory frame
    (load_map.cpp:254-287): the target is the pose position raised ``lift``
    metres (y is down, so ``y - lift``), the eye sits ``back`` metres behind
    it along the pose's forward axis, and the camera looks at the target
    with the pose's up."""
    out = []
    for v in np.asarray(base_views, np.float32):
        R = v[:3, :3]
        fwd = R @ np.array([0, 0, 1], np.float32)
        up = R @ np.array([0, -1, 0], np.float32)
        view_at = v[:3, 3] + np.array([0, -lift, 0], np.float32)
        eye = view_at - back * fwd
        # the reference builds a GL modelview (x right, y up, z backward);
        # convert to the camera-to-world convention (y down, z forward)
        z_gl = eye - view_at
        z_gl /= max(np.linalg.norm(z_gl), 1e-9)
        x_gl = np.cross(up, z_gl)
        x_gl /= max(np.linalg.norm(x_gl), 1e-9)
        y_gl = np.cross(z_gl, x_gl)
        T = np.eye(4, dtype=np.float32)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x_gl, -y_gl, -z_gl, eye
        out.append(T)
    return out


def acquire_images(
    smap: SurfelMap,
    views: list[np.ndarray],
    path: str,
    cam: CameraIntrinsics,
    start_id: int = 0,
    footprint: int = 5,
    device: torch.device | str | None = None,
) -> None:
    """Render every view and save image/semantic PNG pairs — the reference's
    acquireImages (src/SurfelMapping.cpp:378-434): <path>/image/NNNNNN.png
    (RGB) and <path>/semantic/NNNNNN.png (class+1, 0 = hole).  Renders on
    ``device``: the CUDA card unless the caller asks for the CPU."""
    from PIL import Image

    from .ops.splat import pad_to_blocks, render_view
    from .pipeline import resolve_device

    image_dir = os.path.join(path, "image")
    sem_dir = os.path.join(path, "semantic")
    os.makedirs(image_dir, exist_ok=True)
    os.makedirs(sem_dir, exist_ok=True)

    dev = resolve_device(device)
    smap = pad_to_blocks(smap.to(dev), 2048)  # once, not per view
    # the previous view's active count feeds forward as the next cull budget
    hint = None
    for i, v in enumerate(views):
        out = render_view(smap, v, cam, footprint=footprint, start_blocks=hint, device=dev)
        hint = int(out["n_active_blocks"]) + 1
        rgb = torch.clamp(torch.round(out["rgb"] * 255.0), 0, 255).to(torch.uint8)
        sem = out["semantic"].to(torch.uint8)
        name = f"{start_id + i:06d}.png"
        Image.fromarray(rgb.cpu().numpy()).save(os.path.join(image_dir, name))
        Image.fromarray(sem.cpu().numpy()).save(os.path.join(sem_dir, name))
