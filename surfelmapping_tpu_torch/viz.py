"""Offline visualization, the headless analogue of the reference's Pangolin
GUI (gui/GUI.{h,cpp} + the draw_surface shader family); counterpart of
surfelmapping_tpu/viz.py.

The reference's window offers surfel rendering in mono/normal/rgb/semantic
colour modes (draw_surface.vert + draw_surface_adaptive.geom) and
normalized-depth and semantic-palette image panels (GUI::normalizeDepth /
processSemantic, gui/GUI.cpp:199-273).  This module renders the same content
to numpy arrays and PNG files.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import CameraIntrinsics
from .ops.colors import semantic_to_rgb
from .ops.splat import splat_render
from .surfels import SurfelMap


def normalize_depth(depth: np.ndarray, min_d: float, max_d: float) -> np.ndarray:
    """GUI::normalizeDepth (depth_norm_float.frag): linear map to u8 gray."""
    d = np.asarray(depth, np.float32)
    g = np.clip((d - min_d) / max(max_d - min_d, 1e-6), 0.0, 1.0)
    g = np.where(d <= 0, 0.0, g)
    return (g * 255).astype(np.uint8)


def semantic_image(semantic: np.ndarray) -> np.ndarray:
    """GUI::processSemantic (show_semantic.frag): palette colorization."""
    return semantic_to_rgb(torch.as_tensor(np.asarray(semantic))).numpy()


def render_map_view(
    smap: SurfelMap,
    view: np.ndarray,
    cam: CameraIntrinsics,
    mode: str = "rgb",
    footprint: int = 5,
) -> np.ndarray:
    """Render the map, on its device, in one of the reference's draw modes
    (draw_surface.vert colour modes): 'rgb', 'semantic', 'normal', 'mono',
    'confidence', 'depth' -> u8[H,W,3]."""
    # single window: viewer output should not crop large splats when the
    # bucketed side table overflows on dense maps
    out = splat_render(smap, torch.as_tensor(np.asarray(view, np.float32), device=smap.device),
                       cam, footprint=footprint, small_footprint=None)
    ids = out["id"].cpu().numpy()
    hole = ids < 0
    safe = np.clip(ids, 0, smap.capacity - 1)
    if mode == "rgb":
        img = out["rgb"].cpu().numpy() * 255.0
    elif mode == "semantic":
        sem = out["semantic"].cpu().numpy()
        img = semantic_image(np.maximum(sem - 1, 0)).astype(np.float32)
        img[sem == 0] = 0
    elif mode == "normal":
        n = smap.normal().cpu().numpy()[safe]
        img = (n * 0.5 + 0.5) * 255.0
    elif mode == "confidence":
        c = smap.column("conf").cpu().numpy()[safe]
        g = np.clip(c / max(c.max(), 1e-6), 0, 1)[..., None] * 255.0
        img = np.repeat(g, 3, axis=-1)
    elif mode == "depth":
        g = normalize_depth(out["depth"].cpu().numpy(), 1.0, 30.0)[..., None]
        img = np.repeat(g, 3, axis=-1).astype(np.float32)
    else:  # mono
        img = np.full(ids.shape + (3,), 200.0, np.float32)
    img[hole] = 0
    return np.clip(img, 0, 255).astype(np.uint8)


def overview_pose(traj_pose: np.ndarray, height: float = 30.0) -> np.ndarray:
    """Bird's-eye pose above a trajectory frame looking down — the GUI's
    overview fly-through camera (load_map.cpp:254-287 / build_map follow)."""
    T = np.asarray(traj_pose, np.float32).copy()
    look_down = np.array(
        [[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float32
    )
    lift = np.eye(4, dtype=np.float32)
    lift[1, 3] = -height  # y is down
    return T @ lift @ look_down


def save_png(img: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray(img).save(path)
