"""Parity metrics: rendered-image PSNR and trajectory error (counterpart
of surfelmapping_tpu/metrics.py).
"""

from __future__ import annotations

import numpy as np
import torch


def psnr(a: np.ndarray, b: np.ndarray, mask: np.ndarray | None = None,
         peak: float = 1.0) -> float:
    """PSNR between two images; with ``mask`` only masked pixels count
    (novel-view renders have holes — compare where a splat landed)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if mask is not None:
        m = np.broadcast_to(np.asarray(mask)[..., None] if a.ndim == 3 and mask.ndim == 2 else mask, a.shape)
        diff2 = ((a - b) ** 2)[m]
    else:
        diff2 = (a - b) ** 2
    mse = diff2.mean() if diff2.size else np.inf
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def render_vs_frame_psnr(mapper, rgb_frame: np.ndarray, pose: np.ndarray,
                         footprint: int = 5) -> tuple[float, float]:
    """Render the mapper's map at ``pose`` and compare with the captured RGB
    frame.  Returns (psnr_on_hits, hit_fraction)."""
    from .ops.splat import splat_render

    # single window: a parity metric must never degrade quietly through
    # cropped large-bucket splats
    out = splat_render(mapper.smap, torch.as_tensor(pose, dtype=torch.float32,
                                                    device=mapper.device),
                       mapper.cam, footprint=footprint, small_footprint=None)
    rendered = out["rgb"].cpu().numpy()
    hits = out["semantic"].cpu().numpy() > 0
    frame = np.asarray(rgb_frame, np.float64)
    if frame.max() > 1.5:
        frame = frame / 255.0
    return psnr(rendered, frame, hits), float(hits.mean())


def absolute_trajectory_error(est: np.ndarray, gt: np.ndarray) -> dict:
    """ATE between pose sequences [N,4,4] (translation RMSE/mean/max, m)."""
    est = np.asarray(est)
    gt = np.asarray(gt)
    d = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    return {
        "rmse": float(np.sqrt((d ** 2).mean())),
        "mean": float(d.mean()),
        "max": float(d.max()),
    }
