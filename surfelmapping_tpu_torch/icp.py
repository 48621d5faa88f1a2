"""Frame-to-model ICP pose refinement, point-to-plane Gauss-Newton
(counterpart of surfelmapping_tpu/icp.py).

The reference takes ground-truth poses and performs no tracking
(src/SurfelMapping.h:29); this module supplies it:

  * per iteration, the model is projectively associated to the frame through
    the same index map as fusion (``ops/active.index_active``, the z-buffer
    kernel K1 on the card);
  * per-pixel point-to-plane residuals r = n_w . (T v_c - p_w) with Huber
    weights build the 6x6 normal equations as masked sums;
  * the 6-dof update solves on the device (6x6 Cholesky) with a trust-region
    clamp and a step search over four step fractions.

The iterations are a Python loop over device tensors: the gates, the clamp
and the step choice stay tensor operations, so nothing is read back to the
host inside a refinement.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .config import CameraIntrinsics, PipelineParams
from .ops.active import ActiveTable, index_active, table_from_map
from .ops.frame_surfels import backproject, central_normals
from .ops.preprocess import metricize_depth, support_filter
from .ops.transforms import (compose, device_scalar, dot3, exp_se3, fma_matmul,
                             full_precision_matmul, ieee_sqrt, invert_se3, norm3,
                             rotate_vectors, safe_normalize, solve_pos, transform_points)
from .pipeline import resolve_device
from .surfels import SurfelMap

_EPS = 1e-12


@functools.lru_cache(maxsize=8)
def _step_scales(device: torch.device) -> torch.Tensor:
    """The step fractions tried per iteration, on ``device`` (cached: a
    tensor made from a list on the card costs a host sync)."""
    return torch.tensor((1.0, 0.5, 0.25, 0.0), dtype=torch.float32, device=device)


def preprocess_for_icp(depth_raw: torch.Tensor, semantic: torch.Tensor,
                       cam: CameraIntrinsics, params: PipelineParams) -> torch.Tensor:
    """Metricize + both support filters, NO box smoothing: the reference's
    smoothing bias is range-dependent, so smoothed frame depth does not
    cancel against the smoothed-ingest map and the mapping feedback loop
    drifts (surfelmapping_tpu/icp.py:76-84)."""
    metric = metricize_depth(depth_raw, cam, params)
    f1 = support_filter(metric, semantic, params, params.filter_diff_thresh_1)
    return support_filter(f1, semantic, params, params.filter_diff_thresh_2)


def frame_geometry(depth: torch.Tensor, cam: CameraIntrinsics):
    """Camera-frame points and central-difference normals, [H*W, 3] each."""
    vx, vy, vz = backproject(depth, cam)
    nx, ny, nz = central_normals(depth, cam)
    v_c = torch.stack([vx.reshape(-1), vy.reshape(-1), vz.reshape(-1)], dim=-1)
    n_c = torch.stack([nx.reshape(-1), ny.reshape(-1), nz.reshape(-1)], dim=-1)
    return v_c, n_c


def incidence_ok(v_c: torch.Tensor, n_c: torch.Tensor, incidence_min: float) -> torch.Tensor:
    """Grazing-angle gate |n.v| / (|v||n|) > incidence_min: grazing surfaces
    carry the largest viewpoint-dependent depth bias."""
    incidence = torch.abs(dot3(n_c, v_c)) / torch.clamp(norm3(v_c) * norm3(n_c), min=_EPS)
    return incidence > incidence_min


def associate(at: ActiveTable, ids: torch.Tensor, pose: torch.Tensor, v_c: torch.Tensor,
              n_c: torch.Tensor, valid: torch.Tensor, max_residual: float,
              huber_delta: float):
    """The model point and normal behind each pixel's index-image id and the
    pixel's gated Huber weight (icp.py:122-147, ba.py:189-210): the frame
    normal within 0.5 rad of the model's (data.vert:158), |r| under
    ``max_residual``, the distance under 4x that.

    Returns (v_w, p_w, n_w, w, ok)."""
    has = ids >= 0  # the index map already excludes global id 0
    safe = torch.clamp(ids, 0, at.size - 1)
    p_w = torch.stack([at.x[safe], at.y[safe], at.z[safe]], dim=-1)
    n_w = safe_normalize(torch.stack([at.nx[safe], at.ny[safe], at.nz[safe]], dim=-1))
    v_w = transform_points(pose, v_c)
    n_fw = rotate_vectors(pose, n_c)
    d = v_w - p_w
    r = dot3(n_w, d)
    angle_ok = dot3(n_fw, n_w) > 0.878  # cos(0.5 rad)
    ok = (valid & has & angle_ok & (torch.abs(r) < max_residual)
          & (norm3(d) < 4.0 * max_residual))
    ar = torch.abs(r)
    w = torch.where(ar < huber_delta, 1.0,
                    device_scalar(huber_delta, ar.device) / torch.clamp(ar, min=_EPS))
    w = torch.where(ok, w, 0.0)
    return v_w, p_w, n_w, w, ok


def _normal_equations(v_w: torch.Tensor, p_w: torch.Tensor, n_w: torch.Tensor,
                      w: torch.Tensor):
    """A (6x6), b (6,) and the weighted residual sum of squares.

    Left-multiplicative update T <- exp([v, omega]) T, so J = [n ; v_w x n]
    per point; every output is a plain sum over points."""
    r = dot3(n_w, v_w - p_w)
    J = torch.cat([n_w, torch.linalg.cross(v_w, n_w, dim=-1)], dim=-1)  # [P,6]
    wr = w * r
    A = torch.matmul((J * w[:, None]).T, J)
    b = -torch.matmul(J.T, wr)
    return A, b, torch.sum(wr * r)


def trust_region(delta: torch.Tensor) -> torch.Tensor:
    """Per-step scale min(1, 0.3 m / |v|, 0.1 rad / |w|) of [..., 6] twists,
    shaped [..., 1]."""
    dev = delta.device
    tn = torch.clamp(norm3(delta[..., :3]), min=_EPS)
    rn = torch.clamp(norm3(delta[..., 3:]), min=_EPS)
    scale = torch.minimum(device_scalar(0.3, dev) / tn, device_scalar(0.1, dev) / rn)
    return torch.clamp(scale, max=1.0)[..., None]


def _gauss_newton_step(A: torch.Tensor, b: torch.Tensor, n_in: torch.Tensor) -> torch.Tensor:
    """Marquardt-damped solve, trust-region clamp, and a zero update when the
    solve fails or fewer than 64 pixels are inliers."""
    dA = torch.diagonal(A)
    A = A + torch.diag(1e-2 * dA + 1e-6 * torch.max(dA) + 1e-12)
    delta = solve_pos(A, b)
    delta = delta * trust_region(delta)
    ill = ~torch.all(torch.isfinite(delta)) | (n_in < 64)
    return torch.where(ill, 0.0, delta)


def _best_step(delta: torch.Tensor, pose: torch.Tensor, v_c: torch.Tensor,
               p_w: torch.Tensor, n_w: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The pose at the step fraction (1, 1/2, 1/4 or 0) with the least
    weighted SSE over the same correspondences; ties go to the first."""
    scales = _step_scales(delta.device)
    P = compose(exp_se3(delta * scales[:, None]), pose)                     # [4,4,4]
    vw = fma_matmul(v_c, P[:, :3, :3].transpose(-1, -2)) + P[:, None, :3, 3]  # [4,P,3]
    rr = dot3(n_w, vw - p_w)
    sses = torch.sum(w * rr * rr, dim=-1)
    return P[torch.argmin(sses)]


def refine_pose(
    smap: SurfelMap | ActiveTable,
    depth_metric: torch.Tensor,
    init_pose: torch.Tensor,
    cam: CameraIntrinsics,
    params: PipelineParams,
    iters: int = 5,
    max_residual: float = 0.5,
    huber_delta: float = 0.05,
    incidence_min: float = 0.5,
):
    """Refine ``init_pose`` (camera-to-world) against the map.

    ``smap`` is a SurfelMap or an ActiveTable (the gathered in-frustum
    working set, ``SurfelMapper.active_table``), so every iteration costs
    O(in-view surfels).  ``depth_metric`` is :func:`preprocess_for_icp`'s
    output.  Returns (pose, {"rmse", "inliers"} of the last iteration, 0-d
    device tensors)."""
    at = smap if isinstance(smap, ActiveTable) else table_from_map(smap)
    n_valid = at.slot_valid.sum(dtype=torch.int32)  # the valid prefix, once
    time = torch.max(torch.where(at.slot_valid, at.last_t, 0.0))
    v_c, n_c = frame_geometry(depth_metric, cam)
    d_flat = depth_metric.reshape(-1)
    frame_valid = ((d_flat > params.near_clip) & (d_flat < params.far_clip)
                   & incidence_ok(v_c, n_c, incidence_min))

    pose = init_pose
    rmse = torch.zeros((), dtype=torch.float32, device=d_flat.device)
    n_in = torch.zeros((), dtype=torch.int32, device=d_flat.device)
    fa = params.index_factor
    s0 = (fa - 1) // 2  # index pixel of each depth pixel's centre: ceil(fa*(c+0.5))-1
    for _ in range(iters):
        idx = index_active(at, invert_se3(pose), time, cam, params, n_valid)
        ids = idx[s0::fa, s0::fa].reshape(-1)
        v_w, p_w, n_w, w, ok = associate(at, ids, pose, v_c, n_c, frame_valid,
                                         max_residual, huber_delta)
        A, b, wss = _normal_equations(v_w, p_w, n_w, w)
        n_in = ok.sum(dtype=torch.int32)
        delta = _gauss_newton_step(A, b, n_in)
        pose = _best_step(delta, pose, v_c, p_w, n_w, w)
        rmse = ieee_sqrt(wss / torch.clamp(n_in.to(torch.float32), min=1.0))
    return pose, {"rmse": rmse, "inliers": n_in}


class ICPRefiner:
    """Host-side wrapper: raw frame in, refined pose out (numpy).

    ``device=None`` runs on the card and raises without one."""

    def __init__(self, cam: CameraIntrinsics, params: PipelineParams, iters: int = 5,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        full_precision_matmul()
        self.cam = cam
        self.params = params
        self.iters = iters
        self.last_diag: dict = {}

    def refine(self, smap, depth_raw, semantic, init_pose) -> np.ndarray:
        dev = self.device
        depth = torch.from_numpy(np.asarray(depth_raw).astype(np.int32)).to(dev)
        sem = torch.from_numpy(np.asarray(semantic).astype(np.int32)).to(dev)
        depth_m = preprocess_for_icp(depth, sem, self.cam, self.params)
        pose0 = torch.as_tensor(np.asarray(init_pose, np.float32), device=dev)
        pose, diag = refine_pose(smap, depth_m, pose0, self.cam, self.params, self.iters)
        self.last_diag = {k: float(v) for k, v in diag.items()}
        return pose.cpu().numpy()
