"""Windowed bundle adjustment over the K most recent frames (counterpart of
surfelmapping_tpu/ba.py).

  * The window holds a pose per frame and a stride-subsampled camera-frame
    point/normal cloud.
  * Two residual families per Gauss-Newton iteration: each window frame's
    point-to-plane terms against the map, through the same index map as
    fusion (the z-buffer kernel K1 on the card, one call per frame; the JAX
    package vmaps the frames onto its XLA scatter path), in the K diagonal
    6x6 blocks; and odometry edges r = log(Z_k^-1 T_k^-1 T_{k+1}) between
    consecutive frames, J_{k+1} = -J_k = Adj(T_{k+1}^-1), which couple the
    window into one block-tridiagonal system.
  * The 6K x 6K system solves densely by Cholesky on the device.
  * When the window slides, the oldest pose is Schur-complemented out of the
    (pose 0, pose 1) system into a quadratic prior on the new pose 0.

Pose 0 always carries a prior (the gauge fix, then the marginalization
prior), so the system is full rank.  With a ``group`` (a
parallel.distributed.Comm over ranks that each hold part of the evidence),
the per-frame normal equations are all-reduced (SUM) before the
normalization, as the JAX package psums them over its mesh axis; every rank
then solves the identical system.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import CameraIntrinsics, PipelineParams
from .icp import _normal_equations, associate, frame_geometry, incidence_ok, trust_region
from .ops.active import ActiveTable, index_active
from .ops.transforms import (adjoint_se3, compose, device_scalar, exp_se3,
                             full_precision_matmul, invert_se3, log_se3, solve_pos)
from .pipeline import resolve_device

_EPS = 1e-12
# Map-term evidence normalization: each frame's normal equations are scaled
# by BA_EVIDENCE / n_inliers, calibrated on the JAX package's KITTI-resolution
# parity experiment (surfelmapping_tpu/ba.py:62-71).
BA_EVIDENCE = 2048.0


@dataclasses.dataclass
class BAWindow:
    """Sliding window of K frames.

    ``v_c``/``n_c`` are stride-subsampled camera-frame points/normals
    [K, P, 3]; ``valid`` masks bad pixels.  ``odo`` holds the K-1 relative
    measurements Z_k = T_k^-1 T_{k+1}.  ``prior_H``/``prior_b`` is the
    quadratic prior on pose 0 linearized at ``prior_T0``.  ``n_valid``, the
    occupied frames, is a host int (the window warms up from 1)."""

    poses: torch.Tensor     # f32[K,4,4]
    v_c: torch.Tensor       # f32[K,P,3]
    n_c: torch.Tensor       # f32[K,P,3]
    valid: torch.Tensor     # bool[K,P]
    odo: torch.Tensor       # f32[max(K-1,1),4,4]
    prior_H: torch.Tensor   # f32[6,6]
    prior_b: torch.Tensor   # f32[6]
    prior_T0: torch.Tensor  # f32[4,4]
    n_valid: int


def subsample_frame(depth_metric: torch.Tensor, cam: CameraIntrinsics,
                    params: PipelineParams, stride: int, incidence_min: float = 0.35):
    """Stride-subsampled (v_c [P,3], n_c [P,3], valid [P]) of an ICP-
    preprocessed metric depth image.  BA's incidence gate is a softer 0.35
    than ICP's 0.5: the odometry edges already hold the directions that the
    grazing ground dominates."""
    H, W = depth_metric.shape
    v, n = frame_geometry(depth_metric, cam)
    s = stride // 2
    keep = lambda a: a.view(H, W, -1)[s::stride, s::stride].reshape(-1, a.shape[-1])  # noqa: E731
    v, n = keep(v), keep(n)
    d = depth_metric[s::stride, s::stride].reshape(-1)
    ok = (d > params.near_clip) & (d < params.far_clip)
    return v, n, ok & incidence_ok(v, n, incidence_min)


def subsample_count(cam: CameraIntrinsics, stride: int) -> int:
    H = (cam.height - stride // 2 + stride - 1) // stride
    W = (cam.width - stride // 2 + stride - 1) // stride
    return H * W


def empty_window(K: int, P: int, device: torch.device | str) -> BAWindow:
    eye = torch.eye(4, dtype=torch.float32, device=device)
    return BAWindow(
        poses=eye.repeat(K, 1, 1),
        v_c=torch.zeros((K, P, 3), dtype=torch.float32, device=device),
        n_c=torch.zeros((K, P, 3), dtype=torch.float32, device=device),
        valid=torch.zeros((K, P), dtype=torch.bool, device=device),
        odo=eye.repeat(max(K - 1, 1), 1, 1),
        prior_H=torch.zeros((6, 6), dtype=torch.float32, device=device),
        prior_b=torch.zeros((6,), dtype=torch.float32, device=device),
        prior_T0=eye.clone(),
        n_valid=0,
    )


# ---------------------------------------------------------------------------
# Residual assembly
# ---------------------------------------------------------------------------

def _frame_to_map_block(at: ActiveTable, pose: torch.Tensor, v_c: torch.Tensor,
                        n_c: torch.Tensor, valid: torch.Tensor, time,
                        cam: CameraIntrinsics, params: PipelineParams, stride: int,
                        max_residual: float, huber_delta: float, n_valid: torch.Tensor):
    """One frame's point-to-plane normal equations against the table, with
    ICP's gates: (A 6x6, b 6, n_inliers).  ``stride`` is the grid ``v_c`` was
    subsampled on; ``n_valid`` the table's valid prefix."""
    idx = index_active(at, invert_se3(pose), time, cam, params, n_valid)
    fa = params.index_factor
    # the index pixel of each stride cell's centre: a point at depth-pixel
    # centre c + 0.5 lands on index pixel ceil(fa*(c+0.5)) - 1
    start = (stride // 2) * fa + (fa - 1) // 2
    ids = idx[start:cam.height * fa:stride * fa, start:cam.width * fa:stride * fa].reshape(-1)
    v_w, p_w, n_w, w, ok = associate(at, ids, pose, v_c, n_c, valid, max_residual, huber_delta)
    A, b, _ = _normal_equations(v_w, p_w, n_w, w)
    return A, b, ok.sum(dtype=torch.int32)


def _odometry_edge(T_k: torch.Tensor, T_k1: torch.Tensor, Z: torch.Tensor):
    """Linearized odometry edges (batched over leading dims): residual r0 and
    jacobian E with r(delta) ~ r0 + E (delta_{k+1} - delta_k),
    E = Adj(T_{k+1}^-1)."""
    r0 = log_se3(compose(invert_se3(Z), compose(invert_se3(T_k), T_k1)))
    E = adjoint_se3(invert_se3(T_k1))
    return E, r0


def _evidence(n_in: torch.Tensor) -> torch.Tensor:
    """BA_EVIDENCE / max(n_in, 1) per frame."""
    return (device_scalar(BA_EVIDENCE, n_in.device)
            / torch.clamp(n_in.to(torch.float32), min=1.0))


# ---------------------------------------------------------------------------
# The windowed solve
# ---------------------------------------------------------------------------

def _assemble_and_solve(diag_A, diag_b, E, r0, odo_w, frame_mask, prior_H, prior_g,
                        damping: float) -> torch.Tensor:
    """Build the block-tridiagonal 6K x 6K system and solve for the stacked
    twist updates [K,6]; unoccupied frames get identity rows (delta = 0)."""
    K = diag_A.shape[0]
    dev = diag_A.device
    fm = frame_mask.to(torch.float32)
    ew = odo_w * fm[:-1] * fm[1:]
    EtE = torch.einsum("kij,kil->kjl", E, E) * ew[:, None, None]
    Etr = torch.einsum("kij,ki->kj", E, r0) * ew[:, None]

    # diagonal blocks: map term + incident edges + prior on pose 0
    diag = diag_A * fm[:, None, None]
    diag = torch.cat([diag[:-1] + EtE, diag[-1:]])
    diag = torch.cat([diag[:1], diag[1:] + EtE])
    diag = torch.cat([diag[:1] + prior_H, diag[1:]])
    g = diag_b * fm[:, None]
    g = torch.cat([g[:-1] + Etr, g[-1:]])   # J_k = -E  => g_k += E^T r w
    g = torch.cat([g[:1], g[1:] - Etr])     # J_{k+1} = +E => g_{k+1} -= E^T r w
    g = torch.cat([g[:1] + prior_g, g[1:]])

    # dense assembly in [K, K, 6, 6] blocks (K is tiny)
    ar = torch.arange(K, device=dev)
    Hb = torch.zeros((K, K, 6, 6), dtype=torch.float32, device=dev)
    Hb[ar, ar] = diag
    Hb.index_put_((ar[:-1], ar[1:]), -EtE, accumulate=True)
    Hb.index_put_((ar[1:], ar[:-1]), -EtE, accumulate=True)
    Hm = Hb.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    g = g.reshape(6 * K)

    dm = torch.diagonal(Hm)
    scale = torch.max(dm) + 1.0
    empty = (~frame_mask).repeat_interleave(6)
    Hm = Hm + torch.diag(damping * dm + 1e-6 * scale + empty * scale)
    delta = solve_pos(Hm, g)
    delta = torch.where(torch.isfinite(delta), delta, 0.0)
    return delta.reshape(K, 6)


def _prior_gradient(win: BAWindow, pose0: torch.Tensor) -> torch.Tensor:
    """The prior's gradient re-anchored at the current pose-0 estimate:
    g_p = prior_b - prior_H log(T0_cur T0_lin^-1)."""
    rp = log_se3(compose(pose0, invert_se3(win.prior_T0)))
    return win.prior_b - torch.matmul(win.prior_H, rp)


def refine_window(
    win: BAWindow,
    at: ActiveTable,
    time,
    cam: CameraIntrinsics,
    params: PipelineParams,
    stride: int = 4,
    iters: int = 3,
    odo_weight: float = 1e4,
    max_residual: float = 0.5,
    huber_delta: float = 0.05,
    damping: float = 1e-2,
    group=None,
):
    """Gauss-Newton over the whole window against the active table ``at``
    (``ops.active.table_from_map(smap)`` for a whole map).  Only the
    occupied frames are associated (one K1 call each per iteration).  With
    ``group`` (a parallel.distributed.Comm) the per-frame (A, b, n_inliers)
    are summed over its ranks before the normalization.

    Returns (window with refined poses, {"inliers": 0-d device tensor})."""
    K = win.poses.shape[0]
    dev = win.poses.device
    nv = min(win.n_valid, K)
    frame_mask = torch.arange(K, device=dev) < nv
    n_valid = at.slot_valid.sum(dtype=torch.int32)  # the valid prefix, once
    odo_w = torch.full((K - 1,), odo_weight, dtype=torch.float32, device=dev)
    poses = win.poses
    n_tot = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(iters):
        blocks = [_frame_to_map_block(at, poses[k], win.v_c[k], win.n_c[k], win.valid[k],
                                      time, cam, params, stride, max_residual, huber_delta,
                                      n_valid) for k in range(nv)]
        pad = K - nv
        dA = torch.stack([b[0] for b in blocks] + [torch.zeros_like(win.prior_H)] * pad)
        db = torch.stack([b[1] for b in blocks] + [torch.zeros_like(win.prior_b)] * pad)
        n_in = torch.stack([b[2] for b in blocks]
                           + [torch.zeros((), dtype=torch.int32, device=dev)] * pad)
        if group is not None:
            # the cross-rank reduction of the per-frame systems (ba.py:274-277)
            sums = group.all_reduce(torch.cat([dA.reshape(-1), db.reshape(-1)]), "sum")
            dA, db = sums[:K * 36].view(K, 6, 6), sums[K * 36:].view(K, 6)
            n_in = group.all_reduce(n_in, "sum")
        norm = _evidence(n_in)
        dA = dA * norm[:, None, None]
        db = db * norm[:, None]

        E, r0 = _odometry_edge(poses[:-1], poses[1:], win.odo[:K - 1])
        delta = _assemble_and_solve(dA, db, E, r0, odo_w, frame_mask, win.prior_H,
                                    _prior_gradient(win, poses[0]), damping)
        # trust region per pose (as ICP's)
        delta = delta * trust_region(delta) * frame_mask[:, None]
        poses = compose(exp_se3(delta), poses)
        n_tot = n_in.sum(dtype=torch.int32)
    return dataclasses.replace(win, poses=poses), {"inliers": n_tot}


# ---------------------------------------------------------------------------
# Sliding / marginalization
# ---------------------------------------------------------------------------

def marginalize_oldest(win: BAWindow, at: ActiveTable, time, cam: CameraIntrinsics,
                       params: PipelineParams, stride: int = 4, odo_weight: float = 1e4):
    """Schur-complement the oldest pose out of the (pre-slide) window system:
    pose 0's map block, the 0-1 odometry edge and pose 0's prior, then

        H' = H_11 - H_10 H_00^-1 H_01,   b' = b_1 - H_10 H_00^-1 b_0

    Returns (prior_H 6x6, prior_b 6, prior_T0 = pose 1) for the slid
    window's new pose 0."""
    n_valid = at.slot_valid.sum(dtype=torch.int32)
    A0, b0, n0 = _frame_to_map_block(at, win.poses[0], win.v_c[0], win.n_c[0], win.valid[0],
                                     time, cam, params, stride, 0.5, 0.05, n_valid)
    norm0 = _evidence(n0)
    A0 = A0 * norm0
    b0 = b0 * norm0
    E, r0 = _odometry_edge(win.poses[0], win.poses[1], win.odo[0])
    EtE = torch.matmul(E.T, E) * odo_weight
    Etr = torch.matmul(E.T, r0) * odo_weight
    g_pr = _prior_gradient(win, win.poses[0])

    H00 = A0 + win.prior_H + EtE
    H11 = EtE
    H01 = -EtE
    g0 = b0 + g_pr + Etr
    g1 = -Etr
    dm = torch.diagonal(H00)
    H00 = H00 + torch.diag(1e-2 * dm + 1e-6 * torch.max(dm) + 1e-9)
    X = solve_pos(H00, torch.cat([H01, g0[:, None]], dim=1))
    Hs = H11 - torch.matmul(H01.T, X[:, :6])
    bs = g1 - torch.matmul(H01.T, X[:, 6])
    ok = torch.all(torch.isfinite(Hs)) & torch.all(torch.isfinite(bs))
    Hs = torch.where(ok, Hs, 0.0)
    bs = torch.where(ok, bs, 0.0)
    Hs = 0.5 * (Hs + Hs.T)  # symmetrize against numerical drift
    return Hs, bs, win.poses[1]


def _set(t: torch.Tensor, i: int, value) -> torch.Tensor:
    """``t`` with row ``i`` replaced (a copy: windows are values)."""
    t = t.clone()
    t[i] = value
    return t


def _slide(t: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    return torch.cat([t[1:], value[None]])


class WindowedBA:
    """Host-side sliding window (surfelmapping_tpu/ba.py:414-549).

    Feed each frame's ICP-preprocessed metric depth and its odometry pose
    (ground truth, ICP output or a motion model); it keeps the window and
    returns the refined newest pose.  Map association runs on an ActiveTable
    the caller provides per frame.  ``device=None`` runs on the card and
    raises without one."""

    def __init__(self, cam: CameraIntrinsics, params: PipelineParams, window: int = 5,
                 stride: int = 4, iters: int = 3, odo_weight: float = 1e4,
                 gauge_weight: float = 1e2, prior_decay: float = 0.0,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        full_precision_matmul()
        self.cam = cam
        self.params = params
        self.K = window
        self.stride = stride
        self.iters = iters
        self.odo_weight = odo_weight
        # Each slide multiplies the Schur prior by this factor.  0.0 discards
        # it: every window pose is absolutely anchored by its map terms, so
        # the prior re-counts old map information at a stale linearization
        # point (surfelmapping_tpu/ba.py:440-449 has the measurements).
        self.prior_decay = prior_decay
        self.P = subsample_count(cam, stride)
        self.win = empty_window(window, self.P, self.device)
        self._gauge = gauge_weight
        # the last RAW odometry pose: edges join consecutive raw estimates, so
        # a BA correction of frame k-1 does not leak into edge (k-1, k)
        self._last_odo: torch.Tensor | None = None
        self.last_diag: dict = {}

    def _pose(self, pose) -> torch.Tensor:
        if not isinstance(pose, torch.Tensor):
            pose = torch.from_numpy(np.asarray(pose, np.float32))
        return pose.to(self.device, torch.float32)

    def push(self, depth_metric: torch.Tensor, pose_odo, at: ActiveTable | None = None,
             time: float = 0.0) -> None:
        """Append a frame; when the window is full, marginalize the oldest
        pose (against ``at``; odometry and a weak prior if ``at`` is None)
        and slide."""
        v, n, ok = subsample_frame(depth_metric, self.cam, self.params, self.stride)
        w, K = self.win, self.K
        nv = w.n_valid
        pose_odo = self._pose(pose_odo)
        prev_odo, self._last_odo = self._last_odo, pose_odo
        if nv == 0:
            self.win = dataclasses.replace(
                w,
                prior_H=torch.eye(6, dtype=torch.float32, device=self.device) * self._gauge,
                prior_b=torch.zeros_like(w.prior_b),
                prior_T0=pose_odo,
                poses=_set(w.poses, 0, pose_odo),
                v_c=_set(w.v_c, 0, v), n_c=_set(w.n_c, 0, n), valid=_set(w.valid, 0, ok),
                n_valid=1,
            )
            return
        if prev_odo is None:
            prev_odo = pose_odo  # identity relative motion
        z = compose(invert_se3(prev_odo), pose_odo)
        if nv < K:
            # the initial estimate chains the raw relative motion onto the
            # refined previous estimate
            self.win = dataclasses.replace(
                w,
                poses=_set(w.poses, nv, compose(w.poses[nv - 1], z)),
                v_c=_set(w.v_c, nv, v), n_c=_set(w.n_c, nv, n), valid=_set(w.valid, nv, ok),
                odo=_set(w.odo, nv - 1, z),
                n_valid=nv + 1,
            )
            return
        # full window: Schur-marginalize pose 0, then slide
        if at is not None:
            Hs, bs, T0 = marginalize_oldest(w, at, time, self.cam, self.params, self.stride,
                                            self.odo_weight)
            Hs = Hs * self.prior_decay
            bs = bs * self.prior_decay
        else:
            Hs = torch.eye(6, dtype=torch.float32, device=self.device) * min(self._gauge, 1e4)
            bs = torch.zeros_like(w.prior_b)
            T0 = w.poses[1]
        self.win = dataclasses.replace(
            w,
            poses=_slide(w.poses, compose(w.poses[K - 1], z)),
            v_c=_slide(w.v_c, v), n_c=_slide(w.n_c, n), valid=_slide(w.valid, ok),
            odo=_slide(w.odo, z),
            prior_H=Hs, prior_b=bs, prior_T0=T0,
        )

    def refine(self, at: ActiveTable, time: float, group=None) -> np.ndarray:
        """Gauss-Newton over the window (its evidence summed over ``group``'s
        ranks, if given); returns the refined newest pose (4x4, read back to
        the host)."""
        self.win, diag = refine_window(self.win, at, time, self.cam, self.params,
                                       self.stride, self.iters, self.odo_weight,
                                       group=group)
        self.last_diag = {k: int(v) for k, v in diag.items()}
        return self.win.poses[min(self.win.n_valid, self.K) - 1].cpu().numpy()

    def poses_out(self) -> np.ndarray:
        """Current window pose estimates [n_valid, 4, 4]."""
        return self.win.poses[:self.win.n_valid].cpu().numpy()
