"""Inputs of the association stage (``ops/active.associate_active``) for
holding its CUDA kernel to the plain version: the card tests, the CPU tests
and chip_smoke's ``associate`` phase.

A case is a frame (depth, colour, classes), an active table and the index
image that points the frame's pixels into the table, made from a seed:

  * ``surface``: a smooth surface whose own surfels, a few mm off, fill the
    table, so most pixels pass every gate and merge; a tenth of the table
    are tombstones (conf <= 0), padding slots follow the valid ones, slot 0
    has global id 0; a tenth of the index pixels are empty (-1) and a tenth
    point at a random slot (a tombstone, a padding slot or slot 0 among
    them); colours outside [0, 1] and on the half levels of the rounding;
  * ``surface_f2``: the same with index_factor 2 (four windows a pixel);
  * ``sky_moving``: the surface with a sky band and car and person blocks;
  * ``random``: random depths, holes, classes and table rows, index_factor
    2, a loose depth gate;
  * ``kitti``: ``surface`` at KITTI's 1226x370 (``io.synthetic.kitti_cam``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import CameraIntrinsics, PipelineParams
from ..io.synthetic import CAR_CLASS, SKY_CLASS, kitti_cam
from ..ops.active import ActiveTable
from ..ops.transforms import invert_se3

PERSON_CLASS = 11
# case -> (H, W, index_factor, fuse_thresh)
CASES = {"surface": (64, 96, 1, 0.05), "surface_f2": (64, 96, 2, 0.05),
         "sky_moving": (64, 96, 1, 0.5), "random": (48, 64, 2, 0.5),
         "kitti": (370, 1226, 1, 0.05)}
PADDING = 500  # table slots past the valid ones


def _pose(rng: np.random.Generator) -> np.ndarray:
    yaw = rng.uniform(-0.2, 0.2)
    c, s = np.cos(yaw), np.sin(yaw)
    pose = np.eye(4)
    pose[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    pose[:3, 3] = rng.uniform(-1.0, 1.0, 3)
    return pose.astype(np.float32)


def _surface(rng, cam: CameraIntrinsics, pose: np.ndarray, sky_moving: bool):
    """Depth, classes and the table's rows (world frame, one per pixel)."""
    H, W = cam.height, cam.width
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    depth = 6.0 + 2.0 * np.sin(u / (W / 6.0)) + v / (H / 5.0)
    sem = (u // 16 % 5).astype(np.int32)
    if sky_moving:
        sem[: H // 4] = SKY_CLASS
        sem[H // 2:, : W // 4] = CAR_CLASS
        sem[H // 2:, W // 2: W // 2 + W // 8] = PERSON_CLASS
    # camera-frame points and central-difference normals of the surface
    X = (u + 0.5 - cam.cx) * depth / cam.fx
    Y = (v + 0.5 - cam.cy) * depth / cam.fy
    P = np.stack([X, Y, depth], -1)
    n = np.cross(np.gradient(P, axis=1), np.gradient(P, axis=0))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    R, t = pose[:3, :3].astype(np.float64), pose[:3, 3].astype(np.float64)
    world = P.reshape(-1, 3) @ R.T + t + rng.normal(0.0, 0.003, (H * W, 3))
    normal = n.reshape(-1, 3) @ R.T + rng.normal(0.0, 0.05, (H * W, 3))
    radius = depth.reshape(-1) * np.sqrt(2.0) / cam.fx * rng.uniform(0.4, 1.2, H * W)
    depth[rng.uniform(size=(H, W)) < 0.03] = 0.0
    depth[rng.uniform(size=(H, W)) < 0.01] = 40.0  # past far_clip
    return depth, sem, world, normal, radius


def _random(rng, cam: CameraIntrinsics, pose: np.ndarray):
    H, W = cam.height, cam.width
    depth = np.round(rng.uniform(0.5, 35.0, (H, W)) * 4.0) / 4.0
    depth[rng.uniform(size=(H, W)) < 0.1] = 0.0
    sem = rng.integers(0, 19, (H, W)).astype(np.int32)
    v, u, z = rng.uniform(0, H, H * W), rng.uniform(0, W, H * W), rng.uniform(1.0, 30.0, H * W)
    P = np.stack([(u - cam.cx) * z / cam.fx, (v - cam.cy) * z / cam.fy, z], -1)
    world = P @ pose[:3, :3].T.astype(np.float64) + pose[:3, 3]
    normal = rng.normal(size=(H * W, 3))
    return depth, sem, world, normal, rng.uniform(0.01, 0.3, H * W)


def association_case(case: str, device, seed: int = 0) -> tuple:
    """``associate_active``'s positional arguments for ``case`` on ``device``:
    (depth, rgb, semantic, index_image, table, pose, T_inv, time, cam,
    params); the depth gate's threshold is ``params.fuse_thresh_factor``."""
    H, W, F, fuse_thresh = CASES[case]
    rng = np.random.default_rng(seed)
    cam = (kitti_cam() if case == "kitti" else
           CameraIntrinsics(fx=150.0, fy=149.0, cx=W / 2 + 0.25, cy=H / 2 - 0.5, width=W,
                            height=H))
    params = PipelineParams(fuse_thresh_factor=fuse_thresh, index_factor=F)
    pose = _pose(rng)
    if case == "random":
        depth, sem, world, normal, radius = _random(rng, cam, pose)
    else:
        depth, sem, world, normal, radius = _surface(rng, cam, pose, case == "sky_moving")
    rgb = rng.uniform(-0.1, 1.1, (H, W, 3))
    rgb[::7, ::5, 1] = (rng.integers(0, 255, rgb[::7, ::5, 1].shape) + 0.5) / 255.0

    # the table: pixel p's surfel in slot perm[p], then the padding slots
    n, A = H * W, H * W + PADDING
    perm = rng.permutation(n)

    def column(values, pad):
        out = np.empty(A)
        out[perm] = values
        out[n:] = pad
        return out.astype(np.float32)

    conf = rng.uniform(0.5, 4.0, n)
    dead = rng.uniform(size=n) < 0.1
    conf[dead] = rng.uniform(-2.0, 0.0, int(dead.sum()))  # tombstones
    colour = rng.integers(0, 1 << 24, n)
    colorsem = np.empty(A, np.int32)
    colorsem[perm] = ((sem.reshape(-1).astype(np.int64) << 24) | colour).astype(
        np.uint32).view(np.int32)
    colorsem[n:] = rng.integers(0, 1 << 24, PADDING)
    rand = rng.uniform(-5.0, 5.0, (PADDING, 3))
    cols = dict(x=column(world[:, 0], rand[:, 0]), y=column(world[:, 1], rand[:, 1]),
                z=column(world[:, 2], rand[:, 2]), conf=column(conf, 1.0),
                init_t=column(rng.uniform(0, 5, n), 0.0), last_t=column(rng.uniform(0, 7, n), 0.0),
                nx=column(normal[:, 0], 0.0), ny=column(normal[:, 1], 0.0),
                nz=column(normal[:, 2], 1.0), radius=column(radius, 0.05))
    # the index image: each window holds its pixel's slot, or -1, or any slot
    own = np.repeat(np.repeat(perm.reshape(H, W), F, 0), F, 1)
    r = rng.uniform(size=own.shape)
    index = np.where(r < 0.1, -1, np.where(r > 0.9, rng.integers(0, A, own.shape), own))

    def dev(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    table = ActiveTable(**{k: dev(v) for k, v in cols.items()}, colorsem=dev(colorsem),
                        global_id=torch.arange(A, device=device),
                        slot_valid=torch.arange(A, device=device) < n,
                        blk=torch.zeros(0, dtype=torch.int64, device=device))
    pose_t = dev(pose)
    return (dev(depth, np.float32), dev(rgb, np.float32), dev(sem), dev(index, np.int64),
            table, pose_t, invert_se3(pose_t), 7.0, cam, params)


def differing_columns(got, want) -> dict[str, int]:
    """The AssocFlat columns of ``got`` whose bits differ from ``want``'s,
    with the count of entries that differ (floats compared as their bits,
    so a NaN equals the same NaN)."""
    bad = {}
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if w.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if not torch.equal(g, w):
            bad[f.name] = int((g != w).sum())
    return bad
