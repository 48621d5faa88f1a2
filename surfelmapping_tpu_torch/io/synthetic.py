"""Procedural KITTI-like scene generator for tests and benchmarks.

A numpy-only copy of surfelmapping_tpu/io/synthetic.py (the port imports
nothing of the JAX package).  It ray-casts a simple driving scene (ground
plane, side walls = "buildings", a floating "car" box) from a
forward-moving camera, producing the frame tuple the reference's
KittiReader yields (rgb u8[H,W,3], depth u16[H,W] mm, semantic u8[H,W],
gt pose f32[4,4]) with the same camera conventions (x right, y down,
z forward; ground at y = +height).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import CameraIntrinsics

GROUND_CLASS = 0      # road
BUILDING_CLASS = 2
CAR_CLASS = 13
SKY_CLASS = 10


@dataclasses.dataclass
class SyntheticScene:
    cam: CameraIntrinsics
    ground_y: float = 1.6
    wall_x: float = 8.0
    car_center: tuple[float, float, float] = (2.0, 0.8, 14.0)
    car_half: tuple[float, float, float] = (1.0, 0.8, 2.0)
    step: float = 0.8  # forward metres per frame
    noise_mm: float = 0.0
    # additional BUILDING_CLASS boxes ((center), (half)) — static structures
    extra_boxes: tuple = ()

    def pose(self, frame: int) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[2, 3] = frame * self.step
        return T

    def _raycast(self, T: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Returns (depth_m f32[H,W], semantic u8[H,W]) in the camera frame of
        pose T (camera-to-world)."""
        cam = self.cam
        H, W = cam.height, cam.width
        x = (np.arange(W, dtype=np.float64)[None, :] + 0.5 - cam.cx) / cam.fx
        y = (np.arange(H, dtype=np.float64)[:, None] + 0.5 - cam.cy) / cam.fy
        dx = np.broadcast_to(x, (H, W))
        dy = np.broadcast_to(y, (H, W))
        dz = np.ones((H, W))

        R = T[:3, :3].astype(np.float64)
        t = T[:3, 3].astype(np.float64)
        # world-frame ray directions and origin
        wx = R[0, 0] * dx + R[0, 1] * dy + R[0, 2] * dz
        wy = R[1, 0] * dx + R[1, 1] * dy + R[1, 2] * dz
        wz = R[2, 0] * dx + R[2, 1] * dy + R[2, 2] * dz

        best_t = np.full((H, W), np.inf)
        sem = np.full((H, W), SKY_CLASS, np.uint8)

        def consider(t_hit: np.ndarray, mask: np.ndarray, cls: int):
            nonlocal best_t, sem
            ok = mask & (t_hit > 0.1) & (t_hit < best_t)
            best_t = np.where(ok, t_hit, best_t)
            sem = np.where(ok, np.uint8(cls), sem)

        # ground plane y = ground_y (y down -> below camera)
        denom = np.where(np.abs(wy) < 1e-9, 1e-9, wy)
        t_ground = (self.ground_y - t[1]) / denom
        consider(t_ground, wy > 1e-6, GROUND_CLASS)

        # two side walls x = +-wall_x
        for sign in (-1.0, 1.0):
            denom = np.where(np.abs(wx) < 1e-9, 1e-9, wx)
            t_wall = (sign * self.wall_x - t[0]) / denom
            consider(t_wall, np.abs(wx) > 1e-6, BUILDING_CLASS)

        # axis-aligned boxes (slab method): the car + any extra structures
        def box(center, half, cls):
            c = np.asarray(center)
            h = np.asarray(half)
            tmin = np.full((H, W), -np.inf)
            tmax = np.full((H, W), np.inf)
            for axis, (wdir, orig) in enumerate(
                [(wx, t[0]), (wy, t[1]), (wz, t[2])]
            ):
                denom = np.where(np.abs(wdir) < 1e-9, 1e-9, wdir)
                t1 = (c[axis] - h[axis] - orig) / denom
                t2 = (c[axis] + h[axis] - orig) / denom
                tmin = np.maximum(tmin, np.minimum(t1, t2))
                tmax = np.minimum(tmax, np.maximum(t1, t2))
            consider(tmin, tmax >= tmin, cls)

        box(self.car_center, self.car_half, CAR_CLASS)
        for center, half in self.extra_boxes:
            box(center, half, BUILDING_CLASS)

        # camera-frame depth: z component of the hit point in camera coords
        depth = np.where(np.isfinite(best_t), best_t * dz, 0.0)
        return depth.astype(np.float32), sem

    def frame(self, idx: int, rng: np.random.Generator | None = None):
        """Returns (rgb u8[H,W,3], depth_mm u16[H,W], semantic u8[H,W],
        pose f32[4,4])."""
        T = self.pose(idx)
        depth_m, sem = self._raycast(T)
        depth_mm = np.clip(depth_m * 1000.0, 0, 65535)
        if self.noise_mm and rng is not None:
            depth_mm = depth_mm + rng.normal(0, self.noise_mm, depth_mm.shape)
        depth_mm = np.clip(depth_mm, 0, 65535).astype(np.uint16)
        # deterministic class-keyed colors with a mild shading by depth
        base = np.array(
            [[90, 90, 95], [200, 60, 200], [120, 110, 100], [70, 130, 180]],
            np.float32,
        )
        key = np.select(
            [sem == GROUND_CLASS, sem == BUILDING_CLASS, sem == CAR_CLASS],
            [0, 2, 1],
            default=3,
        )
        shade = np.clip(1.0 - depth_m / 80.0, 0.3, 1.0)[..., None]
        rgb = np.clip(base[key] * shade, 0, 255).astype(np.uint8)
        return rgb, depth_mm, sem, T


def corridor_scene(cam: CameraIntrinsics) -> SyntheticScene:
    """The JAX package's tracking experiment scene (tools/record_parity.py:
    101-107): a corridor of 12 boxes alternating left and right along the
    trajectory, 0.5 m per frame.  The bare ground-and-walls scene leaves the
    forward translation unconstrained, and ICP drifts along z there."""
    boxes = tuple((((-4.0 if i % 2 else 4.5), 0.6, 6.0 + 5.0 * i), (1.0, 1.0, 1.2))
                  for i in range(12))
    return SyntheticScene(cam, step=0.5, extra_boxes=boxes)


def tiny_cam(width: int = 128, height: int = 96) -> CameraIntrinsics:
    return CameraIntrinsics(
        fx=100.0, fy=100.0, cx=width / 2.0, cy=height / 2.0,
        width=width, height=height,
    )


def kitti_cam() -> CameraIntrinsics:
    """KITTI-odometry-like intrinsics (seq 00 camera 2, approx)."""
    return CameraIntrinsics(
        fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, width=1226, height=370
    )


# Cases of the preprocess stencil kernel against its plain version, as
# (H, W, stereo border, smooth radius, class): the KITTI shape; shapes that
# are not multiples of the kernel's tile (30 columns, 14 rows); radii 0, 1,
# 3, 6; borders 0 and 80; one class everywhere (the gated-class sentinel must
# not match it); the class INT32_MIN (the sentinel itself: the general path).
STENCIL_CASES = [(70, 200, 16.0, 6, None), (37, 200, 0.0, 6, None), (370, 1226, 80.0, 6, None),
                 (45, 97, 0.0, 1, None), (31, 61, 16.0, 0, None), (17, 300, 80.0, 3, None),
                 (29, 33, 3.0, 6, 4), (370, 1226, 80.0, 6, 7), (53, 127, 0.0, 6, -2**31)]


def stencil_frame(H: int, W: int, rng: np.random.Generator,
                  cls: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """A metric depth f32[H,W] and class i32[H,W] frame for the preprocess
    stencil: class edges, holes, far and near outliers.  ``cls`` puts one
    class everywhere; INT32_MIN goes over the top half, class 5 below."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = 5.0 + 4.0 * np.sin(x / 37.0) + 0.002 * y * x / W
    depth[:, W // 2:] += 3.0
    depth[rng.random((H, W)) < 0.03] = 0.0
    depth[rng.random((H, W)) < 0.01] = 150.0
    depth[rng.random((H, W)) < 0.01] = 0.5
    sem = np.zeros((H, W), np.int32)
    sem[:, : W // 3] = 1
    sem[H // 2:, :] += 2
    sem[: H // 8, 2 * W // 3:] = 10
    sem[rng.random((H, W)) < 0.01] = 11
    if cls is not None:
        sem[:] = cls
    if cls == -2**31:
        sem[H // 2:] = 5
    return depth.astype(np.float32), sem
