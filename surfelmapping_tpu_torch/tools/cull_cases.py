"""Inputs of the render cull's visibility pass (``ops/visible_blocks``) for
holding its CUDA kernel to the plain form: the card tests, the CPU tests
and chip_smoke's ``cull`` phase.

A case is a map of ``n`` slots (the columns px, py, pz, conf), a
camera-to-world pose and a camera, made from a seed.  Each block of the map
plays one part, drawn at random:

  * dead: conf 0 at the origin, as padding and compaction leave slots;
  * tombstoned: conf 0, -0.0 or negative, at positions in view;
  * non-finite: conf > 0 in view, one coordinate of each slot NaN or
    infinite;
  * probe: one slot on a gate (z = 1 or max_depth, u or v on the padded
    image's edge), placed in the camera frame in float64 and rounded into
    the world, so that float32 puts it a few ulps to either side; the
    block's other slots are live but behind the camera, so the block's
    answer is that slot's;
  * scattered: slots in and around the frustum, conf of either sign.

``random`` takes a random pose and KITTI's intrinsics.  ``gates`` takes a
pose with no rotation and a translation of halves, and a camera on which
u = x and v = y at z = 64, so camera coordinates round-trip exactly: its
first blocks hold one probe each (:data:`GATE_PROBES`), exactly on a gate
or one ulp to either side of it, besides a live slot of conf 0, -0.0, a
subnormal or NaN, and non-finite coordinates; the rest of its blocks are
drawn as above.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import CameraIntrinsics
from ..io.synthetic import kitti_cam
from ..surfels import COLUMNS, SurfelMap

CASES = ("random", "gates")
MAX_DEPTH, MARGIN = 200.0, 8
GATES_CAM = CameraIntrinsics(fx=64.0, fy=64.0, cx=0.0, cy=0.0, width=128, height=96)
GATES_SHIFT = (0.5, 0.5, -0.5)  # the gates pose's translation


def _gate_probes() -> list[tuple[float, float, float, float, bool]]:
    """(x, y, z, conf, visible) in GATES_CAM's frame: each gate's value and
    its neighbours one ulp inside and outside, then the special slots."""
    f32, inf = np.float32, np.inf
    W, H, m = GATES_CAM.width, GATES_CAM.height, MARGIN
    probes = []
    for gate, inside, on_visible in ((1.0, inf, False), (MAX_DEPTH, -inf, False)):
        z = f32(gate)  # at x = y = 1: u = v = 64 / z, in the image
        probes += [(1.0, 1.0, z, 1.0, on_visible), (1.0, 1.0, np.nextafter(z, f32(inside)), 1.0, True),
                   (1.0, 1.0, np.nextafter(z, f32(-inside)), 1.0, False)]
    for axis, gate, inside in ((0, -m, inf), (0, W + m, -inf), (1, -m, inf), (1, H + m, -inf)):
        for c, visible in ((f32(gate), True), (np.nextafter(f32(gate), f32(inside)), True),
                           (np.nextafter(f32(gate), f32(-inside)), False)):
            xy = [10.0, 10.0]
            xy[axis] = c
            probes.append((xy[0], xy[1], 64.0, 1.0, visible))
    sub = np.nextafter(f32(0), f32(1))
    probes += [(10.0, 10.0, 64.0, 0.0, False), (10.0, 10.0, 64.0, -0.0, False),
               (10.0, 10.0, 64.0, sub, True), (10.0, 10.0, 64.0, np.nan, False),
               (np.nan, 10.0, 64.0, 1.0, False), (10.0, 10.0, inf, 1.0, False),
               (inf, 10.0, 64.0, 1.0, False)]
    return probes


GATE_PROBES = _gate_probes()


@dataclasses.dataclass
class CullCase:
    px: torch.Tensor          # f32[n]
    py: torch.Tensor
    pz: torch.Tensor
    conf: torch.Tensor
    view: torch.Tensor        # f32[4, 4], camera to world
    cam: CameraIntrinsics
    gate_blocks: torch.Tensor  # i64: the blocks holding one of GATE_PROBES each
    gate_visible: torch.Tensor  # bool: whether each of them is visible

    def columns(self) -> tuple[torch.Tensor, ...]:
        return self.px, self.py, self.pz, self.conf

    def surfel_map(self) -> SurfelMap:
        """The case as a map, every slot below the cursor, the other
        columns zero."""
        n = self.px.shape[0]
        dev = self.px.device
        cols = {k: torch.zeros(n + 1, dtype=torch.int32 if k == "colorsem" else torch.float32,
                               device=dev) for k in COLUMNS}
        for k, c in zip(("px", "py", "pz", "conf"), self.columns()):
            cols[k][:n] = c
        return SurfelMap(**cols, count=torch.tensor(n, dtype=torch.int32, device=dev))


def _random_pose(rng: np.random.Generator) -> np.ndarray:
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    q[:, 0] *= np.sign(np.linalg.det(q))
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = q, rng.uniform(-20.0, 20.0, 3)
    return T.astype(np.float32)


def _camera_points(cam: CameraIntrinsics, z, u, v) -> np.ndarray:
    """Camera-frame points (float64, [n, 3]) at depth z projecting to (u, v)."""
    return np.stack([(u - cam.cx) * z / cam.fx, (v - cam.cy) * z / cam.fy, z], axis=1)


def cull_case(name: str, n: int, block_size: int, seed: int = 0,
              device: torch.device | str = "cpu") -> CullCase:
    """The case ``name`` over ``n`` slots in blocks of ``block_size``."""
    if name not in CASES:
        raise ValueError(f"unknown cull case {name!r}")
    if n % block_size:
        raise ValueError(f"{n} slots are not whole blocks of {block_size}")
    rng = np.random.default_rng(seed)
    G = n // block_size
    if name == "gates":
        cam, view = GATES_CAM, np.eye(4, dtype=np.float32)
        view[:3, 3] = GATES_SHIFT
        if G < len(GATE_PROBES):
            raise ValueError(f"gates: {G} blocks hold fewer than {len(GATE_PROBES)} probes")
    else:
        cam, view = kitti_cam(), _random_pose(rng)
    W, H, m = cam.width, cam.height, MARGIN

    part = np.repeat(rng.choice(5, G, p=[0.25, 0.15, 0.1, 0.3, 0.2]), block_size)
    z = np.exp(rng.uniform(np.log(1.5), np.log(150.0), n))
    u, v = rng.uniform(-m, W + m, n), rng.uniform(-m, H + m, n)
    conf = rng.uniform(0.1, 10.0, n)
    scat = part == 4
    z[scat] = rng.uniform(-20.0, 1.25 * MAX_DEPTH, scat.sum())
    u[scat] = rng.uniform(-W, 2 * W, scat.sum())
    v[scat] = rng.uniform(-H, 2 * H, scat.sum())
    conf[scat] = rng.uniform(-1.0, 1.0, scat.sum())
    probe = part == 3
    z[probe] = rng.uniform(-50.0, -1.0, probe.sum())  # live, behind the camera
    cam_pts = _camera_points(cam, z, u, v)
    # one slot of each probe block on a gate, in float64
    pblk = np.flatnonzero(probe[::block_size])
    slot = pblk * block_size + rng.integers(0, block_size, pblk.size)
    gate = rng.integers(0, 6, pblk.size)
    gz = np.where(gate == 0, 1.0, np.where(gate == 1, MAX_DEPTH, rng.uniform(2.0, 150.0, pblk.size)))
    gu = np.where(gate == 2, -m, np.where(gate == 3, W + m, rng.uniform(0, W, pblk.size)))
    gv = np.where(gate == 4, -m, np.where(gate == 5, H + m, rng.uniform(0, H, pblk.size)))
    cam_pts[slot] = _camera_points(cam, gz, gu, gv)

    pose = view.astype(np.float64)
    world = (cam_pts @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)
    conf = conf.astype(np.float32)
    dead = part == 0
    world[dead], conf[dead] = 0.0, 0.0
    tomb = np.flatnonzero(part == 1)
    conf[tomb] = rng.choice(np.array([0.0, -0.0, -1.0, -1e-30], np.float32), tomb.size)
    bad = np.flatnonzero(part == 2)
    world[bad, rng.integers(0, 3, bad.size)] = rng.choice(
        np.array([np.nan, np.inf, -np.inf], np.float32), bad.size)

    gate_blocks = np.zeros(0, np.int64)
    gate_visible = np.zeros(0, bool)
    if name == "gates":
        gate_blocks = np.arange(len(GATE_PROBES))
        span = slice(0, len(GATE_PROBES) * block_size)
        world[span], conf[span] = 0.0, 0.0
        probes = np.array([p[:4] for p in GATE_PROBES], np.float32)
        slot = gate_blocks * block_size + rng.integers(0, block_size, gate_blocks.size)
        world[slot] = probes[:, :3] + np.array(GATES_SHIFT, np.float32)  # exact: halves on each grid
        conf[slot] = probes[:, 3]
        gate_visible = np.array([p[4] for p in GATE_PROBES])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return CullCase(t(world[:, 0]), t(world[:, 1]), t(world[:, 2]), t(conf), t(view), cam,
                    t(gate_blocks), t(gate_visible))
