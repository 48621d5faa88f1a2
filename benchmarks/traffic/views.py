"""Generator ``views``: a stream of novel views around a mapped stretch of a
drive, as ``load_map --mode random`` asks for them (load_map.cpp:132-173):
a base pose drawn from the stretch, moved by a uniform offset in x and z
and turned by a uniform yaw about the reference's (0, -1, 0) axis.  A copy
of ``surfelmapping_tpu_torch/views.py:random_novel_views`` (commit dd68e64)
drawn as an endless stream from the seed."""

from __future__ import annotations

import numpy as np


def yaw_about_minus_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], dtype=np.float32)
    return T


def translate(x: float, y: float, z: float) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [x, y, z]
    return T


class NovelViews:
    """Camera-to-world f32[4,4] views; ``stream`` separates independent
    streams of one seed (the warm-up's from the window's)."""

    def __init__(self, base_poses: list[np.ndarray], traffic: dict, seed: int, stream: int = 0):
        self.base = np.asarray(base_poses, np.float32)
        self.mix = traffic
        self.rng = np.random.default_rng([seed, stream])

    def next(self) -> np.ndarray:
        m, rng = self.mix, self.rng
        v = self.base[rng.integers(0, len(self.base))]
        x_off = rng.uniform(-m["max_x_m"], m["max_x_m"])
        z_off = rng.uniform(-m["max_z_m"], m["max_z_m"])
        theta = np.deg2rad(rng.uniform(-m["max_yaw_deg"], m["max_yaw_deg"]))
        return (v @ (translate(x_off, 0.0, z_off) @ yaw_about_minus_y(theta))).astype(np.float32)
