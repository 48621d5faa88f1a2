"""Generator ``drive``: a KITTI-like stereo drive through a procedural street,
made on the device from the seed.

A torch rewrite of ``surfelmapping_tpu_torch/io/synthetic.py``'s ray caster
(ground plane, walls on both sides) with seeded boxes on both sides of the
road.  The camera drives straight down +z, ``step_m`` per frame, with the
KITTI axes (x right, y down, z forward).  The street is periodic: one period
of ``period_frames`` frames is ray-cast in set-up, and frame t shows the
image of frame t mod period from the pose of frame t, so the map keeps
growing as on a real drive and never revisits a place.

The seed decides the order of the configuration's boxes along each side,
their jitter along the road, and the depth noise.  Every seed draws the
same boxes, so the work a seed gives is the same, in another order.

Depth noise: the configuration's disparity noise in pixels, smooth across
the image (drawn on a coarse grid and upsampled bilinearly, as a stereo
network's errors are), so depth z reads f*b / (f*b/z + n).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

GROUND, BUILDING, SKY = 0, 2, 10
# base colour of each class (ground, building, car, sky), shaded by depth
COLOURS = {0: (90, 90, 95), 2: (120, 110, 100), 13: (200, 60, 200), 10: (70, 130, 180)}
NOISE_CELL_PX = 8  # the disparity noise's correlation length


def box_layout(scene: dict, period_m: float, rng: np.random.Generator) -> list[tuple]:
    """The boxes of one period as (centre xyz, half xyz, class): for each
    side, the configuration's kinds dealt to the side's slots in an order
    drawn from the seed, each jittered along the road."""
    slot = scene["slot_m"]
    n_slots = int(round(period_m / slot))
    boxes = []
    for sign in (-1.0, 1.0):
        kinds = [k for k in scene["boxes"] for _ in range(k["per_side"])]
        if len(kinds) > n_slots:
            raise ValueError(f"{len(kinds)} boxes per side, {n_slots} slots")
        kinds += [None] * (n_slots - len(kinds))
        order = rng.permutation(n_slots)
        jitter = rng.uniform(-scene["jitter_m"], scene["jitter_m"], n_slots)
        for i in range(n_slots):
            k = kinds[order[i]]
            if k is None:
                continue
            half = tuple(k["half_m"])
            centre = (sign * k["offset_m"], scene["ground_y_m"] - half[1],
                      (i + 0.5) * slot + jitter[i])
            boxes.append((centre, half, k["class"]))
    return boxes


class Drive:
    """One period of frames on ``device``; :meth:`frame` gives frame t of the
    endless drive as ``SurfelMapper.process_frame`` takes it."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, chunk: int = 25):
        cam = config["camera"]
        self.H, self.W = cam["height"], cam["width"]
        self.step = float(traffic["step_m"])
        self.period = int(traffic["period_frames"])
        period_m = self.period * self.step
        rng = np.random.default_rng(seed)
        scene = config["scene"]
        boxes = box_layout(scene, period_m, rng)
        # a box near the period's end is seen again from its start: each box
        # also stands one period further on
        self.boxes = boxes + [((c[0], c[1], c[2] + period_m), h, k) for c, h, k in boxes]
        gen = torch.Generator(device=device)
        gen.manual_seed(int(rng.integers(0, 2**62)))
        fb = cam["fx"] * config["stereo_baseline_m"]
        rgb, depth, sem = [], [], []
        for f0 in range(0, self.period, chunk):
            frames = range(f0, min(f0 + chunk, self.period))
            d, s = self._raycast(cam, scene, frames, device)
            rgb.append(self._colour(d, s))
            depth.append(self._noisy_mm(d, fb, config["disparity_noise_px"], gen))
            sem.append(s)
        self.rgb = torch.cat(rgb)        # u8[F, H, W, 3]
        self.depth = torch.cat(depth)    # i32[F, H, W], u16 millimetres
        self.sem = torch.cat(sem)        # u8[F, H, W]

    def pose(self, t: int) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[2, 3] = t * self.step
        return T

    def frame(self, t: int) -> tuple:
        """(rgb u8[H,W,3], depth i32[H,W] mm, semantic u8[H,W], pose f32[4,4])."""
        i = t % self.period
        return self.rgb[i], self.depth[i], self.sem[i], self.pose(t)

    def _raycast(self, cam: dict, scene: dict, frames, device):
        """Camera-frame depth f32[n,H,W] (0 = no hit) and class u8[n,H,W] of
        ``frames``.  Rays have unit z, so a hit's ray parameter is its depth;
        the camera does not turn, so every slab but z is the same in every
        frame."""
        H, W = self.H, self.W
        x = (torch.arange(W, dtype=torch.float32, device=device) + 0.5 - cam["cx"]) / cam["fx"]
        y = (torch.arange(H, dtype=torch.float32, device=device) + 0.5 - cam["cy"]) / cam["fy"]
        dx = x[None, :].expand(H, W)
        dy = y[:, None].expand(H, W)
        inf = torch.full((H, W), torch.inf, device=device)
        best = inf.clone()
        cls = torch.full((H, W), SKY, dtype=torch.uint8, device=device)

        def consider(best, cls, t_hit, ok, k):
            ok = ok & (t_hit > 0.1) & (t_hit < best)
            return torch.where(ok, t_hit, best), torch.where(ok, k, cls)

        safe = lambda d: torch.where(torch.abs(d) < 1e-9, 1e-9, d)  # noqa: E731
        best, cls = consider(best, cls, scene["ground_y_m"] / safe(dy), dy > 1e-6, GROUND)
        for sign in (-1.0, 1.0):
            best, cls = consider(best, cls, sign * scene["wall_x_m"] / safe(dx),
                                 torch.abs(dx) > 1e-6, BUILDING)
        z0 = torch.tensor([f * self.step for f in frames], device=device)[:, None, None]
        best = best.expand(len(z0), H, W).clone()
        cls = cls.expand(len(z0), H, W).clone()
        reach = scene["max_range_m"]
        lo, hi = float(z0.min()), float(z0.max()) + reach
        for (c, h, k) in self.boxes:
            if c[2] + h[2] < lo or c[2] - h[2] > hi:
                continue
            # the x and y slabs (the origin is on the z axis in every frame)
            tmin, tmax = -inf, inf
            for axis, d in ((0, dx), (1, dy)):
                t1 = (c[axis] - h[axis]) / safe(d)
                t2 = (c[axis] + h[axis]) / safe(d)
                tmin = torch.maximum(tmin, torch.minimum(t1, t2))
                tmax = torch.minimum(tmax, torch.maximum(t1, t2))
            enter = torch.maximum(tmin, c[2] - h[2] - z0)
            leave = torch.minimum(tmax, c[2] + h[2] - z0)
            best, cls = consider(best, cls, enter, leave >= enter, k)
        depth = torch.where(torch.isfinite(best), best, 0.0)
        return depth, cls

    @staticmethod
    def _colour(depth: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
        base = torch.zeros(cls.shape + (3,), dtype=torch.float32, device=cls.device)
        for k, c in COLOURS.items():
            base = torch.where((cls == k)[..., None],
                               torch.tensor(c, dtype=torch.float32, device=cls.device), base)
        shade = torch.clamp(1.0 - depth / 80.0, 0.3, 1.0)[..., None]
        return torch.clamp(base * shade, 0, 255).to(torch.uint8)

    def _noisy_mm(self, depth: torch.Tensor, fb: float, sigma_px: float,
                  gen: torch.Generator) -> torch.Tensor:
        n, H, W = depth.shape
        coarse = torch.randn((n, 1, H // NOISE_CELL_PX + 2, W // NOISE_CELL_PX + 2),
                             generator=gen, device=depth.device) * sigma_px
        noise = F.interpolate(coarse, size=(H, W), mode="bilinear", align_corners=False)[:, 0]
        disp = fb / torch.clamp(depth, min=1e-6) + noise
        noisy = torch.where((depth > 0) & (disp > 0.05), fb / torch.clamp(disp, min=0.05), 0.0)
        return torch.clamp(torch.round(noisy * 1000.0), 0, 65535).to(torch.int32)
