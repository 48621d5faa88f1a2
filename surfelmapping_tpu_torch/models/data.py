"""SPADE inference data on the host (counterpart of the inference half of
surfelmapping_tpu/models/data.py), numpy and PIL as there.

  * bad-frame skip list: the reference drops hardcoded KITTI frame-id ranges
    at load time (kitti_dataset.py:126-139);
  * SingleDataset semantics for inference (label only, 1248-wide crops at
    aspect 3.25, start_frame_id skip, single_dataset.py:23-40);
  * the final composite: GAN pixels in the render's holes
    (SPADE/postprocess.py:44-57).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
from PIL import Image

# The reference's hardcoded bad-frame id ranges for its KITTI sequence
# (SPADE/data/kitti_dataset.py:126-139): inclusive [lo, hi] pairs.
KITTI_BAD_FRAME_RANGES: tuple[tuple[int, int], ...] = (
    (0, 56), (69, 134), (840, 1306), (1674, 1705),
)


def _frame_id(name: str) -> int | None:
    try:
        return int(name.split(".")[0])
    except ValueError:
        return None


def in_skip_ranges(name: str, ranges) -> bool:
    fid = _frame_id(name)
    if fid is None:
        return False
    return any(lo <= fid <= hi for lo, hi in ranges)


@dataclass
class SingleRenderDataset:
    """Inference dataset: rendered labels only, deterministic order
    (reference SingleDataset, SPADE/data/single_dataset.py:23-40 — KITTI
    defaults crop_size=1248, aspect_ratio=3.25, i.e. 1248x384 center-crops,
    frames before ``start_frame_id`` skipped)."""

    label_dir: str
    crop_size: int = 1248
    aspect_ratio: float = 3.25
    start_frame_id: int = 0

    def __post_init__(self):
        names = sorted(os.listdir(self.label_dir))
        self.names = [
            n for n in names
            if (_frame_id(n) is None or _frame_id(n) >= self.start_frame_id)
        ]
        self.out_h = int(round(self.crop_size / self.aspect_ratio))

    def __len__(self) -> int:
        return len(self.names)

    def __iter__(self):
        for name in self.names:
            yield name, self.load(name)

    def load(self, name: str) -> np.ndarray:
        """float32 HWC label in [-1, 1], resized/cropped to
        (crop_size/aspect, crop_size)."""
        lab = Image.open(os.path.join(self.label_dir, name)).convert("RGB")
        w, h = lab.size
        cw, ch = self.crop_size, self.out_h
        scale = max(cw / w, ch / h)
        nw, nh = int(round(w * scale)), int(round(h * scale))
        lab = lab.resize((nw, nh), Image.NEAREST)
        x = (nw - cw) // 2
        y = (nh - ch) // 2
        arr = np.asarray(lab)[y : y + ch, x : x + cw]
        return arr.astype(np.float32) / 127.5 - 1.0


def postprocess_composite(
    rendered: np.ndarray, generated: np.ndarray, semantic: np.ndarray
) -> np.ndarray:
    """Final composite: where the rendered semantic is 0 (hole/sky) take the
    GAN pixel, else keep the rendered pixel (SPADE/postprocess.py:44-57)."""
    hole = semantic == 0
    out = rendered.copy()
    out[hole] = generated[hole]
    return out
