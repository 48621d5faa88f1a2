"""The training batches of LADS's SPADE loader (``SPADE/data/kitti_dataset.py``
with ``util/random_erasing.py``), written plainly: from one numpy
generator seeded as the dataset is, each sample draws its pair (uniformly
over the names the label and image folders share, in sorted order), the
corner of a ``crop`` x ``crop`` crop of the pair resized so its shorter
side is ``load_size``, a horizontal flip (p 0.5) and the label's random
erasing (p 0.8, area 2-30%, aspect 0.2-5, value 0), in that order; the
label is resized nearest, the photo bicubic, and both scaled to [-1, 1]
in float32.  ``batch`` samples make a batch, NHWC.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image


def batches(label_dir: str, image_dir: str, seed: int, batch: int, crop: int,
            load_size: int, keep) -> list[tuple[np.ndarray, np.ndarray]]:
    """The batches numbered in ``keep`` (a range) of the stream, decoded;
    the batches before them are drawn and not decoded."""
    names = sorted(set(os.listdir(label_dir)) & set(os.listdir(image_dir)))
    rng = np.random.default_rng(seed)
    out = []
    for b in range(keep.stop):
        samples = [draw(label_dir, names, rng, crop, load_size) for _ in range(batch)]
        if b in keep:
            labs, imgs = zip(*(decode(label_dir, image_dir, *s, crop) for s in samples))
            out.append((np.stack(labs), np.stack(imgs)))
    return out


def draw(label_dir, names, rng, crop, load_size):
    name = names[rng.integers(0, len(names))]
    with Image.open(os.path.join(label_dir, name)) as im:
        w, h = im.size
    scale = load_size / min(w, h)
    W, H = int(round(w * scale)), int(round(h * scale))
    y = int(rng.integers(0, max(H - crop, 0) + 1))
    x = int(rng.integers(0, max(W - crop, 0) + 1))
    flip = bool(rng.random() < 0.5)
    box = None
    h_crop, w_crop = min(H - y, crop), min(W - x, crop)
    if rng.random() <= 0.8:
        for _ in range(100):
            target = rng.uniform(0.02, 0.3) * (h_crop * w_crop)
            ratio = rng.uniform(0.2, 5.0)
            eh, ew = int(round(np.sqrt(target * ratio))), int(round(np.sqrt(target / ratio)))
            if eh < h_crop and ew < w_crop:
                box = (int(rng.integers(0, h_crop - eh)), int(rng.integers(0, w_crop - ew)), eh, ew)
                break
    return name, (W, H), y, x, flip, box


def decode(label_dir, image_dir, name, size, y, x, flip, box, crop):
    lab = np.asarray(Image.open(os.path.join(label_dir, name)).convert("RGB")
                     .resize(size, Image.NEAREST))[y:y + crop, x:x + crop].copy()
    img = np.asarray(Image.open(os.path.join(image_dir, name)).convert("RGB")
                     .resize(size, Image.BICUBIC))[y:y + crop, x:x + crop]
    if flip:
        lab, img = lab[:, ::-1].copy(), img[:, ::-1]
    if box is not None:
        by, bx, bh, bw = box
        lab[by:by + bh, bx:bx + bw] = 0
    return lab.astype(np.float32) / 127.5 - 1.0, img.astype(np.float32) / 127.5 - 1.0
