"""SPADE data on the host (counterpart of surfelmapping_tpu/models/data.py),
numpy and PIL as there, with the same draws in the same order, so that a
seed gives the same batches bit for bit.

  * PairedRenderDataset = KittiDataset semantics (SPADE/data/kitti_dataset.py):
    label = rendered surfel image, image = real photo, paired by filename;
    train transform: resize shorter side to load_size, random crop
    crop_size x crop_size, horizontal flip, RandomErasing applied to the
    label ONLY (kitti_dataset.py:84-101) to simulate render holes;
  * RandomErasing (SPADE/util/random_erasing.py): p=0.8, area 2-30%, aspect
    0.3-1/0.3, erase value 0;
  * a sample's draws (:class:`Draw`: name, crop, flip, erasing) are made
    from the image sizes in the PNG headers, apart from its decoding, so a
    data-parallel rank makes every global batch's draws in order and
    decodes only its own rows (``batches(..., rows)``); :class:`Prefetched`
    decodes the next batch on a thread while the card runs the step;
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


ERASE_AREA = (0.02, 0.3)  # share of the image erased, drawn uniformly
ERASE_ASPECT = 0.2        # aspect ratio drawn from [0.2, 1 / 0.2]


def erase_box(H: int, W: int, rng: np.random.Generator,
              p: float = 0.8) -> tuple[int, int, int, int] | None:
    """The draws of :func:`random_erasing` on an H x W image, in its order:
    the rectangle (y, x, h, w) to erase, or None."""
    if rng.random() > p:
        return None
    area = H * W
    for _ in range(100):
        target = rng.uniform(*ERASE_AREA) * area
        ratio = rng.uniform(ERASE_ASPECT, 1.0 / ERASE_ASPECT)
        h = int(round(np.sqrt(target * ratio)))
        w = int(round(np.sqrt(target / ratio)))
        if h < H and w < W:
            return int(rng.integers(0, H - h)), int(rng.integers(0, W - w)), h, w
    return None


def erase(img: np.ndarray, box: tuple[int, int, int, int] | None) -> np.ndarray:
    """``img`` with ``box`` (y, x, h, w) set to 0, a copy (``img`` itself
    without a box)."""
    if box is None:
        return img
    y, x, h, w = box
    img = img.copy()
    img[y : y + h, x : x + w] = 0
    return img


def random_erasing(img: np.ndarray, rng: np.random.Generator, p: float = 0.8) -> np.ndarray:
    """Cutout augmentation with probability ``p`` (SPADE/util/random_erasing.py:27:
    p=0.8, sl=0.02, sh=0.3, r1=0.2; erase value 0 per base_dataset.py:83-84)."""
    return erase(img, erase_box(*img.shape[:2], rng, p))


@dataclass(frozen=True)
class Draw:
    """The random draws of one training sample, made without its pixels:
    the pair's ``name``, the crop's corner (``y``, ``x``) in the resized
    image, the flip and the erased rectangle (y, x, h, w) of the label."""

    name: str
    y: int
    x: int
    flip: bool
    box: tuple[int, int, int, int] | None


@dataclass
class PairedRenderDataset:
    """Yields (label, image) float32 NHWC batches in [-1, 1]."""

    label_dir: str
    image_dir: str
    crop_size: int = 256
    load_size: int = 286
    seed: int = 0
    # inclusive [lo, hi] frame-id ranges to drop; pass
    # KITTI_BAD_FRAME_RANGES for the reference's hardcoded skip list
    skip_ranges: tuple[tuple[int, int], ...] = ()

    def __post_init__(self):
        labels = sorted(os.listdir(self.label_dir))
        images = set(os.listdir(self.image_dir))
        self.names = [
            n for n in labels
            if n in images and not in_skip_ranges(n, self.skip_ranges)
        ]
        if not self.names:
            raise ValueError("no paired files between label and image dirs")
        self.rng = np.random.default_rng(self.seed)
        self._sizes: dict[str, tuple[int, int]] = {}

    def __len__(self) -> int:
        return len(self.names)

    def resized_size(self, name: str) -> tuple[int, int]:
        """(w, h) of the pair resized so its shorter side is ``load_size``,
        from the label's header alone (``Image.open`` reads no pixels)."""
        size = self._sizes.get(name)
        if size is None:
            with Image.open(os.path.join(self.label_dir, name)) as lab:
                w, h = lab.size
            scale = self.load_size / min(w, h)
            size = self._sizes[name] = (int(round(w * scale)), int(round(h * scale)))
        return size

    def _load_pair(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        lab = Image.open(os.path.join(self.label_dir, name)).convert("RGB")
        img = Image.open(os.path.join(self.image_dir, name)).convert("RGB")
        size = self.resized_size(name)
        lab = lab.resize(size, Image.NEAREST)
        img = img.resize(size, Image.BICUBIC)
        return np.asarray(lab), np.asarray(img)

    def draw(self) -> Draw:
        """The next sample's draws, in the reference's order (name, crop,
        flip, erasing), without decoding a pixel."""
        name = self.names[self.rng.integers(0, len(self.names))]
        W, H = self.resized_size(name)
        cs = self.crop_size
        y = int(self.rng.integers(0, max(H - cs, 0) + 1))
        x = int(self.rng.integers(0, max(W - cs, 0) + 1))
        flip = bool(self.rng.random() < 0.5)
        box = erase_box(min(H - y, cs), min(W - x, cs), self.rng)
        return Draw(name, y, x, flip, box)

    def load(self, d: Draw) -> tuple[np.ndarray, np.ndarray]:
        """The sample that ``d`` draws: decoded, resized, cropped, flipped,
        its label erased, as float32 in [-1, 1]."""
        lab, img = self._load_pair(d.name)
        cs = self.crop_size
        lab = lab[d.y : d.y + cs, d.x : d.x + cs]
        img = img[d.y : d.y + cs, d.x : d.x + cs]
        if d.flip:
            lab = lab[:, ::-1]
            img = img[:, ::-1]
        lab = erase(lab, d.box)
        to_f = lambda a: a.astype(np.float32) / 127.5 - 1.0  # noqa: E731
        return to_f(lab), to_f(img)

    def batches(self, batch_size: int, steps: int, rows: slice | None = None):
        """``steps`` batches of ``batch_size`` samples.  Every batch's draws
        are made whole, so the samples are the same whatever ``rows`` is;
        with ``rows`` only those rows of each batch are decoded and
        yielded (a data-parallel rank's own)."""
        for _ in range(steps):
            draws = [self.draw() for _ in range(batch_size)]
            labs, imgs = zip(*(self.load(d) for d in draws[rows or slice(None)]))
            yield np.stack(labs), np.stack(imgs)


class Prefetched:
    """Iterates ``batches`` (pairs of numpy arrays) ahead on a worker
    thread, so the next batches are decoded while the card runs the steps;
    yields each as torch tensors, in pinned memory when ``pin`` (for a copy
    to the card that does not block the host).  The items and their order
    are those of ``batches``; an exception in the worker is raised where
    the item would have been.  :meth:`close` (or leaving a ``with``) ends
    the worker after the batch in flight."""

    # batches asked of the worker at once: a D+G iteration's slack carries
    # the decode of the D-only iteration after it (with one, that shorter
    # step waited for its batch)
    AHEAD = 2

    def __init__(self, batches, pin: bool = False):
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        self._batches, self._pin = iter(batches), pin
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="spade-prefetch")
        self._ahead = deque(self._pool.submit(self._make) for _ in range(self.AHEAD))

    def _make(self):
        import torch

        arrays = next(self._batches, None)
        if arrays is None:
            return None
        out = tuple(torch.from_numpy(a) for a in arrays)
        return tuple(t.pin_memory() for t in out) if self._pin else out

    def __iter__(self):
        return self

    def __next__(self):
        item = self._ahead[0].result()
        if item is None:
            raise StopIteration
        self._ahead.popleft()
        self._ahead.append(self._pool.submit(self._make))
        return item

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


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
