"""Inputs of the renderer's dilation (``ops/splat._dilate``) for holding its
CUDA kernel to the plain loop: the card tests, the CPU tests and
chip_smoke's ``dilate`` phase.

A case is NC stacked class buffers i64[NC, H, W] of packed words
(key << 32) | id, as K1 leaves them, made from a seed:

  * ``sparse``: a few percent of the pixels of each class, and at least
    one, hold a centre (positive float depth bits as keys, ids below
    INT32_MAX), the rest the empty word; neighbouring centres share keys
    with other ids;
  * ``dense``: every pixel a centre, keys from a handful of values (negative
    ones among them, so the signed order counts) and ids in any order;
  * ``border``: centres only in the first and last two rows and columns;
  * ``empty_class``: ``sparse`` with the last class all empty words;
  * ``all_empty``: every word empty.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.index_map import INT32_MAX
from ..ops.splat import EMPTY_WORD

CASES = ("sparse", "dense", "border", "empty_class", "all_empty")


def dilate_case(name: str, nc: int, H: int, W: int, seed: int = 0,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """The class buffers of case ``name``: i64[nc, H, W] on ``device``."""
    if name not in CASES:
        raise ValueError(f"unknown dilation case {name!r}")
    rng = np.random.default_rng(seed)
    shape = (nc, H, W)
    ids = rng.integers(0, INT32_MAX, shape, dtype=np.int64)
    if name == "dense":
        keys = rng.choice(np.array([-7, -1, 0, 3, 1 << 29], np.int64), shape)
        hit = np.ones(shape, bool)
    else:
        depth = rng.uniform(1.0, 200.0, shape).astype(np.float32)
        keys = depth.view(np.int32).astype(np.int64)
        # neighbours in a row share a key: equal keys, other ids
        keys[..., 1::2] = keys[..., 0::2][..., :W // 2]
        hit = rng.uniform(size=shape) < 0.04
        hit[np.arange(nc), rng.integers(0, H, nc), rng.integers(0, W, nc)] = True
        if name == "border":
            inner = np.zeros((H, W), bool)
            inner[2:H - 2, 2:W - 2] = True
            hit = (rng.uniform(size=shape) < 0.3) & ~inner
        if name == "empty_class":
            hit[-1] = False
        if name == "all_empty":
            hit[:] = False
    words = np.where(hit, (keys << 32) | ids, EMPTY_WORD)
    return torch.from_numpy(words).to(device)
