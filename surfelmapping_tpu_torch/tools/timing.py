"""Shared pieces of the probes: kernel timing by CUDA events, the card's
``nvidia-smi`` line, random z-buffer candidates, and the library yardstick
(one PyTorch call computing the z-buffer's function)."""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from ..ops.index_map import INT32_MAX

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` on the card by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def random_candidates(rng: np.random.Generator, P: int, A: int, dev: torch.device,
                      zkey: np.ndarray | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """A candidates in random pixel order over [0, P), keys in [0, 2^30)
    (or the given keys)."""
    if zkey is None:
        zkey = rng.integers(0, 1 << 30, A).astype(np.int32)
    fpix = rng.integers(0, P, A).astype(np.int32)
    return torch.from_numpy(zkey).to(dev), torch.from_numpy(fpix).to(dev)


def packed_scatter_min(zkey: torch.Tensor, fpix: torch.Tensor, P: int):
    """The library yardstick: a function doing one ``scatter_reduce`` amin of
    the packed words (key << 32 | index) into P pixels (+1 spare for the
    invalid keys), and its (key, id) result."""
    A = zkey.shape[0]
    pix = torch.where(zkey != INT32_MAX, fpix, P).long()
    vals = (zkey.long() << 32) | torch.arange(A, device=zkey.device)
    empty = torch.full((P + 1,), (INT32_MAX << 32) | INT32_MAX, dtype=torch.int64,
                       device=zkey.device)

    def call():
        return empty.scatter_reduce(0, pix, vals, "amin")

    out = call()[:P]
    return call, ((out >> 32).int(), (out & 0xFFFFFFFF).int())


def bound_ms(candidates: int, pixels: int) -> float:
    """The z-buffer's least time on the H100: 8 B read per candidate (key +
    pixel) and 8 B written per pixel (key + id) over the memory rate."""
    return (8.0 * candidates + 8.0 * pixels) / HBM_BYTES_PER_S * 1e3
