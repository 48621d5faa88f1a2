"""Shared pieces of the probes: kernel timing by CUDA events, the card's
``nvidia-smi`` line, random z-buffer candidates, and the library yardstick
(one PyTorch call computing the z-buffer's function)."""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from ..ops.index_map import INT32_MAX

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
HOLD_CYCLES = 20_000_000   # ~10 ms of the card's clock
FLUSH_BYTES = 64 << 20     # more than the H100's 50 MB L2


def cuda_ms(fn, iters: int, warmup: int = 2, hold: bool = False) -> float:
    """Mean time per call of ``fn`` by CUDA events over ``iters`` calls,
    warm in L2.  By default the calls run back to back as the host issues
    them, so the time per call is the larger of the host's and the card's.
    With ``hold=True`` the stream is held by a ~10 ms spin first, so the
    host enqueues the calls ahead of the card and the result is the card's
    time alone (when ``iters`` calls take the host less than the spin)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_cold(fn, iters: int) -> float:
    """Mean device time of ``fn`` with L2 flushed before each call (a 64 MB
    write between the calls, outside the timed span), the stream held as in
    :func:`cuda_ms` with ``hold=True``."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    for i, (start, end) in enumerate(events):
        flush.fill_(i)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


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


INT32_MIN = -(2**31)
ORDERS = ("random", "block", "one_tile", "signed")


def ordered_candidates(rng: np.random.Generator, P: int, A: int, order: str,
                       dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """A candidates over [0, P) in one of the layouts the binned z-buffer
    (ops/zbuf_outres.py) is held to: ``random`` pixel order, keys in [0, 2^30);
    ``block``, the same with the pixels sorted ascending, the order in which
    the index stage hands candidates over (tools/probe_pallas_zbuf.py:10-14);
    ``one_tile``, every pixel in [0, 1024), inside the first resolve tile
    whatever its width, with keys in [0, 64) so that most pixels see ties;
    ``signed``, keys over all of int32, INT32_MIN and INT32_MAX (never
    written) among them."""
    zkey = rng.integers(0, 1 << 30, A).astype(np.int32)
    fpix = rng.integers(0, P, A).astype(np.int32)
    if order == "block":
        fpix.sort()
    elif order == "one_tile":
        fpix = rng.integers(0, min(P, 1024), A).astype(np.int32)
        zkey = rng.integers(0, 64, A).astype(np.int32)
    elif order == "signed":
        zkey = rng.integers(INT32_MIN, INT32_MAX, A, endpoint=True).astype(np.int32)
        zkey[::97] = INT32_MIN
        zkey[::89] = INT32_MAX
    elif order != "random":
        raise ValueError(f"unknown order {order!r}; one of {ORDERS}")
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
