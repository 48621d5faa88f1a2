"""The TPU probes' z-buffer kernels: the CUDA kernel's wrapper, its plain
PyTorch version and the two probe entry points (counterparts of
tools/probe_pallas_zbuf.py:pallas_zbuf, "P1", and
tools/probe_zbuf_variants.py:outres, "P2").

Both compute K1's function (ops/zbuf.py) without a valid-prefix bound: per
pixel the minimum int32 key among the candidates that land there, and the
smallest candidate index among those with that key; a key of INT32_MAX never
writes; an empty pixel is (INT32_MAX, INT32_MAX).  One CUDA source,
``csrc/zbuffer_outres.cu``, serves both.  Its output is one int32[n, 2]
tensor whose pairs (id, key) are the 64-bit words (key << 32) | id that its
atomics update, and the entry points return the key and id planes as strided
views of it.

A CPU tensor goes to :func:`zbuffer_outres_plain`; a CUDA tensor goes to the
kernel (or the wrapper raises).

Contract checks.  The TPU kernels walk ``A // chunk`` whole chunks, so they
drop any tail of the candidates past the last whole chunk, and they write
whatever row a pixel names without a bounds check.  Rather than quietly
compute something else, the entry points raise ``ValueError`` when A is not
a multiple of the chunk, or when a pixel lies outside ``[0, rows * 128)``,
the buffer the TPU kernel would write.  The pixel check reads the pixels'
range back to the host (one sync): these are probe entry points, not a path
of the mapper or the renderer.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_lib import CudaKernel, LaunchCount, ptr, require_cuda, stream_handle
from .index_map import INT32_MAX

_P = ctypes.c_void_p
KERNEL = CudaKernel(
    "zbuffer_outres", "zbuffer_outres.cu",
    {"zbuffer_outres_launch": (ctypes.c_int, [_P, _P, ctypes.c_int64, ctypes.c_int64,
                                              _P, _P])},
)
P1 = LaunchCount("pallas_zbuf")
P2 = LaunchCount("outres")
LANES = 128


def zbuffer_outres_plain(zkey: torch.Tensor, fpix: torch.Tensor, n_pix: int) -> torch.Tensor:
    """The two-pass scatter-min of tools/probe_pallas_zbuf.py:114-120 (key,
    then the smallest index among the winners) on an n_pix + 1 buffer whose
    spare slot takes the losers; an INT32_MAX key never wins.  Returns
    int32[n_pix, 2]: column 0 the id, column 1 the key."""
    pix = fpix.long()
    zbuf = torch.full((n_pix + 1,), INT32_MAX, dtype=torch.int32, device=zkey.device)
    zbuf.scatter_reduce_(0, pix, zkey, "amin")
    win = (zkey != INT32_MAX) & (zkey == zbuf[pix])
    ids = torch.arange(zkey.shape[0], dtype=torch.int32, device=zkey.device)
    idbuf = torch.full((n_pix + 1,), INT32_MAX, dtype=torch.int32, device=zkey.device)
    idbuf.scatter_reduce_(0, torch.where(win, pix, n_pix), ids, "amin")
    return torch.stack([idbuf[:n_pix], zbuf[:n_pix]], dim=1)


def zbuffer_outres(zkey: torch.Tensor, fpix: torch.Tensor, n_pix: int,
                   entry: LaunchCount) -> torch.Tensor:
    """The z-buffer over n_pix pixels as int32[n_pix, 2] (id, key) pairs.
    Every pixel must lie in [0, n_pix) (the entry points check it).
    ``entry`` is the entry point whose launch count this launch adds to."""
    if zkey.device.type == "cpu":
        return zbuffer_outres_plain(zkey, fpix, n_pix)
    A = zkey.shape[0]
    if A >= 2**31:
        raise ValueError(f"zbuffer_outres: {A} candidates; indices must fit in int32")
    require_cuda(zkey, "zkey", torch.int32, (A,))
    require_cuda(fpix, "fpix", torch.int32, (A,))
    if fpix.device != zkey.device:
        raise ValueError(f"fpix is on {fpix.device}, zkey on {zkey.device}")
    dev = zkey.device
    out = torch.empty((n_pix, 2), dtype=torch.int32, device=dev)
    lib = KERNEL.lib()
    with torch.cuda.device(dev):
        rc = lib.zbuffer_outres_launch(ptr(zkey), ptr(fpix), A, n_pix, ptr(out),
                                       stream_handle(dev))
    KERNEL.check(rc)
    KERNEL.launches += 1
    entry.launches += 1
    return out


def check_probe_inputs(name: str, zkey: torch.Tensor, fpix: torch.Tensor,
                       chunk: int, n_pix: int) -> None:
    """Raise ValueError where the TPU kernel would drop candidates (A not a
    multiple of ``chunk``) or write outside its buffer (a pixel outside
    [0, n_pix))."""
    if zkey.dim() != 1 or zkey.shape != fpix.shape:
        raise ValueError(f"{name}: zkey and fpix must be 1-D of one length, got "
                         f"{tuple(zkey.shape)} and {tuple(fpix.shape)}")
    A = zkey.shape[0]
    if A % chunk:
        raise ValueError(f"{name}: {A} candidates is not a multiple of the chunk {chunk}; "
                         f"the TPU kernel would drop the last {A % chunk}")
    if A:
        lo, hi = (int(v) for v in torch.aminmax(fpix))
        if lo < 0 or hi >= n_pix:
            raise ValueError(f"{name}: pixels span [{lo}, {hi}], outside the buffer "
                             f"[0, {n_pix}) the TPU kernel writes")


def pallas_zbuf(zkey: torch.Tensor, fpix: torch.Tensor, P_pad: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """P1 (tools/probe_pallas_zbuf.py:94): one buffer pair of
    rows = P_pad // 128 rows of 128 pixels, candidates in chunks of 2048.
    Returns (zbuf, idbuf), each int32[rows, 128]."""
    rows = P_pad // LANES
    check_probe_inputs("pallas_zbuf", zkey, fpix, 2048, rows * LANES)
    out = zbuffer_outres(zkey, fpix, rows * LANES, P1)
    return out[:, 1].view(rows, LANES), out[:, 0].view(rows, LANES)


def outres_pixels(num_pix: int) -> int:
    """The pixels of :func:`outres`' buffer: whole 128-pixel rows covering
    num_pix + 1, so the pixel num_pix is a spare that is never returned."""
    return -(-(num_pix + 1) // LANES) * LANES


def outres(zkey: torch.Tensor, fpix: torch.Tensor, num_pix: int, chunk: int = 1024
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """P2 (tools/probe_zbuf_variants.py:66) over a buffer of
    :func:`outres_pixels` pixels.  Returns (zbuf, idbuf), each
    int32[num_pix]."""
    n_pix = outres_pixels(num_pix)
    check_probe_inputs("outres", zkey, fpix, chunk, n_pix)
    out = zbuffer_outres(zkey, fpix, n_pix, P2)
    return out[:num_pix, 1], out[:num_pix, 0]
