"""The TPU probes' z-buffer kernels: the CUDA kernel's wrapper, its plain
PyTorch version and the two probe entry points (counterparts of
tools/probe_pallas_zbuf.py:pallas_zbuf, "P1", and
tools/probe_zbuf_variants.py:outres, "P2").

Both compute K1's function (ops/zbuf.py) without a valid-prefix bound: per
pixel the minimum int32 key among the candidates that land there, and the
smallest candidate index among those with that key; a key of INT32_MAX never
writes; an empty pixel is (INT32_MAX, INT32_MAX).  One CUDA source,
``csrc/zbuffer_outres.cu``, serves both: a binned shared-memory z-buffer.  A
bin pass sorts the candidates by pixel tile within each block's span, and a
resolve pass takes one tile per block, reduces it in shared memory and
writes it out once.  :func:`outres_plan` sizes the tiles, the bin blocks and
the scratch, which the wrapper allocates.  The output is one int32[n, 2]
tensor whose pairs (id, key) are the 64-bit words (key << 32) | id, and the
entry points return the key and id planes as strided views of it.

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
import math
from dataclasses import dataclass

import torch

from .cuda_lib import CudaKernel, LaunchCount, ptr, require_cuda, stream_handle
from .index_map import INT32_MAX

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel(
    "zbuffer_outres", "zbuffer_outres.cu",
    {"zbuffer_outres_launch": (_I, [_P, _P, _I, _I, _I, _P, _P, _P, _P])},
)
P1 = LaunchCount("pallas_zbuf")
P2 = LaunchCount("outres")
LANES = 128

# The plan's sizes, the one place that checks what the kernel can take.
SPAN = 8192               # candidates per bin block (csrc/zbuffer_outres.cu's kSpan)
TILE_LOG2_RANGE = (10, 14)  # 1024 to 16384 pixels: 8 to 128 KB of keys and ids per resolve block
ENTRIES_PER_TILE = 2048   # the mean bucket the plan aims a tile at
MIN_TILES = 2 * 132       # at least two resolve blocks per SM of the H100
MAX_TILES = 12_000        # bin's per-tile counts within 48 KB of shared memory
SMEM_PER_BLOCK = 232_448  # the H100's shared memory a block can use (227 KB)


@dataclass(frozen=True)
class OutresPlan:
    """The kernel's launch for A candidates over n_pix pixels: tiles of
    2^tile_log2 pixels, one resolve block each (the last tile ragged unless
    T divides n_pix); bin blocks of SPAN candidates (the last one ragged);
    the scratch: ``entries`` int64 words (one per candidate) and ``starts``
    int32 values (the segment table, (tiles + 1) x bin_blocks)."""

    tile_log2: int
    tiles: int
    bin_blocks: int
    entries: int
    starts: int

    @property
    def tile(self) -> int:
        return 1 << self.tile_log2

    @property
    def bin_smem(self) -> int:
        """Shared memory bytes of one bin block: its span's entries and its
        per-tile counts."""
        return 8 * SPAN + 4 * self.tiles

    @property
    def tile_smem(self) -> int:
        """Shared memory bytes of one resolve block's tile: a key and an id
        per pixel."""
        return 8 * self.tile


def default_tile_log2(A: int, n_pix: int) -> int:
    """The power of two nearest ENTRIES_PER_TILE candidates per tile at the
    mean density A / n_pix, no wider than leaves MIN_TILES tiles, within
    TILE_LOG2_RANGE.  At the probes' 2^20 candidates: 1024 pixels over
    P1's 453,632 and 4096 over P2's 1,814,528, 443 tiles each."""
    lo, hi = TILE_LOG2_RANGE
    want = round(math.log2(ENTRIES_PER_TILE * n_pix / A)) if A and n_pix else lo
    cap = math.floor(math.log2(n_pix / MIN_TILES)) if n_pix >= MIN_TILES else lo
    return max(lo, min(hi, want, cap))


def outres_plan(A: int, n_pix: int) -> OutresPlan:
    """The launch for A candidates over n_pix pixels: the tile of
    :func:`default_tile_log2`, widened while the pixels need more than
    MAX_TILES tiles.  Raises ValueError where the kernel cannot take the
    sizes."""
    if not 0 <= A < 2**31:
        raise ValueError(f"zbuffer_outres: {A} candidates; indices must fit in int32")
    if not 0 <= n_pix < 2**31:
        raise ValueError(f"zbuffer_outres: {n_pix} pixels; pixels must fit in int32")
    tile_log2 = default_tile_log2(A, n_pix)
    while -(-n_pix >> tile_log2) > MAX_TILES and tile_log2 < TILE_LOG2_RANGE[1]:
        tile_log2 += 1
    tiles = -(-n_pix >> tile_log2)
    if tiles > MAX_TILES:
        raise ValueError(f"zbuffer_outres: {n_pix} pixels need {tiles} tiles of "
                         f"{1 << tile_log2}, more than {MAX_TILES}")
    bin_blocks = -(-A // SPAN)
    return OutresPlan(tile_log2=tile_log2, tiles=tiles, bin_blocks=bin_blocks,
                      entries=A, starts=(tiles + 1) * bin_blocks)


def outres_scratch(plan: OutresPlan, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The scratch that the wrapper hands the kernel: (entries, starts)."""
    return (torch.empty(plan.entries, dtype=torch.int64, device=device),
            torch.empty(plan.starts, dtype=torch.int32, device=device))


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
    A pixel outside [0, n_pix) never writes (the entry points refuse it).
    ``entry`` is the entry point whose launch count this launch adds to."""
    if zkey.device.type == "cpu":
        return zbuffer_outres_plain(zkey, fpix, n_pix)
    A = zkey.shape[0]
    plan = outres_plan(A, n_pix)
    require_cuda(zkey, "zkey", torch.int32, (A,))
    require_cuda(fpix, "fpix", torch.int32, (A,))
    if fpix.device != zkey.device:
        raise ValueError(f"fpix is on {fpix.device}, zkey on {zkey.device}")
    dev = zkey.device
    out = torch.empty((n_pix, 2), dtype=torch.int32, device=dev)
    if plan.tiles == 0:
        return out
    entries, starts = outres_scratch(plan, dev)
    lib = KERNEL.lib()
    with torch.cuda.device(dev):
        rc = lib.zbuffer_outres_launch(ptr(zkey), ptr(fpix), A, n_pix, plan.tile_log2,
                                       ptr(entries), ptr(starts), ptr(out), stream_handle(dev))
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
