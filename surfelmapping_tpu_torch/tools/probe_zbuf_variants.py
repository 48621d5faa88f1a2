"""The binned z-buffer kernel (P2) on the card at the TPU probe's
cases (counterpart of tools/probe_zbuf_variants.py):

    python -m surfelmapping_tpu_torch.tools.probe_zbuf_variants [--a 1048576] [--iters 20]

For each case, A candidates in random pixel order: ``outres`` checked against
its plain version (exact, or it raises), the kernel's time by CUDA events and
its ns per candidate, its bound, and beside them K1 (ops/zbuf.py) and the
library yardstick (one ``scatter_reduce`` amin of packed int64 words) on the
same candidates.  Then K1's index-map shape, which no TPU probe had: P =
453,620, a valid prefix of 700,001 of the 2^20 candidates, 30% of them
invalid; K1 with that prefix against the kernel on the prefix (through
``zbuffer_outres``: the prefix is no multiple of a chunk).  Each time twice:
over calls issued back to back (``ms``, the larger of the host's and the
card's time per call) and with the calls queued behind a spin
(``ms_device``, the card's time alone).  One JSON line per case.  The TPU
probe's chunk sizes only select how many candidates its kernel stages in
SMEM; here they only set the multiple that A must be.  Its TPU-only cases
are left out, each with the reason printed.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import zbuf, zbuf_outres
from ..pipeline import resolve_device
from .timing import bound_ms, card_line, cuda_ms, packed_scatter_min, random_candidates

CASES = (  # (name, pixels, chunk)
    ("P=453k outres c1024", 453_620, 1024),
    ("P=453k outres c2048", 453_620, 2048),
    ("P=1.81M outres (4-class renderer shape)", 4 * 453_620, 1024),
)
LEFT_OUT = {
    "P=453k R=1, P=453k R=3": "replicas: the TPU kernel's replicated VMEM buffers give "
    "its scalar loop instruction-level parallelism; the CUDA kernel resolves each pixel "
    "tile once in shared memory",
    "P=1.81M outres vmem=100MB, P=453k R=4 vmem100": "vmem_mb: the TPU's scoped VMEM "
    "limit; the card has no such limit to set",
}


def run(A: int = 1 << 20, iters: int = 20, seed: int = 0) -> list[dict]:
    """Check and time every case; returns one dict per case."""
    dev = resolve_device(None)
    card = card_line()
    rng = np.random.default_rng(seed)
    zkey_np = rng.integers(0, 1 << 30, A).astype(np.int32)
    rows = []
    for name, P, chunk in CASES:
        zk, fp = random_candidates(rng, P, A, dev, zkey_np)
        zb, ib = zbuf_outres.outres(zk, fp, P, chunk)
        n_pix = zbuf_outres.outres_pixels(P)
        ref = zbuf_outres.zbuffer_outres_plain(zk, fp, n_pix)
        if not (torch.equal(zb, ref[:P, 1]) and torch.equal(ib, ref[:P, 0])):
            raise AssertionError(f"{name}: kernel != plain")
        kernel = lambda: zbuf_outres.zbuffer_outres(zk, fp, n_pix, zbuf_outres.P2)  # noqa: E731
        k1 = lambda: zbuf.zbuffer_argmin(zk, fp, P)  # noqa: E731
        library, _ = packed_scatter_min(zk, fp, P)
        ms = cuda_ms(kernel, iters)
        row = dict(case=name, P=P, A=A, chunk=chunk, exact=True, ms=ms,
                   ns_per_candidate=ms * 1e6 / A, bound_ms=bound_ms(A, n_pix),
                   k1_ms=cuda_ms(k1, iters), library_ms=cuda_ms(library, iters), card=card,
                   ms_device=cuda_ms(kernel, iters, hold=True),
                   k1_ms_device=cuda_ms(k1, iters, hold=True),
                   library_ms_device=cuda_ms(library, iters, hold=True))
        print(json.dumps(row), flush=True)
        rows.append(row)
    rows.append(k1_index_shape(rng, A, iters, dev, card))
    for cases, why in LEFT_OUT.items():
        print(json.dumps(dict(left_out=cases, why=why)), flush=True)
    return rows


def k1_index_shape(rng: np.random.Generator, A: int, iters: int, dev, card: str,
                   P: int = 453_620, n_valid: int = 700_001) -> dict:
    """K1 with its valid prefix beside the kernel on the prefix, at the
    index map's shape; the invalid candidates are (INT32_MAX, P), as the
    index stage leaves them."""
    n_valid = min(n_valid, A)
    zkey = rng.integers(100, 1 << 30, A).astype(np.int32)
    fpix = rng.integers(0, P, A).astype(np.int32)
    invalid = rng.uniform(size=A) < 0.3
    zkey[invalid], fpix[invalid] = zbuf_outres.INT32_MAX, P
    zk, fp = torch.from_numpy(zkey).to(dev), torch.from_numpy(fpix).to(dev)
    nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
    k1 = lambda: zbuf.zbuffer_argmin_packed(zk, fp, P, nv)  # noqa: E731
    kernel = lambda: zbuf_outres.zbuffer_outres(  # noqa: E731
        zk[:n_valid], fp[:n_valid], P, zbuf_outres.P2)
    if not torch.equal(kernel().view(torch.int64).reshape(-1), k1()):
        raise AssertionError("K1 index shape: kernel != K1")
    ms = cuda_ms(kernel, iters)
    row = dict(case="P=453k K1 index shape, valid prefix", P=P, A=A, n_valid=n_valid,
               exact=True, ms=ms, ns_per_candidate=ms * 1e6 / n_valid,
               bound_ms=bound_ms(n_valid, P), k1_ms=cuda_ms(k1, iters), card=card,
               ms_device=cuda_ms(kernel, iters, hold=True),
               k1_ms_device=cuda_ms(k1, iters, hold=True))
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--a", type=int, default=1 << 20, help="candidates per case")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    run(args.a, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
