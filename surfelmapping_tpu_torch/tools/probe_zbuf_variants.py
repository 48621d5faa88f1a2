"""The output-resident z-buffer kernel (P2) on the card at the TPU probe's
cases (counterpart of tools/probe_zbuf_variants.py):

    python -m surfelmapping_tpu_torch.tools.probe_zbuf_variants [--a 1048576] [--iters 20]

For each case, A candidates in random pixel order: ``outres`` checked against
its plain version (exact, or it raises), the kernel's time by CUDA events and
its ns per candidate, its bound, and beside them K1 (ops/zbuf.py) and the
library yardstick (one ``scatter_reduce`` amin of packed int64 words) on the
same candidates.  One JSON line per case.  The TPU probe's chunk sizes only
select how many candidates its kernel stages in SMEM; here they only set the
multiple that A must be.  Its TPU-only cases are left out, each with the
reason printed.  Needs a CUDA card.
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
    "its scalar loop instruction-level parallelism; the CUDA kernel has one buffer and "
    "one 64-bit atomicMin per candidate",
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
        ms = cuda_ms(lambda: zbuf_outres.zbuffer_outres(zk, fp, n_pix, zbuf_outres.P2), iters)
        k1_ms = cuda_ms(lambda: zbuf.zbuffer_argmin(zk, fp, P), iters)
        library, _ = packed_scatter_min(zk, fp, P)
        library_ms = cuda_ms(library, iters)
        row = dict(case=name, P=P, A=A, chunk=chunk, exact=True, ms=ms,
                   ns_per_candidate=ms * 1e6 / A, bound_ms=bound_ms(A, n_pix),
                   k1_ms=k1_ms, library_ms=library_ms, card=card)
        print(json.dumps(row), flush=True)
        rows.append(row)
    for cases, why in LEFT_OUT.items():
        print(json.dumps(dict(left_out=cases, why=why)), flush=True)
    return rows


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
