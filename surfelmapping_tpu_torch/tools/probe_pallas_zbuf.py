"""The single-buffer z-buffer kernel (P1) on the card at the TPU probe's
shape (counterpart of tools/probe_pallas_zbuf.py):

    python -m surfelmapping_tpu_torch.tools.probe_pallas_zbuf [--a 1048576] [--iters 20]

A candidates in random pixel order over P = 453,620 pixels, buffers padded to
P_pad = 453,632: ``pallas_zbuf`` checked against its plain version (the
two-pass scatter-min that the TPU probe called "xla 2-pass"; exact, or it
raises), then the times by CUDA events of the plain version, the kernel, K1
(ops/zbuf.py) and the library yardstick (one ``scatter_reduce`` amin of
packed int64 words), one JSON line each: ``ms`` over calls issued back to
back (the larger of the host's and the card's time per call) and
``ms_device`` with the calls queued behind a spin (the card's time alone).
Needs a CUDA card.
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

P = 453_620
P_PAD = -(-P // 128) * 128


def run(A: int = 1 << 20, iters: int = 20, seed: int = 0) -> list[dict]:
    """Check P1 and time it beside its yardsticks; returns one dict each."""
    dev = resolve_device(None)
    card = card_line()
    zk, fp = random_candidates(np.random.default_rng(seed), P, A, dev)
    zb, ib = zbuf_outres.pallas_zbuf(zk, fp, P_PAD)
    ref = zbuf_outres.zbuffer_outres_plain(zk, fp, P_PAD)
    if not (torch.equal(zb.reshape(-1), ref[:, 1]) and torch.equal(ib.reshape(-1), ref[:, 0])):
        raise AssertionError("pallas_zbuf: kernel != plain")
    library, _ = packed_scatter_min(zk, fp, P)
    fns = {
        "plain 2-pass": lambda: zbuf_outres.zbuffer_outres_plain(zk, fp, P_PAD),
        "P1 kernel": lambda: zbuf_outres.zbuffer_outres(zk, fp, P_PAD, zbuf_outres.P1),
        "K1 kernel": lambda: zbuf.zbuffer_argmin(zk, fp, P),
        "library scatter_reduce": library,
    }
    rows = []
    for name, fn in fns.items():
        ms = cuda_ms(fn, iters)
        row = dict(case=name, P=P, P_pad=P_PAD, A=A, exact=True, ms=ms,
                   ns_per_candidate=ms * 1e6 / A, bound_ms=bound_ms(A, P_PAD), card=card,
                   ms_device=cuda_ms(fn, iters, hold=True))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--a", type=int, default=1 << 20, help="candidates")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    run(args.a, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
