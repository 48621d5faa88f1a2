"""P1/P2's z-buffer (``ops/zbuf_outres.zbuffer_outres``) of several checkouts
of this repo, timed in turns on one card:

    python -m surfelmapping_tpu_torch.tools.zbuf_ab DIR [DIR ...] [--a 1048576] [--iters 50]

Each DIR is the root of a checkout: ``.`` for this one, another commit
unpacked with ``git archive`` for a before-and-after.  Its package is loaded
under a name of its own, so its kernel is built from its own source.  For
P1's and P2's buffers (453,632 and 1,814,528 pixels) and A candidates (2^20
as the TPU probes had them, unless ``--a`` says otherwise) in each order of
``timing.ORDERS``, every checkout's result is checked against this
checkout's plain version (exact, or it raises), then each is timed on the
card warm in L2 (``cuda_ms(hold=True)``) and with L2 flushed
(``cuda_ms_cold``), in the order given and then reversed (a, b, b, a).  One
JSON line per shape and order, with the card's ``nvidia-smi`` line.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

from ..ops import zbuf_outres
from ..pipeline import resolve_device
from .timing import ORDERS, bound_ms, card_line, cuda_ms, cuda_ms_cold, ordered_candidates

SHAPES = (("P1", 453_632, 453_632), ("P2", 4 * 453_620, zbuf_outres.outres_pixels(4 * 453_620)))


def load_checkout(root: str, alias: str):
    """``ops.zbuf_outres`` of the checkout at ``root``, its package imported
    as ``alias``."""
    pkg = Path(root).resolve() / "surfelmapping_tpu_torch"
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{alias}.ops.zbuf_outres")


def run(roots: list[str], iters: int = 50, A: int = 1 << 20, seed: int = 0) -> list[dict]:
    dev = resolve_device(None)
    card = card_line()
    mods = [load_checkout(root, f"zbuf_ab_checkout{i}") for i, root in enumerate(roots)]
    turns = list(range(len(roots))) + list(reversed(range(len(roots))))
    rows = []
    for shape, P, n_pix in SHAPES:
        for order in ORDERS:
            zk, fp = ordered_candidates(np.random.default_rng(seed), P, A, order, dev)
            ref = zbuf_outres.zbuffer_outres_plain(zk, fp, n_pix)
            calls = [lambda m=m: m.zbuffer_outres(zk, fp, n_pix, m.P2) for m in mods]
            for root, call in zip(roots, calls):
                if not bool((call() == ref).all()):
                    raise AssertionError(f"{shape} {order}: {root}'s kernel != plain")
            warm = {root: [] for root in roots}
            cold = {root: [] for root in roots}
            for i in turns:
                warm[roots[i]].append(cuda_ms(calls[i], iters, hold=True))
                cold[roots[i]].append(cuda_ms_cold(calls[i], min(iters, 20)))
            row = dict(shape=shape, order=order, P=P, buffer_pixels=n_pix, A=A,
                       bound_ms=bound_ms(A, n_pix), ms_device=warm, ms_device_cold=cold,
                       card=card)
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("roots", nargs="+", help="checkout roots, timed in this order")
    ap.add_argument("--a", type=int, default=1 << 20, help="candidates per case")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    run(args.roots, args.iters, args.a)
    return 0


if __name__ == "__main__":
    sys.exit(main())
