"""Comparisons of flax-layout variable trees (nested dicts of numpy arrays),
shared by chip_smoke's card-vs-CPU checks and the tests: a tree flattened
to "/"-joined keys, and each gradient leaf's gap over its scale."""

from __future__ import annotations

import numpy as np


def flat(tree: dict, prefix: str = "") -> dict:
    """``tree``'s leaves under "/"-joined keys ("gen/head_0/conv_0/kernel")."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def grad_scales(grads: dict) -> dict:
    """Each leaf's scale, for a flat gradient tree: its largest magnitude,
    or the network's largest where the leaf's is below 1e-4 of it (a bias
    that only a normalization reads: its true gradient is 0, and both sides
    give rounding noise)."""
    mags = {k: float(np.abs(a).max()) for k, a in grads.items()}
    top = max(mags.values())
    return {k: m if m >= 1e-4 * top else top for k, m in mags.items()}


def grad_gaps(got: dict, want: dict) -> dict:
    """Each leaf's largest |got - want| over its scale (:func:`grad_scales`
    of ``want``), for two gradient trees of the same layout."""
    g, w = flat(got), flat(want)
    if g.keys() != w.keys():
        raise ValueError(f"gradient trees differ in their leaves: {sorted(g.keys() ^ w.keys())}")
    scales = grad_scales(w)
    return {k: float(np.abs(g[k] - w[k]).max()) / scales[k] for k in w}


def gap_summary(gaps: dict) -> dict:
    """The largest of :func:`grad_gaps`' gaps and its leaf, the median
    leaf's, and the five largest."""
    order = sorted(gaps, key=gaps.get, reverse=True)
    return dict(max=gaps[order[0]], worst=order[0], median=float(np.median(list(gaps.values()))),
                top=[(k, gaps[k]) for k in order[:5]])


def float32_gradients_held(gaps: dict, flipped: bool) -> bool:
    """Whether a float32 step's gradients on two devices agree, from
    :func:`gap_summary`: each leaf within 1e-3 of its scale.  Where one
    rounding flips a choice between the generator's output and the losses
    (a ReLU's, a max pool's or an L1 term's sign), the gradient reaching
    the output changes and every generator leaf moves, the last block's
    too: the VAE's G step at chip_smoke's small size on the H100 reads
    1.4e-2 at its worst leaf and 2.2e-3 at its median one.  There
    (``flipped``) each leaf is held within 5e-2 and the median leaf within
    1e-2."""
    if flipped:
        return gaps["max"] <= 5e-2 and gaps["median"] <= 1e-2
    return gaps["max"] <= 1e-3
