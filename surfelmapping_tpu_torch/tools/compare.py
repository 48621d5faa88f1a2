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


def step_gaps(got: dict, want: dict, got_logs: dict, want_logs: dict) -> dict:
    """How far one run's D step then G step lies from another's, from the
    flax-layout trees after them (``SpadeTrainer.state_to_numpy``) and the
    steps' logs: the losses' largest relative gap, and for each net
    (``d``, ``g``) the :func:`gap_summary` of its gradients (Adam's mu after
    its step: with b1 = 0 it is the gradient), its stored SN and BN state's
    largest gap over each array's largest magnitude, and its parameters'
    largest gap over its learning rate."""
    if got_logs.keys() != want_logs.keys():
        raise ValueError(f"the logs differ in their keys: {sorted(got_logs)} {sorted(want_logs)}")
    out = {"loss_rel_err": max(abs(got_logs[k] - want_logs[k]) / abs(want_logs[k])
                               for k in want_logs)}
    for net in ("d", "g"):
        grads = gap_summary(grad_gaps(*(t[f"{net}_opt"]["inner_state"]["0"]["mu"]
                                        for t in (got, want))))
        s_got, s_want = flat(got[f"{net}_batch_stats"]), flat(want[f"{net}_batch_stats"])
        stored = max(float(np.abs(s_got[k] - s_want[k]).max())
                     / max(float(np.abs(s_want[k]).max()), 1e-30) for k in s_want)
        lr = float(want[f"{net}_opt"]["hyperparams"]["learning_rate"])
        p_got, p_want = flat(got[f"{net}_params"]), flat(want[f"{net}_params"])
        params = max(float(np.abs(p_got[k] - p_want[k]).max()) for k in p_want) / lr
        out[net] = dict(grad=grads, stored_err=stored, param_err_over_lr=params)
    return out


def float32_steps_held(gaps: dict) -> bool:
    """Whether two float32 runs of a D step then a G step on the same batch
    agree, from :func:`step_gaps`: the losses within 1e-4 relative; the
    gradients as :func:`float32_gradients_held` holds them where a rounding
    flips a choice (a data-parallel step and one process run the
    convolutions at other batch sizes, so their sums round differently;
    a wrong batch norm or loss scale moves every leaf by O(1)); the stored
    state within 1e-5 of each array's largest magnitude; each parameter
    within 2 lr of the other run's (Adam's first step moves it by at most
    lr, and a flipped sign of a near-zero gradient moves it the other way),
    with 0.1% for float32 rounding."""
    return gaps["loss_rel_err"] <= 1e-4 and all(
        float32_gradients_held(gaps[n]["grad"], True) and gaps[n]["stored_err"] <= 1e-5
        and gaps[n]["param_err_over_lr"] <= 2.002 for n in ("d", "g"))
