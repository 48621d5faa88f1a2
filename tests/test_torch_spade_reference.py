"""The port's SPADE training against the benchmark's plain reference
(``benchmarks/reference/spade``), and the training data path of the
data-parallel CLI: every rank's own rows of the same draws, prefetched.

Sizes are the SPADE tests' (ngf 8, ndf 8, crop 64, two discriminator
scales of 2 layers, batch 2; crop 32 with VGG19 on).  The steps compare in float64, where both
compute the same mathematics in other summation orders: the losses within
1e-12 and each gradient (Adam's first moment after the step: beta1 is 0)
within 1e-9 of its RMS, against at least 1e-2 of the net's largest (the
biases ahead of a normalization have a true gradient of 0 and get rounding
noise); each weight's change within 1e-6 where its gradient reaches that
1e-2 (``CHANGE_TOL``); the running statistics within 1e-12.  In float32, one rounding can
flip a ReLU's or a hinge's choice and move a share of a leaf far past
these (tests/test_torch_spade_train.py's module docstring).
"""

import os
import sys
import time
import types

import numpy as np
import pytest
import torch
from PIL import Image

from benchmarks.reference import spade as reference
from benchmarks.reference.spade import data as reference_data
from surfelmapping_tpu_torch import spade_train
from surfelmapping_tpu_torch.models.data import PairedRenderDataset, Prefetched
from surfelmapping_tpu_torch.models.pix2pix import SpadeConfig, SpadeTrainer
from surfelmapping_tpu_torch.parallel import distributed
from surfelmapping_tpu_torch.parallel.distributed import rank_rows

SMALL = dict(ngf=8, ndf=8, crop_size=64, z_dim=16, num_d=2, n_layers_d=2)
BATCH = 2
LOSS_TOL, GRAD_TOL, GRAD_FLOOR = 1e-12, 1e-9, 1e-2
# the port holds Adam's learning rate and betas as float32 values (optax's
# inject_hyperparams), the reference as Python floats: a change of a weight
# differs by their rounding, ~6e-8 of it
CHANGE_TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the steps against the reference -----------------------------------------------------

def _reference_state(st) -> reference.State:
    """The port's TrainState as the reference's (the same names)."""
    def net(m):
        return None if m is None else {k: v.detach().clone() for k, v in m.state_dict().items()}

    def adam(m, opt, prefix):
        names = [prefix + n for n, _ in m.named_parameters()]
        return reference.Adam(opt.count, dict(zip(names, [t.clone() for t in opt.mu])),
                              dict(zip(names, [t.clone() for t in opt.nu])))

    prefix = "" if st.enc is not None else "gen."
    return reference.State(net(st.gen), net(st.enc), net(st.d), net(st.vgg),
                           adam(st.g, st.g_opt, prefix), adam(st.d, st.d_opt, ""))


def _rms(t):
    return float(t.double().pow(2).mean().sqrt())


def _grads_held(names, got, want):
    top = max(_rms(w) for w in want)
    for n, g, w in zip(names, got, want):
        assert _rms(g - w) <= GRAD_TOL * max(_rms(w), GRAD_FLOOR * top), n


def _changes_held(names, before, got, want, grads):
    """Each weight's change over the step within CHANGE_TOL of the
    reference's, where the weight's gradient reaches GRAD_FLOOR of the
    net's largest (Adam scales a gradient of rounding noise to +-lr)."""
    top = max(_rms(g) for g in grads)
    for n, b, g, w, grad in zip(names, before, got, want, grads):
        if _rms(grad) >= GRAD_FLOOR * top:
            assert _rms(g.detach() - w) <= CHANGE_TOL * _rms(w - b), n


def _setup(use_vae: bool, use_vgg: bool, seed: int, crop: int = 64):
    small = dict(SMALL, crop_size=crop, use_vae=use_vae, use_vgg=use_vgg)
    cfg, rcfg = SpadeConfig(**small), reference.Config(**small)
    tr = SpadeTrainer(cfg, device="cpu")
    st = tr.init_state(seed=seed).to(torch.float64)
    rng = np.random.default_rng(seed)
    lab, img = (torch.tensor(rng.uniform(-1, 1, (BATCH, crop, crop, 3))) for _ in range(2))
    noise = torch.tensor(rng.normal(size=(BATCH, 16))) if use_vae else None
    return tr, st, rcfg, lab, img, noise


@pytest.mark.parametrize("use_vae", [False, True], ids=["plain_vgg", "vae"])
def test_steps_match_the_reference(use_vae):
    """A D step, then a G step, of the port and of the reference from the
    same seeded state, batch and noise: the losses, the gradients, the
    weights' changes and the generator's running statistics (float64, tolerances in the module
    docstring).  With VGG19 on, crop 32 (VGG19 is the costliest part of
    the step on the CPU)."""
    tr, st, rcfg, lab, img, noise = _setup(use_vae, not use_vae, seed=11,
                                           crop=64 if use_vae else 32)
    nchw = lambda t: t.permute(0, 3, 1, 2).contiguous()  # noqa: E731
    for step in ("d_step", "g_step"):
        ref = _reference_state(st)
        net = st.d if step == "d_step" else st.g
        before = [p.detach().clone() for p in net.parameters()]
        st, logs = getattr(tr, step)(st, lab, img, noise=noise)
        want = getattr(reference, step)(ref, nchw(lab), nchw(img), noise, rcfg)
        assert logs.keys() == want.keys()
        for k in want:
            assert abs(float(logs[k]) - float(want[k])) <= LOSS_TOL * abs(float(want[k])), k
        opt, radam = (st.d_opt, ref.d_adam) if step == "d_step" else (st.g_opt, ref.g_adam)
        assert opt.count == radam.count
        _grads_held(list(radam.mu), opt.mu, list(radam.mu.values()))
        weights = ref.d if step == "d_step" else ref.g_params()
        _changes_held(list(radam.mu), before, list(net.parameters()),
                      [weights[n] for n in radam.mu], list(radam.mu.values()))
    stats = {k: v for k, v in ref.gen.items() if k.endswith((".mean", ".var"))}
    mine = st.gen.state_dict()
    for k, v in stats.items():
        assert _rms(mine[k] - v) <= LOSS_TOL * max(_rms(v), 1.0), k


def test_the_reference_split_four_ways_is_the_whole_batch():
    """The reference on four parts of a batch (the batch norms' statistics
    and the gradients summed over the parts, as four ranks sum them) equals
    it on the whole batch, in float64."""
    tr, st, rcfg, lab, img, noise = _setup(False, False, seed=12, crop=32)
    lab, img = (torch.cat([t, t.flip(1)]).permute(0, 3, 1, 2).contiguous() for t in (lab, img))
    out = []
    for parts in (1, 4):
        ref = _reference_state(st)
        logs = reference.d_step(ref, lab, img, noise, rcfg, parts)
        logs.update(reference.g_step(ref, lab, img, noise, rcfg, parts))
        out.append((ref, logs))
    (a, la), (b, lb) = out
    for k in la:
        assert abs(float(la[k]) - float(lb[k])) <= LOSS_TOL * abs(float(la[k])), k
    for adam_a, adam_b in ((a.g_adam, b.g_adam), (a.d_adam, b.d_adam)):
        _grads_held(list(adam_a.mu), list(adam_b.mu.values()), list(adam_a.mu.values()))


# -- the data path --------------------------------------------------------------------------

def _pairs(root, n=5):
    rng = np.random.default_rng(0)
    (root / "label").mkdir()
    (root / "image").mkdir()
    for i, (h, w) in enumerate([(40, 130), (50, 60), (37, 37), (64, 90), (45, 70)][:n]):
        a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(a).save(root / "label" / f"{i:06d}.png")
        Image.fromarray(a[::-1].copy()).save(root / "image" / f"{i:06d}.png")
    return str(root / "label"), str(root / "image")


def _whole_batches(lab, img, batch, steps, load_size=36):
    """The batches and their names as the dataset drew them before its
    draws were split from its decoding: each sample drawn and decoded in
    turn from the one generator, by the benchmark's plain loader."""
    names = sorted(set(os.listdir(lab)) & set(os.listdir(img)))
    rng = np.random.default_rng(0)  # the dataset's default seed
    out = []
    for _ in range(steps):
        samples = [reference_data.draw(lab, names, rng, 32, load_size) for _ in range(batch)]
        labs, imgs = zip(*(reference_data.decode(lab, img, *s, 32) for s in samples))
        out.append((np.stack(labs), np.stack(imgs), [s[0] for s in samples]))
    return out


@pytest.mark.parametrize("ranks", [2, 4])
def test_each_rank_decodes_its_own_rows_of_the_same_draws(ranks, tmp_path, monkeypatch):
    """The ranks' rows of each global batch, put together, are the whole
    batch the dataset drew before, bit for bit; a rank opens the pixels of
    its own rows' pairs only."""
    lab, img = _pairs(tmp_path)
    B, steps = 8, 3
    want = _whole_batches(lab, img, B, steps)
    loaded = []
    load_pair = PairedRenderDataset._load_pair
    monkeypatch.setattr(PairedRenderDataset, "_load_pair",
                        lambda self, name: loaded.append(name) or load_pair(self, name))
    comms = [types.SimpleNamespace(rank=r, size=ranks) for r in range(ranks)]
    got = []
    for comm in comms:
        loaded.clear()
        ds = PairedRenderDataset(lab, img, crop_size=32, load_size=36)
        rows = rank_rows(comm, B)
        got.append(list(ds.batches(B, steps, rows)))
        assert loaded == [n for _, _, names in want for n in names[rows]]
    for s, (wl, wi, _) in enumerate(want):
        np.testing.assert_array_equal(np.concatenate([g[s][0] for g in got]), wl)
        np.testing.assert_array_equal(np.concatenate([g[s][1] for g in got]), wi)


def test_the_benchmarks_plain_loader_decodes_the_same_batches(tmp_path):
    """``benchmarks/reference/spade/data.py``, which the training cell's
    check holds the ranks' rows to, gives the dataset's batches bit for
    bit, skipped batches drawn and not decoded."""
    lab, img = _pairs(tmp_path)
    ds = PairedRenderDataset(lab, img, crop_size=32, load_size=36, seed=5)
    want = list(ds.batches(4, 5))[3:]
    got = reference_data.batches(lab, img, 5, 4, 32, 36, range(3, 5))
    assert len(got) == len(want) == 2
    for (gl, gi), (wl, wi) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gi, wi)


class _Comm:
    """A rank of a job that does nothing collective (the iterations are
    stubbed)."""

    backend = "gloo"

    def __init__(self, rank, size):
        self.rank, self.size = rank, size

    def barrier(self):
        pass


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_spade_train_draws_the_same_samples_for_any_number_of_ranks(ranks, tmp_path,
                                                                     monkeypatch):
    """``spade_train``'s training loop over two epochs feeds every rank its
    rows of the batches the CLI drew before (its init batch, then each
    epoch's), in order, with a G step every second iteration of an epoch."""
    lab, img = _pairs(tmp_path)
    B, steps, epochs = 4, 3, 2
    want = _whole_batches(lab, img, B, 1 + steps * epochs, load_size=int(32 * 1.12))[1:]
    seen = {}

    def iteration(trainer, state, batches, it, with_g):
        lab_, img_ = next(batches)
        seen.setdefault(rank, []).append((it, with_g, lab_.numpy(), img_.numpy()))
        return state, (lab_, img_), {"d_total": torch.zeros(())}

    monkeypatch.setattr(spade_train, "train_iteration", iteration)
    for rank in range(ranks):
        ns = types.SimpleNamespace(
            label_dir=lab, image_dir=img, niter=1, niter_decay=epochs - 1,
            steps_per_epoch=steps, batch=B, crop=32, ngf=8, ndf=8, d_steps_per_g=2, num_d=1,
            n_layers_d=2, no_vgg=True, use_vae=False, lambda_kld=0.05, kitti_skip_list=False,
            ckpt_dir=str(tmp_path / f"ckpt{ranks}_{rank}"), continue_train=False, log_every=100,
            display_every=1000, device="cpu", devices=ranks, timeout=60.0, profile=False)
        comm = None if ranks == 1 else _Comm(rank, ranks)
        assert spade_train.train(ns, torch.device("cpu"), comm) == 0
    for i, (wl, wi, _) in enumerate(want):
        its = [seen[r][i] for r in range(ranks)]
        assert {(it, g) for it, g, _, _ in its} == {(i, i % steps % 2 == 0)}
        np.testing.assert_array_equal(np.concatenate([t[2] for t in its]), wl)
        np.testing.assert_array_equal(np.concatenate([t[3] for t in its]), wi)
    assert all(len(seen[r]) == steps * epochs for r in range(ranks))


def test_prefetched_keeps_order_and_raises_where_the_item_was():
    def items():
        for i in range(3):
            yield np.full(2, i), np.full(1, -i)
        raise ValueError("broken input")

    with Prefetched(items()) as it:
        for i in range(3):
            a, b = next(it)
            assert torch.is_tensor(a) and int(a[0]) == i and int(b[0]) == -i
        with pytest.raises(ValueError, match="broken input"):
            next(it)
    with Prefetched(iter([(np.zeros(1),)] * 100)) as it:
        next(it)  # leaving early ends the worker
    assert not any(t.is_alive() for t in it._pool._threads)


def test_a_failed_rank_is_named_and_the_others_end_on_their_own():
    """Rank 1 fails at once; rank 0 fails a moment later, as a rank whose
    peer died fails in its next collective.  The launcher names rank 1,
    and rank 0 ends with its own exit code within the grace, unkilled."""
    prog = ("import os, sys, time; r = int(os.environ['RANK']); "
            "time.sleep(0.5 if r == 0 else 0); sys.exit(7 if r == 0 else 3)")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as e:
        distributed.spawn_ranks([sys.executable, "-c", prog], 2, "gloo", timeout=60)
    msg = str(e.value)
    assert "failed: rank 1 first (exit 3)" in msg and "rank 0 (exit 7)" in msg, msg
    assert time.monotonic() - t0 < distributed.GRACE_S + 10
