"""Port parity, SPADE training: the discriminator, the losses and VGG19,
one D step and one G step, the LR schedule, the paired training data, the
checkpoint in both directions and the spade_train and move_data CLIs,
against the JAX package on the CPU.

The training state is the port's seeded init (``init_state_numpy``: flax's
layout and distributions) with random batch-norm statistics, handed to JAX
through the port's checkpoint writer and flax's ``from_bytes``, so no test
pays for a flax init.  Sizes: ngf 8, ndf 8, crop 64, batch 2, two
discriminator scales of 2 layers (the JAX package's test sizes); the steps
run with VGG19 on, and with the VAE (encoder, KLD) with VGG19 off, which
the VGG tests cover on their own.  At crop 32 the generator's first block
sees a 1x1 grid, and its batch norm over two values amplifies float32
rounding past the stored-state tolerance; crop 64 gives it a 2x2 grid.

The steps are held against the JAX package run in float64.  Its float32
gradients on the CPU stray from its own float64 ones far beyond 1e-4 of a
leaf through VGG19's deeper layers, and one float32 rounding can flip a
ReLU's, a leaky ReLU's, a max pool's or an L1 term's choice, which at
these small feature maps moves a share of every leaf upstream of it
(``compare.float32_gradients_held`` says how far, card vs CPU).  So the
port runs each step in float32, the path it ships, and in
float64 (``TrainState.to``), which computes exactly what the JAX package
computes.

Tolerances:
  * losses: float32 1e-4 relative, float64 1e-7;
  * gradients (Adam's ``mu`` after one step: with b1 = 0 it is the
    gradient), float64: 1e-6 of each leaf's largest magnitude.  A bias that
    only a normalization reads (ahead of an instance or batch norm) has a
    true gradient of 0 and gets rounding noise; such a leaf, one whose
    largest is below 1e-4 of the network's largest, is held against the
    network's largest instead;
  * parameters after the step, float64: Adam's first step moves each by
    about +-lr * sign(g), so within 1e-6 * lr where |g| is at least 1e-3
    of its leaf's scale above, and within 2 * lr (a flipped sign) elsewhere;
  * stored state (SN ``u`` and ``sigma``, BN running statistics): float32
    1e-5, float64 1e-7 of each array's largest magnitude (the encoder's
    bilinear resize weights are float32 in JAX even in float64 mode);
  * features and generated images (float32): 1e-5 of the largest magnitude
    (1e-4 for a whole generator), losses outside the steps 1e-4;
  * learning rates, data batches and CLI files: exact.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from flax.traverse_util import flatten_dict
from PIL import Image

from surfelmapping_tpu.models import data as jdata
from surfelmapping_tpu.models import losses as jlosses
from surfelmapping_tpu.models import spade as jspade
from surfelmapping_tpu.models import train_utils as jtrain_utils
from surfelmapping_tpu.models.pix2pix import SpadeConfig as JaxConfig
from surfelmapping_tpu.models.pix2pix import SpadeTrainer as JaxTrainer
from surfelmapping_tpu.models.pix2pix import TrainState
from surfelmapping_tpu_torch import convert
from surfelmapping_tpu_torch.models import checkpoint, data, losses, spade, train_utils
from surfelmapping_tpu_torch.models.pix2pix import LR, SpadeConfig, SpadeTrainer, init_state_numpy
from surfelmapping_tpu_torch.tools.compare import flat, grad_gaps, grad_scales
from test_torch_spade import _nchw, _nhwc, _random_bn_stats

NGF, CROP, BATCH, Z_DIM = 8, 64, 2, 16
SMALL = dict(ngf=NGF, ndf=NGF, crop_size=CROP, num_d=2, n_layers_d=2)


def _configs(use_vae: bool, **kw) -> tuple[SpadeConfig, JaxConfig]:
    args = dict(SMALL, use_vae=use_vae, z_dim=Z_DIM, **kw)
    return SpadeConfig(**args), JaxConfig(**args)


def _scale_close(got, want, rel, where=""):
    """|got - want| <= rel * max|want|, array for array."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, where
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale or err == 0.0, (where, err, scale)


def _trees_close(got: dict, want: dict, rel: float):
    g, w = flatten_dict(got), flatten_dict(want)
    assert g.keys() == w.keys()
    for k in w:
        _scale_close(g[k], w[k], rel, "/".join(k))


def _same(a, b) -> bool:
    """Two trees hold the same keys, dtypes and bits, in any key order."""
    return checkpoint.packb(a) == checkpoint.packb(b)


def _jax_state(tree: dict, jcfg: JaxConfig, init=JaxTrainer.init_state) -> TrainState:
    """The JAX package's TrainState for ``tree``, as its spade_train restores
    a checkpoint: flax's ``from_bytes`` onto ``init_state``'s structure,
    here from the port's writer."""
    jt = JaxTrainer(jcfg)
    lab = jnp.zeros((BATCH, jcfg.crop_size, jcfg.crop_size, 3), jnp.float32)
    shapes = jax.eval_shape(lambda a, b: init(jt, a, b), lab, lab)
    restored = serialization.from_bytes(dataclasses.asdict(shapes), checkpoint.packb(tree))
    return TrainState(**restored)


def _state_tree(state: TrainState) -> dict:
    return serialization.to_state_dict(jax.device_get(dataclasses.asdict(state)))


def _batch(seed: int, n: int = BATCH, hw: int = CROP) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, (n, hw, hw, 3)).astype(np.float32) for _ in range(2))


@pytest.fixture(scope="module", autouse=True)
def _no_pretrained_vgg():
    """Both packages' VGG comes from the state, not from SMTPU_VGG19."""
    saved = os.environ.pop("SMTPU_VGG19", None)
    yield
    if saved is not None:
        os.environ["SMTPU_VGG19"] = saved


def _f64(tree):
    """``tree`` with its float32 arrays in float64."""
    return jax.tree.map(lambda a: a.astype(np.float64) if a.dtype == np.float32 else a, tree)


def _run_steps(use_vae: bool) -> dict:
    """One d_step and one g_step, each from the same initial state and batch:
    the port's in float32 and float64, the JAX package's in float64 (see
    the module docstring), the VAE noise as the JAX package draws it."""
    cfg, jcfg = _configs(use_vae, use_vgg=not use_vae)
    tree = init_state_numpy(cfg)
    _random_bn_stats(tree["g_batch_stats"], np.random.default_rng(1))
    label, real = _batch(2)
    jt = JaxTrainer(jcfg, seed=0)
    out = {"tree": tree, "cfg": cfg, "jt": jt}
    noise = {}
    with jax.enable_x64(True):
        s0 = _jax_state(_f64(tree), jcfg)
        for name in ("d_step", "g_step"):
            s1, logs = getattr(jt, name)(s0, jnp.asarray(label, jnp.float64),
                                         jnp.asarray(real, jnp.float64))
            out[name] = (_state_tree(s1), {k: float(v) for k, v in logs.items()})
        if use_vae:
            for name, key in (("g_step", 0), ("d_step", 0 ^ 0x5EED)):
                rng = jax.random.fold_in(jax.random.PRNGKey(key), 0)
                noise[name] = torch.tensor(np.asarray(
                    jax.random.normal(rng, (BATCH, Z_DIM), jnp.float64)), dtype=torch.float32)
    port = {}
    for dtype in (torch.float32, torch.float64):
        for name in ("d_step", "g_step"):
            tr = SpadeTrainer(cfg, device="cpu")
            st, logs = getattr(tr, name)(tr.state_from_numpy(tree).to(dtype),
                                         torch.from_numpy(label).to(dtype),
                                         torch.from_numpy(real).to(dtype), noise=noise.get(name))
            port[name, str(dtype)[6:]] = (tr.state_to_numpy(st),
                                          {k: float(v) for k, v in logs.items()})
    out["port"] = port
    return out


# -- modules and losses -----------------------------------------------------


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("n_layers", [2, 4])
def test_discriminator_matches_jax(n_layers, train):
    """Every scale's every feature, and the stored u and sigma (moved in
    training mode only)."""
    cfg = SpadeConfig(**{**SMALL, "n_layers_d": n_layers})
    module = spade.MultiscaleDiscriminator(2, NGF, n_layers, device="meta")
    v = convert.init_numpy(module, torch.Generator().manual_seed(n_layers))
    x = np.random.default_rng(n_layers).uniform(-1, 1, (BATCH, CROP, CROP, 6)).astype(np.float32)
    jd = jspade.MultiscaleDiscriminator(num_d=2, ndf=NGF, n_layers=n_layers)
    want, upd = jax.jit(lambda v, x: jd.apply(v, x, train=train, mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    port = convert.load_numpy(module, v, "cpu", trainable=True).train(train)
    got = port(_nchw(x))
    assert len(got) == cfg.num_d and all(len(s) == n_layers + 1 for s in got)
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            _scale_close(_nhwc(g.detach()), w, 1e-5)
    stats = convert.to_numpy(port)["batch_stats"]
    _trees_close(stats, jax.device_get(upd["batch_stats"]), 1e-5)
    moved = [k for k, a in flatten_dict(stats).items()
             if not np.array_equal(a, flatten_dict(v["batch_stats"])[k])]
    assert bool(moved) == train


def test_spade_norm_train_mode_matches_jax():
    """Batch statistics (flax's fast variance) and the running averages."""
    rng = np.random.default_rng(3)
    x = rng.normal(0.5, 2, (2, 8, 12, 16)).astype(np.float32)
    seg = rng.uniform(-1, 1, (2, 20, 30, 3)).astype(np.float32)
    module = spade.SPADENorm(16, device="meta")
    v = convert.init_numpy(module, torch.Generator().manual_seed(3))
    _random_bn_stats(v["batch_stats"], rng)
    want, upd = jspade.SPADENorm(16).apply(v, jnp.asarray(x), jnp.asarray(seg), train=True,
                                           mutable=["batch_stats"])
    port = convert.load_numpy(module, v, "cpu", trainable=True).train()
    _scale_close(_nhwc(port(_nchw(x), _nchw(seg)).detach()), want, 1e-5)
    _trees_close(convert.to_numpy(port)["batch_stats"], jax.device_get(upd["batch_stats"]), 1e-6)


@pytest.fixture(scope="module")
def vgg_params():
    return {"params": convert.init_numpy(losses.VGG19Features("meta"),
                                         torch.Generator().manual_seed(5))["params"]}


def _feats(rng, shapes):
    return [[rng.normal(0, 1, s).astype(np.float32) for s in shapes] for _ in range(2)]


@pytest.mark.parametrize("loss", ["hinge_d", "hinge_g", "multiscale_hinge_d",
                                  "multiscale_hinge_g", "feature_matching", "kld", "vgg"])
def test_loss_matches_jax(loss, vgg_params):
    rng = np.random.default_rng(6)
    shapes = [(2, 4, 9, 9), (2, 8, 5, 5), (2, 1, 6, 6)]
    real, fake = _feats(rng, shapes), _feats(rng, shapes)
    t = lambda feats: [[torch.from_numpy(a) for a in s] for s in feats]  # noqa: E731
    j = lambda feats: [[jnp.asarray(a.transpose(0, 2, 3, 1)) for a in s] for s in feats]  # noqa
    a, b = rng.normal(0, 1, (2, 1, 6, 6)).astype(np.float32), rng.normal(0, 1, (2, 1, 6, 6))
    b = b.astype(np.float32)
    if loss == "hinge_d":
        got, want = losses.hinge_d_loss(torch.from_numpy(a), torch.from_numpy(b)), \
            jlosses.hinge_d_loss(jnp.asarray(a), jnp.asarray(b))
    elif loss == "hinge_g":
        got, want = losses.hinge_g_loss(torch.from_numpy(a)), jlosses.hinge_g_loss(jnp.asarray(a))
    elif loss == "multiscale_hinge_d":
        got, want = losses.multiscale_hinge_d(t(real), t(fake)), \
            jlosses.multiscale_hinge_d(j(real), j(fake))
    elif loss == "multiscale_hinge_g":
        got, want = losses.multiscale_hinge_g(t(fake)), jlosses.multiscale_hinge_g(j(fake))
    elif loss == "feature_matching":
        got, want = losses.feature_matching_loss(t(real), t(fake), 10.0), \
            jlosses.feature_matching_loss(j(real), j(fake), 10.0)
    elif loss == "kld":
        mu, logvar = (rng.normal(0, 1, (2, Z_DIM)).astype(np.float32) for _ in range(2))
        got, want = losses.kld_loss(torch.from_numpy(mu), torch.from_numpy(logvar)), \
            jlosses.kld_loss(jnp.asarray(mu), jnp.asarray(logvar))
    else:
        f, r = _batch(7)
        vgg = convert.load_numpy(losses.VGG19Features("meta"), vgg_params, "cpu")
        got = losses.vgg_loss(vgg, _nchw(f), _nchw(r), 10.0)
        want = jlosses.vgg_loss(lambda p, x: jlosses.VGG19Features().apply(p, x), vgg_params,
                                jnp.asarray(f), jnp.asarray(r), 10.0)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_vgg19_features_match_jax(vgg_params):
    """relu1_1 .. relu5_1 from JAX's VGG19 params carried across."""
    x = _batch(8)[0]
    want = jlosses.VGG19Features().apply(vgg_params, jnp.asarray(x))
    got = convert.load_numpy(losses.VGG19Features("meta"), vgg_params, "cpu")(_nchw(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _scale_close(_nhwc(g), w, 1e-5)


@pytest.mark.parametrize("source", ["npz", "pth", "env", "missing"])
def test_load_vgg19_weights_matches_jax(source, vgg_params, tmp_path, monkeypatch):
    p = vgg_params["params"]
    if source == "pth":
        path = tmp_path / "vgg19.pth"
        torch.save({f"features.{li}.{n}": torch.from_numpy(
            p[f"conv{i}"]["kernel"].transpose(3, 2, 0, 1).copy() if n == "weight"
            else p[f"conv{i}"]["bias"]) for i, li in enumerate(losses.TORCHVISION_CONV_INDEX)
            for n in ("weight", "bias")}, path)
    else:
        path = tmp_path / "vgg19.npz"
        if source != "missing":
            np.savez(path, **{f"conv{i}_{k}": p[f"conv{i}"][k] for i in range(16)
                              for k in ("kernel", "bias")})
    arg = str(path)
    if source == "env":
        monkeypatch.setenv("SMTPU_VGG19", str(path))
        arg = None
    got, want = losses.load_vgg19_weights(arg), jlosses.load_vgg19_weights(arg)
    if source == "missing":
        assert got is None and want is None
        return
    assert _same(got, jax.tree.map(np.asarray, want))
    assert _same(got, vgg_params)


# -- the training steps -----------------------------------------------------


def test_init_state_has_flax_layout():
    """init_state_numpy's tree is the JAX TrainState's state dict: the same
    keys, shapes and dtypes (flax's init structure by jax.eval_shape)."""
    for use_vae in (False, True):
        cfg, jcfg = _configs(use_vae)
        jt = JaxTrainer(jcfg)
        lab = jnp.zeros((1, CROP, CROP, 3), jnp.float32)
        want = serialization.to_state_dict(dataclasses.asdict(jax.eval_shape(
            jt.init_state, lab, lab)))
        got = init_state_numpy(cfg)
        shape = lambda t: {k: (tuple(np.shape(v)), np.dtype(v.dtype))  # noqa: E731
                           for k, v in flatten_dict(t, keep_empty_nodes=True).items()
                           if hasattr(v, "dtype")}
        assert shape(got) == shape(want)
        empty = lambda t: sorted(k for k, v in flatten_dict(  # noqa: E731
            t, keep_empty_nodes=True).items() if not hasattr(v, "dtype"))
        assert empty(got) == empty(want)


STEP_TOLERANCES = {"float32": dict(loss=1e-4, stats=1e-5),
                   "float64": dict(loss=1e-7, stats=1e-7)}


def _check_losses(steps, step, precision):
    (_, want), (_, got) = steps[step], steps["port"][step, precision]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=STEP_TOLERANCES[precision]["loss"],
                                   err_msg=k)
    if step == "g_step":
        assert ("g_kld" in got) == steps["cfg"].use_vae


def _check_gradients_and_params(steps, step):
    """Adam's mu (the gradient, b1 = 0) and its count, the hyperparameters,
    the params and the step counter, in float64; the other network's params
    do not move."""
    (want, _), (got, _) = steps[step], steps["port"][step, "float64"]
    net, other = ("d", "g") if step == "d_step" else ("g", "d")
    opt_w, opt_g = want[f"{net}_opt"], got[f"{net}_opt"]
    lr = float(opt_w["hyperparams"]["learning_rate"])
    mu = flat(opt_w["inner_state"]["0"]["mu"])
    scales = grad_scales(mu)
    gaps = grad_gaps(opt_g["inner_state"]["0"]["mu"], opt_w["inner_state"]["0"]["mu"])
    assert max(gaps.values()) <= 1e-6, max(gaps, key=gaps.get)
    assert int(opt_g["count"]) == int(opt_w["count"]) == 1
    assert int(opt_g["inner_state"]["0"]["count"]) == 1
    assert {k: float(v) for k, v in opt_g["hyperparams"].items()} == \
        {k: float(v) for k, v in opt_w["hyperparams"].items()}
    for k, p in flat(got[f"{net}_params"]).items():
        w, g = flat(want[f"{net}_params"])[k], mu[k]
        sure = np.abs(g) >= 1e-3 * scales[k]
        err = np.abs(p - w)
        assert err[sure].max(initial=0) <= 1e-6 * lr and err.max() <= 2 * lr, k
    assert _same(steps["port"][step, "float32"][0][f"{other}_params"],
                 steps["tree"][f"{other}_params"])
    assert int(got["step"]) == int(want["step"]) == (1 if step == "g_step" else 0)


def _check_stored_state(steps, step, precision):
    """The trained net's SN u and sigma and BN running statistics (the G
    step's, with the encoder's u); the other net's state is not stored."""
    (want, _), (got, _) = steps[step], steps["port"][step, precision]
    net, other = ("d", "g") if step == "d_step" else ("g", "d")
    _trees_close(got[f"{net}_batch_stats"], want[f"{net}_batch_stats"],
                 STEP_TOLERANCES[precision]["stats"])
    before = steps["tree"]
    if precision == "float32":
        assert _same(got[f"{other}_batch_stats"], before[f"{other}_batch_stats"])
    moved = [k for k, a in flatten_dict(got[f"{net}_batch_stats"]).items()
             if not np.array_equal(a, flatten_dict(before[f"{net}_batch_stats"])[k])]
    assert moved


def _check_checkpoint(steps, tmp_path):
    """The port's checkpoint after its G step: flax restores it onto the JAX
    TrainState, the JAX spade_train would write that state as the same
    bytes, and JAX's infer on it
    equals the port's; the port reads it back bit for bit."""
    tree = steps["port"]["g_step", "float32"][0]
    path = tmp_path / "latest.msgpack"
    checkpoint.save_train_state(str(path), tree)
    raw = path.read_bytes()
    jcfg = _configs(steps["cfg"].use_vae, use_vgg=steps["cfg"].use_vgg)[1]
    js = _jax_state(checkpoint.load_train_state(str(path)), jcfg)
    assert serialization.to_bytes(jax.device_get(dataclasses.asdict(js))) == raw  # as written
    tr = SpadeTrainer(steps["cfg"], device="cpu")
    st = tr.state_from_numpy(checkpoint.load_train_state(str(path)))
    assert checkpoint.packb(tr.state_to_numpy(st)) == raw
    label, real = _batch(9)
    style = real if steps["cfg"].use_vae else None
    want = steps["jt"].infer(js, jnp.asarray(label), None if style is None else
                             jnp.asarray(style))
    got = tr.infer(torch.from_numpy(label), None if style is None else torch.from_numpy(style),
                   state=st)
    _scale_close(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("use_vae", [False, True], ids=["plain", "vae"])
def test_steps_match_jax(use_vae, tmp_path):
    """One D step and one G step against the JAX package's (see the module
    docstring), then the port's checkpoint under flax.  One test per
    configuration, so that the JAX steps compile once in whichever worker
    runs it."""
    steps = _run_steps(use_vae)
    for step in ("d_step", "g_step"):
        for precision in ("float32", "float64"):
            _check_losses(steps, step, precision)
            _check_stored_state(steps, step, precision)
        _check_gradients_and_params(steps, step)
    _check_checkpoint(steps, tmp_path)


@pytest.mark.parametrize("niter,niter_decay", [(3, 4), (1, 1), (2, 5)])
def test_lr_schedule_matches_jax(niter, niter_decay):
    """update_learning_rate over niter + niter_decay epochs (and one more),
    both learning rates equal as float32 after every epoch."""
    cfg, jcfg = _configs(False, niter=niter, niter_decay=niter_decay, use_vgg=False)
    assert jcfg.lr == LR
    jt = JaxTrainer(jcfg)
    w = {"w": np.zeros(1, np.float32)}  # update_learning_rate reads only the optimizers
    js = TrainState(g_params=w, g_batch_stats={}, d_params=w, d_batch_stats={},
                    g_opt=jt.g_tx.init(w), d_opt=jt.d_tx.init(w), vgg_params=None, step=0)
    tr = SpadeTrainer(cfg, device="cpu")
    st = tr.state_from_numpy(init_state_numpy(cfg))
    for epoch in range(1, niter + niter_decay + 2):
        js = jt.update_learning_rate(js, epoch)
        st = tr.update_learning_rate(st, epoch)
        assert tr.current_lrs(st) == jt.current_lrs(js), epoch
        assert tr.old_lr == jt.old_lr
    assert tr.current_lrs(st) == (0.0, 0.0)


# -- data, bookkeeping and the CLIs -----------------------------------------


def _write_pairs(root, rng, sizes, names=None):
    lab, img = root / "label", root / "image"
    lab.mkdir()
    img.mkdir()
    names = names or [f"{i:06d}.png" for i in range(len(sizes))]
    for n, (h, w) in zip(names, sizes):
        a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(a).save(lab / n)
        Image.fromarray(a[::-1].copy()).save(img / n)
    return lab, img


@pytest.mark.parametrize("seed,skip", [(0, ()), (3, ((0, 56), (69, 134)))])
def test_paired_dataset_matches_jax(seed, skip, tmp_path):
    """The same names and batches, bit for bit (crop, flip, erasing and the
    PIL resizes drawn in the same order); random_erasing alone too."""
    lab, img = _write_pairs(tmp_path, np.random.default_rng(seed),
                            [(40, 130), (50, 60), (37, 37), (64, 90)],
                            ["000010.png", "000060.png", "000070.png", "notes.png"])
    kw = dict(crop_size=32, load_size=36, seed=seed, skip_ranges=skip)
    ours, ref = data.PairedRenderDataset(str(lab), str(img), **kw), \
        jdata.PairedRenderDataset(str(lab), str(img), **kw)
    assert ours.names == ref.names and len(ours) == len(ref)
    for (l1, i1), (l2, i2) in zip(ours.batches(3, 4), ref.batches(3, 4)):
        assert l1.dtype == l2.dtype == np.float32 and l1.shape == (3, 32, 32, 3)
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(i1, i2)
    x = np.random.default_rng(seed).uniform(0, 1, (40, 50, 3)).astype(np.float32)
    for p in (1.0, 0.8, 0.0):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(data.random_erasing(x, a, p=p),
                                      jdata.random_erasing(x, b, p=p))
        assert a.random() == b.random()  # the same number of draws


def test_train_utils_match_jax(tmp_path):
    """IterationCounter's cursor and iter.txt, the Visualizer's files,
    the options files and to_uint8_image."""
    for mod in (train_utils, jtrain_utils):
        d = tmp_path / mod.__name__.split(".")[0]
        c = mod.IterationCounter(str(d), 6, 2, 1, 1)
        d.mkdir(exist_ok=True)
        for e in c.training_epochs():
            c.record_epoch_start(e)
            for _ in range(3):
                c.record_one_iteration()
            c.record_current_iter()
            c.record_epoch_end()
        v = mod.Visualizer(str(d))
        v.print_current_errors(1, 2, {"b": 1.25, "a": np.float32(2.5)})
        v.display_current_results({"x": np.zeros((4, 4, 3), np.float32)}, 1, 6)
        mod.save_options(str(d), {"crop": 32, "name": "s"})
        c2 = mod.IterationCounter(str(d), 6, 2, 1, 1, continue_train=True)
        assert (c2.first_epoch, c2.epoch_iter, c2.total_steps_so_far) == (3, 0, 12)
        assert mod.load_options(str(d)) == {"crop": 32, "name": "s"}
    a, b = tmp_path / "surfelmapping_tpu_torch", tmp_path / "surfelmapping_tpu"
    for rel in ("iter.txt", "opt.txt", "web/index.html"):
        assert (a / rel).read_text() == (b / rel).read_text(), rel
    log = lambda d: (d / "loss_log.txt").read_text().splitlines()[1:]  # noqa: E731
    assert log(a) == log(b)
    assert sorted(os.listdir(a / "web/images")) == sorted(os.listdir(b / "web/images"))
    x = np.linspace(-1.5, 1.5, 24, dtype=np.float32).reshape(2, 4, 3)
    np.testing.assert_array_equal(train_utils.to_uint8_image(x), jtrain_utils.to_uint8_image(x))


def _cli_files(ckpt) -> dict:
    """What the CLI leaves in its checkpoint directory, less its run's own
    numbers: iter.txt, the loss log's epochs, iterations and keys, opt.txt
    (its own path read as CKPT) without the port's --device, --devices,
    --timeout and --profile lines, and the gallery's file names."""
    log = [ln for ln in (ckpt / "loss_log.txt").read_text().splitlines()
           if not ln.startswith("===")]
    keys = [(ln.split(")")[0], [w for w in ln.split(")")[1].split() if w.endswith(":")])
            for ln in log]
    opt = [ln.replace(str(ckpt), "CKPT") for ln in (ckpt / "opt.txt").read_text().splitlines()
           if not ln.startswith(("device:", "devices:", "timeout:", "profile:"))]
    return {"iter": (ckpt / "iter.txt").read_text(), "log": keys, "opt": opt,
            "images": sorted(os.listdir(ckpt / "web" / "images")),
            "files": sorted(os.listdir(ckpt))}


def test_spade_train_cli_matches_jax(tmp_path, monkeypatch):
    """Both CLIs train 2 epochs of 2 steps from the same state and PNGs and
    write the same files; then each resumes the JAX CLI's checkpoint with
    --continue-train and one more epoch of decay (from the cursor that
    iter.txt recorded: epoch 2, so epochs 2 and 3 run).  The port restores the JAX
    checkpoint bit for bit, and its own checkpoint restores under flax."""
    import spade_train as jax_cli

    from surfelmapping_tpu_torch import spade_train as port_cli

    cfg = SpadeConfig(ngf=NGF, ndf=NGF, crop_size=CROP, num_d=1, n_layers_d=2, use_vgg=False)
    tree = init_state_numpy(cfg)
    monkeypatch.setattr(JaxTrainer, "init_state",
                        lambda self, lab, img: _jax_state(tree, self.cfg))
    lab, img = _write_pairs(tmp_path, np.random.default_rng(0), [(40, 48)] * 3)
    argv = ["--label-dir", str(lab), "--image-dir", str(img), "--niter", "1",
            "--niter-decay", "1", "--steps-per-epoch", "2", "--crop", str(CROP), "--ngf",
            str(NGF), "--ndf", str(NGF), "--num-d", "1", "--n-layers-d", "2", "--no-vgg",
            "--log-every", "1", "--display-every", "3"]
    run = {"jax": lambda a: jax_cli.main(a), "port": lambda a: port_cli.main(a + ["--device",
                                                                                   "cpu"])}
    for who in ("jax", "port"):
        assert run[who](argv + ["--ckpt-dir", str(tmp_path / who)]) == 0
    assert _cli_files(tmp_path / "port") == _cli_files(tmp_path / "jax")
    # the end-of-epoch save records (epoch, iterations) over iter.txt's (epoch + 1, 0)
    assert _cli_files(tmp_path / "jax")["iter"] == "2\n2\n"
    jax_ckpt = checkpoint.load_train_state(str(tmp_path / "jax" / "latest.msgpack"))
    tr = SpadeTrainer(cfg, device="cpu")
    assert _same(tr.state_to_numpy(tr.state_from_numpy(jax_ckpt)), jax_ckpt)
    _jax_state(checkpoint.load_train_state(str(tmp_path / "port" / "latest.msgpack")),
               JaxConfig(ngf=NGF, ndf=NGF, crop_size=CROP, num_d=1, n_layers_d=2,
                         use_vgg=False))

    resume = argv[:]
    resume[resume.index("--niter-decay") + 1] = "2"
    for who in ("jax", "port"):
        shutil.copytree(tmp_path / "jax", tmp_path / f"resumed_{who}")
        assert run[who](resume + ["--ckpt-dir", str(tmp_path / f"resumed_{who}"),
                                  "--continue-train"]) == 0
    got, want = (_cli_files(tmp_path / f"resumed_{w}") for w in ("port", "jax"))
    assert got == want and want["iter"] == "3\n2\n"  # epochs 2 and 3 ran again
    resumed = checkpoint.load_train_state(str(tmp_path / "resumed_port" / "latest.msgpack"))
    assert int(resumed["g_opt"]["count"]) == int(jax_ckpt["g_opt"]["count"]) + 2
    assert float(resumed["g_opt"]["hyperparams"]["learning_rate"]) == 0.0  # the decay replayed


@pytest.mark.parametrize("fake", [False, True], ids=["move", "fake"])
def test_move_data_cli_matches_jax(fake, tmp_path, capsys):
    """The same moves (printed and done) from the same novel-view tree."""
    import move_data as jax_cli

    from surfelmapping_tpu_torch import move_data as port_cli

    outs = {}
    for who, cli in (("jax", jax_cli), ("port", port_cli)):
        src = tmp_path / who / "novel"
        for sub in ("image", "semantic"):
            (src / sub).mkdir(parents=True)
            for fid in (0, 7, 12):
                (src / sub / f"{fid}.png").write_bytes(f"{sub}{fid}".encode())
        dst = tmp_path / who / "dataset"
        assert cli.main(["--offset", "100", "-t", str(dst), "-s", str(src)]
                        + (["--fake"] if fake else [])) == 0
        printed = capsys.readouterr().out.replace(str(tmp_path / who), "ROOT")
        moved = sorted(str(p.relative_to(tmp_path / who)) for p in (tmp_path / who).rglob("*")
                       if p.is_file())
        outs[who] = (printed, moved)
    assert outs["port"] == outs["jax"]
    assert ("dataset/image/000112.png" in outs["port"][1]) != fake
