"""SPADE's two training steps and the TTUR Adam (SPADE's
pix2pix_trainer.py and pix2pix_model.py, as LADS trains): a D step
discriminates the generator's fake (generator in eval mode) and the real
image, each beside its label, in one batch and descends the hinge loss; a
G step (discriminator in eval mode) descends hinge + feature matching +
VGG (+ KLD with the encoder).  Each step takes the global batch and
``parts`` (see the package's docstring)."""

from __future__ import annotations

import dataclasses

import torch

from benchmarks.reference.spade import model
from benchmarks.reference.spade.model import Config

BUFFERS = (".mean", ".var", ".u", ".sigma")


def trainable(name: str) -> bool:
    return not name.endswith(BUFFERS)


@dataclasses.dataclass
class Adam:
    """Adam as optax computes it: mu and nu per weight, the step count, and
    w -= lr * mu_hat / (sqrt(nu_hat) + eps), mu_hat and nu_hat bias-corrected."""

    count: int
    mu: dict
    nu: dict

    @torch.no_grad()
    def update(self, params: dict, grads: dict, lr: float, cfg: Config) -> None:
        self.count += 1
        b1, b2 = cfg.beta1, cfg.beta2
        for k, g in grads.items():
            self.mu[k] = b1 * self.mu[k] + (1 - b1) * g
            self.nu[k] = b2 * self.nu[k] + (1 - b2) * g * g
            mu_hat = self.mu[k] / (1 - b1 ** self.count)
            nu_hat = self.nu[k] / (1 - b2 ** self.count)
            params[k] = params[k] - lr * mu_hat / (torch.sqrt(nu_hat) + cfg.eps)


@dataclasses.dataclass
class State:
    """The weights and buffers of the generator (``gen``), the encoder
    (``enc``, None without the VAE), the discriminator (``d``) and VGG19
    (``vgg``, None without the VGG loss), by the program's names, and each
    trained network's Adam (the generator's over ``gen.``- and
    ``enc.``-prefixed names)."""

    gen: dict
    enc: dict | None
    d: dict
    vgg: dict | None
    g_adam: Adam
    d_adam: Adam

    def g_params(self) -> dict:
        out = {f"gen.{k}": v for k, v in self.gen.items() if trainable(k)}
        if self.enc is not None:
            out.update({f"enc.{k}": v for k, v in self.enc.items() if trainable(k)})
        return out


def _with_grad(p: dict) -> dict:
    return {k: v.detach().requires_grad_(trainable(k)) for k, v in p.items()}


def _generate(st: State, gen: dict, enc: dict | None, segs, imgs, noise, cfg, train, new_g,
              new_e, recompute):
    """(fake images per part, (mus, logvars) or None)."""
    zs, aux = None, None
    if cfg.use_vae:
        mus, logvars = model.encoder(enc, imgs, cfg, train, new_e)
        rows = [m.shape[0] for m in mus]
        zs = [mu + torch.exp(0.5 * lv) * n for mu, lv, n in zip(mus, logvars, noise.split(rows))]
        aux = (mus, logvars)
    logits = model.generator(gen, segs, zs, cfg, train, new_g, recompute)
    return [torch.tanh(x) for x in logits], aux


def _discriminate(d: dict, segs, fakes, reals, cfg, train, new):
    """(fake features, real features): each part's fake then real, beside
    its label, in one batch."""
    both = [torch.cat([torch.cat([s, f], 1), torch.cat([s, r], 1)], 0)
            for s, f, r in zip(segs, fakes, reals)]
    feats = model.discriminator(d, both, cfg, train, new)
    ns = [s.shape[0] for s in segs]
    split = lambda sel: [[[t[:n] if sel else t[n:] for t, n in zip(layer, ns)]  # noqa: E731
                          for layer in scale] for scale in feats]
    return split(True), split(False)


def d_step(st: State, seg, img, noise, cfg: Config, parts: int = 1) -> dict:
    """One discriminator step on the global NCHW batch ``seg``, ``img`` in
    [-1, 1] (``noise``: the global batch's VAE noise); updates ``st``;
    returns the loss."""
    model.full_float32()
    segs, imgs = list(seg.chunk(parts)), list(img.chunk(parts))
    with torch.no_grad():
        fakes, _ = _generate(st, st.gen, st.enc, segs, imgs, noise, cfg, False, None, None,
                             False)
    d = _with_grad(st.d)
    new: dict = {}
    fake_f, real_f = _discriminate(d, segs, fakes, imgs, cfg, True, new)
    loss = model.hinge_d(real_f, fake_f)
    names = [k for k in d if trainable(k)]
    grads = dict(zip(names, torch.autograd.grad(loss, [d[k] for k in names])))
    params = {k: st.d[k] for k in names}
    st.d_adam.update(params, grads, cfg.d_lr, cfg)
    st.d = {**st.d, **params, **new}
    return {"d_total": loss.detach()}


def g_step(st: State, seg, img, noise, cfg: Config, parts: int = 1,
           recompute: bool = True) -> dict:
    """One generator step (and the encoder's) on the global batch; updates
    ``st``; returns the losses."""
    model.full_float32()
    segs, imgs = list(seg.chunk(parts)), list(img.chunk(parts))
    gen, enc = _with_grad(st.gen), None if st.enc is None else _with_grad(st.enc)
    new_g: dict = {}
    new_e: dict = {}
    fakes, aux = _generate(st, gen, enc, segs, imgs, noise, cfg, True, new_g, new_e, recompute)
    fake_f, real_f = _discriminate(st.d, segs, fakes, imgs, cfg, False, None)
    logs = {"g_gan": model.hinge_g(fake_f),
            "g_fm": model.feature_matching(real_f, fake_f, cfg.lambda_feat)}
    logs["g_vgg"] = (model.vgg_loss(st.vgg, fakes, imgs, cfg.lambda_vgg) if cfg.use_vgg
                     else torch.zeros((), device=seg.device))
    total = logs["g_gan"] + logs["g_fm"] + logs["g_vgg"]
    if aux is not None:
        logs["g_kld"] = model.kld(*aux) * cfg.lambda_kld
        total = total + logs["g_kld"]
    logs["g_total"] = total
    named = {f"gen.{k}": v for k, v in gen.items() if trainable(k)}
    if enc is not None:
        named.update({f"enc.{k}": v for k, v in enc.items() if trainable(k)})
    grads = dict(zip(named, torch.autograd.grad(total, list(named.values()))))
    params = st.g_params()
    st.g_adam.update(params, grads, cfg.g_lr, cfg)
    st.gen = {**st.gen, **{k[4:]: v for k, v in params.items() if k.startswith("gen.")}, **new_g}
    if st.enc is not None:
        st.enc = {**st.enc, **{k[4:]: v for k, v in params.items() if k.startswith("enc.")},
                  **new_e}
    return {k: v.detach() for k, v in logs.items()}
