"""Pix2Pix(SPADE): the model bundle, its inference and its training
(counterpart of surfelmapping_tpu/models/pix2pix.py).

``SpadeTrainer.infer`` is the reference's inference mode
(pix2pix_model.py:93-100): the label-conditioned generator, or with a VAE
the generator from the encoder's deterministic ``mu`` of a style image, or
from z = 0 without one.  Its weights come from flax variables: a
checkpoint (``models/checkpoint.py``) or :func:`init_variables`, a seeded
init that draws from flax's own initialisers.

Training (SPADE/trainers/pix2pix_trainer.py, models/pix2pix_model.py) runs
on a :class:`TrainState`, which carries the JAX package's TrainState in
torch form:
  * TTUR Adam with betas (0, 0.9): G at lr/2, D at lr*2, optax's formula,
    the learning rate held as optimizer state (``inject_hyperparams``);
  * losses: multiscale hinge GAN + feature-matching L1 (+ VGG, + KLD with a
    VAE);
  * fake and real are discriminated in ONE batch (pix2pix_model.py:208-223);
  * ``g_step`` runs D in eval mode (its ``u`` is not stored, its params do
    not move), ``d_step`` runs G in eval mode (BN at the running
    statistics); ``step`` counts G steps;
  * linear LR decay after ``niter`` epochs (pix2pix_trainer.py:66-86).
Everything runs in float32 with TF32 off for convolutions and matmuls.

Data parallel (the JAX CLI's sharded jit over a ``data`` mesh): a trainer
with a ``parallel.distributed.Comm`` of D ranks takes each step on the
rank's rows of the global batch (:func:`shard_batch`), and the step equals
the one-process step on the global batch:
  * the generator's batch norms take the global statistics
    (``spade.SPADENorm.batch_statistics``);
  * each rank weights its batch means (hinge, feature matching, VGG) by 1/D
    and keeps its KLD, a sum over the batch, whole; the SUM over the ranks
    of the gradients is then the global loss's gradient.  (The JAX
    ``axis_name`` form, a pmean of the gradients, scales the KLD's by 1/D;
    its CLI takes the sharded jit, which this follows);
  * the gradients, flattened into one buffer with the logs at its end, are
    summed in ONE all-reduce per step, so every rank's Adam moves the same
    parameters by the same bytes and the logs are global values;
  * the VAE noise is drawn for the global batch from the same generator on
    every rank, and each rank takes its rows.
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext

import numpy as np
import torch
import torch.nn as nn

from .. import convert
from ..ops.transforms import full_precision_matmul
from ..parallel.distributed import Comm
from ..parallel.distributed import shard_rows as shard_batch  # the JAX package's name
from ..pipeline import resolve_device
from ..utils import tracing
from .losses import (VGG19Features, feature_matching_loss, kld_loss, load_vgg19_weights,
                     multiscale_hinge_d, multiscale_hinge_g, vgg_loss)
from .spade import LABEL_NC, MultiscaleDiscriminator, build_modules

ADAM_HYPERPARAMS = ("learning_rate", "b1", "b2", "eps", "eps_root")
LR, BETA1, BETA2, ADAM_EPS = 2e-4, 0.0, 0.9, 1e-8  # TTUR Adam (pix2pix_model.py:70-79)
LAMBDA_FEAT = LAMBDA_VGG = 10.0
G_NOISE_SEED, D_NOISE_SEED = 0, 1  # the VAE noise streams of g_step and d_step


@dataclasses.dataclass
class SpadeConfig:
    """The GAN's settings (pix2pix.py:43-66)."""

    ngf: int = 64
    ndf: int = 64
    crop_size: int = 256
    aspect_ratio: float = 1.0
    use_vae: bool = False
    z_dim: int = 256
    use_vgg: bool = True
    num_d: int = 2
    n_layers_d: int = 4
    niter: int = 100        # epochs at constant lr (ref train_options.py)
    niter_decay: int = 100  # epochs of linear decay to zero
    lambda_kld: float = 0.05


def _generator_variables(cfg: SpadeConfig, g: torch.Generator) -> dict:
    gen, enc = build_modules(cfg, "meta")
    gv = convert.init_numpy(gen, g)
    if enc is None:
        return gv
    ev = convert.init_numpy(enc, g)
    return {c: {"gen": gv[c], "enc": ev[c]} for c in ("params", "batch_stats")}


def init_variables(cfg: SpadeConfig, seed: int = 0) -> dict:
    """Generator variables in flax's layout, drawn from flax's initialisers
    by a ``torch.Generator`` seeded with ``seed`` (the distributions of the
    JAX package's init, not its bits); with a VAE the generator's and the
    encoder's variables are bundled under ``gen`` and ``enc`` as
    ``SpadeTrainer.init_state`` bundles them (pix2pix.py:155-161)."""
    return _generator_variables(cfg, torch.Generator().manual_seed(seed))


def discriminator(cfg: SpadeConfig, device=None) -> MultiscaleDiscriminator:
    return MultiscaleDiscriminator(cfg.num_d, cfg.ndf, cfg.n_layers_d, 2 * LABEL_NC, device)


def adam_numpy(params: dict, lr: float) -> dict:
    """A fresh ``optax.inject_hyperparams(optax.adam)`` state for the flax
    ``params`` tree, as flax serializes it."""
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    zeros = lambda t: {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v)  # noqa: E731
                       for k, v in t.items()}
    count = np.zeros((), np.int32)
    return {"count": count,
            "hyperparams": dict(zip(ADAM_HYPERPARAMS,
                                    map(f32, (lr, BETA1, BETA2, ADAM_EPS, 0.0)))),
            "hyperparams_states": {},
            "inner_state": {"0": {"count": count, "mu": zeros(params), "nu": zeros(params)},
                            "1": {}}}


def init_state_numpy(cfg: SpadeConfig, seed: int = 0) -> dict:
    """A whole training state in the tree that
    ``flax.serialization.to_state_dict(dataclasses.asdict(state))`` gives
    for the JAX package's TrainState, freshly initialised: the generator as
    :func:`init_variables` draws it at ``seed`` (the CLI's is 0), then the
    discriminator and (with VGG on and no pretrained file, see
    ``losses.load_vgg19_weights``) VGG19 from the same ``torch.Generator``."""
    g = torch.Generator().manual_seed(seed)
    gv = _generator_variables(cfg, g)
    dv = convert.init_numpy(discriminator(cfg, "meta"), g)
    vgg = None
    if cfg.use_vgg:
        vgg = load_vgg19_weights()
        if vgg is None:
            vgg = {"params": convert.init_numpy(VGG19Features("meta"), g)["params"]}
    return {"g_params": gv["params"], "g_batch_stats": gv["batch_stats"],
            "d_params": dv["params"], "d_batch_stats": dv["batch_stats"],
            "g_opt": adam_numpy(gv["params"], LR / 2.0),
            "d_opt": adam_numpy(dv["params"], LR * 2.0),
            "vgg_params": vgg, "step": np.zeros((), np.int32)}


@dataclasses.dataclass
class AdamState:
    """``optax.inject_hyperparams(optax.adam)``'s state for ``params``: the
    step ``count`` (optax keeps two, always equal), the hyperparameters as
    0-d float32 tensors, and each parameter's moments ``mu`` and ``nu``."""

    params: list[nn.Parameter]
    count: int
    hyper: dict[str, torch.Tensor]
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]

    @classmethod
    def from_numpy(cls, module: nn.Module, opt: dict, device) -> "AdamState":
        names = [n for n, _ in module.named_parameters()]
        inner = opt["inner_state"]["0"]
        moments = [convert.torch_tensors(module, {"params": inner[m]}, collections=("params",))
                   for m in ("mu", "nu")]
        hyper = {k: torch.tensor(np.asarray(opt["hyperparams"][k], np.float32), device=device)
                 for k in ADAM_HYPERPARAMS}
        return cls(list(module.parameters()), int(inner["count"]), hyper,
                   *([m[n].to(device) for n in names] for m in moments))

    def to_numpy(self, module: nn.Module) -> dict:
        names = [n for n, _ in module.named_parameters()]
        count = np.asarray(self.count, np.int32)
        mu, nu = (convert.to_numpy(module, dict(zip(names, m)), ("params",))["params"]
                  for m in (self.mu, self.nu))
        return {"count": count,
                "hyperparams": {k: v.cpu().numpy() for k, v in self.hyper.items()},
                "hyperparams_states": {},
                "inner_state": {"0": {"count": count, "mu": mu, "nu": nu}, "1": {}}}

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor]) -> None:
        """One step: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, the
        parameter moved by -lr * mu_hat / (sqrt(nu_hat + eps_root) + eps)
        with mu_hat and nu_hat bias-corrected by 1 - b^count."""
        h = self.hyper
        self.count += 1
        torch._foreach_mul_(self.mu, h["b1"])
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - h["b1"]))
        torch._foreach_mul_(self.nu, h["b2"])
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                        1 - h["b2"]))
        denom = torch._foreach_div(self.nu, 1 - h["b2"] ** self.count)
        torch._foreach_add_(denom, h["eps_root"])
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, h["eps"])
        step = torch._foreach_div(self.mu, 1 - h["b1"] ** self.count)
        torch._foreach_div_(step, denom)
        torch._foreach_mul_(step, -h["learning_rate"])
        torch._foreach_add_(self.params, step)


@dataclasses.dataclass
class TrainState:
    """The JAX package's TrainState in torch form: the generator ``g`` (the
    SPADE generator, or with a VAE an ``nn.ModuleDict`` of it as ``gen``
    and the encoder as ``enc``, so its flax paths are those of the bundled
    ``g_params``), the discriminator ``d`` and VGG19 ``vgg`` (None with VGG
    off), all trainable forms (``convert.load_numpy(trainable=True)``), the
    two optimizers' states and the G ``step`` count."""

    g: nn.Module
    d: MultiscaleDiscriminator
    vgg: VGG19Features | None
    g_opt: AdamState
    d_opt: AdamState
    step: int

    def to(self, dtype: torch.dtype) -> "TrainState":
        """The state with its weights, statistics and optimizer state in
        ``dtype`` (in place): float64 makes two devices' or two packages'
        steps comparable where float32 rounding decides a ReLU or a max
        pool's choice differently."""
        for m in (self.g, self.d, self.vgg):
            if m is not None:
                m.to(dtype)
        for opt in (self.g_opt, self.d_opt):
            opt.mu, opt.nu = ([t.to(dtype) for t in m] for m in (opt.mu, opt.nu))
            opt.hyper = {k: v.to(dtype) for k, v in opt.hyper.items()}
        return self

    @property
    def gen(self) -> nn.Module:
        return self.g["gen"] if isinstance(self.g, nn.ModuleDict) else self.g

    @property
    def enc(self) -> nn.Module | None:
        return self.g["enc"] if isinstance(self.g, nn.ModuleDict) else None


def _nchw(x: torch.Tensor, device) -> torch.Tensor:
    # a pinned batch goes to the card without blocking the host
    return x.to(device, non_blocking=True).permute(0, 3, 1, 2).contiguous()


class SpadeTrainer(nn.Module):
    """The GAN on ``device``: the CUDA card unless the caller asks for the
    CPU.  Given flax ``variables`` (see ``convert.spade_from_numpy``), it
    holds the generator (and encoder) for inference; the training methods
    work on a :class:`TrainState` from :meth:`init_state` or
    :meth:`state_from_numpy`.  The VAE's noise is drawn from two
    ``torch.Generator``s on the device seeded with constants (the JAX
    package folds the step into a PRNG key: the same distribution, not its
    bits).  With a ``comm`` of more than one rank the steps are data
    parallel (see the module docstring): every rank calls them together, on
    its rows of the batch."""

    def __init__(self, cfg: SpadeConfig, variables: dict | None = None, device=None,
                 comm: Comm | None = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.comm = comm
        self.world = 1 if comm is None else comm.size
        full_precision_matmul()
        self.gen = self.enc = None
        if variables is not None:
            self.gen, self.enc = convert.spade_from_numpy(variables, cfg, self.device)
        self.old_lr = LR
        self.g_rng = torch.Generator(self.device).manual_seed(G_NOISE_SEED)
        self.d_rng = torch.Generator(self.device).manual_seed(D_NOISE_SEED)

    # -- inference ------------------------------------------------------------

    @torch.inference_mode()
    def infer_logits(self, label: torch.Tensor, real: torch.Tensor | None = None,
                     state: TrainState | None = None) -> torch.Tensor:
        """The generated image before its tanh, NHWC, for an NHWC ``label``
        in [-1, 1]; with a VAE and a style image ``real``, z is the
        encoder's mu, else 0.  The generator is the trainer's, or that of a
        training ``state`` (in eval mode)."""
        gen, enc = (self.gen, self.enc) if state is None else (state.gen, state.enc)
        if state is not None:
            state.g.eval()
        seg = _nchw(label, self.device)
        z = None
        if enc is not None and real is not None:
            z, _ = enc(_nchw(real, self.device))
        return gen.logits(seg, z).permute(0, 2, 3, 1)

    def infer(self, label: torch.Tensor, real: torch.Tensor | None = None,
              state: TrainState | None = None) -> torch.Tensor:
        """The generated image in [-1, 1], NHWC (pix2pix.py:347-357)."""
        return torch.tanh(self.infer_logits(label, real, state))

    # -- state ----------------------------------------------------------------

    def state_from_numpy(self, tree: dict) -> TrainState:
        """A TrainState on the trainer's device from the flax-layout tree of
        :func:`init_state_numpy` (a JAX TrainState's state dict, or a
        checkpoint read by ``checkpoint.load_train_state``)."""
        cfg, dev = self.cfg, self.device
        gen, enc = build_modules(cfg, "meta", self.comm)
        g = gen if enc is None else nn.ModuleDict({"gen": gen, "enc": enc})
        g = convert.load_numpy(g, {"params": tree["g_params"],
                                   "batch_stats": tree["g_batch_stats"]}, dev, trainable=True)
        d = convert.load_numpy(discriminator(cfg, "meta"),
                               {"params": tree["d_params"], "batch_stats": tree["d_batch_stats"]},
                               dev, trainable=True)
        vgg = None
        if cfg.use_vgg:
            vgg = convert.load_numpy(VGG19Features("meta"), tree["vgg_params"], dev)
        return TrainState(g, d, vgg, AdamState.from_numpy(g, tree["g_opt"], dev),
                          AdamState.from_numpy(d, tree["d_opt"], dev), int(tree["step"]))

    def state_to_numpy(self, state: TrainState) -> dict:
        """The flax-layout tree of ``state`` (see :func:`init_state_numpy`)."""
        gv, dv = convert.to_numpy(state.g), convert.to_numpy(state.d)
        return {"g_params": gv["params"], "g_batch_stats": gv["batch_stats"],
                "d_params": dv["params"], "d_batch_stats": dv["batch_stats"],
                "g_opt": state.g_opt.to_numpy(state.g), "d_opt": state.d_opt.to_numpy(state.d),
                "vgg_params": (None if state.vgg is None else
                               {"params": convert.to_numpy(state.vgg, collections=("params",))
                                ["params"]}),
                "step": np.asarray(state.step, np.int32)}

    def init_state(self, seed: int = 0) -> TrainState:
        """A fresh TrainState from :func:`init_state_numpy` at ``seed``."""
        return self.state_from_numpy(init_state_numpy(self.cfg, seed))

    def update_learning_rate(self, state: TrainState, epoch: int) -> TrainState:
        """Linear LR decay to zero over the last ``niter_decay`` epochs
        (pix2pix_trainer.py:66-86): constant for the first ``niter`` epochs,
        then old_lr - lr/niter_decay each epoch; the TTUR split (G lr/2,
        D lr*2) is reapplied to the decayed base rate."""
        cfg = self.cfg
        new_lr = max(0.0, self.old_lr - LR / cfg.niter_decay) if epoch > cfg.niter \
            else self.old_lr
        if new_lr != self.old_lr:
            for opt, lr in ((state.g_opt, new_lr / 2.0), (state.d_opt, new_lr * 2.0)):
                opt.hyper["learning_rate"] = torch.tensor(lr, dtype=torch.float32,
                                                          device=self.device)
            self.old_lr = new_lr
        return state

    def current_lrs(self, state: TrainState) -> tuple[float, float]:
        """(G lr, D lr) as floats."""
        return (float(state.g_opt.hyper["learning_rate"]),
                float(state.d_opt.hyper["learning_rate"]))

    # -- forward helpers ------------------------------------------------------

    def _generate(self, state: TrainState, seg: torch.Tensor, real: torch.Tensor,
                  rng: torch.Generator, noise: torch.Tensor | None):
        """(fake in [-1, 1], (mu, logvar) or None).  With a VAE
        (pix2pix_model.py:135-150) z = mu + exp(logvar / 2) * noise, the
        noise of the global batch ((B * ranks, z_dim)) drawn from ``rng``
        unless given, and this rank's rows of it taken."""
        kld_aux, z = None, None
        if state.enc is not None:
            mu, logvar = state.enc(real)
            if noise is None:
                noise = torch.randn((mu.shape[0] * self.world, mu.shape[1]), generator=rng,
                                    device=self.device, dtype=mu.dtype)
            noise, = shard_batch(self.comm, noise)
            z = mu + torch.exp(0.5 * logvar) * noise.to(self.device, mu.dtype)
            kld_aux = (mu, logvar)
        return torch.tanh(state.gen.logits(seg, z)), kld_aux

    @staticmethod
    def _discriminate(d: nn.Module, seg, fake, real):
        """(fake_feats, real_feats): one batch of fake then real, each
        concatenated with the label (pix2pix_model.py:208-223)."""
        both = torch.cat([torch.cat([seg, fake], 1), torch.cat([seg, real], 1)], 0)
        n = seg.shape[0]
        feats = d(both)
        return [[f[:n] for f in s] for s in feats], [[f[n:] for f in s] for s in feats]

    @torch.no_grad()
    def _sum_over_ranks(self, grads: list[torch.Tensor], logs: dict) -> tuple[list, dict]:
        """The gradients and the logs summed over the ranks in ONE all-reduce
        (collective): the gradients flattened into one buffer, the logs at
        its end.  As given at one rank."""
        if self.world == 1:
            return grads, logs
        ref = grads[0]
        tail = [torch.as_tensor(v, dtype=ref.dtype, device=ref.device).detach().reshape(1)
                for v in logs.values()]
        buf = torch.cat([g.reshape(-1) for g in grads] + tail)
        tracing.count("spade.allreduce_bytes", buf.numel() * buf.element_size())
        with tracing.span("spade.allreduce"), (tracing.span(tracing.WAIT) if
                                               self.comm.blocks_host else nullcontext()):
            self.comm.all_reduce(buf, "sum")
        parts = buf.split([g.numel() for g in grads] + [1] * len(tail))
        return ([p.view_as(g) for p, g in zip(parts, grads)],
                {k: p[0] for k, p in zip(logs, parts[len(grads):])})

    # -- steps ----------------------------------------------------------------

    def g_step(self, state: TrainState, label: torch.Tensor, real: torch.Tensor,
               noise: torch.Tensor | None = None) -> tuple[TrainState, dict]:
        """One generator step on NHWC ``label`` and ``real`` batches in
        [-1, 1] (the rank's rows; ``noise`` is the global batch's): G (and
        the encoder) in training mode, D in eval mode; the losses, global,
        as 0-d tensors in ``logs``."""
        cfg = self.cfg
        seg, img = _nchw(label, self.device), _nchw(real, self.device)
        state.g.train()
        state.d.eval()
        calls = 0 if self.comm is None else self.comm.calls
        with torch.enable_grad():
            fake, kld_aux = self._generate(state, seg, img, self.g_rng, noise)
            fake_feats, real_feats = self._discriminate(state.d, seg, fake, img)
            l_gan = multiscale_hinge_g(fake_feats)
            l_fm = feature_matching_loss(real_feats, fake_feats, LAMBDA_FEAT)
            l_vgg = vgg_loss(state.vgg, fake, img, LAMBDA_VGG) if cfg.use_vgg else 0.0
            l_kld = kld_loss(*kld_aux) * cfg.lambda_kld if kld_aux is not None else 0.0
            # this rank's part of the global batch's means; the KLD sums over the batch
            total = (l_gan + l_fm + l_vgg) / self.world + l_kld
            grads = torch.autograd.grad(total, state.g_opt.params)  # none for D
        if self.world > 1:  # the batch norms' all-reduces, forward and backward
            tracing.count("spade.bn_allreduces", self.comm.calls - calls)
        logs = {"g_gan": l_gan / self.world, "g_fm": l_fm / self.world,
                "g_vgg": l_vgg / self.world}
        if kld_aux is not None:
            logs["g_kld"] = l_kld
        logs["g_total"] = total
        grads, logs = self._sum_over_ranks(grads, logs)
        state.g_opt.update(grads)
        state.step += 1
        return state, {k: v.detach() if torch.is_tensor(v) else v for k, v in logs.items()}

    def d_step(self, state: TrainState, label: torch.Tensor, real: torch.Tensor,
               noise: torch.Tensor | None = None) -> tuple[TrainState, dict]:
        """One discriminator step: G in eval mode (BN at its running
        statistics) makes the fake, D in training mode; as :meth:`g_step`
        across ranks."""
        seg, img = _nchw(label, self.device), _nchw(real, self.device)
        state.g.eval()
        with torch.no_grad():
            fake, _ = self._generate(state, seg, img, self.d_rng, noise)
        state.d.train()
        with torch.enable_grad():
            fake_feats, real_feats = self._discriminate(state.d, seg, fake, img)
            loss = multiscale_hinge_d(real_feats, fake_feats) / self.world
            grads = torch.autograd.grad(loss, state.d_opt.params)
        grads, logs = self._sum_over_ranks(grads, {"d_total": loss.detach()})
        state.d_opt.update(grads)
        return state, logs
