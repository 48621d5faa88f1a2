"""GAN training losses (counterpart of surfelmapping_tpu/models/losses.py;
SPADE/models/networks/loss.py parity).

  * hinge GAN loss (the reference default, loss.py GANLoss 'hinge');
  * multiscale feature-matching L1 (pix2pix_model.py:151-160, lambda 10/num_D);
  * VGG19 perceptual loss with the reference's 1/32..1 layer weights
    (loss.py VGGLoss).  :class:`VGG19Features` is written out as plain
    convolutions (no torchvision).  :func:`load_vgg19_weights` reads
    pretrained weights from a local torchvision ``.pth`` or a flax-layout
    ``.npz`` (by path or SMTPU_VGG19); without one the trainer falls back to
    a fixed randomly initialised feature net, as the JAX package does;
  * KL divergence for the optional VAE mode (loss.py KLDLoss).

Tensors are NCHW; a discriminator's output is a list (one per scale) of its
layers' outputs, the logits last.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

Feats = Sequence[Sequence[torch.Tensor]]

VGG_BLOCKS = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))  # (channels, convs)
VGG_CONVS = sum(n for _, n in VGG_BLOCKS)
# torchvision vgg19.features' conv layer indices, in order
TORCHVISION_CONV_INDEX = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34)
VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def hinge_d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    return torch.mean(F.relu(1.0 - real_logits)) + torch.mean(F.relu(1.0 + fake_logits))


def hinge_g_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    return -torch.mean(fake_logits)


def multiscale_hinge_d(real_feats: Feats, fake_feats: Feats) -> torch.Tensor:
    """Mean hinge loss over every scale's logits (the reference divides by
    num_D, pix2pix_model.py GANLoss __call__)."""
    loss = 0.0
    for rf, ff in zip(real_feats, fake_feats):
        loss = loss + hinge_d_loss(rf[-1], ff[-1])
    return loss / len(real_feats)


def multiscale_hinge_g(fake_feats: Feats) -> torch.Tensor:
    loss = 0.0
    for ff in fake_feats:
        loss = loss + hinge_g_loss(ff[-1])
    return loss / len(fake_feats)


def feature_matching_loss(real_feats: Feats, fake_feats: Feats,
                          lambda_feat: float = 10.0) -> torch.Tensor:
    """L1 between the discriminator's intermediate features of fake and
    (detached) real (pix2pix_model.py:151-160)."""
    loss = 0.0
    for rf, ff in zip(real_feats, fake_feats):
        for r, f in zip(rf[:-1], ff[:-1]):
            loss = loss + torch.mean(torch.abs(f - r.detach()))
    return loss * lambda_feat / len(real_feats)


class VGG19Features(nn.Module):
    """VGG19's conv slices (SPADE/models/networks/architecture.py:94-124):
    ``conv0``..``conv15``, 3x3 with padding 1, each followed by a ReLU, 2x2
    max pools between the blocks.  Returns relu1_1, relu2_1, relu3_1,
    relu4_1 and relu5_1."""

    def __init__(self, device=None):
        super().__init__()
        cin, i = 3, 0
        for ch, n in VGG_BLOCKS:
            for _ in range(n):
                setattr(self, f"conv{i}", nn.Conv2d(cin, ch, 3, padding=1, device=device))
                cin, i = ch, i + 1

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        outs, h, i = [], x, 0
        for b, (_, n) in enumerate(VGG_BLOCKS):
            for c in range(n):
                h = F.relu(getattr(self, f"conv{i}")(h))
                i += 1
                if c == 0:
                    outs.append(h)
            if b < len(VGG_BLOCKS) - 1:
                h = F.max_pool2d(h, 2, 2)
        return outs


def load_vgg19_weights(path: str | None = None) -> dict | None:
    """Flax variables ``{"params": {"conv<i>": {"kernel", "bias"}}}`` (numpy,
    HWIO kernels) for :class:`VGG19Features` from a local pretrained
    checkpoint: a torchvision-layout ``.pth`` state_dict
    (``features.<idx>.weight`` OIHW) or an ``.npz`` with ``conv<i>_kernel``
    / ``conv<i>_bias`` in flax's layout.  ``path=None`` reads SMTPU_VGG19.
    None when there is no such file (the caller falls back to a random
    init)."""
    path = path or os.environ.get("SMTPU_VGG19")
    if not path or not os.path.exists(path):
        return None
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {"params": {f"conv{i}": {"kernel": np.array(data[f"conv{i}_kernel"]),
                                            "bias": np.array(data[f"conv{i}_bias"])}
                               for i in range(VGG_CONVS)}}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {"params": {f"conv{i}": {
        "kernel": sd[f"features.{li}.weight"].numpy().transpose(2, 3, 1, 0),
        "bias": sd[f"features.{li}.bias"].numpy()} for i, li in enumerate(TORCHVISION_CONV_INDEX)}}


def vgg_loss(vgg: VGG19Features, fake: torch.Tensor, real: torch.Tensor,
             lambda_vgg: float = 10.0) -> torch.Tensor:
    """Perceptual L1 over the VGG slices; images in [-1, 1] (tanh range),
    ImageNet-normalized; the real image's features take no gradient."""
    mean = torch.tensor(IMAGENET_MEAN, device=fake.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=fake.device)[:, None, None]

    def prep(img):
        return ((img + 1.0) / 2.0 - mean) / std

    f_feats = vgg(prep(fake))
    with torch.no_grad():
        r_feats = vgg(prep(real))
    loss = 0.0
    for w, f, r in zip(VGG_WEIGHTS, f_feats, r_feats):
        loss = loss + w * torch.mean(torch.abs(f - r))
    return loss * lambda_vgg


def kld_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    return -0.5 * torch.sum(1 + logvar - mu**2 - torch.exp(logvar))
