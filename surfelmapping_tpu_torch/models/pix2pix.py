"""Pix2Pix(SPADE): the model bundle and its inference (counterpart of the
inference half of surfelmapping_tpu/models/pix2pix.py).

``SpadeTrainer.infer`` is the reference's inference mode
(pix2pix_model.py:93-100): the label-conditioned generator, or with a VAE
the generator from the encoder's deterministic ``mu`` of a style image, or
from z = 0 without one.  The weights come from flax variables: a JAX
package checkpoint (``models/checkpoint.py``) or :func:`init_variables`,
a seeded init that draws from flax's own initialisers.  The generator runs in float32 with
TF32 off for convolutions and matmuls.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from .. import convert
from ..ops.transforms import full_precision_matmul
from ..pipeline import resolve_device
from .spade import build_modules


@dataclasses.dataclass
class SpadeConfig:
    """The generator's and encoder's settings (pix2pix.py:43-66)."""

    ngf: int = 64
    ndf: int = 64
    crop_size: int = 256
    aspect_ratio: float = 1.0
    use_vae: bool = False
    z_dim: int = 256


def init_variables(cfg: SpadeConfig, seed: int = 0) -> dict:
    """Generator variables in flax's layout, drawn from flax's initialisers
    by a ``torch.Generator`` seeded with ``seed`` (the distributions of the
    JAX package's init, not its bits); with a VAE the generator's and the
    encoder's variables are bundled under ``gen`` and ``enc`` as
    ``SpadeTrainer.init_state`` bundles them (pix2pix.py:155-161)."""
    g = torch.Generator().manual_seed(seed)
    gen, enc = build_modules(cfg, "meta")
    gv = convert.init_numpy(gen, g)
    if enc is None:
        return gv
    ev = convert.init_numpy(enc, g)
    return {c: {"gen": gv[c], "enc": ev[c]} for c in ("params", "batch_stats")}


class SpadeTrainer(nn.Module):
    """The generator (and encoder) on ``device``: the CUDA card unless the
    caller asks for the CPU.  Weights from flax ``variables`` (see
    ``convert.spade_from_numpy``).  The training half of the JAX trainer is
    not ported yet."""

    def __init__(self, cfg: SpadeConfig, variables: dict, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        full_precision_matmul()
        self.gen, self.enc = convert.spade_from_numpy(variables, cfg, self.device)

    @torch.inference_mode()
    def infer_logits(self, label: torch.Tensor, real: torch.Tensor | None = None) -> torch.Tensor:
        """The generated image before its tanh, NHWC, for an NHWC ``label``
        in [-1, 1]; with a VAE and a style image ``real``, z is the
        encoder's mu, else 0."""
        seg = label.to(self.device).permute(0, 3, 1, 2).contiguous()
        z = None
        if self.enc is not None and real is not None:
            z, _ = self.enc(real.to(self.device).permute(0, 3, 1, 2).contiguous())
        return self.gen.logits(seg, z).permute(0, 2, 3, 1)

    def infer(self, label: torch.Tensor, real: torch.Tensor | None = None) -> torch.Tensor:
        """The generated image in [-1, 1], NHWC (pix2pix.py:347-357)."""
        return torch.tanh(self.infer_logits(label, real))
