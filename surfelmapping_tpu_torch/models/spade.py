"""SPADE generator, multiscale discriminator and VAE encoder (counterpart
of surfelmapping_tpu/models/spade.py).

The reference's modified SPADE: the "label" is the rendered surfel RGB
image (``LABEL_NC`` = 3); a SPADE layer is a parameter-free batch norm with a
label-conditioned (gamma, beta) from a shared 128-channel conv; the
generator is an fc conv (or, with a VAE, a dense layer from z) at the
latent grid, then head + 2 middle + 4 up SPADE ResNet blocks with 2x
nearest upsampling and a tanh image head.

Each module comes in two forms, filled by ``convert.load_numpy``.  Loaded
for inference, a spectral-normed convolution (:class:`SNConv2d`) holds its
kernel already divided by the sigma of flax's power step
(:func:`spectral_normalize`, once at load), and a SPADE norm normalizes with
its running statistics.  Loaded trainable, the convolution holds the raw
kernel and runs the power step on every call, and in training mode
(``module.train()``, flax's ``train``/``update_stats``) the SPADE norms
normalize with the batch's statistics and both store their new state (the
running statistics; ``u`` and ``sigma``).  Submodules carry the flax module
names (``Conv_0``, ``conv_s``, ``fc_vae``...), so a flax variable path reads
as a module path.  Tensors are NCHW.  The modules are built on the ``meta``
device.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.2
BN_EPS = 1e-5
IN_EPS = 1e-5
SN_EPS = 1e-12  # flax SpectralNorm's epsilon
BN_MOMENTUM = 0.9  # the SPADE norms' running averages
NUM_UP_LAYERS = 5
ENCODER_SIZE = 256
LABEL_NC = 3   # the label is the rendered RGB image
NHIDDEN = 128  # width of a SPADE norm's shared conv


def power_step(w: torch.Tensor, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """flax.linen.SpectralNorm's one power-iteration step on a (fan_in, out)
    matrix from the stored ``u`` (1, out): (sigma, the new u).  u and v are
    held constant (flax's ``stop_gradient``), so a gradient reaches ``w``
    through sigma = v w u^T alone."""
    with torch.no_grad():
        v = _l2_normalize(u @ w.T)
        u1 = _l2_normalize(v @ w)
    return ((v @ w) @ u1.T)[0, 0], u1


def _divide_by_sigma(kernel: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    return kernel / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


def spectral_normalize(kernel: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """flax.linen.SpectralNorm's weight at inference: one power step from
    the stored ``u`` (flax runs it even when ``update_stats`` is False) on
    the kernel reshaped to (fan_in, out), then the kernel divided by that
    step's sigma.  ``kernel`` is in flax's layout (HWIO or (in, out)), ``u``
    is (1, out)."""
    return _divide_by_sigma(kernel, power_step(kernel.reshape(-1, kernel.shape[-1]), u)[0])


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + SN_EPS)


def nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """Source rows of ``jax.image.resize(..., "nearest")``: output i reads
    floor((i + 0.5) * n_in / n_out), taken in integers, so every device
    computes the same index (``F.interpolate``'s "nearest" reads
    floor(i * n_in / n_out))."""
    i = torch.arange(n_out, device=device)
    return torch.div((2 * i + 1) * n_in, 2 * n_out, rounding_mode="floor")


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest resize of an NCHW tensor to (h, w), as JAX samples it."""
    H, W = x.shape[-2:]
    if H != h:
        x = x.index_select(-2, nearest_index(H, h, x.device))
    if W != w:
        x = x.index_select(-1, nearest_index(W, w, x.device))
    return x


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` of an NCHW tensor, which
    antialiases when it downsamples."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=True)


def latent_hw(crop_size: int, aspect_ratio: float) -> tuple[int, int]:
    """The generator's input grid: crop / 32 wide, and that over the aspect
    ratio (Python's round, halves to even) high."""
    sw = crop_size // (2 ** NUM_UP_LAYERS)
    return max(int(round(sw / aspect_ratio)), 1), sw


def _conv3(cin: int, cout: int, device) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, device=device)


class SNConv2d(nn.Conv2d):
    """A convolution under flax's SpectralNorm, with its ``u`` and ``sigma``.

    ``normalized`` (the inference form): the weight is already divided by
    sigma and the forward is the plain convolution.  Otherwise the weight is
    the raw kernel: each forward runs :func:`power_step` on it (its fan_in
    taken in the weight's own (in, h, w) order, which changes only the
    summation order of flax's (h, w, in)) and divides by that sigma, and in
    training mode stores the new ``u`` and ``sigma``."""

    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, device=device, **kwargs)
        self.register_buffer("u", torch.empty(1, self.out_channels, device=device))
        self.register_buffer("sigma", torch.empty((), device=device))
        self.normalized = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.normalized:
            return self._conv_forward(x, self.weight, self.bias)
        sigma, u = power_step(self.weight.reshape(self.out_channels, -1).T, self.u)
        if self.training:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return self._conv_forward(x, _divide_by_sigma(self.weight, sigma), self.bias)


def instance_norm(h: torch.Tensor) -> torch.Tensor:
    """Per-sample, per-channel normalization over H and W: two-pass biased
    variance, eps 1e-5, rsqrt ('spectralinstance' norm layers)."""
    mean = h.mean(dim=(2, 3), keepdim=True)
    var = h.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (h - mean) * torch.rsqrt(var + IN_EPS)


class SPADENorm(nn.Module):
    """Parameter-free batch norm, modulated by (gamma, beta) from the
    nearest-resized label (normalization.py:66-110).  In eval mode it
    normalizes with its running statistics; in training mode with the
    batch's, taken as flax takes them (the biased "fast" variance
    max(0, E[x^2] - E[x]^2) over N, H and W), and it moves the running
    statistics by ``BN_MOMENTUM`` towards them."""

    def __init__(self, norm_nc: int, device=None):
        super().__init__()
        self.register_buffer("mean", torch.empty(norm_nc, device=device))
        self.register_buffer("var", torch.empty(norm_nc, device=device))
        self.Conv_0 = _conv3(LABEL_NC, NHIDDEN, device)
        self.Conv_1 = _conv3(NHIDDEN, norm_nc, device)
        self.Conv_2 = _conv3(NHIDDEN, norm_nc, device)

    def forward(self, x: torch.Tensor, segmap: torch.Tensor) -> torch.Tensor:
        mean, var = self.mean, self.var
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        scale = torch.rsqrt(var + BN_EPS)[:, None, None]
        normalized = (x - mean[:, None, None]) * scale
        seg = resize_nearest(segmap, x.shape[2], x.shape[3])
        actv = F.relu(self.Conv_0(seg))
        return normalized * (1.0 + self.Conv_1(actv)) + self.Conv_2(actv)


class SPADEResnetBlock(nn.Module):
    """architecture.py:21-70: spectral-normed convs after SPADE norms, and a
    learned 1x1 shortcut when the width changes."""

    # flax numbers the block's SpectralNorm wrappers in this order
    SN_CONVS = ("conv_0", "conv_1", "conv_s")

    def __init__(self, fin: int, fout: int, device=None):
        super().__init__()
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        self.norm_0 = SPADENorm(fin, device)
        self.conv_0 = SNConv2d(fin, fmiddle, 3, padding=1, device=device)
        self.norm_1 = SPADENorm(fmiddle, device)
        self.conv_1 = SNConv2d(fmiddle, fout, 3, padding=1, device=device)
        if self.learned_shortcut:
            self.norm_s = SPADENorm(fin, device)
            self.conv_s = SNConv2d(fin, fout, 1, bias=False, device=device)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        dx = self.conv_0(F.leaky_relu(self.norm_0(x, seg), LRELU_SLOPE))
        dx = self.conv_1(F.leaky_relu(self.norm_1(dx, seg), LRELU_SLOPE))
        xs = self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut else x
        return xs + dx


def _up(x: torch.Tensor) -> torch.Tensor:
    return resize_nearest(x, x.shape[2] * 2, x.shape[3] * 2)


class SPADEGenerator(nn.Module):
    """generator.py:25-120 ('normal': 5 up layers, 7 SPADE blocks).  The
    output is (sh * 32, sw * 32) of :func:`latent_hw`, whatever the label's
    size."""

    BLOCKS = ("head_0", "G_middle_0", "G_middle_1", "up_0", "up_1", "up_2", "up_3")

    def __init__(self, ngf: int = 64, crop_size: int = 256, aspect_ratio: float = 1.0,
                 use_vae: bool = False, z_dim: int = 256, device=None):
        super().__init__()
        nf = ngf
        self.latent_hw = latent_hw(crop_size, aspect_ratio)
        self.use_vae, self.z_dim, self.width = use_vae, z_dim, 16 * nf
        sh, sw = self.latent_hw
        if use_vae:
            self.fc_vae = nn.Linear(z_dim, 16 * nf * sh * sw, device=device)
        else:
            self.fc = _conv3(LABEL_NC, 16 * nf, device)
        widths = (16, 16, 16, 16, 8, 4, 2, 1)
        for name, fin, fout in zip(self.BLOCKS, widths[:-1], widths[1:]):
            setattr(self, name, SPADEResnetBlock(fin * nf, fout * nf, device))
        self.conv_img = _conv3(nf, 3, device)

    def logits(self, seg: torch.Tensor, z: torch.Tensor | None = None) -> torch.Tensor:
        """The image before the tanh."""
        sh, sw = self.latent_hw
        B = seg.shape[0]
        if self.use_vae:
            if z is None:
                z = torch.zeros(B, self.z_dim, dtype=seg.dtype, device=seg.device)
            # flax reshapes the dense output in NHWC order
            x = self.fc_vae(z).reshape(B, sh, sw, self.width).permute(0, 3, 1, 2)
        else:
            x = self.fc(resize_nearest(seg, sh, sw))
        x = self.head_0(x, seg)
        x = _up(x)
        x = self.G_middle_0(x, seg)
        x = self.G_middle_1(x, seg)
        for name in self.BLOCKS[3:]:
            x = getattr(self, name)(_up(x), seg)
        return self.conv_img(F.leaky_relu(x, LRELU_SLOPE))


class ConvEncoder(nn.Module):
    """encoder.py ConvEncoder -> (mu, logvar): the image resized to 256x256,
    six stride-2 spectral-normed convs with instance norm, two dense heads."""

    SN_CONVS = tuple(f"layer{i}" for i in range(6))

    def __init__(self, ndf: int = 64, z_dim: int = 256, device=None):
        super().__init__()
        nf = ndf
        widths = [3, nf, nf * 2, nf * 4, nf * 8, nf * 8, nf * 8]
        for i, name in enumerate(self.SN_CONVS):
            setattr(self, name, SNConv2d(widths[i], widths[i + 1], 3, stride=2, padding=1,
                                         device=device))
        flat = widths[-1] * (ENCODER_SIZE // 2 ** len(self.SN_CONVS)) ** 2
        self.fc_mu = nn.Linear(flat, z_dim, device=device)
        self.fc_var = nn.Linear(flat, z_dim, device=device)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if x.shape[2:] != (ENCODER_SIZE, ENCODER_SIZE):
            x = resize_bilinear(x, ENCODER_SIZE, ENCODER_SIZE)
        h = x
        for name in self.SN_CONVS:
            h = F.leaky_relu(instance_norm(getattr(self, name)(h)), LRELU_SLOPE)
        # flax flattens in NHWC order
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return self.fc_mu(h), self.fc_var(h)


class NLayerDiscriminator(nn.Module):
    """discriminator.py NLayerDiscriminator: a PatchGAN of 4x4 convs with
    symmetric padding 2; every layer but the first and the last is
    spectral-normed and instance-normed.  Returns every layer's output, the
    logits last."""

    def __init__(self, ndf: int = 64, n_layers: int = 4, input_nc: int = 2 * LABEL_NC,
                 device=None):
        super().__init__()
        self.SN_CONVS = tuple(f"conv{i}" for i in range(1, n_layers))
        self.conv0 = nn.Conv2d(input_nc, ndf, 4, stride=2, padding=2, device=device)
        nf = ndf
        for i, name in enumerate(self.SN_CONVS, start=1):
            nf_prev, nf = nf, min(nf * 2, 512)
            setattr(self, name, SNConv2d(nf_prev, nf, 4, stride=1 if i == n_layers - 1 else 2,
                                         padding=2, device=device))
        self.conv_out = nn.Conv2d(nf, 1, 4, padding=2, device=device)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        h = F.leaky_relu(self.conv0(x), LRELU_SLOPE)
        feats = [h]
        for name in self.SN_CONVS:
            h = F.leaky_relu(instance_norm(getattr(self, name)(h)), LRELU_SLOPE)
            feats.append(h)
        feats.append(self.conv_out(h))
        return feats


class MultiscaleDiscriminator(nn.Module):
    """discriminator.py MultiscaleDiscriminator: ``num_d`` PatchGANs
    (``D0``, ``D1``...), each on the input average-pooled once more (3x3,
    stride 2, padding 1, the pad counted in the divisor as flax counts it)."""

    def __init__(self, num_d: int = 2, ndf: int = 64, n_layers: int = 4,
                 input_nc: int = 2 * LABEL_NC, device=None):
        super().__init__()
        self.num_d = num_d
        for d in range(num_d):
            setattr(self, f"D{d}", NLayerDiscriminator(ndf, n_layers, input_nc, device))

    def forward(self, x: torch.Tensor) -> list[list[torch.Tensor]]:
        outs = []
        for d in range(self.num_d):
            outs.append(getattr(self, f"D{d}")(x))
            if d != self.num_d - 1:
                x = F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)
        return outs


def build_modules(cfg, device=None) -> tuple[SPADEGenerator, ConvEncoder | None]:
    """The generator, and the encoder when ``cfg.use_vae``, of a
    ``models.pix2pix.SpadeConfig`` (pix2pix.py:84-97)."""
    gen = SPADEGenerator(ngf=cfg.ngf, crop_size=cfg.crop_size, aspect_ratio=cfg.aspect_ratio,
                         use_vae=cfg.use_vae, z_dim=cfg.z_dim, device=device)
    enc = ConvEncoder(ndf=cfg.ndf, z_dim=cfg.z_dim, device=device) if cfg.use_vae else None
    return gen, enc
