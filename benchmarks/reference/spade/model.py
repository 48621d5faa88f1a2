"""SPADE's networks and losses on lists of batch parts (see the package's
docstring).  ``p`` is a flat dictionary of weights and buffers; a name is
the program's module path (``head_0.norm_0.Conv_0.weight``).  Tensors are
NCHW."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LRELU = 0.2
BN_EPS = IN_EPS = 1e-5
SN_EPS = 1e-12
BN_MOMENTUM = 0.9
NHIDDEN = 128        # a SPADE norm's shared convolution
ENCODER_SIZE = 256   # the encoder's input, resized
BLOCKS = ("head_0", "G_middle_0", "G_middle_1", "up_0", "up_1", "up_2", "up_3")
WIDTHS = (16, 16, 16, 16, 8, 4, 2, 1)  # the blocks' widths in ngf
VGG_BLOCKS = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))
VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass
class Config:
    """The GAN's settings (SPADE's options, LADS's values by default)."""

    ngf: int = 64
    ndf: int = 64
    crop_size: int = 256
    z_dim: int = 256
    use_vae: bool = True
    use_vgg: bool = True
    num_d: int = 2
    n_layers_d: int = 4
    lambda_feat: float = 10.0
    lambda_vgg: float = 10.0
    lambda_kld: float = 0.05
    g_lr: float = 1e-4   # TTUR: lr / 2
    d_lr: float = 4e-4   # TTUR: lr * 2
    beta1: float = 0.0
    beta2: float = 0.9
    eps: float = 1e-8


def full_float32() -> None:
    """Matrix products and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def each(fn, *lists):
    return [fn(*args) for args in zip(*lists)]


def lrelu(xs):
    return [F.leaky_relu(x, LRELU) for x in xs]


def conv(xs, p, name, stride=1, padding=1, weight=None):
    w = p[name + ".weight"] if weight is None else weight
    b = p.get(name + ".bias")
    return [F.conv2d(x, w, b, stride, padding) for x in xs]


# -- spectral norm -----------------------------------------------------------------

def _l2n(x):
    return x * torch.rsqrt((x * x).sum() + SN_EPS)


def spectral(p, name, new: dict | None):
    """The kernel of ``name`` divided by the sigma of one power step from
    its stored ``u``; with ``new`` (training mode) the step's ``u`` and
    sigma go there."""
    w, u = p[name + ".weight"], p[name + ".u"]
    m = w.reshape(w.shape[0], -1).T  # (fan_in, out)
    with torch.no_grad():
        v = _l2n(u @ m.T)
        u1 = _l2n(v @ m)
    sigma = ((v @ m) @ u1.T)[0, 0]
    if new is not None:
        new[name + ".u"] = u1.detach()
        new[name + ".sigma"] = sigma.detach()
    return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


# -- normalisations and resizes ------------------------------------------------------

def instance_norm(h):
    mean = h.mean(dim=(2, 3), keepdim=True)
    var = h.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (h - mean) * torch.rsqrt(var + IN_EPS)


def nearest(x, h, w):
    """JAX's nearest resize: output i reads floor((i + 0.5) * in / out)."""
    H, W = x.shape[-2:]
    rows = torch.div((2 * torch.arange(h, device=x.device) + 1) * H, 2 * h, rounding_mode="floor")
    cols = torch.div((2 * torch.arange(w, device=x.device) + 1) * W, 2 * w, rounding_mode="floor")
    return x[..., rows, :][..., cols]


def batch_moments(xs):
    """Mean and fast variance per channel over every part's N, H and W: the
    sums of x and x^2 over the parts, over the global count."""
    n = sum(x.numel() // x.shape[1] for x in xs)
    s1 = sum(x.sum(dim=(0, 2, 3)) for x in xs)
    s2 = sum((x * x).sum(dim=(0, 2, 3)) for x in xs)
    mean = s1 / n
    return mean, torch.clamp_min(s2 / n - mean * mean, 0.0)


def spade_norm(xs, segs, p, name, train: bool, new: dict | None):
    """Batch norm without parameters, then the scale and shift that 3x3
    convolutions predict from the label at x's size (SPADE, eq. 1)."""
    if train:
        mean, var = batch_moments(xs)
        if new is not None:
            new[name + ".mean"] = BN_MOMENTUM * p[name + ".mean"] + (1 - BN_MOMENTUM) * mean.detach()
            new[name + ".var"] = BN_MOMENTUM * p[name + ".var"] + (1 - BN_MOMENTUM) * var.detach()
    else:
        mean, var = p[name + ".mean"], p[name + ".var"]
    scale = torch.rsqrt(var + BN_EPS)[:, None, None]
    out = []
    for x, seg in zip(xs, segs):
        s = nearest(seg, x.shape[2], x.shape[3])
        actv = F.relu(F.conv2d(s, p[name + ".Conv_0.weight"], p[name + ".Conv_0.bias"], 1, 1))
        gamma = F.conv2d(actv, p[name + ".Conv_1.weight"], p[name + ".Conv_1.bias"], 1, 1)
        beta = F.conv2d(actv, p[name + ".Conv_2.weight"], p[name + ".Conv_2.bias"], 1, 1)
        out.append((x - mean[:, None, None]) * scale * (1.0 + gamma) + beta)
    return out


# -- the generator ------------------------------------------------------------------

def resnet_block(xs, segs, p, name, kernels: dict, train: bool, new: dict | None):
    """SPADE's residual block: two spectral-normed 3x3 convolutions after
    SPADE norms, a learned 1x1 shortcut where the width changes."""
    dx = conv(lrelu(spade_norm(xs, segs, p, name + ".norm_0", train, new)), p,
              name + ".conv_0", weight=kernels["conv_0"])
    dx = conv(lrelu(spade_norm(dx, segs, p, name + ".norm_1", train, new)), p,
              name + ".conv_1", weight=kernels["conv_1"])
    if "conv_s" in kernels:
        short = conv(spade_norm(xs, segs, p, name + ".norm_s", train, new), p, name + ".conv_s",
                     padding=0, weight=kernels["conv_s"])
    else:
        short = xs
    return [a + b for a, b in zip(short, dx)]


def up(xs):
    return [nearest(x, 2 * x.shape[2], 2 * x.shape[3]) for x in xs]


def generator(p, segs, zs, cfg: Config, train: bool, new: dict | None, recompute: bool):
    """The generator's image before its tanh, per part.  With ``recompute``
    each block's activations are recomputed in the backward; the block is
    then a pure function of its inputs (its kernels' power steps and its
    statistics' updates come out of it)."""
    sw = cfg.crop_size // 32
    width = 16 * cfg.ngf
    if cfg.use_vae:
        x = [F.linear(z, p["fc_vae.weight"], p["fc_vae.bias"]).reshape(z.shape[0], sw, sw, width)
             .permute(0, 3, 1, 2) for z in zs]
    else:
        x = conv([nearest(s, sw, sw) for s in segs], p, "fc")
    for i, name in enumerate(BLOCKS):
        if i == 1 or i >= 3:
            x = up(x)
        convs = ("conv_0", "conv_1") + (("conv_s",) if WIDTHS[i] != WIDTHS[i + 1] else ())
        kernels = {c: spectral(p, f"{name}.{c}", new if train else None) for c in convs}
        if recompute:
            n = len(x)

            def block(*t, name=name, kernels=kernels):
                stats: dict = {}
                out = resnet_block(list(t[:n]), list(t[n:]), p, name, kernels, train, stats)
                return (*out, *stats.values())

            outs = checkpoint(block, *x, *segs, use_reentrant=False)
            x = list(outs[:n])
            if train and new is not None:
                keys = [f"{name}.{m}.{s}" for m in ("norm_0", "norm_1", "norm_s")
                        if f"{name}.{m}.mean" in p for s in ("mean", "var")]
                new.update(zip(keys, outs[n:]))
        else:
            x = resnet_block(x, segs, p, name, kernels, train, new)
    return conv(lrelu(x), p, "conv_img")


def encoder(p, imgs, cfg: Config, train: bool, new: dict | None):
    """(mu, logvar) per part: the image at 256x256, six stride-2
    spectral-normed convolutions with instance norm, two dense heads."""
    hs = [F.interpolate(x, size=(ENCODER_SIZE,) * 2, mode="bilinear", align_corners=False,
                        antialias=True) if x.shape[2:] != (ENCODER_SIZE,) * 2 else x
          for x in imgs]
    for i in range(6):
        k = spectral(p, f"layer{i}", new if train else None)
        hs = lrelu([instance_norm(h) for h in conv(hs, p, f"layer{i}", stride=2, weight=k)])
    flat = [h.permute(0, 2, 3, 1).reshape(h.shape[0], -1) for h in hs]
    return ([F.linear(f, p["fc_mu.weight"], p["fc_mu.bias"]) for f in flat],
            [F.linear(f, p["fc_var.weight"], p["fc_var.bias"]) for f in flat])


# -- the discriminator ------------------------------------------------------------------

def patch_d(p, pre, xs, cfg: Config, train: bool, new: dict | None):
    """A PatchGAN's every layer's output, per part, the logits last."""
    h = lrelu(conv(xs, p, pre + "conv0", stride=2, padding=2))
    feats = [h]
    for i in range(1, cfg.n_layers_d):
        k = spectral(p, f"{pre}conv{i}", new if train else None)
        stride = 1 if i == cfg.n_layers_d - 1 else 2
        h = lrelu([instance_norm(y) for y in conv(h, p, f"{pre}conv{i}", stride, 2, weight=k)])
        feats.append(h)
    feats.append(conv(h, p, pre + "conv_out", padding=2))
    return feats


def discriminator(p, xs, cfg: Config, train: bool, new: dict | None):
    """``num_d`` PatchGANs, each on the input average-pooled once more:
    [scale][layer] -> list over parts."""
    out = []
    for d in range(cfg.num_d):
        out.append(patch_d(p, f"D{d}.", xs, cfg, train, new))
        if d != cfg.num_d - 1:
            xs = [F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True) for x in xs]
    return out


def vgg19(p, xs):
    """relu1_1 .. relu5_1 of VGG19's convolutions, per part."""
    outs, h, i = [], xs, 0
    for b, (_, n) in enumerate(VGG_BLOCKS):
        for c in range(n):
            h = [F.relu(y) for y in conv(h, p, f"conv{i}")]
            i += 1
            if c == 0:
                outs.append(h)
        if b < len(VGG_BLOCKS) - 1:
            h = [F.max_pool2d(y, 2, 2) for y in h]
    return outs


# -- losses: means over the global batch ---------------------------------------------------

def global_mean(parts):
    return sum(t.sum() for t in parts) / sum(t.numel() for t in parts)


def hinge_d(real, fake):
    """Mean over the scales of mean(relu(1 - real)) + mean(relu(1 + fake))."""
    loss = sum(global_mean([F.relu(1.0 - r) for r in rs[-1]])
               + global_mean([F.relu(1.0 + f) for f in fs[-1]]) for rs, fs in zip(real, fake))
    return loss / len(real)


def hinge_g(fake):
    return sum(-global_mean(fs[-1]) for fs in fake) / len(fake)


def feature_matching(real, fake, lam):
    loss = 0.0
    for rs, fs in zip(real, fake):
        for r, f in zip(rs[:-1], fs[:-1]):
            loss = loss + global_mean([torch.abs(a - b.detach()) for a, b in zip(f, r)])
    return loss * lam / len(real)


def vgg_loss(p, fakes, reals, lam):
    mean = torch.tensor(IMAGENET_MEAN, device=fakes[0].device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=fakes[0].device)[:, None, None]
    prep = lambda xs: [((x + 1.0) / 2.0 - mean) / std for x in xs]  # noqa: E731
    f_feats = vgg19(p, prep(fakes))
    with torch.no_grad():
        r_feats = vgg19(p, prep(reals))
    loss = sum(w * global_mean([torch.abs(a - b) for a, b in zip(f, r)])
               for w, f, r in zip(VGG_WEIGHTS, f_feats, r_feats))
    return loss * lam


def kld(mus, logvars):
    return sum(-0.5 * torch.sum(1 + lv - mu ** 2 - torch.exp(lv)) for mu, lv in zip(mus, logvars))
