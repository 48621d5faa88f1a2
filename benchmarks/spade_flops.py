"""The model FLOPs of a SPADE training iteration, from the layer shapes of
the plain reference (``benchmarks/reference/spade``), and the card's
float32 peak.  Kept beside ``roofline.py``, so a change to the program does
not change the work it is credited with.

FLOPs count 2 per multiply-add of the convolutions and dense layers and
nothing else.  A net trained in a step counts its forward three times
(the backward as twice the forward); a net that is only run counts once.
A D step runs the generator (and encoder) without gradients and trains
the discriminator on the fake and the real batch; a G step trains the
generator and the encoder and runs the discriminator and VGG19 on both.
"""

from __future__ import annotations

F32_FLOPS_PER_S = 66.9e12  # NVIDIA H100 SXM5, float32 outside the tensor cores
WIDTHS = (16, 16, 16, 16, 8, 4, 2, 1)  # the generator's blocks, in ngf
VGG_BLOCKS = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))
NHIDDEN, LABEL_NC = 128, 3


def conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def spade_norm_macs(c: int, r: int) -> int:
    """A SPADE norm of ``c`` channels at r x r: the label's 3x3 conv to 128,
    then the scale's and the shift's 3x3 convs to ``c``."""
    return (LABEL_NC * NHIDDEN + 2 * NHIDDEN * c) * 9 * r * r


def generator_macs(ngf: int, crop: int, z_dim: int, use_vae: bool) -> int:
    sw = crop // 32
    macs = z_dim * 16 * ngf * sw * sw if use_vae else LABEL_NC * 16 * ngf * 9 * sw * sw
    res = (sw, 2 * sw, 2 * sw, 4 * sw, 8 * sw, 16 * sw, 32 * sw)
    for i, r in enumerate(res):
        fin, fout = WIDTHS[i] * ngf, WIDTHS[i + 1] * ngf
        mid = min(fin, fout)
        macs += spade_norm_macs(fin, r) + spade_norm_macs(mid, r)
        macs += (fin * mid + mid * fout) * 9 * r * r
        if fin != fout:
            macs += spade_norm_macs(fin, r) + fin * fout * r * r
    return macs + ngf * 3 * 9 * crop * crop


def encoder_macs(ndf: int, z_dim: int) -> int:
    widths = (3, ndf, 2 * ndf, 4 * ndf, 8 * ndf, 8 * ndf, 8 * ndf)
    macs, r = 0, 256
    for cin, cout in zip(widths[:-1], widths[1:]):
        r = conv_out(r, 3, 2, 1)
        macs += cin * cout * 9 * r * r
    return macs + 2 * widths[-1] * r * r * z_dim


def discriminator_macs(ndf: int, n_layers: int, num_d: int, crop: int) -> int:
    """Every scale's PatchGAN on one (label, image) pair of 6 channels."""
    macs, size = 0, crop
    for _ in range(num_d):
        r = conv_out(size, 4, 2, 2)
        macs += 6 * ndf * 16 * r * r
        nf = ndf
        for i in range(1, n_layers):
            prev, nf = nf, min(2 * nf, 512)
            r = conv_out(r, 4, 1 if i == n_layers - 1 else 2, 2)
            macs += prev * nf * 16 * r * r
        r = conv_out(r, 4, 1, 2)
        macs += nf * 16 * r * r
        size = conv_out(size, 3, 2, 1)
    return macs


def vgg_macs(crop: int) -> int:
    macs, cin, r = 0, 3, crop
    for b, (c, n) in enumerate(VGG_BLOCKS):
        for _ in range(n):
            macs += cin * c * 9 * r * r
            cin = c
        if b < len(VGG_BLOCKS) - 1:
            r //= 2
    return macs


def iteration_flops(model: dict, batch: int) -> float:
    """Mean model FLOPs of one iteration at global ``batch``: a D step, and
    a G step every ``d_steps_per_g`` iterations.  ``model`` is the
    configuration file's ``model``."""
    m = model
    g = generator_macs(m["ngf"], m["crop_size"], m["z_dim"], m["use_vae"])
    e = encoder_macs(m["ndf"], m["z_dim"]) if m["use_vae"] else 0
    d = discriminator_macs(m["ndf"], m["n_layers_d"], m["num_d"], m["crop_size"])
    v = vgg_macs(m["crop_size"]) if m["use_vgg"] else 0
    d_step = batch * (g + e) + 3 * 2 * batch * d
    g_step = 3 * batch * (g + e) + 2 * batch * (d + v)
    return 2.0 * (d_step + g_step / m["d_steps_per_g"])
