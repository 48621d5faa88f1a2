"""SPADE inference + postprocess CLI of the port (the root ``spade_test.py``'s
counterpart; reference SPADE/test.py + postprocess.py).

    python -m surfelmapping_tpu_torch.spade_test --ckpt spade_ckpt.msgpack \\
        --label-dir renders/image --semantic-dir renders/semantic --out out/ \\
        [--crop 256] [--device cuda|cpu]

Runs the generator over rendered label images and composites GAN pixels into
render holes (where semantic == 0), writing the final simulator frames.
``--ckpt`` is a checkpoint of the JAX package's ``spade_train.py`` (flax
msgpack of its TrainState); only the generator's variables are read.  Runs
on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
from PIL import Image

from .models.data import _frame_id, postprocess_composite
from .ops.transforms import device_scalar


def unit_batch(image_u8: np.ndarray, device: torch.device) -> torch.Tensor:
    """A u8 HWC image as a 1-image NHWC float32 batch in [-1, 1]."""
    x = torch.tensor(image_u8, device=device).float()[None]
    return x / device_scalar(127.5, device) - 1.0


def fake_to_u8(fake: torch.Tensor, height: int, width: int) -> np.ndarray:
    """One generated HWC image in [-1, 1] as u8 (clipped, then truncated),
    resized bicubic to ``height`` x ``width`` when its size differs."""
    out = torch.clamp((fake + 1.0) * 127.5, 0, 255).to(torch.uint8).contiguous().cpu().numpy()
    if out.shape[:2] != (height, width):
        out = np.asarray(Image.fromarray(out).resize((width, height), Image.BICUBIC))
    return out


def enhance_frame(model, label_u8: np.ndarray, semantic_u8: np.ndarray | None = None,
                  style_u8: np.ndarray | None = None) -> np.ndarray:
    """One simulator frame: the generator on a rendered u8 label (with a
    VAE, styled by ``style_u8`` or from z = 0), its output as u8 at the
    label's size, and GAN pixels where the render's semantic is 0 (all of
    them without a semantic).  ``model`` is a ``models.pix2pix.SpadeTrainer``."""
    style = None if style_u8 is None else unit_batch(style_u8, model.device)
    fake = model.infer(unit_batch(label_u8, model.device), style)[0]
    fake_u8 = fake_to_u8(fake, *label_u8.shape[:2])
    if semantic_u8 is None:
        return fake_u8
    return postprocess_composite(label_u8, fake_u8, semantic_u8)


def _read(path: str, mode: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert(mode))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--label-dir", required=True)
    ap.add_argument("--semantic-dir", default=None)
    ap.add_argument("--out", default="output/enhanced")
    ap.add_argument("--crop", type=int, default=256)
    ap.add_argument("--ngf", type=int, default=64)
    ap.add_argument("--num-d", type=int, default=2,
                    help="the checkpoint's discriminator count (read by the JAX CLI's "
                         "restore; inference does not use the discriminator)")
    ap.add_argument("--n-layers-d", type=int, default=4,
                    help="the checkpoint's discriminator depth (as --num-d)")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--start-frame-id", type=int, default=0,
                    help="skip frames below this id (reference "
                         "single_dataset.py start_frame_id)")
    ap.add_argument("--use-vae", action="store_true",
                    help="checkpoint was trained with --use-vae (the "
                         "encoder rides in g_params; inference uses the "
                         "z = 0 prior unless --style-dir is given)")
    ap.add_argument("--style-dir", default=None,
                    help="with --use-vae: encode the same-named image from "
                         "this directory as the style source (mu path)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    from .models.checkpoint import load_generator_variables
    from .models.pix2pix import SpadeConfig, SpadeTrainer
    from .pipeline import resolve_device

    device = resolve_device(args.device)  # before any file is read
    # the generator runs at the checkpoint's crop (aspect 1): the net is
    # fully convolutional, and its output is resized back to each label's
    # size for compositing (single_dataset.py:23-40)
    cfg = SpadeConfig(ngf=args.ngf, crop_size=args.crop, use_vae=args.use_vae)
    model = SpadeTrainer(cfg, variables=load_generator_variables(args.ckpt), device=device)

    names = sorted(os.listdir(args.label_dir))
    names = [
        n for n in names
        if (_frame_id(n) is None or _frame_id(n) >= args.start_frame_id)
    ]
    if args.limit:
        names = names[: args.limit]
    os.makedirs(args.out, exist_ok=True)
    for name in names:
        label = _read(os.path.join(args.label_dir, name), "RGB")
        style = _read(os.path.join(args.style_dir, name), "RGB") if args.style_dir else None
        sem = (_read(os.path.join(args.semantic_dir, name), "L") if args.semantic_dir
               else None)
        out = enhance_frame(model, label, sem, style)
        Image.fromarray(out).save(os.path.join(args.out, name))
    print(f"wrote {len(names)} frames to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
