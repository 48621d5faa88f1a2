"""SPADE GAN training CLI of the port (the root ``spade_train.py``'s
counterpart; reference SPADE/train.py).

    python -m surfelmapping_tpu_torch.spade_train --label-dir D1 --image-dir D2
        [--niter 100 --niter-decay 100] [--batch B] [--crop 256]
        [--d-steps-per-g 2] [--ckpt-dir checkpoints/spade]
        [--continue-train] [--steps-per-epoch N] [--device cuda|cpu]

Epoch loop over niter + niter_decay epochs, a D step every iteration and a
G step every ``--d-steps-per-g`` iterations, TTUR Adam, hinge + FM (+ VGG)
losses, linear LR decay after ``--niter`` epochs, iter.txt-resumable
iteration bookkeeping, loss log + HTML gallery.  The checkpoint
``<ckpt-dir>/latest.msgpack`` is the JAX package's format (flax msgpack of
its TrainState): either package's ``spade_test`` reads it, and either
package's ``--continue-train`` resumes it.  Runs on the CUDA card unless
``--device cpu`` is given; one device (the data-parallel mesh of the JAX
CLI is not ported).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--label-dir", required=True)
    ap.add_argument("--image-dir", required=True)
    ap.add_argument("--niter", type=int, default=100,
                    help="epochs at constant lr")
    ap.add_argument("--niter-decay", type=int, default=100,
                    help="epochs of linear lr decay to zero")
    ap.add_argument("--steps-per-epoch", type=int, default=0,
                    help="batches per epoch (0 = dataset size / batch)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--crop", type=int, default=256)
    ap.add_argument("--ngf", type=int, default=64)
    ap.add_argument("--ndf", type=int, default=64)
    ap.add_argument("--d-steps-per-g", type=int, default=2)
    ap.add_argument("--num-d", type=int, default=2,
                    help="multiscale discriminator count")
    ap.add_argument("--n-layers-d", type=int, default=4)
    ap.add_argument("--no-vgg", action="store_true")
    ap.add_argument("--use-vae", action="store_true",
                    help="VAE mode: ConvEncoder + reparameterised z + KLD "
                         "loss (reference --use_vae)")
    ap.add_argument("--lambda-kld", type=float, default=0.05)
    ap.add_argument("--kitti-skip-list", action="store_true",
                    help="drop the reference's hardcoded bad KITTI frames")
    ap.add_argument("--ckpt-dir", default="checkpoints/spade")
    ap.add_argument("--continue-train", action="store_true")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--display-every", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    import torch

    from .models.checkpoint import load_train_state, save_train_state
    from .models.data import KITTI_BAD_FRAME_RANGES, PairedRenderDataset
    from .models.pix2pix import SpadeConfig, SpadeTrainer
    from .models.train_utils import IterationCounter, Visualizer, save_options
    from .pipeline import resolve_device

    device = resolve_device(args.device)  # before any file is written
    os.makedirs(args.ckpt_dir, exist_ok=True)
    save_options(args.ckpt_dir, args)

    cfg = SpadeConfig(
        ngf=args.ngf, ndf=args.ndf, crop_size=args.crop,
        use_vgg=not args.no_vgg,
        num_d=args.num_d, n_layers_d=args.n_layers_d,
        niter=args.niter, niter_decay=args.niter_decay,
        use_vae=args.use_vae, lambda_kld=args.lambda_kld,
    )
    trainer = SpadeTrainer(cfg, device=device)
    ds = PairedRenderDataset(
        args.label_dir, args.image_dir, crop_size=args.crop,
        load_size=int(args.crop * 1.12),
        skip_ranges=KITTI_BAD_FRAME_RANGES if args.kitti_skip_list else (),
    )
    print(f"{len(ds)} paired frames; device={device}")

    next(ds.batches(args.batch, 1))  # the JAX CLI's init batch: the same draws follow
    ckpt_path = os.path.join(args.ckpt_dir, "latest.msgpack")
    if args.continue_train and os.path.exists(ckpt_path):
        state = trainer.state_from_numpy(load_train_state(ckpt_path))
        print(f"restored checkpoint {ckpt_path}")
    else:
        state = trainer.init_state()

    steps_per_epoch = args.steps_per_epoch or max(len(ds) // args.batch, 1)
    counter = IterationCounter(
        args.ckpt_dir, steps_per_epoch * args.batch, args.batch,
        args.niter, args.niter_decay, continue_train=args.continue_train,
    )
    viz = Visualizer(args.ckpt_dir)

    def save(state):
        save_train_state(ckpt_path, trainer.state_to_numpy(state))
        counter.record_current_iter()

    # replay the decay schedule up to the resume epoch so a resumed run
    # continues at the correct lr (update runs at the END of each epoch
    # with that epoch's number — reference train.py:85 convention)
    for e in range(1, counter.first_epoch):
        state = trainer.update_learning_rate(state, e)

    for epoch in counter.training_epochs():
        counter.record_epoch_start(epoch)
        for i, (lab, img) in enumerate(ds.batches(args.batch, steps_per_epoch)):
            lab, img = torch.from_numpy(lab), torch.from_numpy(img)
            state, dlogs = trainer.d_step(state, lab, img)
            logs = dict(dlogs)
            if i % args.d_steps_per_g == 0:
                state, glogs = trainer.g_step(state, lab, img)
                logs.update(glogs)
            counter.record_one_iteration()
            if counter.needs_printing(args.log_every * args.batch):
                viz.print_current_errors(epoch, counter.epoch_iter, logs)
            if counter.needs_displaying(args.display_every * args.batch):
                fake = trainer.infer(lab, state=state)
                viz.display_current_results(
                    {
                        "input_label": lab[0].numpy(),
                        "synthesized_image": fake[0].cpu().numpy(),
                        "real_image": img[0].numpy(),
                    },
                    epoch, counter.total_steps_so_far,
                )
            if counter.needs_saving():
                save(state)
        counter.record_epoch_end()
        state = trainer.update_learning_rate(state, epoch)
        g_lr, d_lr = trainer.current_lrs(state)
        print(f"epoch {epoch} done; lr G={g_lr:.2e} D={d_lr:.2e}")
        save(state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
