"""SPADE GAN training CLI of the port (the root ``spade_train.py``'s
counterpart; reference SPADE/train.py).

    python -m surfelmapping_tpu_torch.spade_train --label-dir D1 --image-dir D2
        [--niter 100 --niter-decay 100] [--batch B] [--crop 256]
        [--d-steps-per-g 2] [--ckpt-dir checkpoints/spade]
        [--continue-train] [--steps-per-epoch N] [--device cuda|cpu]
        [--devices D [--timeout S]] [--profile]

Epoch loop over niter + niter_decay epochs, a D step every iteration and a
G step every ``--d-steps-per-g`` iterations, TTUR Adam, hinge + FM (+ VGG)
losses, linear LR decay after ``--niter`` epochs, iter.txt-resumable
iteration bookkeeping, loss log + HTML gallery.  The checkpoint
``<ckpt-dir>/latest.msgpack`` is the JAX package's format (flax msgpack of
its TrainState): either package's ``spade_test`` reads it, and either
package's ``--continue-train`` resumes it.  Runs on the CUDA card unless
``--device cpu`` is given.

Batches: every rank makes every global batch's random draws (the pair,
the crop, the flip, the erasing) in the same order, so a seed and
``--batch`` give the same samples for any number of ranks, and decodes
only its own rows; a worker thread decodes the next two batches while
the card runs the steps (``models.data.Prefetched``).  :func:`train_iteration` is one
iteration of the loop, which the benchmark's training cell calls too.

Data parallel (the JAX CLI's mesh branch): ``--devices D`` runs D ranks
(NCCL ranks, one per card, or gloo ranks on the CPU with ``--device cpu``;
``--timeout`` kills every rank after S seconds, or when one fails).  Every
rank trains on its rows of the global batches; the
batch norms, the gradients and the printed losses are global
(``models.pix2pix``), so the run trains as one process on the global batch
would.  Rank 0 alone writes the options, the log, the gallery, iter.txt
and the checkpoint; every rank reads the checkpoint to resume.  A
``--batch`` that D does not divide runs in this process alone, as the JAX
CLI runs on one device.  Started by a launcher (``RANK`` set), this process
is one rank of the job.
"""

from __future__ import annotations

import argparse
import gc
import os
import sys

from .utils import tracing


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
    ap.add_argument("--devices", type=int, default=1, metavar="D",
                    help="train data-parallel in D ranks (D > 1): NCCL ranks on D cards, "
                         "or gloo ranks on the CPU with --device cpu")
    ap.add_argument("--timeout", type=float, default=86400.0,
                    help="seconds after which a multi-rank job is killed, every rank")
    ap.add_argument("--profile", action="store_true",
                    help="record the spans and print their summary at the end (rank 0)")
    args = ap.parse_args(argv)

    import torch

    from .parallel.distributed import initialize, launch_ranks, shutdown
    from .pipeline import resolve_device

    device = resolve_device(args.device)  # before any file is written or any rank starts
    if args.devices > 1 and "RANK" not in os.environ and args.batch % args.devices == 0:
        return launch_ranks(f"{__package__}.spade_train",
                            list(sys.argv[1:] if argv is None else argv), args.devices,
                            args.device, args.timeout)
    comm = None
    if args.devices > 1 and "RANK" in os.environ:
        comm = initialize(timeout_s=args.timeout)
        if comm.size != args.devices:
            raise RuntimeError(f"--devices {args.devices} in a job of {comm.size} ranks")
        if comm.backend == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
    if args.profile:
        tracing.enable()
    try:
        return train(args, device, comm)
    finally:
        if comm is not None:
            shutdown()
        if args.profile and (comm is None or comm.rank == 0):
            print(tracing.summary())


def train_iteration(trainer, state, batches, it: int, with_g: bool):
    """One iteration of the training loop (collective across ranks): the
    rank's rows of the next global batch from ``batches`` (a
    ``models.data.Prefetched``; the wait for it is the ``spade.data``
    span), a D step, and a G step when ``with_g``, under the root span
    ``spade.iter`` with id ``it``.  Returns the state, the batch and the
    steps' logs (global, as 0-d tensors)."""
    with tracing.span("spade.iter", root_id=it):
        with tracing.span("spade.data"), tracing.span(tracing.WAIT):
            lab, img = next(batches)
        with tracing.span("spade.d_step"):
            state, logs = trainer.d_step(state, lab, img)
        logs = dict(logs)
        if with_g:
            with tracing.span("spade.g_step"):
                state, glogs = trainer.g_step(state, lab, img)
            logs.update(glogs)
    return state, (lab, img), logs


def train(args, device, comm) -> int:
    """The training run of :func:`main`'s parsed ``args`` on ``device``: in
    this process alone (``comm`` None) or as one rank of a data-parallel
    job."""
    from .models.checkpoint import load_train_state, save_train_state
    from .models.data import KITTI_BAD_FRAME_RANGES, PairedRenderDataset, Prefetched
    from .models.pix2pix import SpadeConfig, SpadeTrainer
    from .models.train_utils import IterationCounter, Visualizer, save_options
    from .parallel.distributed import rank_rows

    lead = comm is None or comm.rank == 0
    if lead:
        os.makedirs(args.ckpt_dir, exist_ok=True)
    save_options(args.ckpt_dir, args, comm)
    if args.devices > 1 and comm is None:
        print(f"--batch {args.batch} not divisible by {args.devices} devices; "
              "running single-device (pad the batch to shard)")

    cfg = SpadeConfig(
        ngf=args.ngf, ndf=args.ndf, crop_size=args.crop,
        use_vgg=not args.no_vgg,
        num_d=args.num_d, n_layers_d=args.n_layers_d,
        niter=args.niter, niter_decay=args.niter_decay,
        use_vae=args.use_vae, lambda_kld=args.lambda_kld,
    )
    trainer = SpadeTrainer(cfg, device=device, comm=comm)
    ds = PairedRenderDataset(
        args.label_dir, args.image_dir, crop_size=args.crop,
        load_size=int(args.crop * 1.12),
        skip_ranges=KITTI_BAD_FRAME_RANGES if args.kitti_skip_list else (),
    )
    if lead:
        ranks = "" if comm is None else f"; {comm.size} ranks over {comm.backend}"
        print(f"{len(ds)} paired frames; device={device}{ranks}")

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
        args.niter, args.niter_decay, continue_train=args.continue_train, comm=comm,
    )
    viz = Visualizer(args.ckpt_dir, comm=comm)

    def save(state):
        save_train_state(ckpt_path, trainer.state_to_numpy(state) if lead else None, comm)
        counter.record_current_iter()

    # replay the decay schedule up to the resume epoch so a resumed run
    # continues at the correct lr (update runs at the END of each epoch
    # with that epoch's number — reference train.py:85 convention)
    for e in range(1, counter.first_epoch):
        state = trainer.update_learning_rate(state, e)

    epochs = counter.training_epochs()
    # one stream for every epoch: the same draws as a generator per epoch
    batches = Prefetched(ds.batches(args.batch, steps_per_epoch * len(epochs),
                                    rank_rows(comm, args.batch)),
                         pin=device.type == "cuda")
    gc.collect()
    gc.freeze()  # what lives now is left out of the collector's passes in the loop
    with batches:
        for epoch in epochs:
            counter.record_epoch_start(epoch)
            for i in range(steps_per_epoch):
                state, (lab, img), logs = train_iteration(
                    trainer, state, batches, counter.total_steps_so_far // args.batch,
                    i % args.d_steps_per_g == 0)
                counter.record_one_iteration()
                if counter.needs_printing(args.log_every * args.batch):
                    viz.print_current_errors(epoch, counter.epoch_iter, logs)
                if lead and counter.needs_displaying(args.display_every * args.batch):
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
            if lead:
                print(f"epoch {epoch} done; lr G={g_lr:.2e} D={d_lr:.2e}")
            save(state)
    gc.unfreeze()
    return 0


if __name__ == "__main__":
    sys.exit(main())
