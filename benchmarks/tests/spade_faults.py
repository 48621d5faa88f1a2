"""A rank of the ``spade`` driver with a fault put into the program: the
fault named by ``SPADE_FAULT`` is applied, then the driver's rank runs.

    SPADE_FAULT=local_bn python -m benchmarks.tests.spade_faults JOB_JSON

Faults: ``local_bn`` (each rank's batch norms take its own rows'
statistics), ``drop_rank`` (the last rank's gradients and losses left out
of the gradient all-reduce), ``no_vgg`` (the VGG term dropped from the G
loss), ``no_update`` (Adam's moments move, the weights do not),
``half_lr`` (Adam's steps at half the learning rate), ``no_flip`` (the
loader's flips left undone)."""

from __future__ import annotations

import dataclasses
import os
import sys


def apply(fault: str) -> None:
    import torch

    from surfelmapping_tpu_torch.models import pix2pix, spade

    if fault == "local_bn":
        def local(self, x):
            mean = x.mean(dim=(0, 2, 3))
            return mean, torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
        spade.SPADENorm.batch_statistics = local
    elif fault == "drop_rank":
        summed = pix2pix.SpadeTrainer._sum_over_ranks

        def sum_without_last(self, grads, logs):
            if self.comm.rank == self.comm.size - 1:
                grads = [torch.zeros_like(g) for g in grads]
                logs = {k: torch.zeros_like(torch.as_tensor(v)) for k, v in logs.items()}
            return summed(self, grads, logs)
        pix2pix.SpadeTrainer._sum_over_ranks = sum_without_last
    elif fault == "no_vgg":
        pix2pix.vgg_loss = lambda vgg, fake, real, lam: 0.0 * fake.sum()
    elif fault in ("no_update", "half_lr"):
        update = pix2pix.AdamState.update

        def faulty(self, grads):
            if fault == "half_lr":
                lr = self.hyper["learning_rate"]
                self.hyper["learning_rate"] = lr / 2
                update(self, grads)
                self.hyper["learning_rate"] = lr
                return
            kept = [p.detach().clone() for p in self.params]
            update(self, grads)
            with torch.no_grad():
                torch._foreach_copy_(self.params, kept)
        pix2pix.AdamState.update = faulty
    elif fault == "no_flip":
        from surfelmapping_tpu_torch.models import data

        load = data.PairedRenderDataset.load
        data.PairedRenderDataset.load = lambda self, d: load(self, dataclasses.replace(d, flip=False))
    else:
        raise ValueError(f"no fault {fault!r}")


if __name__ == "__main__":
    apply(os.environ["SPADE_FAULT"])
    from benchmarks.drivers.spade import rank_main

    sys.exit(rank_main(sys.argv[1]))
