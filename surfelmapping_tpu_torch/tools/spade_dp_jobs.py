"""Rank programs of SPADE's data-parallel training: each is one rank's side
of a job that ``parallel.distributed.spawn_ranks`` (or
``spawn_cpu_processes``) launches, and each writes what its caller checks
into ``--out`` (the counterpart of tests/spade_dp_worker.py, which runs the
JAX package's sharded jit).

    python -m surfelmapping_tpu_torch.tools.spade_dp_jobs JOB --out DIR [options]

Jobs (tests/test_torch_spade_dp.py, tests/test_torch_gpu.py and
chip_smoke.py's ``spade_dp`` phase launch them):
  norm   one SPADE norm in training mode on the rank's rows of
         :func:`norm_case`'s batch, its output weighted into a sum and
         differentiated: each rank writes its output rows, input gradient,
         parameter gradients and running statistics (``rank<r>.npz``)
  steps  a D step, then a G step, of ``SpadeTrainer`` on the rank's rows of
         the global batch (``--batch``) that every rank draws from
         ``PairedRenderDataset(--label-dir, --image-dir)``, from the seeded
         init (``init_state_numpy``) of the ``--config`` given, in
         ``--dtype``, with a VAE from the global batch's noise of
         ``--noise`` if given; each rank writes its state's tree (``rank<r>.msgpack``,
         without the VGG weights, which do not train) and a JSON line
         (``rank<r>.json``): the logs, the collectives' calls and bytes per
         step, and whether a checksum of the trained state is the same on
         every rank (all-reduced with MIN and with MAX).  With ``--timed N``
         (on the card) it then trains N more iterations in the CLI's pattern
         and adds the wall ms of those after the first ``--warm``, the card's
         busy ms, the collectives' ms (replayed), the parameter counts and
         the peak memory.

The ranks run on the card unless ``--device cpu`` is given; a CPU rank runs
one torch thread (the ranks share the machine).  No JAX is imported.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import convert
from ..models.checkpoint import packb
from ..models.data import PairedRenderDataset
from ..models.pix2pix import SpadeConfig, SpadeTrainer, TrainState, init_state_numpy
from ..models.spade import SPADENorm
from ..parallel.distributed import Comm, initialize, shard_rows, shutdown
from ..pipeline import resolve_device
from .sharded_jobs import collective_ms

NORM_C = 16  # norm_case's channels
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def norm_case(seed: int = 3) -> tuple[dict, dict]:
    """A SPADE norm's seeded flax variables (random running statistics) and
    a global batch of 4 in float64: ``x`` (4, NORM_C, 6, 10), the label
    ``seg`` (4, 3, 20, 30) and the loss weights ``w`` (x's shape)."""
    module = SPADENorm(NORM_C, device="meta")
    v = convert.init_numpy(module, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    v["batch_stats"]["BatchNorm_0"] = {"mean": rng.normal(0, 1, NORM_C).astype(np.float32),
                                       "var": rng.uniform(0.5, 2, NORM_C).astype(np.float32)}
    batch = {"x": rng.normal(0.5, 2, (4, NORM_C, 6, 10)),
             "seg": rng.uniform(-1, 1, (4, 3, 20, 30)),
             "w": rng.normal(0, 1, (4, NORM_C, 6, 10))}
    return v, batch


def norm_run(comm: Comm | None, variables: dict, batch: dict, device) -> dict:
    """One SPADE norm over ``comm`` (None: this process alone) on this
    rank's rows of ``batch``, in float64: the output rows, the gradient of
    sum(output * w) by the input rows and by each parameter, and the
    running statistics after the step, as numpy."""
    module = convert.load_numpy(SPADENorm(NORM_C, "meta", comm), variables, device,
                                trainable=True).to(torch.float64).train()
    x, seg, w = (torch.from_numpy(a).to(device) for a in shard_rows(
        comm, batch["x"], batch["seg"], batch["w"]))
    x.requires_grad_()
    out = module(x, seg)
    (out * w).sum().backward()
    res = {"out": out, "x_grad": x.grad, "mean": module.mean, "var": module.var}
    res.update({f"grad/{n}": p.grad for n, p in module.named_parameters()})
    return {k: v.detach().cpu().numpy() for k, v in res.items()}


def job_norm(comm: Comm, a) -> None:
    v, batch = norm_case()
    np.savez(Path(a.out) / f"rank{comm.rank}.npz",
             **norm_run(comm, v, batch, resolve_device(a.device)))


def state_checksum(state: TrainState) -> torch.Tensor:
    """Two int64 sums for each tensor of the trained state (both nets'
    parameters and buffers, both optimizers' moments): of its elements' bit
    patterns, and of them times their position (wrapping)."""
    tensors = [*state.g.state_dict().values(), *state.d.state_dict().values()]
    for opt in (state.g_opt, state.d_opt):
        tensors += [*opt.mu, *opt.nu]
    sums = []
    for t in tensors:
        bits = t.detach().contiguous().view(-1)
        bits = bits.view({4: torch.int32, 8: torch.int64}[bits.element_size()]).to(torch.int64)
        pos = torch.arange(1, bits.numel() + 1, device=bits.device)
        sums += [bits.sum(), (bits * pos).sum()]
    return torch.stack(sums)


def ranks_identical(comm: Comm, state: TrainState) -> bool:
    """Whether every rank holds the same trained state, bit for bit, by
    :func:`state_checksum` all-reduced with MIN and with MAX (collective)."""
    c = state_checksum(state)
    return torch.equal(comm.all_reduce(c.clone(), "min"), comm.all_reduce(c.clone(), "max"))


def norm_widths(gen: torch.nn.Module) -> list[int]:
    """The channels of each of the generator's SPADE norms, in order."""
    return [m.mean.numel() for m in gen.modules() if isinstance(m, SPADENorm)]


def timed(comm: Comm, tr: SpadeTrainer, st: TrainState, batches: list, warm: int,
          g_logs: int) -> dict:
    """The CLI's pattern (a D step each iteration, a G step every second) on
    ``batches`` (this rank's rows), on the card: wall ms per iteration after
    ``warm`` iterations, the card's busy ms of this rank over one iteration
    with a G step and one without (torch.profiler: NCCL's kernels, which
    wait for the other ranks on the card, apart too, the two iterations' wall
    ms beside it, and their eight costliest kernels), the collectives of one
    D and one G step replayed (``sharded_jobs.collective_ms``; the G step's
    gradients carry its ``g_logs`` losses), the parameter counts and the
    peak memory."""
    from torch.profiler import ProfilerActivity, profile

    dev = tr.device

    def iteration(i, lab, img):
        tr.d_step(st, lab, img)
        if i % 2 == 0:
            tr.g_step(st, lab, img)

    wall = []
    for i, (lab, img) in enumerate(batches):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        iteration(i, lab, img)
        torch.cuda.synchronize(dev)
        wall.append((time.perf_counter() - t0) * 1e3)
    wall = wall[warm:]
    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2):
            iteration(i, *batches[i])
        torch.cuda.synchronize(dev)
        profiled_ms = (time.perf_counter() - t0) * 1e3 / 2
    events = sorted((e for e in prof.key_averages() if e.device_type == cuda
                     and not getattr(e, "is_user_annotation", False)),
                    key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 2e3
    # NCCL's kernels stay resident while they wait for the other ranks
    nccl = sum(e.self_device_time_total for e in events if e.key.startswith("nccl")) / 2e3
    n_g = sum(p.numel() for p in st.g_opt.params)
    n_d = sum(p.numel() for p in st.d_opt.params)
    dt = st.g_opt.params[0].dtype
    widths = norm_widths(st.gen)
    top = [dict(name=e.key[:90], ms_per_iteration=e.self_device_time_total / 2e3,
                launches=e.count) for e in events[:8]]
    out = dict(wall_ms=statistics.mean(wall), wall_ms_all=wall, timed_iterations=len(wall),
               busy_ms_per_iteration=busy, nccl_kernel_ms_per_iteration=nccl,
               profiled_wall_ms=profiled_ms, top_kernels=top,
               g_params=n_g, d_params=n_d, spade_norms=len(widths),
               max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    if comm.size > 1:
        out["collective_ms"] = dict(
            d_grad=collective_ms(comm, [(dt, n_d + 1, "sum")], dev),
            g_grad=collective_ms(comm, [(dt, n_g + g_logs, "sum")], dev),
            g_batch_norms=collective_ms(comm, [(dt, 2 * c, "sum") for c in widths] * 2, dev))
    return out


def job_steps(comm: Comm, a) -> None:
    dev = resolve_device(a.device)
    if dev.type == "cuda" and comm.backend == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    dtype = DTYPES[a.dtype]
    cfg = SpadeConfig(**json.loads(a.config))
    ds = PairedRenderDataset(a.label_dir, a.image_dir, crop_size=cfg.crop_size,
                             load_size=int(cfg.crop_size * 1.12))
    batches = [shard_rows(comm, *(torch.from_numpy(x).to(dtype) for x in b))
               for b in ds.batches(a.batch, 1 + a.timed)]
    tr = SpadeTrainer(cfg, device=dev, comm=comm)
    st = tr.state_from_numpy(init_state_numpy(cfg)).to(dtype)
    noise = {} if a.noise is None else dict(np.load(a.noise))
    logs, collectives = {}, {}
    for step in ("d_step", "g_step"):
        if step == "g_step" and comm.rank == a.fail_rank:
            raise RuntimeError(f"rank {comm.rank} fails before its G step, as asked")
        calls, nbytes = comm.calls, comm.bytes
        z = noise.get(step)
        _, out = getattr(tr, step)(st, *batches[0],
                                   noise=None if z is None else torch.from_numpy(z))
        logs.update({k: float(v) for k, v in out.items()})
        collectives[step] = dict(calls=comm.calls - calls, bytes=comm.bytes - nbytes)
    tree = tr.state_to_numpy(st)
    del tree["vgg_params"]
    (Path(a.out) / f"rank{comm.rank}.msgpack").write_bytes(packb(tree))
    res = dict(rank=comm.rank, ranks=comm.size, backend=comm.backend, device=str(dev),
               rows=int(batches[0][0].shape[0]), logs=logs, collectives=collectives,
               ranks_identical=ranks_identical(comm, st))
    if a.timed:
        res.update(timed(comm, tr, st, batches[1:], a.warm, g_logs=len(out)))
    (Path(a.out) / f"rank{comm.rank}.json").write_text(json.dumps(res))


JOBS = {"norm": job_norm, "steps": job_steps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("job", choices=sorted(JOBS))
    ap.add_argument("--out", required=True, help="directory for the job's results")
    ap.add_argument("--device", default=None,
                    help="the ranks' device (default: the CUDA card; an NCCL rank's own)")
    ap.add_argument("--label-dir", help="steps: the label PNGs")
    ap.add_argument("--image-dir", help="steps: the image PNGs")
    ap.add_argument("--batch", type=int, default=2, help="steps: the global batch")
    ap.add_argument("--config", default="{}", help="steps: SpadeConfig's fields as JSON")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    ap.add_argument("--timed", type=int, default=0,
                    help="steps: iterations to time after the two steps (on the card)")
    ap.add_argument("--warm", type=int, default=2, help="steps: untimed iterations of those")
    ap.add_argument("--noise", help="steps: .npz of the global batch's VAE noise for "
                                    "d_step and g_step (default: the trainer's draws)")
    ap.add_argument("--fail-rank", type=int, default=-1,
                    help="steps: this rank raises before its G step")
    a = ap.parse_args(argv)
    if a.device == "cpu":
        torch.set_num_threads(1)
    comm = initialize()
    try:
        os.makedirs(a.out, exist_ok=True)
        JOBS[a.job](comm, a)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
