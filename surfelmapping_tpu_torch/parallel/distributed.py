"""Multi-process runtime of the sharded surfel engine (counterpart of
surfelmapping_tpu/parallel/distributed.py).

JAX drives every device of a mesh from one controller per host; PyTorch runs
one process per rank, joined in a ``torch.distributed`` process group:

  * every rank calls :func:`initialize`, which joins the job's group from
    the environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, the
    rendezvous ``SURFEL_DIST_INIT`` and the backend
    ``SURFEL_DIST_BACKEND``), and gets the :class:`Comm` that the sharded
    engine's collectives go through (:func:`fusion_group` is the
    counterpart of ``fusion_mesh``);
  * every rank reads the same frames (replicated inputs: the per-frame
    images are small); the map state is what is sharded;
  * checkpoints: :func:`allgather_state` gives every rank every shard's live
    prefix, after which rank 0 writes the reference-format binary
    (:func:`save_checkpoint`).

SPADE's data-parallel training takes two more pieces from here:
:func:`shard_rows`, this rank's rows of a global batch (the counterpart of
``pix2pix.shard_batch``), and :func:`sum_over_ranks`, a SUM all-reduce that
autograd differentiates (the batch norms' statistics across ranks).

The backend is explicit: NCCL for ranks on cards of their own, gloo when
asked (CPU ranks, or ranks that share one card, which NCCL refuses).  Only
``all_reduce`` and ``broadcast`` are used, the two collectives that gloo
offers on CUDA tensors as well as on CPU ones; an all-gather is an
all-reduce (SUM) of a zero buffer that holds this rank's rows.

:func:`spawn_cpu_processes` launches N local gloo ranks (the CI harness of
the multi-rank path, as the JAX package's launcher is); :func:`spawn_ranks`
is the same launcher for any backend, and ``python -m
surfelmapping_tpu_torch.parallel.distributed --ranks N -- PROGRAM`` its
command line.  The rendezvous is a ``FileStore`` in
a fresh temporary directory, so concurrent jobs never collide on a port, and
one failed rank, or the timeout, kills every rank.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from ..surfels import COLUMNS, SurfelMap, save_map
from .sharded import ShardedMapState, gather_sharded_map

ENV_INIT = "SURFEL_DIST_INIT"        # rendezvous URL: file://... or tcp://host:port
ENV_BACKEND = "SURFEL_DIST_BACKEND"  # nccl | gloo
BACKENDS = ("nccl", "gloo")
REPO_ROOT = Path(__file__).resolve().parents[2]

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


class Comm:
    """The collectives of a group of ranks, with a count of the calls and
    the bytes they carried (each rank's own tensor, as it goes in).

    ``group=None`` is a job of one rank without a process group: its
    collectives return their input."""

    def __init__(self, group: dist.ProcessGroup | None = None):
        self.group = group
        self.rank = 0 if group is None else dist.get_rank(group)
        self.size = 1 if group is None else dist.get_world_size(group)
        self.backend = None if group is None else dist.get_backend(group)
        self.calls = 0
        self.bytes = 0

    def _count(self, t: torch.Tensor) -> None:
        self.calls += 1
        self.bytes += t.numel() * t.element_size()

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """Reduce ``t`` (contiguous) in place over the group with ``op``
        (sum, min or max) and return it."""
        if self.group is not None:
            self._count(t)
            dist.all_reduce(t, _OPS[op], group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place."""
        if self.group is not None:
            self._count(t)
            dist.broadcast(t, dist.get_global_rank(self.group, src), group=self.group)
        return t

    def barrier(self) -> None:
        """Return once every rank has called it: one one-element SUM
        all-reduce, waited for on the host (on the rank's card with NCCL)."""
        if self.group is not None:
            dev = torch.device("cuda", torch.cuda.current_device()) \
                if self.backend == "nccl" else torch.device("cpu")
            self.all_reduce(torch.zeros(1, device=dev), "sum").item()

    def all_gather_rows(self, rows: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``rows`` ([n_rank, ...], n_rank may differ between
        ranks, dtype and trailing shape may not), in rank order.  The counts
        travel first, then the rows padded to the largest count."""
        if self.group is None:
            return [rows]
        counts = torch.zeros(self.size, dtype=torch.int64, device=rows.device)
        counts[self.rank] = rows.shape[0]
        counts = self.all_reduce(counts, "sum").tolist()
        buf = rows.new_zeros((self.size, max(counts)) + tuple(rows.shape[1:]))
        buf[self.rank, : rows.shape[0]] = rows
        self.all_reduce(buf, "sum")
        return [buf[r, :n] for r, n in enumerate(counts)]


class _SumOverRanks(torch.autograd.Function):
    """A SUM all-reduce inside autograd's graph.  Every rank's output is the
    sum of every rank's input, so the gradient of a rank's input is the sum
    over the ranks of the gradients that reach their outputs: the backward
    is the same all-reduce of the incoming gradient."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, comm: Comm) -> torch.Tensor:
        ctx.comm = comm
        return comm.all_reduce(t.detach().clone(memory_format=torch.contiguous_format), "sum")

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.comm.all_reduce(grad.clone(memory_format=torch.contiguous_format), "sum"), None


def sum_over_ranks(t: torch.Tensor, comm: Comm | None) -> torch.Tensor:
    """``t`` summed over the ranks of ``comm`` (collective, in the forward and
    again in the backward, so every rank must call it in the same order),
    differentiable; ``t`` itself without a group of more than one rank."""
    if comm is None or comm.size == 1:
        return t
    return _SumOverRanks.apply(t, comm)


def shard_rows(comm: Comm | None, *arrays):
    """This rank's contiguous rows of each global batch in ``arrays``
    (tensors or numpy arrays of B rows): rank r of D holds rows
    [r * B / D, (r + 1) * B / D), the leading-axis sharding of
    ``pix2pix.shard_batch``.  Raises where B is not a multiple of D.  All of
    each array without a group."""
    size, rank = (1, 0) if comm is None else (comm.size, comm.rank)
    out = []
    for a in arrays:
        if a.shape[0] % size:
            raise ValueError(f"a batch of {a.shape[0]} rows does not split over {size} ranks")
        n = a.shape[0] // size
        out.append(a[rank * n:(rank + 1) * n])
    return tuple(out)


def initialize(backend: str | None = None, init_method: str | None = None,
               rank: int | None = None, world_size: int | None = None,
               timeout_s: float = 300.0) -> Comm:
    """Join (or create) the job's process group and return its :class:`Comm`.

    ``rank`` and ``world_size`` default to ``RANK`` and ``WORLD_SIZE``; the
    rendezvous is ``init_method``, else ``SURFEL_DIST_INIT``, else
    ``env://`` (``MASTER_ADDR``/``MASTER_PORT``); the backend is
    ``backend``, else ``SURFEL_DIST_BACKEND``, else NCCL.  An NCCL rank takes
    the card ``LOCAL_RANK`` (else its rank) as its current device.  With no
    job configured (no world size) this does nothing and returns the
    one-rank Comm, as the JAX function is a no-op without a coordinator.
    ``timeout_s`` bounds every collective, so a rank whose peer died fails
    instead of hanging."""
    if dist.is_initialized():
        return Comm(dist.group.WORLD)
    if world_size is None and "WORLD_SIZE" not in os.environ:
        return Comm(None)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(os.environ["RANK"]) if rank is None else rank
    backend = backend or os.environ.get(ENV_BACKEND, "nccl")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    init_method = init_method or os.environ.get(ENV_INIT, "env://")
    device_id = None
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the NCCL backend needs CUDA cards; pass backend='gloo' "
                               "to run the ranks on the CPU")
        device_id = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device_id)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            device_id=device_id)
    return Comm(dist.group.WORLD)


def fusion_group() -> Comm:
    """The Comm over every rank of the initialized job: the sharded engine's
    counterpart of the JAX ``fusion_mesh`` (a job runs one rank per shard,
    so the group is the world)."""
    if not dist.is_initialized():
        raise RuntimeError("fusion_group: no process group; call initialize() first")
    return Comm(dist.group.WORLD)


def shutdown() -> None:
    """Leave the process group (every rank; a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def allgather_state(state: ShardedMapState, comm: Comm) -> list[ShardedMapState]:
    """Every rank's shard on every rank (collective): each shard's live
    prefix as a ShardedMapState of that many slots, in rank order."""
    m = state.smap
    n = int(m.count)
    rows = torch.stack([m.column(k)[:n].view(torch.int32) for k in COLUMNS], dim=1)
    out = []
    for r, part in enumerate(comm.all_gather_rows(rows)):
        cols = {k: torch.cat([part[:, j], part.new_zeros(1)])
                for j, k in enumerate(COLUMNS)}
        cols = {k: c if k == "colorsem" else c.view(torch.float32) for k, c in cols.items()}
        count = torch.tensor(part.shape[0], dtype=torch.int32, device=part.device)
        out.append(ShardedMapState(SurfelMap(**cols, count=count), rank=r, world=comm.size))
    return out


def save_checkpoint(state: ShardedMapState, comm: Comm, path: str, start_id: int = 0,
                    end_id: int = 0) -> None:
    """Write the reference-format binary map of the whole sharded map
    (collective: every rank calls it; rank 0 writes)."""
    full = gather_sharded_map(allgather_state(state, comm))
    if comm.rank == 0:
        save_map(full, path, start_id, end_id)


# ---------------------------------------------------------------------------
# Local launcher
# ---------------------------------------------------------------------------

def spawn_ranks(argv: list[str], num_processes: int, backend: str, timeout: float = 600.0,
                extra_env: dict | None = None) -> list[subprocess.CompletedProcess]:
    """Run ``argv`` in ``num_processes`` local processes, rank r with
    ``RANK=r``, ``LOCAL_RANK=r``, ``WORLD_SIZE``, the backend and a
    ``FileStore`` rendezvous in a fresh temporary directory; the repository
    root goes first on ``PYTHONPATH``.  When one rank fails, or the timeout
    passes, every rank still running is killed and this raises with the end
    of each rank's output.  Returns the completed processes (their output
    in ``stdout``)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    with tempfile.TemporaryDirectory(prefix="surfel_job_") as td:
        procs, logs = [], []
        path = os.pathsep.join([str(REPO_ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
        try:
            for r in range(num_processes):
                env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                           WORLD_SIZE=str(num_processes), PYTHONPATH=path,
                           **{ENV_INIT: f"file://{td}/rendezvous", ENV_BACKEND: backend})
                env.update(extra_env or {})
                log = open(os.path.join(td, f"rank{r}.log"), "w+")
                logs.append(log)
                procs.append(subprocess.Popen(argv, env=env, stdout=log,
                                              stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            failed = timed_out = False
            while True:
                codes = [p.poll() for p in procs]
                if all(c == 0 for c in codes):
                    break
                failed = any(c not in (None, 0) for c in codes)
                timed_out = time.monotonic() > deadline
                if failed or timed_out:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    results = [subprocess.CompletedProcess(argv, p.returncode, out, None)
               for p, out in zip(procs, outs)]
    if failed or timed_out:
        why = f"timed out after {timeout} s" if timed_out and not failed else "failed"
        tails = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n{out[-3000:]}"
                          for r, (p, out) in enumerate(zip(procs, outs)))
        raise RuntimeError(f"distributed job {why}:\n{tails}")
    return results


def spawn_cpu_processes(argv: list[str], num_processes: int, timeout: float = 600.0,
                        extra_env: dict | None = None) -> list[subprocess.CompletedProcess]:
    """:func:`spawn_ranks` with gloo ranks on the CPU (no card is visible to
    them), each with an equal share of the CPU's threads."""
    threads = max(1, (os.cpu_count() or 1) // num_processes)
    env = {"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": str(threads), **(extra_env or {})}
    return spawn_ranks(argv, num_processes, "gloo", timeout, env)


def python_module(module: str, *args: str) -> list[str]:
    """The argv that runs ``python -m module args...`` with this interpreter."""
    return [sys.executable, "-m", module, *args]


def launch_ranks(module: str, argv: list[str], ranks: int, device: str | None,
                 timeout: float) -> int:
    """A CLI's ``--devices``: run ``python -m module argv...`` in ``ranks``
    ranks, gloo CPU ranks when ``device`` is "cpu", else NCCL ranks, one per
    card (raises with fewer cards than ranks).  Prints rank 0's output;
    returns 0 (a failed rank raises)."""
    cmd = python_module(module, *argv)
    if device == "cpu":
        results = spawn_cpu_processes(cmd, ranks, timeout=timeout)
    else:
        n = torch.cuda.device_count()
        if n < ranks:
            raise RuntimeError(f"--devices {ranks} needs {ranks} CUDA cards, found {n}; "
                               f"pass --device cpu to run {ranks} gloo ranks on the CPU")
        results = spawn_ranks(cmd, ranks, "nccl", timeout=timeout)
    print(results[0].stdout, end="", flush=True)
    return 0


def main(argv=None) -> int:
    """``python -m surfelmapping_tpu_torch.parallel.distributed --ranks N
    [--backend nccl|gloo] [--timeout S] -- PROGRAM ARGS...``: run a Python
    program (``-m module`` or a script, with its arguments) in N local ranks
    and print each rank's output, rank by rank.  A failed rank or the
    timeout kills every rank; the exit code is then 1."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--backend", choices=BACKENDS, default="nccl")
    ap.add_argument("--timeout", type=float, default=3600.0)
    ap.add_argument("program", nargs=argparse.REMAINDER,
                    help="after --: -m MODULE ARGS... or SCRIPT ARGS...")
    a = ap.parse_args(argv)
    prog = a.program[1:] if a.program[:1] == ["--"] else a.program
    if not prog:
        ap.error("no program to run")
    try:
        results = spawn_ranks([sys.executable, *prog], a.ranks, a.backend, a.timeout)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 1
    for r, res in enumerate(results):
        print(f"--- rank {r} ---\n{res.stdout}", end="", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
