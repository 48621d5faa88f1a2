"""Driver ``spade``: SPADE trained data-parallel, as ``python -m
surfelmapping_tpu_torch.spade_train --devices D --batch B --use-vae``
trains it, one rank per card.

Set-up launches the ranks through the program's ``parallel.distributed.
spawn_ranks`` (NCCL on the card, gloo on the CPU), each running this
module (:func:`rank_main`), and meanwhile writes the traffic's paired views
as PNGs into the run's temporary directory (``traffic/pairs.py``: the
program's own map and renders).  Every rank initialises the weights from
the seed while the pairs are made, then reads them through ``models.data.
PairedRenderDataset`` (every global batch's draws, its own rows decoded,
the next batch prefetched) and trains through ``spade_train.
train_iteration``, the CLI's own iteration: a D step each iteration, a G
step every ``d_steps_per_g`` (a period).  The ranks warm up for
``warm_iterations``; the window starts on a barrier and ends on the first
whole period to end after ``--seconds``, on a barrier, so every window's
iterations are whole periods.  Rank 0's host clock times it;
``frames_per_s`` is the training images of the window (the global batch
times its iterations) over its seconds.  The traced run traces a stretch
of ``trace_iterations`` on rank 0.  A setting of the configuration that the
program does not take, or holds at another value, fails the run at once.

The check (:func:`check`) holds four things to their limits:
  * ``param_mismatch``: the tensors of the generator, the encoder and the
    discriminator (weights and buffers) at the window's end in which a rank
    differs from rank 0, by two checksums of each tensor's bits;
  * ``rows_mismatch``: the rows of the window's first two global batches
    in which the ranks' rows differ, bit for bit, from the same draws
    decoded from the PNGs by the plain loader (``reference/spade/data``);
  * ``step_rel_err``: from rank 0's state at the window's start, the plain
    reference (``reference/spade``) recomputes the window's first two
    iterations (D, G, D) on those plainly decoded batches, with the VAE
    noise the program drew; the worst relative error over the steps'
    gradients (Adam's first moments: beta1 is 0), each weight's change over
    the step (the weights whose gradient reaches ``GRAD_FLOOR`` of their
    net's largest), the batch norms' running statistics and the losses;
  * ``loss_nonfinite``: the non-finite losses of the window.
``--control 1`` runs the program with TF32 on (on the CPU, which has no
TF32, every convolution's and dense layer's operands rounded to TF32's 10
mantissa bits), which the check has to find.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

from benchmarks import harness

RANK_MODULE = "benchmarks.drivers.spade"
# a gradient's error is taken relative to at least this share of its net's
# largest gradient, and a weight's change is compared only where its
# gradient reaches it: the biases ahead of a normalization have a true
# gradient of 0 and get rounding noise, which Adam scales to +-lr
GRAD_FLOOR = 1e-2
BASES = {"mid": "before", "after": "mid"}  # the state each compared step starts from


@dataclasses.dataclass
class State:
    work: Path
    job: dict
    thread: threading.Thread
    outcome: dict


# -- set-up, window and check: the harness's process ------------------------------------

def needs_program() -> None:
    """Fail at once on a program without what the cell drives."""
    from surfelmapping_tpu_torch import spade_train
    from surfelmapping_tpu_torch.models import data

    missing = [n for n, m in (("spade_train.train_iteration", spade_train),
                              ("models.data.Prefetched", data))
               if not hasattr(m, n.split(".")[-1])]
    if missing:
        raise SystemExit(f"the program lacks {missing}, which this cell drives")


def program_config(model: dict):
    """The program's ``SpadeConfig`` of the configuration's ``model``.  A
    key that is no field of it has to equal the program's own constant
    (``d_steps_per_g`` is the loop's, which this driver runs); any other
    key, or another value, fails the run."""
    from surfelmapping_tpu_torch.models import pix2pix, spade

    fields = {f.name for f in dataclasses.fields(pix2pix.SpadeConfig)}
    fixed = {"label_nc": spade.LABEL_NC, "lambda_feat": pix2pix.LAMBDA_FEAT,
             "lambda_vgg": pix2pix.LAMBDA_VGG, "g_lr": pix2pix.LR / 2.0,
             "d_lr": pix2pix.LR * 2.0, "beta1": pix2pix.BETA1, "beta2": pix2pix.BETA2,
             "eps": pix2pix.ADAM_EPS}
    bad = {k: v for k, v in model.items()
           if k not in fields and k != "d_steps_per_g" and (k not in fixed or fixed[k] != v)}
    if bad:
        raise SystemExit(f"the program does not take {bad} (its own: "
                         f"{ {k: fixed.get(k) for k in bad} })")
    return pix2pix.SpadeConfig(**{k: v for k, v in model.items() if k in fields})


def setup(ctx) -> State:
    t_setup = time.perf_counter()
    needs_program()
    cell, mix = ctx.cell, ctx.cell.traffic
    model = cell.config["model"]
    program_config(model)
    period = int(model["d_steps_per_g"])
    if mix["warm_iterations"] % period or mix["trace_iterations"] % period:
        raise SystemExit(f"the warm-up and the traced stretch are whole periods of {period}")
    work = Path(tempfile.mkdtemp(prefix="spade_cell_"))
    ranks = int(cell.config["gpus"])
    backend = cell.settings["backend"] if ctx.device.type == "cuda" else "gloo"
    job = {"model": model, "ranks": ranks, "backend": backend, "period": period,
           "device": ctx.device.type, "batch": ranks * int(mix["batch_per_rank"]),
           "label_dir": str(work / "label"), "image_dir": str(work / "image"),
           "pairs": str(work / "pairs.json"),
           "load_size": mix["load_size"], "seed": ctx.seed, "seconds": ctx.seconds,
           "warm": mix["warm_iterations"], "trace": ctx.trace,
           "trace_from_period": mix["trace_from_period"], "trace_iterations": mix["trace_iterations"],
           "control": ctx.control, "timeout_s": cell.settings["timeout_s"], "out": str(work)}
    (work / "job.json").write_text(json.dumps(job))
    outcome: dict = {"t_spawn": time.perf_counter()}
    thread = threading.Thread(target=launch, args=(job, work, cell.settings, outcome),
                              daemon=True)
    thread.start()  # the ranks start and make their weights while the pairs are made
    try:
        pairs = cell.generator().write_pairs(mix, ctx.seed, ctx.device, str(work))
        ready = {"ok": True}
    except BaseException as e:
        ready = {"error": repr(e)}
        raise
    finally:
        (work / "pairs.tmp").write_text(json.dumps(ready))
        os.replace(work / "pairs.tmp", job["pairs"])
    ctx.notes.update(start_s=t_setup - ctx.t_process, pairs_map_s=pairs["map_s"],
                     pairs_render_write_s=pairs["render_write_s"],
                     pairs_live_surfels=pairs["live_surfels"])
    return State(work, job, thread, outcome)


def launch(job: dict, work: Path, settings: dict, outcome: dict) -> None:
    """Run the ranks (on a thread of the harness's process) and keep what
    ``spawn_ranks`` returned or raised."""
    from surfelmapping_tpu_torch.parallel import distributed

    argv = [sys.executable, "-m", RANK_MODULE, str(work / "job.json")]
    env = dict(settings.get("env", {}))
    try:
        if job["device"] == "cpu":
            distributed.spawn_cpu_processes(argv, job["ranks"], job["timeout_s"], env)
        else:
            env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // job["ranks"])))
            distributed.spawn_ranks(argv, job["ranks"], job["backend"], job["timeout_s"], env)
        outcome["ok"] = True
    except RuntimeError as e:
        outcome["error"] = e


def window(st: State, ctx) -> dict:
    st.thread.join()
    if "error" in st.outcome:
        raise st.outcome["error"]
    ranks = [json.loads((st.work / f"rank{r}.json").read_text()) for r in range(st.job["ranks"])]
    r0 = ranks[0]
    ctx.window_started(r0["t_window"])
    seconds = r0["t_end"] - r0["t_window"]
    images = r0["iterations"] * st.job["batch"]
    ctx.notes.update(iterations=r0["iterations"], period_s=r0["period_s"],
                     rank_start_s=max(r["t_start"] for r in ranks) - st.outcome["t_spawn"],
                     init_s=r0["init_s"], pairs_wait_s=r0["pairs_wait_s"], warm_s=r0["warm_s"],
                     window_gap_s=r0["t_window"] - r0["t_warm_end"],
                     rank_train_peak_bytes=[r["train_peak_bytes"] for r in ranks],
                     rank_memory_peak_bytes=[r["memory_peak_bytes"] for r in ranks])
    records = None
    if ctx.trace and (st.work / "records.json").exists():
        from benchmarks import spade_flops

        records = json.loads((st.work / "records.json").read_text())
        records["flops_per_iter"] = spade_flops.iteration_flops(ctx.cell.config["model"],
                                                                st.job["batch"])
        records["ranks"] = st.job["ranks"]
        records["peak_flops"] = spade_flops.F32_FLOPS_PER_S
    st.outcome["ranks"] = ranks
    return {"attempted": images, "failed": 0, "seconds": seconds,
            "metrics": {"frames_per_s": images / seconds}, "records": records}


def check(st: State, ctx) -> dict:
    ranks = st.outcome["ranks"]
    sums = [r["checksums"] for r in ranks]
    mismatch = sum(a != b for other in sums[1:] for a, b in zip(sums[0], other))
    mismatch += sum(len(s) != len(sums[0]) for s in sums)
    try:
        rows, err, notes = step_error(st, ctx)
    finally:
        shutil.rmtree(st.work, ignore_errors=True)
    ctx.notes.update(notes)
    lim = ctx.cell.settings["limits"]
    return {"param_mismatch": (mismatch, lim["param_mismatch"]),
            "rows_mismatch": (rows, lim["rows_mismatch"]),
            "step_rel_err": (err, lim["step_rel_err"]),
            "loss_nonfinite": (ranks[0]["nonfinite"], lim["loss_nonfinite"])}


def reference_config(model: dict):
    from benchmarks.reference.spade import Config

    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in model.items() if k in names})


def reference_state(snap: dict, device):
    """The reference's state from a snapshot of the program's
    (:func:`snapshot`)."""
    from benchmarks.reference.spade import Adam, State as RefState

    def part(prefix):
        got = {k[len(prefix):]: v.to(device) for k, v in snap.items() if k.startswith(prefix)}
        return got or None

    adam = {n: Adam(int(snap[f"{n}_count"]), part(f"{n}_mu/"), part(f"{n}_nu/"))
            for n in ("g", "d")}
    return RefState(part("gen/"), part("enc/"), part("d/"), part("vgg/"), adam["g"], adam["d"])


def _rms(t) -> float:
    return float(t.double().pow(2).mean().sqrt())


def rel_errors(got: dict, want: dict, floor: float) -> dict:
    """Per tensor, the RMS of got - want over the larger of want's RMS and
    ``floor`` times the largest RMS among ``want``'s tensors."""
    rms = {k: _rms(v) for k, v in want.items()}
    top = max(rms.values())
    return {k: _rms(got[k].double().cpu() - want[k].double().cpu())
            / max(rms[k], floor * top, 1e-30) for k in want}


def reference_steps(snaps: dict, batches: list, with_g: list, cfg, device,
                    parts: int = 1) -> dict:
    """The reference's steps of the window's first two iterations on their
    global ``batches`` (a G step after the D step where ``with_g``), with
    the VAE noise the program drew (the generators' states in
    ``snaps["before"]``), in the layout of the program's snapshots:
    ``mid``, the first iteration from the program's state at the window's
    start (``snaps["before"]``), and ``after``, the second from the
    program's state after the first (``snaps["mid"]``); each with the
    weights and buffers of the networks it trained, the gradients (Adam's
    first moments) and the losses.  ``parts`` splits each batch as ranks
    would.

    The second iteration starts from the program's state and not from the
    reference's: Adam moves the biases ahead of the generator's batch norms,
    whose gradients are rounding noise, by +-lr with the noise's sign, and
    the generator in eval mode (a D step's) does not cancel them, so a D
    step after the reference's own G step would compare two draws of that
    noise rather than the program with the reference."""
    from benchmarks.reference.spade import d_step, g_step

    rngs = {}
    for name in ("g_rng", "d_rng"):
        rngs[name] = torch.Generator(device)
        rngs[name].set_state(snaps["before"][name])
    B = batches[0][0].shape[0]
    draw = lambda g: torch.randn((B, cfg.z_dim), generator=rngs[g], device=device)  # noqa: E731

    out = {}
    for step, base, batch, g in zip(("mid", "after"), ("before", "mid"), batches, with_g):
        ref = reference_state(snaps[base], device)
        logs = d_step(ref, *batch, draw("d_rng"), cfg, parts)
        if g:
            logs.update(g_step(ref, *batch, draw("g_rng"), cfg, parts))
        nets = {"d": ref.d}
        if g:
            nets.update(gen=ref.gen, enc=ref.enc or {})
        got = {"logs": logs}
        for net, tensors in nets.items():
            got.update({f"{net}/{k}": v for k, v in tensors.items()})
        for net in ("gd" if g else "d"):
            adam = ref.g_adam if net == "g" else ref.d_adam
            got.update({f"{net}_mu/{k}": v for k, v in adam.mu.items()})
        out[step] = got
    return out


def param_key(mu_key: str) -> str:
    """The snapshot's name of the weight of a first moment's name:
    ``g_mu/gen.X`` is ``gen/X``, ``g_mu/enc.X`` ``enc/X``, ``d_mu/X``
    ``d/X``."""
    net, name = mu_key.split("/", 1)
    return name.replace(".", "/", 1) if net == "g_mu" else f"d/{name}"


def step_errors(want: dict, got: dict, snaps: dict) -> dict:
    """Each compared tensor's and loss's relative error, ``got`` against
    ``want`` (both in :func:`reference_steps`'s layout; ``snaps`` holds the
    states the steps started from)."""
    errs = {}
    for step, w in want.items():
        g, base = got[step], snaps[BASES[step]]
        for net in ("g_mu/", "d_mu/"):
            grads = {k: v for k, v in w.items() if k.startswith(net)}
            if not grads:
                continue
            errs.update({f"{step}:{k}": e for k, e in rel_errors(
                {k: g[k] for k in grads}, grads, GRAD_FLOOR).items()})
            rms = {k: _rms(v) for k, v in grads.items()}
            moved = [param_key(k) for k in grads if rms[k] >= GRAD_FLOOR * max(rms.values())]
            change = lambda s: {k: s[k].double().cpu() - base[k].double() for k in moved}  # noqa: E731
            errs.update({f"{step}:dw/{k}": e for k, e in
                         rel_errors(change(g), change(w), 0.0).items()})
        stats = {k: v for k, v in w.items()
                 if k.startswith("gen/") and k.endswith((".mean", ".var"))}
        if stats:
            errs.update({f"{step}:{k}": e for k, e in
                         rel_errors({k: g[k] for k in stats}, stats, 0.0).items()})
        for k, v in w["logs"].items():
            errs[f"{step}:log/{k}"] = (abs(float(g["logs"][k]) - float(v))
                                       / max(abs(float(v)), 1e-30))
    return errs


def load_window(st: State, device) -> tuple[dict, list, int]:
    """Rank 0's snapshots, the window's first two global batches (NCHW on
    ``device``) as the plain loader decodes them from the PNGs, and the
    count of their rows in which the ranks' rows differ from them."""
    from benchmarks.reference.spade import data

    job = st.job
    snaps = {k: torch.load(st.work / f"{k}.pt", map_location="cpu")
             for k in ("before", "mid", "after")}
    want = data.batches(job["label_dir"], job["image_dir"], job["seed"], job["batch"],
                        int(job["model"]["crop_size"]), job["load_size"],
                        range(job["warm"], job["warm"] + 2))
    rows = [torch.load(st.work / f"rows{r}.pt") for r in range(job["ranks"])]
    mismatch = 0
    for i, pair in enumerate(want):
        for j, arr in enumerate(pair):
            got = torch.cat([r[i][j] for r in rows])
            ref = torch.from_numpy(arr)
            mismatch += (sum(not torch.equal(a, b) for a, b in zip(got, ref))
                         + abs(len(got) - len(ref)))
    nchw = lambda a: torch.from_numpy(a).to(device).permute(0, 3, 1, 2).contiguous()  # noqa: E731
    return snaps, [tuple(nchw(a) for a in pair) for pair in want], mismatch


def step_error(st: State, ctx) -> tuple[int, float, dict]:
    """The rows' mismatch, the worst of :func:`step_errors` of the program
    against the reference's :func:`reference_steps`, and notes."""
    from benchmarks.reference.spade import full_float32

    full_float32()
    t0 = time.perf_counter()
    snaps, batches, rows = load_window(st, ctx.device)
    period = st.job["period"]
    with_g = [(st.job["warm"] + i) % period == 0 for i in range(2)]
    want = reference_steps(snaps, batches, with_g, reference_config(ctx.cell.config["model"]),
                           ctx.device)
    errs = step_errors(want, snaps, snaps)
    ranked = sorted(errs, key=errs.get)
    logs = {f"{s}:{k}": float(v) for s, w in want.items() for k, v in w["logs"].items()}
    return rows, errs[ranked[-1]], {
        "step_worst": {k: errs[k] for k in ranked[-4:]},
        "step_worst_change": max((errs[k], k) for k in errs if ":dw/" in k),
        "step_median": errs[ranked[len(ranked) // 2]],
        "step_logs": logs, "reference_s": time.perf_counter() - t0}


# -- the ranks --------------------------------------------------------------------------

def snapshot(state, full: bool) -> dict:
    """Device copies of the program's training state, by the program's
    names: each net's weights and buffers (``gen/``, ``enc/``, ``d/``, and
    with ``full`` ``vgg/``), each optimizer's first moments (``g_mu/``,
    ``d_mu/``, named as the generator bundle names them, ``gen.``/``enc.``)
    and with ``full`` its second moments and step count."""
    out = {}
    nets = {"gen": state.gen, "enc": state.enc, "d": state.d}
    if full:
        nets["vgg"] = state.vgg
    for net, m in nets.items():
        if m is not None:
            out.update({f"{net}/{k}": v.detach().clone() for k, v in m.state_dict().items()})
    for net, m, opt in (("g", state.g, state.g_opt), ("d", state.d, state.d_opt)):
        names = [n for n, _ in m.named_parameters()]
        if net == "g" and state.enc is None:
            names = [f"gen.{n}" for n in names]
        out.update({f"{net}_mu/{n}": t.clone() for n, t in zip(names, opt.mu)})
        if full:
            out.update({f"{net}_nu/{n}": t.clone() for n, t in zip(names, opt.nu)})
            out[f"{net}_count"] = torch.tensor(opt.count)
    return out


def checksums(state) -> list[list[int]]:
    """Two int64 sums per tensor of the generator, encoder and discriminator
    (weights and buffers): of its elements' bits, and of them times their
    position (wrapping)."""
    rows = []
    for m in (state.g, state.d):
        for t in m.state_dict().values():
            bits = t.detach().contiguous().view(-1).view(torch.int32).to(torch.int64)
            pos = torch.arange(1, bits.numel() + 1, device=bits.device)
            rows.append(torch.stack([bits.sum(), (bits * pos).sum()]))
    return torch.stack(rows).cpu().tolist()


def tf32_control(device) -> None:
    """The control: matrix products and convolutions in TF32.  The CPU has
    no TF32, so there every convolution's and dense layer's input and
    weight are rounded to TF32's 10 mantissa bits (and their gradients)."""
    import torch.nn.functional as F

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        return

    class Round(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return tf32(x)

        @staticmethod
        def backward(ctx, g):
            return tf32(g)

    def tf32(x):
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    conv2d, linear = F.conv2d, F.linear
    F.conv2d = lambda x, w, *a, **k: conv2d(Round.apply(x), Round.apply(w), *a, **k)
    F.linear = lambda x, w, *a, **k: linear(Round.apply(x), Round.apply(w), *a, **k)


def wait_for_pairs(path: str, timeout_s: float) -> None:
    """Wait for the harness's word that the pairs are written."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no pairs after {timeout_s} s")
        time.sleep(0.01)
    ready = json.loads(Path(path).read_text())
    if "error" in ready:
        raise RuntimeError(f"the pairs were not made: {ready['error']}")


def rank_main(job_path: str) -> int:
    t_start = time.perf_counter()
    job = json.loads(Path(job_path).read_text())
    from surfelmapping_tpu_torch.models.data import PairedRenderDataset, Prefetched
    from surfelmapping_tpu_torch.models.pix2pix import SpadeTrainer
    from surfelmapping_tpu_torch.parallel import distributed
    from surfelmapping_tpu_torch.spade_train import train_iteration

    comm = distributed.initialize(timeout_s=job["timeout_s"])
    try:
        if job["device"] == "cuda":
            dev = torch.device("cuda", comm.rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device("cpu")
        cfg = program_config(job["model"])
        trainer = SpadeTrainer(cfg, device=dev, comm=comm)
        if job["control"]:
            tf32_control(dev)
        state = trainer.init_state(seed=job["seed"])
        t_init = time.perf_counter()
        wait_for_pairs(job["pairs"], job["timeout_s"])
        t_pairs = time.perf_counter()
        ds = PairedRenderDataset(job["label_dir"], job["image_dir"], crop_size=cfg.crop_size,
                                 load_size=job["load_size"], seed=job["seed"])
        batches = Prefetched(ds.batches(job["batch"], 1 << 40,
                                        distributed.rank_rows(comm, job["batch"])),
                             pin=dev.type == "cuda")
        with batches:
            res = train_window(job, comm, dev, trainer, state, batches, train_iteration)
        res.update(t_start=t_start, init_s=t_init - t_start, pairs_wait_s=t_pairs - t_init)
        Path(job["out"], f"rank{comm.rank}.json").write_text(json.dumps(res))
    finally:
        distributed.shutdown()
    return 0


def train_window(job, comm, dev, trainer, state, batches, train_iteration) -> dict:
    """Warm-up, window and what the check needs, on one rank."""
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    lead = comm.rank == 0
    period = job["period"]
    t_warm = time.perf_counter()
    it = 0
    for _ in range(job["warm"]):
        state, _, _ = train_iteration(trainer, state, batches, it, it % period == 0)
        it += 1
    sync()
    comm.barrier()
    t_warm_end = time.perf_counter()
    train_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    out = Path(job["out"])
    rngs = {"g_rng": trainer.g_rng.get_state(), "d_rng": trainer.d_rng.get_state()}
    tracer = None
    if job["trace"] and lead:
        tracer = harness.Tracer(job["trace_iterations"])
    flag = torch.zeros(1, device=dev if comm.backend == "nccl" else "cpu")
    nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
    kept, period_s = [], []
    snaps = {"before": snapshot(state, full=True)} if lead else {}
    gc.collect()
    gc.freeze()  # what lives now is left out of the collector's passes in the window
    comm.barrier()
    t0 = time.perf_counter()
    first = it

    def one_period() -> bool:
        nonlocal state, it
        t = time.perf_counter()
        for _ in range(period):
            state, batch, logs = train_iteration(trainer, state, batches, it, it % period == 0)
            if it - first < 2:
                kept.append(batch)
            if lead and it - first < 2:  # after the window's first iteration, then its second
                snap = snapshot(state, full=it == first)
                snap["logs"] = {k: torch.as_tensor(v).detach().clone() for k, v in logs.items()}
                snaps["mid" if it == first else "after"] = snap
            vals = torch.stack([torch.as_tensor(v, dtype=torch.float32).to(dev).reshape(())
                                for v in logs.values()])
            nonfinite.add_(torch.count_nonzero(~torch.isfinite(vals)))
            it += 1
        stop = 0.0
        if lead:
            sync()
            period_s.append(time.perf_counter() - t)
            stop = float(time.perf_counter() - t0 >= job["seconds"] and it - first >= 2
                         and (tracer is None or tracer.done))
        flag.fill_(stop)
        return bool(comm.all_reduce(flag, "max").item())

    done = False
    while not done:
        if (tracer is not None and not tracer.done
                and (it - first) // period >= job["trace_from_period"]):
            with tracer.stretch():
                for _ in range(job["trace_iterations"] // period):
                    one_period()
            continue
        done = one_period()
    t_end = time.perf_counter()
    gc.unfreeze()
    res = {"rank": comm.rank, "t_window": t0, "t_end": t_end, "t_warm_end": t_warm_end,
           "iterations": it - first, "period_s": period_s, "warm_s": t_warm_end - t_warm,
           "nonfinite": int(nonfinite), "checksums": checksums(state),
           "train_peak_bytes": train_peak,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else 0)}
    torch.save([[t.clone() for t in b] for b in kept], out / f"rows{comm.rank}.pt")
    if lead:
        snaps["before"].update(rngs)
        for name, snap in snaps.items():
            torch.save({k: v.cpu() if torch.is_tensor(v) else v for k, v in snap.items()},
                       out / f"{name}.pt")
        if tracer is not None and tracer.records is not None:
            rec = dict(tracer.records, spans=span_sums(job["trace_iterations"]))
            (out / "records.json").write_text(json.dumps(rec))
    return res


def span_sums(items: int) -> dict | None:
    """The traced stretch's program spans per iteration: ``spade.iter``
    less its waits (host ms), and the ``spade.data`` waits (ms)."""
    from benchmarks.spans import last_roots, wait_ns

    roots = last_roots("spade.iter", items)
    if roots is None:
        return None
    host = sum(root.end_ns - root.start_ns - wait_ns(inside) for root, inside in roots)
    data = sum(r.end_ns - r.start_ns for _, inside in roots for r in inside
               if r.name == "spade.data")
    return {"host_ms_per_iter": host / 1e6 / items, "data_ms_per_iter": data / 1e6 / items}


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1]))
