"""Port parity, SPADE data-parallel training: the batch norm across ranks,
the D and G steps over two ranks, ``spade_train --devices`` and the
launcher's kill on a failed rank, with ranks as real gloo CPU processes
(surfelmapping_tpu_torch/tools/spade_dp_jobs.py, launched by the port's own
launcher with a timeout that kills every rank).

The contract is the JAX CLI's sharded jit: split over D ranks, a step
equals the single-device step on the global batch (tests/test_spade.py's
``test_data_parallel_sharded_jit_matches_single_device`` holds the JAX
side).  So two ranks, each with 2 rows of a global batch of 4, are held
against the port's one-process step on the 4 rows, in the plain
configuration (VGG19 on) and the VAE one (VGG19 off); the VAE
configuration, given the JAX package's noise for the global batch, also
against the JAX package's single-device ``d_step`` then ``g_step`` (its
VGG19 is held to JAX in tests/test_torch_spade_train.py).  The JAX sharded
jit itself (a subprocess over two virtual devices) is not run here: its
compile alone would take most of this file's time budget.  Sizes and float64 tolerances are
tests/test_torch_spade_train.py's: ngf 8, ndf 8, crop 64, two
discriminator scales of 2 layers.  The norm across ranks is held to 1e-12
of each array's largest magnitude, and every rank's trained state to rank
0's bit for bit.
"""

import json
import time
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flax import serialization

from surfelmapping_tpu.models.pix2pix import SpadeTrainer as JaxTrainer
from surfelmapping_tpu.models.pix2pix import TrainState
from surfelmapping_tpu_torch import spade_train as port_cli
from surfelmapping_tpu_torch.models import checkpoint
from surfelmapping_tpu_torch.models.data import PairedRenderDataset
from surfelmapping_tpu_torch.models.pix2pix import SpadeConfig, SpadeTrainer, init_state_numpy
from surfelmapping_tpu_torch.parallel import distributed
from surfelmapping_tpu_torch.parallel.distributed import (Comm, python_module, shard_rows,
                                                          spawn_cpu_processes)
from surfelmapping_tpu_torch.tools import spade_dp_jobs
from surfelmapping_tpu_torch.tools.compare import flat, grad_gaps, grad_scales
from test_torch_spade_train import (SMALL, Z_DIM, _cli_files, _configs, _f64, _state_tree,
                                    _write_pairs)

JOBS = "surfelmapping_tpu_torch.tools.spade_dp_jobs"
TIMEOUT = 240.0  # seconds for any one job, every rank killed after it
RANKS, BATCH = 2, 4


@pytest.fixture(autouse=True)
def _one_thread():
    """This process's torch work on one thread: the references here are
    small, and the rank jobs and the suite's other workers share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_job(job: str, out, *args: str) -> list:
    return spawn_cpu_processes(python_module(JOBS, job, "--out", str(out), "--device", "cpu",
                                             *args), RANKS, timeout=TIMEOUT)


def in_background(fn, *args):
    """``fn(*args)`` on a thread of its own (a rank job, or a CLI that
    launches one, waits on its processes while this process computes the
    reference); ``.result()`` waits for it and raises what it raised."""
    pool = ThreadPoolExecutor(1)
    future = pool.submit(fn, *args)
    pool.shutdown(wait=False)
    return future


def _jax_state(tree: dict, jt: JaxTrainer) -> TrainState:
    """The JAX package's TrainState holding the flax-layout ``tree``, each
    optimizer's state restored onto optax's own structure for the tree's
    parameters (tests/test_torch_spade_train.py restores the whole tree onto
    flax's init structure; this skips that init's trace)."""
    opt = {n: serialization.from_state_dict(tx.init(tree[f"{n}_params"]), tree[f"{n}_opt"])
           for n, tx in (("g", jt.g_tx), ("d", jt.d_tx))}
    return TrainState(**{k: tree[k] for k in ("g_params", "g_batch_stats", "d_params",
                                              "d_batch_stats", "vgg_params", "step")},
                      g_opt=opt["g"], d_opt=opt["d"])


def _close(got, want, rel, where=""):
    """|got - want| <= rel * max|want|, array for array."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, where
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * float(np.abs(want).max()) or err == 0.0, (where, err)


# -- the batch norm across ranks -------------------------------------------------

def test_sync_batch_norm_matches_one_process(tmp_path):
    """Each rank's output rows and input gradient, the sum over the ranks of
    the parameter gradients, and every rank's running statistics, against
    one process's SPADE norm on the global batch."""
    run_job("norm", tmp_path)
    v, batch = spade_dp_jobs.norm_case()
    want = spade_dp_jobs.norm_run(None, v, batch, "cpu")
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(RANKS)]
    for k in ("out", "x_grad"):
        _close(np.concatenate([r[k] for r in ranks]), want[k], 1e-12, k)
    for k in [k for k in want if k.startswith("grad/")]:
        _close(sum(r[k] for r in ranks), want[k], 1e-12, k)
    for r in ranks:
        for k in ("mean", "var"):
            _close(r[k], want[k], 1e-12, k)
    moved = np.abs(ranks[0]["mean"] - v["batch_stats"]["BatchNorm_0"]["mean"]).max()
    assert moved > 1e-3  # the statistics did move


def test_sync_batch_norm_at_one_rank_is_the_local_form(tmp_path):
    """A group of one rank computes what no group computes, bit for bit;
    shard_rows gives rank r its contiguous rows and refuses a batch that
    does not split."""
    comm = distributed.initialize(backend="gloo", init_method=f"file://{tmp_path}/rendezvous",
                                  rank=0, world_size=1)
    try:
        assert comm.size == 1
        v, batch = spade_dp_jobs.norm_case()
        got = spade_dp_jobs.norm_run(comm, v, batch, "cpu")
        want = spade_dp_jobs.norm_run(None, v, batch, "cpu")
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    finally:
        distributed.shutdown()
    a = np.arange(12).reshape(6, 2)
    two = types.SimpleNamespace(size=2, rank=1)
    np.testing.assert_array_equal(shard_rows(two, a)[0], a[3:])
    np.testing.assert_array_equal(shard_rows(Comm(None), a)[0], a)
    with pytest.raises(ValueError, match="does not split"):
        shard_rows(types.SimpleNamespace(size=4, rank=0), a)


# -- the steps --------------------------------------------------------------------

STEP_TOLERANCES = dict(loss=1e-7, grad=1e-6, stats=1e-7)  # test_torch_spade_train's float64


def _held(got: dict, want: dict, got_logs: dict, want_logs: dict) -> None:
    """A D step then a G step of one run held to another's, in float64: the
    losses, each net's gradient (Adam's mu after its step: b1 = 0), its
    parameters (within 1e-6 * lr where the gradient is at least 1e-3 of its
    leaf's scale, within 2 * lr, a flipped sign, elsewhere), its stored SN
    and BN state, and the counts."""
    assert got_logs.keys() == want_logs.keys()
    for k in want_logs:
        np.testing.assert_allclose(got_logs[k], want_logs[k], rtol=STEP_TOLERANCES["loss"],
                                   err_msg=k)
    for net in ("d", "g"):
        opt_g, opt_w = got[f"{net}_opt"], want[f"{net}_opt"]
        gaps = grad_gaps(opt_g["inner_state"]["0"]["mu"], opt_w["inner_state"]["0"]["mu"])
        assert max(gaps.values()) <= STEP_TOLERANCES["grad"], max(gaps, key=gaps.get)
        assert int(opt_g["count"]) == int(opt_w["count"]) == 1
        lr = float(opt_w["hyperparams"]["learning_rate"])
        mu = flat(opt_w["inner_state"]["0"]["mu"])
        scales = grad_scales(mu)
        for k, p in flat(got[f"{net}_params"]).items():
            err = np.abs(p - flat(want[f"{net}_params"])[k])
            sure = np.abs(mu[k]) >= 1e-3 * scales[k]
            assert err[sure].max(initial=0) <= 1e-6 * lr and err.max() <= 2 * lr, k
        stats_g, stats_w = flat(got[f"{net}_batch_stats"]), flat(want[f"{net}_batch_stats"])
        assert stats_g.keys() == stats_w.keys()
        for k in stats_w:
            _close(stats_g[k], stats_w[k], STEP_TOLERANCES["stats"], k)
    assert int(got["step"]) == int(want["step"]) == 1


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Five label/image PNG pairs, larger than the crop."""
    root = tmp_path_factory.mktemp("pairs")
    return _write_pairs(root, np.random.default_rng(0), [(72, 80)] * 5)


def _global_batch(lab, img, cfg) -> tuple[np.ndarray, np.ndarray]:
    """The batch every rank draws first (the dataset at its default seed)."""
    ds = PairedRenderDataset(str(lab), str(img), crop_size=cfg.crop_size,
                             load_size=int(cfg.crop_size * 1.12))
    return next(ds.batches(BATCH, 1))


def _jax_noise(use_vae: bool) -> dict:
    """The VAE noise of the JAX package's d_step and g_step at step 0, drawn
    for the global batch (empty without a VAE)."""
    if not use_vae:
        return {}
    with jax.enable_x64(True):
        return {step: np.array(jax.random.normal(jax.random.fold_in(
            jax.random.PRNGKey(key), 0), (BATCH, Z_DIM), jnp.float64))
            for step, key in (("g_step", 0), ("d_step", 0 ^ 0x5EED))}


@pytest.mark.parametrize("use_vae", [False, True], ids=["plain", "vae"])
def test_two_rank_steps_match_one_process(use_vae, pairs, tmp_path):
    """One D step then one G step over two ranks in float64: every rank's
    state bit for bit rank 0's (the files, and the job's checksum
    all-reduced with MIN and MAX), one gradient all-reduce per step plus one
    per batch norm forward and backward in the G step, and rank 0's state
    and the global losses held to the port's one-process steps on the
    global batch.  The VAE configuration, with the JAX package's noise of
    the global batch (each rank takes its rows), is also held to the JAX
    package's single-device steps on it: its KLD is a sum over the batch,
    which a mean over the ranks' gradients would scale by 1/2."""
    cfg, jcfg = _configs(use_vae, use_vgg=not use_vae)
    lab, img = pairs
    noise = _jax_noise(use_vae)
    args = ["--label-dir", str(lab), "--image-dir", str(img), "--batch", str(BATCH),
            "--config", json.dumps(dict(SMALL, use_vae=use_vae, z_dim=Z_DIM,
                                        use_vgg=not use_vae)), "--dtype", "float64"]
    if use_vae:
        np.savez(tmp_path / "noise.npz", **noise)
        args += ["--noise", str(tmp_path / "noise.npz")]
    job = in_background(run_job, "steps", tmp_path, *args)  # XLA compiles on one core
    label, real = _global_batch(lab, img, cfg)
    if use_vae:
        jt = JaxTrainer(jcfg, seed=0)
        with jax.enable_x64(True):
            s = _jax_state(_f64(init_state_numpy(cfg)), jt)
            jlogs = {}
            for step in ("d_step", "g_step"):
                s, out = getattr(jt, step)(s, jnp.asarray(label, jnp.float64),
                                           jnp.asarray(real, jnp.float64))
                jlogs.update({k: float(v) for k, v in out.items()})
            jwant = _state_tree(s)
    job.result()
    tr = SpadeTrainer(cfg, device="cpu")
    st = tr.state_from_numpy(init_state_numpy(cfg)).to(torch.float64)
    logs = {}
    for step in ("d_step", "g_step"):
        z = noise.get(step)
        _, out = getattr(tr, step)(st, torch.from_numpy(label).double(),
                                   torch.from_numpy(real).double(),
                                   noise=None if z is None else torch.from_numpy(z))
        logs.update({k: float(v) for k, v in out.items()})
    want = tr.state_to_numpy(st)
    raw = [(tmp_path / f"rank{r}.msgpack").read_bytes() for r in range(RANKS)]
    res = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(RANKS)]
    assert raw[1] == raw[0] and all(r["ranks_identical"] for r in res)
    assert [r["rows"] for r in res] == [BATCH // RANKS] * RANKS
    assert res[0]["logs"] == res[1]["logs"]
    got = checkpoint.unpackb(raw[0])
    _held(got, want, res[0]["logs"], logs)
    if use_vae:
        _held(got, jwant, res[0]["logs"], jlogs)

    widths = spade_dp_jobs.norm_widths(st.gen)
    n_d = sum(p.numel() for p in st.d_opt.params)
    n_g = sum(p.numel() for p in st.g_opt.params)
    assert res[0]["collectives"] == {
        "d_step": {"calls": 1, "bytes": (n_d + 1) * 8},
        "g_step": {"calls": 2 * len(widths) + 1,
                   "bytes": (n_g + len(logs) - 1 + 4 * sum(widths)) * 8}}


def test_a_failing_rank_ends_the_job(pairs, tmp_path):
    """Rank 1 raises before its G step while rank 0 waits in that step's
    first collective: the launcher kills rank 0 and raises, long before its
    timeout."""
    lab, img = pairs
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"failed(.|\n)*rank 1 \(exit 1\)(.|\n)*as asked"):
        spawn_cpu_processes(python_module(
            JOBS, "steps", "--out", str(tmp_path), "--device", "cpu", "--label-dir", str(lab),
            "--image-dir", str(img), "--config", json.dumps(dict(SMALL, use_vgg=False)),
            "--fail-rank", "1"), RANKS, timeout=120)
    assert time.monotonic() - t0 < 60


# -- spade_train --devices ------------------------------------------------------------

def test_spade_train_devices_matches_the_jax_cli(pairs, tmp_path, monkeypatch):
    """``spade_train --devices 2 --device cpu --batch 4`` writes the files
    that the JAX CLI writes at --batch 4 on one device (the same log keys at
    the same iterations, iter.txt, opt.txt less the port's device, devices
    and timeout lines, the gallery's names), from the same state; then it
    resumes its own checkpoint with --continue-train and one more epoch of
    decay (epochs 2 and 3 rerun, the decay replayed)."""
    import spade_train as jax_cli

    cfg = SpadeConfig(**dict(SMALL, num_d=1, use_vgg=False))
    tree = init_state_numpy(cfg)
    monkeypatch.setattr(JaxTrainer, "init_state",
                        lambda self, lab, img: _jax_state(tree, self))
    lab, img = pairs
    argv = ["--label-dir", str(lab), "--image-dir", str(img), "--niter", "1",
            "--niter-decay", "1", "--steps-per-epoch", "2", "--batch", str(BATCH), "--crop",
            str(cfg.crop_size), "--ngf", "8", "--ndf", "8", "--num-d", "1", "--n-layers-d", "2",
            "--no-vgg", "--log-every", "1", "--display-every", "3"]
    port = ["--devices", str(RANKS), "--device", "cpu", "--timeout", str(TIMEOUT)]
    resume = argv[:]
    resume[resume.index("--niter-decay") + 1] = "2"
    ckpt = tmp_path / "port"
    first = {}

    def train_then_resume():
        assert port_cli.main(argv + port + ["--ckpt-dir", str(ckpt)]) == 0
        first.update(files=_cli_files(ckpt),
                     state=checkpoint.load_train_state(str(ckpt / "latest.msgpack")))
        assert port_cli.main(resume + port + ["--ckpt-dir", str(ckpt), "--continue-train"]) == 0

    port_runs = in_background(train_then_resume)
    assert jax_cli.main(argv + ["--ckpt-dir", str(tmp_path / "jax")]) == 0
    port_runs.result()
    want = _cli_files(tmp_path / "jax")
    assert first["files"] == want and want["iter"] == "2\n8\n"
    first = first["state"]
    assert int(first["g_opt"]["count"]) == 2 and int(first["d_opt"]["count"]) == 4
    assert (ckpt / "iter.txt").read_text() == "3\n8\n"
    resumed = checkpoint.load_train_state(str(ckpt / "latest.msgpack"))
    assert int(resumed["g_opt"]["count"]) == int(first["g_opt"]["count"]) + 2
    assert float(resumed["g_opt"]["hyperparams"]["learning_rate"]) == 0.0


def test_spade_train_devices_with_an_indivisible_batch_runs_alone(pairs, tmp_path, monkeypatch,
                                                                   capsys):
    """--batch 3 over --devices 2 prints the JAX CLI's message and trains in
    this process alone: no rank is launched."""
    def no_ranks(*a, **k):
        raise AssertionError("a rank was launched")

    monkeypatch.setattr(distributed, "spawn_ranks", no_ranks)
    monkeypatch.setattr(distributed, "spawn_cpu_processes", no_ranks)
    lab, img = pairs
    ckpt = tmp_path / "ckpt"
    assert port_cli.main(["--label-dir", str(lab), "--image-dir", str(img), "--niter", "1",
                          "--niter-decay", "0", "--steps-per-epoch", "1", "--batch", "3",
                          "--crop", "64", "--ngf", "8", "--ndf", "8", "--num-d", "1",
                          "--n-layers-d", "2", "--no-vgg", "--devices", "2", "--device", "cpu",
                          "--ckpt-dir", str(ckpt)]) == 0
    out = capsys.readouterr().out
    assert ("--batch 3 not divisible by 2 devices; running single-device (pad the batch to "
            "shard)") in out
    assert "ranks over" not in out
    assert (ckpt / "latest.msgpack").exists() and (ckpt / "iter.txt").read_text() == "1\n3\n"
