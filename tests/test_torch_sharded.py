"""Port parity, the sharded engine: parallel/sharded.py, parallel/distributed.py,
BA's cross-rank reduction and ``build_map --devices``, with ranks as real
gloo CPU processes (surfelmapping_tpu_torch/tools/sharded_jobs.py, launched
by the port's own launcher with a timeout that kills every rank).

The shard-for-shard comparison runs the JAX package's ``make_sharded_step``
on 4 virtual CPU devices in a process of its own
(tests/jax_sharded_reference.py), jitted and with ``--xla_cpu_max_isa=AVX``.
Jitted, XLA's CPU compiler contracts multiply-adds into FMAs on an FMA
machine, and at fuse_thresh_factor = 0 the merge and conflict gates are
exact-equality tests that a contraction flips (ROADMAP ground rules); an ISA
without FMA keeps every gate where the port's is.  Op by op (the port's
other parity tests) the shard_map took ~700 s on an 8-core CPU, so the
remaining difference of the jitted program, XLA's own lowering of division
and square roots, stays: positions and normals within 1 ulp-level bounds,
every other column, count and stat bit for bit.  Both packages start from
one state, dealt from a port map and carried by convert.sharded_*.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from surfelmapping_tpu_torch import build_map, convert
from surfelmapping_tpu_torch.config import MapConfig, PipelineParams
from surfelmapping_tpu_torch.io.synthetic import SyntheticScene, tiny_cam
from surfelmapping_tpu_torch.parallel.distributed import (Comm, python_module,
                                                          spawn_cpu_processes)
from surfelmapping_tpu_torch.parallel.sharded import ShardedMapper
from surfelmapping_tpu_torch.pipeline import SurfelMapper
from surfelmapping_tpu_torch.surfels import COLUMNS, load_map, pack_records
from surfelmapping_tpu_torch.tools import sharded_jobs

HERE = os.path.dirname(os.path.abspath(__file__))
JOBS = "surfelmapping_tpu_torch.tools.sharded_jobs"
TIMEOUT = 240.0  # seconds for any one job, every rank killed after it


def run_job(job: str, ranks: int, out, *args: str) -> list:
    return spawn_cpu_processes(python_module(JOBS, job, "--out", str(out), "--device", "cpu",
                                             *args), ranks, timeout=TIMEOUT)


def shared_fraction(got: np.ndarray, want: np.ndarray) -> float:
    """The share of ``want``'s records (rows of 12 float32 words) that
    ``got`` holds bit for bit, as multisets."""
    from collections import Counter

    a = Counter(map(bytes, np.ascontiguousarray(got, np.float32)))
    b = Counter(map(bytes, np.ascontiguousarray(want, np.float32)))
    return sum((a & b).values()) / max(sum(b.values()), 1)


# The sharded engine resolves a depth-key tie to the smallest GLOBAL id
# (rank * S + slot), the single card to the smallest slot: the same rule on
# other numbers.  Where two surfels of one pixel have the same depth (the
# synthetic scene's planes make such ties), the frame merges into the other
# one, and both records differ.  Likewise surfel 0's quirks (unmatchable,
# exempt from conflict) fall on rank 0's slot 0, which after a per-shard
# compaction can be another surfel than the single card's slot 0.  The JAX
# package's own test holds 99% of its surfel positions
# (tests/test_sharded.py:154-158); these hold 99% of the records bit for bit.
# Over a long run with removals the count can drift by a few with the rank
# count (20 frames of the long run: 2441, 2442 and 2445 surfels at 2, 4 and
# 8 ranks, 2445 on one card); the 8-rank run of the JAX test meets it.  That
# the slot order is the whole cause is held frame by frame below
# (test_sharded_mapper_frames_equal_the_single_card_step_in_rank_order).
SET_SHARE = 0.99


# -- the state both packages start from ---------------------------------------

D, CAP = 4, 1 << 14


def test_sharded_state_roundtrip_through_convert(tmp_path):
    """convert.sharded_from_numpy / sharded_to_numpy carry a JAX
    ShardedMapState's columns (split by device) into the ranks' shards and
    back, bit for bit."""
    counts, n = sharded_jobs.dealt_state(tmp_path / "s.npz", D, CAP, 0.05, frames=2)
    z = np.load(tmp_path / "s.npz")
    cols = {k: z[k] for k in COLUMNS}
    states = convert.sharded_from_numpy(cols, counts, "cpu")
    assert [s.rank for s in states] == list(range(D)) and states[0].world == D
    assert [int(s.smap.count) for s in states] == counts.tolist() and counts.sum() == n > 0
    assert convert.sharded_from_numpy(cols, counts, "cpu", rank=2).smap.count == counts[2]
    back, back_counts = convert.sharded_to_numpy(states)
    np.testing.assert_array_equal(back_counts, counts)
    for k in COLUMNS:
        np.testing.assert_array_equal(back[k].view(np.int32), cols[k].view(np.int32), err_msg=k)


# -- (i) the step, shard for shard against the JAX package -------------------

FLOAT_BOUNDS = {"px": 1e-6, "py": 1e-6, "pz": 1e-6, "nx": 1e-7, "ny": 1e-7, "nz": 1e-7,
                "radius": 1e-7}


@pytest.mark.parametrize("fuse_thresh", [0.05, 0.0])
def test_sharded_step_matches_jax_shard_for_shard(fuse_thresh, tmp_path):
    # the one state both packages read, carried through the port's shards
    state = tmp_path / "state.npz"
    sharded_jobs.dealt_state(state, D, CAP, fuse_thresh)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 --xla_cpu_max_isa=AVX")
    jax_out = tmp_path / "jax.npz"
    ref = subprocess.Popen([sys.executable, os.path.join(HERE, "jax_sharded_reference.py"),
                            str(state), str(jax_out)], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    try:
        run_job("step", D, tmp_path / "port", "--state", str(state))
        log, _ = ref.communicate(timeout=TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-3000:]
    want = np.load(jax_out)
    got = [np.load(tmp_path / "port" / f"rank{r}.npz") for r in range(D)]
    S = CAP // D
    np.testing.assert_array_equal([int(g["count"]) for g in got], want["counts"])
    for r, g in enumerate(got):
        # per-frame removed, merged, dropped, new, count and live per shard
        st = g["stats"]
        port_rows = np.concatenate([st[:, :3], st[:, -1:], st[:, 3 + 2 * D:3 + 3 * D]
                                    .sum(1, keepdims=True), st[:, 3 + 2 * D:3 + 3 * D]], 1)
        np.testing.assert_array_equal(port_rows, want["stats"], err_msg=f"rank {r} stats")
        n = int(g["count"])
        for k in COLUMNS:
            a, b = g[k][:n], want[k][r * S:r * S + n]
            if k in FLOAT_BOUNDS:
                np.testing.assert_allclose(a, b, rtol=FLOAT_BOUNDS[k], atol=FLOAT_BOUNDS[k],
                                           err_msg=f"rank {r} {k}")
            else:
                np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                              err_msg=f"rank {r} {k}")
    np.testing.assert_array_equal(got[0]["last_depth"], want["last_depth"])
    assert want["stats"][:, 1].sum() > 0 and want["stats"][:, 3].sum() > 0  # merges, news
    if fuse_thresh == 0.0:
        assert want["stats"][:, 0].sum() > 0  # conflict removals at the reference default


# -- (ii) ShardedMapper against the single-card mapper -------------------------

def test_sharded_mapper_long_run_matches_the_single_card(tmp_path):
    """tests/test_sharded.py:111-158 on the port: 8 ranks, 20 frames of
    removals (fuse_thresh 0), a capacity that must grow, deferred
    compaction; against the single-card SurfelMapper: the same count, no
    surfel dropped, and the same surfel set but for depth ties (SET_SHARE)."""
    run_job("mapper", 8, tmp_path, "--frames", "20", "--capacity", str(1 << 13),
            "--active-blocks", "8", "--block-size", "128", "--sync-every", "4",
            "--compact-dead-frac", "0.2", "--scene-step", "0.6")
    got = np.load(tmp_path / "mapper.npz")
    cam = tiny_cam(128, 64)
    single = SurfelMapper(cam, PipelineParams(stereo_border=0.0), MapConfig(capacity=1 << 16),
                          sync_every=4, device="cpu")
    scene = SyntheticScene(cam, step=0.6)
    for i in range(20):
        single.process_frame(*scene.frame(i))
    assert int(got["count"]) == single.count > 0
    assert int(got["capacity"]) > 1 << 13, "growth never triggered — weak test"
    assert int(got["dropped"]) == 0
    want = pack_records(single.smap)[:single.count].numpy()
    assert shared_fraction(got["records"], want) >= SET_SHARE


LONG_RUN = ("--frames", "20", "--capacity", str(1 << 13), "--active-blocks", "8",
            "--block-size", "128", "--sync-every", "4", "--compact-dead-frac", "0.2",
            "--scene-step", "0.6")


@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_mapper_frames_equal_the_single_card_step_in_rank_order(ranks, tmp_path):
    """Where the long run's count drifts from the single card's (2441 and
    2442 surfels at 2 and 4 ranks, 2445 on one card), the order of the
    slots is the whole cause: after each frame of the long run (here with
    growth, replays and compactions), the single card's fusion step, run
    on every shard's prefix concatenated in rank order (the global-id
    order, tombstones kept), gives the sharded engine's next map, record
    for record (bit for bit, as multisets of the live records)."""
    from surfelmapping_tpu_torch.pipeline import _fusion_step, stage_frame

    # a smaller budget and a compaction at each sync that finds tombstones
    run_job("mapper", ranks, tmp_path, *LONG_RUN, "--active-blocks", "2",
            "--compact-dead-frac", "0.0", "--dump-frames")
    got = np.load(tmp_path / "mapper.npz")
    assert int(got["capacity"]) > 1 << 13
    assert int(got["event_replays"]) > 0 and int(got["event_compacts"]) > 0
    cam, params, B = tiny_cam(128, 64), PipelineParams(stereo_border=0.0), 128
    scene = SyntheticScene(cam, step=0.6)

    def live(smap):
        n = int(smap.count)
        rows = pack_records(smap)[:n].numpy()[smap.column("conf")[:n].numpy() > 0]
        return rows.view(np.int32)

    def loaded(t, spare):
        z = np.load(tmp_path / f"frame{t}.npz")
        n = len(z["px"])
        cap = -(-(n + spare) // B) * B
        cols = {k: np.concatenate([z[k], np.zeros(cap - n, z[k].dtype)]) for k in COLUMNS}
        return convert.map_from_numpy(cols, n, "cpu"), z

    for t in range(19):
        m, z = loaded(t, (cam.height * cam.width) // 2 + 1)
        rgb, depth, sem, pose = stage_frame(torch.device("cpu"), *scene.frame(t + 1))
        m, _, dropped, _ = _fusion_step(m, depth, rgb, sem, pose,
                                        torch.from_numpy(z["last_depth"]),
                                        torch.from_numpy(z["last_pose"]), float(z["tick"]),
                                        cam, params, m.capacity // B, B)
        want, _ = loaded(t + 1, 1)
        a, b = live(m), live(want)
        assert int(dropped) == 0 and a.shape == b.shape, f"frame {t + 1}"
        np.testing.assert_array_equal(a[np.lexsort(a.T[::-1])], b[np.lexsort(b.T[::-1])],
                                      err_msg=f"frame {t + 1}")
    assert len(a) == int(got["count"]) > 0


def test_one_rank_mapper_equals_the_single_card_in_order():
    """A one-rank ShardedMapper (no process group) writes the single-card
    mapper's records in the single-card order, bit for bit, through growth
    and a compaction at every sync that finds tombstones."""
    cam = tiny_cam(128, 64)
    params = PipelineParams(stereo_border=0.0)
    sm = ShardedMapper(Comm(None), cam, params, capacity=1 << 12, active_blocks=4,
                       block_size=128, sync_every=3, compact_dead_frac=0.0, device="cpu")
    single = SurfelMapper(cam, params, MapConfig(capacity=1 << 14), sync_every=3,
                          device="cpu")
    scene = SyntheticScene(cam, step=0.5)
    for i in range(7):
        sm.process_frame(*scene.frame(i))
        single.process_frame(*scene.frame(i))
    assert sm.count == single.count > 0
    assert sm.events["compacts"] > 0 and sm.events["capacity_growths"] > 0
    got = pack_records(sm.smap()).numpy()
    want = pack_records(single.smap)[:single.count].numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# -- (iii) the budget replay ---------------------------------------------------

def test_sharded_mapper_budget_overflow_replay(tmp_path):
    """tests/test_sharded.py:161-199 on the port: a one-block budget repairs
    by window replay and ends bit-identical, shard for shard, to a 64-block
    run."""
    run_job("replay", 4, tmp_path, "--budgets", "1", "64")
    for r in range(4):
        z = np.load(tmp_path / f"rank{r}.npz")
        assert int(z["b1_active_blocks"]) > 1, "budget never grew — repair did not fire"
        assert int(z["b1_live"]) == int(z["b64_live"]) > 0
        n = int(z["b1_count"])
        assert n == int(z["b64_count"])
        for k in COLUMNS:
            np.testing.assert_array_equal(z[f"b1_{k}"][:n].view(np.int32),
                                          z[f"b64_{k}"][:n].view(np.int32), err_msg=k)


# -- (iv) BA's cross-rank reduction ---------------------------------------------

def test_ba_cross_rank_reduction_matches_the_single_rank(tmp_path):
    """tests/test_ba.py:135-203 on the port: the window's pixels dealt over
    4 ranks, the per-frame systems all-reduced, give the single-rank
    refinement within the JAX test's rtol 1e-4, atol 1e-5 (the sums run in
    another order); every rank solves the same all-reduced system, so the
    ranks agree bit for bit, and the inlier counts partition exactly."""
    run_job("ba", 4, tmp_path, "--frames", "16")
    z = [np.load(tmp_path / f"rank{r}.npz") for r in range(4)]
    for r in range(1, 4):
        np.testing.assert_array_equal(z[r]["poses"], z[0]["poses"])
    np.testing.assert_allclose(z[0]["poses"], z[0]["ref_poses"], rtol=1e-4, atol=1e-5)
    assert int(z[0]["inliers"]) == int(z[0]["ref_inliers"]) > 0


# -- (v) the distributed job ---------------------------------------------------

def test_distributed_job_all_reduces_fuses_and_checkpoints(tmp_path):
    results = run_job("distributed", 2, tmp_path)
    counts = [int(r.stdout.split("OK count=")[1]) for r in results]
    assert counts[0] == counts[1] > 0
    loaded, _, _ = load_map(str(tmp_path / "map.bin"), "cpu")
    assert int(loaded.count) == counts[0]


def test_sharded_dryrun_two_ranks():
    """The dry run's command line (dryrun() behind it) in two gloo CPU ranks."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    out = subprocess.run([sys.executable, "-m", "surfelmapping_tpu_torch.parallel.sharded",
                          "--ranks", "2", "--device", "cpu", "--timeout", str(TIMEOUT)],
                         cwd=os.path.dirname(HERE), env=env, capture_output=True, text=True,
                         timeout=TIMEOUT + 30)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "dryrun: 2 ranks ok" in out.stdout


def test_launcher_kills_every_rank_when_one_fails():
    code = ("import os, sys, time\n"
            "sys.exit(3) if os.environ['RANK'] == '1' else time.sleep(120)\n")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"failed(.|\n)*rank 1 \(exit 3\)"):
        spawn_cpu_processes([sys.executable, "-c", code], 3, timeout=100)
    assert time.monotonic() - t0 < 60


def test_launcher_timeout_kills_every_rank():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out"):
        spawn_cpu_processes([sys.executable, "-c", "import time; time.sleep(120)"], 2,
                            timeout=2)
    assert time.monotonic() - t0 < 60


# -- (vi) build_map --devices ---------------------------------------------------

@pytest.mark.parametrize("clean", [False, True], ids=["plain", "clean"])
def test_build_map_devices_matches_the_single_card(clean, tmp_path, capsys):
    args = ["--synthetic", "4", "--synthetic-cam", "small", "--device", "cpu",
            "--capacity", str(1 << 16)] + (["--clean"] if clean else [])
    assert build_map.main(args + ["--out", str(tmp_path / "one.bin")]) == 0
    assert build_map.main(args + ["--devices", "2", "--timeout", str(TIMEOUT),
                                  "--out", str(tmp_path / "two.bin")]) == 0
    out = capsys.readouterr().out
    assert "2 ranks" in out and ("after clean" in out) == clean
    one, _, _ = load_map(str(tmp_path / "one.bin"), "cpu")
    two, _, _ = load_map(str(tmp_path / "two.bin"), "cpu")
    assert int(one.count) == int(two.count) > 0
    assert shared_fraction(pack_records(two).numpy(), pack_records(one).numpy()) >= SET_SHARE


def test_build_map_devices_tracks_on_rank_0_and_broadcasts(tmp_path, capsys):
    """--icp --ba on two ranks: rank 0 refines against the gathered active
    table and every rank fuses its broadcast pose (a rank that fused another
    pose would deadlock or diverge the shards' collectives)."""
    out = tmp_path / "m.bin"
    assert build_map.main(["--synthetic", "4", "--synthetic-cam", "small", "--device", "cpu",
                           "--capacity", str(1 << 16), "--icp", "--ba", "--pose-noise", "0.02",
                           "--devices", "2", "--timeout", str(TIMEOUT), "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    ate = [ln for ln in lines if ln.startswith("ATE (rmse vs input gt): ")]
    assert len(ate) == 1 and 0.0 < float(ate[0].split()[5]) < 0.1
    assert int(load_map(str(out), "cpu")[0].count) > 0


def test_build_map_devices_needs_the_cards_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.device_count() >= 2:
        pytest.skip("two or more CUDA cards are present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        build_map.main(["--synthetic", "2", "--synthetic-cam", "small", "--devices", "2",
                        "--out", str(tmp_path / "m.bin")])
    assert not (tmp_path / "m.bin").exists()


# -- JAX-side faults the port leaves out ---------------------------------------

def test_read_pending_on_an_empty_window():
    """surfelmapping_tpu's ShardedMapper._read_pending raises IndexError on
    an empty window (parallel/sharded.py:469-487); the port's returns an
    empty (0, 2 + 2D) array."""
    import jax
    from jax.sharding import Mesh

    from surfelmapping_tpu.parallel.sharded import AXIS
    from surfelmapping_tpu.parallel.sharded import ShardedMapper as JShardedMapper

    jsm = JShardedMapper(Mesh(np.array(jax.devices()[:2]), (AXIS,)), tiny_cam(128, 64),
                         capacity=1 << 12, block_size=128)
    with pytest.raises(IndexError):
        jsm._read_pending()
    sm = ShardedMapper(Comm(None), tiny_cam(128, 64), capacity=1 << 12, block_size=128,
                       device="cpu")
    assert sm._read_pending().shape == (0, 4)
    assert sm.count == 0


class _Viewer:
    """The viewer's interface to the loop, recording the capacity bar."""

    quit = want_save = want_clean = want_reset = want_novel = False
    show_local = False

    def __init__(self):
        self.bars = []

    def map_view_pose(self, pose):
        return pose

    def update(self, *args, capacity_used, capacity_total, **kw):
        self.bars.append((capacity_used, capacity_total))

    def wait_if_paused(self):
        pass


def test_sharded_viewer_capacity_bar_reads_the_true_cursors():
    """The JAX loop's capacity bar reads the sharded mapper's worst-case
    cursor estimate (build_map.py:252-254); the port's reads the cursors
    that the render cadence's gather synced."""
    cam = tiny_cam(128, 64)
    sm = ShardedMapper(Comm(None), cam, PipelineParams(stereo_border=0.0), capacity=1 << 14,
                       block_size=128, sync_every=8, device="cpu")
    gui, scene, history = _Viewer(), SyntheticScene(cam), []
    for i in range(4):
        frame = scene.frame(i)
        sm.process_frame(*frame)
        history.append((i, frame[1], frame[2], frame[3]))
        build_map.gui_step_sharded(gui, sm, history, (i, *frame), 2, 0)
    used, total = gui.bars[-1]
    assert used == int(sm.state.smap.count) > 0 and total == sm.capacity
    worst_case = 3 * ((cam.height * cam.width) // 2 + 1)  # the JAX loop's estimate
    assert used < worst_case
    # rank 0's keys act on every rank: r resets the map, q ends the loop
    gui.want_reset = gui.quit = True
    _, stop = build_map.gui_step_sharded(gui, sm, history, (3, *frame), 2, 0)
    assert stop and sm.count == 0 and not gui.want_reset


def test_sharded_viewer_on_rank_0_leaves_the_ranks_in_step(tmp_path):
    """build_map's sharded viewer step with the viewer (snapshots) on rank 0
    only, over two gloo ranks, at the long run's settings with a one-block
    budget: it replays, grows and compacts, and ends with every shard bit
    for bit as in the same loop with no viewer on any rank.  A sync that
    rank 0 alone made (a count read for the status line) would split the
    ranks' windows: a replay's collectives would pair with another frame's,
    growth would move the ranks' global ids apart, or the job would hang."""
    run_job("viewer", 2, tmp_path, "--frames", "12", "--capacity", str(1 << 13),
            "--active-blocks", "1", "--block-size", "128", "--sync-every", "4",
            "--compact-dead-frac", "0.0", "--scene-step", "0.6")
    assert len(list((tmp_path / "snapshots").glob("*.png"))) > 0
    for r in range(2):
        z = np.load(tmp_path / f"rank{r}.npz")
        assert int(z["viewer_event_replays"]) > 0, "no replay fired — weak test"
        assert int(z["viewer_event_capacity_growths"]) > 0
        assert int(z["viewer_event_compacts"]) > 0
        for k in z.files:
            if k.startswith("viewer_"):
                want = z["none_" + k[len("viewer_"):]]
                np.testing.assert_array_equal(z[k].view(np.int32) if z[k].dtype == np.float32
                                              else z[k], want.view(np.int32)
                                              if want.dtype == np.float32 else want,
                                              err_msg=f"rank {r} {k}")
        assert int(z["viewer_live"]) > 0
