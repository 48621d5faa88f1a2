"""Port parity, the small host modules and the viewer: the local surfel model
(``ops/local_model.py``, ``SurfelMapper.local_model``), ``map_from_stacked``,
the stopwatch's tick/tock, ``utils/checker``, ``utils/tracing``, ``gui``
and its loop in ``build_map``, and the end-to-end chain tool
(``tools/run_e2e``) on the CPU.

Everything the JAX package also computes is compared on the same numpy-seeded
inputs and must be exact: the local model bit for bit (its JAX side runs
with jit disabled, as the mapper tests do), the checker's strings and problem
lists character for character, the viewer's images and camera exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image

from surfelmapping_tpu import gui as jgui
from surfelmapping_tpu import surfels as jsurfels
from surfelmapping_tpu.config import MapConfig as JMapConfig
from surfelmapping_tpu.config import PipelineParams as JParams
from surfelmapping_tpu.io.synthetic import tiny_cam as jtiny_cam
from surfelmapping_tpu.ops.frame_surfels import association_candidates as jcandidates
from surfelmapping_tpu.ops.preprocess import metricize_depth as jmetricize
from surfelmapping_tpu.ops.transforms import transform_planar as jtransform_planar
from surfelmapping_tpu.pipeline import SurfelMapper as JMapper
from surfelmapping_tpu.utils import checker as jchecker
from surfelmapping_tpu.utils.stopwatch import Stopwatch as JStopwatch
from surfelmapping_tpu_torch import build_map, convert, gui, surfels
from surfelmapping_tpu_torch.config import MapConfig, PipelineParams
from surfelmapping_tpu_torch.io.kitti import write_kitti_dir
from surfelmapping_tpu_torch.io.synthetic import SyntheticScene, tiny_cam
from surfelmapping_tpu_torch.pipeline import SurfelMapper
from surfelmapping_tpu_torch.surfels import COLUMNS
from surfelmapping_tpu_torch.tools import run_e2e
from surfelmapping_tpu_torch.utils import checker, tracing
from surfelmapping_tpu_torch.utils.stopwatch import Stopwatch

F32_COLS = [k for k in COLUMNS if k != "colorsem"]


@jax.disable_jit()
def test_local_model_matches_jax_in_lattice_order():
    """SurfelMapper.local_model after one frame (tick 1), bit for bit
    against the JAX mapper's, and in the reference's uv column-major
    lattice order (tests/test_fusion.py:206): the valid candidates of an
    independent numpy reordering, u outer, v inner."""
    scene = SyntheticScene(tiny_cam())
    jm = JMapper(jtiny_cam(), JParams(), JMapConfig(capacity=1 << 16))
    m = SurfelMapper(tiny_cam(), PipelineParams(), MapConfig(capacity=1 << 16), device="cpu")
    m.process_frame(*scene.frame(0))
    jm.process_frame(*scene.frame(0))
    rgb, d, s, T = scene.frame(1)
    lm, jlm = m.local_model(rgb, d, s, T), jm.local_model(rgb, d, s, T)
    n = int(lm.count)
    assert n == int(jlm.count) > 0 and lm.capacity == 128 * 96
    for k in COLUMNS:
        got = lm.column(k).numpy().view(np.int32)
        want = np.asarray(getattr(jlm, k)).view(np.int32)
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert (lm.column("init_t")[:n] == 1.0).all() and (lm.column("conf")[n:] == 0).all()

    depth_m = jmetricize(jnp.asarray(d.astype(np.uint16)), jm.cam, jm.params)
    fs = jcandidates(depth_m, jnp.asarray(rgb, jnp.float32) / 255.0,
                     jnp.asarray(s.astype(np.int32)), jm.cam, jm.params)
    wx, _, _ = jtransform_planar(jnp.asarray(T), fs.px, fs.py, fs.pz)
    valid = np.asarray(fs.valid).T.reshape(-1)
    np.testing.assert_array_equal(lm.column("px")[:n].numpy(),
                                  np.asarray(wx).T.reshape(-1)[valid])


def test_map_from_stacked_matches_jax(rng):
    N, count = 50, 37
    pos = rng.uniform(-10, 10, (N, 3)).astype(np.float32)
    normal = rng.normal(size=(N, 3)).astype(np.float32)
    rgb = (rng.integers(0, 256, (N, 3)) / 255.0).astype(np.float32)
    sem = rng.integers(0, 19, N).astype(np.int32)
    conf, radius, init_t, last_t = (rng.uniform(0, 5, N).astype(np.float32) for _ in range(4))
    args = (pos, conf, rgb, sem, init_t, last_t, normal, radius)
    smap = surfels.map_from_stacked(*(torch.from_numpy(a) for a in args), count)
    jmap = jsurfels.map_from_stacked(*(jnp.asarray(a) for a in args), count)
    assert smap.capacity == N and int(smap.count) == int(jmap.count) == count
    assert smap.px.shape == (N + 1,)  # the spare slot
    for k in COLUMNS:
        np.testing.assert_array_equal(smap.column(k).numpy().view(np.int32),
                                      np.asarray(getattr(jmap, k)).view(np.int32), err_msg=k)


def test_stopwatch_tick_tock_matches_jax(monkeypatch):
    """tock without a tick records nothing; tick/tock pairs record each
    name's last, total and count as the JAX stopwatch does (on one clock)."""
    ticks = iter(np.arange(0.0, 100.0, 0.25))
    clock = lambda: float(next(ticks))  # noqa: E731
    watches = (Stopwatch(), JStopwatch())
    for w in watches:
        monkeypatch.setattr("time.perf_counter", clock)
        w.tock("never")
        for name in ("a", "b", "a"):
            w.tick(name)
            w.tock(name)
        with w.time("c"):
            pass
    port, jx = watches
    assert dict(port.counts) == dict(jx.counts) == {"a": 2, "b": 1, "c": 1}
    assert port.timings == jx.timings and dict(port.totals) == dict(jx.totals)
    assert port.report() == jx.report() and port.mean_ms("a") == 250.0


def _invariant_columns(rng, cap=64, count=40):
    """A map that keeps every invariant, with class-1 colours (no
    subnormal colour words)."""
    cols = {k: np.zeros(cap, np.float32) for k in F32_COLS}
    n = rng.normal(size=(count, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    for j, k in enumerate(("nx", "ny", "nz")):
        cols[k][:count] = n[:, j]
    for k in ("px", "py", "pz"):
        cols[k][:count] = rng.uniform(-10, 10, count)
    cols["conf"][:count] = rng.uniform(0.5, 3.0, count)
    cols["radius"][:count] = rng.uniform(0.01, 0.2, count)
    cols["init_t"][:count] = rng.integers(0, 9, count)
    cols["last_t"][:count] = cols["init_t"][:count] + 1
    rgb = rng.integers(0, 256, (count, 3))
    bits = np.zeros(cap, np.int32)
    bits[:count] = (1 << 24) | (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    cols["colorsem"] = bits.view(np.float32)
    return cols, count


def _both(cols, count):
    return (convert.map_from_numpy(cols, count, "cpu"),
            jsurfels.SurfelMap(**{k: jnp.asarray(v) for k, v in cols.items()},
                               count=jnp.int32(count)))


def test_checker_matches_jax(rng):
    cols, count = _invariant_columns(rng)
    port, jx = _both(cols, count)
    assert checker.sample_surfels(port) == jchecker.sample_surfels(jx)
    assert checker.sample_surfels(port, ids=[0, 7, 39]) == jchecker.sample_surfels(jx, ids=[0, 7, 39])
    assert checker.check_map_invariants(port) == jchecker.check_map_invariants(jx) == []
    broken = {k: v.copy() for k, v in cols.items()}
    broken["conf"][[2, 5]] = (0.0, -1.0)
    broken["conf"][50] = 1.0             # beyond the live prefix
    broken["nx"][4] = 3.0                # not unit
    broken["radius"][6] = 0.0
    broken["px"][8] = np.nan
    port, jx = _both(broken, count)
    problems = checker.check_map_invariants(port)
    assert problems == jchecker.check_map_invariants(jx) and len(problems) == 5
    assert checker.sample_surfels(_both(cols, 0)[0]) == "<empty map>"
    img = rng.normal(size=(12, 9)).astype(np.float32)
    img[3, 3] = np.inf
    assert checker.histogram(img) == jchecker.histogram(img)
    assert checker.histogram(torch.from_numpy(img), bins=4) == jchecker.histogram(img, bins=4)
    assert checker.histogram(np.full(3, np.nan)) == "<no finite values>"


def test_tracing_writes_a_trace_on_the_cpu(tmp_path):
    with tracing.trace_to(str(tmp_path / "trace")):
        with tracing.span("surfel_probe_range"):
            torch.ones(64).cumsum(0)
    (name,) = os.listdir(tmp_path / "trace")
    assert name.startswith("trace_") and name.endswith(".json")
    trace = json.loads((tmp_path / "trace" / name).read_text())
    assert any(e.get("name") == "surfel_probe_range" for e in trace["traceEvents"])
    stats = tracing.device_memory_stats()
    assert stats == {} if not torch.cuda.is_available() else all(
        "bytes_limit" in v for v in stats.values())


def test_gui_helpers_match_jax(rng, tmp_path):
    np.testing.assert_array_equal(gui.SEMANTIC_PALETTE, jgui.SEMANTIC_PALETTE)
    assert gui.SEMANTIC_PALETTE.dtype == np.uint8
    d = rng.uniform(-5, 60, (17, 23)).astype(np.float32)
    d[rng.random(d.shape) < 0.2] = 0.0
    for far in (30.0, 12.5):
        np.testing.assert_array_equal(gui.normalize_depth(d, far), jgui.normalize_depth(d, far))
    sem = rng.integers(-3, 25, (17, 23)).astype(np.int32)
    np.testing.assert_array_equal(gui.colorize_semantic(sem), jgui.colorize_semantic(sem))

    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    pose[:3, 3] = rng.uniform(-5, 5, 3)
    jviewer = jgui.MappingGUI(jtiny_cam(64, 48), snapshot_dir=str(tmp_path))
    try:
        for follow, az, el, dist in ((True, 0.0, 0.45, 18.0), (False, 0.3, 0.6, 9.0),
                                     (True, -0.2, 0.1, 30.0)):
            jviewer.follow, jviewer.orbit_az, jviewer.orbit_el = follow, az, el
            jviewer.orbit_dist = dist
            np.testing.assert_array_equal(gui.map_view_pose(pose, follow, az, el, dist),
                                          jviewer.map_view_pose(pose))
    finally:
        jviewer.close()


def test_headless_snapshot_update(tmp_path):
    """tests/test_gui.py on the port's viewer, and the frustum drawn only
    with a fresh map render (against the camera that rendered the panel)."""
    cam = tiny_cam(64, 48)
    viewer = gui.MappingGUI(cam, snapshot_dir=str(tmp_path), snapshot_every=1)
    assert not viewer.interactive
    rgb = np.zeros((48, 64, 3), np.uint8)
    depth = np.full((48, 64), 5.0, np.float32)
    sem = np.zeros((48, 64), np.int32)
    render = {"rgb": torch.zeros(48, 64, 3), "semantic": torch.ones(48, 64, dtype=torch.int32),
              "depth": torch.from_numpy(depth)}
    pose = np.eye(4, dtype=np.float32)
    viewer.map_view_pose(pose)
    viewer.update(rgb, depth, sem, render, status="t", pose=pose, map_render=render)
    drawn = [line.get_xydata().copy() for line in viewer._frustum_lines]
    assert any(len(xy) for xy in drawn)
    moved = pose.copy()
    moved[2, 3] = 3.0
    viewer.update(rgb, depth, sem, None, pose=moved)  # no fresh map render
    for line, xy in zip(viewer._frustum_lines, drawn):
        np.testing.assert_array_equal(line.get_xydata(), xy)
    viewer.close()
    assert len(sorted(tmp_path.iterdir())) == 2


def test_build_map_gui_loop_on_the_cpu(tmp_path, monkeypatch, capsys):
    """build_map DIR --gui-snapshots: every frame renders the model panels
    (the local model with 'l'), and the keys act: v writes a novel view
    into output/novel, s saves the map, c cleans, r resets."""
    cam = tiny_cam(128, 96)
    scene = SyntheticScene(cam)
    write_kitti_dir(str(tmp_path / "seq"), cam, (scene.frame(i) for i in range(5)))
    monkeypatch.chdir(tmp_path)
    update = gui.MappingGUI.update
    renders = []

    def keyed_update(self, *a, **kw):
        update(self, *a, **kw)
        renders.append(a[3] is not None)
        self.show_local = self._frame_no == 2
        if self._frame_no == 3:
            self.want_novel = self.want_save = self.want_clean = True
        if self._frame_no == 4:
            self.want_reset = True

    monkeypatch.setattr(gui.MappingGUI, "update", keyed_update)
    assert build_map.main(["seq", "--device", "cpu", "--capacity", "65536", "--out", "m.bin",
                           "--decoder", "pil", "--gui-snapshots", "snaps",
                           "--gui-render-every", "1"]) == 0
    out = capsys.readouterr().out
    assert renders == [False, True, True, True, True]  # frame 0 makes no surfels
    assert len(os.listdir("snaps")) == 5
    assert "acquired novel view 1" in out and "cleaned: surfels=" in out and "map reset" in out
    assert os.listdir("output/novel/image") == ["000000.png"]
    saved = [n for n in os.listdir(".") if n.startswith("surfel_map_")]
    assert len(saved) == 1
    head = np.frombuffer(open(saved[0], "rb").read(12), "<i4")
    assert head[0] > 0 and list(head[1:]) == [0, 2]
    img = np.asarray(Image.open("snaps/frame_000002.png"))
    assert img.ndim == 3 and img.shape[2] in (3, 4)


def test_run_e2e_on_the_cpu(tmp_path):
    wd = str(tmp_path / "e2e")
    assert run_e2e.main(["--workdir", wd, "--device", "cpu", "--synthetic-cam", "small"]) == 0
    doc = json.loads(open(os.path.join(wd, "e2e.json")).read())
    assert doc["ok"] and doc["device"] == "cpu"
    hops = doc["hops"]
    assert hops["build_map"]["end_id"] == 5 and hops["load_map_paired"]["pairs"] == 6
    assert hops["spade_test"]["enhanced"] == hops["load_map_random"]["pairs"] == 3
    assert hops["move_data"] == {"moved": 3, "first": "001000.png"}
