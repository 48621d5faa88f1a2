"""Port parity, tracking (windowed BA): the window, ``refine_window`` and
``marginalize_oldest`` of surfelmapping_tpu_torch against the JAX package on
the CPU, the scenarios of tests/test_ba.py on the port alone, and the
build-map CLI with ICP and BA.

The port fuses test_ba.py's scene once on the CPU and the JAX side gets the
same map through numpy; the window is built by the JAX WindowedBA and carried
into the port by ``convert.window_from_numpy``.  The JAX functions run with
jit disabled, as in tests/test_torch_icp.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfelmapping_tpu import ba as jba
from surfelmapping_tpu.config import PipelineParams as JParams
from surfelmapping_tpu.icp import preprocess_for_icp as jpreprocess
from surfelmapping_tpu.io.synthetic import tiny_cam as jtiny_cam
from surfelmapping_tpu.ops import active as jactive
from surfelmapping_tpu.surfels import SurfelMap as JMap
from surfelmapping_tpu_torch import ba, build_map, convert, icp
from surfelmapping_tpu_torch.config import MapConfig, PipelineParams
from surfelmapping_tpu_torch.io.synthetic import SyntheticScene, tiny_cam
from surfelmapping_tpu_torch.ops.active import table_from_map
from surfelmapping_tpu_torch.pipeline import SurfelMapper
from surfelmapping_tpu_torch.surfels import resize_map

# tests/test_ba.py's scene: errors are measured on the constrained (z, y)
# components; lateral x is the corridor gauge
BOXES = (
    ((-4.0, 0.6, 11.0), (1.0, 1.0, 1.5)),
    ((0.5, 0.7, 18.0), (1.2, 0.9, 1.0)),
    ((-2.0, 0.4, 24.0), (1.0, 1.2, 1.0)),
)
PARAMS = dict(fuse_thresh_factor=0.05, smooth_radius=1, stereo_border=0.0)
WIN = dict(window=4, stride=2, iters=2, odo_weight=300.0)


@pytest.fixture(scope="module")
def fused_scene():
    cam = tiny_cam()
    params = PipelineParams(**PARAMS)
    scene = SyntheticScene(cam, step=0.4, car_center=(4.5, 0.8, 13.0), extra_boxes=BOXES)
    mapper = SurfelMapper(cam, params, MapConfig(capacity=1 << 17), device="cpu")
    for i in range(16):
        mapper.process_frame(*scene.frame(i))
    assert mapper.count > 2000
    # cut to the live prefix in whole blocks: a whole-map table's invalid
    # padding changes no result, only the time of every index map
    smap = resize_map(mapper.smap, -(-mapper.count // 2048) * 2048)
    cols, count = convert.map_to_numpy(smap)
    jmap = JMap(**{k: jnp.asarray(v) for k, v in cols.items()}, count=jnp.int32(count))
    return cam, params, scene, smap, jmap


def _depth(d, s, params):
    return icp.preprocess_for_icp(torch.from_numpy(d.astype(np.int32)),
                                  torch.from_numpy(s.astype(np.int32)), tiny_cam(), params)


def _odometry_poses(scene, seed=3):
    """Frames 4-7 with 3 cm of z noise each (tests/test_ba.py:149-157)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(4, 8):
        rgb, d, s, T = scene.frame(i)
        T_odo = T.astype(np.float32).copy()
        T_odo[2, 3] += rng.normal(0, 0.03)
        out.append((i, d, s, T_odo))
    return out


@pytest.fixture(scope="module")
def windows(fused_scene):
    """The same 4 pushes into the JAX WindowedBA and into the port's: both
    windows, and both tables of the whole map."""
    cam, params, scene, smap, jmap = fused_scene
    jt = jactive.table_from_map(jmap)
    at = table_from_map(smap)
    jw = jba.WindowedBA(jtiny_cam(), JParams(**PARAMS), **WIN)
    tw = ba.WindowedBA(cam, params, **WIN, device="cpu")
    with jax.disable_jit():
        for i, d, s, T_odo in _odometry_poses(scene):
            jw.push(jpreprocess(jnp.asarray(d), jnp.asarray(s.astype(np.int32)), jtiny_cam(),
                                JParams(**PARAMS)), T_odo, at=jt, time=float(i))
            tw.push(_depth(d, s, params), T_odo, at=at, time=float(i))
    return jw.win, tw.win, jt, at


def _arrays(jwin):
    return {f.name: np.asarray(getattr(jwin, f.name)) for f in dataclasses.fields(jwin)
            if f.name != "n_valid"}


def _assert_poses_close(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got[..., :3, 3] - want[..., :3, 3]).max() < tol
    # rotation angle from the skew part of R_got^T R_want: an arccos of the
    # trace would read float32's departure from orthonormality (~1e-4 rad)
    dR = np.swapaxes(got[..., :3, :3], -1, -2) @ want[..., :3, :3]
    skew = np.stack([dR[..., 2, 1] - dR[..., 1, 2], dR[..., 0, 2] - dR[..., 2, 0],
                     dR[..., 1, 0] - dR[..., 0, 1]], axis=-1) / 2
    assert np.arcsin(np.minimum(np.linalg.norm(skew, axis=-1), 1.0)).max() < tol


def test_window_push_matches_jax(windows):
    """The port's WindowedBA fills its window as the JAX one does, and a
    window round-trips through numpy exactly."""
    jwin, twin, _, _ = windows
    arrays, n = convert.window_to_numpy(twin)
    assert n == int(jwin.n_valid) == 4
    want = _arrays(jwin)
    for k, v in arrays.items():
        assert v.dtype == want[k].dtype, k
        np.testing.assert_allclose(v, want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    back = convert.window_to_numpy(convert.window_from_numpy(arrays, n, "cpu"))
    assert back[1] == n and all(np.array_equal(back[0][k], arrays[k]) for k in arrays)


@jax.disable_jit()
def test_refine_window_matches_jax(fused_scene, windows):
    """refine_window on the JAX WindowedBA's window, carried into the port:
    poses within 1e-4 m and 1e-4 rad, inliers within 1%."""
    cam, params, _, _, _ = fused_scene
    jwin, _, jt, at = windows
    want, wdiag = jba.refine_window(jwin, jt, jnp.float32(7.0), jtiny_cam(), JParams(**PARAMS),
                                    stride=2, iters=2, odo_weight=300.0)
    twin = convert.window_from_numpy(_arrays(jwin), int(jwin.n_valid), "cpu")
    got, gdiag = ba.refine_window(twin, at, 7.0, cam, params, stride=2, iters=2,
                                  odo_weight=300.0)
    _assert_poses_close(got.poses.numpy(), np.asarray(want.poses))
    n_j, n_t = int(wdiag["inliers"]), int(gdiag["inliers"])
    assert n_j > 300 and abs(n_t - n_j) <= 0.01 * n_j
    # the poses moved, and only they
    assert not np.allclose(np.asarray(want.poses), np.asarray(jwin.poses), atol=1e-4)
    assert torch.equal(got.v_c, twin.v_c) and got.n_valid == twin.n_valid


@jax.disable_jit()
def test_marginalize_oldest_matches_jax(fused_scene, windows):
    """The Schur prior of a full window: within 1e-4 of its largest entry."""
    cam, params, _, _, _ = fused_scene
    jwin, _, jt, at = windows
    want = jba.marginalize_oldest(jwin, jt, jnp.float32(7.0), jtiny_cam(), JParams(**PARAMS),
                                  stride=2, odo_weight=300.0)
    twin = convert.window_from_numpy(_arrays(jwin), int(jwin.n_valid), "cpu")
    got = ba.marginalize_oldest(twin, at, 7.0, cam, params, stride=2, odo_weight=300.0)
    for g, w in zip(got[:2], want[:2]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())
    assert np.abs(np.asarray(want[1])).max() > 0
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert torch.equal(got[0], got[0].T)


def _zy_err(P, T):
    return float(np.linalg.norm([P[2, 3] - T[2, 3], P[1, 3] - T[1, 3]]))


def _run_sequence(cam, params, scene, smap, dropout=(), seed=1):
    """tests/test_ba.py:66-89: random-walk odometry drift through frames
    4-13; per frame (index, odometry error, BA error) on (z, y)."""
    at = table_from_map(smap)
    w = ba.WindowedBA(cam, params, window=6, stride=2, iters=4, odo_weight=300.0, device="cpu")
    rng = np.random.default_rng(seed)
    drift = np.eye(4, dtype=np.float32)
    out = []
    for i in range(4, 14):
        rgb, d, s, T = scene.frame(i)
        if i in dropout:
            d = np.zeros_like(d)
        dT = np.eye(4, dtype=np.float32)
        dT[2, 3] = rng.normal(0, 0.02)
        dT[1, 3] = rng.normal(0, 0.008)
        drift = drift @ dT
        T_odo = (T @ drift).astype(np.float32)
        w.push(_depth(d, s, params), T_odo, at=at, time=float(i))
        refined = w.refine(at, time=float(i))
        out.append((i, _zy_err(T_odo, T), _zy_err(refined, T)))
    return out, w


def test_ba_reduces_odometry_drift(fused_scene):
    """tests/test_ba.py:92-103 on the port."""
    cam, params, scene, smap, _ = fused_scene
    out, w = _run_sequence(cam, params, scene, smap)
    odo = np.mean([r[1] for r in out])
    bae = np.mean([r[2] for r in out])
    assert np.isfinite(bae)
    assert bae < 0.75 * odo, f"BA {bae:.4f} vs odometry {odo:.4f}"
    # the window slid, so marginalization ran; the prior stays sane
    assert w.win.n_valid == w.K
    H = w.win.prior_H.numpy()
    assert np.all(np.isfinite(H)) and np.all(np.isfinite(w.win.prior_b.numpy()))
    assert np.allclose(H, H.T, atol=1e-4)


def test_ba_bridges_measurement_dropout(fused_scene):
    """tests/test_ba.py:106-132 on the port: ICP on a frame without depth
    has 0 inliers and leaves the pose exactly where it was; BA's odometry
    edges carry the neighbours' corrections across the gap."""
    cam, params, scene, smap, _ = fused_scene
    dropout = {5, 8}
    out, _ = _run_sequence(cam, params, scene, smap, dropout=dropout)
    at = table_from_map(smap)
    for i, odo_err, ba_err in out:
        if i not in dropout:
            continue
        _, d, s, _ = scene.frame(i)
        pose, diag = icp.refine_pose(at, _depth(np.zeros_like(d), s, params),
                                     torch.eye(4), cam, params)
        assert int(diag["inliers"]) == 0
        assert torch.equal(pose, torch.eye(4))
        assert ba_err < odo_err, f"frame {i}: BA {ba_err:.4f} vs odometry {odo_err:.4f}"


class _TwoEqualRanks:
    """A group of two ranks that hold the same evidence: its SUM doubles."""

    def all_reduce(self, t, op):
        assert op == "sum"
        return t.mul_(2)


def test_refine_window_axis_name_waits_for_the_sharded_engine(fused_scene, windows):
    """The sharded engine came: ``axis_name`` became ``group``, whose SUM of
    the per-frame (A, b, n_inliers) runs before the normalization.  Two
    ranks with equal evidence double every sum, the normalization by the
    summed inliers halves it back exactly (powers of two), so the refine is
    the one-rank refine bit for bit; the multi-rank job is
    tests/test_torch_sharded.py::test_ba_cross_rank_reduction_matches_the_single_rank."""
    cam, params, _, _, _ = fused_scene
    _, twin, _, at = windows
    with pytest.raises(TypeError, match="axis_name"):
        ba.refine_window(twin, at, 7.0, cam, params, axis_name="s")
    want, wd = ba.refine_window(twin, at, 7.0, cam, params, stride=2, iters=2, odo_weight=300.0)
    got, gd = ba.refine_window(twin, at, 7.0, cam, params, stride=2, iters=2, odo_weight=300.0,
                               group=_TwoEqualRanks())
    assert torch.equal(got.poses, want.poses)
    assert int(gd["inliers"]) == 2 * int(wd["inliers"]) > 0


def test_build_map_cli_tracks_with_icp_and_ba(tmp_path, capsys):
    out = str(tmp_path / "m.bin")
    assert build_map.main(["--synthetic", "4", "--synthetic-cam", "small", "--icp", "--ba",
                           "--pose-noise", "0.02", "--device", "cpu", "--out", out,
                           "--capacity", str(1 << 16)]) == 0
    lines = capsys.readouterr().out.splitlines()
    ate = [ln for ln in lines if ln.startswith("ATE (rmse vs input gt): ")]
    assert len(ate) == 1 and np.isfinite(float(ate[0].split()[5]))
    assert any("saved:" in ln and "from 4 frames" in ln for ln in lines)
