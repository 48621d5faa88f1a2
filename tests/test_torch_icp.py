"""Port parity, tracking (ICP): the SE(3) maps, ICP's index image, its
normal equations and ``refine_pose`` of surfelmapping_tpu_torch against the
JAX package on the CPU, and the scenarios of tests/test_icp.py on the port
alone.

The port fuses test_icp.py's scene once on the CPU; the JAX side gets the
same map through numpy (``convert``).  The JAX functions run with jit
disabled, op by op, as in tests/test_torch_pipeline.py: jitted XLA contracts
multiply-adds into FMAs, which moves a projected surfel across a pixel edge
and so changes the index image.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfelmapping_tpu import icp as jicp
from surfelmapping_tpu import metrics as jmetrics
from surfelmapping_tpu.config import PipelineParams as JParams
from surfelmapping_tpu.io.synthetic import tiny_cam as jtiny_cam
from surfelmapping_tpu.ops import active as jactive
from surfelmapping_tpu.ops import transforms as jtf
from surfelmapping_tpu.surfels import SurfelMap as JMap
from surfelmapping_tpu_torch import convert, icp, metrics
from surfelmapping_tpu_torch.config import MapConfig, PipelineParams
from surfelmapping_tpu_torch.io.synthetic import SyntheticScene, tiny_cam
from surfelmapping_tpu_torch.ops import active, transforms
from surfelmapping_tpu_torch.pipeline import SurfelMapper
from surfelmapping_tpu_torch.surfels import resize_map

# tests/test_icp.py's scene: fronto-parallel faces constrain depth, height,
# pitch and yaw; lateral x is unconstrained (corridor gauge)
BOXES = (((-4.0, 0.6, 11.0), (1.0, 1.0, 1.5)), ((0.5, 0.7, 18.0), (1.2, 0.9, 1.0)))
PARAMS = dict(fuse_thresh_factor=0.05, smooth_radius=1)


def _scene(cam):
    return SyntheticScene(cam, step=0.4, car_center=(4.5, 0.8, 13.0), extra_boxes=BOXES)


def _build(n_frames):
    """(cam, params, scene, map) after fusing ``n_frames``; the map cut to its
    live prefix in whole blocks (invalid padding changes no result, only the
    time of every index map)."""
    cam = tiny_cam()
    m = SurfelMapper(cam, PipelineParams(**PARAMS), MapConfig(capacity=1 << 15), device="cpu")
    scene = _scene(cam)
    for i in range(n_frames):
        m.process_frame(*scene.frame(i))
    assert m.count > 0
    return cam, m.params, scene, resize_map(m.smap, -(-m.count // 2048) * 2048)


def _perturbed(T_gt):
    """10 cm forward, 5 cm lateral, 0.7 deg yaw (tests/test_icp.py:44-58)."""
    yaw = np.deg2rad(0.7)
    Ry = np.array([[np.cos(yaw), 0, np.sin(yaw), 0], [0, 1, 0, 0],
                   [-np.sin(yaw), 0, np.cos(yaw), 0], [0, 0, 0, 1]], np.float32)
    T0 = T_gt @ Ry
    T0[0, 3] += 0.05
    T0[2, 3] += 0.10
    return T0


def _depth(d, s, params):
    return icp.preprocess_for_icp(torch.from_numpy(d.astype(np.int32)),
                                  torch.from_numpy(s.astype(np.int32)), tiny_cam(), params)


def _jax_map(smap):
    cols, count = convert.map_to_numpy(smap)
    return JMap(**{k: jnp.asarray(v) for k, v in cols.items()}, count=jnp.int32(count))


@pytest.fixture(scope="module")
def fused():
    cam, params, scene, smap = _build(4)
    return cam, params, scene, smap, _jax_map(smap)


def _rotation_angle(A, B):
    """The angle of R_A^T R_B from its skew part (an arccos of the trace
    would read float32's departure from orthonormality, ~1e-4 rad)."""
    dR = np.asarray(A, np.float64)[:3, :3].T @ np.asarray(B, np.float64)[:3, :3]
    skew = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]) / 2
    return float(np.arcsin(min(np.linalg.norm(skew), 1.0)))


def _random_pose(rng) -> np.ndarray:
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = q
    T[:3, 3] = rng.uniform(-20, 20, 3)
    return T


def _twists(rng):
    """Twists with |w| from 0 (the small gate) through 1e-9 to 0.5 rad."""
    xi = rng.normal(0, 0.5, (40, 6)).astype(np.float32)
    xi[:4, 3:] = 0.0
    xi[4:8, 3:] *= 1e-9
    xi[8:12, 3:] *= 1e-4
    return xi


@pytest.mark.parametrize("fn", ["exp_se3", "log_se3", "adjoint_se3"])
@jax.disable_jit()
def test_se3_maps_match_jax(fn, rng):
    xi = _twists(rng)
    for x in xi:
        if fn == "exp_se3":
            want = np.asarray(jtf.exp_se3(jnp.asarray(x)))
            got = transforms.exp_se3(torch.from_numpy(x)).numpy()
        else:
            T = np.array(jtf.exp_se3(jnp.asarray(x)))
            want = np.asarray(getattr(jtf, fn)(jnp.asarray(T)))
            got = getattr(transforms, fn)(torch.from_numpy(T)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # batched: the same values as one at a time
    batch = transforms.exp_se3(torch.from_numpy(xi))
    for x, b in zip(xi, batch):
        assert torch.equal(transforms.exp_se3(torch.from_numpy(x)), b)


@jax.disable_jit()
def test_pose_products_and_acos_match_jax_exactly(rng):
    """The FMA-chain products equal XLA's on the CPU bit for bit, and the
    float64 acos agrees with JAX's float32 arccos to its last bit or two."""
    for _ in range(50):
        A, B = _random_pose(rng), _random_pose(rng)
        assert np.array_equal(transforms.compose(torch.from_numpy(A), torch.from_numpy(B)).numpy(),
                              np.asarray(jtf.compose(jnp.asarray(A), jnp.asarray(B))))
        assert np.array_equal(transforms.invert_se3(torch.from_numpy(A)).numpy(),
                              np.asarray(jtf.invert_se3(jnp.asarray(A))))
    x = rng.uniform(-1, 1, 4096).astype(np.float32)
    np.testing.assert_allclose(transforms.acos(torch.from_numpy(x)).numpy(),
                               np.asarray(jnp.arccos(jnp.asarray(x))), rtol=3e-7, atol=0)


@jax.disable_jit()
def test_icp_index_image_equals_jax(fused):
    """One ICP iteration's association at a perturbed pose: the port's index
    image (K1's plain version) equals JAX's, pixel for pixel."""
    cam, params, scene, smap, jmap = fused
    T_inv = np.array(jtf.invert_se3(jnp.asarray(_perturbed(scene.frame(4)[3]))))
    jt = jactive.table_from_map(jmap)
    time = jnp.max(jnp.where(jt.slot_valid, jt.last_t, 0.0))
    want = np.asarray(jactive.index_active(jt, jnp.asarray(T_inv), time, jtiny_cam(),
                                           JParams(**PARAMS)))
    at = active.table_from_map(smap)
    got = active.index_active(at, torch.from_numpy(T_inv),
                              torch.max(torch.where(at.slot_valid, at.last_t, 0.0)), cam,
                              params, at.slot_valid.sum(dtype=torch.int32))
    assert (want >= 0).sum() > 100
    np.testing.assert_array_equal(got.numpy(), want)


def test_table_from_map_round_trip(fused):
    """A map viewed as a table has the count as its valid prefix, and
    map_from_table gives the map back."""
    smap = fused[3]
    at = active.table_from_map(smap)
    assert int(at.slot_valid.sum()) == int(smap.count) and bool(at.slot_valid[:int(smap.count)].all())
    back = active.map_from_table(at, smap.count)
    assert back.capacity == smap.capacity
    for k in ("px", "py", "pz", "conf", "colorsem", "init_t", "last_t", "nx", "ny", "nz", "radius"):
        assert torch.equal(back.column(k), smap.column(k)), k


@jax.disable_jit()
def test_normal_equations_match_jax(rng):
    P = 3000
    v_w = rng.uniform(-20, 20, (P, 3)).astype(np.float32)
    p_w = v_w + rng.normal(0, 0.05, (P, 3)).astype(np.float32)
    n = rng.normal(size=(P, 3))
    n_w = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    w = np.where(rng.uniform(size=P) < 0.2, 0.0, rng.uniform(0.1, 1.0, P)).astype(np.float32)
    want = jicp._normal_equations(*(jnp.asarray(a) for a in (v_w, p_w, n_w, w)))
    got = icp._normal_equations(*(torch.from_numpy(a) for a in (v_w, p_w, n_w, w)))
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("form", ["map", "table"])
@jax.disable_jit()
def test_refine_pose_matches_jax(form, fused):
    """refine_pose from a perturbed pose on the same map (or the same table,
    carried across by convert.table_from_numpy): poses within 1e-4 m and
    1e-4 rad, inliers within 1%."""
    cam, params, scene, smap, jmap = fused
    _, d, s, T_gt = scene.frame(4)
    T0 = _perturbed(T_gt)
    jd = jicp.preprocess_for_icp(jnp.asarray(d), jnp.asarray(s.astype("int32")), jtiny_cam(),
                                 JParams(**PARAMS))
    src = jmap
    tsrc = smap
    if form == "table":
        src = jactive.table_from_map(jmap)
        tsrc = convert.table_from_numpy({k: np.asarray(getattr(src, k)) for k in
                                         src.__dataclass_fields__}, "cpu")
        assert tsrc.colorsem.dtype == torch.int32
    want, wdiag = jicp.refine_pose(src, jd, jnp.asarray(T0), jtiny_cam(), JParams(**PARAMS))
    depth = _depth(d, s, params)
    np.testing.assert_array_equal(depth.numpy(), np.asarray(jd))
    got, gdiag = icp.refine_pose(tsrc, depth, torch.from_numpy(T0), cam, params)
    want, got = np.asarray(want), got.numpy()
    assert np.abs(got[:3, 3] - want[:3, 3]).max() < 1e-4
    assert _rotation_angle(got, want) < 1e-4
    n_j, n_t = int(wdiag["inliers"]), int(gdiag["inliers"])
    assert n_j > 60 and abs(n_t - n_j) <= 0.01 * n_j
    assert abs(float(gdiag["rmse"]) - float(wdiag["rmse"])) < 1e-5


def test_absolute_trajectory_error_matches_jax(rng):
    gt = np.stack([_random_pose(rng) for _ in range(17)])
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.1, (17, 3)).astype(np.float32)
    assert metrics.absolute_trajectory_error(est, gt) == jmetrics.absolute_trajectory_error(est, gt)


def test_icp_recovers_perturbed_pose(fused):
    """tests/test_icp.py:42-82 on the port: depth, height and yaw recovered."""
    cam, params, scene, smap, _ = fused
    _, d, s, T_gt = scene.frame(4)
    refined, diag = icp.refine_pose(smap, _depth(d, s, params), torch.from_numpy(_perturbed(T_gt)),
                                    cam, params, iters=8)
    refined = refined.numpy()
    assert int(diag["inliers"]) > 60
    assert abs(refined[2, 3] - T_gt[2, 3]) < 0.02
    assert abs(refined[1, 3] - T_gt[1, 3]) < 0.02
    dR = refined[:3, :3].T @ T_gt[:3, :3]
    assert abs(np.arctan2(dR[0, 2], dR[0, 0])) < np.deg2rad(0.3)
    assert np.linalg.norm(refined[:3, 3] - T_gt[:3, 3]) < 0.07


def test_icp_identity_stays_put():
    """tests/test_icp.py:85-95 on the port."""
    cam, params, scene, smap = _build(3)
    _, d, s, T_gt = scene.frame(2)
    refined, _ = icp.refine_pose(smap, _depth(d, s, params), torch.from_numpy(T_gt), cam,
                                 params, iters=4)
    assert np.linalg.norm(refined.numpy()[:3, 3] - T_gt[:3, 3]) < 0.01


def test_icp_refiner_takes_raw_frames(fused):
    """The host wrapper: raw u16 depth and classes in, a numpy pose out, and
    the last iteration's diagnostics as floats."""
    cam, params, scene, smap, _ = fused
    _, d, s, T_gt = scene.frame(4)
    r = icp.ICPRefiner(cam, params, iters=8, device="cpu")
    pose = r.refine(smap, d, s, _perturbed(T_gt))
    want, _ = icp.refine_pose(smap, _depth(d, s, params), torch.from_numpy(_perturbed(T_gt)),
                              cam, params, iters=8)
    assert isinstance(pose, np.ndarray) and np.array_equal(pose, want.numpy())
    assert set(r.last_diag) == {"rmse", "inliers"} and r.last_diag["inliers"] > 60
