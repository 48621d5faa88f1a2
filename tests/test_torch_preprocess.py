"""Port parity, preprocessing: metricize, the support filter and
remove_movings match the JAX package exactly; the support -> smooth ->
support chain (the preprocess stencil kernel's plain version, which the
port's CPU path runs) matches the JAX jnp chain to atol 1e-4, the
tolerance of tests/test_pallas_preprocess.py.  (The kernel against its
plain version on the card: tests/test_torch_gpu.py.)
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfelmapping_tpu.config import CameraIntrinsics as JCam
from surfelmapping_tpu.config import PipelineParams as JParams
from surfelmapping_tpu.io.synthetic import SyntheticScene as JScene
from surfelmapping_tpu.ops import preprocess as jpre
from surfelmapping_tpu_torch.config import CameraIntrinsics, PipelineParams
from surfelmapping_tpu_torch.ops import preprocess as tpre
from surfelmapping_tpu_torch.ops.preprocess_stencil import preprocess_stencil


def _cams(H, W):
    kw = dict(fx=100.0, fy=100.0, cx=W / 2, cy=H / 2, width=W, height=H)
    return JCam(**kw), CameraIntrinsics(**kw)


def _synthetic_frame(H, W, rng, border_classes=True):
    """Depth with smooth ramps + discontinuities, holes, and a class image
    with boundaries crossing the stencil windows (the frames of
    tests/test_pallas_preprocess.py)."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = 5.0 + 4.0 * np.sin(x / 37.0) + 0.002 * y * x / W
    depth[:, W // 2 :] += 3.0
    depth[rng.random((H, W)) < 0.03] = 0.0
    depth[rng.random((H, W)) < 0.01] = 150.0  # beyond filter_cap_depth
    depth[rng.random((H, W)) < 0.01] = 0.5    # below near_clip
    sem = np.zeros((H, W), np.int32)
    if border_classes:
        sem[:, : W // 3] = 1
        sem[H // 2 :, :] += 2
        sem[: H // 8, 2 * W // 3 :] = 10
        sem[rng.random((H, W)) < 0.01] = 11
        sem[rng.random((H, W)) < 0.005] = 12
    return depth.astype(np.float32), sem


@functools.partial(jax.jit, static_argnames=("cam", "params"))
def _jnp_chain(metric, semantic, cam, params):
    f1 = jpre.support_filter(metric, semantic, params, params.filter_diff_thresh_1)
    sm = jpre.smooth_depth(f1, semantic, cam, params)
    return jpre.support_filter(sm, semantic, params, params.filter_diff_thresh_2)


def _raw_frame(rng, H=96, W=128):
    depth_mm = rng.integers(0, 40000, (H, W)).astype(np.uint16)
    depth_mm[rng.random((H, W)) < 0.05] = 0
    sem = rng.integers(0, 19, (H, W)).astype(np.int32)
    return depth_mm, sem


def test_metricize_exact(rng):
    jcam, cam = _cams(96, 128)
    depth_mm, _ = _raw_frame(rng)
    want = jpre.metricize_depth(jnp.asarray(depth_mm), jcam, JParams())
    got = tpre.metricize_depth(torch.from_numpy(depth_mm.astype(np.int32)), cam, PipelineParams())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("thresh", [0.15, 0.1, 2.0])
def test_support_filter_exact(thresh, rng):
    depth, sem = _synthetic_frame(70, 200, rng)
    want = jpre.support_filter(jnp.asarray(depth), jnp.asarray(sem), JParams(), thresh)
    got = tpre.support_filter(torch.from_numpy(depth), torch.from_numpy(sem),
                              PipelineParams(), thresh)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_remove_movings_exact(rng):
    jcam, cam = _cams(96, 128)
    jscene = JScene(jcam, car_center=(0.5, 0.8, 6.0))
    _, d0, _, _ = jscene.frame(0)
    _, d1, sem, _ = jscene.frame(1)
    last = tpre.metricize_depth(torch.from_numpy(d0.astype(np.int32)), cam, PipelineParams()).numpy()
    depth = tpre.metricize_depth(torch.from_numpy(d1.astype(np.int32)), cam, PipelineParams()).numpy()
    # the car moved: a rigid offset between the frames' depths makes movers
    depth = np.where(sem == 13, depth + 0.7, depth).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = (0.05, -0.02, 0.8)
    sem = sem.astype(np.int32)
    want = jpre.remove_movings(jnp.asarray(depth), jnp.asarray(sem), jnp.asarray(last),
                               jnp.asarray(T), jcam, JParams(stereo_border=16.0))
    got = tpre.remove_movings(torch.from_numpy(depth), torch.from_numpy(sem),
                              torch.from_numpy(last), torch.from_numpy(T), cam,
                              PipelineParams(stereo_border=16.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != depth).sum() > 0, "no pixel was culled"


@pytest.mark.parametrize(
    "H,W,border",
    [
        (70, 200, 16.0),   # even H, small border
        (37, 200, 0.0),    # odd H, no border
        (128, 328, 80.0),  # the reference stereo border
    ],
)
def test_chain_matches_jax(H, W, border, rng):
    jcam, cam = _cams(H, W)
    depth, sem = _synthetic_frame(H, W, rng)
    want = _jnp_chain(jnp.asarray(depth), jnp.asarray(sem), jcam, JParams(stereo_border=border))
    got = preprocess_stencil(torch.from_numpy(depth), torch.from_numpy(sem), cam,
                             PipelineParams(stereo_border=border))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    kept = float((got > 0).float().mean())
    assert 0.05 < kept < 0.999


@pytest.mark.parametrize("kind", ["zeros", "plane"])
def test_chain_degenerate_frames(kind):
    H, W = 64, 200
    jcam, cam = _cams(H, W)
    depth = np.zeros((H, W), np.float32) if kind == "zeros" else np.full((H, W), 7.5, np.float32)
    sem = np.zeros((H, W), np.int32)
    want = _jnp_chain(jnp.asarray(depth), jnp.asarray(sem), jcam, JParams(stereo_border=8.0))
    got = preprocess_stencil(torch.from_numpy(depth), torch.from_numpy(sem), cam,
                             PipelineParams(stereo_border=8.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    if kind == "zeros":
        assert float(got.abs().max()) == 0.0


def test_preprocess_frame_matches_jax():
    """u16 frame -> DEPTH_FILTERED image through each package's entry."""
    jcam, cam = _cams(96, 128)
    _, depth_mm, sem, _ = JScene(jcam).frame(2)
    want = jax.jit(jpre.preprocess_frame, static_argnames=("cam", "params"))(
        jnp.asarray(depth_mm), jnp.asarray(sem.astype(np.int32)), cam=jcam, params=JParams())
    got = tpre.preprocess_frame(torch.from_numpy(depth_mm.astype(np.int32)),
                                torch.from_numpy(sem.astype(np.int32)), cam, PipelineParams())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert float((got > 0).float().mean()) > 0.01  # 48 of 128 columns lie right of the border

