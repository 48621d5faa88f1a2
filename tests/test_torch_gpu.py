"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions, and the main path and the renderer on the card against
the CPU.

Every test here needs a CUDA card: it carries the ``gpu`` marker and skips
without one.  The file imports neither JAX nor the JAX package, so it also
runs on a machine that has only PyTorch, without the suite's conftest:

    python -m pytest --noconftest -o addopts= -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from surfelmapping_tpu_torch.config import CameraIntrinsics, MapConfig, PipelineParams
from surfelmapping_tpu_torch.io.synthetic import SyntheticScene, kitti_cam, tiny_cam
from surfelmapping_tpu_torch.ops import preprocess_stencil as k2
from surfelmapping_tpu_torch.ops import zbuf as k1
from surfelmapping_tpu_torch.ops import zbuf_outres as outres
from surfelmapping_tpu_torch.ops.index_map import INT32_MAX
from surfelmapping_tpu_torch.ops.preprocess import metricize_depth, stencil_chain_plain
from surfelmapping_tpu_torch.ops.splat import render_view
from surfelmapping_tpu_torch.pipeline import SurfelMapper

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _zbuf_case(name, seed=0):
    """(zkey, fpix, P, n_valid): random with invalids, ties, a partial valid
    prefix whose tail keeps valid-looking keys, and the index map's shape."""
    rng = np.random.default_rng(seed)
    P, A, nv = {"random": (5000, 4096, 4096), "prefix": (2000, 8192, 3001),
                "kitti": (453_620, 1 << 20, 700_001)}.get(name, (200, 4096, 4096))
    zkey = rng.integers(0, 1 << 20, A).astype(np.int32)
    fpix = rng.integers(0, P, A).astype(np.int32)
    inval = rng.uniform(size=A) < 0.3
    zkey[inval] = INT32_MAX
    fpix[inval] = P
    if name == "ties":
        zkey[:] = INT32_MAX
        zkey[[3, 4, 5]] = 77
        fpix[[3, 4, 5]] = 13
    return zkey, fpix, P, nv


@pytest.mark.parametrize("name", ["random", "ties", "prefix", "kitti"])
def test_zbuffer_kernel_matches_plain(name, cuda):
    zkey, fpix, P, nv = _zbuf_case(name)
    zk, fp = torch.from_numpy(zkey).to(cuda), torch.from_numpy(fpix).to(cuda)
    slot_valid = torch.arange(zkey.shape[0], device=cuda) < nv
    before = k1.KERNEL.launches
    zb, ib = k1.zbuffer_argmin(zk, fp, P, slot_valid)
    assert k1.KERNEL.launches == before + 1
    zr, ir = k1.zbuffer_argmin_plain(zk, fp, P, slot_valid)
    assert torch.equal(zb, zr) and torch.equal(ib, ir)
    if name == "ties":
        assert (int(zb[13]), int(ib[13])) == (77, 3)


def test_zbuffer_wrapper_rejects_bad_inputs(cuda):
    zk = torch.zeros(8, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        k1.zbuffer_argmin(zk, zk.int(), 4, torch.ones(8, dtype=torch.bool, device=cuda))


def _stencil_frame(H, W, rng):
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = 5.0 + 4.0 * np.sin(x / 37.0) + 0.002 * y * x / W
    depth[:, W // 2 :] += 3.0
    depth[rng.random((H, W)) < 0.03] = 0.0
    depth[rng.random((H, W)) < 0.01] = 150.0
    depth[rng.random((H, W)) < 0.01] = 0.5
    sem = np.zeros((H, W), np.int32)
    sem[:, : W // 3] = 1
    sem[H // 2 :, :] += 2
    sem[: H // 8, 2 * W // 3 :] = 10
    sem[rng.random((H, W)) < 0.01] = 11
    return depth.astype(np.float32), sem


@pytest.mark.parametrize("H,W,border", [(70, 200, 16.0), (37, 200, 0.0), (370, 1226, 80.0)])
def test_stencil_kernel_matches_plain(H, W, border, cuda):
    cam = CameraIntrinsics(fx=100.0, fy=100.0, cx=W / 2, cy=H / 2, width=W, height=H)
    params = PipelineParams(stereo_border=border)
    depth, sem = _stencil_frame(H, W, np.random.default_rng(0))
    metric, semantic = torch.from_numpy(depth).to(cuda), torch.from_numpy(sem).to(cuda)
    got = k2.preprocess_stencil(metric, semantic, cam, params)
    want = stencil_chain_plain(metric, semantic, cam, params)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_stencil_kernel_on_a_synthetic_kitti_frame(cuda):
    cam, params = kitti_cam(), PipelineParams()
    _, depth, sem, _ = SyntheticScene(cam, noise_mm=40.0).frame(5, np.random.default_rng(1))
    metric = metricize_depth(torch.from_numpy(depth.astype(np.int32)).to(cuda), cam, params)
    semantic = torch.from_numpy(sem.astype(np.int32)).to(cuda)
    got = k2.preprocess_stencil(metric, semantic, cam, params)
    want = stencil_chain_plain(metric, semantic, cam, params)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert float((got > 0).float().mean()) > 0.05


def test_main_path_on_the_card_matches_the_cpu(cuda):
    """Both kernels on the path, identical per-frame stats to the CPU run
    of the plain versions."""
    params = PipelineParams(fuse_thresh_factor=0.05)
    scene = SyntheticScene(tiny_cam(), step=0.4)
    card = SurfelMapper(tiny_cam(), params, MapConfig(capacity=1 << 16), device=cuda)
    cpu = SurfelMapper(tiny_cam(), params, MapConfig(capacity=1 << 16), device="cpu")
    n1, n2 = k1.KERNEL.launches, k2.KERNEL.launches
    for i in range(5):
        frame = scene.frame(i)
        got = {k: int(v) for k, v in card.process_frame(*frame).items()}
        assert got == {k: int(v) for k, v in cpu.process_frame(*frame).items()}, i
    assert k1.KERNEL.launches - n1 == 4
    assert k2.KERNEL.launches - n2 == 5
    assert card.count == cpu.count > 0


def _outres_case(P, seed=0):
    """2^20 candidates over [0, P): signed keys, INT32_MAX keys, a planted
    min-id tie on pixel 13, and (at P = 453,620 and above) empty pixels."""
    rng = np.random.default_rng(seed)
    A = 1 << 20
    zkey = rng.integers(-(1 << 30), 1 << 30, A).astype(np.int32)
    fpix = rng.integers(0, P, A).astype(np.int32)
    zkey[rng.uniform(size=A) < 0.2] = INT32_MAX
    fpix[fpix == 13] = 14
    fpix[[7, 8, 900]] = 13
    zkey[[7, 8, 900]] = -(1 << 30) - 5
    return zkey, fpix


@pytest.mark.parametrize("P", [5000, 453_620, 4 * 453_620])
def test_outres_kernel_matches_plain(P, cuda):
    zkey, fpix = _outres_case(P)
    zk, fp = torch.from_numpy(zkey).to(cuda), torch.from_numpy(fpix).to(cuda)
    before = (outres.KERNEL.launches, outres.P2.launches, outres.P1.launches)
    zb, ib = outres.outres(zk, fp, P)
    ref = outres.zbuffer_outres_plain(zk, fp, outres.outres_pixels(P))
    assert torch.equal(zb, ref[:P, 1]) and torch.equal(ib, ref[:P, 0])
    assert (int(zb[13]), int(ib[13])) == (-(1 << 30) - 5, 7)
    assert (int((ib == INT32_MAX).sum()) > 0) == (P > 5000)   # empty pixels
    P_pad = -(-P // 128) * 128
    zb1, ib1 = outres.pallas_zbuf(zk, fp, P_pad)
    ref1 = outres.zbuffer_outres_plain(zk, fp, P_pad)
    assert torch.equal(zb1.reshape(-1), ref1[:, 1]) and torch.equal(ib1.reshape(-1), ref1[:, 0])
    assert (outres.KERNEL.launches, outres.P2.launches, outres.P1.launches) == (
        before[0] + 2, before[1] + 1, before[2] + 1)


def test_outres_wrapper_rejects_bad_inputs(cuda):
    zk = torch.zeros(2048, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="CUDA tensor"):
        outres.zbuffer_outres(zk, zk.cpu(), 4096, outres.P2)
    with pytest.raises(ValueError, match="int32"):
        outres.zbuffer_outres(zk.long(), zk, 4096, outres.P2)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        outres.outres(zk[:-1], zk[:-1], 4000)
    with pytest.raises(ValueError, match="outside the buffer"):
        outres.pallas_zbuf(zk, zk - 1, 4096)


def test_render_view_on_the_card_matches_the_cpu(cuda):
    """The renderer on the card (K1 for the fast method) equals its run on
    the CPU, at a mapping pose of a small map, for both methods."""
    cam, params = tiny_cam(), PipelineParams(fuse_thresh_factor=0.05)
    mapper = SurfelMapper(cam, params, MapConfig(capacity=1 << 16), device="cpu")
    scene = SyntheticScene(cam)
    for i in range(4):
        mapper.process_frame(*scene.frame(i))
    smap, pose = mapper.smap, scene.pose(2)
    for method in ("fast", "exact"):
        n = k1.KERNEL.launches
        got = render_view(smap, pose, cam, block_size=256, start_blocks=4, method=method,
                          device=cuda)
        assert k1.KERNEL.launches - n == (method == "fast")
        want = render_view(smap, pose, cam, block_size=256, start_blocks=4, method=method,
                           device="cpu")
        for key in ("rgb", "semantic", "depth", "id", "n_active_blocks"):
            assert torch.equal(got[key].cpu(), want[key]), (method, key)
        assert float((want["id"] >= 0).float().mean()) > 0.03
