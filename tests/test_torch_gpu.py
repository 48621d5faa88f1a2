"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions, and the main path, the renderer, tracking, the SPADE
enhancer and trainer, the dataset CLI and the local model on the card
against the CPU.

Every test here needs a CUDA card: it carries the ``gpu`` marker and skips
without one.  The file imports neither JAX nor the JAX package, so it also
runs on a machine that has only PyTorch, without the suite's conftest:

    python -m pytest --noconftest -o addopts= -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

from surfelmapping_tpu_torch.config import CameraIntrinsics, MapConfig, PipelineParams
from surfelmapping_tpu_torch.io.synthetic import (STENCIL_CASES, SyntheticScene, kitti_cam,
                                                  stencil_frame, tiny_cam)
from surfelmapping_tpu_torch.ops import active
from surfelmapping_tpu_torch.ops import associate_merge as am
from surfelmapping_tpu_torch.ops import disc_dilate as dd
from surfelmapping_tpu_torch.ops import preprocess_stencil as k2
from surfelmapping_tpu_torch.ops import visible_blocks as vb
from surfelmapping_tpu_torch.ops import zbuf as k1
from surfelmapping_tpu_torch.ops import zbuf_outres as outres
from surfelmapping_tpu_torch.ops.index_map import INT32_MAX
from surfelmapping_tpu_torch.ops import frame_surfels as fs
from surfelmapping_tpu_torch.ops.colors import unit_rgb
from surfelmapping_tpu_torch.ops.preprocess import (metricize_depth, remove_movings,
                                                    stencil_chain_plain)
from surfelmapping_tpu_torch.ops import splat
from surfelmapping_tpu_torch.ops.splat import render_view
from surfelmapping_tpu_torch import ba, build_map, convert, icp, spade_test, spade_train, surfels
from surfelmapping_tpu_torch.io import native
from surfelmapping_tpu_torch.io.kitti import KittiReader, write_kitti_dir
from surfelmapping_tpu_torch.models import checkpoint
from surfelmapping_tpu_torch.models.pix2pix import (SpadeConfig, SpadeTrainer, init_state_numpy,
                                                    init_variables)
from surfelmapping_tpu_torch.ops import transforms
from surfelmapping_tpu_torch.tools.cull_cases import CASES as CULL_CASES
from surfelmapping_tpu_torch.tools.cull_cases import MARGIN, MAX_DEPTH, cull_case
from surfelmapping_tpu_torch.tools.compare import (flat, float32_gradients_held,
                                                   float32_steps_held, gap_summary, grad_gaps,
                                                   step_gaps)
from surfelmapping_tpu_torch.ops.active import table_from_map
from surfelmapping_tpu_torch.ops.transforms import compose, invert_se3
from surfelmapping_tpu_torch.pipeline import SurfelMapper
from surfelmapping_tpu_torch.tools.assoc_cases import CASES as ASSOC_CASES
from surfelmapping_tpu_torch.tools.assoc_cases import association_case, differing_columns
from surfelmapping_tpu_torch.tools.dilate_cases import CASES as DILATE_CASES
from surfelmapping_tpu_torch.tools.dilate_cases import dilate_case
from surfelmapping_tpu_torch.tools.timing import ORDERS, ordered_candidates
from surfelmapping_tpu_torch.utils import tracing

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


@pytest.mark.parametrize("form", ["none", "zero", "mid", "all", "misaligned"])
def test_zbuffer_kernel_n_valid_and_packed_words(form, cuda):
    """K1 with a 0-d n_valid tensor (0, mid, A) or none: one launch, exact
    packed words, strided key and id views; a misaligned view of the
    candidates takes the kernel's 4-byte loads."""
    zkey, fpix, P, _ = _zbuf_case("kitti")
    A = zkey.shape[0]
    zk, fp = torch.from_numpy(zkey).to(cuda), torch.from_numpy(fpix).to(cuda)
    nv = {"none": A, "zero": 0, "mid": 700_001, "all": A, "misaligned": 5}[form]
    n_valid = None if form == "none" else torch.tensor(nv, dtype=torch.int32, device=cuda)
    if form == "misaligned":
        zk, fp = (torch.cat([t[:1], t])[1:] for t in (zk, fp))
        assert zk.data_ptr() % 16 and fp.data_ptr() % 16
    before = k1.KERNEL.launches
    packed = k1.zbuffer_argmin_packed(zk, fp, P, n_valid)
    assert k1.KERNEL.launches == before + 1
    zr, ir = k1.zbuffer_argmin_plain(zk, fp, P, torch.arange(A, device=cuda) < nv)
    assert torch.equal(packed, (zr.long() << 32) | ir.long())
    zb, ib = k1.key_id_views(packed)
    assert torch.equal(zb, zr) and torch.equal(ib, ir) and zb.stride() == (2,)
    assert int((ib != INT32_MAX).sum()) == (0 if nv == 0 else int((ir != INT32_MAX).sum()))


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


@pytest.mark.parametrize("H,W,border,radius,cls", STENCIL_CASES)
def test_stencil_kernel_matches_plain(H, W, border, radius, cls, cuda):
    cam = CameraIntrinsics(fx=100.0, fy=100.0, cx=W / 2, cy=H / 2, width=W, height=H)
    params = PipelineParams(stereo_border=border, smooth_radius=radius)
    depth, sem = stencil_frame(H, W, np.random.default_rng(0), cls)
    metric, semantic = torch.from_numpy(depth).to(cuda), torch.from_numpy(sem).to(cuda)
    got = k2.preprocess_stencil(metric, semantic, cam, params)
    want = stencil_chain_plain(metric, semantic, cam, params)
    assert torch.equal(got, want)
    assert 0.05 < float((want > 0).float().mean()) < 1.0


def test_stencil_kernel_on_a_synthetic_kitti_frame(cuda):
    cam, params = kitti_cam(), PipelineParams()
    _, depth, sem, _ = SyntheticScene(cam, noise_mm=40.0).frame(5, np.random.default_rng(1))
    metric = metricize_depth(torch.from_numpy(depth.astype(np.int32)).to(cuda), cam, params)
    semantic = torch.from_numpy(sem.astype(np.int32)).to(cuda)
    got = k2.preprocess_stencil(metric, semantic, cam, params)
    want = stencil_chain_plain(metric, semantic, cam, params)
    assert torch.equal(got, want)
    assert float((got > 0).float().mean()) > 0.05


def _fusion_stage(stage, dev):
    """One stage of the fusion path on ``dev`` from one synthetic KITTI
    frame; returns its output tensors on the CPU."""
    cam, params = kitti_cam(), PipelineParams()
    scene = SyntheticScene(cam, step=0.8)
    rgb, depth, sem, pose = scene.frame(5)
    last_pose = torch.from_numpy(scene.frame(4)[3]).to(dev)
    metric = metricize_depth(torch.from_numpy(depth.astype(np.int32)).to(dev), cam, params)
    if stage == "metricize_depth":
        out = (metric,)
    elif stage in ("backproject", "central_normals"):
        out = getattr(fs, stage)(metric, cam)
    elif stage == "surfel_radius":
        nz = fs.central_normals(metric, cam)[2]
        out = (fs.surfel_radius(metric, nz, cam),)
    elif stage == "ray_geometry":
        out = fs.ray_geometry(cam, dev)
    elif stage == "remove_movings":
        semantic = torch.from_numpy(sem.astype(np.int32)).to(dev)
        filtered = stencil_chain_plain(metric, semantic, cam, params)
        T = compose(invert_se3(last_pose), torch.from_numpy(pose).to(dev))
        out = (remove_movings(filtered, semantic, filtered.roll(3, 1), T, cam, params), T)
    else:
        assert stage == "unit_rgb"
        out = (unit_rgb(torch.from_numpy(rgb).to(dev)),)
    return [t.cpu() for t in out]


@pytest.mark.parametrize("stage", ["metricize_depth", "backproject", "central_normals",
                                   "surfel_radius", "ray_geometry", "remove_movings",
                                   "unit_rgb"])
def test_fusion_stage_on_the_card_equals_the_cpu(stage, cuda):
    """Divisions by device tensors and correctly rounded square roots: the
    card's fusion stages equal the CPU's bit for bit."""
    for got, want in zip(_fusion_stage(stage, cuda), _fusion_stage(stage, "cpu")):
        assert torch.equal(got, want), (stage, int((got != want).sum()))


def test_main_path_on_the_card_matches_the_cpu(cuda):
    """Both kernels on the path, identical per-frame stats to the CPU run
    of the plain versions."""
    params = PipelineParams(fuse_thresh_factor=0.05)
    scene = SyntheticScene(tiny_cam(), step=0.4)
    card = SurfelMapper(tiny_cam(), params, MapConfig(capacity=1 << 16), device=cuda)
    cpu = SurfelMapper(tiny_cam(), params, MapConfig(capacity=1 << 16), device="cpu")
    n1, n2, n3 = k1.KERNEL.launches, k2.KERNEL.launches, am.KERNEL.launches
    for i in range(5):
        frame = scene.frame(i)
        got = {k: int(v) for k, v in card.process_frame(*frame).items()}
        assert got == {k: int(v) for k, v in cpu.process_frame(*frame).items()}, i
    assert k1.KERNEL.launches - n1 == 4
    assert k2.KERNEL.launches - n2 == 5
    assert am.KERNEL.launches - n3 == 4
    assert card.count == cpu.count > 0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(ASSOC_CASES))
def test_associate_kernel_matches_plain(case, seed, cuda):
    """The association kernel against its plain version on the card, every
    AssocFlat column bit for bit: tombstones, padding slots, slot 0, empty
    and stray index pixels, sky and moving classes, index_factor 1 and 2,
    and the KITTI shape.  One launch, one ``fuse.associate_kernel`` count."""
    args = association_case(case, cuda, seed)
    before = am.KERNEL.launches
    tracing.enable()
    try:
        got = active.associate_active(*args)
        counted = sum(r.n for r in tracing.records() if r.name == "fuse.associate_kernel")
    finally:
        tracing.enable(False)
    assert am.KERNEL.launches == before + 1 and counted == 1
    want = active.associate_active_plain(*args)
    torch.cuda.synchronize()
    assert differing_columns(got, want) == {}, case
    assert (want.mark >= 0).any() or case == "random"
    assert (want.mark == -1).any() and (want.mark == -10).any()


def test_associate_wrapper_rejects_bad_inputs(cuda):
    depth, rgb, sem, index, table, pose, T_inv, time, cam, params = association_case(
        "surface_f2", cuda)
    ft = params.fuse_thresh_factor

    def call(**kw):
        a = dict(depth=depth, rgb=rgb, semantic=sem, index_image=index, at=table, pose=pose,
                 T_inv=T_inv)
        a.update(kw)
        return am.associate_merge(**a, time=time, cam=cam, params=params, fuse_thresh=ft)

    with pytest.raises(ValueError, match="float32"):
        call(depth=depth.double())
    with pytest.raises(ValueError, match="shape"):
        call(index_image=index[::2, ::2].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        call(rgb=rgb.permute(1, 0, 2).contiguous().permute(1, 0, 2))
    with pytest.raises(ValueError, match="CUDA"):
        call(at=dataclasses.replace(table, radius=table.radius.cpu()))
    with pytest.raises(ValueError, match="int64"):
        call(index_image=index.int())


@pytest.mark.parametrize("case", DILATE_CASES)
def test_dilate_kernel_matches_plain(case, cuda):
    """The renderer's dilation on the card: one kernel launch and one
    ``render.dilate_kernel`` count, the merged words equal to the plain
    loop's bit for bit at KITTI's 370x1226 with the classes (1, 2, 3, 5)."""
    classes, H, W = (1, 2, 3, 5), 370, 1226
    packed = dilate_case(case, len(classes), H, W, seed=3, device=cuda)
    before = dd.KERNEL.launches
    tracing.enable()
    try:
        keys, ids = splat._dilate(packed.reshape(-1), classes, tiny_cam(W, H))
        counted = sum(r.n for r in tracing.records() if r.name == "render.dilate_kernel")
    finally:
        tracing.enable(False)
    assert dd.KERNEL.launches == before + 1 and counted == 1
    want = splat.dilate_plain(packed, classes).reshape(-1)
    torch.cuda.synchronize()
    assert torch.equal((keys.long() << 32) | ids.long(), want)


@pytest.mark.parametrize("classes", [(1, 2, 3, 5), (5,), (1,), (0, 2)])
@pytest.mark.parametrize("H,W", [(1, 1), (7, 5), (33, 47), (100, 129), (370, 1226)])
def test_dilate_kernel_at_ragged_shapes(H, W, classes, cuda):
    """Shapes off the 32x16 tile, a single pixel, fewer pixels than a halo."""
    for case in ("sparse", "dense"):
        packed = dilate_case(case, len(classes), H, W, seed=H + W, device=cuda)
        got = dd.disc_dilate(packed, classes)
        want = splat.dilate_plain(packed, classes)
        torch.cuda.synchronize()
        assert torch.equal(got, want), case


def test_dilate_kernel_with_a_halo_in_opted_in_shared_memory(cuda):
    """Radius 40: an 86 KB tile and halo, past the 48 KB a launch has
    without opting in; a radius whose halo does not fit is refused."""
    packed = dilate_case("sparse", 2, 50, 70, seed=1, device=cuda)
    classes = (3, 40)
    assert torch.equal(dd.disc_dilate(packed, classes), splat.dilate_plain(packed, classes))
    torch.cuda.synchronize()
    too_big = dd.max_radius(cuda) + 1
    with pytest.raises(ValueError, match="shared memory"):
        dd.disc_dilate(packed[:1].contiguous(), (too_big,))


def test_dilate_wrapper_rejects_bad_inputs(cuda):
    classes = (1, 2, 3, 5)
    packed = dilate_case("sparse", 4, 16, 24, device=cuda)
    before = dd.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        dd.disc_dilate(packed.cpu(), classes)
    with pytest.raises(ValueError, match="int64"):
        dd.disc_dilate(packed.int(), classes)
    with pytest.raises(ValueError, match="contiguous"):
        dd.disc_dilate(packed.transpose(1, 2).contiguous().transpose(1, 2), classes)
    with pytest.raises(ValueError, match="shape"):
        dd.disc_dilate(packed, (1, 2, 3))
    with pytest.raises(ValueError, match="shape"):
        dd.disc_dilate(packed.reshape(-1), classes)
    assert dd.KERNEL.launches == before


@pytest.mark.parametrize("block_size", [32, 256, 2048])
@pytest.mark.parametrize("case", CULL_CASES)
def test_cull_kernel_matches_plain(case, block_size, cuda):
    """The cull's visibility pass on the card: one kernel launch and one
    ``render.cull_kernel`` count per call, and every block's answer the
    plain form's, bit for bit, over 2^20 slots with dead, tombstoned and
    non-finite slots and slots on each gate (tools/cull_cases.py), at three
    seeds (three random poses in ``random``)."""
    for seed in range(3):
        c = cull_case(case, 1 << 20, block_size, seed=seed, device=cuda)
        T_inv = invert_se3(c.view)
        before = vb.KERNEL.launches
        tracing.enable()
        try:
            got = vb.visible_blocks(*c.columns(), T_inv, c.cam, block_size, MAX_DEPTH, MARGIN)
            counted = sum(r.n for r in tracing.records() if r.name == "render.cull_kernel")
        finally:
            tracing.enable(False)
        assert vb.KERNEL.launches == before + 1 and counted == 1
        want = vb.visible_blocks_plain(*c.columns(), T_inv, c.cam, block_size, MAX_DEPTH,
                                       MARGIN)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (seed, int((got != want).sum()))
        assert want.any() and not want.all()
        assert torch.equal(got[c.gate_blocks], c.gate_visible)


def test_cull_kernel_on_misaligned_columns(cuda):
    """Columns that start off a 16-byte boundary take the kernel's scalar
    loads: the same answers."""
    c = cull_case("random", 1 << 16, 256, seed=5, device=cuda)
    cols = []
    for t in c.columns():
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        buf[1:] = t
        cols.append(buf[1:])
    assert all(t.data_ptr() % 16 for t in cols)
    T_inv = invert_se3(c.view)
    got = vb.visible_blocks(*cols, T_inv, c.cam, 256, MAX_DEPTH, MARGIN)
    want = vb.visible_blocks_plain(*c.columns(), T_inv, c.cam, 256, MAX_DEPTH, MARGIN)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_cull_wrapper_rejects_bad_inputs(cuda):
    c = cull_case("random", 1 << 12, 32, device=cuda)
    T_inv = invert_se3(c.view)
    px, py, pz, conf = c.columns()

    def call(*cols, T=T_inv, B=32):
        return vb.visible_blocks(*cols, T, c.cam, B, MAX_DEPTH, MARGIN)

    before = vb.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        call(px.cpu(), py, pz, conf)
    with pytest.raises(ValueError, match="float32"):
        call(px, py, pz, conf.double())
    with pytest.raises(ValueError, match="contiguous"):
        call(px, py, torch.stack([pz, pz], 1)[:, 0], conf)
    with pytest.raises(ValueError, match="shape"):
        call(px, py[:-1], pz, conf)
    with pytest.raises(ValueError, match="whole blocks"):
        call(px[:-4], py[:-4], pz[:-4], conf[:-4])
    with pytest.raises(ValueError, match="block size"):
        call(px, py, pz, conf, B=100)
    with pytest.raises(ValueError, match="block size"):
        call(px, py, pz, conf, B=1536)
    with pytest.raises(ValueError, match="T_inv"):
        call(px, py, pz, conf, T=T_inv[:3])
    assert vb.KERNEL.launches == before


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


@pytest.mark.parametrize("order", ORDERS)
def test_outres_entry_points_on_the_binned_orders(order, cuda):
    """P1 and P2 against the plain version, exact, on chip_smoke's orders at
    a small size: 32,768 candidates (four bin spans) over 10,317 pixels (a
    buffer of five tiles and a ragged sixth); one launch per call."""
    num_pix, n_pix = 10_317, outres.outres_pixels(10_317)
    zk, fp = ordered_candidates(np.random.default_rng(1), num_pix, 4 * 8192, order, cuda)
    ref = outres.zbuffer_outres_plain(zk, fp, n_pix)
    before = (outres.KERNEL.launches, outres.P2.launches, outres.P1.launches)
    zb, ib = outres.outres(zk, fp, num_pix)
    assert torch.equal(zb, ref[:num_pix, 1]) and torch.equal(ib, ref[:num_pix, 0])
    zb1, ib1 = outres.pallas_zbuf(zk, fp, n_pix)
    assert torch.equal(zb1.reshape(-1), ref[:, 1]) and torch.equal(ib1.reshape(-1), ref[:, 0])
    assert (outres.KERNEL.launches, outres.P2.launches, outres.P1.launches) == (
        before[0] + 2, before[1] + 1, before[2] + 1)


BINNED_CASES = ["ragged", "empty", "all_invalid", "outside", "misaligned", "many_blocks",
                "wide_tiles"]


@pytest.mark.parametrize("case", BINNED_CASES)
def test_binned_kernel_edge_cases(case, cuda):
    """The kernel through ``zbuffer_outres`` against the plain version, exact:
    A not a multiple of a bin span (nor of 4), A = 0, every key INT32_MAX,
    pixels outside the buffer (never written), inputs off 16-byte alignment
    (4-byte loads), more bin blocks than a resolve block tables at once, and
    a sparse buffer whose tiles need more than 48 KB of shared memory."""
    n_pix, A = 5 * 2048 + 77, 4 * outres.SPAN
    if case == "many_blocks":  # a resolve block tables 512 bin blocks' segments at once
        A = 513 * outres.SPAN + 5
    elif case == "wide_tiles":
        n_pix, A = outres.MAX_TILES * 2048 + 5, 8192
    zk, fp = ordered_candidates(np.random.default_rng(2), n_pix, A, "random", cuda)
    valid_key, valid_pix = zk, fp
    if case == "ragged":
        zk, fp = zk[:A - 1000 + 3], fp[:A - 1000 + 3]
        valid_key, valid_pix = zk, fp
    elif case == "empty":
        zk, fp = zk[:0], fp[:0]
        valid_key, valid_pix = zk, fp
    elif case == "all_invalid":
        zk = valid_key = torch.full_like(zk, INT32_MAX)
    elif case == "outside":
        fp = fp.clone()
        fp[::5], fp[1::7] = -1, n_pix + 3
        outside = (fp < 0) | (fp >= n_pix)
        valid_key = torch.where(outside, INT32_MAX, zk)
        valid_pix = torch.where(outside, n_pix, fp)
    elif case == "misaligned":
        zk, fp = (torch.cat([t[:1], t])[1:] for t in (zk, fp))
        assert zk.data_ptr() % 16 and fp.data_ptr() % 16
        valid_key, valid_pix = zk, fp
    plan = outres.outres_plan(zk.shape[0], n_pix)
    if case == "wide_tiles":  # more than the 48 KB a launch gets without asking
        assert plan.tile_smem > 48 * 1024
    if case == "many_blocks":
        assert plan.bin_blocks > 512
    before = (outres.KERNEL.launches, outres.P2.launches)
    got = outres.zbuffer_outres(zk, fp, n_pix, outres.P2)
    assert (outres.KERNEL.launches, outres.P2.launches) == (before[0] + 1, before[1] + 1)
    ref = outres.zbuffer_outres_plain(valid_key, valid_pix, n_pix)
    assert torch.equal(got, ref)
    if case in ("empty", "all_invalid"):
        assert (got == INT32_MAX).all()


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
        n, nd, nc = k1.KERNEL.launches, dd.KERNEL.launches, vb.KERNEL.launches
        got = render_view(smap, pose, cam, block_size=256, start_blocks=4, method=method,
                          device=cuda)
        assert k1.KERNEL.launches - n == dd.KERNEL.launches - nd == (method == "fast")
        assert vb.KERNEL.launches - nc == 1 + got["budget_retries"]  # one launch per cull
        want = render_view(smap, pose, cam, block_size=256, start_blocks=4, method=method,
                           device="cpu")
        for key in ("rgb", "semantic", "depth", "id", "n_active_blocks"):
            assert torch.equal(got[key].cpu(), want[key]), (method, key)
        assert float((want["id"] >= 0).float().mean()) > 0.03


def _random_poses(n, seed=0):
    rng = np.random.default_rng(seed)
    out = np.zeros((n, 4, 4), np.float32)
    for T in out:
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        q[:, 0] *= np.sign(np.linalg.det(q))
        T[:3, :3], T[:3, 3], T[3, 3] = q, rng.uniform(-20, 20, 3), 1.0
    return torch.from_numpy(out)


def test_pose_math_on_the_card_equals_the_cpu(cuda):
    """The FMA-chain products, the float64 acos and the SE(3) maps built on
    them give the same bits on the card as on the CPU."""
    A, B = _random_poses(200, 0), _random_poses(200, 1)
    for a, b in zip(A, B):
        assert torch.equal(compose(a.to(cuda), b.to(cuda)).cpu(), compose(a, b))
        assert torch.equal(invert_se3(a.to(cuda)).cpu(), invert_se3(a))
    assert torch.equal(compose(A.to(cuda), B.to(cuda)).cpu(), compose(A, B))
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, 1 << 20).astype(np.float32))
    assert torch.equal(transforms.acos(x.to(cuda)).cpu(), transforms.acos(x))
    xi = torch.from_numpy(np.random.default_rng(3).normal(0, 0.3, (500, 6)).astype(np.float32))
    for fn, arg in ((transforms.exp_se3, xi), (transforms.log_se3, A),
                    (transforms.adjoint_se3, A)):
        assert torch.equal(fn(arg.to(cuda)).cpu(), fn(arg)), fn.__name__


def _tracking_case():
    """A 5-frame CPU map of tests/test_ba.py's 128x96 scene (fronto-parallel
    boxes; no stereo border, so the whole width ingests) and the scene."""
    cam, params = tiny_cam(), PipelineParams(fuse_thresh_factor=0.05, stereo_border=0.0)
    scene = SyntheticScene(cam, step=0.4, car_center=(4.5, 0.8, 13.0), extra_boxes=(
        ((-4.0, 0.6, 11.0), (1.0, 1.0, 1.5)), ((0.5, 0.7, 18.0), (1.2, 0.9, 1.0)),
        ((-2.0, 0.4, 24.0), (1.0, 1.2, 1.0))))
    mapper = SurfelMapper(cam, params, MapConfig(capacity=1 << 16), device="cpu")
    for i in range(5):
        mapper.process_frame(*scene.frame(i))
    return cam, params, scene, mapper.smap


def _depth(dev, cam, params, d, s):
    return icp.preprocess_for_icp(torch.from_numpy(d.astype(np.int32)).to(dev),
                                  torch.from_numpy(s.astype(np.int32)).to(dev), cam, params)


def _pose_gap(a, b):
    """(max translation difference m, rotation angle rad) of two poses."""
    a, b = a.cpu().double(), b.cpu().double()
    dR = a[..., :3, :3].transpose(-1, -2) @ b[..., :3, :3]
    skew = torch.stack([dR[..., 2, 1] - dR[..., 1, 2], dR[..., 0, 2] - dR[..., 2, 0],
                        dR[..., 1, 0] - dR[..., 0, 1]], dim=-1) / 2
    return (float((a[..., :3, 3] - b[..., :3, 3]).abs().max()),
            float(torch.asin(torch.clamp(skew.norm(dim=-1), max=1.0)).max()))


def test_icp_and_ba_on_the_card_match_the_cpu(cuda):
    """refine_pose and refine_window on the card (K1) against the CPU's
    plain versions on the same map and window: within 1e-5 m and 1e-5 rad,
    inliers within 0.1%."""
    cam, params, scene, smap = _tracking_case()
    _, d, s, T = scene.frame(5)
    T0 = torch.from_numpy(T.copy())
    T0[0, 3] += 0.05
    T0[2, 3] -= 0.08
    out = []
    for dev in (cuda, "cpu"):
        n = k1.KERNEL.launches
        pose, diag = icp.refine_pose(smap.to(dev), _depth(dev, cam, params, d, s), T0.to(dev),
                                     cam, params)
        out.append((pose, int(diag["inliers"]), k1.KERNEL.launches - n))
    (pc, nc, lc), (pp, npu, lp) = out
    assert (lc, lp) == (5, 0) and npu > 100
    t_gap, r_gap = _pose_gap(pc, pp)
    assert t_gap < 1e-5 and r_gap < 1e-5 and abs(nc - npu) <= 0.001 * npu

    w = ba.WindowedBA(cam, params, window=4, stride=2, device="cpu")
    at = table_from_map(smap)
    rng = np.random.default_rng(0)
    for i in range(2, 6):
        _, d, s, T = scene.frame(i)
        T = T.copy()
        T[2, 3] += rng.normal(0, 0.03)
        w.push(_depth("cpu", cam, params, d, s), T, at=at, time=float(i))
    arrays, nv = convert.window_to_numpy(w.win)
    res = []
    for dev in (cuda, "cpu"):
        win = convert.window_from_numpy(arrays, nv, dev)
        got, diag = ba.refine_window(win, table_from_map(smap.to(dev)), 5.0, cam, params,
                                     stride=2)
        res.append((got.poses, int(diag["inliers"])))
    (card_poses, card_in), (cpu_poses, cpu_in) = res
    t_gap, r_gap = _pose_gap(card_poses, cpu_poses)
    assert t_gap < 1e-5 and r_gap < 1e-5 and cpu_in > 100
    assert abs(card_in - cpu_in) <= 0.001 * cpu_in


def test_dropout_update_is_exactly_zero_on_the_card(cuda):
    """A frame without depth: 0 inliers and the initial pose exactly."""
    cam, params, scene, smap = _tracking_case()
    _, d, s, T = scene.frame(5)
    T0 = torch.from_numpy(T).to(cuda)
    pose, diag = icp.refine_pose(smap.to(cuda), _depth(cuda, cam, params, np.zeros_like(d), s),
                                 T0, cam, params)
    assert int(diag["inliers"]) == 0 and torch.equal(pose, T0)


def _random_bn_stats(tree: dict, rng) -> dict:
    """``tree`` with every BatchNorm_0 mean ~ N(0, 0.1) and var ~ U(0.5, 2)."""
    for k, v in tree.items():
        if k == "BatchNorm_0":
            v["mean"] = rng.normal(0, 0.1, v["mean"].shape).astype(np.float32)
            v["var"] = rng.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)
        elif isinstance(v, dict):
            _random_bn_stats(v, rng)
    return tree


@pytest.mark.parametrize("case", ["aspect_1.0", "aspect_3.25", "vae_style", "vae_prior"])
def test_spade_generator_on_the_card_matches_the_cpu(case, cuda):
    """The generator (and the encoder's mu) at ngf 16, crop 64, batch 2 on
    the card and on the CPU from the same weights: the image before its
    tanh within 1e-4 of its largest magnitude (float32, no TF32)."""
    vae = case.startswith("vae")
    cfg = SpadeConfig(ngf=16, ndf=16, crop_size=64, use_vae=vae,
                      aspect_ratio=3.25 if case == "aspect_3.25" else 1.0)
    rng = np.random.default_rng(0)
    v = init_variables(cfg, seed=0)
    v["batch_stats"] = _random_bn_stats(v["batch_stats"], rng)
    label = torch.from_numpy(rng.uniform(-1, 1, (2, 40, 130, 3)).astype(np.float32))
    style = (torch.from_numpy(rng.uniform(-1, 1, (2, 70, 90, 3)).astype(np.float32))
             if case == "vae_style" else None)
    got, want = (SpadeTrainer(cfg, variables=v, device=d).infer_logits(
        label, style).cpu() for d in (cuda, "cpu"))
    assert got.shape == want.shape == (2, 64 if case != "aspect_3.25" else 32, 64, 3)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert float((torch.tanh(want).abs() < 0.99).float().mean()) > 0.5


def test_spade_test_cli_on_the_card(tmp_path, cuda):
    """spade_test on the card (its default device) and on the CPU over the
    same PNGs, from a checkpoint of the port's seeded weights written in
    flax's format: the same files, u8 images within one level, rendered
    pixels kept where the semantic is not 0."""
    v = init_variables(SpadeConfig(ngf=8, crop_size=64), seed=1)
    v["batch_stats"] = _random_bn_stats(v["batch_stats"], np.random.default_rng(1))
    ckpt = tmp_path / "spade.msgpack"
    ckpt.write_bytes(checkpoint.packb({"g_params": v["params"], "g_batch_stats": v["batch_stats"],
                               "step": np.zeros((), np.int32)}))
    labels, sems = tmp_path / "image", tmp_path / "semantic"
    labels.mkdir()
    sems.mkdir()
    rng = np.random.default_rng(2)
    for fid in range(3):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
            labels / f"{fid:06d}.png")
        Image.fromarray((rng.uniform(size=(64, 64)) < 0.6).astype(np.uint8) * 5).save(
            sems / f"{fid:06d}.png")
    argv = ["--ckpt", str(ckpt), "--label-dir", str(labels), "--semantic-dir", str(sems),
            "--crop", "64", "--ngf", "8"]
    assert spade_test.main(argv + ["--out", str(tmp_path / "card")]) == 0
    assert spade_test.main(argv + ["--out", str(tmp_path / "cpu"), "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "card"))
    assert names == sorted(os.listdir(tmp_path / "cpu")) == sorted(os.listdir(labels))
    for n in names:
        got = np.asarray(Image.open(tmp_path / "card" / n)).astype(int)
        want = np.asarray(Image.open(tmp_path / "cpu" / n)).astype(int)
        assert np.abs(got - want).max() <= 1, n
        keep = np.asarray(Image.open(sems / n)) != 0
        np.testing.assert_array_equal(got[keep], np.asarray(Image.open(labels / n))[keep])


@pytest.mark.parametrize("use_vae", [False, True], ids=["plain", "vae"])
def test_spade_train_steps_on_the_card_match_the_cpu(use_vae, cuda):
    """One D step and one G step (ngf 8, crop 64, batch 2, two scales of 4
    layers, VGG on), each from the same variables and batch, on the card and
    on the CPU: the losses within 1e-4 relative in float32 and float64; in
    float32 the stored SN u/sigma and BN statistics within 1e-5 of their
    largest magnitude, and the gradients (Adam's mu, b1 = 0) as
    ``compare.float32_gradients_held`` holds them (the VAE's G step looser:
    a rounding can flip a choice ahead of its losses); in float64, where no
    rounding flips a choice, the gradients within 1e-6 of each leaf's
    scale."""
    cfg = SpadeConfig(ngf=8, ndf=8, crop_size=64, num_d=2, n_layers_d=4, use_vae=use_vae,
                      z_dim=16)
    rng = np.random.default_rng(3)
    tree = init_state_numpy(cfg)
    _random_bn_stats(tree["g_batch_stats"], rng)
    label, real = (torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32))
                   for _ in range(2))
    noise = torch.from_numpy(rng.normal(0, 1, (2, 16))) if use_vae else None

    def run(device, dtype, step):
        tr = SpadeTrainer(cfg, device=device)
        st, logs = getattr(tr, step)(tr.state_from_numpy(tree).to(dtype), label.to(dtype),
                                     real.to(dtype), noise=noise)
        return tr.state_to_numpy(st), {k: float(v) for k, v in logs.items()}

    for dtype in (torch.float32, torch.float64):
        for step, net in (("d_step", "d"), ("g_step", "g")):
            (card, card_logs), (cpu, cpu_logs) = (run(d, dtype, step) for d in (cuda, "cpu"))
            assert card_logs.keys() == cpu_logs.keys()
            for k in cpu_logs:
                assert np.isfinite(card_logs[k]) and abs(card_logs[k] - cpu_logs[k]) <= \
                    1e-4 * abs(cpu_logs[k]), (dtype, step, k)
            gaps = gap_summary(grad_gaps(*(t[f"{net}_opt"]["inner_state"]["0"]["mu"]
                                           for t in (card, cpu))))
            if dtype == torch.float32:
                a, b = flat(card[f"{net}_batch_stats"]), flat(cpu[f"{net}_batch_stats"])
                for k in b:
                    assert np.abs(a[k] - b[k]).max() <= 1e-5 * np.abs(b[k]).max(), (step, k)
                assert float32_gradients_held(gaps, use_vae and net == "g"), (step, gaps)
            else:
                assert gaps["max"] <= 1e-6, (step, gaps)
            assert int(card["step"]) == (1 if step == "g_step" else 0)


def test_spade_train_then_spade_test_on_the_card(tmp_path, cuda):
    """spade_train on the card (its default device) from label/image PNGs
    the test writes, 2 epochs of 2 steps at ngf 8, crop 64, then spade_test
    from its checkpoint: finite logged losses, a checkpoint the port reads
    back bit for bit, enhanced frames that keep the rendered pixels where
    the semantic is not 0."""
    rng = np.random.default_rng(4)
    dirs = {k: tmp_path / k for k in ("label", "image", "semantic")}
    for d in dirs.values():
        d.mkdir()
    for fid in range(3):
        name = f"{fid:06d}.png"
        Image.fromarray(rng.integers(0, 256, (72, 96, 3), dtype=np.uint8)).save(dirs["label"] / name)
        Image.fromarray(rng.integers(0, 256, (72, 96, 3), dtype=np.uint8)).save(dirs["image"] / name)
        Image.fromarray((rng.uniform(size=(72, 96)) < 0.6).astype(np.uint8) * 4).save(
            dirs["semantic"] / name)
    ckpt = tmp_path / "ckpt"
    small = ["--crop", "64", "--ngf", "8", "--num-d", "2", "--n-layers-d", "2"]
    assert spade_train.main(["--label-dir", str(dirs["label"]), "--image-dir", str(dirs["image"]),
                             "--niter", "1", "--niter-decay", "1", "--steps-per-epoch", "2",
                             "--ndf", "8", "--log-every", "1", "--ckpt-dir", str(ckpt)]
                            + small) == 0
    logged = [float(w) for ln in (ckpt / "loss_log.txt").read_text().splitlines()
              if ln.startswith("(epoch") for w in ln.split(")")[1].split()[1::2]]
    assert logged and all(np.isfinite(logged))
    raw = (ckpt / "latest.msgpack").read_bytes()
    cfg = SpadeConfig(ngf=8, ndf=8, crop_size=64, num_d=2, n_layers_d=2)
    tr = SpadeTrainer(cfg)
    assert checkpoint.packb(tr.state_to_numpy(tr.state_from_numpy(checkpoint.unpackb(raw)))) == raw
    out = tmp_path / "enhanced"
    assert spade_test.main(["--ckpt", str(ckpt / "latest.msgpack"), "--label-dir",
                            str(dirs["label"]), "--semantic-dir", str(dirs["semantic"]),
                            "--out", str(out), "--crop", "64", "--ngf", "8"]) == 0
    for name in sorted(os.listdir(dirs["label"])):
        got = np.asarray(Image.open(out / name))
        keep = np.asarray(Image.open(dirs["semantic"] / name)) != 0
        assert got.shape == (72, 96, 3)
        np.testing.assert_array_equal(got[keep], np.asarray(Image.open(dirs["label"] / name))[keep])


def _machine_decoder() -> str:
    """The native decoder where this machine can build it (g++ and libpng's
    header), else PIL: the choice chip_smoke.py makes."""
    return "pil" if native.missing_toolchain() else "native"


@pytest.fixture
def scene_dir(tmp_path):
    """A 5-frame 128x96 KITTI-layout directory of the procedural scene."""
    cam = tiny_cam(128, 96)
    scene = SyntheticScene(cam)
    write_kitti_dir(str(tmp_path / "seq"), cam, (scene.frame(i) for i in range(5)))
    return str(tmp_path / "seq"), [scene.frame(i) for i in range(5)]


def test_dataset_decoder_on_this_machine(scene_dir, tmp_path, cuda):
    """The machine's decoder reads every frame back bit-equal; where the
    native library builds here, its map IO equals the Python map IO."""
    path, frames = scene_dir
    r = KittiReader(path, decoder=_machine_decoder())
    for want in frames:
        f = r.get_next()
        for got, w in zip((f.rgb, f.depth, f.semantic, f.pose), want):
            np.testing.assert_array_equal(got, w)
    r.close()
    if r.decoder == "native":
        m = SurfelMapper(tiny_cam(128, 96), device=cuda)
        for fr in frames:
            m.process_frame(*fr)
        p_py, p_nat = str(tmp_path / "py.bin"), str(tmp_path / "nat.bin")
        m.save_map(p_py, 0, 4)
        rec, s0, s1 = native.load_map_native(p_py)
        native.save_map_native(p_nat, rec, s0, s1)
        assert open(p_py, "rb").read() == open(p_nat, "rb").read() and rec.shape[0] > 0
        loaded, _, _ = surfels.load_map(p_nat, cuda)
        np.testing.assert_array_equal(surfels.pack_records(loaded).cpu().numpy(), rec)


def test_dataset_cli_on_the_card_matches_the_cpu(scene_dir, tmp_path, cuda):
    """build_map DIR on the card writes the CPU's map bit for bit, also
    with --frames and the backward clean."""
    path, _ = scene_dir
    for extra in ([], ["--frames", "3", "--clean"]):
        outs = {}
        for dev in ("cuda", "cpu"):
            outs[dev] = str(tmp_path / f"{dev}.bin")
            assert build_map.main([path, "--out", outs[dev], "--capacity", str(1 << 16),
                                   "--decoder", _machine_decoder(), "--device", dev]
                                  + extra) == 0
        card, cpu = (open(outs[d], "rb").read() for d in ("cuda", "cpu"))
        n = int(np.frombuffer(cpu[:4], "<u4")[0])
        assert n > 100 and card == cpu


def test_local_model_on_the_card_matches_the_cpu(cuda):
    scene = SyntheticScene(tiny_cam())
    models = {}
    for dev in ("cuda", "cpu"):
        m = SurfelMapper(tiny_cam(), PipelineParams(), MapConfig(capacity=1 << 16), device=dev)
        m.process_frame(*scene.frame(0))
        models[dev] = m.local_model(*scene.frame(1))
    card, cpu = models["cuda"], models["cpu"]
    assert card.device.type == "cuda" and int(card.count) == int(cpu.count) > 0
    for k in surfels.COLUMNS:
        assert torch.equal(card.column(k).cpu(), cpu.column(k)), k


# -- the sharded engine on the card ---------------------------------------------

SHARD_JOBS = "surfelmapping_tpu_torch.tools.sharded_jobs"


def _sharded_job(job, ranks, out, device, *args):
    """A job of tools/sharded_jobs.py: gloo ranks that share the card
    (NCCL refuses two ranks on one GPU), or gloo CPU ranks."""
    from surfelmapping_tpu_torch.parallel.distributed import (python_module, spawn_cpu_processes,
                                                              spawn_ranks)

    cmd = python_module(SHARD_JOBS, job, "--out", str(out), "--device", device, *args)
    if device == "cpu":
        return spawn_cpu_processes(cmd, ranks, timeout=300)
    return spawn_ranks(cmd, ranks, "gloo", timeout=300)


def test_index_resolve_equals_k1_on_the_card(cuda):
    """K1 against the three-op z-buffer it replaced (ops/active.index_resolve),
    both on the card, at the index map's shape: exact."""
    from surfelmapping_tpu_torch.ops.active import index_resolve

    zkey, fpix, P, _ = _zbuf_case("kitti")
    zkey, fpix = torch.from_numpy(zkey).to(cuda), torch.from_numpy(fpix).to(cuda)
    for keys in (zkey, torch.where(zkey == INT32_MAX, zkey, zkey % 64)):  # many ties
        ids = torch.arange(keys.shape[0], dtype=torch.int32, device=cuda)
        want = index_resolve(keys, fpix, ids, P, empty_to_minus1=False)
        _, got = k1.zbuffer_argmin(keys, fpix, P)
        assert torch.equal(got, want)


def test_sharded_step_on_the_card_equals_the_cpu(tmp_path, cuda):
    """Two gloo ranks sharing the card run three frames of the sharded step
    from one dealt state, as two gloo CPU ranks do: every shard, count and
    stat bit for bit (the fusion path is bit-exact card vs CPU)."""
    from surfelmapping_tpu_torch.tools.sharded_jobs import dealt_state

    D, state = 2, tmp_path / "state.npz"
    counts, _ = dealt_state(state, D, 1 << 14, 0.05)
    for dev in ("cuda", "cpu"):
        _sharded_job("step", D, tmp_path / dev, dev, "--state", str(state))
    for r in range(D):
        a, b = (np.load(tmp_path / dev / f"rank{r}.npz") for dev in ("cuda", "cpu"))
        for k in b.files:
            np.testing.assert_array_equal(a[k].view(np.int32) if a[k].dtype == np.float32
                                          else a[k],
                                          b[k].view(np.int32) if b[k].dtype == np.float32
                                          else b[k], err_msg=f"rank {r} {k}")
    assert int(np.load(tmp_path / "cuda" / "rank0.npz")["count"]) > counts[0]


def test_sharded_mapper_on_the_card_matches_the_cpu(tmp_path, cuda):
    """tests/test_torch_sharded.py's long run (20 frames of removals, growth,
    compaction) with two gloo ranks sharing the card equals the same job in
    two gloo CPU ranks bit for bit; against the single-card SurfelMapper on
    the card it shares 99.5% of the records (a depth-key tie resolves by
    global id across ranks, by slot on one card, so at two ranks the counts
    drift by a few: 2441 against 2445, 2435 records shared, 0.99591, on the
    CPU; tests/test_torch_sharded.py holds the slot order as the whole
    cause, frame by frame)."""
    from collections import Counter

    args = ("--frames", "20", "--capacity", str(1 << 13), "--active-blocks", "8",
            "--block-size", "128", "--sync-every", "4", "--compact-dead-frac", "0.2",
            "--scene-step", "0.6")
    for dev in ("cuda", "cpu"):
        _sharded_job("mapper", 2, tmp_path / dev, dev, *args)
    got, cpu = (np.load(tmp_path / dev / "mapper.npz") for dev in ("cuda", "cpu"))
    for k in cpu.files:
        np.testing.assert_array_equal(got[k], cpu[k], err_msg=k)
    assert int(got["capacity"]) > 1 << 13 and int(got["dropped"]) == 0
    cam = tiny_cam(128, 64)
    single = SurfelMapper(cam, PipelineParams(stereo_border=0.0), MapConfig(capacity=1 << 16),
                          sync_every=4, device=cuda)
    scene = SyntheticScene(cam, step=0.6)
    for i in range(20):
        single.process_frame(*scene.frame(i))
    want = surfels.pack_records(single.smap)[:single.count].cpu().numpy()
    a, b = Counter(map(bytes, got["records"])), Counter(map(bytes, want))
    assert sum((a & b).values()) >= 0.995 * max(len(want), len(got["records"]))


def test_spade_dp_two_ranks_on_the_card_match_one_process(tmp_path, cuda):
    """tools/spade_dp_jobs ``steps`` at ngf 16, crop 64 (num_d 2, 4 layers,
    VGG19 on), float32: one D and one G step on a global batch of 2, in two
    gloo ranks sharing the card (one image each) and in one process, held
    as compare.float32_steps_held holds them; both ranks' states the same
    bytes."""
    import json

    from surfelmapping_tpu_torch.parallel.distributed import python_module, spawn_ranks

    rng = np.random.default_rng(0)
    for d in ("label", "image"):
        (tmp_path / d).mkdir()
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (72, 80, 3), dtype=np.uint8)).save(
                tmp_path / d / f"{i:06d}.png")
    config = json.dumps(dict(ngf=16, ndf=16, crop_size=64, num_d=2, n_layers_d=4))
    runs = {}
    for ranks in (1, 2):
        out = tmp_path / f"dp{ranks}"
        spawn_ranks(python_module("surfelmapping_tpu_torch.tools.spade_dp_jobs", "steps",
                                  "--out", str(out), "--label-dir", str(tmp_path / "label"),
                                  "--image-dir", str(tmp_path / "image"), "--batch", "2",
                                  "--config", config), ranks, "gloo", timeout=300)
        raw = [(out / f"rank{r}.msgpack").read_bytes() for r in range(ranks)]
        logs = [json.loads((out / f"rank{r}.json").read_text()) for r in range(ranks)]
        assert all(r == raw[0] for r in raw) and all(ln["ranks_identical"] for ln in logs)
        assert logs[0]["device"].startswith("cuda")
        runs[ranks] = (checkpoint.unpackb(raw[0]), logs[0]["logs"])
    gaps = step_gaps(runs[2][0], runs[1][0], runs[2][1], runs[1][1])
    assert float32_steps_held(gaps), gaps
