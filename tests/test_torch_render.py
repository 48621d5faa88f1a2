"""Port parity, the novel-view renderer: the port's splat_render,
splat_render_fast, cull_for_render, render_view and viz.render_map_view on
the CPU (every kernel's plain version) against the JAX package's, plus the
port-only counterparts of the property checks in tests/test_render.py.

One small map is built per module by the port's CPU mapper (tiny_cam 128x96,
4 frames, fuse_thresh_factor 0.05) and handed to the JAX package as the same
columns through numpy.  The JAX side runs with jit disabled: inside a jitted
program XLA's CPU compiler contracts multiply-adds into FMAs, which moves
intersections by an ulp and flips winners on the disc boundary; op by op,
XLA rounds each product as PyTorch does.  The port takes its float32 square
roots correctly rounded (ops/transforms.py:ieee_sqrt), as XLA does.  With
that, every image is compared exactly, at a mapping pose (a pure
translation, so both packages invert it exactly).

One documented divergence: the JAX dilation masks the key but not the id of
a disc stamp that reads from outside the image, so an uncovered border pixel
can take a wrapped-around id with key INT32_MAX (a hit with NaN depth).  The
port leaves it a hole.  The comparisons exclude exactly such pixels and
require holes there; ``test_stamps_from_outside_the_image_leave_holes``
provokes the case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfelmapping_tpu import surfels as jsurfels
from surfelmapping_tpu import viz as jviz
from surfelmapping_tpu.io.synthetic import tiny_cam as jtiny_cam
from surfelmapping_tpu.ops import splat as jsplat
from surfelmapping_tpu_torch import convert, viz
from surfelmapping_tpu_torch.config import MapConfig, PipelineParams
from surfelmapping_tpu_torch.io.synthetic import SyntheticScene, tiny_cam
from surfelmapping_tpu_torch.metrics import psnr
from surfelmapping_tpu_torch.ops import active
from surfelmapping_tpu_torch.ops import disc_dilate as dd
from surfelmapping_tpu_torch.ops import splat
from surfelmapping_tpu_torch.ops import visible_blocks as vb
from surfelmapping_tpu_torch.ops.colors import encode_color
from surfelmapping_tpu_torch.pipeline import SurfelMapper
from surfelmapping_tpu_torch.ops.transforms import invert_se3
from surfelmapping_tpu_torch.surfels import COLUMNS, empty_map
from surfelmapping_tpu_torch.tools.cull_cases import MARGIN, MAX_DEPTH, cull_case
from surfelmapping_tpu_torch.tools.dilate_cases import CASES as DILATE_CASES
from surfelmapping_tpu_torch.tools.dilate_cases import dilate_case
from surfelmapping_tpu_torch.utils import tracing

CAM = tiny_cam(128, 96)
IMAGES = ("rgb", "semantic", "depth", "id")


@pytest.fixture(scope="module")
def mapped():
    """(port map, JAX map, frames) of 4 fused frames, at capacity 2048."""
    m = SurfelMapper(CAM, PipelineParams(fuse_thresh_factor=0.05), MapConfig(capacity=1 << 14),
                     device="cpu")
    scene = SyntheticScene(CAM)
    frames = [scene.frame(i) for i in range(4)]
    for f in frames:
        m.process_frame(*f)
    cols, n = convert.map_to_numpy(m.smap)
    assert 200 < n <= 2048
    # cut to 2048 slots: the JAX side's cost, op by op, scales with capacity
    cols = {k: v[:2048] for k, v in cols.items()}
    smap = convert.map_from_numpy(cols, n, "cpu")
    jmap = jsurfels.SurfelMap(**{k: jnp.asarray(v) for k, v in cols.items()},
                              count=jnp.int32(n))
    return smap, jmap, frames


def assert_same_images(got: dict, want: dict, min_cover: float = 0.03) -> None:
    """Every image equal, except at the JAX border quirk's pixels (NaN depth
    there), which must be holes in the port; at least ``min_cover`` of the
    pixels hit."""
    want = {k: np.asarray(want[k]) for k in IMAGES}
    got = {k: got[k].numpy() for k in IMAGES}
    quirk = np.isnan(want["depth"])
    assert (got["id"][quirk] == -1).all() and (got["semantic"][quirk] == 0).all()
    for k in IMAGES:
        np.testing.assert_array_equal(got[k][~quirk], want[k][~quirk], err_msg=k)
    assert (got["id"] >= 0).mean() >= min_cover, "the test view must be covered"


@pytest.mark.parametrize("footprint,small,large_frac",
                         [(3, None, 8), (5, None, 8), (3, 2, 4), (5, 2, 8)])
@jax.disable_jit()
def test_splat_render_matches_jax(mapped, footprint, small, large_frac):
    """Single window and bucketed; at large_frac 8 the 256-slot side table
    overflows, and the overflowed splats render cropped, as in JAX."""
    smap, jmap, frames = mapped
    T = frames[2][3]
    got = splat.splat_render(smap, torch.from_numpy(T), CAM, footprint=footprint,
                             small_footprint=small, large_frac=large_frac)
    want = jsplat.splat_render(jmap, jnp.asarray(T), jtiny_cam(), footprint=footprint,
                               small_footprint=small, large_frac=large_frac)
    assert_same_images(got, want)
    overflow = int(got["large_overflow"])
    assert overflow == int(want["large_overflow"])
    assert (overflow > 0) == (small is not None and large_frac == 8)


@jax.disable_jit()
def test_splat_render_fast_matches_jax(mapped):
    smap, jmap, frames = mapped
    T = frames[2][3]
    got = splat.splat_render_fast(smap, torch.from_numpy(T), CAM, footprint=5)
    want = jsplat.splat_render_fast(jmap, jnp.asarray(T), jtiny_cam(), footprint=5)
    assert_same_images(got, want)
    assert int(got["large_overflow"]) == int(want["large_overflow"])


@pytest.mark.parametrize("num_blocks", [2, 64])
@jax.disable_jit()
def test_cull_for_render_matches_jax(mapped, num_blocks):
    """The chosen blocks (a truncating budget keeps the newest), the global
    ids and the active count."""
    smap, jmap, frames = mapped
    T = frames[2][3]
    culled, gids, n_active = splat.cull_for_render(smap, torch.from_numpy(T), CAM,
                                                   num_blocks, block_size=32, margin=7)
    jculled, jgids, jn = jsplat.cull_for_render(jmap, jnp.asarray(T), jtiny_cam(),
                                                num_blocks, block_size=32, margin=7)
    assert int(n_active) == int(jn) > 2
    np.testing.assert_array_equal(gids.numpy(), np.asarray(jgids))
    assert culled.capacity == jculled.capacity == num_blocks * 32
    assert int(culled.count) == int(jculled.count)
    for k in COLUMNS:
        want = np.asarray(getattr(jculled, k))
        np.testing.assert_array_equal(culled.column(k).numpy(),
                                      want.view(np.int32) if k == "colorsem" else want, err_msg=k)


@pytest.mark.parametrize("method", ["fast", "exact"])
@pytest.mark.parametrize("block_size", [256, 32])
@jax.disable_jit()
def test_render_view_matches_jax(mapped, method, block_size):
    """Cull + render with a budget hint of 4 blocks: at 256-slot blocks it
    suffices, at 32-slot blocks the budget grows; the ids come back as map
    slot ids either way."""
    smap, jmap, frames = mapped
    T = frames[2][3]
    got = splat.render_view(smap, T, CAM, block_size=block_size, start_blocks=4,
                            method=method, device="cpu")
    want = jsplat.render_view(jmap, jnp.asarray(T), jtiny_cam(), block_size=block_size,
                              start_blocks=4, method=method)
    assert_same_images(got, want)
    assert int(got["n_active_blocks"]) == int(want["n_active_blocks"])
    assert (got["budget_retries"] > 0) == (block_size == 32)
    assert got["id"].dtype == torch.int32


@pytest.mark.parametrize("mode", ["rgb", "semantic", "normal", "mono", "confidence", "depth"])
@jax.disable_jit()
def test_render_map_view_matches_jax(mapped, mode):
    smap, jmap, frames = mapped
    T = frames[2][3]
    got = viz.render_map_view(smap, T, CAM, mode=mode, footprint=3)
    want = jviz.render_map_view(jmap, T, jtiny_cam(), mode=mode, footprint=3)
    assert got.dtype == np.uint8 and got.shape == (CAM.height, CAM.width, 3)
    np.testing.assert_array_equal(got, want)


@jax.disable_jit()
def test_stamps_from_outside_the_image_leave_holes():
    """One small surfel centred in the last column: JAX's dilation wraps its
    id into the first column with key INT32_MAX (NaN depth, a coloured
    'hit'); the port's stamps from outside the image contribute nothing."""
    # the fixture's capacity, so the JAX side reuses the ops it compiled there
    cols = {k: np.zeros(2048, np.float32) for k in COLUMNS}
    for k, v in dict(px=6.36, pz=10.0, nz=-1.0, conf=2.0, radius=0.05).items():
        cols[k][0] = v
    bits = encode_color(torch.tensor([0.5, 0.25, 1.0]), torch.tensor(2)).numpy()
    cols["colorsem"] = np.full(2048, bits, np.int32).view(np.float32)
    smap = convert.map_from_numpy(cols, 1, "cpu")
    jmap = jsurfels.SurfelMap(**{k: jnp.asarray(v) for k, v in cols.items()}, count=jnp.int32(1))
    got = splat.splat_render_fast(smap, torch.eye(4), CAM)
    want = jsplat.splat_render_fast(jmap, jnp.eye(4, dtype=jnp.float32), jtiny_cam())
    ids = got["id"].numpy()
    assert (ids[:, CAM.width - 2:] == 0).sum() == 6   # the 3x3 disc's in-image part
    assert (ids[:, 0] == -1).all() and np.isfinite(got["depth"].numpy()).all()
    quirk = np.isnan(np.asarray(want["depth"]))
    assert quirk[:, 0].sum() == 3 and (np.asarray(want["id"])[quirk] == 0).all()
    assert_same_images(got, want, min_cover=0.0)


# ---- the port's own properties (tests/test_render.py) ---------------------

def test_render_depth_matches_input(mapped):
    smap, _, frames = mapped
    _, d, _, T = frames[1]
    depth = splat.splat_render(smap, torch.from_numpy(T), CAM, footprint=3)["depth"].numpy()
    d_m = d.astype(np.float32) / 1000.0
    # only the near field right of the 80-px stereo border is ever ingested
    cand = (d_m > 1.5) & (d_m < 6.0)
    cand[:, :80] = False
    mask = (depth > 0) & cand
    assert mask.sum() > 0.3 * cand.sum()
    assert np.median(np.abs(depth[mask] - d_m[mask])) < 0.3


def test_render_semantic_offset_and_holes(mapped):
    smap, _, frames = mapped
    _, _, s, T = frames[1]
    out = splat.splat_render(smap, torch.from_numpy(T), CAM, footprint=3)
    sem = out["semantic"].numpy()
    vals = np.unique(sem)
    assert 0 in vals
    assert {int(v) - 1 for v in vals if v} <= set(np.unique(s).tolist())
    assert ((out["id"].numpy() == -1) == (sem == 0)).all()
    rgb = out["rgb"].numpy()[sem > 0]
    assert rgb.min() >= 0.0 and rgb.max() <= 1.0 and (rgb.sum(-1) > 0).mean() > 0.95
    for render in (splat.splat_render, splat.splat_render_fast):
        empty = render(empty_map(64, "cpu"), torch.eye(4), CAM, footprint=3)
        assert int(empty["semantic"].sum()) == 0 and int(empty["id"].max()) == -1


def test_culled_render_reproduces_the_full_map_render(mapped):
    smap, _, frames = mapped
    T = frames[2][3]
    for method, full in (("exact", splat.splat_render(smap, torch.from_numpy(T), CAM,
                                                      small_footprint=None)),
                         ("fast", splat.splat_render_fast(smap, torch.from_numpy(T), CAM))):
        culled = splat.render_view(smap, T, CAM, block_size=256, start_blocks=1,
                                   method=method, device="cpu")
        for k in IMAGES:
            assert torch.equal(culled[k], full[k]), (method, k)


def test_fast_splatter_matches_exact_renderer(mapped):
    smap, _, frames = mapped
    T = torch.from_numpy(frames[2][3])
    exact = splat.splat_render(smap, T, CAM, footprint=5)
    fast = splat.splat_render_fast(smap, T, CAM, footprint=5)
    he, hf = exact["semantic"].numpy() > 0, fast["semantic"].numpy() > 0
    both = he & hf
    assert abs(he.mean() - hf.mean()) < 0.05
    assert both.sum() > 0.9 * he.sum()
    assert psnr(fast["rgb"].numpy(), exact["rgb"].numpy(), both) > 25.0
    derr = np.abs(fast["depth"].numpy() - exact["depth"].numpy())[both]
    assert np.median(derr) < 0.05


def test_render_psnr_parity(mapped):
    smap, _, frames = mapped
    rgb, d, _, T = frames[2]
    out = splat.splat_render(smap, torch.from_numpy(T), CAM, footprint=3)
    hits = out["semantic"].numpy() > 0
    d_m = d.astype(np.float64) / 1000.0
    ingestible = (d_m > 1.5) & (d_m < 6.0)
    ingestible[:, :80] = False
    assert hits[ingestible].mean() > 0.3
    assert psnr(out["rgb"].numpy(), rgb.astype(np.float64) / 255.0, hits) > 20.0


# ---- the dilation: the disc stamps, the plain loop, the dispatch ----------

@pytest.mark.parametrize("R,n", [(0, 1), (1, 9), (2, 21), (3, 37), (5, 97)])
def test_disc_stamps_follow_the_disc_rule(R, n):
    stamps = dd.disc_stamps(R)
    assert len(stamps) == n == len(set(stamps))
    assert set(stamps) == {(dj, di) for dj in range(-R - 1, R + 2) for di in range(-R - 1, R + 2)
                           if dj * dj + di * di <= (R + 0.5) ** 2}
    assert stamps == tuple(sorted(stamps))  # row by row


def test_stamp_table_rows_are_the_disc_stamps():
    """The kernel's table (ops/disc_dilate.stamp_table) holds each class's
    disc_stamps as one run of offsets per row, and refuses what the kernel
    cannot take."""
    classes = (1, 2, 3, 5)
    t = dd.stamp_table(classes)
    assert t.nc == 4 and list(t.radius[:4]) == list(classes)
    for c, R in enumerate(classes):
        rows = [(r - R, t.lo[t.row0[c] + r], t.hi[t.row0[c] + r]) for r in range(2 * R + 1)]
        assert tuple((dj, di) for dj, lo, hi in rows for di in range(lo, hi + 1)) == \
            dd.disc_stamps(R)
    assert t.row0[3] + 11 == sum(2 * R + 1 for R in classes)
    for bad in ((), (1,) * 9, (-1,), (128,), (100, 100, 100, 100, 100, 100)):
        with pytest.raises(ValueError):
            dd.stamp_table(bad)


def _brute_force_dilation(packed: np.ndarray, classes) -> np.ndarray:
    """Per pixel, the smallest word among the centres of every class whose
    disc (distance <= R + 0.5) covers it; the empty word if none."""
    _, H, W = packed.shape
    out = np.full((H, W), splat.EMPTY_WORD, np.int64)
    yy, xx = np.mgrid[0:H, 0:W]
    for y in range(H):
        for x in range(W):
            for c, R in enumerate(classes):
                near = (yy - y) ** 2 + (xx - x) ** 2 <= (R + 0.5) ** 2
                out[y, x] = min(out[y, x], packed[c][near].min())
    return out


@pytest.mark.parametrize("classes,H,W", [((1, 2, 3, 5), 19, 23), ((5,), 7, 5), ((1,), 1, 1),
                                         ((0, 2), 6, 9)])
@pytest.mark.parametrize("case", DILATE_CASES)
def test_dilate_on_the_cpu_matches_brute_force(case, classes, H, W):
    """_dilate's plain loop against a per-pixel search over every centre:
    centres on the border, equal keys with other ids, signed keys, empty
    classes; the (key, id) views of the merged words."""
    packed = dilate_case(case, len(classes), H, W, seed=len(classes) + H)
    want = _brute_force_dilation(packed.numpy(), classes)
    cam = tiny_cam(W, H)
    keys, ids = splat._dilate(packed.reshape(-1), classes, cam)
    assert np.array_equal(splat.dilate_plain(packed, classes).numpy(), want)
    assert np.array_equal(keys.numpy(), (want >> 32).reshape(-1))
    assert np.array_equal(ids.numpy(), (want & 0xFFFFFFFF).reshape(-1))
    if case == "all_empty" or case == "empty_class" and len(classes) == 1:
        assert (want == splat.EMPTY_WORD).all()
    else:
        assert (want != splat.EMPTY_WORD).any()


def test_dilate_on_the_cpu_runs_the_plain_loop(monkeypatch):
    """CPU tensors never reach the kernel's wrapper: no launch, no
    ``render.dilate_kernel`` count."""
    def kernel(*_):
        raise AssertionError("the CUDA kernel's wrapper was called for CPU tensors")

    monkeypatch.setattr(splat, "disc_dilate", kernel)
    classes = (1, 2, 3, 5)
    packed = dilate_case("sparse", 4, 24, 40)
    before = dd.KERNEL.launches
    tracing.enable()
    try:
        keys, ids = splat._dilate(packed.reshape(-1), classes, tiny_cam(40, 24))
        counted = [r for r in tracing.records() if r.name == "render.dilate_kernel"]
    finally:
        tracing.enable(False)
    assert dd.KERNEL.launches == before and counted == []
    want = splat.dilate_plain(packed, classes)
    assert torch.equal((keys.long() << 32) | (ids.long() & 0xFFFFFFFF), want.reshape(-1))


def test_dilate_kernel_wrapper_refuses_cpu_tensors():
    packed = dilate_case("sparse", 4, 8, 8)
    before = dd.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        dd.disc_dilate(packed, (1, 2, 3, 5))
    assert dd.KERNEL.launches == before


def test_cull_on_the_cpu_runs_the_plain_form(monkeypatch):
    """CPU tensors never reach the cull kernel's wrapper: no launch, no
    ``render.cull_kernel`` count, and the blocks chosen (over a budget they
    overflow) are those of the plain form's block mask."""
    def kernel(*_):
        raise AssertionError("the CUDA kernel's wrapper was called for CPU tensors")

    monkeypatch.setattr(splat, "visible_blocks", kernel)
    case = cull_case("random", 1 << 14, 32, seed=4)
    smap = case.surfel_map()
    before = vb.KERNEL.launches
    tracing.enable()
    try:
        _, gids, n_active = splat.cull_for_render(smap, case.view, case.cam, 64, block_size=32,
                                                  max_depth=MAX_DEPTH, margin=MARGIN)
        counted = [r for r in tracing.records() if r.name == "render.cull_kernel"]
    finally:
        tracing.enable(False)
    assert vb.KERNEL.launches == before and counted == []
    blk_act = vb.visible_blocks_plain(*case.columns(), invert_se3(case.view), case.cam, 32,
                                      MAX_DEPTH, MARGIN)
    blk, n = active.choose_from_blocks(blk_act, 64)
    assert int(n_active) == int(n) > 64
    assert torch.equal(gids, active.gather_active(smap, blk, 32).global_id)


@pytest.mark.parametrize("block_size", [32, 2048])
def test_cull_plain_form_on_the_gates(block_size):
    """The plain form on slots exactly on each gate of the cull and one ulp
    to either side (tools/cull_cases.py's ``gates``): z = 1 and max_depth
    are out, the padded image's edges are in, conf must be above 0, and
    non-finite coordinates fail."""
    case = cull_case("gates", 1 << 16, block_size, seed=1)
    blk_act = vb.visible_blocks_plain(*case.columns(), invert_se3(case.view), case.cam,
                                      block_size, MAX_DEPTH, MARGIN)
    assert torch.equal(blk_act[case.gate_blocks], case.gate_visible)


@pytest.mark.parametrize("num_blocks", [4, 64])
def test_choose_blocks_from_a_slot_mask_or_its_block_mask(num_blocks):
    """choose_blocks' two halves: a slot mask and its block mask choose the
    same blocks, the newest ones where they overflow the budget."""
    G, B = 100, 32
    slot_mask = torch.from_numpy(np.random.default_rng(7).uniform(size=G * B) < 0.01)
    blk_act = active.block_any(slot_mask, B)
    assert torch.equal(blk_act, slot_mask.view(G, B).any(1))
    ids = torch.nonzero(blk_act).flatten()
    assert 4 < ids.numel() < 64
    kept = ids[-num_blocks:]
    want = torch.cat([kept, torch.full((num_blocks - kept.numel(),), G)])  # G: filler
    for blk, n_active in (active.choose_blocks(slot_mask, num_blocks, B),
                          active.choose_from_blocks(blk_act, num_blocks)):
        assert torch.equal(blk, want) and int(n_active) == ids.numel()


def test_cull_kernel_wrapper_refuses_cpu_tensors():
    case = cull_case("random", 1 << 12, 32)
    before = vb.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        vb.visible_blocks(*case.columns(), invert_se3(case.view), case.cam, 32, MAX_DEPTH,
                          MARGIN)
    assert vb.KERNEL.launches == before
