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
from surfelmapping_tpu_torch.ops import splat
from surfelmapping_tpu_torch.ops.colors import encode_color
from surfelmapping_tpu_torch.pipeline import SurfelMapper
from surfelmapping_tpu_torch.surfels import COLUMNS, empty_map

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
