"""Port parity, the render path's host modules: the view generators, PSNR,
the semantic palette, the viewer helpers, and the load-map CLI, whose PNGs
must equal those of the JAX package's ``acquire_images`` on the same map and
views.  The JAX renders run with jit disabled (see tests/test_torch_render.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from surfelmapping_tpu import metrics as jmetrics
from surfelmapping_tpu import views as jviews
from surfelmapping_tpu import viz as jviz
from surfelmapping_tpu.io.synthetic import tiny_cam as jtiny_cam
from surfelmapping_tpu.ops import colors as jcolors
from surfelmapping_tpu.surfels import load_map as jload_map
from surfelmapping_tpu_torch import load_map, metrics, views, viz
from surfelmapping_tpu_torch.config import MapConfig, PipelineParams
from surfelmapping_tpu_torch.io.synthetic import SyntheticScene, tiny_cam
from surfelmapping_tpu_torch.ops import colors
from surfelmapping_tpu_torch.pipeline import SurfelMapper


def _base_views(n=6):
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        c, s = np.cos(0.1 * i), np.sin(0.1 * i)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        T[:3, 3] = rng.uniform(-3, 3, 3) + [0, 0, 1.5 * i]
        out.append(T)
    return out


def test_view_generators_match_jax():
    base = _base_views()
    for got, want in (
        (views.random_novel_views(base, 7, seed=3), jviews.random_novel_views(base, 7, seed=3)),
        (views.s_shaped_views(base, period=6.0), jviews.s_shaped_views(base, period=6.0)),
        (views.overview_views(base), jviews.overview_views(base)),
    ):
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def test_psnr_matches_jax(rng):
    a = rng.uniform(0, 1, (9, 11, 3))
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1)
    mask = rng.uniform(size=(9, 11)) < 0.5
    for m in (None, mask):
        assert metrics.psnr(a, b, m) == jmetrics.psnr(a, b, m)
    assert metrics.psnr(a, a) == float("inf")


def test_semantic_palette_and_viewer_helpers_match_jax(rng):
    sem = rng.integers(-2, 22, (5, 7)).astype(np.int32)   # out-of-range ids clamp
    np.testing.assert_array_equal(colors.semantic_to_rgb(torch.from_numpy(sem)).numpy(),
                                  np.asarray(jcolors.semantic_to_rgb(jnp.asarray(sem))))
    np.testing.assert_array_equal(colors.SEMANTIC_PALETTE.numpy(), jcolors.SEMANTIC_PALETTE)
    np.testing.assert_array_equal(viz.semantic_image(sem), jviz.semantic_image(sem))
    depth = rng.uniform(-1, 40, (6, 8)).astype(np.float32)
    np.testing.assert_array_equal(viz.normalize_depth(depth, 1.0, 30.0),
                                  jviz.normalize_depth(depth, 1.0, 30.0))
    pose = _base_views()[3]
    np.testing.assert_array_equal(viz.overview_pose(pose), jviz.overview_pose(pose))


@pytest.fixture(scope="module")
def map_file(tmp_path_factory):
    """A map of 6 frames fused by the port's CPU mapper on tiny_cam 128x96,
    saved in the reference format (the CLI renders it at 256x128)."""
    path = str(tmp_path_factory.mktemp("map") / "m.bin")
    cam = tiny_cam(128, 96)
    m = SurfelMapper(cam, PipelineParams(fuse_thresh_factor=0.05), MapConfig(capacity=1 << 14),
                     device="cpu")
    scene = SyntheticScene(cam)
    for i in range(6):
        m.process_frame(*scene.frame(i))
    m.save_map(path, 0, 5)
    return path


def _pngs(directory):
    names = sorted(os.listdir(directory))
    return names, [np.asarray(Image.open(os.path.join(directory, n))) for n in names]


@jax.disable_jit()
def test_load_map_cli_matches_jax_acquire_images(map_file, tmp_path):
    """Equal PNGs, except where the JAX dilation's border quirk colours an
    uncovered pixel within the largest stamp radius (5 px) of the image
    edge (tests/test_torch_render.py): the port leaves a hole there."""
    out = str(tmp_path / "novel")
    assert load_map.main([map_file, "--synthetic", "--synthetic-cam", "small", "--num", "2",
                          "--footprint", "3", "--out", out, "--device", "cpu"]) == 0
    # the CLI's views: random perturbations of the mapped frames' poses
    jmap, start, end = jload_map(map_file)
    base = [SyntheticScene(tiny_cam(256, 128)).pose(i) for i in range(start, end + 1)]
    jout = str(tmp_path / "jax")
    jviews.acquire_images(jmap, jviews.random_novel_views(base, 2, seed=0), jout,
                          jtiny_cam(256, 128), footprint=3)
    names, sems = _pngs(os.path.join(out, "semantic"))
    jnames, jsems = _pngs(os.path.join(jout, "semantic"))
    assert names == jnames == ["000000.png", "000001.png"]
    _, rgbs = _pngs(os.path.join(out, "image"))
    _, jrgbs = _pngs(os.path.join(jout, "image"))
    for sem, jsem, rgb, jrgb in zip(sems, jsems, rgbs, jrgbs):
        differ = (sem != jsem) | (rgb != jrgb).any(-1)
        border = np.ones(sem.shape, bool)
        border[5:-5, 5:-5] = False
        assert (sem[differ] == 0).all() and not (differ & ~border).any()
        assert (sem > 0).mean() > 0.05, "the views must see the map"


@pytest.mark.parametrize("mode,folder,first,n", [("paired", "paired", 0, 6), ("s", "novel", 4, 2),
                                                  ("overview", "overview", 0, 6)])
def test_load_map_cli_modes(map_file, tmp_path, mode, folder, first, n):
    out = str(tmp_path / "novel")
    assert load_map.main([map_file, "--synthetic", "--synthetic-cam", "small", "--mode", mode,
                          "--num", "2", "--out", out, "--device", "cpu"]) == 0
    for sub in ("image", "semantic"):
        names, _ = _pngs(os.path.join(str(tmp_path / folder), sub))
        assert names == [f"{first + i:06d}.png" for i in range(n)]


def test_load_map_cli_refuses_dataset_input(map_file, tmp_path):
    """--calib of a directory that holds no KITTI-layout dataset: a clear
    error, never the synthetic scene's poses."""
    with pytest.raises(FileNotFoundError, match="times.txt"):
        load_map.main([map_file, "--calib", str(tmp_path), "--device", "cpu",
                       "--out", str(tmp_path / "novel")])
    assert not (tmp_path / "novel").exists()
