"""Port parity, foundation: colour bits, transforms, the reference byte
format, the JAX <-> port map conversion, and the port's import boundary.

Inputs are numpy arrays made from a seed, handed to both packages.

The JAX package multiplies records by the live mask in ``pack_records``
(surfelmapping_tpu/surfels.py:173); on the CPU backend that flushes a
subnormal float -- a class-0 colour with r < 128 -- to +0.  The port keeps
the bits.  The byte comparisons therefore expect equality everywhere except
exactly those colour words, which JAX writes as 0.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfelmapping_tpu import surfels as jsurfels
from surfelmapping_tpu.ops import colors as jcolors
from surfelmapping_tpu.ops import transforms as jtf
from surfelmapping_tpu_torch import convert, surfels
from surfelmapping_tpu_torch.ops import colors, transforms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_COLS = ("px", "py", "pz", "conf", "init_t", "last_t", "nx", "ny", "nz", "radius")


def _random_pose(rng) -> np.ndarray:
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = q
    T[:3, 3] = rng.uniform(-20, 20, 3)
    return T


def _random_map_columns(rng, cap=64, count=40):
    """Map columns as the JAX map holds them (colorsem float32 bits), with
    a run of subnormal class-0 colours and some tombstones."""
    cols = {k: np.zeros(cap, np.float32) for k in F32_COLS}
    for k in F32_COLS:
        cols[k][:count] = rng.uniform(-10, 10, count).astype(np.float32)
    cols["conf"][:count] = rng.uniform(0.5, 3.0, count).astype(np.float32)
    cols["conf"][[3, 11]] = (-0.1, 0.0)  # tombstones
    sem = rng.integers(0, 19, count)
    sem[:10] = 0                          # class 0: subnormal when r < 128
    rgb = rng.integers(0, 256, (count, 3))
    rgb[:10, 0] = rng.integers(0, 128, 10)
    bits = np.zeros(cap, np.int32)
    bits[:count] = (sem << 24) | (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    cols["colorsem"] = bits.view(np.float32)
    return cols, count


def _jax_map(cols, count):
    return jsurfels.SurfelMap(**{k: jnp.asarray(v) for k, v in cols.items()},
                              count=jnp.int32(count))


def test_color_bits_match_jax(rng):
    rgb_u8 = rng.integers(0, 256, (7, 9, 3)).astype(np.uint8)
    sem = rng.integers(0, 19, (7, 9)).astype(np.int32)
    rgb = rgb_u8.astype(np.float32) / np.float32(255.0)
    want = np.asarray(jcolors.encode_color(jnp.asarray(rgb), jnp.asarray(sem).astype(jnp.uint32)))
    got = colors.encode_color(torch.from_numpy(rgb), torch.from_numpy(sem))
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))
    # decode: the port reads the same words as int32 bits
    j_rgb, j_sem = jcolors.decode_color(jnp.asarray(want))
    t_rgb, t_sem = colors.decode_color(got)
    np.testing.assert_array_equal(t_rgb.numpy(), np.asarray(j_rgb))
    np.testing.assert_array_equal(t_sem.numpy(), np.asarray(j_sem).astype(np.int32))


def test_transforms_match_jax(rng):
    A, B = _random_pose(rng), _random_pose(rng)
    x, y, z = (rng.uniform(-30, 30, 500).astype(np.float32) for _ in range(3))
    for jf, tf in ((jtf.transform_planar, transforms.transform_planar),
                   (jtf.rotate_planar, transforms.rotate_planar)):
        want = jf(jnp.asarray(A), jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
        got = tf(torch.from_numpy(A), torch.from_numpy(x), torch.from_numpy(y),
                 torch.from_numpy(z))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jtf.normalize_planar(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    got = transforms.normalize_planar(*(torch.from_numpy(v) for v in (x, y, z)))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    # 4x4 products: the same k-ordered FMA chain as XLA's on the CPU
    np.testing.assert_array_equal(transforms.invert_se3(torch.from_numpy(A)).numpy(),
                                  np.asarray(jtf.invert_se3(jnp.asarray(A))))
    np.testing.assert_array_equal(
        transforms.compose(torch.from_numpy(A), torch.from_numpy(B)).numpy(),
        np.asarray(jtf.compose(jnp.asarray(A), jnp.asarray(B))))


def _expected_jax_words(port_words: np.ndarray) -> np.ndarray:
    """The port's record words with JAX's flush applied: a subnormal colour
    word (exponent bits 0, mantissa != 0) becomes 0."""
    out = port_words.copy()
    col = out[:, 4]
    col[((col & 0x7F800000) == 0) & (col != 0)] = 0
    return out


def test_pack_records_and_save_map_bytes_match_jax(rng, tmp_path):
    cols, count = _random_map_columns(rng)
    port_rec = surfels.pack_records(convert.map_from_numpy(cols, count, "cpu")).numpy()
    jax_rec = np.asarray(jsurfels.pack_records(_jax_map(cols, count)))
    words = port_rec.view(np.int32)
    np.testing.assert_array_equal(jax_rec.view(np.int32), _expected_jax_words(words))
    assert (words[:count, 4] != jax_rec.view(np.int32)[:count, 4]).sum() > 0, \
        "the test map must hold subnormal colours"

    p_port, p_jax = tmp_path / "port.bin", tmp_path / "jax.bin"
    surfels.save_map(convert.map_from_numpy(cols, count, "cpu"), str(p_port), 3, 9)
    jsurfels.save_map(_jax_map(cols, count), str(p_jax), 3, 9)
    raw_port, raw_jax = p_port.read_bytes(), p_jax.read_bytes()
    assert raw_port[:12] == raw_jax[:12]
    n = int(np.frombuffer(raw_port[:4], "<u4")[0])
    assert n == count - 2  # tombstones filtered
    rec_port = np.frombuffer(raw_port[12:], "<i4").reshape(n, 12)
    rec_jax = np.frombuffer(raw_jax[12:], "<i4").reshape(n, 12)
    np.testing.assert_array_equal(rec_jax, _expected_jax_words(rec_port))


def test_port_keeps_subnormal_color_bits(rng, tmp_path):
    cols, count = _random_map_columns(rng)
    smap = convert.map_from_numpy(cols, count, "cpu")
    bits = cols["colorsem"].view(np.int32)[:count]
    rec = surfels.pack_records(smap).numpy().view(np.int32)
    np.testing.assert_array_equal(rec[:count, 4], bits)
    path = str(tmp_path / "m.bin")
    surfels.save_map(smap, path, 0, 1)
    loaded, s0, s1 = surfels.load_map(path, "cpu")
    live = cols["conf"][:count] > 0
    np.testing.assert_array_equal(loaded.column("colorsem")[: live.sum()].numpy(), bits[live])
    assert (s0, s1) == (0, 1)


def test_map_roundtrip_through_convert(rng, tmp_path):
    cols, count = _random_map_columns(rng)
    back, n = convert.map_to_numpy(convert.map_from_numpy(cols, count, "cpu"))
    assert n == count
    for k in cols:
        np.testing.assert_array_equal(back[k].view(np.int32), cols[k].view(np.int32), err_msg=k)
    # a map saved by the port loads in the JAX package with the same records
    path = str(tmp_path / "m.bin")
    surfels.save_map(convert.map_from_numpy(cols, count, "cpu"), path, 0, 5)
    jmap, _, _ = jsurfels.load_map(path)
    live = cols["conf"][:count] > 0
    for k in F32_COLS:
        np.testing.assert_array_equal(np.asarray(getattr(jmap, k))[: live.sum()],
                                      cols[k][:count][live], err_msg=k)


def test_port_imports_no_jax():
    """Importing every port module and chip_smoke loads no jax*, flax, optax
    or msgpack module and nothing of the JAX package (exact names: the port
    shares its prefix)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import surfelmapping_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0].startswith('jax')\n"
        "       or m.split('.')[0] in ('flax', 'optax', 'msgpack')\n"
        "       or m == 'surfelmapping_tpu' or m.startswith('surfelmapping_tpu.')]\n"
        "print(len([m for m in sys.modules if m.startswith('surfelmapping_tpu_torch')]))\n"
        "print(sorted(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True).stdout.split("\n")
    assert int(out[0]) > 15, "the walk must import the port's modules"
    assert out[1] == "[]"


@pytest.mark.parametrize("entry", ["SurfelMapper", "render_view", "load_map", "ICPRefiner",
                                   "WindowedBA", "build_map", "SpadeTrainer", "spade_test",
                                   "spade_train"])
@pytest.mark.parametrize("device", [None, "cuda"])
def test_entry_point_defaults_to_the_card(device, entry, tmp_path):
    """The mapper, the renderer, the trackers, the SPADE model and the CLIs
    run on the card unless asked for the CPU; without CUDA they raise rather
    than fall back."""
    from PIL import Image

    from surfelmapping_tpu_torch import build_map, load_map, spade_test, spade_train
    from surfelmapping_tpu_torch.ba import WindowedBA
    from surfelmapping_tpu_torch.config import PipelineParams
    from surfelmapping_tpu_torch.icp import ICPRefiner
    from surfelmapping_tpu_torch.io.synthetic import tiny_cam
    from surfelmapping_tpu_torch.models.pix2pix import SpadeConfig, SpadeTrainer, init_variables
    from surfelmapping_tpu_torch.ops.splat import render_view
    from surfelmapping_tpu_torch.pipeline import SurfelMapper

    path = str(tmp_path / "empty.bin")
    surfels.save_map(surfels.empty_map(8, "cpu"), path, 0, 1)
    spade = SpadeConfig(ngf=8, crop_size=32)
    if entry == "spade_test":  # a checkpoint holding the generator, one label
        from surfelmapping_tpu_torch.models.checkpoint import packb

        v = init_variables(spade)
        (tmp_path / "g.msgpack").write_bytes(packb(
            {"g_params": v["params"], "g_batch_stats": v["batch_stats"]}))
        (tmp_path / "labels").mkdir()
        Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(tmp_path / "labels" / "0.png")
    if entry == "spade_train":  # one label/image pair
        for d in ("labels", "images"):
            (tmp_path / d).mkdir()
            Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(tmp_path / d / "0.png")
    calls = {
        "SurfelMapper": lambda: SurfelMapper(tiny_cam(), device=device).device,
        "render_view": lambda: render_view(surfels.empty_map(8, "cpu"), np.eye(4), tiny_cam(),
                                           device=device)["id"].device,
        "load_map": lambda: load_map.main(
            [path, "--synthetic-cam", "small", "--num", "1", "--out", str(tmp_path / "novel")]
            + ([] if device is None else ["--device", device])),
        "ICPRefiner": lambda: ICPRefiner(tiny_cam(), PipelineParams(), device=device).device,
        "WindowedBA": lambda: WindowedBA(tiny_cam(), PipelineParams(), device=device).device,
        "build_map": lambda: build_map.main(
            ["--synthetic", "3", "--synthetic-cam", "small", "--icp", "--ba", "--capacity",
             str(1 << 16), "--out", str(tmp_path / "m.bin")]
            + ([] if device is None else ["--device", device])),
        "SpadeTrainer": lambda: SpadeTrainer(spade, init_variables(spade), device=device).device,
        "spade_test": lambda: spade_test.main(
            ["--ckpt", str(tmp_path / "g.msgpack"), "--label-dir", str(tmp_path / "labels"),
             "--crop", "32", "--ngf", "8", "--out", str(tmp_path / "enhanced")]
            + ([] if device is None else ["--device", device])),
        "spade_train": lambda: spade_train.main(
            ["--label-dir", str(tmp_path / "labels"), "--image-dir", str(tmp_path / "images"),
             "--niter", "1", "--niter-decay", "0", "--steps-per-epoch", "1", "--crop", "32",
             "--ngf", "8", "--ndf", "8", "--num-d", "1", "--n-layers-d", "2", "--no-vgg",
             "--ckpt-dir", str(tmp_path / "ckpt")]
            + ([] if device is None else ["--device", device])),
    }
    if torch.cuda.is_available():
        got = calls[entry]()
        assert got == 0 if entry in ("load_map", "build_map", "spade_test", "spade_train") \
            else got.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            calls[entry]()
        assert not (tmp_path / "ckpt").exists()  # spade_train raises before it writes
