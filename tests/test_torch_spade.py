"""Port parity, SPADE enhancement: the resizes, flax's spectral norm, the
SPADE norm and ResNet block, the generator and the VAE path against the JAX
package's SpadeTrainer.infer, the port's init against flax's variable
layout, the checkpoint decoder against flax's msgpack, the inference data
and the spade_test CLI.

Weights are the port's seeded init (flax's layout and distributions) with
random batch-norm statistics, handed to both packages as numpy arrays; the
JAX side applies them without an init of its own (``jax.eval_shape`` gives
its layout), so no test pays for a flax init except the JAX CLI's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax import serialization
from flax.traverse_util import flatten_dict
from PIL import Image

from surfelmapping_tpu.models import data as jdata
from surfelmapping_tpu.models import spade as jspade
from surfelmapping_tpu.models.pix2pix import SpadeConfig as JaxConfig
from surfelmapping_tpu.models.pix2pix import SpadeTrainer as JaxTrainer
from surfelmapping_tpu.models.pix2pix import TrainState
from surfelmapping_tpu_torch import convert
from surfelmapping_tpu_torch.models import checkpoint, data, spade
from surfelmapping_tpu_torch.models.pix2pix import SpadeConfig, SpadeTrainer, init_variables

NGF, CROP, Z_DIM = 8, 64, 16


def _random_bn_stats(tree: dict, rng) -> dict:
    """``tree`` with every BatchNorm_0 mean ~ N(0, 0.1) and var ~ U(0.5, 2)."""
    for k, v in tree.items():
        if k == "BatchNorm_0":
            v["mean"] = rng.normal(0, 0.1, v["mean"].shape).astype(np.float32)
            v["var"] = rng.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)
        elif isinstance(v, dict):
            _random_bn_stats(v, rng)
    return tree


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def _jax_state(variables: dict) -> TrainState:
    """A TrainState holding only the generator's variables, which is all
    SpadeTrainer.infer reads."""
    return TrainState(g_params=variables["params"], g_batch_stats=variables["batch_stats"],
                      d_params=None, d_batch_stats=None, g_opt=None, d_opt=None,
                      vgg_params=None, step=None)


@pytest.fixture(scope="module")
def plain_vars():
    v = init_variables(SpadeConfig(ngf=NGF, crop_size=CROP), seed=0)
    v["batch_stats"] = _random_bn_stats(v["batch_stats"], np.random.default_rng(1))
    return v


@pytest.fixture(scope="module")
def vae_vars():
    v = init_variables(SpadeConfig(ngf=NGF, ndf=NGF, crop_size=CROP, use_vae=True,
                                   z_dim=Z_DIM), seed=0)
    v["batch_stats"] = _random_bn_stats(v["batch_stats"], np.random.default_rng(2))
    return v


@pytest.mark.parametrize("src,dst", [((370, 1226), (12, 39)), ((384, 1248), (12, 39)),
                                     ((256, 256), (8, 8)), ((370, 1226), (24, 78)),
                                     ((370, 1226), (384, 1248)), ((96, 128), (3, 4))])
def test_resize_nearest_matches_jax(src, dst):
    x = np.random.default_rng(0).uniform(-1, 1, (1, *src, 2)).astype(np.float32)
    want = np.asarray(jspade._resize_nearest(jnp.asarray(x), *dst))
    got = _nhwc(spade.resize_nearest(_nchw(x), *dst))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src", [(384, 1248), (370, 1226), (64, 64)])
def test_resize_bilinear_matches_jax(src):
    """The encoder's resize to 256x256: JAX antialiases when it downsamples."""
    x = np.random.default_rng(0).uniform(-1, 1, (1, *src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 256, 256, 3), method="bilinear"))
    got = _nhwc(spade.resize_bilinear(_nchw(x), 256, 256))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


class _FlaxSN(fnn.Module):
    """flax's SpectralNorm around a dense layer; applied to the identity it
    returns the normalised kernel."""

    out: int

    @fnn.compact
    def __call__(self, x):
        return fnn.SpectralNorm(fnn.Dense(self.out, use_bias=False, name="d"))(
            x, update_stats=False)


def test_spectral_normalize_matches_flax():
    rng = np.random.default_rng(0)
    kernel = rng.normal(0, 0.1, (3, 3, 16, 32)).astype(np.float32)  # HWIO
    u = rng.normal(0, 1, (1, 32)).astype(np.float32)
    flat = kernel.reshape(-1, 32)
    want = np.asarray(_FlaxSN(32).apply(
        {"params": {"d": {"kernel": flat}},
         "batch_stats": {"SpectralNorm_0": {"d/kernel/u": u, "d/kernel/sigma": np.float32(1)}}},
        jnp.eye(flat.shape[0])))
    got = spade.spectral_normalize(torch.from_numpy(kernel), torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy().reshape(-1, 32), want, rtol=1e-6, atol=1e-9)
    assert not np.allclose(want, flat, rtol=1e-3)  # sigma is not 1


def _port_module(module, seed: int):
    """Flax variables for a port module (seeded init, random BN stats) and
    the module loaded with them on the CPU."""
    v = convert.init_numpy(module, torch.Generator().manual_seed(seed))
    v["batch_stats"] = _random_bn_stats(v["batch_stats"], np.random.default_rng(seed))
    return v, convert.load_numpy(module, v, "cpu")


def test_spade_norm_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 8, 12, 16)).astype(np.float32)
    seg = rng.uniform(-1, 1, (2, 20, 30, 3)).astype(np.float32)
    v, port = _port_module(spade.SPADENorm(16, device="meta"), 3)
    want = np.asarray(jspade.SPADENorm(16).apply(v, jnp.asarray(x), jnp.asarray(seg),
                                                 train=False))
    got = _nhwc(port(_nchw(x), _nchw(seg)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fin,fout", [(16, 8), (16, 16)], ids=["learned_shortcut", "identity"])
def test_resnet_block_matches_jax(fin, fout):
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 8, 12, fin)).astype(np.float32)
    seg = rng.uniform(-1, 1, (2, 20, 30, 3)).astype(np.float32)
    v, port = _port_module(spade.SPADEResnetBlock(fin, fout, device="meta"), 4)
    assert ("conv_s" in v["params"]) == (fin != fout)
    want = np.asarray(jspade.SPADEResnetBlock(fin, fout).apply(
        v, jnp.asarray(x), jnp.asarray(seg), train=False))
    got = _nhwc(port(_nchw(x), _nchw(seg)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("aspect,label_hw,out_h", [(1.0, (70, 70), 64), (3.25, (40, 130), 32)])
def test_generator_matches_jax(plain_vars, aspect, label_hw, out_h):
    """SpadeTrainer.infer at crop 64 (output 64x64 and 32x64), from labels
    whose size is off the generator's grid."""
    label = np.random.default_rng(5).uniform(-1, 1, (2, *label_hw, 3)).astype(np.float32)
    jt = JaxTrainer(JaxConfig(ngf=NGF, crop_size=CROP, aspect_ratio=aspect, use_vgg=False))
    want = np.asarray(jt.infer(_jax_state(plain_vars), jnp.asarray(label)))
    port = SpadeTrainer(SpadeConfig(ngf=NGF, crop_size=CROP, aspect_ratio=aspect),
                        variables=plain_vars, device="cpu")
    got = port.infer(torch.from_numpy(label)).numpy()
    assert got.shape == want.shape == (2, out_h, CROP, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (np.abs(want) < 0.99).mean() > 0.5  # not saturated


@pytest.mark.parametrize("styled", [True, False], ids=["style", "prior"])
def test_vae_path_matches_jax(vae_vars, styled):
    """With a style image the encoder's mu drives the generator; without
    one, z = 0."""
    rng = np.random.default_rng(6)
    label = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    style = rng.uniform(-1, 1, (2, 80, 96, 3)).astype(np.float32) if styled else None
    jt = JaxTrainer(JaxConfig(ngf=NGF, ndf=NGF, crop_size=CROP, use_vae=True, z_dim=Z_DIM,
                              use_vgg=False))
    want = np.asarray(jt.infer(_jax_state(vae_vars), jnp.asarray(label),
                               None if style is None else jnp.asarray(style)))
    port = SpadeTrainer(SpadeConfig(ngf=NGF, ndf=NGF, crop_size=CROP, use_vae=True,
                                    z_dim=Z_DIM), variables=vae_vars, device="cpu")
    got = port.infer(torch.from_numpy(label),
                     None if style is None else torch.from_numpy(style)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if styled:
        prior = port.infer(torch.from_numpy(label)).numpy()
        assert np.abs(prior - got).max() > 1e-3  # the style moves the output


def _jax_layout(use_vae: bool) -> dict:
    """flax's variables of the generator (and encoder), shapes only."""
    jt = JaxTrainer(JaxConfig(ngf=NGF, ndf=NGF, crop_size=CROP, use_vae=use_vae, z_dim=Z_DIM,
                              use_vgg=False))
    lab = jnp.zeros((1, CROP, CROP, 3), jnp.float32)
    state = jax.eval_shape(jt.init_state, lab, lab)
    return {"params": state.g_params, "batch_stats": state.g_batch_stats}


@pytest.mark.parametrize("use_vae", [False, True], ids=["plain", "vae"])
def test_init_has_flax_layout_and_distributions(plain_vars, vae_vars, use_vae):
    ours = vae_vars if use_vae else plain_vars
    want = {k: (tuple(v.shape), np.dtype(v.dtype)) for k, v in
            flatten_dict(_jax_layout(use_vae)).items()}
    got = {k: (v.shape, v.dtype) for k, v in flatten_dict(ours).items()}
    assert got == want
    params = ours["params"]["gen"] if use_vae else ours["params"]
    k = params["head_0"]["conv_0"]["kernel"]  # lecun normal, truncated at 2 deviations
    std = np.sqrt(1.0 / (9 * k.shape[2]))
    assert abs(k.std() / std - 1) < 0.05 and np.abs(k).max() <= 2 * std / 0.87962566 + 1e-7
    assert not params["head_0"]["conv_0"]["bias"].any()
    u = init_variables(SpadeConfig(ngf=NGF, crop_size=CROP))["batch_stats"]["head_0"][
        "SpectralNorm_0"]["conv_0/kernel/u"]
    assert abs(u.std() - 1) < 0.3


def _trees_equal(a, b, where=""):
    assert type(a) is type(b) or (isinstance(a, np.generic) and isinstance(b, np.generic)), \
        (where, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _trees_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _trees_equal(x, y, f"{where}/{i}")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype and np.shape(a) == np.shape(b), where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def _jax_checkpoint(variables: dict, cfg: JaxConfig) -> bytes:
    """flax's bytes of a whole TrainState for ``cfg`` (as spade_train.py
    writes it), with the given generator variables and zeros elsewhere."""
    import dataclasses

    jt = JaxTrainer(cfg)
    lab = jnp.zeros((1, cfg.crop_size, cfg.crop_size, 3), jnp.float32)
    shapes = jax.eval_shape(jt.init_state, lab, lab)
    state = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    state = dataclasses.replace(state, g_params=variables["params"],
                                g_batch_stats=variables["batch_stats"])
    return serialization.to_bytes(dataclasses.asdict(state))


def test_checkpoint_decoder_matches_flax(plain_vars, tmp_path):
    raw = _jax_checkpoint(plain_vars, JaxConfig(ngf=NGF, ndf=NGF, crop_size=CROP, num_d=1,
                                                n_layers_d=2, use_vgg=False))
    _trees_equal(checkpoint.unpackb(raw), serialization.msgpack_restore(raw))
    path = tmp_path / "ckpt.msgpack"
    path.write_bytes(raw)
    _trees_equal(checkpoint.load_generator_variables(str(path)), plain_vars)
    # the rest of the subset: numpy scalars (ext 3), every int width, floats,
    # nil/bool, str, bin, nested lists, empty and int arrays
    tree = {"f32": np.float32(2.5), "i64": np.int64(-7),
            "ints": [0, 127, 128, 300, 70_000, 2**40, -1, -33, -200, -70_000, -2**40],
            "misc": [1.5, None, True, False, "héllo" * 20, b"\x00\x01" * 200, [[]]],
            "a": np.arange(6, dtype=np.int64).reshape(2, 3),
            "e": np.zeros((0, 4), np.float16), "s": np.float32(3.0) * np.ones((), np.float32)}
    raw = serialization.msgpack_serialize(tree)
    _trees_equal(checkpoint.unpackb(raw), serialization.msgpack_restore(raw))


@pytest.mark.parametrize("case", ["chunked", "complex", "trailing"])
def test_checkpoint_decoder_raises_outside_the_subset(case):
    if case == "chunked":  # flax's form of an array over 2^30 bytes
        raw = serialization.msgpack_serialize(
            {"x": {"__msgpack_chunked_array__": True, "shape": [2], "chunks": {}}})
    elif case == "complex":
        raw = serialization.msgpack_serialize({"x": 1 + 2j})
    else:
        raw = serialization.msgpack_serialize({"x": 1}) + b"\x00"
    with pytest.raises(ValueError, match="msgpack"):
        checkpoint.unpackb(raw)


def test_inference_data_matches_jax(tmp_path):
    names = ["000010.png", "000060.png", "000070.png", "001300.png", "notes.png",
             "1700.png", "002000.png"]
    assert data.KITTI_BAD_FRAME_RANGES == jdata.KITTI_BAD_FRAME_RANGES
    for n in names:
        assert data._frame_id(n) == jdata._frame_id(n)
        for ranges in (((0, 56), (69, 134)), data.KITTI_BAD_FRAME_RANGES):
            assert data.in_skip_ranges(n, ranges) == jdata.in_skip_ranges(n, ranges)
    rng = np.random.default_rng(7)
    for i, n in enumerate(names):
        h, w = ((40, 130), (370, 1226), (50, 60))[i % 3]
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(tmp_path / n)
    for crop, aspect, start in ((130, 3.25, 65), (1248, 3.25, 0), (64, 1.0, 1700)):
        ours = data.SingleRenderDataset(str(tmp_path), crop, aspect, start)
        ref = jdata.SingleRenderDataset(str(tmp_path), crop, aspect, start)
        assert ours.names == ref.names and len(ours) == len(ref) and ours.out_h == ref.out_h
        for (n1, a1), (n2, a2) in zip(ours, ref):
            assert n1 == n2 and a1.dtype == a2.dtype
            np.testing.assert_array_equal(a1, a2)
    rendered = rng.integers(0, 256, (6, 7, 3), dtype=np.uint8)
    generated = rng.integers(0, 256, (6, 7, 3), dtype=np.uint8)
    semantic = rng.integers(0, 3, (6, 7)).astype(np.uint8)
    np.testing.assert_array_equal(data.postprocess_composite(rendered, generated, semantic),
                                  jdata.postprocess_composite(rendered, generated, semantic))


def test_spade_test_cli_matches_jax(plain_vars, tmp_path):
    """The JAX CLI and the port's on one checkpoint and the same label and
    semantic PNGs: the same files, u8 images within one level (the
    truncating u8 cast after generators that agree to ~1e-6)."""
    import spade_test as jax_cli

    from surfelmapping_tpu_torch import spade_test as port_cli

    crop = 32
    v = init_variables(SpadeConfig(ngf=NGF, crop_size=crop), seed=3)
    v["batch_stats"] = _random_bn_stats(v["batch_stats"], np.random.default_rng(3))
    ckpt = tmp_path / "spade.msgpack"
    ckpt.write_bytes(_jax_checkpoint(v, JaxConfig(ngf=NGF, crop_size=crop, num_d=1,
                                                  n_layers_d=2, use_vgg=False)))
    labels, sems = tmp_path / "image", tmp_path / "semantic"
    labels.mkdir()
    sems.mkdir()
    rng = np.random.default_rng(8)
    for fid in range(4):
        Image.fromarray(rng.integers(0, 256, (crop, crop, 3), dtype=np.uint8)).save(
            labels / f"{fid:06d}.png")
        Image.fromarray((rng.uniform(size=(crop, crop)) < 0.6).astype(np.uint8) * 3).save(
            sems / f"{fid:06d}.png")
    argv = ["--ckpt", str(ckpt), "--label-dir", str(labels), "--semantic-dir", str(sems),
            "--crop", str(crop), "--ngf", str(NGF), "--num-d", "1", "--n-layers-d", "2",
            "--start-frame-id", "1", "--limit", "2"]
    assert jax_cli.main(argv + ["--out", str(tmp_path / "jax")]) == 0
    assert port_cli.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == ["000001.png", "000002.png"]
    for n in names:
        got = np.asarray(Image.open(tmp_path / "port" / n)).astype(int)
        want = np.asarray(Image.open(tmp_path / "jax" / n)).astype(int)
        assert np.abs(got - want).max() <= 1, n
        hole = np.asarray(Image.open(sems / n)) == 0
        label = np.asarray(Image.open(labels / n))
        np.testing.assert_array_equal(got[~hole], label[~hole])  # rendered pixels kept


def test_spade_entry_point_turns_off_tf32():
    """float32 convolutions and matmuls without TF32 once the model is built."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    cfg = SpadeConfig(ngf=NGF, crop_size=32)
    SpadeTrainer(cfg, init_variables(cfg), device="cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
