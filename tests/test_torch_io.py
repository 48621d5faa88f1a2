"""Port parity, dataset input and map IO: the port's KITTI reader against the
JAX package's on the same directory (every case of tests/test_io.py, with
both of the port's decoders), the port's native library (its own build of
surfelio.cpp) against PIL and against the Python map IO of both packages,
and the dataset CLIs: ``build_map DIR`` and ``load_map --calib DIR`` on the
CPU against the JAX CLIs on the same directory.

Frames, intrinsics and map records must be exact and poses bit-equal.  The
JAX mapper and renderer run with jit disabled, as in
tests/test_torch_pipeline.py and tests/test_torch_views.py, so the maps
agree exactly except for the colour words JAX's save flushes
(tests/test_torch_foundation.py, ROADMAP Queue 3).
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from surfelmapping_tpu.io.kitti import KittiReader as JKittiReader
from surfelmapping_tpu.surfels import load_map as jload_map
from surfelmapping_tpu.surfels import save_map as jsave_map
from surfelmapping_tpu_torch import build_map, convert, load_map, surfels
from surfelmapping_tpu_torch.io import kitti, native
from surfelmapping_tpu_torch.io.kitti import T20, KittiReader, write_kitti_dir
from surfelmapping_tpu_torch.io.synthetic import SyntheticScene, tiny_cam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import build_map as jbuild_map  # noqa: E402  (the JAX package's CLIs)
import load_map as jload_map_cli  # noqa: E402

from test_torch_foundation import _expected_jax_words  # noqa: E402


@pytest.fixture
def kitti_dir(tmp_path, rng):
    """tests/test_io.py's directory: 4 random 32x20 frames."""
    d = tmp_path / "seq"
    (d / "image_2").mkdir(parents=True)
    (d / "PSMNet").mkdir()
    (d / "semantics").mkdir()
    n, H, W = 4, 20, 32
    with open(d / "times.txt", "w") as f:
        f.writelines(f"{i * 0.1:.6f}\n" for i in range(n))
    with open(d / "calibration.txt", "w") as f:
        f.write("100.0 101.0 16.0 10.0\n32 20\n")
    with open(d / "pose.txt", "w") as f:
        for i in range(n):
            T = np.eye(4)
            T[2, 3] = i * 0.5
            f.write(" ".join(str(x) for x in T[:3].ravel()) + "\n")
    frames = []
    for i in range(n):
        rgb = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
        dep = rng.integers(0, 60000, (H, W), dtype=np.uint16)
        sem = rng.integers(0, 19, (H, W), dtype=np.uint8)
        Image.fromarray(rgb).save(d / "image_2" / f"{i:06d}.png")
        Image.fromarray(dep).save(d / "PSMNet" / f"{i:06d}.png")
        Image.fromarray(sem).save(d / "semantics" / f"{i:06d}.png")
        frames.append((rgb, dep, sem))
    return str(d), frames


def _assert_frames_equal(got, want):
    assert got.frame_id == want.frame_id and got.time == want.time
    for k in ("rgb", "depth", "semantic", "pose"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("sub_level", [0, 1])
@pytest.mark.parametrize("decoder", ["native", "pil"])
def test_kitti_reader_matches_jax(kitti_dir, decoder, sub_level):
    """Intrinsics exact, poses bit-equal (T20 right-multiplied), every frame
    exact, with either decoder and at sub_level 0 and 1."""
    path, frames = kitti_dir
    r = KittiReader(path, sub_level=sub_level, decoder=decoder)
    j = JKittiReader(path, sub_level=sub_level, use_native=False)
    assert r.decoder == decoder
    assert r.cam == type(r.cam)(**vars(j.cam))
    assert r.poses.dtype == np.float32
    np.testing.assert_array_equal(r.poses, j.poses)
    np.testing.assert_array_equal(r.poses[0], np.eye(4, dtype=np.float32) @ T20)
    assert r.times == j.times and len(r) == len(j) == 4
    for i in range(4):
        f, jf = r.get_next(), j.get_next()
        _assert_frames_equal(f, jf)
        s = 1 << sub_level
        np.testing.assert_array_equal(f.rgb, frames[i][0][::s, ::s])
    assert r.get_next() is None and j.get_next() is None
    r.close()


@pytest.mark.parametrize("decoder", ["native", "pil"])
def test_kitti_reader_cursor_semantics_match_jax(kitti_dir, decoder):
    """get_next / get_last / save_state / resume_state / set_state step the
    cursor as the JAX reader does, and backward reads (after the native
    prefetcher has gone past them) decode the same frames."""
    path, _ = kitti_dir
    r, j = KittiReader(path, decoder=decoder), JKittiReader(path, use_native=False)
    ids, jids = [], []
    while (f := r.get_next()) is not None:
        ids.append(f.frame_id)
        jids.append(j.get_next().frame_id)
    assert ids == jids == [0, 1, 2, 3] and j.get_next() is None
    r.save_state()
    j.save_state()
    back = []
    while (f := r.get_last()) is not None:
        jf = j.get_last()
        _assert_frames_equal(f, jf)
        back.append(f.frame_id)
    assert back == [2, 1, 0] and j.get_last() is None
    r.resume_state()
    j.resume_state()
    assert r.current == j.current == 3
    r.set_state(0)
    j.set_state(0)
    _assert_frames_equal(r.get_next(), j.get_next())
    r.close()


def test_native_prefetcher_and_read_png_match_pil(kitti_dir):
    path, frames = kitti_dir
    pf = native.FramePrefetcher(os.path.join(path, "image_2"), os.path.join(path, "PSMNet"),
                                os.path.join(path, "semantics"), 0, 3)
    for i in range(4):
        name = f"{i:06d}.png"
        pil = (np.asarray(Image.open(os.path.join(path, "image_2", name)).convert("RGB")),
               np.asarray(Image.open(os.path.join(path, "PSMNet", name))).astype(np.uint16),
               np.asarray(Image.open(os.path.join(path, "semantics", name)).convert("L")))
        for got, want, direct, sub in zip(pf.get(i), pil, frames[i],
                                          ("image_2", "PSMNet", "semantics")):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, direct)
            np.testing.assert_array_equal(native.read_png(os.path.join(path, sub, name)), want)
    with pytest.raises(ValueError, match="not pending"):
        pf.get(2)  # taken already: the loader would wait for it forever
    pf.close()
    assert str(native.library_path()).startswith(str(native.BUILD_DIR))
    assert native.library_path().name.startswith("libsurfelio-")


def test_native_decoder_raises_instead_of_falling_back(kitti_dir, monkeypatch):
    """A native reader whose library does not build raises with g++'s
    message; a frame that cannot be decoded raises with either decoder."""
    path, _ = kitti_dir
    os.remove(os.path.join(path, "semantics", "000002.png"))
    for decoder, err in (("native", RuntimeError), ("pil", FileNotFoundError)):
        r = KittiReader(path, decoder=decoder)
        r.get_next(), r.get_next()
        with pytest.raises(err):
            r.get_next()
        r.close()
    with pytest.raises(ValueError, match="decoder"):
        KittiReader(path, decoder="cv2")
    monkeypatch.setattr(native, "LIBS", native.LIBS + ("-lno_such_library_anywhere",))
    native.lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            KittiReader(path, decoder="native").get_next()
    finally:
        native.lib.cache_clear()


def test_native_map_io_roundtrip_and_interop(tmp_path, rng):
    """save_map_native/load_map_native round trip; the native file loads in
    the port's and the JAX package's Python readers, the Python writers'
    files load natively, and the port's save_map writes the same bytes as
    save_map_native of its records."""
    rec = rng.normal(size=(64, 12)).astype(np.float32)
    rec[:, 3] = np.abs(rec[:, 3]) + 0.1  # live: conf > 0
    p = str(tmp_path / "m.bin")
    native.save_map_native(p, rec, 1, 9)
    rec2, a, b = native.load_map_native(p)
    np.testing.assert_array_equal(rec, rec2)
    assert (a, b) == (1, 9)
    smap, s0, s1 = surfels.load_map(p, "cpu")
    assert (s0, s1) == (1, 9) and int(smap.count) == 64
    np.testing.assert_array_equal(surfels.pack_records(smap).numpy()[:, [0, 1, 2, 3, 4, 6]],
                                  rec[:, [0, 1, 2, 3, 4, 6]])
    jmap, j0, j1 = jload_map(p)
    assert (j0, j1) == (1, 9) and int(jmap.count) == 64
    np.testing.assert_array_equal(np.asarray(jmap.px)[:64], rec[:, 0])

    p_port, p_jax, p_nat = (str(tmp_path / n) for n in ("port.bin", "jax.bin", "nat.bin"))
    surfels.save_map(smap, p_port, 1, 9)
    jsave_map(jmap, p_jax, 1, 9)
    native.save_map_native(p_nat, surfels.pack_records(smap).numpy(), 1, 9)
    assert open(p_port, "rb").read() == open(p_nat, "rb").read()
    for q in (p_port, p_jax):
        got, g0, g1 = native.load_map_native(q)
        assert (g0, g1) == (1, 9) and got.shape == (64, 12)
    np.testing.assert_array_equal(native.load_map_native(p_port)[0].view(np.int32),
                                  surfels.pack_records(smap).numpy().view(np.int32))
    empty = str(tmp_path / "empty.bin")
    native.save_map_native(empty, np.zeros((0, 12), np.float32), 0, 0)
    assert native.load_map_native(empty)[0].shape == (0, 12)
    with pytest.raises(ValueError):
        native.save_map_native(empty, np.zeros((3, 11), np.float32), 0, 0)


# -- the dataset CLIs ----------------------------------------------------

N_FRAMES = 4


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """A KITTI-layout directory of the procedural scene, 128x96 (wider than
    the 80-px stereo border), written by the port's writer."""
    d = str(tmp_path_factory.mktemp("scene") / "seq")
    cam = tiny_cam(128, 96)
    scene = SyntheticScene(cam)
    write_kitti_dir(d, cam, (scene.frame(i) for i in range(N_FRAMES)))
    return d


def _records(path):
    raw = open(path, "rb").read()
    n = int(np.frombuffer(raw[:4], "<u4")[0])
    return (np.frombuffer(raw[4:12], "<i4").tolist(),
            np.frombuffer(raw[12:], "<i4").reshape(n, 12))


def test_write_kitti_dir_reads_back_the_scene(scene_dir):
    cam = tiny_cam(128, 96)
    scene = SyntheticScene(cam)
    r = kitti.KittiReader(scene_dir, decoder="pil")
    assert r.cam == cam and len(r) == N_FRAMES
    for i in range(N_FRAMES):
        f = r.get_next()
        for got, want in zip((f.rgb, f.depth, f.semantic, f.pose), scene.frame(i)):
            np.testing.assert_array_equal(got, want)


@jax.disable_jit()
def test_build_map_dataset_cli_matches_jax(scene_dir, tmp_path, capsys):
    """``build_map DIR`` and ``build_map DIR --frames 3`` on the CPU write
    the JAX CLI's records (start and end ids included), except the colour
    words JAX's save flushes."""
    for extra, ids in (([], [0, N_FRAMES - 1]), (["--frames", "3"], [0, 2])):
        port, jax_out = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
        assert build_map.main([scene_dir, "--out", port, "--capacity", "65536",
                               "--device", "cpu"] + extra) == 0
        assert "decoder native" in capsys.readouterr().out
        assert jbuild_map.main([scene_dir, "--out", jax_out, "--capacity", "65536"]
                               + extra) == 0
        (head, rec), (jhead, jrec) = _records(port), _records(jax_out)
        assert head == jhead == ids
        assert rec.shape == jrec.shape and rec.shape[0] > 100
        np.testing.assert_array_equal(jrec, _expected_jax_words(rec))


@jax.disable_jit()
def test_load_map_calib_cli_matches_jax(scene_dir, tmp_path):
    """``load_map MAP --calib DIR --mode paired`` renders at the reader's
    poses with its intrinsics: the JAX CLI's PNGs, except where the JAX
    dilation's border quirk colours an uncovered pixel within 5 px of the
    edge (tests/test_torch_views.py)."""
    m = str(tmp_path / "m.bin")
    assert build_map.main([scene_dir, "--out", m, "--capacity", "65536", "--device", "cpu",
                           "--decoder", "pil"]) == 0
    out, jout = str(tmp_path / "port" / "novel"), str(tmp_path / "jax" / "novel")
    assert load_map.main([m, "--calib", scene_dir, "--mode", "paired", "--out", out,
                          "--device", "cpu"]) == 0
    assert jload_map_cli.main([m, "--calib", scene_dir, "--mode", "paired", "--out", jout]) == 0
    names = sorted(os.listdir(str(tmp_path / "port" / "paired" / "image")))
    assert names == sorted(os.listdir(str(tmp_path / "jax" / "paired" / "image"))) \
        == [f"{i:06d}.png" for i in range(N_FRAMES)]
    border = np.ones((96, 128), bool)
    border[5:-5, 5:-5] = False
    for n in names:
        sem, jsem, rgb, jrgb = (np.asarray(Image.open(str(tmp_path / side / "paired" / sub / n)))
                                for side, sub in (("port", "semantic"), ("jax", "semantic"),
                                                  ("port", "image"), ("jax", "image")))
        differ = (sem != jsem) | (rgb != jrgb).any(-1)
        assert (sem[differ] == 0).all() and not (differ & ~border).any()
        assert (sem > 0).mean() > 0.05, "the paired views must see the map"


def test_sub_level_pads_an_odd_frame_with_holes(tmp_path):
    """--sub-level 1 of a 2*W x 2*H directory with odd W and H: the reader
    halves the intrinsics and the size, and build_map pads the odd size with
    depth-0 pixels (the JAX CLI refuses odd sizes) into a non-empty map.
    161 px leave 81 columns beside the 80-px stereo border."""
    cam = tiny_cam(2 * 161, 2 * 61)  # 161x61 at level 1
    scene = SyntheticScene(cam)
    d = str(tmp_path / "seq")
    write_kitti_dir(d, cam, (scene.frame(i) for i in range(3)))
    r = KittiReader(d, sub_level=1, decoder="pil")
    assert (r.cam.width, r.cam.height, r.cam.fx, r.cam.cx) == (161, 61, cam.fx / 2, cam.cx / 2)
    even, pad = build_map.pad_to_even(r.cam)
    assert (even.width, even.height, even.fx) == (162, 62, r.cam.fx)
    f = r.get_next()
    rgb, depth, sem = pad(f.rgb, f.depth, f.semantic)
    assert rgb.shape == (62, 162, 3) and depth.shape == sem.shape == (62, 162)
    assert (depth[-1] == 0).all() and (depth[:, -1] == 0).all()
    np.testing.assert_array_equal(depth[:61, :161], f.depth)
    out = str(tmp_path / "m.bin")
    assert build_map.main([d, "--sub-level", "1", "--out", out, "--device", "cpu",
                           "--capacity", "65536"]) == 0
    head, rec = _records(out)
    assert head == [0, 2] and rec.shape[0] > 0


def test_map_file_from_the_cli_loads_natively(scene_dir, tmp_path):
    out = str(tmp_path / "m.bin")
    assert build_map.main([scene_dir, "--out", out, "--capacity", "65536", "--device", "cpu",
                           "--frames", "2"]) == 0
    rec, s0, s1 = native.load_map_native(out)
    smap, p0, p1 = surfels.load_map(out, "cpu")
    assert (s0, s1) == (p0, p1) == (0, 1)
    np.testing.assert_array_equal(rec.view(np.int32),
                                  surfels.pack_records(smap).numpy().view(np.int32))
    cols, n = convert.map_to_numpy(smap)
    assert n == rec.shape[0] > 0
    assert torch.equal(smap.count, torch.tensor(n, dtype=torch.int32))


def test_build_map_dataset_cli_tracks_and_cleans(scene_dir, tmp_path, capsys):
    """--icp, --ba, --pose-noise and --clean act on dataset input through the
    same Tracker as on the procedural scene: the ATE against the reader's
    poses is printed and the cleaned map keeps the frames' ids."""
    out = str(tmp_path / "m.bin")
    assert build_map.main([scene_dir, "--out", out, "--capacity", "65536", "--device", "cpu",
                           "--icp", "--ba", "--pose-noise", "0.02", "--clean"]) == 0
    log = capsys.readouterr().out
    assert "ATE (rmse vs input gt)" in log and "after clean: surfels=" in log
    head, rec = _records(out)
    assert head == [0, N_FRAMES - 1] and rec.shape[0] > 0
