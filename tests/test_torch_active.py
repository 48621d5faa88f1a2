"""Port parity, per function: frame surfels, the checkerboard lattice, and
the active-block engine (plan / gather / conflict / index / associate /
fuse-append) plus compact, initialize_map and conflict_pass.

The state is a real one: three synthetic frames fused by the port on the
CPU (a map with merges and tombstones), and the fourth frame's inputs.  It
is read out as numpy and handed to both packages.  Integers (block ids,
counts, keys, pixels, the index image, marks, colour bits) must match
exactly, floats to rtol 1e-5.  Normal components are unit-vector entries
and are compared at atol 1e-5 beside rtol: near zero a relative bound on a
cancellation-prone cross product says nothing.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfelmapping_tpu import surfels as jsurfels
from surfelmapping_tpu.config import CameraIntrinsics as JCam
from surfelmapping_tpu.config import PipelineParams as JParams
from surfelmapping_tpu.ops import active as jact
from surfelmapping_tpu.ops import frame_surfels as jfs
from surfelmapping_tpu.ops import fusion as jfus
from surfelmapping_tpu_torch import convert
from surfelmapping_tpu_torch.config import MapConfig, PipelineParams
from surfelmapping_tpu_torch.io.synthetic import SyntheticScene, tiny_cam
from surfelmapping_tpu_torch.ops import active as tact
from surfelmapping_tpu_torch.ops import frame_surfels as tfs
from surfelmapping_tpu_torch.ops import fusion as tfus
from surfelmapping_tpu_torch.ops.preprocess import preprocess_frame, remove_movings
from surfelmapping_tpu_torch.ops.transforms import compose, invert_se3
from surfelmapping_tpu_torch.pipeline import SurfelMapper

PARAMS = dict(fuse_thresh_factor=0.05, stereo_border=16.0)
BLOCK = 64
NORMALS = {"nx", "ny", "nz", "wnx", "wny", "wnz"}


def compare(got, want, name=""):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    if g.dtype == np.int32 and w.dtype == np.float32:  # colorsem bits
        w = w.view(np.int32)
    if g.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    else:
        atol = 1e-5 if name in NORMALS else 0.0
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def state():
    """Numpy state: a fused map and frame 3's inputs."""
    cam = tiny_cam()
    params = PipelineParams(**PARAMS)
    m = SurfelMapper(cam, params, MapConfig(capacity=1 << 13, block_size=BLOCK),
                     device="cpu")
    scene = SyntheticScene(cam, step=0.4)
    for i in range(3):
        m.process_frame(*scene.frame(i))
    cols, count = convert.map_to_numpy(m._smap)
    rgb, depth_mm, sem, pose = scene.frame(3)
    sem_t = torch.from_numpy(sem.astype(np.int32))
    pose_t = torch.from_numpy(pose)
    filtered = preprocess_frame(torch.from_numpy(depth_mm.astype(np.int32)), sem_t, cam, params)
    T_c2l = compose(invert_se3(m.last_pose), pose_t)
    depth = remove_movings(filtered, sem_t, m.last_depth, T_c2l, cam, params)
    return dict(
        cols=cols, count=count, depth=depth.numpy(),
        rgb=(rgb.astype(np.float32) / np.float32(255.0)), sem=sem.astype(np.int32),
        pose=pose, T_inv=invert_se3(pose_t).numpy(), time=3.0,
    )


@pytest.fixture(scope="module")
def both(state):
    """Every stage of the fusion step on both sides, from equal inputs."""
    jcam = JCam(**dataclasses.asdict(tiny_cam()))
    jp, tp = JParams(**PARAMS), PipelineParams(**PARAMS)
    J = lambda a: jnp.asarray(a)  # noqa: E731
    T = torch.from_numpy
    jmap = jsurfels.SurfelMap(**{k: J(v) for k, v in state["cols"].items()},
                              count=jnp.int32(state["count"]))
    tmap = convert.map_from_numpy(state["cols"], state["count"], "cpu")
    cam = tiny_cam()
    out = dict(jcam=jcam, cam=cam, jp=jp, tp=tp, jmap=jmap, tmap=tmap)

    nb = 64
    out["j_plan"] = jact.plan_active_blocks(jmap, J(state["T_inv"]), jcam, jp, nb, BLOCK)
    out["t_plan"] = tact.plan_active_blocks(tmap, T(state["T_inv"]), cam, tp, nb, BLOCK)
    jat = jact.gather_active(jmap, out["j_plan"][0], BLOCK)
    tat = tact.gather_active(tmap, out["t_plan"][0], BLOCK)
    out["j_gather"], out["t_gather"] = jat, tat
    kw = dict(min_depth=1.0, max_depth=30.0, fuse_thresh=0.05, is_clean=False)
    jat, out["j_removed"] = jact.conflict_active(jat, J(state["depth"]), J(state["sem"]),
                                                 J(state["T_inv"]), jcam, jp, **kw)
    tat, out["t_removed"] = tact.conflict_active(tat, T(state["depth"]), T(state["sem"]),
                                                 T(state["T_inv"]), cam, tp, **kw)
    out["j_conflict"], out["t_conflict"] = jat, tat
    jt = jnp.float32(state["time"])
    out["j_cand"] = jact.index_candidates(jat, J(state["T_inv"]), jt, jcam, jp)
    out["t_cand"] = tact.index_candidates(tat, T(state["T_inv"]), state["time"], cam, tp)
    out["j_index"] = jact.index_active(jat, J(state["T_inv"]), jt, jcam, jp)
    out["t_index"] = tact.index_active(tat, T(state["T_inv"]), state["time"], cam, tp)
    out["j_assoc"] = jact.associate_active(
        J(state["depth"]), J(state["rgb"]), J(state["sem"]), out["j_index"], jat,
        J(state["pose"]), J(state["T_inv"]), jt, jcam, jp)
    out["t_assoc"] = tact.associate_active(
        T(state["depth"]), T(state["rgb"]), T(state["sem"]), out["t_index"], tat,
        T(state["pose"]), T(state["T_inv"]), state["time"], cam, tp)
    out["j_fused"] = jact.fuse_append_map(jmap, jat, out["j_assoc"], BLOCK)
    tmap_copy = tmap.clone()
    out["t_fused"] = tact.fuse_append_map(tmap_copy, tat, out["t_assoc"])
    return out


FS_FUNCS = ["backproject", "central_normals", "surfel_radius", "checkerboard",
            "neighbours_nonzero", "ray_geometry", "feedback_surfels",
            "association_candidates", "pixel_grid"]


@pytest.mark.parametrize("fn", FS_FUNCS)
def test_frame_surfels_match_jax(fn, state):
    jcam = JCam(**dataclasses.asdict(tiny_cam()))
    cam = tiny_cam()
    jp, tp = JParams(**PARAMS), PipelineParams(**PARAMS)
    d, rgb, sem = state["depth"], state["rgb"], state["sem"]
    if fn in ("backproject", "central_normals"):
        want = getattr(jfs, fn)(jnp.asarray(d), jcam)
        got = getattr(tfs, fn)(torch.from_numpy(d), cam)
        names = ("x", "y", "z") if fn == "backproject" else ("nx", "ny", "nz")
    elif fn == "surfel_radius":
        nz = tfs.central_normals(torch.from_numpy(d), cam)[2]
        want = (jfs.surfel_radius(jnp.asarray(d), jnp.asarray(nz.numpy()), jcam),)
        got = (tfs.surfel_radius(torch.from_numpy(d), nz, cam),)
        names = ("radius",)
    elif fn in ("checkerboard", "ray_geometry", "pixel_grid"):
        want = getattr(jfs, fn)(jcam)
        got = getattr(tfs, fn)(cam, "cpu")
        want, got = (want,) if fn == "checkerboard" else want, (got,) if fn == "checkerboard" else got
        names = (fn,) * len(got)
    elif fn == "neighbours_nonzero":
        want = (jfs.neighbours_nonzero(jnp.asarray(d)),)
        got = (tfs.neighbours_nonzero(torch.from_numpy(d)),)
        names = (fn,)
    else:
        jf = getattr(jfs, fn)(jnp.asarray(d), jnp.asarray(rgb), jnp.asarray(sem), jcam, jp)
        tf = getattr(tfs, fn)(torch.from_numpy(d), torch.from_numpy(rgb),
                              torch.from_numpy(sem), cam, tp)
        names = tuple(f.name for f in dataclasses.fields(tf))
        want = tuple(getattr(jf, k) for k in names)
        got = tuple(getattr(tf, k) for k in names)
    for g, w, n in zip(got, want, names):
        compare(g, w, n)


@pytest.mark.parametrize("trailing", [(), (3,)])
def test_checkerboard_flat_lattice_order(trailing, rng):
    img = rng.standard_normal((96, 128) + trailing).astype(np.float32)
    compare(tact.checkerboard_flat(torch.from_numpy(img)),
            jact.checkerboard_flat(jnp.asarray(img)), "lattice")


@pytest.mark.parametrize("num_blocks", [64, 3])
def test_plan_active_blocks_exact(num_blocks, both, state):
    """Block ids and the true active count; a budget of 3 overflows and
    must keep the newest blocks."""
    T_inv = state["T_inv"]
    jb, jn = jact.plan_active_blocks(both["jmap"], jnp.asarray(T_inv), both["jcam"],
                                     both["jp"], num_blocks, BLOCK)
    tb, tn = tact.plan_active_blocks(both["tmap"], torch.from_numpy(T_inv), both["cam"],
                                     both["tp"], num_blocks, BLOCK)
    compare(tb, jb, "blk")
    assert int(tn) == int(jn) > 3


def test_gather_active_exact(both):
    ja, ta = both["j_gather"], both["t_gather"]
    for f in dataclasses.fields(ta):
        compare(getattr(ta, f.name), getattr(ja, f.name), f.name)
    assert bool(ta.slot_valid.any()) and not bool(ta.slot_valid.all())


def test_conflict_active_matches(both):
    compare(both["t_conflict"].conf, both["j_conflict"].conf, "conf")
    assert int(both["t_removed"]) == int(both["j_removed"]) > 0


def test_index_candidates_and_image_exact(both):
    for g, w, n in zip(both["t_cand"], both["j_cand"], ("zkey", "fpix")):
        compare(g, w, n)
    compare(both["t_index"], both["j_index"], "index image")
    assert int((both["t_index"] >= 0).sum()) > 100


def test_associate_active_matches(both):
    ja, ta = both["j_assoc"], both["t_assoc"]
    for f in dataclasses.fields(ta):
        name = {"nx": "wnx", "ny": "wny", "nz": "wnz"}.get(f.name, f.name)
        compare(getattr(ta, f.name), getattr(ja, f.name), name)
    marks = ta.mark.numpy()
    assert (marks >= 0).sum() > 0 and (marks == -1).sum() > 0, "need merges and news"


def test_fuse_append_map_matches(both):
    (jm, jd), (tm, td) = both["j_fused"], both["t_fused"]
    assert int(tm.count) == int(jm.count) > both["tmap"].count
    assert int(td) == int(jd) == 0
    for k in ("px", "py", "pz", "conf", "colorsem", "init_t", "last_t",
              "nx", "ny", "nz", "radius"):
        compare(tm.column(k), getattr(jm, k), k)


@pytest.mark.parametrize("prefix", [None, 4096])
def test_compact_matches(prefix, both):
    jm = jfus.compact(both["jmap"], prefix=prefix)
    tm = tfus.compact(both["tmap"].clone(), prefix=prefix)
    assert int(tm.count) == int(jm.count) < int(both["tmap"].count)
    for k in ("px", "conf", "colorsem", "init_t", "nz", "radius"):
        compare(tm.column(k), getattr(jm, k), k)


def test_compact_prefix_below_count_raises(both):
    with pytest.raises(ValueError, match="prefix"):
        tfus.compact(both["tmap"].clone(), prefix=BLOCK)


def test_initialize_map_matches(state):
    jcam = JCam(**dataclasses.asdict(tiny_cam()))
    jp, tp = JParams(**PARAMS), PipelineParams(**PARAMS)
    d, rgb, sem, pose = state["depth"], state["rgb"], state["sem"], state["pose"]
    jf = jfs.feedback_surfels(jnp.asarray(d), jnp.asarray(rgb), jnp.asarray(sem), jcam, jp)
    tf = tfs.feedback_surfels(torch.from_numpy(d), torch.from_numpy(rgb),
                              torch.from_numpy(sem), tiny_cam(), tp)
    cap = 4096
    jm, jd = jfus.initialize_map(jsurfels.empty_map(cap), jf, jnp.asarray(pose), 0.0)
    from surfelmapping_tpu_torch.surfels import empty_map

    tm, td = tfus.initialize_map(empty_map(cap, "cpu"), tf, torch.from_numpy(pose), 0.0)
    assert int(tm.count) == int(jm.count) > 0 and int(td) == int(jd) == 0
    for k in ("px", "py", "pz", "conf", "colorsem", "nx", "ny", "nz", "radius"):
        compare(tm.column(k), getattr(jm, k), k)


@pytest.mark.parametrize("is_clean", [True, False])
def test_conflict_pass_matches(is_clean, both, state):
    # cleanPoints' gates, and the fusion step's (which the port's
    # conflict_active applies to the active table)
    kw = (dict(min_depth=1.0, max_depth=15.0, fuse_thresh=0.1, is_clean=True) if is_clean
          else dict(min_depth=1.0, max_depth=30.0, fuse_thresh=0.05, is_clean=False))
    want = jfus.conflict_pass(both["jmap"], jnp.asarray(state["depth"]),
                              jnp.asarray(state["sem"]), jnp.asarray(state["T_inv"]),
                              both["jcam"], both["jp"], **kw)
    got = tfus.conflict_pass(both["tmap"], torch.from_numpy(state["depth"]),
                             torch.from_numpy(state["sem"]), torch.from_numpy(state["T_inv"]),
                             both["cam"], both["tp"], **kw)
    compare(got, want, "conf")
    if not is_clean:
        assert int((got != both["tmap"].column("conf")).sum()) > 0
