"""Port parity, the reference-form fusion ops: ops/index_map.py
(scatter_argmin_image, project_surfels, build_index_map, gather_fields),
ops/association.py (associate) and the forms of ops/active.py that the
active engine replaced or that the sharded engine runs (index_resolve,
fuse_active, append_flat, append_round_robin, fuse_append_shard).

The state is a real one, as in tests/test_torch_active.py: three synthetic
frames fused by the port on the CPU, read out as numpy and handed to both
packages, and the fourth frame's association.  The JAX functions are not
jitted, so they run op by op and round each operation as PyTorch does:
every comparison here is bit for bit (integers, colour words and float
bits alike) unless a test says otherwise.
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
from surfelmapping_tpu.ops import association as jassoc
from surfelmapping_tpu.ops import index_map as jim
from surfelmapping_tpu_torch import convert
from surfelmapping_tpu_torch.config import MapConfig, PipelineParams
from surfelmapping_tpu_torch.io.synthetic import SyntheticScene, tiny_cam
from surfelmapping_tpu_torch.ops import active as tact
from surfelmapping_tpu_torch.ops import association as tassoc
from surfelmapping_tpu_torch.ops import index_map as tim
from surfelmapping_tpu_torch.ops.colors import encode_color
from surfelmapping_tpu_torch.ops.preprocess import preprocess_frame, remove_movings
from surfelmapping_tpu_torch.ops.transforms import compose, invert_se3
from surfelmapping_tpu_torch.pipeline import SurfelMapper
from surfelmapping_tpu_torch.surfels import COLUMNS

PARAMS = dict(fuse_thresh_factor=0.05, stereo_border=16.0)
BLOCK = 64
INT32_MAX = 2**31 - 1


def same(got, want, name=""):
    """Bit-equal: integers as they are, floats by their bits (the colour
    word is int32 bits in the port, float32 bits in the JAX package)."""
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    if g.dtype.kind == "f" or w.dtype.kind == "f":
        g = g.astype(np.float32, copy=False).view(np.int32) if g.dtype.kind == "f" else g
        w = w.astype(np.float32, copy=False).view(np.int32) if w.dtype.kind == "f" else w
    np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64), err_msg=name)


@pytest.fixture(scope="module")
def state():
    cam = tiny_cam()
    params = PipelineParams(**PARAMS)
    m = SurfelMapper(cam, params, MapConfig(capacity=1 << 13, block_size=BLOCK), device="cpu")
    scene = SyntheticScene(cam, step=0.4)
    for i in range(3):
        m.process_frame(*scene.frame(i))
    cols, count = convert.map_to_numpy(m._smap)
    rgb, depth_mm, sem, pose = scene.frame(3)
    sem_t, pose_t = torch.from_numpy(sem.astype(np.int32)), torch.from_numpy(pose)
    filtered = preprocess_frame(torch.from_numpy(depth_mm.astype(np.int32)), sem_t, cam, params)
    depth = remove_movings(filtered, sem_t, m.last_depth,
                           compose(invert_se3(m.last_pose), pose_t), cam, params)
    return dict(cols=cols, count=count, depth=depth.numpy(),
                rgb=rgb.astype(np.float32) / np.float32(255.0), sem=sem.astype(np.int32),
                pose=pose, T_inv=invert_se3(pose_t).numpy(), time=3.0)


@pytest.fixture(scope="module")
def both(state):
    """The two maps, the frame's active table and association on both sides."""
    J, T = jnp.asarray, torch.from_numpy
    jcam, cam = JCam(**dataclasses.asdict(tiny_cam())), tiny_cam()
    jp, tp = JParams(**PARAMS), PipelineParams(**PARAMS)
    jmap = jsurfels.SurfelMap(**{k: J(v) for k, v in state["cols"].items()},
                              count=jnp.int32(state["count"]))
    tmap = convert.map_from_numpy(state["cols"], state["count"], "cpu")
    jblk, _ = jact.plan_active_blocks(jmap, J(state["T_inv"]), jcam, jp, 64, BLOCK)
    tblk, tn = tact.plan_active_blocks(tmap, T(state["T_inv"]), cam, tp, 64, BLOCK)
    jat = jact.gather_active(jmap, jblk, BLOCK)
    tat = tact.gather_active(tmap, tblk, BLOCK)
    jt = jnp.float32(state["time"])
    jidx = jact.index_active(jat, J(state["T_inv"]), jt, jcam, jp)
    tidx = tact.index_active(tat, T(state["T_inv"]), state["time"], cam, tp,
                             tact.valid_prefix(tn, tblk.shape[0], BLOCK))
    jas = jact.associate_active(J(state["depth"]), J(state["rgb"]), J(state["sem"]), jidx,
                                jat, J(state["pose"]), J(state["T_inv"]), jt, jcam, jp)
    tas = tact.associate_active(T(state["depth"]), T(state["rgb"]), T(state["sem"]), tidx,
                                tat, T(state["pose"]), T(state["T_inv"]), state["time"],
                                cam, tp)
    assert int((tas.mark >= 0).sum()) > 0 and int((tas.mark == -1).sum()) > 0
    return dict(jcam=jcam, cam=cam, jp=jp, tp=tp, jmap=jmap, tmap=tmap, jat=jat, tat=tat,
                jas=jas, tas=tas)


# -- ops/index_map.py ---------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "ties", "all_invalid"])
def test_scatter_argmin_image_exact(case, rng):
    n, P = 5000, 700
    pix = rng.integers(0, P, n).astype(np.int32)
    z = rng.uniform(0.5, 40.0, n).astype(np.float32)
    valid = rng.random(n) < 0.7
    if case == "ties":  # planted equal depths: the smallest element id wins
        z[:] = z[rng.integers(0, 20, n)]
    if case == "all_invalid":
        valid[:] = False
    want = jim.scatter_argmin_image(jnp.asarray(pix), jnp.asarray(z), jnp.asarray(valid), P)
    got = tim.scatter_argmin_image(torch.from_numpy(pix), torch.from_numpy(z),
                                   torch.from_numpy(valid), P)
    for g, w, name in zip(got, want, ("id", "key")):
        same(g, w, name)
    assert (got[0] >= 0).any() != (case == "all_invalid")


def test_project_surfels_and_build_index_map_exact(state, both):
    J, T = jnp.asarray, torch.from_numpy
    want = jim.project_surfels(both["jmap"], J(state["T_inv"]), both["jcam"])
    got = tim.project_surfels(both["tmap"], T(state["T_inv"]), both["cam"])
    for g, w, name in zip(got, want, "xyzuv"):
        same(g, w, name)
    want = jim.build_index_map(both["jmap"], J(state["T_inv"]), jnp.float32(state["time"]),
                               both["jcam"], both["jp"])
    got = tim.build_index_map(both["tmap"], T(state["T_inv"]), state["time"], both["cam"],
                              both["tp"])
    same(got, want, "index image")
    assert int((got >= 0).sum()) > 100


def test_gather_fields_exact(state, both, rng):
    ids = rng.integers(-3, state["count"] + 3, (9, 11)).astype(np.int32)  # some clamp
    want = jim.gather_fields(both["jmap"], jnp.asarray(ids), jnp.asarray(state["T_inv"]))
    got = tim.gather_fields(both["tmap"], torch.from_numpy(ids), torch.from_numpy(state["T_inv"]))
    assert sorted(got) == sorted(want)
    for k in want:
        same(got[k], want[k], k)


# -- ops/association.py -------------------------------------------------------

def _associate_both(state, both):
    """The port's full-map associate, and the JAX package's active-table
    association on the whole map viewed as a table (its index image with
    surfel 0 masked out, the full form's ``id > 0`` rule)."""
    J, T = jnp.asarray, torch.from_numpy
    jt = jnp.float32(state["time"])
    jidx = jim.build_index_map(both["jmap"], J(state["T_inv"]), jt, both["jcam"], both["jp"])
    jidx = jnp.where(jidx > 0, jidx, -1)
    want = jact.associate_active(J(state["depth"]), J(state["rgb"]), J(state["sem"]), jidx,
                                 jact.table_from_map(both["jmap"]), J(state["pose"]),
                                 J(state["T_inv"]), jt, both["jcam"], both["jp"])
    tidx = tim.build_index_map(both["tmap"], T(state["T_inv"]), state["time"], both["cam"],
                               both["tp"])
    got = tassoc.associate(T(state["depth"]), T(state["rgb"]), T(state["sem"]), tidx,
                           both["tmap"], T(state["pose"]), T(state["T_inv"]), state["time"],
                           both["cam"], both["tp"])
    return got, want


def test_associate_matches_the_active_form_on_the_whole_map(state, both):
    """The full-map records on the checkerboard lattice equal the JAX
    active-table association's, field for field and bit for bit; a merge's
    init_t is the map's (the active form leaves it 0 and keeps it in place);
    off the lattice every pixel is invalid (mark -10)."""
    got, want = _associate_both(state, both)
    cb = tact.checkerboard_flat
    mark = cb(got.mark)
    same(mark, want.mark, "mark")
    for j, wnm in enumerate(("x", "y", "z")):
        same(cb(got.pos[..., j]), getattr(want, wnm), wnm)
    for j, wnm in enumerate(("nx", "ny", "nz")):
        same(cb(got.normal[..., j]), getattr(want, wnm), wnm)
    for name in ("conf", "radius", "last_t"):
        same(cb(getattr(got, name)), getattr(want, name), name)
    same(encode_color(cb(got.rgb), cb(got.sem)), want.colorsem, "colorsem")
    merged = mark >= 0
    map_init = both["tmap"].column("init_t")[torch.clamp(mark, min=0).long()]
    same(cb(got.init_t), torch.where(merged, map_init, torch.tensor(np.asarray(want.init_t))),
         "init_t")
    lattice = (torch.arange(got.mark.shape[0])[:, None]
               + torch.arange(got.mark.shape[1])[None, :]) % 2 == 1
    assert bool((got.mark[~lattice] == -10).all())
    assert int(merged.sum()) > 0 and int((mark == -1).sum()) > 0


def test_jax_full_map_associate_raises(state, both):
    """A JAX-side fault the port leaves out: surfelmapping_tpu's full-map
    ``associate`` unpacks ray_geometry's three values into two
    (ops/association.py:93) and reads keys its planar modules no longer
    have; it raises before computing anything.  The port's associate
    implements the documented contract (the test above)."""
    J = jnp.asarray
    jidx = jim.build_index_map(both["jmap"], J(state["T_inv"]), jnp.float32(3.0), both["jcam"],
                               both["jp"])
    with pytest.raises(ValueError, match="unpack"):
        jassoc.associate(J(state["depth"]), J(state["rgb"]), J(state["sem"]), jidx,
                         both["jmap"], J(state["pose"]), J(state["T_inv"]), jnp.float32(3.0),
                         both["jcam"], both["jp"])


# -- ops/active.py: index_resolve ---------------------------------------------

@pytest.mark.parametrize("form", ["plain", "depth_buf", "keep_empty"])
def test_index_resolve_exact(form, rng):
    A, P = 4000, 900
    zkey = rng.integers(0, 50, A).astype(np.int32)  # many equal keys: ties
    zkey[rng.random(A) < 0.2] = INT32_MAX
    fpix = np.where(zkey == INT32_MAX, P, rng.integers(0, P, A)).astype(np.int32)
    ids = rng.permutation(A).astype(np.int32)
    kw = {}
    if form == "depth_buf":  # an injected depth image, as the all-reduced one
        buf = rng.integers(0, 60, P).astype(np.int32)
        kw = dict(depth_buf=buf)
    if form == "keep_empty":
        kw = dict(empty_to_minus1=False)
    want = jact.index_resolve(jnp.asarray(zkey), jnp.asarray(fpix), jnp.asarray(ids), P,
                              **{k: jnp.asarray(v) if k == "depth_buf" else v
                                 for k, v in kw.items()})
    got = tact.index_resolve(torch.from_numpy(zkey), torch.from_numpy(fpix),
                             torch.from_numpy(ids), P,
                             **{k: torch.from_numpy(v) if k == "depth_buf" else v
                                for k, v in kw.items()})
    same(got, want, "id_buf")
    empty = INT32_MAX if form == "keep_empty" else -1
    assert (got.numpy() == empty).any() and (got.numpy() != empty).any()


def test_index_resolve_equals_k1_plain(state, both):
    """K1's plain version (ops/zbuf.py) on the frame's candidates resolves
    the same winners as the three-op form with candidate ids."""
    from surfelmapping_tpu_torch.ops.zbuf import zbuffer_argmin

    tat = both["tat"]
    zkey, fpix = tact.index_candidates(tat, torch.from_numpy(state["T_inv"]), state["time"],
                                       both["cam"], both["tp"])
    P = both["cam"].height * both["cam"].width
    ids = torch.arange(tat.size, dtype=torch.int32)
    want = tact.index_resolve(torch.where(tat.slot_valid, zkey, INT32_MAX), fpix, ids, P,
                              empty_to_minus1=False)
    _, got = zbuffer_argmin(zkey, fpix, P, tat.slot_valid)
    assert torch.equal(got, want)


# -- ops/active.py: the frame's tail --------------------------------------------

def _table_cols(at):
    return {f.name: getattr(at, f.name) for f in dataclasses.fields(at)}


def test_fuse_active_exact(both):
    want = jact.fuse_active(both["jat"], both["jas"])
    before = {k: v.clone() for k, v in _table_cols(both["tat"]).items()}
    got = tact.fuse_active(both["tat"], both["tas"])
    for name, v in _table_cols(got).items():
        same(v, getattr(want, name), name)
    for name, v in _table_cols(both["tat"]).items():  # the input is a value
        assert torch.equal(v, before[name]), name
    assert not torch.equal(got.conf, both["tat"].conf)


def _assoc_from_jax(jas, n=None):
    cols = {f.name: np.asarray(getattr(jas, f.name))[:n] for f in dataclasses.fields(jas)}
    cols["colorsem"] = cols["colorsem"].view(np.int32)
    cols["mark"] = cols["mark"].astype(np.int64)
    return tact.AssocFlat(**{k: torch.from_numpy(v.copy()) for k, v in cols.items()})


def _jax_map(cols, count):
    return jsurfels.SurfelMap(**{k: jnp.asarray(v) for k, v in cols.items()},
                              count=jnp.int32(count))


def _same_map(tm, jm, name):
    assert int(tm.count) == int(jm.count), name
    for k in COLUMNS:
        same(tm.column(k), getattr(jm, k), f"{name}:{k}")


# capacity, count: the staging-window branch (capacity >= Vp) with room, with
# count + Vp over capacity (nothing appended, however few are new), and the
# direct-scatter branch (capacity < Vp) that appends what fits
APPEND_CASES = {"window": (1 << 13, None), "window_overflow": (8192, 8192 - 6000),
                "scatter": (4096, None), "scatter_overflow": (4096, 4096 - 40)}


@pytest.mark.parametrize("case", list(APPEND_CASES))
def test_append_flat_both_branches_exact(case, state, both):
    cap, count = APPEND_CASES[case]
    cols = {k: v[:cap] if len(v) >= cap else np.pad(v, (0, cap - len(v)))
            for k, v in state["cols"].items()}
    count = state["count"] if count is None else count
    Vp = int(both["tas"].mark.shape[0])
    assert (cap >= Vp) == case.startswith("window")
    jm, jd = jact.append_flat(_jax_map(cols, count), both["jas"])
    tm, td = tact.append_flat(convert.map_from_numpy(cols, count, "cpu"), both["tas"])
    _same_map(tm, jm, case)
    n_new = int((both["tas"].mark == -1).sum())
    assert int(td) == int(jd)
    assert (int(td) > 0) == case.endswith("overflow")
    if case == "window_overflow":  # all or nothing, though n_new would fit
        assert count + n_new <= cap and int(td) == n_new


@pytest.mark.parametrize("rank", [0, 1, 2])
@pytest.mark.parametrize("overflow", [False, True], ids=["room", "overflow"])
def test_append_round_robin_exact(rank, overflow, state, both):
    D = 3
    count = len(state["cols"]["px"]) - 10 if overflow else state["count"]
    jm, jd = jact.append_round_robin(_jax_map(state["cols"], count), both["jas"], D,
                                     jnp.int32(rank))
    tm, td = tact.append_round_robin(convert.map_from_numpy(state["cols"], count, "cpu"),
                                     both["tas"], D, rank)
    _same_map(tm, jm, f"rank {rank}")
    assert int(td) == int(jd)
    assert (int(td) > 0) == overflow


def test_round_robin_shards_hold_the_single_append_set(state, both):
    """The union of the D shards' appends is append_flat's set of records."""
    D = 3
    one, _ = tact.append_flat(convert.map_from_numpy(state["cols"], state["count"], "cpu"),
                              both["tas"])
    ref = torch.stack([one.column(k)[state["count"]:int(one.count)].view(torch.int32)
                       for k in COLUMNS], 1)
    parts = []
    for r in range(D):
        m, _ = tact.append_round_robin(convert.map_from_numpy(state["cols"], state["count"],
                                                              "cpu"), both["tas"], D, r)
        parts.append(torch.stack([m.column(k)[state["count"]:int(m.count)].view(torch.int32)
                                  for k in COLUMNS], 1))
    got = torch.cat(parts)
    assert got.shape == ref.shape
    key = lambda t: sorted(map(tuple, t.tolist()))  # noqa: E731
    assert key(got) == key(ref)


@pytest.mark.parametrize("rank", [0, 2])
def test_fuse_append_shard_exact(rank, both):
    D = 3
    jm, jd = jact.fuse_append_shard(both["jmap"], both["jat"], both["jas"], BLOCK, D,
                                    jnp.int32(rank))
    tm, td = tact.fuse_append_shard(both["tmap"].clone(), both["tat"], both["tas"], D, rank)
    _same_map(tm, jm, f"rank {rank}")
    assert int(td) == int(jd) == 0
