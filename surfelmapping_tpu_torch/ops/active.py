"""Active-block fusion engine: per-frame cost O(in-frustum surfels), not
O(map capacity) (counterpart of surfelmapping_tpu/ops/active.py).

  1. ``plan_active_blocks``  — one dense pass over the whole map computes
     per-surfel view/conflict gates and reduces them to per-*block* activity
     (block = 2048 contiguous slots; surfels append in scan order, so
     frustum residency is efficient at block granularity) through
     ``choose_blocks``; the render cull shares its second half,
     ``choose_from_blocks``, which takes a block mask.
  2. ``gather_active``       — gathers the active blocks into a fixed-size
     *active table* of flat 1-D columns.
  3. conflict / index / associate run on the active table with the exact
     reference semantics (same gates, marks and quirks as the JAX package).
  4. ``fuse_append_map``     — writes the active blocks back, the merged
     records over their map slots and the new surfels at the map tail in the
     reference's column-major lattice order, in place.

Removal is deferred: conflict drives conf <= 0 (tombstones); ops/fusion.py
``compact`` reclaims them at capacity-growth / checkpoint / clean
boundaries.  Parity notes: conflict has no timeDelta gate, so planning keys
on frustum membership; the ``id > 0`` quirk (surfel 0 unmatchable,
data.vert:142, conflict.geom:17) is applied on GLOBAL slot ids; the index
image holds ACTIVE-table positions.

The reference forms that the active engine replaced on the fusion path
(``index_resolve``, the three-op z-buffer K1 is held to; ``fuse_active``;
``append_flat``) and the shard forms of the frame's tail
(``append_round_robin``, ``fuse_append_shard``, which parallel/sharded.py
runs) close the module.

Nothing here reads a value back to the host: out-of-range writes go to the
map's spare slot (surfels.py), and no boolean-mask indexing is used.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import CameraIntrinsics, PipelineParams
from ..surfels import SurfelMap
from .associate_merge import associate_merge
from .frame_surfels import association_candidates, ray_geometry
from .index_map import INT32_MAX, _depth_key, project_surfels
from .transforms import (acos, ieee_sqrt, normalize_planar, project_planar, rotate_planar,
                         safe_divisor, transform_planar)
from .zbuf import zbuffer_argmin


# ---------------------------------------------------------------------------
# Checkerboard slicing (the reference's 1/2-sparse lattice, data.vert:88)
# ---------------------------------------------------------------------------

def checkerboard_flat(img: torch.Tensor) -> torch.Tensor:
    """Extract the (x+y)%2==1 checkerboard pixels of an [H,W,...] image as a
    flat [(H*W)//2, ...] tensor in EXACT column-major lattice order (u outer,
    v inner) — the reference's uv feedback-lattice traversal
    (src/FeedbackBuffer.cpp:43-59), so appended surfels get identical ids.

    Requires even H and W."""
    H, W = img.shape[:2]
    if H % 2 or W % 2:
        raise ValueError(f"checkerboard_flat needs even dims, got {H}x{W}")
    rest = tuple(img.shape[2:])
    v = img.reshape((H // 2, 2, W // 2, 2) + rest)
    a = v[:, 1, :, 0].transpose(0, 1)  # u even -> v odd   (W/2, H/2, ...)
    b = v[:, 0, :, 1].transpose(0, 1)  # u odd  -> v even  (W/2, H/2, ...)
    inter = torch.stack([a, b], dim=1)  # (W/2, 2, H/2, ...)
    return inter.reshape((W * H // 2,) + rest)


# ---------------------------------------------------------------------------
# Active table
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ActiveTable:
    """The gathered in-frustum working set as flat 1-D columns (A slots).

    ``global_id`` maps active slot -> map slot; ``blk`` holds the gathered
    block ids (G = capacity/block_size marks padding).  ``slot_valid``
    masks padding slots, whose contents are the clamped gather of block G-1.

    Prefix contract: the valid slots form a PREFIX of the table
    (``slot_valid`` is non-increasing), because plan_active_blocks orders
    active blocks first.  The index-map z-buffer reads only the first
    n_valid candidates (:func:`valid_prefix`, or sum(slot_valid)) and relies
    on it; a table with interleaved invalid slots would lose valid
    candidates (the kernel wrapper checks a mask on its CPU path,
    ops/zbuf.py).
    """

    x: torch.Tensor          # f32[A]
    y: torch.Tensor          # f32[A]
    z: torch.Tensor          # f32[A]
    conf: torch.Tensor       # f32[A]
    colorsem: torch.Tensor   # i32[A] packed (sem<<24|r<<16|g<<8|b)
    init_t: torch.Tensor     # f32[A]
    last_t: torch.Tensor     # f32[A]
    nx: torch.Tensor         # f32[A]
    ny: torch.Tensor         # f32[A]
    nz: torch.Tensor         # f32[A]
    radius: torch.Tensor     # f32[A]
    global_id: torch.Tensor  # i64[A]
    slot_valid: torch.Tensor  # bool[A]
    blk: torch.Tensor        # i64[AB]

    @property
    def size(self) -> int:
        return self.x.shape[0]


# table column <- map column
_TABLE_COLS = dict(x="px", y="py", z="pz", conf="conf", colorsem="colorsem",
                   init_t="init_t", last_t="last_t", nx="nx", ny="ny", nz="nz",
                   radius="radius")


def _conflict_gates(u, v, z, cam: CameraIntrinsics, params: PipelineParams,
                    min_depth: float, max_depth: float) -> torch.Tensor:
    """conflict.vert:34 in-view test (inclusive upper bounds, stereo border),
    shared by planning and the conflict pass."""
    return (
        (u >= params.stereo_border)
        & (u <= cam.width)
        & (v >= 0)
        & (v <= cam.height)
        & (z > min_depth)
        & (z < max_depth)
    )


def block_any(slot_mask: torch.Tensor, block_size: int) -> torch.Tensor:
    """bool[G]: whether any slot of each block passes ``slot_mask``
    (bool[G * block_size])."""
    G = slot_mask.shape[0] // block_size
    return slot_mask.view(G, block_size).any(dim=1)


def choose_from_blocks(blk_act: torch.Tensor,
                       num_blocks: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`choose_blocks` from the block mask ``blk_act`` (bool[G]), as
    :func:`block_any` reduces a slot mask or the render cull's kernel
    computes it."""
    G = blk_act.shape[0]
    n_active = blk_act.sum(dtype=torch.int32)
    ids = torch.where(blk_act, torch.arange(G, device=blk_act.device), -1)
    ids = torch.sort(ids).values             # inactive (-1) first, actives ascending
    chosen = ids[max(G - num_blocks, 0):]    # most recent blocks win on overflow
    blk = torch.sort(torch.where(chosen >= 0, chosen, G)).values
    return blk, n_active


def choose_blocks(slot_mask: torch.Tensor, num_blocks: int,
                  block_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The block choice of the fusion plan and the render cull: a block is
    active if any of its slots passes the caller's gate ``slot_mask``
    (bool[G * block_size]).

    Returns (blk i64[num_blocks]: active block ids ascending, then filler
    id G; n_active: the total active block count, 0-d int32).  Overflow
    rule: if n_active > num_blocks, the num_blocks highest-id (most recently
    appended) active blocks are kept and the older ones dropped.  Both host
    loops repair an overflow by reading n_active and running again with a
    grown budget: the mapper's window verify
    (``SurfelMapper._repair_overflow``) and :func:`splat.render_view`'s
    budget loop."""
    return choose_from_blocks(block_any(slot_mask, block_size), num_blocks)


def plan_active_blocks(
    smap: SurfelMap,
    T_inv: torch.Tensor,
    cam: CameraIntrinsics,
    params: PipelineParams,
    num_blocks: int,
    block_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense O(capacity) pass -> the <= num_blocks active block ids, as
    :func:`choose_blocks` returns them.  A slot is active if it is live and
    passes the conflict in-view gate OR the index-map candidate gate (the
    timeDelta gate is deliberately NOT applied: stale in-view surfels must
    still reach the conflict pass)."""
    _, _, pc_z, u, v = project_surfels(smap, T_inv, cam)
    live = smap.column("conf") > 0.0
    confl = _conflict_gates(u, v, pc_z, cam, params, params.near_clip, params.far_clip)
    fa = params.index_factor
    pi = torch.ceil(u * fa).to(torch.int32) - 1
    pj = torch.ceil(v * fa).to(torch.int32) - 1
    idxg = (
        (pi >= 0) & (pi < cam.width * fa) & (pj >= 0) & (pj < cam.height * fa)
        & (pc_z > 0.0) & (pc_z < params.far_clip)
    )
    return choose_blocks(live & (confl | idxg), num_blocks, block_size)


def valid_prefix(n_active: torch.Tensor, num_blocks: int, block_size: int) -> torch.Tensor:
    """The valid prefix of the active table that :func:`gather_active`
    builds from :func:`choose_blocks`' ``n_active``: its slots of the
    true active blocks, at most ``num_blocks`` of them (0-d int32, equal to
    ``slot_valid.sum()``)."""
    return torch.clamp(n_active, max=num_blocks) * block_size


def gather_active(smap: SurfelMap, blk: torch.Tensor, block_size: int) -> ActiveTable:
    """Contiguous block gather into flat 1-D active columns.  Filler blocks
    (id G) gather block G-1, as JAX's clamped gather does; slot_valid masks
    them."""
    B = block_size
    G = smap.capacity // B
    src = blk.clamp(max=G - 1)

    def g1(name):
        return smap.column(name).view(G, B).index_select(0, src).reshape(-1)

    offs = torch.arange(B, device=blk.device)[None, :]
    gid = (blk[:, None] * B + offs).reshape(-1)
    slot_valid = (blk < G).repeat_interleave(B)
    return ActiveTable(
        **{t: g1(m) for t, m in _TABLE_COLS.items()},
        global_id=gid,
        slot_valid=slot_valid,
        blk=blk,
    )


def writeback_active(smap: SurfelMap, at: ActiveTable) -> SurfelMap:
    """Scatter the (possibly tombstoned) active slots back into the map, in
    place (JAX donated the map here); padding slots go to the spare slot.
    init_t is never modified by conflict/fuse, so it is not written back."""
    dest = torch.where(at.slot_valid, at.global_id, smap.capacity)
    for t, m in _TABLE_COLS.items():
        if m != "init_t":
            getattr(smap, m).index_copy_(0, dest, getattr(at, t))
    return smap


# ---------------------------------------------------------------------------
# Conflict (free-space violation) on the active table
# ---------------------------------------------------------------------------

def conflict_active(
    at: ActiveTable,
    depth: torch.Tensor,
    semantic: torch.Tensor,
    T_inv: torch.Tensor,
    cam: CameraIntrinsics,
    params: PipelineParams,
    min_depth: float,
    max_depth: float,
    fuse_thresh: float,
    is_clean: bool,
    gid_offset: int = 0,
) -> tuple[ActiveTable, torch.Tensor]:
    """conflict.vert/.geom + update_conf (src/GlobalModel.cpp:396-515) on the
    active table; the conf decrement tombstones the surfel.  ``gid_offset``
    turns a shard's local slot ids into global ids (the sharded step).

    Returns (table, n_removed): n_removed counts surfels whose conf crossed
    <= 0 this pass."""
    p = params
    H, W = cam.height, cam.width
    x, y, z, u, v = project_planar(T_inv, at.x, at.y, at.z, cam)
    in_view = _conflict_gates(u, v, z, cam, p, min_depth, max_depth)

    safe_z = safe_divisor(z)
    xl = x / safe_z
    yl = y / safe_z
    lam = ieee_sqrt(xl * xl + yl * yl + 1.0)

    ui = torch.clamp(torch.floor(u).to(torch.int64), 0, W - 1)
    vi = torch.clamp(torch.floor(v).to(torch.int64), 0, H - 1)
    flat = vi * W + ui
    # sky/hole substitutions folded into the image first, so one per-surfel
    # gather is paid (conflict.vert:49-58 semantics)
    hole = depth if is_clean else torch.where(depth == 0.0, max_depth + 20.0, depth)
    deff = torch.where(semantic == p.sky_class, max_depth + 1.0, hole)
    d = deff.reshape(-1)[flat]

    violates = (d * lam - z * lam) > (fuse_thresh * z)
    live = at.slot_valid & (at.conf > 0.0)
    # id>0: surfel 0 exempt (conflict.geom:17), on the GLOBAL id
    hit = live & (at.global_id + gid_offset > 0) & in_view & violates
    new_conf = torch.where(hit, at.conf - p.conflict_conf_decrement, at.conf)
    n_removed = (hit & (new_conf <= 0.0)).sum(dtype=torch.int32)
    return dataclasses.replace(at, conf=new_conf), n_removed


# ---------------------------------------------------------------------------
# Index map on the active table
# ---------------------------------------------------------------------------

def index_candidates(
    at: ActiveTable,
    T_inv: torch.Tensor,
    time: float,
    cam: CameraIntrinsics,
    params: PipelineParams,
    gid_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-surfel half of predictIndices: depth key + target pixel.

    Gates: z>0, z<farClip, timeDelta freshness, pixel bounds, conf>0
    (tombstones) and global id>0 (surfel 0 is unmatchable, data.vert:142;
    ``gid_offset`` as in :func:`conflict_active`).

    Returns (zkey i32[A], INT32_MAX = invalid; fpix i32[A], H*W = invalid)."""
    factor = params.index_factor
    icam = cam.scaled(factor)
    H, W = icam.height, icam.width
    _, _, z, u, v = project_planar(T_inv, at.x, at.y, at.z, icam)
    fresh = (time - at.last_t) <= params.time_delta
    pi = torch.ceil(u).to(torch.int32) - 1
    pj = torch.ceil(v).to(torch.int32) - 1
    inb = (pi >= 0) & (pi < W) & (pj >= 0) & (pj < H)
    valid = (
        at.slot_valid & (at.conf > 0.0) & (at.global_id + gid_offset > 0)
        & fresh & (z > 0.0) & (z < params.far_clip) & inb
    )
    key = _depth_key(z, valid)
    fpix = torch.where(valid, pj * W + pi, H * W).to(torch.int32)
    return key, fpix


def index_resolve(
    zkey: torch.Tensor,
    fpix: torch.Tensor,
    ids: torch.Tensor,
    num_pix: int,
    depth_buf: torch.Tensor | None = None,
    empty_to_minus1: bool = True,
) -> torch.Tensor:
    """The z-buffer half of predictIndices in its three-op form (scatter-min
    the keys, gather each candidate's pixel minimum, scatter-min the ids of
    the winners): the winner ``ids`` per pixel, flat [num_pix] of ids'
    dtype, -1 = empty.  K1 (ops/zbuf.py) computes the same function in one
    kernel and is held to this one.  ``depth_buf`` lets a distributed caller
    inject the all-reduced depth image between the passes; with
    ``empty_to_minus1=False`` empties stay INT32_MAX, so the result can feed
    a further MIN across ranks.  A pixel outside [0, num_pix) is dropped."""
    P = num_pix
    dev = zkey.device
    pix = torch.where((fpix >= 0) & (fpix < P), fpix, P).long()
    if depth_buf is None:
        buf = torch.full((P + 1,), INT32_MAX, dtype=torch.int32, device=dev)
        depth_buf = buf.scatter_reduce_(0, pix, zkey, "amin")[:P]
    valid = zkey != INT32_MAX
    win = depth_buf[torch.clamp(pix, max=P - 1)]
    is_win = valid & (zkey == win)
    id_buf = torch.full((P + 1,), INT32_MAX, dtype=ids.dtype, device=dev)
    id_buf.scatter_reduce_(0, torch.where(is_win, pix, P), ids, "amin")
    id_buf = id_buf[:P]
    if not empty_to_minus1:
        return id_buf
    return torch.where(id_buf == INT32_MAX, -1, id_buf)


def index_active(
    at: ActiveTable,
    T_inv: torch.Tensor,
    time: float,
    cam: CameraIntrinsics,
    params: PipelineParams,
    n_valid: torch.Tensor,
) -> torch.Tensor:
    """predictIndices (src/IndexMap.cpp:138-198) over the active table:
    i64[H*F, W*F] image of ACTIVE slot positions (-1 = empty), resolved by
    the scatter-argmin z-buffer (ops/zbuf.py).  Candidate ids ARE active
    positions, so no translation is needed.  ``n_valid`` is the table's
    valid prefix (0-d int32, :func:`valid_prefix`), so the z-buffer needs no
    count of ``at.slot_valid``."""
    icam = cam.scaled(params.index_factor)
    zkey, fpix = index_candidates(at, T_inv, time, cam, params)
    _, idbuf = zbuffer_argmin(zkey, fpix, icam.height * icam.width, n_valid)
    return torch.where(idbuf == INT32_MAX, -1, idbuf.long()).view(icam.height, icam.width)


# ---------------------------------------------------------------------------
# Association + merge on the checkerboard lattice (flat)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AssocFlat:
    """Per-checkerboard-pixel fusion records, flat [(H*W)//2] tensors in
    column-major lattice order.  Mark convention: -10 invalid | -1 new
    unstable | >=0 ACTIVE slot to fuse into."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    conf: torch.Tensor
    colorsem: torch.Tensor  # i32
    init_t: torch.Tensor
    last_t: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor
    radius: torch.Tensor
    mark: torch.Tensor      # i64


def _angle_between(ax, ay, az, bx, by, bz) -> torch.Tensor:
    """acos(a.b/(|a||b|)) exactly as data.vert:54-57 (component form)."""
    dot = ax * bx + ay * by + az * bz
    na = ieee_sqrt(ax * ax + ay * ay + az * az)
    nb = ieee_sqrt(bx * bx + by * by + bz * bz)
    cosv = dot / torch.clamp(na * nb, min=1e-12)
    return acos(torch.clamp(cosv, -1.0, 1.0))


# packed row layout of the association gather (all as int32 bits)
_PACKED = ("x", "y", "z", "conf", "colorsem", "nx", "ny", "nz", "radius")


def associate_active(
    depth: torch.Tensor,
    rgb: torch.Tensor,
    semantic: torch.Tensor,
    index_image: torch.Tensor,
    at: ActiveTable,
    pose: torch.Tensor,
    T_inv: torch.Tensor,
    time: float,
    cam: CameraIntrinsics,
    params: PipelineParams,
    fuse_thresh: float | None = None,
) -> AssocFlat:
    """The data.vert association + merge kernel on flat checkerboard pixels:
    :func:`associate_active_plain` for CPU tensors, one launch of the CUDA
    kernel (ops/associate_merge.py) for CUDA tensors, the same bits."""
    if fuse_thresh is None:
        fuse_thresh = params.fuse_thresh_factor
    if depth.device.type == "cpu":
        return associate_active_plain(depth, rgb, semantic, index_image, at, pose, T_inv,
                                      time, cam, params, fuse_thresh)
    return AssocFlat(**associate_merge(depth, rgb, semantic, index_image, at, pose, T_inv,
                                       time, cam, params, fuse_thresh))


def associate_active_plain(
    depth: torch.Tensor,
    rgb: torch.Tensor,
    semantic: torch.Tensor,
    index_image: torch.Tensor,
    at: ActiveTable,
    pose: torch.Tensor,
    T_inv: torch.Tensor,
    time: float,
    cam: CameraIntrinsics,
    params: PipelineParams,
    fuse_thresh: float | None = None,
) -> AssocFlat:
    """The association stage as eager PyTorch ops, on any device.

    Reproduced quirks: index validity ``id`` valid iff the slot maps to a
    global id > 0 (enforced at the index scatter); merged color = new color
    (data.vert:183); merged radius = min(new, old) (data.vert:193)."""
    p = params
    if fuse_thresh is None:
        fuse_thresh = p.fuse_thresh_factor
    factor = p.index_factor
    dev = depth.device

    cand = association_candidates(depth, rgb, semantic, cam, p)
    xl_img, yl_img, lam_img = ray_geometry(cam, dev)

    cb = checkerboard_flat
    c_px, c_py, c_pz = cb(cand.px), cb(cand.py), cb(cand.pz)
    c_nx, c_ny, c_nz = cb(cand.nx), cb(cand.ny), cb(cand.nz)
    c_rad = cb(cand.radius)
    c_conf = cb(cand.conf)
    c_cs = cb(cand.colorsem)
    c_sem = cb(cand.sem)
    c_valid = cb(cand.valid)
    c_lam = cb(lam_img)
    c_rayx, c_rayy = cb(xl_img), cb(yl_img)  # ray z component == 1
    c_depth = cb(depth)

    # ONE row gather of the nine attributes each pixel reads, packed as
    # int32 bits so the color bits travel untouched
    packed = torch.stack([getattr(at, k).view(torch.int32) for k in _PACKED], dim=1)

    best = None
    for wi in range(factor):
        for wj in range(factor):
            sub = index_image[wj::factor, wi::factor]
            mid = checkerboard_flat(sub)
            has = mid >= 0  # source already excluded global id 0
            safe = torch.where(has, mid, 0)
            rows = packed.index_select(0, safe)
            ox, oy, oz, o_conf = (rows[:, j].view(torch.float32) for j in range(4))
            o_cs = rows[:, 4]
            onx, ony, onz, o_rad = (rows[:, j].view(torch.float32) for j in range(5, 9))
            # camera-frame old vertex/normal
            px, py, pz = transform_planar(T_inv, ox, oy, oz)
            cnx, cny, cnz = normalize_planar(*rotate_planar(T_inv, onx, ony, onz))

            o_sem = (o_cs >> 24) & 0xFF
            depth_gate = torch.abs(pz * c_lam - c_depth * c_lam) <= fuse_thresh
            sem_gate = c_sem == o_sem
            # perpendicular ray distance |ray x p| / lam (data.vert:150)
            crx = c_rayy * pz - 1.0 * py
            cry = 1.0 * px - c_rayx * pz
            crz = c_rayx * py - c_rayy * px
            dist = ieee_sqrt(crx * crx + cry * cry + crz * crz) / c_lam
            ang = _angle_between(cnx, cny, cnz, c_nx, c_ny, c_nz)
            ok = has & sem_gate & depth_gate & (torch.abs(ang) < p.merge_normal_angle)
            dist = torch.where(ok, dist, torch.inf)
            entry = dict(
                dist=dist, id=mid, px=px, py=py, pz=pz, conf=o_conf,
                cs=o_cs, nx=cnx, ny=cny, nz=cnz, rad=o_rad,
            )
            if best is None:
                best = entry
            else:
                take = entry["dist"] < best["dist"]
                best = {k: torch.where(take, entry[k], best[k]) for k in best}

    matched = c_valid & torch.isfinite(best["dist"])

    # ---- merge math (data.vert:174-208) -----------------------------------
    c_n = c_conf
    c_o = best["conf"]
    csum = c_n + c_o
    merge_small = c_rad < p.merge_radius_factor * best["rad"]

    def avg(new, old):
        return (c_n * new + c_o * old) / csum

    mpx = torch.where(merge_small, avg(c_px, best["px"]), best["px"])
    mpy = torch.where(merge_small, avg(c_py, best["py"]), best["py"])
    mpz = torch.where(merge_small, avg(c_pz, best["pz"]), best["pz"])
    mnx = torch.where(merge_small, avg(c_nx, best["nx"]), best["nx"])
    mny = torch.where(merge_small, avg(c_ny, best["ny"]), best["ny"])
    mnz = torch.where(merge_small, avg(c_nz, best["nz"]), best["nz"])
    mrad = torch.where(merge_small, torch.minimum(c_rad, best["rad"]), best["rad"])
    # data.vert:183: merged color == new color; semantics equal by the gate
    mcs = torch.where(merge_small, c_cs, best["cs"])

    # merged vs new-unstable records (camera frame)
    ox = torch.where(matched, mpx, c_px)
    oy = torch.where(matched, mpy, c_py)
    oz = torch.where(matched, mpz, c_pz)
    nxx = torch.where(matched, mnx, c_nx)
    nyy = torch.where(matched, mny, c_ny)
    nzz = torch.where(matched, mnz, c_nz)
    conf = torch.where(matched, csum, c_n)
    radius = torch.where(matched, mrad, c_rad)
    colorsem = torch.where(matched, mcs, c_cs)
    init_t = torch.where(matched, 0.0, torch.full_like(c_n, time))  # merged init_t stays in place
    last_t = torch.full_like(init_t, time)

    # world frame
    wx, wy, wz = transform_planar(pose, ox, oy, oz)
    wnx, wny, wnz = normalize_planar(*rotate_planar(pose, nxx, nyy, nzz))

    mark = torch.where(c_valid, torch.where(matched, best["id"], -1), -10)

    return AssocFlat(
        x=wx, y=wy, z=wz, conf=conf, colorsem=colorsem,
        init_t=init_t, last_t=last_t,
        nx=wnx, ny=wny, nz=wnz, radius=radius, mark=mark,
    )


_ASSOC_COLS = dict(px="x", py="y", pz="z", conf="conf", colorsem="colorsem",
                   last_t="last_t", nx="nx", ny="ny", nz="nz", radius="radius")


def fuse_append_map(
    smap: SurfelMap,
    at: ActiveTable,
    assoc: AssocFlat,
) -> tuple[SurfelMap, torch.Tensor]:
    """The frame's tail, in place on the map (JAX donated it here): block
    writeback (conflict tombstones) + ONE combined scatter per column of the
    merge writes (mark >= 0 records land on their GLOBAL map slot, fuse.vert)
    and the tail append (mark == -1 records pack after count in lattice
    order, unstable.vert + concatenate).

    init_t is scattered for new records only (merges keep the old initTime,
    data.vert:186).  Appends are all-or-nothing on overflow; returns
    (map, n_dropped), which pre-growth keeps at 0 in the pipeline."""
    smap = writeback_active(smap, at)
    cap = smap.capacity
    matched = assoc.mark >= 0
    is_new = assoc.mark == -1
    offs = torch.cumsum(is_new.to(torch.int32), 0) - 1    # int64
    n_new = torch.clamp(offs[-1] + 1, min=0).to(torch.int32)
    fits = smap.count + n_new <= cap

    safe_mark = torch.where(matched, assoc.mark, 0)
    dest_merge = at.global_id.index_select(0, safe_mark)
    dest_new = smap.count + offs
    new_ok = is_new & fits
    dest = torch.where(matched, dest_merge, torch.where(new_ok, dest_new, cap))
    # tombstoned merge targets keep their write (the reference's fuse scatter
    # also writes rows whose conflict decrement landed this frame)
    for m, a in _ASSOC_COLS.items():
        getattr(smap, m).index_copy_(0, dest, getattr(assoc, a))
    smap.init_t.index_copy_(0, torch.where(new_ok, dest_new, cap), assoc.init_t)
    appended = torch.where(fits, n_new, 0)
    smap.count = smap.count + appended
    return smap, n_new - appended


# ---------------------------------------------------------------------------
# A whole map viewed as a table
# ---------------------------------------------------------------------------

def table_from_map(smap: SurfelMap) -> ActiveTable:
    """View a map directly as an ActiveTable whose active positions ARE the
    map slots (spare excluded): the valid slots are the prefix below
    ``count``, so the z-buffer's n_valid is ``count``."""
    ids = torch.arange(smap.capacity, device=smap.device)
    return ActiveTable(
        **{t: smap.column(m) for t, m in _TABLE_COLS.items()},
        global_id=ids,
        slot_valid=ids < smap.count,
        blk=torch.zeros((0,), dtype=torch.int64, device=smap.device),
    )


def map_from_table(at: ActiveTable, count: torch.Tensor) -> SurfelMap:
    """Inverse of :func:`table_from_map` (same slot addressing; the map gets
    a fresh spare slot)."""
    def col(t):
        return torch.cat([t, t.new_zeros(1)])

    return SurfelMap(**{m: col(getattr(at, t)) for t, m in _TABLE_COLS.items()},
                     count=count)


# ---------------------------------------------------------------------------
# Reference and shard forms of the frame's tail
# ---------------------------------------------------------------------------

_APPEND_COLS = dict(_ASSOC_COLS, init_t="init_t")
_TABLE_COLS_INV = {m: t for t, m in _TABLE_COLS.items()}


def fuse_active(at: ActiveTable, assoc: AssocFlat) -> ActiveTable:
    """fuse.vert scatter (src/GlobalModel.cpp:348-394) into the table: the
    merged records over their target ACTIVE slots, as a new table (the input
    is not written).  init_t is untouched (merges keep the old initTime).
    Duplicate marks resolve to an arbitrary winner, like the GL point-scatter
    race.  ``fuse_append_map`` replaced it on the fusion path: this is a
    reference form that no path runs (the tests, chip_smoke's
    ``small_reference``)."""
    A = at.size
    idx = torch.where(assoc.mark >= 0, assoc.mark, A)  # A: the spare slot

    def sc(dst, src):
        out = torch.cat([dst, dst.new_zeros(1)])
        return out.index_copy_(0, idx, src)[:A]

    return dataclasses.replace(
        at, **{_TABLE_COLS_INV[m]: sc(getattr(at, _TABLE_COLS_INV[m]), getattr(assoc, a))
               for m, a in _ASSOC_COLS.items()})


def append_flat(smap: SurfelMap, assoc: AssocFlat) -> tuple[SurfelMap, torch.Tensor]:
    """Append the mark == -1 records at the map tail, in place, in lattice
    order (unstable.vert/.geom + concatenate, src/GlobalModel.cpp:581-637).
    Returns (map, n_dropped).  A reference form that no path runs (the
    fusion step appends through ``fuse_append_map``).

    Both of the JAX function's branches, with their overflow rules:
      * capacity >= Vp (the lattice size): the new records pack into a
        [Vp] staging buffer that is written over the window of Vp slots at
        the tail.  All or nothing, and conservatively so: it appends only if
        count + Vp <= capacity, however few records are new;
      * a smaller capacity: a direct scatter that appends what fits."""
    is_new = assoc.mark == -1
    Vp = is_new.shape[0]
    cap = smap.capacity
    dev = smap.device
    offs = torch.cumsum(is_new.to(torch.int32), 0) - 1
    n_new = torch.clamp(offs[-1] + 1, min=0).to(torch.int32)
    if cap >= Vp:
        fits = smap.count + Vp <= cap
        lattice = torch.arange(Vp, device=dev)
        window = torch.clamp(smap.count, 0, cap - Vp) + lattice
        keep_new = (lattice < n_new) & fits
        sidx = torch.where(is_new, offs, Vp)
        for m, a in _APPEND_COLS.items():
            src = getattr(assoc, a)
            stage = src.new_zeros(Vp + 1).index_copy_(0, sidx, src)[:Vp]
            col = getattr(smap, m)
            col.index_copy_(0, window, torch.where(keep_new, stage, col[window]))
        appended = torch.where(fits, n_new, 0)
    else:
        dest = smap.count + offs
        idx = torch.where(is_new & (dest < cap), dest, cap)
        for m, a in _APPEND_COLS.items():
            getattr(smap, m).index_copy_(0, idx, getattr(assoc, a))
        appended = torch.minimum(n_new, torch.clamp(cap - smap.count, min=0))
    smap.count = smap.count + appended
    return smap, n_new - appended


def _dealt(assoc: AssocFlat, rank_mod: int, my_rank: int):
    """The new records dealt to ``my_rank``: every rank_mod-th by lattice
    rank r (r % rank_mod == my_rank) -> (bool mask, slot offset r // rank_mod,
    count)."""
    is_new = assoc.mark == -1
    rank = torch.cumsum(is_new.to(torch.int32), 0) - 1
    to_me = is_new & (rank % rank_mod == my_rank)
    return to_me, rank // rank_mod, to_me.sum(dtype=torch.int32)


def append_round_robin(smap: SurfelMap, assoc: AssocFlat, rank_mod: int,
                       my_rank: int) -> tuple[SurfelMap, torch.Tensor]:
    """Shard form of :func:`append_flat`, in place: append only the new
    records dealt to ``my_rank``, packed at the local tail.  Round-robin
    dealing keeps the shards balanced and makes the union of the shards the
    single-map append's surfel set.  Appends what fits; returns
    (map, n_dropped_local).  A reference form that no path runs (the
    sharded step appends through :func:`fuse_append_shard`)."""
    cap = smap.capacity
    to_me, slot, n_mine = _dealt(assoc, rank_mod, my_rank)
    dest = smap.count + slot
    idx = torch.where(to_me & (dest < cap), dest, cap)
    for m, a in _APPEND_COLS.items():
        getattr(smap, m).index_copy_(0, idx, getattr(assoc, a))
    appended = torch.minimum(n_mine, torch.clamp(cap - smap.count, min=0))
    smap.count = smap.count + appended
    return smap, n_mine - appended


def fuse_append_shard(local: SurfelMap, at: ActiveTable, assoc: AssocFlat, rank_mod: int,
                      my_rank: int) -> tuple[SurfelMap, torch.Tensor]:
    """Shard form of :func:`fuse_append_map`, in place: block writeback + ONE
    scatter per column of the merge writes (``at.global_id`` is the LOCAL
    slot here) and of this shard's round-robin share of the new records
    (dealt as :func:`append_round_robin` deals them).  Returns
    (map, n_dropped_local)."""
    local = writeback_active(local, at)
    cap = local.capacity
    matched = assoc.mark >= 0
    to_me, slot, n_mine = _dealt(assoc, rank_mod, my_rank)
    dest_new = local.count + slot
    ok_new = to_me & (dest_new < cap)
    dest_merge = at.global_id.index_select(0, torch.where(matched, assoc.mark, 0))
    dest = torch.where(matched, dest_merge, torch.where(ok_new, dest_new, cap))
    for m, a in _ASSOC_COLS.items():
        getattr(local, m).index_copy_(0, dest, getattr(assoc, a))
    local.init_t.index_copy_(0, torch.where(ok_new, dest_new, cap), assoc.init_t)
    appended = torch.minimum(n_mine, torch.clamp(cap - local.count, min=0))
    local.count = local.count + appended
    return local, n_mine - appended
