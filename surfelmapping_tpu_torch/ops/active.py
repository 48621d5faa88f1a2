"""Active-block fusion engine: per-frame cost O(in-frustum surfels), not
O(map capacity) (counterpart of surfelmapping_tpu/ops/active.py).

  1. ``plan_active_blocks``  — one dense pass over the whole map computes
     per-surfel view/conflict gates and reduces them to per-*block* activity
     (block = 2048 contiguous slots; surfels append in scan order, so
     frustum residency is efficient at block granularity).
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

Nothing here reads a value back to the host: out-of-range writes go to the
map's spare slot (surfels.py), and no boolean-mask indexing is used.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import CameraIntrinsics, PipelineParams
from ..surfels import SurfelMap
from .frame_surfels import association_candidates, ray_geometry
from .index_map import INT32_MAX, _depth_key
from .transforms import transform_planar
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
    sum(slot_valid) candidates and relies on it; a table with interleaved
    invalid slots would lose valid candidates (the kernel wrapper checks the
    contract on its CPU path, ops/zbuf.py).
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


def _project(px, py, pz, T_inv: torch.Tensor, cam: CameraIntrinsics):
    x, y, z = transform_planar(T_inv, px, py, pz)
    safe_z = torch.where(torch.abs(z) < 1e-12, 1e-12, z)
    u = cam.fx * x / safe_z + cam.cx
    v = cam.fy * y / safe_z + cam.cy
    return x, y, z, u, v


def _active_block_mask(smap: SurfelMap, T_inv: torch.Tensor, cam: CameraIntrinsics,
                       params: PipelineParams, block_size: int) -> torch.Tensor:
    """bool[G] per-block activity: any live surfel in the block passes the
    conflict in-view gate OR the index-map candidate gate (the timeDelta
    gate is deliberately NOT applied: stale in-view surfels must still reach
    the conflict pass)."""
    G = smap.capacity // block_size
    _, _, pc_z, u, v = _project(smap.column("px"), smap.column("py"),
                                smap.column("pz"), T_inv, cam)
    live = smap.column("conf") > 0.0
    confl = _conflict_gates(u, v, pc_z, cam, params, params.near_clip, params.far_clip)
    fa = params.index_factor
    pi = torch.ceil(u * fa).to(torch.int32) - 1
    pj = torch.ceil(v * fa).to(torch.int32) - 1
    idxg = (
        (pi >= 0) & (pi < cam.width * fa) & (pj >= 0) & (pj < cam.height * fa)
        & (pc_z > 0.0) & (pc_z < params.far_clip)
    )
    act = (live & (confl | idxg)).view(G, block_size)
    return act.any(dim=1)


def plan_active_blocks(
    smap: SurfelMap,
    T_inv: torch.Tensor,
    cam: CameraIntrinsics,
    params: PipelineParams,
    num_blocks: int,
    block_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense O(capacity) pass -> the <= num_blocks active block ids.

    Returns (blk i64[num_blocks]: active blocks ascending, then G fillers;
    n_active: the total active block count, 0-d, which the host compares
    with num_blocks at the next sync).  On overflow the highest-id (most
    recently appended) blocks are kept, and the host's window verify
    replays the window with a grown budget."""
    G = smap.capacity // block_size
    blk_act = _active_block_mask(smap, T_inv, cam, params, block_size)
    n_active = blk_act.sum(dtype=torch.int32)
    ids = torch.where(blk_act, torch.arange(G, device=blk_act.device), -1)
    ids = torch.sort(ids).values             # inactive (-1) first, actives ascending
    chosen = ids[max(G - num_blocks, 0):]    # most recent blocks win on overflow
    blk = torch.sort(torch.where(chosen >= 0, chosen, G)).values
    return blk, n_active


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
) -> tuple[ActiveTable, torch.Tensor]:
    """conflict.vert/.geom + update_conf (src/GlobalModel.cpp:396-515) on the
    active table; the conf decrement tombstones the surfel.

    Returns (table, n_removed): n_removed counts surfels whose conf crossed
    <= 0 this pass."""
    p = params
    H, W = cam.height, cam.width
    x, y, z, u, v = _project(at.x, at.y, at.z, T_inv, cam)
    in_view = _conflict_gates(u, v, z, cam, p, min_depth, max_depth)

    safe_z = torch.where(torch.abs(z) < 1e-12, 1e-12, z)
    xl = x / safe_z
    yl = y / safe_z
    lam = torch.sqrt(xl * xl + yl * yl + 1.0)

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
    hit = live & (at.global_id > 0) & in_view & violates
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-surfel half of predictIndices: depth key + target pixel.

    Gates: z>0, z<farClip, timeDelta freshness, pixel bounds, conf>0
    (tombstones) and global id>0 (surfel 0 is unmatchable, data.vert:142).

    Returns (zkey i32[A], INT32_MAX = invalid; fpix i32[A], H*W = invalid)."""
    factor = params.index_factor
    icam = cam.scaled(factor)
    H, W = icam.height, icam.width
    _, _, z, u, v = _project(at.x, at.y, at.z, T_inv, icam)
    fresh = (time - at.last_t) <= params.time_delta
    pi = torch.ceil(u).to(torch.int32) - 1
    pj = torch.ceil(v).to(torch.int32) - 1
    inb = (pi >= 0) & (pi < W) & (pj >= 0) & (pj < H)
    valid = (
        at.slot_valid & (at.conf > 0.0) & (at.global_id > 0)
        & fresh & (z > 0.0) & (z < params.far_clip) & inb
    )
    key = _depth_key(z, valid)
    fpix = torch.where(valid, pj * W + pi, H * W).to(torch.int32)
    return key, fpix


def index_active(
    at: ActiveTable,
    T_inv: torch.Tensor,
    time: float,
    cam: CameraIntrinsics,
    params: PipelineParams,
) -> torch.Tensor:
    """predictIndices (src/IndexMap.cpp:138-198) over the active table:
    i64[H*F, W*F] image of ACTIVE slot positions (-1 = empty), resolved by
    the scatter-argmin z-buffer (ops/zbuf.py).  Candidate ids ARE active
    positions, so no translation is needed."""
    icam = cam.scaled(params.index_factor)
    zkey, fpix = index_candidates(at, T_inv, time, cam, params)
    _, idbuf = zbuffer_argmin(zkey, fpix, icam.height * icam.width, at.slot_valid)
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
    na = torch.sqrt(ax * ax + ay * ay + az * az)
    nb = torch.sqrt(bx * bx + by * by + bz * bz)
    cosv = dot / torch.clamp(na * nb, min=1e-12)
    return torch.arccos(torch.clamp(cosv, -1.0, 1.0))


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
    """The data.vert association + merge kernel on flat checkerboard pixels.

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

    R, t = T_inv[:3, :3], T_inv[:3, 3]
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
            px = R[0, 0] * ox + R[0, 1] * oy + R[0, 2] * oz + t[0]
            py = R[1, 0] * ox + R[1, 1] * oy + R[1, 2] * oz + t[1]
            pz = R[2, 0] * ox + R[2, 1] * oy + R[2, 2] * oz + t[2]
            cnx = R[0, 0] * onx + R[0, 1] * ony + R[0, 2] * onz
            cny = R[1, 0] * onx + R[1, 1] * ony + R[1, 2] * onz
            cnz = R[2, 0] * onx + R[2, 1] * ony + R[2, 2] * onz
            nlen = torch.clamp(torch.sqrt(cnx * cnx + cny * cny + cnz * cnz), min=1e-12)
            cnx, cny, cnz = cnx / nlen, cny / nlen, cnz / nlen

            o_sem = (o_cs >> 24) & 0xFF
            depth_gate = torch.abs(pz * c_lam - c_depth * c_lam) <= fuse_thresh
            sem_gate = c_sem == o_sem
            # perpendicular ray distance |ray x p| / lam (data.vert:150)
            crx = c_rayy * pz - 1.0 * py
            cry = 1.0 * px - c_rayx * pz
            crz = c_rayx * py - c_rayy * px
            dist = torch.sqrt(crx * crx + cry * cry + crz * crz) / c_lam
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
    Rw, tw = pose[:3, :3], pose[:3, 3]
    wx = Rw[0, 0] * ox + Rw[0, 1] * oy + Rw[0, 2] * oz + tw[0]
    wy = Rw[1, 0] * ox + Rw[1, 1] * oy + Rw[1, 2] * oz + tw[1]
    wz = Rw[2, 0] * ox + Rw[2, 1] * oy + Rw[2, 2] * oz + tw[2]
    wnx = Rw[0, 0] * nxx + Rw[0, 1] * nyy + Rw[0, 2] * nzz
    wny = Rw[1, 0] * nxx + Rw[1, 1] * nyy + Rw[1, 2] * nzz
    wnz = Rw[2, 0] * nxx + Rw[2, 1] * nyy + Rw[2, 2] * nzz
    wl = torch.clamp(torch.sqrt(wnx * wnx + wny * wny + wnz * wnz), min=1e-12)
    wnx, wny, wnz = wnx / wl, wny / wl, wnz / wl

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
