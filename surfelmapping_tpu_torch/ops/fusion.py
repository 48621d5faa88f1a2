"""Full-map passes: free-space conflict, compaction, first-frame init
(counterpart of surfelmapping_tpu/ops/fusion.py).

  * conflict_pass:   conflict.vert/.geom + update_conf (src/GlobalModel.cpp:396-515)
                     over the WHOLE map — the offline cleanPoints replay
  * compact:         back_map.vert/.geom (src/GlobalModel.cpp:517-579),
                     stream compaction by prefix-sum scatter
  * initialize_map:  init_unstable.vert (src/GlobalModel.cpp:191-244)
"""

from __future__ import annotations

import torch

from ..config import CameraIntrinsics, PipelineParams
from ..surfels import COLUMNS, SurfelMap, empty_map
from .frame_surfels import FrameSurfels
from .transforms import normalize_planar, rotate_planar, transform_planar


def conflict_pass(
    smap: SurfelMap,
    depth: torch.Tensor,
    semantic: torch.Tensor,
    T_inv: torch.Tensor,
    cam: CameraIntrinsics,
    params: PipelineParams,
    min_depth: float,
    max_depth: float,
    fuse_thresh: float,
    is_clean: bool,
) -> torch.Tensor:
    """Free-space violation test per surfel (conflict.vert) over the whole
    map.  Returns the updated confidence f32[capacity] (conf - 1 where the
    surfel floats in front of the current measurement); surfel 0 is exempt
    (conflict.geom:17 ``id > 0``)."""
    p = params
    H, W = cam.height, cam.width
    conf = smap.column("conf")
    x, y, z = transform_planar(T_inv, smap.column("px"), smap.column("py"),
                               smap.column("pz"))
    safe_z = torch.where(torch.abs(z) < 1e-12, 1e-12, z)
    xl = x / safe_z
    yl = y / safe_z
    u = cam.fx * xl + cam.cx
    v = cam.fy * yl + cam.cy

    in_view = (
        (u >= p.stereo_border)
        & (u <= W)
        & (v >= 0)
        & (v <= H)
        & (z > min_depth)
        & (z < max_depth)
    )

    lam = torch.sqrt(xl * xl + yl * yl + 1.0)

    # nearest-texel sample, clamped to edge; sky/hole substitutions folded in
    hole = depth if is_clean else torch.where(depth == 0.0, max_depth + 20.0, depth)
    deff = torch.where(semantic == p.sky_class, max_depth + 1.0, hole)
    ui = torch.clamp(torch.floor(u).to(torch.int64), 0, W - 1)
    vi = torch.clamp(torch.floor(v).to(torch.int64), 0, H - 1)
    d = deff.reshape(-1)[vi * W + ui]

    violates = (d * lam - z * lam) > (fuse_thresh * z)

    ids = torch.arange(smap.capacity, device=conf.device)
    hit = smap.live_mask() & (conf > 0.0) & (ids > 0) & in_view & violates
    return torch.where(hit, conf - p.conflict_conf_decrement, conf)


def compact(smap: SurfelMap, prefix: int | None = None) -> SurfelMap:
    """Back-mapping compaction: drop rows with conf <= 0, preserve order
    (back_map.geom keeps conf > 0, src/GlobalModel.cpp:517-579).

    ``prefix`` restricts the work to the first ``prefix`` slots, which is
    exact only when every written slot lies below it: it raises if
    ``prefix`` < count (a host read of the cursor).  The full form returns a
    new map; the prefix form rewrites the head of each column in place."""
    cap = smap.capacity
    if prefix is None or prefix >= cap:
        keep = smap.live_mask() & (smap.column("conf") > 0.0)
        dest = torch.cumsum(keep.to(torch.int32), 0) - 1
        idx = torch.where(keep, dest, cap)  # dropped -> spare slot
        out = empty_map(cap, smap.device)
        for k in COLUMNS:
            getattr(out, k).index_copy_(0, idx, smap.column(k))
        out.count = torch.clamp(dest[-1] + 1, min=0).to(torch.int32)
        return out

    count = int(smap.count)
    if prefix < count:
        raise ValueError(f"compact: prefix {prefix} < count {count} would drop "
                         "live surfels above the prefix")
    keep = (
        torch.arange(prefix, device=smap.device) < smap.count
    ) & (smap.conf[:prefix] > 0.0)
    dest = torch.cumsum(keep.to(torch.int32), 0) - 1
    idx = torch.where(keep, dest, prefix)
    for k in COLUMNS:
        col = getattr(smap, k)
        packed = torch.zeros(prefix + 1, dtype=col.dtype, device=col.device)
        packed.index_copy_(0, idx, col[:prefix])
        # slots >= prefix are beyond the cursor and still zero
        col[:prefix] = packed[:prefix]
    smap.count = torch.clamp(dest[-1] + 1, min=0).to(torch.int32)
    return smap


def _column_major_flat(a: torch.Tensor) -> torch.Tensor:
    """Flatten [H,W,...] in column-major pixel order (col*H + row) — the
    reference's uv-lattice order (src/GlobalModel.cpp:66-73)."""
    return a.transpose(0, 1).reshape((-1,) + tuple(a.shape[2:]))


def initialize_map(
    smap: SurfelMap, frame: FrameSurfels, pose: torch.Tensor, time: float = 0.0
) -> tuple[SurfelMap, torch.Tensor]:
    """First-map initialization from a feedback-buffer frame: world-transform
    every valid camera-frame surfel and append it, in place, in the
    reference's column-major lattice order (init_unstable.vert +
    GlobalModel::initialize, src/FeedbackBuffer.cpp:43-59).

    Returns (map, n_dropped)."""
    wx, wy, wz = transform_planar(pose, frame.px, frame.py, frame.pz)
    wnx, wny, wnz = normalize_planar(*rotate_planar(pose, frame.nx, frame.ny, frame.nz))

    valid = _column_major_flat(frame.valid)
    offs = torch.cumsum(valid.to(torch.int32), 0) - 1
    n_new = torch.clamp(offs[-1] + 1, min=0).to(torch.int32)
    dest = smap.count + offs
    ok = valid & (dest < smap.capacity)
    idx = torch.where(ok, dest, smap.capacity)

    time_img = torch.full(frame.conf.shape, time, dtype=torch.float32,
                          device=frame.conf.device)
    src = dict(px=wx, py=wy, pz=wz, conf=frame.conf, colorsem=frame.colorsem,
               init_t=time_img, last_t=time_img, nx=wnx, ny=wny, nz=wnz,
               radius=frame.radius)
    for k, v in src.items():
        getattr(smap, k).index_copy_(0, idx, _column_major_flat(v))
    appended = torch.minimum(n_new, torch.clamp(smap.capacity - smap.count, min=0))
    smap.count = smap.count + appended
    return smap, n_new - appended
