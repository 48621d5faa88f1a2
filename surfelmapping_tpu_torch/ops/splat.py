"""Novel-view surfel splatting: RGB / semantic / depth images from any pose
(counterpart of surfelmapping_tpu/ops/splat.py).

The reference rasterises one camera-facing or normal-oriented quad per surfel
and discards fragments outside the unit disc (draw_image.vert +
draw_image_adaptive.geom + draw_image.frag, src/GlobalModel.cpp:782-833).
Because each quad is planar, perspective-correct interpolation of its
texcoord equals a ray/plane intersection, so the exact renderer computes, for
every pixel in a bounded footprint around the projected centre, the
intersection of the pixel ray with the splat plane and applies the same
inside-disc test.  Geometry from draw_image_adaptive.geom: surfels farther
than 5 m render as view-aligned discs (lines 45-50), nearer ones
normal-oriented with radius r / (1 + 0.5|cos angle|) (lines 51-60); active
gate 1 < z < maxDepth = 200 (GlobalModel.cpp:806); colour is the surfel RGB,
semantic is class+1 with 0 for holes (draw_image_adaptive.geom:35).

Three renderers, as in the JAX package:
  * :func:`splat_render`, exact: a depth pass and a winner-id pass over every
    footprint offset, each a scatter-min.  The offset loops run in Python and
    keep one offset's temporaries alive.  A small/large bucket split sends
    only the splats that need the full footprint through it.
  * :func:`splat_render_fast`, the production path: each surfel's centre
    goes once through the z-buffer kernel K1 (ops/zbuf.py) into one of four
    class buffers by its pixel radius, then disc-shaped min-dilations of the
    class buffers spread the footprints.  The dilation works on K1's packed
    int64 words (key << 32 | id): one CUDA kernel on the card
    (ops/disc_dilate.py), and on the CPU a plain loop of one
    ``torch.minimum`` per disc stamp (164 for the classes 1, 2, 3, 5).
  * :func:`render_view`: culls the map to the in-frustum blocks first
    (:func:`cull_for_render`; on the card its pass over every slot is one
    CUDA kernel, ops/visible_blocks.py), so a view costs O(in-frustum
    surfels), and grows the cull budget until nothing is truncated.

Port notes.  JAX's dropped scatters (``mode="drop"``) become writes to a
spare slot past the end of each buffer.  Divergence from the JAX package, at
the image border only: its dilation masks the key of a stamp that reads from
outside the image but not the id (surfelmapping_tpu/ops/splat.py:420-429),
so a pixel that no splat covers can take a wrapped-around id with key
INT32_MAX and come out as a hit with NaN depth.  Here such a stamp
contributes nothing, and the pixel stays a hole.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import CameraIntrinsics
from ..surfels import COLUMNS, SurfelMap
from ..utils import tracing
from .active import _TABLE_COLS, choose_from_blocks, gather_active, valid_prefix
from .colors import decode_color
from .disc_dilate import disc_dilate, disc_stamps
from .index_map import INT32_MAX, _depth_key
from .transforms import (device_scalar, ieee_sqrt, invert_se3, normalize_planar,
                         project_pixels, rotate_planar, safe_divisor, transform_planar)
from .visible_blocks import visible_blocks, visible_blocks_plain
from .zbuf import key_id_views, zbuffer_argmin_packed

SQRT2 = 1.41421356237
EMPTY_WORD = (INT32_MAX << 32) | INT32_MAX  # packed (key, id) of an empty pixel


def _splat_frames(px, py, pz, nx, ny, nz, radius):
    """Per-surfel splat plane: returns (X axis, Y axis, plane normal) as
    planar component triples, in the render camera frame."""
    far_mode = pz > 5.0

    # near (oriented) branch
    dot_en = px * nx + py * ny + pz * nz
    elen = ieee_sqrt(px * px + py * py + pz * pz)
    nlen = ieee_sqrt(nx * nx + ny * ny + nz * nz)
    cosang = dot_en / torch.clamp(elen * nlen, min=1e-12)
    rad_near = radius / (1.0 + 0.5 * torch.abs(cosang))
    # x_near = normalize((n.y - n.z, -n.x, n.x)) * rad_near*sqrt2
    ax, ay, az = normalize_planar(ny - nz, -nx, nx)
    sn = rad_near * SQRT2
    xnx, xny, xnz = ax * sn, ay * sn, az * sn
    # y_near = cross(n, x_near)
    ynx = ny * xnz - nz * xny
    yny = nz * xnx - nx * xnz
    ynz = nx * xny - ny * xnx

    # far (view-aligned) branch: X = (-1,0,0)*r*sqrt2, Y = (0,-1,0)*r*sqrt2
    sf = radius * SQRT2
    Xx = torch.where(far_mode, -sf, xnx)
    Xy = torch.where(far_mode, 0.0, xny)
    Xz = torch.where(far_mode, 0.0, xnz)
    Yx = torch.where(far_mode, 0.0, ynx)
    Yy = torch.where(far_mode, -sf, yny)
    Yz = torch.where(far_mode, 0.0, ynz)

    # plane normal = normalize(cross(X, Y))
    pnx, pny, pnz = normalize_planar(
        Xy * Yz - Xz * Yy, Xz * Yx - Xx * Yz, Xx * Yy - Xy * Yx
    )
    return (Xx, Xy, Xz), (Yx, Yy, Yz), (pnx, pny, pnz)


def cull_for_render(
    smap: SurfelMap,
    view: torch.Tensor,
    cam: CameraIntrinsics,
    num_blocks: int,
    block_size: int = 2048,
    max_depth: float = 200.0,
    margin: int = 8,
) -> tuple[SurfelMap, torch.Tensor, torch.Tensor]:
    """Gather the surfel blocks visible from ``view`` into a compact map.

    A surfel can only write pixels within ``margin`` px of its projected
    centre, so a block whose surfels all project outside the padded image, or
    outside (1, max_depth), never contributes.  Returns (culled map of
    num_blocks * block_size slots, global_ids i64[A], n_active blocks, 0-d
    int32).  The culled map holds the blocks that
    :func:`active.choose_from_blocks` keeps, in ascending order, valid blocks
    first; its padding slots have conf 0.  On overflow :func:`render_view`
    re-culls with a grown budget.

    The visible blocks come from one launch of the CUDA kernel
    (ops/visible_blocks.py) for a map on the card, from the plain form
    :func:`visible_blocks_plain` for a map on the CPU: the same bits."""
    dev = smap.device
    gate = visible_blocks_plain if dev.type == "cpu" else visible_blocks
    blk_act = gate(*(smap.column(k) for k in ("px", "py", "pz", "conf")), invert_se3(view),
                   cam, block_size, max_depth, margin)
    blk, n_active = choose_from_blocks(blk_act, num_blocks)
    at = gather_active(smap, blk, block_size)
    cols = {m: getattr(at, t) for t, m in _TABLE_COLS.items()}
    cols["conf"] = torch.where(at.slot_valid, at.conf, 0.0)
    culled = SurfelMap(
        **{k: F.pad(c, (0, 1)) for k, c in cols.items()},  # + the spare slot
        count=torch.full((), at.size, dtype=torch.int32, device=dev),
    )
    return culled, at.global_id, n_active


def _decode(smap: SurfelMap, keys: torch.Tensor, ids: torch.Tensor,
            cam: CameraIntrinsics) -> dict[str, torch.Tensor]:
    """Per-pixel winner (key i32[P], id i32[P], INT32_MAX = hole) -> the
    rgb / semantic / depth / id images."""
    H, W = cam.height, cam.width
    hole = ids == INT32_MAX
    wid = torch.where(hole, 0, ids)
    w_rgb, w_sem = decode_color(smap.column("colorsem").index_select(0, wid))
    return {
        "rgb": torch.where(hole[:, None], 0.0, w_rgb).reshape(H, W, 3),
        "semantic": torch.where(hole, 0, w_sem + 1).reshape(H, W),
        "depth": torch.where(hole, 0.0, keys.view(torch.float32)).reshape(H, W),
        "id": torch.where(hole, -1, ids).reshape(H, W),
    }


def splat_render(
    smap: SurfelMap,
    view: torch.Tensor,
    cam: CameraIntrinsics,
    max_depth: float = 200.0,
    footprint: int = 5,
    small_footprint: int | None = 2,
    large_frac: int = 8,
) -> dict[str, torch.Tensor]:
    """Render the map from camera-to-world pose ``view``, exactly.

    Returns dict with:
      rgb:      f32[H,W,3] in [0,1] (0 where no surfel)
      semantic: i32[H,W]   class+1, 0 = hole (reference convention)
      depth:    f32[H,W]   camera-frame z of the winning splat, 0 = hole
      id:       i32[H,W]   winning surfel id, -1 = hole
      large_overflow: i32  splats that exceeded the large-bucket budget and
                           rendered cropped to the small window

    ``footprint`` bounds the per-surfel pixel radius (the large bucket);
    splats whose projected extent fits ``small_footprint`` only pay the small
    window.  ``small_footprint=None`` forces the single window (identical
    output unless the large bucket overflowed).
    """
    T_inv = invert_se3(view)
    H, W = cam.height, cam.width
    num_pix = H * W
    N = smap.capacity
    dev = smap.device
    col = smap.column

    px, py, pz = transform_planar(T_inv, col("px"), col("py"), col("pz"))
    nx, ny, nz = normalize_planar(*rotate_planar(T_inv, col("nx"), col("ny"), col("nz")))
    # conf > 0 also excludes tombstoned surfels awaiting deferred compaction
    active = smap.live_mask() & (col("conf") > 0.0) & (pz > 1.0) & (pz < max_depth)

    (Xx, Xy, Xz), (Yx, Yy, Yz), (pnx, pny, pnz) = _splat_frames(
        px, py, pz, nx, ny, nz, col("radius")
    )
    inv_x2 = 1.0 / torch.clamp(Xx * Xx + Xy * Xy + Xz * Xz, min=1e-18)
    inv_y2 = 1.0 / torch.clamp(Yx * Yx + Yy * Yy + Yz * Yz, min=1e-18)
    n_dot_p = pnx * px + pny * py + pnz * pz

    uc, vc = project_pixels(px, py, pz, cam)
    pi0 = torch.floor(uc).to(torch.int64)
    pj0 = torch.floor(vc).to(torch.int64)

    cols = dict(
        px=px, py=py, pz=pz, Xx=Xx, Xy=Xy, Xz=Xz, Yx=Yx, Yy=Yy, Yz=Yz,
        pnx=pnx, pny=pny, pnz=pnz, inv_x2=inv_x2, inv_y2=inv_y2,
        n_dot_p=n_dot_p, pi0=pi0, pj0=pj0,
    )

    # focal lengths as device tensors: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which rounds differently from XLA
    fx, fy = device_scalar(cam.fx, dev), device_scalar(cam.fy, dev)

    def offset_hit(c, ok_base, dj, di):
        qpx = c["pi0"] + di
        qpy = c["pj0"] + dj
        # pixel ray through (px+0.5, py+0.5)
        dx = (qpx.to(torch.float32) + 0.5 - cam.cx) / fx
        dy = (qpy.to(torch.float32) + 0.5 - cam.cy) / fy
        denom = c["pnx"] * dx + c["pny"] * dy + c["pnz"]
        denom = safe_divisor(denom)
        t = c["n_dot_p"] / denom
        qx = t * dx - c["px"]
        qy = t * dy - c["py"]
        qz = t - c["pz"]
        a = (qx * c["Xx"] + qy * c["Xy"] + qz * c["Xz"]) * c["inv_x2"]
        b = (qx * c["Yx"] + qy * c["Yy"] + qz * c["Yz"]) * c["inv_y2"]
        inside = (a * a + b * b) <= 0.5
        inb = (qpx >= 0) & (qpx < W) & (qpy >= 0) & (qpy < H)
        ok = ok_base & inside & inb & (t > 0.0) & (t < max_depth)
        flat = torch.where(ok, qpy * W + qpx, num_pix)  # num_pix: the spare
        return flat, t, ok

    # ---- bucket split ----------------------------------------------------
    all_ids = torch.arange(N, dtype=torch.int32, device=dev)
    if small_footprint is None or small_footprint >= footprint:
        large_overflow = torch.zeros((), dtype=torch.int32, device=dev)
        buckets = [(cols, active, all_ids, footprint)]
    else:
        # conservative projected half-extent in px: the disc's pixel radius
        # is <= f * |axis| / z with |axis| = rad*sqrt2; +1 covers the
        # floor()/pixel-centre offsets
        axis_len = ieee_sqrt(torch.maximum(Xx * Xx + Xy * Xy + Xz * Xz,
                                            Yx * Yx + Yy * Yy + Yz * Yz))
        f = max(cam.fx, cam.fy)
        rd = f * axis_len / torch.clamp(pz, min=1.0)
        is_small = rd <= (small_footprint - 0.999)
        is_large = active & ~is_small
        AL = max(N // large_frac, 256)
        lpos = torch.cumsum(is_large.to(torch.int32), 0, dtype=torch.int32) - 1
        over = is_large & (lpos >= AL)
        large_overflow = over.sum(dtype=torch.int32)
        dest = torch.where(is_large & ~over, lpos, AL)  # AL: the spare
        lids = torch.full((AL + 1,), -1, dtype=torch.int32, device=dev)
        lids = lids.index_copy_(0, dest.long(), all_ids)[:AL]
        lsafe = torch.clamp(lids, 0, N - 1)
        lcols = {k: v.index_select(0, lsafe) for k, v in cols.items()}
        lok = lids >= 0
        # overflowed larges render cropped through the small window rather
        # than disappearing
        small_ok = active & (is_small | over)
        buckets = [(cols, small_ok, all_ids, small_footprint), (lcols, lok, lsafe, footprint)]

    def offsets(R):
        return [(dj, di) for dj in range(-R, R + 1) for di in range(-R, R + 1)]

    # ---- pass 1: depth z-buffer -----------------------------------------
    depth_buf = torch.full((num_pix + 1,), INT32_MAX, dtype=torch.int32, device=dev)
    for c, okb, _, R in buckets:
        for dj, di in offsets(R):
            flat, t, ok = offset_hit(c, okb, dj, di)
            depth_buf.scatter_reduce_(0, flat, _depth_key(t, ok), "amin")

    # ---- pass 2: winner ids (ties -> smallest id; GL leaves ties to draw
    # order).  Intersections recomputed rather than kept per offset.
    id_buf = torch.full((num_pix + 1,), INT32_MAX, dtype=torch.int32, device=dev)
    for c, okb, ids, R in buckets:
        for dj, di in offsets(R):
            flat, t, ok = offset_hit(c, okb, dj, di)
            win = ok & (_depth_key(t, ok) == depth_buf[flat])
            id_buf.scatter_reduce_(0, torch.where(win, flat, num_pix), ids, "amin")

    out = _decode(smap, depth_buf[:num_pix], id_buf[:num_pix], cam)
    out["large_overflow"] = large_overflow
    return out


def fast_candidates(
    smap: SurfelMap,
    view: torch.Tensor,
    cam: CameraIntrinsics,
    max_depth: float = 200.0,
    footprint: int = 5,
    classes: tuple[int, ...] = (1, 2, 3, 5),
) -> tuple[torch.Tensor, torch.Tensor, tuple[int, ...], torch.Tensor]:
    """The point-sprite splatter's centre candidates, one per surfel.

    Returns (key i32[N], cflat i32[N], classes, large_overflow): ``cflat``
    indexes NC = len(classes) stacked H*W class buffers by the surfel's
    pixel-radius class, NC*H*W for a surfel that does not render;
    ``classes`` keeps the classes up to ``footprint``."""
    T_inv = invert_se3(view)
    H, W = cam.height, cam.width
    num_pix = H * W
    N = smap.capacity
    col = smap.column

    px, py, pz = transform_planar(T_inv, col("px"), col("py"), col("pz"))
    nx, ny, nz = normalize_planar(*rotate_planar(T_inv, col("nx"), col("ny"), col("nz")))
    active = smap.live_mask() & (col("conf") > 0.0) & (pz > 1.0) & (pz < max_depth)

    # per-surfel disc pixel radius: the exact splat's disc half-extent is
    # |X|*sqrt(0.5) = rad (near) or rad*sqrt2*sqrt0.5 (far); same
    # foreshortened radius model
    far_mode = pz > 5.0
    dot_en = px * nx + py * ny + pz * nz
    elen = ieee_sqrt(px * px + py * py + pz * pz)
    cosang = dot_en / torch.clamp(elen, min=1e-12)
    radius = col("radius")
    rad_eff = torch.where(far_mode, radius, radius / (1.0 + 0.5 * torch.abs(cosang)))
    f = max(cam.fx, cam.fy)
    safe_z = torch.clamp(pz, min=1.0)
    rd = f * rad_eff / safe_z

    classes = tuple(c for c in classes if c <= footprint) or (footprint,)
    cls = torch.full((N,), len(classes) - 1, dtype=torch.int32, device=smap.device)
    for ci in range(len(classes) - 2, -1, -1):
        cls = torch.where(rd <= classes[ci], ci, cls)
    large_overflow = (active & (rd > classes[-1])).sum(dtype=torch.int32)

    uc = cam.fx * px / safe_z + cam.cx
    vc = cam.fy * py / safe_z + cam.cy
    pi0 = torch.floor(uc).to(torch.int32)
    pj0 = torch.floor(vc).to(torch.int32)
    # centres outside the image are dropped (the dilation buffers are
    # image-sized; splats centred off-image lose their partial border
    # coverage, as in the JAX package)
    inb = (pi0 >= 0) & (pi0 < W) & (pj0 >= 0) & (pj0 < H)
    ok = active & inb
    NC = len(classes)
    cflat = torch.where(ok, cls * num_pix + pj0 * W + pi0, NC * num_pix)
    return _depth_key(pz, ok), cflat, classes, large_overflow


def dilate_plain(packed: torch.Tensor, classes: tuple[int, ...]) -> torch.Tensor:
    """Disc-shaped min-dilation of each class's centre buffer, merged over
    the classes: per pixel the smallest (key, id) pair, by key and then by
    id, among the centres whose class disc covers it.  The buffers
    (i64[NC, H, W]) come from K1 as int64 words (key << 32) | id, which
    order the same way, so a stamp of :func:`disc_stamps` is one
    ``torch.minimum``.  Stamps reaching outside the image read the empty
    word.  Returns the merged i64[H, W] plane."""
    _, H, W = packed.shape
    out = torch.full((H, W), EMPTY_WORD, dtype=torch.int64, device=packed.device)
    for ci, R in enumerate(classes):
        src = torch.constant_pad_nd(packed[ci], (R, R, R, R), EMPTY_WORD)
        for dj, di in disc_stamps(R):
            # out[r, c] <- min(out[r, c], centre[r - dj, c - di])
            torch.minimum(out, src[R - dj:R - dj + H, R - di:R - di + W], out=out)
    return out


def _dilate(packed: torch.Tensor, classes: tuple[int, ...],
            cam: CameraIntrinsics) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's class buffers dilated and merged (:func:`dilate_plain`): the
    plain loop for CPU tensors, one launch of the CUDA kernel
    (ops/disc_dilate.py) for CUDA tensors, the same bits.  Returns the
    merged (key, id) planes as int32 views."""
    packed = packed.view(len(classes), cam.height, cam.width)
    if packed.device.type == "cpu":
        out = dilate_plain(packed, classes)
    else:
        out = disc_dilate(packed, classes)
    return key_id_views(out.reshape(-1))


def splat_render_fast(
    smap: SurfelMap,
    view: torch.Tensor,
    cam: CameraIntrinsics,
    max_depth: float = 200.0,
    footprint: int = 5,
    classes: tuple[int, ...] = (1, 2, 3, 5),
    n_valid: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """Point-sprite splatter: each surfel's centre goes once through K1
    into its class buffer, and the footprints spread as disc-shaped
    min-dilations of the class buffers.

    Divergences from the exact renderer (as in the JAX package): constant
    depth across a splat; circular stamps; the footprint radius quantised up
    to the next class, cropped at ``footprint``.  ``n_valid`` (0-d int32 on
    the map's device) bounds the slots K1 streams; the slots past it must
    not render (render_view's culled table: its padding has conf 0).
    Returns the same dict as :func:`splat_render` (large_overflow = splats
    cropped at the last class)."""
    num_pix = cam.height * cam.width
    with tracing.span("render.centres"):
        key, cflat, classes, large_overflow = fast_candidates(
            smap, view, cam, max_depth, footprint, classes)
    with tracing.span("render.k1"):
        packed = zbuffer_argmin_packed(key, cflat, len(classes) * num_pix, n_valid)
    with tracing.span("render.dilate"):
        keys, ids = _dilate(packed, classes, cam)
    with tracing.span("render.decode"):
        out = _decode(smap, keys, ids, cam)
    out["large_overflow"] = large_overflow
    return out


def pad_to_blocks(smap: SurfelMap, block_size: int) -> SurfelMap:
    """The map with its capacity padded up to whole blocks by dead slots
    (conf 0); block culling needs whole blocks, and a loaded map arrives at
    its raw count.  Returns the map itself if it is already whole."""
    if smap.capacity % block_size == 0:
        return smap
    pad = block_size - smap.capacity % block_size
    return SurfelMap(**{k: F.pad(smap.column(k), (0, pad + 1)) for k in COLUMNS},
                     count=smap.count)


def render_view(
    smap: SurfelMap,
    view,
    cam: CameraIntrinsics,
    max_depth: float = 200.0,
    footprint: int = 5,
    block_size: int = 2048,
    start_blocks: int | None = None,
    method: str = "fast",
    classes: tuple[int, ...] = (1, 2, 3, 5),
    device: torch.device | str | None = None,
) -> dict[str, torch.Tensor]:
    """Cull + render, growing the cull budget until nothing is truncated.
    The ``id`` image is translated back to the map's slot ids (int32, -1 =
    hole).

    ``method``: "fast" = :func:`splat_render_fast` (the production path),
    "exact" = :func:`splat_render` (the quality reference, single window).
    ``start_blocks`` is the cull-budget hint: None starts at the full block
    count (no retry ever); view loops feed the previous view's
    ``n_active_blocks`` back in.  Hints are bucketed to powers of two, and a
    hint of at least half the block count takes the full budget.

    Runs on ``device``: the CUDA card unless the caller asks for the CPU; a
    map elsewhere is copied there.  The view reads the device once (the
    active block count, after the render is enqueued) and re-renders only if
    the budget truncated it.  Adds ``n_active_blocks`` (0-d int32) and
    ``budget_retries`` (int) to the output.

    The view is the root span ``render.view``; the read is its ``wait``, and
    each re-render counts one ``render.budget_retries``."""
    from ..pipeline import resolve_device

    if method not in ("fast", "exact"):
        raise ValueError(f"render_view: unknown method {method!r}")
    dev = resolve_device(device)
    smap = pad_to_blocks(smap.to(dev), block_size)
    view = torch.as_tensor(view, dtype=torch.float32, device=dev)
    G = max(smap.capacity // block_size, 1)
    if start_blocks is None:
        budget = G
    else:
        budget = 1
        while budget < start_blocks:
            budget *= 2
        budget = G if budget >= G // 2 else budget
    retries = 0
    with tracing.span("render.view"):
        while True:
            out, n_active = _cull_and_render(
                smap, view, cam, budget, block_size, max_depth, footprint, method, classes,
            )
            n = tracing.read_back(n_active)
            if n <= budget or budget >= G:
                out["n_active_blocks"] = n_active
                out["budget_retries"] = retries
                return out
            retries += 1
            tracing.count("render.budget_retries")
            while budget < n:
                budget *= 2
            budget = min(budget, G)


def _cull_and_render(
    smap: SurfelMap,
    view: torch.Tensor,
    cam: CameraIntrinsics,
    num_blocks: int,
    block_size: int,
    max_depth: float,
    footprint: int,
    method: str,
    classes: tuple[int, ...],
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    with tracing.span("render.cull"):
        culled, gids, n_active = cull_for_render(
            smap, view, cam, num_blocks, block_size, max_depth, margin=footprint + 2,
        )
    if method == "fast":
        # the culled table holds valid blocks first: stream only that prefix
        # through the z-buffer kernel (a pow2 budget can pad the tail)
        nv = valid_prefix(n_active, num_blocks, block_size)
        out = splat_render_fast(culled, view, cam, max_depth, footprint,
                                classes=classes, n_valid=nv)
    else:
        # the exact method is the quality reference: single window, no
        # footprint buckets (the side table scales with the culled size and
        # could overflow into cropped splats)
        out = splat_render(culled, view, cam, max_depth, footprint, small_footprint=None)
    idl = out["id"]
    gid = gids.index_select(0, torch.clamp(idl, 0, gids.shape[0] - 1).reshape(-1))
    out["id"] = torch.where(idl >= 0, gid.view(idl.shape).to(torch.int32), -1)
    return out, n_active
