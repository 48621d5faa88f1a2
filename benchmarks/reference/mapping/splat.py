"""Frozen copy of ``surfelmapping_tpu_torch/ops/splat.py`` at commit dd68e64,
trimmed to what the benchmark's reference needs.  The point-sprite
renderer's candidates, disc dilation and decode.
"""

from __future__ import annotations

import torch

from .config import CameraIntrinsics
from .surfels import SurfelMap
from .colors import decode_color
from .index_map import INT32_MAX, _depth_key
from .transforms import (ieee_sqrt, invert_se3, normalize_planar,
                         rotate_planar, transform_planar)
from .zbuf import key_id_views, zbuffer_argmin_packed

SQRT2 = 1.41421356237
EMPTY_WORD = (INT32_MAX << 32) | INT32_MAX  # packed (key, id) of an empty pixel


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


def _dilate(packed: torch.Tensor, classes: tuple[int, ...],
            cam: CameraIntrinsics) -> tuple[torch.Tensor, torch.Tensor]:
    """Disc-shaped min-dilation of each class's centre buffer, merged over
    the classes: per pixel the smallest (key, id) pair, by key and then by
    id, among the centres whose class disc covers it.  The buffers come from
    K1 as int64 words (key << 32) | id, which order the same way, so a stamp
    is one ``torch.minimum``.  Stamps reaching outside the image read the
    empty word.  Returns the merged (key, id) planes as int32 views."""
    H, W = cam.height, cam.width
    packed = packed.view(len(classes), H, W)
    out = torch.full((H, W), EMPTY_WORD, dtype=torch.int64, device=packed.device)
    for ci, R in enumerate(classes):
        src = torch.constant_pad_nd(packed[ci], (R, R, R, R), EMPTY_WORD)
        for dj in range(-R, R + 1):
            for di in range(-R, R + 1):
                if dj * dj + di * di > (R + 0.5) ** 2:
                    continue  # disc-shaped stamp
                # out[r, c] <- min(out[r, c], centre[r - dj, c - di])
                torch.minimum(out, src[R - dj:R - dj + H, R - di:R - di + W], out=out)
    return key_id_views(out.reshape(-1))


def render_u8(smap: SurfelMap, view: torch.Tensor, cam: CameraIntrinsics,
              max_depth: float = 200.0, footprint: int = 5,
              classes: tuple[int, ...] = (1, 2, 3, 5)) -> tuple[torch.Tensor, torch.Tensor]:
    """The fast renderer over the WHOLE map, with no cull: every surfel's
    centre into its class buffer, the disc dilation, the decode.  Returns
    the image and semantic PNGs as u8 tensors (RGB rounded and clipped to
    [0, 255]; the semantic as class+1, 0 = hole)."""
    num_pix = cam.height * cam.width
    key, cflat, classes, _ = fast_candidates(smap, view, cam, max_depth, footprint, classes)
    packed = zbuffer_argmin_packed(key, cflat, len(classes) * num_pix)
    keys, ids = _dilate(packed, classes, cam)
    out = _decode(smap, keys, ids, cam)
    rgb = torch.clamp(torch.round(out["rgb"] * 255.0), 0, 255).to(torch.uint8)
    return rgb, out["semantic"].to(torch.uint8)

