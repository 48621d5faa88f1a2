"""Projective index map, full-map form (counterpart of
surfelmapping_tpu/ops/index_map.py).

The reference renders every active surfel into a depth-tested FBO
(src/IndexMap.cpp:138-198, src/Shaders/index_map.vert/.frag).  Here the GL
z-buffer is a two-pass scatter-argmin: scatter-min the surfels' depth keys
into their pixels, then scatter-min the ids of the surfels whose key equals
their pixel's minimum (ties resolve to the smallest id).

This form associates against the WHOLE map; the fusion step uses the
active-table form (ops/active.py:index_active), whose z-buffer is the K1
kernel.  Both are plain torch here: the JAX package's functions are XLA.
Apart from ``_depth_key``, this module is a reference form that no path of
the engine runs: the tests hold it against the JAX package, and
chip_smoke's ``small_reference`` phase runs it on the card.

Pixel convention: a point projected to continuous (u, v) lands in pixel
(ceil(u)-1, ceil(v)-1), the GL point-rasterization rule for size-1 points.
Empty pixels hold id -1; consumers keep the reference's ``id > 0`` validity
convention (surfel 0 is unmatchable: data.vert:142, conflict.geom:17).
"""

from __future__ import annotations

import torch

from ..config import CameraIntrinsics, PipelineParams
from ..surfels import SurfelMap
from .transforms import normalize_planar, project_planar, rotate_planar, transform_planar

INT32_MAX = 2**31 - 1


def _depth_key(z: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Monotonic int32 key for positive-float depth ordering; invalid -> MAX.
    The key is the float's bit pattern: for z > 0 it is >= 0 and orders
    like z."""
    key = z.to(torch.float32).view(torch.int32)
    return torch.where(valid, key, INT32_MAX)


def scatter_argmin_image(
    flat_pix: torch.Tensor,
    z: torch.Tensor,
    valid: torch.Tensor,
    num_pixels: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Generic z-buffer: (winner_id i32[num_pixels], depth_key i32[num_pixels]).

    ``flat_pix`` is each element's flat pixel (any value where invalid).
    The winner is the smallest element index among the depth minimisers;
    an empty pixel holds id -1 and key INT32_MAX."""
    n = flat_pix.shape[0]
    dev = flat_pix.device
    key = _depth_key(z, valid)
    # the spare bin num_pixels takes the invalid elements (JAX drops them)
    idx = torch.where(valid, flat_pix.long(), num_pixels)
    depth_buf = torch.full((num_pixels + 1,), INT32_MAX, dtype=torch.int32, device=dev)
    depth_buf.scatter_reduce_(0, idx, key, "amin")
    is_winner = valid & (key == depth_buf[idx])
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    id_buf = torch.full((num_pixels + 1,), INT32_MAX, dtype=torch.int32, device=dev)
    id_buf.scatter_reduce_(0, torch.where(is_winner, idx, num_pixels), ids, "amin")
    id_buf = torch.where(id_buf == INT32_MAX, -1, id_buf)
    return id_buf[:num_pixels], depth_buf[:num_pixels]


def project_surfels(smap: SurfelMap, T_inv: torch.Tensor, cam: CameraIntrinsics):
    """Camera-frame planar positions and continuous projections of every
    slot: (x, y, z, u, v), each f32[capacity]."""
    return project_planar(T_inv, smap.column("px"), smap.column("py"), smap.column("pz"),
                          cam)


def build_index_map(
    smap: SurfelMap,
    T_inv: torch.Tensor,
    time: float,
    cam: CameraIntrinsics,
    params: PipelineParams,
) -> torch.Tensor:
    """predictIndices (src/IndexMap.cpp:138-198): id image i32[H*F, W*F].

    Active-surfel gates (index_map.vert:45 + GL clipping/depth test): live
    and conf > 0 (tombstones excluded), z < farClip, z > 0,
    time - last_t <= timeDelta, pixel inside the image."""
    factor = params.index_factor
    icam = cam.scaled(factor)
    H, W = icam.height, icam.width
    _, _, z, u, v = project_surfels(smap, T_inv, icam)
    live = smap.live_mask() & (smap.column("conf") > 0.0)
    fresh = (time - smap.column("last_t")) <= params.time_delta
    pi = torch.ceil(u).to(torch.int32) - 1
    pj = torch.ceil(v).to(torch.int32) - 1
    inb = (pi >= 0) & (pi < W) & (pj >= 0) & (pj < H)
    valid = live & fresh & (z > 0.0) & (z < params.far_clip) & inb
    id_buf, _ = scatter_argmin_image(pj * W + pi, z, valid, H * W)
    return id_buf.view(H, W)


def gather_fields(smap: SurfelMap, ids: torch.Tensor, T_inv: torch.Tensor
                  ) -> dict[str, torch.Tensor]:
    """Camera-frame attributes of the surfels ``ids`` (int[...]), the
    counterpart of the reference's vertConf/colorTime/normRad index-map
    attachments (index_map.vert:61-63).  Out-of-range ids clamp; the caller
    masks with its own validity.  ``pos``/``normal`` are stacked [..., 3]."""
    safe = torch.clamp(ids.long(), 0, smap.capacity - 1)

    def g(name):
        return smap.column(name)[safe]

    x, y, z = transform_planar(T_inv, g("px"), g("py"), g("pz"))
    nx, ny, nz = normalize_planar(*rotate_planar(T_inv, g("nx"), g("ny"), g("nz")))
    return {
        "pos": torch.stack([x, y, z], dim=-1),
        "conf": g("conf"),
        "colorsem": g("colorsem"),
        "init_t": g("init_t"),
        "normal": torch.stack([nx, ny, nz], dim=-1),
        "radius": g("radius"),
    }
