"""Local surfel model: unconditional per-pixel surfel creation (counterpart
of surfelmapping_tpu/ops/local_model.py).

GlobalModel::getLocalSurfelModel + genLSM.vert/.geom
(src/GlobalModel.cpp:1077-1176): the same candidate-surfel front half as the
association kernel but without association — every valid pixel becomes a
new unstable world-frame surfel.  The reference computes this every frame
into a scratch VBO for inspection; here it is an on-demand function.
"""

from __future__ import annotations

import torch

from ..config import CameraIntrinsics, PipelineParams
from ..surfels import COLUMNS, SurfelMap
from .fusion import _column_major_flat
from .frame_surfels import association_candidates
from .transforms import normalize_planar, rotate_planar, transform_planar


def local_surfel_model(
    depth: torch.Tensor,
    rgb: torch.Tensor,
    semantic: torch.Tensor,
    pose: torch.Tensor,
    time: float,
    cam: CameraIntrinsics,
    params: PipelineParams,
) -> SurfelMap:
    """This frame's surfels in the world frame as a compacted map (capacity
    H*W, live prefix = the valid pixels, in the reference's uv column-major
    order).  ``depth`` is metric, ``rgb`` f32[H,W,3] in [0,1]."""
    fs = association_candidates(depth, rgb, semantic, cam, params)
    wx, wy, wz = transform_planar(pose, fs.px, fs.py, fs.pz)
    wnx, wny, wnz = normalize_planar(*rotate_planar(pose, fs.nx, fs.ny, fs.nz))

    valid = _column_major_flat(fs.valid)
    n = valid.shape[0]
    dest = torch.cumsum(valid.to(torch.int32), 0) - 1
    idx = torch.where(valid, dest, n)  # invalid pixels go to the spare slot

    t = torch.full(fs.conf.shape, time, dtype=torch.float32, device=depth.device)
    src = dict(px=wx, py=wy, pz=wz, conf=fs.conf, colorsem=fs.colorsem, init_t=t,
               last_t=t, nx=wnx, ny=wny, nz=wnz, radius=fs.radius)
    cols = {}
    for k in COLUMNS:
        flat = _column_major_flat(src[k])
        cols[k] = torch.zeros(n + 1, dtype=flat.dtype, device=flat.device).index_copy_(
            0, idx, flat)
    count = torch.clamp(dest[-1] + 1, min=0).to(torch.int32)
    return SurfelMap(**cols, count=count)
