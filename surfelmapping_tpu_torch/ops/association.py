"""Projective data association + merge over the whole map (counterpart of
surfelmapping_tpu/ops/association.py).

The data.vert association and merge kernel as dense per-pixel math.  For
every valid pixel it builds a candidate surfel (ops/frame_surfels.py), looks
up the index map in a ``factor x factor`` sub-pixel window (factor 1 in the
reference: the co-located texel, src/IndexMap.cpp:21), gates the map surfel
by same class, ray-depth distance <= fuseThresh and normal angle < 0.5 rad,
keeps the one nearest the pixel ray (data.vert:126-172), and emits the
merged surfel (confidence-weighted average, data.vert:174-208), a new
unstable surfel (mark -1, data.vert:210-225) or nothing (mark -10).

Reproduced quirks: index validity is ``id > 0`` (surfel 0 is unmatchable,
data.vert:142); the merged color is the new color (data.vert:183 averages
the new color with itself); the merged radius is min(new, old)
(data.vert:193).

The fusion step runs the active-table form (ops/active.py:associate_active);
this form, a reference that no path of the engine runs (the tests hold it
against the JAX package, chip_smoke's ``small_reference`` runs it on the
card), reads the whole map through :func:`index_map.gather_fields` and
returns dense [H, W] records.  The per-pixel arithmetic is that of
``associate_active``, term for term.  The JAX function this mirrors raises
before it computes anything: it unpacks ``ray_geometry``'s three values into
two (surfelmapping_tpu/ops/association.py:93) and reads candidate and
gather keys that its planar modules no longer have (``cand.pos``,
``g["sem"]``, ``g["rgb"]``).  The port implements the contract its
docstrings state.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import CameraIntrinsics, PipelineParams
from ..surfels import SurfelMap
from .active import _angle_between
from .colors import decode_color
from .frame_surfels import association_candidates, ray_geometry
from .index_map import gather_fields
from .transforms import ieee_sqrt, normalize_planar, rotate_planar, transform_planar


@dataclasses.dataclass
class AssociationResult:
    """Dense per-pixel fusion records in the WORLD frame ([H, W] leading
    dims); ``mark`` i32[H, W] with the reference's -10 / -1 / >= 0
    convention (>= 0: the map slot to fuse into)."""

    pos: torch.Tensor      # f32[H,W,3] world position (merged or new)
    conf: torch.Tensor     # f32[H,W]
    rgb: torch.Tensor      # f32[H,W,3] on the 8-bit color lattice
    sem: torch.Tensor      # i32[H,W]
    init_t: torch.Tensor   # f32[H,W]
    last_t: torch.Tensor   # f32[H,W]
    normal: torch.Tensor   # f32[H,W,3]
    radius: torch.Tensor   # f32[H,W]
    mark: torch.Tensor     # i32[H,W]


def associate(
    depth: torch.Tensor,
    rgb: torch.Tensor,
    semantic: torch.Tensor,
    index_image: torch.Tensor,
    smap: SurfelMap,
    pose: torch.Tensor,
    T_inv: torch.Tensor,
    time: float,
    cam: CameraIntrinsics,
    params: PipelineParams,
    fuse_thresh: float | None = None,
) -> AssociationResult:
    """The association + merge kernel over the whole frame.

    ``index_image`` is :func:`index_map.build_index_map`'s i32[H*F, W*F]
    image for the same pose; ``fuse_thresh`` defaults to
    params.fuse_thresh_factor (0.0 in the reference build)."""
    p = params
    if fuse_thresh is None:
        fuse_thresh = p.fuse_thresh_factor
    factor = p.index_factor

    cand = association_candidates(depth, rgb, semantic, cam, p)
    xl, yl, lam = ray_geometry(cam, depth.device)

    best = None
    for wi in range(factor):
        for wj in range(factor):
            # the sub-pixel texel (j*F + wj, i*F + wi) under pixel (j, i)
            mid = index_image[wj::factor, wi::factor]
            has = mid > 0  # the reference's validity convention
            g = gather_fields(smap, mid, T_inv)
            px, py, pz = g["pos"].unbind(-1)
            cnx, cny, cnz = g["normal"].unbind(-1)
            o_cs = g["colorsem"]
            depth_gate = torch.abs(pz * lam - depth * lam) <= fuse_thresh
            sem_gate = cand.sem == ((o_cs >> 24) & 0xFF)
            # perpendicular distance of the old vertex to the ray (xl, yl, 1)
            crx = yl * pz - 1.0 * py
            cry = 1.0 * px - xl * pz
            crz = xl * py - yl * px
            dist = ieee_sqrt(crx * crx + cry * cry + crz * crz) / lam
            ang = _angle_between(cnx, cny, cnz, cand.nx, cand.ny, cand.nz)
            ok = has & sem_gate & depth_gate & (torch.abs(ang) < p.merge_normal_angle)
            entry = dict(dist=torch.where(ok, dist, torch.inf), id=mid, px=px, py=py, pz=pz,
                         conf=g["conf"], cs=o_cs, init=g["init_t"], nx=cnx, ny=cny, nz=cnz,
                         rad=g["radius"])
            if best is None:
                best = entry
            else:
                take = entry["dist"] < best["dist"]
                best = {k: torch.where(take, entry[k], best[k]) for k in best}

    matched = cand.valid & torch.isfinite(best["dist"])

    # ---- merge math (data.vert:174-208) -----------------------------------
    c_n = cand.conf
    c_o = best["conf"]
    csum = c_n + c_o
    merge_small = cand.radius < p.merge_radius_factor * best["rad"]

    def merged(new, old):
        return torch.where(merge_small, (c_n * new + c_o * old) / csum, old)

    ox = torch.where(matched, merged(cand.px, best["px"]), cand.px)
    oy = torch.where(matched, merged(cand.py, best["py"]), cand.py)
    oz = torch.where(matched, merged(cand.pz, best["pz"]), cand.pz)
    onx = torch.where(matched, merged(cand.nx, best["nx"]), cand.nx)
    ony = torch.where(matched, merged(cand.ny, best["ny"]), cand.ny)
    onz = torch.where(matched, merged(cand.nz, best["nz"]), cand.nz)
    mrad = torch.where(merge_small, torch.minimum(cand.radius, best["rad"]), best["rad"])
    radius = torch.where(matched, mrad, cand.radius)
    conf = torch.where(matched, csum, c_n)
    # data.vert:183: the merged color is the new color
    colorsem = torch.where(matched & ~merge_small, best["cs"], cand.colorsem)
    init_t = torch.where(matched, best["init"], torch.full_like(c_n, time))
    last_t = torch.full_like(c_n, time)

    wx, wy, wz = transform_planar(pose, ox, oy, oz)
    wnx, wny, wnz = normalize_planar(*rotate_planar(pose, onx, ony, onz))
    mark = torch.where(cand.valid, torch.where(matched, best["id"], -1), -10)
    return AssociationResult(
        pos=torch.stack([wx, wy, wz], dim=-1),
        conf=conf,
        rgb=decode_color(colorsem)[0],
        sem=cand.sem,
        init_t=init_t,
        last_t=last_t,
        normal=torch.stack([wnx, wny, wnz], dim=-1),
        radius=radius,
        mark=mark.to(torch.int32),
    )
