"""The reference fusion drive: the fusion step of
``surfelmapping_tpu_torch/pipeline.py:_fusion_step`` (frozen at commit
dd68e64) on this package's plain operations, driven frame by frame.

The step plans with a budget of every block, so it never truncates and
never replays: the engine's result does not depend on the budget once
nothing is truncated.  Frames come from the benchmark's own generator, and
each frame's LAST depth is worked out again from the frame before it.
"""

from __future__ import annotations

import numpy as np
import torch

from .active import (associate_active, conflict_active, fuse_append_map, gather_active,
                     index_active, plan_active_blocks, valid_prefix)
from .colors import unit_rgb
from .config import CameraIntrinsics, PipelineParams
from .preprocess import preprocess_frame, remove_movings
from .surfels import COLUMNS, SurfelMap
from .transforms import compose, invert_se3


def stage(frame, device) -> tuple:
    """A generated frame (rgb u8[H,W,3], depth i32[H,W] mm, semantic u8[H,W],
    pose f32[4,4]) as the step reads it."""
    rgb, depth, sem, pose = frame
    pose = torch.as_tensor(np.asarray(pose, np.float32), device=device)
    return unit_rgb(rgb.to(device)), depth.to(device), sem.to(device, torch.int32), pose


def fusion_step(smap: SurfelMap, depth_raw, rgb, semantic, pose, last_depth, last_pose,
                time: float, cam: CameraIntrinsics, params: PipelineParams,
                block_size: int) -> tuple[SurfelMap, torch.Tensor]:
    """One incremental fusion step, in place on ``smap``; returns the map
    and the frame's filtered depth (the next frame's LAST image)."""
    filtered = preprocess_frame(depth_raw, semantic, cam, params)
    T_c2l = compose(invert_se3(last_pose), pose)
    depth_m = remove_movings(filtered, semantic, last_depth, T_c2l, cam, params)
    T_inv = invert_se3(pose)
    G = smap.capacity // block_size
    blk, n_active = plan_active_blocks(smap, T_inv, cam, params, G, block_size)
    # the active blocks lead: keep them (at least one slot, a filler when none)
    n = max(int(n_active), 1)
    blk = blk[:n]
    at = gather_active(smap, blk, block_size)
    at, _ = conflict_active(
        at, depth_m, semantic, T_inv, cam, params,
        min_depth=params.near_clip, max_depth=params.far_clip,
        fuse_thresh=params.fuse_thresh_factor, is_clean=False,
    )
    idx_img = index_active(at, T_inv, time, cam, params,
                           n_valid=valid_prefix(n_active, n, block_size))
    assoc = associate_active(depth_m, rgb, semantic, idx_img, at, pose, T_inv,
                             time, cam, params)
    smap, dropped = fuse_append_map(smap, at, assoc)
    if int(dropped):
        raise RuntimeError(f"reference map full: {int(dropped)} surfels dropped")
    return smap, filtered


def bfloat16_rounded(smap: SurfelMap) -> None:
    """The control's precision: every float column rounded to bfloat16."""
    for k in COLUMNS:
        col = getattr(smap, k)
        if col.dtype == torch.float32:
            col.copy_(col.to(torch.bfloat16).to(torch.float32))


def drive(smap: SurfelMap, frame_at, ticks: range, cam: CameraIntrinsics,
          params: PipelineParams, block_size: int, control: bool = False) -> SurfelMap:
    """Fuse frames ``ticks`` (consecutive, the first > 0) into ``smap`` in
    place; ``frame_at(t)`` gives frame t.  With ``control`` the map is held
    in bfloat16 precision after every step."""
    dev = smap.device
    prev = stage(frame_at(ticks[0] - 1), dev)
    last_depth = preprocess_frame(prev[1], prev[2], cam, params)
    last_pose = prev[3]
    for t in ticks:
        rgb, depth, sem, pose = stage(frame_at(t), dev)
        smap, last_depth = fusion_step(smap, depth, rgb, sem, pose, last_depth, last_pose,
                                       float(t), cam, params, block_size)
        last_pose = pose
        if control:
            bfloat16_rounded(smap)
    return smap



def live_records(smap: SurfelMap) -> torch.Tensor:
    """The live surfels (slots below the cursor with conf > 0) in slot
    order, as int32 bits [n, 11]: the map's content whatever its capacity
    and wherever compaction has closed the gaps."""
    n = int(smap.count)
    keep = smap.conf[:n] > 0.0
    return torch.stack([getattr(smap, k)[:n][keep].view(torch.int32) for k in COLUMNS], dim=1)


def record_mismatch(a: SurfelMap, b: SurfelMap) -> int:
    """Live surfels of ``a`` and ``b`` that differ in any bit, position by
    position, plus the difference of their counts."""
    ra, rb = live_records(a), live_records(b)
    n = min(ra.shape[0], rb.shape[0])
    differ = int((ra[:n] != rb[:n]).any(dim=1).sum())
    return differ + abs(ra.shape[0] - rb.shape[0])
