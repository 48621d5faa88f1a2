"""SurfelMapper: the per-frame pipeline driver (counterpart of
surfelmapping_tpu/pipeline.py:60-714).

Behavioural contract reproduced exactly:
  * frame 0 only seeds the LAST depth image + lastPose and returns
    (src/SurfelMapping.cpp:142-154);
  * the tick==0 initialize branch is only reachable after reset()
    (src/SurfelMapping.cpp:161-168);
  * per-frame stage order: preprocess -> movings -> conflict -> index map
    -> associate -> fuse -> append (src/SurfelMapping.cpp:171-242);
  * cleanPoints: metricize only, conflict with maxDepth = farClip - 15,
    fuseThresh = 0.1, isClean = 1 (src/SurfelMapping.cpp:496-532).

The frame is a sequence of PyTorch ops and the two hand-written kernels,
enqueued on the card without any read back to the host.  The host reads
the device once per ``sync_every`` frames (one stacked copy) to verify the
window's active-block budget, to catch an overflow, and to drive capacity
growth and compaction.  The map columns are updated in place; the window's
starting map is kept as a copy by value so a budget overflow can be replayed
exactly.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .config import CameraIntrinsics, MapConfig, PipelineParams
from .ops.active import (
    associate_active,
    conflict_active,
    fuse_append_map,
    gather_active,
    index_active,
    plan_active_blocks,
)
from .ops.frame_surfels import feedback_surfels
from .ops.fusion import compact, conflict_pass, initialize_map
from .ops.preprocess import metricize_depth, preprocess_frame, remove_movings
from .ops.transforms import compose, full_precision_matmul, invert_se3
from .surfels import SurfelMap, empty_map, load_map, resize_map, save_map
from .utils.stopwatch import Stopwatch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``None`` means the card; a CUDA device without CUDA raises (the CPU
    runs only when asked for)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch versions on the CPU")
    return dev


def _live_count(smap: SurfelMap) -> torch.Tensor:
    return (smap.column("conf") > 0.0).sum(dtype=torch.int32)


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------

def _preprocess_only(depth_raw, semantic, cam: CameraIntrinsics,
                     params: PipelineParams) -> torch.Tensor:
    """Frame-0 path: produce the LAST depth image only."""
    return preprocess_frame(depth_raw, semantic, cam, params)


def _init_step(smap, depth_raw, rgb, semantic, pose, last_depth, last_pose,
               time: float, cam: CameraIntrinsics, params: PipelineParams):
    """tick==0 (post-reset) path: preprocess + movings + feedback-buffer init
    (src/SurfelMapping.cpp:161-168).  Appends to ``smap`` in place."""
    filtered = preprocess_frame(depth_raw, semantic, cam, params)
    T_c2l = compose(invert_se3(last_pose), pose)
    depth_m = remove_movings(filtered, semantic, last_depth, T_c2l, cam, params)
    frame = feedback_surfels(depth_m, rgb, semantic, cam, params)
    smap, dropped = initialize_map(smap, frame, pose, time)
    return smap, filtered, dropped


def _fusion_step(smap: SurfelMap, depth_raw, rgb, semantic, pose, last_depth,
                 last_pose, time: float, cam: CameraIntrinsics,
                 params: PipelineParams, active_blocks: int, block_size: int):
    """The incremental fusion step (tick > 0) on the active-block engine, in
    the reference's stage order (src/SurfelMapping.cpp:171-242).  The map
    columns are updated in place (the JAX step donated its map)."""
    filtered = preprocess_frame(depth_raw, semantic, cam, params)
    T_c2l = compose(invert_se3(last_pose), pose)
    depth_m = remove_movings(filtered, semantic, last_depth, T_c2l, cam, params)
    T_inv = invert_se3(pose)

    blk, n_active = plan_active_blocks(smap, T_inv, cam, params, active_blocks, block_size)
    at = gather_active(smap, blk, block_size)
    at, removed = conflict_active(
        at, depth_m, semantic, T_inv, cam, params,
        min_depth=params.near_clip, max_depth=params.far_clip,
        fuse_thresh=params.fuse_thresh_factor, is_clean=False,
    )
    idx_img = index_active(at, T_inv, time, cam, params)
    assoc = associate_active(depth_m, rgb, semantic, idx_img, at, pose, T_inv,
                             time, cam, params)
    smap, dropped = fuse_append_map(smap, at, assoc)

    stats = {
        "removed": removed,
        "merged": (assoc.mark >= 0).sum(dtype=torch.int32),
        "new": (assoc.mark == -1).sum(dtype=torch.int32),
        "count": _live_count(smap),  # live (tombstones excluded)
        "active_blocks": n_active,
    }
    return smap, filtered, dropped, stats


def _clean_step(smap: SurfelMap, depth_raw, semantic, pose,
                cam: CameraIntrinsics, params: PipelineParams) -> SurfelMap:
    """Backward ghost-removal pass (src/SurfelMapping.cpp:496-532)."""
    depth_m = metricize_depth(depth_raw, cam, params)
    T_inv = invert_se3(pose)
    new_conf = conflict_pass(
        smap, depth_m, semantic, T_inv, cam, params,
        min_depth=params.near_clip, max_depth=params.far_clip - 15.0,
        fuse_thresh=params.clean_fuse_thresh_factor, is_clean=True,
    )
    smap.column("conf").copy_(new_conf)
    return compact(smap)


def _gather_active_for(smap: SurfelMap, pose, cam: CameraIntrinsics,
                       params: PipelineParams, active_blocks: int, block_size: int):
    """Plan + gather the active table for an arbitrary camera pose; also
    returns the TRUE active-block count so the caller can detect a
    truncated gather."""
    T_inv = invert_se3(pose)
    blk, n_active = plan_active_blocks(smap, T_inv, cam, params, active_blocks, block_size)
    return gather_active(smap, blk, block_size), n_active


# ---------------------------------------------------------------------------
# Host-side driver
# ---------------------------------------------------------------------------

class SurfelMapper:
    """Host orchestrator with the reference's SurfelMapping API surface
    (processFrame / cleanPoints / reset analogues + checkpoint IO).

    ``device=None`` runs on the card and raises if there is none; the CPU
    runs only when asked for (``device="cpu"``)."""

    def __init__(
        self,
        cam: CameraIntrinsics,
        params: PipelineParams | None = None,
        map_config: MapConfig | None = None,
        sync_every: int = 8,
        device: torch.device | str | None = None,
    ):
        self.device = resolve_device(device)
        full_precision_matmul()
        self.cam = cam
        self.params = params or PipelineParams()
        self.map_config = map_config or MapConfig()
        if cam.height % 2 or cam.width % 2:
            raise ValueError(
                "active-block engine needs even image dims (checkerboard "
                f"slicing); got {cam.width}x{cam.height} — pad the frames"
            )
        self.stopwatch = Stopwatch()
        # requested active-block budget; effective value is min(this, #blocks)
        self.active_blocks = self.map_config.active_blocks
        # the buffer pre-grows by sync_every * H*W/2 worst-case slots, and the
        # replay window retains every frame's staged inputs until the next
        # sync, so the window length is clamped
        self.sync_every = max(1, min(sync_every, 128))
        self.reset_all()

    # -- state management ---------------------------------------------------

    def reset_all(self) -> None:
        """Fresh engine: empty map, no reference frame."""
        H, W = self.cam.height, self.cam.width
        self._smap = empty_map(self.map_config.rounded_capacity(self.map_config.capacity),
                               self.device)
        self.last_depth = torch.zeros((H, W), dtype=torch.float32, device=self.device)
        self.last_pose = torch.eye(4, dtype=torch.float32, device=self.device)
        self.tick = 0
        self.ref_frame_set = False
        self.history_poses: list = []
        self.last_stats: dict[str, Any] = {}
        # host events that explain throughput anomalies
        self.events = {"replays": 0, "budget_growths": 0, "compacts": 0,
                       "capacity_growths": 0, "peak_active": 0}
        self._clear_window()

    def _clear_window(self) -> None:
        self._cached_count = 0   # live surfels (tombstones excluded)
        self._cached_tail = 0    # allocation cursor (smap.count)
        self._since_sync = 0
        self._pending_dropped: list[torch.Tensor] = []
        self._pending_active: list[torch.Tensor] = []
        # Budget-overflow guard (see _repair_overflow): a copy by value of the
        # map at the start of the unverified window + each window frame's
        # staged inputs and dispatched budget.
        self._chk: SurfelMap | None = None
        self._window: list = []

    @property
    def _effective_active_blocks(self) -> int:
        return min(self.active_blocks, self._smap.capacity // self.map_config.block_size)

    def reset(self) -> None:
        """Map reset (src/SurfelMapping.cpp:436-441): clears the model and
        tick but keeps the reference frame, so the next frame takes the
        tick==0 initialize path."""
        self._smap = empty_map(self._smap.capacity, self.device)
        self.tick = 0
        self.history_poses = []
        self._clear_window()

    @property
    def smap(self) -> SurfelMap:
        """The surfel map, compacted for external consumption.

        The internal map defers removal (tombstones, conf <= 0); reading this
        property syncs and compacts, so consumers see exactly what the
        reference's per-frame back-mapping would have produced.

        LIFETIME: the returned map IS the live map, which the next
        ``process_frame`` updates in place.  Consume it before the next
        frame, or take :meth:`snapshot`."""
        self._refresh_counts()
        if self._cached_tail != self._cached_count:
            self._compact_now()
        return self._smap

    @smap.setter
    def smap(self, value: SurfelMap) -> None:
        self._smap = value

    def snapshot(self) -> SurfelMap:
        """A copy by value of :attr:`smap` that later frames do not touch."""
        return self.smap.clone()

    @property
    def count(self) -> int:
        """Live surfel count (a host sync point)."""
        self._refresh_counts()
        return self._cached_count

    def _compact_now(self) -> None:
        # compact only the pow2 bucket covering the allocation cursor: every
        # written slot is below the tail, so the result is identical and the
        # column scatters cost O(bucket), not O(capacity)
        self.events["compacts"] += 1
        cfg = self.map_config
        bucket = cfg.rounded_capacity(max(self._cached_tail, 1))
        b2 = cfg.block_size
        while b2 < bucket:
            b2 *= 2
        bucket = min(b2, self._smap.capacity)
        self._smap = compact(self._smap, prefix=bucket)
        self._cached_tail = int(self._smap.count)
        if self._cached_tail != self._cached_count:
            raise RuntimeError("compaction changed the live count — tombstone "
                               "accounting bug")

    def _read_pending(self) -> tuple[list[int], list[int], int, int]:
        """ONE stacked device->host read: each window frame's true active
        block count and dropped count, the map's cursor and its live count."""
        k = len(self._pending_active)
        vals = self._pending_active + self._pending_dropped + [
            self._smap.count, _live_count(self._smap)]
        host = torch.stack(vals).tolist()  # all int32
        return host[:k], host[k:-2], host[-2], host[-1]

    def _repair_overflow(self) -> tuple[list[int], list[int], int, int]:
        """Verify the unverified frame window and repair budget overflows.

        If any frame ran with a truncated working set (budget < true active
        block count), the budget grows and the WHOLE window is replayed from
        the retained checkpoint: the result is identical to a run that never
        overflowed.  Repair loops because the replayed maps can expose a
        still-larger working set.  Returns the final :meth:`_read_pending`."""
        cfg = self.map_config
        for _ in range(32):  # paranoid bound; budget growth is monotone
            acts, dropped, tail, live = self._read_pending()
            if not self._window:
                return acts, dropped, tail, live
            effs = [eff for (_, eff) in self._window]
            self.events["peak_active"] = max(self.events["peak_active"], max(acts))
            if all(a <= e for a, e in zip(acts, effs)):
                return acts, dropped, tail, live
            peak = max(acts)
            self.events["replays"] += 1
            while self.active_blocks < peak:
                self.active_blocks *= 2
                self.events["budget_growths"] += 1
            # the replay updates its map in place: start from a copy so a
            # further repair round can replay again
            smap = self._chk.clone()
            filtered = None
            for i, (inp, _) in enumerate(self._window):
                eff = self._effective_active_blocks
                smap, filtered, dropped_i, stats_dev = _fusion_step(
                    smap, *inp, self.cam, self.params, eff, cfg.block_size,
                )
                self._pending_dropped[i] = dropped_i
                self._pending_active[i] = stats_dev["active_blocks"]
                self._window[i] = (inp, eff)
            self._smap = smap
            self.last_depth = filtered
        raise RuntimeError("active-budget repair did not converge (bug)")

    def _refresh_counts(self) -> None:
        """Periodic host sync: verify/repair the frame window, check the
        overflow flags, cache counts, apply the deferred-compaction policy
        and the active-budget tuning."""
        acts, dropped, tail, live = self._repair_overflow()
        if sum(dropped):
            raise RuntimeError(
                f"surfel buffer overflow dropped {sum(dropped)} surfels — "
                "pre-growth margin violated (bug)"
            )
        cfg = self.map_config
        if acts and not cfg.freeze_active_budget:
            # right-size the budget to the measured working set, with wide
            # hysteresis (grow at 0.75 occupancy, shrink at 3x slack);
            # undershoot is repaired exactly by _repair_overflow
            peak = max(acts)
            eff = self._effective_active_blocks
            if peak > cfg.active_watermark * eff:
                target = max(eff, 64)
                while peak > cfg.active_watermark * target:
                    target *= 2
                self.active_blocks = target
            elif peak * 3 < eff and eff > 64:
                self.active_blocks = max(64, eff // 2)
        self._pending_dropped = []
        self._pending_active = []
        self._chk = None
        self._window = []
        self._cached_tail = tail
        self._cached_count = live
        self._since_sync = 0
        dead = self._cached_tail - self._cached_count
        # reclaim tombstones only under ALLOCATION PRESSURE (the cursor
        # nearing the growth watermark): dead slots never re-activate blocks,
        # so a pre-sized capacity absorbs them for free, while an eager
        # compaction stalls the frame loop
        if (
            dead > cfg.compact_dead_frac * self._smap.capacity
            and self._cached_tail > 0.75 * self._smap.capacity
        ):
            self._compact_now()

    def _maybe_grow_cached(self, need: int) -> None:
        cfg = self.map_config
        cap = self._smap.capacity
        if need <= cap * cfg.watermark:
            return
        # reclaim tombstones before buying memory
        self._refresh_counts()
        if self._cached_tail > self._cached_count:
            dead = self._cached_tail - self._cached_count
            self._compact_now()
            need = max(self._cached_tail, need - dead)
        new_cap = cap
        while need > new_cap * cfg.watermark:
            new_cap = int(new_cap * cfg.growth_factor)
        new_cap = cfg.rounded_capacity(new_cap)
        if new_cap > cap:
            self.events["capacity_growths"] += 1
            self._smap = resize_map(self._smap, new_cap)

    def _maybe_grow(self, needed_extra: int = 0) -> None:
        self._maybe_grow_cached(int(self._smap.count) + needed_extra)

    def active_table(self, pose):
        """Gather the in-frustum active table for an external consumer (ICP /
        windowed BA) at the fusion step's O(in-view) cost.  ``pose`` is
        camera-to-world.  Never truncated: the budget grows and the gather
        repeats until it covers the pose's working set."""
        self._repair_overflow()
        pose = self._to_device(None, None, None, pose)[3]
        while True:
            eff = self._effective_active_blocks
            at, n_active = _gather_active_for(
                self._smap, pose, self.cam, self.params,
                eff, self.map_config.block_size,
            )
            n = int(n_active)
            if n <= eff or eff >= self._smap.capacity // self.map_config.block_size:
                return at
            while self.active_blocks < n:
                self.active_blocks *= 2

    # -- frame ingestion ----------------------------------------------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            # pinned + non-blocking: a pageable copy would wait for the queue
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _to_device(self, rgb, depth, semantic, pose):
        """Stage a frame on the mapper's device.

        Uploads the NARROW dtypes (u8 rgb/semantic, u16 depth) and widens on
        the device; tensors already there pass through, so callers can
        pre-stage frames.  ``None`` entries stay ``None``."""
        dev = self.device
        if rgb is not None:
            if not isinstance(rgb, torch.Tensor):
                rgb_np = np.asarray(rgb)
                if rgb_np.dtype != np.uint8 and np.issubdtype(rgb_np.dtype, np.integer):
                    rgb_np = rgb_np.astype(np.uint8)
                rgb = self._upload(rgb_np)
            rgb = rgb.to(dev)
            if not rgb.is_floating_point():
                rgb = rgb.to(torch.float32) / 255.0
            elif rgb.dtype != torch.float32:
                rgb = rgb.to(torch.float32)
        if depth is not None and not isinstance(depth, torch.Tensor):
            # u16 travels as its int16 bit pattern and is widened on the
            # device (int16 -> int32 sign-extends; the mask restores u16)
            raw = np.asarray(depth).astype(np.uint16).view(np.int16)
            depth = self._upload(raw).to(dev).to(torch.int32) & 0xFFFF
        if depth is not None:
            depth = depth.to(dev)
        if semantic is not None:
            if not isinstance(semantic, torch.Tensor):
                sem_np = np.asarray(semantic)
                if sem_np.dtype not in (np.uint8, np.int8):
                    if sem_np.max(initial=0) < 256 and sem_np.min(initial=0) >= 0:
                        sem_np = sem_np.astype(np.uint8)
                semantic = self._upload(sem_np)
            semantic = semantic.to(dev, torch.int32)
        if pose is not None:
            if not isinstance(pose, torch.Tensor):
                pose = self._upload(np.asarray(pose, np.float32))
            pose = pose.to(dev, torch.float32)
        return rgb, depth, semantic, pose

    def stage_frame(self, rgb, depth, semantic, pose):
        """Pre-stage a frame's arrays on the device (for prefetch pipelines)."""
        return self._to_device(rgb, depth, semantic, pose)

    def process_frame(self, rgb, depth, semantic, pose) -> dict[str, Any]:
        """Ingest one frame (reference processFrame,
        src/SurfelMapping.cpp:115-251).  ``pose`` is the camera-to-world 4x4.
        Returns per-frame stats (0-d device tensors; reading one syncs)."""
        sw = self.stopwatch
        # keep a host pose for the history without reading a staged one back
        pose_host = pose if isinstance(pose, np.ndarray) else None
        rgb, depth, semantic, pose = self._to_device(rgb, depth, semantic, pose)
        if pose_host is None:
            pose_host = pose

        if not self.ref_frame_set:
            with sw.time("Preprocess"):
                self.last_depth = _preprocess_only(depth, semantic, self.cam, self.params)
            self.last_pose = pose
            self.ref_frame_set = True
            self.history_poses.append(pose_host)
            self.tick += 1
            self.last_stats = {"count": self.count, "first_frame": True}
            return self.last_stats

        time = float(self.tick)
        if self.tick == 0:
            # only reachable after reset(); the step appends in place, so a
            # retry after growth starts again from the untouched map
            with sw.time("Initialize"):
                while True:
                    smap, filtered, dropped = _init_step(
                        self._smap.clone(), depth, rgb, semantic, pose,
                        self.last_depth, self.last_pose, time,
                        self.cam, self.params,
                    )
                    n_dropped = int(dropped)
                    if n_dropped == 0:
                        break
                    self._maybe_grow(n_dropped)
            self._smap = smap
            self._refresh_counts()
            stats = {"count": self._cached_count, "initialized": True}
        else:
            # pre-grow so overflow is impossible until the next periodic sync
            max_new = (self.cam.height * self.cam.width) // 2 + 1
            frames_ahead = self.sync_every - self._since_sync + 1
            self._maybe_grow_cached(self._cached_tail + frames_ahead * max_new)
            eff = self._effective_active_blocks
            prev_depth, prev_pose = self.last_depth, self.last_pose
            if not self._window:
                # the step updates the map in place: keep the pre-window
                # state by VALUE so overflow repair can replay
                self._chk = self._smap.clone()
            with sw.time("Run"):
                smap, filtered, dropped, stats_dev = _fusion_step(
                    self._smap, depth, rgb, semantic, pose,
                    prev_depth, prev_pose, time,
                    self.cam, self.params,
                    eff, self.map_config.block_size,
                )
            self._smap = smap
            n_act = stats_dev.pop("active_blocks")
            self._window.append(
                ((depth, rgb, semantic, pose, prev_depth, prev_pose, time), eff)
            )
            self._pending_dropped.append(dropped)
            self._pending_active.append(n_act)
            self._since_sync += 1
            if self._since_sync >= self.sync_every:
                self._refresh_counts()
            stats = stats_dev

        self.last_depth = filtered
        self.last_pose = pose
        self.history_poses.append(pose_host)
        self.tick += 1
        self.last_stats = stats
        return stats

    def clean_points(self, depth, semantic, pose) -> None:
        """Backward ghost-removal replay (reference cleanPoints)."""
        self._refresh_counts()
        _, depth, semantic, pose = self._to_device(None, depth, semantic, pose)
        with self.stopwatch.time("Clean Points"):
            self._smap = _clean_step(self._smap, depth, semantic, pose,
                                     self.cam, self.params)
        # _clean_step compacts, so tail == live afterwards
        self._pending_dropped = []
        self._pending_active = []
        self._cached_tail = self._cached_count = int(self._smap.count)
        self._since_sync = 0

    # -- persistence --------------------------------------------------------

    def save_map(self, path: str, start_id: int = 0, end_id: int = 0) -> None:
        save_map(self.smap, path, start_id, end_id)  # property compacts

    def load_map(self, path: str) -> tuple[int, int]:
        smap, start_id, end_id = load_map(path, self.device)
        cap = self.map_config.capacity
        while smap.capacity > cap * self.map_config.watermark:
            cap = int(cap * self.map_config.growth_factor)
        self._smap = resize_map(smap, self.map_config.rounded_capacity(cap))
        self._refresh_counts()
        self.tick = end_id + 1
        self.ref_frame_set = True
        return start_id, end_id
