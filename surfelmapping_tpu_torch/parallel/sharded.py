"""Block-sharded surfel fusion over torch.distributed ranks (counterpart of
surfelmapping_tpu/parallel/sharded.py).

The map's slots are split across the ranks of a process group: rank r owns
S = capacity / D contiguous slots, its global slot ids start at r * S, and
it keeps its own live-prefix cursor.  Every rank runs the single-card
engine's active-block machinery (ops/active.py: plan, gather, conflict,
index candidates, associate) on its own slots, with K1 (the z-buffer kernel)
resolving its local index map, and the ranks couple through THREE
image-sized collectives per frame:

  1. MIN all-reduce of the per-rank z-buffer depth keys (i32[H*W]): the
     depth test across ranks;
  2. MIN all-reduce of the per-rank winner GLOBAL ids (i32[H*W]): the
     winner, with the single-card engine's min-id tie-break;
  3. MAX all-reduce of the per-rank "pixel matched" mask (u8[H*W/2]), so
     every rank knows which valid pixels became new surfels;

plus one SUM all-reduce of the frame's stats (3 + 3D int32).  INT32_MAX
marks an empty pixel through both MINs.  The association gathers and the
fuse scatter touch only the winning rank's own slots; new surfels are dealt
round-robin by lattice rank so the shards stay balanced; removal is
tombstoned per shard as on one card.

Each rank runs the same host loop on the same frames.  Every decision the
host takes (window replay, growth, compaction) reads only all-reduced stats,
so the ranks take the same branches and meet in the same collectives.  The
dense preprocessing (K2) runs replicated on every rank.

On a card the step runs K1 and K2 through the port's CUDA kernels; on CPU
tensors it runs their plain versions (the wrappers decide by the tensor's
device; there is no path from one to the other).
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import TYPE_CHECKING

import numpy as np
import torch

from ..config import CameraIntrinsics, PipelineParams
from ..ops.active import (
    INT32_MAX,
    associate_active,
    conflict_active,
    fuse_append_shard,
    gather_active,
    index_candidates,
    plan_active_blocks,
    valid_prefix,
)
from ..ops.fusion import compact
from ..ops.preprocess import preprocess_frame, remove_movings
from ..ops.transforms import compose, full_precision_matmul, invert_se3
from ..ops.zbuf import zbuffer_argmin
from ..pipeline import resolve_device, stage_frame
from ..surfels import COLUMNS, SurfelMap, empty_map, resize_map, save_map

if TYPE_CHECKING:
    from .distributed import Comm


# ---------------------------------------------------------------------------
# Sharded state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedMapState:
    """One rank's shard: its own SurfelMap of S slots (plus the spare slot)
    whose ``count`` is the shard's cursor, its ``rank`` and the ``world``
    size.  Local slot i is global slot rank * S + i."""

    smap: SurfelMap
    rank: int
    world: int

    @property
    def shard_slots(self) -> int:
        return self.smap.capacity

    @property
    def capacity(self) -> int:
        return self.smap.capacity * self.world

    def clone(self) -> "ShardedMapState":
        """A copy by value (the replay checkpoint: the step writes in place)."""
        return ShardedMapState(self.smap.clone(), self.rank, self.world)


def empty_sharded(capacity: int, n_ranks: int, rank: int,
                  device: torch.device | str) -> ShardedMapState:
    """Rank ``rank``'s empty shard of a ``capacity``-slot map over n_ranks."""
    if capacity % n_ranks:
        raise ValueError("capacity must divide evenly across ranks")
    if capacity >= INT32_MAX:
        raise ValueError(f"capacity {capacity}: global ids must stay below INT32_MAX, "
                         "the empty marker of the winner all-reduce")
    return ShardedMapState(empty_map(capacity // n_ranks, device), rank, n_ranks)


def gather_sharded_map(states: list[ShardedMapState]) -> SurfelMap:
    """Concatenate the live rows (conf > 0) of every shard's prefix, in rank
    order, into one compacted map (rendering, checkpoints).  ``states`` is
    every rank's shard, as distributed.allgather_state returns them."""
    parts = {k: [] for k in COLUMNS}
    for st in states:
        n = int(st.smap.count)
        keep = st.smap.column("conf")[:n] > 0.0
        for k in COLUMNS:
            parts[k].append(st.smap.column(k)[:n][keep])
    cols = {k: torch.cat(v + [v[0].new_zeros(1)]) for k, v in parts.items()}
    total = cols["px"].shape[0] - 1
    return SurfelMap(**cols, count=torch.tensor(total, dtype=torch.int32,
                                                device=cols["px"].device))


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardStats:
    """A frame's stats, all-reduced (equal on every rank): one int32 vector
    [removed, merged, dropped, active_per_rank[D], tail_per_rank[D],
    live_per_rank[D]] and the replicated count of new records."""

    vec: torch.Tensor
    new: torch.Tensor
    world: int

    def per_rank(self, i: int) -> torch.Tensor:
        D = self.world
        return self.vec[3 + i * D: 3 + (i + 1) * D]

    def as_dict(self) -> dict[str, torch.Tensor]:
        active, tail, live = (self.per_rank(i) for i in range(3))
        return {"count": live.sum(), "removed": self.vec[0], "new": self.new,
                "merged": self.vec[1], "dropped": self.vec[2], "active_blocks": active.max(),
                "active_per_dev": active, "tail_per_dev": tail, "live_per_dev": live}

    def row(self) -> torch.Tensor:
        """[peak_active, dropped, tail_per_rank..., live_per_rank...], the
        row the host's sync reads."""
        return torch.cat([self.per_rank(0).max()[None], self.vec[2:3],
                          self.per_rank(1), self.per_rank(2)])


def _shard_body(state: ShardedMapState, depth_m, rgb, semantic, pose, time: float,
                cam: CameraIntrinsics, params: PipelineParams, comm: "Comm",
                active_blocks: int, block_size: int):
    p = params
    icam = cam.scaled(p.index_factor)
    num_pix = icam.height * icam.width
    local = state.smap
    S, B = local.capacity, block_size
    G = S // B
    me, D = state.rank, state.world
    gid0 = me * S
    T_inv = invert_se3(pose)

    # ---- 1. local active-block plan + gather (the single-card ops) -------
    blk, n_active = plan_active_blocks(local, T_inv, cam, p, active_blocks, B)
    at = gather_active(local, blk, B)

    # ---- 2. conflict (local; the id > 0 exemption on the global id) -----
    at, removed = conflict_active(
        at, depth_m, semantic, T_inv, cam, p,
        min_depth=p.near_clip, max_depth=p.far_clip,
        fuse_thresh=p.fuse_thresh_factor, is_clean=False, gid_offset=gid0,
    )

    # ---- 3. distributed index map (collectives 1 and 2) ------------------
    # K1 resolves the local (key, candidate) minimum; the table's global ids
    # rise with the candidate index (blocks gathered ascending), so K1's
    # min-index tie-break is the min-global-id tie-break after translation.
    zkey, fpix = index_candidates(at, T_inv, time, cam, p, gid_offset=gid0)
    zbuf_local, idx_local = zbuffer_argmin(zkey, fpix, num_pix,
                                           valid_prefix(n_active, blk.shape[0], B))
    zbuf = comm.all_reduce(zbuf_local.contiguous(), "min")
    win = (zbuf_local == zbuf) & (zbuf_local != INT32_MAX)
    safe_idx = torch.clamp(idx_local, 0, at.size - 1).long()
    gid_win = torch.where(win, (at.global_id[safe_idx] + gid0).to(torch.int32), INT32_MAX)
    id_flat = comm.all_reduce(gid_win, "min")

    # ---- 4. association against the gathered active table ---------------
    # a winner on this rank maps to its active-table slot through the
    # inverse block map, so the per-pixel gathers stay at table scale
    mine = (id_flat >= gid0) & (id_flat < gid0 + S)
    g_local = torch.where(mine, id_flat - gid0, 0).long()
    blk_inv = torch.full((G + 1,), -1, dtype=torch.int64, device=blk.device)
    blk_inv.index_copy_(0, blk, torch.arange(blk.shape[0], device=blk.device))
    bpos = blk_inv[g_local // B]
    aslot = bpos * B + g_local % B
    # a winner was a candidate, so its block is gathered; guard anyway
    local_idx = torch.where(mine & (bpos >= 0), aslot, -1).view(icam.height, icam.width)
    assoc = associate_active(depth_m, rgb, semantic, local_idx, at, pose, T_inv, time, cam, p)

    # ---- 5. which pixels matched on any rank (collective 3) -------------
    matched_mine = assoc.mark >= 0
    matched_any = comm.all_reduce(matched_mine.to(torch.uint8), "max") > 0
    # a pixel valid here but matched on another rank must not append
    mark = torch.where(matched_mine, assoc.mark,
                       torch.where((assoc.mark == -1) & matched_any, -10, assoc.mark))
    assoc = dataclasses.replace(assoc, mark=mark)

    # ---- 6. block writeback + one merge/append scatter per column -------
    local, dropped = fuse_append_shard(local, at, assoc, D, me)

    vec = torch.zeros(3 + 3 * D, dtype=torch.int32, device=blk.device)
    vec[:3] = torch.stack([removed, matched_mine.sum(dtype=torch.int32), dropped])
    vec[3 + me::D] = torch.stack([n_active, local.count,
                                  (local.column("conf") > 0.0).sum(dtype=torch.int32)])
    stats = ShardStats(comm.all_reduce(vec, "sum"), (mark == -1).sum(dtype=torch.int32), D)
    return ShardedMapState(local, me, D), stats


def make_sharded_step(comm: "Comm", cam: CameraIntrinsics, params: PipelineParams,
                      active_blocks: int = 64, block_size: int = 2048):
    """The block-sharded fusion step of this rank.

    Signature: (state, depth_raw, rgb f32[H,W,3], semantic i32[H,W], pose,
    last_depth, last_pose, time) -> (state, last_depth', ShardStats).
    ``active_blocks``/``block_size`` bound each rank's LOCAL working set
    (the shard's slots must divide by block_size).  The shard's columns are
    updated in place."""

    def step(state, depth_raw, rgb, semantic, pose, last_depth, last_pose, time):
        # the dense preprocessing (K2) runs replicated on every rank
        depth_f = preprocess_frame(depth_raw, semantic, cam, params)
        T_c2l = compose(invert_se3(last_pose), pose)
        depth_m = remove_movings(depth_f, semantic, last_depth, T_c2l, cam, params)
        state, stats = _shard_body(state, depth_m, rgb, semantic, pose, time, cam, params,
                                   comm, active_blocks, block_size)
        return state, depth_f, stats

    return step


# ---------------------------------------------------------------------------
# Per-shard compaction and growth
# ---------------------------------------------------------------------------

def compact_shard(state: ShardedMapState) -> ShardedMapState:
    """Order-preserving compaction of this rank's shard (live rows of the
    prefix to the front): the per-shard form of ops/fusion.py:compact, so
    the global surfel set and each shard's order match a never-tombstoned
    run."""
    return ShardedMapState(compact(state.smap), state.rank, state.world)


def resize_sharded(state: ShardedMapState, new_capacity: int) -> ShardedMapState:
    """Grow this rank's shard to new_capacity / D slots, keeping its live
    prefix."""
    if new_capacity % state.world:
        raise ValueError("capacity must divide evenly across ranks")
    S_new = new_capacity // state.world
    if S_new < state.shard_slots:
        raise ValueError("sharded map never shrinks")
    if new_capacity >= INT32_MAX:
        raise ValueError(f"capacity {new_capacity} reaches INT32_MAX")
    return ShardedMapState(resize_map(state.smap, S_new), state.rank, state.world)


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------

class ShardedMapper:
    """This rank's host driver of the block-sharded engine, with the
    single-card mapper's guarantees: pre-growth so the append can never drop
    a surfel, a verify of each window with replay when the active-block
    budget truncated a frame, and deferred compaction.

    Every rank of ``comm`` constructs one and feeds it the same frames.
    ``count``, ``smap``, ``save_map`` and ``active_table`` are collective:
    every rank calls them together.  ``device=None`` runs on the card (an
    NCCL rank's current card) and raises without one."""

    def __init__(self, comm: "Comm", cam: CameraIntrinsics,
                 params: PipelineParams | None = None, capacity: int = 1 << 20,
                 active_blocks: int = 64, block_size: int = 1024, sync_every: int = 8,
                 compact_dead_frac: float = 0.25, device: torch.device | str | None = None):
        self.device = resolve_device(device)
        full_precision_matmul()
        self.comm = comm
        self.cam = cam
        self.params = params or PipelineParams()
        self.n_ranks = comm.size
        self.block_size = block_size
        self.active_blocks = active_blocks
        self.sync_every = max(1, min(sync_every, 128))
        self.compact_dead_frac = compact_dead_frac
        self.state = empty_sharded(self._round_cap(capacity), self.n_ranks, comm.rank,
                                   self.device)
        self.events = {"replays": 0, "budget_growths": 0, "compacts": 0,
                       "capacity_growths": 0}
        self.last_depth = torch.zeros(cam.shape, dtype=torch.float32, device=self.device)
        self.last_pose = torch.eye(4, dtype=torch.float32, device=self.device)
        self.tick = 0
        self.ref_frame_set = False
        self._clear()

    def _clear(self) -> None:
        self._window: list = []
        self._chk: ShardedMapState | None = None
        self._pending: list[ShardStats] = []
        self._since_sync = 0
        # per-rank cursors (tombstones included) and live counts, read at
        # each sync; between syncs _tails advances by the worst case
        self._tails = np.zeros(self.n_ranks, np.int64)
        self._live = np.zeros(self.n_ranks, np.int64)

    # -- capacity bookkeeping ---------------------------------------------

    def _round_cap(self, cap: int) -> int:
        quantum = self.n_ranks * self.block_size
        return -(-cap // quantum) * quantum

    @property
    def capacity(self) -> int:
        return self.state.capacity

    @property
    def shard_slots(self) -> int:
        return self.state.shard_slots

    @property
    def _eff_blocks(self) -> int:
        return min(self.active_blocks, self.shard_slots // self.block_size)

    def _per_frame(self) -> int:
        """The most slots one frame can append to one shard: round-robin
        dealing bounds a shard's share of a frame at ceil(Vp / D) + 1."""
        Vp = (self.cam.height * self.cam.width) // 2
        return -(-Vp // self.n_ranks) + 1

    def _maybe_grow(self, frames_ahead: int) -> None:
        """Pre-grow so the worst-case ingest of the unverified window fits
        in EVERY shard."""
        need = int(self._tails.max()) + frames_ahead * self._per_frame()
        if need <= self.shard_slots:
            return
        self._sync()
        need = int(self._tails.max()) + frames_ahead * self._per_frame()
        new_slots = self.shard_slots
        while need > new_slots:
            new_slots *= 2
        if new_slots > self.shard_slots:
            self.events["capacity_growths"] += 1
            self.state = resize_sharded(self.state, new_slots * self.n_ranks)

    # -- sync / verify / repair -------------------------------------------

    def _read_pending(self) -> np.ndarray:
        """ONE stacked device-to-host read of the pending frames' rows
        [peak_active, dropped, tail_per_rank..., live_per_rank...]; an empty
        window gives a (0, 2 + 2D) array (the JAX mapper's raises there)."""
        if not self._pending:
            return np.zeros((0, 2 + 2 * self.n_ranks), np.int64)
        return torch.stack([s.row() for s in self._pending]).cpu().numpy().astype(np.int64)

    def _sync(self) -> None:
        """Drain the pending stats; verify the window (budget truncation,
        drops) and repair by replay with a grown budget, as the single-card
        mapper does.  The replay starts from a copy of the checkpoint, so a
        further round can replay again."""
        rows = None
        for _ in range(32):
            if not self._window:
                break
            rows = self._read_pending()
            peaks = rows[:, 0]
            if all(a <= eff for a, (_, eff) in zip(peaks, self._window)):
                break
            self.events["replays"] += 1
            while self.active_blocks < int(peaks.max()):
                self.active_blocks *= 2
                self.events["budget_growths"] += 1
            state, last_depth = self._chk.clone(), None
            for i, (inp, _) in enumerate(self._window):
                eff = self._eff_blocks
                state, last_depth, self._pending[i] = self._step(state, inp, eff)
                self._window[i] = (inp, eff)
            self.state, self.last_depth = state, last_depth
            rows = None
        else:
            raise RuntimeError("sharded budget repair did not converge (bug)")

        if self._pending:
            if rows is None:
                rows = self._read_pending()
            dropped = int(rows[:, 1].sum())
            if dropped:
                raise RuntimeError(f"sharded append dropped {dropped} surfels — "
                                   "pre-growth margin violated (bug)")
            D = self.n_ranks
            self._tails = rows[-1, 2:2 + D].copy()
            self._live = rows[-1, 2 + D:2 + 2 * D].copy()
            if self._tails.sum() - self._live.sum() > self.compact_dead_frac * self.capacity:
                self.events["compacts"] += 1
                self.state = compact_shard(self.state)
                self._tails = self._live.copy()
        self._pending, self._window, self._chk = [], [], None
        self._since_sync = 0

    def _step(self, state, inp, eff: int):
        step = make_sharded_step(self.comm, self.cam, self.params, eff, self.block_size)
        return step(state, *inp)

    @property
    def count(self) -> int:
        """Live surfels over every rank (syncs; every rank calls it)."""
        self._sync()
        return int(self._live.sum())

    @property
    def tails(self) -> np.ndarray:
        """Each rank's cursor, tombstones included, as of the last sync."""
        return self._tails

    @property
    def live(self) -> int:
        """Live surfels over every rank as of the last sync.  It does not
        sync, so one rank alone may read it: a sync on some ranks only
        would split the ranks' windows, replays and growth."""
        return int(self._live.sum())

    def smap(self) -> SurfelMap:
        """The gathered, compacted map of every shard (collective)."""
        from .distributed import allgather_state

        self._sync()
        return gather_sharded_map(allgather_state(self.state, self.comm))

    def save_map(self, path: str, start_id: int = 0, end_id: int = 0) -> None:
        """Write the reference binary map of every shard's live surfels: the
        bytes a single-card run writes for the same surfel set, the order
        interleaved by shard (collective; rank 0 writes)."""
        m = self.smap()
        if self.comm.rank == 0:
            save_map(m, path, start_id, end_id)

    def reset(self) -> None:
        """Clear the model and keep the reference frame (the counterpart of
        SurfelMapper.reset)."""
        self.state = empty_sharded(self.capacity, self.n_ranks, self.comm.rank, self.device)
        self.tick = 0
        self._clear()

    def active_table(self, pose):
        """The in-frustum active table at ``pose`` (camera-to-world) for
        ICP/BA: the shards are gathered (collective) into one map, which is
        planned and gathered as on one card.  One cross-rank gather per
        call."""
        from ..ops.active import gather_active as _gather

        pose = stage_frame(self.device, None, None, None, pose)[3]
        smap = self.smap()
        bs = self.block_size
        cap = -(-max(int(smap.count), 1) // bs) * bs
        smap = resize_map(smap, cap)
        blk, _ = plan_active_blocks(smap, invert_se3(pose), self.cam, self.params,
                                    cap // bs, bs)
        return _gather(smap, blk, bs)

    # -- frame ingestion ---------------------------------------------------

    def stage_frame(self, rgb, depth, semantic, pose):
        """Stage a frame's arrays on the rank's device (pipeline.stage_frame)."""
        return stage_frame(self.device, rgb, depth, semantic, pose)

    def process_frame(self, rgb, depth, semantic, pose) -> dict:
        """Ingest one frame, with the single-card SurfelMapper's frame-0
        seeding contract: frame 0 only seeds the last depth and pose.
        Returns the frame's stats (device tensors, equal on every rank)."""
        rgb, depth, semantic, pose = stage_frame(self.device, rgb, depth, semantic, pose)
        if not self.ref_frame_set:
            self.last_depth = preprocess_frame(depth, semantic, self.cam, self.params)
            self.last_pose = pose
            self.ref_frame_set = True
            self.tick += 1
            return {"first_frame": True}

        self._maybe_grow(self.sync_every - self._since_sync + 1)
        if not self._window:
            # the step writes the shard in place: keep the pre-window state
            # by VALUE so a budget repair can replay
            self._chk = self.state.clone()
        eff = self._eff_blocks
        inp = (depth, rgb, semantic, pose, self.last_depth, self.last_pose, float(self.tick))
        self.state, self.last_depth, stats = self._step(self.state, inp, eff)
        self._window.append((inp, eff))
        self._pending.append(stats)
        self.last_pose = pose
        self.tick += 1
        self._tails = self._tails + self._per_frame()
        self._since_sync += 1
        if self._since_sync >= self.sync_every:
            self._sync()
        return stats.as_dict()


# ---------------------------------------------------------------------------
# Dry run
# ---------------------------------------------------------------------------

def _dryrun_rank(device: str) -> int:
    """One rank of :func:`dryrun`: two frames of a 128x64 synthetic scene."""
    from ..io.synthetic import SyntheticScene, tiny_cam
    from .distributed import initialize, shutdown

    comm = initialize()
    try:
        dev = resolve_device(device)  # an NCCL rank's own card
        if dev.type == "cpu":
            torch.set_num_threads(1)
        D = comm.size
        cam, params = tiny_cam(128, 64), PipelineParams()
        cap = 1 << 14
        block = (cap // D) // 2 or 1
        state = empty_sharded(cap, D, comm.rank, dev)
        step = make_sharded_step(comm, cam, params, active_blocks=4, block_size=block)
        scene = SyntheticScene(cam)
        last_depth = torch.zeros(cam.shape, dtype=torch.float32, device=dev)
        last_pose = stage_frame(dev, None, None, None, scene.pose(0))[3]
        for i in range(1, 3):
            rgb, depth, sem, pose = stage_frame(dev, *scene.frame(i))
            state, last_depth, stats = step(state, depth, rgb, sem, pose, last_depth,
                                            last_pose, float(i))
            last_pose = pose
        total = int(stats.as_dict()["count"])
        if total <= 0:
            raise RuntimeError("sharded step produced an empty map")
        print(f"rank {comm.rank}: dryrun count={total} on {dev}", flush=True)
    finally:
        shutdown()
    return 0


def dryrun(n_ranks: int, device: torch.device | str | None = None,
           timeout: float = 300.0) -> None:
    """Run two frames of the sharded step in ``n_ranks`` ranks (the
    counterpart of the JAX package's dryrun over an n-device mesh): NCCL
    ranks, one per card, unless ``device`` is the CPU, which runs gloo CPU
    ranks.  Raises without CUDA or with fewer cards than ranks (unless
    asked for the CPU), if a rank fails, or if the map stays empty."""
    from .distributed import python_module, spawn_cpu_processes, spawn_ranks

    dev = resolve_device(device)
    cmd = python_module(f"{__package__}.sharded", "--device", dev.type)
    if dev.type == "cpu":
        spawn_cpu_processes(cmd, n_ranks, timeout)
        return
    if torch.cuda.device_count() < n_ranks:
        raise RuntimeError(f"dryrun({n_ranks}) needs {n_ranks} CUDA cards, found "
                           f"{torch.cuda.device_count()}; pass device='cpu'")
    spawn_ranks(cmd, n_ranks, "nccl", timeout)


def main(argv=None) -> int:
    """``python -m surfelmapping_tpu_torch.parallel.sharded [--ranks N]
    [--device cpu] [--timeout S]``: :func:`dryrun`.  In a rank of the job
    (``RANK`` set) it is that rank's program."""
    import argparse

    ap = argparse.ArgumentParser(description=dryrun.__doc__)
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--device", default=None, help="cpu, or the CUDA cards (the default)")
    ap.add_argument("--timeout", type=float, default=300.0)
    a = ap.parse_args(argv)
    if "RANK" in os.environ:
        return _dryrun_rank(a.device)
    dryrun(a.ranks, a.device, a.timeout)
    print(f"dryrun: {a.ranks} ranks ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
