"""The device-resident surfel map: planar struct-of-arrays columns
(counterpart of surfelmapping_tpu/surfels.py:45-225).

One 1-D tensor per scalar attribute, ``capacity + 1`` slots long.  The last
slot is a write-only **spare**: every scatter that JAX expressed with
``mode="drop"`` (out-of-range index = no write) sends its dropped rows to
index ``capacity`` instead, because torch raises on an out-of-range index.
Nothing ever reads the spare; ``capacity`` and every view a caller gets
exclude it.

``colorsem`` holds the packed (sem<<24 | r<<16 | g<<8 | b) value as int32
bits (ops/colors.py): never as a float, so subnormal colors survive.
``count`` is the allocation cursor, a 0-d int32 tensor on the map's device;
reading it on the host is a sync, which the mapper does once per window.
Slots below ``count`` with conf <= 0 are tombstones awaiting compaction.

The checkpoint format is byte-compatible with the reference's
``downloadMap``/``uploadMap``: [u32 count][i32 start_id][i32 end_id]
[count x 12 f32], record layout src/Config.cpp:16-31
(src/GlobalModel.cpp:901-1011).
"""

from __future__ import annotations

import dataclasses
from typing import BinaryIO

import numpy as np
import torch
import torch.nn.functional as F

from .ops.colors import decode_color, encode_color

# map columns in record-independent order; colorsem is int32, the rest f32
COLUMNS = ("px", "py", "pz", "conf", "colorsem", "init_t", "last_t",
           "nx", "ny", "nz", "radius")


@dataclasses.dataclass
class SurfelMap:
    """Planar surfel storage: capacity N (+1 spare slot), cursor ``count``.

      px, py, pz: world position (f32)
      conf:       confidence (vec4#0.w of the reference record)
      colorsem:   packed color + class, int32 bits
      init_t:     first-seen tick (vec4#1.z)
      last_t:     last-fused tick (vec4#1.w)
      nx, ny, nz: world unit normal
      radius:     surfel disc radius (m)
      count:      i32[] allocation cursor (live prefix incl. tombstones)
    """

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    conf: torch.Tensor
    colorsem: torch.Tensor
    init_t: torch.Tensor
    last_t: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor
    radius: torch.Tensor
    count: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.px.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.px.device

    def column(self, name: str) -> torch.Tensor:
        """The ``capacity`` real slots of a column (a view, spare excluded)."""
        return getattr(self, name)[: self.capacity]

    def live_mask(self) -> torch.Tensor:
        """bool[capacity]: True for the slots below the cursor."""
        return torch.arange(self.capacity, device=self.device) < self.count

    def clone(self) -> "SurfelMap":
        """A copy by value of every column and the cursor (the replay
        checkpoint: the fusion step updates the columns in place)."""
        return SurfelMap(**{f.name: getattr(self, f.name).clone()
                            for f in dataclasses.fields(self)})

    def to(self, device: torch.device | str) -> "SurfelMap":
        """The map on ``device`` (itself if it is already there)."""
        if self.device == torch.device(device):
            return self
        return SurfelMap(**{f.name: getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})

    # -- stacked [capacity, 3] views (cold paths: viewer, tests) ------------

    def pos(self) -> torch.Tensor:
        return torch.stack([self.column(k) for k in ("px", "py", "pz")], dim=-1)

    def normal(self) -> torch.Tensor:
        return torch.stack([self.column(k) for k in ("nx", "ny", "nz")], dim=-1)

    def rgb(self) -> torch.Tensor:
        return decode_color(self.column("colorsem"))[0]

    def sem(self) -> torch.Tensor:
        return decode_color(self.column("colorsem"))[1]


def map_from_stacked(pos, conf, rgb, sem, init_t, last_t, normal, radius,
                     count) -> SurfelMap:
    """A map from stacked (N,3) pos/rgb/normal and (N,) columns, with the
    spare slot appended (surfelmapping_tpu/surfels.py:98-110)."""
    cols = dict(px=pos[:, 0], py=pos[:, 1], pz=pos[:, 2], conf=conf,
                colorsem=encode_color(rgb, sem), init_t=init_t, last_t=last_t,
                nx=normal[:, 0], ny=normal[:, 1], nz=normal[:, 2], radius=radius)
    return SurfelMap(**{k: F.pad(v, (0, 1)) for k, v in cols.items()},
                     count=torch.as_tensor(count, dtype=torch.int32, device=pos.device))


def empty_map(capacity: int, device: torch.device | str) -> SurfelMap:
    """An all-zero map with ``capacity`` slots (+1 spare) on ``device``."""
    cols = {
        k: torch.zeros(capacity + 1,
                       dtype=torch.int32 if k == "colorsem" else torch.float32,
                       device=device)
        for k in COLUMNS
    }
    return SurfelMap(**cols, count=torch.zeros((), dtype=torch.int32, device=device))


def resize_map(m: SurfelMap, new_capacity: int) -> SurfelMap:
    """Copy a map into a larger (or equal) allocation (a host sync: reads
    the cursor to refuse a shrink below it)."""
    if new_capacity < int(m.count):
        raise ValueError("cannot shrink below live count")
    n = min(m.capacity, new_capacity)
    out = empty_map(new_capacity, m.device)
    for k in COLUMNS:
        getattr(out, k)[:n] = getattr(m, k)[:n]
    out.count = m.count.clone()
    return out


# ---------------------------------------------------------------------------
# Reference-layout (12 f32 / surfel) packing, checkpoint IO
# ---------------------------------------------------------------------------

_RECORD = ("px", "py", "pz", "conf", "colorsem", None, "init_t", "last_t",
           "nx", "ny", "nz", "radius")


def pack_records(m: SurfelMap) -> torch.Tensor:
    """Pack the map into the reference's 12-float record layout
    (src/Config.cpp:16-31): [x y z conf | packedColor mark initT lastT |
    nx ny nz radius], ``mark`` written as 0 (back_map.geom:17-23).

    Returns f32[capacity, 12]; rows >= count are zero.  Built in int32 bits
    and masked with a select, so the color bits come out exactly as stored
    (the JAX package multiplies by the live mask, surfels.py:173, which
    flushes subnormal colors to 0 on a flush-to-zero backend)."""
    zero = torch.zeros(m.capacity, dtype=torch.int32, device=m.device)
    rec = torch.stack(
        [zero if k is None else m.column(k).view(torch.int32) for k in _RECORD],
        dim=1,
    )
    live = m.live_mask()[:, None]
    return torch.where(live, rec, 0).view(torch.float32)


def unpack_records(rec: torch.Tensor, count: int) -> SurfelMap:
    """Inverse of :func:`pack_records` (f32[N,12] records -> planar map)."""
    n = rec.shape[0]
    m = empty_map(n, rec.device)
    bits = rec.contiguous().view(torch.int32)
    for j, k in enumerate(_RECORD):
        if k is not None:
            col = getattr(m, k)
            col[:n] = bits[:, j].view(col.dtype)
    m.count = torch.tensor(count, dtype=torch.int32, device=rec.device)
    return m


def save_map(m: SurfelMap, path: str, start_id: int, end_id: int) -> None:
    """Write the reference's binary map format
    [u32 count][i32 start][i32 end][count*12 f32] (src/GlobalModel.cpp:901-953),
    little-endian.  Tombstoned rows (conf <= 0) are filtered out host-side,
    preserving relative order."""
    count = int(m.count)
    rec = pack_records(m)[:count].cpu().numpy()
    rec = rec[rec[:, 3] > 0.0]
    with open(path, "wb") as f:
        _write_map_stream(f, rec, start_id, end_id)


def _write_map_stream(f: BinaryIO, rec: np.ndarray, start_id: int, end_id: int) -> None:
    f.write(np.uint32(rec.shape[0]).tobytes())
    f.write(np.int32(start_id).tobytes())
    f.write(np.int32(end_id).tobytes())
    f.write(np.ascontiguousarray(rec, dtype="<f4").tobytes())


def load_map(
    path: str, device: torch.device | str, capacity: int | None = None
) -> tuple[SurfelMap, int, int]:
    """Read a reference-format map file; returns (map, start_id, end_id)
    (src/GlobalModel.cpp:955-1011)."""
    with open(path, "rb") as f:
        count = int(np.frombuffer(f.read(4), dtype="<u4")[0])
        start_id = int(np.frombuffer(f.read(4), dtype="<i4")[0])
        end_id = int(np.frombuffer(f.read(4), dtype="<i4")[0])
        rec = np.frombuffer(f.read(count * 48), dtype="<f4").reshape(count, 12)
    cap = capacity or max(1, count)
    if cap < count:
        raise ValueError(f"capacity {cap} < stored surfel count {count}")
    full = np.zeros((cap, 12), np.float32)
    full[:count] = rec
    return unpack_records(torch.from_numpy(full).to(device), count), start_id, end_id
