"""Frozen copy of ``surfelmapping_tpu_torch/surfels.py`` at commit dd68e64,
trimmed to what the benchmark's reference needs.  The planar surfel map: one
column per attribute, capacity + 1 slots (the last a write-only spare), an
int32 cursor.
"""

from __future__ import annotations

import dataclasses

import torch


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


def empty_map(capacity: int, device: torch.device | str) -> SurfelMap:
    """An all-zero map with ``capacity`` slots (+1 spare) on ``device``."""
    cols = {
        k: torch.zeros(capacity + 1,
                       dtype=torch.int32 if k == "colorsem" else torch.float32,
                       device=device)
        for k in COLUMNS
    }
    return SurfelMap(**cols, count=torch.zeros((), dtype=torch.int32, device=device))


# ---------------------------------------------------------------------------
# Reference-layout (12 f32 / surfel) packing, checkpoint IO
# ---------------------------------------------------------------------------
