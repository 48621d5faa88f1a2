"""Carry state between the JAX package and the port, through numpy.

The system has no weights: what carries over is the surfel map and the
mapper's running state (last filtered depth, last pose, tick).  A map's
columns are read out of the JAX ``SurfelMap`` with ``np.asarray``; its
float32 ``colorsem`` column becomes the port's int32 bits by ``.view``,
never by arithmetic, so subnormal colors survive.
"""

from __future__ import annotations

import numpy as np
import torch

from .surfels import COLUMNS, SurfelMap, empty_map


def map_from_numpy(cols: dict[str, np.ndarray], count: int,
                   device: torch.device | str) -> SurfelMap:
    """The port's map from numpy columns of one capacity (colorsem as
    float32 or int32 bits)."""
    cap = len(cols["px"])
    m = empty_map(cap, device)
    for k in COLUMNS:
        a = np.array(cols[k], copy=True)  # writable, contiguous
        a = a.view(np.int32) if k == "colorsem" else a.astype(np.float32, copy=False)
        getattr(m, k)[:cap] = torch.from_numpy(a).to(device)
    m.count = torch.tensor(int(count), dtype=torch.int32, device=device)
    return m


def map_to_numpy(smap: SurfelMap) -> tuple[dict[str, np.ndarray], int]:
    """(columns, count) with colorsem as float32 bits, the JAX map's dtype."""
    cols = {k: smap.column(k).cpu().numpy() for k in COLUMNS}
    cols["colorsem"] = cols["colorsem"].view(np.float32)
    return cols, int(smap.count)


def mapper_state_from_numpy(mapper, cols: dict[str, np.ndarray], count: int,
                            last_depth: np.ndarray, last_pose: np.ndarray,
                            tick: int) -> None:
    """Put a mapper (surfelmapping_tpu_torch.pipeline.SurfelMapper) in the
    state another mapper left: its map, last filtered depth, last pose and
    tick.  The next frame then takes the same path on both."""
    dev = mapper.device
    mapper.smap = map_from_numpy(cols, count, dev)
    mapper.last_depth = torch.from_numpy(np.array(last_depth, np.float32)).to(dev)
    mapper.last_pose = torch.from_numpy(np.array(last_pose, np.float32)).to(dev)
    mapper.tick = int(tick)
    mapper.ref_frame_set = True
    mapper._clear_window()
    mapper._refresh_counts()
