"""Carry state between the JAX package and the port, through numpy.

The system has no weights: what carries over is the surfel map, the
mapper's running state (last filtered depth, last pose, tick), an active
table and a BA window.  Columns are read out of the JAX dataclasses with
``np.asarray``; a float32 ``colorsem`` column becomes the port's int32 bits
by ``.view``, never by arithmetic, so subnormal colors survive.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ba import BAWindow
from .ops.active import ActiveTable
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


def table_from_numpy(cols: dict[str, np.ndarray], device: torch.device | str) -> ActiveTable:
    """The port's ActiveTable from numpy columns (a JAX ActiveTable's fields;
    colorsem as float32 or int32 bits, ids widened to int64)."""
    out = {}
    for f in dataclasses.fields(ActiveTable):
        a = np.array(cols[f.name], copy=True)
        if f.name == "colorsem":
            a = a.view(np.int32)
        elif f.name in ("global_id", "blk"):
            a = a.astype(np.int64)
        elif f.name != "slot_valid":
            a = a.astype(np.float32, copy=False)
        out[f.name] = torch.from_numpy(a).to(device)
    return ActiveTable(**out)


_WINDOW_ARRAYS = ("poses", "v_c", "n_c", "valid", "odo", "prior_H", "prior_b", "prior_T0")


def window_from_numpy(arrays: dict[str, np.ndarray], n_valid: int,
                      device: torch.device | str) -> BAWindow:
    """The port's BAWindow from numpy arrays (a JAX BAWindow's fields)."""
    return BAWindow(**{k: torch.from_numpy(np.array(arrays[k], copy=True)).to(device)
                       for k in _WINDOW_ARRAYS}, n_valid=int(n_valid))


def window_to_numpy(win: BAWindow) -> tuple[dict[str, np.ndarray], int]:
    """(arrays, n_valid) of a BAWindow, the JAX BAWindow's fields and dtypes
    (n_valid becomes int32 there)."""
    return {k: getattr(win, k).cpu().numpy() for k in _WINDOW_ARRAYS}, win.n_valid
