"""The benchmark's cells at a size a CPU test holds: a 160x96 camera, a
small map and sync window, a 20-frame street period."""

from __future__ import annotations

import copy
import time

import torch

from benchmarks import harness
from benchmarks.run import run_cell

SEED = 2_300_000_017  # more than 31 bits, as a run's seed may be


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.find_cell(name)
    c = copy.deepcopy(cell.config)
    c["camera"] = {"fx": 100.0, "fy": 100.0, "cx": 80.0, "cy": 48.0, "width": 160, "height": 96}
    c["map"] = {"capacity": 1 << 15, "active_blocks": 4, "freeze_active_budget": True}
    c["sync_every"] = 2
    c["scene"]["slot_m"] = 4.0
    c["scene"]["boxes"][0]["per_side"] = 2
    c["scene"]["boxes"][1]["per_side"] = 1
    cell.config = c
    t = copy.deepcopy(cell.traffic)
    if cell.settings["driver"] == "fuse":
        t.update(period_frames=20, prefix_frames=6, lap_frames=6, trace_from_frame=1,
                 trace_frames=3)
    else:
        t["map"].update(period_frames=20, frames=14)
        t.update(warm_views=2, check_views=2, check_within=3, trace_after_views=1,
                 trace_views=2, start_views=1)
    cell.traffic = t
    return cell


def run_tiny(name: str, seed: int = SEED, seconds: float = 1.5, control: bool = False) -> dict:
    return run_cell(name, seed, seconds, False, control, torch.device("cpu"),
                    cell=tiny_cell(name), t_process=time.perf_counter())
