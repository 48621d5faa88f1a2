"""The ``spade-dp4`` cell at a size a CPU test holds: two gloo ranks on the
CPU, ngf 8 at crop 64, two images per rank, pairs from a 6-frame drive at
160x96."""

from __future__ import annotations

import copy
import time

import torch

from benchmarks import harness
from benchmarks.run import run_cell
from benchmarks.tests.tiny_cells import SEED, tiny_cell

SMALL = dict(ngf=8, ndf=8, crop_size=64, z_dim=16, num_d=2, n_layers_d=2)


def tiny_spade_cell() -> harness.Cell:
    cell = harness.find_cell("spade-dp4")
    cell.config = copy.deepcopy(cell.config)
    cell.config["model"].update(SMALL)
    cell.config["gpus"] = 2
    mix = copy.deepcopy(cell.traffic)
    mix["map"].update(config=tiny_cell("fuse-explore").config, period_frames=20, frames=6)
    mix.update(load_size=71, batch_per_rank=2, warm_iterations=2)
    cell.traffic = mix
    cell.settings = dict(cell.settings, timeout_s=240)
    return cell


def run_tiny_spade(seed: int = SEED, seconds: float = 0.5, control: bool = False) -> dict:
    return run_cell("spade-dp4", seed, seconds, False, control, torch.device("cpu"),
                    cell=tiny_spade_cell(), t_process=time.perf_counter())
