"""Debug inspection of maps and images (counterpart of
surfelmapping_tpu/utils/checker.py): the test oracle the reference built as
``Checker`` (src/Utils/Checker.{h,cpp}: download textures/VBOs, print random
or id-addressed samples, range checks, histograms).  The "download" is a
copy of the port's map columns to the host."""

from __future__ import annotations

import numpy as np
import torch

from ..surfels import SurfelMap


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def sample_surfels(smap: SurfelMap, ids=None, n: int = 5, seed: int = 0) -> str:
    """Pretty-print chosen (or random) live surfels, one per line."""
    count = int(smap.count)
    if count == 0:
        return "<empty map>"
    if ids is None:
        rng = np.random.default_rng(seed)
        ids = rng.integers(0, count, size=min(n, count))
    pos, nrm = _host(smap.pos()), _host(smap.normal())
    rgb, sem = _host(smap.rgb()), _host(smap.sem())
    conf, rad = _host(smap.column("conf")), _host(smap.column("radius"))
    it, lt = _host(smap.column("init_t")), _host(smap.column("last_t"))
    lines = []
    for i in ids:
        lines.append(
            f"[{i:8d}] p=({pos[i,0]:8.3f},{pos[i,1]:8.3f},{pos[i,2]:8.3f}) "
            f"c={conf[i]:6.2f} rgb=({rgb[i,0]:.2f},{rgb[i,1]:.2f},{rgb[i,2]:.2f}) "
            f"sem={sem[i]:2d} n=({nrm[i,0]:6.3f},{nrm[i,1]:6.3f},{nrm[i,2]:6.3f}) "
            f"r={rad[i]:.4f} t=[{it[i]:.0f},{lt[i]:.0f}]"
        )
    return "\n".join(lines)


def check_map_invariants(smap: SurfelMap) -> list[str]:
    """Range/consistency checks over the live prefix; returns violations
    (the assertions the reference's checkDataTypes/checkBackMapping printouts
    verified by eye, test_main.cpp:37-125)."""
    problems = []
    count = int(smap.count)
    cap = smap.capacity
    if not (0 <= count <= cap):
        problems.append(f"count {count} outside [0, {cap}]")
        return problems
    conf = _host(smap.column("conf"))
    if count and (conf[:count] <= 0).any():
        problems.append(
            f"{(conf[:count] <= 0).sum()} live surfels with conf <= 0 "
            "(compaction must remove them)"
        )
    if (conf[count:] != 0).any():
        problems.append("non-zero confidence beyond live prefix")
    if count:
        norms = np.linalg.norm(_host(smap.normal())[:count], axis=-1)
        bad = np.abs(norms - 1.0) > 1e-3
        if bad.any():
            problems.append(f"{bad.sum()} live surfels with non-unit normals")
        rad = _host(smap.column("radius"))[:count]
        if (rad <= 0).any():
            problems.append(f"{(rad <= 0).sum()} live surfels with radius <= 0")
        if not np.isfinite(_host(smap.pos())[:count]).all():
            problems.append("non-finite surfel positions")
    return problems


def histogram(img, bins: int = 10) -> str:
    """Text histogram of an image/array (Checker::histogramTexturef)."""
    a = (_host(img) if isinstance(img, torch.Tensor) else np.asarray(img)).ravel()
    a = a[np.isfinite(a)]
    if a.size == 0:
        return "<no finite values>"
    hist, edges = np.histogram(a, bins=bins)
    width = 40
    top = hist.max() or 1
    lines = [
        f"[{edges[i]:10.3f},{edges[i+1]:10.3f}) {'#' * int(width * hist[i] / top):<40s} {hist[i]}"
        for i in range(bins)
    ]
    return "\n".join(lines)
