"""Per-stage wall-clock profiling (counterpart of
surfelmapping_tpu/utils/stopwatch.py; the reference's Stopwatch TICK/TOCK,
src/Utils/Stopwatch.h:34-113).

PyTorch returns before the card finishes, so a stage time is the time to
enqueue unless ``sync`` names a CUDA device: then the context ends with
``torch.cuda.synchronize`` and the time is the stage's true latency.
"""

from __future__ import annotations

import contextlib
import time as _time
from collections import defaultdict

import torch


class Stopwatch:
    """Accumulates per-name (last_ms, total_ms, calls)."""

    def __init__(self) -> None:
        self.timings: dict[str, float] = {}
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str, sync: torch.device | str | None = None):
        t0 = _time.perf_counter()
        try:
            yield
        finally:
            if sync is not None and torch.device(sync).type == "cuda":
                torch.cuda.synchronize(sync)
            self._record(name, t0)

    def tick(self, name: str) -> None:
        """Start the named timer (the reference's TICK)."""
        self.timings[f"__start_{name}"] = _time.perf_counter()

    def tock(self, name: str) -> None:
        """Stop the named timer and record it (TOCK); without a tick, nothing."""
        start = self.timings.pop(f"__start_{name}", None)
        if start is not None:
            self._record(name, start)

    def _record(self, name: str, start: float) -> None:
        ms = (_time.perf_counter() - start) * 1000.0
        self.timings[name] = ms
        self.totals[name] += ms
        self.counts[name] += 1

    def mean_ms(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return self.totals.get(name, 0.0) / c if c else 0.0

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            lines.append(
                f"{name:>24s}: last {self.timings.get(name, 0.0):8.2f} ms  "
                f"mean {self.mean_ms(name):8.2f} ms  n={self.counts[name]}"
            )
        return "\n".join(lines)
