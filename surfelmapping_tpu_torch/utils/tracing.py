"""Profiler integration on ``torch.profiler`` (counterpart of
surfelmapping_tpu/utils/tracing.py, which wraps ``jax.profiler``).

Usage:
    with trace_to("/tmp/trace"):            # open in Perfetto / chrome://tracing
        mapper.process_frame(...)

    with annotate("fusion"):                # named range inside a trace
        ...
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace_to(logdir: str):
    """Profile the block (the host, and every CUDA card when there is one)
    and write a Chrome/Perfetto trace ``trace_<time>_<pid>.json`` into
    ``logdir``.  Yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    name = f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"
    prof.export_chrome_trace(os.path.join(logdir, name))


def annotate(name: str):
    """Named range annotation (shows up in profiler timelines)."""
    return record_function(name)


def device_memory_stats() -> dict:
    """Per-card memory use, for the GUI capacity-overlay analogue
    (build_map.cpp:204, GUI::drawCapacity): PyTorch's allocated and
    reserved bytes, and the card's free and total bytes.  Empty without a
    CUDA card."""
    stats = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "bytes_reserved": s.get("reserved_bytes.all.current", 0),
            "bytes_free": free,
            "bytes_limit": total,
        }
    return stats
