"""The port's spans and counters, and its torch.profiler integration
(counterpart of surfelmapping_tpu/utils/tracing.py, which wraps
``jax.profiler``).

A span times one step of a frame or a view on the host's clock
(``time.perf_counter_ns``); a counter counts an event where it happens.
Both record only while tracing is on: after :func:`enable` (the CLIs'
``--profile``), or while a torch.profiler records.  Off, :func:`span`
returns one shared object that does nothing, so a span site on the hot
path costs one flag check.

The spans of one frame or view share a root id: the mapper's tick for a
frame (``fuse.frame``), a counter of the recorder for a view
(``render.view``).  A blocking device->host read goes through
:func:`read_back`, which times it as a ``wait`` span: the time the host
spent waiting for the card, wherever it happened.  The recorder keeps the
last :data:`RING` spans and counts in memory (:func:`records`), and
:func:`summary` tabulates them per name.  Under a profiler each span also
opens a ``record_function`` range of its own name, so the spans sit in the
same trace as the kernels; :func:`epoch_ns` puts a span's times on the
trace's clock (Unix-epoch ns, as Kineto's ``trace_start_ns``).

Usage:
    tracing.enable()
    with tracing.span("fuse.frame", root_id=tick):
        n = tracing.read_back(count)        # timed as a wait
    tracing.count("render.budget_retries")
    print(tracing.summary())

    with trace_to("/tmp/trace"):            # open in Perfetto / chrome://tracing
        mapper.process_frame(...)

Spans nest as one thread's calls do; the recorder is the process's own.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

RING = 1 << 16  # spans and counts kept
WAIT = "wait"

Record = collections.namedtuple(
    "Record", "name start_ns end_ns span_id parent_id root_id n")
Record.__doc__ = """One span (``n`` None) or count (``n`` events, at
``start_ns == end_ns``, ``span_id`` -1).  ``parent_id`` is -1 at a root."""

_enabled = False
_ring: collections.deque = collections.deque(maxlen=RING)
_open: list = []  # the open spans, innermost last
_span_ids = itertools.count()
_root_ids = itertools.count()
# one reading of both clocks: perf_counter_ns -> Unix-epoch ns
_CLOCK = (time.perf_counter_ns(), time.time_ns())


def enable(on: bool = True) -> None:
    """Record spans and counts from now on, from an empty ring (``False``:
    only under a profiler again)."""
    global _enabled
    if on:
        _ring.clear()
    _enabled = on


class _Off:
    """The span of tracing off: enters and leaves, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "root", "id", "parent", "t0", "rf")

    def __init__(self, name: str, root_id: int | None):
        self.name, self.root = name, root_id

    def __enter__(self):
        outer = _open[-1] if _open else None
        self.id = next(_span_ids)
        self.parent = -1 if outer is None else outer.id
        if self.root is None:
            self.root = next(_root_ids) if outer is None else outer.root
        _open.append(self)
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _open.pop()
        _ring.append((self.name, self.t0, t1, self.id, self.parent, self.root, None))
        return False


def span(name: str, root_id: int | None = None):
    """A span named ``name`` around a ``with`` block.  ``root_id`` makes it
    the root of a frame or view; without one it joins the open span's root
    (or starts a root of its own).  Pass a constant name: the off path
    builds nothing."""
    if _enabled or _autograd_profiler._is_profiler_enabled:
        return _Span(name, root_id)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Count ``n`` events under the open span."""
    if _enabled or _autograd_profiler._is_profiler_enabled:
        outer = _open[-1] if _open else None
        t = time.perf_counter_ns()
        _ring.append((name, t, t, -1, -1 if outer is None else outer.id,
                      -1 if outer is None else outer.root, n))


def read_back(t: torch.Tensor):
    """``t.tolist()`` (a Python number for a 0-d tensor): a blocking read
    of the device, timed as a ``wait`` span while tracing is on."""
    if _enabled or _autograd_profiler._is_profiler_enabled:
        with _Span(WAIT, None):
            return t.tolist()
    return t.tolist()


def records() -> list[Record]:
    """The kept spans and counts, each span after those inside it."""
    return [Record(*r) for r in _ring]


def clear() -> None:
    _ring.clear()


def epoch_ns(t_ns: int) -> int:
    """A span time as Unix-epoch ns, the clock of a profiler trace."""
    return t_ns - _CLOCK[0] + _CLOCK[1]


def summary() -> str:
    """Per span name: calls, wall ms (total, mean), self ms (wall less the
    spans directly inside) and wait ms (the ``wait`` spans anywhere inside,
    its own time for ``wait`` itself); then each counter's total."""
    rows: dict[str, list] = {}
    counts: dict[str, int] = {}
    inner: dict[int, int] = collections.defaultdict(int)  # span id -> ns of direct children
    waits: dict[int, int] = collections.defaultdict(int)  # span id -> ns of waits inside
    for r in _ring:  # a span comes after every span inside it
        name, t0, t1, sid, parent, _, n = r
        if n is not None:
            counts[name] = counts.get(name, 0) + n
            continue
        dur = t1 - t0
        w = waits.pop(sid, 0) + (dur if name == WAIT else 0)
        row = rows.setdefault(name, [0, 0, 0, 0])
        row[0] += 1
        row[1] += dur
        row[2] += dur - inner.pop(sid, 0)
        row[3] += w
        if parent >= 0:
            inner[parent] += dur
            waits[parent] += w
    lines = [f"{'span':<28}{'calls':>8}{'wall ms':>12}{'mean ms':>10}{'self ms':>12}"
             f"{'wait ms':>12}"]
    for name, (calls, wall, own, w) in sorted(rows.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"{name:<28}{calls:>8}{wall / 1e6:>12.3f}{wall / 1e6 / calls:>10.3f}"
                     f"{own / 1e6:>12.3f}{w / 1e6:>12.3f}")
    for name, n in sorted(counts.items()):
        lines.append(f"{'count ' + name:<28}{n:>8}")
    return "\n".join(lines)


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
