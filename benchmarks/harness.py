"""The benchmark's machinery, driven by ``BENCHMARK.json`` and by files found
by name: ``configs/<config>.json``, ``traffic/<traffic>.json`` (whose
``generator`` names ``traffic/<generator>.py``), ``workloads/<cell>.json``
(whose ``driver`` names ``drivers/<driver>.py``) and ``metrics/<metric>.py``.
A new cell, configuration, mix or per-layer metric is new files and new
entries; no file here changes.

The traced run (``--trace 1``) takes a torch.profiler trace of a stretch of
the window, with the benchmark's own ranges around the calls into each
layer, and hands the per-layer readers its records.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may load (compared whole: the port's
# name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "surfelmapping_tpu")
RANGE_PREFIX = "bench:"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A Python file of the benchmark, loaded by its path (names may hold
    dots and dashes)."""
    name = "benchmarks_" + "_".join(path.relative_to(HERE).with_suffix("").parts)
    name = name.replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything its files hold."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    settings: dict
    end_to_end: list
    per_layer: list

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def driver(self):
        return load_module(HERE / "drivers" / f"{self.settings['driver']}.py")

    def generator(self):
        return load_module(HERE / "traffic" / f"{self.traffic['generator']}.py")


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def find_cell(name: str, root: Path = ROOT) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r}; BENCHMARK.json has {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if reports(m, name, e2e_names)]
    return Cell(name=name, entry=entry, config=config,
                traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                settings=load_json(HERE / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def reader(metric_name: str):
    return load_module(HERE / "metrics" / f"{metric_name}.py")


def host_sample() -> dict:
    """The process's CPU seconds, the host's 1-minute load and its stolen
    CPU seconds (a virtual machine's neighbours), to set beside a window."""
    import os
    import time

    steal = None
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        steal = int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return {"cpu_s": time.process_time(), "load": os.getloadavg()[0], "steal_s": steal}


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    return sorted({m.split(".")[0] for m in (sys.modules if modules is None else modules)}
                  & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def ranges(targets: list[tuple[object, dict]]):
    """For each (module or object, {attribute: label}) wrap the function it
    reaches by that attribute in a profiler range ``bench:<label>``; the
    program's own code is not edited (a copy of profile_fusion's
    ``stage_ranges``, commit dd68e64)."""
    from torch.profiler import record_function

    saved = [(obj, name, getattr(obj, name), label)
             for obj, names in targets for name, label in names.items()]

    def ranged(label, fn):
        def call(*args, **kwargs):
            with record_function(RANGE_PREFIX + label):
                return fn(*args, **kwargs)
        return call

    try:
        for obj, name, fn, label in saved:
            setattr(obj, name, ranged(label, fn))
        yield
    finally:
        for obj, name, fn, _ in saved:
            setattr(obj, name, fn)


class KernelCalls:
    """Records each call of the program's K1 and K2 entry points with its
    sizes (K1: candidates, valid count as the device tensor it is given,
    pixels; K2: pixels and smooth radius).  Nothing is read from the device
    while recording: the valid counts are read once the stretch is over."""

    def __init__(self):
        self.k1: list[tuple] = []
        self.k2: list[tuple] = []

    @contextlib.contextmanager
    def recording(self):
        from surfelmapping_tpu_torch.ops import preprocess_stencil, splat, zbuf

        k1, k2 = zbuf.zbuffer_argmin_packed, preprocess_stencil.preprocess_stencil

        def k1_call(zkey, fpix, num_pix, valid=None):
            self.k1.append((zkey.shape[0], valid, num_pix))
            return k1(zkey, fpix, num_pix, valid)

        def k2_call(metric, semantic, cam, params):
            self.k2.append((metric.numel(), params.smooth_radius))
            return k2(metric, semantic, cam, params)

        patched = [(zbuf, "zbuffer_argmin_packed", k1), (splat, "zbuffer_argmin_packed", k1),
                   (preprocess_stencil, "preprocess_stencil", k2)]
        try:
            for mod, name, _ in patched:
                setattr(mod, name, k1_call if name == "zbuffer_argmin_packed" else k2_call)
            yield self
        finally:
            for mod, name, fn in patched:
                setattr(mod, name, fn)

    def k1_sizes(self) -> list[tuple[int, int, int, bool]]:
        """(candidates, valid, pixels, whether a count was given) of each K1
        call."""
        out = []
        for A, valid, P in self.k1:
            if valid is None:
                n = A
            elif valid.dim() == 0:
                n = min(int(valid), A)
            else:
                n = int(valid.sum())
            out.append((A, n, P, valid is not None))
        return out


def split_events(prof) -> tuple[list, list[tuple[float, float, str]]]:
    """The card's own events (kernels, copies, fills) of a torch.profiler
    run, without the device side of the host's ranges, and the benchmark's
    own host ranges (us) by start."""
    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    device, spans = [], []
    for e in prof.events():
        if e.device_type == cuda and not getattr(e, "is_user_annotation", False):
            device.append(e)
        elif e.device_type == cpu and e.name.startswith(RANGE_PREFIX):
            spans.append((e.time_range.start, e.time_range.end, e.name[len(RANGE_PREFIX):]))
    return device, sorted(spans)


def short_name(kernel: str) -> str:
    """A kernel's name without its namespaces and argument list, at most
    160 characters."""
    import re

    name = re.sub(r"\bvoid\s+|\b(at::native|at|std|c10)::|\(anonymous namespace\)::", "", kernel)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += ch in "<"
        depth -= ch in ">"
        if ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut].strip()[:160]


def busy_intervals(events: list) -> list[tuple[float, float]]:
    """The union of the events' [start, end) intervals (us), in order."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    merged: list[list[float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def idle_by_range(busy: list[tuple[float, float]], spans: list[tuple[float, float, str]],
                  t0: float, t1: float) -> dict[str, float]:
    """Device idle time (us) in [t0, t1], split by the innermost host range
    open while the device was idle ("host" where none was).  The ranges nest,
    as one thread's calls do."""
    # the innermost range over time, as segments (start, label)
    marks = sorted([(s, 0, i) for i, (s, _, _) in enumerate(spans)]
                   + [(e, 1, i) for i, (_, e, _) in enumerate(spans)], key=lambda m: (m[0], -m[1]))
    stack: list[int] = []
    segments = [(t0, "host")]
    for t, kind, i in marks:
        if kind == 0:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        segments.append((t, spans[stack[-1]][2] if stack else "host"))
    gaps, cur = [], t0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, min(s, t1)))
        cur = max(cur, e)
    if cur < t1:
        gaps.append((cur, t1))
    out: dict[str, float] = {}
    j = 0
    for gs, ge in gaps:
        while j + 1 < len(segments) and segments[j + 1][0] <= gs:
            j += 1
        k, t = j, gs
        while t < ge:
            end = min(ge, segments[k + 1][0]) if k + 1 < len(segments) else ge
            if end > t:
                out[segments[k][1]] = out.get(segments[k][1], 0.0) + (end - t)
            t, k = end, k + 1
    return out


class Tracer:
    """The traced run's profiler, over a stretch of ``items`` frames, views
    or steps.  A trace that came back with fewer device events than items
    (every item launches work) lost its events, as torch.profiler's traces
    now and then do: the next stretch is traced instead, up to ``tries``
    stretches (chip_smoke's ``device_profile`` retries so)."""

    def __init__(self, items: int, targets: list | None = None, tries: int = 3):
        self.items, self.targets, self.tries = items, targets or [], tries
        self.records: dict | None = None
        self.lost = 0
        self.calls = KernelCalls()

    @property
    def done(self) -> bool:
        return self.records is not None or self.lost >= self.tries

    @contextlib.contextmanager
    def stretch(self):
        """Trace the ``items`` items run inside; the caller counts them."""
        import time

        import torch
        from torch.profiler import ProfilerActivity, profile

        self.calls = KernelCalls()
        torch.cuda.synchronize()
        with ranges(self.targets), self.calls.recording(), \
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        events, spans = split_events(prof)
        if len(events) < self.items:
            self.lost += 1
            print(f"trace lost its events ({len(events)} for {self.items} items), "
                  f"try {self.lost} of {self.tries}", file=sys.stderr)
            return
        self.records = self.analyse(events, spans, window_s)

    def analyse(self, events: list, spans: list, window_s: float) -> dict:
        busy = busy_intervals(events)
        busy_us = sum(e - s for s, e in busy)
        t0 = min(e.time_range.start for e in events)
        by_name: dict[str, float] = {}
        for e in events:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
        if spans:
            t0 = min(t0, spans[0][0])
        t1 = t0 + window_s * 1e6
        idle = idle_by_range(busy, spans, t0, t1)
        short: dict[str, float] = {}
        for name, us in by_name.items():
            short[short_name(name)] = short.get(short_name(name), 0.0) + us
        top = lambda d: [[k, v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
        return {
            "items": self.items,
            "window_s": window_s,
            "busy_s": busy_us / 1e6,
            "device_events": len(events),
            "kernel_s": {k: v / 1e6 for k, v in by_name.items()},
            "k1_calls": self.calls.k1_sizes(),
            "k2_calls": list(self.calls.k2),
            "breakdown": {"device_ops": top(short), "idle_gaps": top(idle)},
        }


def kernel_seconds(records: dict, pattern: str) -> float:
    """Device seconds of the kernels whose name matches ``pattern``."""
    import re

    return sum(s for name, s in records["kernel_s"].items() if re.search(pattern, name))
