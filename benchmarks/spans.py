"""The program's own spans and counts, as the per-layer readers of a traced
run take them from the port's recorder (``surfelmapping_tpu_torch.utils.
tracing``).  The recorder records while a torch.profiler records, so its
last roots of a name are the traced stretch's frames or views.  A program
without the recorder reads as nothing, as does one that kept fewer such
roots than the stretch's items."""

from __future__ import annotations

WAIT = "wait"  # a blocking read of the device


def last_roots(name: str, items: int) -> list[tuple] | None:
    """The last ``items`` spans named ``name``, each as (span, the spans and
    counts recorded inside it: its root id, within its times)."""
    from surfelmapping_tpu_torch.utils import tracing

    read = getattr(tracing, "records", None)
    if read is None or items <= 0:
        return None
    recs = read()
    roots = [r for r in recs if r.name == name and r.n is None][-items:]
    if len(roots) < items:
        return None
    by_root: dict[int, list] = {}
    for r in recs:
        by_root.setdefault(r.root_id, []).append(r)
    return [(root, [r for r in by_root[root.root_id] if r is not root
                    and root.start_ns <= r.start_ns and r.end_ns <= root.end_ns])
            for root in roots]


def wait_ns(inside: list) -> int:
    return sum(r.end_ns - r.start_ns for r in inside if r.name == WAIT)


def counted(inside: list, name: str) -> int:
    return sum(r.n for r in inside if r.name == name)
