"""``render.wait_ms_per_view``: the milliseconds per rendered view in which
the host waited for the device (the program's ``wait`` spans inside its
``render.view`` spans: the active block count, read once the view is
enqueued), over the traced stretch.  A program without the spans reads as
nothing."""

from benchmarks.spans import last_roots, wait_ns

LAYER = "render"
MOVES = "views_per_s"
FAMILY = "render"


def read(records: dict) -> float | None:
    roots = last_roots("render.view", records["items"])
    if roots is None:
        return None
    return sum(wait_ns(inside) for _, inside in roots) / 1e6 / records["items"]
