"""``render.retries_per_view``: the renders per view that the cull budget
truncated and the program drew again (its ``render.budget_retries`` counts
inside its ``render.view`` spans), over the traced stretch.  A program
without the counts reads as nothing."""

from benchmarks.spans import counted, last_roots

LAYER = "render"
MOVES = "view_ms_p95"
FAMILY = "render"


def read(records: dict) -> float | None:
    roots = last_roots("render.view", records["items"])
    if roots is None:
        return None
    return sum(counted(inside, "render.budget_retries") for _, inside in roots) / records["items"]
