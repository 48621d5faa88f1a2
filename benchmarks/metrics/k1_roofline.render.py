"""``k1_roofline.render``: K1's share of its roofline at the render path's calls:
the least time of the traced stretch's K1 calls (each call's bytes from its
own sizes, over the card's HBM bandwidth) over the device time of K1's two
kernels in the trace.  Nothing to read (no K1 call, or no K1 kernel by its
name) reads as nothing."""

from benchmarks.harness import kernel_seconds
from benchmarks.roofline import k1_seconds

LAYER = "kernels"
MOVES = "views_per_s"
FAMILY = "render"
KERNELS = r"\b(fill_empty|scatter_min)\b"  # csrc/zbuffer_argmin.cu


def read(records: dict) -> float | None:
    calls = records["k1_calls"]
    device_s = kernel_seconds(records, KERNELS)
    if not calls or device_s <= 0.0:
        return None
    return 100.0 * sum(k1_seconds(n, P, given) for _, n, P, given in calls) / device_s
