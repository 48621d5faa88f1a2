"""``k2_roofline.fuse``: K2's share of its roofline in fusion: the least time
of the traced stretch's K2 calls (the larger of each call's float32
operations over the card's peak and its bytes over HBM bandwidth, from the
call's own sizes) over the device time of K2's kernel in the trace.
Nothing to read reads as nothing."""

from benchmarks.harness import kernel_seconds
from benchmarks.roofline import k2_seconds

LAYER = "kernels"
MOVES = "frames_per_s"
FAMILY = "fuse"
KERNELS = r"\bstencil_kernel\b"  # csrc/preprocess_stencil.cu


def read(records: dict) -> float | None:
    calls = records["k2_calls"]
    device_s = kernel_seconds(records, KERNELS)
    if not calls or device_s <= 0.0:
        return None
    return 100.0 * sum(k2_seconds(p, r) for p, r in calls) / device_s
