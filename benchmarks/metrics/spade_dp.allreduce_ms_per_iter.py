"""``spade_dp.allreduce_ms_per_iter``: rank 0's device milliseconds per
training iteration in NCCL's kernels (the gradient all-reduces, the batch
norms' statistics forward and backward, the window's barriers), over the
traced stretch.  It includes the time an all-reduce waits for the slowest
rank."""

from benchmarks.harness import kernel_seconds

LAYER = "collectives"
MOVES = "frames_per_s"
FAMILY = "spade"


def read(records: dict) -> float | None:
    return kernel_seconds(records, r"(?i)nccl") * 1e3 / records["items"]
