"""``spade_dp.idle_share``: the share of the traced stretch of training
iterations in which no operation ran on rank 0's card.  NCCL's kernels
count as busy while they wait for the other ranks."""

LAYER = "device"
MOVES = "frames_per_s"
FAMILY = "spade"


def read(records: dict) -> float | None:
    return 100.0 * (1.0 - records["busy_s"] / records["window_s"])
