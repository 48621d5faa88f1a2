"""``fuse.idle_share``: the share of the traced stretch of fused frames in
which no operation ran on the device."""

LAYER = "device"
MOVES = "frames_per_s"
FAMILY = "fuse"


def read(records: dict) -> float | None:
    return 100.0 * (1.0 - records["busy_s"] / records["window_s"])
