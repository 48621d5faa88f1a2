"""``fuse.busy_ms_per_frame``: milliseconds per fused frame in which an
operation ran on the device over the traced stretch: the fusion step's work
on the card."""

LAYER = "fusion step"
MOVES = "frames_per_s"
FAMILY = "fuse"


def read(records: dict) -> float | None:
    return records["busy_s"] * 1e3 / records["items"]
