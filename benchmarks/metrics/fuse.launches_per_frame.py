"""``fuse.launches_per_frame``: the device's events (kernels, copies, fills)
per fused frame over the traced stretch: the host's launch load, which the
host driver sets."""

LAYER = "host driver"
MOVES = "frames_per_s"
FAMILY = "fuse"


def read(records: dict) -> float | None:
    return records["device_events"] / records["items"]
