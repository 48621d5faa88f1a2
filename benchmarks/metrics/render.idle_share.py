"""``render.idle_share``: the share of the traced stretch of rendered views in
which no operation ran on the device."""

LAYER = "device"
MOVES = "views_per_s"
FAMILY = "render"


def read(records: dict) -> float | None:
    return 100.0 * (1.0 - records["busy_s"] / records["window_s"])
