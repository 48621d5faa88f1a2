"""``render.launches_per_view``: the device's events (kernels, copies, fills)
per rendered view over the traced stretch."""

LAYER = "render"
MOVES = "views_per_s"
FAMILY = "render"


def read(records: dict) -> float | None:
    return records["device_events"] / records["items"]
