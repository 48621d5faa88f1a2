"""``fuse.host_ms_per_frame``: the host's milliseconds per fused frame outside
its waits for the device, over the traced stretch: each ``fuse.frame`` span
of the program less the ``wait`` spans inside it.  What launch cures cut.
A program without the spans reads as nothing."""

from benchmarks.spans import last_roots, wait_ns

LAYER = "host driver"
MOVES = "frames_per_s"
FAMILY = "fuse"


def read(records: dict) -> float | None:
    roots = last_roots("fuse.frame", records["items"])
    if roots is None:
        return None
    ns = sum(root.end_ns - root.start_ns - wait_ns(inside) for root, inside in roots)
    return ns / 1e6 / records["items"]
