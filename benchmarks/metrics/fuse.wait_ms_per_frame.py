"""``fuse.wait_ms_per_frame``: the milliseconds per fused frame in which the
host waited for the device (the program's ``wait`` spans inside its
``fuse.frame`` spans: the sync window's read, growth's and compaction's
counts), over the traced stretch.  It rises when the device, not the host,
sets the pace.  A program without the spans reads as nothing."""

from benchmarks.spans import last_roots, wait_ns

LAYER = "host driver"
MOVES = "frames_per_s"
FAMILY = "fuse"


def read(records: dict) -> float | None:
    roots = last_roots("fuse.frame", records["items"])
    if roots is None:
        return None
    return sum(wait_ns(inside) for _, inside in roots) / 1e6 / records["items"]
