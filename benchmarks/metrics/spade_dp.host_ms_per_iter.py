"""``spade_dp.host_ms_per_iter``: rank 0's host milliseconds per training
iteration outside its waits: each ``spade.iter`` span of the program less
the ``wait`` spans inside it, over the traced stretch.  Where the card sets
the pace it includes the time the host is held in a launch.  A program
without the spans reads as nothing."""

LAYER = "SPADE training loop"
MOVES = "frames_per_s"
FAMILY = "spade"


def read(records: dict) -> float | None:
    spans = records.get("spans")
    return None if spans is None else spans["host_ms_per_iter"]
