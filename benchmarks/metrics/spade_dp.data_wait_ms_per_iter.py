"""``spade_dp.data_wait_ms_per_iter``: rank 0's milliseconds per training
iteration spent waiting for its prefetched batch (the program's
``spade.data`` spans), over the traced stretch.  It rises when decoding
the rank's rows takes longer than the step.  A program without the spans
reads as nothing."""

LAYER = "SPADE training loop"
MOVES = "frames_per_s"
FAMILY = "spade"


def read(records: dict) -> float | None:
    spans = records.get("spans")
    return None if spans is None else spans["data_ms_per_iter"]
