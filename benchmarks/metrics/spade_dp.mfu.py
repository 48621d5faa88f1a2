"""``spade_dp.mfu``: the model FLOPs of the traced stretch's training
iterations (``benchmarks/spade_flops.py``: convolutions and dense layers,
a trained net's backward as twice its forward) over the stretch's seconds
on rank 0 times the cards' float32 peak (66.9 TFLOP/s each)."""

LAYER = "SPADE training step"
MOVES = "frames_per_s"
FAMILY = "spade"


def read(records: dict) -> float | None:
    if "flops_per_iter" not in records:
        return None
    peak = records["ranks"] * records["peak_flops"] * records["window_s"]
    return 100.0 * records["flops_per_iter"] * records["items"] / peak
