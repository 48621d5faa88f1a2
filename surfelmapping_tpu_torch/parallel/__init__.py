"""Multi-rank execution: the slot-sharded surfel map over torch.distributed."""
