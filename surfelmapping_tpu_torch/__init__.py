"""surfelmapping_tpu_torch — the surfel mapper in PyTorch, with hand-written
CUDA kernels for Hopper.

A port of ``surfelmapping_tpu`` (JAX on a TPU), which stays beside it as the
reference.  This package imports neither JAX nor the JAX package.  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``, where
every kernel's plain PyTorch version runs instead.

    from surfelmapping_tpu_torch.pipeline import SurfelMapper
    python -m surfelmapping_tpu_torch.build_map --synthetic 20 --out map.bin
"""
