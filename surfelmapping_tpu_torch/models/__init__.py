"""SPADE enhancement of rendered views (counterpart of
surfelmapping_tpu/models/): the generator and VAE encoder, the inference
half of the Pix2Pix trainer, the inference data and the JAX package's
checkpoint format."""
