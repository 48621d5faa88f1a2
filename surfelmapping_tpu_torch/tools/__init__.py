"""Measurement entry points of the port: the counterparts of the JAX
package's TPU probes (the root ``tools/``), run on the CUDA card."""
