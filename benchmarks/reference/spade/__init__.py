"""A plain float32 PyTorch reference of SPADE's training step, as LADS trains
it: Park et al., "Semantic Image Synthesis with Spatially-Adaptive
Normalization", CVPR 2019 (arXiv:1903.07291), in LADS's modified copy
(``SPADE/``: the label is the rendered RGB image, three channels).

It imports nothing of the program and no kernel of its own: every layer
is a ``torch.nn.functional`` call on a flat dictionary of weights, named as
the program's modules name them (``gen.head_0.norm_0.Conv_0.weight``), so
that a state of the program can be handed over as it is.

``model`` holds the networks and the losses, ``train`` the two training
steps and Adam.  Each works on a batch held as a list of parts (``parts``
of the steps): one part is the batch as one, four parts compute it as four
ranks would, with the batch norms' statistics and the gradients summed over
the parts, which gives the float32 summation-order spread of a split batch.

Departures from the published description, each as the program has it:
  * the VGG loss runs on the trainer's fixed randomly initialised VGG19
    feature net: no pretrained VGG19 is in the repository;
  * spectral norm runs one power step from the stored ``u`` on the kernel
    laid out as (fan_in, out) with fan_in in (in, h, w) order, and divides
    by that step's sigma (flax's SpectralNorm, as the LADS copy's JAX port
    has it); a network in eval mode runs the step too and stores nothing;
  * the generator's batch norms take the "fast" variance max(0, E[x^2] -
    E[x]^2) over N, H and W, and move their running statistics by 0.9;
  * nearest resizes sample row floor((i + 0.5) * in / out) (JAX's), and
    the encoder's bilinear resize to 256 antialiases;
  * the dense layers flatten and reshape in NHWC order (flax's);
  * the VAE's noise of the global batch is an input (the program draws it
    from its own generators);
  * the G step recomputes each residual block's activations in its
    backward (``torch.utils.checkpoint``): the global batch of 32 at crop
    256 does not otherwise fit on one card.

Each step turns TF32 off for matrix products and convolutions
(``full_float32``: ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False).
"""

from benchmarks.reference.spade.model import Config, full_float32  # noqa: F401
from benchmarks.reference.spade.train import Adam, State, d_step, g_step  # noqa: F401
