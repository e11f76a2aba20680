"""lavender-tpu on PyTorch and CUDA: the serving forward and the
retrieval-MLM train step on one NVIDIA H100.

A port of the JAX package ``lavender_tpu`` (which stays the reference): the
same model, parameters and layouts, with the TPU's Pallas kernels replaced
by hand-written CUDA kernels under ``csrc/``.  Imports nothing of the JAX
package.
"""

__version__ = "0.3.0"
