"""bfc-tpu ported to PyTorch and CUDA on one NVIDIA H100.

The counterpart of the JAX package bfc_tpu: the same two-pass k-mer
spectrum error correction of lh3/bfc (count, then correct or trim) with
output byte-identical to it, where every device program of the ported
paths is a kernel written by hand for Hopper (csrc/).  The package imports torch,
numpy and the standard library only.
"""

__version__ = "0.1.0"
