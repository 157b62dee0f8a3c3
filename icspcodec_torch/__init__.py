"""icspcodec_torch: the block video codec on PyTorch and CUDA (NVIDIA H100).

A port of the JAX package icspcodec_tpu, held against it: exact mode gives
the same bytes.  The sequential wavefronts run as hand-written CUDA kernels
(csrc/), each beside its plain PyTorch version (the one used on the CPU).
"""
