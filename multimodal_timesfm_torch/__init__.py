"""PyTorch/CUDA port of multimodal_timesfm_tpu.

A package of its own beside the JAX package, which it mirrors module by
module (``ops/``, ``models/``, ``data/``) and never imports. Plain tensor code
is PyTorch; the JAX package's Pallas TPU kernels become hand-written CUDA
kernels for Hopper (``csrc/``), built at first use. Entry points run on the
CUDA device unless the caller passes ``device="cpu"``.
"""
