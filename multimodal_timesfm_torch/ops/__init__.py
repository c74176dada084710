"""Tensor ops: patching, RevIN, causal and Chronos-2 attention (plain versions and CUDA kernels)."""
