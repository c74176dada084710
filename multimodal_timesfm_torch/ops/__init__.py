"""Tensor ops: patching, RevIN and causal attention (plain versions and CUDA kernels)."""
