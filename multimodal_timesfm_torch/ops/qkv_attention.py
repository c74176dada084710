"""Small-S causal attention over the raw fused qkv projection.

Counterpart of ``multimodal_timesfm_tpu/ops/qkv_attention.py``: the input is
the (B, S, 3*H*D) output of the qkv GEMM in column blocks q|k|v, head h at
columns h*D of each block, q pre-scaled; the output is (B, S, H*D), ready for
the out projection. The CUDA kernel reads q, k and v straight out of that
layout (row stride 3*H*D), so nothing is sliced, copied or transposed. The
TPU kernel's row-tile packing is a TPU layout device and is not carried over.
"""

from __future__ import annotations

import torch

from multimodal_timesfm_torch.ops import _kernels
from multimodal_timesfm_torch.ops.attention import plain_causal_attention


def split_heads(qkv: torch.Tensor, num_heads: int, head_dim: int) -> tuple[torch.Tensor, ...]:
    """(B, S, 3*H*D) -> three (B, S, H, D) views; no copy."""
    hd = num_heads * head_dim
    return tuple(
        qkv[..., i * hd : (i + 1) * hd].unflatten(-1, (num_heads, head_dim)) for i in range(3)
    )


def plain_qkv_causal_attention(
    qkv: torch.Tensor, key_valid: torch.Tensor, num_heads: int, head_dim: int
) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_qkv_causal_attention`."""
    q, k, v = split_heads(qkv, num_heads, head_dim)
    return plain_causal_attention(q, k, v, key_valid).flatten(-2)


def fused_qkv_causal_attention(
    qkv: torch.Tensor, key_valid: torch.Tensor, num_heads: int, head_dim: int
) -> torch.Tensor:
    """softmax(QK^T + causal + padding) V over the raw (B, S, 3*H*D) qkv.

    Args:
        qkv: (B, S, 3*H*D) contiguous, q pre-scaled.
        key_valid: (B, S) bool, True = valid key.

    Returns:
        (B, S, H*D) in qkv's dtype.
    """
    batch, seq, cols = qkv.shape
    hd = num_heads * head_dim
    if cols != 3 * hd:
        raise ValueError(f"qkv has {cols} columns, expected 3*H*D = {3 * hd}")
    if qkv.device.type == "cpu":
        return plain_qkv_causal_attention(qkv, key_valid, num_heads, head_dim)
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    out = torch.empty((batch, seq, hd), dtype=qkv.dtype, device=qkv.device)
    q, k, v = split_heads(qkv, num_heads, head_dim)
    _kernels.attention_fwd(q, k, v, key_valid, out.unflatten(-1, (num_heads, head_dim)))
    fused_qkv_causal_attention.launches += 1
    return out


fused_qkv_causal_attention.launches = 0


def supports_qkv_fused(x: torch.Tensor, seq: int, dim: int) -> bool:
    """Gate of the fused-qkv kernel: the JAX package's TPU bounds, on CUDA tensors."""
    return x.is_cuda and 8 <= seq < 256 and seq % 8 == 0 and dim <= 256 and dim % 8 == 0
