"""Small-S causal attention over the raw fused qkv projection.

Counterpart of ``multimodal_timesfm_tpu/ops/qkv_attention.py``: the input is
the (B, S, 3*H*D) output of the qkv GEMM in column blocks q|k|v, head h at
columns h*D of each block, q pre-scaled; the output is (B, S, H*D), ready for
the out projection. The CUDA kernels read q, k and v straight out of that
layout (row stride 3*H*D), and the backward kernel writes dq|dk|dv into one
(B, S, 3*H*D) gradient in the same layout, so nothing is sliced, copied or
transposed. The residuals are qkv and the mask, as in JAX's custom VJP. The
TPU kernel's row-tile packing is a TPU layout device and is not carried over.
"""

from __future__ import annotations

import torch

from multimodal_timesfm_torch.ops import _kernels
from multimodal_timesfm_torch.ops.attention import plain_attention_bwd, plain_causal_attention


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


def plain_qkv_attention_bwd(
    qkv: torch.Tensor, key_valid: torch.Tensor, g: torch.Tensor, num_heads: int, head_dim: int
) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel (JAX ``_bwd_kernel``).

    g: (B, S, H*D). Returns dqkv (B, S, 3*H*D) in qkv's dtype, column blocks
    dq|dk|dv where JAX's kernel writes them.
    """
    q, k, v = split_heads(qkv, num_heads, head_dim)
    grads = plain_attention_bwd(q, k, v, key_valid, g.unflatten(-1, (num_heads, head_dim)))
    return torch.cat([d.flatten(-2) for d in grads], dim=-1)


class _FusedQKVAttention(torch.autograd.Function):
    @staticmethod
    def forward(
        ctx, qkv: torch.Tensor, key_valid: torch.Tensor, num_heads: int, head_dim: int
    ) -> torch.Tensor:
        ctx.save_for_backward(qkv, key_valid)
        ctx.num_heads, ctx.head_dim = num_heads, head_dim
        if qkv.device.type == "cpu":
            return plain_qkv_causal_attention(qkv, key_valid, num_heads, head_dim)
        batch, seq, _ = qkv.shape
        out = torch.empty((batch, seq, num_heads * head_dim), dtype=qkv.dtype, device=qkv.device)
        q, k, v = split_heads(qkv, num_heads, head_dim)
        _kernels.attention_fwd(q, k, v, key_valid, out.unflatten(-1, (num_heads, head_dim)))
        fused_qkv_causal_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> tuple[torch.Tensor | None, ...]:
        qkv, key_valid = ctx.saved_tensors
        dqkv = fused_qkv_causal_attention_bwd(qkv, key_valid, g, ctx.num_heads, ctx.head_dim)
        return dqkv, None, None, None


def fused_qkv_causal_attention(
    qkv: torch.Tensor, key_valid: torch.Tensor, num_heads: int, head_dim: int
) -> torch.Tensor:
    """softmax(QK^T + causal + padding) V over the raw (B, S, 3*H*D) qkv, differentiable.

    Args:
        qkv: (B, S, 3*H*D) contiguous, q pre-scaled.
        key_valid: (B, S) bool, True = valid key.

    Returns:
        (B, S, H*D) in qkv's dtype. ``fused_qkv_causal_attention.launches``
        counts forward kernel launches.
    """
    cols = qkv.shape[-1]
    if cols != 3 * num_heads * head_dim:
        raise ValueError(f"qkv has {cols} columns, expected 3*H*D = {3 * num_heads * head_dim}")
    if qkv.device.type != "cpu" and not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    return _FusedQKVAttention.apply(qkv, key_valid, num_heads, head_dim)


fused_qkv_causal_attention.launches = 0


def fused_qkv_causal_attention_bwd(
    qkv: torch.Tensor, key_valid: torch.Tensor, g: torch.Tensor, num_heads: int, head_dim: int
) -> torch.Tensor:
    """Backward of :func:`fused_qkv_causal_attention`: dqkv, a new (B, S, 3*H*D).

    A CPU tensor runs :func:`plain_qkv_attention_bwd`; any other launches the
    backward kernel or raises. ``fused_qkv_causal_attention_bwd.launches``
    counts kernel launches.
    """
    if qkv.device.type == "cpu":
        return plain_qkv_attention_bwd(qkv, key_valid, g, num_heads, head_dim)
    dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
    q, k, v = split_heads(qkv, num_heads, head_dim)
    dq, dk, dv = split_heads(dqkv, num_heads, head_dim)
    g_heads = g.contiguous().unflatten(-1, (num_heads, head_dim))
    _kernels.attention_bwd(q, k, v, key_valid, g_heads, dq, dk, dv)
    fused_qkv_causal_attention_bwd.launches += 1
    return dqkv


fused_qkv_causal_attention_bwd.launches = 0


def supports_qkv_fused(x: torch.Tensor, seq: int, dim: int) -> bool:
    """Gate of the fused-qkv kernel: the JAX package's TPU bounds, on CUDA tensors."""
    return x.is_cuda and 8 <= seq < 256 and seq % 8 == 0 and dim <= 256 and dim % 8 == 0
