"""Small-S causal attention over the raw fused qkv projection.

Counterpart of ``multimodal_timesfm_tpu/ops/qkv_attention.py``: the input is
the (B, S, 3*H*D) output of the qkv GEMM in column blocks q|k|v, head h at
columns h*D of each block, q pre-scaled; the output is (B, S, H*D), ready for
the out projection. The CUDA kernels read q, k and v straight out of that
layout (row stride 3*H*D), and the backward kernel writes dq|dk|dv into one
(B, S, 3*H*D) gradient in the same layout, so nothing is sliced, copied or
transposed. The residuals are qkv and the mask, as in JAX's custom VJP. The
entry point is the ``torch.library`` custom op
``torch.ops.mtt.fused_qkv_causal_attention``. The TPU kernel's row-tile
packing is a TPU layout device and is not carried over.
"""

from __future__ import annotations

import collections

import torch

from multimodal_timesfm_torch.ops import _kernels
from multimodal_timesfm_torch.ops.attention import (
    fold_trials,
    is_traced,
    plain_attention_bwd,
    plain_causal_attention,
    takes_kernels,
)


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


def fused_qkv_causal_attention(
    qkv: torch.Tensor, key_valid: torch.Tensor, num_heads: int, head_dim: int
) -> torch.Tensor:
    """softmax(QK^T + causal + padding) V over the raw (B, S, 3*H*D) qkv, differentiable.

    Args:
        qkv: (B, S, 3*H*D) contiguous, q pre-scaled.
        key_valid: (B, S) bool, True = valid key.

    Returns:
        (B, S, H*D) in qkv's dtype. ``fused_qkv_causal_attention.launches``
        counts forward kernel launches, ``.shapes`` counts them by (dtype, B, S, H, D).
    """
    cols = qkv.shape[-1]
    if cols != 3 * num_heads * head_dim:
        raise ValueError(f"qkv has {cols} columns, expected 3*H*D = {3 * num_heads * head_dim}")
    return _fused_qkv_op(qkv, key_valid, num_heads, head_dim)


fused_qkv_causal_attention.launches = 0
fused_qkv_causal_attention.shapes = collections.Counter()


def fused_qkv_causal_attention_bwd(
    qkv: torch.Tensor, key_valid: torch.Tensor, g: torch.Tensor, num_heads: int, head_dim: int
) -> torch.Tensor:
    """Backward of :func:`fused_qkv_causal_attention`: dqkv, a new (B, S, 3*H*D).

    A CPU tensor runs :func:`plain_qkv_attention_bwd`; any other launches the
    backward kernel or raises. ``fused_qkv_causal_attention_bwd.launches``
    counts kernel launches, ``.shapes`` counts them by (dtype, B, S, H, D).
    """
    if qkv.device.type == "cpu":
        return plain_qkv_attention_bwd(qkv, key_valid, g, num_heads, head_dim)
    dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
    q, k, v = split_heads(qkv, num_heads, head_dim)
    dq, dk, dv = split_heads(dqkv, num_heads, head_dim)
    g_heads = g.contiguous().unflatten(-1, (num_heads, head_dim))
    _kernels.attention_bwd(q, k, v, key_valid, g_heads, dq, dk, dv)
    fused_qkv_causal_attention_bwd.launches += 1
    fused_qkv_causal_attention_bwd.shapes[(qkv.dtype, *qkv.shape[:2], num_heads, head_dim)] += 1
    return dqkv


fused_qkv_causal_attention_bwd.launches = 0
fused_qkv_causal_attention_bwd.shapes = collections.Counter()


def _forward(qkv: torch.Tensor, key_valid: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    """The op's implementation: plain on a CPU tensor, else the kernel, counted."""
    if qkv.device.type == "cpu":
        return plain_qkv_causal_attention(qkv, key_valid, num_heads, head_dim).contiguous()
    batch, seq, _ = qkv.shape
    out = torch.empty((batch, seq, num_heads * head_dim), dtype=qkv.dtype, device=qkv.device)
    q, k, v = split_heads(qkv, num_heads, head_dim)
    _kernels.attention_fwd(q, k, v, key_valid, out.unflatten(-1, (num_heads, head_dim)))
    fused_qkv_causal_attention.launches += 1
    fused_qkv_causal_attention.shapes[(qkv.dtype, *qkv.shape[:2], num_heads, head_dim)] += 1
    return out


def _setup_context(ctx, inputs, output) -> None:
    qkv, key_valid, num_heads, head_dim = inputs
    ctx.save_for_backward(qkv, key_valid)
    ctx.num_heads, ctx.head_dim = num_heads, head_dim


def _backward(ctx, g: torch.Tensor) -> tuple[torch.Tensor | None, ...]:
    qkv, key_valid = ctx.saved_tensors
    dqkv = fused_qkv_causal_attention_bwd(qkv, key_valid, g, ctx.num_heads, ctx.head_dim)
    return dqkv, None, None, None


def _fake(qkv: torch.Tensor, key_valid: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    """The shape and dtype for ``torch.export``; a real meta tensor takes the kernel path."""
    if not is_traced(qkv):
        return _forward(qkv, key_valid, num_heads, head_dim)
    return qkv.new_empty((*qkv.shape[:2], num_heads * head_dim))


# The custom op mtt::fused_qkv_causal_attention, registered as ops/attention.py's
# entry points are: one implementation for every device, a fake one for
# torch.export (and meta tensors), the backward kernel through register_autograd.
_fused_qkv_op = torch.library.custom_op("mtt::fused_qkv_causal_attention", _forward, mutates_args=())
_fused_qkv_op.register_fake(_fake)
_fused_qkv_op.register_autograd(_backward, setup_context=_setup_context)


def _vmap_rule(info, in_dims, qkv, key_valid, num_heads, head_dim):
    """Under ``torch.func.vmap``: the trial axis folded into the batch rows, one launch
    (and one backward launch) for all trials; rows are independent in the kernels."""
    trials = info.batch_size
    out = _fused_qkv_op(
        fold_trials(qkv, in_dims[0], trials).contiguous(),
        fold_trials(key_valid, in_dims[1], trials).contiguous(),
        num_heads,
        head_dim,
    )
    return out.unflatten(0, (trials, -1)), 0


_fused_qkv_op.register_vmap(_vmap_rule)


def supports_qkv_fused(x: torch.Tensor, seq: int, dim: int) -> bool:
    """Gate of the fused-qkv kernel (B1): the JAX package's TPU bounds (8 <= S < 256,
    S % 8 == 0), on a tensor that ``ops.attention.takes_kernels``."""
    return takes_kernels(x) and 8 <= seq < 256 and seq % 8 == 0 and dim <= 256 and dim % 8 == 0
