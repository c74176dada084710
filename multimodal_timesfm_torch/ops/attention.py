"""Causal attention with key padding: the plain path and the whole-sequence kernel.

Counterpart of ``multimodal_timesfm_tpu/ops/attention.py``. Layout (B, S, H, D)
with q pre-scaled and ``key_valid`` (B, S) bool, True = valid key. Masked
logits are ``finfo(float32).min``, never ``-inf``: a query row with no valid
key then gets uniform weights and stays finite.

``fused_causal_attention`` launches the hand-written CUDA kernel
(``csrc/attention_fwd.cu``) on a CUDA tensor and runs the plain version on a
CPU tensor; there is no other fallback. Forward only: the backward kernel
comes with the trainer.
"""

from __future__ import annotations

import torch

from multimodal_timesfm_torch.ops import _kernels

NEG_INF = torch.finfo(torch.float32).min


def plain_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch attention, the counterpart of JAX ``xla_causal_attention``.

    fp32 logits and softmax; the weights are rounded to the compute dtype
    before an fp32-accumulated PV product (products of two bf16 values are
    exact in fp32), and the output is cast once.

    Args:
        q, k, v: (B, S, H, D); q pre-scaled.
        key_valid: (B, S) bool, True = valid key.

    Returns:
        (B, S, H, D) in q's dtype.
    """
    seq = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    causal = torch.ones(seq, seq, dtype=torch.bool, device=q.device).tril()
    mask = causal[None, None] & key_valid[:, None, None, :]
    logits = logits.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float()).to(q.dtype)


def fused_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor
) -> torch.Tensor:
    """Whole-sequence causal attention (JAX ``fused_causal_attention`` forward).

    q, k, v: (B, S, H, D) sharing one row stride, each head's D values
    contiguous (so q/k/v column views of a fused projection go in without a
    copy); key_valid: (B, S) bool. Returns a new contiguous (B, S, H, D).
    """
    if q.device.type == "cpu":
        return plain_causal_attention(q, k, v, key_valid)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _kernels.attention_fwd(q, k, v, key_valid, out)
    fused_causal_attention.launches += 1
    return out


fused_causal_attention.launches = 0


def supports_fused(x: torch.Tensor, seq: int, dim: int) -> bool:
    """Gate of the whole-sequence kernel: the JAX package's TPU bounds, on CUDA tensors."""
    return x.is_cuda and 256 <= seq <= 1024 and seq % 8 == 0 and dim <= 256


def needs_flash(x: torch.Tensor, seq: int, dim: int) -> bool:
    """Where JAX runs its library flash kernel (S > 2048), which is not ported yet."""
    return x.is_cuda and seq > 2048 and dim <= 256
