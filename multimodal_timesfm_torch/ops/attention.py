"""Causal attention with key padding: the plain path and the whole-sequence kernel.

Counterpart of ``multimodal_timesfm_tpu/ops/attention.py``. Layout (B, S, H, D)
with q pre-scaled and ``key_valid`` (B, S) bool, True = valid key. Masked
logits are ``finfo(float32).min``, never ``-inf``: a query row with no valid
key then gets uniform weights and stays finite.

``fused_causal_attention`` is differentiable. On a CUDA tensor its forward
launches the hand-written kernel ``csrc/attention_fwd.cu`` and its backward
``csrc/attention_bwd.cu``; on a CPU tensor each runs its plain version. There
is no other fallback. As in JAX's custom VJP, the only residuals are q, k, v
and the mask: the backward recomputes the weights.
"""

from __future__ import annotations

import torch

from multimodal_timesfm_torch.ops import _kernels

NEG_INF = torch.finfo(torch.float32).min


class _SoftmaxLowp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        weights = torch.softmax(logits, dim=-1).to(dtype)
        ctx.save_for_backward(weights)
        return weights

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> tuple[torch.Tensor, None]:
        (weights,) = ctx.saved_tensors
        w32, g32 = weights.float(), g.float()
        return w32 * (g32 - (g32 * w32).sum(dim=-1, keepdim=True)), None


def softmax_lowp(logits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 softmax over the last axis, returned and saved in ``dtype`` (JAX ``softmax_lowp``).

    The backward is the softmax rule evaluated from the saved ``dtype``
    weights upcast to fp32, as JAX's custom VJP does; the fp32 weights are
    never kept.
    """
    return _SoftmaxLowp.apply(logits, dtype)


def masked_logits(q: torch.Tensor, k: torch.Tensor, key_valid: torch.Tensor) -> torch.Tensor:
    """fp32 (B, H, S, S) logits of q pre-scaled, causal-future and padded keys at finfo.min."""
    seq = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    causal = torch.ones(seq, seq, dtype=torch.bool, device=q.device).tril()
    mask = causal[None, None] & key_valid[:, None, None, :]
    return logits.masked_fill(~mask, NEG_INF)


def plain_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch attention, the counterpart of JAX ``xla_causal_attention``.

    fp32 logits and softmax; the weights are rounded to the compute dtype
    (:func:`softmax_lowp`) before an fp32-accumulated PV product (products of
    two bf16 values are exact in fp32), and the output is cast once.

    Args:
        q, k, v: (B, S, H, D); q pre-scaled.
        key_valid: (B, S) bool, True = valid key.

    Returns:
        (B, S, H, D) in q's dtype.
    """
    weights = softmax_lowp(masked_logits(q, k, key_valid), q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float()).to(q.dtype)


def plain_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel (JAX ``_attn_bwd_kernel``).

    Recomputes W = softmax(mask(QK^T)) in fp32 and keeps it unrounded, as the
    kernels do (the plain forward's autograd would use the weights rounded to
    the compute dtype instead): dV = W^T g, dW = g V^T,
    dL = W * (dW - rowsum(dW * W)), dQ = dL K, dK = dL^T Q, all in fp32 with
    one cast to q's dtype.

    Args:
        q, k, v, g: (B, S, H, D); key_valid: (B, S) bool.

    Returns:
        (dq, dk, dv), each (B, S, H, D) in q's dtype.
    """
    w = torch.softmax(masked_logits(q, k, key_valid), dim=-1)
    g32 = g.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", w, g32)
    dw = torch.einsum("bqhd,bkhd->bhqk", g32, v.float())
    dl = w * (dw - (dw * w).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", dl, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", dl, q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


class _FusedCausalAttention(torch.autograd.Function):
    @staticmethod
    def forward(
        ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor
    ) -> torch.Tensor:
        ctx.save_for_backward(q, k, v, key_valid)
        if q.device.type == "cpu":
            return plain_causal_attention(q, k, v, key_valid)
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        _kernels.attention_fwd(q, k, v, key_valid, out)
        fused_causal_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> tuple[torch.Tensor | None, ...]:
        q, k, v, key_valid = ctx.saved_tensors
        return (*fused_causal_attention_bwd(q, k, v, key_valid, g), None)


def fused_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor
) -> torch.Tensor:
    """Whole-sequence causal attention (JAX ``fused_causal_attention``), differentiable.

    q, k, v: (B, S, H, D) sharing one row stride, each head's D values
    contiguous (so q/k/v column views of a fused projection go in without a
    copy); key_valid: (B, S) bool. Returns a new contiguous (B, S, H, D).
    ``fused_causal_attention.launches`` counts forward kernel launches.
    """
    return _FusedCausalAttention.apply(q, k, v, key_valid)


fused_causal_attention.launches = 0


def fused_causal_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`fused_causal_attention`: (dq, dk, dv), each a new (B, S, H, D).

    A CPU tensor runs :func:`plain_attention_bwd`; any other launches the
    backward kernel or raises. ``fused_causal_attention_bwd.launches`` counts
    kernel launches.
    """
    if q.device.type == "cpu":
        return plain_attention_bwd(q, k, v, key_valid, g)
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    _kernels.attention_bwd(q, k, v, key_valid, g.contiguous(), dq, dk, dv)
    fused_causal_attention_bwd.launches += 1
    return dq, dk, dv


fused_causal_attention_bwd.launches = 0


def supports_fused(x: torch.Tensor, seq: int, dim: int) -> bool:
    """Gate of the whole-sequence kernel: the JAX package's TPU bounds, on CUDA tensors."""
    return x.is_cuda and 256 <= seq <= 1024 and seq % 8 == 0 and dim <= 256


def needs_flash(x: torch.Tensor, seq: int, dim: int) -> bool:
    """Where JAX runs its library flash kernel (S > 2048), which is not ported yet."""
    return x.is_cuda and seq > 2048 and dim <= 256
