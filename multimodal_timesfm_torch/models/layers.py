"""Core building blocks: dense, norms, the residual MLP, causal attention, the stack.

Counterpart of ``multimodal_timesfm_tpu/models/layers.py``. The numeric rules
are the JAX package's: GEMMs accumulate in fp32 and cast once to the input
dtype; the low-precision norms accumulate their moments in fp32, keep the
(..., D) intermediates in the input dtype and apply the learned gain in fp32
with one final cast. Padding masks are bool, True = padded.

Weights are stored as ``nn.Linear`` does, (out, in); the JAX package stores
(in, out) (``models/bridge.py`` converts).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_timesfm_torch.ops.attention import (
    flash_causal_attention,
    fused_causal_attention,
    needs_flash,
    plain_causal_attention,
    supports_fused,
)
from multimodal_timesfm_torch.ops.qkv_attention import (
    fused_qkv_causal_attention,
    split_heads,
    supports_qkv_fused,
)

# 1/ln(2): softplus(0) * _R_SOFTPLUS_0 == 1, so a zero per-dim scale is 1/sqrt(D).
_R_SOFTPLUS_0 = 1.442695041


def xavier_uniform(shape: tuple[int, int], generator: torch.Generator) -> torch.Tensor:
    """Xavier-uniform init of an (out, in) weight, from ``generator``."""
    fan_out, fan_in = shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ weight.T + bias`` accumulated in fp32, bias added in fp32, one cast to x's dtype."""
    b = None if bias is None else bias.float()
    return F.linear(x.float(), weight.float(), b).to(x.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    """ReLU whose backward reads the mask from the saved output (JAX ``relu``'s custom VJP).

    ``torch.relu`` already saves only its output and takes the gradient at 0
    as 0, which is what the JAX package's custom VJP adds to ``jnp.maximum``:
    the output is a residual of the down projection anyway, so no separate
    ``x > 0`` mask is kept.
    """
    return torch.relu(x)


class _Swish(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        s = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1 - s))


def swish(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` rounded as ``jax.nn.swish`` rounds it on the CPU.

    Every elementwise op runs in fp32 and rounds to x's dtype, in JAX's order:
    ``x * (1 / (1 + exp(-x)))``; in bf16 this is bit-equal to JAX on every
    bf16 value (``F.silu`` rounds once and differs on a quarter of them). The
    backward is JAX's logistic rule, ``g * s + (g * x) * (s * (1 - s))`` with
    the same per-op rounding; differentiating the forward's ops instead would
    give ``0 * inf`` below x = -88, where ``exp(-x)`` overflows.
    """
    return _Swish.apply(x)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with gain ``1 + scale``."""
    if x.dtype == torch.float32:
        var = (x * x).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + eps) * (1.0 + scale)
    # fp32 variance, x.dtype intermediates, fp32 gain with one final cast:
    # casting (1 + scale) to bf16 first would snap it to a ~0.004 grid.
    var = (x * x).float().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return ((x * inv).float() * (1.0 + scale.float())).to(x.dtype)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm with population variance."""
    if x.dtype == torch.float32:
        mu = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, correction=0)
        return (x - mu) * torch.rsqrt(var + eps) * scale + bias
    mu32 = x.float().mean(dim=-1, keepdim=True)
    centered = x - mu32.to(x.dtype)
    var = (centered * centered).float().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return ((centered * inv).float() * scale.float() + bias.float()).to(x.dtype)


class Dense(nn.Module):
    """Affine map with an (out, in) weight; see :func:`dense`."""

    def __init__(self, in_dim: int, out_dim: int, generator: torch.Generator, bias: bool = True) -> None:
        super().__init__()
        self.weight = nn.Parameter(xavier_uniform((out_dim, in_dim), generator))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias)


class RMSNorm(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale)


class LayerNorm(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias)


class ResidualBlock(nn.Module):
    """Residual MLP: ``output(act(hidden(x))) + residual(x)``; ``act`` is swish unless given
    (Chronos-2's patch embeddings use :func:`relu`)."""

    def __init__(
        self, in_dim: int, hidden_dim: int, out_dim: int, generator: torch.Generator,
        act: Callable[[torch.Tensor], torch.Tensor] = swish,
    ) -> None:
        super().__init__()
        self.act = act
        self.hidden = Dense(in_dim, hidden_dim, generator)
        self.output = Dense(hidden_dim, out_dim, generator)
        self.residual = Dense(in_dim, out_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output(self.act(self.hidden(x))) + self.residual(x)


class Attention(nn.Module):
    """Multi-head causal self-attention with key padding and a learned per-dim query scale."""

    def __init__(
        self, model_dims: int, num_heads: int, head_dim: int, generator: torch.Generator
    ) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.qkv = Dense(model_dims, 3 * num_heads * head_dim, generator)
        self.out = Dense(num_heads * head_dim, model_dims, generator)
        self.per_dim_scale = nn.Parameter(torch.zeros(head_dim))

    def forward(self, x: torch.Tensor, paddings: torch.Tensor) -> torch.Tensor:
        """Counterpart of JAX ``causal_attention``, with its dispatch.

        Args:
            x: (B, S, model_dims).
            paddings: (B, S) bool, True = padded token.

        Dispatch: one token -> the v projection alone (softmax over one key
        is the identity); on CUDA 8 <= S < 256 -> the fused-qkv kernel,
        256 <= S <= 1024 -> the whole-sequence kernel, S > 2048 -> the flash
        entry point; everything else, and every CPU tensor, the plain path.
        """
        batch, seq, _ = x.shape
        heads, dim = self.num_heads, self.head_dim
        hd = heads * dim
        if seq == 1:
            bias = None if self.qkv.bias is None else self.qkv.bias[2 * hd :]
            out = dense(x, self.qkv.weight[2 * hd :], bias)
            return self.out(out.to(x.dtype))

        qkv = self.qkv(x)  # (B, S, 3*H*D), column blocks q|k|v
        # Per-dim query scale on the q column block, fp32 multiply and one cast.
        scale = (_R_SOFTPLUS_0 / math.sqrt(dim)) * F.softplus(self.per_dim_scale.float())
        q = (qkv[..., :hd].float() * scale.repeat(heads)).to(qkv.dtype)
        if qkv.requires_grad:
            # A new tensor, as JAX's concatenate: writing into the projection
            # output would overwrite what the backward of the scale and of the
            # projection read.
            qkv = torch.cat([q, qkv[..., hd:]], dim=-1)
        else:
            # Nothing differentiates through it (serving): in place, which
            # saves a copy of qkv per layer.
            qkv[..., :hd] = q
        key_valid = ~paddings

        if supports_qkv_fused(qkv, seq, dim):
            out = fused_qkv_causal_attention(qkv, key_valid, heads, dim)
        else:
            q, k, v = split_heads(qkv, heads, dim)
            if supports_fused(qkv, seq, dim):
                out = fused_causal_attention(q, k, v, key_valid)
            elif needs_flash(qkv, seq, dim):
                out = flash_causal_attention(q, k, v, key_valid)
            else:
                out = plain_causal_attention(q, k, v, key_valid)
            out = out.reshape(batch, seq, hd)
        return self.out(out.to(x.dtype))


class TransformerLayer(nn.Module):
    """Pre-norm causal block: RMS norm -> attention -> residual; LayerNorm -> ReLU FFN ->
    padding-zeroed residual."""

    def __init__(
        self, model_dims: int, num_heads: int, head_dim: int, ffn_dims: int,
        generator: torch.Generator,
    ) -> None:
        super().__init__()
        self.attn_norm = RMSNorm(model_dims)
        self.attn = Attention(model_dims, num_heads, head_dim, generator)
        self.ffn_norm = LayerNorm(model_dims)
        self.ffn_up = Dense(model_dims, ffn_dims, generator)
        self.ffn_down = Dense(ffn_dims, model_dims, generator)

    def forward(self, x: torch.Tensor, paddings: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), paddings)
        h = self.ffn_down(relu(self.ffn_up(self.ffn_norm(x))))
        h = h * (~paddings)[..., None].to(h.dtype)
        return x + h


class StackedTransformer(nn.Module):
    """``num_layers`` transformer layers run in order (the JAX package scans a stacked tree)."""

    def __init__(
        self, num_layers: int, model_dims: int, num_heads: int, head_dim: int, ffn_dims: int,
        generator: torch.Generator,
    ) -> None:
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerLayer(model_dims, num_heads, head_dim, ffn_dims, generator)
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, paddings: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, paddings)
        return x
