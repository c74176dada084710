"""BERT-family sentence encoder (the all-MiniLM-L6-v2 geometry) as a PyTorch module.

Counterpart of the JAX package's ``text/bert.py``, computing what
``bert_encode`` computes, op by op, in fp32: post-LN blocks with
biased-variance LayerNorm (eps 1e-12), exact GELU, learned position and
token-type embeddings; attention as two products in fp32 with the logits
scaled by 1/sqrt(head_dim) and a ``finfo(float32).min`` additive key mask;
then attention-mask-weighted mean pooling and L2 normalisation.

The module's parameter names are the JAX tree's, so ``models/bridge.py``
loads a JAX params tree into it and writes one back: ``embeddings/{word,
position,token_type}`` tables, ``embeddings/ln``, and a ``layers`` list whose
dense kernels are (in, out) in JAX and (out, in) here.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def minilm_l6(cls) -> "BertConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "BertConfig":
        return cls(vocab_size=128, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32)


def normal(shape: tuple[int, ...], generator: torch.Generator, std: float = 0.02) -> nn.Parameter:
    """An N(0, std^2) parameter drawn on the CPU from ``generator``."""
    return nn.Parameter(torch.randn(shape, generator=generator) * std)


class Linear(nn.Module):
    """``x @ weight.T + bias`` with an (out, in) weight drawn N(0, 0.02^2), a zero bias."""

    def __init__(self, in_dim: int, out_dim: int, generator: torch.Generator, bias: bool = True) -> None:
        super().__init__()
        self.weight = normal((out_dim, in_dim), generator)
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    """Biased-variance LayerNorm: ``(x - mean) * rsqrt(var + eps) * scale [+ bias]``."""

    def __init__(self, dim: int, eps: float, bias: bool = True) -> None:
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.scale.shape, self.scale, self.bias, self.eps)


def check_int_mask(attention_mask: torch.Tensor) -> None:
    """Refuse a bool mask: the encoders take the tokenizer's int mask (HF polarity,
    1 = valid), and a bool mask suggests the repo's True = padded convention."""
    if attention_mask.dtype == torch.bool:
        raise TypeError(
            "attention_mask must be the tokenizer's int mask (HF polarity, 1=valid); "
            "a bool mask suggests the repo's True=padded convention, which would be "
            "silently inverted here — convert explicitly."
        )


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask_fn) -> torch.Tensor:
    """(B, S, H, D) q, k, v -> (B, S, H*D): fp32 logits scaled by 1/sqrt(D), masked by
    ``mask_fn(logits)``, softmax over keys, then the weighted sum of v."""
    b, s, h, d = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    weights = torch.softmax(mask_fn(logits), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, s, h * d)


def mean_pool_normalize(x: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Mean over valid tokens, then L2 normalisation (the sentence-transformers head)."""
    mask = attention_mask[..., None].to(x.dtype)
    pooled = torch.sum(x * mask, dim=1) / torch.clamp_min(torch.sum(mask, dim=1), 1e-9)
    return l2_normalize(pooled)


def l2_normalize(pooled: torch.Tensor) -> torch.Tensor:
    return pooled / torch.clamp_min(torch.linalg.vector_norm(pooled, dim=-1, keepdim=True), 1e-12)


class _Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig, generator: torch.Generator) -> None:
        super().__init__()
        h = cfg.hidden_size
        self.word = normal((cfg.vocab_size, h), generator)
        self.position = normal((cfg.max_position_embeddings, h), generator)
        self.token_type = normal((cfg.type_vocab_size, h), generator)
        self.ln = LayerNorm(h, cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        s = input_ids.shape[1]
        # Every token has type 0: token_type[0] broadcast is JAX's gather of row 0.
        x = F.embedding(input_ids, self.word) + self.position[:s][None] + self.token_type[0]
        return self.ln(x)


class _Layer(nn.Module):
    def __init__(self, cfg: BertConfig, generator: torch.Generator) -> None:
        super().__init__()
        h, i, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        self.num_heads = cfg.num_heads
        self.q = Linear(h, h, generator)
        self.k = Linear(h, h, generator)
        self.v = Linear(h, h, generator)
        self.attn_out = Linear(h, h, generator)
        self.attn_ln = LayerNorm(h, eps)
        self.ffn_up = Linear(h, i, generator)
        self.ffn_down = Linear(i, h, generator)
        self.ffn_ln = LayerNorm(h, eps)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        b, s, h = x.shape
        shape = (b, s, self.num_heads, h // self.num_heads)
        q, k, v = (proj(x).view(shape) for proj in (self.q, self.k, self.v))
        ctx = attention(q, k, v, lambda logits: logits + attn_bias)
        x = self.attn_ln(x + self.attn_out(ctx))
        return self.ffn_ln(x + self.ffn_down(F.gelu(self.ffn_up(x))))


class BertEncoder(nn.Module):
    """(B, S) int ids + int mask (1 = valid) -> (B, hidden) L2-normalised sentence embeddings."""

    def __init__(self, cfg: BertConfig, generator: torch.Generator | None = None) -> None:
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        self.config = cfg
        self.embeddings = _Embeddings(cfg, generator)
        self.layers = nn.ModuleList(_Layer(cfg, generator) for _ in range(cfg.num_layers))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        check_int_mask(attention_mask)
        x = self.embeddings(input_ids)
        neg = torch.finfo(torch.float32).min
        attn_bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, neg)
        for layer in self.layers:
            x = layer(x, attn_bias)
        return mean_pool_normalize(x, attention_mask)
