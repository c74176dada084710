"""ModernBERT encoder (the ruri-v3-310m geometry) as a PyTorch module.

Counterpart of the JAX package's ``text/modernbert.py``, computing what
``modernbert_encode`` computes, op by op, in fp32: RoPE in place of learned
positions (angles formed in fp32 on the device as JAX forms them, theta
160,000 on the global layers and 10,000 on the local ones), pre-norm
bias-free LayerNorms (eps 1e-5; layer 0 has no attention norm), a GeGLU FFN
with exact GELU, global attention every third layer and a local window
|i - j| <= window/2 elsewhere, applied as a ``where`` against
``finfo(float32).min`` together with the key mask; then mean (or CLS)
pooling and L2 normalisation.

310M defaults: hidden 768, 25 layers, 12 heads, GeGLU intermediate 3072,
vocab 102,400, window 128. The parameter names are the JAX tree's
(``embeddings/{word,norm}``, a ``layers`` list, ``final_norm``), for
``models/bridge.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_timesfm_torch.text.bert import (
    LayerNorm,
    Linear,
    attention,
    check_int_mask,
    l2_normalize,
    mean_pool_normalize,
    normal,
)


@dataclasses.dataclass(frozen=True)
class ModernBertConfig:
    vocab_size: int = 102400
    hidden_size: int = 768
    num_layers: int = 25
    num_heads: int = 12
    intermediate_size: int = 3072  # GeGLU: Wi projects to 2x this
    global_attn_every_n_layers: int = 3
    local_attention_window: int = 128
    global_rope_theta: float = 160000.0
    local_rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-5
    pooling: str = "mean"  # or "cls"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def is_global_layer(self, i: int) -> bool:
        return i % self.global_attn_every_n_layers == 0

    @classmethod
    def ruri_v3_310m(cls) -> "ModernBertConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "ModernBertConfig":
        return cls(
            vocab_size=128,
            hidden_size=16,
            num_layers=4,
            num_heads=2,
            intermediate_size=32,
            local_attention_window=4,
        )


def rope_tables(seq: int, dim: int, theta: float, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the rotary angles, (1, S, 1, dim/2), in fp32 as JAX forms them."""
    half = dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))
    angles = torch.arange(seq, dtype=torch.float32, device=device)[:, None] * freqs[None, :]
    return torch.cos(angles)[None, :, None, :], torch.sin(angles)[None, :, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of the last axis of (B, S, H, D)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class _Embeddings(nn.Module):
    def __init__(self, cfg: ModernBertConfig, generator: torch.Generator) -> None:
        super().__init__()
        self.word = normal((cfg.vocab_size, cfg.hidden_size), generator)
        self.norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, bias=False)


class _Layer(nn.Module):
    def __init__(self, cfg: ModernBertConfig, index: int, generator: torch.Generator) -> None:
        super().__init__()
        h, i2, eps = cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps
        self.num_heads = cfg.num_heads
        self.is_global = cfg.is_global_layer(index)
        # Layer 0 has no attention norm: the embedding norm precedes it.
        self.attn_norm = LayerNorm(h, eps, bias=False) if index > 0 else None
        self.wqkv = Linear(h, 3 * h, generator, bias=False)
        self.wo = Linear(h, h, generator, bias=False)
        self.mlp_norm = LayerNorm(h, eps, bias=False)
        self.mlp_wi = Linear(h, 2 * i2, generator, bias=False)
        self.mlp_wo = Linear(i2, h, generator, bias=False)

    def forward(
        self, x: torch.Tensor, rope: tuple[torch.Tensor, torch.Tensor], allowed: torch.Tensor
    ) -> torch.Tensor:
        b, s, h = x.shape
        y = x if self.attn_norm is None else self.attn_norm(x)
        qkv = self.wqkv(y).view(b, s, 3, self.num_heads, h // self.num_heads)
        q, k, v = qkv.unbind(2)
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
        neg = torch.finfo(torch.float32).min
        x = x + self.wo(attention(q, k, v, lambda logits: torch.where(allowed, logits, neg)))
        inp, gate = self.mlp_wi(self.mlp_norm(x)).chunk(2, dim=-1)
        return x + self.mlp_wo(F.gelu(inp) * gate)


class ModernBertEncoder(nn.Module):
    """(B, S) int ids + int mask (1 = valid) -> (B, hidden) L2-normalised sentence embeddings."""

    def __init__(self, cfg: ModernBertConfig, generator: torch.Generator | None = None) -> None:
        super().__init__()
        generator = generator or torch.Generator().manual_seed(0)
        self.config = cfg
        self.embeddings = _Embeddings(cfg, generator)
        self.layers = nn.ModuleList(_Layer(cfg, i, generator) for i in range(cfg.num_layers))
        self.final_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, bias=False)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        check_int_mask(attention_mask)
        cfg = self.config
        s, device = input_ids.shape[1], input_ids.device
        x = self.embeddings.norm(F.embedding(input_ids, self.embeddings.word))
        key_valid = attention_mask[:, None, None, :] > 0  # (B, 1, 1, S)
        pos = torch.arange(s, device=device)
        local_ok = torch.abs(pos[:, None] - pos[None, :]) <= cfg.local_attention_window // 2
        allowed = {True: key_valid, False: key_valid & local_ok[None, None]}
        ropes = {
            True: rope_tables(s, cfg.head_dim, cfg.global_rope_theta, device),
            False: rope_tables(s, cfg.head_dim, cfg.local_rope_theta, device),
        }
        for layer in self.layers:
            x = layer(x, ropes[layer.is_global], allowed[layer.is_global])
        x = self.final_norm(x)
        if cfg.pooling == "cls":
            return l2_normalize(x[:, 0])
        return mean_pool_normalize(x, attention_mask)


def convert_hf_modernbert_state(sd: dict[str, Any], cfg: ModernBertConfig) -> dict[str, Any]:
    """An HF ModernBERT state dict as the JAX-layout numpy tree (torch (out, in) -> (in, out)).

    Raises ``KeyError`` naming the first missing parameter; keys the tree does not
    use are ignored.
    """
    if any(k.startswith("model.") for k in sd):
        sd = {k.removeprefix("model."): v for k, v in sd.items()}

    def leaf(name: str) -> np.ndarray:
        if name not in sd:
            raise KeyError(f"{name} is missing from the ModernBERT state dict")
        return np.asarray(sd[name], np.float32)

    def kernel(name: str) -> dict[str, np.ndarray]:
        return {"kernel": np.ascontiguousarray(leaf(name).T)}

    tree: dict[str, Any] = {
        "embeddings": {
            "word": leaf("embeddings.tok_embeddings.weight"),
            "norm": {"scale": leaf("embeddings.norm.weight")},
        },
        "layers": [],
        "final_norm": {"scale": leaf("final_norm.weight")},
    }
    for i in range(cfg.num_layers):
        base = f"layers.{i}"
        layer: dict[str, Any] = {
            "wqkv": kernel(f"{base}.attn.Wqkv.weight"),
            "wo": kernel(f"{base}.attn.Wo.weight"),
            "mlp_norm": {"scale": leaf(f"{base}.mlp_norm.weight")},
            "mlp_wi": kernel(f"{base}.mlp.Wi.weight"),
            "mlp_wo": kernel(f"{base}.mlp.Wo.weight"),
        }
        if i > 0:
            layer["attn_norm"] = {"scale": leaf(f"{base}.attn_norm.weight")}
        tree["layers"].append(layer)
    return tree
