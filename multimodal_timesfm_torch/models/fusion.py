"""Addition-based multimodal fusion MLP.

Counterpart of ``multimodal_timesfm_tpu/models/fusion.py``: a 1-3 layer
bias-free Linear+ReLU MLP projecting text embedding dims -> ts embedding
dims, added element-wise to the patch embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from multimodal_timesfm_torch.models.layers import Dense, dense, relu


@dataclasses.dataclass(frozen=True)
class FusionSpec:
    """Fusion MLP geometry.

    Raises (at construction): ValueError for num_layers outside 1..3 or a
    hidden_dims length mismatch.
    """

    ts_embedding_dims: int
    text_embedding_dims: int
    num_layers: int = 1
    hidden_dims: tuple[int, ...] = ()

    def __post_init__(self) -> None:
        if self.num_layers < 1 or self.num_layers > 3:
            raise ValueError(f"num_layers must be between 1 and 3, got {self.num_layers}")
        if len(self.hidden_dims) != self.num_layers - 1:
            raise ValueError(
                f"hidden_dims must have {self.num_layers - 1} elements for "
                f"{self.num_layers} layers, got {len(self.hidden_dims)}"
            )

    @property
    def dims(self) -> tuple[int, ...]:
        return (self.text_embedding_dims, *self.hidden_dims, self.ts_embedding_dims)


def apply_fusion(
    weights: Sequence[torch.Tensor], ts_embeddings: torch.Tensor, text_embeddings: torch.Tensor
) -> torch.Tensor:
    """Project text embeddings through bias-free Linear+ReLU layers, add to ts embeddings."""
    h = text_embeddings.to(ts_embeddings.dtype)
    for weight in weights:
        h = relu(dense(h, weight))
    return ts_embeddings + h


class MultimodalFusion(nn.Module):
    def __init__(self, spec: FusionSpec, generator: torch.Generator) -> None:
        super().__init__()
        dims = spec.dims
        self.layers = nn.ModuleList(
            Dense(dims[i], dims[i + 1], generator, bias=False) for i in range(len(dims) - 1)
        )

    def forward(self, ts_embeddings: torch.Tensor, text_embeddings: torch.Tensor) -> torch.Tensor:
        return apply_fusion([layer.weight for layer in self.layers], ts_embeddings, text_embeddings)
