"""Backbone-agnostic adapter contract.

Counterpart of ``multimodal_timesfm_tpu/models/base.py``. The pipeline is
``preprocess -> [fusion injection point] -> forward -> postprocess``. Unlike
the JAX package's stateless adapters, an adapter here is an ``nn.Module``
that holds its own parameters. Mask convention: True = padded.
"""

from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod

import torch
from torch import nn


@dataclasses.dataclass
class PreprocessResult:
    """Result of adapter preprocessing.

    Attributes:
        input_embeddings: (B, num_patches, model_dims) tokenizer output, the
            fusion injection point.
        masks: per-patch-element bool masks, True = padded.
        normalization_stats: adapter-specific stats needed by postprocess.
    """

    input_embeddings: torch.Tensor
    masks: torch.Tensor
    normalization_stats: dict[str, torch.Tensor]


class TsfmAdapter(nn.Module, ABC):
    """Adapter for a time-series foundation model backbone."""

    @property
    @abstractmethod
    def model_dims(self) -> int:
        """Hidden dimension of the backbone transformer."""

    @property
    @abstractmethod
    def patch_len(self) -> int:
        """Raw time-series steps per input patch."""

    @property
    @abstractmethod
    def point_forecast_index(self) -> int:
        """Index into the last output dim that gives the point forecast."""

    @abstractmethod
    def preprocess(self, inputs: torch.Tensor, masks: torch.Tensor) -> PreprocessResult:
        """Patch/normalize/tokenize: (B, C) series -> (B, N, D) embeddings."""

    @abstractmethod
    def forward(self, input_embeddings: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """Run the backbone transformer stack over (possibly fused) embeddings."""

    @abstractmethod
    def postprocess(
        self,
        horizon: int,
        output_embeddings: torch.Tensor,
        normalization_stats: dict[str, torch.Tensor],
    ) -> torch.Tensor:
        """Project to forecasts: -> (B, horizon, num_output_channels)."""
