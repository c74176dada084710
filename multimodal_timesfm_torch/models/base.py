"""Backbone-agnostic adapter contract.

Counterpart of ``multimodal_timesfm_tpu/models/base.py``. The pipeline is
``preprocess -> [fusion injection point] -> forward -> postprocess``. Unlike
the JAX package's stateless adapters, an adapter here is an ``nn.Module``
that holds its own parameters. Mask convention: True = padded.
"""

from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Any

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

    # -- the checkpoint surface (JAX ``models/base.py:96-127``): local paths only --

    def load_checkpoint(self, path: str | Path) -> None:
        """Load backbone weights from a local checkpoint directory or file into this
        module, strictly (``models/convert.py``)."""
        from multimodal_timesfm_torch.models.bridge import load_jax_params
        from multimodal_timesfm_torch.models.convert import load_backbone_checkpoint

        load_jax_params(self, load_backbone_checkpoint(path, self))

    @staticmethod
    def config_from_hf(hf_config: dict) -> Any:
        """This adapter's config dataclass from an HF ``config.json`` dict."""
        raise NotImplementedError

    @classmethod
    def from_pretrained(cls, path_or_repo: str | Path, config: Any = None) -> "TsfmAdapter":
        """The adapter with pretrained weights from a snapshot.

        ``path_or_repo`` is a local snapshot directory, a checkpoint file, or an
        HF repo id resolved against local caches (``models/snapshot.py``;
        nothing is downloaded). Without ``config``, a snapshot's
        ``config.json`` gives the geometry. Returns the adapter on the CPU,
        holding the weights (JAX returns ``(adapter, params)``).
        """
        from multimodal_timesfm_torch.models.snapshot import read_hf_config, resolve_snapshot_dir

        snapshot = resolve_snapshot_dir(path_or_repo)
        if config is None and snapshot.is_dir():
            hf = read_hf_config(snapshot)
            if hf is not None:
                config = cls.config_from_hf(hf)
        adapter = cls(config) if config is not None else cls()
        adapter.load_checkpoint(snapshot)
        return adapter
