"""Multimodal decoder: the composition root of the forecasting pipeline.

Counterpart of ``multimodal_timesfm_tpu/models/decoder.py``. Pipeline:
``adapter.preprocess -> fusion (iff text_embeddings given) -> adapter.forward
-> adapter.postprocess``. The module holds two children, ``adapter`` and
``fusion``, the two subtrees the JAX package's params tree has.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from multimodal_timesfm_torch.models.base import TsfmAdapter
from multimodal_timesfm_torch.models.fusion import FusionSpec, MultimodalFusion
from multimodal_timesfm_torch.utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class MultimodalDecoderConfig:
    text_embedding_dims: int = 384
    num_fusion_layers: int = 1
    fusion_hidden_dims: tuple[int, ...] = ()


class MultimodalDecoder(nn.Module):
    """Adapter + fusion head.

    The module is moved to ``device``: CUDA by default, where its absence
    raises; pass ``device="cpu"`` to run on the CPU. The fusion MLP is
    initialised from ``generator`` (seed 0 when none is given).
    """

    def __init__(
        self,
        adapter: TsfmAdapter,
        config: MultimodalDecoderConfig | None = None,
        device: str | torch.device | None = None,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        target = resolve_device(device)
        self.config = config or MultimodalDecoderConfig()
        self.fusion_spec = FusionSpec(
            ts_embedding_dims=adapter.model_dims,
            text_embedding_dims=self.config.text_embedding_dims,
            num_layers=self.config.num_fusion_layers,
            hidden_dims=tuple(self.config.fusion_hidden_dims),
        )
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.adapter = adapter
        self.fusion = MultimodalFusion(self.fusion_spec, gen)
        self.to(target)

    def with_children(self, **children: nn.Module) -> "MultimodalDecoder":
        """A decoder that shares this one's config and children, except those given
        (``adapter=...``, ``fusion=...``)."""
        clone = copy.copy(self)
        clone._modules = {**self._modules, **children}
        return clone

    def _encode(
        self, inputs: torch.Tensor, masks: torch.Tensor, text_embeddings: torch.Tensor | None
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Shared prefix: validate -> preprocess -> fuse -> forward."""
        if masks.shape != inputs.shape:
            raise ValueError(f"masks shape {tuple(masks.shape)} must match inputs shape {tuple(inputs.shape)}")
        pre = self.adapter.preprocess(inputs, masks.to(torch.bool))
        embeddings = pre.input_embeddings
        if text_embeddings is not None:
            embeddings = self.fusion(embeddings, text_embeddings)
        return self.adapter(embeddings, pre.masks), pre.normalization_stats

    def forward_full(
        self,
        horizon: int,
        inputs: torch.Tensor,
        masks: torch.Tensor,
        text_embeddings: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """All output channels (B, horizon, num_outputs); fusion only when text is given."""
        output_embeddings, stats = self._encode(inputs, masks, text_embeddings)
        return self.adapter.postprocess(horizon, output_embeddings, stats)

    def forward_quantiles(
        self,
        horizon: int,
        inputs: torch.Tensor,
        masks: torch.Tensor,
        text_embeddings: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Long-horizon quantile forecasts via the adapter's quantile head."""
        postprocess_quantiles = getattr(self.adapter, "postprocess_quantiles", None)
        if postprocess_quantiles is None:
            raise NotImplementedError(
                f"{type(self.adapter).__name__} has no quantile head; use forward_full"
            )
        output_embeddings, stats = self._encode(inputs, masks, text_embeddings)
        return postprocess_quantiles(horizon, output_embeddings, stats)

    def forward(
        self,
        horizon: int,
        inputs: torch.Tensor,
        masks: torch.Tensor,
        text_embeddings: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Point forecast (B, horizon): the ``point_forecast_index`` channel."""
        full = self.forward_full(horizon, inputs, masks, text_embeddings)
        return full[..., self.adapter.point_forecast_index]
