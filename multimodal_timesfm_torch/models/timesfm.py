"""TimesFM 2.5 backbone and its adapter.

Counterpart of ``multimodal_timesfm_tpu/models/timesfm.py``. 200M geometry:
input_patch_len p=32, output_patch_len o=128, model_dims 1280, ffn 1280, 20
layers, 16 heads x 80 head_dim, q=10 output channels (point + 9 deciles),
decode_index 5 (the median channel).

  * preprocess patches the context, computes causal masked running mean/std
    per patch, RevIN-normalizes, zero-fills padded positions and tokenizes
    ``[normed, mask]``;
  * forward runs the transformer stack with the per-patch mask taken from
    the last element of each patch mask;
  * postprocess projects the last patch only, reverses RevIN with its stats
    and reshapes to (B, o, q), sliced to the horizon; horizon > o raises.
"""

from __future__ import annotations

import dataclasses

import torch

from multimodal_timesfm_torch.models.base import PreprocessResult, TsfmAdapter
from multimodal_timesfm_torch.models.layers import ResidualBlock, StackedTransformer
from multimodal_timesfm_torch.ops.patching import patchify
from multimodal_timesfm_torch.ops.revin import masked_running_stats, revin


@dataclasses.dataclass(frozen=True)
class TimesFMConfig:
    """Architecture hyperparameters. Defaults = the 200M checkpoint geometry."""

    input_patch_len: int = 32
    output_patch_len: int = 128
    model_dims: int = 1280
    ffn_dims: int = 1280
    num_layers: int = 20
    num_heads: int = 16
    num_output_channels: int = 10  # point + 9 quantiles
    decode_index: int = 5  # median channel: the point forecast
    # Level per quantile channel (channels 1..; channel 0 is the mean).
    quantiles: tuple[float, ...] = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
    # Continuous quantile head (upstream ``output_projection_quantiles``).
    use_quantile_head: bool = False
    quantile_horizon: int = 1024
    compute_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.model_dims // self.num_heads

    @classmethod
    def tiny(cls) -> "TimesFMConfig":
        """A CPU-testable miniature with the same wiring."""
        return cls(
            input_patch_len=4,
            output_patch_len=8,
            model_dims=32,
            ffn_dims=32,
            num_layers=2,
            num_heads=2,
        )


class TimesFM2p5Adapter(TsfmAdapter):
    """The TimesFM backbone behind the adapter contract.

    Parameters are initialised on the CPU from ``generator`` (seed 0 when
    none is given); move the module with ``.to(device)``.
    """

    def __init__(
        self, config: TimesFMConfig | None = None, generator: torch.Generator | None = None
    ) -> None:
        super().__init__()
        cfg = self.config = config or TimesFMConfig()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.tokenizer = ResidualBlock(2 * cfg.input_patch_len, cfg.model_dims, cfg.model_dims, gen)
        self.stacked_xf = StackedTransformer(
            cfg.num_layers, cfg.model_dims, cfg.num_heads, cfg.head_dim, cfg.ffn_dims, gen
        )
        self.output_projection_point = ResidualBlock(
            cfg.model_dims, cfg.model_dims, cfg.output_patch_len * cfg.num_output_channels, gen
        )
        if cfg.use_quantile_head:
            self.output_projection_quantiles = ResidualBlock(
                cfg.model_dims, cfg.model_dims, cfg.quantile_horizon * cfg.num_output_channels, gen
            )

    @property
    def model_dims(self) -> int:
        return self.config.model_dims

    @property
    def patch_len(self) -> int:
        return self.config.input_patch_len

    @property
    def point_forecast_index(self) -> int:
        return self.config.decode_index

    @property
    def quantile_loss_spec(self) -> tuple[tuple[float, ...], int | None]:
        """(quantile levels, mean channel): the mean at channel 0, the levels on channels 1.."""
        if 1 + len(self.config.quantiles) != self.config.num_output_channels:
            raise ValueError(
                f"num_output_channels ({self.config.num_output_channels}) must be "
                f"1 + len(quantiles) ({len(self.config.quantiles)}) for quantile loss"
            )
        return self.config.quantiles, 0

    def preprocess(self, inputs: torch.Tensor, masks: torch.Tensor) -> PreprocessResult:
        """Patch, RevIN-normalize with causal running stats, and tokenize.

        Args:
            inputs: (B, C) float series; C must be a multiple of patch_len.
            masks: (B, C) bool, True = padded.
        """
        cfg = self.config
        if masks.shape != inputs.shape:
            raise ValueError(f"masks shape {tuple(masks.shape)} must match inputs shape {tuple(inputs.shape)}")
        patched_inputs = patchify(inputs, cfg.input_patch_len)
        patched_masks = patchify(masks, cfg.input_patch_len)

        context_mu, context_sigma = masked_running_stats(patched_inputs, patched_masks)
        normed = revin(patched_inputs, context_mu, context_sigma, reverse=False)
        normed = normed.masked_fill(patched_masks, 0.0)

        tokenizer_inputs = torch.cat([normed, patched_masks.to(normed.dtype)], dim=-1)
        input_embeddings = self.tokenizer(tokenizer_inputs.to(cfg.compute_dtype))
        return PreprocessResult(
            input_embeddings=input_embeddings,
            masks=patched_masks,
            normalization_stats={"context_mu": context_mu, "context_sigma": context_sigma},
        )

    def forward(self, input_embeddings: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """Run the transformer stack; per-patch mask = last element of each patch mask."""
        return self.stacked_xf(input_embeddings.to(self.config.compute_dtype), masks[..., -1])

    def _project_last_patch(
        self,
        head: ResidualBlock,
        horizon: int,
        out_len: int,
        output_embeddings: torch.Tensor,
        normalization_stats: dict[str, torch.Tensor],
    ) -> torch.Tensor:
        # Only the last patch's forecast is returned, so only it is projected.
        batch = output_embeddings.shape[0]
        output_ts = head(output_embeddings[:, -1:]).float()
        renormed = revin(
            output_ts,
            normalization_stats["context_mu"][:, -1:],
            normalization_stats["context_sigma"][:, -1:],
            reverse=True,
        ).reshape(batch, out_len, self.config.num_output_channels)
        return renormed[:, :horizon, :]

    def postprocess(
        self,
        horizon: int,
        output_embeddings: torch.Tensor,
        normalization_stats: dict[str, torch.Tensor],
    ) -> torch.Tensor:
        """Project to (o, q) channels, reverse RevIN, take the last patch sliced to horizon.

        Raises:
            ValueError: if horizon > output_patch_len.
        """
        cfg = self.config
        if horizon > cfg.output_patch_len:
            raise ValueError(
                f"horizon must be <= output_patch_len ({cfg.output_patch_len}), got {horizon}. "
                "For longer horizons use inference.Forecaster.forecast_autoregressive."
            )
        return self._project_last_patch(
            self.output_projection_point, horizon, cfg.output_patch_len,
            output_embeddings, normalization_stats,
        )

    def postprocess_quantiles(
        self,
        horizon: int,
        output_embeddings: torch.Tensor,
        normalization_stats: dict[str, torch.Tensor],
    ) -> torch.Tensor:
        """Full-horizon quantile forecasts via the continuous quantile head.

        Requires ``use_quantile_head=True``; horizons up to ``quantile_horizon``.
        """
        cfg = self.config
        if not cfg.use_quantile_head:
            raise ValueError("configure use_quantile_head=True to use the quantile head")
        if horizon > cfg.quantile_horizon:
            raise ValueError(
                f"horizon must be <= quantile_horizon ({cfg.quantile_horizon}), got {horizon}."
            )
        return self._project_last_patch(
            self.output_projection_quantiles, horizon, cfg.quantile_horizon,
            output_embeddings, normalization_stats,
        )
