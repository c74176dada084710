"""Chronos-2 backbone and its adapter.

Counterpart of ``multimodal_timesfm_tpu/models/chronos.py``. 120M geometry:
model_dim 768, 16 layers, 12 heads x 64, ffn 3072, patch 16/16, 64 future
patches (``max_output_patches``), 9 decile quantiles (0.5 at index 4, the
point forecast), 32 relative-position buckets up to distance 128.

  * preprocess standardizes each series over its valid points (instance
    norm), patches it with linear time encodings and its validity mask, and
    embeds ``[time, values, valid]`` through a ReLU residual MLP;
  * forward appends the [REG] token and ``max_output_patches`` zero future
    patches (embedded once at batch 1), runs the T5-style encoder
    (bidirectional attention with a relative-position bias, RMS pre-norms,
    ReLU FFN) and returns the future patches' hidden states;
  * postprocess projects the first ``ceil(horizon / 16)`` of them to
    quantiles, undoes the instance norm and slices the horizon; a horizon
    beyond ``max_output_patches * output_patch_size`` raises.

Attention on a CUDA tensor is the hand-written kernel
(``ops/chronos_attention.py``, B4f/B4b); on a CPU tensor it is the plain
composition of JAX's default encoder path (composed fp32 softmax, weights
cast to the compute dtype). The two agree on every valid token; on a padded
token (never read: the output is the future patches, always valid) the
kernel lets the query attend itself and the plain path every valid key, as
JAX's kernel and XLA paths do.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from multimodal_timesfm_torch.models.base import PreprocessResult, TsfmAdapter
from multimodal_timesfm_torch.models.layers import Dense, ResidualBlock, RMSNorm, dense, relu, xavier_uniform
from multimodal_timesfm_torch.ops.attention import NEG_INF, takes_kernels
from multimodal_timesfm_torch.ops.chronos_attention import fused_chronos_attention
from multimodal_timesfm_torch.ops.patching import patchify
from multimodal_timesfm_torch.ops.qkv_attention import split_heads
from multimodal_timesfm_torch.parallel.collectives import copy_to_model, scatter_to_model

_SCALE_EPS = 1e-10


@dataclasses.dataclass(frozen=True)
class Chronos2Config:
    """Architecture hyperparameters. Defaults = the 120M geometry.

    ``max_output_patches`` future-patch tokens always run through the
    encoder (bidirectional keys of every context token), so a smaller value
    changes the outputs, not only the cost (PARITY.md). ``pack`` > 1 packs
    that many series into one encoder row as attention segments (numerically
    the same as ``pack=1``); ``remat`` recomputes each encoder layer in the
    backward instead of keeping its activations.
    """

    model_dim: int = 768
    num_layers: int = 16
    num_heads: int = 12
    ffn_dim: int = 3072
    input_patch_size: int = 16
    output_patch_size: int = 16
    max_output_patches: int = 64
    time_encoding_scale: float = 1000.0
    use_reg_token: bool = True
    reg_token_id: int = 0
    vocab_size: int = 2  # the special-token table ("shared")
    quantiles: tuple[float, ...] = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
    rel_pos_buckets: int = 32
    rel_pos_max_distance: int = 128
    pack: int = 1
    remat: bool = False
    compute_dtype: torch.dtype = torch.float32

    def __post_init__(self) -> None:
        # _relative_bucket divides by max_exact = buckets // 4: below 4
        # buckets that is a division by zero.
        if self.rel_pos_buckets < 4:
            raise ValueError(f"rel_pos_buckets must be >= 4, got {self.rel_pos_buckets}")
        # The future patches are built at output_patch_size but embedded by
        # the same input_patch_embedding as the context patches.
        if self.input_patch_size != self.output_patch_size:
            raise ValueError(
                "Chronos-2 requires input_patch_size == output_patch_size "
                f"(got {self.input_patch_size} != {self.output_patch_size}): "
                "the shared input_patch_embedding embeds both context and "
                "future patches. Adjust the horizon via max_output_patches."
            )

    @property
    def num_quantiles(self) -> int:
        return len(self.quantiles)

    @property
    def head_dim(self) -> int:
        return self.model_dim // self.num_heads

    @classmethod
    def tiny(cls) -> "Chronos2Config":
        """A CPU-testable miniature with the same wiring."""
        return cls(
            model_dim=32,
            num_layers=2,
            num_heads=2,
            ffn_dim=64,
            input_patch_size=4,
            output_patch_size=4,
            max_output_patches=4,
        )


def instance_norm_stats(context: torch.Tensor, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and std over the valid points, each (B, 1); the count is at least 1 and a
    scale below 1e-10 (a constant series) becomes 1."""
    valid = valid.to(context.dtype)
    n = torch.clamp_min(valid.sum(dim=-1, keepdim=True), 1.0)
    loc = (context * valid).sum(dim=-1, keepdim=True) / n
    var = (valid * (context - loc) ** 2).sum(dim=-1, keepdim=True) / n
    scale = torch.sqrt(var)
    return loc, torch.where(scale < _SCALE_EPS, torch.ones_like(scale), scale)


def instance_norm_inverse(x: torch.Tensor, loc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Undo the standardization; (B, 1) stats broadcast over the trailing dims of (B, ...)."""
    extra = (1,) * (x.dim() - loc.dim())
    return x * scale.reshape(*scale.shape, *extra) + loc.reshape(*loc.shape, *extra)


def _relative_bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5 bidirectional relative-position bucket of ``rel`` = key - query.

    The log ratio is taken in float32 with a float32 denominator, as JAX
    computes it, and truncated to int32: a float64 ``math.log`` could move a
    distance at a bucket boundary into the next bucket.
    """
    num = num_buckets // 2
    ret = torch.where(rel > 0, num, 0)
    rel = rel.abs()
    max_exact = num // 2
    denom = torch.log(torch.tensor(max_distance / max_exact, dtype=torch.float32))
    log_ratio = torch.log(rel.clamp_min(1).to(torch.float32) / max_exact) / denom
    large = (max_exact + (log_ratio * (num - max_exact)).to(torch.int32)).clamp_max(num - 1)
    return ret + torch.where(rel < max_exact, rel, large)


def _bucket_table(seq: int, num_buckets: int, max_distance: int, device: torch.device) -> torch.Tensor:
    pos = torch.arange(seq)
    return _relative_bucket(pos[None, :] - pos[:, None], num_buckets, max_distance).to(device)


@functools.lru_cache(maxsize=32)
def _cached_buckets(seq: int, num_buckets: int, max_distance: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return _bucket_table(seq, num_buckets, max_distance, device)


def _buckets(seq: int, num_buckets: int, max_distance: int, device: torch.device) -> torch.Tensor:
    """(S, S) bucket of key - query, computed on the CPU once per length and device.

    Made outside inference mode even when first asked for inside it, so that
    a later differentiated call can index with the cached tensor. While
    ``torch.export`` traces, the table is computed in the graph and not
    cached (a traced tensor must not outlive its trace).
    """
    if torch.compiler.is_compiling():
        return _bucket_table(seq, num_buckets, max_distance, device)
    return _cached_buckets(seq, num_buckets, max_distance, device)


class ChronosAttention(nn.Module):
    """The encoder's q, k, v and out projections (no bias); see :class:`ChronosEncoderLayer`."""

    def __init__(self, model_dim: int, generator: torch.Generator) -> None:
        super().__init__()
        self.q = Dense(model_dim, model_dim, generator, bias=False)
        self.k = Dense(model_dim, model_dim, generator, bias=False)
        self.v = Dense(model_dim, model_dim, generator, bias=False)
        self.out = Dense(model_dim, model_dim, generator, bias=False)


class ChronosEncoderLayer(nn.Module):
    """RMS norm -> T5 attention -> residual; RMS norm -> ReLU FFN -> residual."""

    def __init__(self, cfg: Chronos2Config, generator: torch.Generator) -> None:
        super().__init__()
        self.num_heads, self.head_dim = cfg.num_heads, cfg.head_dim
        self.attn_norm = RMSNorm(cfg.model_dim)
        self.attn = ChronosAttention(cfg.model_dim, generator)
        self.ffn_norm = RMSNorm(cfg.model_dim)
        self.ffn_up = Dense(cfg.model_dim, cfg.ffn_dim, generator, bias=False)
        self.ffn_down = Dense(cfg.ffn_dim, cfg.model_dim, generator, bias=False)

    def forward(self, h: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``mask``: on the kernel route (``ops.attention.takes_kernels``: the card, or the
        CPU while exporting) the (B, S) int32 segment ids of the kernel; otherwise the
        additive fp32 key mask (0 or finfo.min) of JAX's composition."""
        attn = self.attn
        normed = self.attn_norm(h)
        if attn.q.parallel is not None:
            # Column-parallel q, k, v: this rank's heads, from a replicated input.
            normed = copy_to_model(normed, attn.q.parallel[1])
        # One GEMM over the concatenated q|k|v weights: its (B, S, 3*H*D) output
        # is what the kernel reads in place (JAX's fused path concatenates too).
        # H is this rank's heads: all of them, or H/mp under tensor parallelism,
        # with ``bias`` this rank's (H/mp, S, S) slice.
        qkv = dense(normed, torch.cat([attn.q.weight, attn.k.weight, attn.v.weight]))
        if takes_kernels(h):
            ctx = fused_chronos_attention(qkv, mask, bias)
        else:
            q, k, v = split_heads(qkv, attn.q.weight.shape[0] // self.head_dim, self.head_dim)
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + bias[None] + mask
            # The composed fp32 softmax of JAX's default path, cast once.
            weights = torch.softmax(logits, dim=-1).to(h.dtype)
            ctx = torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float()).flatten(-2)
        h = h + attn.out(ctx.to(h.dtype))
        return h + self.ffn_down(relu(self.ffn_up(self.ffn_norm(h))))


class ChronosEncoder(nn.Module):
    """The T5-style encoder: layers, the (buckets, H) bias table and the final RMS norm.

    ``rel_pos_bias`` is a plain parameter (not an ``nn.Embedding`` weight),
    so the weight bridge keeps its JAX layout.
    """

    def __init__(self, cfg: Chronos2Config, generator: torch.Generator) -> None:
        super().__init__()
        self.config = cfg
        self.layers = nn.ModuleList(ChronosEncoderLayer(cfg, generator) for _ in range(cfg.num_layers))
        self.rel_pos_bias = nn.Parameter(
            xavier_uniform((cfg.rel_pos_buckets, cfg.num_heads), generator)
        )
        self.final_norm = RMSNorm(cfg.model_dim)

    def forward(
        self, x: torch.Tensor, attention_mask: torch.Tensor, segment_ids: torch.Tensor | None = None
    ) -> torch.Tensor:
        """Bidirectional encoder (JAX ``chronos_encoder``).

        Args:
            x: (B, S, model_dim).
            attention_mask: (B, S), 1 = valid.
            segment_ids: optional (B, S) int; tokens attend only within their segment.

        Returns:
            (B, S, model_dim) in the compute dtype.
        """
        cfg = self.config
        batch, seq, _ = x.shape
        buckets = _buckets(seq, cfg.rel_pos_buckets, cfg.rel_pos_max_distance, x.device)
        # (H, S, S) fp32, gathered once per call: autograd sums its cotangent
        # over the layers into the (buckets, H) table. Under tensor parallelism
        # the replicated table is cut to this rank's heads, and its gradient
        # summed over the model axis.
        table = self.rel_pos_bias
        q = self.layers[0].attn.q if len(self.layers) else None
        if q is not None and q.parallel is not None:
            table = scatter_to_model(table, q.parallel[1], dim=1)
        bias = table[buckets].permute(2, 0, 1).float().contiguous()
        valid = attention_mask > 0
        if takes_kernels(x):
            # Attention-group ids: the segment for a valid token, an id of its
            # own (negative) for a padded one, which then attends only itself.
            base = torch.zeros_like(valid, dtype=torch.int32) if segment_ids is None else segment_ids
            own = -1 - torch.arange(seq, dtype=torch.int32, device=x.device)
            mask = torch.where(valid, base.to(torch.int32), own).contiguous()
        else:
            allowed = valid[:, None, None, :]
            if segment_ids is not None:
                allowed = allowed & (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
            mask = torch.zeros(allowed.shape, dtype=torch.float32, device=x.device).masked_fill(
                ~allowed, NEG_INF
            )
        h = x.to(cfg.compute_dtype)
        for layer in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                h = checkpoint(layer, h, bias, mask, use_reentrant=False)
            else:
                h = layer(h, bias, mask)
        return self.final_norm(h)


class Chronos2Adapter(TsfmAdapter):
    """The Chronos-2 backbone behind the adapter contract.

    Parameters are initialised on the CPU from ``generator`` (seed 0 when
    none is given); move the module with ``.to(device)``. ``shared`` (the
    [REG] token table) is a plain parameter, kept in its JAX layout by the
    weight bridge.
    """

    def __init__(
        self, config: Chronos2Config | None = None, generator: torch.Generator | None = None
    ) -> None:
        super().__init__()
        cfg = self.config = config or Chronos2Config()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_patch_embedding = ResidualBlock(
            3 * cfg.input_patch_size, cfg.ffn_dim, cfg.model_dim, gen, act=relu
        )
        self.shared = nn.Parameter(xavier_uniform((cfg.vocab_size, cfg.model_dim), gen))
        self.encoder = ChronosEncoder(cfg, gen)
        self.output_patch_embedding = ResidualBlock(
            cfg.model_dim, cfg.ffn_dim, cfg.num_quantiles * cfg.output_patch_size, gen, act=relu
        )

    @staticmethod
    def config_from_hf(hf_config: dict) -> Chronos2Config:
        from multimodal_timesfm_torch.models.snapshot import chronos2_config_from_hf

        return chronos2_config_from_hf(hf_config)

    @property
    def model_dims(self) -> int:
        return self.config.model_dim

    @property
    def patch_len(self) -> int:
        return self.config.input_patch_size

    @property
    def point_forecast_index(self) -> int:
        return self.config.quantiles.index(0.5)

    @property
    def quantile_loss_spec(self) -> tuple[tuple[float, ...], int | None]:
        """Every output channel is a quantile; there is no mean channel."""
        return self.config.quantiles, None

    def preprocess(self, inputs: torch.Tensor, masks: torch.Tensor) -> PreprocessResult:
        """Normalize, patch, time-encode and embed.

        Args:
            inputs: (B, C) float series; C must be a multiple of the patch size.
            masks: (B, C) bool, True = padded.
        """
        cfg = self.config
        if masks.shape != inputs.shape:
            raise ValueError(f"masks shape {tuple(masks.shape)} must match inputs shape {tuple(inputs.shape)}")
        batch, context = inputs.shape
        p = cfg.input_patch_size
        valid = (~masks).to(inputs.dtype)  # 1.0 = valid
        loc, scale = instance_norm_stats(inputs, valid)
        normed = (inputs - loc) / scale * valid
        # Context time encodings end just before the forecast origin at 0.
        time_enc = torch.arange(-context, 0, dtype=torch.float32, device=inputs.device)
        time_enc = (time_enc / cfg.time_encoding_scale)[None].expand(batch, context)
        features = torch.cat([patchify(time_enc, p), patchify(normed, p), patchify(valid, p)], dim=-1)
        input_embeds = self.input_patch_embedding(features.to(cfg.compute_dtype))
        # A patch is valid iff any of its points is.
        patch_valid = patchify(valid, p).amax(dim=-1)
        return PreprocessResult(
            input_embeddings=input_embeds,
            masks=patch_valid == 0,
            normalization_stats={"loc": loc, "scale": scale},
        )

    def forward(
        self, input_embeddings: torch.Tensor, masks: torch.Tensor, pack: int | None = None
    ) -> torch.Tensor:
        """Append [REG] and the future patches, run the encoder, return the future patches.

        ``masks`` is the per-patch bool mask from preprocess (True = padded).
        ``pack=k`` packs groups of k consecutive batch rows into one encoder
        row as k attention segments (the batch must divide by k); the default
        is the config's ``pack``. Returns (B, max_output_patches, model_dim).
        """
        cfg = self.config
        pack = cfg.pack if pack is None else pack
        if pack < 1:
            raise ValueError(f"pack must be >= 1, got {pack}")
        batch = input_embeddings.shape[0]
        dtype, device = input_embeddings.dtype, input_embeddings.device
        n_out, out_p = cfg.max_output_patches, cfg.output_patch_size

        future_time_enc = (
            torch.arange(n_out * out_p, dtype=torch.float32, device=device) / cfg.time_encoding_scale
        ).reshape(1, n_out, out_p).to(dtype)
        zeros = torch.zeros((1, n_out, out_p), dtype=dtype, device=device)
        # The future rows are the same for every series: embedded once, at batch 1.
        future_embeds = self.input_patch_embedding(
            torch.cat([future_time_enc, zeros, zeros], dim=-1)
        ).expand(batch, n_out, cfg.model_dim)

        attention_mask = (~masks).to(dtype)  # (B, Nc), 1 = valid
        ones = torch.ones((batch, n_out), dtype=dtype, device=device)
        if cfg.use_reg_token:
            reg = self.shared[cfg.reg_token_id].to(dtype).expand(batch, 1, cfg.model_dim)
            embeds = torch.cat([input_embeddings, reg, future_embeds], dim=-2)
            attention_mask = torch.cat([attention_mask, ones[:, :1], ones], dim=-1)
        else:
            embeds = torch.cat([input_embeddings, future_embeds], dim=-2)
            attention_mask = torch.cat([attention_mask, ones], dim=-1)

        if pack == 1:
            return self.encoder(embeds, attention_mask)[:, -n_out:]
        if batch % pack != 0:
            raise ValueError(f"batch ({batch}) must be divisible by pack ({pack})")
        groups, seq = batch // pack, embeds.shape[1]
        segment_ids = torch.arange(pack, dtype=torch.int32, device=device).repeat_interleave(seq)
        hidden = self.encoder(
            embeds.reshape(groups, pack * seq, cfg.model_dim),
            attention_mask.reshape(groups, pack * seq),
            segment_ids[None].expand(groups, pack * seq),
        )
        hidden = hidden.reshape(groups, pack, seq, cfg.model_dim)[:, :, -n_out:]
        return hidden.reshape(batch, n_out, cfg.model_dim)

    def postprocess(
        self,
        horizon: int,
        output_embeddings: torch.Tensor,
        normalization_stats: dict[str, torch.Tensor],
    ) -> torch.Tensor:
        """Quantile head, inverse instance norm, horizon slice: (B, horizon, num_quantiles).

        Raises:
            ValueError: if horizon > max_output_patches * output_patch_size.
        """
        cfg = self.config
        max_horizon = cfg.max_output_patches * cfg.output_patch_size
        if horizon > max_horizon:
            raise ValueError(
                f"horizon ({horizon}) exceeds the maximum prediction length "
                f"({max_horizon} = {cfg.max_output_patches} patches * {cfg.output_patch_size} steps)."
            )
        batch = output_embeddings.shape[0]
        q, out_p = cfg.num_quantiles, cfg.output_patch_size
        # Only the first ceil(horizon / out_p) patches survive the slice, and the
        # head's weights are shared across patches: only those are projected.
        n_h = math.ceil(horizon / out_p)
        preds = self.output_patch_embedding(output_embeddings[:, :n_h]).float()
        preds = preds.reshape(batch, n_h, q, out_p).permute(0, 2, 1, 3).reshape(batch, q, n_h * out_p)
        preds = instance_norm_inverse(
            preds, normalization_stats["loc"], normalization_stats["scale"]
        )
        return preds[:, :, :horizon].permute(0, 2, 1)
