"""Build the configured backbone and decoder for the Time-MMD CLIs.

The port's counterparts of ``examples/time_mmd/sweep_lib.py``
``build_adapter`` and ``init_decoder_params`` (``:77-127``), shared by the
forecast and export CLIs (and by the sweep CLIs when they are ported).
"""

from __future__ import annotations

from dataclasses import replace
from pathlib import Path

import torch

from multimodal_timesfm_torch.models.base import TsfmAdapter
from multimodal_timesfm_torch.models.bridge import load_jax_params, random_jax_params
from multimodal_timesfm_torch.models.chronos import Chronos2Adapter, Chronos2Config
from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
from multimodal_timesfm_torch.models.snapshot import read_hf_config, resolve_snapshot_dir
from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig
from multimodal_timesfm_torch.time_mmd.configs import ModelConfig
from multimodal_timesfm_torch.training.checkpoint import load_checkpoint
from multimodal_timesfm_torch.utils.logging import get_logger
from multimodal_timesfm_torch.utils.platform import resolve_device

_logger = get_logger()


def build_adapter(model_config: ModelConfig, pretrained_dir: str | None) -> TsfmAdapter:
    """The configured backbone adapter (on the CPU, weights not loaded yet).

    Geometry precedence: the YAML ``arch`` overrides, then the snapshot's own
    ``config.json`` (when ``pretrained_dir`` carries one; a path or an HF repo
    id resolved locally), then the dataclass defaults. A patch length that
    differs from ``model_config.adapter.patch_len`` (the one the caches were
    built with) raises.
    """
    arch = dict(model_config.adapter.arch)
    if pretrained_dir is not None:
        pretrained_dir = str(resolve_snapshot_dir(pretrained_dir))
    hf = read_hf_config(pretrained_dir) if pretrained_dir and Path(pretrained_dir).is_dir() else None
    if model_config.adapter.type == "timesfm":
        base = TimesFM2p5Adapter.config_from_hf(hf) if hf else TimesFMConfig()
        adapter: TsfmAdapter = TimesFM2p5Adapter(replace(base, **arch))
    elif model_config.adapter.type == "chronos":
        if "quantiles" in arch:
            arch["quantiles"] = tuple(arch["quantiles"])
        base_c = Chronos2Adapter.config_from_hf(hf) if hf else Chronos2Config()
        adapter = Chronos2Adapter(replace(base_c, **arch))
    else:
        raise NotImplementedError(f"Unsupported adapter type: {model_config.adapter.type!r}")
    if adapter.patch_len != model_config.adapter.patch_len:
        raise ValueError(
            f"adapter.patch_len ({adapter.patch_len}) does not match "
            f"model_config.adapter.patch_len ({model_config.adapter.patch_len}); "
            "the cached dataset was built with the config value — rebuild the cache or fix the config."
        )
    return adapter


def init_decoder_params(decoder: MultimodalDecoder, pretrained_dir: str | None, seed: int) -> None:
    """Draw the decoder's weights from ``seed`` (``bridge.random_jax_params``), then load
    the backbone from ``pretrained_dir`` when given (``models/convert.py``)."""
    load_jax_params(decoder, random_jax_params(decoder, seed))
    if pretrained_dir is not None:
        snapshot = resolve_snapshot_dir(pretrained_dir)
        decoder.adapter.load_checkpoint(snapshot)
        _logger.info("Loaded pretrained backbone from %s", snapshot)
    else:
        _logger.warning("No --pretrained-dir given: backbone is randomly initialized")


def apply_checkpoint(decoder: MultimodalDecoder, path: str | Path) -> list[str]:
    """Load every trained subtree a trainer checkpoint carries (``fusion_params``,
    ``adapter_params``; the port's or the JAX trainer's) into ``decoder``; returns the
    keys applied."""
    checkpoint = load_checkpoint(Path(path))
    applied = []
    for key, child in (("fusion_params", decoder.fusion), ("adapter_params", decoder.adapter)):
        if isinstance(checkpoint, dict) and key in checkpoint:
            load_jax_params(child, checkpoint[key])
            _logger.info("Loaded %s from %s", key, path)
            applied.append(key)
    return applied


def build_decoder(model_config: ModelConfig, pretrained_dir: str | None, seed: int,
                  device: str | torch.device | None = None) -> MultimodalDecoder:
    """The configured decoder with its weights (seeded, then the backbone from
    ``pretrained_dir``), moved to ``device`` (CUDA unless told otherwise)."""
    target = resolve_device(device)
    adapter = build_adapter(model_config, pretrained_dir)
    decoder = MultimodalDecoder(
        adapter,
        MultimodalDecoderConfig(text_embedding_dims=model_config.fusion.text_embedding_dims),
        device="cpu",
    )
    init_decoder_params(decoder, pretrained_dir, seed)
    return decoder.to(target)
