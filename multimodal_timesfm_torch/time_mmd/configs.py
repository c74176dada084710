"""Time-MMD run configuration: the forecast windows and the model selection.

The port's copy of ``examples/time_mmd/configs/{forecast,model}.py``, reading
the same YAML files (``examples/time_mmd/configs/models/*.yml``) through
``utils/yaml.py``, which reads a JSON file without PyYAML.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Literal

from multimodal_timesfm_torch.utils.yaml import load_yaml, parse_yaml


@dataclass
class ForecastConfig:
    context_len: int = 32
    horizon_len: int = 32

    @classmethod
    def from_yaml(cls, path: Path | str) -> ForecastConfig:
        return parse_yaml(Path(path), cls)


@dataclass
class AdapterConfig:
    """TSFM adapter selection + geometry; ``arch`` overrides backbone config fields."""

    type: Literal["chronos", "timesfm"] = "timesfm"
    pretrained_repo: str = "google/timesfm-2.5-200m-pytorch"
    patch_len: int = 32
    arch: dict = field(default_factory=dict)


@dataclass
class FusionConfig:
    """Fusion head + text encoder selection."""

    text_encoder_type: Literal["english", "japanese"] = "english"
    text_embedding_dims: int = 384
    num_fusion_layers: int = 1
    fusion_hidden_dims: list[int] = field(default_factory=list)


@dataclass
class ModelConfig:
    adapter: AdapterConfig = field(default_factory=AdapterConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)

    @classmethod
    def from_yaml(cls, path: Path | str) -> ModelConfig:
        config_dict = load_yaml(path)
        return cls(
            adapter=AdapterConfig(**config_dict.get("adapter", {})),
            fusion=FusionConfig(**config_dict.get("fusion", {})),
        )
