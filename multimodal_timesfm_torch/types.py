"""Data schemas shared between layers (framework-free copy of the JAX package's).

The ``text_embeddings`` key is optional: its presence selects multimodal over
baseline behaviour downstream. Checkpoint payloads keep the JAX package's
keys; their parameter trees are numpy arrays in JAX layout
(``models/bridge.export_jax_params``).
"""

from __future__ import annotations

from typing import Any, Literal, NotRequired, TypedDict

import numpy as np
import numpy.typing as npt
import torch

TrainingMode = Literal["multimodal", "baseline"]


class RawSample(TypedDict):
    """A single raw dataset sample before preprocessing: per-patch texts, not yet embedded."""

    context: npt.NDArray[np.float32]
    horizon: npt.NDArray[np.float32]
    patched_texts: list[list[str]]
    metadata: dict[str, Any]


class PreprocessedSample(TypedDict):
    """A single dataset sample after preprocessing (text already embedded)."""

    context: npt.NDArray[np.float32]
    horizon: npt.NDArray[np.float32]
    text_embeddings: NotRequired[npt.NDArray[np.float32]]
    metadata: dict[str, Any]


class Batch(TypedDict):
    """A collated batch: tensors on the host or the device (JAX ``types.Batch``, whose
    arrays are numpy or jax). ``text_embeddings`` is present in multimodal mode."""

    context: torch.Tensor
    horizon: torch.Tensor
    text_embeddings: NotRequired[torch.Tensor]
    metadata: list[dict[str, Any]]


class CheckpointBase(TypedDict):
    """Fields shared by both checkpoint kinds."""

    epoch: int
    global_step: int
    optimizer_state: Any
    best_val_loss: float


class MultimodalCheckpoint(CheckpointBase):
    """Multimodal mode: the fusion parameters only."""

    fusion_params: Any


class BaselineCheckpoint(CheckpointBase):
    """Baseline mode: the adapter parameters only."""

    adapter_params: Any


class EvaluationMetrics(TypedDict):
    """MSE and MAE; ``wql``/``mean_pinball`` when quantile metrics are asked for."""

    mse: float
    mae: float
    wql: NotRequired[float]
    mean_pinball: NotRequired[float]
