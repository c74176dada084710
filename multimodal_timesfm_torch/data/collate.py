"""Stack samples into dense host arrays (framework-free copy of the JAX package's)."""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import numpy as np

from multimodal_timesfm_torch.types import PreprocessedSample


@dataclasses.dataclass
class StackedDataset:
    """Whole dataset as dense arrays. ``text_embeddings is None`` = baseline mode."""

    context: np.ndarray  # (S, C) float32
    horizon: np.ndarray  # (S, H) float32
    text_embeddings: np.ndarray | None  # (S, N, T) float32
    metadata: list[dict[str, Any]]

    def __len__(self) -> int:
        return self.context.shape[0]


def stack_samples(samples: Iterable[PreprocessedSample], multimodal: bool) -> StackedDataset:
    """Stack samples; in multimodal mode every sample must carry text embeddings."""
    samples = list(samples)
    if not samples:
        raise RuntimeError("Dataset is empty.")
    context = np.stack([np.asarray(s["context"], np.float32) for s in samples])
    horizon = np.stack([np.asarray(s["horizon"], np.float32) for s in samples])
    text = None
    if multimodal:
        text = np.stack([np.asarray(s["text_embeddings"], np.float32) for s in samples])
    return StackedDataset(
        context=context,
        horizon=horizon,
        text_embeddings=text,
        metadata=[s["metadata"] for s in samples],
    )
