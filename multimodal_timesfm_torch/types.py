"""Data schemas shared between layers (framework-free copy of the JAX package's).

The ``text_embeddings`` key is optional: its presence selects multimodal over
baseline behaviour downstream.
"""

from __future__ import annotations

from typing import Any, NotRequired, TypedDict

import numpy as np
import numpy.typing as npt


class PreprocessedSample(TypedDict):
    """A single dataset sample after preprocessing (text already embedded)."""

    context: npt.NDArray[np.float32]
    horizon: npt.NDArray[np.float32]
    text_embeddings: NotRequired[npt.NDArray[np.float32]]
    metadata: dict[str, Any]
