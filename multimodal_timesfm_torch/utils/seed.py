"""Seeding: one call seeds Python's ``random``, numpy's and torch's global generators."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> None:
    """Seed ``random``, ``np.random`` and torch (the CPU and every CUDA device)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
