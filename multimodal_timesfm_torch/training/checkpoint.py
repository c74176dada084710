"""Checkpoint persistence: save, load and rotate, with the JAX package's policies.

Counterpart of ``multimodal_timesfm_tpu/training/checkpoint.py``, pickle
backend only. A payload is a dict of host values (numpy trees in JAX layout,
Python scalars); tensors are pulled to host numpy on save. Epoch checkpoints
are ``checkpoint_epoch_<n>.ckpt`` with ``save_total_limit`` rotation, the
best one is ``best_model.ckpt``. Unpickle only files this program wrote.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any

import torch

from multimodal_timesfm_torch.utils.logging import get_logger

_logger = get_logger()

CKPT_SUFFIX = ".ckpt"


def _to_host(node: Any) -> Any:
    if isinstance(node, torch.Tensor):
        return node.detach().cpu().numpy()
    if isinstance(node, dict):
        return {key: _to_host(value) for key, value in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_to_host(value) for value in node)
    return node


def save_checkpoint(path: Path, payload: dict) -> None:
    """Persist ``payload``; a crash mid-save never destroys an existing file at ``path``.

    The payload is written whole to a sibling temporary file first, then
    renamed over ``path``.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(_to_host(payload), f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)


def load_checkpoint(path: Path | str) -> dict:
    """Load a checkpoint written by :func:`save_checkpoint`."""
    with open(path, "rb") as f:
        return pickle.load(f)


def rotate_checkpoints(checkpoint_dir: Path, save_total_limit: int) -> None:
    """Delete the oldest epoch checkpoints beyond ``save_total_limit`` (0 deletes them all)."""
    checkpoints = sorted(
        Path(checkpoint_dir).glob(f"checkpoint_epoch_*{CKPT_SUFFIX}"),
        key=lambda p: int(p.stem.rsplit("_", 1)[-1]),
    )
    for checkpoint in checkpoints[: max(0, len(checkpoints) - save_total_limit)]:
        checkpoint.unlink()
        _logger.info("Deleted old checkpoint: %s", checkpoint.name)
