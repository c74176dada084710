"""Offline preprocessing: the text-embedding cache, readable by both packages.

Counterpart of the JAX package's ``data/preprocess.py``, with its cache-key
path scheme ``{dataset}_{entity}_{enc}_p{P}_c{C}_h{H}[_aug].pkl`` and its
pickle layout: a list of plain dicts holding numpy float32 arrays and Python
scalars, never tensors, so a cache written by either package loads in the
other. Each embedded sample's metadata carries the provenance stamp
``{"text_encoder": {"encoder": <class name>, "is_pretrained": bool}}``.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Callable

import numpy as np

from multimodal_timesfm_torch.data.dataset import MultimodalDatasetBase
from multimodal_timesfm_torch.types import PreprocessedSample
from multimodal_timesfm_torch.utils.logging import get_logger

_logger = get_logger()


class PreprocessPipeline:
    """End-to-end preprocessing: path generation, persistence, and execution."""

    def __init__(self, cache_dir: Path) -> None:
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)

    def get_path(
        self,
        dataset_name: str,
        entity: str,
        text_encoder_type: str,
        patch_len: int,
        context_len: int,
        horizon_len: int,
        augment: bool = False,
    ) -> Path:
        """Cache path for a configuration."""
        parts = [
            dataset_name,
            entity,
            text_encoder_type,
            f"p{patch_len}",
            f"c{context_len}",
            f"h{horizon_len}",
        ]
        if augment:
            parts.append("aug")
        return self.cache_dir / ("_".join(parts) + ".pkl")

    def load(
        self, path: Path, require_pretrained_embeddings: bool = False
    ) -> list[PreprocessedSample]:
        """Load a cache file.

        A cache whose provenance stamp says ``is_pretrained=False`` (built with
        random encoder weights and the hash tokenizer) loads with a warning, or
        raises ``ValueError`` when ``require_pretrained_embeddings`` is set.
        """
        _logger.info("Loading preprocessed data from %s", path)
        if not path.exists():
            raise FileNotFoundError(
                f"Cache file not found: {path}. Build it with "
                "python -m multimodal_timesfm_torch.time_mmd.cache (add --augment for "
                "caches with the '_aug' suffix), or adjust the requested augment flags."
            )
        with open(path, "rb") as f:
            data: list[PreprocessedSample] = pickle.load(f)
        _logger.info("Loaded %s samples", len(data))

        provenance = next(
            (s["metadata"].get("text_encoder") for s in data if "metadata" in s), None
        )
        if provenance is not None and not provenance.get("is_pretrained", True):
            message = (
                f"{path.name} was built WITHOUT pretrained text-encoder weights "
                f"(encoder={provenance.get('encoder')}): embeddings are "
                "pipeline-functional but not parity-grade."
            )
            if require_pretrained_embeddings:
                raise ValueError(
                    message + " Rebuild the cache with --text-model-dir pointing "
                    "at a local snapshot (docs/PRETRAINED.md)."
                )
            _logger.warning(message)
        return data

    def _save(self, path: Path, data: list[PreprocessedSample]) -> None:
        _logger.info("Saving %s samples to %s", len(data), path)
        with open(path, "wb") as f:
            pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
        _logger.info("Saved %.2f MB", path.stat().st_size / (1024 * 1024))

    def _preprocess(
        self,
        dataset: MultimodalDatasetBase,
        text_encoder: Callable[[list[str]], np.ndarray] | None,
    ) -> list[PreprocessedSample]:
        """Embed each sample's per-patch texts (joined with spaces; '' if none).

        ``text_encoder`` is any callable list[str] -> (N, T) float array; it is
        called once per sample, as in the JAX package, so the encoder sees the
        same batches and pads them to the same lengths.
        """
        _logger.info(
            "Preprocessing %s samples (%s)",
            len(dataset),
            "multimodal" if text_encoder is not None else "baseline",
        )
        result: list[PreprocessedSample] = []
        for i in range(len(dataset)):
            sample = dataset[i]
            entry = PreprocessedSample(
                context=sample["context"],
                horizon=sample["horizon"],
                metadata=sample["metadata"],
            )
            if text_encoder is not None:
                texts = [" ".join(patch) if patch else "" for patch in sample["patched_texts"]]
                entry["text_embeddings"] = np.asarray(text_encoder(texts), np.float32)
                entry["metadata"] = dict(entry["metadata"]) | {
                    "text_encoder": {
                        "encoder": type(text_encoder).__name__,
                        "is_pretrained": bool(getattr(text_encoder, "is_pretrained", True)),
                    }
                }
            result.append(entry)
            if (i + 1) % 100 == 0:
                _logger.info("Preprocessed %s/%s samples", i + 1, len(dataset))
        _logger.info("Preprocessing complete")
        return result

    def prepare(
        self,
        path: Path,
        dataset_factory: Callable[[], MultimodalDatasetBase],
        text_encoder: Callable[[list[str]], np.ndarray] | None = None,
        force_rebuild: bool = False,
    ) -> list[PreprocessedSample]:
        """Load from disk, or build + save if absent."""
        if not force_rebuild and path.exists():
            return self.load(path)
        dataset = dataset_factory()
        data = self._preprocess(dataset, text_encoder)
        self._save(path, data)
        return data
