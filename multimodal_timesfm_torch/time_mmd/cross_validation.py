"""Fold-dataset loading from pre-computed caches.

The port's copy of ``examples/time_mmd/cross_validation.py``: one fixed fold
of cached domain pickles per split, concatenated (there is no k-fold loop).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Literal

from multimodal_timesfm_torch.data.dataset import ConcatDataset, PreprocessedDataset
from multimodal_timesfm_torch.data.preprocess import PreprocessPipeline
from multimodal_timesfm_torch.types import PreprocessedSample


@dataclass
class DomainSpec:
    """Domain name + whether to load its augmented cache."""

    name: str
    augment: bool = field(default=False)


def load_fold_datasets(
    train_domain_specs: list[DomainSpec],
    val_domain_specs: list[DomainSpec],
    test_domain_specs: list[DomainSpec],
    text_encoder_type: Literal["english", "japanese"],
    patch_len: int,
    context_len: int,
    horizon_len: int,
    cache_dir: Path,
    require_pretrained_embeddings: bool = False,
) -> tuple[
    ConcatDataset[PreprocessedSample],
    ConcatDataset[PreprocessedSample],
    ConcatDataset[PreprocessedSample],
]:
    """Load cached datasets for a single fold.

    ``require_pretrained_embeddings=True`` refuses caches built with the
    random-weights/hash text-encoder fallback (see ``PreprocessPipeline.load``).
    """
    cache = PreprocessPipeline(cache_dir)

    def load_cached_domains(domain_specs: list[DomainSpec]) -> list[PreprocessedDataset]:
        datasets = []
        for spec in domain_specs:
            cache_path = cache.get_path(
                dataset_name="time_mmd",
                entity=spec.name,
                text_encoder_type=text_encoder_type,
                patch_len=patch_len,
                context_len=context_len,
                horizon_len=horizon_len,
                augment=spec.augment,
            )
            samples = cache.load(cache_path, require_pretrained_embeddings)
            datasets.append(PreprocessedDataset(samples, mode="multimodal"))
        return datasets

    return (
        ConcatDataset(load_cached_domains(train_domain_specs)),
        ConcatDataset(load_cached_domains(val_domain_specs)),
        ConcatDataset(load_cached_domains(test_domain_specs)),
    )
