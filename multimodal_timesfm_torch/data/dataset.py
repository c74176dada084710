"""Dataset containers (framework-free copy of the JAX package's ``data/dataset.py``).

Plain Python sequence types: there is no DataLoader; the trainer stacks a
whole dataset into dense arrays (``data/collate.py``) and gathers batches by
index on the device.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Generic, Iterator, Sequence, TypeVar

from multimodal_timesfm_torch.types import PreprocessedSample, RawSample, TrainingMode

T = TypeVar("T")


class SizedDataset(Generic[T], ABC):
    """Minimal dataset protocol: __len__ + __getitem__."""

    @abstractmethod
    def __getitem__(self, index: int) -> T: ...

    @abstractmethod
    def __len__(self) -> int: ...

    def __iter__(self) -> Iterator[T]:
        for i in range(len(self)):
            yield self[i]


class MultimodalDatasetBase(SizedDataset[RawSample], ABC):
    """Abstract base class for raw multimodal time-series datasets."""


class PreprocessedDataset(SizedDataset[PreprocessedSample]):
    """Wraps cached preprocessed samples; validates text embeddings in multimodal mode."""

    def __init__(self, data: list[PreprocessedSample], mode: TrainingMode) -> None:
        self.data = data
        self.mode = mode
        self._validate()

    def _validate(self) -> None:
        if self.mode == "multimodal" and not all("text_embeddings" in s for s in self.data):
            raise ValueError("All samples must contain 'text_embeddings' for multimodal mode")

    def __getitem__(self, index: int) -> PreprocessedSample:
        return self.data[index]

    def __len__(self) -> int:
        return len(self.data)


class ConcatDataset(SizedDataset[T]):
    """Concatenation of datasets, indexed as one sequence."""

    def __init__(self, datasets: Sequence[SizedDataset[T] | Sequence[T]]) -> None:
        self.datasets = list(datasets)
        self._lengths = [len(d) for d in self.datasets]

    def __getitem__(self, index: int) -> T:
        if index < 0:
            index += len(self)
            # Still negative after wrapping: out of range, not the first
            # dataset's Python-negative index.
            if index < 0:
                raise IndexError("index out of range")
        for d, n in zip(self.datasets, self._lengths):
            if index < n:
                return d[index]
            index -= n
        raise IndexError("index out of range")

    def __len__(self) -> int:
        return sum(self._lengths)
