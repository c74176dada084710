"""Frozen sentence encoders for the embedding cache, on the CUDA device.

Counterpart of the JAX package's ``text/encoders.py``, with its call
contract: an encoder is a callable ``list[str] -> (N, dim)`` numpy float32
(``(dim,)`` for a single string) that tokenizes in chunks of ``batch_size``
32, pads each chunk to the tokenizers' length buckets and runs the module on
it, one host copy per chunk.

  * :class:`EnglishTextEncoder`: all-MiniLM-L6-v2 geometry (``text/bert.py``),
    384-d, with the WordPiece tokenizer of a snapshot's ``vocab.txt``.
  * :class:`JapaneseTextEncoder`: ruri-v3-310m geometry
    (``text/modernbert.py``), 768-d; its snapshot tokenizer needs
    ``transformers``, imported only then.

Weights: ``model_dir`` is a local HF snapshot. Without one, the module's
weights are drawn from a ``torch.Generator`` seeded 0 (not the JAX package's
``jax.random.key(0)`` draw; parity with JAX goes through
``models/bridge.py``), the tokenizer is :class:`HashTokenizer`, and
``is_pretrained`` is False. The products run in fp32 with TF32 off, whatever
the process's matmul precision, as the JAX encoders compute in fp32.
"""

from __future__ import annotations

import contextlib
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch
from torch import nn

from multimodal_timesfm_torch.models.bridge import load_jax_params
from multimodal_timesfm_torch.text.bert import BertConfig, BertEncoder
from multimodal_timesfm_torch.text.modernbert import (
    ModernBertConfig,
    ModernBertEncoder,
    convert_hf_modernbert_state,
)
from multimodal_timesfm_torch.text.tokenizer import HashTokenizer
from multimodal_timesfm_torch.utils.logging import get_logger
from multimodal_timesfm_torch.utils.platform import resolve_device

_logger = get_logger()


@contextlib.contextmanager
def fp32_matmuls() -> Iterator[None]:
    """Products in full fp32 (no TF32) inside the block; the process's setting after it."""
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(previous)


class TextEncoderBase(ABC):
    """Frozen sentence encoder: callable ``list[str] -> (N, dim) float32``."""

    def __init__(
        self,
        embedding_dim: int,
        model_dir: Path | str | None = None,
        max_length: int = 256,
        batch_size: int = 32,
        device: str | torch.device | None = None,
    ) -> None:
        self.embedding_dim = embedding_dim
        self.max_length = max_length
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.is_pretrained = False

        if model_dir is not None:
            tree, self.tokenizer = self._load_pretrained(Path(model_dir))
            self.model = self._build(None)
            load_jax_params(self.model, tree)
            self.is_pretrained = True
        else:
            _logger.warning(
                "No model_dir for %s: using random weights + hash tokenizer "
                "(pipeline-functional, NOT embedding-parity)",
                type(self).__name__,
            )
            self.model = self._build(torch.Generator().manual_seed(0))
            self.tokenizer = HashTokenizer(self._config().vocab_size)
        self.model = self.model.to(self.device).eval().requires_grad_(False)
        self._validate()

    # -- model-specific hooks --

    @abstractmethod
    def _config(self) -> Any: ...

    @abstractmethod
    def _build(self, generator: torch.Generator | None) -> nn.Module: ...

    @abstractmethod
    def _load_pretrained(self, model_dir: Path) -> tuple[dict, Any]: ...

    # -- shared interface --

    @property
    def tokenizer_name(self) -> str:
        """The tokenizer's class, with ``(native)`` when the C++ WordPiece runs."""
        native = getattr(self.tokenizer, "_native", None) is not None
        return type(self.tokenizer).__name__ + (" (native)" if native else "")

    def _validate(self) -> None:
        actual = self._config().hidden_size
        if actual != self.embedding_dim:
            raise ValueError(
                f"Embedding dimension mismatch: expected {self.embedding_dim}, got {actual}."
            )

    def _encode_arrays(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """(B, S) int ids and mask -> (B, dim) float32 embeddings, through the module."""
        with torch.no_grad(), fp32_matmuls():
            emb = self.model(torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device))
        return emb.cpu().numpy()

    def __call__(self, texts: str | list[str]) -> np.ndarray:
        """Encode texts -> (N, dim) float32 (or (dim,) for a single string)."""
        single = isinstance(texts, str)
        batch = [texts] if single else list(texts)
        out = np.empty((len(batch), self.embedding_dim), np.float32)
        for i in range(0, len(batch), self.batch_size):
            chunk = batch[i : i + self.batch_size]
            ids, mask = self.tokenizer.encode_batch(chunk, self.max_length)
            out[i : i + len(chunk)] = self._encode_arrays(ids, mask)
        return out[0] if single else out


class EnglishTextEncoder(TextEncoderBase):
    """English encoder: all-MiniLM-L6-v2 geometry, 384-d."""

    def __init__(
        self,
        model_dir: Path | str | None = None,
        embedding_dim: int = 384,
        device: str | torch.device | None = None,
    ) -> None:
        self.config = BertConfig.minilm_l6()
        super().__init__(embedding_dim, model_dir, device=device)

    def _config(self) -> BertConfig:
        return self.config

    def _build(self, generator: torch.Generator | None) -> nn.Module:
        return BertEncoder(self.config, generator)

    def _load_pretrained(self, model_dir: Path) -> tuple[dict, Any]:
        from multimodal_timesfm_torch.models.snapshot import bert_config_from_hf, read_hf_config
        from multimodal_timesfm_torch.text.convert import load_hf_bert

        hf = read_hf_config(model_dir)
        if hf is not None:
            self.config = bert_config_from_hf(hf, defaults=self.config)
        return load_hf_bert(model_dir, self.config)


class JapaneseTextEncoder(TextEncoderBase):
    """Japanese encoder: ruri-v3-310m ModernBERT geometry, 768-d.

    Pretrained loading converts the snapshot's ModernBERT weights; ruri's
    tokenizer is a unigram model read with ``transformers`` from the snapshot.
    Without a snapshot, batches use the hash tokenizer.
    """

    def __init__(
        self,
        model_dir: Path | str | None = None,
        embedding_dim: int = 768,
        device: str | torch.device | None = None,
    ) -> None:
        self.config = ModernBertConfig.ruri_v3_310m()
        super().__init__(embedding_dim, model_dir, device=device)

    def _config(self) -> ModernBertConfig:
        return self.config

    def _build(self, generator: torch.Generator | None) -> nn.Module:
        return ModernBertEncoder(self.config, generator)

    def _load_pretrained(self, model_dir: Path) -> tuple[dict, Any]:
        from multimodal_timesfm_torch.models.snapshot import (
            modernbert_config_from_hf,
            read_hf_config,
        )
        from multimodal_timesfm_torch.text.convert import load_state_dict
        from multimodal_timesfm_torch.text.tokenizer import HFTokenizerWrapper

        hf = read_hf_config(model_dir)
        if hf is not None:
            self.config = modernbert_config_from_hf(hf, defaults=self.config)
        tree = convert_hf_modernbert_state(load_state_dict(model_dir), self.config)
        return tree, HFTokenizerWrapper(model_dir)


def build_text_encoder(
    text_encoder_type: str,
    model_dir: Path | str | None = None,
    embedding_dim: int | None = None,
    device: str | torch.device | None = None,
) -> TextEncoderBase:
    """Factory keyed like the cache CLI's ``--text-encoder-type``.

    ``model_dir`` may also be an HF repo id (e.g.
    ``sentence-transformers/all-MiniLM-L6-v2``), resolved against local
    snapshot caches (``models/snapshot.py``). ``embedding_dim`` is the
    DECLARED dimension checked against the loaded model; ``None`` keeps the
    per-type defaults (384/768). The encoder runs on CUDA unless ``device``
    names another device.
    """
    if model_dir is not None:
        from multimodal_timesfm_torch.models.snapshot import resolve_snapshot_dir

        model_dir = resolve_snapshot_dir(model_dir)
    dims = {} if embedding_dim is None else {"embedding_dim": embedding_dim}
    if text_encoder_type == "english":
        return EnglishTextEncoder(model_dir, device=device, **dims)
    if text_encoder_type == "japanese":
        return JapaneseTextEncoder(model_dir, device=device, **dims)
    raise ValueError(f"Unknown text encoder type: {text_encoder_type!r}")
