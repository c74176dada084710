"""WordPiece tokenizer (host-side), compatible with BERT-family vocab.txt files.

The port's copy of the JAX package's ``text/tokenizer.py``, with the same ids
and the same padded batches: basic tokenization (clean, lowercase,
accent-strip, punctuation split, CJK split) followed by greedy
longest-match-first WordPiece with ``##`` continuations, as HF's
``BertTokenizer`` does for the MiniLM sentence encoder. ``encode_batch`` pads
to the same length buckets (16 to 512), so the encoders see the JAX shapes.

When no vocab file is available, a deterministic hashing tokenizer keeps the
multimodal pipeline runnable end-to-end; it is not embedding-parity and is
flagged via ``is_hash_fallback``.
"""

from __future__ import annotations

from typing import Any

import hashlib
import unicodedata
from pathlib import Path

import numpy as np

_SPECIAL = {"pad": "[PAD]", "unk": "[UNK]", "cls": "[CLS]", "sep": "[SEP]"}


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


class WordPieceTokenizer:
    """BERT-style tokenizer over a vocab.txt file."""

    def __init__(
        self,
        vocab_path: Path | str,
        do_lower_case: bool = True,
        max_input_chars_per_word: int = 100,
        use_native: bool = True,
    ) -> None:
        self.vocab: dict[str, int] = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.do_lower_case = do_lower_case
        self.max_input_chars_per_word = max_input_chars_per_word
        self.pad_id = self.vocab[_SPECIAL["pad"]]
        self.unk_id = self.vocab[_SPECIAL["unk"]]
        self.cls_id = self.vocab[_SPECIAL["cls"]]
        self.sep_id = self.vocab[_SPECIAL["sep"]]
        self.is_hash_fallback = False

        # Native C++ fast path (the port's csrc/wordpiece.cpp); Python otherwise.
        # The native vocab hardcodes max_chars_per_word=100, so a custom
        # max_input_chars_per_word must route through the Python path — the
        # two would otherwise tokenize 21-100-char words differently for the
        # same configuration.
        self._native = None
        if use_native and do_lower_case and max_input_chars_per_word == 100:
            try:
                from multimodal_timesfm_torch.text.native import NativeWordPiece

                self._native = NativeWordPiece(vocab_path)
            except (RuntimeError, OSError):
                self._native = None

    # -- basic tokenization --

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD:
                continue
            if ch in "\t\n\r" or unicodedata.category(ch) == "Zs":
                out.append(" ")
                continue
            # HF drops ALL C* categories (Cc, Cf format chars like ZWSP/LRM, ...)
            if unicodedata.category(ch).startswith("C"):
                continue
            out.append(ch)
        return "".join(out)

    def _split_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    def _basic_tokenize(self, text: str) -> list[str]:
        text = self._clean(text)
        text = self._split_cjk(text)
        tokens = text.split()
        output: list[str] = []
        for token in tokens:
            if self.do_lower_case:
                token = token.lower()
                token = unicodedata.normalize("NFD", token)
                token = "".join(c for c in token if unicodedata.category(c) != "Mn")
            # split on punctuation
            current: list[str] = []
            for ch in token:
                if _is_punctuation(ch):
                    if current:
                        output.append("".join(current))
                        current = []
                    output.append(ch)
                else:
                    current.append(ch)
            if current:
                output.append("".join(current))
        return output

    # -- wordpiece --

    def _wordpiece(self, token: str) -> list[int]:
        if len(token) > self.max_input_chars_per_word:
            return [self.unk_id]
        ids: list[int] = []
        start = 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                substr = token[start:end]
                if start > 0:
                    substr = "##" + substr
                if substr in self.vocab:
                    cur = self.vocab[substr]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str, max_length: int = 256) -> list[int]:
        """Token ids with [CLS]/[SEP], truncated to max_length."""
        if self._native is not None:
            return self._native.encode(text, max_length)
        ids = [self.cls_id]
        for token in self._basic_tokenize(text):
            ids.extend(self._wordpiece(token))
            if len(ids) >= max_length - 1:
                ids = ids[: max_length - 1]
                break
        ids.append(self.sep_id)
        return ids

    def encode_batch(
        self, texts: list[str], max_length: int = 256
    ) -> tuple[np.ndarray, np.ndarray]:
        """Encode + right-pad a batch: returns (ids, attention_mask) int32 arrays.

        The sequence length is padded up to a power-of-two bucket (16 to 512), as in
        the JAX package, where the buckets bound recompilations: the same texts give
        the same padded shapes, and so the same embeddings, in both packages.
        """
        encoded = [self.encode(t, max_length) for t in texts]
        longest = max(len(e) for e in encoded)
        buckets = [16, 32, 64, 128, 256, 512]
        seq = next((b for b in buckets if b >= longest), max_length)
        seq = min(seq, max_length)
        ids = np.full((len(encoded), seq), self.pad_id, np.int32)
        mask = np.zeros((len(encoded), seq), np.int32)
        for i, e in enumerate(encoded):
            e = e[:seq]
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return ids, mask


class HFTokenizerWrapper:
    """Adapter for a ``transformers`` tokenizer loaded from a LOCAL snapshot.

    Used for tokenizers this package does not implement natively (e.g.
    ruri-v3's unigram model). Loading is strictly offline
    (``local_files_only=True``); exposes the same ``encode``/``encode_batch``
    interface as :class:`WordPieceTokenizer`.
    """

    def __init__(self, model_dir: Any) -> None:
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(str(model_dir), local_files_only=True)
        self.pad_id = self._tok.pad_token_id or 0
        self.is_hash_fallback = False

    def encode(self, text: str, max_length: int = 256) -> list[int]:
        return self._tok.encode(text, add_special_tokens=True, truncation=True, max_length=max_length)

    encode_batch = WordPieceTokenizer.encode_batch  # shared bucketing/padding


class HashTokenizer:
    """Deterministic offline fallback: buckets whitespace/punct tokens by hash.

    NOT embedding-parity with any pretrained tokenizer — exists so the full
    multimodal pipeline (cache -> train -> eval) runs in environments without
    a downloaded vocab. Flagged via ``is_hash_fallback = True``.
    """

    def __init__(self, vocab_size: int = 30522) -> None:
        self.vocab_size = vocab_size
        self.pad_id, self.unk_id, self.cls_id, self.sep_id = 0, 1, 2, 3
        self.is_hash_fallback = True

    def _hash(self, token: str) -> int:
        digest = hashlib.md5(token.encode()).digest()
        return 4 + int.from_bytes(digest[:4], "little") % (self.vocab_size - 4)

    def encode(self, text: str, max_length: int = 256) -> list[int]:
        tokens: list[str] = []
        current: list[str] = []
        for ch in text.lower():
            if ch.isspace() or _is_punctuation(ch):
                if current:
                    tokens.append("".join(current))
                    current = []
                if _is_punctuation(ch):
                    tokens.append(ch)
            else:
                current.append(ch)
        if current:
            tokens.append("".join(current))
        ids = [self.cls_id] + [self._hash(t) for t in tokens][: max_length - 2] + [self.sep_id]
        return ids

    encode_batch = WordPieceTokenizer.encode_batch
