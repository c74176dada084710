"""ctypes bindings for the native WordPiece tokenizer (the port's ``csrc/wordpiece.cpp``).

The shared library is built with ``g++`` at first use into
``build/torch_kernels/`` at the repository root (never beside the source),
named by a hash of the source and the flags, and written under a temporary
name then renamed, so concurrent first uses do not race. Where ``g++`` or
the source is missing, :func:`load_library` returns None and callers use the
pure-Python tokenizer.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Any

from multimodal_timesfm_torch.utils.logging import get_logger

_logger = get_logger()

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "wordpiece.cpp"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libwordpiece_{digest.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / so.name
        try:
            subprocess.run(
                ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(out)], check=True, capture_output=True
            )
        except (subprocess.CalledProcessError, FileNotFoundError) as exc:
            _logger.warning("native wordpiece build failed: %s", exc)
            return False
        os.replace(out, so)
    return True


@functools.cache
def load_library() -> Any:
    """Load (building if needed) the native library, or return None."""
    if not SOURCE.exists():
        return None
    so = library_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as exc:
        _logger.warning("native wordpiece library %s does not load: %s", so, exc)
        return None
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_create.argtypes = [ctypes.c_char_p]
    lib.wp_destroy.argtypes = [ctypes.c_void_p]
    lib.wp_destroy.restype = None
    lib.wp_encode.restype = ctypes.c_int32
    lib.wp_encode.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


class NativeWordPiece:
    """Native encoder over a vocab.txt; same id output as WordPieceTokenizer."""

    def __init__(self, vocab_path: Path | str) -> None:
        lib = load_library()
        if lib is None:
            raise RuntimeError("native wordpiece library unavailable")
        self._lib = lib
        vocab_text = Path(vocab_path).read_text(encoding="utf-8")
        self._handle = lib.wp_create(vocab_text.encode("utf-8"))

    def encode(self, text: str, max_length: int = 256) -> list[int]:
        # The C ABI is NUL-terminated, so an embedded NUL would end the input
        # there; the Python tokenizer drops NULs and goes on, so strip them.
        if "\x00" in text:
            text = text.replace("\x00", "")
        buf = (ctypes.c_int32 * max_length)()
        n = self._lib.wp_encode(self._handle, text.encode("utf-8"), max_length, buf)
        return list(buf[:n])

    def __del__(self) -> None:  # pragma: no cover
        if getattr(self, "_handle", None):
            self._lib.wp_destroy(self._handle)
            self._handle = None
