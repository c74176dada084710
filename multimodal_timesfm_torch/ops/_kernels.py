"""Build, load and launch the port's CUDA kernels.

The sources under ``multimodal_timesfm_torch/csrc/`` are compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface, at
first use, into ``build/torch_kernels/`` at the repository root, and bound
with ``ctypes``. The library's file name carries a hash of the sources and
flags, so an edited source is rebuilt. Nothing here runs at import: the CPU
tests import every module of the port on hosts without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "attention_fwd.cu",)
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc`` or ``PATH``."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = home / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found ($CUDA_HOME/bin, /usr/local/cuda/bin, PATH): the port's CUDA "
            "kernels cannot be built"
        )
    return found


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmtt_kernels_{digest.hexdigest()[:16]}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library.

    Raises ``RuntimeError`` quoting nvcc's stderr when the build fails, or
    the loader's message when the library does not load. The compiler's
    output (``-Xptxas=-v``: registers, shared memory, spills) is kept beside
    the library as ``<name>.log``.
    """
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode} building {so.name}:\n{proc.stderr}"
            )
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as exc:
        raise RuntimeError(f"could not load the kernel library {so}: {exc}") from exc
    ptr = ctypes.c_void_p
    lib.attention_fwd.argtypes = [ptr] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2 + [ptr]
    lib.attention_fwd.restype = ctypes.c_int
    return lib


def _check_heads_view(name: str, x: torch.Tensor, shape: tuple[int, ...], row_stride: int) -> None:
    """``x`` must be a (B, S, H, D) view with unit-stride heads and rows ``row_stride`` apart."""
    b, s, h, d = shape
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if x.stride(3) != 1 or x.stride(2) != d or x.stride(1) != row_stride:
        raise ValueError(
            f"{name} strides {x.stride()} are not (S*ld, ld, D, 1) with ld={row_stride}, D={d}"
        )
    if b > 1 and x.stride(0) != s * row_stride:
        raise ValueError(f"{name} batch stride {x.stride(0)} != S*ld = {s * row_stride}")


def attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_valid: torch.Tensor,
    out: torch.Tensor,
) -> None:
    """Launch the attention forward kernel on the current stream.

    q, k, v: (B, S, H, D) views sharing one row stride (``stride(1)``), each
    head's D values contiguous; out: the same shape, its own row stride;
    key_valid: (B, S) bool, contiguous. Validates device, dtype, shape and
    strides, and raises ``RuntimeError`` if the launch is refused.
    """
    lib = library()
    shape = tuple(q.shape)
    if len(shape) != 4:
        raise ValueError(f"q must be (B, S, H, D), got shape {shape}")
    batch, seq, heads, dim = shape
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("key_valid", key_valid), ("out", out)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} is on {t.device}; the kernel needs every input on {dev} (CUDA)")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}; the kernel takes float32 or bfloat16")
    for name, t in (("k", k), ("v", v), ("out", out)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    if not 0 < dim <= 256:
        raise ValueError(f"head_dim {dim} outside the kernel's range 1..256")
    ld_in = q.stride(1)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_heads_view(name, t, shape, ld_in)
    _check_heads_view("out", out, shape, out.stride(1))
    if key_valid.dtype != torch.bool or tuple(key_valid.shape) != (batch, seq):
        raise ValueError(
            f"key_valid must be bool of shape {(batch, seq)}, got {key_valid.dtype} "
            f"{tuple(key_valid.shape)}"
        )
    if not key_valid.is_contiguous():
        raise ValueError("key_valid must be contiguous")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], batch, seq, heads, dim, ld_in, out.stride(1), stream,
        )
    if err != 0:
        raise RuntimeError(f"attention_fwd launch failed with CUDA error {err}")
