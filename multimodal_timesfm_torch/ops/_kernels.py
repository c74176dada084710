"""Build, load and launch the port's CUDA kernels.

The sources under ``multimodal_timesfm_torch/csrc/`` are compiled with
``nvcc`` for ``sm_90a``, one ``nvcc`` per source, all started together, and
linked into one shared library with a plain C interface, at first use, into
``build/torch_kernels/`` at the repository root, and bound with ``ctypes``.
The library's file name carries a hash of the sources and flags, so an edited
source is rebuilt. Nothing here runs at import: the CPU tests import every
module of the port on hosts without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "attention_fwd.cu", _PKG / "csrc" / "attention_bwd.cu")
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
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


def _build(so: Path) -> None:
    """Compile every source in parallel, link them into ``so``; raise quoting nvcc's stderr."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        tmp = Path(tmp_dir)
        objects = [tmp / f"{src.stem}.o" for src in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for src, obj in zip(SOURCES, objects)
        ]
        outputs = [proc.communicate() for proc in procs]
        log = "".join(out + err for out, err in outputs)
        for proc, (_, err) in zip(procs, outputs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed with exit code {proc.returncode} building {so.name}:\n{err}"
                )
        linked = tmp / so.name
        proc = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(linked), *map(str, objects)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode} linking {so.name}:\n{proc.stderr}"
            )
        so.with_suffix(".log").write_text(log)
        os.replace(linked, so)


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
        _build(so)
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as exc:
        raise RuntimeError(f"could not load the kernel library {so}: {exc}") from exc
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.attention_fwd.argtypes = [ptr] * 5 + [i32] * 5 + [i64] * 2 + [ptr]
    lib.attention_fwd.restype = i32
    lib.attention_bwd.argtypes = [ptr] * 9 + [i32] * 5 + [i64] * 3 + [ptr]
    lib.attention_bwd.restype = i32
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


def _check_inputs(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor,
    others: tuple[tuple[str, torch.Tensor], ...],
) -> tuple[int, int, int, int]:
    """Device, dtype and layout checks shared by both launches; returns (B, S, H, D)."""
    shape = tuple(q.shape)
    if len(shape) != 4:
        raise ValueError(f"q must be (B, S, H, D), got shape {shape}")
    batch, seq, heads, dim = shape
    dev = q.device
    tensors = (("q", q), ("k", k), ("v", v), ("key_valid", key_valid), *others)
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} is on {t.device}; the kernel needs every input on {dev} (CUDA)")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}; the kernel takes float32 or bfloat16")
    for name, t in tensors:
        if name != "key_valid" and t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    if not 0 < dim <= 256:
        raise ValueError(f"head_dim {dim} outside the kernel's range 1..256")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_heads_view(name, t, shape, q.stride(1))
    if key_valid.dtype != torch.bool or tuple(key_valid.shape) != (batch, seq):
        raise ValueError(
            f"key_valid must be bool of shape {(batch, seq)}, got {key_valid.dtype} "
            f"{tuple(key_valid.shape)}"
        )
    if not key_valid.is_contiguous():
        raise ValueError("key_valid must be contiguous")
    return batch, seq, heads, dim


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
    batch, seq, heads, dim = _check_inputs(q, k, v, key_valid, (("out", out),))
    _check_heads_view("out", out, tuple(q.shape), out.stride(1))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], batch, seq, heads, dim, q.stride(1), out.stride(1), stream,
        )
    if err != 0:
        raise RuntimeError(f"attention_fwd launch failed with CUDA error {err}")


def attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_valid: torch.Tensor,
    g: torch.Tensor,
    dq: torch.Tensor,
    dk: torch.Tensor,
    dv: torch.Tensor,
) -> None:
    """Launch the two attention backward kernels on the current stream.

    q, k, v as for :func:`attention_fwd`; g: the output's cotangent, a
    (B, S, H, D) view with its own row stride; dq, dk, dv: (B, S, H, D) views
    sharing one row stride, written whole. A (3, B, H, S) fp32 scratch for the
    row statistics is allocated here. Raises ``RuntimeError`` if a launch is
    refused.
    """
    lib = library()
    outs = (("dq", dq), ("dk", dk), ("dv", dv))
    batch, seq, heads, dim = _check_inputs(q, k, v, key_valid, (("g", g), *outs))
    shape = tuple(q.shape)
    _check_heads_view("g", g, shape, g.stride(1))
    for name, t in outs:
        _check_heads_view(name, t, shape, dq.stride(1))
    stats = torch.empty(3 * batch * heads * seq, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            _DTYPE_CODES[q.dtype], batch, seq, heads, dim,
            q.stride(1), g.stride(1), dq.stride(1), stream,
        )
    if err != 0:
        raise RuntimeError(f"attention_bwd launch failed with CUDA error {err}")
