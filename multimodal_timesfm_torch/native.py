"""The native server of an AOTInductor package: build ``mtt_serve`` and the C++ ops, and drive them.

A package of :func:`serving.export_program` (``format="aoti"``) calls the port's
attention ops (``torch.ops.mtt.*``) through PyTorch's dispatcher.
``csrc/mtt_ops.cpp`` registers those ops in C++ and ``csrc/mtt_serve.cpp`` is
a server on ``torch::inductor::AOTIModelPackageLoader`` that links libtorch and
no Python: the counterpart of TF Serving loading the JAX package's SavedModel.
This module is Python and lies off the served path: it builds the two and
runs the server in a subprocess.

The build runs at first use, with the first of ``$CXX``, ``g++`` and ``c++``
that compiles a C++17 program, against the installed torch
(``torch.utils.cpp_extension.include_paths()``/``library_paths()``, its
``_GLIBCXX_USE_CXX11_ABI``), into ``build/torch_native/`` at the repository
root, one directory named by a hash of the sources, the flags, the compiler and
torch's version, written under a temporary name and renamed. It holds three
files, compiled together: ``mtt_serve``; ``libmtt_ops.so``, the ops in the
``mtt`` namespace, which the server loads (never load it into a Python process
that imported the op modules: the second registration of ``mtt::*`` raises);
``libmtt_native.so``, the same ops in the ``mtt_native`` namespace, which
:func:`load_check_ops` loads into this process to hold them against the
Python ops. The CUDA build (``cuda=True``) adds the ops' CUDA implementations
and links the kernel library ``ops._kernels`` builds from the same ``.cu``
sources, so no kernel is compiled twice; without ``nvcc`` it raises. Nothing
falls back to a CPU build when the card was asked for.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import functools
import hashlib
import json
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from multimodal_timesfm_torch.utils.platform import resolve_device

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
OPS_SOURCE = CSRC / "mtt_ops.cpp"
SERVE_SOURCE = CSRC / "mtt_serve.cpp"
BUILD_DIR = _PKG.parent / "build" / "torch_native"
OPS = ("fused_causal_attention", "flash_causal_attention", "fused_qkv_causal_attention", "fused_chronos_attention")
# The server's exit code for what it refuses by name (another format, device or input).
REFUSED = 2


@dataclasses.dataclass(frozen=True)
class Build:
    """One build: the server, the ops library in each namespace, how it was made."""

    directory: Path
    server: Path
    ops: Path  # namespace mtt, for the server
    check_ops: Path  # namespace mtt_native, for this process
    compiler: str
    seconds: float  # 0 when the directory was already built


@functools.cache
def compiler() -> str:
    """The first of ``$CXX``, ``g++`` and ``c++`` that compiles and links a C++17 program."""
    candidates = [c for c in (os.environ.get("CXX"), "g++", "c++") if c]
    with tempfile.TemporaryDirectory() as tmp:
        source = Path(tmp) / "probe.cc"
        source.write_text("#include <string>\nint main() { return std::string(\"ok\").size() == 2 ? 0 : 1; }\n")
        for cxx in candidates:
            try:
                done = subprocess.run([cxx, "-std=c++17", str(source), "-o", str(Path(tmp) / "probe")],
                                      capture_output=True, text=True, timeout=120)
            except (FileNotFoundError, PermissionError):
                continue
            if done.returncode == 0:
                return cxx
    raise RuntimeError(f"no C++ compiler among {candidates} builds a C++17 program: mtt_serve cannot be built")


def _cpp_std() -> str:
    """The C++ standard Inductor compiles its own C++ against torch's headers with."""
    try:
        from torch._inductor.cpp_builder import _get_cpp_std_cflag

        return f"-std={_get_cpp_std_cflag()[0].split('=')[-1]}"
    except (ImportError, AttributeError, IndexError):
        return "-std=c++17"


def _cuda_include() -> Path:
    include = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "include"
    if not (include / "cuda_runtime_api.h").is_file():
        raise RuntimeError(f"no CUDA headers under {include}: the CUDA ops cannot be built")
    return include


@functools.cache
def _flags(cuda: bool) -> tuple[str, tuple[str, ...], tuple[str, ...], tuple[str, ...]]:
    """(compiler, compile flags, link flags, the kernel library's link arguments)."""
    from torch.utils import cpp_extension

    libs = cpp_extension.library_paths()
    flags = [_cpp_std(), "-O2", f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
             *(f"-I{p}" for p in cpp_extension.include_paths())]
    link = [*(f"-L{p}" for p in libs), *(f"-Wl,-rpath,{p}" for p in libs), "-Wl,--no-as-needed",
            "-ltorch", "-ltorch_cpu", "-lc10"]
    kernels: list[str] = []
    if cuda:
        from multimodal_timesfm_torch.ops import _kernels

        _kernels.library()  # built by nvcc from the .cu sources, or raises
        so = _kernels.library_path()
        flags += ["-DMTT_WITH_CUDA", f"-I{_cuda_include()}"]
        link += ["-ltorch_cuda", "-lc10_cuda"]
        kernels = [str(so), f"-Wl,-rpath,{so.parent}"]
    return compiler(), tuple(flags), tuple(link), tuple(kernels)


def _directory(cuda: bool) -> Path:
    """Where the build of the current sources and flags lives."""
    digest = hashlib.sha256()
    for source in (OPS_SOURCE, SERVE_SOURCE):
        digest.update(source.read_bytes())
    cxx, flags, link, kernels = _flags(cuda)
    digest.update(" ".join([cxx, torch.__version__, *flags, *link, *kernels]).encode())
    return BUILD_DIR / f"{'cuda' if cuda else 'cpu'}_{digest.hexdigest()[:16]}"


def _commands(cuda: bool, out: Path) -> list[list[str]]:
    """The three compile-and-link commands: the ops in each namespace, the server."""
    cxx, flags, link, kernels = _flags(cuda)
    ops = [cxx, *flags, "-fPIC", "-shared", str(OPS_SOURCE)]
    return [
        [*ops, "-o", str(out / "libmtt_ops.so"), *kernels, *link],
        [*ops, "-DMTT_NS=mtt_native", "-o", str(out / "libmtt_native.so"), *kernels, *link],
        [cxx, *flags, str(SERVE_SOURCE), "-o", str(out / "mtt_serve"), *link, "-ldl"],
    ]


@functools.cache
def build(cuda: bool) -> Build:
    """Build (if the sources or flags changed) the server and both ops libraries.

    ``cuda`` adds the ops' CUDA half, linked to the kernel library. Raises
    ``RuntimeError`` quoting the compiler's errors when a build fails, or when
    ``cuda`` is asked for and ``nvcc`` or the CUDA headers are missing.
    """
    directory = _directory(cuda)
    seconds = 0.0
    if not (directory / "mtt_serve").exists():
        start = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = Path(tmp) / "out"
            out.mkdir()
            commands = _commands(cuda, out)
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for c in commands]
            for cmd, proc in zip(commands, procs):
                _, err = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"{cmd[0]} failed with exit code {proc.returncode} building "
                                       f"{Path(cmd[cmd.index('-o') + 1]).name}:\n{err[-4000:]}")
            try:
                os.replace(out, directory)
            except OSError:
                if not (directory / "mtt_serve").exists():  # not another process's build
                    raise
        seconds = time.perf_counter() - start
    return Build(directory, directory / "mtt_serve", directory / "libmtt_ops.so", directory / "libmtt_native.so",
                 _flags(cuda)[0], seconds)


def start_build(cuda: bool) -> concurrent.futures.Future:
    """:func:`build` with its compilers running while the caller goes on: the flags, whose
    lookup imports torch's own compile modules, are worked out in the calling thread, and
    only the compilers' subprocesses are waited on in another (two threads importing
    torch's modules at once can each meet the other's half-initialised module)."""
    _directory(cuda)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(build, cuda)
    pool.shutdown(wait=False)
    return future


def load_check_ops(device: str | torch.device | None = None) -> Any:
    """Load the ``mtt_native`` ops library into this process and return ``torch.ops.mtt_native``.

    The same C++ registration the server loads, under another namespace, so
    that it can be held against the Python ops (``torch.ops.mtt``) here. Built
    with its CUDA half unless ``device="cpu"``.
    """
    path = build(resolve_device(device).type == "cuda").check_ops
    torch.ops.load_library(str(path))
    return torch.ops.mtt_native


def launch_counts(library: str | Path) -> dict[str, int]:
    """Each op's kernel launches, as a loaded ops library counts them."""
    lib = ctypes.CDLL(str(library))
    lib.mtt_ops_launches.restype = ctypes.c_int64
    lib.mtt_ops_launches.argtypes = [ctypes.c_char_p]
    return {op: lib.mtt_ops_launches(op.encode()) for op in OPS}


def serve(
    artifact_dir: str | Path,
    context: np.ndarray,
    text: np.ndarray | None = None,
    device: str | torch.device | None = None,
    batch: int = 64,
    repeat: int = 1,
) -> tuple[dict[str, np.ndarray], dict]:
    """Serve ``context`` (and ``text``) with ``mtt_serve`` in a subprocess.

    The package at ``artifact_dir`` serves on ``device`` (CUDA unless the
    caller passes another) in batches of ``batch``, one pass for the outputs
    and ``repeat`` timed passes held bit-equal to it. Returns ``(outputs,
    info)``: each output by name, real rows only; ``info`` is the server's last
    line (``load_s``, ``series_per_s``, ``launches``, ``flags``, ...) plus
    ``start_s`` (from the subprocess's start to the server's ``main``: the
    process and libtorch coming up), ``wall_s`` and the server's ``lines``.
    Raises ``ValueError`` with the server's message for what it refuses by
    name, ``RuntimeError`` for any other failure.
    """
    dev = resolve_device(device)
    made = build(dev.type == "cuda")
    with tempfile.TemporaryDirectory() as tmp:
        tmp_dir = Path(tmp)
        np.save(tmp_dir / "context.npy", np.asarray(context, np.float32))
        argv = [str(made.server), str(artifact_dir), "--context", str(tmp_dir / "context.npy"),
                "--out", str(tmp_dir / "out"), "--device", dev.type, "--batch", str(batch),
                "--repeat", str(repeat), "--ops-lib", str(made.ops)]
        if text is not None:
            np.save(tmp_dir / "text.npy", np.asarray(text, np.float32))
            argv += ["--text", str(tmp_dir / "text.npy")]
        start = time.monotonic()
        done = subprocess.run(argv, capture_output=True, text=True)
        wall = time.monotonic() - start
        if done.returncode == REFUSED:
            raise ValueError(done.stderr.strip())
        if done.returncode != 0:
            raise RuntimeError(f"mtt_serve exited with code {done.returncode}:\n{done.stderr[-4000:]}")
        lines = done.stdout.strip().splitlines()
        info = json.loads(lines[-1])
        outputs = {name: np.load(tmp_dir / "out" / f"{name}.npy") for name in info["outputs"]}
    info.update(start_s=info["t_main"] - start, wall_s=wall, lines=lines[:-1])
    return outputs, info
