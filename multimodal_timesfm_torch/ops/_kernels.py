"""Build, load and launch the port's CUDA kernels.

The sources under ``multimodal_timesfm_torch/csrc/`` are compiled with
``nvcc`` for ``sm_90a``, one ``nvcc`` per source, all started together, and
linked into one shared library with a plain C interface, at first use, into
``build/torch_kernels/`` at the repository root, and bound with ``ctypes``.
The library's file name carries a hash of every file under ``csrc/`` (the
sources and the headers they include) and of the flags, so an edited source
or header is rebuilt. Nothing here runs at import: the CPU tests import every
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
CSRC = _PKG / "csrc"
SOURCES = tuple(
    CSRC / name
    for name in ("attention_fwd.cu", "attention_bwd.cu", "attention_fwd_hopper.cu",
                 "attention_bwd_hopper.cu", "attention_fwd_short_hopper.cu",
                 "attention_bwd_short_hopper.cu", "chronos_attention.cu",
                 "chronos_attention_bwd.cu", "chronos_attention_hopper.cu",
                 "chronos_attention_bwd_hopper.cu", "chronos_attention_short_hopper.cu",
                 "chronos_attention_bwd_short_hopper.cu", "chronos_attention_tf32.cu",
                 "chronos_attention_bwd_tf32.cu", "attention_fwd_tf32.cu", "attention_bwd_tf32.cu",
                 "attention_fwd_tf32_hopper.cu", "attention_bwd_tf32_hopper.cu",
                 "chronos_attention_short_tf32.cu", "chronos_attention_bwd_short_tf32.cu",
                 "chronos_attention_tf32_hopper.cu", "chronos_attention_bwd_tf32_hopper.cu")
)
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
    """Where the library of the current sources lives: named by a hash of every file
    under :data:`CSRC` (names and contents) and of the nvcc flags."""
    digest = hashlib.sha256()
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        digest.update(path.relative_to(CSRC).as_posix().encode() + b"\0")
        digest.update(path.read_bytes())
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
    lib.attention_bwd_scratch.argtypes = [ptr] * 7 + [i32] * 5 + [i64] * 3
    lib.attention_bwd_scratch.restype = i64
    lib.chronos_attention_fwd.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
    lib.chronos_attention_fwd.restype = i32
    lib.chronos_attention_bwd.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
    lib.chronos_attention_bwd.restype = i32
    for fn in (lib.attention_fwd_config, lib.attention_bwd_config):
        fn.argtypes = [i32, i32, i32, ctypes.POINTER(i32)]
        fn.restype = i32
    lib.chronos_attention_config.argtypes = [i32] * 6 + [ctypes.POINTER(i32)]
    lib.chronos_attention_config.restype = i32
    lib.chronos_attention_bwd_buffers.argtypes = [i32] * 5 + [ctypes.POINTER(i64)]
    lib.chronos_attention_bwd_buffers.restype = i32
    for fn in (lib.attention_set_route, lib.chronos_set_route):
        fn.argtypes = [i32]
        fn.restype = i32
    return lib


_ROUTES = ("fp32 CUDA cores", "bf16 mma.sync m16n8k16", "bf16 wgmma + TMA, warp-specialised",
           "bf16 mma.sync m16n8k16 fed by TMA, persistent, one pass", "fp32 3xTF32 mma.sync m16n8k8",
           "fp32 3xTF32 wgmma m64nNk8 fed by TMA, warp-specialised")
ROUTE_NAMES = {"rule": 0, "mma.sync": 1, "wgmma": 2, "cuda cores": 3, "tf32 mma.sync": 4, "tf32 wgmma": 5}
# The Chronos overrides carry the numbers of the plan's routes they force (``_CHRONOS_ROUTES``):
# "mma.sync" route 1 (or 2 past its limits), "wgmma" 3, "tf32 mma.sync" 5, "tf32 persistent" 6,
# "tf32 wgmma" 7; "cuda cores" (route 0, whose number is the rule's) takes 4, the number of the
# bf16 persistent route, which has no override of its own, as the causal family's "cuda cores"
# takes 3.
CHRONOS_ROUTE_NAMES = {"rule": 0, "mma.sync": 1, "wgmma": 3, "cuda cores": 4, "tf32 mma.sync": 5,
                       "tf32 persistent": 6, "tf32 wgmma": 7}
# The lengths from which the library's dispatch gives an fp32 call at head_dim 80 route 5 (3xTF32
# wgmma fed by TMA) in place of route 4 (3xTF32 mma.sync): ``kFwdFrom`` of
# csrc/attention_fwd_tf32_hopper.cu and ``kBwdFrom`` of csrc/attention_bwd_tf32_hopper.cu, the
# borders chip_smoke.py's ``[gate] causal fp32`` lines measure. :func:`causal_f32_route` follows
# that rule without the library; chip_smoke.py holds the two to each other on the card.
TF32_WGMMA_FROM = {"forward": 128, "backward": 128}
# The lengths at which the library's dispatch gives an fp32 Chronos call at head_dim 64 route 6
# (3xTF32 mma.sync fed by TMA, persistent) in place of route 5: from ``kShortFwdFrom`` to
# ``kShortFwdTo`` of csrc/chronos_attention_short_tf32.cu, up to ``kShortTo`` of
# csrc/chronos_attention_bwd_short_tf32.cu, the borders chip_smoke.py's ``[gate] chronos fp32
# persistent`` lines measure. :func:`chronos_f32_route` follows that rule without the library.
CHRONOS_TF32_SHORT_FROM = {"forward": 17, "backward": 1}
CHRONOS_TF32_SHORT_TO = {"forward": 112, "backward": 80}
# The lengths from which the library's dispatch gives an fp32 Chronos call at head_dim 64 that
# route 6 leaves route 7 (3xTF32 wgmma fed by TMA) in place of route 5: ``kFwdFrom`` of
# csrc/chronos_attention_tf32_hopper.cu and ``kBwdFrom`` of csrc/chronos_attention_bwd_tf32_hopper.cu,
# the borders chip_smoke.py's ``[gate] chronos fp32 wgmma`` lines measure.
CHRONOS_TF32_WGMMA_FROM = {"forward": 160, "backward": 385}


def set_route(name: str) -> None:
    """Which route the causal attention kernels take: ``"rule"`` (the library's dispatch
    rule, the default), ``"mma.sync"`` (bf16 never on the wgmma or a persistent route),
    ``"wgmma"`` (bf16 on the wgmma route at every S its layout rule allows; never a persistent
    route), ``"cuda cores"`` (fp32 never on a 3xTF32 route), ``"tf32 mma.sync"`` (fp32 never on
    the 3xTF32 wgmma route: the 3xTF32 mma.sync route by its own rule) or ``"tf32 wgmma"``
    (fp32 on the 3xTF32 wgmma route at every S its layout rule allows); the last three leave
    bf16 to the rule. For measuring the borders between them (``chip_smoke.py``'s ``[gate]``
    lines); process-wide, in the library."""
    err = library().attention_set_route(ROUTE_NAMES[name])
    if err != 0:
        raise RuntimeError(f"attention_set_route({name!r}) failed with CUDA error {err}")


def set_chronos_route(name: str) -> None:
    """Which route the Chronos attention kernels take at head_dim 64: ``"rule"`` (the
    library's dispatch rule, the default), ``"mma.sync"`` (bf16 never on the wgmma or a
    persistent route: the one-pass or tiled mma.sync route by their own limits), ``"wgmma"``
    (bf16 on the wgmma route at every S; never a persistent route), ``"cuda cores"`` (fp32
    never on a 3xTF32 route), ``"tf32 mma.sync"`` (fp32 on route 5 at every S, never on route
    6 or 7), ``"tf32 persistent"`` (fp32 on route 6 at every S it is built for, the rule's
    route 7 or 5 past that) or ``"tf32 wgmma"`` (fp32 on route 7 at every S, never on route
    6); the first three leave fp32 to the rule, the last four bf16. For measuring the
    borders (``chip_smoke.py``'s Chronos ``[gate]`` lines); process-wide, in the library."""
    err = library().chronos_set_route(CHRONOS_ROUTE_NAMES[name])
    if err != 0:
        raise RuntimeError(f"chronos_set_route({name!r}) failed with CUDA error {err}")


def chronos_f32_route(backward: bool, seq: int, dim: int) -> int:
    """The route the library's rule (no override) gives an fp32 Chronos call, by number: 6 at
    head_dim 64 from :data:`CHRONOS_TF32_SHORT_FROM` to :data:`CHRONOS_TF32_SHORT_TO`, else 7 at
    head_dim 64 from :data:`CHRONOS_TF32_WGMMA_FROM`, 5 at head_dim 64 below that, 0 (the CUDA
    cores) at other head dims. chip_smoke.py holds it to the library's plan on the card."""
    if dim != 64:
        return 0
    way = "backward" if backward else "forward"
    if CHRONOS_TF32_SHORT_FROM[way] <= seq <= CHRONOS_TF32_SHORT_TO[way]:
        return 6
    return 7 if seq >= CHRONOS_TF32_WGMMA_FROM[way] else 5


def _attention_config(backward: bool, dtype: torch.dtype, seq: int, dim: int) -> list[int]:
    """``attention_fwd_config`` / ``attention_bwd_config`` of the library for (dtype, S, D)."""
    cfg = (ctypes.c_int * 8)()
    fn = library().attention_bwd_config if backward else library().attention_fwd_config
    err = fn(_DTYPE_CODES[dtype], seq, dim, cfg)
    if err != 0:
        raise RuntimeError(f"no attention route for {dtype} S={seq} D={dim} (CUDA error {err})")
    return list(cfg)


def attention_route_number(backward: bool, dtype: torch.dtype, seq: int, dim: int) -> int:
    """The causal kernels' route for (dtype, S, head_dim) by number: 0 fp32 on the CUDA cores,
    1 mma.sync, 2 wgmma, 3 the bf16 persistent one-pass route (short S), 4 fp32 3xTF32 on
    mma.sync, 5 fp32 3xTF32 on wgmma fed by TMA."""
    return _attention_config(backward, dtype, seq, dim)[0]


def causal_f32_route(backward: bool, inputs: tuple[torch.Tensor, ...], outputs: tuple[torch.Tensor, ...]) -> int:
    """The route the library's rule (no override) gives an fp32 call of the causal kernels, by
    number (5, 4 or 0), from its tensors alone: ``inputs`` the (B, S, H, D) views the kernels
    read (q, k, v, and g for the backward), ``outputs`` those they write. Route 5 from
    :data:`TF32_WGMMA_FROM` at head_dim 80 where TMA reads every input (base and row stride
    ``stride(1)`` 16-byte aligned) and every output is written 8 bytes a lane (base 8-byte
    aligned, row stride even); route 4 under the same layout rule at head_dim 80 below that
    length; the CUDA cores otherwise. Works on meta tensors (their ``data_ptr`` is the storage
    offset in bytes)."""
    seq, dim = inputs[0].shape[1], inputs[0].shape[3]
    reads = all(t.data_ptr() % 16 == 0 and t.stride(1) % 4 == 0 for t in inputs)
    writes = all(t.data_ptr() % 8 == 0 and t.stride(1) % 2 == 0 for t in outputs)
    if dim != 80 or not (reads and writes):
        return 0
    return 5 if seq >= TF32_WGMMA_FROM["backward" if backward else "forward"] else 4


def attention_route(backward: bool, dtype: torch.dtype, seq: int, dim: int) -> str:
    """The route and tiles the causal attention kernels take for (dtype, S, head_dim), as the
    library's own dispatch reports them (``attention_fwd_config`` / ``attention_bwd_config``)."""
    cfg = _attention_config(backward, dtype, seq, dim)
    route, threads, rows, keys, heads, padded, cols = cfg[:7]
    text = (f"{_ROUTES[route]}, {threads} threads, {rows} query rows x {keys} keys per tile, "
            f"{heads} head(s) per block, head_dim {dim} padded to {padded}, {cols} output "
            f"columns per block")
    if route == 5:
        text += (", each product lo hi + hi lo + hi hi, operands split into hi and lo by the producers' converting "
                 "warps (transposed for P X)")
        if not backward:
            return text + (", one pass (online softmax), 2 consumer warpgroups of 64 rows + 1 producer warpgroup "
                           "(a TMA warp, 3 converting)")
        return text + (", 3 kernels (row statistics, dQ, dK and dV), each 1 consumer warpgroup of 64 rows + 1 "
                       "producer warpgroup (a TMA warp, 3 converting)")
    if route == 4:
        text += ", each product lo hi + hi lo + hi hi"
        if not backward:
            return text + ", one pass (online softmax)"
        return text + (", 2 kernels (dq: two walks over the keys, the row statistics first, W and dL of the "
                       "tile pairs on and below the diagonal written to a scratch; dK and dV from them, "
                       "recomputed above the diagonal), in chunks of (batch row, head) work items")
    if backward and route != 0:
        text += ", dL as " + ("a hi + lo bf16 pair" if cfg[7] else "one bf16 operand")
    if route == 2:
        text += (", one pass" if not backward else ", 3 kernels (row statistics, dQ, dK and dV)")
        text += ", 2 consumer warpgroups of 64 rows + 1 TMA producer warpgroup"
    if route == 3:
        text += (", 1 kernel (" + ("dQ, dK and dV of a work item, no statistics scratch" if backward
                                   else "whole-row softmax, W rounded to bf16 once normalised")
                 + f"), work items of {heads} head(s) x every row, 2 consumer groups of {threads // 64} "
                 "warp(s) + 1 TMA producer warp")
    return text


_CHRONOS_ROUTES = ("fp32 CUDA cores", "bf16 mma.sync m16n8k16 one-pass", "bf16 mma.sync m16n8k16 tiled",
                   "bf16 wgmma + TMA, warp-specialised",
                   "bf16 mma.sync m16n8k16 fed by TMA, persistent, one pass",
                   "fp32 3xTF32 mma.sync m16n8k8",
                   "fp32 3xTF32 mma.sync m16n8k8 fed by TMA, persistent, one pass",
                   "fp32 3xTF32 wgmma m64nNk8 fed by TMA, warp-specialised")
_CHRONOS_KEYS = ("route", "threads", "rows", "keys", "passes", "group", "groups", "padded", "cols", "split_dl")


def chronos_plan(backward: bool, dtype: torch.dtype, batch: int, seq: int, heads: int, dim: int) -> dict:
    """The plan the Chronos attention kernels take for (dtype, B, S, H, D), as the library's
    own dispatch reports it (``chronos_attention_config``): route, threads, query rows per
    block, keys per tile, passes over the keys, batch rows per block, blocks along the batch
    (the dbias partial planes), padded head_dim, output columns per block, dL split."""
    cfg = (ctypes.c_int * 10)()
    err = library().chronos_attention_config(int(backward), _DTYPE_CODES[dtype], batch, seq, heads, dim, cfg)
    if err != 0:
        raise RuntimeError(
            f"no Chronos attention route for {dtype} B={batch} S={seq} H={heads} D={dim} (CUDA error {err})"
        )
    return dict(zip(_CHRONOS_KEYS, cfg))


def chronos_route(backward: bool, dtype: torch.dtype, batch: int, seq: int, heads: int, dim: int) -> str:
    """:func:`chronos_plan` as one line of text."""
    p = chronos_plan(backward, dtype, batch, seq, heads, dim)
    if p["route"] == 7:
        text = (f"{_CHRONOS_ROUTES[7]}, {p['threads']} threads, {p['rows']} query rows a block x "
                f"{p['keys']}-row walked tiles, head_dim {dim}, each product lo hi + hi lo + hi hi, operands "
                f"split into hi and lo by the producers' converting warps (transposed for P X)")
        if not backward:
            return text + (", one pass (online softmax), 2 consumer warpgroups of 64 rows + 1 producer warpgroup "
                           "(a TMA warp, 3 converting)")
        return text + (f", per chunk of {p['group']} batch rows 3 kernels (row statistics; dQ, writing W and dL "
                       f"to a scratch; dK and dV from them, W^T and dL^T split in registers) and a 4th for dbias "
                       f"(dL summed over the batch in order), each 2 consumer warpgroups of 64 rows + 1 producer "
                       f"warpgroup (a TMA warp, 3 converting)")
    if p["route"] == 6:
        consumers = p["threads"] // 32 - 1
        groups = 1 if backward else consumers // (p["rows"] // 16)
        text = (f"{_CHRONOS_ROUTES[6]}, persistent blocks of {p['threads']} threads "
                f"({groups} consumer group(s) of {consumers // groups} warp(s) + 1 TMA "
                f"producer warp), each one head and a range of about {p['group']} batch rows "
                f"({p['groups']} blocks a head")
        if not backward:
            return text + (f"), {p['rows']} query rows x {p['keys']} keys a tile, 1 kernel (whole-row "
                           f"softmax, O = W V from W in registers), head_dim {dim}, each product lo hi + "
                           f"hi lo + hi hi")
        return text + (f": the dbias partials), {p['rows']} query rows x {p['keys']} keys a tile, two warps a "
                       f"16-row block (a half of the keys, then of the output columns), 1 kernel (dQ, dK and "
                       f"dV of a batch row, W and dL in shared memory, no scratch), head_dim {dim}, each "
                       f"product lo hi + hi lo + hi hi")
    if p["route"] == 4:
        warps = p["rows"] // 16  # a consumer group's
        text = (f"{_CHRONOS_ROUTES[4]}, persistent blocks of {p['threads']} threads "
                f"({(p['threads'] // 32 - 1) // warps} consumer group(s) of {warps} warp(s) + 1 TMA "
                f"producer warp), each one head and a range of about {p['group']} batch rows "
                f"({p['groups']} blocks a head")
        if not backward:
            return text + (f"), {p['rows']} query rows x {p['keys']} keys a tile, 1 kernel (whole-row "
                           f"softmax, W rounded to bf16 once normalised), head_dim {dim}")
        return text + (f": the dbias partials), {p['rows']} query rows x {p['keys']} keys a tile, 1 "
                       f"kernel (dQ, dK and dV of a batch row, no statistics scratch), head_dim {dim}, dL "
                       f"as a hi + lo bf16 pair")
    if p["route"] == 3:
        text = (f"{_CHRONOS_ROUTES[3]}, persistent blocks of {p['threads']} threads (2 consumer "
                f"warpgroups of 64 rows + 1 TMA producer warpgroup), work items of {p['rows']} rows, "
                f"{p['keys']}-row tiles, head_dim {dim}")
        if backward:
            return text + (f", 3 kernels (row statistics, dQ, dK and dV) and a 4th for dbias (its blocks "
                           f"summed over the batch in order, in {p['groups']} group(s) of {p['group']} batch "
                           f"rows), dL as a hi + lo bf16 pair")
        return text + ", one pass (online softmax)"
    if p["route"] == 5:
        text = (f"{_CHRONOS_ROUTES[5]}, {p['threads']} threads, {p['rows']} query rows x {p['keys']} keys "
                f"per tile, head_dim {dim}, each product lo hi + hi lo + hi hi")
        if not backward:
            return text + ", one pass (online softmax)"
        return text + (f", 2 kernels (dq: {'two walks' if p['passes'] == 2 else 'one walk'} over the keys, "
                       f"the row statistics first, W and dL written to a scratch; dK and dV from them) and a "
                       f"3rd for dbias (dL summed over the batch in order)")
    text = (f"{_CHRONOS_ROUTES[p['route']]}, {p['threads']} threads, {p['rows']} query rows x "
            f"{p['keys']} keys per tile, {'one pass' if p['passes'] == 1 else 'two passes'}, "
            f"{p['group']} batch row(s) per block ({p['groups']} blocks along the batch), head_dim "
            f"{dim} padded to {p['padded']}, {p['cols']} output columns per block")
    if backward and p["route"] != 0:
        text += ", dL as " + ("a hi + lo bf16 pair" if p["split_dl"] else "one bf16 operand")
    return text


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


def _check_aux(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple[int, ...]) -> None:
    """A side input (mask, segment ids, bias) must have this dtype and shape, contiguous."""
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{name} must be {dtype} of shape {shape}, got {t.dtype} {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    aux: tuple[tuple[str, torch.Tensor], ...],
    others: tuple[tuple[str, torch.Tensor], ...],
) -> tuple[int, int, int, int]:
    """Device, dtype and layout checks shared by every launch; returns (B, S, H, D).

    ``aux`` tensors are only checked for their device (the caller checks
    their dtype and shape with :func:`_check_aux`); ``others`` must have q's
    dtype.
    """
    shape = tuple(q.shape)
    if len(shape) != 4:
        raise ValueError(f"q must be (B, S, H, D), got shape {shape}")
    batch, seq, heads, dim = shape
    dev = q.device
    floats = (("q", q), ("k", k), ("v", v), *others)
    for name, t in (*floats, *aux):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} is on {t.device}; the kernel needs every input on {dev} (CUDA)")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}; the kernel takes float32 or bfloat16")
    for name, t in floats:
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    if not 0 < dim <= 256:
        raise ValueError(f"head_dim {dim} outside the kernel's range 1..256")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_heads_view(name, t, shape, q.stride(1))
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
    batch, seq, heads, dim = _check_inputs(q, k, v, (("key_valid", key_valid),), (("out", out),))
    _check_aux("key_valid", key_valid, torch.bool, (batch, seq))
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
    """Launch the attention backward kernels on the current stream (one on the bf16
    persistent route, two or three on the others, two a chunk on the fp32 3xTF32 mma.sync
    route).

    q, k, v as for :func:`attention_fwd`; g: the output's cotangent, a
    (B, S, H, D) view with its own row stride; dq, dk, dv: (B, S, H, D) views
    sharing one row stride, written whole. The fp32 scratch the library's route needs
    (``attention_bwd_scratch``) is allocated here: none on the persistent route, one chunk's
    W and dL tiles and row statistics on the 3xTF32 mma.sync route, a (3, B, H, S rounded up
    to 64) one for the row statistics on the others. Raises ``RuntimeError`` if a launch is refused.
    """
    lib = library()
    outs = (("dq", dq), ("dk", dk), ("dv", dv))
    batch, seq, heads, dim = _check_inputs(q, k, v, (("key_valid", key_valid),), (("g", g), *outs))
    _check_aux("key_valid", key_valid, torch.bool, (batch, seq))
    shape = tuple(q.shape)
    _check_heads_view("g", g, shape, g.stride(1))
    for name, t in outs:
        _check_heads_view(name, t, shape, dq.stride(1))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr())
    floats = lib.attention_bwd_scratch(*ptrs, _DTYPE_CODES[q.dtype], batch, seq, heads, dim, q.stride(1),
                                       g.stride(1), dq.stride(1))
    stats = torch.empty(floats, dtype=torch.float32, device=q.device) if floats > 0 else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), None if stats is None else stats.data_ptr(),
            _DTYPE_CODES[q.dtype], batch, seq, heads, dim,
            q.stride(1), g.stride(1), dq.stride(1), stream,
        )
    if err != 0:
        raise RuntimeError(f"attention_bwd launch failed with CUDA error {err}")


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy of it when its data does not start 16-byte aligned (the
    wgmma routes read qkv and g by TMA and the fp32 3xTF32 mma.sync route by 16-byte cp.async, which
    need that; PyTorch's allocator gives it)."""
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.contiguous_format)


def _check_chronos(
    qkv: torch.Tensor, seg: torch.Tensor, bias: torch.Tensor, num_heads: int, head_dim: int,
    others: tuple[tuple[str, torch.Tensor], ...],
) -> tuple[int, int, int, int]:
    """Checks of the Chronos launches: qkv (B, S, 3*H*D) contiguous, seg int32 (B, S) and
    bias fp32 (H, S, S) contiguous, ``others`` contiguous in qkv's dtype. Returns
    (B, S, H, D)."""
    if qkv.dim() != 3 or qkv.shape[-1] != 3 * num_heads * head_dim:
        raise ValueError(
            f"qkv must be (B, S, 3*H*D) with H*D = {num_heads * head_dim}, got {tuple(qkv.shape)}"
        )
    for name, t in (("qkv", qkv), *others):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    hd = num_heads * head_dim
    q, k, v = (qkv[..., i * hd : (i + 1) * hd].unflatten(-1, (num_heads, head_dim)) for i in range(3))
    batch, seq, heads, dim = _check_inputs(q, k, v, (("seg", seg), ("bias", bias)), others)
    _check_aux("seg", seg, torch.int32, (batch, seq))
    _check_aux("bias", bias, torch.float32, (heads, seq, seq))
    return batch, seq, heads, dim


def chronos_attention_fwd(
    qkv: torch.Tensor, seg: torch.Tensor, bias: torch.Tensor, out: torch.Tensor,
    num_heads: int, head_dim: int,
) -> None:
    """Launch the Chronos attention forward kernel (B4f) on the current stream.

    qkv: (B, S, 3*H*D) contiguous, q unscaled; seg: (B, S) int32; bias:
    (H, S, S) fp32; out: (B, S, H*D) contiguous in qkv's dtype (16-byte aligned on
    the bf16 persistent route, which writes it 16 bytes a lane; PyTorch's allocator
    gives that). Validates device, dtype, shape and layout, and raises
    ``RuntimeError`` if the launch is refused.
    """
    lib = library()
    batch, seq, heads, dim = _check_chronos(qkv, seg, bias, num_heads, head_dim, (("out", out),))
    if tuple(out.shape) != (batch, seq, heads * dim):
        raise ValueError(f"out has shape {tuple(out.shape)}, expected {(batch, seq, heads * dim)}")
    qkv = _aligned16(qkv)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.chronos_attention_fwd(
            qkv.data_ptr(), seg.data_ptr(), bias.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[qkv.dtype], batch, seq, heads, dim, stream,
        )
    if err != 0:
        raise RuntimeError(f"chronos_attention_fwd launch failed with CUDA error {err}")


def chronos_attention_bwd(
    qkv: torch.Tensor, seg: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
    dqkv: torch.Tensor, dbias: torch.Tensor | None, num_heads: int, head_dim: int,
) -> None:
    """Launch the Chronos attention backward kernels (B4b) on the current stream.

    qkv, seg, bias as for :func:`chronos_attention_fwd`; g: (B, S, H*D) and
    dqkv: (B, S, 3*H*D), contiguous in qkv's dtype, dqkv written whole;
    dbias: (H, S, S) fp32, written whole, or None to skip the bias gradient.
    Allocates the scratch the library's ``chronos_attention_bwd_buffers`` asks for: off the
    plan's persistent routes (4, 6), a (3, B, H, S rounded up to 64) fp32 one for the row
    statistics (on the 3xTF32 route 5, one for the W and dL tiles of one chunk of batch rows;
    on route 7, both) and, with dbias, the (H, S, S) fp32 partial sums of dL the plan needs (one per
    block along the batch; none when there is one; past 65,535 batch rows, which run in
    chunks, the most a chunk needs and a plane for a chunk's own sum). Raises
    ``RuntimeError`` if a launch is refused.
    """
    lib = library()
    outs = (("g", g), ("dqkv", dqkv))
    batch, seq, heads, dim = _check_chronos(qkv, seg, bias, num_heads, head_dim, outs)
    if tuple(g.shape) != (batch, seq, heads * dim) or dqkv.shape != qkv.shape:
        raise ValueError(f"g {tuple(g.shape)} or dqkv {tuple(dqkv.shape)} does not match qkv")
    qkv, g = _aligned16(qkv), _aligned16(g)
    floats = (ctypes.c_longlong * 2)()
    err = lib.chronos_attention_bwd_buffers(_DTYPE_CODES[qkv.dtype], batch, seq, heads, dim, floats)
    if err != 0:
        raise RuntimeError(f"chronos_attention_bwd_buffers failed with CUDA error {err}")
    stats = torch.empty(floats[0], dtype=torch.float32, device=qkv.device) if floats[0] > 0 else None
    partials = None
    if dbias is not None:
        if dbias.device != qkv.device:
            raise ValueError(f"dbias is on {dbias.device}; the kernel needs it on {qkv.device}")
        _check_aux("dbias", dbias, torch.float32, (heads, seq, seq))
        partials = torch.empty(max(1, floats[1]), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.chronos_attention_bwd(
            qkv.data_ptr(), seg.data_ptr(), bias.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
            None if dbias is None else dbias.data_ptr(), None if stats is None else stats.data_ptr(),
            None if partials is None else partials.data_ptr(),
            _DTYPE_CODES[qkv.dtype], batch, seq, heads, dim, stream,
        )
    if err != 0:
        raise RuntimeError(f"chronos_attention_bwd launch failed with CUDA error {err}")
