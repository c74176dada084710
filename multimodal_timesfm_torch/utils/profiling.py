"""Profiling and step-timing utilities, on ``torch.profiler``.

Counterpart of ``multimodal_timesfm_tpu/utils/profiling.py``. ``trace()``
wraps a block in a ``torch.profiler`` trace written as a gzipped Chrome trace
(viewable in Perfetto or ``chrome://tracing``); :func:`summarize_trace` and
:func:`gemm_efficiency` read the newest one back offline; ``Throughput``
keeps step-time and series-per-second counters.

The event categories read are those of PyTorch's Chrome-trace export:
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` run on the device; ``cpu_op``
(an aten op or a ``record_function`` span) and ``python_function`` run on
the host. A device event carries the ``External id`` of the host op that
launched it, and a host op records its ``Input Dims`` when shapes are
recorded.
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterator

import torch

# The dense bf16 peak of one H100 SXM (NVIDIA's data sheet, 700 W).
H100_PEAK_FLOPS = 989e12
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "python_function")
# The GEMM ops whose FLOPs are read from their Input Dims (the trace carries none).
GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::matmul")


@contextlib.contextmanager
def trace(log_dir: str | Path, enabled: bool = True, host: bool = True) -> Iterator[None]:
    """Profile the enclosed block to a ``*.pt.trace.json.gz`` under ``log_dir`` (no-op
    when disabled).

    Device activity is recorded where a CUDA device is present, and the block
    ends with a synchronise so that its kernels are in the trace. ``host``
    also records the host's ops with their input shapes (what
    :func:`gemm_efficiency` needs); without it only the device's activity is
    recorded, which leaves the host's pace as it is unprofiled (without a CUDA device the
    host is all there is, and is recorded either way).
    """
    if not enabled:
        yield
        return
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU] if host or not cuda else []
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities, record_shapes=host) as prof:
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
    # time_ns at a fixed width: the newest trace sorts last by name.
    prof.export_chrome_trace(str(log_dir / f"trace_{time.time_ns():020d}.pt.trace.json.gz"))


def _newest_events(log_dir: str | Path) -> tuple[Path, list[dict]]:
    """(the newest trace under ``log_dir``, its events): the last by file name, which
    :func:`trace` gives the time it was written."""
    traces = sorted(Path(log_dir).rglob("*.trace.json.gz"), key=lambda p: p.name)
    if not traces:
        raise FileNotFoundError(f"no *.trace.json.gz under {log_dir}")
    with gzip.open(traces[-1]) as f:
        return traces[-1], json.load(f).get("traceEvents", [])


def summarize_trace(log_dir: str | Path, top: int | None = 20) -> dict:
    """Summarize the newest :func:`trace` under ``log_dir``.

    Returns:
        dict with ``trace_file``, ``device_busy_ms`` (the sum of the device
        events' durations), ``host_ms`` (the sum of the host ops' and Python
        functions' spans across host threads, overlaps included: a rough
        activity number, not wall time), and ``top_ops``: a list of
        ``(kernel name, total_ms, share_of_device)``, most expensive first
        (every one with ``top=None``).
    """
    trace_file, events = _newest_events(log_dir)
    ops: collections.Counter = collections.Counter()
    host = 0.0
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") in DEVICE_CATS:
            ops[e["name"]] += e.get("dur", 0)
        elif e.get("cat") in HOST_CATS:
            host += e.get("dur", 0)
    device_busy = sum(ops.values())
    total_op = device_busy or 1.0
    return {
        "trace_file": str(trace_file),
        "device_busy_ms": device_busy / 1e3,
        "host_ms": host / 1e3,
        "top_ops": [(name, dur / 1e3, dur / total_op) for name, dur in ops.most_common(top)],
    }


def _dims(shape: Any) -> list[int]:
    return [int(d) for d in shape] if isinstance(shape, list) else []


def gemm_flops(name: str, input_dims: list) -> float:
    """FLOPs of one call of a GEMM op of ``GEMM_OPS`` from its ``Input Dims``: 2·M·K·N,
    times the batch for the batched ones. 0 where the shapes do not make a GEMM."""
    dims = [_dims(d) for d in input_dims]
    if name in ("aten::addmm", "aten::baddbmm"):
        dims = dims[1:]  # the added term comes first
    if len(dims) < 2 or not dims[0] or not dims[1]:
        return 0.0
    a, b = dims[0], dims[1]
    if name == "aten::matmul":
        a = [1, *a] if len(a) == 1 else a  # a vector is one row
        b = [*b, 1] if len(b) == 1 else b  # or one column
        batch_a, batch_b = a[:-2], b[:-2]
        width = max(len(batch_a), len(batch_b))
        batch_a = [1] * (width - len(batch_a)) + batch_a
        batch_b = [1] * (width - len(batch_b)) + batch_b
        batch = math.prod(max(x, y) for x, y in zip(batch_a, batch_b))
        return 2.0 * batch * a[-2] * a[-1] * b[-1]
    if name in ("aten::bmm", "aten::baddbmm"):
        if len(a) != 3 or len(b) != 3:
            return 0.0
        return 2.0 * a[0] * a[1] * a[2] * b[2]
    if len(a) != 2 or len(b) != 2:
        return 0.0
    return 2.0 * a[0] * a[1] * b[1]


def gemm_efficiency(log_dir: str | Path, peak_flops: float = H100_PEAK_FLOPS, top: int = 12) -> dict:
    """Per-GEMM sustained efficiency against ``peak_flops``, read from the newest trace.

    The trace carries no FLOP counts, so each GEMM op's FLOPs come from its
    ``Input Dims`` (:func:`gemm_flops`; a trace of :func:`trace` with
    ``host``), and its time is that of the device events that share its
    ``External id``, the kernels it launched itself. Read an eager call: a
    CUDA-graph replay's kernels carry the replay's id, not their ops'.
    Device time that no GEMM op launched is ``non_flop_ms``.

    Returns dict with ``flop_ms``/``non_flop_ms``, ``weighted_eff`` (the
    duration-weighted fraction of peak across the GEMMs, the value to pass to
    ``python -m multimodal_timesfm_torch.roofline --eff``), and
    ``top_gemms``: ``(op and its input dims, calls, total_ms, gflop_per_call,
    frac_of_peak)``.
    """
    trace_file, events = _newest_events(log_dir)
    gemms: dict[Any, tuple[str, float]] = {}  # External id -> (row name, FLOPs)
    device: collections.Counter = collections.Counter()  # External id -> device us
    device_total = 0.0
    for e in events:
        if e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        if e.get("cat") == "cpu_op" and e.get("name") in GEMM_OPS:
            dims = args.get("Input Dims", [])
            flops = gemm_flops(e["name"], dims)
            if flops > 0:
                shapes = "x".join(str(_dims(d)) for d in dims if _dims(d))
                gemms[args.get("External id")] = (f"{e['name']} {shapes}", flops)
        elif e.get("cat") in DEVICE_CATS:
            device_total += e.get("dur", 0)
            device[args.get("External id")] += e.get("dur", 0)

    dur_us: collections.Counter = collections.Counter()
    calls: collections.Counter = collections.Counter()
    flops_per_call: dict[str, float] = {}
    for ext, (name, flops) in gemms.items():
        if device[ext] <= 0:  # an op whose GEMM an inner op launched (matmul over mm)
            continue
        dur_us[name] += device[ext]
        calls[name] += 1
        flops_per_call[name] = flops

    flop_us = sum(dur_us.values())
    flop_total = sum(flops_per_call[n] * calls[n] for n in dur_us)
    rows = [(n, calls[n], us / 1e3, flops_per_call[n] / 1e9,
             flops_per_call[n] * calls[n] / (us * 1e-6) / peak_flops) for n, us in dur_us.items()]
    rows.sort(key=lambda r: -r[2])
    weighted_eff = flop_total / (flop_us * 1e-6) / peak_flops if flop_us else 0.0
    return {
        "trace_file": str(trace_file),
        "flop_ms": flop_us / 1e3,
        "non_flop_ms": (device_total - flop_us) / 1e3,
        "weighted_eff": weighted_eff,
        "top_gemms": rows[:top],
    }


@dataclass
class Throughput:
    """Running step-time and items/sec counters."""

    total_items: int = 0
    total_seconds: float = 0.0
    steps: int = 0
    _t0: float = field(default=0.0, repr=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, items: int) -> float:
        """Record one timed step; returns its duration in seconds."""
        elapsed = time.perf_counter() - self._t0
        self.total_items += items
        self.total_seconds += elapsed
        self.steps += 1
        return elapsed

    @property
    def items_per_sec(self) -> float:
        return self.total_items / self.total_seconds if self.total_seconds else 0.0

    @property
    def mean_step_seconds(self) -> float:
        return self.total_seconds / self.steps if self.steps else 0.0
