"""The port's profiling module and roofline, on the CPU.

``utils/profiling.py`` is held to the JAX package's summaries
(``tests/test_utils.py``) on synthetic traces in PyTorch's Chrome-trace
format, and reads a real CPU trace of a tiny decoder step. The roofline's
copies of the bench's FLOP model and workloads equal ``bench.py``'s (imported
here only), its saved-bytes count of one layer equals a hand count, and its
CLI runs on the CPU with JAX, ``bench`` and orbax blocked.
"""

import dataclasses
import gzip
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
from multimodal_timesfm_tpu.models.chronos import Chronos2Config as JChronosConfig
from multimodal_timesfm_tpu.models.timesfm import TimesFMConfig as JTimesFMConfig
from multimodal_timesfm_tpu.utils.profiling import summarize_trace as jax_summarize_trace
from multimodal_timesfm_torch import roofline
from multimodal_timesfm_torch.data.collate import StackedDataset
from multimodal_timesfm_torch.models.chronos import Chronos2Config
from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig
from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
from multimodal_timesfm_torch.training_args import TrainingArguments
from multimodal_timesfm_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent


def _write_trace(root: Path, events: list[dict], name: str = "trace_1.pt.trace.json.gz") -> None:
    root.mkdir(parents=True, exist_ok=True)
    with gzip.open(root / name, "wt") as f:
        json.dump({"traceEvents": events}, f)


def _op(name, ext, dims, ts=0, dur=5):
    return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1, "tid": 1, "ts": ts, "dur": dur,
            "args": {"External id": ext, "Input Dims": dims}}


def _kernel(name, ext, dur, ts=0):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": {"External id": ext, "correlation": ext + 1000}}


def test_summarize_trace_aggregates_device_events(tmp_path):
    """Busy time is the sum of the kernel, memcpy and memset events; host time the sum of
    the host ops and Python functions (overlaps included); the launches and flow events
    count as neither. The newest trace is read."""
    events = [
        {"ph": "M", "pid": 0, "name": "process_name", "args": {"name": "GPU 0"}},
        _kernel("gemm_a", 1, 3000), _kernel("gemm_a", 2, 1000, ts=4000), _kernel("elementwise", 3, 500),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0, "tid": 8, "ts": 0, "dur": 400},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "pid": 0, "tid": 8, "ts": 0, "dur": 100},
        _op("aten::mm", 1, [[2, 2], [2, 2]], dur=1500),
        {"ph": "X", "cat": "python_function", "name": "forward", "pid": 1, "tid": 1, "ts": 0, "dur": 500},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1, "ts": 0, "dur": 900},
        {"ph": "s", "cat": "ac2g", "name": "flow", "pid": 1, "tid": 1, "ts": 0, "id": 1},
    ]
    _write_trace(tmp_path / "old", [_kernel("stale", 9, 99999)], "trace_0.pt.trace.json.gz")
    _write_trace(tmp_path / "new", events)
    s = profiling.summarize_trace(tmp_path)
    assert s["trace_file"].endswith("trace_1.pt.trace.json.gz")
    assert s["device_busy_ms"] == pytest.approx(5.0)
    assert s["host_ms"] == pytest.approx(2.0)
    top = {name: ms for name, ms, _ in s["top_ops"]}
    assert top == pytest.approx({"gemm_a": 4.0, "elementwise": 0.5, "Memcpy HtoD": 0.4, "Memset": 0.1})
    assert s["top_ops"][0][2] == pytest.approx(0.8)
    assert [n for n, _, _ in profiling.summarize_trace(tmp_path, top=2)["top_ops"]] == ["gemm_a", "elementwise"]
    # The keys of the JAX package's summary.
    jax_dir = tmp_path / "jax"
    _write_trace(jax_dir, [], "vm.trace.json.gz")
    assert set(s) == set(jax_summarize_trace(jax_dir))


@pytest.mark.parametrize("name,dims,flops", [
    ("aten::mm", [[64, 32], [32, 16]], 2 * 64 * 32 * 16),
    ("aten::addmm", [[16], [64, 32], [32, 16], [], []], 2 * 64 * 32 * 16),
    ("aten::bmm", [[3, 64, 32], [3, 32, 16]], 2 * 3 * 64 * 32 * 16),
    ("aten::baddbmm", [[3, 64, 16], [3, 64, 32], [3, 32, 16], [], []], 2 * 3 * 64 * 32 * 16),
    ("aten::matmul", [[5, 3, 64, 32], [32, 16]], 2 * 15 * 64 * 32 * 16),
    ("aten::matmul", [[2, 1, 64, 32], [4, 32, 16]], 2 * 8 * 64 * 32 * 16),
    ("aten::matmul", [[32], [32, 16]], 2 * 32 * 16),
    ("aten::mm", [[64, 32], []], 0),
])
def test_gemm_flops_from_input_dims(name, dims, flops):
    assert profiling.gemm_flops(name, dims) == flops


def test_gemm_efficiency_reads_flops_from_input_dims(tmp_path):
    """Each GEMM op's FLOPs from its Input Dims, its time from the kernels sharing its
    External id; an outer matmul whose mm launched the kernel counts once; device time no
    GEMM launched is non-FLOP time."""
    gf = 2 * 1000 * 500 * 1000  # 1 GFLOP
    events = [
        _op("aten::matmul", 10, [[1000, 500], [500, 1000]]),  # launches nothing itself
        _op("aten::mm", 11, [[1000, 500], [500, 1000]]), _kernel("sm90_gemm", 11, 10),
        _op("aten::mm", 12, [[1000, 500], [500, 1000]]), _kernel("sm90_gemm", 12, 6), _kernel("splitk", 12, 4),
        _op("aten::addmm", 13, [[1000], [1000, 500], [500, 1000], [], []]), _kernel("sm90_gemm", 13, 40),
        _op("aten::add", 14, [[1000], [1000]]), _kernel("elementwise", 14, 30),
    ]
    _write_trace(tmp_path, events)
    s = profiling.gemm_efficiency(tmp_path, peak_flops=2e14)
    # mm: 2 calls, 2 GF over 20 us = 1e14 FLOP/s = 0.5 of peak; addmm: 1 GF / 40 us = 0.125.
    assert s["flop_ms"] == pytest.approx(0.06)
    assert s["non_flop_ms"] == pytest.approx(0.03)
    assert s["weighted_eff"] == pytest.approx(3 * gf / 60e-6 / 2e14)
    rows = {op: (calls, ms, gflop, eff) for op, calls, ms, gflop, eff in s["top_gemms"]}
    assert rows["aten::mm [1000, 500]x[500, 1000]"] == pytest.approx((2, 0.02, 1.0, 0.5))
    assert rows["aten::addmm [1000]x[1000, 500]x[500, 1000]"] == pytest.approx((1, 0.04, 1.0, 0.125))
    assert len(rows) == 2
    assert s["top_gemms"][0][0].startswith("aten::addmm")


def test_a_missing_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.summarize_trace(tmp_path)
    with pytest.raises(FileNotFoundError):
        profiling.gemm_efficiency(tmp_path)


def _tiny_trainer(num_layers=2, batch=8, tokens=16, mode="multimodal", device="cpu", dtype=torch.float32):
    cfg = dataclasses.replace(TimesFMConfig.tiny(), num_layers=num_layers, compute_dtype=dtype)
    with torch.device(device):
        decoder = MultimodalDecoder(TimesFM2p5Adapter(cfg), MultimodalDecoderConfig(text_embedding_dims=6),
                                    device=device)
    patch = decoder.adapter.patch_len
    rng = np.random.default_rng(0)
    data = StackedDataset(
        context=rng.normal(size=(batch, tokens * patch)).astype(np.float32),
        horizon=rng.normal(size=(batch, 8)).astype(np.float32),
        text_embeddings=rng.normal(size=(batch, tokens, 6)).astype(np.float32) if mode == "multimodal" else None,
        metadata=[{}] * batch,
    )
    args = TrainingArguments(output_dir="unused", per_device_train_batch_size=batch,
                             per_device_eval_batch_size=batch, num_train_epochs=1, save_strategy="no",
                             logging_strategy="no")
    return MultimodalTrainer(decoder, args, data, data, mode, device=device), cfg


def test_a_cpu_trace_of_a_decoder_step_is_read_back(tmp_path):
    """A real trace of one optimizer step of a tiny decoder on the CPU: the host's ops with
    their shapes, no device events; the GEMMs' Input Dims give FLOPs; a disabled trace writes
    nothing."""
    trainer, _ = _tiny_trainer()
    batch = trainer.args.per_device_train_batch_size
    mb = trainer._micro_batch(trainer.train_data, trainer._train_device, np.arange(batch),
                              np.ones(batch, np.float32), float(batch))
    with profiling.trace(tmp_path / "off", enabled=False):
        trainer._optimizer_step([mb])
    assert not (tmp_path / "off").exists()
    throughput = profiling.Throughput()
    throughput.start()
    with profiling.trace(tmp_path / "on"):
        trainer._optimizer_step([mb])
    assert throughput.stop(batch) > 0 and throughput.items_per_sec > 0 and throughput.steps == 1
    s = profiling.summarize_trace(tmp_path / "on")
    assert s["trace_file"].endswith(".pt.trace.json.gz")
    assert s["device_busy_ms"] == 0 and s["top_ops"] == [] and s["host_ms"] > 0
    _, events = profiling._newest_events(tmp_path / "on")
    gemms = [e for e in events if e.get("cat") == "cpu_op" and e["name"] in profiling.GEMM_OPS]
    assert gemms and all(profiling.gemm_flops(e["name"], e["args"]["Input Dims"]) > 0
                         for e in gemms if e["name"] != "aten::matmul")
    g = profiling.gemm_efficiency(tmp_path / "on")
    assert (g["flop_ms"], g["weighted_eff"], g["top_gemms"]) == (0, 0.0, [])


@pytest.mark.parametrize("workload", sorted(bench.WORKLOADS))
def test_roofline_copies_equal_the_bench(workload):
    """The port's copies of the bench's workloads and FLOP model give the bench's numbers
    (the bench's take the JAX configs, the port's its own), with and without the fold."""
    assert roofline.WORKLOADS[workload] == bench.WORKLOADS[workload]
    assert roofline.WORKLOAD_ARCH.get(workload) == bench.WORKLOAD_ARCH.get(workload)
    backbone, context, horizon, _, _, _, mode = bench.WORKLOADS[workload]
    arch = bench.WORKLOAD_ARCH.get(workload, {})
    if backbone == "timesfm":
        jcfg, tcfg = dataclasses.replace(JTimesFMConfig(), **arch), dataclasses.replace(TimesFMConfig(), **arch)
        for fold in (True, False):
            assert roofline.timesfm_flops_per_series(tcfg, context, mode, fold=fold) == \
                bench.timesfm_flops_per_series(jcfg, context, mode, fold=fold)
    else:
        jcfg, tcfg = dataclasses.replace(JChronosConfig(), **arch), dataclasses.replace(Chronos2Config(), **arch)
        assert roofline.chronos_flops_per_series(tcfg, context, mode, horizon=horizon) == \
            bench.chronos_flops_per_series(jcfg, context, mode, horizon=horizon)


def test_saved_bytes_of_one_layer_equal_a_hand_count():
    """Two layers against one, multimodal fp32 at 16 tokens (the B1 route; the frozen norms'
    gains and the query scale folded): one layer saves its input x and the RMS norm's
    rsqrt r for the norm; the qkv projection and the key mask for the B1 kernel; the
    residual x1 (by the variance), x1 - mean and the LayerNorm's rsqrt; the ReLU's output;
    and the padding mask of the FFN residual. The frozen GEMMs save only their weights,
    which the weight term counts."""
    b1, _ = roofline.saved_bytes(_tiny_trainer(1, device="meta")[0])
    b2, _ = roofline.saved_bytes(_tiny_trainer(2, device="meta")[0])
    _, cfg = _tiny_trainer(1, device="meta")
    rows, d, f = 8 * 16, cfg.model_dims, cfg.ffn_dims
    hd = cfg.num_heads * (d // cfg.num_heads)
    fp32 = rows * 4 * (d + 1 + 3 * hd + d + d + 1 + f + 1)
    assert b2 - b1 == fp32 + rows  # + the bool key mask


def test_the_roofline_runs_on_the_cpu_without_jax_bench_or_orbax():
    """``python -m multimodal_timesfm_torch.roofline --json`` with JAX, the JAX package, the
    bench and orbax blocked: one JSON line with the JAX script's keys, H100 constants."""
    code = (
        "import sys, runpy\n"
        "for name in ('jax', 'jaxlib', 'multimodal_timesfm_tpu', 'bench', 'orbax'):\n"
        "    sys.modules[name] = None\n"
        "sys.argv = ['roofline', '--workload', 'timesfm_mm_c32', '--json']\n"
        "runpy.run_module('multimodal_timesfm_torch.roofline', run_name='__main__')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == ["workload", "batch", "steps_per_dispatch", "flops_per_series", "gemm_eff",
                          "ms_compute", "ms_weights", "ms_residual", "ms_fixed", "ms_val", "ms_total",
                          "residual_stream_mb", "num_residual_streams", "ceiling_mfu",
                          "ceiling_series_per_sec", "weight_note"]
    assert (roofline.PEAK, roofline.HBM_BW) == (989e12, 3.35e12)
    assert roofline.FIXED_DISPATCH_S != 0.116
    fps = line["flops_per_series"]
    assert line["ms_compute"] == round(fps * 2048 / (989e12 * roofline.DEFAULT_EFF) * 1e3, 2)
    assert line["residual_stream_mb"] > 0 and line["weight_note"].startswith("frozen bf16 weights")
