#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what comes out.

Run from the repository root, on a host with one CUDA card:

    python3 chip_smoke.py [--seed N]

Phases (each prints its lines; any failure exits non-zero):

1. build: compile ``multimodal_timesfm_torch/csrc/attention_fwd.cu`` with
   nvcc for sm_90a; print the build seconds, the compiler's register and
   shared-memory report, and the card's name and power limit;
2. kernels: each CUDA kernel against its plain PyTorch version on the card,
   in fp32 and bf16, with left-padded key masks, at the shapes the serving
   path gives it; the kernel, the plain version and
   ``torch.nn.functional.scaled_dot_product_attention`` (a yardstick only;
   the port never calls it) are timed (device time from torch.profiler, and
   CUDA events around back-to-back calls) beside the least time the card
   could take for the same work;
3. slice: TimesFM-2.5 200M at full width (weights drawn from ``--seed`` with
   numpy, loaded through ``models/bridge.py``) with a one-layer 384-dim
   fusion MLP, served through ``Forecaster.forecast_dataset`` at contexts
   512, 2048 and 16384 in fp32 and bf16; the kernels' launch counters must
   show 20 launches (one per layer) per batch, and the first series of each
   context must agree with the same port run on the CPU in fp32; one more
   call per context and dtype runs under torch.profiler for the device's busy
   and idle time and the kernels that take it.

The line before the last names the card and its power limit; the last line
is ``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when no CUDA device is present or the port cannot be imported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# |kernel - plain| <= ATOL + RTOL * |plain| on valid query rows. fp32: only the
# summation order differs. bf16: both round the same fp32 accumulators to bf16,
# which may land one bf16 ulp (2^-8 relative) apart.
KERNEL_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# max |card - CPU fp32| <= TOL * std(CPU forecasts). fp32: GEMM summation
# order only. bf16: activations rounded in 20 layers of random weights (0.029
# measured at 4 layers on the CPU).
SLICE_TOL = {torch.float32: 2e-3, torch.bfloat16: 0.15}
HORIZON = 128
B1_SOURCE = "multimodal_timesfm_tpu/ops/qkv_attention.py:111"
B2_SOURCE = "multimodal_timesfm_tpu/ops/attention.py:174"
CU_SOURCE = "multimodal_timesfm_torch/csrc/attention_fwd.cu"


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip()


def time_ms(fn, iters: int) -> float:
    """Mean time per call of ``fn`` between two CUDA events around ``iters`` back-to-back
    calls, after one warm call. Includes any gap the host leaves between launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn) -> tuple[float, list[tuple[str, float]]]:
    """Run ``fn`` once under torch.profiler (CUDA activity only).

    Returns the host wall time in ms and [(kernel name, device ms)], largest
    first; the list is empty when the profiler records no device activity.
    """
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()]
    return wall_ms, sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])


def device_ms(fn, iters: int) -> tuple[float, float]:
    """(device ms, event ms) per call of ``fn``: the device time is the sum of the
    kernels the profiler records over ``iters`` calls; where it records none, the
    event time stands in for it."""
    event = time_ms(fn, iters)
    _, rows = device_profile(lambda: [fn() for _ in range(iters)])
    device = sum(ms for _, ms in rows) / iters
    return (device if device > 0 else event), event


def left_padded_valid(batch: int, seq: int, gen: torch.Generator) -> torch.Tensor:
    """(B, S) bool key mask, row b valid from a random pad length in [0, S/2); row 0 unpadded."""
    pads = torch.randint(0, seq // 2, (batch,), generator=gen, device="cuda")
    pads[0] = 0
    return torch.arange(seq, device="cuda")[None, :] >= pads[:, None]


def attention_bound(batch: int, seq: int, heads: int, dim: int, valid: torch.Tensor,
                    dtype: torch.dtype) -> tuple[float, str]:
    """Least time for causal key-padded attention: max(bytes / HBM rate, flops / peak).

    Bytes: q, k, v and the mask read once, the output written once. Flops:
    QK^T and PV over the (row, key) pairs this mask needs (key valid, key <= row).
    """
    elt = torch.finfo(dtype).bits // 8
    nbytes = 4 * batch * seq * heads * dim * elt + batch * seq
    rows_per_key = torch.arange(seq, 0, -1, device=valid.device)
    pairs = int((valid * rows_per_key).sum())
    flops = 4 * dim * heads * pairs
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def compare(what: str, out: torch.Tensor, ref: torch.Tensor, valid: torch.Tensor) -> float:
    """Kernel output vs plain output: every row finite, valid query rows within
    KERNEL_TOL. Returns the max abs difference on valid rows."""
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"{what} {out.dtype}: non-finite output")
    # Valid query rows: with left padding, row s sees a valid key iff s is valid.
    rows = valid.reshape(*valid.shape, *([1] * (out.dim() - 2)))
    err = (out.float() - ref.float()).abs()
    atol, rtol = KERNEL_TOL[out.dtype]
    if ((err - atol - rtol * ref.float().abs()) * rows).amax().item() > 0:
        raise AssertionError(
            f"{what} {out.dtype}: max |kernel - plain| {(err * rows).amax().item():.3g} "
            f"exceeds atol {atol} + rtol {rtol} * |plain|"
        )
    return (err * rows).amax().item()


def check_kernel(name: str, kernel, plain, sdpa, valid: torch.Tensor, dtype: torch.dtype,
                 shape: tuple[int, int, int, int], iters: int) -> dict:
    """Kernel vs plain version on the card; returns the measured row."""
    batch, seq, heads, dim = shape
    out = kernel()
    ref = plain()
    diff = compare(f"{name} {shape}", out, ref, valid)
    atol, rtol = KERNEL_TOL[dtype]
    bound_ms, bound_by = attention_bound(batch, seq, heads, dim, valid, dtype)
    ms, ms_ev = device_ms(kernel, iters)
    plain_ms, plain_ev = device_ms(plain, max(2, iters // 4))
    library_ms, library_ev = device_ms(sdpa, iters)
    row = {
        "max_abs_err": diff,
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    print(
        f"[kernels] {name} B={batch} S={seq} H={heads} D={dim} {str(dtype)[6:]}: "
        f"max_abs_err {diff:.3g} (atol {atol}, rtol {rtol}) | device ms: kernel {ms:.4f}, "
        f"plain {plain_ms:.4f}, sdpa {library_ms:.4f} | event ms: kernel {ms_ev:.4f}, "
        f"plain {plain_ev:.4f}, sdpa {library_ev:.4f} | bound {bound_ms:.4f} ms ({bound_by})",
        flush=True,
    )
    return row


def sdpa_fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor):
    """torch SDPA over the same inputs ((B, S, H, D) views), as a timing yardstick."""
    seq = q.shape[1]
    causal = torch.ones(seq, seq, dtype=torch.bool, device=q.device).tril()
    mask = causal[None, None] & valid[:, None, None, :]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, scale=1.0
    )


def kernel_phase(seed: int) -> dict[str, dict]:
    from multimodal_timesfm_torch.ops.attention import fused_causal_attention, plain_causal_attention
    from multimodal_timesfm_torch.ops.qkv_attention import (
        fused_qkv_causal_attention,
        plain_qkv_causal_attention,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[kernels] torch.backends.cuda.matmul.allow_tf32=False torch.backends.cudnn.allow_tf32=False")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    heads, dim = 16, 80
    rows: dict[str, dict] = {}
    for dtype in (torch.float32, torch.bfloat16):
        for batch, seq in ((64, 16), (64, 64), (64, 192)):
            qkv = torch.randn(batch, seq, 3 * heads * dim, generator=gen, device="cuda")
            qkv[..., : heads * dim] /= math.sqrt(dim)  # q arrives pre-scaled
            qkv = qkv.to(dtype)
            valid = left_padded_valid(batch, seq, gen)
            q, k, v = (t.unflatten(-1, (heads, dim)) for t in qkv.chunk(3, dim=-1))
            rows[f"B1f S={seq} {dtype}"] = check_kernel(
                "fused_qkv_causal_attention",
                lambda: fused_qkv_causal_attention(qkv, valid, heads, dim),
                lambda: plain_qkv_causal_attention(qkv, valid, heads, dim),
                sdpa_fn(q, k, v, valid), valid, dtype, (batch, seq, heads, dim), 50,
            )
        for batch, seq in ((8, 512), (8, 1024)):
            q, k, v = (
                torch.randn(batch, seq, heads, dim, generator=gen, device="cuda") for _ in range(3)
            )
            q = (q / math.sqrt(dim)).to(dtype)
            k, v = k.to(dtype), v.to(dtype)
            valid = left_padded_valid(batch, seq, gen)
            rows[f"B2f S={seq} {dtype}"] = check_kernel(
                "fused_causal_attention",
                lambda: fused_causal_attention(q, k, v, valid),
                lambda: plain_causal_attention(q, k, v, valid),
                sdpa_fn(q, k, v, valid), valid, dtype, (batch, seq, heads, dim), 20,
            )
    return rows


def edge_checks(seed: int) -> None:
    """Kernel vs plain version at shapes off the main path: a ragged last key tile,
    head dims that are not multiples of 32, and the largest head dim (256)."""
    from multimodal_timesfm_torch.ops.attention import fused_causal_attention, plain_causal_attention

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    for batch, seq, heads, dim in ((3, 264, 3, 20), (2, 40, 2, 40), (2, 300, 2, 256)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (
                torch.randn(batch, seq, heads, dim, generator=gen, device="cuda").to(dtype)
                for _ in range(3)
            )
            valid = left_padded_valid(batch, seq, gen)
            compare(
                f"edge case {(batch, seq, heads, dim)}",
                fused_causal_attention(q, k, v, valid), plain_causal_attention(q, k, v, valid), valid,
            )
    print("[kernels] edge shapes (B,S,H,D) (3,264,3,20) (2,40,2,40) (2,300,2,256), fp32 and bf16: "
          "kernel == plain within tolerance")


def flash_gate_check() -> None:
    """S > 2048 on CUDA must raise (the flash kernel, ROADMAP B3, is not ported)."""
    from multimodal_timesfm_torch.models.layers import Attention

    attn = Attention(32, 2, 16, torch.Generator().manual_seed(0)).cuda()
    x = torch.zeros(1, 2056, 32, device="cuda")
    try:
        attn(x, torch.zeros(1, 2056, dtype=torch.bool, device="cuda"))
    except NotImplementedError as exc:
        print(f"[gate] S=2056 on CUDA raises NotImplementedError: {exc}")
        return
    raise AssertionError("S=2056 on CUDA ran without the flash kernel instead of raising")


def make_samples(context: int, count: int, seed: int) -> list[dict]:
    """Synthetic Time-MMD-like samples: seasonal series with per-patch text embeddings."""
    rng = np.random.default_rng(seed + context)
    t = np.arange(context, dtype=np.float64)
    samples = []
    for _ in range(count):
        period = rng.uniform(8.0, 256.0)
        series = np.sin(2 * np.pi * t / period) + 0.01 * rng.normal() * t / 32 + 0.2 * rng.normal(size=context)
        samples.append({
            "context": series.astype(np.float32),
            "horizon": np.zeros(HORIZON, np.float32),
            "text_embeddings": rng.normal(size=(context // 32, 384)).astype(np.float32),
            "metadata": {"mean": float(rng.uniform(-50, 50)), "std": float(rng.uniform(0.5, 5.0))},
        })
    return samples


def slice_phase(seed: int) -> dict[str, int]:
    from multimodal_timesfm_torch.inference import Forecaster
    from multimodal_timesfm_torch.models.bridge import load_jax_params, random_jax_params
    from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
    from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig
    from multimodal_timesfm_torch.ops.attention import fused_causal_attention
    from multimodal_timesfm_torch.ops.qkv_attention import fused_qkv_causal_attention

    kind = torch.cuda.get_device_name(0)
    cfg = TimesFMConfig()  # 200M: md 1280, 20 layers, 16 x 80 heads, ffn 1280, patch 32, out 128 x 10
    dec_cfg = MultimodalDecoderConfig(text_embedding_dims=384, num_fusion_layers=1)

    def build(device: str, dtype: torch.dtype) -> MultimodalDecoder:
        adapter = TimesFM2p5Adapter(dataclasses.replace(cfg, compute_dtype=dtype))
        decoder = MultimodalDecoder(adapter, dec_cfg, device=device)
        load_jax_params(decoder, tree)
        return decoder

    t0 = time.perf_counter()
    tree = random_jax_params(MultimodalDecoder(TimesFM2p5Adapter(cfg), dec_cfg, device="cpu"), seed)
    decoders = {dtype: build("cuda", dtype) for dtype in (torch.float32, torch.bfloat16)}
    reference = build("cpu", torch.float32)
    n_params = sum(p.numel() for p in reference.parameters())
    print(f"[slice] {n_params:,} parameters from seed {seed} in {time.perf_counter() - t0:.1f} s")

    # context -> (series, batch size, series checked against the CPU)
    plan = {512: (200, 64, 8), 2048: (200, 64, 8), 16384: (16, 8, 2)}
    data = {ctx: make_samples(ctx, n, seed) for ctx, (n, _, _) in plan.items()}
    forecasters = {
        (dtype, ctx): Forecaster(dec, batch_size=bs, device="cuda")
        for dtype, dec in decoders.items() for ctx, (_, bs, _) in plan.items()
    }
    for (dtype, ctx), fc in forecasters.items():  # warm-up: cuBLAS handles, allocator
        fc.forecast_dataset(HORIZON, data[ctx][: plan[ctx][1]], denormalize=True)
    torch.cuda.synchronize()

    counters = (fused_qkv_causal_attention, fused_causal_attention)
    for fn in counters:
        fn.launches = 0
    preds = {}
    for (dtype, ctx), fc in forecasters.items():
        n, bs, _ = plan[ctx]
        before = [fn.launches for fn in counters]
        start = time.perf_counter()
        out = fc.forecast_dataset(HORIZON, data[ctx], denormalize=True)
        seconds = time.perf_counter() - start
        delta = [fn.launches - b for fn, b in zip(counters, before)]
        want = 20 * -(-n // bs)
        expected = [want, 0] if ctx < 16384 else [0, want]
        if delta != expected:
            raise AssertionError(f"context {ctx} {dtype}: launches (B1, B2) {delta}, expected {expected}")
        if out.shape != (n, HORIZON) or not np.isfinite(out).all():
            raise AssertionError(f"context {ctx} {dtype}: bad forecasts, shape {out.shape}")
        preds[(dtype, ctx)] = out
        print(
            f"[slice] context {ctx} {str(dtype)[6:]}: {n} series in {seconds:.4f} s = "
            f"{n / seconds:.1f} series/s on {kind} | launches B1 {delta[0]}, B2 {delta[1]}",
            flush=True,
        )
    launches = {"B1f": counters[0].launches, "B2f": counters[1].launches}

    for (dtype, ctx), fc in forecasters.items():
        wall, kernels = device_profile(
            lambda: fc.forecast_dataset(HORIZON, data[ctx], denormalize=True)
        )
        busy = sum(ms for _, ms in kernels)
        attn = sum(ms for name, ms in kernels if "attention_fwd_kernel" in name)
        top = ", ".join(f"{name[:60]} {ms:.3f} ms" for name, ms in kernels[:5])
        print(
            f"[profile] context {ctx} {str(dtype)[6:]}: wall {wall:.3f} ms, device busy "
            f"{busy:.3f} ms, idle {1 - busy / wall:.3f}, attention kernel {attn:.3f} ms | {top}",
            flush=True,
        )

    for ctx, (_, _, n_ref) in plan.items():
        ref_fc = Forecaster(reference, batch_size=n_ref, device="cpu")
        ref = ref_fc.forecast_dataset(HORIZON, data[ctx][:n_ref], denormalize=True)
        scale = float(ref.std())
        for dtype in decoders:
            err = float(np.abs(preds[(dtype, ctx)][:n_ref] - ref).max())
            tol = SLICE_TOL[dtype] * scale
            print(
                f"[slice] context {ctx} {str(dtype)[6:]} vs CPU fp32 ({n_ref} series): "
                f"max abs err {err:.4g}, tolerance {tol:.4g} ({SLICE_TOL[dtype]} x std {scale:.4g})"
            )
            if not err <= tol:
                raise AssertionError(f"context {ctx} {dtype}: card and CPU disagree")
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        from multimodal_timesfm_torch.ops import _kernels
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port ({exc}); run from the repository root", file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    lib_path = _kernels.library_path()
    _kernels.library()
    print(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s (nvcc {' '.join(_kernels.NVCC_FLAGS)})")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {line.strip()}")
    gpu = gpu_line()
    print(f"[gpu] {gpu} | torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)

    rows = kernel_phase(args.seed)
    edge_checks(args.seed)
    flash_gate_check()
    launches = slice_phase(args.seed)

    # One entry per kernel, timed at its main-path shape in bf16: B1 at
    # context 2048 (64 tokens, batch 64), B2 at context 16384 (512 tokens, batch 8).
    entries = []
    for key, name, source, batch, seq in (
        ("B1f", "fused_qkv_causal_attention", B1_SOURCE, 64, 64),
        ("B2f", "fused_causal_attention", B2_SOURCE, 8, 512),
    ):
        entries.append({
            "name": name, "route": "cuda", "source": CU_SOURCE, "replaces": source,
            "launches": launches[key], "shape": f"B={batch} S={seq} H=16 D=80 bfloat16",
            **rows[f"{key} S={seq} {torch.bfloat16}"],
        })
    print(json.dumps({"kernels": entries}))
    print(f"[gpu] {gpu}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
