#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what comes out.

Run from the repository root, on a host with one CUDA card:

    python3 chip_smoke.py [--seed N]

Phases (each prints its lines and its seconds; any failure exits non-zero):

1. build: compile ``multimodal_timesfm_torch/csrc/attention_fwd.cu`` and
   ``attention_bwd.cu`` with nvcc for sm_90a, one nvcc per source started
   together; print the build seconds, the compiler's register and
   shared-memory report, and the card's name and power limit;
2. kernels: each CUDA kernel against its plain PyTorch version on the card,
   in fp32 and bf16, with left-padded key masks (and, for the backward, the
   cotangent zeroed on padded query rows, as the model path leaves it), at
   the shapes the serving and training paths give it; the kernel, the plain
   version and ``torch.nn.functional.scaled_dot_product_attention`` (forward,
   or its backward under autograd; a yardstick only, the port never calls
   it) are timed (device time from torch.profiler, and CUDA events around
   back-to-back calls) beside the least time the card could take for the
   same work;
3. serving: TimesFM-2.5 200M at full width (weights drawn from ``--seed``
   with numpy, loaded through ``models/bridge.py``) with a one-layer 384-dim
   fusion MLP, served through ``Forecaster.forecast_dataset`` at contexts
   512, 2048 and 16384 in fp32 and bf16, three calls each (series/s is their
   median); the forward kernels' launch counters must show 20 launches (one
   per layer) per batch, the three calls must give the same forecasts, and the first
   series of each context must agree with the same port run on the CPU in
   fp32; one more call per context and dtype runs under torch.profiler for
   the device's busy and idle time and the kernels that take it;
4. training: the same model trained through ``MultimodalTrainer``
   (``train_epoch``, ``validate_epoch``) in multimodal mode at contexts 512
   (batch 256) and 16384 (batch 16), fp32 and bf16, and in baseline mode at
   context 512 in fp32, horizon 32; the counters must show 20 forward and
   20 backward launches of the right kernel per micro-batch plus the
   validation forwards; every loss finite; baseline mode must move
   ``per_dim_scale``; train series/s after a warm-up epoch and one profiled
   epoch per multimodal cell; and one optimizer step on the card against
   the same port on the CPU in fp32 (gradients, loss and updated
   parameters; at context 16384 both sides cut depth to 4 layers).

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
import tempfile
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# |kernel - plain| <= ATOL + RTOL * |plain| on valid query rows. fp32: only the
# summation order differs. bf16: both round the same fp32 accumulators to bf16,
# which may land one bf16 ulp (2^-8 relative) apart.
KERNEL_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# Backward kernel vs its plain version, |diff| <= ATOL + RTOL * |plain| on
# every element (the cotangent is zero on padded query rows). fp32: the same
# fp32 sums in another order, over terms up to ~50 (measured 1e-5). bf16: both
# round the same fp32 accumulators once, one bf16 ulp apart at most (2^-7
# relative just above a power of two).
BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# max |card - CPU fp32| <= TOL * std(CPU forecasts). fp32: GEMM summation
# order only. bf16: activations rounded in 20 layers of random weights (0.029
# measured at 4 layers on the CPU).
SLICE_TOL = {torch.float32: 2e-3, torch.bfloat16: 0.15}
# One optimizer step, card vs CPU, fp32. Loss: |diff| <= 1e-4 * |CPU loss|
# (summation order only). Gradients: ||card - CPU|| <= 1e-2 * ||CPU|| over all
# trained leaves. Summation order alone moves them by ~1e-6, but a ReLU whose
# input lies within fp32 rounding of 0 can take the other branch on the other
# device and move the whole gradient below it by a step (about 3e-3 at
# context 512, 20 layers, 4 series); the check prints, layer by layer, where
# the two backward passes first depart by more than 1e-4. Parameters:
# Adam's first update is lr * g / (|g| + eps), about lr * sign(g), so an
# element whose gradient is near zero may flip and move 2 lr apart; at most
# 1e-2 of the elements may differ by more than 1e-2 lr (a wrong backward
# flips about half of them).
TWIN_LOSS_RTOL, TWIN_GRAD_RTOL, TWIN_PARAM_FRAC = 1e-4, 1e-2, 1e-2
HORIZON = 128
SERVE_REPEATS = 3
TRAIN_HORIZON = 32
TRAIN_LR = 1e-4
# Baseline mode updates all 200M random weights: at 1e-4 one Adam step,
# about lr * sign(g) on every weight, raised the loss from 15.6 to 283.
BASELINE_LR = 1e-5
B1_SOURCE = "multimodal_timesfm_tpu/ops/qkv_attention.py:111"
B2_SOURCE = "multimodal_timesfm_tpu/ops/attention.py:174"
B1B_SOURCE = "multimodal_timesfm_tpu/ops/qkv_attention.py:141"
B2B_SOURCE = "multimodal_timesfm_tpu/ops/attention.py:189"
CU_SOURCE = "multimodal_timesfm_torch/csrc/attention_fwd.cu"
CU_BWD_SOURCE = "multimodal_timesfm_torch/csrc/attention_bwd.cu"


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


def backward_bound(batch: int, seq: int, heads: int, dim: int, valid: torch.Tensor,
                   dtype: torch.dtype) -> tuple[float, str]:
    """Least time for the attention backward: max(bytes / HBM rate, flops / peak).

    Bytes: q, k, v and g read once, dq, dk and dv written once, the mask read
    once. Flops: QK^T, G V^T, dV = W^T G, dQ = dL K and dK = dL^T Q over the
    (row, key) pairs this mask needs (key valid, key <= row), 10 D H each.
    """
    elt = torch.finfo(dtype).bits // 8
    nbytes = 7 * batch * seq * heads * dim * elt + batch * seq
    rows_per_key = torch.arange(seq, 0, -1, device=valid.device)
    pairs = int((valid * rows_per_key).sum())
    flops = 10 * dim * heads * pairs
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def compare_bwd(what: str, outs, refs) -> float:
    """Backward kernel outputs vs the plain version's: finite, every element within
    BWD_TOL. Returns the max abs difference."""
    torch.cuda.synchronize()
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = refs if isinstance(refs, tuple) else (refs,)
    worst = 0.0
    for out, ref in zip(outs, refs):
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"{what} {out.dtype}: non-finite gradient")
        err = (out.float() - ref.float()).abs()
        atol, rtol = BWD_TOL[out.dtype]
        if (err - atol - rtol * ref.float().abs()).amax().item() > 0:
            raise AssertionError(
                f"{what} {out.dtype}: max |kernel - plain| {err.amax().item():.3g} exceeds "
                f"atol {atol} + rtol {rtol} * |plain|"
            )
        worst = max(worst, err.amax().item())
    return worst


def sdpa_bwd_fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
                g: torch.Tensor):
    """The backward of torch SDPA under autograd, same inputs, as a timing yardstick."""
    seq = q.shape[1]
    causal = torch.ones(seq, seq, dtype=torch.bool, device=q.device).tril()
    mask = causal[None, None] & valid[:, None, None, :]
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=1.0)
    gh = g.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qh, kh, vh), gh, retain_graph=True)


def check_bwd_kernel(name: str, kernel, plain, sdpa_bwd, valid: torch.Tensor, dtype: torch.dtype,
                     shape: tuple[int, int, int, int], iters: int) -> dict:
    """Backward kernel vs its plain version on the card; returns the measured row."""
    batch, seq, heads, dim = shape
    diff = compare_bwd(f"{name} {shape}", kernel(), plain())
    atol, rtol = BWD_TOL[dtype]
    bound_ms, bound_by = backward_bound(batch, seq, heads, dim, valid, dtype)
    ms, ms_ev = device_ms(kernel, iters)
    plain_ms, plain_ev = device_ms(plain, max(2, iters // 4))
    library_ms, library_ev = device_ms(sdpa_bwd, iters)
    print(
        f"[kernels] {name} B={batch} S={seq} H={heads} D={dim} {str(dtype)[6:]}: "
        f"max_abs_err {diff:.3g} (atol {atol}, rtol {rtol}) | device ms: kernel {ms:.4f}, "
        f"plain {plain_ms:.4f}, sdpa backward {library_ms:.4f} | event ms: kernel {ms_ev:.4f}, "
        f"plain {plain_ev:.4f}, sdpa backward {library_ev:.4f} | bound {bound_ms:.4f} ms ({bound_by})",
        flush=True,
    )
    return {
        "max_abs_err": diff, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def padded_cotangent(shape: tuple[int, ...], valid: torch.Tensor, dtype: torch.dtype,
                     gen: torch.Generator) -> torch.Tensor:
    """A random output cotangent, zero on padded query rows (as the model path leaves it)."""
    g = torch.randn(*shape, generator=gen, device="cuda")
    return (g * valid.reshape(*valid.shape, *([1] * (g.dim() - 2)))).to(dtype)


def backward_kernel_phase(seed: int) -> dict[str, dict]:
    from multimodal_timesfm_torch.ops.attention import fused_causal_attention_bwd, plain_attention_bwd
    from multimodal_timesfm_torch.ops.qkv_attention import (
        fused_qkv_causal_attention_bwd,
        plain_qkv_attention_bwd,
        split_heads,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    heads, dim = 16, 80
    rows: dict[str, dict] = {}
    for dtype in (torch.float32, torch.bfloat16):
        for batch, seq in ((256, 16), (64, 64)):  # training contexts 512 and 2048
            qkv = torch.randn(batch, seq, 3 * heads * dim, generator=gen, device="cuda")
            qkv[..., : heads * dim] /= math.sqrt(dim)
            qkv = qkv.to(dtype)
            valid = left_padded_valid(batch, seq, gen)
            g = padded_cotangent((batch, seq, heads * dim), valid, dtype, gen)
            q, k, v = split_heads(qkv, heads, dim)
            rows[f"B1b S={seq} {dtype}"] = check_bwd_kernel(
                "fused_qkv_causal_attention_bwd",
                lambda: fused_qkv_causal_attention_bwd(qkv, valid, g, heads, dim),
                lambda: plain_qkv_attention_bwd(qkv, valid, g, heads, dim),
                sdpa_bwd_fn(q, k, v, valid, g.unflatten(-1, (heads, dim))),
                valid, dtype, (batch, seq, heads, dim), 20,
            )
        for batch, seq in ((16, 512), (8, 1024)):  # training context 16384, and S = 1024
            q, k, v = (
                torch.randn(batch, seq, heads, dim, generator=gen, device="cuda") for _ in range(3)
            )
            q = (q / math.sqrt(dim)).to(dtype)
            k, v = k.to(dtype), v.to(dtype)
            valid = left_padded_valid(batch, seq, gen)
            g = padded_cotangent((batch, seq, heads, dim), valid, dtype, gen)
            rows[f"B2b S={seq} {dtype}"] = check_bwd_kernel(
                "fused_causal_attention_bwd",
                lambda: fused_causal_attention_bwd(q, k, v, valid, g),
                lambda: plain_attention_bwd(q, k, v, valid, g),
                sdpa_bwd_fn(q, k, v, valid, g), valid, dtype, (batch, seq, heads, dim), 5,
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

    from multimodal_timesfm_torch.ops.attention import fused_causal_attention_bwd, plain_attention_bwd
    from multimodal_timesfm_torch.ops.qkv_attention import (
        fused_qkv_causal_attention_bwd,
        plain_qkv_attention_bwd,
    )

    for batch, seq, heads, dim in ((2, 40, 2, 40), (2, 300, 2, 256)):
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(batch, seq, 3 * heads * dim, generator=gen, device="cuda").to(dtype)
            valid = left_padded_valid(batch, seq, gen)
            g = padded_cotangent((batch, seq, heads * dim), valid, dtype, gen)
            what = f"backward edge case {(batch, seq, heads, dim)}"
            compare_bwd(what, fused_qkv_causal_attention_bwd(qkv, valid, g, heads, dim),
                        plain_qkv_attention_bwd(qkv, valid, g, heads, dim))
            q, k, v = (t.unflatten(-1, (heads, dim)) for t in qkv.chunk(3, dim=-1))
            g4 = g.unflatten(-1, (heads, dim))
            compare_bwd(what, fused_causal_attention_bwd(q, k, v, valid, g4),
                        plain_attention_bwd(q, k, v, valid, g4))
    print("[kernels] backward edge shapes (B,S,H,D) (2,40,2,40) (2,300,2,256), both entry points, "
          "fp32 and bf16: kernel == plain within tolerance")


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


def make_samples(context: int, count: int, seed: int, horizon: int = HORIZON) -> list[dict]:
    """Synthetic Time-MMD-like samples: seasonal series with per-patch text embeddings;
    the horizon is the series' continuation."""
    rng = np.random.default_rng(seed + context)
    t = np.arange(context + horizon, dtype=np.float64)
    samples = []
    for _ in range(count):
        period = rng.uniform(8.0, 256.0)
        series = (np.sin(2 * np.pi * t / period) + 0.01 * rng.normal() * t / 32
                  + 0.2 * rng.normal(size=t.size)).astype(np.float32)
        samples.append({
            "context": series[:context],
            "horizon": series[context:],
            "text_embeddings": rng.normal(size=(context // 32, 384)).astype(np.float32),
            "metadata": {"mean": float(rng.uniform(-50, 50)), "std": float(rng.uniform(0.5, 5.0))},
        })
    return samples


def slice_phase(seed: int) -> tuple[dict[str, int], dict, dict, object]:
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
        rates = []
        for _ in range(SERVE_REPEATS):  # the host's share at context 512 varies from call to call
            start = time.perf_counter()
            out = fc.forecast_dataset(HORIZON, data[ctx], denormalize=True)
            rates.append(n / (time.perf_counter() - start))
            if out.shape != (n, HORIZON) or not np.isfinite(out).all():
                raise AssertionError(f"context {ctx} {dtype}: bad forecasts, shape {out.shape}")
            if (dtype, ctx) in preds and not np.array_equal(out, preds[(dtype, ctx)]):
                raise AssertionError(f"context {ctx} {dtype}: forecasts differ between calls")
            preds[(dtype, ctx)] = out
        delta = [fn.launches - b for fn, b in zip(counters, before)]
        want = 20 * -(-n // bs) * SERVE_REPEATS
        expected = [want, 0] if ctx < 16384 else [0, want]
        if delta != expected:
            raise AssertionError(f"context {ctx} {dtype}: launches (B1, B2) {delta}, expected {expected}")
        print(
            f"[slice] context {ctx} {str(dtype)[6:]}: {n} series, median of {SERVE_REPEATS} calls "
            f"{float(np.median(rates)):.1f} series/s ({', '.join(f'{r:.1f}' for r in rates)}) on {kind} "
            f"| launches B1 {delta[0]}, B2 {delta[1]}",
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
    return launches, tree, decoders, reference


def _leaves(tree, prefix: str = "") -> dict[str, np.ndarray]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, value in items:
        out.update(_leaves(value, f"{prefix}/{key}"))
    return out


def _input_grad_hooks(decoder, store: dict) -> list:
    """Record the gradient reaching, per layer, the FFN down projection's input, the
    attention output (the out projection's input) and the layer's input. In the
    backward they arrive in that order: a departure between the first two lies in
    the FFN (down projection, ReLU, up projection, LayerNorm)."""
    handles = []
    for i, layer in enumerate(decoder.adapter.stacked_xf.layers):
        for name, module in ((f"layer {i} FFN down input", layer.ffn_down),
                             (f"layer {i} attention output", layer.attn.out),
                             (f"layer {i} input", layer)):
            def pre(_, args, name=name):
                if args[0].requires_grad:
                    args[0].register_hook(lambda g: store.__setitem__(name, g.detach().cpu().numpy()))
            handles.append(module.register_forward_pre_hook(pre))
    return handles


def first_departure(card: dict, cpu: dict, threshold: float = 1e-4) -> str:
    """Walk the recorded gradients in the order the backward pass produced them; name where
    card and CPU first differ by more than ``threshold`` (norm-relative)."""
    worst_above = 0.0
    for name in cpu:
        rel = float(np.linalg.norm(card[name] - cpu[name]) / np.linalg.norm(cpu[name]))
        if rel > threshold:
            return (f"backward passes agree to {worst_above:.2g} down to {name}, "
                    f"where they first differ by {rel:.2g}")
        worst_above = max(worst_above, rel)
    return f"backward passes agree to {worst_above:.2g} at every layer"


def twin_check(label: str, mode: str, context: int, decoders: dict, tree: dict, seed: int,
               workdir: str) -> None:
    """One optimizer step of the same port on the card and on the CPU, fp32: the gradient of
    the first micro-batch, the step's loss and the updated trained parameters."""
    from multimodal_timesfm_torch.models.bridge import export_jax_params, load_jax_params
    from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
    from multimodal_timesfm_torch.training_args import TrainingArguments

    n = 4
    data = make_samples(context, n, seed + 3, TRAIN_HORIZON)
    args = TrainingArguments(
        output_dir=workdir, per_device_train_batch_size=n, num_train_epochs=1,
        learning_rate=TRAIN_LR, weight_decay=0.01, eval_strategy="epoch", save_strategy="no",
        logging_strategy="no", seed=seed,
    )
    result, inputs = {}, {}
    for device, decoder in decoders.items():
        load_jax_params(decoder, tree)
        trainer = MultimodalTrainer(decoder, args, data, data, mode, device=device)
        # The first micro-batch's gradient, through the trainer's own loss.
        perm = np.arange(n, dtype=np.int32)
        mb = trainer._micro_batch(trainer.train_data, trainer._train_device, perm, np.ones(n, np.float32))
        inputs[device] = {}
        handles = _input_grad_hooks(decoder, inputs[device])
        grads = torch.autograd.grad(trainer._loss(mb), trainer.trainable)
        for handle in handles:
            handle.remove()
        grad_tree = export_jax_params(trainer.trainable_module, dict(zip(trainer.trainable, grads)))
        loss = trainer.train_epoch()
        result[device] = (loss, _leaves(grad_tree), _leaves(export_jax_params(trainer.trainable_module)))
    (loss_g, grads_g, params_g), (loss_c, grads_c, params_c) = result["cuda"], result["cpu"]
    print(f"[train] {label}: {first_departure(inputs['cuda'], inputs['cpu'])}", flush=True)
    if not abs(loss_g - loss_c) <= TWIN_LOSS_RTOL * abs(loss_c):
        raise AssertionError(f"{label}: loss card {loss_g} vs CPU {loss_c}")
    grad_diff = np.concatenate([(grads_g[k] - grads_c[k]).ravel() for k in grads_c])
    grad_ref = np.concatenate([grads_c[k].ravel() for k in grads_c])
    grad_err = float(np.linalg.norm(grad_diff) / np.linalg.norm(grad_ref))
    if not grad_err <= TWIN_GRAD_RTOL:
        raise AssertionError(f"{label}: gradient norm rel err {grad_err:.3g} > {TWIN_GRAD_RTOL}")
    diffs = np.concatenate([np.abs(params_g[k] - params_c[k]).ravel() for k in params_c])
    frac = float(np.mean(diffs > 1e-2 * TRAIN_LR))
    if not (frac <= TWIN_PARAM_FRAC and diffs.max() <= 2.01 * TRAIN_LR):
        raise AssertionError(f"{label}: updated parameters differ ({frac:.3g} of elements by > 0.01 lr, "
                             f"max {diffs.max():.3g})")
    print(
        f"[train] {label} card vs CPU fp32, one step of {n} series: loss {loss_g:.6f} vs {loss_c:.6f} "
        f"(rtol {TWIN_LOSS_RTOL}); gradient ||diff|| / ||CPU|| {grad_err:.3g} (tol {TWIN_GRAD_RTOL}); "
        f"updated parameters: max |diff| {diffs.max():.3g}, {frac:.3g} of {diffs.size:,} elements "
        f"> 0.01 lr (tol {TWIN_PARAM_FRAC})",
        flush=True,
    )


def training_phase(seed: int, tree: dict, decoders: dict, reference) -> dict[str, int]:
    """MultimodalTrainer at full width on the card; returns the kernels' launch counts."""
    from multimodal_timesfm_torch.models.bridge import load_jax_params, random_jax_params
    from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
    from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig
    from multimodal_timesfm_torch.ops.attention import fused_causal_attention, fused_causal_attention_bwd
    from multimodal_timesfm_torch.ops.qkv_attention import (
        fused_qkv_causal_attention,
        fused_qkv_causal_attention_bwd,
    )
    from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
    from multimodal_timesfm_torch.training_args import TrainingArguments

    kind = torch.cuda.get_device_name(0)
    counters = {
        "B1f": fused_qkv_causal_attention, "B1b": fused_qkv_causal_attention_bwd,
        "B2f": fused_causal_attention, "B2b": fused_causal_attention_bwd,
    }
    # (mode, context, dtype, batch, steps per epoch, profiled epoch)
    cells = (
        ("multimodal", 512, torch.float32, 256, 3, True),
        ("multimodal", 512, torch.bfloat16, 256, 3, True),
        ("multimodal", 16384, torch.float32, 16, 3, True),
        ("multimodal", 16384, torch.bfloat16, 16, 3, True),
        ("baseline", 512, torch.float32, 256, 1, False),
    )
    with tempfile.TemporaryDirectory() as workdir:
        for fn in counters.values():
            fn.launches = 0
        for mode, ctx, dtype, batch, steps, profiled in cells:
            label = f"{mode} context {ctx} {str(dtype)[6:]}"
            decoder = decoders[dtype]
            load_jax_params(decoder, tree)
            train = make_samples(ctx, steps * batch, seed, TRAIN_HORIZON)
            val = make_samples(ctx, batch, seed + 1, TRAIN_HORIZON)
            args = TrainingArguments(
                output_dir=workdir, per_device_train_batch_size=batch,
                per_device_eval_batch_size=batch, num_train_epochs=3,
                learning_rate=TRAIN_LR if mode == "multimodal" else BASELINE_LR,
                weight_decay=0.01, eval_strategy="epoch", save_strategy="no",
                logging_strategy="no", seed=seed,
            )
            trainer = MultimodalTrainer(decoder, args, train, val, mode, device="cuda")
            scale = decoder.adapter.stacked_xf.layers[0].attn.per_dim_scale.detach().clone()
            before = {key: fn.launches for key, fn in counters.items()}
            warm = trainer.train_epoch()  # first epoch: cuBLAS handles, allocator
            loss = trainer.train_epoch()
            series_per_s = trainer.last_throughput
            val_loss = trainer.validate_epoch()
            epochs = 2
            if profiled:
                wall, kernels = device_profile(trainer.train_epoch)
                epochs += 1
                busy = sum(ms for _, ms in kernels)
                bwd = sum(ms for name, ms in kernels if "attention_bwd" in name)
                fwd = sum(ms for name, ms in kernels if "attention_fwd_kernel" in name)
                top = ", ".join(f"{name[:60]} {ms:.3f} ms" for name, ms in kernels[:5])
                print(
                    f"[profile] train {label}: one epoch of {steps} steps, wall {wall:.3f} ms, "
                    f"device busy {busy:.3f} ms, idle {1 - busy / wall:.3f}, attention backward "
                    f"kernels {bwd:.3f} ms ({bwd / busy:.3f} of busy), forward kernel {fwd:.3f} ms "
                    f"| {top}",
                    flush=True,
                )
            delta = {key: fn.launches - before[key] for key, fn in counters.items()}
            fwd_key, bwd_key = ("B1f", "B1b") if ctx < 16384 else ("B2f", "B2b")
            want = {key: 0 for key in counters}
            want[fwd_key] = 20 * (epochs * steps + 1)  # + one validation batch
            want[bwd_key] = 20 * epochs * steps
            if delta != want:
                raise AssertionError(f"{label}: launches {delta}, expected {want}")
            if not all(np.isfinite(x) for x in (warm, loss, val_loss)):
                raise AssertionError(f"{label}: non-finite loss {warm}, {loss}, {val_loss}")
            moved = float((decoder.adapter.stacked_xf.layers[0].attn.per_dim_scale.detach() - scale).abs().max())
            if mode == "baseline" and not moved > 0:
                raise AssertionError(f"{label}: per_dim_scale did not move")
            print(
                f"[train] {label}: batch {batch}, {steps} steps per epoch | train loss {warm:.5f} -> "
                f"{loss:.5f}, val loss {val_loss:.5f} | {series_per_s:.1f} train series/s after "
                f"warm-up on {kind} | launches {delta} | layer-0 per_dim_scale moved {moved:.3g}",
                flush=True,
            )
        launches = {key: fn.launches for key, fn in counters.items()}

        twin_check("multimodal context 512", "multimodal", 512,
                   {"cuda": decoders[torch.float32], "cpu": reference}, tree, seed, workdir)
        twin_check("baseline context 512", "baseline", 512,
                   {"cuda": decoders[torch.float32], "cpu": reference}, tree, seed, workdir)
        cfg4 = TimesFMConfig(num_layers=4)
        dec_cfg = MultimodalDecoderConfig(text_embedding_dims=384, num_fusion_layers=1)
        shallow = {
            device: MultimodalDecoder(TimesFM2p5Adapter(cfg4), dec_cfg, device=device)
            for device in ("cuda", "cpu")
        }
        twin_check("multimodal context 16384 (4 layers)", "multimodal", 16384, shallow,
                   random_jax_params(shallow["cpu"], seed), seed, workdir)
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
    print(f"[build] {lib_path.name} from {len(_kernels.SOURCES)} sources in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {' '.join(_kernels.NVCC_FLAGS)})")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {line.strip()}")
    gpu = gpu_line()
    print(f"[gpu] {gpu} | torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)

    def phase(name: str, fn, *a):
        start = time.perf_counter()
        out = fn(*a)
        print(f"[phase] {name}: {time.perf_counter() - start:.1f} s", flush=True)
        return out

    rows = phase("forward kernels", kernel_phase, args.seed)
    rows.update(phase("backward kernels", backward_kernel_phase, args.seed))
    phase("edge shapes", edge_checks, args.seed)
    phase("flash gate", flash_gate_check)
    launches, tree, decoders, reference = phase("serving", slice_phase, args.seed)
    train_launches = phase("training", training_phase, args.seed, tree, decoders, reference)

    # One entry per kernel, timed at its main-path shape in bf16: B1f at
    # context 2048 (64 tokens, batch 64) and B2f at context 16384 (512 tokens,
    # batch 8) of the serving path; B1b at context 512 (16 tokens, batch 256)
    # and B2b at context 16384 (512 tokens, batch 16) of the training path.
    # Launches: B1f and B2f from the serving run, B1b and B2b from the
    # training run.
    entries = []
    for key, name, cu, source, batch, seq, count in (
        ("B1f", "fused_qkv_causal_attention", CU_SOURCE, B1_SOURCE, 64, 64, launches["B1f"]),
        ("B2f", "fused_causal_attention", CU_SOURCE, B2_SOURCE, 8, 512, launches["B2f"]),
        ("B1b", "fused_qkv_causal_attention_bwd", CU_BWD_SOURCE, B1B_SOURCE, 256, 16,
         train_launches["B1b"]),
        ("B2b", "fused_causal_attention_bwd", CU_BWD_SOURCE, B2B_SOURCE, 16, 512,
         train_launches["B2b"]),
    ):
        entries.append({
            "name": name, "route": "cuda", "source": cu, "replaces": source,
            "launches": count, "shape": f"B={batch} S={seq} H=16 D=80 bfloat16",
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
