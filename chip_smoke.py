#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what comes out.

Run from the repository root, on a host with one CUDA card:

    python3 chip_smoke.py [--seed N]

Phases (each prints its lines and its seconds; any failure exits non-zero):

1. build: compile the four sources under ``multimodal_timesfm_torch/csrc/``
   (``attention_fwd.cu``, ``attention_bwd.cu``, sharing ``attention_common.cuh``;
   ``chronos_attention.cu``, ``chronos_attention_bwd.cu``, sharing
   ``chronos_common.cuh``) with nvcc for sm_90a, one nvcc per source started together; print the
   build seconds, the compiler's register and shared-memory report, and the
   card's name and power limit;
2. kernels: each CUDA kernel against its plain PyTorch version on the card,
   in fp32 and bf16, on every query row (rows with no valid key included):
   the causal kernels (B1f/B1b, B2f/B2b, and the same kernels behind the
   flash entry point, B3f/B3b, at S = 2100 and 4096) with left-padded key
   masks (and, for the backward, the cotangent zeroed on padded query rows,
   as the model path leaves it), then, with a random cotangent on every row,
   under masks that exercise the kernels' skip rule (pads of 128 up to
   S - 1, random holes after the first valid key, a row with no valid key)
   at S = 300, 600 and 2100 and at the small-S tiles (S = 8, 16, 24), both
   entry points; the Chronos kernels (B4f/B4b) with one segment, and three
   segments with padded tokens, dbias included, on every route and tile
   shape (S = 5, 16, 17, 48, 64, 67, 70, 80, 81, 96, 97, 113, 128, 129, 193,
   200, 577; head dims 16 to 256); every backward launched twice and held
   bit-equal; all at the
   shapes the serving and training paths give them, and at edge shapes. The
   route and tiles of each kernel at its main-path shapes are printed
   (``[route]``). The kernel, the plain version and
   ``torch.nn.functional.scaled_dot_product_attention`` (forward, or its
   backward under autograd; a yardstick only, the port never calls it) are
   timed (device time from torch.profiler, and CUDA events around
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
   (batch 256) and 16384 (batch 16), fp32 and bf16, with the frozen affine
   fold on (the trainer's default), and in baseline mode at context 512 in
   fp32, horizon 32; the counters must show 20 forward and 20 backward
   launches of the right kernel per micro-batch plus the validation
   forwards; every loss finite; baseline mode must move ``per_dim_scale``;
   train series/s after a warm-up epoch and one profiled epoch per
   multimodal cell; the bf16 context-512 cell also on the fused path (its
   step a CUDA graph; the replays' launches added to the count) against the
   per-epoch loop's idle share; and one optimizer step on the card against
   the same port on the CPU in fp32 (gradients, loss and updated
   parameters; at context 16384 both sides cut depth to 4 layers);
4b. headline: the JAX bench's ``timesfm_mm_c32`` (multimodal, batch 2048,
   131,072 series, 3 epochs; the frozen adapter folded and stored in bf16)
   and ``timesfm_baseline_c32`` (baseline, batch 8192, 65,536 series, 2
   epochs, bf16 Adam moments), context and horizon 32, bf16 compute,
   configured as ``bench.py:219-337``, on the fused path
   (``train_epochs_fused``, one CUDA graph per trainer): train series/s over
   the timed epochs after a warm-up run, a profiled epoch (idle share, GEMM
   share, the top kernels), the fold state; two more baseline steps with
   ``fused_optimizer=True`` and with ``trainable_cast_dtype=bf16``; and a
   two-step card-against-CPU twin of each cell in bf16 at 4 layers (tolerances beside
   ``TWIN_BF16_LOSS_RTOL``);
5. TimesFM past 2,048 tokens: context 67,200 (2,100 tokens) served at batch
   2 and trained for one step (multimodal, fp32) through the flash entry
   point: 20 B3 forward and 20 B3 backward launches, finite forecasts and
   loss;
6. Chronos-2 serving: the 120M geometry (768 wide, 16 layers, 12 x 64
   heads, 64 future patches) with the same fusion MLP, served at horizon 128
   through ``Forecaster.forecast_dataset`` at contexts 512, 2048 and 8192
   (97, 193 and 577 tokens) in fp32 and bf16, as in phase 3: 16 B4f
   launches per batch, a profiled call, and the card against the port on
   the CPU in fp32;
7. Chronos-2 training through ``MultimodalTrainer`` at the JAX bench's
   geometries (``bench.py:388-403``, context 32, horizon 32): multimodal at
   batch 128 (67 tokens) in fp32 and bf16 (the frozen encoder stored in
   bf16), baseline at batch 128 in fp32
   (dbias on the path), and multimodal with 2 future patches packed 16 to a
   row at batch 512 (segment masking on the path); 16 B4f and 16 B4b
   launches per micro-batch; a profiled epoch per cell; and a one-step twin
   on the CPU in both modes, the baseline one holding the ``rel_pos_bias``
   gradient to the stated tolerance;
8. time-mmd data: a synthetic Time-MMD tree written with the ``csv`` module
   from ``--seed`` (the ten domains, nine monthly of 500 rows and the daily
   Environment of 11,000; report CSVs, search CSVs on half the domains; NaN,
   inf and NA-like cells; texts reaching every length bucket and the cut at
   256 tokens) and a MiniLM-L6 snapshot with weights drawn from ``--seed``;
   embedding caches built on the card through the port's
   ``time_mmd.cache`` CLI at context 32 and 512 (patch 32), augmented and
   plain: samples, texts, seconds and texts/s, one domain's build profiled
   (idle share, top kernels), the native tokenizer required where ``g++``
   exists, the cache reloaded equal and every pickle holding numpy only;
   MiniLM-L6 on the card against the CPU on 256 texts, with TF32 allowed
   outside the encoder; ModernBERT at ruri-v3-310m width (25 layers) on 256
   texts in chunks of 32, and a 3-layer twin against the CPU; then
   ``load_fold_datasets`` and ``MultimodalTrainer`` on TimesFM-2.5 200M
   from the caches (context 32 on the headline's fused, folded bf16 path;
   context 512 in bf16 on the per-epoch loop, 20 B1f and 20 B1b launches
   per micro-batch) and ``MultimodalEvaluator`` on the test fold;
9. pretrained to served: synthetic snapshots of TimesFM-2.5 200M (about 816 MB)
   and Chronos-2 120M (about 476 MB) written under ``build/pretrained/`` from
   ``--seed`` with the port's safetensors writer, under the upstream names of
   ``models/convert.py``'s rules, with a ``config.json``; ``from_pretrained``
   of each, every tensor on the card bit-equal to the bridge loading the same
   arrays; a TimesFM fine-tune from the snapshot (multimodal, context 512,
   bf16, frozen adapter in bf16) checkpointed with both backends and resumed
   from each, the next epoch bit-equal to the uninterrupted run; artifacts
   (``serving.export_program``) of the fine-tuned model as its trainer holds
   it, of TimesFM at context 512 (fp32 traced on the CPU, bf16 on the card)
   and 2048 (bf16) and of Chronos-2 at 512 and 2048 (bf16), each loaded with
   ``load_program`` on the card and served three times, in turn with
   ``Forecaster`` on the same data (series/s, one profiled call's idle share,
   20 B1f or 16 B4f launches per batch, forecasts against ``Forecaster``'s on
   the same weights), one re-pointed at the fine-tuned
   weights; TimesFM served at contexts 96, 1,056 and 40,000 (3, 33 and 1,250
   tokens) and trained one step at 1,056, with the plain attention made to
   raise (B2f and B2b must launch); the forecast CLI in-process with
   ``--autoregressive`` at horizon 512 (its decode graphs' captures and
   replays, series/s, forecasts bit-equal to the eager loop); and a check
   that nothing of jax, the JAX package, ``examples``, safetensors or
   transformers was imported. Before any main path, phase 2 also checks the
   whole-sequence kernels (B2f, B2b) at the lengths the repaired gates give
   them (S = 2, 3, 5, 7, 33, 1,025, 1,250), and at the exact (B, S) that
   phase 9's serving and training give them;
10. sweeps, with PyTorch's per-sample vmap fallback disabled (an op without a
   batching rule raises) and the plain attention made to raise: phase 8's
   tree split by the port's split CLI, the fold cached by the cache CLI, then
   ``python -m multimodal_timesfm_torch.tune --offline --vectorized`` in-process
   (TimesFM-2.5 at full width and ``CUT_LAYERS`` (4) of its 20 layers, fp32,
   8 trials in one structural group) and the same 8
   configs through the sequential CLI, ``val/best_loss`` and ``test/mse`` per
   trial within ``SWEEP_RTOL``; the JAX bench's ``timesfm_mm_sweepT16``
   (bench.py:510-650: 16 trials in one group against sequential T=1 runs, and
   split 6/5/5 over 1/2/3 fusion layers; s/trial, trials/hour, the ratio, the
   CUDA-graph captures and replays, one profiled step's and validation pass's
   idle share); a TimesFM multimodal group at context 512 (B1f/B1b) and a
   Chronos-2 multimodal group at ``chronos_mm_h32`` (B4f/B4b), each with the
   same counted launches at T=4 as at T=1; a baseline TimesFM group of T=2
   (per-trial 200M weights) against a T=1 run, and ``vectorized_max_trials``.
   Before the main paths, each custom op's vmap rule is held to per-trial
   launches on the card (B1-B4, fp32 and bf16): forward and gradients
   bit-equal, one launch for all trials (B4 with a per-trial bias: one a
   trial);
11. parallel (the ``(data, model)`` mesh of ``multimodal_timesfm_torch/parallel/``):
   two ranks spawned on the one card with gloo (NCCL refuses two ranks on
   one device; their fused steps run eagerly), weights from ``--seed`` at
   full width and ``CUT_LAYERS`` (4) layers, over a (2, 1) mesh (TimesFM-2.5
   multimodal c512 fp32,
   256 series at batch 64, two epochs of the loop and two of the fused path;
   ``MultimodalEvaluator``; four distinct trials of ``run_vectorized_trials``,
   two a rank; ``Forecaster`` c512 bf16, 192 series in batches of 64) and a
   (1, 2) mesh (TimesFM baseline c512 fp32, 128 series at batch 32, its
   checkpoint loaded without a mesh bit-equal to the gathered weights;
   Chronos-2 baseline at ``chronos_mm_h32``'s 67 tokens and serving at
   c512, fp32 and bf16, B4f/B4b at 6 heads a rank; the same ``Forecaster``
   cell), each reading (``[parallel]``) beside its limit against the same run
   without a mesh, done meanwhile in this process; every rank must launch
   B1f/B1b and B4f/B4b and never the plain attention; then one NCCL rank on a
   (1, 1) mesh (the fused step captured with its all-reduce; bit-equal or
   not, and train series/s in turns against the run without a mesh); then
   ``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
   multimodal_timesfm_torch.tune --vectorized`` on phase 10's tree, held per
   run id to the same CLI on one rank. Before the main paths phase 2 checks
   B4 at its 6-head shapes;
12. aoti package (run after phase 9): TimesFM-2.5 200M in fp32 and bf16 and
   Chronos-2 120M in bf16 at full width and depth, context 512, exported as
   AOTInductor packages (``serving.export_program(format="aoti")``) compiled
   on the card, the three at once, each in a child process of this script
   (``--compile-package``) from the geometry alone, then re-pointed at
   weights drawn from ``--seed``; served from their files beside the same
   decoders' ``torch.export`` programs: compile and load seconds, series/s of
   the package, ``Forecaster`` and the program in turn on 192 series in
   batches of 64, 20 B1f or 16 B4f launches per batch through the package,
   the package bit-equal between calls and loads and within ``AOTI_TOL`` of
   ``Forecaster`` (with the bf16-against-fp32 control printed), one profiled
   call's idle share. Inductor links the package with ``-fopenmp``: the phase
   takes the first of ``$CXX``, ``g++``, ``c++`` that can.

The ``[profile]`` lines read ``utils/profiling.py``'s traces
(``device_profile``: the device's activity only; ``op_profile``: the host's
ops and shapes too, for ``gemm_efficiency``). The headline phase measures the
fixed cost of one fused call (a 1-epoch against the 3-epoch call of
``timesfm_mm_c32``) and the eager step's GEMM efficiency, and prints a
``[roofline]`` line (``multimodal_timesfm_torch.roofline``) beside the measured
share of the bf16 peak; the training phase prints one for ``timesfm_mm_c512``
from its bf16 fused epoch.

The ``kernels`` line lists every kernel with its launches on the main-path
phases (3 to 12; each starts its counters at 0; a kernel captured in a CUDA
graph counts once per replay; phase 11 adds its ranks' counts) and its
numbers at its main-path shape in bf16; a ``[launches]`` line splits B4's
counted launches by the route the library's plan gives each shape.

``python3 chip_smoke.py --parallel-only`` only builds the kernels, checks B4
at phase 11's 6-head shapes and runs phase 11 (making phase 10's tree
itself); ``--aoti-only`` only builds the kernels and runs phase 12. ``python3 chip_smoke.py --kernel-times [--root DIR] [--chronos-only]`` only
checks and times every kernel at its main-path shapes in fp32 and bf16 (the
six causal kernels, unless ``--chronos-only``; B4f and B4b with and without
dbias at 128 x 67, 128 x 67 at 6 heads and 16 x 577), with the port imported from DIR (another
checkout, such as the parent commit's) when given, so that two trees compare
on one card. ``python3 chip_smoke.py --serving-times [--root DIR]`` only
times TimesFM serving at context 512 (fp32 and bf16, seven calls each), with
the port imported from DIR when given. ``python3 chip_smoke.py
--training-times [--root DIR]`` only times the eager ``chronos_mm_h32`` bf16
training epoch (seven epochs after two of warm-up), with the port imported
from DIR when given. ``python3 chip_smoke.py --dispatch-times`` only times
the host's cost of one call of the fused-qkv attention entry point as the
``torch.library`` custom op it is and as an ``autograd.Function`` around the
same launch, in inference, in a forward with grad, and forward and backward.
The line before the last names the
card and its power limit; the last line
is ``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when no CUDA device is present or the port cannot be imported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
# Card against CPU in bf16 compute, one fused epoch of two steps (on the card the
# first eager, the second a CUDA-graph replay), the same bf16 storage on both
# sides: each GEMM sums in fp32 in another order and rounds to bf16, and one bf16
# ulp (2^-8 relative) flipped in a layer's output carries through the 20 layers.
# Losses (both steps') and the validation loss: |diff| <= 2e-2 x |CPU|. The
# gradient of the first micro-batch over all trained leaves: ||card - CPU|| <=
# 0.1 x ||CPU|| (about 60 bf16 roundings on the backward path, sqrt(60) x 2^-8 =
# 3%, three times over). The trained parameters after the two Adam steps: none
# more than 2.01 lr x steps apart (Adam normalises each step to about lr, so a
# few % of gradient noise moves a parameter by a fraction of lr: the share of
# elements more than 0.1 lr apart is printed, 0.121 at the first reading).
TWIN_BF16_LOSS_RTOL, TWIN_BF16_GRAD_RTOL = 2e-2, 0.1
# Phase 11, and the tune CLI runs of phase 10 that phase 11 repeats over two ranks, run
# their backbones at full width and CUT_LAYERS layers (TimesFM-2.5's 20 and Chronos-2's 16
# cut): the mesh's arithmetic and the CLI's bookkeeping are the same in every layer, and
# the script's time limit holds phase 12's three compiles. Phase 11's bf16 forecast limit
# (PAR_FORECAST_TOL) was set at full depth.
CUT_LAYERS = 4
# The JAX bench's headline cells (bench.py:366-374, configured as bench.py:219-337):
# (name, mode, batch, series, timed epochs); context and horizon 32, bf16 compute,
# learning rate 1e-4, one warm-up run of the timed epochs first.
HEADLINE_CELLS = (
    ("timesfm_mm_c32", "multimodal", 2048, 131072, 3),
    ("timesfm_baseline_c32", "baseline", 8192, 65536, 2),
)
# Launches that CUDA-graph replays made on a main path: a wrapper counts a
# captured launch once, at capture, so each phase adds (replays - captures) x
# the launches of one step here.
GRAPH_LAUNCHES: dict[str, int] = {}
HORIZON = 128
SERVE_REPEATS = 3
TRAIN_HORIZON = 32
TRAIN_LR = 1e-4
# Baseline mode updates all 200M random weights: at 1e-4 one Adam step,
# about lr * sign(g) on every weight, raised the loss from 15.6 to 283.
BASELINE_LR = 1e-5
CU_SOURCE = "multimodal_timesfm_torch/csrc/attention_fwd.cu"
CU_BWD_SOURCE = "multimodal_timesfm_torch/csrc/attention_bwd.cu"
CU_CHRONOS_SOURCE = "multimodal_timesfm_torch/csrc/chronos_attention.cu"
# Every kernel of the port: (key, wrapper, CUDA source, the TPU kernel it
# replaces, (B, S, H, D) of the main-path shape it is timed at in bf16).
# B1f at serving context 2048 (64 tokens, batch 64) and B2f at context 16384
# (512 tokens, batch 8); B1b at training context 512 (16 tokens, batch 256)
# and B2b at context 16384 (512 tokens, batch 16); B3 at context 67,200
# (2,100 tokens, batch 2); B4 at Chronos-2's fine-tune (67 tokens, batch 128).
KERNELS = (
    ("B1f", "fused_qkv_causal_attention", CU_SOURCE,
     "multimodal_timesfm_tpu/ops/qkv_attention.py:111", (64, 64, 16, 80)),
    ("B1b", "fused_qkv_causal_attention_bwd", CU_BWD_SOURCE,
     "multimodal_timesfm_tpu/ops/qkv_attention.py:141", (256, 16, 16, 80)),
    ("B2f", "fused_causal_attention", CU_SOURCE,
     "multimodal_timesfm_tpu/ops/attention.py:174", (8, 512, 16, 80)),
    ("B2b", "fused_causal_attention_bwd", CU_BWD_SOURCE,
     "multimodal_timesfm_tpu/ops/attention.py:189", (16, 512, 16, 80)),
    ("B3f", "flash_causal_attention", CU_SOURCE,
     "multimodal_timesfm_tpu/ops/attention.py:322", (2, 2100, 16, 80)),
    ("B3b", "flash_causal_attention_bwd", CU_BWD_SOURCE,
     "multimodal_timesfm_tpu/ops/attention.py:322", (2, 2100, 16, 80)),
    ("B4f", "fused_chronos_attention", CU_CHRONOS_SOURCE,
     "multimodal_timesfm_tpu/ops/chronos_attention.py:120", (128, 67, 12, 64)),
    ("B4b", "fused_chronos_attention_bwd", CU_CHRONOS_SOURCE,
     "multimodal_timesfm_tpu/ops/chronos_attention.py:144", (128, 67, 12, 64)),
)
KERNELS_BY_KEY = tuple((key, shape) for key, _, _, _, shape in KERNELS)
CHRONOS_HORIZON = 32  # the JAX bench's Chronos fine-tune horizon


def row_key(key: str, shape: tuple[int, int, int, int], dtype: torch.dtype) -> str:
    """Where a kernel phase files the measured row of kernel ``key`` at (B, S, H, D) and dtype."""
    return f"{key} {shape} {dtype}"


def kernel_entries(rows: dict[str, dict], launches: dict[str, int]) -> list[dict]:
    """The ``kernels`` line: one entry per kernel of KERNELS, with its launches on the
    main-path phases and its measured row at its own main-path shape in bf16."""
    entries = []
    for key, name, cu, replaces, shape in KERNELS:
        batch, seq, heads, dim = shape
        entries.append({
            "name": name, "route": "cuda", "source": cu, "replaces": replaces,
            "launches": launches[key], "shape": f"B={batch} S={seq} H={heads} D={dim} bfloat16",
            **rows[row_key(key, shape, torch.bfloat16)],
        })
    return entries


def sass_mma_report(lib_path) -> list[str]:
    """Per kernel family of the library, from ``cuobjdump -sass``: how many of its compiled
    instantiations contain tensor-core instructions (HMMA), and the fewest they hold. Lines
    naming no tool when the toolkit has no cuobjdump."""
    import re
    from pathlib import Path

    from multimodal_timesfm_torch.ops import _kernels

    tool = Path(_kernels.nvcc_path()).with_name("cuobjdump")
    if not tool.is_file():
        return [f"no {tool}: SASS not read"]
    out = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True)
    counts: dict[str, list[int]] = {}
    family = None
    for line in out.stdout.splitlines():
        found = re.search(r"Function : \S*?(\d+)((?:chronos|attention)_\w*?kernel)", line)
        if found:
            family = found.group(2)
            counts.setdefault(family, []).append(0)
        elif family is not None and "HMMA" in line:
            counts[family][-1] += 1
    return [f"{name}: {sum(n > 0 for n in found)} of {len(found)} instantiations run HMMA "
            f"(fewest {min(found)})" for name, found in sorted(counts.items())]


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
    """Run ``fn`` once under ``utils.profiling.trace`` with the device's activity only (the
    host keeps its unprofiled pace) and read the trace back with ``summarize_trace``.

    Returns the host wall time in ms and [(kernel name, device ms)], largest
    first; the list is empty when the profiler records no device activity.
    """
    from multimodal_timesfm_torch.utils import profiling

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as log_dir:
        with profiling.trace(log_dir, host=False):
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - start) * 1e3
        summary = profiling.summarize_trace(log_dir, top=None)
    return wall_ms, [(name, ms) for name, ms, _ in summary["top_ops"]]


def op_profile(fn) -> tuple[dict, dict]:
    """Run ``fn`` once eagerly under ``utils.profiling.trace`` (the host's ops with their
    shapes, and the device's activity): (``summarize_trace``, ``gemm_efficiency`` against
    the bf16 peak) of that trace. A CUDA-graph replay hides the ops behind its kernels, so
    this reads an eager call."""
    from multimodal_timesfm_torch.utils import profiling

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as log_dir:
        with profiling.trace(log_dir):
            fn()
        return profiling.summarize_trace(log_dir), profiling.gemm_efficiency(log_dir, PEAK_FLOPS[torch.bfloat16])


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


def compare(what: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    """Kernel output vs plain output on every query row, those with no valid key (uniform
    weights over all S keys) included: finite, within KERNEL_TOL. Returns the max abs
    difference."""
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"{what} {out.dtype}: non-finite output")
    err = (out.float() - ref.float()).abs()
    atol, rtol = KERNEL_TOL[out.dtype]
    if (err - atol - rtol * ref.float().abs()).amax().item() > 0:
        raise AssertionError(
            f"{what} {out.dtype}: max |kernel - plain| {err.amax().item():.3g} "
            f"exceeds atol {atol} + rtol {rtol} * |plain|"
        )
    return err.amax().item()


def time_kernel(name: str, shape: tuple[int, int, int, int], dtype: torch.dtype, err: float,
                tol: tuple[float, float], kernel, plain, library, bound: tuple[float, str], iters: int,
                library_name: str) -> dict:
    """Device and event times of a kernel, its plain version and the library yardstick; the
    row of the ``kernels`` line, with ``err`` (checked against ``tol``) and the bound."""
    batch, seq, heads, dim = shape
    bound_ms, bound_by = bound
    ms, ms_ev = device_ms(kernel, iters)
    plain_ms, plain_ev = device_ms(plain, max(2, iters // 4))
    library_ms, library_ev = device_ms(library, iters)
    print(
        f"[kernels] {name} B={batch} S={seq} H={heads} D={dim} {str(dtype)[6:]}: max_abs_err {err:.3g} "
        f"(atol {tol[0]}, rtol {tol[1]}) | device ms: kernel {ms:.4f}, plain {plain_ms:.4f}, "
        f"{library_name} {library_ms:.4f} | event ms: "
        f"kernel {ms_ev:.4f}, plain {plain_ev:.4f}, {library_name} {library_ev:.4f} | bound "
        f"{bound_ms:.4f} ms ({bound_by})",
        flush=True,
    )
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def check_kernel(name: str, kernel, plain, sdpa, valid: torch.Tensor, dtype: torch.dtype,
                 shape: tuple[int, int, int, int], iters: int) -> dict:
    """Kernel vs plain version on the card; returns the measured row."""
    diff = compare(f"{name} {shape}", kernel(), plain())
    return time_kernel(name, shape, dtype, diff, KERNEL_TOL[dtype], kernel, plain, sdpa,
                       attention_bound(*shape, valid, dtype), iters, "sdpa")


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
            rows[row_key("B1f", (batch, seq, heads, dim), dtype)] = check_kernel(
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
            rows[row_key("B2f", (batch, seq, heads, dim), dtype)] = check_kernel(
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


def same_twice(what: str, kernel) -> None:
    """Two launches of a backward kernel must give bit-equal gradients."""
    first, again = kernel(), kernel()
    torch.cuda.synchronize()
    first = first if isinstance(first, tuple) else (first,)
    again = again if isinstance(again, tuple) else (again,)
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError(f"{what}: two backward launches differ")


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
    """Backward kernel vs its plain version on the card, and two launches bit-equal;
    returns the measured row."""
    diff = compare_bwd(f"{name} {shape}", kernel(), plain())
    same_twice(f"{name} {shape} {dtype}", kernel)
    return time_kernel(name, shape, dtype, diff, BWD_TOL[dtype], kernel, plain, sdpa_bwd,
                       backward_bound(*shape, valid, dtype), iters, "sdpa backward")


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
            rows[row_key("B1b", (batch, seq, heads, dim), dtype)] = check_bwd_kernel(
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
            rows[row_key("B2b", (batch, seq, heads, dim), dtype)] = check_bwd_kernel(
                "fused_causal_attention_bwd",
                lambda: fused_causal_attention_bwd(q, k, v, valid, g),
                lambda: plain_attention_bwd(q, k, v, valid, g),
                sdpa_bwd_fn(q, k, v, valid, g), valid, dtype, (batch, seq, heads, dim), 5,
            )
    return rows


def skip_rule_masks(batch: int, seq: int, gen: torch.Generator) -> dict[str, torch.Tensor]:
    """(B, S) bool key masks that exercise the causal kernels' skip rule. "left-padded": a
    pad in [0, S/2). "deep padding": a pad in [min(128, S - 1), S - 1], so whole query tiles
    have no valid key (row 0 keeps only its last key). "holes": left-padded, then every later
    key invalid with probability 0.3 (the first valid key kept); the last row has no valid
    key at all."""
    ar = torch.arange(seq, device="cuda")[None, :]
    deep = torch.randint(min(128, seq - 1), seq, (batch,), generator=gen, device="cuda")
    deep[0] = seq - 1
    holes = left_padded_valid(batch, seq, gen)
    first = holes.int().argmax(dim=1)
    keep = torch.rand(batch, seq, generator=gen, device="cuda") >= 0.3
    holes = holes & (keep | (ar == first[:, None]))
    holes[-1] = False
    return {"left-padded": left_padded_valid(batch, seq, gen), "deep padding": ar >= deep[:, None],
            "holes": holes}


def check_causal_masks(label: str, shape: tuple[int, int, int, int], dtype: torch.dtype,
                       gen: torch.Generator, flash: bool = False) -> None:
    """Both entry points of one length (fused-qkv and whole-sequence, or the flash entry
    point), forward and backward, against the plain versions on every query row under each
    mask of :func:`skip_rule_masks`, with a random cotangent on every row; two backward
    launches bit-equal."""
    from multimodal_timesfm_torch.ops.attention import (
        flash_causal_attention,
        flash_causal_attention_bwd,
        fused_causal_attention,
        fused_causal_attention_bwd,
        plain_attention_bwd,
        plain_causal_attention,
    )
    from multimodal_timesfm_torch.ops.qkv_attention import (
        fused_qkv_causal_attention,
        fused_qkv_causal_attention_bwd,
        split_heads,
    )

    batch, seq, heads, dim = shape
    worst_f = worst_b = 0.0
    for name, valid in skip_rule_masks(batch, seq, gen).items():
        qkv = torch.randn(batch, seq, 3 * heads * dim, generator=gen, device="cuda")
        qkv[..., : heads * dim] /= math.sqrt(dim)
        qkv = qkv.to(dtype)
        q, k, v = split_heads(qkv, heads, dim)
        g = torch.randn(batch, seq, heads * dim, generator=gen, device="cuda").to(dtype)
        g4 = g.unflatten(-1, (heads, dim))
        what = f"{label} {shape} {name}"
        ref, ref_b = plain_causal_attention(q, k, v, valid), plain_attention_bwd(q, k, v, valid, g4)
        if flash:
            runs = [(flash_causal_attention(q, k, v, valid), ref,
                     lambda: flash_causal_attention_bwd(q, k, v, valid, g4), ref_b)]
        else:
            runs = [(fused_causal_attention(q, k, v, valid), ref,
                     lambda: fused_causal_attention_bwd(q, k, v, valid, g4), ref_b),
                    (fused_qkv_causal_attention(qkv, valid, heads, dim), ref.flatten(-2),
                     lambda: fused_qkv_causal_attention_bwd(qkv, valid, g, heads, dim),
                     torch.cat([d.flatten(-2) for d in ref_b], dim=-1))]
        for out, want, backward, want_b in runs:
            worst_f = max(worst_f, compare(what, out, want))
            worst_b = max(worst_b, compare_bwd(f"{what} backward", backward(), want_b))
            same_twice(f"{what} {dtype}", backward)
    entries = "flash entry point" if flash else "both entry points"
    print(f"[kernels] {label} (B,S,H,D) {shape} {str(dtype)[6:]}, {entries}, masks "
          f"left-padded / deep padding / holes: max |kernel - plain| on every row forward "
          f"{worst_f:.3g}, backward {worst_b:.3g}; two backward launches bit-equal", flush=True)


def edge_checks(seed: int) -> None:
    """The causal kernels against their plain versions off the main path, every row, both
    entry points, fp32 and bf16, under the skip-rule masks: a ragged last key tile, head
    dims 20, 40 and 256, S = 300 and 600 with whole 64-row tiles of padding, and the
    small-S tiles at S = 8, 16 and 24 with H = 5 (a head count their blocks do not divide)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    shapes = ((3, 264, 3, 20), (2, 40, 2, 40), (2, 300, 2, 256), (3, 300, 2, 80), (3, 600, 2, 80),
              (3, 8, 5, 80), (3, 16, 5, 80), (3, 24, 5, 80))
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            check_causal_masks("edge case", shape, dtype, gen)


# The lengths the repaired gates send to the whole-sequence entry point (B2) where the TPU's
# gates sent them to the plain path: 2-7 tokens, S not a multiple of 8 (33: context 1,056)
# and 1,025-2,048 (1,250: context 40,000). Checked before any main path runs.
GATE_LENGTHS = (2, 3, 5, 7, 33, 1025, 1250)
# Phase 9 serves the contexts whose token counts the TPU's gates sent to the plain path
# (context -> series, batch), and trains one step at GATE_TRAIN (context, batch).
GATE_CONTEXTS = {96: (64, 64), 1056: (64, 64), 40000: (4, 4)}
GATE_TRAIN = (1056, 16)
# The (B, S) the gate checks run at: every GATE_LENGTHS entry, and the exact (B, S) that
# phase 9's serving and training give B2.
GATE_SHAPES = tuple(sorted(
    {(4 if s > 1000 else 16, s) for s in GATE_LENGTHS}
    | {(batch, ctx // 32) for ctx, (_, batch) in GATE_CONTEXTS.items()}
    | {(GATE_TRAIN[1], GATE_TRAIN[0] // 32)}, key=lambda bs: (bs[1], bs[0])))


def gate_length_checks(seed: int) -> None:
    """B2f and B2b against their plain versions at :data:`GATE_SHAPES`, fp32 and bf16, on
    every query row under the skip-rule masks, with a random cotangent on every row; two
    backward launches bit-equal."""
    from multimodal_timesfm_torch.ops.attention import (
        fused_causal_attention,
        fused_causal_attention_bwd,
        plain_attention_bwd,
        plain_causal_attention,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    heads, dim = 16, 80
    for dtype in (torch.float32, torch.bfloat16):
        for batch, seq in GATE_SHAPES:
            worst_f = worst_b = 0.0
            for name, valid in skip_rule_masks(batch, seq, gen).items():
                q, k, v = (torch.randn(batch, seq, heads, dim, generator=gen, device="cuda") for _ in range(3))
                q, k, v = (q / math.sqrt(dim)).to(dtype), k.to(dtype), v.to(dtype)
                g = torch.randn(batch, seq, heads, dim, generator=gen, device="cuda").to(dtype)
                what = f"B2 gate length (B,S,H,D) {(batch, seq, heads, dim)} {name}"
                worst_f = max(worst_f, compare(what, fused_causal_attention(q, k, v, valid),
                                               plain_causal_attention(q, k, v, valid)))
                backward = lambda: fused_causal_attention_bwd(q, k, v, valid, g)  # noqa: E731
                worst_b = max(worst_b, compare_bwd(f"{what} backward", backward(),
                                                   plain_attention_bwd(q, k, v, valid, g)))
                same_twice(f"{what} {dtype}", backward)
            print(f"[kernels] B2 at gate length S={seq} (B={batch} H={heads} D={dim}) {str(dtype)[6:]}, "
                  f"masks left-padded / deep padding / holes: max |kernel - plain| forward {worst_f:.3g}, "
                  f"backward {worst_b:.3g}; two backward launches bit-equal", flush=True)


# Chronos-2's main-path (B, S) in the kernels: serving at contexts 512, 2048 and 8192, and
# the fine-tunes (67 tokens at batch 128, and at 4 trials x 128 rows in a sweep group; 16
# rows of 5 packed at batch 512).
CHRONOS_PATH_SHAPES = ((64, 97), (64, 193), (16, 577), (128, 67), (512, 67), (512, 80))


def print_routes() -> None:
    """The route and tiles of every kernel at its main-path shapes, fp32 and bf16, as the
    library's dispatch reports them."""
    from multimodal_timesfm_torch.ops import _kernels

    for key, name, _, _, (_, seq, heads, dim) in KERNELS:
        for dtype in (torch.float32, torch.bfloat16):
            if not key.startswith("B4"):
                route = _kernels.attention_route(key.endswith("b"), dtype, seq, dim)
                print(f"[route] {key} {name} S={seq} D={dim} {str(dtype)[6:]}: {route}")
                continue
            if not hasattr(_kernels, "chronos_route"):
                continue
            for batch, path_seq in CHRONOS_PATH_SHAPES:
                route = _kernels.chronos_route(key.endswith("b"), dtype, batch, path_seq, heads, dim)
                print(f"[route] {key} {name} B={batch} S={path_seq} H={heads} D={dim} "
                      f"{str(dtype)[6:]}: {route}")


def chronos_bound(batch: int, seq: int, heads: int, dim: int, seg: torch.Tensor,
                  dtype: torch.dtype, backward: bool, dbias: bool = False) -> tuple[float, str]:
    """Least time for the Chronos attention: max(bytes / HBM rate, flops / peak).

    Bytes, forward: q, k, v read and the output written once (4 B S H D
    elements), the (H, S, S) fp32 bias and the (B, S) int32 segment ids read
    once; backward: q, k, v and g read and dq, dk, dv written once (7 B S H D
    elements), the bias and the segment ids, and the (H, S, S) fp32 dbias
    written once when it is computed. Flops: 4 D H (forward: QK^T, PV) or
    10 D H (backward: QK^T, G V^T, dV, dQ, dK) per (row, key) pair of one
    segment; the attention is bidirectional, so every pair of a segment counts.
    """
    elt = torch.finfo(dtype).bits // 8
    pairs = int((seg[:, :, None] == seg[:, None, :]).sum())
    nbytes = (7 if backward else 4) * batch * seq * heads * dim * elt + heads * seq * seq * 4 + batch * seq * 4
    if dbias:
        nbytes += heads * seq * seq * 4
    flops = (10 if backward else 4) * dim * heads * pairs
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def chronos_segments(batch: int, seq: int, segments: int, padded: bool, gen: torch.Generator) -> torch.Tensor:
    """(B, S) int32 ids as the encoder builds them: ``segments`` contiguous segments per
    row; with ``padded``, a random fifth of the tokens padded, each with an id of its own."""
    seg = (torch.arange(seq, device="cuda") * segments // seq).int()[None].repeat(batch, 1)
    if padded:
        pad = torch.rand(batch, seq, generator=gen, device="cuda") < 0.2
        pad[:, -1] = False
        own = -1 - torch.arange(seq, dtype=torch.int32, device="cuda")
        seg = torch.where(pad, own[None], seg)
    return seg.contiguous()


def chronos_sdpa_mask(seg: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The float SDPA mask of the same function: bias + finfo.min across segments, (B, H, S, S)."""
    from multimodal_timesfm_torch.ops.attention import NEG_INF

    same = seg[:, :, None] == seg[:, None, :]
    return (bias[None] + torch.where(same, 0.0, NEG_INF)[:, None]).to(dtype)


def chronos_inputs(shape: tuple[int, int, int, int], segments: int, padded: bool, dtype: torch.dtype,
                   gen: torch.Generator) -> tuple[torch.Tensor, ...]:
    """qkv (q unscaled, entries of about dim^-1/4 so logits are O(1)), seg, a N(0, 1) bias and
    a cotangent, drawn on the card."""
    batch, seq, heads, dim = shape
    qkv = (torch.randn(batch, seq, 3 * heads * dim, generator=gen, device="cuda") / dim ** 0.25).to(dtype)
    bias = torch.randn(heads, seq, seq, generator=gen, device="cuda")
    seg = chronos_segments(batch, seq, segments, padded, gen)
    g = torch.randn(batch, seq, heads * dim, generator=gen, device="cuda").to(dtype)
    return qkv, seg, bias, g


def chronos_timed_rows(qkv: torch.Tensor, seg: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
                       shape: tuple[int, int, int, int], errs: tuple[float, float, float],
                       iters: int) -> tuple[dict, dict]:
    """B4f, B4b without dbias (the multimodal path) and B4b with dbias (baseline mode) timed
    beside their plain versions, SDPA (forward, or its backward under autograd) and their
    bounds; ``errs`` = the checked forward, dqkv and dbias errors. Returns the B4f and the
    no-dbias B4b rows."""
    from multimodal_timesfm_torch.ops.chronos_attention import (
        fused_chronos_attention,
        fused_chronos_attention_bwd,
        plain_chronos_attention,
        plain_chronos_attention_bwd,
    )

    batch, seq, heads, dim = shape
    dtype = qkv.dtype
    err_f, err_b, err_db = errs
    mask = chronos_sdpa_mask(seg, bias, dtype)
    qh, kh, vh = (t.unflatten(-1, (heads, dim)).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, attn_mask=mask, scale=1.0)
    fwd = time_kernel(
        "fused_chronos_attention", shape, dtype, err_f, KERNEL_TOL[dtype],
        lambda: fused_chronos_attention(qkv, seg, bias),
        lambda: plain_chronos_attention(qkv, seg, bias), sdpa,
        chronos_bound(*shape, seg, dtype, backward=False), 2 * iters, "sdpa",
    )
    qd, kd, vd = (t.detach().requires_grad_() for t in (qh, kh, vh))
    out = torch.nn.functional.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask, scale=1.0)
    gh = g.unflatten(-1, (heads, dim)).transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(out, (qd, kd, vd), gh, retain_graph=True)  # noqa: E731
    # The main path's backward: multimodal mode, the bias frozen (no dbias).
    bwd = time_kernel(
        "fused_chronos_attention_bwd (no dbias)", shape, dtype, err_b, BWD_TOL[dtype],
        lambda: fused_chronos_attention_bwd(qkv, seg, bias, g, False),
        lambda: plain_chronos_attention_bwd(qkv, seg, bias, g, False), sdpa_bwd,
        chronos_bound(*shape, seg, dtype, backward=True), iters, "sdpa backward",
    )
    time_kernel(
        "fused_chronos_attention_bwd (with dbias)", shape, dtype, max(err_b, err_db), BWD_TOL[dtype],
        lambda: fused_chronos_attention_bwd(qkv, seg, bias, g, True),
        lambda: plain_chronos_attention_bwd(qkv, seg, bias, g, True), sdpa_bwd,
        chronos_bound(*shape, seg, dtype, backward=True, dbias=True), iters, "sdpa backward",
    )
    return fwd, bwd


def check_chronos(what: str, qkv: torch.Tensor, seg: torch.Tensor, bias: torch.Tensor,
                  g: torch.Tensor) -> tuple[float, float, float]:
    """B4f and B4b (with and without dbias) against their plain versions on every element;
    two backward launches bit-equal; the backward without dbias gives the same dqkv. Returns
    the forward, dqkv and dbias errors."""
    from multimodal_timesfm_torch.ops.chronos_attention import (
        fused_chronos_attention,
        fused_chronos_attention_bwd,
        plain_chronos_attention,
        plain_chronos_attention_bwd,
    )

    dtype = qkv.dtype
    err_f = compare(f"{what} forward", fused_chronos_attention(qkv, seg, bias),
                    plain_chronos_attention(qkv, seg, bias))
    dqkv, dbias = fused_chronos_attention_bwd(qkv, seg, bias, g, True)
    ref_dqkv, ref_dbias = plain_chronos_attention_bwd(qkv, seg, bias, g, True)
    err_b = compare_bwd(f"{what} backward", dqkv, ref_dqkv)
    err_db = compare_bwd(f"{what} dbias", dbias, ref_dbias)
    again_dqkv, again_dbias = fused_chronos_attention_bwd(qkv, seg, bias, g, True)
    frozen_dqkv, none = fused_chronos_attention_bwd(qkv, seg, bias, g, False)
    torch.cuda.synchronize()
    if not (torch.equal(again_dbias, dbias) and torch.equal(again_dqkv, dqkv)):
        raise AssertionError(f"{what} {dtype}: two backward launches differ")
    if none is not None or not torch.equal(frozen_dqkv, dqkv):
        raise AssertionError(f"{what} {dtype}: the backward without dbias differs")
    print(f"[kernels] {what} {str(dtype)[6:]}: max |kernel - plain| forward {err_f:.3g}, dqkv "
          f"{err_b:.3g}, dbias {err_db:.3g} (|dbias| <= {ref_dbias.abs().max().item():.3g}); "
          "two launches bit-equal; without dbias: dqkv bit-equal", flush=True)
    return err_f, err_b, err_db


# Phase 11's B4 shapes: 12 heads over a model axis of 2 (the fine-tune's 67 tokens and
# serving's 97, batch 64 on each rank; the timed row's batch 128), one and three segments.
SHARDED_CHRONOS_CASES = [(batch, seq, 6, 64, *variant) for batch, seq in ((64, 67), (64, 97), (128, 67))
                         for variant in ((1, False), (3, True))]


def sharded_chronos_checks(seed: int) -> None:
    """B4f and B4b at phase 11's head-sharded shapes against their plain versions."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    for dtype in (torch.float32, torch.bfloat16):
        for batch, seq, heads, dim, segments, padded in SHARDED_CHRONOS_CASES:
            shape = (batch, seq, heads, dim)
            qkv, seg, bias, g = chronos_inputs(shape, segments, padded, dtype, gen)
            check_chronos(f"B4 {shape} {segments} segment(s){' padded' if padded else ''}", qkv, seg, bias, g)


def chronos_kernel_phase(seed: int) -> dict[str, dict]:
    """B4f and B4b against their plain versions on every element, fp32 and bf16, at every
    route and tile shape; timed at the main-path shape."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    rows: dict[str, dict] = {}
    main_shape = dict(KERNELS_BY_KEY)["B4f"]
    # (B, S, H, D, segments, padded): the Chronos-2 shapes (67 tokens at context 32, alone
    # and as a sweep group's 4 x 128 folded rows, 97 at 512, 193 at 2048, 577 at 8192),
    # each with one segment and with three segments and padded tokens; 80 = 16 packed
    # rows of 5 (at batch 256: 6 batch rows per block, a short
    # last group); then the edges of the one-pass limit and of the 16-row steps (S = 16, 17,
    # 48, 129; 5), every one-pass tile count (S = 64, 81, 96, 113, 128: the forward's 4, 6,
    # 6, 8, 8 warps, the backward's 4, 6, 6 and the tiled route past 96), head dims 16 (one
    # k-step), 20 (rows not 16-byte aligned, one-pass and tiled), 32, 128, 256, and odd
    # batches (9, 17).
    cases = [(batch, seq, 12, 64, *variant)
             for batch, seq in ((128, 67), (512, 67), (64, 97), (64, 193), (16, 577))
             for variant in ((1, False), (3, True))]
    cases += SHARDED_CHRONOS_CASES
    cases += [(32, 80, 12, 64, 16, False), (256, 80, 12, 64, 16, False),
              (4, 16, 12, 64, 1, False), (4, 17, 12, 64, 3, True), (4, 48, 12, 64, 3, True),
              (4, 64, 12, 64, 3, True), (4, 81, 12, 64, 1, False), (4, 96, 12, 64, 3, True),
              (4, 113, 12, 64, 1, False), (4, 128, 12, 64, 3, True),
              (4, 129, 12, 64, 3, True), (3, 67, 2, 16, 3, True), (3, 67, 2, 20, 3, True),
              (3, 200, 2, 20, 3, True), (3, 70, 2, 32, 1, True), (3, 70, 2, 128, 3, True),
              (2, 70, 2, 256, 3, True), (9, 200, 2, 64, 3, True), (17, 97, 2, 64, 3, True),
              (4, 5, 2, 64, 1, False)]
    for dtype in (torch.float32, torch.bfloat16):
        for batch, seq, heads, dim, segments, padded in cases:
            shape = (batch, seq, heads, dim)
            qkv, seg, bias, g = chronos_inputs(shape, segments, padded, dtype, gen)
            what = f"B4 {shape} {segments} segment(s){' padded' if padded else ''}"
            errs = check_chronos(what, qkv, seg, bias, g)
            if shape != main_shape or segments != 1:
                continue
            fwd, bwd = chronos_timed_rows(qkv, seg, bias, g, shape, errs, 10)
            rows[row_key("B4f", shape, dtype)] = fwd
            rows[row_key("B4b", shape, dtype)] = bwd
    return rows


def flash_kernel_phase(seed: int) -> dict[str, dict]:
    """B3 (the causal kernels behind the flash entry point) at S = 2100 and 4096, B=2,
    H=16, D=80, left-padded, against plain causal attention on every row (timed at 2100,
    fp32 and bf16), and at 2100 under every skip-rule mask."""
    from multimodal_timesfm_torch.ops.attention import (
        flash_causal_attention,
        flash_causal_attention_bwd,
        plain_attention_bwd,
        plain_causal_attention,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    heads, dim = 16, 80
    rows: dict[str, dict] = {}
    for dtype in (torch.float32, torch.bfloat16):
        for batch, seq in ((2, 2100), (2, 4096)):
            shape = (batch, seq, heads, dim)
            q, k, v = (torch.randn(batch, seq, heads, dim, generator=gen, device="cuda") for _ in range(3))
            q = (q / math.sqrt(dim)).to(dtype)
            k, v = k.to(dtype), v.to(dtype)
            valid = left_padded_valid(batch, seq, gen)
            g = padded_cotangent(shape, valid, dtype, gen)
            timed = shape == dict(KERNELS_BY_KEY)["B3f"]
            if timed:
                rows[row_key("B3f", shape, dtype)] = check_kernel(
                    "flash_causal_attention", lambda: flash_causal_attention(q, k, v, valid),
                    lambda: plain_causal_attention(q, k, v, valid), sdpa_fn(q, k, v, valid),
                    valid, dtype, shape, 5,
                )
                rows[row_key("B3b", shape, dtype)] = check_bwd_kernel(
                    "flash_causal_attention_bwd", lambda: flash_causal_attention_bwd(q, k, v, valid, g),
                    lambda: plain_attention_bwd(q, k, v, valid, g), sdpa_bwd_fn(q, k, v, valid, g),
                    valid, dtype, shape, 3,
                )
                continue
            err_f = compare(f"B3 {shape}", flash_causal_attention(q, k, v, valid),
                            plain_causal_attention(q, k, v, valid))
            err_b = compare_bwd(f"B3 backward {shape}", flash_causal_attention_bwd(q, k, v, valid, g),
                                plain_attention_bwd(q, k, v, valid, g))
            same_twice(f"B3 backward {shape} {dtype}", lambda: flash_causal_attention_bwd(q, k, v, valid, g))
            print(f"[kernels] flash_causal_attention B={batch} S={seq} H={heads} D={dim} "
                  f"{str(dtype)[6:]}: max |kernel - plain| forward {err_f:.3g} (every row), "
                  f"backward {err_b:.3g}; two backward launches bit-equal", flush=True)
        check_causal_masks("flash", (2, 2100, heads, dim), dtype, gen, flash=True)
    return rows


def kernel_times(seed: int, chronos_only: bool = False) -> None:
    """Every kernel at its main-path shapes, fp32 and bf16, checked against its plain version
    and timed beside the plain version, SDPA and the bound (``[kernels]`` lines): the six
    causal kernels (B1f/B1b, B2f/B2b, B3f/B3b) left-padded (skipped with ``chronos_only``),
    then B4f, B4b without dbias and B4b with dbias at Chronos-2's fine-tune (128 x 67 tokens)
    and its serving at context 8192 (16 x 577), and at the fine-tune's shape with its 12 heads
    over a model axis of 2 (128 x 67 x 6), one segment. With ``--root`` the port comes
    from another checkout (the parent commit, say), so that two trees compare on one card."""
    from multimodal_timesfm_torch.ops.attention import (
        flash_causal_attention,
        flash_causal_attention_bwd,
        fused_causal_attention,
        fused_causal_attention_bwd,
        plain_attention_bwd,
        plain_causal_attention,
    )
    from multimodal_timesfm_torch.ops.qkv_attention import (
        fused_qkv_causal_attention,
        fused_qkv_causal_attention_bwd,
        plain_qkv_attention_bwd,
        plain_qkv_causal_attention,
        split_heads,
    )

    forward = {"B2f": fused_causal_attention, "B3f": flash_causal_attention}
    backward = {"B2b": fused_causal_attention_bwd, "B3b": flash_causal_attention_bwd}
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    for key, name, _, _, shape in KERNELS:
        if key.startswith("B4") or chronos_only:
            continue
        batch, seq, heads, dim = shape
        iters = 5 if seq > 1000 else 20
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(batch, seq, 3 * heads * dim, generator=gen, device="cuda")
            qkv[..., : heads * dim] /= math.sqrt(dim)
            qkv = qkv.to(dtype)
            valid = left_padded_valid(batch, seq, gen)
            q, k, v = split_heads(qkv, heads, dim)
            g = padded_cotangent((batch, seq, heads * dim), valid, dtype, gen)
            g4 = g.unflatten(-1, (heads, dim))
            if key == "B1f":
                check_kernel(name, lambda: fused_qkv_causal_attention(qkv, valid, heads, dim),
                             lambda: plain_qkv_causal_attention(qkv, valid, heads, dim),
                             sdpa_fn(q, k, v, valid), valid, dtype, shape, iters)
            elif key == "B1b":
                check_bwd_kernel(name, lambda: fused_qkv_causal_attention_bwd(qkv, valid, g, heads, dim),
                                 lambda: plain_qkv_attention_bwd(qkv, valid, g, heads, dim),
                                 sdpa_bwd_fn(q, k, v, valid, g4), valid, dtype, shape, iters)
            elif key in forward:
                check_kernel(name, lambda: forward[key](q, k, v, valid),
                             lambda: plain_causal_attention(q, k, v, valid), sdpa_fn(q, k, v, valid),
                             valid, dtype, shape, iters)
            else:
                check_bwd_kernel(name, lambda: backward[key](q, k, v, valid, g4),
                                 lambda: plain_attention_bwd(q, k, v, valid, g4),
                                 sdpa_bwd_fn(q, k, v, valid, g4), valid, dtype, shape, iters)
    for shape in (dict(KERNELS_BY_KEY)["B4f"], (128, 67, 6, 64), (16, 577, 12, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            qkv, seg, bias, g = chronos_inputs(shape, 1, False, dtype, gen)
            errs = check_chronos(f"B4 {shape} 1 segment(s)", qkv, seg, bias, g)
            chronos_timed_rows(qkv, seg, bias, g, shape, errs, 10 if shape[1] < 100 else 5)


def make_samples(context: int, count: int, seed: int, horizon: int = HORIZON, patch: int = 32) -> list[dict]:
    """Synthetic Time-MMD-like samples: seasonal series with per-patch text embeddings
    (``patch`` steps each); the horizon is the series' continuation."""
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
            "text_embeddings": rng.normal(size=(context // patch, 384)).astype(np.float32),
            "metadata": {"mean": float(rng.uniform(-50, 50)), "std": float(rng.uniform(0.5, 5.0))},
        })
    return samples


def slice_phase(seed: int) -> tuple[dict, dict, object]:
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

    for (dtype, ctx), fc in forecasters.items():
        wall, kernels = device_profile(
            lambda: fc.forecast_dataset(HORIZON, data[ctx], denormalize=True)
        )
        busy = sum(ms for _, ms in kernels)
        attn = sum(ms for name, ms in kernels if "attention_fwd_" in name)
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
    return tree, decoders, reference


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
    adapter = decoder.adapter
    stack = adapter.stacked_xf if hasattr(adapter, "stacked_xf") else adapter.encoder
    for i, layer in enumerate(stack.layers):
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
               workdir: str, patch: int = 32, report: tuple[str, ...] = ()) -> None:
    """One optimizer step of the same port on the card and on the CPU, fp32: the gradient of
    the first micro-batch, the step's loss and the updated trained parameters. Each leaf
    named in ``report`` must also hold its own gradient to TWIN_GRAD_RTOL."""
    from multimodal_timesfm_torch.models.bridge import export_jax_params, load_jax_params
    from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
    from multimodal_timesfm_torch.training_args import TrainingArguments

    n = 4
    data = make_samples(context, n, seed + 3, TRAIN_HORIZON, patch)
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
        mb = trainer._micro_batch(trainer.train_data, trainer._train_device, perm, np.ones(n, np.float32), n)
        inputs[device] = {}
        handles = _input_grad_hooks(trainer.model, inputs[device])
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
    for leaf in report:
        leaf_err = float(np.linalg.norm(grads_g[leaf] - grads_c[leaf]) / np.linalg.norm(grads_c[leaf]))
        print(f"[train] {label}: gradient of {leaf} ||diff|| / ||CPU|| {leaf_err:.3g} "
              f"(tol {TWIN_GRAD_RTOL}), ||CPU|| {np.linalg.norm(grads_c[leaf]):.4g}", flush=True)
        if not leaf_err <= TWIN_GRAD_RTOL:
            raise AssertionError(f"{label}: gradient of {leaf} differs by {leaf_err:.3g}")
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


def training_phase(seed: int, tree: dict, decoders: dict, reference) -> None:
    """MultimodalTrainer at full width on the card."""
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
                fwd = sum(ms for name, ms in kernels if "attention_fwd_" in name)
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
                f"warm-up on {kind} | launches {delta} | layer-0 per_dim_scale moved {moved:.3g} | "
                f"frozen folds: seq1 {trainer.folded_seq1}, affine {trainer._folded_affine}",
                flush=True,
            )
            if (mode, ctx, dtype) == ("multimodal", 512, torch.bfloat16):
                rate = fused_against_loop(label, trainer, counters, fwd_key, bwd_key, steps, wall, busy)
                eff = eager_step_gemms(f"train {label}", trainer)
                roofline_line("timesfm_mm_c512", rate, eff)

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


def fused_against_loop(label: str, trainer, counters: dict, fwd_key: str, bwd_key: str, steps: int,
                       loop_wall: float, loop_busy: float) -> float:
    """The same trainer on the fused path (the step a CUDA graph): a warm-up epoch (one eager
    step, the capture, replays), a timed epoch and a profiled one, against the per-epoch
    loop's profiled epoch; the captured kernels' replays go into the launch count. Returns
    the timed epoch's train series/s."""
    before = {key: fn.launches for key, fn in counters.items()}
    replays0, captures0 = trainer.graph_replays, trainer.graph_captures
    trainer.train_epochs_fused(1)
    trainer.train_epochs_fused(1)
    rate = trainer.last_throughput
    wall, kernels = device_profile(lambda: trainer.train_epochs_fused(1))
    busy = sum(ms for _, ms in kernels)
    delta = {key: fn.launches - before[key] for key, fn in counters.items()}
    captures = trainer.graph_captures - captures0
    replays = trainer.graph_replays - replays0
    want = {key: 0 for key in counters}
    want[fwd_key] = 20 * (2 * captures + 3)  # the eager step and the capture, + 3 validation batches
    want[bwd_key] = 20 * 2 * captures
    if captures != 1 or replays != 3 * steps - 1 or delta != want:
        raise AssertionError(f"{label} fused: captures {captures}, replays {replays}, launches {delta}, "
                             f"expected 1, {3 * steps - 1}, {want}")
    for key in (fwd_key, bwd_key):
        GRAPH_LAUNCHES[key] = GRAPH_LAUNCHES.get(key, 0) + 20 * (replays - captures)
    print(
        f"[profile] train {label} fused epochs (CUDA graph, {replays} replays): one epoch of {steps} "
        f"steps, wall {wall:.3f} ms, device busy {busy:.3f} ms, idle {1 - busy / wall:.3f}, "
        f"{rate:.1f} train series/s | per-epoch loop: wall {loop_wall:.3f} ms, busy {loop_busy:.3f} ms, "
        f"idle {1 - loop_busy / loop_wall:.3f}",
        flush=True,
    )
    return rate


def bench_data(mode: str, batch: int, samples: int, seed: int):
    """The JAX bench's data (bench.py:286-306): noise series of 32 steps with a 32-step
    horizon, one 384-dim text embedding each in multimodal mode, drawn from ``seed``; the
    validation split is the first max(batch, 8) series."""
    from multimodal_timesfm_torch.data.collate import StackedDataset

    rng = np.random.default_rng(seed)
    text = rng.normal(size=(samples, 1, 384)).astype(np.float32) if mode == "multimodal" else None
    context = rng.normal(size=(samples, 32)).astype(np.float32)
    horizon = rng.normal(size=(samples, 32)).astype(np.float32)
    n_val = max(batch, 8)
    train = StackedDataset(context, horizon, text, [{} for _ in range(samples)])
    val = StackedDataset(context[:n_val], horizon[:n_val], None if text is None else text[:n_val],
                         [{} for _ in range(n_val)])
    return train, val


def headline_trainer(decoder, mode: str, batch: int, train, val, epochs: int, workdir: str, seed: int,
                     device: str = "cuda", **knobs):
    """MultimodalTrainer as bench.py:308-337 builds it: ``epochs + 1`` epochs in the
    schedule, lr 1e-4, no checkpoints (so the fused path), bf16 moments in baseline mode,
    the frozen adapter stored in bf16 in multimodal mode, the folds at their defaults."""
    from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
    from multimodal_timesfm_torch.training_args import TrainingArguments

    args = TrainingArguments(
        output_dir=workdir, per_device_train_batch_size=batch, per_device_eval_batch_size=batch,
        num_train_epochs=epochs + 1, learning_rate=1e-4, eval_strategy="epoch", save_strategy="no",
        logging_strategy="no", seed=seed,
        adam_moment_dtype="bfloat16" if mode == "baseline" else "float32",
    )
    frozen = torch.bfloat16 if mode == "multimodal" else None
    return MultimodalTrainer(decoder, args, train, val, mode, device=device, frozen_cast_dtype=frozen, **knobs)


def is_gemm(kernel: str) -> bool:
    """Whether a device kernel's name is a cuBLAS/CUTLASS matrix product."""
    return any(tag in kernel.lower() for tag in ("gemm", "nvjet", "xmma", "cutlass"))


def is_simt_gemm(kernel: str) -> bool:
    """Whether a GEMM kernel's name is an fp32 product on the CUDA cores (SIMT/FFMA)."""
    return any(tag in kernel.lower() for tag in ("f32f32_f32f32", "sgemm", "simt", "ffma"))


def fused_twin(label: str, mode: str, decoders: dict, tree: dict, seed: int, workdir: str) -> None:
    """One fused epoch of two steps at batch 8, configured as the headline cell, on the card
    (the second step a CUDA-graph replay) and on the CPU, both in bf16 compute: the first
    micro-batch's gradient, the losses, the validation loss and the trained parameters
    (TWIN_BF16_*)."""
    from multimodal_timesfm_torch.models.bridge import export_jax_params, load_jax_params

    start = time.perf_counter()
    train, val = bench_data(mode, 8, 16, seed + 7)
    out = {}
    for device, decoder in decoders.items():
        load_jax_params(decoder, tree)
        trainer = headline_trainer(decoder, mode, 8, train, val, 1, workdir, seed, device=device)
        mb = trainer._micro_batch(trainer.train_data, trainer._train_device, np.arange(8), np.ones(8, np.float32), 8)
        grads = torch.autograd.grad(trainer._loss(mb), trainer._work, allow_unused=True, materialize_grads=True)
        grad_leaves = _leaves(export_jax_params(trainer.trainable_module, dict(zip(trainer.trainable, grads))))
        losses, val_losses = trainer.train_epochs_fused(1)
        params = _leaves(export_jax_params(trainer.trainable_module))
        out[device] = (np.append(losses.ravel(), val_losses), grad_leaves, params, trainer.graph_replays)
    (loss_g, grads_g, params_g, replays), (loss_c, grads_c, params_c, _) = out["cuda"], out["cpu"]
    loss_err = float(np.max(np.abs(loss_g - loss_c) / np.abs(loss_c)))
    grad_err = float(
        np.linalg.norm(np.concatenate([(grads_g[k] - grads_c[k]).ravel() for k in grads_c]))
        / np.linalg.norm(np.concatenate([grads_c[k].ravel() for k in grads_c]))
    )
    diffs = np.concatenate([np.abs(params_g[k] - params_c[k]).ravel() for k in params_c])
    lr = 1e-4
    print(
        f"[headline] twin {label}, card vs CPU bf16, two steps of 8 series ({replays} replayed on the "
        f"card): losses and val loss {np.array2string(loss_g, precision=6)} vs "
        f"{np.array2string(loss_c, precision=6)}, max rel err {loss_err:.3g} (tol {TWIN_BF16_LOSS_RTOL}); "
        f"first gradient ||diff|| / ||CPU|| {grad_err:.3g} (tol {TWIN_BF16_GRAD_RTOL}); trained "
        f"parameters: max |diff| {diffs.max():.3g} (tol {2.01 * lr * 2:.3g}), "
        f"{float(np.mean(diffs > 0.1 * lr)):.3g} of {diffs.size:,} elements > 0.1 lr | "
        f"{time.perf_counter() - start:.1f} s",
        flush=True,
    )
    if replays != 1:
        raise AssertionError(f"twin {label}: {replays} graph replays, expected 1")
    if not (loss_err <= TWIN_BF16_LOSS_RTOL and grad_err <= TWIN_BF16_GRAD_RTOL and diffs.max() <= 2.01 * lr * 2):
        raise AssertionError(f"twin {label}: card and CPU disagree")


def eager_step_gemms(label: str, trainer) -> float:
    """One eager optimizer step of ``trainer`` over a batch of its staged rows under
    ``op_profile``: prints its device time and its GEMMs' efficiency against the bf16 peak
    (``utils.profiling.gemm_efficiency``), and returns the duration-weighted efficiency."""
    batch = trainer.args.per_device_train_batch_size
    staged = trainer._train_device
    idx = torch.arange(batch, device=trainer.device)
    ones = torch.ones(batch, device=trainer.device)
    summary, gemms = op_profile(lambda: trainer._optimizer_step([trainer._gather(staged, idx, ones, ones.sum())]))
    busy = summary["device_busy_ms"]
    print(
        f"[profile] {label}: one eager optimizer step, device busy {busy:.3f} ms, host ops "
        f"{summary['host_ms']:.3f} ms | GEMM ops {gemms['flop_ms']:.3f} ms of device time "
        f"({gemms['flop_ms'] / busy:.3f} of busy), weighted efficiency {gemms['weighted_eff']:.4f} of "
        f"{PEAK_FLOPS[torch.bfloat16]:.3g} FLOP/s | "
        + ", ".join(f"{op} x{n} {ms:.3f} ms {eff:.3f}" for op, n, ms, _, eff in gemms["top_gemms"][:6]),
        flush=True,
    )
    return gemms["weighted_eff"]


def roofline_line(workload: str, rate: float, eff: float, fixed_s: float | None = None) -> None:
    """The ``[roofline]`` line of ``workload`` (``multimodal_timesfm_torch.roofline`` at the
    GEMM efficiency ``eff`` measured here and the fixed cost ``fixed_s``, the module's
    constant when None) beside the measured share of peak: ``rate`` x FLOPs/series / peak."""
    from multimodal_timesfm_torch import roofline

    out, _ = roofline.roofline(workload, eff, roofline.FIXED_DISPATCH_S if fixed_s is None else fixed_s)
    share = rate * out["flops_per_series"] / roofline.PEAK
    print(f"[roofline] {workload}: measured {rate:.1f} train series/s = {share:.4f} of the "
          f"{roofline.PEAK:.3g} FLOP/s bf16 peak, on {torch.cuda.get_device_name(0)} | roofline at "
          f"eff {eff:.4f}: {json.dumps(out)}", flush=True)


def headline_phase(seed: int, tree: dict, decoders: dict) -> None:
    """The JAX bench's headline cells on the fused path: train series/s over the timed
    epochs after a warm-up run, a profiled epoch (idle share, GEMM share, top kernels), the
    fold state; two more baseline steps with the fused optimizer and with a bf16 working
    copy of the trained adapter; and card-against-CPU twins of both cells at 4 layers."""
    import dataclasses as dc

    from multimodal_timesfm_torch.models.bridge import load_jax_params, random_jax_params
    from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
    from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig

    kind = torch.cuda.get_device_name(0)
    decoder = decoders[torch.bfloat16]
    with tempfile.TemporaryDirectory() as workdir:
        for name, mode, batch, samples, epochs in HEADLINE_CELLS:
            load_jax_params(decoder, tree)
            train, val = bench_data(mode, batch, samples, seed)
            trainer = headline_trainer(decoder, mode, batch, train, val, epochs, workdir, seed)
            if not trainer.fused_epochs_supported():
                raise AssertionError(f"{name}: the fused path is not supported")
            start = time.perf_counter()
            trainer.train_epochs_fused(epochs)  # warm-up: the capture, cuBLAS plans, allocator
            warm_s = time.perf_counter() - start
            losses, val_losses = trainer.train_epochs_fused(epochs)
            rate = trainer.last_throughput
            wall, kernels = device_profile(lambda: trainer.train_epochs_fused(1))
            busy = sum(ms for _, ms in kernels)
            gemm = sum(ms for k, ms in kernels if is_gemm(k))
            simt = sum(ms for k, ms in kernels if is_gemm(k) and is_simt_gemm(k))
            steps = -(-samples // batch)
            want_replays = (2 * epochs + 1) * steps - 1
            if (trainer.graph_captures, trainer.graph_replays) != (1, want_replays):
                raise AssertionError(f"{name}: captures {trainer.graph_captures}, replays "
                                     f"{trainer.graph_replays}, expected 1, {want_replays}")
            if trainer.folded_seq1 != (mode == "multimodal"):
                raise AssertionError(f"{name}: folded_seq1 {trainer.folded_seq1}")
            stored = sorted({str(p.dtype)[6:] for p in trainer.model.adapter.parameters()})
            print(
                f"[headline] {name}: {mode}, batch {batch}, {samples} series, {steps} steps per epoch, "
                f"bf16 compute | {rate:.1f} train series/s over {epochs} epochs after a {warm_s:.1f} s "
                f"warm-up run, on {kind} | train loss {losses[0].mean():.5f} -> {losses[-1].mean():.5f}, "
                f"val loss {val_losses[-1]:.5f} | folded_seq1 {trainer.folded_seq1}, affine fold "
                f"{trainer._folded_affine}, adapter stored in {'/'.join(stored)}, moments "
                f"{str(trainer.optimizer.mu[0].dtype)[6:]} | fused epochs, one CUDA graph, "
                f"{trainer.graph_replays} replays",
                flush=True,
            )
            top = ", ".join(f"{k[:90]} {ms:.3f} ms ({ms / busy:.3f})" for k, ms in kernels[:8])
            print(
                f"[profile] {name}: one fused epoch of {steps} steps, wall {wall:.3f} ms, device busy "
                f"{busy:.3f} ms, idle {1 - busy / wall:.3f}, GEMM kernels {gemm:.3f} ms "
                f"({gemm / busy:.3f} of busy: tensor-core {gemm - simt:.3f} ms, fp32 SIMT {simt:.3f} ms) "
                f"| {top}",
                flush=True,
            )
            eff = eager_step_gemms(name, trainer)
            if name == "timesfm_mm_c32":
                # The fixed cost of one fused call: a 1-epoch call against the 3-epoch one.
                start = time.perf_counter()
                trainer.train_epochs_fused(epochs)
                many_s = time.perf_counter() - start
                start = time.perf_counter()
                trainer.train_epochs_fused(1)
                one_s = time.perf_counter() - start
                fixed_s = one_s - (many_s - one_s) / (epochs - 1)
                print(f"[roofline] {name}: fixed cost of one fused call {fixed_s:.6f} s (1 epoch "
                      f"{one_s:.6f} s, {epochs} epochs {many_s:.6f} s, on {kind})", flush=True)
                roofline_line(name, rate, eff, fixed_s)
            del trainer
            torch.cuda.empty_cache()

        for knobs in ({"fused_optimizer": True}, {"trainable_cast_dtype": torch.bfloat16}):
            load_jax_params(decoder, tree)
            train, val = bench_data("baseline", 8192, 2 * 8192, seed + 1)
            trainer = headline_trainer(decoder, "baseline", 8192, train, val, 1, workdir, seed, **knobs)
            losses, val_losses = trainer.train_epochs_fused(1)
            work = sorted({str(p.dtype)[6:] for p in trainer._work})
            wall, kernels = device_profile(lambda: trainer.train_epochs_fused(1))  # two replays
            busy = sum(ms for _, ms in kernels)
            gemm = sum(ms for k, ms in kernels if is_gemm(k))
            simt = sum(ms for k, ms in kernels if is_gemm(k) and is_simt_gemm(k))
            print(
                f"[headline] timesfm_baseline_c32 with {knobs}: two steps of 8192 series (one eager, "
                f"one replayed) | losses {np.array2string(losses.ravel(), precision=5)}, val loss "
                f"{val_losses[0]:.5f} | differentiated weights {'/'.join(work)}, optimizer "
                f"{type(trainer.optimizer).__name__} | two more steps (replays) profiled: wall "
                f"{wall:.3f} ms, device busy {busy:.3f} ms, GEMM kernels {gemm:.3f} ms (tensor-core "
                f"{gemm - simt:.3f} ms, fp32 SIMT {simt:.3f} ms)",
                flush=True,
            )
            del trainer
            torch.cuda.empty_cache()

        # The twins run 4 layers on both sides: the 200M model's bf16 steps on the CPU
        # are slow, and the script has to stay well inside its time limit.
        cfg4 = dc.replace(TimesFMConfig(num_layers=4), compute_dtype=torch.bfloat16)
        dec_cfg = MultimodalDecoderConfig(text_embedding_dims=384, num_fusion_layers=1)
        pair = {device: MultimodalDecoder(TimesFM2p5Adapter(cfg4), dec_cfg, device=device)
                for device in ("cuda", "cpu")}
        tree4 = random_jax_params(pair["cpu"], seed)
        fused_twin("timesfm_mm_c32 (folded, frozen adapter in bf16, 4 layers)", "multimodal", pair, tree4,
                   seed, workdir)
        fused_twin("timesfm_baseline_c32 (4 layers)", "baseline", pair, tree4, seed, workdir)


def launch_counters() -> dict[str, object]:
    """Every kernel wrapper of the port, by key: each counts its own launches."""
    from multimodal_timesfm_torch.ops.attention import (
        flash_causal_attention,
        flash_causal_attention_bwd,
        fused_causal_attention,
        fused_causal_attention_bwd,
    )
    from multimodal_timesfm_torch.ops.chronos_attention import (
        fused_chronos_attention,
        fused_chronos_attention_bwd,
    )
    from multimodal_timesfm_torch.ops.qkv_attention import (
        fused_qkv_causal_attention,
        fused_qkv_causal_attention_bwd,
    )

    return {
        "B1f": fused_qkv_causal_attention, "B1b": fused_qkv_causal_attention_bwd,
        "B2f": fused_causal_attention, "B2b": fused_causal_attention_bwd,
        "B3f": flash_causal_attention, "B3b": flash_causal_attention_bwd,
        "B4f": fused_chronos_attention, "B4b": fused_chronos_attention_bwd,
    }


def launch_counts() -> dict[str, int]:
    return {key: fn.launches for key, fn in launch_counters().items()}


def b4_routes() -> dict[str, int]:
    """B4f's and B4b's launches since their ``.shapes`` tallies were cleared, by the route
    the library's plan gives each shape ("B4f one-pass", "B4f tiled", "B4b fp32", ...)."""
    from multimodal_timesfm_torch.ops import _kernels

    names = ("fp32", "one-pass", "tiled")
    out: dict[str, int] = {}
    for key in ("B4f", "B4b"):
        for (dtype, batch, seq, heads, dim), n in launch_counters()[key].shapes.items():
            route = _kernels.chronos_plan(key == "B4b", dtype, batch, seq, heads, dim)["route"]
            label = f"{key} {names[route]}"
            out[label] = out.get(label, 0) + n
    return out


def expect_launches(label: str, before: dict[str, int], want: dict[str, int]) -> dict[str, int]:
    """The launches since ``before`` must be ``want`` for the keys named there and 0 elsewhere."""
    delta = {key: n - before[key] for key, n in launch_counts().items()}
    full = {key: want.get(key, 0) for key in delta}
    if delta != full:
        raise AssertionError(f"{label}: launches {delta}, expected {full}")
    return {key: n for key, n in delta.items() if n}


def long_context_phase(seed: int, tree: dict, decoders: dict) -> None:
    """TimesFM at context 67,200 (2,100 tokens): serving and one training step through B3."""
    from multimodal_timesfm_torch.inference import Forecaster
    from multimodal_timesfm_torch.models.bridge import load_jax_params
    from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
    from multimodal_timesfm_torch.training_args import TrainingArguments

    ctx, n = 67200, 2
    decoder = decoders[torch.float32]
    load_jax_params(decoder, tree)
    data = make_samples(ctx, n, seed)
    fc = Forecaster(decoder, batch_size=n, device="cuda")
    before = launch_counts()
    start = time.perf_counter()
    out = fc.forecast_dataset(HORIZON, data, denormalize=True)
    rate = n / (time.perf_counter() - start)
    if out.shape != (n, HORIZON) or not np.isfinite(out).all():
        raise AssertionError(f"context {ctx}: bad forecasts, shape {out.shape}")
    seen = expect_launches(f"context {ctx} serving", before, {"B3f": 20})
    print(f"[long] TimesFM context {ctx} (2,100 tokens) fp32, batch {n}: {rate:.2f} series/s "
          f"(one call, first at this length) | launches {seen}", flush=True)
    train = make_samples(ctx, n, seed + 1, TRAIN_HORIZON)
    with tempfile.TemporaryDirectory() as workdir:
        args = TrainingArguments(
            output_dir=workdir, per_device_train_batch_size=n, per_device_eval_batch_size=n,
            num_train_epochs=1, learning_rate=TRAIN_LR, weight_decay=0.01, eval_strategy="epoch",
            save_strategy="no", logging_strategy="no", seed=seed,
        )
        trainer = MultimodalTrainer(decoder, args, train, train, "multimodal", device="cuda")
        before = launch_counts()
        loss = trainer.train_epoch()
        seen = expect_launches(f"context {ctx} training", before, {"B3f": 20, "B3b": 20})
    if not np.isfinite(loss):
        raise AssertionError(f"context {ctx}: non-finite training loss {loss}")
    print(f"[long] TimesFM context {ctx} multimodal fp32, one step of {n} series: loss {loss:.5f}, "
          f"{trainer.last_throughput:.2f} train series/s | launches {seen}", flush=True)


def chronos_decoders(seed: int, cfg) -> tuple[dict, dict, object]:
    """(weights tree, {dtype: decoder on the card}, fp32 decoder on the CPU) for a Chronos-2
    configuration with the 384 -> 768 fusion MLP, weights drawn from ``seed``."""
    from multimodal_timesfm_torch.models.bridge import load_jax_params, random_jax_params
    from multimodal_timesfm_torch.models.chronos import Chronos2Adapter
    from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig

    dec_cfg = MultimodalDecoderConfig(text_embedding_dims=384, num_fusion_layers=1)

    def build(device: str, dtype: torch.dtype):
        decoder = MultimodalDecoder(
            Chronos2Adapter(dataclasses.replace(cfg, compute_dtype=dtype)), dec_cfg, device=device
        )
        load_jax_params(decoder, tree)
        return decoder

    tree = random_jax_params(MultimodalDecoder(Chronos2Adapter(cfg), dec_cfg, device="cpu"), seed)
    decoders = {dtype: build("cuda", dtype) for dtype in (torch.float32, torch.bfloat16)}
    return tree, decoders, build("cpu", torch.float32)


def chronos_serving_phase(seed: int) -> tuple[dict, dict, object]:
    """Chronos-2 120M served through Forecaster.forecast_dataset at horizon 128."""
    from multimodal_timesfm_torch.inference import Forecaster
    from multimodal_timesfm_torch.models.chronos import Chronos2Config

    kind = torch.cuda.get_device_name(0)
    cfg = Chronos2Config()  # 768 wide, 16 layers, 12 x 64 heads, ffn 3072, patch 16, 64 future patches
    t0 = time.perf_counter()
    tree, decoders, reference = chronos_decoders(seed, cfg)
    n_params = sum(p.numel() for p in reference.parameters())
    print(f"[chronos] {n_params:,} parameters from seed {seed} in {time.perf_counter() - t0:.1f} s")
    # context -> (series, batch size, series checked against the CPU); tokens = context / 16 + 1 + 64
    plan = {512: (200, 64, 8), 2048: (200, 64, 8), 8192: (16, 16, 2)}
    data = {ctx: make_samples(ctx, n, seed, HORIZON, patch=16) for ctx, (n, _, _) in plan.items()}
    forecasters = {
        (dtype, ctx): Forecaster(dec, batch_size=bs, device="cuda")
        for dtype, dec in decoders.items() for ctx, (_, bs, _) in plan.items()
    }
    for (dtype, ctx), fc in forecasters.items():  # warm-up: cuBLAS handles, allocator
        fc.forecast_dataset(HORIZON, data[ctx][: plan[ctx][1]], denormalize=True)
    torch.cuda.synchronize()
    preds = {}
    for (dtype, ctx), fc in forecasters.items():
        n, bs, _ = plan[ctx]
        before = launch_counts()
        rates = []
        for _ in range(SERVE_REPEATS):
            start = time.perf_counter()
            out = fc.forecast_dataset(HORIZON, data[ctx], denormalize=True)
            rates.append(n / (time.perf_counter() - start))
            if out.shape != (n, HORIZON) or not np.isfinite(out).all():
                raise AssertionError(f"chronos context {ctx} {dtype}: bad forecasts, shape {out.shape}")
            if (dtype, ctx) in preds and not np.array_equal(out, preds[(dtype, ctx)]):
                raise AssertionError(f"chronos context {ctx} {dtype}: forecasts differ between calls")
            preds[(dtype, ctx)] = out
        seen = expect_launches(f"chronos context {ctx} {dtype}", before,
                               {"B4f": 16 * -(-n // bs) * SERVE_REPEATS})
        print(
            f"[chronos] context {ctx} ({ctx // 16 + 65} tokens) {str(dtype)[6:]}: {n} series, median of "
            f"{SERVE_REPEATS} calls {float(np.median(rates)):.1f} series/s "
            f"({', '.join(f'{r:.1f}' for r in rates)}) on {kind} | launches {seen}",
            flush=True,
        )
    for (dtype, ctx), fc in forecasters.items():
        wall, kernels = device_profile(lambda: fc.forecast_dataset(HORIZON, data[ctx], denormalize=True))
        busy = sum(ms for _, ms in kernels)
        attn = sum(ms for name, ms in kernels if "chronos_fwd_" in name)
        top = ", ".join(f"{name[:60]} {ms:.3f} ms" for name, ms in kernels[:5])
        print(
            f"[profile] chronos context {ctx} {str(dtype)[6:]}: wall {wall:.3f} ms, device busy "
            f"{busy:.3f} ms, idle {1 - busy / wall:.3f}, B4f {attn:.3f} ms ({attn / busy:.3f} of busy) "
            f"| {top}",
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
                f"[chronos] context {ctx} {str(dtype)[6:]} vs CPU fp32 ({n_ref} series): "
                f"max abs err {err:.4g}, tolerance {tol:.4g} ({SLICE_TOL[dtype]} x std {scale:.4g})"
            )
            if not err <= tol:
                raise AssertionError(f"chronos context {ctx} {dtype}: card and CPU disagree")
    return tree, decoders, reference


def chronos_training_phase(seed: int, tree: dict, decoders: dict, reference) -> None:
    """Chronos-2 through MultimodalTrainer at the JAX bench's geometries, and CPU twins."""
    from multimodal_timesfm_torch.models.bridge import load_jax_params
    from multimodal_timesfm_torch.models.chronos import Chronos2Config
    from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
    from multimodal_timesfm_torch.training_args import TrainingArguments

    kind = torch.cuda.get_device_name(0)
    _, packed, _ = chronos_decoders(seed, dataclasses.replace(Chronos2Config(), max_output_patches=2, pack=16))
    # (bench workload, mode, dtype, decoder, batch, steps per epoch, trainer knobs); context
    # 32, horizon 32; the bf16 cell stores the frozen encoder in bf16, as bench.py:317 does
    cells = (
        ("chronos_mm_h32", "multimodal", torch.float32, decoders[torch.float32], 128, 3, {}),
        ("chronos_mm_h32", "multimodal", torch.bfloat16, decoders[torch.bfloat16], 128, 3,
         {"frozen_cast_dtype": torch.bfloat16}),
        ("chronos_baseline_h32", "baseline", torch.float32, decoders[torch.float32], 128, 3, {}),
        ("chronos_mm_h32_mop2", "multimodal", torch.float32, packed[torch.float32], 512, 3, {}),
    )
    with tempfile.TemporaryDirectory() as workdir:
        for name, mode, dtype, decoder, batch, steps, knobs in cells:
            label = f"{name} {mode} {str(dtype)[6:]}"
            load_jax_params(decoder, tree)
            train = make_samples(32, steps * batch, seed, CHRONOS_HORIZON, patch=16)
            val = make_samples(32, batch, seed + 1, CHRONOS_HORIZON, patch=16)
            args = TrainingArguments(
                output_dir=workdir, per_device_train_batch_size=batch,
                per_device_eval_batch_size=batch, num_train_epochs=3,
                learning_rate=TRAIN_LR if mode == "multimodal" else BASELINE_LR,
                weight_decay=0.01, eval_strategy="epoch", save_strategy="no",
                logging_strategy="no", seed=seed,
            )
            trainer = MultimodalTrainer(decoder, args, train, val, mode, device="cuda", **knobs)
            stored = {p.dtype for p in trainer.model.adapter.parameters()}
            table = decoder.adapter.encoder.rel_pos_bias.detach().clone()
            before = launch_counts()
            warm = trainer.train_epoch()  # first epoch: cuBLAS handles, allocator
            loss = trainer.train_epoch()
            series_per_s = trainer.last_throughput
            val_loss = trainer.validate_epoch()
            wall, kernels = device_profile(trainer.train_epoch)
            busy = sum(ms for _, ms in kernels)
            fwd = sum(ms for k, ms in kernels if "chronos_fwd_" in k)
            bwd = sum(ms for k, ms in kernels if "chronos_bwd" in k)
            top = ", ".join(f"{k[:60]} {ms:.3f} ms" for k, ms in kernels[:5])
            print(
                f"[profile] train {label}: one epoch of {steps} steps, wall {wall:.3f} ms, device busy "
                f"{busy:.3f} ms, idle {1 - busy / wall:.3f}, B4f {fwd:.3f} ms ({fwd / busy:.3f} of busy), "
                f"B4b {bwd:.3f} ms ({bwd / busy:.3f} of busy) | {top}",
                flush=True,
            )
            seen = expect_launches(label, before, {"B4f": 16 * (3 * steps + 1), "B4b": 16 * 3 * steps})
            if not all(np.isfinite(x) for x in (warm, loss, val_loss)):
                raise AssertionError(f"{label}: non-finite loss {warm}, {loss}, {val_loss}")
            moved = float((decoder.adapter.encoder.rel_pos_bias.detach() - table).abs().max())
            if (mode == "baseline") != (moved > 0):
                raise AssertionError(f"{label}: rel_pos_bias moved by {moved} in {mode} mode")
            print(
                f"[train] {label}: batch {batch}, {steps} steps per epoch | train loss {warm:.5f} -> "
                f"{loss:.5f}, val loss {val_loss:.5f} | {series_per_s:.1f} train series/s after "
                f"warm-up on {kind} | launches {seen} (16 per micro-batch each way, 16 per "
                f"validation batch) | rel_pos_bias moved {moved:.3g} | encoder weights stored in "
                f"{', '.join(sorted(str(d)[6:] for d in stored))}",
                flush=True,
            )
        pair = {"cuda": decoders[torch.float32], "cpu": reference}
        twin_check("chronos multimodal context 32", "multimodal", 32, pair, tree, seed, workdir, patch=16)
        twin_check("chronos baseline context 32", "baseline", 32, pair, tree, seed, workdir, patch=16,
                   report=("/encoder/rel_pos_bias",))


# --- the time-mmd data phase -------------------------------------------------

# The synthetic Time-MMD tree: the ten domains of the Time-MMD release (their
# columns from the port's DEFAULT_TIME_MMD_CONFIGS: Health_AFR's start column is
# ``date``), nine monthly domains of TIME_MMD_ROWS rows and the
# daily Environment domain of TIME_MMD_DAILY_ROWS; a report row every 7 rows (fact
# and preds), a search table on every other domain. Per domain (in
# TIME_MMD_DOMAINS order) the median words of a text cell and the share of cells
# that are NA-like, so that every length bucket from 16 to 256 occurs and texts
# are cut at 256.
TIME_MMD_DOMAINS = ("Agriculture", "Climate", "Economy", "Energy", "Environment",
                    "Health_AFR", "Health_US", "Security", "SocialGood", "Traffic")
TIME_MMD_ROWS = 500
# Environment is cut from 11,000 daily rows to 4,000: at 11,000 the phase took
# about 146 s on an NVIDIA H100 80GB HBM3 at 700 W (the headline cache's calls of
# one text set the pace), over its 120 s budget.
TIME_MMD_DAILY_ROWS = 4000
TEXT_MEDIAN_WORDS = (1, 2, 3, 5, 8, 12, 18, 25, 40, 3)
TEXT_NA_SHARE = (0.7, 0.5, 0.3, 0.2, 0.1, 0.1, 0.1, 0.1, 0.05, 0.4)
NA_CELLS = ("NA", "null", "", "N/A", "NA - not available", "None", "nan", "NULL")
SYLLABLES = ("ka", "lo", "mi", "ne", "ru", "ta", "sho", "vi", "de", "po", "gra", "tel", "an", "es", "or")
# Card against the same encoder on the CPU, both fp32 without TF32, on L2-normalised
# embeddings: the same fp32 products summed in another order (1e-6 expected).
ENCODER_TOL = 1e-4
# (context, horizon) of the two cache geometries, patch 32: the headline's, and
# context 512 (16 texts a call).
CACHE_GEOMETRIES = ((32, 32), (512, 128))
TRAIN_DOMAINS = ("Agriculture", "Climate", "Economy", "Energy", "Environment", "Health_AFR", "Security")


def write_csv(path, header: list[str], rows: list[list[str]]) -> None:
    import csv

    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        writer.writerows(rows)


def write_time_mmd_tree(root, seed: int) -> list[str]:
    """Write the synthetic Time-MMD tree under ``root`` with the ``csv`` module from numpy
    draws; return its words (3,000 made of SYLLABLES). Each domain's numerical CSV has
    its own configured columns, rows in shuffled order, an empty first and a NaN last
    value and a few interior NA, nan and inf cells."""
    import datetime as dt

    from multimodal_timesfm_torch.time_mmd.columns import DEFAULT_TIME_MMD_CONFIGS

    rng = np.random.default_rng(seed)
    words: dict[str, None] = {}
    while len(words) < 3000:
        words["".join(rng.choice(SYLLABLES, size=int(rng.integers(1, 5))))] = None
    vocab_words = np.array(list(words))
    for k, domain in enumerate(TIME_MMD_DOMAINS):
        cols = DEFAULT_TIME_MMD_CONFIGS.get_config_for_domain(domain)
        daily = domain == "Environment"
        n = TIME_MMD_DAILY_ROWS if daily else TIME_MMD_ROWS
        if daily:
            starts = ends = [dt.date(1990, 1, 1) + dt.timedelta(days=i) for i in range(n)]
        else:
            starts = [dt.date(1980 + i // 12, i % 12 + 1, 1) for i in range(n)]
            ends = [dt.date(1980 + (i + 1) // 12, (i + 1) % 12 + 1, 1) - dt.timedelta(days=1) for i in range(n)]
        t = np.arange(n)
        series = 10 + 3 * np.sin(2 * np.pi * t / (365 if daily else 12)) + 0.1 * np.cumsum(rng.normal(size=n))
        values = [f"{v:.4f}" for v in series]
        values[0], values[-1] = "", "NaN"
        for i in rng.choice(np.arange(2, n - 2), size=n // 50, replace=False):
            values[i] = str(rng.choice(["NA", "nan", "inf", "-inf", "null"]))
        write_csv(root / "numerical" / domain / f"{domain}.csv",
                  [cols.start_date_col, cols.end_date_col, *cols.time_series_cols, "extra"],
                  [[starts[i].isoformat(), ends[i].isoformat(), values[i], "x"] for i in rng.permutation(n)])

        def cell() -> str:
            if rng.random() < TEXT_NA_SHARE[k]:
                return str(rng.choice(NA_CELLS))
            count = int(np.clip(np.exp(rng.normal(np.log(TEXT_MEDIAN_WORDS[k]), 0.8)), 1, 400))
            return " ".join(vocab_words[rng.integers(0, len(vocab_words), count)]).capitalize() + "."

        def table(offset: int, span: int) -> list[list[str]]:
            return [[starts[i].isoformat(), ends[min(i + span, n - 1)].isoformat(), cell(), cell()]
                    for i in range(offset, n, 7)]

        header = ["start_date", "end_date", "fact", "preds"]
        write_csv(root / "textual" / domain / f"{domain}_report.csv", header, table(0, 6))
        if k % 2 == 0:
            write_csv(root / "textual" / domain / f"{domain}_search.csv", header, table(3, 10))
    return list(words)


def write_minilm_snapshot(path, words: list[str], seed: int) -> None:
    """A local snapshot at all-MiniLM-L6-v2's geometry: ``config.json``, a 30,522-entry
    ``vocab.txt`` (2,400 of the tree's words, the syllables and their ``##`` pieces, so
    the other words split or become [UNK]) and ``pytorch_model.bin`` under HF's names,
    weights drawn from ``seed`` (no pretrained weights are in the repository)."""
    from multimodal_timesfm_torch.models.bridge import export_jax_params
    from multimodal_timesfm_torch.text.bert import BertConfig, BertEncoder
    from multimodal_timesfm_torch.text.convert import hf_bert_state

    cfg = BertConfig.minilm_l6()
    path.mkdir(parents=True)
    module = BertEncoder(cfg, torch.Generator().manual_seed(seed))
    state = hf_bert_state(export_jax_params(module))
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, path / "pytorch_model.bin")
    entries = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", ",", ":", *words[:2400], *SYLLABLES,
               *(f"##{s}" for s in SYLLABLES)]
    entries += [f"[unused{i}]" for i in range(cfg.vocab_size - len(entries))]
    (path / "vocab.txt").write_text("\n".join(entries) + "\n")
    (path / "config.json").write_text(json.dumps({
        "hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads, "intermediate_size": cfg.intermediate_size,
        "vocab_size": cfg.vocab_size, "max_position_embeddings": cfg.max_position_embeddings,
    }))


def _types(node, seen: set) -> set:
    seen.add(type(node))
    if isinstance(node, dict):
        for key, value in node.items():
            seen.add(type(key))
            _types(value, seen)
    elif isinstance(node, list):
        for value in node:
            _types(value, seen)
    return seen


def check_cache_file(path) -> list:
    """Load one cache pickle and fail unless it holds dicts, lists, Python scalars and
    float32 numpy arrays only (what the JAX package's pickles hold)."""
    import pickle

    samples = pickle.loads(path.read_bytes())
    kinds = _types(samples, set())
    if not kinds <= {list, dict, str, int, float, bool, np.ndarray}:
        raise AssertionError(f"{path.name} holds {sorted(k.__name__ for k in kinds)}")
    dtypes = {a.dtype for s in samples for a in s.values() if isinstance(a, np.ndarray)}
    if dtypes - {np.dtype(np.float32)}:
        raise AssertionError(f"{path.name} holds arrays of {dtypes}")
    return samples


def time_mmd_phase(seed: int, tree: dict) -> None:
    """CSVs -> windows and per-patch texts -> MiniLM-L6 on the card -> the embedding cache
    (the port's ``time_mmd.cache`` CLI) -> the fold loader -> MultimodalTrainer and
    MultimodalEvaluator on TimesFM-2.5 200M; ModernBERT at ruri-v3-310m width; both
    encoders held to the port on the CPU."""
    import collections
    import copy
    import shutil
    from pathlib import Path

    from multimodal_timesfm_torch.data.preprocess import PreprocessPipeline
    from multimodal_timesfm_torch.models.bridge import load_jax_params
    from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
    from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig
    from multimodal_timesfm_torch.text.encoders import JapaneseTextEncoder, build_text_encoder, fp32_matmuls
    from multimodal_timesfm_torch.text.modernbert import ModernBertConfig, ModernBertEncoder
    from multimodal_timesfm_torch.text.tokenizer import HashTokenizer
    from multimodal_timesfm_torch.time_mmd import cache as cache_cli
    from multimodal_timesfm_torch.time_mmd.cross_validation import DomainSpec, load_fold_datasets
    from multimodal_timesfm_torch.time_mmd.dataset import TimeMmdDataset
    from multimodal_timesfm_torch.training.evaluator import MultimodalEvaluator
    from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
    from multimodal_timesfm_torch.training_args import TrainingArguments

    kind = torch.cuda.get_device_name(0)
    print(f"[data] matmul flags at the start: float32_matmul_precision "
          f"{torch.get_float32_matmul_precision()!r}, cuda.matmul.allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root, snapshot, cache_dir = tmp / "Time-MMD", tmp / "minilm", tmp / "cache"
        t0 = time.perf_counter()
        words = write_time_mmd_tree(root, seed)
        write_minilm_snapshot(snapshot, words, seed)
        rows = {d: sum(1 for _ in open(root / "numerical" / d / f"{d}.csv")) - 1 for d in TIME_MMD_DOMAINS}
        print(f"[data] synthetic Time-MMD tree (csv module, seed {seed}): {rows} rows, report CSVs on every "
              f"domain, search CSVs on {len(list(root.glob('textual/*/*_search.csv')))}; MiniLM-L6 snapshot "
              f"(pytorch_model.bin, weights from seed {seed}) in {time.perf_counter() - t0:.1f} s", flush=True)
        (tmp / "model.json").write_text(json.dumps({
            "adapter": {"type": "timesfm", "patch_len": 32},
            "fusion": {"text_encoder_type": "english", "text_embedding_dims": 384}}))

        encoder = build_text_encoder("english", str(snapshot), embedding_dim=384)
        if shutil.which("g++") and encoder.tokenizer_name != "WordPieceTokenizer (native)":
            raise AssertionError(f"g++ is present but the tokenizer is {encoder.tokenizer_name}")
        print(f"[data] encoder {type(encoder).__name__} on {encoder.device}, tokenizer "
              f"{encoder.tokenizer_name}, "
              f"pretrained stamp {encoder.is_pretrained}", flush=True)

        # Caches through the CLI: augmented and plain, at both geometries.
        for ctx, hor in CACHE_GEOMETRIES:
            forecast = tmp / f"forecast_c{ctx}.json"
            forecast.write_text(json.dumps({"context_len": ctx, "horizon_len": hor}))
            for augment in (True, False):
                argv = ["--data-path", str(root), "--model-config", str(tmp / "model.json"),
                        "--forecast-config", str(forecast), "--text-encoder-type", "english",
                        "--text-model-dir", str(snapshot), "--cache-dir", str(cache_dir), "--seed", str(seed),
                        *(["--augment"] if augment else [])]
                start = time.perf_counter()
                if cache_cli.main(argv) != 0:
                    raise AssertionError(f"cache CLI failed: {argv}")
                seconds = time.perf_counter() - start
                suffix = "_aug" if augment else ""
                files = sorted(cache_dir.glob(f"time_mmd_*_english_p32_c{ctx}_h{hor}{suffix}.pkl"))
                if len(files) != len(TIME_MMD_DOMAINS):
                    raise AssertionError(f"{len(files)} cache files at context {ctx}{suffix}")
                samples = sum(len(check_cache_file(f)) for f in files)
                texts = samples * (ctx // 32)
                print(f"[data] cache context {ctx} horizon {hor}{' --augment' if augment else ''}: {samples} "
                      f"samples, {texts} texts ({ctx // 32} a call) in {seconds:.2f} s (CLI wall: CSVs, "
                      f"windows, encoder, pickles), {texts / seconds:.1f} texts/s on {kind}", flush=True)

        # Length buckets and the cut at 256 over the headline cache's texts (one a call).
        def texts_of(sample) -> list[str]:
            return [" ".join(p) if p else "" for p in sample["patched_texts"]]

        buckets, cut = collections.Counter(), 0
        for domain in TIME_MMD_DOMAINS:
            for sample in TimeMmdDataset(root, domain, 32, 32, 32, augment=True):
                texts = texts_of(sample)
                buckets[encoder.tokenizer.encode_batch(texts, 256)[0].shape[1]] += 1
                cut += sum(len(encoder.tokenizer.encode(t, 4096)) > 256 for t in texts)
        print(f"[data] context-32 --augment calls by padded length: {dict(sorted(buckets.items()))}; "
              f"texts cut at 256 tokens: {cut}", flush=True)
        if set(buckets) != {16, 32, 64, 128, 256} or cut == 0:
            raise AssertionError("the tree does not reach every length bucket and the cut at 256")

        # One domain's build, profiled: the encode loop's idle share and top kernels.
        pipeline = PreprocessPipeline(tmp / "profiled")
        dataset = TimeMmdDataset(root, "Agriculture", 32, 32, 32, augment=True)
        path = pipeline.get_path("time_mmd", "Agriculture", "english", 32, 32, 32, augment=True)
        built = []
        wall, kernels = device_profile(lambda: built.append(pipeline.prepare(path, lambda: dataset, encoder,
                                                                             force_rebuild=True)))
        busy = sum(ms for _, ms in kernels)
        top = ", ".join(f"{name[:60]} {ms:.3f} ms" for name, ms in kernels[:6])
        print(f"[profile] cache build of Agriculture, context 32 --augment ({len(dataset)} calls of one "
              f"text): wall {wall:.3f} ms, device busy {busy:.3f} ms, idle {1 - busy / wall:.3f}, "
              f"{len(dataset) / wall * 1e3:.1f} texts/s | {top}", flush=True)
        reloaded = pipeline.load(path)
        same = len(reloaded) == len(built[0]) and all(
            a["metadata"] == b["metadata"] and all(np.array_equal(a[k], b[k]) for k in
                                                   ("context", "horizon", "text_embeddings"))
            for a, b in zip(reloaded, built[0]))
        if not same:
            raise AssertionError("the cache file does not reload equal")
        print("[data] the profiled cache reloads equal; every cache pickle holds dicts, lists, Python "
              "scalars and float32 numpy arrays only", flush=True)

        # Card against CPU: MiniLM-L6 at full width on 256 texts of the tree, every step-th of
        # its plain windows' texts at both geometries (short and cut alike), with TF32 turned
        # on for the process.
        plain = [t for ctx, hor in CACHE_GEOMETRIES for d in TIME_MMD_DOMAINS
                 for s in TimeMmdDataset(root, d, 32, ctx, hor) for t in texts_of(s)]
        step = max(1, len(plain) // 256)
        picked = plain[::step][:256]
        start = time.perf_counter()
        cpu_encoder = build_text_encoder("english", str(snapshot), embedding_dim=384, device="cpu")
        previous = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("high")
        try:
            card = encoder(picked)
        finally:
            torch.set_float32_matmul_precision(previous)
        err = float(np.abs(card - cpu_encoder(picked)).max())
        print(f"[data] MiniLM-L6 card vs CPU on {len(picked)} texts (every {step}th of the {len(plain)} plain "
              f"windows' texts), process precision 'high' (TF32 allowed) outside the encoder: max abs diff "
              f"{err:.3g} (tol {ENCODER_TOL}) | "
              f"{time.perf_counter() - start:.1f} s", flush=True)
        if not err <= ENCODER_TOL:
            raise AssertionError("MiniLM-L6: card and CPU disagree")

        # ModernBERT at ruri-v3-310m width on the card; a 3-layer twin on the CPU.
        start = time.perf_counter()
        ruri = JapaneseTextEncoder()
        ruri(picked[:32])  # warm-up: cuBLAS handles, allocator
        torch.cuda.synchronize()
        built_s = time.perf_counter() - start
        start = time.perf_counter()
        emb = ruri(picked)
        seconds = time.perf_counter() - start
        norms = np.linalg.norm(emb, axis=1)
        print(f"[data] ModernBERT {ruri.config.num_layers} layers x {ruri.config.hidden_size} on {kind}: "
              f"{len(picked)} texts in chunks of 32 in {seconds:.3f} s, {len(picked) / seconds:.1f} texts/s | "
              f"shape {emb.shape}, |norm - 1| max {np.abs(norms - 1).max():.2g}, tokenizer "
              f"{ruri.tokenizer_name} | "
              f"built and warmed in {built_s:.1f} s",
              flush=True)
        if emb.shape != (len(picked), 768) or not np.isfinite(emb).all() or np.abs(norms - 1).max() > 1e-4:
            raise AssertionError("ModernBERT: bad embeddings")
        del ruri
        start = time.perf_counter()
        cfg3 = dataclasses.replace(ModernBertConfig.ruri_v3_310m(), num_layers=3)
        cpu_model = ModernBertEncoder(cfg3, torch.Generator().manual_seed(seed)).eval()
        card_model = copy.deepcopy(cpu_model).cuda()
        tok = HashTokenizer(cfg3.vocab_size)
        worst, seqs = 0.0, []
        with torch.no_grad(), fp32_matmuls():
            for i in range(0, 64, 32):
                ids, mask = (torch.from_numpy(a) for a in tok.encode_batch(picked[i:i + 32], 256))
                seqs.append(ids.shape[1])
                got = card_model(ids.cuda(), mask.cuda()).cpu()
                worst = max(worst, float((got - cpu_model(ids, mask)).abs().max()))
        if max(seqs) <= cfg3.local_attention_window // 2 + 1:
            raise AssertionError(f"ModernBERT twin: padded lengths {seqs} never reach past the local window")
        print(f"[data] ModernBERT 3 layers (global, local, local; window {cfg3.local_attention_window}) x "
              f"{cfg3.hidden_size} card vs CPU on 64 texts (padded to {seqs}): max abs diff {worst:.3g} "
              f"(tol {ENCODER_TOL}) | {time.perf_counter() - start:.1f} s", flush=True)
        if not worst <= ENCODER_TOL:
            raise AssertionError("ModernBERT: card and CPU disagree")
        del card_model, cpu_model

        # Training from the caches: TimesFM-2.5 200M, bf16 compute.
        adapter = TimesFM2p5Adapter(dataclasses.replace(TimesFMConfig(), compute_dtype=torch.bfloat16))
        dec_cfg = MultimodalDecoderConfig(text_embedding_dims=384, num_fusion_layers=1)
        decoder = MultimodalDecoder(adapter, dec_cfg, device="cuda")
        folds = {
            32: ([DomainSpec(d, augment=True) for d in TRAIN_DOMAINS],
                 [DomainSpec("Health_US"), DomainSpec("SocialGood")], [DomainSpec("Traffic")]),
            # Only the daily domain is long enough for a 640-step window.
            512: ([DomainSpec("Environment", augment=True)], [DomainSpec("Environment")],
                  [DomainSpec("Environment")]),
        }
        workdir = tmp / "train"
        for ctx, hor in CACHE_GEOMETRIES:
            start = time.perf_counter()
            train, val, test = load_fold_datasets(*folds[ctx], "english", 32, ctx, hor, cache_dir)
            load_jax_params(decoder, tree)
            before = launch_counts()
            if ctx == 32:  # the headline configuration: folded, frozen adapter in bf16, fused epochs
                trainer = headline_trainer(decoder, "multimodal", 2048, train, val, 1, str(workdir), seed)
                if not (trainer.fused_epochs_supported() and trainer.folded_seq1):
                    raise AssertionError("context 32: not the fused, folded headline path")
                trainer.train_epochs_fused(1)  # warm-up: the capture, cuBLAS plans
                losses, val_losses = trainer.train_epochs_fused(1)
                losses = list(losses.ravel()) + list(np.ravel(val_losses))
                batch, path_name = 2048, "fused epochs, one CUDA graph"
            else:  # bf16 on the per-epoch loop, B1 in both directions
                batch, path_name = 256, "per-epoch loop"
                args = TrainingArguments(
                    output_dir=str(workdir), per_device_train_batch_size=batch,
                    per_device_eval_batch_size=batch, num_train_epochs=1, learning_rate=TRAIN_LR,
                    weight_decay=0.01, eval_strategy="epoch", save_strategy="no", logging_strategy="no",
                    seed=seed,
                )
                trainer = MultimodalTrainer(decoder, args, train, val, "multimodal", device="cuda")
                losses = [trainer.train_epoch(), trainer.train_epoch(), trainer.validate_epoch()]
            rate = trainer.last_throughput
            metrics = MultimodalEvaluator(trainer.eval_model, device="cuda").evaluate(test, batch_size=batch)
            steps, val_batches, test_batches = (-(-len(d) // batch) for d in (train, val, test))
            want = {}  # one token at context 32: the folded stack runs no attention kernel
            if ctx == 512:  # two epochs of steps, a validation and a test pass, 20 layers
                want = {"B1f": 20 * (2 * steps + val_batches + test_batches), "B1b": 20 * 2 * steps}
            seen = expect_launches(f"time-mmd context {ctx}", before, want)
            values = [*losses, metrics["mse"], metrics["mae"]]
            if not np.isfinite(values).all():
                raise AssertionError(f"time-mmd context {ctx}: non-finite {values}")
            print(f"[data] train TimesFM-2.5 200M from the context-{ctx} caches ({path_name}, bf16): "
                  f"{len(train)} / {len(val)} / {len(test)} train / val / test series, batch {batch}, {steps} "
                  f"steps an epoch, two epochs | losses {np.array2string(np.asarray(losses), precision=5)} | "
                  f"{rate:.1f} train series/s (the second epoch) on {kind} | "
                  f"{time.perf_counter() - start:.1f} s "
                  f"| test mse {metrics['mse']:.5f}, mae {metrics['mae']:.5f} | launches "
                  f"{seen} (20 per micro-batch each way, 20 per validation and test batch)", flush=True)
            del trainer
            torch.cuda.empty_cache()
    # The card's path reads CSVs, snapshots and configs without these (YAML is tried first
    # where it is installed; a JSON config reads without it).
    imported = sorted(m for m in ("pandas", "safetensors", "transformers", "jax") if m in sys.modules)
    if imported:
        raise AssertionError(f"the data path imported {imported}")


# The two snapshots of the "pretrained to served" phase: upstream tensor names (the
# converters' rules, candidate 0), weights drawn from --seed, and a config.json giving the
# published geometry (TimesFM-2.5 200M; Chronos-2 120M) in the upstream config's own names.
QUANTILES = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9]
PRETRAINED_HF = {
    "timesfm-2.5-200m": {
        "model_type": "timesfm", "patch_len": 32, "output_patch_len": 128, "hidden_size": 1280,
        "intermediate_size": 1280, "num_hidden_layers": 20, "num_attention_heads": 16,
        "quantiles": QUANTILES,
    },
    "chronos-2-120m": {
        "model_type": "t5", "d_model": 768, "d_ff": 3072, "num_layers": 16, "num_heads": 12,
        "relative_attention_num_buckets": 32, "relative_attention_max_distance": 128,
        "chronos_config": {"input_patch_size": 16, "output_patch_size": 16, "max_output_patches": 64,
                           "quantiles": QUANTILES, "use_reg_token": True},
    },
}
# An exported artifact against Forecaster on the same weights, on the card: the program runs
# the same aten ops and kernels at the same shapes (its last batch padded as Forecaster pads
# it), so the forecasts are expected bit-equal. Where they are not, |diff| <= TOL x std: fp32,
# summation order only; bf16, one bf16 ulp (2^-8) flipped in a layer's output carries
# through the stack.
EXPORT_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
EXPORTS = (  # (snapshot, context, compute dtype, traced on: the fp32 one on the CPU)
    ("timesfm-2.5-200m", 512, torch.float32, "cpu"),
    ("timesfm-2.5-200m", 512, torch.bfloat16, "cuda"),
    ("timesfm-2.5-200m", 2048, torch.bfloat16, "cuda"),
    ("chronos-2-120m", 512, torch.bfloat16, "cuda"),
    ("chronos-2-120m", 2048, torch.bfloat16, "cuda"),
)


def write_pretrained_snapshot(path, adapter, rules, hf: dict, seed: int) -> dict:
    """A synthetic upstream snapshot of ``adapter``'s geometry: ``model.safetensors`` (the
    port's writer) under the upstream names of ``rules`` and ``config.json``. Weights are
    ``bridge.random_jax_params(adapter, seed)``, an RMS gain stored in the weight convention
    (1 + scale). Returns the JAX-layout tree the converter must give."""
    import re

    from multimodal_timesfm_torch.models.bridge import random_jax_params
    from multimodal_timesfm_torch.utils import safetensors

    upstream, want = {}, {}
    for key, value in _leaves(random_jax_params(adapter, seed)).items():
        key = key.strip("/")
        _, candidates = next(r for r in rules if re.fullmatch(r[0], key))
        name, transform = candidates[0]
        if transform == "rms":
            stored = (value + np.float32(1.0)).astype(np.float32)
            value = stored - np.float32(1.0)  # what the converter computes
        elif transform == "t":
            stored = np.swapaxes(value, -1, -2)
        elif transform == "":
            stored = value
        else:
            raise AssertionError(f"{key}: candidate 0 has transform {transform!r}")
        want[key] = value
        for i, part in enumerate(stored) if "{i}" in name else ((None, stored),):
            upstream[name.format(i=i) if i is not None else name] = np.ascontiguousarray(part)
    path.mkdir(parents=True, exist_ok=True)
    safetensors.save_file(upstream, path / "model.safetensors")
    (path / "config.json").write_text(json.dumps(hf))
    tree: dict = {}
    for key, value in want.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def serve_padded(serve, context: np.ndarray, text: np.ndarray, batch: int) -> np.ndarray:
    """An exported artifact over ``context`` in batches of ``batch`` rows, the last padded by
    repeating its last row, as Forecaster pads it; returns the real rows' point forecasts."""
    from multimodal_timesfm_torch.inference import _pad_rows

    outs = []
    for i in range(0, context.shape[0], batch):
        real = min(batch, context.shape[0] - i)
        out = serve(_pad_rows(context[i : i + batch], batch), _pad_rows(text[i : i + batch], batch))
        outs.append(out["point_forecast"].cpu().numpy()[:real])
    return np.concatenate(outs)


def compare_export(label: str, out: np.ndarray, ref: np.ndarray, dtype: torch.dtype) -> str:
    """The artifact's forecasts against Forecaster's: bit-equal, or within EXPORT_TOL."""
    if out.shape != ref.shape or not np.isfinite(out).all():
        raise AssertionError(f"{label}: bad forecasts, shape {out.shape}")
    if np.array_equal(out, ref):
        return "bit-equal to Forecaster"
    err, tol = float(np.abs(out - ref).max()), EXPORT_TOL[dtype] * float(ref.std())
    if not err <= tol:
        raise AssertionError(f"{label}: artifact and Forecaster differ by {err:.4g} > {tol:.4g}")
    return f"max |artifact - Forecaster| {err:.4g} <= {tol:.4g} ({EXPORT_TOL[dtype]} x std), not bit-equal"


def pretrained_phase(seed: int) -> None:
    """Snapshots -> from_pretrained -> a bf16 fine-tune with checkpoints of both backends
    and resumes -> exported artifacts served from their files (re-pointed once) -> the
    repaired gates -> the forecast CLI with the autoregressive decode graph."""
    import copy
    import pickle
    import shutil
    import warnings
    from pathlib import Path

    from multimodal_timesfm_torch import forecast as forecast_cli
    from multimodal_timesfm_torch.inference import Forecaster
    from multimodal_timesfm_torch.models import layers
    from multimodal_timesfm_torch.models.bridge import export_jax_params, load_jax_params, random_jax_params
    from multimodal_timesfm_torch.models.chronos import Chronos2Adapter
    from multimodal_timesfm_torch.models.convert import CHRONOS_NAME_RULES, TIMESFM_NAME_RULES
    from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
    from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig
    from multimodal_timesfm_torch.serving import export_program, load_program, save_program_params
    from multimodal_timesfm_torch.training.checkpoint import save_checkpoint
    from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
    from multimodal_timesfm_torch.training_args import TrainingArguments

    kind = torch.cuda.get_device_name(0)
    root = Path(__file__).resolve().parent / "build" / "pretrained"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    dec_cfg = MultimodalDecoderConfig(text_embedding_dims=384, num_fusion_layers=1)
    specs = {"timesfm-2.5-200m": (TimesFM2p5Adapter, TIMESFM_NAME_RULES),
             "chronos-2-120m": (Chronos2Adapter, CHRONOS_NAME_RULES)}

    # 1. snapshots, and from_pretrained on the card against the bridge
    decoders = {}
    for name, (cls, rules) in specs.items():
        hf = PRETRAINED_HF[name]
        start = time.perf_counter()
        want = write_pretrained_snapshot(root / name, cls(cls.config_from_hf(hf)), rules, hf, seed)
        size = (root / name / "model.safetensors").stat().st_size
        written = time.perf_counter() - start
        start = time.perf_counter()
        adapter = cls.from_pretrained(root / name)
        loaded = time.perf_counter() - start
        if cls is TimesFM2p5Adapter and adapter.config != TimesFMConfig():
            raise AssertionError(f"{name}: config.json read as {adapter.config}")
        decoder = MultimodalDecoder(adapter, dec_cfg, device="cuda")
        fusion = random_jax_params(decoder.fusion, seed)
        load_jax_params(decoder.fusion, fusion)
        ref = MultimodalDecoder(cls(adapter.config), dec_cfg, device="cuda")
        load_jax_params(ref.adapter, want)
        load_jax_params(ref.fusion, fusion)
        pairs = list(zip(decoder.named_parameters(), ref.named_parameters()))
        bad = [n for (n, a), (_, b) in pairs if not torch.equal(a, b)]
        if bad or len(pairs) != len(list(ref.parameters())):
            raise AssertionError(f"{name}: from_pretrained differs from the bridge at {bad[:5]}")
        n_params = sum(p.numel() for p in adapter.parameters())
        print(f"[pretrained] {name}: synthetic snapshot (seed {seed}) model.safetensors "
              f"{size / 1e6:.1f} MB, {n_params:,} backbone parameters, written in {written:.1f} s; "
              f"from_pretrained (config.json geometry, port safetensors reader, converter) in "
              f"{loaded:.1f} s; all {len(pairs)} tensors on the card bit-equal to the bridge", flush=True)
        decoders[name] = decoder
        del ref
    timesfm = decoders["timesfm-2.5-200m"]

    def with_dtype(decoder, dtype: torch.dtype):
        """A copy of ``decoder`` computing in ``dtype`` (built on the meta device, then given
        a copy of the weights: no random draw of 200M parameters)."""
        if dtype == torch.float32:
            return decoder
        cfg = dataclasses.replace(decoder.adapter.config, compute_dtype=dtype)
        with torch.device("meta"):
            copy_ = MultimodalDecoder(type(decoder.adapter)(cfg), dec_cfg, device="meta")
        copy_ = copy_.to_empty(device="cuda")
        copy_.load_state_dict(decoder.state_dict())
        return copy_

    # 2. fine-tune TimesFM from the snapshot (multimodal, c512, bf16), checkpoint, resume
    train = make_samples(512, 128, seed + 11, TRAIN_HORIZON)
    val = make_samples(512, 64, seed + 12, TRAIN_HORIZON)

    def trainer(out: str):
        args = TrainingArguments(
            output_dir=str(root / out), per_device_train_batch_size=64, per_device_eval_batch_size=64,
            num_train_epochs=2, learning_rate=TRAIN_LR, weight_decay=0.01, eval_strategy="epoch",
            save_strategy="epoch", logging_strategy="no", seed=seed)
        return MultimodalTrainer(with_dtype(timesfm, torch.bfloat16), args, train, val, "multimodal",
                                 device="cuda", frozen_cast_dtype=torch.bfloat16, ckpt_backend="orbax")

    start = time.perf_counter()
    run = trainer("finetune")
    before = launch_counts()
    run.current_epoch = 0
    losses = [run.train_epoch()]
    run.save_ckpt(run.validate_epoch())
    orbax_ckpt = run.args.checkpoint_dir / "checkpoint_epoch_0.ckpt"
    pickle_ckpt = root / "finetune_epoch_0_pickle.ckpt"
    save_checkpoint(pickle_ckpt, run._build_checkpoint(), backend="pickle")
    run.current_epoch = 1
    losses.append(run.train_epoch())
    rate = run.last_throughput
    final = _leaves(export_jax_params(run.trainable_module))
    seen = expect_launches("fine-tune from the snapshot", before, {"B1f": 20 * 5, "B1b": 20 * 4})
    if not orbax_ckpt.is_dir() or not np.isfinite(losses).all():
        raise AssertionError(f"fine-tune: checkpoint {orbax_ckpt} or losses {losses}")
    print(f"[pretrained] fine-tune TimesFM-2.5 200M from the snapshot: multimodal, context 512, bf16 "
          f"(frozen adapter stored in bf16), 128 series in batches of 64, two epochs: losses "
          f"{np.array2string(np.asarray(losses), precision=6)}, {rate:.1f} train series/s (second epoch) "
          f"on {kind} | launches {seen} | {time.perf_counter() - start:.1f} s", flush=True)
    for backend, path in (("orbax", orbax_ckpt), ("pickle", pickle_ckpt)):
        resumed = trainer(f"resume_{backend}")
        resumed.resume_from_checkpoint(path)
        resumed._rng.permutation(len(train))  # the order epoch 0 drew, as the run drew it
        resumed.current_epoch = 1
        loss = resumed.train_epoch()
        mine = _leaves(export_jax_params(resumed.trainable_module))
        same = loss == losses[1] and all(np.array_equal(mine[k], final[k]) for k in final)
        if not same:
            worst = max(float(np.abs(mine[k] - final[k]).max()) for k in final)
            raise AssertionError(f"resume from the {backend} checkpoint: loss {loss} vs {losses[1]}, "
                                 f"parameters up to {worst:.3g} apart")
        print(f"[pretrained] resume from the {backend} checkpoint ({'a directory' if path.is_dir() else 'a file'}"
              f"): the next epoch's loss and trained parameters bit-equal to the uninterrupted run", flush=True)
        del resumed
    finetuned = export_jax_params(run.trainable_module)
    # The fine-tuned model as the trainer holds it: affine fold, frozen weights stored in
    # bf16 (bf16 GEMMs with an fp32 result), bf16 compute.
    art = root / "export" / "finetuned_c512_bf16_stored"
    export_program(run.eval_model, HORIZON, 512, art, multimodal=True)
    serve, _ = load_program(art, device="cuda")
    data = make_samples(512, 128, seed + 13)
    context = np.stack([d["context"] for d in data])
    text = np.stack([d["text_embeddings"] for d in data])
    ref = Forecaster(run.eval_model, batch_size=64, device="cuda").forecast(HORIZON, context, text_embeddings=text)
    before = launch_counts()
    out = serve_padded(serve, context, text, 64)
    seen = expect_launches("fine-tuned artifact", before, {"B1f": 20 * 2})
    print(f"[export] the fine-tuned TimesFM as its trainer holds it (affine fold, frozen weights in bf16), "
          f"context 512: {compare_export('fine-tuned artifact', out, ref, torch.bfloat16)} | launches {seen}",
          flush=True)
    del run
    torch.cuda.empty_cache()

    # 3. exported artifacts, served from their files
    artifacts = {}
    for name, ctx, dtype, traced_on in EXPORTS:
        cls, _ = specs[name]
        label = f"{name} context {ctx} {str(dtype)[6:]}, exported on the {'card' if traced_on == 'cuda' else 'CPU'}"
        decoder = with_dtype(decoders[name], dtype)
        source = decoder if traced_on == "cuda" else copy.deepcopy(decoder).to("cpu")
        art = root / "export" / f"{name}_c{ctx}_{str(dtype)[6:]}_{traced_on}"
        start = time.perf_counter()
        export_program(source, HORIZON, ctx, art, multimodal=True)
        exported = time.perf_counter() - start
        start = time.perf_counter()
        serve, manifest = load_program(art, device="cuda")
        loaded = time.perf_counter() - start
        patch = decoder.adapter.patch_len
        data = make_samples(ctx, 192, seed + ctx, patch=patch)
        context = np.stack([d["context"] for d in data])
        text = np.stack([d["text_embeddings"] for d in data])
        fc = Forecaster(decoder, batch_size=64, device="cuda")
        ref = fc.forecast(HORIZON, context, text_embeddings=text)
        serve_padded(serve, context[:64], text[:64], 64)  # warm-up
        torch.cuda.synchronize()
        key, per = ("B4f", 16) if cls is Chronos2Adapter else ("B1f", 20)
        rates, fc_rates, outs = [], [], []
        for _ in range(SERVE_REPEATS):  # the artifact and Forecaster in turn, same data
            before = launch_counts()
            start_call = time.perf_counter()
            outs.append(serve_padded(serve, context, text, 64))
            rates.append(len(context) / (time.perf_counter() - start_call))
            seen = expect_launches(label, before, {key: per * 3})
            start_call = time.perf_counter()
            fc.forecast(HORIZON, context, text_embeddings=text)
            fc_rates.append(len(context) / (time.perf_counter() - start_call))
        if not all(np.array_equal(o, outs[0]) for o in outs):
            raise AssertionError(f"{label}: forecasts differ between calls")
        verdict = compare_export(label, outs[0], ref, dtype)
        wall, kernels = device_profile(lambda: serve_padded(serve, context, text, 64))
        busy = sum(ms for _, ms in kernels)
        sizes = {f: (art / f).stat().st_size / 1e6 for f in ("program.pt2", "params.npz")}
        print(f"[export] {label}: export {exported:.1f} s (program.pt2 {sizes['program.pt2']:.2f} MB, "
              f"params.npz {sizes['params.npz']:.1f} MB), load_program {loaded:.1f} s | served 192 series "
              f"in batches of 64, median of {SERVE_REPEATS} calls {float(np.median(rates)):.1f} series/s "
              f"({', '.join(f'{r:.1f}' for r in rates)}), Forecaster in turn {float(np.median(fc_rates)):.1f} "
              f"({', '.join(f'{r:.1f}' for r in fc_rates)}) on {kind} | profiled call: wall {wall:.3f} ms, "
              f"busy {busy:.3f} ms, idle {1 - busy / wall:.3f} | launches {seen} per call ({per} per batch) | "
              f"{verdict}", flush=True)
        artifacts[(name, ctx, dtype, traced_on)] = (art, context, text)

    # 4. re-point the c512 fp32 artifact at the fine-tuned fusion weights
    art, context, text = artifacts[("timesfm-2.5-200m", 512, torch.float32, "cpu")]
    old = serve_padded(load_program(art, device="cuda")[0], context, text, 64)
    load_jax_params(timesfm.fusion, finetuned)
    save_program_params(art, timesfm)
    new = serve_padded(load_program(art, device="cuda")[0], context, text, 64)
    ref = Forecaster(timesfm, batch_size=64, device="cuda").forecast(HORIZON, context, text_embeddings=text)
    if np.array_equal(new, old) or list(art.glob("*.tmp")):
        raise AssertionError("re-pointed artifact: forecasts did not follow the new weights")
    print(f"[export] re-pointed TimesFM context 512 fp32 at the fine-tuned fusion weights "
          f"(save_program_params): {compare_export('re-pointed', new, ref, torch.float32)}; "
          f"max |new - old| {float(np.abs(new - old).max()):.4g}", flush=True)

    # 5. the repaired gates: no plain attention on the card
    plain = layers.plain_causal_attention

    def no_plain(*a):
        raise AssertionError("plain_causal_attention ran on the card")

    layers.plain_causal_attention = no_plain
    try:
        for ctx, (n, batch) in GATE_CONTEXTS.items():
            data = make_samples(ctx, n, seed + ctx)
            fc = Forecaster(timesfm, batch_size=batch, device="cuda")
            fc.forecast_dataset(HORIZON, data[:batch])  # warm-up: the first call at a length
            torch.cuda.synchronize()
            before = launch_counts()
            start = time.perf_counter()
            out = fc.forecast_dataset(HORIZON, data, denormalize=True)
            rate = n / (time.perf_counter() - start)
            if out.shape != (n, HORIZON) or not np.isfinite(out).all():
                raise AssertionError(f"context {ctx}: bad forecasts")
            seen = expect_launches(f"gate context {ctx}", before, {"B2f": 20 * -(-n // batch)})
            print(f"[gates] TimesFM context {ctx} ({ctx // 32} tokens) fp32, {n} series in batches of {batch}: "
                  f"{rate:.1f} series/s (one call after a warm-up) on {kind} | launches {seen}", flush=True)
        ctx, batch = GATE_TRAIN
        data = make_samples(ctx, batch, seed + 3, TRAIN_HORIZON)
        args = TrainingArguments(
            output_dir=str(root / "gate_train"), per_device_train_batch_size=batch,
            per_device_eval_batch_size=batch,
            num_train_epochs=1, learning_rate=TRAIN_LR, eval_strategy="epoch", save_strategy="no",
            logging_strategy="no", seed=seed)
        gate_trainer = MultimodalTrainer(timesfm, args, data, data, "multimodal", device="cuda")
        before = launch_counts()
        loss = gate_trainer.train_epoch()
        seen = expect_launches(f"gate context {ctx} training", before, {"B2f": 20, "B2b": 20})
        if not np.isfinite(loss):
            raise AssertionError(f"context {ctx} training: loss {loss}")
        print(f"[gates] TimesFM context {ctx} ({ctx // 32} tokens) multimodal fp32, one step of {batch} series: loss "
              f"{loss:.5f} | launches {seen}", flush=True)
        del gate_trainer
    finally:
        layers.plain_causal_attention = plain

    # 6. the forecast CLI, autoregressive at horizon 512 (4 rounds of 128 at context 512)
    cache = root / "cache" / "time_mmd_Synthetic_english_p32_c512_h512.pkl"
    cache.parent.mkdir()
    samples = make_samples(512, 128, seed + 21, horizon=512)
    cache.write_bytes(pickle.dumps(samples))
    (root / "model.json").write_text(json.dumps({"adapter": {"type": "timesfm", "patch_len": 32},
                                                 "fusion": {"text_embedding_dims": 384}}))
    made = []

    class Recorded(Forecaster):
        def forecast_dataset(self, *a, **kw):
            made.append(self)
            start_call = time.perf_counter()
            out = super().forecast_dataset(*a, **kw)
            self.seconds = time.perf_counter() - start_call
            return out

    flags = ["--cache-file", str(cache), "--model-config", str(root / "model.json"), "--horizon", "512",
             "--pretrained-dir", str(root / "timesfm-2.5-200m"), "--checkpoint", str(pickle_ckpt),
             "--multimodal", "--denormalize", "--autoregressive", "--batch-size", "64"]
    forecast_cli.Forecaster = Recorded
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # text fuses into the first window only, as in JAX
            before = launch_counts()
            if forecast_cli.main([*flags, "--output", str(root / "forecasts.npz")]) != 0:
                raise AssertionError("forecast CLI failed")
            graphs = made[-1]
            first_rate = len(samples) / graphs.seconds
            again = graphs.forecast_dataset(512, samples, multimodal=True, denormalize=True, autoregressive=True)
            replay_rate = len(samples) / graphs.seconds
            # another context on the same Forecaster: a graph of its own, then its replay
            short = make_samples(256, 64, seed + 22, horizon=512)
            held = graphs.graph_captures
            short_got = [graphs.forecast_dataset(512, short, multimodal=True, denormalize=True,
                                                 autoregressive=True) for _ in range(2)]
            if graphs.graph_captures != held + 1:
                raise AssertionError(f"forecast CLI: context 256 made {graphs.graph_captures - held} decode graphs")
            captures, replays = graphs.graph_captures, graphs.graph_replays
            GRAPH_LAUNCHES["B1f"] = GRAPH_LAUNCHES.get("B1f", 0) + 20 * 4 * (replays - captures)
            loop = Forecaster(graphs.model, batch_size=64, device="cuda")  # the CLI's decoder
            loop._use_graphs = False
            loop.forecast_dataset(512, samples[:64], multimodal=True, denormalize=True, autoregressive=True)
            torch.cuda.synchronize()
            start = time.perf_counter()
            want = loop.forecast_dataset(512, samples, multimodal=True, denormalize=True, autoregressive=True)
            loop_rate = len(samples) / (time.perf_counter() - start)
            short_want = loop.forecast_dataset(512, short, multimodal=True, denormalize=True, autoregressive=True)
    finally:
        forecast_cli.Forecaster = Forecaster
    got = np.load(root / "forecasts.npz")
    if got["forecasts"].shape != (128, 512) or not np.array_equal(got["forecasts"], want):
        raise AssertionError("forecast CLI: the decode graph differs from the eager loop")
    if not np.array_equal(again, want):
        raise AssertionError("forecast CLI: a second call's replays differ from the eager loop")
    if not all(np.array_equal(x, short_want) for x in short_got):
        raise AssertionError("forecast CLI: the decode graph at context 256 differs from the eager loop")
    seen = {k: v - before[k] for k, v in launch_counts().items() if v - before[k]}
    print(f"[cli] python -m multimodal_timesfm_torch.forecast --autoregressive --horizon 512 (4 rounds at "
          f"context 512, snapshot + port checkpoint), 128 series in batches of 64: decode graphs "
          f"{captures} captured, {replays} replays over two calls and two at context 256 (a graph of "
          f"its own, bit-equal to the eager loop too); forecast_dataset {first_rate:.1f} series/s "
          f"in the CLI (capture included), {replay_rate:.1f} on a second call (replays only), the eager "
          f"loop {loop_rate:.1f} (after a warm-up) on {kind}; forecasts bit-equal to the eager loop on the "
          f"card | counted launches {seen} "
          f"(+{20 * 4 * (replays - captures)} B1f from replays)", flush=True)
    shutil.rmtree(root / "export", ignore_errors=True)
    # The sweep slice's modules too (phase 10 drives them): importing them pulls in
    # nothing of these either.
    import multimodal_timesfm_torch.time_mmd.split  # noqa: F401
    import multimodal_timesfm_torch.time_mmd.sweep_lib  # noqa: F401
    import multimodal_timesfm_torch.training.vectorized  # noqa: F401
    import multimodal_timesfm_torch.tune  # noqa: F401
    import multimodal_timesfm_torch.tune_baseline  # noqa: F401
    import multimodal_timesfm_torch.utils.tracking  # noqa: F401

    imported = sorted(m for m in ("jax", "multimodal_timesfm_tpu", "examples", "safetensors", "transformers")
                      if m in sys.modules)
    if imported:
        raise AssertionError(f"the pretrained-to-served and sweep paths imported {imported}")


# --- phase 12: the AOTInductor package -----------------------------------------

# A package against Forecaster on the same weights, on the card: max |diff| <= TOL x std of
# Forecaster's forecasts. Inductor fuses and reorders the elementwise work, so the two are
# not bit-equal. TimesFM fp32: summation order only (1e-4); TimesFM bf16: roundings in
# another order carried through 20 layers (0.15). Chronos-2 bf16: 0.2, phase 11's bf16
# forecast limit: through 16 layers of random weights a reordering alone moves bf16
# forecasts by up to 0.15 x std (a batch of 32 against 64, or the mesh), bf16 against fp32
# by 0.27. Each bf16 cell also prints that control: Forecaster in bf16 against Forecaster in
# fp32 on the same weights.
AOTI_TOL = {("timesfm-2.5-200m", torch.float32): 1e-4, ("timesfm-2.5-200m", torch.bfloat16): 0.15,
            ("chronos-2-120m", torch.bfloat16): 0.2}
AOTI_CONTEXT = 512  # 192 series in batches of 64, horizon 128
# Both at full depth: a package's compile time is mostly the compiling process's own start
# (Chronos-2's took 159.3 s at 16 layers and 162.0 s at 4, beside TimesFM-2.5's two).
AOTI_LAYERS = {"timesfm-2.5-200m": 20, "chronos-2-120m": 16}


def openmp_cxx() -> str:
    """The first of ``$CXX``, ``g++`` and ``c++`` that links a program with ``-fopenmp``:
    Inductor links a package's C++ wrapper with it. A GCC installed without its
    ``libgomp.spec`` compiles but cannot link it."""
    candidates = [c for c in (os.environ.get("CXX"), "g++", "c++") if c]
    with tempfile.TemporaryDirectory() as d:
        source = Path(d) / "omp.cc"
        source.write_text("int main() { return 0; }\n")
        for cxx in candidates:
            try:
                done = subprocess.run([cxx, "-fopenmp", str(source), "-o", str(Path(d) / "omp")],
                                      capture_output=True, text=True, timeout=120)
            except FileNotFoundError:
                continue
            if done.returncode == 0:
                return cxx
            print(f"[aoti] {cxx} does not link -fopenmp: {done.stderr.strip()[-200:]}", flush=True)
    raise AssertionError(f"no C++ compiler among {candidates} links -fopenmp, which AOTInductor needs")


def _served_decoder(name: str, dtype: torch.dtype, device: str = "cuda"):
    from multimodal_timesfm_torch.models.chronos import Chronos2Adapter, Chronos2Config
    from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
    from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig

    cls, cfg = {"timesfm-2.5-200m": (TimesFM2p5Adapter, TimesFMConfig()),
                "chronos-2-120m": (Chronos2Adapter, Chronos2Config())}[name]
    cfg = dataclasses.replace(cfg, compute_dtype=dtype, num_layers=AOTI_LAYERS[name])
    dec_cfg = MultimodalDecoderConfig(text_embedding_dims=384, num_fusion_layers=1)
    return MultimodalDecoder(cls(cfg), dec_cfg, device=device)


def compile_package(name: str, dtype: str, out: str) -> None:
    """A child process of phase 12: the package of ``name`` in ``dtype`` at AOTI_CONTEXT,
    compiled on the card from a decoder of that geometry with its initial weights (a
    package holds no weights; the parent re-points it); prints its compile seconds."""
    from multimodal_timesfm_torch.serving import export_program

    decoder = _served_decoder(name, getattr(torch, dtype))
    start = time.perf_counter()
    export_program(decoder, HORIZON, AOTI_CONTEXT, out, multimodal=True, format="aoti")
    print(json.dumps({"compile_s": time.perf_counter() - start}), flush=True)


def aoti_phase(seed: int) -> None:
    """TimesFM-2.5 200M (fp32, bf16) and Chronos-2 120M (bf16) at full width and depth as
    AOTInductor packages at context 512: the three compiled on the card at once, each in a
    child process of its own from the geometry alone, then re-pointed
    (``save_program_params``) at weights drawn from ``seed``; beside each, the same
    decoder's ``torch.export`` program. Served from their files with ``load_program``:
    load seconds; series/s of the package, ``Forecaster`` and the program in turn on the
    same 192 series; B1f or B4f launches, one per layer and batch, through the package; the
    package bit-equal between calls and between two loads, and within AOTI_TOL of
    Forecaster; one profiled package call's idle share (``utils.profiling``)."""
    from multimodal_timesfm_torch.inference import Forecaster
    from multimodal_timesfm_torch.models.bridge import load_jax_params, random_jax_params
    from multimodal_timesfm_torch.serving import export_program, load_program, save_program_params
    from multimodal_timesfm_torch.utils import profiling

    kind = torch.cuda.get_device_name(0)
    cxx = openmp_cxx()
    print(f"[aoti] Inductor's host C++ compiler: {cxx}", flush=True)
    root = Path(__file__).resolve().parent / "build" / "aoti"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ctx = AOTI_CONTEXT
    cells = {cell: root / f"{cell[0]}_{str(cell[1])[6:]}" for cell in AOTI_TOL}
    env = {**os.environ, "CXX": cxx, "TORCHINDUCTOR_COMPILE_THREADS": "3"}
    start = time.perf_counter()
    children = {cell: subprocess.Popen(
        [sys.executable, __file__, "--compile-package", cell[0], str(cell[1])[6:], str(path / "aoti")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env) for cell, path in cells.items()}
    try:
        # Meanwhile: the weights, the data, Forecaster's forecasts and the programs.
        trees, fp32_refs, setup = {}, {}, {}
        for name, dtype in cells:
            decoder = _served_decoder(name, dtype, device="cpu")
            if name not in trees:
                trees[name] = random_jax_params(decoder, seed)
            load_jax_params(decoder, trees[name])
            decoder = decoder.cuda()
            data = make_samples(ctx, 192, seed + ctx, patch=decoder.adapter.patch_len)
            context = np.stack([d["context"] for d in data])
            text = np.stack([d["text_embeddings"] for d in data])
            fc = Forecaster(decoder, batch_size=64, device="cuda")
            ref = fc.forecast(HORIZON, context, text_embeddings=text)
            if name not in fp32_refs:
                fp32 = ref if dtype == torch.float32 else None
                if fp32 is None:
                    fp32_decoder = _served_decoder(name, torch.float32, device="cpu")
                    load_jax_params(fp32_decoder, trees[name])
                    fp32 = Forecaster(fp32_decoder.cuda(), batch_size=64, device="cuda").forecast(
                        HORIZON, context, text_embeddings=text)
                    del fp32_decoder
                fp32_refs[name] = fp32
            export_program(decoder, HORIZON, ctx, cells[(name, dtype)] / "program", multimodal=True)
            setup[(name, dtype)] = (decoder, fc, context, text, ref)
        compiled = {}
        for cell, child in children.items():
            out, err = child.communicate(timeout=900)
            if child.returncode != 0:
                raise AssertionError(f"compiling the {cell} package failed:\n{err[-3000:]}")
            compiled[cell] = json.loads(out.strip().splitlines()[-1])["compile_s"]
    finally:
        for child in children.values():
            if child.poll() is None:
                child.kill()
                child.wait()
    wall_s = time.perf_counter() - start
    print(f"[aoti] three packages compiled at once on the card, one child process each (Inductor's "
          f"compile workers 3 a child): {', '.join(f'{n} {str(d)[6:]} {s:.1f} s' for (n, d), s in compiled.items())}"
          f"; {wall_s:.1f} s from their start to the last, the parent's setup alongside", flush=True)

    for (name, dtype), path in cells.items():
        decoder, fc, context, text, ref = setup.pop((name, dtype))
        label = f"{name} ({AOTI_LAYERS[name]} layers) context {ctx} {str(dtype)[6:]}"
        save_program_params(path / "aoti", decoder)
        start = time.perf_counter()
        package, manifest = load_program(path / "aoti", device="cuda")
        load_s = time.perf_counter() - start
        if manifest["format"] != "aoti" or manifest["platforms"] != ["cuda"]:
            raise AssertionError(f"{label}: manifest {manifest['format']}, {manifest['platforms']}")
        program, _ = load_program(path / "program", device="cuda")
        for serve in (package, program):  # warm-up
            serve_padded(serve, context[:64], text[:64], 64)
        torch.cuda.synchronize()
        key, per = ("B4f" if name.startswith("chronos") else "B1f"), AOTI_LAYERS[name]
        rates: dict[str, list[float]] = {"package": [], "Forecaster": [], "program": []}
        outs = []
        for _ in range(SERVE_REPEATS):  # in turn, on the same data
            before = launch_counts()
            start = time.perf_counter()
            outs.append(serve_padded(package, context, text, 64))
            rates["package"].append(len(context) / (time.perf_counter() - start))
            seen = expect_launches(f"{label} package", before, {key: per * 3})
            start = time.perf_counter()
            fc.forecast(HORIZON, context, text_embeddings=text)
            rates["Forecaster"].append(len(context) / (time.perf_counter() - start))
            start = time.perf_counter()
            serve_padded(program, context, text, 64)
            rates["program"].append(len(context) / (time.perf_counter() - start))
        again = serve_padded(load_program(path / "aoti", device="cuda")[0], context, text, 64)
        if not all(np.array_equal(o, outs[0]) for o in (*outs, again)):
            raise AssertionError(f"{label}: the package's forecasts differ between calls or loads")
        if outs[0].shape != ref.shape or not np.isfinite(outs[0]).all():
            raise AssertionError(f"{label}: bad forecasts, shape {outs[0].shape}")
        std = float(ref.std())
        diff = np.abs(outs[0] - ref) / std
        limit = AOTI_TOL[(name, dtype)]
        if not diff.max() <= limit:
            raise AssertionError(f"{label}: package and Forecaster differ by {diff.max():.4g} x std > {limit}")
        control = np.abs(ref - fp32_refs[name]) / std
        with tempfile.TemporaryDirectory() as log_dir:
            with profiling.trace(log_dir, host=False):
                start = time.perf_counter()
                serve_padded(package, context, text, 64)
                wall = (time.perf_counter() - start) * 1e3
            summary = profiling.summarize_trace(log_dir, top=4)
        busy = summary["device_busy_ms"]
        top = ", ".join(f"{k[:70]} {ms:.3f} ms" for k, ms, _ in summary["top_ops"])
        size = (path / "aoti" / "package.pt2").stat().st_size / 1e6
        median = {k: float(np.median(v)) for k, v in rates.items()}
        print(
            f"[aoti] {label}: package compiled in {compiled[(name, dtype)]:.1f} s (package.pt2 {size:.2f} MB; "
            f"re-pointed at the seed's weights in params.npz), loaded in {load_s:.2f} s | 192 series in "
            f"batches of 64, median of {SERVE_REPEATS} calls in turn: package {median['package']:.1f} series/s "
            f"({', '.join(f'{r:.1f}' for r in rates['package'])}), Forecaster {median['Forecaster']:.1f} "
            f"({', '.join(f'{r:.1f}' for r in rates['Forecaster'])}), program {median['program']:.1f} "
            f"({', '.join(f'{r:.1f}' for r in rates['program'])}) on {kind} | profiled package call: wall "
            f"{wall:.3f} ms, busy {busy:.3f} ms, idle {1 - busy / wall:.3f} | {top} | launches {seen} per "
            f"call ({per} per batch) | |package - Forecaster| / std: max {diff.max():.4g} <= {limit}, median "
            f"{float(np.median(diff)):.3g}; control, Forecaster against its fp32 twin: max "
            f"{control.max():.4g}, median {float(np.median(control)):.3g} | bit-equal between calls and loads",
            flush=True,
        )
        del decoder, fc, package, program
        torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    imported = sorted(m for m in ("jax", "multimodal_timesfm_tpu", "bench", "orbax") if m in sys.modules)
    if imported:
        raise AssertionError(f"the AOTI phase imported {imported}")

def serving_times(seed: int, repeats: int = 7) -> None:
    """TimesFM-2.5 200M served through Forecaster at context 512 (200 series in batches of
    64, multimodal, horizon 128), fp32 and bf16: the median series/s of ``repeats`` calls
    after a warm-up, with the port imported from ``--root`` when given. The serving path is
    host-bound, so this reads the cost of the attention entry points' dispatch."""
    from multimodal_timesfm_torch.inference import Forecaster
    from multimodal_timesfm_torch.models.bridge import load_jax_params, random_jax_params
    from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
    from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig

    dec_cfg = MultimodalDecoderConfig(text_embedding_dims=384, num_fusion_layers=1)
    tree = random_jax_params(MultimodalDecoder(TimesFM2p5Adapter(), dec_cfg, device="cpu"), seed)
    data = make_samples(512, 200, seed)
    for dtype in (torch.float32, torch.bfloat16):
        decoder = MultimodalDecoder(
            TimesFM2p5Adapter(dataclasses.replace(TimesFMConfig(), compute_dtype=dtype)), dec_cfg, device="cuda")
        load_jax_params(decoder, tree)
        fc = Forecaster(decoder, batch_size=64, device="cuda")
        fc.forecast_dataset(HORIZON, data, denormalize=True)
        rates = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            start = time.perf_counter()
            fc.forecast_dataset(HORIZON, data, denormalize=True)
            rates.append(len(data) / (time.perf_counter() - start))
        print(f"[serving-times] context 512 {str(dtype)[6:]}: median of {repeats} calls "
              f"{float(np.median(rates)):.1f} series/s ({', '.join(f'{r:.1f}' for r in rates)})", flush=True)


def training_times(seed: int, epochs: int = 7) -> None:
    """The eager ``chronos_mm_h32`` bf16 cell of the Chronos training phase (batch 128, 3
    steps an epoch, context 32, horizon 32, frozen encoder stored in bf16): train series/s
    of ``epochs`` epochs after two of warm-up, with the port imported from ``--root`` when
    given. The per-epoch loop is host-bound (the chronos training phase's profile shows
    the card idle most of an epoch), so this reads the
    dispatch cost of the Chronos attention entry points with grad."""
    from multimodal_timesfm_torch.models.bridge import load_jax_params, random_jax_params
    from multimodal_timesfm_torch.models.chronos import Chronos2Adapter, Chronos2Config
    from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
    from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
    from multimodal_timesfm_torch.training_args import TrainingArguments

    cfg = Chronos2Config()
    dec_cfg = MultimodalDecoderConfig(text_embedding_dims=384, num_fusion_layers=1)
    tree = random_jax_params(MultimodalDecoder(Chronos2Adapter(cfg), dec_cfg, device="cpu"), seed)
    decoder = MultimodalDecoder(
        Chronos2Adapter(dataclasses.replace(cfg, compute_dtype=torch.bfloat16)), dec_cfg, device="cuda")
    load_jax_params(decoder, tree)
    batch, steps = 128, 3
    train = make_samples(32, steps * batch, seed, CHRONOS_HORIZON, patch=16)
    val = make_samples(32, batch, seed + 1, CHRONOS_HORIZON, patch=16)
    with tempfile.TemporaryDirectory() as workdir:
        args = TrainingArguments(
            output_dir=workdir, per_device_train_batch_size=batch, per_device_eval_batch_size=batch,
            num_train_epochs=3, learning_rate=TRAIN_LR, weight_decay=0.01, eval_strategy="epoch",
            save_strategy="no", logging_strategy="no", seed=seed)
        trainer = MultimodalTrainer(decoder, args, train, val, "multimodal", device="cuda",
                                    frozen_cast_dtype=torch.bfloat16)
        rates = []
        for epoch in range(epochs + 2):
            loss = trainer.train_epoch()
            if not np.isfinite(loss):
                raise AssertionError(f"training-times: loss {loss}")
            if epoch >= 2:
                rates.append(trainer.last_throughput)
    print(f"[training-times] chronos_mm_h32 multimodal bfloat16, batch {batch}, {steps} steps an epoch: "
          f"median of {epochs} epochs {float(np.median(rates)):.1f} train series/s "
          f"({', '.join(f'{r:.1f}' for r in rates)})", flush=True)


def dispatch_times(calls: int = 2000, repeats: int = 7) -> None:
    """The host's time for one call of the fused-qkv attention entry point (B1f, and B1b
    with the backward) at a shape whose kernels take a few microseconds ((B,S,H,D)
    (1,8,1,8), fp32): the ``torch.library`` custom op the port calls against an
    ``autograd.Function`` around the same launches (the form the entry points had before
    they were ops), in inference, in a forward with grad, and a forward and backward. Each
    figure is the median over ``repeats`` rounds of ``calls`` calls without a
    synchronisation, the two forms alternating."""
    from multimodal_timesfm_torch.ops import qkv_attention as qa

    class Launch(torch.autograd.Function):
        @staticmethod
        def forward(ctx, qkv, key_valid, heads, dim):
            ctx.save_for_backward(qkv, key_valid)
            ctx.heads, ctx.dim = heads, dim
            return qa._forward(qkv, key_valid, heads, dim)

        @staticmethod
        def backward(ctx, g):
            qkv, key_valid = ctx.saved_tensors
            return qa.fused_qkv_causal_attention_bwd(qkv, key_valid, g, ctx.heads, ctx.dim), None, None, None

    heads, dim = 1, 8
    gen = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(1, 8, 3 * heads * dim, generator=gen, device="cuda")
    valid = torch.ones(1, 8, dtype=torch.bool, device="cuda")
    g = torch.randn(1, 8, heads * dim, generator=gen, device="cuda")
    forms = {"custom op": qa.fused_qkv_causal_attention, "autograd.Function": Launch.apply}
    if not torch.equal(forms["custom op"](qkv, valid, heads, dim), forms["autograd.Function"](qkv, valid, heads, dim)):
        raise AssertionError("dispatch-times: the two forms disagree")
    leaf = qkv.clone().requires_grad_()

    def inference(fn):
        with torch.no_grad():
            fn(qkv, valid, heads, dim)

    def forward_grad(fn):
        fn(leaf, valid, heads, dim)

    def forward_backward(fn):
        fn(leaf, valid, heads, dim).backward(g)

    for mode, step in (("inference", inference), ("forward with grad", forward_grad),
                       ("forward and backward", forward_backward)):
        per_call = {name: [] for name in forms}
        for _ in range(repeats):
            for name, fn in forms.items():
                step(fn)
                torch.cuda.synchronize()
                start = time.perf_counter()
                for _ in range(calls):
                    step(fn)
                torch.cuda.synchronize()
                per_call[name].append((time.perf_counter() - start) / calls * 1e6)
        us = {name: float(np.median(v)) for name, v in per_call.items()}
        print(f"[dispatch-times] B1 (B,S,H,D) (1,8,1,8) fp32, {mode}: custom op {us['custom op']:.2f} us a call, "
              f"autograd.Function {us['autograd.Function']:.2f} us, difference "
              f"{us['custom op'] - us['autograd.Function']:.2f} us (median of {repeats} rounds of {calls} calls)",
              flush=True)


# Phase 10, sweeps: the vmap rules against per-trial launches (before the main paths),
# then the tuning workflow and the vectorized trials on the card.
# Vectorized against sequential trials of the same configs (the tune CLI, fp32, 8 trials):
# |vec - seq| <= SWEEP_RTOL x |seq| on val/best_loss and test/mse. The trial axis changes
# only the GEMMs' row counts (T x B rows against B), so the sums run in another order;
# the trajectory ceiling of the repo's parity tests (losses rtol 2e-3) bounds what Adam
# makes of that over two epochs.
SWEEP_RTOL = 2e-3
# Shapes of the vmap-rule checks: (label, trials, batch rows per trial, S) on the main
# paths of phase 10 (B1 at the context-512 group's 4 x 32 rows; B4 at the Chronos group's
# 4 x 128 rows of chronos_mm_h32, its bias shared, and a bias per trial as a baseline
# Chronos sweep trains it) and the lengths B2 and B3 serve (B2 at 40 tokens, B3 past 2,048).
VMAP_CAUSAL_SHAPES = (("B1", 4, 32, 16), ("B2", 2, 8, 40), ("B3", 2, 1, 2100))
VMAP_CHRONOS_SHAPES = ((4, 128, 67, False), (2, 8, 67, True))
SWEEP_FOLD = ("Agriculture", "Economy", "Environment", "Health_US", "Traffic")


def vmap_rule_checks(seed: int) -> None:
    """Each custom op's vmap rule (one launch over the trial axis folded into the batch
    rows) against a loop of per-trial launches on the card, forward and backward, fp32 and
    bf16: outputs and input gradients bit-equal (every kernel's rows are independent); a
    bias shared by the trials gets one dbias sum over all rows, held to 1e-5 relative of
    the per-trial sums. The vmapped output and gradients are also held against the plain
    version on the folded rows: the output within KERNEL_TOL, the gradients (dbias
    included) within BWD_TOL."""
    from torch.func import vmap

    from multimodal_timesfm_torch.ops.attention import (
        flash_causal_attention,
        fused_causal_attention,
        plain_attention_bwd,
        plain_causal_attention,
    )
    from multimodal_timesfm_torch.ops.chronos_attention import (
        fused_chronos_attention,
        plain_chronos_attention,
        plain_chronos_attention_bwd,
    )
    from multimodal_timesfm_torch.ops.qkv_attention import (
        fused_qkv_causal_attention,
        plain_qkv_attention_bwd,
        plain_qkv_causal_attention,
        split_heads,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def check(label, fn, plain, args, in_dims, grad_idx, shared_grad=None):
        """``plain(args, g)`` gives the plain output and the gradients of ``grad_idx`` for
        the cotangent ``g`` of the vmapped output, on the same (T, ...) layout."""
        trials = args[0].shape[0]
        before = launch_counts()
        out = vmap(fn, in_dims=in_dims)(*args)
        grads = torch.autograd.grad(out.float().square().sum(), [args[i] for i in grad_idx])
        folded = {k: v - before[k] for k, v in launch_counts().items() if v - before[k]}
        refs = [fn(*[a if d is None else a[t] for a, d in zip(args, in_dims)]) for t in range(trials)]
        ref_grads = torch.autograd.grad(sum(r.float().square().sum() for r in refs), [args[i] for i in grad_idx])
        same = torch.equal(out, torch.stack(refs)) and all(
            torch.equal(g, r) for i, (g, r) in enumerate(zip(grads, ref_grads)) if i != shared_grad)
        note = ""
        if shared_grad is not None:
            g, r = grads[shared_grad], ref_grads[shared_grad]
            rel = float((g - r).abs().max() / r.abs().max())
            note = f", shared dbias {rel:.2g} of max (tol 1e-5)"
            same = same and rel <= 1e-5
        plain_out, plain_grads = plain([a.detach() for a in args], (2 * out.detach().float()).to(out.dtype))
        err_f = compare(f"vmap {label}", out, plain_out)
        err_b = compare_bwd(f"vmap {label} backward", tuple(grads), tuple(plain_grads))
        print(f"[vmap] {label}: {trials} trials, vmapped launches {folded} against {trials} per-trial "
              f"launches each way: forward and gradients bit-equal {same}{note}; against plain on the "
              f"folded rows: forward {err_f:.3g}, gradients {err_b:.3g}", flush=True)
        if not same:
            raise AssertionError(f"vmap rule {label}: disagrees with per-trial launches")

    def folded(x):
        return x.reshape(-1, *x.shape[2:])

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for key, trials, batch, seq in VMAP_CAUSAL_SHAPES:
            # q and k scaled by D^-1/4 each: logits of O(1), as the kernels see them.
            qkv = (torch.randn(trials, batch, seq, 3 * 16 * 80, device="cuda", generator=gen) / 80 ** 0.25).to(dtype)
            qkv.requires_grad_()
            valid = torch.rand(trials, batch, seq, device="cuda", generator=gen) > 0.2
            valid[..., 0] = True
            if key == "B1":
                def fn(x, m):
                    return fused_qkv_causal_attention(x, m, 16, 80)

                def plain(args, g):
                    x, m = (folded(a) for a in args)
                    return (plain_qkv_causal_attention(x, m, 16, 80).view_as(g),
                            (plain_qkv_attention_bwd(x, m, folded(g), 16, 80).view_as(args[0]),))
            else:
                entry = fused_causal_attention if key == "B2" else flash_causal_attention

                def fn(x, m, entry=entry):
                    return entry(*split_heads(x, 16, 80), m)

                def plain(args, g):
                    q, k, v = split_heads(folded(args[0]), 16, 80)
                    m = folded(args[1])
                    dq, dk, dv = plain_attention_bwd(q, k, v, m, folded(g))
                    dqkv = torch.cat([d.flatten(-2) for d in (dq, dk, dv)], dim=-1)
                    return plain_causal_attention(q, k, v, m).view_as(g), (dqkv.view_as(args[0]),)
            check(f"{key} ({trials} x {batch}, {seq}, 16, 80) {name}", fn, plain, (qkv, valid), (0, 0), (0,))
        for trials, batch, seq, per_trial in VMAP_CHRONOS_SHAPES:
            qkv = (torch.randn(trials, batch, seq, 3 * 12 * 64, device="cuda", generator=gen) / 64 ** 0.25).to(dtype)
            qkv.requires_grad_()
            seg = torch.zeros(trials, batch, seq, dtype=torch.int32, device="cuda")
            seg[:, ::2, seq - 5:] = -1 - torch.arange(5, dtype=torch.int32, device="cuda")  # padded tokens
            bias = torch.randn(*((trials,) if per_trial else ()), 12, seq, seq, device="cuda", generator=gen)
            bias.requires_grad_()

            def plain(args, g, per_trial=per_trial):
                qkv, seg, bias = args
                if per_trial:
                    parts = [(plain_chronos_attention(qkv[t], seg[t], bias[t]),
                              plain_chronos_attention_bwd(qkv[t], seg[t], bias[t], g[t], True))
                             for t in range(qkv.shape[0])]
                    return (torch.stack([o for o, _ in parts]),
                            tuple(torch.stack([d[i] for _, d in parts]) for i in range(2)))
                out = plain_chronos_attention(folded(qkv), folded(seg), bias)
                dqkv, dbias = plain_chronos_attention_bwd(folded(qkv), folded(seg), bias, folded(g), True)
                return out.view_as(g), (dqkv.view_as(qkv), dbias)

            check(f"B4 ({trials} x {batch}, {seq}, 12, 64) {name}, bias "
                    f"{'per trial (one launch per trial)' if per_trial else 'shared'}",
                    fused_chronos_attention, plain, (qkv, seg, bias), (0, 0, 0 if per_trial else None), (0, 2),
                    shared_grad=None if per_trial else 1)


def _timesfm_decoder(seed: int, dtype: torch.dtype, fusion_layers: int = 1, hidden: tuple = (),
                     adapter=None):
    """A TimesFM-2.5 200M decoder on the card, weights from ``seed`` (the adapter given is
    shared as it is)."""
    from multimodal_timesfm_torch.models.bridge import load_jax_params, random_jax_params
    from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
    from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig

    dec_cfg = MultimodalDecoderConfig(text_embedding_dims=384, num_fusion_layers=fusion_layers,
                                      fusion_hidden_dims=hidden)
    if adapter is not None:
        decoder = MultimodalDecoder(adapter, dec_cfg, device="cuda",
                                    generator=torch.Generator().manual_seed(seed + fusion_layers))
        return decoder
    decoder = MultimodalDecoder(TimesFM2p5Adapter(dataclasses.replace(TimesFMConfig(), compute_dtype=dtype)),
                                dec_cfg, device="cpu")
    load_jax_params(decoder, random_jax_params(decoder, seed))
    return decoder.cuda()


def _sweep_results(path) -> dict:
    out = {}
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        if "val/best_loss" in rec or "error" in rec:
            out[rec["run_id"]] = rec
    return out


def sweep_tree(seed: int) -> tuple[Path, float, float]:
    """The phase-8 tree split by the port's split CLI and the fold cached by the cache CLI,
    made anew under ``SWEEP_TREE`` with the configs the tune CLI reads (``model.json``,
    ``forecast.json``, ``sweep.json``): (the directory, split seconds, cache seconds).
    Phase 10 makes it and phase 11 tunes on it again."""
    from multimodal_timesfm_torch.time_mmd import cache as cache_cli
    from multimodal_timesfm_torch.time_mmd import split as split_cli

    tmp = SWEEP_TREE
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    root, snapshot, cache_dir = tmp / "Time-MMD", tmp / "minilm", tmp / "cache"
    start = time.perf_counter()
    words = write_time_mmd_tree(root, seed)
    write_minilm_snapshot(snapshot, words, seed)
    if split_cli.main(["--data-path", str(root), "--train-ratio", "0.6", "--val-ratio", "0.2"]) != 0:
        raise AssertionError("split CLI failed")
    split_s = time.perf_counter() - start
    (tmp / "model.json").write_text(json.dumps({
        "adapter": {"type": "timesfm", "patch_len": 32, "arch": {"num_layers": CUT_LAYERS}},
        "fusion": {"text_encoder_type": "english", "text_embedding_dims": 384}}))
    (tmp / "forecast.json").write_text(json.dumps({"context_len": 32, "horizon_len": 32}))
    start = time.perf_counter()
    for augment, splits in ((True, ("train",)), (False, ("val", "test"))):
        argv = ["--data-path", str(root), "--model-config", str(tmp / "model.json"),
                "--forecast-config", str(tmp / "forecast.json"), "--text-encoder-type", "english",
                "--text-model-dir", str(snapshot), "--cache-dir", str(cache_dir), "--seed", str(seed),
                "--domains", *(f"{d}_{s}" for d in SWEEP_FOLD for s in splits),
                *(["--augment"] if augment else [])]
        if cache_cli.main(argv) != 0:
            raise AssertionError(f"cache CLI failed: {argv}")
    cache_s = time.perf_counter() - start
    # examples/time_mmd/configs/sweeps/multimodal_1layer.yml, written as JSON (the card has
    # no PyYAML), with the structural keys fixed to one value each: one group.
    (tmp / "sweep.json").write_text(json.dumps({
        "method": "bayes", "metric": {"name": "test/mse", "goal": "minimize"},
        "parameters": {
            "num_fusion_layers": {"value": 1}, "batch_size": {"values": [32]}, "num_epochs": {"values": [2]},
            "learning_rate": {"distribution": "log_uniform_values", "min": 1e-6, "max": 1e-4},
            "lr_scheduler_type": {"values": ["linear"]},
            "warmup_steps": {"distribution": "uniform", "min": 0.0, "max": 0.1},
            "weight_decay": {"distribution": "log_uniform_values", "min": 1e-4, "max": 1e-1},
            "gradient_accumulation_steps": {"values": [1]},
        }}))
    return tmp, split_s, cache_s


def tune_argv(tree: Path, count: int) -> list[str]:
    """The tune CLI's flags for the sweep on ``tree`` (``sweep_tree``), ``count`` trials."""
    return ["--sweep-config", str(tree / "sweep.json"), "--count", str(count), "--model-config",
            str(tree / "model.json"), "--forecast-config", str(tree / "forecast.json"),
            "--cache-dir", str(tree / "cache"), "--offline"]


def sweep_cli_part(seed: int, kind: str) -> None:
    """The tuning workflow from raw CSVs: the phase-8 tree split by the port's split CLI,
    cached by the cache CLI (``sweep_tree``), then ``python -m multimodal_timesfm_torch.tune
    --offline --vectorized`` in-process (one structural group of 8 trials) and the same 8
    configs through the sequential CLI (``train_and_evaluate``)."""
    from multimodal_timesfm_torch import tune

    tmp, split_s, cache_s = sweep_tree(seed)
    root = tmp / "Time-MMD"
    common = [*tune_argv(tmp, 8), "--seed", str(seed)]
    seconds = {}
    for label, extra in (("vectorized", ["--vectorized"]), ("sequential", [])):
        start = time.perf_counter()
        if tune.main([*common, "--output-dir", str(tmp / label), *extra]) != 0:
            raise AssertionError(f"tune CLI ({label}) failed")
        seconds[label] = time.perf_counter() - start
    vec, seq = (_sweep_results(tmp / label / "sweep_results.jsonl") for label in ("vectorized", "sequential"))
    errors = [r for r in (*vec.values(), *seq.values()) if "error" in r]
    if errors or len(vec) != 8 or set(vec) != set(seq):
        raise AssertionError(f"tune CLI: runs {sorted(vec)} / {sorted(seq)}, errors {errors[:2]}")
    worst = {key: max(abs(vec[r][key] - seq[r][key]) / abs(seq[r][key]) for r in seq)
             for key in ("val/best_loss", "test/mse", "test/mae")}
    state = (tmp / "vectorized" / "sweep_state.jsonl").read_text().splitlines()
    n_train = sum(1 for _ in open(root / "numerical" / "Agriculture_train" / "Agriculture_train.csv")) - 1
    print(f"[sweep] workflow: phase 8's tree split by `python -m multimodal_timesfm_torch.time_mmd.split "
          f"--train-ratio 0.6 --val-ratio 0.2` ({n_train} of 500 monthly rows to a train split) and the "
          f"MiniLM-L6 snapshot in {split_s:.1f} s; the fold's caches (train --augment, val, test) by the "
          f"cache CLI in {cache_s:.1f} s; `tune --offline --vectorized --count 8` (TimesFM-2.5 at full "
          f"width, {CUT_LAYERS} layers, fp32, one group of 8 at batch 32, 2 epochs) in "
          f"{seconds['vectorized']:.1f} s, the same 8 configs "
          f"through the sequential CLI in {seconds['sequential']:.1f} s on {kind}; per trial, max "
          f"|vectorized - sequential| / |sequential|: val/best_loss {worst['val/best_loss']:.2g}, "
          f"test/mse {worst['test/mse']:.2g}, test/mae {worst['test/mae']:.2g} (tol {SWEEP_RTOL}); "
          f"{len(state)} observations in sweep_state.jsonl", flush=True)
    if max(worst.values()) > SWEEP_RTOL or len(state) != 8:
        raise AssertionError("tune CLI: vectorized and sequential trials disagree")


def sweep_bench_part(seed: int, kind: str) -> None:
    """``timesfm_mm_sweepT16`` as the JAX bench defines it (bench.py:510-650): TimesFM-2.5
    200M multimodal, bf16 compute, the frozen adapter seq1-folded and stored in bf16;
    2,048 series, batch 32, 2 epochs, context 32; 16 trials in one group against
    sequential T=1 runs (4 timed), and the same 16 split 6/5/5 over 1/2/3 fusion layers."""
    from multimodal_timesfm_torch.models.layers import fold_frozen_tree_seq1
    from multimodal_timesfm_torch.training import vectorized

    start = time.perf_counter()
    base = _timesfm_decoder(seed, torch.bfloat16)
    fold_frozen_tree_seq1(base.adapter)
    for p in base.adapter.parameters():
        if p.dtype == torch.float32:
            p.data = p.data.to(torch.bfloat16)
    decoders = {1: base, 2: _timesfm_decoder(seed, torch.bfloat16, 2, (512,), adapter=base.adapter),
                3: _timesfm_decoder(seed, torch.bfloat16, 3, (512, 256), adapter=base.adapter)}
    fusions = {k: {n: p.detach().clone() for n, p in d.fusion.named_parameters()} for k, d in decoders.items()}
    rng = np.random.default_rng(0)
    n, batch, epochs = 2048, 32, 2
    data = {"context": rng.normal(size=(n, 32)).astype(np.float32),
            "horizon": rng.normal(size=(n, 32)).astype(np.float32),
            "text": rng.normal(size=(n, 1, 384)).astype(np.float32)}
    val = {k: v[:256] for k, v in data.items()}
    built_s = time.perf_counter() - start
    graphs = {"captures": 0, "replays": 0}

    def run(t: int, layers: int = 1):
        r = np.random.default_rng(1)
        hp = {"learning_rate": r.uniform(1e-4, 1e-2, t), "weight_decay": r.uniform(0.0, 0.01, t),
              "warmup_steps": r.uniform(0, 8, t)}
        res = vectorized.run_vectorized_trials(
            decoders[layers], vectorized.replicate_trainables(fusions[layers], t), data, val, hp,
            horizon_len=32, batch_size=batch, num_epochs=epochs, scheduler="linear", seed=0)
        graphs["captures"] += res.graph_captures
        graphs["replays"] += res.graph_replays
        if not np.isfinite(res.train_losses).all() or not np.isfinite(res.best_val).all():
            raise AssertionError(f"sweepT16: non-finite losses at T={t}")
        return res

    def timed(fn) -> float:
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - start

    trials, seq_trials = 16, 4
    run(1)  # the capture of the T=1 program
    seq = timed(lambda: [run(1) for _ in range(seq_trials)]) / seq_trials
    run(trials)  # the capture of the T=16 program
    vec = timed(lambda: run(trials)) / trials
    frag = {1: 6, 2: 5, 3: 5}
    first = {layers: timed(lambda layers=layers, t=t: run(t, layers)) for layers, t in frag.items()}
    frag_s = timed(lambda: [run(t, layers) for layers, t in frag.items()]) / trials
    # One step (a graph replay) and one validation pass (8 eager vmapped forwards) of the
    # T=16 and T=1 programs under the profiler; a whole call's trace (some 50,000 kernels)
    # takes the profiler tens of seconds to reduce.
    programs = {p.idx.shape[0]: p for p in vectorized._PROGRAMS.values() if p.objective.decoder is base}
    val_idx = torch.arange(256, device="cuda").reshape(8, 32)
    val_w = torch.ones(8, 32, device="cuda")
    profiled = {}
    for t in (trials, 1):
        prog = programs[t]
        profiled[t] = [device_profile(prog.graph[0].replay),
                       device_profile(lambda prog=prog: prog.val_losses(val_idx, val_w, 8))]
    print(f"[sweep] timesfm_mm_sweepT16 (TimesFM-2.5 200M multimodal, seq1-folded, frozen in bf16, bf16 "
          f"compute; {n} series, batch {batch}, {epochs} epochs, context 32; built in {built_s:.1f} s): "
          f"vectorized T={trials} {vec:.4f} s/trial ({3600 / vec:.1f} trials/hour), sequential T=1 "
          f"{seq:.4f} s/trial ({3600 / seq:.1f} trials/hour, {seq_trials} timed), ratio {seq / vec:.2f}; "
          f"fragmented {frag} over 1/2/3 fusion layers {frag_s:.4f} s/trial (ratio {seq / frag_s:.2f}; first "
          f"calls with their captures {', '.join(f'{k}: {v:.2f} s' for k, v in first.items())}); "
          f"{n * epochs / vec:.1f} train series/s vectorized; CUDA graphs {graphs['captures']} captures, "
          f"{graphs['replays']} replays on {kind}", flush=True)
    for t, ((step_wall, step_k), (val_wall, val_k)) in profiled.items():
        step_busy, val_busy = sum(ms for _, ms in step_k), sum(ms for _, ms in val_k)
        top = ", ".join(f"{k[:40]} {ms:.3f} ms" for k, ms in step_k[:3])
        print(f"[profile] sweepT16 T={t}: one step (graph replay) wall {step_wall:.3f} ms, device busy "
              f"{step_busy:.3f} ms, idle {1 - step_busy / step_wall:.3f}; one validation pass (8 eager vmapped "
              f"forwards of 32 rows) wall {val_wall:.1f} ms, busy {val_busy:.1f} ms, idle "
              f"{1 - val_busy / val_wall:.3f}; a call runs 128 steps and 2 passes | step: {top}", flush=True)
    vectorized.release_programs(decoders[1])
    for d in decoders.values():
        vectorized.release_programs(d)


def _group_data(context: int, horizon: int, n: int, patch: int, seed: int, text: bool = True) -> dict:
    rng = np.random.default_rng(seed)
    out = {"context": rng.normal(size=(n, context)).astype(np.float32),
           "horizon": rng.normal(size=(n, horizon)).astype(np.float32)}
    if text:
        out["text"] = rng.normal(size=(n, context // patch, 384)).astype(np.float32)
    return out


def _group_runs(label: str, decoder, key: str, trials: int, data: dict, val: dict, horizon: int, batch: int,
                epochs: int, lr: float, want: dict[str, int], per_step: dict[str, int]) -> None:
    """A T=``trials`` vectorized run of distinct trials (trial t: learning rate lr / 2^t,
    weight decay 0.01 (t + 1), warmup t + 1 steps, permutation stream seed t), then each
    trial alone as a T=1 run with its hyperparameters and seed. Every run's counted
    launches must be ``want`` (the trial axis folded into one launch), and every trial's
    train and validation losses and best validation loss those of its T=1 run within
    SWEEP_RTOL: the folded GEMMs and kernels change only the row counts."""
    from multimodal_timesfm_torch.training import vectorized

    init = {n: p.detach().clone() for n, p in getattr(decoder, key).named_parameters()}
    hp = {"learning_rate": lr * 0.5 ** np.arange(trials), "weight_decay": 0.01 * (1.0 + np.arange(trials)),
          "warmup_steps": 1.0 + np.arange(trials)}
    results, seen = [], []
    for t in (None, *range(trials)):
        one = {k: v if t is None else v[t:t + 1] for k, v in hp.items()}
        n = trials if t is None else 1
        before = launch_counts()
        start = time.perf_counter()
        res = vectorized.run_vectorized_trials(
            decoder, vectorized.replicate_trainables(init, n), data, val, one, horizon_len=horizon,
            batch_size=batch, num_epochs=epochs, seed=t or 0, seed_stride=1, trainable_key=key)
        seconds = time.perf_counter() - start
        run = f"T={trials}" if t is None else f"trial {t} alone"
        delta = expect_launches(f"{label} {run}", before, want)
        for k, m in per_step.items():
            GRAPH_LAUNCHES[k] = GRAPH_LAUNCHES.get(k, 0) + (res.graph_replays - res.graph_captures) * m
        if not (np.isfinite(res.train_losses).all() and np.isfinite(res.best_val).all()):
            raise AssertionError(f"{label} {run}: non-finite losses")
        results.append(res)
        seen.append(f"{run}: {seconds:.2f} s, counted launches {delta}, graph {res.graph_captures} capture / "
                    f"{res.graph_replays} replays, best val {np.array2string(res.best_val, precision=5)}")
        vectorized.release_programs(decoder)
    vec, alone = results[0], results[1:]
    worst = {name: max(float(np.max(np.abs(getattr(vec, name)[t] - getattr(r, name)[0])
                                    / np.abs(getattr(r, name)[0]))) for t, r in enumerate(alone))
             for name in ("train_losses", "val_losses", "best_val")}
    # The check has power only if the trials differ (each draws its own batches): two
    # trials more than 2 x SWEEP_RTOL apart cannot both be within it of one run alone.
    apart = min(float(np.max(np.abs(a.train_losses - b.train_losses) / np.abs(b.train_losses)))
                for i, a in enumerate(alone) for b in alone[i + 1:])
    print(f"[sweep] {label}: " + "; ".join(seen) + f"; the same counted launches at T=1 and T={trials} "
          f"(per step {per_step}; each run: the eager step, the capture, the validation forwards); "
          f"learning rates {', '.join(f'{x:.3g}' for x in hp['learning_rate'])}; per trial, max |T={trials} - "
          f"alone| / |alone|: " + ", ".join(f"{k} {v:.2g}" for k, v in worst.items()) + f" (tol {SWEEP_RTOL}); "
          f"two trials' train losses at least {apart:.2g} apart", flush=True)
    if max(worst.values()) > SWEEP_RTOL:
        raise AssertionError(f"{label}: a trial of the T={trials} run departs from its run alone")
    if apart <= 5 * SWEEP_RTOL:
        raise AssertionError(f"{label}: the trials are too alike for the check to tell them apart")


def sweep_groups_part(seed: int, kind: str) -> None:
    """The trial axis through the kernels: a TimesFM multimodal group at context 512 (16
    tokens, B1f/B1b), a Chronos-2 multimodal group at chronos_mm_h32 (67 tokens, B4f/B4b),
    each at T=4 with the launches of T=1; a baseline TimesFM group of T=2 with per-trial
    200M weights; every trial of a group against its run alone; ``vectorized_max_trials``."""
    from multimodal_timesfm_torch.models.bridge import load_jax_params, random_jax_params
    from multimodal_timesfm_torch.models.chronos import Chronos2Adapter, Chronos2Config
    from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
    from multimodal_timesfm_torch.training import vectorized

    # TimesFM context 512, horizon 128, 256 series at batch 32 (8 steps an epoch), 2 epochs,
    # validation 64 series (2 batches): 20 layers x (eager step + capture + 2 x 2 validation).
    timesfm = _timesfm_decoder(seed, torch.float32)
    data, val = _group_data(512, 128, 256, 32, seed), _group_data(512, 128, 64, 32, seed + 1)
    _group_runs("TimesFM-2.5 200M multimodal context 512 fp32 (16 tokens)", timesfm, "fusion", 4, data, val,
                128, 32, 2, TRAIN_LR, {"B1f": 20 * 6, "B1b": 20 * 2}, {"B1f": 20, "B1b": 20})

    # Baseline: the adapter per trial (2 x 200M), context 512, 64 series at batch 16 (4 steps),
    # one epoch, validation 16 series: 20 x (eager + capture + 1) forward, 20 x 2 backward.
    data, val = _group_data(512, 128, 64, 32, seed + 2, text=False), _group_data(512, 128, 16, 32, seed + 3, False)
    _group_runs("TimesFM-2.5 200M baseline context 512 fp32, per-trial weights", timesfm, "adapter", 2,
                data, val, 128, 16, 1, BASELINE_LR, {"B1f": 20 * 3, "B1b": 20 * 2}, {"B1f": 20, "B1b": 20})
    trainable_bytes = sum(p.numel() * 4 for p in timesfm.adapter.parameters())
    hbm = vectorized.device_hbm_bytes()
    t_max = vectorized.vectorized_max_trials(trainable_bytes, hbm)
    print(f"[sweep] vectorized_max_trials: {trainable_bytes / 1e9:.3f} GB of fp32 adapter, 5 copies a trial, "
          f"0.75 of {hbm / 1e9:.1f} GB -> T_max = {t_max} baseline trials on {kind}", flush=True)
    del timesfm
    torch.cuda.empty_cache()

    # Chronos-2 120M multimodal, bf16 compute, frozen encoder in bf16: context 32, horizon 32,
    # 512 series at batch 128 (4 steps), 2 epochs, validation 128: 16 layers x (2 + 2).
    cfg = dataclasses.replace(Chronos2Config(), compute_dtype=torch.bfloat16)
    dec_cfg = MultimodalDecoderConfig(text_embedding_dims=384, num_fusion_layers=1)
    chronos = MultimodalDecoder(Chronos2Adapter(cfg), dec_cfg, device="cpu")
    load_jax_params(chronos, random_jax_params(chronos, seed))
    for p in chronos.adapter.parameters():
        p.data = p.data.to(torch.bfloat16)
    chronos = chronos.cuda()
    data, val = _group_data(32, CHRONOS_HORIZON, 512, 16, seed + 4), _group_data(32, CHRONOS_HORIZON, 128, 16, seed + 5)
    _group_runs("Chronos-2 120M multimodal (chronos_mm_h32, 67 tokens) bf16, frozen in bf16", chronos, "fusion", 4,
                data, val, CHRONOS_HORIZON, 128, 2, TRAIN_LR, {"B4f": 16 * 4, "B4b": 16 * 2},
                {"B4f": 16, "B4b": 16})


def sweep_phase(seed: int) -> None:
    """Phase 10: the tuning workflow and the vectorized trials on the card, with PyTorch's
    per-sample vmap fallback disabled (an op without a batching rule raises) and the plain
    attention made to raise."""
    from multimodal_timesfm_torch.models import layers

    kind = torch.cuda.get_device_name(0)
    plain = layers.plain_causal_attention

    def no_plain(*a):
        raise AssertionError("plain_causal_attention ran on the card")

    layers.plain_causal_attention = no_plain
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        start = time.perf_counter()
        sweep_cli_part(seed, kind)
        print(f"[sweep] workflow part: {time.perf_counter() - start:.1f} s", flush=True)
        start = time.perf_counter()
        sweep_bench_part(seed, kind)
        print(f"[sweep] sweepT16 part: {time.perf_counter() - start:.1f} s", flush=True)
        start = time.perf_counter()
        sweep_groups_part(seed, kind)
        print(f"[sweep] groups part: {time.perf_counter() - start:.1f} s", flush=True)
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(True)
        layers.plain_causal_attention = plain
    imported = sorted(m for m in ("jax", "multimodal_timesfm_tpu", "examples", "pandas") if m in sys.modules)
    if imported:
        raise AssertionError(f"the sweep path imported {imported}")


# --- phase 11: the (data, model) mesh -----------------------------------------

# Phase 10's split tree and cache, kept for phase 11's tune CLI over two ranks.
SWEEP_TREE = Path(__file__).resolve().parent / "build" / "sweep_tree"
# Two ranks on one card against the same run without a mesh: fp32 train losses relative,
# validation losses and weights absolute (JAX's tests/test_sharding.py:96-101), vectorized
# trials SWEEP_RTOL. Forecasts, max |diff| / std of the forecasts without a mesh, each limit
# set between the largest sound reading and a control, as read on an H100 80GB HBM3 at
# 700 W. fp32 1e-4: Chronos-2's 16 layers with their row-parallel GEMMs summed in two
# halves read 2.95e-5, the same decoder without a mesh at batch 32 against 64 (other GEMM
# shapes) 4.2e-5. bf16 0.2: Chronos-2 under the mesh reads 0.150 and at batch 32 against
# 64 0.115; bf16 against fp32 (the control: a whole dtype's rounding) reads 0.274.
PAR_LOSS_RTOL, PAR_VAL_ATOL, PAR_WEIGHT_ATOL = 1e-5, 1e-4, 5e-3
PAR_FORECAST_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.2}
# Launches the ranks of phase 11 made on the card: their counters are their own.
RANK_LAUNCHES: dict[str, int] = {}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _arrays(module) -> dict[str, np.ndarray]:
    return {name: p.detach().float().cpu().numpy() for name, p in module.named_parameters()}


def parallel_work(seed: int, meshes: dict | None, workdir: str, rank: int = 0) -> dict:
    """The runs of phase 11, over ``meshes`` ({"dp": the (2, 1) mesh, "mp": the (1, 2) mesh};
    every rank runs this) or each without a mesh (``meshes`` None; the reference): what
    each gives. Weights from ``seed`` (numpy, as ``random_jax_params`` draws them), full
    width. Under the (1, 2) mesh the decoders are sharded by ``parallel.shard_params``;
    rank 0 writes what must be compared whole (a checkpoint, Chronos's trained weights)."""
    from multimodal_timesfm_torch import parallel
    from multimodal_timesfm_torch.inference import Forecaster
    from multimodal_timesfm_torch.models.bridge import export_jax_params, load_jax_params, random_jax_params
    from multimodal_timesfm_torch.models.chronos import Chronos2Adapter, Chronos2Config
    from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
    from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig
    from multimodal_timesfm_torch.training import vectorized
    from multimodal_timesfm_torch.training.evaluator import MultimodalEvaluator
    from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
    from multimodal_timesfm_torch.training_args import TrainingArguments

    dp, mp = (None, None) if meshes is None else (meshes["dp"], meshes["mp"])
    shard = None if meshes is None else parallel.shard_params
    tag = "ref" if meshes is None else "mesh"
    dec_cfg = MultimodalDecoderConfig(text_embedding_dims=384, num_fusion_layers=1)
    trees = {}

    def decoder(family: str, dtype: torch.dtype = torch.float32):
        if family == "timesfm":
            adapter = TimesFM2p5Adapter(dataclasses.replace(TimesFMConfig(), num_layers=CUT_LAYERS,
                                                            compute_dtype=dtype))
        else:
            adapter = Chronos2Adapter(dataclasses.replace(Chronos2Config(), num_layers=CUT_LAYERS,
                                                          compute_dtype=dtype))
        dec = MultimodalDecoder(adapter, dec_cfg, device="cpu")
        if family not in trees:
            trees[family] = random_jax_params(dec, seed)
        load_jax_params(dec, trees[family])
        return dec.cuda()

    def args(name: str, batch: int, epochs: int, lr: float, save_strategy: str = "no") -> TrainingArguments:
        return TrainingArguments(
            output_dir=f"{workdir}/{tag}_{name}", per_device_train_batch_size=batch,
            per_device_eval_batch_size=batch, num_train_epochs=epochs, learning_rate=lr, weight_decay=0.01,
            eval_strategy="epoch", save_strategy=save_strategy, logging_strategy="no", seed=seed)

    out: dict = {"graph_launches": {}}

    def count_replays(captures: int, replays: int, per_step: dict[str, int]) -> None:
        for key, n in per_step.items():
            out["graph_launches"][key] = out["graph_launches"].get(key, 0) + (replays - captures) * n

    # TimesFM-2.5 (CUT_LAYERS layers) multimodal, context 512 (16 tokens), fp32, the (2, 1) mesh: 256
    # series at batch 64, two epochs of the loop, then two of the fused path.
    dec = decoder("timesfm")
    train, val = make_samples(512, 256, seed, TRAIN_HORIZON), make_samples(512, 64, seed + 1, TRAIN_HORIZON)
    trainer = MultimodalTrainer(dec, args("mm", 64, 2, TRAIN_LR), train, val, "multimodal", device="cuda", mesh=dp)
    out["mm_loop"] = [(trainer.train_epoch(), trainer.validate_epoch()) for _ in range(2)]
    out["mm_loop_fusion"] = _arrays(dec.fusion)
    load_jax_params(dec.fusion, trees["timesfm"]["fusion"])
    trainer = MultimodalTrainer(dec, args("mm", 64, 2, TRAIN_LR), train, val, "multimodal", device="cuda", mesh=dp)
    losses, vals = trainer.train_epochs_fused(2)
    out["mm_fused"] = {"losses": losses, "vals": vals, "fusion": _arrays(dec.fusion),
                       "captures": trainer.graph_captures, "replays": trainer.graph_replays}
    count_replays(trainer.graph_captures, trainer.graph_replays, {"B1f": CUT_LAYERS, "B1b": CUT_LAYERS})
    # MultimodalEvaluator on 200 series at batch 64 (the last batch padded), the (2, 1) mesh.
    evaluator = MultimodalEvaluator(dec, device="cuda", mesh=dp)
    out["evaluate"] = dict(evaluator.evaluate(make_samples(512, 200, seed + 2, TRAIN_HORIZON), batch_size=64))
    # Four distinct trials (lr 1e-4 / 2^t, own batch orders) over the (2, 1) mesh: two a rank.
    load_jax_params(dec.fusion, trees["timesfm"]["fusion"])
    init = {n: p.detach().clone() for n, p in dec.fusion.named_parameters()}
    hp = {"learning_rate": TRAIN_LR * 0.5 ** np.arange(4), "weight_decay": 0.01 * (1.0 + np.arange(4)),
          "warmup_steps": 1.0 + np.arange(4)}
    data, tval = _group_data(512, HORIZON, 256, 32, seed + 3), _group_data(512, HORIZON, 64, 32, seed + 4)
    res = vectorized.run_vectorized_trials(
        dec, vectorized.replicate_trainables(init, 4, dp), data, tval, hp, horizon_len=HORIZON, batch_size=32,
        num_epochs=2, seed=seed, seed_stride=1, mesh=dp)
    mse, mae = vectorized.evaluate_vectorized(dec, res.best_trainable, tval, horizon_len=HORIZON, batch_size=32,
                                              mesh=dp)
    out["trials"] = {"train": res.train_losses, "val": res.val_losses, "best": res.best_val, "mse": mse,
                     "mae": mae, "block": next(iter(res.best_trainable.values())).shape[0]}
    count_replays(res.graph_captures, res.graph_replays, {"B1f": CUT_LAYERS, "B1b": CUT_LAYERS})
    vectorized.release_programs(dec)
    del dec, trainer, evaluator, res
    torch.cuda.empty_cache()

    # TimesFM baseline, context 512, fp32, the (1, 2) mesh: 128 series at batch 32, one
    # epoch; the best checkpoint (whole arrays) written under the mesh.
    dec = decoder("timesfm")
    train, val = make_samples(512, 128, seed + 5, TRAIN_HORIZON), make_samples(512, 32, seed + 6, TRAIN_HORIZON)
    trainer = MultimodalTrainer(dec, args("base", 32, 1, BASELINE_LR, save_strategy="best"), train, val,
                                "baseline", device="cuda", mesh=mp, shard_params_fn=shard)
    out["base"] = {"loss": trainer.train_epoch(), "val": trainer.validate_epoch()}
    if meshes is None:
        out["base"]["adapter"] = _leaves(export_jax_params(dec.adapter))
    else:
        trainer.save_ckpt(out["base"]["val"])
        out["base"]["ckpt"] = str(trainer.args.checkpoint_dir / "best_model.ckpt")
        whole = parallel.gather_params(trainer.trainable_module)
        if rank == 0:
            from multimodal_timesfm_torch.training.checkpoint import load_checkpoint

            # Loaded into a TimesFM adapter without a mesh: bit-equal to the gathered weights.
            plain = TimesFM2p5Adapter(TimesFMConfig(num_layers=CUT_LAYERS))
            load_jax_params(plain, load_checkpoint(out["base"]["ckpt"])["adapter_params"])
            trained = trainer.trainable_module.parameters()
            out["base"]["ckpt_bit_equal"] = all(
                torch.equal(p, whole[q].cpu()) for p, q in zip(plain.parameters(), trained))
        out["base"]["local_ffn_up"] = tuple(dec.adapter.stacked_xf.layers[0].ffn_up.weight.shape)
    del dec, trainer
    torch.cuda.empty_cache()

    # Chronos-2 (CUT_LAYERS layers) baseline at chronos_mm_h32's geometry (context 32, 67 tokens, horizon
    # 32), fp32, the (1, 2) mesh: 256 series at batch 64, one epoch (B4f/B4b at 6 heads).
    dec = decoder("chronos")
    train = make_samples(32, 256, seed + 7, CHRONOS_HORIZON, patch=16)
    val = make_samples(32, 64, seed + 8, CHRONOS_HORIZON, patch=16)
    trainer = MultimodalTrainer(dec, args("chronos", 64, 1, BASELINE_LR), train, val, "baseline", device="cuda",
                                mesh=mp, shard_params_fn=shard)
    out["chronos"] = {"loss": trainer.train_epoch(), "val": trainer.validate_epoch()}
    whole = parallel.gather_params(trainer.trainable_module) if meshes else None
    if meshes is None:
        out["chronos"]["adapter"] = _arrays(dec.adapter)
    elif rank == 0:
        names = [n for n, _ in trainer.trainable_module.named_parameters()]
        np.savez(f"{workdir}/chronos_mesh.npz", **{
            n: whole[p].cpu().numpy() for n, p in zip(names, trainer.trainable_module.parameters())})
    del dec, trainer, whole
    torch.cuda.empty_cache()

    # Chronos-2 served at context 512 (97 tokens), fp32 and bf16, the (1, 2) mesh: 128
    # series in batches of 64; TimesFM served at context 512 in bf16, 192 series in batches
    # of 64, at (2, 1) and (1, 2).
    serve_c = make_samples(512, 128, seed + 9, HORIZON, patch=16)
    out["chronos_serve"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        fc = Forecaster(decoder("chronos", dtype), batch_size=64, device="cuda", mesh=mp, shard_params_fn=shard)
        out["chronos_serve"][dtype] = fc.forecast_dataset(HORIZON, serve_c)
        if meshes is None:
            fc.batch_size = 32  # the floor: the same decoder, other GEMM shapes
            out.setdefault("chronos_serve_b32", {})[dtype] = fc.forecast_dataset(HORIZON, serve_c)
        del fc
    serve_t = make_samples(512, 192, seed + 10, HORIZON)
    out["serve"] = {}
    for name, mesh, sharded in (("dp2", dp, None), ("mp2", mp, shard)):
        if meshes is None and name == "mp2":
            break  # one reference for both meshes
        fc = Forecaster(decoder("timesfm", torch.bfloat16), batch_size=64, device="cuda", mesh=mesh,
                        shard_params_fn=sharded)
        out["serve"][name] = fc.forecast_dataset(HORIZON, serve_t, denormalize=True)
        del fc
    torch.cuda.empty_cache()
    if meshes is None:
        out["trees"] = trees
    return out


def parallel_rank(rank: int, world: int, port: int, seed: int, workdir: str) -> None:
    """One of phase 11's two ranks: gloo (NCCL refuses two ranks on one card), the card's
    device 0; the plain attention made to raise; ``parallel_work`` over a (2, 1) and a (1, 2)
    mesh; what it saw, with its launches, pickled to ``workdir/rank<rank>.pkl``."""
    from multimodal_timesfm_torch import parallel
    from multimodal_timesfm_torch.models import layers
    from multimodal_timesfm_torch.ops import chronos_attention

    def no_plain(*a):
        raise AssertionError("the plain attention ran on the card")

    layers.plain_causal_attention = no_plain
    chronos_attention.plain_chronos_attention = no_plain
    parallel.initialize_multihost(f"localhost:{port}", world, rank, backend="gloo")
    meshes = {"dp": parallel.make_mesh(parallel.MeshConfig(data_parallel=2, model_parallel=1)),
              "mp": parallel.make_mesh(parallel.MeshConfig(data_parallel=1, model_parallel=2))}
    for counter in launch_counters().values():
        counter.launches = 0
    out = parallel_work(seed, meshes, workdir, rank)
    out["launches"] = {k: n + out["graph_launches"].get(k, 0) for k, n in launch_counts().items()}
    with open(f"{workdir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def _max_diff(a: dict, b: dict) -> float:
    return max(float(np.max(np.abs(a[k] - b[k]))) for k in b)


def parallel_checks(ref: dict, ranks: list[dict], workdir: str) -> tuple[list[str], list[str]]:
    """Each reading of the two ranks beside its limit, against the runs without a mesh, and
    the labels of those that fail."""
    from multimodal_timesfm_torch.training.checkpoint import load_checkpoint

    lines, failed = [], []

    def check(label: str, value: float, limit: float) -> None:
        ok = value <= limit
        lines.append(f"{label} {value:.3g} (limit {limit:g}){'' if ok else ' FAILED'}")
        if not ok:
            failed.append(label)

    def rel(a, b) -> float:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / np.abs(b)))

    for r, seen in enumerate(ranks):
        pre = f"rank {r}:"
        loop, want = np.asarray(seen["mm_loop"]), np.asarray(ref["mm_loop"])
        check(f"{pre} (2,1) TimesFM mm c512 loop, 2 epochs: train loss rel", rel(loop[:, 0], want[:, 0]), PAR_LOSS_RTOL)
        check(f"{pre} val loss abs", float(np.max(np.abs(loop[:, 1] - want[:, 1]))), PAR_VAL_ATOL)
        check(f"{pre} fusion weights abs", _max_diff(seen["mm_loop_fusion"], ref["mm_loop_fusion"]), PAR_WEIGHT_ATOL)
        fused, want = seen["mm_fused"], ref["mm_fused"]
        check(f"{pre} fused path (eager under gloo, {fused['captures']} captures): train losses rel",
              rel(fused["losses"], want["losses"]), PAR_LOSS_RTOL)
        check(f"{pre} val abs", float(np.max(np.abs(fused["vals"] - want["vals"]))), PAR_VAL_ATOL)
        check(f"{pre} fusion abs", _max_diff(fused["fusion"], want["fusion"]), PAR_WEIGHT_ATOL)
        if fused["captures"] != 0:
            failed.append(f"{pre} the fused step was captured under gloo")
        check(f"{pre} (2,1) MultimodalEvaluator mse/mae rel",
              max(rel(seen["evaluate"][k], ref["evaluate"][k]) for k in ("mse", "mae")), PAR_LOSS_RTOL)
        trials, want = seen["trials"], ref["trials"]
        check(f"{pre} (2,1) 4 trials ({trials['block']} on this rank): train/val/best/test mse rel",
              max(rel(trials[k], want[k]) for k in ("train", "val", "best", "mse", "mae")), SWEEP_RTOL)
        for cell, label in (("base", "(1,2) TimesFM baseline c512"), ("chronos", "(1,2) Chronos-2 baseline 67 tokens")):
            check(f"{pre} {label}: train loss rel", rel(seen[cell]["loss"], ref[cell]["loss"]), PAR_LOSS_RTOL)
            check(f"{pre} val abs", abs(seen[cell]["val"] - ref[cell]["val"]), PAR_VAL_ATOL)
        for dtype, out in seen["chronos_serve"].items():
            want = ref["chronos_serve"][dtype]
            check(f"{pre} (1,2) Chronos-2 c512 {str(dtype)[6:]} forecasts / std",
                  float(np.max(np.abs(out - want)) / want.std()), PAR_FORECAST_TOL[dtype])
        for name, out in seen["serve"].items():
            want = ref["serve"]["dp2"]
            check(f"{pre} {name} TimesFM c512 bf16 forecasts / std", float(np.max(np.abs(out - want)) / want.std()),
                  PAR_FORECAST_TOL[torch.bfloat16])
    # The weights trained under the (1, 2) mesh, whole: TimesFM's from the checkpoint rank 0
    # wrote, Chronos's as rank 0 gathered them.
    base = ranks[0]["base"]
    if not base.get("ckpt_bit_equal"):
        failed.append("the checkpoint written under the mesh, loaded without one, differs from the gathered weights")
    def spread(out, want) -> str:
        diff = np.abs(out - want) / want.std()
        return f"max {diff.max():.3g}, median {np.median(diff):.3g}"

    serve, b32 = ref["chronos_serve"], ref["chronos_serve_b32"]
    lines.append(f"without a mesh, Chronos-2 c512 |diff| / std: fp32 at batch 32 against 64 "
                 f"{spread(b32[torch.float32], serve[torch.float32])}; bf16 at batch 32 against 64 "
                 f"{spread(b32[torch.bfloat16], serve[torch.bfloat16])}; bf16 against fp32 "
                 f"{spread(serve[torch.bfloat16], serve[torch.float32])}")
    for r, seen in enumerate(ranks):
        lines.append(f"rank {r}: (1,2) Chronos-2 c512 bf16 |diff| / std "
                     f"{spread(seen['chronos_serve'][torch.bfloat16], serve[torch.bfloat16])}")
    lines.append(f"(1,2) checkpoint loaded without a mesh bit-equal to the gathered weights: "
                 f"{base.get('ckpt_bit_equal')} (rank 0 held ffn_up {base['local_ffn_up']} of each layer)")
    tree = _leaves(load_checkpoint(base["ckpt"])["adapter_params"])
    check("(1,2) TimesFM baseline weights (the checkpoint) abs", _max_diff(tree, ref["base"]["adapter"]),
          PAR_WEIGHT_ATOL)
    with np.load(f"{workdir}/chronos_mesh.npz") as chronos:
        check("(1,2) Chronos-2 baseline weights abs", _max_diff(dict(chronos), ref["chronos"]["adapter"]),
              PAR_WEIGHT_ATOL)
    return lines, failed


def nccl_one_rank(seed: int, trees: dict, kind: str) -> None:
    """One rank, NCCL, mesh (1, 1): TimesFM multimodal c512 fp32 on the fused path, its step
    captured as one CUDA graph with its data-axis all-reduce, against the same run without
    a mesh (bit-equal or not, and both runs' train series/s; run in turns: no mesh, mesh,
    mesh, no mesh); then the trained decoder's autoregressive decode through ``Forecaster``,
    a CUDA graph with the mesh and without it (bit-equal or not)."""
    from multimodal_timesfm_torch import parallel
    from multimodal_timesfm_torch.inference import Forecaster
    from multimodal_timesfm_torch.models.bridge import load_jax_params
    from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
    from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig
    from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
    from multimodal_timesfm_torch.training_args import TrainingArguments

    parallel.initialize_multihost(f"localhost:{free_port()}", 1, 0)
    try:
        mesh = parallel.make_mesh(parallel.MeshConfig(data_parallel=1, model_parallel=1))
        backend = torch.distributed.get_backend()
        dec = MultimodalDecoder(TimesFM2p5Adapter(TimesFMConfig(num_layers=CUT_LAYERS)),
                                MultimodalDecoderConfig(text_embedding_dims=384), device="cpu")
        load_jax_params(dec, trees["timesfm"])
        dec = dec.cuda()
        train, val = make_samples(512, 256, seed, TRAIN_HORIZON), make_samples(512, 64, seed + 1, TRAIN_HORIZON)
        runs = {}
        with tempfile.TemporaryDirectory() as workdir:
            for label in ("no mesh", "mesh (1,1)", "mesh (1,1) again", "no mesh again"):
                load_jax_params(dec.fusion, trees["timesfm"]["fusion"])
                args = TrainingArguments(
                    output_dir=workdir, per_device_train_batch_size=64, per_device_eval_batch_size=64,
                    num_train_epochs=2, learning_rate=TRAIN_LR, weight_decay=0.01, eval_strategy="epoch",
                    save_strategy="no", logging_strategy="no", seed=seed)
                trainer = MultimodalTrainer(dec, args, train, val, "multimodal", device="cuda",
                                            mesh=mesh if "mesh (" in label else None)
                losses, vals = trainer.train_epochs_fused(2)
                for key in ("B1f", "B1b"):
                    GRAPH_LAUNCHES[key] = (GRAPH_LAUNCHES.get(key, 0)
                                           + (trainer.graph_replays - trainer.graph_captures) * CUT_LAYERS)
                runs[label] = (losses, vals, _arrays(dec.fusion), trainer.graph_captures, trainer.graph_replays,
                               trainer.last_throughput)
        # Horizon 512: 4 rounds at context 512; 128 series in batches of 64, served twice.
        serve = make_samples(512, 128, seed + 23, horizon=512)
        decodes = {}
        for label, m in (("no mesh", None), ("mesh (1,1)", mesh)):
            fc = Forecaster(dec, batch_size=64, device="cuda", mesh=m)
            got = [fc.forecast_dataset(512, serve, multimodal=True, denormalize=True, autoregressive=True)
                   for _ in range(2)]
            replayed = fc.graph_replays - fc.graph_captures
            GRAPH_LAUNCHES["B1f"] = GRAPH_LAUNCHES.get("B1f", 0) + CUT_LAYERS * 4 * replayed
            decodes[label] = (got, fc.graph_captures, fc.graph_replays)
    finally:
        torch.distributed.destroy_process_group()
    ref, ours = runs["no mesh"], runs["mesh (1,1)"]
    bit_equal = (np.array_equal(ref[0], ours[0]) and np.array_equal(ref[1], ours[1])
                 and all(np.array_equal(ref[2][k], ours[2][k]) for k in ref[2]))
    worst = max(float(np.max(np.abs(ours[0] - ref[0]) / np.abs(ref[0]))), 0.0)
    rates = ", ".join(f"{label} {r[5]:.1f}" for label, r in runs.items())
    print(f"[parallel] one rank, {backend}, mesh (1,1), TimesFM ({CUT_LAYERS} layers) mm c512 fp32 fused, 256 "
          f"series at batch 64, "
          f"2 epochs: graph captures {ours[3]} (replays {ours[4]}), the step's all-reduce in the graph; losses "
          f"and fusion weights bit-equal to the run without a mesh: {bit_equal} (train losses rel {worst:.3g}, "
          f"limit {PAR_LOSS_RTOL:g}) | train series/s in turns on {kind}: {rates}", flush=True)
    if ours[3] < 1 or worst > PAR_LOSS_RTOL or _max_diff(ours[2], ref[2]) > PAR_WEIGHT_ATOL:
        raise AssertionError("one-rank NCCL mesh: no graph capture, or the run departs from the one without a mesh")
    plain = decodes["no mesh"][0]
    got, captures, replays = decodes["mesh (1,1)"]
    decode_equal = all(np.array_equal(a, w) for a, w in zip(got, plain))
    spread = max(float(np.max(np.abs(a - w)) / w.std()) for a, w in zip(got, plain))
    print(f"[parallel] one rank, {backend}, mesh (1,1), Forecaster.forecast_autoregressive of the trained "
          f"decoder, horizon 512 (4 rounds at context 512), 128 series at batch 64, twice: decode graph captures "
          f"{captures} (replays {replays}; without a mesh {decodes['no mesh'][1]} / {decodes['no mesh'][2]}), "
          f"forecasts bit-equal to the decode without a mesh: {decode_equal} (max |diff| / std {spread:.3g}, "
          f"limit {PAR_FORECAST_TOL[torch.float32]:g}); at mp = 1 the graph holds no collective, the rows are "
          f"gathered after it", flush=True)
    if captures < 1 or spread > PAR_FORECAST_TOL[torch.float32]:
        raise AssertionError("one-rank NCCL mesh: no decode graph, or the decode departs from the one without a mesh")


def parallel_tune(seed: int, kind: str) -> None:
    """``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
    multimodal_timesfm_torch.tune --vectorized`` (4 trials, one group, two a rank, gloo on
    the one card) on phase 10's split tree and cache, held per run id to the same CLI on one
    rank; rank 0 alone writes the results and the sweep state."""
    from multimodal_timesfm_torch import tune

    tree = SWEEP_TREE if (SWEEP_TREE / "sweep.json").exists() else sweep_tree(seed)[0]
    argv = [*tune_argv(tree, 4), "--seed", str(seed), "--vectorized"]
    for label in ("tune1", "tune2"):
        shutil.rmtree(tree / label, ignore_errors=True)
    start = time.perf_counter()
    if tune.main([*argv, "--output-dir", str(tree / "tune1")]) != 0:
        raise AssertionError("tune CLI on one rank failed")
    one_s = time.perf_counter() - start
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [str(root), os.environ.get("PYTHONPATH")]))}
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "multimodal_timesfm_torch.tune", *argv, "--output-dir", str(tree / "tune2")],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    two_s = time.perf_counter() - start
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-8000:], sep="\n", file=sys.stderr)
        raise AssertionError(f"tune CLI over two ranks exited {proc.returncode}")
    one, two = (_sweep_results(tree / label / "sweep_results.jsonl") for label in ("tune1", "tune2"))
    records = [json.loads(line) for line in (tree / "tune2" / "sweep_results.jsonl").read_text().splitlines()]
    finished = [r["run_id"] for r in records if "val/best_loss" in r]
    state = (tree / "tune2" / "sweep_state.jsonl").read_text().splitlines()
    errors = [r for r in (*one.values(), *two.values()) if "error" in r]
    if errors or len(one) != 4 or set(one) != set(two) or len(finished) != 4 or len(state) != 4:
        raise AssertionError(f"tune over two ranks: runs {sorted(one)} / {finished}, {len(state)} observations, "
                             f"errors {errors[:2]}")
    worst = {key: max(abs(two[r][key] - one[r][key]) / abs(one[r][key]) for r in one)
             for key in ("val/best_loss", "test/mse", "test/mae")}
    print(f"[parallel] `python -m torch.distributed.run --standalone --nproc-per-node 2 -m "
          f"multimodal_timesfm_torch.tune --offline --vectorized --count 4` on phase 10's tree (one group of 4, "
          f"two trials a rank, gloo on {kind}): {two_s:.1f} s against {one_s:.1f} s on one rank in-process; "
          f"one record per run and {len(state)} observations (rank 0 writes); per run id, max |two ranks - one| "
          f"/ |one|: " + ", ".join(f"{k} {v:.2g}" for k, v in worst.items()) + f" (limit {SWEEP_RTOL})",
          flush=True)
    if max(worst.values()) > SWEEP_RTOL:
        raise AssertionError("tune over two ranks departs from one rank")


def parallel_phase(seed: int) -> None:
    """Phase 11: two ranks on the one card (gloo) over the (2, 1) and (1, 2) meshes against
    the same runs without a mesh (run meanwhile in this process), one NCCL rank on a (1, 1)
    mesh, and the tune CLI over two ranks."""
    from multimodal_timesfm_torch.ops import _kernels

    kind = torch.cuda.get_device_name(0)
    for backward, dtype, batch, seq in ((False, torch.float32, 64, 97), (False, torch.bfloat16, 64, 97),
                                        (False, torch.float32, 64, 67), (True, torch.float32, 64, 67)):
        print(f"[route] B4{'b' if backward else 'f'} {str(dtype)[6:]} B={batch} S={seq} H=6 D=64 (12 heads over "
              f"mp=2): {_kernels.chronos_route(backward, dtype, batch, seq, 6, 64)}", flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        start = time.perf_counter()
        ranks = torch.multiprocessing.start_processes(
            parallel_rank, args=(2, free_port(), seed, workdir), nprocs=2, join=False, start_method="spawn")
        try:
            ref = parallel_work(seed, None, workdir)
            ref_s = time.perf_counter() - start
            while not ranks.join():
                pass
        finally:
            for proc in ranks.processes:
                if proc.is_alive():
                    proc.terminate()
        ranks_s = time.perf_counter() - start
        seen = []
        for rank in range(2):
            with open(f"{workdir}/rank{rank}.pkl", "rb") as f:
                seen.append(pickle.load(f))
        lines, failed = parallel_checks(ref, seen, workdir)
        for line in lines:
            print(f"[parallel] {line}", flush=True)
        if failed:
            raise AssertionError(f"phase 11: {failed}")
        for rank, out in enumerate(seen):
            missing = [k for k in ("B1f", "B1b", "B4f", "B4b") if out["launches"][k] == 0]
            print(f"[parallel] rank {rank} (gloo, {kind}) launches: {out['launches']}", flush=True)
            if missing:
                raise AssertionError(f"rank {rank} launched no {missing}")
            for key, n in out["launches"].items():
                RANK_LAUNCHES[key] = RANK_LAUNCHES.get(key, 0) + n
        for key, n in ref.pop("graph_launches").items():
            GRAPH_LAUNCHES[key] = GRAPH_LAUNCHES.get(key, 0) + n
        print(f"[parallel] two ranks on one card, both backbones at {CUT_LAYERS} layers: {ranks_s:.1f} s (the runs "
              f"without a mesh meanwhile in this process, {ref_s:.1f} s)", flush=True)
    nccl_one_rank(seed, ref["trees"], kind)
    parallel_tune(seed, kind)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--kernel-times", action="store_true",
                        help="only check and time every kernel at its main-path shapes")
    parser.add_argument("--root", default=None,
                        help="with --kernel-times: import the port from this checkout instead")
    parser.add_argument("--chronos-only", action="store_true",
                        help="with --kernel-times: only the Chronos rows (B4f, B4b)")
    parser.add_argument("--serving-times", action="store_true",
                        help="only time TimesFM serving at context 512 (fp32, bf16)")
    parser.add_argument("--training-times", action="store_true",
                        help="only time the eager chronos_mm_h32 bf16 training epoch")
    parser.add_argument("--dispatch-times", action="store_true",
                        help="only time one call of the B1 entry point: custom op against autograd.Function")
    parser.add_argument("--parallel-only", action="store_true",
                        help="only build the kernels and run phase 11 (the mesh)")
    parser.add_argument("--aoti-only", action="store_true",
                        help="only build the kernels and run phase 12 (the AOTInductor packages)")
    parser.add_argument("--compile-package", nargs=3, metavar=("NAME", "DTYPE", "OUT"),
                        help="phase 12's child process: compile one package")
    args = parser.parse_args()
    if args.chronos_only and not args.kernel_times:
        parser.error("--chronos-only needs --kernel-times")
    if args.root is not None and not (args.kernel_times or args.serving_times or args.training_times):
        parser.error("--root needs --kernel-times, --serving-times or --training-times")
    if args.root is not None:
        sys.path.insert(0, args.root)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        from multimodal_timesfm_torch.ops import _kernels
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port ({exc}); run from the repository root", file=sys.stderr)
        return 1
    if args.compile_package:
        compile_package(*args.compile_package)
        return 0

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
    for line in sass_mma_report(lib_path):
        print(f"[build] SASS {line}")
    gpu = gpu_line()
    print(f"[gpu] {gpu} | torch {torch.__version__} CUDA {torch.version.cuda} | port from "
          f"{_kernels.CSRC.parent if hasattr(_kernels, 'CSRC') else _kernels.SOURCES[0].parent.parent}",
          flush=True)
    if args.serving_times or args.training_times or args.dispatch_times:
        if args.serving_times:
            serving_times(args.seed)
        if args.training_times:
            training_times(args.seed)
        if args.dispatch_times:
            dispatch_times()
        print(f"[gpu] {gpu}")
        return 0
    if args.aoti_only:
        for counter in launch_counters().values():
            counter.launches = 0
        start = time.perf_counter()
        aoti_phase(args.seed)
        print(f"[phase] aoti package: {time.perf_counter() - start:.1f} s | launches {launch_counts()}", flush=True)
        print(f"[gpu] {gpu}")
        return 0
    if args.parallel_only:
        sharded_chronos_checks(args.seed)
        for counter in launch_counters().values():
            counter.launches = 0
        start = time.perf_counter()
        parallel_phase(args.seed)
        print(f"[phase] parallel: {time.perf_counter() - start:.1f} s | launches here {launch_counts()}, "
              f"replayed {GRAPH_LAUNCHES}, on the ranks {RANK_LAUNCHES}", flush=True)
        print(f"[gpu] {gpu}")
        return 0
    if args.kernel_times:
        if hasattr(_kernels, "attention_route"):
            print_routes()
        kernel_times(args.seed, args.chronos_only)
        print(f"[gpu] {gpu}")
        return 0
    print_routes()

    def phase(name: str, fn, *a):
        start = time.perf_counter()
        out = fn(*a)
        print(f"[phase] {name}: {time.perf_counter() - start:.1f} s", flush=True)
        return out

    rows = phase("forward kernels", kernel_phase, args.seed)
    rows.update(phase("backward kernels", backward_kernel_phase, args.seed))
    phase("edge shapes", edge_checks, args.seed)
    phase("gate lengths", gate_length_checks, args.seed)
    rows.update(phase("chronos kernels", chronos_kernel_phase, args.seed))
    rows.update(phase("flash kernels", flash_kernel_phase, args.seed))
    phase("vmap rules", vmap_rule_checks, args.seed)

    # The main paths: every launch counter starts at 0 just before each and is read
    # just after; the kernels line reports their sum.
    launches = {key: 0 for key, *_ in KERNELS}
    routes: dict[str, int] = {}

    def main_path(name: str, fn, *a):
        for counter in launch_counters().values():
            counter.launches = 0
        for key in ("B4f", "B4b"):
            launch_counters()[key].shapes.clear()
        GRAPH_LAUNCHES.clear()
        RANK_LAUNCHES.clear()
        out = phase(name, fn, *a)
        for key, n in launch_counts().items():
            launches[key] += n + GRAPH_LAUNCHES.get(key, 0) + RANK_LAUNCHES.get(key, 0)
        for route, n in b4_routes().items():
            routes[route] = routes.get(route, 0) + n
        return out

    tree, decoders, reference = main_path("serving", slice_phase, args.seed)
    main_path("training", training_phase, args.seed, tree, decoders, reference)
    main_path("headline", headline_phase, args.seed, tree, decoders)
    main_path("timesfm past 2048 tokens", long_context_phase, args.seed, tree, decoders)
    del decoders, reference
    c_tree, c_decoders, c_reference = main_path("chronos serving", chronos_serving_phase, args.seed)
    main_path("chronos training", chronos_training_phase, args.seed, c_tree, c_decoders, c_reference)
    del c_decoders, c_reference
    torch.cuda.empty_cache()
    main_path("time-mmd data", time_mmd_phase, args.seed, tree)
    del tree
    torch.cuda.empty_cache()
    main_path("pretrained to served", pretrained_phase, args.seed)
    torch.cuda.empty_cache()
    main_path("aoti package", aoti_phase, args.seed)
    torch.cuda.empty_cache()
    main_path("sweeps", sweep_phase, args.seed)
    torch.cuda.empty_cache()
    main_path("parallel", parallel_phase, args.seed)
    idle = [key for key, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main paths: {idle}")
    print(f"[launches] main paths: {launches}")
    print(f"[launches] B4 by route, this process's counted launches (replays, all one-pass, and the "
          f"ranks' not split): {routes}")
    print(json.dumps({"kernels": kernel_entries(rows, launches)}))
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
