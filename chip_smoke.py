#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what comes out.

Run from the repository root, on a host with one CUDA card:

    python3 chip_smoke.py [--seed N]

Phases (each prints its lines and its seconds; any failure exits non-zero):

1. build: compile the eighteen sources under ``multimodal_timesfm_torch/csrc/``
   (``attention_fwd.cu``, ``attention_bwd.cu``, sharing ``attention_common.cuh``;
   their bf16 wgmma/TMA route ``attention_fwd_hopper.cu``, ``attention_bwd_hopper.cu``,
   sharing ``hopper_common.cuh``; ``chronos_attention.cu``, ``chronos_attention_bwd.cu``,
   sharing ``chronos_common.cuh``, and their bf16 wgmma/TMA route at head_dim 64
   ``chronos_attention_hopper.cu``, ``chronos_attention_bwd_hopper.cu``, sharing
   ``chronos_hopper.cuh``; the bf16 one-pass persistent route for short sequences, the
   backwards' ``attention_bwd_short_hopper.cu`` and ``chronos_attention_bwd_short_hopper.cu``,
   B4f's ``chronos_attention_short_hopper.cu`` and B1f's ``attention_fwd_short_hopper.cu``,
   sharing ``hopper_short.cuh``; the
   Chronos kernels' fp32 3xTF32 route at head_dim 64, ``chronos_attention_tf32.cu`` and
   ``chronos_attention_bwd_tf32.cu``, sharing ``chronos_tf32.cuh``, and the causal kernels'
   at head_dim 80, ``attention_fwd_tf32.cu`` and ``attention_bwd_tf32.cu``, sharing
   ``attention_tf32.cuh``; both routes' pieces in ``tf32_common.cuh``; and the causal
   kernels' fp32 3xTF32 route on wgmma fed by TMA, route 5, ``attention_fwd_tf32_hopper.cu``
   and ``attention_bwd_tf32_hopper.cu``, sharing ``attention_tf32_hopper.cuh``) with nvcc
   for sm_90a, one nvcc per source started
   together; print the build seconds, the compiler's register, shared-memory and spill
   report, the SASS count per kernel family of HMMA (mma.sync; HMMA.1688.F32.TF32 among
   them), HGMMA (wgmma; HGMMA on TF32 operands among them) and UTMALDG (TMA tile loads),
   failing if a wgmma-route family holds no HGMMA or UTMALDG, a persistent-route family no
   HMMA or UTMALDG, a 3xTF32 mma.sync family no HMMA.1688.F32.TF32, a route-5 family no HGMMA
   on TF32 operands or no UTMALDG, or a route-5 kernel spills, and the card's name and power
   limit;
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
   200, 577; head dims 16 to 256), on the wgmma route forced at 16 x 577,
   64 x 193, 64 x 97 and its tails, and B4f on its persistent route at
   every case of S <= 128 at head_dim 64 and at odd batches (two launches
   bit-equal); B1f on its persistent route at S = 8 to 64 in steps of 8 at
   odd batches and 5 heads, and on split q, k, v through the whole-sequence
   entry point at S = 1 to 64, left-padded with rows that have no valid key
   (two launches bit-equal); every backward launched twice and held bit-equal; the bf16
   backwards where dV's terms cancel (a cotangent centred over 16-row blocks,
   or over a row's 16 segments, times 8) at each older route's own lengths:
   causal 96 (mma.sync) and 512 (wgmma), Chronos 96 (one-pass), 577 (wgmma)
   and head_dim 128 at 80 (tiled), and the Chronos ones in fp32 at the same
   shapes (the 3xTF32 route at head_dim 64); all at the
   shapes the serving and training paths give them, and at edge shapes. The
   route and tiles of each kernel at its main-path shapes are printed
   (``[route]``: in bf16 at head_dim 80 the causal kernels take the wgmma/TMA route
   from the border the dispatch rule sets, mma.sync below it, and the persistent
   one-pass route up to 64 tokens, forward and backward). First the bf16 borders
   between those two routes: both routes' forward and backward at S = 16 to 2,048
   (D = 80, about 8,192 tokens a call), checked and timed in turns, one ``[gate]`` line
   per length and one per border; then the same for the Chronos kernels' wgmma route
   against their mma.sync routes at S = 64 to 577 (D = 64, 12 heads, about 9,232
   tokens a call; device time held to a CUDA graph replay's event time); then the
   borders of the backwards' persistent route: B1b at S = 8 to 128 (D = 80, 16 heads,
   B = 8,192 / S) against the mma.sync route and, from 64, the wgmma route, B4b at
   S = 16 to 96 (D = 64, 12 heads, B = 9,232 / S), without and with dbias, against the
   one-pass or tiled mma.sync route and the wgmma route, B1f at S = 8 to 64 in steps of 8
   (D = 80, 16 heads, B = 8,192 / S) against the mma.sync route and, at 64, the wgmma route,
   and B4f at S = 16 to 128 against
   the one-pass route up to 96 and the wgmma route from 97 (held times, in turns). The
   fp32 border of the Chronos kernels' 3xTF32 route against their CUDA-core route at S = 16
   to 577 (D = 64, 12 heads, B = 9,232 / S, held times, in turns), and the causal kernels'
   border between their two fp32 routes (``[gate] causal fp32``: route 4, 3xTF32 on
   mma.sync, against route 5, 3xTF32 on wgmma fed by TMA, forward and backward at S = 16 to
   2,100, D = 80, 16 heads, B = 8,192 / S, each checked against the plain version, held
   times in turns), and the borders of the Chronos fp32 routes 6 and 7 (``[gate] chronos
   fp32 persistent``, ``[gate] chronos fp32 wgmma``) are measured only under
   ``--kernel-times``: the rule takes a 3xTF32 route at every S at head_dim 64, and at
   head_dim 80 route 5 from the border the causal gate set, route 4 below it. In fp32 the causal kernels' rows are those of the route the
   rule gives their shape, route 5's with route 4 checked and timed beside it, and B3b runs
   once past one chunk of route 4's scratch (8 x 2,100 x 16; route 5 where the rule sends
   that length). The kernel,
   the plain version and
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
   launches per batch (from 2048 on the wgmma route in bf16 and route 7 in
   fp32, checked), a profiled call, and the card against the port on the CPU
   in fp32;
7. Chronos-2 training through ``MultimodalTrainer`` at the JAX bench's
   geometries (``bench.py:388-403``, context 32, horizon 32): multimodal at
   batch 128 (67 tokens) in fp32 and bf16 (the frozen encoder stored in
   bf16), baseline at batch 128 in fp32
   (dbias on the path), and multimodal with 2 future patches packed 16 to a
   row at batch 512 (segment masking on the path); then at context 8192 (577
   tokens, batch 16) in bf16 and fp32, multimodal and baseline, the paths of
   B4b on the wgmma route and on route 7 (their routes checked); 16 B4f and 16 B4b
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
   (``--compile-package``, started before phase 8, so that the compiles run
   beside phases 8 and 9) from the geometry alone, then re-pointed at
   weights drawn from ``--seed``; served from their files beside the same
   decoders' ``torch.export`` programs: compile and load seconds, series/s of
   the package, ``Forecaster`` and the program in turn on 192 series in
   batches of 64, 20 B1f or 16 B4f launches per batch through the package,
   the package bit-equal between calls and loads and within ``AOTI_TOL`` of
   ``Forecaster`` (with the bf16-against-fp32 control printed), one profiled
   call's idle share. Inductor links the package with ``-fopenmp``: the phase
   takes the first of ``$CXX``, ``g++``, ``c++`` that can;
13. native serving (after phase 12, on its packages): ``mtt_serve``, a libtorch
   program with no Python in its process (``csrc/mtt_serve.cpp``), and the attention
   ops registered in C++ (``csrc/mtt_ops.cpp``), built by ``native.py`` with the first
   of ``$CXX``, ``g++``, ``c++`` that compiles, its CUDA half linked to the kernel
   library (the build starts in a thread right after the kernels' and runs alongside the
   other phases; the server's NEEDED entries must name no Python); before the main
   paths, the four CUDA ops of that registration, loaded here as ``mtt_native``, each
   bit-equal to the Python op at its main-path shapes (B1f 64 x 64, B2f 8 x 512, B3f 2 x
   2100 at 16 x 80 heads; B4f 128 x 67 and 16 x 577 at 12 x 64) in fp32 and bf16; then
   the server in a subprocess on each of phase 12's packages, 192 series in batches of
   64, timed in turn with the package loaded here: its forecasts bit-equal to this
   process's package's (every timed pass bit-equal to its first, batch by batch), within
   ``AOTI_TOL`` of ``Forecaster``, 20 B1f or 16 B4f launches a batch through the C++
   registration and nothing else, its matmul flags this process's; process start and
   load seconds, series/s beside the package's (``[native]``).

The ``[profile]`` lines read ``utils/profiling.py``'s traces
(``device_profile``: the device's activity only; ``op_profile``: the host's
ops and shapes too, for ``gemm_efficiency``). The headline phase measures the
fixed cost of one fused call (a 1-epoch against the 3-epoch call of
``timesfm_mm_c32``) and the eager step's GEMM efficiency, and prints a
``[roofline]`` line (``multimodal_timesfm_torch.roofline``) beside the measured
share of the bf16 peak; the training phase prints one for ``timesfm_mm_c512``
from its bf16 fused epoch.

The ``kernels`` line lists every kernel with its launches on the main-path
phases (3 to 13; each starts its counters at 0; a kernel captured in a CUDA
graph counts once per replay; phase 11 adds its ranks' counts, phase 13 the
server's) and its
numbers at its main-path shape in bf16, and the Chronos wgmma route's and B4f's persistent
route's entries with their own counted launches; a ``[launches]`` line splits B1b's and
B4's counted launches by the route the library's plan gives each shape.

``python3 chip_smoke.py --parallel-only`` only builds the kernels, checks B4
at phase 11's 6-head shapes and runs phase 11 (making phase 10's tree
itself); ``--aoti-only`` only builds the kernels and runs phase 12;
``--native-only`` builds the kernels and the native server, checks the C++ ops and
runs phases 12 and 13. ``python3 chip_smoke.py --kernel-times [--root DIR] [--chronos-only]`` only
prints the routes and the ``[gate]`` borders (the Chronos fp32 one too) and checks and times every kernel at its
main-path shapes in fp32 and bf16 (the six causal kernels and the borders, unless
``--chronos-only``; B4f and B4b with and without dbias at 128 x 67, 128 x 67 at 6 heads,
64 x 97, 64 x 193 and 16 x 577); with DIR (another checkout, such as the parent commit's)
the library of that checkout is built too and its B1b, B2f, B2b, B3f and B3b on the same
bf16 inputs, and its B4 at every one of those shapes on the same fp32 and bf16 inputs, are
timed against this one's, in turns, in the same run (B1b and B4 held to a graph replay's
event time). ``python3 chip_smoke.py --serving-times [--root DIR]`` only
times TimesFM serving at context 512 (fp32 and bf16, seven calls each), with
the port imported from DIR when given. ``python3 chip_smoke.py
--training-times [--root DIR]`` only times three eager bf16 training cells (TimesFM
multimodal at context 512, ``chronos_mm_h32``, ``chronos_baseline_h32``: seven epochs after
two of warm-up, and one profiled epoch with the attention backward's share of busy time),
with the port imported from DIR when given. ``python3 chip_smoke.py --dispatch-times`` only times
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
# The TF32 tensor rate, dense: an fp32 product taken as three TF32 products (3xTF32, the
# Chronos kernels' route 5) runs at most at a third of it.
PEAK_TF32 = 495e12
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
CU_CHRONOS_SOURCE = "multimodal_timesfm_torch/csrc/chronos_attention.cu"
# The bf16 one-pass persistent route the dispatch gives B1b (up to 64 tokens) and B4b (up to
# 80) at their main-path shapes.
CU_SHORT_BWD_SOURCE = "multimodal_timesfm_torch/csrc/attention_bwd_short_hopper.cu"
CU_CHRONOS_SHORT_BWD_SOURCE = "multimodal_timesfm_torch/csrc/chronos_attention_bwd_short_hopper.cu"
# The bf16 one-pass persistent route the dispatch gives B4f up to 128 tokens at head_dim 64.
CU_CHRONOS_SHORT_FWD_SOURCE = "multimodal_timesfm_torch/csrc/chronos_attention_short_hopper.cu"
# The bf16 one-pass persistent route the dispatch gives B1f (and B2f) up to 64 tokens at
# head_dim 80.
CU_SHORT_FWD_SOURCE = "multimodal_timesfm_torch/csrc/attention_fwd_short_hopper.cu"
# The bf16 wgmma/TMA route the dispatch gives B2 and B3 at their main-path shapes.
CU_HOPPER_SOURCE = "multimodal_timesfm_torch/csrc/attention_fwd_hopper.cu"
CU_HOPPER_BWD_SOURCE = "multimodal_timesfm_torch/csrc/attention_bwd_hopper.cu"
# The bf16 wgmma/TMA route the dispatch gives B4f and B4b at head_dim 64 past the Chronos
# borders (Chronos-2 serving at contexts 2048 and 8192, the c8192 fine-tune).
CU_CHRONOS_HOPPER_SOURCE = "multimodal_timesfm_torch/csrc/chronos_attention_hopper.cu"
CU_CHRONOS_HOPPER_BWD_SOURCE = "multimodal_timesfm_torch/csrc/chronos_attention_bwd_hopper.cu"
# The fp32 3xTF32 route on mma.sync (plan route 5): routes 6 and 7 take every fp32 call at head_dim
# 64 that Chronos-2's main paths make (67, 80 and 97 tokens; 193 and 577 forward, 577 backward), so it
# keeps the lengths between their borders (the forward below 17 and at 113-159 tokens, the backward
# at 81-384) and the override "tf32 mma.sync", no main-path launch, and no row of its own in the
# kernels line; the [gate] lines and kernel_times (with --root, the parent's side) still time it.
CU_CHRONOS_TF32_SOURCE = "multimodal_timesfm_torch/csrc/chronos_attention_tf32.cu"
CU_CHRONOS_TF32_BWD_SOURCE = "multimodal_timesfm_torch/csrc/chronos_attention_bwd_tf32.cu"
# Route 7, the 3xTF32 route on wgmma fed by TMA the dispatch gives fp32 B4f and B4b at head_dim 64
# from its borders (_kernels.CHRONOS_TF32_WGMMA_FROM), and its rows of the kernels line:
# Chronos-2 serving at context 8192 and its fp32 fine-tunes there (577 tokens; B4b with dbias in
# baseline mode).
CU_CHRONOS_TF32W_SOURCE = "multimodal_timesfm_torch/csrc/chronos_attention_tf32_hopper.cu"
CU_CHRONOS_TF32W_BWD_SOURCE = "multimodal_timesfm_torch/csrc/chronos_attention_bwd_tf32_hopper.cu"
TF32W_CHRONOS_KERNELS = (
    ("B4f", "fused_chronos_attention", CU_CHRONOS_TF32W_SOURCE,
     "multimodal_timesfm_tpu/ops/chronos_attention.py:120", (16, 577, 12, 64)),
    ("B4b", "fused_chronos_attention_bwd", CU_CHRONOS_TF32W_BWD_SOURCE,
     "multimodal_timesfm_tpu/ops/chronos_attention.py:144", (16, 577, 12, 64)),
)
# Route 6, the persistent 3xTF32 route fed by TMA the dispatch gives fp32 B4f and B4b at head_dim
# 64 up to their borders (_kernels.CHRONOS_TF32_SHORT_TO), and its rows of the kernels line, at
# Chronos-2's fine-tune (67 tokens) in fp32.
CU_CHRONOS_TF32_SHORT_SOURCE = "multimodal_timesfm_torch/csrc/chronos_attention_short_tf32.cu"
CU_CHRONOS_TF32_SHORT_BWD_SOURCE = "multimodal_timesfm_torch/csrc/chronos_attention_bwd_short_tf32.cu"
TF32_PERSISTENT_KERNELS = (
    ("B4f", "fused_chronos_attention", CU_CHRONOS_TF32_SHORT_SOURCE,
     "multimodal_timesfm_tpu/ops/chronos_attention.py:120", (128, 67, 12, 64)),
    ("B4b", "fused_chronos_attention_bwd", CU_CHRONOS_TF32_SHORT_BWD_SOURCE,
     "multimodal_timesfm_tpu/ops/chronos_attention.py:144", (128, 67, 12, 64)),
)
# The fp32 3xTF32 route the dispatch gives the causal kernels at head_dim 80 (route 4), and its
# rows of the kernels line: (key, wrapper, source, TPU kernel, a shape it is timed at in fp32:
# B1f at serving contexts 2048 and 6144 (64 and 192 tokens), B1b at training contexts 512 and
# 2048, B2 at 16384, B3 at 67,200).
CU_TF32_SOURCE = "multimodal_timesfm_torch/csrc/attention_fwd_tf32.cu"
CU_TF32_BWD_SOURCE = "multimodal_timesfm_torch/csrc/attention_bwd_tf32.cu"
# Route 5, the causal kernels' fp32 3xTF32 route on wgmma fed by TMA, which the dispatch gives
# head_dim 80 from the border its [gate] causal fp32 lines set: a CAUSAL_TF32_KERNELS row whose
# shape the rule sends there is reported with these sources.
CU_TF32W_SOURCE = "multimodal_timesfm_torch/csrc/attention_fwd_tf32_hopper.cu"
CU_TF32W_BWD_SOURCE = "multimodal_timesfm_torch/csrc/attention_bwd_tf32_hopper.cu"
# CAUSAL_TF32_KERNELS rows timed but given no entry of their own in the kernels line: no main path
# serves TimesFM in fp32 at 192 tokens (context 6144), so B1f's wrapper never launches route 5
# there; that kernel's main-path launches stand under B2f and B3f.
CAUSAL_TF32_TIMED_ONLY = (("B1f", (64, 192, 16, 80)),)
CAUSAL_TF32_KERNELS = (
    ("B1f", "fused_qkv_causal_attention", CU_TF32_SOURCE, "multimodal_timesfm_tpu/ops/qkv_attention.py:111",
     (64, 64, 16, 80)),
    ("B1f", "fused_qkv_causal_attention", CU_TF32_SOURCE, "multimodal_timesfm_tpu/ops/qkv_attention.py:111",
     (64, 192, 16, 80)),
    ("B1b", "fused_qkv_causal_attention_bwd", CU_TF32_BWD_SOURCE,
     "multimodal_timesfm_tpu/ops/qkv_attention.py:141", (256, 16, 16, 80)),
    ("B1b", "fused_qkv_causal_attention_bwd", CU_TF32_BWD_SOURCE,
     "multimodal_timesfm_tpu/ops/qkv_attention.py:141", (64, 64, 16, 80)),
    ("B2f", "fused_causal_attention", CU_TF32_SOURCE, "multimodal_timesfm_tpu/ops/attention.py:174",
     (8, 512, 16, 80)),
    ("B2b", "fused_causal_attention_bwd", CU_TF32_BWD_SOURCE, "multimodal_timesfm_tpu/ops/attention.py:189",
     (16, 512, 16, 80)),
    ("B3f", "flash_causal_attention", CU_TF32_SOURCE, "multimodal_timesfm_tpu/ops/attention.py:322",
     (2, 2100, 16, 80)),
    ("B3b", "flash_causal_attention_bwd", CU_TF32_BWD_SOURCE, "multimodal_timesfm_tpu/ops/attention.py:322",
     (2, 2100, 16, 80)),
)
# The Chronos wgmma route's rows of the kernels line: (key, wrapper, source, TPU kernel,
# the route's main-path shape: serving and fine-tuning at context 8192, 577 tokens).
CHRONOS_WGMMA_KERNELS = (
    ("B4f", "fused_chronos_attention", CU_CHRONOS_HOPPER_SOURCE,
     "multimodal_timesfm_tpu/ops/chronos_attention.py:120", (16, 577, 12, 64)),
    ("B4b", "fused_chronos_attention_bwd", CU_CHRONOS_HOPPER_BWD_SOURCE,
     "multimodal_timesfm_tpu/ops/chronos_attention.py:144", (16, 577, 12, 64)),
)
# Every kernel of the port: (key, wrapper, CUDA source of the route its main-path shape
# takes in bf16, the TPU kernel it replaces, (B, S, H, D) of that shape).
# B1f at serving context 2048 (64 tokens, batch 64) and B2f at context 16384
# (512 tokens, batch 8); B1b at training context 512 (16 tokens, batch 256)
# and B2b at context 16384 (512 tokens, batch 16); B3 at context 67,200
# (2,100 tokens, batch 2); B4 at Chronos-2's fine-tune (67 tokens, batch 128).
KERNELS = (
    ("B1f", "fused_qkv_causal_attention", CU_SHORT_FWD_SOURCE,
     "multimodal_timesfm_tpu/ops/qkv_attention.py:111", (64, 64, 16, 80)),
    ("B1b", "fused_qkv_causal_attention_bwd", CU_SHORT_BWD_SOURCE,
     "multimodal_timesfm_tpu/ops/qkv_attention.py:141", (256, 16, 16, 80)),
    ("B2f", "fused_causal_attention", CU_HOPPER_SOURCE,
     "multimodal_timesfm_tpu/ops/attention.py:174", (8, 512, 16, 80)),
    ("B2b", "fused_causal_attention_bwd", CU_HOPPER_BWD_SOURCE,
     "multimodal_timesfm_tpu/ops/attention.py:189", (16, 512, 16, 80)),
    ("B3f", "flash_causal_attention", CU_HOPPER_SOURCE,
     "multimodal_timesfm_tpu/ops/attention.py:322", (2, 2100, 16, 80)),
    ("B3b", "flash_causal_attention_bwd", CU_HOPPER_BWD_SOURCE,
     "multimodal_timesfm_tpu/ops/attention.py:322", (2, 2100, 16, 80)),
    ("B4f", "fused_chronos_attention", CU_CHRONOS_SHORT_FWD_SOURCE,
     "multimodal_timesfm_tpu/ops/chronos_attention.py:120", (128, 67, 12, 64)),
    ("B4b", "fused_chronos_attention_bwd", CU_CHRONOS_SHORT_BWD_SOURCE,
     "multimodal_timesfm_tpu/ops/chronos_attention.py:144", (128, 67, 12, 64)),
)
KERNELS_BY_KEY = tuple((key, shape) for key, _, _, _, shape in KERNELS)
# The persistent route's rows of the kernels line that KERNELS does not already give a route
# of their own: B4f's and B1f's (key, wrapper, source, TPU kernel, the route's main-path shape:
# B1f at serving context 512, 16 tokens in batches of 64).
PERSISTENT_KERNELS = (
    ("B4f", "fused_chronos_attention", CU_CHRONOS_SHORT_FWD_SOURCE,
     "multimodal_timesfm_tpu/ops/chronos_attention.py:120", (128, 67, 12, 64)),
    ("B1f", "fused_qkv_causal_attention", CU_SHORT_FWD_SOURCE,
     "multimodal_timesfm_tpu/ops/qkv_attention.py:111", (64, 16, 16, 80)),
)
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


def persistent_route_entries(rows: dict[str, dict], routes: dict[str, int]) -> list[dict]:
    """The ``kernels`` line's entries of PERSISTENT_KERNELS: this process's counted launches on
    the persistent route (``routes``, from route_launches) and the measured row at the route's
    main-path shape in bf16."""
    entries = []
    for key, name, cu, replaces, shape in PERSISTENT_KERNELS:
        batch, seq, heads, dim = shape
        entries.append({
            "name": f"{name} (persistent route)", "route": "cuda", "source": cu, "replaces": replaces,
            "launches": routes.get(f"{key} persistent", 0),
            "shape": f"B={batch} S={seq} H={heads} D={dim} bfloat16",
            **rows[row_key(key, shape, torch.bfloat16)],
        })
    return entries


def wgmma_route_entries(rows: dict[str, dict], routes: dict[str, int]) -> list[dict]:
    """The ``kernels`` line's entries of the Chronos wgmma route (CHRONOS_WGMMA_KERNELS):
    this process's counted launches on that route (``routes``, from route_launches) and the
    measured row at the route's main-path shape in bf16."""
    entries = []
    for key, name, cu, replaces, shape in CHRONOS_WGMMA_KERNELS:
        batch, seq, heads, dim = shape
        entries.append({
            "name": f"{name} (wgmma route)", "route": "cuda", "source": cu, "replaces": replaces,
            "launches": routes.get(f"{key} wgmma", 0),
            "shape": f"B={batch} S={seq} H={heads} D={dim} bfloat16",
            **rows[row_key(key, shape, torch.bfloat16)],
        })
    return entries


def tf32w_chronos_entries(rows: dict[str, dict], routes: dict[str, int]) -> list[dict]:
    """The ``kernels`` line's entries of route 7 (TF32W_CHRONOS_KERNELS): this process's counted
    launches on that route (``routes``, from route_launches) and the measured row at the route's
    main-path shape in fp32."""
    entries = []
    for key, name, cu, replaces, shape in TF32W_CHRONOS_KERNELS:
        batch, seq, heads, dim = shape
        entries.append({
            "name": f"{name} (3xTF32 wgmma route)", "route": "cuda", "source": cu, "replaces": replaces,
            "launches": routes.get(f"{key} tf32 wgmma", 0),
            "shape": f"B={batch} S={seq} H={heads} D={dim} float32",
            **rows[row_key(key, shape, torch.float32)],
        })
    return entries


def tf32_persistent_entries(rows: dict[str, dict], routes: dict[str, int]) -> list[dict]:
    """The ``kernels`` line's entries of route 6 (TF32_PERSISTENT_KERNELS): this process's
    counted launches on that route (``routes``, from route_launches) and the measured row at the
    route's main-path shape in fp32."""
    entries = []
    for key, name, cu, replaces, shape in TF32_PERSISTENT_KERNELS:
        batch, seq, heads, dim = shape
        entries.append({
            "name": f"{name} (3xTF32 persistent route)", "route": "cuda", "source": cu,
            "replaces": replaces, "launches": routes.get(f"{key} tf32 persistent", 0),
            "shape": f"B={batch} S={seq} H={heads} D={dim} float32",
            **rows[row_key(key, shape, torch.float32)],
        })
    return entries


def causal_f32_label(key: str, seq: int) -> str:
    """The route label (of B1_ROUTES) the library's rule gives causal kernel ``key`` in fp32
    at S = ``seq``, head_dim 80: "tf32 wgmma" (route 5) or "tf32" (route 4)."""
    from multimodal_timesfm_torch.ops import _kernels

    return B1_ROUTES[_kernels.attention_route_number(key.endswith("b"), torch.float32, seq, 80)]


def causal_tf32_entries(rows: dict[str, dict], routes: dict[str, int]) -> list[dict]:
    """The ``kernels`` line's entries of the causal fp32 routes (CAUSAL_TF32_KERNELS), each row
    on the route the rule gives its shape (route 5, 3xTF32 wgmma, from the border; route 4,
    3xTF32 mma.sync, below it): this process's counted launches on that route (``routes``, from
    route_launches; one count a kernel and route, beside each of its shapes) and the measured
    row at the shape in fp32 (a route-5 row with route 4's time in the same run)."""
    entries = []
    for key, name, cu, replaces, shape in CAUSAL_TF32_KERNELS:
        if (key, shape) in CAUSAL_TF32_TIMED_ONLY:
            continue
        batch, seq, heads, dim = shape
        label = causal_f32_label(key, seq)
        if label == "tf32 wgmma":
            cu = CU_TF32W_BWD_SOURCE if key.endswith("b") else CU_TF32W_SOURCE
        entries.append({
            "name": f"{name} ({'3xTF32 wgmma route' if label == 'tf32 wgmma' else '3xTF32 route'})",
            "route": "cuda", "source": cu, "replaces": replaces,
            "launches": routes.get(f"{key} {label}", 0),
            "shape": f"B={batch} S={seq} H={heads} D={dim} float32",
            **rows[row_key(key, shape, torch.float32)],
        })
    return entries


# The SASS instructions sass_mma_report counts per kernel family: mma.sync's (HMMA; among
# them m16n8k8 on TF32 operands, HMMA.1688.F32.TF32), wgmma's (HGMMA; among them those on TF32
# operands, an HGMMA line naming TF32) and TMA's tile loads (UTMALDG).
SASS_TF32 = "HMMA.1688.F32.TF32"
SASS_GMMA_TF32 = "HGMMA.TF32"
SASS_OPS = ("HMMA", "HGMMA", "UTMALDG", SASS_TF32, SASS_GMMA_TF32)
# The kernel families of the wgmma route, which must hold HGMMA and UTMALDG.
WGMMA_FAMILIES = ("attention_fwd_wgmma_kernel", "attention_bwd_rows_kernel",
                  "attention_bwd_dkdv_wgmma_kernel", "chronos_fwd_wgmma_kernel",
                  "chronos_bwd_rows_kernel", "chronos_bwd_dkdv_wgmma_kernel",
                  "chronos_bwd_dbias_wgmma_kernel")
# The kernel families of the persistent one-pass route (mma.sync fed by TMA: the backwards',
# B4f's and B1f's), which must hold HMMA and UTMALDG.
PERSISTENT_FAMILIES = ("attention_bwd_short_kernel", "chronos_bwd_short_kernel", "chronos_fwd_short_kernel",
                       "attention_fwd_short_kernel")
# The kernel families of the Chronos 3xTF32 route that take products, which must hold
# HMMA.1688.F32.TF32 (its dbias kernel only sums dL over the batch), and the causal route's.
TF32_FAMILIES = ("chronos_fwd_tf32_kernel", "chronos_bwd_dq_tf32_kernel", "chronos_bwd_dkdv_tf32_kernel")
# The kernel families of route 6 (the Chronos fp32 kernels' persistent route, mma.sync fed by
# TMA), which must hold HMMA.1688.F32.TF32 and UTMALDG.
TF32_PERSISTENT_FAMILIES = ("chronos_fwd_short_tf32_kernel", "chronos_bwd_short_tf32_kernel")
CAUSAL_TF32_FAMILIES = ("attention_fwd_tf32_kernel", "attention_bwd_dq_tf32_kernel", "attention_bwd_dkdv_tf32_kernel")
# The kernel families of route 5, which must hold HGMMA on TF32 operands and UTMALDG, and spill
# nothing; and those of the Chronos kernels' route 7, held to the same.
TF32W_FAMILIES = ("attention_fwd_tf32w_kernel", "attention_bwd_rows_tf32w_kernel", "attention_bwd_dkdv_tf32w_kernel")
TF32W_CHRONOS_FAMILIES = ("chronos_fwd_tf32w_kernel", "chronos_bwd_rows_tf32w_kernel", "chronos_bwd_dkdv_tf32w_kernel")


def sass_counts(lib_path) -> dict[str, list[dict[str, int]]] | None:
    """Per kernel family of the library, from ``cuobjdump -sass``: for each compiled
    instantiation, how many of each of :data:`SASS_OPS` it holds. None when the toolkit
    has no cuobjdump."""
    import re
    from pathlib import Path

    from multimodal_timesfm_torch.ops import _kernels

    tool = Path(_kernels.nvcc_path()).with_name("cuobjdump")
    if not tool.is_file():
        return None
    out = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True)
    counts: dict[str, list[dict[str, int]]] = {}
    family = None
    for line in out.stdout.splitlines():
        found = re.search(r"Function : \S*?(\d+)((?:chronos|attention)_\w*?kernel)", line)
        if found:
            family = found.group(2)
            counts.setdefault(family, []).append(dict.fromkeys(SASS_OPS, 0))
        elif family is not None:
            op = re.search(r"\b(HMMA|HGMMA|UTMALDG)\b", line)
            if op:
                counts[family][-1][op.group(1)] += 1
            if SASS_TF32 in line:
                counts[family][-1][SASS_TF32] += 1
            if "HGMMA" in line and "TF32" in line:
                counts[family][-1][SASS_GMMA_TF32] += 1
    return counts


def sass_mma_report(lib_path, require_wgmma: bool = True) -> list[str]:
    """One line per kernel family of the library: how many of its compiled instantiations
    hold tensor-core instructions of mma.sync (HMMA) and of wgmma (HGMMA) and TMA tile
    loads (UTMALDG), and the fewest they hold. With ``require_wgmma`` (a library of this
    checkout), raises if a family of the wgmma route is missing or holds no HGMMA or no
    UTMALDG, a family of the persistent route no HMMA or no UTMALDG, a family of the
    3xTF32 route no HMMA.1688.F32.TF32, one of route 6 no HMMA.1688.F32.TF32 or no UTMALDG,
    or one of route 5 or route 7 no HGMMA on TF32 operands or no UTMALDG; a line naming no
    tool when the toolkit has no cuobjdump."""
    counts = sass_counts(lib_path)
    if counts is None:
        return ["no cuobjdump: SASS not read"]
    lines = []
    for name, found in sorted(counts.items()):
        parts = [f"{sum(c[op] > 0 for c in found)} of {len(found)} instantiations run {op} "
                 f"(fewest {min(c[op] for c in found)})" for op in SASS_OPS]
        lines.append(f"{name}: " + ", ".join(parts))
    for name in WGMMA_FAMILIES if require_wgmma else ():
        found = counts.get(name, [])
        if not found or any(c["HGMMA"] == 0 or c["UTMALDG"] == 0 for c in found):
            raise AssertionError(f"SASS: {name} does not run HGMMA and UTMALDG in every instantiation: {found}")
    for name in PERSISTENT_FAMILIES if require_wgmma else ():
        found = counts.get(name, [])
        if not found or any(c["HMMA"] == 0 or c["UTMALDG"] == 0 for c in found):
            raise AssertionError(f"SASS: {name} does not run HMMA and UTMALDG in every instantiation: {found}")
    for name in TF32_FAMILIES + CAUSAL_TF32_FAMILIES if require_wgmma else ():
        found = counts.get(name, [])
        if not found or any(c[SASS_TF32] == 0 for c in found):
            raise AssertionError(f"SASS: {name} does not run {SASS_TF32} in every instantiation: {found}")
    for name in TF32_PERSISTENT_FAMILIES if require_wgmma else ():
        found = counts.get(name, [])
        if not found or any(c[SASS_TF32] == 0 or c["UTMALDG"] == 0 for c in found):
            raise AssertionError(f"SASS: {name} does not run {SASS_TF32} and UTMALDG in every "
                                 f"instantiation: {found}")
    for name in TF32W_FAMILIES + TF32W_CHRONOS_FAMILIES if require_wgmma else ():
        found = counts.get(name, [])
        if not found or any(c[SASS_GMMA_TF32] == 0 or c["UTMALDG"] == 0 for c in found):
            raise AssertionError(f"SASS: {name} does not run HGMMA on TF32 operands and UTMALDG in every "
                                 f"instantiation: {found}")
    return lines


def ptxas_report(log_text: str, require: bool = True) -> list[str]:
    """From nvcc's ``-Xptxas=-v`` log of the library: for each kernel of route 5
    (TF32W_FAMILIES) and of route 7 (TF32W_CHRONOS_FAMILIES) its spill stores and loads and its
    registers, and any warning of ptxas's (C7510-C7520: wgmma serialised) that names one, one line
    each, led by the route; raises when ``require`` and one spills. (The dynamic shared memory a
    block takes is the library's to report.)"""
    import re

    def route(name: str) -> str | None:
        if any(f in name for f in TF32W_FAMILIES):
            return "route 5"
        return "route 7" if any(f in name for f in TF32W_CHRONOS_FAMILIES) else None

    lines, entry = [], None
    for line in log_text.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            entry = found.group(1)
            continue
        warned = re.search(r"\((C75[01]\d|C7520)\).*function '(\S+)'", line)
        if warned and route(warned.group(2)):
            lines.append(f"{route(warned.group(2))} {warned.group(2)}: {line.strip()}")
            continue
        if entry is None or route(entry) is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            if require and (int(spill.group(1)) or int(spill.group(2))):
                raise AssertionError(f"ptxas: {entry} spills: {line.strip()}")
            lines.append(f"{route(entry)} {entry}: {line.strip()}")
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            lines.append(f"{route(entry)} {entry}: {line.strip()}")
    return lines


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


def graph_ms(fn, iters: int) -> float:
    """Mean time per call of ``fn`` between two CUDA events around the replay of one CUDA
    graph of ``iters`` calls: no host cost between the launches, and no kernel left out."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


# A profiler reading below this share of its graph-replay reading has kernels missing from
# the trace (one such trace read 0.3072 ms of B3b against an event time of 0.5332 ms on an
# H100 80GB HBM3 at 700 W), and the event reading stands.
HELD_SHARE = 0.95


def held_ms(fn, iters: int) -> tuple[float, float, float, float]:
    """(reading, device ms, event ms, graph ms) per call of ``fn``: the device time from the
    profiler held to the CUDA-event time of a graph replay of the same calls
    (:func:`graph_ms`); the reading is the device time unless it falls below HELD_SHARE of
    the graph's event time."""
    device, event = device_ms(fn, iters)
    graph = graph_ms(fn, iters)
    return (device if device >= HELD_SHARE * graph else graph), device, event, graph


def left_padded_valid(batch: int, seq: int, gen: torch.Generator) -> torch.Tensor:
    """(B, S) bool key mask, row b valid from a random pad length in [0, S/2); row 0 unpadded."""
    pads = torch.randint(0, seq // 2, (batch,), generator=gen, device="cuda")
    pads[0] = 0
    return torch.arange(seq, device="cuda")[None, :] >= pads[:, None]


def ops_time(flops: int, dtype: torch.dtype, three_tf32: bool) -> float:
    """Seconds for ``flops`` at the card's peak for ``dtype``; with ``three_tf32`` (fp32 work
    taken as 3xTF32 on the tensor cores) three TF32 products for each fp32 one at the TF32 rate
    (PEAK_TF32) in place of the CUDA cores' fp32 rate."""
    return 3 * flops / PEAK_TF32 if three_tf32 else flops / PEAK_FLOPS[dtype]


def attention_bound(batch: int, seq: int, heads: int, dim: int, valid: torch.Tensor,
                    dtype: torch.dtype, three_tf32: bool = False) -> tuple[float, str]:
    """Least time for causal key-padded attention: max(bytes / HBM rate, flops / peak), the peak
    as :func:`ops_time` takes it.

    Bytes: q, k, v and the mask read once, the output written once. Flops:
    QK^T and PV over the (row, key) pairs this mask needs (key valid, key <= row).
    """
    elt = torch.finfo(dtype).bits // 8
    nbytes = 4 * batch * seq * heads * dim * elt + batch * seq
    rows_per_key = torch.arange(seq, 0, -1, device=valid.device)
    pairs = int((valid * rows_per_key).sum())
    flops = 4 * dim * heads * pairs
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops_time(flops, dtype, three_tf32)
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
                library_name: str, held: bool = False) -> dict:
    """Device and event times of a kernel, its plain version and the library yardstick; the
    row of the ``kernels`` line, with ``err`` (checked against ``tol``) and the bound. With
    ``held`` the kernel's device time is held to a graph replay's event time (held_ms)."""
    batch, seq, heads, dim = shape
    bound_ms, bound_by = bound
    if held:
        ms, device, ms_ev, graph = held_ms(kernel, iters)
        print(f"[kernels] {name} B={batch} S={seq} held: device {device:.4f} ms, graph replay {graph:.4f} ms"
              f"{'' if ms == device else ' (the trace left kernels out: the event time stands)'}",
              flush=True)
    else:
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


def causal_tf32(backward: bool, dtype: torch.dtype, shape: tuple[int, int, int, int]) -> bool:
    """Whether the causal kernels' dispatch gives this call a 3xTF32 route (route 4 on
    mma.sync, route 5 on wgmma)."""
    from multimodal_timesfm_torch.ops import _kernels

    return dtype == torch.float32 and _kernels.attention_route_number(backward, dtype, shape[1], shape[3]) in (4, 5)


def mma_sync_row(row: dict, what: str, backward: bool, kernel, plain_out, compare_fn,
                 shape: tuple[int, int, int, int], iters: int) -> dict:
    """A row of route 5 (3xTF32 wgmma) with route 4 (3xTF32 mma.sync) beside it: that route
    checked against the plain version and timed in the same run (held_ms, the route override
    "tf32 mma.sync"). A row the rule leaves on route 4 is returned as it is."""
    from multimodal_timesfm_torch.ops import _kernels

    if _kernels.attention_route_number(backward, torch.float32, shape[1], shape[3]) != 5:
        return row
    try:
        _kernels.set_route("tf32 mma.sync")
        compare_fn(f"{what} route 4", kernel(), plain_out)
        row["mma_sync_ms"] = held_ms(kernel, iters)[0]
    finally:
        _kernels.set_route("rule")
    print(f"[kernels] {what} float32 3xTF32 wgmma route {row['ms']:.4f} ms against the 3xTF32 mma.sync route "
          f"{row['mma_sync_ms']:.4f} ms (held; {row['mma_sync_ms'] / row['ms']:.2f}x) and {row['library_ms']:.4f} ms "
          f"of the library call; bound {row['bound_ms']:.4f} ms (3xTF32)", flush=True)
    return row


def check_kernel(name: str, kernel, plain, sdpa, valid: torch.Tensor, dtype: torch.dtype,
                 shape: tuple[int, int, int, int], iters: int) -> dict:
    """Kernel vs plain version on the card; returns the measured row. On a 3xTF32 route the
    kernel's time is held (held_ms) and the bound is the 3xTF32 one; on route 5 route 4 is
    checked and timed beside it (mma_sync_row). On the bf16 persistent route the time is held
    too: a trace can leave its few-microsecond launches out (one read 0.0025 ms at 64 x 16,
    under its bound, where the same call's held readings were 0.0054 and 0.0061 ms; H100 80GB
    HBM3 at 700 W)."""
    from multimodal_timesfm_torch.ops import _kernels

    want = plain()
    diff = compare(f"{name} {shape}", kernel(), want)
    tf32 = causal_tf32(False, dtype, shape)
    held = tf32 or _kernels.attention_route_number(False, dtype, shape[1], shape[3]) == 3
    row = time_kernel(name, shape, dtype, diff, KERNEL_TOL[dtype], kernel, plain, sdpa,
                      attention_bound(*shape, valid, dtype, three_tf32=tf32), iters, "sdpa", held=held)
    if tf32:
        row = mma_sync_row(row, f"{name} {shape}", False, kernel, want, compare, shape, iters)
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
    short_forward_checks(gen)
    return rows


# B1f's persistent route (bf16, head_dim 80, up to 64 tokens) checked at every S from 8 to 64
# in steps of 8 through the fused-qkv entry point, (B, H): odd batches, TimesFM's 16 heads and
# an odd count, 5; then through the whole-sequence entry point on split (B, S, H, D) tensors, at those lengths and at lengths
# the dispatch sends there (1, 2, 5, 7, 17, 33, 63).
SHORT_FORWARD_FUSED = [(batch, seq, heads) for seq in range(8, 65, 8) for batch, heads in ((3, 16), (7, 5))]
SHORT_FORWARD_SPLIT = [(5, seq, 3) for seq in (1, 2, 5, 7, 8, 16, 17, 24, 32, 33, 40, 48, 56, 63, 64)]


def short_forward_checks(gen: torch.Generator) -> None:
    """B1f's persistent route at SHORT_FORWARD_FUSED (fused qkv) and SHORT_FORWARD_SPLIT (split q,
    k, v through ``fused_causal_attention``), bf16, head_dim 80, left-padded keys with a row past
    its first half padded (its first query rows see no valid key) and a row with no valid key at
    all: the dispatch's route 3, every element of every row within KERNEL_TOL of the plain
    version, two launches bit-equal."""
    from multimodal_timesfm_torch.ops import _kernels
    from multimodal_timesfm_torch.ops.attention import fused_causal_attention, plain_causal_attention
    from multimodal_timesfm_torch.ops.qkv_attention import fused_qkv_causal_attention, plain_qkv_causal_attention

    dtype, dim = torch.bfloat16, 80
    worst, count = 0.0, 0
    for split, cases in ((False, SHORT_FORWARD_FUSED), (True, SHORT_FORWARD_SPLIT)):
        for batch, seq, heads in cases:
            if _kernels.attention_route_number(False, dtype, seq, dim) != 3:
                raise AssertionError(f"B1f S={seq}: the dispatch's route is not the persistent one")
            pads = torch.randint(0, seq // 2 + 1, (batch,), generator=gen, device="cuda")
            pads[0], pads[1] = 0, seq // 2 + 1  # row 1's first query rows see no valid key
            valid = torch.arange(seq, device="cuda")[None, :] >= pads[:, None]
            valid[-1] = False
            if split:
                q, k, v = (torch.randn(batch, seq, heads, dim, generator=gen, device="cuda") for _ in range(3))
                q, k, v = (q / math.sqrt(dim)).to(dtype), k.to(dtype), v.to(dtype)
                fwd = lambda: fused_causal_attention(q, k, v, valid)  # noqa: E731
                ref = plain_causal_attention(q, k, v, valid)
            else:
                qkv = torch.randn(batch, seq, 3 * heads * dim, generator=gen, device="cuda")
                qkv[..., : heads * dim] /= math.sqrt(dim)
                qkv = qkv.to(dtype)
                fwd = lambda: fused_qkv_causal_attention(qkv, valid, heads, dim)  # noqa: E731
                ref = plain_qkv_causal_attention(qkv, valid, heads, dim)
            what = f"B1f persistent route B={batch} S={seq} H={heads} {'split' if split else 'fused qkv'}"
            worst = max(worst, compare(what, fwd(), ref))
            same_twice(what, fwd)
            count += 1
    print(f"[kernels] B1f persistent route at {count} shapes (fused qkv: S = 8-64 in steps of 8 at "
          f"(B, H) = (3, 16) and (7, 5); split q, k, v: S = {[c[1] for c in SHORT_FORWARD_SPLIT]} at B = 5, H "
          f"= 3; left-padded, rows with no valid key): max |kernel - plain| {worst:.3g} within KERNEL_TOL on "
          f"every element of every row; two launches bit-equal", flush=True)


def backward_bound(batch: int, seq: int, heads: int, dim: int, valid: torch.Tensor,
                   dtype: torch.dtype, three_tf32: bool = False) -> tuple[float, str]:
    """Least time for the attention backward: max(bytes / HBM rate, flops / peak), the peak as
    :func:`ops_time` takes it.

    Bytes: q, k, v and g read once, dq, dk and dv written once, the mask read
    once. Flops: QK^T, G V^T, dV = W^T G, dQ = dL K and dK = dL^T Q over the
    (row, key) pairs this mask needs (key valid, key <= row), 10 D H each.
    """
    elt = torch.finfo(dtype).bits // 8
    nbytes = 7 * batch * seq * heads * dim * elt + batch * seq
    rows_per_key = torch.arange(seq, 0, -1, device=valid.device)
    pairs = int((valid * rows_per_key).sum())
    flops = 10 * dim * heads * pairs
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops_time(flops, dtype, three_tf32)
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
    returns the measured row (on a 3xTF32 route as :func:`check_kernel` gives it)."""
    want = plain()
    diff = compare_bwd(f"{name} {shape}", kernel(), want)
    same_twice(f"{name} {shape} {dtype}", kernel)
    tf32 = causal_tf32(True, dtype, shape)
    row = time_kernel(name, shape, dtype, diff, BWD_TOL[dtype], kernel, plain, sdpa_bwd,
                      backward_bound(*shape, valid, dtype, three_tf32=tf32), iters, "sdpa backward", held=tf32)
    if tf32:
        row = mma_sync_row(row, f"{name} {shape}", True, kernel, want, compare_bwd, shape, iters)
    return row


def padded_cotangent(shape: tuple[int, ...], valid: torch.Tensor, dtype: torch.dtype,
                     gen: torch.Generator) -> torch.Tensor:
    """A random output cotangent, zero on padded query rows (as the model path leaves it)."""
    g = torch.randn(*shape, generator=gen, device="cuda")
    return (g * valid.reshape(*valid.shape, *([1] * (g.dim() - 2)))).to(dtype)


# Where dV's terms cancel: a cotangent centred over each block of DV_CANCEL_BLOCK query rows
# (the causal kernels) or over each of a row's segments (Chronos), times DV_CANCEL_SCALE. dV =
# W^T G then keeps only W's spread over those rows, while a rounding of W reaches it times
# |G|: one bf16 rounding of W leaves dV outside BWD_TOL there (in a CPU model of each route,
# tests/test_torch_port_dv_pair.py), W as a hi + lo pair keeps it inside. At each route's own
# lengths: causal 96 (the mma.sync route, B1b's entry point) and 512 (wgmma, B2b's);
# Chronos 96 (one-pass), 577 (wgmma), and head_dim 128 at 80 (tiled), 16 segments a row.
DV_CANCEL_BLOCK, DV_CANCEL_SCALE = 16, 8.0
CAUSAL_DV_CANCEL_SHAPES = ((256, 96, 16, 80), (16, 512, 16, 80))
CHRONOS_DV_CANCEL_SHAPES = ((512, 96, 12, 64), (16, 577, 12, 64), (512, 80, 4, 128))


def centred_cotangent(g: torch.Tensor, groups: torch.Tensor) -> torch.Tensor:
    """DV_CANCEL_SCALE times ``g`` (B, S, ...) less its mean over the query rows of each group:
    ``groups`` (B, S) ids, rows of one id one group. In ``g``'s dtype."""
    same = (groups[:, :, None] == groups[:, None, :]).float()
    flat = g.float().flatten(2)
    mean = torch.bmm(same, flat) / same.sum(-1, keepdim=True)
    return (DV_CANCEL_SCALE * (flat - mean)).unflatten(-1, g.shape[2:]).to(g.dtype)


def causal_dv_cancel_checks(gen: torch.Generator) -> None:
    """The causal backwards in bf16 where dV's terms cancel (CAUSAL_DV_CANCEL_SHAPES: every key
    valid, the cotangent centred over blocks of DV_CANCEL_BLOCK rows) against their plain
    versions on every element, two launches bit-equal."""
    from multimodal_timesfm_torch.ops import _kernels
    from multimodal_timesfm_torch.ops.attention import fused_causal_attention_bwd, plain_attention_bwd
    from multimodal_timesfm_torch.ops.qkv_attention import (
        fused_qkv_causal_attention_bwd,
        plain_qkv_attention_bwd,
        split_heads,
    )

    dtype = torch.bfloat16
    for batch, seq, heads, dim in CAUSAL_DV_CANCEL_SHAPES:
        qkv = torch.randn(batch, seq, 3 * heads * dim, generator=gen, device="cuda")
        qkv[..., : heads * dim] /= math.sqrt(dim)
        qkv = qkv.to(dtype)
        valid = torch.ones(batch, seq, dtype=torch.bool, device="cuda")
        blocks = (torch.arange(seq, device="cuda") // DV_CANCEL_BLOCK)[None].expand(batch, seq)
        g = centred_cotangent(torch.randn(batch, seq, heads * dim, generator=gen, device="cuda").to(dtype),
                              blocks)
        if seq <= 128:  # B1b's entry point
            bwd = lambda: fused_qkv_causal_attention_bwd(qkv, valid, g, heads, dim)  # noqa: E731
            ref = plain_qkv_attention_bwd(qkv, valid, g, heads, dim)
        else:  # B2b's
            q, k, v = (t.contiguous() for t in split_heads(qkv, heads, dim))
            g4 = g.unflatten(-1, (heads, dim))
            bwd = lambda: fused_causal_attention_bwd(q, k, v, valid, g4)  # noqa: E731
            ref = plain_attention_bwd(q, k, v, valid, g4)
        what = f"causal dV cancelling (B,S,H,D) {(batch, seq, heads, dim)}"
        err = compare_bwd(what, bwd(), ref)
        same_twice(what, bwd)
        route = _kernels.attention_route(True, dtype, seq, dim).split(",")[0]
        print(f"[kernels] {what} bf16, cotangent centred over {DV_CANCEL_BLOCK}-row blocks x "
              f"{DV_CANCEL_SCALE:g}: max |kernel - plain| {err:.3g} within BWD_TOL; two launches "
              f"bit-equal; route {route}", flush=True)


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
    causal_dv_cancel_checks(gen)
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
# (B, S, H): serving at contexts 512, 2048, 8192; the fine-tune, a sweep group, packed rows; the
# fine-tune's 12 heads over a model axis of 2.
CHRONOS_PATH_SHAPES = ((64, 97, 12), (64, 193, 12), (16, 577, 12), (128, 67, 12), (512, 67, 12), (512, 80, 12),
                       (128, 67, 6))


def print_routes() -> None:
    """The route and tiles of every kernel at its main-path shapes, fp32 and bf16, as the
    library's dispatch reports them."""
    from multimodal_timesfm_torch.ops import _kernels

    causal_short = tuple(row for row in PERSISTENT_KERNELS if not row[0].startswith("B4"))
    for key, name, _, _, (_, seq, heads, dim) in KERNELS + causal_short:
        for dtype in (torch.float32, torch.bfloat16):
            if not key.startswith("B4"):
                route = _kernels.attention_route(key.endswith("b"), dtype, seq, dim)
                print(f"[route] {key} {name} S={seq} D={dim} {str(dtype)[6:]}: {route}")
                continue
            if not hasattr(_kernels, "chronos_route"):
                continue
            for batch, path_seq, path_heads in CHRONOS_PATH_SHAPES:
                route = _kernels.chronos_route(key.endswith("b"), dtype, batch, path_seq, path_heads, dim)
                print(f"[route] {key} {name} B={batch} S={path_seq} H={path_heads} D={dim} "
                      f"{str(dtype)[6:]}: {route}")


def chronos_bound(batch: int, seq: int, heads: int, dim: int, seg: torch.Tensor,
                  dtype: torch.dtype, backward: bool, dbias: bool = False,
                  three_tf32: bool = False) -> tuple[float, str]:
    """Least time for the Chronos attention: max(bytes / HBM rate, flops / peak), the peak as
    :func:`ops_time` takes it.

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
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops_time(flops, dtype, three_tf32)
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
    from multimodal_timesfm_torch.ops import _kernels
    from multimodal_timesfm_torch.ops.chronos_attention import (
        fused_chronos_attention,
        fused_chronos_attention_bwd,
        plain_chronos_attention,
        plain_chronos_attention_bwd,
    )

    batch, seq, heads, dim = shape
    dtype = qkv.dtype
    err_f, err_b, err_db = errs

    def bound(backward: bool, dbias: bool = False) -> tuple[float, str]:
        # The bound of the route the call takes: fp32 on a 3xTF32 route (plan route 5, 6 or 7) at
        # the TF32 rate, else at the dtype's.
        tf32 = _kernels.chronos_plan(backward, dtype, batch, seq, heads, dim)["route"] in (5, 6, 7)
        return chronos_bound(*shape, seg, dtype, backward, dbias, three_tf32=tf32)

    mask = chronos_sdpa_mask(seg, bias, dtype)
    qh, kh, vh = (t.unflatten(-1, (heads, dim)).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, attn_mask=mask, scale=1.0)
    fwd = time_kernel(
        "fused_chronos_attention", shape, dtype, err_f, KERNEL_TOL[dtype],
        lambda: fused_chronos_attention(qkv, seg, bias),
        lambda: plain_chronos_attention(qkv, seg, bias), sdpa,
        bound(False), 2 * iters, "sdpa", held=True,
    )
    qd, kd, vd = (t.detach().requires_grad_() for t in (qh, kh, vh))
    out = torch.nn.functional.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask, scale=1.0)
    gh = g.unflatten(-1, (heads, dim)).transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(out, (qd, kd, vd), gh, retain_graph=True)  # noqa: E731
    sdpa_db, sdpa_db_name = sdpa_dbias_fn(qd, kd, vd, seg, bias, gh)
    # The main path's backward: multimodal mode, the bias frozen (no dbias).
    bwd = time_kernel(
        "fused_chronos_attention_bwd (no dbias)", shape, dtype, err_b, BWD_TOL[dtype],
        lambda: fused_chronos_attention_bwd(qkv, seg, bias, g, False),
        lambda: plain_chronos_attention_bwd(qkv, seg, bias, g, False), sdpa_bwd,
        bound(True), iters, "sdpa backward", held=True,
    )
    bwd_db = time_kernel(
        "fused_chronos_attention_bwd (with dbias)", shape, dtype, max(err_b, err_db), BWD_TOL[dtype],
        lambda: fused_chronos_attention_bwd(qkv, seg, bias, g, True),
        lambda: plain_chronos_attention_bwd(qkv, seg, bias, g, True), sdpa_db,
        bound(True, dbias=True), iters, sdpa_db_name,
        held=True,
    )
    if dtype == torch.float32 and _kernels.chronos_plan(True, dtype, batch, seq, heads, dim)["route"] in (5, 6, 7):
        # Beside the 3xTF32 route's bound (bound_ms), the same work's bound on the CUDA cores
        # (PEAK_FLOPS), the fp32 route the parent took.
        rows = (("B4f", fwd, False, False), ("B4b (no dbias)", bwd, True, False), ("B4b (with dbias)", bwd_db, True, True))
        parts = []
        for what, row, backward, dbias in rows:
            row["bound_cuda_cores_ms"], _ = chronos_bound(*shape, seg, dtype, backward, dbias)
            parts.append(f"{what} {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} (3xTF32, {row['bound_by']}) / "
                         f"{row['bound_cuda_cores_ms']:.4f} (CUDA cores)")
        print(f"[kernels] fp32 B={batch} S={seq} H={heads} D={dim} bounds: {'; '.join(parts)} | routes: forward "
              f"{_kernels.chronos_route(False, dtype, batch, seq, heads, dim).split(',')[0]}, backward "
              f"{_kernels.chronos_route(True, dtype, batch, seq, heads, dim).split(',')[0]}", flush=True)
    return fwd, bwd


def sdpa_dbias_fn(qd: torch.Tensor, kd: torch.Tensor, vd: torch.Tensor, seg: torch.Tensor,
                  bias: torch.Tensor, gh: torch.Tensor):
    """The yardstick of B4b with dbias: SDPA's backward on the memory-efficient backend with
    its float mask built from a bias that requires grad, so that the call also gives the
    bias's gradient (the mask's, summed over the batch). Returns (the timed call, its name);
    where the installed PyTorch refuses a mask gradient on that backend, SDPA's backward
    without it, named so, so that no row reads as a loss to a call that computes less."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaf = bias.detach().requires_grad_()
    try:
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            out = torch.nn.functional.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=chronos_sdpa_mask(seg, leaf, qd.dtype), scale=1.0)
        call = lambda: torch.autograd.grad(out, (qd, kd, vd, leaf), gh, retain_graph=True)  # noqa: E731
        call()
        return call, "sdpa backward with dbias"
    except RuntimeError as exc:
        print(f"[kernels] SDPA refuses a mask gradient on the memory-efficient backend ({exc}); "
              "the with-dbias yardstick computes no dbias", flush=True)
        out = torch.nn.functional.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=chronos_sdpa_mask(seg, bias, qd.dtype), scale=1.0)
        return (lambda: torch.autograd.grad(out, (qd, kd, vd), gh, retain_graph=True),
                "sdpa backward (no dbias)")


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


# The dtypes chronos_dv_cancel_checks runs: bf16 (the older routes' W as a hi + lo pair) and
# fp32 (the 3xTF32 route at head_dim 64, each operand split into TF32 hi + lo).
DV_CANCEL_DTYPES = (torch.bfloat16, torch.float32)


def chronos_dv_cancel_checks(gen: torch.Generator) -> None:
    """B4b in bf16 and fp32 where dV's terms cancel (CHRONOS_DV_CANCEL_SHAPES: 16 segments a row,
    the cotangent centred over each segment's rows) against its plain version on every element,
    with and without dbias, two launches bit-equal (check_chronos)."""
    from multimodal_timesfm_torch.ops import _kernels

    for dtype in DV_CANCEL_DTYPES:
        for shape in CHRONOS_DV_CANCEL_SHAPES:
            batch, seq, heads, dim = shape
            qkv, seg, bias, g = chronos_inputs(shape, 16, False, dtype, gen)
            route = _kernels.chronos_route(True, dtype, batch, seq, heads, dim).split(",")[0]
            check_chronos(f"B4 dV cancelling {shape} 16 segments, cotangent centred in each x "
                          f"{DV_CANCEL_SCALE:g} (backward: {route})", qkv, seg, bias, centred_cotangent(g, seg))


# B4f's persistent route checked at every S it is built for (bf16, head_dim 64; the rule's
# route there), at the Chronos kernel phase's cases of S <= 128 and at odd batches: fewer rows than blocks a
# head (3, 1), a range of one row per block, and batches the blocks do not divide.
PERSISTENT_FORWARD_ODD = [(3, 67, 12, 64, 3, True), (1, 5, 2, 64, 1, False), (9, 67, 12, 64, 3, True),
                          (17, 80, 12, 64, 16, False), (130, 67, 12, 64, 1, False), (7, 97, 5, 64, 3, True),
                          (11, 113, 12, 64, 1, False), (5, 128, 3, 64, 3, True)]


def persistent_forward_checks(gen: torch.Generator, cases: list[tuple]) -> None:
    """B4f on its persistent route at ``cases`` with head_dim 64 and S <= 128, and at
    PERSISTENT_FORWARD_ODD, bf16: the plan's route 4, every element within KERNEL_TOL of the
    plain version, two launches bit-equal."""
    from multimodal_timesfm_torch.ops import _kernels
    from multimodal_timesfm_torch.ops.chronos_attention import fused_chronos_attention, plain_chronos_attention

    dtype = torch.bfloat16
    worst, count = 0.0, 0
    for batch, seq, heads, dim, segments, padded in cases + PERSISTENT_FORWARD_ODD:
        if dim != 64 or seq > 128:
            continue
        shape = (batch, seq, heads, dim)
        if _kernels.chronos_plan(False, dtype, batch, seq, heads, dim)["route"] != 4:
            raise AssertionError(f"B4f {shape}: the plan's route is not the persistent one")
        qkv, seg, bias, _ = chronos_inputs(shape, segments, padded, dtype, gen)
        what = f"B4f persistent route {shape} {segments} segment(s){' padded' if padded else ''}"
        fwd = lambda: fused_chronos_attention(qkv, seg, bias)  # noqa: E731
        worst = max(worst, compare(what, fwd(), plain_chronos_attention(qkv, seg, bias)))
        same_twice(what, fwd)
        count += 1
    print(f"[kernels] B4f persistent route at {count} shapes (S <= 128, head_dim 64, bf16; odd "
          f"batches {[c[:4] for c in PERSISTENT_FORWARD_ODD]}): max |kernel - plain| {worst:.3g} within "
          f"KERNEL_TOL on every element; two launches bit-equal", flush=True)


# Route 6 (fp32, head_dim 64) checked at every S it is built for, forced by the library's override
# "tf32 persistent": B4f at S = 1-128 and B4b (with and without dbias) at S = 1-80, the batch,
# heads and segments taken in turn from these (odd batches, one of a head's blocks per row and
# fewer rows than blocks, 6 heads as on a model axis of 2, one segment, three with padded tokens,
# sixteen).
TF32_PERSISTENT_VARIANTS = ((3, 12, 1, False), (5, 6, 3, True), (17, 2, 16, False), (9, 12, 3, True),
                            (1, 6, 1, False), (130, 12, 3, True))
TF32_PERSISTENT_BUILT_TO = {"forward": 128, "backward": 80}


def tf32_persistent_checks(gen: torch.Generator) -> None:
    """Route 6 at every S it is built for (TF32_PERSISTENT_BUILT_TO), fp32, head_dim 64, forced
    by the override "tf32 persistent", the variants of TF32_PERSISTENT_VARIANTS in turn: the
    plan's route 6, every element within KERNEL_TOL of the plain forward and BWD_TOL of the plain
    backward with and without dbias, two launches bit-equal (check_chronos). Then the rule's
    route at every S against _kernels.chronos_f32_route (the Python mirror of the borders)."""
    from multimodal_timesfm_torch.ops import _kernels
    from multimodal_timesfm_torch.ops.chronos_attention import fused_chronos_attention, plain_chronos_attention

    dtype, dim = torch.float32, 64
    worst, count = [0.0, 0.0, 0.0], 0
    try:
        _kernels.set_chronos_route("tf32 persistent")
        for seq in range(1, TF32_PERSISTENT_BUILT_TO["forward"] + 1):
            batch, heads, segments, padded = TF32_PERSISTENT_VARIANTS[seq % len(TF32_PERSISTENT_VARIANTS)]
            # One token: one batch row (the wrappers' layout check cannot read a row stride there).
            batch, segments = (1, 1) if seq == 1 else (batch, min(segments, seq))
            backward = seq <= TF32_PERSISTENT_BUILT_TO["backward"]
            for d in (False, True) if backward else (False,):
                if _kernels.chronos_plan(d, dtype, batch, seq, heads, dim)["route"] != 6:
                    raise AssertionError(f"B4{'b' if d else 'f'} fp32 S={seq}: the forced route 6 is not the plan's")
            shape = (batch, seq, heads, dim)
            qkv, seg, bias, g = chronos_inputs(shape, segments, padded, dtype, gen)
            what = f"B4 route 6 {shape} {segments} segment(s){' padded' if padded else ''}"
            if backward:
                errs = check_chronos(what, qkv, seg, bias, g)
                worst = [max(w, e) for w, e in zip(worst, errs)]
            else:
                fwd = lambda: fused_chronos_attention(qkv, seg, bias)  # noqa: E731
                worst[0] = max(worst[0], compare(what, fwd(), plain_chronos_attention(qkv, seg, bias)))
                same_twice(what, fwd)
            count += 1
    finally:
        _kernels.set_chronos_route("rule")
    for seq in (*range(1, 600), *F32_WGMMA_BORDER_LENGTHS):
        for d in (False, True):
            route = _kernels.chronos_plan(d, dtype, 64, seq, 12, dim)["route"]
            if route != _kernels.chronos_f32_route(d, seq, dim):
                raise AssertionError(f"B4{'b' if d else 'f'} fp32 S={seq}: the rule gives route {route}, "
                                     f"chronos_f32_route {_kernels.chronos_f32_route(d, seq, dim)}")
    print(f"[kernels] route 6 (fp32 3xTF32 persistent, forced) at S = 1-{TF32_PERSISTENT_BUILT_TO['forward']} "
          f"(backward 1-{TF32_PERSISTENT_BUILT_TO['backward']}), {count} shapes, variants "
          f"{list(TF32_PERSISTENT_VARIANTS)}: max |kernel - plain| forward {worst[0]:.3g}, dqkv {worst[1]:.3g}, "
          f"dbias {worst[2]:.3g}, within tolerance on every element; two launches bit-equal; the rule's route "
          f"at S = 1-599 and 1,025 as chronos_f32_route gives it (route 6 forward at "
          f"{_kernels.CHRONOS_TF32_SHORT_FROM['forward']}-{_kernels.CHRONOS_TF32_SHORT_TO['forward']}, backward "
          f"up to {_kernels.CHRONOS_TF32_SHORT_TO['backward']}; past them route 7 from "
          f"{_kernels.CHRONOS_TF32_WGMMA_FROM['forward']} / {_kernels.CHRONOS_TF32_WGMMA_FROM['backward']})",
          flush=True)


# Route 7 (fp32, head_dim 64) checked forced by the library's override "tf32 wgmma" at the lengths
# around its borders and its tiles' edges (81, 96, 97, 113, 128 = two 64-row warpgroups, 129: a
# block whose second warpgroup's rows all lie past S, 193, 577 = 18 x 32 + 1, 1,025), the batch,
# heads and segments taken in turn from these (odd batches, 12 heads and 6 as on a model axis of 2,
# one segment, three with padded tokens).
TF32W_LENGTHS = (81, 96, 97, 113, 128, 129, 193, 577, 1025)
TF32W_VARIANTS = ((3, 12, 1, False), (5, 6, 3, True), (2, 12, 3, True), (7, 6, 1, False))
# C4: rows past S in the last 32-row query tile, with the last bias row past where exp overflows
# (88): (B, S, H, D), and what is added to that row.
TF32W_LASTROW_SHAPE, TF32W_LASTROW_BIAS = (3, 577, 12, 64), 100.0


def tf32w_checks(gen: torch.Generator) -> None:
    """Route 7 at TF32W_LENGTHS, fp32, head_dim 64, forced by the override "tf32 wgmma", the
    variants of TF32W_VARIANTS in turn, then at TF32W_LASTROW_SHAPE with TF32W_LASTROW_BIAS added
    to the last bias row (C4: the rows past S that the dK/dV kernel reads): the plan's route 7
    both ways, every element finite and within KERNEL_TOL of the plain forward and BWD_TOL of the
    plain backward with and without dbias, two launches bit-equal (check_chronos)."""
    from multimodal_timesfm_torch.ops import _kernels

    dtype, dim = torch.float32, 64
    worst, shapes = [0.0, 0.0, 0.0], []
    try:
        _kernels.set_chronos_route("tf32 wgmma")
        for i, seq in enumerate(TF32W_LENGTHS):
            batch, heads, segments, padded = TF32W_VARIANTS[i % len(TF32W_VARIANTS)]
            for d in (False, True):
                if _kernels.chronos_plan(d, dtype, batch, seq, heads, dim)["route"] != 7:
                    raise AssertionError(f"B4{'b' if d else 'f'} fp32 S={seq}: the forced route 7 is not the plan's")
            shape = (batch, seq, heads, dim)
            qkv, seg, bias, g = chronos_inputs(shape, segments, padded, dtype, gen)
            errs = check_chronos(f"B4 route 7 {shape} {segments} segment(s){' padded' if padded else ''}",
                                 qkv, seg, bias, g)
            worst = [max(w, e) for w, e in zip(worst, errs)]
            shapes.append(shape)
        shape = TF32W_LASTROW_SHAPE
        qkv, seg, bias, g = chronos_inputs(shape, 1, False, dtype, gen)
        bias[:, -1] += TF32W_LASTROW_BIAS
        errs = check_chronos(f"B4 route 7 {shape} last bias row + {TF32W_LASTROW_BIAS:g}", qkv, seg, bias, g)
        worst = [max(w, e) for w, e in zip(worst, errs)]
        shapes.append(shape)
    finally:
        _kernels.set_chronos_route("rule")
    print(f"[kernels] route 7 (fp32 3xTF32 wgmma, forced) at {shapes}: max |kernel - plain| forward "
          f"{worst[0]:.3g}, dqkv {worst[1]:.3g}, dbias {worst[2]:.3g}, within tolerance on every element; two "
          f"launches bit-equal", flush=True)


# C3: more than kGridRows = 65,535 batch rows, which the entry points run in chunks. Each kernel
# family at its shortest main-path length: (key, (B, S, H, D)).
CHUNKED_BATCH = 65537
BATCH_CHUNK_SHAPES = (("B1", (CHUNKED_BATCH, 16, 1, 80)), ("B2", (CHUNKED_BATCH, 16, 1, 80)),
                      ("B3", (CHUNKED_BATCH, 16, 1, 80)), ("B4", (CHUNKED_BATCH, 16, 1, 64)))


def batch_chunk_checks(seed: int) -> None:
    """C3: B1 (fused qkv), B2 and B3 (split q, k, v; the same entry points) and B4 (with and
    without dbias), forward and backward, bf16 and fp32, at 65,537 batch rows (two chunks),
    against their plain versions on every element; two backward launches bit-equal."""
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
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 21)
    split = {"B2": (fused_causal_attention, fused_causal_attention_bwd),
             "B3": (flash_causal_attention, flash_causal_attention_bwd)}
    for dtype in (torch.float32, torch.bfloat16):
        for key, shape in BATCH_CHUNK_SHAPES:
            batch, seq, heads, dim = shape
            what = f"C3 {key} {shape} {str(dtype)[6:]}"
            if key == "B4":
                qkv, seg, bias, g = chronos_inputs(shape, 3, True, dtype, gen)
                errs = check_chronos(what, qkv, seg, bias, g)
                print(f"[kernels] {what}: forward {errs[0]:.3g}, dqkv {errs[1]:.3g}, dbias {errs[2]:.3g}", flush=True)
                del qkv, seg, bias, g
                continue
            qkv = torch.randn(batch, seq, 3 * heads * dim, generator=gen, device="cuda")
            qkv[..., : heads * dim] /= math.sqrt(dim)
            qkv = qkv.to(dtype)
            valid = left_padded_valid(batch, seq, gen)
            g = padded_cotangent((batch, seq, heads * dim), valid, dtype, gen)
            if key == "B1":
                fwd = lambda: fused_qkv_causal_attention(qkv, valid, heads, dim)  # noqa: E731
                ref = plain_qkv_causal_attention(qkv, valid, heads, dim)
                bwd = lambda: fused_qkv_causal_attention_bwd(qkv, valid, g, heads, dim)  # noqa: E731
                ref_b = plain_qkv_attention_bwd(qkv, valid, g, heads, dim)
            else:
                q, k, v = (t.unflatten(-1, (heads, dim)) for t in qkv.chunk(3, dim=-1))
                g4 = g.unflatten(-1, (heads, dim))
                fwd = lambda: split[key][0](q, k, v, valid)  # noqa: E731
                ref = plain_causal_attention(q, k, v, valid)
                bwd = lambda: split[key][1](q, k, v, valid, g4)  # noqa: E731
                ref_b = plain_attention_bwd(q, k, v, valid, g4)
            err_f = compare(f"{what} forward", fwd(), ref)
            err_b = compare_bwd(f"{what} backward", bwd(), ref_b)
            same_twice(f"{what} backward", bwd)
            print(f"[kernels] {what}: max |kernel - plain| forward {err_f:.3g}, backward {err_b:.3g}; two "
                  "backward launches bit-equal", flush=True)
            del qkv, valid, g, ref, ref_b
        torch.cuda.empty_cache()


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
    # last group; at 512, dV's terms cancel often enough that W as one bf16 value fails
    # BWD_TOL on the persistent route); then the edges of the one-pass limit and of the 16-row steps (S = 16, 17,
    # 48, 129; 5), every one-pass tile count (S = 64, 81, 96, 113, 128: the forward's 4, 6,
    # 6, 8, 8 warps, the backward's 4, 6, 6 and the tiled route past 96), head dims 16 (one
    # k-step), 20 (rows not 16-byte aligned, one-pass and tiled), 32, 128, 256, and odd
    # batches (9, 17); 32 x 577: the fp32 backward in two chunks of batch rows (its W and dL
    # scratch past 1 GiB), dbias carried from the first.
    cases = [(batch, seq, 12, 64, *variant)
             for batch, seq in ((128, 67), (512, 67), (64, 97), (64, 193), (16, 577))
             for variant in ((1, False), (3, True))]
    cases += SHARDED_CHRONOS_CASES
    cases += [(32, 577, 12, 64, 3, True), (32, 80, 12, 64, 16, False), (256, 80, 12, 64, 16, False), (512, 80, 12, 64, 16, False),
              (4, 16, 12, 64, 1, False), (4, 17, 12, 64, 3, True), (4, 48, 12, 64, 3, True),
              (4, 64, 12, 64, 3, True), (4, 81, 12, 64, 1, False), (4, 96, 12, 64, 3, True),
              (4, 113, 12, 64, 1, False), (4, 128, 12, 64, 3, True),
              (4, 129, 12, 64, 3, True), (3, 67, 2, 16, 3, True), (3, 67, 2, 20, 3, True),
              (3, 200, 2, 20, 3, True), (3, 70, 2, 32, 1, True), (3, 70, 2, 128, 3, True),
              (2, 70, 2, 256, 3, True), (9, 200, 2, 64, 3, True), (17, 97, 2, 64, 3, True),
              (4, 5, 2, 64, 1, False)]
    timed = (main_shape, dict((k, shape) for k, *_, shape in CHRONOS_WGMMA_KERNELS)["B4f"])
    for dtype in (torch.float32, torch.bfloat16):
        for batch, seq, heads, dim, segments, padded in cases:
            shape = (batch, seq, heads, dim)
            qkv, seg, bias, g = chronos_inputs(shape, segments, padded, dtype, gen)
            what = f"B4 {shape} {segments} segment(s){' padded' if padded else ''}"
            errs = check_chronos(what, qkv, seg, bias, g)
            if shape not in timed or segments != 1:
                continue
            fwd, bwd = chronos_timed_rows(qkv, seg, bias, g, shape, errs, 10 if seq < 100 else 5)
            rows[row_key("B4f", shape, dtype)] = fwd
            rows[row_key("B4b", shape, dtype)] = bwd
    wgmma_route_checks(gen)
    persistent_forward_checks(gen, cases)
    tf32_persistent_checks(gen)
    tf32w_checks(gen)
    chronos_dv_cancel_checks(gen)
    return rows


# The Chronos wgmma route's own checks (bf16, head_dim 64, the route forced at every S):
# Chronos-2's 577, 193 and 97 tokens, one segment and three with padded tokens; the
# one-row tails S = 64 k + 1 (65, 129), S = 64 (no tail), 17 and 200 (a work item whose
# second warpgroup's rows all lie past S), 2 and 3 heads, odd batches.
WGMMA_ROUTE_CASES = ([(batch, seq, 12, 64, *variant)
                      for batch, seq in ((16, 577), (64, 193), (64, 97))
                      for variant in ((1, False), (3, True))]
                     + [(4, 65, 2, 64, 3, True), (3, 129, 12, 64, 3, True), (5, 64, 12, 64, 3, True),
                        (7, 17, 3, 64, 3, True), (2, 200, 2, 64, 1, False), (9, 200, 2, 64, 3, True)])


def wgmma_route_checks(gen: torch.Generator) -> None:
    """B4f and B4b (with and without dbias) on the wgmma route at WGMMA_ROUTE_CASES against
    their plain versions on every element, two backward launches bit-equal."""
    from multimodal_timesfm_torch.ops import _kernels

    try:
        _kernels.set_chronos_route("wgmma")
        for batch, seq, heads, dim, segments, padded in WGMMA_ROUTE_CASES:
            shape = (batch, seq, heads, dim)
            qkv, seg, bias, g = chronos_inputs(shape, segments, padded, torch.bfloat16, gen)
            route = _kernels.chronos_plan(True, torch.bfloat16, batch, seq, heads, dim)["route"]
            if route != 3 or _kernels.chronos_plan(False, torch.bfloat16, batch, seq, heads, dim)["route"] != 3:
                raise AssertionError(f"B4 {shape}: the forced wgmma route is not the plan's")
            check_chronos(f"B4 wgmma route {shape} {segments} segment(s){' padded' if padded else ''}",
                          qkv, seg, bias, g)
    finally:
        _kernels.set_chronos_route("rule")


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
    chunked_backward_check(gen)
    return rows


# A backward past one chunk of route 4's scratch: 8 x 2,100 x 16 is 128 work items of
# 18.4 MB each, three chunks of 43 (the budget holds 58).
CHUNKED_SHAPE = (8, 2100, 16, 80)


def chunked_backward_check(gen: torch.Generator) -> None:
    """B3b in fp32 at CHUNKED_SHAPE, left-padded, a random cotangent on every row: route 4
    (forced: the rule gives that length route 5, whose scratch is the row statistics) in three
    chunks of work items, then the rule's route, each against the plain version on every
    element, two launches bit-equal."""
    from multimodal_timesfm_torch.ops import _kernels
    from multimodal_timesfm_torch.ops.attention import flash_causal_attention_bwd, plain_attention_bwd

    batch, seq, heads, dim = CHUNKED_SHAPE
    q, k, v, g = (torch.randn(batch, seq, heads, dim, generator=gen, device="cuda") for _ in range(4))
    q = q / math.sqrt(dim)
    valid = left_padded_valid(batch, seq, gen)
    bwd = lambda: flash_causal_attention_bwd(q, k, v, valid, g)  # noqa: E731
    want = plain_attention_bwd(q, k, v, valid, g)
    for route in ("tf32 mma.sync", "rule"):
        try:
            _kernels.set_route(route)
            floats = _kernels.library().attention_bwd_scratch(
                *(t.data_ptr() for t in (q, k, v, g, q, k, v)), 0, batch, seq, heads, dim, q.stride(1),
                g.stride(1), q.stride(1))
            err = compare_bwd(f"B3b chunked {CHUNKED_SHAPE} {route}", bwd(), want)
            same_twice(f"B3b chunked {CHUNKED_SHAPE} {route}", bwd)
            text = _kernels.attention_route(True, torch.float32, seq, dim).split(",")[0]
        finally:
            _kernels.set_route("rule")
        print(f"[kernels] flash_causal_attention_bwd (B,S,H,D) {CHUNKED_SHAPE} float32, {route}: {text}, scratch "
              f"{floats * 4 / 1e6:.1f} MB ({batch * heads} work items): max |kernel - plain| {err:.3g} within "
              f"BWD_TOL; two launches bit-equal", flush=True)


# The lengths the bf16 border between the wgmma and mma.sync routes is measured at (D = 80,
# 16 heads, about 8,192 tokens a call: B = 8192 // S).
BORDER_LENGTHS = (16, 32, 64, 128, 192, 256, 512, 1024, 2048)


# A route counts as the faster at a length when its device time is below this share of the
# other's: the spread between two readings of one kernel in one run is 2-4%.
BORDER_MARGIN = 0.95


def route_borders(seed: int) -> None:
    """The bf16 border between the causal kernels' wgmma and mma.sync routes: at each of
    :data:`BORDER_LENGTHS` the forward and the backward on both routes (the library's route
    override), checked against the plain versions and timed in turns (mma.sync, wgmma,
    wgmma, mma.sync; device time from torch.profiler, so the host's cost of a call is not
    counted); one ``[gate]`` line per length, then one per border: the least S from which
    the wgmma route is the faster (by :data:`BORDER_MARGIN`) at every measured length,
    beside the least S the dispatch rule gives it."""
    from multimodal_timesfm_torch.ops import _kernels
    from multimodal_timesfm_torch.ops.attention import (
        fused_causal_attention,
        fused_causal_attention_bwd,
        plain_attention_bwd,
        plain_causal_attention,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    heads, dim, dtype = 16, 80, torch.bfloat16
    faster: dict[str, list[bool]] = {"forward": [], "backward": []}
    try:
        for seq in BORDER_LENGTHS:
            batch = max(1, 8192 // seq)
            q, k, v, g = (torch.randn(batch, seq, heads, dim, generator=gen, device="cuda") for _ in range(4))
            q, k, v, g = (q / math.sqrt(dim)).to(dtype), k.to(dtype), v.to(dtype), g.to(dtype)
            valid = left_padded_valid(batch, seq, gen)
            fwd = lambda: fused_causal_attention(q, k, v, valid)  # noqa: E731
            bwd = lambda: fused_causal_attention_bwd(q, k, v, valid, g)  # noqa: E731
            ref, ref_b = plain_causal_attention(q, k, v, valid), plain_attention_bwd(q, k, v, valid, g)
            times = {"mma.sync": [], "wgmma": []}
            for route in ("mma.sync", "wgmma", "wgmma", "mma.sync"):
                _kernels.set_route(route)
                if not times[route]:
                    compare(f"{route} route S={seq}", fwd(), ref)
                    compare_bwd(f"{route} route S={seq} backward", bwd(), ref_b)
                times[route].append((device_ms(fwd, 20)[0], device_ms(bwd, 10)[0]))
            mean = {r: [sum(t[i] for t in ts) / len(ts) for i in (0, 1)] for r, ts in times.items()}
            for i, name in enumerate(("forward", "backward")):
                faster[name].append(mean["wgmma"][i] < BORDER_MARGIN * mean["mma.sync"][i])
            print(f"[gate] bf16 D={dim} H={heads} S={seq} B={batch}, device ms: forward mma.sync "
                  f"{mean['mma.sync'][0]:.4f} ms, wgmma {mean['wgmma'][0]:.4f} ms; backward mma.sync "
                  f"{mean['mma.sync'][1]:.4f} ms, wgmma {mean['wgmma'][1]:.4f} ms (both within "
                  f"tolerance of the plain versions)", flush=True)
    finally:
        _kernels.set_route("rule")
    for name, wins in faster.items():
        measured = next((s for i, s in enumerate(BORDER_LENGTHS) if all(wins[i:])), None)
        rule = next((s for s in BORDER_LENGTHS
                     if "wgmma" in _kernels.attention_route(name == "backward", dtype, s, dim)), None)
        print(f"[gate] bf16 {name} border: the wgmma route is the faster (by {1 - BORDER_MARGIN:.0%}) "
              f"from S={measured} on (of {BORDER_LENGTHS}); the dispatch rule takes it from S={rule}",
              flush=True)


# The lengths the bf16 border between the Chronos wgmma route and the mma.sync routes
# (one-pass, tiled) is measured at: head_dim 64, 12 heads, about CHRONOS_BORDER_TOKENS tokens
# a call (B = CHRONOS_BORDER_TOKENS // S): 16 x 577, Chronos-2's serving batch at context 8192.
CHRONOS_BORDER_LENGTHS = (64, 80, 97, 128, 193, 577)
CHRONOS_BORDER_TOKENS = 16 * 577


def chronos_route_borders(seed: int) -> None:
    """The bf16 border between the Chronos attention's wgmma route and its mma.sync routes:
    at each of CHRONOS_BORDER_LENGTHS the forward, the backward without dbias and with dbias
    on both (the library's route override), checked against the plain versions and timed in
    turns (mma.sync, wgmma, wgmma, mma.sync; held_ms: device time held to a graph replay's
    event time); one ``[gate]`` line per length, then one per direction: the least S from
    which the wgmma route is the faster (by BORDER_MARGIN, the backward in both modes) at
    every measured length, beside the least S the dispatch rule gives it."""
    from multimodal_timesfm_torch.ops import _kernels
    from multimodal_timesfm_torch.ops.chronos_attention import (
        fused_chronos_attention,
        fused_chronos_attention_bwd,
        plain_chronos_attention,
        plain_chronos_attention_bwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    heads, dim, dtype = 12, 64, torch.bfloat16
    faster: dict[str, list[bool]] = {"forward": [], "backward": []}
    try:
        for seq in CHRONOS_BORDER_LENGTHS:
            batch = max(1, CHRONOS_BORDER_TOKENS // seq)
            qkv, seg, bias, g = chronos_inputs((batch, seq, heads, dim), 1, False, dtype, gen)
            calls = (lambda: fused_chronos_attention(qkv, seg, bias),
                     lambda: fused_chronos_attention_bwd(qkv, seg, bias, g, False),
                     lambda: fused_chronos_attention_bwd(qkv, seg, bias, g, True))
            ref = plain_chronos_attention(qkv, seg, bias)
            ref_b, ref_db = plain_chronos_attention_bwd(qkv, seg, bias, g, True)
            times: dict[str, list[tuple[float, ...]]] = {"mma.sync": [], "wgmma": []}
            for route in ("mma.sync", "wgmma", "wgmma", "mma.sync"):
                _kernels.set_chronos_route(route)
                if not times[route]:
                    compare(f"chronos {route} route S={seq}", calls[0](), ref)
                    compare_bwd(f"chronos {route} route S={seq} backward", calls[2](), (ref_b, ref_db))
                times[route].append(tuple(held_ms(fn, 20 if i == 0 else 10)[0] for i, fn in enumerate(calls)))
            mean = {r: [sum(t[i] for t in ts) / len(ts) for i in range(3)] for r, ts in times.items()}
            wins = [mean["wgmma"][i] < BORDER_MARGIN * mean["mma.sync"][i] for i in range(3)]
            faster["forward"].append(wins[0])
            faster["backward"].append(wins[1] and wins[2])
            plans = {d: _kernels.chronos_route(d == "backward", dtype, batch, seq, heads, dim).split(",")[0]
                     for d in ("forward", "backward")}
            print(f"[gate] chronos bf16 D={dim} H={heads} S={seq} B={batch}, held device ms (mma.sync / "
                  f"wgmma): forward {mean['mma.sync'][0]:.4f} / {mean['wgmma'][0]:.4f}, backward "
                  f"{mean['mma.sync'][1]:.4f} / {mean['wgmma'][1]:.4f}, with dbias {mean['mma.sync'][2]:.4f} "
                  f"/ {mean['wgmma'][2]:.4f} (both routes within tolerance of the plain versions; the "
                  f"rule: forward {plans['forward']}, backward {plans['backward']})", flush=True)
    finally:
        _kernels.set_chronos_route("rule")
    for name, wins in faster.items():
        measured = next((s for i, s in enumerate(CHRONOS_BORDER_LENGTHS) if all(wins[i:])), None)
        rule = next((s for s in CHRONOS_BORDER_LENGTHS if _kernels.chronos_plan(
            name == "backward", dtype, max(1, CHRONOS_BORDER_TOKENS // s), s, heads, dim)["route"] == 3), None)
        print(f"[gate] chronos bf16 {name} border: the wgmma route is the faster (by "
              f"{1 - BORDER_MARGIN:.0%}) from S={measured} on (of {CHRONOS_BORDER_LENGTHS}); the dispatch "
              f"rule takes it from S={rule}", flush=True)


# The lengths the fp32 border between the Chronos kernels' 3xTF32 route and their CUDA-core
# route is measured at (head_dim 64, 12 heads, B = CHRONOS_BORDER_TOKENS // S): one tile of S
# padded to 16 up to 80 tokens, 64-row tiles from 81; Chronos-2's 67, 97, 193 and 577.
F32_BORDER_LENGTHS = (16, 32, 48, 64, 67, 80, 97, 128, 193, 577)


def chronos_f32_borders(seed: int) -> None:
    """The fp32 border between the Chronos attention's 3xTF32 route and its CUDA-core route: at
    each of F32_BORDER_LENGTHS the forward, the backward without dbias and with dbias on both
    (the dispatch rule, which takes the 3xTF32 route at head_dim 64, and the library's route
    override ``"cuda cores"``), checked against the plain versions and timed in turns (CUDA
    cores, rule, rule, CUDA cores; held_ms); one ``[gate]`` line per length, then one
    per direction: the least S from which the 3xTF32 route is the faster (by BORDER_MARGIN, the
    backward in both modes) at every measured length, beside the least S the dispatch rule
    gives it."""
    from multimodal_timesfm_torch.ops import _kernels
    from multimodal_timesfm_torch.ops.chronos_attention import (
        fused_chronos_attention,
        fused_chronos_attention_bwd,
        plain_chronos_attention,
        plain_chronos_attention_bwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    heads, dim, dtype = 12, 64, torch.float32
    faster: dict[str, list[bool]] = {"forward": [], "backward": []}
    try:
        for seq in F32_BORDER_LENGTHS:
            batch = max(1, CHRONOS_BORDER_TOKENS // seq)
            qkv, seg, bias, g = chronos_inputs((batch, seq, heads, dim), 1, False, dtype, gen)
            calls = (lambda: fused_chronos_attention(qkv, seg, bias),
                     lambda: fused_chronos_attention_bwd(qkv, seg, bias, g, False),
                     lambda: fused_chronos_attention_bwd(qkv, seg, bias, g, True))
            ref = plain_chronos_attention(qkv, seg, bias)
            ref_b, ref_db = plain_chronos_attention_bwd(qkv, seg, bias, g, True)
            times: dict[str, list[tuple[float, ...]]] = {"cuda cores": [], "rule": []}
            for route in ("cuda cores", "rule", "rule", "cuda cores"):
                _kernels.set_chronos_route(route)
                if not times[route]:
                    compare(f"chronos fp32 {route} route S={seq}", calls[0](), ref)
                    compare_bwd(f"chronos fp32 {route} route S={seq} backward", calls[2](), (ref_b, ref_db))
                times[route].append(tuple(held_ms(fn, 10)[0] for fn in calls))
            mean = {r: [sum(t[i] for t in ts) / len(ts) for i in range(3)] for r, ts in times.items()}
            wins = [mean["rule"][i] < BORDER_MARGIN * mean["cuda cores"][i] for i in range(3)]
            faster["forward"].append(wins[0])
            faster["backward"].append(wins[1] and wins[2])
            _kernels.set_chronos_route("rule")
            plans = {d: _kernels.chronos_route(d == "backward", dtype, batch, seq, heads, dim).split(",")[0]
                     for d in ("forward", "backward")}
            print(f"[gate] chronos fp32 D={dim} H={heads} S={seq} B={batch}, held device ms (CUDA cores / "
                  f"3xTF32): forward {mean['cuda cores'][0]:.4f} / {mean['rule'][0]:.4f}, backward "
                  f"{mean['cuda cores'][1]:.4f} / {mean['rule'][1]:.4f}, with dbias "
                  f"{mean['cuda cores'][2]:.4f} / {mean['rule'][2]:.4f} (both routes within tolerance of "
                  f"the plain versions; the rule: forward {plans['forward']}, backward {plans['backward']})",
                  flush=True)
    finally:
        _kernels.set_chronos_route("rule")
    for name, wins in faster.items():
        measured = next((s for i, s in enumerate(F32_BORDER_LENGTHS) if all(wins[i:])), None)
        rule = next((s for s in F32_BORDER_LENGTHS if _kernels.chronos_plan(
            name == "backward", dtype, max(1, CHRONOS_BORDER_TOKENS // s), s, heads, dim)["route"] in (5, 6, 7)),
                    None)
        print(f"[gate] chronos fp32 {name} border: the 3xTF32 route is the faster (by "
              f"{1 - BORDER_MARGIN:.0%}) from S={measured} on (of {F32_BORDER_LENGTHS}); the dispatch "
              f"rule takes it from S={rule}", flush=True)


# The lengths route 6's borders are measured at (fp32, head_dim 64, 12 heads, B = 9,232 // S):
# Chronos-2's 67 (the fine-tune), 80 (packed rows) and 97 (serving at context 512), and the
# lengths between and around them, each up to the longest S it is built for.
F32_PERSISTENT_BORDER_LENGTHS = (16, 32, 48, 64, 67, 80, 97, 113, 128)


def chronos_f32_persistent_borders(seed: int) -> None:
    """The fp32 borders of route 6 against route 5 (the library's overrides ``"tf32 persistent"``
    and ``"tf32 mma.sync"``): at each of F32_PERSISTENT_BORDER_LENGTHS the forward, and up to 80
    the backward without and with dbias, on both routes, checked against the plain versions and
    timed in turns (route 5, route 6, route 6, route 5; held_ms); one ``[gate] chronos fp32
    persistent`` line per length, then one per direction (persistent_border_line)."""
    from multimodal_timesfm_torch.ops import _kernels
    from multimodal_timesfm_torch.ops.chronos_attention import (
        fused_chronos_attention,
        fused_chronos_attention_bwd,
        plain_chronos_attention,
        plain_chronos_attention_bwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    heads, dim, dtype = 12, 64, torch.float32
    wins: dict[str, list[bool]] = {"forward": [], "backward": []}
    rule: dict[str, list[bool]] = {"forward": [], "backward": []}
    names = {"route 5": "tf32 mma.sync", "route 6": "tf32 persistent"}
    try:
        for seq in F32_PERSISTENT_BORDER_LENGTHS:
            batch = max(1, CHRONOS_BORDER_TOKENS // seq)
            backward = seq <= 80
            qkv, seg, bias, g = chronos_inputs((batch, seq, heads, dim), 1, False, dtype, gen)
            calls = [lambda: fused_chronos_attention(qkv, seg, bias)]
            if backward:
                calls += [lambda: fused_chronos_attention_bwd(qkv, seg, bias, g, False),
                          lambda: fused_chronos_attention_bwd(qkv, seg, bias, g, True)]
            ref = plain_chronos_attention(qkv, seg, bias)
            ref_b = plain_chronos_attention_bwd(qkv, seg, bias, g, True) if backward else None
            times: dict[str, list[tuple[float, ...]]] = {"route 5": [], "route 6": []}
            for route in ("route 5", "route 6", "route 6", "route 5"):
                _kernels.set_chronos_route(names[route])
                want = 6 if route == "route 6" else 5
                if _kernels.chronos_plan(False, dtype, batch, seq, heads, dim)["route"] != want:
                    raise AssertionError(f"chronos fp32 S={seq}: the override {names[route]!r} is not the plan's")
                if not times[route]:
                    compare(f"chronos fp32 {route} S={seq}", calls[0](), ref)
                    if backward:
                        compare_bwd(f"chronos fp32 {route} S={seq} backward", calls[2](), ref_b)
                times[route].append(tuple(held_ms(fn, 10)[0] for fn in calls))
            _kernels.set_chronos_route("rule")
            mean = {r: [sum(t[i] for t in ts) / len(ts) for i in range(len(calls))] for r, ts in times.items()}
            won = [mean["route 6"][i] < BORDER_MARGIN * mean["route 5"][i] for i in range(len(calls))]
            wins["forward"].append(won[0])
            rule["forward"].append(_kernels.chronos_plan(False, dtype, batch, seq, heads, dim)["route"] == 6)
            if backward:
                wins["backward"].append(won[1] and won[2])
                rule["backward"].append(_kernels.chronos_plan(True, dtype, batch, seq, heads, dim)["route"] == 6)
            parts = [f"forward {mean['route 5'][0]:.4f} / {mean['route 6'][0]:.4f}"]
            if backward:
                parts += [f"backward {mean['route 5'][1]:.4f} / {mean['route 6'][1]:.4f}",
                          f"with dbias {mean['route 5'][2]:.4f} / {mean['route 6'][2]:.4f}"]
            print(f"[gate] chronos fp32 persistent D={dim} H={heads} S={seq} B={batch}, held device ms (route 5 / "
                  f"route 6): {', '.join(parts)} (both routes within tolerance of the plain versions; the rule: "
                  f"forward route {_kernels.chronos_plan(False, dtype, batch, seq, heads, dim)['route']}"
                  + (f", backward route {_kernels.chronos_plan(True, dtype, batch, seq, heads, dim)['route']}"
                     if backward else "") + ")", flush=True)
    finally:
        _kernels.set_chronos_route("rule")
    lengths = F32_PERSISTENT_BORDER_LENGTHS
    persistent_border_line("chronos fp32 persistent forward", lengths, wins["forward"], rule["forward"])
    short = tuple(s for s in lengths if s <= 80)
    persistent_border_line("chronos fp32 persistent backward", short, wins["backward"], rule["backward"])


# The lengths route 7's borders are measured at (fp32, head_dim 64, 12 heads, B = 9,232 // S):
# from route 6's backward border (80) through Chronos-2's 97 (serving at context 512), 193 and 577
# (contexts 2048 and 8192) to 1,025, with route 6 beside them where it is built (the forward up to
# TF32_PERSISTENT_BUILT_TO's 128).
F32_WGMMA_BORDER_LENGTHS = (81, 97, 113, 128, 160, 193, 256, 385, 577, 1025)


def chronos_f32_wgmma_borders(seed: int) -> None:
    """The fp32 borders of route 7 (3xTF32 wgmma fed by TMA; the library's override ``"tf32
    wgmma"``) against route 5 (``"tf32 mma.sync"``) and, where route 6 is built, route 6
    (``"tf32 persistent"``): at each of F32_WGMMA_BORDER_LENGTHS the forward, the backward
    without dbias and with dbias on each route, checked against the plain versions and timed in
    turns (route 5, route 6, route 7, route 7, route 6, route 5; held_ms); one ``[gate] chronos
    fp32 wgmma`` line per length, then one per direction: the least S from which route 7 is the
    faster by BORDER_MARGIN than every other route measured there (the backward in both modes)
    at every measured length, beside the least S from which the dispatch rule gives route 7."""
    from multimodal_timesfm_torch.ops import _kernels
    from multimodal_timesfm_torch.ops.chronos_attention import (
        fused_chronos_attention,
        fused_chronos_attention_bwd,
        plain_chronos_attention,
        plain_chronos_attention_bwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 29)
    heads, dim, dtype = 12, 64, torch.float32
    names = {"route 5": "tf32 mma.sync", "route 6": "tf32 persistent", "route 7": "tf32 wgmma"}
    wins: dict[str, list[bool]] = {"forward": [], "backward": []}
    try:
        for seq in F32_WGMMA_BORDER_LENGTHS:
            batch = max(1, CHRONOS_BORDER_TOKENS // seq)
            qkv, seg, bias, g = chronos_inputs((batch, seq, heads, dim), 1, False, dtype, gen)
            calls = (lambda: fused_chronos_attention(qkv, seg, bias),
                     lambda: fused_chronos_attention_bwd(qkv, seg, bias, g, False),
                     lambda: fused_chronos_attention_bwd(qkv, seg, bias, g, True))
            ref = plain_chronos_attention(qkv, seg, bias)
            ref_b = plain_chronos_attention_bwd(qkv, seg, bias, g, True)
            built = {"forward": seq <= TF32_PERSISTENT_BUILT_TO["forward"],
                     "backward": seq <= TF32_PERSISTENT_BUILT_TO["backward"]}
            order = ("route 5", "route 6", "route 7", "route 7", "route 6", "route 5")
            times: dict[str, list[list[float | None]]] = {r: [] for r in names}
            for route in order:
                _kernels.set_chronos_route(names[route])
                want = int(route[-1])
                ways = [built[w] or route != "route 6" for w in ("forward", "backward", "backward")]
                if _kernels.chronos_plan(False, dtype, batch, seq, heads, dim)["route"] != (want if ways[0] else 7):
                    raise AssertionError(f"chronos fp32 S={seq}: the override {names[route]!r} is not the plan's")
                if not times[route]:
                    if ways[0]:
                        compare(f"chronos fp32 {route} S={seq}", calls[0](), ref)
                    if ways[1]:
                        compare_bwd(f"chronos fp32 {route} S={seq} backward", calls[2](), ref_b)
                times[route].append([held_ms(fn, 10)[0] if on else None for fn, on in zip(calls, ways)])
            _kernels.set_chronos_route("rule")
            mean = {r: [None if ts[0][i] is None else sum(t[i] for t in ts) / len(ts) for i in range(3)]
                    for r, ts in times.items()}
            won = [all(mean[r][i] is None or mean["route 7"][i] < BORDER_MARGIN * mean[r][i]
                       for r in ("route 5", "route 6")) for i in range(3)]
            wins["forward"].append(won[0])
            wins["backward"].append(won[1] and won[2])

            def part(what: str, i: int) -> str:
                return f"{what} " + " / ".join("-" if mean[r][i] is None else f"{mean[r][i]:.4f}" for r in names)

            print(f"[gate] chronos fp32 wgmma D={dim} H={heads} S={seq} B={batch}, held device ms (route 5 / "
                  f"route 6 / route 7; - where route 6 is not built): {part('forward', 0)}, {part('backward', 1)}, "
                  f"{part('with dbias', 2)} (every route within tolerance of the plain versions; the rule: forward "
                  f"route {_kernels.chronos_plan(False, dtype, batch, seq, heads, dim)['route']}, backward route "
                  f"{_kernels.chronos_plan(True, dtype, batch, seq, heads, dim)['route']})", flush=True)
    finally:
        _kernels.set_chronos_route("rule")
    lengths = F32_WGMMA_BORDER_LENGTHS
    for name, won in wins.items():
        measured = next((s for i, s in enumerate(lengths) if all(won[i:])), None)
        rule = next((s for s in lengths if _kernels.chronos_plan(
            name == "backward", dtype, max(1, CHRONOS_BORDER_TOKENS // s), s, heads, dim)["route"] == 7), None)
        print(f"[gate] chronos fp32 wgmma {name} border: route 7 is the faster (by {1 - BORDER_MARGIN:.0%}) than "
              f"every other route measured from S={measured} on (of {lengths}; where route 6 takes a length by "
              f"its own border, the rule keeps it there); the dispatch rule takes route 7 from S={rule}",
              flush=True)


def sdpa_graph_ms(qkv: torch.Tensor, seg: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
                  heads: int, dim: int, iters: int = 10) -> tuple[float, float]:
    """SDPA's forward alone and its forward with ``torch.autograd.grad`` (q, k, v), each captured
    in a CUDA graph after a side-stream warm-up, as the trainer's step is captured, and held to
    the replay's event time: ms per call of each (the backward is their difference)."""
    mask = chronos_sdpa_mask(seg, bias, qkv.dtype)
    qh, kh, vh = (t.unflatten(-1, (heads, dim)).transpose(1, 2).detach().requires_grad_()
                  for t in qkv.chunk(3, dim=-1))
    gh = g.unflatten(-1, (heads, dim)).transpose(1, 2)

    def forward():
        return torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=1.0)

    def both():
        return torch.autograd.grad(forward(), (qh, kh, vh), gh)

    out = []
    for fn in (forward, both):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
        del graph
    return out[0], out[1]


# The lengths the fp32 border between the causal kernels' two 3xTF32 routes (route 4 on mma.sync,
# route 5 on wgmma fed by TMA) is measured at (head_dim 80, 16 heads, B = 8,192 // S): B1's
# main-path 16, 64 and 192, B2's 512 and B3's 2,100, and the lengths between.
CAUSAL_F32_BORDER_LENGTHS = (16, 32, 64, 128, 192, 256, 512, 1024, 2100)


def causal_f32_borders(seed: int) -> None:
    """The fp32 border between the causal kernels' route 4 (3xTF32 mma.sync) and route 5
    (3xTF32 wgmma fed by TMA): at each of CAUSAL_F32_BORDER_LENGTHS the forward and the backward
    on both (the library's route overrides "tf32 mma.sync" and "tf32 wgmma"), left-padded, checked
    against the plain versions and timed in turns (route 4, route 5, route 5, route 4; held_ms);
    one ``[gate]`` line per length, then one per direction: the least S from which route 5 is the
    faster (by BORDER_MARGIN) at every measured length, beside the least S the dispatch rule gives
    it. At each length the rule's route is also held to ``_kernels.causal_f32_route``, which
    follows the rule without the library."""
    from multimodal_timesfm_torch.ops import _kernels
    from multimodal_timesfm_torch.ops.attention import (
        fused_causal_attention,
        fused_causal_attention_bwd,
        plain_attention_bwd,
        plain_causal_attention,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 18)
    heads, dim, dtype = 16, 80, torch.float32
    routes = ("tf32 mma.sync", "tf32 wgmma")
    faster: dict[str, list[bool]] = {"forward": [], "backward": []}
    try:
        for seq in CAUSAL_F32_BORDER_LENGTHS:
            batch = max(1, 8192 // seq)
            q, k, v, g = (torch.randn(batch, seq, heads, dim, generator=gen, device="cuda") for _ in range(4))
            q = q / math.sqrt(dim)
            valid = left_padded_valid(batch, seq, gen)
            calls = (lambda: fused_causal_attention(q, k, v, valid),
                     lambda: fused_causal_attention_bwd(q, k, v, valid, g))
            ref, ref_b = plain_causal_attention(q, k, v, valid), plain_attention_bwd(q, k, v, valid, g)
            times: dict[str, list[tuple[float, ...]]] = {route: [] for route in routes}
            iters = 5 if seq > 1000 else 10
            for route in (routes[0], routes[1], routes[1], routes[0]):
                _kernels.set_route(route)
                if not times[route]:
                    compare(f"causal fp32 {route} route S={seq}", calls[0](), ref)
                    compare_bwd(f"causal fp32 {route} route S={seq} backward", calls[1](), ref_b)
                    same_twice(f"causal fp32 {route} route S={seq} backward", calls[1])
                times[route].append(tuple(held_ms(fn, iters)[0] for fn in calls))
            del ref, ref_b
            mean = {r: [sum(t[i] for t in ts) / len(ts) for i in range(2)] for r, ts in times.items()}
            for i, name in enumerate(("forward", "backward")):
                faster[name].append(mean[routes[1]][i] < BORDER_MARGIN * mean[routes[0]][i])
            _kernels.set_route("rule")
            rules = {}
            for d, outs in (("forward", (q,)), ("backward", (q, k, v))):
                number = _kernels.attention_route_number(d == "backward", dtype, seq, dim)
                ins = (q, k, v) if d == "forward" else (q, k, v, g)
                if _kernels.causal_f32_route(d == "backward", ins, outs) != number:
                    raise AssertionError(f"causal fp32 S={seq} {d}: the library's rule gives route {number}, "
                                         f"_kernels.causal_f32_route another")
                rules[d] = _kernels.attention_route(d == "backward", dtype, seq, dim).split(",")[0]
            print(f"[gate] causal fp32 D={dim} H={heads} S={seq} B={batch}, held device ms (3xTF32 mma.sync / "
                  f"3xTF32 wgmma): forward {mean[routes[0]][0]:.4f} / {mean[routes[1]][0]:.4f}, backward "
                  f"{mean[routes[0]][1]:.4f} / {mean[routes[1]][1]:.4f} (both routes within tolerance of the "
                  f"plain versions, backward launches bit-equal; the rule: forward {rules['forward']}, backward "
                  f"{rules['backward']})", flush=True)
    finally:
        _kernels.set_route("rule")
    for name, wins in faster.items():
        measured = next((s for i, s in enumerate(CAUSAL_F32_BORDER_LENGTHS) if all(wins[i:])), None)
        rule = next((s for s in CAUSAL_F32_BORDER_LENGTHS
                     if _kernels.attention_route_number(name == "backward", dtype, s, dim) == 5), None)
        print(f"[gate] causal fp32 {name} border: the 3xTF32 wgmma route is the faster (by {1 - BORDER_MARGIN:.0%}) "
              f"from S={measured} on (of {CAUSAL_F32_BORDER_LENGTHS}); the dispatch rule takes it from S={rule}",
              flush=True)


# The lengths the bf16 borders of the backwards' persistent one-pass route are measured at:
# B1b at head_dim 80, 16 heads, B = 8,192 // S (the route takes S <= 64); B4b at head_dim 64,
# 12 heads, B = CHRONOS_BORDER_TOKENS // S (the route takes S <= 80).
PERSISTENT_BORDER_LENGTHS = (8, 16, 32, 48, 64, 96, 128)
CHRONOS_PERSISTENT_BORDER_LENGTHS = (16, 32, 48, 64, 67, 80, 96)


def persistent_border_line(what: str, lengths: tuple[int, ...], wins: list[bool], rule: list[bool]) -> None:
    """One ``[gate]`` line per border of the persistent route: the lengths where it is the
    faster by BORDER_MARGIN than every other route measured there, the longest S up to which
    it is at every measured length, and the lengths the dispatch rule gives it."""
    won = [s for s, w in zip(lengths, wins) if w]
    upto = next((lengths[i - 1] for i, w in enumerate(wins) if not w), lengths[-1]) if wins[0] else None
    print(f"[gate] {what} border: the persistent route is the faster (by {1 - BORDER_MARGIN:.0%}) than "
          f"every other route at S={won} (of {lengths}), at every length up to S={upto}; the dispatch "
          f"rule takes it at S={[s for s, r in zip(lengths, rule) if r]}", flush=True)


def persistent_route_borders(seed: int, chronos_only: bool = False) -> None:
    """The bf16 borders of the backwards' persistent one-pass route. B1b (unless
    ``chronos_only``): at each of PERSISTENT_BORDER_LENGTHS the fused-qkv backward on the
    persistent route (up to 64 tokens; the rule's there), the mma.sync route and, from 64, the
    wgmma route (the library's route override), checked against the plain version (the persistent route's
    two launches bit-equal) and timed in turns (each route, then the same in reverse; held_ms);
    B4b: the same at CHRONOS_PERSISTENT_BORDER_LENGTHS, without and with dbias, against the
    one-pass or tiled mma.sync route and the wgmma route. One ``[gate]`` line per length, then
    one per border (persistent_border_line). Then the forwards' borders: B1f's (unless
    ``chronos_only``, causal_forward_borders) and B4f's (persistent_forward_borders)."""
    from multimodal_timesfm_torch.ops import _kernels
    from multimodal_timesfm_torch.ops.chronos_attention import (
        fused_chronos_attention_bwd,
        plain_chronos_attention_bwd,
    )
    from multimodal_timesfm_torch.ops.qkv_attention import (
        fused_qkv_causal_attention_bwd,
        plain_qkv_attention_bwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    dtype = torch.bfloat16

    def in_turns(routes: list[str], set_route, calls, check) -> dict[str, list[float]]:
        # The persistent route is the rule's at every length it is timed at.
        times: dict[str, list[tuple[float, ...]]] = {r: [] for r in routes}
        for route in routes + routes[::-1]:
            set_route("rule" if route == "persistent" else route)
            if not times[route]:
                check(route)
            times[route].append(tuple(held_ms(fn, 10)[0] for fn in calls))
        set_route("rule")
        return {r: [sum(t[i] for t in ts) / len(ts) for i in range(len(calls))] for r, ts in times.items()}

    def faster(mean: dict[str, list[float]]) -> bool:
        return "persistent" in mean and all(
            p < BORDER_MARGIN * o for r, ms in mean.items() if r != "persistent"
            for p, o in zip(mean["persistent"], ms))

    if not chronos_only:
        heads, dim = 16, 80
        wins, rule = [], []
        try:
            for seq in PERSISTENT_BORDER_LENGTHS:
                batch = 8192 // seq
                qkv = torch.randn(batch, seq, 3 * heads * dim, generator=gen, device="cuda")
                qkv[..., : heads * dim] /= math.sqrt(dim)
                qkv = qkv.to(dtype)
                valid = left_padded_valid(batch, seq, gen)
                g = padded_cotangent((batch, seq, heads * dim), valid, dtype, gen)
                bwd = lambda: fused_qkv_causal_attention_bwd(qkv, valid, g, heads, dim)  # noqa: E731
                ref = plain_qkv_attention_bwd(qkv, valid, g, heads, dim)

                def check(route):
                    compare_bwd(f"B1b {route} route S={seq}", bwd(), ref)
                    if route == "persistent":
                        same_twice(f"B1b persistent route S={seq}", bwd)

                routes = (["persistent"] if seq <= 64 else []) + ["mma.sync"] + (["wgmma"] if seq >= 64 else [])
                mean = in_turns(routes, _kernels.set_route, (bwd,), check)
                wins.append(faster(mean))
                rule.append(_kernels.attention_route_number(True, dtype, seq, dim) == 3)
                print(f"[gate] B1b persistent bf16 D={dim} H={heads} S={seq} B={batch}, held device ms: "
                      + ", ".join(f"{r} {m[0]:.4f}" for r, m in mean.items())
                      + (" (the persistent route takes S <= 64)" if seq > 64 else "")
                      + f"; every route within tolerance of the plain version; the rule: "
                        f"{_kernels.attention_route(True, dtype, seq, dim).split(',')[0]}", flush=True)
        finally:
            _kernels.set_route("rule")
        persistent_border_line("B1b bf16 backward", PERSISTENT_BORDER_LENGTHS, wins, rule)
        causal_forward_borders(seed)

    heads, dim = 12, 64
    wins, rule = [], []
    try:
        for seq in CHRONOS_PERSISTENT_BORDER_LENGTHS:
            batch = max(1, CHRONOS_BORDER_TOKENS // seq)
            qkv, seg, bias, g = chronos_inputs((batch, seq, heads, dim), 1, False, dtype, gen)
            calls = (lambda: fused_chronos_attention_bwd(qkv, seg, bias, g, False),
                     lambda: fused_chronos_attention_bwd(qkv, seg, bias, g, True))
            ref = plain_chronos_attention_bwd(qkv, seg, bias, g, True)

            def check(route):
                compare_bwd(f"B4b {route} route S={seq}", calls[1](), ref)

            routes = (["persistent"] if seq <= 80 else []) + ["mma.sync", "wgmma"]
            mean = in_turns(routes, _kernels.set_chronos_route, calls, check)
            wins.append(faster(mean))
            rule.append(_kernels.chronos_plan(True, dtype, batch, seq, heads, dim)["route"] == 4)
            print(f"[gate] B4b persistent bf16 D={dim} H={heads} S={seq} B={batch}, held device ms "
                  f"(no dbias / with dbias): "
                  + ", ".join(f"{r} {m[0]:.4f} / {m[1]:.4f}" for r, m in mean.items())
                  + (" (the persistent route takes S <= 80)" if seq > 80 else "")
                  + f"; every route within tolerance of the plain version; the rule: "
                    f"{_kernels.chronos_route(True, dtype, batch, seq, heads, dim).split(',')[0]}", flush=True)
    finally:
        _kernels.set_chronos_route("rule")
    persistent_border_line("B4b bf16 backward", CHRONOS_PERSISTENT_BORDER_LENGTHS, wins, rule)
    persistent_forward_borders(seed)


# The lengths the bf16 border of B1f's persistent route is measured at: head_dim 80, 16 heads,
# B = 8,192 / S; against the mma.sync route at every length and the wgmma route at 64 (the
# routes the rule gave those lengths before the persistent route).
SHORT_FORWARD_BORDER_LENGTHS = tuple(range(8, 65, 8))


def causal_forward_borders(seed: int) -> None:
    """The bf16 border of B1f's persistent route: at each of SHORT_FORWARD_BORDER_LENGTHS the
    forward on the persistent route (the rule's at every length it is timed at), the mma.sync
    route and, at 64, the wgmma route (the library's route override), each checked against the
    plain version (the persistent route's two launches bit-equal) and timed in turns (each
    route, then the same in reverse; held_ms). One ``[gate]`` line per length, then one for the
    border (persistent_border_line)."""
    from multimodal_timesfm_torch.ops import _kernels
    from multimodal_timesfm_torch.ops.qkv_attention import plain_qkv_causal_attention, split_heads

    gen = torch.Generator(device="cuda").manual_seed(seed + 14)
    heads, dim, dtype = 16, 80, torch.bfloat16
    wins, rule = [], []
    try:
        for seq in SHORT_FORWARD_BORDER_LENGTHS:
            batch = 8192 // seq
            qkv = torch.randn(batch, seq, 3 * heads * dim, generator=gen, device="cuda")
            qkv[..., : heads * dim] /= math.sqrt(dim)
            qkv = qkv.to(dtype)
            valid = left_padded_valid(batch, seq, gen)
            q, k, v = split_heads(qkv, heads, dim)
            ref = plain_qkv_causal_attention(qkv, valid, heads, dim).unflatten(-1, (heads, dim))
            routes = ["persistent", "mma.sync"] + (["wgmma"] if seq >= 64 else [])
            outs = {r: torch.empty(batch, seq, heads, dim, dtype=dtype, device="cuda") for r in routes}

            def call(route):
                return lambda: _kernels.attention_fwd(q, k, v, valid, outs[route])

            times: dict[str, list[float]] = {r: [] for r in routes}
            for route in routes + routes[::-1]:
                _kernels.set_route("rule" if route == "persistent" else route)
                if not times[route]:
                    want = {"persistent": 3, "mma.sync": 1, "wgmma": 2}[route]
                    if _kernels.attention_route_number(False, dtype, seq, dim) != want:
                        raise AssertionError(f"B1f S={seq}: the {route} route is not the dispatch's")
                    call(route)()
                    compare(f"B1f {route} route S={seq}", outs[route], ref)
                    if route == "persistent":
                        same_twice(f"B1f persistent route S={seq}",
                                   lambda: (call(route)(), outs[route].clone())[1])
                times[route].append(held_ms(call(route), 10)[0])
            _kernels.set_route("rule")
            mean = {r: sum(ts) / len(ts) for r, ts in times.items()}
            wins.append(all(mean["persistent"] < BORDER_MARGIN * ms for r, ms in mean.items() if r != "persistent"))
            rule.append(_kernels.attention_route_number(False, dtype, seq, dim) == 3)
            print(f"[gate] B1f persistent bf16 D={dim} H={heads} S={seq} B={batch}, held device ms: "
                  + ", ".join(f"{r} {m:.4f}" for r, m in mean.items())
                  + f"; every route within tolerance of the plain version; the rule: "
                    f"{B1_ROUTES[_kernels.attention_route_number(False, dtype, seq, dim)]}", flush=True)
    finally:
        _kernels.set_route("rule")
    persistent_border_line("B1f bf16 forward", SHORT_FORWARD_BORDER_LENGTHS, wins, rule)


# The lengths the bf16 border of B4f's persistent route is measured at: head_dim 64, 12 heads,
# B = CHRONOS_BORDER_TOKENS // S; against the one-pass route up to 96 tokens and against the
# wgmma route from 97 (the routes the rule gave those lengths before the persistent route).
FORWARD_BORDER_LENGTHS = (16, 32, 48, 64, 67, 80, 96, 97, 113, 128)


def persistent_forward_borders(seed: int) -> None:
    """The bf16 border of B4f's persistent route: at each of FORWARD_BORDER_LENGTHS the forward
    on the persistent route (the rule's, up to 128) and on the route it took there before
    (mma.sync one-pass up to 96, wgmma from 97; the library's route override), checked against the plain version (the persistent route's two launches
    bit-equal) and timed in turns (persistent, other, other, persistent; held_ms). One ``[gate]``
    line per length, then one for the border (persistent_border_line)."""
    from multimodal_timesfm_torch.ops import _kernels
    from multimodal_timesfm_torch.ops.chronos_attention import fused_chronos_attention, plain_chronos_attention

    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    heads, dim, dtype = 12, 64, torch.bfloat16
    wins, rule = [], []
    try:
        for seq in FORWARD_BORDER_LENGTHS:
            batch = max(1, CHRONOS_BORDER_TOKENS // seq)
            qkv, seg, bias, _ = chronos_inputs((batch, seq, heads, dim), 1, False, dtype, gen)
            fwd = lambda: fused_chronos_attention(qkv, seg, bias)  # noqa: E731
            ref = plain_chronos_attention(qkv, seg, bias)
            other = "mma.sync" if seq <= 96 else "wgmma"
            times: dict[str, list[float]] = {"persistent": [], other: []}
            for route in ("persistent", other, other, "persistent"):
                _kernels.set_chronos_route("rule" if route == "persistent" else route)
                if not times[route]:
                    want = {"persistent": 4, "mma.sync": 1, "wgmma": 3}[route]
                    if _kernels.chronos_plan(False, dtype, batch, seq, heads, dim)["route"] != want:
                        raise AssertionError(f"B4f S={seq}: the {route} route is not the plan's")
                    compare(f"B4f {route} route S={seq}", fwd(), ref)
                    if route == "persistent":
                        same_twice(f"B4f persistent route S={seq}", fwd)
                times[route].append(held_ms(fwd, 20)[0])
            _kernels.set_chronos_route("rule")
            mean = {r: sum(ts) / len(ts) for r, ts in times.items()}
            wins.append(mean["persistent"] < BORDER_MARGIN * mean[other])
            rule.append(_kernels.chronos_plan(False, dtype, batch, seq, heads, dim)["route"] == 4)
            print(f"[gate] B4f persistent bf16 D={dim} H={heads} S={seq} B={batch}, held device ms: persistent "
                  f"{mean['persistent']:.4f}, {other} {mean[other]:.4f}; both within tolerance of the plain "
                  f"version; the rule: {_kernels.chronos_route(False, dtype, batch, seq, heads, dim).split(',')[0]}",
                  flush=True)
    finally:
        _kernels.set_chronos_route("rule")
    persistent_border_line("B4f bf16 forward", FORWARD_BORDER_LENGTHS, wins, rule)


# B1f's shapes timed by --kernel-times in bf16 and fp32 beside KERNELS' 64 x 64 (against the
# parent with --root): serving at context 512 (64 x 16) and the c512 fine-tune's forward (256 x
# 16); in fp32 these are route 4's most launched shapes.
B1F_SHORT_SHAPES = ((64, 16, 16, 80), (256, 16, 16, 80))


def parent_kernels(root: str):
    """The ``ops/_kernels.py`` of the checkout at ``root`` (the parent commit's, say) as a
    module of its own: its library builds from that checkout's ``csrc/`` into that
    checkout's ``build/``, and its wrappers launch that library's kernels."""
    import importlib.util

    path = Path(root).resolve() / "multimodal_timesfm_torch" / "ops" / "_kernels.py"
    spec = importlib.util.spec_from_file_location("parent_kernels", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.library()
    return module


def parent_against_change(key: str, shape: tuple[int, int, int, int], parent, q, k, v, valid,
                          g) -> None:
    """One ``[kernels]`` line: the causal kernel ``key`` of the parent checkout's library against
    this one's on the same inputs (bf16: B1f, B1b, B2f, B2b, B3f, B3b; fp32: all six) at
    ``shape``, timed in turns (parent, change, change, parent; held to a graph replay's event
    time: a trace's device time swung 0.58-1.11x on unchanged bf16 B3 kernels within one call),
    with the largest difference between the two outputs. B1b writes dq|dk|dv into one fused (B, S, 3*H*D) gradient, as its entry point
    does."""
    from multimodal_timesfm_torch.ops import _kernels
    from multimodal_timesfm_torch.ops.qkv_attention import split_heads

    backward = key.endswith("b")
    batch, seq, heads, dim = shape

    def fresh():
        if key == "B1b":
            return split_heads(torch.empty(batch, seq, 3 * heads * dim, dtype=q.dtype, device="cuda"),
                               heads, dim)
        return tuple(torch.empty_like(q) for _ in range(3 if backward else 1))

    outs = {name: fresh() for name in ("parent", "change")}
    mods = {"parent": parent, "change": _kernels}

    def call(name):
        if backward:
            return lambda: mods[name].attention_bwd(q, k, v, valid, g, *outs[name])
        return lambda: mods[name].attention_fwd(q, k, v, valid, *outs[name])

    times: dict[str, list[float]] = {"parent": [], "change": []}
    iters = 5 if shape[1] > 1000 else 20
    for name in ("parent", "change", "change", "parent"):
        times[name].append(held_ms(call(name), iters)[0])
    torch.cuda.synchronize()
    diff = max((a.float() - b.float()).abs().max().item() for a, b in zip(outs["parent"], outs["change"]))
    ratio = sum(times["parent"]) / sum(times["change"])
    print(f"[kernels] {key} parent against change B={batch} S={seq} H={heads} D={dim} {str(q.dtype)[6:]}: "
          f"held device ms parent {times['parent'][0]:.4f} / {times['parent'][1]:.4f}, "
          f"change {times['change'][0]:.4f} / {times['change'][1]:.4f} ({ratio:.2f}x; change: "
          f"{_kernels.attention_route(backward, q.dtype, seq, dim)}); "
          f"max |parent - change| {diff:.3g}", flush=True)


def chronos_parent_against_change(shape: tuple[int, int, int, int], parent, qkv, seg, bias, g) -> None:
    """One ``[kernels]`` line: B4f, B4b without dbias and B4b with dbias of the parent
    checkout's library against this one's on the same inputs (fp32 or bf16) at ``shape``,
    timed in turns (parent, change, change, parent; held_ms), with the largest differences
    between the two outputs and each library's route."""
    from multimodal_timesfm_torch.ops import _kernels

    batch, seq, heads, dim = shape
    mods = {"parent": parent, "change": _kernels}
    outs = {name: (torch.empty(batch, seq, heads * dim, dtype=qkv.dtype, device="cuda"),
                   torch.empty_like(qkv), torch.empty_like(bias)) for name in mods}

    def calls(name):
        mod, (out, dqkv, dbias) = mods[name], outs[name]
        return (lambda: mod.chronos_attention_fwd(qkv, seg, bias, out, heads, dim),
                lambda: mod.chronos_attention_bwd(qkv, seg, bias, g, dqkv, None, heads, dim),
                lambda: mod.chronos_attention_bwd(qkv, seg, bias, g, dqkv, dbias, heads, dim))

    times: dict[str, list[tuple[float, ...]]] = {"parent": [], "change": []}
    for name in ("parent", "change", "change", "parent"):
        times[name].append(tuple(held_ms(fn, 20 if i == 0 else 10)[0] for i, fn in enumerate(calls(name))))
    torch.cuda.synchronize()
    diffs = [(a.float() - b.float()).abs().max().item() for a, b in zip(outs["parent"], outs["change"])]
    parts = []
    for i, what in enumerate(("B4f", "B4b (no dbias)", "B4b (with dbias)")):
        p, c = [t[i] for t in times["parent"]], [t[i] for t in times["change"]]
        parts.append(f"{what} parent {p[0]:.4f} / {p[1]:.4f}, change {c[0]:.4f} / {c[1]:.4f} "
                     f"({sum(p) / sum(c):.2f}x)")
    print(f"[kernels] B4 parent against change B={batch} S={seq} H={heads} D={dim} {str(qkv.dtype)[6:]}, held device "
          f"ms: {'; '.join(parts)} | max |parent - change| out {diffs[0]:.3g}, dqkv {diffs[1]:.3g}, dbias "
          f"{diffs[2]:.3g} | parent: {parent.chronos_route(True, qkv.dtype, batch, seq, heads, dim)}; "
          f"change: {_kernels.chronos_route(True, qkv.dtype, batch, seq, heads, dim)}", flush=True)


def kernel_times(seed: int, chronos_only: bool = False, root: str | None = None) -> None:
    """Every kernel at its main-path shapes, fp32 and bf16, checked against its plain version
    and timed beside the plain version, SDPA and the bound (``[kernels]`` lines): the six
    causal kernels (B1f/B1b, B2f/B2b, B3f/B3b) left-padded (skipped with ``chronos_only``), in
    fp32 at the shapes of CAUSAL_TF32_KERNELS (route 4 beside route 5 where the rule gives route 5) and
    in bf16 at those of KERNELS, then B4f, B4b without dbias and B4b with dbias at Chronos-2's
    fine-tune (128 x 67 tokens) and its serving at context 8192 (16 x 577), and at the
    fine-tune's shape with its 12 heads over a model axis of 2 (128 x 67 x 6), one segment.
    With ``root`` (``--root``: another checkout, such as the parent commit's) the bf16 B1b,
    B2f, B2b, B3f and B3b rows, every fp32 causal row, and every B4 shape in fp32 and bf16, are
    followed by that checkout's kernels against this one's on the same inputs, so that the two
    compare on one card in one run."""
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

    from multimodal_timesfm_torch.ops import _kernels

    forward = {"B2f": fused_causal_attention, "B3f": flash_causal_attention}
    backward = {"B2b": fused_causal_attention_bwd, "B3b": flash_causal_attention_bwd}
    parent = parent_kernels(root) if root is not None else None
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    causal = [(key, name, shape, torch.float32) for key, name, _, _, shape in CAUSAL_TF32_KERNELS]
    causal += [(key, name, shape, torch.bfloat16) for key, name, _, _, shape in KERNELS if not key.startswith("B4")]
    causal += [("B1f", "fused_qkv_causal_attention", shape, dtype) for shape in B1F_SHORT_SHAPES
               for dtype in (torch.float32, torch.bfloat16)]
    for key, name, shape, dtype in [] if chronos_only else causal:
        batch, seq, heads, dim = shape
        iters = 5 if seq > 1000 else 20
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
        if parent is not None and (dtype == torch.float32 or key[:2] in ("B1", "B2", "B3")):
            parent_against_change(key, shape, parent, q, k, v, valid, g4)
    for shape in (dict(KERNELS_BY_KEY)["B4f"], (128, 67, 6, 64), (64, 97, 12, 64), (64, 193, 12, 64),
                  (16, 577, 12, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            qkv, seg, bias, g = chronos_inputs(shape, 1, False, dtype, gen)
            errs = check_chronos(f"B4 {shape} 1 segment(s)", qkv, seg, bias, g)
            _, bwd = chronos_timed_rows(qkv, seg, bias, g, shape, errs, 10 if shape[1] < 100 else 5)
            if dtype == torch.float32 and shape == (16, 577, 12, 64):
                fwd_ms, both_ms = sdpa_graph_ms(qkv, seg, bias, g, shape[2], shape[3])
                print(f"[kernels] B4b fp32 {shape} against SDPA held in a CUDA graph: SDPA forward {fwd_ms:.4f} ms, "
                      f"forward + backward {both_ms:.4f}, backward {both_ms - fwd_ms:.4f}; B4b (no dbias) "
                      f"{bwd['ms']:.4f} held ({_kernels.chronos_route(True, dtype, *shape).split(',')[0]})",
                      flush=True)
            if parent is not None:
                chronos_parent_against_change(shape, parent, qkv, seg, bias, g)


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


# The Chronos plan's routes (chronos_attention_config), and the causal kernels'
# (attention_fwd_config / attention_bwd_config), by number ("fp32": the CUDA cores).
B4_ROUTES = ("fp32", "one-pass", "tiled", "wgmma", "persistent", "tf32", "tf32 persistent", "tf32 wgmma")
B1_ROUTES = ("fp32", "mma.sync", "wgmma", "persistent", "tf32", "tf32 wgmma")
# The wrappers whose launches route_launches splits by route: every one.
ROUTED_KEYS = ("B1f", "B1b", "B2f", "B2b", "B3f", "B3b", "B4f", "B4b")


def route_launches(by_length: bool = False) -> dict[str, int]:
    """Each kernel's launches since its ``.shapes`` tally was cleared, by the route the library
    gives each shape ("B1b persistent", "B2f tf32", "B4f one-pass", "B4b fp32", ...); with
    ``by_length``, by route and sequence length ("B1f tf32 S=16", ...)."""
    from multimodal_timesfm_torch.ops import _kernels

    out: dict[str, int] = {}
    for key in ROUTED_KEYS:
        for (dtype, batch, seq, heads, dim), n in launch_counters()[key].shapes.items():
            if not key.startswith("B4"):
                label = f"{key} {B1_ROUTES[_kernels.attention_route_number(key.endswith('b'), dtype, seq, dim)]}"
            else:
                route = _kernels.chronos_plan(key == "B4b", dtype, batch, seq, heads, dim)["route"]
                label = f"{key} {B4_ROUTES[route]}"
            if by_length:
                label += f" S={seq}"
            out[label] = out.get(label, 0) + n
    return out


def expect_launches(label: str, before: dict[str, int], want: dict[str, int]) -> dict[str, int]:
    """The launches since ``before`` must be ``want`` for the keys named there and 0 elsewhere."""
    delta = {key: n - before[key] for key, n in launch_counts().items()}
    full = {key: want.get(key, 0) for key in delta}
    if delta != full:
        raise AssertionError(f"{label}: launches {delta}, expected {full}")
    return {key: n for key, n in delta.items() if n}


def expect_route(label: str, backward: bool, shape: tuple[int, int], route: str,
                 dtype: torch.dtype = torch.bfloat16) -> None:
    """B4f's (or B4b's) route at (B, S) = ``shape``, 12 x 64 heads, in ``dtype``, as the library's
    plan gives it, must be ``route`` (one of B4_ROUTES); prints it."""
    from multimodal_timesfm_torch.ops import _kernels

    batch, seq = shape
    plan = _kernels.chronos_plan(backward, dtype, batch, seq, 12, 64)
    if B4_ROUTES[plan["route"]] != route:
        raise AssertionError(f"{label}: B4{'b' if backward else 'f'} at B={batch} S={seq} takes the "
                             f"{B4_ROUTES[plan['route']]} route, expected {route}")
    print(f"[route] {label}: B4{'b' if backward else 'f'} B={batch} S={seq}: "
          f"{_kernels.chronos_route(backward, dtype, batch, seq, 12, 64)}", flush=True)


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
        if ctx >= 2048:  # the bf16 wgmma route and, in fp32, route 7
            expect_route(f"chronos context {ctx} {dtype}", False, (bs, ctx // 16 + 65),
                         "wgmma" if dtype == torch.bfloat16 else "tf32 wgmma", dtype)
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
    # (workload, mode, dtype, decoder, context, batch, steps per epoch, trainer knobs);
    # horizon 32. The JAX bench's cells at context 32 (the bf16 one stores the frozen
    # encoder in bf16, as bench.py:317 does), then the fine-tune at context 8192 (577
    # tokens, Chronos-2's longest served context), full width and depth, in bf16 and in
    # fp32 (Chronos-2's default compute dtype), in both modes: the paths of B4b past the
    # one-pass route (bf16: the wgmma route; fp32: route 7; with dbias in baseline mode).
    cells = (
        ("chronos_mm_h32", "multimodal", torch.float32, decoders[torch.float32], 32, 128, 3, {}),
        ("chronos_mm_h32", "multimodal", torch.bfloat16, decoders[torch.bfloat16], 32, 128, 3,
         {"frozen_cast_dtype": torch.bfloat16}),
        ("chronos_baseline_h32", "baseline", torch.float32, decoders[torch.float32], 32, 128, 3, {}),
        ("chronos_mm_h32_mop2", "multimodal", torch.float32, packed[torch.float32], 32, 512, 3, {}),
        ("chronos_mm_c8192", "multimodal", torch.bfloat16, decoders[torch.bfloat16], 8192, 16, 2,
         {"frozen_cast_dtype": torch.bfloat16}),
        ("chronos_baseline_c8192", "baseline", torch.bfloat16, decoders[torch.bfloat16], 8192, 16, 2, {}),
        ("chronos_mm_c8192", "multimodal", torch.float32, decoders[torch.float32], 8192, 16, 2, {}),
        ("chronos_baseline_c8192", "baseline", torch.float32, decoders[torch.float32], 8192, 16, 2, {}),
    )
    with tempfile.TemporaryDirectory() as workdir:
        for name, mode, dtype, decoder, context, batch, steps, knobs in cells:
            label = f"{name} {mode} {str(dtype)[6:]}"
            load_jax_params(decoder, tree)
            train = make_samples(context, steps * batch, seed, CHRONOS_HORIZON, patch=16)
            val = make_samples(context, batch, seed + 1, CHRONOS_HORIZON, patch=16)
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
            if context == 8192:
                for backward in (False, True):
                    expect_route(label, backward, (batch, context // 16 + 65),
                                 "wgmma" if dtype == torch.bfloat16 else "tf32 wgmma", dtype)
            if not all(np.isfinite(x) for x in (warm, loss, val_loss)):
                raise AssertionError(f"{label}: non-finite loss {warm}, {loss}, {val_loss}")
            moved = float((decoder.adapter.encoder.rel_pos_bias.detach() - table).abs().max())
            if (mode == "baseline") != (moved > 0):
                raise AssertionError(f"{label}: rel_pos_bias moved by {moved} in {mode} mode")
            print(
                f"[train] {label}: context {context}, batch {batch}, {steps} steps per epoch | train "
                f"loss {warm:.5f} -> "
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
AOTI_ROOT = Path(__file__).resolve().parent / "build" / "aoti"


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
    package holds no weights; the parent re-points it); prints its compile seconds. Runs
    below the parent's CPU priority (it compiles beside the parent's phases), as do
    Inductor's compile workers, which inherit it."""
    from multimodal_timesfm_torch.serving import export_program

    os.nice(10)
    decoder = _served_decoder(name, getattr(torch, dtype))
    start = time.perf_counter()
    export_program(decoder, HORIZON, AOTI_CONTEXT, out, multimodal=True, format="aoti")
    print(json.dumps({"compile_s": time.perf_counter() - start}), flush=True)


def _kill(children: list) -> None:
    for child in children:
        if child.poll() is None:
            child.kill()
            child.wait()


def start_package_compiles() -> dict:
    """Phase 12's three package compiles, one child process each (``--compile-package``,
    Inductor's compile workers 3 a child), started ahead of the phase so that they run beside
    the phases before it; each child's output goes to files beside its package under
    AOTI_ROOT. Returns what :func:`aoti_phase` waits for; children still running when this
    process exits are killed."""
    import atexit

    cxx = openmp_cxx()
    print(f"[aoti] Inductor's host C++ compiler: {cxx}", flush=True)
    shutil.rmtree(AOTI_ROOT, ignore_errors=True)
    AOTI_ROOT.mkdir(parents=True)
    cells = {cell: AOTI_ROOT / f"{cell[0]}_{str(cell[1])[6:]}" for cell in AOTI_TOL}
    env = {**os.environ, "CXX": cxx, "TORCHINDUCTOR_COMPILE_THREADS": "3"}
    children = {}
    for cell, path in cells.items():
        with open(f"{path}.out", "w") as out, open(f"{path}.err", "w") as err:
            children[cell] = subprocess.Popen(
                [sys.executable, __file__, "--compile-package", cell[0], str(cell[1])[6:], str(path / "aoti")],
                stdout=out, stderr=err, text=True, env=env)
    atexit.register(_kill, list(children.values()))
    return {"cells": cells, "children": children, "start": time.perf_counter()}


def aoti_phase(seed: int, started: dict | None = None) -> dict:
    """TimesFM-2.5 200M (fp32, bf16) and Chronos-2 120M (bf16) at full width and depth as
    AOTInductor packages at context 512: the three compiled on the card at once, each in a
    child process of its own from the geometry alone (``started`` by
    :func:`start_package_compiles`, or here), then re-pointed
    (``save_program_params``) at weights drawn from ``seed``; beside each, the same
    decoder's ``torch.export`` program. Served from their files with ``load_program``:
    load seconds; series/s of the package, ``Forecaster`` and the program in turn on the
    same 192 series; B1f or B4f launches, one per layer and batch, through the package; the
    package bit-equal between calls and between two loads, and within AOTI_TOL of
    Forecaster; one profiled package call's idle share (``utils.profiling``). Returns, for
    phase 13, each cell's package directory, data, the package's forecasts, Forecaster's and
    the package's median series/s; the packages stay under ``build/aoti/`` (AOTI_ROOT) until
    :func:`remove_packages`."""
    from multimodal_timesfm_torch.inference import Forecaster
    from multimodal_timesfm_torch.models.bridge import load_jax_params, random_jax_params
    from multimodal_timesfm_torch.serving import export_program, load_program, save_program_params
    from multimodal_timesfm_torch.utils import profiling

    kind = torch.cuda.get_device_name(0)
    started = started or start_package_compiles()
    cells, children = started["cells"], started["children"]
    ctx = AOTI_CONTEXT
    served = {}
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
            child.wait(timeout=900)
            if child.returncode != 0:
                err = Path(f"{cells[cell]}.err").read_text()
                raise AssertionError(f"compiling the {cell} package failed:\n{err[-3000:]}")
            out = Path(f"{cells[cell]}.out").read_text()
            compiled[cell] = json.loads(out.strip().splitlines()[-1])["compile_s"]
    finally:
        _kill(list(children.values()))
    wall_s = time.perf_counter() - started["start"]
    print(f"[aoti] three packages compiled at once on the card, one child process each (Inductor's "
          f"compile workers 3 a child): {', '.join(f'{n} {str(d)[6:]} {s:.1f} s' for (n, d), s in compiled.items())}"
          f"; {wall_s:.1f} s from their start to the last, what ran before this phase and its setup "
          "alongside", flush=True)

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
        served[(name, dtype)] = {"path": path / "aoti", "context": context, "text": text, "outs": outs[0],
                                 "ref": ref, "package_rate": median["package"]}
        del decoder, fc, package, program
        torch.cuda.empty_cache()
    imported = sorted(m for m in ("jax", "multimodal_timesfm_tpu", "bench", "orbax") if m in sys.modules)
    if imported:
        raise AssertionError(f"the AOTI phase imported {imported}")
    return served


def remove_packages() -> None:
    shutil.rmtree(AOTI_ROOT, ignore_errors=True)


# Phase 13: phase 12's packages served by mtt_serve, a process that runs libtorch and no Python
# (multimodal_timesfm_torch/native.py builds it from csrc/mtt_serve.cpp and csrc/mtt_ops.cpp).
NATIVE_OPS = {"B1f": "fused_qkv_causal_attention", "B2f": "fused_causal_attention",
              "B3f": "flash_causal_attention", "B4f": "fused_chronos_attention"}
# Each forward op of the C++ registration at its main-path shapes (B, S, H, D): TimesFM's
# 16 x 80 heads in batches of 64 at 16 tokens and at 64 (B1f, serving at contexts 512 and
# 2048: the persistent route), 512 tokens (B2f) and 2,100 (B3f); Chronos-2's 12 x 64 heads at
# 67 tokens (B4f persistent) and 577 (B4f wgmma).
NATIVE_CHECK_SHAPES = (("B1f", (64, 16, 16, 80)), ("B1f", (64, 64, 16, 80)), ("B2f", (8, 512, 16, 80)),
                       ("B3f", (2, 2100, 16, 80)), ("B4f", (128, 67, 12, 64)), ("B4f", (16, 577, 12, 64)))
# The server's launches, added to the main paths' counts as phase 11's ranks' are.
NATIVE_LAUNCHES: dict[str, int] = {}


def needed(path: Path) -> list[str]:
    """The NEEDED entries of an ELF file's dynamic section (``readelf -d``)."""
    done = subprocess.run(["readelf", "-d", str(path)], capture_output=True, text=True, check=True)
    return [line.split("[", 1)[1].rstrip("]") for line in done.stdout.splitlines() if "(NEEDED)" in line]


def native_build_result(future):
    """The finished build: printed, and the server held to linking no Python."""
    made = future.result()
    libs = needed(made.server)
    python = [lib for lib in libs if lib.startswith("libpython") or lib.startswith("libtorch_python")]
    if python:
        raise AssertionError(f"mtt_serve links {python}")
    print(f"[native] built {made.directory.name} with {made.compiler} in {made.seconds:.1f} s, alongside "
          f"the work of this process (mtt_serve, libmtt_ops.so, libmtt_native.so; the CUDA ops linked to "
          f"the kernel library, not recompiled) | mtt_serve NEEDED: {', '.join(libs)}", flush=True)
    return made


def native_op_checks(seed: int, future) -> None:
    """The four CUDA ops of the C++ registration, loaded as ``mtt_native``, each bit-equal to
    the Python op (``torch.ops.mtt``) at the main-path shapes in fp32 and bf16, on inputs
    with padded and empty key rows (B1f-B3f, q, k, v strided views of one projection) and
    three segments with padded tokens (B4f), each call one launch of the C++ op's counter.
    The Python ops' launches made here are comparisons and are taken back off their
    counters."""
    from multimodal_timesfm_torch import native
    from multimodal_timesfm_torch.ops.qkv_attention import split_heads

    made = native_build_result(future)
    ops = native.load_check_ops()
    counters = launch_counters()
    saved = {key: (fn.launches, dict(getattr(fn, "shapes", {}))) for key, fn in counters.items()}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    try:
        for dtype in (torch.float32, torch.bfloat16):
            for key, (batch, seq, heads, dim) in NATIVE_CHECK_SHAPES:
                name = NATIVE_OPS[key]
                if key == "B4f":
                    qkv, seg, bias, _ = chronos_inputs((batch, seq, heads, dim), 3, True, dtype, gen)
                    args = (qkv, seg, bias)
                else:
                    qkv = (torch.randn(batch, seq, 3 * heads * dim, generator=gen, device="cuda")
                           / dim ** 0.25).to(dtype)
                    valid = left_padded_valid(batch, seq, gen)
                    valid[-1] = False  # a row with no valid key
                    args = ((qkv, valid, heads, dim) if key == "B1f"
                            else (*split_heads(qkv, heads, dim), valid))
                before = native.launch_counts(made.check_ops)[name]
                out = getattr(ops, name)(*args)
                ref = getattr(torch.ops.mtt, name)(*args)
                torch.cuda.synchronize()
                launched = native.launch_counts(made.check_ops)[name] - before
                if launched != 1:
                    raise AssertionError(f"mtt_native::{name} launched its kernel {launched} times, not once")
                if out.shape != ref.shape or not torch.equal(out, ref):
                    err = float((out.float() - ref.float()).abs().max()) if out.shape == ref.shape else math.inf
                    raise AssertionError(f"mtt_native::{name} {str(dtype)[6:]} {batch}x{seq}: differs from "
                                         f"the Python op by {err:.4g}")
                route = ""
                if key != "B4f":
                    from multimodal_timesfm_torch.ops import _kernels

                    number = _kernels.attention_route_number(False, dtype, seq, dim)
                    if dtype == torch.float32 and seq >= _kernels.TF32_WGMMA_FROM["forward"] and number != 5:
                        raise AssertionError(f"mtt_native::{name} float32 S={seq}: route {number}, not route 5")
                    route = f" on {_kernels.attention_route(False, dtype, seq, dim).split(',')[0]}"
                print(f"[native] mtt_native::{name} ({key}) {str(dtype)[6:]} B,S,H,D {batch},{seq},{heads},"
                      f"{dim}: bit-equal to torch.ops.mtt.{name}, one launch{route}", flush=True)
    finally:
        for key, fn in counters.items():
            fn.launches = saved[key][0]
            if hasattr(fn, "shapes"):
                fn.shapes.clear()
                fn.shapes.update(saved[key][1])


def python_flags() -> dict:
    """This process's matmul flags, under the server's names."""
    matmul = torch.backends.cuda.matmul
    return {"allow_tf32_cublas": bool(matmul.allow_tf32),
            "float32_matmul_precision": torch.get_float32_matmul_precision(),
            "allow_bf16_reduced_precision_reduction": bool(matmul.allow_bf16_reduced_precision_reduction),
            "allow_fp16_reduced_precision_reduction": bool(matmul.allow_fp16_reduced_precision_reduction)}


def native_phase(served: dict, future) -> None:
    """Phase 12's three packages served by ``mtt_serve`` in a subprocess (``native.serve``):
    the same 192 series in batches of 64, one pass for the forecasts and SERVE_REPEATS timed
    passes, each held bit-equal to the first batch by batch, timed in turn with the package
    loaded in this process (``load_program``: a pass before the server and one after). The
    server's forecasts must be bit-equal to this process's package's (phase 12's and this
    phase's) and within AOTI_TOL of Forecaster's; its launches 20 B1f (TimesFM) or 16 B4f
    (Chronos-2) a batch and nothing else; its matmul flags this process's."""
    from multimodal_timesfm_torch import native
    from multimodal_timesfm_torch.serving import load_program

    future.result()
    kind = torch.cuda.get_device_name(0)
    flags = python_flags()
    for (name, dtype), cell in served.items():
        label = f"{name} ({AOTI_LAYERS[name]} layers) context {AOTI_CONTEXT} {str(dtype)[6:]}"
        context, text, path = cell["context"], cell["text"], cell["path"]
        key, per = ("B4f", AOTI_LAYERS[name]) if name.startswith("chronos") else ("B1f", AOTI_LAYERS[name])
        package, _ = load_program(path, device="cuda")
        serve_padded(package, context[:64], text[:64], 64)  # warm-up
        python_rates, python_outs = [], []
        for turn in range(2):
            torch.cuda.synchronize()
            start = time.perf_counter()
            python_outs.append(serve_padded(package, context, text, 64))
            python_rates.append(len(context) / (time.perf_counter() - start))
            if turn == 0:
                outputs, info = native.serve(path, context, text, device="cuda", batch=64, repeat=SERVE_REPEATS)
        got = outputs["point_forecast"]
        for what, want in (("phase 12's package", cell["outs"]), ("this phase's package", python_outs[0]),
                           ("this phase's package, second pass", python_outs[1])):
            if got.shape != want.shape or not np.array_equal(got, want):
                err = float(np.abs(got - want).max()) if got.shape == want.shape else math.inf
                raise AssertionError(f"{label}: mtt_serve's forecasts differ from {what} by {err:.4g}")
        std = float(cell["ref"].std())
        diff = float(np.abs(got - cell["ref"]).max()) / std
        if not diff <= AOTI_TOL[(name, dtype)]:
            raise AssertionError(f"{label}: mtt_serve and Forecaster differ by {diff:.4g} x std")
        want = {op: (per * info["batches"] if op == NATIVE_OPS[key] else 0) for op in native.OPS}
        if info["launches"] != want:
            raise AssertionError(f"{label}: mtt_serve launched {info['launches']}, expected {want}")
        if info["flags"] != flags:
            raise AssertionError(f"{label}: mtt_serve's matmul flags {info['flags']} are not this process's {flags}")
        NATIVE_LAUNCHES[key] = NATIVE_LAUNCHES.get(key, 0) + per * info["batches"]
        rates = info["series_per_s"]
        print(f"[native] {label}: mtt_serve (no Python in its process) started in {info['start_s']:.3f} s, "
              f"loaded in {info['load_s']:.3f} s (package {info['package_load_s']:.3f} s, params.npz "
              f"{info['load_s'] - info['package_load_s']:.3f} s), {info['wall_s']:.3f} s in all | 192 series in "
              f"batches of 64, in turn: mtt_serve median {float(np.median(rates)):.1f} series/s "
              f"({', '.join(f'{r:.1f}' for r in rates)}), the package in this process "
              f"{float(np.median(python_rates)):.1f} ({', '.join(f'{r:.1f}' for r in python_rates)}; phase 12 "
              f"{cell['package_rate']:.1f}) on {kind} | {per} {key} ({NATIVE_OPS[key]}) launches a batch over "
              f"{info['batches']} batches | bit-equal to the package served in this process, every pass bit-equal "
              f"to the first; |mtt_serve - Forecaster| / std {diff:.4g} <= {AOTI_TOL[(name, dtype)]} | matmul "
              f"flags {info['flags']}", flush=True)
        del package
        torch.cuda.empty_cache()
    remove_packages()


def serving_times(seed: int, repeats: int = 7) -> None:
    """TimesFM-2.5 200M served through Forecaster at context 512 (200 series in batches of
    64, multimodal, horizon 128), fp32 and bf16: the median series/s of ``repeats`` calls
    after a warm-up, with the port imported from ``--root`` when given, then one profiled call:
    the device's busy time, idle share and B1f's kernels' share of busy (kernels named
    ``attention_fwd``). The serving path is host-bound, so series/s reads the cost of the
    attention entry points' dispatch; the shares are a trace's reading, which undercounts the
    persistent routes' few-microsecond launches (held times read them higher)."""
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
        wall, kernels = device_profile(lambda: fc.forecast_dataset(HORIZON, data, denormalize=True))
        busy = sum(ms for _, ms in kernels)
        attn = sum(ms for k, ms in kernels if "attention_fwd" in k)
        print(f"[serving-times] context 512 {str(dtype)[6:]}: median of {repeats} calls "
              f"{float(np.median(rates)):.1f} series/s ({', '.join(f'{r:.1f}' for r in rates)}) | profiled "
              f"call: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle {1 - busy / wall:.3f}, B1f "
              f"(attention_fwd*) {attn:.3f} ms, {attn / busy:.3f} of busy", flush=True)


def training_times(seed: int, epochs: int = 7) -> None:
    """Three bf16 fine-tune cells of the training phases, with the port imported from
    ``--root`` when given: TimesFM-2.5 multimodal at context 512 (batch 256, 16 tokens: B1b on
    its main-path shape), and Chronos-2's ``chronos_mm_h32`` (multimodal, the frozen encoder
    stored in bf16) and ``chronos_baseline_h32`` (baseline: dbias on the path), batch 128, 67
    tokens, context and horizon 32, bf16 compute; 3 steps an epoch. Per cell the median train
    series/s of ``epochs`` epochs after two of warm-up, then one profiled epoch: the device's
    busy time, idle share and the attention forward's and backward's kernels' shares of busy
    (B1f and B1b: kernels named ``attention_fwd`` and ``attention_bwd``; B4f and B4b:
    ``chronos_fwd`` and ``chronos_bwd``). The per-epoch loop is host-bound, so series/s moves
    with the host; the shares are the device's reading."""
    from multimodal_timesfm_torch.models.bridge import load_jax_params, random_jax_params
    from multimodal_timesfm_torch.models.chronos import Chronos2Adapter, Chronos2Config
    from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
    from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
    from multimodal_timesfm_torch.training_args import TrainingArguments

    dec_cfg = MultimodalDecoderConfig(text_embedding_dims=384, num_fusion_layers=1)

    def chronos():
        cfg = Chronos2Config()
        tree = random_jax_params(MultimodalDecoder(Chronos2Adapter(cfg), dec_cfg, device="cpu"), seed)
        decoder = MultimodalDecoder(
            Chronos2Adapter(dataclasses.replace(cfg, compute_dtype=torch.bfloat16)), dec_cfg, device="cuda")
        load_jax_params(decoder, tree)
        return decoder

    # (workload, decoder, mode, context, patch, horizon, batch, trainer knobs, backward kernels)
    cells = (
        ("timesfm_mm_c512", lambda: _timesfm_decoder(seed, torch.bfloat16), "multimodal", 512, 32,
         TRAIN_HORIZON, 256, {}, ("B1b", "attention_bwd")),
        ("chronos_mm_h32", chronos, "multimodal", 32, 16, CHRONOS_HORIZON, 128,
         {"frozen_cast_dtype": torch.bfloat16}, ("B4b", "chronos_bwd")),
        ("chronos_baseline_h32", chronos, "baseline", 32, 16, CHRONOS_HORIZON, 128, {},
         ("B4b", "chronos_bwd")),
    )
    steps = 3
    for name, build, mode, context, patch, horizon, batch, knobs, (key, family) in cells:
        decoder = build()
        train = make_samples(context, steps * batch, seed, horizon, patch=patch)
        val = make_samples(context, batch, seed + 1, horizon, patch=patch)
        with tempfile.TemporaryDirectory() as workdir:
            args = TrainingArguments(
                output_dir=workdir, per_device_train_batch_size=batch, per_device_eval_batch_size=batch,
                num_train_epochs=3, learning_rate=TRAIN_LR if mode == "multimodal" else BASELINE_LR,
                weight_decay=0.01, eval_strategy="epoch", save_strategy="no", logging_strategy="no",
                seed=seed)
            trainer = MultimodalTrainer(decoder, args, train, val, mode, device="cuda", **knobs)
            rates = []
            for epoch in range(epochs + 2):
                loss = trainer.train_epoch()
                if not np.isfinite(loss):
                    raise AssertionError(f"training-times {name}: loss {loss}")
                if epoch >= 2:
                    rates.append(trainer.last_throughput)
            wall, kernels = device_profile(trainer.train_epoch)
        busy = sum(ms for _, ms in kernels)
        share = sum(ms for k, ms in kernels if family in k)
        fwd_key, fwd_family = key[:2] + "f", family.replace("_bwd", "_fwd")
        fwd = sum(ms for k, ms in kernels if fwd_family in k)
        print(f"[training-times] {name} {mode} bfloat16, batch {batch}, {steps} steps an epoch: median of "
              f"{epochs} epochs {float(np.median(rates)):.1f} train series/s ({', '.join(f'{r:.1f}' for r in rates)}) "
              f"| profiled epoch: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle {1 - busy / wall:.3f}, "
              f"{fwd_key} ({fwd_family}*) {fwd:.3f} ms, {fwd / busy:.3f} of busy, "
              f"{key} ({family}*) {share:.3f} ms, {share / busy:.3f} of busy", flush=True)
        del decoder, trainer
        torch.cuda.empty_cache()


def fp32_times(seed: int, repeats: int = 5, epochs: int = 5) -> None:
    """TimesFM-2.5 200M and Chronos-2 120M in fp32, their default compute dtype, with the port
    imported from ``--root`` when given. TimesFM, where the causal kernels' fp32 route carries it:
    served through
    Forecaster (multimodal, horizon 128) at contexts 2048, 16384 and 67,200 (64, 512 and 2,100
    tokens: B1f, B2f, B3f; 200 series in batches of 64, 16 in batches of 8, 4 in batches of 2),
    the median series/s of ``repeats`` calls after a warm-up, then one profiled call; and the
    multimodal fine-tune at context 16384 (batch 16, 3 steps an epoch: B2f and B2b), the median
    train series/s of ``epochs`` epochs after one, a profiled epoch, and the most memory the
    card's allocator held over the fine-tune (``torch.cuda.max_memory_allocated``, from a reset
    before the trainer is built). Each profiled reading gives the device's busy time, its idle
    share and the attention kernels' share of busy (``attention_fwd*``, ``attention_bwd*``).
    Then Chronos-2 (chronos_fp32_times), where route 7 carries B4 past route 6's borders."""
    from multimodal_timesfm_torch.inference import Forecaster
    from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
    from multimodal_timesfm_torch.training_args import TrainingArguments

    def shares(kernels) -> str:
        busy = sum(ms for _, ms in kernels)
        fwd = sum(ms for k, ms in kernels if "attention_fwd" in k)
        bwd = sum(ms for k, ms in kernels if "attention_bwd" in k)
        return (f"device busy {busy:.3f} ms, attention forward {fwd / busy:.3f} and backward {bwd / busy:.3f} "
                f"of busy"), busy

    decoder = _timesfm_decoder(seed, torch.float32)
    for ctx, (n, batch) in {2048: (200, 64), 16384: (16, 8), 67200: (4, 2)}.items():
        data = make_samples(ctx, n, seed)
        fc = Forecaster(decoder, batch_size=batch, device="cuda")
        fc.forecast_dataset(HORIZON, data, denormalize=True)
        rates = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            start = time.perf_counter()
            fc.forecast_dataset(HORIZON, data, denormalize=True)
            rates.append(n / (time.perf_counter() - start))
        wall, kernels = device_profile(lambda: fc.forecast_dataset(HORIZON, data, denormalize=True))
        text, busy = shares(kernels)
        print(f"[fp32-times] serve context {ctx} float32, {n} series in batches of {batch}: median of {repeats} "
              f"calls {float(np.median(rates)):.1f} series/s ({', '.join(f'{r:.1f}' for r in rates)}) | profiled "
              f"call: wall {wall:.3f} ms, {text}, idle {1 - busy / wall:.3f}", flush=True)
    ctx, batch, steps = 16384, 16, 3
    train = make_samples(ctx, steps * batch, seed, TRAIN_HORIZON)
    val = make_samples(ctx, batch, seed + 1, TRAIN_HORIZON)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as workdir:
        args = TrainingArguments(
            output_dir=workdir, per_device_train_batch_size=batch, per_device_eval_batch_size=batch,
            num_train_epochs=3, learning_rate=TRAIN_LR, weight_decay=0.01, eval_strategy="epoch",
            save_strategy="no", logging_strategy="no", seed=seed)
        trainer = MultimodalTrainer(decoder, args, train, val, "multimodal", device="cuda")
        rates = []
        for epoch in range(epochs + 1):
            loss = trainer.train_epoch()
            if not np.isfinite(loss):
                raise AssertionError(f"fp32-times context {ctx}: loss {loss}")
            if epoch >= 1:
                rates.append(trainer.last_throughput)
        wall, kernels = device_profile(trainer.train_epoch)
        peak = torch.cuda.max_memory_allocated()
    text, busy = shares(kernels)
    print(f"[fp32-times] train context {ctx} multimodal float32, batch {batch}, {steps} steps an epoch: median "
          f"of {epochs} epochs {float(np.median(rates)):.1f} train series/s ({', '.join(f'{r:.1f}' for r in rates)}) "
          f"| profiled epoch: wall {wall:.3f} ms, {text}, idle {1 - busy / wall:.3f} | peak memory allocated "
          f"{peak / 2**30:.3f} GiB", flush=True)
    del decoder, trainer
    torch.cuda.empty_cache()
    chronos_fp32_times(seed, repeats, epochs)


def chronos_fp32_times(seed: int, repeats: int = 5, epochs: int = 5) -> None:
    """Chronos-2 120M in fp32 (full width and depth, weights from ``seed``), where route 7 carries
    B4 past route 6's borders: served through Forecaster (multimodal, horizon 128) at contexts 2048
    and 8192 (193 and 577 tokens: B4f; 200 series in batches of 64, 16 in batches of 16), the median
    series/s of ``repeats`` calls after a warm-up, then one profiled call; and the fine-tunes at
    context 8192 (batch 16, 2 steps an epoch, horizon 32), ``chronos_mm_c8192`` (multimodal: B4f,
    B4b) and ``chronos_baseline_c8192`` (baseline: B4b with dbias), the median train series/s of
    ``epochs`` epochs after one, a profiled epoch, and the most memory the card's allocator held
    over the fine-tune (``torch.cuda.max_memory_allocated``, from a reset before the trainer is
    built). Each profiled reading gives the device's busy time, its idle share and B4f's and B4b's
    shares of busy (``chronos_fwd_*``, ``chronos_bwd*``)."""
    from multimodal_timesfm_torch.inference import Forecaster
    from multimodal_timesfm_torch.models.bridge import load_jax_params, random_jax_params
    from multimodal_timesfm_torch.models.chronos import Chronos2Adapter, Chronos2Config
    from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
    from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
    from multimodal_timesfm_torch.training_args import TrainingArguments

    def shares(kernels) -> tuple[str, float]:
        busy = sum(ms for _, ms in kernels)
        fwd = sum(ms for k, ms in kernels if "chronos_fwd_" in k)
        bwd = sum(ms for k, ms in kernels if "chronos_bwd" in k)
        return f"device busy {busy:.3f} ms, B4f {fwd / busy:.3f} and B4b {bwd / busy:.3f} of busy", busy

    dec_cfg = MultimodalDecoderConfig(text_embedding_dims=384, num_fusion_layers=1)
    decoder = MultimodalDecoder(Chronos2Adapter(dataclasses.replace(Chronos2Config(), compute_dtype=torch.float32)),
                                dec_cfg, device="cpu")
    tree = random_jax_params(decoder, seed)
    load_jax_params(decoder, tree)
    decoder = decoder.cuda()
    for ctx, (n, batch) in {2048: (200, 64), 8192: (16, 16)}.items():
        data = make_samples(ctx, n, seed, HORIZON, patch=16)
        fc = Forecaster(decoder, batch_size=batch, device="cuda")
        fc.forecast_dataset(HORIZON, data, denormalize=True)
        rates = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            start = time.perf_counter()
            fc.forecast_dataset(HORIZON, data, denormalize=True)
            rates.append(n / (time.perf_counter() - start))
        wall, kernels = device_profile(lambda: fc.forecast_dataset(HORIZON, data, denormalize=True))
        text, busy = shares(kernels)
        print(f"[fp32-times] chronos serve context {ctx} ({ctx // 16 + 65} tokens) float32, {n} series in batches "
              f"of {batch}: median of {repeats} calls {float(np.median(rates)):.1f} series/s "
              f"({', '.join(f'{r:.1f}' for r in rates)}) | profiled call: wall {wall:.3f} ms, {text}, idle "
              f"{1 - busy / wall:.3f}", flush=True)
    ctx, batch, steps = 8192, 16, 2
    train = make_samples(ctx, steps * batch, seed, CHRONOS_HORIZON, patch=16)
    val = make_samples(ctx, batch, seed + 1, CHRONOS_HORIZON, patch=16)
    for name, mode in (("chronos_mm_c8192", "multimodal"), ("chronos_baseline_c8192", "baseline")):
        load_jax_params(decoder, tree)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as workdir:
            args = TrainingArguments(
                output_dir=workdir, per_device_train_batch_size=batch, per_device_eval_batch_size=batch,
                num_train_epochs=3, learning_rate=TRAIN_LR if mode == "multimodal" else BASELINE_LR,
                weight_decay=0.01, eval_strategy="epoch", save_strategy="no", logging_strategy="no", seed=seed)
            trainer = MultimodalTrainer(decoder, args, train, val, mode, device="cuda")
            rates = []
            for epoch in range(epochs + 1):
                loss = trainer.train_epoch()
                if not np.isfinite(loss):
                    raise AssertionError(f"fp32-times {name}: loss {loss}")
                if epoch >= 1:
                    rates.append(trainer.last_throughput)
            wall, kernels = device_profile(trainer.train_epoch)
            peak = torch.cuda.max_memory_allocated()
        text, busy = shares(kernels)
        print(f"[fp32-times] train {name} {mode} float32, context {ctx}, batch {batch}, {steps} steps an epoch: "
              f"median of {epochs} epochs {float(np.median(rates)):.1f} train series/s "
              f"({', '.join(f'{r:.1f}' for r in rates)}) | profiled epoch: wall {wall:.3f} ms, {text}, idle "
              f"{1 - busy / wall:.3f} | peak memory allocated {peak / 2**30:.3f} GiB", flush=True)
        del trainer
        torch.cuda.empty_cache()


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
                        help="with --kernel-times: also time this checkout's kernels (bf16 B1b, B2, B3; "
                             "fp32 B1-B3; B4) "
                             "beside this one's; with --serving-times or --training-times: import the "
                             "port from this checkout instead")
    parser.add_argument("--chronos-only", action="store_true",
                        help="with --kernel-times: only the Chronos rows (B4f, B4b)")
    parser.add_argument("--serving-times", action="store_true",
                        help="only time TimesFM serving at context 512 (fp32, bf16)")
    parser.add_argument("--training-times", action="store_true",
                        help="only time three eager bf16 training cells (TimesFM c512, chronos_mm_h32, "
                             "chronos_baseline_h32) and their attention backward's share")
    parser.add_argument("--fp32-times", action="store_true",
                        help="only time fp32 end to end: TimesFM serving at contexts 2048, 16384 and 67,200 "
                             "and its c16384 fine-tune, then Chronos-2 serving at contexts 2048 and 8192 and "
                             "its c8192 fine-tunes in both modes: series/s, attention shares, peak memory")
    parser.add_argument("--dispatch-times", action="store_true",
                        help="only time one call of the B1 entry point: custom op against autograd.Function")
    parser.add_argument("--parallel-only", action="store_true",
                        help="only build the kernels and run phase 11 (the mesh)")
    parser.add_argument("--aoti-only", action="store_true",
                        help="only build the kernels and run phase 12 (the AOTInductor packages)")
    parser.add_argument("--native-only", action="store_true",
                        help="only build the kernels and mtt_serve, check the C++ ops, run phases 12 and 13")
    parser.add_argument("--compile-package", nargs=3, metavar=("NAME", "DTYPE", "OUT"),
                        help="phase 12's child process: compile one package")
    args = parser.parse_args()
    if args.chronos_only and not args.kernel_times:
        parser.error("--chronos-only needs --kernel-times")
    if args.root is not None and not (args.kernel_times or args.serving_times or args.training_times
                                      or args.fp32_times):
        parser.error("--root needs --kernel-times, --serving-times, --training-times or --fp32-times")
    if args.root is not None and not args.kernel_times:
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
            if ("registers" in line or "spill" in line or "Compiling entry" in line
                    or "Potential Performance Loss" in line):
                print(f"[build] {line.strip()}")
    for line in sass_mma_report(lib_path, require_wgmma=args.root is None or args.kernel_times):
        print(f"[build] SASS {line}")
    if log.exists() and hasattr(_kernels.library(), "tf32w_fwd_smem"):
        for line in ptxas_report(log.read_text(), require=args.root is None or args.kernel_times):
            print(f"[build] ptxas {line}")
        lib = _kernels.library()
        print(f"[build] ptxas route 5 dynamic shared memory a block: forward {lib.tf32w_fwd_smem()} bytes (two "
              f"blocks an SM), backward statistics {lib.tf32w_bwd_smem(1)}, dq {lib.tf32w_bwd_smem(2)}, dkdv "
              f"{lib.tf32w_bwd_smem(3)} bytes (one block an SM)", flush=True)
        if hasattr(lib, "chronos_tf32w_fwd_smem"):
            print(f"[build] ptxas route 7 dynamic shared memory a block: forward {lib.chronos_tf32w_fwd_smem()} "
                  f"bytes, backward statistics {lib.chronos_tf32w_bwd_smem(1)}, dq {lib.chronos_tf32w_bwd_smem(2)}, "
                  f"dkdv {lib.chronos_tf32w_bwd_smem(3)} bytes (one block an SM each)", flush=True)
    gpu = gpu_line()
    print(f"[gpu] {gpu} | torch {torch.__version__} CUDA {torch.version.cuda} | port from "
          f"{_kernels.CSRC.parent if hasattr(_kernels, 'CSRC') else _kernels.SOURCES[0].parent.parent}",
          flush=True)
    if args.serving_times or args.training_times or args.fp32_times or args.dispatch_times:
        if args.serving_times:
            serving_times(args.seed)
        if args.training_times:
            training_times(args.seed)
        if args.fp32_times:
            fp32_times(args.seed)
        if args.dispatch_times:
            dispatch_times()
        print(f"[gpu] {gpu}")
        return 0
    if args.aoti_only:
        for counter in launch_counters().values():
            counter.launches = 0
        start = time.perf_counter()
        aoti_phase(args.seed)
        remove_packages()
        print(f"[phase] aoti package: {time.perf_counter() - start:.1f} s | launches {launch_counts()}", flush=True)
        print(f"[gpu] {gpu}")
        return 0
    if not (args.parallel_only or args.kernel_times):
        from multimodal_timesfm_torch import native

        native_future = native.start_build(True)  # the compilers run alongside what follows
    if args.native_only:
        start = time.perf_counter()
        native_op_checks(args.seed, native_future)
        print(f"[phase] native ops: {time.perf_counter() - start:.1f} s", flush=True)
        start = time.perf_counter()
        served = aoti_phase(args.seed)
        print(f"[phase] aoti package: {time.perf_counter() - start:.1f} s", flush=True)
        start = time.perf_counter()
        native_phase(served, native_future)
        print(f"[phase] native serving: {time.perf_counter() - start:.1f} s | launches {NATIVE_LAUNCHES}", flush=True)
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
        print_routes()
        if not args.chronos_only:
            route_borders(args.seed)
        chronos_route_borders(args.seed)
        chronos_f32_borders(args.seed)
        chronos_f32_persistent_borders(args.seed)
        chronos_f32_wgmma_borders(args.seed)
        if not args.chronos_only:
            causal_f32_borders(args.seed)
        persistent_route_borders(args.seed, args.chronos_only)
        kernel_times(args.seed, args.chronos_only, args.root)
        print(f"[gpu] {gpu}")
        return 0
    print_routes()

    def phase(name: str, fn, *a):
        start = time.perf_counter()
        out = fn(*a)
        print(f"[phase] {name}: {time.perf_counter() - start:.1f} s", flush=True)
        return out

    phase("route borders", route_borders, args.seed)
    phase("chronos route borders", chronos_route_borders, args.seed)
    phase("persistent route borders", persistent_route_borders, args.seed)
    rows = phase("forward kernels", kernel_phase, args.seed)
    rows.update(phase("backward kernels", backward_kernel_phase, args.seed))
    phase("edge shapes", edge_checks, args.seed)
    phase("gate lengths", gate_length_checks, args.seed)
    rows.update(phase("chronos kernels", chronos_kernel_phase, args.seed))
    phase("batch chunks", batch_chunk_checks, args.seed)
    rows.update(phase("flash kernels", flash_kernel_phase, args.seed))
    phase("vmap rules", vmap_rule_checks, args.seed)
    phase("native ops", native_op_checks, args.seed, native_future)

    # The main paths: every launch counter starts at 0 just before each and is read
    # just after; the kernels line reports their sum.
    launches = {key: 0 for key, *_ in KERNELS}
    routes: dict[str, int] = {}
    lengths: dict[str, int] = {}

    def main_path(name: str, fn, *a):
        for counter in launch_counters().values():
            counter.launches = 0
        for key in ROUTED_KEYS:
            launch_counters()[key].shapes.clear()
        GRAPH_LAUNCHES.clear()
        RANK_LAUNCHES.clear()
        NATIVE_LAUNCHES.clear()
        out = phase(name, fn, *a)
        for key, n in launch_counts().items():
            launches[key] += (n + GRAPH_LAUNCHES.get(key, 0) + RANK_LAUNCHES.get(key, 0)
                              + NATIVE_LAUNCHES.get(key, 0))
        for route, n in route_launches().items():
            routes[route] = routes.get(route, 0) + n
        for route, n in route_launches(by_length=True).items():
            lengths[route] = lengths.get(route, 0) + n
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
    compiles = start_package_compiles()  # phase 12's, beside phases 8 and 9
    main_path("time-mmd data", time_mmd_phase, args.seed, tree)
    del tree
    torch.cuda.empty_cache()
    main_path("pretrained to served", pretrained_phase, args.seed)
    torch.cuda.empty_cache()
    served = main_path("aoti package", aoti_phase, args.seed, compiles)
    torch.cuda.empty_cache()
    main_path("native serving", native_phase, served, native_future)
    del served
    main_path("sweeps", sweep_phase, args.seed)
    torch.cuda.empty_cache()
    main_path("parallel", parallel_phase, args.seed)
    idle = [key for key, n in launches.items() if n == 0]
    idle += [f"{key} wgmma" for key, *_ in CHRONOS_WGMMA_KERNELS if not routes.get(f"{key} wgmma")]
    idle += [f"{key} persistent" for key in ("B1f", "B1b", "B4f", "B4b") if not routes.get(f"{key} persistent")]
    idle += [f"{key} tf32 wgmma" for key, *_ in TF32W_CHRONOS_KERNELS if not routes.get(f"{key} tf32 wgmma")]
    idle += [f"{key} tf32 persistent" for key, *_ in TF32_PERSISTENT_KERNELS
             if not routes.get(f"{key} tf32 persistent")]
    idle += [f"{key} {causal_f32_label(key, shape[1])}" for key, *_, shape in CAUSAL_TF32_KERNELS
             if (key, shape) not in CAUSAL_TF32_TIMED_ONLY and not routes.get(f"{key} {causal_f32_label(key, shape[1])}")]
    if idle:
        raise AssertionError(f"kernels never launched on the main paths: {idle}")
    print(f"[launches] main paths: {launches}")
    print(f"[launches] every kernel by route, this process's counted launches (replays and the ranks' "
          f"not split): {routes}")
    print(f"[launches] every kernel by route and length, the same counts: {dict(sorted(lengths.items()))}")
    print(json.dumps({"kernels": kernel_entries(rows, launches) + wgmma_route_entries(rows, routes)
                      + persistent_route_entries(rows, routes) + tf32w_chronos_entries(rows, routes)
                      + tf32_persistent_entries(rows, routes) + causal_tf32_entries(rows, routes)}))
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
