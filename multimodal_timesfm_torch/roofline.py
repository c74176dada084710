"""Per-workload roofline accounting on one H100, for the port's trainer.

Counterpart of ``scripts/roofline.py``. It decomposes a bench workload's
per-optimizer-step time into the same terms, with the H100's constants:

  * compute: the analytic GEMM FLOPs of the bench's per-series model at a
    sustained GEMM efficiency (``--eff``; read a workload's own from an eager
    step's trace with ``utils.profiling.gemm_efficiency``);
  * residual streams: the bytes autograd saves in one micro-batch's forward
    at the workload's full geometry, each written once forward and read once
    backward, at HBM bandwidth. They are counted with
    ``torch.autograd.graph.saved_tensors_hooks`` on a trainer built on the
    ``meta`` device and run under ``FakeTensorMode``, so nothing is computed
    or allocated, with the attention on the card's route (the kernels save
    q, k, v and the mask; the plain attention would save its (B, H, S, S)
    weights);
  * weight streams: the frozen weights read by the forward and the input-
    gradient GEMMs in multimodal mode (stored in bf16), or the 38P
    parameter-traffic scheme in baseline mode;
  * the fixed cost of one fused call (``train_epochs_fused``), measured on
    the card, amortized over the call's steps;
  * validation: one forward-only batch per epoch.

Ceiling MFU = ideal time / total time, ideal = FLOPs / peak.

    python -m multimodal_timesfm_torch.roofline --workload timesfm_mm_c32 [--eff E] [--json]

Runs on the CPU, no card needed. The workloads, their architectures and the
FLOP model are this module's copies of the root ``bench.py``'s
(``WORKLOADS``, ``WORKLOAD_ARCH``, ``timesfm_flops_per_series``,
``chronos_flops_per_series``): its ``build_trainer`` imports the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import tempfile

import numpy as np
import torch

from multimodal_timesfm_torch.utils.profiling import H100_PEAK_FLOPS as PEAK

HBM_BW = 3.35e12  # H100 SXM HBM3 bytes/s (NVIDIA's data sheet)
# The fixed cost of one fused call (train_epochs_fused after its capture: staging the
# epoch orders, the final read-back), solved from a 1-epoch and a 3-epoch call of
# timesfm_mm_c32 on one trainer: 0.563065 s and 1.685703 s (chip_smoke.py's headline
# phase on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit). Another run read
# 0.562784 s and 1.688565 s, -0.000107 s: the cost is within the timing's noise.
FIXED_DISPATCH_S = 0.001747
# The duration-weighted efficiency of timesfm_mm_c32's GEMMs in one eager bf16 step
# against PEAK (utils.profiling.gemm_efficiency in the same run, on the same card).
DEFAULT_EFF = 0.4794

# name -> (backbone, context, horizon, batch, samples, epochs, mode): bench.py:358-403.
WORKLOADS: dict[str, tuple[str, int, int, int, int, int, str]] = {
    "timesfm_mm_c32": ("timesfm", 32, 32, 2048, 131072, 3, "multimodal"),
    "timesfm_baseline_c32": ("timesfm", 32, 32, 8192, 65536, 2, "baseline"),
    "timesfm_mm_c512": ("timesfm", 512, 32, 256, 8192, 2, "multimodal"),
    "timesfm_mm_c2048": ("timesfm", 2048, 32, 64, 2048, 2, "multimodal"),
    "timesfm_mm_c16384": ("timesfm", 16384, 32, 16, 768, 1, "multimodal"),
    "chronos_mm_h32": ("chronos", 32, 32, 128, 4096, 2, "multimodal"),
    "chronos_baseline_h32": ("chronos", 32, 32, 128, 4096, 2, "baseline"),
    "chronos_mm_h32_mop2": ("chronos", 32, 32, 512, 32768, 2, "multimodal"),
}
WORKLOAD_ARCH: dict[str, dict] = {
    "chronos_mm_h32_mop2": {"max_output_patches": 2, "pack": 16},
}
TEXT_DIMS = 384


def timesfm_flops_per_series(
    cfg, context: int, mode: str, text_dims: int = TEXT_DIMS, fold: bool = True
) -> float:
    """Training FLOPs/series: fwd + input-grad path (frozen backbone) or +dW.

    ``fold`` mirrors the seq==1 attention fold of the trainer measured (its
    ``folded_seq1``): the required per-layer attention FLOPs at one token
    are then one (md, md) GEMM, else the v and out projections.
    """
    n = context // cfg.input_patch_len
    p, md, ffn = cfg.input_patch_len, cfg.model_dims, cfg.ffn_dims
    o, q = cfg.output_patch_len, cfg.num_output_channels
    tokenizer = 2 * n * (2 * p * md + md * md + 2 * p * md)
    if n == 1:
        attn_gemms = 2 * md * md if (mode == "multimodal" and fold) else 4 * md * md
    else:
        attn_gemms = 8 * md * md
    stack = cfg.num_layers * (n * (attn_gemms + 4 * md * ffn) + 4 * n * n * md)
    # The head projects only the last patch (the only one returned).
    head = 2 * (md * md + 2 * md * o * q)
    fwd = tokenizer + stack + head
    # multimodal: the frozen backbone needs d/d(input) through every matmul (about
    # 1x fwd); the fusion needs dX and dW (about 3x its fwd). baseline: fwd+dX+dW.
    if mode == "multimodal":
        return 2.0 * fwd + 3.0 * (2 * n * text_dims * md)
    return 3.0 * fwd


def chronos_flops_per_series(
    cfg, context: int, mode: str, text_dims: int = TEXT_DIMS, horizon: int = 32
) -> float:
    nc = context // cfg.input_patch_size
    mop = cfg.max_output_patches
    s = nc + (1 if cfg.use_reg_token else 0) + mop
    p, dm, ffn = cfg.input_patch_size, cfg.model_dim, cfg.ffn_dim
    qo = cfg.num_quantiles * cfg.output_patch_size
    embed = 2 * (nc + mop) * (3 * p * ffn + ffn * dm + 3 * p * dm)
    stack = cfg.num_layers * (s * (8 * dm * dm + 4 * dm * ffn) + 4 * s * s * dm)
    # The head projects only the patches that survive the horizon slice.
    head_patches = min(mop, -(-horizon // cfg.output_patch_size))
    head = 2 * head_patches * (dm * ffn + ffn * qo + dm * qo)
    fwd = embed + stack + head
    if mode == "multimodal":
        return 2.0 * fwd + 3.0 * (2 * nc * text_dims * dm)
    return 3.0 * fwd


def build_trainer(workload: str, samples: int | None = None):
    """(the port's trainer for ``workload`` as the JAX bench configures it, built on the
    ``meta`` device, its config). bf16 compute; multimodal mode stores the frozen
    adapter in bf16, baseline mode keeps bf16 Adam moments. ``samples`` defaults to
    max(batch, 8): the per-step trace depends on the batch geometry only."""
    from multimodal_timesfm_torch.data.collate import StackedDataset
    from multimodal_timesfm_torch.models.chronos import Chronos2Adapter, Chronos2Config
    from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
    from multimodal_timesfm_torch.models.timesfm import TimesFM2p5Adapter, TimesFMConfig
    from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
    from multimodal_timesfm_torch.training_args import TrainingArguments

    backbone, context, horizon, batch, _, epochs, mode = WORKLOADS[workload]
    arch = WORKLOAD_ARCH.get(workload, {})
    cls, cfg = (TimesFM2p5Adapter, TimesFMConfig()) if backbone == "timesfm" else (Chronos2Adapter, Chronos2Config())
    cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16, **arch)
    with torch.device("meta"):
        decoder = MultimodalDecoder(cls(cfg), MultimodalDecoderConfig(text_embedding_dims=TEXT_DIMS), device="meta")
    n = samples or max(batch, 8)
    patches = context // decoder.adapter.patch_len
    rng = np.random.default_rng(0)
    data = StackedDataset(
        context=rng.normal(size=(n, context)).astype(np.float32),
        horizon=rng.normal(size=(n, horizon)).astype(np.float32),
        text_embeddings=rng.normal(size=(n, patches, TEXT_DIMS)).astype(np.float32) if mode == "multimodal" else None,
        metadata=[{} for _ in range(n)],
    )
    args = TrainingArguments(
        output_dir=tempfile.gettempdir(), per_device_train_batch_size=batch, per_device_eval_batch_size=batch,
        num_train_epochs=epochs, learning_rate=1e-4, save_strategy="no", logging_strategy="no", seed=0,
        adam_moment_dtype="bfloat16" if mode == "baseline" else "float32",
    )
    trainer = MultimodalTrainer(
        decoder, args, data, data, mode, device="meta",
        frozen_cast_dtype=torch.bfloat16 if mode == "multimodal" else None,
    )
    return trainer, cfg


def saved_bytes(trainer) -> tuple[int, list[tuple[str, int]]]:
    """(total bytes, [(dtype and shape, bytes)]) of the tensors autograd saves in the forward
    of one micro-batch of ``trainer``'s batch size, each tensor once; the parameters and
    buffers it saves, and views of them, are weights, counted by the weight term instead.

    The trainer lives on the ``meta`` device and the forward runs under
    ``FakeTensorMode``, so nothing is computed; the attention takes the
    kernels' route there, as on the card."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from multimodal_timesfm_torch.ops.attention import kernel_route

    weights = {id(t) for t in (*trainer.model.parameters(), *trainer.model.buffers())}
    seen: dict[int, torch.Tensor] = {}

    def pack(t: torch.Tensor) -> torch.Tensor:
        base = t if t._base is None else t._base  # a GEMM saves its weight as a transposed view
        if id(base) not in weights:
            seen.setdefault(id(t), t)
        return t

    batch = trainer.args.per_device_train_batch_size
    idx = np.arange(batch) % len(trainer.train_data)
    ones = np.ones(batch, np.float32)
    with FakeTensorMode(allow_non_fake_inputs=True), kernel_route():
        mb = trainer._micro_batch(trainer.train_data, trainer._train_device, idx, ones, ones.sum())
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            trainer._loss(mb)
    streams = [(f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}", t.numel() * t.element_size())
               for t in seen.values()]
    return sum(b for _, b in streams), streams


def roofline(workload: str, eff: float = DEFAULT_EFF, fixed_s: float = FIXED_DISPATCH_S) -> tuple[dict, list]:
    """(the roofline of ``workload`` with JAX's keys, its saved-tensor streams)."""
    backbone, context, horizon, batch, samples, epochs, mode = WORKLOADS[workload]
    trainer, cfg = build_trainer(workload)
    res_bytes, streams = saved_bytes(trainer)

    # --- compute term ---
    if backbone == "timesfm":
        fps = timesfm_flops_per_series(cfg, context, mode, fold=trainer.folded_seq1)
    else:
        fps = chronos_flops_per_series(cfg, context, mode, horizon=horizon)
    flops_step = fps * batch
    t_ideal = flops_step / PEAK
    t_compute = flops_step / (PEAK * eff)

    # --- weight / parameter traffic term ---
    frozen = trainer.eval_model.adapter if mode == "multimodal" else trainer.eval_model.fusion
    p_frozen = sum(p.numel() for p in frozen.parameters())
    p_train = sum(p.numel() for p in trainer.trainable_module.parameters())
    if mode == "multimodal":
        # The frozen child stored in bf16: read by the forward GEMMs and by the dX ones.
        w_bytes = 2 * (2 * p_frozen)
        w_note = f"frozen bf16 weights fwd+dX reads (P={p_frozen / 1e6:.1f}M)"
    else:
        # Full fine-tune: fp32 masters, a bf16 compute copy, bf16 moments, fp32 grads and
        # the global-norm read.
        w_bytes = 38 * p_train
        w_note = f"38P parameter-traffic scheme (P={p_train / 1e6:.1f}M)"
    t_weights = w_bytes / HBM_BW

    # --- residual term: each saved tensor written forward, read backward ---
    t_residual = 2 * res_bytes / HBM_BW

    # --- fixed + validation terms ---
    steps_per_epoch = samples // batch
    steps_total = steps_per_epoch * epochs
    t_fixed = fixed_s / steps_total
    fwd_share = 2.0 if mode == "multimodal" else 3.0
    n_val = max(batch, 8)
    t_val = (fps / fwd_share) * n_val / (PEAK * eff) / steps_per_epoch

    t_total = t_compute + t_weights + t_residual + t_fixed + t_val
    out = {
        "workload": workload,
        "batch": batch,
        "steps_per_dispatch": steps_total,
        "flops_per_series": fps,
        "gemm_eff": eff,
        "ms_compute": round(t_compute * 1e3, 2),
        "ms_weights": round(t_weights * 1e3, 2),
        "ms_residual": round(t_residual * 1e3, 2),
        "ms_fixed": round(t_fixed * 1e3, 2),
        "ms_val": round(t_val * 1e3, 2),
        "ms_total": round(t_total * 1e3, 2),
        "residual_stream_mb": round(res_bytes / 1e6, 1),
        "num_residual_streams": len(streams),
        "ceiling_mfu": round(t_ideal / t_total, 3),
        "ceiling_series_per_sec": round(batch / t_total, 1),
        "weight_note": w_note,
    }
    return out, streams


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True, choices=sorted(WORKLOADS))
    ap.add_argument("--eff", type=float, default=DEFAULT_EFF,
                    help="sustained GEMM efficiency vs the bf16 peak (read from this workload's "
                    f"trace when available; default {DEFAULT_EFF}, timesfm_mm_c32's on the H100)")
    ap.add_argument("--json", action="store_true", help="print one JSON line only")
    args = ap.parse_args(argv)
    out, streams = roofline(args.workload, args.eff)
    print(json.dumps(out))
    if not args.json:
        print("\nTensors autograd saves in one micro-batch's forward (written fwd + read bwd):")
        grouped: collections.Counter = collections.Counter()
        counts: collections.Counter = collections.Counter()
        for name, nbytes in streams:
            grouped[name] += nbytes
            counts[name] += 1
        for name, nbytes in grouped.most_common():
            print(f"  {name:40s} x{counts[name]:<4d} {nbytes / 1e6:9.1f} MB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
