"""Sweep trials for the tuning CLIs: one at a time, or a whole group at once.

The port's counterpart of ``examples/time_mmd/sweep_lib.py``:

  * :func:`train_and_evaluate` runs one trial as the reference does:
    ``MultimodalTrainer`` with the run's hyperparameters, the best checkpoint
    restored, ``MultimodalEvaluator`` on the test fold, the metrics logged
    through the run, the checkpoints removed;
  * :func:`train_and_evaluate_many` groups the runs by their structural
    hyperparameters (:func:`_structural_key`) and trains each group's trials
    at once over one shared backbone (``training/vectorized.py``), with the
    frozen folds the trainer takes (at one patch token the seq1 fold, in
    multimodal mode the affine fold), the device budget refused before
    anything is staged, and failures isolated per trial and per group.

Both build the backbone through ``time_mmd/models.py`` and run on CUDA unless
``device`` names another device. Over a mesh (``parallel/``, every rank
running the same sweep), a trial's trainer and evaluator split its batches
over the data axis, and a vectorized group whose size the data axis divides
splits its trials over it (the device budget is then per device); rank 0
alone writes and removes files.
"""

from __future__ import annotations

import shutil
from dataclasses import replace
from pathlib import Path
from typing import Any

import numpy as np
import torch

from multimodal_timesfm_torch.data.collate import stack_samples
from multimodal_timesfm_torch.models.decoder import MultimodalDecoder, MultimodalDecoderConfig
from multimodal_timesfm_torch.models.layers import fold_frozen_tree_affines, fold_frozen_tree_seq1
from multimodal_timesfm_torch.parallel.mesh import DATA_AXIS, axis_size, barrier, check_mesh, is_main_rank
from multimodal_timesfm_torch.time_mmd.configs import ForecastConfig, ModelConfig
from multimodal_timesfm_torch.time_mmd.cross_validation import DomainSpec, load_fold_datasets
from multimodal_timesfm_torch.time_mmd.models import build_adapter, init_decoder_params
from multimodal_timesfm_torch.training import vectorized
from multimodal_timesfm_torch.training.checkpoint import load_checkpoint
from multimodal_timesfm_torch.training.evaluator import MultimodalEvaluator
from multimodal_timesfm_torch.training.trainer import MultimodalTrainer
from multimodal_timesfm_torch.training_args import TrainingArguments
from multimodal_timesfm_torch.types import TrainingMode
from multimodal_timesfm_torch.utils.logging import get_logger
from multimodal_timesfm_torch.utils.platform import resolve_device

_logger = get_logger()

# The fixed fold of domains with good textual data, as the reference selects it.
FOLD_DOMAINS = ["Agriculture", "Economy", "Environment", "Health_US", "Traffic"]


def fold_domain_specs(augment_splits: set[str]) -> tuple[list[DomainSpec], list[DomainSpec], list[DomainSpec]]:
    """Train/val/test DomainSpecs for the fixed fold."""
    return tuple(
        [DomainSpec(name=f"{d}_{split}", augment=split in augment_splits) for d in FOLD_DOMAINS]
        for split in ("train", "val", "test")
    )


def parse_fusion_hparams(config: Any) -> tuple[int, list[int]]:
    """The fusion MLP's depth and hidden widths from a run config (the reference's keys
    and guards)."""
    num_fusion_layers = config.get("num_fusion_layers", 1)
    fusion_hidden_dims: list[int] = []
    if num_fusion_layers == 1:
        pass
    elif num_fusion_layers == 2:
        dim = config.get("fusion_hidden_dim", None)
        if dim is None:
            raise ValueError("fusion_hidden_dim is required when num_fusion_layers is 2")
        fusion_hidden_dims = [dim]
    elif num_fusion_layers == 3:
        d1 = config.get("fusion_hidden_dim_1", None)
        d2 = config.get("fusion_hidden_dim_2", None)
        if d1 is None or d2 is None:
            raise ValueError(
                "fusion_hidden_dim_1 and fusion_hidden_dim_2 are required when num_fusion_layers is 3"
            )
        fusion_hidden_dims = [d1, d2]
    else:
        raise ValueError(f"num_fusion_layers must be between 1 and 3, got {num_fusion_layers}")
    return num_fusion_layers, fusion_hidden_dims


def override_training_args(base: TrainingArguments, config: Any) -> TrainingArguments:
    """``base`` with the run's sampled hyperparameters applied."""
    return replace(
        base,
        per_device_train_batch_size=config.get("batch_size", base.per_device_train_batch_size),
        num_train_epochs=config.get("num_epochs", base.num_train_epochs),
        learning_rate=config.get("learning_rate", base.learning_rate),
        lr_scheduler_type=config.get("lr_scheduler_type", base.lr_scheduler_type),
        warmup_steps=config.get("warmup_steps", base.warmup_steps),
        weight_decay=config.get("weight_decay", base.weight_decay),
        gradient_accumulation_steps=config.get(
            "gradient_accumulation_steps", base.gradient_accumulation_steps
        ),
    )


def _fold_datasets(
    model_config: ModelConfig, forecast_config: ForecastConfig, cache_dir: Path,
    augment_splits: set[str], require_pretrained_text: bool,
):
    train_specs, val_specs, test_specs = fold_domain_specs(augment_splits)
    return load_fold_datasets(
        train_domain_specs=train_specs,
        val_domain_specs=val_specs,
        test_domain_specs=test_specs,
        text_encoder_type=model_config.fusion.text_encoder_type,
        patch_len=model_config.adapter.patch_len,
        context_len=forecast_config.context_len,
        horizon_len=forecast_config.horizon_len,
        cache_dir=cache_dir,
        require_pretrained_embeddings=require_pretrained_text,
    )


def _decoder(
    model_config: ModelConfig, pretrained_dir: str | None, num_layers: int, hidden: tuple[int, ...],
    seed: int,
) -> MultimodalDecoder:
    """A fresh decoder on the CPU: the backbone as configured, weights from ``seed`` (then
    the snapshot's backbone)."""
    decoder = MultimodalDecoder(
        build_adapter(model_config, pretrained_dir),
        MultimodalDecoderConfig(
            text_embedding_dims=model_config.fusion.text_embedding_dims,
            num_fusion_layers=num_layers,
            fusion_hidden_dims=tuple(hidden),
        ),
        device="cpu",
    )
    init_decoder_params(decoder, pretrained_dir, seed)
    return decoder


def train_and_evaluate(
    run: Any,
    base_training_args: TrainingArguments,
    model_config: ModelConfig,
    forecast_config: ForecastConfig,
    mode: TrainingMode,
    cache_dir: Path,
    augment_splits: set[str],
    pretrained_dir: str | None,
    mesh: Any = None,
    require_pretrained_text: bool = False,
    device: str | torch.device | None = None,
) -> dict:
    """One sweep trial: train, restore the best epoch, evaluate on the test fold, log,
    clean up. Returns the test metrics."""
    config = run.config
    _logger.info("Starting sweep run %s with config: %s", run.id, dict(config.items()))

    num_fusion_layers, fusion_hidden_dims = parse_fusion_hparams(config)
    training_args = override_training_args(base_training_args, config)
    train_dataset, val_dataset, test_dataset = _fold_datasets(
        model_config, forecast_config, cache_dir, augment_splits, require_pretrained_text
    )
    decoder = _decoder(
        model_config, pretrained_dir, num_fusion_layers, tuple(fusion_hidden_dims), training_args.seed or 0
    )
    trainer = MultimodalTrainer(
        decoder, training_args, train_dataset, val_dataset, mode, device=device, mesh=mesh, wandb_run=run
    )
    trainer.train()

    checkpoint = load_checkpoint(training_args.checkpoint_dir / "best_model.ckpt")
    best_val_loss = checkpoint["best_val_loss"]
    trainer.load_trained_params(checkpoint[trainer._params_key])

    evaluator = MultimodalEvaluator(trainer.eval_model, device=trainer.device, mesh=mesh)
    test_metrics = evaluator.evaluate(
        test_dataset,
        batch_size=training_args.per_device_eval_batch_size,
        multimodal=mode == "multimodal",
        # The quantile heads are scored too when they were the training objective.
        quantile_metrics=training_args.loss_type == "quantile",
    )
    _logger.info(
        "Run %s — best_val_loss: %.6f, test_mse: %.6f, test_mae: %.6f",
        run.id, best_val_loss, test_metrics["mse"], test_metrics["mae"],
    )
    logged = {
        "val/best_loss": best_val_loss,
        "test/mse": test_metrics["mse"],
        "test/mae": test_metrics["mae"],
    }
    if "wql" in test_metrics:
        logged["test/wql"] = test_metrics["wql"]
        logged["test/mean_pinball"] = test_metrics["mean_pinball"]
    run.log(logged, step=trainer.global_step)

    barrier()  # every rank has read the best checkpoint
    if is_main_rank() and training_args.checkpoint_dir.exists():
        shutil.rmtree(training_args.checkpoint_dir)
    return dict(test_metrics)


def _structural_key(config: Any, base: TrainingArguments) -> tuple:
    """The hyperparameters that change the trained program (the group key); unsampled
    values fall back to ``base`` as ``override_training_args`` resolves them."""
    num_layers, hidden = parse_fusion_hparams(config)
    args = override_training_args(base, config)
    return (
        num_layers,
        tuple(hidden),
        args.per_device_train_batch_size,
        args.num_train_epochs,
        args.lr_scheduler_type,
        args.gradient_accumulation_steps,
    )


def train_and_evaluate_many(
    runs: list,
    base_training_args: TrainingArguments,
    model_config: ModelConfig,
    forecast_config: ForecastConfig,
    cache_dir: Path,
    augment_splits: set[str],
    pretrained_dir: str | None,
    require_pretrained_text: bool = False,
    mesh: Any = None,
    mode: TrainingMode = "multimodal",
    device: str | torch.device | None = None,
) -> None:
    """Vectorized sweep: each structural group's trials trained at once.

    Sampled configs are grouped by :func:`_structural_key` (fusion architecture,
    batch size, epochs, schedule family, accumulation) and each group runs
    ``run_vectorized_trials`` over one decoder whose frozen child all its trials
    share, then ``evaluate_vectorized`` on the test fold; every trial logs
    ``val/best_loss``, ``test/mse`` and ``test/mae`` through its run, as
    :func:`train_and_evaluate` does. Every trial starts from the same init and
    batch order (``seed_stride=0``), as sequential trials of one seed do.

    Baseline mode vectorizes too while the group fits: each trial carries 5 fp32
    copies of the trained backbone (``vectorized_max_trials``), and a larger
    group raises with the computed budget (logged as that group's error). A
    config that fails validation, or a group that fails, logs its error to its
    runs and the rest still run; if every trial fails, this raises. With a
    ``mesh``, a group whose size its data axis divides splits its trials over it
    (the budget then holds per device: ``T_max x dp`` trials); another group runs
    unsharded on every rank, with a warning.
    """
    check_mesh(mesh, "train_and_evaluate_many")
    target = resolve_device(device)
    train_dataset, val_dataset, test_dataset = _fold_datasets(
        model_config, forecast_config, cache_dir, augment_splits, require_pretrained_text
    )
    multimodal = mode == "multimodal"
    trainable_key = "fusion" if multimodal else "adapter"

    def as_dict(dataset) -> dict[str, np.ndarray]:
        stacked = stack_samples(dataset, multimodal=multimodal)
        out = {"context": stacked.context, "horizon": stacked.horizon}
        if multimodal:
            out["text"] = stacked.text_embeddings
        return out

    train_d, val_d, test_d = as_dict(train_dataset), as_dict(val_dataset), as_dict(test_dataset)

    groups: dict[tuple, list] = {}
    failures = 0
    for run in runs:
        try:
            key = _structural_key(run.config, base_training_args)
        except Exception as e:  # noqa: BLE001 - trial isolation: the error is logged to its run
            failures += 1
            _logger.warning("Trial %s failed config validation: %s", run.id, e)
            run.log({"error": f"{type(e).__name__}: {e}"})
            continue
        groups.setdefault(key, []).append(run)
    if runs and not groups:
        raise RuntimeError(f"All {failures} vectorized sweep trial(s) failed validation")

    def run_group(key: tuple, group: list) -> None:
        num_layers, hidden, batch_size, num_epochs, scheduler, accum = key
        training_args = override_training_args(base_training_args, group[0].config)
        decoder = _decoder(model_config, pretrained_dir, num_layers, hidden, training_args.seed or 0)
        if multimodal and forecast_config.context_len == model_config.adapter.patch_len:
            # One patch token end to end: each frozen layer's attention folds into one
            # (D, D) GEMM, shared by every trial and the evaluation (TimesFM only).
            fold_frozen_tree_seq1(decoder.adapter)
        if multimodal:
            # The frozen norms' gains and the query scale into the adjacent weights.
            fold_frozen_tree_affines(decoder.adapter)

        # Shard the trial axis over the mesh when the group divides evenly; otherwise run
        # the group unsharded on every rank (trials stay correct either way).
        group_mesh = mesh
        if mesh is not None and len(group) % axis_size(mesh, DATA_AXIS) != 0:
            _logger.warning(
                "Group of %d trials not divisible by mesh data axis (%d); running unsharded",
                len(group), axis_size(mesh, DATA_AXIS),
            )
            group_mesh = None
        dp = axis_size(group_mesh, DATA_AXIS)

        trained = getattr(decoder, trainable_key)
        trainable_bytes = sum(p.numel() * 4 for p in trained.parameters())
        hbm = vectorized.device_hbm_bytes()
        max_t = vectorized.vectorized_max_trials(trainable_bytes, hbm)
        # The budget is per device: each holds len(group) / dp trials.
        per_device_trials = len(group) // dp
        if per_device_trials > max_t:
            raise ValueError(
                f"Vectorized {mode} group of {len(group)} trials exceeds the device budget: each "
                f"trial carries 5 fp32 copies of the {trainable_bytes / 1e6:.0f}MB trained tree "
                f"(params + AdamW mu/nu + best + grads) = {5 * trainable_bytes / 1e9:.2f}GB/trial, "
                f"and 75% of the {hbm / 1e9:.1f}GB device memory fits {max_t} trial(s) per device "
                f"({per_device_trials} would land on each of {dp} device(s)). Split the "
                f"sweep into groups of <= {max_t * dp} (--count) or run sequentially."
            )
        inits = vectorized.replicate_trainables(
            {k: v.detach().clone() for k, v in trained.named_parameters()}, len(group), group_mesh
        )
        decoder.to(target)

        num_batches = -(-len(train_d["context"]) // batch_size)
        total_steps = num_epochs * -(-num_batches // accum)
        # Per-trial continuous hyperparameters; unsampled ones fall back to the base args.
        hp = {
            "learning_rate": np.asarray(
                [r.config.get("learning_rate", base_training_args.learning_rate) for r in group]
            ),
            "weight_decay": np.asarray(
                [r.config.get("weight_decay", base_training_args.weight_decay) for r in group]
            ),
            "warmup_steps": np.asarray(
                [
                    override_training_args(base_training_args, r.config).get_warmup_steps(total_steps)
                    for r in group
                ],
                np.float32,
            ),
        }
        _logger.info("Vectorized group %s: %d trial(s) at once", key, len(group))
        try:
            results = vectorized.run_vectorized_trials(
                decoder, inits, train_d, val_d, hp,
                horizon_len=forecast_config.horizon_len,
                batch_size=batch_size,
                num_epochs=num_epochs,
                accum=accum,
                scheduler=scheduler,
                max_grad_norm=training_args.max_grad_norm,
                seed=training_args.seed or 0,
                seed_stride=0,
                eval_batch_size=training_args.per_device_eval_batch_size,
                loss_type=training_args.loss_type,
                trainable_key=trainable_key,
                mesh=group_mesh,
            )
            mse, mae = vectorized.evaluate_vectorized(
                decoder, results.best_trainable, test_d,
                horizon_len=forecast_config.horizon_len,
                batch_size=training_args.per_device_eval_batch_size,
                trainable_key=trainable_key,
                mesh=group_mesh,
            )
        finally:
            # This group's programs pin its decoder and trial buffers: free them now.
            vectorized.release_programs(decoder)
        steps_per_epoch = -(-num_batches // accum)
        for t, run in enumerate(group):
            _logger.info(
                "Run %s — best_val_loss: %.6f, test_mse: %.6f, test_mae: %.6f",
                run.id, results.best_val[t], mse[t], mae[t],
            )
            run.log(
                {
                    "val/best_loss": float(results.best_val[t]),
                    "test/mse": float(mse[t]),
                    "test/mae": float(mae[t]),
                },
                step=num_epochs * steps_per_epoch,
            )

    for key, group in groups.items():
        try:
            run_group(key, group)
        except Exception as e:  # noqa: BLE001 - group isolation: the error is logged to its runs
            failures += len(group)
            _logger.warning("Vectorized group %s failed: %s", key, e)
            for run in group:
                run.log({"error": f"{type(e).__name__}: {e}"})
    if runs and failures == len(runs):
        raise RuntimeError(f"All {failures} vectorized sweep trial(s) failed")
