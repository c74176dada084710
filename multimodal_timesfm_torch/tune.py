"""Hyperparameter tuning for multimodal forecasting: W&B sweeps or the local sweep engine.

    python -m multimodal_timesfm_torch.tune --sweep-config SWEEP.yml [--count N] \\
        [--model-config M.yml] [--forecast-config F.yml] [--augment [train val test]] \\
        [--cache-dir data/cache] [--pretrained-dir DIR] [--offline] [--output-dir DIR] \\
        [--seed N] [--loss-type mse|quantile] [--require-pretrained-text] [--vectorized] \\
        [--sweep-id ID] [--device cpu]

The port's counterpart of ``scripts/tune_time_mmd_sweep.py``, with its flags
plus ``--device`` (CUDA by default). With wandb installed and without
``--offline`` it drives a W&B sweep (``--sweep-id`` joins one); otherwise
``LocalSweep`` samples the sweep YAML's space (TPE under ``method: bayes``)
and each trial logs to ``<output-dir>/sweep_results.jsonl``.
``--vectorized`` claims every trial's run id on disk first, trains the
trials grouped by structure at once over one shared backbone
(``time_mmd/sweep_lib.train_and_evaluate_many``), then feeds the finished
trials back to the TPE state. ``python -m multimodal_timesfm_torch.tune_baseline``
runs the same in baseline mode.

Over N ranks (one per device) the CLI runs under ``torch.distributed.run``:

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        -m multimodal_timesfm_torch.tune --sweep-config SWEEP.yml --offline ...

Every rank runs the same sweep over a (data, model) mesh of all N ranks
(data-parallel), as the JAX CLI does with more than one device: a trial's
batches, or a vectorized group's trials, split over the data axis. Rank 0
alone writes ``sweep_results.jsonl`` and the sweep state.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Any

import torch.distributed

from multimodal_timesfm_torch.parallel.distributed import initialize_multihost
from multimodal_timesfm_torch.parallel.mesh import barrier, make_mesh
from multimodal_timesfm_torch.time_mmd.configs import ForecastConfig, ModelConfig
from multimodal_timesfm_torch.time_mmd.sweep_lib import train_and_evaluate, train_and_evaluate_many
from multimodal_timesfm_torch.training_args import TrainingArguments
from multimodal_timesfm_torch.utils.logging import setup_logger
from multimodal_timesfm_torch.utils.seed import set_seed
from multimodal_timesfm_torch.utils.tracking import LocalRun, LocalSweep, try_import_wandb
from multimodal_timesfm_torch.utils.yaml import load_yaml

MODE = "multimodal"


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Run a hyperparameter sweep for multimodal time series forecasting."
    )
    parser.add_argument("--sweep-id", type=str, help="Existing W&B sweep ID to join.")
    parser.add_argument("--sweep-config", type=str, help="Path to a sweep YAML config file.")
    parser.add_argument("--count", type=int, help="Number of sweep runs to execute.")
    parser.add_argument("--model-config", type=str)
    parser.add_argument("--forecast-config", type=str)
    parser.add_argument("--augment", nargs="*", choices=["train", "val", "test"], default=["train"])
    parser.add_argument("--cache-dir", type=str, default="data/cache")
    parser.add_argument("--pretrained-dir", type=str, help="Local backbone checkpoint dir.")
    parser.add_argument("--offline", action="store_true", help="Force the local sweep engine.")
    parser.add_argument("--output-dir", type=str, default=None)
    parser.add_argument("--seed", type=int)
    parser.add_argument(
        "--loss-type", choices=["mse", "quantile"], default="mse",
        help="Training objective: mse (reference parity) or quantile "
        "(mean-MSE + pinball over the adapter's quantile channels).",
    )
    parser.add_argument(
        "--require-pretrained-text", action="store_true",
        help="Refuse embedding caches built without pretrained text-encoder weights.",
    )
    parser.add_argument(
        "--vectorized", action="store_true",
        help="Train the sweep's trials at once on the device (grouped by structural "
        "hyperparameters, vmapped over lr/weight-decay/warmup). Offline engine only; "
        "results land in the same sweep_results.jsonl.",
    )
    parser.add_argument("--device", type=str, help="Device to train on (default: CUDA).")
    return parser.parse_args(argv)


def _sweep(args: argparse.Namespace, mode: str, mesh: Any) -> int:
    logger = setup_logger()

    model_config = ModelConfig.from_yaml(args.model_config) if args.model_config else ModelConfig()
    forecast_config = (
        ForecastConfig.from_yaml(args.forecast_config) if args.forecast_config else ForecastConfig()
    )
    output_dir = args.output_dir or f"outputs/sweeps/{mode}"
    base_training_args = TrainingArguments(
        output_dir=output_dir,
        logging_strategy="epoch",
        eval_strategy="epoch",
        save_strategy="best",
        load_best_model_at_end=False,
        loss_type=args.loss_type,
        seed=args.seed,
    )
    if args.seed is not None:
        set_seed(args.seed)
    augment_splits = set(args.augment)

    def run_trial(run) -> None:
        train_and_evaluate(
            run=run,
            base_training_args=base_training_args,
            model_config=model_config,
            forecast_config=forecast_config,
            mode=mode,
            cache_dir=Path(args.cache_dir),
            augment_splits=augment_splits,
            pretrained_dir=args.pretrained_dir,
            require_pretrained_text=args.require_pretrained_text,
            device=args.device,
            mesh=mesh,
        )

    if args.vectorized:
        if args.sweep_id:
            logger.error(
                "--vectorized runs a LOCAL sweep engine and cannot contribute trials to W&B "
                "sweep %s — drop --sweep-id or --vectorized.",
                args.sweep_id,
            )
            return 1
        if not args.sweep_config:
            logger.error("--sweep-config is required for --vectorized.")
            return 1
        sweep = LocalSweep(load_yaml(args.sweep_config), Path(output_dir), seed=args.seed or 0)
        results_path = Path(output_dir) / "sweep_results.jsonl"
        offset = sweep.next_trial_index()  # relaunches continue the numbering
        runs = [
            LocalRun(f"local-{offset + t}", sweep.sample(), results_path)
            for t in range(1 if args.count is None else args.count)
        ]
        barrier()  # every rank has read the numbering before rank 0 writes
        for run in runs:
            # Claim the run ids on disk before training: a killed group otherwise
            # leaves no record, and a relaunch would reuse the ids.
            run.log({"event": "trial_start", "config": dict(run.config.items())})
        logger.info("Vectorized sweep: %d trial(s)", len(runs))
        train_and_evaluate_many(
            runs=runs,
            base_training_args=base_training_args,
            model_config=model_config,
            forecast_config=forecast_config,
            cache_dir=Path(args.cache_dir),
            augment_splits=augment_splits,
            pretrained_dir=args.pretrained_dir,
            require_pretrained_text=args.require_pretrained_text,
            mode=mode,
            device=args.device,
            mesh=mesh,
        )
        # The finished trials go to the TPE engine's durable state: a relaunch in the
        # same output directory resumes with these observations.
        metric_name = sweep.metric.get("name")
        if metric_name is not None:
            for run in runs:
                if metric_name in run.summary:
                    sweep.observe(dict(run.config.items()), float(run.summary[metric_name]))
        logger.info("Sweep agent finished")
        return 0

    wandb = None if args.offline else try_import_wandb()
    project = f"{mode}-{model_config.adapter.type}-time-mmd"
    if wandb is not None:
        if args.sweep_id:
            sweep_id = args.sweep_id
            logger.info("Joining existing sweep %s", sweep_id)
        else:
            if not args.sweep_config:
                logger.error("Either --sweep-id or --sweep-config must be provided.")
                return 1
            sweep_id = wandb.sweep(sweep=load_yaml(args.sweep_config), project=project)
            logger.info("Created new sweep %s", sweep_id)

        def sweep_fn() -> None:
            with wandb.init(project=project) as run:
                run_trial(run)

        logger.info("Starting W&B agent (count=%s)", args.count)
        wandb.agent(sweep_id, function=sweep_fn, project=project, count=args.count)
    else:
        if not args.sweep_config:
            logger.error("--sweep-config is required for the local sweep engine.")
            return 1
        logger.info("W&B unavailable or --offline: running the local sweep engine")
        sweep = LocalSweep(load_yaml(args.sweep_config), Path(output_dir), seed=args.seed or 0)
        sweep.agent(run_trial, count=args.count)

    logger.info("Sweep agent finished")
    return 0


def main(argv: list[str] | None = None, mode: str = MODE) -> int:
    args = parse_args(argv)
    # Launched over more than one rank (torch.distributed.run): one mesh of all of them.
    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        initialize_multihost(backend="gloo" if args.device == "cpu" else None)
        mesh = make_mesh()
    try:
        return _sweep(args, mode, mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
