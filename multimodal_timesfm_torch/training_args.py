"""Training arguments: a field-for-field copy of the JAX package's frozen dataclass.

The YAML loader, the warmup-steps rule (int >= 1 = exact steps, float in
[0, 1) = ratio of total steps) and the output/logs/checkpoints directory
creation are the same.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Literal

from multimodal_timesfm_torch.utils.yaml import parse_yaml


@dataclass(frozen=True)
class TrainingArguments:
    # --- Output ---
    output_dir: str = field(default="outputs")

    # --- Training Duration and Batch Size ---
    per_device_train_batch_size: int = field(default=8)
    num_train_epochs: int = field(default=10)

    # --- Learning Rate & Scheduler ---
    learning_rate: float = field(default=1e-4)
    lr_scheduler_type: Literal["linear", "cosine"] = field(default="linear")
    warmup_steps: float = field(default=0.0)

    # --- Optimizer ---
    weight_decay: float = field(default=0.0)
    # Storage dtype of the AdamW moments; "bfloat16" halves the optimizer
    # state while the update still accumulates in fp32
    # (training/optimization.AdamW).
    adam_moment_dtype: Literal["float32", "bfloat16"] = field(default="float32")

    # --- Regularization & Training Stability ---
    gradient_accumulation_steps: int = field(default=1)
    max_grad_norm: float = field(default=1.0)

    # --- Logging & Monitoring ---
    logging_strategy: Literal["no", "epoch", "steps"] = field(default="steps")
    logging_steps: int = field(default=100)

    # --- Experiment Tracking ---
    run_name: str | None = field(default=None)

    # --- Evaluation ---
    eval_strategy: Literal["no", "epoch", "steps"] = field(default="no")
    per_device_eval_batch_size: int = field(default=8)

    # --- Checkpointing & Saving ---
    save_strategy: Literal["no", "epoch", "steps", "best"] = field(default="steps")
    save_total_limit: int | None = field(default=None)

    # --- Best Model Tracking ---
    load_best_model_at_end: bool = field(default=False)

    # --- Loss ---
    # "mse": point-channel MSE. "quantile": pinball loss over the adapter's
    # quantile channels plus MSE on its mean channel when one exists.
    loss_type: Literal["mse", "quantile"] = field(default="mse")

    # --- Reproducibility ---
    seed: int | None = field(default=None)

    def __post_init__(self) -> None:
        if self.loss_type not in ("mse", "quantile"):
            raise ValueError(
                f"Unsupported loss_type: {self.loss_type!r} (expected 'mse' or 'quantile')"
            )
        if self.adam_moment_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"Unsupported adam_moment_dtype: {self.adam_moment_dtype!r} "
                "(expected 'float32' or 'bfloat16')"
            )
        Path(self.output_dir).mkdir(parents=True, exist_ok=True)
        self.logging_dir.mkdir(parents=True, exist_ok=True)
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)

    @property
    def logging_dir(self) -> Path:
        return Path(self.output_dir) / "logs"

    @property
    def checkpoint_dir(self) -> Path:
        return Path(self.output_dir) / "checkpoints"

    @classmethod
    def from_yaml(cls, yaml_path: Path | str) -> TrainingArguments:
        return parse_yaml(Path(yaml_path), cls)

    def get_warmup_steps(self, num_training_steps: int) -> int:
        """int >= 1 -> exact steps; float in [0, 1) -> ceil(ratio * total)."""
        return (
            int(self.warmup_steps)
            if self.warmup_steps >= 1
            else math.ceil(num_training_steps * self.warmup_steps)
        )
