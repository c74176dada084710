"""Trainer: per-epoch training with mode-based parameter partitioning.

Counterpart of ``multimodal_timesfm_tpu/training/trainer.py``'s per-epoch
loop (``train`` -> ``_train_loop``), with the same semantics:

  * multimodal mode trains the ``fusion`` child of the decoder with the
    adapter frozen; baseline mode trains the ``adapter``. The trained
    parameters get ``requires_grad``, the rest lose it;
  * all-False input masks at train time; batches padded to a static size
    with zero-weight rows, the loss divided by ``max(sum(weights) * H, 1)``;
  * point-channel MSE, or the quantile objective (``loss_type="quantile"``);
  * gradient accumulation as the mean of the micro-batch gradients, fp32
    global-norm clipping, AdamW, and the schedule advanced per optimizer
    step (``training/optimization.py``);
  * the epoch order drawn by a numpy ``Generator`` seeded from ``args.seed``
    (``build_epoch_indices``), which gives the JAX trainer's batch order;
  * per-epoch validation, epoch and best checkpoints with rotation, resume,
    and the best model restored at the end on request.

The datasets are staged on the device once when they fit under
``max_device_dataset_bytes``; each epoch then moves only its index and weight
arrays, and micro-batches are gathered on the device. Larger datasets are
gathered on the host, one micro-batch at a time. The trainer runs on CUDA
unless the caller passes ``device="cpu"``.

Not ported yet, and refused when asked for: ``mesh``/``shard_params_fn``
(ROADMAP queue A item 10), the frozen folds ``fold_frozen_seq1`` and
``fold_frozen_affine`` (item 18; both are exact up to fp32 reassociation, so
leaving them off changes no result), ``fused_optimizer`` (item 19),
``fuse_epochs=True`` (item 20), ``frozen_cast_dtype``/``trainable_cast_dtype``
(item 21) and ``ckpt_backend="orbax"`` (item 22).
"""

from __future__ import annotations

import math
import time
from typing import Any

import numpy as np
import torch

from multimodal_timesfm_torch.data.collate import StackedDataset, stack_samples
from multimodal_timesfm_torch.models.bridge import export_jax_params, jax_tree_arrays, load_jax_params
from multimodal_timesfm_torch.models.decoder import MultimodalDecoder
from multimodal_timesfm_torch.training.checkpoint import (
    load_checkpoint,
    rotate_checkpoints,
    save_checkpoint,
)
from multimodal_timesfm_torch.training.optimization import AdamW, make_schedule
from multimodal_timesfm_torch.training_args import TrainingArguments
from multimodal_timesfm_torch.types import TrainingMode
from multimodal_timesfm_torch.utils.logging import get_logger
from multimodal_timesfm_torch.utils.platform import resolve_device

_logger = get_logger()


def quantile_objective(
    full: torch.Tensor,
    horizon: torch.Tensor,
    weights: torch.Tensor,
    denom: torch.Tensor,
    spec: tuple[tuple[float, ...], int | None],
) -> torch.Tensor:
    """Mean pinball loss over the quantile channels, plus MSE on the mean channel if any.

    ``full``: (B, H, C) fp32 forecasts; ``spec``: the adapter's
    ``quantile_loss_spec`` = (levels, mean_channel).
    """
    levels, mean_channel = spec
    loss = 0.0
    if mean_channel is not None:
        err = (full[..., mean_channel] - horizon) ** 2
        loss = torch.sum(err * weights[:, None]) / denom
    q_channels = [c for c in range(full.shape[-1]) if c != mean_channel]
    errs = horizon[..., None] - full[..., q_channels]  # (B, H, Q)
    levels_t = torch.tensor(levels, dtype=torch.float32, device=full.device)
    pinball = torch.maximum((levels_t - 1.0) * errs, levels_t * errs)
    return loss + torch.sum(pinball * weights[:, None, None]) / (denom * len(levels))


def build_epoch_indices(
    n: int, batch: int, shuffle: bool, accum: int, dp: int, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray, int]:
    """Epoch index and weight arrays in the layout (steps, accum, B).

    Rows are padded to static shapes with index 0 and weight 0; a weighted
    loss makes padded rows inert. ``dp`` pads the batch to a multiple of a
    data-parallel axis (1 here). The same numpy draws as the JAX package's,
    so a shared seed gives a shared batch order.
    """
    idx = rng.permutation(n) if shuffle else np.arange(n)
    num_batches = math.ceil(n / batch)
    num_steps = math.ceil(num_batches / accum)
    b_padded = math.ceil(batch / dp) * dp
    total = num_steps * accum * b_padded

    take = np.zeros(total, np.int64)
    weights = np.zeros(total, np.float32)
    for bi in range(num_batches):
        real = min(batch, n - bi * batch)
        take[bi * b_padded : bi * b_padded + real] = idx[bi * batch : bi * batch + real]
        weights[bi * b_padded : bi * b_padded + real] = 1.0

    shape = (num_steps, accum, b_padded)
    return take.reshape(shape).astype(np.int32), weights.reshape(shape), num_batches


def _refuse_unported(**knobs: tuple[Any, bool, str]) -> None:
    for name, (value, asked, item) in knobs.items():
        if asked:
            raise NotImplementedError(
                f"{name}={value!r} is not ported to the PyTorch trainer yet (ROADMAP queue A, item {item})"
            )


class MultimodalTrainer:
    """Trainer for multimodal and baseline time-series forecasting."""

    def __init__(
        self,
        model: MultimodalDecoder,
        args: TrainingArguments,
        train_dataset: Any,
        val_dataset: Any,
        mode: TrainingMode,
        device: str | torch.device | None = None,
        max_device_dataset_bytes: int = 4 << 30,
        mesh: Any = None,
        shard_params_fn: Any = None,
        frozen_cast_dtype: Any = None,
        trainable_cast_dtype: Any = None,
        ckpt_backend: str = "pickle",
        fuse_epochs: bool | None = None,
        fold_frozen_seq1: bool = False,
        fold_frozen_affine: bool = False,
        fused_optimizer: bool = False,
    ) -> None:
        """``model`` is moved to ``device`` (CUDA by default, where its absence
        raises) and trained in place. ``fuse_epochs`` None or False runs the
        per-epoch loop, the only path ported."""
        _refuse_unported(
            mesh=(mesh, mesh is not None, "10"),
            shard_params_fn=(shard_params_fn, shard_params_fn is not None, "10"),
            fold_frozen_seq1=(fold_frozen_seq1, bool(fold_frozen_seq1), "18"),
            fold_frozen_affine=(fold_frozen_affine, bool(fold_frozen_affine), "18"),
            fused_optimizer=(fused_optimizer, bool(fused_optimizer), "19"),
            fuse_epochs=(fuse_epochs, fuse_epochs is True, "20"),
            frozen_cast_dtype=(frozen_cast_dtype, frozen_cast_dtype is not None, "21"),
            trainable_cast_dtype=(trainable_cast_dtype, trainable_cast_dtype is not None, "21"),
            ckpt_backend=(ckpt_backend, ckpt_backend != "pickle", "22"),
        )
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.args = args
        self.mode = mode

        multimodal = mode == "multimodal"
        self.train_data = (
            train_dataset
            if isinstance(train_dataset, StackedDataset)
            else stack_samples(train_dataset, multimodal)
        )
        self.val_data = (
            val_dataset
            if isinstance(val_dataset, StackedDataset)
            else stack_samples(val_dataset, multimodal)
        )
        if len(self.train_data) == 0:
            raise RuntimeError("Training dataset is empty.")
        if len(self.val_data) == 0:
            raise RuntimeError("Validation dataset is empty.")
        self.horizon_len = int(self.train_data.horizon.shape[1])

        # --- params partition: the trained child module vs the frozen rest ---
        self.trainable_key = "fusion" if multimodal else "adapter"
        self.trainable_module = getattr(model, self.trainable_key)
        model.requires_grad_(False)
        self.trainable_module.requires_grad_(True)
        self.trainable = list(self.trainable_module.parameters())

        # --- optimizer + schedule (per optimizer step) ---
        num_batches = math.ceil(len(self.train_data) / args.per_device_train_batch_size)
        self.num_training_steps = args.num_train_epochs * math.ceil(
            num_batches / args.gradient_accumulation_steps
        )
        self.schedule = make_schedule(
            args.lr_scheduler_type,
            args.learning_rate,
            args.get_warmup_steps(self.num_training_steps),
            self.num_training_steps,
        )
        moment_dtype = torch.bfloat16 if args.adam_moment_dtype == "bfloat16" else None
        self.optimizer = AdamW(
            self.trainable, self.schedule, args.weight_decay, args.max_grad_norm, moment_dtype
        )

        self._rng = np.random.default_rng(args.seed if args.seed is not None else 0)

        def nbytes(d: StackedDataset) -> int:
            total = d.context.nbytes + d.horizon.nbytes
            if d.text_embeddings is not None:
                total += d.text_embeddings.nbytes
            return total

        self._device_resident = (
            nbytes(self.train_data) + nbytes(self.val_data) <= max_device_dataset_bytes
        )
        if self._device_resident:
            self._train_device = self._to_device(self.train_data)
            self._val_device = self._to_device(self.val_data)
        else:
            _logger.info("Dataset exceeds device budget; gathering micro-batches on the host")
        self._val_indices: tuple[np.ndarray, np.ndarray, int] | None = None

        self.current_epoch = 0
        self.start_epoch = 0
        self.global_step = 0
        self.best_val_loss = float("inf")
        self.last_throughput: float | None = None

    # ------------------------------------------------------------------
    # data staging and the per-micro-batch computation
    # ------------------------------------------------------------------

    def _to_device(self, data: StackedDataset) -> dict[str, torch.Tensor]:
        tree = {"context": data.context, "horizon": data.horizon}
        if data.text_embeddings is not None:
            tree["text"] = data.text_embeddings
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device) for k, v in tree.items()}

    def _micro_batch(
        self, data: StackedDataset, staged: dict[str, torch.Tensor] | None, idx: np.ndarray,
        weights: np.ndarray,
    ) -> dict[str, torch.Tensor]:
        """Rows ``idx`` of each dataset array, gathered on the device when it holds them."""
        if staged is not None:
            take = torch.from_numpy(idx.astype(np.int64)).to(self.device)
            mb = {k: v[take] for k, v in staged.items()}
        else:
            arrays = {"context": data.context, "horizon": data.horizon}
            if data.text_embeddings is not None:
                arrays["text"] = data.text_embeddings
            mb = {k: torch.from_numpy(np.ascontiguousarray(v[idx])).to(self.device) for k, v in arrays.items()}
        mb["weights"] = torch.from_numpy(weights).to(self.device)
        return mb

    def _loss(self, mb: dict[str, torch.Tensor]) -> torch.Tensor:
        """Weighted training loss; the weights zero out padded rows."""
        context, horizon, weights = mb["context"], mb["horizon"], mb["weights"]
        masks = torch.zeros_like(context, dtype=torch.bool)
        denom = torch.clamp_min(torch.sum(weights) * self.horizon_len, 1.0)
        text = mb.get("text")
        if self.args.loss_type == "mse":
            point = self.model(self.horizon_len, context, masks, text)
            err = (point.float() - horizon) ** 2
            return torch.sum(err * weights[:, None]) / denom
        full = self.model.forward_full(self.horizon_len, context, masks, text)
        return quantile_objective(
            full.float(), horizon, weights, denom, self.model.adapter.quantile_loss_spec
        )

    def _eval_mse(self, mb: dict[str, torch.Tensor]) -> torch.Tensor:
        masks = torch.zeros_like(mb["context"], dtype=torch.bool)
        point = self.model(self.horizon_len, mb["context"], masks, mb.get("text"))
        err = point.float() - mb["horizon"]
        denom = torch.clamp_min(torch.sum(mb["weights"]) * self.horizon_len, 1.0)
        return torch.sum(err * err * mb["weights"][:, None]) / denom

    def _optimizer_step(self, micro_batches: list[dict[str, torch.Tensor] | None]) -> list[torch.Tensor]:
        """One optimizer step over the ``accum`` micro-batches of a step; returns their losses.

        The gradient is the mean over the step's ``accum`` micro-batches; an
        all-padding one (None) has a zero gradient and is not run.
        """
        accum = self.args.gradient_accumulation_steps
        grads: list[torch.Tensor] | None = None
        losses = []
        for mb in micro_batches:
            if mb is None:
                continue
            loss = self._loss(mb)
            g = torch.autograd.grad(loss, self.trainable, allow_unused=True, materialize_grads=True)
            if accum == 1:
                grads = list(g)
            else:
                if grads is None:
                    grads = [torch.zeros_like(p) for p in self.trainable]
                grads = [a + gi / accum for a, gi in zip(grads, g)]
            losses.append(loss.detach())
        self.optimizer.step(grads)
        return losses

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def train_epoch(self) -> float:
        """Train one epoch; returns the average per-micro-batch training loss."""
        perm, weights, _ = build_epoch_indices(
            len(self.train_data),
            self.args.per_device_train_batch_size,
            True,
            self.args.gradient_accumulation_steps,
            1,
            self._rng,
        )
        staged = self._train_device if self._device_resident else None
        t0 = time.perf_counter()
        losses: list[torch.Tensor] = []
        num_steps, accum, _ = perm.shape
        for s in range(num_steps):
            group = [
                self._micro_batch(self.train_data, staged, perm[s, a], weights[s, a])
                if weights[s, a].any() else None
                for a in range(accum)
            ]
            losses += self._optimizer_step(group)
        loss_arr = torch.stack(losses).cpu().numpy()  # waits for the epoch's work
        elapsed = time.perf_counter() - t0
        self.last_throughput = len(self.train_data) / max(elapsed, 1e-9)

        if not np.all(np.isfinite(loss_arr)):
            bad = int(np.flatnonzero(~np.isfinite(loss_arr))[0])
            raise FloatingPointError(
                f"Non-finite training loss at epoch {self.current_epoch}, micro-batch {bad} "
                f"(loss={loss_arr[bad]}). Check learning rate / data scaling."
            )

        self.global_step += num_steps
        return float(np.mean(loss_arr))

    @torch.no_grad()
    def validate_epoch(self) -> float:
        """One validation epoch; the average per-micro-batch MSE."""
        if self._val_indices is None:
            self._val_indices = build_epoch_indices(
                len(self.val_data), self.args.per_device_eval_batch_size, False, 1, 1, self._rng
            )
        perm, weights, num_batches = self._val_indices
        staged = self._val_device if self._device_resident else None
        mse = [
            self._eval_mse(self._micro_batch(self.val_data, staged, perm[s, 0], weights[s, 0]))
            for s in range(num_batches)
        ]
        return float(torch.stack(mse).mean().cpu())

    # --- checkpointing ---

    @property
    def _params_key(self) -> str:
        return "fusion_params" if self.mode == "multimodal" else "adapter_params"

    def _build_checkpoint(self) -> dict:
        opt = self.optimizer
        module = self.trainable_module
        return {
            "epoch": self.current_epoch,
            "global_step": self.global_step,
            "optimizer_state": {
                "count": np.int32(opt.count),
                "mu": export_jax_params(module, dict(zip(self.trainable, opt.mu))),
                "nu": export_jax_params(module, dict(zip(self.trainable, opt.nu))),
            },
            "best_val_loss": self.best_val_loss,
            self._params_key: export_jax_params(module),
        }

    def resume_from_checkpoint(self, path: Any) -> None:
        """Restore the trained parameters, optimizer state and counters; call before ``train()``.

        Training continues at the epoch after the checkpointed one.
        """
        checkpoint = load_checkpoint(path)
        load_jax_params(self.trainable_module, checkpoint[self._params_key])
        state = checkpoint["optimizer_state"]
        with torch.no_grad():
            for slots, tree in ((self.optimizer.mu, state["mu"]), (self.optimizer.nu, state["nu"])):
                arrays = jax_tree_arrays(self.trainable_module, tree)
                for p, slot in zip(self.trainable, slots):
                    slot.copy_(torch.from_numpy(arrays[p]))
        self.optimizer.count = int(state["count"])
        self.start_epoch = checkpoint["epoch"] + 1
        self.current_epoch = self.start_epoch
        self.global_step = checkpoint["global_step"]
        self.best_val_loss = checkpoint["best_val_loss"]
        _logger.info(
            "Resumed from %s at epoch %d (global step %d)", path, self.start_epoch, self.global_step
        )

    def save_ckpt(self, val_loss: float) -> None:
        """Epoch/best checkpoint policy with rotation."""
        is_best = val_loss < self.best_val_loss
        if is_best:
            self.best_val_loss = val_loss
        if self.args.save_strategy == "best" and not is_best:
            return

        checkpoint = self._build_checkpoint()
        if self.args.save_strategy == "epoch":
            path = self.args.checkpoint_dir / f"checkpoint_epoch_{self.current_epoch}.ckpt"
            save_checkpoint(path, checkpoint)
            _logger.info("Saved checkpoint at epoch %d", self.current_epoch)
            if self.args.save_total_limit is not None:
                rotate_checkpoints(self.args.checkpoint_dir, self.args.save_total_limit)
        if is_best:
            save_checkpoint(self.args.checkpoint_dir / "best_model.ckpt", checkpoint)
            _logger.info("Saved best model checkpoint at epoch %d", self.current_epoch)

    def train(self) -> None:
        """Main training loop: per epoch, train, validate, log and checkpoint."""
        if self.args.eval_strategy != "epoch":
            raise NotImplementedError(
                f"eval_strategy={self.args.eval_strategy!r} is not supported; only 'epoch' is implemented."
            )
        if self.args.save_strategy == "steps":
            _logger.warning(
                "save_strategy='steps' is accepted for config parity but not implemented: NO "
                "checkpoints will be written. Use 'epoch' or 'best'."
            )
        _logger.info("Starting %s training for %d epochs", self.mode, self.args.num_train_epochs)
        _logger.info("Train dataset size: %d", len(self.train_data))
        _logger.info("Validation dataset size: %d", len(self.val_data))

        for epoch in range(self.start_epoch, self.args.num_train_epochs):
            self.current_epoch = epoch
            train_loss = self.train_epoch()
            val_loss = self.validate_epoch()
            _logger.info(
                "Epoch %d: Train Loss = %.6f, Val Loss = %.6f (%.1f series/s)",
                epoch, train_loss, val_loss, self.last_throughput or 0.0,
            )
            if self.args.save_strategy in ("epoch", "best"):
                self.save_ckpt(val_loss)

        if self.args.load_best_model_at_end:
            best_path = self.args.checkpoint_dir / "best_model.ckpt"
            if best_path.exists():
                load_jax_params(self.trainable_module, load_checkpoint(best_path)[self._params_key])
                _logger.info("Loaded best model at end of training")
        _logger.info("Training completed")
