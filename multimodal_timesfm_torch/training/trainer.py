"""Trainer: per-epoch or fused multi-epoch training with mode-based parameter partitioning.

Counterpart of ``multimodal_timesfm_tpu/training/trainer.py``, with the same
semantics:

  * multimodal mode trains the ``fusion`` child of the decoder with the
    adapter frozen; baseline mode trains the ``adapter``. The trained
    parameters get ``requires_grad``, the rest lose it;
  * all-False input masks at train time; batches padded to a static size
    with zero-weight rows, the loss divided by ``max(sum(weights) * H, 1)``;
  * point-channel MSE, or the quantile objective (``loss_type="quantile"``);
  * gradient accumulation as the mean of the micro-batch gradients (an
    all-padding micro-batch runs with zero weight, as JAX's scan runs it),
    fp32 global-norm clipping, AdamW (the optax chain, or the fused stepper
    with ``fused_optimizer=True``), and the schedule advanced per optimizer
    step on the device (``training/optimization.py``);
  * the epoch order drawn by a numpy ``Generator`` seeded from ``args.seed``
    (``build_epoch_indices``), which gives the JAX trainer's batch order;
  * per-epoch validation, epoch and best checkpoints with rotation, resume,
    and the best model restored at the end on request;
  * the frozen child is a trainer-owned copy, folded (multimodal TimesFM:
    ``fold_frozen_seq1`` at one patch token, ``fold_frozen_affine``; both on
    by default, as in JAX) and then cast to ``frozen_cast_dtype``; the
    caller's frozen child is left as it was. The trained child is the
    caller's, trained in place; with ``trainable_cast_dtype`` each optimizer
    step differentiates a cast working copy of it, made once per step, and
    the optimizer updates the fp32 masters, which validation and
    checkpoints read;
  * ``train()`` takes the fused multi-epoch path (``train_epochs_fused``)
    when ``fused_epochs_supported()``: the epoch orders drawn up front in
    the loop's RNG order, no host synchronisation until the run ends, the
    best trained tensors tracked on the device. On CUDA, without gradient
    accumulation, one optimizer step (gather, forward, backward, clip,
    update) is captured in a CUDA graph after one eager step and replayed;
    a capture that fails raises.

The datasets are staged on the device once when they fit under
``max_device_dataset_bytes``; each epoch then moves only its index and weight
arrays, and micro-batches are gathered on the device. Larger datasets are
gathered on the host, one micro-batch at a time, and train per epoch. The
trainer runs on CUDA unless the caller passes ``device="cpu"``.

Checkpoints take the JAX package's two backends (``training/checkpoint.py``:
a pickle file, or with ``ckpt_backend="orbax"`` a directory of safetensors
and JSON), and resuming reads the port's payloads and those the JAX trainer
wrote (an optax chain or fused state, bf16 moments included).

Over a (data, model) mesh (``parallel/``; one process per device, every
rank running the same calls): each rank takes its contiguous rows of every
micro-batch (the batch padded to the data axis, as JAX pads it), its loss is
its weighted sum over the global ``max(sum(weights) * H, 1)``, and the
gradients are summed over the data axis (a mean would be wrong wherever the
padding rows fall unevenly); losses and validation sums are summed the same
way. ``shard_params_fn`` (``parallel.shard_params``) shards the decoder over
the model axis in place and turns the folds off, as in JAX; the clip's norm is
that of the whole tensors. Checkpoints hold whole arrays (rank 0 writes what
the ranks gather); a restore reloads them whole and shards them again. On
CUDA the fused path captures its step with the collectives when they ride
NCCL; under gloo (two ranks on one card) the step runs eagerly.
"""

from __future__ import annotations

import copy
import functools
import math
import time
import warnings
from typing import Any, Callable

import numpy as np
import torch

from multimodal_timesfm_torch.data.collate import StackedDataset, stack_samples
from multimodal_timesfm_torch.models.bridge import export_jax_params, jax_tree_arrays, load_jax_params
from multimodal_timesfm_torch.models.decoder import MultimodalDecoder
from multimodal_timesfm_torch.models.layers import (
    StackedTransformer,
    fold_frozen_tree_affines,
    fold_frozen_tree_seq1,
)
from multimodal_timesfm_torch.parallel.mesh import (
    DATA_AXIS,
    all_reduce_sum,
    axis_group,
    axis_size,
    barrier,
    check_mesh,
    graphs_capture_collectives,
    is_main_rank,
    local_rows,
)
from multimodal_timesfm_torch.parallel.sharding import (
    gather_params,
    local_blocks,
    sharded_params,
    unshard_params,
)
from multimodal_timesfm_torch.training.checkpoint import (
    BACKENDS,
    adam_state,
    load_checkpoint,
    rotate_checkpoints,
    save_checkpoint,
)
from multimodal_timesfm_torch.training.optimization import AdamW, FusedOptimizer, make_schedule
from multimodal_timesfm_torch.training_args import TrainingArguments
from multimodal_timesfm_torch.types import TrainingMode
from multimodal_timesfm_torch.utils.logging import get_logger
from multimodal_timesfm_torch.utils.platform import resolve_device

_logger = get_logger()


@functools.lru_cache(maxsize=8)
def _levels_tensor(levels: tuple[float, ...], device: torch.device) -> torch.Tensor:
    """The quantile levels as an fp32 tensor on ``device``, made once: a host-to-device
    copy cannot be captured in a CUDA graph."""
    with torch.inference_mode(False):
        return torch.tensor(levels, dtype=torch.float32).to(device)


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
    levels_t = _levels_tensor(tuple(levels), full.device)
    pinball = torch.maximum((levels_t - 1.0) * errs, levels_t * errs)
    return loss + torch.sum(pinball * weights[:, None, None]) / (denom * len(levels))


def build_epoch_indices(
    n: int, batch: int, shuffle: bool, accum: int, dp: int, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray, int]:
    """Epoch index and weight arrays in the layout (steps, accum, B).

    Rows are padded to static shapes with index 0 and weight 0; a weighted
    loss makes padded rows inert. ``dp`` pads the batch to a multiple of the
    mesh's data axis (1 without one). The same numpy draws as the JAX
    package's, so a shared seed gives a shared batch order.
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


def _cast_floats(module: torch.nn.Module, dtype: torch.dtype) -> None:
    """Store every fp32 parameter of ``module`` in ``dtype`` (others stay as they are)."""
    for param in module.parameters():
        if param.dtype == torch.float32:
            param.data = param.data.to(dtype)


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
        frozen_cast_dtype: torch.dtype | None = None,
        trainable_cast_dtype: torch.dtype | None = None,
        ckpt_backend: str = "pickle",
        fuse_epochs: bool | None = None,
        fold_frozen_seq1: bool = True,
        fold_frozen_affine: bool = True,
        fused_optimizer: bool = False,
        wandb_run: Any = None,
    ) -> None:
        """``model`` is moved to ``device`` (CUDA by default, where its absence
        raises); its trained child is trained in place, its frozen child is
        copied when folded or cast.

        ``frozen_cast_dtype`` (e.g. ``torch.bfloat16``) stores the frozen
        child's fp32 parameters in that dtype, after the folds.
        ``trainable_cast_dtype`` differentiates a copy of the trained child
        cast to that dtype, keeping fp32 masters in the optimizer.
        ``fuse_epochs``: None lets ``train()`` take the fused multi-epoch path
        when it is supported; False forces the per-epoch loop.
        ``fold_frozen_seq1``: in multimodal mode with one patch token on both
        splits, fold each frozen layer's attention into one (D, D) matrix
        (``models/layers.fold_seq1_attention``). ``fold_frozen_affine``: in
        multimodal mode, fold the frozen norms' gains and the per-dim query
        scale into the adjacent GEMM weights. Both are exact up to fp32
        reassociation and apply to TimesFM only. ``fused_optimizer`` selects
        the fused AdamW stepper; a checkpoint resumes only under the setting
        it was written with. ``wandb_run`` (a W&B run, or any object with
        ``log(metrics, step=...)``) receives the JAX trainer's keys at its
        steps: ``train/loss`` and ``train/lr`` per step or per epoch as
        ``args.logging_strategy`` says, and ``val/loss`` every epoch.
        ``mesh`` (``parallel.make_mesh``) splits every batch over its data
        axis; ``shard_params_fn(module, mesh)`` (``parallel.shard_params``)
        shards the decoder, in place, over its model axis.
        """
        check_mesh(mesh, "MultimodalTrainer")
        if shard_params_fn is not None and mesh is None:
            raise ValueError("shard_params_fn needs a mesh to shard over")
        self.mesh = mesh
        self._dp = axis_size(mesh, DATA_AXIS)
        self._data_group = axis_group(mesh, DATA_AXIS)
        self._shard_params_fn = shard_params_fn
        if ckpt_backend not in BACKENDS:
            raise ValueError(f"ckpt_backend must be one of {BACKENDS}, got {ckpt_backend!r}")
        self.ckpt_backend = ckpt_backend
        self.device = resolve_device(device)
        model = model.to(self.device)
        self.args = args
        self.mode = mode
        self.fuse_epochs = fuse_epochs
        self._wandb_run = wandb_run

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
        frozen_key = "adapter" if multimodal else "fusion"
        self.trainable_module = getattr(model, self.trainable_key)
        model.requires_grad_(False)
        self.trainable_module.requires_grad_(True)
        self.trainable = list(self.trainable_module.parameters())

        # --- the frozen child: folded in fp32 first, then cast (JAX's order) ---
        # The folds apply to a frozen TimesFM stack only (not to Chronos-2), and not under
        # tensor parallelism: the sharding rules key on the qkv/out names they replace.
        foldable = (
            multimodal
            and shard_params_fn is None
            and isinstance(getattr(model.adapter, "stacked_xf", None), StackedTransformer)
        )
        patch = model.adapter.patch_len
        self._folded_seq1 = bool(
            fold_frozen_seq1
            and foldable
            and self.train_data.context.shape[1] == patch
            and self.val_data.context.shape[1] == patch
        )
        self._folded_affine = bool(fold_frozen_affine and foldable)
        self.eval_model = model
        if self._folded_seq1 or self._folded_affine or frozen_cast_dtype is not None:
            frozen = copy.deepcopy(getattr(model, frozen_key))
            if self._folded_seq1:
                fold_frozen_tree_seq1(frozen)
            if self._folded_affine:
                fold_frozen_tree_affines(frozen)
            if frozen_cast_dtype is not None:
                _cast_floats(frozen, frozen_cast_dtype)
            self.eval_model = model.with_children(**{frozen_key: frozen})
        if shard_params_fn is not None:
            shard_params_fn(self.eval_model, mesh)

        # --- the module the training step differentiates ---
        self._trainable_cast_dtype = trainable_cast_dtype
        self.model = self.eval_model
        self._work = self.trainable
        if trainable_cast_dtype is not None:
            work = copy.deepcopy(self.trainable_module)
            _cast_floats(work, trainable_cast_dtype)
            self.model = self.eval_model.with_children(**{self.trainable_key: work})
            self._work = list(work.parameters())

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
        optimizer_cls = FusedOptimizer if fused_optimizer else AdamW
        shards = sharded_params(self.trainable_module)
        self.optimizer = optimizer_cls(
            self.trainable, self.schedule, args.weight_decay, args.max_grad_norm, moment_dtype,
            model_axis=next((axis for _, axis in shards.values()), None),
            sharded=[p in shards for p in self.trainable],
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
        self._val_indices: tuple[np.ndarray, np.ndarray, int, np.ndarray | None] | None = None

        # The captured optimizer step of the fused path (CUDA, no accumulation):
        # (graph, index buffer, weight buffer, weight-sum buffer, loss output),
        # kept across runs.
        self._step_graph: tuple | None = None
        self.graph_captures = 0
        self.graph_replays = 0
        self._warned_eager_step = False

        self.current_epoch = 0
        self.start_epoch = 0
        self.global_step = 0
        self.best_val_loss = float("inf")
        self.last_throughput: float | None = None
        self._fused_best: dict[str, Any] | None = None

    # ------------------------------------------------------------------
    # data staging and the per-micro-batch computation
    # ------------------------------------------------------------------

    def _to_device(self, data: StackedDataset) -> dict[str, torch.Tensor]:
        tree = {"context": data.context, "horizon": data.horizon}
        if data.text_embeddings is not None:
            tree["text"] = data.text_embeddings
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device) for k, v in tree.items()}

    @staticmethod
    def _gather(
        staged: dict[str, torch.Tensor], idx: torch.Tensor, weights: torch.Tensor, wsum: torch.Tensor
    ) -> dict[str, torch.Tensor]:
        """Rows ``idx`` of each staged array, gathered on the device, with their weights
        and the weight sum of the whole micro-batch (over every rank of a mesh)."""
        mb = {k: torch.index_select(v, 0, idx) for k, v in staged.items()}
        mb["weights"] = weights
        mb["wsum"] = wsum
        return mb

    def _micro_batch(
        self, data: StackedDataset, staged: dict[str, torch.Tensor] | None, idx: np.ndarray,
        weights: np.ndarray, wsum: np.ndarray,
    ) -> dict[str, torch.Tensor]:
        """Rows ``idx`` of each dataset array, gathered on the device when it holds them."""
        w = torch.from_numpy(np.ascontiguousarray(weights)).to(self.device)
        ws = torch.tensor(float(wsum), device=self.device)
        if staged is not None:
            return self._gather(staged, torch.from_numpy(idx.astype(np.int64)).to(self.device), w, ws)
        arrays = {"context": data.context, "horizon": data.horizon}
        if data.text_embeddings is not None:
            arrays["text"] = data.text_embeddings
        mb = {k: torch.from_numpy(np.ascontiguousarray(v[idx])).to(self.device) for k, v in arrays.items()}
        mb["weights"] = w
        mb["wsum"] = ws
        return mb

    def _rank_rows(
        self, perm: np.ndarray, weights: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(this rank's rows of the (..., B) index and weight arrays, the weight sum of each
        whole micro-batch); without a mesh the arrays are kept whole. The weights are 0/1,
        so the sums are exact in fp32."""
        wsum = weights.sum(axis=-1)
        return local_rows(perm, self.mesh, dim=-1), local_rows(weights, self.mesh, dim=-1), wsum

    def _sum_over_data(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the mesh's data axis (``t`` itself without a mesh)."""
        return t if self.mesh is None else all_reduce_sum([t], self._data_group)[0]

    def _loss(self, mb: dict[str, torch.Tensor]) -> torch.Tensor:
        """Weighted training loss; the weights zero out padded rows. On a mesh, this rank's
        share: its rows' weighted sum over the whole micro-batch's denominator."""
        context, horizon, weights = mb["context"], mb["horizon"], mb["weights"]
        masks = torch.zeros_like(context, dtype=torch.bool)
        denom = torch.clamp_min(mb["wsum"] * self.horizon_len, 1.0)
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
        point = self.eval_model(self.horizon_len, mb["context"], masks, mb.get("text"))
        err = point.float() - mb["horizon"]
        denom = torch.clamp_min(mb["wsum"] * self.horizon_len, 1.0)
        return torch.sum(err * err * mb["weights"][:, None]) / denom

    def _optimizer_step(self, micro_batches: list[dict[str, torch.Tensor]]) -> torch.Tensor:
        """One optimizer step over the ``accum`` micro-batches of a step; returns their
        (accum,) losses.

        The gradient is the mean over the step's micro-batches, accumulated in
        the masters' dtype; without accumulation the gradients go to the
        optimizer as the backward gives them. On a mesh the gradients are summed
        over the data axis (one fp32 all-reduce) and the losses are this rank's
        shares. Nothing here reads a value back to the host.
        """
        accum = len(micro_batches)
        if self._trainable_cast_dtype is not None:
            with torch.no_grad():
                torch._foreach_copy_(self._work, self.trainable)
        grads: list[torch.Tensor] | None = None
        losses = []
        for mb in micro_batches:
            loss = self._loss(mb)
            g = torch.autograd.grad(loss, self._work, allow_unused=True, materialize_grads=True)
            if accum == 1:
                grads = list(g)
            else:
                if grads is None:
                    grads = [torch.zeros_like(p) for p in self.trainable]
                grads = [a + gi / accum for a, gi in zip(grads, g)]
            losses.append(loss.detach())
        if self.mesh is not None:
            grads = all_reduce_sum(grads, self._data_group)
        self.optimizer.step(grads)
        return torch.stack(losses)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @staticmethod
    def _check_finite(flat: np.ndarray, first_epoch: int) -> None:
        """Raise on the first non-finite loss of an (epochs, micro-batches) array."""
        if not np.all(np.isfinite(flat)):
            e, b = map(int, np.argwhere(~np.isfinite(flat))[0])
            raise FloatingPointError(
                f"Non-finite training loss at epoch {first_epoch + e}, micro-batch {b} "
                f"(loss={flat[e, b]}). Check learning rate / data scaling."
            )

    def train_epoch(self) -> float:
        """Train one epoch; returns the average per-micro-batch training loss."""
        perm, weights, num_batches = build_epoch_indices(
            len(self.train_data),
            self.args.per_device_train_batch_size,
            True,
            self.args.gradient_accumulation_steps,
            self._dp,
            self._rng,
        )
        perm, weights, wsum = self._rank_rows(perm, weights)
        staged = self._train_device if self._device_resident else None
        t0 = time.perf_counter()
        num_steps, accum, _ = perm.shape
        losses = [
            self._optimizer_step([
                self._micro_batch(self.train_data, staged, perm[s, a], weights[s, a], wsum[s, a])
                for a in range(accum)
            ])
            for s in range(num_steps)
        ]
        # (num_steps, accum); waits for the epoch
        loss_matrix = self._sum_over_data(torch.stack(losses)).cpu().numpy()
        loss_arr = loss_matrix.reshape(-1)[:num_batches]
        elapsed = time.perf_counter() - t0
        self.last_throughput = len(self.train_data) / max(elapsed, 1e-9)
        self._check_finite(loss_arr[None], self.current_epoch)
        step_start = self.global_step
        self.global_step += num_steps
        if self.args.logging_strategy == "steps":
            self._log_steps(loss_matrix.reshape(-1), num_batches, step_start, num_steps)
        return float(np.mean(loss_arr))

    def _lr_at(self, step: int) -> float:
        return float(self.schedule(torch.tensor(step)))

    def _log_steps(self, losses: np.ndarray, num_batches: int, step_start: int, num_steps: int) -> None:
        """Per-step W&B logs from an epoch's flat micro-batch losses (JAX ``train_epoch``):
        every ``logging_steps``-th step logs the loss of its last real micro-batch and the
        rate that step used."""
        if self._wandb_run is None:
            return
        accum = self.args.gradient_accumulation_steps
        every = max(self.args.logging_steps, 1)
        for s in range(num_steps):
            gs = step_start + s + 1
            if gs % every == 0:
                last_real = min(accum, num_batches - s * accum) - 1
                self._wandb_run.log(
                    {"train/loss": float(losses[s * accum + max(last_real, 0)]), "train/lr": self._lr_at(gs - 1)},
                    step=gs,
                )

    @torch.no_grad()
    def _val_loss(
        self, idx: torch.Tensor, weights: torch.Tensor, num_batches: int, wsum: torch.Tensor
    ) -> torch.Tensor:
        """Mean validation MSE over the first ``num_batches`` rows of (steps, B) device
        indices and weights (on a mesh this rank's rows, with each step's whole weight
        sum), as a device scalar summed over the data axis."""
        mse = [
            self._eval_mse(self._gather(self._val_device, idx[s], weights[s], wsum[s]))
            for s in range(num_batches)
        ]
        return self._sum_over_data(torch.stack(mse).mean())

    def _val_arrays(self) -> tuple[np.ndarray, np.ndarray, int, np.ndarray]:
        """The validation order: (steps, B) indices and weights of this rank's rows, the
        step count, and each step's whole weight sum."""
        perm, weights, num_batches = build_epoch_indices(
            len(self.val_data), self.args.per_device_eval_batch_size, False, 1, self._dp, self._rng
        )
        perm, weights, wsum = self._rank_rows(perm[:, 0], weights[:, 0])
        return perm, weights, num_batches, wsum

    @torch.no_grad()
    def validate_epoch(self) -> float:
        """One validation epoch; the average per-micro-batch MSE."""
        if self._val_indices is None:
            self._val_indices = self._val_arrays()
        perm, weights, num_batches, wsum = self._val_indices
        if self._device_resident:
            idx = torch.from_numpy(perm.astype(np.int64)).to(self.device)
            ws = torch.from_numpy(wsum).to(self.device)
            return float(self._val_loss(idx, torch.from_numpy(weights).to(self.device), num_batches, ws))
        mse = [
            self._eval_mse(self._micro_batch(self.val_data, None, perm[s], weights[s], wsum[s]))
            for s in range(num_batches)
        ]
        return float(self._sum_over_data(torch.stack(mse).mean()).cpu())

    @property
    def folded_seq1(self) -> bool:
        """Whether the frozen stack's attention was folded for one token (``fold_seq1_attention``).

        True only when every gate held: multimodal mode, one patch token on
        both splits, the ``fold_frozen_seq1`` knob, and a TimesFM adapter.
        FLOPs accounting keys on this instead of re-deriving the gates.
        """
        return self._folded_seq1

    def fused_epochs_supported(self) -> bool:
        """Whether ``train()`` can run the fused multi-epoch path: the device-resident
        data path, per-epoch eval, and no per-epoch host work (epoch checkpoints
        need the host between epochs; ``no``/``best`` do not)."""
        return (
            self.fuse_epochs is not False
            and self._device_resident
            and self.args.eval_strategy == "epoch"
            and self.args.save_strategy in ("no", "best")
        )

    def _step_runner(
        self, perm: torch.Tensor, weights: torch.Tensor, wsum: torch.Tensor
    ) -> Callable[[int, int], torch.Tensor]:
        """``run(e, s)``: optimizer step ``s`` of epoch ``e`` of (E, steps, accum, B) device
        indices and weights and (E, steps, accum) whole-batch weight sums; returns its
        (accum,) losses.

        On CUDA without accumulation the step is a CUDA graph: captured once per
        trainer, after one eager step on a side stream (which is the step it
        stands for), then replayed with the step's rows copied into its static
        index and weight buffers. A mesh's collectives are captured with it when
        they ride NCCL; gloo's cannot be, and the step then runs eagerly, as it
        does elsewhere.
        """
        staged = self._train_device
        accum = perm.shape[2]

        capturable = graphs_capture_collectives(self.mesh)
        if self.device.type != "cuda" or accum != 1 or not capturable:
            if self.device.type == "cuda" and accum == 1 and not self._warned_eager_step:
                self._warned_eager_step = True
                _logger.warning(
                    "The fused step runs eagerly: the mesh's collectives ride gloo, which a "
                    "CUDA graph cannot capture"
                )

            def eager(e: int, s: int) -> torch.Tensor:
                return self._optimizer_step(
                    [self._gather(staged, perm[e, s, a], weights[e, s, a], wsum[e, s, a]) for a in range(accum)]
                )
            return eager

        def run(e: int, s: int) -> torch.Tensor:
            if self._step_graph is None:
                idx, w = perm[e, s, 0].clone(), weights[e, s, 0].clone()
                ws = wsum[e, s, 0].clone()
                side = torch.cuda.Stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side):
                    loss = self._optimizer_step([self._gather(staged, idx, w, ws)])
                torch.cuda.current_stream(self.device).wait_stream(side)
                loss.record_stream(torch.cuda.current_stream(self.device))
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    out = self._optimizer_step([self._gather(staged, idx, w, ws)])
                self._step_graph = (graph, idx, w, ws, out)
                self.graph_captures += 1
                return loss
            graph, idx, w, ws, out = self._step_graph
            idx.copy_(perm[e, s, 0])
            w.copy_(weights[e, s, 0])
            ws.copy_(wsum[e, s, 0])
            graph.replay()
            self.graph_replays += 1
            return out

        return run

    def train_epochs_fused(self, num_epochs: int) -> tuple[np.ndarray, np.ndarray]:
        """Run ``num_epochs`` x (train epoch + validation) with no host synchronisation
        until the end (JAX ``train_epochs_fused``).

        The epoch orders are drawn on the host up front in the loop's RNG order
        and staged once; the validation loss is the same per-batch mean; under
        ``save_strategy="best"`` the best trained tensors are tracked on the
        device (``torch.where``), with the loop's best-epoch selection. A
        ``best`` checkpoint written after a fused run carries the end-of-run
        optimizer state (stamped ``optimizer_state_is_final``).

        Returns:
            (train_losses, val_losses): (E, num_micro_batches) and (E,).
        """
        if not self._device_resident:
            raise RuntimeError("train_epochs_fused requires the device-resident data path")
        accum = self.args.gradient_accumulation_steps
        draws = [
            build_epoch_indices(
                len(self.train_data), self.args.per_device_train_batch_size, True, accum, self._dp, self._rng
            )
            for _ in range(num_epochs)
        ]
        num_batches = draws[0][2]
        perm, weights, wsum = self._rank_rows(np.stack([d[0] for d in draws]), np.stack([d[1] for d in draws]))
        perm = torch.from_numpy(perm.astype(np.int64)).to(self.device)
        weights = torch.from_numpy(np.ascontiguousarray(weights)).to(self.device)
        wsum = torch.from_numpy(wsum).to(self.device)
        val_perm, val_weights, val_nb, val_wsum = self._val_arrays()
        val_idx = torch.from_numpy(val_perm.astype(np.int64)).to(self.device)
        val_w = torch.from_numpy(np.ascontiguousarray(val_weights)).to(self.device)
        val_wsum = torch.from_numpy(val_wsum).to(self.device)

        start = self.best_val_loss if np.isfinite(self.best_val_loss) else np.finfo(np.float32).max
        best_val = torch.tensor(start, dtype=torch.float32, device=self.device)
        best = [p.detach().clone() for p in self.trainable] if self.args.save_strategy == "best" else None
        num_steps = perm.shape[1]
        train_losses = torch.empty((num_epochs, num_steps, accum), device=self.device)
        val_losses = torch.empty(num_epochs, device=self.device)

        t0 = time.perf_counter()
        run = self._step_runner(perm, weights, wsum)
        for e in range(num_epochs):
            for s in range(num_steps):
                train_losses[e, s] = run(e, s)
            val_loss = self._val_loss(val_idx, val_w, val_nb, val_wsum)
            val_losses[e] = val_loss
            is_best = val_loss < best_val
            best_val = torch.where(is_best, val_loss, best_val)
            if best is not None:
                with torch.no_grad():
                    for b, p in zip(best, self.trainable):
                        b.copy_(torch.where(is_best, p, b))
        loss_cube = self._sum_over_data(train_losses).cpu().numpy()  # the run's one wait
        val_arr = val_losses.cpu().numpy()
        elapsed = time.perf_counter() - t0
        self.last_throughput = num_epochs * len(self.train_data) / max(elapsed, 1e-9)

        flat = loss_cube.reshape(num_epochs, -1)[:, :num_batches]
        self._check_finite(flat, self.start_epoch)
        self.global_step += num_epochs * num_steps
        self._fused_best = {
            "val": float(best_val),
            "trainable": best,  # None unless save_strategy="best"
            "epoch": self.start_epoch + int(np.argmin(val_arr)),
        }
        return flat, val_arr

    # --- checkpointing ---

    @property
    def _params_key(self) -> str:
        return "fusion_params" if self.mode == "multimodal" else "adapter_params"

    def _build_checkpoint(self, params: list[torch.Tensor] | None = None) -> dict:
        """The checkpoint payload; ``params`` (one per trained tensor) in place of the
        live trained parameters when given. Whole arrays: the blocks of sharded tensors
        are gathered (every rank must call this)."""
        opt = self.optimizer
        module = self.trainable_module

        def whole(values: list[torch.Tensor] | None) -> dict:
            return export_jax_params(
                module, gather_params(module, None if values is None else dict(zip(self.trainable, values)))
            )

        return {
            "epoch": self.current_epoch,
            "global_step": self.global_step,
            "optimizer_state": {"count": np.int32(opt.count), "mu": whole(opt.mu), "nu": whole(opt.nu)},
            # Resuming under the other optimizer is refused by name.
            "optimizer_is_fused": isinstance(opt, FusedOptimizer),
            "best_val_loss": self.best_val_loss,
            self._params_key: whole(params),
        }

    def _save(self, path: Any, checkpoint: dict) -> None:
        """Rank 0 writes; every rank waits until the file is there."""
        if is_main_rank():
            save_checkpoint(path, checkpoint, backend=self.ckpt_backend)
        barrier()

    def load_trained_params(self, tree: Any, moments: tuple[Any, Any] | None = None) -> None:
        """Load a JAX-layout tree of whole arrays into the trained parameters (and, with
        ``moments``, the (mu, nu) trees into the optimizer's slots). Under tensor
        parallelism the trained child is gathered whole, loaded, and sharded again by
        ``shard_params_fn``, as JAX re-applies it on restore (every rank must call this)."""
        module = self.trainable_module
        sharded = bool(sharded_params(module))
        if sharded:
            unshard_params(module)
        load_jax_params(module, tree)
        slots = []
        if moments is not None:
            slots = [(opt_slots, jax_tree_arrays(module, t))
                     for opt_slots, t in zip((self.optimizer.mu, self.optimizer.nu), moments)]
        if sharded:
            self._shard_params_fn(module, self.mesh)
        with torch.no_grad():
            for opt_slots, arrays in slots:
                blocks = local_blocks(module, {p: torch.from_numpy(arrays[p]) for p in self.trainable})
                for p, slot in zip(self.trainable, opt_slots):
                    slot.copy_(blocks[p])

    def resume_from_checkpoint(self, path: Any) -> None:
        """Restore the trained parameters, optimizer state and counters; call before ``train()``.

        Reads either backend, and checkpoints the JAX trainer wrote (its optax
        chain or fused state, fp32 or bf16 moments). Training continues at the
        epoch after the checkpointed one. A checkpoint
        written under the other ``fused_optimizer`` setting raises; a ``best``
        checkpoint of the fused path (best weights, end-of-run optimizer state)
        warns.
        """
        checkpoint = load_checkpoint(path)
        saved_fused = checkpoint.get("optimizer_is_fused")
        live_fused = isinstance(self.optimizer, FusedOptimizer)
        if saved_fused is not None and bool(saved_fused) != live_fused:
            saved_kind = "fused" if saved_fused else "chain"
            live_kind = "chain" if saved_fused else "fused"
            raise ValueError(
                f"Checkpoint {path} was written with the {saved_kind} optimizer "
                f"but this trainer was built with the {live_kind} one — their "
                "opt_state structures are incompatible. Rebuild the trainer with "
                f"fused_optimizer={bool(saved_fused)} to resume it."
            )
        if checkpoint.get("optimizer_state_is_final"):
            warnings.warn(
                f"Resuming from {path}: this checkpoint was written by the fused "
                "training path — its weights are the best epoch's, but the optimizer "
                "state is end-of-run. Moments/schedule position will not match the "
                "recorded epoch/global_step.",
                UserWarning,
                stacklevel=2,
            )
        # The port's {"count", "mu", "nu"}, or the ScaleByAdamState of a JAX chain
        # or fused state; moments of either dtype are cast to the live slots'.
        count, mu, nu = adam_state(checkpoint["optimizer_state"])
        self.load_trained_params(checkpoint[self._params_key], (mu, nu))
        self.optimizer.count = count
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
            self._save(path, checkpoint)
            _logger.info("Saved checkpoint at epoch %d", self.current_epoch)
            if self.args.save_total_limit is not None and is_main_rank():
                rotate_checkpoints(self.args.checkpoint_dir, self.args.save_total_limit)
        if is_best:
            self._save(self.args.checkpoint_dir / "best_model.ckpt", checkpoint)
            _logger.info("Saved best model checkpoint at epoch %d", self.current_epoch)

    def train(self) -> None:
        """Main training loop: the fused path when supported, else per epoch train,
        validate, log and checkpoint."""
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

        if self.fused_epochs_supported():
            self._train_fused()
        else:
            self._train_loop()

        if self.args.load_best_model_at_end:
            best_path = self.args.checkpoint_dir / "best_model.ckpt"
            if best_path.exists():
                self.load_trained_params(load_checkpoint(best_path)[self._params_key])
                _logger.info("Loaded best model at end of training")
        _logger.info("Training completed")

    def _train_fused(self) -> None:
        """The fused run (``train_epochs_fused``); logging and the best checkpoint follow
        from the returned losses."""
        num_epochs = self.args.num_train_epochs - self.start_epoch
        if num_epochs <= 0:
            return
        step0 = self.global_step
        train_losses, val_losses = self.train_epochs_fused(num_epochs)
        steps_per_epoch = (self.global_step - step0) // num_epochs
        for e in range(num_epochs):
            train_loss, val_loss = float(np.mean(train_losses[e])), float(val_losses[e])
            _logger.info(
                "Epoch %d: Train Loss = %.6f, Val Loss = %.6f (%.1f series/s)",
                self.start_epoch + e, train_loss, val_loss, self.last_throughput or 0.0,
            )
            if self._wandb_run is None:
                continue
            gs = step0 + (e + 1) * steps_per_epoch
            if self.args.logging_strategy == "steps":
                self._log_steps(train_losses[e], train_losses.shape[1], step0 + e * steps_per_epoch,
                                steps_per_epoch)
                self._wandb_run.log({"val/loss": val_loss}, step=gs)
            elif self.args.logging_strategy == "epoch":
                self._wandb_run.log(
                    {"train/loss": train_loss, "train/lr": self._lr_at(gs - steps_per_epoch), "val/loss": val_loss},
                    step=gs,
                )
            else:  # val/loss is logged under logging_strategy="no" too, as in JAX
                self._wandb_run.log({"val/loss": val_loss}, step=gs)
        # As in the loop, the best is tracked only where save_ckpt would run.
        improved = (
            self.args.save_strategy == "best" and float(np.min(val_losses)) < self.best_val_loss
        )
        if improved:
            self.best_val_loss = self._fused_best["val"]
            # epoch and global_step record the best epoch's position; the
            # optimizer state is end-of-run, and the stamp says so.
            live_step = self.global_step
            best_epoch = self._fused_best["epoch"]
            self.current_epoch = best_epoch
            self.global_step = step0 + (best_epoch - self.start_epoch + 1) * steps_per_epoch
            checkpoint = self._build_checkpoint(self._fused_best["trainable"])
            checkpoint["optimizer_state_is_final"] = True
            self.global_step = live_step
            self._save(self.args.checkpoint_dir / "best_model.ckpt", checkpoint)
            _logger.info("Saved best model checkpoint at epoch %d", best_epoch)
        self.current_epoch = self.args.num_train_epochs - 1

    def _train_loop(self) -> None:
        """Per-epoch host loop (exact checkpoint semantics)."""
        for epoch in range(self.start_epoch, self.args.num_train_epochs):
            self.current_epoch = epoch
            epoch_lr = self._lr_at(self.global_step)
            train_loss = self.train_epoch()
            val_loss = self.validate_epoch()
            _logger.info(
                "Epoch %d: Train Loss = %.6f, Val Loss = %.6f (%.1f series/s)",
                epoch, train_loss, val_loss, self.last_throughput or 0.0,
            )
            if self._wandb_run is not None:
                if self.args.logging_strategy == "epoch":
                    self._wandb_run.log(
                        {"train/loss": train_loss, "train/lr": epoch_lr, "val/loss": val_loss},
                        step=self.global_step,
                    )
                else:  # val/loss is logged under every other strategy too, as in JAX
                    self._wandb_run.log({"val/loss": val_loss}, step=self.global_step)
            if self.args.save_strategy in ("epoch", "best"):
                self.save_ckpt(val_loss)
