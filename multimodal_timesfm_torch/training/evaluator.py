"""Evaluator: MSE and MAE (and optionally quantile metrics) over a dataset.

Counterpart of ``multimodal_timesfm_tpu/training/evaluator.py``: the mean
per-sample MSE and MAE over the dataset, computed in padded static batches
(the last batch is filled by wrapping around with zero-weight rows), summed
on the device and read once. ``quantile_metrics=True`` adds the mean pinball
loss over the adapter's quantile levels and the weighted quantile loss
``2 * sum(pinball) / sum(|y|)``. Over a mesh the batch is padded to the data
axis, as JAX pads it, each rank evaluates its rows of each batch, and the
sums are summed over the data axis.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from multimodal_timesfm_torch.data.collate import StackedDataset, stack_samples
from multimodal_timesfm_torch.models.decoder import MultimodalDecoder
from multimodal_timesfm_torch.parallel.mesh import (
    DATA_AXIS,
    all_reduce_sum,
    axis_group,
    axis_size,
    check_mesh,
    local_rows,
    pad_to_multiple,
)
from multimodal_timesfm_torch.types import EvaluationMetrics
from multimodal_timesfm_torch.utils.platform import resolve_device


class MultimodalEvaluator:
    """Computes evaluation metrics for a decoder, on CUDA unless ``device`` says otherwise.

    The decoder is moved to the device. ``mesh`` (``parallel.make_mesh``) splits each
    batch over its data axis; a decoder sharded over its model axis is evaluated as it is.
    """

    def __init__(
        self, model: MultimodalDecoder, device: str | torch.device | None = None, mesh: Any = None
    ) -> None:
        check_mesh(mesh, "MultimodalEvaluator")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.mesh = mesh

    @torch.no_grad()
    def evaluate(
        self,
        dataset: Any,
        batch_size: int = 8,
        multimodal: bool | None = None,
        quantile_metrics: bool = False,
    ) -> EvaluationMetrics:
        """Evaluate over ``dataset`` (samples or a ``StackedDataset``); raises if it is empty.

        ``multimodal`` defaults to whether the data carries text embeddings.
        """
        if not isinstance(dataset, StackedDataset):
            if len(dataset) == 0:
                raise RuntimeError("Evaluation dataset is empty.")
            if multimodal is None:
                multimodal = "text_embeddings" in dataset[0]
            data = stack_samples(dataset, multimodal)
        else:
            data = dataset
            if multimodal is None:
                multimodal = data.text_embeddings is not None
        n = len(data)
        if n == 0:
            raise RuntimeError("Evaluation dataset is empty.")

        horizon_len = int(data.horizon.shape[1])
        b = pad_to_multiple(batch_size, axis_size(self.mesh, DATA_AXIS))
        num_batches = math.ceil(n / b)
        take = np.resize(np.arange(n), num_batches * b).reshape(num_batches, b)
        weights = np.zeros(num_batches * b, np.float32)
        weights[:n] = 1.0
        # This rank's contiguous rows of every batch (all of them without a mesh).
        take = local_rows(take, self.mesh, dim=1)
        weights = local_rows(weights.reshape(num_batches, b), self.mesh, dim=1)
        text = data.text_embeddings if multimodal else None
        if quantile_metrics:
            levels, mean_channel = self.model.adapter.quantile_loss_spec
            levels_t = torch.tensor(levels, dtype=torch.float32, device=self.device)

        def stage(arr: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        total_se, total_ae, total_pb, total_abs = zero, zero, zero, zero
        for i in range(num_batches):
            rows = take[i]
            context, horizon, w = stage(data.context[rows]), stage(data.horizon[rows]), stage(weights[i])
            masks = torch.zeros_like(context, dtype=torch.bool)
            txt = None if text is None else stage(text[rows])
            w = w[:, None]
            if quantile_metrics:
                full = self.model.forward_full(horizon_len, context, masks, txt).float()
                point = full[..., self.model.adapter.point_forecast_index]
                q_channels = [c for c in range(full.shape[-1]) if c != mean_channel]
                errs = horizon[..., None] - full[..., q_channels]
                pinball = torch.maximum((levels_t - 1.0) * errs, levels_t * errs)
                total_pb = total_pb + torch.sum(pinball * w[..., None]) / (horizon_len * len(levels))
                total_abs = total_abs + torch.sum(torch.abs(horizon) * w) / horizon_len
            else:
                point = self.model(horizon_len, context, masks, txt)
            err = point.float() - horizon
            total_se = total_se + torch.sum(err * err * w) / horizon_len
            total_ae = total_ae + torch.sum(torch.abs(err) * w) / horizon_len

        totals = torch.stack([total_se, total_ae, total_pb, total_abs])
        if self.mesh is not None:
            totals = all_reduce_sum([totals], axis_group(self.mesh, DATA_AXIS))[0]
        se, ae, pb, ab = (float(t) for t in totals.cpu())
        metrics = EvaluationMetrics(mse=se / n, mae=ae / n)
        if quantile_metrics:
            metrics["mean_pinball"] = pb / n
            metrics["wql"] = 2.0 * pb / max(ab, 1e-12)
        return metrics
