"""Batch inference API: forecasting over preprocessed datasets.

Counterpart of ``multimodal_timesfm_tpu/inference.py``. A ``Forecaster``
serves a decoder on one device in batches of a fixed size (the final ragged
batch is padded by repeating its last row), decodes horizons beyond one
output patch autoregressively, and can denormalize predictions with the
per-sample z-score ``mean``/``std`` metadata the Time-MMD loader records.
It serves any adapter: TimesFM-2.5 and Chronos-2.

Over a (data, model) mesh (``parallel/``), each rank forecasts its contiguous
rows of every padded batch (``batch_size`` must divide by the data axis, as
in JAX), with the decoder sharded over the model axis by ``shard_params_fn``;
the forecasts are gathered to every rank as host arrays.

On CUDA the whole autoregressive decode of a batch (round 0 with its
optional text, then the context slides) is one CUDA graph, the counterpart
of JAX's one compiled decode program (``inference.py:236-268``): captured
once per (batch, context, chunk, rounds, text shape, dtype) after one eager run, then
replayed; the graphs sit in a bounded LRU of JAX's size (8). A graph reads
the parameters' storage, so weights loaded in place (``bridge.load_jax_params``)
are what it serves. On the CPU the same decode runs eagerly, and on a mesh
whose collectives ride gloo too (a CUDA graph cannot capture them).
"""

from __future__ import annotations

import warnings
from collections import OrderedDict
from typing import Any, Callable

import numpy as np
import torch

from multimodal_timesfm_torch.data.collate import StackedDataset, stack_samples
from multimodal_timesfm_torch.models.decoder import MultimodalDecoder
from multimodal_timesfm_torch.parallel.mesh import (
    DATA_AXIS,
    all_gather_rows,
    axis_group,
    axis_size,
    check_mesh,
    graphs_capture_collectives,
    local_rows,
)
from multimodal_timesfm_torch.utils.cache import lru_get
from multimodal_timesfm_torch.utils.platform import resolve_device


def _pad_rows(arr: np.ndarray, size: int) -> np.ndarray:
    """Pad ``arr`` to ``size`` rows by repeating its last row."""
    real = arr.shape[0]
    if real == size:
        return arr
    return np.concatenate([arr, np.repeat(arr[-1:], size - real, 0)])


class Forecaster:
    """A decoder, in eval mode on one device, serving batched forecasts.

    The decoder is moved to ``device``: CUDA by default, where its absence
    raises; pass ``device="cpu"`` to serve on the CPU. ``mesh``
    (``parallel.make_mesh``) splits each batch over its data axis;
    ``shard_params_fn`` (``parallel.shard_params``) shards the decoder, in
    place, over its model axis.
    """

    def __init__(
        self,
        model: MultimodalDecoder,
        batch_size: int = 64,
        device: str | torch.device | None = None,
        mesh: Any = None,
        shard_params_fn: Any = None,
    ) -> None:
        check_mesh(mesh, "Forecaster")
        if shard_params_fn is not None and mesh is None:
            raise ValueError("shard_params_fn needs a mesh to shard over")
        dp = axis_size(mesh, DATA_AXIS)
        if batch_size % dp != 0:
            raise ValueError(
                f"batch_size ({batch_size}) must be divisible by the mesh data "
                f"axis ({dp}) for sharded serving"
            )
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        if shard_params_fn is not None:
            shard_params_fn(self.model, mesh)
        self.mesh = mesh
        self.batch_size = batch_size
        self._warned_ar_text = False
        # Captured decode graphs by (batch, context, chunk, rounds, text shape, dtype); each
        # pins a graph and its static buffers, so the LRU is bounded as JAX's is.
        self._ar_graphs: OrderedDict = OrderedDict()
        self._fn_cache_max = 8
        self._use_graphs = self.device.type == "cuda" and graphs_capture_collectives(mesh)
        self.graph_captures = 0
        self.graph_replays = 0

    def _stage(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _batched(
        self,
        fn: Callable[..., torch.Tensor],
        context: np.ndarray,
        masks: np.ndarray,
        text_embeddings: np.ndarray | None,
    ) -> np.ndarray:
        """Run ``fn(context, masks, text)`` over fixed-size batches, padding the last; on a
        mesh each rank runs its rows of each batch and the outputs are gathered."""
        outs = []
        b = self.batch_size

        def rows(arr: np.ndarray) -> torch.Tensor:
            return self._stage(local_rows(_pad_rows(arr, b), self.mesh))

        with torch.inference_mode():
            for i in range(0, context.shape[0], b):
                real = min(b, context.shape[0] - i)
                txt = None if text_embeddings is None else rows(text_embeddings[i : i + b])
                out = fn(rows(context[i : i + b]), rows(masks[i : i + b]), txt)
                if self.mesh is not None:
                    out = all_gather_rows(out, axis_group(self.mesh, DATA_AXIS))
                outs.append(out.cpu().numpy()[:real])
        return np.concatenate(outs, axis=0)

    def forecast(
        self,
        horizon: int,
        context: np.ndarray,
        masks: np.ndarray | None = None,
        text_embeddings: np.ndarray | None = None,
        full: bool = False,
    ) -> np.ndarray:
        """Forecast (N, horizon) point values (or (N, horizon, Q) with ``full``)."""
        if masks is None:
            masks = np.zeros_like(context, dtype=bool)
        method = self.model.forward_full if full else self.model
        return self._batched(
            lambda x, m, t: method(horizon, x, m, t),
            np.asarray(context, np.float32), np.asarray(masks, bool), text_embeddings,
        )

    def forecast_autoregressive(
        self,
        horizon: int,
        context: np.ndarray,
        masks: np.ndarray | None = None,
        text_embeddings: np.ndarray | None = None,
        text_mode: str = "first_window",
    ) -> np.ndarray:
        """Point forecasts beyond one output patch via autoregressive decode.

        The context window slides: each round forecasts one chunk, appends
        it to the fixed-length context and drops as many of the oldest steps.
        Text fusion applies to the FIRST window only; ``text_mode`` makes
        that visible to the caller:

          * ``"first_window"`` (default): fuse the first window, and warn once
            per Forecaster when the decode spans more than one window;
          * ``"error"``: raise when text is passed and the decode needs more
            than one window.

        Args:
            horizon: total steps; may exceed the backbone's single-shot cap.
            context: (N, C) with C a multiple of the patch length.
            text_embeddings: optional (N, num_patches, T) for the first window.
            text_mode: "first_window" | "error".

        Returns:
            (N, horizon) point forecasts.
        """
        if text_mode not in ("first_window", "error"):
            raise ValueError(
                f"Unsupported text_mode: {text_mode!r} (expected 'first_window' or 'error')"
            )
        adapter = self.model.adapter
        output_patch_len = getattr(adapter.config, "output_patch_len", None)
        if output_patch_len is None:
            # Chronos-2 decodes long horizons natively (up to max_output_patches
            # x output_patch_size); its single shot is the forecast.
            return self.forecast(horizon, context, masks, text_embeddings)
        patch = adapter.patch_len
        # largest single-shot chunk that keeps the context patch-aligned
        chunk = max((output_patch_len // patch) * patch, patch)
        rounds = -(-horizon // chunk)

        if text_embeddings is not None and rounds > 1:
            if text_mode == "error":
                raise ValueError(
                    f"forecast_autoregressive with text_mode='error': horizon {horizon} "
                    f"needs {rounds} windows, but text fusion only applies to the first "
                    "window — drop the text, shorten the horizon, or use "
                    "text_mode='first_window' to accept first-window-only fusion."
                )
            if not self._warned_ar_text:
                warnings.warn(
                    "forecast_autoregressive: text fusion applies to the FIRST window "
                    f"only; the remaining {rounds - 1} window(s) decode without text. "
                    "Pass text_mode='error' to forbid this.",
                    UserWarning,
                    stacklevel=2,
                )
                self._warned_ar_text = True

        if masks is None:
            masks = np.zeros_like(context, dtype=bool)

        eager = self._decode_fn(chunk, rounds)
        decode = eager
        if self._use_graphs:
            # the graph's inputs are static buffers: every shape it copies in is in the key
            dtype = next(self.model.parameters()).dtype
            text_shape = None if text_embeddings is None else np.shape(text_embeddings)[1:]
            key = (self.batch_size, np.shape(context)[1], chunk, rounds, text_shape, dtype)
            decode = lru_get(self._ar_graphs, key, lambda: self._graph_runner(eager), self._fn_cache_max)

        out = self._batched(
            decode, np.asarray(context, np.float32), np.asarray(masks, bool), text_embeddings
        )
        return out[:, :horizon]

    def _decode_fn(self, chunk: int, rounds: int) -> Callable[..., torch.Tensor]:
        """The whole decode of one batch: round 0 (with its optional text), then ``rounds - 1``
        rounds that slide the context by ``chunk`` steps without text."""

        def decode(ctx: torch.Tensor, msk: torch.Tensor, text: torch.Tensor | None) -> torch.Tensor:
            preds = [self.model(chunk, ctx, msk, text)]
            for _ in range(rounds - 1):
                ctx = torch.cat([ctx[:, chunk:], preds[-1].to(ctx.dtype)], dim=1)
                msk = torch.cat([msk[:, chunk:], torch.zeros_like(preds[-1], dtype=torch.bool)], dim=1)
                preds.append(self.model(chunk, ctx, msk, None))
            return torch.cat(preds, dim=1)

        return decode

    def _graph_runner(self, decode: Callable[..., torch.Tensor]) -> Callable[..., torch.Tensor]:
        """``decode`` as a CUDA graph: the first call runs it eagerly on a side stream (its
        result is that call's), then captures it on static copies of the inputs; every
        later call copies its inputs in and replays. The output buffer is the graph's,
        overwritten by the next replay."""
        state: dict[str, Any] = {}

        def run(ctx: torch.Tensor, msk: torch.Tensor, text: torch.Tensor | None) -> torch.Tensor:
            if not state:
                inputs = [ctx.clone(), msk.clone(), None if text is None else text.clone()]
                side = torch.cuda.Stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side):
                    first = decode(*inputs)
                torch.cuda.current_stream(self.device).wait_stream(side)
                first.record_stream(torch.cuda.current_stream(self.device))
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    out = decode(*inputs)
                state.update(graph=graph, inputs=inputs, out=out)
                self.graph_captures += 1
                return first
            for buf, value in zip(state["inputs"], (ctx, msk, text)):
                if buf is not None:
                    buf.copy_(value)
            state["graph"].replay()
            self.graph_replays += 1
            return state["out"]

        return run

    def forecast_dataset(
        self,
        horizon: int,
        dataset: Any,
        multimodal: bool | None = None,
        denormalize: bool = False,
        full: bool = False,
        autoregressive: bool = False,
        text_mode: str = "first_window",
    ) -> np.ndarray:
        """Forecast every sample of a (preprocessed) dataset.

        With ``denormalize``, predictions are mapped back to the original
        scale via each sample's recorded ``mean``/``std`` metadata.
        ``autoregressive`` routes through :meth:`forecast_autoregressive`
        (point forecasts only), with ``text_mode`` forwarded.
        """
        if autoregressive and full:
            raise ValueError("autoregressive decode produces point forecasts only; drop full=True")
        if isinstance(dataset, StackedDataset):
            data = dataset
            if multimodal is None:
                multimodal = data.text_embeddings is not None
        else:
            if multimodal is None:
                multimodal = len(dataset) > 0 and "text_embeddings" in dataset[0]
            data = stack_samples(dataset, multimodal)

        text = data.text_embeddings if multimodal else None
        if autoregressive:
            preds = self.forecast_autoregressive(
                horizon, data.context, text_embeddings=text, text_mode=text_mode
            )
        else:
            preds = self.forecast(horizon, data.context, text_embeddings=text, full=full)
        if denormalize:
            mean = np.array([m.get("mean", 0.0) for m in data.metadata], np.float32)
            std = np.array([m.get("std", 1.0) for m in data.metadata], np.float32)
            shape = (-1,) + (1,) * (preds.ndim - 1)
            preds = preds * std.reshape(shape) + mean.reshape(shape)
        return preds
