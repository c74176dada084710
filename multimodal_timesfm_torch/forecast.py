"""Batch forecasting CLI: run a trained model over a cached dataset, on the CUDA device.

    python -m multimodal_timesfm_torch.forecast --cache-file CACHE.pkl --horizon H \\
        [--model-config M.yml] [--pretrained-dir SNAPSHOT] [--checkpoint CKPT] \\
        [--multimodal] [--full] [--autoregressive] [--text-mode first_window|error] \\
        [--denormalize] [--batch-size N] [--output forecasts.npz] [--device cpu]

The port's counterpart of ``scripts/forecast.py``, with its flags plus
``--device``: loads a cached sample pickle, a backbone (a local snapshot or
random weights) and optionally a trained checkpoint (``fusion_params`` and/or
``adapter_params``; one the port wrote or one the JAX trainer wrote), and
writes the forecasts and each sample's metadata to an ``.npz`` with the JAX
script's keys (``forecasts``, ``metadata``). With ``--autoregressive`` the
decode of each batch is one CUDA graph on the card.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from multimodal_timesfm_torch.data.preprocess import PreprocessPipeline
from multimodal_timesfm_torch.inference import Forecaster
from multimodal_timesfm_torch.time_mmd.configs import ModelConfig
from multimodal_timesfm_torch.time_mmd.models import apply_checkpoint, build_decoder
from multimodal_timesfm_torch.utils.logging import setup_logger


def _parse_args(argv: list[str] | None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Batch forecasting over a cached dataset.")
    parser.add_argument("--cache-file", type=str, required=True, help="PreprocessedSample pickle.")
    parser.add_argument("--model-config", type=str)
    parser.add_argument("--horizon", type=int, required=True)
    parser.add_argument("--pretrained-dir", type=str, help="Local backbone checkpoint dir.")
    parser.add_argument("--checkpoint", type=str, help="Trained .ckpt (fusion or adapter).")
    parser.add_argument("--multimodal", action="store_true", help="Feed text embeddings.")
    parser.add_argument("--full", action="store_true", help="All quantile channels.")
    parser.add_argument(
        "--autoregressive",
        action="store_true",
        help="Decode horizons beyond the backbone's single-shot cap by sliding the context "
        "window (one CUDA graph per batch on the card; point forecasts only).",
    )
    parser.add_argument(
        "--text-mode",
        choices=("first_window", "error"),
        default="first_window",
        help="Multi-window AR with text: fuse the first window only (default, warns once) "
        "or refuse ('error').",
    )
    parser.add_argument("--denormalize", action="store_true")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--output", type=str, default="forecasts.npz")
    parser.add_argument("--device", type=str, help="Device to serve on (default: CUDA).")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = _parse_args(argv)
    logger = setup_logger()
    model_config = ModelConfig.from_yaml(args.model_config) if args.model_config else ModelConfig()
    decoder = build_decoder(model_config, args.pretrained_dir, seed=0, device=args.device)
    if args.checkpoint:
        apply_checkpoint(decoder, args.checkpoint)

    cache = Path(args.cache_file)
    samples = PreprocessPipeline(cache.parent).load(cache)
    forecaster = Forecaster(decoder, batch_size=args.batch_size, device=args.device)
    preds = forecaster.forecast_dataset(
        args.horizon,
        samples,
        multimodal=args.multimodal,
        denormalize=args.denormalize,
        full=args.full,
        autoregressive=args.autoregressive,
        text_mode=args.text_mode,
    )
    metadata = [s["metadata"] for s in samples]
    np.savez(
        args.output,
        forecasts=preds,
        metadata=np.asarray([json.dumps(m, default=str) for m in metadata]),
    )
    logger.info("Wrote %s forecasts of shape %s to %s", len(preds), preds.shape, args.output)
    if forecaster.graph_captures:
        logger.info("Decode graphs: %d captured, %d replays", forecaster.graph_captures,
                    forecaster.graph_replays)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
