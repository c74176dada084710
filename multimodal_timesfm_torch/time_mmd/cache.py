"""Pre-compute and cache text embeddings for Time-MMD domains, on the CUDA device.

    python -m multimodal_timesfm_torch.time_mmd.cache --text-encoder-type english \\
        [--text-model-dir SNAPSHOT] [--data-path data/Time-MMD] [--domains D ...] \\
        [--augment] [--cache-dir data/cache] [--model-config M.yml] \\
        [--forecast-config F.yml] [--force-rebuild] [--seed N] [--device cpu]

The port's counterpart of ``scripts/cache_time_mmd_datasets.py``, with its
flags: for every (or each selected) domain, build a ``TimeMmdDataset``, run
the frozen text encoder over each sample's per-patch texts and pickle the
samples under the standard cache keys, in the layout the JAX package reads.
``--text-model-dir`` points at a local HF snapshot (a path or an ``org/name``
id, see ``models/snapshot.py``); without it the encoder runs with weights
drawn from seed 0 and the hash tokenizer, and the caches say so. The encoder
runs on the CUDA device unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from multimodal_timesfm_torch.data.preprocess import PreprocessPipeline
from multimodal_timesfm_torch.text.encoders import build_text_encoder
from multimodal_timesfm_torch.time_mmd.configs import FusionConfig, ForecastConfig, ModelConfig
from multimodal_timesfm_torch.time_mmd.dataset import TimeMmdDataset
from multimodal_timesfm_torch.utils.logging import setup_logger
from multimodal_timesfm_torch.utils.seed import set_seed


def declared_embedding_dim(text_encoder_type: str, fusion: FusionConfig) -> int | None:
    """The fusion config's ``text_embedding_dims`` when it describes THIS encoder type,
    else None (the encoder's own default, 384 or 768): a japanese caching run with a
    default (english/384) model config must not fail on 384 against 768."""
    if fusion.text_encoder_type == text_encoder_type:
        return fusion.text_embedding_dims
    return None


def _parse_args(argv: list[str] | None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Pre-compute and cache text embeddings for Time-MMD domains."
    )
    parser.add_argument("--model-config", type=str)
    parser.add_argument("--forecast-config", type=str)
    parser.add_argument(
        "--text-encoder-type", type=str, choices=["english", "japanese"], required=True
    )
    parser.add_argument("--text-model-dir", type=str, help="Local HF snapshot for the encoder.")
    parser.add_argument("--data-path", type=str, default="data/Time-MMD")
    parser.add_argument("--domains", type=str, nargs="+")
    parser.add_argument("--augment", action="store_true")
    parser.add_argument("--cache-dir", type=str, default="data/cache")
    parser.add_argument("--force-rebuild", action="store_true")
    parser.add_argument("--seed", type=int)
    parser.add_argument("--device", type=str, help="Device of the encoder (default: CUDA).")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = _parse_args(argv)
    logger = setup_logger()

    model_config = ModelConfig.from_yaml(args.model_config) if args.model_config else ModelConfig()
    forecast_config = (
        ForecastConfig.from_yaml(args.forecast_config) if args.forecast_config else ForecastConfig()
    )
    if args.seed is not None:
        set_seed(args.seed)

    text_encoder = build_text_encoder(
        args.text_encoder_type,
        args.text_model_dir,
        embedding_dim=declared_embedding_dim(args.text_encoder_type, model_config.fusion),
        device=args.device,
    )
    logger.info(
        "Text encoder: %s on %s (pretrained=%s, tokenizer %s)", args.text_encoder_type,
        text_encoder.device, text_encoder.is_pretrained, text_encoder.tokenizer_name,
    )

    data_path = Path(args.data_path)
    domains = args.domains or TimeMmdDataset.get_domains(data_path)
    logger.info("Caching %d domains: %s", len(domains), domains)

    pipeline = PreprocessPipeline(Path(args.cache_dir))
    for domain in domains:
        logger.info("Processing domain: %s", domain)
        cache_path = pipeline.get_path(
            dataset_name="time_mmd",
            entity=domain,
            text_encoder_type=args.text_encoder_type,
            patch_len=model_config.adapter.patch_len,
            context_len=forecast_config.context_len,
            horizon_len=forecast_config.horizon_len,
            augment=args.augment,
        )

        def _dataset_factory(domain: str = domain) -> TimeMmdDataset:
            return TimeMmdDataset(
                data_dir=data_path,
                domain=domain,
                patch_len=model_config.adapter.patch_len,
                context_len=forecast_config.context_len,
                horizon_len=forecast_config.horizon_len,
                augment=args.augment,
            )

        pipeline.prepare(
            path=cache_path,
            dataset_factory=_dataset_factory,
            text_encoder=text_encoder,
            force_rebuild=args.force_rebuild,
        )
        logger.info("Done: %s -> %s", domain, cache_path)

    logger.info("All domains cached successfully")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
