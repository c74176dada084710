"""Export a (fine-tuned) forecaster as a ``torch.export`` program or an AOTInductor package.

    python -m multimodal_timesfm_torch.export --output exported/ \\
        [--model-config M.yml] [--pretrained-dir SNAPSHOT] [--fusion-checkpoint CKPT] \\
        [--context-len 32] [--horizon 32] [--multimodal] [--full-outputs] [--seed 0] \\
        [--format program|aoti] [--device cpu]

The port's counterpart of ``scripts/export_saved_model.py``, with its flags
plus ``--device``, the device the model is traced on (CUDA unless told
otherwise). ``--format program`` (the default; JAX's ``stablehlo``) writes
the ``ExportedProgram``, which serves on both devices; ``--format aoti``
(JAX's ``savedmodel``, which is JAX's default) compiles it with AOTInductor
for the tracing device, the only one it serves on. Both load through
``serving.load_program``. ``--fusion-checkpoint`` takes a port or a JAX
trainer checkpoint; every trained subtree it carries is applied.
"""

from __future__ import annotations

import argparse

from multimodal_timesfm_torch.serving import FORMATS, export_program
from multimodal_timesfm_torch.time_mmd.configs import ModelConfig
from multimodal_timesfm_torch.time_mmd.models import apply_checkpoint, build_decoder
from multimodal_timesfm_torch.utils.logging import setup_logger


def _parse_args(argv: list[str] | None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model-config", type=str, help="Model YAML (adapter + fusion).")
    parser.add_argument("--pretrained-dir", type=str, help="Backbone snapshot dir or HF repo id.")
    parser.add_argument(
        "--fusion-checkpoint",
        type=str,
        help="Trainer checkpoint (.ckpt) whose fusion_params to bake in (multimodal).",
    )
    parser.add_argument("--context-len", type=int, default=32)
    parser.add_argument("--horizon", type=int, default=32)
    parser.add_argument("--multimodal", action="store_true")
    parser.add_argument("--full-outputs", action="store_true", help="Also emit all channels.")
    parser.add_argument(
        "--format",
        choices=sorted(FORMATS),
        default="program",
        help="program: the torch.export program (serves on both devices); aoti: it compiled by "
        "AOTInductor for the tracing device.",
    )
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, help="Device to trace on (default: CUDA).")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = _parse_args(argv)
    logger = setup_logger()
    model_config = ModelConfig.from_yaml(args.model_config) if args.model_config else ModelConfig()
    decoder = build_decoder(model_config, args.pretrained_dir, args.seed, device=args.device)
    if args.fusion_checkpoint and not apply_checkpoint(decoder, args.fusion_checkpoint):
        logger.error(
            "%s carries neither fusion_params nor adapter_params — is it a training "
            "checkpoint? (raw params trees load via --pretrained-dir)", args.fusion_checkpoint,
        )
        return 1
    export_program(
        decoder,
        horizon=args.horizon,
        context_len=args.context_len,
        output_dir=args.output,
        multimodal=args.multimodal,
        full_outputs=args.full_outputs,
        format=args.format,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
