"""Hyperparameter tuning for baseline (backbone fine-tune) forecasting.

    python -m multimodal_timesfm_torch.tune_baseline [the flags of multimodal_timesfm_torch.tune]

The port's counterpart of ``scripts/tune_baseline_sweep.py``: the same CLI
and flow as ``multimodal_timesfm_torch.tune`` in baseline mode (the adapter
is fine-tuned, the fusion MLP unused, the datasets read without text).
"""

from __future__ import annotations

from multimodal_timesfm_torch.tune import main as tune_main


def main(argv: list[str] | None = None) -> int:
    return tune_main(argv, mode="baseline")


if __name__ == "__main__":
    raise SystemExit(main())
