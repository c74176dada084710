"""Split Time-MMD numerical data chronologically; copy textual data per split.

    python -m multimodal_timesfm_torch.time_mmd.split --train-ratio 0.6 --val-ratio 0.2 \\
        [--data-path data/Time-MMD] [--domains D ...] [--force-rebuild]

The port's counterpart of ``scripts/split_time_mmd_datasets.py``, with its
flags and refusals: each domain's numerical CSV is sorted by the domain's
start-date column and cut at ``int(n * train_ratio)`` and
``int(n * (train_ratio + val_ratio))`` rows into sibling ``{domain}_train``,
``{domain}_val`` and ``{domain}_test`` directories; each textual CSV is
copied byte for byte into every split directory under the split's name
(texts are filtered by window dates when they are loaded). Without
``--domains`` the domains are discovered under ``numerical/``, skipping the
outputs of an earlier split.

No pandas: rows are read and written with the ``csv`` module and every cell
keeps its source text. The sort is the one pandas gives the column as read
(``time_mmd/table.py``: strings by code point, numbers numerically, missing
cells last), so the loaders of both packages read the same windows from
these files as from the JAX script's.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

from multimodal_timesfm_torch.time_mmd.columns import DEFAULT_TIME_MMD_CONFIGS
from multimodal_timesfm_torch.time_mmd.dataset import TimeMmdDataset
from multimodal_timesfm_torch.time_mmd.table import CsvTable
from multimodal_timesfm_torch.utils.logging import get_logger, setup_logger

SPLITS = ("train", "val", "test")

_logger = get_logger()


def _parse_args(argv: list[str] | None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Split Time-MMD dataset into train / val / test sets.")
    parser.add_argument("--data-path", type=str, default="data/Time-MMD")
    parser.add_argument("--train-ratio", type=float, required=True)
    parser.add_argument("--val-ratio", type=float, required=True)
    parser.add_argument("--domains", type=str, nargs="+")
    parser.add_argument("--force-rebuild", action="store_true")
    return parser.parse_args(argv)


def split_numerical(
    numerical_dir: Path, domain: str, train_ratio: float, val_ratio: float, force: bool
) -> None:
    src = numerical_dir / domain / f"{domain}.csv"
    if not src.exists():
        _logger.warning("Numerical file not found, skipping: %s", src)
        return
    table = CsvTable.read(src)
    date_col = DEFAULT_TIME_MMD_CONFIGS.get_config_for_domain(domain).start_date_col
    if date_col not in table.columns:
        _logger.error("Date column %r not found in %s — cannot split chronologically", date_col, src)
        return
    # The rows as written (blank lines skipped, as CsvTable.read skips them), in the
    # column's sort order.
    with open(src, newline="", encoding="utf-8-sig") as f:
        rows = [row for row in csv.reader(f) if row]
    header, body = rows[0], rows[1:]
    body = [body[i] for i in table.order(date_col)]

    n = len(body)
    train_end = int(n * train_ratio)
    val_end = int(n * (train_ratio + val_ratio))
    slices = {"train": body[:train_end], "val": body[train_end:val_end], "test": body[val_end:]}
    for split in SPLITS:
        split_domain = f"{domain}_{split}"
        out_path = numerical_dir / split_domain / f"{split_domain}.csv"
        out_path.parent.mkdir(parents=True, exist_ok=True)
        if out_path.exists() and not force:
            _logger.info("Skip (exists): %s", out_path)
            continue
        with open(out_path, "w", newline="", encoding="utf-8") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(header)
            writer.writerows(slices[split])
        _logger.info("Wrote: %s (%d rows)", out_path, len(slices[split]))


def duplicate_textual(textual_dir: Path, domain: str, force: bool) -> None:
    domain_dir = textual_dir / domain
    if not domain_dir.exists():
        _logger.warning("Textual directory not found, skipping: %s", domain_dir)
        return
    for src in sorted(domain_dir.glob("*.csv")):
        # "{domain}_report.csv" -> suffix "report"
        suffix = src.stem.removeprefix(f"{domain}_")
        for split in SPLITS:
            split_domain = f"{domain}_{split}"
            out_path = textual_dir / split_domain / f"{split_domain}_{suffix}.csv"
            out_path.parent.mkdir(parents=True, exist_ok=True)
            if out_path.exists() and not force:
                _logger.info("Skip (exists): %s", out_path)
                continue
            out_path.write_bytes(src.read_bytes())
            _logger.info("Copied: %s -> %s", src, out_path)


def main(argv: list[str] | None = None) -> int:
    args = _parse_args(argv)
    setup_logger()
    if args.train_ratio + args.val_ratio >= 1.0:
        _logger.error("train_ratio + val_ratio must be < 1.0")
        return 1

    data_path = Path(args.data_path)
    if args.domains:
        domains = args.domains  # explicit requests are honoured as given
    else:
        # Auto-discovery never re-splits the outputs of an earlier split.
        domains = [
            d for d in TimeMmdDataset.get_domains(data_path) if not d.endswith(("_train", "_val", "_test"))
        ]
    for domain in domains:
        _logger.info("Splitting domain %s", domain)
        split_numerical(data_path / "numerical", domain, args.train_ratio, args.val_ratio, args.force_rebuild)
        duplicate_textual(data_path / "textual", domain, args.force_rebuild)
    _logger.info("Done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
