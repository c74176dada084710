"""Time-MMD dataset loader: numerical series + patch-aligned textual reports.

The port's counterpart of ``examples/time_mmd/data/time_mmd_dataset.py``,
giving the same samples in the same order without pandas
(``time_mmd/table.py`` reads the CSVs as ``pandas.read_csv`` does):

  * loads ``numerical/{D}/{D}.csv`` plus optional
    ``textual/{D}/{D}_report.csv`` / ``{D}_search.csv``, sorted by start date,
  * per configured numeric column: trims leading/trailing NaN/inf, replaces
    interior invalids by linear interpolation over the row positions,
  * slides windows of ``context_len + horizon_len`` with stride
    ``horizon_len``; optional augmentation adds one window set per start
    shift in ``range(patch_len)``,
  * per-sample z-score using **context statistics only**, std clamped to 1.0
    below 1e-6,
  * divides each window's date span evenly into ``context_len // patch_len``
    sub-periods (truncated to whole microseconds, as pandas divides a
    ``Timedelta``) and collects overlapping texts with ``Report: `` /
    ``Report Prediction: `` / ``Search: `` / ``Search prediction: ``
    prefixes from the ``fact``/``preds`` columns; texts that are missing,
    empty or start with ``NA`` are dropped,
  * metadata records domain/column/shift/start_index/mean/std as Python
    scalars.

A date this loader cannot parse raises ``ValueError`` naming the file and
the value, where pandas would read some of them as NaT or, in a text table
whose dates read as integers, as nanoseconds since the epoch.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from multimodal_timesfm_torch.data.dataset import MultimodalDatasetBase
from multimodal_timesfm_torch.time_mmd.columns import DEFAULT_TIME_MMD_CONFIGS, DomainColumnConfig
from multimodal_timesfm_torch.time_mmd.table import CsvTable, parse_date
from multimodal_timesfm_torch.types import RawSample

_STD_EPS = 1e-6


def _clean_text(text: str | None) -> str | None:
    """Missing/empty/'NA'-prefixed -> None, else the stripped string."""
    if text is None:
        return None
    text = text.strip()
    if not text or text.startswith("NA"):
        return None
    return text


@dataclass
class _TextTable:
    """One textual CSV as parallel arrays for interval joins."""

    starts: np.ndarray  # int64 microseconds since the epoch
    ends: np.ndarray
    dated: np.ndarray  # bool: both dates present (a missing one never overlaps)
    texts: list[list[str]]  # per row: prefixed fact/preds strings, in order

    @classmethod
    def build(cls, table: CsvTable, fact_prefix: str, preds_prefix: str) -> "_TextTable | None":
        if "start_date" not in table.columns or "end_date" not in table.columns:
            return None
        starts, start_ok = table.dates("start_date")
        ends, end_ok = table.dates("end_date")
        columns = [
            (table.values(name), prefix)
            for name, prefix in (("fact", fact_prefix), ("preds", preds_prefix))
            if name in table.columns
        ]
        texts: list[list[str]] = []
        for i in range(len(table)):
            row_texts = []
            for values, prefix in columns:
                cleaned = _clean_text(values[i])
                if cleaned is not None:
                    row_texts.append(f"{prefix}{cleaned}")
            texts.append(row_texts)
        return cls(starts=starts, ends=ends, dated=start_ok & end_ok, texts=texts)

    def overlapping(self, patch_start: int, patch_end: int) -> list[str]:
        """All texts of rows whose [start, end] overlaps [patch_start, patch_end]."""
        mask = self.dated & (self.starts <= patch_end) & (self.ends >= patch_start)
        out: list[str] = []
        for idx in np.flatnonzero(mask):
            out.extend(self.texts[idx])
        return out


class TimeMmdDataset(MultimodalDatasetBase):
    """Loader for one Time-MMD domain.

    Expected directory structure::

        data_dir/
          numerical/(Domain)/(Domain).csv
          textual/(Domain)/(Domain)_report.csv
          textual/(Domain)/(Domain)_search.csv
    """

    def __init__(
        self,
        data_dir: Path,
        domain: str,
        patch_len: int = 32,
        context_len: int = 32,
        horizon_len: int = 32,
        column_config: DomainColumnConfig | None = None,
        augment: bool = False,
    ) -> None:
        self.data_dir = Path(data_dir)
        self.domain = domain
        self.patch_len = patch_len
        self.context_len = context_len
        self.horizon_len = horizon_len
        self.column_config = column_config or DEFAULT_TIME_MMD_CONFIGS.get_config_for_domain(domain)
        self.augment = augment
        self.data: list[RawSample] = []

        self._validate()
        self._load_data()

    def _validate(self) -> None:
        if not self.data_dir.exists():
            raise FileNotFoundError(f"Data directory not found: {self.data_dir}")
        if self.context_len % self.patch_len != 0:
            raise ValueError(
                f"context_len ({self.context_len}) must be an integer multiple of "
                f"patch_len ({self.patch_len})"
            )
        if self.horizon_len % self.patch_len != 0:
            raise ValueError(
                f"horizon_len ({self.horizon_len}) must be an integer multiple of "
                f"patch_len ({self.patch_len})"
            )

    @staticmethod
    def _sanitize_series(values: np.ndarray) -> tuple[np.ndarray, int, int] | None:
        """Trim leading/trailing invalids and interpolate interior ones linearly over the
        row positions: (values, first row, end row), or None when no value is finite.

        The ends are finite after the trim, so ``np.interp`` over the finite points is
        pandas' ``interpolate(method="linear", limit_direction="both")`` (which calls
        it too) and its ``ffill``/``bfill`` have nothing left to fill.
        """
        finite = np.isfinite(values)  # False for NaN and +/-inf
        valid_idx = np.flatnonzero(finite)
        if valid_idx.size == 0:
            return None
        lo, hi = int(valid_idx[0]), int(valid_idx[-1]) + 1
        vals = values[lo:hi].copy()
        bad = ~finite[lo:hi]
        if bad.any():
            pos = np.arange(vals.size)
            vals[bad] = np.interp(pos[bad], pos[~bad], vals[~bad])
        return vals, lo, hi

    @staticmethod
    def _zscore_window(
        context: np.ndarray, horizon: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, float, float]:
        """Z-score both windows with context-only stats (std<1e-6 -> 1.0)."""
        mean = float(np.mean(context))
        std = float(np.std(context))
        if std < _STD_EPS:
            std = 1.0
        return (context - mean) / std, (horizon - mean) / std, mean, std

    @staticmethod
    def _patched_texts(
        window_start: int, window_end: int, tables: list[_TextTable], num_patches: int
    ) -> list[list[str]]:
        """Split [window_start, window_end] into equal sub-periods; gather overlaps.

        The sub-period is ``int(span / num_patches)`` microseconds: pandas divides a
        ``Timedelta`` by an integer in floating point and truncates toward zero.
        """
        duration = int((window_end - window_start) / num_patches)
        patches: list[list[str]] = []
        for i in range(num_patches):
            patch_start = window_start + i * duration
            patch_end = window_start + (i + 1) * duration
            collected: list[str] = []
            for table in tables:
                collected.extend(table.overlapping(patch_start, patch_end))
            patches.append(collected)
        return patches

    def _process_data(self, numerical: CsvTable, tables: list[_TextTable]) -> None:
        numeric_cols = self.column_config.get_time_series_columns(all_columns=numerical.columns)
        if not numeric_cols:
            raise ValueError(
                f"No time series columns found for domain {self.domain!r} with the given configuration"
            )
        for col_name in (self.column_config.start_date_col, self.column_config.end_date_col):
            if col_name not in numerical.columns:
                raise ValueError(
                    f"Date column {col_name!r} not found in numerical data. "
                    f"Available columns: {numerical.columns}"
                )

        full_starts = numerical.values(self.column_config.start_date_col)
        full_ends = numerical.values(self.column_config.end_date_col)

        def parse(values: list[str | None], column: str) -> np.ndarray:
            if None in values:
                raise ValueError(f"{numerical.path}: a row of the series has no {column!r}")
            return np.array([parse_date(numerical.path, v) for v in values], np.int64)

        window_len = self.context_len + self.horizon_len
        text_patches_num = self.context_len // self.patch_len
        shifts = range(self.patch_len) if self.augment else range(1)

        for column in numeric_cols:
            sanitized = self._sanitize_series(numerical.floats(column))
            if sanitized is None:
                continue
            ts_data, lo, hi = sanitized
            if len(ts_data) < window_len:
                continue
            # Each window's boundary dates, parsed one value at a time as the JAX
            # loader's pd.to_datetime(str(v)) does.
            start_dt = parse(full_starts[lo:hi], self.column_config.start_date_col)
            end_dt = parse(full_ends[lo:hi], self.column_config.end_date_col)

            for shift in shifts:
                for start_index in range(shift, len(ts_data) - window_len + 1, self.horizon_len):
                    context_end = start_index + self.context_len
                    context = ts_data[start_index:context_end]
                    horizon = ts_data[context_end : context_end + self.horizon_len]

                    ctx_norm, hor_norm, mean, std = self._zscore_window(context, horizon)
                    patched_texts = self._patched_texts(
                        int(start_dt[start_index]), int(end_dt[context_end - 1]), tables,
                        text_patches_num,
                    )
                    self.data.append(
                        RawSample(
                            context=ctx_norm.astype(np.float32),
                            horizon=hor_norm.astype(np.float32),
                            patched_texts=patched_texts,
                            metadata={
                                "domain": self.domain,
                                "column": column,
                                "shift": shift,
                                "start_index": start_index,
                                "mean": mean,
                                "std": std,
                            },
                        )
                    )

    def _load_data(self) -> None:
        numerical_file = self.data_dir / "numerical" / self.domain / f"{self.domain}.csv"
        textual_dir = self.data_dir / "textual" / self.domain
        if not numerical_file.exists():
            raise FileNotFoundError(f"Numerical data file not found: {numerical_file}")

        numerical = CsvTable.read(numerical_file)
        start_col = self.column_config.start_date_col
        if start_col in numerical.columns:
            numerical = numerical.take(numerical.order(start_col))

        tables: list[_TextTable] = []
        for name, fact_prefix, preds_prefix in (
            ("report", "Report: ", "Report Prediction: "),
            ("search", "Search: ", "Search prediction: "),
        ):
            path = textual_dir / f"{self.domain}_{name}.csv"
            if path.exists():
                table = _TextTable.build(CsvTable.read(path), fact_prefix, preds_prefix)
                if table is not None:
                    tables.append(table)

        self._process_data(numerical, tables)

    @classmethod
    def get_domains(cls, path: Path) -> list[str]:
        """Sorted domain names found under ``numerical/``."""
        numerical_dir = Path(path) / "numerical"
        if not numerical_dir.exists():
            raise FileNotFoundError(f"Numerical data directory not found: {numerical_dir}")
        return sorted(d.name for d in numerical_dir.iterdir() if d.is_dir())

    def __getitem__(self, index: int) -> RawSample:
        if index >= len(self.data):
            raise IndexError(f"Index {index} out of range for dataset of size {len(self.data)}")
        return self.data[index]

    def __len__(self) -> int:
        return len(self.data)
