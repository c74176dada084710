"""CSV tables read the way the JAX loader's ``pandas.read_csv`` reads them, without pandas.

The JAX Time-MMD loader (``examples/time_mmd/data/time_mmd_dataset.py``)
leans on pandas for five things, each reproduced here with the ``csv``
module and numpy:

  * missing values: a cell equal to one of pandas' default NA strings
    (:data:`NA_VALUES`) is missing, in text and number columns alike;
  * column types: a column whose every cell is an integer reads as integers,
    one whose present cells are all numbers (or that holds nothing) as
    floats, any other as strings (:meth:`CsvTable.kind`); the type decides
    how the column sorts and how its cells print;
  * sorting by a column as read (:meth:`CsvTable.order`): integers and floats
    numerically, strings by code point, missing cells last;
  * dates parsed one value at a time (:func:`parse_date`), to microseconds
    since the epoch, pandas' resolution for dates read from strings;
  * numbers: Python's ``float``, which rounds correctly (pandas' own parser
    may differ from it in the last bit of a float64).

Whatever this module cannot parse raises ``ValueError`` naming the file and
the value: it never guesses.
"""

from __future__ import annotations

import csv
import datetime as _dt
import re
from pathlib import Path

import numpy as np

# pandas' default ``na_values`` (``pandas._libs.parsers.STR_NA_VALUES``).
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})

# The tokens pandas' C parser reads as int64 and as float64.
_INT = re.compile(r"\s*[+-]?\d+\s*")
_FLOAT = re.compile(r"\s*[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|inf|infinity)\s*", re.IGNORECASE)
# YYYY, YYYY-MM, YYYY-MM-DD, then optionally a time HH:MM[:SS[.ffffff]] after a space or T.
_DATE = re.compile(
    r"(\d{4})(?:[-/](\d{1,2})(?:[-/](\d{1,2})"
    r"(?:[ T](\d{1,2}):(\d{2})(?::(\d{2})(?:\.(\d{1,6}))?)?)?)?)?"
)
_EPOCH = _dt.datetime(1970, 1, 1)


def parse_date(path: Path, value: str) -> int:
    """Microseconds since the epoch of one date as ``pd.to_datetime(value)`` reads it.

    Takes an integer year (``2001`` is 2001-01-01), ``YYYY-MM``, ``YYYY-MM-DD``
    (or with ``/``), and a date with a time; raises ``ValueError`` naming
    ``path`` and ``value`` on anything else.
    """
    found = _DATE.fullmatch(value.strip())
    if found is None:
        raise ValueError(f"{path}: cannot parse {value!r} as a date")
    year, month, day, hour, minute, second, frac = found.groups()
    try:
        stamp = _dt.datetime(
            int(year), int(month or 1), int(day or 1), int(hour or 0), int(minute or 0),
            int(second or 0), int((frac or "0").ljust(6, "0")),
        )
    except ValueError as exc:
        raise ValueError(f"{path}: cannot parse {value!r} as a date ({exc})") from None
    return (stamp - _EPOCH) // _dt.timedelta(microseconds=1)


class CsvTable:
    """A CSV file as columns of cells, ``None`` for a missing cell."""

    def __init__(self, path: Path, columns: list[str], cells: dict[str, list[str | None]]) -> None:
        self.path = path
        self.columns = columns
        self.cells = cells

    @classmethod
    def read(cls, path: Path | str) -> "CsvTable":
        """Read ``path``: the first row names the columns (a UTF-8 byte-order mark
        dropped, as pandas drops it); blank lines are skipped; a short row is padded
        with missing cells; a row longer than the header raises."""
        path = Path(path)
        with open(path, newline="", encoding="utf-8-sig") as f:
            rows = [row for row in csv.reader(f) if row]
        if not rows:
            raise ValueError(f"{path}: no header row")
        header, body = rows[0], rows[1:]
        if len(set(header)) != len(header):
            raise ValueError(f"{path}: repeated column names in {header}")
        columns: dict[str, list[str | None]] = {name: [] for name in header}
        for line, row in enumerate(body, start=2):
            if len(row) > len(header):
                raise ValueError(f"{path}: row {line} has {len(row)} fields, the header {len(header)}")
            row = row + [""] * (len(header) - len(row))
            for name, cell in zip(header, row):
                columns[name].append(None if cell in NA_VALUES else cell)
        return cls(path, header, columns)

    def __len__(self) -> int:
        return len(self.cells[self.columns[0]]) if self.columns else 0

    def kind(self, column: str) -> str:
        """``"int"``, ``"float"`` or ``"str"``: the type pandas gives the column."""
        present = [c for c in self.cells[column] if c is not None]
        if len(present) == len(self.cells[column]) and present and all(_INT.fullmatch(c) for c in present):
            return "int"
        if all(_INT.fullmatch(c) or _FLOAT.fullmatch(c) for c in present):
            return "float"
        return "str"

    def floats(self, column: str) -> np.ndarray:
        """The column as float64, NaN where a cell is missing."""
        out = np.empty(len(self), np.float64)
        for i, cell in enumerate(self.cells[column]):
            try:
                out[i] = np.nan if cell is None else float(cell)
            except ValueError:
                raise ValueError(
                    f"{self.path}: cannot parse {cell!r} in column {column!r} as a number"
                ) from None
        return out

    def values(self, column: str) -> list[str | None]:
        """The cells as ``str()`` of what pandas hands out: ``"7"`` for an integer
        column's ``007``, ``"1000.0"`` for a float column's ``1e3``; ``None`` if missing."""
        kind = self.kind(column)
        cells = self.cells[column]
        if kind == "int":
            return [str(int(c)) for c in cells]
        if kind == "float":
            return [None if c is None else str(float(c)) for c in cells]
        return list(cells)

    def order(self, column: str) -> list[int]:
        """Row order sorted by ``column`` as read, missing cells last, ties in file order."""
        cells = self.cells[column]
        key = (lambda c: c) if self.kind(column) == "str" else float
        present = [i for i, c in enumerate(cells) if c is not None]
        missing = [i for i, c in enumerate(cells) if c is None]
        return sorted(present, key=lambda i: key(cells[i])) + missing

    def take(self, rows: list[int]) -> "CsvTable":
        """The table with its rows in the order ``rows``."""
        cells = {name: [col[i] for i in rows] for name, col in self.cells.items()}
        return CsvTable(self.path, self.columns, cells)

    def dates(self, column: str) -> tuple[np.ndarray, np.ndarray]:
        """The column parsed whole, as ``pd.to_datetime(df[column])`` does for dates
        read as strings: (microseconds since the epoch, present mask). A column
        pandas reads as numbers would be taken for nanoseconds since the epoch;
        that raises here."""
        cells = self.cells[column]
        if self.kind(column) != "str" and any(c is not None for c in cells):
            raise ValueError(
                f"{self.path}: column {column!r} holds numbers, not dates "
                f"(first value {next(c for c in cells if c is not None)!r})"
            )
        present = np.array([c is not None for c in cells], bool)
        stamps = np.array([0 if c is None else parse_date(self.path, c) for c in cells], np.int64)
        return stamps, present
