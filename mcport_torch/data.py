"""Price CSVs → resampled prices, returns and annualised moments, without pandas.

The port's copy of ``mcport.data.load_universe`` (``mcport/data/csv_loader.py``
and ``mcport/data/pipeline.py``), in the standard library and NumPy alone: the
machine with the card has no pandas. Semantics, each as mcport's:

- **reading** (``read_csv_file``): if no header cell is (case- and
  space-insensitively) ``date``, the first ``header_scan_rows`` rows are
  scanned for one; the date column is the first named ``date``; the price
  column is the first, in file order, named one of ``price_priority``, else
  the first other column. Rows with an empty or NA date or price are dropped,
  thousands separators are stripped (``strip_thousands``), and rows whose date
  or price does not parse are dropped.
- **dates**: ``MM/DD/YYYY`` (investing.com), ``YYYY-MM-DD`` or ``YYYY/MM/DD``
  (a time of day after it is ignored), and ``Mon DD, YYYY`` — the formats
  ``pandas.to_datetime(format="mixed")`` reads month-first. A date in another
  format is dropped where pandas might have parsed it.
- **combining**: names made unique with a " (k)" suffix; the assets'
  histories inner-joined on date (a date that repeats within one file is
  refused, as pandas' join refuses it) and sorted; then pandas'
  ``resample(rule).last().dropna()``: each date falls in the bin of the first
  period end on or after it (``ME`` month end, ``QE`` quarter end, ``W``
  Sunday, ``D`` the day), and a bin keeps the row of its latest date.
- **returns**: ``stats_rets`` is ``pct_change().dropna()``, ``port_rets``
  ``pct_change().fillna(0)`` with its leading zero row; ``mean_ann`` and
  ``cov_ann`` are the mean and the ddof=1 covariance of ``port_rets`` times the
  period's annualisation factor.

``tests/test_torch_data.py`` holds the result to mcport's on the fixtures.
"""

from __future__ import annotations

import csv
import datetime as _dt
import re
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from mcport_torch.config import DataConfig, period_info

__all__ = ["PriceData", "read_csv_file", "dedupe_names", "combine_prices",
           "load_universe"]

# pandas.read_csv's default NA strings
_NA = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN",
                 "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN",
                 "None", "n/a", "nan", "null"})
_MDY = re.compile(r"^(\d{1,2})/(\d{1,2})/(\d{4})$")
_YMD = re.compile(r"^(\d{4})[-/](\d{1,2})[-/](\d{1,2})(?:[T ].*)?$")


@dataclass(frozen=True)
class PriceData:
    """The universe the engines read; mcport's field names."""

    names: tuple[str, ...]
    prices: np.ndarray            # (T, A) resampled prices
    stats_rets: np.ndarray        # (T-1, A) pct_change().dropna()
    port_rets: np.ndarray         # (T, A) pct_change().fillna(0)
    mean_ann: np.ndarray          # (A,)  annualised mean of port_rets
    cov_ann: np.ndarray           # (A, A) annualised ddof=1 cov of port_rets
    ann_factor: int
    resample_rule: str

    @property
    def n_assets(self) -> int:
        return len(self.names)


def _norm(cell: object) -> str:
    return str(cell).strip().lower()


def _parse_date(s: str) -> _dt.date | None:
    s = s.strip()
    try:
        if m := _MDY.match(s):
            return _dt.date(int(m[3]), int(m[1]), int(m[2]))
        if m := _YMD.match(s):
            return _dt.date(int(m[1]), int(m[2]), int(m[3]))
        return _dt.datetime.strptime(s, "%b %d, %Y").date()
    except ValueError:
        return None


def _parse_price(s: str, strip_thousands: bool) -> float | None:
    if strip_thousands:
        s = s.replace(",", "")
    try:
        x = float(s)
    except ValueError:
        return None
    return None if x != x else x


def read_csv_file(path: str | Path,
                  config: DataConfig = DataConfig()) -> tuple[list[_dt.date], np.ndarray]:
    """One price CSV → (dates in file order, float64 prices). Raises
    ``ValueError`` where mcport raises ``CsvFormatError``."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        raise ValueError(f"{path}: empty file")
    if any(_norm(c) == "date" for c in rows[0]):
        header_idx = 0
    else:
        header_idx = next((i for i in range(min(config.header_scan_rows, len(rows)))
                           if any(_norm(c) == "date" for c in rows[i])), None)
        if header_idx is None:
            raise ValueError(f"{path}: no header row with a 'date' column")
    header, body = rows[header_idx], rows[header_idx + 1:]
    date_col = next(i for i, c in enumerate(header) if _norm(c) == "date")
    prices = [i for i, c in enumerate(header) if _norm(c) in config.price_priority]
    if not prices:
        prices = [i for i in range(len(header)) if i != date_col]
    if not prices:
        raise ValueError(f"{path}: no price column")
    price_col = prices[0]

    def cell(row, i):
        return row[i] if i < len(row) else ""

    kept = [(cell(r, date_col), cell(r, price_col)) for r in body
            if cell(r, date_col) not in _NA and cell(r, price_col) not in _NA]
    if not kept:
        raise ValueError(f"{path}: no row has both a date and a price")
    dates, values = [], []
    for d, p in kept:
        day, x = _parse_date(d), _parse_price(p, config.strip_thousands)
        if day is not None and x is not None:
            dates.append(day)
            values.append(x)
    if not dates:
        raise ValueError(f"{path}: no row has a parseable date and price")
    return dates, np.asarray(values, np.float64)


def dedupe_names(names: Iterable[str]) -> list[str]:
    """Make duplicate asset names unique with a " (k)" suffix."""
    counter: Counter[str] = Counter()
    out = []
    for base in names:
        counter[base] += 1
        out.append(base if counter[base] == 1 else f"{base} ({counter[base]})")
    return out


def _period_end(day: _dt.date, rule: str) -> _dt.date:
    """Label of the resample bin holding ``day``: the first period end on or
    after it."""
    if rule == "D":
        return day
    if rule == "W":                                   # W-SUN
        return day + _dt.timedelta(days=6 - day.weekday())
    if rule == "ME":
        month_end = day.month
    elif rule == "QE":                                # QE-DEC
        month_end = -(-day.month // 3) * 3
    else:
        raise ValueError(f"unknown resample rule {rule!r}")
    first_of_next = (_dt.date(day.year + 1, 1, 1) if month_end == 12
                     else _dt.date(day.year, month_end + 1, 1))
    return first_of_next - _dt.timedelta(days=1)


def combine_prices(series: Sequence[tuple[list[_dt.date], np.ndarray]],
                   resample_rule: str = "ME") -> np.ndarray:
    """Inner-join per-asset (dates, prices) on date, sort, and keep the last
    row of each non-empty resample bin → (T, A) float64."""
    tables = []
    for dates, values in series:
        table = dict(zip(dates, values))
        if len(table) != len(dates):
            raise ValueError("a price history repeats a date; the histories "
                             "cannot be joined on date")
        tables.append(table)
    common = sorted(set(tables[0]).intersection(*tables[1:]))
    last: dict[_dt.date, _dt.date] = {}
    for day in common:                                # ascending: the last wins
        last[_period_end(day, resample_rule)] = day
    rows = [last[label] for label in sorted(last)]
    if not rows:
        raise ValueError(
            "inner join of asset histories is empty after resampling - "
            "the assets share no common dates (check mixed daily/weekly files)")
    return np.array([[t[day] for t in tables] for day in rows], np.float64)


def load_universe(paths: Sequence[str | Path],
                  config: DataConfig = DataConfig()) -> PriceData:
    """Load price CSVs, join, resample and compute returns and moments. An
    asset's name is its file name up to the first '.'."""
    if not paths:
        raise ValueError("no price data provided")
    named = [(Path(p).name.split(".")[0], read_csv_file(p, config)) for p in paths]
    rule, ann = period_info(config.period)
    prices = combine_prices([s for _, s in named], rule)
    pct = prices[1:] / prices[:-1] - 1.0
    stats_rets = pct[~np.isnan(pct).any(axis=1)]
    port_rets = np.concatenate([np.zeros((1, prices.shape[1])), np.nan_to_num(
        pct, nan=0.0, posinf=np.inf, neginf=-np.inf)])
    mean = port_rets.mean(axis=0)
    centred = port_rets - mean
    with np.errstate(divide="ignore", invalid="ignore"):   # one row: NaN, as pandas
        cov = centred.T @ centred / (port_rets.shape[0] - 1)
    mean_ann, cov_ann = mean * ann, cov * ann
    return PriceData(
        names=tuple(dedupe_names([n for n, _ in named])),
        prices=prices,
        stats_rets=stats_rets,
        port_rets=port_rets,
        mean_ann=mean_ann,
        cov_ann=cov_ann,
        ann_factor=ann,
        resample_rule=rule,
    )
