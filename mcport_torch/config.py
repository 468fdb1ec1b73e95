"""Configuration of the port: the fields of ``mcport/config.py`` it reads.

A copy, not an import: the port imports nothing of :mod:`mcport`. Each
dataclass keeps mcport's field names and defaults for the fields the port
reads (``tests/test_torch_data.py`` holds every default to mcport's), so a
``Config`` written for one package configures the other. Fields the port does
not read are left out: mcport's ``GBMConfig.dt`` and ``use_pallas`` (the port
always runs its kernels on a card and their plain forms on the CPU), and the
portfolio, mesh and forecast sections. ``PayoffConfig`` is the payoff grid of
:mod:`mcport_torch.options.payoff`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

__all__ = ["period_info", "DataConfig", "SimulationConfig", "GBMConfig",
           "SketchConfig", "COVERING_LOG1P_SKETCH", "PayoffConfig", "Config"]

# period code -> (pandas-3 resample rule, annualisation factor); 'M' and 'Q'
# also accept their pandas-3 spellings
_PERIOD_TABLE = {
    "M": ("ME", 12),
    "ME": ("ME", 12),
    "Q": ("QE", 4),
    "QE": ("QE", 4),
    "W": ("W", 52),
    "D": ("D", 252),
}


def period_info(period: str) -> tuple[str, int]:
    """Map a period code to (resample rule, annualisation factor)."""
    try:
        return _PERIOD_TABLE[period.upper()]
    except KeyError:
        raise ValueError(
            f"unknown period {period!r}; expected one of {sorted(_PERIOD_TABLE)}"
        ) from None


@dataclass(frozen=True)
class DataConfig:
    """CSV ingestion and the returns pipeline (:mod:`mcport_torch.data`)."""

    period: str = "M"                  # resample period code (M/Q/W/D)
    strip_thousands: bool = True       # "86,493.0" -> 86493.0
    price_priority: tuple[str, ...] = ("price", "close", "adj close", "open")
    header_scan_rows: int = 5          # header-sniff window

    @property
    def resample_rule(self) -> str:
        return period_info(self.period)[0]

    @property
    def annual_factor(self) -> int:
        return period_info(self.period)[1]


@dataclass(frozen=True)
class SimulationConfig:
    """Tail level of the risk reports."""

    alpha: float = 0.95                # VaR/CVaR confidence


@dataclass(frozen=True)
class GBMConfig:
    """Correlated-GBM path engine."""

    n_paths: int = 131_072             # divisible by the default path_block
    n_steps: int = 252
    seed: int = 0
    antithetic: bool = False
    qmc: str = "none"                  # none | sobol | halton (not ported: raises)
    dtype: str = "float32"             # accumulator type of the engines
    path_block: int = 8_192            # paths per engine block
    auto_sketch: bool = True           # derive the terminal sketch from the params
    innovations: str = "normal"        # "normal" | "student_t"
    t_dof: float = 6.0                 # Student-t degrees of freedom
    ci_boot: int = 0                   # bootstrap error bars (not ported: > 0 raises)
    bm: str = "poly"                   # normal tier: "poly" | "poly_fast"


@dataclass(frozen=True)
class SketchConfig:
    """Histogram sketch: ``n_bins`` bins over [lo, hi] in ``space``
    coordinates ("linear" returns or "log1p" u = log1p(r))."""

    n_bins: int = 8_192
    lo: float = -1.0
    hi: float = 3.0
    space: str = "linear"


# A generous covering log1p sketch for engines without an analytic range
# (the GARCH terminals): -99.99% .. +100000% simple return at relative
# resolution. mcport's definition; the CLI and the API share it.
COVERING_LOG1P_SKETCH = SketchConfig(
    n_bins=8_192,
    lo=math.log1p(-0.9999),
    hi=math.log1p(1000.0),
    space="log1p",
)


@dataclass(frozen=True)
class PayoffConfig:
    """Payoff-curve grid (app.py:593)."""

    n_points: int = 100
    lo_mult: float = 0.5
    hi_mult: float = 1.5


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    simulation: SimulationConfig = field(default_factory=SimulationConfig)
    gbm: GBMConfig = field(default_factory=GBMConfig)
    sketch: SketchConfig = field(default_factory=SketchConfig)
