"""Option legs: the position model of the reference app (``app.py:164-193``).

Port of ``mcport/options/legs.py``. A leg is ``(type, strike, premium, qty)``;
the type is one of seven, named in English or by the reference's Persian
labels (:data:`PERSIAN_NAMES`). A position of several legs is a :class:`Legs`
struct of NumPy arrays (host data, as in mcport), and its per-period return
over a price series is one broadcast over (periods, legs) in torch.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

__all__ = ["LegType", "PERSIAN_NAMES", "Legs", "parse_leg_type", "leg_period_return",
           "position_return_series"]


class LegType(enum.IntEnum):
    """The seven leg types of ``app.py:164-180``."""

    BUY_ASSET = 0      # خرید دارایی
    SELL_ASSET = 1     # فروش دارایی
    BUY_CALL = 2       # خرید کال
    SELL_CALL = 3      # فروش کال
    BUY_PUT = 4        # خرید پوت
    SELL_PUT = 5       # فروش پوت
    SELL_FUTURES = 6   # فروش فیوچرز


PERSIAN_NAMES = {
    LegType.BUY_ASSET: "خرید دارایی",
    LegType.SELL_ASSET: "فروش دارایی",
    LegType.BUY_CALL: "خرید کال",
    LegType.SELL_CALL: "فروش کال",
    LegType.BUY_PUT: "خرید پوت",
    LegType.SELL_PUT: "فروش پوت",
    LegType.SELL_FUTURES: "فروش فیوچرز",
}
_FROM_PERSIAN = {v: k for k, v in PERSIAN_NAMES.items()}


def parse_leg_type(value: "LegType | str | int") -> LegType:
    """A :class:`LegType` from itself, its name, its Persian label or its id."""
    if isinstance(value, LegType):
        return value
    if isinstance(value, int):
        return LegType(value)
    if value in _FROM_PERSIAN:
        return _FROM_PERSIAN[value]
    return LegType[value.upper()]


@dataclass(frozen=True)
class Legs:
    """A multi-leg position as a struct of arrays: ``type_id`` (L,) int32,
    ``strike``, ``premium`` and ``qty`` (L,) float64."""

    type_id: np.ndarray
    strike: np.ndarray
    premium: np.ndarray
    qty: np.ndarray

    @classmethod
    def from_rows(cls, rows: Sequence[tuple]) -> "Legs":
        """From reference-style rows ``[(type, strike, premium, qty), ...]``."""
        if not rows:
            return cls(np.zeros(0, np.int32), np.zeros(0), np.zeros(0), np.zeros(0))
        t, k, p, q = zip(*rows)
        return cls(np.array([int(parse_leg_type(x)) for x in t], np.int32),
                   np.asarray(k, np.float64), np.asarray(p, np.float64),
                   np.asarray(q, np.float64))

    def rows(self) -> list[tuple]:
        return [(LegType(int(t)), float(k), float(p), float(q))
                for t, k, p, q in zip(self.type_id, self.strike, self.premium, self.qty)]

    def __len__(self) -> int:
        return len(self.type_id)


def _as(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def leg_period_return(type_id, price: torch.Tensor, prev_price: torch.Tensor, strike,
                      premium) -> torch.Tensor:
    """One leg's return over a price move ``prev_price → price``
    (``app.py:164-180``): intrinsic value minus (or plus) the premium, over the
    previous price; 0 where the previous price is 0 and for an unknown type.
    Broadcasts over any leading shape."""
    price = torch.as_tensor(price)
    prev_price = _as(prev_price, price)
    strike, premium = _as(strike, price), _as(premium, price)
    t = torch.as_tensor(type_id, device=price.device)
    zero = torch.zeros((), dtype=price.dtype, device=price.device)
    call_iv = torch.maximum(price - strike, zero)
    put_iv = torch.maximum(strike - price, zero)
    up = price - prev_price
    branches = (up, -up, call_iv - premium, premium - call_iv, put_iv - premium,
                premium - put_iv, -up)
    numer = zero
    for k in reversed(range(7)):
        numer = torch.where(t == k, branches[k], numer)
    safe_prev = torch.where(prev_price == 0, torch.ones_like(prev_price), prev_price)
    return torch.where(prev_price == 0, zero, numer / safe_prev)


def position_return_series(legs: Legs, prices) -> torch.Tensor:
    """``calc_options_series`` (``app.py:182-193``) as one broadcast: the
    per-period return of the qty-weighted position over prices (T,),
    ``ret[t] = Σ_l qty_l · leg_return(l, p_t, p_{t-1})``, ``ret[0] = 0``."""
    prices = torch.as_tensor(prices)
    if len(legs) == 0:
        return torch.zeros_like(prices)
    p, pp = prices[1:, None], prices[:-1, None]
    per_leg = leg_period_return(torch.as_tensor(legs.type_id)[None, :], p, pp,
                                _as(legs.strike, prices)[None, :],
                                _as(legs.premium, prices)[None, :])
    rets = torch.sum(_as(legs.qty, prices)[None, :] * per_leg, dim=1)
    return torch.cat([torch.zeros((1,), dtype=prices.dtype, device=prices.device), rets])
