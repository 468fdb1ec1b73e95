"""The 7 named hedging strategies (app.py:507-581): a copy of
``mcport/options/strategies.py``.

Each constructor expands a strategy into its leg list exactly as the reference's
tab-1 UI does, with the same defaults: put strikes default to 0.9x spot, call
strikes to 1.1x spot, premiums to 0, contract quantities to 1 (app.py:515-581).
Strategy names match the reference selectbox (app.py:507-510).
"""

from __future__ import annotations

from typing import Callable

from mcport_torch.options.legs import Legs, LegType

__all__ = ["STRATEGIES", "strategy_legs", "married_put", "protective_put", "covered_call",
           "collar", "bear_put_spread", "synthetic_put", "long_straddle"]


def married_put(
    spot: float,
    qty_asset: float = 1.0,
    strike_put: float | None = None,
    premium_put: float = 0.0,
    qty_contract: float = 1.0,
) -> Legs:
    """Buy asset + buy put (app.py:515-524). Default put strike 0.9x spot."""
    strike_put = spot * 0.9 if strike_put is None else strike_put
    return Legs.from_rows([
        (LegType.BUY_ASSET, 0.0, 0.0, qty_asset),
        (LegType.BUY_PUT, strike_put, premium_put, qty_contract),
    ])


# 'Married Put' and 'Protective Put' expand identically in the reference
# (same branch, app.py:515).
protective_put = married_put


def covered_call(
    spot: float,
    qty_asset: float = 1.0,
    strike_call: float | None = None,
    premium_call: float = 0.0,
    qty_contract: float = 1.0,
) -> Legs:
    """Sell call only — the reference does NOT add the underlying leg here
    (app.py:525-533)."""
    strike_call = spot * 1.1 if strike_call is None else strike_call
    return Legs.from_rows([(LegType.SELL_CALL, strike_call, premium_call, qty_contract)])


def collar(
    spot: float,
    qty_asset: float = 1.0,
    strike_put: float | None = None,
    premium_put: float = 0.0,
    strike_call: float | None = None,
    premium_call: float = 0.0,
    qty_contract: float = 1.0,
) -> Legs:
    """Buy put + sell call, shared contract qty (app.py:534-546)."""
    strike_put = spot * 0.9 if strike_put is None else strike_put
    strike_call = spot * 1.1 if strike_call is None else strike_call
    return Legs.from_rows([
        (LegType.BUY_PUT, strike_put, premium_put, qty_contract),
        (LegType.SELL_CALL, strike_call, premium_call, qty_contract),
    ])


def bear_put_spread(
    spot: float,
    qty_asset: float = 1.0,
    strike_put_high: float | None = None,
    premium_put_high: float = 0.0,
    strike_put_low: float | None = None,
    premium_put_low: float = 0.0,
    qty_contract: float = 1.0,
) -> Legs:
    """Buy high-strike put + sell low-strike put (app.py:547-559).
    Defaults: high strike = spot, low strike = 0.9x spot."""
    strike_put_high = spot if strike_put_high is None else strike_put_high
    strike_put_low = spot * 0.9 if strike_put_low is None else strike_put_low
    return Legs.from_rows([
        (LegType.BUY_PUT, strike_put_high, premium_put_high, qty_contract),
        (LegType.SELL_PUT, strike_put_low, premium_put_low, qty_contract),
    ])


def synthetic_put(
    spot: float,
    qty_asset: float = 1.0,
    strike_call: float | None = None,
    premium_call: float = 0.0,
    qty_contract: float = 1.0,
) -> Legs:
    """Sell futures + buy call (app.py:560-568). Default call strike = spot."""
    strike_call = spot if strike_call is None else strike_call
    return Legs.from_rows([
        (LegType.SELL_FUTURES, 0.0, 0.0, qty_asset),
        (LegType.BUY_CALL, strike_call, premium_call, qty_contract),
    ])


def long_straddle(
    spot: float,
    qty_asset: float = 1.0,
    strike_call: float | None = None,
    premium_call: float = 0.0,
    strike_put: float | None = None,
    premium_put: float = 0.0,
    qty_contract: float = 1.0,
) -> Legs:
    """Buy call + buy put, both defaulting to at-the-money (app.py:569-581).
    A strangle is the same constructor with different strikes."""
    strike_call = spot if strike_call is None else strike_call
    strike_put = spot if strike_put is None else strike_put
    return Legs.from_rows([
        (LegType.BUY_CALL, strike_call, premium_call, qty_contract),
        (LegType.BUY_PUT, strike_put, premium_put, qty_contract),
    ])


# Reference selectbox labels (app.py:507-510) → constructors.
STRATEGIES: dict[str, Callable[..., Legs]] = {
    "Married Put": married_put,
    "Protective Put": protective_put,
    "Covered Call": covered_call,
    "Collar": collar,
    "Bear Put Spread": bear_put_spread,
    "Synthetic Put": synthetic_put,
    "Long Straddle/Strangle": long_straddle,
}


def strategy_legs(name: str, spot: float, **kwargs) -> Legs:
    """Expand a strategy by its reference selectbox name."""
    if name in ("-", "", None):
        return Legs.from_rows([])
    try:
        ctor = STRATEGIES[name]
    except KeyError:
        raise ValueError(f"unknown strategy {name!r}; expected one of {list(STRATEGIES)}") from None
    return ctor(spot, **kwargs)
