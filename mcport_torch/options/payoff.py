"""Terminal payoff curves, breakeven and P/L% (``app.py:195-229``).

Port of ``mcport/options/payoff.py``, with its parity notes:

* premiums are quoted as a fraction of the purchase price — every payoff
  branch scales ``premium * purchase_price`` (``app.py:206-212``), and the
  total premium sums ``qty * premium * purchase_price`` over the legs with a
  nonzero premium (``app.py:197``);
* the total premium is subtracted from every grid point (``app.py:215``),
  which counts premiums twice beside the per-leg terms: the reference's
  behaviour, kept;
* breakeven uses the reference's first-leg heuristic (``app.py:218-225``).
"""

from __future__ import annotations

import torch

from mcport_torch.config import PayoffConfig
from mcport_torch.options.legs import Legs, LegType

__all__ = ["price_grid", "total_premium", "calculate_payoff", "calculate_breakeven",
           "profit_loss_percent"]


def price_grid(current_price: float, config: PayoffConfig = PayoffConfig(),
               dtype=torch.float64) -> torch.Tensor:
    """The payoff grid: ``n_points`` prices over 0.5x-1.5x spot (``app.py:593``)."""
    return torch.linspace(current_price * config.lo_mult, current_price * config.hi_mult,
                          config.n_points, dtype=dtype)


def total_premium(legs: Legs, purchase_price: float, dtype=torch.float64) -> torch.Tensor:
    """``Σ qty · premium · purchase_price`` over legs with premium != 0 (``app.py:197``)."""
    prem = torch.as_tensor(legs.premium, dtype=dtype)
    qty = torch.as_tensor(legs.qty, dtype=dtype)
    return torch.sum(torch.where(prem != 0, qty * prem * purchase_price,
                                 torch.zeros((), dtype=dtype)))


def calculate_payoff(legs: Legs, purchase_price: float, prices) -> torch.Tensor:
    """Terminal payoff of the position over a price grid (``app.py:195-216``),
    one (G, L) broadcast."""
    prices = torch.as_tensor(prices)
    if len(legs) == 0:
        return torch.zeros_like(prices)
    dt = prices.dtype
    p = prices[:, None]
    t_id = torch.as_tensor(legs.type_id)[None, :]
    k = torch.as_tensor(legs.strike, dtype=dt)[None, :]
    prem_scaled = torch.as_tensor(legs.premium, dtype=dt)[None, :] * purchase_price
    q = torch.as_tensor(legs.qty, dtype=dt)[None, :]
    zero = torch.zeros((), dtype=dt)
    call_iv = torch.maximum(p - k, zero)
    put_iv = torch.maximum(k - p, zero)
    branches = (p - purchase_price, purchase_price - p, call_iv - prem_scaled,
                prem_scaled - call_iv, put_iv - prem_scaled, prem_scaled - put_iv,
                purchase_price - p)
    per_leg = zero
    for i in reversed(range(7)):
        per_leg = torch.where(t_id == i, branches[i], per_leg)
    return torch.sum(q * per_leg, dim=1) - total_premium(legs, purchase_price, dt)


def calculate_breakeven(legs: Legs, purchase_price: float) -> float:
    """First-leg heuristic breakeven (``app.py:218-225``), on the host."""
    tp = float(total_premium(legs, purchase_price))
    for t, strike, _prem, qty in legs.rows():
        if t in (LegType.BUY_PUT, LegType.BUY_CALL):
            return strike + tp / qty if qty != 0 else purchase_price
        if t in (LegType.SELL_PUT, LegType.SELL_CALL):
            return strike - tp / qty if qty != 0 else purchase_price
    return purchase_price + tp


def profit_loss_percent(payoffs, purchase_price: float, qty_asset: float) -> torch.Tensor:
    """Payoff → percent of the invested capital (``app.py:227-229``)."""
    investment = purchase_price * qty_asset
    payoffs = torch.as_tensor(payoffs)
    if investment == 0:
        return torch.zeros_like(payoffs)
    return payoffs / investment * 100.0
