"""Option legs, payoffs, strategies and hedged settlement: the port of
``mcport/options`` (``american.py`` is not ported yet)."""

from mcport_torch.options.hedged import (
    HedgeSpec,
    auto_hedged_sketch,
    hedged_from_simple,
    hedged_return_bounds,
    hedged_step_returns,
    hedged_terminal_returns,
    legs_from_spec,
)
from mcport_torch.options.legs import (
    PERSIAN_NAMES,
    Legs,
    LegType,
    leg_period_return,
    parse_leg_type,
    position_return_series,
)
from mcport_torch.options.payoff import (
    calculate_breakeven,
    calculate_payoff,
    price_grid,
    profit_loss_percent,
)
from mcport_torch.options.strategies import STRATEGIES, strategy_legs

__all__ = [
    "Legs", "LegType", "PERSIAN_NAMES", "parse_leg_type", "leg_period_return",
    "position_return_series", "price_grid", "calculate_payoff", "calculate_breakeven",
    "profit_loss_percent", "STRATEGIES", "strategy_legs", "HedgeSpec", "legs_from_spec",
    "hedged_terminal_returns", "hedged_from_simple", "hedged_step_returns",
    "hedged_return_bounds", "auto_hedged_sketch",
]
