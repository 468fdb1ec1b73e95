"""The port's ``options`` package (``mcport_torch.options``) against mcport's
on identical float64 inputs, to 1e-12: the leg model and its Persian names,
the reference's seven strategies and their defaults, the payoff curves and
breakevens, and hedged settlement — ``HedgeSpec.build`` arrays and digest
bytes byte for byte, ``legs_from_spec`` on mcport's JSON example, the
terminal and per-step compositions, the exact PWL return bounds and the
covering hedged sketch. mcport is called with explicit float64 inputs
(``tests/conftest.py`` turns on x64).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcport.config import PayoffConfig as RefPayoffConfig
from mcport.models.gbm import GBMParams as RefParams
from mcport.options import hedged as ref_hedged
from mcport.options import legs as ref_legs
from mcport.options import payoff as ref_payoff
from mcport.options import strategies as ref_strategies
from mcport_torch.config import PayoffConfig
from mcport_torch.convert import from_mcport
from mcport_torch.options import hedged, legs, payoff, strategies

ATOL = 1e-12
NAMES = ["BTC", "ETH", "SOL"]
SPOTS = np.array([30_000.0, 2_000.0, 25.0])


def _np(x) -> np.ndarray:
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, np.float64)


def _same_legs(a, b) -> bool:
    return (np.array_equal(a.type_id, b.type_id) and a.type_id.dtype == b.type_id.dtype
            and all(np.array_equal(getattr(a, f), getattr(b, f))
                    for f in ("strike", "premium", "qty")))


@pytest.mark.parametrize("name", list(ref_legs.PERSIAN_NAMES.values()))
def test_persian_leg_names_parse_as_mcport(name):
    assert int(legs.parse_leg_type(name)) == int(ref_legs.parse_leg_type(name))
    t = legs.parse_leg_type(name)
    assert legs.PERSIAN_NAMES[t] == name and legs.parse_leg_type(t.name) is t
    assert legs.parse_leg_type(int(t)) is t


def test_leg_rows_roundtrip_as_mcport():
    rows = [("BUY_ASSET", 0.0, 0.0, 1.0), ("خرید پوت", 95.0, 1.5, 2.0), (3, 110.0, 0.7, 1.0)]
    mine, ref = legs.Legs.from_rows(rows), ref_legs.Legs.from_rows(rows)
    assert _same_legs(mine, ref) and len(mine) == 3
    assert [(int(t), k, p, q) for t, k, p, q in mine.rows()] == \
        [(int(t), k, p, q) for t, k, p, q in ref.rows()]
    assert _same_legs(legs.Legs.from_rows([]), ref_legs.Legs.from_rows([]))


@pytest.mark.parametrize("t", range(8))
def test_leg_period_return_matches_mcport(t):
    rng = np.random.default_rng(t)
    price, prev = rng.uniform(50, 150, 200), rng.uniform(50, 150, 200)
    prev[:5] = 0.0
    got = legs.leg_period_return(t, torch.as_tensor(price), torch.as_tensor(prev), 100.0, 2.5)
    want = ref_legs.leg_period_return(jnp.asarray(t), jnp.asarray(price), jnp.asarray(prev),
                                      jnp.asarray(100.0), jnp.asarray(2.5))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)


def test_position_return_series_matches_mcport():
    prices = np.random.default_rng(1).uniform(80, 120, 60)
    rows = [("BUY_ASSET", 0, 0, 1), ("BUY_PUT", 95, 1.0, 1), ("SELL_CALL", 110, 0.5, 2)]
    got = legs.position_return_series(legs.Legs.from_rows(rows), torch.as_tensor(prices))
    want = ref_legs.position_return_series(ref_legs.Legs.from_rows(rows), jnp.asarray(prices))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)
    empty = legs.position_return_series(legs.Legs.from_rows([]), torch.as_tensor(prices))
    assert float(empty.abs().max()) == 0.0


@pytest.mark.parametrize("name", list(ref_strategies.STRATEGIES))
@pytest.mark.parametrize("kwargs", [{}, {"qty_contract": 3.0}])
def test_strategies_expand_as_mcport(name, kwargs):
    assert list(strategies.STRATEGIES) == list(ref_strategies.STRATEGIES)
    assert _same_legs(strategies.strategy_legs(name, 100.0, **kwargs),
                      ref_strategies.strategy_legs(name, 100.0, **kwargs))


def test_strategy_edges_match_mcport():
    assert len(strategies.strategy_legs("-", 100.0)) == 0
    with pytest.raises(ValueError, match="unknown strategy"):
        strategies.strategy_legs("Iron Condor", 100.0)


@pytest.mark.parametrize("name", list(ref_strategies.STRATEGIES))
def test_payoff_and_breakeven_match_mcport(name):
    kw = {"Married Put": {"premium_put": 0.02}, "Protective Put": {"premium_put": 0.02},
          "Collar": {"premium_put": 0.02, "premium_call": 0.01},
          "Bear Put Spread": {"premium_put_high": 0.03}}.get(name, {"premium_call": 0.01})
    mine = strategies.strategy_legs(name, 100.0, **kw)
    ref = ref_strategies.strategy_legs(name, 100.0, **kw)
    grid = payoff.price_grid(100.0, PayoffConfig())
    ref_grid = ref_payoff.price_grid(100.0, RefPayoffConfig())
    np.testing.assert_allclose(_np(grid), np.asarray(ref_grid), rtol=0, atol=ATOL)
    got = payoff.calculate_payoff(mine, 100.0, grid)
    want = ref_payoff.calculate_payoff(ref, 100.0, jnp.asarray(_np(grid)))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-9)
    assert abs(payoff.calculate_breakeven(mine, 100.0)
               - ref_payoff.calculate_breakeven(ref, 100.0)) <= ATOL
    np.testing.assert_allclose(_np(payoff.profit_loss_percent(got, 100.0, 2.0)),
                               np.asarray(ref_payoff.profit_loss_percent(want, 100.0, 2.0)),
                               rtol=0, atol=1e-9)


def test_payoff_config_defaults_match_mcport():
    assert PayoffConfig() == PayoffConfig(**vars(RefPayoffConfig()))


# ---- hedged settlement -------------------------------------------------------------

SPEC_JSON = {"BTC": {"strategy": "Married Put", "params": {"premium_put": 1.5}},
             "ETH": {"legs": [["BUY_ASSET", 0, 0, 1], ["BUY_PUT", 2500, 20, 1]]}}


@pytest.fixture(scope="module")
def specs():
    mine = hedged.HedgeSpec.build(hedged.legs_from_spec(SPEC_JSON, NAMES, SPOTS), NAMES)
    ref = ref_hedged.HedgeSpec.build(ref_hedged.legs_from_spec(SPEC_JSON, NAMES, SPOTS),
                                     NAMES)
    return mine, ref


def test_legs_from_spec_matches_mcport_example():
    mine = hedged.legs_from_spec(json.loads(json.dumps(SPEC_JSON)), NAMES, SPOTS)
    ref = ref_hedged.legs_from_spec(SPEC_JSON, NAMES, SPOTS)
    assert mine.keys() == ref.keys() and all(_same_legs(mine[k], ref[k]) for k in mine)
    with pytest.raises(ValueError, match="not in the universe"):
        hedged.legs_from_spec({"DOGE": {"strategy": "Collar"}}, NAMES, SPOTS)
    with pytest.raises(ValueError, match="needs 'strategy' or 'legs'"):
        hedged.legs_from_spec({"BTC": {}}, NAMES, SPOTS)


def test_hedge_spec_arrays_and_digest_match_mcport(specs):
    mine, ref = specs
    for f in ("type_id", "strike", "premium", "qty", "hedged_mask"):
        a, b = getattr(mine, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert mine.digest_bytes() == ref.digest_bytes()
    t, k, p, q = mine.tensors("cpu")
    assert t.dtype == torch.int32 and k.dtype == torch.float32
    assert np.array_equal(t.numpy(), ref.type_id)
    np.testing.assert_array_equal(q.numpy(), ref.qty.astype(np.float32))


def test_hedge_spec_build_validates_as_mcport():
    with pytest.raises(ValueError, match="not in the universe"):
        hedged.HedgeSpec.build({"XRP": []}, NAMES)
    with pytest.raises(ValueError, match="out of range"):
        hedged.HedgeSpec.build({5: []}, NAMES)
    by_index = hedged.HedgeSpec.build({1: [("SELL_CALL", 2200, 10, 1)]}, NAMES)
    ref = ref_hedged.HedgeSpec.build({1: [("SELL_CALL", 2200, 10, 1)]}, NAMES)
    assert by_index.digest_bytes() == ref.digest_bytes()
    assert np.array_equal(by_index.hedged_mask, ref.hedged_mask)


@pytest.mark.parametrize("fn", ["hedged_terminal_returns", "hedged_from_simple"])
def test_terminal_compositions_match_mcport(specs, fn):
    mine, ref = specs
    x = np.random.default_rng(3).normal(0.0, 0.3, (500, 3))
    got = getattr(hedged, fn)(torch.as_tensor(x), SPOTS, *mine.tensors("cpu", torch.float64))
    want = getattr(ref_hedged, fn)(jnp.asarray(x), jnp.asarray(SPOTS), *ref.arrays)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)


def test_step_returns_match_mcport(specs):
    mine, ref = specs
    rng = np.random.default_rng(4)
    prev = SPOTS * np.exp(rng.normal(0, 0.2, (300, 3)))
    cur = prev * np.exp(rng.normal(0, 0.05, (300, 3)))
    got = hedged.hedged_step_returns(torch.as_tensor(prev), torch.as_tensor(cur),
                                     *mine.tensors("cpu", torch.float64))
    want = ref_hedged.hedged_step_returns(jnp.asarray(prev), jnp.asarray(cur), *ref.arrays)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("lo, hi", [(0.5, 2.0), (0.99, 1.01), (1.5, 3.0)])
def test_return_bounds_match_mcport(specs, lo, hi):
    """Intervals that hold every strike, none, or only some; the extrema sit
    at the ends or at an interior kink."""
    mine, ref = specs
    got = hedged.hedged_return_bounds(mine, SPOTS * lo, SPOTS * hi, SPOTS)
    want = ref_hedged.hedged_return_bounds(ref, SPOTS * lo, SPOTS * hi, SPOTS)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    assert (got[0] <= got[1]).all()


@pytest.mark.parametrize("weights", [None, np.array([0.5, 0.3, 0.2])])
@pytest.mark.parametrize("t_dof", [None, 5.0])
def test_auto_hedged_sketch_matches_mcport(specs, weights, t_dof):
    mine, ref = specs
    ref_params = RefParams(s0=SPOTS, mean_step=np.array([1e-3, 5e-4, 2e-3]),
                           chol_step=np.linalg.cholesky(4e-4 * (0.5 * np.eye(3) + 0.5)))
    got = hedged.auto_hedged_sketch(from_mcport(ref_params), 52, mine, weights=weights,
                                    t_dof=t_dof)
    want = ref_hedged.auto_hedged_sketch(ref_params, 52, ref, weights=weights, t_dof=t_dof)
    assert got.space == want.space == "linear" and got.n_bins == want.n_bins
    assert abs(got.lo - want.lo) <= 1e-12 * max(1.0, abs(want.lo))
    assert abs(got.hi - want.hi) <= 1e-12 * max(1.0, abs(want.hi))
