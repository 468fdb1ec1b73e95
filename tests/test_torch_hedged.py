"""Hedged settlement on simulated paths: the port against mcport.

- The kernels' plain forms (``ops/hedged.py``): the hedged multi-dd and
  Merton paths against mcport's ``_lax_multi_dd_hedged`` and hedged
  ``merton_path_stats`` in law at matched path counts (terminal mean within 4
  standard errors, the drawdown quantile through mcport's empirical CDF); an
  identity hedge against the rebalanced mode on the same Philox counters
  within the tolerance helper; a married put lifting the drawdown floor; the
  per-path bound rejecting planted faults by more than 2x (a put settled as
  a call, a division by the new price, settlement in bfloat16, a dropped
  premium, a drawdown off by 1e-3) and holding increments moved by a sound
  kernel's rounding; overflowed wealth held path by path.
- Engines and API: hedged ``gbm_risk`` against mcport's in law, an identity
  hedge giving the unhedged report, the hedge binding the run digest, split
  + resume bit-identical (``run_resumable_mc`` and the path-risk driver),
  ``hedged_tail_risk`` for all seven families against mcport's in law, the
  hedged GBM and jump frontiers scoring as the plain scorer on one weight
  matrix, and hedged DCC through ``path_tail_risk`` and its frontier with
  mcport's keys.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcport.api import gbm_risk as ref_gbm_risk
from mcport.api import hedged_tail_risk as ref_hedged_tail
from mcport.config import Config as RefConfig
from mcport.config import DataConfig as RefDataConfig
from mcport.config import GBMConfig as RefGBMConfig
from mcport.data import load_universe as ref_load
from mcport.engine.drawdown_frontier import _lax_multi_dd_hedged
from mcport.models.gbm import GBMParams as RefParams
from mcport.models.jump import merton_path_stats as ref_merton_path_stats
from mcport.options import HedgeSpec as RefHedgeSpec
from mcport.options import LegType as RefLegType
from mcport.options import Legs as RefLegs
from mcport_torch.api import gbm_risk, hedged_tail_risk, path_tail_risk
from mcport_torch.config import Config, DataConfig, GBMConfig
from mcport_torch.convert import from_mcport, merton_params_from_numpy
from mcport_torch.data import load_universe
from mcport_torch.engine.drawdown_frontier import (drawdown_frontier_search,
                                                   family_drawdown_frontier_search,
                                                   frontier_seeds)
from mcport_torch.engine.mc_engine import run_resumable_mc
from mcport_torch.engine.path_risk import run_resumable_path_risk
from mcport_torch.ops import hedged as OH
from mcport_torch.ops.hedged import HedgeTensors, hedged_multi_dd
from mcport_torch.ops.jump import merton_multi_portfolio_dd
from mcport_torch.ops.gbm import step_shocks
from mcport_torch.ops.multi_dd import (gbm_multi_portfolio_dd, hedged_price_bound,
                                       multi_dd_reference, multi_dd_shares)
from mcport_torch.options import HedgeSpec
from mcport_torch.options.strategies import collar, married_put

torch.set_num_threads(1)   # the suite runs several xdist workers on shared cores

A = 4
NAMES = ["A0", "A1", "A2", "A3"]
S0 = np.array([100.0, 50.0, 20.0, 8.0])
_VOLS = np.array([0.02, 0.025, 0.015, 0.03])
CHOL = np.linalg.cholesky(_VOLS[:, None] * _VOLS[None, :] * (0.4 * np.eye(A) + 0.6))
MEAN = np.array([1e-3, 5e-4, 8e-4, 2e-3])
W = np.array([0.4, 0.3, 0.2, 0.1])
REF_PARAMS = RefParams(s0=S0, mean_step=MEAN, chol_step=CHOL)
PARAMS = from_mcport(REF_PARAMS)
ROWS = {0: [(RefLegType.BUY_ASSET, 0.0, 0.0, 1.0), (RefLegType.BUY_PUT, 95.0, 0.5, 1.0)],
        1: [(RefLegType.BUY_PUT, 45.0, 0.2, 1.0), (RefLegType.SELL_CALL, 56.0, 0.3, 1.0)]}
REF_SPEC = RefHedgeSpec.build({k: RefLegs.from_rows(v) for k, v in ROWS.items()}, NAMES)
SPEC = from_mcport(REF_SPEC)
HEDGE = HedgeTensors.from_spec(SPEC, S0, "cpu")
IDENTITY = HedgeSpec.build({i: [("BUY_ASSET", 0, 0, 1)] for i in range(A)}, NAMES)


def _f32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _ref_args(spec=REF_SPEC):
    return (jnp.asarray(S0, jnp.float32), *spec.arrays)


def _cdf_within(sample: np.ndarray, q: float, p: float, n_ref: int) -> bool:
    """The p-quantile ``q`` of one sample sits at p in the other's empirical
    CDF, within 4 binomial standard errors of both sample sizes."""
    f = float(np.mean(sample <= q))
    se = math.sqrt(p * (1 - p) / sample.size + p * (1 - p) / n_ref)
    return abs(f - p) <= 4 * se


# ---- the plain forms of the hedged kernel modes ----------------------------------------

@pytest.mark.parametrize("t_df", [None, 5.0])
def test_hedged_multi_dd_plain_form_matches_mcport_in_law(t_df):
    n, steps = 16_384, 16
    w = np.stack([W, np.full(A, 0.25)])
    term, dd = gbm_multi_portfolio_dd(3, _f32(MEAN), _f32(CHOL), _f32(w), n, steps,
                                      t_df=t_df, hedge=HEDGE)
    rterm, rdd = _lax_multi_dd_hedged(jax.random.key(3), jnp.asarray(MEAN, jnp.float32),
                                      jnp.asarray(CHOL, jnp.float32),
                                      jnp.asarray(w, jnp.float32), n, steps, jnp.float32,
                                      *_ref_args(), t_df=t_df)
    for c in range(2):
        t, rt = term[0, c].double().numpy(), np.asarray(rterm[c], np.float64)
        assert abs(t.mean() - rt.mean()) <= 4 * math.sqrt(t.var() / n + rt.var() / n)
        d, rd = dd[0, c].double().numpy(), np.asarray(rdd[c], np.float64)
        assert _cdf_within(rd, float(np.quantile(d, 0.05)), 0.05, n)
        assert _cdf_within(rd, float(np.quantile(d, 0.5)), 0.5, n)


def test_hedged_merton_plain_form_matches_mcport_in_law():
    n, steps, rate = 16_384, 16, 0.1
    muj, sigj = np.full(A, -0.04), np.full(A, 0.03)
    term, dd = merton_multi_portfolio_dd(5, _f32(MEAN), _f32(CHOL), rate, _f32(muj),
                                         _f32(sigj), _f32(W[None]), n, steps, hedge=HEDGE)
    rterm, rdd = ref_merton_path_stats(jax.random.key(5), jnp.asarray(MEAN, jnp.float32),
                                       jnp.asarray(CHOL, jnp.float32), rate,
                                       jnp.asarray(muj, jnp.float32),
                                       jnp.asarray(sigj, jnp.float32),
                                       jnp.asarray(W[None], jnp.float32), n, steps,
                                       hedge_args=_ref_args())
    t, rt = term[0, 0].double().numpy(), np.asarray(rterm[0], np.float64)
    assert abs(t.mean() - rt.mean()) <= 4 * math.sqrt(t.var() / n + rt.var() / n)
    d, rd = dd[0, 0].double().numpy(), np.asarray(rdd[0], np.float64)
    assert _cdf_within(rd, float(np.quantile(d, 0.05)), 0.05, n)


def test_identity_hedge_is_the_rebalanced_mode_on_the_same_counters():
    ident = HedgeTensors.from_spec(IDENTITY, S0, "cpu")
    w = _f32(np.random.default_rng(0).dirichlet(np.ones(A), 7))
    kw = dict(first_block=2, n_blocks=2)
    h = gbm_multi_portfolio_dd(9, _f32(MEAN), _f32(CHOL), w, 2_000, 52, hedge=ident, **kw)
    r = gbm_multi_portfolio_dd(9, _f32(MEAN), _f32(CHOL), w, 2_000, 52, rebalance=True, **kw)
    bound = multi_dd_reference(9, _f32(MEAN), _f32(CHOL), w, 2_000, 52, hedge=ident,
                               with_bound=True, **kw)[2]
    shares = multi_dd_shares(h, (*r, bound), None, _f32(CHOL), _f32(MEAN), 52, True, "float32",
                             ident)
    assert max(shares.values()) <= 1.0
    jh = merton_multi_portfolio_dd(9, _f32(MEAN), _f32(CHOL), 0.0, _f32(np.zeros(A)),
                                   _f32(np.zeros(A)), w, 2_000, 52, hedge=ident, **kw)
    assert all(torch.equal(x, y) for x, y in zip(jh, h))   # rate 0: kernel #3's path


def test_married_put_lifts_the_drawdown_floor():
    """Per-step zero-premium puts dominate the per-step returns below the
    strike, so the drawdown distribution improves in aggregate (mcport's
    test_dd_frontier_hedged_put_lifts_drawdown_floor)."""
    prot = HedgeTensors.from_spec(HedgeSpec.build(
        {i: [("BUY_ASSET", 0, 0, 1), ("BUY_PUT", 0.97 * S0[i], 0, 1)] for i in range(A)},
        NAMES), S0, "cpu")
    w = _f32(np.random.default_rng(1).dirichlet(np.ones(A), 64))
    _, dd_base = gbm_multi_portfolio_dd(4, _f32(MEAN), _f32(CHOL), w, 2_048, 26,
                                        rebalance=True)
    _, dd_prot = gbm_multi_portfolio_dd(4, _f32(MEAN), _f32(CHOL), w, 2_048, 26, hedge=prot)
    q_base = torch.quantile(dd_base[0], 0.05, dim=-1)
    q_prot = torch.quantile(dd_prot[0], 0.05, dim=-1)
    assert float(q_prot.mean()) > float(q_base.mean())
    assert float(q_prot.median()) > float(q_base.median())
    assert float(dd_prot.min()) >= float(dd_base.min())


def _put_as_call(p_prev, p_new, type_id, strike, premium, qty):
    swapped = torch.where(type_id == 4, torch.full_like(type_id, 2), type_id)
    return _right(p_prev, p_new, swapped, strike, premium, qty)


def _divide_by_new(p_prev, p_new, type_id, strike, premium, qty):
    return _right(p_prev, p_new, type_id, strike, premium, qty) * p_prev / p_new


def _bfloat16(p_prev, p_new, type_id, strike, premium, qty):
    return _right(p_prev, p_new, type_id, strike, premium, qty).bfloat16().float()


def _no_premium(p_prev, p_new, type_id, strike, premium, qty):
    return _right(p_prev, p_new, type_id, strike, torch.zeros_like(premium), qty)


_right = OH.hedged_returns_reference
# the smoke's bench hedge, a married put on asset 0 and a collar on asset 1 at
# the reference's default strikes, with a premium of 0.1% of the spot per
# option leg so that dropping it is a fault
BENCH = HedgeTensors.from_spec(HedgeSpec.build(
    {0: married_put(S0[0], premium_put=1e-3 * S0[0]),
     1: collar(S0[1], premium_put=1e-3 * S0[1], premium_call=1e-3 * S0[1])}, NAMES), S0, "cpu")
FAULTS = {"put settled as a call": (_put_as_call, None),
          "division by the new price": (_divide_by_new, None),
          "settled in bfloat16": (_bfloat16, None),
          "premium dropped": (_no_premium, None),
          "drawdown off by 1e-3": (None, lambda out: (out[0], out[1] - 1e-3))}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("steps", [16, 252])
def test_hedged_tolerance_rejects_planted_faults(monkeypatch, fault, steps):
    """The per-path bound (the plain form's ``with_bound``) rejects each
    planted fault by more than 2x on the bench hedge, at 16 and 252 steps."""
    settle, output = FAULTS[fault]
    w = _f32(np.random.default_rng(2).dirichlet(np.ones(A), 5))
    args = (6, _f32(MEAN), _f32(CHOL), w, 512, steps)
    kw = dict(first_block=1, n_blocks=1, hedge=BENCH)
    right = multi_dd_reference(*args, with_bound=True, **kw)
    assert max(multi_dd_shares(right, right, None, _f32(CHOL), _f32(MEAN), steps, True,
                               "float32", BENCH).values()) == 0.0
    if settle is not None:
        monkeypatch.setattr(OH, "hedged_returns_reference", settle)
    wrong = gbm_multi_portfolio_dd(*args, **kw)
    if output is not None:
        wrong = output(wrong)
    shares = multi_dd_shares(wrong, right, None, _f32(CHOL), _f32(MEAN), steps, True,
                             "float32", BENCH)
    assert max(shares.values()) > 2.0, shares


@pytest.mark.parametrize("steps", [16, 252])
def test_hedged_bound_holds_prices_a_kernel_apart(steps):
    """A sound kernel's log increments differ from the plain form's by its
    draws' rounding: 1e-7 per step at these volatilities (``ops.gbm
    .kernel_tolerance``'s 2e-6 per draw). Increments moved by that much, at
    random, stay within the per-path bound on the bench hedge."""
    z = step_shocks(8, A, 512, steps, device="cpu")
    x = _f32(MEAN) + z @ _f32(CHOL).T
    w = _f32(np.random.default_rng(4).dirichlet(np.ones(A), 5))
    right = OH.hedged_multi_dd(x, BENCH, w, price_bound=hedged_price_bound(
        _f32(CHOL), _f32(MEAN), steps))
    gen = torch.Generator().manual_seed(steps)
    moved = OH.hedged_multi_dd(x + 1e-7 * (2.0 * torch.rand(x.shape, generator=gen) - 1.0),
                               BENCH, w)
    shares = OH.hedged_shares(moved, right, None)
    assert 0.0 < max(shares.values()) <= 1.0, shares


def test_kernel_order_settles_as_mcports_leg_returns():
    """One division by the previous price after the legs' numerators agrees
    with mcport's per-leg division to rounding."""
    from mcport.options.hedged import hedged_step_returns as ref_step

    rng = np.random.default_rng(3)
    prev = S0 * np.exp(rng.normal(0, 0.1, (1_000, A)))
    new = prev * np.exp(rng.normal(0, 0.03, (1_000, A)))
    got = OH.hedged_returns_reference(_f32(prev), _f32(new), *HEDGE[1:])
    want = ref_step(jnp.asarray(prev, jnp.float32), jnp.asarray(new, jnp.float32),
                    *REF_SPEC.arrays)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)


# ---- engines and API -------------------------------------------------------------------

CFG = GBMConfig(n_paths=32_768, n_steps=13, path_block=8_192, seed=1)


def test_gbm_risk_hedged_matches_mcport_in_law():
    got = gbm_risk(PARAMS, W, Config(gbm=CFG), legs_by_asset=dict(ROWS), device="cpu")
    want = ref_gbm_risk(REF_PARAMS, W, RefConfig(gbm=RefGBMConfig(
        n_paths=CFG.n_paths, n_steps=CFG.n_steps, path_block=CFG.path_block, seed=1)),
        legs_by_asset=dict(ROWS))
    # the hedged per-path returns of the port's own draw give the standard errors
    from mcport_torch.ops.gbm import block_terminal_log_returns
    from mcport_torch.options.hedged import hedged_terminal_returns

    term = block_terminal_log_returns(1, _f32(MEAN), _f32(CHOL), CFG.path_block,
                                      CFG.n_steps, first_block=0, n_blocks=4)
    port = (hedged_terminal_returns(term.double(), S0, *SPEC.tensors("cpu", torch.float64))
            @ torch.as_tensor(W)).numpy().ravel()
    q = np.quantile(port, 0.05)
    h = 0.02 * port.std()
    se_var = math.sqrt(0.05 * 0.95 / port.size) / (np.mean(np.abs(port - q) < h) / (2 * h))
    tail = port[port <= q]
    se_cvar = math.sqrt((tail.var() + 0.95 * (q - tail.mean()) ** 2) / (port.size * 0.05))
    assert abs(got.port_mean - want.port_mean) <= 4 * math.sqrt(2) * port.std() / math.sqrt(
        port.size)
    assert abs(got.var - want.var) <= 4 * math.sqrt(2) * se_var
    assert abs(got.cvar - want.cvar) <= 4 * math.sqrt(2) * se_cvar
    se_mean = np.sqrt(np.diag(want.cov) / CFG.n_paths)
    assert (np.abs(got.mean - want.mean) <= 4 * math.sqrt(2) * se_mean).all()


def test_identity_hedge_gives_the_unhedged_report():
    ident = {i: [("BUY_ASSET", 0, 0, 1)] for i in range(A)}
    got = gbm_risk(PARAMS, W, Config(gbm=CFG), legs_by_asset=ident, device="cpu")
    plain = gbm_risk(PARAMS, W, Config(gbm=CFG), device="cpu")
    np.testing.assert_array_equal(got.mean, plain.mean)
    assert abs(got.port_mean - plain.port_mean) <= 1e-6
    # the two sketches differ (linear hedged, log1p unhedged): within a few bins
    assert abs(got.var - plain.var) <= 2e-3 and abs(got.cvar - plain.cvar) <= 2e-3


def test_hedged_digest_binds_the_checkpoint(tmp_path):
    other = HedgeSpec.build({0: [("BUY_ASSET", 0, 0, 1), ("BUY_PUT", 90.0, 0.5, 1)]}, NAMES)
    _, ck = run_resumable_mc(PARAMS, W, CFG, hedge=SPEC, max_blocks=1, device="cpu")
    for bad in (other, None):
        with pytest.raises(ValueError, match="digest"):
            run_resumable_mc(PARAMS, W, CFG, hedge=bad, checkpoint=ck, device="cpu")
    _, pck = run_resumable_path_risk("gbm", PARAMS, W, CFG, hedge=SPEC, max_blocks=1,
                                     device="cpu")
    with pytest.raises(ValueError, match="digest"):
        run_resumable_path_risk("gbm", PARAMS, W, CFG, hedge=other, checkpoint=pck,
                                device="cpu")


def test_hedged_split_resume_is_bit_identical(tmp_path):
    full, ck_full = run_resumable_mc(PARAMS, W, CFG, hedge=SPEC, device="cpu")
    _, part = run_resumable_mc(PARAMS, W, CFG, hedge=SPEC, max_blocks=1, device="cpu",
                               checkpoint_path=tmp_path / "mc.npz")
    resumed, ck = run_resumable_mc(PARAMS, W, CFG, hedge=SPEC, checkpoint=part,
                                   device="cpu")
    assert ck.done and not part.done and np.array_equal(ck.hist, ck_full.hist)
    assert (resumed.var, resumed.cvar, resumed.port_mean) == (full.var, full.cvar,
                                                              full.port_mean)
    merton = merton_params_from_numpy(S0, MEAN, CHOL, 0.05, np.full(A, -0.03),
                                      np.full(A, 0.02))
    for model, params in (("gbm", PARAMS), ("student_t", PARAMS), ("jump", merton)):
        rfull, rck_full = run_resumable_path_risk(model, params, W, CFG, hedge=SPEC,
                                                  device="cpu")
        _, rpart = run_resumable_path_risk(model, params, W, CFG, hedge=SPEC, max_blocks=3,
                                           device="cpu")
        rres, rck = run_resumable_path_risk(model, params, W, CFG, hedge=SPEC,
                                            checkpoint=rpart, device="cpu")
        assert rck.done and all(np.array_equal(getattr(rck, f), getattr(rck_full, f))
                                for f in ("h_port", "h_dd", "s_port", "s_dd")), model
        assert (rres.var, rres.dd_p95) == (rfull.var, rfull.dd_p95), model


@pytest.fixture(scope="module")
def weekly(fixtures_dir):
    paths = [fixtures_dir / "BTC_USD 7 Years Weekly.csv",
             fixtures_dir / "ETH_USD 7 Years Weekly.csv"]
    return load_universe(paths, DataConfig(period="W")), ref_load(
        paths=paths, config=RefDataConfig(period="W"))


def _weekly_legs(data):
    s = float(data.prices[-1, 0])
    return {data.names[0]: [("BUY_ASSET", 0.0, 0.0, 1.0), ("BUY_PUT", 0.95 * s, 0.0, 1.0)],
            data.names[1]: [("BUY_PUT", 0.9 * float(data.prices[-1, 1]), 0.0, 1.0),
                            ("SELL_CALL", 1.5 * float(data.prices[-1, 1]), 0.0, 1.0)]}


@pytest.mark.parametrize("model", ["gbm", "student_t", "garch", "dcc", "jump", "heston",
                                   "bootstrap"])
def test_hedged_tail_risk_families_match_mcport_in_law(weekly, model):
    from mcport_torch.api import _family_terminal_simple
    from mcport_torch.options.hedged import hedged_from_simple

    data, ref_data = weekly
    legs = _weekly_legs(data)
    n = 16_384
    got = hedged_tail_risk(data, None, Config(gbm=GBMConfig(n_paths=n, n_steps=13)), legs,
                           model=model, device="cpu")
    want = ref_hedged_tail(ref_data, None, RefConfig(gbm=RefGBMConfig(
        n_paths=n, path_block=n, n_steps=13, use_pallas=False)), legs, model=model)
    assert set(got) == set(want) and got["hedged_assets"] == want["hedged_assets"]
    simple = _family_terminal_simple(data, model, GBMConfig(n_paths=n, n_steps=13), "cpu")
    spec = HedgeSpec.build(legs, data.names)
    port = (hedged_from_simple(simple, data.prices[-1], *spec.tensors("cpu", torch.float64))
            @ torch.full((2,), 0.5)).double().numpy()
    s = np.sort(port)
    k, d = int(0.05 * n), int(math.sqrt(n * 0.05 * 0.95))
    se_var = (s[k + d] - s[k - d]) / 2
    tail = port[port <= s[k]]
    se_cvar = math.sqrt((tail.var() + 0.95 * (s[k] - tail.mean()) ** 2) / (n * 0.05))
    assert abs(got["var"] - want["var"]) <= 4 * math.sqrt(2) * se_var + 1e-6
    assert abs(got["cvar"] - want["cvar"]) <= 4 * math.sqrt(2) * se_cvar + 1e-6
    assert abs(got["port_mean"] - want["port_mean"]) <= 4 * math.sqrt(2) * port.std() / \
        math.sqrt(n) + 1e-6
    assert got["cvar"] <= got["var"]


def test_hedged_tail_risk_refuses_error_bars(weekly):
    data, _ = weekly
    with pytest.raises(NotImplementedError, match="not ported"):
        hedged_tail_risk(data, None, Config(gbm=GBMConfig(ci_boot=10)), _weekly_legs(data),
                         device="cpu")


@pytest.mark.parametrize("model", ["dcc"])
def test_hedged_family_calls_run_on_the_weekly_fixtures(weekly, model):
    """The last family whose hedged mode was ported: ``path_tail_risk`` with
    legs has mcport's keys and hedged assets, and the hedged frontier on the
    same fit settles every candidate (the laws:
    ``tests/test_torch_hedged_dcc.py``)."""
    from mcport.api import path_tail_risk as ref_tail
    from mcport_torch.models.dcc import estimate_dcc_garch

    data, ref_data = weekly
    legs = _weekly_legs(data)
    small = GBMConfig(n_paths=8_192, n_steps=8, path_block=4_096, seed=1)
    got = path_tail_risk(data, None, Config(gbm=small), model=model, legs_by_asset=legs,
                         device="cpu")
    want = ref_tail(ref_data, None, RefConfig(gbm=RefGBMConfig(
        n_paths=8_192, n_steps=8, path_block=4_096, use_pallas=False)), model=model,
        legs_by_asset=legs)
    assert set(got) == set(want) and got["hedged_assets"] == want["hedged_assets"]
    assert got["cvar"] <= got["var"] and -1.0 <= got["dd_p95"] <= got["dd_median"] <= 0.0
    r = family_drawdown_frontier_search(0, model, estimate_dcc_garch(data.port_rets),
                                        dd_budget=0.9, n_candidates=16, n_paths=512, n_steps=8,
                                        hedge=HedgeSpec.build(legs, data.names),
                                        s0=data.prices[-1], device="cpu")
    assert r.opt_idx >= 0 and np.isfinite(r.ret).all()


def _scores(term, dd, k_tail):
    return term.mean(dim=-1), torch.kthvalue(dd, k_tail, dim=-1).values


@pytest.mark.parametrize("model", ["gbm", "jump"])
def test_hedged_frontier_scores_as_the_plain_scorer(model):
    """The frontier's hedged scores and optimum equal the plain scorer's
    (:func:`mcport_torch.ops.hedged.hedged_multi_dd`) on the same weight
    matrix and the same paths, and the candidates' scores agree with
    mcport's hedged lax scorer in law."""
    kw = dict(dd_budget=0.25, n_candidates=96, n_paths=2_048, n_steps=26)
    if model == "gbm":
        r = drawdown_frontier_search(4, PARAMS, hedge=SPEC, device="cpu", **kw)
    else:
        merton = merton_params_from_numpy(S0, MEAN, CHOL, 0.05, np.full(A, -0.03),
                                          np.full(A, 0.02))
        r = family_drawdown_frontier_search(4, "jump", merton, hedge=SPEC, s0=S0,
                                            device="cpu", **kw)
    assert r.opt_idx >= 0 and 0 < int(r.feasible.sum()) < kw["n_candidates"]
    path_seed, _ = frontier_seeds(4)
    w = torch.as_tensor(r.weights, dtype=torch.float32)
    from mcport_torch.ops.gbm import step_shocks
    from mcport_torch.ops.jump import merton_increments

    if model == "gbm":
        z = step_shocks(path_seed, A, kw["n_paths"], kw["n_steps"], device="cpu")
        x = _f32(MEAN) + z @ _f32(CHOL).T
    else:
        x = merton_increments(path_seed, _f32(MEAN), _f32(CHOL), 0.05, _f32(np.full(A, -0.03)),
                              _f32(np.full(A, 0.02)), kw["n_paths"], kw["n_steps"])
    term, dd = hedged_multi_dd(x, HEDGE, w)
    ret, dd_p95 = _scores(term[0], dd[0], math.ceil(0.05 * kw["n_paths"]))
    np.testing.assert_array_equal(r.ret, ret.numpy())
    np.testing.assert_array_equal(r.dd_p95, dd_p95.numpy())
    feasible = r.valid & (dd_p95.numpy() >= -0.25)
    assert r.opt_idx == int(np.argmax(np.where(feasible, ret.numpy(), -np.inf)))
    if model == "gbm":   # mcport's hedged lax scorer on the same candidates, in law
        rterm, _ = _lax_multi_dd_hedged(jax.random.key(4), jnp.asarray(MEAN, jnp.float32),
                                        jnp.asarray(CHOL, jnp.float32),
                                        jnp.asarray(r.weights[:8], jnp.float32),
                                        kw["n_paths"], kw["n_steps"], jnp.float32,
                                        *_ref_args())
        rt = np.asarray(rterm, np.float64)
        t = term[0, :8].double().numpy()
        se = np.sqrt(t.var(axis=1) / kw["n_paths"] + rt.var(axis=1) / kw["n_paths"])
        assert (np.abs(t.mean(axis=1) - rt.mean(axis=1)) <= 4 * se).all()


def test_frontier_ranks_overflowed_drawdowns_as_worst():
    """Per-step settlement of deep in-the-money legs can overflow the wealth
    (a NaN drawdown); mcport's ``top_k(-dd)`` ranks it the worst, and so
    does the port's quantile, so such a candidate is never feasible."""
    from mcport_torch.engine.drawdown_frontier import _tail_stats

    dd = torch.tensor([[-0.1, float("nan"), -0.2, -0.05], [-0.1, -0.3, -0.2, -0.05]])
    _, q1 = _tail_stats(torch.zeros_like(dd), dd, 1)
    _, q2 = _tail_stats(torch.zeros_like(dd), dd, 2)
    assert q1.tolist() == [-math.inf, -0.30000001192092896]
    assert q2.tolist() == [pytest.approx(-0.2), pytest.approx(-0.2)]


def test_hedged_shares_hold_overflowed_paths_to_each_other():
    """Per-step settlement can overflow a path's wealth. Overflowed on both
    sides, a path must carry the same inf and NaN drawdown; finite on one
    side only, its finite wealth must lie within the bound of float32's
    largest value (the last step decided it); a kernel that overflows a path
    its plain form keeps far inside the range, or a NaN drawdown on a finite
    path, fails."""
    nan, inf = float("nan"), float("inf")
    top = torch.finfo(torch.float32).max
    p = (torch.tensor([[1.0, inf, 2.0, 0.99 * top, -inf]]),
         torch.tensor([[-0.1, nan, -0.2, -0.3, nan]]), torch.full((1, 5), 0.02))
    k = (torch.tensor([[1.0 + 1e-7, inf, 2.0, inf, -inf]]),
         torch.tensor([[-0.1, nan, -0.2, nan, nan]]))
    assert max(OH.hedged_shares(k, p, None).values()) <= 1.0
    assert OH.hedged_held(k, p) == {"finite": 2, "overflowed": 2, "edge": 1, "astray": 0,
                                    "max_abs": pytest.approx(1.1920929e-07),
                                    "max_rel": pytest.approx(1.1920929e-07 / 2)}
    far = (p[0], p[1], torch.full((1, 5), 1e-3))      # 0.99 top is not within 1e-3 of it
    assert OH.hedged_shares(k, far, None)["term"] == math.inf
    astray = (torch.tensor([[1.0, inf, inf, 0.99 * top, -inf]]), k[1])
    assert OH.hedged_shares(astray, p, None)["term"] == math.inf
    flipped = (torch.tensor([[1.0, inf, 2.0, 0.99 * top, inf]]), k[1])
    assert OH.hedged_shares(flipped, p, None)["term"] == math.inf
    nan_dd = (k[0], torch.tensor([[nan, nan, -0.2, nan, nan]]))
    assert OH.hedged_shares(nan_dd, p, None)["dd"] == math.inf
