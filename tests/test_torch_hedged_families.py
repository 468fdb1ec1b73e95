"""Hedged per-step settlement of the GARCH and bootstrap families: the port
against mcport, on the CPU (the Heston family's engines and frontier:
``tests/test_torch_hedged_heston.py``).

- Settlement on identical moves: the hedged plain forms' core
  (``ops/hedged.py`` ``hedged_multi_dd`` with ``gross``) against mcport's
  in-kernel settlement (``make_hedged_returns``, ``pallas_multi_dd.py:46``)
  on the same per-step GARCH returns and spots, to 1e-6; the bootstrap's
  hedged plain form against the same recursion in JAX on identical restart
  indices: the prices bit for bit, one-hot candidates bit for bit (their
  score is exact), any weights to 1e-6.
- In law at matched path counts: hedged ``run_garch_path_risk`` and
  ``run_bootstrap_path_risk`` against mcport's (the drawdown quantiles
  through order statistics for the bootstrap, whose law has atoms), and both
  hedged frontiers' scores against mcport's hedged lax scorers on the same
  candidates; an identity hedge (one BUY_ASSET leg per asset) gives the
  unhedged mode to its bound; split + resume bit-identical; the hedge binds
  the digest; hedged runs without spots raise, as mcport's do.
- The per-path bounds (``ops.garch.garch_price_bound``,
  ``ops.bootstrap.bootstrap_price_bound``, ``ops.heston.heston_price_bound``,
  ``ops.dcc.dcc_price_bound``) reject planted faults by more than 2x at 252
  steps on the bench hedge (settlement in bfloat16, a drawdown off by 1e-3, a
  dropped premium, a put settled as a call), the GARCH bound holds returns
  moved by a sound kernel's rounding, the Heston bound gross factors 2 ulps
  apart, and the DCC bound innovations of shocks 2e-6 apart through a
  recursion rounded otherwise.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcport.config import GBMConfig as RefGBMConfig
from mcport.engine.path_risk import run_bootstrap_path_risk as ref_bootstrap_run
from mcport.engine.path_risk import run_garch_path_risk as ref_garch_run
from mcport.models.bootstrap import bootstrap_path_stats as ref_bootstrap_stats
from mcport.models.garch_mc import CCCGarchParams as RefGarch
from mcport.models.garch_mc import garch_path_stats as ref_garch_stats
from mcport.models.heston import HestonParams as RefHeston
from mcport.ops.pallas_multi_dd import make_hedged_returns
from mcport.options import HedgeSpec as RefHedgeSpec
from mcport.options import LegType as RefLegType
from mcport.options import Legs as RefLegs
from mcport_torch.config import GBMConfig
from mcport_torch.convert import from_mcport
from mcport_torch.engine.drawdown_frontier import (family_drawdown_frontier_search,
                                                   frontier_seeds)
from mcport_torch.engine.path_risk import (run_bootstrap_path_risk, run_garch_path_risk,
                                           run_resumable_path_risk)
from mcport_torch.convert import dcc_params_from_numpy
from mcport_torch.ops import bootstrap as OB
from mcport_torch.ops import dcc as OD
from mcport_torch.ops import garch as OG
from mcport_torch.ops import hedged as OH
from mcport_torch.ops import heston as OHS
from mcport_torch.ops.hedged import HedgeTensors, hedged_multi_dd
from mcport_torch.options import HedgeSpec
from mcport_torch.options.strategies import collar, married_put

torch.set_num_threads(1)   # the suite runs several xdist workers on shared cores

A = 4
NAMES = ["A0", "A1", "A2", "A3"]
S0 = np.array([100.0, 50.0, 20.0, 8.0])
W = np.array([0.4, 0.3, 0.2, 0.1])
REF_GARCH = RefGarch(
    mu=np.array([5e-4, 1e-3, 8e-4, 3e-4]), omega=np.array([4e-6, 6e-6, 5e-6, 8e-6]),
    alpha=np.array([0.08, 0.12, 0.1, 0.06]), beta=np.array([0.88, 0.82, 0.85, 0.9]),
    corr_chol=np.linalg.cholesky(0.5 * np.eye(A) + 0.5),
    sigma2_0=np.array([1e-4, 2e-4, 1.5e-4, 3e-4]), eps2_0=np.array([1e-4, 2e-4, 3e-4, 1e-4]))
GARCH = from_mcport(REF_GARCH)
# the same universe under Heston: the GARCH parameters' means, their long-run
# variances omega / (1 - alpha - beta) as theta and v0, the same correlation
_LONG_RUN = REF_GARCH.omega / (1.0 - REF_GARCH.alpha - REF_GARCH.beta)
REF_HESTON = RefHeston(
    mu=REF_GARCH.mu, kappa=np.array([0.15, 0.1, 0.2, 0.15]), theta=_LONG_RUN,
    xi=np.array([3e-3, 4e-3, 2e-3, 3e-3]), rho=np.array([-0.5, -0.4, -0.6, -0.5]),
    v0=_LONG_RUN, corr_chol=REF_GARCH.corr_chol, s0=S0)
HESTON = from_mcport(REF_HESTON)
# the same universe under DCC: the GARCH base, chip_smoke's bench a 0.05, b 0.9,
# q0 = 0.5 I + 0.5, e0 = 0
DCC = dcc_params_from_numpy(GARCH, 0.05, 0.9, 0.5 * np.eye(A) + 0.5, np.zeros(A))
HISTORY = (np.random.default_rng(42).standard_t(5, (150, A)) * 0.02 + 0.002).astype(np.float32)
ROWS = {0: [(RefLegType.BUY_ASSET, 0.0, 0.0, 1.0), (RefLegType.BUY_PUT, 95.0, 0.5, 1.0)],
        1: [(RefLegType.BUY_PUT, 45.0, 0.2, 1.0), (RefLegType.SELL_CALL, 56.0, 0.3, 1.0)]}
REF_SPEC = RefHedgeSpec.build({k: RefLegs.from_rows(v) for k, v in ROWS.items()}, NAMES)
SPEC = from_mcport(REF_SPEC)
HEDGE = HedgeTensors.from_spec(SPEC, S0, "cpu")
IDENTITY = HedgeSpec.build({i: [("BUY_ASSET", 0, 0, 1)] for i in range(A)}, NAMES)
CFG = GBMConfig(n_paths=16_384, n_steps=12, path_block=4_096, seed=4)
REF_CFG = RefGBMConfig(n_paths=16_384, n_steps=12, path_block=4_096, seed=4)


def _f32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _ref_args(spec=REF_SPEC):
    return (jnp.asarray(S0, jnp.float32), *spec.arrays)


def _mcport_settled(gross: np.ndarray, w: np.ndarray, spec=REF_SPEC):
    """mcport's hedged candidate recursion in JAX float32 on given per-step
    gross factors ``(n, T, A)``: ``p_new = p · gross``, the settlement of
    ``make_hedged_returns`` on the (A, n) layout of the TPU kernels, ``V *=
    1 + w·r_h`` → (term, dd, prices) with term and dd ``(W, n)``."""
    ht, hk, hp, hq = (jnp.asarray(x) for x in spec.arrays)
    settle = make_hedged_returns(ht, hk.astype(jnp.float32), hp.astype(jnp.float32),
                                 hq.astype(jnp.float32))
    g = jnp.asarray(gross, jnp.float32)
    wj = jnp.asarray(w, jnp.float32)
    p = jnp.broadcast_to(jnp.asarray(S0, jnp.float32)[:, None], (A, g.shape[0]))
    v = jnp.ones((wj.shape[0], g.shape[0]), jnp.float32)
    peak, dd, prices = v, jnp.zeros_like(v), []
    for t in range(g.shape[1]):
        p_new = p * g[:, t, :].T
        v = v * (1.0 + wj @ settle(p, p_new))
        peak = jnp.maximum(peak, v)
        dd = jnp.minimum(dd, v / peak - 1.0)
        p = p_new
        prices.append(np.asarray(p))
    return np.asarray(v - 1.0), np.asarray(dd), np.stack(prices)


# ---- the settlement on identical moves -------------------------------------------------

def test_hedged_garch_settlement_matches_mcport_on_identical_returns():
    """The GARCH plain form's gross ``(1 + mu) + eps`` and its settlement
    against mcport's kernel settlement on the same returns and spots."""
    zc = OG.correlated_shocks(3, GARCH.tensors("cpu"), 512, 26)
    eps = OG.garch_innovations(zc, GARCH.tensors("cpu"))[0]
    gross = (1.0 + GARCH.tensors("cpu").mu) + eps
    w = np.stack([W, np.full(A, 0.25)])
    term, dd = hedged_multi_dd(gross, HEDGE, _f32(w), gross=True)
    rterm, rdd, _ = _mcport_settled(gross.numpy(), w)
    np.testing.assert_allclose(term.numpy(), rterm, rtol=0, atol=1e-6)
    np.testing.assert_allclose(dd.numpy(), rdd, rtol=0, atol=1e-6)
    # the plain form itself is that recursion on its own shocks
    plain = OG.garch_multi_dd_reference(3, GARCH.tensors("cpu"), _f32(w), 512, 26,
                                        hedge=HEDGE)
    assert all(torch.equal(x, y[None]) for x, y in zip(plain, (term, dd)))


def test_hedged_bootstrap_plain_form_matches_mcport_on_identical_rows():
    """On identical restart indices: the prices ``P · (1 + row)`` bit for bit,
    one-hot candidates (an exact score) bit for bit, any weights to 1e-6."""
    hist = torch.as_tensor(HISTORY)
    idx = OB.bootstrap_indices(7, HISTORY.shape[0], 512, 40, 0.2, device="cpu")[0]
    gross = (1.0 + hist[idx]).numpy()
    w = np.vstack([np.eye(A), W[None], np.full((1, A), 0.25)])
    term, dd = OB.bootstrap_multi_dd_reference(7, hist, _f32(w), 512, 40, 0.2, hedge=HEDGE)
    rterm, rdd, rprices = _mcport_settled(gross, w)
    p = torch.as_tensor(S0, dtype=torch.float32).expand(512, A)
    for t in range(40):
        p = p * (1.0 + hist[idx[:, t]])
        assert np.array_equal(p.numpy().T, rprices[t])
    assert np.array_equal(term[0, :A].numpy(), rterm[:A])
    assert np.array_equal(dd[0, :A].numpy(), rdd[:A])
    np.testing.assert_allclose(term[0].numpy(), rterm, rtol=0, atol=1e-6)
    np.testing.assert_allclose(dd[0].numpy(), rdd, rtol=0, atol=1e-6)


@pytest.mark.parametrize("family", ["garch", "bootstrap"])
def test_identity_hedge_is_the_unhedged_mode(family):
    """One BUY_ASSET leg per asset settles to the asset's return: the
    unhedged mode on the same counters, within the hedged bound."""
    ident = HedgeTensors.from_spec(IDENTITY, S0, "cpu")
    w = _f32(np.random.default_rng(0).dirichlet(np.ones(A), 7))
    kw = dict(first_block=2, n_blocks=2)
    if family == "garch":
        args = (9, GARCH.tensors("cpu"), w, 1_000, 52)
        h = OG.garch_multi_portfolio_dd(*args, hedge=ident, **kw)
        r = OG.garch_multi_portfolio_dd(*args, **kw)
        bound = OG.garch_multi_dd_reference(*args, hedge=ident, with_bound=True, **kw)[2]
        shares = OG.garch_shares(h, (*r, bound), GARCH.tensors("cpu"), 52, hedge=ident)
    else:
        args = (9, torch.as_tensor(HISTORY), w, 1_000, 52, 0.2)
        h = OB.bootstrap_multi_portfolio_dd(*args, hedge=ident, **kw)
        r = OB.bootstrap_multi_portfolio_dd(*args, **kw)
        bound = OB.bootstrap_multi_dd_reference(*args, hedge=ident, with_bound=True, **kw)[2]
        shares = OB.bootstrap_shares(h, (*r, bound), args[1], w, 52, hedge=ident)
    assert max(shares.values()) <= 1.0, shares
    assert max(float((x - y).abs().max()) for x, y in zip(h, r)) > 0.0


# ---- the planted faults ----------------------------------------------------------------

def _put_as_call(p_prev, p_new, type_id, strike, premium, qty):
    swapped = torch.where(type_id == 4, torch.full_like(type_id, 2), type_id)
    return _right(p_prev, p_new, swapped, strike, premium, qty)


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
FAULTS = {"settled in bfloat16": (_bfloat16, None),
          "drawdown off by 1e-3": (None, lambda out: (out[0], out[1] - 1e-3)),
          "premium dropped": (_no_premium, None),
          "put settled as a call": (_put_as_call, None)}


def _family_call(family, w, steps, **kw):
    if family == "garch":
        g = GARCH.tensors("cpu")
        return (lambda: OG.garch_multi_portfolio_dd(6, g, w, 512, steps, hedge=BENCH, **kw),
                lambda: OG.garch_multi_dd_reference(6, g, w, 512, steps, hedge=BENCH,
                                                    with_bound=True, **kw),
                lambda k, p: OG.garch_shares(k, p, g, steps, hedge=BENCH))
    if family == "dcc":
        d = DCC.tensors("cpu")
        return (lambda: OD.dcc_multi_portfolio_dd(6, d, w, 512, steps, hedge=BENCH, **kw),
                lambda: OD.dcc_multi_dd_reference(6, d, w, 512, steps, hedge=BENCH,
                                                  with_bound=True, **kw),
                lambda k, p: OD.dcc_shares(k, p, d, steps, hedge=BENCH))
    if family == "heston":
        h = HESTON.tensors("cpu")
        return (lambda: OHS.heston_multi_portfolio_dd(6, h, w, 512, steps, hedge=BENCH, **kw),
                lambda: OHS.heston_multi_dd_reference(6, h, w, 512, steps, hedge=BENCH,
                                                      with_bound=True, **kw),
                lambda k, p: OHS.heston_shares(k, p, h, steps, hedge=BENCH))
    hist = torch.as_tensor(HISTORY)
    return (lambda: OB.bootstrap_multi_portfolio_dd(6, hist, w, 512, steps, 0.2, hedge=BENCH,
                                                    **kw),
            lambda: OB.bootstrap_multi_dd_reference(6, hist, w, 512, steps, 0.2, hedge=BENCH,
                                                    with_bound=True, **kw),
            lambda k, p: OB.bootstrap_shares(k, p, hist, w, steps, hedge=BENCH))


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("family", ["garch", "bootstrap", "heston", "dcc"])
def test_hedged_price_bounds_reject_planted_faults(monkeypatch, family, fault):
    """The per-path bound (the plain form's ``with_bound``) rejects each
    planted fault by more than 2x on the bench hedge at 252 steps."""
    settle, output = FAULTS[fault]
    w = _f32(np.random.default_rng(2).dirichlet(np.ones(A), 5))
    kern, plain, shares = _family_call(family, w, 252, first_block=1, n_blocks=1)
    right = plain()
    assert max(shares(right[:2], right).values()) == 0.0
    if settle is not None:
        monkeypatch.setattr(OH, "hedged_returns_reference", settle)
    wrong = kern()
    if output is not None:
        wrong = output(wrong)
    got = shares(wrong, right)
    assert max(got.values()) > 2.0, got


@pytest.mark.parametrize("steps", [16, 252])
def test_garch_price_bound_holds_returns_a_kernel_apart(steps):
    """A sound kernel's innovations differ from the plain form's by its
    draws' rounding, 2e-6 per draw through sigma and the correlation's row.
    Returns moved by that much, at random, stay within the per-path bound."""
    g = GARCH.tensors("cpu")
    eps = OG.garch_innovations(OG.correlated_shocks(8, g, 512, steps), g)
    gross = (1.0 + g.mu) + eps
    w = _f32(np.random.default_rng(4).dirichlet(np.ones(A), 5))
    right = hedged_multi_dd(gross, BENCH, w, price_bound=OG.garch_price_bound(g, steps),
                            gross=True)
    sigma = float(torch.sqrt(g.sigma2_0.max()))
    gen = torch.Generator().manual_seed(steps)
    moved = hedged_multi_dd(gross + 2e-6 * sigma * (2.0 * torch.rand(gross.shape, generator=gen)
                                                    - 1.0), BENCH, w, gross=True)
    shares = OH.hedged_shares(moved, right, None)
    assert 0.0 < max(shares.values()) <= 1.0, shares


@pytest.mark.parametrize("steps", [16, 252])
def test_dcc_price_bound_holds_innovations_a_kernel_apart(monkeypatch, steps):
    """A sound DCC kernel draws its shocks up to 2e-6 from the plain form's
    and rounds the recursion otherwise (nvcc contracts its sums). Shocks
    moved by up to 2e-6 at random, through the recursion evaluated in
    float64, give prices within the per-path bound of
    :func:`mcport_torch.ops.dcc.dcc_price_bound`, which the plain form
    computes from its own path."""
    d = DCC.tensors("cpu")
    z = OD._shocks(8, d, 512, steps, -1, 1, 0)
    eps, path = OD.dcc_innovations(z, d, with_path=True)
    w = _f32(np.random.default_rng(4).dirichlet(np.ones(A), 5))
    right = hedged_multi_dd((1.0 + d.mu) + eps, BENCH, w,
                            price_bound=OD.dcc_price_bound(d, path), gross=True)
    gen = torch.Generator().manual_seed(steps)
    z_k = z.double() + 2e-6 * (2.0 * torch.rand(z.shape, generator=gen, dtype=torch.float64)
                               - 1.0)
    monkeypatch.setattr(OD, "rsqrt_rn", torch.rsqrt)
    monkeypatch.setattr(OD, "sqrt_rn", torch.sqrt)
    eps_k = OD.dcc_innovations(z_k, OD.DccTensors(*(x.double() for x in d))).float()
    moved = hedged_multi_dd((1.0 + d.mu) + eps_k, BENCH, w, gross=True)
    shares = OH.hedged_shares(moved, right, None)
    assert 0.0 < max(shares.values()) <= 1.0, shares


def _ulps_away(x: torch.Tensor, k: int, gen: torch.Generator) -> torch.Tensor:
    """``x`` moved ``k`` float32 ulps up or down, the direction at random per
    element."""
    up = torch.rand(x.shape, generator=gen) < 0.5
    target = torch.where(up, torch.full_like(x, math.inf), torch.full_like(x, -math.inf))
    for _ in range(k):
        x = torch.nextafter(x, target)
    return x


@pytest.mark.parametrize("steps", [16, 252])
def test_heston_price_bound_holds_gross_factors_two_ulps_apart(steps):
    """The Heston kernel's log increments are the plain form's bits; its
    ``exp`` may sit 2 ulps from torch's. Gross factors ``exp(x)`` moved 2
    ulps per step, in a random direction, stay within the per-path bound of
    :func:`mcport_torch.ops.heston.heston_price_bound`."""
    h = HESTON.tensors("cpu")
    x = OHS.heston_increments(*OHS.heston_shocks(8, h, 512, steps), h)
    gross = torch.exp(x)
    w = _f32(np.random.default_rng(4).dirichlet(np.ones(A), 5))
    right = hedged_multi_dd(x, BENCH, w, price_bound=OHS.heston_price_bound(h, steps))
    assert all(torch.equal(a, b) for a, b in zip(hedged_multi_dd(gross, BENCH, w, gross=True),
                                                 right[:2]))
    gen = torch.Generator().manual_seed(steps)
    moved = hedged_multi_dd(_ulps_away(gross, 2, gen), BENCH, w, gross=True)
    shares = OH.hedged_shares(moved, right, None)
    assert 0.0 < max(shares.values()) <= 1.0, shares


# ---- engines and frontiers against mcport ----------------------------------------------

def _order_se(x: np.ndarray, p: float) -> float:
    """Distribution-free standard error of the sample p-quantile (order
    statistics one binomial standard deviation either side)."""
    s = np.sort(x)
    k, d = int(p * x.size), int(np.sqrt(x.size * p * (1 - p)))
    return float(s[k + d] - s[k - d]) / 2


def _es_se(x: np.ndarray, p: float) -> float:
    q = np.quantile(x, p)
    tail = x[x <= q]
    return float(np.sqrt((tail.var() + (1 - p) * (q - tail.mean()) ** 2) / (x.size * p)))


def _sample(family, cfg, hedge):
    n = cfg.n_paths // cfg.path_block
    kw = dict(first_block=0, n_blocks=n, hedge=hedge)
    if family == "garch":
        term, dd = OG.garch_multi_portfolio_dd(cfg.seed, GARCH.tensors("cpu"), _f32(W)[None],
                                               cfg.path_block, cfg.n_steps, **kw)
    else:
        term, dd = OB.bootstrap_multi_portfolio_dd(cfg.seed, torch.as_tensor(HISTORY),
                                                   _f32(W)[None], cfg.path_block, cfg.n_steps,
                                                   **kw)
    return term.double().numpy().ravel(), dd.double().numpy().ravel()


@pytest.mark.parametrize("family", ["garch", "bootstrap"])
def test_hedged_family_path_risk_matches_mcport_in_law(family):
    if family == "garch":
        got = run_garch_path_risk(GARCH, W, CFG, hedge=SPEC, s0=S0, device="cpu")
        want = ref_garch_run(REF_GARCH, W, REF_CFG, hedge=REF_SPEC, s0=S0)
    else:
        got = run_bootstrap_path_risk(HISTORY, W, CFG, hedge=SPEC, s0=S0, device="cpu")
        want = ref_bootstrap_run(HISTORY, W, REF_CFG, hedge=REF_SPEC, s0=S0)
    assert got.n_paths == want.n_paths == CFG.n_paths
    port, dd = _sample(family, CFG, HEDGE)
    se = {"var": _order_se(port, 0.05), "cvar": _es_se(port, 0.05),
          "port_mean": port.std() / np.sqrt(port.size),
          "dd_mean": dd.std() / np.sqrt(dd.size),
          "dd_p95": _order_se(dd, 0.05), "dd_median": _order_se(dd, 0.5)}
    for name, s in se.items():
        assert abs(getattr(got, name) - getattr(want, name)) <= 4 * np.sqrt(2) * s + 1e-6, name
    assert got.cvar <= got.var and -1 <= got.dd_p95 <= got.dd_median <= 0


@pytest.mark.parametrize("family", ["garch", "bootstrap"])
def test_hedged_family_split_resume_and_digest(family):
    params = GARCH if family == "garch" else HISTORY
    cfg = GBMConfig(n_paths=8_192, n_steps=10, path_block=1_024, seed=2)
    full, ck_full = run_resumable_path_risk(family, params, W, cfg, hedge=SPEC, s0=S0,
                                            device="cpu")
    _, part = run_resumable_path_risk(family, params, W, cfg, hedge=SPEC, s0=S0,
                                      max_blocks=3, device="cpu")
    res, ck = run_resumable_path_risk(family, params, W, cfg, hedge=SPEC, s0=S0,
                                      checkpoint=part, device="cpu")
    assert ck.done and not part.done
    assert all(np.array_equal(getattr(ck, f), getattr(ck_full, f))
               for f in ("h_port", "h_dd", "s_port", "s_dd"))
    assert (res.var, res.dd_p95) == (full.var, full.dd_p95)
    for bad in (dict(hedge=None), dict(hedge=SPEC, s0=S0 * 1.01)):
        with pytest.raises(ValueError, match="digest"):
            run_resumable_path_risk(family, params, W, cfg, checkpoint=part, device="cpu",
                                    **bad)
    with pytest.raises(ValueError, match="requires s0"):
        run_resumable_path_risk(family, params, W, cfg, hedge=SPEC, device="cpu")
    one_shot = run_garch_path_risk if family == "garch" else run_bootstrap_path_risk
    with pytest.raises(ValueError, match="requires s0"):
        one_shot(params, W, cfg, hedge=SPEC, device="cpu")


@pytest.mark.parametrize("family", ["garch", "bootstrap"])
def test_hedged_family_frontier_scores_as_mcports_scorer(family):
    """The hedged frontier's scores are the plain scorer's on its weight
    matrix and paths (the optimum the best feasible mean), and agree with
    mcport's hedged lax scorer on the same candidates in law."""
    kw = dict(dd_budget=0.3, n_candidates=64, n_paths=2_048, n_steps=26)
    params = GARCH if family == "garch" else HISTORY
    r = family_drawdown_frontier_search(4, family, params, hedge=SPEC, s0=S0, device="cpu",
                                        **kw)
    assert r.opt_idx >= 0 and 0 < int(r.feasible.sum()) <= kw["n_candidates"]
    path_seed, _ = frontier_seeds(4)
    w = torch.as_tensor(r.weights, dtype=torch.float32)
    if family == "garch":
        term, dd = OG.garch_multi_dd_reference(path_seed, GARCH.tensors("cpu"), w,
                                               kw["n_paths"], kw["n_steps"], hedge=HEDGE)
        rterm, _ = ref_garch_stats(jax.random.key(4), REF_GARCH, jnp.asarray(r.weights[:8],
                                                                             jnp.float32),
                                   kw["n_paths"], kw["n_steps"], jnp.float32,
                                   hedge_args=_ref_args())
    else:
        term, dd = OB.bootstrap_multi_dd_reference(path_seed, torch.as_tensor(HISTORY), w,
                                                   kw["n_paths"], kw["n_steps"], hedge=HEDGE)
        rterm, _ = ref_bootstrap_stats(jax.random.key(4), jnp.asarray(HISTORY),
                                       jnp.asarray(r.weights[:8], jnp.float32), kw["n_paths"],
                                       kw["n_steps"], hedge_args=_ref_args())
    k = math.ceil(0.05 * kw["n_paths"])
    ret = term[0].mean(dim=-1)
    q = torch.kthvalue(torch.nan_to_num(dd[0], nan=-math.inf), k, dim=-1).values
    np.testing.assert_array_equal(r.ret, ret.numpy())
    np.testing.assert_array_equal(r.dd_p95, q.numpy())
    feasible = r.valid & (q.numpy() >= -0.3)
    assert r.opt_idx == int(np.argmax(np.where(feasible, ret.numpy(), -np.inf)))
    t, rt = term[0, :8].double().numpy(), np.asarray(rterm, np.float64)
    se = np.sqrt(t.var(axis=1) / kw["n_paths"] + rt.var(axis=1) / kw["n_paths"])
    assert (np.abs(t.mean(axis=1) - rt.mean(axis=1)) <= 4 * se).all()
