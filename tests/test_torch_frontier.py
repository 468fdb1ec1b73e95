"""The port's drawdown-frontier search and Dirichlet sampling against mcport's,
on the CPU.

The streams differ (the port's Philox paths and torch-generator weights,
mcport's Threefry), so the searches are compared in law at matched sizes
(64 candidates, 4,096 paths, 12 steps):

- each search's optimum, scored again by the OTHER package on its own paths,
  has the mean return and drawdown quantile its search reported, within 4
  standard errors of the difference (errors from the per-path samples:
  mean, and the asymptotic variance of the quantile);
- every candidate of mcport's search, scored by the port, agrees with
  mcport's scores the same way;
- the feasible shares agree within 4 standard errors of a difference of two
  binomial proportions.

Against itself the port is exact where mcport pins it: the bf16 screen plus
float32 rescore gives the float32 search's optimum; "auto" is float32.

The family frontier (GARCH, DCC, bootstrap, common-jump Merton and Heston,
rebalanced wealth) is held the same way at 32 candidates x 4,096 paths x 12
steps: every candidate of mcport's
search, scored by the port on its own paths, has mcport's mean return within
4 standard errors of the difference, and mcport's drawdown quantile ``q``
lies where the port's law puts it, ``F(q-) <= 1 - alpha <= F(q)`` within 4
binomial standard errors (the bootstrap's drawdown law has atoms); chunking
never changes a score.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcport.engine.drawdown_frontier import _lax_multi_dd
from mcport.engine.drawdown_frontier import drawdown_frontier_search as ref_search
from mcport.engine.drawdown_frontier import family_drawdown_frontier_search as ref_family
from mcport.models.dcc import DCCGarchParams as RefDcc
from mcport.models.garch_mc import CCCGarchParams as RefGarch
from mcport.models.gbm import GBMParams as RefParams
from mcport.models.heston import HestonParams as RefHeston
from mcport.models.jump import MertonParams as RefMerton
from mcport.ops.dirichlet import sample_constrained_weights as ref_constrained
from mcport_torch.convert import from_mcport
from mcport_torch.engine.drawdown_frontier import (drawdown_frontier_search,
                                                   family_drawdown_frontier_search,
                                                   frontier_seeds)
from mcport_torch.models.bootstrap import bootstrap_path_stats
from mcport_torch.models.dcc import dcc_path_stats
from mcport_torch.models.garch_mc import garch_path_stats
from mcport_torch.models.heston import heston_path_stats
from mcport_torch.models.jump import merton_path_stats
from mcport_torch.ops.dirichlet import sample_weights
from mcport_torch.ops.multi_dd import gbm_multi_portfolio_dd

torch.set_num_threads(1)   # the suite runs several xdist workers on shared cores

A = 3
MEAN = np.array([0.002, 0.001, 0.0015])
CHOL = np.linalg.cholesky(0.0009 * (0.6 * np.eye(A) + 0.4))
REF_PARAMS = RefParams(s0=np.ones(A) * 100, mean_step=MEAN, chol_step=CHOL)
PARAMS = from_mcport(REF_PARAMS)
KW = dict(dd_budget=0.15, n_candidates=64, n_paths=4_096, n_steps=12)
ALPHA = 0.95


def _quantile_se(x: np.ndarray, p: float) -> np.ndarray:
    """Row-wise asymptotic standard error of the sample p-quantile."""
    q = np.quantile(x, p, axis=-1, keepdims=True)
    h = 0.02 * x.std(axis=-1, keepdims=True)
    dens = np.mean(np.abs(x - q) < h, axis=-1) / (2 * h[..., 0])
    return np.sqrt(p * (1 - p) / x.shape[-1]) / dens


def _port_scores(w: np.ndarray, seed: int):
    """(ret, dd_p95, their standard errors) of candidates ``w`` on the port's
    plain form."""
    term, dd = gbm_multi_portfolio_dd(seed, torch.as_tensor(MEAN, dtype=torch.float32),
                                      torch.as_tensor(CHOL, dtype=torch.float32),
                                      torch.tensor(w, dtype=torch.float32),
                                      KW["n_paths"], KW["n_steps"])
    term, dd = term[0].double().numpy(), dd[0].double().numpy()
    k = int(np.ceil((1 - ALPHA) * KW["n_paths"]))
    return (term.mean(-1), np.sort(dd, axis=-1)[:, k - 1],
            term.std(-1) / np.sqrt(term.shape[-1]), _quantile_se(dd, 1 - ALPHA))


def _mcport_scores(w: np.ndarray, key):
    term, dd = map(np.asarray, _lax_multi_dd(key, jnp.asarray(MEAN, jnp.float32),
                                             jnp.asarray(CHOL, jnp.float32),
                                             jnp.asarray(w, jnp.float32), KW["n_paths"],
                                             KW["n_steps"], jnp.float32))
    k = int(np.ceil((1 - ALPHA) * KW["n_paths"]))
    return term.mean(-1), np.sort(dd, axis=-1)[:, k - 1]


@pytest.fixture(scope="module")
def searches():
    got = drawdown_frontier_search(3, PARAMS, score_dtype="float32", device="cpu", **KW)
    want = ref_search(jax.random.key(3), REF_PARAMS, dtype=jnp.float32, use_pallas=False,
                      **KW)
    return got, want


def test_search_shapes_and_feasibility(searches):
    got, _ = searches
    n = KW["n_candidates"]
    assert got.weights.shape == (n, A) and got.valid.all()
    np.testing.assert_allclose(got.weights.sum(1), 1.0, atol=1e-6)
    assert np.array_equal(got.feasible, got.valid & (got.dd_p95 >= -KW["dd_budget"]))
    assert got.opt_idx >= 0 and got.feasible[got.opt_idx]
    assert got.ret[got.opt_idx] == got.ret[got.feasible].max()
    assert np.array_equal(got.opt_weights, got.weights[got.opt_idx])


def test_optima_agree_with_mcport_in_law(searches):
    got, want = searches
    assert got.opt_idx >= 0 and want.opt_idx >= 0
    # the port's optimum on mcport's paths
    r_m, d_m = _mcport_scores(got.weights[[got.opt_idx]], jax.random.fold_in(
        jax.random.PRNGKey(0), 12345))
    r_p, d_p, se_r, se_d = _port_scores(got.weights[[got.opt_idx]], frontier_seeds(3)[0])
    assert abs(r_m[0] - got.ret[got.opt_idx]) <= 4 * np.sqrt(2) * se_r[0]
    assert abs(d_m[0] - got.dd_p95[got.opt_idx]) <= 4 * np.sqrt(2) * se_d[0]
    # mcport's optimum on the port's paths
    r_p, d_p, se_r, se_d = _port_scores(want.weights[[want.opt_idx]], 7)
    assert abs(r_p[0] - want.ret[want.opt_idx]) <= 4 * np.sqrt(2) * se_r[0]
    assert abs(d_p[0] - want.dd_p95[want.opt_idx]) <= 4 * np.sqrt(2) * se_d[0]


def test_every_candidate_scores_as_mcport_in_law(searches):
    _, want = searches
    r_p, d_p, se_r, se_d = _port_scores(want.weights, 9)
    assert np.all(np.abs(r_p - want.ret) <= 4 * np.sqrt(2) * se_r)
    assert np.all(np.abs(d_p - want.dd_p95) <= 4 * np.sqrt(2) * se_d)


def test_feasible_shares_agree_with_mcport(searches):
    got, want = searches
    n = KW["n_candidates"]
    p_got, p_want = got.feasible.mean(), want.feasible.mean()
    p = 0.5 * (p_got + p_want)
    assert abs(p_got - p_want) <= 4 * np.sqrt(2 * p * (1 - p) / n) + 1.0 / n


def test_bf16_screen_and_rescore_give_the_float32_optimum():
    kw = dict(KW, dd_budget=1.0, n_candidates=96)
    every = drawdown_frontier_search(2, PARAMS, score_dtype="float32", device="cpu", **kw)
    kw["dd_budget"] = float(np.median(-every.dd_p95))     # about half feasible
    r32 = drawdown_frontier_search(2, PARAMS, score_dtype="float32", device="cpu", **kw)
    rb16 = drawdown_frontier_search(2, PARAMS, score_dtype="bfloat16", device="cpu", **kw)
    assert r32.opt_idx >= 0 and rb16.opt_idx == r32.opt_idx
    np.testing.assert_array_equal(rb16.weights, r32.weights)
    i = r32.opt_idx
    assert rb16.ret[i] == pytest.approx(r32.ret[i], rel=1e-6, abs=1e-7)
    assert rb16.dd_p95[i] == pytest.approx(r32.dd_p95[i], abs=1e-6)
    # the screen did screen: its unrescored drawdowns differ from float32
    assert not np.array_equal(rb16.dd_p95, r32.dd_p95)


def test_auto_stays_float32_on_the_cpu():
    r32 = drawdown_frontier_search(2, PARAMS, score_dtype="float32", device="cpu", **KW)
    rauto = drawdown_frontier_search(2, PARAMS, device="cpu", **KW)
    np.testing.assert_array_equal(rauto.ret, r32.ret)
    np.testing.assert_array_equal(rauto.dd_p95, r32.dd_p95)


def test_chunking_and_modes():
    small = drawdown_frontier_search(4, PARAMS, w_block=16, device="cpu", **KW)
    whole = drawdown_frontier_search(4, PARAMS, device="cpu", **KW)
    np.testing.assert_allclose(small.ret, whole.ret, rtol=0, atol=1e-7)
    np.testing.assert_allclose(small.dd_p95, whole.dd_p95, rtol=0, atol=1e-7)
    reb = drawdown_frontier_search(4, PARAMS, rebalance=True, device="cpu", **KW)
    t = drawdown_frontier_search(4, PARAMS, t_df=5.0, device="cpu", **KW)
    assert not np.allclose(reb.ret, whole.ret) and not np.allclose(t.dd_p95, whole.dd_p95)
    none = drawdown_frontier_search(4, PARAMS, device="cpu", **dict(KW, dd_budget=1e-4))
    assert none.opt_idx == -1 and none.opt_weights is None
    with pytest.raises(ValueError, match="w_block"):
        drawdown_frontier_search(4, PARAMS, w_block=0, device="cpu", **KW)


def test_dirichlet_law_and_bounds_match_mcport():
    gen = torch.Generator().manual_seed(0)
    n = 20_000
    w, valid = sample_weights(gen, n, np.zeros(4), np.ones(4))
    assert valid.all() and w.dtype == torch.float32
    var = (4 - 1) / (16 * 5)                      # Dirichlet(1,1,1,1) component variance
    assert np.allclose(w.mean(0).numpy(), 0.25, atol=4 * np.sqrt(var / n))
    assert np.allclose(w.var(0).numpy(), var, rtol=0.05)
    lo, hi = np.full(4, 0.05), np.full(4, 0.5)
    w, valid = sample_weights(gen, 4_000, lo, hi, max_retries=3)
    ok = ((w >= torch.as_tensor(lo, dtype=torch.float32))
          & (w <= torch.as_tensor(hi, dtype=torch.float32))).all(1)
    assert torch.equal(ok, valid)
    _, ref_valid = ref_constrained(jax.random.key(1), 4_000, jnp.asarray(lo), jnp.asarray(hi),
                                   max_retries=3)
    p, q = float(valid.double().mean()), float(np.asarray(ref_valid).mean())
    assert abs(p - q) <= 4 * np.sqrt(2 * p * (1 - p) / 4_000) + 1e-3


# ---- the family frontier: GARCH, DCC, bootstrap, Merton, Heston -------------------

REF_GARCH = RefGarch(mu=MEAN, omega=np.full(A, 4e-5), alpha=np.full(A, 0.08),
                     beta=np.full(A, 0.9), corr_chol=np.linalg.cholesky(0.6 * np.eye(A) + 0.4),
                     sigma2_0=np.full(A, 9e-4), eps2_0=np.full(A, 9e-4))
HISTORY = (np.random.default_rng(42).standard_t(5, (150, A)) * 0.03 + 0.002).astype(np.float32)
FAMILY_KW = dict(dd_budget=0.15, n_candidates=32, n_paths=4_096, n_steps=12)
REF_MERTON = RefMerton(REF_PARAMS, 0.1, np.array([-0.06, -0.08, -0.05]),
                       np.array([0.03, 0.04, 0.02]))
REF_HESTON = RefHeston(mu=MEAN, kappa=np.full(A, 0.15), theta=np.full(A, 9e-4),
                       xi=np.full(A, 0.01), rho=np.full(A, -0.5), v0=np.full(A, 9e-4),
                       corr_chol=np.linalg.cholesky(0.6 * np.eye(A) + 0.4), s0=np.ones(A))


REF_DCC = RefDcc(base=REF_GARCH, a_dcc=0.06, b_dcc=0.9, q0=0.55 * np.eye(A) + 0.4,
                 e0=np.array([1.2, -0.4, 2.0]))


def _family_params(model):
    ref = {"garch": REF_GARCH, "dcc": REF_DCC, "jump": REF_MERTON,
           "heston": REF_HESTON}.get(model)
    return (HISTORY, HISTORY) if ref is None else (from_mcport(ref), ref)


def _family_path_stats(model, seed, params, w, n_paths, n_steps):
    """The port's plain (terminal returns, drawdowns) of candidates ``w``."""
    if model == "jump":
        d = params.diffusion
        return merton_path_stats(seed, d.mean_step, d.chol_step, params.jump_rate,
                                 params.jump_mean, params.jump_vol, w, n_paths, n_steps,
                                 device="cpu")
    fn = {"garch": garch_path_stats, "dcc": dcc_path_stats, "heston": heston_path_stats,
          "bootstrap": bootstrap_path_stats}[model]
    return fn(seed, params, w, n_paths, n_steps, device="cpu")


@pytest.mark.parametrize("model", ["garch", "dcc", "bootstrap", "jump", "heston"])
def test_family_frontier_scores_as_mcport_in_law(model):
    params, ref_params = _family_params(model)
    got = family_drawdown_frontier_search(3, model, params, device="cpu", **FAMILY_KW)
    want = ref_family(jax.random.key(3), model, ref_params, use_pallas=False, **FAMILY_KW)
    n = FAMILY_KW["n_candidates"]
    assert got.weights.shape == (n, A) and got.valid.all()
    assert np.array_equal(got.feasible, got.valid & (got.dd_p95 >= -FAMILY_KW["dd_budget"]))
    if got.opt_idx >= 0:
        assert got.ret[got.opt_idx] == got.ret[got.feasible].max()
    # mcport's candidates on the port's paths
    term, dd = (x.double().numpy() for x in _family_path_stats(
        model, 7, params, want.weights, FAMILY_KW["n_paths"], FAMILY_KW["n_steps"]))
    se_r = term.std(-1) / np.sqrt(term.shape[-1])
    assert np.all(np.abs(term.mean(-1) - want.ret) <= 4 * np.sqrt(2) * se_r)
    # mcport's quantile q is one of the port's: F(q-) <= 1 - alpha <= F(q) on
    # the port's paths, within binomial error (the bootstrap's drawdown law has
    # atoms, where a quantile's density-based error is meaningless)
    p, n_p = 1 - ALPHA, dd.shape[-1]
    tol = 4 * np.sqrt(2 * p * (1 - p) / n_p)
    q = want.dd_p95[:, None].astype(np.float64)
    assert np.all((dd < q).mean(-1) <= p + tol) and np.all((dd <= q).mean(-1) >= p - tol)


@pytest.mark.parametrize("model", ["garch", "dcc", "bootstrap", "jump", "heston"])
def test_family_frontier_chunks_share_one_path_set(model):
    params, _ = _family_params(model)
    small = family_drawdown_frontier_search(4, model, params, w_block=8, device="cpu",
                                            **FAMILY_KW)
    whole = family_drawdown_frontier_search(4, model, params, device="cpu", **FAMILY_KW)
    np.testing.assert_array_equal(small.weights, whole.weights)
    np.testing.assert_allclose(small.ret, whole.ret, rtol=0, atol=1e-7)
    np.testing.assert_allclose(small.dd_p95, whole.dd_p95, rtol=0, atol=1e-7)
    with pytest.raises(ValueError, match="w_block"):
        family_drawdown_frontier_search(4, model, params, w_block=0, device="cpu",
                                        **FAMILY_KW)
