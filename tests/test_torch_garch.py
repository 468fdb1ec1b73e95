"""The port's CCC-GARCH family (``models/garch.py``, ``models/garch_mc.py``,
``ops/garch.py``) against mcport's, on the CPU.

- Deterministic: the GARCH negative log-likelihood and its gradient equal
  mcport's (``jax.value_and_grad`` with the suite's x64 on) to 1e-9
  relative; ``standardized_residuals`` and ``forecast_garch_variance`` to
  1e-9; ``fit_garch_11`` and ``estimate_ccc_garch`` reach the same
  log-likelihood within 1e-7 relative, with parameters within 1e-4 of their
  scales (the return's spread, omega's bound, 1 for alpha and beta) and the
  forecast state within 1e-3 relative — the reach of L-BFGS-B's default
  tolerances on a likelihood this flat: the two fits' evaluations agree to
  rounding, but rounding steers the optimizer's path in its flat
  directions; ``convert.from_mcport`` is exact.
- Stochastic, in law: the streams differ (Philox against Threefry), so the
  port's plain samplers are held to mcport's lax references at 20,000 paths:
  per-asset terminal means within 6 standard errors of the difference, the
  standard deviations within 6%, and the portfolio's VaR, CVaR, mean
  drawdown and drawdown quantile within 4 standard errors of the difference
  (errors from the port's own per-path sample).
- The kernel-vs-plain bound (``garch_shares``) holds the plain form against
  itself and rejects planted faults at the shapes the card's checks run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcport.data import load_universe as ref_load
from mcport.config import DataConfig as RefDataConfig
from mcport.models import garch as RG
from mcport.models import garch_mc as RM
from mcport_torch.convert import from_mcport
from mcport_torch.models import garch as G
from mcport_torch.models import garch_mc as M
from mcport_torch.ops import garch as O

torch.set_num_threads(1)   # the suite runs several xdist workers on shared cores

A = 3
REF = RM.CCCGarchParams(
    mu=np.array([5e-4, 1e-3, 8e-4]),
    omega=np.array([4e-6, 6e-6, 5e-6]),
    alpha=np.array([0.08, 0.12, 0.1]),
    beta=np.array([0.88, 0.82, 0.85]),
    corr_chol=np.linalg.cholesky(np.array([[1.0, 0.6, 0.3], [0.6, 1.0, 0.4],
                                           [0.3, 0.4, 1.0]])),
    sigma2_0=np.array([1e-4, 2e-4, 1.5e-4]),
    eps2_0=np.array([1e-4, 2e-4, 3e-4]),
)
PARAMS = from_mcport(REF)
W = np.array([0.5, 0.3, 0.2])


@pytest.fixture(scope="module")
def weekly(fixtures_dir):
    """The reference's weekly BTC/ETH universe: 365 rows of simple returns."""
    paths = sorted(str(p) for p in fixtures_dir.glob("*7 Years Weekly.csv"))
    return ref_load(paths=paths, config=RefDataConfig(period="W")).port_rets


def _garch_series(seed: int, n: int = 600) -> np.ndarray:
    """A GARCH(1,1) series with known parameters (mu 1e-3, omega 2e-5,
    alpha 0.1, beta 0.85) from numpy normals."""
    z = np.random.default_rng(seed).standard_normal(n)
    r, s2, e = np.empty(n), 2e-5 / 0.05, 0.0
    for t in range(n):
        s2 = 2e-5 + 0.1 * e * e + 0.85 * s2
        e = np.sqrt(s2) * z[t]
        r[t] = 1e-3 + e
    return r


@pytest.mark.parametrize("point", [[1e-3, 1e-5, 0.05, 0.9], [0.0, 2e-5, 0.2, 0.7],
                                   [2e-3, 1e-6, 0.0, 0.0], [-1e-3, 5e-5, 0.3, 0.69]])
def test_nll_and_gradient_match_mcport(point):
    r = _garch_series(0)
    want, want_g = RG._nll_grad(jnp.asarray(point, jnp.float64), jnp.asarray(r))
    got, got_g = G.garch_nll(np.asarray(point), r)
    assert got == pytest.approx(float(want), rel=1e-9)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=1e-9, atol=0)


@pytest.mark.parametrize("series", ["weekly_btc", "weekly_eth", "simulated"])
def test_fit_garch_11_matches_mcport(weekly, series):
    r = {"weekly_btc": weekly[:, 0], "weekly_eth": weekly[:, 1],
         "simulated": _garch_series(1)}[series]
    got, want = G.fit_garch_11(r), RG.fit_garch_11(r)
    assert got.loglik == pytest.approx(want.loglik, rel=1e-7)
    v = float(np.var(r))
    for name, scale in (("mu", np.std(r)), ("omega", 10 * v), ("alpha", 1.0), ("beta", 1.0)):
        assert abs(getattr(got, name) - getattr(want, name)) <= 1e-4 * scale, name
    # the forecast state follows the parameters: eps_T moves with mu
    assert got.last_eps2 == pytest.approx(want.last_eps2, rel=1e-3)
    assert got.last_sigma2 == pytest.approx(want.last_sigma2, rel=1e-3)
    np.testing.assert_allclose(G.forecast_garch_variance(got, 12),
                               RG.forecast_garch_variance(want, 12), rtol=1e-3)


def test_forecast_garch_variance_matches_mcport():
    fit = RG.Garch11Fit(mu=1e-3, omega=2e-6, alpha=0.07, beta=0.91, last_eps2=3e-4,
                        last_sigma2=2.5e-4, loglik=0.0)
    got = G.forecast_garch_variance(G.Garch11Fit(**vars(fit)), 40)
    np.testing.assert_allclose(got, RG.forecast_garch_variance(fit, 40), rtol=1e-12)


def test_standardized_residuals_match_mcport(weekly):
    args = (weekly, REF.mu[:2], REF.omega[:2], REF.alpha[:2], REF.beta[:2])
    np.testing.assert_allclose(M.standardized_residuals(*args),
                               RM.standardized_residuals(*args), rtol=1e-9, atol=1e-12)


def test_estimate_ccc_garch_matches_mcport(weekly):
    rets = np.column_stack([weekly, _garch_series(2, weekly.shape[0])])
    got, want = M.estimate_ccc_garch(rets), RM.estimate_ccc_garch(rets)
    scale = {"mu": rets.std(0), "omega": 10 * rets.var(0), "alpha": 1.0, "beta": 1.0}
    for name, s in scale.items():
        assert np.all(np.abs(getattr(got, name).numpy() - getattr(want, name))
                      <= 1e-4 * s), name
    for name in ("sigma2_0", "eps2_0"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(got.corr_chol.numpy(), want.corr_chol, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="T>=20"):
        M.estimate_ccc_garch(rets[:10])


def test_convert_round_trip_is_exact():
    for name in ("mu", "omega", "alpha", "beta", "corr_chol", "sigma2_0", "eps2_0"):
        got = getattr(PARAMS, name)
        assert got.dtype == torch.float64
        assert np.array_equal(got.numpy(), getattr(REF, name)), name
    assert PARAMS.n_assets == A


# ---- in law against mcport's lax samplers -----------------------------------------

N, STEPS = 20_000, 16


def _quantile_se(x: np.ndarray, p: float) -> float:
    q = np.quantile(x, p)
    h = 0.02 * x.std()
    return float(np.sqrt(p * (1 - p) / x.size) / (np.mean(np.abs(x - q) < h) / (2 * h)))


def _es_se(x: np.ndarray, p: float) -> float:
    q = np.quantile(x, p)
    tail = x[x <= q]
    return float(np.sqrt((tail.var() + (1 - p) * (q - tail.mean()) ** 2) / (x.size * p)))


def _tail(x: np.ndarray, p: float = 0.05) -> tuple[float, float]:
    q = np.quantile(x, p)
    return float(q), float(x[x <= q].mean())


@pytest.mark.parametrize("t_df", [None, 5.5])
def test_terminal_returns_match_mcport_in_law(t_df):
    got = M.garch_terminal_returns(3, PARAMS, N, STEPS, t_df=t_df, device="cpu").double().numpy()
    want = np.asarray(RM.garch_terminal_returns(jax.random.key(3), REF, N, STEPS,
                                                jnp.float64, t_df=t_df))
    assert got.shape == want.shape == (N, A)
    se = np.sqrt((got.var(0) + want.var(0)) / N)
    assert np.all(np.abs(got.mean(0) - want.mean(0)) < 6 * se)
    np.testing.assert_allclose(got.std(0), want.std(0), rtol=0.06)
    assert abs(np.corrcoef(got, rowvar=False)[0, 1]
               - np.corrcoef(want, rowvar=False)[0, 1]) < 0.05
    port, ref_port = got @ W, want @ W
    var, cvar = _tail(port)
    ref_var, ref_cvar = _tail(ref_port)
    assert abs(var - ref_var) <= 4 * np.sqrt(2) * _quantile_se(port, 0.05)
    assert abs(cvar - ref_cvar) <= 4 * np.sqrt(2) * _es_se(port, 0.05)


def test_full_paths_compound_to_the_terminal():
    term, paths = M.simulate_garch_returns(4, PARAMS, 500, 9, full_paths=True, device="cpu")
    assert paths.shape == (500, 9, A)
    np.testing.assert_allclose(torch.prod(1.0 + paths.double(), dim=1).numpy() - 1.0,
                               term.numpy(), rtol=0, atol=2e-6)


def test_path_stats_match_mcport_in_law():
    cand = np.stack([W, np.full(A, 1 / A), np.eye(A)[1]])
    term, dd = (x.double().numpy() for x in M.garch_path_stats(5, PARAMS, cand, N, STEPS,
                                                               device="cpu"))
    rt, rd = (np.asarray(x) for x in RM.garch_path_stats(jax.random.key(5), REF, cand, N,
                                                         STEPS, jnp.float64))
    assert term.shape == dd.shape == rt.shape == (3, N)
    for c in range(3):
        se = np.sqrt((term[c].var() + rt[c].var()) / N)
        assert abs(term[c].mean() - rt[c].mean()) < 4 * se
        se_dd = np.sqrt((dd[c].var() + rd[c].var()) / N)
        assert abs(dd[c].mean() - rd[c].mean()) < 4 * se_dd
        q_se = _quantile_se(dd[c], 0.05)
        assert abs(np.quantile(dd[c], 0.05) - np.quantile(rd[c], 0.05)) < 4 * np.sqrt(2) * q_se
    assert (dd <= 0).all() and (dd >= -1).all()


def test_zero_volatility_is_the_closed_form():
    flat = from_mcport(RM.CCCGarchParams(
        mu=np.array([0.01, -0.005]), omega=np.zeros(2), alpha=np.zeros(2), beta=np.zeros(2),
        corr_chol=np.eye(2), sigma2_0=np.zeros(2), eps2_0=np.zeros(2)))
    out = M.garch_terminal_returns(1, flat, 64, 6, device="cpu").numpy()
    np.testing.assert_allclose(out[:, 0], 1.01 ** 6 - 1, rtol=1e-6)
    np.testing.assert_allclose(out[:, 1], 0.995 ** 6 - 1, rtol=1e-6)


def test_one_asset_candidate_is_the_terminal_gross():
    """With one asset and the weight 1, the candidate form's wealth is the
    terminal form's compounded gross (both on the same shocks)."""
    g = from_mcport(RM.CCCGarchParams(*(np.asarray(getattr(REF, f))[:1] if f != "corr_chol"
                                        else np.eye(1) for f in RM.CCCGarchParams
                                        .__dataclass_fields__))).tensors("cpu")
    term = O.garch_terminal(2, g, 300, 11)
    t5, _ = O.garch_multi_portfolio_dd(2, g, torch.ones((1, 1)), 300, 11)
    np.testing.assert_allclose(t5[0, 0].numpy(), term[0, :, 0].numpy(), rtol=0, atol=1e-6)


# ---- the kernel-vs-plain bound ----------------------------------------------------

def _bench(a: int = 15):
    s0 = np.full(a, 4e-4)
    rng = np.random.default_rng(a)
    return M.CCCGarchParams(*(torch.as_tensor(x) for x in (
        rng.normal(1e-3, 5e-4, a), 0.1 * s0, np.full(a, 0.08), np.full(a, 0.9),
        np.linalg.cholesky(0.5 * np.eye(a) + 0.5), s0, s0)))


INNOVATIONS = O.garch_innovations


def _lagged_variance(zc, g):
    """A fault: the innovation takes the previous step's variance."""
    s2, e2 = g.sigma2_0.expand(zc.shape[:-2] + zc.shape[-1:]), g.eps2_0
    out = []
    for t in range(zc.shape[-2]):
        eps = torch.sqrt(s2) * zc[..., t, :]
        s2 = g.omega + g.alpha * e2 + g.beta * s2
        e2 = eps * eps
        out.append(eps)
    return torch.stack(out, dim=-2)


def _no_beta(zc, g):
    """A fault: the variance forgets its own past (beta = 0)."""
    return INNOVATIONS(zc, g._replace(beta=torch.zeros_like(g.beta)))


def _uncorrelated(zc, g):
    """A fault: the shocks are not correlated."""
    z = torch.linalg.solve_triangular(torch.tril(g.corr_chol), zc.unsqueeze(-1),
                                      upper=False).squeeze(-1)
    return INNOVATIONS(z, g)


@pytest.mark.parametrize("fault", [_lagged_variance, _no_beta, _uncorrelated])
@pytest.mark.parametrize("steps", [7, 252])
def test_garch_tolerance_rejects_planted_faults(monkeypatch, fault, steps):
    """chip_smoke.py and tests/test_torch_cuda.py hold kernels #4 and #5 to
    ``garch_shares``; the plain form meets it against itself, and each
    planted fault exceeds it by at least 2x at the bench's 15 assets."""
    g = _bench().tensors("cpu")
    w = torch.as_tensor(np.random.default_rng(0).dirichlet(np.ones(15), 13),
                        dtype=torch.float32)
    kw = dict(first_block=6, n_blocks=2)
    right_t = O.garch_terminal_reference(11, g, 256, steps, **kw)
    right_c = O.garch_multi_dd_reference(11, g, w, 256, steps, with_bound=True, **kw)
    assert max(O.garch_shares(right_t, right_t, g, steps).values()) == 0.0
    monkeypatch.setattr(O, "garch_innovations", fault)
    wrong_t = O.garch_terminal_reference(11, g, 256, steps, **kw)
    wrong_c = O.garch_multi_dd_reference(11, g, w, 256, steps, **kw)
    assert O.garch_shares(wrong_t, right_t, g, steps)["term"] > 2.0
    assert max(O.garch_shares(wrong_c, right_c, g, steps).values()) > 2.0


def test_wrappers_check_their_inputs():
    g = _bench().tensors("cpu")
    # the plain forms take any width, and so does the card (past 64 assets its wide
    # layout, csrc/wide.cuh): a launch refuses an empty universe only
    assert O.garch_terminal(0, _bench(17).tensors("cpu"), 16, 4).shape == (1, 16, 17)
    O.check_card_assets(65, "GARCH")
    O.check_card_assets(200, "GARCH")
    with pytest.raises(ValueError, match="at least one asset"):
        O.check_card_assets(0, "GARCH")
    with pytest.raises(ValueError, match="float32"):
        O.garch_terminal(0, g._replace(mu=g.mu.double()), 16, 4)
    with pytest.raises(ValueError, match="weights must be"):
        O.garch_multi_portfolio_dd(0, g, torch.ones(3, 4), 16, 4)
    with pytest.raises(ValueError, match="no GARCH kernel"):
        O.garch_terminal(0, O.GarchTensors(*(x.to("meta") for x in g)), 16, 4)
