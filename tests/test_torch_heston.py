"""The port's Heston family (``models/heston.py``, ``ops/heston.py``) against
mcport's, on the CPU.

- Deterministic: ``_ewma_variance`` and ``estimate_heston(method="moment")``
  equal mcport's to 1e-9 on the weekly fixtures and a simulated series; the
  QMLE objective and its gradient (``qmle_nll_grad``, a NumPy forward filter
  and its adjoint) equal mcport's ``jax.value_and_grad`` of its ``lax.scan``
  to 1e-6 relative at identical points, with and without the variance floor
  binding (XLA:CPU's float64 transcendentals are only float32-accurate);
  ``_qmle_filter`` equals mcport's. ``fit_heston_qmle`` on a simulated
  strong-leverage series and on a pure-GBM series reaches mcport's
  quasi-log-likelihood within 1e-6 relative, parameters within 1e-4 of their
  scales and the same side of the LRT gate (each series' LRT, printed, lies
  far from 3.84). On series where the filter grazes its 1e-8 floor the
  likelihood has near-singular kinks and the two L-BFGS-B runs may stop
  apart (mcport's line search ends abnormally): such series are not used.
- Stochastic, in law (Philox against Threefry): terminal returns and
  candidate paths against mcport's lax references at 20,000 paths (means
  within 6 and 4 standard errors of the difference, deviations within 6%,
  the drawdown quantile within 4); with xi = 0 and v0 = theta the law is the
  GBM family's.
- The kernels' design: at a Feller-violating xi a 2-ulp change of the shocks
  grows to O(1) within 252 steps, which is why the kernels round their path
  state as the plain form does; ``heston_shares`` rejects planted faults by
  at least 2x.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import minimize

from mcport.config import DataConfig as RefDataConfig
from mcport.data import load_universe as ref_load
from mcport.models import heston as RH
from mcport_torch.convert import from_mcport
from mcport_torch.models import heston as H
from mcport_torch.ops import heston as O
from mcport_torch.ops.gbm import sqrt_rn

torch.set_num_threads(1)   # the suite runs several xdist workers on shared cores

A = 3
REF = RH.HestonParams(
    mu=np.array([8e-4, 1e-3, 5e-4]), kappa=np.array([0.15, 0.1, 0.2]),
    theta=np.array([4e-4, 3e-4, 5e-4]), xi=np.array([3e-3, 4e-3, 2e-3]),
    rho=np.array([-0.5, -0.7, -0.3]), v0=np.array([4e-4, 2e-4, 6e-4]),
    corr_chol=np.linalg.cholesky(np.array([[1.0, 0.6, 0.3], [0.6, 1.0, 0.4],
                                           [0.3, 0.4, 1.0]])),
    s0=np.array([100.0, 50.0, 20.0]))
PARAMS = from_mcport(REF)
W = np.array([0.5, 0.3, 0.2])


def _heston_prices(seed: int, n: int, mu=5e-4, kappa=0.05, theta=2e-4, xi=4e-3,
                   rho=-0.9) -> np.ndarray:
    """A one-asset Heston price history (full-truncation Euler, numpy
    normals); ``xi = 0`` is GBM at variance ``theta``."""
    rng = np.random.default_rng(seed)
    v, x = theta, np.empty(n)
    for t in range(n):
        z, w = rng.standard_normal(2)
        zv = rho * z + np.sqrt(1 - rho * rho) * w
        vp = max(v, 0.0)
        x[t] = mu - 0.5 * vp + np.sqrt(vp) * z
        v = v + kappa * (theta - vp) + xi * np.sqrt(vp) * zv
    return 100.0 * np.exp(np.concatenate([[0.0], np.cumsum(x)]))[:, None]


@pytest.fixture(scope="module")
def weekly_prices(fixtures_dir):
    paths = sorted(str(p) for p in fixtures_dir.glob("*7 Years Weekly.csv"))
    return ref_load(paths=paths, config=RefDataConfig(period="W")).prices


_FIELDS = ("mu", "kappa", "theta", "xi", "rho", "v0", "corr_chol", "s0")


@pytest.mark.parametrize("series", ["weekly", "simulated"])
def test_moment_estimator_matches_mcport(weekly_prices, series):
    prices = (weekly_prices if series == "weekly" else
              np.hstack([_heston_prices(1, 500), _heston_prices(2, 500, rho=-0.3)]))
    got, want = (H.estimate_heston(prices, method="moment"),
                 RH.estimate_heston(prices, method="moment"))
    for name in _FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name), rtol=1e-9,
                                   atol=1e-15, err_msg=name)
    logret = np.diff(np.log(prices), axis=0)
    np.testing.assert_allclose(H._ewma_variance(logret), RH._ewma_variance(logret), rtol=1e-9)
    with pytest.raises(ValueError, match="T>=20"):
        H.estimate_heston(prices[:10], method="moment")
    with pytest.raises(ValueError, match="method"):
        H.estimate_heston(prices, method="mle")


_R = np.random.default_rng(0).standard_t(4, 600) * 0.8 + 0.05


@pytest.mark.parametrize("point", [[0.05, 0.1, 1.0, -0.3], [0.0, 0.5, 0.9, 0.8],
                                   [0.02, 0.05, 1.1, -0.05], [-0.05, 1.4, 0.5, 0.9]])
def test_qmle_objective_and_gradient_match_mcport(point):
    """The last two points bind the 1e-8 floor (many times at the last)."""
    want, want_g = RH._qmle_nll_grad(jnp.asarray(point, jnp.float64), jnp.asarray(_R), 0.03)
    got, got_g = H.qmle_nll_grad(np.asarray(point), _R, 0.03)
    assert got == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=1e-6, atol=0)
    z, v_end = H._qmle_filter(np.asarray(point), _R, 0.03)
    z_ref, v_ref = RH._qmle_filter(np.asarray(point), _R, 0.03)
    np.testing.assert_allclose(z, z_ref, rtol=1e-12)
    assert v_end == pytest.approx(v_ref, rel=1e-12)


def _lrt(prices) -> float:
    """The leverage LRT of a one-asset series: the port's free fit from
    mcport's starts against a c = 0 refit from its optimum."""
    lr = np.diff(np.log(prices[:, 0]))
    s = lr.std(ddof=1)
    r = lr / s
    vbar = np.var(r)
    bounds = [(None, None), (1e-3, 1.5), (1e-6, 10 * vbar + 1e-6), (-0.9, 0.9)]
    mm = H.estimate_heston(prices, method="moment")
    p_mm = np.array([float(mm.mu[0]) / s, float(mm.kappa[0]), float(mm.theta[0]) / s**2,
                     np.clip(float(mm.xi[0] * mm.rho[0]) / s, -0.85, 0.85)])

    def fun(p):
        return H.qmle_nll_grad(p, r, s)

    starts = [p_mm, np.r_[p_mm[0], 0.1, p_mm[2], -0.1], np.r_[p_mm[0], 0.5, p_mm[2], 0.0]]
    best = min((minimize(fun, p0, jac=True, method="L-BFGS-B", bounds=bounds)
                for p0 in starts), key=lambda res: res.fun)
    b0 = list(bounds)
    b0[3] = (0.0, 0.0)
    p0 = best.x.copy()
    p0[3] = 0.0
    res0 = minimize(fun, p0, jac=True, method="L-BFGS-B", bounds=b0)
    return max(2.0 * (res0.fun - best.fun), 0.0)


@pytest.mark.parametrize("series", ["leverage", "gbm"])
def test_fit_heston_qmle_matches_mcport(series):
    prices = (_heston_prices(4, 800) if series == "leverage" else
              _heston_prices(0, 1000, xi=0.0, rho=0.0))
    lrt = _lrt(prices)
    print(f"{series}: LRT {lrt:.2f} (gate 3.84)")
    assert (lrt > 30.0) if series == "leverage" else (lrt < 2.0)
    got, want = H.fit_heston_qmle(prices), RH.fit_heston_qmle(prices)
    lr = np.diff(np.log(prices[:, 0]))
    s = lr.std(ddof=1)

    def qll(p):
        point = [float(p.mu[0]) / s, float(p.kappa[0]), float(p.theta[0]) / s**2,
                 float(p.xi[0] * p.rho[0]) / s]
        return -H.qmle_nll_grad(point, lr / s, s)[0]

    assert qll(got) == pytest.approx(qll(from_mcport(want)), rel=1e-6)
    scale = {"mu": s, "kappa": 1.0, "theta": s * s, "xi": np.sqrt(2 * 0.05 * s * s),
             "rho": 1.0, "v0": s * s}
    for name, sc in scale.items():
        assert abs(float(getattr(got, name)[0]) - float(getattr(want, name)[0])) <= 1e-4 * sc, name
    # the same side of the gate: a leverage fit keeps |rho| well away from 0,
    # a GBM fit's rho is shrunk by LRT / 3.84
    assert (abs(float(got.rho[0])) > 0.3) == (series == "leverage")


def test_estimate_heston_defaults_to_the_qmle():
    prices = np.hstack([_heston_prices(5, 400), _heston_prices(6, 400, rho=-0.5)])
    got = H.estimate_heston(prices)
    want = RH.estimate_heston(prices)
    for name in ("mu", "kappa", "theta", "v0"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name), rtol=1e-3,
                                   err_msg=name)
    np.testing.assert_allclose(got.corr_chol.numpy(), want.corr_chol, atol=1e-3)


# ---- the samplers, in law -------------------------------------------------------

N, STEPS = 20_000, 16


def _quantile_se(x: np.ndarray, p: float) -> float:
    q = np.quantile(x, p)
    h = 0.02 * x.std()
    return float(np.sqrt(p * (1 - p) / x.size) / (np.mean(np.abs(x - q) < h) / (2 * h)))


def test_terminal_returns_match_mcport_in_law():
    got = H.heston_terminal_returns(3, PARAMS, N, STEPS, device="cpu").double().numpy()
    want = np.asarray(RH.heston_terminal_returns(jax.random.key(3), REF, N, STEPS,
                                                 jnp.float32), np.float64)
    assert got.shape == want.shape == (N, A)
    se = np.sqrt((got.var(0) + want.var(0)) / N)
    assert np.all(np.abs(got.mean(0) - want.mean(0)) < 6 * se)
    np.testing.assert_allclose(got.std(0), want.std(0), rtol=0.06)
    assert np.all(np.abs(np.corrcoef(got, rowvar=False) - np.corrcoef(want, rowvar=False))
                  < 0.05)


def test_full_paths_sum_to_the_terminal():
    term, x = H.simulate_heston_returns(4, PARAMS, 500, 9, full_paths=True, device="cpu")
    assert x.shape == (500, 9, A)
    acc = torch.zeros_like(x[:, 0])
    for t in range(9):
        acc = acc + x[:, t]
    assert torch.equal(torch.expm1(acc), term)
    assert torch.equal(term, H.heston_terminal_returns(4, PARAMS, 500, 9, device="cpu"))


def test_path_stats_match_mcport_in_law():
    cand = np.stack([W, np.full(A, 1 / A), np.eye(A)[1]])
    term, dd = (x.double().numpy() for x in H.heston_path_stats(5, PARAMS, cand, N, STEPS,
                                                                device="cpu"))
    rt, rd = (np.asarray(x, np.float64) for x in RH.heston_path_stats(
        jax.random.key(5), REF, cand, N, STEPS))
    assert term.shape == dd.shape == rt.shape == (3, N)
    for c in range(3):
        se = np.sqrt((term[c].var() + rt[c].var()) / N)
        assert abs(term[c].mean() - rt[c].mean()) < 4 * se
        se_dd = np.sqrt((dd[c].var() + rd[c].var()) / N)
        assert abs(dd[c].mean() - rd[c].mean()) < 4 * se_dd
        q_se = _quantile_se(dd[c], 0.05)
        assert abs(np.quantile(dd[c], 0.05) - np.quantile(rd[c], 0.05)) < 4 * np.sqrt(2) * q_se
    assert (dd <= 0).all() and (dd >= -1).all()


def test_frozen_variance_is_the_gbm_law():
    """xi = 0 and v0 = theta freeze the variance: each step is GBM's ``(mu -
    theta/2) + sqrt(theta) zc``, exactly on the same shocks, and in law N(n
    (mu - theta/2), n theta R)."""
    frozen = from_mcport(RH.HestonParams(**{**REF.__dict__, "xi": np.zeros(A),
                                             "v0": REF.theta}))
    h = frozen.tensors("cpu")
    zc, w = O.heston_shocks(7, h, 4_000, 12)
    x = O.heston_increments(zc, w, h)
    gbm = (h.mu - 0.5 * h.theta) + torch.sqrt(h.theta) * zc
    assert torch.equal(x, gbm)
    term = np.log1p(H.heston_terminal_returns(7, frozen, 4_000, 12, device="cpu")
                    .double().numpy())
    mean = 12 * (REF.mu - REF.theta / 2)
    se = np.sqrt(12 * REF.theta / 4_000)
    assert np.all(np.abs(term.mean(0) - mean) < 5 * se)
    np.testing.assert_allclose(term.var(0), 12 * REF.theta, rtol=0.1)


# ---- the kernels' design: chaos at a Feller-violating xi, and the bound ------------

def _bench(a: int = 15, xi: float = 3e-3):
    rng = np.random.default_rng(a)
    full = np.ones(a)
    return H.HestonParams(*(torch.as_tensor(x) for x in (
        rng.normal(1e-3, 5e-4, a), 0.15 * full, 4e-4 * full, xi * full, -0.5 * full,
        4e-4 * full, np.linalg.cholesky(0.5 * np.eye(a) + 0.5), full))).tensors("cpu")


@pytest.mark.parametrize("xi, grows", [(3e-3, False), (0.05, True)])
def test_rounding_grows_chaotically_where_feller_fails(xi, grows):
    """A 2-ulp change of the shocks moves the terminal log return by less than
    1e-5 at the bench's xi, and by more than 1e-2 within 252 steps at xi =
    0.05, where sqrt at v ~ 0 magnifies it: a kernel that rounds differently
    from the plain form could not be held to it there."""
    h = _bench(15, xi)
    zc, w = O.heston_shocks(11, h, 512, 252, first_block=6)
    g = torch.Generator().manual_seed(0)
    nudge = 2 * 2.0 ** -24
    zc2 = zc * (1 + nudge * torch.randn(zc.shape, generator=g))
    w2 = w * (1 + nudge * torch.randn(w.shape, generator=g))
    d = (O.heston_increments(zc, w, h).sum(-2) - O.heston_increments(zc2, w2, h).sum(-2)).abs()
    assert (float(d.max()) > 1e-2) if grows else (float(d.max()) < 1e-5)


def test_plain_form_rounds_as_ieee_float32():
    """The kernels' sqrtf is correctly rounded and torch's vectorised CPU
    float32 sqrt is not always (some results an ulp off), which made the CPU
    plain form differ from the card's where the path is chaotic. ``sqrt_rn``
    is IEEE's root, and the Heston increments equal a NumPy float32
    emulation, one rounding per operation, at a Feller-violating xi."""
    x = np.abs(np.random.default_rng(1).normal(0, 1, 1_000_000)).astype(np.float32)
    assert np.array_equal(sqrt_rn(torch.from_numpy(x)).numpy(), np.sqrt(x))
    h = _bench(15, 0.05)
    zc, w = O.heston_shocks(3, h, 2_048, 16)
    got = O.heston_increments(zc, w, h).numpy()
    mu, kappa, theta, xi, rho = (getattr(h, k).numpy() for k in ("mu", "kappa", "theta",
                                                                  "xi", "rho"))
    rho_c = np.sqrt(np.float32(1) - rho * rho)
    v = np.broadcast_to(h.v0.numpy(), zc.shape[:-2] + zc.shape[-1:]).copy()
    want = []
    for t in range(16):
        zct = zc[..., t, :].numpy()
        zv = rho * zct + rho_c * w[..., t, :].numpy()
        vp = np.maximum(v, np.float32(0))
        sv = np.sqrt(vp)
        want.append((mu - np.float32(0.5) * vp) + sv * zct)
        v = v + kappa * (theta - vp) + xi * sv * zv
    assert np.array_equal(got, np.stack(want, axis=-2))


INCREMENTS = O.heston_increments


def _variance_from_vp(zc, w, h):
    """A fault: the variance update adds to vp, not v."""
    v = h.v0.expand(zc.shape[:-2] + zc.shape[-1:])
    out = []
    for t in range(zc.shape[-2]):
        zv = h.rho * zc[..., t, :] + h.rho_c * w[..., t, :]
        vp = torch.clamp_min(v, 0.0)
        sv = torch.sqrt(vp)
        out.append((h.mu - 0.5 * vp) + sv * zc[..., t, :])
        v = vp + h.kappa * (h.theta - vp) + h.xi * sv * zv
    return torch.stack(out, dim=-2)


def _no_leverage(zc, w, h):
    """A fault: the variance shock ignores the return shock (rho = 0)."""
    return INCREMENTS(zc, w, h._replace(rho=torch.zeros_like(h.rho)))


def _rho_c_in_float64(zc, w, h):
    """A fault of rounding alone: sqrt(1 - rho^2) in float64, then float32."""
    class Shifted(O.HestonTensors):
        @property
        def rho_c(self):
            return torch.sqrt(1.0 - self.rho.double() ** 2).to(torch.float32) * (1 + 2**-23)
    return INCREMENTS(zc, w, Shifted(*h))


@pytest.mark.parametrize("fault", [_variance_from_vp, _no_leverage, _rho_c_in_float64])
def test_heston_tolerance_rejects_planted_faults(monkeypatch, fault):
    """chip_smoke.py and tests/test_torch_cuda.py hold kernels #9 and #10 to
    ``heston_shares``; the plain form meets it against itself, and each
    planted fault exceeds it by at least 2x at the bench's 15 assets and a
    Feller-violating xi."""
    h = _bench(15, 0.05)
    w = torch.as_tensor(np.random.default_rng(0).dirichlet(np.ones(15), 13),
                        dtype=torch.float32)
    kw = dict(first_block=6, n_blocks=2)
    right_t = O.heston_terminal_reference(11, h, 256, 63, **kw)
    right_c = O.heston_multi_dd_reference(11, h, w, 256, 63, **kw)
    assert max(O.heston_shares(right_t, right_t, h, 63).values()) == 0.0
    assert max(O.heston_shares(right_c, right_c, h, 63).values()) == 0.0
    monkeypatch.setattr(O, "heston_increments", fault)
    wrong_t = O.heston_terminal_reference(11, h, 256, 63, **kw)
    wrong_c = O.heston_multi_dd_reference(11, h, w, 256, 63, **kw)
    assert O.heston_shares(wrong_t, right_t, h, 63)["term"] > 2.0
    assert max(O.heston_shares(wrong_c, right_c, h, 63).values()) > 2.0


def test_wrappers_check_their_inputs():
    h = _bench(3)
    # the plain forms take any width, and so does the card (past 64 assets its wide
    # layout, csrc/wide.cuh): a launch refuses an empty universe only
    assert O.heston_terminal(0, _bench(17), 16, 4).shape == (1, 16, 17)
    O.check_card_assets(65, "Heston")
    O.check_card_assets(200, "Heston")
    with pytest.raises(ValueError, match="at least one asset"):
        O.check_card_assets(0, "Heston")
    with pytest.raises(ValueError, match="float32"):
        O.heston_terminal(0, h._replace(mu=h.mu.double()), 16, 4)
    with pytest.raises(ValueError, match="weights must be"):
        O.heston_multi_portfolio_dd(0, h, torch.ones(3, 4), 16, 4)
    with pytest.raises(ValueError, match="no Heston kernel"):
        O.heston_terminal(0, O.HestonTensors(*(x.to("meta") for x in h)), 16, 4)
