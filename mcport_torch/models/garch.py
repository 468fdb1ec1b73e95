"""GARCH(1,1): maximum-likelihood fit and variance forecast.

Port of ``mcport/models/garch.py``. The model is the constant-mean normal
GARCH(1,1)

    r_t = mu + eps_t,  eps_t ~ N(0, sigma2_t),
    sigma2_t = omega + alpha * eps_{t-1}^2 + beta * sigma2_{t-1},

with ``sigma2_0`` the sample variance (the backcast), fitted by scipy's
L-BFGS-B from mcport's three starts under mcport's bounds. The fit is host
math in float64, as in mcport.

mcport evaluates the negative log-likelihood as a ``lax.scan`` and its
gradient with ``jax.grad``. Here the variance recursion, which is linear in
``sigma2``, is one IIR filter (:func:`scipy.signal.lfilter`), and the gradient
is its adjoint, the same filter run backwards: no Python loop per step, so a
fit of hundreds of evaluations stays cheap. mcport's ``1e-12`` floor on
``sigma2`` cannot bind inside the bounds (``omega >= 1e-12``, ``alpha, beta >=
0``), so the filter computes the same function.

The forecast follows ``garch_fit.forecast(horizon=h)`` (app.py:349-350):
``sigma2_{T+1} = omega + alpha eps_T^2 + beta sigma2_T``, then ``sigma2_{T+k}
= omega + (alpha + beta) sigma2_{T+k-1}``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.signal import lfilter

__all__ = ["Garch11Fit", "fit_garch_11", "forecast_garch_variance", "garch_nll",
           "variance_path"]

_LOG2PI = float(np.log(2.0 * np.pi))
_STARTS = ((0.05, 0.90), (0.10, 0.80), (0.02, 0.95))   # (alpha, beta), mcport's


@dataclass(frozen=True)
class Garch11Fit:
    mu: float
    omega: float
    alpha: float
    beta: float
    last_eps2: float    # eps_T^2
    last_sigma2: float  # sigma2_T
    loglik: float


def variance_path(eps2: np.ndarray, omega, alpha, beta, sigma2_0) -> np.ndarray:
    """``sigma2_t`` for ``t = 0 .. T-1`` from the squared residuals ``eps2
    (T,)``: ``sigma2_0`` given, then ``sigma2_t = omega + alpha eps2_{t-1} +
    beta sigma2_{t-1}`` — one IIR filter."""
    out = np.empty(eps2.shape[0])
    out[0] = sigma2_0
    if eps2.shape[0] > 1:
        out[1:], _ = lfilter([1.0], [1.0, -beta], omega + alpha * eps2[:-1],
                             zi=[beta * sigma2_0])
    return out


def garch_nll(params: np.ndarray, r: np.ndarray) -> tuple[float, np.ndarray]:
    """(negative log-likelihood, its gradient) at ``params = (mu, omega,
    alpha, beta)`` for the series ``r (T,)`` — mcport's ``_nll`` and
    ``jax.grad`` of it.

    The gradient is the adjoint of the variance filter: ``lam_t = g_t + beta
    lam_{t+1}`` with ``g_t = (1/sigma2_t - eps2_t/sigma2_t^2) / 2`` the direct
    derivative by ``sigma2_t``, run backwards by the same filter.
    """
    mu, omega, alpha, beta = (float(x) for x in params)
    eps = r - mu
    e2 = eps * eps
    s2 = variance_path(e2, omega, alpha, beta, float(np.var(r)))
    nll = 0.5 * float(np.sum(_LOG2PI + np.log(s2) + e2 / s2))
    g = 0.5 * (1.0 / s2 - e2 / (s2 * s2))
    g[0] = 0.0                                   # sigma2_0 is the fixed backcast
    lam = lfilter([1.0], [1.0, -beta], g[::-1])[::-1]   # total d nll / d sigma2_t
    d_e2 = 0.5 / s2
    d_e2[:-1] += alpha * lam[1:]
    grad = np.array([float(np.sum(-2.0 * eps * d_e2)), float(np.sum(lam[1:])),
                     float(np.sum(lam[1:] * e2[:-1])), float(np.sum(lam[1:] * s2[:-1]))])
    return nll, grad


def fit_garch_11(returns) -> Garch11Fit:
    """Maximum-likelihood GARCH(1,1) of one return series (mcport's starts,
    bounds and optimizer)."""
    from scipy.optimize import minimize

    r = np.asarray(returns, np.float64)
    if r.size < 10:
        raise ValueError("series too short for GARCH(1,1)")
    v = float(np.var(r))
    bounds = [(None, None), (1e-12, 10.0 * v + 1e-12), (0.0, 0.999), (0.0, 0.999)]
    best = None
    for a0, b0 in _STARTS:
        p0 = np.array([r.mean(), v * (1 - a0 - b0), a0, b0])
        res = minimize(garch_nll, p0, args=(r,), jac=True, method="L-BFGS-B",
                       bounds=bounds)
        if best is None or res.fun < best.fun:
            best = res
    mu, omega, alpha, beta = map(float, best.x)
    eps = r - mu
    s2 = variance_path(eps * eps, omega, alpha, beta, v)
    return Garch11Fit(mu=mu, omega=omega, alpha=alpha, beta=beta,
                      last_eps2=float(eps[-1] ** 2), last_sigma2=float(s2[-1]),
                      loglik=-float(best.fun))


def forecast_garch_variance(fit: Garch11Fit, horizon: int) -> np.ndarray:
    """(horizon,) per-step conditional variance forecast (app.py:349-350)."""
    out = np.empty(horizon)
    s2 = fit.omega + fit.alpha * fit.last_eps2 + fit.beta * fit.last_sigma2
    for k in range(horizon):
        out[k] = s2
        s2 = fit.omega + (fit.alpha + fit.beta) * s2
    return out
