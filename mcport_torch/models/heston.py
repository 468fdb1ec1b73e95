"""Heston stochastic-volatility family: parameters, calibration and samplers.

Port of ``mcport/models/heston.py``. Per-asset square-root (CIR) variance with
cross-asset correlated return shocks, full-truncation Euler (dt = 1 analysis
period):

    x_{t,a}   = (mu_a - v+_{t,a}/2) + sqrt(v+_{t,a}) zc_{t,a}    (log return)
    v_{t+1,a} = v_{t,a} + kappa_a (theta_a - v+_{t,a})
                + xi_a sqrt(v+_{t,a}) zv_{t,a}
    zc = L_R z,  zv_a = rho_a zc_a + sqrt(1 - rho_a^2) w_a

with ``v+ = max(v, 0)``. With ``xi = 0`` and ``v0 = theta`` the variance is
frozen and the model is the GBM family's per-step law.

Calibration (float64 host math, as in mcport): :func:`estimate_heston` with
``method="moment"`` is the moment match of mcport's module docstring; the
default ``"qmle"`` refines ``(mu, kappa, theta, c = xi rho)`` per asset by the
leverage-filter quasi-likelihood (:func:`fit_heston_qmle`, mcport's starts,
fallback, c = 0 refit and LRT gate). mcport differentiates a ``lax.scan`` of
the filter with ``jax.value_and_grad``; here :func:`qmle_nll_grad` is NumPy:
between floor hits the filter is linear in the variance (``c sqrt(vp) z = c
(r - mu + vp sd / 2)``), so each stretch is one IIR filter
(:func:`scipy.signal.lfilter`), restarted where the ``1e-8`` floor binds, and
the gradient is the adjoint filter run backwards, which the floor cuts (its
derivative is 0 there).

Samplers: :func:`simulate_heston_returns` and :func:`heston_path_stats` are
the plain torch forms on the port's Philox counters (one block keyed by
``seed``); :func:`heston_terminal_returns` launches the terminal kernel on the
card (:mod:`mcport_torch.ops.heston`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from scipy.signal import lfilter

from mcport_torch.ops.heston import (
    HestonTensors,
    heston_increments,
    heston_multi_dd_reference,
    heston_shocks,
    heston_terminal,
    heston_terminal_reference,
)

__all__ = ["HestonParams", "estimate_heston", "fit_heston_qmle", "qmle_nll_grad",
           "simulate_heston_returns", "heston_terminal_returns", "heston_path_stats",
           "EWMA_LAMBDA"]

EWMA_LAMBDA = 0.94   # RiskMetrics decay for the variance proxy / v0
_LRT_95 = 3.84       # chi2_1 95% critical value: the leverage pretest's gate
_FLOOR = 1e-8        # the filter's variance floor (standardised scale)
_LOG2PI = float(np.log(2.0 * np.pi))


def _f64(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float64))


@dataclass(frozen=True)
class HestonParams:
    """Per-asset CIR variance with leverage and the cross-asset shock
    correlation, per analysis step, as float64 CPU tensors."""

    mu: torch.Tensor          # (A,) per-step log drift (E[x] = mu - v/2)
    kappa: torch.Tensor       # (A,) variance mean-reversion speed per step
    theta: torch.Tensor       # (A,) long-run variance per step
    xi: torch.Tensor          # (A,) vol-of-vol per step
    rho: torch.Tensor         # (A,) leverage corr(return shock, variance shock)
    v0: torch.Tensor          # (A,) initial variance (today's state)
    corr_chol: torch.Tensor   # (A, A) Cholesky of the cross-asset shock corr R
    s0: torch.Tensor          # (A,) spot prices

    @property
    def n_assets(self) -> int:
        return self.mu.shape[-1]

    def tensors(self, device: torch.device | str) -> HestonTensors:
        """The float32 parameters the kernels take, on ``device``."""
        return HestonTensors(*(torch.as_tensor(getattr(self, f)).to(device, torch.float32)
                               for f in HestonTensors._fields))


def _ewma_variance(logret: np.ndarray, lam: float = EWMA_LAMBDA) -> np.ndarray:
    """(T, A) EWMA variance proxy, seeded at the sample variance."""
    eps = logret - logret.mean(axis=0)
    v = np.empty_like(eps)
    v[0] = eps.var(axis=0)
    for t in range(1, eps.shape[0]):
        v[t] = lam * v[t - 1] + (1.0 - lam) * eps[t - 1] ** 2
    return v


def estimate_heston(prices, jitter: float = 1e-10, method: str = "qmle") -> HestonParams:
    """Heston calibration from a (T, A) price matrix: ``"qmle"`` (default)
    refines the moment match by :func:`fit_heston_qmle`; ``"moment"`` is the
    raw moment match (kappa from the acf ratio of squared returns, xi from the
    conditional kurtosis capped at the Feller bound, rho from the leverage
    moment, R from EWMA-standardised returns, v0 the last EWMA variance)."""
    if method not in ("qmle", "moment"):
        raise ValueError(f"method must be 'qmle' or 'moment', got {method!r}")
    if method == "qmle":
        return fit_heston_qmle(prices, jitter=jitter)
    prices = np.asarray(prices, np.float64)
    if prices.ndim != 2 or prices.shape[0] < 20:
        raise ValueError("estimate_heston needs a (T>=20, A) price matrix")
    logret = np.diff(np.log(prices), axis=0)            # (T-1, A)
    a = logret.shape[1]
    eps = logret - logret.mean(axis=0)
    theta = np.maximum(logret.var(axis=0, ddof=1), 1e-12)

    sq = eps**2
    sqc = sq - sq.mean(axis=0)
    c1 = (sqc[:-1] * sqc[1:]).mean(axis=0)
    c2 = (sqc[:-2] * sqc[2:]).mean(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        phi = np.where(c1 > 0, c2 / np.maximum(c1, 1e-300), 0.5)
    phi = np.clip(np.nan_to_num(phi, nan=0.5), 0.0, 0.999)
    kappa = np.clip(1.0 - phi, 1e-3, 1.5)

    var_v = np.maximum((eps**4).mean(axis=0) / 3.0 - theta**2, 0.0)
    xi = np.minimum(np.sqrt(2.0 * kappa * var_v / theta),
                    np.sqrt(2.0 * kappa * theta))       # Feller: 2 k th >= xi^2

    lev = (eps[:-1] * sq[1:]).mean(axis=0) - eps[:-1].mean(axis=0) * sq.mean(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        rho = np.where(xi > 1e-12, lev / np.maximum(xi * theta, 1e-300), 0.0)
    rho = np.clip(np.nan_to_num(rho), -0.95, 0.95)

    v_proxy = _ewma_variance(logret)
    z = eps / np.sqrt(np.maximum(v_proxy, 1e-12))
    corr = np.atleast_2d(np.corrcoef(z, rowvar=False))
    chol = np.linalg.cholesky(corr + jitter * np.eye(a))
    v0 = np.maximum(EWMA_LAMBDA * v_proxy[-1] + (1.0 - EWMA_LAMBDA) * eps[-1] ** 2, 1e-12)
    mu = logret.mean(axis=0) + theta / 2.0
    return HestonParams(*(_f64(x) for x in (mu, kappa, theta, xi, rho, v0, chol,
                                            prices[-1])))


def _filter_variance(a: float, b: np.ndarray, v0: float,
                     window: int = 128) -> tuple[np.ndarray, np.ndarray]:
    """``(v, vp)`` of ``vp_t = max(v_t, floor)``, ``v_{t+1} = a vp_t + b_t``
    from ``v_0 = v0``, for ``t < len(b)``: IIR filters over at most
    ``window`` steps at a time, each restarted at the first floor hit."""
    n = b.shape[0]
    v, vp = np.empty(n), np.empty(n)
    t, v_t = 0, v0
    while t < n:
        start = max(v_t, _FLOOR)
        m = min(window, n - t)
        y = np.empty(m + 1)
        y[0] = start
        y[1:], _ = lfilter([1.0], [1.0, -a], b[t:t + m], zi=[a * start])
        low = np.flatnonzero(y[1:m] < _FLOOR)
        k = m if low.size == 0 else int(low[0]) + 1     # steps t .. t+k-1 settled
        v[t] = v_t
        v[t + 1:t + k] = y[1:k]
        vp[t:t + k] = y[:k]
        t, v_t = t + k, y[k]
    return v, vp


def qmle_nll_grad(params, r: np.ndarray, sd: float) -> tuple[float, np.ndarray]:
    """(negative Gaussian quasi-log-likelihood, its gradient) of the leverage
    filter at ``params = (mu, kappa, theta, c)`` on standardised returns ``r
    (T,)`` — mcport's ``_qmle_nll`` and ``jax.value_and_grad`` of it:

        vp_t = max(v_t, 1e-8),  resid_t = r_t - mu + vp_t sd / 2
        nll  = sum_t (log(2 pi vp_t) + resid_t^2 / vp_t) / 2
        v_{t+1} = vp_t + kappa (theta - vp_t) + c resid_t,  v_0 = var(r).
    """
    mu, kappa, theta, c = (float(x) for x in params)
    a = 1.0 - kappa + 0.5 * c * sd
    v, vp = _filter_variance(a, kappa * theta + c * (r - mu), float(np.var(r)))
    resid = r - mu + 0.5 * sd * vp
    nll = 0.5 * float(np.sum(_LOG2PI + np.log(vp) + resid * resid / vp))
    # d nll / d vp_t directly, then the adjoint lam_t = d nll / d v_t: 0 where
    # the floor holds vp, else d_t + a lam_{t+1}, run backwards per stretch
    d = 0.5 * (1.0 / vp - resid * resid / (vp * vp)) + 0.5 * sd * resid / vp
    free = v > _FLOOR
    lam = np.zeros(r.shape[0] + 1)
    edges = np.flatnonzero(np.diff(np.concatenate([[False], free, [False]]).astype(np.int8)))
    for s, e in zip(edges[::2], edges[1::2]):      # free stretches [s, e)
        lam[s:e] = lfilter([1.0], [1.0, -a], d[s:e][::-1])[::-1]
    nxt = lam[1:]                                   # lam_{t+1} for each step t
    grad = np.array([float(np.sum(-resid / vp) - c * np.sum(nxt)),
                     float(np.sum(nxt * (theta - vp))),
                     float(kappa * np.sum(nxt)),
                     float(np.sum(nxt * resid))])
    return nll, grad


def _qmle_filter(params, r: np.ndarray, sd: float):
    """(standardised residuals z_t, filter end state vhat_{T+1})."""
    mu, kappa, theta, c = params
    v = float(np.var(r))
    z = np.empty_like(r)
    for t, r_t in enumerate(r):
        vp = max(v, _FLOOR)
        z[t] = (r_t - mu + 0.5 * vp * sd) / np.sqrt(vp)
        v = vp + kappa * (theta - vp) + c * np.sqrt(vp) * z[t]
    return z, max(v, _FLOOR)


def fit_heston_qmle(prices, init: HestonParams | None = None,
                    jitter: float = 1e-10) -> HestonParams:
    """Leverage-filter QMLE refinement of the moment-matched calibration —
    mcport's ``fit_heston_qmle``: per asset, L-BFGS-B over ``(mu, kappa,
    theta, c)`` on standardised returns from the moment match and two spread
    starts; the moment match kept where the fit does not improve on it or
    degenerates; a ``c = 0`` refit whose likelihood ratio gates the leverage
    (at 3.84 xi is floored at ``|c| / 0.95``, below it rho is shrunk by
    ``LRT / 3.84``); xi from the conditional-kurtosis and autocovariance
    moments at the refined ``(kappa, theta)``, Feller-capped; v0 the filter's
    end state; R re-estimated from the filter-standardised residuals."""
    from scipy.optimize import minimize

    prices = np.asarray(prices, np.float64)
    if init is None:
        init = estimate_heston(prices, jitter=jitter, method="moment")
    logret = np.diff(np.log(prices), axis=0)
    a = logret.shape[1]
    sd = np.maximum(logret.std(axis=0, ddof=1), 1e-12)
    mu, kappa, theta, xi, rho, v0 = (init.mu.numpy().copy(), init.kappa.numpy().copy(),
                                     init.theta.numpy().copy(), init.xi.numpy().copy(),
                                     init.rho.numpy().copy(), init.v0.numpy().copy())
    z_resid = np.empty_like(logret)

    for i in range(a):
        s = float(sd[i])
        r = logret[:, i] / s
        vbar = float(np.var(r))

        def fun(p, r=r, s=s):
            return qmle_nll_grad(p, r, s)

        bounds = [(None, None), (1e-3, 1.5), (1e-6, 10.0 * vbar + 1e-6), (-0.9, 0.9)]
        p_mm = np.array([mu[i] / s, kappa[i], theta[i] / (s * s),
                         np.clip(xi[i] * rho[i] / s, -0.85, 0.85)])
        nll_mm = fun(p_mm)[0]
        best = None
        for k0, c0 in ((None, None), (0.10, -0.10), (0.50, 0.0)):
            p0 = p_mm.copy()
            if k0 is not None:
                p0[1], p0[3] = k0, c0
            res = minimize(fun, p0, jac=True, method="L-BFGS-B", bounds=bounds)
            if np.isfinite(res.fun) and (best is None or res.fun < best.fun):
                best = res
        degenerate = best is not None and (best.x[1] <= 1.5e-3 or best.x[2] <= 2e-6)
        if best is None or best.fun > nll_mm + 1e-9 or degenerate:
            p_use = p_mm         # keep the moment match; R still needs residuals
        else:
            # leverage LRT: refit with c pinned to 0 from the free optimum; a
            # refit that slides past the free optimum replaces it (LRT 0)
            b0 = list(bounds)
            b0[3] = (0.0, 0.0)
            p0 = np.asarray(best.x, np.float64).copy()
            p0[3] = 0.0
            res0 = minimize(fun, p0, jac=True, method="L-BFGS-B", bounds=b0)
            if np.isfinite(res0.fun) and res0.fun < best.fun:
                best = res0
            lrt = max(2.0 * (float(res0.fun) - float(best.fun)), 0.0)
            p_use = np.asarray(best.x, np.float64)
            mu_q, kappa_q, theta_q, c_q = p_use
            mu[i] = mu_q * s
            kappa[i] = kappa_q
            theta[i] = max(theta_q * s * s, 1e-12)
            c_abs = c_q * s                       # xi*rho on the return scale
            eps = logret[:, i] - logret[:, i].mean()
            sq = eps**2
            sqc = sq - sq.mean()
            c1 = float((sqc[:-1] * sqc[1:]).mean())
            var_v = max(float((eps**4).mean()) / 3.0 - theta[i] ** 2, 0.0)
            if kappa[i] < 0.999:      # c1 = (1 - kappa) Var(v) informs only below 1
                var_v = max(var_v, c1 / (1.0 - kappa[i]))
            xi_q = np.sqrt(2.0 * kappa[i] * var_v / theta[i])
            feller = np.sqrt(2.0 * kappa[i] * theta[i])
            if lrt >= _LRT_95:
                xi_q = min(max(xi_q, abs(c_abs) / 0.95), feller)
                xi[i] = xi_q
                rho[i] = float(np.clip(c_abs / xi_q, -0.95, 0.95)) if xi_q > 1e-12 else 0.0
            else:
                xi_q = min(xi_q, feller)
                xi[i] = xi_q
                raw = float(np.clip(c_abs / xi_q, -0.95, 0.95)) if xi_q > 1e-12 else 0.0
                rho[i] = raw * (lrt / _LRT_95)
        z_resid[:, i], v_end = _qmle_filter(p_use, r, s)
        if p_use is not p_mm:
            v0[i] = v_end * s * s

    corr = np.atleast_2d(np.corrcoef(z_resid, rowvar=False))
    chol = np.linalg.cholesky(corr + jitter * np.eye(a))
    return HestonParams(*(_f64(x) for x in (mu, kappa, theta, xi, rho,
                                            np.maximum(v0, 1e-12), chol, prices[-1])))


def simulate_heston_returns(seed: int, params: HestonParams, n_paths: int, n_steps: int,
                            full_paths: bool = False, *, device: torch.device | str):
    """``(terminal (n_paths, A), log_increments (n_paths, n_steps, A) | None)``:
    the compounded terminal simple returns ``expm1(Σ x)`` and, with
    ``full_paths``, the per-step log returns — the plain form, on ``device``.
    mcport computes the increments only in lax, never in its kernel, so the
    port materialises them with the plain step recursion."""
    h = params.tensors(device)
    term = heston_terminal_reference(seed, h, n_paths, n_steps)[0]
    if not full_paths:
        return term, None
    return term, heston_increments(*heston_shocks(seed, h, n_paths, n_steps), h)[0]


def heston_terminal_returns(seed: int, params: HestonParams, n_paths: int, n_steps: int,
                            *, device: str | torch.device = "cuda") -> torch.Tensor:
    """(n_paths, A) terminal compounded simple returns, one block keyed by
    ``seed``: the Heston terminal kernel on a card, its plain form on the
    CPU."""
    from mcport_torch.device import resolve_device

    return heston_terminal(seed, params.tensors(resolve_device(device)), n_paths, n_steps)[0]


def heston_path_stats(seed: int, params: HestonParams, weights, n_paths: int, n_steps: int,
                      *, device: torch.device | str):
    """(terminal returns (W, n_paths), max drawdowns (W, n_paths)) of ``W``
    candidates compounding per-period rebalanced wealth ``V_{t+1} = V_t
    (w'exp(x_t))`` over Heston paths — the plain form of the candidate
    kernel."""
    h = params.tensors(device)
    w = torch.tensor(np.asarray(weights, np.float32), device=h.device)
    term, dd = heston_multi_dd_reference(seed, h, w.reshape(-1, params.n_assets), n_paths,
                                         n_steps)
    return term[0], dd[0]
