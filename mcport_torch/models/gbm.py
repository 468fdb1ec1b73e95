"""Correlated-GBM parameters: estimation from prices and portfolio returns.

Port of the estimators of ``mcport/models/gbm.py`` (``estimate_gbm``,
``ledoit_wolf_shrinkage``, ``ewma_cov``, ``estimate_t_dof``) and of
``portfolio_terminal_returns``. Estimation is float64 host-side math on short
price histories; it runs on whatever device its input tensor lies on (a NumPy
input becomes a CPU tensor) and matches mcport to 1e-12 on the fixtures.

Model: per-step log increment ``m + L z``, with ``m`` the mean per-step log
return and ``L`` the Cholesky factor of the per-step log-return covariance.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "GBMParams",
    "estimate_gbm",
    "ledoit_wolf_shrinkage",
    "ewma_cov",
    "estimate_t_dof",
    "portfolio_terminal_returns",
]


@dataclass(frozen=True)
class GBMParams:
    """Per-step log-return moments and spot prices, as float64 tensors.

    ``mean_step`` (A,) and ``chol_step`` (A, A, lower) are per step: one
    simulated step is one analysis period.
    """

    s0: torch.Tensor         # (A,) spot prices
    mean_step: torch.Tensor  # (A,) per-step mean log return
    chol_step: torch.Tensor  # (A, A) Cholesky of the per-step covariance

    @property
    def n_assets(self) -> int:
        return self.s0.shape[-1]


def _f64(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.tensor(np.asarray(x, np.float64))


def _cov(x: torch.Tensor) -> torch.Tensor:
    """Sample covariance of the rows of ``x`` (ddof=1), always 2-D."""
    return torch.atleast_2d(torch.cov(x.T, correction=1))


def ledoit_wolf_shrinkage(returns) -> tuple[torch.Tensor, float]:
    """(shrunk covariance, intensity rho): Ledoit-Wolf (2004) shrinkage of
    the ddof=1 sample covariance toward the scaled identity ``m·I``, with the
    intensity derived in the 1/T convention (mcport's estimator)."""
    x = _f64(returns)
    t, a = x.shape
    xc = x - x.mean(dim=0)
    s_mle = xc.T @ xc / t
    m = torch.trace(s_mle) / a
    eye = torch.eye(a, dtype=x.dtype, device=x.device)
    d2 = float(torch.sum((s_mle - m * eye) ** 2))
    outer = xc[:, :, None] * xc[:, None, :]            # (T, A, A); T is small
    b2 = min(float(torch.sum((outer - s_mle) ** 2)) / t**2, d2)
    rho = 0.0 if d2 == 0.0 else b2 / d2
    s = _cov(x)
    return rho * (torch.trace(s) / a) * eye + (1.0 - rho) * s, float(rho)


def ewma_cov(returns, lam: float = 0.94) -> torch.Tensor:
    """RiskMetrics exponentially weighted covariance: weight ``lam^s`` on the
    return ``s`` periods ago, normalised over the window, centred on the
    weighted mean, with an effective-sample-size ddof correction."""
    if not 0.0 < lam < 1.0:
        raise ValueError(f"ewma lambda must be in (0, 1), got {lam}")
    x = _f64(returns)
    t = x.shape[0]
    w = lam ** torch.arange(t - 1, -1, -1.0, dtype=x.dtype, device=x.device)
    w = w / w.sum()
    xc = x - w @ x
    cov = (xc * w[:, None]).T @ xc
    ess = 1.0 / float(torch.sum(w**2))
    return torch.atleast_2d(cov * ess / max(ess - 1.0, 1e-12))


def estimate_gbm(prices, jitter: float = 1e-12, estimator: str = "sample",
                 ewma_lambda: float = 0.94) -> GBMParams:
    """Fit per-step GBM moments from a (T, A) price matrix.

    ``estimator``: ``"sample"`` (mean and ddof=1 covariance of log returns,
    the reference's estimator), ``"lw"`` (Ledoit-Wolf shrinkage) or
    ``"ewma"`` (RiskMetrics, ``ewma_lambda``). A ``jitter`` on the diagonal
    keeps the Cholesky factor defined for near-degenerate universes.
    """
    prices = _f64(prices)
    if prices.dim() != 2 or prices.shape[0] < 3:
        raise ValueError("estimate_gbm needs a (T>=3, A) price matrix")
    if not bool(torch.isfinite(prices).all()) or bool((prices <= 0).any()):
        raise ValueError("prices must be strictly positive and finite for GBM estimation")
    logret = torch.diff(torch.log(prices), dim=0)
    mean_step = logret.mean(dim=0)
    if estimator == "sample":
        cov_step = _cov(logret)
    elif estimator == "lw":
        cov_step, _ = ledoit_wolf_shrinkage(logret)
    elif estimator == "ewma":
        cov_step = ewma_cov(logret, ewma_lambda)
    else:
        raise ValueError(
            f"estimator must be 'sample', 'lw' or 'ewma', got {estimator!r}")
    a = cov_step.shape[0]
    eye = torch.eye(a, dtype=cov_step.dtype, device=cov_step.device)
    chol = torch.linalg.cholesky(cov_step + jitter * eye)
    return GBMParams(s0=prices[-1].clone(), mean_step=mean_step, chol_step=chol)


def estimate_t_dof(prices, min_dof: float = 4.5, max_dof: float = 50.0) -> float:
    """Method-of-moments Student-t degrees of freedom from pooled standardised
    log returns (excess kurtosis 6/(nu-4)), clamped to [min_dof, max_dof]."""
    logret = torch.diff(torch.log(_f64(prices)), dim=0)
    z = (logret - logret.mean(dim=0)) / logret.std(dim=0, correction=1)
    excess = max(float(torch.mean(z**4)) - 3.0, 1e-9)
    return float(np.clip(4.0 + 6.0 / excess, min_dof, max_dof))


def portfolio_terminal_returns(terminal_log: torch.Tensor,
                               weights: torch.Tensor) -> torch.Tensor:
    """Portfolio simple return per path, ``Σ_a w_a (exp(logR_a) - 1)``:
    weights (A,) give (paths,), weights (W, A) give (paths, W)."""
    gross = torch.exp(terminal_log) - 1.0
    w = weights.to(gross.dtype)
    return gross @ (w if w.dim() == 1 else w.T)
