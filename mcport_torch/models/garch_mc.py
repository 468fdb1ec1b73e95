"""CCC-GARCH(1,1) Monte Carlo: parameters, estimation and samplers.

Port of ``mcport/models/garch_mc.py``. Returns follow Bollerslev's (1990)
constant-conditional-correlation multivariate GARCH:

    r_{t,a} = mu_a + eps_{t,a},   eps_t = D_t zc_t,   zc_t = L_R z_t ~ N(0, R)
    D_t = diag(sigma_{t,a}),      sigma2_{t,a} = omega_a + alpha_a eps_{t-1,a}^2
                                                 + beta_a sigma2_{t-1,a}

Estimation (float64, host) fits each asset's GARCH(1,1)
(:mod:`mcport_torch.models.garch`) and takes ``R`` as the sample correlation
of the standardised residuals, as mcport does.

The samplers :func:`simulate_garch_returns`, :func:`garch_terminal_returns`
and :func:`garch_path_stats` are the plain torch forms, mcport's lax
references, on the port's Philox counters (one block keyed by ``seed``):
they run on any ``device`` and are what the GARCH kernels
(:mod:`mcport_torch.ops.garch`) are held against. :func:`garch_risk` is the
``garch-risk`` computation on the kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from mcport_torch.config import COVERING_LOG1P_SKETCH, SketchConfig
from mcport_torch.device import resolve_device
from mcport_torch.models.garch import Garch11Fit, fit_garch_11, variance_path
from mcport_torch.ops.garch import (
    GarchTensors,
    correlated_shocks,
    garch_innovations,
    garch_multi_dd_reference,
    garch_terminal,
    garch_terminal_reference,
)
from mcport_torch.ops.quantile import histogram, sketch_var_cvar

__all__ = ["CCCGarchParams", "GarchRisk", "estimate_ccc_garch", "simulate_garch_returns",
           "garch_terminal_returns", "garch_path_stats", "garch_risk",
           "standardized_residuals"]


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64))


@dataclass(frozen=True)
class CCCGarchParams:
    """Per-asset GARCH(1,1) plus the constant conditional correlation, as
    float64 CPU tensors."""

    mu: torch.Tensor          # (A,) per-step mean return
    omega: torch.Tensor       # (A,)
    alpha: torch.Tensor       # (A,)
    beta: torch.Tensor        # (A,)
    corr_chol: torch.Tensor   # (A, A) Cholesky of the constant correlation R
    sigma2_0: torch.Tensor    # (A,) starting conditional variance (last fitted)
    eps2_0: torch.Tensor      # (A,) last squared residual

    @property
    def n_assets(self) -> int:
        return self.mu.shape[-1]

    def tensors(self, device: torch.device | str) -> GarchTensors:
        """The float32 parameters the kernels take, on ``device``."""
        return GarchTensors(*(torch.as_tensor(getattr(self, f)).to(device, torch.float32)
                              for f in GarchTensors._fields))


def standardized_residuals(returns, mu, omega, alpha, beta) -> np.ndarray:
    """(T, A) GARCH-standardised residuals ``eps_t / sigma_t`` under the
    per-asset (A,) parameters: ``sigma2_0`` the sample variance, the
    ``1e-12`` floor — mcport's single implementation of the recursion."""
    r = np.asarray(returns, np.float64)
    eps = r - np.asarray(mu, np.float64)
    v = r.var(axis=0)
    s2 = np.stack([variance_path(eps[:, i] ** 2, float(omega[i]), float(alpha[i]),
                                 float(beta[i]), float(v[i]))
                   for i in range(r.shape[1])], axis=1)
    return eps / np.sqrt(np.maximum(s2, 1e-12))


def estimate_ccc_garch(returns, jitter: float = 1e-10) -> CCCGarchParams:
    """Per-asset GARCH(1,1) MLEs and the CCC correlation from a (T, A) matrix
    of simple per-period returns (the reference's convention)."""
    r = np.asarray(returns, np.float64)
    if r.ndim != 2 or r.shape[0] < 20:
        raise ValueError("estimate_ccc_garch needs a (T>=20, A) return matrix")
    a = r.shape[1]
    fits: list[Garch11Fit] = [fit_garch_11(r[:, i]) for i in range(a)]

    def field(name):
        return np.array([getattr(f, name) for f in fits])

    std_resid = standardized_residuals(r, field("mu"), field("omega"), field("alpha"),
                                       field("beta"))
    corr = np.atleast_2d(np.corrcoef(std_resid, rowvar=False))
    chol = np.linalg.cholesky(corr + jitter * np.eye(a))
    return CCCGarchParams(mu=_f64(field("mu")), omega=_f64(field("omega")),
                          alpha=_f64(field("alpha")), beta=_f64(field("beta")),
                          corr_chol=_f64(chol), sigma2_0=_f64(field("last_sigma2")),
                          eps2_0=_f64(field("last_eps2")))


def simulate_garch_returns(seed: int, params: CCCGarchParams, n_paths: int, n_steps: int,
                           full_paths: bool = False, t_df: float | None = None, *,
                           device: torch.device | str):
    """``(terminal (n_paths, A), paths (n_paths, n_steps, A) | None)``:
    compounded terminal simple returns and, with ``full_paths``, the per-step
    returns ``mu + eps_t``. ``t_df`` draws unit-variance Student-t shocks
    (GARCH-t). The plain form, on ``device``."""
    g = params.tensors(device)
    term = garch_terminal_reference(seed, g, n_paths, n_steps, t_df=t_df)[0]
    if not full_paths:
        return term, None
    return term, g.mu + garch_innovations(
        correlated_shocks(seed, g, n_paths, n_steps, t_df=t_df)[0], g)


def garch_terminal_returns(seed: int, params: CCCGarchParams, n_paths: int, n_steps: int,
                           t_df: float | None = None, *,
                           device: torch.device | str) -> torch.Tensor:
    """Terminal compounded simple returns ``(n_paths, A)`` — the plain form."""
    return simulate_garch_returns(seed, params, n_paths, n_steps, t_df=t_df,
                                  device=device)[0]


def garch_path_stats(seed: int, params: CCCGarchParams, weights, n_paths: int,
                     n_steps: int, *, device: torch.device | str):
    """(terminal returns (W, n_paths), max drawdowns (W, n_paths)) of ``W``
    candidates compounding per-period rebalanced wealth ``V_{t+1} = V_t (1 +
    w·r_t)`` over CCC-GARCH paths — the plain form of the candidate kernel."""
    g = params.tensors(device)
    w = torch.tensor(np.asarray(weights, np.float32), device=g.device)
    term, dd = garch_multi_dd_reference(seed, g, w.reshape(-1, params.n_assets), n_paths,
                                        n_steps)
    return term[0], dd[0]


class GarchRisk(NamedTuple):
    """Tail risk of one portfolio under CCC-GARCH paths."""

    var: float        # portfolio VaR at alpha (simple-return units)
    cvar: float
    port_mean: float


def garch_risk(seed: int, params: CCCGarchParams, weights, n_paths: int = 100_000,
               n_steps: int = 52, alpha: float = 0.95, t_df: float | None = None,
               sketch: SketchConfig = COVERING_LOG1P_SKETCH, *,
               device: str | torch.device = "cuda") -> GarchRisk:
    """VaR/CVaR and mean of the portfolio's terminal simple return over
    ``n_paths`` CCC-GARCH paths of ``n_steps`` steps on ``device`` — what
    mcport's ``garch-risk`` command computes: one launch of the terminal
    kernel keyed by ``seed``, then the covering log1p sketch."""
    dev = resolve_device(device)
    term = garch_terminal(seed, params.tensors(dev), n_paths, n_steps, t_df=t_df)[0]
    port = term @ torch.as_tensor(np.asarray(weights, np.float64), device=dev).to(term.dtype)
    v, c = sketch_var_cvar(histogram(port, sketch), alpha, sketch)
    return GarchRisk(var=float(v), cvar=float(c), port_mean=float(port.mean()))
