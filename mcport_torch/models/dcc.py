"""DCC-GARCH(1,1): dynamic conditional correlations (Engle 2002).

Port of ``mcport/models/dcc.py``. On top of the CCC model's univariate
GARCH(1,1) recursions (:mod:`mcport_torch.models.garch_mc`) a per-path
pseudo-correlation state drives the shocks' correlation:

    Q_t = (1 - a - b) S + a e_{t-1} e_{t-1}' + b Q_{t-1}
    R_t = diag(Q_t)^{-1/2} Q_t diag(Q_t)^{-1/2},   e_t ~ N(0, R_t)

Estimation (float64, host) is Engle's two-step QMLE, as mcport's: the
univariate fits first, then ``(a, b)`` as the argmax of the correlation
log-likelihood of the standardised residuals over a coarse and then a fine
feasible grid, each evaluated as one batched float64 recursion over the
grid's rows (:func:`_dcc_loglik_grid`); ``Q`` is then rolled to ``Q_T``.

The samplers :func:`dcc_terminal_returns` and :func:`dcc_path_stats` are the
plain torch forms on the port's Philox counters (one block keyed by
``seed``): they run on any ``device`` and are what the DCC kernels
(:mod:`mcport_torch.ops.dcc`) are held against. :func:`dcc_risk` is the
``garch-risk --correlation dcc`` computation on the terminal kernel.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from mcport_torch.config import COVERING_LOG1P_SKETCH, SketchConfig
from mcport_torch.device import resolve_device
from mcport_torch.models.garch_mc import (CCCGarchParams, estimate_ccc_garch,
                                          standardized_residuals)
from mcport_torch.ops.dcc import (DccTensors, dcc_multi_dd_reference, dcc_terminal,
                                  dcc_terminal_reference)
from mcport_torch.ops.quantile import histogram, sketch_var_cvar

__all__ = ["DCCGarchParams", "DccRisk", "estimate_dcc_garch", "dcc_terminal_returns",
           "dcc_path_stats", "dcc_risk"]


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64))


@dataclass(frozen=True)
class DCCGarchParams:
    """Univariate GARCH base plus the DCC correlation dynamics, as float64 CPU
    tensors."""

    base: CCCGarchParams      # mu/omega/alpha/beta + unconditional corr chol(S)
    a_dcc: torch.Tensor       # () news coefficient
    b_dcc: torch.Tensor       # () persistence coefficient
    q0: torch.Tensor          # (A, A) last fitted Q_T (the simulation's start)
    e0: torch.Tensor          # (A,) last standardised residual

    @property
    def n_assets(self) -> int:
        return self.base.n_assets

    def tensors(self, device: torch.device | str) -> DccTensors:
        """The float32 parameters the kernels take, on ``device``; ``S`` is
        ``corr_chol corr_chol'`` in float64, as mcport forms it."""
        b = self.base
        chol = torch.as_tensor(b.corr_chol, dtype=torch.float64)
        fields = {f: getattr(b, f) for f in ("mu", "omega", "alpha", "beta", "sigma2_0",
                                             "eps2_0")}
        fields.update(e0=self.e0, s=chol @ chol.T, q0=self.q0,
                      ab=torch.stack([torch.as_tensor(self.a_dcc, dtype=torch.float64),
                                      torch.as_tensor(self.b_dcc, dtype=torch.float64)]))
        return DccTensors(**{f: torch.as_tensor(fields[f]).to(device, torch.float32)
                             for f in DccTensors._fields})


def _dcc_loglik_grid(e: np.ndarray, s: np.ndarray, ab: np.ndarray) -> np.ndarray:
    """Correlation log-likelihood for each ``(a, b)`` row of ``ab`` → (G,)
    float64 — mcport's ``_dcc_loglik_grid``, every grid row's recursion in one
    batch:

        ll = -0.5 sum_t [ log|R_t| + e_t' R_t^{-1} e_t - e_t' e_t ]

    with ``R_t`` the normalised ``Q_t`` plus ``1e-6 I`` (the guard for the
    solve) and ``Q`` folding the residual in after it is scored."""
    e_t = torch.as_tensor(np.asarray(e, np.float64))
    s_t = torch.as_tensor(np.asarray(s, np.float64))
    ab_t = torch.as_tensor(np.asarray(ab, np.float64))
    g, a_dim = ab_t.shape[0], e_t.shape[1]
    a_c, b_c = ab_t[:, 0, None, None], ab_t[:, 1, None, None]
    eye = torch.eye(a_dim, dtype=torch.float64)
    q = s_t.expand(g, a_dim, a_dim)
    total = torch.zeros(g, dtype=torch.float64)
    for et in e_t:
        qn = torch.sqrt(torch.diagonal(q, dim1=-2, dim2=-1)).clamp_min(1e-6)
        r_t = q / (qn[:, :, None] * qn[:, None, :]) + 1e-6 * eye
        chol = torch.linalg.cholesky(r_t)
        sol = torch.cholesky_solve(et.expand(g, a_dim)[..., None], chol)[..., 0]
        total = total - (2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
                         + sol @ et - et @ et)
        q = (1.0 - a_c - b_c) * s_t + a_c * torch.outer(et, et) + b_c * q
    return (0.5 * total).numpy()


def _feasible_grid(a_lo, a_hi, b_lo, b_hi, n_a=13, n_b=17) -> np.ndarray:
    aa, bb = np.meshgrid(np.linspace(a_lo, a_hi, n_a),
                         np.linspace(b_lo, b_hi, n_b), indexing="ij")
    ab = np.stack([aa.ravel(), bb.ravel()], axis=1)
    return ab[(ab[:, 0] >= 0) & (ab[:, 1] >= 0) & (ab.sum(1) < 0.999)]


def estimate_dcc_garch(returns) -> DCCGarchParams:
    """Two-step QMLE from a (T, A) matrix of simple per-period returns:
    univariate GARCH fits, then ``(a, b)`` by coarse-to-fine grid
    maximisation of the correlation likelihood (two rounds, deterministic);
    warns when the argmax sits on the search boundary."""
    r = np.asarray(returns, np.float64)
    base = estimate_ccc_garch(r)
    e = standardized_residuals(r, base.mu, base.omega, base.alpha, base.beta)
    s = np.corrcoef(e, rowvar=False)
    s = np.atleast_2d(s) + 1e-9 * np.eye(e.shape[1])

    ab = _feasible_grid(0.0, 0.40, 0.0, 0.98, n_a=17, n_b=25)
    a0, b0 = ab[int(np.argmax(_dcc_loglik_grid(e, s, ab)))]
    ab2 = _feasible_grid(max(a0 - 0.03, 0.0), min(a0 + 0.03, 0.45),
                         max(b0 - 0.06, 0.0), min(b0 + 0.06, 0.995))
    a_c, b_c = (float(x) for x in ab2[int(np.argmax(_dcc_loglik_grid(e, s, ab2)))])
    if a_c >= 0.44 or a_c + b_c >= 0.994:
        warnings.warn(f"DCC argmax sits on the search boundary (a={a_c:.3f}, "
                      f"b={b_c:.3f}); the fitted dynamics may be clamped", stacklevel=2)

    # roll Q to Q_T through e[0..T-2]: the simulation's first step folds
    # e0 = e[-1] itself
    q = s.copy()
    for t in range(e.shape[0] - 1):
        q = (1.0 - a_c - b_c) * s + a_c * np.outer(e[t], e[t]) + b_c * q
    return DCCGarchParams(base=base, a_dcc=_f64(a_c), b_dcc=_f64(b_c), q0=_f64(q),
                          e0=_f64(e[-1]))


def dcc_terminal_returns(seed: int, params: DCCGarchParams, n_paths: int, n_steps: int, *,
                         device: torch.device | str) -> torch.Tensor:
    """Terminal compounded simple returns ``(n_paths, A)`` under DCC-GARCH(1,1)
    — the plain form, on ``device``."""
    return dcc_terminal_reference(seed, params.tensors(device), n_paths, n_steps)[0]


def dcc_path_stats(seed: int, params: DCCGarchParams, weights, n_paths: int, n_steps: int,
                   *, device: torch.device | str):
    """(terminal returns (W, n_paths), max drawdowns (W, n_paths)) of ``W``
    candidates compounding per-period rebalanced wealth ``V_{t+1} = V_t (1 +
    w·r_t)`` over DCC-GARCH paths — the plain form of the candidate kernel."""
    d = params.tensors(device)
    w = torch.tensor(np.asarray(weights, np.float32), device=d.device)
    term, dd = dcc_multi_dd_reference(seed, d, w.reshape(-1, params.n_assets), n_paths,
                                      n_steps)
    return term[0], dd[0]


class DccRisk(NamedTuple):
    """Tail risk of one portfolio under DCC-GARCH paths."""

    var: float        # portfolio VaR at alpha (simple-return units)
    cvar: float
    port_mean: float


def dcc_risk(seed: int, params: DCCGarchParams, weights, n_paths: int = 262_144,
             n_steps: int = 52, alpha: float = 0.95,
             sketch: SketchConfig = COVERING_LOG1P_SKETCH, *,
             device: str | torch.device = "cuda") -> DccRisk:
    """VaR/CVaR and mean of the portfolio's terminal simple return over
    ``n_paths`` DCC-GARCH paths of ``n_steps`` steps on ``device`` — mcport's
    ``dcc_risk``: one launch of the terminal kernel keyed by ``seed``, then
    the covering log1p sketch."""
    dev = resolve_device(device)
    term = dcc_terminal(seed, params.tensors(dev), n_paths, n_steps)[0]
    port = term @ torch.as_tensor(np.asarray(weights, np.float64), device=dev).to(term.dtype)
    v, c = sketch_var_cvar(histogram(port, sketch), alpha, sketch)
    return DccRisk(var=float(v), cvar=float(c), port_mean=float(port.mean()))
