"""Merton jump-diffusion with systemic (common) jumps: parameters, threshold
calibration and samplers.

Port of ``mcport/models/jump.py``. A compound-Poisson systemic jump is added
to the correlated diffusion; every event moves every asset at once:

    terminal log return_a = n m_a + sqrt(n) (L z)_a            (diffusion)
                          + N muJ_a + sqrt(N) sigJ_a u          (jumps)

with ``N ~ Poisson(lambda n)`` jump events over the horizon and one common
normal ``u`` per path. Conditional on ``N`` the jump sum is Gaussian, so the
terminal sampler is exact (:func:`merton_terminal_returns`). The path form
(:func:`merton_path_stats`, kernel #8's plain form) discretises the clock per
step: a Bernoulli(lambda) event with one common jump normal per (path, step).

Calibration (:func:`estimate_merton_common`, float64 host math as in mcport):
a step is a systemic jump when the cross-sectional median |z-score| of the
assets' log returns exceeds ``threshold``; the diffusion is re-fitted on the
calm steps and the jump moments on the jump steps' excess moves.

The exact terminal sampler draws from the port's Philox streams on its own
tag, ``rng.STREAM_MERTON``, keyed by ``seed``: for path ``p``, counter ``(0,
a, p)`` gives asset ``a``'s diffusion normal (the first draw of the poly
Box-Muller pair of words 0 and 1), and counter ``(1, 0, p)`` the path's
Poisson uniform (53 bits from words 0 and 1) and its common jump normal (words
2 and 3). The count is taken by inversion: ``torch.searchsorted`` of the
uniform into a float64 table of the ``Poisson(lambda n)`` CDF up to
``default_merton_sketch``'s ``n_hi``. mcport samples this in lax, outside any
kernel, so it runs as torch ops on the card, and equals its CPU run to
rounding.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from mcport_torch.config import SketchConfig
from mcport_torch.device import resolve_device
from mcport_torch.models.gbm import GBMParams, estimate_gbm
from mcport_torch.ops.gbm import BM_VARIANTS, sqrt_rn
from mcport_torch.ops.jump import merton_multi_dd_reference
from mcport_torch.ops.quantile import auto_sketch, histogram, sketch_var_cvar
from mcport_torch.rng import STREAM_MERTON, bits_to_unit, philox4x32

__all__ = ["MertonParams", "estimate_merton_common", "merton_terminal_returns",
           "merton_path_stats", "merton_risk", "MertonRisk", "default_merton_sketch"]


def _f64(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float64))


def _f32(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev, torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=dev)


@dataclass(frozen=True)
class MertonParams:
    """Diffusion (per step) plus systemic-jump parameters; arrays as float64
    CPU tensors."""

    diffusion: GBMParams        # per-step m, L estimated on non-jump steps
    jump_rate: float            # lambda per step (P[jump event] per period)
    jump_mean: torch.Tensor     # (A,) mean log-jump size per asset
    jump_vol: torch.Tensor      # (A,) jump-size vol per asset

    @property
    def n_assets(self) -> int:
        return self.diffusion.n_assets


def estimate_merton_common(prices, threshold: float = 3.0,
                           jitter: float = 1e-12) -> MertonParams:
    """Threshold calibration of the common-jump model from a (T, A) price
    matrix. With no detected jump the model is plain GBM (``jump_rate = 0``);
    a threshold that leaves fewer than 3 calm steps raises."""
    prices = np.asarray(prices, np.float64)
    logret = np.diff(np.log(prices), axis=0)            # (T-1, A)
    mu0 = logret.mean(axis=0)
    sd0 = logret.std(axis=0, ddof=1)
    z = (logret - mu0) / np.maximum(sd0, 1e-12)
    jump_step = np.median(np.abs(z), axis=1) > threshold

    n_jump = int(jump_step.sum())
    t_eff = logret.shape[0]
    if n_jump == 0:
        diff = estimate_gbm(prices, jitter)
        a = diff.n_assets
        return MertonParams(diff, 0.0, torch.zeros(a, dtype=torch.float64),
                            torch.zeros(a, dtype=torch.float64))

    calm = logret[~jump_step]
    if calm.shape[0] < 3:
        raise ValueError(
            f"threshold {threshold} flags {n_jump}/{t_eff} steps as jumps, "
            f"leaving {calm.shape[0]} calm steps — too few to estimate the "
            "diffusion (need >= 3); raise the threshold")
    mean_step = calm.mean(axis=0)
    cov_step = np.atleast_2d(np.cov(calm, rowvar=False, ddof=1))
    a = cov_step.shape[0]
    chol = np.linalg.cholesky(cov_step + jitter * np.eye(a))
    diff = GBMParams(s0=_f64(prices[-1]), mean_step=_f64(mean_step), chol_step=_f64(chol))
    resid = logret[jump_step] - mean_step               # jump-step excess moves
    jump_vol = resid.std(axis=0, ddof=1) if n_jump > 1 else np.zeros(a)
    return MertonParams(diff, n_jump / t_eff, _f64(resid.mean(axis=0)), _f64(jump_vol))


def _n_hi(jump_rate: float, n_steps: int) -> float:
    """A 10-sigma-high Poisson count for the horizon (mcport's sketch rule)."""
    lam = max(jump_rate * n_steps, 1e-12)
    return lam + 10.0 * math.sqrt(lam) + 10.0


def merton_terminal_returns(seed: int, mean_step, chol_step, jump_rate: float, jump_mean,
                            jump_vol, n_paths: int, n_steps: int, return_jumps: bool = False,
                            *, device: torch.device | str):
    """(n_paths, A) float32 terminal LOG returns of the common-jump model, one
    block keyed by ``seed`` on ``device`` (with ``return_jumps``, also the
    per-path Poisson event counts, float32) — mcport's exact sampler:
    diffusion ``N(n m, n LL')`` plus, given the count ``N``, the rank-one jump
    sum ``N muJ + sqrt(N) u sigJ``."""
    from scipy.stats import poisson

    dev = torch.device(device)
    m, chol, mu_j, sig_j = (_f32(x, dev) for x in (mean_step, chol_step, jump_mean, jump_vol))
    a = m.shape[-1]
    key = (seed & 0xFFFFFFFF, 0)
    path = torch.arange(n_paths, dtype=torch.int64, device=dev)
    asset = torch.arange(a, dtype=torch.int64, device=dev)
    w = philox4x32((0, asset[None, :], path[:, None], STREAM_MERTON), key)
    z, _ = BM_VARIANTS["poly"](bits_to_unit(w[0]), bits_to_unit(w[1]))      # (n, A)
    c = philox4x32((1, 0, path, STREAM_MERTON), key)
    u53 = ((c[0] >> 5) * (1 << 26) + (c[1] >> 6) + 1).to(torch.float64) * 2.0 ** -53
    u, _ = BM_VARIANTS["poly"](bits_to_unit(c[2]), bits_to_unit(c[3]))      # (n,)
    k_hi = math.ceil(_n_hi(jump_rate, n_steps))
    cdf = torch.as_tensor(poisson.cdf(np.arange(k_hi + 1), jump_rate * n_steps), device=dev)
    n_jumps = torch.searchsorted(cdf, u53).clamp_max(k_hi).to(torch.float32)
    scale = sqrt_rn(torch.tensor(float(n_steps), device=dev))
    diffusion = n_steps * m + scale * (z @ chol.T)
    jumps = n_jumps[:, None] * mu_j + sqrt_rn(n_jumps)[:, None] * u[:, None] * sig_j
    term = diffusion + jumps
    return (term, n_jumps) if return_jumps else term


def merton_path_stats(seed: int, mean_step, chol_step, jump_rate: float, jump_mean, jump_vol,
                      weights, n_paths: int, n_steps: int, *, device: torch.device | str):
    """(terminal returns (W, n_paths), max drawdowns (W, n_paths)) of ``W``
    candidates compounding per-period rebalanced wealth ``V_{t+1} = V_t
    (w'exp(x_t))`` over common-jump Merton paths with the per-step Bernoulli
    clock — the plain form of the jump kernel, one block keyed by ``seed``."""
    dev = torch.device(device)
    m, chol, mu_j, sig_j = (_f32(x, dev) for x in (mean_step, chol_step, jump_mean, jump_vol))
    w = _f32(weights, dev).reshape(-1, m.shape[-1])
    term, dd = merton_multi_dd_reference(seed, m, chol, float(jump_rate), mu_j, sig_j, w,
                                         n_paths, n_steps)
    return term[0], dd[0]


class MertonRisk(NamedTuple):
    """Tail risk under the common-jump model (mcport's fields, on the host)."""

    var: float
    cvar: float
    port_mean: float
    mean: np.ndarray     # (A,) mean terminal log return
    jump_frac: float     # fraction of paths with >= 1 jump event
    hist: np.ndarray     # (n_bins,) portfolio-return histogram counts


def default_merton_sketch(params: MertonParams, n_steps: int) -> SketchConfig:
    """Covering sketch: the GBM-derived range widened by the worst plausible
    compound-Poisson jump contribution (10-sigma on a 10-sigma-high count)."""
    n_hi = _n_hi(params.jump_rate, n_steps)
    mu_j, sig_j = params.jump_mean.numpy(), params.jump_vol.numpy()
    jump_lo = float(np.min(n_hi * mu_j - 10.0 * np.sqrt(n_hi) * sig_j))
    jump_hi = float(np.max(n_hi * mu_j + 10.0 * np.sqrt(n_hi) * sig_j))
    base = auto_sketch(params.diffusion.mean_step, params.diffusion.chol_step, n_steps)
    return SketchConfig(n_bins=base.n_bins, lo=base.lo + min(jump_lo, 0.0),
                        hi=base.hi + max(jump_hi, 0.0), space="log1p")


def merton_risk(seed: int, params: MertonParams, weights, n_paths: int = 262_144,
                n_steps: int = 52, alpha: float = 0.95, sketch: SketchConfig | None = None,
                *, device: str | torch.device = "cuda") -> MertonRisk:
    """Portfolio tail risk under the common-jump model on ``device`` — what
    mcport's ``jump-risk`` command computes: the exact terminal sampler keyed
    by ``seed``, then the covering log1p sketch (:func:`default_merton_sketch`
    by default)."""
    if sketch is None:
        sketch = default_merton_sketch(params, n_steps)
    dev = resolve_device(device)
    d = params.diffusion
    term, n_jumps = merton_terminal_returns(seed, d.mean_step, d.chol_step, params.jump_rate,
                                            params.jump_mean, params.jump_vol, n_paths,
                                            n_steps, return_jumps=True, device=dev)
    port = (torch.exp(term) - 1.0) @ _f32(weights, dev)
    counts = histogram(port, sketch)
    v, c = sketch_var_cvar(counts, alpha, sketch)
    return MertonRisk(var=float(v), cvar=float(c), port_mean=float(port.mean()),
                      mean=term.mean(dim=0).cpu().numpy(),
                      jump_frac=float((n_jumps > 0).to(torch.float32).mean()),
                      hist=counts.cpu().numpy())
