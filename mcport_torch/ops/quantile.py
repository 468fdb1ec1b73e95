"""Streaming moments and the mergeable histogram sketch.

Port of ``mcport/ops/quantile.py`` (moments, sketch, VaR/CVaR; the bootstrap
CIs are not ported yet). VaR/CVaR at 16M+ paths reduce on the device without
keeping the paths:

- :class:`MomentState` — count, sum and outer-product accumulators, each with a
  Neumaier compensation term. A batch is cut into ``chunk``-row pieces reduced
  by one batched matrix product; the pieces fold together through exact
  two-sum steps. mcport folds them left to right (``lax.scan``); the port folds
  them pairwise, which is the same compensated sum in log2(pieces) launches
  instead of one Python step per piece. An optional ``shift`` (the known
  terminal drift) keeps the covariance finalisation free of cancellation.
- histogram sketch — fixed bins over ``SketchConfig``'s range, in linear return
  space or in log1p space. Counts are int64, exact at any path count;
  quantiles and tail means interpolate within a bin.

The per-block functions (``update_moments``, ``histogram``) never synchronise
with the device, so the engine can enqueue a whole dispatch group ahead.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcport.config import SketchConfig

__all__ = [
    "MomentState",
    "init_moments",
    "update_moments",
    "merge_moments",
    "finalize_moments",
    "auto_sketch",
    "histogram",
    "sketch_quantile",
    "sketch_tail_mean",
    "sketch_var_cvar",
]


class MomentState(NamedTuple):
    """Streaming first and second moments of an (n, A) sample stream.

    The represented values are ``sum + sum_c`` and ``outer + outer_c``; every
    field merges by addition. ``count`` is int64.
    """

    count: torch.Tensor    # () int64
    sum: torch.Tensor      # (A,)
    sum_c: torch.Tensor    # (A,) compensation
    outer: torch.Tensor    # (A, A) sum of x x'
    outer_c: torch.Tensor  # (A, A) compensation


def init_moments(n_assets: int, *, dtype: torch.dtype = torch.float32,
                 device: torch.device | str) -> MomentState:
    z_a = torch.zeros((n_assets,), dtype=dtype, device=device)
    z_aa = torch.zeros((n_assets, n_assets), dtype=dtype, device=device)
    return MomentState(torch.zeros((), dtype=torch.int64, device=device),
                       z_a, z_a.clone(), z_aa, z_aa.clone())


def _two_sum(s: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Branch-free Neumaier two-sum: (fl(s + x), exact residual)."""
    t = s + x
    e = torch.where(s.abs() >= x.abs(), (s - t) + x, (x - t) + s)
    return t, e


def _compensated_total(parts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(total, compensation) of ``parts`` summed over dim 0: pairwise two-sum
    levels, each carrying the exact residuals of its additions."""
    comp = torch.zeros_like(parts)
    while parts.shape[0] > 1:
        if parts.shape[0] % 2:
            pad = torch.zeros_like(parts[:1])
            parts, comp = torch.cat([parts, pad]), torch.cat([comp, pad])
        parts, err = _two_sum(parts[0::2], parts[1::2])
        comp = comp[0::2] + comp[1::2] + err
    return parts[0], comp[0]


def update_moments(state: MomentState, x: torch.Tensor,
                   shift: torch.Tensor | None = None, chunk: int = 512) -> MomentState:
    """Fold an (n, A) batch into the accumulator; ``shift`` (A,) is
    subtracted from every row first (pass the same to
    :func:`finalize_moments`)."""
    x = x.to(state.sum.dtype)
    n, a = x.shape
    if shift is not None:
        x = x - shift.to(x.dtype)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))  # zero rows add nothing
    xr = x.reshape(n_chunks, chunk, a)
    parts = torch.cat([xr.sum(dim=1),                                    # (C, A)
                       torch.bmm(xr.transpose(1, 2), xr).reshape(n_chunks, a * a)],
                      dim=1)                  # sums and outer products fold as one
    total, comp = _compensated_total(parts)
    ds, dsc = total[:a], comp[:a]
    do, doc = total[a:].reshape(a, a), comp[a:].reshape(a, a)
    s, e1 = _two_sum(state.sum, ds)
    o, e2 = _two_sum(state.outer, do)
    return MomentState(state.count + n, s, state.sum_c + dsc + e1,
                       o, state.outer_c + doc + e2)


def merge_moments(a: MomentState, b: MomentState) -> MomentState:
    """Compensated merge of two accumulators."""
    s, e1 = _two_sum(a.sum, b.sum)
    o, e2 = _two_sum(a.outer, b.outer)
    return MomentState(a.count + b.count, s, a.sum_c + b.sum_c + e1,
                       o, a.outer_c + b.outer_c + e2)


def finalize_moments(state: MomentState, ddof: int = 1,
                     shift: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean (A,), cov (A, A)) with ddof=1 by default; ``shift`` must equal the
    one passed to :func:`update_moments`."""
    n = state.count.to(state.sum.dtype)
    s = state.sum + state.sum_c
    m2 = state.outer + state.outer_c
    mean_c = s / n
    cov = (m2 - n * torch.outer(mean_c, mean_c)) / (n - ddof)
    mean = mean_c if shift is None else mean_c + shift.to(s.dtype)
    return mean, cov


# ---- histogram sketch --------------------------------------------------------
#
# SketchConfig.space: "linear" bins returns over [lo, hi]; "log1p" bins
# u = log1p(r), with lo/hi in u-space. Results are in return space.

# -1 + 1e-6 is exact in float32 and maps to u = -13.8, inside any sketch's
# bottom clamp (-1 + 1e-12 would round to -1 and give log1p = -inf).
_LOG1P_FLOOR = -1.0 + 1e-6


def _to_u(x: torch.Tensor, config: SketchConfig) -> torch.Tensor:
    if config.space == "log1p":
        return torch.log1p(torch.clamp_min(x, _LOG1P_FLOOR))
    return x


def _from_u(u: torch.Tensor, config: SketchConfig) -> torch.Tensor:
    if config.space == "log1p":
        return torch.expm1(u)
    return u


def _width(config: SketchConfig, like: torch.Tensor) -> torch.Tensor:
    # a device tensor, not a Python float: CUDA divides by a host scalar as a
    # multiplication by its reciprocal, which moves samples across bin edges.
    # torch.full fills on the device; torch.tensor would copy from the host
    # and synchronise.
    return torch.full((), (config.hi - config.lo) / config.n_bins,
                      dtype=like.dtype, device=like.device)


def auto_sketch(mean_step, chol_step, n_steps: int, weights=None,
                k_sigma: float = 12.0, n_bins: int = 8192,
                t_dof: float | None = None) -> SketchConfig:
    """A log1p-space sketch guaranteed to cover the terminal portfolio return
    for these GBM parameters (±``k_sigma`` per-asset terminal bounds, widened
    by one extreme t shock for Student-t innovations) — mcport's
    ``auto_sketch``, host-side NumPy as there."""
    m = np.asarray(torch.as_tensor(mean_step).cpu(), np.float64).reshape(-1)
    L = np.atleast_2d(np.asarray(torch.as_tensor(chol_step).cpu(), np.float64))
    var_step = np.einsum("ij,ij->i", L, L)
    mu = n_steps * m
    sd = np.sqrt(n_steps * var_step)
    widen = 0.0
    if t_dof is not None:
        from scipy.stats import t as _t

        x = float(_t.isf(1e-13, t_dof)) / np.sqrt(t_dof / (t_dof - 2.0))
        widen = x * np.sqrt(var_step)
    lo_asset = np.expm1(mu - k_sigma * sd - widen)
    hi_asset = np.expm1(mu + k_sigma * sd + widen)
    if weights is None:
        lo_r, hi_r = float(lo_asset.min()), float(hi_asset.max())
    else:
        w = np.asarray(torch.as_tensor(weights).cpu(), np.float64).reshape(-1)
        lo_r, hi_r = float(w @ lo_asset), float(w @ hi_asset)
    lo_u = np.log1p(max(lo_r, _LOG1P_FLOOR))
    hi_u = np.log1p(hi_r)
    pad = 1e-6 * max(1.0, hi_u - lo_u)
    return SketchConfig(n_bins=n_bins, lo=float(lo_u - pad), hi=float(hi_u + pad),
                        space="log1p")


def histogram(x: torch.Tensor, config: SketchConfig = SketchConfig()) -> torch.Tensor:
    """Bin a sample batch into (n_bins,) int64 counts; out-of-range samples
    clamp to the edge bins. Counts add with int64 ``scatter_add_`` (exact and
    order-free; ``torch.bincount`` would size its output on the host and
    synchronise with the device)."""
    u = _to_u(x.reshape(-1), config)
    idx = torch.floor((u - config.lo) / _width(config, u)).to(torch.int64)
    idx = idx.clamp_(0, config.n_bins - 1)
    counts = torch.zeros(config.n_bins, dtype=torch.int64, device=u.device)
    return counts.scatter_add_(0, idx, torch.ones_like(idx))


def _edges(config: SketchConfig, dtype: torch.dtype,
           device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    width = (config.hi - config.lo) / config.n_bins
    left = config.lo + width * torch.arange(config.n_bins, dtype=dtype, device=device)
    return left, torch.full((), width, dtype=dtype, device=device)


def sketch_quantile(counts: torch.Tensor, q: float,
                    config: SketchConfig = SketchConfig(),
                    total: torch.Tensor | None = None, *,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Quantile ``q`` in return space from histogram counts, interpolated
    linearly within its bin (in sketch space); arithmetic in ``dtype``."""
    counts = counts.to(dtype)
    if total is None:
        total = counts.sum()
    cdf = torch.cumsum(counts, dim=0)
    target = (torch.full((), q, dtype=dtype, device=counts.device) * total).reshape(1)
    bin_idx = torch.searchsorted(cdf, target, side="left")
    bin_idx = bin_idx.clamp(0, config.n_bins - 1)[0]
    left, width = _edges(config, dtype, counts.device)
    below = torch.where(bin_idx > 0, cdf[(bin_idx - 1).clamp_min(0)],
                        torch.zeros((), dtype=dtype, device=counts.device))
    inbin = torch.clamp_min(counts[bin_idx], 1.0)
    frac = torch.clamp((target[0] - below) / inbin, 0.0, 1.0)
    return _from_u(left[bin_idx] + frac * width, config)


def sketch_tail_mean(counts: torch.Tensor, thresh: torch.Tensor,
                     config: SketchConfig = SketchConfig(), *,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Mean (return space) of the samples at or below ``thresh``: each bin
    contributes its covered fraction at the midpoint of the covered part."""
    counts = counts.to(dtype)
    left, width = _edges(config, dtype, counts.device)
    thresh = torch.as_tensor(thresh, dtype=dtype, device=counts.device)
    frac = torch.clamp((_to_u(thresh, config) - left) / width, 0.0, 1.0)
    mid = _from_u(left + 0.5 * frac * width, config)
    tail_counts = counts * frac
    n_tail = tail_counts.sum()
    mean_tail = torch.sum(tail_counts * mid) / torch.clamp_min(n_tail, 1.0)
    return torch.where(n_tail > 0, mean_tail, thresh)


def sketch_var_cvar(counts: torch.Tensor, alpha: float = 0.95,
                    config: SketchConfig = SketchConfig(), *,
                    dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """Historical VaR/CVaR on sketched counts: VaR = quantile(1 - alpha),
    CVaR = mean of the tail at or below VaR."""
    v = sketch_quantile(counts, 1.0 - alpha, config, dtype=dtype)
    return v, sketch_tail_mean(counts, v, config, dtype=dtype)
