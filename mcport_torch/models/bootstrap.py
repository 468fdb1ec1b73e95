"""Stationary block-bootstrap Monte Carlo over historical joint returns.

Port of ``mcport/models/bootstrap.py``. Distribution-free forward simulation:
every simulated step is one real (A,) row of the history, so the joint
cross-asset distribution is kept exactly, and runs of consecutive rows keep
short-range serial dependence (Politis-Romano stationary bootstrap, circular,
expected block length ``1 / p_restart``).

:func:`bootstrap_terminal_returns` and :func:`bootstrap_path_stats` are the
plain torch forms, mcport's lax references, on the port's Philox counters
(one block keyed by ``seed``, stream ``STREAM_BOOT``): they run on any
``device`` and are what the bootstrap kernels
(:mod:`mcport_torch.ops.bootstrap`) are held against. :func:`bootstrap_risk`
runs the terminal kernel. Where mcport takes a JAX key and an optional kernel
seed, the port takes one integer ``seed``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcport_torch.config import SketchConfig
from mcport_torch.device import resolve_device
from mcport_torch.ops.bootstrap import (
    bootstrap_multi_dd_reference,
    bootstrap_terminal,
    bootstrap_terminal_reference,
)
from mcport_torch.ops.quantile import histogram, sketch_var_cvar

__all__ = ["BootstrapRisk", "bootstrap_terminal_returns", "bootstrap_path_stats",
           "bootstrap_risk"]


def _history(returns, device) -> torch.Tensor:
    return torch.tensor(np.asarray(returns, np.float32), device=device)


def bootstrap_terminal_returns(seed: int, returns, n_paths: int, n_steps: int,
                               p_restart: float = 0.2, *,
                               device: torch.device | str) -> torch.Tensor:
    """(n_paths, A) terminal simple returns of stationary-bootstrap paths over
    the (T, A) history ``returns`` — the plain form, on ``device``.
    ``p_restart=1`` is the iid bootstrap."""
    return bootstrap_terminal_reference(seed, _history(returns, device), n_paths, n_steps,
                                        p_restart)[0]


def bootstrap_path_stats(seed: int, returns, weights, n_paths: int, n_steps: int,
                         p_restart: float = 0.2, *, device: torch.device | str):
    """(terminal returns (W, n_paths), max drawdowns (W, n_paths)) of ``W``
    candidates compounding per-period rebalanced wealth ``V_{t+1} = V_t (1 +
    w·r_t)`` over the same resampled paths as
    :func:`bootstrap_terminal_returns` — the plain form."""
    hist = _history(returns, device)
    w = torch.tensor(np.asarray(weights, np.float32), device=hist.device)
    term, dd = bootstrap_multi_dd_reference(seed, hist, w.reshape(-1, hist.shape[1]),
                                            n_paths, n_steps, p_restart)
    return term[0], dd[0]


class BootstrapRisk(NamedTuple):
    """Tail risk of a bootstrap run (mcport's fields, on the host)."""

    var: float              # portfolio VaR at alpha (simple-return units)
    cvar: float
    port_mean: float
    mean: np.ndarray        # (A,) per-asset mean terminal simple return
    hist: np.ndarray        # (n_bins,) portfolio-return histogram counts


def _auto_sketch_from_history(returns, n_steps: int, n_bins: int = 8192) -> SketchConfig:
    """Covering log1p range from the history itself: the most extreme path
    compounds the best or worst historical row every step."""
    r = np.asarray(returns, np.float64)
    worst = np.log1p(np.maximum(r.min(), -0.9999))
    best = np.log1p(r.max())
    lo = n_steps * min(worst, 0.0)
    hi = n_steps * max(best, 0.0)
    pad = 1e-6 * max(1.0, hi - lo)
    return SketchConfig(n_bins=n_bins, lo=float(lo - pad), hi=float(hi + pad),
                        space="log1p")


def bootstrap_risk(
    seed: int,
    returns,
    weights,
    n_paths: int = 100_000,
    n_steps: int = 52,
    p_restart: float = 0.2,
    alpha: float = 0.95,
    sketch: SketchConfig | None = None,
    *,
    device: str | torch.device = "cuda",
) -> BootstrapRisk:
    """Distribution-free portfolio tail risk from ``n_paths`` resampled
    historical paths on ``device``: one launch of the terminal kernel keyed by
    ``seed``. ``sketch=None`` derives a covering log1p range from the history
    (the compounded best and worst rows bound every path)."""
    if sketch is None:
        sketch = _auto_sketch_from_history(returns, n_steps)
    dev = resolve_device(device)
    term = bootstrap_terminal(seed, _history(returns, dev), n_paths, n_steps, p_restart)[0]
    port = term @ torch.as_tensor(np.asarray(weights, np.float64), device=dev).to(term.dtype)
    counts = histogram(port, sketch)
    v, c = sketch_var_cvar(counts, alpha, sketch)
    return BootstrapRisk(var=float(v), cvar=float(c), port_mean=float(port.mean()),
                         mean=term.mean(dim=0).cpu().numpy(), hist=counts.cpu().numpy())
