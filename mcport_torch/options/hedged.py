"""Hedged portfolios on simulated paths.

Port of ``mcport/options/hedged.py``. The reference applies option legs to
the historical return series only (``app.py:657-667``); mcport composes its
leg model (``app.py:164-216``) with the path engines, and so does the port.

A hedged asset's return over one holding interval ``prev → S`` is the
qty-weighted sum of its legs' returns, :func:`leg_period_return` each. Two
compositions with simulated paths:

* **terminal** (the engines' default): the horizon is one interval — the
  options expire at the horizon and settle at intrinsic value against the
  simulated terminal price ``S_T = s0·exp(term_log)``;
* **per step**: every simulated step settles like one historical period
  (``calc_options_series``, ``app.py:182-193``, on a simulated path), in
  rebalanced form — the path kernels' hedged modes
  (:mod:`mcport_torch.ops.hedged`).

An asset without legs gets the implicit BUY_ASSET qty-1 leg, so its hedged
return is its plain simple return. The per-asset legs are dense ``(A, L)``
arrays, ``L`` the most legs of any asset, padded with qty-0 rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np
import torch

from mcport_torch.config import SketchConfig
from mcport_torch.options.legs import Legs, LegType, leg_period_return

__all__ = ["HedgeSpec", "legs_from_spec", "hedged_terminal_returns", "hedged_from_simple",
           "hedged_step_returns", "hedged_return_bounds", "auto_hedged_sketch"]


def legs_from_spec(spec: Mapping[str, Mapping], names: Sequence[str],
                   spots: Sequence[float]) -> dict[str, Legs]:
    """``{asset: Legs}`` from a JSON-style hedge config (the CLI's ``--hedge``).

    Per asset, a named reference strategy with its parameters (strikes and
    premiums default as in ``app.py:515-581``, relative to the asset's spot)
    or explicit reference-style leg rows::

        {"BTC": {"strategy": "Married Put", "params": {"premium_put": 1.5}},
         "ETH": {"legs": [["BUY_ASSET", 0, 0, 1], ["BUY_PUT", 2500, 20, 1]]}}
    """
    from mcport_torch.options.strategies import strategy_legs

    out: dict[str, Legs] = {}
    for asset, entry in spec.items():
        if asset not in names:
            raise ValueError(
                f"hedge config asset {asset!r} is not in the universe {list(names)}")
        spot = float(spots[list(names).index(asset)])
        if "strategy" in entry:
            out[asset] = strategy_legs(entry["strategy"], spot, **entry.get("params", {}))
        elif "legs" in entry:
            out[asset] = Legs.from_rows([tuple(row) for row in entry["legs"]])
        else:
            raise ValueError(f"hedge config for {asset!r} needs 'strategy' or 'legs'")
    return out


@dataclass(frozen=True)
class HedgeSpec:
    """Dense ``(A, L)`` struct of arrays over the universe's option legs.

    ``qty == 0`` rows are padding. ``hedged_mask[i]`` is True iff asset ``i``
    has explicit legs (an unhedged asset carries the implicit BUY_ASSET qty-1
    leg and a False mask)."""

    type_id: np.ndarray      # (A, L) int32
    strike: np.ndarray       # (A, L) absolute price units
    premium: np.ndarray      # (A, L) absolute price units (app.py:164-180)
    qty: np.ndarray          # (A, L) float; 0 = padding
    hedged_mask: np.ndarray  # (A,) bool

    @property
    def n_assets(self) -> int:
        return self.type_id.shape[0]

    def tensors(self, device, dtype=torch.float32) -> tuple[torch.Tensor, ...]:
        """``(type_id, strike, premium, qty)`` on ``device``: the type ids as
        int32, the rest in ``dtype``."""
        return (torch.as_tensor(self.type_id, dtype=torch.int32, device=device),
                *(torch.as_tensor(np.asarray(x, np.float64), device=device).to(dtype)
                  for x in (self.strike, self.premium, self.qty)))

    def digest_bytes(self) -> bytes:
        """Stable bytes for checkpoint run digests (mcport's, byte for byte)."""
        return b"".join(np.ascontiguousarray(a, np.float64).tobytes()
                        for a in (self.type_id, self.strike, self.premium, self.qty))

    @classmethod
    def build(cls, legs_by_asset: Mapping[str | int, Legs | Sequence[tuple]] | None,
              names: Sequence[str]) -> "HedgeSpec":
        """From ``{asset name or index: Legs | reference-style rows}``. An
        unknown key raises (a mistyped asset name hedging nothing is refused);
        an asset left out gets the implicit BUY_ASSET qty-1 leg."""
        a = len(names)
        by_idx: dict[int, Legs] = {}
        for key, legs in (legs_by_asset or {}).items():
            if isinstance(key, str):
                if key not in names:
                    raise ValueError(f"legs_by_asset key {key!r} is not in the universe "
                                     f"{list(names)}")
                idx = list(names).index(key)
            else:
                idx = int(key)
                if not 0 <= idx < a:
                    raise ValueError(f"legs_by_asset index {idx} out of range (A={a})")
            if not isinstance(legs, Legs):
                legs = Legs.from_rows(list(legs))
            by_idx[idx] = legs

        max_l = max([1] + [len(v) for v in by_idx.values()])
        type_id = np.zeros((a, max_l), np.int32)
        strike, premium, qty = np.zeros((a, max_l)), np.zeros((a, max_l)), np.zeros((a, max_l))
        mask = np.zeros(a, bool)
        for i in range(a):
            legs = by_idx.get(i)
            if legs is None or len(legs) == 0:
                type_id[i, 0] = int(LegType.BUY_ASSET)
                qty[i, 0] = 1.0
            else:
                n = len(legs)
                type_id[i, :n] = legs.type_id
                strike[i, :n] = legs.strike
                premium[i, :n] = legs.premium
                qty[i, :n] = legs.qty
                mask[i] = True
        return cls(type_id, strike, premium, qty, mask)


def _position_return(S: torch.Tensor, prev: torch.Tensor, type_id, strike, premium,
                     qty) -> torch.Tensor:
    """The qty-weighted leg returns for a move ``prev → S``: ``S (..., A)``,
    per-leg parameters ``(A, L)``, one ``(..., A)`` select chain per leg."""
    dt = S.dtype
    out = torch.zeros_like(S)
    t = torch.as_tensor(type_id, device=S.device)
    k, p, q = (torch.as_tensor(x, device=S.device).to(dt) for x in (strike, premium, qty))
    for l in range(t.shape[-1]):
        out = out + q[:, l] * leg_period_return(t[:, l], S, prev, k[:, l], p[:, l])
    return out


def hedged_terminal_returns(term_log: torch.Tensor, s0, type_id, strike, premium,
                            qty) -> torch.Tensor:
    """(N, A) hedged simple returns from (N, A) terminal LOG returns: the legs
    settle at intrinsic value against ``S_T = s0 · exp(term_log)``; an
    unhedged asset gives ``exp(term_log) - 1``."""
    s0 = torch.as_tensor(s0, device=term_log.device).to(term_log.dtype)
    return _position_return(s0 * torch.exp(term_log), s0, type_id, strike, premium, qty)


def hedged_from_simple(simple: torch.Tensor, s0, type_id, strike, premium,
                       qty) -> torch.Tensor:
    """The terminal composition from terminal SIMPLE returns (the GARCH, DCC,
    Heston and bootstrap terminals): ``S_T = s0 · (1 + simple)``."""
    s0 = torch.as_tensor(s0, device=simple.device).to(simple.dtype)
    return _position_return(s0 * (1.0 + simple), s0, type_id, strike, premium, qty)


def hedged_step_returns(s_prev: torch.Tensor, s_cur: torch.Tensor, type_id, strike, premium,
                        qty) -> torch.Tensor:
    """Per-step hedged returns for a path move ``s_prev → s_cur`` (absolute
    prices, ``(..., A)``): ``calc_options_series``'s per-period settlement
    (``app.py:182-193``) on one simulated step."""
    return _position_return(s_cur, s_prev, type_id, strike, premium, qty)


def hedged_return_bounds(spec: HedgeSpec, s_lo: np.ndarray, s_hi: np.ndarray,
                         s0: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The exact per-asset hedged-return range for ``S ∈ [s_lo, s_hi]``: each
    leg's return is piecewise linear in ``S`` with one kink at its strike, so
    the extrema sit at the ends or at an interior strike — at most ``L + 2``
    points per asset, evaluated (float64, on the host) through the engines'
    leg formula."""
    a, n_legs = spec.type_id.shape
    lo, hi = np.empty(a), np.empty(a)
    for i in range(a):
        pts = [s_lo[i], s_hi[i]] + [k for k in spec.strike[i] if s_lo[i] < k < s_hi[i]]
        S = torch.as_tensor(np.asarray(pts, np.float64))
        r = torch.zeros_like(S)
        for l in range(n_legs):
            if spec.qty[i, l] == 0.0:
                continue
            r = r + spec.qty[i, l] * leg_period_return(
                int(spec.type_id[i, l]), S, float(s0[i]), float(spec.strike[i, l]),
                float(spec.premium[i, l]))
        lo[i], hi[i] = float(r.min()), float(r.max())
    return lo, hi


def auto_hedged_sketch(params, n_steps: int, spec: HedgeSpec, weights=None,
                       k_sigma: float = 12.0, n_bins: int = 8_192,
                       t_dof: float | None = None) -> SketchConfig:
    """A covering LINEAR sketch of hedged portfolio returns: the terminal
    prices bounded by the ``±k_sigma`` Gaussian envelope of the log return
    (widened by the t tail at ``t_dof``), mapped through the exact payoff
    bounds per asset, then combined with the (long-only) weights. Linear
    space, since short legs can take hedged returns below -1."""
    m = np.asarray(params.mean_step, np.float64).reshape(-1)
    lc = np.atleast_2d(np.asarray(params.chol_step, np.float64))
    s0 = np.asarray(params.s0, np.float64).reshape(-1)
    var_step = np.einsum("ij,ij->i", lc, lc)
    mu = n_steps * m
    sd = np.sqrt(n_steps * var_step)
    widen = 0.0
    if t_dof is not None:
        from scipy.stats import t as _t

        x = float(_t.isf(1e-13, t_dof)) / np.sqrt(t_dof / (t_dof - 2.0))
        widen = x * np.sqrt(var_step)
    s_lo = s0 * np.exp(mu - k_sigma * sd - widen)
    s_hi = s0 * np.exp(mu + k_sigma * sd + widen)
    lo_a, hi_a = hedged_return_bounds(spec, s_lo, s_hi, s0)
    if weights is None:
        lo_r, hi_r = float(lo_a.min()), float(hi_a.max())
    else:
        w = np.asarray(weights, np.float64)
        lo_r, hi_r = float(w @ lo_a), float(w @ hi_a)
    pad = max((hi_r - lo_r), 1e-6) / n_bins
    return SketchConfig(n_bins=n_bins, lo=lo_r - pad, hi=hi_r + pad, space="linear")
