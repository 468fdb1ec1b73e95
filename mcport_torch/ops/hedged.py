"""Hedged per-step settlement inside the path kernels: the plain torch form of
``csrc/hedged.cuh`` and what the hedged kernel modes share.

Port of mcport's ``make_hedged_returns`` (``mcport/ops/pallas_multi_dd.py``),
the in-kernel settlement of the hedged modes of ``_multi_dd_kernel`` and
``_jump_dd_kernel``. Every path carries its assets' prices ``P`` from the
spot ``s0``; each step moves them, ``P_new = P · gross``, settles every leg
at intrinsic value against the move, and the candidates compound ``V *= 1 +
W·r_h`` with

    r_h = (Σ_l qty_l · numer_l(P, P_new)) / P          (per asset)

in the kernel's order: the legs' numerators summed in turn (one rounded
product and one rounded sum each), then ONE division by the previous price.
That is not :func:`mcport_torch.options.legs.leg_period_return`'s order (a
division per leg): the two agree to rounding. A leg of unknown type and the
qty-0 padding rows give exactly 0.

:func:`hedged_multi_dd` is the plain form of a hedged candidate kernel from
its log increments, and bounds a kernel's distance from it path by path;
:func:`hedged_shares` holds a kernel to that bound.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["HedgeTensors", "hedged_returns_reference", "hedged_multi_dd", "hedged_shares",
           "hedged_held"]

_EPS = 2.0 ** -24    # float32 unit roundoff


class HedgeTensors(NamedTuple):
    """A hedge as the kernels take it, on one device: the spot ``s0`` (A,)
    float32, the leg ``type_id`` (A, L) int32 and ``strike``, ``premium``,
    ``qty`` (A, L) float32 (absolute price units; qty 0 pads)."""

    s0: torch.Tensor
    type_id: torch.Tensor
    strike: torch.Tensor
    premium: torch.Tensor
    qty: torch.Tensor

    @classmethod
    def from_spec(cls, spec, s0, device) -> "HedgeTensors":
        """From a :class:`mcport_torch.options.hedged.HedgeSpec` and the spots."""
        s0 = torch.as_tensor(np.asarray(s0, np.float64), device=device).to(torch.float32)
        return cls(s0, *spec.tensors(device))

    @property
    def n_legs(self) -> int:
        return self.type_id.shape[1]

    def check(self, a: int, device: torch.device) -> None:
        """Raise unless this hedge covers ``a`` assets on ``device``."""
        if tuple(self.s0.shape) != (a,) or self.type_id.dim() != 2 or \
                self.type_id.shape[0] != a or self.type_id.shape[1] < 1:
            raise ValueError(f"the hedge must cover {a} assets with at least one leg each: "
                             f"s0 {tuple(self.s0.shape)}, legs {tuple(self.type_id.shape)}")
        if self.type_id.dtype != torch.int32:
            raise ValueError(f"hedge type ids must be int32, got {self.type_id.dtype}")
        for name in ("s0", "strike", "premium", "qty"):
            x = getattr(self, name)
            want = (a,) if name == "s0" else tuple(self.type_id.shape)
            if x.dtype != torch.float32 or tuple(x.shape) != want:
                raise ValueError(f"hedge {name} must be float32 {want}, got {x.dtype} "
                                 f"{tuple(x.shape)}")
        if any(x.device != device for x in self):
            raise ValueError(f"the hedge must be on {device}")

    def packed(self) -> torch.Tensor:
        """The kernels' hedge block, float32: s0 (A), then the type ids (exact
        small integers), strikes, premiums and quantities, (A·L) each,
        row-major."""
        return torch.cat([self.s0, self.type_id.to(torch.float32).reshape(-1),
                          self.strike.reshape(-1), self.premium.reshape(-1),
                          self.qty.reshape(-1)]).contiguous()


def hedged_returns_reference(p_prev: torch.Tensor, p_new: torch.Tensor, type_id: torch.Tensor,
                             strike: torch.Tensor, premium: torch.Tensor,
                             qty: torch.Tensor) -> torch.Tensor:
    """Per-asset hedged returns ``(..., A)`` of the moves ``p_prev → p_new``
    under legs ``(A, L)``, in the kernel's operation order: for each leg in
    turn ``r += qty · numer`` (a product and a sum, each rounded), then one
    division by ``p_prev``."""
    zero = torch.zeros((), dtype=p_new.dtype, device=p_new.device)
    up = p_new - p_prev
    r = torch.zeros_like(p_new)
    for l in range(type_id.shape[1]):
        t, k, prem, q = type_id[:, l], strike[:, l], premium[:, l], qty[:, l]
        call_iv = torch.maximum(p_new - k, zero)
        put_iv = torch.maximum(k - p_new, zero)
        numer = torch.where(t == 5, prem - put_iv, zero)
        numer = torch.where(t == 4, put_iv - prem, numer)
        numer = torch.where(t == 3, prem - call_iv, numer)
        numer = torch.where(t == 2, call_iv - prem, numer)
        numer = torch.where((t == 1) | (t == 6), -up, numer)
        numer = torch.where(t == 0, up, numer)
        r = r + q * numer
    return r / p_prev


def _leg_scales(p_prev: torch.Tensor, p_new: torch.Tensor, r: torch.Tensor,
                hedge: HedgeTensors, delta: torch.Tensor):
    """Per asset ``(..., A)``, for :func:`hedged_multi_dd`'s bound, over one
    move ``p_prev → p_new`` with settled returns ``r``:

    - ``s``: how far ``r_h`` moves per unit of relative price difference
      ``δ`` (at this step or the last), to first order: ``|r|`` for the
      division, ``|qty| |up| / p_prev`` per asset leg, ``|qty| p_new /
      p_prev`` per option leg in the money on either side (``delta``, the
      price bound, decides "either side"); an out-of-the-money leg settles to
      its premium on both sides;
    - ``g``: the asset legs' part that follows the step-to-step change of
      ``δ`` instead, ``|qty| p_new / p_prev``: over the steps it telescopes;
    - ``u``: the magnitude, relative to ``p_prev``, of every result the
      settlement rounds (each rounding is at most ``2^-24`` of it)."""
    up = p_new - p_prev
    s, g = r.abs(), torch.zeros_like(r)
    u, qn = up.abs(), torch.zeros_like(r)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    for l in range(hedge.n_legs):
        t = hedge.type_id[:, l]
        k, prem, q = (x[:, l].to(r.dtype) for x in (hedge.strike, hedge.premium, hedge.qty))
        asset = (t == 0) | (t == 1) | (t == 6)
        call, put = (t == 2) | (t == 3), (t == 4) | (t == 5)
        live = ((call & (p_new * (1.0 + 2.0 * delta) > k))
                | (put & (p_new * (1.0 - 2.0 * delta) < k)))
        iv = torch.where(call, (p_new - k).clamp_min(0.0), (k - p_new).clamp_min(0.0))
        s = s + torch.where(asset, q.abs() * up.abs(),
                            torch.where(live, q.abs() * p_new, zero)) / p_prev
        g = g + torch.where(asset, q.abs() * p_new / p_prev, zero)
        numer = torch.where(asset, up.abs(), torch.where(call | put, iv + prem.abs(), zero))
        u = u + torch.where(call | put, (p_new - k).abs() + numer, zero)
        qn = qn + q.abs() * numer
    return s, g, (u + (hedge.n_legs + 1) * qn) / p_prev + r.abs()


def hedged_multi_dd(x: torch.Tensor, hedge: HedgeTensors, weights: torch.Tensor,
                    score_dtype: str = "float32", price_bound: torch.Tensor | None = None,
                    value_bound: float = 0.0, gross: bool = False) -> tuple[torch.Tensor, ...]:
    """(terminal returns, max drawdowns), each ``(..., W, n)``, of ``W``
    candidates ``weights (W, A)`` over log increments ``x (..., n, T, A)``:
    ``P_0 = s0``, ``P_t = P_{t-1} · exp(x_t)`` (with ``gross``, ``x`` holds
    the steps' gross factors and ``P_t = P_{t-1} · x_t``: the GARCH and
    bootstrap families), ``V_t = V_{t-1} (1 + W·r_h)``
    with :func:`hedged_returns_reference`, from ``V_0 = peak_0 = 1``, ``dd_0 =
    0`` — the hedged kernels' path, step by step, in the score tier's
    numerics (:mod:`mcport_torch.ops.multi_dd`).

    With ``price_bound``, a kernel family's bound on the relative difference
    of each asset's price from this form's — ``(A,)`` at any step (its log
    paths' bound), or ``(..., n, T, A)`` step by step along each path (DCC's,
    :func:`mcport_torch.ops.dcc.dcc_price_bound`) — a third output ``(...,
    W, n)`` bounds the relative difference of each (candidate, path)'s value
    at every step, along this path, to first order in the bound: with ``c_t
    = 1 / |1 + W·r_h|`` and
    :func:`_leg_scales`,

        Σ_t c_t Σ_a |w_a| δ_a s_a,t                     (the price levels)
      + sqrt(Σ_t (c_t Σ_a |w_a| δ_a g_a,t)² / T)        (the asset legs: the
                                                         change of δ per step,
                                                         a random walk)
      + 4 sqrt(Σ_t (2^-23 (c_t Σ_a |w_a| (u_a,t + A |r_a,t|) + 2))²)
                                                        (both sides' roundings
                                                         of the settlement and
                                                         the score, 4 sigma)
      + value_bound                                     (the score tier's)

    An option leg keeps the price's past difference, so the first term adds
    up over the steps a leg is in the money, and only over those. The
    terminal return then differs by at most ``bound · (1 + |term|)``, the
    drawdown by ``2 · bound`` (:func:`hedged_shares`)."""
    from mcport_torch.ops.multi_dd import _score

    w = weights.to(x.dtype)
    p = hedge.s0.to(x.dtype).expand(x.shape[:-2] + x.shape[-1:])
    v = torch.ones(x.shape[:-2] + (w.shape[0],), dtype=x.dtype, device=x.device)
    peak, dd = torch.ones_like(v), torch.zeros_like(v)
    if price_bound is not None:
        aw = w.abs().T
        lin, walk, rounding = torch.zeros_like(v), torch.zeros_like(v), torch.zeros_like(v)
    for t in range(x.shape[-2]):
        p_new = p * (x[..., t, :] if gross else torch.exp(x[..., t, :]))
        r = hedged_returns_reference(p, p_new, hedge.type_id, hedge.strike, hedge.premium,
                                     hedge.qty)
        f = _score(r, w, score_dtype)
        if price_bound is not None:
            delta = (price_bound[..., t, :] if price_bound.dim() > 1
                     else price_bound).to(x.dtype)
            s, g, u = _leg_scales(p, p_new, r, hedge, delta)
            c = 1.0 / (1.0 + f).abs()
            lin = lin + c * ((delta * s) @ aw)
            walk = walk + (c * ((delta * g) @ aw)) ** 2
            rounding = rounding + (2.0 * _EPS * (c * ((u + r.shape[-1] * r.abs()) @ aw) + 2.0)) ** 2
        v = v * (1.0 + f)
        peak = torch.maximum(peak, v)
        dd = torch.minimum(dd, v / peak - 1.0)
        p = p_new
    out = (torch.movedim(v - 1.0, -1, -2), torch.movedim(dd, -1, -2))
    if price_bound is None:
        return out
    bound = (lin + torch.sqrt(walk / max(x.shape[-2], 1)) + 4.0 * torch.sqrt(rounding)
             + value_bound)
    return (*out, torch.movedim(bound, -1, -2))


def _overflow(kernel, plain):
    """Masks over the (candidate, path)s of a hedged comparison: ``both``
    finite on both sides; ``same`` non-finite on both, with the same
    terminal value (``±inf`` or NaN) and drawdown (NaN once the wealth
    overflowed: ``inf / inf``); ``edge`` finite on one side only, where the
    finite side's wealth lies within the bound of float32's largest value
    (the last step decided it); and ``astray``, every other."""
    k, p, bound = kernel[0], plain[0], plain[2]
    kf, pf = torch.isfinite(k), torch.isfinite(p)
    both = kf & pf

    def same(x, y):
        return (x == y) | (torch.isnan(x) & torch.isnan(y))

    same_nf = ~kf & ~pf & same(k, p) & same(kernel[1], plain[1])
    finite_side = torch.where(kf, k, p).to(torch.float64)
    edge = (kf ^ pf) & ((1.0 + finite_side).abs() * (1.0 + bound.to(torch.float64))
                        >= torch.finfo(torch.float32).max)
    return both, same_nf, edge, ~(both | same_nf | edge)


def hedged_shares(kernel, plain, plain_f32, score_dtype: str = "float32") -> dict[str, float]:
    """The largest share of its bound that ``|kernel - plain|`` uses, per
    output ``{"term", "dd"}``. ``plain`` is ``(term, dd, bound)``, the plain
    form with ``price_bound`` (:func:`hedged_multi_dd`): the terminal return
    is held to ``bound · (1 + |plain|)``, the drawdown to ``2 · bound``, path
    by path. In the bfloat16 tier, as
    :func:`mcport_torch.ops.multi_dd.multi_dd_shares` does, in aggregate
    against a quarter of the tier's own rounding (``plain - plain_f32``).

    Per-step settlement pays an in-the-money leg's intrinsic value every
    step, so a path's wealth can leave float32's range (mcport's
    semantics). Such paths are held too (:func:`_overflow`): non-finite on
    both sides they must be the same value, and a path finite on one side
    only must have crossed float32's edge within the bound; anything else
    gives ``inf``, as does a non-finite drawdown on a path finite on both
    sides. :func:`hedged_held` counts each kind."""
    both, _, _, astray = _overflow(kernel, plain)
    bad = bool(astray.any()) or not bool(torch.isfinite(kernel[1][both]).all())
    out = {}
    for i, name in enumerate(("term", "dd")):
        k, p, b = kernel[i][both], plain[i][both], plain[2][both]
        if bad:
            out[name] = math.inf
        elif k.numel() == 0:
            out[name] = 0.0
        elif score_dtype == "bfloat16":
            spread = float((p - plain_f32[i][both]).abs().mean())
            out[name] = float((k - p).abs().mean()) / max(0.25 * spread, 1e-30)
        else:
            tol = b * (1.0 + p.abs()) if name == "term" else 2.0 * b
            out[name] = float(((k - p).abs() / tol).max())
    return out


def hedged_held(kernel, plain) -> dict[str, float]:
    """How a hedged comparison (:func:`hedged_shares`) held its (candidate,
    path)s: the counts ``finite`` (to the bound), ``overflowed`` (the same
    non-finite values on both sides), ``edge`` and ``astray``, and the worst
    ``|kernel - plain|`` of the finite ones as ``max_abs`` (terminal return
    and drawdown) and ``max_rel`` (the terminal return over ``1 + |plain|``)."""
    both, same_nf, edge, astray = _overflow(kernel, plain)
    out = {"finite": int(both.sum()), "overflowed": int(same_nf.sum()),
           "edge": int(edge.sum()), "astray": int(astray.sum()), "max_abs": 0.0,
           "max_rel": 0.0}
    if out["finite"]:
        d = [(kernel[i][both] - plain[i][both]).abs() for i in range(2)]
        out["max_abs"] = max(float(x.max()) for x in d)
        out["max_rel"] = float((d[0] / (1.0 + plain[0][both].abs())).max())
    return out
