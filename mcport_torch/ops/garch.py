"""CCC-GARCH(1,1) paths: the CUDA GARCH kernels and their plain torch forms.

Port of ``mcport/ops/pallas_garch.py``, both modes. Two kernels
(``csrc/garch.cu``) replace ``_garch_kernel`` and ``_garch_dd_kernel``: per
path and step they correlate the shocks with the Cholesky factor ``L_R`` of the
constant correlation, ``zc = L_R z``, update the conditional variance
``sigma2 = omega + alpha eps2_prev + beta sigma2``, draw the innovation ``eps =
sqrt(max(sigma2, 0)) zc`` and the return ``r = mu + eps``; then

- :func:`garch_terminal` compounds every asset, ``cum *= 1 + mu + eps`` → the
  terminal simple returns ``cum - 1``;
- :func:`garch_multi_portfolio_dd` compounds ``W`` candidate portfolios'
  per-period rebalanced wealth ``V *= 1 + w·r`` (float32, mcport's
  ``score_dot``) with the running peak and maximum drawdown; hedged
  (``hedge``), the prices ``P *= 1 + mu + eps`` from the spots settle every
  option leg each step and ``V *= 1 + w·r_h`` (:mod:`mcport_torch.ops.hedged`).

The shocks are the GBM kernels' normals on ``STREAM_GBM``
(:func:`mcport_torch.ops.gbm.step_shocks`), so the plain forms are
``step_shocks`` followed by :func:`garch_innovations`. The terminal
kernel also takes unit-variance Student-t shocks (mcport's GARCH-t lax
sampler): ``t_df`` folds the ``1/sqrt(df/(df-2))`` scale into ``L_R``. The
candidate kernel draws normal shocks only, as mcport's does.

Up to 16 assets the candidate kernel runs the layout
:func:`garch_narrow_plan` gives its candidate count
(:mod:`mcport_torch.ops.narrow`): a thread per path scoring its own few
candidates, or for more the same recursion's returns through a device
scratch, scored by blocks of candidates; the layouts' outputs are equal bit
for bit.

Each wrapper dispatches on the device of its tensors: the CPU goes to the
plain form, a CUDA device launches the kernel or raises. The plain forms and
the card take any number of assets: from 17 to 64 through the kernels' wide
variants, past 64 through the layout of ``csrc/wide.cuh``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mcport_torch.ops.gbm import (_BM_CODE, _T_CODE, MAX_ASSETS, WIDE_CTAS, _check_args,
                                  check_card_assets, sqrt_rn, wide_scratch, wide_tile,
                                  step_shocks, t_scaled_chol)
from mcport_torch.ops.hedged import HedgeTensors, hedged_multi_dd, hedged_shares
from mcport_torch.ops.multi_dd import MAX_CANDIDATES, rebalanced_dd
from mcport_torch.ops.narrow import (LAYOUTS, NARROW_ASSETS, NARROW_SCRATCH_FLOATS, NarrowPlan,
                                     narrow_plan, r4)

__all__ = [
    "GarchTensors",
    "correlated_shocks",
    "garch_innovations",
    "garch_terminal_reference",
    "garch_terminal",
    "garch_multi_dd_reference",
    "garch_multi_portfolio_dd",
    "garch_tolerance",
    "garch_price_bound",
    "garch_shares",
    "garch_value_bound",
    "garch_narrow_plan",
]

_EPS = 2.0 ** -24    # float32 unit roundoff
#: csrc/garch.cu ``kSoloMaxCand``: the solo layout's widest W (the split layout past it)
_SOLO_MAX_CAND = 13


def _recur_floats(a: int, w: int, own: bool, legs: int) -> int:
    """csrc/garch.cu ``RecurLayout(a, w, own ? kOwn : kReturns, legs).total``."""
    h = 16 * 16 + 4 * 16
    p = h + (r4(a * (1 + 4 * legs)) if legs else 0) + (w * 16 if own else 0)
    return p + (16 * 64 if legs else 0) + (3 * w * 64 if own else 0)


def garch_narrow_plan(n_assets: int, n_cand: int, n_steps: int = 252,
                      block_paths: int = 131_072, n_blocks: int = 1, n_legs: int = 0,
                      scratch_floats: int = NARROW_SCRATCH_FLOATS,
                      layout: str | None = None) -> NarrowPlan:
    """The GARCH candidate kernel's layout for ``n_cand`` candidates (W <= 256)
    at ``n_assets <= 16`` (csrc/garch.cu ``narrow_layout`` and its layouts'
    shared memory, the same arithmetic): solo up to 13 candidates, split past
    them (the faster two on an H100 at every W, and split faster than the
    former 16-path tile kernel at every W, measured by
    ``tools/ab_narrow_kernels.py``), or ``layout`` by name. The split
    layout's scratch holds ``n_blocks x chunk x n_steps x n_assets`` returns,
    no more than ``scratch_floats``."""
    return narrow_plan("the GARCH candidate kernel", n_assets, n_cand, n_steps, block_paths,
                       n_blocks, n_legs, scratch_floats, _SOLO_MAX_CAND, MAX_CANDIDATES,
                       _recur_floats, None, layout)


class GarchTensors(NamedTuple):
    """CCC-GARCH(1,1) parameters as float32 tensors on one device: ``mu``,
    ``omega``, ``alpha``, ``beta``, ``sigma2_0``, ``eps2_0`` (A,) and
    ``corr_chol`` (A, A), the lower Cholesky factor of the correlation."""

    mu: torch.Tensor
    omega: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    corr_chol: torch.Tensor
    sigma2_0: torch.Tensor
    eps2_0: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.corr_chol.device

    def packed(self, chol: torch.Tensor) -> torch.Tensor:
        """The kernels' parameter block: ``chol`` (A·A, row-major), then mu,
        omega, alpha, beta, sigma2_0, eps2_0 (A each), float32, contiguous."""
        return torch.cat([chol.reshape(-1), self.mu, self.omega, self.alpha, self.beta,
                          self.sigma2_0, self.eps2_0]).contiguous()


def _check(g: GarchTensors, n_paths: int, n_steps: int, n_blocks: int, t_df) -> int:
    a = g.corr_chol.shape[0]
    for name, x in g._asdict().items():
        want = (a, a) if name == "corr_chol" else (a,)
        if x.dtype != torch.float32 or tuple(x.shape) != want or x.device != g.device:
            raise ValueError(f"GARCH parameter {name} must be float32 {want} on "
                             f"{g.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    _check_args(g.corr_chol, n_paths, n_steps, n_blocks, "poly", t_df)
    return a


def garch_innovations(zc: torch.Tensor, g: GarchTensors) -> torch.Tensor:
    """Innovations ``eps_t`` ``(..., T, A)`` from correlated shocks ``zc
    (..., T, A)``: ``sigma2_t = omega + alpha eps_{t-1}^2 + beta
    sigma2_{t-1}`` from ``(sigma2_0, eps2_0)``, ``eps_t = sqrt(max(sigma2_t,
    0)) zc_t`` — the variance recursion of mcport's ``_garch_kernel``, in its
    order of operations. The step's return is ``mu + eps_t``."""
    s2 = g.sigma2_0.expand(zc.shape[:-2] + zc.shape[-1:])
    e2 = g.eps2_0.expand_as(s2)
    out = []
    for t in range(zc.shape[-2]):
        s2 = g.omega + g.alpha * e2 + g.beta * s2
        eps = sqrt_rn(torch.clamp_min(s2, 0.0)) * zc[..., t, :]
        e2 = eps * eps
        out.append(eps)
    if not out:
        return zc.new_zeros(zc.shape)
    return torch.stack(out, dim=-2)


def correlated_shocks(seed: int, g: GarchTensors, n_paths: int, n_steps: int, *,
                      first_block: int = -1, n_blocks: int = 1, first_path: int = 0,
                      t_df: float | None = None) -> torch.Tensor:
    """``zc = L_R z`` ``(n_blocks, n_paths, n_steps, A)`` on the kernels'
    counters (``t_df``: unit-variance Student-t shocks); like the kernels,
    only the lower triangle of ``L_R`` is read."""
    chol = torch.tril(t_scaled_chol(g.corr_chol, t_df))
    z = step_shocks(seed, chol.shape[0], n_paths, n_steps, first_block=first_block,
                    n_blocks=n_blocks, first_path=first_path, t_df=t_df, device=g.device)
    return z @ chol.T


def garch_terminal_reference(
    seed: int,
    g: GarchTensors,
    n_paths: int,
    n_steps: int,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
    first_path: int = 0,
    t_df: float | None = None,
) -> torch.Tensor:
    """Plain torch form of the GARCH terminal kernel: terminal simple returns
    ``(n_blocks, n_paths, A)`` float32 for paths ``first_path ..`` of each
    block. Runs on any device; the tests use it on the CPU and
    ``chip_smoke.py`` holds the kernel against it on the card."""
    _check(g, n_paths, n_steps, n_blocks, t_df)
    zc = correlated_shocks(seed, g, n_paths, n_steps, first_block=first_block,
                           n_blocks=n_blocks, first_path=first_path, t_df=t_df)
    eps = garch_innovations(zc, g)
    cum = torch.ones_like(eps[..., 0, :])
    one_mu = 1.0 + g.mu
    for t in range(n_steps):
        cum = cum * (one_mu + eps[..., t, :])   # mcport's 1.0 + mu + eps
    return cum - 1.0


def _launch_terminal(seed, g, n_paths, n_steps, first_block, n_blocks, t_df, wide=False):
    """Launch kernel #4; ``wide`` takes the 17-64-asset tile kernel at any
    width (``chip_smoke.py`` times the two layouts at 15 assets)."""
    from mcport_torch._build import library

    lib = library("garch")
    a = g.corr_chol.shape[0]
    out = torch.empty((n_blocks, n_paths, a), dtype=torch.float32, device=g.device)
    if n_paths == 0:
        return out
    params = g.packed(t_scaled_chol(g.corr_chol, t_df))
    df = 0.0 if t_df is None else float(t_df)
    neg2_over_df = 0.0 if t_df is None else -2.0 / float(t_df)
    tier = _T_CODE if t_df is not None else _BM_CODE["poly"]
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        if a > MAX_ASSETS:   # csrc/wide.cuh's layout: sigma2 and the gross
            tp = wide_tile(a)
            scratch = wide_scratch(2 * a * WIDE_CTAS * tp, g.device, "GARCH")
            err = lib.mcport_garch_wide(seed, first_block, n_blocks, n_paths, a, 0, n_steps,
                                        tier, df, neg2_over_df, 0, params.data_ptr(), None,
                                        None, out.data_ptr(), None, scratch.data_ptr(), tp,
                                        WIDE_CTAS, stream)
        else:
            err = lib.mcport_garch_terminal(seed, first_block, n_blocks, n_paths, a, n_steps,
                                            int(wide), tier, df, neg2_over_df,
                                            params.data_ptr(), out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"GARCH terminal kernel launch failed: CUDA error {err} "
                           f"({lib.mcport_error_string(err).decode()})")
    garch_terminal.launches += 1
    garch_terminal.wide_launches += int(a > MAX_ASSETS)
    return out


def garch_terminal(
    seed: int,
    g: GarchTensors,
    n_paths: int,
    n_steps: int,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
    t_df: float | None = None,
) -> torch.Tensor:
    """Terminal simple returns ``(n_blocks, n_paths, A)`` float32 of CCC-GARCH
    paths for the blocks ``first_block + 1 .. first_block + n_blocks`` of a run
    seeded ``seed`` (one block keyed by ``seed`` itself by default) —
    mcport's ``pallas_garch_terminal_returns``. ``t_df`` draws unit-variance
    Student-t shocks.

    Parameters on a CUDA device launch the kernel, counted in
    ``garch_terminal.launches``; on the CPU the plain form runs. Any other
    device, or a problem the kernel does not take, raises.
    """
    _check(g, n_paths, n_steps, n_blocks, t_df)
    if g.device.type == "cpu":
        return garch_terminal_reference(seed, g, n_paths, n_steps, first_block=first_block,
                                        n_blocks=n_blocks, t_df=t_df)
    if g.device.type != "cuda":
        raise ValueError(f"no GARCH kernel for device {g.device}")
    check_card_assets(g.corr_chol.shape[0], "GARCH")
    return _launch_terminal(seed, g, n_paths, n_steps, first_block, n_blocks, t_df)


garch_terminal.launches = 0
garch_terminal.wide_launches = 0   # the wide layout's share of ``launches`` (A > 64)


def garch_multi_dd_reference(
    seed: int,
    g: GarchTensors,
    weights: torch.Tensor,
    n_paths: int,
    n_steps: int,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
    first_path: int = 0,
    hedge: HedgeTensors | None = None,
    with_bound: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Plain torch form of the GARCH candidate kernel: ``(term, dd)``, each
    ``(n_blocks, W, n_paths)`` float32, for paths ``first_path ..`` of each
    block. ``hedge``: the hedged mode, mcport's ``_garch_dd_kernel`` hedged
    branch — ``P_0 = s0``, ``P_t = P_{t-1} · (1 + mu + eps_t)`` (the gross
    rounded as the kernel rounds it, ``(1 + mu) + eps``), every leg settled
    against the move (:func:`mcport_torch.ops.hedged.hedged_multi_dd`); with
    ``with_bound`` a third output bounds each (candidate, path)'s distance
    from the kernel (:func:`garch_price_bound`), unhedged each candidate's
    relative one ``(W, 1)`` (:func:`garch_value_bound` of these returns)."""
    _check(g, n_paths, n_steps, n_blocks, None)
    zc = correlated_shocks(seed, g, n_paths, n_steps, first_block=first_block,
                           n_blocks=n_blocks, first_path=first_path)
    eps = garch_innovations(zc, g)
    if hedge is None:
        r = g.mu + eps
        out = rebalanced_dd(r, weights)
        if not with_bound:
            return out
        r_max = float(r.abs().max()) if r.numel() else 0.0
        return (*out, garch_value_bound(g, weights, r_max, n_steps).to(g.device))
    return hedged_multi_dd((1.0 + g.mu) + eps, hedge, weights.to(torch.float32),
                           price_bound=(garch_price_bound(g, n_steps).to(g.device)
                                        if with_bound else None), gross=True)


def _launch_dd(seed, g, weights, n_paths, n_steps, first_block, n_blocks, wide=False,
               hedge=None, layout=None):
    """Launch kernel #5 for at most ``MAX_CANDIDATES``, hedged with ``hedge``;
    up to 16 assets in the layout of :func:`garch_narrow_plan`, or in
    ``layout`` by name; ``wide`` takes the 64-asset instantiation at any width
    up to 64."""
    from mcport_torch._build import library

    lib = library("garch")
    w_cnt, a = weights.shape
    term = torch.empty((n_blocks, w_cnt, n_paths), dtype=torch.float32, device=g.device)
    dd = torch.empty((n_blocks, w_cnt, n_paths), dtype=torch.float32, device=g.device)
    if n_paths == 0:
        return term, dd
    params = g.packed(g.corr_chol)
    weights = weights.contiguous()
    block = hedge.packed() if hedge is not None else None
    n_legs = hedge.n_legs if hedge is not None else 0
    hp = block.data_ptr() if block is not None else None
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        if a > MAX_ASSETS:   # csrc/wide.cuh's layout: sigma2 and, hedged, the price
            tp = wide_tile(a)
            scratch = wide_scratch((2 if hedge is not None else 1) * a * WIDE_CTAS * tp,
                                   g.device, "GARCH")
            err = lib.mcport_garch_wide(seed, first_block, n_blocks, n_paths, a, w_cnt, n_steps,
                                        _BM_CODE["poly"], 0.0, 0.0, n_legs, params.data_ptr(),
                                        weights.data_ptr(), hp, term.data_ptr(), dd.data_ptr(),
                                        scratch.data_ptr(), tp, WIDE_CTAS, stream)
        else:
            scratch, code = None, -1
            if a <= NARROW_ASSETS and not wide:
                plan = garch_narrow_plan(a, w_cnt, n_steps, n_paths, n_blocks, n_legs,
                                         layout=layout)
                code = -1 if layout is None else LAYOUTS[plan.layout]
                if plan.scratch_floats:
                    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32,
                                          device=g.device)
            err = lib.mcport_garch_multi_dd(
                seed, first_block, n_blocks, n_paths, a, w_cnt, n_steps, int(wide), n_legs,
                params.data_ptr(), weights.data_ptr(), hp, term.data_ptr(), dd.data_ptr(),
                scratch.data_ptr() if scratch is not None else None,
                scratch.numel() if scratch is not None else 0, code, stream)
    if err:
        raise RuntimeError(f"GARCH candidate kernel launch failed: CUDA error {err} "
                           f"({lib.mcport_error_string(err).decode()})")
    garch_multi_portfolio_dd.launches += 1
    garch_multi_portfolio_dd.wide_launches += int(a > MAX_ASSETS)
    if hedge is not None:
        garch_multi_portfolio_dd.hedged_launches += 1
    return term, dd


def garch_multi_portfolio_dd(
    seed: int,
    g: GarchTensors,
    weights: torch.Tensor,
    n_paths: int,
    n_steps: int,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
    hedge: HedgeTensors | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(terminal returns, max drawdowns), each ``(n_blocks, W, n_paths)``
    float32, of ``W`` candidates ``weights (W, A)`` compounding rebalanced
    wealth over the CCC-GARCH paths of blocks ``first_block + 1 ..
    first_block + n_blocks`` — mcport's ``pallas_garch_path_stats``.

    ``hedge`` (a :class:`mcport_torch.ops.hedged.HedgeTensors` on the same
    device) selects hedged per-step settlement, mcport's ``hedge_args``: the
    prices move ``P *= 1 + mu + eps`` from the spots, every leg settles each
    step, and the candidates compound ``V *= 1 + W·r_h``. More than
    ``MAX_CANDIDATES`` candidates run as several launches over the same paths.
    Tensors on a CUDA device launch the kernel, each launch counted in
    ``garch_multi_portfolio_dd.launches`` (a hedged one in
    ``.hedged_launches`` too); on the CPU the plain form runs. Any other
    device, or a problem the kernel does not take, raises.
    """
    a = _check(g, n_paths, n_steps, n_blocks, None)
    w = weights.to(torch.float32)
    if w.dim() != 2 or w.shape[1] != a or w.shape[0] < 1 or w.device != g.device:
        raise ValueError(f"weights must be (W >= 1, {a}) on {g.device}, got "
                         f"{tuple(w.shape)} on {w.device}")
    if hedge is not None:
        hedge.check(a, g.device)
    if g.device.type == "cpu":
        return garch_multi_dd_reference(seed, g, w, n_paths, n_steps,
                                        first_block=first_block, n_blocks=n_blocks,
                                        hedge=hedge)[:2]
    if g.device.type != "cuda":
        raise ValueError(f"no GARCH kernel for device {g.device}")
    check_card_assets(a, "GARCH")
    parts = [_launch_dd(seed, g, w[i:i + MAX_CANDIDATES], n_paths, n_steps, first_block,
                        n_blocks, hedge=hedge)
             for i in range(0, w.shape[0], MAX_CANDIDATES)]
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts], dim=1), torch.cat([p[1] for p in parts], dim=1))


garch_multi_portfolio_dd.launches = 0
garch_multi_portfolio_dd.wide_launches = 0   # the wide layout's share of ``launches`` (A > 64)
garch_multi_portfolio_dd.hedged_launches = 0   # the hedged mode's share of ``launches``


def garch_price_bound(g: GarchTensors, n_steps: int) -> torch.Tensor:
    """Per-asset bound ``(A,)`` on the relative difference of the hedged GARCH
    kernel's price ``P`` from its plain form's at any step. The price
    compounds the gross ``1 + mu + eps`` as the terminal kernel's value does
    (``P = s0 · cum``), with the same operations: so it is
    :func:`garch_tolerance`'s relative bound, built from the same terms (the
    draws' 2e-6 through ``sigma Σ_j |L_ij|`` and two roundings per step, a
    random walk over ``n`` steps with a factor 4). The hedged plain form turns
    it into a bound per (candidate, path) (:func:`mcport_torch.ops.hedged
    .hedged_multi_dd`)."""
    return garch_tolerance(g, n_steps)


def garch_tolerance(g: GarchTensors, n_steps: int, t_df: float | None = None) -> torch.Tensor:
    """Relative bound per asset ``(A,)`` on ``|kernel - plain form|`` of a
    compounded GARCH value: ``|Δ| <= rel_i · (1 + |plain|)`` for the
    terminal returns of :func:`garch_terminal`.

    Per step the two sides differ by the draws (at most 2e-6 each, as
    :func:`mcport_torch.ops.gbm.kernel_tolerance` has it, through ``Σ_j
    |L_ij|`` and the volatility ``σ``) and by float32 rounding of the gross
    return (two roundings of 2^-24); the differences add up like a random
    walk over ``n`` steps, with a factor 4 of headroom. ``σ`` is three times
    the largest of the start, the first step's and the unconditional
    volatility.
    """
    chol = t_scaled_chol(g.corr_chol, t_df).to(torch.float64).cpu()
    s2_first = g.omega + g.alpha * g.eps2_0 + g.beta * g.sigma2_0
    persist = (g.alpha + g.beta).clamp_max(0.999)
    s2_bar = torch.maximum(torch.maximum(g.sigma2_0, s2_first), g.omega / (1.0 - persist))
    sigma = 3.0 * torch.sqrt(s2_bar.to(torch.float64).cpu())
    per_step = 2.0 * _EPS + 2e-6 * sigma * chol.abs().sum(dim=1)
    return (4.0 * math.sqrt(max(n_steps, 1)) * per_step).to(torch.float32)


def garch_value_bound(g: GarchTensors, weights: torch.Tensor, r_max: float,
                      n_steps: int) -> torch.Tensor:
    """Relative bound ``(W, 1)`` on ``|kernel - plain form|`` of each
    candidate's value over returns no larger than ``r_max`` in magnitude:
    ``|Δterm| <= rel (1 + |term|)``, ``|Δdd| <= 2 rel``.

    The largest asset bound (:func:`garch_tolerance`) plus the score's share.
    At every step the score sums its ``A`` terms ``w_a r_a`` in an order of
    its own (the kernels ascend the assets, the plain form's ``r @ w.T``
    sums in whatever order the library picks for the problem's size): ``A``
    roundings of at most ``2^-24 h``, ``h = Σ_a |w_a| · r_max`` bounding
    ``Σ_a |w_a r_a|``; and the roundings of ``1 + f`` and the product (two
    of ``2^-24``). Every one of these enters at every step, so over ``n``
    steps they add up like a random walk; with a factor 4 of headroom the
    score's share is ``4 sqrt(n) 2^-24 (2 + A h)``, as
    :func:`mcport_torch.ops.bootstrap.bootstrap_shares` has it for the same
    score, and never below the former share, which counted the score's
    roundings once at a full ``2^-24`` each (``8 · 2^-24 · (A + sqrt(n))``)."""
    a, n = g.corr_chol.shape[0], max(n_steps, 1)
    h = weights.detach().to("cpu", torch.float64).abs().sum(dim=1) * float(r_max)
    score = torch.clamp(4.0 * _EPS * math.sqrt(n) * (2.0 + a * h),
                        min=8.0 * _EPS * (a + math.sqrt(n)))
    return (float(garch_tolerance(g, n_steps).max()) + score).to(torch.float32).view(-1, 1)


def garch_shares(kernel, plain, g: GarchTensors, n_steps: int,
                 t_df: float | None = None,
                 hedge: HedgeTensors | None = None) -> dict[str, float]:
    """The largest share of its bound that ``|kernel - plain|`` uses →
    ``{"term"}`` for a terminal tensor ``(..., A)`` (:func:`garch_tolerance`),
    ``{"term", "dd"}`` for a candidate pair ``(term, dd)`` against the bound
    that ``plain`` carries (:func:`garch_multi_dd_reference` ``with_bound``;
    :func:`garch_value_bound`). Non-finite kernel values give ``inf``.
    Hedged (``hedge``): path by path against the bound that ``plain``
    carries, by :func:`mcport_torch.ops.hedged.hedged_shares`."""
    if not isinstance(kernel, torch.Tensor) and len(plain) != 3:
        raise ValueError("a candidate comparison needs the plain form's bound (with_bound)")
    if hedge is not None:
        return hedged_shares(kernel, plain, None)
    rel = garch_tolerance(g, n_steps, t_df).to(g.device)

    def share(k, p, tol):
        if not bool(torch.isfinite(k).all()):
            return math.inf
        return float(((k - p).abs() / tol).max()) if k.numel() else 0.0

    if isinstance(kernel, torch.Tensor):
        return {"term": share(kernel, plain, rel * (1.0 + plain.abs()))}
    r = plain[2].to(plain[0].device)
    return {"term": share(kernel[0], plain[0], r * (1.0 + plain[0].abs())),
            "dd": share(kernel[1], plain[1], (2.0 * r).expand_as(plain[1]))}
