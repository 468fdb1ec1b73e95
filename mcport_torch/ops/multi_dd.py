"""Many candidate portfolios over one shared set of paths: the CUDA multi-dd
kernel and its plain torch form.

Port of ``gbm_multi_portfolio_dd`` (``mcport/ops/pallas_multi_dd.py``), its
three modes. The kernels replace ``_multi_dd_kernel``: up to 16 assets one
per-path GBM recursion on the shared narrow layouts (``csrc/gbm_narrow.cu``,
the layout :func:`gbm_narrow_plan` picks by W, mode and score tier: a thread
per path scoring its own few candidates, or the recursion's returns
through a device scratch to scoring blocks), from 17 to 64 assets
``csrc/multi_dd.cu``'s 16-path tile kernel, past 64 ``csrc/wide.cuh``'s
layout; their outputs are equal bit for bit. Per path each evolves the log
prices step by step on the shocks of the other GBM kernels
(``csrc/gbm_draws.cuh``) and scores every candidate per step —
buy-and-hold ``V_t = W·exp(logS_t)``, rebalanced ``V_t = V_{t-1} ·
W·exp(x_t)``, or hedged ``V_t = V_{t-1} (1 + W·r_h)`` with the option legs
settled per step against the prices ``P_t = P_{t-1} exp(x_t)`` from the spot
(:mod:`mcport_torch.ops.hedged`) — tracking each (candidate, path)'s peak and
maximum drawdown. With one candidate it is :func:`mcport_torch.ops.path_stats
.gbm_path_stats`'s ``(port, dd)``.

Score tiers, mcport's numerics (``SCORE_DTYPES``): "float32"; "tensorfloat32",
mcport's 3-product bf16 split ``w1·e1 + w1·e2 + w2·e1`` (~1.5e-5 relative; not
Hopper's TF32); "bfloat16", both operands rounded to bf16, FP32 sums (~2e-3,
for screening with an exact rescore). Buy-and-hold terminal returns are the
FP32 score in every tier.

The plain form draws the same shocks, builds the log paths and reduces them
with :func:`multi_dd_from_log_paths`, the deterministic counterpart of the
post-path half of mcport's ``_lax_multi_dd``, with the tiers' bf16 rounding
emulated in torch. :func:`gbm_multi_portfolio_dd` dispatches on the device of
its tensors: the CPU goes to the plain form, a CUDA device launches the kernel
or raises.
"""

from __future__ import annotations

import math

import torch

from mcport_torch.ops.gbm import (_BM_CODE, _T_CODE, MAX_ASSETS, WIDE_CTAS, _check_args,
                                  check_card_assets, step_shocks, wide_scratch, wide_tile,
                                  t_scaled_chol)
from mcport_torch.ops.hedged import HedgeTensors, hedged_multi_dd, hedged_shares
from mcport_torch.ops.narrow import (LAYOUTS, NARROW_ASSETS, NARROW_SCRATCH_FLOATS, NarrowPlan,
                                     narrow_plan, r4)
from mcport_torch.ops.path_stats import log_paths_reference, path_stats_tolerance

__all__ = [
    "BF16_DD_ERR_BOUND",
    "BF16_DD_ERR_REBAL_COEF",
    "MAX_CANDIDATES",
    "SCORE_DTYPES",
    "multi_dd_from_log_paths",
    "multi_dd_reference",
    "rebalanced_dd",
    "gbm_multi_portfolio_dd",
    "multi_dd_tolerance",
    "hedged_price_bound",
    "multi_dd_shares",
    "gbm_narrow_plan",
]

# The bf16 screen's drawdown perturbation bounds, mcport's
# (pallas_multi_dd.py:42-43): they size the frontier's rescore margin
# (engine/drawdown_frontier.py), so the margin and the tested bounds agree.
BF16_DD_ERR_BOUND = 8e-3        # buy-and-hold |dd_p95| bound
BF16_DD_ERR_REBAL_COEF = 1.4e-2  # rebalanced widening: coef * sqrt(n_steps)

#: Candidates one kernel launch scores (its micro-tile layout; see the .cu).
MAX_CANDIDATES = 256
SCORE_DTYPES = {"float32": 0, "tensorfloat32": 1, "bfloat16": 2}
#: csrc/gbm_narrow.cu ``kSoloMaxCand`` by mode: the solo layout's widest W
#: (float32 tier only; the split layout past it)
_SOLO_MAX = {"buy-hold": 22, "rebalanced": 23, "hedged": 14}


def _recur_floats(a: int, w: int, own: bool, legs: int) -> int:
    """csrc/gbm_narrow.cu ``GbmRecurLayout(a, w, own ? kOwn : kReturns,
    legs).total``."""
    p = 16 * 16 + 16 + (r4(a * (1 + 4 * legs)) if legs else 0) + (w * 16 if own else 0)
    return p + (16 * 64 if legs else 0) + (3 * w * 64 if own else 0)


def gbm_narrow_plan(n_assets: int, n_cand: int, n_steps: int = 252, block_paths: int = 131_072,
                    n_blocks: int = 1, n_legs: int = 0,
                    scratch_floats: int = NARROW_SCRATCH_FLOATS, layout: str | None = None, *,
                    rebalance: bool = False, score_dtype: str = "float32") -> NarrowPlan:
    """The GBM candidate kernel's layout for ``n_cand`` candidates (W <=
    256) at ``n_assets <= 16`` (csrc/gbm_narrow.cu ``gbm_layout`` and the
    layouts' shared memory, the same arithmetic; hedged when ``n_legs`` > 0,
    else buy-and-hold or ``rebalance``): solo up to ``_SOLO_MAX`` candidates
    (22, 23 rebalanced, 14 hedged) in the float32 tier, split past them and
    in every other tier, as measured on an H100 (``tools/ab_narrow_kernels.py
    ... gbm``); or ``layout`` by name (``solo`` or ``split``). With no steps
    the plan is solo whatever the tier or name: nothing is scored. The split
    layout's scratch holds ``n_blocks x chunk x n_steps x n_assets``
    returns, no more than ``scratch_floats``."""
    if score_dtype not in SCORE_DTYPES:
        raise ValueError(f"score_dtype must be one of {sorted(SCORE_DTYPES)}, "
                         f"got {score_dtype!r}")
    mode = "hedged" if n_legs else "rebalanced" if rebalance else "buy-hold"
    f32, split = score_dtype == "float32", score_dtype == "tensorfloat32"
    if layout == "solo" and not f32 and n_steps:
        raise ValueError(f"the GBM candidate kernel's solo layout scores in the float32 "
                         f"tier only, not {score_dtype}")
    if n_steps == 0 and layout in (None, "split"):
        layout = "solo"
    return narrow_plan("the GBM candidate kernel", n_assets, n_cand, n_steps, block_paths,
                       n_blocks, n_legs, scratch_floats, _SOLO_MAX[mode] if f32 else 0,
                       MAX_CANDIDATES, _recur_floats, None, layout, split_tier=split)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest bfloat16 (ties to even), kept in float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _score(e: torch.Tensor, w: torch.Tensor, score_dtype: str) -> torch.Tensor:
    """``e @ w.T`` for ``e (..., A)`` and ``w (W, A)`` in the tier's numerics."""
    if score_dtype == "float32":
        return e @ w.T
    if score_dtype == "bfloat16":
        return _bf16(e) @ _bf16(w).T
    w1, e1 = _bf16(w), _bf16(e)
    w2, e2 = _bf16(w - w1), _bf16(e - e1)
    return (e1 @ w1.T + e2 @ w1.T) + e1 @ w2.T


def multi_dd_from_log_paths(paths: torch.Tensor, weights: torch.Tensor,
                            rebalance: bool = False,
                            score_dtype: str = "float32") -> tuple[torch.Tensor, torch.Tensor]:
    """(terminal returns, max drawdowns) of ``W`` candidates ``weights (W, A)``
    over ``(..., n, T, A)`` cumulative log paths → two ``(..., W, n)``
    tensors — the post-path half of mcport's ``_lax_multi_dd``, with the score
    tier's operand rounding. Buy-and-hold terminal returns are the float32
    score of the terminal state in every tier; with no steps every return is
    0 (``V_0 = 1``)."""
    if score_dtype not in SCORE_DTYPES:
        raise ValueError(f"score_dtype must be one of {sorted(SCORE_DTYPES)}, "
                         f"got {score_dtype!r}")
    w = weights.to(paths.dtype)
    if rebalance:
        x = torch.diff(paths, dim=-2, prepend=torch.zeros_like(paths[..., :1, :]))
        v = torch.cumprod(_score(torch.exp(x), w, score_dtype), dim=-2)
    else:
        v = _score(torch.exp(paths), w, score_dtype)
    v = torch.movedim(v, -1, -3)                               # (..., W, n, T)
    v = torch.cat([v.new_ones(v.shape[:-1] + (1,)), v], dim=-1)
    peak = torch.cummax(v, dim=-1).values
    dd = torch.amin(v / peak - 1.0, dim=-1)
    if rebalance or not paths.shape[-2]:
        term = v[..., -1] - 1.0
    else:
        term = torch.movedim(torch.exp(paths[..., -1, :]) @ w.T, -1, -2) - 1.0
    return term, dd


def rebalanced_dd(r: torch.Tensor, weights: torch.Tensor,
                  gross: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(terminal returns, max drawdowns), each ``(..., W, n)``, of ``W``
    candidates ``weights (W, A)`` compounding per-period rebalanced wealth
    ``V_t = V_{t-1} (1 + w·r_t)`` over per-step returns ``r (..., n, T, A)``,
    from ``V_0 = peak_0 = 1``, ``dd_0 = 0`` (mcport's ``_garch_dd_kernel`` and
    ``_bootstrap_dd_kernel`` after the path step). With ``gross``, ``r`` holds
    gross factors and ``V_t = V_{t-1} (w·r_t)`` (``_heston_dd_kernel``)."""
    w = weights.to(r.dtype)
    v = torch.ones(r.shape[:-2] + (w.shape[0],), dtype=r.dtype, device=r.device)
    peak = torch.ones_like(v)
    dd = torch.zeros_like(v)
    for t in range(r.shape[-2]):
        f = r[..., t, :] @ w.T
        v = v * (f if gross else 1.0 + f)
        peak = torch.maximum(peak, v)
        dd = torch.minimum(dd, v / peak - 1.0)
    return torch.movedim(v - 1.0, -1, -2), torch.movedim(dd, -1, -2)


def multi_dd_reference(
    seed: int,
    mean: torch.Tensor,
    chol: torch.Tensor,
    weights: torch.Tensor,
    n_paths: int,
    n_steps: int,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
    first_path: int = 0,
    rebalance: bool = False,
    score_dtype: str = "float32",
    bm: str = "poly",
    t_df: float | None = None,
    hedge: HedgeTensors | None = None,
    with_bound: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Plain torch form of the multi-dd kernel: ``(term, dd)``, each
    ``(n_blocks, W, n_paths)`` float32, for paths ``first_path ..`` of each
    block. ``chol`` is the kernel's factor (t scale folded in); ``hedge``
    selects the hedged mode (``rebalance`` is then not read), and
    ``with_bound`` adds the hedged kernel's bound per (candidate, path)
    (:func:`mcport_torch.ops.hedged.hedged_multi_dd`, with
    :func:`hedged_price_bound`). Runs on any device; the tests use it on the
    CPU and ``chip_smoke.py`` holds the kernel against it on the card."""
    _check_args(chol, n_paths, n_steps, n_blocks, bm, t_df)
    if hedge is not None:
        z = step_shocks(seed, chol.shape[0], n_paths, n_steps, first_block=first_block,
                        n_blocks=n_blocks, first_path=first_path, bm=bm, t_df=t_df,
                        device=chol.device)
        split = 2.0 * 2.0 ** -16 * math.sqrt(max(n_steps, 1))   # the split tier's rounding
        return hedged_multi_dd(
            mean + z @ chol.T, hedge, weights.to(torch.float32), score_dtype,
            hedged_price_bound(chol, mean, n_steps).to(chol.device) if with_bound else None,
            split if score_dtype == "tensorfloat32" else 0.0)
    paths = log_paths_reference(seed, mean, chol, n_paths, n_steps,
                                first_block=first_block, n_blocks=n_blocks,
                                first_path=first_path, bm=bm, t_df=t_df)
    return multi_dd_from_log_paths(paths, weights, rebalance, score_dtype)


def _launch(seed, mean, chol, weights, n_paths, n_steps, first_block, n_blocks,
            rebalance, score_dtype, bm, t_df, hedge, layout=None):
    """Launch the kernel for at most ``MAX_CANDIDATES``, hedged with
    ``hedge``; up to 16 assets in the layout of :func:`gbm_narrow_plan`, or
    in ``layout`` by name (``solo`` or ``split``)."""
    from mcport_torch._build import library

    dev = chol.device
    w_cnt, a = weights.shape
    term = torch.empty((n_blocks, w_cnt, n_paths), dtype=torch.float32, device=dev)
    dd = torch.empty((n_blocks, w_cnt, n_paths), dtype=torch.float32, device=dev)
    if n_paths == 0:
        return term, dd
    chol, mean, weights = chol.contiguous(), mean.contiguous(), weights.contiguous()
    df = 0.0 if t_df is None else float(t_df)
    neg2_over_df = 0.0 if t_df is None else -2.0 / float(t_df)
    mode = 2 if hedge is not None else int(rebalance)
    block = hedge.packed() if hedge is not None else None
    n_legs = hedge.n_legs if hedge is not None else 0
    args = (seed, first_block, n_blocks, n_paths, a, w_cnt, n_steps,
            _T_CODE if t_df is not None else _BM_CODE[bm], mode, SCORE_DTYPES[score_dtype],
            n_legs, df, neg2_over_df, chol.data_ptr(),
            mean.data_ptr(), weights.data_ptr(), block.data_ptr() if block is not None else None,
            term.data_ptr(), dd.data_ptr())
    plan = None
    if a <= NARROW_ASSETS:
        plan = gbm_narrow_plan(a, w_cnt, n_steps, n_paths, n_blocks, n_legs, layout=layout,
                               rebalance=rebalance, score_dtype=score_dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if a > MAX_ASSETS:   # csrc/wide.cuh's layout
            lib = library("multi_dd")
            tp = wide_tile(a)
            scratch = wide_scratch(a * WIDE_CTAS * tp, dev, "multi-dd")
            err = lib.mcport_multi_dd_wide(*args, scratch.data_ptr(), tp, WIDE_CTAS, stream)
        elif plan is not None:   # csrc/gbm_narrow.cu
            lib = library("gbm_narrow")
            scratch = (torch.empty(plan.scratch_floats, dtype=torch.float32, device=dev)
                       if plan.scratch_floats else None)
            err = lib.mcport_gbm_narrow_dd(
                *args, scratch.data_ptr() if scratch is not None else None,
                scratch.numel() if scratch is not None else 0, LAYOUTS[plan.layout], stream)
        else:   # 17-64 assets: csrc/multi_dd.cu's tile kernel
            lib = library("multi_dd")
            err = lib.mcport_multi_dd(*args, stream)
    if err:
        raise RuntimeError(f"multi-dd kernel launch failed: CUDA error {err} "
                           f"({lib.mcport_error_string(err).decode()})")
    gbm_multi_portfolio_dd.launches += 1
    gbm_multi_portfolio_dd.wide_launches += int(a > MAX_ASSETS)
    if hedge is not None:
        gbm_multi_portfolio_dd.hedged_launches += 1
    return term, dd


def gbm_multi_portfolio_dd(
    seed: int,
    mean_step: torch.Tensor,
    chol_step: torch.Tensor,
    weights: torch.Tensor,
    n_paths: int,
    n_steps: int,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
    rebalance: bool = False,
    score_dtype: str = "float32",
    t_df: float | None = None,
    bm: str = "poly",
    hedge: HedgeTensors | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(terminal returns, max drawdowns), each ``(n_blocks, W, n_paths)``
    float32, of ``W`` candidates ``weights (W, A)`` over the paths of blocks
    ``first_block + 1 .. first_block + n_blocks`` of a run seeded ``seed``
    (one block keyed by ``seed`` itself by default).

    ``chol_step`` is the model's factor (``t_df`` folds the unit-variance t
    scale into it). ``hedge`` (a :class:`mcport_torch.ops.hedged.HedgeTensors`
    on the same device) selects hedged per-step settlement, mcport's
    ``hedge_args``: the candidates compound ``V *= 1 + W·r_h`` (``rebalance``
    is not read). More than ``MAX_CANDIDATES`` candidates run as several
    launches over the same paths. Tensors on a CUDA device launch the kernel,
    each launch counted in ``gbm_multi_portfolio_dd.launches`` (a hedged one
    in ``.hedged_launches`` too); on the CPU the plain form runs. Any other
    device, or a problem the kernel does not take, raises.
    """
    chol = t_scaled_chol(chol_step.to(torch.float32), t_df)
    mean = mean_step.to(torch.float32)
    w = weights.to(torch.float32)
    _check_args(chol, n_paths, n_steps, n_blocks, bm, t_df)
    a = chol.shape[0]
    if mean.shape != (a,) or w.dim() != 2 or w.shape[1] != a or w.shape[0] < 1:
        raise ValueError(f"mean_step must have shape ({a},) and weights (W >= 1, {a}); "
                         f"got {tuple(mean.shape)} and {tuple(w.shape)}")
    if score_dtype not in SCORE_DTYPES:
        raise ValueError(f"score_dtype must be one of {sorted(SCORE_DTYPES)}, "
                         f"got {score_dtype!r}")
    if not chol.device == mean.device == w.device:
        raise ValueError("mean_step, chol_step and weights must be on one device")
    if hedge is not None:
        hedge.check(a, chol.device)
    if chol.device.type == "cpu":
        return multi_dd_reference(seed, mean, chol, w, n_paths, n_steps,
                                  first_block=first_block, n_blocks=n_blocks,
                                  rebalance=rebalance, score_dtype=score_dtype, bm=bm,
                                  t_df=t_df, hedge=hedge)
    if chol.device.type != "cuda":
        raise ValueError(f"no multi-dd kernel for device {chol.device}")
    check_card_assets(a, "multi-dd")
    parts = [_launch(seed, mean, chol, w[i:i + MAX_CANDIDATES], n_paths, n_steps,
                     first_block, n_blocks, rebalance, score_dtype, bm, t_df, hedge)
             for i in range(0, w.shape[0], MAX_CANDIDATES)]
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts], dim=1), torch.cat([p[1] for p in parts], dim=1))


gbm_multi_portfolio_dd.launches = 0
gbm_multi_portfolio_dd.wide_launches = 0   # the wide layout's share of ``launches`` (A > 64)
gbm_multi_portfolio_dd.hedged_launches = 0   # the hedged mode's share of ``launches``


def multi_dd_tolerance(chol: torch.Tensor, mean: torch.Tensor, n_steps: int,
                       rebalance: bool, score_dtype: str) -> float:
    """Relative bound on ``|kernel - plain form|`` of a candidate's value in
    the float32 and split tiers: :func:`path_stats_tolerance`'s, plus, in the
    split tier, twice ``2^-16`` per step (a low part rounded on either side of
    a tie), over ``sqrt(n)`` steps rebalanced. The terminal return then
    differs by at most ``rel · (1 + term)``, the drawdown by ``2 · rel``.

    The bfloat16 tier has no such bound: an exp one float32 ulp apart on the
    two sides may round to neighbouring bf16 values, 2^-7 apart. It is held
    instead by :func:`multi_dd_shares`'s aggregate test. On an H100 the
    largest differences used at most a fifth of these bounds (float32 and
    split tiers, both modes, 1-256 candidates, 7 and 252 steps, up to 131,072
    paths), and a wrong tier or mode exceeds them
    (``tests/test_torch_multi_dd.py``). The hedged mode's bound is per path
    (:func:`hedged_price_bound`)."""
    _, rel = path_stats_tolerance(chol, mean, n_steps)
    if score_dtype == "tensorfloat32":
        rel += 2.0 * 2.0 ** -16 * (math.sqrt(max(n_steps, 1)) if rebalance else 1.0)
    return rel


def hedged_price_bound(chol: torch.Tensor, mean: torch.Tensor, n_steps: int) -> torch.Tensor:
    """Per-asset bound ``(A,)`` on the relative difference of the hedged
    kernel's price ``P`` from its plain form's at any step: the log paths'
    bound (:func:`path_stats_tolerance`) plus two roundings per step (the exp
    and the price's product) over ``4 sqrt(n)`` steps. The hedged plain form
    turns it into a bound per (candidate, path)
    (:func:`mcport_torch.ops.hedged.hedged_multi_dd`)."""
    term, _ = path_stats_tolerance(chol, mean, n_steps)
    return term + 8.0 * 2.0 ** -24 * math.sqrt(max(n_steps, 1))


def multi_dd_shares(kernel, plain, plain_f32, chol: torch.Tensor, mean: torch.Tensor,
                    n_steps: int, rebalance: bool, score_dtype: str,
                    hedge: HedgeTensors | None = None) -> dict[str, float]:
    """The largest share of its bound that ``|kernel - plain|`` uses, per
    output ``{"term", "dd"}`` (``inf`` for a non-finite kernel value).

    float32 and tensorfloat32: elementwise, against
    :func:`multi_dd_tolerance`. bfloat16: in aggregate, ``mean |kernel -
    plain|`` over ``0.25 · mean |plain - plain_f32|`` (the tier's own
    rounding; a kernel that ignored the tier would use ~4x the bound), and the
    buy-and-hold terminal, float32 in every tier, elementwise. ``plain_f32``
    is the plain form in the float32 tier on the same paths (read only for
    bfloat16). ``hedge``: the hedged mode, by :func:`mcport_torch.ops.hedged
    .hedged_shares`, path by path against the bound that ``plain`` carries
    (:func:`multi_dd_reference` ``with_bound``)."""
    if hedge is not None:
        if len(plain) != 3:
            raise ValueError("a hedged comparison needs the plain form's bound (with_bound)")
        return hedged_shares(kernel, plain, plain_f32, score_dtype)
    out = {}
    rel = multi_dd_tolerance(chol, mean, n_steps, rebalance, score_dtype)
    for i, name in enumerate(("term", "dd")):
        k, p = kernel[i], plain[i]
        if not bool(torch.isfinite(k).all()):
            out[name] = math.inf
            continue
        if k.numel() == 0:
            out[name] = 0.0
            continue
        d = (k - p).abs()
        if score_dtype == "bfloat16" and not (name == "term" and not rebalance):
            spread = float((p - plain_f32[i]).abs().mean())
            out[name] = float(d.mean()) / max(0.25 * spread, 1e-30)
        else:
            tol = rel * (1.0 + p.abs()) if name == "term" else 2.0 * rel
            out[name] = float((d / tol).max())
    return out
