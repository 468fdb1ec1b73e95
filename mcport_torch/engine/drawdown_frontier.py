"""Drawdown-constrained frontier search over simulated GBM, CCC-GARCH,
DCC-GARCH, common-jump Merton, Heston and stationary-bootstrap paths.

Port of ``drawdown_frontier_search`` and ``family_drawdown_frontier_search``
(``mcport/engine/drawdown_frontier.py``): among Dirichlet(1) candidate
portfolios, the one with the highest mean simulated terminal return whose
``(1 - alpha)``-quantile of the maximum drawdown stays above ``-dd_budget``.

Candidates are scored chunk by chunk, ``w_block`` at a time, by the multi-dd
kernel (:func:`mcport_torch.ops.multi_dd.gbm_multi_portfolio_dd`), or for the
families by their candidate kernels
(:func:`mcport_torch.ops.garch.garch_multi_portfolio_dd`,
:func:`mcport_torch.ops.dcc.dcc_multi_portfolio_dd`,
:func:`mcport_torch.ops.jump.merton_multi_portfolio_dd`,
:func:`mcport_torch.ops.heston.heston_multi_portfolio_dd`,
:func:`mcport_torch.ops.bootstrap.bootstrap_multi_portfolio_dd`; rebalanced
wealth, float32, no screening tier), over ONE shared path set (every chunk regenerates the same paths from the same key, so
comparisons between chunks are exact). Each chunk is reduced on the device to
``(ret, dd_p95)`` before the next runs: the full ``(N, P)`` score matrix —
4,096 x 131,072 x 2 floats is 4.3 GB — is never held.

``score_dtype="bfloat16"`` screens with the bf16 score tier and rescores, at
float32 over the same paths, every candidate the screen could have misjudged
(within mcport's pinned perturbation margin of the budget) until the winner
itself is exact. ``"auto"`` is float32: mcport picks the screen on a TPU,
where bf16 products are cheaper, but the port's kernel scores every tier on
FP32 FMAs, so on an H100 the screen plus rescore is slower than float32 with
the same optimum (``PERF.md``).

Differences from mcport: ``seed`` (an int) replaces the JAX key — it seeds a
CPU generator that draws the path key and the seed of the weights' device
generator; ``w_block`` defaults to the kernel's 256 candidates per launch
(mcport: 128, its VMEM tile); "auto" never screens and there is no
``auto_bf16_min_work``; on the CPU the plain form honours the score tiers
(mcport's lax path ignores them).

``hedge`` (a :class:`mcport_torch.options.hedged.HedgeSpec`) scores every
candidate on hedged per-step settlement against the prices from the spots —
always the settled recursion ``V *= 1 + w·r_h`` (mcport: buy-and-hold of an
intrinsic-settled position is not defined mid-path) — for GBM and every
family of the family search.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from mcport_torch.device import resolve_device
from mcport_torch.models.gbm import GBMParams
from mcport_torch.ops.bootstrap import bootstrap_multi_portfolio_dd
from mcport_torch.ops.dcc import dcc_multi_portfolio_dd
from mcport_torch.ops.dirichlet import sample_weights
from mcport_torch.ops.hedged import HedgeTensors
from mcport_torch.ops.garch import garch_multi_portfolio_dd
from mcport_torch.ops.heston import heston_multi_portfolio_dd
from mcport_torch.ops.jump import merton_multi_portfolio_dd
from mcport_torch.ops.multi_dd import (
    BF16_DD_ERR_BOUND,
    BF16_DD_ERR_REBAL_COEF,
    MAX_CANDIDATES,
    gbm_multi_portfolio_dd,
    multi_dd_from_log_paths,
)

__all__ = ["DrawdownFrontierResult", "drawdown_frontier_search",
           "family_drawdown_frontier_search", "multi_dd_from_log_paths",
           "frontier_seeds"]


@dataclass(frozen=True)
class DrawdownFrontierResult:
    weights: np.ndarray     # (N, A)
    valid: np.ndarray       # (N,)
    ret: np.ndarray         # (N,) mean simulated terminal return
    dd_p95: np.ndarray      # (N,) (1 - alpha)-quantile of the max drawdown
    feasible: np.ndarray    # (N,) valid & dd_p95 >= -dd_budget
    opt_idx: int            # argmax ret among feasible; -1 if none
    dd_budget: float

    @property
    def opt_weights(self) -> np.ndarray | None:
        return None if self.opt_idx < 0 else self.weights[self.opt_idx]


def frontier_seeds(seed: int) -> tuple[int, int]:
    """(path key, weight-generator seed) of a search seeded ``seed``: two
    draws of a CPU generator, so the weights' torch generator and the
    kernels' Philox key never share a key."""
    g = torch.Generator().manual_seed(seed)
    path_seed = int(torch.randint(0, 1 << 30, (), generator=g))
    weight_seed = int(torch.randint(0, 1 << 62, (), generator=g))
    return path_seed, weight_seed


def _result(w: torch.Tensor, valid: np.ndarray, ret: np.ndarray, dd_p95: np.ndarray,
            budget: float) -> DrawdownFrontierResult:
    """The search's result: feasible candidates and the best of them."""
    feasible = valid & (dd_p95 >= -budget)
    opt_idx = int(np.argmax(np.where(feasible, ret, -np.inf))) if feasible.any() else -1
    return DrawdownFrontierResult(weights=w.cpu().numpy(), valid=valid, ret=ret,
                                  dd_p95=dd_p95, feasible=feasible, opt_idx=opt_idx,
                                  dd_budget=budget)


def _tail_stats(term: torch.Tensor, dd: torch.Tensor, k_tail: int):
    """(mean terminal return, k-th smallest drawdown) per candidate row. A NaN
    drawdown (hedged wealth that overflowed) ranks as the worst, as in
    mcport's ``top_k(-dd)``: ``kthvalue`` alone would rank it the best."""
    dd = torch.nan_to_num(dd, nan=-math.inf)
    return term.mean(dim=-1), torch.kthvalue(dd, k_tail, dim=-1).values


def drawdown_frontier_search(
    seed: int,
    params: GBMParams,
    dd_budget: float = 0.30,
    n_candidates: int = 4_096,
    n_paths: int = 8_192,
    n_steps: int = 252,
    alpha: float = 0.95,
    min_weights=None,
    max_weights=None,
    w_block: int = MAX_CANDIDATES,
    score_dtype: str = "auto",
    rescore_top: int = 32,
    rebalance: bool = False,
    hedge=None,
    t_df: float | None = None,
    bm: str = "poly",
    *,
    device: str | torch.device = "cuda",
) -> DrawdownFrontierResult:
    """Max mean simulated return s.t. the ``(1 - alpha)``-quantile of the
    max drawdown is ``>= -dd_budget``, over ``n_candidates`` Dirichlet(1)
    portfolios (within ``min_weights``/``max_weights``) and one set of
    ``n_paths`` paths of ``n_steps`` steps, on ``device``.

    ``score_dtype``: "float32", "tensorfloat32" (mcport's bf16 split),
    "bfloat16" (screen plus exact rescore of up to ``rescore_top`` leaders per
    round until the winner is exact) or "auto" (float32). ``rebalance`` scores
    per-step-rebalanced candidates; ``hedge`` (a HedgeSpec) hedged per-step
    settlement against the prices from ``params.s0`` (the bf16 screen's margin
    then widens as rebalanced); ``t_df`` Student-t shocks; ``bm`` the normal
    tier of both screen and rescore.
    """
    dev = resolve_device(device)
    a = params.n_assets
    min_w = np.zeros(a) if min_weights is None else np.asarray(min_weights, np.float64)
    max_w = np.ones(a) if max_weights is None else np.asarray(max_weights, np.float64)
    if score_dtype == "auto":
        score_dtype = "float32"
    block = min(w_block, n_candidates)
    if not 1 <= block <= MAX_CANDIDATES:
        raise ValueError(f"w_block must be in 1..{MAX_CANDIDATES}, got {w_block}")

    path_seed, weight_seed = frontier_seeds(seed)
    gen = torch.Generator(device=dev).manual_seed(weight_seed)
    w, valid = sample_weights(gen, n_candidates, min_w, max_w)
    mean = torch.as_tensor(params.mean_step).to(dev, torch.float32)
    chol = torch.as_tensor(params.chol_step).to(dev, torch.float32)
    legs = None if hedge is None else HedgeTensors.from_spec(
        hedge, torch.as_tensor(params.s0).cpu().numpy(), dev)
    k_tail = max(1, math.ceil((1.0 - alpha) * n_paths))

    def score(w_blk: torch.Tensor, tier: str):
        term, dd = gbm_multi_portfolio_dd(path_seed, mean, chol, w_blk, n_paths, n_steps,
                                          rebalance=rebalance, score_dtype=tier,
                                          t_df=t_df, bm=bm, hedge=legs)
        return _tail_stats(term[0], dd[0], k_tail)

    chunks = [score(w[i:i + block], score_dtype) for i in range(0, n_candidates, block)]
    ret = torch.cat([c[0] for c in chunks]).cpu().numpy()
    dd_p95 = torch.cat([c[1] for c in chunks]).cpu().numpy()
    valid_np = valid.cpu().numpy()
    budget = abs(dd_budget)

    if score_dtype == "bfloat16" and rescore_top > 0:
        # exact pass over every candidate the screen could have misjudged:
        # within `margin` of the budget (mcport's pinned bf16 perturbation
        # bound, widened as sqrt(T) when rebalancing compounds it). The
        # feasible set lies inside this pool, so rescoring batches until the
        # winner itself is exact keeps the optimum exact. Hedged scoring
        # compounds per step like rebalancing: the same widening.
        margin = BF16_DD_ERR_BOUND + (
            BF16_DD_ERR_REBAL_COEF * math.sqrt(n_steps)
            if rebalance or hedge is not None else 0.0)
        pool = np.nonzero(valid_np & (dd_p95 >= -(budget + margin)))[0]
        rescored: set[int] = set()
        while pool.size:
            feas = valid_np & (dd_p95 >= -budget)
            if not feas.any():
                break
            winner = int(np.argmax(np.where(feas, ret, -np.inf)))
            if winner in rescored:
                # near-tie contenders: two launches' mean reductions can
                # disagree by ~1 ulp; rescore any feasible candidate within
                # that band of the exact winner so the argmax compares exact
                # values
                tie = 4e-7 * max(1.0, abs(float(ret[winner])))
                ties = [i for i in np.nonzero(feas)[0]
                        if i not in rescored and ret[i] >= ret[winner] - tie]
                if not ties:
                    break
                batch = np.asarray(ties[:max(rescore_top, 1)])
            else:
                fresh = [i for i in pool[np.argsort(-ret[pool])]
                         if i != winner and i not in rescored]
                batch = np.asarray([winner] + fresh[:rescore_top - 1])
            r_x, d_x = score(w[torch.as_tensor(batch, device=dev)], "float32")
            ret[batch], dd_p95[batch] = r_x.cpu().numpy(), d_x.cpu().numpy()
            rescored.update(int(i) for i in batch)

    return _result(w, valid_np, ret, dd_p95, budget)


def family_drawdown_frontier_search(
    seed: int,
    model: str,
    model_params,
    dd_budget: float = 0.30,
    n_candidates: int = 4_096,
    n_paths: int = 8_192,
    n_steps: int = 252,
    alpha: float = 0.95,
    min_weights=None,
    max_weights=None,
    w_block: int = MAX_CANDIDATES,
    p_restart: float = 0.2,
    hedge=None,
    s0=None,
    *,
    device: str | torch.device = "cuda",
) -> DrawdownFrontierResult:
    """The drawdown-constrained frontier under a non-GBM path family, on
    ``device``: "garch" (``model_params`` a
    :class:`mcport_torch.models.garch_mc.CCCGarchParams`), "dcc" (a
    :class:`mcport_torch.models.dcc.DCCGarchParams`), "jump" (a
    :class:`mcport_torch.models.jump.MertonParams`), "heston" (a
    :class:`mcport_torch.models.heston.HestonParams`) or "bootstrap"
    (``model_params`` the (T, A) history of simple returns, ``p_restart`` its
    restart probability). Candidates compound per-period rebalanced wealth,
    scored in float32 in chunks of at most ``MAX_CANDIDATES`` over one shared
    path stream. ``hedge`` (a HedgeSpec) with the spots ``s0``: hedged
    per-step settlement, every family (a NaN drawdown of overflowed wealth
    ranks as the worst)."""
    if model not in ("garch", "dcc", "jump", "heston", "bootstrap"):
        raise ValueError(f"model must be 'garch', 'dcc', 'jump', 'heston' or 'bootstrap', "
                         f"got {model!r}")
    if hedge is not None and s0 is None:
        raise ValueError("hedged family frontier requires s0 (asset prices)")
    dev = resolve_device(device)
    block = min(w_block, n_candidates)
    if not 1 <= block <= MAX_CANDIDATES:
        raise ValueError(f"w_block must be in 1..{MAX_CANDIDATES}, got {w_block}")
    legs = None if hedge is None else HedgeTensors.from_spec(
        hedge, np.asarray(torch.as_tensor(s0).cpu(), np.float64), dev)
    if model == "garch":
        g = model_params.tensors(dev)
        a = model_params.n_assets

        def score(w_blk):
            return garch_multi_portfolio_dd(path_seed, g, w_blk, n_paths, n_steps, hedge=legs)
    elif model == "dcc":
        dt = model_params.tensors(dev)
        a = model_params.n_assets

        def score(w_blk):
            return dcc_multi_portfolio_dd(path_seed, dt, w_blk, n_paths, n_steps, hedge=legs)
    elif model == "jump":
        d, a = model_params.diffusion, model_params.n_assets
        mean, chol, muj, sigj = (torch.as_tensor(x).to(dev, torch.float32) for x in (
            d.mean_step, d.chol_step, model_params.jump_mean, model_params.jump_vol))

        def score(w_blk):
            return merton_multi_portfolio_dd(path_seed, mean, chol, model_params.jump_rate,
                                             muj, sigj, w_blk, n_paths, n_steps, hedge=legs)
    elif model == "heston":
        h = model_params.tensors(dev)
        a = model_params.n_assets

        def score(w_blk):
            return heston_multi_portfolio_dd(path_seed, h, w_blk, n_paths, n_steps,
                                             hedge=legs)
    else:
        hist = torch.as_tensor(np.asarray(model_params, np.float32), device=dev)
        a = hist.shape[1]

        def score(w_blk):
            return bootstrap_multi_portfolio_dd(path_seed, hist, w_blk, n_paths, n_steps,
                                                p_restart, hedge=legs)
    min_w = np.zeros(a) if min_weights is None else np.asarray(min_weights, np.float64)
    max_w = np.ones(a) if max_weights is None else np.asarray(max_weights, np.float64)

    path_seed, weight_seed = frontier_seeds(seed)
    gen = torch.Generator(device=dev).manual_seed(weight_seed)
    w, valid = sample_weights(gen, n_candidates, min_w, max_w)
    k_tail = max(1, math.ceil((1.0 - alpha) * n_paths))
    chunks = []
    for i in range(0, n_candidates, block):
        term, dd = score(w[i:i + block])
        chunks.append(_tail_stats(term[0], dd[0], k_tail))
    ret = torch.cat([c[0] for c in chunks]).cpu().numpy()
    dd_p95 = torch.cat([c[1] for c in chunks]).cpu().numpy()
    valid_np = valid.cpu().numpy()
    budget = abs(dd_budget)
    return _result(w, valid_np, ret, dd_p95, budget)
