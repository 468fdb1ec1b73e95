"""Common-jump Merton candidate paths: the CUDA jump kernel and its plain
torch form.

Port of ``pallas_merton_path_stats`` (``mcport/ops/pallas_jump.py``), both
modes. The kernel (``csrc/jump.cu``) replaces ``_jump_dd_kernel``:
per path and step it draws the GBM shocks ``z`` on kernel #3's counters, the
increment ``x = m + L z``, and a systemic jump clock — an event ``u < λ`` and
one common jump normal ``jn`` shared by every asset — that adds ``μJ + σJ·jn``
to every asset's increment on an event step; then ``W`` candidates compound
per-period rebalanced wealth ``V *= W·exp(x)`` (float32, mcport's
``score_dot``) with their running peak and maximum drawdown. Hedged
(``hedge``), every asset's price moves ``P *= exp(x)`` from its spot and the
candidates compound ``V *= 1 + W·r_h`` with the legs settled per step
(:mod:`mcport_torch.ops.hedged`).

The jump clock (``rng.STREAM_JUMP``): one Philox call ``(c, 0, path,
STREAM_JUMP)`` covers steps ``2c`` and ``2c + 1`` of one path — words 0 and
1 are their event uniforms, words 2 and 3 one poly Box-Muller pair, their
jump normals. mcport's kernel draws an 8-row grid per four steps (rows 0-3
the uniforms, 4-7 two Box-Muller pairs); this is that grid halved. The event
test compares float32 uniforms, exact on both sides, with ``float32(λ)``, so
the kernel and the plain form pick identical jump steps.

Up to 16 assets the kernel runs the layout :func:`merton_narrow_plan` gives
its candidate count (:mod:`mcport_torch.ops.narrow`): a thread per path
scoring its own few candidates, or for more the same recursion's returns
through a device scratch, scored by blocks of candidates; the layouts'
outputs are equal bit for bit.

The plain form adds the jump term to the increments that
:func:`mcport_torch.ops.path_stats.log_paths_reference` sums and scores them
with :func:`mcport_torch.ops.multi_dd.multi_dd_from_log_paths` (rebalanced):
at ``λ = 0`` it is kernel #3's rebalanced float32 plain form exactly, since it
adds ``0 · (μJ + σJ·jn)``. :func:`merton_multi_portfolio_dd` dispatches on the
device of its tensors: the CPU goes to the plain form, a CUDA device launches
the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from mcport_torch.ops.gbm import (BM_VARIANTS, MAX_ASSETS, WIDE_CTAS, _check_args, _uniform_calls,
                                  check_card_assets, step_shocks, wide_scratch, wide_tile)
from mcport_torch.ops.hedged import HedgeTensors, hedged_multi_dd, hedged_shares
from mcport_torch.ops.multi_dd import (MAX_CANDIDATES, hedged_price_bound, multi_dd_from_log_paths,
                                       multi_dd_tolerance)
from mcport_torch.ops.narrow import (LAYOUTS, NARROW_ASSETS, NARROW_SCRATCH_FLOATS, NarrowPlan,
                                     narrow_plan, r4)
from mcport_torch.rng import STREAM_JUMP

__all__ = [
    "jump_clock",
    "merton_increments",
    "merton_multi_dd_reference",
    "merton_multi_portfolio_dd",
    "merton_tolerance",
    "merton_price_bound",
    "merton_shares",
    "merton_narrow_plan",
]

#: csrc/jump.cu ``kSoloMaxCand``: the solo layout's widest W (the split layout past it)
_SOLO_MAX_CAND = 10


def _recur_floats(a: int, w: int, own: bool, legs: int) -> int:
    """csrc/jump.cu ``RecurLayout(a, w, own ? kOwn : kReturns, legs).total``."""
    h = 16 * 16 + 4 * 16
    p = h + (r4(a * (1 + 4 * legs)) if legs else 0) + (w * 16 if own else 0)
    return p + (16 * 64 if legs else 0) + (3 * w * 64 if own else 0)


def merton_narrow_plan(n_assets: int, n_cand: int, n_steps: int = 252,
                       block_paths: int = 131_072, n_blocks: int = 1, n_legs: int = 0,
                       scratch_floats: int = NARROW_SCRATCH_FLOATS,
                       layout: str | None = None) -> NarrowPlan:
    """The jump kernel's layout for ``n_cand`` candidates (W <= 256) at
    ``n_assets <= 16`` (csrc/jump.cu ``narrow_layout`` and its layouts'
    shared memory, the same arithmetic): solo up to 10 candidates, split past
    them (the faster two on an H100 at every W, measured by
    ``tools/ab_narrow_kernels.py``), or ``layout`` by name. The split
    layout's scratch holds ``n_blocks x chunk x n_steps x n_assets`` returns,
    no more than ``scratch_floats``."""
    return narrow_plan("the jump kernel", n_assets, n_cand, n_steps, block_paths, n_blocks,
                       n_legs, scratch_floats, _SOLO_MAX_CAND, MAX_CANDIDATES, _recur_floats,
                       None, layout)


def jump_clock(seed: int, jump_rate: float, n_paths: int, n_steps: int, *,
               first_block: int = -1, n_blocks: int = 1, first_path: int = 0,
               device: torch.device | str) -> tuple[torch.Tensor, torch.Tensor]:
    """``(event, jn)``, each ``(n_blocks, n_paths, n_steps)`` float32 on the
    kernel's counters: ``event`` is 1 where the step's uniform is below
    ``float32(jump_rate)``, else 0; ``jn`` the step's common jump normal."""
    dev = torch.device(device)
    call = _uniform_calls(seed, 1, n_paths, first_block, n_blocks, first_path, dev,
                          STREAM_JUMP)
    lam = torch.tensor(jump_rate, dtype=torch.float32, device=dev)
    events, normals = [], []
    for c in range(-(-n_steps // 2)):
        u = [x[..., 0] for x in call(c)]
        events += [(u[0] < lam).to(torch.float32), (u[1] < lam).to(torch.float32)]
        normals += BM_VARIANTS["poly"](u[2], u[3])
    if not events:
        empty = torch.zeros((n_blocks, n_paths, 0), dtype=torch.float32, device=dev)
        return empty, empty.clone()
    return (torch.stack(events[:n_steps], dim=-1), torch.stack(normals[:n_steps], dim=-1))


def merton_increments(seed: int, mean: torch.Tensor, chol: torch.Tensor, jump_rate: float,
                      jump_mean: torch.Tensor, jump_vol: torch.Tensor, n_paths: int,
                      n_steps: int, *, first_block: int = -1, n_blocks: int = 1,
                      first_path: int = 0) -> torch.Tensor:
    """Log increments ``x_t = m + L z_t + event_t (μJ + σJ jn_t)`` → ``(n_blocks,
    n_paths, n_steps, A)`` float32 on the kernel's counters."""
    z = step_shocks(seed, chol.shape[0], n_paths, n_steps, first_block=first_block,
                    n_blocks=n_blocks, first_path=first_path, device=chol.device)
    event, jn = jump_clock(seed, jump_rate, n_paths, n_steps, first_block=first_block,
                           n_blocks=n_blocks, first_path=first_path, device=chol.device)
    return (mean + z @ chol.T) + event[..., None] * (jump_mean + jump_vol * jn[..., None])


def _check(chol, mean, jump_mean, jump_vol, n_paths, n_steps, n_blocks, jump_rate) -> int:
    _check_args(chol, n_paths, n_steps, n_blocks, "poly", None)
    a = chol.shape[0]
    for name, x in (("mean_step", mean), ("jump_mean", jump_mean), ("jump_vol", jump_vol)):
        if x.dtype != torch.float32 or tuple(x.shape) != (a,) or x.device != chol.device:
            raise ValueError(f"{name} must be float32 ({a},) on {chol.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not math.isfinite(jump_rate) or jump_rate < 0.0:
        raise ValueError(f"jump_rate must be a finite rate >= 0, got {jump_rate}")
    return a


def merton_multi_dd_reference(
    seed: int,
    mean: torch.Tensor,
    chol: torch.Tensor,
    jump_rate: float,
    jump_mean: torch.Tensor,
    jump_vol: torch.Tensor,
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
    """Plain torch form of the jump kernel: ``(term, dd)``, each ``(n_blocks,
    W, n_paths)`` float32, for paths ``first_path ..`` of each block;
    ``hedge`` selects the hedged mode, and ``with_bound`` adds the hedged
    kernel's bound per (candidate, path) (:func:`mcport_torch.ops.hedged
    .hedged_multi_dd`, with :func:`merton_price_bound`).
    Runs on any device; the tests use it on the CPU and ``chip_smoke.py``
    holds the kernel against it on the card."""
    _check(chol, mean, jump_mean, jump_vol, n_paths, n_steps, n_blocks, jump_rate)
    x = merton_increments(seed, mean, chol, jump_rate, jump_mean, jump_vol, n_paths, n_steps,
                          first_block=first_block, n_blocks=n_blocks, first_path=first_path)
    if hedge is not None:
        price = merton_price_bound(chol, mean, jump_vol, n_steps) if with_bound else None
        return hedged_multi_dd(x, hedge, weights.to(torch.float32), price_bound=price)
    return multi_dd_from_log_paths(torch.cumsum(x, dim=2), weights, rebalance=True)


def _launch(seed, params, weights, a, n_paths, n_steps, first_block, n_blocks, jump_rate,
            hedge, layout=None):
    """Launch the jump kernel for at most ``MAX_CANDIDATES``, hedged with
    ``hedge``; up to 16 assets in the layout of :func:`merton_narrow_plan`,
    or in ``layout`` by name."""
    from mcport_torch._build import library

    lib = library("jump")
    dev = params.device
    w_cnt = weights.shape[0]
    term = torch.empty((n_blocks, w_cnt, n_paths), dtype=torch.float32, device=dev)
    dd = torch.empty((n_blocks, w_cnt, n_paths), dtype=torch.float32, device=dev)
    if n_paths == 0:
        return term, dd
    weights = weights.contiguous()
    n_legs = hedge.n_legs if hedge is not None else 0
    block = hedge.packed() if hedge is not None else None
    args = (seed, first_block, n_blocks, n_paths, a, w_cnt, n_steps, n_legs, jump_rate,
            params.data_ptr(), weights.data_ptr(), block.data_ptr() if block is not None else None,
            term.data_ptr(), dd.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if a > MAX_ASSETS:   # csrc/wide.cuh's layout
            tp = wide_tile(a)
            scratch = wide_scratch(a * WIDE_CTAS * tp, dev, "jump")
            err = lib.mcport_merton_multi_dd_wide(*args, scratch.data_ptr(), tp, WIDE_CTAS,
                                                  stream)
        else:
            scratch, code = None, -1
            if a <= NARROW_ASSETS:
                plan = merton_narrow_plan(a, w_cnt, n_steps, n_paths, n_blocks, n_legs,
                                          layout=layout)
                code = -1 if layout is None else LAYOUTS[plan.layout]
                if plan.scratch_floats:
                    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32, device=dev)
            err = lib.mcport_merton_multi_dd(
                *args, scratch.data_ptr() if scratch is not None else None,
                scratch.numel() if scratch is not None else 0, code, stream)
    if err:
        raise RuntimeError(f"jump kernel launch failed: CUDA error {err} "
                           f"({lib.mcport_error_string(err).decode()})")
    merton_multi_portfolio_dd.launches += 1
    merton_multi_portfolio_dd.wide_launches += int(a > MAX_ASSETS)
    if hedge is not None:
        merton_multi_portfolio_dd.hedged_launches += 1
    return term, dd


def merton_multi_portfolio_dd(
    seed: int,
    mean_step: torch.Tensor,
    chol_step: torch.Tensor,
    jump_rate: float,
    jump_mean: torch.Tensor,
    jump_vol: torch.Tensor,
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
    wealth over the common-jump Merton paths of blocks ``first_block + 1 ..
    first_block + n_blocks`` of a run seeded ``seed`` (one block keyed by
    ``seed`` itself by default) — mcport's ``pallas_merton_path_stats``;
    ``hedge`` (a :class:`mcport_torch.ops.hedged.HedgeTensors`) settles the
    option legs per step (mcport's ``hedge_args``).

    More than ``MAX_CANDIDATES`` candidates run as several launches over the
    same paths. Tensors on a CUDA device launch the kernel, each launch
    counted in ``merton_multi_portfolio_dd.launches`` (a hedged one in
    ``.hedged_launches`` too); on the CPU the plain form runs. Any other
    device, or a problem the kernel does not take, raises.
    """
    chol, mean = chol_step.to(torch.float32), mean_step.to(torch.float32)
    muj, sigj = jump_mean.to(torch.float32), jump_vol.to(torch.float32)
    jump_rate = float(jump_rate)
    a = _check(chol, mean, muj, sigj, n_paths, n_steps, n_blocks, jump_rate)
    w = weights.to(torch.float32)
    if w.dim() != 2 or w.shape[1] != a or w.shape[0] < 1 or w.device != chol.device:
        raise ValueError(f"weights must be (W >= 1, {a}) on {chol.device}, got "
                         f"{tuple(w.shape)} on {w.device}")
    if hedge is not None:
        hedge.check(a, chol.device)
    if chol.device.type == "cpu":
        return merton_multi_dd_reference(seed, mean, chol, jump_rate, muj, sigj, w, n_paths,
                                         n_steps, first_block=first_block, n_blocks=n_blocks,
                                         hedge=hedge)
    if chol.device.type != "cuda":
        raise ValueError(f"no jump kernel for device {chol.device}")
    check_card_assets(a, "jump")
    params = torch.cat([chol.reshape(-1), mean, muj, sigj]).contiguous()
    parts = [_launch(seed, params, w[i:i + MAX_CANDIDATES], a, n_paths, n_steps, first_block,
                     n_blocks, jump_rate, hedge)
             for i in range(0, w.shape[0], MAX_CANDIDATES)]
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts], dim=1), torch.cat([p[1] for p in parts], dim=1))


merton_multi_portfolio_dd.launches = 0
merton_multi_portfolio_dd.wide_launches = 0   # the wide layout's share of ``launches`` (A > 64)
merton_multi_portfolio_dd.hedged_launches = 0   # the hedged mode's share of ``launches``


def merton_tolerance(chol: torch.Tensor, mean: torch.Tensor, jump_vol: torch.Tensor,
                     n_steps: int) -> float:
    """Relative bound on ``|kernel - plain form|`` of a candidate's value:
    :func:`mcport_torch.ops.multi_dd.multi_dd_tolerance` of the rebalanced
    float32 tier (the diffusion is kernel #3's, step for step), plus the jump
    normals' share — 2e-6 per draw, as for the shocks, scaled by the largest
    ``σJ``, over ``4 sqrt(n)`` steps as a random walk with headroom. The
    events are identical on both sides, so no jump can be missed. The terminal
    return then differs by at most ``rel · (1 + term)``, the drawdown by ``2 ·
    rel``. The hedged mode's bound is per path (:func:`merton_price_bound`)."""
    rel = multi_dd_tolerance(chol, mean, n_steps, True, "float32")
    sig = float(jump_vol.abs().max()) if jump_vol.numel() else 0.0
    return rel + 4.0 * math.sqrt(max(n_steps, 1)) * 2e-6 * sig


def merton_price_bound(chol: torch.Tensor, mean: torch.Tensor, jump_vol: torch.Tensor,
                       n_steps: int) -> torch.Tensor:
    """Per-asset bound ``(A,)`` on the relative difference of the hedged
    jump kernel's price from its plain form's at any step: kernel #3's
    (:func:`mcport_torch.ops.multi_dd.hedged_price_bound`) plus the jump
    normals' share as in :func:`merton_tolerance`, per asset's ``σJ``."""
    walk = 4.0 * math.sqrt(max(n_steps, 1)) * 2e-6 * jump_vol.to(torch.float32).abs()
    return hedged_price_bound(chol, mean, n_steps) + walk.to(chol.device)


def merton_shares(kernel, plain, chol: torch.Tensor, mean: torch.Tensor,
                  jump_vol: torch.Tensor, n_steps: int,
                  hedge: HedgeTensors | None = None) -> dict[str, float]:
    """The largest share of its bound (:func:`merton_tolerance`) that
    ``|kernel - plain|`` uses, per output ``{"term", "dd"}`` (``inf`` for a
    non-finite kernel value). Hedged (``hedge``): path by path against the
    bound that ``plain`` carries (:func:`merton_multi_dd_reference`
    ``with_bound``), by :func:`mcport_torch.ops.hedged.hedged_shares`."""
    if hedge is not None:
        if len(plain) != 3:
            raise ValueError("a hedged comparison needs the plain form's bound (with_bound)")
        return hedged_shares(kernel, plain, None)
    rel = merton_tolerance(chol, mean, jump_vol, n_steps)
    out = {}
    for i, name in enumerate(("term", "dd")):
        k, p = kernel[i], plain[i]
        if not bool(torch.isfinite(k).all()):
            out[name] = math.inf
        elif k.numel() == 0:
            out[name] = 0.0
        else:
            tol = rel * (1.0 + p.abs()) if name == "term" else 2.0 * rel
            out[name] = float(((k - p).abs() / tol).max())
    return out
