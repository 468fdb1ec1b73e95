"""Stationary block-bootstrap paths: the CUDA bootstrap kernels and their
plain torch forms.

Port of ``mcport/ops/pallas_bootstrap.py``, both modes. Two kernels
(``csrc/bootstrap.cu``) replace ``_bootstrap_kernel`` and
``_bootstrap_dd_kernel``. Each path resamples rows of a ``(T, A)`` history of
per-period simple returns (Politis-Romano, circular): from a uniform start
row, every step either restarts at a uniform row (probability ``p_restart``)
or advances to the next row, wrapping at ``T``; then

- :func:`bootstrap_terminal` compounds every asset, ``gross *= 1 + row`` → the
  terminal simple returns ``gross - 1``;
- :func:`bootstrap_multi_portfolio_dd` compounds ``W`` candidates' per-period
  rebalanced wealth ``V *= 1 + w·row`` with the running peak and maximum
  drawdown; hedged (``hedge``), the prices ``P *= 1 + row`` from the spots
  settle every option leg each step and ``V *= 1 + w·r_h``, the prices and
  settled returns the plain form's bit for bit.

The uniforms come from Philox on ``STREAM_BOOT``, key the block seed, counter
``(call, 0, path, STREAM_BOOT)``: call 0 word 0 gives the start row, call
``1 + s // 2`` gives step ``s`` its (restart, jump) pair, words (0, 1) for an
even step and (2, 3) for an odd one. With ``m = bits >> 9`` (23 bits) the
restart test is ``m · 2^-23 < p_restart`` in float32 and the jump row is ``⌊m ·
T / 2^23⌋`` in integers, both exact on either side. So the kernels and the
plain forms select identical rows, and the terminal kernel equals its plain
form bit for bit (``gross *= 1 + row`` has no contraction). TPU workarounds
are not ported: the one-hot matmul gather and its 3-way bf16 split; the
history sits in the kernels' shared memory, or past a block's shared memory
in device memory behind the read-only cache, and selection is a load.

Up to 16 assets the candidate kernel runs the layout
:func:`bootstrap_narrow_plan` gives its candidate count
(:mod:`mcport_torch.ops.narrow`): a thread per path walking its rows and
scoring its own few candidates, or for more the same walk's rows through a
device scratch, scored by blocks of candidates; each layout's block holds the
history where its own shared memory has room for it. The layouts' outputs
are equal bit for bit.

Each wrapper dispatches on the device of its tensors: the CPU goes to the
plain form, a CUDA device launches the kernel or raises. Past 64 assets the
kernels run the layout of ``csrc/wide.cuh`` (the history in device memory).
"""

from __future__ import annotations

import math

import torch

from mcport_torch.ops.gbm import (MAX_ASSETS, WIDE_CTAS, block_seeds, check_card_assets,
                                  wide_scratch, wide_tile)
from mcport_torch.ops.hedged import HedgeTensors, hedged_multi_dd, hedged_shares
from mcport_torch.ops.multi_dd import MAX_CANDIDATES, rebalanced_dd
from mcport_torch.ops.narrow import (LAYOUTS, NARROW_ASSETS, NARROW_SCRATCH_FLOATS, NarrowPlan,
                                     narrow_plan, r4)
from mcport_torch.rng import STREAM_BOOT, philox4x32

__all__ = [
    "SHARED_BYTES",
    "history_in_shared",
    "bootstrap_indices",
    "bootstrap_terminal_reference",
    "bootstrap_terminal",
    "bootstrap_multi_dd_reference",
    "bootstrap_multi_portfolio_dd",
    "bootstrap_price_bound",
    "bootstrap_shares",
    "bootstrap_narrow_plan",
    "bootstrap_layout_holds_history",
]

#: Shared memory one block of the kernels may hold: the H100's 227 KB per block.
SHARED_BYTES = 232_448
_EPS = 2.0 ** -24    # float32 unit roundoff
_TILE_P = 16         # paths per block of the candidate kernel
#: csrc/bootstrap.cu ``kBootThreads``: paths (and threads) per block of the walk
_BOOT_THREADS = 128
#: csrc/bootstrap.cu ``kSoloMaxCand`` and ``kSoloMaxHedged``: the solo layout's
#: widest W, unhedged and hedged (the split layout past it)
_SOLO_MAX_CAND, _SOLO_MAX_HEDGED = 22, 14


def _recur_floats(a: int, w: int, own: bool, legs: int, hist: int = 0) -> int:
    """csrc/bootstrap.cu ``RecurLayout(T, a, w, own ? kOwn : kReturns, legs,
    shared).total``, ``hist`` the history's ``T·A`` floats when shared."""
    h = r4(hist) + (r4(a * (1 + 4 * legs)) if legs else 0) + (w * 16 if own else 0)
    return h + (16 * _BOOT_THREADS if legs else 0) + (3 * w * _BOOT_THREADS if own else 0)


def _dd_floats(a: int, w: int, hist: int = 0) -> int:
    """csrc/bootstrap.cu ``DdLayout(T, a, round4(w), shared).total``, the
    block of ``bootstrap_dd_kernel`` (17-64 assets; the hedge is read from
    device memory)."""
    return r4(hist) + a * r4(w) + a * _TILE_P + 2 * _TILE_P


def bootstrap_layout_holds_history(layout: str | None, n_assets: int, n_cand: int,
                                   t_len: int, n_legs: int = 0) -> bool:
    """Whether ``layout``'s block (its first launch's: the walk of ``solo``
    and ``split``; None: ``bootstrap_dd_kernel`` of 17-64 assets) keeps the
    ``(t_len, n_assets)`` history in shared memory: where its own bytes and
    the history's fit a block's ``SHARED_BYTES``. Else the history stays in
    device memory and each step's row is read through the read-only cache."""
    a, w, hist = int(n_assets), int(n_cand), int(t_len) * int(n_assets)
    if layout is None:
        return history_in_shared(4 * _dd_floats(a, w, hist))
    return history_in_shared(4 * _recur_floats(a, w, layout == "solo", n_legs, hist))


def bootstrap_narrow_plan(n_assets: int, n_cand: int, t_len: int = 365, n_steps: int = 252,
                          block_paths: int = 131_072, n_blocks: int = 1, n_legs: int = 0,
                          scratch_floats: int = NARROW_SCRATCH_FLOATS,
                          layout: str | None = None) -> NarrowPlan:
    """The bootstrap candidate kernel's layout for ``n_cand`` candidates (W <=
    256) at ``n_assets <= 16`` over a ``t_len``-row history (csrc/bootstrap.cu
    ``narrow_layout`` and its layouts' shared memory, the same arithmetic):
    solo up to 22 candidates (14 hedged), split past them (on an H100 split
    is faster than solo from 24 candidates, 15 hedged, and than the 17-64-
    asset kernel's layout at every W; measured by
    ``tools/ab_narrow_kernels.py``), or ``layout`` by name; blocks of 128
    paths for the walk. Each layout's shared memory holds the
    history where it fits (:func:`bootstrap_layout_holds_history`). The
    split layout's scratch holds ``n_blocks x chunk x n_steps x n_assets``
    rows, no more than ``scratch_floats``."""
    hist = int(t_len) * int(n_assets)

    def recur(a, w, own, legs):
        base = _recur_floats(a, w, own, legs)
        with_hist = _recur_floats(a, w, own, legs, hist)
        return with_hist if history_in_shared(4 * with_hist) else base

    solo_max = _SOLO_MAX_HEDGED if n_legs else _SOLO_MAX_CAND
    return narrow_plan("the bootstrap candidate kernel", n_assets, n_cand, n_steps, block_paths,
                       n_blocks, n_legs, scratch_floats, solo_max, MAX_CANDIDATES, recur,
                       None, layout, solo_threads=_BOOT_THREADS)


def _check(hist: torch.Tensor, n_paths: int, n_steps: int, n_blocks: int) -> tuple[int, int]:
    if hist.dtype != torch.float32 or hist.dim() != 2 or hist.shape[0] < 1:
        raise ValueError(f"the history must be a (T >= 1, A) float32 matrix, got "
                         f"{tuple(hist.shape)} {hist.dtype}")
    t_len, a = hist.shape
    if a < 1:
        raise ValueError("the history must cover at least one asset")
    if not 0 <= n_paths < 2**31 or n_steps < 0 or not 1 <= n_blocks <= 65_535:
        raise ValueError(f"bad grid: n_paths={n_paths}, n_steps={n_steps}, "
                         f"n_blocks={n_blocks}")
    return t_len, a


def history_in_shared(nbytes: int) -> bool:
    """Whether a kernel keeps the history in shared memory: when its whole
    block layout, ``nbytes``, fits a block's ``SHARED_BYTES``. A longer history
    stays in device memory and each step's row is read from there through the
    read-only cache (``__ldg``); the rows selected, and so the results, are the
    same either way."""
    return nbytes <= SHARED_BYTES


def bootstrap_indices(
    seed: int,
    t_len: int,
    n_paths: int,
    n_steps: int,
    p_restart: float,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
    first_path: int = 0,
    device: torch.device | str,
) -> torch.Tensor:
    """The history row of every step on the kernels' counters → ``(n_blocks,
    n_paths, n_steps)`` int64, for paths ``first_path ..`` of each block."""
    dev = torch.device(device)
    keys = torch.tensor(block_seeds(seed, first_block, n_blocks), dtype=torch.int64,
                        device=dev).view(-1, 1)
    path = torch.arange(first_path, first_path + n_paths, dtype=torch.int64,
                        device=dev).view(1, -1)
    p32 = torch.tensor(p_restart, dtype=torch.float32, device=dev)

    def call(c: int):
        words = philox4x32((c, 0, path, STREAM_BOOT), (keys, 0))
        return [w.expand(n_blocks, n_paths) >> 9 for w in words]   # 23-bit integers

    def jump(m):
        return (m * t_len) >> 23

    idx = jump(call(0)[0])
    out = []
    for s in range(n_steps):
        if s % 2 == 0:
            m = call(1 + s // 2)
        m_restart, m_jump = m[2 * (s % 2)], m[2 * (s % 2) + 1]
        nxt = idx + 1
        nxt = torch.where(nxt == t_len, 0, nxt)
        restart = m_restart.to(torch.float32) * 2.0 ** -23 < p32
        idx = torch.where(restart, jump(m_jump), nxt)
        out.append(idx)
    if not out:
        return torch.zeros((n_blocks, n_paths, 0), dtype=torch.int64, device=dev)
    return torch.stack(out, dim=-1)


def bootstrap_terminal_reference(
    seed: int,
    hist: torch.Tensor,
    n_paths: int,
    n_steps: int,
    p_restart: float = 0.2,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
    first_path: int = 0,
) -> torch.Tensor:
    """Plain torch form of the bootstrap terminal kernel: terminal simple
    returns ``(n_blocks, n_paths, A)`` float32 for paths ``first_path ..`` of
    each block. Runs on any device; the tests use it on the CPU and
    ``chip_smoke.py`` holds the kernel against it, bit for bit, on the card."""
    t_len, a = _check(hist, n_paths, n_steps, n_blocks)
    idx = bootstrap_indices(seed, t_len, n_paths, n_steps, p_restart,
                            first_block=first_block, n_blocks=n_blocks,
                            first_path=first_path, device=hist.device)
    gross = torch.ones((n_blocks, n_paths, a), dtype=torch.float32, device=hist.device)
    for t in range(n_steps):
        gross = gross * (1.0 + hist[idx[..., t]])
    return gross - 1.0


def _launch_terminal(seed, hist, n_paths, n_steps, p_restart, first_block, n_blocks):
    from mcport_torch._build import library

    t_len, a = hist.shape
    in_shared = history_in_shared(4 * t_len * a)
    lib = library("bootstrap")
    out = torch.empty((n_blocks, n_paths, a), dtype=torch.float32, device=hist.device)
    if n_paths == 0:
        return out
    hist = hist.contiguous()
    with torch.cuda.device(hist.device):
        stream = torch.cuda.current_stream(hist.device).cuda_stream
        if a > MAX_ASSETS:   # csrc/wide.cuh's layout: the grosses; the history in device memory
            tp = wide_tile(a, 0)
            scratch = wide_scratch(a * WIDE_CTAS * tp, hist.device, "bootstrap")
            err = lib.mcport_bootstrap_wide(
                seed, first_block, n_blocks, n_paths, t_len, a, 0, n_steps, 0,
                float(p_restart), hist.data_ptr(), None, None, out.data_ptr(), None,
                scratch.data_ptr(), tp, WIDE_CTAS, stream)
        else:
            err = lib.mcport_bootstrap_terminal(
                seed, first_block, n_blocks, n_paths, t_len, a, n_steps, float(p_restart),
                int(in_shared), hist.data_ptr(), out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"bootstrap terminal kernel launch failed: CUDA error {err} "
                           f"({lib.mcport_error_string(err).decode()})")
    bootstrap_terminal.launches += 1
    bootstrap_terminal.wide_launches += int(a > MAX_ASSETS)
    return out


def bootstrap_terminal(
    seed: int,
    hist: torch.Tensor,
    n_paths: int,
    n_steps: int,
    p_restart: float = 0.2,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
) -> torch.Tensor:
    """Terminal simple returns ``(n_blocks, n_paths, A)`` float32 of
    stationary-bootstrap paths over the history ``hist (T, A)`` for the blocks
    ``first_block + 1 .. first_block + n_blocks`` of a run seeded ``seed`` (one
    block keyed by ``seed`` itself by default) — mcport's
    ``pallas_bootstrap_terminal_returns``; expected block length
    ``1 / p_restart``.

    A history on a CUDA device launches the kernel, counted in
    ``bootstrap_terminal.launches``; on the CPU the plain form runs. Any other
    device, or a problem the kernel does not take, raises. A history past a
    block's shared memory is read from device memory (:func:`history_in_shared`).
    """
    _check(hist, n_paths, n_steps, n_blocks)
    if hist.device.type == "cpu":
        return bootstrap_terminal_reference(seed, hist, n_paths, n_steps, p_restart,
                                            first_block=first_block, n_blocks=n_blocks)
    if hist.device.type != "cuda":
        raise ValueError(f"no bootstrap kernel for device {hist.device}")
    check_card_assets(hist.shape[1], "bootstrap")
    return _launch_terminal(seed, hist, n_paths, n_steps, p_restart, first_block, n_blocks)


bootstrap_terminal.launches = 0
bootstrap_terminal.wide_launches = 0   # the wide layout's share of ``launches`` (A > 64)


def bootstrap_multi_dd_reference(
    seed: int,
    hist: torch.Tensor,
    weights: torch.Tensor,
    n_paths: int,
    n_steps: int,
    p_restart: float = 0.2,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
    first_path: int = 0,
    hedge: HedgeTensors | None = None,
    with_bound: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Plain torch form of the bootstrap candidate kernel: ``(term, dd)``,
    each ``(n_blocks, W, n_paths)`` float32, for paths ``first_path ..`` of
    each block. ``hedge``: the hedged mode, mcport's ``_bootstrap_dd_kernel``
    hedged branch — ``P_0 = s0``, ``P_t = P_{t-1} · (1 + row_t)`` on the
    selected rows, every leg settled against the move
    (:func:`mcport_torch.ops.hedged.hedged_multi_dd`); with ``with_bound`` a
    third output bounds each (candidate, path)'s distance from the kernel
    (:func:`bootstrap_price_bound`: the prices are the kernel's, bit for
    bit)."""
    t_len, _ = _check(hist, n_paths, n_steps, n_blocks)
    idx = bootstrap_indices(seed, t_len, n_paths, n_steps, p_restart,
                            first_block=first_block, n_blocks=n_blocks,
                            first_path=first_path, device=hist.device)
    if hedge is None:
        return rebalanced_dd(hist[idx], weights)
    return hedged_multi_dd(1.0 + hist[idx], hedge, weights.to(torch.float32),
                           price_bound=(bootstrap_price_bound(hist.shape[1], hist.device)
                                        if with_bound else None), gross=True)


def bootstrap_price_bound(n_assets: int, device) -> torch.Tensor:
    """Per-asset bound ``(A,)`` on the relative difference of the hedged
    bootstrap kernel's price ``P`` from its plain form's at any step: zero.
    Both sides select the same rows (integer selection on the same Philox
    words) and compute ``P · (1 + row)``, one add and one multiply, each
    rounded once, with nothing to contract: the prices, and so the settled
    returns (``csrc/hedged.cuh`` rounds as the plain form does), are equal
    bit for bit. Only the score's sum over assets differs in order, which the
    hedged bound's rounding term covers (:func:`mcport_torch.ops.hedged
    .hedged_multi_dd`)."""
    return torch.zeros(n_assets, dtype=torch.float32, device=device)


def _launch_dd(seed, hist, weights, n_paths, n_steps, p_restart, first_block, n_blocks,
               hedge=None, layout=None):
    """Launch kernel #7 for at most ``MAX_CANDIDATES``, hedged with ``hedge``;
    up to 16 assets in the layout of :func:`bootstrap_narrow_plan`, or in
    ``layout`` by name."""
    from mcport_torch._build import library

    t_len, a = hist.shape
    w_cnt = weights.shape[0]
    n_legs = hedge.n_legs if hedge is not None else 0
    plan = None
    if a <= NARROW_ASSETS:
        plan = bootstrap_narrow_plan(a, w_cnt, t_len, n_steps, n_paths, n_blocks, n_legs,
                                     layout=layout)
    in_shared = bootstrap_layout_holds_history(plan.layout if plan else None, a, w_cnt,
                                               t_len, n_legs)
    lib = library("bootstrap")
    term = torch.empty((n_blocks, w_cnt, n_paths), dtype=torch.float32, device=hist.device)
    dd = torch.empty((n_blocks, w_cnt, n_paths), dtype=torch.float32, device=hist.device)
    if n_paths == 0:
        return term, dd
    hist, weights = hist.contiguous(), weights.contiguous()
    block = hedge.packed() if hedge is not None else None
    hp = block.data_ptr() if block is not None else None
    with torch.cuda.device(hist.device):
        stream = torch.cuda.current_stream(hist.device).cuda_stream
        if a > MAX_ASSETS:   # csrc/wide.cuh's layout: hedged, the prices
            tp = wide_tile(a, 0)
            scratch = wide_scratch((a if hedge is not None else 0) * WIDE_CTAS * tp,
                                   hist.device, "bootstrap")
            err = lib.mcport_bootstrap_wide(
                seed, first_block, n_blocks, n_paths, t_len, a, w_cnt, n_steps, n_legs,
                float(p_restart), hist.data_ptr(), weights.data_ptr(), hp, term.data_ptr(),
                dd.data_ptr(), scratch.data_ptr(), tp, WIDE_CTAS, stream)
        else:
            scratch = None
            if plan is not None and plan.scratch_floats:
                scratch = torch.empty(plan.scratch_floats, dtype=torch.float32,
                                      device=hist.device)
            err = lib.mcport_bootstrap_multi_dd(
                seed, first_block, n_blocks, n_paths, t_len, a, w_cnt, n_steps, n_legs,
                float(p_restart), int(in_shared), hist.data_ptr(), weights.data_ptr(), hp,
                term.data_ptr(), dd.data_ptr(),
                scratch.data_ptr() if scratch is not None else None,
                scratch.numel() if scratch is not None else 0,
                -1 if layout is None else LAYOUTS[plan.layout], stream)
    if err:
        raise RuntimeError(f"bootstrap candidate kernel launch failed: CUDA error {err} "
                           f"({lib.mcport_error_string(err).decode()})")
    bootstrap_multi_portfolio_dd.launches += 1
    bootstrap_multi_portfolio_dd.wide_launches += int(a > MAX_ASSETS)
    if hedge is not None:
        bootstrap_multi_portfolio_dd.hedged_launches += 1
    return term, dd


def bootstrap_multi_portfolio_dd(
    seed: int,
    hist: torch.Tensor,
    weights: torch.Tensor,
    n_paths: int,
    n_steps: int,
    p_restart: float = 0.2,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
    hedge: HedgeTensors | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(terminal returns, max drawdowns), each ``(n_blocks, W, n_paths)``
    float32, of ``W`` candidates ``weights (W, A)`` compounding rebalanced
    wealth over the bootstrap paths of blocks ``first_block + 1 ..
    first_block + n_blocks`` — mcport's ``pallas_bootstrap_path_stats``.

    ``hedge`` (a :class:`mcport_torch.ops.hedged.HedgeTensors` on the same
    device) selects hedged per-step settlement, mcport's ``hedge_args``: the
    prices move ``P *= 1 + row`` from the spots, every leg settles each step,
    and the candidates compound ``V *= 1 + W·r_h``. More than
    ``MAX_CANDIDATES`` candidates run as several launches over the same paths.
    Tensors on a CUDA device launch the kernel, each launch counted in
    ``bootstrap_multi_portfolio_dd.launches`` (a hedged one in
    ``.hedged_launches`` too); on the CPU the plain form runs. Any other
    device, or a problem the kernel does not take, raises.
    """
    _, a = _check(hist, n_paths, n_steps, n_blocks)
    w = weights.to(torch.float32)
    if w.dim() != 2 or w.shape[1] != a or w.shape[0] < 1 or w.device != hist.device:
        raise ValueError(f"weights must be (W >= 1, {a}) on {hist.device}, got "
                         f"{tuple(w.shape)} on {w.device}")
    if hedge is not None:
        hedge.check(a, hist.device)
    if hist.device.type == "cpu":
        return bootstrap_multi_dd_reference(seed, hist, w, n_paths, n_steps, p_restart,
                                            first_block=first_block, n_blocks=n_blocks,
                                            hedge=hedge)[:2]
    if hist.device.type != "cuda":
        raise ValueError(f"no bootstrap kernel for device {hist.device}")
    check_card_assets(a, "bootstrap")
    parts = [_launch_dd(seed, hist, w[i:i + MAX_CANDIDATES], n_paths, n_steps, p_restart,
                        first_block, n_blocks, hedge)
             for i in range(0, w.shape[0], MAX_CANDIDATES)]
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts], dim=1), torch.cat([p[1] for p in parts], dim=1))


bootstrap_multi_portfolio_dd.launches = 0
bootstrap_multi_portfolio_dd.wide_launches = 0   # the wide layout's share of ``launches`` (A > 64)
bootstrap_multi_portfolio_dd.hedged_launches = 0   # the hedged mode's share of ``launches``


def bootstrap_shares(kernel, plain, hist: torch.Tensor, weights: torch.Tensor,
                     n_steps: int, hedge: HedgeTensors | None = None) -> dict[str, float]:
    """The largest share of its bound that ``|kernel - plain|`` of the
    candidate kernel uses, per output ``{"term", "dd"}`` (``inf`` for a
    non-finite kernel value).

    Both sides select the same rows; they differ only in the order of the
    score's float32 sum over assets, at most ``A · 2^-24 · h`` per step with
    ``h`` the largest ``Σ_a |w_a| |row_a|``, and the roundings of ``1 + f``
    and the product (two of 2^-24). Over ``n`` steps these add up like a
    random walk; with a factor 4 of headroom ``rel = 4 sqrt(n) 2^-24 (2 + A
    h)`` bounds the value relatively, ``|Δterm| <= rel (1 + |term|)`` and
    ``|Δdd| <= 2 rel``. Hedged (``hedge``): path by path against the bound
    that ``plain`` carries (:func:`bootstrap_multi_dd_reference`
    ``with_bound``), by :func:`mcport_torch.ops.hedged.hedged_shares`."""
    if hedge is not None:
        if len(plain) != 3:
            raise ValueError("a hedged comparison needs the plain form's bound (with_bound)")
        return hedged_shares(kernel, plain, None)
    a = hist.shape[1]
    h = float((weights.abs().sum(dim=1).max() * hist.abs().max()).cpu())
    rel = 4.0 * math.sqrt(max(n_steps, 1)) * _EPS * (2.0 + a * h)
    out = {}
    for i, name in enumerate(("term", "dd")):
        k, p = kernel[i], plain[i]
        if not bool(torch.isfinite(k).all()):
            out[name] = math.inf
            continue
        tol = rel * (1.0 + p.abs()) if name == "term" else torch.full_like(p, 2.0 * rel)
        out[name] = float(((k - p).abs() / tol).max()) if k.numel() else 0.0
    return out
