"""Path statistics of one portfolio: the CUDA path-stats kernel and its plain
torch form.

Port of ``gbm_path_stats`` (``mcport/ops/pallas_gbm.py``). The kernel
(``csrc/path_stats.cu``) replaces ``_path_stats_kernel``: per path it evolves
the log prices step by step (``logS += m + L z``), tracks the portfolio value
``V_t`` — buy-and-hold ``Σ w exp(logS)`` or rebalanced ``V_{t-1} · Σ w
exp(x)`` — with its running peak and maximum drawdown, from ``V_0 = peak_0 =
1`` and ``dd_0 = 0``. Its shocks are the terminal-noise kernel's, draw for
draw (``csrc/gbm_draws.cuh``), so its terminal log returns equal
``block_terminal_log_returns`` at the same seed up to rounding.

The plain form draws the same shocks (:func:`mcport_torch.ops.gbm.step_shocks`),
builds the log paths and reduces them with
:func:`mcport_torch.ops.multi_dd.multi_dd_from_log_paths` for one candidate,
the deterministic counterpart of mcport's ``_stats_from_log_paths``.

:func:`gbm_path_stats` dispatches on the device of its tensors: the CPU goes to
the plain form, a CUDA device launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from mcport_torch.ops.gbm import (
    MAX_ASSETS,
    WIDE_CTAS,
    wide_scratch,
    wide_tile,
    _BM_CODE,
    _T_CODE,
    _check_args,
    check_card_assets,
    kernel_tolerance,
    step_shocks,
    t_scaled_chol,
)

__all__ = [
    "log_paths_reference",
    "path_stats_reference",
    "gbm_path_stats",
    "path_stats_tolerance",
    "path_stats_shares",
]

_EPS = 2.0 ** -24    # float32 unit roundoff


def log_paths_reference(
    seed: int,
    mean: torch.Tensor,
    chol: torch.Tensor,
    n_paths: int,
    n_steps: int,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
    first_path: int = 0,
    bm: str = "poly",
    t_df: float | None = None,
) -> torch.Tensor:
    """Cumulative log paths ``(n_blocks, n_paths, n_steps, A)`` float32 on the
    kernels' counters: ``logS_t = Σ_{s<=t} (m + L z_s)``. ``chol`` is the
    factor the kernels receive (the t scale already folded in)."""
    z = step_shocks(seed, chol.shape[0], n_paths, n_steps, first_block=first_block,
                    n_blocks=n_blocks, first_path=first_path, bm=bm, t_df=t_df,
                    device=chol.device)
    return torch.cumsum(mean + z @ chol.T, dim=2)


def path_stats_reference(
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
    bm: str = "poly",
    t_df: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch form of the path-stats kernel: ``(terminal (n_blocks,
    n_paths, A), port (n_blocks, n_paths), dd (n_blocks, n_paths))`` float32
    for paths ``first_path ..`` of each block. ``chol`` is the kernel's
    factor. Runs on any device; the tests use it on the CPU and
    ``chip_smoke.py`` holds the kernel against it on the card."""
    from mcport_torch.ops.multi_dd import multi_dd_from_log_paths  # it imports this module

    _check_args(chol, n_paths, n_steps, n_blocks, bm, t_df)
    paths = log_paths_reference(seed, mean, chol, n_paths, n_steps,
                                first_block=first_block, n_blocks=n_blocks,
                                first_path=first_path, bm=bm, t_df=t_df)
    port, dd = multi_dd_from_log_paths(paths, weights[None], rebalance)
    term = paths[:, :, -1] if n_steps else paths.new_zeros(paths.shape[:2] + paths.shape[3:])
    return term, port[:, 0], dd[:, 0]


def _launch(seed, mean, chol, weights, n_paths, n_steps, first_block, n_blocks,
            rebalance, bm, t_df, terminal):
    from mcport_torch._build import library

    lib = library("path_stats")
    dev = chol.device
    a = chol.shape[0]
    term = (torch.empty((n_blocks, n_paths, a), dtype=torch.float32, device=dev)
            if terminal else None)
    port = torch.empty((n_blocks, n_paths), dtype=torch.float32, device=dev)
    dd = torch.empty((n_blocks, n_paths), dtype=torch.float32, device=dev)
    if n_paths == 0:
        return term, port, dd
    chol, mean, weights = chol.contiguous(), mean.contiguous(), weights.contiguous()
    df = 0.0 if t_df is None else float(t_df)
    neg2_over_df = 0.0 if t_df is None else -2.0 / float(t_df)
    tier = _T_CODE if t_df is not None else _BM_CODE[bm]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if a > MAX_ASSETS:   # csrc/wide.cuh: kernel #3's wide layout with one candidate
            tp = wide_tile(a)
            scratch = wide_scratch(a * WIDE_CTAS * tp, dev, "path-stats")
            err = lib.mcport_path_stats_wide(
                seed, first_block, n_blocks, n_paths, a, n_steps, tier, int(rebalance), df,
                neg2_over_df, chol.data_ptr(), mean.data_ptr(), weights.data_ptr(),
                None if term is None else term.data_ptr(), port.data_ptr(), dd.data_ptr(),
                scratch.data_ptr(), tp, WIDE_CTAS, stream)
        else:
            err = lib.mcport_path_stats(
                seed, first_block, n_blocks, n_paths, a, n_steps, tier, int(rebalance), df,
                neg2_over_df, chol.data_ptr(), mean.data_ptr(), weights.data_ptr(),
                None if term is None else term.data_ptr(), port.data_ptr(), dd.data_ptr(),
                stream)
    if err:
        raise RuntimeError(f"path-stats kernel launch failed: CUDA error {err} "
                           f"({lib.mcport_error_string(err).decode()})")
    gbm_path_stats.launches += 1
    gbm_path_stats.wide_launches += int(a > MAX_ASSETS)
    return term, port, dd


def gbm_path_stats(
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
    t_df: float | None = None,
    bm: str = "poly",
    terminal: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor]:
    """Path evolution with the portfolio's statistics for the blocks
    ``first_block + 1 .. first_block + n_blocks`` of a run seeded ``seed`` (one
    block keyed by ``seed`` itself by default) → ``(terminal log returns
    (n_blocks, n_paths, A) or None when not ``terminal``, port return
    (n_blocks, n_paths), max drawdown (n_blocks, n_paths))`` float32.

    ``chol_step`` is the model's factor: ``t_df`` draws unit-variance
    Student-t shocks, its ``1/sqrt(df/(df-2))`` scale folded into L. Tensors on
    a CUDA device launch the kernel (one launch for all blocks), counted in
    ``gbm_path_stats.launches``; on the CPU the plain form runs. Any other
    device, or a problem the kernel does not take, raises.
    """
    chol = t_scaled_chol(chol_step.to(torch.float32), t_df)
    mean = mean_step.to(torch.float32)
    w = weights.to(torch.float32)
    _check_args(chol, n_paths, n_steps, n_blocks, bm, t_df)
    a = chol.shape[0]
    if mean.shape != (a,) or w.shape != (a,):
        raise ValueError(f"mean_step and weights must have shape ({a},), got "
                         f"{tuple(mean.shape)} and {tuple(w.shape)}")
    if not chol.device == mean.device == w.device:
        raise ValueError("mean_step, chol_step and weights must be on one device")
    if chol.device.type == "cpu":
        term, port, dd = path_stats_reference(
            seed, mean, chol, w, n_paths, n_steps, first_block=first_block,
            n_blocks=n_blocks, rebalance=rebalance, bm=bm, t_df=t_df)
        return (term if terminal else None), port, dd
    if chol.device.type != "cuda":
        raise ValueError(f"no path-stats kernel for device {chol.device}")
    check_card_assets(a, "path-stats")
    return _launch(seed, mean, chol, w, n_paths, n_steps, first_block, n_blocks,
                   rebalance, bm, t_df, terminal)


gbm_path_stats.launches = 0
gbm_path_stats.wide_launches = 0   # the wide layout's share of ``launches`` (A > 64)


def path_stats_tolerance(chol: torch.Tensor, mean: torch.Tensor,
                         n_steps: int) -> tuple[torch.Tensor, float]:
    """Bounds on ``|kernel - plain form|`` of :func:`gbm_path_stats` for the
    kernel's factor ``chol`` → ``(terminal bound per asset (A,), relative
    bound on the portfolio value)``.

    Terminal: the terminal-noise kernel's bound on the shocks' sum
    (:func:`kernel_tolerance`) plus the rounding of a running float32 sum of
    ``n_steps`` increments, ``2 · 2^-24 · sqrt(n) · B`` with ``B = n|m| + 6
    sqrt(n) ||L_i||`` a bound on ``|logS|`` (the plain form sums in another
    order). Value: the largest terminal bound plus ``8 · 2^-24 · (A +
    sqrt(n))`` for the sum over assets and, rebalanced, the product over
    steps. The portfolio return then differs by at most ``rel · (1 + port)``
    and the drawdown, a ratio of two values, by ``2 · rel``. On an H100 the
    largest differences used at most a fifth of the terminal bound and a
    third of the value bounds (tiers, modes, 1-64 assets, 7 and 252 steps,
    up to 16.7M paths), and planted faults exceed them
    (``tests/test_torch_path_risk.py``).
    """
    chol = chol.to(torch.float32)
    n = max(n_steps, 1)
    b = n * mean.to(torch.float32).abs() + 6.0 * math.sqrt(n) * chol.norm(dim=1)
    term = kernel_tolerance(chol, n_steps) + 2.0 * _EPS * math.sqrt(n) * b
    rel = float(term.max()) + 8.0 * _EPS * (chol.shape[0] + math.sqrt(n))
    return term, rel


def path_stats_shares(kernel, plain, chol: torch.Tensor, mean: torch.Tensor,
                      n_steps: int) -> dict[str, float]:
    """The largest share of its bound (:func:`path_stats_tolerance`) that
    ``|kernel - plain|`` uses, per output: ``{"term", "port", "dd"}``; a
    terminal of None is skipped. Non-finite kernel values give ``inf``."""
    term_tol, rel = path_stats_tolerance(chol, mean, n_steps)
    term_tol = term_tol.to(plain[1].device)

    def share(k, p, tol):
        if not bool(torch.isfinite(k).all()):
            return math.inf
        return float(((k - p).abs() / tol).max()) if k.numel() else 0.0

    out = {"port": share(kernel[1], plain[1], rel * (1.0 + plain[1].abs())),
           "dd": share(kernel[2], plain[2], torch.full_like(plain[2], 2.0 * rel))}
    if kernel[0] is not None:
        out["term"] = share(kernel[0], plain[0], term_tol)
    return out
