#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card

The quickest proof that the port (``mcport_torch``) builds and runs on the
GPU. It imports neither jax, pandas nor mcport. Phases, each printed as it
ends:

0. the card: ``nvidia-smi`` name and power limit, torch's device name;
1. the kernel build from ``mcport_torch/csrc`` (nvcc, sm_90a, one process per
   source, all at once), timed, with ptxas's registers and stack frames;
2. the terminal-noise kernel (#1) against its plain torch form on identical
   Philox counters: tiers poly / poly_fast / t(5.5), A in {1, 15, 64}, 252
   and 7 steps, a ragged 65,537-path count over two blocks, antithetic on and
   off; single draws (L = [[1]], 1 and 2 steps) of both normal tiers; and
   every launch the main path of phase 4 makes. Bound per element and asset:
   ``mcport_torch.ops.gbm.kernel_tolerance``;
3. the law on the card at 1,048,576 paths x 252 steps x 15 assets: terminal
   means within 5 standard errors of n*m, covariance within 2% of n*LL', and
   the t tier's fat tails at 4 steps;
4. the gbm-risk main path, ``mcport_torch.api.gbm_risk``, on the bench's
   synthetic 15-asset universe at GBMConfig defaults (131,072 x 252) and at
   BASELINE config-4 scale (16,777,216 x 252, 1,048,576-path blocks): first
   call and three warm walls, kernel #1 launched once per dispatch group,
   split + resume bit-identical, the card agreeing with the CPU run, and
   VaR/CVaR/moments agreeing with exact Gaussian sampling;
5. kernel #1 and its plain form timed with CUDA events at 1,048,576 x 252 x
   15, and its other two tiers;
6. the path-stats kernel (#2) against its plain form — tiers, buy-and-hold and
   rebalanced, A in {1, 15, 64}, 252 and 7 steps, a ragged 16,385-path count
   over two blocks, and every launch of phase 7 over a head slice
   of each block's paths (bound: ``ops.path_stats.path_stats_tolerance``); #2's terminal against #1's at the
   same seed; the multi-dd kernel (#3) against its plain form — the three
   score tiers, both modes, W in {1, 13, 256}, A = 15, 252 steps, the draw
   tiers at W = 13, and one 256-candidate chunk of phase 7's frontier over
   its 131,072 paths (bound: ``ops.multi_dd.multi_dd_shares``); #3 with one
   candidate bit-identical to #2; #3 up to 16 assets in every layout of
   ``ops.multi_dd.gbm_narrow_plan`` (W = 1, each side of every switch of
   each mode and 256; buy-and-hold, rebalanced and hedged with two legs of
   every type; the three score tiers; 1,029 x 2 paths x 52 steps), the
   layout W picks within the plain form's bound and every layout by name
   (solo, split) bit for bit with it;
7. the path tier's main path: ``run_path_risk`` at both sizes, buy-and-hold
   and rebalanced, normal and t(5.5) shocks (first call and two warm walls),
   ``run_resumable_path_risk`` split + resume bit-identical, ``path_tail_risk``
   for gbm and student_t on a synthetic price history, and
   ``drawdown_frontier_search`` at the bench's size (4,096 candidates x
   131,072 paths x 252 steps) in the float32 tier, in "auto" (float32 on a
   card) and as the bf16 screen plus float32 rescore, whose optima must be
   equivalent (bench.py's rule); counts reset before and read after,
   both kernels launched; the buy-and-hold VaR against gbm-risk's on the same
   shocks, drawdown quantiles and the frontier's optimum against the plain
   forms on the same paths;
8. kernels #2 and #3 timed with CUDA events beside their plain forms (and #3's
   score product alone as one torch.matmul per step; #3's plain form in the
   float32 tier), #3 at one candidate (131,072 x 252, plain and hedged), and
   each kernel's least time: its bytes over the memory rate or its
   instructions over the card's issue rate — for #1 its hot loop's SASS
   (``cuobjdump -sass``), for #2 and #3 the work the function needs (kernel
   #1's draw plus the steps' correlate, exp, scoring and drawdown), beside
   #2's own loop and, once, #3's former SASS-counted yardstick.
9. the family kernels against their plain forms: the GARCH terminal kernel
   (#4; A in {1, 15, 16}, normal and t(5.5), 252 and 7 steps) and candidate
   kernel (#5; W in {1, 13, 256}, 7 steps) within ``ops.garch.garch_shares``; the
   bootstrap terminal kernel (#6; A in {1, 15, 64}, p_restart 0.2, 0 and 1)
   bit for bit; the candidate kernel (#7, 7 steps) within ``ops.bootstrap
   .bootstrap_shares`` and, with one-hot candidates, bit for bit against its
   plain form and #6 (the selection); and every launch of phase 10 over a
   head slice of each block's paths;
10. the family tier's main paths at the bench's GARCH parameters and a
   365 x 15 history: ``garch_risk`` (normal, t(5.5)) and ``bootstrap_risk``
   at 1,048,576 x 252, ``run_garch_path_risk`` and ``run_bootstrap_path_risk``
   at both sizes with split + resume, ``path_tail_risk`` for both families and
   ``bootstrap_tail_risk``,
   both family frontiers at 4,096 x 131,072 x 252, and the CLI's
   ``garch-risk``, ``bootstrap-risk``, ``path-risk --models
   garch,bootstrap`` and ``dd-frontier --model garch|bootstrap`` on the
   weekly fixtures; counts reset before and read after, each kernel launched
   as often as these calls need; then the GARCH terminal law, the iid
   bootstrap's mean, the card against the CPU, the drawdown quantiles and
   both frontiers' optima against the plain forms;
11. kernels #4-#7 timed with CUDA events beside their plain forms and one
   PyTorch call (``index_select`` for #6's rows, ``torch.matmul`` for the
   score of #5 and #7), and each one's least time from the work its function
   needs;
12. the Merton and Heston kernels against their plain forms: the Merton
   candidate kernel (#8; A in {1, 15, 64}, rates 0.02 and 0.3, W = 1, 256
   and each side of every layout switch of ``ops.jump.merton_narrow_plan``:
   10 and 11) within ``ops.jump.merton_shares``, its jumped paths the plain
   form's with unmissable jumps, and at rate 0 kernel #3's rebalanced output
   bit for bit; the Heston terminal (#9; A in {1, 15, 16}) and candidate
   (#10; W = 1, 12, 13, 128, 129, 256, the switches of
   ``ops.heston.heston_narrow_plan``) kernels within
   ``ops.heston.heston_shares`` at the bench's vol of vol and a
   Feller-violating one (0.05), and at the case whose cuBLAS score order
   left the former Heston bound (2,053 x 2 paths, W = 12, xi 0.05, 252
   steps; its share of the bound printed); both candidate kernels hedged at
   those W (A = 15 and 16, two legs per asset of every type, 52 steps) path
   by path within the price bounds; the GARCH (#5) and bootstrap (#7)
   candidate kernels at W = 1, each side of every layout switch of
   ``ops.garch.garch_narrow_plan`` and ``ops.bootstrap.bootstrap_narrow_plan``
   and 256 (A = 15 and 16, 52 steps), unhedged within ``garch_shares`` and
   ``bootstrap_shares`` and hedged (two legs of every type) path by path,
   the bootstrap over the bench's history (shared memory) and an 8,192-row
   one (device memory); and every launch of phase 13 over a head slice of
   each block's paths;
13. the Merton and Heston main paths at bench.py's parameters: ``merton_risk``
   and ``heston_terminal_returns`` at 1,048,576 x 252, ``run_merton_path_risk``
   and ``run_heston_path_risk`` at both sizes with split + resume,
   ``path_tail_risk`` for both (the 15-asset Heston QMLE's host seconds
   printed), both frontiers at 4,096 x 131,072 x 252, and the CLI's
   ``jump-risk``, ``path-risk --models jump,heston`` and ``dd-frontier
   --model jump|heston`` on the weekly fixtures; counts reset before and read
   after, each kernel launched as often as these calls need; then both
   terminal laws, the card against the CPU, the drawdown quantiles and both
   frontiers' optima against the plain forms;
14. kernels #8-#10 timed with CUDA events beside their plain forms and, for
   #8 and #10, the score product as one ``torch.matmul`` per step; kernel
   #4's t(5.5) tier alone; #5, #7, #8 and #10 at W = 1 (131,072 x 252, the
   layout each plan routes it to); and each new kernel's least time from the
   work its function needs.
15. the DCC-GARCH kernels against their plain forms within
   ``ops.dcc.dcc_shares``: the terminal kernel (replacing #11 and #12; A in
   {1, 2, 15, 16}, 52 and 7 steps, a ragged path count over two blocks) and
   the candidate kernel (replacing #13 and #14; W in {1, 13, 256}) at
   bench.py's DCC parameters, with q0 off S (a non-unit diagonal and a large
   common e0) and frozen (a = 0, b = 1); the zero-vol closed form; a = b = 0
   against kernel #4 on the same seed; and every launch of phase 16 over a
   head slice of each block's paths;
16. the DCC main paths at bench.py's DCC parameters: ``dcc_risk`` at
   1,048,576 x 52, ``run_dcc_path_risk`` at both sizes with split + resume,
   ``path_tail_risk`` (the estimation's host seconds printed), the DCC
   frontier at 4,096 x 131,072 x 252, and the CLI's ``garch-risk
   --correlation dcc``, ``path-risk --models dcc``, ``dd-frontier --model
   dcc`` and ``compare-models`` on the weekly fixtures; counts reset before
   and read after, each kernel launched as often as these calls need; then
   the terminal law ((1 + mu)^n - 1 exactly), the card against the CPU, the
   drawdown quantiles and the frontier's optimum against the plain forms;
17. both DCC kernels timed with CUDA events beside their plain forms at
   1,048,576 x 52 x 15 and 256 x 131,072 x 52, with ``torch.linalg.cholesky``
   of the (1,048,576, 15, 15) batch x 52 and the score product as one
   ``torch.matmul`` per step x 52 as yardsticks, and their least times from
   the work their functions need.
18. the repairs: the GARCH, Heston and DCC kernels' wide variants at A in
   {17, 33, 64} against their plain forms (Heston's path state bit for bit,
   at the bench's vol of vol and a Feller-violating one), the bootstrap
   kernels on an 8,192 x 15 history past shared memory (bit for bit, and the
   one-hot selection), ``path_tail_risk`` for garch, heston and dcc and
   ``compare_tail_risk`` on a 17-asset universe on the card (counts reset
   before and read after);
19. the hedged modes of kernels #3 and #8 against their plain forms (1-3 legs
   of every type, the score tiers and t(5.5), W in {1, 13, 256}, rates 0.02
   and 0.3), an identity hedge against the rebalanced mode, #8 at rate 0
   against #3 bit for bit, and every hedged launch of phase 20 over a head
   slice of each block's paths (bounds: ``ops.multi_dd
   .multi_dd_shares`` and ``ops.jump.merton_shares`` with the hedge);
20. the hedged main paths with a married put on asset 0 and a collar on
   asset 1: ``gbm_risk`` at both cells, path risk for gbm, student_t and jump
   at both cells with split + resume, ``path_tail_risk`` for the three, the
   hedged GBM and jump frontiers at 4,096 x 131,072 x 252,
   ``hedged_tail_risk`` for all seven families at 1,048,576 x 252 (DCC at
   52), and the CLI's ``hedged-risk``, ``gbm-risk --hedge``, ``path-risk
   --hedge`` and ``dd-frontier --hedge`` on the weekly fixtures; counts reset
   before and read after; then the hedged drawdown quantiles and the hedged
   frontier's optimum against the plain form;
21. the hedged modes timed at 256 x 131,072 x 252 beside their plain forms and
   the score product as one ``torch.matmul`` per step, each wide variant at
   A = 64 (DCC's beside ``torch.linalg.cholesky`` of a (paths, 64, 64) batch
   once per step and the score product), and the bootstrap kernels on the
   long history; the hedged modes' least times from the work their
   functions need.
22. widths past 64 (``csrc/wide.cuh``): every kernel at A = 65 and 200 (DCC
   65 and 256, where Q leaves shared memory) on the bench universe
   widened, against its plain form with today's bounds (the bootstrap's
   selection bit for bit, #3 at one candidate equal to #2, #8 at rate 0
   equal to #3); the hedged #3, #5, #7, #8, #10 and #13 at A = 65; and the
   main paths at 65 assets (``path_tail_risk`` for all seven families,
   ``compare_tail_risk``, ``gbm_risk``, a GBM frontier) with every wrapper's
   wide count reset before and read after, then hedged Heston and hedged
   DCC path risk and frontiers at 65 assets with the hedged counts reset
   before and read after, each launch against the plain form over a head
   slice;
23. the hedged modes of #5, #7, #10 and #13 against their plain forms path
   by path (``ops.garch.garch_shares``, ``ops.bootstrap.bootstrap_shares``,
   ``ops.heston.heston_shares`` and ``ops.dcc.dcc_shares`` with the hedge;
   DCC's bound ``dcc_price_bound`` from each path's own volatility and
   condition): 1-3 legs of every type, W in {1, 13, 256}, the bootstrap on
   shared-memory and 8,192-row histories, one-hot bootstrap candidates bit
   for bit, an identity hedge against the unhedged mode (Heston's also at a
   Feller-violating vol of vol), hedged #10 on the bench hedge at A = 15,
   17, 64, 65 and 200 and 16, 52 and 252 steps, hedged #13 at A = 15, 16,
   17, 64, 65 and 256 and 16 and 52 steps (252 up to 16 assets) and at W =
   5 and 257, deep puts that overflow #13's wealth, and every hedged launch
   of phase 24 over a head slice of each block's paths;
24. the hedged GARCH, Heston, bootstrap and DCC main paths with the bench
   hedge: path risk at both cells with split + resume, ``path_tail_risk``
   for the four, the four hedged frontiers at 4,096 x 131,072 x 252 and at
   52 steps with budgets that bind (optima against the plain forms), and
   the CLI's ``path-risk --hedge`` and ``dd-frontier --hedge`` for the four
   on the weekly fixtures; counts reset before and read after;
25. the hedged #5, #7 and #10 timed at 256 x 131,072 x 252 and #13 at 256 x
   131,072 x 52 beside their unhedged modes, plain forms and the score
   product as one ``torch.matmul`` per step; each kernel's wide layout at A
   = 200 (DCC 256, beside ``torch.linalg.cholesky`` of a (paths, 256, 256)
   batch once per step and the score product) beside its plain form,
   hedged #10's (A = 200) and #13's (A = 256) beside their unhedged modes;
   every new entry's least time from the work its function needs.

It prints a JSON line with each kernel's launches, error, times and bound,
then, as the last line, ``{"ok": true, "device": {...}}`` — only when every
phase passed. Any failure raises and exits non-zero without that line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

N_ASSETS, N_STEPS = 15, 252
LAW_PATHS = 1 << 20
TIERS = (("poly", None), ("poly_fast", None), ("t", 5.5))
DISPATCH = 16                       # the engines' DISPATCH_BLOCKS


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def bench_universe(a: int = N_ASSETS):
    """The synthetic universe of bench.py: 0.0004 variance, 0.5 correlation."""
    rng = np.random.default_rng(0)
    corr = 0.5 * np.eye(a) + 0.5
    chol = np.linalg.cholesky(0.0004 * corr).astype(np.float32)
    mean = rng.normal(1e-3, 5e-4, a).astype(np.float32)
    return mean, chol


def t_kurtosis(chol: np.ndarray, df: float, n_steps: int) -> float:
    """Pooled standardised kurtosis of ``L · sum_t z_t`` for polar-t shocks.

    One draw's kurtosis follows from the polar transform on the sampler's
    uniform grid k * 2^-23 (whose floor truncates the t tail): with
    r^2 = df (u^(-2/df) - 1) and E cos^2 = 1/2, E cos^4 = 3/8. A sum of n
    draws keeps 1/n of the excess; the row mix of L keeps
    sum_j L_ij^4 / (sum_j L_ij^2)^2 of it for asset i.
    """
    u = np.arange(1, 2**23 + 1, dtype=np.float64) * 2.0**-23
    r2 = df * (u ** (-2.0 / df) - 1.0)
    kappa = (3.0 / 8.0) * np.mean(r2**2) / (np.mean(r2) / 2.0) ** 2
    lsq = chol.astype(np.float64) ** 2
    mix = float(np.mean((lsq**2).sum(1) / lsq.sum(1) ** 2))
    return 3.0 + (kappa - 3.0) / n_steps * mix


def phase_card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    print(f"phase0 card: torch device {name}, {torch.cuda.device_count()} visible, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return name


def phase_build() -> None:
    from mcport_torch import _build

    t0 = time.perf_counter()
    libs = _build.build_libraries()               # one nvcc per source, in parallel
    for name in libs:
        _build.library(name)
    print(f"phase1 build: {len(libs)} libraries in {time.perf_counter() - t0:.2f} s")
    for name, so in libs.items():
        log = so.with_suffix(".log").read_text().splitlines()
        used = [ln.split("Used")[1].strip() for ln in log if "Used" in ln]
        frames = sorted({ln.strip() for ln in log if "stack frame" in ln})
        print(f"phase1 ptxas {name}: {used}; {frames}")


def cells() -> dict:
    """The two sizes of the main paths: GBMConfig defaults and BASELINE config 4."""
    from mcport_torch.config import GBMConfig

    return {"default": GBMConfig(),
            "config4": GBMConfig(n_paths=16_777_216, path_block=1_048_576)}


def engine_groups(g) -> list[tuple[int, int]]:
    """(first_block, n_blocks) of each kernel launch ``run_resumable_mc`` makes
    for ``g``: one launch per dispatch group."""
    n = g.n_paths // g.path_block
    return [(b, min(DISPATCH, n - b)) for b in range(0, n, DISPATCH)]


def _held(k, p, tol) -> tuple[float, float]:
    """max |kernel - plain| and the largest share of its per-asset bound."""
    d = (k - p).abs()
    return float(d.max()), float((d / tol).max())


def phase_kernel_vs_plain(dev) -> float:
    from mcport_torch.ops.gbm import (block_terminal_log_returns, gbm_terminal_noise,
                                      kernel_tolerance, t_scaled_chol,
                                      terminal_noise_reference)

    worst = 0.0

    def held(what, k, p, tol, extra=True):
        nonlocal worst
        err, share = _held(k, p, tol)
        fin = bool(torch.isfinite(k).all())
        print(f"phase2 {what} max_abs={err:.3e} bound={float(tol.max()):.3e} "
              f"share={share:.3f} finite={fin}")
        check(fin and share <= 1.0 and extra, f"kernel vs plain, {what}")
        worst = max(worst, err)

    n_paths = 65_537
    for a in (1, 15, 64):
        corr = 0.5 * np.eye(a) + 0.5
        chol = torch.from_numpy(np.linalg.cholesky(4e-4 * corr).astype(np.float32)).to(dev)
        mean = torch.full((a,), 1e-3, dtype=torch.float32, device=dev)
        for tier, t_df in TIERS:
            bm = "poly" if tier == "t" else tier
            lk = t_scaled_chol(chol, t_df)
            for steps in (N_STEPS, 7):
                tol = kernel_tolerance(lk, steps)
                for anti in (False, True):
                    rows = n_paths // 2 if anti else n_paths
                    kw = dict(first_block=6, n_blocks=2, bm=bm, t_df=t_df)
                    k = gbm_terminal_noise(11, lk, rows, steps, **kw)
                    p = terminal_noise_reference(11, lk, rows, steps, **kw)
                    mirror = True
                    if anti:
                        term = block_terminal_log_returns(
                            11, mean, chol, n_paths, steps, antithetic=True, **kw)
                        drift = steps * mean
                        mirror = bool(torch.equal(term[:, :rows], drift + k)
                                      and torch.equal(term[:, rows:], drift - k))
                    held(f"tier={tier} A={a} steps={steps} antithetic={int(anti)} "
                         f"paths={n_paths} mirror={mirror}", k, p, tol, mirror)

    # single draws: with L = [[1]] the output is the normal draws themselves,
    # where one wrong polynomial of a tier shows (tests/test_torch_gbm_ops.py)
    one = torch.ones((1, 1), dtype=torch.float32, device=dev)
    for bm in ("poly", "poly_fast"):
        for steps in (1, 2):
            kw = dict(first_block=6, n_blocks=2, bm=bm)
            held(f"tier={bm} L=[[1]] steps={steps} paths=262145",
                 gbm_terminal_noise(11, one, 262_145, steps, **kw),
                 terminal_noise_reference(11, one, 262_145, steps, **kw),
                 kernel_tolerance(one, steps))

    # the launches of the main path itself (phase 4): the bench universe, the
    # engine's seed, blocks and dispatch groups
    _, chol_np = bench_universe()
    chol = torch.from_numpy(chol_np).to(dev)
    for name, g in cells().items():
        tol = kernel_tolerance(chol, g.n_steps)
        per = max(1, (1 << 20) // g.path_block)         # plain form in <= 1M-path calls
        for b0, nb in engine_groups(g):
            k = gbm_terminal_noise(g.seed, chol, g.path_block, g.n_steps,
                                   first_block=b0, n_blocks=nb, bm=g.bm)
            p = torch.cat([terminal_noise_reference(
                g.seed, chol, g.path_block, g.n_steps, first_block=b, bm=g.bm,
                n_blocks=min(per, b0 + nb - b)) for b in range(b0, b0 + nb, per)])
            held(f"engine {name} seed={g.seed} blocks={b0}..{b0 + nb - 1} "
                 f"x {g.path_block} steps={g.n_steps} A={N_ASSETS} tier={g.bm}", k, p, tol)
            del k, p
    return worst


def phase_law(dev) -> None:
    from mcport_torch.ops.gbm import terminal_log_returns

    mean_np, chol_np = bench_universe()
    mean = torch.from_numpy(mean_np).to(dev)
    chol = torch.from_numpy(chol_np).to(dev)
    cov_true = N_STEPS * chol_np.astype(np.float64) @ chol_np.T.astype(np.float64)
    se = np.sqrt(np.diag(cov_true) / LAW_PATHS)
    for tier, t_df in TIERS:
        bm = "poly" if tier == "t" else tier
        x = terminal_log_returns(5, mean, chol, LAW_PATHS, N_STEPS, bm=bm,
                                 t_df=t_df).double()
        m = x.mean(0).cpu().numpy()
        cov = torch.cov(x.T).cpu().numpy()
        z_mean = float(np.max(np.abs(m - N_STEPS * mean_np) / se))
        rel_cov = float(np.max(np.abs(cov - cov_true) / np.abs(cov_true)))
        z = (x - x.mean(0)) / x.std(0)
        kurt = float((z**4).mean())
        print(f"phase3 law tier={tier} paths={LAW_PATHS} steps={N_STEPS} "
              f"max|mean-nm|/se={z_mean:.2f} max rel cov err={rel_cov:.4f} "
              f"pooled kurtosis={kurt:.4f}")
        check(z_mean < 5.0 and rel_cov < 0.02, f"law of tier {tier}")
    steps = 4
    x = terminal_log_returns(6, mean, chol, LAW_PATHS, steps, t_df=5.5).double()
    z = (x - x.mean(0)) / x.std(0)
    kurt = float((z**4).mean())
    want = t_kurtosis(chol_np, 5.5, steps)
    print(f"phase3 law tier=t steps={steps} pooled kurtosis={kurt:.4f} "
          f"(the sampler's law: {want:.4f}; at {N_STEPS} steps "
          f"{t_kurtosis(chol_np, 5.5, N_STEPS):.4f}; normal: 3)")
    check(kurt > 3.2 and abs(kurt - want) < 0.25 * (want - 3.0), "t tier fat tails")


def _moments_equal(a, b) -> bool:
    fields = ("count", "sum", "sum_c", "outer", "outer_c", "port_sum", "hist")
    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in fields)


def phase_main_path(dev, tmp: Path) -> int:
    from mcport_torch.config import Config, GBMConfig
    from mcport_torch.api import gbm_risk
    from mcport_torch.convert import gbm_params_from_numpy
    from mcport_torch.engine.mc_engine import load_checkpoint, run_resumable_mc
    from mcport_torch.ops.gbm import gbm_terminal_noise
    from mcport_torch.ops.quantile import auto_sketch

    mean_np, chol_np = bench_universe()
    params = gbm_params_from_numpy(np.ones(N_ASSETS), mean_np, chol_np)
    w = np.full(N_ASSETS, 1.0 / N_ASSETS)
    warm_reps = 3

    def timed(g, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = gbm_risk(params, w, Config(gbm=g), device=dev, **kw)
        torch.cuda.synchronize()
        return report, time.perf_counter() - t0

    # the main path: every launch count reset just before, read just after.
    # Each cell runs once writing its checkpoint (the first call), then
    # warm_reps more times without one (the warm walls of PERF.md)
    reports, walls, groups = {}, {}, 0
    gbm_terminal_noise.launches = 0
    for name, g in cells().items():
        reports[name], first = timed(g, checkpoint_path=tmp / f"{name}.npz")
        walls[name] = (first, [timed(g)[1] for _ in range(warm_reps)])
        groups += (1 + warm_reps) * len(engine_groups(g))
    launches = gbm_terminal_noise.launches
    print(f"phase4 main path: kernel launches {launches}, dispatch groups {groups}")
    check(launches > 0 and launches == groups, "main path went through the kernel")

    for name, g in cells().items():
        r = reports[name]
        ck = load_checkpoint(tmp / f"{name}.npz")
        finite = bool(np.isfinite(r.mean).all() and np.isfinite(r.cov).all()
                      and math.isfinite(r.var) and math.isfinite(r.cvar))
        first, warm = walls[name]
        print(f"phase4 {name}: paths={r.n_paths} steps={g.n_steps} block={g.path_block} "
              f"wall first call (checkpoint written)={first:.4f} s, warm (no checkpoint)="
              f"{' / '.join(f'{t:.4f}' for t in warm)} s var={r.var:.6f} cvar={r.cvar:.6f} "
              f"port_mean={r.port_mean:.6f} hist_mass={int(ck.hist.sum())} finite={finite}")
        check(r.n_paths == g.n_paths and int(ck.hist.sum()) == g.n_paths,
              f"{name}: path count and histogram mass")
        check(finite and r.cvar <= r.var, f"{name}: finite, cvar <= var")

        # a max_blocks split plus resume is the one-shot run, bit for bit
        split = max(1, (g.n_paths // g.path_block) // 3)
        _, part = run_resumable_mc(params, w, g, max_blocks=split, device=dev)
        resumed = gbm_risk(params, w, Config(gbm=g), checkpoint=part,
                           checkpoint_path=tmp / f"{name}_resumed.npz", device=dev)
        ck2 = load_checkpoint(tmp / f"{name}_resumed.npz")
        same = (resumed.var == r.var and resumed.cvar == r.cvar
                and np.array_equal(resumed.mean, r.mean) and np.array_equal(resumed.cov, r.cov)
                and _moments_equal(ck, ck2))
        print(f"phase4 {name}: split at block {split} + resume bit-identical={same}")
        check(same and ck2.done, f"{name}: resume equivalence")

    # the card against the port's CPU run (plain sampler, same counters)
    small = GBMConfig(n_paths=16_384, n_steps=16, path_block=4_096, seed=3)
    on_card = gbm_risk(params, w, Config(gbm=small), device=dev)
    on_cpu = gbm_risk(params, w, Config(gbm=small), device="cpu")
    d_var = abs(on_card.var - on_cpu.var)
    d_cvar = abs(on_card.cvar - on_cpu.cvar)
    d_mom = max(float(np.max(np.abs(on_card.mean - on_cpu.mean))),
                float(np.max(np.abs(on_card.cov - on_cpu.cov))))
    sk = auto_sketch(params.mean_step, params.chol_step, small.n_steps)
    width = (sk.hi - sk.lo) / sk.n_bins     # a sample may cross one bin edge
    print(f"phase4 card vs cpu (16,384 x 16): |dvar|={d_var:.2e} |dcvar|={d_cvar:.2e} "
          f"(bound {2 * width:.2e}) max|dmoment|={d_mom:.2e} (bound 1e-6)")
    check(d_var <= 2 * width and d_cvar <= 2 * width and d_mom < 1e-6,
          "card agrees with CPU run")

    # default run against exact sampling: terminal log returns are exactly
    # N(n m, n LL'), so 4M exact draws give the reference VaR/CVaR
    gen = torch.Generator(device=dev).manual_seed(1234)
    n_ref = 1 << 22
    m = torch.from_numpy(mean_np).double().to(dev)
    L = torch.from_numpy(chol_np).double().to(dev)
    z = torch.randn((n_ref, N_ASSETS), generator=gen, dtype=torch.float64, device=dev)
    term = N_STEPS * m + math.sqrt(N_STEPS) * z @ L.T
    port = (torch.exp(term) - 1.0) @ torch.from_numpy(w).to(dev)
    k = math.ceil(0.05 * n_ref)
    worst = torch.topk(port, k, largest=False).values
    ref_var, ref_cvar = float(worst.max()), float(worst.mean())
    r = reports["default"]
    cov_true = N_STEPS * chol_np.astype(np.float64) @ chol_np.T.astype(np.float64)
    se = np.sqrt(np.diag(cov_true) / r.n_paths)
    z_mean = float(np.max(np.abs(r.mean - N_STEPS * mean_np) / se))
    rel_cov = float(np.max(np.abs(r.cov - cov_true) / cov_true))
    rel = (abs(r.var - ref_var) / abs(ref_var), abs(r.cvar - ref_cvar) / abs(ref_cvar))
    print(f"phase4 default vs exact sampling: var {r.var:.6f} vs {ref_var:.6f}, "
          f"cvar {r.cvar:.6f} vs {ref_cvar:.6f} (rel {rel[0]:.4f}, {rel[1]:.4f}); "
          f"max|mean-nm|/se={z_mean:.2f} max rel cov err={rel_cov:.4f}")
    check(rel[0] < 0.03 and rel[1] < 0.03 and z_mean < 5 and rel_cov < 0.05,
          "default run agrees with exact sampling")
    return launches


def _time_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing(dev) -> tuple[float, float]:
    from mcport_torch.ops.gbm import gbm_terminal_noise, terminal_noise_reference

    _, chol_np = bench_universe()
    chol = torch.from_numpy(chol_np).to(dev)

    def kernel():
        gbm_terminal_noise(0, chol, LAW_PATHS, N_STEPS)

    def plain():
        terminal_noise_reference(0, chol, LAW_PATHS, N_STEPS)

    kernel(), plain()                       # warm up both
    torch.cuda.synchronize()
    p1 = _time_ms(plain, 1)
    k1 = _time_ms(kernel, 20)
    k2 = _time_ms(kernel, 20)
    p2 = _time_ms(plain, 1)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    work = LAW_PATHS * N_STEPS
    print(f"phase5 timing {LAW_PATHS} x {N_STEPS} x {N_ASSETS}: kernel {k1:.3f} / {k2:.3f} ms "
          f"({work / ms * 1e3:.4e} path-steps/s), plain {p1:.1f} / {p2:.1f} ms "
          f"({work / plain_ms * 1e3:.4e} path-steps/s)")

    # the kernel's other tiers (the main path's default is poly, timed above)
    for tier, t_df in TIERS[1:]:
        bm = "poly" if tier == "t" else tier

        def other(bm=bm, t_df=t_df):
            gbm_terminal_noise(0, chol, LAW_PATHS, N_STEPS, bm=bm, t_df=t_df)

        other()
        t = _time_ms(other, 20)
        print(f"phase5 timing tier={tier}: kernel {t:.3f} ms ({work / t * 1e3:.4e} path-steps/s)")
    return ms, plain_ms


# ---- the GBM path tier: kernels #2 (path stats) and #3 (multi-dd) -----------------

PATH_MODES = (("buy-hold", False, None), ("rebalanced", True, None),
              ("buy-hold t", False, 5.5), ("rebalanced t", True, 5.5))
FRONTIER = dict(dd_budget=0.5, n_candidates=4_096, n_paths=131_072, n_steps=N_STEPS)
FRONTIER_SEED = 5                   # bench.py:257-258 (and its key)
KERNEL_PATHS = 16_385               # ragged: not a whole number of CUDA blocks
MDD_PATHS = 4_099                   # ragged: not a whole number of 16-path tiles
PLAIN_CHUNK = 131_072               # paths per plain-form call at 15 assets
MDD_PLAIN_CHUNK = 8_192             # paths per plain multi-dd call at 256 candidates
LAYOUT_PATHS = 1_029                # #3's layouts by name: not a whole number of blocks


def path_config(g, t_df):
    return g if t_df is None else dataclasses.replace(g, innovations="student_t",
                                                      t_dof=t_df)


def bench_weights(a: int = N_ASSETS) -> np.ndarray:
    return np.random.default_rng(1).dirichlet(np.ones(a))


def bench_prices():
    """A price history for ``path_tail_risk``: 504 daily steps of the bench
    universe from seed 2 (``names``, ``prices`` and their ``port_rets``, the
    simple returns with a zero first row, are all it reads)."""
    from types import SimpleNamespace

    mean, chol = bench_universe()
    z = np.random.default_rng(2).standard_normal((504, N_ASSETS))
    logp = np.cumsum(mean + z @ chol.T.astype(np.float64), axis=0)
    prices = 100.0 * np.exp(np.vstack([np.zeros(N_ASSETS), logp]))
    port_rets = np.vstack([np.zeros(N_ASSETS), prices[1:] / prices[:-1] - 1.0])
    return SimpleNamespace(names=tuple(f"asset{i}" for i in range(N_ASSETS)), prices=prices,
                           port_rets=port_rets)


def path_launches() -> list[dict]:
    """Every launch of the path-stats kernel that phase 7 makes: the engine's
    dispatch groups for each size and mode, and ``path_tail_risk``'s
    (estimated from ``bench_prices``, rebalanced, default size)."""
    from mcport_torch.config import GBMConfig
    from mcport_torch.models.gbm import estimate_gbm, estimate_t_dof

    mean, chol = bench_universe()
    w = bench_weights()
    out = []
    for name, g in cells().items():
        for mode, reb, t_df in PATH_MODES:
            for b0, nb in engine_groups(g):
                out.append(dict(what=f"engine {name} {mode} blocks={b0}..{b0 + nb - 1}",
                                seed=g.seed, mean=mean, chol=chol, w=w,
                                block=g.path_block, steps=g.n_steps, first_block=b0,
                                n_blocks=nb, rebalance=reb, t_df=t_df))
    est = estimate_gbm(bench_prices().prices)
    g = GBMConfig()
    for model, t_df in (("gbm", None), ("student_t", estimate_t_dof(bench_prices().prices))):
        for b0, nb in engine_groups(g):
            out.append(dict(what=f"path_tail_risk {model} blocks={b0}..{b0 + nb - 1}",
                            seed=g.seed, mean=est.mean_step.numpy(),
                            chol=est.chol_step.numpy(), w=np.full(N_ASSETS, 1 / N_ASSETS),
                            block=g.path_block, steps=g.n_steps, first_block=b0,
                            n_blocks=nb, rebalance=True, t_df=t_df))
    return out


def _plain_path_stats(seed, mean, lk, w, n_paths, steps, *, first_block=-1, n_blocks=1,
                      **kw):
    """The plain form over ``n_paths`` paths of each block, block by block in
    PLAIN_CHUNK-path pieces → (term, port, dd) on the card."""
    from mcport_torch.ops.path_stats import path_stats_reference

    blocks = []
    for b in range(n_blocks):
        parts = [path_stats_reference(seed, mean, lk, w, min(PLAIN_CHUNK, n_paths - p), steps,
                                      first_block=first_block + b, first_path=p, **kw)
                 for p in range(0, n_paths, PLAIN_CHUNK)]
        blocks.append(tuple(torch.cat([x[i] for x in parts], dim=1) for i in range(3)))
    return tuple(torch.cat([x[i] for x in blocks]) for i in range(3))


def _plain_multi_dd(seed, mean, lk, w, n_paths, steps, **kw):
    """The plain multi-dd form of one block in MDD_PLAIN_CHUNK-path pieces."""
    from mcport_torch.ops.multi_dd import multi_dd_reference

    parts = [multi_dd_reference(seed, mean, lk, w, min(MDD_PLAIN_CHUNK, n_paths - p),
                                steps, first_path=p, **kw)
             for p in range(0, n_paths, MDD_PLAIN_CHUNK)]
    return tuple(torch.cat([x[i] for x in parts], dim=2) for i in range(2))


def phase_path_kernels(dev) -> dict:
    """Kernels #2 and #3 against their plain forms and each other; returns the
    largest |kernel - plain| of each."""
    from mcport_torch.engine.drawdown_frontier import frontier_seeds
    from mcport_torch.ops.dirichlet import sample_weights
    from mcport_torch.ops.gbm import block_terminal_log_returns, t_scaled_chol
    from mcport_torch.ops.multi_dd import (gbm_multi_portfolio_dd, multi_dd_reference,
                                           multi_dd_shares)
    from mcport_torch.ops.path_stats import (gbm_path_stats, path_stats_reference,
                                             path_stats_shares, path_stats_tolerance)

    worst = {"path_stats": 0.0, "multi_dd": 0.0}

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def held_ps(what, k, p, lk, mean, steps):
        shares = path_stats_shares(k, p, lk, mean, steps)
        err = max(float((a - b).abs().max()) for a, b in zip(k, p)
                  if a is not None and a.numel())
        print(f"phase6 path_stats {what} max_abs={err:.3e} shares="
              + " ".join(f"{n}={v:.3f}" for n, v in shares.items()))
        check(max(shares.values()) <= 1.0, f"path-stats kernel vs plain, {what}")
        worst["path_stats"] = max(worst["path_stats"], err)

    # the shapes: tiers, modes, widths, step counts; a ragged path count over two blocks
    for a in (1, 15, 64):
        rng = np.random.default_rng(a)
        mean = t(rng.normal(1e-3, 5e-4, a))
        chol = t(np.linalg.cholesky(4e-4 * (0.5 * np.eye(a) + 0.5)))
        w = t(rng.dirichlet(np.ones(a)))
        for tier, t_df in TIERS:
            bm = "poly" if tier == "t" else tier
            lk = t_scaled_chol(chol, t_df)
            for steps in (N_STEPS, 7):
                for reb in (False, True):
                    kw = dict(first_block=6, n_blocks=2, bm=bm, t_df=t_df, rebalance=reb)
                    k = gbm_path_stats(11, mean, chol, w, KERNEL_PATHS, steps, **kw)
                    p = path_stats_reference(11, mean, lk, w, KERNEL_PATHS, steps, **kw)
                    held_ps(f"tier={tier} A={a} steps={steps} rebalance={int(reb)} "
                            f"paths={KERNEL_PATHS}x2", k, p, lk, mean, steps)
                    del k, p

    # every launch of phase 7, against the plain form over a head slice of
    # each block's paths
    for launch in path_launches():
        mean, chol, w = t(launch["mean"]), t(launch["chol"]), t(launch["w"])
        lk = t_scaled_chol(chol, launch["t_df"])
        kw = dict(first_block=launch["first_block"], n_blocks=launch["n_blocks"],
                  rebalance=launch["rebalance"], t_df=launch["t_df"])
        n = launch["block"]
        k = gbm_path_stats(launch["seed"], mean, chol, w, n, launch["steps"],
                           terminal=False, **kw)
        for p0 in _slices(n):
            m = min(SLICE, n)
            _, port, dd = path_stats_reference(launch["seed"], mean, lk, w, m, launch["steps"],
                                               first_path=p0, **kw)
            held_ps(f"{launch['what']} x {n} paths {p0}..{p0 + m - 1}",
                    (None, k[1][:, p0:p0 + m], k[2][:, p0:p0 + m]), (None, port, dd), lk,
                    mean, launch["steps"])
        del k

    # consistency: #2's terminal is #1's at the same seed and blocks; #3 with
    # one candidate is #2
    mean_np, chol_np = bench_universe()
    mean, chol, w = t(mean_np), t(chol_np), t(bench_weights())
    g = cells()["default"]
    grp = dict(first_block=0, n_blocks=g.n_paths // g.path_block)
    for t_df in (None, 5.5):
        term, port, dd = gbm_path_stats(g.seed, mean, chol, w, g.path_block, N_STEPS,
                                        t_df=t_df, **grp)
        ref = block_terminal_log_returns(g.seed, mean, chol, g.path_block, N_STEPS,
                                         t_df=t_df, **grp)
        tol, _ = path_stats_tolerance(t_scaled_chol(chol, t_df), mean, N_STEPS)
        d = (term - ref).abs()
        print(f"phase6 consistency #1/#2 t_df={t_df} {grp['n_blocks']} x {g.path_block} "
              f"x {N_STEPS}: max "
              f"|terminal(#2) - terminal(#1)|={float(d.max()):.3e} share="
              f"{float((d / tol.to(dev)).max()):.3f}")
        check(bool((d <= tol.to(dev)).all()), "kernel #2 terminal is kernel #1's")
        for reb in (False, True):
            _, port, dd = gbm_path_stats(g.seed, mean, chol, w, g.path_block, N_STEPS,
                                         rebalance=reb, t_df=t_df, terminal=False, **grp)
            term3, dd3 = gbm_multi_portfolio_dd(g.seed, mean, chol, w[None], g.path_block,
                                                N_STEPS, rebalance=reb, t_df=t_df, **grp)
            same = torch.equal(term3[:, 0], port) and torch.equal(dd3[:, 0], dd)
            print(f"phase6 consistency #2/#3 (W=1) t_df={t_df} rebalance={int(reb)}: "
                  f"bit-identical={same} max|d|={float((term3[:, 0] - port).abs().max()):.3e}"
                  f"/{float((dd3[:, 0] - dd).abs().max()):.3e}")
            check(same, "kernel #3 with one candidate is kernel #2")

    def held_md(what, k, p, p32, lk, mean, steps, reb, sd):
        shares = multi_dd_shares(k, p, p32, lk, mean, steps, reb, sd)
        err = max(float((a - b).abs().max()) for a, b in zip(k, p))
        print(f"phase6 multi_dd {what} max_abs={err:.3e} shares="
              + " ".join(f"{n}={v:.3f}" for n, v in shares.items()))
        check(max(shares.values()) <= 1.0, f"multi-dd kernel vs plain, {what}")
        worst["multi_dd"] = max(worst["multi_dd"], err)

    for n_cand in (1, 13, 256):
        cand = t(np.random.default_rng(n_cand).dirichlet(np.ones(N_ASSETS), n_cand))
        for reb in (False, True):
            kw = dict(first_block=6, n_blocks=2, rebalance=reb)
            p32 = multi_dd_reference(11, mean, chol, cand, MDD_PATHS, N_STEPS, **kw)
            for sd in ("float32", "tensorfloat32", "bfloat16"):
                k = gbm_multi_portfolio_dd(11, mean, chol, cand, MDD_PATHS, N_STEPS,
                                           score_dtype=sd, **kw)
                p = (p32 if sd == "float32" else
                     multi_dd_reference(11, mean, chol, cand, MDD_PATHS, N_STEPS,
                                        score_dtype=sd, **kw))
                held_md(f"W={n_cand} rebalance={int(reb)} score={sd} A={N_ASSETS} "
                        f"steps={N_STEPS} paths={MDD_PATHS}x2", k, p, p32, chol, mean,
                        N_STEPS, reb, sd)
    for tier, t_df in TIERS:
        bm = "poly" if tier == "t" else tier
        cand = t(np.random.default_rng(7).dirichlet(np.ones(N_ASSETS), 13))
        lk = t_scaled_chol(chol, t_df)
        k = gbm_multi_portfolio_dd(11, mean, chol, cand, MDD_PATHS, 7, bm=bm, t_df=t_df)
        p = multi_dd_reference(11, mean, lk, cand, MDD_PATHS, 7, bm=bm, t_df=t_df)
        held_md(f"W=13 tier={tier} steps=7", k, p, p, lk, mean, 7, False, "float32")

    # one 256-candidate chunk of phase 7's frontier over all its paths, in the
    # float32 tier and the bf16 screen
    path_seed, weight_seed = frontier_seeds(FRONTIER_SEED)
    gen = torch.Generator(device=dev).manual_seed(weight_seed)
    cand, _ = sample_weights(gen, FRONTIER["n_candidates"], np.zeros(N_ASSETS),
                             np.ones(N_ASSETS))
    cand = cand[:256]
    n_paths = FRONTIER["n_paths"]
    p32 = _plain_multi_dd(path_seed, mean, chol, cand, n_paths, N_STEPS)
    for sd in ("float32", "bfloat16"):
        k = gbm_multi_portfolio_dd(path_seed, mean, chol, cand, n_paths, N_STEPS,
                                   score_dtype=sd)
        p = p32 if sd == "float32" else _plain_multi_dd(path_seed, mean, chol, cand,
                                                        n_paths, N_STEPS, score_dtype=sd)
        held_md(f"frontier chunk 0 W=256 score={sd} paths={n_paths}", k, p, p32, chol,
                mean, N_STEPS, False, sd)
        del k, p

    _gbm_layout_checks(dev, mean, chol)
    return worst


def _gbm_layout_checks(dev, mean, chol) -> None:
    """Every routed layout of #3 up to 16 assets (ops.multi_dd.gbm_narrow_plan)
    at the bench universe ``mean, chol``: W = 1, each side of every switch of
    each mode, and 256, in each score tier (and t(5.5) shocks at the
    switches), in the layout W picks and in every layout by name, bit for bit
    with each other and within the plain form's bound (hedged: two legs per
    asset of every type, path by path)."""
    from mcport_torch.ops.gbm import t_scaled_chol
    from mcport_torch.ops.multi_dd import (_launch, gbm_multi_portfolio_dd, gbm_narrow_plan,
                                           multi_dd_reference, multi_dd_shares)

    legs = leg_mix(N_ASSETS, 2, dev, seed=5)
    for mode in ("buy-hold", "rebalanced", "hedged"):
        reb, hedge = mode == "rebalanced", (legs if mode == "hedged" else None)
        n_legs = 2 if hedge is not None else 0

        def plan(*x, **k):
            return gbm_narrow_plan(*x, rebalance=reb, **k)

        for n_cand in layout_switches(plan):
            cand = torch.as_tensor(np.random.default_rng(n_cand).dirichlet(
                np.ones(N_ASSETS), n_cand), dtype=torch.float32, device=dev)
            cases = [("float32", None), ("tensorfloat32", None), ("bfloat16", None)]
            cases += [("float32", 5.5)] if n_cand not in (1, 256) else []
            for sd, t_df in cases:
                lk = t_scaled_chol(chol, t_df)
                kw = dict(first_block=6, n_blocks=2, rebalance=reb, hedge=hedge, t_df=t_df)
                k = gbm_multi_portfolio_dd(11, mean, chol, cand, LAYOUT_PATHS, 52, score_dtype=sd,
                                           **kw)
                p32 = multi_dd_reference(11, mean, lk, cand, LAYOUT_PATHS, 52, **kw)
                p = (p32 if sd == "float32" and hedge is None else
                     multi_dd_reference(11, mean, lk, cand, LAYOUT_PATHS, 52, score_dtype=sd,
                                        with_bound=hedge is not None, **kw))
                what = (f"layouts W={n_cand} {mode} score={sd} t_df={t_df} "
                        f"{LAYOUT_PATHS}x2 x 52")
                shares = multi_dd_shares(k, p, p32, lk, mean, 52, reb, sd, hedge)
                routed = plan(N_ASSETS, n_cand, 52, LAYOUT_PATHS, 2, n_legs, score_dtype=sd)
                print(f"phase6 multi_dd {what} by W ({routed.layout}) max_abs="
                      f"{max(float((a - b).abs().max()) for a, b in zip(k, p)):.3e} shares="
                      + " ".join(f"{n}={v:.3f}" for n, v in shares.items()))
                check(max(shares.values()) <= 1.0, f"multi-dd kernel vs plain, {what}")
                for layout in ("solo", "split"):
                    try:
                        plan(N_ASSETS, n_cand, 52, LAYOUT_PATHS, 2, n_legs, layout=layout,
                             score_dtype=sd)
                    except ValueError:
                        continue
                    got = _launch(11, mean, lk, cand, LAYOUT_PATHS, 52, 6, 2, reb, sd, "poly",
                                  t_df, hedge, layout)
                    same = all(torch.equal(a, b) for a, b in zip(got, k))
                    print(f"phase6 multi_dd {what} {layout}: bit for bit with the layout W "
                          f"picks={same}")
                    check(same, f"multi-dd layout {layout} is the routed one, {what}")


def _reports_equal(a, b) -> bool:
    """Equal fields, a NaN equal to a NaN (the drawdown sum of overflowed
    hedged wealth)."""
    def same(x, y):
        return x == y or (isinstance(x, float) and math.isnan(x) and math.isnan(y))

    return all(same(getattr(a, f), getattr(b, f)) for f in
               ("var", "cvar", "port_mean", "dd_mean", "dd_p95", "dd_median", "n_paths"))


def phase_path_tier(dev) -> dict:
    """The path tier's main path: run_path_risk and path_tail_risk at both
    sizes and all modes, split + resume, and the drawdown frontier at the
    bench's size in the float32, auto and bfloat16 tiers."""
    from mcport_torch.api import path_tail_risk
    from mcport_torch.config import Config
    from mcport_torch.convert import gbm_params_from_numpy
    from mcport_torch.engine.drawdown_frontier import drawdown_frontier_search
    from mcport_torch.engine.mc_engine import run_resumable_mc
    from mcport_torch.engine.path_risk import (DD_SKETCH, run_path_risk,
                                               run_resumable_path_risk)
    from mcport_torch.ops.multi_dd import gbm_multi_portfolio_dd, multi_dd_tolerance
    from mcport_torch.ops.path_stats import gbm_path_stats

    mean_np, chol_np = bench_universe()
    params = gbm_params_from_numpy(np.ones(N_ASSETS), mean_np, chol_np)
    w = bench_weights()
    warm_reps = 2

    def timed(fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # the main path: every count reset just before, read just after
    gbm_path_stats.launches = 0
    gbm_multi_portfolio_dd.launches = 0
    reports, walls, groups = {}, {}, 0
    for name, g in cells().items():
        for mode, reb, t_df in PATH_MODES:
            cfg = path_config(g, t_df)
            reports[name, mode], first = timed(run_path_risk, params, w, cfg,
                                               rebalance=reb, device=dev)
            walls[name, mode] = (first, [timed(run_path_risk, params, w, cfg, rebalance=reb,
                                               device=dev)[1] for _ in range(warm_reps)])
            groups += (1 + warm_reps) * len(engine_groups(g))
    resumes = {}
    for name, g in cells().items():
        n_blocks = g.n_paths // g.path_block
        full, ck_full = run_resumable_path_risk("gbm", params, w, g, rebalance=False,
                                                device=dev)
        _, part = run_resumable_path_risk("gbm", params, w, g, rebalance=False,
                                          max_blocks=n_blocks // 3, device=dev)
        resumed, ck = run_resumable_path_risk("gbm", params, w, g, rebalance=False,
                                              checkpoint=part, device=dev)
        resumes[name] = (full, ck_full, part, resumed, ck)
        groups += 3 * len(engine_groups(g)) - (1 if n_blocks // 3 == 0 else 0)
    prices = bench_prices()
    tail = {}
    for model in ("gbm", "student_t"):
        tail[model], first = timed(path_tail_risk, prices, None, Config(), model=model,
                                   device=dev)
        walls["path_tail_risk", model] = (first, [])
        groups += len(engine_groups(Config().gbm))
    frontier = {}
    for sd in ("float32", "auto", "bfloat16"):
        r, first = timed(drawdown_frontier_search, FRONTIER_SEED, params, score_dtype=sd,
                         device=dev, **FRONTIER)
        warm = [timed(drawdown_frontier_search, FRONTIER_SEED, params, score_dtype=sd,
                      device=dev, **FRONTIER)[1] for _ in range(warm_reps)]
        frontier[sd], walls["frontier", sd] = r, (first, warm)
    launches = {"path_stats": gbm_path_stats.launches,
                "multi_dd": gbm_multi_portfolio_dd.launches}
    chunks = FRONTIER["n_candidates"] // 256
    scored = len(frontier) * chunks * (1 + warm_reps)
    print(f"phase7 path tier: path-stats launches {launches['path_stats']} (dispatch "
          f"groups {groups}), multi-dd launches {launches['multi_dd']} (> "
          f"{scored} chunks, plus the bf16 screen's rescores)")
    check(launches["path_stats"] == groups, "path tier went through the path-stats kernel")
    check(launches["multi_dd"] > scored,
          "frontier went through the multi-dd kernel (chunks and rescores)")

    # what came out
    dd_width = (DD_SKETCH.hi - DD_SKETCH.lo) / DD_SKETCH.n_bins
    for (name, mode), r in reports.items():
        first, warm = walls[name, mode]
        ok = (all(math.isfinite(getattr(r, f)) for f in
                  ("var", "cvar", "port_mean", "dd_mean", "dd_p95", "dd_median"))
              and r.cvar <= r.var and -1.0 <= r.dd_p95 <= r.dd_median <= 0.0
              and -1.0 <= r.dd_mean <= 0.0 and r.n_paths == cells()[name].n_paths)
        print(f"phase7 run_path_risk {name} {mode}: paths={r.n_paths} wall first="
              f"{first:.4f} s warm={' / '.join(f'{x:.4f}' for x in warm)} s var={r.var:.6f} "
              f"cvar={r.cvar:.6f} port_mean={r.port_mean:.6f} dd_mean={r.dd_mean:.6f} "
              f"dd_median={r.dd_median:.6f} dd_p95={r.dd_p95:.6f} sane={ok}")
        check(ok, f"path risk {name} {mode}: finite and ordered")
    for name, (full, ck_full, part, resumed, ck) in resumes.items():
        same = (_reports_equal(full, resumed) and ck.done and not part.done
                and all(np.array_equal(getattr(ck, f), getattr(ck_full, f))
                        for f in ("h_port", "h_dd", "s_port", "s_dd"))
                and _reports_equal(full, reports[name, "buy-hold"]))
        print(f"phase7 {name}: split at block {part.next_block} + resume bit-identical to "
              f"the one-shot run and to run_path_risk={same}")
        check(same, f"{name}: path-risk resume equivalence")
    for model, out in tail.items():
        print(f"phase7 path_tail_risk {model}: wall {walls['path_tail_risk', model][0]:.4f} "
              f"s {json.dumps(out)}")
        check(out["n_paths"] == Config().gbm.n_paths and out["cvar"] <= out["var"]
              and -1.0 <= out["dd_p95"] <= 0.0, f"path_tail_risk {model}")

    # against references: the buy-hold terminal VaR is gbm-risk's on the same
    # shocks (different sketches: within two bins of each); the drawdown
    # quantiles are the plain form's over the same paths (within two dd bins)
    from mcport_torch.ops.path_stats import path_stats_reference

    g = cells()["default"]
    rr, _ = run_resumable_mc(params, w, g, device=dev)
    r = reports["default", "buy-hold"]
    var_gap = abs(r.var - rr.var)
    print(f"phase7 default buy-hold: path-tier var {r.var:.6f} vs gbm-risk var "
          f"{rr.var:.6f} on the same shocks (|d|={var_gap:.2e}, bound 2e-3)")
    check(var_gap < 2e-3, "path-tier VaR agrees with gbm-risk's")
    t = torch.as_tensor
    _, port, dd = path_stats_reference(
        g.seed, t(mean_np, device=dev), t(chol_np, device=dev),
        t(w, dtype=torch.float32, device=dev), g.path_block, g.n_steps, first_block=0,
        n_blocks=g.n_paths // g.path_block)
    k = math.ceil(0.05 * dd.numel())
    ref_p95 = float(torch.kthvalue(dd.reshape(-1), k).values)
    ref_med = float(torch.median(dd.reshape(-1)))
    ref_mean = float(dd.double().mean())
    print(f"phase7 default buy-hold dd vs plain form over the same paths: p95 {r.dd_p95:.6f} "
          f"vs {ref_p95:.6f}, median {r.dd_median:.6f} vs {ref_med:.6f}, mean "
          f"{r.dd_mean:.6f} vs {ref_mean:.6f} (bound {2 * dd_width:.2e})")
    check(abs(r.dd_p95 - ref_p95) <= 2 * dd_width and abs(r.dd_median - ref_med) <= 2 * dd_width
          and abs(r.dd_mean - ref_mean) <= 1e-5, "drawdown quantiles agree with the plain form")

    r32 = frontier["float32"]

    def equivalent(r) -> bool:
        return r32.opt_idx >= 0 and r.opt_idx >= 0 and (r32.opt_idx == r.opt_idx or abs(
            float(r32.ret[r32.opt_idx]) - float(r.ret[r.opt_idx]))
            <= 4e-7 * max(1.0, abs(float(r32.ret[r32.opt_idx]))))

    for sd, r in frontier.items():
        first, warm = walls["frontier", sd]
        i = r.opt_idx
        print(f"phase7 frontier {sd}: {FRONTIER['n_candidates']} x {FRONTIER['n_paths']} x "
              f"{N_STEPS} wall first={first:.4f} s warm={' / '.join(f'{x:.4f}' for x in warm)}"
              f" s feasible={int(r.feasible.sum())} opt={i} ret={float(r.ret[i]):.6f} "
              f"dd_p95={float(r.dd_p95[i]):.6f}")
    same = {sd: equivalent(frontier[sd]) for sd in ("auto", "bfloat16")}
    print(f"phase7 frontier: optima equivalent to float32's (bench.py's rule): {same}")
    check(all(same.values()) and float(r32.dd_p95[r32.opt_idx]) >= -FRONTIER["dd_budget"],
          "frontier: auto and bfloat16 give float32's feasible optimum")
    opt = torch.as_tensor(r32.weights[r32.opt_idx][None], device=dev)
    from mcport_torch.engine.drawdown_frontier import frontier_seeds

    term, dd = _plain_multi_dd(frontier_seeds(FRONTIER_SEED)[0], t(mean_np, device=dev),
                               t(chol_np, device=dev), opt, FRONTIER["n_paths"], N_STEPS)
    k = max(1, math.ceil(0.05 * FRONTIER["n_paths"]))
    p_ret = float(term[0, 0].mean())
    p_dd = float(torch.kthvalue(dd[0, 0], k).values)
    rel = multi_dd_tolerance(torch.as_tensor(chol_np), torch.as_tensor(mean_np), N_STEPS,
                             False, "float32")
    print(f"phase7 frontier optimum vs plain form: ret {float(r32.ret[r32.opt_idx]):.7f} vs "
          f"{p_ret:.7f}, dd_p95 {float(r32.dd_p95[r32.opt_idx]):.7f} vs {p_dd:.7f} "
          f"(bounds {rel * (1 + abs(p_ret)):.2e}, {2 * rel:.2e})")
    check(abs(float(r32.ret[r32.opt_idx]) - p_ret) <= rel * (1 + abs(p_ret))
          and abs(float(r32.dd_p95[r32.opt_idx]) - p_dd) <= 2 * rel,
          "frontier optimum agrees with the plain form")
    return launches


def _sass_loops(so: Path, kernel: str) -> list[tuple[int, int, list[str]]]:
    """Every loop of ``kernel`` in library ``so`` (``cuobjdump -sass``): a
    backward branch and its target → ``(first, last, instructions)``."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    out = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass", str(so)],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    body = next(f for f in re.split(r"\n\s*Function : ", out)[1:]
                if kernel in f.split("\n", 1)[0])
    ins = [(int(m[1], 16), m[2]) for m in
           re.finditer(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", body, re.M)]
    at = {a: i for i, (a, _) in enumerate(ins)}
    loops = []
    for i, (_, text) in enumerate(ins):
        m = re.search(r"\bBRA\s+0x([0-9a-f]+)", text)
        if m and at.get(int(m[1], 16), i + 1) <= i:
            j = at[int(m[1], 16)]
            loops.append((j, i, [t for _, t in ins[j:i + 1]]))
    return loops


def _hot_loop(loops, ops: tuple[str, ...], per_iter: int,
              within=None) -> tuple[int, int, tuple[int, int]]:
    """(instructions, source iterations) of the innermost loop that holds at
    least one source iteration's worth (``per_iter``, less a quarter for
    operands the compiler hoisted) of the instructions ``ops``, inside the
    loop ``within`` if given; a body unrolled u times counts u iterations."""
    found = []
    for j, i, body in loops:
        if within is not None and not within[0] <= j <= i <= within[1]:
            continue
        n_op = sum(any(o in t for o in ops) for t in body)
        if n_op >= 0.75 * per_iter:
            found.append((len(body), max(1, round(n_op / per_iter)), (j, i)))
    check(bool(found), f"no loop with {per_iter} x {ops} in the SASS")
    return min(found)


PHILOX_MULS = ("IMAD.WIDE.U32", "IMAD.HI.U32")   # 2 per Philox round, 20 per call

#: a probe of the draws alone: kernel #1's Philox-call loop (four normal draws
#: and their running sum) in the poly tier and in the strict tier the Heston
#: kernels draw (gbm_draws.cuh kPolyStrict: every operation rounded as the
#: torch form rounds it, no contraction)
DRAW_PROBE = r"""
#include "gbm_draws.cuh"
template <int kTier>
__device__ void probe(long long seed, int n_calls, float* out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t key = block_key(seed, 0, 0);
  float acc = 0.0f;
  for (int c = 0; c < n_calls; ++c) {
    float z[4];
    call_draws<kTier>(c, 0, p, key, 4, 0.0f, 0.0f, z);
    acc = acc + ((z[0] + z[1]) + (z[2] + z[3]));
  }
  out[p] = acc;
}
extern "C" __global__ void draw_probe_poly(long long s, int n, float* o) { probe<kPoly>(s, n, o); }
extern "C" __global__ void draw_probe_strict(long long s, int n, float* o) {
  probe<kPolyStrict>(s, n, o);
}
"""


def draw_counts() -> dict:
    """Instructions per draw in the SASS: kernel #1's loop per Philox call
    over its draws (four normal, two Student-t) and the probe's loops, poly
    and strict (``DRAW_PROBE``, built with nvcc into a temporary
    directory)."""
    from torch.utils.cpp_extension import CUDA_HOME

    from mcport_torch import _build

    lib = _build.build_libraries(("terminal_noise",))["terminal_noise"]
    out = {}
    for tier, name, draws in (("poly", "terminal_noise_kernelILi0E", 4),
                              ("t", "terminal_noise_kernelILi2E", 2)):
        ins, its, _ = _hot_loop(_sass_loops(lib, name), PHILOX_MULS, 20)
        out[f"kernel #1 {tier}"] = ins / its / draws
    with tempfile.TemporaryDirectory() as tmp:
        src, cubin = Path(tmp) / "probe.cu", Path(tmp) / "probe.cubin"
        src.write_text(DRAW_PROBE)
        subprocess.run([str(Path(CUDA_HOME) / "bin" / "nvcc"), "-cubin", "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        f"-I{_build._CSRC}", "-o", str(cubin), str(src)], check=True,
                       timeout=300, capture_output=True)
        for tier in ("poly", "strict"):
            ins, its, _ = _hot_loop(_sass_loops(cubin, f"draw_probe_{tier}"), PHILOX_MULS, 20)
            out[f"probe {tier}"] = ins / its / 4
    return out


def issue_rate() -> float:
    """Thread-instructions the card can issue per second: 4 schedulers of 32
    lanes per SM at the maximum SM clock."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=60)
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 4 * 32 * mhz * 1e6


HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3 peak bandwidth


def bounds(rate: float) -> dict:
    """Least time of each kernel at its timing shape: the larger of its bytes
    over HBM bandwidth and its instructions over the issue rate. Kernel #1
    counts its hot loop's SASS; #2 and #3 count what the function needs, as
    ``family_bounds`` counts #5 and #7, built from kernel #1's measured
    draw (#2 prints the 16-asset recursion's own loop beside it, #3 the
    former yardstick, ``multi_dd_kernel``'s SASS score loop, once); #3 also
    at one candidate (the path-risk engine's W = 1, 131,072 x 252), plain
    and hedged. The rest of each kernel is left out: a lower bound."""
    from mcport_torch import _build

    libs = _build.build_libraries()
    a, p, n = N_ASSETS, LAW_PATHS, N_STEPS
    out = {}
    # kernel #1, poly: the pair loop, one Philox call per iteration, per asset
    ins, its, _ = _hot_loop(_sass_loops(libs["terminal_noise"], "terminal_noise_kernelILi0E"),
                            PHILOX_MULS, 20)
    calls = -(-(n // 2 + n % 2) // 2)
    out["terminal_noise"] = (ins * a * (calls // its) * p, 4 * (a * a + p * a),
                             f"pair loop {ins} instructions / {its} Philox call(s)")
    # kernel #2, poly buy-and-hold, what the function needs per asset-step:
    # kernel #1's draw (its pair loop per Philox call of four steps, the
    # running sum included), the lower triangle of L z ((A+1)/2 FMAs), exp
    # (FMUL, MUFU.EX2) and the w.exp FMA; per path-step the peak and the
    # drawdown (FMNMX, MUFU.RCP, FFMA, FMNMX)
    draw = ins / its / 4
    # kernel #1's t tier (the draw that #4's t(5.5) bound charges) and the
    # strict draw of the Heston kernels, printed beside #9's bound below
    draws = draw_counts()
    per_step = a * (draw + (a + 1) / 2 + 3) + 4
    out["path_stats"] = (per_step * n * p, 4 * (a * a + 2 * a) + 8 * p,
                         f"{draw:.2f} instructions per draw (kernel #1) + {(a + 1) / 2:.0f} "
                         f"FMAs + 3 per asset-step, + 4 per path-step: {per_step:.2f} per "
                         f"path-step")
    # beside it, the kernel's own loop (path_stats_narrow_kernel, up to 16
    # assets, poly buy-and-hold): one iteration is 16 assets' Philox calls and
    # four steps, of which A=15 runs 15/16 of the draws (printed only)
    ins, its, _ = _hot_loop(_sass_loops(libs["path_stats"], "path_stats_narrow_kernelILi0ELb0EE"),
                            PHILOX_MULS, 16 * 20)
    own = ins * (a / 16) * ((-(-n // 4)) // its) * p
    print(f"phase8 path_stats own call loop: {ins} instructions / {its} call(s) of 16 "
          f"assets, {ins / its / 64:.2f} per asset-step; at A={a} {own:.4e} "
          f"instructions = {own / rate * 1e3:.3f} ms at {rate:.4e}/s")
    # kernel #3 at the frontier's shape, float32 buy-and-hold, what the
    # function needs per path-step: the draws, the lower triangle of L z, 3
    # per asset-step (m, logS, exp), then W·(A + 6) for scoring (W·A FMAs, V,
    # peak, dd), as family_bounds counts #5 and #7
    w_cnt, pp = 256, FRONTIER["n_paths"]
    gbm_step = a * (draw + 3) + a * (a + 1) / 2
    score = w_cnt * (a + 6)
    out["multi_dd"] = ((gbm_step + score) * n * pp, 4 * (a * a + a + w_cnt * a) + 8 * w_cnt * pp,
                       f"{draw:.2f} per draw + 3 per asset-step + {a * (a + 1) / 2:.0f} "
                       f"correlate FMAs: {gbm_step:.2f} per path-step + {score} for {w_cnt} "
                       f"candidates")
    # one candidate at 131,072 x 252 (the path-risk engine's W = 1), plain and
    # hedged (the bench hedge, 2 legs: hedged_bounds's settlement)
    settle = a * (7 * 2 + 1 + 8)
    for key, step in (("multi_dd W=1", gbm_step), ("multi_dd_hedged W=1", gbm_step + settle)):
        out[key] = ((step + a + 6) * n * pp, 4 * (a * a + 2 * a) + 8 * pp,
                    f"{step:.2f} per path-step + {a + 6} for 1 candidate, {pp} x {n}")
    # the former yardstick, once: multi_dd_kernel's SASS score loop (inside the
    # Philox-call loop, two float4 loads per asset), per scoring thread and step
    loops = _sass_loops(libs["multi_dd"], "multi_dd_kernelILi0ELi0ELi0EE")
    *_, call_loop = _hot_loop(loops, PHILOX_MULS, 4 * 20)
    ins, its, _ = _hot_loop(loops, ("LDS.128",), 2, within=call_loop)
    old = ins * (a // its) * n * w_cnt * (pp // 16)
    print(f"phase8 bound multi_dd, the former yardstick: score loop {ins} instructions / "
          f"{its} asset(s) of multi_dd_kernel, {old:.4e} instructions = "
          f"{old / rate * 1e3:.3f} ms")
    res = {}
    for name, (instr, nbytes, how) in out.items():
        t_ops, t_bytes = instr / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        res[name] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
        print(f"phase8 bound {name}: {how}; {instr:.4e} instructions at {rate:.4e}/s = "
              f"{t_ops:.3f} ms, {nbytes} bytes at 3.35 TB/s = {t_bytes:.3f} ms")
    res.update(family_bounds(draw, rate, draw_t=draws["kernel #1 t"]))
    res.update(family2_bounds(draw, rate))
    # beside #9's bound, which charges kernel #1's draw twice: what a strict
    # draw (kPolyStrict, the Heston kernels') costs in the SASS
    print("phase14 bound heston_terminal, for information, instructions per draw: "
          + ", ".join(f"{k} {v:.2f}" for k, v in draws.items()))
    res.update(dcc_bounds(draw, rate, w1_steps=N_STEPS))
    res.update(hedged_bounds(draw, rate))
    # phase 21's variants, keyed as it keys their times: the widened kernels at
    # A = 64 (52 steps; terminal 262,144 paths, DCC 65,536; candidates 256 x
    # 16,384, DCC 256 x 4,096), the bootstrap on the long history, and the
    # 17-64-asset layouts at 15 assets (the same work as the narrow kernels)
    a64 = dict(a=64, n=DCC_STEPS, p=262_144, pp=16_384, tag="phase21 A=64")
    variants = {**family_bounds(draw, rate, names=("garch_terminal", "garch_multi_dd"), **a64),
                **family2_bounds(draw, rate, names=("heston_terminal", "heston_multi_dd"),
                                 **a64),
                **dcc_bounds(draw, rate, **dict(a64, p=65_536, pp=4_096))}
    res.update({f"{name} A=64": b for name, b in variants.items()})
    long = family_bounds(draw, rate, rows=LONG_HISTORY, tag=f"phase21 {LONG_HISTORY}-row",
                         names=("bootstrap_terminal", "bootstrap_multi_dd"))
    res.update({f"{name} {LONG_HISTORY} rows": b for name, b in long.items()})
    for name in ("garch_terminal", "garch_multi_dd", "heston_terminal", "heston_multi_dd"):
        res[f"{name} A=15 17-64 layout"] = res[name]
    res["draw"] = draw   # kernel #1's instructions per draw, for the later tables
    return res


def phase_path_timing(dev) -> dict:
    """Kernels #2 and #3 timed with CUDA events beside their plain forms (and,
    for #3, the score product alone as one torch.matmul per step)."""
    from mcport_torch.ops.multi_dd import gbm_multi_portfolio_dd
    from mcport_torch.ops.path_stats import gbm_path_stats

    mean_np, chol_np = bench_universe()
    mean = torch.as_tensor(mean_np, device=dev)
    chol = torch.as_tensor(chol_np, device=dev)
    w = torch.as_tensor(bench_weights(), dtype=torch.float32, device=dev)
    res = {}

    def kernel2(rebalance=False):
        gbm_path_stats(0, mean, chol, w, LAW_PATHS, N_STEPS, rebalance=rebalance,
                       terminal=False)

    def plain2():
        _plain_path_stats(0, mean, chol, w, LAW_PATHS, N_STEPS)

    kernel2()
    torch.cuda.synchronize()
    p1, k1, k2 = _time_ms(plain2, 1), _time_ms(kernel2, 10), _time_ms(kernel2, 10)
    ms, plain_ms = (k1 + k2) / 2, p1
    work = LAW_PATHS * N_STEPS
    reb = _time_ms(lambda: kernel2(True), 10)
    print(f"phase8 timing path_stats {LAW_PATHS} x {N_STEPS} x {N_ASSETS} buy-hold: kernel "
          f"{k1:.3f} / {k2:.3f} ms ({work / ms * 1e3:.4e} path-steps/s), plain {p1:.1f} "
          f"ms ({work / plain_ms * 1e3:.4e} path-steps/s); rebalanced kernel "
          f"{reb:.3f} ms")
    res["path_stats"] = (ms, plain_ms, None)

    n_cand, pp = 256, FRONTIER["n_paths"]
    cand = torch.as_tensor(np.random.default_rng(0).dirichlet(np.ones(N_ASSETS), n_cand),
                           dtype=torch.float32, device=dev)
    work = n_cand * pp * N_STEPS
    def plain3():
        _plain_multi_dd(0, mean, chol, cand, pp, N_STEPS)

    for sd in ("float32", "tensorfloat32", "bfloat16"):
        def kernel3(sd=sd):
            gbm_multi_portfolio_dd(0, mean, chol, cand, pp, N_STEPS, score_dtype=sd)

        kernel3()
        torch.cuda.synchronize()
        k1, k2 = _time_ms(kernel3, 5), _time_ms(kernel3, 5)
        ms = (k1 + k2) / 2
        line = (f"phase8 timing multi_dd {n_cand} x {pp} x {N_STEPS} score={sd}: kernel "
                f"{k1:.3f} / {k2:.3f} ms ({work / ms * 1e3:.4e} cand-path-steps/s)")
        if sd == "float32":  # the plain form (float32), its first call, after the kernel's
            p1 = _time_ms(plain3, 1)
            line += f", plain {p1:.1f} ms"
            res["multi_dd"] = (ms, p1)
        print(line)
    # the library yardstick: the score product alone, one (W, A) x (A, P)
    # torch.matmul per step
    e = torch.rand((N_ASSETS, pp), device=dev)
    mm = _time_ms(lambda: torch.matmul(cand, e), 50)
    print(f"phase8 timing torch.matmul ({n_cand}, {N_ASSETS}) x ({N_ASSETS}, {pp}): {mm:.4f} "
          f"ms per step, x {N_STEPS} steps = {mm * N_STEPS:.3f} ms")
    res["multi_dd"] = (*res["multi_dd"], mm * N_STEPS)
    # one candidate (the path-risk engine's W = 1) at 131,072 x 252, plain and
    # hedged (the bench hedge); their bounds are printed with the others'
    from mcport_torch.ops.hedged import HedgeTensors

    one = torch.as_tensor(bench_weights()[None], dtype=torch.float32, device=dev)
    spots = np.full(N_ASSETS, SPOT)
    legs = HedgeTensors.from_spec(bench_hedge(spots)[1], spots, dev)
    for key, hedge in (("multi_dd W=1", None), ("multi_dd_hedged W=1", legs)):
        def kernel1(hedge=hedge):
            gbm_multi_portfolio_dd(0, mean, chol, one, pp, N_STEPS, hedge=hedge)

        kernel1()
        torch.cuda.synchronize()
        k1, k2 = _time_ms(kernel1, 10), _time_ms(kernel1, 10)
        res[key] = ((k1 + k2) / 2, None, None)
        print(f"phase8 timing {key} {pp} x {N_STEPS} x {N_ASSETS}: kernel {k1:.3f} / {k2:.3f} "
              f"ms ({pp * N_STEPS / res[key][0] * 1e3:.4e} path-steps/s)")
    return res


# ---- the family tier: kernels #4-#7 (CCC-GARCH and the block bootstrap) -----------

FAMILY_SEED = 3
FAMILY_PATHS = 1 << 20              # garch-risk and bootstrap-risk: 1,048,576 x 252
SLICE = 4_096                       # paths of each block the plain forms re-run
# paths per plain-form call where the references re-run a whole main-path
# result (a frontier optimum over its 131,072 paths; the default cell's
# drawdown quantiles, times its 16 blocks): the plain forms' time goes by
# calls and steps, hardly by paths, so few large calls
REF_CHUNK, REF_BLOCK_CHUNK = 65_536, 4_096
CLI_PATHS = 131_072                 # path-risk on the fixtures
CLI_FRONTIER = (4_096, 16_384)      # dd-frontier on the fixtures: candidates, paths
FAMILY_KERNELS = ("garch_terminal", "garch_multi_dd", "bootstrap_terminal",
                  "bootstrap_multi_dd")


def bench_garch(a: int = N_ASSETS):
    """bench.py:190-200: the bench universe's means, omega 0.1 x 4e-4, alpha
    0.08, beta 0.9, correlation 0.5, sigma2_0 = eps2_0 = 4e-4."""
    from mcport_torch.convert import garch_params_from_numpy

    mean, _ = bench_universe(a)
    s0 = np.full(a, 4e-4)
    return garch_params_from_numpy(mean.astype(np.float64), 0.1 * s0, np.full(a, 0.08),
                                   np.full(a, 0.9),
                                   np.linalg.cholesky(0.5 * np.eye(a) + 0.5), s0, s0)


def bench_history(a: int = N_ASSETS) -> np.ndarray:
    """bench.py:286: 365 rows of N(1e-3, 0.02) per-period returns (seed 3)."""
    return np.random.default_rng(3).normal(1e-3, 0.02, (365, a)).astype(np.float32)


def _family_kernels():
    from mcport_torch.ops.bootstrap import bootstrap_multi_portfolio_dd, bootstrap_terminal
    from mcport_torch.ops.garch import garch_multi_portfolio_dd, garch_terminal

    return dict(zip(FAMILY_KERNELS, (garch_terminal, garch_multi_portfolio_dd,
                                     bootstrap_terminal, bootstrap_multi_portfolio_dd)))


def _slices(n_paths: int, m: int | None = None) -> list[int]:
    """First paths of the slices the plain forms re-run, ``m`` paths each
    (``SLICE``): the head of each block. The plain forms' time goes by their
    steps and calls (a torch op per step), hardly by their paths: one slice
    per launch, not a head and a tail."""
    return [0]


def family_launches(dev) -> list[dict]:
    """Every distinct launch of kernels #4-#7 that phase 10 makes through the
    API (the CLI's run on the fixtures is checked by its counts): garch-risk
    and bootstrap-risk, both path-risk cells of each family, path_tail_risk
    and bootstrap_tail_risk (parameters estimated from ``bench_prices``), and
    every 256-candidate chunk of both frontiers. ``src`` is the launch's
    GARCH parameters or history, on ``dev``."""
    from mcport_torch.config import GBMConfig
    from mcport_torch.engine.drawdown_frontier import frontier_seeds
    from mcport_torch.models.garch_mc import estimate_ccc_garch
    from mcport_torch.ops.dirichlet import sample_weights

    w, eq = bench_weights()[None], np.full((1, N_ASSETS), 1.0 / N_ASSETS)
    garch, hist = bench_garch().tensors(dev), torch.as_tensor(bench_history(), device=dev)
    rets = bench_prices().port_rets
    src = {"garch_terminal": garch, "garch_multi_dd": garch, "bootstrap_terminal": hist,
           "bootstrap_multi_dd": hist}
    out = [dict(kernel="garch_terminal", what="garch_risk", seed=FAMILY_SEED,
                n=FAMILY_PATHS, t_df=None),
           dict(kernel="garch_terminal", what="garch_risk t(5.5)", seed=FAMILY_SEED,
                n=FAMILY_PATHS, t_df=5.5),
           dict(kernel="bootstrap_terminal", what="bootstrap_risk", seed=FAMILY_SEED,
                n=FAMILY_PATHS),
           dict(kernel="bootstrap_terminal", what="bootstrap_tail_risk", seed=GBMConfig().seed,
                n=GBMConfig().n_paths,
                src=torch.as_tensor(rets, dtype=torch.float32, device=dev))]
    for name, g in cells().items():
        for kernel in ("garch_multi_dd", "bootstrap_multi_dd"):
            out.append(dict(kernel=kernel, what=f"path risk {name}", seed=g.seed,
                            n=g.path_block, w=w, first_block=0,
                            n_blocks=g.n_paths // g.path_block))
    g = GBMConfig()
    tail = dict(seed=g.seed, n=g.path_block, w=eq, first_block=0,
                n_blocks=g.n_paths // g.path_block)
    out.append(dict(kernel="garch_multi_dd", what="path_tail_risk garch",
                    src=estimate_ccc_garch(rets).tensors(dev), **tail))
    out.append(dict(kernel="bootstrap_multi_dd", what="path_tail_risk bootstrap",
                    src=torch.as_tensor(rets, dtype=torch.float32, device=dev), **tail))
    path_seed, weight_seed = frontier_seeds(FRONTIER_SEED)
    gen = torch.Generator(device=dev).manual_seed(weight_seed)
    cand, _ = sample_weights(gen, FRONTIER["n_candidates"], np.zeros(N_ASSETS),
                             np.ones(N_ASSETS))
    for kernel in ("garch_multi_dd", "bootstrap_multi_dd"):   # its 16 launches of 256
        out.append(dict(kernel=kernel, what="frontier, 16 chunks", seed=path_seed,
                        n=FRONTIER["n_paths"], w=cand))
    for launch in out:
        launch.setdefault("src", src[launch["kernel"]])
    return out


def phase_family_kernels(dev) -> dict:
    """Kernels #4-#7 against their plain forms: test shapes, then every launch
    of phase 10 over a head slice of each block's paths. The
    bootstrap's selection is held bit for bit."""
    from mcport_torch.ops.bootstrap import (bootstrap_multi_dd_reference, bootstrap_shares,
                                            bootstrap_terminal_reference)
    from mcport_torch.ops.garch import (garch_multi_dd_reference, garch_shares,
                                        garch_terminal_reference)

    k = _family_kernels()
    worst = dict.fromkeys(FAMILY_KERNELS, 0.0)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def held(name, what, kern, plain, shares):
        pairs = zip(kern, plain) if isinstance(kern, tuple) else [(kern, plain)]
        err = max(float((a - b).abs().max()) for a, b in pairs if a.numel())
        print(f"phase9 {name} {what} max_abs={err:.3e} shares="
              + " ".join(f"{n}={v:.3f}" for n, v in shares.items()))
        check(max(shares.values()) <= 1.0, f"{name} kernel vs plain, {what}")
        worst[name] = max(worst[name], err)

    def same(name, what, kern, plain):
        pairs = list(zip(kern, plain)) if isinstance(kern, tuple) else [(kern, plain)]
        ok = all(torch.equal(a, b) for a, b in pairs)
        err = max(float((a - b).abs().max()) for a, b in pairs if a.numel())
        print(f"phase9 {name} {what} bit-identical={ok} max_abs={err:.3e}")
        check(ok, f"{name} kernel is its plain form bit for bit, {what}")
        worst[name] = max(worst[name], err)

    # test shapes: widths, tiers, step counts, candidate counts, ragged paths over two blocks
    kw = dict(first_block=6, n_blocks=2)
    for a in (1, 15, 16):
        g = bench_garch(a).tensors(dev)
        for t_df in (None, 5.5):
            for steps in (N_STEPS, 7):
                kk = k["garch_terminal"](11, g, KERNEL_PATHS, steps, t_df=t_df, **kw)
                p = garch_terminal_reference(11, g, KERNEL_PATHS, steps, t_df=t_df, **kw)
                held("garch_terminal", f"A={a} t_df={t_df} steps={steps} "
                     f"paths={KERNEL_PATHS}x2", kk, p, garch_shares(kk, p, g, steps, t_df))
    g = bench_garch().tensors(dev)
    hist = t(bench_history())
    # 7 steps here: phase 12 holds every layout at 52 steps, and the launches
    # of phase 10 below run 252
    for n_cand in (1, 13, 256):
        cand = t(np.random.default_rng(n_cand).dirichlet(np.ones(N_ASSETS), n_cand))
        for steps in (7,):
            kk = k["garch_multi_dd"](11, g, cand, MDD_PATHS, steps, **kw)
            p = garch_multi_dd_reference(11, g, cand, MDD_PATHS, steps, with_bound=True, **kw)
            held("garch_multi_dd", f"W={n_cand} A={N_ASSETS} steps={steps} "
                 f"paths={MDD_PATHS}x2", kk, p[:2], garch_shares(kk, p, g, steps))
            kk = k["bootstrap_multi_dd"](11, hist, cand, MDD_PATHS, steps, 0.2, **kw)
            p = bootstrap_multi_dd_reference(11, hist, cand, MDD_PATHS, steps, 0.2, **kw)
            held("bootstrap_multi_dd", f"W={n_cand} A={N_ASSETS} T=365 steps={steps} "
                 f"paths={MDD_PATHS}x2", kk, p, bootstrap_shares(kk, p, hist, cand, steps))
    for a in (1, 15, 64):
        h = t(bench_history(a))
        for p_restart in (0.2, 0.0, 1.0):
            for steps in (N_STEPS, 7):
                same("bootstrap_terminal", f"A={a} T=365 p_restart={p_restart} "
                     f"steps={steps} paths={KERNEL_PATHS}x2",
                     k["bootstrap_terminal"](11, h, KERNEL_PATHS, steps, p_restart, **kw),
                     bootstrap_terminal_reference(11, h, KERNEL_PATHS, steps, p_restart, **kw))
    # selection: one-hot candidates score one asset's rows exactly, so #7 is
    # its plain form and #6 bit for bit
    eye = torch.eye(N_ASSETS, device=dev)
    t7 = k["bootstrap_multi_dd"](11, hist, eye, KERNEL_PATHS, N_STEPS, 0.2, **kw)
    same("bootstrap_multi_dd", f"one-hot W={N_ASSETS} paths={KERNEL_PATHS}x2 (selection)",
         t7, bootstrap_multi_dd_reference(11, hist, eye, KERNEL_PATHS, N_STEPS, 0.2, **kw))
    same("bootstrap_multi_dd", "one-hot terminal against kernel #6", t7[0],
         k["bootstrap_terminal"](11, hist, KERNEL_PATHS, N_STEPS, 0.2, **kw).transpose(1, 2))

    # every launch of phase 10, over a head slice of each block
    for launch in family_launches(dev):
        name, n, src, seed = launch["kernel"], launch["n"], launch["src"], launch["seed"]
        blocks = dict(first_block=launch.get("first_block", -1),
                      n_blocks=launch.get("n_blocks", 1))
        if name == "garch_terminal":
            kk = k[name](seed, src, n, N_STEPS, t_df=launch["t_df"], **blocks)
        elif name == "bootstrap_terminal":
            kk = k[name](seed, src, n, N_STEPS, 0.2, **blocks)
        else:
            w = torch.as_tensor(launch["w"], dtype=torch.float32, device=dev)
            kk = k[name](seed, src, w, n, N_STEPS, **blocks)
        for p0 in _slices(n):
            m = min(SLICE, n)
            sl = slice(p0, p0 + m)
            what = (f"{launch['what']} blocks={blocks['first_block'] + 1}.."
                    f"{blocks['first_block'] + blocks['n_blocks']} paths {p0}..{p0 + m - 1}")
            if name == "garch_terminal":
                p = garch_terminal_reference(seed, src, m, N_STEPS, first_path=p0,
                                             t_df=launch["t_df"], **blocks)
                held(name, what, kk[:, sl], p, garch_shares(kk[:, sl], p, src, N_STEPS,
                                                            launch["t_df"]))
            elif name == "bootstrap_terminal":
                same(name, what, kk[:, sl], bootstrap_terminal_reference(
                    seed, src, m, N_STEPS, 0.2, first_path=p0, **blocks))
            elif name == "garch_multi_dd":
                p = garch_multi_dd_reference(seed, src, w, m, N_STEPS, first_path=p0,
                                             with_bound=True, **blocks)
                part = (kk[0][..., sl], kk[1][..., sl])
                held(name, what, part, p[:2], garch_shares(part, p, src, N_STEPS))
            else:
                p = bootstrap_multi_dd_reference(seed, src, w, m, N_STEPS, 0.2, first_path=p0,
                                                 **blocks)
                part = (kk[0][..., sl], kk[1][..., sl])
                held(name, what, part, p, bootstrap_shares(part, p, src, w, N_STEPS))
        del kk
    return worst


def _fixture_cli(dev) -> dict:
    """The four family commands of the CLI on the weekly BTC/ETH fixtures, as
    a user runs them; each command's JSON."""
    import contextlib
    import io

    from mcport_torch.cli import main as cli

    csvs = sorted(str(p) for p in (Path(__file__).resolve().parent / "fixtures").glob(
        "*7 Years Weekly.csv"))
    check(len(csvs) == 2, "the weekly BTC/ETH fixtures are in the checkout")
    common = [*csvs, "--period", "W", "--steps", str(N_STEPS), "--device", str(dev)]
    runs = {"garch-risk": ["garch-risk", "--paths", str(FAMILY_PATHS)],
            "bootstrap-risk": ["bootstrap-risk", "--paths", str(FAMILY_PATHS)],
            "path-risk": ["path-risk", "--models", "garch,bootstrap", "--paths",
                          str(CLI_PATHS)]}
    for model in ("garch", "bootstrap"):
        runs[f"dd-frontier {model}"] = ["dd-frontier", "--model", model, "--candidates",
                                        str(CLI_FRONTIER[0]), "--paths", str(CLI_FRONTIER[1]),
                                        "--dd-budget", "1.0"]
    out = {}
    for name, argv in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(argv[:1] + common + argv[1:])
        out[name] = json.loads(buf.getvalue())
    return out


def phase_family_tier(dev) -> dict:
    """The family tier's main paths at full width: garch_risk (normal and
    t(5.5)) and bootstrap_risk at 1,048,576 x 252, run_garch_path_risk and
    run_bootstrap_path_risk at both cells with split + resume, path_tail_risk
    for both families and bootstrap_tail_risk, both family frontiers at the
    bench's size, and the four CLI commands on the fixtures; counts reset
    before and read after."""
    from mcport_torch.api import bootstrap_tail_risk, path_tail_risk
    from mcport_torch.config import Config
    from mcport_torch.engine.drawdown_frontier import family_drawdown_frontier_search
    from mcport_torch.engine.path_risk import (run_bootstrap_path_risk, run_garch_path_risk,
                                               run_resumable_path_risk)
    from mcport_torch.models.bootstrap import bootstrap_risk
    from mcport_torch.models.garch_mc import garch_risk

    params, hist, w = bench_garch(), bench_history(), bench_weights()
    warm_reps = 2
    k = _family_kernels()

    def timed(fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def walls(fn, *a, reps=warm_reps, **kw):
        out, first = timed(fn, *a, **kw)
        return out, (first, [timed(fn, *a, **kw)[1] for _ in range(reps)])

    for fn in k.values():
        fn.launches = 0
    risk, wall = {}, {}
    for label, t_df in (("garch_risk", None), ("garch_risk t(5.5)", 5.5)):
        risk[label], wall[label] = walls(garch_risk, FAMILY_SEED, params, w,
                                         n_paths=FAMILY_PATHS, n_steps=N_STEPS, t_df=t_df,
                                         device=dev)
    risk["bootstrap_risk"], wall["bootstrap_risk"] = walls(
        bootstrap_risk, FAMILY_SEED, hist, w, n_paths=FAMILY_PATHS, n_steps=N_STEPS,
        device=dev)
    reports, resumes = {}, {}
    for name, g in cells().items():
        for model, run, src in (("garch", run_garch_path_risk, params),
                                ("bootstrap", run_bootstrap_path_risk, hist)):
            reports[model, name], wall[model, name] = walls(run, src, w, g, device=dev)
            n_blocks = g.n_paths // g.path_block
            full, ck_full = run_resumable_path_risk(model, src, w, g, device=dev)
            _, part = run_resumable_path_risk(model, src, w, g, max_blocks=n_blocks // 3,
                                              device=dev)
            resumed, ck = run_resumable_path_risk(model, src, w, g, checkpoint=part,
                                                  device=dev)
            resumes[model, name] = (full, ck_full, part, resumed, ck)
    prices = bench_prices()
    tail = {m: timed(path_tail_risk, prices, None, Config(), model=m, device=dev)
            for m in ("garch", "bootstrap")}
    boot_tail, boot_tail_wall = timed(bootstrap_tail_risk, prices, None, Config(), device=dev)
    # each family frontier's budget: the bench portfolio's drawdown quantile in
    # the default cell, plus 0.01 — it binds, and leaves a feasible set
    frontier, budget = {}, {}
    for model, src in (("garch", params), ("bootstrap", hist)):
        budget[model] = round(-reports[model, "default"].dd_p95 + 0.01, 4)
        kw = dict(FRONTIER, dd_budget=budget[model])
        frontier[model], wall["frontier", model] = walls(
            family_drawdown_frontier_search, FRONTIER_SEED, model, src, reps=1, device=dev,
            **kw)
    cli = _fixture_cli(dev)
    launches = {name: fn.launches for name, fn in k.items()}
    chunks = FRONTIER["n_candidates"] // 256
    cli_chunks = -(-CLI_FRONTIER[0] // 256)
    per_model = (2 * (1 + warm_reps) + 2 * 3 + 1 + 2 * chunks + 1 + cli_chunks)
    want = {"garch_terminal": 2 * (1 + warm_reps) + 1, "bootstrap_terminal": 1 + warm_reps + 2,
            "garch_multi_dd": per_model, "bootstrap_multi_dd": per_model}
    print(f"phase10 family tier: launches {launches} (expected {want})")
    check(launches == want, "the family tier went through kernels #4-#7")

    for label, r in risk.items():
        first, warm = wall[label]
        print(f"phase10 {label} {FAMILY_PATHS} x {N_STEPS}: wall first={first:.4f} s warm="
              f"{' / '.join(f'{x:.4f}' for x in warm)} s var={r.var:.6f} cvar={r.cvar:.6f} "
              f"port_mean={r.port_mean:.6f}")
        check(all(math.isfinite(x) for x in (r.var, r.cvar, r.port_mean))
              and r.cvar <= r.var < r.port_mean, f"{label}: finite and ordered")
    for (model, name), r in reports.items():
        first, warm = wall[model, name]
        ok = (all(math.isfinite(getattr(r, f)) for f in
                  ("var", "cvar", "port_mean", "dd_mean", "dd_p95", "dd_median"))
              and r.cvar <= r.var and -1.0 <= r.dd_p95 <= r.dd_median <= 0.0
              and r.n_paths == cells()[name].n_paths)
        print(f"phase10 run_{model}_path_risk {name}: paths={r.n_paths} wall first="
              f"{first:.4f} s warm={' / '.join(f'{x:.4f}' for x in warm)} s var={r.var:.6f} "
              f"cvar={r.cvar:.6f} dd_mean={r.dd_mean:.6f} dd_median={r.dd_median:.6f} "
              f"dd_p95={r.dd_p95:.6f} sane={ok}")
        check(ok, f"{model} path risk {name}: finite and ordered")
        full, ck_full, part, resumed, ck = resumes[model, name]
        same = (_reports_equal(full, resumed) and ck.done and not part.done
                and all(np.array_equal(getattr(ck, f), getattr(ck_full, f))
                        for f in ("h_port", "h_dd", "s_port", "s_dd"))
                and _reports_equal(full, r))
        print(f"phase10 {model} {name}: split at block {part.next_block} + resume "
              f"bit-identical to the one-shot run={same}")
        check(same, f"{model} {name}: path-risk resume equivalence")
    for model, (out, t_wall) in tail.items():
        print(f"phase10 path_tail_risk {model}: wall {t_wall:.4f} s {json.dumps(out)}")
        check(out["n_paths"] == Config().gbm.n_paths and out["cvar"] <= out["var"]
              and -1.0 <= out["dd_p95"] <= 0.0, f"path_tail_risk {model}")
    print(f"phase10 bootstrap_tail_risk {Config().gbm.n_paths} x {Config().gbm.n_steps}: "
          f"wall {boot_tail_wall:.4f} s var={boot_tail.var:.6f} cvar={boot_tail.cvar:.6f} "
          f"port_mean={boot_tail.port_mean:.6f}")
    check(int(boot_tail.hist.sum()) == Config().gbm.n_paths and boot_tail.cvar <= boot_tail.var,
          "bootstrap_tail_risk")
    for model, r in frontier.items():
        first, warm = wall["frontier", model]
        i = r.opt_idx
        print(f"phase10 frontier {model}: {FRONTIER['n_candidates']} x {FRONTIER['n_paths']} "
              f"x {N_STEPS} budget {budget[model]} wall first={first:.4f} s warm="
              f"{warm[0]:.4f} s feasible={int(r.feasible.sum())} opt={i} "
              f"ret={float(r.ret[i]):.6f} dd_p95={float(r.dd_p95[i]):.6f}")
        check(0 < int(r.feasible.sum()) < FRONTIER["n_candidates"]
              and float(r.dd_p95[i]) >= -budget[model],
              f"{model} frontier: the budget binds and an optimum is feasible")
    for name, out in cli.items():
        print(f"phase10 cli {name}: {json.dumps(out)}")
    for name in ("garch-risk", "bootstrap-risk"):
        check(cli[name]["cvar"] <= cli[name]["var"], f"cli {name}")
    check(all(cli["path-risk"][m]["n_paths"] == CLI_PATHS for m in ("garch", "bootstrap"))
          and all("weights" in cli[f"dd-frontier {m}"] for m in ("garch", "bootstrap")),
          "cli path-risk and dd-frontier")
    _family_references(dev, params, hist, w, risk, reports, frontier)
    return launches


def _family_references(dev, params, hist, w, risk, reports, frontier) -> None:
    """What phase 10 produced, against references: the GARCH terminal law
    (E[1 + mu + eps] = 1 + mu every step, so each asset's mean terminal return
    is (1 + mu)^n - 1), the iid bootstrap's analytic mean, the card against
    the CPU at a small size, the drawdown quantiles against the plain forms
    over the same paths, and each frontier's optimum against its plain form."""
    from mcport_torch.engine.drawdown_frontier import frontier_seeds
    from mcport_torch.engine.path_risk import DD_SKETCH
    from mcport_torch.models.bootstrap import bootstrap_risk
    from mcport_torch.models.garch_mc import garch_risk
    from mcport_torch.ops.bootstrap import bootstrap_multi_dd_reference, bootstrap_terminal
    from mcport_torch.ops.garch import garch_multi_dd_reference, garch_terminal

    g = params.tensors(dev)
    term = garch_terminal(FAMILY_SEED, g, FAMILY_PATHS, N_STEPS)[0].double()
    want = (1.0 + params.mu.numpy()) ** N_STEPS - 1.0
    z = np.abs(term.mean(0).cpu().numpy() - want) / (term.std(0).cpu().numpy()
                                                     / math.sqrt(FAMILY_PATHS))
    print(f"phase10 garch law {FAMILY_PATHS} x {N_STEPS}: max |mean - ((1+mu)^n - 1)|/se="
          f"{z.max():.2f}")
    check(z.max() < 5.0, "GARCH terminal means are (1 + mu)^n - 1")
    h = torch.as_tensor(hist, device=dev)
    iid = bootstrap_terminal(FAMILY_SEED, h, FAMILY_PATHS, 16, 1.0)[0].double()
    want = (1.0 + hist.astype(np.float64).mean(0)) ** 16 - 1.0
    z = np.abs(iid.mean(0).cpu().numpy() - want) / (iid.std(0).cpu().numpy()
                                                    / math.sqrt(FAMILY_PATHS))
    print(f"phase10 bootstrap iid law {FAMILY_PATHS} x 16: max |mean - ((1+r)^n - 1)|/se="
          f"{z.max():.2f}")
    check(z.max() < 5.0, "iid bootstrap means are (1 + mean row)^n - 1")

    # the card against the CPU run (plain forms, same counters) at 16,384 x 16
    for label, fn, src in (("garch_risk", garch_risk, params),
                           ("bootstrap_risk", bootstrap_risk, hist)):
        card = fn(FAMILY_SEED, src, w, 16_384, 16, device=dev)
        cpu = fn(FAMILY_SEED, src, w, 16_384, 16, device="cpu")
        d = max(abs(card.var - cpu.var), abs(card.cvar - cpu.cvar))
        print(f"phase10 {label} card vs cpu (16,384 x 16): max |d var|, |d cvar| = {d:.3e} "
              f"(bound 1e-4: a few sketch bins)")
        check(d <= 1e-4, f"{label}: card agrees with the CPU run")

    # drawdown quantiles of the default cell against the plain forms over the same paths
    cfg = cells()["default"]
    nb = cfg.n_paths // cfg.path_block
    wt = torch.as_tensor(w, dtype=torch.float32, device=dev)[None]
    dd_width = (DD_SKETCH.hi - DD_SKETCH.lo) / DD_SKETCH.n_bins
    for model, plain in (("garch", lambda p0, m: garch_multi_dd_reference(
            cfg.seed, g, wt, m, N_STEPS, first_block=0, n_blocks=nb, first_path=p0)),
                         ("bootstrap", lambda p0, m: bootstrap_multi_dd_reference(
            cfg.seed, h, wt, m, N_STEPS, 0.2, first_block=0, n_blocks=nb, first_path=p0))):
        dd = torch.cat([plain(p0, min(REF_BLOCK_CHUNK, cfg.path_block - p0))[1]
                        for p0 in range(0, cfg.path_block, REF_BLOCK_CHUNK)], dim=-1).reshape(-1)
        r = reports[model, "default"]
        q = float(torch.kthvalue(dd, math.ceil(0.05 * dd.numel())).values)
        med = float(torch.median(dd))
        print(f"phase10 {model} default dd vs plain form over the same paths: p95 "
              f"{r.dd_p95:.6f} vs {q:.6f}, median {r.dd_median:.6f} vs {med:.6f}, mean "
              f"{r.dd_mean:.6f} vs {float(dd.double().mean()):.6f} (bound {2 * dd_width:.2e})")
        check(abs(r.dd_p95 - q) <= 2 * dd_width and abs(r.dd_median - med) <= 2 * dd_width
              and abs(r.dd_mean - float(dd.double().mean())) <= 1e-5,
              f"{model} drawdown quantiles agree with the plain form")

    # each frontier's optimum against its plain form on the same paths
    path_seed = frontier_seeds(FRONTIER_SEED)[0]
    k_tail = math.ceil(0.05 * FRONTIER["n_paths"])
    for model, r in frontier.items():
        opt = torch.as_tensor(r.weights[r.opt_idx][None], device=dev)
        n = FRONTIER["n_paths"]
        parts = [(garch_multi_dd_reference(path_seed, g, opt, min(REF_CHUNK, n - p0), N_STEPS,
                                           first_path=p0)
                  if model == "garch" else
                  bootstrap_multi_dd_reference(path_seed, h, opt, min(REF_CHUNK, n - p0), N_STEPS,
                                               0.2, first_path=p0))
                 for p0 in range(0, n, REF_CHUNK)]
        term = torch.cat([p[0] for p in parts], dim=-1)[0, 0]
        dd = torch.cat([p[1] for p in parts], dim=-1)[0, 0]
        ret, q = float(term.mean()), float(torch.kthvalue(dd, k_tail).values)
        d_ret, d_dd = abs(float(r.ret[r.opt_idx]) - ret), abs(float(r.dd_p95[r.opt_idx]) - q)
        print(f"phase10 frontier {model} optimum vs plain form: ret "
              f"{float(r.ret[r.opt_idx]):.7f} vs {ret:.7f}, dd_p95 "
              f"{float(r.dd_p95[r.opt_idx]):.7f} vs {q:.7f} (bound 1e-4)")
        check(d_ret <= 1e-4 and d_dd <= 1e-4, f"{model} frontier optimum agrees with the plain "
              "form")


PHILOX_CALL = 60      # 10 rounds of 2 IMAD.WIDE.U32, 2 LOP3 and 2 IADD (key schedule)


def family_bounds(draw: float, rate: float, *, a: int = N_ASSETS, n: int = N_STEPS,
                  p: int = FAMILY_PATHS, pp: int = FRONTIER["n_paths"], rows: int = 365,
                  names=None, tag: str = "phase11", w_cnt: int = 256,
                  draw_t: float | None = None) -> dict:
    """Least time of kernels #4-#7 at their timing shapes (or at ``a``
    assets, ``n`` steps, ``p`` terminal and ``pp`` candidate paths, a
    ``rows``-row history; only ``names`` if given), from the work each
    function needs: the larger of its instructions over the issue rate and
    its bytes over HBM bandwidth. ``draw`` is kernel #1's measured
    instructions per normal draw (its pair loop per Philox call / 4);
    ``w_cnt`` candidates. ``draw_t``, kernel #1's per Student-t draw (its t
    tier's loop per Philox call / 2), adds #4's t(5.5) tier, counted as the
    normal one."""
    tri = a * (a + 1) / 2
    garch_step = a * (draw + 7) + tri          # draw, (A+1)/2 FMAs, sqrt + 6 per asset
    score = w_cnt * (a + 6)                    # W·A FMAs, 1 + f, V·, peak, dd
    boot_step = PHILOX_CALL / 2 + 8            # half a Philox call and the row index
    work = {
        "garch_terminal": (garch_step * n * p, 4 * (a * a + 6 * a) + 4 * a * p,
                           f"{draw:.2f} per draw + 7 per asset-step (sqrt, update) + "
                           f"{tri:.0f} correlate FMAs: {garch_step:.2f} per path-step"),
        "garch_multi_dd": ((garch_step + score) * n * pp,
                           4 * (a * a + 6 * a + w_cnt * a) + 8 * w_cnt * pp,
                           f"{garch_step:.2f} per path-step + {score} for {w_cnt} candidates "
                           f"(A + 6 each)"),
        "bootstrap_terminal": ((boot_step + 2 * a) * n * p, 4 * rows * a + 4 * a * p,
                               f"{boot_step:.0f} per path-step (half a {PHILOX_CALL}-"
                               f"instruction Philox call, 8 for the row) + 2 per asset-step"),
        "bootstrap_multi_dd": ((boot_step + a + score) * n * pp,
                               4 * (rows * a + w_cnt * a) + 8 * w_cnt * pp,
                               f"{boot_step + a:.0f} per path-step (selection and the "
                               f"row's loads) + {score} for {w_cnt} candidates"),
    }
    if draw_t is not None:
        step_t = a * (draw_t + 7) + tri
        work["garch_terminal t(5.5)"] = (step_t * n * p, work["garch_terminal"][1],
                                         f"{draw_t:.2f} per Student-t draw + 7 per asset-step "
                                         f"+ {tri:.0f} correlate FMAs: {step_t:.2f} per "
                                         f"path-step")
    return _bound_table(work, rate, tag, names)


def _bound_table(work: dict, rate: float, tag: str, names=None) -> dict:
    """``{name: (bound ms, "operations" or "bytes")}`` from ``{name:
    (instructions, bytes, how)}``, each printed under ``tag``."""
    res = {}
    for name, (instr, nbytes, how) in work.items():
        if names is not None and name not in names:
            continue
        t_ops, t_bytes = instr / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        res[name] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
        print(f"{tag} bound {name}: {how}; {instr:.4e} instructions at {rate:.4e}/s = "
              f"{t_ops:.3f} ms, {nbytes} bytes at 3.35 TB/s = {t_bytes:.3f} ms")
    return res


def phase_family_timing(dev) -> dict:
    """Kernels #4-#7 timed with CUDA events at the main paths' shapes beside
    their plain forms (in 131,072- and 8,192-path pieces) and, where one
    exists, one PyTorch call: index_select of one step's rows for #6 and the
    score product torch.matmul for #5 and #7, each times the step count."""
    from mcport_torch.ops.bootstrap import (bootstrap_multi_dd_reference,
                                            bootstrap_terminal_reference)
    from mcport_torch.ops.garch import garch_multi_dd_reference, garch_terminal_reference

    k = _family_kernels()
    g = bench_garch().tensors(dev)
    hist = torch.as_tensor(bench_history(), device=dev)
    cand = torch.as_tensor(np.random.default_rng(0).dirichlet(np.ones(N_ASSETS), 256),
                           dtype=torch.float32, device=dev)
    pp = FRONTIER["n_paths"]

    def chunked(fn, n, piece):
        return lambda: [fn(p0, min(piece, n - p0)) for p0 in range(0, n, piece)]

    runs = {
        "garch_terminal": (lambda: k["garch_terminal"](0, g, FAMILY_PATHS, N_STEPS),
                           chunked(lambda p0, m: garch_terminal_reference(
                               0, g, m, N_STEPS, first_path=p0), FAMILY_PATHS, PLAIN_CHUNK),
                           FAMILY_PATHS * N_STEPS, 10),
        "garch_multi_dd": (lambda: k["garch_multi_dd"](0, g, cand, pp, N_STEPS),
                           chunked(lambda p0, m: garch_multi_dd_reference(
                               0, g, cand, m, N_STEPS, first_path=p0), pp, MDD_PLAIN_CHUNK),
                           256 * pp * N_STEPS, 5),
        "bootstrap_terminal": (lambda: k["bootstrap_terminal"](0, hist, FAMILY_PATHS, N_STEPS),
                               chunked(lambda p0, m: bootstrap_terminal_reference(
                                   0, hist, m, N_STEPS, first_path=p0), FAMILY_PATHS,
                                   PLAIN_CHUNK),
                               FAMILY_PATHS * N_STEPS, 10),
        "bootstrap_multi_dd": (lambda: k["bootstrap_multi_dd"](0, hist, cand, pp, N_STEPS),
                               chunked(lambda p0, m: bootstrap_multi_dd_reference(
                                   0, hist, cand, m, N_STEPS, first_path=p0), pp,
                                   MDD_PLAIN_CHUNK),
                               256 * pp * N_STEPS, 5),
    }
    res = {}
    for name, (kern, plain, work, reps) in runs.items():
        kern()
        torch.cuda.synchronize()
        # the plain form once, its first call (a warm-up would double the
        # phase's time): a yardstick of arithmetic
        p1, k1, k2 = _time_ms(plain, 1), _time_ms(kern, reps), _time_ms(kern, reps)
        ms, plain_ms = (k1 + k2) / 2, p1
        unit = "cand-path-steps/s" if "multi" in name else "path-steps/s"
        print(f"phase11 timing {name}: kernel {k1:.3f} / {k2:.3f} ms ({work / ms * 1e3:.4e} "
              f"{unit}), plain {p1:.1f} ms")
        res[name] = [ms, plain_ms, None]
    idx = torch.randint(0, hist.shape[0], (FAMILY_PATHS,), device=dev)
    sel = _time_ms(lambda: torch.index_select(hist, 0, idx), 50)
    e = torch.rand((N_ASSETS, pp), device=dev)
    mm = _time_ms(lambda: torch.matmul(cand, e), 50)
    print(f"phase11 timing index_select of {FAMILY_PATHS} rows of (365, {N_ASSETS}): {sel:.4f} "
          f"ms per step, x {N_STEPS} = {sel * N_STEPS:.3f} ms; torch.matmul (256, {N_ASSETS}) "
          f"x ({N_ASSETS}, {pp}): {mm:.4f} ms per step, x {N_STEPS} = {mm * N_STEPS:.3f} ms")
    res["bootstrap_terminal"][2] = sel * N_STEPS
    res["garch_multi_dd"][2] = res["bootstrap_multi_dd"][2] = mm * N_STEPS
    return res


# ---- the Merton and Heston families: kernels #8-#10 -------------------------------

FAMILY2_KERNELS = ("merton_multi_dd", "heston_terminal", "heston_multi_dd")
FELLER_XI = 0.05                    # a vol-of-vol where 2 kappa theta < xi^2: truncation binds
CRASH_PATHS = 1 << 20               # paths per block of the unmissable-jumps check


def bench_merton(a: int = N_ASSETS):
    """bench.py:326-332: the bench universe plus jump rate 0.02 per step, jump
    mean -0.08 and jump vol 0.04 per asset."""
    from mcport_torch.convert import merton_params_from_numpy

    mean, chol = bench_universe(a)
    return merton_params_from_numpy(np.ones(a), mean.astype(np.float64),
                                    chol.astype(np.float64), 0.02, np.full(a, -0.08),
                                    np.full(a, 0.04))


def bench_heston(a: int = N_ASSETS, xi: float = 3e-3):
    """bench.py:358-363: the bench universe's means, kappa 0.15, theta 4e-4, xi
    3e-3 (or ``xi``), rho -0.5, v0 4e-4, shock correlation 0.5."""
    from mcport_torch.convert import heston_params_from_numpy

    mean, _ = bench_universe(a)
    full = np.ones(a)
    return heston_params_from_numpy(mean.astype(np.float64), 0.15 * full, 4e-4 * full,
                                    xi * full, -0.5 * full, 4e-4 * full,
                                    np.linalg.cholesky(0.5 * np.eye(a) + 0.5), 100.0 * full)


def layout_switches(plan) -> tuple[int, ...]:
    """W = 1, each side of every layout switch of a candidate kernel's plan
    up to 16 assets (``ops.jump.merton_narrow_plan``,
    ``ops.heston.heston_narrow_plan``, ...) at the bench's 15 assets,
    unhedged and hedged (two legs per asset), and 256."""
    out = {1, 256}
    for legs in (0, 2):
        names = [plan(N_ASSETS, w, n_legs=legs).layout for w in range(1, 257)]
        for w in range(1, 256):
            if names[w] != names[w - 1]:
                out |= {w, w + 1}
    return tuple(sorted(out))


def _family2_kernels():
    from mcport_torch.ops.heston import heston_multi_portfolio_dd, heston_terminal
    from mcport_torch.ops.jump import merton_multi_portfolio_dd

    return dict(zip(FAMILY2_KERNELS, (merton_multi_portfolio_dd, heston_terminal,
                                      heston_multi_portfolio_dd)))


def _merton_tensors(p, dev):
    d = p.diffusion
    return tuple(torch.as_tensor(x).to(dev, torch.float32)
                 for x in (d.mean_step, d.chol_step, p.jump_mean, p.jump_vol))


_FITTED = {}


def fitted_families():
    """The jump and Heston parameters ``path_tail_risk`` estimates from
    ``bench_prices`` (computed once), and the Heston QMLE's host seconds."""
    if not _FITTED:
        from mcport_torch.models.heston import estimate_heston
        from mcport_torch.models.jump import estimate_merton_common

        prices = bench_prices().prices
        _FITTED["jump"] = estimate_merton_common(prices)
        t0 = time.perf_counter()
        _FITTED["heston"] = estimate_heston(prices)
        _FITTED["heston_fit_s"] = time.perf_counter() - t0
    return _FITTED


def family2_launches(dev) -> list[dict]:
    """Every distinct launch of kernels #8-#10 that phase 13 makes through the
    API (the CLI's run on the fixtures is checked by its counts):
    ``heston_terminal_returns`` at 1,048,576 x 252, both path-risk cells of
    each family, ``path_tail_risk`` for both (parameters estimated from
    ``bench_prices``), and every 256-candidate chunk of both frontiers.
    ``src`` is the launch's parameters on ``dev``."""
    from mcport_torch.config import GBMConfig
    from mcport_torch.engine.drawdown_frontier import frontier_seeds
    from mcport_torch.ops.dirichlet import sample_weights

    w, eq = bench_weights()[None], np.full((1, N_ASSETS), 1.0 / N_ASSETS)
    src = {"merton_multi_dd": bench_merton(), "heston_terminal": bench_heston(),
           "heston_multi_dd": bench_heston()}
    out = [dict(kernel="heston_terminal", what="heston_terminal_returns", seed=FAMILY_SEED,
                n=FAMILY_PATHS)]
    for name, g in cells().items():
        for kernel in ("merton_multi_dd", "heston_multi_dd"):
            out.append(dict(kernel=kernel, what=f"path risk {name}", seed=g.seed,
                            n=g.path_block, w=w, first_block=0,
                            n_blocks=g.n_paths // g.path_block))
    g = GBMConfig()
    fit = fitted_families()
    for kernel, model in (("merton_multi_dd", "jump"), ("heston_multi_dd", "heston")):
        out.append(dict(kernel=kernel, what=f"path_tail_risk {model}", seed=g.seed,
                        n=g.path_block, w=eq, first_block=0,
                        n_blocks=g.n_paths // g.path_block, src=fit[model]))
    path_seed, weight_seed = frontier_seeds(FRONTIER_SEED)
    gen = torch.Generator(device=dev).manual_seed(weight_seed)
    cand, _ = sample_weights(gen, FRONTIER["n_candidates"], np.zeros(N_ASSETS),
                             np.ones(N_ASSETS))
    # the Heston frontier's 16 launches of 256 in one call; the Merton plain
    # form holds every (path, step, candidate) at once, so it goes chunk by chunk
    out.append(dict(kernel="heston_multi_dd", what="frontier, 16 chunks", seed=path_seed,
                    n=FRONTIER["n_paths"], w=cand))
    for i in range(0, FRONTIER["n_candidates"], 256):
        out.append(dict(kernel="merton_multi_dd", what=f"frontier chunk {i // 256}",
                        seed=path_seed, n=FRONTIER["n_paths"], w=cand[i:i + 256]))
    for launch in out:
        launch.setdefault("src", src[launch["kernel"]])
    return out


def phase_family2_kernels(dev) -> dict:
    """Kernels #8-#10 against their plain forms: test shapes (Heston at the
    bench's xi and a Feller-violating one, and the 2,053-path case whose
    cuBLAS score order left the former Heston bound), #8's jump steps and
    its rate-0 identity with kernel #3, the candidate kernels up to 16
    assets (#8, #10, #5, #7) hedged and unhedged on each side of every
    layout switch, then every launch of phase 13 over a head slice of each
    block's paths."""
    from mcport_torch.ops.bootstrap import (bootstrap_multi_dd_reference, bootstrap_narrow_plan,
                                            bootstrap_shares)
    from mcport_torch.ops.garch import garch_multi_dd_reference, garch_narrow_plan, garch_shares
    from mcport_torch.ops.heston import (heston_multi_dd_reference, heston_narrow_plan,
                                         heston_shares, heston_terminal_reference,
                                         heston_tolerance)
    from mcport_torch.ops.jump import (merton_multi_dd_reference, merton_narrow_plan,
                                       merton_shares)
    from mcport_torch.ops.multi_dd import gbm_multi_portfolio_dd

    k = _family2_kernels()
    fk = _family_kernels()
    switches = {"merton_multi_dd": layout_switches(merton_narrow_plan),
                "heston_multi_dd": layout_switches(heston_narrow_plan),
                "garch_multi_dd": layout_switches(garch_narrow_plan),
                "bootstrap_multi_dd": layout_switches(bootstrap_narrow_plan)}
    worst = dict.fromkeys(FAMILY2_KERNELS + ("garch_multi_dd", "bootstrap_multi_dd",
                                             "garch_multi_dd_hedged",
                                             "bootstrap_multi_dd_hedged"), 0.0)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def held(name, what, kern, plain, shares):
        pairs = zip(kern, plain) if isinstance(kern, tuple) else [(kern, plain)]
        err = max(float((a - b).abs().max()) for a, b in pairs if a.numel())
        print(f"phase12 {name} {what} max_abs={err:.3e} shares="
              + " ".join(f"{n}={v:.3f}" for n, v in shares.items()))
        check(max(shares.values()) <= 1.0, f"{name} kernel vs plain, {what}")
        worst[name] = max(worst[name], err)

    kw = dict(first_block=6, n_blocks=2)
    for a, steps in ((15, N_STEPS), (15, 7), (1, 9), (64, 8)):
        mean, chol = (t(x) for x in bench_universe(a))
        muj, sigj = t(np.full(a, -0.08)), t(np.full(a, 0.04))
        for n_cand in switches["merton_multi_dd"]:
            cand = t(np.random.default_rng(n_cand).dirichlet(np.ones(a), n_cand))
            for rate in (0.02, 0.3):
                kk = k["merton_multi_dd"](11, mean, chol, rate, muj, sigj, cand, MDD_PATHS,
                                          steps, **kw)
                p = merton_multi_dd_reference(11, mean, chol, rate, muj, sigj, cand, MDD_PATHS,
                                              steps, **kw)
                held("merton_multi_dd", f"W={n_cand} A={a} steps={steps} rate={rate} "
                     f"paths={MDD_PATHS}x2", kk, p, merton_shares(kk, p, chol, mean, sigj, steps))
    # unmissable jumps: sigma_J = 0, mu_J = -0.5, one step; a jumped path's
    # drawdown is below -0.2, so the jump steps show in the output
    mean, chol = (t(x) for x in bench_universe())
    eq = torch.full((1, N_ASSETS), 1.0 / N_ASSETS, device=dev)
    zero, crash = t(np.zeros(N_ASSETS)), t(np.full(N_ASSETS, -0.5))
    _, dk = k["merton_multi_dd"](5, mean, chol, 0.3, crash, zero, eq, CRASH_PATHS, 1,
                                 first_block=0, n_blocks=2)
    _, dp = merton_multi_dd_reference(5, mean, chol, 0.3, crash, zero, eq, CRASH_PATHS, 1,
                                      first_block=0, n_blocks=2)
    jumped = dp < -0.2
    same = torch.equal(dk < -0.2, jumped)
    print(f"phase12 merton_multi_dd unmissable jumps (rate 0.3, mu_J -0.5, sigma_J 0, 1 step, "
          f"{CRASH_PATHS} x 2 paths): jumped share {float(jumped.float().mean()):.4f}, the "
          f"kernel's jumped paths are the plain form's={same}")
    check(same, "kernel #8 jumps on the plain form's steps")
    # rate 0: no step jumps, and the kernel keeps kernel #3's step code
    muj, sigj = t(np.full(N_ASSETS, -0.08)), t(np.full(N_ASSETS, 0.04))
    for n_cand in (1, 256):
        cand = t(np.random.default_rng(n_cand).dirichlet(np.ones(N_ASSETS), n_cand))
        grp = dict(first_block=0, n_blocks=2)
        k8 = k["merton_multi_dd"](3, mean, chol, 0.0, muj, sigj, cand, 8_192, N_STEPS, **grp)
        k3 = gbm_multi_portfolio_dd(3, mean, chol, cand, 8_192, N_STEPS, rebalance=True, **grp)
        ident = torch.equal(k8[0], k3[0]) and torch.equal(k8[1], k3[1])
        print(f"phase12 merton_multi_dd rate 0 W={n_cand} 8,192 x 2 x {N_STEPS}: bit-identical "
              f"to kernel #3 rebalanced={ident} max|d|="
              f"{float((k8[0] - k3[0]).abs().max()):.3e}/{float((k8[1] - k3[1]).abs().max()):.3e}")
        check(ident, "kernel #8 at rate 0 is kernel #3's rebalanced output")

    # each layout up to 16 assets hedged: two legs per asset of every type, on
    # each side of every layout switch and at 256, 52 steps; path by path
    # within the price bounds (#8's and #10's unhedged layouts are the test
    # shapes above; #5's and #7's below)
    for a in (15, 16):
        mean, chol = (t(x) for x in bench_universe(a))
        muj, sigj = t(np.full(a, -0.08)), t(np.full(a, 0.04))
        h = bench_heston(a, FELLER_XI).tensors(dev)
        for name, widths in switches.items():
            if name in ("garch_multi_dd", "bootstrap_multi_dd"):
                continue
            for n_cand in widths:
                cand = t(np.random.default_rng(n_cand).dirichlet(np.ones(a), n_cand))
                hedge = leg_mix(a, 2, dev, seed=n_cand)
                what = f"hedged L=2 W={n_cand} A={a} steps=52 paths={MDD_PATHS}x2"
                if name == "merton_multi_dd":
                    kk = k[name](11, mean, chol, 0.3, muj, sigj, cand, MDD_PATHS, 52, hedge=hedge,
                                 **kw)
                    p = merton_multi_dd_reference(11, mean, chol, 0.3, muj, sigj, cand, MDD_PATHS,
                                                  52, hedge=hedge, with_bound=True, **kw)
                    held(name, what + " rate=0.3", kk, p[:2],
                         merton_shares(kk, p, chol, mean, sigj, 52, hedge))
                else:
                    kk = k[name](11, h, cand, MDD_PATHS, 52, hedge=hedge, **kw)
                    p = heston_multi_dd_reference(11, h, cand, MDD_PATHS, 52, hedge=hedge,
                                                  with_bound=True, **kw)
                    held(name, what + f" xi={FELLER_XI}", kk, p[:2],
                         heston_shares(kk, p, h, 52, hedge=hedge))

    # #5 and #7 up to 16 assets on each side of every layout switch and at 256,
    # 52 steps, unhedged and hedged (two legs per asset of every type), #7 over
    # the bench's history (shared memory) and a LONG_HISTORY-row one (device
    # memory): within garch_shares and bootstrap_shares, hedged path by path
    long_hist = np.random.default_rng(8).normal(1e-3, 0.02, (LONG_HISTORY, 16))
    for a in (15, 16):
        g = bench_garch(a).tensors(dev)
        hists = {"T=365": t(bench_history(a)), f"T={LONG_HISTORY}": t(long_hist[:, :a])}
        for hedge in (None, leg_mix(a, 2, dev, seed=a)):
            tag = "hedged L=2 " if hedge is not None else ""
            bound = dict(with_bound=True) if hedge is not None else {}
            for n_cand in switches["garch_multi_dd"]:
                cand = t(np.random.default_rng(n_cand).dirichlet(np.ones(a), n_cand))
                name = "garch_multi_dd" + ("_hedged" if hedge is not None else "")
                kk = fk["garch_multi_dd"](11, g, cand, MDD_PATHS, 52, hedge=hedge, **kw)
                p = garch_multi_dd_reference(11, g, cand, MDD_PATHS, 52, hedge=hedge,
                                             with_bound=True, **kw)
                held(name, f"{tag}W={n_cand} A={a} steps=52 paths={MDD_PATHS}x2", kk, p[:2],
                     garch_shares(kk, p, g, 52, hedge=hedge))
            for n_cand in switches["bootstrap_multi_dd"]:
                cand = t(np.random.default_rng(n_cand).dirichlet(np.ones(a), n_cand))
                name = "bootstrap_multi_dd" + ("_hedged" if hedge is not None else "")
                for hname, hist in hists.items():
                    kk = fk["bootstrap_multi_dd"](11, hist, cand, MDD_PATHS, 52, 0.2, hedge=hedge,
                                                  **kw)
                    p = bootstrap_multi_dd_reference(11, hist, cand, MDD_PATHS, 52, 0.2,
                                                     hedge=hedge, **bound, **kw)
                    held(name, f"{tag}W={n_cand} A={a} {hname} steps=52 paths={MDD_PATHS}x2",
                         kk, p[:2], bootstrap_shares(kk, p, hist, cand, 52, hedge=hedge))

    # the case whose score order left the former Heston bound (it counted the
    # score's roundings once): cuBLAS sums this size's r @ w.T in another order
    h = bench_heston(N_ASSETS, FELLER_XI).tensors(dev)
    cand = t(np.random.default_rng(12).dirichlet(np.ones(N_ASSETS), 12))
    kk = k["heston_multi_dd"](11, h, cand, 2_053, N_STEPS, **kw)
    p = heston_multi_dd_reference(11, h, cand, 2_053, N_STEPS, **kw)
    shares = heston_shares(kk, p, h, N_STEPS)
    rel = heston_tolerance(N_ASSETS, N_STEPS)[1]
    former = 8.0 * 2.0 ** -24 * (N_ASSETS + 2.0 * math.sqrt(N_STEPS))
    print(f"phase12 heston_multi_dd score order, W=12 A={N_ASSETS} xi={FELLER_XI} "
          f"steps={N_STEPS} paths=2053x2: share {max(shares.values()):.4f} of the bound "
          f"(rel {rel:.4e}), {max(shares.values()) * rel / former:.4f} of the former one "
          f"(rel {former:.4e})")
    held("heston_multi_dd", f"W=12 A={N_ASSETS} xi={FELLER_XI} steps={N_STEPS} paths=2053x2",
         kk, p, shares)

    for xi in (3e-3, FELLER_XI):
        for a in (1, 15, 16):
            h = bench_heston(a, xi).tensors(dev)
            for steps in (N_STEPS, 7):
                kk = k["heston_terminal"](11, h, KERNEL_PATHS, steps, **kw)
                p = heston_terminal_reference(11, h, KERNEL_PATHS, steps, **kw)
                held("heston_terminal", f"A={a} xi={xi} steps={steps} paths={KERNEL_PATHS}x2",
                     kk, p, heston_shares(kk, p, h, steps))
        for a, steps in ((15, N_STEPS), (15, 7), (1, 9), (16, 8)):
            h = bench_heston(a, xi).tensors(dev)
            for n_cand in switches["heston_multi_dd"]:
                cand = t(np.random.default_rng(n_cand).dirichlet(np.ones(a), n_cand))
                kk = k["heston_multi_dd"](11, h, cand, MDD_PATHS, steps, **kw)
                p = heston_multi_dd_reference(11, h, cand, MDD_PATHS, steps, **kw)
                held("heston_multi_dd", f"W={n_cand} A={a} xi={xi} steps={steps} "
                     f"paths={MDD_PATHS}x2", kk, p, heston_shares(kk, p, h, steps))

    # every launch of phase 13, over a head slice of each block
    for launch in family2_launches(dev):
        name, n, src, seed = launch["kernel"], launch["n"], launch["src"], launch["seed"]
        blocks = dict(first_block=launch.get("first_block", -1),
                      n_blocks=launch.get("n_blocks", 1))
        if name == "merton_multi_dd":
            mean, chol, muj, sigj = _merton_tensors(src, dev)
            rate = src.jump_rate
            w = torch.as_tensor(launch["w"], dtype=torch.float32, device=dev)
            kk = k[name](seed, mean, chol, rate, muj, sigj, w, n, N_STEPS, **blocks)
        else:
            h = src.tensors(dev)
            if name == "heston_terminal":
                kk = k[name](seed, h, n, N_STEPS, **blocks)
            else:
                w = torch.as_tensor(launch["w"], dtype=torch.float32, device=dev)
                kk = k[name](seed, h, w, n, N_STEPS, **blocks)
        for p0 in _slices(n):
            m = min(SLICE, n)
            sl = slice(p0, p0 + m)
            what = (f"{launch['what']} blocks={blocks['first_block'] + 1}.."
                    f"{blocks['first_block'] + blocks['n_blocks']} paths {p0}..{p0 + m - 1}")
            if name == "merton_multi_dd":
                p = merton_multi_dd_reference(seed, mean, chol, rate, muj, sigj, w, m, N_STEPS,
                                              first_path=p0, **blocks)
                part = (kk[0][..., sl], kk[1][..., sl])
                held(name, what, part, p, merton_shares(part, p, chol, mean, sigj, N_STEPS))
            elif name == "heston_terminal":
                p = heston_terminal_reference(seed, h, m, N_STEPS, first_path=p0, **blocks)
                held(name, what, kk[:, sl], p, heston_shares(kk[:, sl], p, h, N_STEPS))
            else:
                p = heston_multi_dd_reference(seed, h, w, m, N_STEPS, first_path=p0, **blocks)
                part = (kk[0][..., sl], kk[1][..., sl])
                held(name, what, part, p, heston_shares(part, p, h, N_STEPS))
        del kk
    return worst


def _fixture_cli2(dev) -> dict:
    """The family commands of this slice on the weekly BTC/ETH fixtures, as a
    user runs them; each command's JSON."""
    import contextlib
    import io

    from mcport_torch.cli import main as cli

    csvs = sorted(str(p) for p in (Path(__file__).resolve().parent / "fixtures").glob(
        "*7 Years Weekly.csv"))
    check(len(csvs) == 2, "the weekly BTC/ETH fixtures are in the checkout")
    common = [*csvs, "--period", "W", "--steps", str(N_STEPS), "--device", str(dev)]
    runs = {"jump-risk": ["jump-risk", "--paths", str(FAMILY_PATHS)],
            "path-risk": ["path-risk", "--models", "jump,heston", "--paths", str(CLI_PATHS)]}
    for model in ("jump", "heston"):
        runs[f"dd-frontier {model}"] = ["dd-frontier", "--model", model, "--candidates",
                                        str(CLI_FRONTIER[0]), "--paths", str(CLI_FRONTIER[1]),
                                        "--dd-budget", "1.0"]
    out = {}
    for name, argv in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(argv[:1] + common + argv[1:])
        out[name] = json.loads(buf.getvalue())
    return out


def phase_family2_tier(dev) -> dict:
    """The Merton and Heston main paths at full width: merton_risk and
    heston_terminal_returns at 1,048,576 x 252, run_merton_path_risk and
    run_heston_path_risk at both cells with split + resume, path_tail_risk
    for both (the 15-asset QMLE fit timed), both family frontiers at the
    bench's size, and the CLI's jump-risk, path-risk --models jump,heston
    and dd-frontier --model jump|heston on the fixtures; counts reset before
    and read after."""
    from mcport_torch.api import path_tail_risk
    from mcport_torch.config import Config
    from mcport_torch.engine.drawdown_frontier import family_drawdown_frontier_search
    from mcport_torch.engine.path_risk import (run_heston_path_risk, run_merton_path_risk,
                                               run_resumable_path_risk)
    from mcport_torch.models.heston import heston_terminal_returns
    from mcport_torch.models.jump import merton_risk

    merton, heston, w = bench_merton(), bench_heston(), bench_weights()
    params = {"jump": merton, "heston": heston}
    runs = {"jump": run_merton_path_risk, "heston": run_heston_path_risk}
    warm_reps = 2
    k = _family2_kernels()
    fit = fitted_families()
    print(f"phase13 the Heston QMLE fit of path_tail_risk ({bench_prices().prices.shape[0]} "
          f"prices x {N_ASSETS} assets): {fit['heston_fit_s']:.2f} s on the host")

    def timed(fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def walls(fn, *a, reps=warm_reps, **kw):
        out, first = timed(fn, *a, **kw)
        return out, (first, [timed(fn, *a, **kw)[1] for _ in range(reps)])

    for fn in k.values():
        fn.launches = 0
    risk, wall = {}, {}
    risk["merton_risk"], wall["merton_risk"] = walls(
        merton_risk, FAMILY_SEED, merton, w, n_paths=FAMILY_PATHS, n_steps=N_STEPS, device=dev)
    term, wall["heston_terminal_returns"] = walls(
        heston_terminal_returns, FAMILY_SEED, heston, FAMILY_PATHS, N_STEPS, device=dev)
    reports, resumes = {}, {}
    for name, g in cells().items():
        for model in ("jump", "heston"):
            reports[model, name], wall[model, name] = walls(runs[model], params[model], w, g,
                                                            device=dev)
            n_blocks = g.n_paths // g.path_block
            full, ck_full = run_resumable_path_risk(model, params[model], w, g, device=dev)
            _, part = run_resumable_path_risk(model, params[model], w, g,
                                              max_blocks=n_blocks // 3, device=dev)
            resumed, ck = run_resumable_path_risk(model, params[model], w, g, checkpoint=part,
                                                  device=dev)
            resumes[model, name] = (full, ck_full, part, resumed, ck)
    prices = bench_prices()
    tail = {m: timed(path_tail_risk, prices, None, Config(), model=m, device=dev)
            for m in ("jump", "heston")}
    frontier, budget = {}, {}
    for model in ("jump", "heston"):
        budget[model] = round(-reports[model, "default"].dd_p95 + 0.01, 4)
        kw = dict(FRONTIER, dd_budget=budget[model])
        frontier[model], wall["frontier", model] = walls(
            family_drawdown_frontier_search, FRONTIER_SEED, model, params[model], reps=1,
            device=dev, **kw)
    cli = _fixture_cli2(dev)
    launches = {name: fn.launches for name, fn in k.items()}
    chunks = FRONTIER["n_candidates"] // 256
    cli_chunks = -(-CLI_FRONTIER[0] // 256)
    per_model = 2 * (1 + warm_reps) + 2 * 3 + 1 + 2 * chunks + 1 + cli_chunks
    want = {"merton_multi_dd": per_model, "heston_terminal": 1 + warm_reps,
            "heston_multi_dd": per_model}
    print(f"phase13 Merton and Heston tier: launches {launches} (expected {want})")
    check(launches == want, "the Merton and Heston paths went through kernels #8-#10")

    r = risk["merton_risk"]
    first, warm = wall["merton_risk"]
    print(f"phase13 merton_risk {FAMILY_PATHS} x {N_STEPS}: wall first={first:.4f} s warm="
          f"{' / '.join(f'{x:.4f}' for x in warm)} s var={r.var:.6f} cvar={r.cvar:.6f} "
          f"port_mean={r.port_mean:.6f} jump_frac={r.jump_frac:.6f}")
    check(all(math.isfinite(x) for x in (r.var, r.cvar, r.port_mean))
          and r.cvar <= r.var < r.port_mean and 0.0 < r.jump_frac < 1.0
          and int(r.hist.sum()) == FAMILY_PATHS, "merton_risk: finite and ordered")
    first, warm = wall["heston_terminal_returns"]
    fin = bool(torch.isfinite(term).all())
    print(f"phase13 heston_terminal_returns {FAMILY_PATHS} x {N_STEPS} x {N_ASSETS}: wall first="
          f"{first:.4f} s warm={' / '.join(f'{x:.4f}' for x in warm)} s finite={fin} shape="
          f"{tuple(term.shape)}")
    check(fin and tuple(term.shape) == (FAMILY_PATHS, N_ASSETS), "heston terminal returns")
    for (model, name), r in reports.items():
        first, warm = wall[model, name]
        ok = (all(math.isfinite(getattr(r, f)) for f in
                  ("var", "cvar", "port_mean", "dd_mean", "dd_p95", "dd_median"))
              and r.cvar <= r.var and -1.0 <= r.dd_p95 <= r.dd_median <= 0.0
              and r.n_paths == cells()[name].n_paths)
        print(f"phase13 run_{'merton' if model == 'jump' else model}_path_risk {name}: paths="
              f"{r.n_paths} wall first={first:.4f} s warm={' / '.join(f'{x:.4f}' for x in warm)}"
              f" s var={r.var:.6f} cvar={r.cvar:.6f} dd_mean={r.dd_mean:.6f} dd_median="
              f"{r.dd_median:.6f} dd_p95={r.dd_p95:.6f} sane={ok}")
        check(ok, f"{model} path risk {name}: finite and ordered")
        full, ck_full, part, resumed, ck = resumes[model, name]
        same = (_reports_equal(full, resumed) and ck.done and not part.done
                and all(np.array_equal(getattr(ck, f), getattr(ck_full, f))
                        for f in ("h_port", "h_dd", "s_port", "s_dd"))
                and _reports_equal(full, r))
        print(f"phase13 {model} {name}: split at block {part.next_block} + resume "
              f"bit-identical to the one-shot run={same}")
        check(same, f"{model} {name}: path-risk resume equivalence")
    for model, (out, t_wall) in tail.items():
        print(f"phase13 path_tail_risk {model}: wall {t_wall:.4f} s {json.dumps(out)}")
        check(out["n_paths"] == Config().gbm.n_paths and out["cvar"] <= out["var"]
              and -1.0 <= out["dd_p95"] <= 0.0, f"path_tail_risk {model}")
    for model, r in frontier.items():
        first, warm = wall["frontier", model]
        i = r.opt_idx
        print(f"phase13 frontier {model}: {FRONTIER['n_candidates']} x {FRONTIER['n_paths']} "
              f"x {N_STEPS} budget {budget[model]} wall first={first:.4f} s warm="
              f"{warm[0]:.4f} s feasible={int(r.feasible.sum())} opt={i} "
              f"ret={float(r.ret[i]):.6f} dd_p95={float(r.dd_p95[i]):.6f}")
        check(0 < int(r.feasible.sum()) < FRONTIER["n_candidates"]
              and float(r.dd_p95[i]) >= -budget[model],
              f"{model} frontier: the budget binds and an optimum is feasible")
    for name, out in cli.items():
        print(f"phase13 cli {name}: {json.dumps(out)}")
    check(cli["jump-risk"]["cvar"] <= cli["jump-risk"]["var"], "cli jump-risk")
    check(all(cli["path-risk"][m]["n_paths"] == CLI_PATHS for m in ("jump", "heston"))
          and all("weights" in cli[f"dd-frontier {m}"] for m in ("jump", "heston")),
          "cli path-risk and dd-frontier")
    _family2_references(dev, merton, heston, w, reports, frontier)
    return launches


def _family2_references(dev, merton, heston, w, reports, frontier) -> None:
    """What phase 13 produced, against references: the Merton terminal law
    (mean log return n m + lambda n muJ, exactly), the Heston terminal law at
    the bench's parameters (v0 = theta: mean log return n (mu - theta/2)),
    the card against the CPU at 16,384 x 16, the drawdown quantiles against
    the plain forms over the same paths, and each frontier's optimum against
    its plain form."""
    from mcport_torch.engine.drawdown_frontier import frontier_seeds
    from mcport_torch.engine.path_risk import DD_SKETCH
    from mcport_torch.models.heston import heston_terminal_returns
    from mcport_torch.models.jump import merton_risk, merton_terminal_returns
    from mcport_torch.ops.heston import heston_multi_dd_reference, heston_shares
    from mcport_torch.ops.jump import merton_multi_dd_reference

    d = merton.diffusion
    lam = merton.jump_rate
    x = merton_terminal_returns(FAMILY_SEED, d.mean_step, d.chol_step, lam, merton.jump_mean,
                                merton.jump_vol, FAMILY_PATHS, N_STEPS, device=dev).double()
    want = N_STEPS * (d.mean_step.numpy() + lam * merton.jump_mean.numpy())
    z = np.abs(x.mean(0).cpu().numpy() - want) / (x.std(0).cpu().numpy()
                                                  / math.sqrt(FAMILY_PATHS))
    print(f"phase13 merton law {FAMILY_PATHS} x {N_STEPS}: max |mean - n (m + lambda muJ)|/se="
          f"{z.max():.2f}")
    check(z.max() < 5.0, "Merton terminal means are n (m + lambda muJ)")
    x = torch.log1p(heston_terminal_returns(FAMILY_SEED, heston, FAMILY_PATHS, N_STEPS,
                                            device=dev).double())
    want = N_STEPS * (heston.mu.numpy() - heston.theta.numpy() / 2)
    z = np.abs(x.mean(0).cpu().numpy() - want) / (x.std(0).cpu().numpy()
                                                  / math.sqrt(FAMILY_PATHS))
    print(f"phase13 heston law {FAMILY_PATHS} x {N_STEPS}: max |mean - n (mu - theta/2)|/se="
          f"{z.max():.2f}")
    check(z.max() < 5.0, "Heston terminal means are n (mu - theta/2)")

    card = merton_risk(FAMILY_SEED, merton, w, 16_384, 16, device=dev)
    cpu = merton_risk(FAMILY_SEED, merton, w, 16_384, 16, device="cpu")
    dv = max(abs(card.var - cpu.var), abs(card.cvar - cpu.cvar))
    print(f"phase13 merton_risk card vs cpu (16,384 x 16): max |d var|, |d cvar| = {dv:.3e} "
          f"(bound 1e-4: a few sketch bins), jump_frac {card.jump_frac} vs {cpu.jump_frac}")
    check(dv <= 1e-4 and card.jump_frac == cpu.jump_frac, "merton_risk: card agrees with CPU")
    h_card = heston_terminal_returns(FAMILY_SEED, heston, 16_384, 16, device=dev)
    h_cpu = heston_terminal_returns(FAMILY_SEED, heston, 16_384, 16, device="cpu")
    sh = heston_shares(h_card.cpu(), h_cpu, heston.tensors("cpu"), 16)
    print(f"phase13 heston_terminal_returns card vs cpu (16,384 x 16): share {sh['term']:.3f}")
    check(sh["term"] <= 1.0, "heston_terminal_returns: card agrees with CPU")

    cfg = cells()["default"]
    nb = cfg.n_paths // cfg.path_block
    wt = torch.as_tensor(w, dtype=torch.float32, device=dev)[None]
    mt = _merton_tensors(merton, dev)
    h = heston.tensors(dev)
    dd_width = (DD_SKETCH.hi - DD_SKETCH.lo) / DD_SKETCH.n_bins
    plain = {"jump": lambda seed, w_, m, **kw: merton_multi_dd_reference(
                 seed, mt[0], mt[1], merton.jump_rate, mt[2], mt[3], w_, m, N_STEPS, **kw),
             "heston": lambda seed, w_, m, **kw: heston_multi_dd_reference(
                 seed, h, w_, m, N_STEPS, **kw)}
    for model in ("jump", "heston"):
        dd = torch.cat([plain[model](cfg.seed, wt, min(REF_BLOCK_CHUNK, cfg.path_block - p0),
                                     first_block=0, n_blocks=nb, first_path=p0)[1]
                        for p0 in range(0, cfg.path_block, REF_BLOCK_CHUNK)], dim=-1).reshape(-1)
        r = reports[model, "default"]
        q = float(torch.kthvalue(dd, math.ceil(0.05 * dd.numel())).values)
        med = float(torch.median(dd))
        print(f"phase13 {model} default dd vs plain form over the same paths: p95 "
              f"{r.dd_p95:.6f} vs {q:.6f}, median {r.dd_median:.6f} vs {med:.6f}, mean "
              f"{r.dd_mean:.6f} vs {float(dd.double().mean()):.6f} (bound {2 * dd_width:.2e})")
        check(abs(r.dd_p95 - q) <= 2 * dd_width and abs(r.dd_median - med) <= 2 * dd_width
              and abs(r.dd_mean - float(dd.double().mean())) <= 1e-5,
              f"{model} drawdown quantiles agree with the plain form")
    path_seed = frontier_seeds(FRONTIER_SEED)[0]
    k_tail = math.ceil(0.05 * FRONTIER["n_paths"])
    for model, r in frontier.items():
        opt = torch.as_tensor(r.weights[r.opt_idx][None], device=dev)
        n = FRONTIER["n_paths"]
        parts = [plain[model](path_seed, opt, min(REF_CHUNK, n - p0), first_path=p0)
                 for p0 in range(0, n, REF_CHUNK)]
        term = torch.cat([p[0] for p in parts], dim=-1)[0, 0]
        dd = torch.cat([p[1] for p in parts], dim=-1)[0, 0]
        ret, q = float(term.mean()), float(torch.kthvalue(dd, k_tail).values)
        d_ret, d_dd = abs(float(r.ret[r.opt_idx]) - ret), abs(float(r.dd_p95[r.opt_idx]) - q)
        print(f"phase13 frontier {model} optimum vs plain form: ret "
              f"{float(r.ret[r.opt_idx]):.7f} vs {ret:.7f}, dd_p95 "
              f"{float(r.dd_p95[r.opt_idx]):.7f} vs {q:.7f} (bound 1e-4)")
        check(d_ret <= 1e-4 and d_dd <= 1e-4, f"{model} frontier optimum agrees with the plain "
              "form")


BOX_MULLER_PAIR = 79.5   # kernel #1's draw: 54.75 = a quarter of a Philox call + half a pair


def family2_bounds(draw: float, rate: float, *, a: int = N_ASSETS, n: int = N_STEPS,
                   p: int = FAMILY_PATHS, pp: int = FRONTIER["n_paths"], names=None,
                   tag: str = "phase14", w_cnt: int = 256) -> dict:
    """Least time of kernels #8-#10 at their timing shapes (or at the shape
    given, only ``names`` if given), from the work each function needs: the
    larger of its instructions over the issue rate and its bytes over HBM
    bandwidth. ``draw`` is kernel #1's measured instructions per normal draw
    (its pair loop per Philox call / 4); ``w_cnt`` candidates."""
    tri = a * (a + 1) / 2
    score = w_cnt * (a + 6)                    # W·A FMAs, V·f, peak, dd
    lam = 0.02
    merton_step = a * (draw + 3) + tri + PHILOX_CALL / 2 + BOX_MULLER_PAIR / 2 + lam * a
    heston_step = a * (2 * draw + 12) + tri    # two draws, the update, the correlate
    work = {
        "merton_multi_dd": ((merton_step + score) * n * pp,
                            4 * (a * a + 3 * a + w_cnt * a) + 8 * w_cnt * pp,
                            f"{draw:.2f} per draw + 3 per asset-step (m, exp) + {tri:.0f} "
                            f"correlate FMAs + half a Philox call and half a Box-Muller pair "
                            f"+ {lam} x A jump adds: {merton_step:.2f} per path-step + {score} "
                            f"for {w_cnt} candidates"),
        "heston_terminal": (heston_step * n * p, 4 * (a * a + 7 * a) + 4 * a * p,
                            f"2 x {draw:.2f} per asset-step (two draws) + 12 for the update + "
                            f"{tri:.0f} correlate FMAs: {heston_step:.2f} per path-step"),
        "heston_multi_dd": ((heston_step + 2 * a + score) * n * pp,
                            4 * (a * a + 7 * a + w_cnt * a) + 8 * w_cnt * pp,
                            f"{heston_step:.2f} per path-step + 2 per asset-step (exp) + "
                            f"{score} for {w_cnt} candidates"),
    }
    return _bound_table(work, rate, tag, names)


W1_TIMES = {}   # phase 14: kernels #5, #7, #8 and #10 at W = 1, ms


def phase_family2_timing(dev) -> dict:
    """Kernels #8-#10 timed with CUDA events at the main paths' shapes beside
    their plain forms (in 131,072- and 8,192-path pieces) and, for #8 and
    #10, the score product alone as one torch.matmul per step; and kernel
    #4's t(5.5) tier alone."""
    from mcport_torch.ops.garch import garch_terminal
    from mcport_torch.ops.heston import heston_multi_dd_reference, heston_terminal_reference
    from mcport_torch.ops.jump import merton_multi_dd_reference

    k = _family2_kernels()
    mean, chol, muj, sigj = _merton_tensors(bench_merton(), dev)
    h = bench_heston().tensors(dev)
    cand = torch.as_tensor(np.random.default_rng(0).dirichlet(np.ones(N_ASSETS), 256),
                           dtype=torch.float32, device=dev)
    pp = FRONTIER["n_paths"]

    def chunked(fn, n, piece):
        return lambda: [fn(p0, min(piece, n - p0)) for p0 in range(0, n, piece)]

    runs = {
        "merton_multi_dd": (lambda: k["merton_multi_dd"](0, mean, chol, 0.02, muj, sigj, cand,
                                                         pp, N_STEPS),
                            chunked(lambda p0, m: merton_multi_dd_reference(
                                0, mean, chol, 0.02, muj, sigj, cand, m, N_STEPS,
                                first_path=p0), pp, MDD_PLAIN_CHUNK),
                            256 * pp * N_STEPS, 5),
        "heston_terminal": (lambda: k["heston_terminal"](0, h, FAMILY_PATHS, N_STEPS),
                            chunked(lambda p0, m: heston_terminal_reference(
                                0, h, m, N_STEPS, first_path=p0), FAMILY_PATHS, PLAIN_CHUNK),
                            FAMILY_PATHS * N_STEPS, 10),
        "heston_multi_dd": (lambda: k["heston_multi_dd"](0, h, cand, pp, N_STEPS),
                            chunked(lambda p0, m: heston_multi_dd_reference(
                                0, h, cand, m, N_STEPS, first_path=p0), pp, MDD_PLAIN_CHUNK),
                            256 * pp * N_STEPS, 5),
    }
    res = {}
    for name, (kern, plain, work, reps) in runs.items():
        kern()
        torch.cuda.synchronize()
        # the plain form once, its first call (a warm-up would double the
        # phase's time): a yardstick of arithmetic
        p1, k1, k2 = _time_ms(plain, 1), _time_ms(kern, reps), _time_ms(kern, reps)
        ms, plain_ms = (k1 + k2) / 2, p1
        unit = "cand-path-steps/s" if "multi" in name else "path-steps/s"
        print(f"phase14 timing {name}: kernel {k1:.3f} / {k2:.3f} ms ({work / ms * 1e3:.4e} "
              f"{unit}), plain {p1:.1f} ms")
        res[name] = [ms, plain_ms, None]
    e = torch.rand((N_ASSETS, pp), device=dev)
    mm = _time_ms(lambda: torch.matmul(cand, e), 50)
    print(f"phase14 timing torch.matmul (256, {N_ASSETS}) x ({N_ASSETS}, {pp}): {mm:.4f} ms per "
          f"step, x {N_STEPS} = {mm * N_STEPS:.3f} ms")
    res["merton_multi_dd"][2] = res["heston_multi_dd"][2] = mm * N_STEPS
    g = bench_garch().tensors(dev)
    # W = 1, the path-risk engine's launches, at 131,072 x 252: kernels #5,
    # #7, #8 and #10 (their bounds are printed with the others')
    one = torch.as_tensor(bench_weights()[None], dtype=torch.float32, device=dev)
    hist = torch.as_tensor(bench_history(), device=dev)
    fk = _family_kernels()
    for name, fn in (("garch_multi_dd", lambda: fk["garch_multi_dd"](0, g, one, pp, N_STEPS)),
                     ("bootstrap_multi_dd",
                      lambda: fk["bootstrap_multi_dd"](0, hist, one, pp, N_STEPS)),
                     ("merton_multi_dd", lambda: k["merton_multi_dd"](0, mean, chol, 0.02, muj,
                                                                      sigj, one, pp, N_STEPS)),
                     ("heston_multi_dd", lambda: k["heston_multi_dd"](0, h, one, pp, N_STEPS))):
        fn()
        torch.cuda.synchronize()
        t1, t2 = _time_ms(fn, 10), _time_ms(fn, 10)
        W1_TIMES[name] = (t1 + t2) / 2
        print(f"phase14 timing {name} W=1 {pp} x {N_STEPS} x {N_ASSETS}: kernel {t1:.3f} / "
              f"{t2:.3f} ms ({pp * N_STEPS / W1_TIMES[name] * 1e3:.4e} path-steps/s)")

    def garch_t():
        garch_terminal(0, g, FAMILY_PATHS, N_STEPS, t_df=5.5)

    garch_t()
    t1, t2 = _time_ms(garch_t, 10), _time_ms(garch_t, 10)
    print(f"phase14 timing garch_terminal t(5.5) tier alone {FAMILY_PATHS} x {N_STEPS} x "
          f"{N_ASSETS}: kernel {t1:.3f} / {t2:.3f} ms "
          f"({FAMILY_PATHS * N_STEPS / ((t1 + t2) / 2) * 1e3:.4e} path-steps/s)")
    res["garch_terminal t(5.5)"] = [(t1 + t2) / 2, None, None]   # beside its bound in main
    return res


# ---- the DCC-GARCH family: kernels #11-#14 ----------------------------------------

DCC_KERNELS = ("dcc_terminal", "dcc_dd")
DCC_STEPS = 52                      # bench.py:213, the DCC risk horizon


def bench_dcc(a: int = N_ASSETS, ab=(0.05, 0.9), q0=None, e0: float = 0.0):
    """bench.py:211-219: the bench's GARCH parameters (``bench_garch``), a
    0.05, b 0.9, q0 = 0.5 I + 0.5 (or ``q0``), e0 = 0 (or ``e0`` for every
    asset)."""
    from mcport_torch.convert import dcc_params_from_numpy

    corr = 0.5 * np.eye(a) + 0.5
    return dcc_params_from_numpy(bench_garch(a), ab[0], ab[1], corr if q0 is None else q0,
                                 np.full(a, e0))


def _dcc_kernels():
    from mcport_torch.ops.dcc import dcc_multi_portfolio_dd, dcc_terminal

    return dict(zip(DCC_KERNELS, (dcc_terminal, dcc_multi_portfolio_dd)))


def fitted_dcc():
    """The DCC parameters ``path_tail_risk`` estimates from ``bench_prices``
    (computed once), and the estimation's host seconds."""
    if "dcc" not in _FITTED:
        from mcport_torch.models.dcc import estimate_dcc_garch

        t0 = time.perf_counter()
        _FITTED["dcc"] = estimate_dcc_garch(bench_prices().port_rets)
        _FITTED["dcc_fit_s"] = time.perf_counter() - t0
    return _FITTED


def dcc_launches(dev) -> list[dict]:
    """Every distinct launch of the DCC kernels that phase 16 makes through the
    API (the CLI's run on the fixtures is checked by its counts): dcc_risk at
    1,048,576 x 52, both path-risk cells, path_tail_risk (parameters
    estimated from ``bench_prices``) and every 256-candidate chunk of the
    frontier. ``src`` is the launch's parameters."""
    from mcport_torch.config import GBMConfig
    from mcport_torch.engine.drawdown_frontier import frontier_seeds
    from mcport_torch.ops.dirichlet import sample_weights

    w, eq = bench_weights()[None], np.full((1, N_ASSETS), 1.0 / N_ASSETS)
    out = [dict(kernel="dcc_terminal", what="dcc_risk", seed=FAMILY_SEED, n=FAMILY_PATHS,
                steps=DCC_STEPS)]
    for name, g in cells().items():
        out.append(dict(kernel="dcc_dd", what=f"path risk {name}", seed=g.seed,
                        n=g.path_block, w=w, first_block=0, n_blocks=g.n_paths // g.path_block))
    g = GBMConfig()
    out.append(dict(kernel="dcc_dd", what="path_tail_risk dcc", seed=g.seed,
                    n=g.path_block, w=eq, first_block=0, n_blocks=g.n_paths // g.path_block,
                    src=fitted_dcc()["dcc"]))
    path_seed, weight_seed = frontier_seeds(FRONTIER_SEED)
    gen = torch.Generator(device=dev).manual_seed(weight_seed)
    cand, _ = sample_weights(gen, FRONTIER["n_candidates"], np.zeros(N_ASSETS),
                             np.ones(N_ASSETS))
    out.append(dict(kernel="dcc_dd", what="frontier, 16 chunks of 256", seed=path_seed,
                    n=FRONTIER["n_paths"], w=cand))
    for launch in out:
        launch.setdefault("src", bench_dcc())
        launch.setdefault("steps", N_STEPS)
    return out


def phase_dcc_kernels(dev) -> dict:
    """The DCC kernels against their plain forms within ``ops.dcc.dcc_shares``:
    test shapes (A in {1, 2, 15, 16}, 52 and 7 steps, a ragged path count
    over two blocks, W in {1, 13, 256}; q0 with a non-unit diagonal and a
    large common e0; the frozen case a = 0, b = 1), the zero-vol closed form,
    a = b = 0 against kernel #4 on the same seed, then every launch of phase
    16 over a head slice of each block's paths."""
    from mcport_torch.ops.dcc import (dcc_multi_dd_reference, dcc_shares, dcc_terminal_reference,
                                      dcc_tolerance)
    from mcport_torch.ops.garch import garch_terminal

    k = _dcc_kernels()
    worst = dict.fromkeys(DCC_KERNELS, 0.0)

    def held(name, what, kern, plain, shares):
        pairs = zip(kern, plain) if isinstance(kern, tuple) else [(kern, plain)]
        err = max(float((a - b).abs().max()) for a, b in pairs if a.numel())
        print(f"phase15 {name} {what} max_abs={err:.3e} shares="
              + " ".join(f"{n}={v:.3f}" for n, v in shares.items()))
        check(max(shares.values()) <= 1.0, f"{name} kernel vs plain, {what}")
        worst[name] = max(worst[name], err)

    kw = dict(first_block=6, n_blocks=2)
    cases = {"bench": bench_dcc,
             "q0=S+0.05I e0=3": lambda a: bench_dcc(a, q0=0.55 * np.eye(a) + 0.5, e0=3.0),
             "frozen a=0 b=1": lambda a: bench_dcc(a, ab=(0.0, 1.0))}
    for case, params in cases.items():
        for a in (1, 2, 15, 16):
            d = params(a).tensors(dev)
            for steps in (DCC_STEPS, 7):
                kk = k["dcc_terminal"](11, d, KERNEL_PATHS, steps, **kw)
                p = dcc_terminal_reference(11, d, KERNEL_PATHS, steps, **kw)
                held("dcc_terminal", f"{case} A={a} steps={steps} paths={KERNEL_PATHS}x2", kk,
                     p, dcc_shares(kk, p, d, steps))
        for a, steps in ((15, DCC_STEPS), (15, 7), (1, 9), (2, 8), (16, 8)):
            d = params(a).tensors(dev)
            for n_cand in (1, 13, 256):
                cand = torch.as_tensor(np.random.default_rng(n_cand).dirichlet(
                    np.ones(a), n_cand), dtype=torch.float32, device=dev)
                kk = k["dcc_dd"](11, d, cand, MDD_PATHS, steps, **kw)
                p = dcc_multi_dd_reference(11, d, cand, MDD_PATHS, steps, **kw)
                held("dcc_dd", f"{case} W={n_cand} A={a} steps={steps} "
                     f"paths={MDD_PATHS}x2", kk, p, dcc_shares(kk, p, d, steps))
    # zero volatility: every path compounds (1 + mu)^n - 1
    d = bench_dcc(3).tensors(dev)
    zero = torch.zeros(3, device=dev)
    mu = torch.tensor([0.01, -0.005, 0.002], device=dev)
    d = d._replace(mu=mu, omega=zero, alpha=zero, beta=zero, sigma2_0=zero, eps2_0=zero)
    want = ((1.0 + mu.double()) ** 6 - 1.0).float()
    zt = k["dcc_terminal"](1, d, 4_099, 6)[0]
    zd = k["dcc_dd"](1, d, torch.eye(3, device=dev), 4_099, 6)[0][0]
    err = max(float((zt - want).abs().max()), float((zd - want[:, None]).abs().max()))
    print(f"phase15 zero vol, 6 steps: max |kernel - ((1 + mu)^6 - 1)| = {err:.3e} (bound 3e-7)")
    check(err <= 3e-7, "the DCC kernels' zero-vol closed form")
    # a = b = 0 and q0 = S: CCC-GARCH on kernel #4's shocks, up to the float32
    # Cholesky of S
    for a in (2, 15):
        d = bench_dcc(a, ab=(0.0, 0.0)).tensors(dev)
        k11 = k["dcc_terminal"](5, d, 65_536, N_STEPS, first_block=0, n_blocks=2)
        k4 = garch_terminal(5, bench_garch(a).tensors(dev), 65_536, N_STEPS, first_block=0,
                            n_blocks=2)
        sh = dcc_shares(k11, k4, d, N_STEPS)
        print(f"phase15 dcc_terminal a=b=0 q0=S A={a} 65,536 x 2 x {N_STEPS} against kernel #4 "
              f"(garch_terminal, same seed): max_abs={float((k11 - k4).abs().max()):.3e} "
              f"share={sh['term']:.3f} of dcc_tolerance (relative bound "
              f"{float(dcc_tolerance(d, N_STEPS).max()):.3e})")
        check(sh["term"] <= 1.0, "kernel #11 at a = b = 0 is kernel #4 up to chol(S)")

    # every launch of phase 16, over a head slice of each block
    for launch in dcc_launches(dev):
        name, n, seed, steps = launch["kernel"], launch["n"], launch["seed"], launch["steps"]
        d = launch["src"].tensors(dev)
        blocks = dict(first_block=launch.get("first_block", -1),
                      n_blocks=launch.get("n_blocks", 1))
        if name == "dcc_terminal":
            kk = k[name](seed, d, n, steps, **blocks)
        else:
            w = torch.as_tensor(launch["w"], dtype=torch.float32, device=dev)
            kk = k[name](seed, d, w, n, steps, **blocks)
        for p0 in _slices(n):
            m = min(SLICE, n)
            sl = slice(p0, p0 + m)
            what = (f"{launch['what']} blocks={blocks['first_block'] + 1}.."
                    f"{blocks['first_block'] + blocks['n_blocks']} paths {p0}..{p0 + m - 1}")
            if name == "dcc_terminal":
                p = dcc_terminal_reference(seed, d, m, steps, first_path=p0, **blocks)
                held(name, what, kk[:, sl], p, dcc_shares(kk[:, sl], p, d, steps))
            else:
                p = dcc_multi_dd_reference(seed, d, w, m, steps, first_path=p0, **blocks)
                part = (kk[0][..., sl], kk[1][..., sl])
                held(name, what, part, p, dcc_shares(part, p, d, steps))
        del kk
    return worst


def _fixture_cli_dcc(dev) -> dict:
    """This slice's commands on the weekly BTC/ETH fixtures, as a user runs
    them; each command's JSON."""
    import contextlib
    import io

    from mcport_torch.cli import main as cli

    csvs = sorted(str(p) for p in (Path(__file__).resolve().parent / "fixtures").glob(
        "*7 Years Weekly.csv"))
    check(len(csvs) == 2, "the weekly BTC/ETH fixtures are in the checkout")
    common = [*csvs, "--period", "W", "--steps", str(N_STEPS), "--device", str(dev)]
    runs = {"garch-risk dcc": ["garch-risk", "--correlation", "dcc", "--paths",
                               str(FAMILY_PATHS)],
            "path-risk": ["path-risk", "--models", "dcc", "--paths", str(CLI_PATHS)],
            "dd-frontier dcc": ["dd-frontier", "--model", "dcc", "--candidates",
                                str(CLI_FRONTIER[0]), "--paths", str(CLI_FRONTIER[1]),
                                "--dd-budget", "1.0"],
            "compare-models": ["compare-models", "--paths", str(FAMILY_PATHS)]}
    out = {}
    for name, argv in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(argv[:1] + common + argv[1:])
        out[name] = json.loads(buf.getvalue())
    return out


def phase_dcc_tier(dev) -> dict:
    """The DCC main paths at full width: dcc_risk at 1,048,576 x 52,
    run_dcc_path_risk at both cells with split + resume, path_tail_risk
    (the estimation's host seconds printed), the DCC frontier at the bench's
    size, and the CLI's garch-risk --correlation dcc, path-risk --models dcc,
    dd-frontier --model dcc and compare-models on the fixtures; counts reset
    before and read after."""
    from mcport_torch.api import path_tail_risk
    from mcport_torch.config import Config
    from mcport_torch.engine.drawdown_frontier import family_drawdown_frontier_search
    from mcport_torch.engine.path_risk import run_dcc_path_risk, run_resumable_path_risk
    from mcport_torch.models.dcc import dcc_risk

    dcc, w = bench_dcc(), bench_weights()
    warm_reps = 2
    k = _dcc_kernels()
    fit = fitted_dcc()
    print(f"phase16 the DCC estimation of path_tail_risk ({bench_prices().prices.shape[0]} "
          f"prices x {N_ASSETS} assets: {N_ASSETS} GARCH fits and the (a, b) grids): "
          f"{fit['dcc_fit_s']:.2f} s on the host, a={float(fit['dcc'].a_dcc):.4f} "
          f"b={float(fit['dcc'].b_dcc):.4f}")

    def timed(fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def walls(fn, *a, reps=warm_reps, **kw):
        out, first = timed(fn, *a, **kw)
        return out, (first, [timed(fn, *a, **kw)[1] for _ in range(reps)])

    for fn in k.values():
        fn.launches = 0
    wall = {}
    risk, wall["dcc_risk"] = walls(dcc_risk, FAMILY_SEED, dcc, w, n_paths=FAMILY_PATHS,
                                   n_steps=DCC_STEPS, device=dev)
    reports, resumes = {}, {}
    for name, g in cells().items():
        reports[name], wall[name] = walls(run_dcc_path_risk, dcc, w, g, device=dev)
        n_blocks = g.n_paths // g.path_block
        full, ck_full = run_resumable_path_risk("dcc", dcc, w, g, device=dev)
        _, part = run_resumable_path_risk("dcc", dcc, w, g, max_blocks=n_blocks // 3,
                                          device=dev)
        resumed, ck = run_resumable_path_risk("dcc", dcc, w, g, checkpoint=part, device=dev)
        resumes[name] = (full, ck_full, part, resumed, ck)
    tail, t_wall = timed(path_tail_risk, bench_prices(), None, Config(), model="dcc",
                         device=dev)
    budget = round(-reports["default"].dd_p95 + 0.01, 4)
    frontier, wall["frontier"] = walls(family_drawdown_frontier_search, FRONTIER_SEED, "dcc",
                                       dcc, reps=1, device=dev,
                                       **dict(FRONTIER, dd_budget=budget))
    cli, cli_wall = timed(_fixture_cli_dcc, dev)
    launches = {name: fn.launches for name, fn in k.items()}
    chunks = FRONTIER["n_candidates"] // 256
    cli_chunks = -(-CLI_FRONTIER[0] // 256)
    want = {"dcc_terminal": 1 + warm_reps + 2,
            "dcc_dd": 2 * (1 + warm_reps) + 2 * 3 + 1 + 2 * chunks + 1 + cli_chunks}
    print(f"phase16 DCC tier: launches {launches} (expected {want})")
    check(launches == want, "the DCC paths went through their two kernels")

    first, warm = wall["dcc_risk"]
    print(f"phase16 dcc_risk {FAMILY_PATHS} x {DCC_STEPS}: wall first={first:.4f} s warm="
          f"{' / '.join(f'{x:.4f}' for x in warm)} s var={risk.var:.6f} cvar={risk.cvar:.6f} "
          f"port_mean={risk.port_mean:.6f}")
    check(all(math.isfinite(x) for x in risk) and risk.cvar <= risk.var < risk.port_mean,
          "dcc_risk: finite and ordered")
    for name, r in reports.items():
        first, warm = wall[name]
        ok = (all(math.isfinite(getattr(r, f)) for f in
                  ("var", "cvar", "port_mean", "dd_mean", "dd_p95", "dd_median"))
              and r.cvar <= r.var and -1.0 <= r.dd_p95 <= r.dd_median <= 0.0
              and r.n_paths == cells()[name].n_paths)
        print(f"phase16 run_dcc_path_risk {name}: paths={r.n_paths} wall first={first:.4f} s "
              f"warm={' / '.join(f'{x:.4f}' for x in warm)} s var={r.var:.6f} "
              f"cvar={r.cvar:.6f} dd_mean={r.dd_mean:.6f} dd_median={r.dd_median:.6f} "
              f"dd_p95={r.dd_p95:.6f} sane={ok}")
        check(ok, f"dcc path risk {name}: finite and ordered")
        full, ck_full, part, resumed, ck = resumes[name]
        same = (_reports_equal(full, resumed) and ck.done and not part.done
                and all(np.array_equal(getattr(ck, f), getattr(ck_full, f))
                        for f in ("h_port", "h_dd", "s_port", "s_dd"))
                and _reports_equal(full, r))
        print(f"phase16 dcc {name}: split at block {part.next_block} + resume bit-identical "
              f"to the one-shot run={same}")
        check(same, f"dcc {name}: path-risk resume equivalence")
    print(f"phase16 path_tail_risk dcc: wall {t_wall:.4f} s (estimation included) "
          f"{json.dumps(tail)}")
    check(tail["n_paths"] == Config().gbm.n_paths and tail["cvar"] <= tail["var"]
          and -1.0 <= tail["dd_p95"] <= 0.0, "path_tail_risk dcc")
    first, warm = wall["frontier"]
    i = frontier.opt_idx
    print(f"phase16 frontier dcc: {FRONTIER['n_candidates']} x {FRONTIER['n_paths']} x "
          f"{N_STEPS} budget {budget} wall first={first:.4f} s warm={warm[0]:.4f} s "
          f"feasible={int(frontier.feasible.sum())} opt={i} ret={float(frontier.ret[i]):.6f} "
          f"dd_p95={float(frontier.dd_p95[i]):.6f}")
    check(0 < int(frontier.feasible.sum()) < FRONTIER["n_candidates"]
          and float(frontier.dd_p95[i]) >= -budget,
          "dcc frontier: the budget binds and an optimum is feasible")
    print(f"phase16 cli: the four commands in {cli_wall:.2f} s")
    for name, out in cli.items():
        print(f"phase16 cli {name}: {json.dumps(out)}")
    g_dcc = cli["garch-risk dcc"]
    check(g_dcc["cvar"] <= g_dcc["var"] and g_dcc["model"].startswith("dcc-garch(1,1) a="),
          "cli garch-risk dcc")
    check(cli["path-risk"]["dcc"]["n_paths"] == CLI_PATHS
          and "weights" in cli["dd-frontier dcc"], "cli path-risk and dd-frontier")
    models = cli["compare-models"]["models"]
    check(len(models) == 7 and all("error" not in m and m["cvar"] <= m["var"]
                                   for m in models.values()),
          "cli compare-models: seven families")
    _dcc_references(dev, dcc, w, reports, frontier)
    return launches


def _dcc_references(dev, dcc, w, reports, frontier) -> None:
    """What phase 16 produced, against references: the terminal law (eps is
    a martingale difference, so E[1 + R_n] = (1 + mu)^n exactly), the card
    against the CPU at 16,384 x 16, the drawdown quantiles against the plain
    form over the same paths, and the frontier's optimum against its plain
    form."""
    from mcport_torch.engine.drawdown_frontier import frontier_seeds
    from mcport_torch.engine.path_risk import DD_SKETCH
    from mcport_torch.models.dcc import dcc_risk, dcc_terminal_returns
    from mcport_torch.ops.dcc import dcc_multi_dd_reference, dcc_shares, dcc_terminal

    d = dcc.tensors(dev)
    x = dcc_terminal(FAMILY_SEED, d, FAMILY_PATHS, DCC_STEPS)[0].double()
    want = (1.0 + dcc.base.mu.numpy()) ** DCC_STEPS - 1.0
    z = np.abs(x.mean(0).cpu().numpy() - want) / (x.std(0).cpu().numpy()
                                                  / math.sqrt(FAMILY_PATHS))
    print(f"phase16 dcc law {FAMILY_PATHS} x {DCC_STEPS}: max |mean - ((1 + mu)^n - 1)|/se="
          f"{z.max():.2f}")
    check(z.max() < 5.0, "DCC terminal means are (1 + mu)^n - 1")

    card = dcc_risk(FAMILY_SEED, dcc, w, 16_384, 16, device=dev)
    cpu = dcc_risk(FAMILY_SEED, dcc, w, 16_384, 16, device="cpu")
    dv = max(abs(card.var - cpu.var), abs(card.cvar - cpu.cvar))
    t_card = dcc_terminal_returns(FAMILY_SEED, dcc, 16_384, 16, device="cpu")
    t_k = dcc_terminal(FAMILY_SEED, d, 16_384, 16)[0].cpu()
    sh = dcc_shares(t_k, t_card, dcc.tensors("cpu"), 16)
    print(f"phase16 dcc card vs cpu (16,384 x 16): max |d var|, |d cvar| = {dv:.3e} (bound "
          f"1e-4: a few sketch bins); terminal returns share {sh['term']:.3f}")
    check(dv <= 1e-4 and sh["term"] <= 1.0, "dcc_risk: card agrees with CPU")

    cfg = cells()["default"]
    nb = cfg.n_paths // cfg.path_block
    wt = torch.as_tensor(w, dtype=torch.float32, device=dev)[None]
    dd_width = (DD_SKETCH.hi - DD_SKETCH.lo) / DD_SKETCH.n_bins
    dd = torch.cat([dcc_multi_dd_reference(cfg.seed, d, wt,
                                           min(REF_BLOCK_CHUNK, cfg.path_block - p0), N_STEPS,
                                           first_block=0, n_blocks=nb, first_path=p0)[1]
                    for p0 in range(0, cfg.path_block, REF_BLOCK_CHUNK)], dim=-1).reshape(-1)
    r = reports["default"]
    q = float(torch.kthvalue(dd, math.ceil(0.05 * dd.numel())).values)
    med = float(torch.median(dd))
    print(f"phase16 dcc default dd vs plain form over the same paths: p95 {r.dd_p95:.6f} vs "
          f"{q:.6f}, median {r.dd_median:.6f} vs {med:.6f}, mean {r.dd_mean:.6f} vs "
          f"{float(dd.double().mean()):.6f} (bound {2 * dd_width:.2e})")
    check(abs(r.dd_p95 - q) <= 2 * dd_width and abs(r.dd_median - med) <= 2 * dd_width
          and abs(r.dd_mean - float(dd.double().mean())) <= 1e-5,
          "dcc drawdown quantiles agree with the plain form")
    path_seed = frontier_seeds(FRONTIER_SEED)[0]
    k_tail = math.ceil(0.05 * FRONTIER["n_paths"])
    opt = torch.as_tensor(frontier.weights[frontier.opt_idx][None], device=dev)
    n = FRONTIER["n_paths"]
    parts = [dcc_multi_dd_reference(path_seed, d, opt, min(REF_CHUNK, n - p0), N_STEPS,
                                    first_path=p0) for p0 in range(0, n, REF_CHUNK)]
    term = torch.cat([p[0] for p in parts], dim=-1)[0, 0]
    dd = torch.cat([p[1] for p in parts], dim=-1)[0, 0]
    ret, q = float(term.mean()), float(torch.kthvalue(dd, k_tail).values)
    i = frontier.opt_idx
    d_ret, d_dd = abs(float(frontier.ret[i]) - ret), abs(float(frontier.dd_p95[i]) - q)
    print(f"phase16 frontier dcc optimum vs plain form: ret {float(frontier.ret[i]):.7f} vs "
          f"{ret:.7f}, dd_p95 {float(frontier.dd_p95[i]):.7f} vs {q:.7f} (bound 1e-4)")
    check(d_ret <= 1e-4 and d_dd <= 1e-4, "dcc frontier optimum agrees with the plain form")


def dcc_bounds(draw: float, rate: float, *, a: int = N_ASSETS, n: int = DCC_STEPS,
               p: int = FAMILY_PATHS, pp: int = FRONTIER["n_paths"],
               tag: str = "phase17", w1_steps: int | None = None) -> dict:
    """Least time of the DCC kernels at their timing shapes (1,048,576 x 52 x
    15 and 256 x 131,072 x 52, or the shape given), from the work each
    function needs per path-step: the draws, the Q update (3 per triangle
    entry), the Cholesky (A(A^2-1)/6 FMAs, A(A-1)/2 multiplies, A rsqrt), the
    correlate (A(A+1)/2 FMAs) and 9 per asset for the rescale, GARCH and
    compounding; the candidate kernel adds 256 x (A + 6) for the score. With
    ``w1_steps``, also the candidate kernel at one candidate (the path-risk
    engine's W = 1) over ``pp`` paths x ``w1_steps``: the recursion + 1 x (A +
    6), as ``"dcc_dd W=1"``."""
    w_cnt = 256
    tri = a * (a + 1) / 2
    chol = a * (a * a - 1) / 6 + a * (a - 1) / 2 + a
    step = a * draw + 3 * tri + chol + tri + 9 * a
    score = w_cnt * (a + 6)
    how = (f"{a} x {draw:.2f} draws + {3 * tri:.0f} Q update + {chol:.0f} Cholesky "
           f"({a * (a * a - 1) / 6:.0f} FMAs, {a * (a - 1) / 2:.0f} multiplies, {a} rsqrt) + "
           f"{tri:.0f} correlate + {9 * a} rescale/GARCH/compound: {step:.2f} per path-step")
    work = {"dcc_terminal": (step * n * p, 4 * (2 * a * a + 7 * a + 2) + 4 * a * p, how),
            "dcc_dd": ((step + score) * n * pp,
                             4 * (2 * a * a + 7 * a + 2 + w_cnt * a) + 8 * w_cnt * pp,
                             f"{step:.2f} per path-step + {score} for 256 candidates")}
    if w1_steps is not None:
        work["dcc_dd W=1"] = ((step + a + 6) * w1_steps * pp, 4 * (2 * a * a + 8 * a + 2) + 8 * pp,
                              f"{step:.2f} per path-step + {a + 6} for one candidate, "
                              f"{pp} x {w1_steps}")
    return _bound_table(work, rate, tag)


def phase_dcc_timing(dev) -> dict:
    """The DCC kernels timed with CUDA events at bench.py's DCC shapes beside
    their plain forms (in 131,072- and 8,192-path pieces), and the one-call
    yardsticks: torch.linalg.cholesky of a (1,048,576, 15, 15) batch x 52
    (the factorisation alone) and the score product as one torch.matmul per
    step x 52. The candidate kernel also at one candidate, the path-risk
    engine's W = 1, at 131,072 x 252 (``"dcc_dd W=1"``, printed beside its
    bound; its plain form is timed at 256 candidates only)."""
    from mcport_torch.ops.dcc import dcc_multi_dd_reference, dcc_terminal_reference

    k = _dcc_kernels()
    d = bench_dcc().tensors(dev)
    cand = torch.as_tensor(np.random.default_rng(0).dirichlet(np.ones(N_ASSETS), 256),
                           dtype=torch.float32, device=dev)
    pp = FRONTIER["n_paths"]

    def chunked(fn, n, piece):
        return lambda: [fn(p0, min(piece, n - p0)) for p0 in range(0, n, piece)]

    runs = {
        "dcc_terminal": (lambda: k["dcc_terminal"](0, d, FAMILY_PATHS, DCC_STEPS),
                         chunked(lambda p0, m: dcc_terminal_reference(
                             0, d, m, DCC_STEPS, first_path=p0), FAMILY_PATHS, PLAIN_CHUNK),
                         FAMILY_PATHS * DCC_STEPS, 10),
        "dcc_dd": (lambda: k["dcc_dd"](0, d, cand, pp, DCC_STEPS),
                         chunked(lambda p0, m: dcc_multi_dd_reference(
                             0, d, cand, m, DCC_STEPS, first_path=p0), pp, MDD_PLAIN_CHUNK),
                         256 * pp * DCC_STEPS, 10),
    }
    res = {}
    for name, (kern, plain, work, reps) in runs.items():
        kern()
        torch.cuda.synchronize()
        # the plain form once, its first call (a warm-up would double the
        # phase's time): a yardstick of arithmetic
        p1, k1, k2 = _time_ms(plain, 1), _time_ms(kern, reps), _time_ms(kern, reps)
        ms, plain_ms = (k1 + k2) / 2, p1
        unit = "cand-path-steps/s" if name == "dcc_dd" else "path-steps/s"
        print(f"phase17 timing {name}: kernel {k1:.3f} / {k2:.3f} ms ({work / ms * 1e3:.4e} "
              f"{unit}), plain {p1:.1f} ms")
        res[name] = [ms, plain_ms, None]
    q = torch.as_tensor(0.5 * np.eye(N_ASSETS) + 0.5, dtype=torch.float32, device=dev)
    qb = q.expand(FAMILY_PATHS, N_ASSETS, N_ASSETS).contiguous()
    ch = _time_ms(lambda: torch.linalg.cholesky(qb), 5)
    del qb
    print(f"phase17 timing torch.linalg.cholesky ({FAMILY_PATHS}, {N_ASSETS}, {N_ASSETS}): "
          f"{ch:.4f} ms per step, x {DCC_STEPS} = {ch * DCC_STEPS:.3f} ms")
    e = torch.rand((N_ASSETS, pp), device=dev)
    mm = _time_ms(lambda: torch.matmul(cand, e), 50)
    print(f"phase17 timing torch.matmul (256, {N_ASSETS}) x ({N_ASSETS}, {pp}): {mm:.4f} ms per "
          f"step, x {DCC_STEPS} = {mm * DCC_STEPS:.3f} ms")
    res["dcc_terminal"][2] = ch * DCC_STEPS
    res["dcc_dd"][2] = mm * DCC_STEPS
    one = torch.as_tensor(bench_weights()[None], dtype=torch.float32, device=dev)
    w1 = lambda: k["dcc_dd"](0, d, one, pp, N_STEPS)  # noqa: E731
    w1()
    torch.cuda.synchronize()
    t1, t2 = _time_ms(w1, 5), _time_ms(w1, 5)
    print(f"phase17 timing dcc_dd W=1 {pp} x {N_STEPS}: kernel {t1:.3f} / {t2:.3f} ms "
          f"({pp * N_STEPS / ((t1 + t2) / 2) * 1e3:.4e} path-steps/s)")
    res["dcc_dd W=1"] = [(t1 + t2) / 2, None, None]
    return res


# ---- wider universes and hedged settlement: phases 18-21 -------------------------------

WIDE = (17, 33, 64)                 # widths of the wide variants (the narrow ones stop at 16)
LONG_HISTORY = 8_192                # rows: past a block's shared memory at 15 assets
HEDGED_KERNELS = ("multi_dd_hedged", "merton_multi_dd_hedged")
SPOT = 100.0                        # the hedged main paths' spot of every bench asset
HEDGED_TAIL_STEPS = {"dcc": DCC_STEPS}
# the hedged frontiers' horizons: the bench's 252 steps, where settling the
# married put every step drives some candidates' wealth past float32's range
# (mcport's semantics), and 52, where it stays inside it
HEDGED_FRONTIER_STEPS = (N_STEPS, 52)


def bench_hedge(spots) -> tuple:
    """A married put on asset 0 and a collar on asset 1 at the reference's
    default strikes (0.9 and 1.1 of the spot, no premium), the others
    unhedged: ``(legs_by_asset, HedgeSpec)`` for spots ``spots``."""
    from mcport_torch.options import HedgeSpec, strategy_legs

    legs = {0: strategy_legs("Married Put", float(spots[0])),
            1: strategy_legs("Collar", float(spots[1]))}
    return legs, HedgeSpec.build(legs, [f"asset{i}" for i in range(len(spots))])


def hedged_params():
    """The bench universe (GBM and Merton) at spot 100 for every asset."""
    from mcport_torch.convert import gbm_params_from_numpy, merton_params_from_numpy

    mean, chol = bench_universe()
    s0 = np.full(N_ASSETS, SPOT)
    gbm = gbm_params_from_numpy(s0, mean.astype(np.float64), chol.astype(np.float64))
    merton = merton_params_from_numpy(s0, mean.astype(np.float64), chol.astype(np.float64),
                                      0.02, np.full(N_ASSETS, -0.08), np.full(N_ASSETS, 0.04))
    return gbm, merton


def leg_mix(a: int, n_legs: int, dev, seed: int = 0):
    """Every leg type over ``n_legs`` legs per asset, strikes within 15% of
    random spots, premiums up to 2%, and one qty-0 padding row."""
    from mcport_torch.ops.hedged import HedgeTensors

    rng = np.random.default_rng(seed)
    s0 = rng.uniform(20.0, 200.0, a)
    t = (np.arange(a * n_legs) % 7).reshape(a, n_legs).astype(np.int32)
    q = rng.uniform(0.2, 1.5, (a, n_legs))
    q[-1, -1] = 0.0

    def f(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    return HedgeTensors(f(s0), torch.as_tensor(t, device=dev),
                        f(s0[:, None] * rng.uniform(0.85, 1.15, (a, n_legs))),
                        f(s0[:, None] * rng.uniform(0.0, 0.02, (a, n_legs))), f(q))


def universe17():
    """ROADMAP.md Queue 3's probe: 200 weekly rows of N(1e-3, 0.02) returns
    plus a common factor for 17 assets (``names``, ``prices``,
    ``port_rets``)."""
    from types import SimpleNamespace

    rng = np.random.default_rng(17)
    rets = rng.normal(1e-3, 0.02, (199, 17)) + rng.normal(0.0, 0.01, (199, 1))
    prices = 100.0 * np.cumprod(np.vstack([np.ones((1, 17)), 1.0 + rets]), axis=0)
    return SimpleNamespace(names=tuple(f"S{i}" for i in range(17)), prices=prices,
                           port_rets=np.vstack([np.zeros((1, 17)), rets]))


def _held_printer(prefix: str, worst: dict):
    """``held(name, what, kernel, plain, shares)``: print and check one
    comparison, keep each kernel's worst |kernel - plain| over the values
    finite on both sides."""
    def held(name, what, kern, plain, shares):
        pairs = zip(kern, plain) if isinstance(kern, tuple) else [(kern, plain)]
        diffs = [(x - y).abs() for x, y in pairs if x.numel()]
        err = max((float(d[torch.isfinite(d)].max()) if bool(torch.isfinite(d).any()) else 0.0)
                  for d in diffs)
        print(f"{prefix} {name} {what} max_abs={err:.3e} shares="
              + " ".join(f"{n}={v:.3f}" for n, v in shares.items()))
        check(max(shares.values()) <= 1.0, f"{name} kernel vs plain, {what}")
        worst[name] = max(worst.get(name, 0.0), err)
    return held


def phase_wide(dev) -> dict:
    """Phase 18, the repairs: the GARCH, Heston and DCC kernels' wide variants
    at A = 17, 33 and 64 against their plain forms (Heston's path state bit
    for bit: its terminal within four ulps of expm1); the bootstrap kernels
    on an 8,192 x 15 history (past shared memory) bit for bit; path_tail_risk
    for garch, heston and dcc and compare_tail_risk on the 17-asset probe
    universe, counts reset before and read after (past 64 assets: phase 22).
    Returns each kernel's worst |kernel - plain|."""
    from mcport_torch.api import compare_tail_risk, path_tail_risk
    from mcport_torch.config import Config, GBMConfig
    from mcport_torch.ops import bootstrap as B
    from mcport_torch.ops import dcc as D
    from mcport_torch.ops import garch as G
    from mcport_torch.ops import heston as H

    worst: dict = {}
    held = _held_printer("phase18", worst)
    kw = dict(first_block=6, n_blocks=2)
    for a in WIDE:
        rng = np.random.default_rng(a)
        w13 = torch.as_tensor(rng.dirichlet(np.ones(a), 13), dtype=torch.float32, device=dev)
        g = bench_garch(a).tensors(dev)
        for t_df in (None, 5.5):
            k = G.garch_terminal(11, g, MDD_PATHS, N_STEPS, t_df=t_df, **kw)
            p = G.garch_terminal_reference(11, g, MDD_PATHS, N_STEPS, t_df=t_df, **kw)
            held("garch_terminal", f"A={a} t_df={t_df} {MDD_PATHS}x2 x {N_STEPS}", k, p,
                 G.garch_shares(k, p, g, N_STEPS, t_df))
        k = G.garch_multi_portfolio_dd(11, g, w13, MDD_PATHS, N_STEPS, **kw)
        p = G.garch_multi_dd_reference(11, g, w13, MDD_PATHS, N_STEPS, with_bound=True, **kw)
        held("garch_multi_dd", f"A={a} W=13 {MDD_PATHS}x2 x {N_STEPS}", k, p[:2],
             G.garch_shares(k, p, g, N_STEPS))
        for xi in (3e-3, FELLER_XI):
            h = bench_heston(a, xi).tensors(dev)
            k = H.heston_terminal(11, h, MDD_PATHS, N_STEPS, **kw)
            p = H.heston_terminal_reference(11, h, MDD_PATHS, N_STEPS, **kw)
            held("heston_terminal", f"A={a} xi={xi} {MDD_PATHS}x2 x {N_STEPS}", k, p,
                 H.heston_shares(k, p, h, N_STEPS))
            k = H.heston_multi_portfolio_dd(11, h, w13, MDD_PATHS, N_STEPS, **kw)
            p = H.heston_multi_dd_reference(11, h, w13, MDD_PATHS, N_STEPS, **kw)
            held("heston_multi_dd", f"A={a} xi={xi} W=13 {MDD_PATHS}x2 x {N_STEPS}", k, p,
                 H.heston_shares(k, p, h, N_STEPS))
        d = bench_dcc(a).tensors(dev)
        k = D.dcc_terminal(11, d, 2_053, DCC_STEPS, **kw)
        p = D.dcc_terminal_reference(11, d, 2_053, DCC_STEPS, **kw)
        held("dcc_terminal", f"A={a} 2053x2 x {DCC_STEPS}", k, p, D.dcc_shares(k, p, d,
                                                                               DCC_STEPS))
        k = D.dcc_multi_portfolio_dd(11, d, w13, 1_029, 13, **kw)
        p = D.dcc_multi_dd_reference(11, d, w13, 1_029, 13, **kw)
        held("dcc_dd", f"A={a} W=13 1029x2 x 13", k, p, D.dcc_shares(k, p, d, 13))
    # the bootstrap past shared memory: the same rows from device memory
    hist = torch.as_tensor(np.random.default_rng(8).normal(1e-3, 0.02, (LONG_HISTORY, N_ASSETS)),
                           dtype=torch.float32, device=dev)
    check(not B.history_in_shared(4 * LONG_HISTORY * N_ASSETS),
          "the long history is past a block's shared memory")
    k = B.bootstrap_terminal(11, hist, KERNEL_PATHS, N_STEPS, 0.2, **kw)
    p = B.bootstrap_terminal_reference(11, hist, KERNEL_PATHS, N_STEPS, 0.2, **kw)
    print(f"phase18 bootstrap_terminal {LONG_HISTORY} x {N_ASSETS} history, {KERNEL_PATHS}x2 "
          f"x {N_STEPS}: bit for bit={torch.equal(k, p)}")
    check(torch.equal(k, p), "bootstrap_terminal on the long history is its plain form")
    worst["bootstrap_terminal"] = 0.0
    eye = torch.eye(N_ASSETS, device=dev)
    k7, _ = B.bootstrap_multi_portfolio_dd(11, hist, eye, MDD_PATHS, N_STEPS, 0.2, **kw)
    p6 = B.bootstrap_terminal_reference(11, hist, MDD_PATHS, N_STEPS, 0.2, **kw)
    print(f"phase18 bootstrap_multi_dd one-hot candidates on the long history: the plain "
          f"form's rows bit for bit={torch.equal(k7, p6.transpose(1, 2))}")
    check(torch.equal(k7, p6.transpose(1, 2)), "bootstrap_multi_dd selects the same rows")
    w13 = torch.as_tensor(np.random.default_rng(9).dirichlet(np.ones(N_ASSETS), 13),
                          dtype=torch.float32, device=dev)
    k = B.bootstrap_multi_portfolio_dd(11, hist, w13, MDD_PATHS, N_STEPS, 0.2, **kw)
    p = B.bootstrap_multi_dd_reference(11, hist, w13, MDD_PATHS, N_STEPS, 0.2, **kw)
    held("bootstrap_multi_dd", f"long history W=13 {MDD_PATHS}x2 x {N_STEPS}", k, p,
         B.bootstrap_shares(k, p, hist, w13, N_STEPS))
    # the main paths at 17 assets: counts reset just before, read just after
    counted = {"garch_terminal": G.garch_terminal, "garch_multi_dd": G.garch_multi_portfolio_dd,
               "heston_terminal": H.heston_terminal,
               "heston_multi_dd": H.heston_multi_portfolio_dd,
               "dcc_terminal": D.dcc_terminal, "dcc_dd": D.dcc_multi_portfolio_dd}
    for fn in counted.values():
        fn.launches = 0
    data = universe17()
    cfg = Config(gbm=GBMConfig(n_steps=DCC_STEPS))
    t0 = time.perf_counter()
    tails = {m: path_tail_risk(data, None, cfg, model=m, device=dev)
             for m in ("garch", "heston", "dcc")}
    compare = compare_tail_risk(data, None, cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    print(f"phase18 17 assets: path_tail_risk garch/heston/dcc and compare_tail_risk in "
          f"{wall:.2f} s (estimation included), launches {launches}")
    check(all(n > 0 for n in launches.values()),
          "the 17-asset main paths went through the wide kernels")
    for m, out in tails.items():
        print(f"phase18 path_tail_risk {m} at 17 assets: {json.dumps(out)}")
        check(out["cvar"] <= out["var"] and -1.0 <= out["dd_p95"] <= out["dd_median"] <= 0.0,
              f"path_tail_risk {m} at 17 assets")
    print(f"phase18 compare_tail_risk at 17 assets: {json.dumps(compare)}")
    check(len(compare) == 7 and all("error" not in v and v["cvar"] <= v["var"]
                                    for v in compare.values()),
          "compare_tail_risk reports seven families at 17 assets")
    return worst


def hedged_launches(dev) -> list[dict]:
    """Every distinct hedged launch of kernels #3 and #8 that phase 20 makes
    through the API (the CLI's run on the fixtures is checked by its counts):
    path risk at both cells for gbm, student_t and jump, path_tail_risk for
    the three (parameters estimated from ``bench_prices``, spots its last
    prices), and every 256-candidate chunk of both frontiers."""
    from mcport_torch.config import GBMConfig
    from mcport_torch.engine.drawdown_frontier import frontier_seeds
    from mcport_torch.models.gbm import estimate_gbm, estimate_t_dof
    from mcport_torch.ops.dirichlet import sample_weights

    gbm, merton = hedged_params()
    w = bench_weights()[None]
    out = []
    for name, g in cells().items():
        nb = g.n_paths // g.path_block
        for model, t_df in (("gbm", None), ("student_t", 5.5), ("jump", None)):
            out.append(dict(kernel="merton_multi_dd_hedged" if model == "jump"
                            else "multi_dd_hedged", what=f"path risk {model} {name}",
                            seed=g.seed, n=g.path_block, w=w, first_block=0, n_blocks=nb,
                            t_df=t_df, src=merton if model == "jump" else gbm,
                            s0=np.full(N_ASSETS, SPOT)))
    prices = bench_prices().prices
    g = GBMConfig()
    eq = np.full((1, N_ASSETS), 1.0 / N_ASSETS)
    est = estimate_gbm(prices)
    for model, t_df in (("gbm", None), ("student_t", estimate_t_dof(prices))):
        out.append(dict(kernel="multi_dd_hedged", what=f"path_tail_risk {model}", seed=g.seed,
                        n=g.path_block, w=eq, first_block=0, n_blocks=g.n_paths // g.path_block,
                        t_df=t_df, src=est, s0=prices[-1]))
    out.append(dict(kernel="merton_multi_dd_hedged", what="path_tail_risk jump", seed=g.seed,
                    n=g.path_block, w=eq, first_block=0, n_blocks=g.n_paths // g.path_block,
                    t_df=None, src=fitted_families()["jump"], s0=prices[-1]))
    path_seed, weight_seed = frontier_seeds(FRONTIER_SEED)
    gen = torch.Generator(device=dev).manual_seed(weight_seed)
    cand, _ = sample_weights(gen, FRONTIER["n_candidates"], np.zeros(N_ASSETS),
                             np.ones(N_ASSETS))
    for steps in HEDGED_FRONTIER_STEPS:   # each frontier's 16 launches of 256 candidates
        for kernel, src in (("multi_dd_hedged", gbm), ("merton_multi_dd_hedged", merton)):
            out.append(dict(kernel=kernel, what=f"frontier {steps} steps, 16 chunks",
                            seed=path_seed, n=FRONTIER["n_paths"], w=cand, t_df=None, src=src,
                            s0=np.full(N_ASSETS, SPOT), steps=steps))
    for launch in out:
        launch.setdefault("steps", N_STEPS)
    return out


def _hedged_call(launch, dev, plain: bool, n=None, first_path=0, bound=True):
    """One hedged launch of ``hedged_launches`` through the kernel, or its
    plain form over ``n`` paths from ``first_path``, with its bound per
    (candidate, path) unless ``bound`` is false."""
    from mcport_torch.ops.gbm import t_scaled_chol
    from mcport_torch.ops.hedged import HedgeTensors
    from mcport_torch.ops.jump import merton_multi_dd_reference, merton_multi_portfolio_dd
    from mcport_torch.ops.multi_dd import gbm_multi_portfolio_dd, multi_dd_reference

    _, spec = bench_hedge(launch["s0"])
    hedge = HedgeTensors.from_spec(spec, launch["s0"], dev)
    w = torch.as_tensor(launch["w"], dtype=torch.float32, device=dev)
    blocks = dict(first_block=launch.get("first_block", -1), n_blocks=launch.get("n_blocks", 1))
    p = launch["src"]
    d = p.diffusion if launch["kernel"] == "merton_multi_dd_hedged" else p
    mean, chol = (torch.as_tensor(x).to(dev, torch.float32) for x in (d.mean_step, d.chol_step))
    n = launch["n"] if n is None else n
    if launch["kernel"] == "merton_multi_dd_hedged":
        muj, sigj = (torch.as_tensor(x).to(dev, torch.float32) for x in (p.jump_mean,
                                                                         p.jump_vol))
        args = (launch["seed"], mean, chol, p.jump_rate, muj, sigj, w, n, launch["steps"])
        if plain:
            return merton_multi_dd_reference(*args, first_path=first_path, hedge=hedge,
                                             with_bound=bound, **blocks)
        return merton_multi_portfolio_dd(*args, hedge=hedge, **blocks)
    t_df = launch["t_df"]
    if plain:
        return multi_dd_reference(launch["seed"], mean, t_scaled_chol(chol, t_df), w, n,
                                  launch["steps"], first_path=first_path, t_df=t_df,
                                  hedge=hedge, with_bound=bound, **blocks)
    return gbm_multi_portfolio_dd(launch["seed"], mean, chol, w, n, launch["steps"], t_df=t_df,
                                  hedge=hedge, **blocks)


def _hedged_shares(launch, kern, plain, dev):
    from mcport_torch.ops.gbm import t_scaled_chol
    from mcport_torch.ops.hedged import HedgeTensors
    from mcport_torch.ops.jump import merton_shares
    from mcport_torch.ops.multi_dd import multi_dd_shares

    _, spec = bench_hedge(launch["s0"])
    hedge = HedgeTensors.from_spec(spec, launch["s0"], dev)
    p = launch["src"]
    d = p.diffusion if launch["kernel"] == "merton_multi_dd_hedged" else p
    mean, chol = (torch.as_tensor(x).to(dev, torch.float32) for x in (d.mean_step, d.chol_step))
    if launch["kernel"] == "merton_multi_dd_hedged":
        sigj = torch.as_tensor(p.jump_vol).to(dev, torch.float32)
        return merton_shares(kern, plain, chol, mean, sigj, launch["steps"], hedge)
    return multi_dd_shares(kern, plain, None, t_scaled_chol(chol, launch["t_df"]), mean,
                           launch["steps"], True, "float32", hedge)


def phase_hedged_kernels(dev) -> dict:
    """Phase 19: the hedged modes of kernels #3 and #8 against their plain
    forms (``ops.multi_dd.multi_dd_shares`` and ``ops.jump.merton_shares``
    with the hedge): test shapes with 1-3 legs of every type, the score tiers
    and t(5.5) shocks, W in {1, 13, 256}; an identity hedge against the
    rebalanced mode on the card; #8 at rate 0 against #3, both hedged, bit for
    bit; then every launch of phase 20 over a head slice of each
    block's paths. Each comparison holds every (candidate, path): finite ones
    to the plain form's bound path by path, overflowed ones to the same
    non-finite values (``ops.hedged.hedged_shares``); it prints how many of
    each, and the worst absolute and relative differences of the finite
    ones, which the kernels line reports."""
    from mcport_torch.ops.gbm import t_scaled_chol
    from mcport_torch.ops.hedged import HedgeTensors, hedged_held
    from mcport_torch.ops.jump import (merton_multi_dd_reference, merton_multi_portfolio_dd,
                                       merton_shares)
    from mcport_torch.ops.multi_dd import (gbm_multi_portfolio_dd, multi_dd_reference,
                                           multi_dd_shares)
    from mcport_torch.options import HedgeSpec

    worst: dict = {}

    def held(name, what, kern, plain, shares):
        c = hedged_held(kern, plain)
        print(f"phase19 {name} {what} max_abs={c['max_abs']:.3e} max_rel={c['max_rel']:.3e} "
              f"paths finite={c['finite']} overflowed={c['overflowed']} edge={c['edge']} "
              f"astray={c['astray']} shares=" + " ".join(f"{n}={v:.4f}"
                                                         for n, v in shares.items()))
        check(max(shares.values()) <= 1.0, f"{name} kernel vs plain, {what}")
        worst[name] = max(worst.get(name, 0.0), c["max_abs"])

    mean_np, chol_np = bench_universe()
    mean, chol = torch.as_tensor(mean_np, device=dev), torch.as_tensor(chol_np, device=dev)
    merton = bench_merton()
    _, mchol, muj, sigj = _merton_tensors(merton, dev)
    kw = dict(first_block=6, n_blocks=2)
    for n_legs in (1, 2, 3):
        hedge = leg_mix(N_ASSETS, n_legs, dev, seed=n_legs)
        for n_cand in (1, 13, 256):
            w = torch.as_tensor(np.random.default_rng(n_cand).dirichlet(np.ones(N_ASSETS),
                                                                        n_cand),
                                dtype=torch.float32, device=dev)
            tiers = ("float32", "tensorfloat32", "bfloat16") if n_cand == 13 else ("float32",)
            for sd in tiers:
                for t_df in ((None, 5.5) if n_cand == 13 else (None,)):
                    lk = t_scaled_chol(chol, t_df)
                    args = (11, mean, lk, w, MDD_PATHS, 60)
                    k = gbm_multi_portfolio_dd(11, mean, chol, w, MDD_PATHS, 60, score_dtype=sd,
                                               t_df=t_df, hedge=hedge, **kw)
                    p = multi_dd_reference(*args, score_dtype=sd, t_df=t_df, hedge=hedge,
                                           with_bound=True, **kw)
                    p32 = multi_dd_reference(*args, t_df=t_df, hedge=hedge, **kw)
                    held("multi_dd_hedged", f"L={n_legs} W={n_cand} {sd} t_df={t_df} "
                         f"{MDD_PATHS}x2 x 60", k, p,
                         multi_dd_shares(k, p, p32, lk, mean, 60, True, sd, hedge))
            for rate in (0.02, 0.3):
                margs = (11, mean, mchol, rate, muj, sigj, w, MDD_PATHS, 60)
                k = merton_multi_portfolio_dd(*margs, hedge=hedge, **kw)
                p = merton_multi_dd_reference(*margs, hedge=hedge, with_bound=True, **kw)
                held("merton_multi_dd_hedged", f"L={n_legs} W={n_cand} rate={rate} "
                     f"{MDD_PATHS}x2 x 60", k, p,
                     merton_shares(k, p, mchol, mean, sigj, 60, hedge))
    # an identity hedge (one BUY_ASSET leg per asset) is the rebalanced mode
    ident = HedgeTensors.from_spec(HedgeSpec.build(None, [str(i) for i in range(N_ASSETS)]),
                                   np.linspace(10.0, 200.0, N_ASSETS), dev)
    w = torch.as_tensor(np.random.default_rng(3).dirichlet(np.ones(N_ASSETS), 256),
                        dtype=torch.float32, device=dev)
    h = gbm_multi_portfolio_dd(5, mean, chol, w, MDD_PATHS, N_STEPS, hedge=ident)
    r = gbm_multi_portfolio_dd(5, mean, chol, w, MDD_PATHS, N_STEPS, rebalance=True)
    bound = multi_dd_reference(5, mean, chol, w, MDD_PATHS, N_STEPS, hedge=ident,
                               with_bound=True)[2]
    sh = multi_dd_shares(h, (*r, bound), None, chol, mean, N_STEPS, True, "float32", ident)
    print(f"phase19 identity hedge vs the rebalanced mode, W=256 {MDD_PATHS} x {N_STEPS}: "
          f"max_abs={max(float((x - y).abs().max()) for x, y in zip(h, r)):.3e} shares="
          + " ".join(f"{n}={v:.4f}" for n, v in sh.items()))
    check(max(sh.values()) <= 1.0, "an identity hedge is the rebalanced mode")
    # rate 0: kernel #8 hedged is kernel #3 hedged bit for bit
    hedge = leg_mix(N_ASSETS, 2, dev, seed=7)
    j = merton_multi_portfolio_dd(7, mean, chol, 0.0, muj, sigj, w, MDD_PATHS, N_STEPS,
                                  hedge=hedge)
    m = gbm_multi_portfolio_dd(7, mean, chol, w, MDD_PATHS, N_STEPS, hedge=hedge)
    same = torch.equal(j[0], m[0]) and torch.equal(j[1], m[1])
    print(f"phase19 merton hedged at rate 0 vs multi_dd hedged, W=256 {MDD_PATHS} x "
          f"{N_STEPS}: bit for bit={same}")
    check(same, "kernel #8 hedged at rate 0 is kernel #3 hedged")
    # every launch of phase 20, over a head slice of each block
    for launch in hedged_launches(dev):
        kk = _hedged_call(launch, dev, plain=False)
        for p0 in _slices(launch["n"]):
            m = min(SLICE, launch["n"])
            sl = slice(p0, p0 + m)
            part = (kk[0][..., sl], kk[1][..., sl])
            p = _hedged_call(launch, dev, plain=True, n=m, first_path=p0)
            held(launch["kernel"], f"{launch['what']} paths {p0}..{p0 + m - 1}", part, p,
                 _hedged_shares(launch, part, p, dev))
        del kk
    return worst


def _fixture_cli_hedged(dev, tmp: Path, runs=None) -> dict:
    """Hedged commands on the weekly BTC/ETH fixtures (a married put on BTC, a
    collar on ETH), as a user runs them: ``runs`` ``{name: argv}``, by
    default phase 20's four; each command's JSON."""
    import contextlib
    import io

    from mcport_torch.cli import main as cli

    csvs = sorted(str(p) for p in (Path(__file__).resolve().parent / "fixtures").glob(
        "*7 Years Weekly.csv"))
    check(len(csvs) == 2, "the weekly BTC/ETH fixtures are in the checkout")
    hedge = tmp / "hedge.json"
    hedge.write_text(json.dumps({Path(csvs[0]).stem: {"strategy": "Married Put"},
                                 Path(csvs[1]).stem: {"strategy": "Collar"}}))
    common = [*csvs, "--period", "W", "--hedge", str(hedge), "--device", str(dev)]
    # a year of weekly steps: per-step settlement of the collar's short call
    # over 252 weeks of crypto volatility overflows the wealth (in mcport too)
    if runs is None:
        runs = {"hedged-risk": ["hedged-risk", "--paths", str(FAMILY_PATHS)],
                "gbm-risk --hedge": ["gbm-risk", "--paths", str(FAMILY_PATHS), "--steps", "52",
                                     "--path-stats"],
                "path-risk --hedge": ["path-risk", "--models", "gbm,student_t,jump", "--paths",
                                      str(CLI_PATHS)],
                "dd-frontier --hedge": ["dd-frontier", "--candidates", str(CLI_FRONTIER[0]),
                                        "--paths", str(CLI_FRONTIER[1]), "--steps", "52",
                                        "--dd-budget", "1.0"]}
    out = {}
    for name, argv in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(argv[:1] + common + argv[1:])
        out[name] = json.loads(buf.getvalue())
    return out


def phase_hedged_tier(dev) -> dict:
    """Phase 20, the hedged main paths, all with a married put on asset 0 and
    a collar on asset 1: gbm_risk at both cells, path risk for gbm, student_t
    and jump at both cells with split + resume, path_tail_risk for the three,
    the hedged GBM and jump frontiers at the bench's size, hedged_tail_risk
    for the seven families at 1,048,576 x 252 (DCC at 52), and the four CLI
    commands on the fixtures; counts reset before and read after."""
    from mcport_torch.api import gbm_risk, hedged_tail_risk, path_tail_risk
    from mcport_torch.config import Config
    from mcport_torch.engine.drawdown_frontier import (drawdown_frontier_search,
                                                       family_drawdown_frontier_search)
    from mcport_torch.engine.path_risk import (run_merton_path_risk, run_path_risk,
                                               run_resumable_path_risk)
    from mcport_torch.ops.gbm import gbm_terminal_noise
    from mcport_torch.ops.jump import merton_multi_portfolio_dd
    from mcport_torch.ops.multi_dd import gbm_multi_portfolio_dd

    gbm, merton = hedged_params()
    w = bench_weights()
    legs, spec = bench_hedge(np.full(N_ASSETS, SPOT))
    prices = bench_prices()
    tail_legs, _ = bench_hedge(prices.prices[-1])

    def timed(fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def walls(fn, *a, reps=1, **kw):
        out, first = timed(fn, *a, **kw)
        return out, (first, [timed(fn, *a, **kw)[1] for _ in range(reps)])

    counted = {"multi_dd_hedged": gbm_multi_portfolio_dd,
               "merton_multi_dd_hedged": merton_multi_portfolio_dd}
    for fn in counted.values():
        fn.hedged_launches = 0
    gbm_terminal_noise.launches = 0
    wall, risks = {}, {}
    for name, g in cells().items():
        risks[name], wall[f"gbm_risk {name}"] = walls(
            gbm_risk, gbm, w, Config(gbm=g), legs_by_asset=legs, device=dev)
    reports, resumes = {}, {}
    for name, g in cells().items():
        nb = g.n_paths // g.path_block
        for model in ("gbm", "student_t", "jump"):
            cfg = path_config(g, 5.5 if model == "student_t" else None)
            params = merton if model == "jump" else gbm
            run = run_merton_path_risk if model == "jump" else run_path_risk
            key = f"{model} {name}"
            reports[key], wall[key] = walls(run, params, w, cfg, hedge=spec, device=dev)
            _, part = run_resumable_path_risk(model, params, w, cfg, hedge=spec,
                                              max_blocks=nb // 3, device=dev)
            resumes[key] = run_resumable_path_risk(model, params, w, cfg, hedge=spec,
                                                   checkpoint=part, device=dev), part
    tails = {m: path_tail_risk(prices, None, Config(), model=m, legs_by_asset=tail_legs,
                               device=dev) for m in ("gbm", "student_t", "jump")}
    # each 252-step frontier's budget: the bench portfolio's hedged drawdown
    # quantile in the default cell, plus 0.01; each 52-step one's: the median
    # candidate's quantile, from a first pass. Each binds and leaves a feasible set
    runs = {"gbm": lambda **kw: drawdown_frontier_search(FRONTIER_SEED, gbm, hedge=spec,
                                                         device=dev, **kw),
            "jump": lambda **kw: family_drawdown_frontier_search(
                FRONTIER_SEED, "jump", merton, hedge=spec, s0=np.full(N_ASSETS, SPOT),
                device=dev, **kw)}
    frontier, budget = {}, {}
    for steps in HEDGED_FRONTIER_STEPS:
        for m, run in runs.items():
            key, cfg = f"{m} {steps}", dict(FRONTIER, n_steps=steps)
            if steps == N_STEPS:
                budget[key] = round(-reports[f"{m} default"].dd_p95 + 0.01, 4)
            else:   # the median candidate's, over those whose wealth stays finite
                q = run(**dict(cfg, dd_budget=1.0)).dd_p95
                budget[key] = round(-float(np.median(q[np.isfinite(q)])), 4)
            frontier[key], wall[f"frontier {key}"] = walls(run, **dict(cfg, dd_budget=budget[key]))
    hedged_tail, t_wall = {}, {}
    for m in ("gbm", "student_t", "garch", "dcc", "jump", "heston", "bootstrap"):
        cfg = Config(gbm=dataclasses.replace(
            cells()["default"], n_paths=FAMILY_PATHS, n_steps=HEDGED_TAIL_STEPS.get(m, N_STEPS)))
        hedged_tail[m], t_wall[m] = timed(hedged_tail_risk, prices, None, cfg, tail_legs,
                                          model=m, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        cli, cli_wall = timed(_fixture_cli_hedged, dev, Path(tmp))
    launches = {name: fn.hedged_launches for name, fn in counted.items()}
    print(f"phase20 hedged tier: hedged launches {launches}, terminal-noise launches "
          f"{gbm_terminal_noise.launches}")
    check(all(n > 0 for n in launches.values()) and gbm_terminal_noise.launches > 0,
          "the hedged paths went through the hedged modes of kernels #3 and #8")

    for name, r in risks.items():
        first, warm = wall[f"gbm_risk {name}"]
        print(f"phase20 gbm_risk hedged {name}: paths={r.n_paths} wall first={first:.4f} s "
              f"warm={warm[0]:.4f} s var={r.var:.6f} cvar={r.cvar:.6f} "
              f"port_mean={r.port_mean:.6f}")
        check(math.isfinite(r.var) and r.cvar <= r.var < r.port_mean, f"gbm_risk hedged {name}")
    for key, r in reports.items():
        first, warm = wall[key]
        (resumed, ck), part = resumes[key]
        same = _reports_equal(r, resumed) and ck.done and not part.done
        print(f"phase20 path risk hedged {key}: paths={r.n_paths} wall first={first:.4f} s "
              f"warm={warm[0]:.4f} s var={r.var:.6f} cvar={r.cvar:.6f} dd_p95={r.dd_p95:.6f} "
              f"dd_median={r.dd_median:.6f}; split at block {part.next_block} + resume "
              f"bit-identical={same}")
        check(r.cvar <= r.var and -1.0 <= r.dd_p95 <= r.dd_median <= 0.0,
              f"hedged path risk {key}: finite and ordered")
        check(same, f"hedged path risk {key}: resume equivalence")
    for m, out in tails.items():
        print(f"phase20 path_tail_risk hedged {m}: {json.dumps(out)}")
        check(out["hedged_assets"] == ["asset0", "asset1"] and out["cvar"] <= out["var"],
              f"path_tail_risk hedged {m}")
    for key, r in frontier.items():
        first, warm = wall[f"frontier {key}"]
        i = r.opt_idx
        print(f"phase20 frontier hedged {key} steps: {FRONTIER['n_candidates']} x "
              f"{FRONTIER['n_paths']} budget {budget[key]} wall first={first:.4f} s "
              f"warm={warm[0]:.4f} s feasible={int(r.feasible.sum())} opt={i} "
              f"ret={float(r.ret[i]):.7g} dd_p95={float(r.dd_p95[i]):.6f} candidates with "
              f"an infinite mean return {int((~np.isfinite(r.ret)).sum())}")
        check(0 < int(r.feasible.sum()) < FRONTIER["n_candidates"]
              and float(r.dd_p95[i]) >= -budget[key], f"hedged {key}-step frontier")
    for m, out in hedged_tail.items():
        print(f"phase20 hedged_tail_risk {m} {FAMILY_PATHS} x "
              f"{HEDGED_TAIL_STEPS.get(m, N_STEPS)}: wall {t_wall[m]:.3f} s (estimation "
              f"included) {json.dumps(out)}")
        check(out["n_paths"] == FAMILY_PATHS and out["cvar"] <= out["var"]
              and all(math.isfinite(out[k]) for k in ("var", "cvar", "port_mean")),
              f"hedged_tail_risk {m}")
    print(f"phase20 cli: the four hedged commands in {cli_wall:.2f} s")
    for name, out in cli.items():
        print(f"phase20 cli {name}: {json.dumps(out)}")
    check(all(cli["hedged-risk"][m]["cvar"] <= cli["hedged-risk"][m]["var"]
              for m in cli["hedged-risk"] if m != "weights"), "cli hedged-risk")
    check(cli["gbm-risk --hedge"]["max_drawdown"]["settlement"] == "per-period hedged"
          and cli["path-risk --hedge"]["settlement"] == "per-period hedged"
          and cli["dd-frontier --hedge"]["hedged"] is True, "cli --hedge")
    _hedged_references(dev, gbm, merton, w, spec, reports, frontier)
    return launches


def _hedged_references(dev, gbm, merton, w, spec, reports, frontier) -> None:
    """What phase 20 produced, against references: the default cell's hedged
    drawdown quantiles against the plain form over the same paths, and each
    hedged frontier's optimum (GBM and jump, 252 and 52 steps) against its
    plain form over all its paths, within what the plain form's bound per
    path allows (the mean return within the mean of the terminal bounds, the
    quantile within twice the largest bound, each plus a reduction's
    rounding); an infinite mean return must be the plain form's too."""
    from mcport_torch.engine.drawdown_frontier import frontier_seeds
    from mcport_torch.engine.path_risk import DD_SKETCH
    from mcport_torch.ops.hedged import HedgeTensors
    from mcport_torch.ops.multi_dd import multi_dd_reference

    hedge = HedgeTensors.from_spec(spec, np.full(N_ASSETS, SPOT), dev)
    mean, chol = (torch.as_tensor(x).to(dev, torch.float32) for x in (gbm.mean_step,
                                                                      gbm.chol_step))
    cfg = cells()["default"]
    nb = cfg.n_paths // cfg.path_block
    wt = torch.as_tensor(w, dtype=torch.float32, device=dev)[None]
    dd = torch.cat([multi_dd_reference(cfg.seed, mean, chol, wt,
                                       min(REF_BLOCK_CHUNK, cfg.path_block - p0), N_STEPS,
                                       first_block=0, n_blocks=nb, first_path=p0,
                                       hedge=hedge)[1]
                    for p0 in range(0, cfg.path_block, REF_BLOCK_CHUNK)], dim=-1).reshape(-1)
    dd_width = (DD_SKETCH.hi - DD_SKETCH.lo) / DD_SKETCH.n_bins
    r = reports["gbm default"]
    q = float(torch.kthvalue(dd, math.ceil(0.05 * dd.numel())).values)
    med = float(torch.median(dd))
    print(f"phase20 hedged gbm default dd vs plain form over the same paths: p95 "
          f"{r.dd_p95:.6f} vs {q:.6f}, median {r.dd_median:.6f} vs {med:.6f} (bound "
          f"{2 * dd_width:.2e})")
    check(abs(r.dd_p95 - q) <= 2 * dd_width and abs(r.dd_median - med) <= 2 * dd_width,
          "hedged drawdown quantiles agree with the plain form")
    path_seed = frontier_seeds(FRONTIER_SEED)[0]
    n = FRONTIER["n_paths"]
    for key, f in frontier.items():
        m, steps = key.split()
        i = f.opt_idx
        launch = dict(kernel="merton_multi_dd_hedged" if m == "jump" else "multi_dd_hedged",
                      seed=path_seed, w=f.weights[i][None], t_df=None,
                      src=merton if m == "jump" else gbm, s0=np.full(N_ASSETS, SPOT),
                      steps=int(steps), n=n)
        parts = [_hedged_call(launch, dev, plain=True, n=min(REF_CHUNK, n - p0), first_path=p0)
                 for p0 in range(0, n, REF_CHUNK)]
        term, ddo, bnd = (torch.cat([p[j] for p in parts], dim=-1)[0, 0] for j in range(3))
        ret = float(term.mean())
        q = float(torch.kthvalue(torch.nan_to_num(ddo, nan=-math.inf),
                                 math.ceil(0.05 * n)).values)
        fin = torch.isfinite(term)
        ret_tol = (float((bnd[fin].double() * (1.0 + term[fin].double().abs())).mean())
                   + (1e-6 * (1.0 + abs(ret)) if math.isfinite(ret) else 0.0))
        q_tol = 2.0 * float(bnd[torch.isfinite(ddo)].max()) + 1e-6
        got_ret, got_q = float(f.ret[i]), float(f.dd_p95[i])
        print(f"phase20 hedged frontier {key} steps optimum vs plain form: ret {got_ret:.7g} "
              f"vs {ret:.7g} (bound {ret_tol:.3g}), dd_p95 {got_q:.7f} vs {q:.7f} (bound "
              f"{q_tol:.3g}); paths overflowed {int((~fin).sum())} of {n}")
        check(_within(got_ret, ret, ret_tol) and _within(got_q, q, q_tol),
              f"hedged {key}-step frontier optimum agrees with the plain form")


def _within(got: float, want: float, tol: float) -> bool:
    """``|got - want| <= tol``; a non-finite ``want`` must be ``got`` itself."""
    if not math.isfinite(want):
        return got == want or (math.isnan(got) and math.isnan(want))
    return abs(got - want) <= tol


def hedged_bounds(draw: float, rate: float) -> dict:
    """Least time of the hedged modes of kernels #3 and #8 at 256 x 131,072 x
    252 with the bench hedge (L = 2 legs), from the work each function needs
    per path-step: the draws, the correlate's lower triangle, the increment,
    exp and price update (3 per asset), per asset the legs' settlement (per
    leg two subtractions, two maxima, the select, a multiply and an add: 7)
    and one division (counted as 8), and the score, 256 x (A + 6); #8 adds
    the jump clock (half a Philox call and half a Box-Muller pair) and its
    adds."""
    a, n, w_cnt, pp, legs = N_ASSETS, N_STEPS, 256, FRONTIER["n_paths"], 2
    tri = a * (a + 1) / 2
    settle = a * (7 * legs + 1 + 8)
    score = w_cnt * (a + 6)
    gbm_step = a * (draw + 3) + tri + settle
    jump_step = gbm_step + PHILOX_CALL / 2 + BOX_MULLER_PAIR / 2 + 0.02 * a
    hedge_bytes = 4 * a * (1 + 4 * legs)
    work = {"multi_dd_hedged": ((gbm_step + score) * n * pp,
                                4 * (a * a + a + w_cnt * a) + hedge_bytes + 8 * w_cnt * pp,
                                f"{draw:.2f} per draw + 3 per asset-step + {tri:.0f} correlate "
                                f"FMAs + {settle:.0f} settlement: {gbm_step:.2f} per path-step "
                                f"+ {score} for 256 candidates"),
               "merton_multi_dd_hedged": ((jump_step + score) * n * pp,
                                          4 * (a * a + 3 * a + w_cnt * a) + hedge_bytes
                                          + 8 * w_cnt * pp,
                                          f"{jump_step:.2f} per path-step (the jump clock "
                                          f"added) + {score} for 256 candidates")}
    return _bound_table(work, rate, "phase21")


def _dcc_yardsticks(d, w, n: int, steps: int, dev) -> tuple[float, float | None]:
    """One-call yardsticks of a DCC kernel at ``n`` paths x ``steps``, in ms:
    ``torch.linalg.cholesky`` of the (n, A, A) batch of the start's Q once per
    step x steps (the factorisation alone), and with candidates ``w`` the
    score product ``torch.matmul`` (W, A) x (A, n) once per step x steps."""
    a = d.n_assets
    qb = d.q0.expand(n, a, a).contiguous()
    ch = _time_ms(lambda: torch.linalg.cholesky(qb), 3) * steps
    del qb
    mm = None
    if w is not None:
        x = torch.rand((a, n), device=dev)
        mm = _time_ms(lambda: torch.matmul(w, x), 20) * steps
    return ch, mm


def phase_hedged_timing(dev) -> dict:
    """Phase 21: the hedged modes of #3 and #8 timed with CUDA events at 256 x
    131,072 x 252 beside their plain forms (in 8,192-path pieces) and the
    score product as one torch.matmul per step; each wide variant at A = 64;
    the bootstrap kernels on the 8,192-row history."""
    from mcport_torch.ops import bootstrap as B
    from mcport_torch.ops import dcc as D
    from mcport_torch.ops import garch as G
    from mcport_torch.ops import heston as H
    from mcport_torch.ops.hedged import HedgeTensors

    gbm, merton = hedged_params()
    _, spec = bench_hedge(np.full(N_ASSETS, SPOT))
    hedge = HedgeTensors.from_spec(spec, np.full(N_ASSETS, SPOT), dev)
    cand = torch.as_tensor(np.random.default_rng(0).dirichlet(np.ones(N_ASSETS), 256),
                           dtype=torch.float32, device=dev)
    pp = FRONTIER["n_paths"]
    res = {}
    for name, src in (("multi_dd_hedged", gbm), ("merton_multi_dd_hedged", merton)):
        launch = dict(kernel=name, seed=0, n=pp, w=cand, t_df=None, src=src,
                      s0=np.full(N_ASSETS, SPOT), steps=N_STEPS)

        def kern(launch=launch):
            _hedged_call(launch, dev, plain=False)

        def plain(launch=launch):
            for p0 in range(0, pp, MDD_PLAIN_CHUNK):
                _hedged_call(launch, dev, plain=True, n=min(MDD_PLAIN_CHUNK, pp - p0),
                             first_path=p0, bound=False)

        kern()
        torch.cuda.synchronize()
        p1, k1, k2 = _time_ms(plain, 1), _time_ms(kern, 3), _time_ms(kern, 3)
        ms = (k1 + k2) / 2
        print(f"phase21 timing {name} (L=2) 256 x {pp} x {N_STEPS}: kernel {k1:.3f} / "
              f"{k2:.3f} ms ({256 * pp * N_STEPS / ms * 1e3:.4e} cand-path-steps/s), plain "
              f"{p1:.1f} ms")
        res[name] = [ms, p1, None]
    e = torch.rand((N_ASSETS, pp), device=dev)
    mm = _time_ms(lambda: torch.matmul(cand, e), 50)
    print(f"phase21 timing torch.matmul (256, {N_ASSETS}) x ({N_ASSETS}, {pp}): {mm:.4f} ms per "
          f"step, x {N_STEPS} = {mm * N_STEPS:.3f} ms")
    for name in HEDGED_KERNELS:
        res[name][2] = mm * N_STEPS
    # the wide variants at A = 64
    a, tp, dp, steps = 64, 262_144, 16_384, DCC_STEPS
    c64 = torch.as_tensor(np.random.default_rng(1).dirichlet(np.ones(a), 256),
                          dtype=torch.float32, device=dev)
    g, h, d = (bench_garch(a).tensors(dev), bench_heston(a).tensors(dev),
               bench_dcc(a).tensors(dev))
    wide = {"garch_terminal": (lambda: G.garch_terminal(0, g, tp, steps), tp),
            "garch_multi_dd": (lambda: G.garch_multi_portfolio_dd(0, g, c64, dp, steps), dp),
            "heston_terminal": (lambda: H.heston_terminal(0, h, tp, steps), tp),
            "heston_multi_dd": (lambda: H.heston_multi_portfolio_dd(0, h, c64, dp, steps), dp),
            "dcc_terminal": (lambda: D.dcc_terminal(0, d, tp // 4, steps), tp // 4),
            "dcc_dd": (lambda: D.dcc_multi_portfolio_dd(0, d, c64, dp // 4, steps), dp // 4)}
    for name, (fn, n) in wide.items():
        fn()
        torch.cuda.synchronize()
        t1, t2 = _time_ms(fn, 2), _time_ms(fn, 2)
        work = n * steps * (256 if "multi" in name or name == "dcc_dd" else 1)
        print(f"phase21 timing {name} wide variant A={a} {'256 x ' if work > n * steps else ''}"
              f"{n} x {steps}: kernel {t1:.3f} / {t2:.3f} ms "
              f"({work / ((t1 + t2) / 2) * 1e3:.4e} {'cand-' if work > n * steps else ''}"
              f"path-steps/s)")
        res[f"{name} A=64"] = [(t1 + t2) / 2, None, None]
    # the DCC yardsticks at A = 64: the factorisation alone and the score alone
    for name, n in (("dcc_terminal", tp // 4), ("dcc_dd", dp // 4)):
        ch, mm = _dcc_yardsticks(d, c64 if name == "dcc_dd" else None, n, steps, dev)
        print(f"phase21 timing {name} A={a} yardsticks: torch.linalg.cholesky ({n}, {a}, {a}) "
              f"per step x {steps} {ch:.3f} ms" + (f", torch.matmul (256, {a}) x ({a}, {n}) per "
                                                  f"step x {steps} {mm:.3f} ms" if mm else ""))
        res[f"{name} A=64"][2] = ch
    _tile_at_15(dev, cand, res)
    # the bootstrap on the long history, from device memory
    hist = torch.as_tensor(np.random.default_rng(8).normal(1e-3, 0.02, (LONG_HISTORY, N_ASSETS)),
                           dtype=torch.float32, device=dev)
    short = hist[:365].contiguous()
    for what, hh in (("365-row history (shared memory)", short),
                     (f"{LONG_HISTORY}-row history (device memory)", hist)):
        def term(hh=hh):
            B.bootstrap_terminal(0, hh, FAMILY_PATHS, N_STEPS)

        def cdd(hh=hh):
            B.bootstrap_multi_portfolio_dd(0, hh, cand, pp, N_STEPS)

        term(), cdd()
        torch.cuda.synchronize()
        t1, c1 = _time_ms(term, 5), _time_ms(cdd, 2)
        print(f"phase21 timing bootstrap {what}: terminal {FAMILY_PATHS} x {N_STEPS} "
              f"{t1:.3f} ms, candidates 256 x {pp} x {N_STEPS} {c1:.3f} ms")
        if hh is hist:
            res[f"bootstrap_terminal {LONG_HISTORY} rows"] = [t1, None, None]
            res[f"bootstrap_multi_dd {LONG_HISTORY} rows"] = [c1, None, None]
    return res


def _tile_at_15(dev, cand, res: dict) -> None:
    """The GARCH and Heston kernels' 17-64-asset layouts run at the bench's 15
    assets: held to their plain forms (Heston bit for bit) on two blocks, then
    timed with CUDA events beside the narrow kernels at the narrow kernels'
    timing shapes (phases 11 and 14), narrow / wide / wide / narrow — what
    keeping the narrow kernels beside them buys."""
    from mcport_torch.ops import garch as G
    from mcport_torch.ops import heston as H

    g, h = bench_garch().tensors(dev), bench_heston().tensors(dev)
    w13 = torch.as_tensor(np.random.default_rng(15).dirichlet(np.ones(N_ASSETS), 13),
                          dtype=torch.float32, device=dev)
    kw = dict(first_block=6, n_blocks=2)
    k = G._launch_terminal(11, g, MDD_PATHS, N_STEPS, 6, 2, None, wide=True)
    sh = G.garch_shares(k, G.garch_terminal_reference(11, g, MDD_PATHS, N_STEPS, **kw), g,
                        N_STEPS, None)
    k = G._launch_dd(11, g, w13, MDD_PATHS, N_STEPS, 6, 2, wide=True)
    sd = G.garch_shares(k, G.garch_multi_dd_reference(11, g, w13, MDD_PATHS, N_STEPS,
                                                      with_bound=True, **kw), g, N_STEPS)
    same_t = torch.equal(H._launch_terminal(11, h, MDD_PATHS, N_STEPS, 6, 2, wide=True),
                         H.heston_terminal_reference(11, h, MDD_PATHS, N_STEPS, **kw))
    kh = H._launch_dd(11, h, w13, MDD_PATHS, N_STEPS, 6, 2, wide=True)
    ph = H.heston_multi_dd_reference(11, h, w13, MDD_PATHS, N_STEPS, **kw)
    same_d = torch.equal(kh[0], ph[0]) and torch.equal(kh[1], ph[1])
    print(f"phase21 17-64 layouts at A={N_ASSETS} vs plain forms, {MDD_PATHS}x2 x {N_STEPS}: "
          f"garch_terminal share {max(sh.values()):.3f}, garch_multi_dd share "
          f"{max(sd.values()):.3f}, heston terminal and candidates bit for bit "
          f"{same_t} / {same_d}")
    check(max(sh.values()) <= 1.0 and max(sd.values()) <= 1.0 and same_t and same_d,
          "the 17-64-asset layouts at 15 assets agree with their plain forms")
    pp = FRONTIER["n_paths"]
    runs = {"garch_terminal": lambda wide: G._launch_terminal(0, g, FAMILY_PATHS, N_STEPS, -1,
                                                              1, None, wide),
            "garch_multi_dd": lambda wide: G._launch_dd(0, g, cand, pp, N_STEPS, -1, 1, wide),
            "heston_terminal": lambda wide: H._launch_terminal(0, h, FAMILY_PATHS, N_STEPS, -1,
                                                               1, wide),
            "heston_multi_dd": lambda wide: H._launch_dd(0, h, cand, pp, N_STEPS, -1, 1, wide)}
    for name, fn in runs.items():
        fn(False), fn(True)
        torch.cuda.synchronize()
        n1, t1 = _time_ms(lambda: fn(False), 2), _time_ms(lambda: fn(True), 2)
        t2, n2 = _time_ms(lambda: fn(True), 2), _time_ms(lambda: fn(False), 2)
        narrow, tile = (n1 + n2) / 2, (t1 + t2) / 2
        print(f"phase21 timing {name} at A={N_ASSETS}: narrow {n1:.3f} / {n2:.3f} ms, 17-64 "
              f"layout {t1:.3f} / {t2:.3f} ms ({tile / narrow:.3f}x)")
        res[f"{name} A=15 17-64 layout"] = [tile, None, None]


# ---- past 64 assets, and the hedged GARCH and bootstrap modes: phases 22-25 -------------

WIDE_A = (65, 200)                  # widths of the wide layout (csrc/wide.cuh)
DCC_WIDE_A = (65, 256)              # DCC's: at 256 a path's Q leaves shared memory
WIDE_TERM, WIDE_CAND, WIDE_STEPS = 32_768, 8_192, 52   # per block; two blocks each check
DCC_WIDE = (2_048, 8)               # DCC: paths per block, steps
WIDE_TIMING = dict(p=65_536, pp=8_192, n=52)   # phase 25 at A = 200 (DCC: 4,096 x 8)
WIDE_KERNELS = ("terminal_noise", "path_stats", "multi_dd", "merton_multi_dd",
                "garch_terminal", "garch_multi_dd", "bootstrap_terminal", "bootstrap_multi_dd",
                "heston_terminal", "heston_multi_dd", "dcc_terminal", "dcc_dd")
FAMILY_HEDGED = ("garch_multi_dd_hedged", "bootstrap_multi_dd_hedged", "heston_multi_dd_hedged",
                 "dcc_dd_hedged")
#: each family's hedged kernel
HEDGED_KERNEL = {"garch": "garch_multi_dd_hedged", "bootstrap": "bootstrap_multi_dd_hedged",
                 "heston": "heston_multi_dd_hedged", "dcc": "dcc_dd_hedged"}
HESTON_HEDGED_A = (15, 17, 64, 65, 200)   # <16>, <64>, <64>, HestonWide, HestonWide
HESTON_HEDGED_STEPS = (16, 52, N_STEPS)
# hedged #13: <true> at 15 and 16, dcc_group_kernel at 17, 64, 65 and 256 (Q in
# device memory); 16 and 52 steps, and 252 where A <= 16
DCC_HEDGED_A = (15, 16, 17, 64, 65, 256)
DCC_HEDGED_PATHS = {65: 1_024, 256: 128}   # paths per block past 64: the plain form costs A^3


def _wide_wrappers() -> dict:
    """Each kernel's wrapper, by its name in the kernels line."""
    from mcport_torch.ops import bootstrap as B
    from mcport_torch.ops import dcc as D
    from mcport_torch.ops import garch as G
    from mcport_torch.ops import heston as H
    from mcport_torch.ops.gbm import gbm_terminal_noise
    from mcport_torch.ops.jump import merton_multi_portfolio_dd
    from mcport_torch.ops.multi_dd import gbm_multi_portfolio_dd
    from mcport_torch.ops.path_stats import gbm_path_stats

    return dict(zip(WIDE_KERNELS, (
        gbm_terminal_noise, gbm_path_stats, gbm_multi_portfolio_dd, merton_multi_portfolio_dd,
        G.garch_terminal, G.garch_multi_portfolio_dd, B.bootstrap_terminal,
        B.bootstrap_multi_portfolio_dd, H.heston_terminal, H.heston_multi_portfolio_dd,
        D.dcc_terminal, D.dcc_multi_portfolio_dd)))


def universe65():
    """Queue 3's probe at 65 assets: 200 weekly rows of N(1e-3, 0.02) returns
    plus a common factor (``names``, ``prices``, ``port_rets``)."""
    from types import SimpleNamespace

    rng = np.random.default_rng(65)
    rets = rng.normal(1e-3, 0.02, (199, 65)) + rng.normal(0.0, 0.01, (199, 1))
    prices = 100.0 * np.cumprod(np.vstack([np.ones((1, 65)), 1.0 + rets]), axis=0)
    return SimpleNamespace(names=tuple(f"S{i}" for i in range(65)), prices=prices,
                           port_rets=np.vstack([np.zeros((1, 65)), rets]))


def _wide_calls(a: int, dev, p: int, pp: int, n: int, w_cnt: int, nb: int = 2):
    """``{name: (kernel(), plain(), shares(k, p) or None for bit for bit)}``
    for every kernel at ``a`` assets (``p`` terminal and ``pp`` candidate
    paths per block, ``n`` steps, ``w_cnt`` candidates, ``nb`` blocks)."""
    from mcport_torch.ops import bootstrap as B
    from mcport_torch.ops import garch as G
    from mcport_torch.ops import heston as H
    from mcport_torch.ops.gbm import (gbm_terminal_noise, kernel_tolerance,
                                      terminal_noise_reference)
    from mcport_torch.ops.jump import (merton_multi_dd_reference, merton_multi_portfolio_dd,
                                       merton_shares)
    from mcport_torch.ops.multi_dd import (gbm_multi_portfolio_dd, multi_dd_reference,
                                           multi_dd_shares)
    from mcport_torch.ops.path_stats import (gbm_path_stats, path_stats_reference,
                                             path_stats_shares)

    kw = dict(first_block=6, n_blocks=nb)
    mean, chol = (torch.as_tensor(x, device=dev) for x in bench_universe(a))
    w1 = torch.full((a,), 1.0 / a, device=dev)
    w = torch.as_tensor(np.random.default_rng(a).dirichlet(np.ones(a), w_cnt),
                        dtype=torch.float32, device=dev)
    m = bench_merton(a)
    _, _, muj, sigj = _merton_tensors(m, dev)
    g, hist, h = (bench_garch(a).tensors(dev), torch.as_tensor(bench_history(a), device=dev),
                  bench_heston(a).tensors(dev))

    def tn_share(k, pl):
        return {"term": float(((k - pl).abs() / kernel_tolerance(chol, n)).max())}

    margs = (11, mean, chol, 0.02, muj, sigj, w, pp, n)
    return {
        "terminal_noise": (lambda: gbm_terminal_noise(11, chol, p, n, **kw),
                           lambda: terminal_noise_reference(11, chol, p, n, **kw), tn_share),
        "path_stats": (lambda: gbm_path_stats(11, mean, chol, w1, p, n, **kw),
                       lambda: path_stats_reference(11, mean, chol, w1, p, n, **kw),
                       lambda k, pl: path_stats_shares(k, pl, chol, mean, n)),
        "multi_dd": (lambda: gbm_multi_portfolio_dd(11, mean, chol, w, pp, n, rebalance=True,
                                                    **kw),
                     lambda: multi_dd_reference(11, mean, chol, w, pp, n, rebalance=True, **kw),
                     lambda k, pl: multi_dd_shares(k, pl, None, chol, mean, n, True,
                                                   "float32")),
        "merton_multi_dd": (lambda: merton_multi_portfolio_dd(*margs, **kw),
                            lambda: merton_multi_dd_reference(*margs, **kw),
                            lambda k, pl: merton_shares(k, pl, chol, mean, sigj, n)),
        "garch_terminal": (lambda: G.garch_terminal(11, g, p, n, **kw),
                           lambda: G.garch_terminal_reference(11, g, p, n, **kw),
                           lambda k, pl: G.garch_shares(k, pl, g, n)),
        "garch_multi_dd": (lambda: G.garch_multi_portfolio_dd(11, g, w, pp, n, **kw),
                           lambda: G.garch_multi_dd_reference(11, g, w, pp, n, with_bound=True,
                                                              **kw),
                           lambda k, pl: G.garch_shares(k, pl, g, n)),
        "bootstrap_terminal": (lambda: B.bootstrap_terminal(11, hist, p, n, **kw),
                               lambda: B.bootstrap_terminal_reference(11, hist, p, n, **kw),
                               None),
        "bootstrap_multi_dd": (lambda: B.bootstrap_multi_portfolio_dd(11, hist, w, pp, n, **kw),
                               lambda: B.bootstrap_multi_dd_reference(11, hist, w, pp, n, **kw),
                               lambda k, pl: B.bootstrap_shares(k, pl, hist, w, n)),
        "heston_terminal": (lambda: H.heston_terminal(11, h, p, n, **kw),
                            lambda: H.heston_terminal_reference(11, h, p, n, **kw),
                            lambda k, pl: H.heston_shares(k, pl, h, n)),
        "heston_multi_dd": (lambda: H.heston_multi_portfolio_dd(11, h, w, pp, n, **kw),
                            lambda: H.heston_multi_dd_reference(11, h, w, pp, n, **kw),
                            lambda k, pl: H.heston_shares(k, pl, h, n)),
    }


def _dcc_wide_calls(a: int, dev, p: int, n: int, w_cnt: int, nb: int = 2):
    from mcport_torch.ops import dcc as D

    kw = dict(first_block=6, n_blocks=nb)
    d = bench_dcc(a).tensors(dev)
    w = torch.as_tensor(np.random.default_rng(a).dirichlet(np.ones(a), w_cnt),
                        dtype=torch.float32, device=dev)
    return {"dcc_terminal": (lambda: D.dcc_terminal(11, d, p, n, **kw),
                             lambda: D.dcc_terminal_reference(11, d, p, n, **kw),
                             lambda k, pl: D.dcc_shares(k, pl, d, n)),
            "dcc_dd": (lambda: D.dcc_multi_portfolio_dd(11, d, w, p, n, **kw),
                       lambda: D.dcc_multi_dd_reference(11, d, w, p, n, **kw),
                       lambda k, pl: D.dcc_shares(k, pl, d, n))}


def phase_wide_any(dev) -> tuple[dict, dict, dict]:
    """Phase 22, widths past 64: every kernel at A = 65 and 200 (DCC 65 and
    256, where Q leaves shared memory) on the bench universe widened,
    against its plain form on the card with today's bounds (the bootstrap
    terminal and one-hot candidates bit for bit, Heston's path state through
    heston_shares' four ulps, #8 at rate 0 equal to #3 and #3 with one
    candidate equal to #2); the hedged #3, #5, #7 and #8 at A = 65; then the
    main paths at 65 assets with every wrapper's wide count reset before and
    read after: path_tail_risk for the seven families, compare_tail_risk
    (the terminal kernels), gbm_risk and a GBM frontier. Returns each wide
    layout's worst |kernel - plain| and its launches on that run."""
    from mcport_torch.api import compare_tail_risk, gbm_risk, path_tail_risk
    from mcport_torch.config import Config, GBMConfig
    from mcport_torch.engine.drawdown_frontier import drawdown_frontier_search
    from mcport_torch.models.gbm import estimate_gbm
    from mcport_torch.ops import bootstrap as B
    from mcport_torch.ops.jump import (merton_multi_dd_reference, merton_multi_portfolio_dd,
                                       merton_shares)
    from mcport_torch.ops.multi_dd import (gbm_multi_portfolio_dd, multi_dd_reference,
                                           multi_dd_shares)

    worst: dict = {}
    held = _held_printer("phase22", worst)
    for a in WIDE_A:
        calls = _wide_calls(a, dev, WIDE_TERM, WIDE_CAND, WIDE_STEPS, 64)
        for name, (kern, plain, shares) in calls.items():
            k, p = kern(), plain()
            what = f"A={a} {'64 x ' if 'dd' in name else ''}2 blocks x {WIDE_STEPS}"
            if shares is None:
                same = torch.equal(k, p)
                print(f"phase22 {name} wide {what}: bit for bit={same}")
                check(same, f"{name} wide at A={a} is its plain form")
                worst[name] = max(worst.get(name, 0.0), 0.0)
            else:
                held(name, what, k, p, shares(k, p))
            del k, p
        # the bit-identical pairs: #3 at one candidate is #2, #8 at rate 0 is
        # #3 rebalanced, one-hot bootstrap candidates select the plain rows
        mean, chol = (torch.as_tensor(x, device=dev) for x in bench_universe(a))
        w1 = torch.full((a,), 1.0 / a, device=dev)
        kw = dict(first_block=6, n_blocks=2)
        ps = calls["path_stats"][0]()
        one = gbm_multi_portfolio_dd(11, mean, chol, w1[None], WIDE_TERM, WIDE_STEPS, **kw)
        _, _, muj, sigj = _merton_tensors(bench_merton(a), dev)
        w = torch.as_tensor(np.random.default_rng(a).dirichlet(np.ones(a), 64),
                            dtype=torch.float32, device=dev)
        j0 = merton_multi_portfolio_dd(11, mean, chol, 0.0, muj, sigj, w, WIDE_CAND,
                                       WIDE_STEPS, **kw)
        m3 = gbm_multi_portfolio_dd(11, mean, chol, w, WIDE_CAND, WIDE_STEPS, rebalance=True,
                                    **kw)
        hist = torch.as_tensor(bench_history(a), device=dev)
        k7, _ = B.bootstrap_multi_portfolio_dd(11, hist, torch.eye(a, device=dev)[:9], WIDE_CAND,
                                               WIDE_STEPS, **kw)
        p6 = B.bootstrap_terminal_reference(11, hist, WIDE_CAND, WIDE_STEPS, **kw)
        same = (torch.equal(one[0][:, 0], ps[1]) and torch.equal(one[1][:, 0], ps[2]),
                torch.equal(j0[0], m3[0]) and torch.equal(j0[1], m3[1]),
                torch.equal(k7, p6[..., :9].transpose(1, 2)))
        print(f"phase22 A={a} bit for bit: #3 one candidate = #2 {same[0]}, #8 rate 0 = #3 "
              f"{same[1]}, #7 one-hot = #6's plain rows {same[2]}")
        check(all(same), f"the bit-identical wide kernels at A={a}")
    for a in DCC_WIDE_A:
        for name, (kern, plain, shares) in _dcc_wide_calls(a, dev, *DCC_WIDE, 64).items():
            k, p = kern(), plain()
            held(name, f"A={a} {'64 x ' if name == 'dcc_dd' else ''}2 blocks x {DCC_WIDE[1]}",
                 k, p, shares(k, p))
    # the hedged modes at 65 assets: 2 legs of every type, 64 candidates
    hw = {}
    a = WIDE_A[0]
    hedge = leg_mix(a, 2, dev, seed=a)
    for name, (kern, plain, shares) in _family_hedged_calls(a, dev, hedge, WIDE_CAND, 60,
                                                            64).items():
        k, p = kern(), plain()
        err = _hedged_report("phase22", name, f"A={a} L=2 W=64 2 blocks x 60", k, p,
                             shares(k, p))
        hw[name + (" wide" if name in ("heston_multi_dd_hedged", "dcc_dd_hedged") else "")] = err
    mean, chol = (torch.as_tensor(x, device=dev) for x in bench_universe(a))
    w = torch.as_tensor(np.random.default_rng(a).dirichlet(np.ones(a), 64),
                        dtype=torch.float32, device=dev)
    _, _, muj, sigj = _merton_tensors(bench_merton(a), dev)
    kw = dict(first_block=6, n_blocks=2, hedge=hedge)
    k = gbm_multi_portfolio_dd(11, mean, chol, w, WIDE_CAND, 60, **kw)
    p = multi_dd_reference(11, mean, chol, w, WIDE_CAND, 60, with_bound=True, **kw)
    hw["multi_dd_hedged"] = _hedged_report(
        "phase22", "multi_dd_hedged", f"A={a} L=2 W=64 2 blocks x 60", k, p,
        multi_dd_shares(k, p, None, chol, mean, 60, True, "float32", hedge))
    margs = (11, mean, chol, 0.3, muj, sigj, w, WIDE_CAND, 60)
    k = merton_multi_portfolio_dd(*margs, **kw)
    p = merton_multi_dd_reference(*margs, with_bound=True, **kw)
    hw["merton_multi_dd_hedged"] = _hedged_report(
        "phase22", "merton_multi_dd_hedged", f"A={a} L=2 W=64 rate 0.3 2 blocks x 60", k, p,
        merton_shares(k, p, chol, mean, sigj, 60, hedge))

    # the main paths at 65 assets: counts reset just before, read just after
    wrappers = _wide_wrappers()
    for fn in wrappers.values():
        fn.wide_launches = 0
    data = universe65()
    cfg = Config(gbm=GBMConfig(n_steps=DCC_STEPS))
    t0 = time.perf_counter()
    tails = {m: path_tail_risk(data, None, cfg, model=m, device=dev)
             for m in ("gbm", "student_t", "garch", "dcc", "jump", "heston", "bootstrap")}
    compare = compare_tail_risk(data, None, cfg, device=dev)
    params = estimate_gbm(data.prices)
    risk = gbm_risk(params, None, cfg, device=dev)
    front = drawdown_frontier_search(FRONTIER_SEED, params, dd_budget=1.0, n_candidates=512,
                                     n_paths=16_384, n_steps=DCC_STEPS, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.wide_launches for name, fn in wrappers.items()}
    print(f"phase22 65 assets: path_tail_risk x 7, compare_tail_risk, gbm_risk and a 512 x "
          f"16,384 frontier in {wall:.2f} s (estimation included), wide launches {launches}")
    check(all(n > 0 for n in launches.values()),
          "the 65-asset main paths went through every kernel's wide layout")
    for m, out in tails.items():
        print(f"phase22 path_tail_risk {m} at 65 assets: {json.dumps(out)}")
        check(out["cvar"] <= out["var"] and -1.0 <= out["dd_p95"] <= out["dd_median"] <= 0.0,
              f"path_tail_risk {m} at 65 assets")
    print(f"phase22 compare_tail_risk at 65 assets: {json.dumps(compare)}")
    check(len(compare) == 7 and all("error" not in v and v["cvar"] <= v["var"]
                                    for v in compare.values()),
          "compare_tail_risk reports seven families at 65 assets")
    check(risk.cvar <= risk.var and front.opt_idx >= 0, "gbm_risk and the frontier at 65")
    for model in ("heston", "dcc"):
        launches[HEDGED_KERNEL[model]] = _hedged_at_65(dev, hw, model)
    return worst, launches, hw


def _hedged_at_65(dev, worst: dict, model: str) -> int:
    """Hedged Heston or DCC at 65 assets through its main paths, the bench
    hedge on assets 0 and 1 at spot 100 (Heston's parameters' own): path
    risk at the default cell and a 256 x 16,384 hedged frontier, 52 steps
    (DCC 16: its plain form costs A^3 per step), the hedged count reset just
    before and read just after (every launch at 65 assets runs the wide
    layout's hedged mode: ``HestonWide<true, true>``, ``dcc_group_kernel<128,
    true, true, true, true>``); then each launch against the plain form over a head
    slice (DCC's 1,024 paths). Returns the hedged launches."""
    from mcport_torch.config import GBMConfig
    from mcport_torch.engine.drawdown_frontier import (family_drawdown_frontier_search,
                                                       frontier_seeds)
    from mcport_torch.engine.path_risk import run_dcc_path_risk, run_heston_path_risk
    from mcport_torch.ops.dcc import dcc_multi_portfolio_dd
    from mcport_torch.ops.dirichlet import sample_weights
    from mcport_torch.ops.heston import heston_multi_portfolio_dd

    a, kernel = WIDE_A[0], HEDGED_KERNEL[model]
    spot = np.full(a, SPOT)
    if model == "heston":
        params, run, wrapper, steps, piece = (bench_heston(a), run_heston_path_risk,
                                              heston_multi_portfolio_dd, DCC_STEPS, SLICE)
        spots = {}
    else:
        params, run, wrapper, steps, piece = (bench_dcc(a), run_dcc_path_risk,
                                              dcc_multi_portfolio_dd, 16, 1_024)
        spots = dict(s0=spot)
    _, spec = bench_hedge(spot)
    w = np.full(a, 1.0 / a)
    cfg = GBMConfig(n_steps=steps)
    front_kw = dict(dd_budget=1.0, n_candidates=256, n_paths=16_384, n_steps=steps)
    wrapper.hedged_launches = 0
    t0 = time.perf_counter()
    rep = run(params, w, cfg, hedge=spec, device=dev, **spots)
    front = family_drawdown_frontier_search(FRONTIER_SEED, model, params, hedge=spec, s0=spot,
                                            device=dev, **front_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = wrapper.hedged_launches
    print(f"phase22 hedged {model} at {a} assets: path risk {cfg.n_paths} x {cfg.n_steps} "
          f"var={rep.var:.6f} dd_p95={rep.dd_p95:.6f}, frontier 256 x 16,384 opt="
          f"{front.opt_idx}, in {wall:.2f} s; hedged (wide) launches {n}")
    check(n > 0 and rep.cvar <= rep.var and -1.0 <= rep.dd_p95 <= 0.0 and front.opt_idx >= 0,
          f"hedged {model} at 65 assets went through its wide layout's hedged mode")
    path_seed, weight_seed = frontier_seeds(FRONTIER_SEED)
    gen = torch.Generator(device=dev).manual_seed(weight_seed)
    cand, _ = sample_weights(gen, 256, np.zeros(a), np.ones(a))
    src = params.tensors(dev)
    for what, launch in (
            ("path risk default", dict(kernel=kernel, seed=cfg.seed, n=cfg.path_block,
                                       w=w[None], first_block=0,
                                       n_blocks=cfg.n_paths // cfg.path_block)),
            ("frontier", dict(kernel=kernel, seed=path_seed, n=front_kw["n_paths"], w=cand))):
        launch.update(src=src, s0=spot, steps=steps)
        kk = _family_hedged_call(launch, dev, plain=False)
        m = min(piece, launch["n"])
        for p0 in _slices(launch["n"], m):
            part = (kk[0][..., p0:p0 + m], kk[1][..., p0:p0 + m])
            p = _family_hedged_call(launch, dev, plain=True, n=m, first_path=p0)
            err = _hedged_report("phase22", f"{kernel} wide",
                                 f"A={a} {what} paths {p0}..{p0 + m - 1}", part, p,
                                 _family_hedged_shares(launch, part, p, dev))
            worst[f"{kernel} wide"] = max(worst.get(f"{kernel} wide", 0.0), err)
    return n


def _same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Equal bit for bit, a NaN (overflowed hedged wealth) equal to a NaN."""
    return x.shape == y.shape and bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())


EDGE_PATHS: dict = {}   # per hedged kernel: paths finite on one side only, at float32's edge


def _hedged_report(prefix, name, what, kern, plain, shares) -> float:
    """Print and check one hedged comparison (ops.hedged.hedged_held's
    counts): every path within its bound, none astray; a path whose wealth
    crossed float32's largest value on one side only, within the bound of
    it (an edge path, ``ops.hedged._overflow``), is counted in EDGE_PATHS.
    Returns the worst |kernel - plain| of the finite paths."""
    from mcport_torch.ops.hedged import hedged_held

    c = hedged_held(kern, plain)
    print(f"{prefix} {name} {what} max_abs={c['max_abs']:.3e} max_rel={c['max_rel']:.3e} "
          f"paths finite={c['finite']} overflowed={c['overflowed']} edge={c['edge']} "
          f"astray={c['astray']} shares=" + " ".join(f"{n}={v:.4f}" for n, v in shares.items()))
    check(max(shares.values()) <= 1.0 and c["astray"] == 0, f"{name} kernel vs plain, {what}")
    EDGE_PATHS[name] = EDGE_PATHS.get(name, 0) + c["edge"]
    return c["max_abs"]


def _family_hedged_calls(a, dev, hedge, n, steps, w_cnt, rows=365, seed=11, w=None, nb=2):
    """``{name: (kernel(), plain(), shares(k, p))}`` of the hedged GARCH,
    bootstrap, Heston and DCC modes at ``a`` assets, with the plain forms'
    per-path bound."""
    from mcport_torch.ops import bootstrap as B
    from mcport_torch.ops import dcc as D
    from mcport_torch.ops import garch as G
    from mcport_torch.ops import heston as H

    if w is None:
        w = torch.as_tensor(np.random.default_rng(w_cnt).dirichlet(np.ones(a), w_cnt),
                            dtype=torch.float32, device=dev)
    kw = dict(first_block=6, n_blocks=nb, hedge=hedge)
    g, h, d = bench_garch(a).tensors(dev), bench_heston(a).tensors(dev), bench_dcc(a).tensors(dev)
    hist = torch.as_tensor(np.random.default_rng(8).normal(1e-3, 0.02, (rows, a)),
                           dtype=torch.float32, device=dev)
    return {"garch_multi_dd_hedged": (
                lambda: G.garch_multi_portfolio_dd(seed, g, w, n, steps, **kw),
                lambda: G.garch_multi_dd_reference(seed, g, w, n, steps, with_bound=True, **kw),
                lambda k, p: G.garch_shares(k, p, g, steps, hedge=hedge)),
            "bootstrap_multi_dd_hedged": (
                lambda: B.bootstrap_multi_portfolio_dd(seed, hist, w, n, steps, **kw),
                lambda: B.bootstrap_multi_dd_reference(seed, hist, w, n, steps,
                                                       with_bound=True, **kw),
                lambda k, p: B.bootstrap_shares(k, p, hist, w, steps, hedge=hedge)),
            "heston_multi_dd_hedged": (
                lambda: H.heston_multi_portfolio_dd(seed, h, w, n, steps, **kw),
                lambda: H.heston_multi_dd_reference(seed, h, w, n, steps, with_bound=True, **kw),
                lambda k, p: H.heston_shares(k, p, h, steps, hedge=hedge)),
            "dcc_dd_hedged": (
                lambda: D.dcc_multi_portfolio_dd(seed, d, w, n, steps, **kw),
                lambda: D.dcc_multi_dd_reference(seed, d, w, n, steps, with_bound=True, **kw),
                lambda k, p: D.dcc_shares(k, p, d, steps, hedge=hedge))}


def family_hedged_launches(dev) -> list[dict]:
    """Every distinct hedged launch of kernels #5, #7, #10 and #13 that phase
    24 makes through the API (the CLI's run on the fixtures is checked by its
    counts): path risk at both cells, path_tail_risk (parameters estimated
    from ``bench_prices``, spots its last prices) and every 256-candidate
    chunk of the four frontiers at 252 and 52 steps."""
    from mcport_torch.config import GBMConfig
    from mcport_torch.engine.drawdown_frontier import frontier_seeds
    from mcport_torch.models.garch_mc import estimate_ccc_garch
    from mcport_torch.ops.dirichlet import sample_weights

    garch, hist = bench_garch().tensors(dev), torch.as_tensor(bench_history(), device=dev)
    heston = bench_heston().tensors(dev)   # spots 100: SPOT, the run's default s0
    srcs = (("garch_multi_dd_hedged", garch), ("bootstrap_multi_dd_hedged", hist),
            ("heston_multi_dd_hedged", heston), ("dcc_dd_hedged", bench_dcc().tensors(dev)))
    w = bench_weights()[None]
    spot = np.full(N_ASSETS, SPOT)
    out = []
    for name, g in cells().items():
        for kernel, src in srcs:
            out.append(dict(kernel=kernel, what=f"path risk {name}", seed=g.seed, n=g.path_block,
                            w=w, first_block=0, n_blocks=g.n_paths // g.path_block, src=src,
                            s0=spot))
    prices = bench_prices()
    g = GBMConfig()
    tail = dict(seed=g.seed, n=g.path_block, w=np.full((1, N_ASSETS), 1.0 / N_ASSETS),
                first_block=0, n_blocks=g.n_paths // g.path_block, s0=prices.prices[-1])
    out.append(dict(kernel="garch_multi_dd_hedged", what="path_tail_risk garch",
                    src=estimate_ccc_garch(prices.port_rets).tensors(dev), **tail))
    out.append(dict(kernel="bootstrap_multi_dd_hedged", what="path_tail_risk bootstrap",
                    src=torch.as_tensor(prices.port_rets, dtype=torch.float32, device=dev),
                    **tail))
    out.append(dict(kernel="heston_multi_dd_hedged", what="path_tail_risk heston",
                    src=fitted_families()["heston"].tensors(dev), **tail))
    out.append(dict(kernel="dcc_dd_hedged", what="path_tail_risk dcc",
                    src=fitted_dcc()["dcc"].tensors(dev), **tail))
    path_seed, weight_seed = frontier_seeds(FRONTIER_SEED)
    gen = torch.Generator(device=dev).manual_seed(weight_seed)
    cand, _ = sample_weights(gen, FRONTIER["n_candidates"], np.zeros(N_ASSETS),
                             np.ones(N_ASSETS))
    for steps in HEDGED_FRONTIER_STEPS:   # each frontier's 16 launches of 256 candidates
        for kernel, src in srcs:
            out.append(dict(kernel=kernel, what=f"frontier {steps} steps, 16 chunks",
                            seed=path_seed, n=FRONTIER["n_paths"], w=cand, src=src, s0=spot,
                            steps=steps))
    for launch in out:
        launch.setdefault("steps", N_STEPS)
    return out


def _family_hedged_call(launch, dev, plain: bool, n=None, first_path=0, bound=True):
    """One launch of ``family_hedged_launches`` through the kernel, or its
    plain form over ``n`` paths from ``first_path`` (with its per-path bound
    unless ``bound`` is false)."""
    from mcport_torch.ops import bootstrap as B
    from mcport_torch.ops import dcc as D
    from mcport_torch.ops import garch as G
    from mcport_torch.ops import heston as H
    from mcport_torch.ops.hedged import HedgeTensors

    _, spec = bench_hedge(launch["s0"])
    hedge = HedgeTensors.from_spec(spec, launch["s0"], dev)
    w = torch.as_tensor(launch["w"], dtype=torch.float32, device=dev)
    kw = dict(first_block=launch.get("first_block", -1), n_blocks=launch.get("n_blocks", 1),
              hedge=hedge)
    n = launch["n"] if n is None else n
    args = (launch["seed"], launch["src"], w, n, launch["steps"])
    if launch["kernel"] == "garch_multi_dd_hedged":
        if plain:
            return G.garch_multi_dd_reference(*args, first_path=first_path, with_bound=bound,
                                              **kw)
        return G.garch_multi_portfolio_dd(*args, **kw)
    if launch["kernel"] == "heston_multi_dd_hedged":
        if plain:
            return H.heston_multi_dd_reference(*args, first_path=first_path, with_bound=bound,
                                               **kw)
        return H.heston_multi_portfolio_dd(*args, **kw)
    if launch["kernel"] == "dcc_dd_hedged":
        if plain:
            return D.dcc_multi_dd_reference(*args, first_path=first_path, with_bound=bound, **kw)
        return D.dcc_multi_portfolio_dd(*args, **kw)
    if plain:
        return B.bootstrap_multi_dd_reference(*args, first_path=first_path, with_bound=bound,
                                              **kw)
    return B.bootstrap_multi_portfolio_dd(*args, **kw)


def _family_hedged_shares(launch, kern, plain, dev):
    from mcport_torch.ops import bootstrap as B
    from mcport_torch.ops import dcc as D
    from mcport_torch.ops import garch as G
    from mcport_torch.ops import heston as H
    from mcport_torch.ops.hedged import HedgeTensors

    _, spec = bench_hedge(launch["s0"])
    hedge = HedgeTensors.from_spec(spec, launch["s0"], dev)
    if launch["kernel"] == "garch_multi_dd_hedged":
        return G.garch_shares(kern, plain, launch["src"], launch["steps"], hedge=hedge)
    if launch["kernel"] == "heston_multi_dd_hedged":
        return H.heston_shares(kern, plain, launch["src"], launch["steps"], hedge=hedge)
    if launch["kernel"] == "dcc_dd_hedged":
        return D.dcc_shares(kern, plain, launch["src"], launch["steps"], hedge=hedge)
    w = torch.as_tensor(launch["w"], dtype=torch.float32, device=dev)
    return B.bootstrap_shares(kern, plain, launch["src"], w, launch["steps"], hedge=hedge)


def phase_family_hedged_kernels(dev) -> dict:
    """Phase 23: the hedged modes of kernels #5, #7, #10 and #13 against
    their plain forms, path by path to the per-path bound
    (``ops.garch.garch_price_bound``, ``ops.bootstrap.bootstrap_price_bound``:
    the bootstrap's prices are the plain form's bit for bit;
    ``ops.heston.heston_price_bound``; ``ops.dcc.dcc_price_bound``, from each
    path's own volatility and condition): 1-3 legs of every type, W in {1,
    13, 256}, the bootstrap on a 365-row history (shared memory) and an
    8,192-row one (device memory); one-hot bootstrap candidates bit for bit;
    an identity hedge against the unhedged mode (Heston's at the bench's vol
    of vol and a Feller-violating one, where a variance path one ulp off
    would leave the bound); hedged #10 on the bench hedge at every width
    (``HESTON_HEDGED_A``) at 16, 52 and 252 steps, hedged #13 at every width
    (``DCC_HEDGED_A``) at 16 and 52 steps and 252 up to 16 assets, and at W =
    5 and 257 (past one launch); deep puts that overflow #13's wealth; then
    every hedged launch of phase 24 over a head slice of each
    block's paths. The GARCH candidate kernel draws normal shocks only, as
    mcport's does. Returns each kernel's worst |kernel - plain| (hedged #10
    and #13 past 64 assets under ``"heston_multi_dd_hedged wide"`` and
    ``"dcc_dd_hedged wide"``)."""
    from mcport_torch.ops import bootstrap as B
    from mcport_torch.ops import dcc as D
    from mcport_torch.ops import garch as G
    from mcport_torch.ops import heston as H
    from mcport_torch.ops.hedged import HedgeTensors
    from mcport_torch.options import HedgeSpec

    worst: dict = {}

    def keep(name, err):
        worst[name] = max(worst.get(name, 0.0), err)

    for n_legs in (1, 2, 3):
        hedge = leg_mix(N_ASSETS, n_legs, dev, seed=n_legs)
        for n_cand in (1, 13, 256):
            for rows in (365, LONG_HISTORY):
                calls = _family_hedged_calls(N_ASSETS, dev, hedge, MDD_PATHS, 60, n_cand,
                                             rows=rows)
                for name, (kern, plain, shares) in calls.items():
                    if not name.startswith("bootstrap") and rows != 365:
                        continue
                    k, p = kern(), plain()
                    keep(name, _hedged_report("phase23", name, f"L={n_legs} W={n_cand} "
                                              f"{rows}-row history {MDD_PATHS}x2 x 60"
                                              if name.startswith("boot") else
                                              f"L={n_legs} W={n_cand} {MDD_PATHS}x2 x 60",
                                              k, p, shares(k, p)))
    # one-hot bootstrap candidates: the prices and the settlement bit for bit
    hist = torch.as_tensor(bench_history(), device=dev)
    hedge = leg_mix(N_ASSETS, 3, dev, seed=5)
    eye = torch.eye(N_ASSETS, device=dev)
    k = B.bootstrap_multi_portfolio_dd(4, hist, eye, MDD_PATHS, N_STEPS, hedge=hedge)
    p = B.bootstrap_multi_dd_reference(4, hist, eye, MDD_PATHS, N_STEPS, hedge=hedge)
    same = _same_bits(k[0], p[0]) and _same_bits(k[1], p[1])
    print(f"phase23 bootstrap hedged one-hot candidates, L=3 {MDD_PATHS} x {N_STEPS}: the "
          f"plain form bit for bit={same}")
    check(same, "the hedged bootstrap's prices and settlement are the plain form's")
    # hedged #10 and #13 at every width on the bench hedge (spot 100): #10
    # <16> at 15, <64> at 17 and 64, HestonWide at 65 and 200; #13 as
    # DCC_HEDGED_A says
    for name, widths, bound in (("heston_multi_dd_hedged", HESTON_HEDGED_A, "heston_price_bound"),
                                ("dcc_dd_hedged", DCC_HEDGED_A, "dcc_price_bound")):
        top = 0.0
        for a in widths:
            spot = np.full(a, SPOT)
            hedge = HedgeTensors.from_spec(bench_hedge(spot)[1], spot, dev)
            n = MDD_PATHS if name.startswith("heston") else DCC_HEDGED_PATHS.get(a, MDD_PATHS)
            steps_all = (HESTON_HEDGED_STEPS if name.startswith("heston")
                         else (16, DCC_STEPS) + ((N_STEPS,) if a <= 16 else ()))
            for steps in steps_all:
                kern, plain, shares = _family_hedged_calls(a, dev, hedge, n, steps, 64)[name]
                k, p = kern(), plain()
                sh = shares(k, p)
                top = max(top, *sh.values())
                err = _hedged_report("phase23", name, f"bench hedge A={a} W=64 {n}x2 x {steps}",
                                     k, p, sh)
                keep(name + (" wide" if a > 64 else ""), err)
                del k, p
        print(f"phase23 {name} on the bench hedge at A = {widths}: the largest share of "
              f"{bound}'s per-path bound {top:.4f}")
    # hedged #13 past one launch's 256 candidates, and deep in-the-money puts
    # settled every step, which overflow the wealth on both sides
    spot = np.full(N_ASSETS, SPOT)
    hedge = HedgeTensors.from_spec(bench_hedge(spot)[1], spot, dev)
    for n_cand in (5, 257):
        kern, plain, shares = _family_hedged_calls(N_ASSETS, dev, hedge, MDD_PATHS, DCC_STEPS,
                                                   n_cand)["dcc_dd_hedged"]
        k, p = kern(), plain()
        keep("dcc_dd_hedged", _hedged_report("phase23", "dcc_dd_hedged", f"bench hedge "
                                             f"W={n_cand} {MDD_PATHS}x2 x {DCC_STEPS}", k, p,
                                             shares(k, p)))
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    puts = HedgeTensors(f(np.full(N_ASSETS, 100.0)),
                        torch.full((N_ASSETS, 2), 4, dtype=torch.int32, device=dev),
                        f(np.full((N_ASSETS, 2), 99.0)), f(np.zeros((N_ASSETS, 2))),
                        f(np.full((N_ASSETS, 2), 3.0)))
    kern, plain, shares = _family_hedged_calls(N_ASSETS, dev, puts, 2_053, N_STEPS, 13,
                                               nb=1)["dcc_dd_hedged"]
    k, p = kern(), plain()
    _hedged_report("phase23", "dcc_dd_hedged", f"deep puts W=13 2053 x {N_STEPS}", k, p,
                   shares(k, p))
    check(int((~torch.isfinite(p[0])).sum()) > 0, "hedged #13 carries overflowed wealth")
    # an identity hedge (one BUY_ASSET leg per asset) is the unhedged mode
    ident = HedgeTensors.from_spec(HedgeSpec.build(None, [str(i) for i in range(N_ASSETS)]),
                                   np.linspace(10.0, 200.0, N_ASSETS), dev)
    w = torch.as_tensor(np.random.default_rng(3).dirichlet(np.ones(N_ASSETS), 256),
                        dtype=torch.float32, device=dev)
    g, d = bench_garch().tensors(dev), bench_dcc().tensors(dev)
    hs = {xi: bench_heston(xi=xi).tensors(dev) for xi in (3e-3, FELLER_XI)}

    def heston_identity(h):
        return (lambda: H.heston_multi_portfolio_dd(5, h, w, MDD_PATHS, N_STEPS, hedge=ident),
                lambda: H.heston_multi_portfolio_dd(5, h, w, MDD_PATHS, N_STEPS),
                lambda: H.heston_multi_dd_reference(5, h, w, MDD_PATHS, N_STEPS, hedge=ident,
                                                    with_bound=True)[2],
                lambda k, r: H.heston_shares(k, r, h, N_STEPS, hedge=ident))

    for name, kern, unh, bnd, shares in (
            ("heston", *heston_identity(hs[3e-3])),
            (f"heston (xi {FELLER_XI}, Feller violated)", *heston_identity(hs[FELLER_XI])),
            ("garch", lambda: G.garch_multi_portfolio_dd(5, g, w, MDD_PATHS, N_STEPS, hedge=ident),
             lambda: G.garch_multi_portfolio_dd(5, g, w, MDD_PATHS, N_STEPS),
             lambda: G.garch_multi_dd_reference(5, g, w, MDD_PATHS, N_STEPS, hedge=ident,
                                                with_bound=True)[2],
             lambda h, r: G.garch_shares(h, r, g, N_STEPS, hedge=ident)),
            ("bootstrap",
             lambda: B.bootstrap_multi_portfolio_dd(5, hist, w, MDD_PATHS, N_STEPS, hedge=ident),
             lambda: B.bootstrap_multi_portfolio_dd(5, hist, w, MDD_PATHS, N_STEPS),
             lambda: B.bootstrap_multi_dd_reference(5, hist, w, MDD_PATHS, N_STEPS, hedge=ident,
                                                    with_bound=True)[2],
             lambda h, r: B.bootstrap_shares(h, r, hist, w, N_STEPS, hedge=ident)),
            ("dcc", lambda: D.dcc_multi_portfolio_dd(5, d, w, MDD_PATHS, N_STEPS, hedge=ident),
             lambda: D.dcc_multi_portfolio_dd(5, d, w, MDD_PATHS, N_STEPS),
             lambda: D.dcc_multi_dd_reference(5, d, w, MDD_PATHS, N_STEPS, hedge=ident,
                                              with_bound=True)[2],
             lambda h, r: D.dcc_shares(h, r, d, N_STEPS, hedge=ident))):
        h, r = kern(), unh()
        sh = shares(h, (*r, bnd()))
        print(f"phase23 {name} identity hedge vs the unhedged mode, W=256 {MDD_PATHS} x "
              f"{N_STEPS}: max_abs={max(float((x - y).abs().max()) for x, y in zip(h, r)):.3e} "
              "shares=" + " ".join(f"{n}={v:.4f}" for n, v in sh.items()))
        check(max(sh.values()) <= 1.0, f"a {name} identity hedge is the unhedged mode")
    # every launch of phase 24, over a head slice of each block
    for launch in family_hedged_launches(dev):
        kk = _family_hedged_call(launch, dev, plain=False)
        for p0 in _slices(launch["n"]):
            m = min(SLICE, launch["n"])
            part = (kk[0][..., p0:p0 + m], kk[1][..., p0:p0 + m])
            p = _family_hedged_call(launch, dev, plain=True, n=m, first_path=p0)
            keep(launch["kernel"], _hedged_report(
                "phase23", launch["kernel"], f"{launch['what']} paths {p0}..{p0 + m - 1}", part,
                p, _family_hedged_shares(launch, part, p, dev)))
        del kk
    print(f"phase23 paths at float32's edge (finite on one side only, within the bound): "
          f"{EDGE_PATHS}")
    return worst


def _fixture_cli_family_hedged(dev, tmp: Path) -> dict:
    """``path-risk --hedge --models garch,bootstrap,heston,dcc`` and
    ``dd-frontier --model garch|bootstrap|heston|dcc --hedge`` on the weekly
    fixtures, 52 weekly steps; each command's JSON."""
    runs = {"path-risk --hedge": ["path-risk", "--models", "garch,bootstrap,heston,dcc",
                                  "--paths", str(CLI_PATHS), "--steps", "52"]}
    for m in ("garch", "bootstrap", "heston", "dcc"):
        runs[f"dd-frontier --model {m} --hedge"] = [
            "dd-frontier", "--model", m, "--candidates", str(CLI_FRONTIER[0]), "--paths",
            str(CLI_FRONTIER[1]), "--steps", "52", "--dd-budget", "1.0"]
    return _fixture_cli_hedged(dev, tmp, runs)


def phase_family_hedged_tier(dev) -> dict:
    """Phase 24, the hedged GARCH, Heston, bootstrap and DCC main paths with
    the bench hedge (a married put on asset 0 and a collar on asset 1, spot
    100, Heston's default spots): path risk at both cells with split +
    resume, path_tail_risk for the four families, the four hedged frontiers
    at 4,096 x 131,072 x 252 and at 52 steps, each with a budget that binds,
    and the CLI's hedged path-risk and dd-frontier for the four on the
    fixtures; the hedged counts reset before and read after; then the
    drawdown quantiles and each frontier's optimum against the plain
    forms."""
    from mcport_torch.api import path_tail_risk
    from mcport_torch.config import Config
    from mcport_torch.engine.drawdown_frontier import family_drawdown_frontier_search
    from mcport_torch.engine.path_risk import (run_bootstrap_path_risk, run_dcc_path_risk,
                                               run_garch_path_risk, run_heston_path_risk,
                                               run_resumable_path_risk)
    from mcport_torch.ops.bootstrap import bootstrap_multi_portfolio_dd
    from mcport_torch.ops.dcc import dcc_multi_portfolio_dd
    from mcport_torch.ops.garch import garch_multi_portfolio_dd
    from mcport_torch.ops.heston import heston_multi_portfolio_dd

    params, hist, w = bench_garch(), bench_history(), bench_weights()
    heston = bench_heston()   # its spots are SPOT: run_heston_path_risk's default s0
    spot = np.full(N_ASSETS, SPOT)
    _, spec = bench_hedge(spot)
    prices = bench_prices()
    tail_legs, _ = bench_hedge(prices.prices[-1])
    counted = {"garch_multi_dd_hedged": garch_multi_portfolio_dd,
               "bootstrap_multi_dd_hedged": bootstrap_multi_portfolio_dd,
               "heston_multi_dd_hedged": heston_multi_portfolio_dd,
               "dcc_dd_hedged": dcc_multi_portfolio_dd}
    models = (("garch", run_garch_path_risk, params), ("bootstrap", run_bootstrap_path_risk, hist),
              ("heston", run_heston_path_risk, heston), ("dcc", run_dcc_path_risk, bench_dcc()))
    fitted_dcc()   # the DCC estimation of path_tail_risk, once, outside its wall

    def timed(fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def walls(fn, *a, **kw):
        out, first = timed(fn, *a, **kw)
        return out, (first, timed(fn, *a, **kw)[1])

    for fn in counted.values():
        fn.hedged_launches = 0
    reports, resumes, wall = {}, {}, {}
    for name, g in cells().items():
        nb = g.n_paths // g.path_block
        for model, run, src in models:
            key = f"{model} {name}"
            # Heston's spots default to the parameters' own (SPOT), as a user's call
            kw = {} if model == "heston" else dict(s0=spot)
            reports[key], wall[key] = walls(run, src, w, g, hedge=spec, device=dev, **kw)
            _, part = run_resumable_path_risk(model, src, w, g, hedge=spec, max_blocks=nb // 3,
                                              device=dev, **kw)
            resumes[key] = run_resumable_path_risk(model, src, w, g, hedge=spec,
                                                   checkpoint=part, device=dev, **kw), part
    tails = {m: timed(path_tail_risk, prices, None, Config(), model=m, legs_by_asset=tail_legs,
                      device=dev) for m in ("garch", "bootstrap", "heston", "dcc")}
    frontier, budget = {}, {}
    for steps in HEDGED_FRONTIER_STEPS:
        for m, _, src in models:
            key, cfg = f"{m} {steps}", dict(FRONTIER, n_steps=steps)

            def run(**kw):
                return family_drawdown_frontier_search(FRONTIER_SEED, m, src, hedge=spec,
                                                       s0=spot, device=dev, **kw)

            if steps == N_STEPS:
                budget[key] = round(-reports[f"{m} default"].dd_p95 + 0.01, 4)
            else:   # the median candidate's, over those whose wealth stays finite
                q = run(**dict(cfg, dd_budget=1.0)).dd_p95
                budget[key] = round(-float(np.median(q[np.isfinite(q)])), 4)
            frontier[key], wall[f"frontier {key}"] = walls(run, **dict(cfg, dd_budget=budget[key]))
    with tempfile.TemporaryDirectory() as tmp:
        cli, cli_wall = timed(_fixture_cli_family_hedged, dev, Path(tmp))
    launches = {name: fn.hedged_launches for name, fn in counted.items()}
    print(f"phase24 hedged family tier: hedged launches {launches}")
    check(all(n > 0 for n in launches.values()),
          "the hedged paths went through the hedged modes of kernels #5, #7, #10 and #13")
    for key, r in reports.items():
        first, warm = wall[key]
        (resumed, ck), part = resumes[key]
        same = _reports_equal(r, resumed) and ck.done and not part.done
        print(f"phase24 path risk hedged {key}: paths={r.n_paths} wall first={first:.4f} s "
              f"warm={warm:.4f} s var={r.var:.6f} cvar={r.cvar:.6f} dd_p95={r.dd_p95:.6f} "
              f"dd_median={r.dd_median:.6f}; split at block {part.next_block} + resume "
              f"bit-identical={same}")
        check(r.cvar <= r.var and -1.0 <= r.dd_p95 <= r.dd_median <= 0.0,
              f"hedged path risk {key}: finite and ordered")
        check(same, f"hedged path risk {key}: resume equivalence")
    for m, (out, t_wall) in tails.items():
        print(f"phase24 path_tail_risk hedged {m}: wall {t_wall:.4f} s {json.dumps(out)}")
        check(out["hedged_assets"] == ["asset0", "asset1"] and out["cvar"] <= out["var"],
              f"path_tail_risk hedged {m}")
    for key, r in frontier.items():
        first, warm = wall[f"frontier {key}"]
        i = r.opt_idx
        print(f"phase24 frontier hedged {key} steps: {FRONTIER['n_candidates']} x "
              f"{FRONTIER['n_paths']} budget {budget[key]} wall first={first:.4f} s "
              f"warm={warm:.4f} s feasible={int(r.feasible.sum())} opt={i} "
              f"ret={float(r.ret[i]):.7g} dd_p95={float(r.dd_p95[i]):.6f} candidates with "
              f"an infinite mean return {int((~np.isfinite(r.ret)).sum())}")
        check(0 < int(r.feasible.sum()) < FRONTIER["n_candidates"]
              and float(r.dd_p95[i]) >= -budget[key], f"hedged {key}-step frontier")
    print(f"phase24 cli: the hedged family commands in {cli_wall:.2f} s")
    for name, out in cli.items():
        print(f"phase24 cli {name}: {json.dumps(out)}")
    check(cli["path-risk --hedge"]["settlement"] == "per-period hedged"
          and all(cli["path-risk --hedge"][m]["cvar"] <= cli["path-risk --hedge"][m]["var"]
                  for m in ("garch", "bootstrap", "heston", "dcc"))
          and all(cli[f"dd-frontier --model {m} --hedge"]["hedged"] is True
                  for m in ("garch", "bootstrap", "heston", "dcc")),
          "cli hedged garch, bootstrap, heston and dcc")
    _family_hedged_references(dev, w, reports, frontier)
    return launches


def _family_hedged_references(dev, w, reports, frontier) -> None:
    """Phase 24's results against the plain forms: the default cell's hedged
    drawdown quantiles over the same paths, and each hedged frontier's
    optimum over all its paths within what the per-path bound allows (as
    phase 20 holds #3 and #8)."""
    from mcport_torch.engine.drawdown_frontier import frontier_seeds
    from mcport_torch.engine.path_risk import DD_SKETCH

    cfg = cells()["default"]
    nb = cfg.n_paths // cfg.path_block
    spot = np.full(N_ASSETS, SPOT)
    garch, hist = bench_garch().tensors(dev), torch.as_tensor(bench_history(), device=dev)
    srcs = {"garch": garch, "bootstrap": hist, "heston": bench_heston().tensors(dev),
            "dcc": bench_dcc().tensors(dev)}
    dd_width = (DD_SKETCH.hi - DD_SKETCH.lo) / DD_SKETCH.n_bins
    for m, src in srcs.items():
        launch = dict(kernel=HEDGED_KERNEL[m], seed=cfg.seed, w=w[None], src=src, s0=spot,
                      steps=N_STEPS, first_block=0, n_blocks=nb)
        dd = torch.cat([_family_hedged_call(launch, dev, plain=True,
                                            n=min(REF_BLOCK_CHUNK, cfg.path_block - p0),
                                            first_path=p0, bound=False)[1]
                        for p0 in range(0, cfg.path_block, REF_BLOCK_CHUNK)], dim=-1).reshape(-1)
        dd = torch.nan_to_num(dd, nan=-math.inf)
        r = reports[f"{m} default"]
        q = float(torch.kthvalue(dd, math.ceil(0.05 * dd.numel())).values)
        med = float(torch.median(dd))
        print(f"phase24 hedged {m} default dd vs plain form over the same paths: p95 "
              f"{r.dd_p95:.6f} vs {q:.6f}, median {r.dd_median:.6f} vs {med:.6f} (bound "
              f"{2 * dd_width:.2e})")
        check(abs(r.dd_p95 - q) <= 2 * dd_width and abs(r.dd_median - med) <= 2 * dd_width,
              f"hedged {m} drawdown quantiles agree with the plain form")
    path_seed = frontier_seeds(FRONTIER_SEED)[0]
    n = FRONTIER["n_paths"]
    for key, f in frontier.items():
        m, steps = key.split()
        i = f.opt_idx
        launch = dict(kernel=HEDGED_KERNEL[m], seed=path_seed, w=f.weights[i][None],
                      src=srcs[m], s0=spot, steps=int(steps), n=n)
        parts = [_family_hedged_call(launch, dev, plain=True, n=min(REF_CHUNK, n - p0),
                                     first_path=p0) for p0 in range(0, n, REF_CHUNK)]
        term, ddo, bnd = (torch.cat([p[j] for p in parts], dim=-1)[0, 0] for j in range(3))
        ret = float(term.mean())
        q = float(torch.kthvalue(torch.nan_to_num(ddo, nan=-math.inf),
                                 math.ceil(0.05 * n)).values)
        fin = torch.isfinite(term)
        ret_tol = (float((bnd[fin].double() * (1.0 + term[fin].double().abs())).mean())
                   + (1e-6 * (1.0 + abs(ret)) if math.isfinite(ret) else 0.0))
        q_tol = 2.0 * float(bnd[torch.isfinite(ddo)].max()) + 1e-6
        got_ret, got_q = float(f.ret[i]), float(f.dd_p95[i])
        print(f"phase24 hedged frontier {key} steps optimum vs plain form: ret {got_ret:.7g} "
              f"vs {ret:.7g} (bound {ret_tol:.3g}), dd_p95 {got_q:.7f} vs {q:.7f} (bound "
              f"{q_tol:.3g}); paths overflowed {int((~fin).sum())} of {n}")
        check(_within(got_ret, ret, ret_tol) and _within(got_q, q, q_tol),
              f"hedged {key}-step frontier optimum agrees with the plain form")


def wide_bounds(draw: float, rate: float) -> dict:
    """Least time of each kernel's wide layout at phase 25's shapes (A = 200:
    terminal 65,536 x 52, candidates 256 x 8,192 x 52; DCC A = 256, 4,096 x
    8 and 256 x 4,096 x 8) from the work each function needs (the families'
    tables at that shape; #1-#3 per path-step: the draws, the full row of L
    z (A FMAs per asset) and, per step, exp and the score)."""
    a, sh = 200, WIDE_TIMING
    p, pp, n, w_cnt = sh["p"], sh["pp"], sh["n"], 256
    score = w_cnt * (a + 6)
    gbm_step = a * (draw + a + 3)
    tag = "phase25 A=200"
    work = {"terminal_noise": ((a * draw * n + a * a) * p, 4 * (a * a + a * p),
                               f"{a} x {n} draws of {draw:.2f} + {a * a} FMAs of L sum(z) per "
                               f"path"),
            "path_stats": ((gbm_step + 4) * n * p, 4 * (a * a + 2 * a) + 8 * p,
                           f"{gbm_step:.0f} per path-step: {a} draws, {a} x {a} FMAs of L z, "
                           f"3 per asset"),
            "multi_dd": ((gbm_step + score) * n * pp, 4 * (a * a + a + w_cnt * a) + 8 * w_cnt * pp,
                         f"{gbm_step:.0f} per path-step + {score} for 256 candidates")}
    out = _bound_table(work, rate, tag)
    m = family2_bounds(draw, rate, a=a, n=n, p=p, pp=pp, tag=tag)
    out.update(family_bounds(draw, rate, a=a, n=n, p=p, pp=pp, tag=tag))
    out.update(m)
    d = dcc_bounds(draw, rate, a=256, n=DCC_WIDE[1], p=4_096, pp=4_096,
                   tag="phase25 A=256")
    out.update(d)
    return {f"{name} wide": b for name, b in out.items()}


def family_hedged_bounds(draw: float, rate: float) -> dict:
    """Least time of the hedged modes of kernels #5, #7 and #10 at 256 x
    131,072 x 252 with the bench hedge (L = 2 legs), of hedged #10's wide
    layout at A = 200 (256 x 8,192 x 52), and of hedged #13 at 256 x 131,072
    x 52 and past 64 at A = 256 (256 x 1,024 x 16), from the work each
    function needs:
    the unhedged mode's (``family_bounds``, ``family2_bounds``) plus, per
    asset-step, the price update (2) and the legs' settlement (per leg 7, one
    division counted as 8), as ``hedged_bounds`` counts for #3 and #8."""
    a, n, w_cnt, pp, legs = N_ASSETS, N_STEPS, 256, FRONTIER["n_paths"], 2
    tri = a * (a + 1) / 2
    settle = a * (7 * legs + 1 + 8 + 2)
    score = w_cnt * (a + 6)
    garch_step = a * (draw + 7) + tri + settle
    boot_step = PHILOX_CALL / 2 + 8 + a + settle
    hedge_bytes = 4 * a * (1 + 4 * legs)
    work = {"garch_multi_dd_hedged": ((garch_step + score) * n * pp,
                                      4 * (a * a + 6 * a + w_cnt * a) + hedge_bytes
                                      + 8 * w_cnt * pp,
                                      f"{garch_step:.2f} per path-step ({settle:.0f} "
                                      f"settlement) + {score} for 256 candidates"),
            "bootstrap_multi_dd_hedged": ((boot_step + score) * n * pp,
                                          4 * (365 * a + w_cnt * a) + hedge_bytes
                                          + 8 * w_cnt * pp,
                                          f"{boot_step:.2f} per path-step ({settle:.0f} "
                                          f"settlement) + {score} for 256 candidates")}

    def heston(a, n, pp, how):
        tri = a * (a + 1) / 2
        settle = a * (7 * legs + 1 + 8 + 2)
        score = w_cnt * (a + 6)
        step = a * (2 * draw + 12) + tri + 2 * a + settle   # family2_bounds' + exp + settlement
        return ((step + score) * n * pp,
                4 * (a * a + 7 * a + w_cnt * a) + 4 * a * (1 + 4 * legs) + 8 * w_cnt * pp,
                f"{how}{step:.2f} per path-step ({settle:.0f} settlement) + {score} for 256 "
                f"candidates")

    work["heston_multi_dd_hedged"] = heston(a, n, pp, "")
    sh = WIDE_TIMING
    work["heston_multi_dd_hedged wide"] = heston(200, sh["n"], sh["pp"],
                                                 f"A=200 x {sh['pp']} x {sh['n']}: ")

    def dcc(a, n, pp):   # dcc_bounds' step + the settlement (phase 28's shapes)
        tri = a * (a + 1) / 2
        chol = a * (a * a - 1) / 6 + a * (a - 1) / 2 + a
        settle = a * (7 * legs + 1 + 8 + 2)
        score = w_cnt * (a + 6)
        step = a * draw + 3 * tri + chol + tri + 9 * a + settle
        return ((step + score) * n * pp,
                4 * (2 * a * a + 7 * a + 2 + w_cnt * a) + 4 * a * (1 + 4 * legs)
                + 8 * w_cnt * pp,
                f"A={a} x {pp} x {n}: {step:.2f} per path-step ({settle:.0f} settlement) + "
                f"{score} for 256 candidates")

    work["dcc_dd_hedged"] = dcc(a, DCC_STEPS, pp)
    work["dcc_dd_hedged wide"] = dcc(256, 16, 1_024)
    return _bound_table(work, rate, "phase25")


def phase_wide_timing(dev) -> dict:
    """Phase 25, with CUDA events: the hedged modes of #5, #7 and #10 at 256 x
    131,072 x 252 and of #13 at 256 x 131,072 x 52 (the bench hedge, L = 2)
    beside their unhedged modes, their plain forms (8,192-path pieces) and
    the score product as one torch.matmul per step; then each kernel's wide
    layout at A = 200 (DCC 256) beside its plain form (and, for the
    candidates, the score product as one torch.matmul per step; for DCC
    also torch.linalg.cholesky of the (paths, 256, 256) batch once per step,
    the terminal's yardstick), hedged #10's (A = 200, 256 x 8,192 x 52) and
    #13's (A = 256, 256 x 1,024 x 16) beside their unhedged modes."""
    from mcport_torch.ops import bootstrap as B
    from mcport_torch.ops import dcc as D
    from mcport_torch.ops import garch as G
    from mcport_torch.ops import heston as H

    spot = np.full(N_ASSETS, SPOT)
    cand = torch.as_tensor(np.random.default_rng(0).dirichlet(np.ones(N_ASSETS), 256),
                           dtype=torch.float32, device=dev)
    pp = FRONTIER["n_paths"]
    res = {}
    garch, hist = bench_garch().tensors(dev), torch.as_tensor(bench_history(), device=dev)
    unhedged = {"garch_multi_dd_hedged": G.garch_multi_portfolio_dd,
                "bootstrap_multi_dd_hedged": B.bootstrap_multi_portfolio_dd,
                "heston_multi_dd_hedged": H.heston_multi_portfolio_dd,
                "dcc_dd_hedged": D.dcc_multi_portfolio_dd}
    e = torch.rand((N_ASSETS, pp), device=dev)
    mm = _time_ms(lambda: torch.matmul(cand, e), 50)
    for name, src in (("garch_multi_dd_hedged", garch), ("bootstrap_multi_dd_hedged", hist),
                      ("heston_multi_dd_hedged", bench_heston().tensors(dev)),
                      ("dcc_dd_hedged", bench_dcc().tensors(dev))):
        steps = DCC_STEPS if name == "dcc_dd_hedged" else N_STEPS
        launch = dict(kernel=name, seed=0, n=pp, w=cand, src=src, s0=spot, steps=steps)

        def kern(launch=launch):
            _family_hedged_call(launch, dev, plain=False)

        def bare(name=name, src=src, steps=steps):
            unhedged[name](0, src, cand, pp, steps)

        def plain(launch=launch):
            for p0 in range(0, pp, MDD_PLAIN_CHUNK):
                _family_hedged_call(launch, dev, plain=True, n=min(MDD_PLAIN_CHUNK, pp - p0),
                                    first_path=p0, bound=False)

        kern(), bare()
        torch.cuda.synchronize()
        p1, k1, u1, u2, k2 = (_time_ms(plain, 1), _time_ms(kern, 3), _time_ms(bare, 3),
                              _time_ms(bare, 3), _time_ms(kern, 3))
        ms = (k1 + k2) / 2
        print(f"phase25 timing {name} (L=2) 256 x {pp} x {steps}: kernel {k1:.3f} / "
              f"{k2:.3f} ms ({256 * pp * steps / ms * 1e3:.4e} cand-path-steps/s), the "
              f"unhedged mode {u1:.3f} / {u2:.3f} ms, plain {p1:.1f} ms, torch.matmul x "
              f"{steps} {mm * steps:.3f} ms")
        res[name] = [ms, p1, mm * steps]
    # hedged #10's and #13's layouts past 64 (HestonWide<true, true> at A =
    # 200; dcc_group_kernel hedged at A = 256, Q in device memory), the bench
    # hedge, beside the unhedged mode in the same call
    sh = WIDE_TIMING
    for name, a, pw, n, src, unh in (
            ("heston_multi_dd_hedged", 200, sh["pp"], sh["n"], bench_heston(200).tensors(dev),
             H.heston_multi_portfolio_dd),
            ("dcc_dd_hedged", 256, 1_024, 16, bench_dcc(256).tensors(dev),
             D.dcc_multi_portfolio_dd)):
        wa = torch.as_tensor(np.random.default_rng(a).dirichlet(np.ones(a), 256),
                             dtype=torch.float32, device=dev)
        launch = dict(kernel=name, seed=0, n=pw, w=wa, src=src, s0=np.full(a, SPOT), steps=n)

        def kern(launch=launch):
            _family_hedged_call(launch, dev, plain=False)

        def bare(unh=unh, src=src, wa=wa, pw=pw, n=n):
            unh(0, src, wa, pw, n)

        kern(), bare()
        torch.cuda.synchronize()
        k1, u1, u2, k2 = (_time_ms(kern, 2), _time_ms(bare, 2), _time_ms(bare, 2),
                          _time_ms(kern, 2))
        piece = pw if name.startswith("heston") else 256   # DCC's plain form costs A^3
        pl = _time_ms(lambda launch=launch, pw=pw, piece=piece: [
            _family_hedged_call(launch, dev, plain=True, n=min(piece, pw - p0), first_path=p0,
                                bound=False) for p0 in range(0, pw, piece)], 1)
        x = torch.rand((a, pw), device=dev)
        lib = _time_ms(lambda wa=wa, x=x: torch.matmul(wa, x), 20) * n
        chol = (f", torch.linalg.cholesky ({pw}, {a}, {a}) per step x steps "
                f"{_dcc_yardsticks(src, None, pw, n, dev)[0]:.3f} ms"
                if name.startswith("dcc") else "")
        print(f"phase25 timing {name} wide layout A={a} (L=2) 256 x {pw} x {n}: kernel "
              f"{k1:.3f} / {k2:.3f} ms, the unhedged mode {u1:.3f} / {u2:.3f} ms, plain "
              f"{pl:.1f} ms, torch.matmul per step x steps {lib:.3f} ms{chol}")
        res[f"{name} wide"] = [(k1 + k2) / 2, pl, lib]
    # each wide layout at A = 200 (DCC 256)
    sh = WIDE_TIMING
    calls = {**_wide_calls(200, dev, sh["p"], sh["pp"], sh["n"], 256, nb=1),
             **_dcc_wide_calls(256, dev, 4_096, DCC_WIDE[1], 256, nb=1)}
    for name, (kern, plain, _) in calls.items():
        kern()
        torch.cuda.synchronize()
        t1, t2 = _time_ms(kern, 2), _time_ms(kern, 2)
        pl = _time_ms(plain, 1)
        a = 256 if name.startswith("dcc") else 200
        cand_paths = 4_096 if name.startswith("dcc") else sh["pp"]
        lib, chol = None, ""
        if name.endswith("dd"):
            c = torch.rand((256, a), device=dev)
            x = torch.rand((a, cand_paths), device=dev)
            steps = DCC_WIDE[1] if name.startswith("dcc") else sh["n"]
            lib = _time_ms(lambda: torch.matmul(c, x), 20) * steps
        if name.startswith("dcc"):   # the factorisation alone, beside the score product
            ch = _dcc_yardsticks(bench_dcc(a).tensors(dev), None, 4_096, DCC_WIDE[1], dev)[0]
            chol = f", torch.linalg.cholesky (4096, {a}, {a}) per step x steps {ch:.3f} ms"
            lib = ch if lib is None else lib   # the terminal's yardstick: the Cholesky
        print(f"phase25 timing {name} wide layout A={a}: kernel {t1:.3f} / {t2:.3f} ms, plain "
              f"{pl:.1f} ms" + (f", torch.matmul per step x steps {lib:.3f} ms"
                                if name.endswith("dd") else "") + chol)
        res[f"{name} wide"] = [(t1 + t2) / 2, pl, lib]
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import mcport_torch  # noqa: F401  (the precision pin)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    clock = [t0]

    def lap(what: str) -> None:
        now = time.perf_counter()
        print(f"chip_smoke: {what} took {now - clock[0]:.1f} s")
        clock[0] = now

    kind = phase_card()
    phase_build()
    lap("phases 0-1")
    worst = {"terminal_noise": phase_kernel_vs_plain(dev)}
    phase_law(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = {"terminal_noise": phase_main_path(dev, Path(tmp))}
    times = {"terminal_noise": (*phase_timing(dev), None)}
    lap("phases 2-5")
    worst.update(phase_path_kernels(dev))
    launches.update(phase_path_tier(dev))
    times.update(phase_path_timing(dev))
    lap("phases 6-8")
    worst.update(phase_family_kernels(dev))
    lap("phase 9")
    launches.update(phase_family_tier(dev))
    lap("phase 10")
    times.update(phase_family_timing(dev))
    lap("phase 11")
    for name, err in phase_family2_kernels(dev).items():   # #5 and #7 also phases 9 and 23
        worst[name] = max(worst.get(name, 0.0), err)
    lap("phase 12")
    launches.update(phase_family2_tier(dev))
    lap("phase 13")
    times.update(phase_family2_timing(dev))
    lap("phase 14")
    worst.update(phase_dcc_kernels(dev))
    lap("phase 15")
    launches.update(phase_dcc_tier(dev))
    lap("phase 16")
    times.update(phase_dcc_timing(dev))
    lap("phase 17")
    for name, err in phase_wide(dev).items():
        worst[name] = max(worst[name], err)
    lap("phase 18")
    worst.update(phase_hedged_kernels(dev))
    lap("phase 19")
    launches.update(phase_hedged_tier(dev))
    lap("phase 20")
    times.update(phase_hedged_timing(dev))
    lap("phase 21")
    wide_worst, wide_launches, hedged_wide = phase_wide_any(dev)
    lap("phase 22")
    for name, err in phase_family_hedged_kernels(dev).items():
        worst[name] = max(worst.get(name, 0.0), err)
    for name, err in hedged_wide.items():
        worst[name] = max(worst[name], err)
    lap("phase 23")
    launches.update(phase_family_hedged_tier(dev))
    lap("phase 24")
    times.update(phase_wide_timing(dev))
    rate = issue_rate()
    bound = bounds(rate)
    draw = bound.pop("draw")
    bound.update(family_hedged_bounds(draw, rate))
    bound.update(wide_bounds(draw, rate))
    for key, t in times.items():
        if " " in key or key in FAMILY_HEDGED:   # phases 21 and 25, beside their bounds
            print(f"bound {key}: {t[0]:.3f} ms, bound {bound[key][0]:.3f} ms "
                  f"({bound[key][1]}), {100 * bound[key][0] / t[0]:.1f}% of the bound")
    # phase 14's W = 1 times beside the least time of one candidate's work
    one = family_bounds(draw, rate, w_cnt=1, names=("garch_multi_dd", "bootstrap_multi_dd"),
                        tag="phase14 W=1")
    one.update(family2_bounds(draw, rate, w_cnt=1, names=("merton_multi_dd", "heston_multi_dd"),
                              tag="phase14 W=1"))
    for key, t in W1_TIMES.items():
        print(f"bound {key} W=1: {t:.3f} ms, bound {one[key][0]:.3f} ms ({one[key][1]}), "
              f"{100 * one[key][0] / t:.1f}% of the bound")
    lap("phase 25 and the bounds")
    check("jax" not in sys.modules and "pandas" not in sys.modules
          and not any(m == "mcport" or m.startswith("mcport.") for m in sys.modules),
          "no jax, pandas or mcport imported")
    kernels = {  # name: (source, the TPU kernel it replaces)
        "terminal_noise": ("terminal_noise.cu", "mcport/ops/pallas_gbm.py:413"),
        "path_stats": ("path_stats.cu", "mcport/ops/pallas_gbm.py:631"),
        # up to 16 assets #3 runs csrc/gbm_narrow.cu's layouts (the main paths'
        # 15), from 17 multi_dd.cu's tile kernel, past 64 its wide layout
        "multi_dd": ("gbm_narrow.cu", "mcport/ops/pallas_multi_dd.py:82"),
        "garch_terminal": ("garch.cu", "mcport/ops/pallas_garch.py:36"),
        "garch_multi_dd": ("garch.cu", "mcport/ops/pallas_garch.py:113"),
        "bootstrap_terminal": ("bootstrap.cu", "mcport/ops/pallas_bootstrap.py:52"),
        "bootstrap_multi_dd": ("bootstrap.cu", "mcport/ops/pallas_bootstrap.py:120"),
        "merton_multi_dd": ("jump.cu", "mcport/ops/pallas_jump.py:70"),
        "heston_terminal": ("heston.cu", "mcport/ops/pallas_heston.py:72"),
        "heston_multi_dd": ("heston.cu", "mcport/ops/pallas_heston.py:172"),
        # one kernel each for the TPU's pack and tile layouts: :242 and :337,
        # :359 and :279
        "dcc_terminal": ("dcc.cu", "mcport/ops/pallas_dcc.py:242"),
        "dcc_dd": ("dcc.cu", "mcport/ops/pallas_dcc.py:359"),
        # the hedged modes: the hedged branches of #3 (:143-175), #8 (:100-120),
        # #5 (:137-167), #7 (:147-164) and #10 (:208-235)
        "multi_dd_hedged": ("gbm_narrow.cu", "mcport/ops/pallas_multi_dd.py:143"),
        "merton_multi_dd_hedged": ("jump.cu", "mcport/ops/pallas_jump.py:100"),
        "garch_multi_dd_hedged": ("garch.cu", "mcport/ops/pallas_garch.py:137"),
        "bootstrap_multi_dd_hedged": ("bootstrap.cu", "mcport/ops/pallas_bootstrap.py:147"),
        "heston_multi_dd_hedged": ("heston.cu", "mcport/ops/pallas_heston.py:208"),
        # #13's hedged branch (:378-406); #14 has no hedged mode (:585-587)
        "dcc_dd_hedged": ("dcc.cu", "mcport/ops/pallas_dcc.py:378"),
    }
    # each kernel's layout past 64 assets (csrc/wide.cuh and its model in the
    # kernel's file): launches on phase 22's 65-asset main paths, errors from
    # phase 22, times and bounds at A = 200 (DCC 256) from phase 25
    for name in WIDE_KERNELS:
        src, replaces = kernels[name]
        kernels[f"{name} wide"] = ("multi_dd.cu" if src == "gbm_narrow.cu" else src, replaces)
        launches[f"{name} wide"] = wide_launches[name]
        worst[f"{name} wide"] = wide_worst[name]
    # hedged #10's layout past 64 (HestonWide<true, true>): launches on phase
    # 22's hedged 65-asset main paths, errors from phases 22-23 (A = 65, 200),
    # time and bound at A = 200 from phase 25
    kernels["heston_multi_dd_hedged wide"] = kernels["heston_multi_dd_hedged"]
    launches["heston_multi_dd_hedged wide"] = wide_launches["heston_multi_dd_hedged"]
    # hedged #13's layout past 64 (dcc_group_kernel hedged): the same,
    # errors at A = 65 and 256, time and bound at A = 256
    kernels["dcc_dd_hedged wide"] = kernels["dcc_dd_hedged"]
    launches["dcc_dd_hedged wide"] = wide_launches["dcc_dd_hedged"]
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": f"mcport_torch/csrc/{src}",
        "replaces": replaces, "launches": launches[name],
        "max_abs_err": worst[name], "ms": times[name][0], "plain_ms": times[name][1],
        "bound_ms": bound[name][0], "bound_by": bound[name][1],
        "library_ms": times[name][2],
    } for name, (src, replaces) in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
