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
   over two blocks, and every launch of phase 7 over all its paths (bound:
   ``ops.path_stats.path_stats_tolerance``); #2's terminal against #1's at the
   same seed; the multi-dd kernel (#3) against its plain form — the three
   score tiers, both modes, W in {1, 13, 256}, A = 15, 252 steps, the draw
   tiers at W = 13, and one 256-candidate chunk of phase 7's frontier over
   its 131,072 paths (bound: ``ops.multi_dd.multi_dd_shares``); #3 with one
   candidate bit-identical to #2;
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
   score product alone as one torch.matmul per step), and each kernel's
   least time: its bytes over the memory rate or its instructions over the
   card's issue rate, counted from the SASS (``cuobjdump -sass``) — for #1 and
   #3 their hot loops, for #2 the work the function needs (kernel #1's draw
   plus the steps' correlate, exp and drawdown), beside #2's own loop.

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
DISPATCH = 16                       # run_resumable_mc's dispatch_blocks default


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


def path_config(g, t_df):
    return g if t_df is None else dataclasses.replace(g, innovations="student_t",
                                                      t_dof=t_df)


def bench_weights(a: int = N_ASSETS) -> np.ndarray:
    return np.random.default_rng(1).dirichlet(np.ones(a))


def bench_prices():
    """A price history for ``path_tail_risk``: 504 daily steps of the bench
    universe from seed 2 (``names`` and ``prices`` are all it reads)."""
    from types import SimpleNamespace

    mean, chol = bench_universe()
    z = np.random.default_rng(2).standard_normal((504, N_ASSETS))
    logp = np.cumsum(mean + z @ chol.T.astype(np.float64), axis=0)
    prices = 100.0 * np.exp(np.vstack([np.zeros(N_ASSETS), logp]))
    return SimpleNamespace(names=tuple(f"asset{i}" for i in range(N_ASSETS)), prices=prices)


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

    # every launch of phase 7, against the plain form over all its paths
    for launch in path_launches():
        mean, chol, w = t(launch["mean"]), t(launch["chol"]), t(launch["w"])
        lk = t_scaled_chol(chol, launch["t_df"])
        kw = dict(first_block=launch["first_block"], n_blocks=launch["n_blocks"],
                  rebalance=launch["rebalance"], t_df=launch["t_df"])
        k = gbm_path_stats(launch["seed"], mean, chol, w, launch["block"], launch["steps"],
                           terminal=False, **kw)
        p = _plain_path_stats(launch["seed"], mean, lk, w, launch["block"],
                              launch["steps"], **kw)
        held_ps(f"{launch['what']} x {launch['block']}", k, (None, *p[1:]), lk, mean,
                launch["steps"])
        del k, p

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
    return worst


def _reports_equal(a, b) -> bool:
    return all(getattr(a, f) == getattr(b, f) for f in
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
    over HBM bandwidth and its instructions over the issue rate. Kernels #1
    and #3 count their hot loops' SASS; #2 counts what the function needs,
    built from kernel #1's measured draw, and prints its own loop's count
    beside it. The rest of each kernel is left out: a lower bound."""
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
    per_step = a * (draw + (a + 1) / 2 + 3) + 4
    out["path_stats"] = (per_step * n * p, 4 * (a * a + 2 * a) + 8 * p,
                         f"{draw:.2f} instructions per draw (kernel #1) + {(a + 1) / 2:.0f} "
                         f"FMAs + 3 per asset-step, + 4 per path-step: {per_step:.2f} per "
                         f"path-step")
    # beside it, the kernel's own loop (the <=16-asset build): one iteration is
    # 16 assets' Philox calls and four steps, of which A=15 runs (15/16)^2
    ins, its, _ = _hot_loop(_sass_loops(libs["path_stats"],
                                        "path_stats_kernelILi0ELb0ELi16ELi16E"),
                            PHILOX_MULS, 16 * 20)
    own = ins * (a / 16) ** 2 * ((-(-n // 4)) // its) * p
    print(f"phase8 path_stats own call loop: {ins} instructions / {its} call(s) of 16 "
          f"assets, {ins / its / 64:.2f} per asset-step; at A={a} {own:.4e} "
          f"instructions = {own / rate * 1e3:.3f} ms at {rate:.4e}/s")
    # kernel #3, float32 buy-and-hold: the score loop inside the Philox-call
    # loop, two float4 loads (weights, exps) per asset, per scoring thread
    # (one per candidate of a 16-path tile) and step
    w_cnt, pp = 256, FRONTIER["n_paths"]
    loops = _sass_loops(libs["multi_dd"], "multi_dd_kernelILi0ELb0ELi0EE")
    *_, call_loop = _hot_loop(loops, PHILOX_MULS, 4 * 20)
    ins, its, _ = _hot_loop(loops, ("LDS.128",), 2, within=call_loop)
    out["multi_dd"] = (ins * (a // its) * n * w_cnt * (pp // 16),
                       4 * (a * a + a + w_cnt * a) + 8 * w_cnt * pp,
                       f"score loop {ins} instructions / {its} asset(s)")
    res = {}
    for name, (instr, nbytes, how) in out.items():
        t_ops, t_bytes = instr / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        res[name] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
        print(f"phase8 bound {name}: {how}; {instr:.4e} instructions at {rate:.4e}/s = "
              f"{t_ops:.3f} ms, {nbytes} bytes at 3.35 TB/s = {t_bytes:.3f} ms")
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

    kernel2(), plain2()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = _time_ms(plain2, 1), _time_ms(kernel2, 10), _time_ms(kernel2, 10), \
        _time_ms(plain2, 1)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    work = LAW_PATHS * N_STEPS
    reb = _time_ms(lambda: kernel2(True), 10)
    print(f"phase8 timing path_stats {LAW_PATHS} x {N_STEPS} x {N_ASSETS} buy-hold: kernel "
          f"{k1:.3f} / {k2:.3f} ms ({work / ms * 1e3:.4e} path-steps/s), plain {p1:.1f} / "
          f"{p2:.1f} ms ({work / plain_ms * 1e3:.4e} path-steps/s); rebalanced kernel "
          f"{reb:.3f} ms")
    res["path_stats"] = (ms, plain_ms, None)

    n_cand, pp = 256, FRONTIER["n_paths"]
    cand = torch.as_tensor(np.random.default_rng(0).dirichlet(np.ones(N_ASSETS), n_cand),
                           dtype=torch.float32, device=dev)
    work = n_cand * pp * N_STEPS
    for sd in ("float32", "tensorfloat32", "bfloat16"):
        def kernel3(sd=sd):
            gbm_multi_portfolio_dd(0, mean, chol, cand, pp, N_STEPS, score_dtype=sd)

        def plain3(sd=sd):
            _plain_multi_dd(0, mean, chol, cand, pp, N_STEPS, score_dtype=sd)

        kernel3(), plain3()
        torch.cuda.synchronize()
        p1, k1, k2, p2 = _time_ms(plain3, 1), _time_ms(kernel3, 5), _time_ms(kernel3, 5), \
            _time_ms(plain3, 1)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        print(f"phase8 timing multi_dd {n_cand} x {pp} x {N_STEPS} score={sd}: kernel "
              f"{k1:.3f} / {k2:.3f} ms ({work / ms * 1e3:.4e} cand-path-steps/s), plain "
              f"{p1:.1f} / {p2:.1f} ms")
        if sd == "float32":
            res["multi_dd"] = (ms, plain_ms)
    # the library yardstick: the score product alone, one (W, A) x (A, P)
    # torch.matmul per step
    e = torch.rand((N_ASSETS, pp), device=dev)
    mm = _time_ms(lambda: torch.matmul(cand, e), 50)
    print(f"phase8 timing torch.matmul ({n_cand}, {N_ASSETS}) x ({N_ASSETS}, {pp}): {mm:.4f} "
          f"ms per step, x {N_STEPS} steps = {mm * N_STEPS:.3f} ms")
    res["multi_dd"] = (*res["multi_dd"], mm * N_STEPS)
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
    kind = phase_card()
    phase_build()
    worst = {"terminal_noise": phase_kernel_vs_plain(dev)}
    phase_law(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = {"terminal_noise": phase_main_path(dev, Path(tmp))}
    times = {"terminal_noise": (*phase_timing(dev), None)}
    worst.update(phase_path_kernels(dev))
    launches.update(phase_path_tier(dev))
    times.update(phase_path_timing(dev))
    bound = bounds(issue_rate())
    check("jax" not in sys.modules and "pandas" not in sys.modules
          and not any(m == "mcport" or m.startswith("mcport.") for m in sys.modules),
          "no jax, pandas or mcport imported")
    source = {"terminal_noise": "mcport/ops/pallas_gbm.py:413",
              "path_stats": "mcport/ops/pallas_gbm.py:631",
              "multi_dd": "mcport/ops/pallas_multi_dd.py:82"}
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": f"mcport_torch/csrc/{name}.cu",
        "replaces": source[name], "launches": launches[name],
        "max_abs_err": worst[name], "ms": times[name][0], "plain_ms": times[name][1],
        "bound_ms": bound[name][0], "bound_by": bound[name][1],
        "library_ms": times[name][2],
    } for name in source]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
