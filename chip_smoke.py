#!/usr/bin/env python3
"""Drive the PyTorch port's gbm-risk main path once on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card

The quickest proof that the port (``mcport_torch``) builds and runs on the
GPU. It imports neither jax nor pandas. Phases, each printed as it ends:

0. the card: ``nvidia-smi`` name and power limit, torch's device name;
1. the kernel build from ``mcport_torch/csrc`` (nvcc, sm_90a), timed;
2. the terminal-noise kernel against its plain torch form on identical Philox
   counters: tiers poly / poly_fast / t(5.5), A in {1, 15, 64}, 252 and 7
   steps, a ragged 65,537-path count over two blocks, antithetic on and off;
   single draws (L = [[1]], 1 and 2 steps) of both normal tiers; and every
   launch the main path of phase 4 makes (its seed, blocks and dispatch
   groups at both sizes). Bound per element and asset:
   ``mcport_torch.ops.gbm.kernel_tolerance`` (the smaller of 2e-6 per draw,
   as nvcc contracts multiply-adds into FMAs and torch does not, and a
   random-walk bound at least four times the largest difference measured on
   an H100);
3. the law on the card at 1,048,576 paths x 252 steps x 15 assets: terminal
   means within 5 standard errors of n*m, covariance within 2% of n*LL', and
   the t tier's fat tails: pooled standardised kurtosis above 3.2 and within
   25% (of its excess) of the sampler's law at 4 steps;
4. the main path, ``mcport_torch.api.gbm_risk``, on the bench's synthetic
   15-asset universe at GBMConfig defaults (131,072 x 252) and at BASELINE
   config-4 scale (16,777,216 x 252, 1,048,576-path blocks), each once with
   its checkpoint written and three times warm: histogram mass and n_paths
   equal the request, cvar <= var, all finite, the kernel launched once per
   dispatch group, a max_blocks split plus resume bit-identical to the
   one-shot run, the card agreeing with the port's CPU run on a small input,
   and VaR/CVaR/moments agreeing with exact Gaussian terminal sampling;
5. kernel and plain form timed with CUDA events at 1,048,576 x 252 x 15, and
   the kernel's other two tiers.

It prints a JSON line with each kernel's launches, error and times, then, as
the last line, ``{"ok": true, "device": {...}}`` — only when every phase
passed. Any failure raises and exits non-zero without that line.
"""

from __future__ import annotations

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
    so = _build.build_library()
    _build.library()
    regs = [ln.split("Used")[1].strip() for ln in so.with_suffix(".log").read_text().splitlines()
            if "Used" in ln]
    print(f"phase1 build: {so.name} in {time.perf_counter() - t0:.2f} s; ptxas: {regs}")


def cells() -> dict:
    """The two sizes of the main path: GBMConfig defaults and BASELINE config 4."""
    from mcport.config import GBMConfig

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
    from mcport.config import Config, GBMConfig
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import mcport_torch  # noqa: F401  (the precision pin)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = phase_card()
    phase_build()
    worst = phase_kernel_vs_plain(dev)
    phase_law(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_main_path(dev, Path(tmp))
    ms, plain_ms = phase_timing(dev)
    check("jax" not in sys.modules and "pandas" not in sys.modules,
          "no jax or pandas imported")
    print(json.dumps({"kernels": [{
        "name": "terminal_noise", "route": "cuda",
        "source": "mcport_torch/csrc/terminal_noise.cu",
        "replaces": "mcport/ops/pallas_gbm.py:413",
        "launches": launches, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
