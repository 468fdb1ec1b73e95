#!/usr/bin/env python3
"""Where the time of one warm call of the PyTorch port's main paths goes on a card.

    python3 tools/profile_gbm_risk.py [gbm|family|garch-bootstrap|merton-heston|dcc]
    # needs one CUDA card; gbm, family and dcc by default

GBM tier: for each size of ``chip_smoke.py``'s main paths (GBMConfig
defaults and BASELINE config-4 scale, on the bench's synthetic 15-asset
universe) it profiles ``mcport_torch.api.gbm_risk`` and ``run_path_risk``
(buy-and-hold, normal shocks; hedged with the smoke's married put and
collar at spot 100), and then ``drawdown_frontier_search`` at the
bench's size (4,096 candidates x 131,072 paths x 252 steps) in its default
tier ("auto", float32 on a card) and as the bf16 screen plus rescore. Family
tier: ``garch_risk`` and ``bootstrap_risk`` at 1,048,576 x 252 (the bench's
GARCH parameters, a 365 x 15 history), ``run_garch_path_risk`` and
``run_bootstrap_path_risk`` at both sizes, and both family frontiers at the
bench's size (alone: ``garch-bootstrap``); then (alone: ``merton-heston``)
the Merton and Heston families
at the bench's parameters: ``merton_risk`` and ``heston_terminal_returns`` at
1,048,576 x 252, ``run_merton_path_risk`` and ``run_heston_path_risk`` at
both sizes, and both frontiers. DCC tier: ``dcc_risk`` at 1,048,576 x 52 (bench.py's DCC
parameters and horizon), ``run_dcc_path_risk`` at both sizes, the DCC
frontier at the bench's size, and ``compare_tail_risk`` on the weekly BTC/ETH
fixtures at the ``compare-models`` defaults (262,144 paths x 52 steps,
estimation included). For each call it prints:

- the warm walls without a checkpoint (host clock, ending in a synchronise),
  after one call that warms up;
- one more call under ``torch.profiler``: its wall, the device's busy time
  (the union of the intervals of its kernels, copies and fills), the idle
  share of the wall, the number of kernel launches and of host
  synchronisations, and the device kernels and host calls that take longest.

Imports neither jax nor pandas. The kernel is built on first use, as in
``chip_smoke.py``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
REPS, TOP = 3, 12      # warm walls per size; rows of each ranking


def _busy_us(spans: list[tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, -float("inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _trace(prof) -> list[dict]:
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _top(events: list[dict], n: int) -> list[str]:
    total, count = defaultdict(float), defaultdict(int)
    for e in events:
        total[e["name"]] += e["dur"]
        count[e["name"]] += 1
    rows = sorted(total, key=total.get, reverse=True)[:n]
    return [f"{total[k] / 1e3:10.3f} ms x {count[k]:5d}  {k[:100]}" for k in rows]


def profile_cell(name, fn) -> None:
    def call() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    call()
    walls = [call() for _ in range(REPS)]
    print(f"{name} warm walls ms {' / '.join(f'{t * 1e3:.2f}' for t in walls)}")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall = call()
    events = _trace(prof)
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
    busy = _busy_us([(e["ts"], e["ts"] + e["dur"]) for e in device]) / 1e3
    launches = sum("LaunchKernel" in e["name"] for e in runtime)
    syncs = sum("Synchronize" in e["name"] for e in runtime)
    print(f"{name} profiled wall {wall * 1e3:.2f} ms, device busy {busy:.2f} ms "
          f"(union of {len(device)} device events), idle share of wall "
          f"{1 - busy / (wall * 1e3):.3f}, launches {launches}, syncs {syncs}")
    if not device:
        print(f"{name}: the profiler recorded no device events")
    print("\n".join(f"  device {ln}" for ln in _top(device, TOP)))
    print("\n".join(f"  host   {ln}" for ln in _top(runtime, TOP)))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_gbm_risk: no CUDA device visible to torch", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (DCC_STEPS, FAMILY_PATHS, FAMILY_SEED, FRONTIER, FRONTIER_SEED,
                            N_ASSETS, SPOT, bench_dcc, bench_garch, bench_hedge, bench_heston,
                            bench_history, bench_merton, bench_universe, bench_weights, cells)
    from mcport_torch.api import compare_tail_risk, gbm_risk
    from mcport_torch.config import Config
    from mcport_torch.convert import gbm_params_from_numpy
    from mcport_torch.engine.drawdown_frontier import (drawdown_frontier_search,
                                                       family_drawdown_frontier_search)
    from mcport_torch.engine.path_risk import (run_bootstrap_path_risk, run_dcc_path_risk,
                                               run_garch_path_risk, run_heston_path_risk,
                                               run_merton_path_risk, run_path_risk)
    from mcport_torch.models.bootstrap import bootstrap_risk
    from mcport_torch.models.dcc import dcc_risk
    from mcport_torch.models.garch_mc import garch_risk
    from mcport_torch.models.heston import heston_terminal_returns
    from mcport_torch.models.jump import merton_risk

    tiers = sys.argv[1:] or ["gbm", "family", "dcc"]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip())
    dev = torch.device("cuda", 0)
    mean, chol = bench_universe()
    params = gbm_params_from_numpy(np.ones(N_ASSETS), mean, chol)
    w = np.full(N_ASSETS, 1.0 / N_ASSETS)
    front = f"({FRONTIER['n_candidates']} x {FRONTIER['n_paths']} x {FRONTIER['n_steps']})"
    if "gbm" in tiers:
        for name, g in cells().items():
            size = f"{name} ({g.n_paths} x {g.n_steps}, block {g.path_block})"
            profile_cell(f"gbm_risk {size}",
                         lambda g=g: gbm_risk(params, w, Config(gbm=g), device=dev))
            profile_cell(f"run_path_risk {size}",
                         lambda g=g: run_path_risk(params, w, g, device=dev))
        spots = np.full(N_ASSETS, SPOT)
        hedged = gbm_params_from_numpy(spots, mean, chol)
        spec = bench_hedge(spots)[1]
        for name, g in cells().items():
            size = f"{name} ({g.n_paths} x {g.n_steps}, block {g.path_block})"
            profile_cell(f"run_path_risk hedged {size}",
                         lambda g=g: run_path_risk(hedged, w, g, hedge=spec, device=dev))
        for sd in ("auto", "bfloat16"):
            profile_cell(f"drawdown_frontier_search {sd} {front}",
                         lambda sd=sd: drawdown_frontier_search(FRONTIER_SEED, params,
                                                                score_dtype=sd, device=dev,
                                                                **FRONTIER))
    steps, wb = FRONTIER["n_steps"], bench_weights()
    if "family" in tiers or "garch-bootstrap" in tiers:
        garch, hist = bench_garch(), bench_history()
        profile_cell(f"garch_risk ({FAMILY_PATHS} x {steps})",
                     lambda: garch_risk(FAMILY_SEED, garch, wb, FAMILY_PATHS, steps,
                                        device=dev))
        profile_cell(f"bootstrap_risk ({FAMILY_PATHS} x {steps})",
                     lambda: bootstrap_risk(FAMILY_SEED, hist, wb, FAMILY_PATHS, steps,
                                            device=dev))
        for name, g in cells().items():
            size = f"{name} ({g.n_paths} x {g.n_steps}, block {g.path_block})"
            profile_cell(f"run_garch_path_risk {size}",
                         lambda g=g: run_garch_path_risk(garch, wb, g, device=dev))
            profile_cell(f"run_bootstrap_path_risk {size}",
                         lambda g=g: run_bootstrap_path_risk(hist, wb, g, device=dev))
        for model, src in (("garch", garch), ("bootstrap", hist)):
            profile_cell(f"family_drawdown_frontier_search {model} {front}",
                         lambda model=model, src=src: family_drawdown_frontier_search(
                             FRONTIER_SEED, model, src, device=dev, **FRONTIER))
    if "family" in tiers or "merton-heston" in tiers:
        merton, heston = bench_merton(), bench_heston()
        profile_cell(f"merton_risk ({FAMILY_PATHS} x {steps})",
                     lambda: merton_risk(FAMILY_SEED, merton, wb, FAMILY_PATHS, steps,
                                         device=dev))
        profile_cell(f"heston_terminal_returns ({FAMILY_PATHS} x {steps})",
                     lambda: heston_terminal_returns(FAMILY_SEED, heston, FAMILY_PATHS, steps,
                                                     device=dev))
        for name, g in cells().items():
            size = f"{name} ({g.n_paths} x {g.n_steps}, block {g.path_block})"
            profile_cell(f"run_merton_path_risk {size}",
                         lambda g=g: run_merton_path_risk(merton, wb, g, device=dev))
            profile_cell(f"run_heston_path_risk {size}",
                         lambda g=g: run_heston_path_risk(heston, wb, g, device=dev))
        for model, src in (("jump", merton), ("heston", heston)):
            profile_cell(f"family_drawdown_frontier_search {model} {front}",
                         lambda model=model, src=src: family_drawdown_frontier_search(
                             FRONTIER_SEED, model, src, device=dev, **FRONTIER))
    if "dcc" in tiers:
        from mcport_torch.config import DataConfig, GBMConfig
        from mcport_torch.data import load_universe

        dcc, wb = bench_dcc(), bench_weights()
        profile_cell(f"dcc_risk ({FAMILY_PATHS} x {DCC_STEPS})",
                     lambda: dcc_risk(FAMILY_SEED, dcc, wb, FAMILY_PATHS, DCC_STEPS,
                                      device=dev))
        for name, g in cells().items():
            size = f"{name} ({g.n_paths} x {g.n_steps}, block {g.path_block})"
            profile_cell(f"run_dcc_path_risk {size}",
                         lambda g=g: run_dcc_path_risk(dcc, wb, g, device=dev))
        profile_cell(f"family_drawdown_frontier_search dcc {front}",
                     lambda: family_drawdown_frontier_search(FRONTIER_SEED, "dcc", dcc,
                                                             device=dev, **FRONTIER))
        weekly = load_universe(sorted(str(p) for p in (ROOT / "fixtures").glob(
            "*7 Years Weekly.csv")), DataConfig(period="W"))
        cmp_cfg = Config(gbm=GBMConfig(n_paths=262_144, n_steps=52, path_block=8_192))
        profile_cell("compare_tail_risk weekly BTC/ETH (262,144 x 52, estimation included)",
                     lambda: compare_tail_risk(weekly, None, cmp_cfg, device=dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
