#!/usr/bin/env python3
"""Where the time of one warm gbm-risk call of the PyTorch port goes on a card.

    python3 tools/profile_gbm_risk.py        # needs one CUDA card

For each size of ``chip_smoke.py``'s main path (GBMConfig defaults and
BASELINE config-4 scale, on the bench's synthetic 15-asset universe) it prints:

- the warm walls of ``mcport_torch.api.gbm_risk`` without a checkpoint (host
  clock, ending in a synchronise), after one call that warms up;
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


def profile_cell(name, g, params, w, dev) -> None:
    from mcport.config import Config
    from mcport_torch.api import gbm_risk

    def call() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gbm_risk(params, w, Config(gbm=g), device=dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    call()
    walls = [call() for _ in range(REPS)]
    print(f"{name} ({g.n_paths} x {g.n_steps}, block {g.path_block}) warm walls ms "
          f"{' / '.join(f'{t * 1e3:.2f}' for t in walls)}")

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
    from chip_smoke import N_ASSETS, bench_universe, cells
    from mcport_torch.convert import gbm_params_from_numpy

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip())
    dev = torch.device("cuda", 0)
    mean, chol = bench_universe()
    params = gbm_params_from_numpy(np.ones(N_ASSETS), mean, chol)
    w = np.full(N_ASSETS, 1.0 / N_ASSETS)
    for name, g in cells().items():
        profile_cell(name, g, params, w, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
