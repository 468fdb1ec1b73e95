"""How far four planted faults of hedged settlement exceed candidate price
bounds of the hedged Heston kernel, on the CPU.

    python3 tools/heston_bound_faults.py        # from the repository root

For each Heston universe (the bench's variance 4e-4 per step, and the
long-run variances 1-2e-4 of ``tests/test_torch_hedged_families.py``) and
each candidate bound on the price's relative difference at 252 steps — the
worst case summed step by step, ``n · 10 · 2^-24`` and ``n · 6 · 2^-24``,
and the random walk of ``ops.heston.heston_price_bound`` — it prints the
largest share of the per-path bound (``ops.hedged.hedged_multi_dd``) that
each fault uses: settlement in bfloat16, a drawdown off by 1e-3, a dropped
premium, a put settled as a call. A bound tells a fault from a sound
kernel when the share exceeds 2. The faults, hedge and weights are those
of the tests (512 paths, 5 candidates, the bench hedge)."""
import math
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
from mcport_torch.convert import heston_params_from_numpy  # noqa: E402
from mcport_torch.ops import hedged as OH  # noqa: E402
from mcport_torch.ops import heston as OHS  # noqa: E402
from mcport_torch.ops.hedged import HedgeTensors, hedged_multi_dd, hedged_shares  # noqa: E402
from mcport_torch.options import HedgeSpec  # noqa: E402
from mcport_torch.options.strategies import collar, married_put  # noqa: E402

A, N = 4, 252
S0 = np.array([100.0, 50.0, 20.0, 8.0])
NAMES = [f"A{i}" for i in range(A)]
EPS = 2.0 ** -24
HEDGE = HedgeTensors.from_spec(HedgeSpec.build(
    {0: married_put(S0[0], premium_put=1e-3 * S0[0]),
     1: collar(S0[1], premium_put=1e-3 * S0[1], premium_call=1e-3 * S0[1])}, NAMES), S0, "cpu")
W = torch.as_tensor(np.random.default_rng(2).dirichlet(np.ones(A), 5), dtype=torch.float32)
RIGHT = OH.hedged_returns_reference


def universe(var):
    return heston_params_from_numpy(
        np.array([5e-4, 1e-3, 8e-4, 3e-4]), np.array([0.15, 0.1, 0.2, 0.15]), var,
        np.array([3e-3, 4e-3, 2e-3, 3e-3]), np.array([-0.5, -0.4, -0.6, -0.5]), var,
        np.linalg.cholesky(0.5 * np.eye(A) + 0.5), S0).tensors("cpu")


FAULTS = {
    "bfloat16": lambda *a: RIGHT(*a).bfloat16().float(),
    "premium dropped": lambda p, q, t, k, pr, qty: RIGHT(p, q, t, k, torch.zeros_like(pr), qty),
    "put as call": lambda p, q, t, k, pr, qty: RIGHT(
        p, q, torch.where(t == 4, torch.full_like(t, 2), t), k, pr, qty),
    "dd off by 1e-3": None,
}
UNIVERSES = {"variance 4e-4": np.full(A, 4e-4),
             "variance 1-2e-4": np.array([1e-4, 1e-4, 1e-4, 2e-4])}
for uname, var in UNIVERSES.items():
    h = universe(var)
    x = OHS.heston_increments(*OHS.heston_shocks(6, h, 512, N, first_block=1, n_blocks=1), h)
    bounds = {"n x 10 x 2^-24": N * 10 * EPS, "n x 6 x 2^-24": N * 6 * EPS,
              "heston_price_bound": float(OHS.heston_price_bound(h, N)[0])}
    for bname, delta in bounds.items():
        right = hedged_multi_dd(x, HEDGE, W, price_bound=torch.full((A,), delta))
        shares = {}
        for fname, settle in FAULTS.items():
            OH.hedged_returns_reference = settle or RIGHT
            wrong = hedged_multi_dd(x, HEDGE, W)
            OH.hedged_returns_reference = RIGHT
            if settle is None:
                wrong = (wrong[0], wrong[1] - 1e-3)
            shares[fname] = max(hedged_shares(wrong, right, None).values())
        print(f"{uname}, bound {bname} = {delta:.4e}: " + ", ".join(
            f"{k} {v:.3g}" if math.isfinite(v) else f"{k} inf" for k, v in shares.items()))
