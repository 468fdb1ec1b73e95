"""How far four planted faults of hedged settlement exceed candidate price
bounds of the hedged DCC kernel, on the CPU.

    python3 tools/dcc_bound_faults.py        # from the repository root

On the universe of ``tests/test_torch_hedged_families.py`` (4 assets, its
GARCH parameters as the DCC base, a 0.05, b 0.9, q0 = 0.5 I + 0.5, e0 = 0),
its bench hedge, 512 paths of block 1 of seed 6, 252 steps and 5 Dirichlet
candidates (rng 2), it prints for each candidate bound on the price's
relative difference — ``ops.dcc.dcc_price_bound`` (step by step, from each
path's own volatility and condition), ``ops.dcc.dcc_tolerance`` and
``ops.garch.garch_tolerance`` on the same universe — its range at the last
step, then the largest share of the per-path bound
(``ops.hedged.hedged_multi_dd``) that each fault uses, term / dd: settlement
in bfloat16, a drawdown off by 1e-3, a dropped premium, a put settled as a
call. A bound tells a fault from a sound kernel when a share exceeds 2.
Last, the share that a sound kernel's rounding uses: the shocks moved by up
to 2e-6 at random and the recursion evaluated in float64 (other roundings,
as a contracting kernel has)."""
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
from mcport_torch.convert import dcc_params_from_numpy  # noqa: E402
from mcport_torch.models.garch_mc import CCCGarchParams  # noqa: E402
from mcport_torch.ops import dcc as OD  # noqa: E402
from mcport_torch.ops import hedged as OH  # noqa: E402
from mcport_torch.ops.garch import garch_tolerance  # noqa: E402
from mcport_torch.ops.hedged import HedgeTensors, hedged_multi_dd, hedged_shares  # noqa: E402
from mcport_torch.options import HedgeSpec  # noqa: E402
from mcport_torch.options.strategies import collar, married_put  # noqa: E402

A, N = 4, 252
S0 = np.array([100.0, 50.0, 20.0, 8.0])
NAMES = [f"A{i}" for i in range(A)]
BASE = CCCGarchParams(*(torch.as_tensor(x, dtype=torch.float64) for x in (
    [5e-4, 1e-3, 8e-4, 3e-4], [4e-6, 6e-6, 5e-6, 8e-6], [0.08, 0.12, 0.1, 0.06],
    [0.88, 0.82, 0.85, 0.9], np.linalg.cholesky(0.5 * np.eye(A) + 0.5),
    [1e-4, 2e-4, 1.5e-4, 3e-4], [1e-4, 2e-4, 3e-4, 1e-4])))
D = dcc_params_from_numpy(BASE, 0.05, 0.9, 0.5 * np.eye(A) + 0.5, np.zeros(A)).tensors("cpu")
HEDGE = HedgeTensors.from_spec(HedgeSpec.build(
    {0: married_put(S0[0], premium_put=1e-3 * S0[0]),
     1: collar(S0[1], premium_put=1e-3 * S0[1], premium_call=1e-3 * S0[1])}, NAMES), S0, "cpu")
W = torch.as_tensor(np.random.default_rng(2).dirichlet(np.ones(A), 5), dtype=torch.float32)
RIGHT = OH.hedged_returns_reference
FAULTS = {
    "bfloat16": lambda *a: RIGHT(*a).bfloat16().float(),
    "dd off by 1e-3": None,
    "premium dropped": lambda p, q, t, k, pr, qty: RIGHT(p, q, t, k, torch.zeros_like(pr), qty),
    "put as call": lambda p, q, t, k, pr, qty: RIGHT(
        p, q, torch.where(t == 4, torch.full_like(t, 2), t), k, pr, qty),
}

z = OD._shocks(6, D, 512, N, 1, 1, 0)
eps, path = OD.dcc_innovations(z, D, with_path=True)
gross = (1.0 + D.mu) + eps
# a sound kernel: shocks up to 2e-6 apart, every operation rounded otherwise (float64)
gen = torch.Generator().manual_seed(1)
z_k = z.double() + 2e-6 * (2.0 * torch.rand(z.shape, generator=gen, dtype=torch.float64) - 1.0)
rsqrt, sqrt = OD.rsqrt_rn, OD.sqrt_rn
OD.rsqrt_rn, OD.sqrt_rn = torch.rsqrt, torch.sqrt
eps_k = OD.dcc_innovations(z_k, OD.DccTensors(*(x.double() for x in D))).float()
OD.rsqrt_rn, OD.sqrt_rn = rsqrt, sqrt
sound = hedged_multi_dd((1.0 + D.mu) + eps_k, HEDGE, W, gross=True)

bounds = {"dcc_price_bound": OD.dcc_price_bound(D, path),
          "dcc_tolerance": OD.dcc_tolerance(D, N),
          "garch_tolerance": garch_tolerance(BASE.tensors("cpu"), N)}
for bname, delta in bounds.items():
    last = delta[..., -1, :] if delta.dim() > 1 else delta
    right = hedged_multi_dd(gross, HEDGE, W, price_bound=delta, gross=True)
    cells = []
    for fname, settle in FAULTS.items():
        OH.hedged_returns_reference = settle or RIGHT
        wrong = hedged_multi_dd(gross, HEDGE, W, gross=True)
        OH.hedged_returns_reference = RIGHT
        if settle is None:
            wrong = (wrong[0], wrong[1] - 1e-3)
        sh = hedged_shares(wrong, right, None)
        cells.append(f"{fname} {sh['term']:.3g} / {sh['dd']:.3g}")
    sh = hedged_shares(sound, right, None)
    print(f"{bname} (at step {N}: {float(last.min()):.3e} .. {float(last.max()):.3e}): "
          + ", ".join(cells) + f"; a sound kernel {sh['term']:.3g} / {sh['dd']:.3g}")
