"""Same-call A/B of two trees' unhedged GARCH and bootstrap candidate kernels
(the narrow layouts, at 256 x 131,072 x 252 on the bench universe), timed
with CUDA events in turns: other / this / this / other.

    git archive <commit> mcport_torch | tar -x -C DIR    # the other tree
    python3 tools/ab_narrow_kernels.py DIR              # from the repository root

Needs one card; builds both trees' libraries."""
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as S

dev = torch.device("cuda", 0)
print(S.phase_card())


def load(root):
    for m in [m for m in sys.modules if m == "mcport_torch" or m.startswith("mcport_torch.")]:
        del sys.modules[m]
    sys.path.insert(0, root)
    import mcport_torch._build as B
    B.build_libraries(("garch", "bootstrap"))
    import mcport_torch.ops.garch as G
    import mcport_torch.ops.bootstrap as O
    sys.path.remove(root)
    mods = {m: v for m, v in sys.modules.items()
            if m == "mcport_torch" or m.startswith("mcport_torch.")}
    return G, O, mods


mods = {"other": load(sys.argv[1]), "this": load(".")}
cand = torch.as_tensor(np.random.default_rng(0).dirichlet(np.ones(15), 256), dtype=torch.float32,
                       device=dev)
pp = 131_072
g = S.bench_garch().tensors(dev)
h = torch.as_tensor(S.bench_history(), device=dev)
res = {}
for order in ("other", "this", "this", "other"):
    G, O, side = mods[order]
    sys.modules.update(side)   # the launchers import their own package's _build at call time
    runs = (("garch_multi_dd <16>", lambda: G._launch_dd(0, g, cand, pp, 252, -1, 1)),
            ("garch_multi_dd <64>", lambda: G._launch_dd(0, g, cand, pp, 252, -1, 1, wide=True)),
            ("bootstrap_multi_dd", lambda: O.bootstrap_multi_portfolio_dd(0, h, cand, pp, 252)))
    for name, fn in runs:
        fn()
        torch.cuda.synchronize()
        res.setdefault((name, order), []).append(S._time_ms(fn, 5))
for (name, order), t in sorted(res.items()):
    print(f"ab {name} {order}: " + " / ".join(f"{x:.3f}" for x in t) + " ms")
