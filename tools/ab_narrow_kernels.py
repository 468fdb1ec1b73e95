"""Same-call A/B of two trees' unhedged candidate kernels in their narrow
layouts (GARCH, bootstrap, Heston; at 256 x 131,072 x 252 on the bench
universe), the Heston terminal kernel (1,048,576 x 252) and the three DCC
candidate kernels and its terminal kernel (``dcc_dd_kernel`` at 15 assets,
256 x 131,072 x 52; ``dcc_wide_kernel`` at 64, 256 x 16,384 x 52;
``dcc_wider_kernel`` at 65, 256 x 4,096 x 16; the terminal at 1,048,576 x
52), timed with CUDA events in turns: other / this / this / other. First,
per library, whether each kernel of the other tree has this tree's
instructions (``cuobjdump -sass``; a template parameter added with its
default, ``<16>`` against ``<16, false>``, names the same kernel, as does a
kernel made a template against its ``<false>`` instantiation, and
kernel-parameter offsets ``c[0x0][...]`` are masked, so an added parameter
alone does not count as a change).

    git archive <commit> mcport_torch | tar -x -C DIR    # the other tree
    python3 tools/ab_narrow_kernels.py DIR              # from the repository root

Needs one card; builds both trees' GARCH, bootstrap and Heston libraries."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as S

FAMILIES = ("garch", "bootstrap", "heston", "dcc")
dev = torch.device("cuda", 0)
print(S.phase_card())


def load(root):
    for m in [m for m in sys.modules if m == "mcport_torch" or m.startswith("mcport_torch.")]:
        del sys.modules[m]
    sys.path.insert(0, root)
    import mcport_torch._build as B
    B.build_libraries(FAMILIES)
    import mcport_torch.ops.bootstrap as O
    import mcport_torch.ops.dcc as D
    import mcport_torch.ops.garch as G
    import mcport_torch.ops.heston as H
    sys.path.remove(root)
    mods = {m: v for m, v in sys.modules.items()
            if m == "mcport_torch" or m.startswith("mcport_torch.")}
    return G, O, H, D, mods


def sass(so: Path) -> dict:
    """``{kernel key: [instruction, ...]}`` of a library, parameter offsets
    masked; the key drops the anonymous namespace, a trailing ``false``
    template argument, the parameter types, and a lone ``<false>`` (a kernel
    made a template keys as the plain kernel it was)."""
    from torch.utils.cpp_extension import CUDA_HOME

    text = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    out, key = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            key = re.sub(r"_GLOBAL__N__\w+?_[0-9a-f]{8}", "", m.group(1))
            key = re.sub(r"(kernel)E[a-zA-Z]\w*$", r"\1E", re.sub(r"Ev\w*$", "", key))
            while "ELb0EE" in key:
                key = key.replace("ELb0EE", "EE")
            key = re.sub(r"ILb0EE$", "E", key)
            out[key] = []
        elif key and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            ins = re.sub(r"/\*.*?\*/", "", line).strip()
            out[key].append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][P]", ins))
    return out


mods = {"other": load(sys.argv[1]), "this": load(".")}
for fam in FAMILIES:
    libs = {}
    for side, root in (("other", sys.argv[1]), ("this", ".")):
        libs[side] = sorted((Path(root) / "mcport_torch" / "build").glob(f"lib{fam}_*.so"),
                            key=lambda p: p.stat().st_mtime)[-1]
    a, b = sass(libs["other"]), sass(libs["this"])
    for key, ins in sorted(a.items()):
        same = b.get(key) == ins
        print(f"sass {fam} {key}: {len(ins)} instructions, "
              f"{'the same in this tree' if same else 'CHANGED' if key in b else 'not found'}")
cand = torch.as_tensor(np.random.default_rng(0).dirichlet(np.ones(15), 256), dtype=torch.float32,
                       device=dev)
pp, p_term = 131_072, 1 << 20
g = S.bench_garch().tensors(dev)
hist = torch.as_tensor(S.bench_history(), device=dev)
hp = S.bench_heston().tensors(dev)
dccs = {a: S.bench_dcc(a).tensors(dev) for a in (15, 64, 65)}
dcand = {a: torch.as_tensor(np.random.default_rng(a).dirichlet(np.ones(a), 256),
                            dtype=torch.float32, device=dev) for a in (64, 65)}
dcand[15] = cand
res = {}
for order in ("other", "this", "this", "other"):
    G, O, H, D, side = mods[order]
    sys.modules.update(side)   # the launchers import their own package's _build at call time
    runs = {"garch": (("garch_multi_dd <16>", lambda: G._launch_dd(0, g, cand, pp, 252, -1, 1)),
                      ("garch_multi_dd <64>",
                       lambda: G._launch_dd(0, g, cand, pp, 252, -1, 1, wide=True))),
            "bootstrap": (("bootstrap_multi_dd",
                           lambda: O.bootstrap_multi_portfolio_dd(0, hist, cand, pp, 252)),),
            "heston": (("heston_multi_dd <16>", lambda: H._launch_dd(0, hp, cand, pp, 252, -1, 1)),
                       ("heston_multi_dd <64>",
                        lambda: H._launch_dd(0, hp, cand, pp, 252, -1, 1, wide=True)),
                       ("heston_terminal", lambda: H.heston_terminal(0, hp, p_term, 252))),
            "dcc": (("dcc_dd <15>", lambda: D._launch_dd(0, dccs[15], dcand[15], pp, 52, -1, 1)),
                    ("dcc_dd wide <64>",
                     lambda: D._launch_dd(0, dccs[64], dcand[64], 16_384, 52, -1, 1)),
                    ("dcc_dd wider <65>",
                     lambda: D._launch_dd(0, dccs[65], dcand[65], 4_096, 16, -1, 1)),
                    ("dcc_terminal", lambda: D.dcc_terminal(0, dccs[15], p_term, 52)))}
    for fam in FAMILIES:
        for name, fn in runs[fam]:
            fn()
            torch.cuda.synchronize()
            res.setdefault((name, order), []).append(S._time_ms(fn, 5))
for (name, order), t in sorted(res.items()):
    print(f"ab {name} {order}: " + " / ".join(f"{x:.3f}" for x in t) + " ms")
