"""Same-call A/B of two trees' kernels, timed with CUDA events in turns:
other / this / this / other.

- The unhedged candidate kernels in their narrow layouts (GARCH, bootstrap,
  Heston; at 256 x 131,072 x 252 on the bench universe), the Heston
  terminal kernel (1,048,576 x 252), the narrow DCC terminal kernel (15
  assets, 1,048,576 x 52).
- The DCC kernels past 16 assets (``dcc_group_kernel`` in this tree): their
  outputs against the other tree's with ``torch.equal`` (the terminal, the
  candidates at W = 1, 64 and 256, the hedged mode with every leg type) at A
  = 17, 33, 64, 65, 200 and 256, then timed at the widths and shapes of
  the DCC predictions in PERF.md §6 (each turn the best of three timings of two
  launches, each tree its best turn; the timed outputs held equal too).
- The narrow DCC candidate kernel (``dcc_dd_kernel``, A <= 16): its outputs
  against the other tree's with ``torch.equal`` at A = 1, 7, 15 and 16, W =
  1, 5 and 256, unhedged and hedged (two legs per asset of every type), then
  timed the same way at the bench universe: W = 256 at 256 x 131,072 x 52
  and W = 1 at 131,072 x 252, each unhedged and hedged.
- First, per library, whether each kernel of the other tree has this tree's
  instructions (``cuobjdump -sass``; a template parameter added with its
  default, ``<16>`` against ``<16, false>``, names the same kernel, as does
  a kernel made a template against its ``<false>`` instantiation, and
  kernel-parameter offsets ``c[0x0][...]`` are masked, so an added
  parameter alone does not count as a change); every kernel but the
  redesigned DCC ones (``REDESIGNED``) must keep them.

    git archive <commit> mcport_torch | tar -x -C DIR    # the other tree
    python3 tools/ab_narrow_kernels.py DIR              # from the repository root

Needs one card; builds both trees' GARCH, bootstrap, Heston and DCC
libraries. Exits 1 when a kept kernel changed its SASS or a DCC output
differs from the other tree's."""
import math
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


#: the other tree's DCC kernels that this tree redesigns: past 16 assets, and
#: the narrow candidate kernel
REDESIGNED = ("dcc_wide_kernel", "dcc_wider_kernel", "dcc_group_kernel", "dcc_dd_kernel")
mods = {"other": load(sys.argv[1]), "this": load(".")}
kept = [0, 0]
for fam in FAMILIES:
    libs = {}
    for side, root in (("other", sys.argv[1]), ("this", ".")):
        libs[side] = sorted((Path(root) / "mcport_torch" / "build").glob(f"lib{fam}_*.so"),
                            key=lambda p: p.stat().st_mtime)[-1]
    a, b = sass(libs["other"]), sass(libs["this"])
    for key, ins in sorted(a.items()):
        same = b.get(key) == ins
        redesigned = any(r in key for r in REDESIGNED)
        kept[0] += int(same and not redesigned)
        kept[1] += int(not redesigned)
        print(f"sass {fam} {key}: {len(ins)} instructions, "
              f"{'the same in this tree' if same else 'CHANGED' if key in b else 'not found'}"
              f"{' (redesigned)' if redesigned else ''}")
print(f"sass: {kept[0]} of {kept[1]} kept kernels the same in this tree")


def simplex(a, n, seed=0):
    return torch.as_tensor(np.random.default_rng(seed + a).dirichlet(np.ones(a), n),
                           dtype=torch.float32, device=dev)


def bits(out):
    return [x.clone().view(torch.int32) for x in (out if isinstance(out, tuple) else (out,))]


def run_on(side, fn):
    """fn(D) with side's package in sys.modules (its launchers import their
    own _build at call time)."""
    sys.modules.update(mods[side][4])
    out = fn(mods[side][3])
    torch.cuda.synchronize()
    return out


# ---- the DCC kernels past 16 assets: outputs bit for bit -------------------------
DCC_A = (17, 33, 64, 65, 200, 256)
unequal = []
for a in DCC_A:
    d = S.bench_dcc(a).tensors(dev)
    legs = S.leg_mix(a, 2, dev, seed=a)
    w = {n: simplex(a, n) for n in (1, 64, 256)}
    paths, steps = (515, 13) if a <= 64 else (131, 9)
    kw = dict(first_block=6, n_blocks=2)
    cases = {"terminal": lambda D: D.dcc_terminal(11, d, paths, steps, **kw)}
    for n in (1, 64, 256):
        cases[f"candidates W={n}"] = (lambda D, n=n: D.dcc_multi_portfolio_dd(
            11, d, w[n], paths, steps, **kw))
        cases[f"hedged W={n} L=2"] = (lambda D, n=n: D.dcc_multi_portfolio_dd(
            11, d, w[n], paths, steps, hedge=legs, **kw))
    for name, fn in cases.items():
        x, y = bits(run_on("other", fn)), bits(run_on("this", fn))
        same = all(torch.equal(p, q) for p, q in zip(x, y))
        if not same:
            unequal.append(f"A={a} {name}")
        print(f"equal dcc A={a} {name} ({paths} x 2 blocks x {steps}): "
              f"{'bit for bit' if same else 'DIFFERENT'}")

# ---- the narrow DCC candidate kernel: outputs bit for bit ---------------------------
for a in (1, 7, 15, 16):
    d = S.bench_dcc(a).tensors(dev)
    legs = S.leg_mix(a, 2, dev, seed=a)
    kw = dict(first_block=6, n_blocks=2)
    for n in (1, 5, 256):
        w = simplex(a, n)
        for hedge in (None, legs):
            name = f"W={n}" + (" hedged L=2" if hedge is not None else "")
            fn = (lambda D, w=w, hedge=hedge: D.dcc_multi_portfolio_dd(
                11, d, w, 1_029, 52, hedge=hedge, **kw))
            x, y = bits(run_on("other", fn)), bits(run_on("this", fn))
            same = all(torch.equal(p, q) for p, q in zip(x, y))
            if not same:
                unequal.append(f"narrow A={a} {name}")
            print(f"equal dcc_dd A={a} {name} (1,029 x 2 blocks x 52): "
                  f"{'bit for bit' if same else 'DIFFERENT'}")

# ---- timing, in turns ---------------------------------------------------------------
cand = simplex(15, 256, seed=-15)
pp, p_term = 131_072, 1 << 20
g = S.bench_garch().tensors(dev)
hist = torch.as_tensor(S.bench_history(), device=dev)
hp = S.bench_heston().tensors(dev)
d15 = S.bench_dcc(15).tensors(dev)
#: (function, A, paths, steps): the DCC predictions in PERF.md §6, then the other widths
DCC_TIMED = (("terminal", 256, 4_096, 8), ("candidates", 256, 4_096, 8), ("hedged", 256, 1_024, 16),
             ("terminal", 64, 65_536, 52), ("candidates", 64, 4_096, 52), ("hedged", 64, 4_096, 52),
             ("terminal", 17, 65_536, 52), ("candidates", 17, 4_096, 52), ("hedged", 17, 4_096, 52),
             ("terminal", 33, 65_536, 52), ("candidates", 33, 4_096, 52), ("hedged", 33, 4_096, 52),
             ("terminal", 65, 16_384, 16), ("candidates", 65, 4_096, 16), ("hedged", 65, 4_096, 16),
             ("terminal", 200, 4_096, 8), ("candidates", 200, 4_096, 8), ("hedged", 200, 1_024, 16))
#: the narrow candidate kernel at the bench universe: (name, W, paths, steps, hedged)
NARROW_TIMED = (("W=256", 256, pp, 52, False), ("W=256 hedged", 256, pp, 52, True),
                ("W=1", 1, pp, 252, False), ("W=1 hedged", 1, pp, 252, True))
w_one = torch.as_tensor(S.bench_weights()[None], dtype=torch.float32, device=dev)
dcc_in = {}
for a in sorted({c[1] for c in DCC_TIMED}):
    spots = np.full(a, S.SPOT)
    from mcport_torch.ops.hedged import HedgeTensors

    dcc_in[a] = (S.bench_dcc(a).tensors(dev), simplex(a, 256),
                 HedgeTensors.from_spec(S.bench_hedge(spots)[1], spots, dev))
spots15 = np.full(15, S.SPOT)
h15 = HedgeTensors.from_spec(S.bench_hedge(spots15)[1], spots15, dev)


def dcc_call(fun, a, n, steps):
    d, w, hedge = dcc_in[a]
    if fun == "terminal":
        return lambda D: D.dcc_terminal(0, d, n, steps)
    return lambda D: D.dcc_multi_portfolio_dd(0, d, w, n, steps,
                                              hedge=hedge if fun == "hedged" else None)


res, firsts = {}, {}
for order in ("other", "this", "this", "other"):
    G, O, H, D, side = mods[order]
    sys.modules.update(side)
    runs = {"garch": (("garch_multi_dd <16>", lambda: G._launch_dd(0, g, cand, pp, 252, -1, 1)),
                      ("garch_multi_dd <64>",
                       lambda: G._launch_dd(0, g, cand, pp, 252, -1, 1, wide=True))),
            "bootstrap": (("bootstrap_multi_dd",
                           lambda: O.bootstrap_multi_portfolio_dd(0, hist, cand, pp, 252)),),
            "heston": (("heston_multi_dd <16>", lambda: H._launch_dd(0, hp, cand, pp, 252, -1, 1)),
                       ("heston_multi_dd <64>",
                        lambda: H._launch_dd(0, hp, cand, pp, 252, -1, 1, wide=True)),
                       ("heston_terminal", lambda: H.heston_terminal(0, hp, p_term, 252))),
            "dcc": (("dcc_terminal <15>", lambda: D.dcc_terminal(0, d15, p_term, 52)),)}
    for fam in FAMILIES:
        for name, fn in runs[fam]:
            fn()
            torch.cuda.synchronize()
            res.setdefault((name, order), []).append(S._time_ms(fn, 5))
    for label, n, paths, steps, hedged in NARROW_TIMED:
        def call(D, n=n, paths=paths, steps=steps, hedged=hedged):
            return D.dcc_multi_portfolio_dd(0, d15, cand if n > 1 else w_one, paths, steps,
                                            hedge=h15 if hedged else None)
        out = call(D)
        torch.cuda.synchronize()
        firsts.setdefault((label, 15, order), bits(out))
        name = f"dcc_dd {label} A=15 {n} x {paths} x {steps}"
        res.setdefault((name, order), []).append(min(S._time_ms(lambda: call(D), 2)
                                                     for _ in range(3)))
    for fun, a, n, steps in DCC_TIMED:
        call = dcc_call(fun, a, n, steps)
        out = call(D)
        torch.cuda.synchronize()
        firsts.setdefault((fun, a, order), bits(out))
        name = f"dcc {fun} A={a} {'256 x ' if fun != 'terminal' else ''}{n} x {steps}"
        # the best of three timings of two launches: a turn's first launches
        # can wait on the host (allocations, a shared CPU)
        res.setdefault((name, order), []).append(min(S._time_ms(lambda: call(D), 2)
                                                     for _ in range(3)))
for (name, order), t in sorted(res.items()):
    print(f"ab {name} {order}: " + " / ".join(f"{x:.3f}" for x in t) + " ms")
for label, n, paths, steps, hedged in NARROW_TIMED:
    name = f"dcc_dd {label} A=15 {n} x {paths} x {steps}"
    other, this = min(res[(name, "other")]), min(res[(name, "this")])
    same = all(torch.equal(p, q) for p, q in zip(firsts[(label, 15, "other")],
                                                  firsts[(label, 15, "this")]))
    if not same:
        unequal.append(name)
    print(f"speedup {name}: {other:.3f} -> {this:.3f} ms, {other / this:.2f}x, outputs "
          f"{'bit for bit' if same else 'DIFFERENT'}")
worst_64_256, worst_slower = math.inf, 0.0
for fun, a, n, steps in DCC_TIMED:
    name = f"dcc {fun} A={a} {'256 x ' if fun != 'terminal' else ''}{n} x {steps}"
    other, this = min(res[(name, "other")]), min(res[(name, "this")])
    same = all(torch.equal(p, q) for p, q in zip(firsts[(fun, a, "other")],
                                                  firsts[(fun, a, "this")]))
    if not same:
        unequal.append(name)
    print(f"speedup {name}: {other:.3f} -> {this:.3f} ms, {other / this:.2f}x, outputs "
          f"{'bit for bit' if same else 'DIFFERENT'}")
    if a in (64, 256):
        worst_64_256 = min(worst_64_256, other / this)
    worst_slower = max(worst_slower, this / other - 1.0)
print(f"summary: sass {kept[0]} of {kept[1]} kept; DCC outputs "
      f"{'all bit for bit' if not unequal else 'DIFFERENT: ' + ', '.join(unequal)}; "
      f"least speedup at A = 64 and 256 {worst_64_256:.2f}x; most slower "
      f"{100 * worst_slower:.2f}%")
sys.exit(0 if kept[0] == kept[1] and not unequal else 1)
