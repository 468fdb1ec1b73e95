"""Same-call A/B of two trees' kernels, timed with CUDA events in turns:
other / this / this / other.

    git archive <commit> mcport_torch | tar -x -C DIR    # the other tree
    python3 tools/ab_narrow_kernels.py DIR [merton-heston|garch-bootstrap|dcc|gbm|terminal|all]

- First, per library (jump, Heston, GARCH, bootstrap, DCC, multi-dd, path
  stats), whether each
  kernel of the other tree has this tree's instructions (``cuobjdump
  -sass``; a template parameter added with its default, ``<16>`` against
  ``<16, false>``, names the same kernel, as does a kernel made a template
  against its ``<false>`` instantiation, and kernel-parameter offsets
  ``c[0x0][...]`` are masked, so an added parameter alone does not count as
  a change); every kernel of the other tree must keep them.
- ``merton-heston`` (the default): the Merton (#8) and Heston (#10)
  candidate kernels up to 16 assets, their outputs against the other
  tree's with ``torch.equal`` at A = 1, 7, 15 and 16, W = 1, each side of
  every layout switch (10/11, 12/13, 128/129) and 256, unhedged and hedged (two legs per
  asset of every type), at two jump rates or vols of vol, 52 steps on two
  blocks of 1,029 paths: this tree in the layout its W picks and in every
  layout by name (solo, split and, for Heston, tile). Then both trees timed
  in turns at the bench universe, W = 256 at 256 x 131,072 x 252 and W = 1
  at 131,072 x 252, unhedged and hedged (the bench hedge), each turn the best
  of three timings of two launches, each tree its best turn, the timed
  outputs held equal; and this tree's layouts by name at W = 1 to 256.
- ``garch-bootstrap``: the GARCH (#5) and bootstrap (#7) candidate kernels
  up to 16 assets, the same checks as ``merton-heston`` (at the bench's
  GARCH parameters; the bootstrap over a 365-row history in shared memory
  and an 8,192-row one in device memory), both trees timed in turns at W =
  256 and W = 1, and at their main paths: ``run_garch_path_risk`` and
  ``run_bootstrap_path_risk`` at config-4 (16,777,216 x 252, the bench
  weights), plain and hedged (the bench hedge), and both family frontiers
  (4,096 x 131,072 x 252); then this tree's layouts by name at W = 1 to
  256, and the registers and spills ptxas reports for the kernels of both
  libraries. The other tree's ``garch_dd_kernel<16, *>`` listings are kept
  under ``chiprun_out/`` (which multiply-adds nvcc contracts).
- ``dcc``: the DCC kernels past 16 assets (``dcc_group_kernel``) and the
  narrow DCC candidate kernel (``dcc_dd_kernel``): their outputs against the
  other tree's with ``torch.equal`` (A = 17, 33, 64, 65, 200, 256 and 1, 7,
  15, 16; the terminal, W = 1/5/64/256, hedged), then timed at the widths
  and shapes of the DCC rows of PERF.md §6.

- ``gbm``: the GBM candidate kernel (#3) and the path-stats kernel (#2) up
  to 16 assets: #3's outputs against the other tree's with ``torch.equal``
  at A = 1, 7, 15 and 16, W = 1, each side of every layout switch and 256,
  buy-and-hold, rebalanced and hedged (two legs per asset of every type),
  the three score tiers and the three draw tiers, 0, 1, 5, 52 and 252
  steps, a factor with terms above its diagonal, in the layout W picks and
  in every layout by name; #2's (terminal, port, dd) likewise in both modes
  and every draw tier. Then both trees timed in turns: #3 at 256 x 131,072 x
  252 (each mode and tier) and at W = 1 (131,072 x 252), #2 at 1,048,576 x
  252, config-4 ``run_path_risk`` (buy-and-hold, rebalanced, hedged GBM and
  hedged Student-t) and the GBM frontier (auto and the bf16 screen); this
  tree's layouts by name at W = 1 to 256 per mode and tier, and ptxas's
  registers and spills.

- ``terminal``: the Heston (#9) and GARCH (#4) terminal kernels up to 16
  assets: their outputs against the other tree's with ``torch.equal`` at A
  = 1, 2, 7, 15, 16 and 0, 1, 5, 7, 9, 52, 252 steps over two blocks of
  1,029 paths (Heston at both vols of vol, and this tree's 17-64-asset tile
  at the same width; GARCH in the normal and the t(5.5) tier). Then both
  trees timed in turns at 1,048,576 x 252 x 15, the timed outputs held
  equal, with the walls of ``heston_terminal_returns`` and ``garch_risk``
  (normal and t(5.5)); both trees again at A = 1, 7, 15, 16 beside this
  tree's tile; each terminal kernel's instructions per asset-step in its
  Philox-call loop (both trees) and per draw (kernel #1's tiers and a
  strict-draw probe, ``chip_smoke.draw_counts``); ptxas's registers
  and spills of both libraries.

Needs one card; builds both trees' libraries. Exits 1 when a kept kernel
changed its SASS or an output differs from the other tree's."""
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as S

PART = sys.argv[2] if len(sys.argv) > 2 else "merton-heston"
FAMILIES = ("jump", "heston", "garch", "bootstrap", "dcc", "multi_dd", "path_stats")
dev = torch.device("cuda", 0)
print(S.phase_card())


def load(root):
    for m in [m for m in sys.modules if m == "mcport_torch" or m.startswith("mcport_torch.")]:
        del sys.modules[m]
    sys.path.insert(0, root)
    import mcport_torch._build as B
    B.build_libraries(tuple(B.KERNELS))
    import mcport_torch.ops.bootstrap as O
    import mcport_torch.ops.dcc as D
    import mcport_torch.ops.garch as G
    import mcport_torch.ops.heston as H
    import mcport_torch.ops.jump as J
    import mcport_torch.engine.drawdown_frontier  # noqa: F401  (each tree its own engines)
    import mcport_torch.engine.path_risk  # noqa: F401
    import mcport_torch.models.garch_mc  # noqa: F401
    import mcport_torch.models.heston  # noqa: F401
    import mcport_torch.ops.multi_dd  # noqa: F401
    import mcport_torch.ops.path_stats  # noqa: F401
    sys.path.remove(root)
    mods = {m: v for m, v in sys.modules.items()
            if m == "mcport_torch" or m.startswith("mcport_torch.")}
    return G, O, H, D, mods, J


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


#: the other tree's kernels that this tree no longer has: Heston's and GARCH's
#: candidate kernels up to 16 assets, now the layouts of csrc/narrow_dd.cuh,
#: and the path-stats kernel's 16-asset build (path_stats_kernel<…, 16, 16>),
#: now path_stats_narrow_kernel; and the terminal kernels #9 and #4 up to 16
#: assets, redesigned under their names
REDESIGNED = ("heston_dd_kernelILi16E", "garch_dd_kernelILi16E", "ELi16ELi16E",
              "22heston_terminal_kernelE", "21garch_terminal_kernelILi")
mods = {"other": load(sys.argv[1]), "this": load(".")}
kept = [0, 0]
for fam in FAMILIES:
    libs = {}
    for side, root in (("other", sys.argv[1]), ("this", ".")):
        libs[side] = sorted((Path(root) / "mcport_torch" / "build").glob(f"lib{fam}_*.so"),
                            key=lambda p: p.stat().st_mtime)[-1]
    a, b = sass(libs["other"]), sass(libs["this"])
    if fam == "garch":   # the former candidate kernel's listings: which adds nvcc fuses
        Path("chiprun_out").mkdir(exist_ok=True)
        for key, ins in a.items():
            if "garch_dd_kernelILi16E" in key or "garch_terminal_kernelILi" in key:
                Path(f"chiprun_out/sass_other_{key[-40:]}.txt").write_text("\n".join(ins))
    for key, ins in sorted(a.items()):
        same = b.get(key) == ins
        redesigned = any(r in key for r in REDESIGNED)
        kept[0] += int(same and not redesigned)
        kept[1] += int(not redesigned)
        if key in b and not same:   # both listings, for a diff
            for side, listing in (("other", ins), ("this", b[key])):
                Path("chiprun_out").mkdir(exist_ok=True)
                Path(f"chiprun_out/sass_{fam}_{key[-40:]}_{side}.txt").write_text(
                    "\n".join(listing))
        flops = ""
        if key in b and not same:   # the floating-point operations, in order
            fp = [[re.search(r"\b(FFMA|FMUL|FADD|FMNMX|MUFU\.\w+)\b", i) for i in x]
                  for x in (ins, b[key])]
            fp = [[m.group(1) for m in x if m] for x in fp]
            flops = (f" (the same {len(fp[0])} floating-point operations in the same order)"
                     if fp[0] == fp[1] else f" ({len(fp[0])} -> {len(fp[1])} floating-point "
                                            f"operations, not in the same order)")
        print(f"sass {fam} {key}: {len(ins)} instructions, "
              f"{'the same in this tree' if same else 'CHANGED' if key in b else 'not found'}"
              f"{flops}{' (redesigned)' if redesigned else ''}")
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


unequal = []


def dcc_part():
    """The DCC kernels' outputs against the other tree's, then their times."""
    # ---- the DCC kernels past 16 assets: outputs bit for bit -------------------------
    DCC_A = (17, 33, 64, 65, 200, 256)
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
        G, O, H, D, side, _ = mods[order]
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
        for fam in runs:
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
    return (f"least DCC speedup at A = 64 and 256 {worst_64_256:.2f}x; most slower "
            f"{100 * worst_slower:.2f}%")


# ---- kernels #8 and #10 up to 16 assets ---------------------------------------------

#: W = 1, each side of every layout switch (ops/jump.py merton_narrow_plan: 10/11;
#: ops/heston.py heston_narrow_plan: 12/13, 128/129), and the frontier's W
NARROW_W = (1, 10, 11, 12, 13, 128, 129, 256)
#: this tree's layouts by name (ops/narrow.py LAYOUTS; the jump kernel has no tile)
LAYOUTS = ("solo", "split", "tile")
SWEEP_W = (1, 2, 4, 5, 6, 7, 8, 10, 12, 13, 14, 15, 16, 17, 18, 20, 22, 23, 24, 32, 64, 128, 192, 256)


def on(side):
    """side's modules (G, O, H, D, modules, J), its package in sys.modules."""
    sys.modules.update(mods[side][4])
    return mods[side]


def held_equal(label, want, got) -> None:
    same = all(torch.equal(p, q) for p, q in zip(want, got))
    if not same:
        unequal.append(label)
    print(f"equal {label}: {'bit for bit' if same else 'DIFFERENT'}")


def taken(plan, a, n, hedge):
    """The layouts by name that a block's shared memory holds at A = a, W = n
    and the hedge's legs (the solo layout's candidates' state grows with W)."""
    out = []
    for layout in LAYOUTS:
        try:
            plan(a, n, 52, 1_029, 2, hedge.n_legs if hedge is not None else 0, layout=layout)
        except ValueError as e:
            print(f"layout {layout} not taken: {e}")
        else:
            out.append(layout)
    return out


def merton(a):
    mean, chol, muj, sigj = S._merton_tensors(S.bench_merton(a), dev)
    return mean, chol, muj, sigj, torch.cat([chol.reshape(-1), mean, muj, sigj]).contiguous()


def merton_heston_part():
    """#8 and #10: outputs against the other tree's in every layout, then
    the times."""
    kw = dict(first_block=6, n_blocks=2)
    for a in (1, 7, 15, 16):
        mean, chol, muj, sigj, params = merton(a)
        legs = S.leg_mix(a, 2, dev, seed=a)
        for n in NARROW_W:
            w = simplex(a, n)
            for hedge in (None, legs):
                tag = f"A={a} W={n}" + (" hedged L=2" if hedge is not None else "")
                for rate in (0.02, 0.3):
                    J = on("other")[5]
                    want = bits(J.merton_multi_portfolio_dd(11, mean, chol, rate, muj, sigj, w,
                                                            1_029, 52, hedge=hedge, **kw))
                    J = on("this")[5]
                    got = J.merton_multi_portfolio_dd(11, mean, chol, rate, muj, sigj, w, 1_029,
                                                      52, hedge=hedge, **kw)
                    held_equal(f"jump {tag} rate={rate} by W", want, bits(got))
                    for layout in taken(J.merton_narrow_plan, a, n, hedge):
                        got = J._launch(11, params, w, a, 1_029, 52, 6, 2, rate, hedge, layout)
                        torch.cuda.synchronize()
                        held_equal(f"jump {tag} rate={rate} {layout}", want, bits(got))
                for xi in (3e-3, S.FELLER_XI):
                    h = S.bench_heston(a, xi).tensors(dev)
                    H = on("other")[2]
                    want = bits(H.heston_multi_portfolio_dd(11, h, w, 1_029, 52, hedge=hedge,
                                                            **kw))
                    H = on("this")[2]
                    got = H.heston_multi_portfolio_dd(11, h, w, 1_029, 52, hedge=hedge, **kw)
                    held_equal(f"heston {tag} xi={xi} by W", want, bits(got))
                    for layout in taken(H.heston_narrow_plan, a, n, hedge):
                        got = H._launch_dd(11, h, w, 1_029, 52, 6, 2, hedge=hedge, layout=layout)
                        torch.cuda.synchronize()
                        held_equal(f"heston {tag} xi={xi} {layout}", want, bits(got))

    from mcport_torch.ops.hedged import HedgeTensors

    pp = 131_072
    cand = simplex(15, 256, seed=-15)
    w_one = torch.as_tensor(S.bench_weights()[None], dtype=torch.float32, device=dev)
    mean, chol, muj, sigj, params = merton(15)
    hp = S.bench_heston().tensors(dev)
    spots = np.full(15, S.SPOT)
    h15 = HedgeTensors.from_spec(S.bench_hedge(spots)[1], spots, dev)

    def call(fam, mod, w, hedged, layout=None):
        hedge = h15 if hedged else None
        if fam == "jump":
            if layout is None:
                return lambda: mod.merton_multi_portfolio_dd(0, mean, chol, 0.02, muj, sigj, w,
                                                             pp, 252, hedge=hedge)
            return lambda: mod._launch(0, params, w, 15, pp, 252, -1, 1, 0.02, hedge, layout)
        if layout is None:
            return lambda: mod.heston_multi_portfolio_dd(0, hp, w, pp, 252, hedge=hedge)
        return lambda: mod._launch_dd(0, hp, w, pp, 252, -1, 1, hedge=hedge, layout=layout)

    def best(fn):
        # the best of three timings of two launches: a turn's first launches
        # can wait on the host (allocations, a shared CPU)
        return min(S._time_ms(fn, 2) for _ in range(3))

    timed = (("W=256", cand, False), ("W=256 hedged", cand, True), ("W=1", w_one, False),
             ("W=1 hedged", w_one, True))
    res, firsts = {}, {}
    for order in ("other", "this", "this", "other"):
        side = on(order)
        for fam, mod in (("jump", side[5]), ("heston", side[2])):
            for label, w, hedged in timed:
                fn = call(fam, mod, w, hedged)
                out = fn()
                torch.cuda.synchronize()
                firsts.setdefault((fam, label, order), bits(out))
                res.setdefault((f"{fam} {label}", order), []).append(best(fn))
    for (name, order), t in sorted(res.items()):
        print(f"ab {name} {order}: " + " / ".join(f"{x:.3f}" for x in t) + " ms")
    worst = 0.0
    for fam in ("jump", "heston"):
        for label, w, hedged in timed:
            name = f"{fam} {label}"
            other, this = min(res[(name, "other")]), min(res[(name, "this")])
            held_equal(f"{name} timed outputs", firsts[(fam, label, "other")],
                       firsts[(fam, label, "this")])
            worst = max(worst, this / other - 1.0)
            shape = f"{w.shape[0]} x {pp} x 252" if w.shape[0] > 1 else f"{pp} x 252"
            print(f"speedup {name} A=15 {shape}: {other:.3f} -> {this:.3f} ms, "
                  f"{other / this:.2f}x")
    # this tree's layouts by name, W = 1 to 256 at 131,072 x 252
    side = on("this")
    for n in SWEEP_W:
        w = cand[:n] if n > 1 else w_one
        for fam, mod in (("jump", side[5]), ("heston", side[2])):
            for hedged in (False, True):
                times = []
                plan = mod.merton_narrow_plan if fam == "jump" else mod.heston_narrow_plan
                for layout in taken(plan, 15, n, h15 if hedged else None):
                    fn = call(fam, mod, w, hedged, layout)
                    fn()
                    torch.cuda.synchronize()
                    times.append(f"{layout} {best(fn):.3f}")
                print(f"layouts {fam} W={n}{' hedged' if hedged else ''} A=15 {pp} x 252: "
                      + ", ".join(times) + " ms")
    return f"#8/#10 most slower than the other tree {100 * worst:.2f}%"


# ---- kernels #5 and #7 up to 16 assets ----------------------------------------------


def ptxas_report(libs=("garch", "bootstrap")) -> None:
    """Registers, stack frames and spills of every kernel of both trees'
    libraries, from the ``-Xptxas -v`` report kept beside each library."""
    for side, root in (("other", sys.argv[1]), ("this", ".")):
        for fam in libs:
            logs = sorted((Path(root) / "mcport_torch" / "build").glob(f"lib{fam}_*.log"),
                          key=lambda p: p.stat().st_mtime)
            if not logs:   # a library the tree does not have
                continue
            log = logs[-1].read_text()
            name, spill = None, ""
            for line in log.splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    name = re.sub(r"_GLOBAL__N__\w+?_[0-9a-f]{8}", "", m.group(1))
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                              r"(\d+) bytes spill loads", line)
                if m and name:
                    spill = f"frame {m.group(1)}, spills {m.group(2)}/{m.group(3)}"
                m = re.search(r"Used (\d+) registers", line)
                if m and name:
                    print(f"ptxas {side} {fam} {name}: {m.group(1)} registers, {spill}")
                    name = None


def garch_bootstrap_part():
    """#5 and #7: outputs against the other tree's in every layout, then the
    times: the kernels, their main paths, this tree's layouts by name."""
    from mcport_torch.ops.hedged import HedgeTensors

    kw = dict(first_block=6, n_blocks=2)
    this_g, this_o = on("this")[0], on("this")[1]
    switches = {"garch": S.layout_switches(this_g.garch_narrow_plan),
                "bootstrap": S.layout_switches(this_o.bootstrap_narrow_plan)}
    print(f"layout switches (W each side, and 1 and 256): {switches}")
    long_hist = np.random.default_rng(8).normal(1e-3, 0.02, (S.LONG_HISTORY, 16)).astype(
        np.float32)
    for a in (1, 7, 15, 16):
        g = S.bench_garch(a).tensors(dev)
        hists = {"365 rows": torch.as_tensor(S.bench_history(a), device=dev),
                 f"{S.LONG_HISTORY} rows": torch.as_tensor(long_hist[:, :a].copy(), device=dev)}
        legs = S.leg_mix(a, 2, dev, seed=a)
        for n in sorted(set(switches["garch"]) | set(switches["bootstrap"])):
            w = simplex(a, n)
            for hedge in (None, legs):
                tag = f"A={a} W={n}" + (" hedged L=2" if hedge is not None else "")
                G = on("other")[0]
                want = bits(G.garch_multi_portfolio_dd(11, g, w, 1_029, 52, hedge=hedge, **kw))
                G = on("this")[0]
                got = G.garch_multi_portfolio_dd(11, g, w, 1_029, 52, hedge=hedge, **kw)
                held_equal(f"garch {tag} by W", want, bits(got))
                for layout in taken(G.garch_narrow_plan, a, n, hedge):
                    got = G._launch_dd(11, g, w, 1_029, 52, 6, 2, hedge=hedge, layout=layout)
                    torch.cuda.synchronize()
                    held_equal(f"garch {tag} {layout}", want, bits(got))
                for hname, hist in hists.items():
                    O = on("other")[1]
                    want = bits(O.bootstrap_multi_portfolio_dd(11, hist, w, 1_029, 52,
                                                               hedge=hedge, **kw))
                    O = on("this")[1]
                    got = O.bootstrap_multi_portfolio_dd(11, hist, w, 1_029, 52, hedge=hedge, **kw)
                    held_equal(f"bootstrap {tag} {hname} by W", want, bits(got))
                    plan = (lambda *x, t=hist.shape[0], **k: O.bootstrap_narrow_plan(
                        x[0], x[1], t, *x[2:], **k))
                    for layout in taken(plan, a, n, hedge):
                        got = O._launch_dd(11, hist, w, 1_029, 52, 0.2, 6, 2, hedge=hedge,
                                           layout=layout)
                        torch.cuda.synchronize()
                        held_equal(f"bootstrap {tag} {hname} {layout}", want, bits(got))

    pp = 131_072
    cand = simplex(15, 256, seed=-15)
    w_one = torch.as_tensor(S.bench_weights()[None], dtype=torch.float32, device=dev)
    g15 = S.bench_garch().tensors(dev)
    hist15 = torch.as_tensor(S.bench_history(), device=dev)
    spots = np.full(15, S.SPOT)
    h15 = HedgeTensors.from_spec(S.bench_hedge(spots)[1], spots, dev)

    def call(fam, mod, w, hedged, layout=None):
        hedge = h15 if hedged else None
        if fam == "garch":
            if layout is None:
                return lambda: mod.garch_multi_portfolio_dd(0, g15, w, pp, 252, hedge=hedge)
            return lambda: mod._launch_dd(0, g15, w, pp, 252, -1, 1, hedge=hedge, layout=layout)
        if layout is None:
            return lambda: mod.bootstrap_multi_portfolio_dd(0, hist15, w, pp, 252, hedge=hedge)
        return lambda: mod._launch_dd(0, hist15, w, pp, 252, 0.2, -1, 1, hedge=hedge,
                                      layout=layout)

    def best(fn):
        return min(S._time_ms(fn, 2) for _ in range(3))

    def wall(fn):
        torch.cuda.synchronize()
        t0 = S.time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (S.time.perf_counter() - t0)

    timed = (("W=256", cand, False), ("W=256 hedged", cand, True), ("W=1", w_one, False),
             ("W=1 hedged", w_one, True))
    config4 = S.cells()["config4"]
    weights = S.bench_weights()
    _, spec = S.bench_hedge(spots)
    garch_p, hist_np = S.bench_garch(), S.bench_history()
    res, firsts = {}, {}
    for order in ("other", "this", "this", "other"):
        side = on(order)
        for fam, mod in (("garch", side[0]), ("bootstrap", side[1])):
            for label, w, hedged in timed:
                fn = call(fam, mod, w, hedged)
                out = fn()
                torch.cuda.synchronize()
                firsts.setdefault((fam, label, order), bits(out))
                res.setdefault((f"{fam} {label}", order), []).append(best(fn))
        pr = side[4]["mcport_torch.engine.path_risk"]
        fr = side[4]["mcport_torch.engine.drawdown_frontier"]
        for fam, run, src in (("garch", pr.run_garch_path_risk, garch_p),
                              ("bootstrap", pr.run_bootstrap_path_risk, hist_np)):
            for hedged in (False, True):
                extra = dict(hedge=spec, s0=spots) if hedged else {}
                name = f"config-4 run_{fam}_path_risk" + (" hedged" if hedged else "")
                rep, ms = wall(lambda: run(src, weights, config4, device=dev, **extra))
                firsts.setdefault((name, order), (rep.var, rep.cvar, rep.dd_p95))
                res.setdefault((name, order), []).append(ms)
            budget = {"garch": 0.6527, "bootstrap": 0.1177}[fam]
            kwf = dict(S.FRONTIER, dd_budget=budget)
            name = f"{fam} frontier 4,096 x 131,072 x 252"
            r, ms = wall(lambda: fr.family_drawdown_frontier_search(S.FRONTIER_SEED, fam, src,
                                                                    device=dev, **kwf))
            firsts.setdefault((name, order), (int(r.opt_idx), float(r.ret[r.opt_idx])))
            res.setdefault((name, order), []).append(ms)
    for (name, order), t in sorted(res.items()):
        print(f"ab {name} {order}: " + " / ".join(f"{x:.3f}" for x in t) + " ms")
    worst = 0.0
    for fam in ("garch", "bootstrap"):
        for label, w, hedged in timed:
            name = f"{fam} {label}"
            other, this = min(res[(name, "other")]), min(res[(name, "this")])
            held_equal(f"{name} timed outputs", firsts[(fam, label, "other")],
                       firsts[(fam, label, "this")])
            worst = max(worst, this / other - 1.0)
            shape = f"{w.shape[0]} x {pp} x 252" if w.shape[0] > 1 else f"{pp} x 252"
            print(f"speedup {name} A=15 {shape}: {other:.3f} -> {this:.3f} ms, "
                  f"{other / this:.2f}x")
    for name in sorted({k[0] for k in res if k[0].startswith(("config-4", "garch frontier",
                                                              "bootstrap frontier"))}):
        other, this = min(res[(name, "other")]), min(res[(name, "this")])
        same = firsts[(name, "other")] == firsts[(name, "this")]
        if not same:
            unequal.append(name)
        print(f"speedup {name}: {other:.1f} -> {this:.1f} ms (best of 2 walls each), "
              f"{other / this:.2f}x, results {'equal' if same else 'DIFFERENT'} "
              f"({firsts[(name, 'this')]})")
    # this tree's layouts by name, W = 1 to 256 at 131,072 x 252
    side = on("this")
    for n in SWEEP_W:
        w = cand[:n] if n > 1 else w_one
        for fam, mod in (("garch", side[0]), ("bootstrap", side[1])):
            plan = mod.garch_narrow_plan if fam == "garch" else (
                lambda *x, m=mod, **k: m.bootstrap_narrow_plan(x[0], x[1], 365, *x[2:], **k))
            for hedged in (False, True):
                times = []
                for layout in taken(plan, 15, n, h15 if hedged else None):
                    fn = call(fam, mod, w, hedged, layout)
                    fn()
                    torch.cuda.synchronize()
                    times.append(f"{layout} {best(fn):.3f}")
                print(f"layouts {fam} W={n}{' hedged' if hedged else ''} A=15 {pp} x 252: "
                      + ", ".join(times) + " ms")
    ptxas_report()
    return f"#5/#7 most slower than the other tree {100 * worst:.2f}%"


# ---- kernels #3 and #2 up to 16 assets ---------------------------------------------

#: the draw tiers: (bm, t_df)
DRAWS = (("poly", None), ("poly_fast", None), ("t", 5.5))
GBM_SWEEP_W = (1, 2, 4, 8, *range(12, 29), 32, 64, 128, 192, 256)
SCORES = ("float32", "tensorfloat32", "bfloat16")
MODES = ("buy-hold", "rebalanced", "hedged")


def gbm_part():
    """#3 and #2: outputs against the other tree's in every layout, then the
    times: the kernels, their main paths, this tree's layouts by name."""
    from mcport_torch.ops.hedged import HedgeTensors

    this = on("this")[4]
    M, P = this["mcport_torch.ops.multi_dd"], this["mcport_torch.ops.path_stats"]
    plans = {mode: (lambda *x, mode=mode, **k: M.gbm_narrow_plan(
        *x, rebalance=mode == "rebalanced", **k)) for mode in MODES}
    switches = sorted({n for mode in MODES for n in S.layout_switches(plans[mode])})
    print(f"layout switches (W each side, and 1 and 256): {switches}")
    kw = dict(first_block=6, n_blocks=2)

    def mods(side):
        s = on(side)[4]
        return s["mcport_torch.ops.multi_dd"], s["mcport_torch.ops.path_stats"]

    def factor(a, full):
        mean_np, chol_np = S.bench_universe(a)
        chol = chol_np.astype(np.float64)
        if full and a > 1:   # terms above the diagonal: a rotation of the first two columns
            c0, c1 = chol[:, 0].copy(), chol[:, 1].copy()
            chol[:, 0], chol[:, 1] = 0.8 * c0 - 0.6 * c1, 0.6 * c0 + 0.8 * c1
        return (torch.as_tensor(mean_np, dtype=torch.float32, device=dev),
                torch.as_tensor(chol, dtype=torch.float32, device=dev))

    def cand_case(tag, a, n, mode, sd, draw, steps, full=False, by_name=True, paths=1_029):
        mean, chol = factor(a, full)
        w = simplex(a, n)
        bm, t_df = ("poly", draw[1]) if draw[0] == "t" else draw
        hedge = S.leg_mix(a, 2, dev, seed=a) if mode == "hedged" else None
        args = dict(rebalance=mode == "rebalanced", score_dtype=sd, bm=bm, t_df=t_df,
                    hedge=hedge, **kw)
        want = bits(mods("other")[0].gbm_multi_portfolio_dd(11, mean, chol, w, paths, steps,
                                                           **args))
        Mt = mods("this")[0]
        got = Mt.gbm_multi_portfolio_dd(11, mean, chol, w, paths, steps, **args)
        held_equal(f"gbm {tag} by W", want, bits(got))
        if not by_name:
            return
        lk = Mt.t_scaled_chol(chol, t_df)
        for layout in ("solo", "split"):
            try:
                Mt.gbm_narrow_plan(a, n, steps, paths, 2, 0 if hedge is None else hedge.n_legs,
                                   layout=layout, rebalance=mode == "rebalanced",
                                   score_dtype=sd)
            except ValueError:
                continue
            got = Mt._launch(11, mean, lk, w, paths, steps, 6, 2, mode == "rebalanced", sd,
                             bm, t_df, hedge, layout)
            torch.cuda.synchronize()
            held_equal(f"gbm {tag} {layout}", want, bits(got))

    for a in (1, 7, 15, 16):
        for n in switches:
            for mode in MODES:
                for sd in SCORES:
                    cand_case(f"A={a} W={n} {mode} {sd} 52 steps", a, n, mode, sd, DRAWS[0], 52)
        for draw in DRAWS[1:]:
            for n in (1, 256):
                for mode in MODES:
                    for sd in SCORES:
                        cand_case(f"A={a} W={n} {mode} {sd} {draw[0]} 52 steps", a, n, mode, sd,
                                  draw, 52)
    for a in (7, 15):
        for steps in (0, 1, 5, 252):
            for n in (1, 11, 256):
                for mode in MODES:
                    for sd in SCORES:
                        cand_case(f"A={a} W={n} {mode} {sd} {steps} steps", a, n, mode, sd,
                                  DRAWS[0], steps, by_name=steps == 5)
        for n in (1, 13, 256):
            for mode in MODES:
                cand_case(f"A={a} W={n} {mode} float32 full factor", a, n, mode, "float32",
                          DRAWS[0], 52, full=True)
    # #2: (terminal, port, dd), and without the terminal
    for a in (1, 7, 15, 16):
        for draw in DRAWS:
            bm, t_df = ("poly", draw[1]) if draw[0] == "t" else draw
            for reb in (False, True):
                for steps in (0, 1, 5, 52, 252):
                    for full in ((False, True) if steps == 52 else (False,)):
                        mean, chol = factor(a, full)
                        w = simplex(a, 1)[0]
                        for terminal in (True, False):
                            args = dict(rebalance=reb, bm=bm, t_df=t_df, terminal=terminal, **kw)
                            want = mods("other")[1].gbm_path_stats(11, mean, chol, w, 2_053,
                                                                   steps, **args)
                            got = mods("this")[1].gbm_path_stats(11, mean, chol, w, 2_053, steps,
                                                                 **args)
                            held_equal(f"path_stats A={a} {draw[0]} rebalance={int(reb)} "
                                       f"{steps} steps full={int(full)} terminal={int(terminal)}",
                                       bits(tuple(x for x in want if x is not None)),
                                       bits(tuple(x for x in got if x is not None)))

    # ---- the times, in turns ---------------------------------------------------------
    pp, p2 = 131_072, 1 << 20
    mean, chol = factor(15, False)
    cand = simplex(15, 256, seed=-15)
    w_one = torch.as_tensor(S.bench_weights()[None], dtype=torch.float32, device=dev)
    spots = np.full(15, S.SPOT)
    h15 = HedgeTensors.from_spec(S.bench_hedge(spots)[1], spots, dev)
    timed = [(f"W=256 {mode} {sd}", cand, mode, sd) for mode in MODES for sd in SCORES]
    timed += [(f"W=1 {mode}", w_one, mode, "float32") for mode in MODES]

    def call3(mod, w, mode, sd, t_df=None, layout=None):
        hedge = h15 if mode == "hedged" else None
        if layout is None:
            return lambda: mod.gbm_multi_portfolio_dd(0, mean, chol, w, pp, 252,
                                                      rebalance=mode == "rebalanced",
                                                      score_dtype=sd, t_df=t_df, hedge=hedge)
        lk = mod.t_scaled_chol(chol, t_df)
        return lambda: mod._launch(0, mean, lk, w, pp, 252, -1, 1, mode == "rebalanced", sd,
                                   "poly", t_df, hedge, layout)

    def best(fn):
        return min(S._time_ms(fn, 2) for _ in range(3))

    def wall(fn):
        torch.cuda.synchronize()
        t0 = S.time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (S.time.perf_counter() - t0)

    from mcport_torch.convert import gbm_params_from_numpy

    mean_np, chol_np = S.bench_universe()
    params = gbm_params_from_numpy(spots, mean_np, chol_np)
    config4 = S.cells()["config4"]
    weights = S.bench_weights()
    _, spec = S.bench_hedge(spots)
    res, firsts = {}, {}

    def turn(name, order, fn, key=bits):
        out = fn()
        torch.cuda.synchronize()
        firsts.setdefault((name, order), key(out))
        res.setdefault((name, order), []).append(best(fn))

    def same_values(x, y):
        return len(x) == len(y) and all(a == b or (a != a and b != b) for a, b in zip(x, y))

    for order in ("other", "this", "this", "other"):
        M_, P_ = mods(order)
        side = on(order)[4]
        for label, w, mode, sd in timed:
            turn(f"gbm {label}", order, call3(M_, w, mode, sd))
        turn("gbm W=1 hedged t", order, call3(M_, w_one, "hedged", "float32", t_df=5.5))
        w15 = torch.as_tensor(weights, dtype=torch.float32, device=dev)
        for label, reb, t_df in (("buy-hold", False, None), ("rebalanced", True, None),
                                 ("buy-hold t", False, 5.5)):
            turn(f"path_stats {label} 1,048,576 x 252", order,
                 lambda P_=P_, reb=reb, t_df=t_df: P_.gbm_path_stats(
                     0, mean, chol, w15, p2, 252, rebalance=reb, t_df=t_df, terminal=False),
                 key=lambda out: bits(out[1:]))
        pr = side["mcport_torch.engine.path_risk"]
        fr = side["mcport_torch.engine.drawdown_frontier"]
        for label, reb, t_df, hedged in (("buy-hold", False, None, False),
                                         ("rebalanced", True, None, False),
                                         ("hedged gbm", False, None, True),
                                         ("hedged student_t", False, 5.5, True)):
            cfg = S.path_config(config4, t_df)
            name = f"config-4 run_path_risk {label}"
            rep, ms = wall(lambda: pr.run_path_risk(params, weights, cfg, rebalance=reb,
                                                    hedge=spec if hedged else None, device=dev))
            firsts.setdefault((name, order), (rep.var, rep.cvar, rep.dd_p95, rep.dd_mean))
            res.setdefault((name, order), []).append(ms)
        for sd in ("auto", "bfloat16"):
            name = f"gbm frontier {sd} 4,096 x 131,072 x 252"
            r, ms = wall(lambda: fr.drawdown_frontier_search(S.FRONTIER_SEED, params,
                                                             score_dtype=sd, device=dev,
                                                             **S.FRONTIER))
            firsts.setdefault((name, order), (int(r.opt_idx), float(r.ret[r.opt_idx])))
            res.setdefault((name, order), []).append(ms)
    for (name, order), t in sorted(res.items()):
        print(f"ab {name} {order}: " + " / ".join(f"{x:.3f}" for x in t) + " ms")
    worst = 0.0
    for name in sorted({k[0] for k in res}):
        other, this_ = min(res[(name, "other")]), min(res[(name, "this")])
        x, y = firsts[(name, "other")], firsts[(name, "this")]
        walls = name.startswith(("config-4", "gbm frontier"))
        same = same_values(x, y) if walls else all(torch.equal(p, q) for p, q in zip(x, y))
        if not same:
            unequal.append(f"{name} timed")
        if not walls:
            worst = max(worst, this_ / other - 1.0)
        print(f"speedup {name}: {other:.3f} -> {this_:.3f} ms, {other / this_:.2f}x, "
              f"{'best of 2 walls, results' if walls else 'outputs'} "
              f"{'bit for bit' if same else 'DIFFERENT'}")
    # this tree's layouts by name, W = 1 to 256 at 131,072 x 252: float32 at
    # every W near the solo layout's switches, the other tiers at a few
    Mt, _ = mods("this")
    for n in GBM_SWEEP_W:
        w = cand[:n] if n > 1 else w_one
        for mode in MODES:
            for sd in SCORES:
                if sd != "float32" and n not in (1, 8, 32, 128, 256):
                    continue
                times = []
                for layout in ("solo", "split"):
                    try:
                        Mt.gbm_narrow_plan(15, n, 252, pp, 1, h15.n_legs if mode == "hedged"
                                           else 0, layout=layout,
                                           rebalance=mode == "rebalanced", score_dtype=sd)
                    except ValueError:
                        continue
                    fn = call3(Mt, w, mode, sd, layout=layout)
                    fn()
                    torch.cuda.synchronize()
                    times.append(f"{layout} {best(fn):.3f}")
                print(f"layouts gbm W={n} {mode} {sd} A=15 {pp} x 252: " + ", ".join(times)
                      + " ms")
    ptxas_report(("gbm_narrow", "multi_dd", "path_stats"))
    return f"#3/#2 most slower than the other tree {100 * worst:.2f}%"


# ---- the terminal kernels #9 and #4 up to 16 assets ---------------------------------

TERMINAL_A = (1, 2, 7, 15, 16)
TERMINAL_STEPS = (0, 1, 5, 7, 9, 52, 252)


def terminal_sass_counts() -> None:
    """Instructions per asset-step of each terminal kernel's Philox-call
    loop (``S._hot_loop`` over ``cuobjdump -sass``: an iteration holds 16
    assets' Philox calls, two per asset for Heston; four steps, two in
    GARCH's t tier), both trees, and the draws' own loops: kernel #1's
    normal and t tiers and a strict (kPolyStrict) draw probe."""
    from torch.utils.cpp_extension import CUDA_HOME

    for side, root in (("other", sys.argv[1]), ("this", ".")):
        for fam, calls in (("heston", 32), ("garch", 16)):
            so = sorted((Path(root) / "mcport_torch" / "build").glob(f"lib{fam}_*.so"),
                        key=lambda x: x.stat().st_mtime)[-1]
            text = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass",
                                   str(so)], capture_output=True, text=True, check=True).stdout
            for name in sorted(set(re.findall(r"Function : (\S*terminal_kernel\S*)", text))):
                steps = 2 if fam == "garch" and "ILi2E" in name else 4
                ins, its, _ = S._hot_loop(S._sass_loops(so, name), S.PHILOX_MULS, calls * 20)
                print(f"sass loop {side} {name}: {ins} instructions / {its} call(s) of 16 "
                      f"assets, {ins / its / (16 * steps):.2f} per asset-step")
    print("instructions per draw: " + ", ".join(f"{k} {v:.2f}"
                                                 for k, v in S.draw_counts().items()))


def terminal_part():
    """#9 and #4: outputs against the other tree's at every width, step count
    and tier (Heston also this tree's 17-64-asset tile), then both trees
    timed in turns and their main paths' walls, then both trees' kernels and
    this tree's tile at A = 1, 7, 15, 16; the SASS counts and ptxas's
    registers and spills."""
    kw = dict(first_block=6, n_blocks=2)
    n_eq = 0
    for a in TERMINAL_A:
        hs = {xi: S.bench_heston(a, xi).tensors(dev) for xi in (3e-3, S.FELLER_XI)}
        g = S.bench_garch(a).tensors(dev)
        for steps in TERMINAL_STEPS:
            for xi, h in hs.items():
                want = bits(on("other")[2].heston_terminal(11, h, 1_029, steps, **kw))
                H = on("this")[2]
                held_equal(f"heston_terminal A={a} steps={steps} xi={xi}", want,
                           bits(H.heston_terminal(11, h, 1_029, steps, **kw)))
                n_eq += 1
                # the 17-64-asset tile at the same width: the same path, bit for bit
                got = H._launch_terminal(11, h, 1_029, steps, 6, 2, wide=True)
                torch.cuda.synchronize()
                held_equal(f"heston_terminal A={a} steps={steps} xi={xi} tile 64", want,
                           bits(got))
                n_eq += 1
            for t_df in (None, 5.5):
                want = bits(on("other")[0].garch_terminal(11, g, 1_029, steps, t_df=t_df, **kw))
                G = on("this")[0]
                held_equal(f"garch_terminal A={a} steps={steps} t_df={t_df}", want,
                           bits(G.garch_terminal(11, g, 1_029, steps, t_df=t_df, **kw)))
                n_eq += 1
    print(f"terminal comparisons: {n_eq}")

    p_term = 1 << 20
    h15, g15 = S.bench_heston().tensors(dev), S.bench_garch().tensors(dev)
    hp, gp, w15 = S.bench_heston(), S.bench_garch(), S.bench_weights()

    def best(fn):
        return min(S._time_ms(fn, 2) for _ in range(3))

    def wall(fn):
        torch.cuda.synchronize()
        t0 = S.time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (S.time.perf_counter() - t0)

    timed = {"heston": lambda side: lambda: side[2].heston_terminal(0, h15, p_term, 252),
             "garch poly": lambda side: lambda: side[0].garch_terminal(0, g15, p_term, 252),
             "garch t(5.5)": lambda side: lambda: side[0].garch_terminal(0, g15, p_term, 252,
                                                                          t_df=5.5)}
    res, firsts = {}, {}
    for order in ("other", "this", "this", "other"):
        side = on(order)
        for name, make in timed.items():
            fn = make(side)
            out = fn()
            torch.cuda.synchronize()
            firsts.setdefault((name, order), bits(out))
            res.setdefault((name, order), []).append(best(fn))
        heston_mod = side[4]["mcport_torch.models.heston"]
        garch_mod = side[4]["mcport_torch.models.garch_mc"]
        for name, fn in (
                ("heston_terminal_returns wall", lambda: heston_mod.heston_terminal_returns(
                    S.FAMILY_SEED, hp, p_term, 252, device=dev)),
                ("garch_risk wall", lambda: garch_mod.garch_risk(
                    S.FAMILY_SEED, gp, w15, n_paths=p_term, n_steps=252, device=dev)),
                ("garch_risk t(5.5) wall", lambda: garch_mod.garch_risk(
                    S.FAMILY_SEED, gp, w15, n_paths=p_term, n_steps=252, t_df=5.5,
                    device=dev))):
            fn()
            out, ms = min((wall(fn) for _ in range(3)), key=lambda x: x[1])
            key = bits(out) if isinstance(out, torch.Tensor) else (out.var, out.cvar,
                                                                   out.port_mean)
            firsts.setdefault((name, order), key)
            res.setdefault((name, order), []).append(ms)
    for (name, order), t in sorted(res.items()):
        print(f"ab {name} {order}: " + " / ".join(f"{x:.3f}" for x in t) + " ms")
    worst = 0.0
    for name in sorted({k[0] for k in res}):
        other, this_ = min(res[(name, "other")]), min(res[(name, "this")])
        x, y = firsts[(name, "other")], firsts[(name, "this")]
        same = (all(torch.equal(p, q) for p, q in zip(x, y)) if isinstance(x, list)
                else x == y)
        if not same:
            unequal.append(f"{name} timed")
        if "wall" not in name:
            worst = max(worst, this_ / other - 1.0)
        print(f"speedup {name} A=15 1,048,576 x 252: {other:.3f} -> {this_:.3f} ms, "
              f"{other / this_:.3f}x, {'results' if 'wall' in name else 'outputs'} "
              f"{'equal' if same else 'DIFFERENT'}")
    # both trees' kernels and this tree's 17-64-asset tile at A = 1, 7, 15, 16
    for a in (1, 7, 15, 16):
        h, g = S.bench_heston(a).tensors(dev), S.bench_garch(a).tensors(dev)
        for fam in ("heston", "garch poly", "garch t(5.5)"):
            t_df = 5.5 if "t(5.5)" in fam else None
            times = {}
            for order in ("other", "this", "this", "other"):
                side = on(order)
                fn = ((lambda: side[2].heston_terminal(0, h, p_term, 252)) if fam == "heston"
                      else (lambda: side[0].garch_terminal(0, g, p_term, 252, t_df=t_df)))
                fn()
                times.setdefault(order, []).append(best(fn))
            other, this_ = min(times["other"]), min(times["this"])
            if a in (1, 7, 16):
                worst = max(worst, this_ / other - 1.0)
            side = on("this")
            fn = ((lambda: side[2]._launch_terminal(0, h, p_term, 252, -1, 1, wide=True))
                  if fam == "heston" else
                  (lambda: side[0]._launch_terminal(0, g, p_term, 252, -1, 1, t_df, wide=True)))
            fn()
            print(f"terminal {fam} A={a} 1,048,576 x 252: other {other:.3f}, this {this_:.3f} ms "
                  f"({other / this_:.3f}x); this tree's 17-64-asset tile {best(fn):.3f} ms")
    terminal_sass_counts()
    ptxas_report(("heston", "garch"))
    return f"#9/#4 most slower than the other tree {100 * worst:.2f}%"


notes = []
if PART in ("merton-heston", "all"):
    notes.append(merton_heston_part())
if PART in ("garch-bootstrap", "all"):
    notes.append(garch_bootstrap_part())
if PART in ("dcc", "all"):
    notes.append(dcc_part())
if PART in ("gbm", "all"):
    notes.append(gbm_part())
if PART in ("terminal", "all"):
    notes.append(terminal_part())
print(f"summary: sass {kept[0]} of {kept[1]} kept; outputs "
      f"{'all bit for bit' if not unequal else 'DIFFERENT: ' + ', '.join(unequal)}; "
      + "; ".join(notes))
sys.exit(0 if kept[0] == kept[1] and not unequal else 1)
