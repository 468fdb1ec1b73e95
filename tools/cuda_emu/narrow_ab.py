"""Bit-for-bit A/B of two trees' Merton (#8), Heston (#10), GARCH (#5),
bootstrap (#7) and GBM (#3, with the path-stats function #2) kernels, and
of their Heston (#9) and GARCH (#4) terminal kernels, on the CPU, under the
host emulation of ``cuda_runtime.h`` (no nvcc or card needed; g++ with
C++20).

    python3 tools/cuda_emu/narrow_ab.py OTHER_TREE [THIS_TREE] [FAMILY,...]

Each tree is a directory holding ``mcport_torch/csrc`` (``git archive
<commit> mcport_torch | tar -x -C DIR``; this tree defaults to the
repository). Both are built with ``-ffp-contract=off`` and run on the same
launches: A = 1, 2, 7, 15, 16 (and 17, 33, the 17-64-asset layout) at W = 1,
8, 9, 16 and 256, unhedged and hedged (two legs per asset, every type), at
the bench's jump rate, vol of vol, GARCH persistence or 365-row history
in shared memory and at a high rate, a Feller-violating vol of vol, larger
GARCH shocks or a 4,099-row history in device memory, 9 steps (three
Philox calls) over two blocks of 37 paths (a multiple of no tile). Up to 16
assets this tree runs every layout of its entry point
(``-DNARROW_LAYOUTS``: the one W picks, then solo, split and, for Heston,
tile by name; a layout whose block the shared memory cannot
hold is refused and skipped), each against the other tree's one launch.
FAMILY (``jump,heston,garch,bootstrap`` by default) picks families. The
emulation rounds every operation the source leaves to the compiler on its
own (no contraction), so GARCH, whose former candidate kernel left its
variance update's multiply-adds to nvcc while the redesigned layouts write
nvcc's two FMAs out, is compared like for like only between this tree's
layouts: the one W picks and split against solo, bit for bit; the A/B of
the trees is the card's (``tools/ab_narrow_kernels.py``). FAMILY ``gbm``
(not in the default) holds #3 of this tree against the other tree's
``multi_dd.cu`` — up to 16 assets ``csrc/gbm_narrow.cu`` in every layout
(by W, solo, split), at 17 and 33 ``multi_dd.cu``'s tile kernel (A = 1, 7,
16, 17, 33, W = 1, 9 and 256, the three draw tiers, modes and score tiers,
and a factor with terms above its diagonal; 9 steps, and 0 steps with the
poly draws) — and this tree's ``path_stats.cu`` (#2) against the other
tree's (terminal logS, port, dd), 9 steps over two blocks of 37 paths
(``tools/cuda_emu/gbm_main.inc``). FAMILY ``heston-terminal`` and
``garch-terminal`` (not in the default) hold this tree's terminal kernel
#9 or #4, in the layout its entry point routes to, against the other
tree's at A = 1, 2, 7, 15, 16 and 0, 1, 7 and 9 steps over two blocks of 37
paths: Heston at both vols of vol, its output and its log sum, GARCH at both
parameter sets in both draw tiers, the other tree's terminal
multiply-adds written out as nvcc contracted them where that tree left them
to nvcc (``GARCH_CONTRACTIONS``). Prints one line per launch and exits 1 if
any output differs.
"""
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from prep import prep  # noqa: E402

WIDTHS = (1, 2, 7, 15, 16, 17, 33)
CANDIDATES = (1, 8, 9, 16, 256)
ENTRY = {"jump": "mcport_merton_multi_dd", "heston": "mcport_heston_multi_dd",
         "garch": "mcport_garch_multi_dd", "bootstrap": "mcport_bootstrap_multi_dd"}
#: the layouts each family's entry point takes by name (ops/narrow.py LAYOUTS)
NAMED = {"jump": (0, 1), "heston": (0, 1, 2), "garch": (0, 1), "bootstrap": (0, 1)}


def build(tree: Path, work: Path, tag: str, family: str) -> tuple[Path, bool]:
    """The emulated driver of ``family`` in ``tree``, and whether its entry
    point takes a layout."""
    csrc = work / f"{tag}_csrc"
    if not csrc.exists():
        prep(tree / "mcport_torch" / "csrc", csrc)
    src = (csrc / f"{family}.cu").read_text()
    sig = re.search(rf"int {ENTRY[family]}\((.*?)\)", src, re.S)
    layouts = bool(sig and "layout" in sig.group(1))
    flags = [f"-DFAMILY_{family.upper()}"] + (["-DNARROW_LAYOUTS"] if layouts else [])
    exe = work / f"{family}_emu_{tag}"
    subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off", *flags, f"-I{HERE}",
                    f"-I{csrc}", str(HERE / "narrow_main.cpp"), "-o", str(exe), "-lpthread"],
                   check=True)
    return exe, layouts


def build_gbm(tree: Path, work: Path, tag: str, build: str) -> Path:
    """The emulated GBM executable ``build`` (GBM, GBM_TILE, GBM_STATS) of ``tree``."""
    csrc = work / f"{tag}_csrc"
    if not csrc.exists():
        prep(tree / "mcport_torch" / "csrc", csrc)
    exe = work / f"{build}_emu_{tag}"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", f"-DFAMILY_{build}",
                    f"-I{HERE}", f"-I{csrc}", str(HERE / "narrow_main.cpp"), "-o", str(exe),
                    "-lpthread"], check=True)
    return exe


def gbm_ab(other: Path, this: Path, work: Path) -> tuple[int, int]:
    """#3 and #2 of this tree against the other's: (launches, differences)."""
    exe = {(tag, d): build_gbm(tree, work, tag, d) for tag, tree in (("other", other),
                                                                      ("this", this))
           for d in ("GBM_TILE", "GBM_STATS")}
    exe["this", "GBM"] = build_gbm(this, work, "this", "GBM")
    n = bad = 0

    def same(x: Path, y: Path) -> bool:
        return np.fromfile(x, np.float32).tobytes() == np.fromfile(y, np.float32).tobytes()

    def run(key, args, out) -> bool:
        return subprocess.run([str(exe[key]), *args, str(out)], timeout=900).returncode == 0

    for a in (1, 7, 16, 17, 33):
        for w in (1, 9, 256):
            for draw in range(3):
                for mode in range(3):
                    for score in range(3):
                        for full, steps in ([(0, 9), (1, 9)] if score == 0 else [(0, 9)]) + (
                                [(0, 0)] if draw == 0 else []):
                            code = f"{draw}{mode}{score}{full}"
                            legs = 2 if mode == 2 else 0
                            args = [str(x) for x in (a, 37, steps, 2, w, legs)]
                            ref, got = work / "other.bin", work / "this.bin"
                            assert run(("other", "GBM_TILE"), args + ["-1", code], ref)
                            layouts = ([(name, ("this", "GBM"), lay) for name, lay in
                                        (("by W", "-1"), ("solo", "0"), ("split", "1"))]
                                       if a <= 16 else [("tile", ("this", "GBM_TILE"), "-1")])
                            for name, key, lay in layouts:
                                what = f"gbm A={a} W={w} steps={steps} case {code} {name}"
                                if not run(key, args + [lay, code], got):
                                    print(f"{what}: refused")
                                    continue
                                ok = same(ref, got)
                                bad += not ok
                                n += 1
                                print(f"{what}: {'bit for bit' if ok else 'DIFFERENT'}",
                                      flush=True)
    for a in (1, 7, 16):
        for draw in range(3):
            for mode in range(2):
                for full in (0, 1):
                    code = f"{draw}{mode}0{full}"
                    args = [str(x) for x in (a, 150, 9, 2, 0, 0, "-1", code)]
                    ref, got = work / "other.bin", work / "this.bin"
                    assert run(("other", "GBM_STATS"), args, ref)
                    assert run(("this", "GBM_STATS"), args, got)
                    ok = same(ref, got)
                    bad += not ok
                    n += 1
                    print(f"path_stats A={a} case {code}: {'bit for bit' if ok else 'DIFFERENT'}",
                          flush=True)
    return n, bad


#: the GARCH terminal kernel up to commit 96dcd2a left these multiply-adds to nvcc;
#: written out as nvcc contracted them (read from that kernel's SASS), so that the
#: emulation, which contracts nothing, compares like for like
GARCH_CONTRACTIONS = (
    ("  return q.omega[a] + q.alpha[a] * q.e2_0[a] + q.beta[a] * q.s2_0[a];",
     "  return __fmaf_rn(q.beta[a], q.s2_0[a], __fmaf_rn(q.alpha[a], q.e2_0[a], q.omega[a]));"),
    ("""          const float eps = sqrtf(fmaxf(s2[i], 0.0f)) * y;
          cum[i] *= g.w + eps;
          const float e2 = eps * eps;
          s2[i] = g.x + g.y * e2 + g.z * s2[i];""",
     """          const float eps = __fmul_rn(sqrtf(fmaxf(s2[i], 0.0f)), y);
          cum[i] = __fmul_rn(cum[i], __fadd_rn(g.w, eps));
          s2[i] = __fmaf_rn(g.z, s2[i], __fmaf_rn(g.y, __fmul_rn(eps, eps), g.x));"""),
)


def terminal_ab(other: Path, this: Path, work: Path, family: str) -> tuple[int, int]:
    """The terminal kernel of ``family`` (heston: #9, garch: #4) of this tree,
    in the layout its entry point routes to, against the other tree's: A = 1,
    2, 7, 15, 16 at 0, 1, 7 and 9 steps over two blocks of 37 paths (blocks 7
    and 8); Heston at both vols of vol, its output and its log sum; GARCH at
    both parameter sets in both tiers, the other tree's contractions written
    out where it left them to nvcc (GARCH_CONTRACTIONS). (launches, differences)."""
    base = family.removesuffix("-terminal")
    exe = {}
    for tag, tree in (("other", other), ("this", this)):
        csrc = work / f"{tag}_{base}_terminal_csrc"
        prep(tree / "mcport_torch" / "csrc", csrc)
        if base == "garch" and tag == "other":
            src = (csrc / "garch.cu").read_text()
            done = [old for old, _ in GARCH_CONTRACTIONS if old in src]
            for old, new in GARCH_CONTRACTIONS:
                src = src.replace(old, new)
            (csrc / "garch.cu").write_text(src)
            print(f"garch-terminal: the other tree's contractions written out: {len(done)} of "
                  f"{len(GARCH_CONTRACTIONS)} expressions")
        layouts = bool(re.search(rf"int {ENTRY[base]}\([^)]*layout", (csrc / f"{base}.cu")
                                 .read_text(), re.S))
        exe[tag] = work / f"{base}_terminal_emu_{tag}"
        subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off",
                        f"-DFAMILY_{base.upper()}"] + (["-DNARROW_LAYOUTS"] if layouts else [])
                       + [f"-I{HERE}", f"-I{csrc}", str(HERE / "narrow_main.cpp"), "-o",
                          str(exe[tag]), "-lpthread"], check=True)
    n = bad = 0
    for a in (1, 2, 7, 15, 16):
        for steps in (0, 1, 7, 9):
            for case in range(4):
                args = [str(x) for x in (a, 37, steps, 2, 0, 0, "-1", case)]
                want, got = work / "other.bin", work / "this.bin"
                subprocess.run([str(exe["other"]), *args, str(want)], check=True, timeout=900)
                subprocess.run([str(exe["this"]), *args, str(got)], check=True, timeout=900)
                same = (np.fromfile(want, np.float32).tobytes()
                        == np.fromfile(got, np.float32).tobytes())
                bad += not same
                n += 1
                what = ({0: "xi 3e-3", 1: "xi 0.05", 2: "xi 3e-3 log sum",
                         3: "xi 0.05 log sum"} if base == "heston" else
                        {0: "poly", 1: "poly, larger shocks", 2: "t(5.5)",
                         3: "t(5.5), larger shocks"})[case]
                print(f"{family} A={a} steps={steps} {what}: "
                      f"{'bit for bit' if same else 'DIFFERENT'}", flush=True)
    return n, bad


def main() -> int:
    other = Path(sys.argv[1]).resolve()
    this = Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else HERE.parents[1]
    families = sys.argv[3].split(",") if len(sys.argv) > 3 else list(ENTRY)
    bad = n = 0
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        if "gbm" in families:
            families.remove("gbm")
            n, bad = gbm_ab(other, this, work)
        for family in [f for f in families if f.endswith("-terminal")]:
            families.remove(family)
            dn, db = terminal_ab(other, this, work, family)
            n, bad = n + dn, bad + db
        for family in families:
            o_exe, _ = build(other, work, "other", family)
            t_exe, layouts = build(this, work, "this", family)
            for a in WIDTHS:
                for w in CANDIDATES:
                    for legs, case in ((0, 0), (0, 1), (2, 1)):
                        args = [str(x) for x in (a, 37, 9, 2, w, legs)]
                        want = work / "other.bin"
                        subprocess.run([str(o_exe), *args, "-1", str(case), str(want)],
                                       check=True, timeout=900)
                        ref = np.fromfile(want, np.float32).tobytes()
                        named = NAMED[family]
                        if family == "garch" and layouts and a <= 16:
                            # like for like: this tree's solo layout is the reference
                            subprocess.run([str(t_exe), *args, "0", str(case), str(want)],
                                           timeout=900)
                            ref = np.fromfile(want, np.float32).tobytes()
                            named = (1,)
                        for layout in ((-1, *named) if layouts and a <= 16 else (-1,)):
                            got = work / "this.bin"
                            run = subprocess.run([str(t_exe), *args, str(layout), str(case),
                                                  str(got)], timeout=900)
                            if run.returncode and layout >= 0:
                                print(f"{family} A={a} W={w} L={legs} layout {layout}: refused")
                                continue
                            run.check_returncode()
                            same = np.fromfile(got, np.float32).tobytes() == ref
                            bad += not same
                            n += 1
                            name = {-1: "by W", 0: "solo", 1: "split", 2: "tile"}[layout]
                            print(f"{family} A={a} W={w} L={legs} case {case} layout {name}: "
                                  f"{'bit for bit' if same else 'DIFFERENT'}", flush=True)
    print(f"summary: {n - bad} of {n} launches bit for bit")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
