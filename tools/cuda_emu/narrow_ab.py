"""Bit-for-bit A/B of two trees' Merton (#8), Heston (#10), GARCH (#5) and
bootstrap (#7) candidate kernels on the CPU, under the host emulation of
``cuda_runtime.h`` (no nvcc or card needed; g++ with C++20).

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
the trees is the card's (``tools/ab_narrow_kernels.py``). Prints one
line per launch and exits 1 if any output differs.
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


def main() -> int:
    other = Path(sys.argv[1]).resolve()
    this = Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else HERE.parents[1]
    families = sys.argv[3].split(",") if len(sys.argv) > 3 else list(ENTRY)
    bad = n = 0
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
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
