"""Bit-for-bit A/B of two trees' DCC kernels on the CPU, under the host
emulation of ``cuda_runtime.h`` (no nvcc or card needed; g++ with C++20).

    python3 tools/cuda_emu/dcc_ab.py OTHER_TREE [THIS_TREE]

Each tree is a directory holding ``mcport_torch/csrc`` (``git archive
<commit> mcport_torch | tar -x -C DIR``; this tree defaults to the
repository). Both are built with ``-ffp-contract=off`` and run on the same
launches: up to 16 assets (every width) the terminal function and the
candidates at W = 1, 5, 16, 17 and 256, hedged at W = 1, 5 and 256 (two
legs per asset, every type); past 16 the terminal function, W = 1 and 256
candidates and the hedged mode at widths across the group sizes, the
4-column panels and the layouts' boundaries; 5 steps (two Philox calls),
two dispatch blocks. Prints one line per launch and exits 1 if any
output differs. A tree whose ``mcport_dcc_wide`` takes a CTA count is built
with ``-DDCC_CTAS_API``, one whose ``mcport_dcc_multi_dd`` takes a scratch
with ``-DDCC_NARROW_SCRATCH``.
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

WIDTHS = (*range(1, 17), 17, 31, 33, 64, 65, 129, 220, 221, 256)
CASES = [(0, 0, 0, 1), (1, 256, 0, 0), (1, 1, 2, 1)]   # (mode, W, legs, case)
#: up to 16 assets, both layouts of the candidate kernel (solo up to W = 16,
#: pipelined past it) on each side of the switch, hedged in each
NARROW_CASES = [(0, 0, 0, 1), (1, 1, 0, 0), (1, 5, 0, 1), (1, 16, 0, 0), (1, 17, 0, 1),
                (1, 256, 0, 0), (1, 1, 2, 1), (1, 5, 2, 0), (1, 256, 2, 1)]


def build(tree: Path, work: Path, tag: str) -> Path:
    csrc = work / tag
    prep(tree / "mcport_torch" / "csrc", csrc)
    src = (csrc / "dcc.cu").read_text()
    api = ["-DDCC_CTAS_API"] if "int n_ctas, void* stream" in src else []
    narrow = re.search(r"int mcport_dcc_multi_dd\((.*?)\)", src, re.S)
    if narrow and "scratch" in narrow.group(1):
        api.append("-DDCC_NARROW_SCRATCH")
    exe = work / f"dcc_emu_{tag}"
    subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off", *api, f"-I{HERE}",
                    f"-I{csrc}", str(HERE / "dcc_main.cpp"), "-o", str(exe), "-lpthread"],
                   check=True)
    return exe


def main() -> int:
    other = Path(sys.argv[1]).resolve()
    this = Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else HERE.parents[1]
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        exes = {"other": build(other, work, "other"), "this": build(this, work, "this")}
        for a in WIDTHS:
            paths = 5 if a > 64 else 19
            for mode, w, legs, case in (NARROW_CASES if a <= 16 else CASES):
                args = [str(x) for x in (mode, a, paths, 5, 2, w, legs, case)]
                outs = {}
                for side, exe in exes.items():
                    out = work / f"{side}.bin"
                    subprocess.run([str(exe), *args, str(out)], check=True, timeout=900)
                    outs[side] = np.fromfile(out, np.float32)
                same = outs["other"].tobytes() == outs["this"].tobytes()
                bad += not same
                what = ("terminal" if mode == 0 else f"W={w}") + (f" L={legs}" if legs else "")
                print(f"A={a} {what} case {case}: {outs['this'].size} outputs, "
                      f"{'bit for bit' if same else 'DIFFERENT'}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
