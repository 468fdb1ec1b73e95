"""Bit-for-bit A/B of two trees' DCC kernels on the CPU, under the host
emulation of ``cuda_runtime.h`` (no nvcc or card needed; g++ with C++20).

    python3 tools/cuda_emu/dcc_ab.py OTHER_TREE [THIS_TREE]

Each tree is a directory holding ``mcport_torch/csrc`` (``git archive
<commit> mcport_torch | tar -x -C DIR``; this tree defaults to the
repository). Both are built with ``-ffp-contract=off`` and run on the same
launches: the terminal function, W = 1 and 256 candidates and the hedged
mode (two legs per asset, every type) at widths across the group sizes,
the 4-column panels and the layouts' boundaries, 5 steps (two Philox
calls), two dispatch blocks. Prints one line per launch and exits 1 if any
output differs. A tree whose ``mcport_dcc_wide`` takes a CTA count is built
with ``-DDCC_CTAS_API``.
"""
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from prep import prep  # noqa: E402

WIDTHS = (17, 31, 33, 64, 65, 129, 220, 221, 256)
CASES = [(0, 0, 0, 1), (1, 256, 0, 0), (1, 1, 2, 1)]   # (mode, W, legs, case)


def build(tree: Path, work: Path, tag: str) -> Path:
    csrc = work / tag
    prep(tree / "mcport_torch" / "csrc", csrc)
    api = ["-DDCC_CTAS_API"] if "int n_ctas, void* stream" in (csrc / "dcc.cu").read_text() else []
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
            for mode, w, legs, case in CASES:
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
