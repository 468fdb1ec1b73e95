"""Whether one kernel source gives the same SASS when built again with the
port's flags: builds ``mcport_torch/csrc/NAME.cu`` four times at once — to
one output name in two directories, to another output name, and from a copy
of ``csrc`` in another directory (as ``tools/ab_narrow_kernels.py`` builds
the other tree's) — and prints for each kernel whether its instructions
equal the first build's (parameter offsets and the anonymous namespace's
name masked, as that tool masks them), and, where they do not, whether
they do once register numbers, ``.reuse`` flags and addresses are masked as
well.

    python3 tools/sass_rebuild.py dcc      # on a machine with nvcc

A library's build (``mcport_torch/_build.py``) writes to a temporary file of
a random name and renames it into place."""
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

from torch.utils.cpp_extension import CUDA_HOME

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from mcport_torch._build import NVCC_FLAGS  # noqa: E402

NAME = sys.argv[1] if len(sys.argv) > 1 else "dcc"
BIN = Path(CUDA_HOME) / "bin"


def sass(so: Path) -> dict:
    """``{kernel: [instruction, ...]}``, parameter offsets and the anonymous
    namespace's name masked."""
    text = subprocess.run([str(BIN / "cuobjdump"), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    out, key = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            key = re.sub(r"_GLOBAL__N__\w+?_[0-9a-f]{8}", "", m.group(1))
            out[key] = []
        elif key and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            ins = re.sub(r"/\*.*?\*/", "", line).strip()
            out[key].append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][P]", ins))
    return out


def masked(ins: list) -> Counter:
    """The instructions as a multiset, registers, reuse flags and addresses masked."""
    return Counter(re.sub(r"\b(U?R|P|B)\d+\b", r"\1", re.sub(r"0x[0-9a-f]+", "X", i))
                   .replace(".reuse", "") for i in ins)


with tempfile.TemporaryDirectory() as tmp:
    src = ROOT / "mcport_torch" / "csrc"
    copy = Path(tmp) / "copy" / "mcport_torch" / "csrc"
    shutil.copytree(src, copy)
    builds = [(src, Path(tmp) / "a" / "lib.so"), (src, Path(tmp) / "b" / "lib.so"),
              (src, Path(tmp) / "a" / "other.so"), (copy, Path(tmp) / "c" / "lib.so")]
    procs = []
    for where, o in builds:
        o.parent.mkdir(exist_ok=True)
        procs.append(subprocess.Popen([str(BIN / "nvcc"), *NVCC_FLAGS, "-o", str(o),
                                       str(where / f"{NAME}.cu")],
                                      stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
    assert all(p.wait() == 0 for p in procs)
    first, *rest = (sass(o) for _, o in builds)
    for label, other in zip(("same name, other directory", "other name",
                             "the source copied to another directory"), rest):
        same = [k for k in first if other.get(k) == first[k]]
        alloc = [k for k in first if k not in same and k in other
                 and masked(other[k]) == masked(first[k])]
        print(f"{NAME}.cu built twice ({label}): {len(same)} of {len(first)} kernels the same "
              f"SASS, {len(alloc)} more the same once registers, reuse flags and addresses are "
              f"masked" + "".join(f"\n  differs: {k}" for k in first if k not in same))
