"""Copy a tree's ``csrc`` into a directory, rewritten for the host emulation
(``cuda_runtime.h`` beside this file): dynamic shared memory becomes the
block's buffer, a kernel's static ``__shared__`` array (of float or float4)
a function-static array (one per instantiation, which the threads of the
running block share: the emulation runs one block at a time), each
``bar.sync`` a named std::barrier, ``<<<...>>>`` a call of ``shim_launch``,
a volatile ``ld.shared.v4.f32`` a plain load.

    python3 tools/cuda_emu/prep.py SRC_CSRC_DIR DST_DIR
"""
import re
import sys
from pathlib import Path


def prep(src: Path, dst: Path) -> None:
    dst.mkdir(parents=True, exist_ok=True)
    for f in [*src.glob("*.cu"), *src.glob("*.cuh")]:
        t = f.read_text()
        t = re.sub(r"extern __shared__ (?:__align__\(16\) )?float (\w+)\[\];",
                   lambda m: f"float* {m.group(1)} = g_smem;", t)
        t = re.sub(r"(?<!extern )__shared__ (?:__align__\(16\) )?(float4?) (\w+)\[([^\]]+)\];",
                   lambda m: f"static {m.group(1)} {m.group(2)}[{m.group(3)}];", t)
        t = re.sub(r'asm volatile\("bar\.sync %0, %1;" ::"r"\((.*?)\), "r"\((.*?)\) : "memory"\);',
                   lambda m: f"shim_bar({m.group(1)}, {m.group(2)});", t)
        t = re.sub(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\(",
                   lambda m: f"shim_launch({m.group(1)}, {m.group(2)}, ", t, flags=re.S)
        # the volatile 16-byte shared loads (lds128, lds4): a plain load
        t = re.sub(r'asm volatile\("ld\.shared\.v4\.f32.*?__cvta_generic_to_shared\(p\)\)\)\);',
                   "v = *reinterpret_cast<const float4*>(p);", t, flags=re.S)
        (dst / f.name).write_text(t)


if __name__ == "__main__":
    prep(Path(sys.argv[1]), Path(sys.argv[2]))
