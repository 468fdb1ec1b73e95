"""The loops of a kernel's SASS: for each backward branch, the loop's
address range, its instruction count, its commonest opcodes and the order
of its global loads (LDG), shared loads (LDS) and FP32 FMAs (FFMA), which
shows whether the loads of an unrolled body all come before its FMAs or
one pair at a time.

    python3 tools/sass_loops.py LIB.so KERNEL_SUBSTRING   # runs cuobjdump -sass (CUDA toolkit)
    python3 tools/sass_loops.py DUMP.sass KERNEL_SUBSTRING  # a saved cuobjdump -sass dump

Every kernel whose mangled name contains KERNEL_SUBSTRING is listed (for
example ``dcc_wider_kernelILb1ELb0ELb0E`` for one instantiation)."""
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path


def sass_text(path: Path) -> str:
    if path.suffix != ".so":
        return path.read_text()
    from torch.utils.cpp_extension import CUDA_HOME

    return subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout


def kernels(text: str, want: str) -> dict:
    """{mangled name: [(address, instruction), ...]} of the kernels matching want."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            cur = m.group(1) if want in m.group(1) else None
            if cur:
                out[cur] = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if cur and m:
            out[cur].append((int(m.group(1), 16), m.group(2).strip()))
    return out


def opcode(ins: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0].split(".")[0]


def main() -> int:
    for name, ins in kernels(sass_text(Path(sys.argv[1])), sys.argv[2]).items():
        print(f"{name}: {len(ins)} instructions")
        for addr, s in ins:
            m = re.search(r"\bBRA\S*\s+(?:`\(\.L_x_\d+\)\s*)?0x([0-9a-f]+)", s)
            if not m or int(m.group(1), 16) >= addr:
                continue
            start = int(m.group(1), 16)
            body = [opcode(x) for a, x in ins if start <= a <= addr]
            top = ", ".join(f"{op} {n}" for op, n in Counter(body).most_common(6))
            order = " ".join(op for op in body if op in ("LDG", "LDS", "FFMA"))
            print(f"  loop {start:#06x}-{addr:#06x}: {len(body)} instructions ({top})")
            if len(body) <= 120 and order:
                print(f"    loads and FMAs in order: {order}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
