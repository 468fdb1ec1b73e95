"""Build and load the port's CUDA kernels.

``nvcc`` compiles ``csrc/*.cu`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with ``ctypes``: no PyTorch headers,
so a build takes seconds. The library is built at first use into
``mcport_torch/build/`` (listed in ``.gitignore``), under a name keyed on a
hash of the sources and flags, so a checkout builds it for itself and an edit
rebuilds it. ``nvcc``'s resource report (``-Xptxas -v``: registers, shared
memory, spills per kernel) is kept beside the library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

__all__ = ["library", "build_library", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _sources() -> list[Path]:
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("the port's kernels need nvcc; no CUDA toolkit was "
                           "found (set CUDA_HOME)")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def build_library() -> Path:
    """Compile the kernels unless a library for these sources exists; return
    its path. Concurrent builders each write a temporary file and rename it
    into place, so a reader never sees a half-written library."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    so = _BUILD_DIR / f"libmcport_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    _BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(s) for s in srcs if s.suffix == ".cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's signature declared."""
    lib = ctypes.CDLL(str(build_library()))
    c_ll, c_int, c_float, c_ptr = (ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_float, ctypes.c_void_p)
    lib.mcport_terminal_noise.argtypes = [
        c_ll, c_ll, c_int, c_int, c_int, c_int, c_int, c_float, c_float,
        c_ptr, c_ptr, c_ptr]
    lib.mcport_terminal_noise.restype = c_int
    lib.mcport_error_string.argtypes = [c_int]
    lib.mcport_error_string.restype = ctypes.c_char_p
    return lib
