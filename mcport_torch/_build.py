"""Build and load the port's CUDA kernels.

``nvcc`` compiles each ``csrc/<name>.cu`` for Hopper (``sm_90a``) into a shared
library of its own with a plain C interface, loaded with ``ctypes``: no
PyTorch headers, so a build takes seconds, and the sources build in parallel
(one ``nvcc`` process each, all started together). A library is built at
first use into ``mcport_torch/build/`` (listed in ``.gitignore``), under a
name keyed on a hash of its source, the shared headers (``csrc/*.cuh``) and
the flags, so a checkout builds it for itself and an edit rebuilds it.
``nvcc``'s resource report (``-Xptxas -v``: registers, shared memory, stack
frame and spills per kernel) is kept beside each library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

__all__ = ["KERNELS", "NVCC_FLAGS", "build_libraries", "library"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_c_ll, _c_int, _c_float, _c_ptr = (ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                   ctypes.c_void_p)
#: Each kernel library's C entry points and their argument types (see the
#: .cu): name, argtypes, then the next entry point's name, argtypes, ...
_I, _F, _P = [_c_int], [_c_float], [_c_ptr]
KERNELS = {
    "terminal_noise": ("mcport_terminal_noise", [
        _c_ll, _c_ll, _c_int, _c_int, _c_int, _c_int, _c_int, _c_float, _c_float,
        _c_ptr, _c_ptr, _c_ptr],
        "mcport_terminal_noise_wide", [_c_ll, _c_ll] + 5 * _I + 2 * _F + 2 * _P + _I + 2 * _P),
    "path_stats": ("mcport_path_stats", [
        _c_ll, _c_ll, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_float,
        _c_float, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr],
        "mcport_path_stats_wide",
        [_c_ll, _c_ll] + 6 * _I + 2 * _F + 7 * _P + 2 * _I + _P),
    "gbm_narrow": ("mcport_gbm_narrow_dd",
                   [_c_ll, _c_ll] + 9 * _I + 2 * _F + 7 * _P + [_c_ll, _c_int, _c_ptr]),
    "multi_dd": ("mcport_multi_dd", [
        _c_ll, _c_ll, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,
        _c_int, _c_float, _c_float, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr],
        "mcport_multi_dd_wide",
        [_c_ll, _c_ll] + 9 * _I + 2 * _F + 7 * _P + 2 * _I + _P),
    "garch": ("mcport_garch_terminal", [
        _c_ll, _c_ll, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_float, _c_float,
        _c_ptr, _c_ptr, _c_ptr],
        "mcport_garch_multi_dd", [_c_ll, _c_ll] + 7 * _I + 6 * _P + [_c_ll, _c_int, _c_ptr],
        "mcport_garch_wide",
        [_c_ll, _c_ll] + 6 * _I + 2 * _F + _I + 6 * _P + 2 * _I + _P),
    "bootstrap": ("mcport_bootstrap_terminal", [
        _c_ll, _c_ll, _c_int, _c_int, _c_int, _c_int, _c_int, _c_float, _c_int, _c_ptr,
        _c_ptr, _c_ptr],
        "mcport_bootstrap_multi_dd",
        [_c_ll, _c_ll] + 7 * _I + _F + _I + 6 * _P + [_c_ll, _c_int, _c_ptr],
        "mcport_bootstrap_wide", [_c_ll, _c_ll] + 7 * _I + _F + 6 * _P + 2 * _I + _P),
    "jump": ("mcport_merton_multi_dd", [
        _c_ll, _c_ll, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_float, _c_ptr,
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ll, _c_int, _c_ptr],
        "mcport_merton_multi_dd_wide", [_c_ll, _c_ll] + 6 * _I + _F + 6 * _P + 2 * _I + _P),
    "heston": ("mcport_heston_terminal", [
        _c_ll, _c_ll, _c_int, _c_int, _c_int, _c_int, _c_int, _c_ptr, _c_ptr, _c_ptr],
        "mcport_heston_multi_dd", [_c_ll, _c_ll] + 7 * _I + 6 * _P + [_c_ll, _c_int, _c_ptr],
        "mcport_heston_wide", [_c_ll, _c_ll] + 6 * _I + 6 * _P + 2 * _I + _P),
    "dcc": ("mcport_dcc_terminal", [
        _c_ll, _c_ll, _c_int, _c_int, _c_int, _c_int, _c_ptr, _c_ptr, _c_ptr],
        "mcport_dcc_multi_dd", [_c_ll, _c_ll] + 6 * _I + 6 * _P + [_c_ll] + _P,
        "mcport_dcc_wide", [_c_ll, _c_ll] + 6 * _I + 6 * _P + [_c_ll] + _P),
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("the port's kernels need nvcc; no CUDA toolkit was "
                           "found (set CUDA_HOME)")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sorted(_CSRC.glob("*.cuh")), _CSRC / f"{name}.cu"]:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return _BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_libraries(names=tuple(KERNELS)) -> dict[str, Path]:
    """Compile every kernel of ``names`` that has no library for its current
    sources, all at once; return each one's library path. Each build writes a
    temporary file and renames it into place, so concurrent builders never
    show a reader a half-written library."""
    paths = {name: _library_path(name) for name in names}
    todo = {name: so for name, so in paths.items() if not so.exists()}
    if not todo:
        return paths
    _BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    try:
        for name, so in todo.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(_CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}.cu ({proc.returncode}):\n{out}")
                continue
            todo[name].with_suffix(".log").write_text(out)
            os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return paths


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, its entry points' signatures
    declared."""
    entries = KERNELS[name]
    lib = ctypes.CDLL(str(build_libraries((name,))[name]))
    for fn_name, argtypes in zip(entries[::2], entries[1::2]):
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = _c_int
    lib.mcport_error_string.argtypes = [_c_int]
    lib.mcport_error_string.restype = ctypes.c_char_p
    return lib
