"""The ctypes signatures of ``mcport_torch._build.KERNELS`` against the C
entry points of ``mcport_torch/csrc/*.cu``, on the CPU (no ``nvcc`` needed).

A signature that does not match its C parameters shifts every argument after
the mismatch, silently. Each entry point's parameters are read from its
``.cu`` source and mapped to ctypes (``long long``, ``int``, ``float``, any
pointer) one for one, in order.
"""

import ctypes
import re
from pathlib import Path

import pytest

from mcport_torch._build import KERNELS

CSRC = Path(__file__).resolve().parents[1] / "mcport_torch" / "csrc"


def _c_entry_points(name: str) -> dict[str, list]:
    """``{function: [ctypes type, ...]}`` of the ``int mcport_*(...)`` entry
    points of ``csrc/<name>.cu``."""
    src = (CSRC / f"{name}.cu").read_text()
    out = {}
    for m in re.finditer(r"^int (mcport_\w+)\(([^)]*)\)\s*\{", src, flags=re.M):
        types = []
        for param in m.group(2).split(","):
            param = " ".join(param.split())
            if "*" in param:
                types.append(ctypes.c_void_p)
            elif param.startswith("long long "):
                types.append(ctypes.c_longlong)
            elif param.startswith("int "):
                types.append(ctypes.c_int)
            elif param.startswith("float "):
                types.append(ctypes.c_float)
            else:
                raise AssertionError(f"{name}.cu {m.group(1)}: unknown parameter {param!r}")
        out[m.group(1)] = types
    return out


ENTRIES = [(lib, fn) for lib, entries in KERNELS.items() for fn in entries[::2]]


def test_every_c_entry_point_has_a_signature():
    declared = {fn for _, fn in ENTRIES}
    for lib in KERNELS:
        assert set(_c_entry_points(lib)) <= declared, lib


@pytest.mark.parametrize("lib, fn", ENTRIES, ids=[fn for _, fn in ENTRIES])
def test_ctypes_signature_matches_the_c_parameters(lib, fn):
    entries = KERNELS[lib]
    argtypes = entries[entries.index(fn) + 1]
    assert argtypes == _c_entry_points(lib)[fn]
