"""Device selection: the port's counterpart of ``mcport/utils/backend.py``.

Every public function of the port takes an explicit ``device``; nothing picks
``cuda`` or ``cpu`` on its own. Asking for a card that is not there raises:
there is no silent CPU fallback, because a run on the CPU is a different
measurement, not a slower one.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(name: str | torch.device) -> torch.device:
    """``torch.device`` for ``name`` ("cuda", "cuda:1", "cpu"), checked.

    Raises ``RuntimeError`` for a CUDA device when no card is visible or the
    index is out of range, and ``ValueError`` for any other device type.
    """
    dev = torch.device(name)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device must be 'cuda[:N]' or 'cpu', got {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch sees no CUDA device "
            f"(torch {torch.__version__}, built for CUDA {torch.version.cuda})")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {name!r} requested but only {torch.cuda.device_count()} "
            "CUDA device(s) are visible")
    return torch.device("cuda", index)
