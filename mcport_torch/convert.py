"""Carry parameters from mcport (NumPy) into the port (torch).

The tests feed both packages from the same NumPy arrays through these
functions. Weight vectors need no conversion: the port's engine and API take
NumPy weights as mcport's do. Checkpoints are deliberately not carried
across: the two packages draw different random streams, and the port's run
digest refuses mcport's.
"""

from __future__ import annotations

import numpy as np
import torch

from mcport_torch.models.gbm import GBMParams

__all__ = ["gbm_params_from_numpy", "from_mcport"]


def _f64(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float64))


def gbm_params_from_numpy(s0, mean_step, chol_step) -> GBMParams:
    """Port :class:`GBMParams` (float64 CPU tensors, copied) from arrays of
    shapes (A,), (A,) and (A, A)."""
    s0, mean_step, chol_step = _f64(s0), _f64(mean_step), _f64(chol_step)
    a = s0.shape[-1]
    if s0.shape != (a,) or mean_step.shape != (a,) or chol_step.shape != (a, a):
        raise ValueError(f"shapes {tuple(s0.shape)}, {tuple(mean_step.shape)}, "
                         f"{tuple(chol_step.shape)} do not describe one universe")
    return GBMParams(s0=s0, mean_step=mean_step, chol_step=chol_step)


def from_mcport(params) -> GBMParams:
    """The port's counterpart of an ``mcport.models.gbm.GBMParams``."""
    return gbm_params_from_numpy(params.s0, params.mean_step, params.chol_step)
