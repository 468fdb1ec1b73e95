"""Carry parameters from mcport (NumPy) into the port (torch): GBM,
CCC-GARCH(1,1), DCC-GARCH(1,1), common-jump Merton and Heston, and option
legs and hedges.

The tests feed both packages from the same NumPy arrays through these
functions. Weight vectors need no conversion: the port's engine and API take
NumPy weights as mcport's do. Checkpoints are deliberately not carried
across: the two packages draw different random streams, and the port's run
digest refuses mcport's.
"""

from __future__ import annotations

import numpy as np
import torch

from mcport_torch.models.dcc import DCCGarchParams
from mcport_torch.models.garch_mc import CCCGarchParams
from mcport_torch.models.gbm import GBMParams
from mcport_torch.models.heston import HestonParams
from mcport_torch.models.jump import MertonParams
from mcport_torch.options.hedged import HedgeSpec
from mcport_torch.options.legs import Legs

__all__ = ["gbm_params_from_numpy", "garch_params_from_numpy", "dcc_params_from_numpy",
           "merton_params_from_numpy", "heston_params_from_numpy", "from_mcport"]


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


def garch_params_from_numpy(mu, omega, alpha, beta, corr_chol, sigma2_0,
                            eps2_0) -> CCCGarchParams:
    """Port :class:`CCCGarchParams` (float64 CPU tensors, copied) from six
    (A,) arrays and the (A, A) correlation factor."""
    p = CCCGarchParams(mu=_f64(mu), omega=_f64(omega), alpha=_f64(alpha), beta=_f64(beta),
                       corr_chol=_f64(corr_chol), sigma2_0=_f64(sigma2_0),
                       eps2_0=_f64(eps2_0))
    a = p.n_assets
    shapes = [tuple(getattr(p, f).shape) for f in ("omega", "alpha", "beta", "sigma2_0",
                                                    "eps2_0")]
    if p.mu.shape != (a,) or any(s != (a,) for s in shapes) or p.corr_chol.shape != (a, a):
        raise ValueError("the GARCH arrays do not describe one universe")
    return p


def dcc_params_from_numpy(base: CCCGarchParams, a_dcc, b_dcc, q0, e0) -> DCCGarchParams:
    """Port :class:`DCCGarchParams` (float64 CPU tensors, copied) from the
    port's GARCH base, the two coefficients, the (A, A) starting Q and the
    (A,) last standardised residual."""
    p = DCCGarchParams(base=base, a_dcc=_f64(a_dcc), b_dcc=_f64(b_dcc), q0=_f64(q0),
                       e0=_f64(e0))
    a = base.n_assets
    if (p.a_dcc.shape, p.b_dcc.shape, p.q0.shape, p.e0.shape) != ((), (), (a, a), (a,)):
        raise ValueError("the DCC arrays do not describe the base's universe")
    return p


def merton_params_from_numpy(s0, mean_step, chol_step, jump_rate, jump_mean,
                             jump_vol) -> MertonParams:
    """Port :class:`MertonParams` (float64 CPU tensors, copied) from the
    diffusion's arrays, the per-step jump rate and the (A,) jump mean and
    vol."""
    p = MertonParams(gbm_params_from_numpy(s0, mean_step, chol_step), float(jump_rate),
                     _f64(jump_mean), _f64(jump_vol))
    if p.jump_mean.shape != (p.n_assets,) or p.jump_vol.shape != (p.n_assets,):
        raise ValueError("the jump arrays do not describe the diffusion's universe")
    return p


def heston_params_from_numpy(mu, kappa, theta, xi, rho, v0, corr_chol, s0) -> HestonParams:
    """Port :class:`HestonParams` (float64 CPU tensors, copied) from seven (A,)
    arrays and the (A, A) correlation factor."""
    p = HestonParams(mu=_f64(mu), kappa=_f64(kappa), theta=_f64(theta), xi=_f64(xi),
                     rho=_f64(rho), v0=_f64(v0), corr_chol=_f64(corr_chol), s0=_f64(s0))
    a = p.n_assets
    vectors = ("kappa", "theta", "xi", "rho", "v0", "s0")
    if (p.mu.shape != (a,) or any(getattr(p, f).shape != (a,) for f in vectors)
            or p.corr_chol.shape != (a, a)):
        raise ValueError("the Heston arrays do not describe one universe")
    return p


def from_mcport(params) -> (GBMParams | CCCGarchParams | DCCGarchParams | MertonParams
                            | HestonParams | HedgeSpec | Legs):
    """The port's counterpart of mcport's ``GBMParams``, ``CCCGarchParams``,
    ``DCCGarchParams``, ``MertonParams``, ``HestonParams``, ``HedgeSpec`` or
    ``Legs``, told apart by a field only that type has: ``hedged_mask``
    (HedgeSpec, which shares ``type_id`` with Legs), ``type_id`` (Legs),
    ``a_dcc`` (DCC, whose ``base`` is converted as GARCH parameters),
    ``omega`` (GARCH), ``kappa`` (Heston), ``diffusion`` (Merton),
    ``mean_step`` (GBM). The option types keep their NumPy arrays, copied."""
    p = params
    if hasattr(p, "hedged_mask"):
        return HedgeSpec(*(np.array(getattr(p, f)) for f in
                           ("type_id", "strike", "premium", "qty", "hedged_mask")))
    if hasattr(p, "type_id"):
        return Legs(*(np.array(getattr(p, f)) for f in ("type_id", "strike", "premium", "qty")))
    if hasattr(p, "a_dcc"):
        return dcc_params_from_numpy(from_mcport(p.base), p.a_dcc, p.b_dcc, p.q0, p.e0)
    if hasattr(p, "omega"):
        return garch_params_from_numpy(p.mu, p.omega, p.alpha, p.beta, p.corr_chol,
                                       p.sigma2_0, p.eps2_0)
    if hasattr(p, "kappa"):
        return heston_params_from_numpy(p.mu, p.kappa, p.theta, p.xi, p.rho, p.v0,
                                        p.corr_chol, p.s0)
    if hasattr(p, "diffusion"):
        d = p.diffusion
        return merton_params_from_numpy(d.s0, d.mean_step, d.chol_step, p.jump_rate,
                                        p.jump_mean, p.jump_vol)
    if hasattr(p, "mean_step"):
        return gbm_params_from_numpy(p.s0, p.mean_step, p.chol_step)
    raise TypeError(f"no port counterpart for {type(p).__name__}")
