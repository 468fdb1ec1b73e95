"""Top-level API of the port: ``gbm_risk``.

Port of the single-device, pseudo-random branch of ``mcport.api.gbm_risk``:
correlated-GBM tail risk for one portfolio through the chunked, resumable
engine. The mesh, quasi-MC and hedged branches are not ported yet and raise.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from mcport.config import Config
from mcport_torch.engine.mc_engine import MCCheckpoint, RiskReport, run_resumable_mc
from mcport_torch.models.gbm import GBMParams, estimate_gbm

__all__ = ["gbm_risk", "Config"]


def gbm_risk(
    data,
    weights: Sequence[float] | np.ndarray | torch.Tensor | None = None,
    config: Config = Config(),
    mesh=None,
    checkpoint: MCCheckpoint | None = None,
    checkpoint_path=None,
    legs_by_asset=None,
    *,
    device: str | torch.device,
) -> RiskReport:
    """Correlated-GBM tail risk for one portfolio on ``device``.

    ``data`` is a :class:`GBMParams` or an ``mcport.data.PriceData`` (anything
    with a ``prices`` (T, A) matrix), estimated with the sample estimator.
    ``weights`` default to equal weights. ``config.gbm`` sets paths, steps,
    seed, block size, antithetic draws and innovations; ``config.simulation
    .alpha`` the tail level; ``config.gbm.auto_sketch=False`` uses
    ``config.sketch`` verbatim. ``checkpoint``/``checkpoint_path`` resume and
    save as in :func:`mcport_torch.engine.mc_engine.run_resumable_mc`.
    """
    g = config.gbm
    if mesh is not None:
        raise NotImplementedError("multi-device gbm_risk is not ported to mcport_torch yet")
    if legs_by_asset:
        raise NotImplementedError("hedged gbm_risk is not ported to mcport_torch yet")
    if g.qmc != "none":
        raise NotImplementedError("quasi-MC gbm_risk is not ported to mcport_torch yet")
    params = data if isinstance(data, GBMParams) else estimate_gbm(data.prices)
    a = params.n_assets
    w = (np.full(a, 1.0 / a) if weights is None
         else np.asarray(torch.as_tensor(weights).cpu(), np.float64))
    if w.shape != (a,):
        raise ValueError(f"weights must have shape ({a},)")
    sketch = None if g.auto_sketch else config.sketch
    report, _ = run_resumable_mc(
        params, w, g, sketch, alpha=config.simulation.alpha,
        checkpoint=checkpoint, checkpoint_path=checkpoint_path, device=device)
    return report
