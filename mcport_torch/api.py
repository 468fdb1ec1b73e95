"""Top-level API of the port: ``gbm_risk``, ``path_tail_risk``,
``hedged_tail_risk``, ``bootstrap_tail_risk`` and ``compare_tail_risk``.

Ports of the single-device, pseudo-random branches of ``mcport.api.gbm_risk``
(correlated-GBM tail risk for one portfolio through the chunked, resumable
engine, hedged or not), of ``mcport.api.path_tail_risk`` for all seven
families (terminal VaR/CVaR plus the simulated max-drawdown distribution,
hedged or not), of ``mcport.api.hedged_tail_risk`` (option legs settled
against every family's terminal prices), of ``mcport.api.bootstrap_tail_risk``
and of ``mcport.api.compare_tail_risk`` (one portfolio under every family).
The mesh and quasi-MC branches and bootstrap error bars are not ported yet
and raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from mcport_torch.config import COVERING_LOG1P_SKETCH, Config
from mcport_torch.device import resolve_device
from mcport_torch.engine.mc_engine import MCCheckpoint, RiskReport, run_resumable_mc
from mcport_torch.engine.path_risk import (
    FAMILIES,
    PathRiskCheckpoint,
    run_bootstrap_path_risk,
    run_dcc_path_risk,
    run_garch_path_risk,
    run_heston_path_risk,
    run_merton_path_risk,
    run_path_risk,
    run_resumable_path_risk,
)
from mcport_torch.models.bootstrap import BootstrapRisk, bootstrap_risk
from mcport_torch.models.dcc import dcc_risk, estimate_dcc_garch
from mcport_torch.models.garch_mc import estimate_ccc_garch, garch_risk
from mcport_torch.models.gbm import GBMParams, estimate_gbm, estimate_t_dof
from mcport_torch.models.heston import estimate_heston, heston_terminal_returns
from mcport_torch.models.jump import estimate_merton_common, merton_risk, merton_terminal_returns
from mcport_torch.ops.bootstrap import bootstrap_terminal
from mcport_torch.ops.dcc import dcc_terminal
from mcport_torch.ops.garch import garch_terminal
from mcport_torch.ops.gbm import terminal_log_returns
from mcport_torch.ops.quantile import histogram, sketch_var_cvar
from mcport_torch.options.hedged import HedgeSpec, hedged_from_simple

__all__ = ["gbm_risk", "path_tail_risk", "hedged_tail_risk", "bootstrap_tail_risk",
           "compare_tail_risk", "Config"]


def gbm_risk(
    data,
    weights: Sequence[float] | np.ndarray | torch.Tensor | None = None,
    config: Config = Config(),
    mesh=None,
    checkpoint: MCCheckpoint | None = None,
    checkpoint_path=None,
    legs_by_asset=None,
    *,
    device: str | torch.device = "cuda",
) -> RiskReport:
    """Correlated-GBM tail risk for one portfolio on ``device``.

    ``data`` is a :class:`GBMParams` or a :class:`mcport_torch.data.PriceData`
    (anything with a ``prices`` (T, A) matrix), estimated with the sample
    estimator.
    ``weights`` default to equal weights. ``config.gbm`` sets paths, steps,
    seed, block size, antithetic draws and innovations; ``config.simulation
    .alpha`` the tail level; ``config.gbm.auto_sketch=False`` uses
    ``config.sketch`` verbatim. ``checkpoint``/``checkpoint_path`` resume and
    save as in :func:`mcport_torch.engine.mc_engine.run_resumable_mc`.

    ``legs_by_asset`` ({asset name or index: Legs or reference-style rows})
    makes the PORTFOLIO tail statistics hedged: the legs settle at intrinsic
    value against the simulated terminal prices (the terminal composition of
    ``app.py:164-180``); the asset moments stay the plain log-return moments.
    """
    g = config.gbm
    if mesh is not None:
        raise NotImplementedError("multi-device gbm_risk is not ported to mcport_torch yet")
    if g.qmc != "none":
        raise NotImplementedError("quasi-MC gbm_risk is not ported to mcport_torch yet")
    params = data if isinstance(data, GBMParams) else estimate_gbm(data.prices)
    a = params.n_assets
    w = (np.full(a, 1.0 / a) if weights is None
         else np.asarray(torch.as_tensor(weights).cpu(), np.float64))
    if w.shape != (a,):
        raise ValueError(f"weights must have shape ({a},)")
    hedge = None
    if legs_by_asset:
        names = getattr(data, "names", None) or [f"asset{i}" for i in range(a)]
        hedge = HedgeSpec.build(legs_by_asset, names)
    sketch = None if g.auto_sketch else config.sketch
    report, _ = run_resumable_mc(
        params, w, g, sketch, alpha=config.simulation.alpha,
        checkpoint=checkpoint, checkpoint_path=checkpoint_path, hedge=hedge, device=device)
    return report


def path_tail_risk(
    data,
    weights: Sequence[float] | np.ndarray | None = None,
    config: Config = Config(),
    model: str = "gbm",
    legs_by_asset=None,
    p_restart: float = 0.2,
    rebalance: bool = True,
    checkpoint: PathRiskCheckpoint | None = None,
    checkpoint_path=None,
    max_blocks: int | None = None,
    *,
    device: str | torch.device = "cuda",
) -> dict:
    """Per-period path risk for one portfolio on ``device``: terminal
    VaR/CVaR plus the simulated max-drawdown distribution →
    ``{var, cvar, port_mean, dd_mean, dd_median, dd_p95, model, n_paths}``.

    ``data`` is a :class:`mcport_torch.data.PriceData` (``names``, a (T, A)
    ``prices`` matrix and its ``port_rets``). ``model`` "gbm" is correlated
    log-normal; "student_t" keeps its drift and covariance with unit-variance
    Student-t shocks at the moment-fitted dof (reported as ``t_dof``);
    "garch" fits CCC-GARCH(1,1) to ``port_rets``, "dcc" DCC-GARCH(1,1);
    "jump" calibrates the common-jump Merton model to ``prices`` (threshold
    3); "heston" fits the Heston model to ``prices`` (the QMLE);
    "bootstrap" resamples ``port_rets`` with restart probability
    ``p_restart``. ``rebalance`` selects per-step
    rebalancing (default) or buy-and-hold for the GBM families; every other
    family's wealth is always rebalanced.
    ``checkpoint`` / ``checkpoint_path`` / ``max_blocks`` route through
    :func:`mcport_torch.engine.path_risk.run_resumable_path_risk`
    (bit-identical to the one-shot engines) and add a ``done`` flag.

    ``legs_by_asset`` settles every asset's option legs per simulated step
    against the prices from the last row of ``prices`` (hedged per-step
    settlement, the rebalanced recursion ``V *= 1 + w·r_h``; ``rebalance`` is
    not read) and adds ``hedged_assets``, for every family.
    """
    if model not in FAMILIES:
        raise ValueError(f"model must be 'gbm', 'student_t', 'garch', 'dcc', 'jump', "
                         f"'heston' or 'bootstrap', got {model!r}")
    spec = None if legs_by_asset is None else HedgeSpec.build(legs_by_asset, data.names)
    a = len(data.names)
    w = np.full(a, 1.0 / a) if weights is None else np.asarray(weights, np.float64)
    if w.shape != (a,):
        raise ValueError(f"weights must have shape ({a},)")
    g = config.gbm
    alpha = config.simulation.alpha
    if model in ("gbm", "student_t"):
        params = estimate_gbm(data.prices)
        if model == "student_t":
            g = dataclasses.replace(g, innovations="student_t",
                                    t_dof=estimate_t_dof(data.prices))
    elif model == "garch":
        params = estimate_ccc_garch(data.port_rets)
    elif model == "dcc":
        params = estimate_dcc_garch(data.port_rets)
    elif model == "jump":
        params = estimate_merton_common(data.prices)
    elif model == "heston":
        params = estimate_heston(data.prices)
    else:
        params = data.port_rets
    resumable = (checkpoint is not None or checkpoint_path is not None
                 or max_blocks is not None)
    if resumable:
        rep, ck = run_resumable_path_risk(
            model, params, w, g, alpha=alpha, hedge=spec,
            s0=None if spec is None else np.asarray(data.prices[-1], np.float64),
            p_restart=p_restart, rebalance=rebalance, checkpoint=checkpoint,
            checkpoint_path=checkpoint_path, max_blocks=max_blocks, device=device)
    elif model == "garch":
        rep = run_garch_path_risk(params, w, g, alpha=alpha, hedge=spec,
                                  s0=None if spec is None else np.asarray(data.prices[-1]),
                                  device=device)
    elif model == "dcc":
        rep = run_dcc_path_risk(params, w, g, alpha=alpha, hedge=spec,
                                s0=None if spec is None else np.asarray(data.prices[-1]),
                                device=device)
    elif model == "jump":
        rep = run_merton_path_risk(params, w, g, alpha=alpha, hedge=spec, device=device)
    elif model == "heston":
        rep = run_heston_path_risk(params, w, g, alpha=alpha, hedge=spec, device=device)
    elif model == "bootstrap":
        rep = run_bootstrap_path_risk(params, w, g, p_restart=p_restart, alpha=alpha,
                                      hedge=spec,
                                      s0=None if spec is None else np.asarray(data.prices[-1]),
                                      device=device)
    else:
        rep = run_path_risk(params, w, g, alpha=alpha, rebalance=rebalance, hedge=spec,
                            device=device)
    out = {
        "var": rep.var, "cvar": rep.cvar, "port_mean": rep.port_mean,
        "dd_mean": rep.dd_mean, "dd_median": rep.dd_median,
        "dd_p95": rep.dd_p95, "model": model, "n_paths": rep.n_paths,
    }
    if resumable:
        out["done"] = ck.done
    if model == "student_t":
        out["t_dof"] = g.t_dof
    if spec is not None:
        out["hedged_assets"] = [n for n, m_ in zip(data.names, spec.hedged_mask) if m_]
    return out


def _family_terminal_simple(data, model: str, g, dev: torch.device) -> torch.Tensor:
    """(n_paths, A) terminal SIMPLE returns under ``model``, one block keyed by
    ``g.seed`` — mcport's ``_family_terminal_simple`` on the port's terminal
    kernels: the terminal-noise kernel (gbm, student_t), the GARCH, DCC,
    Heston and bootstrap terminal kernels, and the exact Merton sampler."""
    seed, n, steps = g.seed, g.n_paths, g.n_steps
    if model in ("gbm", "student_t"):
        params = estimate_gbm(data.prices)
        mean, chol = (torch.as_tensor(x).to(dev, torch.float32)
                      for x in (params.mean_step, params.chol_step))
        t_df = estimate_t_dof(data.prices) if model == "student_t" else None
        return torch.expm1(terminal_log_returns(seed, mean, chol, n, steps, t_df=t_df))
    if model == "garch":
        return garch_terminal(seed, estimate_ccc_garch(data.port_rets).tensors(dev), n,
                              steps)[0]
    if model == "dcc":
        return dcc_terminal(seed, estimate_dcc_garch(data.port_rets).tensors(dev), n,
                            steps)[0]
    if model == "jump":
        mp = estimate_merton_common(data.prices)
        d = mp.diffusion
        return torch.expm1(merton_terminal_returns(seed, d.mean_step, d.chol_step,
                                                   mp.jump_rate, mp.jump_mean, mp.jump_vol,
                                                   n, steps, device=dev))
    if model == "heston":
        return heston_terminal_returns(seed, estimate_heston(data.prices), n, steps,
                                       device=dev)
    if model == "bootstrap":
        hist = torch.as_tensor(np.asarray(data.port_rets, np.float32), device=dev)
        return bootstrap_terminal(seed, hist, n, steps)[0]
    raise ValueError(f"model must be 'gbm', 'student_t', 'garch', 'dcc', 'jump', 'heston' "
                     f"or 'bootstrap', got {model!r}")


def hedged_tail_risk(
    data,
    weights: Sequence[float] | np.ndarray | None = None,
    config: Config = Config(),
    legs_by_asset=None,
    model: str = "gbm",
    *,
    device: str | torch.device = "cuda",
) -> dict:
    """Hedged portfolio tail risk under any terminal model family, on
    ``device`` → ``{var, cvar, port_mean, model, n_paths, hedged_assets}``.

    Draws ``(n_paths, A)`` terminal simple returns under ``model`` ("gbm",
    "student_t", "garch", "dcc", "jump", "heston", "bootstrap"; estimated from
    ``data`` as :func:`path_tail_risk` does), settles each asset's option legs
    at intrinsic value against the implied terminal price ``s0 · (1 + r)``
    with ``s0`` the last row of ``prices`` (:func:`mcport_torch.options.hedged
    .hedged_from_simple`), and reports the exact k-worst tail of the hedged
    portfolio: ``k = ceil((1 - alpha) n_paths)``, VaR the k-th worst return,
    CVaR the mean of the k worst. Bootstrap error bars (``config.gbm.ci_boot
    > 0``) are not ported and raise."""
    g = config.gbm
    if g.ci_boot > 0:
        raise NotImplementedError("bootstrap error bars (ci_boot > 0) are not ported to "
                                  "mcport_torch yet")
    dev = resolve_device(device)
    a = len(data.names)
    w = np.full(a, 1.0 / a) if weights is None else np.asarray(weights, np.float64)
    spec = HedgeSpec.build(legs_by_asset, data.names)
    s0 = torch.as_tensor(np.asarray(data.prices[-1], np.float64), device=dev)
    simple = _family_terminal_simple(data, model, g, dev)
    hedged = hedged_from_simple(simple, s0, *spec.tensors(dev, torch.float64))
    port = hedged @ torch.as_tensor(w, device=dev).to(hedged.dtype)
    k = max(1, math.ceil((1.0 - config.simulation.alpha) * g.n_paths))
    worst = torch.topk(-port, k).values
    return {
        "var": float(-worst[-1]),
        "cvar": float(-worst.mean()),
        "port_mean": float(port.mean()),
        "model": model,
        "n_paths": g.n_paths,
        "hedged_assets": [n for n, m_ in zip(data.names, spec.hedged_mask) if m_],
    }


def bootstrap_tail_risk(
    data,
    weights: Sequence[float] | np.ndarray | None = None,
    config: Config = Config(),
    p_restart: float = 0.2,
    *,
    device: str | torch.device = "cuda",
) -> BootstrapRisk:
    """Distribution-free tail risk by stationary block bootstrap over the
    assembled historical returns ``data.port_rets``, on ``device``
    (:func:`mcport_torch.models.bootstrap.bootstrap_risk`, seeded
    ``config.gbm.seed``)."""
    a = len(data.names)
    w = np.full(a, 1.0 / a) if weights is None else np.asarray(weights, np.float64)
    g = config.gbm
    return bootstrap_risk(g.seed, data.port_rets, w, n_paths=g.n_paths, n_steps=g.n_steps,
                          p_restart=p_restart, alpha=config.simulation.alpha, device=device)


def compare_tail_risk(
    data,
    weights: Sequence[float] | np.ndarray | None = None,
    config: Config = Config(),
    *,
    device: str | torch.device = "cuda",
) -> dict[str, dict[str, float]]:
    """One portfolio under every model family on ``device`` → ``{model: {var,
    cvar, portfolio_mean, ...}}``: GBM with normal and with Student-t shocks
    (moment-fitted dof, ``t_dof``), CCC-GARCH, DCC-GARCH (``a_dcc``,
    ``b_dcc``), common-jump Merton (``jump_rate_per_step``), Heston
    (``mean_kappa``, ``mean_xi``) and the stationary block bootstrap, on the
    same universe, weights, path count and horizon (``config.gbm``) and tail
    level (``config.simulation.alpha``) — mcport's risk-model sensitivity
    view.

    As mcport does, a GARCH, DCC or Heston fit that fails on a degenerate
    series is reported as ``{"error": ...}`` and the others go on; only the
    estimation is guarded, so a kernel that fails to build or launch raises.
    """
    a = len(data.names)
    w = np.full(a, 1.0 / a) if weights is None else np.asarray(weights, np.float64)
    g = config.gbm
    alpha = config.simulation.alpha
    n, steps, seed = g.n_paths, g.n_steps, g.seed
    params = estimate_gbm(data.prices)
    out: dict[str, dict[str, float]] = {}

    def pack(var, cvar, mean):
        return {"var": float(var), "cvar": float(cvar), "portfolio_mean": float(mean)}

    r = gbm_risk(params, w, config, device=device)
    out["gbm_normal"] = pack(r.var, r.cvar, r.port_mean)
    t_cfg = dataclasses.replace(g, innovations="student_t", t_dof=estimate_t_dof(data.prices))
    r = gbm_risk(params, w, dataclasses.replace(config, gbm=t_cfg), device=device)
    out["gbm_student_t"] = pack(r.var, r.cvar, r.port_mean)
    out["gbm_student_t"]["t_dof"] = t_cfg.t_dof

    # each `try` holds the estimation alone: what runs on the card propagates
    try:
        gp = estimate_ccc_garch(data.port_rets)
    except Exception as e:  # degenerate series can break the MLE; keep going
        out["ccc_garch"] = {"error": str(e)}
    else:
        r = garch_risk(seed, gp, w, n_paths=n, n_steps=steps, alpha=alpha, device=device)
        out["ccc_garch"] = pack(r.var, r.cvar, r.port_mean)

    try:
        dp = estimate_dcc_garch(data.port_rets)
    except Exception as e:
        out["dcc_garch"] = {"error": str(e)}
    else:
        r = dcc_risk(seed, dp, w, n_paths=n, n_steps=steps, alpha=alpha, device=device)
        out["dcc_garch"] = pack(r.var, r.cvar, r.port_mean)
        out["dcc_garch"]["a_dcc"] = float(dp.a_dcc)
        out["dcc_garch"]["b_dcc"] = float(dp.b_dcc)

    jp = estimate_merton_common(data.prices)
    r = merton_risk(seed, jp, w, n_paths=n, n_steps=steps, alpha=alpha, device=device)
    out["merton_jump"] = pack(r.var, r.cvar, r.port_mean)
    out["merton_jump"]["jump_rate_per_step"] = jp.jump_rate

    try:
        hp = estimate_heston(data.prices)
    except Exception as e:
        out["heston"] = {"error": str(e)}
    else:
        term = heston_terminal_returns(seed, hp, n, steps, device=device)
        port = term @ torch.as_tensor(w, device=term.device).to(term.dtype)
        v, c = sketch_var_cvar(histogram(port, COVERING_LOG1P_SKETCH), alpha,
                               COVERING_LOG1P_SKETCH)
        out["heston"] = pack(v, c, port.mean())
        out["heston"]["mean_kappa"] = float(hp.kappa.mean())
        out["heston"]["mean_xi"] = float(hp.xi.mean())

    r = bootstrap_tail_risk(data, w, config, device=device)
    out["block_bootstrap"] = pack(r.var, r.cvar, r.port_mean)
    return out
