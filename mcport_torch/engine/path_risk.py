"""Path-dependent risk: the max-drawdown distribution of a portfolio under
GBM, CCC-GARCH, DCC-GARCH, common-jump Merton, Heston and stationary-bootstrap
paths.

Port of ``mcport/engine/path_risk.py``: every family, unhedged and with
hedged per-step settlement. Each family has a
block function (mcport's ``_block_fn_for``) that evolves every path of
a dispatch group on its kernel and returns the portfolio's terminal return
and maximum drawdown per path:

- "gbm" and "student_t": the path-stats kernel
  (:func:`mcport_torch.ops.path_stats.gbm_path_stats`; :func:`stats_from_log_paths`,
  mcport's ``_stats_from_log_paths``, is the same reduction on materialised
  log paths);
- "garch": the GARCH candidate kernel with one candidate
  (:func:`mcport_torch.ops.garch.garch_multi_portfolio_dd`);
- "dcc": the DCC candidate kernel with one candidate
  (:func:`mcport_torch.ops.dcc.dcc_multi_portfolio_dd`);
- "jump": the Merton candidate kernel with one candidate
  (:func:`mcport_torch.ops.jump.merton_multi_portfolio_dd`);
- "heston": the Heston candidate kernel with one candidate
  (:func:`mcport_torch.ops.heston.heston_multi_portfolio_dd`);
- "bootstrap": the bootstrap candidate kernel with one candidate
  (:func:`mcport_torch.ops.bootstrap.bootstrap_multi_portfolio_dd`).

The engine folds them block by block into two int64 histogram sketches
(terminal return for VaR/CVaR, drawdown for its quantiles) and two sums, on
the device, without a host synchronisation per block.

Like the terminal engine (:mod:`mcport_torch.engine.mc_engine`), the result is
a deterministic function of (family, parameters, weights, seed, grid): block
``b`` draws the Philox stream keyed ``int32(seed + (b+1) * SEED_STRIDE)``, a
dispatch group of ``DISPATCH_BLOCKS`` blocks is one kernel launch, and the
blocks fold left to right, so a run split by ``max_blocks`` and resumed is
bit-identical to the one-shot run. The checkpoint digest binds the family and
its arrays and carries the backend tag ``torch-philox``: another family's or
mcport's checkpoints are refused.

Rebalancing follows mcport: :func:`run_path_risk` holds the initial GBM
allocation (buy-and-hold) by default, :func:`run_resumable_path_risk`
rebalances every step, and the GARCH, DCC, jump, Heston and bootstrap
families always compound per-period rebalanced wealth.
The bootstrap's default terminal sketch is the covering log1p range of its
history.

``hedge`` (a :class:`mcport_torch.options.hedged.HedgeSpec`) settles the
option legs at intrinsic value every simulated step against the prices from
the spots ``s0`` and compounds ``V *= 1 + w·r_h`` (mcport's hedged branches):
"gbm" and "student_t" score the one portfolio on the multi-dd kernel's hedged
mode, "jump", "garch", "dcc", "heston" and "bootstrap" on their candidate
kernels' (the spots default to the model's own for "gbm", "student_t", "jump"
and "heston"; the GARCH, DCC and bootstrap families carry none: ``s0`` is
required, as in mcport). The hedge's bytes and the spots enter the checkpoint
digest.

Not ported yet (raise ``NotImplementedError``): quasi-MC paths (``qmc``),
bootstrap error bars (``ci_boot``) and
``run_resumable_path_risk_with_recovery``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from mcport_torch.config import GBMConfig, SketchConfig
from mcport_torch.device import resolve_device
from mcport_torch.engine.mc_engine import BACKEND_TAG
from mcport_torch.models.bootstrap import _auto_sketch_from_history
from mcport_torch.models.dcc import DCCGarchParams
from mcport_torch.models.garch_mc import CCCGarchParams
from mcport_torch.models.gbm import GBMParams
from mcport_torch.models.heston import HestonParams
from mcport_torch.models.jump import MertonParams
from mcport_torch.ops.bootstrap import bootstrap_multi_portfolio_dd
from mcport_torch.ops.dcc import dcc_multi_portfolio_dd
from mcport_torch.ops.garch import garch_multi_portfolio_dd
from mcport_torch.ops.heston import heston_multi_portfolio_dd
from mcport_torch.ops.jump import merton_multi_portfolio_dd
from mcport_torch.ops.hedged import HedgeTensors
from mcport_torch.ops.multi_dd import gbm_multi_portfolio_dd, multi_dd_from_log_paths
from mcport_torch.ops.path_stats import gbm_path_stats
from mcport_torch.ops.quantile import histogram, sketch_quantile, sketch_var_cvar

__all__ = ["DD_SKETCH", "DISPATCH_BLOCKS", "FAMILIES", "PathRiskReport", "PathRiskCheckpoint",
           "run_path_risk", "run_garch_path_risk", "run_dcc_path_risk", "run_merton_path_risk",
           "run_heston_path_risk", "run_bootstrap_path_risk", "run_resumable_path_risk",
           "run_resumable_path_risk_with_recovery", "load_path_risk_checkpoint",
           "stats_from_log_paths"]

# drawdowns live in [-1, 0]; a dedicated tight sketch keeps quantile error tiny
DD_SKETCH = SketchConfig(n_bins=4096, lo=-1.0, hi=0.0)

#: blocks per kernel launch; grouping never changes results
DISPATCH_BLOCKS = 16

#: mcport's path families
FAMILIES = ("gbm", "student_t", "garch", "dcc", "jump", "heston", "bootstrap")


@dataclass(frozen=True)
class PathRiskReport:
    var: float            # terminal portfolio VaR at alpha
    cvar: float
    port_mean: float
    dd_mean: float        # mean max drawdown (negative)
    dd_p95: float         # (1 - alpha)-quantile of the max drawdown: the worse tail
    dd_median: float
    n_paths: int
    tail_ci: dict | None = None   # bootstrap error bars: not ported, always None


@dataclass
class PathRiskCheckpoint:
    """Resumable path-risk state: the two int64 sketches, the two sums and
    the block cursor ``next_block``."""

    seed: int
    n_steps: int
    block_paths: int
    n_blocks: int
    next_block: int
    h_port: np.ndarray
    h_dd: np.ndarray
    s_port: np.ndarray
    s_dd: np.ndarray
    sketch_lo: float
    sketch_hi: float
    sketch_space: str
    dd_lo: float
    dd_hi: float
    digest: str = ""

    def save(self, path: str | Path) -> None:
        np.savez(path, **{f.name: getattr(self, f.name)
                          for f in dataclasses.fields(self)})

    @property
    def done(self) -> bool:
        return self.next_block >= self.n_blocks

    @property
    def sketch(self) -> SketchConfig:
        return SketchConfig(n_bins=int(np.asarray(self.h_port).shape[-1]),
                            lo=float(self.sketch_lo), hi=float(self.sketch_hi),
                            space=str(self.sketch_space))

    @property
    def dd_sketch(self) -> SketchConfig:
        return SketchConfig(n_bins=int(np.asarray(self.h_dd).shape[-1]),
                            lo=float(self.dd_lo), hi=float(self.dd_hi))


def load_path_risk_checkpoint(path: str | Path) -> PathRiskCheckpoint:
    with np.load(path) as z:
        names = [f.name for f in dataclasses.fields(PathRiskCheckpoint)]
        missing = set(names) - set(z.files)
        if missing:
            raise ValueError(f"checkpoint {path} lacks fields {sorted(missing)}; "
                             "it was not written by this engine")
        kw = {k: z[k] for k in names}
    for k in ("seed", "n_steps", "block_paths", "n_blocks", "next_block"):
        kw[k] = int(kw[k])
    for k in ("sketch_lo", "sketch_hi", "dd_lo", "dd_hi"):
        kw[k] = float(kw[k])
    kw["sketch_space"], kw["digest"] = str(kw["sketch_space"]), str(kw["digest"])
    kw["h_port"], kw["h_dd"] = kw["h_port"].astype(np.int64), kw["h_dd"].astype(np.int64)
    return PathRiskCheckpoint(**kw)


def _host_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.ascontiguousarray(np.asarray(x, np.float64))


def _digest(model: str, model_params, weights, config: GBMConfig, rebalance: bool,
            p_restart: float, hedge=None, s0=None) -> str:
    """Binds a checkpoint to its computation: family, its parameter arrays,
    weights, the spots, seed, grid, shock law, rebalancing, normal tier, the
    hedge and the backend (mcport's ``_model_digest`` fields, with the port's
    stream tag)."""
    h = hashlib.sha256(model.encode())
    if model in ("gbm", "student_t"):
        arrays = (model_params.mean_step, model_params.chol_step, model_params.s0)
    elif model == "garch":
        p = model_params
        arrays = (p.mu, p.omega, p.alpha, p.beta, p.corr_chol, p.sigma2_0, p.eps2_0)
    elif model == "dcc":
        p, b = model_params, model_params.base
        arrays = (b.mu, b.omega, b.alpha, b.beta, b.corr_chol, b.sigma2_0, b.eps2_0, p.q0,
                  p.e0, [float(p.a_dcc), float(p.b_dcc)])
    elif model == "jump":
        p = model_params
        arrays = (p.diffusion.mean_step, p.diffusion.chol_step, [p.jump_rate], p.jump_mean,
                  p.jump_vol)
    elif model == "heston":
        p = model_params
        arrays = (p.mu, p.kappa, p.theta, p.xi, p.rho, p.v0, p.corr_chol, p.s0)
    else:
        arrays = (model_params, [p_restart])
    for arr in (*arrays, weights) + (() if s0 is None else (s0,)):
        h.update(_host_f64(arr).tobytes())
    h.update(f"{config.seed}|{config.n_steps}|{config.n_paths}|{config.path_block}|"
             f"{config.innovations}|{config.t_dof}|{rebalance}|{BACKEND_TAG}".encode())
    t_active = config.innovations == "student_t" or model == "student_t"
    if config.bm != "poly" and not t_active:
        h.update(f"|bm={config.bm}".encode())
    if hedge is not None:
        h.update(b"hedge|" + hedge.digest_bytes())
    return h.hexdigest()


def _require_spots(hedge, s0, model: str) -> None:
    """Hedged GARCH, DCC and bootstrap runs settle against spots the model
    does not carry: raise without them, as mcport does."""
    if hedge is not None and s0 is None:
        raise ValueError(f"hedged {model} path risk requires s0 (asset prices)")


def _check_unported(config: GBMConfig) -> None:
    if config.qmc != "none":
        raise NotImplementedError("quasi-MC path risk is not ported to mcport_torch yet")
    if config.ci_boot > 0:
        raise NotImplementedError("bootstrap error bars (ci_boot > 0) are not ported "
                                  "to mcport_torch yet")


def _report(h_port, h_dd, s_port, s_dd, n_done: int, alpha: float,
            sketch: SketchConfig, dd_sketch: SketchConfig, dtype) -> PathRiskReport:
    v, c = sketch_var_cvar(h_port, alpha, sketch, dtype=dtype)
    dd_p95 = sketch_quantile(h_dd, 1.0 - alpha, dd_sketch, dtype=dtype)
    dd_med = sketch_quantile(h_dd, 0.5, dd_sketch, dtype=dtype)
    n = max(n_done, 1)
    return PathRiskReport(var=float(v), cvar=float(c), port_mean=float(s_port) / n,
                          dd_mean=float(s_dd) / n, dd_p95=float(dd_p95),
                          dd_median=float(dd_med), n_paths=n_done)


def stats_from_log_paths(paths: torch.Tensor, weights: torch.Tensor,
                         rebalance: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(portfolio terminal return, max drawdown) of one portfolio ``weights
    (A,)`` from ``(..., n, T, A)`` cumulative log paths → two ``(..., n)``
    tensors: mcport's ``_stats_from_log_paths``, which is
    :func:`multi_dd_from_log_paths` with one candidate."""
    port, dd = multi_dd_from_log_paths(paths, weights[None], rebalance)
    return port[..., 0, :], dd[..., 0, :]


def _block_fn(model: str, model_params, weights, config: GBMConfig, rebalance: bool,
              p_restart: float, dev: torch.device, hedge=None, s0=None):
    """``(block_fn, default_sketch)`` for ``model`` — mcport's
    ``_block_fn_for``. ``block_fn(first_block, n_blocks)`` launches one
    dispatch group and returns ``(port, dd)``, each ``(n_blocks,
    path_block)``. ``hedge`` with the spots ``s0``: hedged per-step
    settlement."""
    w = torch.as_tensor(_host_f64(weights), device=dev).to(torch.float32)
    n, steps, seed = config.path_block, config.n_steps, config.seed
    legs = None if hedge is None else HedgeTensors.from_spec(hedge, _host_f64(s0), dev)
    if model in ("gbm", "student_t"):
        mean = torch.as_tensor(_host_f64(model_params.mean_step), device=dev).to(torch.float32)
        chol = torch.as_tensor(_host_f64(model_params.chol_step), device=dev).to(torch.float32)
        t_df = (float(config.t_dof)
                if config.innovations == "student_t" or model == "student_t" else None)
        if legs is not None:   # one candidate on the multi-dd kernel's hedged mode
            def block_fn(b, group):
                term, dd = gbm_multi_portfolio_dd(seed, mean, chol, w[None], n, steps,
                                                  first_block=b, n_blocks=group, t_df=t_df,
                                                  bm=config.bm, hedge=legs)
                return term[:, 0], dd[:, 0]

            return block_fn, SketchConfig()

        def block_fn(b, group):
            _, port, dd = gbm_path_stats(seed, mean, chol, w, n, steps, first_block=b,
                                         n_blocks=group, rebalance=rebalance, t_df=t_df,
                                         bm=config.bm, terminal=False)
            return port, dd

        return block_fn, SketchConfig()
    if model == "garch":
        g = model_params.tensors(dev)

        def block_fn(b, group):
            term, dd = garch_multi_portfolio_dd(seed, g, w[None], n, steps, first_block=b,
                                                n_blocks=group, hedge=legs)
            return term[:, 0], dd[:, 0]

        return block_fn, SketchConfig()
    if model == "dcc":
        dt = model_params.tensors(dev)

        def block_fn(b, group):
            term, dd = dcc_multi_portfolio_dd(seed, dt, w[None], n, steps, first_block=b,
                                              n_blocks=group, hedge=legs)
            return term[:, 0], dd[:, 0]

        return block_fn, SketchConfig()
    if model == "jump":
        d = model_params.diffusion
        mean, chol, muj, sigj = (torch.as_tensor(_host_f64(x), device=dev).to(torch.float32)
                                 for x in (d.mean_step, d.chol_step, model_params.jump_mean,
                                           model_params.jump_vol))

        def block_fn(b, group):
            term, dd = merton_multi_portfolio_dd(seed, mean, chol, model_params.jump_rate, muj,
                                                 sigj, w[None], n, steps, first_block=b,
                                                 n_blocks=group, hedge=legs)
            return term[:, 0], dd[:, 0]

        return block_fn, SketchConfig()
    if model == "heston":
        h = model_params.tensors(dev)

        def block_fn(b, group):
            term, dd = heston_multi_portfolio_dd(seed, h, w[None], n, steps, first_block=b,
                                                 n_blocks=group, hedge=legs)
            return term[:, 0], dd[:, 0]

        return block_fn, SketchConfig()
    hist = torch.as_tensor(_host_f64(model_params), device=dev).to(torch.float32)

    def block_fn(b, group):
        term, dd = bootstrap_multi_portfolio_dd(seed, hist, w[None], n, steps, p_restart,
                                                first_block=b, n_blocks=group, hedge=legs)
        return term[:, 0], dd[:, 0]

    if legs is not None:   # settlement is not bounded by the history's rows (mcport's rule)
        return block_fn, SketchConfig()
    return block_fn, _auto_sketch_from_history(_host_f64(model_params), steps)


def _fold(state, block_fn, config: GBMConfig, sketch: SketchConfig,
          dd_sketch: SketchConfig, start: int, stop: int, on_group=None):
    """Fold blocks ``start .. stop-1`` into ``state = (h_port, h_dd, s_port,
    s_dd)`` (device tensors); ``on_group(next_block, state)`` runs after each
    dispatch group."""
    dtype = getattr(torch, config.dtype)
    h_port, h_dd, s_port, s_dd = state
    b = start
    while b < stop:
        group = min(DISPATCH_BLOCKS, stop - b)
        port, dd = block_fn(b, group)
        for pb, db in zip(port.to(dtype), dd.to(dtype)):
            h_port = h_port + histogram(pb, sketch)
            h_dd = h_dd + histogram(db, dd_sketch)
            s_port = s_port + pb.sum()
            s_dd = s_dd + db.sum()
        b += group
        if on_group is not None:
            on_group(b, (h_port, h_dd, s_port, s_dd))
    return h_port, h_dd, s_port, s_dd


def _empty_state(sketch: SketchConfig, dd_sketch: SketchConfig, dtype, dev):
    return (torch.zeros(sketch.n_bins, dtype=torch.int64, device=dev),
            torch.zeros(dd_sketch.n_bins, dtype=torch.int64, device=dev),
            torch.zeros((), dtype=dtype, device=dev),
            torch.zeros((), dtype=dtype, device=dev))


def _n_blocks(config: GBMConfig) -> int:
    if config.n_paths % config.path_block:
        raise ValueError(f"n_paths {config.n_paths} not divisible by path_block "
                         f"{config.path_block}")
    return config.n_paths // config.path_block


def _one_shot(model, model_params, weights, config: GBMConfig, sketch, dd_sketch,
              alpha: float, rebalance: bool, p_restart: float, device, hedge=None,
              s0=None) -> PathRiskReport:
    n_blocks = _n_blocks(config)
    dev = resolve_device(device)
    dtype = getattr(torch, config.dtype)
    block_fn, default_sketch = _block_fn(model, model_params, weights, config, rebalance,
                                         p_restart, dev, hedge, s0)
    sketch = default_sketch if sketch is None else sketch
    state = _fold(_empty_state(sketch, dd_sketch, dtype, dev), block_fn, config, sketch,
                  dd_sketch, 0, n_blocks)
    return _report(*state, config.n_paths, alpha, sketch, dd_sketch, dtype)


def run_path_risk(
    params: GBMParams,
    weights,
    config: GBMConfig = GBMConfig(),
    sketch: SketchConfig = SketchConfig(),
    dd_sketch: SketchConfig = DD_SKETCH,
    alpha: float = 0.95,
    rebalance: bool = False,
    hedge=None,
    *,
    device: str | torch.device = "cuda",
) -> PathRiskReport:
    """Simulated path risk for one portfolio on ``device``: terminal VaR/CVaR
    plus the max-drawdown distribution (mean, median, ``(1 - alpha)``
    quantile).

    ``rebalance=True`` resets to the target weights every step; False is
    buy-and-hold. ``config.innovations="student_t"`` draws unit-variance
    Student-t shocks at ``config.t_dof``; ``config.bm`` picks the normal tier.
    ``hedge`` (a HedgeSpec) settles the option legs every step against the
    prices from ``params.s0`` (the rebalanced recursion ``V *= 1 + w·r_h``;
    ``rebalance`` is not read).
    """
    _check_unported(config)
    return _one_shot("gbm", params, weights, config, sketch, dd_sketch, alpha, rebalance,
                     0.2, device, hedge, None if hedge is None else params.s0)


def run_garch_path_risk(
    params: CCCGarchParams,
    weights,
    config: GBMConfig = GBMConfig(),
    sketch: SketchConfig = SketchConfig(),
    dd_sketch: SketchConfig = DD_SKETCH,
    alpha: float = 0.95,
    hedge=None,
    s0=None,
    *,
    device: str | torch.device = "cuda",
) -> PathRiskReport:
    """Simulated path risk under CCC-GARCH(1,1) paths on ``device``: terminal
    VaR/CVaR plus the max-drawdown distribution of one portfolio compounding
    per-period rebalanced wealth. Normal shocks, as mcport's (the config's
    innovations enter only the checkpoint digest). ``hedge`` (a HedgeSpec)
    settles the option legs every step against the prices ``P *= 1 + mu +
    eps`` from the spots ``s0``, which it requires, as mcport does."""
    _check_unported(config)
    _require_spots(hedge, s0, "garch")
    return _one_shot("garch", params, weights, config, sketch, dd_sketch, alpha, True,
                     0.2, device, hedge, s0)


def run_dcc_path_risk(
    params: DCCGarchParams,
    weights,
    config: GBMConfig = GBMConfig(),
    sketch: SketchConfig = SketchConfig(),
    dd_sketch: SketchConfig = DD_SKETCH,
    alpha: float = 0.95,
    hedge=None,
    s0=None,
    *,
    device: str | torch.device = "cuda",
) -> PathRiskReport:
    """Simulated path risk under DCC-GARCH(1,1) paths on ``device``: terminal
    VaR/CVaR plus the max-drawdown distribution of one portfolio compounding
    per-period rebalanced wealth, under correlations that rise in stress.
    ``hedge`` (a HedgeSpec) settles the option legs every step against the
    prices ``P *= 1 + mu + eps`` from the spots ``s0``, which it requires, as
    mcport does."""
    _check_unported(config)
    _require_spots(hedge, s0, "dcc")
    return _one_shot("dcc", params, weights, config, sketch, dd_sketch, alpha, True, 0.2,
                     device, hedge, s0)


def run_merton_path_risk(
    params: MertonParams,
    weights,
    config: GBMConfig = GBMConfig(),
    sketch: SketchConfig = SketchConfig(),
    dd_sketch: SketchConfig = DD_SKETCH,
    alpha: float = 0.95,
    hedge=None,
    *,
    device: str | torch.device = "cuda",
) -> PathRiskReport:
    """Simulated path risk under common-jump Merton paths on ``device``:
    terminal VaR/CVaR plus the max-drawdown distribution of one portfolio
    compounding per-period rebalanced wealth ``V *= w'exp(x)``, with the
    per-step Bernoulli systemic jump clock (:mod:`mcport_torch.ops.jump`).
    ``hedge`` settles the option legs every step against the prices from
    ``params.diffusion.s0`` (``V *= 1 + w·r_h``)."""
    _check_unported(config)
    return _one_shot("jump", params, weights, config, sketch, dd_sketch, alpha, True, 0.2,
                     device, hedge, None if hedge is None else params.diffusion.s0)


def run_heston_path_risk(
    params: HestonParams,
    weights,
    config: GBMConfig = GBMConfig(),
    sketch: SketchConfig = SketchConfig(),
    dd_sketch: SketchConfig = DD_SKETCH,
    alpha: float = 0.95,
    hedge=None,
    s0=None,
    *,
    device: str | torch.device = "cuda",
) -> PathRiskReport:
    """Simulated path risk under Heston stochastic-volatility paths on
    ``device``: terminal VaR/CVaR plus the max-drawdown distribution of one
    portfolio compounding per-period rebalanced wealth ``V *= w'exp(x)``.
    ``hedge`` (a HedgeSpec) settles the option legs every step against the
    prices ``P *= exp(x)`` from the spots ``s0``, by default ``params.s0``
    (mcport's default), and compounds ``V *= 1 + w·r_h``."""
    _check_unported(config)
    if hedge is not None and s0 is None:
        s0 = params.s0
    return _one_shot("heston", params, weights, config, sketch, dd_sketch, alpha, True, 0.2,
                     device, hedge, s0)


def run_bootstrap_path_risk(
    returns,
    weights,
    config: GBMConfig = GBMConfig(),
    p_restart: float = 0.2,
    sketch: SketchConfig | None = None,
    dd_sketch: SketchConfig = DD_SKETCH,
    alpha: float = 0.95,
    hedge=None,
    s0=None,
    *,
    device: str | torch.device = "cuda",
) -> PathRiskReport:
    """Simulated path risk under stationary-bootstrap resampling of the (T,
    A) history ``returns`` on ``device``: terminal VaR/CVaR plus the
    max-drawdown distribution of one portfolio compounding per-period
    rebalanced wealth. ``sketch=None`` derives the covering log1p terminal
    sketch of the history (valid for any simplex weights; hedged runs take
    the default linear sketch, as mcport's, since settlement is not bounded
    by the history's rows). ``hedge`` (a HedgeSpec) settles the option legs
    every step against the prices ``P *= 1 + row`` from the spots ``s0``,
    which it requires, as mcport does."""
    _check_unported(config)
    _require_spots(hedge, s0, "bootstrap")
    return _one_shot("bootstrap", returns, weights, config, sketch, dd_sketch, alpha, True,
                     p_restart, device, hedge, s0)


def run_resumable_path_risk(
    model: str,
    model_params,
    weights,
    config: GBMConfig = GBMConfig(),
    sketch: SketchConfig | None = None,
    dd_sketch: SketchConfig = DD_SKETCH,
    alpha: float = 0.95,
    hedge=None,
    s0=None,
    p_restart: float = 0.2,
    rebalance: bool = True,
    checkpoint: PathRiskCheckpoint | None = None,
    checkpoint_path: str | Path | None = None,
    max_blocks: int | None = None,
    *,
    device: str | torch.device = "cuda",
) -> tuple[PathRiskReport, PathRiskCheckpoint]:
    """Checkpointable path risk for ``model``: "gbm", "student_t" (GBM drift
    and covariance with unit-variance t shocks at ``config.t_dof``), "garch"
    (``model_params`` a :class:`CCCGarchParams`), "dcc" (a
    :class:`DCCGarchParams`), "jump" (a :class:`MertonParams`), "heston" (a
    :class:`HestonParams`) or "bootstrap" (``model_params`` the (T, A)
    history, ``p_restart`` its restart probability); every family but GBM's
    is rebalanced every step.

    Returns ``(report, checkpoint)``; the report covers the blocks folded so
    far (check ``checkpoint.done``). ``max_blocks`` bounds this call's work;
    ``checkpoint_path`` persists the state after every dispatch group. The
    digest binds a checkpoint to its computation and a mismatched resume
    raises. ``hedge`` (a HedgeSpec) settles the option legs every step
    against the spots ``s0`` (by default the model's own: ``model_params.s0``
    for "gbm", "student_t" and "heston", or ``.diffusion.s0`` for "jump";
    "garch", "dcc" and "bootstrap" carry none and require ``s0``, as mcport
    does).
    """
    if model not in FAMILIES:
        raise ValueError(f"model must be 'gbm', 'student_t', 'garch', 'dcc', 'jump', "
                         f"'heston' or 'bootstrap', got {model!r}")
    _check_unported(config)
    if hedge is not None and s0 is None:
        if model not in ("gbm", "student_t", "jump", "heston"):
            _require_spots(hedge, s0, model)
        s0 = (model_params.diffusion.s0 if model == "jump" else model_params.s0)
    n_blocks = _n_blocks(config)
    dev = resolve_device(device)
    dtype = getattr(torch, config.dtype)
    digest = _digest(model, model_params, weights, config, rebalance, p_restart, hedge, s0)
    block_fn, default_sketch = _block_fn(model, model_params, weights, config, rebalance,
                                         p_restart, dev, hedge, s0)

    if checkpoint is not None:
        if (checkpoint.n_steps, checkpoint.block_paths, checkpoint.n_blocks) != (
                config.n_steps, config.path_block, n_blocks):
            raise ValueError("checkpoint is for a different run configuration")
        if checkpoint.digest != digest:
            raise ValueError(
                "checkpoint digest mismatch: this checkpoint was written for a "
                "different computation (family/params/weights/config) or by another "
                "backend — refusing to resume it")
        sketch, dd_sketch = checkpoint.sketch, checkpoint.dd_sketch
        state = (torch.as_tensor(checkpoint.h_port, device=dev),
                 torch.as_tensor(checkpoint.h_dd, device=dev),
                 torch.as_tensor(checkpoint.s_port, device=dev).to(dtype),
                 torch.as_tensor(checkpoint.s_dd, device=dev).to(dtype))
        start = checkpoint.next_block
    else:
        sketch = default_sketch if sketch is None else sketch
        state = _empty_state(sketch, dd_sketch, dtype, dev)
        start = 0
    stop = n_blocks if max_blocks is None else min(n_blocks, start + max_blocks)

    def snapshot(next_block, st) -> PathRiskCheckpoint:
        h_port, h_dd, s_port, s_dd = (x.cpu().numpy() for x in st)
        return PathRiskCheckpoint(
            seed=config.seed, n_steps=config.n_steps, block_paths=config.path_block,
            n_blocks=n_blocks, next_block=next_block, h_port=h_port, h_dd=h_dd,
            s_port=s_port, s_dd=s_dd, sketch_lo=sketch.lo, sketch_hi=sketch.hi,
            sketch_space=sketch.space, dd_lo=dd_sketch.lo, dd_hi=dd_sketch.hi,
            digest=digest)

    def persist(next_block, st) -> None:
        snapshot(next_block, st).save(checkpoint_path)

    state = _fold(state, block_fn, config, sketch, dd_sketch, start, stop,
                  on_group=persist if checkpoint_path is not None else None)
    ck = snapshot(stop, state)
    report = _report(*state, stop * config.path_block, alpha, sketch, dd_sketch, dtype)
    return report, ck


def run_resumable_path_risk_with_recovery(*args, **kwargs):
    """Not ported: mcport reloads the last checkpoint in-process after a
    device error, but a CUDA fault is sticky for the process, so the port
    needs a process-level design."""
    raise NotImplementedError("run_resumable_path_risk_with_recovery is not ported "
                              "to mcport_torch yet")
