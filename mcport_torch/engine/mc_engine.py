"""Chunked, checkpointable Monte Carlo risk engine (one device).

Port of ``run_resumable_mc`` and its checkpoint from
``mcport/engine/mc_engine.py``. The engine is a deterministic function of
(parameters, weights, seed, grid): block ``b`` always draws the Philox stream
keyed ``int32(seed + (b+1) * SEED_STRIDE)``, blocks fold into the accumulators
left to right, and a checkpoint is ``(next_block, moments, histogram)``. A run
split by ``max_blocks`` and resumed is bit-identical to the one-shot run.

A dispatch group of ``DISPATCH_BLOCKS`` blocks is one launch of the
terminal-noise kernel; the blocks of the group then fold one by one, each on
freshly allocated tensors of the same shape, so results do not depend on how
blocks were grouped. The histogram counts are int64.

The run digest carries the backend tag ``torch-philox``: the port and mcport
draw different streams, so neither resumes the other's checkpoint.

``hedge`` (a :class:`mcport_torch.options.hedged.HedgeSpec`) settles the
portfolio's option legs at intrinsic value against the simulated terminal
prices ``s0 · exp(term)`` (mcport's terminal composition, an elementwise
transform after the kernel); the asset moments stay the plain log-return
moments. The hedge's bytes and the spots enter the run digest.

Not ported yet (raise ``NotImplementedError``): bootstrap error bars
(``ci_boot > 0``) and ``run_resumable_mc_with_recovery``.
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
from mcport_torch.models.gbm import GBMParams, portfolio_terminal_returns
from mcport_torch.ops.gbm import block_terminal_log_returns
from mcport_torch.options.hedged import auto_hedged_sketch, hedged_terminal_returns
from mcport_torch.ops.quantile import (
    MomentState,
    auto_sketch,
    finalize_moments,
    histogram,
    sketch_var_cvar,
    update_moments,
)

__all__ = ["BACKEND_TAG", "DISPATCH_BLOCKS", "MCCheckpoint", "RiskReport",
           "run_resumable_mc", "run_resumable_mc_with_recovery", "load_checkpoint"]

BACKEND_TAG = "torch-philox"

#: blocks per kernel launch; grouping never changes results
DISPATCH_BLOCKS = 16


def _host_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.ascontiguousarray(np.asarray(x, np.float64))


def _run_digest(params: GBMParams, weights, config: GBMConfig, hedge=None) -> str:
    """Binds a checkpoint to its computation: parameters, weights, seed, grid,
    sampler tier, the hedge (mcport's ``hedge|`` bytes, then the spots it
    settles against) and the backend. Resuming anything else is refused."""
    h = hashlib.sha256()
    for arr in (params.mean_step, params.chol_step, weights):
        h.update(_host_f64(arr).tobytes())
    h.update(f"{config.seed}|{config.n_steps}|{config.n_paths}|"
             f"{config.path_block}|{config.antithetic}|"
             f"{config.innovations}|{config.t_dof}".encode())
    if config.bm != "poly" and config.innovations != "student_t":
        h.update(f"|bm={config.bm}".encode())
    if hedge is not None:
        h.update(b"hedge|" + hedge.digest_bytes())
        h.update(_host_f64(params.s0).tobytes())
    h.update(f"|backend={BACKEND_TAG}".encode())
    return h.hexdigest()


@dataclass
class MCCheckpoint:
    """Serializable engine state; ``next_block`` is the resume cursor.

    ``sum_c``/``outer_c`` are the Neumaier compensation terms, ``shift`` the
    drift centring of every sample, ``hist`` the int64 sketch counts; the
    sketch geometry is stored so a resume rebuilds the same bins.
    """

    seed: int
    n_steps: int
    block_paths: int
    n_blocks: int
    next_block: int
    count: np.ndarray
    sum: np.ndarray
    sum_c: np.ndarray
    outer: np.ndarray
    outer_c: np.ndarray
    shift: np.ndarray
    hist: np.ndarray
    port_sum: np.ndarray
    sketch_lo: float
    sketch_hi: float
    sketch_space: str
    antithetic: bool = False
    digest: str = ""

    def save(self, path: str | Path) -> None:
        np.savez(path, **{f.name: getattr(self, f.name)
                          for f in dataclasses.fields(self)})

    @property
    def done(self) -> bool:
        return self.next_block >= self.n_blocks

    @property
    def sketch(self) -> SketchConfig:
        return SketchConfig(n_bins=int(np.asarray(self.hist).shape[-1]),
                            lo=float(self.sketch_lo), hi=float(self.sketch_hi),
                            space=str(self.sketch_space))


def load_checkpoint(path: str | Path) -> MCCheckpoint:
    with np.load(path) as z:
        fields = {f.name for f in dataclasses.fields(MCCheckpoint)}
        missing = fields - set(z.files)
        if missing:
            raise ValueError(f"checkpoint {path} lacks fields {sorted(missing)}; "
                             "it was not written by this engine")
        return MCCheckpoint(
            seed=int(z["seed"]), n_steps=int(z["n_steps"]),
            block_paths=int(z["block_paths"]), n_blocks=int(z["n_blocks"]),
            next_block=int(z["next_block"]),
            count=z["count"].astype(np.int64), sum=z["sum"], sum_c=z["sum_c"],
            outer=z["outer"], outer_c=z["outer_c"], shift=z["shift"],
            hist=z["hist"].astype(np.int64), port_sum=z["port_sum"],
            sketch_lo=float(z["sketch_lo"]), sketch_hi=float(z["sketch_hi"]),
            sketch_space=str(z["sketch_space"]), antithetic=bool(z["antithetic"]),
            digest=str(z["digest"]),
        )


@dataclass(frozen=True)
class RiskReport:
    """Final risk statistics of a (possibly multi-session) run."""

    mean: np.ndarray    # (A,) terminal log-return mean
    cov: np.ndarray     # (A, A)
    var: float          # portfolio VaR at alpha (simple-return units)
    cvar: float
    port_mean: float
    n_paths: int


def run_resumable_mc(
    params: GBMParams,
    weights,
    config: GBMConfig = GBMConfig(),
    sketch: SketchConfig | None = None,
    alpha: float = 0.95,
    checkpoint: MCCheckpoint | None = None,
    max_blocks: int | None = None,
    checkpoint_path: str | Path | None = None,
    hedge=None,
    *,
    device: str | torch.device = "cuda",
) -> tuple[RiskReport, MCCheckpoint]:
    """Run (or resume) a chunked MC risk computation on ``device``.

    ``sketch=None`` derives the covering log1p sketch from the parameters
    (:func:`mcport_torch.ops.quantile.auto_sketch`), or hedged the exact
    linear one (:func:`mcport_torch.options.hedged.auto_hedged_sketch`); a
    resumed run reuses the checkpoint's. ``hedge`` makes the portfolio's tail
    statistics hedged (the module docstring). ``max_blocks`` bounds this
    call's work; pass the returned checkpoint (or its saved file) to
    continue. ``DISPATCH_BLOCKS`` blocks go
    to the device in one kernel launch; grouping never changes results.
    ``config.use_pallas`` is not read: on a CUDA device the kernel always
    runs, on the CPU its plain torch form.
    """
    if config.ci_boot > 0:
        raise NotImplementedError("bootstrap error bars (ci_boot > 0) are not "
                                  "ported to mcport_torch yet")
    dev = resolve_device(device)
    a = params.n_assets
    block_paths = config.path_block
    if config.n_paths % block_paths:
        raise ValueError(f"n_paths {config.n_paths} not divisible by path_block {block_paths}")
    n_blocks = config.n_paths // block_paths
    t_df = config.t_dof if config.innovations == "student_t" else None

    digest = _run_digest(params, weights, config, hedge)
    if checkpoint is None:
        if sketch is None and hedge is not None:
            w_np = _host_f64(weights)
            sketch = auto_hedged_sketch(params, config.n_steps, hedge,
                                        weights=w_np if (w_np >= 0).all() else None,
                                        t_dof=t_df)
        elif sketch is None:
            sketch = auto_sketch(params.mean_step, params.chol_step, config.n_steps,
                                 t_dof=t_df)
        ck = MCCheckpoint(
            seed=config.seed, n_steps=config.n_steps, block_paths=block_paths,
            n_blocks=n_blocks, next_block=0, count=np.zeros((), np.int64),
            sum=np.zeros(a), sum_c=np.zeros(a), outer=np.zeros((a, a)),
            outer_c=np.zeros((a, a)),
            shift=config.n_steps * _host_f64(params.mean_step),
            hist=np.zeros(sketch.n_bins, np.int64), port_sum=np.zeros(()),
            sketch_lo=sketch.lo, sketch_hi=sketch.hi, sketch_space=sketch.space,
            antithetic=config.antithetic, digest=digest,
        )
    else:
        ck = checkpoint
        if (ck.n_steps, ck.block_paths, ck.n_blocks) != (config.n_steps, block_paths, n_blocks):
            raise ValueError("checkpoint is for a different run configuration")
        if ck.digest != digest:
            raise ValueError(
                "checkpoint was written for different parameters/weights/seed or "
                "by another backend (digest mismatch) — refusing to resume a "
                "different computation")
        if sketch is None:
            sketch = ck.sketch
        elif sketch != ck.sketch:
            raise ValueError("sketch config conflicts with the checkpoint's stored sketch")

    dtype = getattr(torch, config.dtype)

    def on_dev(x, dt=dtype):
        return torch.as_tensor(_host_f64(x) if dt.is_floating_point else x,
                               device=dev).to(dt)

    mean_step, chol_step = on_dev(params.mean_step), on_dev(params.chol_step)
    w, shift = on_dev(weights), on_dev(ck.shift)
    moments = MomentState(on_dev(np.asarray(ck.count), torch.int64), on_dev(ck.sum),
                          on_dev(ck.sum_c), on_dev(ck.outer), on_dev(ck.outer_c))
    hist = on_dev(np.asarray(ck.hist), torch.int64)
    port_sum = on_dev(ck.port_sum)
    if hedge is not None:
        s0, legs = on_dev(params.s0), hedge.tensors(dev, torch.float64)

    start = ck.next_block
    stop = n_blocks if max_blocks is None else min(n_blocks, start + max_blocks)
    b = start
    while b < stop:
        group = min(DISPATCH_BLOCKS, stop - b)
        terms = block_terminal_log_returns(
            ck.seed, mean_step, chol_step, block_paths, config.n_steps,
            first_block=b, n_blocks=group, antithetic=config.antithetic,
            t_df=t_df, bm=config.bm)
        for term in terms.to(dtype):
            if hedge is not None:   # the legs settle against s0 · exp(term)
                port = hedged_terminal_returns(term, s0, *legs) @ w
            else:
                port = portfolio_terminal_returns(term, w)
            moments = update_moments(moments, term, shift=shift)
            hist = hist + histogram(port, sketch)
            port_sum = port_sum + port.sum()
        b += group

    ck = MCCheckpoint(
        seed=ck.seed, n_steps=ck.n_steps, block_paths=block_paths, n_blocks=n_blocks,
        next_block=stop, count=moments.count.cpu().numpy(),
        sum=moments.sum.cpu().numpy(), sum_c=moments.sum_c.cpu().numpy(),
        outer=moments.outer.cpu().numpy(), outer_c=moments.outer_c.cpu().numpy(),
        shift=np.asarray(ck.shift), hist=hist.cpu().numpy(),
        port_sum=port_sum.cpu().numpy(), sketch_lo=sketch.lo, sketch_hi=sketch.hi,
        sketch_space=sketch.space, antithetic=ck.antithetic, digest=digest,
    )
    if checkpoint_path is not None:
        ck.save(checkpoint_path)

    n_done = int(ck.count) or 1
    mean, cov = finalize_moments(moments, shift=shift)
    v, c = sketch_var_cvar(hist, alpha, sketch, dtype=dtype)
    report = RiskReport(mean=mean.cpu().numpy(), cov=cov.cpu().numpy(), var=float(v),
                        cvar=float(c), port_mean=float(port_sum) / n_done,
                        n_paths=int(ck.count))
    return report, ck


def run_resumable_mc_with_recovery(*args, **kwargs):
    """Not ported: mcport's in-process recovery reloads the last checkpoint
    after a device error, but a CUDA fault is sticky for the process, so the
    port needs a different (process-level) design."""
    raise NotImplementedError("run_resumable_mc_with_recovery is not ported to "
                              "mcport_torch yet")
