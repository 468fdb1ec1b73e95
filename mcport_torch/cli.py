"""Command-line interface of the port.

    python -m mcport_torch.cli gbm-risk       CSV [CSV ...] [--path-stats] [--hedge FILE] ...
    python -m mcport_torch.cli garch-risk     CSV [CSV ...] [--innovations student_t | --correlation dcc] ...
    python -m mcport_torch.cli bootstrap-risk CSV [CSV ...] [--p-restart 0.2] ...
    python -m mcport_torch.cli jump-risk      CSV [CSV ...] [--threshold 3.0] ...
    python -m mcport_torch.cli path-risk      CSV [CSV ...] [--models gbm,student_t,...] [--hedge FILE] ...
    python -m mcport_torch.cli dd-frontier    CSV [CSV ...] [--model gbm|garch|...] [--hedge FILE] ...
    python -m mcport_torch.cli compare-models CSV [CSV ...] ...
    python -m mcport_torch.cli hedged-risk    CSV [CSV ...] --hedge FILE [--models ...] ...

Each command takes the flags of its ``mcport`` counterpart that the port
carries, plus ``--device`` (the card by default; ``cpu`` runs the kernels'
plain torch forms, for tests), and emits the same JSON keys. CSVs are read
by :mod:`mcport_torch.data` (standard library and NumPy; no pandas). There is
no ``--no-pallas`` or ``--loader``: the plain forms are the kernels' test
yardsticks, not user paths on the card. ``--hedge FILE`` is mcport's JSON
hedge config (:func:`mcport_torch.options.hedged.legs_from_spec`), e.g.

    {"BTC": {"strategy": "Married Put"}, "ETH": {"strategy": "Collar"}}

Hedged ``path-risk`` and ``dd-frontier`` run for every family (against the
last prices). Not ported yet:
``--attribution`` and ``--ci`` (``hedged-risk --ci`` exits with a message).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from mcport_torch.config import Config, DataConfig, GBMConfig, SimulationConfig


def _round_paths(n: int, block: int = 8_192) -> int:
    """Round a user path count up to a whole number of engine blocks."""
    return -(-n // block) * block


def _universe(args):
    from mcport_torch.data import load_universe

    return load_universe(args.csv, DataConfig(period=args.period))


def _weights(args, d) -> np.ndarray:
    a = d.n_assets
    w = (np.full(a, 1.0 / a) if args.weights is None
         else np.asarray([float(x) for x in args.weights.split(",")]))
    if w.shape[0] != a:
        raise SystemExit(f"--weights needs {a} entries")
    return w


def _estimate(args, d):
    from mcport_torch.models.gbm import estimate_gbm

    return estimate_gbm(d.prices, estimator=args.estimator, ewma_lambda=args.ewma_lambda)


def _emit(obj) -> None:
    json.dump(obj, sys.stdout, indent=2, default=float)
    sys.stdout.write("\n")


def _hedge_from_args(args, d):
    """``(legs_by_asset, HedgeSpec)`` from ``--hedge FILE``, or ``(None,
    None)``: mcport's JSON schema, strategy strikes relative to each asset's
    last price (the reference's tab-1 convention, ``app.py:515-581``)."""
    path = getattr(args, "hedge", None)
    if not path:
        return None, None
    from pathlib import Path

    from mcport_torch.options.hedged import HedgeSpec, legs_from_spec

    try:
        spec_map = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise SystemExit(f"--hedge {path}: {e}")
    try:
        legs = legs_from_spec(spec_map, d.names, d.prices[-1])
        return legs, HedgeSpec.build(legs, d.names)
    except ValueError as e:
        raise SystemExit(f"--hedge {path}: {e}")


def cmd_gbm_risk(args) -> None:
    from mcport_torch.engine.mc_engine import load_checkpoint, run_resumable_mc
    from mcport_torch.models.gbm import estimate_t_dof

    d = _universe(args)
    params = _estimate(args, d)
    w = _weights(args, d)
    t_dof = 6.0
    if args.innovations == "student_t":
        t_dof = estimate_t_dof(d.prices)
        if args.fast_normal:
            print("mcport_torch: --fast-normal is ignored with student_t "
                  "innovations (the t sampler has its own polynomial "
                  "pipeline)", file=sys.stderr)
    block = min(args.paths, 8192)
    cfg = GBMConfig(n_paths=_round_paths(args.paths, block), n_steps=args.steps,
                    seed=args.seed, antithetic=args.antithetic, path_block=block,
                    innovations=args.innovations, t_dof=t_dof,
                    bm="poly_fast" if args.fast_normal else "poly")
    ck = load_checkpoint(args.checkpoint) if args.resume else None
    _, hedge = _hedge_from_args(args, d)
    report, ck_out = run_resumable_mc(
        params, w, cfg, alpha=args.alpha, checkpoint=ck,
        checkpoint_path=args.checkpoint, hedge=hedge, device=args.device)
    out = {
        "n_paths": report.n_paths,
        "horizon_steps": args.steps,
        "innovations": args.innovations
                       + (f" (dof={t_dof:.2f})" if args.innovations != "normal" else ""),
        "weights": dict(zip(d.names, map(float, w))),
        "var": report.var,
        "cvar": report.cvar,
        "portfolio_mean_return": report.port_mean,
        "terminal_log_mean": report.mean.tolist(),
        "done": ck_out.done,
    }
    if hedge is not None:
        out["hedged_assets"] = [n for n, m_ in zip(d.names, hedge.hedged_mask) if m_]
    if args.path_stats:
        from mcport_torch.engine.path_risk import run_path_risk

        pr = run_path_risk(params, w, cfg, alpha=args.alpha, hedge=hedge, device=args.device)
        out["max_drawdown"] = {
            "innovations": args.innovations,
            "mean": pr.dd_mean, "median": pr.dd_median, "p95_worst": pr.dd_p95,
        }
        if hedge is not None:
            out["max_drawdown"] = {"settlement": "per-period hedged", **out["max_drawdown"]}
    _emit(out)


def cmd_garch_risk(args) -> None:
    from mcport_torch.models.garch_mc import estimate_ccc_garch, garch_risk
    from mcport_torch.models.gbm import estimate_t_dof

    d = _universe(args)
    w = _weights(args, d)
    if args.correlation == "dcc":
        from mcport_torch.models.dcc import dcc_risk, estimate_dcc_garch

        if args.innovations != "normal":
            raise SystemExit("--correlation dcc supports normal shocks only")
        dp = estimate_dcc_garch(d.port_rets)
        r = dcc_risk(args.seed, dp, w, n_paths=args.paths, n_steps=args.steps,
                     alpha=args.alpha, device=args.device)
        _emit({
            "model": f"dcc-garch(1,1) a={float(dp.a_dcc):.3f} b={float(dp.b_dcc):.3f}",
            "n_paths": args.paths,
            "horizon_steps": args.steps,
            "weights": dict(zip(d.names, map(float, w))),
            "var": r.var, "cvar": r.cvar, "portfolio_mean_return": r.port_mean,
        })
        return
    params = estimate_ccc_garch(d.port_rets)
    t_df = estimate_t_dof(d.prices) if args.innovations == "student_t" else None
    r = garch_risk(args.seed, params, w, n_paths=args.paths, n_steps=args.steps,
                   alpha=args.alpha, t_df=t_df, device=args.device)
    _emit({
        "model": "ccc-garch(1,1)" + (f"-t(dof={t_df:.2f})" if t_df else ""),
        "n_paths": args.paths,
        "horizon_steps": args.steps,
        "weights": dict(zip(d.names, map(float, w))),
        "var": r.var,
        "cvar": r.cvar,
        "portfolio_mean_return": r.port_mean,
        "garch_alpha": params.alpha.tolist(),
        "garch_beta": params.beta.tolist(),
    })


def cmd_bootstrap_risk(args) -> None:
    from mcport_torch.models.bootstrap import bootstrap_risk

    d = _universe(args)
    w = _weights(args, d)
    out = bootstrap_risk(args.seed, d.port_rets, w, n_paths=args.paths, n_steps=args.steps,
                         p_restart=args.p_restart, alpha=args.alpha, device=args.device)
    _emit({
        "engine": "stationary-block-bootstrap",
        "n_paths": args.paths,
        "horizon_steps": args.steps,
        "expected_block_len": 1.0 / args.p_restart,
        "weights": dict(zip(d.names, map(float, w))),
        "var": out.var,
        "cvar": out.cvar,
        "portfolio_mean_return": out.port_mean,
        "asset_mean_terminal": dict(zip(d.names, map(float, out.mean))),
    })


def cmd_jump_risk(args) -> None:
    from mcport_torch.models.jump import estimate_merton_common, merton_risk

    d = _universe(args)
    params = estimate_merton_common(d.prices, threshold=args.threshold)
    w = _weights(args, d)
    out = merton_risk(args.seed, params, w, n_paths=args.paths, n_steps=args.steps,
                      alpha=args.alpha, device=args.device)
    _emit({
        "engine": "merton-common-jump",
        "n_paths": args.paths,
        "horizon_steps": args.steps,
        "calibration": {
            "jump_rate_per_step": params.jump_rate,
            "jump_mean": dict(zip(d.names, map(float, params.jump_mean))),
            "jump_vol": dict(zip(d.names, map(float, params.jump_vol))),
        },
        "weights": dict(zip(d.names, map(float, w))),
        "var": out.var,
        "cvar": out.cvar,
        "portfolio_mean_return": out.port_mean,
        "paths_with_jump_frac": out.jump_frac,
    })


def cmd_hedged_risk(args) -> None:
    from mcport_torch.api import hedged_tail_risk

    if args.ci:
        raise SystemExit("hedged-risk --ci: bootstrap error bars are not ported to "
                         "mcport_torch yet (ROADMAP.md Queue 1 item 4)")
    d = _universe(args)
    w = _weights(args, d)
    legs_by_asset, _ = _hedge_from_args(args, d)
    if legs_by_asset is None:
        raise SystemExit("hedged-risk requires --hedge FILE")
    cfg = Config(gbm=GBMConfig(n_paths=args.paths, n_steps=args.steps, seed=args.seed),
                 simulation=SimulationConfig(alpha=args.alpha))
    out = {"weights": dict(zip(d.names, map(float, w)))}
    for model in args.models.split(","):
        out[model] = hedged_tail_risk(d, w, cfg, legs_by_asset, model=model,
                                      device=args.device)
    _emit(out)


def cmd_path_risk(args) -> None:
    from mcport_torch.api import path_tail_risk

    d = _universe(args)
    w = _weights(args, d)
    legs_by_asset, hedge = _hedge_from_args(args, d)
    block = min(args.paths, 8192)
    cfg = Config(gbm=GBMConfig(n_paths=_round_paths(args.paths, block), n_steps=args.steps,
                               seed=args.seed, path_block=block,
                               bm="poly_fast" if args.fast_normal else "poly"),
                 simulation=SimulationConfig(alpha=args.alpha))
    rebalance = not args.buy_and_hold
    models = args.models.split(",")
    if args.checkpoint and len(models) != 1:
        raise SystemExit("--checkpoint requires a single --models entry")
    ck = None
    if args.resume:
        if not args.checkpoint:
            raise SystemExit("--resume requires --checkpoint FILE")
        from mcport_torch.engine.path_risk import load_path_risk_checkpoint

        ck = load_path_risk_checkpoint(args.checkpoint)
    out = {"weights": dict(zip(d.names, map(float, w))),
           "settlement": "per-period hedged" if hedge is not None else "unhedged",
           "rebalance_gbm": rebalance}
    for model in models:
        out[model] = path_tail_risk(
            d, w, cfg, model=model, legs_by_asset=legs_by_asset, p_restart=args.p_restart,
            rebalance=rebalance, checkpoint=ck, checkpoint_path=args.checkpoint or None,
            device=args.device)
    _emit(out)


def cmd_dd_frontier(args) -> None:
    from mcport_torch.engine.drawdown_frontier import (drawdown_frontier_search,
                                                       family_drawdown_frontier_search)
    from mcport_torch.models.gbm import estimate_t_dof

    d = _universe(args)
    _, hedge = _hedge_from_args(args, d)
    t_dof = None
    if args.model == "gbm":
        t_dof = estimate_t_dof(d.prices) if args.innovations == "student_t" else None
        r = drawdown_frontier_search(
            args.seed, _estimate(args, d), dd_budget=args.dd_budget,
            n_candidates=args.candidates, n_paths=args.paths, n_steps=args.steps,
            alpha=args.alpha, score_dtype=args.score_dtype, rebalance=args.rebalance,
            hedge=hedge, t_df=t_dof, bm="poly_fast" if args.fast_normal else "poly",
            device=args.device)
    else:
        if args.fast_normal:
            raise SystemExit("--fast-normal applies to --model gbm only")
        if args.model == "garch":
            from mcport_torch.models.garch_mc import estimate_ccc_garch

            model_params = estimate_ccc_garch(d.port_rets)
        elif args.model == "dcc":
            from mcport_torch.models.dcc import estimate_dcc_garch

            model_params = estimate_dcc_garch(d.port_rets)
        elif args.model == "jump":
            from mcport_torch.models.jump import estimate_merton_common

            model_params = estimate_merton_common(d.prices)
        elif args.model == "heston":
            from mcport_torch.models.heston import estimate_heston

            model_params = estimate_heston(d.prices)
        else:
            model_params = d.port_rets
        r = family_drawdown_frontier_search(
            args.seed, args.model, model_params, dd_budget=args.dd_budget,
            n_candidates=args.candidates, n_paths=args.paths, n_steps=args.steps,
            alpha=args.alpha, hedge=hedge,
            s0=None if hedge is None else np.asarray(d.prices[-1]), device=args.device)
    out = {
        "model": args.model,
        "dd_budget": r.dd_budget,
        "n_candidates": args.candidates,
        "n_feasible": int(r.feasible.sum()),
        "hedged": hedge is not None,
    }
    if t_dof is not None:
        out["innovations"] = f"student_t (dof={t_dof:.2f})"
    if r.opt_idx < 0:
        out["error"] = "no candidate satisfies the drawdown budget"
    else:
        i = r.opt_idx
        out["weights"] = dict(zip(d.names, map(float, r.opt_weights)))
        out["expected_return"] = float(r.ret[i])
        out["dd_p95"] = float(r.dd_p95[i])
    _emit(out)


def cmd_compare_models(args) -> None:
    from mcport_torch.api import compare_tail_risk

    d = _universe(args)
    w = _weights(args, d)
    block = min(args.paths, 8192)
    cfg = Config(gbm=GBMConfig(n_paths=_round_paths(args.paths, block), n_steps=args.steps,
                               seed=args.seed, path_block=block),
                 simulation=SimulationConfig(alpha=args.alpha))
    out = compare_tail_risk(d, w, cfg, device=args.device)
    _emit({
        "engine": "model-comparison",
        "n_paths": cfg.gbm.n_paths,
        "horizon_steps": args.steps,
        "weights": dict(zip(d.names, map(float, w))),
        "models": out,
    })


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mcport_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("csv", nargs="+",
                        help="asset CSV files (investing.com/yfinance format)")
        sp.add_argument("--period", default="M", choices=["M", "Q", "W", "D"],
                        help="analysis period (resample rule)")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--alpha", type=float, default=0.95)
        sp.add_argument("--device", default="cuda",
                        help="torch device: cuda[:N] (default) or cpu (the "
                             "kernels' plain torch forms, for tests)")

    def hedge_arg(sp, required: str = ""):
        sp.add_argument("--hedge", default=None, metavar="FILE",
                        help=f"JSON hedge config{required}: {{asset: {{strategy, params}} "
                             "| {legs}}")

    def estimator(sp):
        sp.add_argument("--estimator", default="sample", choices=["sample", "lw", "ewma"],
                        help="covariance tier: reference sample (ddof=1) | "
                             "Ledoit-Wolf shrinkage | RiskMetrics EWMA")
        sp.add_argument("--ewma-lambda", type=float, default=0.94,
                        help="EWMA decay (only with --estimator ewma)")

    sp = sub.add_parser("gbm-risk", help="correlated-GBM tail risk")
    common(sp)
    sp.add_argument("--paths", type=int, default=100_000)
    sp.add_argument("--steps", type=int, default=252)
    sp.add_argument("--weights", default=None, help="comma list; default equal")
    sp.add_argument("--antithetic", action="store_true")
    sp.add_argument("--innovations", default="normal", choices=["normal", "student_t"],
                    help="student_t fits dof by method of moments (fat tails)")
    sp.add_argument("--fast-normal", action="store_true",
                    help="screening-tier normal draws (degree-5 polynomial "
                         "Box-Muller, draw error <=~1e-5)")
    sp.add_argument("--checkpoint", default=None, help="npz checkpoint path")
    sp.add_argument("--resume", action="store_true", help="resume from --checkpoint")
    sp.add_argument("--path-stats", action="store_true",
                    help="add the simulated max-drawdown distribution (buy-and-hold, "
                         "same paths, seed and innovations; hedged: per-period settled)")
    hedge_arg(sp)
    estimator(sp)
    sp.set_defaults(fn=cmd_gbm_risk)

    sp = sub.add_parser("garch-risk",
                        help="tail risk under CCC-GARCH(1,1) stochastic volatility")
    common(sp)
    sp.add_argument("--innovations", default="normal", choices=["normal", "student_t"],
                    help="student_t = GARCH-t (moment-fitted dof)")
    sp.add_argument("--correlation", default="ccc", choices=["ccc", "dcc"],
                    help="dcc = dynamic conditional correlations (DCC-GARCH, "
                         "normal shocks)")
    sp.add_argument("--paths", type=int, default=100_000)
    sp.add_argument("--steps", type=int, default=52)
    sp.add_argument("--weights", default=None, help="comma list; default equal")
    sp.set_defaults(fn=cmd_garch_risk)

    sp = sub.add_parser("bootstrap-risk",
                        help="distribution-free tail risk from resampled historical paths")
    common(sp)
    sp.add_argument("--weights", default=None, help="comma-separated, default equal")
    sp.add_argument("--paths", type=int, default=100_000)
    sp.add_argument("--steps", type=int, default=52)
    sp.add_argument("--p-restart", type=float, default=0.2,
                    help="block restart probability (expected block len = 1/p)")
    sp.set_defaults(fn=cmd_bootstrap_risk)

    sp = sub.add_parser("jump-risk",
                        help="Merton systemic-jump tail risk (threshold-calibrated)")
    common(sp)
    sp.add_argument("--weights", default=None, help="comma-separated, default equal")
    sp.add_argument("--paths", type=int, default=262_144)
    sp.add_argument("--steps", type=int, default=52)
    sp.add_argument("--threshold", type=float, default=3.0,
                    help="systemic-jump z-score threshold (cross-sectional median)")
    sp.set_defaults(fn=cmd_jump_risk)

    sp = sub.add_parser("path-risk",
                        help="per-period path risk (terminal VaR/CVaR + "
                             "max-drawdown distribution)")
    common(sp)
    sp.add_argument("--models", default="gbm,student_t,garch,dcc,jump,heston,bootstrap",
                    help="comma list of gbm,student_t,garch,dcc,jump,heston,bootstrap")
    sp.add_argument("--weights", default=None, help="comma list; default equal")
    sp.add_argument("--paths", type=int, default=65_536)
    sp.add_argument("--steps", type=int, default=52)
    sp.add_argument("--p-restart", type=float, default=0.2,
                    help="bootstrap restart probability (1/expected block len)")
    sp.add_argument("--buy-and-hold", action="store_true",
                    help="buy-and-hold GBM wealth instead of the default "
                         "per-period rebalancing (the other families always "
                         "rebalance)")
    sp.add_argument("--checkpoint", default=None, metavar="FILE",
                    help="persist block-cursor state after every dispatch group "
                         "(single --models entry only; resumed runs are "
                         "bit-identical to unsplit ones)")
    sp.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint FILE")
    sp.add_argument("--fast-normal", action="store_true",
                    help="screening-tier normal draws (degree-5 polynomial "
                         "Box-Muller; student_t has its own sampler and ignores it)")
    hedge_arg(sp)
    sp.set_defaults(fn=cmd_path_risk)

    sp = sub.add_parser("dd-frontier",
                        help="max return s.t. a simulated max-drawdown budget")
    common(sp)
    sp.add_argument("--dd-budget", type=float, default=0.30,
                    help="p95-worst drawdown budget (0.30 = -30%%)")
    sp.add_argument("--candidates", type=int, default=8192)
    sp.add_argument("--paths", type=int, default=16_384)
    sp.add_argument("--steps", type=int, default=252)
    sp.add_argument("--score-dtype",
                    choices=["auto", "float32", "tensorfloat32", "bfloat16"],
                    default="auto",
                    help="candidate-scoring tier: auto (default) is float32; "
                         "tensorfloat32 is mcport's bf16 split (~1.5e-5); "
                         "bfloat16 screens, then rescores the leaders at "
                         "float32")
    sp.add_argument("--rebalance", action="store_true",
                    help="rebalance candidates to target weights every period "
                         "instead of buy-and-hold")
    sp.add_argument("--model", choices=["gbm", "garch", "dcc", "jump", "heston",
                                        "bootstrap"], default="gbm",
                    help="path family")
    sp.add_argument("--innovations", choices=["normal", "student_t"], default="normal",
                    help="student_t scores candidates under fat-tailed "
                         "unit-variance t shocks (moment-fitted dof)")
    sp.add_argument("--fast-normal", action="store_true",
                    help="screening-tier normal draws for screen AND rescore")
    hedge_arg(sp)
    estimator(sp)
    sp.set_defaults(fn=cmd_dd_frontier)

    sp = sub.add_parser("compare-models",
                        help="one portfolio, every tail-risk model family")
    common(sp)
    sp.add_argument("--weights", default=None, help="comma-separated, default equal")
    sp.add_argument("--paths", type=int, default=262_144)
    sp.add_argument("--steps", type=int, default=52)
    sp.set_defaults(fn=cmd_compare_models)

    sp = sub.add_parser("hedged-risk",
                        help="hedged tail risk across model families (options settle "
                             "against simulated terminal prices)")
    common(sp)
    hedge_arg(sp, " (required)")
    sp.add_argument("--models", default="gbm,student_t,garch,dcc,jump,heston,bootstrap",
                    help="comma list of gbm,student_t,garch,dcc,jump,heston,bootstrap")
    sp.add_argument("--weights", default=None, help="comma list; default equal")
    sp.add_argument("--paths", type=int, default=100_000)
    sp.add_argument("--steps", type=int, default=52)
    sp.add_argument("--ci", type=int, nargs="?", const=200, default=0, metavar="B",
                    help="bootstrap error bars on var/cvar: not ported (exits)")
    sp.set_defaults(fn=cmd_hedged_risk)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
