"""Command-line interface of the port.

    python -m mcport_torch.cli gbm-risk CSV [CSV ...] [--device cuda] ...

``gbm-risk`` takes the flags of ``mcport gbm-risk`` that the port carries
(csv, --period, --estimator, --ewma-lambda, --paths, --steps, --seed,
--alpha, --weights, --antithetic, --innovations, --fast-normal,
--checkpoint, --resume) plus ``--device``, and emits the same JSON keys.
There is no ``--no-pallas``: the plain torch sampler is the kernel's test
yardstick, not a user path on the card. ``--hedge``, ``--path-stats``,
``--attribution`` and ``--ci`` are not ported yet. Reading CSVs needs pandas
(``mcport.data``), imported only when a command runs.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from mcport.config import DataConfig, GBMConfig


def _round_paths(n: int, block: int = 8_192) -> int:
    """Round a user path count up to a whole number of engine blocks."""
    return -(-n // block) * block


def cmd_gbm_risk(args) -> None:
    from mcport.data import load_universe
    from mcport_torch.engine.mc_engine import load_checkpoint, run_resumable_mc
    from mcport_torch.models.gbm import estimate_gbm, estimate_t_dof

    d = load_universe(paths=args.csv, config=DataConfig(period=args.period))
    params = estimate_gbm(d.prices, estimator=args.estimator,
                          ewma_lambda=args.ewma_lambda)
    a = d.n_assets
    w = (np.full(a, 1.0 / a) if args.weights is None
         else np.asarray([float(x) for x in args.weights.split(",")]))
    if w.shape[0] != a:
        raise SystemExit(f"--weights needs {a} entries")
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
    report, ck_out = run_resumable_mc(
        params, w, cfg, alpha=args.alpha, checkpoint=ck,
        checkpoint_path=args.checkpoint, device=args.device)
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
    json.dump(out, sys.stdout, indent=2, default=float)
    sys.stdout.write("\n")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mcport_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("gbm-risk", help="correlated-GBM tail risk")
    sp.add_argument("csv", nargs="+", help="asset CSV files (investing.com/yfinance format)")
    sp.add_argument("--period", default="M", choices=["M", "Q", "W", "D"],
                    help="analysis period (resample rule)")
    sp.add_argument("--paths", type=int, default=100_000)
    sp.add_argument("--steps", type=int, default=252)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--alpha", type=float, default=0.95)
    sp.add_argument("--weights", default=None, help="comma list; default equal")
    sp.add_argument("--antithetic", action="store_true")
    sp.add_argument("--innovations", default="normal", choices=["normal", "student_t"],
                    help="student_t fits dof by method of moments (fat tails)")
    sp.add_argument("--fast-normal", action="store_true",
                    help="screening-tier normal draws (degree-5 polynomial "
                         "Box-Muller, draw error <=~1e-5)")
    sp.add_argument("--checkpoint", default=None, help="npz checkpoint path")
    sp.add_argument("--resume", action="store_true", help="resume from --checkpoint")
    sp.add_argument("--estimator", default="sample", choices=["sample", "lw", "ewma"],
                    help="covariance tier: reference sample (ddof=1) | "
                         "Ledoit-Wolf shrinkage | RiskMetrics EWMA")
    sp.add_argument("--ewma-lambda", type=float, default=0.94,
                    help="EWMA decay (only with --estimator ewma)")
    sp.add_argument("--device", default="cuda",
                    help="torch device: cuda[:N] (default) or cpu (the plain "
                         "torch sampler, for tests)")
    sp.set_defaults(fn=cmd_gbm_risk)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
