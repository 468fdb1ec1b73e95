"""The port's CLI (``python -m mcport_torch.cli``) against mcport's on the
fixture universe, and the port's import boundary.

``gbm-risk`` reads ``fixtures/*Historical*.csv`` at ``--period D`` (14 assets)
in both CLIs; their JSON carries the same keys and agrees within Monte Carlo
error (the streams differ). ``path-risk``, ``dd-frontier`` and ``gbm-risk
--path-stats`` emit mcport's keys. ``garch-risk`` and ``bootstrap-risk`` read
the weekly BTC/ETH fixtures (365 rows): the same keys, the same fitted GARCH
parameters within 1e-4 (L-BFGS-B's reach, ``tests/test_torch_garch.py``),
and VaR/CVaR/mean within Monte Carlo error; ``jump-risk`` the same
calibration to 1e-12 and VaR/CVaR/mean and the jump fraction within Monte
Carlo error; ``path-risk --models jump,heston`` and ``dd-frontier --model
jump|heston`` mcport's keys. ``garch-risk --correlation dcc`` has mcport's
keys and model string and agrees in law (``--innovations student_t`` exits
with mcport's message); ``path-risk --models dcc`` and ``dd-frontier --model
dcc`` emit mcport's keys; ``compare-models`` gives mcport's seven families
with their keys, VaR/CVaR/mean within Monte Carlo error and the same DCC
fit. ``hedged-risk``, ``gbm-risk --hedge``, ``path-risk --hedge`` and
``dd-frontier --hedge`` (mcport's JSON hedge file: a married put on BTC, a
collar on ETH; every path family) emit mcport's keys, and ``--ci`` exits
with a message. A subprocess imports every ``mcport_torch``
module and finds neither jax nor pandas loaded.
"""

import contextlib
import glob
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcport.cli import main as ref_main
from mcport.config import DataConfig
from mcport.data import load_universe
from mcport_torch.cli import main as port_main
from mcport_torch.models.gbm import estimate_gbm

torch.set_num_threads(1)   # the suite runs several xdist workers on shared cores

ROOT = Path(__file__).resolve().parent.parent
PATHS, STEPS = 65_536, 16


def _run(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue())


@pytest.fixture(scope="module")
def csvs(fixtures_dir):
    return sorted(glob.glob(str(fixtures_dir / "*Historical*.csv")))


@pytest.mark.parametrize("extra", [[], ["--antithetic", "--estimator", "lw"]])
def test_gbm_risk_cli_matches_mcport(csvs, extra):
    common = ["gbm-risk", *csvs, "--period", "D", "--paths", str(PATHS),
              "--steps", str(STEPS), "--seed", "3", *extra]
    port = _run(port_main, common + ["--device", "cpu"])
    ref = _run(ref_main, common)
    assert set(port) == set(ref)
    assert port["n_paths"] == ref["n_paths"] == PATHS and port["done"] is True
    assert port["weights"] == ref["weights"] and port["innovations"] == ref["innovations"]
    assert port["cvar"] <= port["var"]
    # terminal means within 5 standard errors of the difference; VaR/CVaR
    # within 3% relative (the portfolio's own spread between seeds is ~0.6%)
    d = load_universe(paths=csvs, config=DataConfig(period="D"))
    chol = estimate_gbm(d.prices, estimator="lw" if "lw" in extra else "sample").chol_step
    se = np.sqrt(np.diag((chol @ chol.T).numpy()) * STEPS / PATHS)
    mp, mr = np.array(port["terminal_log_mean"]), np.array(ref["terminal_log_mean"])
    assert np.all(np.abs(mp - mr) < 5 * np.sqrt(2) * se)
    assert abs(port["var"] - ref["var"]) <= 0.03 * abs(ref["var"])
    assert abs(port["cvar"] - ref["cvar"]) <= 0.03 * abs(ref["cvar"])


def test_gbm_risk_cli_student_t_and_resume(csvs, tmp_path):
    ck = str(tmp_path / "ck.npz")
    args = ["gbm-risk", *csvs[:3], "--period", "D", "--paths", "4096", "--steps", "8",
            "--innovations", "student_t", "--fast-normal", "--device", "cpu",
            "--checkpoint", ck]
    out = _run(port_main, args)
    assert out["innovations"].startswith("student_t (dof=") and out["done"]
    again = _run(port_main, args + ["--resume"])
    assert again["var"] == out["var"] and again["n_paths"] == 4096


def test_gbm_risk_cli_rejects_wrong_weights(csvs):
    with pytest.raises(SystemExit, match="--weights needs 2 entries"):
        _run(port_main, ["gbm-risk", *csvs[:2], "--period", "D", "--weights", "1",
                         "--device", "cpu"])


def _modules(pkg: Path, name: str):
    """The package's modules, descending only into subpackages."""
    yield name
    for p in sorted(pkg.iterdir()):
        if p.suffix == ".py" and p.name != "__init__.py":
            yield f"{name}.{p.stem}"
        elif (p / "__init__.py").exists():
            yield from _modules(p, f"{name}.{p.name}")


def test_port_imports_no_jax_or_pandas():
    """Import every module of the port in a fresh interpreter."""
    mods = list(_modules(ROOT / "mcport_torch", "mcport_torch"))
    assert "mcport_torch.ops.gbm" in mods and "mcport_torch.cli" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'pandas'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_path_risk_cli_has_mcport_keys(csvs, tmp_path):
    common = ["path-risk", *csvs, "--period", "D", "--models", "gbm,student_t",
              "--paths", "8192", "--steps", "8", "--seed", "2"]
    port = _run(port_main, common + ["--device", "cpu"])
    ref = _run(ref_main, common)
    assert set(port) == set(ref) and port["weights"] == ref["weights"]
    for model in ("gbm", "student_t"):
        assert set(port[model]) == set(ref[model]) and port[model]["n_paths"] == 8192
    ck = str(tmp_path / "ck.npz")
    one = ["path-risk", *csvs[:3], "--period", "D", "--models", "gbm", "--paths", "8192",
           "--steps", "8", "--buy-and-hold", "--device", "cpu", "--checkpoint", ck]
    out = _run(port_main, one)
    assert out["rebalance_gbm"] is False and out["gbm"]["done"] is True
    assert _run(port_main, one + ["--resume"])["gbm"] == out["gbm"]


def test_dd_frontier_cli_has_mcport_keys(csvs):
    common = ["dd-frontier", *csvs, "--period", "D", "--candidates", "32", "--paths",
              "1024", "--steps", "8", "--dd-budget", "0.5"]
    port = _run(port_main, common + ["--device", "cpu"])
    ref = _run(ref_main, common)
    assert set(port) == set(ref) and port["n_feasible"] > 0
    assert set(port["weights"]) == set(ref["weights"])
    t = _run(port_main, common + ["--innovations", "student_t", "--score-dtype",
                                  "bfloat16", "--rebalance", "--device", "cpu"])
    assert t["innovations"].startswith("student_t (dof=")
    dcc = _run(port_main, ["dd-frontier", *csvs[:4], "--period", "D", "--candidates", "16",
                           "--paths", "256", "--steps", "4", "--dd-budget", "0.9", "--model",
                           "dcc", "--device", "cpu"])
    assert set(dcc) == set(port) and dcc["model"] == "dcc" and dcc["n_feasible"] > 0


def test_gbm_risk_cli_path_stats_has_mcport_keys(csvs):
    common = ["gbm-risk", *csvs[:4], "--period", "D", "--paths", "4096", "--steps", "8",
              "--path-stats"]
    port = _run(port_main, common + ["--device", "cpu"])
    ref = _run(ref_main, common)
    assert set(port) == set(ref) and set(port["max_drawdown"]) == set(ref["max_drawdown"])
    assert -1 <= port["max_drawdown"]["p95_worst"] <= port["max_drawdown"]["median"] <= 0


# ---- the GARCH and bootstrap families ----------------------------------------------

@pytest.fixture(scope="module")
def weekly(fixtures_dir):
    return sorted(glob.glob(str(fixtures_dir / "*7 Years Weekly.csv")))


def _within_mc(port, ref, keys, rel=0.05):
    """VaR-like outputs of two independent 20,000-path runs: within 5% relative
    plus an absolute 2e-3 (one estimate's error there is ~1%)."""
    for k in keys:
        assert abs(port[k] - ref[k]) <= rel * abs(ref[k]) + 2e-3, k


def test_garch_risk_cli_matches_mcport(weekly):
    common = ["garch-risk", *weekly, "--period", "W", "--paths", "20000", "--steps", "12",
              "--seed", "1"]
    port = _run(port_main, common + ["--device", "cpu"])
    ref = _run(ref_main, common)
    assert set(port) == set(ref) and port["model"] == ref["model"] == "ccc-garch(1,1)"
    assert port["weights"] == ref["weights"] and port["n_paths"] == 20_000
    np.testing.assert_allclose(port["garch_alpha"], ref["garch_alpha"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(port["garch_beta"], ref["garch_beta"], rtol=0, atol=1e-4)
    _within_mc(port, ref, ("var", "cvar", "portfolio_mean_return"))
    t = _run(port_main, common + ["--innovations", "student_t", "--device", "cpu"])
    t_ref = _run(ref_main, common + ["--innovations", "student_t"])
    assert t["model"] == t_ref["model"] and t["model"].startswith("ccc-garch(1,1)-t(dof=")
    _within_mc(t, t_ref, ("var", "cvar", "portfolio_mean_return"))
    dcc = _run(port_main, common + ["--correlation", "dcc", "--device", "cpu"])
    dcc_ref = _run(ref_main, common + ["--correlation", "dcc"])
    assert set(dcc) == set(dcc_ref) and dcc["model"] == dcc_ref["model"]
    assert dcc["model"].startswith("dcc-garch(1,1) a=") and dcc["n_paths"] == 20_000
    _within_mc(dcc, dcc_ref, ("var", "cvar", "portfolio_mean_return"))
    argv = common + ["--correlation", "dcc", "--innovations", "student_t"]
    with pytest.raises(SystemExit, match="normal shocks only") as ref_exit:
        _run(ref_main, argv)
    with pytest.raises(SystemExit) as port_exit:
        _run(port_main, argv + ["--device", "cpu"])
    assert str(port_exit.value) == str(ref_exit.value)


def test_bootstrap_risk_cli_matches_mcport(weekly):
    common = ["bootstrap-risk", *weekly, "--period", "W", "--paths", "20000", "--steps",
              "12", "--seed", "2", "--p-restart", "0.25"]
    port = _run(port_main, common + ["--device", "cpu"])
    ref = _run(ref_main, common)
    assert set(port) == set(ref) and port["expected_block_len"] == 4.0
    assert set(port["asset_mean_terminal"]) == set(ref["asset_mean_terminal"])
    _within_mc(port, ref, ("var", "cvar", "portfolio_mean_return"))


def test_path_risk_cli_families_have_mcport_keys(weekly, tmp_path):
    common = ["path-risk", *weekly, "--period", "W", "--models", "garch,dcc,bootstrap",
              "--paths", "8192", "--steps", "8", "--seed", "2", "--p-restart", "0.3"]
    port = _run(port_main, common + ["--device", "cpu"])
    ref = _run(ref_main, common)
    assert set(port) == set(ref)
    for model in ("garch", "dcc", "bootstrap"):
        assert set(port[model]) == set(ref[model]) and port[model]["n_paths"] == 8192
    ck = str(tmp_path / "ck.npz")
    one = ["path-risk", *weekly, "--period", "W", "--models", "bootstrap", "--paths",
           "16384", "--steps", "8", "--device", "cpu", "--checkpoint", ck]
    out = _run(port_main, one)
    assert out["bootstrap"]["done"] is True
    assert _run(port_main, one + ["--resume"])["bootstrap"] == out["bootstrap"]


def test_jump_risk_cli_matches_mcport(weekly):
    common = ["jump-risk", *weekly, "--period", "W", "--paths", "20000", "--steps", "12",
              "--seed", "1", "--threshold", "2.5"]
    port = _run(port_main, common + ["--device", "cpu"])
    ref = _run(ref_main, common)
    assert set(port) == set(ref) and port["engine"] == ref["engine"] == "merton-common-jump"
    assert port["weights"] == ref["weights"] and port["n_paths"] == 20_000
    cal, ref_cal = port["calibration"], ref["calibration"]
    assert cal["jump_rate_per_step"] == pytest.approx(ref_cal["jump_rate_per_step"], rel=1e-12)
    assert cal["jump_rate_per_step"] > 0
    for key in ("jump_mean", "jump_vol"):
        np.testing.assert_allclose(list(cal[key].values()), list(ref_cal[key].values()),
                                   rtol=1e-12)
    _within_mc(port, ref, ("var", "cvar", "portfolio_mean_return"))
    p = ref["paths_with_jump_frac"]
    assert abs(port["paths_with_jump_frac"] - p) <= 4 * np.sqrt(2 * p * (1 - p) / 20_000)


def test_path_risk_cli_jump_and_heston_have_mcport_keys(weekly):
    common = ["path-risk", *weekly, "--period", "W", "--models", "jump,heston", "--paths",
              "8192", "--steps", "8", "--seed", "2"]
    port = _run(port_main, common + ["--device", "cpu"])
    ref = _run(ref_main, common)
    assert set(port) == set(ref)
    for model in ("jump", "heston"):
        assert set(port[model]) == set(ref[model]) and port[model]["n_paths"] == 8192
        assert port[model]["cvar"] <= port[model]["var"]


def test_path_risk_cli_defaults_to_every_ported_family():
    from mcport_torch.cli import build_parser

    args = build_parser().parse_args(["path-risk", "x.csv"])
    assert args.models == "gbm,student_t,garch,dcc,jump,heston,bootstrap"


def test_compare_models_cli_matches_mcport(weekly):
    """Every family of mcport's compare-models, with its keys and its VaR,
    CVaR and mean within Monte Carlo error at 20,000 paths; the DCC fit's a
    and b equal."""
    common = ["compare-models", *weekly, "--period", "W", "--paths", "20000", "--steps", "12",
              "--seed", "1"]
    port = _run(port_main, common + ["--device", "cpu"])
    ref = _run(ref_main, common)
    assert set(port) == set(ref) and port["engine"] == ref["engine"] == "model-comparison"
    assert port["n_paths"] == ref["n_paths"] == 24_576 and port["weights"] == ref["weights"]
    assert set(port["models"]) == set(ref["models"]) and len(port["models"]) == 7
    for model, out in ref["models"].items():
        assert set(port["models"][model]) == set(out), model
        _within_mc(port["models"][model], out, ("var", "cvar", "portfolio_mean"))
    for k in ("a_dcc", "b_dcc"):
        assert port["models"]["dcc_garch"][k] == ref["models"]["dcc_garch"][k]


@pytest.mark.parametrize("model", ["garch", "dcc", "bootstrap", "jump", "heston"])
def test_dd_frontier_cli_families_have_mcport_keys(weekly, model):
    common = ["dd-frontier", *weekly, "--period", "W", "--candidates", "32", "--paths",
              "1024", "--steps", "8", "--dd-budget", "0.9", "--model", model]
    port = _run(port_main, common + ["--device", "cpu"])
    ref = _run(ref_main, common)
    assert set(port) == set(ref) and port["model"] == model and port["n_feasible"] > 0
    assert set(port["weights"]) == set(ref["weights"])
    with pytest.raises(SystemExit, match="gbm only"):
        _run(port_main, common + ["--fast-normal", "--device", "cpu"])


# ---- hedged settlement: --hedge and hedged-risk ---------------------------------------

@pytest.fixture(scope="module")
def hedge_file(weekly, tmp_path_factory):
    """mcport's JSON hedge config on the weekly fixtures: a married put on
    BTC and a collar on ETH (strikes relative to each last price)."""
    names = [Path(p).stem for p in weekly]
    path = tmp_path_factory.mktemp("hedge") / "hedge.json"
    path.write_text(json.dumps({names[0]: {"strategy": "Married Put"},
                                names[1]: {"strategy": "Collar"}}))
    return str(path)


@pytest.mark.parametrize("argv", [
    ["hedged-risk", "--models", "gbm,garch,jump,bootstrap", "--paths", "4096", "--steps",
     "8"],
    ["gbm-risk", "--paths", "8192", "--steps", "8", "--path-stats"],
    ["path-risk", "--models", "gbm,student_t,jump", "--paths", "8192", "--steps", "8"],
    ["dd-frontier", "--candidates", "32", "--paths", "1024", "--steps", "8", "--dd-budget",
     "0.9"],
    ["dd-frontier", "--model", "jump", "--candidates", "32", "--paths", "1024", "--steps",
     "8", "--dd-budget", "0.9"],
    ["path-risk", "--models", "garch,bootstrap", "--paths", "8192", "--steps", "8"],
    ["dd-frontier", "--model", "garch", "--candidates", "32", "--paths", "1024", "--steps",
     "8", "--dd-budget", "0.9"],
    ["dd-frontier", "--model", "bootstrap", "--candidates", "32", "--paths", "1024",
     "--steps", "8", "--dd-budget", "0.9"],
    ["path-risk", "--models", "heston", "--paths", "8192", "--steps", "8"],
    ["dd-frontier", "--model", "heston", "--candidates", "32", "--paths", "1024", "--steps",
     "8", "--dd-budget", "0.9"],
    ["path-risk", "--models", "dcc", "--paths", "8192", "--steps", "8"],
    ["dd-frontier", "--model", "dcc", "--candidates", "32", "--paths", "1024", "--steps",
     "8", "--dd-budget", "0.9"],
])
def test_hedged_commands_have_mcport_keys(weekly, hedge_file, argv):
    common = [argv[0], *weekly, "--period", "W", "--hedge", hedge_file, *argv[1:]]
    port = _run(port_main, common + ["--device", "cpu"])
    ref = _run(ref_main, common)
    assert set(port) == set(ref)
    for key, out in ref.items():
        if isinstance(out, dict) and key != "weights":
            assert set(port[key]) == set(out), key
    if argv[0] in ("hedged-risk", "path-risk"):
        models = argv[argv.index("--models") + 1].split(",")
        assert all(port[m]["hedged_assets"] == ref[m]["hedged_assets"] for m in models)
    if argv[0] == "dd-frontier":
        assert port["hedged"] is True and port["n_feasible"] > 0
    if argv[0] == "gbm-risk":
        assert port["hedged_assets"] == ref["hedged_assets"]
        assert port["max_drawdown"]["settlement"] == "per-period hedged"


def test_hedged_commands_exit_on_what_is_not_ported(weekly, hedge_file):
    common = [*weekly, "--period", "W", "--hedge", hedge_file, "--device", "cpu"]
    with pytest.raises(SystemExit, match="bootstrap error bars"):
        _run(port_main, ["hedged-risk", *common, "--ci", "50"])
    with pytest.raises(SystemExit, match="requires --hedge"):
        _run(port_main, ["hedged-risk", *weekly, "--period", "W", "--device", "cpu"])
    with pytest.raises(SystemExit, match="not in the universe"):
        bad = Path(hedge_file).with_name("bad.json")
        bad.write_text(json.dumps({"DOGE": {"strategy": "Collar"}}))
        _run(port_main, ["gbm-risk", *weekly, "--period", "W", "--hedge", str(bad),
                         "--device", "cpu"])
