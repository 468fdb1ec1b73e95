"""The port's CLI (``python -m mcport_torch.cli gbm-risk``) against mcport's
``gbm-risk`` on the fixture universe, and the port's import boundary.

Both CLIs read ``fixtures/*Historical*.csv`` at ``--period D`` (14 assets);
their JSON carries the same keys and agrees within Monte Carlo error (the
streams differ). A subprocess imports every ``mcport_torch`` module and finds
neither jax nor pandas loaded.
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
