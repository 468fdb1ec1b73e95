"""Universes past the port's former caps, on the CPU.

mcport's GARCH, Heston and DCC paths take any number of assets; the port's
refused more than 16 (and every plain form more than 64) before its card
kernels were widened. The probe of ROADMAP.md Queue 3: a synthetic 200 x 17
weekly universe (N(1e-3, 0.02) returns plus a common factor). On it:

- ``path_tail_risk`` for garch, heston and dcc returns mcport's keys, and
  each family's path risk on mcport's fitted parameters agrees with mcport's
  in law (4 standard errors of the difference);
- ``compare_tail_risk`` reports all seven families, as mcport's does;

and every plain form runs at 70 assets (a tiny grid), and the bootstrap's
plain forms take a 5,000 x 15 history (past a block's shared memory on the
card, where the kernels read it from device memory).
"""

import numpy as np
import pytest
import torch

from mcport.api import compare_tail_risk as ref_compare
from mcport.api import path_tail_risk as ref_tail
from mcport.config import Config as RefConfig
from mcport.config import GBMConfig as RefGBMConfig
from mcport.data.pipeline import PriceData as RefPriceData
from mcport.engine.path_risk import run_dcc_path_risk as ref_dcc_run
from mcport.engine.path_risk import run_garch_path_risk as ref_garch_run
from mcport.engine.path_risk import run_heston_path_risk as ref_heston_run
from mcport.models.dcc import estimate_dcc_garch as ref_dcc_fit
from mcport.models.garch_mc import estimate_ccc_garch as ref_garch_fit
from mcport.models.heston import estimate_heston as ref_heston_fit
from mcport_torch.api import compare_tail_risk, path_tail_risk
from mcport_torch.config import Config, GBMConfig
from mcport_torch.convert import from_mcport
from mcport_torch.data import PriceData
from mcport_torch.engine.path_risk import (run_dcc_path_risk, run_garch_path_risk,
                                           run_heston_path_risk)
from mcport_torch.ops import bootstrap as B
from mcport_torch.ops import dcc as D
from mcport_torch.ops import garch as G
from mcport_torch.ops import heston as H
from mcport_torch.ops import jump as J
from mcport_torch.ops import multi_dd as M
from mcport_torch.ops import path_stats as P
from mcport_torch.ops.gbm import gbm_terminal_noise

torch.set_num_threads(1)   # the suite runs several xdist workers on shared cores

A = 17
CFG = dict(n_paths=8_192, n_steps=4, path_block=2_048, seed=3)


def _universe():
    """ROADMAP.md's probe: 200 weekly rows of N(1e-3, 0.02) returns plus a
    common factor, for 17 assets, as both packages' PriceData."""
    rng = np.random.default_rng(17)
    rets = rng.normal(1e-3, 0.02, (199, A)) + rng.normal(0.0, 0.01, (199, 1))
    prices = 100.0 * np.cumprod(np.vstack([np.ones((1, A)), 1.0 + rets]), axis=0)
    port_rets = np.vstack([np.zeros((1, A)), rets])
    fields = dict(names=tuple(f"S{i}" for i in range(A)), prices=prices, stats_rets=rets,
                  port_rets=port_rets, mean_ann=port_rets.mean(0) * 52,
                  cov_ann=np.cov(port_rets, rowvar=False) * 52, ann_factor=52,
                  resample_rule="W")
    return PriceData(**fields), RefPriceData(**fields)


@pytest.fixture(scope="module")
def universe():
    return _universe()


def _w():
    return np.full(A, 1.0 / A)


@pytest.mark.parametrize("model", ["garch", "heston", "dcc"])
def test_path_tail_risk_runs_past_16_assets_as_mcport(universe, model):
    port_data, ref_data = universe
    got = path_tail_risk(port_data, None, Config(gbm=GBMConfig(**CFG)), model=model,
                         device="cpu")
    want = ref_tail(ref_data, None, RefConfig(gbm=RefGBMConfig(**CFG)), model=model)
    assert set(got) == set(want) and got["n_paths"] == want["n_paths"] == CFG["n_paths"]
    assert all(np.isfinite(got[k]) for k in ("var", "cvar", "port_mean", "dd_p95"))
    assert got["cvar"] <= got["var"] and -1 <= got["dd_p95"] <= got["dd_median"] <= 0


def _quantile_se(x: np.ndarray, p: float) -> float:
    """Distribution-free standard error of the sample p-quantile (order
    statistics one binomial standard deviation either side)."""
    s = np.sort(x)
    k, d = int(p * x.size), int(np.sqrt(x.size * p * (1 - p)))
    return float(s[k + d] - s[k - d]) / 2


def _es_se(x: np.ndarray, p: float) -> float:
    q = np.quantile(x, p)
    tail = x[x <= q]
    return float(np.sqrt((tail.var() + (1 - p) * (q - tail.mean()) ** 2) / (x.size * p)))


@pytest.mark.parametrize("model", ["garch", "heston", "dcc"])
def test_family_path_risk_at_17_assets_matches_mcport_in_law(universe, model):
    """On mcport's fitted parameters (so that the estimations' own stopping
    points do not enter), the port's plain forms against mcport's lax
    samplers: the two streams differ, the laws agree within 4 standard errors
    of the difference, taken from the port's own per-path sample."""
    _, ref_data = universe
    kw = dict(CFG, n_paths=16_384, n_steps=8)
    fit, ref_run, run, kernel = {
        "garch": (ref_garch_fit, ref_garch_run, run_garch_path_risk,
                  G.garch_multi_portfolio_dd),
        "heston": (ref_heston_fit, ref_heston_run, run_heston_path_risk,
                   H.heston_multi_portfolio_dd),
        "dcc": (ref_dcc_fit, ref_dcc_run, run_dcc_path_risk, D.dcc_multi_portfolio_dd)}[model]
    ref_params = fit(ref_data.prices if model == "heston" else ref_data.port_rets)
    params = from_mcport(ref_params)
    want = ref_run(ref_params, _w(), RefGBMConfig(**kw))
    got = run(params, _w(), GBMConfig(**kw), device="cpu")
    term, dd = kernel(kw["seed"], params.tensors("cpu"), torch.full((1, A), 1.0 / A),
                      kw["path_block"], kw["n_steps"], first_block=0,
                      n_blocks=kw["n_paths"] // kw["path_block"])
    port, dd = term.double().numpy().ravel(), dd.double().numpy().ravel()
    se = {"var": _quantile_se(port, 0.05), "cvar": _es_se(port, 0.05),
          "port_mean": port.std() / np.sqrt(port.size),
          "dd_mean": dd.std() / np.sqrt(dd.size), "dd_p95": _quantile_se(dd, 0.05)}
    for name, s in se.items():
        assert abs(getattr(got, name) - getattr(want, name)) <= 4 * np.sqrt(2) * s, name


def test_compare_tail_risk_reports_seven_families_past_16_assets(universe):
    port_data, ref_data = universe
    cfg = dict(n_paths=4_096, n_steps=4, path_block=4_096, seed=1)
    got = compare_tail_risk(port_data, None, Config(gbm=GBMConfig(**cfg)), device="cpu")
    want = ref_compare(ref_data, None, RefConfig(gbm=RefGBMConfig(**cfg)))
    assert set(got) == set(want) and len(got) == 7
    assert all("error" not in v and v["cvar"] <= v["var"] for v in got.values())


# ---- every plain form at 70 assets ---------------------------------------------------

W70 = 70


def _chol70():
    corr = 0.5 * np.eye(W70) + 0.5
    return torch.as_tensor(np.linalg.cholesky(4e-4 * corr), dtype=torch.float32)


def _cases():
    chol = _chol70()
    mean = torch.full((W70,), 1e-3)
    w = torch.full((2, W70), 1.0 / W70)
    rng = np.random.default_rng(70)
    s2 = np.full(W70, 4e-4)
    from mcport_torch.convert import (dcc_params_from_numpy, garch_params_from_numpy,
                                      heston_params_from_numpy)

    garch = garch_params_from_numpy(rng.normal(1e-3, 5e-4, W70), 0.1 * s2,
                                    np.full(W70, 0.08), np.full(W70, 0.9),
                                    np.linalg.cholesky(0.5 * np.eye(W70) + 0.5), s2, s2)
    dcc = dcc_params_from_numpy(garch, 0.05, 0.9, 0.5 * np.eye(W70) + 0.5, np.zeros(W70))
    ones = np.ones(W70)
    heston = heston_params_from_numpy(np.full(W70, 1e-3), 0.15 * ones, 4e-4 * ones,
                                      3e-3 * ones, -0.5 * ones, 4e-4 * ones,
                                      np.linalg.cholesky(0.5 * np.eye(W70) + 0.5), ones)
    hist = torch.as_tensor(rng.normal(1e-3, 0.02, (50, W70)), dtype=torch.float32)
    jm, jv = torch.full((W70,), -0.05), torch.full((W70,), 0.04)
    g, d, h = garch.tensors("cpu"), dcc.tensors("cpu"), heston.tensors("cpu")
    return {
        "terminal_noise": lambda: gbm_terminal_noise(0, chol, 64, 3),
        "path_stats": lambda: P.gbm_path_stats(0, mean, chol, w[0], 64, 3)[1],
        "multi_dd": lambda: M.gbm_multi_portfolio_dd(0, mean, chol, w, 64, 3)[0],
        "jump": lambda: J.merton_multi_portfolio_dd(0, mean, chol, 0.1, jm, jv, w, 64, 3)[0],
        "garch_terminal": lambda: G.garch_terminal(0, g, 64, 3),
        "garch_multi_dd": lambda: G.garch_multi_portfolio_dd(0, g, w, 64, 3)[0],
        "heston_terminal": lambda: H.heston_terminal(0, h, 64, 3),
        "heston_multi_dd": lambda: H.heston_multi_portfolio_dd(0, h, w, 64, 3)[0],
        "dcc_terminal": lambda: D.dcc_terminal(0, d, 64, 3),
        "dcc_multi_dd": lambda: D.dcc_multi_portfolio_dd(0, d, w, 64, 3)[0],
        "bootstrap_terminal": lambda: B.bootstrap_terminal(0, hist, 64, 3),
        "bootstrap_multi_dd": lambda: B.bootstrap_multi_portfolio_dd(0, hist, w, 64, 3)[0],
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_every_plain_form_runs_at_70_assets(name):
    out = _cases()[name]()
    assert bool(torch.isfinite(out).all()) and out.numel() > 0
    M.check_card_assets(W70, name)   # the card takes it too: its wide layout
    with pytest.raises(ValueError, match="at least one asset"):
        M.check_card_assets(0, name)


def test_bootstrap_plain_forms_take_a_5000_row_history():
    hist = torch.as_tensor(np.random.default_rng(5).normal(1e-3, 0.02, (5_000, 15)),
                           dtype=torch.float32)
    assert not B.history_in_shared(4 * 5_000 * 15)
    term = B.bootstrap_terminal(2, hist, 512, 52, 0.2, first_block=1, n_blocks=2)
    idx = B.bootstrap_indices(2, 5_000, 512, 52, 0.2, first_block=1, n_blocks=2,
                              device="cpu")
    assert int(idx.max()) >= 3_870        # rows past the former shared-memory limit
    want = torch.prod(1.0 + hist[idx], dim=2) - 1.0
    assert torch.allclose(term, want, rtol=1e-5, atol=1e-6)
    w = torch.eye(15)[:3]
    t7, _ = B.bootstrap_multi_portfolio_dd(2, hist, w, 512, 52, 0.2, first_block=1,
                                           n_blocks=2)
    assert torch.equal(t7, term[..., :3].transpose(1, 2))
