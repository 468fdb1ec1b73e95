"""The port's resumable MC engine (mcport_torch.engine.mc_engine) and
``gbm_risk`` against mcport's, on the CPU (the plain sampler).

The streams differ (Philox in the port, Threefry in mcport's lax engine), so
the comparison is in law: from the same converted parameters at 65,536 paths
x 16 steps, terminal means within 5 standard errors and VaR/CVaR within 4
standard errors of the difference of two independent estimates (asymptotic
quantile and expected-shortfall variances, evaluated on an exact sample of
the terminal law). A fixed 3% bound would sit below the Monte Carlo noise:
one 16,384-path VaR estimate alone has a standard error near 4% here. Against
itself the port is exact: a split run resumed, or another dispatch grouping,
is bit-identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mcport.config import Config, GBMConfig, SketchConfig
from mcport.engine.mc_engine import run_resumable_mc as ref_run
from mcport.models.gbm import GBMParams as RefParams
from mcport_torch.api import gbm_risk
from mcport_torch.convert import from_mcport, gbm_params_from_numpy
from mcport_torch.device import resolve_device
from mcport_torch.engine.mc_engine import (
    load_checkpoint,
    run_resumable_mc,
    run_resumable_mc_with_recovery,
)

torch.set_num_threads(1)   # the suite runs several xdist workers on shared cores

A = 6
RNG = np.random.default_rng(0)
CHOL = np.linalg.cholesky(4e-4 * (0.5 * np.eye(A) + 0.5))
MEAN = RNG.normal(1e-3, 5e-4, A)
W = RNG.dirichlet(np.ones(A))
REF_PARAMS = RefParams(s0=np.ones(A), mean_step=MEAN, chol_step=CHOL)
PARAMS = from_mcport(REF_PARAMS)
CFG = GBMConfig(n_paths=16_384, n_steps=16, path_block=2_048, seed=1)

_STATE = ("count", "sum", "sum_c", "outer", "outer_c", "hist", "port_sum")


def _same_state(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in _STATE)


def _tail_standard_errors(n_steps, n_paths, alpha=0.95, n_exact=2_000_000):
    """Asymptotic standard errors of the VaR and CVaR estimators at
    ``n_paths`` (normal shocks; the t tier keeps the covariance): VaR
    sqrt(p(1-p)/n)/f(q), CVaR sqrt((Var(X | X <= q) + (1-p)(q - ES)^2)/(n p)),
    p = 1 - alpha, from an exact sample of N(n m, n LL')."""
    z = np.random.default_rng(99).standard_normal((n_exact, A))
    port = (np.exp(n_steps * MEAN + np.sqrt(n_steps) * z @ CHOL.T) - 1.0) @ W
    p = 1.0 - alpha
    q = np.quantile(port, p)
    h = 0.01 * port.std()
    dens = np.mean(np.abs(port - q) < h) / (2 * h)
    tail = port[port <= q]
    se_var = np.sqrt(p * (1 - p) / n_paths) / dens
    se_cvar = np.sqrt((tail.var() + (1 - p) * (q - tail.mean()) ** 2) / (n_paths * p))
    return se_var, se_cvar


@pytest.mark.parametrize("kw", [{}, {"antithetic": True},
                                {"innovations": "student_t", "t_dof": 5.0},
                                {"dtype": "float64", "bm": "poly_fast"}])
def test_engine_matches_mcport_in_law(kw):
    cfg = dataclasses.replace(CFG, n_paths=65_536, path_block=8_192, **kw)
    got, ck = run_resumable_mc(PARAMS, W, cfg, device="cpu")
    want, _ = ref_run(REF_PARAMS, W, cfg)
    assert got.n_paths == want.n_paths == cfg.n_paths == int(ck.hist.sum())
    se = np.sqrt(np.diag(CHOL @ CHOL.T) * cfg.n_steps / cfg.n_paths)
    assert np.all(np.abs(got.mean - MEAN * cfg.n_steps) < 5 * se)
    assert np.all(np.abs(got.mean - want.mean) < 5 * np.sqrt(2) * se)
    np.testing.assert_allclose(got.cov, want.cov, rtol=0.1, atol=1e-5)
    se_var, se_cvar = _tail_standard_errors(cfg.n_steps, cfg.n_paths)
    assert abs(got.var - want.var) <= 4 * np.sqrt(2) * se_var
    assert abs(got.cvar - want.cvar) <= 4 * np.sqrt(2) * se_cvar
    assert got.cvar <= got.var
    assert abs(got.port_mean - want.port_mean) < 5 * np.sqrt(2) * se.max()


def test_split_and_resume_bit_identical(tmp_path):
    full, ck_full = run_resumable_mc(PARAMS, W, CFG, device="cpu")
    _, part = run_resumable_mc(PARAMS, W, CFG, max_blocks=3, device="cpu",
                               checkpoint_path=tmp_path / "ck.npz")
    assert not part.done and part.next_block == 3
    resumed, ck = run_resumable_mc(PARAMS, W, CFG, device="cpu",
                                   checkpoint=load_checkpoint(tmp_path / "ck.npz"))
    assert ck.done
    assert resumed.var == full.var and resumed.cvar == full.cvar
    np.testing.assert_array_equal(resumed.mean, full.mean)
    np.testing.assert_array_equal(resumed.cov, full.cov)
    assert _same_state(ck, ck_full)


def test_dispatch_grouping_never_changes_results():
    _, one = run_resumable_mc(PARAMS, W, CFG, device="cpu", dispatch_blocks=1)
    _, three = run_resumable_mc(PARAMS, W, CFG, device="cpu", dispatch_blocks=3)
    _, all_ = run_resumable_mc(PARAMS, W, CFG, device="cpu", dispatch_blocks=16)
    assert _same_state(one, three) and _same_state(one, all_)


def test_digest_rejects_a_jax_checkpoint(tmp_path):
    """Same parameters, weights and grid: mcport's checkpoint is still refused,
    because the two packages draw different streams."""
    _, ref_ck = ref_run(REF_PARAMS, W, CFG, max_blocks=2)
    ref_ck.save(tmp_path / "jax.npz")
    with pytest.raises(ValueError, match="digest"):
        run_resumable_mc(PARAMS, W, CFG, device="cpu",
                         checkpoint=load_checkpoint(tmp_path / "jax.npz"))


def test_resume_refuses_other_runs():
    _, part = run_resumable_mc(PARAMS, W, CFG, max_blocks=1, device="cpu")
    with pytest.raises(ValueError, match="digest"):
        run_resumable_mc(PARAMS, W, dataclasses.replace(CFG, seed=2), checkpoint=part,
                         device="cpu")
    with pytest.raises(ValueError, match="different run configuration"):
        run_resumable_mc(PARAMS, W, dataclasses.replace(CFG, n_steps=8), checkpoint=part,
                         device="cpu")
    with pytest.raises(ValueError, match="sketch"):
        run_resumable_mc(PARAMS, W, CFG, sketch=SketchConfig(), checkpoint=part,
                         device="cpu")


def test_gbm_risk_matches_engine_and_saves_checkpoint(tmp_path):
    cfg = Config(gbm=CFG)
    report = gbm_risk(PARAMS, W, cfg, checkpoint_path=tmp_path / "a.npz", device="cpu")
    want, _ = run_resumable_mc(PARAMS, W, CFG, device="cpu")
    assert (report.var, report.cvar, report.port_mean, report.n_paths) == \
        (want.var, want.cvar, want.port_mean, want.n_paths)
    np.testing.assert_array_equal(report.mean, want.mean)
    np.testing.assert_array_equal(report.cov, want.cov)
    ck = load_checkpoint(tmp_path / "a.npz")
    assert ck.done and ck.hist.dtype == np.int64 and int(ck.hist.sum()) == CFG.n_paths


def test_gbm_risk_fixed_sketch_and_price_data():
    class Prices:   # anything with a (T, A) ``prices`` matrix
        prices = np.exp(np.cumsum(RNG.normal(0.0, 0.02, (30, A)), axis=0))

    cfg = Config(gbm=dataclasses.replace(CFG, auto_sketch=False),
                 sketch=SketchConfig(n_bins=2_048, lo=-1.0, hi=3.0))
    report = gbm_risk(Prices(), None, cfg, device="cpu")
    assert report.n_paths == CFG.n_paths and report.cvar <= report.var


def test_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_resumable_mc(PARAMS, W, CFG, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gbm_risk(PARAMS, W, Config(gbm=CFG), device="cuda:0")
    with pytest.raises(ValueError, match="device must be"):
        resolve_device("mps")


@pytest.mark.parametrize("call", [
    lambda: run_resumable_mc(PARAMS, W, CFG, hedge=object(), device="cpu"),
    lambda: run_resumable_mc(PARAMS, W, dataclasses.replace(CFG, ci_boot=10), device="cpu"),
    lambda: run_resumable_mc_with_recovery(PARAMS, W, CFG),
    lambda: gbm_risk(PARAMS, W, Config(gbm=dataclasses.replace(CFG, qmc="sobol")),
                     device="cpu"),
    lambda: gbm_risk(PARAMS, W, Config(gbm=CFG), mesh=object(), device="cpu"),
    lambda: gbm_risk(PARAMS, W, Config(gbm=CFG), legs_by_asset={0: []}, device="cpu"),
])
def test_unported_branches_raise(call):
    with pytest.raises(NotImplementedError, match="not ported"):
        call()


def test_convert_validates_shapes():
    p = gbm_params_from_numpy(np.ones(A), MEAN, CHOL)
    assert p.n_assets == A
    with pytest.raises(ValueError, match="one universe"):
        gbm_params_from_numpy(np.ones(A), MEAN, CHOL[:-1])
    with pytest.raises(ValueError, match="weights must have shape"):
        gbm_risk(PARAMS, W[:-1], Config(gbm=CFG), device="cpu")
