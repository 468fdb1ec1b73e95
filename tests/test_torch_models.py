"""GBM estimation and portfolio returns (mcport_torch.models.gbm) against
mcport.models.gbm on the fixture universe: the 14 ``*Historical*`` CSVs at
``period="D"`` (24 price rows). Float64 estimators agree to 1e-12."""

import glob

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcport.models.gbm as ref
import mcport_torch.models.gbm as M
from mcport.config import DataConfig
from mcport.data import load_universe

torch.set_num_threads(1)   # the suite runs several xdist workers on shared cores


@pytest.fixture(scope="module")
def prices(fixtures_dir):
    paths = sorted(glob.glob(str(fixtures_dir / "*Historical*.csv")))
    d = load_universe(paths=paths, config=DataConfig(period="D"))
    assert d.prices.shape == (24, 14)
    return d.prices


@pytest.mark.parametrize("estimator, kw", [("sample", {}), ("lw", {}), ("ewma", {}),
                                           ("ewma", {"ewma_lambda": 0.8})])
def test_estimate_gbm_matches_mcport(prices, estimator, kw):
    want = ref.estimate_gbm(prices, estimator=estimator, **kw)
    got = M.estimate_gbm(prices, estimator=estimator, **kw)
    assert got.n_assets == 14 and got.chol_step.dtype == torch.float64
    np.testing.assert_allclose(got.s0.numpy(), want.s0, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.mean_step.numpy(), want.mean_step, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.chol_step.numpy(), want.chol_step, rtol=0, atol=1e-12)


def test_ledoit_wolf_and_ewma_match_mcport(prices):
    logret = np.diff(np.log(prices), axis=0)
    cov_j, rho_j = ref.ledoit_wolf_shrinkage(logret)
    cov_t, rho_t = M.ledoit_wolf_shrinkage(logret)
    assert abs(rho_t - rho_j) <= 1e-12
    np.testing.assert_allclose(cov_t.numpy(), cov_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(M.ewma_cov(logret, 0.9).numpy(), ref.ewma_cov(logret, 0.9),
                               rtol=0, atol=1e-12)


def test_estimate_t_dof_matches_mcport(prices):
    assert abs(M.estimate_t_dof(prices) - ref.estimate_t_dof(prices)) <= 1e-12
    assert abs(M.estimate_t_dof(prices[:, :3], max_dof=6.0)
               - ref.estimate_t_dof(prices[:, :3], max_dof=6.0)) <= 1e-12


@pytest.mark.parametrize("bad, err", [
    (np.ones((2, 3)), "T>=3"),
    (np.array([[1.0, 2.0], [0.0, 1.0], [1.0, 1.0]]), "strictly positive"),
    (np.array([[1.0, 2.0], [np.nan, 1.0], [1.0, 1.0]]), "strictly positive"),
])
def test_estimate_gbm_rejects_bad_prices(bad, err):
    with pytest.raises(ValueError, match=err):
        M.estimate_gbm(bad)
    with pytest.raises(ValueError, match="estimator"):
        M.estimate_gbm(np.ones((5, 2)) + np.arange(5)[:, None], estimator="shrunk")


def test_ewma_lambda_out_of_range():
    with pytest.raises(ValueError, match="lambda"):
        M.ewma_cov(np.ones((5, 2)), 1.0)


@pytest.mark.parametrize("w_shape", [(6,), (3, 6)])
def test_portfolio_terminal_returns_matches_mcport(w_shape):
    rng = np.random.default_rng(0)
    term = rng.normal(0.0, 0.3, (1_000, 6))
    w = rng.dirichlet(np.ones(6), size=w_shape[:-1] or None)
    want = np.asarray(ref.portfolio_terminal_returns(jnp.asarray(term), jnp.asarray(w)))
    got = M.portfolio_terminal_returns(torch.tensor(term), torch.tensor(w)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
