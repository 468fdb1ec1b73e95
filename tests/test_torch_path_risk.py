"""The port's path tier (kernel #2's plain form, ``engine/path_risk.py`` and
``api.path_tail_risk``) against mcport's, on the CPU.

- Deterministic half: :func:`stats_from_log_paths` equals mcport's
  ``_lax_path_stats`` on the same ``simulate_log_paths`` paths to 1e-6
  relative (float32 arithmetic in both).
- Streams: the plain form's terminal log returns are the terminal sampler's
  (kernel #1's plain form) at the same seed and blocks, to 1e-5.
- Engines in law: the streams differ (Philox against Threefry), so
  ``run_path_risk``'s VaR, CVaR, mean return and drawdown mean, median and
  (1 - alpha)-quantile agree with mcport's at 32,768 paths x 16 steps within 4
  standard errors of the difference of two independent estimates, the
  errors taken from the port's own per-path sample (asymptotic quantile and
  expected-shortfall variances).
- Against itself the engine is exact: a split run resumed is bit-identical,
  and mcport's checkpoints are refused.
- The kernel-vs-plain bound (``path_stats_tolerance``) rejects planted faults
  at the shapes the card's checks run.
- The GARCH, DCC, bootstrap, common-jump Merton and Heston families:
  ``run_garch_path_risk``, ``run_dcc_path_risk``, ``run_bootstrap_path_risk``,
  ``run_merton_path_risk`` and ``run_heston_path_risk`` agree with mcport's
  in law at 16,384 paths x 12 steps (4 standard errors of the difference; a
  bootstrap quantile's error from its order statistics, its law being
  lumpy); their split runs resume bit-identically, and a checkpoint of one
  family, or of mcport, is refused by another.
"""

import dataclasses
import glob
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcport.config import Config as RefConfig
from mcport.config import DataConfig as RefDataConfig
from mcport.config import GBMConfig
from mcport.engine.path_risk import _lax_path_stats
from mcport.engine.path_risk import run_path_risk as ref_run
from mcport.engine.path_risk import run_resumable_path_risk as ref_resumable
from mcport.engine.path_risk import run_bootstrap_path_risk as ref_bootstrap_run
from mcport.engine.path_risk import run_dcc_path_risk as ref_dcc_run
from mcport.engine.path_risk import run_garch_path_risk as ref_garch_run
from mcport.engine.path_risk import run_heston_path_risk as ref_heston_run
from mcport.engine.path_risk import run_merton_path_risk as ref_merton_run
from mcport.models.dcc import DCCGarchParams as RefDcc
from mcport.models.garch_mc import CCCGarchParams as RefGarch
from mcport.models.heston import HestonParams as RefHeston
from mcport.models.jump import MertonParams as RefMerton
from mcport.models.gbm import GBMParams as RefParams
from mcport.models.gbm import simulate_log_paths
from mcport_torch.api import gbm_risk, path_tail_risk
from mcport_torch.config import Config, DataConfig
from mcport_torch.convert import from_mcport
from mcport_torch.data import load_universe
from mcport_torch.engine.drawdown_frontier import (drawdown_frontier_search,
                                                   family_drawdown_frontier_search)
from mcport_torch.engine.mc_engine import run_resumable_mc
from mcport_torch.models.dcc import dcc_risk
from mcport_torch.models.heston import heston_terminal_returns
from mcport_torch.models.jump import merton_risk
from mcport_torch.engine.path_risk import (
    DD_SKETCH,
    load_path_risk_checkpoint,
    run_bootstrap_path_risk,
    run_dcc_path_risk,
    run_garch_path_risk,
    run_heston_path_risk,
    run_merton_path_risk,
    run_path_risk,
    run_resumable_path_risk,
    run_resumable_path_risk_with_recovery,
    stats_from_log_paths,
)
from mcport_torch.options import HedgeSpec
from mcport_torch.ops.bootstrap import bootstrap_multi_portfolio_dd
from mcport_torch.ops.dcc import dcc_multi_portfolio_dd
from mcport_torch.ops.garch import garch_multi_portfolio_dd
from mcport_torch.ops.heston import heston_multi_portfolio_dd
from mcport_torch.ops.jump import merton_multi_portfolio_dd
from mcport_torch.ops.gbm import block_terminal_log_returns
from mcport_torch.ops.path_stats import (
    gbm_path_stats,
    path_stats_reference,
    path_stats_shares,
)

torch.set_num_threads(1)   # the suite runs several xdist workers on shared cores

FIXTURES = Path(__file__).resolve().parent.parent / "fixtures"
A = 6
RNG = np.random.default_rng(0)
CHOL = np.linalg.cholesky(4e-4 * (0.5 * np.eye(A) + 0.5))
MEAN = RNG.normal(1e-3, 5e-4, A)
W = RNG.dirichlet(np.ones(A))
REF_PARAMS = RefParams(s0=np.ones(A), mean_step=MEAN, chol_step=CHOL)
PARAMS = from_mcport(REF_PARAMS)
CFG = GBMConfig(n_paths=16_384, n_steps=16, path_block=2_048, seed=1)

_STATE = ("h_port", "h_dd", "s_port", "s_dd")


def _f32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


@pytest.mark.parametrize("t_df", [None, 5.0])
@pytest.mark.parametrize("rebalance", [False, True])
def test_stats_from_log_paths_matches_mcport(rebalance, t_df):
    key = jax.random.key(3)
    m, chol, w = (jnp.asarray(x, jnp.float32) for x in (MEAN, CHOL, W))
    paths = simulate_log_paths(key, m, chol, 512, 12, dtype=jnp.float32, t_df=t_df)
    want_port, want_dd = map(np.asarray, _lax_path_stats(
        key, m, chol, w, 512, 12, jnp.float32, rebalance, t_df))
    port, dd = stats_from_log_paths(torch.from_numpy(np.array(paths)), _f32(W), rebalance)
    np.testing.assert_allclose(port.numpy(), want_port, rtol=0,
                               atol=1e-6 * (1 + np.abs(want_port)).max())
    np.testing.assert_allclose(dd.numpy(), want_dd, rtol=0, atol=1e-6)
    assert (dd <= 0).all() and (dd >= -1).all()


@pytest.mark.parametrize("bm, t_df", [("poly", None), ("poly_fast", None), ("poly", 5.5)])
def test_plain_terminal_is_the_terminal_samplers(bm, t_df):
    kw = dict(first_block=4, n_blocks=2, bm=bm, t_df=t_df)
    term, _, _ = gbm_path_stats(7, _f32(MEAN), _f32(CHOL), _f32(W), 1_000, 13, **kw)
    want = block_terminal_log_returns(7, _f32(MEAN), _f32(CHOL), 1_000, 13, **kw)
    assert float((term - want).abs().max()) <= 1e-5
    no_term, port, dd = gbm_path_stats(7, _f32(MEAN), _f32(CHOL), _f32(W), 1_000, 13,
                                       terminal=False, **kw)
    assert no_term is None and port.shape == dd.shape == (2, 1_000)


def _quantile_se(x: np.ndarray, p: float) -> float:
    """Asymptotic standard error of the sample p-quantile of ``x``:
    sqrt(p(1-p)/n) / f(q), the density from a window of 2% of the spread."""
    q = np.quantile(x, p)
    h = 0.02 * x.std()
    dens = np.mean(np.abs(x - q) < h) / (2 * h)
    return float(np.sqrt(p * (1 - p) / x.size) / dens)


def _es_se(x: np.ndarray, p: float) -> float:
    q = np.quantile(x, p)
    tail = x[x <= q]
    return float(np.sqrt((tail.var() + (1 - p) * (q - tail.mean()) ** 2) / (x.size * p)))


@pytest.mark.parametrize("innov", ["normal", "student_t"])
@pytest.mark.parametrize("rebalance", [False, True])
def test_run_path_risk_matches_mcport_in_law(innov, rebalance):
    cfg = dataclasses.replace(CFG, n_paths=32_768, path_block=8_192, innovations=innov,
                              t_dof=5.0)
    got = run_path_risk(PARAMS, W, cfg, rebalance=rebalance, device="cpu")
    want = ref_run(REF_PARAMS, W, cfg, rebalance=rebalance)
    assert got.n_paths == want.n_paths == cfg.n_paths and got.tail_ci is None
    # the port's own per-path sample gives the standard errors
    _, port, dd = gbm_path_stats(cfg.seed, _f32(MEAN), _f32(CHOL), _f32(W), cfg.path_block,
                                 cfg.n_steps, first_block=0, n_blocks=4,
                                 rebalance=rebalance, t_df=5.0 if innov != "normal" else None)
    port, dd = port.double().numpy().ravel(), dd.double().numpy().ravel()
    se = {"var": _quantile_se(port, 0.05), "cvar": _es_se(port, 0.05),
          "port_mean": port.std() / np.sqrt(port.size),
          "dd_mean": dd.std() / np.sqrt(dd.size),
          "dd_p95": _quantile_se(dd, 0.05), "dd_median": _quantile_se(dd, 0.5)}
    for name, s in se.items():
        assert abs(getattr(got, name) - getattr(want, name)) <= 4 * np.sqrt(2) * s, name
    assert got.cvar <= got.var and -1 <= got.dd_p95 <= got.dd_median <= 0


def test_split_resume_and_grouping_are_bit_identical(tmp_path):
    full, ck_full = run_resumable_path_risk("gbm", PARAMS, W, CFG, device="cpu")
    _, part = run_resumable_path_risk("gbm", PARAMS, W, CFG, max_blocks=3, device="cpu",
                                      checkpoint_path=tmp_path / "ck.npz")
    assert not part.done and part.next_block == 3
    resumed, ck = run_resumable_path_risk(
        "gbm", PARAMS, W, CFG, device="cpu",
        checkpoint=load_path_risk_checkpoint(tmp_path / "ck.npz"))
    assert ck.done and resumed == full
    assert all(np.array_equal(getattr(ck, f), getattr(ck_full, f)) for f in _STATE)
    assert ck.h_port.dtype == np.int64 and int(ck.h_dd.sum()) == CFG.n_paths
    # the one-shot engine folds the same blocks: the same report
    assert run_path_risk(PARAMS, W, CFG, rebalance=True, device="cpu") == full


def test_resume_refuses_mcport_and_other_runs(tmp_path):
    _, ref_ck = ref_resumable("gbm", REF_PARAMS, W, CFG, max_blocks=2)
    ref_ck.save(tmp_path / "jax.npz")
    with pytest.raises(ValueError, match="digest"):
        run_resumable_path_risk("gbm", PARAMS, W, CFG, device="cpu",
                                checkpoint=load_path_risk_checkpoint(tmp_path / "jax.npz"))
    _, part = run_resumable_path_risk("gbm", PARAMS, W, CFG, max_blocks=1, device="cpu")
    for other in (dict(config=dataclasses.replace(CFG, seed=2)),
                  dict(config=CFG, rebalance=False), dict(config=CFG, model="student_t")):
        kw = dict(model="gbm", config=CFG) | other
        with pytest.raises(ValueError, match="digest"):
            run_resumable_path_risk(kw.pop("model"), PARAMS, W, kw.pop("config"),
                                    checkpoint=part, device="cpu", **kw)
    with pytest.raises(ValueError, match="different run configuration"):
        run_resumable_path_risk("gbm", PARAMS, W, dataclasses.replace(CFG, n_steps=8),
                                checkpoint=part, device="cpu")


@pytest.fixture(scope="module")
def universe(fixtures_dir):
    paths = sorted(glob.glob(str(fixtures_dir / "*Historical*.csv")))[:4]
    return paths, load_universe(paths, DataConfig(period="D"))


@pytest.mark.parametrize("model", ["gbm", "student_t"])
def test_path_tail_risk_has_mcport_keys(universe, model, tmp_path):
    from mcport.api import path_tail_risk as ref_tail
    from mcport.data import load_universe as ref_load

    paths, d = universe
    small = dataclasses.replace(GBMConfig(), n_paths=8_192, n_steps=8, path_block=4_096)
    got = path_tail_risk(d, None, Config(gbm=small), model=model, device="cpu")
    want = ref_tail(ref_load(paths=paths, config=RefDataConfig(period="D")), None,
                    RefConfig(gbm=small), model=model)
    assert set(got) == set(want) and got["n_paths"] == want["n_paths"] == 8_192
    assert got.get("t_dof") == pytest.approx(want.get("t_dof"), rel=1e-12)
    resumed = path_tail_risk(d, None, Config(gbm=small), model=model, max_blocks=1,
                             checkpoint_path=tmp_path / "ck.npz", device="cpu")
    assert resumed["done"] is False and resumed["n_paths"] == 4_096


@pytest.mark.parametrize("call", [
    lambda: run_path_risk(PARAMS, W, dataclasses.replace(CFG, qmc="sobol"), device="cpu"),
    lambda: run_path_risk(PARAMS, W, dataclasses.replace(CFG, ci_boot=10), device="cpu"),
    lambda: run_resumable_path_risk_with_recovery("gbm", PARAMS, W, CFG),
])
def test_unported_branches_raise(call):
    with pytest.raises(NotImplementedError, match="not ported"):
        call()


def _hedged_dcc_data():
    """Three assets' 120 weekly prices (a common factor) as ``path_tail_risk``
    takes them, and a married put on asset 0 at its last price."""
    from types import SimpleNamespace

    rng = np.random.default_rng(3)
    rets = rng.normal(1e-3, 0.02, (119, 3)) + rng.normal(0.0, 0.01, (119, 1))
    prices = 100.0 * np.cumprod(np.vstack([np.ones((1, 3)), 1.0 + rets]), axis=0)
    data = SimpleNamespace(names=("X0", "X1", "X2"), prices=prices,
                           port_rets=np.vstack([np.zeros((1, 3)), rets]))
    return data, {0: [("BUY_ASSET", 0.0, 0.0, 1.0), ("BUY_PUT", 0.95 * prices[-1, 0], 0.5, 1.0)]}


_DCC_SPEC = HedgeSpec.build({0: [("BUY_PUT", 0.95, 0.01, 1.0)],
                             2: [("SELL_CALL", 1.05, 0.01, 1.0)]}, [f"a{i}" for i in range(A)])
_DCC_CFG = GBMConfig(n_paths=4_096, n_steps=8, path_block=1_024, seed=1)


@pytest.mark.parametrize("call", [
    lambda: run_resumable_path_risk("dcc", DCC, W, _DCC_CFG, hedge=_DCC_SPEC, s0=np.ones(A),
                                    device="cpu")[0],
    lambda: family_drawdown_frontier_search(0, "dcc", DCC, dd_budget=0.9, n_candidates=16,
                                            n_paths=512, n_steps=8, hedge=_DCC_SPEC,
                                            s0=np.ones(A), device="cpu"),
    lambda: path_tail_risk(_hedged_dcc_data()[0], model="dcc", config=Config(gbm=_DCC_CFG),
                           legs_by_asset=_hedged_dcc_data()[1], device="cpu"),
    lambda: run_dcc_path_risk(DCC, W, _DCC_CFG, hedge=_DCC_SPEC, s0=np.ones(A), device="cpu"),
], ids=["resumable", "frontier", "path_tail_risk", "one-shot"])
def test_hedged_dcc_branches_run(call):
    """The calls that refused a hedged DCC run before its kernel's hedged mode
    was ported now run it: finite, ordered results."""
    out = call()
    if isinstance(out, dict):
        assert out["hedged_assets"] == ["X0"] and out["cvar"] <= out["var"]
    elif hasattr(out, "opt_idx"):
        assert out.opt_idx >= 0 and np.isfinite(out.ret).all()
    else:
        assert out.n_paths == _DCC_CFG.n_paths and out.cvar <= out.var
        assert -1.0 <= out.dd_p95 <= out.dd_median <= 0.0


def test_unknown_model_raises():
    with pytest.raises(ValueError, match="model must be"):
        run_resumable_path_risk("nope", PARAMS, W, CFG, device="cpu")


@pytest.mark.parametrize("call", [
    lambda: gbm_risk(PARAMS, W, Config(gbm=CFG)),
    lambda: run_resumable_mc(PARAMS, W, CFG),
    lambda: run_path_risk(PARAMS, W, CFG),
    lambda: run_resumable_path_risk("gbm", PARAMS, W, CFG),
    lambda: path_tail_risk(load_universe(
        sorted(glob.glob(str(FIXTURES / "*Historical*.csv")))[:2], DataConfig(period="D")),
        model="gbm"),
    lambda: drawdown_frontier_search(0, PARAMS),
    lambda: run_merton_path_risk(MERTON, W, CFG),
    lambda: family_drawdown_frontier_search(0, "heston", HESTON),
    lambda: merton_risk(0, MERTON, W, n_paths=64, n_steps=4),
    lambda: heston_terminal_returns(0, HESTON, 16, 4),
    lambda: run_dcc_path_risk(DCC, W, CFG),
    lambda: family_drawdown_frontier_search(0, "dcc", DCC),
    lambda: dcc_risk(0, DCC, W, n_paths=64, n_steps=4),
])
def test_entry_points_default_to_the_card(call):
    """Without a ``device`` every entry point asks for the card, and a
    machine without one raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


# ---- the kernel-vs-plain bound rejects planted faults ----------------------------

def _no_initial_peak(paths, w, rebalance):
    """A fault: the running peak starts at the first step's value, not V_0 = 1."""
    v = torch.exp(paths) @ w
    peak = torch.cummax(v, dim=-1).values
    return v[..., -1] - 1.0, torch.amin(v / peak - 1.0, dim=-1)


def _lagging_value(paths, w, rebalance):
    """A fault: the value scored at each step is the previous step's."""
    lagged = torch.cat([torch.zeros_like(paths[..., :1, :]), paths[..., :-1, :]], dim=-2)
    return stats_from_log_paths(lagged, w, rebalance)


def _rebalanced_in_buy_hold(paths, w, rebalance):
    return stats_from_log_paths(paths, w, True)


def _one_candidate(fault):
    """``fault`` as the reduction the plain form calls, with one candidate."""
    def multi_dd_from_log_paths(paths, weights, rebalance, score_dtype="float32"):
        port, dd = fault(paths, weights[0], rebalance)
        return port[..., None, :], dd[..., None, :]
    return multi_dd_from_log_paths


@pytest.mark.parametrize("fault", [_no_initial_peak, _lagging_value, _rebalanced_in_buy_hold])
@pytest.mark.parametrize("steps", [7, 252])
def test_path_stats_tolerance_rejects_planted_faults(monkeypatch, fault, steps):
    """chip_smoke.py and tests/test_torch_cuda.py hold kernel #2 to
    ``path_stats_tolerance``; each planted fault exceeds it by at least 2x at
    the 15-asset case they run."""
    import mcport_torch.ops.multi_dd as MD

    a = 15
    mean = _f32(np.full(a, 1e-3))
    chol = _f32(np.linalg.cholesky(4e-4 * (0.5 * np.eye(a) + 0.5)))
    w = _f32(np.random.default_rng(a).dirichlet(np.ones(a)))
    kw = dict(first_block=6, n_blocks=2)
    right = path_stats_reference(11, mean, chol, w, 512, steps, **kw)
    monkeypatch.setattr(MD, "multi_dd_from_log_paths", _one_candidate(fault))
    wrong = path_stats_reference(11, mean, chol, w, 512, steps, **kw)
    shares = path_stats_shares(wrong, right, chol, mean, steps)
    assert max(shares.values()) > 2.0, shares


def test_dd_sketch_is_mcports():
    from mcport.engine.path_risk import DD_SKETCH as REF_DD

    assert dataclasses.asdict(DD_SKETCH) == dataclasses.asdict(REF_DD)


# ---- the GARCH and bootstrap families ----------------------------------------------

REF_GARCH = RefGarch(
    mu=MEAN, omega=np.full(A, 4e-5), alpha=np.full(A, 0.08), beta=np.full(A, 0.9),
    corr_chol=np.linalg.cholesky(0.5 * np.eye(A) + 0.5), sigma2_0=np.full(A, 4e-4),
    eps2_0=np.full(A, 4e-4))
GARCH = from_mcport(REF_GARCH)
HISTORY = (np.random.default_rng(42).standard_t(5, (150, A)) * 0.02 + 0.002).astype(np.float32)
FAMILY_CFG = GBMConfig(n_paths=16_384, n_steps=12, path_block=4_096, seed=4)
REF_MERTON = RefMerton(REF_PARAMS, 0.1, np.linspace(-0.1, -0.05, A), np.full(A, 0.04))
MERTON = from_mcport(REF_MERTON)
REF_HESTON = RefHeston(mu=MEAN, kappa=np.full(A, 0.15), theta=np.full(A, 4e-4),
                       xi=np.full(A, 0.01), rho=np.full(A, -0.5), v0=np.full(A, 6e-4),
                       corr_chol=np.linalg.cholesky(0.5 * np.eye(A) + 0.5), s0=np.ones(A))
HESTON = from_mcport(REF_HESTON)
# the GARCH base with moving correlations; q0 off S, with a non-unit diagonal
REF_DCC = RefDcc(base=REF_GARCH, a_dcc=0.05, b_dcc=0.9, q0=0.45 * np.eye(A) + 0.6,
                 e0=np.linspace(-1.5, 1.5, A))
DCC = from_mcport(REF_DCC)
FAMILY_PARAMS = {"garch": GARCH, "dcc": DCC, "bootstrap": HISTORY, "jump": MERTON,
                 "heston": HESTON}
ONE_SHOT = {"garch": run_garch_path_risk, "dcc": run_dcc_path_risk,
            "bootstrap": run_bootstrap_path_risk, "jump": run_merton_path_risk,
            "heston": run_heston_path_risk}


def _order_se(x: np.ndarray, p: float) -> float:
    """Distribution-free standard error of the sample p-quantile (order
    statistics one binomial standard deviation either side)."""
    s = np.sort(x)
    k, d = int(p * x.size), int(np.sqrt(x.size * p * (1 - p)))
    return float(s[k + d] - s[k - d]) / 2


def _family_sample(model, cfg):
    """The port's per-path (port, dd) of a family run, for standard errors."""
    n = cfg.n_paths // cfg.path_block
    w = _f32(W)[None]
    if model == "garch":
        term, dd = garch_multi_portfolio_dd(cfg.seed, GARCH.tensors("cpu"), w, cfg.path_block,
                                            cfg.n_steps, first_block=0, n_blocks=n)
    elif model == "dcc":
        term, dd = dcc_multi_portfolio_dd(cfg.seed, DCC.tensors("cpu"), w, cfg.path_block,
                                          cfg.n_steps, first_block=0, n_blocks=n)
    elif model == "jump":
        d = MERTON.diffusion
        term, dd = merton_multi_portfolio_dd(cfg.seed, d.mean_step, d.chol_step,
                                             MERTON.jump_rate, MERTON.jump_mean,
                                             MERTON.jump_vol, w, cfg.path_block, cfg.n_steps,
                                             first_block=0, n_blocks=n)
    elif model == "heston":
        term, dd = heston_multi_portfolio_dd(cfg.seed, HESTON.tensors("cpu"), w,
                                             cfg.path_block, cfg.n_steps, first_block=0,
                                             n_blocks=n)
    else:
        term, dd = bootstrap_multi_portfolio_dd(cfg.seed, torch.as_tensor(HISTORY), w,
                                                cfg.path_block, cfg.n_steps, first_block=0,
                                                n_blocks=n)
    return term.double().numpy().ravel(), dd.double().numpy().ravel()


@pytest.mark.parametrize("model", ["garch", "dcc", "bootstrap", "jump", "heston"])
def test_family_path_risk_matches_mcport_in_law(model):
    got = ONE_SHOT[model](FAMILY_PARAMS[model], W, FAMILY_CFG, device="cpu")
    if model == "garch":
        want = ref_garch_run(REF_GARCH, W, FAMILY_CFG)
    elif model == "dcc":
        want = ref_dcc_run(REF_DCC, W, FAMILY_CFG)
    elif model == "jump":
        want = ref_merton_run(REF_MERTON, W, FAMILY_CFG)
    elif model == "heston":
        want = ref_heston_run(REF_HESTON, W, FAMILY_CFG)
    else:
        want = ref_bootstrap_run(HISTORY, W, FAMILY_CFG)
    assert got.n_paths == want.n_paths == FAMILY_CFG.n_paths and got.tail_ci is None
    port, dd = _family_sample(model, FAMILY_CFG)
    q_se = _order_se if model == "bootstrap" else _quantile_se
    se = {"var": q_se(port, 0.05), "cvar": _es_se(port, 0.05),
          "port_mean": port.std() / np.sqrt(port.size),
          "dd_mean": dd.std() / np.sqrt(dd.size),
          "dd_p95": q_se(dd, 0.05), "dd_median": q_se(dd, 0.5)}
    for name, s in se.items():
        assert abs(getattr(got, name) - getattr(want, name)) <= 4 * np.sqrt(2) * s, name
    assert got.cvar <= got.var and -1 <= got.dd_p95 <= got.dd_median <= 0


@pytest.mark.parametrize("model", ["garch", "dcc", "bootstrap", "jump", "heston"])
def test_family_split_resume_is_bit_identical(model, tmp_path):
    params = FAMILY_PARAMS[model]
    full, ck_full = run_resumable_path_risk(model, params, W, CFG, device="cpu")
    _, part = run_resumable_path_risk(model, params, W, CFG, max_blocks=3, device="cpu",
                                      checkpoint_path=tmp_path / "ck.npz")
    resumed, ck = run_resumable_path_risk(
        model, params, W, CFG, device="cpu",
        checkpoint=load_path_risk_checkpoint(tmp_path / "ck.npz"))
    assert not part.done and ck.done and resumed == full
    assert all(np.array_equal(getattr(ck, f), getattr(ck_full, f)) for f in _STATE)
    assert ONE_SHOT[model](params, W, CFG, device="cpu") == full
    if model == "bootstrap":   # the covering sketch of the history by default
        assert ck.sketch_space == "log1p"


def test_family_checkpoints_refuse_other_families():
    _, garch_ck = run_resumable_path_risk("garch", GARCH, W, CFG, max_blocks=1, device="cpu")
    _, boot_ck = run_resumable_path_risk("bootstrap", HISTORY, W, CFG, max_blocks=1,
                                         device="cpu")
    for model, params, ck in (("bootstrap", HISTORY, garch_ck), ("garch", GARCH, boot_ck),
                              ("gbm", PARAMS, garch_ck),
                              ("bootstrap", HISTORY * 1.01, boot_ck)):
        with pytest.raises(ValueError, match="digest"):
            run_resumable_path_risk(model, params, W, CFG, checkpoint=ck, device="cpu")
    with pytest.raises(ValueError, match="digest"):
        run_resumable_path_risk("bootstrap", HISTORY, W, CFG, p_restart=0.3,
                                checkpoint=boot_ck, device="cpu")
    _, ref_ck = ref_resumable("garch", REF_GARCH, W, CFG, max_blocks=1)
    with pytest.raises(ValueError, match="digest"):
        run_resumable_path_risk("garch", GARCH, W, CFG, checkpoint=ref_ck, device="cpu")


def test_jump_and_heston_checkpoints_refuse_other_families():
    _, jump_ck = run_resumable_path_risk("jump", MERTON, W, CFG, max_blocks=1, device="cpu")
    _, heston_ck = run_resumable_path_risk("heston", HESTON, W, CFG, max_blocks=1,
                                           device="cpu")
    other_rate = from_mcport(RefMerton(REF_PARAMS, 0.2, REF_MERTON.jump_mean,
                                       REF_MERTON.jump_vol))
    other_xi = from_mcport(RefHeston(**{**REF_HESTON.__dict__, "xi": np.full(A, 0.02)}))
    for model, params, ck in (("heston", HESTON, jump_ck), ("jump", MERTON, heston_ck),
                              ("garch", GARCH, jump_ck), ("gbm", PARAMS, heston_ck),
                              ("jump", other_rate, jump_ck), ("heston", other_xi, heston_ck)):
        with pytest.raises(ValueError, match="digest"):
            run_resumable_path_risk(model, params, W, CFG, checkpoint=ck, device="cpu")
    for model, ref in (("jump", REF_MERTON), ("heston", REF_HESTON)):
        _, ref_ck = ref_resumable(model, ref, W, CFG, max_blocks=1)
        with pytest.raises(ValueError, match="digest"):
            run_resumable_path_risk(model, FAMILY_PARAMS[model], W, CFG, checkpoint=ref_ck,
                                    device="cpu")


def test_dcc_checkpoints_refuse_other_families_and_parameters():
    """The DCC digest binds the GARCH base, q0, e0, a and b: a GARCH run on the
    same base, another b, another q0 and mcport's DCC checkpoint are refused."""
    from mcport_torch.convert import dcc_params_from_numpy

    _, dcc_ck = run_resumable_path_risk("dcc", DCC, W, CFG, max_blocks=1, device="cpu")
    _, garch_ck = run_resumable_path_risk("garch", GARCH, W, CFG, max_blocks=1, device="cpu")
    other_b = dcc_params_from_numpy(GARCH, 0.05, 0.91, DCC.q0, DCC.e0)
    other_q0 = dcc_params_from_numpy(GARCH, 0.05, 0.9, DCC.q0 + 0.01, DCC.e0)
    for model, params, ck in (("garch", GARCH, dcc_ck), ("dcc", DCC, garch_ck),
                              ("dcc", other_b, dcc_ck), ("dcc", other_q0, dcc_ck)):
        with pytest.raises(ValueError, match="digest"):
            run_resumable_path_risk(model, params, W, CFG, checkpoint=ck, device="cpu")
    _, ref_ck = ref_resumable("dcc", REF_DCC, W, CFG, max_blocks=1)
    with pytest.raises(ValueError, match="digest"):
        run_resumable_path_risk("dcc", DCC, W, CFG, checkpoint=ref_ck, device="cpu")
    resumed, ck = run_resumable_path_risk("dcc", DCC, W, CFG, checkpoint=dcc_ck, device="cpu")
    assert ck.done and resumed.n_paths == CFG.n_paths


@pytest.mark.parametrize("model", ["garch", "dcc", "bootstrap", "jump", "heston"])
def test_path_tail_risk_families_have_mcport_keys(fixtures_dir, model, tmp_path):
    from mcport.api import path_tail_risk as ref_tail
    from mcport.data import load_universe as ref_load

    paths = sorted(str(p) for p in fixtures_dir.glob("*7 Years Weekly.csv"))
    d = load_universe(paths, DataConfig(period="W"))
    small = dataclasses.replace(GBMConfig(), n_paths=8_192, n_steps=8, path_block=4_096)
    got = path_tail_risk(d, None, Config(gbm=small), model=model, device="cpu")
    want = ref_tail(ref_load(paths=paths, config=RefDataConfig(period="W")), None,
                    RefConfig(gbm=small), model=model)
    assert set(got) == set(want) and got["n_paths"] == want["n_paths"] == 8_192
    assert got["cvar"] <= got["var"] and -1 <= got["dd_p95"] <= 0
    resumed = path_tail_risk(d, None, Config(gbm=small), model=model, max_blocks=1,
                             checkpoint_path=tmp_path / "ck.npz", device="cpu")
    assert resumed["done"] is False and resumed["n_paths"] == 4_096
