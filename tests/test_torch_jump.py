"""The port's common-jump Merton family (``models/jump.py``, ``ops/jump.py``)
against mcport's, on the CPU.

- Deterministic: ``estimate_merton_common`` equals mcport's to 1e-12 on the
  weekly fixtures, on a series with planted common jumps and on a calm one
  (both take the GBM estimator there), and raises as mcport does when a
  threshold leaves too few calm steps; ``default_merton_sketch`` is mcport's
  exactly; ``convert.from_mcport`` round-trips each of mcport's four
  parameter types exactly.
- Stochastic, in law (Philox against Threefry): the exact terminal sampler's
  per-asset means within 6 standard errors of the difference, standard
  deviations within 6%, and mean jump count within 6 standard errors;
  ``merton_risk``'s VaR, CVaR and jump fraction within 4 standard errors of
  the difference (errors from the port's own per-path sample); the path form
  (kernel #8's plain form) against mcport's lax ``merton_path_stats``:
  terminal and drawdown means within 4 standard errors of the difference,
  the drawdown quantile within 4 (asymptotic quantile error). Jumps make the
  drawdown tail strictly worse than at rate 0.
- The jump clock: events at the rate, common normals N(0, 1); at rate 0 the
  plain form is kernel #3's rebalanced float32 plain form exactly.
- The kernel-vs-plain bound (``merton_shares``) holds the plain form against
  itself and rejects planted faults by at least 2x at the shapes the card's
  checks run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcport.config import DataConfig as RefDataConfig
from mcport.data import load_universe as ref_load
from mcport.models import jump as RJ
from mcport.models.garch_mc import CCCGarchParams as RefGarch
from mcport.models.gbm import GBMParams as RefGBM
from mcport.models.heston import HestonParams as RefHeston
from mcport_torch.convert import from_mcport
from mcport_torch.models import jump as J
from mcport_torch.ops import jump as O
from mcport_torch.ops.gbm import step_shocks
from mcport_torch.ops.multi_dd import multi_dd_reference

torch.set_num_threads(1)   # the suite runs several xdist workers on shared cores

A = 3
REF_DIFF = RefGBM(s0=np.array([100.0, 50.0, 20.0]), mean_step=np.array([1e-3, 5e-4, 8e-4]),
                  chol_step=np.linalg.cholesky(4e-4 * (0.5 * np.eye(A) + 0.5)))
REF = RJ.MertonParams(REF_DIFF, 0.05, np.array([-0.08, -0.1, -0.06]),
                      np.array([0.04, 0.05, 0.03]))
PARAMS = from_mcport(REF)
W = np.array([0.5, 0.3, 0.2])


@pytest.fixture(scope="module")
def weekly_prices(fixtures_dir):
    paths = sorted(str(p) for p in fixtures_dir.glob("*7 Years Weekly.csv"))
    return ref_load(paths=paths, config=RefDataConfig(period="W")).prices


def _jumpy_prices(seed: int, jumps: bool, n: int = 400) -> np.ndarray:
    """A 4-asset price history; with ``jumps``, planted common crashes of
    about -25% on 8 days."""
    rng = np.random.default_rng(seed)
    logret = rng.normal(5e-4, 0.01, (n, 4))
    if jumps:
        logret[rng.choice(n, 8, replace=False)] += rng.normal(-0.25, 0.03, (8, 4))
    return 100.0 * np.exp(np.vstack([np.zeros(4), np.cumsum(logret, axis=0)]))


def _assert_params_equal(got, want, tol=1e-12):
    d = got.diffusion
    for name in ("s0", "mean_step", "chol_step"):
        np.testing.assert_allclose(getattr(d, name).numpy(), getattr(want.diffusion, name),
                                   rtol=tol, atol=1e-15, err_msg=name)
    assert got.jump_rate == pytest.approx(want.jump_rate, rel=tol, abs=0)
    np.testing.assert_allclose(got.jump_mean.numpy(), want.jump_mean, rtol=tol, atol=1e-15)
    np.testing.assert_allclose(got.jump_vol.numpy(), want.jump_vol, rtol=tol, atol=1e-15)


@pytest.mark.parametrize("series", ["weekly", "planted", "calm"])
def test_estimate_merton_common_matches_mcport(weekly_prices, series):
    prices = {"weekly": weekly_prices, "planted": _jumpy_prices(0, True),
              "calm": _jumpy_prices(1, False)}[series]
    got, want = J.estimate_merton_common(prices), RJ.estimate_merton_common(prices)
    _assert_params_equal(got, want)
    assert (got.jump_rate > 0) == (series != "calm")
    if series == "planted":
        assert got.jump_rate == pytest.approx(8 / 400) and float(got.jump_mean.max()) < -0.2


def test_estimate_merton_common_refuses_too_few_calm_steps():
    prices = _jumpy_prices(2, True, n=40)
    for fn in (J.estimate_merton_common, RJ.estimate_merton_common):
        with pytest.raises(ValueError, match="too few to estimate"):
            fn(prices, threshold=0.0)


@pytest.mark.parametrize("n_steps", [1, 52, 252])
def test_default_merton_sketch_is_mcports(n_steps):
    got, want = J.default_merton_sketch(PARAMS, n_steps), RJ.default_merton_sketch(REF, n_steps)
    assert (got.n_bins, got.lo, got.hi, got.space) == (want.n_bins, want.lo, want.hi,
                                                       want.space)


@pytest.mark.parametrize("kind", ["gbm", "garch", "jump", "heston"])
def test_from_mcport_round_trips_every_parameter_type(kind):
    """Each of mcport's four parameter types is told apart by a field only it
    has and arrives exactly (mcport's HestonParams has a ``corr_chol`` too)."""
    rng = np.random.default_rng(7)
    chol = np.linalg.cholesky(0.5 * np.eye(A) + 0.5)
    ref = {
        "gbm": REF_DIFF,
        "garch": RefGarch(*(rng.uniform(0.01, 0.1, A) for _ in range(4)), chol,
                          rng.uniform(1e-4, 2e-4, A), rng.uniform(1e-4, 2e-4, A)),
        "jump": REF,
        "heston": RefHeston(*(rng.uniform(0.01, 0.5, A) for _ in range(6)), chol,
                            rng.uniform(10, 100, A)),
    }[kind]
    got = from_mcport(ref)
    assert type(got).__name__ == type(ref).__name__
    if kind == "jump":
        _assert_params_equal(got, ref, tol=0)
        return
    for name in ref.__dataclass_fields__:
        g = getattr(got, name)
        assert g.dtype == torch.float64 and np.array_equal(g.numpy(), getattr(ref, name)), name
    with pytest.raises(TypeError, match="no port counterpart"):
        from_mcport(object())


# ---- the exact terminal sampler, in law -----------------------------------------

N, STEPS = 40_000, 16


def _quantile_se(x: np.ndarray, p: float) -> float:
    q = np.quantile(x, p)
    h = 0.02 * x.std()
    return float(np.sqrt(p * (1 - p) / x.size) / (np.mean(np.abs(x - q) < h) / (2 * h)))


def _es_se(x: np.ndarray, p: float) -> float:
    q = np.quantile(x, p)
    tail = x[x <= q]
    return float(np.sqrt((tail.var() + (1 - p) * (q - tail.mean()) ** 2) / (x.size * p)))


def test_terminal_returns_match_mcport_in_law():
    d = PARAMS.diffusion
    got, n_got = J.merton_terminal_returns(3, d.mean_step, d.chol_step, PARAMS.jump_rate,
                                           PARAMS.jump_mean, PARAMS.jump_vol, N, STEPS,
                                           return_jumps=True, device="cpu")
    want, n_want = RJ.merton_terminal_returns(
        jax.random.key(3), REF_DIFF.mean_step, REF_DIFF.chol_step, REF.jump_rate,
        REF.jump_mean, REF.jump_vol, N, STEPS, jnp.float32, return_jumps=True)
    got, want = got.double().numpy(), np.asarray(want, np.float64)
    assert got.shape == want.shape == (N, A)
    se = np.sqrt((got.var(0) + want.var(0)) / N)
    assert np.all(np.abs(got.mean(0) - want.mean(0)) < 6 * se)
    np.testing.assert_allclose(got.std(0), want.std(0), rtol=0.06)
    lam = REF.jump_rate * STEPS
    n_got = n_got.double().numpy()
    assert n_got.min() >= 0 and np.array_equal(n_got, np.round(n_got))
    assert abs(n_got.mean() - float(np.mean(n_want))) < 6 * np.sqrt(2 * lam / N)
    assert abs(n_got.var() - lam) < 0.05 * lam


def test_merton_risk_matches_mcport_in_law():
    got = J.merton_risk(5, PARAMS, W, n_paths=N, n_steps=STEPS, device="cpu")
    want = RJ.merton_risk(jax.random.key(5), REF, W, n_paths=N, n_steps=STEPS)
    d = PARAMS.diffusion
    term = J.merton_terminal_returns(5, d.mean_step, d.chol_step, PARAMS.jump_rate,
                                     PARAMS.jump_mean, PARAMS.jump_vol, N, STEPS,
                                     device="cpu").double().numpy()
    port = np.expm1(term) @ W
    assert int(got.hist.sum()) == N and got.cvar <= got.var
    assert abs(got.var - float(want.var)) <= 4 * np.sqrt(2) * _quantile_se(port, 0.05)
    assert abs(got.cvar - float(want.cvar)) <= 4 * np.sqrt(2) * _es_se(port, 0.05)
    p = float(want.jump_frac)
    assert abs(got.jump_frac - p) <= 4 * np.sqrt(2 * p * (1 - p) / N)
    assert abs(got.port_mean - float(want.port_mean)) <= 4 * np.sqrt(2) * port.std() / np.sqrt(N)


# ---- the path form (kernel #8's plain form), in law ------------------------------

PATH_N, PATH_STEPS = 20_000, 16


def test_path_stats_match_mcport_in_law():
    cand = np.stack([W, np.full(A, 1 / A), np.eye(A)[1]])
    d = PARAMS.diffusion
    term, dd = (x.double().numpy() for x in J.merton_path_stats(
        5, d.mean_step, d.chol_step, 0.1, PARAMS.jump_mean, PARAMS.jump_vol, cand, PATH_N,
        PATH_STEPS, device="cpu"))
    rt, rd = (np.asarray(x, np.float64) for x in RJ.merton_path_stats(
        jax.random.key(5), REF_DIFF.mean_step, REF_DIFF.chol_step, 0.1, REF.jump_mean,
        REF.jump_vol, cand, PATH_N, PATH_STEPS))
    assert term.shape == dd.shape == rt.shape == (3, PATH_N)
    for c in range(3):
        se = np.sqrt((term[c].var() + rt[c].var()) / PATH_N)
        assert abs(term[c].mean() - rt[c].mean()) < 4 * se
        se_dd = np.sqrt((dd[c].var() + rd[c].var()) / PATH_N)
        assert abs(dd[c].mean() - rd[c].mean()) < 4 * se_dd
        q_se = _quantile_se(dd[c], 0.05)
        assert abs(np.quantile(dd[c], 0.05) - np.quantile(rd[c], 0.05)) < 4 * np.sqrt(2) * q_se
    assert (dd <= 0).all() and (dd >= -1).all()


def test_jumps_worsen_the_drawdown_tail():
    d = PARAMS.diffusion
    w = W[None]
    _, calm = J.merton_path_stats(2, d.mean_step, d.chol_step, 0.0, PARAMS.jump_mean,
                                  PARAMS.jump_vol, w, 8_192, 32, device="cpu")
    _, jumpy = J.merton_path_stats(2, d.mean_step, d.chol_step, 0.05, PARAMS.jump_mean,
                                   PARAMS.jump_vol, w, 8_192, 32, device="cpu")
    q_calm, q_jump = (float(torch.quantile(x[0].double(), 0.05)) for x in (calm, jumpy))
    assert q_jump < q_calm - 0.02
    # the same diffusion shocks: a jump only ever lowers a path's wealth here
    assert bool((jumpy <= calm + 1e-6).float().mean() > 0.99)


def test_jump_clock_law():
    event, jn = O.jump_clock(4, 0.2, 4_096, 33, device="cpu")
    assert event.shape == jn.shape == (1, 4_096, 33)
    assert set(event.unique().tolist()) == {0.0, 1.0}
    n = event.numel()
    assert abs(float(event.mean()) - 0.2) < 5 * np.sqrt(0.2 * 0.8 / n)
    assert abs(float(jn.mean())) < 5 / np.sqrt(n) and abs(float(jn.var()) - 1) < 0.02
    # any sub-range of paths regenerates bit for bit
    part, _ = O.jump_clock(4, 0.2, 100, 33, first_path=2_000, device="cpu")
    assert torch.equal(part[0], event[0, 2_000:2_100])


def test_zero_rate_is_the_multi_dd_plain_form_exactly():
    """The contract the kernel keeps on the card: at rate 0 the Merton plain
    form adds 0 · (muJ + sigJ jn) to kernel #3's increments."""
    a = 15
    rng = np.random.default_rng(3)
    mean = torch.tensor(rng.normal(1e-3, 5e-4, a), dtype=torch.float32)
    chol = torch.tensor(np.linalg.cholesky(4e-4 * (0.5 * np.eye(a) + 0.5)), dtype=torch.float32)
    w = torch.tensor(rng.dirichlet(np.ones(a), 13), dtype=torch.float32)
    muj, sigj = torch.full((a,), -0.08), torch.full((a,), 0.04)
    kw = dict(first_block=6, n_blocks=2)
    got = O.merton_multi_portfolio_dd(11, mean, chol, 0.0, muj, sigj, w, 300, 19, **kw)
    want = multi_dd_reference(11, mean, chol, w, 300, 19, rebalance=True, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---- the kernel-vs-plain bound ----------------------------------------------------

def _faulty(kind):
    """``merton_increments`` with a planted fault: "none", the clock never
    fires; "idiosyncratic", each asset draws its own jump normal instead of
    the common one; "late", each jump lands one step late."""
    def increments(seed, mean, chol, jump_rate, jump_mean, jump_vol, n_paths, n_steps, **kw):
        a, dev = chol.shape[0], chol.device
        z = step_shocks(seed, a, n_paths, n_steps, device=dev, **kw)
        event, jn = O.jump_clock(seed, jump_rate, n_paths, n_steps, device=dev, **kw)
        jn = jn[..., None]
        if kind == "none":
            event = torch.zeros_like(event)
        elif kind == "idiosyncratic":
            jn = step_shocks(seed + 1, a, n_paths, n_steps, device=dev, **kw)
        else:
            event = torch.cat([torch.zeros_like(event[..., :1]), event[..., :-1]], dim=-1)
            jn = torch.cat([torch.zeros_like(jn[..., :1, :]), jn[..., :-1, :]], dim=-2)
        return (mean + z @ chol.T) + event[..., None] * (jump_mean + jump_vol * jn)
    return increments


@pytest.mark.parametrize("fault", ["none", "idiosyncratic", "late"])
@pytest.mark.parametrize("steps, rate", [(7, 0.3), (252, 0.02)])
def test_merton_tolerance_rejects_planted_faults(monkeypatch, fault, steps, rate):
    """chip_smoke.py and tests/test_torch_cuda.py hold kernel #8 to
    ``merton_shares``; the plain form meets it against itself, and each
    planted fault exceeds it by at least 2x at the bench's 15 assets."""
    a = 15
    rng = np.random.default_rng(a)
    mean = torch.tensor(rng.normal(1e-3, 5e-4, a), dtype=torch.float32)
    chol = torch.tensor(np.linalg.cholesky(4e-4 * (0.5 * np.eye(a) + 0.5)), dtype=torch.float32)
    muj, sigj = torch.full((a,), -0.08), torch.full((a,), 0.04)
    w = torch.tensor(rng.dirichlet(np.ones(a), 13), dtype=torch.float32)
    kw = dict(first_block=6, n_blocks=2)
    right = O.merton_multi_dd_reference(11, mean, chol, rate, muj, sigj, w, 256, steps, **kw)
    assert max(O.merton_shares(right, right, chol, mean, sigj, steps).values()) == 0.0
    monkeypatch.setattr(O, "merton_increments", _faulty(fault))
    wrong = O.merton_multi_dd_reference(11, mean, chol, rate, muj, sigj, w, 256, steps, **kw)
    assert max(O.merton_shares(wrong, right, chol, mean, sigj, steps).values()) > 2.0


def test_wrappers_check_their_inputs():
    mean, chol = torch.zeros(3), torch.eye(3)
    muj, sigj, w = torch.zeros(3), torch.zeros(3), torch.ones(1, 3)
    with pytest.raises(ValueError, match="jump_rate"):
        O.merton_multi_portfolio_dd(0, mean, chol, -0.1, muj, sigj, w, 16, 4)
    with pytest.raises(ValueError, match="jump_vol must be"):
        O.merton_multi_portfolio_dd(0, mean, chol, 0.1, muj, torch.zeros(4), w, 16, 4)
    with pytest.raises(ValueError, match="weights must be"):
        O.merton_multi_portfolio_dd(0, mean, chol, 0.1, muj, sigj, torch.ones(2, 4), 16, 4)
    with pytest.raises(ValueError, match="no jump kernel"):
        O.merton_multi_portfolio_dd(0, *(x.to("meta") for x in (mean, chol)), 0.1,
                                    *(x.to("meta") for x in (muj, sigj, w)), 16, 4)
