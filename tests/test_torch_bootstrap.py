"""The port's stationary block bootstrap (``models/bootstrap.py``,
``ops/bootstrap.py``) against mcport's, on the CPU.

- Deterministic: ``_auto_sketch_from_history`` equals mcport's exactly; the
  kernels' shared header restates the port's bootstrap stream tag.
- Structure, exact: every one-step path is a history row; with
  ``p_restart = 0`` every step takes the next row, circularly, so two-step
  paths compound adjacent rows; the candidate form with one-hot weights
  compounds one asset's rows exactly as the terminal form does.
- In law: ``p_restart = 1`` (iid rows) gives the analytic terminal mean
  ``(1 + mean row)^n - 1`` within 5 standard errors; against mcport's lax
  sampler (Threefry against Philox) at 32,768 paths the terminal means agree
  within 6 standard errors of the difference and the standard deviations
  within 10%, and the candidates' mean return, mean drawdown and drawdown
  quantile within 4 standard errors of the difference (a quantile's error
  from its order statistics).
- The kernel-vs-plain bound (``bootstrap_shares``) rejects planted faults.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcport.models import bootstrap as RB
from mcport_torch.models import bootstrap as B
from mcport_torch.ops import bootstrap as O

torch.set_num_threads(1)   # the suite runs several xdist workers on shared cores

T, A = 150, 3
W = np.array([0.5, 0.3, 0.2])


@pytest.fixture(scope="module")
def history():
    rng = np.random.default_rng(42)
    return (rng.standard_t(5, (T, A)) * 0.02 + 0.002).astype(np.float32)


@pytest.mark.parametrize("n_steps", [1, 10, 252])
def test_auto_sketch_is_mcports(history, n_steps):
    got = B._auto_sketch_from_history(history, n_steps)
    want = RB._auto_sketch_from_history(history, n_steps)
    assert (got.n_bins, got.lo, got.hi, got.space) == (want.n_bins, want.lo, want.hi,
                                                       want.space)


def test_kernel_source_shares_the_stream_tag():
    import re
    from pathlib import Path

    from mcport_torch.rng import STREAM_BOOT, STREAM_GBM

    src = (Path(O.__file__).resolve().parents[1] / "csrc" / "gbm_draws.cuh").read_text()
    tag = re.search(r"constexpr uint32_t kStreamBoot = (\d+);", src).group(1)
    assert int(tag) == STREAM_BOOT != STREAM_GBM


def test_one_step_rows_are_history_rows(history):
    term = B.bootstrap_terminal_returns(3, history, 2_048, 1, p_restart=1.0,
                                        device="cpu").numpy()
    rows = (1.0 + history) - np.float32(1.0)       # a row through gross - 1, in float32
    eq = (term[:, None, :] == rows[None, :, :]).all(axis=2)
    assert eq.any(axis=1).all()


def test_no_restart_walks_adjacent_rows(history):
    idx = O.bootstrap_indices(5, T, 1_000, 40, 0.0, device="cpu")[0]
    assert torch.equal(idx[:, 1:], (idx[:, :-1] + 1) % T)
    term = B.bootstrap_terminal_returns(5, history, 1_000, 2, p_restart=0.0,
                                        device="cpu").double().numpy()
    h = history.astype(np.float64)
    pair = (1 + h) * (1 + np.roll(h, -1, axis=0)) - 1.0
    eq = np.isclose(term[:, None, :], pair[None, :, :], rtol=1e-5, atol=1e-6).all(axis=2)
    assert eq.any(axis=1).all()


def test_restart_rate_and_uniform_start(history):
    idx = O.bootstrap_indices(6, T, 20_000, 8, 0.25, device="cpu")[0]
    jumps = (idx[:, 1:] != (idx[:, :-1] + 1) % T).double().mean()
    # a restart lands on the next row 1/T of the time: rate p (1 - 1/T)
    assert abs(float(jumps) - 0.25 * (1 - 1 / T)) < 5 * np.sqrt(0.25 * 0.75 / idx[:, 1:].numel())
    counts = torch.bincount(idx[:, 0], minlength=T).double()
    assert float(((counts - counts.mean()) ** 2 / counts.mean()).sum()) < T + 6 * np.sqrt(2 * T)


def test_iid_moments_match_analytic(history):
    n, steps = 65_536, 6
    term = B.bootstrap_terminal_returns(3, history, n, steps, p_restart=1.0,
                                        device="cpu").double().numpy()
    want = (1 + history.astype(np.float64).mean(axis=0)) ** steps - 1
    se = term.std(axis=0, ddof=1) / np.sqrt(n)
    assert np.all(np.abs(term.mean(axis=0) - want) < 5 * se)


def test_reproducible_and_streams_distinct(history):
    h = torch.as_tensor(history)
    a = O.bootstrap_terminal(7, h, 1_024, 4, first_block=0, n_blocks=2)
    assert torch.equal(a, O.bootstrap_terminal(7, h, 1_024, 4, first_block=0, n_blocks=2))
    assert not torch.equal(a, O.bootstrap_terminal(8, h, 1_024, 4, first_block=0,
                                                   n_blocks=2))
    assert not torch.equal(a[0], a[1])
    # a resumed run draws the later blocks alone, bit for bit
    assert torch.equal(a[1], O.bootstrap_terminal(7, h, 1_024, 4, first_block=1)[0])


def test_terminal_matches_mcport_in_law(history):
    n, steps, p = 32_768, 12, 0.25
    got = B.bootstrap_terminal_returns(11, history, n, steps, p, device="cpu").double().numpy()
    want = np.asarray(RB.bootstrap_terminal_returns(jax.random.key(4), history, n, steps,
                                                    p_restart=p, dtype=jnp.float64))
    se = np.sqrt((got.var(0) + want.var(0)) / n)
    assert np.all(np.abs(got.mean(0) - want.mean(0)) < 6 * se)
    assert np.all(np.abs(got.std(0) / want.std(0) - 1) < 0.1)


def _quantile_se(x: np.ndarray, p: float) -> float:
    """Distribution-free standard error of the sample p-quantile: half the
    spread of the order statistics one binomial standard deviation either
    side. A bootstrap's laws are lumpy (a few hundred rows), where a density
    estimate at the quantile would understate the error."""
    s = np.sort(x)
    k, d = int(p * x.size), int(np.sqrt(x.size * p * (1 - p)))
    return float(s[k + d] - s[k - d]) / 2


def test_path_stats_match_mcport_in_law(history):
    n, steps = 32_768, 12
    cand = np.stack([W, np.full(A, 1 / A), np.eye(A)[2]])
    term, dd = (x.double().numpy() for x in B.bootstrap_path_stats(
        5, history, cand, n, steps, device="cpu"))
    rt, rd = (np.asarray(x) for x in RB.bootstrap_path_stats(
        jax.random.key(5), history, cand, n, steps, dtype=jnp.float64))
    for c in range(3):
        assert abs(term[c].mean() - rt[c].mean()) < 4 * np.sqrt((term[c].var() + rt[c].var()) / n)
        assert abs(dd[c].mean() - rd[c].mean()) < 4 * np.sqrt((dd[c].var() + rd[c].var()) / n)
        assert abs(np.quantile(dd[c], 0.05) - np.quantile(rd[c], 0.05)) < (
            4 * np.sqrt(2) * _quantile_se(dd[c], 0.05))
    assert (dd <= 0).all() and (dd >= -1).all()


def test_one_hot_candidates_are_the_terminal_form(history):
    """The candidate form selects the terminal form's rows: with one-hot
    weights its wealth is the terminal gross of that asset, bit for bit."""
    h = torch.as_tensor(history)
    term = O.bootstrap_terminal(9, h, 700, 13, 0.3, first_block=2, n_blocks=2)
    t7, _ = O.bootstrap_multi_portfolio_dd(9, h, torch.eye(A), 700, 13, 0.3, first_block=2,
                                           n_blocks=2)
    assert torch.equal(t7, term.transpose(1, 2))


def test_bootstrap_risk_matches_mcport(history):
    got = B.bootstrap_risk(0, history, W, n_paths=40_000, n_steps=12, device="cpu")
    want = RB.bootstrap_risk(jax.random.key(0), history, W, n_paths=40_000, n_steps=12)
    assert got._fields == want._fields
    assert got.cvar <= got.var < got.port_mean and int(got.hist.sum()) == 40_000
    assert got.hist[0] == 0 and got.hist[-1] == 0      # the covering sketch never clamps
    term = B.bootstrap_terminal_returns(0, history, 40_000, 12, device="cpu").double().numpy()
    port = term @ W
    se = port.std() / np.sqrt(port.size)
    assert abs(got.port_mean - float(want.port_mean)) < 6 * se
    assert abs(got.var - float(want.var)) < 4 * np.sqrt(2) * _quantile_se(port, 0.05)
    np.testing.assert_allclose(got.mean, term.mean(axis=0), rtol=1e-5)


# ---- the kernel-vs-plain bound ----------------------------------------------------

def _stale_rows(r, weights):
    """A fault: each step scores the previous step's row."""
    lagged = torch.cat([torch.zeros_like(r[..., :1, :]), r[..., :-1, :]], dim=-2)
    return REBALANCED(lagged, weights)


def _buy_and_hold(r, weights):
    """A fault: candidates hold their initial allocation."""
    gross = torch.cumprod(1.0 + r, dim=-2) @ weights.to(r.dtype).T       # (..., n, T, W)
    v = torch.movedim(gross, -1, -3)
    peak = torch.cummax(torch.clamp_min(v, 1.0), dim=-1).values
    return v[..., -1] - 1.0, torch.amin(torch.clamp_max(v / peak - 1.0, 0.0), dim=-1)


REBALANCED = O.rebalanced_dd


@pytest.mark.parametrize("fault", [_stale_rows, _buy_and_hold])
@pytest.mark.parametrize("steps", [7, 252])
def test_bootstrap_tolerance_rejects_planted_faults(monkeypatch, history, fault, steps):
    h = torch.as_tensor(np.random.default_rng(0).normal(1e-3, 0.02, (365, 15)),
                        dtype=torch.float32)
    w = torch.as_tensor(np.random.default_rng(1).dirichlet(np.ones(15), 13),
                        dtype=torch.float32)
    kw = dict(first_block=6, n_blocks=2)
    right = O.bootstrap_multi_dd_reference(11, h, w, 256, steps, 0.2, **kw)
    assert max(O.bootstrap_shares(right, right, h, w, steps).values()) == 0.0
    monkeypatch.setattr(O, "rebalanced_dd", fault)
    wrong = O.bootstrap_multi_dd_reference(11, h, w, 256, steps, 0.2, **kw)
    assert max(O.bootstrap_shares(wrong, right, h, w, steps).values()) > 2.0


def test_wrappers_check_their_inputs(history):
    h = torch.as_tensor(history)
    with pytest.raises(ValueError, match="float32"):
        O.bootstrap_terminal(0, h.double(), 16, 4)
    # the plain forms take any width, and so does the card (past 64 assets its wide
    # layout, csrc/wide.cuh): a launch refuses an empty universe only
    assert O.bootstrap_terminal(0, torch.zeros((10, 65)), 16, 4).shape == (1, 16, 65)
    O.check_card_assets(65, "bootstrap")
    O.check_card_assets(200, "bootstrap")
    with pytest.raises(ValueError, match="at least one asset"):
        O.check_card_assets(0, "bootstrap")
    with pytest.raises(ValueError, match="weights must be"):
        O.bootstrap_multi_portfolio_dd(0, h, torch.ones(2, A + 1), 16, 4)
    with pytest.raises(ValueError, match="no bootstrap kernel"):
        O.bootstrap_terminal(0, h.to("meta"), 16, 4)
    # a history past a block's shared memory is read from device memory
    assert O.history_in_shared(4 * 365 * 15)
    assert not O.history_in_shared(4 * 4_000 * 15)
