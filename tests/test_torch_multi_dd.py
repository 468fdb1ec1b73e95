"""Kernel #3's plain form (``mcport_torch.ops.multi_dd``) against mcport, on the
CPU.

- Deterministic half: :func:`multi_dd_from_log_paths` equals mcport's
  ``_lax_multi_dd`` on the same ``simulate_log_paths`` paths, for one and five
  candidates, buy-and-hold and rebalanced: to 1e-6 relative in the float32
  tier; in the split and bf16 tiers within the emulation's stated bound —
  each product ``w·e`` off by at most ``_score_rounding(tier)`` relative, so a
  value by that much per step (compounded over the steps when rebalanced)
  and a drawdown by twice it; the buy-and-hold terminal stays float32.
- One candidate is the path-stats plain form's portfolio.
- The kernel-vs-plain bounds (``multi_dd_shares``) reject a wrong score tier
  and a wrong mode at the shapes the card's checks run.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcport.engine.drawdown_frontier import _lax_multi_dd
from mcport.models.gbm import simulate_log_paths
from mcport_torch.ops import multi_dd as MD
from mcport_torch.ops.path_stats import path_stats_reference

torch.set_num_threads(1)   # the suite runs several xdist workers on shared cores

A, N, T = 6, 256, 10
RNG = np.random.default_rng(0)
CHOL = np.linalg.cholesky(4e-4 * (0.5 * np.eye(A) + 0.5)).astype(np.float32)
MEAN = RNG.normal(1e-3, 5e-4, A).astype(np.float32)
CAND = RNG.dirichlet(np.ones(A), 5).astype(np.float32)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _score_rounding(score_dtype: str) -> float:
    """Relative error of one tier's product ``w·e`` against float32: 0, the
    split's ``4 · 2^-16`` (the operands' low parts keep ``2^-16`` each and
    ``w2·e2`` is dropped), or bf16's ``2^-7 + 2^-16`` (two roundings of
    ``2^-8``)."""
    return {"float32": 0.0, "tensorfloat32": 4 * 2.0 ** -16,
            "bfloat16": 2.0 ** -7 + 2.0 ** -16}[score_dtype]


@pytest.fixture(scope="module")
def paths():
    key = jax.random.key(11)
    log_paths = simulate_log_paths(key, jnp.asarray(MEAN), jnp.asarray(CHOL), N, T,
                                   dtype=jnp.float32)
    return key, torch.from_numpy(np.array(log_paths))


@pytest.mark.parametrize("n_cand", [1, 5])
@pytest.mark.parametrize("rebalance", [False, True])
@pytest.mark.parametrize("score_dtype", ["float32", "tensorfloat32", "bfloat16"])
def test_multi_dd_from_log_paths_matches_mcport(paths, n_cand, rebalance, score_dtype):
    key, log_paths = paths
    w = CAND[:n_cand]
    want_term, want_dd = map(np.asarray, _lax_multi_dd(
        key, jnp.asarray(MEAN), jnp.asarray(CHOL), jnp.asarray(w), N, T, jnp.float32,
        rebalance))
    term, dd = MD.multi_dd_from_log_paths(log_paths, _t(w), rebalance, score_dtype)
    assert term.shape == dd.shape == (n_cand, N)
    eps = _score_rounding(score_dtype) + 1e-6
    rel = (1 + eps) ** T - 1 if rebalance else eps
    term_rel = rel if rebalance else 1e-6
    assert np.all(np.abs(term.numpy() - want_term) <= term_rel * (1 + np.abs(want_term)))
    assert np.all(np.abs(dd.numpy() - want_dd) <= 2.1 * rel)
    if score_dtype == "bfloat16":     # the emulation does round
        assert np.abs(dd.numpy() - want_dd).max() > 1e-5


def test_one_candidate_is_the_path_stats_portfolio():
    kw = dict(first_block=2, n_blocks=2)
    for rebalance in (False, True):
        term, dd = MD.multi_dd_reference(5, _t(MEAN), _t(CHOL), _t(CAND[:1]), 300, 9,
                                         rebalance=rebalance, **kw)
        _, port, dd2 = path_stats_reference(5, _t(MEAN), _t(CHOL), _t(CAND[0]), 300, 9,
                                            rebalance=rebalance, **kw)
        torch.testing.assert_close(term[:, 0], port, rtol=0, atol=1e-6)
        torch.testing.assert_close(dd[:, 0], dd2, rtol=0, atol=1e-6)


# ---- the kernel-vs-plain bounds reject planted faults -----------------------------

@pytest.fixture(scope="module")
def smoke_case():
    """15 assets, 252 steps, 13 candidates: the card's case, at fewer paths."""
    a = 15
    mean = _t(np.random.default_rng(a).normal(1e-3, 5e-4, a))
    chol = _t(np.linalg.cholesky(4e-4 * (0.5 * np.eye(a) + 0.5)))
    cand = _t(np.random.default_rng(13).dirichlet(np.ones(a), 13))
    out = {}
    for reb in (False, True):
        for sd in MD.SCORE_DTYPES:
            out[reb, sd] = MD.multi_dd_reference(11, mean, chol, cand, 96, 252,
                                                 first_block=6, n_blocks=2,
                                                 rebalance=reb, score_dtype=sd)
    return mean, chol, out


@pytest.mark.parametrize("tier, planted, rebalance", [
    (tier, planted, reb) for tier, planted in (("float32", "bfloat16"),
                                               ("tensorfloat32", "bfloat16"),
                                               ("bfloat16", "float32"))
    for reb in (False, True)
] + [("float32", "tensorfloat32", True)])   # buy-and-hold, the split moves less
def test_tolerance_rejects_a_wrong_score_tier(smoke_case, rebalance, tier, planted):
    mean, chol, out = smoke_case
    right, wrong = out[rebalance, tier], out[rebalance, planted]
    shares = MD.multi_dd_shares(wrong, right, out[rebalance, "float32"], chol, mean, 252,
                                rebalance, tier)
    assert max(shares.values()) > 2.0, shares
    own = MD.multi_dd_shares(right, right, out[rebalance, "float32"], chol, mean, 252,
                             rebalance, tier)
    assert max(own.values()) == 0.0


def test_tolerance_rejects_a_wrong_mode(smoke_case):
    mean, chol, out = smoke_case
    shares = MD.multi_dd_shares(out[True, "float32"], out[False, "float32"],
                                out[False, "float32"], chol, mean, 252, False, "float32")
    assert max(shares.values()) > 2.0, shares


# ---- the wrapper -----------------------------------------------------------------

@pytest.mark.parametrize("bad, match", [
    (dict(score_dtype="float16"), "score_dtype"),
    (dict(weights=torch.zeros((0, A))), "weights"),
    (dict(weights=torch.ones((2, A + 1))), "weights"),
    (dict(bm="exact"), "bm"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    kw = dict(weights=_t(CAND))
    kw.update(bad)
    with pytest.raises(ValueError, match=match):
        MD.gbm_multi_portfolio_dd(0, _t(MEAN), _t(CHOL), kw.pop("weights"), 64, 4, **kw)


def test_wrapper_raises_for_a_device_without_kernel():
    with pytest.raises(ValueError, match="no multi-dd kernel"):
        MD.gbm_multi_portfolio_dd(0, _t(MEAN).to("meta"), _t(CHOL).to("meta"),
                                  _t(CAND).to("meta"), 64, 4)


def test_candidates_past_one_launch_score_alike():
    w = _t(np.random.default_rng(3).dirichlet(np.ones(A), MD.MAX_CANDIDATES + 3))
    term, dd = MD.gbm_multi_portfolio_dd(1, _t(MEAN), _t(CHOL), w, 40, 5)
    tail = MD.gbm_multi_portfolio_dd(1, _t(MEAN), _t(CHOL), w[-3:], 40, 5)
    torch.testing.assert_close(term[:, -3:], tail[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(dd[:, -3:], tail[1], rtol=0, atol=1e-6)


def test_constants_agree_with_the_kernel_source_and_mcport():
    from mcport.ops.pallas_multi_dd import BF16_DD_ERR_BOUND, BF16_DD_ERR_REBAL_COEF

    assert (MD.BF16_DD_ERR_BOUND, MD.BF16_DD_ERR_REBAL_COEF) == (
        BF16_DD_ERR_BOUND, BF16_DD_ERR_REBAL_COEF)
    src = (Path(MD.__file__).resolve().parents[1] / "csrc" / "multi_dd.cu").read_text()
    assert int(re.search(r"constexpr int kMaxCand = (\d+);", src)[1]) == MD.MAX_CANDIDATES
    enum = re.search(r"enum Score \{ kF32 = 0, kSplit = 1, kBf16 = 2 \};", src)
    assert enum and MD.SCORE_DTYPES == {"float32": 0, "tensorfloat32": 1, "bfloat16": 2}
