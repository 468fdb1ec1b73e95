"""The port's CUDA kernels on a card against their plain torch forms.

Marked ``cuda``; every test skips without a card. On a machine with one (and
without jax, which tests/conftest.py imports):

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

The cases of chip_smoke.py's phases 2 and 6 at test size, plus the engine's
own dispatch group at GBMConfig defaults. Bounds: the terminal-noise kernel
to ``mcport_torch.ops.gbm.kernel_tolerance`` (the smaller of 2e-6 per draw,
as nvcc contracts multiply-adds into FMAs where torch rounds twice, and a
random-walk bound at least four times the largest difference measured on an
H100); the path-stats kernel to ``ops.path_stats.path_stats_tolerance``; the
multi-dd kernel to ``ops.multi_dd.multi_dd_shares``. With one candidate the
multi-dd kernel is the path-stats kernel bit for bit, and the path-stats
kernel's terminal is the terminal-noise kernel's up to rounding. The family
kernels: CCC-GARCH (#4, #5) to ``ops.garch.garch_shares``, the bootstrap
(#6 bit for bit, #7 to ``ops.bootstrap.bootstrap_shares``), common-jump
Merton (#8) to ``ops.jump.merton_shares`` with the plain form's jump steps
and, at rate 0, kernel #3's output bit for bit, Heston (#9, #10) to
``ops.heston.heston_shares`` at the bench's vol-of-vol and a Feller-violating
one, and DCC-GARCH (the terminal kernel for #11/#12, the candidate kernel for
#13/#14) to ``ops.dcc.dcc_shares``, with ``a = b = 0`` held to kernel #4.
The wide variants of the GARCH, Heston and DCC kernels (17-64 assets) to
the same bounds, the bootstrap kernels on histories past shared memory bit
for bit, and the hedged modes of kernels #3 and #8 to ``multi_dd_shares``
and ``merton_shares`` with the hedge (an identity hedge against the
rebalanced mode; #8 at rate 0 equal to #3, both hedged). Past 64 assets
(``csrc/wide.cuh``): every kernel at A = 65 and 200 (DCC 256, where Q and L
leave shared memory) to the same bounds, the bit-identical pairs bit for
bit. The hedged modes of #5 and #7 (1-3 legs, W in {1, 13, 256}, 15, 64 and
65 assets, shared and device-memory histories) to ``garch_shares`` and
``bootstrap_shares`` with the hedge; one-hot hedged bootstrap candidates bit
for bit; identity hedges against the unhedged modes; overflowed wealth held.
The hedged mode of #10 (15, 17, 64, 65 and 200 assets) to ``heston_shares``
with the hedge (``heston_price_bound``), each C entry point's signature, the
identity hedge at a Feller-violating vol of vol, overflowed wealth held. The
hedged mode of #13 (4, 15, 16, 17, 64, 65 and 256 assets, W up to 257) to
``dcc_shares`` with the hedge (``dcc_price_bound``), each C entry point's
signature, the identity hedge against the unhedged kernel, overflowed
wealth held. The DCC kernel past 16 assets (``dcc_group_kernel``) at each
group size's edges, off the 4-column panels and on each side of where Q and
the factor leave shared memory: the terminal, W = 1 to 257 and the hedged
mode to the same bounds; its scratch check. The narrow candidate kernel
(``dcc_dd_kernel``) in each layout ``ops.dcc.dcc_narrow_plan`` picks (W = 1
to 256 on each side of every switch, A = 1 to 16, 0 to 52 steps, hedged
with one and two legs of every type) to the same bounds, and its scratch
taken in chunks bit for bit with the whole launch. The Merton and Heston
candidate kernels up to 16 assets (``csrc/narrow_dd.cuh``) in the layout
their W picks (on each side of every switch of ``merton_narrow_plan`` and
``heston_narrow_plan`` and at 256, A = 1, 7, 15, 16, hedged with two legs of
every type, Heston also at a Feller-violating vol of vol) to the same bounds,
every layout by name bit for bit with it, the jump kernel's layouts at rate
0 equal to kernel #3, and the split layout's scratch taken in chunks bit for
bit with the whole launch. The GARCH and bootstrap candidate kernels up to
16 assets the same way (on each side of every switch of
``garch_narrow_plan`` and ``bootstrap_narrow_plan`` and at 256, A = 1, 7,
15, 16, hedged with two legs of every type, the bootstrap over a history in
shared memory and one in device memory), their split scratch in chunks too.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest --noconftest "
                    "-o addopts='' -m cuda tests/test_torch_cuda.py")
    return torch.device("cuda")


def _chol(a, dev):
    corr = 0.5 * np.eye(a) + 0.5
    return torch.from_numpy(np.linalg.cholesky(4e-4 * corr).astype(np.float32)).to(dev)


def _within(k, p, tol):
    return bool(torch.isfinite(k).all()) and bool(((k - p).abs() <= tol).all())


@pytest.mark.parametrize("a", [1, 15, 64])
@pytest.mark.parametrize("bm, t_df", [("poly", None), ("poly_fast", None), ("poly", 5.5)])
@pytest.mark.parametrize("steps", [252, 7])
def test_kernel_matches_plain_form(dev, a, bm, t_df, steps):
    from mcport_torch.ops.gbm import gbm_terminal_noise, kernel_tolerance, terminal_noise_reference

    chol = _chol(a, dev)
    kw = dict(first_block=6, n_blocks=2, bm=bm, t_df=t_df)
    before = gbm_terminal_noise.launches
    k = gbm_terminal_noise(11, chol, 4_099, steps, **kw)
    torch.cuda.synchronize()
    assert gbm_terminal_noise.launches == before + 1
    p = terminal_noise_reference(11, chol, 4_099, steps, **kw)
    assert _within(k, p, kernel_tolerance(chol, steps))


@pytest.mark.parametrize("bm", ["poly", "poly_fast"])
@pytest.mark.parametrize("steps", [1, 2])
def test_kernel_single_draws_match_plain_form(dev, bm, steps):
    """With L = [[1]] and one or two steps the output is the draws themselves,
    where a wrong polynomial (poly_fast's ln in the poly tier) shows."""
    from mcport_torch.ops.gbm import gbm_terminal_noise, kernel_tolerance, terminal_noise_reference

    one = torch.ones((1, 1), dtype=torch.float32, device=dev)
    kw = dict(first_block=6, n_blocks=2, bm=bm)
    k = gbm_terminal_noise(11, one, 65_537, steps, **kw)
    p = terminal_noise_reference(11, one, 65_537, steps, **kw)
    assert _within(k, p, kernel_tolerance(one, steps))


def test_kernel_matches_plain_form_at_the_engine_group(dev):
    """The launch run_resumable_mc makes at GBMConfig defaults: seed 0, blocks
    0-15 of 8,192 paths in one launch, 252 steps, poly."""
    from mcport_torch.config import GBMConfig
    from mcport_torch.ops.gbm import gbm_terminal_noise, kernel_tolerance, terminal_noise_reference

    g = GBMConfig()
    chol = _chol(15, dev)
    kw = dict(first_block=0, n_blocks=g.n_paths // g.path_block, bm=g.bm)
    k = gbm_terminal_noise(g.seed, chol, g.path_block, g.n_steps, **kw)
    p = terminal_noise_reference(g.seed, chol, g.path_block, g.n_steps, **kw)
    assert _within(k, p, kernel_tolerance(chol, g.n_steps))
    # a resumed run launches the later blocks alone: same numbers, bit for bit
    tail = gbm_terminal_noise(g.seed, chol, g.path_block, g.n_steps, first_block=5,
                              n_blocks=kw["n_blocks"] - 5, bm=g.bm)
    assert torch.equal(tail, k[5:])


def test_kernel_rejects_too_many_assets(dev):
    """Past 64 assets the kernel runs its wide layout (csrc/wide.cuh) and
    meets the same bound; only an empty universe is refused."""
    from mcport_torch.ops.gbm import gbm_terminal_noise, kernel_tolerance, terminal_noise_reference

    chol = _chol(65, dev)
    k = gbm_terminal_noise(3, chol, 1_029, 52, first_block=6, n_blocks=2)
    p = terminal_noise_reference(3, chol, 1_029, 52, first_block=6, n_blocks=2)
    assert _within(k, p, kernel_tolerance(chol, 52))
    with pytest.raises(ValueError, match="at least one asset"):
        gbm_terminal_noise(0, chol[:0, :0], 128, 4)


def test_engine_on_card_matches_cpu_run(dev):
    from mcport_torch.config import GBMConfig
    from mcport_torch.convert import gbm_params_from_numpy
    from mcport_torch.engine.mc_engine import run_resumable_mc

    a = 5
    params = gbm_params_from_numpy(np.ones(a), np.full(a, 1e-3), _chol(a, "cpu").double())
    w = np.full(a, 1.0 / a)
    cfg = GBMConfig(n_paths=8_192, n_steps=16, path_block=2_048, seed=2)
    card, ck_card = run_resumable_mc(params, w, cfg, device=dev)
    cpu, ck_cpu = run_resumable_mc(params, w, cfg, device="cpu")
    np.testing.assert_allclose(card.mean, cpu.mean, rtol=0, atol=1e-6)
    np.testing.assert_allclose(card.cov, cpu.cov, rtol=0, atol=1e-8)
    assert int(np.abs(ck_card.hist - ck_cpu.hist).sum()) <= 4   # a few bin-edge moves


# ---- kernel #2: path stats -------------------------------------------------------

def _bench_inputs(a, dev, seed=0):
    rng = np.random.default_rng(seed)
    mean = torch.from_numpy(rng.normal(1e-3, 5e-4, a).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.dirichlet(np.ones(a)).astype(np.float32)).to(dev)
    return mean, _chol(a, dev), w


@pytest.mark.parametrize("a", [1, 15, 64])
@pytest.mark.parametrize("bm, t_df", [("poly", None), ("poly_fast", None), ("poly", 5.5)])
@pytest.mark.parametrize("steps", [252, 7])
@pytest.mark.parametrize("rebalance", [False, True])
def test_path_stats_kernel_matches_plain_form(dev, a, bm, t_df, steps, rebalance):
    from mcport_torch.ops.gbm import t_scaled_chol
    from mcport_torch.ops.path_stats import (gbm_path_stats, path_stats_reference,
                                             path_stats_shares)

    mean, chol, w = _bench_inputs(a, dev)
    kw = dict(first_block=6, n_blocks=2, bm=bm, t_df=t_df, rebalance=rebalance)
    before = gbm_path_stats.launches
    k = gbm_path_stats(11, mean, chol, w, 4_099, steps, **kw)
    torch.cuda.synchronize()
    assert gbm_path_stats.launches == before + 1
    lk = t_scaled_chol(chol, t_df)
    p = path_stats_reference(11, mean, lk, w, 4_099, steps, **kw)
    shares = path_stats_shares(k, p, lk, mean, steps)
    assert max(shares.values()) <= 1.0, shares


@pytest.mark.parametrize("t_df", [None, 5.5])
def test_path_stats_terminal_is_the_terminal_kernels(dev, t_df):
    """Kernel #2's terminal log returns are kernel #1's drift + L·Σz at the
    same seed and blocks, up to the rounding of the running sum."""
    from mcport_torch.ops.gbm import block_terminal_log_returns, t_scaled_chol
    from mcport_torch.ops.path_stats import gbm_path_stats, path_stats_tolerance

    mean, chol, w = _bench_inputs(15, dev)
    term, _, _ = gbm_path_stats(0, mean, chol, w, 8_192, 252, first_block=0, n_blocks=3,
                                t_df=t_df)
    ref = block_terminal_log_returns(0, mean, chol, 8_192, 252, first_block=0, n_blocks=3,
                                     t_df=t_df)
    tol, _ = path_stats_tolerance(t_scaled_chol(chol, t_df), mean, 252)
    assert bool(((term - ref).abs() <= tol).all())


def test_path_stats_kernel_without_terminal(dev):
    from mcport_torch.ops.path_stats import gbm_path_stats

    mean, chol, w = _bench_inputs(15, dev)
    full = gbm_path_stats(2, mean, chol, w, 3_000, 16, rebalance=True)
    term, port, dd = gbm_path_stats(2, mean, chol, w, 3_000, 16, rebalance=True,
                                    terminal=False)
    assert term is None and torch.equal(port, full[1]) and torch.equal(dd, full[2])


# ---- kernel #3: many candidates over one path set ------------------------------

@pytest.mark.parametrize("n_cand", [1, 13, 256])
@pytest.mark.parametrize("score_dtype", ["float32", "tensorfloat32", "bfloat16"])
@pytest.mark.parametrize("rebalance", [False, True])
def test_multi_dd_kernel_matches_plain_form(dev, n_cand, score_dtype, rebalance):
    from mcport_torch.ops.multi_dd import (gbm_multi_portfolio_dd, multi_dd_reference,
                                           multi_dd_shares)

    mean, chol, _ = _bench_inputs(15, dev)
    w = torch.from_numpy(np.random.default_rng(n_cand).dirichlet(
        np.ones(15), n_cand).astype(np.float32)).to(dev)
    kw = dict(first_block=6, n_blocks=2, rebalance=rebalance)
    before = gbm_multi_portfolio_dd.launches
    k = gbm_multi_portfolio_dd(11, mean, chol, w, 2_053, 252, score_dtype=score_dtype, **kw)
    torch.cuda.synchronize()
    assert gbm_multi_portfolio_dd.launches == before + 1
    p = multi_dd_reference(11, mean, chol, w, 2_053, 252, score_dtype=score_dtype, **kw)
    p32 = multi_dd_reference(11, mean, chol, w, 2_053, 252, **kw)
    shares = multi_dd_shares(k, p, p32, chol, mean, 252, rebalance, score_dtype)
    assert max(shares.values()) <= 1.0, shares


@pytest.mark.parametrize("bm, t_df", [("poly_fast", None), ("poly", 5.5)])
@pytest.mark.parametrize("a", [1, 64])
def test_multi_dd_kernel_tiers_and_widths(dev, bm, t_df, a):
    from mcport_torch.ops.gbm import t_scaled_chol
    from mcport_torch.ops.multi_dd import (gbm_multi_portfolio_dd, multi_dd_reference,
                                           multi_dd_shares)

    mean, chol, _ = _bench_inputs(a, dev)
    w = torch.from_numpy(np.random.default_rng(3).dirichlet(np.ones(a), 20).astype(
        np.float32)).to(dev)
    k = gbm_multi_portfolio_dd(5, mean, chol, w, 1_000, 7, bm=bm, t_df=t_df)
    lk = t_scaled_chol(chol, t_df)
    p = multi_dd_reference(5, mean, lk, w, 1_000, 7, bm=bm, t_df=t_df)
    shares = multi_dd_shares(k, p, p, lk, mean, 7, False, "float32")
    assert max(shares.values()) <= 1.0, shares


@pytest.mark.parametrize("rebalance", [False, True])
def test_multi_dd_one_candidate_is_path_stats(dev, rebalance):
    """Kernel #3 with one candidate is kernel #2's (port, dd), operation for
    operation."""
    from mcport_torch.ops.multi_dd import gbm_multi_portfolio_dd
    from mcport_torch.ops.path_stats import gbm_path_stats

    mean, chol, w = _bench_inputs(15, dev)
    _, port, dd = gbm_path_stats(0, mean, chol, w, 8_192, 252, first_block=0, n_blocks=2,
                                 rebalance=rebalance)
    term, dd3 = gbm_multi_portfolio_dd(0, mean, chol, w[None], 8_192, 252, first_block=0,
                                       n_blocks=2, rebalance=rebalance)
    assert torch.equal(term[:, 0], port) and torch.equal(dd3[:, 0], dd)


def test_multi_dd_more_than_one_launch_of_candidates(dev):
    from mcport_torch.ops.multi_dd import gbm_multi_portfolio_dd

    mean, chol, _ = _bench_inputs(15, dev)
    w = torch.from_numpy(np.random.default_rng(4).dirichlet(np.ones(15), 300).astype(
        np.float32)).to(dev)
    before = gbm_multi_portfolio_dd.launches
    term, dd = gbm_multi_portfolio_dd(1, mean, chol, w, 777, 9)
    assert gbm_multi_portfolio_dd.launches == before + 2
    tail = gbm_multi_portfolio_dd(1, mean, chol, w[256:], 777, 9)
    assert torch.equal(term[:, 256:], tail[0]) and torch.equal(dd[:, 256:], tail[1])


# ---- kernels #4 and #5: CCC-GARCH -------------------------------------------------

def _garch(a, dev, seed=0):
    """The bench's GARCH universe (bench.py): variance 4e-4, omega 4e-5,
    alpha 0.08, beta 0.9, correlation 0.5."""
    from mcport_torch.convert import garch_params_from_numpy

    rng = np.random.default_rng(seed)
    s0 = np.full(a, 4e-4)
    return garch_params_from_numpy(rng.normal(1e-3, 5e-4, a), 0.1 * s0, np.full(a, 0.08),
                                   np.full(a, 0.9), np.linalg.cholesky(
                                       0.5 * np.eye(a) + 0.5), s0, s0).tensors(dev)


@pytest.mark.parametrize("a", [1, 7, 15, 16])
@pytest.mark.parametrize("t_df", [None, 5.5])
@pytest.mark.parametrize("steps", [252, 7, 5, 1, 0])
def test_garch_terminal_kernel_matches_plain_form(dev, a, t_df, steps):
    """The kernel the wrapper routes to, at every tail of a Philox call
    (1-3 normal steps, 1 Student-t step, none), over two blocks of 4,099
    paths (not a whole number of CUDA blocks) from block 7: within
    garch_shares of its plain form, exactly 0 at no step."""
    from mcport_torch.ops.garch import garch_shares, garch_terminal, garch_terminal_reference

    g = _garch(a, dev)
    kw = dict(first_block=6, n_blocks=2, t_df=t_df)
    before = garch_terminal.launches
    k = garch_terminal(11, g, 4_099, steps, **kw)
    torch.cuda.synchronize()
    assert garch_terminal.launches == before + 1
    if steps == 0:
        assert torch.equal(k, torch.zeros_like(k))
        return
    p = garch_terminal_reference(11, g, 4_099, steps, **kw)
    shares = garch_shares(k, p, g, steps, t_df)
    assert max(shares.values()) <= 1.0, shares


@pytest.mark.parametrize("n_cand", [1, 13, 256])
@pytest.mark.parametrize("a, steps", [(15, 252), (15, 7), (1, 9), (16, 8)])
def test_garch_multi_dd_kernel_matches_plain_form(dev, n_cand, a, steps):
    from mcport_torch.ops.garch import (garch_multi_dd_reference, garch_multi_portfolio_dd,
                                        garch_shares)

    g = _garch(a, dev)
    w = torch.from_numpy(np.random.default_rng(n_cand).dirichlet(
        np.ones(a), n_cand).astype(np.float32)).to(dev)
    kw = dict(first_block=6, n_blocks=2)
    before = garch_multi_portfolio_dd.launches
    k = garch_multi_portfolio_dd(11, g, w, 2_053, steps, **kw)
    torch.cuda.synchronize()
    assert garch_multi_portfolio_dd.launches == before + 1
    p = garch_multi_dd_reference(11, g, w, 2_053, steps, with_bound=True, **kw)
    shares = garch_shares(k, p, g, steps)
    assert max(shares.values()) <= 1.0, shares


def test_garch_kernels_agree_on_one_asset(dev):
    """With one asset and the weight 1, the candidate kernel's value is the
    terminal kernel's compounded gross up to the rounding of ``1 + (mu +
    eps)`` against ``(1 + mu) + eps``: the two share their shocks."""
    from mcport_torch.ops.garch import garch_multi_portfolio_dd, garch_terminal

    g = _garch(1, dev)
    term = garch_terminal(3, g, 8_192, 252, first_block=0, n_blocks=2)
    t5, _ = garch_multi_portfolio_dd(3, g, torch.ones((1, 1), device=dev), 8_192, 252,
                                     first_block=0, n_blocks=2)
    rel = ((t5[:, 0] - term[..., 0]).abs() / (1 + term[..., 0].abs())).max()
    assert float(rel) < 1e-4


def test_garch_kernels_reject_too_many_assets(dev):
    """Past 64 assets the kernels run their wide layout and meet the same
    bound; only an empty universe is refused."""
    from mcport_torch.ops.garch import garch_shares, garch_terminal, garch_terminal_reference

    g = _garch(65, dev)
    k = garch_terminal(3, g, 1_029, 52, first_block=6, n_blocks=2)
    p = garch_terminal_reference(3, g, 1_029, 52, first_block=6, n_blocks=2)
    assert max(garch_shares(k, p, g, 52).values()) <= 1.0
    from mcport_torch.ops.gbm import check_card_assets

    with pytest.raises(ValueError, match="at least one asset"):
        check_card_assets(0, "GARCH")


# ---- kernels #6 and #7: stationary block bootstrap ---------------------------------

def _history(t_len, a, dev, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(1e-3, 0.02, (t_len, a)).astype(np.float32)).to(dev)


@pytest.mark.parametrize("a", [1, 15, 64])
@pytest.mark.parametrize("p_restart", [0.2, 0.0, 1.0])
@pytest.mark.parametrize("steps", [252, 7])
def test_bootstrap_terminal_kernel_is_its_plain_form(dev, a, p_restart, steps):
    """The kernel selects the plain form's rows and compounds them in the same
    order: equal bit for bit."""
    from mcport_torch.ops.bootstrap import bootstrap_terminal, bootstrap_terminal_reference

    hist = _history(365, a, dev)
    kw = dict(first_block=6, n_blocks=2)
    before = bootstrap_terminal.launches
    k = bootstrap_terminal(11, hist, 4_099, steps, p_restart, **kw)
    torch.cuda.synchronize()
    assert bootstrap_terminal.launches == before + 1
    assert torch.equal(k, bootstrap_terminal_reference(11, hist, 4_099, steps, p_restart,
                                                       **kw))


@pytest.mark.parametrize("n_cand", [1, 13, 256])
@pytest.mark.parametrize("a, steps", [(15, 252), (15, 7), (1, 9), (64, 8)])
def test_bootstrap_multi_dd_kernel_matches_plain_form(dev, n_cand, a, steps):
    from mcport_torch.ops.bootstrap import (bootstrap_multi_dd_reference,
                                            bootstrap_multi_portfolio_dd, bootstrap_shares)

    hist = _history(365, a, dev)
    w = torch.from_numpy(np.random.default_rng(n_cand).dirichlet(
        np.ones(a), n_cand).astype(np.float32)).to(dev)
    kw = dict(first_block=6, n_blocks=2)
    before = bootstrap_multi_portfolio_dd.launches
    k = bootstrap_multi_portfolio_dd(11, hist, w, 2_053, steps, 0.2, **kw)
    torch.cuda.synchronize()
    assert bootstrap_multi_portfolio_dd.launches == before + 1
    p = bootstrap_multi_dd_reference(11, hist, w, 2_053, steps, 0.2, **kw)
    shares = bootstrap_shares(k, p, hist, w, steps)
    assert max(shares.values()) <= 1.0, shares


def test_bootstrap_kernels_select_the_same_rows(dev):
    """One-hot candidates score one asset's row exactly: the candidate
    kernel's terminal is then the plain form's and the terminal kernel's, bit
    for bit — its selection is theirs."""
    from mcport_torch.ops.bootstrap import (bootstrap_multi_dd_reference,
                                            bootstrap_multi_portfolio_dd, bootstrap_terminal)

    hist = _history(365, 15, dev)
    eye = torch.eye(15, device=dev)
    t7, d7 = bootstrap_multi_portfolio_dd(4, hist, eye, 3_001, 252, 0.2, first_block=0,
                                          n_blocks=2)
    p7 = bootstrap_multi_dd_reference(4, hist, eye, 3_001, 252, 0.2, first_block=0,
                                      n_blocks=2)
    t6 = bootstrap_terminal(4, hist, 3_001, 252, 0.2, first_block=0, n_blocks=2)
    assert torch.equal(t7, p7[0]) and torch.equal(d7, p7[1])
    assert torch.equal(t7, t6.transpose(1, 2))


@pytest.mark.parametrize("t_len", [4_000, 8_192])
def test_bootstrap_kernels_read_a_history_beyond_shared_memory(dev, t_len):
    """Past a block's shared memory the history stays in device memory: the
    same rows, so the terminal kernel is its plain form bit for bit and the
    one-hot candidates select the same rows."""
    from mcport_torch.ops.bootstrap import (bootstrap_multi_dd_reference,
                                            bootstrap_multi_portfolio_dd, bootstrap_shares,
                                            bootstrap_terminal, bootstrap_terminal_reference,
                                            history_in_shared)

    hist = _history(t_len, 15, dev)
    assert not history_in_shared(4 * t_len * 15)
    kw = dict(first_block=6, n_blocks=2)
    k = bootstrap_terminal(11, hist, 4_099, 252, 0.2, **kw)
    assert torch.equal(k, bootstrap_terminal_reference(11, hist, 4_099, 252, 0.2, **kw))
    w = torch.from_numpy(np.random.default_rng(1).dirichlet(np.ones(15), 13).astype(
        np.float32)).to(dev)
    kk = bootstrap_multi_portfolio_dd(11, hist, w, 2_053, 60, 0.2, **kw)
    pp = bootstrap_multi_dd_reference(11, hist, w, 2_053, 60, 0.2, **kw)
    assert max(bootstrap_shares(kk, pp, hist, w, 60).values()) <= 1.0
    eye = torch.eye(15, device=dev)
    t7, _ = bootstrap_multi_portfolio_dd(11, hist, eye, 2_053, 60, 0.2, **kw)
    t6 = bootstrap_terminal_reference(11, hist, 2_053, 60, 0.2, **kw)
    assert torch.equal(t7, t6.transpose(1, 2))


# ---- kernel #8: common-jump Merton candidates ---------------------------------------

def _merton(a, dev, mu_j=-0.08, sig_j=0.04):
    """The bench's Merton universe (bench.py): the GBM universe plus jump mean
    -0.08 and jump vol 0.04 per asset."""
    mean, chol, _ = _bench_inputs(a, dev)
    full = torch.full((a,), 1.0, dtype=torch.float32, device=dev)
    return mean, chol, mu_j * full, sig_j * full


@pytest.mark.parametrize("n_cand", [1, 13, 256])
@pytest.mark.parametrize("a, steps", [(15, 252), (15, 7), (1, 9), (64, 8)])
@pytest.mark.parametrize("jump_rate", [0.02, 0.3])
def test_merton_kernel_matches_plain_form(dev, n_cand, a, steps, jump_rate):
    from mcport_torch.ops.jump import (merton_multi_dd_reference, merton_multi_portfolio_dd,
                                       merton_shares)

    mean, chol, muj, sigj = _merton(a, dev)
    w = torch.from_numpy(np.random.default_rng(n_cand).dirichlet(
        np.ones(a), n_cand).astype(np.float32)).to(dev)
    kw = dict(first_block=6, n_blocks=2)
    before = merton_multi_portfolio_dd.launches
    k = merton_multi_portfolio_dd(11, mean, chol, jump_rate, muj, sigj, w, 2_053, steps, **kw)
    torch.cuda.synchronize()
    assert merton_multi_portfolio_dd.launches == before + 1
    p = merton_multi_dd_reference(11, mean, chol, jump_rate, muj, sigj, w, 2_053, steps, **kw)
    shares = merton_shares(k, p, chol, mean, sigj, steps)
    assert max(shares.values()) <= 1.0, shares


def test_merton_kernel_jumps_on_the_plain_forms_steps(dev):
    """Unmissable jumps (sigma_J = 0, mu_J = -0.5, one step): a path that
    jumped loses ~40%, so its drawdown shows the event. The kernel's jumped
    paths are the plain form's, path for path."""
    from mcport_torch.ops.jump import merton_multi_dd_reference, merton_multi_portfolio_dd

    mean, chol, muj, sigj = _merton(15, dev, mu_j=-0.5, sig_j=0.0)
    w = torch.full((1, 15), 1.0 / 15, device=dev)
    kw = dict(first_block=0, n_blocks=3)
    _, dk = merton_multi_portfolio_dd(5, mean, chol, 0.3, muj, sigj, w, 65_537, 1, **kw)
    _, dp = merton_multi_dd_reference(5, mean, chol, 0.3, muj, sigj, w, 65_537, 1, **kw)
    jumped = dp < -0.2
    assert 0.25 < float(jumped.float().mean()) < 0.35
    assert torch.equal(dk < -0.2, jumped)


@pytest.mark.parametrize("n_cand", [1, 256])
def test_merton_kernel_at_zero_rate_is_the_multi_dd_kernel(dev, n_cand):
    """At lambda = 0 no step jumps: the kernel is kernel #3's rebalanced
    float32 output bit for bit (it keeps #3's step code)."""
    from mcport_torch.ops.jump import merton_multi_portfolio_dd
    from mcport_torch.ops.multi_dd import gbm_multi_portfolio_dd

    mean, chol, muj, sigj = _merton(15, dev)
    w = torch.from_numpy(np.random.default_rng(n_cand).dirichlet(
        np.ones(15), n_cand).astype(np.float32)).to(dev)
    kw = dict(first_block=0, n_blocks=2)
    k = merton_multi_portfolio_dd(3, mean, chol, 0.0, muj, sigj, w, 8_192, 252, **kw)
    g = gbm_multi_portfolio_dd(3, mean, chol, w, 8_192, 252, rebalance=True, **kw)
    assert torch.equal(k[0], g[0]) and torch.equal(k[1], g[1])


def test_merton_kernel_more_than_one_launch_of_candidates(dev):
    from mcport_torch.ops.jump import merton_multi_portfolio_dd

    mean, chol, muj, sigj = _merton(15, dev)
    w = torch.from_numpy(np.random.default_rng(4).dirichlet(np.ones(15), 300).astype(
        np.float32)).to(dev)
    before = merton_multi_portfolio_dd.launches
    term, dd = merton_multi_portfolio_dd(1, mean, chol, 0.02, muj, sigj, w, 777, 9)
    assert merton_multi_portfolio_dd.launches == before + 2
    tail = merton_multi_portfolio_dd(1, mean, chol, 0.02, muj, sigj, w[256:], 777, 9)
    assert torch.equal(term[:, 256:], tail[0]) and torch.equal(dd[:, 256:], tail[1])


# ---- kernels #9 and #10: Heston ---------------------------------------------------

def _heston(a, dev, xi=3e-3, seed=0):
    """The bench's Heston universe (bench.py): kappa 0.15, theta 4e-4, rho
    -0.5, v0 4e-4, shock correlation 0.5; xi 3e-3, or a Feller-violating xi
    (0.05) where the truncation binds often."""
    from mcport_torch.convert import heston_params_from_numpy

    rng = np.random.default_rng(seed)
    full = np.ones(a)
    return heston_params_from_numpy(
        rng.normal(1e-3, 5e-4, a), 0.15 * full, 4e-4 * full, xi * full, -0.5 * full,
        4e-4 * full, np.linalg.cholesky(0.5 * np.eye(a) + 0.5), full).tensors(dev)


@pytest.mark.parametrize("a", [1, 7, 15, 16])
@pytest.mark.parametrize("xi", [3e-3, 0.05])
@pytest.mark.parametrize("steps", [252, 7, 5, 1, 0])
def test_heston_terminal_kernel_matches_plain_form(dev, a, xi, steps):
    """The kernel the wrapper routes to, at every tail of a Philox call and
    none, over two blocks of 4,099 paths from block 7: within heston_shares
    of its plain form (whose path state it keeps bit for bit), exactly 0 at
    no step; the 17-64-asset tile at the same width gives the same bits."""
    from mcport_torch.ops.heston import (_launch_terminal, heston_shares, heston_terminal,
                                         heston_terminal_reference)

    h = _heston(a, dev, xi)
    kw = dict(first_block=6, n_blocks=2)
    before = heston_terminal.launches
    k = heston_terminal(11, h, 4_099, steps, **kw)
    torch.cuda.synchronize()
    assert heston_terminal.launches == before + 1
    assert torch.equal(k, _launch_terminal(11, h, 4_099, steps, 6, 2, wide=True))
    if steps == 0:
        assert torch.equal(k, torch.zeros_like(k))
        return
    p = heston_terminal_reference(11, h, 4_099, steps, **kw)
    shares = heston_shares(k, p, h, steps)
    assert max(shares.values()) <= 1.0, shares


@pytest.mark.parametrize("n_cand", [1, 13, 256])
@pytest.mark.parametrize("a, steps", [(15, 252), (15, 7), (1, 9), (16, 8)])
@pytest.mark.parametrize("xi", [3e-3, 0.05])
def test_heston_multi_dd_kernel_matches_plain_form(dev, n_cand, a, steps, xi):
    from mcport_torch.ops.heston import (heston_multi_dd_reference, heston_multi_portfolio_dd,
                                         heston_shares)

    h = _heston(a, dev, xi)
    w = torch.from_numpy(np.random.default_rng(n_cand).dirichlet(
        np.ones(a), n_cand).astype(np.float32)).to(dev)
    kw = dict(first_block=6, n_blocks=2)
    before = heston_multi_portfolio_dd.launches
    k = heston_multi_portfolio_dd(11, h, w, 2_053, steps, **kw)
    torch.cuda.synchronize()
    assert heston_multi_portfolio_dd.launches == before + 1
    p = heston_multi_dd_reference(11, h, w, 2_053, steps, **kw)
    shares = heston_shares(k, p, h, steps)
    assert max(shares.values()) <= 1.0, shares


def test_heston_kernels_agree_on_one_asset(dev):
    """With one asset and the weight 1, the candidate kernel's value is the
    terminal kernel's compounded return, prod exp(x) against expm1(sum x),
    on the same path state."""
    from mcport_torch.ops.heston import heston_multi_portfolio_dd, heston_terminal

    h = _heston(1, dev, 0.05)
    term = heston_terminal(3, h, 8_192, 252, first_block=0, n_blocks=2)
    t10, _ = heston_multi_portfolio_dd(3, h, torch.ones((1, 1), device=dev), 8_192, 252,
                                       first_block=0, n_blocks=2)
    rel = ((t10[:, 0] - term[..., 0]).abs() / (1 + term[..., 0].abs())).max()
    assert float(rel) < 1e-4


def test_heston_kernels_reject_too_many_assets(dev):
    """Past 64 assets the kernels run their wide layout, the path state bit
    for bit (the terminal within heston_shares' four ulps of expm1); only an
    empty universe is refused."""
    from mcport_torch.ops.heston import heston_shares, heston_terminal, heston_terminal_reference

    h = _heston(65, dev, 0.05)
    k = heston_terminal(3, h, 1_029, 52, first_block=6, n_blocks=2)
    p = heston_terminal_reference(3, h, 1_029, 52, first_block=6, n_blocks=2)
    assert max(heston_shares(k, p, h, 52).values()) <= 1.0
    from mcport_torch.ops.gbm import check_card_assets

    with pytest.raises(ValueError, match="at least one asset"):
        check_card_assets(0, "Heston")


# ---- kernels #11-#14: DCC-GARCH -----------------------------------------------------

def _dcc(a, dev, case="bench", seed=0):
    """bench.py's DCC parameters on the GARCH universe (a 0.05, b 0.9, q0 =
    S, e0 = 0); "q0" the non-unit diagonal q0 = S + 0.05 I of
    tests/test_pallas_dcc.py with a large common e0 (3); "frozen" a = 0, b =
    1; "ccc" a = b = 0."""
    from mcport_torch.convert import dcc_params_from_numpy, garch_params_from_numpy

    rng = np.random.default_rng(seed)
    s0 = np.full(a, 4e-4)
    corr = 0.5 * np.eye(a) + 0.5
    base = garch_params_from_numpy(rng.normal(1e-3, 5e-4, a), 0.1 * s0, np.full(a, 0.08),
                                   np.full(a, 0.9), np.linalg.cholesky(corr), s0, s0)
    ab, q0, e0 = {"bench": ((0.05, 0.9), corr, 0.0),
                  "q0": ((0.05, 0.9), corr + 0.05 * np.eye(a), 3.0),
                  "frozen": ((0.0, 1.0), corr, 0.0), "ccc": ((0.0, 0.0), corr, 0.0)}[case]
    return dcc_params_from_numpy(base, ab[0], ab[1], q0, np.full(a, e0)).tensors(dev)


@pytest.mark.parametrize("a", [1, 2, 15, 16])
@pytest.mark.parametrize("case", ["bench", "q0", "frozen"])
@pytest.mark.parametrize("steps", [52, 7])
def test_dcc_terminal_kernel_matches_plain_form(dev, a, case, steps):
    from mcport_torch.ops.dcc import dcc_shares, dcc_terminal, dcc_terminal_reference

    d = _dcc(a, dev, case)
    kw = dict(first_block=6, n_blocks=2)
    before = dcc_terminal.launches
    k = dcc_terminal(11, d, 4_099, steps, **kw)
    torch.cuda.synchronize()
    assert dcc_terminal.launches == before + 1
    p = dcc_terminal_reference(11, d, 4_099, steps, **kw)
    shares = dcc_shares(k, p, d, steps)
    assert max(shares.values()) <= 1.0, shares


@pytest.mark.parametrize("n_cand", [1, 13, 256])
@pytest.mark.parametrize("a, steps", [(15, 52), (15, 7), (1, 9), (2, 8), (16, 8)])
@pytest.mark.parametrize("case", ["bench", "q0"])
def test_dcc_multi_dd_kernel_matches_plain_form(dev, n_cand, a, steps, case):
    from mcport_torch.ops.dcc import dcc_multi_dd_reference, dcc_multi_portfolio_dd, dcc_shares

    d = _dcc(a, dev, case)
    w = torch.from_numpy(np.random.default_rng(n_cand).dirichlet(
        np.ones(a), n_cand).astype(np.float32)).to(dev)
    kw = dict(first_block=6, n_blocks=2)
    before = dcc_multi_portfolio_dd.launches
    k = dcc_multi_portfolio_dd(11, d, w, 2_053, steps, **kw)
    torch.cuda.synchronize()
    assert dcc_multi_portfolio_dd.launches == before + 1
    p = dcc_multi_dd_reference(11, d, w, 2_053, steps, **kw)
    shares = dcc_shares(k, p, d, steps)
    assert max(shares.values()) <= 1.0, shares


@pytest.mark.parametrize("a", [2, 15])
def test_dcc_kernel_without_dynamics_is_the_garch_kernel(dev, a):
    """a = b = 0 and q0 = S: Q_t = S every step and the DCC terminal kernel
    draws CCC-GARCH on kernel #4's shocks, up to the float32 Cholesky of S."""
    from mcport_torch.ops.dcc import dcc_shares, dcc_terminal
    from mcport_torch.ops.garch import garch_terminal

    d = _dcc(a, dev, "ccc")
    k11 = dcc_terminal(5, d, 8_192, 52, first_block=0, n_blocks=2)
    k4 = garch_terminal(5, _garch(a, dev), 8_192, 52, first_block=0, n_blocks=2)
    assert dcc_shares(k11, k4, d, 52)["term"] <= 1.0


def test_dcc_kernels_zero_vol_closed_form(dev):
    from mcport_torch.ops.dcc import dcc_multi_portfolio_dd, dcc_terminal

    d = _dcc(3, dev)
    zero = torch.zeros(3, device=dev)
    mu = torch.tensor([0.01, -0.005, 0.002], device=dev)
    d = d._replace(mu=mu, omega=zero, alpha=zero, beta=zero, sigma2_0=zero, eps2_0=zero)
    want = ((1.0 + mu.double()) ** 6 - 1.0).float()
    term = dcc_terminal(1, d, 300, 6)[0]
    assert float((term - want).abs().max()) <= 3e-7
    t13, dd = dcc_multi_portfolio_dd(1, d, torch.eye(3, device=dev), 300, 6)
    assert float((t13[0] - want[:, None]).abs().max()) <= 3e-7


def test_dcc_kernels_agree_on_one_asset(dev):
    """With one asset R = 1, e = z: the candidate kernel's value with the
    weight 1 is the terminal kernel's compounded gross up to the rounding of
    ``1 + (mu + eps)`` against ``(1 + mu) + eps``."""
    from mcport_torch.ops.dcc import dcc_multi_portfolio_dd, dcc_terminal

    d = _dcc(1, dev, "q0")
    term = dcc_terminal(3, d, 8_192, 52, first_block=0, n_blocks=2)
    t13, _ = dcc_multi_portfolio_dd(3, d, torch.ones((1, 1), device=dev), 8_192, 52,
                                    first_block=0, n_blocks=2)
    rel = ((t13[:, 0] - term[..., 0]).abs() / (1 + term[..., 0].abs())).max()
    assert float(rel) < 1e-4


def test_dcc_multi_dd_kernel_more_than_one_launch_of_candidates(dev):
    from mcport_torch.ops.dcc import dcc_multi_portfolio_dd

    d = _dcc(15, dev)
    w = torch.from_numpy(np.random.default_rng(2).dirichlet(np.ones(15), 300)
                         .astype(np.float32)).to(dev)
    before = dcc_multi_portfolio_dd.launches
    term, dd = dcc_multi_portfolio_dd(1, d, w, 777, 9)
    assert dcc_multi_portfolio_dd.launches == before + 2 and term.shape == (1, 300, 777)
    tail = dcc_multi_portfolio_dd(1, d, w[256:], 777, 9)
    assert torch.equal(term[:, 256:], tail[0]) and torch.equal(dd[:, 256:], tail[1])


def test_dcc_kernels_reject_too_many_assets(dev):
    """Past 64 assets the kernels run their wider layout and meet the same
    bound; only an empty universe is refused."""
    from mcport_torch.ops.dcc import dcc_shares, dcc_terminal, dcc_terminal_reference
    from mcport_torch.ops.gbm import check_card_assets

    d = _dcc(65, dev)
    k = dcc_terminal(3, d, 515, 13, first_block=6, n_blocks=2)
    p = dcc_terminal_reference(3, d, 515, 13, first_block=6, n_blocks=2)
    assert max(dcc_shares(k, p, d, 13).values()) <= 1.0
    with pytest.raises(ValueError, match="at least one asset"):
        check_card_assets(0, "DCC")


# ---- the wide variants: 17 <= A <= 64 -----------------------------------------------

@pytest.mark.parametrize("a", [17, 33, 64])
@pytest.mark.parametrize("t_df", [None, 5.5])
def test_garch_wide_kernels_match_plain_form(dev, a, t_df):
    from mcport_torch.ops.garch import (garch_multi_dd_reference, garch_multi_portfolio_dd,
                                        garch_shares, garch_terminal, garch_terminal_reference)

    g = _garch(a, dev)
    kw = dict(first_block=6, n_blocks=2)
    k = garch_terminal(11, g, 1_029, 52, t_df=t_df, **kw)
    p = garch_terminal_reference(11, g, 1_029, 52, t_df=t_df, **kw)
    assert max(garch_shares(k, p, g, 52, t_df).values()) <= 1.0
    w = torch.from_numpy(np.random.default_rng(a).dirichlet(np.ones(a), 13).astype(
        np.float32)).to(dev)
    kk = garch_multi_portfolio_dd(11, g, w, 1_029, 52, **kw)
    pp = garch_multi_dd_reference(11, g, w, 1_029, 52, with_bound=True, **kw)
    assert max(garch_shares(kk, pp, g, 52).values()) <= 1.0


@pytest.mark.parametrize("a", [17, 33, 64])
@pytest.mark.parametrize("xi", [3e-3, 0.05])
def test_heston_wide_kernels_match_plain_form(dev, a, xi):
    """The wide kernels' path state is the plain form's bit for bit, also
    where the Feller condition fails (xi 0.05): the terminal within
    heston_shares' four ulps of expm1."""
    from mcport_torch.ops.heston import (heston_multi_dd_reference, heston_multi_portfolio_dd,
                                         heston_shares, heston_terminal,
                                         heston_terminal_reference)

    h = _heston(a, dev, xi)
    kw = dict(first_block=6, n_blocks=2)
    k = heston_terminal(11, h, 1_029, 63, **kw)
    p = heston_terminal_reference(11, h, 1_029, 63, **kw)
    assert max(heston_shares(k, p, h, 63).values()) <= 1.0
    w = torch.from_numpy(np.random.default_rng(a).dirichlet(np.ones(a), 13).astype(
        np.float32)).to(dev)
    kk = heston_multi_portfolio_dd(11, h, w, 1_029, 63, **kw)
    pp = heston_multi_dd_reference(11, h, w, 1_029, 63, **kw)
    assert max(heston_shares(kk, pp, h, 63).values()) <= 1.0


@pytest.mark.parametrize("a", [17, 33, 64])
@pytest.mark.parametrize("case", ["bench", "q0", "frozen"])
def test_dcc_wide_kernels_match_plain_form(dev, a, case):
    from mcport_torch.ops.dcc import (dcc_multi_dd_reference, dcc_multi_portfolio_dd,
                                      dcc_shares, dcc_terminal, dcc_terminal_reference)

    d = _dcc(a, dev, case)
    kw = dict(first_block=6, n_blocks=2)
    k = dcc_terminal(11, d, 515, 13, **kw)
    p = dcc_terminal_reference(11, d, 515, 13, **kw)
    assert max(dcc_shares(k, p, d, 13).values()) <= 1.0
    w = torch.from_numpy(np.random.default_rng(a).dirichlet(np.ones(a), 256).astype(
        np.float32)).to(dev)
    kk = dcc_multi_portfolio_dd(11, d, w, 515, 13, **kw)
    pp = dcc_multi_dd_reference(11, d, w, 515, 13, **kw)
    assert max(dcc_shares(kk, pp, d, 13).values()) <= 1.0


# ---- the hedged modes of kernels #3 and #8 --------------------------------------------

def _hedge(a, dev, n_legs=2, seed=0):
    """Every leg type over ``n_legs`` legs per asset, strikes around the spot,
    some premiums, and one qty-0 padding row."""
    from mcport_torch.ops.hedged import HedgeTensors

    rng = np.random.default_rng(seed)
    s0 = rng.uniform(20.0, 200.0, a)
    t = (np.arange(a * n_legs) % 7).reshape(a, n_legs).astype(np.int32)
    k = s0[:, None] * rng.uniform(0.85, 1.15, (a, n_legs))
    prem = s0[:, None] * rng.uniform(0.0, 0.02, (a, n_legs))
    q = rng.uniform(0.2, 1.5, (a, n_legs))
    q[-1, -1] = 0.0
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    return HedgeTensors(f(s0), torch.as_tensor(t, device=dev), f(k), f(prem), f(q))


@pytest.mark.parametrize("n_legs", [1, 2, 3])
@pytest.mark.parametrize("score_dtype", ["float32", "tensorfloat32", "bfloat16"])
@pytest.mark.parametrize("bm, t_df", [("poly", None), ("poly", 5.5)])
def test_multi_dd_hedged_kernel_matches_plain_form(dev, n_legs, score_dtype, bm, t_df):
    from mcport_torch.ops.gbm import t_scaled_chol
    from mcport_torch.ops.multi_dd import (gbm_multi_portfolio_dd, multi_dd_reference,
                                           multi_dd_shares)

    a = 15
    mean, chol, _ = _bench_inputs(a, dev)
    hedge = _hedge(a, dev, n_legs)
    w = torch.from_numpy(np.random.default_rng(2).dirichlet(np.ones(a), 13).astype(
        np.float32)).to(dev)
    kw = dict(first_block=6, n_blocks=2, score_dtype=score_dtype, bm=bm, t_df=t_df)
    before = gbm_multi_portfolio_dd.launches
    k = gbm_multi_portfolio_dd(11, mean, chol, w, 2_053, 60, hedge=hedge, **kw)
    torch.cuda.synchronize()
    assert gbm_multi_portfolio_dd.launches == before + 1
    lk = t_scaled_chol(chol, t_df)
    p = multi_dd_reference(11, mean, lk, w, 2_053, 60, hedge=hedge, with_bound=True, **kw)
    p32 = multi_dd_reference(11, mean, lk, w, 2_053, 60, hedge=hedge,
                             **dict(kw, score_dtype="float32"))
    shares = multi_dd_shares(k, p, p32, lk, mean, 60, True, score_dtype, hedge)
    assert max(shares.values()) <= 1.0, shares


def test_multi_dd_identity_hedge_is_the_rebalanced_mode(dev):
    from mcport_torch.ops.hedged import HedgeTensors
    from mcport_torch.ops.multi_dd import (gbm_multi_portfolio_dd, multi_dd_reference,
                                           multi_dd_shares)
    from mcport_torch.options.hedged import HedgeSpec

    a = 15
    mean, chol, _ = _bench_inputs(a, dev)
    ident = HedgeTensors.from_spec(HedgeSpec.build(None, [str(i) for i in range(a)]),
                                   np.linspace(10.0, 100.0, a), dev)
    w = torch.from_numpy(np.random.default_rng(3).dirichlet(np.ones(a), 256).astype(
        np.float32)).to(dev)
    h = gbm_multi_portfolio_dd(5, mean, chol, w, 4_099, 252, hedge=ident)
    r = gbm_multi_portfolio_dd(5, mean, chol, w, 4_099, 252, rebalance=True)
    bound = multi_dd_reference(5, mean, chol, w, 4_099, 252, hedge=ident, with_bound=True)[2]
    assert max(multi_dd_shares(h, (*r, bound), None, chol, mean, 252, True, "float32",
                               ident).values()) <= 1.0


@pytest.mark.parametrize("n_legs", [1, 3])
@pytest.mark.parametrize("jump_rate", [0.02, 0.3])
def test_merton_hedged_kernel_matches_plain_form(dev, n_legs, jump_rate):
    from mcport_torch.ops.jump import (merton_multi_dd_reference, merton_multi_portfolio_dd,
                                       merton_shares)

    a = 15
    mean, chol, muj, sigj = _merton(a, dev)
    hedge = _hedge(a, dev, n_legs, seed=1)
    w = torch.from_numpy(np.random.default_rng(4).dirichlet(np.ones(a), 256).astype(
        np.float32)).to(dev)
    kw = dict(first_block=6, n_blocks=2, hedge=hedge)
    before = merton_multi_portfolio_dd.launches
    k = merton_multi_portfolio_dd(11, mean, chol, jump_rate, muj, sigj, w, 2_053, 60, **kw)
    torch.cuda.synchronize()
    assert merton_multi_portfolio_dd.launches == before + 1
    p = merton_multi_dd_reference(11, mean, chol, jump_rate, muj, sigj, w, 2_053, 60,
                                  with_bound=True, **kw)
    shares = merton_shares(k, p, chol, mean, sigj, 60, hedge)
    assert max(shares.values()) <= 1.0, shares


def test_merton_hedged_kernel_at_zero_rate_is_the_multi_dd_hedged_kernel(dev):
    from mcport_torch.ops.jump import merton_multi_portfolio_dd
    from mcport_torch.ops.multi_dd import gbm_multi_portfolio_dd

    a = 15
    mean, chol, muj, sigj = _merton(a, dev)
    hedge = _hedge(a, dev, 2, seed=2)
    w = torch.from_numpy(np.random.default_rng(5).dirichlet(np.ones(a), 13).astype(
        np.float32)).to(dev)
    j = merton_multi_portfolio_dd(7, mean, chol, 0.0, muj, sigj, w, 2_053, 60, hedge=hedge)
    m = gbm_multi_portfolio_dd(7, mean, chol, w, 2_053, 60, hedge=hedge)
    assert torch.equal(j[0], m[0]) and torch.equal(j[1], m[1])


@pytest.mark.parametrize("kernel", ["multi_dd", "merton"])
def test_hedged_kernels_carry_overflowed_wealth_as_the_plain_form(dev, kernel):
    """Deep in-the-money puts settled every step overflow the wealth; the
    kernels then give the plain form's inf terminal value and NaN drawdown on
    the same paths, and hold every other path to the bound."""
    from mcport_torch.ops.hedged import HedgeTensors, hedged_held
    from mcport_torch.ops.jump import (merton_multi_dd_reference, merton_multi_portfolio_dd,
                                       merton_shares)
    from mcport_torch.ops.multi_dd import (gbm_multi_portfolio_dd, multi_dd_reference,
                                           multi_dd_shares)

    a = 15
    mean, chol, muj, sigj = _merton(a, dev)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    s0 = np.full(a, 100.0)
    hedge = HedgeTensors(f(s0), torch.full((a, 2), 4, dtype=torch.int32, device=dev),
                         f(np.full((a, 2), 99.0)), f(np.zeros((a, 2))), f(np.full((a, 2), 3.0)))
    w = torch.from_numpy(np.random.default_rng(6).dirichlet(np.ones(a), 13).astype(
        np.float32)).to(dev)
    if kernel == "merton":
        args = (3, mean, chol, 0.3, muj, sigj, w, 2_053, 252)
        k = merton_multi_portfolio_dd(*args, hedge=hedge)
        p = merton_multi_dd_reference(*args, hedge=hedge, with_bound=True)
        shares = merton_shares(k, p, chol, mean, sigj, 252, hedge)
    else:
        k = gbm_multi_portfolio_dd(3, mean, chol, w, 2_053, 252, hedge=hedge)
        p = multi_dd_reference(3, mean, chol, w, 2_053, 252, hedge=hedge, with_bound=True)
        shares = multi_dd_shares(k, p, None, chol, mean, 252, True, "float32", hedge)
    held = hedged_held(k, p)
    assert held["overflowed"] > 0 and held["astray"] == 0, held
    assert max(shares.values()) <= 1.0, (shares, held)


# ---- past 64 assets: the wide layout (csrc/wide.cuh) --------------------------------

def _wide_cand(a, dev, n=13, seed=0):
    return torch.from_numpy(np.random.default_rng(seed + a).dirichlet(np.ones(a), n).astype(
        np.float32)).to(dev)


@pytest.mark.parametrize("a", [65, 200])
@pytest.mark.parametrize("bm, t_df", [("poly", None), ("poly_fast", None), ("poly", 5.5)])
def test_gbm_tier_wide_kernels_match_plain_form(dev, a, bm, t_df):
    """Kernels #1-#3 past 64 assets; #3 with one candidate is #2 bit for bit."""
    from mcport_torch.ops.gbm import gbm_terminal_noise, kernel_tolerance, terminal_noise_reference
    from mcport_torch.ops.multi_dd import (gbm_multi_portfolio_dd, multi_dd_reference,
                                           multi_dd_shares)
    from mcport_torch.ops.path_stats import (gbm_path_stats, path_stats_reference,
                                             path_stats_shares)

    mean, chol, w1 = _bench_inputs(a, dev)
    lk = chol if t_df is None else chol / float(np.sqrt(t_df / (t_df - 2.0)))
    kw = dict(first_block=6, n_blocks=2, bm=bm, t_df=t_df)
    k = gbm_terminal_noise(11, lk, 1_029, 52, **kw)
    assert _within(k, terminal_noise_reference(11, lk, 1_029, 52, **kw),
                   kernel_tolerance(lk, 52))
    for rebalance in (False, True):
        ks = gbm_path_stats(11, mean, chol, w1, 1_029, 52, rebalance=rebalance, **kw)
        ps = path_stats_reference(11, mean, lk, w1, 1_029, 52, rebalance=rebalance, **kw)
        assert max(path_stats_shares(ks, ps, lk, mean, 52).values()) <= 1.0
        one = gbm_multi_portfolio_dd(11, mean, chol, w1[None], 1_029, 52, rebalance=rebalance,
                                     **kw)
        assert torch.equal(one[0][:, 0], ks[1]) and torch.equal(one[1][:, 0], ks[2])
    w = _wide_cand(a, dev)
    for sd in ("float32", "tensorfloat32", "bfloat16"):
        kk = gbm_multi_portfolio_dd(11, mean, chol, w, 1_029, 52, rebalance=True,
                                    score_dtype=sd, **kw)
        pp = multi_dd_reference(11, mean, lk, w, 1_029, 52, rebalance=True, score_dtype=sd,
                                **kw)
        p32 = multi_dd_reference(11, mean, lk, w, 1_029, 52, rebalance=True, **kw)
        assert max(multi_dd_shares(kk, pp, p32, lk, mean, 52, True, sd).values()) <= 1.0


@pytest.mark.parametrize("a", [65, 200])
@pytest.mark.parametrize("jump_rate", [0.0, 0.3])
def test_merton_wide_kernel_matches_plain_form(dev, a, jump_rate):
    """Kernel #8 past 64 assets; at rate 0 kernel #3's rebalanced wide output
    bit for bit."""
    from mcport_torch.ops.jump import (merton_multi_dd_reference, merton_multi_portfolio_dd,
                                       merton_shares)
    from mcport_torch.ops.multi_dd import gbm_multi_portfolio_dd

    mean, chol, muj, sigj = _merton(a, dev)
    w = _wide_cand(a, dev, 256)
    args = (11, mean, chol, jump_rate, muj, sigj, w, 1_029, 52)
    k = merton_multi_portfolio_dd(*args, first_block=6, n_blocks=2)
    if jump_rate == 0.0:
        m = gbm_multi_portfolio_dd(11, mean, chol, w, 1_029, 52, rebalance=True, first_block=6,
                                   n_blocks=2)
        assert torch.equal(k[0], m[0]) and torch.equal(k[1], m[1])
    p = merton_multi_dd_reference(*args, first_block=6, n_blocks=2)
    assert max(merton_shares(k, p, chol, mean, sigj, 52).values()) <= 1.0


@pytest.mark.parametrize("a", [65, 200])
@pytest.mark.parametrize("t_df", [None, 5.5])
def test_garch_wide_layout_matches_plain_form(dev, a, t_df):
    from mcport_torch.ops.garch import (garch_multi_dd_reference, garch_multi_portfolio_dd,
                                        garch_shares, garch_terminal, garch_terminal_reference)

    g = _garch(a, dev)
    kw = dict(first_block=6, n_blocks=2)
    k = garch_terminal(11, g, 1_029, 52, t_df=t_df, **kw)
    p = garch_terminal_reference(11, g, 1_029, 52, t_df=t_df, **kw)
    assert max(garch_shares(k, p, g, 52, t_df).values()) <= 1.0
    w = _wide_cand(a, dev, 256)
    kk = garch_multi_portfolio_dd(11, g, w, 1_029, 52, **kw)
    pp = garch_multi_dd_reference(11, g, w, 1_029, 52, with_bound=True, **kw)
    assert max(garch_shares(kk, pp, g, 52).values()) <= 1.0


@pytest.mark.parametrize("a", [65, 200])
@pytest.mark.parametrize("t_len", [365, 8_192])
def test_bootstrap_wide_layout_is_its_plain_form(dev, a, t_len):
    """Kernels #6 and #7 past 64 assets: the terminal bit for bit, one-hot
    candidates the plain form's rows bit for bit, any weights to the bound."""
    from mcport_torch.ops.bootstrap import (bootstrap_multi_dd_reference,
                                            bootstrap_multi_portfolio_dd, bootstrap_shares,
                                            bootstrap_terminal, bootstrap_terminal_reference)

    hist = _history(t_len, a, dev)
    kw = dict(first_block=6, n_blocks=2)
    k = bootstrap_terminal(11, hist, 1_029, 52, 0.2, **kw)
    p = bootstrap_terminal_reference(11, hist, 1_029, 52, 0.2, **kw)
    assert torch.equal(k, p)
    onehot, _ = bootstrap_multi_portfolio_dd(11, hist, torch.eye(a, device=dev)[:7], 1_029, 52,
                                             0.2, **kw)
    assert torch.equal(onehot, p[..., :7].transpose(1, 2))
    w = _wide_cand(a, dev, 256)
    kk = bootstrap_multi_portfolio_dd(11, hist, w, 1_029, 52, 0.2, **kw)
    pp = bootstrap_multi_dd_reference(11, hist, w, 1_029, 52, 0.2, **kw)
    assert max(bootstrap_shares(kk, pp, hist, w, 52).values()) <= 1.0


@pytest.mark.parametrize("a", [65, 200])
@pytest.mark.parametrize("xi", [3e-3, 0.05])
def test_heston_wide_layout_matches_plain_form(dev, a, xi):
    from mcport_torch.ops.heston import (heston_multi_dd_reference, heston_multi_portfolio_dd,
                                         heston_shares, heston_terminal,
                                         heston_terminal_reference)

    h = _heston(a, dev, xi)
    kw = dict(first_block=6, n_blocks=2)
    k = heston_terminal(11, h, 1_029, 63, **kw)
    p = heston_terminal_reference(11, h, 1_029, 63, **kw)
    assert max(heston_shares(k, p, h, 63).values()) <= 1.0
    w = _wide_cand(a, dev, 256)
    kk = heston_multi_portfolio_dd(11, h, w, 1_029, 63, **kw)
    pp = heston_multi_dd_reference(11, h, w, 1_029, 63, **kw)
    assert max(heston_shares(kk, pp, h, 63).values()) <= 1.0


@pytest.mark.parametrize("a", [65, 200, 256])
@pytest.mark.parametrize("case", ["bench", "q0"])
def test_dcc_wider_kernel_matches_plain_form(dev, a, case):
    """Past 64 assets (at 256 Q leaves shared memory for the scratch)."""
    from mcport_torch.ops.dcc import (dcc_multi_dd_reference, dcc_multi_portfolio_dd,
                                      dcc_shares, dcc_terminal, dcc_terminal_reference)

    d = _dcc(a, dev, case)
    kw = dict(first_block=6, n_blocks=2)
    k = dcc_terminal(11, d, 131, 9, **kw)
    p = dcc_terminal_reference(11, d, 131, 9, **kw)
    assert max(dcc_shares(k, p, d, 9).values()) <= 1.0
    w = _wide_cand(a, dev, 256)
    kk = dcc_multi_portfolio_dd(11, d, w, 131, 9, **kw)
    pp = dcc_multi_dd_reference(11, d, w, 131, 9, **kw)
    assert max(dcc_shares(kk, pp, d, 9).values()) <= 1.0


@pytest.mark.parametrize("a", [15, 65])
def test_gbm_and_merton_hedged_kernels_past_64_assets(dev, a):
    from mcport_torch.ops.jump import (merton_multi_dd_reference, merton_multi_portfolio_dd,
                                       merton_shares)
    from mcport_torch.ops.multi_dd import (gbm_multi_portfolio_dd, multi_dd_reference,
                                           multi_dd_shares)

    mean, chol, muj, sigj = _merton(a, dev)
    hedge = _hedge(a, dev, 2, seed=a)
    w = _wide_cand(a, dev, 256)
    k = gbm_multi_portfolio_dd(11, mean, chol, w, 1_029, 60, hedge=hedge)
    p = multi_dd_reference(11, mean, chol, w, 1_029, 60, hedge=hedge, with_bound=True)
    assert max(multi_dd_shares(k, p, None, chol, mean, 60, True, "float32", hedge).values()) <= 1
    j = merton_multi_portfolio_dd(11, mean, chol, 0.0, muj, sigj, w, 1_029, 60, hedge=hedge)
    assert torch.equal(j[0], k[0]) and torch.equal(j[1], k[1])
    args = (11, mean, chol, 0.3, muj, sigj, w, 1_029, 60)
    k = merton_multi_portfolio_dd(*args, hedge=hedge)
    p = merton_multi_dd_reference(*args, hedge=hedge, with_bound=True)
    assert max(merton_shares(k, p, chol, mean, sigj, 60, hedge).values()) <= 1.0


# ---- the hedged modes of kernels #5 and #7 ----------------------------------------------

@pytest.mark.parametrize("a", [15, 64, 65])
@pytest.mark.parametrize("n_legs", [1, 2, 3])
@pytest.mark.parametrize("n_cand", [1, 13, 256])
def test_garch_hedged_kernel_matches_plain_form(dev, a, n_legs, n_cand):
    from mcport_torch.ops.garch import (garch_multi_dd_reference, garch_multi_portfolio_dd,
                                        garch_shares)

    g = _garch(a, dev)
    hedge = _hedge(a, dev, n_legs, seed=n_legs)
    w = _wide_cand(a, dev, n_cand)
    kw = dict(first_block=6, n_blocks=2, hedge=hedge)
    before = garch_multi_portfolio_dd.hedged_launches
    k = garch_multi_portfolio_dd(11, g, w, 1_029, 60, **kw)
    torch.cuda.synchronize()
    assert garch_multi_portfolio_dd.hedged_launches == before + 1
    p = garch_multi_dd_reference(11, g, w, 1_029, 60, with_bound=True, **kw)
    shares = garch_shares(k, p, g, 60, hedge=hedge)
    assert max(shares.values()) <= 1.0, shares


@pytest.mark.parametrize("a, t_len", [(15, 365), (15, 8_192), (64, 365), (65, 365)])
@pytest.mark.parametrize("n_legs", [1, 2, 3])
@pytest.mark.parametrize("n_cand", [1, 13, 256])
def test_bootstrap_hedged_kernel_matches_plain_form(dev, a, t_len, n_legs, n_cand):
    from mcport_torch.ops.bootstrap import (bootstrap_multi_dd_reference,
                                            bootstrap_multi_portfolio_dd, bootstrap_shares)

    hist = _history(t_len, a, dev)
    hedge = _hedge(a, dev, n_legs, seed=n_legs)
    w = _wide_cand(a, dev, n_cand)
    kw = dict(first_block=6, n_blocks=2, hedge=hedge)
    before = bootstrap_multi_portfolio_dd.hedged_launches
    k = bootstrap_multi_portfolio_dd(11, hist, w, 1_029, 60, 0.2, **kw)
    torch.cuda.synchronize()
    assert bootstrap_multi_portfolio_dd.hedged_launches == before + 1
    p = bootstrap_multi_dd_reference(11, hist, w, 1_029, 60, 0.2, with_bound=True, **kw)
    shares = bootstrap_shares(k, p, hist, w, 60, hedge=hedge)
    assert max(shares.values()) <= 1.0, shares


@pytest.mark.parametrize("a", [15, 65])
def test_bootstrap_hedged_one_hot_candidates_are_the_plain_form(dev, a):
    """One-hot candidates score one asset's settled return exactly: the
    hedged kernel's prices and settlement are the plain form's, bit for bit."""
    from mcport_torch.ops.bootstrap import (bootstrap_multi_dd_reference,
                                            bootstrap_multi_portfolio_dd)

    hist = _history(365, a, dev)
    hedge = _hedge(a, dev, 3, seed=5)
    eye = torch.eye(a, device=dev)[:9]
    k = bootstrap_multi_portfolio_dd(4, hist, eye, 2_053, 60, 0.2, hedge=hedge)
    p = bootstrap_multi_dd_reference(4, hist, eye, 2_053, 60, 0.2, hedge=hedge)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.parametrize("family", ["garch", "bootstrap"])
@pytest.mark.parametrize("a", [15, 65])
def test_identity_hedge_is_the_unhedged_family_mode(dev, family, a):
    from mcport_torch.ops.bootstrap import (bootstrap_multi_dd_reference,
                                            bootstrap_multi_portfolio_dd, bootstrap_shares)
    from mcport_torch.ops.garch import (garch_multi_dd_reference, garch_multi_portfolio_dd,
                                        garch_shares)
    from mcport_torch.ops.hedged import HedgeTensors
    from mcport_torch.options.hedged import HedgeSpec

    ident = HedgeTensors.from_spec(HedgeSpec.build(None, [str(i) for i in range(a)]),
                                   np.linspace(10.0, 100.0, a), dev)
    w = _wide_cand(a, dev, 256)
    if family == "garch":
        g = _garch(a, dev)
        h = garch_multi_portfolio_dd(5, g, w, 2_053, 252, hedge=ident)
        r = garch_multi_portfolio_dd(5, g, w, 2_053, 252)
        bound = garch_multi_dd_reference(5, g, w, 2_053, 252, hedge=ident, with_bound=True)[2]
        shares = garch_shares(h, (*r, bound), g, 252, hedge=ident)
    else:
        hist = _history(365, a, dev)
        h = bootstrap_multi_portfolio_dd(5, hist, w, 2_053, 252, hedge=ident)
        r = bootstrap_multi_portfolio_dd(5, hist, w, 2_053, 252)
        bound = bootstrap_multi_dd_reference(5, hist, w, 2_053, 252, hedge=ident,
                                             with_bound=True)[2]
        shares = bootstrap_shares(h, (*r, bound), hist, w, 252, hedge=ident)
    assert max(shares.values()) <= 1.0, shares


@pytest.mark.parametrize("family", ["garch", "bootstrap"])
def test_family_hedged_kernels_carry_overflowed_wealth(dev, family):
    """Deep in-the-money puts settled every step overflow the wealth; the
    kernels give the plain form's inf and NaN on the same paths."""
    from mcport_torch.ops.bootstrap import (bootstrap_multi_dd_reference,
                                            bootstrap_multi_portfolio_dd, bootstrap_shares)
    from mcport_torch.ops.garch import (garch_multi_dd_reference, garch_multi_portfolio_dd,
                                        garch_shares)
    from mcport_torch.ops.hedged import HedgeTensors, hedged_held

    a = 15
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    hedge = HedgeTensors(f(np.full(a, 100.0)), torch.full((a, 2), 4, dtype=torch.int32,
                                                            device=dev),
                         f(np.full((a, 2), 99.0)), f(np.zeros((a, 2))), f(np.full((a, 2), 3.0)))
    w = _wide_cand(a, dev, 13)
    if family == "garch":
        g = _garch(a, dev)
        k = garch_multi_portfolio_dd(3, g, w, 2_053, 252, hedge=hedge)
        p = garch_multi_dd_reference(3, g, w, 2_053, 252, hedge=hedge, with_bound=True)
        shares = garch_shares(k, p, g, 252, hedge=hedge)
    else:
        hist = _history(365, a, dev)
        k = bootstrap_multi_portfolio_dd(3, hist, w, 2_053, 252, hedge=hedge)
        p = bootstrap_multi_dd_reference(3, hist, w, 2_053, 252, hedge=hedge, with_bound=True)
        shares = bootstrap_shares(k, p, hist, w, 252, hedge=hedge)
    held = hedged_held(k, p)
    assert held["overflowed"] > 0 and held["astray"] == 0 and held["edge"] == 0, held
    assert max(shares.values()) <= 1.0, (shares, held)


# ---- the hedged mode of kernel #10 (Heston) ---------------------------------------------

@pytest.mark.parametrize("a", [15, 17, 64, 65, 200])
@pytest.mark.parametrize("n_legs", [1, 2, 3])
@pytest.mark.parametrize("n_cand", [1, 13, 256])
def test_heston_hedged_kernel_matches_plain_form(dev, a, n_legs, n_cand):
    """Every width: ``heston_dd_kernel<16, true>`` (15), ``<64, true>`` (17,
    64) and ``HestonWide<true, true>`` (65, 200), path by path to the bound
    of ``ops.heston.heston_price_bound``."""
    from mcport_torch.ops.heston import (heston_multi_dd_reference, heston_multi_portfolio_dd,
                                         heston_shares)

    h = _heston(a, dev)
    hedge = _hedge(a, dev, n_legs, seed=n_legs)
    w = _wide_cand(a, dev, n_cand)
    kw = dict(first_block=6, n_blocks=2, hedge=hedge)
    before = (heston_multi_portfolio_dd.hedged_launches, heston_multi_portfolio_dd.wide_launches)
    k = heston_multi_portfolio_dd(11, h, w, 1_029, 60, **kw)
    torch.cuda.synchronize()
    assert heston_multi_portfolio_dd.hedged_launches == before[0] + 1
    assert heston_multi_portfolio_dd.wide_launches == before[1] + int(a > 64)
    p = heston_multi_dd_reference(11, h, w, 1_029, 60, with_bound=True, **kw)
    shares = heston_shares(k, p, h, 60, hedge=hedge)
    assert max(shares.values()) <= 1.0, shares


@pytest.mark.parametrize("a", [15, 17, 65])
def test_heston_entry_points_take_their_arguments(dev, a):
    """The ctypes signatures of ``mcport_heston_multi_dd`` and
    ``mcport_heston_wide`` against the C parameters: a launch of each mode
    through each entry point (the <16> and <64> kernels at 15 assets, <64>
    at 17, the wide layout at 65), hedged at 252 steps against the plain
    form, unhedged and the terminal function to ``heston_tolerance``; a hedge
    for another width is refused."""
    from mcport_torch.ops.heston import (_launch_dd, heston_multi_dd_reference, heston_shares,
                                         heston_terminal, heston_terminal_reference)

    h = _heston(a, dev, seed=a)
    k = heston_terminal(5, h, 517, 252, first_block=2, n_blocks=2)
    p = heston_terminal_reference(5, h, 517, 252, first_block=2, n_blocks=2)
    assert max(heston_shares(k, p, h, 252).values()) <= 1.0
    hedge = _hedge(a, dev, 2, seed=a)
    w = _wide_cand(a, dev, 13)
    for wide in ((False, True) if a <= 16 else (False,)):
        k = _launch_dd(5, h, w, 517, 252, 2, 2, wide=wide, hedge=hedge)
        p = heston_multi_dd_reference(5, h, w, 517, 252, first_block=2, n_blocks=2,
                                      hedge=hedge, with_bound=True)
        assert max(heston_shares(k, p, h, 252, hedge=hedge).values()) <= 1.0
        k = _launch_dd(5, h, w, 517, 252, 2, 2, wide=wide)
        p = heston_multi_dd_reference(5, h, w, 517, 252, first_block=2, n_blocks=2)
        assert max(heston_shares(k, p, h, 252).values()) <= 1.0
    with pytest.raises(ValueError, match="hedge must cover"):
        from mcport_torch.ops.heston import heston_multi_portfolio_dd
        heston_multi_portfolio_dd(5, h, w, 517, 8, hedge=_hedge(a + 1, dev, 2))


@pytest.mark.parametrize("a", [15, 65])
@pytest.mark.parametrize("xi", [3e-3, 0.05])
def test_heston_identity_hedge_is_the_unhedged_mode(dev, a, xi):
    """One BUY_ASSET leg per asset: the unhedged mode to the per-path bound,
    also at a Feller-violating vol of vol (0.05), where a variance path one
    ulp off the unhedged one would grow to O(1) in 252 steps: the hedged
    template keeps every rounding of heston_step."""
    from mcport_torch.ops.hedged import HedgeTensors
    from mcport_torch.ops.heston import (heston_multi_dd_reference, heston_multi_portfolio_dd,
                                         heston_shares)
    from mcport_torch.options.hedged import HedgeSpec

    h = _heston(a, dev, xi=xi)
    ident = HedgeTensors.from_spec(HedgeSpec.build(None, [str(i) for i in range(a)]),
                                   np.linspace(10.0, 100.0, a), dev)
    w = _wide_cand(a, dev, 256)
    hk = heston_multi_portfolio_dd(5, h, w, 2_053, 252, hedge=ident)
    r = heston_multi_portfolio_dd(5, h, w, 2_053, 252)
    bound = heston_multi_dd_reference(5, h, w, 2_053, 252, hedge=ident, with_bound=True)[2]
    shares = heston_shares(hk, (*r, bound), h, 252, hedge=ident)
    assert max(shares.values()) <= 1.0, shares


def test_heston_hedged_kernel_carries_overflowed_wealth(dev):
    """Deep in-the-money puts settled every step overflow the wealth; the
    kernel gives the plain form's inf and NaN on the same paths."""
    from mcport_torch.ops.hedged import HedgeTensors, hedged_held
    from mcport_torch.ops.heston import (heston_multi_dd_reference, heston_multi_portfolio_dd,
                                         heston_shares)

    a = 15
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    hedge = HedgeTensors(f(np.full(a, 100.0)), torch.full((a, 2), 4, dtype=torch.int32,
                                                            device=dev),
                         f(np.full((a, 2), 99.0)), f(np.zeros((a, 2))), f(np.full((a, 2), 3.0)))
    h = _heston(a, dev)
    w = _wide_cand(a, dev, 13)
    k = heston_multi_portfolio_dd(3, h, w, 2_053, 252, hedge=hedge)
    p = heston_multi_dd_reference(3, h, w, 2_053, 252, hedge=hedge, with_bound=True)
    held = hedged_held(k, p)
    assert held["overflowed"] > 0 and held["astray"] == 0, held
    assert max(heston_shares(k, p, h, 252, hedge=hedge).values()) <= 1.0, (held,)


# ---- the hedged mode of kernel #13 (DCC) ------------------------------------------------

@pytest.mark.parametrize("a", [4, 15, 16, 17, 64, 65, 256])
@pytest.mark.parametrize("n_legs", [1, 3])
@pytest.mark.parametrize("n_cand", [1, 5, 256, 257])
def test_dcc_hedged_kernel_matches_plain_form(dev, a, n_legs, n_cand):
    """Every width: ``dcc_dd_kernel<true>`` (4, 15, 16) and ``dcc_group_kernel``
    hedged (17, 64, 65; 256, where Q leaves shared memory), W past one
    launch's 256, path by path to the bound of ``ops.dcc.dcc_price_bound``."""
    from mcport_torch.ops.dcc import dcc_multi_dd_reference, dcc_multi_portfolio_dd, dcc_shares

    d = _dcc(a, dev)
    hedge = _hedge(a, dev, n_legs, seed=n_legs)
    w = _wide_cand(a, dev, n_cand)
    paths, steps = (131, 16) if a > 64 else (1_029, 52)
    kw = dict(first_block=6, n_blocks=2, hedge=hedge)
    before = (dcc_multi_portfolio_dd.hedged_launches, dcc_multi_portfolio_dd.wide_launches)
    k = dcc_multi_portfolio_dd(11, d, w, paths, steps, **kw)
    torch.cuda.synchronize()
    chunks = -(-n_cand // 256)
    assert dcc_multi_portfolio_dd.hedged_launches == before[0] + chunks
    assert dcc_multi_portfolio_dd.wide_launches == before[1] + chunks * int(a > 64)
    p = dcc_multi_dd_reference(11, d, w, paths, steps, with_bound=True, **kw)
    shares = dcc_shares(k, p, d, steps, hedge=hedge)
    assert max(shares.values()) <= 1.0, shares


#: dcc_group_kernel's widths: each group size's edges (32, 64, 128 threads per
#: path), widths off the 4-column panels, and each side of where Q (221) and
#: the factor (293) leave shared memory
DCC_GROUP_A = [17, 31, 32, 33, 47, 63, 64, 65, 97, 128, 129, 220, 221, 255, 256, 292, 293]


@pytest.mark.parametrize("a", DCC_GROUP_A)
@pytest.mark.parametrize("fn", ["terminal", "candidates", "hedged"])
def test_dcc_group_kernel_matches_plain_form(dev, a, fn):
    """``dcc_group_kernel`` against the plain forms under today's bounds: the
    terminal function to ``dcc_shares``, the candidates at W = 1, 64, 256 and
    257 (two launches) to ``dcc_shares``, and the hedged mode (two legs per
    asset of every type) path by path to ``dcc_price_bound``, on two blocks
    of a ragged path count."""
    from mcport_torch.ops.dcc import (dcc_multi_dd_reference, dcc_multi_portfolio_dd,
                                      dcc_shares, dcc_terminal, dcc_terminal_reference,
                                      dcc_wide_plan)

    d = _dcc(a, dev, "q0" if a % 2 else "bench")
    paths, steps = (515, 13) if a <= 64 else (131, 9)
    kw = dict(first_block=6, n_blocks=2)
    plan = dcc_wide_plan(a, fn == "hedged")
    assert plan.q_shared == (a <= 220) and plan.w_shared == (a <= 292)
    if fn == "terminal":
        before = (dcc_terminal.launches, dcc_terminal.wide_launches)
        k = dcc_terminal(11, d, paths, steps, **kw)
        torch.cuda.synchronize()
        assert (dcc_terminal.launches, dcc_terminal.wide_launches) == (
            before[0] + 1, before[1] + int(a > 64))
        p = dcc_terminal_reference(11, d, paths, steps, **kw)
        assert max(dcc_shares(k, p, d, steps).values()) <= 1.0
        return
    hedge = _hedge(a, dev, 2, seed=a) if fn == "hedged" else None
    for n_cand in (1, 64, 256, 257):
        w = _wide_cand(a, dev, n_cand)
        before = (dcc_multi_portfolio_dd.launches, dcc_multi_portfolio_dd.hedged_launches)
        k = dcc_multi_portfolio_dd(11, d, w, paths, steps, hedge=hedge, **kw)
        torch.cuda.synchronize()
        chunks = -(-n_cand // 256)
        assert dcc_multi_portfolio_dd.launches == before[0] + chunks
        assert dcc_multi_portfolio_dd.hedged_launches == before[1] + chunks * int(hedge is not None)
        p = dcc_multi_dd_reference(11, d, w, paths, steps, hedge=hedge,
                                   with_bound=hedge is not None, **kw)
        shares = dcc_shares(k, p, d, steps, hedge=hedge)
        assert max(shares.values()) <= 1.0, (n_cand, shares)


@pytest.mark.parametrize("a", [17, 221, 293])
def test_dcc_group_kernel_takes_its_scratch(dev, a):
    """``mcport_dcc_wide`` refuses a scratch smaller than one CTA's slot (and
    a null one) where Q leaves shared memory, needs none where it stays, and
    launches no more CTAs than the scratch has slots for: one slot gives the
    wrapper's result on the same paths."""
    from mcport_torch._build import library
    from mcport_torch.ops.dcc import dcc_terminal, dcc_wide_plan

    lib = library("dcc")
    d = _dcc(a, dev)
    plan = dcc_wide_plan(a, False)
    out = torch.empty((1, 33, a), device=dev)
    params = d.packed()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(scratch, floats):
        return lib.mcport_dcc_wide(3, -1, 1, 33, a, 0, 5, 0, params.data_ptr(), None, None,
                                   out.data_ptr(), None,
                                   scratch.data_ptr() if scratch is not None else None, floats,
                                   stream)

    if plan.slot_floats == 0:
        assert launch(None, 0) == 0
    else:
        one = torch.empty(plan.slot_floats, device=dev)
        assert launch(None, plan.slot_floats) != 0
        assert launch(one, plan.slot_floats - 1) != 0
        assert launch(one, plan.slot_floats) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, dcc_terminal(3, d, 33, 5))


@pytest.mark.parametrize("a", [15, 17, 65])
def test_dcc_entry_points_take_their_arguments(dev, a):
    """The ctypes signatures of ``mcport_dcc_multi_dd`` and ``mcport_dcc_wide``
    against the C parameters: each mode through its entry point, hedged at
    252 steps against the plain form, unhedged and the terminal function to
    ``dcc_tolerance``; a hedge for another width is refused."""
    from mcport_torch.ops.dcc import (_launch_dd, dcc_multi_dd_reference, dcc_multi_portfolio_dd,
                                      dcc_shares, dcc_terminal, dcc_terminal_reference)

    d = _dcc(a, dev, seed=a)
    k = dcc_terminal(5, d, 517, 60, first_block=2, n_blocks=2)
    p = dcc_terminal_reference(5, d, 517, 60, first_block=2, n_blocks=2)
    assert max(dcc_shares(k, p, d, 60).values()) <= 1.0
    hedge = _hedge(a, dev, 2, seed=a)
    w = _wide_cand(a, dev, 13)
    steps = 252 if a <= 64 else 16
    k = _launch_dd(5, d, w, 517, steps, 2, 2, hedge=hedge)
    p = dcc_multi_dd_reference(5, d, w, 517, steps, first_block=2, n_blocks=2, hedge=hedge,
                               with_bound=True)
    assert max(dcc_shares(k, p, d, steps, hedge=hedge).values()) <= 1.0
    k = _launch_dd(5, d, w, 517, steps, 2, 2)
    p = dcc_multi_dd_reference(5, d, w, 517, steps, first_block=2, n_blocks=2)
    assert max(dcc_shares(k, p, d, steps).values()) <= 1.0
    with pytest.raises(ValueError, match="hedge must cover"):
        dcc_multi_portfolio_dd(5, d, w, 517, 8, hedge=_hedge(a + 1, dev, 2))


@pytest.mark.parametrize("a", [15, 17, 65])
def test_dcc_identity_hedge_is_the_unhedged_mode(dev, a):
    """One BUY_ASSET leg per asset settles to the asset's return: the
    unhedged kernel on the same draws and recursion, within the hedged
    bound."""
    from mcport_torch.ops.dcc import dcc_multi_dd_reference, dcc_multi_portfolio_dd, dcc_shares
    from mcport_torch.ops.hedged import HedgeTensors
    from mcport_torch.options.hedged import HedgeSpec

    d = _dcc(a, dev)
    ident = HedgeTensors.from_spec(HedgeSpec.build(None, [str(i) for i in range(a)]),
                                   np.linspace(10.0, 100.0, a), dev)
    w = _wide_cand(a, dev, 256)
    paths, steps = (515, 16) if a > 64 else (2_053, 252)
    h = dcc_multi_portfolio_dd(5, d, w, paths, steps, hedge=ident)
    r = dcc_multi_portfolio_dd(5, d, w, paths, steps)
    bound = dcc_multi_dd_reference(5, d, w, paths, steps, hedge=ident, with_bound=True)[2]
    shares = dcc_shares(h, (*r, bound), d, steps, hedge=ident)
    assert max(shares.values()) <= 1.0, shares


def test_dcc_hedged_kernel_carries_overflowed_wealth(dev):
    """Deep in-the-money puts settled every step overflow the wealth; the
    kernel gives the plain form's inf and NaN on the same paths."""
    from mcport_torch.ops.dcc import dcc_multi_dd_reference, dcc_multi_portfolio_dd, dcc_shares
    from mcport_torch.ops.hedged import HedgeTensors, hedged_held

    a = 15
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    hedge = HedgeTensors(f(np.full(a, 100.0)), torch.full((a, 2), 4, dtype=torch.int32,
                                                            device=dev),
                         f(np.full((a, 2), 99.0)), f(np.zeros((a, 2))), f(np.full((a, 2), 3.0)))
    d = _dcc(a, dev)
    w = _wide_cand(a, dev, 13)
    k = dcc_multi_portfolio_dd(3, d, w, 2_053, 252, hedge=hedge)
    p = dcc_multi_dd_reference(3, d, w, 2_053, 252, hedge=hedge, with_bound=True)
    held = hedged_held(k, p)
    assert held["overflowed"] > 0 and held["astray"] == 0, held
    assert max(dcc_shares(k, p, d, 252, hedge=hedge).values()) <= 1.0, (held,)


# ---- the narrow DCC candidate kernel's layouts (dcc_dd_kernel, A <= 16) ----------------

#: each side of every layout switch of ``ops.dcc.dcc_narrow_plan``: solo up to 4
#: candidates, split past them, its scoring blocks of 512, 256, 128, 64, 32 and
#: 16 paths
DCC_NARROW_W = [1, 2, 3, 4, 5, 16, 17, 64, 255, 256]


@pytest.mark.parametrize("a", [1, 2, 7, 15, 16])
@pytest.mark.parametrize("n_cand", DCC_NARROW_W)
@pytest.mark.parametrize("steps", [0, 1, 5, 52])
def test_dcc_narrow_kernel_layouts_match_plain_form(dev, a, n_cand, steps):
    """``dcc_dd_kernel`` in the layout its W picks, unhedged within
    ``dcc_shares`` and hedged (one and two legs per asset, every leg type)
    path by path within ``dcc_price_bound``, on two blocks of 1,029 paths (a
    multiple of neither the 64-path recursion blocks nor the 16-path tiles);
    q0 off S with a large e0 on odd widths; every call one launch. At 0
    steps every output is the plain form's 0 exactly."""
    from mcport_torch.ops.dcc import dcc_multi_dd_reference, dcc_multi_portfolio_dd, dcc_shares

    d = _dcc(a, dev, "q0" if a % 2 else "bench", seed=a)
    w = _wide_cand(a, dev, n_cand)
    kw = dict(first_block=6, n_blocks=2)
    for hedge in (None, _hedge(a, dev, 1, seed=n_cand), _hedge(a, dev, 2, seed=steps)):
        before = (dcc_multi_portfolio_dd.launches, dcc_multi_portfolio_dd.hedged_launches)
        k = dcc_multi_portfolio_dd(11, d, w, 1_029, steps, hedge=hedge, **kw)
        torch.cuda.synchronize()
        assert dcc_multi_portfolio_dd.launches == before[0] + 1
        assert dcc_multi_portfolio_dd.hedged_launches == before[1] + int(hedge is not None)
        p = dcc_multi_dd_reference(11, d, w, 1_029, steps, hedge=hedge,
                                   with_bound=hedge is not None, **kw)
        if steps == 0:   # nothing moves: the plain form's zeros exactly (its bound is 0)
            assert all(torch.equal(x, y) for x, y in zip(k, p[:2]))
            assert not bool(k[0].any()) and not bool(k[1].any())
            continue
        shares = dcc_shares(k, p, d, steps, hedge=hedge)
        assert max(shares.values()) <= 1.0, (hedge is not None, shares)


@pytest.mark.parametrize("n_cand, hedged", [(17, False), (256, True), (5, True)])
def test_dcc_narrow_kernel_chunks_its_scratch(dev, n_cand, hedged):
    """Past 4 candidates ``mcport_dcc_multi_dd`` takes its returns through the
    scratch it is given, in chunks of 64 paths where the scratch holds fewer
    than all: one chunk's scratch and a ragged one give the wrapper's outputs
    bit for bit; a null scratch, or one smaller than a chunk, is refused."""
    from mcport_torch._build import library
    from mcport_torch.ops.dcc import dcc_multi_portfolio_dd

    lib = library("dcc")
    a, paths, steps, nb = 15, 300, 13, 2
    d = _dcc(a, dev, seed=n_cand)
    w = _wide_cand(a, dev, n_cand)
    hedge = _hedge(a, dev, 2, seed=n_cand) if hedged else None
    want = dcc_multi_portfolio_dd(3, d, w, paths, steps, first_block=1, n_blocks=nb, hedge=hedge)
    params, block = d.packed(), hedge.packed() if hedged else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    chunk = nb * steps * a * 64

    def launch(scratch, floats):
        term = torch.full((nb, n_cand, paths), -9.0, device=dev)
        dd = torch.full_like(term, -9.0)
        err = lib.mcport_dcc_multi_dd(3, 1, nb, paths, a, n_cand, steps, 2 if hedged else 0,
                                      params.data_ptr(), w.data_ptr(),
                                      block.data_ptr() if hedged else None, term.data_ptr(),
                                      dd.data_ptr(),
                                      scratch.data_ptr() if scratch is not None else None,
                                      floats, stream)
        torch.cuda.synchronize()
        return err, (term, dd)

    scratch = torch.empty(2 * chunk + 7, device=dev)
    for floats in (chunk, 2 * chunk + 7):
        err, got = launch(scratch, floats)
        assert err == 0 and all(torch.equal(x, y) for x, y in zip(got, want)), floats
    assert launch(None, chunk)[0] != 0
    assert launch(scratch, chunk - 1)[0] != 0


# ---- the Merton (#8) and Heston (#10) candidate kernels' layouts up to 16 assets -----------

#: each side of every layout switch of ``ops.jump.merton_narrow_plan`` (solo up to
#: 10 candidates, split past them) and ``ops.heston.heston_narrow_plan`` (solo up to
#: 12, split up to 128, tile past it), and 256
GROSS_NARROW_W = [1, 10, 11, 12, 13, 128, 129, 256]


def _named_layouts(plan, a, n_cand, hedge):
    """The layouts by name whose blocks an H100's shared memory holds here."""
    names = []
    for layout in ("solo", "split", "tile"):
        try:
            plan(a, n_cand, 52, 1_029, 2, hedge.n_legs if hedge is not None else 0,
                 layout=layout)
        except ValueError:
            continue
        names.append(layout)
    return names


def _same(x, y):
    return all(torch.equal(p, q) for p, q in zip(x, y))


@pytest.mark.parametrize("a", [1, 7, 15, 16])
@pytest.mark.parametrize("n_cand", GROSS_NARROW_W)
def test_merton_narrow_layouts_match_plain_form(dev, a, n_cand):
    """The jump kernel in the layout its W picks, within ``merton_shares``
    of the plain form (hedged with two legs per asset of every type, path by
    path), and in every layout by name bit for bit with it; two blocks of
    1,029 paths (a multiple of no block or tile), 52 steps, rate 0.3."""
    from mcport_torch.ops.jump import (_launch, merton_multi_dd_reference,
                                       merton_multi_portfolio_dd, merton_narrow_plan,
                                       merton_shares)

    mean, chol, muj, sigj = _merton(a, dev)
    params = torch.cat([chol.reshape(-1), mean, muj, sigj]).contiguous()
    w = _wide_cand(a, dev, n_cand)
    kw = dict(first_block=6, n_blocks=2)
    for hedge in (None, _hedge(a, dev, 2, seed=n_cand)):
        before = merton_multi_portfolio_dd.launches
        k = merton_multi_portfolio_dd(11, mean, chol, 0.3, muj, sigj, w, 1_029, 52, hedge=hedge,
                                      **kw)
        torch.cuda.synchronize()
        assert merton_multi_portfolio_dd.launches == before + 1
        for layout in _named_layouts(merton_narrow_plan, a, n_cand, hedge):
            assert _same(_launch(11, params, w, a, 1_029, 52, 6, 2, 0.3, hedge, layout), k), layout
        p = merton_multi_dd_reference(11, mean, chol, 0.3, muj, sigj, w, 1_029, 52, hedge=hedge,
                                      with_bound=hedge is not None, **kw)
        shares = merton_shares(k, p, chol, mean, sigj, 52, hedge)
        assert max(shares.values()) <= 1.0, (hedge is not None, shares)


@pytest.mark.parametrize("a", [1, 7, 15, 16])
@pytest.mark.parametrize("n_cand", GROSS_NARROW_W)
def test_heston_narrow_layouts_match_plain_form(dev, a, n_cand):
    """The Heston candidate kernel in the layout its W picks, within
    ``heston_shares`` of the plain form (hedged with two legs per asset of
    every type, path by path), and in every layout by name bit for bit with
    it; at the bench's vol of vol and at a Feller-violating one (0.05), where
    a path state one ulp off the plain form's would grow to O(1) in 52 steps
    and leave the bound; two blocks of 1,029 paths, 52 steps."""
    from mcport_torch.ops.heston import (_launch_dd, heston_multi_dd_reference,
                                         heston_multi_portfolio_dd, heston_narrow_plan,
                                         heston_shares)

    w = _wide_cand(a, dev, n_cand)
    kw = dict(first_block=6, n_blocks=2)
    for xi in (3e-3, 0.05):
        h = _heston(a, dev, xi, seed=a)
        for hedge in (None, _hedge(a, dev, 2, seed=n_cand)):
            before = heston_multi_portfolio_dd.launches
            k = heston_multi_portfolio_dd(11, h, w, 1_029, 52, hedge=hedge, **kw)
            torch.cuda.synchronize()
            assert heston_multi_portfolio_dd.launches == before + 1
            for layout in _named_layouts(heston_narrow_plan, a, n_cand, hedge):
                got = _launch_dd(11, h, w, 1_029, 52, 6, 2, hedge=hedge, layout=layout)
                assert _same(got, k), (xi, layout)
            p = heston_multi_dd_reference(11, h, w, 1_029, 52, hedge=hedge,
                                          with_bound=hedge is not None, **kw)
            shares = heston_shares(k, p, h, 52, hedge=hedge)
            assert max(shares.values()) <= 1.0, (xi, hedge is not None, shares)


@pytest.mark.parametrize("n_cand", [1, 11, 256])
@pytest.mark.parametrize("hedged", [False, True])
def test_merton_narrow_layouts_at_zero_rate_are_the_multi_dd_kernel(dev, n_cand, hedged):
    """At lambda = 0 every layout of the jump kernel is kernel #3's
    rebalanced output bit for bit, hedged too."""
    from mcport_torch.ops.jump import _launch, merton_narrow_plan
    from mcport_torch.ops.multi_dd import gbm_multi_portfolio_dd

    a = 15
    mean, chol, muj, sigj = _merton(a, dev)
    params = torch.cat([chol.reshape(-1), mean, muj, sigj]).contiguous()
    w = _wide_cand(a, dev, n_cand, seed=3)
    hedge = _hedge(a, dev, 2, seed=2) if hedged else None
    want = gbm_multi_portfolio_dd(7, mean, chol, w, 2_053, 60, rebalance=True, hedge=hedge,
                                  first_block=0, n_blocks=2)
    for layout in _named_layouts(merton_narrow_plan, a, n_cand, hedge):
        assert _same(_launch(7, params, w, a, 2_053, 60, 0, 2, 0.0, hedge, layout), want), layout


@pytest.mark.parametrize("family", ["jump", "heston", "garch", "bootstrap"])
@pytest.mark.parametrize("n_cand, hedged", [(17, False), (256, True), (64, True)])
def test_narrow_split_layout_chunks_its_scratch(dev, family, n_cand, hedged):
    """The split layout takes its returns through the scratch it is given, in
    chunks of a recursion block's paths (64, the bootstrap's 128) where the
    scratch holds fewer than all: one chunk's scratch and a ragged one give
    the wrapper's outputs bit for bit; a null scratch, or one smaller than a
    chunk, is refused."""
    from mcport_torch._build import library
    from mcport_torch.ops.bootstrap import bootstrap_multi_portfolio_dd
    from mcport_torch.ops.garch import garch_multi_portfolio_dd
    from mcport_torch.ops.heston import heston_multi_portfolio_dd
    from mcport_torch.ops.jump import merton_multi_portfolio_dd

    a, paths, steps, nb = 15, 300, 13, 2
    w = _wide_cand(a, dev, n_cand, seed=n_cand)
    hedge = _hedge(a, dev, 2, seed=n_cand) if hedged else None
    n_legs = 2 if hedged else 0
    kw = dict(first_block=1, n_blocks=nb, hedge=hedge)
    if family == "jump":
        mean, chol, muj, sigj = _merton(a, dev)
        want = merton_multi_portfolio_dd(3, mean, chol, 0.3, muj, sigj, w, paths, steps, **kw)
        params = torch.cat([chol.reshape(-1), mean, muj, sigj]).contiguous()
    elif family == "heston":
        h = _heston(a, dev, 0.05)
        want = heston_multi_portfolio_dd(3, h, w, paths, steps, **kw)
        params = h.packed()
    elif family == "garch":
        g = _garch(a, dev)
        want = garch_multi_portfolio_dd(3, g, w, paths, steps, **kw)
        params = g.packed(g.corr_chol)
    else:
        params = _history(365, a, dev)
        want = bootstrap_multi_portfolio_dd(3, params, w, paths, steps, 0.2, **kw)
    block = hedge.packed() if hedged else None
    lib = library(family)
    stream = torch.cuda.current_stream(dev).cuda_stream
    chunk = nb * steps * a * (128 if family == "bootstrap" else 64)

    def launch(scratch, floats):
        term = torch.full((nb, n_cand, paths), -9.0, device=dev)
        dd = torch.full_like(term, -9.0)
        ptrs = (params.data_ptr(), w.data_ptr(), block.data_ptr() if hedged else None,
                term.data_ptr(), dd.data_ptr(),
                scratch.data_ptr() if scratch is not None else None, floats, 1, stream)
        if family == "jump":
            err = lib.mcport_merton_multi_dd(3, 1, nb, paths, a, n_cand, steps, n_legs, 0.3,
                                             *ptrs)
        elif family == "heston":
            err = lib.mcport_heston_multi_dd(3, 1, nb, paths, a, n_cand, steps, 0, n_legs, *ptrs)
        elif family == "garch":
            err = lib.mcport_garch_multi_dd(3, 1, nb, paths, a, n_cand, steps, 0, n_legs, *ptrs)
        else:   # the 365-row history in the walk's shared memory
            err = lib.mcport_bootstrap_multi_dd(3, 1, nb, paths, 365, a, n_cand, steps, n_legs,
                                                0.2, 1, *ptrs)
        torch.cuda.synchronize()
        return err, (term, dd)

    scratch = torch.empty(2 * chunk + 7, device=dev)
    for floats in (chunk, 2 * chunk + 7):
        err, got = launch(scratch, floats)
        assert err == 0 and _same(got, want), floats
    assert launch(None, chunk)[0] != 0
    assert launch(scratch, chunk - 1)[0] != 0


# ---- the GARCH (#5) and bootstrap (#7) candidate kernels' layouts up to 16 assets ---------

#: each side of every layout switch of ``ops.garch.garch_narrow_plan`` (solo up to
#: 13 candidates, split past them) and ``ops.bootstrap.bootstrap_narrow_plan``
#: (solo up to 22, 14 hedged, split past them), and 256
SIMPLE_NARROW_W = [1, 13, 14, 15, 22, 23, 256]


@pytest.mark.parametrize("a", [1, 7, 15, 16])
@pytest.mark.parametrize("n_cand", SIMPLE_NARROW_W)
def test_garch_narrow_layouts_match_plain_form(dev, a, n_cand):
    """The GARCH candidate kernel in the layout its W picks, within
    ``garch_shares`` of the plain form (hedged with two legs per asset of
    every type, path by path), and in every layout by name bit for bit with
    it; two blocks of 1,029 paths (a multiple of no block or tile), 52
    steps."""
    from mcport_torch.ops.garch import (_launch_dd, garch_multi_dd_reference,
                                        garch_multi_portfolio_dd, garch_narrow_plan,
                                        garch_shares)

    g = _garch(a, dev)
    w = _wide_cand(a, dev, n_cand)
    kw = dict(first_block=6, n_blocks=2)
    for hedge in (None, _hedge(a, dev, 2, seed=n_cand)):
        before = garch_multi_portfolio_dd.launches
        k = garch_multi_portfolio_dd(11, g, w, 1_029, 52, hedge=hedge, **kw)
        torch.cuda.synchronize()
        assert garch_multi_portfolio_dd.launches == before + 1
        for layout in _named_layouts(garch_narrow_plan, a, n_cand, hedge):
            got = _launch_dd(11, g, w, 1_029, 52, 6, 2, hedge=hedge, layout=layout)
            assert _same(got, k), layout
        p = garch_multi_dd_reference(11, g, w, 1_029, 52, hedge=hedge, with_bound=True, **kw)
        shares = garch_shares(k, p, g, 52, hedge=hedge)
        assert max(shares.values()) <= 1.0, (hedge is not None, shares)


@pytest.mark.parametrize("a", [1, 7, 15, 16])
@pytest.mark.parametrize("n_cand", SIMPLE_NARROW_W)
@pytest.mark.parametrize("t_len", [365, 8_192])
def test_bootstrap_narrow_layouts_match_plain_form(dev, a, n_cand, t_len):
    """The bootstrap candidate kernel in the layout its W picks, within
    ``bootstrap_shares`` of the plain form (hedged with two legs per asset of
    every type, path by path: the prices and settled returns are the plain
    form's bit for bit), and in every layout by name bit for bit with it;
    the history in the layouts' shared memory (365 rows) or in device memory
    (8,192); two blocks of 1,029 paths, 52 steps."""
    from mcport_torch.ops.bootstrap import (_launch_dd, bootstrap_multi_dd_reference,
                                            bootstrap_multi_portfolio_dd,
                                            bootstrap_narrow_plan, bootstrap_shares)

    hist = _history(t_len, a, dev)
    w = _wide_cand(a, dev, n_cand)
    kw = dict(first_block=6, n_blocks=2)

    def plan(a, w, *args, **k):
        return bootstrap_narrow_plan(a, w, t_len, *args, **k)

    for hedge in (None, _hedge(a, dev, 2, seed=n_cand)):
        before = bootstrap_multi_portfolio_dd.launches
        k = bootstrap_multi_portfolio_dd(11, hist, w, 1_029, 52, 0.2, hedge=hedge, **kw)
        torch.cuda.synchronize()
        assert bootstrap_multi_portfolio_dd.launches == before + 1
        for layout in _named_layouts(plan, a, n_cand, hedge):
            got = _launch_dd(11, hist, w, 1_029, 52, 0.2, 6, 2, hedge=hedge, layout=layout)
            assert _same(got, k), layout
        p = bootstrap_multi_dd_reference(11, hist, w, 1_029, 52, 0.2, hedge=hedge,
                                         with_bound=hedge is not None, **kw)
        shares = bootstrap_shares(k, p, hist, w, 52, hedge=hedge)
        assert max(shares.values()) <= 1.0, (hedge is not None, shares)


# ---- the GBM candidate kernel (#3) and path stats (#2) up to 16 assets --------------------

GBM_MODES = ("buy-hold", "rebalanced", "hedged")


def _gbm_switches():
    """W = 1, each side of every layout switch of ``ops.multi_dd
    .gbm_narrow_plan`` in each mode (float32), and 256."""
    from mcport_torch.ops.multi_dd import gbm_narrow_plan

    out = {1, 256}
    for legs, reb in ((0, False), (0, True), (2, False)):
        names = [gbm_narrow_plan(15, w, n_legs=legs, rebalance=reb).layout
                 for w in range(1, 257)]
        out |= {w + d for w in range(1, 256) if names[w] != names[w - 1] for d in (0, 1)}
    return sorted(out)


GBM_NARROW_W = _gbm_switches()


def _gbm_layouts(a, n_cand, hedge, mode, sd):
    from mcport_torch.ops.multi_dd import gbm_narrow_plan

    return _named_layouts(lambda *x, **k: gbm_narrow_plan(*x, rebalance=mode == "rebalanced",
                                                          score_dtype=sd, **k),
                          a, n_cand, hedge)


def _gbm_case(dev, a, n_cand, mode, sd, bm="poly", t_df=None, steps=52, chol=None, seed=0):
    """#3 in the layout W picks (counted), in every layout by name bit for
    bit with it, and within ``multi_dd_shares`` of the plain form (hedged
    with two legs per asset of every type, path by path); two blocks of
    1,029 paths."""
    from mcport_torch.ops.gbm import t_scaled_chol
    from mcport_torch.ops.multi_dd import (_launch, gbm_multi_portfolio_dd, multi_dd_reference,
                                           multi_dd_shares)

    mean, chol0, _ = _bench_inputs(a, dev, seed)
    chol = chol0 if chol is None else chol
    w = _wide_cand(a, dev, n_cand, seed=seed)
    hedge = _hedge(a, dev, 2, seed=n_cand) if mode == "hedged" else None
    reb = mode == "rebalanced"
    kw = dict(first_block=6, n_blocks=2, rebalance=reb, hedge=hedge)
    before = gbm_multi_portfolio_dd.launches
    k = gbm_multi_portfolio_dd(11, mean, chol, w, 1_029, steps, score_dtype=sd, bm=bm,
                               t_df=t_df, **kw)
    torch.cuda.synchronize()
    assert gbm_multi_portfolio_dd.launches == before + 1
    lk = t_scaled_chol(chol, t_df)
    for layout in _gbm_layouts(a, n_cand, hedge, mode, sd):
        got = _launch(11, mean, lk, w, 1_029, steps, 6, 2, reb, sd, bm, t_df, hedge, layout)
        assert _same(got, k), layout
    p32 = multi_dd_reference(11, mean, lk, w, 1_029, steps, bm=bm, t_df=t_df, **kw)
    p = (p32 if sd == "float32" and hedge is None else
         multi_dd_reference(11, mean, lk, w, 1_029, steps, score_dtype=sd, bm=bm, t_df=t_df,
                            with_bound=hedge is not None, **kw))
    if hedge is not None and steps == 0:   # V_T = 1 and dd = 0 exactly; the bound is 0
        assert _same(k, p[:2])
        return k
    shares = multi_dd_shares(k, p, p32, lk, mean, steps, reb, sd, hedge)
    assert max(shares.values()) <= 1.0, (mode, sd, shares)
    return k


@pytest.mark.parametrize("a", [1, 7, 15, 16])
@pytest.mark.parametrize("n_cand", GBM_NARROW_W)
@pytest.mark.parametrize("mode", GBM_MODES)
def test_gbm_narrow_layouts_match_plain_form(dev, a, n_cand, mode):
    """#3 up to 16 assets in the layout its W picks (ops.multi_dd
    .gbm_narrow_plan), float32, each mode: every layout by name bit for bit
    with it, within the plain form's bound; 52 steps."""
    _gbm_case(dev, a, n_cand, mode, "float32")


@pytest.mark.parametrize("n_cand", GBM_NARROW_W)
@pytest.mark.parametrize("mode", GBM_MODES)
@pytest.mark.parametrize("sd", ["tensorfloat32", "bfloat16"])
def test_gbm_narrow_score_tiers(dev, n_cand, mode, sd):
    """The reduced-precision score tiers (the split layout; the solo layout
    scores float32 only) at 15 assets, each mode."""
    _gbm_case(dev, 15, n_cand, mode, sd)


@pytest.mark.parametrize("bm, t_df", [("poly_fast", None), ("poly", 5.5)])
@pytest.mark.parametrize("n_cand", [1, 13, 256])
@pytest.mark.parametrize("mode", GBM_MODES)
@pytest.mark.parametrize("steps", [0, 1, 5, 252])
def test_gbm_narrow_draw_tiers_and_steps(dev, bm, t_df, n_cand, mode, steps):
    """The other draw tiers (Student-t: two steps per Philox call) at 0, 1, 5
    and 252 steps, 16 assets."""
    _gbm_case(dev, 16, n_cand, mode, "float32", bm=bm, t_df=t_df, steps=steps)


@pytest.mark.parametrize("n_cand", [1, 13, 256])
@pytest.mark.parametrize("mode", GBM_MODES)
def test_gbm_narrow_factor_above_the_diagonal(dev, n_cand, mode):
    """A factor with terms above its diagonal (the Cholesky factor times a
    rotation of two columns: the same covariance) runs its whole rows: every
    layout bit for bit with the one W picks, within the plain form's bound."""
    a = 15
    chol = _chol(a, dev).double()
    c0, c1 = chol[:, 0].clone(), chol[:, 1].clone()
    chol[:, 0], chol[:, 1] = 0.8 * c0 - 0.6 * c1, 0.6 * c0 + 0.8 * c1
    chol = chol.float()
    assert bool(torch.triu(chol, 1).any())
    _gbm_case(dev, a, n_cand, mode, "float32", chol=chol)


@pytest.mark.parametrize("a", [1, 7, 15, 16])
@pytest.mark.parametrize("bm, t_df", [("poly", None), ("poly_fast", None), ("poly", 5.5)])
@pytest.mark.parametrize("rebalance", [False, True])
@pytest.mark.parametrize("full", [False, True])
def test_gbm_path_stats_up_to_16_is_multi_dd_at_one_candidate(dev, a, bm, t_df, rebalance,
                                                              full):
    """#2 up to 16 assets (csrc/path_stats.cu path_stats_narrow_kernel, the
    lower triangle of L) is #3 at one candidate bit for bit (port, dd) in
    each of #3's layouts (solo, split), for a Cholesky factor and for
    one with terms above its diagonal (the whole rows), and within
    ``path_stats_shares`` of the plain form (terminal logS too)."""
    from mcport_torch.ops.gbm import t_scaled_chol
    from mcport_torch.ops.multi_dd import _launch
    from mcport_torch.ops.path_stats import (gbm_path_stats, path_stats_reference,
                                             path_stats_shares)

    mean, chol, w = _bench_inputs(a, dev, seed=a)
    if full and a > 1:
        c0, c1 = chol[:, 0].clone(), chol[:, 1].clone()
        chol[:, 0], chol[:, 1] = 0.8 * c0 - 0.6 * c1, 0.6 * c0 + 0.8 * c1
    n, steps = 2_053, 60
    before = gbm_path_stats.launches
    got = gbm_path_stats(11, mean, chol, w, n, steps, first_block=6, n_blocks=2,
                         rebalance=rebalance, bm=bm, t_df=t_df)
    torch.cuda.synchronize()
    assert gbm_path_stats.launches == before + 1
    lk = t_scaled_chol(chol, t_df)
    for layout in ("solo", "split"):
        term, dd = _launch(11, mean, lk, w[None], n, steps, 6, 2, rebalance, "float32", bm,
                           t_df, None, layout)
        assert torch.equal(term[:, 0], got[1]) and torch.equal(dd[:, 0], got[2]), layout
    p = path_stats_reference(11, mean, lk, w, n, steps, first_block=6, n_blocks=2,
                             rebalance=rebalance, bm=bm, t_df=t_df)
    shares = path_stats_shares(got, p, lk, mean, steps)
    assert max(shares.values()) <= 1.0, shares


@pytest.mark.parametrize("mode", GBM_MODES)
@pytest.mark.parametrize("sd", ["float32", "tensorfloat32"])
def test_gbm_narrow_split_chunks_its_scratch(dev, mode, sd):
    """Through a scratch that holds one recursion block's paths, the split
    layout gives the whole launch's outputs bit for bit."""
    from mcport_torch._build import library
    from mcport_torch.ops.multi_dd import SCORE_DTYPES, gbm_multi_portfolio_dd

    a, n, steps = 5, 1_029, 7
    mean, chol, _ = _bench_inputs(a, dev)
    w = _wide_cand(a, dev, 17)
    hedge = _hedge(a, dev, 2) if mode == "hedged" else None
    want = gbm_multi_portfolio_dd(3, mean, chol, w, n, steps, first_block=0, n_blocks=2,
                                  rebalance=mode == "rebalanced", score_dtype=sd, hedge=hedge)
    got = [torch.empty_like(x) for x in want]
    floats = 2 * steps * a * 64
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    block = hedge.packed() if hedge is not None else None
    err = library("gbm_narrow").mcport_gbm_narrow_dd(
        3, 0, 2, n, a, 17, steps, 0, GBM_MODES.index(mode), SCORE_DTYPES[sd],
        hedge.n_legs if hedge is not None else 0, 0.0, 0.0, chol.data_ptr(), mean.data_ptr(),
        w.data_ptr(), block.data_ptr() if block is not None else None,
        *(x.data_ptr() for x in got), scratch.data_ptr(), floats, 1,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0 and _same(got, want)
