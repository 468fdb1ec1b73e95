"""The port's GBM terminal sampler (mcport_torch.ops.gbm) against mcport.

- the polynomial helpers and the normal / t draws on identical numpy
  uniforms, against mcport's ``_ln_poly``, ``_sincos_poly``, ``_exp_poly`` and
  ``_BM_VARIANTS`` (max abs <= 1e-6, relative for exp);
- the plain terminal sampler in law against mcport's Pallas kernel in
  interpret mode and its lax engine, with the bounds of
  ``tests/test_pallas_gbm.py`` (odd steps, the antithetic mirror, A=64, the t
  tier's fat tails);
- determinism, counter addressing (block and sub-range independence), and the
  wrapper's dispatch: the plain form for CPU tensors, errors otherwise.
The kernel itself runs only on a card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcport.models.gbm import terminal_log_returns as lax_terminal
from mcport.models.gbm import terminal_log_returns_t as lax_terminal_t
from mcport.ops import pallas_gbm as ref
from mcport_torch.ops import gbm as G

torch.set_num_threads(1)   # the suite runs several xdist workers on shared cores

A = 4
MEAN = np.array([0.001, 0.002, -0.0005, 0.0015])
CHOL = np.linalg.cholesky(0.0004 * (0.55 * np.eye(A) + 0.45 * np.ones((A, A))))
EDGES = np.array([2.0**-23, 1e-6, 1.0 - 2.0**-24, 1.0])


def _uniforms(n, seed):
    rng = np.random.default_rng(seed)
    u = np.concatenate([rng.uniform(2.0**-23, 1.0, n), EDGES]).astype(np.float32)
    v = np.concatenate([rng.uniform(0.0, 1.0, n), EDGES]).astype(np.float32)
    return u, v


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _port_terminal(seed, mean, chol, n, steps, **kw):
    return G.terminal_log_returns(
        seed, _t(np.asarray(mean, np.float32)), _t(np.asarray(chol, np.float32)),
        n, steps, **kw).numpy()


# ---- polynomial helpers and draws, same uniforms ------------------------------

@pytest.mark.parametrize("fast", [False, True])
def test_ln_poly_matches_mcport(fast):
    u, _ = _uniforms(200_000, 0)
    coef = G._LN1P_FAST_COEF if fast else G._LN1P_COEF
    jcoef = ref._LN1P_FAST_COEF if fast else ref._LN1P_COEF
    got = G.ln_poly(_t(u), coef).numpy()
    want = np.asarray(ref._ln_poly(jnp.asarray(u, jnp.float32), jcoef))
    assert np.max(np.abs(got - want)) <= 1e-6


@pytest.mark.parametrize("fast", [False, True])
def test_sincos_poly_matches_mcport(fast):
    _, v = _uniforms(200_000, 1)
    c, s = G.sincos_poly(_t(v), fast)
    cj, sj = ref._sincos_poly(jnp.asarray(v, jnp.float32), fast)
    assert np.max(np.abs(c.numpy() - np.asarray(cj))) <= 1e-6
    assert np.max(np.abs(s.numpy() - np.asarray(sj))) <= 1e-6


def test_exp_poly_matches_mcport():
    x = np.random.default_rng(2).uniform(-25.0, 10.0, 200_000).astype(np.float32)
    got = G.exp_poly(_t(x)).numpy().astype(np.float64)
    want = np.asarray(ref._exp_poly(jnp.asarray(x, jnp.float32))).astype(np.float64)
    assert np.max(np.abs(got / want - 1.0)) <= 1e-6


@pytest.mark.parametrize("bm", ["poly", "poly_fast"])
def test_boxmuller_matches_mcport(bm):
    u, v = _uniforms(200_000, 3)
    z1, z2 = G.BM_VARIANTS[bm](_t(u), _t(v))
    j1, j2 = ref._BM_VARIANTS[bm](jnp.asarray(u, jnp.float32), jnp.asarray(v, jnp.float32))
    assert np.max(np.abs(z1.numpy() - np.asarray(j1))) <= 1e-6
    assert np.max(np.abs(z2.numpy() - np.asarray(j2))) <= 1e-6


def test_t_draw_matches_mcport_one_t():
    """mcport's ``one_t`` (inside ``_make_t_pair``) from its own helpers."""
    u, v = _uniforms(200_000, 4)
    df = 5.5
    uj, vj = jnp.asarray(u, jnp.float32), jnp.asarray(v, jnp.float32)
    p = ref._exp_poly(-2.0 / df * ref._ln_poly(uj)) - 1.0
    want = np.asarray(jnp.sqrt(df * jnp.maximum(p, 0.0)) * ref._sincos_poly(vj)[0])
    got = G.t_draw(_t(u), _t(v), df).numpy()
    assert np.max(np.abs(got - want)) <= 1e-6


# ---- the plain terminal sampler in law ----------------------------------------

def test_terminal_moments_match_mcport_kernel_and_lax():
    """tests/test_pallas_gbm.py::test_terminal_moments_match_reference bounds."""
    n, steps = 20_000, 12
    got = _port_terminal(1, MEAN, CHOL, n, steps)
    kern = np.asarray(ref.pallas_terminal_log_returns(
        1, MEAN, CHOL, n, steps, interpret=True, block=128))
    lax = np.asarray(lax_terminal(jax.random.key(1), MEAN, CHOL, n, steps,
                                  dtype=jnp.float32))
    want_cov = (CHOL @ CHOL.T) * steps
    se = np.sqrt(np.diag(want_cov) / n)
    np.testing.assert_allclose(got.mean(0), MEAN * steps, atol=float(5 * se.max()))
    np.testing.assert_allclose(np.cov(got, rowvar=False), want_cov, rtol=0.1, atol=1e-5)
    for other in (kern, lax):
        np.testing.assert_allclose(got.mean(0), other.mean(0), atol=float(8 * se.max()))
        np.testing.assert_allclose(got.std(0), other.std(0), rtol=0.05)


def test_terminal_odd_steps():
    got = _port_terminal(2, MEAN, CHOL, 10_000, 7)
    np.testing.assert_allclose(got.std(0), np.sqrt(np.diag(CHOL @ CHOL.T) * 7), rtol=0.08)
    kern = np.asarray(ref.pallas_terminal_log_returns(
        2, MEAN, CHOL, 10_000, 7, interpret=True, block=128))
    np.testing.assert_allclose(got.std(0), kern.std(0), rtol=0.08)


@pytest.mark.parametrize("t_df", [None, 5.5])
def test_terminal_antithetic_mirror_is_exact(t_df):
    """The second half is drift minus the first half's noise, bit for bit
    (mcport's test form holds to its 1e-6)."""
    n, steps = 256, 6
    out = _port_terminal(3, MEAN, CHOL, n, steps, antithetic=True, t_df=t_df)
    drift = (np.float32(steps) * MEAN.astype(np.float32))
    np.testing.assert_allclose(out[: n // 2] - drift, -(out[n // 2:] - drift), atol=1e-6)
    chol = G.t_scaled_chol(_t(CHOL.astype(np.float32)), t_df)
    noise = G.terminal_noise_reference(3, chol, n // 2, steps, t_df=t_df)[0].numpy()
    np.testing.assert_array_equal(out[: n // 2], drift + noise)
    np.testing.assert_array_equal(out[n // 2:], drift - noise)


def test_wide_universe_64_assets():
    a = 64
    rng = np.random.default_rng(a)
    chol = np.linalg.cholesky(0.0004 * (0.4 * np.eye(a) + 0.6)).astype(np.float32)
    mean = rng.normal(1e-3, 5e-4, a).astype(np.float32)
    out = _port_terminal(0, mean, chol, 4_000, 8)
    assert out.shape == (4_000, a)
    np.testing.assert_allclose(out.std(0), np.sqrt(np.diag(chol @ chol.T) * 8), rtol=0.12)


def test_t_tier_law_parity_vs_lax_t():
    """tests/test_pallas_gbm.py::test_t_kernel_law_parity_vs_lax_t bounds."""
    a, n, steps, df = 3, 65_536, 8, 5.5
    m = np.full(a, 0.001, np.float32)
    chol = np.linalg.cholesky(4e-4 * (0.5 * np.eye(a) + 0.5)).astype(np.float32)
    port = _port_terminal(3, m, chol, n, steps, t_df=df).astype(np.float64)
    lax_t = np.asarray(lax_terminal_t(jax.random.key(1), m, chol, df, n, steps,
                                      dtype=jnp.float64))
    cov_true = steps * (chol @ chol.T).astype(np.float64)
    se = np.sqrt(np.diag(cov_true) / n)
    assert np.all(np.abs(port.mean(0) - lax_t.mean(0)) < 8 * se)
    np.testing.assert_allclose(np.cov(port, rowvar=False), cov_true, rtol=0.06)
    zp = (port - port.mean(0)) / port.std(0)
    zl = (lax_t - lax_t.mean(0)) / lax_t.std(0)
    assert np.mean(zp**4) > 3.2 and np.mean(zl**4) > 3.2
    assert abs(np.mean(zp**4) - np.mean(zl**4)) < 0.6


def test_poly_fast_tier_same_law_as_poly():
    """Same counters through both normal tiers: draws within the screening
    tier's fidelity bound (<= 1.6e-4 per draw, tests/test_pallas_gbm.py)."""
    chol = _t(np.diag([0.02, 0.03]).astype(np.float32))
    poly = G.terminal_noise_reference(3, chol, 2048, 8)
    fast = G.terminal_noise_reference(3, chol, 2048, 8, bm="poly_fast")
    assert float((poly - fast).abs().max()) < 8 * 1.6e-4 * 0.03


# ---- counter addressing, determinism, dispatch --------------------------------

def test_deterministic_and_blocks_independent():
    chol = _t(CHOL.astype(np.float32))
    out = G.terminal_noise_reference(4, chol, 128, 4, first_block=2, n_blocks=3)
    again = G.terminal_noise_reference(4, chol, 128, 4, first_block=2, n_blocks=3)
    torch.testing.assert_close(out, again, rtol=0, atol=0)
    assert not torch.allclose(out[0], out[1])
    for j in range(3):   # block j of a group is the same block launched alone
        alone = G.terminal_noise_reference(4, chol, 128, 4, first_block=2 + j)
        torch.testing.assert_close(out[j], alone[0], rtol=0, atol=0)
    # any sub-range of paths regenerates identically
    short = G.terminal_noise_reference(4, chol, 37, 4, first_block=2)
    torch.testing.assert_close(short[0], out[0, :37], rtol=0, atol=0)


def test_block_seeds_wrap_like_int32():
    from mcport.seeding import SEED_STRIDE

    seeds = G.block_seeds(2**31 - 5, 3, 2)
    for b, s in enumerate(seeds):
        as_int32 = np.int64(2**31 - 5 + (3 + b + 1) * SEED_STRIDE).astype(np.int32)
        assert s == int(as_int32) & 0xFFFFFFFF
    assert G.block_seeds(9, -1, 1) == [9]


def test_wrapper_uses_plain_form_on_cpu_and_counts_no_launch():
    chol = _t(CHOL.astype(np.float32))
    before = G.gbm_terminal_noise.launches
    got = G.gbm_terminal_noise(5, chol, 100, 5, n_blocks=2, t_df=6.0)
    want = G.terminal_noise_reference(5, chol, 100, 5, n_blocks=2, t_df=6.0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert G.gbm_terminal_noise.launches == before


def test_t_scale_folded_into_chol():
    m, chol, df = _t(MEAN.astype(np.float32)), _t(CHOL.astype(np.float32)), 5.5
    out = G.block_terminal_log_returns(6, m, chol, 64, 5, t_df=df)
    scaled = chol / np.float32(np.sqrt(df / (df - 2.0)))
    torch.testing.assert_close(G.t_scaled_chol(chol, df), scaled, rtol=0, atol=0)
    want = 5 * m + G.terminal_noise_reference(6, scaled, 64, 5, t_df=df)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


@pytest.mark.parametrize("bad", [
    dict(chol=torch.zeros((65, 65))),
    dict(chol=torch.zeros((3, 3), dtype=torch.float64)),
    dict(chol=torch.zeros((3, 4))),
    dict(bm="exact"),
    dict(t_df=2.0),
    dict(n_blocks=0),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    kw = dict(chol=torch.eye(3) * 0.02, bm="poly", t_df=None, n_blocks=1)
    kw.update(bad)
    with pytest.raises(ValueError):
        G.gbm_terminal_noise(0, kw.pop("chol"), 16, 4, **kw)


def test_kernel_source_shares_the_python_constants():
    """The .cu restates three decisions of the Python side; they must agree."""
    import re
    from pathlib import Path

    from mcport.seeding import SEED_STRIDE
    from mcport_torch.rng import STREAM_GBM

    src = (Path(G.__file__).resolve().parents[1] / "csrc" / "terminal_noise.cu").read_text()

    def const(name):
        return re.search(rf"constexpr \w+(?: \w+)? {name} = ([^;]+);", src).group(1)

    assert int(const("kMaxAssets")) == G.MAX_ASSETS
    assert 1 << int(re.fullmatch(r"1LL << (\d+)", const("kSeedStride")).group(1)) == SEED_STRIDE
    assert int(const("kStreamGbm")) == STREAM_GBM


def test_wrapper_raises_for_a_device_without_kernel():
    with pytest.raises(ValueError, match="no terminal-noise kernel"):
        G.gbm_terminal_noise(0, torch.eye(3, device="meta"), 16, 4)


# ---- the kernel-vs-plain tolerance rejects a wrong polynomial tier -------------

def _fast_ln_in_poly(u1, u2):
    r = torch.sqrt(-2.0 * G.ln_poly(u1, G._LN1P_FAST_COEF))
    c, s = G.sincos_poly(u2)
    return r * c, r * s


def _fast_sincos_in_poly(u1, u2):
    r = torch.sqrt(-2.0 * G.ln_poly(u1))
    c, s = G.sincos_poly(u2, fast=True)
    return r * c, r * s


@pytest.mark.parametrize("fault, chol, steps", [
    (_fast_ln_in_poly, np.ones((1, 1)), 1),
    (_fast_sincos_in_poly, np.linalg.cholesky(4e-4 * (0.5 * np.eye(15) + 0.5)), 7),
])
def test_kernel_tolerance_rejects_a_wrong_tier(monkeypatch, fault, chol, steps):
    """chip_smoke.py and tests/test_torch_cuda.py hold the kernel to
    ``kernel_tolerance``; a poly tier built with one of poly_fast's polynomials
    must exceed it at the cases those checks run (here by at least 2x)."""
    chol = _t(chol.astype(np.float32))
    tol = G.kernel_tolerance(chol, steps)
    assert tol.shape == (chol.shape[0],)
    kw = dict(first_block=6, n_blocks=2)
    right = G.terminal_noise_reference(11, chol, 4_099, steps, **kw)
    monkeypatch.setitem(G.BM_VARIANTS, "poly", fault)
    wrong = G.terminal_noise_reference(11, chol, 4_099, steps, **kw)
    assert float(((wrong - right).abs() / tol).max()) > 2.0


def test_kernel_tolerance_is_the_smaller_bound():
    chol = _t(np.linalg.cholesky(4e-4 * (0.5 * np.eye(15) + 0.5)).astype(np.float32))
    for steps in (1, 7, 252):
        worst = 2e-6 * steps * chol.abs().sum(dim=1)
        walk = 1.5e-5 * np.sqrt(steps) * chol.norm(dim=1)
        torch.testing.assert_close(G.kernel_tolerance(chol, steps),
                                   torch.minimum(worst, walk), rtol=1e-6, atol=0)
    assert float(G.kernel_tolerance(torch.ones((1, 1)), 1)) == pytest.approx(2e-6)
