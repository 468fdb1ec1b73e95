"""Streaming moments and the histogram sketch (mcport_torch.ops.quantile)
against mcport.ops.quantile on identical samples.

Tolerances: moments and finalize to 1e-12 in float64 (both are compensated
sums; the port folds pairwise where mcport folds left to right). Sketch
counts identical in float64; in float32 at most 0.01% of the samples may sit
in a neighbouring bin (log1p and the bin floor can differ by an ulp between
backends). VaR/CVaR to 1e-12 on identical float64 counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcport.ops.quantile as ref
import mcport_torch.ops.quantile as Q
from mcport.config import SketchConfig

torch.set_num_threads(1)   # the suite runs several xdist workers on shared cores

A = 5
RNG = np.random.default_rng(0)
CHOL = np.linalg.cholesky(4e-4 * (0.5 * np.eye(A) + 0.5))
MEAN = RNG.normal(1e-3, 5e-4, A)
STEPS = 252


def _sample(n, seed):
    z = np.random.default_rng(seed).standard_normal((n, A))
    return STEPS * MEAN + np.sqrt(STEPS) * z @ CHOL.T


def _ref_state(x, shift, dtype, chunk=512):
    s = ref.init_moments(A, dtype)
    for part in x:
        s = ref.update_moments(s, jnp.asarray(part, dtype), shift=jnp.asarray(shift, dtype),
                               chunk=chunk)
    return s


def _port_state(x, shift, dtype, chunk=512):
    s = Q.init_moments(A, dtype=dtype, device="cpu")
    for part in x:
        s = Q.update_moments(s, torch.tensor(part, dtype=dtype),
                             shift=torch.tensor(shift, dtype=dtype), chunk=chunk)
    return s


@pytest.mark.parametrize("sizes, chunk", [((100_003,), 512), ((5_000, 1, 12_345), 512),
                                          ((4_096, 4_096), 64)])
def test_moments_match_mcport_float64(sizes, chunk):
    x = [_sample(n, i) for i, n in enumerate(sizes)]
    shift = STEPS * MEAN
    sj = _ref_state(x, shift, jnp.float64, chunk)
    st = _port_state(x, shift, torch.float64, chunk)
    assert int(st.count) == sum(sizes) == int(sj.count)
    # raw accumulators are sums over n rows: compare relative to their size
    np.testing.assert_allclose(st.sum + st.sum_c, np.asarray(sj.sum + sj.sum_c),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(st.outer + st.outer_c, np.asarray(sj.outer + sj.outer_c),
                               rtol=1e-12, atol=0)
    mj, cj = ref.finalize_moments(sj, shift=jnp.asarray(shift))
    mt, ct = Q.finalize_moments(st, shift=torch.tensor(shift))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-12)
    # and the numbers are the sample's own
    full = np.concatenate(x)
    np.testing.assert_allclose(mt.numpy(), full.mean(0), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ct.numpy(), np.cov(full, rowvar=False), rtol=0, atol=1e-12)


def test_moments_float32_compensated():
    """The float32 accumulators stay at the float64 answer to ~1e-7 of the
    covariance scale — the compensation at work (mcport's 1e-6 bar)."""
    x = [_sample(65_536, 7 + i) for i in range(4)]
    shift = STEPS * MEAN
    st = _port_state(x, shift, torch.float32)
    sj = _ref_state(x, shift, jnp.float32)
    full = np.concatenate(x)
    mt, ct = Q.finalize_moments(st, shift=torch.tensor(shift, dtype=torch.float32))
    mj, cj = ref.finalize_moments(sj, shift=jnp.asarray(shift, jnp.float32))
    scale = np.abs(np.cov(full, rowvar=False)).max()
    np.testing.assert_allclose(ct.numpy(), np.cov(full, rowvar=False), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=1e-6)


def test_merge_moments_matches_mcport():
    x1, x2 = _sample(3_000, 1), _sample(4_000, 2)
    shift = STEPS * MEAN
    mj = ref.merge_moments(_ref_state([x1], shift, jnp.float64),
                           _ref_state([x2], shift, jnp.float64))
    mt = Q.merge_moments(_port_state([x1], shift, torch.float64),
                         _port_state([x2], shift, torch.float64))
    assert int(mt.count) == 7_000
    np.testing.assert_allclose(mt.outer + mt.outer_c, np.asarray(mj.outer + mj.outer_c),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("kw", [{}, {"t_dof": 5.0}, {"weights": np.full(A, 1 / A)},
                                {"k_sigma": 6.0, "n_bins": 1024}])
def test_auto_sketch_identical(kw):
    assert Q.auto_sketch(torch.tensor(MEAN), torch.tensor(CHOL), STEPS, **kw) == \
        ref.auto_sketch(MEAN, CHOL, STEPS, **kw)


def _port_returns(n, seed):
    return (np.exp(_sample(n, seed)) - 1.0) @ np.full(A, 1.0 / A)


@pytest.mark.parametrize("space", ["log1p", "linear"])
def test_histogram_float64_identical_counts(space):
    sk = (ref.auto_sketch(MEAN, CHOL, STEPS) if space == "log1p"
          else SketchConfig(n_bins=4096, lo=-1.0, hi=3.0))
    port = _port_returns(200_000, 3)
    want = np.asarray(ref.histogram(jnp.asarray(port, jnp.float64), sk, dtype=jnp.float64))
    got = Q.histogram(torch.tensor(port, dtype=torch.float64), sk)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_histogram_float32_at_most_a_ten_thousandth_moves():
    sk = ref.auto_sketch(MEAN, CHOL, STEPS)
    port = _port_returns(400_000, 4).astype(np.float32)
    want = np.asarray(ref.histogram(jnp.asarray(port), sk, dtype=jnp.float32))
    got = Q.histogram(torch.from_numpy(port), sk).numpy()
    assert got.sum() == port.size
    moved = np.abs(np.cumsum(got) - np.cumsum(want)).max()   # samples across one edge
    assert moved <= 1e-4 * port.size


def test_histogram_clamps_to_edge_bins():
    sk = SketchConfig(n_bins=8, lo=-0.5, hi=0.5)
    got = Q.histogram(torch.tensor([-3.0, -0.5, 0.0, 0.49, 7.0], dtype=torch.float64), sk)
    assert got.tolist() == [2, 0, 0, 0, 1, 0, 0, 2]


@pytest.mark.parametrize("alpha", [0.95, 0.99, 0.5])
def test_var_cvar_match_mcport_on_identical_counts(alpha):
    sk = ref.auto_sketch(MEAN, CHOL, STEPS)
    counts = np.asarray(ref.histogram(jnp.asarray(_port_returns(100_000, 5)), sk,
                                      dtype=jnp.float64))
    vj, cj = ref.sketch_var_cvar(jnp.asarray(counts), alpha, sk)
    vt, ct = Q.sketch_var_cvar(torch.tensor(counts.astype(np.int64)), alpha, sk,
                               dtype=torch.float64)
    assert abs(float(vt) - float(vj)) <= 1e-12 and abs(float(ct) - float(cj)) <= 1e-12
    assert float(ct) <= float(vt)
    # and float32 arithmetic stays within float32 rounding of the float64 answer
    v32, c32 = Q.sketch_var_cvar(torch.tensor(counts.astype(np.int64)), alpha, sk)
    assert abs(float(v32) - float(vj)) <= 1e-5 and abs(float(c32) - float(cj)) <= 1e-5


def test_sketch_quantile_grid_matches_mcport():
    sk = ref.auto_sketch(MEAN, CHOL, STEPS)
    counts = np.asarray(ref.histogram(jnp.asarray(_port_returns(50_000, 6)), sk,
                                      dtype=jnp.float64))
    for q in (0.0, 0.001, 0.05, 0.5, 0.95, 1.0):
        want = float(ref.sketch_quantile(jnp.asarray(counts), q, sk))
        got = float(Q.sketch_quantile(torch.tensor(counts.astype(np.int64)), q, sk,
                                      dtype=torch.float64))
        assert abs(got - want) <= 1e-12, q


def test_sketch_var_cvar_close_to_exact_sample():
    """Sketch error is at most about one bin width of the exact k-worst
    statistics of the same sample."""
    sk = ref.auto_sketch(MEAN, CHOL, STEPS)
    port = _port_returns(200_000, 8)
    v, c = Q.sketch_var_cvar(Q.histogram(torch.tensor(port), sk), 0.95, sk,
                             dtype=torch.float64)
    worst = np.sort(port)[: int(np.ceil(0.05 * port.size))]
    width = (sk.hi - sk.lo) / sk.n_bins
    assert abs(float(v) - worst[-1]) <= 2 * width
    assert abs(float(c) - worst.mean()) <= 2 * width
