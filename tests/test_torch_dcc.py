"""The port's DCC-GARCH family (``models/dcc.py``, ``ops/dcc.py``) against
mcport's, on the CPU.

- Deterministic, on identical inputs: the correlation log-likelihood grid
  equals mcport's ``_dcc_loglik_grid`` (float64, the suite's x64 on) to 1e-9
  relative; with the univariate fits held equal, ``estimate_dcc_garch`` picks
  the same ``(a, b)`` exactly and rolls the same ``q0`` and ``e0`` to 1e-12;
  end to end (each package fitting its own GARCH base, whose L-BFGS-B runs
  may stop ~1e-5 apart, ``tests/test_torch_garch.py``) the same ``(a, b)``
  and ``q0``, ``e0`` within 1e-4. ``convert.from_mcport`` is exact.
- Stochastic, in law: the streams differ (Philox against Threefry), so the
  port's plain samplers are held to mcport's lax sampler and to its Pallas
  kernel in interpret mode at 8,192 x 16 (A = 3), as
  ``tests/test_pallas_dcc.py`` holds those two: means within 6 standard
  errors, standard deviations within 8%, correlations within 0.06; the
  candidates' drawdown quantiles through the CDF (``F(q-) <= p <= F(q)``
  within 4 binomial errors of the difference).
- Exact cases: zero volatility compounds to ``(1 + mu)^n - 1``; ``a = b = 0``
  with ``q0 = S`` is the port's CCC-GARCH plain form on the same shocks up to
  the float32 Cholesky of ``S`` (within ``dcc_shares``' bound).
- The kernel-vs-plain bound (``dcc_tolerance``) holds a float64 evaluation of
  the same recursion against the float32 plain form with room to spare, and
  planted faults exceed it more than twice over.
- The plain form's right-looking Cholesky equals the narrow kernels'
  left-looking column loop bit for bit (A = 1 to 33), and the tiled
  schedules of ``dcc_group_kernel`` (panels of 4 and 8 columns, A = 4 to
  130).
- ``dcc_wide_plan`` keeps the group kernel's scratch within 32 MB up to 256
  assets.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcport.config import DataConfig as RefDataConfig
from mcport.data import load_universe as ref_load
from mcport.models import dcc as RD
from mcport.models.garch_mc import CCCGarchParams as RefBase
from mcport.ops.pallas_dcc import pallas_dcc_terminal_returns
from mcport_torch.convert import from_mcport
from mcport_torch.models import dcc as D
from mcport_torch.models.garch_mc import garch_terminal_returns
from mcport_torch.ops import dcc as O
from mcport_torch.ops.gbm import step_shocks

torch.set_num_threads(1)   # the suite runs several xdist workers on shared cores

A = 3
CORR = np.array([[1.0, 0.55, 0.3], [0.55, 1.0, 0.45], [0.3, 0.45, 1.0]])
REF_BASE = RefBase(
    mu=np.array([5e-4, 1e-3, 2e-4]),
    omega=np.array([4e-6, 6e-6, 3e-6]),
    alpha=np.array([0.08, 0.12, 0.06]),
    beta=np.array([0.88, 0.82, 0.9]),
    corr_chol=np.linalg.cholesky(CORR),
    sigma2_0=np.array([1e-4, 2e-4, 8e-5]),
    eps2_0=np.array([1e-4, 2e-4, 8e-5]),
)
# tests/test_pallas_dcc.py's parameters: q0 with a non-unit diagonal
REF = RD.DCCGarchParams(base=REF_BASE, a_dcc=0.06, b_dcc=0.90, q0=CORR + 0.05 * np.eye(A),
                        e0=np.array([0.4, -1.1, 0.2]))
PARAMS = from_mcport(REF)
W = np.array([0.5, 0.3, 0.2])
N, STEPS = 8_192, 16


def _simulate_dcc(t_len, a_c, b_c, rho=0.3, seed=0):
    """tests/test_dcc.py's two-asset DCC-GARCH series, from numpy normals."""
    rng = np.random.default_rng(seed)
    s = np.array([[1.0, rho], [rho, 1.0]])
    q, e_prev = s.copy(), np.zeros(2)
    s2 = np.full(2, 2e-6 / (1 - 0.08 - 0.88))
    eps_prev2 = s2.copy()
    out = np.empty((t_len, 2))
    for t in range(t_len):
        q = (1 - a_c - b_c) * s + a_c * np.outer(e_prev, e_prev) + b_c * q
        qn = np.sqrt(np.diag(q))
        e = np.linalg.cholesky(q / np.outer(qn, qn) + 1e-12 * np.eye(2)) @ rng.standard_normal(2)
        s2 = 2e-6 + 0.08 * eps_prev2 + 0.88 * s2
        eps = np.sqrt(s2) * e
        out[t] = 5e-4 + eps
        eps_prev2, e_prev = eps**2, e
    return out


@pytest.fixture(scope="module")
def weekly(fixtures_dir):
    """The reference's weekly BTC/ETH universe: 365 rows of simple returns."""
    paths = sorted(str(p) for p in fixtures_dir.glob("*7 Years Weekly.csv"))
    return ref_load(paths=paths, config=RefDataConfig(period="W")).port_rets


def _series(name, weekly):
    return weekly if name == "weekly" else _simulate_dcc(600, 0.06, 0.90, seed=1)


# ---- estimation: deterministic, against mcport ------------------------------------

@pytest.mark.parametrize("name", ["synthetic", "weekly"])
def test_loglik_grid_matches_mcport(name, weekly):
    from mcport.models.garch_mc import standardized_residuals

    r = _series(name, weekly)
    ref = RD.estimate_dcc_garch(r)
    b = ref.base
    e = standardized_residuals(r, b.mu, b.omega, b.alpha, b.beta)
    s = np.corrcoef(e, rowvar=False) + 1e-9 * np.eye(e.shape[1])
    ab = D._feasible_grid(0.0, 0.40, 0.0, 0.98, n_a=17, n_b=25)
    np.testing.assert_array_equal(ab, RD._feasible_grid(0.0, 0.40, 0.0, 0.98, n_a=17, n_b=25))
    want = np.asarray(RD._dcc_loglik_grid(jnp.asarray(e, jnp.float64),
                                          jnp.asarray(s, jnp.float64),
                                          jnp.asarray(ab, jnp.float64)))
    got = D._dcc_loglik_grid(e, s, ab)
    assert want.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)


@pytest.mark.parametrize("name", ["synthetic", "weekly"])
def test_estimate_matches_mcport_on_identical_fits(name, weekly, monkeypatch):
    """With mcport's GARCH fit given to both, the second step is the same
    deterministic computation: a and b exactly, q0 and e0 to 1e-12."""
    r = _series(name, weekly)
    base = RD.estimate_ccc_garch(r)
    monkeypatch.setattr(RD, "estimate_ccc_garch", lambda _: base)
    monkeypatch.setattr(D, "estimate_ccc_garch", lambda _: from_mcport(base))
    want, got = RD.estimate_dcc_garch(r), D.estimate_dcc_garch(r)
    assert (float(got.a_dcc), float(got.b_dcc)) == (want.a_dcc, want.b_dcc)
    np.testing.assert_allclose(got.q0.numpy(), want.q0, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.e0.numpy(), want.e0, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["synthetic", "weekly"])
def test_estimate_end_to_end_matches_mcport(name, weekly):
    r = _series(name, weekly)
    want, got = RD.estimate_dcc_garch(r), D.estimate_dcc_garch(r)
    assert (float(got.a_dcc), float(got.b_dcc)) == (want.a_dcc, want.b_dcc)
    np.testing.assert_allclose(got.q0.numpy(), want.q0, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.e0.numpy(), want.e0, rtol=0, atol=1e-4)
    assert got.q0.dtype == got.e0.dtype == got.a_dcc.dtype == torch.float64


def test_estimation_recovers_dcc_dynamics():
    """mcport's recovery bounds (tests/test_dcc.py): dynamic data gives
    material news and persistence, constant-correlation data almost none."""
    p = D.estimate_dcc_garch(_simulate_dcc(2_000, 0.06, 0.90, seed=1))
    assert 0.02 <= float(p.a_dcc) <= 0.15 and 0.80 <= float(p.b_dcc) <= 0.97
    assert float(D.estimate_dcc_garch(_simulate_dcc(2_000, 0.0, 0.0, seed=2)).a_dcc) <= 0.03


def test_from_mcport_is_exact():
    p = from_mcport(REF)
    assert isinstance(p, D.DCCGarchParams) and p.n_assets == A
    assert (float(p.a_dcc), float(p.b_dcc)) == (REF.a_dcc, REF.b_dcc)
    np.testing.assert_array_equal(p.q0.numpy(), REF.q0)
    np.testing.assert_array_equal(p.e0.numpy(), REF.e0)
    np.testing.assert_array_equal(p.base.corr_chol.numpy(), REF_BASE.corr_chol)
    d = p.tensors("cpu")
    np.testing.assert_array_equal(d.s.numpy(), (REF_BASE.corr_chol @ REF_BASE.corr_chol.T)
                                  .astype(np.float32))
    np.testing.assert_array_equal(d.ab.numpy(), np.float32([0.06, 0.90]))


# ---- the samplers in law, against mcport ------------------------------------------

def _law(got, ref):
    se = ref.std(0) / np.sqrt(ref.shape[0])
    np.testing.assert_allclose(got.mean(0), ref.mean(0), rtol=0, atol=float(6 * se.max()))
    np.testing.assert_allclose(got.std(0), ref.std(0), rtol=0.08)
    np.testing.assert_allclose(np.corrcoef(got, rowvar=False), np.corrcoef(ref, rowvar=False),
                               rtol=0, atol=0.06)


@pytest.fixture(scope="module")
def port_terminal():
    return D.dcc_terminal_returns(3, PARAMS, N, STEPS, device="cpu").double().numpy()


def test_terminal_law_matches_mcport_lax(port_terminal):
    ref = np.asarray(RD.dcc_terminal_returns(jax.random.key(3), REF, N, STEPS,
                                             dtype=jnp.float32, use_pallas=False))
    assert port_terminal.shape == ref.shape == (N, A)
    _law(port_terminal, ref)


def test_terminal_law_matches_mcport_pallas_interpret(port_terminal):
    ref = np.asarray(pallas_dcc_terminal_returns(3, REF, N, STEPS, interpret=True, block=128))
    _law(port_terminal, ref)


def test_candidate_law_matches_mcport():
    w = np.stack([W, np.full(A, 1.0 / A)])
    term, dd = (x.double().numpy() for x in D.dcc_path_stats(5, PARAMS, w, N, STEPS,
                                                            device="cpu"))
    r_term, r_dd = (np.asarray(x, np.float64) for x in RD.dcc_path_stats(
        jax.random.key(5), REF, w, N, STEPS))
    assert term.shape == dd.shape == r_dd.shape == (2, N)
    se = np.sqrt(term.var(-1) / N + r_term.var(-1) / N)
    assert np.all(np.abs(term.mean(-1) - r_term.mean(-1)) <= 4 * se)
    for p in (0.05, 0.5):
        tol = 4 * np.sqrt(2 * p * (1 - p) / N)
        q = np.quantile(r_dd, p, axis=-1, method="inverted_cdf")[:, None]
        assert np.all((dd < q).mean(-1) <= p + tol) and np.all((dd <= q).mean(-1) >= p - tol)


def test_zero_vol_closed_form():
    mu = np.array([0.01, -0.005, 0.002])
    base = from_mcport(RefBase(mu=mu, omega=np.zeros(A), alpha=np.zeros(A), beta=np.zeros(A),
                               corr_chol=np.eye(A), sigma2_0=np.zeros(A), eps2_0=np.zeros(A)))
    from mcport_torch.convert import dcc_params_from_numpy

    p = dcc_params_from_numpy(base, 0.05, 0.9, np.eye(A), np.zeros(A))
    out = D.dcc_terminal_returns(1, p, 64, 6, device="cpu").numpy()
    np.testing.assert_allclose(out, np.broadcast_to((1.0 + mu) ** 6 - 1.0, out.shape),
                               rtol=0, atol=3e-7)
    term, dd = D.dcc_path_stats(1, p, np.eye(A), 64, 6, device="cpu")
    np.testing.assert_allclose(term.numpy(), ((1.0 + mu) ** 6 - 1.0)[:, None].repeat(64, 1),
                               rtol=0, atol=3e-7)


@pytest.mark.parametrize("steps", [12, 7])
def test_zero_dynamics_is_ccc_garch_on_the_same_shocks(steps):
    """a = b = 0 and q0 = S: Q_t = S every step, and e = chol(S) z — the
    CCC-GARCH plain form's L_R z, up to the float32 Cholesky of S."""
    from mcport_torch.convert import dcc_params_from_numpy
    from mcport_torch.models.garch_mc import garch_path_stats

    base = PARAMS.base
    p = dcc_params_from_numpy(base, 0.0, 0.0, CORR, np.zeros(A))
    d = p.tensors("cpu")
    dcc = D.dcc_terminal_returns(9, p, 2_048, steps, device="cpu")
    ccc = garch_terminal_returns(9, base, 2_048, steps, device="cpu")
    assert O.dcc_shares(dcc, ccc, d, steps)["term"] <= 1.0
    assert float((dcc - ccc).abs().max()) < 1e-5
    w = np.stack([W, np.eye(A)[0]])
    pair = D.dcc_path_stats(9, p, w, 2_048, steps, device="cpu")
    assert max(O.dcc_shares(pair, garch_path_stats(9, base, w, 2_048, steps, device="cpu"),
                            d, steps).values()) <= 1.0


def test_correlation_rises_after_common_shocks():
    """A common shock (e0 = (3, 3)) lifts the next steps' correlation above
    S; an offsetting one (3, -3) lowers it; a = 0 keeps it at S."""
    from mcport_torch.convert import dcc_params_from_numpy

    corr = np.array([[1.0, 0.3], [0.3, 1.0]])
    base = from_mcport(RefBase(mu=np.zeros(2), omega=np.full(2, 1e-4), alpha=np.zeros(2),
                               beta=np.zeros(2), corr_chol=np.linalg.cholesky(corr),
                               sigma2_0=np.full(2, 1e-4), eps2_0=np.full(2, 1e-4)))

    def one_step_corr(a_c, e0):
        p = dcc_params_from_numpy(base, a_c, 0.9, corr, e0)
        x = D.dcc_terminal_returns(4, p, 32_768, 1, device="cpu").double().numpy()
        return np.corrcoef(x, rowvar=False)[0, 1]

    up, down, flat = (one_step_corr(0.1, [3.0, 3.0]), one_step_corr(0.1, [3.0, -3.0]),
                      one_step_corr(0.0, [3.0, 3.0]))
    # Q_1 = 0.0 S + 0.1 e0 e0' + 0.9 S: R_12 = (0.27 + 0.9) / 1.8 = 0.65, or -0.35
    se = 1.0 / math.sqrt(32_768)
    assert abs(up - 0.65) < 5 * se and abs(down + 0.35) < 5 * se and abs(flat - 0.3) < 5 * se


# ---- the plain form and the kernels' bound ----------------------------------------

def test_plain_form_rounds_as_ieee_float32():
    x = torch.from_numpy(np.random.default_rng(0).uniform(1e-8, 50.0, 100_000)
                         .astype(np.float32))
    want = (1.0 / np.sqrt(x.double().numpy())).astype(np.float32)
    np.testing.assert_array_equal(O.rsqrt_rn(x).numpy(), want)
    d = PARAMS.tensors("cpu")
    z = step_shocks(0, A, 64, 5, device="cpu")
    assert O.dcc_innovations(z, d).dtype == torch.float32


def _left_looking(z, d):
    """The kernels' Cholesky as they run it, column by column: each entry's
    products subtracted in ascending k from ``Q``'s entry, each product and
    difference rounded once; then ``e = D^{-1/2} L z`` and the GARCH step."""
    a_c, b_c = d.ab[0], d.ab[1]
    cs = ((1.0 - a_c) - b_c) * d.s
    n, batch = d.n_assets, z.shape[:-2]
    q, e = d.q0.expand(batch + (n, n)), d.e0.expand(batch + (n,))
    s2, e2 = d.sigma2_0.expand(batch + (n,)), d.eps2_0.expand(batch + (n,))
    out = []
    for t in range(z.shape[-2]):
        q = cs + a_c * (e[..., :, None] * e[..., None, :]) + b_c * q
        cols = []
        for j in range(n):
            num = q[..., j:, j]
            for k in range(j):
                num = num - cols[k][..., j - k:] * cols[k][..., j - k:j - k + 1]
            cols.append(num * O.rsqrt_rn(torch.clamp_min(num[..., :1], 1e-12)))
        zt = z[..., t, :]
        m = cols[0] * zt[..., :1]
        for j in range(1, n):
            m[..., j:] += cols[j] * zt[..., j:j + 1]
        e = m * O.rsqrt_rn(torch.clamp_min(torch.diagonal(q, dim1=-2, dim2=-1), 1e-12))
        s2 = d.omega + d.alpha * e2 + d.beta * s2
        eps = O.sqrt_rn(torch.clamp_min(s2, 0.0)) * e
        e2 = eps * eps
        out.append(eps)
    return torch.stack(out, dim=-2)


@pytest.mark.parametrize("a, ab, e0", [(1, (0.05, 0.9), 0.0), (2, (0.06, 0.9), 1.0),
                                        (5, (0.2, 0.79), -2.0), (17, (0.05, 0.9), 0.5),
                                        (33, (0.0, 1.0), 0.0)])
def test_right_looking_cholesky_is_the_kernels_order(a, ab, e0):
    """The plain form's right-looking Cholesky (the trailing block reduced
    once per column) subtracts every entry's products in the kernels'
    ascending order: its innovations equal the left-looking loop's bit for
    bit, and the path quantities of ``with_path`` are the loop's own."""
    d = _bench(a, ab, e0).tensors("cpu")
    z = step_shocks(4, a, 96, 6, device="cpu")
    eps, path = O.dcc_innovations(z, d, with_path=True)
    assert torch.equal(eps, _left_looking(z, d))
    assert torch.equal(O.dcc_innovations(z, d), eps)
    assert path.sigma.shape == eps.shape == path.row_l1.shape and path.q_max.shape == eps.shape[:-1]
    assert bool((path.row_l1 >= 1.0 - 1e-6).all())   # a unit-norm row of chol(R_t)
    assert bool((path.row_l1 <= math.sqrt(a) * (1.0 + 1e-5)).all())


def _tiled(z, d, nb=4):
    """``dcc_group_kernel``'s Cholesky in its order: Q in 4 x 4 tiles (the
    identity past A), by panels of ``nb`` columns: each tile column of the
    panel first takes the products of the panel's earlier columns, then its
    corner tile is factored column by column and the tiles below solve
    against it; then the trailing triangle takes the panel's products one k
    at a time; each product and difference rounded once, as the plain form
    rounds them. Then ``e = D^{-1/2} L z`` and the GARCH step."""
    a_c, b_c = d.ab[0], d.ab[1]
    cs = ((1.0 - a_c) - b_c) * d.s
    n, batch = d.n_assets, z.shape[:-2]
    ap = 4 * ((n + 3) // 4)
    q, e = d.q0.expand(batch + (n, n)), d.e0.expand(batch + (n,))
    s2, e2 = d.sigma2_0.expand(batch + (n,)), d.eps2_0.expand(batch + (n,))
    out = []
    for t in range(z.shape[-2]):
        q = cs + a_c * (e[..., :, None] * e[..., None, :]) + b_c * q
        w = torch.eye(ap).expand(batch + (ap, ap)).clone()
        w[..., :n, :n] = q
        for p0 in range(0, ap, nb):
            end = min(p0 + nb, ap)
            for c0 in range(p0, end, 4):
                for k in range(p0, c0):       # the panel's earlier columns
                    w[..., c0:, c0:c0 + 4] -= (w[..., c0:, k:k + 1]
                                               * w[..., c0:c0 + 4, k][..., None, :])
                inv = []
                for c in range(c0, c0 + 4):   # the corner, column by column
                    num = w[..., c:c0 + 4, c].clone()
                    for k in range(c0, c):
                        num = num - w[..., c:c0 + 4, k] * w[..., c, k:k + 1]
                    inv.append(O.rsqrt_rn(torch.clamp_min(num[..., :1], 1e-12)))
                    w[..., c:c0 + 4, c] = num * inv[-1]
                for j in range(4):            # the tiles below, against the corner
                    num = w[..., c0 + 4:, c0 + j].clone()
                    for k in range(j):
                        num = num - w[..., c0 + 4:, c0 + k] * w[..., c0 + j, c0 + k:c0 + k + 1]
                    w[..., c0 + 4:, c0 + j] = num * inv[j]
            for k in range(p0, end):          # the trailing triangle, k ascending
                col = w[..., end:, k]
                w[..., end:, end:] -= col[..., :, None] * col[..., None, :]
        zt = z[..., t, :]
        m = w[..., :n, 0] * zt[..., :1]
        for j in range(1, n):
            m[..., j:] += w[..., j:n, j] * zt[..., j:j + 1]
        e = m * O.rsqrt_rn(torch.clamp_min(torch.diagonal(q, dim1=-2, dim2=-1), 1e-12))
        s2 = d.omega + d.alpha * e2 + d.beta * s2
        eps = O.sqrt_rn(torch.clamp_min(s2, 0.0)) * e
        e2 = eps * eps
        out.append(eps)
    return torch.stack(out, dim=-2)


@pytest.mark.parametrize("a, ab, e0, nb", [(4, (0.05, 0.9), 0.0, 4), (17, (0.05, 0.9), 0.5, 4),
                                            (31, (0.2, 0.79), -2.0, 4), (33, (0.0, 1.0), 0.0, 4),
                                            (70, (0.06, 0.9), 1.0, 4), (9, (0.05, 0.9), 0.5, 8),
                                            (130, (0.06, 0.9), 1.0, 8)])
def test_tiled_cholesky_is_the_plain_forms_order(a, ab, e0, nb):
    """``dcc_group_kernel``'s schedules (tiles of 4, right-looking by panels
    of 4 columns, of 8 past 128 assets) subtract every entry's products in
    the plain form's ascending order: the same innovations bit for bit, also
    where A is not a multiple of 4 or of 8."""
    d = _bench(a, ab, e0).tensors("cpu")
    z = step_shocks(4, a, 32, 5, device="cpu")
    assert torch.equal(_tiled(z, d, nb), O.dcc_innovations(z, d))


@pytest.mark.parametrize("hedged", [False, True])
def test_wide_plan_keeps_the_scratch_in_l2(hedged):
    """``dcc_wide_plan`` on an H100 (132 SMs, 233,472 bytes of shared memory
    each) at every width up to 256: the group of 32, 64, 128 or 256 threads
    per path, every block within 227 KB, Q beside the factor in shared memory
    up to 220 assets and no scratch there; past that one slot of Q's tiles
    per CTA and one CTA per SM, the scratch at most 32 MB (17.6 MB at 256,
    inside the 50 MB L2). Past 292 the factor leaves too; the grid follows
    the SM count."""
    for a in range(1, 257):
        p = O.dcc_wide_plan(a, hedged, 132, 233_472)
        tiles = ((a + 3) // 4) * ((a + 3) // 4 + 1) // 2
        assert p.group == (32 if a <= 32 else 64 if a <= 64 else 128 if a <= 128 else 256)
        assert p.group * p.paths == 256 and p.shared_bytes <= 232_448 and p.w_shared
        assert p.q_shared == (a <= 220) and (p.scratch_floats == 0) == p.q_shared
        if not p.q_shared:
            assert p.slot_floats == 16 * tiles and p.ctas == 132
        assert 4 * p.scratch_floats <= 32 * 2 ** 20
        assert p.ctas >= 132
    assert 4 * O.dcc_wide_plan(256, hedged).scratch_floats == 17_571_840
    past = O.dcc_wide_plan(293, hedged, 132, 233_472)
    assert not past.w_shared and not past.q_shared and past.ctas == 132
    assert O.dcc_wide_plan(64, hedged, 66, 233_472).ctas * 2 == O.dcc_wide_plan(64, hedged).ctas
    with pytest.raises(ValueError, match="at least one asset"):
        O.dcc_wide_plan(0, hedged)


def _innovations(z, d, fault=None, dtype=torch.float32):
    """The DCC recursion with torch's Cholesky, at ``dtype``, with one planted
    fault: "no_news" (Q drops a e e'), "swap_ab", "no_rescale" (L z without
    D^{-1/2}), "shift_z" (asset j draws asset j-1's shock), "lag_e" (Q folds
    e every other step only)."""
    d = O.DccTensors(*(x.to(dtype) for x in d))
    a_c, b_c = (d.ab[1], d.ab[0]) if fault == "swap_ab" else (d.ab[0], d.ab[1])
    cs = ((1.0 - a_c) - b_c) * d.s
    batch, n = z.shape[:-2], d.n_assets
    q, e = d.q0.expand(batch + (n, n)), d.e0.expand(batch + (n,))
    s2, e2 = d.sigma2_0.expand(batch + (n,)), d.eps2_0.expand(batch + (n,))
    out = []
    for t in range(z.shape[-2]):
        zt = torch.roll(z[..., t, :], 1, -1) if fault == "shift_z" else z[..., t, :]
        news = 0.0 if fault == "no_news" else a_c
        q = cs + news * (e[..., :, None] * e[..., None, :]) + b_c * q
        m = (torch.linalg.cholesky(q.double()).to(dtype) @ zt[..., None].to(dtype))[..., 0]
        e_new = m if fault == "no_rescale" else m * torch.rsqrt(
            torch.diagonal(q, dim1=-2, dim2=-1))
        s2 = d.omega + d.alpha * e2 + d.beta * s2
        eps = torch.sqrt(s2.clamp_min(0.0)) * e_new
        e2 = eps * eps
        e = e if fault == "lag_e" and t % 2 else e_new
        out.append(eps)
    return torch.stack(out, -2), d


def _bench(a, ab=(0.05, 0.9), e0=0.0):
    from mcport_torch.convert import dcc_params_from_numpy, garch_params_from_numpy

    corr = 0.5 * np.eye(a) + 0.5
    base = garch_params_from_numpy(np.full(a, 1e-3), np.full(a, 4e-5), np.full(a, 0.08),
                                   np.full(a, 0.9), np.linalg.cholesky(corr), np.full(a, 4e-4),
                                   np.full(a, 4e-4))
    return dcc_params_from_numpy(base, ab[0], ab[1], corr, np.full(a, e0))


CASES = {"A=3 q0 non-unit": PARAMS, "A=15 bench": _bench(15), "A=16 e0=4": _bench(16, e0=4.0),
         "A=15 frozen": _bench(15, (0.0, 1.0)), "A=15 a=0.2": _bench(15, (0.2, 0.79))}


@pytest.mark.parametrize("case", list(CASES))
def test_tolerance_holds_rounding_and_rejects_faults(case):
    """A float64 evaluation of the recursion (other operations, other order,
    no float32 rounding) stays within a fifth of the bound of the float32
    plain form; every planted fault exceeds it more than twice over."""
    d = CASES[case].tensors("cpu")
    steps = 24
    z = step_shocks(3, d.n_assets, 256, steps, device="cpu")

    def terminal(eps, dd):
        cum = torch.ones_like(eps[..., 0, :])
        for t in range(steps):
            cum = cum * ((1.0 + dd.mu) + eps[..., t, :])
        return (cum - 1.0).to(torch.float32)

    plain = terminal(O.dcc_innovations(z, d), d)
    assert O.dcc_shares(terminal(*_innovations(z.double(), d, dtype=torch.float64)), plain, d,
                        steps)["term"] < 0.2
    faults = ("no_news", "swap_ab", "no_rescale", "shift_z", "lag_e")
    if case == "A=15 frozen":   # a = 0 and Q = S with a unit diagonal: only the shocks
        faults = ("shift_z",)
    for fault in faults:
        share = O.dcc_shares(terminal(*_innovations(z, d, fault)), plain, d, steps)["term"]
        assert share > 2.0, fault


def test_wrappers_dispatch_on_the_cpu_and_check_their_arguments():
    d = PARAMS.tensors("cpu")
    before = O.dcc_terminal.launches, O.dcc_multi_portfolio_dd.launches
    k = O.dcc_terminal(2, d, 100, 5, first_block=3, n_blocks=2)
    p = O.dcc_terminal_reference(2, d, 100, 5, first_block=3, n_blocks=2)
    assert torch.equal(k, p) and k.shape == (2, 100, A)
    w = torch.tensor(np.stack([W, [1.0, 0.0, 0.0]]), dtype=torch.float32)
    kk = O.dcc_multi_portfolio_dd(2, d, w, 100, 5, first_block=3, n_blocks=2)
    pp = O.dcc_multi_dd_reference(2, d, w, 100, 5, first_block=3, n_blocks=2)
    assert all(torch.equal(x, y) for x, y in zip(kk, pp)) and kk[0].shape == (2, 2, 100)
    assert (O.dcc_terminal.launches, O.dcc_multi_portfolio_dd.launches) == before
    # a sub-range of paths regenerates bit for bit
    part = O.dcc_terminal_reference(2, d, 40, 5, first_block=3, n_blocks=2, first_path=60)
    assert torch.equal(part, p[:, 60:])
    # the plain forms take any width, and so does the card (past 64 assets its wide
    # layout, csrc/wide.cuh): a launch refuses an empty universe only
    assert O.dcc_terminal(0, _bench(17).tensors("cpu"), 8, 2).shape == (1, 8, 17)
    O.check_card_assets(65, "DCC")
    O.check_card_assets(200, "DCC")
    with pytest.raises(ValueError, match="at least one asset"):
        O.check_card_assets(0, "DCC")
    with pytest.raises(ValueError, match="weights must be"):
        O.dcc_multi_portfolio_dd(0, d, torch.ones(2, 4), 8, 2)
    with pytest.raises(ValueError, match="float32"):
        O.dcc_terminal(0, d._replace(q0=d.q0.double()), 8, 2)


def test_dcc_risk_is_the_sketch_of_the_plain_terminal_returns():
    from mcport_torch.config import COVERING_LOG1P_SKETCH as sk
    from mcport_torch.ops.quantile import histogram, sketch_var_cvar

    r = D.dcc_risk(3, PARAMS, W, n_paths=4_096, n_steps=8, device="cpu")
    port = D.dcc_terminal_returns(3, PARAMS, 4_096, 8, device="cpu") @ torch.tensor(
        W, dtype=torch.float32)
    v, c = sketch_var_cvar(histogram(port, sk), 0.95, sk)
    assert (r.var, r.cvar, r.port_mean) == (float(v), float(c), float(port.mean()))
    assert r.cvar <= r.var < r.port_mean


def test_compare_tail_risk_matches_mcport(weekly, fixtures_dir):
    """Every family's entry has mcport's keys, and its VaR, CVaR and mean agree
    in law with mcport's (both at 16,384 paths x 8 steps)."""
    from mcport.api import compare_tail_risk as ref_compare
    from mcport.config import Config as RefConfig
    from mcport.config import GBMConfig as RefGBM
    from mcport_torch.api import compare_tail_risk
    from mcport_torch.config import Config, DataConfig, GBMConfig
    from mcport_torch.data import load_universe

    paths = sorted(str(p) for p in fixtures_dir.glob("*7 Years Weekly.csv"))
    kw = dict(n_paths=16_384, n_steps=8, path_block=8_192, seed=2)
    got = compare_tail_risk(load_universe(paths, DataConfig(period="W")), None,
                            Config(gbm=GBMConfig(**kw)), device="cpu")
    want = ref_compare(ref_load(paths=paths, config=RefDataConfig(period="W")), None,
                       RefConfig(gbm=RefGBM(**kw)))
    assert set(got) == set(want) == {"gbm_normal", "gbm_student_t", "ccc_garch", "dcc_garch",
                                     "merton_jump", "heston", "block_bootstrap"}
    for model, ref in want.items():
        assert set(got[model]) == set(ref), model
        for k in ("var", "cvar", "portfolio_mean"):
            assert abs(got[model][k] - ref[k]) <= 0.06 * abs(ref[k]) + 3e-3, (model, k)
    assert (got["dcc_garch"]["a_dcc"], got["dcc_garch"]["b_dcc"]) == (
        want["dcc_garch"]["a_dcc"], want["dcc_garch"]["b_dcc"])


def test_compare_tail_risk_reports_a_failed_fit_and_raises_past_it(fixtures_dir,
                                                                    monkeypatch):
    """Only the estimation is guarded: a failed fit becomes an error entry,
    a failure of what runs on the device propagates."""
    from mcport_torch import api
    from mcport_torch.config import Config, DataConfig, GBMConfig
    from mcport_torch.data import load_universe

    paths = sorted(str(p) for p in fixtures_dir.glob("*7 Years Weekly.csv"))
    d = load_universe(paths, DataConfig(period="W"))
    cfg = Config(gbm=GBMConfig(n_paths=1_024, n_steps=4, path_block=1_024))

    def broken(_):
        raise ValueError("degenerate series")

    monkeypatch.setattr(api, "estimate_dcc_garch", broken)
    out = api.compare_tail_risk(d, None, cfg, device="cpu")
    assert out["dcc_garch"] == {"error": "degenerate series"} and "var" in out["ccc_garch"]

    def launch_fails(*a, **kw):
        raise RuntimeError("DCC terminal kernel launch failed: CUDA error 98")

    monkeypatch.undo()
    monkeypatch.setattr(api, "dcc_risk", launch_fails)
    with pytest.raises(RuntimeError, match="launch failed"):
        api.compare_tail_risk(d, None, cfg, device="cpu")
