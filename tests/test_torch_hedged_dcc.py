"""Hedged per-step settlement of the DCC-GARCH family: the port against
mcport, on the CPU.

- Settlement on identical moves: the hedged plain form's core
  (``ops/hedged.py`` ``hedged_multi_dd`` on gross factors, ``P_new = P ·
  ((1 + mu) + eps)``) against mcport's in-kernel settlement
  (``make_hedged_returns``, ``pallas_multi_dd.py:46``) on the same gross
  factors and spots, to 1e-6; the hedged plain form
  (``ops.dcc.dcc_multi_dd_reference`` with ``hedge``) is that recursion on
  its own innovations, bit for bit. mcport's tile kernel rounds the gross
  ``1 + (mu + eps)``: its prices part by ulps, and its recursion stays
  within the per-path bound of ``ops.dcc.dcc_price_bound``.
- An identity hedge (one BUY_ASSET leg per asset) gives the unhedged mode
  to the per-path bound.
- In law at matched path counts: hedged ``run_dcc_path_risk`` against
  mcport's (its lax scorer on the CPU), and the hedged frontier's scores
  against mcport's hedged lax scorer (``mcport.models.dcc.dcc_path_stats``
  with ``hedge_args``) on the same candidates.
- Split + resume bit-identical; the hedge and the spots bind the digest; a
  hedged run without spots raises, as mcport's does.
- ``path_tail_risk(model="dcc", legs_by_asset=...)`` settles against the
  last prices and names the hedged assets as mcport does.

The planted faults and the sound-kernel check of ``ops.dcc.dcc_price_bound``
are in ``tests/test_torch_hedged_families.py``.
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcport.api import path_tail_risk as ref_path_tail_risk
from mcport.config import Config as RefConfig
from mcport.config import DataConfig as RefDataConfig
from mcport.config import GBMConfig as RefGBMConfig
from mcport.data import load_universe as ref_load
from mcport.engine.path_risk import run_dcc_path_risk as ref_dcc_run
from mcport.models.dcc import DCCGarchParams as RefDcc
from mcport.models.dcc import dcc_path_stats as ref_dcc_stats
from mcport.models.garch_mc import CCCGarchParams as RefGarch
from mcport.ops.pallas_multi_dd import make_hedged_returns
from mcport.options import HedgeSpec as RefHedgeSpec
from mcport.options import LegType as RefLegType
from mcport.options import Legs as RefLegs
from mcport_torch.api import path_tail_risk
from mcport_torch.config import Config, DataConfig, GBMConfig
from mcport_torch.convert import from_mcport
from mcport_torch.data import load_universe
from mcport_torch.engine.drawdown_frontier import (family_drawdown_frontier_search,
                                                   frontier_seeds)
from mcport_torch.engine.path_risk import run_dcc_path_risk, run_resumable_path_risk
from mcport_torch.ops import dcc as OD
from mcport_torch.ops.hedged import HedgeTensors, hedged_multi_dd, hedged_shares
from mcport_torch.options import HedgeSpec

torch.set_num_threads(1)   # the suite runs several xdist workers on shared cores

A = 3
NAMES = ["A0", "A1", "A2"]
S0 = np.array([100.0, 50.0, 20.0])
W = np.array([0.5, 0.3, 0.2])
REF_GARCH = RefGarch(
    mu=np.array([5e-4, 1e-3, 8e-4]), omega=np.array([4e-6, 6e-6, 5e-6]),
    alpha=np.array([0.08, 0.12, 0.1]), beta=np.array([0.88, 0.82, 0.85]),
    corr_chol=np.linalg.cholesky(0.5 * np.eye(A) + 0.5),
    sigma2_0=np.array([1e-4, 2e-4, 1.5e-4]), eps2_0=np.array([1e-4, 2e-4, 3e-4]))
# moving correlations from q0 off S, with a non-unit diagonal and a nonzero e0
REF_DCC = RefDcc(base=REF_GARCH, a_dcc=0.05, b_dcc=0.9, q0=0.45 * np.eye(A) + 0.6,
                 e0=np.array([-1.0, 0.5, 1.5]))
DCC = from_mcport(REF_DCC)
ROWS = {0: [(RefLegType.BUY_ASSET, 0.0, 0.0, 1.0), (RefLegType.BUY_PUT, 95.0, 0.5, 1.0)],
        1: [(RefLegType.BUY_PUT, 45.0, 0.2, 1.0), (RefLegType.SELL_CALL, 56.0, 0.3, 1.0)]}
REF_SPEC = RefHedgeSpec.build({k: RefLegs.from_rows(v) for k, v in ROWS.items()}, NAMES)
SPEC = from_mcport(REF_SPEC)
HEDGE = HedgeTensors.from_spec(SPEC, S0, "cpu")
CFG = GBMConfig(n_paths=16_384, n_steps=12, path_block=4_096, seed=4)
REF_CFG = RefGBMConfig(n_paths=16_384, n_steps=12, path_block=4_096, seed=4)


def _f32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _mcport_settled(gross: np.ndarray, w: np.ndarray):
    """mcport's hedged candidate recursion in JAX float32 on given per-step
    gross factors ``(n, T, A)``: ``p_new = p · gross`` (``_dcc_dd_kernel``'s
    hedged branch), the settlement of ``make_hedged_returns`` on the (A, n)
    layout of the TPU kernels, ``V *= 1 + w·r_h`` → (term, dd), each ``(W,
    n)``."""
    ht, hk, hp, hq = (jnp.asarray(a) for a in REF_SPEC.arrays)
    settle = make_hedged_returns(ht, hk.astype(jnp.float32), hp.astype(jnp.float32),
                                 hq.astype(jnp.float32))
    g = jnp.asarray(gross, jnp.float32)
    wj = jnp.asarray(w, jnp.float32)
    p = jnp.broadcast_to(jnp.asarray(S0, jnp.float32)[:, None], (A, g.shape[0]))
    v = jnp.ones((wj.shape[0], g.shape[0]), jnp.float32)
    peak, dd = v, jnp.zeros_like(v)
    for t in range(g.shape[1]):
        p_new = p * g[:, t, :].T
        v = v * (1.0 + wj @ settle(p, p_new))
        peak = jnp.maximum(peak, v)
        dd = jnp.minimum(dd, v / peak - 1.0)
        p = p_new
    return np.asarray(v - 1.0), np.asarray(dd)


def test_hedged_dcc_settlement_matches_mcport_on_identical_moves():
    """On the same gross factors the settlement and the candidates' recursion
    agree to 1e-6; with mcport's own rounding of the gross, ``1 + (mu +
    eps)``, the prices part by ulps and mcport's recursion stays within the
    plain form's per-path bound."""
    d = DCC.tensors("cpu")
    eps, path = OD.dcc_innovations(OD._shocks(3, d, 512, 26, -1, 1, 0), d, with_path=True)
    eps, path = eps[0], OD.DccPath(*(x[0] for x in path))
    gross = (1.0 + d.mu) + eps
    w = np.stack([W, np.full(A, 1.0 / A), np.eye(A)[0]])
    term, dd, bound = hedged_multi_dd(gross, HEDGE, _f32(w),
                                      price_bound=OD.dcc_price_bound(d, path), gross=True)
    rterm, rdd = _mcport_settled(gross.numpy(), w)
    np.testing.assert_allclose(term.numpy(), rterm, rtol=0, atol=1e-6)
    np.testing.assert_allclose(dd.numpy(), rdd, rtol=0, atol=1e-6)
    tile = 1.0 + (d.mu + eps)
    assert not torch.equal(tile, gross)
    theirs = tuple(torch.as_tensor(np.array(a)) for a in _mcport_settled(tile.numpy(), w))
    assert max(hedged_shares(theirs, (term, dd, bound), None).values()) <= 1.0
    # the plain form itself is that recursion on its own innovations, bound included
    plain = OD.dcc_multi_dd_reference(3, d, _f32(w), 512, 26, hedge=HEDGE, with_bound=True)
    assert all(torch.equal(a, b[None]) for a, b in zip(plain, (term, dd, bound)))
    assert all(torch.equal(a, b) for a, b in zip(
        OD.dcc_multi_portfolio_dd(3, d, _f32(w), 512, 26, hedge=HEDGE), plain[:2]))


def test_dcc_price_bound_grows_along_the_path():
    """The bound is per path and step, from the path's own volatility and
    condition: it grows with the steps, differs between paths, and stays
    below :func:`mcport_torch.ops.dcc.dcc_tolerance`'s worst case."""
    d = DCC.tensors("cpu")
    _, path = OD.dcc_innovations(OD._shocks(5, d, 256, 52, -1, 1, 0), d, with_path=True)
    delta = OD.dcc_price_bound(d, path)
    assert delta.shape == (1, 256, 52, A) and bool((delta > 0).all())
    assert bool((delta[..., 1:, :] >= delta[..., :-1, :]).all())
    assert float(delta[..., -1, :].std(dim=1).min()) > 0.0
    assert bool((delta[..., -1, :] < OD.dcc_tolerance(d, 52)).all())
    assert (path.row_l1[..., 0] - 1.0).abs().max() < 1e-6   # row 0 of chol(R) is (1, 0, ...)


def test_identity_hedge_is_the_unhedged_dcc_mode():
    """One BUY_ASSET leg per asset settles to the asset's return: the
    unhedged mode on the same counters within the per-path bound."""
    d = DCC.tensors("cpu")
    ident = HedgeTensors.from_spec(HedgeSpec.build(None, NAMES), S0, "cpu")
    w = _f32(np.random.default_rng(0).dirichlet(np.ones(A), 7))
    kw = dict(first_block=2, n_blocks=2)
    args = (9, d, w, 1_000, 52)
    hedged = OD.dcc_multi_portfolio_dd(*args, hedge=ident, **kw)
    plain = OD.dcc_multi_portfolio_dd(*args, **kw)
    bound = OD.dcc_multi_dd_reference(*args, hedge=ident, with_bound=True, **kw)[2]
    shares = OD.dcc_shares(hedged, (*plain, bound), d, 52, hedge=ident)
    assert max(shares.values()) <= 1.0, shares
    assert max(float((a - b).abs().max()) for a, b in zip(hedged, plain)) > 0.0
    with pytest.raises(ValueError, match="with_bound"):
        OD.dcc_shares(hedged, plain, d, 52, hedge=ident)


def _order_se(x: np.ndarray, p: float) -> float:
    """Distribution-free standard error of the sample p-quantile (order
    statistics one binomial standard deviation either side)."""
    s = np.sort(x)
    k, d = int(p * x.size), int(np.sqrt(x.size * p * (1 - p)))
    return float(s[k + d] - s[k - d]) / 2


def _es_se(x: np.ndarray, p: float) -> float:
    q = np.quantile(x, p)
    tail = x[x <= q]
    return float(np.sqrt((tail.var() + (1 - p) * (q - tail.mean()) ** 2) / (x.size * p)))


def test_hedged_dcc_path_risk_matches_mcport_in_law():
    got = run_dcc_path_risk(DCC, W, CFG, hedge=SPEC, s0=S0, device="cpu")
    want = ref_dcc_run(REF_DCC, W, REF_CFG, hedge=REF_SPEC, s0=S0)
    assert got.n_paths == want.n_paths == CFG.n_paths
    term, dd = OD.dcc_multi_portfolio_dd(CFG.seed, DCC.tensors("cpu"), _f32(W)[None],
                                         CFG.path_block, CFG.n_steps, first_block=0,
                                         n_blocks=CFG.n_paths // CFG.path_block, hedge=HEDGE)
    port, dd = term.double().numpy().ravel(), dd.double().numpy().ravel()
    se = {"var": _order_se(port, 0.05), "cvar": _es_se(port, 0.05),
          "port_mean": port.std() / np.sqrt(port.size),
          "dd_mean": dd.std() / np.sqrt(dd.size),
          "dd_p95": _order_se(dd, 0.05), "dd_median": _order_se(dd, 0.5)}
    for name, s in se.items():
        assert abs(getattr(got, name) - getattr(want, name)) <= 4 * np.sqrt(2) * s + 1e-6, name
    assert got.cvar <= got.var and -1 <= got.dd_p95 <= got.dd_median <= 0


def test_hedged_dcc_split_resume_and_digest():
    cfg = GBMConfig(n_paths=8_192, n_steps=10, path_block=1_024, seed=2)
    full, ck_full = run_resumable_path_risk("dcc", DCC, W, cfg, hedge=SPEC, s0=S0,
                                            device="cpu")
    _, part = run_resumable_path_risk("dcc", DCC, W, cfg, hedge=SPEC, s0=S0, max_blocks=3,
                                      device="cpu")
    res, ck = run_resumable_path_risk("dcc", DCC, W, cfg, hedge=SPEC, s0=S0, checkpoint=part,
                                      device="cpu")
    assert ck.done and not part.done
    assert all(np.array_equal(getattr(ck, f), getattr(ck_full, f))
               for f in ("h_port", "h_dd", "s_port", "s_dd"))
    assert (res.var, res.dd_p95) == (full.var, full.dd_p95)
    one_shot = run_dcc_path_risk(DCC, W, cfg, hedge=SPEC, s0=S0, device="cpu")
    assert (one_shot.var, one_shot.dd_p95) == (full.var, full.dd_p95)
    for bad in (dict(hedge=None), dict(hedge=SPEC, s0=S0 * 1.01)):
        with pytest.raises(ValueError, match="digest"):
            run_resumable_path_risk("dcc", DCC, W, cfg, checkpoint=part, device="cpu", **bad)
    # no spots: the port refuses as mcport does
    with pytest.raises(ValueError, match="requires s0"):
        run_resumable_path_risk("dcc", DCC, W, cfg, hedge=SPEC, device="cpu")
    with pytest.raises(ValueError, match="requires s0"):
        run_dcc_path_risk(DCC, W, cfg, hedge=SPEC, device="cpu")
    with pytest.raises(ValueError, match="requires s0"):
        ref_dcc_run(REF_DCC, W, REF_CFG, hedge=REF_SPEC)
    with pytest.raises(ValueError, match="requires s0"):
        family_drawdown_frontier_search(4, "dcc", DCC, hedge=SPEC, device="cpu")


def test_hedged_dcc_frontier_scores_as_mcports_scorer():
    """The hedged frontier's scores are the plain scorer's on its weight
    matrix and paths (the optimum the best feasible mean), and agree with
    mcport's hedged lax scorer on the same candidates in law."""
    kw = dict(dd_budget=0.3, n_candidates=64, n_paths=2_048, n_steps=26)
    r = family_drawdown_frontier_search(4, "dcc", DCC, hedge=SPEC, s0=S0, device="cpu", **kw)
    assert r.opt_idx >= 0 and 0 < int(r.feasible.sum()) <= kw["n_candidates"]
    path_seed, _ = frontier_seeds(4)
    w = torch.as_tensor(r.weights, dtype=torch.float32)
    term, dd = OD.dcc_multi_dd_reference(path_seed, DCC.tensors("cpu"), w, kw["n_paths"],
                                         kw["n_steps"], hedge=HEDGE)
    rterm, _ = ref_dcc_stats(jax.random.key(4), REF_DCC, jnp.asarray(r.weights[:8], jnp.float32),
                             kw["n_paths"], kw["n_steps"], jnp.float32,
                             hedge_args=(jnp.asarray(S0, jnp.float32), *REF_SPEC.arrays))
    k = math.ceil(0.05 * kw["n_paths"])
    ret = term[0].mean(dim=-1)
    q = torch.kthvalue(torch.nan_to_num(dd[0], nan=-math.inf), k, dim=-1).values
    np.testing.assert_array_equal(r.ret, ret.numpy())
    np.testing.assert_array_equal(r.dd_p95, q.numpy())
    feasible = r.valid & (q.numpy() >= -0.3)
    assert r.opt_idx == int(np.argmax(np.where(feasible, ret.numpy(), -np.inf)))
    t, rt = term[0, :8].double().numpy(), np.asarray(rterm, np.float64)
    se = np.sqrt(t.var(axis=1) / kw["n_paths"] + rt.var(axis=1) / kw["n_paths"])
    assert (np.abs(t.mean(axis=1) - rt.mean(axis=1)) <= 4 * se).all()


WEEKLY = ["fixtures/BTC_USD 7 Years Weekly.csv", "fixtures/ETH_USD 7 Years Weekly.csv"]


def test_hedged_dcc_path_tail_risk_as_mcports():
    """``path_tail_risk`` fits DCC-GARCH to the weekly fixtures and settles a
    married put and a collar against the last prices: mcport's keys and
    hedged assets, and exactly the engine's run on that fit with the last
    prices as spots."""
    from mcport_torch.models.dcc import estimate_dcc_garch

    root = Path(__file__).resolve().parents[1]
    paths = [str(root / p) for p in WEEKLY]
    data = load_universe(paths, DataConfig(period="W"))
    ref_data = ref_load(paths=paths, config=RefDataConfig(period="W"))
    last = data.prices[-1]
    legs = {0: [("BUY_ASSET", 0.0, 0.0, 1.0), ("BUY_PUT", 0.9 * last[0], 0.0, 1.0)],
            1: [("BUY_PUT", 0.9 * last[1], 0.0, 1.0), ("SELL_CALL", 1.1 * last[1], 0.0, 1.0)]}
    ref_legs = {k: RefLegs.from_rows([(getattr(RefLegType, t), *rest) for t, *rest in v])
                for k, v in legs.items()}
    small = dict(n_paths=8_192, n_steps=8, path_block=4_096, seed=1)
    got = path_tail_risk(data, None, Config(gbm=GBMConfig(**small)), model="dcc",
                         legs_by_asset=legs, device="cpu")
    want = ref_path_tail_risk(ref_data, None, RefConfig(gbm=RefGBMConfig(**small)),
                              model="dcc", legs_by_asset=ref_legs)
    assert set(got) == set(want)
    assert got["hedged_assets"] == want["hedged_assets"] == list(data.names)
    assert got["n_paths"] == want["n_paths"] == 8_192
    rep = run_dcc_path_risk(estimate_dcc_garch(data.port_rets), np.full(2, 0.5),
                            GBMConfig(**small), hedge=HedgeSpec.build(legs, data.names),
                            s0=last, device="cpu")
    assert (got["var"], got["cvar"], got["dd_p95"]) == (rep.var, rep.cvar, rep.dd_p95)
