"""Hedged per-step settlement of the Heston family: the port against mcport,
on the CPU.

- Settlement on identical log increments: the hedged plain form's core
  (``ops/hedged.py`` ``hedged_multi_dd`` on log increments, ``P_new = P ·
  exp(x)``) against mcport's in-kernel settlement (``make_hedged_returns``,
  ``pallas_multi_dd.py:46``) on the same increments and spots, to 1e-6; the
  hedged plain form (``ops.heston.heston_multi_dd_reference`` with
  ``hedge``) is that recursion on its own increments, bit for bit.
- An identity hedge (one BUY_ASSET leg per asset) gives the unhedged mode
  to the per-path bound, at the universe's vol of vol and at a
  Feller-violating one.
- In law at matched path counts: hedged ``run_heston_path_risk`` against
  mcport's (its lax scorer on the CPU), and the hedged frontier's scores
  against mcport's hedged lax scorer on the same candidates.
- Split + resume bit-identical; the hedge and the spots bind the digest;
  the spots default to the parameters' own (``params.s0``), as mcport's do.
- ``path_tail_risk(model="heston", legs_by_asset=...)`` settles against the
  last prices and names the hedged assets as mcport does.

The planted faults and the 2-ulp check of ``ops.heston.heston_price_bound``
are in ``tests/test_torch_hedged_families.py``.
"""

import dataclasses
import math

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
from mcport.engine.path_risk import run_heston_path_risk as ref_heston_run
from mcport.models.heston import HestonParams as RefHeston
from mcport.models.heston import heston_path_stats as ref_heston_stats
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
from mcport_torch.engine.path_risk import run_heston_path_risk, run_resumable_path_risk
from mcport_torch.ops import heston as OHS
from mcport_torch.ops.hedged import HedgeTensors, hedged_multi_dd
from mcport_torch.options import HedgeSpec

torch.set_num_threads(1)   # the suite runs several xdist workers on shared cores

A = 3
NAMES = ["A0", "A1", "A2"]
S0 = np.array([100.0, 50.0, 20.0])
W = np.array([0.5, 0.3, 0.2])
REF_HESTON = RefHeston(
    mu=np.array([5e-4, 1e-3, 8e-4]), kappa=np.array([0.15, 0.1, 0.2]),
    theta=np.array([1e-4, 1.5e-4, 2e-4]), xi=np.array([3e-3, 4e-3, 2e-3]),
    rho=np.array([-0.5, -0.4, -0.6]), v0=np.array([1.2e-4, 1.5e-4, 1.8e-4]),
    corr_chol=np.linalg.cholesky(0.5 * np.eye(A) + 0.5), s0=S0)
HESTON = from_mcport(REF_HESTON)
ROWS = {0: [(RefLegType.BUY_ASSET, 0.0, 0.0, 1.0), (RefLegType.BUY_PUT, 95.0, 0.5, 1.0)],
        1: [(RefLegType.BUY_PUT, 45.0, 0.2, 1.0), (RefLegType.SELL_CALL, 56.0, 0.3, 1.0)]}
REF_SPEC = RefHedgeSpec.build({k: RefLegs.from_rows(v) for k, v in ROWS.items()}, NAMES)
SPEC = from_mcport(REF_SPEC)
HEDGE = HedgeTensors.from_spec(SPEC, S0, "cpu")
CFG = GBMConfig(n_paths=16_384, n_steps=12, path_block=4_096, seed=4)
REF_CFG = RefGBMConfig(n_paths=16_384, n_steps=12, path_block=4_096, seed=4)


def _f32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _mcport_settled(x: np.ndarray, w: np.ndarray, gross: np.ndarray | None = None):
    """mcport's hedged Heston recursion in JAX float32 on given log increments
    ``(n, T, A)``: ``p_new = p · exp(x)`` (``_heston_dd_kernel``'s hedged
    branch), the settlement of ``make_hedged_returns`` on the (A, n) layout of
    the TPU kernels, ``V *= 1 + w·r_h`` → (term, dd), each ``(W, n)``.
    ``gross``: the factors ``exp(x)`` as given, instead of XLA's ``exp``."""
    ht, hk, hp, hq = (jnp.asarray(a) for a in REF_SPEC.arrays)
    settle = make_hedged_returns(ht, hk.astype(jnp.float32), hp.astype(jnp.float32),
                                 hq.astype(jnp.float32))
    g = jnp.exp(jnp.asarray(x, jnp.float32)) if gross is None else jnp.asarray(gross)
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


def test_hedged_heston_settlement_matches_mcport_on_identical_increments():
    """On the same gross factors ``exp(x)`` (the prices then equal on both
    sides) the settlement and the candidates' recursion agree to 1e-6; with
    XLA's own ``exp`` the prices part by ulps, which in-the-money legs
    settled every step amplify, and mcport's recursion stays within the
    per-path bound of ``ops.heston.heston_price_bound``, built for just
    that."""
    from mcport_torch.ops.hedged import hedged_shares

    h = HESTON.tensors("cpu")
    x = OHS.heston_increments(*OHS.heston_shocks(3, h, 512, 26), h)[0]
    w = np.stack([W, np.full(A, 1.0 / A), np.eye(A)[0]])
    term, dd, bound = hedged_multi_dd(x, HEDGE, _f32(w),
                                      price_bound=OHS.heston_price_bound(h, 26))
    rterm, rdd = _mcport_settled(x.numpy(), w, gross=torch.exp(x).numpy())
    np.testing.assert_allclose(term.numpy(), rterm, rtol=0, atol=1e-6)
    np.testing.assert_allclose(dd.numpy(), rdd, rtol=0, atol=1e-6)
    xla = tuple(torch.as_tensor(np.array(a)) for a in _mcport_settled(x.numpy(), w))
    assert max(hedged_shares(xla, (term, dd, bound), None).values()) <= 1.0
    # the plain form itself is that recursion on its own increments
    plain = OHS.heston_multi_dd_reference(3, h, _f32(w), 512, 26, hedge=HEDGE)
    assert all(torch.equal(a, b[None]) for a, b in zip(plain, (term, dd)))


@pytest.mark.parametrize("xi", [None, 0.05])
def test_identity_hedge_is_the_unhedged_heston_mode(xi):
    """One BUY_ASSET leg per asset settles to the asset's return ``exp(x) -
    1``: the unhedged mode on the same counters within the per-path bound —
    also where the Feller condition fails (xi = 0.05), where a variance path
    one ulp off would leave it."""
    params = HESTON if xi is None else from_mcport(
        dataclasses.replace(REF_HESTON, xi=np.full(A, xi)))
    h = params.tensors("cpu")
    ident = HedgeTensors.from_spec(HedgeSpec.build(None, NAMES), S0, "cpu")
    w = _f32(np.random.default_rng(0).dirichlet(np.ones(A), 7))
    kw = dict(first_block=2, n_blocks=2)
    args = (9, h, w, 1_000, 52)
    hedged = OHS.heston_multi_portfolio_dd(*args, hedge=ident, **kw)
    plain = OHS.heston_multi_portfolio_dd(*args, **kw)
    bound = OHS.heston_multi_dd_reference(*args, hedge=ident, with_bound=True, **kw)[2]
    shares = OHS.heston_shares(hedged, (*plain, bound), h, 52, hedge=ident)
    assert max(shares.values()) <= 1.0, shares
    assert max(float((a - b).abs().max()) for a, b in zip(hedged, plain)) > 0.0


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


def test_hedged_heston_path_risk_matches_mcport_in_law():
    got = run_heston_path_risk(HESTON, W, CFG, hedge=SPEC, device="cpu")
    want = ref_heston_run(REF_HESTON, W, REF_CFG, hedge=REF_SPEC)
    assert got.n_paths == want.n_paths == CFG.n_paths
    term, dd = OHS.heston_multi_portfolio_dd(CFG.seed, HESTON.tensors("cpu"), _f32(W)[None],
                                             CFG.path_block, CFG.n_steps, first_block=0,
                                             n_blocks=CFG.n_paths // CFG.path_block,
                                             hedge=HEDGE)
    port, dd = term.double().numpy().ravel(), dd.double().numpy().ravel()
    se = {"var": _order_se(port, 0.05), "cvar": _es_se(port, 0.05),
          "port_mean": port.std() / np.sqrt(port.size),
          "dd_mean": dd.std() / np.sqrt(dd.size),
          "dd_p95": _order_se(dd, 0.05), "dd_median": _order_se(dd, 0.5)}
    for name, s in se.items():
        assert abs(getattr(got, name) - getattr(want, name)) <= 4 * np.sqrt(2) * s + 1e-6, name
    assert got.cvar <= got.var and -1 <= got.dd_p95 <= got.dd_median <= 0


def test_hedged_heston_split_resume_and_digest():
    cfg = GBMConfig(n_paths=8_192, n_steps=10, path_block=1_024, seed=2)
    full, ck_full = run_resumable_path_risk("heston", HESTON, W, cfg, hedge=SPEC,
                                            device="cpu")
    _, part = run_resumable_path_risk("heston", HESTON, W, cfg, hedge=SPEC, max_blocks=3,
                                      device="cpu")
    res, ck = run_resumable_path_risk("heston", HESTON, W, cfg, hedge=SPEC, checkpoint=part,
                                      device="cpu")
    assert ck.done and not part.done
    assert all(np.array_equal(getattr(ck, f), getattr(ck_full, f))
               for f in ("h_port", "h_dd", "s_port", "s_dd"))
    assert (res.var, res.dd_p95) == (full.var, full.dd_p95)
    # the spots default to the parameters' own, in the digest as in the paths
    res_s0, _ = run_resumable_path_risk("heston", HESTON, W, cfg, hedge=SPEC, s0=S0,
                                        checkpoint=part, device="cpu")
    assert (res_s0.var, res_s0.dd_p95) == (full.var, full.dd_p95)
    one_shot = run_heston_path_risk(HESTON, W, cfg, hedge=SPEC, device="cpu")
    assert one_shot == run_heston_path_risk(HESTON, W, cfg, hedge=SPEC, s0=S0, device="cpu")
    assert (one_shot.var, one_shot.dd_p95) == (full.var, full.dd_p95)
    for bad in (dict(hedge=None), dict(hedge=SPEC, s0=S0 * 1.01)):
        with pytest.raises(ValueError, match="digest"):
            run_resumable_path_risk("heston", HESTON, W, cfg, checkpoint=part, device="cpu",
                                    **bad)
    other = run_heston_path_risk(HESTON, W, cfg, hedge=SPEC, s0=S0 * 1.01, device="cpu")
    assert other != one_shot


def test_hedged_heston_frontier_scores_as_mcports_scorer():
    """The hedged frontier's scores are the plain scorer's on its weight
    matrix and paths (the optimum the best feasible mean), and agree with
    mcport's hedged lax scorer on the same candidates in law."""
    kw = dict(dd_budget=0.3, n_candidates=64, n_paths=2_048, n_steps=26)
    r = family_drawdown_frontier_search(4, "heston", HESTON, hedge=SPEC, s0=S0, device="cpu",
                                        **kw)
    assert r.opt_idx >= 0 and 0 < int(r.feasible.sum()) <= kw["n_candidates"]
    path_seed, _ = frontier_seeds(4)
    w = torch.as_tensor(r.weights, dtype=torch.float32)
    term, dd = OHS.heston_multi_dd_reference(path_seed, HESTON.tensors("cpu"), w,
                                             kw["n_paths"], kw["n_steps"], hedge=HEDGE)
    rterm, _ = ref_heston_stats(jax.random.key(4), REF_HESTON,
                                jnp.asarray(r.weights[:8], jnp.float32), kw["n_paths"],
                                kw["n_steps"], jnp.float32,
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


def test_hedged_heston_path_tail_risk_as_mcports():
    """``path_tail_risk`` fits the Heston model to the weekly fixtures and
    settles a married put and a collar against the last prices: mcport's
    keys and hedged assets, and exactly the engine's run on that fit with
    the last prices as spots."""
    from pathlib import Path

    from mcport_torch.models.heston import estimate_heston

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
    got = path_tail_risk(data, None, Config(gbm=GBMConfig(**small)), model="heston",
                         legs_by_asset=legs, device="cpu")
    want = ref_path_tail_risk(ref_data, None, RefConfig(gbm=RefGBMConfig(**small)),
                              model="heston", legs_by_asset=ref_legs)
    assert set(got) == set(want)
    assert got["hedged_assets"] == want["hedged_assets"] == list(data.names)
    assert got["n_paths"] == want["n_paths"] == 8_192
    rep = run_heston_path_risk(estimate_heston(data.prices), np.full(2, 0.5),
                               GBMConfig(**small), hedge=HedgeSpec.build(legs, data.names),
                               s0=last, device="cpu")
    assert (got["var"], got["cvar"], got["dd_p95"]) == (rep.var, rep.cvar, rep.dd_p95)
