"""The unhedged candidate kernels' score bounds on the CPU: ``heston_shares``
and ``garch_shares`` (through ``garch_value_bound``) count the score's
roundings at every step.

- The same returns scored in three orders — ascending assets from 0 with
  each term fused (the product in float64, then rounded to float32, as the
  kernels' ``fmaf``), ``r @ w.T`` (the plain forms' order, which the
  library picks by the problem's size), and descending assets with each
  product rounded — stay within the bound pair by pair, at the case that
  left the former bound on an H100 (2,053 x 2 paths, 12 candidates, 15
  assets, a vol of vol of 0.05, 252 steps) and at the GARCH bench. The
  share of the former bound, which counted the score's roundings once, is
  printed beside it.
- Planted faults of the unhedged candidates (the score in bfloat16, a
  drawdown off by 1e-3, a skipped step) still exceed the widened bounds
  more than 2x at the shapes ``chip_smoke.py`` checks (15 assets, 252
  steps). Each case prints its shares of the widened and of the former
  bound (``pytest -s``).
"""

import functools
import math

import numpy as np
import pytest
import torch

from mcport_torch.convert import garch_params_from_numpy, heston_params_from_numpy
from mcport_torch.ops import garch as OG
from mcport_torch.ops import heston as OH
from mcport_torch.ops.gbm import step_shocks

torch.set_num_threads(1)   # the suite runs several xdist workers on shared cores

A, N, EPS = 15, 252, 2.0 ** -24
MEAN = np.random.default_rng(A).normal(1e-3, 5e-4, A)
KW = dict(first_block=6, n_blocks=2)


@functools.cache
def _returns(family: str, paths: int):
    """The plain form's per-step returns ``(2, paths, 252, 15)`` (Heston: gross
    factors) and its parameters."""
    if family == "garch":
        s0 = np.full(A, 4e-4)
        g = garch_params_from_numpy(MEAN, 0.1 * s0, np.full(A, 0.08), np.full(A, 0.9),
                                    np.linalg.cholesky(0.5 * np.eye(A) + 0.5), s0,
                                    s0).tensors("cpu")
        z = step_shocks(11, A, paths, N, device="cpu", **KW)
        return g.mu + OG.garch_innovations(z @ torch.tril(g.corr_chol).T, g), g
    full = np.ones(A)
    xi = 0.05 if family == "heston feller" else 3e-3
    h = heston_params_from_numpy(MEAN, 0.15 * full, 4e-4 * full, xi * full, -0.5 * full,
                                 4e-4 * full, np.linalg.cholesky(0.5 * np.eye(A) + 0.5),
                                 100.0 * full).tensors("cpu")
    return torch.exp(OH.heston_increments(*OH.heston_shocks(11, h, paths, N, **KW), h)), h


def _score(r, w, gross, how="matmul"):
    """``(term, dd)`` ``(2, W, paths)`` of rebalanced wealth, each step's
    score summed ``how``; or a planted fault."""
    v = torch.ones(r.shape[:-2] + (w.shape[0],))
    peak, dd = torch.ones_like(v), torch.zeros_like(v)
    for t in range(r.shape[-2]):
        if how == "step skipped" and t == r.shape[-2] // 2:
            continue
        x = r[..., t, :]
        if how == "ascending fused":
            f = torch.zeros_like(v)
            for a in range(x.shape[-1]):
                f = (f.double() + x[..., a, None].double() * w[:, a].double()).float()
        elif how == "descending":
            f = torch.zeros_like(v)
            for a in reversed(range(x.shape[-1])):
                f = f + x[..., a, None] * w[:, a]
        elif how == "bfloat16 score":
            f = x.bfloat16().float() @ w.bfloat16().float().T
        else:
            f = x @ w.T
        v = v * (f if gross else 1.0 + f)
        peak = torch.maximum(peak, v)
        dd = torch.minimum(dd, v / peak - 1.0)
    if how == "dd off by 1e-3":
        dd = dd - 1e-3
    return torch.movedim(v - 1.0, -1, -2), torch.movedim(dd, -1, -2)


def _former(family, params) -> float:
    """The former value bound: the score's roundings counted once."""
    if family == "garch":
        return float(OG.garch_tolerance(params, N).max()) + 8.0 * EPS * (A + math.sqrt(N))
    return 8.0 * EPS * (A + 2.0 * math.sqrt(N))


def _shares(family, kern, plain, params, w, r, former=False):
    """The library's shares of ``kern`` against ``plain`` over the returns
    ``r`` (GARCH: the bound ``garch_value_bound`` gives the plain form), or
    with ``former`` their shares of the former bound."""
    if family == "garch":
        bound = (torch.full((w.shape[0], 1), _former(family, params)) if former
                 else OG.garch_value_bound(params, w, float(r.abs().max()), N))
        return OG.garch_shares(kern, (*plain, bound), params, N)
    scale = OH.heston_tolerance(A, N)[1] / _former(family, params) if former else 1.0
    return {k: v * scale for k, v in OH.heston_shares(kern, plain, params, N).items()}


@pytest.mark.parametrize("family, n_cand", [("heston feller", 12), ("garch", 13)])
def test_score_orders_stay_within_the_widened_bound(family, n_cand):
    """Three summation orders of the same score, pair by pair, within the
    widened bound (the card's cuBLAS order reached 1.037 of the former one
    here; descending assets reach about 1.6 of it on the CPU)."""
    r, params = _returns(family, 2_053)
    w = torch.as_tensor(np.random.default_rng(n_cand).dirichlet(np.ones(A), n_cand),
                        dtype=torch.float32)
    gross = family != "garch"
    outs = {how: _score(r, w, gross, how) for how in ("ascending fused", "matmul", "descending")}
    names = list(outs)
    for i, x in enumerate(names):
        for y in names[i + 1:]:
            share = max(_shares(family, outs[x], outs[y], params, w, r).values())
            old = max(_shares(family, outs[x], outs[y], params, w, r, former=True).values())
            print(f"{family} W={n_cand} {x} vs {y}: share {share:.4f} of the widened bound, "
                  f"{old:.4f} of the former")
            assert share <= 1.0, (x, y, share)
            assert share <= old, "the widened bound is never below the former"


@pytest.mark.parametrize("family", ["heston", "heston feller", "garch"])
@pytest.mark.parametrize("fault", ["bfloat16 score", "dd off by 1e-3", "step skipped"])
def test_widened_score_bounds_reject_planted_faults(family, fault):
    """Each planted fault of an unhedged candidate kernel uses more than
    twice the widened bound, and the sound scores none of it."""
    r, params = _returns(family, 512)
    w = torch.as_tensor(np.random.default_rng(13).dirichlet(np.ones(A), 13),
                        dtype=torch.float32)
    gross = family != "garch"
    right = _score(r, w, gross)
    assert max(_shares(family, right, right, params, w, r).values()) == 0.0
    wrong = _score(r, w, gross, fault)
    share = max(_shares(family, wrong, right, params, w, r).values())
    old = max(_shares(family, wrong, right, params, w, r, former=True).values())
    print(f"{family}, {A} assets, {N} steps, {fault}: {share:.3f} of the widened bound, "
          f"{old:.3f} of the former")
    assert share > 2.0
