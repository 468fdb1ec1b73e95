"""Heston stochastic-volatility paths: the CUDA Heston kernels and their plain
torch forms.

Port of ``mcport/ops/pallas_heston.py``, the unhedged modes and the hedged
mode of ``_heston_dd_kernel``. Two kernels
(``csrc/heston.cu``) replace ``_heston_kernel`` and ``_heston_dd_kernel``:
per path and step they draw two normal fields — the return shocks ``z``
(``STREAM_GBM``, the GBM kernels' layout) and the variance shocks ``w``
(``STREAM_HESTON``, the same layout) — and advance the full-truncation Euler
scheme of mcport's ``_heston_step`` in its order of operations:

    zc = L_R z                       (lower triangle of the correlation factor)
    zv = rho zc + sqrt(1 - rho^2) w  (leverage; sqrt(1 - rho^2) in float32)
    vp = max(v, 0),  sv = sqrt(vp)
    x  = (mu - vp/2) + sv zc         (the step's log return)
    v  = v + kappa (theta - vp) + xi sv zv

- :func:`heston_terminal` sums ``acc += x`` per asset → the terminal simple
  returns ``expm1(acc)`` (mcport's lax form);
- :func:`heston_multi_portfolio_dd` compounds ``W`` candidate portfolios'
  per-period rebalanced wealth ``V *= W·exp(x)`` (float32, mcport's
  ``score_dot``) with the running peak and maximum drawdown; hedged, every
  path carries its prices ``P *= exp(x)`` from the spots, settles the option
  legs against each move and compounds ``V *= 1 + W·r_h``
  (:mod:`mcport_torch.ops.hedged`).

The plain forms are two :func:`mcport_torch.ops.gbm.step_shocks` calls plus
:func:`heston_increments`. Each wrapper dispatches on the device of its
tensors: the CPU goes to the plain form, a CUDA device launches the kernel or
raises. The plain forms and the card take any number of assets: from 17 to
64 through the kernels' wide variants, past 64 through the layout of
``csrc/wide.cuh`` (``csrc/heston.cu``'s HestonWide), the path state bit for
bit at every width. Up to 16 assets the candidate kernel runs the layout
:func:`heston_narrow_plan` gives its candidate count
(:mod:`mcport_torch.ops.narrow`): a thread per path scoring its own few
candidates, for more the same recursion's returns through a device scratch,
scored by blocks of candidates, and past 128 candidates a 16-path tile whose
items and scorers run one Philox call apart; the layouts' outputs are equal
bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mcport_torch.ops.gbm import (MAX_ASSETS, WIDE_CTAS, _check_args, check_card_assets, sqrt_rn,
                                  step_shocks, wide_scratch, wide_tile)
from mcport_torch.ops.hedged import HedgeTensors, hedged_multi_dd, hedged_shares
from mcport_torch.ops.multi_dd import MAX_CANDIDATES, rebalanced_dd
from mcport_torch.ops.narrow import (LAYOUTS, NARROW_ASSETS, NARROW_SCRATCH_FLOATS, NarrowPlan,
                                     narrow_plan, r4)
from mcport_torch.rng import STREAM_HESTON

__all__ = [
    "HestonTensors",
    "heston_shocks",
    "heston_increments",
    "heston_terminal_reference",
    "heston_terminal",
    "heston_multi_dd_reference",
    "heston_multi_portfolio_dd",
    "heston_price_bound",
    "heston_tolerance",
    "heston_shares",
    "heston_narrow_plan",
]

#: csrc/heston.cu ``kSoloMaxCand`` and ``kSplitMaxCand``: the solo and split
#: layouts' widest W (the tile layout past them)
_SOLO_MAX_CAND, _SPLIT_MAX_CAND = 12, 128


def _recur_floats(a: int, w: int, own: bool, legs: int) -> int:
    """csrc/heston.cu ``RecurLayout(a, w, own ? kOwn : kReturns, legs).total``."""
    wv = 16 * 16 + 2 * 4 * 16 + (r4(a * (1 + 4 * legs)) if legs else 0) + (w * 16 if own else 0)
    return wv + 4 * 16 * 64 + (16 * 64 if legs else 0) + (3 * w * 64 if own else 0)


def _tile_floats(a: int, w: int, legs: int) -> int:
    """csrc/heston.cu ``TileLayout(a, round4(w), legs).total``."""
    h = 16 * 16 + 2 * 4 * 16 + (r4(a * (1 + 4 * legs)) if legs else 0)
    return h + a * r4(w) + 2 * 2 * 4 * a * 16


def heston_narrow_plan(n_assets: int, n_cand: int, n_steps: int = 252,
                       block_paths: int = 131_072, n_blocks: int = 1, n_legs: int = 0,
                       scratch_floats: int = NARROW_SCRATCH_FLOATS,
                       layout: str | None = None) -> NarrowPlan:
    """The Heston candidate kernel's layout for ``n_cand`` candidates (W <=
    256) at ``n_assets <= 16`` (csrc/heston.cu ``narrow_layout`` and its
    layouts' shared memory, the same arithmetic): solo up to 12 candidates,
    split up to 128, tile past them (on an H100 the fastest of the three at
    each W, measured by ``tools/ab_narrow_kernels.py``), or ``layout`` by
    name. The split layout's scratch holds ``n_blocks x chunk x n_steps x
    n_assets`` returns, no more than ``scratch_floats``."""
    return narrow_plan("the Heston candidate kernel", n_assets, n_cand, n_steps, block_paths,
                       n_blocks, n_legs, scratch_floats, _SOLO_MAX_CAND, _SPLIT_MAX_CAND,
                       _recur_floats, _tile_floats, layout)


_EPS = 2.0 ** -24    # float32 unit roundoff


class HestonTensors(NamedTuple):
    """Heston parameters as float32 tensors on one device: ``mu``, ``kappa``,
    ``theta``, ``xi``, ``rho``, ``v0`` (A,) and ``corr_chol`` (A, A), the lower
    Cholesky factor of the return shocks' correlation."""

    mu: torch.Tensor
    kappa: torch.Tensor
    theta: torch.Tensor
    xi: torch.Tensor
    rho: torch.Tensor
    v0: torch.Tensor
    corr_chol: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.corr_chol.device

    @property
    def rho_c(self) -> torch.Tensor:
        """``sqrt(1 - rho^2)`` in float32, as mcport's kernel computes it."""
        return sqrt_rn(1.0 - self.rho * self.rho)

    def packed(self) -> torch.Tensor:
        """The kernels' parameter block: ``corr_chol`` (A·A, row-major), then
        mu, kappa, theta, xi, rho, sqrt(1 - rho^2), v0 (A each), float32,
        contiguous."""
        return torch.cat([self.corr_chol.reshape(-1), self.mu, self.kappa, self.theta,
                          self.xi, self.rho, self.rho_c, self.v0]).contiguous()


def _check(h: HestonTensors, n_paths: int, n_steps: int, n_blocks: int) -> int:
    a = h.corr_chol.shape[0]
    for name, x in h._asdict().items():
        want = (a, a) if name == "corr_chol" else (a,)
        if x.dtype != torch.float32 or tuple(x.shape) != want or x.device != h.device:
            raise ValueError(f"Heston parameter {name} must be float32 {want} on "
                             f"{h.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    _check_args(h.corr_chol, n_paths, n_steps, n_blocks, "poly", None)
    return a


def heston_shocks(seed: int, h: HestonTensors, n_paths: int, n_steps: int, *,
                  first_block: int = -1, n_blocks: int = 1,
                  first_path: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """``(zc, w)``, each ``(n_blocks, n_paths, n_steps, A)`` float32 on the
    kernels' counters: the correlated return shocks ``L_R z`` and the variance
    shocks. As in the kernels, only the lower triangle of ``L_R`` is read and
    ``zc_i`` is summed term by term in column order, each product and sum
    rounded once, so that the kernels' path state can equal this form's bit
    for bit."""
    kw = dict(first_block=first_block, n_blocks=n_blocks, first_path=first_path,
              device=h.device)
    a = h.corr_chol.shape[0]
    z = step_shocks(seed, a, n_paths, n_steps, **kw)
    w = step_shocks(seed, a, n_paths, n_steps, stream=STREAM_HESTON, **kw)
    chol = torch.tril(h.corr_chol)
    zc = torch.zeros_like(z)
    for j in range(a):
        zc = zc + chol[:, j] * z[..., j:j + 1]
    return zc, w


def heston_increments(zc: torch.Tensor, w: torch.Tensor, h: HestonTensors) -> torch.Tensor:
    """Log returns ``x_t`` ``(..., T, A)`` of the full-truncation scheme from
    correlated return shocks ``zc`` and variance shocks ``w`` ``(..., T,
    A)``, the variance starting at ``v0`` — mcport's ``_heston_step`` in its
    order of operations."""
    v = h.v0.expand(zc.shape[:-2] + zc.shape[-1:])
    rho_c = h.rho_c
    out = []
    for t in range(zc.shape[-2]):
        zct = zc[..., t, :]
        zv = h.rho * zct + rho_c * w[..., t, :]
        vp = torch.clamp_min(v, 0.0)
        sv = sqrt_rn(vp)
        out.append((h.mu - 0.5 * vp) + sv * zct)
        v = v + h.kappa * (h.theta - vp) + h.xi * sv * zv
    if not out:
        return zc.new_zeros(zc.shape)
    return torch.stack(out, dim=-2)


def heston_terminal_reference(
    seed: int,
    h: HestonTensors,
    n_paths: int,
    n_steps: int,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
    first_path: int = 0,
) -> torch.Tensor:
    """Plain torch form of the Heston terminal kernel: terminal simple returns
    ``expm1(Σ_t x_t)`` ``(n_blocks, n_paths, A)`` float32 for paths
    ``first_path ..`` of each block, the sum taken step by step. Runs on any
    device; the tests use it on the CPU and ``chip_smoke.py`` holds the kernel
    against it on the card."""
    _check(h, n_paths, n_steps, n_blocks)
    x = heston_increments(*heston_shocks(seed, h, n_paths, n_steps, first_block=first_block,
                                         n_blocks=n_blocks, first_path=first_path), h)
    acc = torch.zeros_like(x[..., 0, :])
    for t in range(n_steps):
        acc = acc + x[..., t, :]
    return torch.expm1(acc)


def _launch_terminal(seed, h, n_paths, n_steps, first_block, n_blocks, wide=False):
    """Launch kernel #9; ``wide`` takes the 17-64-asset tile kernel at any
    width (``chip_smoke.py`` times the two layouts at 15 assets)."""
    from mcport_torch._build import library

    lib = library("heston")
    a = h.corr_chol.shape[0]
    out = torch.empty((n_blocks, n_paths, a), dtype=torch.float32, device=h.device)
    if n_paths == 0:
        return out
    params = h.packed()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        if a > MAX_ASSETS:   # csrc/wide.cuh's layout: v, four variance shocks, the log sum
            tp = wide_tile(a)
            scratch = wide_scratch(6 * a * WIDE_CTAS * tp, h.device, "Heston")
            err = lib.mcport_heston_wide(seed, first_block, n_blocks, n_paths, a, 0, n_steps, 0,
                                         params.data_ptr(), None, None, out.data_ptr(), None,
                                         scratch.data_ptr(), tp, WIDE_CTAS, stream)
        else:
            err = lib.mcport_heston_terminal(seed, first_block, n_blocks, n_paths, a, n_steps,
                                             int(wide), params.data_ptr(), out.data_ptr(),
                                             stream)
    if err:
        raise RuntimeError(f"Heston terminal kernel launch failed: CUDA error {err} "
                           f"({lib.mcport_error_string(err).decode()})")
    heston_terminal.launches += 1
    heston_terminal.wide_launches += int(a > MAX_ASSETS)
    return out


def heston_terminal(
    seed: int,
    h: HestonTensors,
    n_paths: int,
    n_steps: int,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
) -> torch.Tensor:
    """Terminal simple returns ``(n_blocks, n_paths, A)`` float32 of Heston
    paths for the blocks ``first_block + 1 .. first_block + n_blocks`` of a run
    seeded ``seed`` (one block keyed by ``seed`` itself by default) —
    mcport's ``pallas_heston_terminal_returns``.

    Parameters on a CUDA device launch the kernel, counted in
    ``heston_terminal.launches``; on the CPU the plain form runs. Any other
    device, or a problem the kernel does not take, raises.
    """
    _check(h, n_paths, n_steps, n_blocks)
    if h.device.type == "cpu":
        return heston_terminal_reference(seed, h, n_paths, n_steps, first_block=first_block,
                                         n_blocks=n_blocks)
    if h.device.type != "cuda":
        raise ValueError(f"no Heston kernel for device {h.device}")
    check_card_assets(h.corr_chol.shape[0], "Heston")
    return _launch_terminal(seed, h, n_paths, n_steps, first_block, n_blocks)


heston_terminal.launches = 0
heston_terminal.wide_launches = 0   # the wide layout's share of ``launches`` (A > 64)


def heston_multi_dd_reference(
    seed: int,
    h: HestonTensors,
    weights: torch.Tensor,
    n_paths: int,
    n_steps: int,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
    first_path: int = 0,
    hedge: HedgeTensors | None = None,
    with_bound: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Plain torch form of the Heston candidate kernel: ``(term, dd)``, each
    ``(n_blocks, W, n_paths)`` float32, for paths ``first_path ..`` of each
    block. ``hedge``: the hedged mode, mcport's ``_heston_dd_kernel`` hedged
    branch — ``P_0 = s0``, ``P_t = P_{t-1} · exp(x_t)`` on the same log
    increments, every leg settled against the move
    (:func:`mcport_torch.ops.hedged.hedged_multi_dd`); with ``with_bound`` a
    third output bounds each (candidate, path)'s distance from the kernel
    (:func:`heston_price_bound`)."""
    _check(h, n_paths, n_steps, n_blocks)
    x = heston_increments(*heston_shocks(seed, h, n_paths, n_steps, first_block=first_block,
                                         n_blocks=n_blocks, first_path=first_path), h)
    if hedge is None:
        return rebalanced_dd(torch.exp(x), weights, gross=True)
    return hedged_multi_dd(x, hedge, weights.to(torch.float32),
                           price_bound=(heston_price_bound(h, n_steps).to(h.device)
                                        if with_bound else None))


def _launch_dd(seed, h, weights, n_paths, n_steps, first_block, n_blocks, wide=False,
               hedge=None, layout=None):
    """Launch kernel #10 for at most ``MAX_CANDIDATES``, hedged with ``hedge``;
    up to 16 assets in the layout of :func:`heston_narrow_plan`, or in
    ``layout`` by name; ``wide`` takes the 64-asset instantiation at any width
    up to 64."""
    from mcport_torch._build import library

    lib = library("heston")
    w_cnt, a = weights.shape
    term = torch.empty((n_blocks, w_cnt, n_paths), dtype=torch.float32, device=h.device)
    dd = torch.empty((n_blocks, w_cnt, n_paths), dtype=torch.float32, device=h.device)
    if n_paths == 0:
        return term, dd
    params = h.packed()
    weights = weights.contiguous()
    block = hedge.packed() if hedge is not None else None
    n_legs = hedge.n_legs if hedge is not None else 0
    hp = block.data_ptr() if block is not None else None
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        if a > MAX_ASSETS:   # csrc/wide.cuh's layout: v, four variance shocks, hedged the price
            tp = wide_tile(a)
            scratch = wide_scratch((6 if hedge is not None else 5) * a * WIDE_CTAS * tp,
                                   h.device, "Heston")
            err = lib.mcport_heston_wide(seed, first_block, n_blocks, n_paths, a, w_cnt,
                                         n_steps, n_legs, params.data_ptr(), weights.data_ptr(),
                                         hp, term.data_ptr(), dd.data_ptr(), scratch.data_ptr(),
                                         tp, WIDE_CTAS, stream)
        else:
            scratch, code = None, -1
            if a <= NARROW_ASSETS and not wide:
                plan = heston_narrow_plan(a, w_cnt, n_steps, n_paths, n_blocks, n_legs,
                                          layout=layout)
                code = -1 if layout is None else LAYOUTS[plan.layout]
                if plan.scratch_floats:
                    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32,
                                          device=h.device)
            err = lib.mcport_heston_multi_dd(
                seed, first_block, n_blocks, n_paths, a, w_cnt, n_steps, int(wide), n_legs,
                params.data_ptr(), weights.data_ptr(), hp, term.data_ptr(), dd.data_ptr(),
                scratch.data_ptr() if scratch is not None else None,
                scratch.numel() if scratch is not None else 0, code, stream)
    if err:
        raise RuntimeError(f"Heston candidate kernel launch failed: CUDA error {err} "
                           f"({lib.mcport_error_string(err).decode()})")
    heston_multi_portfolio_dd.launches += 1
    heston_multi_portfolio_dd.wide_launches += int(a > MAX_ASSETS)
    if hedge is not None:
        heston_multi_portfolio_dd.hedged_launches += 1
    return term, dd


def heston_multi_portfolio_dd(
    seed: int,
    h: HestonTensors,
    weights: torch.Tensor,
    n_paths: int,
    n_steps: int,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
    hedge: HedgeTensors | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(terminal returns, max drawdowns), each ``(n_blocks, W, n_paths)``
    float32, of ``W`` candidates ``weights (W, A)`` compounding rebalanced
    wealth ``V *= W·exp(x)`` over the Heston paths of blocks ``first_block +
    1 .. first_block + n_blocks`` — mcport's ``pallas_heston_path_stats``.

    ``hedge`` (a :class:`mcport_torch.ops.hedged.HedgeTensors` on the same
    device) selects hedged per-step settlement, mcport's ``hedge_args``: the
    prices move ``P *= exp(x)`` from the spots, every leg settles each step,
    and the candidates compound ``V *= 1 + W·r_h``. More than
    ``MAX_CANDIDATES`` candidates run as several launches over the same
    paths. Tensors on a CUDA device launch the kernel, each launch counted in
    ``heston_multi_portfolio_dd.launches`` (a hedged one in
    ``.hedged_launches`` too); on the CPU the plain form runs. Any other
    device, or a problem the kernel does not take, raises.
    """
    a = _check(h, n_paths, n_steps, n_blocks)
    w = weights.to(torch.float32)
    if w.dim() != 2 or w.shape[1] != a or w.shape[0] < 1 or w.device != h.device:
        raise ValueError(f"weights must be (W >= 1, {a}) on {h.device}, got "
                         f"{tuple(w.shape)} on {w.device}")
    if hedge is not None:
        hedge.check(a, h.device)
    if h.device.type == "cpu":
        return heston_multi_dd_reference(seed, h, w, n_paths, n_steps,
                                         first_block=first_block, n_blocks=n_blocks,
                                         hedge=hedge)[:2]
    if h.device.type != "cuda":
        raise ValueError(f"no Heston kernel for device {h.device}")
    check_card_assets(a, "Heston")
    parts = [_launch_dd(seed, h, w[i:i + MAX_CANDIDATES], n_paths, n_steps, first_block,
                        n_blocks, hedge=hedge)
             for i in range(0, w.shape[0], MAX_CANDIDATES)]
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts], dim=1), torch.cat([p[1] for p in parts], dim=1))


heston_multi_portfolio_dd.launches = 0
heston_multi_portfolio_dd.wide_launches = 0   # the wide layout's share of ``launches`` (A > 64)
heston_multi_portfolio_dd.hedged_launches = 0   # the hedged mode's share of ``launches``


def heston_price_bound(h: HestonTensors, n_steps: int) -> torch.Tensor:
    """Per-asset bound ``(A,)`` on the relative difference of the hedged
    Heston kernel's price ``P`` from its plain form's at any step.

    The log increments ``x`` are the same bits on both sides (the variance
    path is bit for bit), so only the price update ``P·exp(x)`` differs. Per
    step, each side's ``exp`` lies within 2 ulps of ``e^x`` (CUDA's
    ``expf``; torch's ``exp``) — 2 ulps are at most ``2 · 2^-23`` of the
    value — so the two factors differ by at most ``8 · 2^-24`` relatively,
    and each side rounds its product ``P·g`` once, ``2^-24`` each: ``10 ·
    2^-24`` per step. Those differences are rounding artefacts, independent
    from step to step, so over ``n`` steps they add up like a random walk,
    with the factor 4 of headroom of :func:`mcport_torch.ops.garch
    .garch_tolerance`: ``4 sqrt(n) · 10 · 2^-24``. (Added up in the worst
    case, ``n · 10 · 2^-24``, the bound would grow with ``n`` as a drawdown
    error does, and could no longer tell settlement in bfloat16 from a sound
    kernel at 252 steps.) Nothing else enters; the hedged plain form turns it
    into a bound per (candidate, path) (:func:`mcport_torch.ops.hedged
    .hedged_multi_dd`)."""
    per_step = 10.0 * _EPS
    a = h.corr_chol.shape[0]
    return torch.full((a,), 4.0 * math.sqrt(max(n_steps, 1)) * per_step, dtype=torch.float32)


def heston_tolerance(n_assets: int, n_steps: int) -> tuple[float, float]:
    """Relative bounds on ``|kernel - plain form|`` → ``(terminal, value)``.

    The kernels' path state (``v``, ``x``, ``acc``) equals the plain form's
    bit for bit, so only the transcendentals that leave the path and the
    candidates' score differ. Terminal: ``expm1`` of the same ``acc`` on two
    implementations, each within an ulp, four ulps with headroom: ``|Δ| <=
    2^-21 |plain|``. Value: at every step each ``exp`` lies within two ulps
    on either side (``8 · 2^-24`` between them), the score sums its ``A``
    positive terms in an order of its own (``A`` roundings: the kernels
    ascend the assets, the plain form's ``r @ w.T`` sums in whatever order
    the library picks for the problem's size) and each side rounds its
    product once: ``(A + 10) · 2^-24`` per step. Every one of these enters
    at every step, so over ``n`` steps they add up like a random walk,
    ``sqrt(n) (A + 10) 2^-24``; the bound is ``8 · 2^-24 · (A + 2)
    sqrt(n)``, at least twice that at every ``A`` and never below the
    former bound, which counted the score's roundings once (``8 · 2^-24 ·
    (A + 2 sqrt(n))``). The terminal return then differs by at most ``rel ·
    (1 + |term|)``, the drawdown by ``2 · rel``."""
    return 2.0 ** -21, 8.0 * _EPS * (n_assets + 2.0) * math.sqrt(max(n_steps, 1))


def heston_shares(kernel, plain, h: HestonTensors, n_steps: int,
                  hedge: HedgeTensors | None = None) -> dict[str, float]:
    """The largest share of its bound (:func:`heston_tolerance`) that ``|kernel
    - plain|`` uses → ``{"term"}`` for a terminal tensor ``(..., A)``,
    ``{"term", "dd"}`` for a candidate pair ``(term, dd)``. Non-finite kernel
    values give ``inf``. Hedged (``hedge``): path by path against the bound
    that ``plain`` carries (:func:`heston_multi_dd_reference` ``with_bound``),
    by :func:`mcport_torch.ops.hedged.hedged_shares`."""
    if hedge is not None:
        if len(plain) != 3:
            raise ValueError("a hedged comparison needs the plain form's bound (with_bound)")
        return hedged_shares(kernel, plain, None)
    term_rel, rel = heston_tolerance(h.corr_chol.shape[0], n_steps)

    def share(k, p, tol):
        if not bool(torch.isfinite(k).all()):
            return math.inf
        return float(((k - p).abs() / tol).max()) if k.numel() else 0.0

    if isinstance(kernel, torch.Tensor):
        return {"term": share(kernel, plain, term_rel * plain.abs() + 1e-30)}
    return {"term": share(kernel[0], plain[0], rel * (1.0 + plain[0].abs())),
            "dd": share(kernel[1], plain[1], torch.full_like(plain[1], 2.0 * rel))}
