"""DCC-GARCH(1,1) paths: the CUDA DCC kernels and their plain torch forms.

Port of ``mcport/ops/pallas_dcc.py``, every mode. Two kernels
(``csrc/dcc.cu``) replace the four TPU kernels — ``_dcc_pack_kernel`` and
``_dcc_kernel`` (the terminal returns in the TPU's pack and tile layouts) and
``_dcc_dd_kernel`` and ``_dcc_pack_dd_kernel`` (the candidates). Per path and
step they follow the pack kernel's formulation (``_make_pack_asset_step``),
from ``Q = q0``, ``e = e0`` and the GARCH state ``(sigma2_0, eps2_0)``:

    Q      = (1-a-b) S + a e e' + b Q          (S = corr_chol corr_chol')
    L      = chol(Q)                           (pivot floor rsqrt(max(d, 1e-12)))
    e_new  = diag(Q)^{-1/2} (L z)              (chol(R) = D^{-1/2} chol(Q))
    sigma2 = omega + alpha eps2 + beta sigma2,  eps = sqrt(max(sigma2, 0)) e_new

with ``diag(Q)`` read from the updated ``Q`` itself, and the return ``r = mu +
eps``; then

- :func:`dcc_terminal` compounds every asset, ``cum *= 1 + mu + eps`` → the
  terminal simple returns ``cum - 1``;
- :func:`dcc_multi_portfolio_dd` compounds ``W`` candidate portfolios'
  per-period rebalanced wealth ``V *= 1 + w·r`` (float32, mcport's
  ``score_dot``) with the running peak and maximum drawdown; hedged
  (``hedge``), the prices ``P *= 1 + mu + eps`` from the spots settle every
  option leg each step and ``V *= 1 + w·r_h`` (:mod:`mcport_torch.ops.hedged`),
  held to its plain form path by path by :func:`dcc_price_bound`.

The shocks ``z`` are the GBM kernels' normals on ``STREAM_GBM``
(:func:`mcport_torch.ops.gbm.step_shocks`), with the GARCH kernels' path, step
and asset mapping: with ``a = b = 0`` and ``q0 = S`` the recursion is
CCC-GARCH on the same shocks, up to the float32 Cholesky of ``S``. The plain
forms are ``step_shocks`` followed by :func:`dcc_innovations`, which rounds
every operation as IEEE float32 (``sqrt_rn``, :func:`rsqrt_rn`) and subtracts
the Cholesky sums in ascending order, as the kernels do.

Each wrapper dispatches on the device of its tensors: the CPU goes to the
plain form, a CUDA device launches the kernel or raises. The plain forms and
the card take any number of assets: past 16 through ``dcc_group_kernel``
(``csrc/dcc.cu``: a group of threads per path, a blocked right-looking
Cholesky bit for bit with the narrow kernels' sums; :func:`dcc_wide_plan`
sizes its grid and the device-memory slots of Q past ~220 assets). Up to 16
the candidates run ``dcc_dd_kernel`` in the layout :func:`dcc_narrow_plan`
gives their count: a thread per path scoring its own few candidates, or
past 4 candidates the recursion's returns through a device scratch that
the wrapper allocates, then blocks that score them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mcport_torch.ops.gbm import (MAX_ASSETS, _check_args, check_card_assets, sqrt_rn, step_shocks,
                                  wide_scratch)
from mcport_torch.ops.hedged import HedgeTensors, hedged_multi_dd, hedged_shares
from mcport_torch.ops.multi_dd import MAX_CANDIDATES, rebalanced_dd

__all__ = [
    "DccTensors",
    "DccPath",
    "rsqrt_rn",
    "dcc_innovations",
    "dcc_terminal_reference",
    "dcc_terminal",
    "dcc_multi_dd_reference",
    "dcc_multi_portfolio_dd",
    "dcc_tolerance",
    "dcc_price_bound",
    "dcc_shares",
    "DccWidePlan",
    "dcc_wide_plan",
    "DccNarrowPlan",
    "dcc_narrow_plan",
]

_EPS = 2.0 ** -24    # float32 unit roundoff
_FLOOR = 1e-12       # the pivot and diagonal floor of mcport's kernels
NARROW_ASSETS = 16   # the narrow kernels' widest universe (csrc/dcc.cu kDA)

# csrc/dcc.cu GroupLayout: threads per block, floats per tile of the factor
# and of Q, a block's shared memory (H100), and the H100's defaults for
# dcc_wide_plan
_GROUP_BLOCK, _TS, _QS, _GROUP_SMEM = 256, 20, 16, 232_448
_H100_SMS, _H100_SMEM_PER_SM = 132, 233_472
# csrc/dcc.cu dcc_dd_kernel (up to 16 assets): the solo layout's threads (a
# path each) and widest W, the scoring block's threads, the scratch's tile of
# paths and the returns a scoring block stages at once; and the most floats
# of returns a launch keeps in its scratch (2 GiB)
_SOLO_THREADS, _SOLO_MAX_CAND = 64, 4
_SCORE_THREADS, _TILE, _STAGE_FLOATS = 256, 16, 8192
NARROW_SCRATCH_FLOATS = 1 << 29


class DccNarrowPlan(NamedTuple):
    """How ``dcc_dd_kernel`` (up to 16 assets) runs W candidates:
    ``layout`` "solo" (a thread per path runs the recursion and scores its
    own candidates, one launch) or "split" (the same recursion writes every
    step's returns to a device scratch, then 256-thread blocks score them:
    two launches per chunk of paths); per launch, in launch order, its
    ``threads`` and ``paths`` per block and ``shared_bytes`` per block;
    ``scratch_floats`` of the returns and ``chunk`` paths per pair of
    launches (``block_paths`` where the scratch holds them all, else a
    multiple of 64)."""

    layout: str
    threads: tuple[int, ...]
    paths: tuple[int, ...]
    shared_bytes: tuple[int, ...]
    scratch_floats: int
    chunk: int


def _score_groups(n_cand: int) -> int:
    """csrc/dcc.cu ``score_groups``: the scoring block's groups of 4 paths."""
    pg = 4
    while pg * 2 * -(-n_cand // 4) <= _SCORE_THREADS:
        pg *= 2
    return pg


def _narrow_shared(n_assets: int, n_cand: int, mode: str, n_legs: int) -> int:
    """csrc/dcc.cu ``NarrowLayout(n_assets, n_cand, mode, n_legs).total``, in
    bytes."""
    r4 = lambda x: -(-x // 4) * 4  # noqa: E731
    tri = NARROW_ASSETS * (NARROW_ASSETS + 1) // 2
    recur = mode != "score"
    paths = _SOLO_THREADS if recur else 0
    h = r4(tri) + 4 * NARROW_ASSETS + {"solo": n_cand * NARROW_ASSETS,
                                       "score": n_assets * r4(n_cand)}.get(mode, 0)
    q = h + (r4(n_assets * (1 + 4 * n_legs)) if recur and n_legs > 0 else 0)
    st = q + r4(n_assets * (n_assets + 1) // 2 * paths) + 5 * n_assets * paths
    bp = 4 * _score_groups(n_cand)
    staged = min(max(_STAGE_FLOATS // (n_assets * bp), 1), 16) * n_assets * bp
    return 4 * (st + {"solo": 3 * n_cand * _SOLO_THREADS, "score": staged}.get(mode, 0))


def dcc_narrow_plan(n_assets: int, n_cand: int, n_steps: int = 52, block_paths: int = 131_072,
                    n_blocks: int = 1, n_legs: int = 0,
                    scratch_floats: int = NARROW_SCRATCH_FLOATS) -> DccNarrowPlan:
    """``dcc_dd_kernel``'s layout for ``n_cand`` candidates (W <= 256) at
    ``n_assets <= 16`` (csrc/dcc.cu ``narrow_mode`` and ``NarrowLayout``,
    the same arithmetic): solo up to 4 candidates, where the scoring is a few
    instructions beside the recursion's ~2,100 per path-step; split past
    them, where a thread per path could not hold the candidates' state and
    enough paths per SM to hide the recursion's latency. The split layout's
    scratch holds ``n_blocks x chunk x n_steps x n_assets`` returns, no more
    than ``scratch_floats``: the whole launch where that fits (up to 2 GiB:
    the frontier's 131,072 x 252 x 15 takes 1.98 GB), else chunks of whole
    64-path blocks."""
    a, w = int(n_assets), int(n_cand)
    if not 1 <= a <= NARROW_ASSETS or not 1 <= w <= MAX_CANDIDATES:
        raise ValueError(f"dcc_dd_kernel takes 1-{NARROW_ASSETS} assets and 1-{MAX_CANDIDATES} "
                         f"candidates, got {a} and {w}")
    if w <= _SOLO_MAX_CAND:
        return DccNarrowPlan("solo", (_SOLO_THREADS,), (_SOLO_THREADS,),
                             (_narrow_shared(a, w, "solo", n_legs),), 0, int(block_paths))
    per_path = int(n_blocks) * int(n_steps) * a
    tiles = lambda n: -(-n // _TILE) * _TILE  # noqa: E731
    chunk = int(block_paths)
    if per_path and int(scratch_floats) // per_path < tiles(chunk):
        chunk = int(scratch_floats) // per_path // _SOLO_THREADS * _SOLO_THREADS
        if chunk < 1:
            raise ValueError(f"a scratch of {int(scratch_floats):,} floats holds no "
                             f"{_SOLO_THREADS}-path chunk of {per_path:,} returns per path")
    return DccNarrowPlan("split", (_SOLO_THREADS, _SCORE_THREADS),
                         (_SOLO_THREADS, 4 * _score_groups(w)),
                         (_narrow_shared(a, w, "returns", n_legs),
                          _narrow_shared(a, w, "score", n_legs)),
                         per_path * tiles(chunk), chunk)


class DccWidePlan(NamedTuple):
    """Where ``dcc_group_kernel`` keeps a path at one width, and what its
    launch needs: ``group`` threads per path, ``paths`` per 256-thread block,
    ``shared_bytes`` of shared memory per block, whether Q and the Cholesky
    factor fit there (``q_shared``, ``w_shared``), ``slot_floats`` of a
    CTA's device-memory slot for those that do not, ``ctas`` the persistent
    grid and ``scratch_floats`` = ``ctas · slot_floats``."""

    group: int
    paths: int
    shared_bytes: int
    q_shared: bool
    w_shared: bool
    slot_floats: int
    ctas: int
    scratch_floats: int


def dcc_wide_plan(n_assets: int, hedged: bool, n_sms: int = _H100_SMS,
                  smem_per_sm: int = _H100_SMEM_PER_SM) -> DccWidePlan:
    """``dcc_group_kernel``'s layout at ``n_assets`` (csrc/dcc.cu
    ``GroupLayout``, the same arithmetic) and its grid on a card of ``n_sms``
    SMs with ``smem_per_sm`` bytes of shared memory each: as many blocks per
    SM as their shared memory (plus the 1 KB the CUDA runtime reserves per block) and
    2,048 threads allow, one where a path needs a slot. Q and then the
    factor move to a device-memory slot per path when a block cannot hold
    them (past 220 and 292 assets), so the scratch is sized by the SMs, not
    by the paths: 17.6 MB at 256 assets on an H100, inside its 50 MB L2. The
    kernel launches no more CTAs than this (fewer where its registers or the
    work allow fewer)."""
    a = int(n_assets)
    if a < 1:
        raise ValueError("the DCC kernels need at least one asset")
    group = 32 if a <= 32 else 64 if a <= 64 else 128 if a <= 128 else _GROUP_BLOCK
    paths = _GROUP_BLOCK // group
    t = (a + 3) // 4
    nt, ap = t * (t + 1) // 2, 4 * t
    for w_shared, q_shared in ((True, True), (True, False), (False, False)):
        per_path = ((nt * _TS if w_shared else 0) + (nt * _QS if q_shared else 0) + 8 * ap
                    + (ap if hedged else 0) + 4)
        shared = 4 * (paths * per_path + 2 * ap * paths)
        if shared <= _GROUP_SMEM:
            break
    else:
        raise ValueError(f"the DCC kernels' per-row state at {a} assets needs {shared:,} bytes "
                         f"of shared memory; a block has {_GROUP_SMEM:,}")
    slot = paths * ((0 if w_shared else nt * _TS) + (0 if q_shared else nt * _QS))
    per_sm = min(2048 // _GROUP_BLOCK if not slot else 1, int(smem_per_sm) // (shared + 1024))
    if per_sm < 1:
        raise ValueError(f"a DCC block needs {shared + 1024:,} bytes of shared memory; an SM "
                         f"has {int(smem_per_sm):,}")
    ctas = per_sm * int(n_sms)
    return DccWidePlan(group, paths, shared, q_shared, w_shared, slot, ctas, ctas * slot)


def _launch_wide(lib, seed, d, n_paths, n_steps, first_block, n_blocks, out, weights=None,
                 dd=None, hedge=None):
    """``mcport_dcc_wide`` on the current stream: the terminal function, or
    with ``weights`` the candidates' (hedged with ``hedge``); returns its
    error code."""
    a = d.n_assets
    props = torch.cuda.get_device_properties(d.device)
    plan = dcc_wide_plan(a, hedge is not None, props.multi_processor_count,
                         getattr(props, "shared_memory_per_multiprocessor", _H100_SMEM_PER_SM))
    scratch = (wide_scratch(plan.scratch_floats, d.device, "DCC") if plan.scratch_floats
               else None)
    params = d.packed()
    wt = weights.t().contiguous() if weights is not None else None
    block = hedge.packed() if hedge is not None else None
    n_cand = weights.shape[0] if weights is not None else 0
    stream = torch.cuda.current_stream(d.device).cuda_stream
    ptr = lambda x: x.data_ptr() if x is not None else None  # noqa: E731
    return lib.mcport_dcc_wide(seed, first_block, n_blocks, n_paths, a, n_cand, n_steps,
                               hedge.n_legs if hedge is not None else 0, params.data_ptr(),
                               ptr(wt), ptr(block), out.data_ptr(), ptr(dd), ptr(scratch),
                               plan.scratch_floats, stream)


class DccTensors(NamedTuple):
    """DCC-GARCH(1,1) parameters as float32 tensors on one device: ``mu``,
    ``omega``, ``alpha``, ``beta``, ``sigma2_0``, ``eps2_0``, ``e0`` (A,),
    ``s`` (A, A) the unconditional correlation ``corr_chol corr_chol'``,
    ``q0`` (A, A) the starting Q, and ``ab`` (2,) the news and persistence
    coefficients ``(a, b)``."""

    mu: torch.Tensor
    omega: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    sigma2_0: torch.Tensor
    eps2_0: torch.Tensor
    e0: torch.Tensor
    s: torch.Tensor
    q0: torch.Tensor
    ab: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.s.device

    @property
    def n_assets(self) -> int:
        return self.s.shape[0]

    def packed(self) -> torch.Tensor:
        """The kernels' parameter block: ``s`` and ``q0`` (A·A each,
        row-major), then mu, omega, alpha, beta, sigma2_0, eps2_0, e0 (A
        each), a and b; float32, contiguous."""
        return torch.cat([self.s.reshape(-1), self.q0.reshape(-1), self.mu, self.omega,
                          self.alpha, self.beta, self.sigma2_0, self.eps2_0, self.e0,
                          self.ab]).contiguous()


def _check(d: DccTensors, n_paths: int, n_steps: int, n_blocks: int) -> int:
    a = d.n_assets
    for name, x in d._asdict().items():
        want = (a, a) if name in ("s", "q0") else (2,) if name == "ab" else (a,)
        if x.dtype != torch.float32 or tuple(x.shape) != want or x.device != d.device:
            raise ValueError(f"DCC parameter {name} must be float32 {want} on "
                             f"{d.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    _check_args(d.s, n_paths, n_steps, n_blocks, "poly", None)
    return a


def rsqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 reciprocal square root, as the kernels'
    ``__frsqrt_rn`` computes it: the float64 value rounded to float32."""
    return torch.rsqrt(x.to(torch.float64)).to(torch.float32)


class DccPath(NamedTuple):
    """The plain form's own path quantities that :func:`dcc_price_bound`
    reads, per path and step: ``sigma (..., T, A)`` each step's volatility
    ``sqrt(max(sigma2, 0))``, ``row_l1 (..., T, A)`` the absolute row sums
    ``Σ_j |chol(R_t)_ij|`` of the step's correlation factor (``chol(R) =
    D^{-1/2} chol(Q)``, at most ``sqrt(i + 1)``) and ``q_max (..., T)`` the
    largest diagonal entry of ``Q_t``."""

    sigma: torch.Tensor
    row_l1: torch.Tensor
    q_max: torch.Tensor


def dcc_innovations(z: torch.Tensor, d: DccTensors, with_path: bool = False):
    """Innovations ``eps_t`` ``(..., T, A)`` from unit normal shocks ``z (...,
    T, A)``: the DCC recursion of the module docstring, one IEEE float32
    operation at a time in the kernels' order — the Q update as ``c0 S + a (e_i
    e_j) + b Q`` with ``c0 = (1 - a) - b``; the Cholesky column by column, each
    entry's sum subtracted in ascending k; ``L z`` summed in ascending j. The
    step's return is ``mu + eps_t``. With ``with_path``, also the path's
    :class:`DccPath`.

    The Cholesky runs right-looking: once column k is scaled, ``L_ik L_jk``
    is subtracted from every entry of the trailing block at once. Each entry
    still receives its products one at a time in ascending k, each product
    and each difference rounded once, so the result is the left-looking
    column-by-column sum of the kernels bit for bit, in ``A`` torch
    operations per step rather than ``A^2 / 2``."""
    a_c, b_c = d.ab[0], d.ab[1]
    cs = ((1.0 - a_c) - b_c) * d.s
    n = d.n_assets
    batch = z.shape[:-2]
    q = d.q0.expand(batch + (n, n))
    e = d.e0.expand(batch + (n,))
    s2 = d.sigma2_0.expand(batch + (n,))
    e2 = d.eps2_0.expand(batch + (n,))
    out, sig, rows, q_max = [], [], [], []
    for t in range(z.shape[-2]):
        q = cs + a_c * (e[..., :, None] * e[..., None, :]) + b_c * q
        w = q.clone()        # the trailing block, reduced column by column
        cols = []            # cols[k]: L[k:, k]
        for k in range(n):
            num = w[..., k:, k]
            inv = rsqrt_rn(torch.clamp_min(num[..., :1], _FLOOR))
            col = num * inv
            cols.append(col)
            if k + 1 < n:
                w[..., k + 1:, k + 1:] -= col[..., 1:, None] * col[..., None, 1:]
        zt = z[..., t, :]
        m = cols[0] * zt[..., :1]
        for j in range(1, n):
            m[..., j:] += cols[j] * zt[..., j:j + 1]
        diag = torch.diagonal(q, dim1=-2, dim2=-1)
        inv_d = rsqrt_rn(torch.clamp_min(diag, _FLOOR))
        e = m * inv_d
        s2 = d.omega + d.alpha * e2 + d.beta * s2
        vol = sqrt_rn(torch.clamp_min(s2, 0.0))
        eps = vol * e
        e2 = eps * eps
        out.append(eps)
        if with_path:
            l1 = cols[0].abs()
            for j in range(1, n):
                l1[..., j:] += cols[j].abs()
            sig.append(vol)
            rows.append(l1 * inv_d)
            q_max.append(diag.amax(dim=-1))
    if not out:
        eps = z.new_zeros(z.shape)
        if not with_path:
            return eps
        return eps, DccPath(eps, eps, z.new_zeros(z.shape[:-1]))
    eps = torch.stack(out, dim=-2)
    if not with_path:
        return eps
    return eps, DccPath(torch.stack(sig, dim=-2), torch.stack(rows, dim=-2),
                        torch.stack(q_max, dim=-1))


def _shocks(seed, d, n_paths, n_steps, first_block, n_blocks, first_path):
    return step_shocks(seed, d.n_assets, n_paths, n_steps, first_block=first_block,
                       n_blocks=n_blocks, first_path=first_path, device=d.device)


def dcc_terminal_reference(
    seed: int,
    d: DccTensors,
    n_paths: int,
    n_steps: int,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
    first_path: int = 0,
) -> torch.Tensor:
    """Plain torch form of the DCC terminal kernel: terminal simple returns
    ``(n_blocks, n_paths, A)`` float32 for paths ``first_path ..`` of each
    block. Runs on any device; the tests use it on the CPU and
    ``chip_smoke.py`` holds the kernel against it on the card."""
    _check(d, n_paths, n_steps, n_blocks)
    eps = dcc_innovations(_shocks(seed, d, n_paths, n_steps, first_block, n_blocks,
                                  first_path), d)
    cum = torch.ones_like(eps[..., 0, :])
    one_mu = 1.0 + d.mu
    for t in range(n_steps):
        cum = cum * (one_mu + eps[..., t, :])   # mcport's (1 + mu) + eps
    return cum - 1.0


def _launch_terminal(seed, d, n_paths, n_steps, first_block, n_blocks):
    from mcport_torch._build import library

    lib = library("dcc")
    a = d.n_assets
    out = torch.empty((n_blocks, n_paths, a), dtype=torch.float32, device=d.device)
    if n_paths == 0:
        return out
    with torch.cuda.device(d.device):
        if a > NARROW_ASSETS:   # dcc_group_kernel
            err = _launch_wide(lib, seed, d, n_paths, n_steps, first_block, n_blocks, out)
        else:
            params = d.packed()
            stream = torch.cuda.current_stream(d.device).cuda_stream
            err = lib.mcport_dcc_terminal(seed, first_block, n_blocks, n_paths, a, n_steps,
                                          params.data_ptr(), out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"DCC terminal kernel launch failed: CUDA error {err} "
                           f"({lib.mcport_error_string(err).decode()})")
    dcc_terminal.launches += 1
    dcc_terminal.wide_launches += int(a > MAX_ASSETS)
    return out


def dcc_terminal(
    seed: int,
    d: DccTensors,
    n_paths: int,
    n_steps: int,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
) -> torch.Tensor:
    """Terminal simple returns ``(n_blocks, n_paths, A)`` float32 of DCC-GARCH
    paths for the blocks ``first_block + 1 .. first_block + n_blocks`` of a
    run seeded ``seed`` (one block keyed by ``seed`` itself by default) —
    mcport's ``pallas_dcc_terminal_returns``.

    Parameters on a CUDA device launch the kernel, counted in
    ``dcc_terminal.launches``; on the CPU the plain form runs. Any other
    device, or a problem the kernel does not take, raises.
    """
    _check(d, n_paths, n_steps, n_blocks)
    if d.device.type == "cpu":
        return dcc_terminal_reference(seed, d, n_paths, n_steps, first_block=first_block,
                                      n_blocks=n_blocks)
    if d.device.type != "cuda":
        raise ValueError(f"no DCC kernel for device {d.device}")
    check_card_assets(d.n_assets, "DCC")
    return _launch_terminal(seed, d, n_paths, n_steps, first_block, n_blocks)


dcc_terminal.launches = 0
dcc_terminal.wide_launches = 0   # the wide layout's share of ``launches`` (A > 64)


def dcc_multi_dd_reference(
    seed: int,
    d: DccTensors,
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
    """Plain torch form of the DCC candidate kernel: ``(term, dd)``, each
    ``(n_blocks, W, n_paths)`` float32, for paths ``first_path ..`` of each
    block. ``hedge``: the hedged mode, mcport's ``_dcc_dd_kernel`` hedged
    branch — ``P_0 = s0``, ``P_t = P_{t-1} · (1 + mu + eps_t)`` (the gross
    rounded ``(1 + mu) + eps``, as :func:`dcc_terminal_reference` compounds
    it), every leg settled against the move
    (:func:`mcport_torch.ops.hedged.hedged_multi_dd`); with ``with_bound`` a
    third output bounds each (candidate, path)'s distance from the kernel,
    from this path's own :func:`dcc_price_bound`."""
    _check(d, n_paths, n_steps, n_blocks)
    z = _shocks(seed, d, n_paths, n_steps, first_block, n_blocks, first_path)
    if hedge is None:
        return rebalanced_dd(d.mu + dcc_innovations(z, d), weights)
    if not with_bound:
        return hedged_multi_dd((1.0 + d.mu) + dcc_innovations(z, d), hedge,
                               weights.to(torch.float32), gross=True)
    eps, path = dcc_innovations(z, d, with_path=True)
    return hedged_multi_dd((1.0 + d.mu) + eps, hedge, weights.to(torch.float32),
                           price_bound=dcc_price_bound(d, path), gross=True)


def _launch_dd(seed, d, weights, n_paths, n_steps, first_block, n_blocks, hedge=None):
    """Launch the candidate kernel for at most ``MAX_CANDIDATES``, hedged with
    ``hedge``."""
    from mcport_torch._build import library

    lib = library("dcc")
    w_cnt, a = weights.shape
    term = torch.empty((n_blocks, w_cnt, n_paths), dtype=torch.float32, device=d.device)
    dd = torch.empty((n_blocks, w_cnt, n_paths), dtype=torch.float32, device=d.device)
    if n_paths == 0:
        return term, dd
    with torch.cuda.device(d.device):
        if a > NARROW_ASSETS:   # dcc_group_kernel
            err = _launch_wide(lib, seed, d, n_paths, n_steps, first_block, n_blocks, term,
                               weights, dd, hedge)
        else:   # dcc_dd_kernel, its returns through a scratch past a few candidates
            plan = dcc_narrow_plan(a, w_cnt, n_steps, n_paths, n_blocks)
            scratch = (torch.empty(plan.scratch_floats, dtype=torch.float32, device=d.device)
                       if plan.scratch_floats else None)
            params = d.packed()
            weights = weights.contiguous()
            block = hedge.packed() if hedge is not None else None
            n_legs = hedge.n_legs if hedge is not None else 0
            hp = block.data_ptr() if block is not None else None
            stream = torch.cuda.current_stream(d.device).cuda_stream
            err = lib.mcport_dcc_multi_dd(seed, first_block, n_blocks, n_paths, a, w_cnt,
                                          n_steps, n_legs, params.data_ptr(),
                                          weights.data_ptr(), hp, term.data_ptr(),
                                          dd.data_ptr(),
                                          scratch.data_ptr() if scratch is not None else None,
                                          plan.scratch_floats, stream)
    if err:
        raise RuntimeError(f"DCC candidate kernel launch failed: CUDA error {err} "
                           f"({lib.mcport_error_string(err).decode()})")
    dcc_multi_portfolio_dd.launches += 1
    dcc_multi_portfolio_dd.wide_launches += int(a > MAX_ASSETS)
    if hedge is not None:
        dcc_multi_portfolio_dd.hedged_launches += 1
    return term, dd


def dcc_multi_portfolio_dd(
    seed: int,
    d: DccTensors,
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
    wealth over the DCC-GARCH paths of blocks ``first_block + 1 ..
    first_block + n_blocks`` — mcport's ``pallas_dcc_path_stats``.

    ``hedge`` (a :class:`mcport_torch.ops.hedged.HedgeTensors` on the same
    device) selects hedged per-step settlement, mcport's ``hedge_args``: the
    prices move ``P *= 1 + mu + eps`` from the spots, every leg settles each
    step, and the candidates compound ``V *= 1 + W·r_h``. More than
    ``MAX_CANDIDATES`` candidates run as several launches over the same paths.
    Tensors on a CUDA device launch the kernel, each launch counted in
    ``dcc_multi_portfolio_dd.launches`` (a hedged one in ``.hedged_launches``
    too); on the CPU the plain form runs. Any other device, or a problem the
    kernel does not take, raises.
    """
    a = _check(d, n_paths, n_steps, n_blocks)
    w = weights.to(torch.float32)
    if w.dim() != 2 or w.shape[1] != a or w.shape[0] < 1 or w.device != d.device:
        raise ValueError(f"weights must be (W >= 1, {a}) on {d.device}, got "
                         f"{tuple(w.shape)} on {w.device}")
    if hedge is not None:
        hedge.check(a, d.device)
    if d.device.type == "cpu":
        return dcc_multi_dd_reference(seed, d, w, n_paths, n_steps, first_block=first_block,
                                      n_blocks=n_blocks, hedge=hedge)[:2]
    if d.device.type != "cuda":
        raise ValueError(f"no DCC kernel for device {d.device}")
    check_card_assets(a, "DCC")
    parts = [_launch_dd(seed, d, w[i:i + MAX_CANDIDATES], n_paths, n_steps, first_block,
                        n_blocks, hedge)
             for i in range(0, w.shape[0], MAX_CANDIDATES)]
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts], dim=1), torch.cat([p[1] for p in parts], dim=1))


dcc_multi_portfolio_dd.launches = 0
dcc_multi_portfolio_dd.wide_launches = 0   # the wide layout's share of ``launches`` (A > 64)
dcc_multi_portfolio_dd.hedged_launches = 0   # the hedged mode's share of ``launches``


def _least_eigenvalues(d: DccTensors, n_steps: int) -> torch.Tensor:
    """``(T,)`` float64 lower bounds on the least eigenvalue of every path's
    ``Q_t``: ``Q_t ⪰ c0 S + b Q_{t-1}`` (``a e e'`` is positive
    semidefinite), so ``lambda_t >= c0 lambda(S) + b lambda_{t-1}`` from
    ``lambda_0 = lambda_min(q0)``, with ``lambda(S)`` the least eigenvalue of
    ``S`` (its largest where ``c0 < 0``)."""
    a_c, b_c = (float(x) for x in d.ab.to(torch.float64).cpu())
    c0 = 1.0 - a_c - b_c
    ev_s = torch.linalg.eigvalsh(d.s.to(torch.float64).cpu())
    q0 = d.q0.to(torch.float64).cpu()
    lam = float(torch.linalg.eigvalsh(0.5 * (q0 + q0.T)).min())
    floor = c0 * float(ev_s.min() if c0 >= 0.0 else ev_s.max())
    out = []
    for _ in range(n_steps):
        lam = floor + b_c * lam
        out.append(lam)
    return torch.tensor(out, dtype=torch.float64)


def dcc_price_bound(d: DccTensors, path: DccPath) -> torch.Tensor:
    """Bound ``(..., T, A)`` on the relative difference of the hedged DCC
    kernel's price ``P_t`` from its plain form's, at every step of every
    path, from the path's own quantities (``path``, :func:`dcc_innovations`
    ``with_path``).

    :func:`dcc_tolerance`'s terms, with this path's values where that bound
    takes the worst case over every path: per step the two sides differ by
    the draws (at most 2e-6 each, through this step's row of ``chol(R_t)``:
    ``2e-6 Σ_j |chol(R_t)_ij|``), by nvcc's contractions in the Q update, the
    Cholesky and ``L z`` (``4 (A + 2)`` roundings of ``e``, amplified by the
    square root of this step's condition bound ``kappa_t = A q_max,t /
    lambda_t``: ``q_max,t`` this path's largest diagonal of ``Q_t``,
    ``lambda_t`` a lower bound on every path's least eigenvalue of ``Q_t``,
    :func:`_least_eigenvalues`) — both scaled by this step's volatility
    ``sigma_t`` and :func:`dcc_tolerance`'s gain ``1 + 4a/(1-b)`` for a
    change of ``e`` that re-enters Q — and by two roundings of the gross
    return. Those differences add up like a random walk along the path,
    with the factor 4 of headroom of :func:`dcc_tolerance`: ``delta_t = 4
    sqrt(Σ_{s<=t} per_step_s^2)``. The hedged plain form turns it into a
    bound per (candidate, path) (:func:`mcport_torch.ops.hedged
    .hedged_multi_dd`, whose ``price_bound`` takes it step by step)."""
    n, steps = d.n_assets, path.sigma.shape[-2]
    a_c, b_c = (float(x) for x in d.ab.to(torch.float64).cpu())
    gain = 1.0 + (4.0 * a_c / (1.0 - b_c) if b_c < 1.0 else 0.0)
    dev = path.sigma.device
    lam = _least_eigenvalues(d, steps).to(dev).clamp_min(1e-12)
    kappa = n * path.q_max.to(torch.float64) / lam
    per_e = (2e-6 * path.row_l1.to(torch.float64)
             + 4.0 * (n + 2) * torch.sqrt(kappa)[..., None] * _EPS)
    per_step = 2.0 * _EPS + path.sigma.to(torch.float64) * gain * per_e
    return (4.0 * torch.sqrt(torch.cumsum(per_step ** 2, dim=-2))).to(torch.float32)


def dcc_tolerance(d: DccTensors, n_steps: int) -> torch.Tensor:
    """Relative bound per asset ``(A,)`` on ``|kernel - plain form|`` of a
    compounded DCC value: ``|Δ| <= rel_i · (1 + |plain|)`` for the terminal
    returns of :func:`dcc_terminal`.

    Per step the two sides differ by the draws (at most 2e-6 each, as
    :func:`mcport_torch.ops.gbm.kernel_tolerance` has it; a row of chol(R) has
    unit norm, so ``e`` moves by at most ``2e-6 sqrt(A)``), by the Q update,
    the Cholesky and ``L z`` (nvcc's FMAs against two roundings: about ``A +
    2`` roundings per entry, amplified by the square root of the condition
    of ``R_t``) and by the gross return (two roundings). The condition of
    ``R_t`` is at most ``A q_max / lambda``: ``lambda``, the least eigenvalue
    of every ``Q_t``, is at least ``min(lambda_min(q0), (1-a-b)
    lambda_min(S) / (1-b))`` (``Q_t ⪰ (1-a-b) lambda_min(S) I + b Q_{t-1}``);
    ``q_max``, the diagonal's scale, the larger of ``q0``'s and ``((1-a-b) +
    4a) / (1-b)``, with ``e^2`` at four times its unit mean. A change of
    ``e`` re-enters Q through ``a e e'`` and stays there for ``1/(1-b)``
    steps: a gain of ``1 + 4a/(1-b)``. The differences add up like a random
    walk over ``n`` steps, with a factor 4 of headroom; ``sigma`` is three
    times the largest of the start, the first step's and the unconditional
    volatility.
    """
    n = d.n_assets
    a_c, b_c = (float(x) for x in d.ab.to(torch.float64).cpu())
    c0 = max(1.0 - a_c - b_c, 0.0)
    s = d.s.to(torch.float64).cpu()
    q0 = d.q0.to(torch.float64).cpu()
    lam = float(torch.linalg.eigvalsh(0.5 * (q0 + q0.T)).min())
    q_max = float(torch.diagonal(q0).max())
    gain = 1.0
    if b_c < 1.0:
        lam = min(lam, c0 * float(torch.linalg.eigvalsh(s).min()) / (1.0 - b_c))
        q_max = max(q_max, (c0 * float(torch.diagonal(s).max()) + 4.0 * a_c) / (1.0 - b_c))
        gain += 4.0 * a_c / (1.0 - b_c)
    kappa = n * q_max / max(lam, 1e-12)
    per_e = 2e-6 * math.sqrt(n) + 4.0 * (n + 2) * math.sqrt(kappa) * _EPS
    s2_first = d.omega + d.alpha * d.eps2_0 + d.beta * d.sigma2_0
    persist = (d.alpha + d.beta).clamp_max(0.999)
    s2_bar = torch.maximum(torch.maximum(d.sigma2_0, s2_first), d.omega / (1.0 - persist))
    sigma = 3.0 * torch.sqrt(s2_bar.to(torch.float64).cpu())
    per_step = 2.0 * _EPS + sigma * gain * per_e
    return (4.0 * math.sqrt(max(n_steps, 1)) * per_step).to(torch.float32)


def dcc_shares(kernel, plain, d: DccTensors, n_steps: int,
               hedge: HedgeTensors | None = None) -> dict[str, float]:
    """The largest share of its bound that ``|kernel - plain|`` uses →
    ``{"term"}`` for a terminal tensor ``(..., A)``, ``{"term", "dd"}`` for a
    candidate pair ``(term, dd)``: the candidates' values are held to the
    largest asset bound plus ``8 · 2^-24 · (A + sqrt(n))`` for the score's sum
    over assets and the product over steps, the drawdown to twice that.
    Non-finite kernel values give ``inf``. Hedged (``hedge``): path by path
    against the bound that ``plain`` carries (:func:`dcc_multi_dd_reference`
    ``with_bound``), by :func:`mcport_torch.ops.hedged.hedged_shares`."""
    if hedge is not None:
        if len(plain) != 3:
            raise ValueError("a hedged comparison needs the plain form's bound (with_bound)")
        return hedged_shares(kernel, plain, None)
    rel = dcc_tolerance(d, n_steps).to(d.device)

    def share(k, p, tol):
        if not bool(torch.isfinite(k).all()):
            return math.inf
        return float(((k - p).abs() / tol).max()) if k.numel() else 0.0

    if isinstance(kernel, torch.Tensor):
        return {"term": share(kernel, plain, rel * (1.0 + plain.abs()))}
    r = float(rel.max()) + 8.0 * _EPS * (d.n_assets + math.sqrt(max(n_steps, 1)))
    return {"term": share(kernel[0], plain[0], r * (1.0 + plain[0].abs())),
            "dd": share(kernel[1], plain[1], torch.full_like(plain[1], 2.0 * r))}
