"""Correlated-GBM terminal sampler: the CUDA terminal-noise kernel and its
plain torch form.

Port of the terminal part of ``mcport/ops/pallas_gbm.py``. The kernel
(``csrc/terminal_noise.cu``) replaces ``_terminal_noise_kernel``: for each
path it sums ``n_steps`` normal draws per asset (or unit-variance Student-t
draws), then applies one ``L · Σz`` — the identity ``Σ_t L z_t = L Σ_t z_t``
keeps the Cholesky product out of the step loop.

The draw math is mcport's, polynomial for polynomial: ``ln_poly``,
``sincos_poly`` and ``exp_poly`` evaluate ln, sin/cos and exp with FMA-friendly
polynomials, the normal tiers are Box-Muller pairs ("poly", the exact-f32
default; "poly_fast", the degree-5 screening fits) and the t tier is Bailey's
polar transform. Only the bit source changed: Philox4x32-10 keyed per block
(:mod:`mcport_torch.rng`), the same counters in the kernel and here.

How a sampler consumes the Philox calls of one (block, path, asset):

- normal tiers: pair ``i`` (steps ``2i`` and ``2i+1``) is Box-Muller of
  words (0, 1) of call ``i // 2`` when ``i`` is even, of words (2, 3) when odd;
- t tier: pair ``i`` is two polar-t draws from words (0, 1) and (2, 3) of
  call ``i``;
- an odd ``n_steps`` adds one more pair index, ``n_steps // 2``, of which only
  the first draw is used — the pair and odd-step logic of the TPU kernel.

:func:`gbm_terminal_noise` dispatches on the device of its tensor: a CPU tensor
goes to :func:`terminal_noise_reference`, a CUDA tensor launches the kernel or
raises. There is no fallback from the card to the plain form.
"""

from __future__ import annotations

import math

import torch

from mcport_torch.seeding import SEED_STRIDE
from mcport_torch.rng import STREAM_GBM, bits_to_unit, philox4x32

__all__ = [
    "MAX_ASSETS",
    "WIDE_CTAS",
    "check_card_assets",
    "wide_tile",
    "wide_scratch",
    "sqrt_rn",
    "ln_poly",
    "sincos_poly",
    "exp_poly",
    "BM_VARIANTS",
    "t_draw",
    "block_seeds",
    "step_shocks",
    "terminal_noise_reference",
    "gbm_terminal_noise",
    "kernel_tolerance",
    "t_scaled_chol",
    "block_terminal_log_returns",
    "terminal_log_returns",
]

#: Widest universe of the kernels' narrow layouts on the card (csrc/gbm_draws.cuh
#: kMaxAssets). Past it every kernel runs the wide layout of csrc/wide.cuh: the
#: card takes any width whose scratch fits its memory, as the plain forms do.
MAX_ASSETS = 64
#: Persistent CTAs of a wide launch (csrc/wide.cuh): four per SM of an H100.
#: The scratch has one slot per CTA, so its size does not grow with the paths.
WIDE_CTAS = 528
_WIDE_SHOCK_BYTES = 100 * 1024   # the shock tile's share of a block's shared memory
_SHARED_BYTES = 232_448          # a block's shared memory on the H100

# degree-10 Chebyshev fit of ln(1+x)/x on [sqrt(2)/2-1, sqrt(2)-1], highest
# coefficient first — mcport's _LN1P_COEF (5.1e-8 max abs error in f32)
_LN1P_COEF = (
    0.0665224252, -0.115752432, 0.118808561, -0.124213966, 0.142213354,
    -0.166670732, 0.200021019, -0.250000367, 0.333333095, -0.499999997, 1.0,
)
# degree-5 fit for the "poly_fast" screening tier (5.7e-6) — _LN1P_FAST_COEF
_LN1P_FAST_COEF = (
    -0.1416694926, 0.2181395213, -0.2536432665, 0.3327617641, -0.4999231513,
    1.0000028669,
)
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
# 2^f on [-0.5, 0.5] in powers of ln2, Horner order — _EXP2_COEF
_EXP2_COEF = (
    0.000154653149, 0.00133952823, 0.00961803994, 0.0555034068, 0.240226511,
    0.6931472, 1.0,
)
# Taylor coefficients of the exact sincos tier. mcport divides by 362880 and
# 40320; the port multiplies by the float reciprocal (at most one ulp apart)
# so that the kernel, the CPU form and the CUDA form of the plain version
# evaluate the same operations.
_INV_FACT = {n: 1.0 / math.factorial(n) for n in (3, 4, 5, 6, 7, 8, 9)}


def _horner(coef, x: torch.Tensor) -> torch.Tensor:
    p = coef[0]
    for c in coef[1:]:
        p = p * x + c
    return p


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as the kernels' ``sqrtf``
    computes it. torch's vectorised CPU float32 ``sqrt`` is not correctly
    rounded (some results are an ulp off); the float64 root rounded
    to float32 is, on any device."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def ln_poly(u: torch.Tensor, coef=_LN1P_COEF) -> torch.Tensor:
    """ln(u) for float32 ``u`` in (0, 1]: exponent extraction, one octave fold
    at sqrt(2), then ``x·P(x)`` for ln(1+x) — mcport's ``_ln_poly``."""
    bits = u.view(torch.int32)
    e = (bits >> 23) - 127                               # u <= 1 → e <= 0
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)  # [1, 2)
    big = m >= 1.4142135
    m = torch.where(big, 0.5 * m, m)
    ef = e.to(torch.float32) + big.to(torch.float32)
    x = m - 1.0
    return _horner(coef, x) * x + ef * _LN2


def sincos_poly(u: torch.Tensor, fast: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin)(2πu) for ``u`` in [0, 1]: quadrant reduction to [-π/4, π/4]
    and Taylor polynomials (``fast``: mcport's degree-5/4 fits)."""
    t = 4.0 * u
    q = torch.floor(t + 0.5)                             # 0..4
    r = (t - q) * (0.5 * math.pi)
    r2 = r * r
    if fast:
        s = r * (0.9999990055 + r2 * (-0.1666327627 + r2 * 0.0081679515))
        c = 0.9999930664 + r2 * (-0.499763506 + r2 * 0.0405120397)
    else:
        f = _INV_FACT
        s = r * (1.0 + r2 * (-f[3] + r2 * (f[5] + r2 * (-f[7] + r2 * f[9]))))
        c = 1.0 + r2 * (-0.5 + r2 * (f[4] + r2 * (-f[6] + r2 * f[8])))
    q = torch.where(q == 4.0, 0.0, q)                    # wrap the top edge
    q1, q2, q3 = q == 1.0, q == 2.0, q == 3.0
    cos_t = torch.where(q1, -s, torch.where(q2, -c, torch.where(q3, s, c)))
    sin_t = torch.where(q1, c, torch.where(q2, -s, torch.where(q3, -c, s)))
    return cos_t, sin_t


def exp_poly(x: torch.Tensor) -> torch.Tensor:
    """exp(x) = 2^k · P(f), k = round-half-even(x·log2 e), clamped to the
    normal-float range — mcport's ``_exp_poly``."""
    t = x * _LOG2E
    k = torch.round(t)
    f = t - k
    ki = k.clamp(-126.0, 127.0).to(torch.int32)
    scale = ((ki + 127) << 23).view(torch.float32)
    return _horner(_EXP2_COEF, f) * scale


def _boxmuller_poly(u1, u2):
    r = sqrt_rn(-2.0 * ln_poly(u1))
    c, s = sincos_poly(u2)
    return r * c, r * s


def _boxmuller_poly_fast(u1, u2):
    r = sqrt_rn(-2.0 * ln_poly(u1, _LN1P_FAST_COEF))
    c, s = sincos_poly(u2, fast=True)
    return r * c, r * s


#: The normal tiers of the port, keyed like mcport's ``_BM_VARIANTS``.
BM_VARIANTS = {"poly": _boxmuller_poly, "poly_fast": _boxmuller_poly_fast}
_BM_CODE = {"poly": 0, "poly_fast": 1}
_T_CODE = 2


def t_draw(u: torch.Tensor, v: torch.Tensor, df: float) -> torch.Tensor:
    """Student-t(df) by Bailey's polar transform,
    ``sqrt(df (u^(-2/df) - 1)) cos(2πv)`` — ``one_t`` of mcport's
    ``_make_t_pair``. Not unit-variance: callers fold the scale into L."""
    p = exp_poly((-2.0 / df) * ln_poly(u)) - 1.0
    r = sqrt_rn(df * torch.clamp_min(p, 0.0))
    c, _ = sincos_poly(v)
    return r * c


def block_seeds(seed: int, first_block: int, n_blocks: int) -> list[int]:
    """Philox key words ``uint32(seed + (first_block + b + 1) * SEED_STRIDE)``
    for ``b < n_blocks`` — the int32 wrap of ``mc_engine.py``'s block seeds,
    read as unsigned. ``first_block=-1, n_blocks=1`` keys one block by
    ``seed`` itself."""
    return [(seed + (first_block + b + 1) * SEED_STRIDE) & 0xFFFFFFFF
            for b in range(n_blocks)]


def _uniform_calls(seed: int, n_assets: int, n_paths: int, first_block: int,
                   n_blocks: int, first_path: int, dev: torch.device,
                   stream: int = STREAM_GBM):
    """``call(draw)`` → the four uniforms (each ``(n_blocks, n_paths, A)``
    float32) of Philox call ``draw`` of ``stream`` for paths ``first_path ..``
    of each block: the kernels' counters."""
    keys = torch.tensor(block_seeds(seed, first_block, n_blocks),
                        dtype=torch.int64, device=dev).view(-1, 1, 1)
    asset = torch.arange(n_assets, dtype=torch.int64, device=dev).view(1, 1, -1)
    path = torch.arange(first_path, first_path + n_paths, dtype=torch.int64,
                        device=dev).view(1, -1, 1)

    def call(draw: int) -> list[torch.Tensor]:
        ctr = (torch.full((), draw, dtype=torch.int64, device=dev), asset, path, stream)
        words = philox4x32(ctr, (keys, 0))
        return [bits_to_unit(w.expand(n_blocks, n_paths, n_assets)) for w in words]

    return call


def step_shocks(
    seed: int,
    n_assets: int,
    n_paths: int,
    n_steps: int,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
    first_path: int = 0,
    bm: str = "poly",
    t_df: float | None = None,
    stream: int = STREAM_GBM,
    device: torch.device | str,
) -> torch.Tensor:
    """The shock of every step on the kernels' counters → ``(n_blocks,
    n_paths, n_steps, A)`` float32: unit normals, or raw polar-t draws
    (scale not applied) with ``t_df``. Paths ``first_path ..
    first_path + n_paths - 1`` of each block, so a long launch can be checked
    in pieces. Step ``s`` of the normal tiers is draw ``s % 2`` of pair
    ``s // 2``; of the t tier, draw ``s % 2`` of call ``s // 2``. ``stream``
    tags the counters (Heston's variance shocks use ``STREAM_HESTON``)."""
    if bm not in _BM_CODE:
        raise ValueError(f"bm must be one of {sorted(_BM_CODE)}, got {bm!r}")
    dev = torch.device(device)
    call = _uniform_calls(seed, n_assets, n_paths, first_block, n_blocks, first_path, dev,
                          stream)
    zs: list[torch.Tensor] = []
    if t_df is not None:
        for c in range(-(-n_steps // 2)):
            u = call(c)
            zs.append(t_draw(u[0], u[1], t_df))
            if 2 * c + 1 < n_steps:
                zs.append(t_draw(u[2], u[3], t_df))
    else:
        boxmuller = BM_VARIANTS[bm]
        for c in range(-(-n_steps // 4)):
            u = call(c)
            zs.extend(boxmuller(u[0], u[1]))
            if 4 * c + 2 < n_steps:
                zs.extend(boxmuller(u[2], u[3]))
    if not zs:
        return torch.zeros((n_blocks, n_paths, 0, n_assets), dtype=torch.float32, device=dev)
    return torch.stack(zs[:n_steps], dim=2)


def check_card_assets(a: int, what: str) -> None:
    """Raise unless the card's ``what`` kernels take ``a`` assets: any ``a >=
    1`` whose wide layout (past ``MAX_ASSETS``) keeps one path's shocks of a
    Philox call, ``4 · 4 · a`` bytes, in a block's shared memory (up to
    ~14,000 assets). Only a launch checks this; every plain form takes any
    width. A launch past ``MAX_ASSETS`` also refuses a scratch that does not
    fit the card's memory (:func:`wide_scratch`)."""
    if a < 1:
        raise ValueError(f"the {what} kernels take at least one asset, got {a}")
    need = 4 * (4 * a + 2 * 64 * 16)
    if a > MAX_ASSETS and need > _SHARED_BYTES:
        raise ValueError(f"the {what} kernels' wide layout needs {need:,} bytes of shared "
                         f"memory for one path's shocks at {a} assets; a block has "
                         f"{_SHARED_BYTES:,}")


def wide_tile(a: int, per_item: int = 4) -> int:
    """Paths per tile of a wide launch at ``a`` assets (csrc/wide.cuh): the
    most, up to 16 and a power of two, whose shock tile (``per_item`` floats
    per asset and path: the steps of one Philox call) keeps within about 100
    KB of shared memory."""
    tp = 16
    while tp > 1 and 4 * per_item * a * tp > _WIDE_SHOCK_BYTES:
        tp //= 2
    return tp


def wide_scratch(floats: int, device: torch.device, what: str) -> torch.Tensor:
    """The device-memory scratch of one wide launch, ``floats`` float32 (at
    least one). Raises ``ValueError`` with the byte count when it does not fit
    the card's free memory."""
    n = max(int(floats), 1)
    free, _ = torch.cuda.mem_get_info(device)
    if 4 * n > free:
        raise ValueError(f"the {what} kernels' scratch needs {4 * n:,} bytes of device "
                         f"memory at this width; {free:,} are free")
    return torch.empty(n, dtype=torch.float32, device=device)


def _check_args(chol, n_paths, n_steps, n_blocks, bm, t_df) -> None:
    if chol.dtype != torch.float32 or chol.dim() != 2 or chol.shape[0] != chol.shape[1]:
        raise ValueError(f"chol must be a square float32 matrix, got "
                         f"{tuple(chol.shape)} {chol.dtype}")
    if chol.shape[0] < 1:
        raise ValueError("chol must cover at least one asset")
    if not 0 <= n_paths < 2**31 or n_steps < 0 or not 1 <= n_blocks <= 65_535:
        raise ValueError(f"bad grid: n_paths={n_paths}, n_steps={n_steps}, "
                         f"n_blocks={n_blocks}")
    if bm not in _BM_CODE:
        raise ValueError(f"bm must be one of {sorted(_BM_CODE)}, got {bm!r}")
    if t_df is not None and not t_df > 2.0:
        raise ValueError(f"t_df must exceed 2 (unit-variance t), got {t_df}")


def terminal_noise_reference(
    seed: int,
    chol: torch.Tensor,
    n_paths: int,
    n_steps: int,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
    bm: str = "poly",
    t_df: float | None = None,
) -> torch.Tensor:
    """Plain torch form of the terminal-noise kernel: ``(n_blocks, n_paths,
    A)`` float32 with ``out[b, p] = L · Σ_t z_t`` on the kernel's counters.

    Runs on any device; the tests use it on the CPU and ``chip_smoke.py``
    holds the kernel against it on the card.
    """
    _check_args(chol, n_paths, n_steps, n_blocks, bm, t_df)
    dev = chol.device
    a = chol.shape[0]
    call = _uniform_calls(seed, a, n_paths, first_block, n_blocks, 0, dev)
    n_pairs, odd = divmod(n_steps, 2)
    acc = torch.zeros((n_blocks, n_paths, a), dtype=torch.float32, device=dev)
    if t_df is not None:
        for i in range(n_pairs + odd):
            u = call(i)
            t1 = t_draw(u[0], u[1], t_df)
            acc = acc + (t1 + t_draw(u[2], u[3], t_df)) if i < n_pairs else acc + t1
    else:
        boxmuller = BM_VARIANTS[bm]
        for i in range(n_pairs + odd):
            if i % 2 == 0:
                u = call(i // 2)
            z1, z2 = boxmuller(u[2 * (i % 2)], u[2 * (i % 2) + 1])
            acc = acc + (z1 + z2) if i < n_pairs else acc + z1
    return acc @ chol.T


def kernel_tolerance(chol: torch.Tensor, n_steps: int) -> torch.Tensor:
    """Per-asset bound on ``|kernel - plain form|`` of :func:`gbm_terminal_noise`
    for the factor ``chol`` it was given → ``(A,)`` float32.

    The smaller of two bounds. ``2e-6 · n_steps · Σ_j |L_ij|`` is the worst
    case of 2e-6 per draw (nvcc contracts multiply-adds into FMAs where torch
    rounds twice). ``1.5e-5 · sqrt(n_steps) · ||L_i||_2`` is where the
    draws' ulp differences add up like a random walk: on an H100 the largest
    difference used at most a quarter of it over the three tiers, 1-64
    assets, 1-252 steps and up to 16.7M paths (6-13x headroom at 7-252 steps,
    4x for single draws). A wrong polynomial tier exceeds it: poly_fast's
    sincos inside the poly tier at 7-252 steps, its ln at one step with
    ``L = [[1]]``.
    """
    chol = chol.to(torch.float32)
    worst = 2e-6 * n_steps * chol.abs().sum(dim=1)
    walk = 1.5e-5 * math.sqrt(n_steps) * chol.norm(dim=1)
    return torch.minimum(worst, walk)


def _launch(seed, chol, n_paths, n_steps, first_block, n_blocks, bm, t_df):
    from mcport_torch._build import library

    lib = library("terminal_noise")
    a = chol.shape[0]
    out = torch.empty((n_blocks, n_paths, a), dtype=torch.float32, device=chol.device)
    if n_paths == 0:
        return out
    chol = chol.contiguous()
    df = 0.0 if t_df is None else float(t_df)
    neg2_over_df = 0.0 if t_df is None else -2.0 / float(t_df)
    tier = _T_CODE if t_df is not None else _BM_CODE[bm]
    with torch.cuda.device(chol.device):
        stream = torch.cuda.current_stream(chol.device).cuda_stream
        if a > MAX_ASSETS:   # each thread's sums in a scratch column (csrc/terminal_noise.cu)
            scratch = wide_scratch(a * WIDE_CTAS * 128, chol.device, "terminal-noise")
            err = lib.mcport_terminal_noise_wide(
                seed, first_block, n_blocks, n_paths, a, n_steps, tier, df, neg2_over_df,
                chol.data_ptr(), scratch.data_ptr(), WIDE_CTAS, out.data_ptr(), stream)
        else:
            err = lib.mcport_terminal_noise(
                seed, first_block, n_blocks, n_paths, a, n_steps, tier, df, neg2_over_df,
                chol.data_ptr(), out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"terminal-noise kernel launch failed: CUDA error "
                           f"{err} ({lib.mcport_error_string(err).decode()})")
    gbm_terminal_noise.launches += 1
    gbm_terminal_noise.wide_launches += int(a > MAX_ASSETS)
    return out


def gbm_terminal_noise(
    seed: int,
    chol: torch.Tensor,
    n_paths: int,
    n_steps: int,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
    bm: str = "poly",
    t_df: float | None = None,
) -> torch.Tensor:
    """Correlated terminal noise ``L · Σ_t z_t`` → ``(n_blocks, n_paths, A)``
    float32, for the blocks ``first_block + 1 .. first_block + n_blocks`` of a
    run seeded ``seed`` (one block, keyed by ``seed`` itself, by default).

    ``chol`` on a CUDA device launches the kernel (one launch for all
    ``n_blocks`` blocks) and counts it in ``gbm_terminal_noise.launches``;
    ``chol`` on the CPU evaluates :func:`terminal_noise_reference`. Any other
    device, or a problem the kernel does not take, raises.
    """
    _check_args(chol, n_paths, n_steps, n_blocks, bm, t_df)
    if chol.device.type == "cpu":
        return terminal_noise_reference(
            seed, chol, n_paths, n_steps, first_block=first_block,
            n_blocks=n_blocks, bm=bm, t_df=t_df)
    if chol.device.type != "cuda":
        raise ValueError(f"no terminal-noise kernel for device {chol.device}")
    check_card_assets(chol.shape[0], "terminal-noise")
    return _launch(seed, chol, n_paths, n_steps, first_block, n_blocks, bm, t_df)


gbm_terminal_noise.launches = 0
gbm_terminal_noise.wide_launches = 0   # the wide layout's share of ``launches`` (A > 64)


def t_scaled_chol(chol: torch.Tensor, t_df: float | None) -> torch.Tensor:
    """``chol / sqrt(df / (df - 2))`` for unit-variance Student-t shocks (the
    factor the kernel receives), ``chol`` itself for normal shocks."""
    if t_df is None:
        return chol
    return chol / torch.sqrt(torch.full((), t_df / (t_df - 2.0), dtype=chol.dtype,
                                        device=chol.device))


def block_terminal_log_returns(
    seed: int,
    mean_step: torch.Tensor,
    chol_step: torch.Tensor,
    n_paths: int,
    n_steps: int,
    *,
    first_block: int = -1,
    n_blocks: int = 1,
    antithetic: bool = False,
    t_df: float | None = None,
    bm: str = "poly",
) -> torch.Tensor:
    """Terminal cumulative log returns of ``n_blocks`` consecutive blocks →
    ``(n_blocks, n_paths, A)`` float32 — mcport's
    ``pallas_terminal_log_returns`` for a whole dispatch group.

    ``antithetic`` draws ``n_paths // 2`` noise rows per block and returns
    ``drift + noise`` followed by its mirror ``drift - noise``. ``t_df``
    selects unit-variance Student-t shocks: the ``1/sqrt(df/(df-2))`` scale is
    folded into L.
    """
    m = mean_step.to(torch.float32)
    chol = t_scaled_chol(chol_step.to(torch.float32), t_df)
    half = n_paths // 2 if antithetic else n_paths
    noise = gbm_terminal_noise(seed, chol.contiguous(), half, n_steps,
                               first_block=first_block, n_blocks=n_blocks,
                               bm=bm, t_df=t_df)
    drift = n_steps * m
    if antithetic:
        return torch.cat([drift + noise, drift - noise], dim=1)
    return drift + noise


def terminal_log_returns(
    seed: int,
    mean_step: torch.Tensor,
    chol_step: torch.Tensor,
    n_paths: int,
    n_steps: int,
    *,
    antithetic: bool = False,
    t_df: float | None = None,
    bm: str = "poly",
) -> torch.Tensor:
    """Terminal cumulative log returns ``(n_paths, A)`` of one block keyed by
    ``seed`` — the port's ``pallas_terminal_log_returns``."""
    return block_terminal_log_returns(
        seed, mean_step, chol_step, n_paths, n_steps,
        antithetic=antithetic, t_df=t_df, bm=bm)[0]
