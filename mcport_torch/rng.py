"""Philox4x32-10 counter-based random bits in plain torch.

The port's random streams. Philox (Salmon et al., SC'11, "Parallel random
numbers: as easy as 1, 2, 3") maps a 128-bit counter and a 64-bit key to 128
random bits, so any draw can be computed from its address alone: the kernel in
``csrc/terminal_noise.cu`` and the plain torch form here read the same bits for
the same counter, whatever the launch geometry. This replaces the TPU's
stateful hardware PRNG (``pltpu.prng_seed``/``prng_random_bits`` in
``mcport/ops/pallas_gbm.py``), which could not be reproduced off-chip.

Stream layout (identical in ``csrc/terminal_noise.cu``):

    key     = (uint32(block_seed), 0)
    counter = (draw, asset, path_in_block, STREAM_GBM)

``block_seed = int32(seed + (b + 1) * SEED_STRIDE)`` for engine block ``b``
(``mcport/engine/mc_engine.py`` convention). ``draw`` indexes the Philox calls
of one (path, asset) pair; how a sampler consumes the four words of a call is
documented in :mod:`mcport_torch.ops.gbm`. ``STREAM_GBM`` tags the GBM shock
stream so that later samplers can draw from the same seeds without overlap.

uint32 values are carried in int64 tensors (torch's unsigned 32-bit type has
too few operators); every step masks back to 32 bits, and the 32x32→64-bit
products are split into 16-bit limbs so that nothing overflows int64.
"""

from __future__ import annotations

import torch

__all__ = ["philox4x32", "bits_to_unit", "STREAM_GBM"]

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
_MASK32 = 0xFFFFFFFF

STREAM_GBM = 0


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(low, high) 32-bit halves of ``m * x`` for uint32 ``m`` and ``x``.

    ``m * x`` needs 64 unsigned bits, which int64 cannot hold; the constant is
    split into 16-bit limbs, so each partial product stays below 2^48.
    """
    p_lo = x * (m & 0xFFFF)
    p_hi = x * (m >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return s & _MASK32, (p_hi >> 16) + (s >> 32)


def philox4x32(counter, key, rounds: int = 10) -> tuple[torch.Tensor, ...]:
    """Philox4x32-``rounds`` of (c0, c1, c2, c3) under key (k0, k1).

    Counter and key words are int64 tensors (or Python ints) holding values in
    [0, 2^32); they broadcast against each other. Returns the four output
    words as int64 tensors of the broadcast shape. Matches the Random123
    known-answer vectors (tests/test_torch_rng.py).
    """
    dev = next((c.device for c in (*counter, *key) if isinstance(c, torch.Tensor)),
               None)
    c0, c1, c2, c3 = torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=torch.int64, device=dev) for c in counter))
    k0, k1 = key
    for r in range(rounds):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        lo0, hi0 = _mulhilo(PHILOX_M0, c0)
        lo1, hi1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (in int64) → float32 uniform on [2^-23, 1].

    The top 23 bits ``m`` give ``1 - m * 2^-23``: every step is exact in
    float32, so the kernel and this form produce bit-identical uniforms. The
    value is never 0, so ``log`` is safe. Same map as mcport's
    ``_bits_to_unit`` (``mcport/ops/pallas_gbm.py``).
    """
    return 1.0 - (bits >> 9).to(torch.float32) * (2.0 ** -23)
