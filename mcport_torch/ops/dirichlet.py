"""Batched, bound-respecting Dirichlet(1) weight sampling.

Port of ``mcport/ops/dirichlet.py``. A batch of ``n`` candidate portfolios is
drawn at once, uniform on the simplex, as normalised Exponential(1) draws (the
law of Dirichlet(1, ..., 1)); rows outside the per-asset bounds are redrawn,
only those, for up to ``max_retries`` rounds in all, and the rows that never
passed are marked invalid — the reference's skip semantics, made explicit.

Randomness comes from an explicit ``torch.Generator`` on the device the
weights are drawn on; the streams differ from mcport's Threefry, so the two
agree in law, not draw for draw. The retry loop reads one flag per round on
the host (it ends as soon as every row is valid).
"""

from __future__ import annotations

import torch

__all__ = ["constraint_mask", "sample_constrained_weights", "sample_weights"]


def constraint_mask(weights: torch.Tensor, min_w: torch.Tensor,
                    max_w: torch.Tensor) -> torch.Tensor:
    """(N,) bool: rows within the per-asset bounds."""
    return (weights >= min_w).all(dim=-1) & (weights <= max_w).all(dim=-1)


def _dirichlet1(generator: torch.Generator, n: int, a: int) -> torch.Tensor:
    e = torch.empty((n, a), dtype=torch.float32, device=generator.device)
    e.exponential_(1.0, generator=generator)
    return e / e.sum(dim=-1, keepdim=True)


def sample_constrained_weights(generator: torch.Generator, n: int, min_w, max_w,
                               max_retries: int = 100) -> tuple[torch.Tensor, torch.Tensor]:
    """``(weights (n, A) float32, valid (n,) bool)`` on the generator's device,
    ``A`` the length of the bounds. Invalid rows never passed within
    ``max_retries`` draws; callers mask them out of optima."""
    dev = generator.device
    min_w = torch.as_tensor(min_w, dtype=torch.float32, device=dev)
    max_w = torch.as_tensor(max_w, dtype=torch.float32, device=dev)
    a = min_w.shape[-1]
    w = _dirichlet1(generator, n, a)
    valid = constraint_mask(w, min_w, max_w)
    for _ in range(1, max_retries):
        if bool(valid.all()):
            break
        fresh = _dirichlet1(generator, n, a)
        w = torch.where(valid[:, None], w, fresh)
        valid = valid | constraint_mask(fresh, min_w, max_w)
    return w, valid


def sample_weights(generator: torch.Generator, n: int, min_w, max_w,
                   max_retries: int = 100) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`sample_constrained_weights`, skipping the bound checks when the
    bounds are the trivial [0, 1] box that every simplex point satisfies."""
    lo = torch.as_tensor(min_w, dtype=torch.float32)
    hi = torch.as_tensor(max_w, dtype=torch.float32)
    if bool((lo <= 0).all()) and bool((hi >= 1).all()):
        w = _dirichlet1(generator, n, lo.shape[-1])
        return w, torch.ones(n, dtype=torch.bool, device=w.device)
    return sample_constrained_weights(generator, n, lo, hi, max_retries)
