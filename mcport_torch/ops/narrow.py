"""The layouts of the GBM (#3), Merton (#8), Heston (#10), GARCH (#5) and
bootstrap (#7) candidate kernels up to 16 assets (``csrc/narrow_dd.cuh``):
what their plans share.

Each kernel picks its layout by the number of candidates W (the C side's
``narrow_layout``, ``gbm_layout``;
:func:`mcport_torch.ops.multi_dd.gbm_narrow_plan`,
:func:`mcport_torch.ops.jump.merton_narrow_plan`,
:func:`mcport_torch.ops.heston.heston_narrow_plan`,
:func:`mcport_torch.ops.garch.garch_narrow_plan` and
:func:`mcport_torch.ops.bootstrap.bootstrap_narrow_plan` mirror it, with each
kernel's shared-memory arithmetic):

- ``solo`` up to a few candidates (the path-risk engine's W = 1): a thread
  per path runs the recursion and scores its own candidates; one launch of
  64-thread blocks (the bootstrap's 128);
- ``split``: the same recursion writes every step's returns to a device
  scratch the wrapper allocates (up to 2 GiB: 131,072 x 252 x 15 takes
  1.98 GB; chunks of a recursion block's paths past it), then 256-thread
  blocks score them, their paths widening as W shrinks (16 at W = 256, 512
  at W = 5-8): two launches per chunk;
- ``tile`` (Heston past 128 candidates): a 256-thread block owns a 16-path
  tile and every candidate, its items' and scorers' phases pipelined one
  Philox call apart with one barrier per call.

Every layout computes each path's operations in the same order: their
outputs are equal bit for bit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

__all__ = ["NarrowPlan", "NARROW_ASSETS", "LAYOUTS", "narrow_plan", "score_groups",
           "score_steps"]

NARROW_ASSETS = 16   # csrc/narrow_dd.cuh kNA
#: the C side's layout codes
LAYOUTS = {"solo": 0, "split": 1, "tile": 2}
# csrc/narrow_dd.cuh: threads (a path each) of a recursion block, of a
# scoring block and of a tile block, paths of a tile, the returns a scoring
# block stages at once; the most floats of returns a launch keeps in its
# scratch (2 GiB)
SOLO_THREADS, SCORE_THREADS, TILE_THREADS, TILE, STAGE_FLOATS = 64, 256, 256, 16, 8192
NARROW_SCRATCH_FLOATS = 1 << 29
SMEM = 232_448   # an H100 block's shared memory, bytes


class NarrowPlan(NamedTuple):
    """How a candidate kernel up to 16 assets runs W candidates: ``layout``
    (``solo``, ``split`` or ``tile``); per launch, in launch
    order, its ``threads`` and ``paths`` per block and ``shared_bytes`` per
    block; ``scratch_floats`` of the split layout's returns and ``chunk``
    paths per pair of its launches (``block_paths`` where the scratch holds
    them all, else a multiple of the recursion block's paths)."""

    layout: str
    threads: tuple[int, ...]
    paths: tuple[int, ...]
    shared_bytes: tuple[int, ...]
    scratch_floats: int
    chunk: int


def r4(n: int) -> int:
    return -(-n // 4) * 4


def score_groups(n_cand: int) -> int:
    """csrc/narrow_dd.cuh ``score_groups``: the scoring block's groups of 4
    paths."""
    pg = 4
    while pg * 2 * -(-n_cand // 4) <= SCORE_THREADS:
        pg *= 2
    return pg


def score_steps(n_assets: int, n_cand: int) -> int:
    """csrc/narrow_dd.cuh ``score_steps``: steps a scoring block stages at
    once."""
    return min(max(STAGE_FLOATS // (n_assets * 4 * score_groups(n_cand)), 1), 16)


def score_floats(n_assets: int, n_cand: int, split: bool = False) -> int:
    """csrc/narrow_dd.cuh ``score_floats``: a scoring block's shared memory
    (twice over in the split score tier, ``split``)."""
    return (2 if split else 1) * (n_assets * r4(n_cand) + score_steps(n_assets, n_cand)
                                  * n_assets * 4 * score_groups(n_cand))


def narrow_plan(kernel: str, n_assets: int, n_cand: int, n_steps: int, block_paths: int,
                n_blocks: int, n_legs: int, scratch_floats: int, solo_max: int, split_max: int,
                recur_floats: Callable[[int, int, bool, int], int],
                tile_floats: Callable[[int, int, int], int] | None,
                layout: str | None = None, solo_threads: int = SOLO_THREADS,
                split_tier: bool = False) -> NarrowPlan:
    """The plan of ``kernel`` (its name, for errors): ``layout``, or by W
    ``solo`` up to ``solo_max`` candidates, ``split`` up to ``split_max`` and
    ``tile`` past it, with the kernel's shared memory in floats from
    ``recur_floats(a, W, own, legs)`` and ``tile_floats(a, W, legs)`` (None:
    the kernel has no tile layout), ``solo_threads`` threads (a path each)
    per recursion block, and the split layout scoring in the split score
    tier where ``split_tier`` (GBM's tensorfloat32: twice the scoring
    block's shared memory)."""
    a, w = int(n_assets), int(n_cand)
    if not 1 <= a <= NARROW_ASSETS or not 1 <= w <= 256:
        raise ValueError(f"{kernel} takes 1-{NARROW_ASSETS} assets and 1-256 candidates in "
                         f"these layouts, got {a} and {w}")
    if layout is None:
        layout = "solo" if w <= solo_max else "split" if w <= split_max else "tile"
    if layout not in LAYOUTS or (layout == "tile" and tile_floats is None):
        raise ValueError(f"{kernel} has no {layout!r} layout")
    legs = int(n_legs)
    if layout == "solo":
        plan = NarrowPlan("solo", (solo_threads,), (solo_threads,),
                          (4 * recur_floats(a, w, True, legs),), 0, int(block_paths))
    elif layout == "tile":
        plan = NarrowPlan("tile", (TILE_THREADS,), (TILE,), (4 * tile_floats(a, w, legs),), 0,
                          int(block_paths))
    else:
        plan = _split(a, w, int(n_steps), int(block_paths), int(n_blocks), legs,
                      int(scratch_floats), recur_floats, solo_threads, split_tier)
    if max(plan.shared_bytes) > SMEM:
        raise ValueError(f"{kernel}'s {plan.layout} layout needs {max(plan.shared_bytes):,} "
                         f"bytes of shared memory per block at {a} assets, {w} candidates and "
                         f"{legs} legs; a block has {SMEM:,}")
    return plan


def _split(a, w, n_steps, block_paths, n_blocks, legs, scratch_floats, recur_floats, threads,
           split_tier):
    per_path = n_blocks * n_steps * a
    tiles = lambda n: -(-n // TILE) * TILE  # noqa: E731
    chunk = block_paths
    if per_path and scratch_floats // per_path < tiles(chunk):
        chunk = scratch_floats // per_path // threads * threads
        if chunk < 1:
            raise ValueError(f"a scratch of {scratch_floats:,} floats holds no "
                             f"{threads}-path chunk of {per_path:,} returns per path")
    return NarrowPlan("split", (threads, SCORE_THREADS), (threads, 4 * score_groups(w)),
                      (4 * recur_floats(a, w, False, legs), 4 * score_floats(a, w, split_tier)),
                      per_path * tiles(chunk), chunk)
