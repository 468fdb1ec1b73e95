"""Seed-space stride between the path blocks of one run.

The port's copy of ``mcport/seeding.py``: engine block ``b`` of a run seeded
``seed`` keys its Philox stream with ``uint32(seed + (b + 1) * SEED_STRIDE)``
(:func:`mcport_torch.ops.gbm.block_seeds`). The CUDA kernels carry the same
constant (``csrc/gbm_draws.cuh``). Changing it changes every stream and
refuses every checkpoint in flight.
"""

SEED_STRIDE = 1 << 14
