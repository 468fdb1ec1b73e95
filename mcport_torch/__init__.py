"""mcport_torch — the PyTorch / CUDA port of mcport for NVIDIA Hopper.

A second package beside :mod:`mcport`, which stays the reference it is held
against. The port runs correlated-GBM tail risk (``gbm-risk``) on one H100:
a hand-written CUDA C++ kernel draws the terminal noise (``csrc/``), plain
PyTorch does the rest (moments, histogram sketch, VaR/CVaR, checkpointing).

Layers, entry point down to the device:

    cli.py  →  api.py  →  engine/mc_engine.py  →  ops/gbm.py  →  csrc/*.cu
                               ↘ ops/quantile.py, models/gbm.py

The port imports torch and never jax. Of :mod:`mcport` it imports only the
jax-free ``mcport.config`` and ``mcport.seeding``; ``mcport.data`` (pandas) is
imported lazily where CSVs are read.

Precision pin: the Hopper analogue of mcport forcing float32 matmuls
(``mcport/__init__.py``). Float32 products on the card must not run in TF32:
the batched moment outer products go through ``torch.bmm`` and TF32 there
would break the 1e-6 moment contract.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
