"""mcport_torch — the PyTorch / CUDA port of mcport for NVIDIA Hopper.

A second package beside :mod:`mcport`, which stays the reference it is held
against. The port runs correlated-GBM tail risk (``gbm-risk``), the GBM path
tier (``path-risk``, ``gbm-risk --path-stats``, ``dd-frontier``), the
CCC-GARCH and block-bootstrap families (``garch-risk``, ``bootstrap-risk``)
the common-jump Merton and Heston families (``jump-risk``,
``heston_terminal_returns``) and the DCC-GARCH family (``garch-risk
--correlation dcc``), with the families' path risk and frontiers, and
``compare-models`` over all seven, on one H100: hand-written CUDA C++ kernels
draw the paths and score them (``csrc/``), plain PyTorch does the rest
(moments, histogram sketches, VaR/CVaR, drawdown quantiles, checkpointing,
the frontier's selection) and host NumPy/SciPy the estimation.

Layers, entry point down to the device:

    cli.py → api.py → engine/mc_engine.py         → ops/gbm.py        → csrc/terminal_noise.cu
                      engine/path_risk.py         → ops/path_stats.py → csrc/path_stats.cu
                      engine/drawdown_frontier.py → ops/multi_dd.py   → csrc/multi_dd.cu
                      models/garch_mc.py, engines → ops/garch.py      → csrc/garch.cu
                      models/bootstrap.py, engines→ ops/bootstrap.py  → csrc/bootstrap.cu
                      engines                     → ops/jump.py       → csrc/jump.cu
                      models/heston.py, engines   → ops/heston.py     → csrc/heston.cu
                      models/dcc.py, engines      → ops/dcc.py        → csrc/dcc.cu
              ↘ data.py, config.py, models/gbm.py, models/garch.py, models/jump.py
                (its exact terminal sampler as torch ops), ops/quantile.py,
                ops/dirichlet.py

The port imports torch and never jax, and nothing of :mod:`mcport`: it keeps
its own copies of the configuration (``config.py``), the seed stride
(``seeding.py``) and the CSV pipeline (``data.py``, standard library and
NumPy, no pandas). Its entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU, where every kernel's plain torch form
runs instead.

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
