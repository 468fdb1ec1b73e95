"""The terminal-noise kernel on a CUDA card against its plain torch form.

Marked ``cuda``; every test skips without a card. On a machine with one (and
without jax, which tests/conftest.py imports):

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Same cases as phase 2 of chip_smoke.py at test size, plus the engine's own
dispatch group at GBMConfig defaults. Bound per element:
``mcport_torch.ops.gbm.kernel_tolerance`` — the smaller of 2e-6 per draw
(nvcc contracts multiply-adds into FMAs where torch rounds twice) and a
random-walk bound at least four times the largest difference measured on an
H100.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest --noconftest "
                    "-o addopts='' -m cuda tests/test_torch_cuda.py")
    return torch.device("cuda")


def _chol(a, dev):
    corr = 0.5 * np.eye(a) + 0.5
    return torch.from_numpy(np.linalg.cholesky(4e-4 * corr).astype(np.float32)).to(dev)


def _within(k, p, tol):
    return bool(torch.isfinite(k).all()) and bool(((k - p).abs() <= tol).all())


@pytest.mark.parametrize("a", [1, 15, 64])
@pytest.mark.parametrize("bm, t_df", [("poly", None), ("poly_fast", None), ("poly", 5.5)])
@pytest.mark.parametrize("steps", [252, 7])
def test_kernel_matches_plain_form(dev, a, bm, t_df, steps):
    from mcport_torch.ops.gbm import gbm_terminal_noise, kernel_tolerance, terminal_noise_reference

    chol = _chol(a, dev)
    kw = dict(first_block=6, n_blocks=2, bm=bm, t_df=t_df)
    before = gbm_terminal_noise.launches
    k = gbm_terminal_noise(11, chol, 4_099, steps, **kw)
    torch.cuda.synchronize()
    assert gbm_terminal_noise.launches == before + 1
    p = terminal_noise_reference(11, chol, 4_099, steps, **kw)
    assert _within(k, p, kernel_tolerance(chol, steps))


@pytest.mark.parametrize("bm", ["poly", "poly_fast"])
@pytest.mark.parametrize("steps", [1, 2])
def test_kernel_single_draws_match_plain_form(dev, bm, steps):
    """With L = [[1]] and one or two steps the output is the draws themselves,
    where a wrong polynomial (poly_fast's ln in the poly tier) shows."""
    from mcport_torch.ops.gbm import gbm_terminal_noise, kernel_tolerance, terminal_noise_reference

    one = torch.ones((1, 1), dtype=torch.float32, device=dev)
    kw = dict(first_block=6, n_blocks=2, bm=bm)
    k = gbm_terminal_noise(11, one, 65_537, steps, **kw)
    p = terminal_noise_reference(11, one, 65_537, steps, **kw)
    assert _within(k, p, kernel_tolerance(one, steps))


def test_kernel_matches_plain_form_at_the_engine_group(dev):
    """The launch run_resumable_mc makes at GBMConfig defaults: seed 0, blocks
    0-15 of 8,192 paths in one launch, 252 steps, poly."""
    from mcport.config import GBMConfig
    from mcport_torch.ops.gbm import gbm_terminal_noise, kernel_tolerance, terminal_noise_reference

    g = GBMConfig()
    chol = _chol(15, dev)
    kw = dict(first_block=0, n_blocks=g.n_paths // g.path_block, bm=g.bm)
    k = gbm_terminal_noise(g.seed, chol, g.path_block, g.n_steps, **kw)
    p = terminal_noise_reference(g.seed, chol, g.path_block, g.n_steps, **kw)
    assert _within(k, p, kernel_tolerance(chol, g.n_steps))
    # a resumed run launches the later blocks alone: same numbers, bit for bit
    tail = gbm_terminal_noise(g.seed, chol, g.path_block, g.n_steps, first_block=5,
                              n_blocks=kw["n_blocks"] - 5, bm=g.bm)
    assert torch.equal(tail, k[5:])


def test_kernel_rejects_too_many_assets(dev):
    from mcport_torch.ops.gbm import gbm_terminal_noise

    with pytest.raises(ValueError, match="1..64 assets"):
        gbm_terminal_noise(0, _chol(65, dev), 128, 4)


def test_engine_on_card_matches_cpu_run(dev):
    from mcport.config import GBMConfig
    from mcport_torch.convert import gbm_params_from_numpy
    from mcport_torch.engine.mc_engine import run_resumable_mc

    a = 5
    params = gbm_params_from_numpy(np.ones(a), np.full(a, 1e-3), _chol(a, "cpu").double())
    w = np.full(a, 1.0 / a)
    cfg = GBMConfig(n_paths=8_192, n_steps=16, path_block=2_048, seed=2)
    card, ck_card = run_resumable_mc(params, w, cfg, device=dev)
    cpu, ck_cpu = run_resumable_mc(params, w, cfg, device="cpu")
    np.testing.assert_allclose(card.mean, cpu.mean, rtol=0, atol=1e-6)
    np.testing.assert_allclose(card.cov, cpu.cov, rtol=0, atol=1e-8)
    assert int(np.abs(ck_card.hist - ck_cpu.hist).sum()) <= 4   # a few bin-edge moves
