"""The terminal kernels #9 (Heston, ``csrc/heston.cu``) and #4 (GARCH,
``csrc/garch.cu``) up to 16 assets on the CPU: their CUDA sources under the
host emulation of ``tools/cuda_emu`` (each CUDA thread a std::thread, IEEE
float32 without contraction), in the layout their entry points route to,
against the plain forms.

- #9's path state, the log sum before ``expm1``, is the plain form's bit for
  bit (``heston_increments`` summed step by step, as
  ``heston_terminal_reference`` sums them) at A = 1, 7, 16 and 0, 1, 7 and 9
  steps (whole Philox calls and a call's tail), over two blocks of 37 paths
  (blocks 7 and 8), at a Feller-violating vol of vol, where the recursion is
  chaotic; its output is within ``heston_shares`` (0 at no step).
- #4 is within ``garch_shares`` of ``garch_terminal_reference`` in both draw
  tiers (normal and Student-t(5.5), the t scale folded into L as the wrapper
  folds it) at the same widths and 1 and 9 steps.
- Planted faults in the plain side, one variance shock (GARCH: one shock)
  taken from the wrong asset and one skipped step: the bit check and both
  bounds catch each, the bounds by more than twice.

Skipped where g++ is missing.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcport_torch.ops import garch as G
from mcport_torch.ops import heston as H

ROOT = Path(__file__).resolve().parents[1]
EMU = ROOT / "tools" / "cuda_emu"
PATHS, BLOCKS = 37, 2       # two blocks of 37 paths: a multiple of no CUDA block
KW = dict(first_block=6, n_blocks=BLOCKS)   # tools/cuda_emu/narrow_main.cpp: seed 11, blocks 7, 8
FAULT_STEP = 3              # the planted faults' step (of 9), and the wrong asset's (1 from 0)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The two sources under the emulation: ``{family: executable}``."""
    if shutil.which("g++") is None:
        pytest.skip("the host emulation of the CUDA sources needs g++")
    sys.path.insert(0, str(EMU))
    try:
        from prep import prep
    finally:
        sys.path.remove(str(EMU))
    work = tmp_path_factory.mktemp("terminal_emu")
    prep(ROOT / "mcport_torch" / "csrc", work / "csrc")
    procs = {}
    for family in ("heston", "garch"):
        exe = work / f"{family}_emu"
        procs[family] = (exe, subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-ffp-contract=off", f"-DFAMILY_{family.upper()}",
             "-DNARROW_LAYOUTS", f"-I{EMU}", f"-I{work / 'csrc'}", str(EMU / "narrow_main.cpp"),
             "-o", str(exe), "-lpthread"]))
    for exe, proc in procs.values():
        assert proc.wait(timeout=300) == 0
    return {family: exe for family, (exe, _) in procs.items()}


def _run(emu, tmp_path, family, a, steps, case):
    """One emulated terminal launch in the routed layout: (output (BLOCKS,
    PATHS, A), its parameter block). CASE (narrow_main.cpp): 0 or 1 the bench
    or the harsher parameters (Heston xi 0.05), + 2 the Heston log sum or the
    GARCH Student-t tier."""
    out = tmp_path / f"{family}_a{a}_s{steps}_c{case}.bin"
    subprocess.run([str(emu[family]), str(a), str(PATHS), str(steps), str(BLOCKS), "0", "0",
                    "-1", str(case), str(out)], check=True, timeout=120)
    k = torch.from_numpy(np.fromfile(out, np.float32)).reshape(BLOCKS, PATHS, a)
    return k, np.fromfile(str(out) + ".in", np.float32)


def _t(v):
    return torch.from_numpy(np.ascontiguousarray(v))


def _heston(x, a) -> H.HestonTensors:
    mu, kappa, theta, xi, rho, rho_c, v0 = (_t(v) for v in np.split(x[a * a:], 7))
    h = H.HestonTensors(mu, kappa, theta, xi, rho, v0, _t(x[:a * a].reshape(a, a)))
    assert torch.equal(h.packed(), _t(x))   # rho_c too, as the wrapper packs it
    return h


def _garch(x, a) -> G.GarchTensors:
    mu, omega, alpha, beta, s2_0, e2_0 = (_t(v) for v in np.split(x[a * a:], 6))
    g = G.GarchTensors(mu, omega, alpha, beta, _t(x[:a * a].reshape(a, a)), s2_0, e2_0)
    assert torch.equal(g.packed(g.corr_chol), _t(x))
    return g


def _heston_log_sum(h, steps, fault=None):
    """The plain form's path state: its increments summed step by step from
    0, as heston_terminal_reference sums them before expm1; ``fault`` plants
    one variance shock of asset 1 taken from asset 0 ("asset") or one skipped
    step ("step")."""
    zc, w = H.heston_shocks(11, h, PATHS, steps, **KW)
    if fault == "asset":
        w = w.clone()
        w[..., FAULT_STEP, 1] = w[..., FAULT_STEP, 0]
    x = H.heston_increments(zc, w, h)
    acc = torch.zeros((BLOCKS, PATHS, h.corr_chol.shape[0]))
    for t in range(steps):
        if not (fault == "step" and t == FAULT_STEP):
            acc = acc + x[..., t, :]
    return acc


def _garch_terminal(g, steps, t_df, fault=None):
    """garch_terminal_reference's returns from its own pieces, ``fault`` as
    in ``_heston_log_sum`` (the shock of asset 1 from asset 0)."""
    zc = G.correlated_shocks(11, g, PATHS, steps, t_df=t_df, **KW)
    if fault == "asset":
        zc = zc.clone()
        zc[..., FAULT_STEP, 1] = zc[..., FAULT_STEP, 0]
    eps = G.garch_innovations(zc, g)
    cum = torch.ones((BLOCKS, PATHS, g.corr_chol.shape[0]))
    for t in range(steps):
        if not (fault == "step" and t == FAULT_STEP):
            cum = cum * ((1.0 + g.mu) + eps[..., t, :])
    return cum - 1.0


@pytest.mark.parametrize("a", [1, 7, 16])
@pytest.mark.parametrize("steps", [0, 1, 7, 9])
def test_heston_terminal_source_is_the_plain_path(emu, tmp_path, a, steps):
    """The emulated kernel's log sum equals the plain form's bit for bit at
    a Feller-violating vol of vol; its terminal returns sit within
    heston_shares of heston_terminal_reference (the C library's expm1f
    against torch's)."""
    state, x = _run(emu, tmp_path, "heston", a, steps, 3)
    h = _heston(x, a)
    assert torch.equal(state, _heston_log_sum(h, steps))
    k, _ = _run(emu, tmp_path, "heston", a, steps, 1)
    if steps == 0:   # no step: expm1(0) (the plain form takes at least one step)
        assert torch.equal(k, torch.zeros_like(k))
        return
    p = H.heston_terminal_reference(11, h, PATHS, steps, **KW)
    assert max(H.heston_shares(k, p, h, steps).values()) <= 1.0


@pytest.mark.parametrize("a", [1, 7, 16])
@pytest.mark.parametrize("t_df", [None, 5.5])
@pytest.mark.parametrize("steps", [1, 9])
def test_garch_terminal_source_matches_plain_form(emu, tmp_path, a, t_df, steps):
    """The emulated kernel within garch_shares of garch_terminal_reference,
    at larger GARCH shocks, in the normal and the Student-t tier (one and
    two Philox calls' tails: 1 and 9 steps)."""
    k, x = _run(emu, tmp_path, "garch", a, steps, 1 + 2 * (t_df is not None))
    g = _garch(x, a)
    p = G.garch_terminal_reference(11, g, PATHS, steps, t_df=t_df, **KW)
    assert torch.equal(p, _garch_terminal(g, steps, t_df))
    assert max(G.garch_shares(k, p, g, steps, t_df).values()) <= 1.0


@pytest.mark.parametrize("fault", ["asset", "step"])
def test_heston_terminal_checks_catch_planted_faults(emu, tmp_path, fault):
    """A plain side with one variance shock from the wrong asset, or one
    step skipped, is caught by the bit check of the state and by
    heston_shares, by more than twice its bound."""
    state, x = _run(emu, tmp_path, "heston", 7, 9, 3)
    h = _heston(x, 7)
    bad = _heston_log_sum(h, 9, fault)
    assert not torch.equal(state, bad)
    k, _ = _run(emu, tmp_path, "heston", 7, 9, 1)
    share = max(H.heston_shares(k, torch.expm1(bad), h, 9).values())
    print(f"heston fault {fault}: {share:.3g} of the bound")
    assert share > 2.0


@pytest.mark.parametrize("fault", ["asset", "step"])
@pytest.mark.parametrize("t_df", [None, 5.5])
def test_garch_terminal_check_catches_planted_faults(emu, tmp_path, fault, t_df):
    """A plain side with one shock from the wrong asset, or one step
    skipped, exceeds garch_shares' bound more than twice, in both tiers."""
    k, x = _run(emu, tmp_path, "garch", 7, 9, 1 + 2 * (t_df is not None))
    g = _garch(x, 7)
    share = max(G.garch_shares(k, _garch_terminal(g, 9, t_df, fault), g, 9, t_df).values())
    print(f"garch fault {fault} t_df={t_df}: {share:.3g} of the bound")
    assert share > 2.0
