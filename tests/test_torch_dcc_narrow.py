"""The narrow DCC candidate kernel (``dcc_dd_kernel``, up to 16 assets, both
modes) on the CPU: its layout plan and its CUDA source under a host emulation.

- ``ops.dcc.dcc_narrow_plan`` picks the solo layout up to 4 candidates and
  the split one (returns through a device scratch, then scoring blocks) past
  them; every block fits the H100's 232,448 bytes of shared memory at every
  A <= 16 and W <= 256; the scratch holds the whole launch up to 2 GiB (the
  frontier's 131,072 x 252 x 15) and chunks of 64 paths past it. Its
  arithmetic is the kernel's: ``NarrowLayout``, ``score_groups`` and
  ``score_steps`` compiled from ``csrc/dcc.cu`` give the same numbers.
- ``csrc/dcc.cu`` built with g++ against ``tools/cuda_emu``'s emulation of
  the CUDA runtime (each thread a std::thread, IEEE float32 without
  contraction) and run at A = 1, 7, 16, W = 1, 5, 256 and hedged (two legs
  per asset of every type), 5 steps over two blocks of 70 paths (not a
  multiple of any tile), also through a scratch of 64-path chunks: within
  ``ops.dcc.dcc_shares`` of the plain form, hedged path by path within
  ``dcc_price_bound``. Skipped where g++ is missing.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcport_torch.ops import dcc as O
from mcport_torch.ops.hedged import HedgeTensors

ROOT = Path(__file__).resolve().parents[1]
EMU = ROOT / "tools" / "cuda_emu"
SMEM = 232_448   # an H100 block's shared memory, bytes


@pytest.mark.parametrize("w, layout, score_paths", [
    (1, "solo", None), (2, "solo", None), (3, "solo", None), (4, "solo", None),
    (5, "split", 512), (16, "split", 256), (17, "split", 128), (64, "split", 64),
    (255, "split", 16), (256, "split", 16)])
def test_narrow_plan_picks_the_layout_by_w(w, layout, score_paths):
    """Solo (a thread per path scores its own candidates, one launch) up to
    4 candidates, split past them (the recursion's launch, then scoring
    blocks of 256 threads whose paths widen as W shrinks); each side of the
    switch and of the scoring blocks' widths."""
    p = O.dcc_narrow_plan(15, w, 52, 131_072)
    assert p.layout == layout
    if layout == "solo":
        assert (p.threads, p.paths, p.scratch_floats) == ((64,), (64,), 0)
    else:
        assert p.threads == (64, 256) and p.paths == (64, score_paths)
        assert p.scratch_floats == 131_072 * 52 * 15 and p.chunk == 131_072


def test_narrow_plan_fits_shared_memory():
    """Every launch of every A <= 16 and W <= 256, with 0 to 4 legs per
    asset, within an H100 block's shared memory; the solo and recursion
    blocks (64 threads) four to an SM's 233,472 bytes (with the 1 KB the
    runtime keeps per block) up to 15 assets, and at 16 but for solo blocks
    of more than one candidate or hedged, which run three to an SM."""
    worst = 0
    for a in range(1, 17):
        for w in range(1, 257):
            for legs in range(5):
                p = O.dcc_narrow_plan(a, w, 5, 100, 1, legs)
                worst = max(worst, *p.shared_bytes)
                four = 4 * (p.shared_bytes[0] + 1024) <= 233_472
                assert four or (a == 16 and p.layout == "solo" and (w > 1 or legs)), (a, w, legs)
                assert 3 * (p.shared_bytes[0] + 1024) <= 233_472
    assert 0 < worst <= SMEM


def test_narrow_plan_sizes_the_scratch():
    """The split layout's scratch holds every block's returns of a chunk of
    paths, in whole 16-path tiles: the whole launch up to 2 GiB (the
    frontier's 131,072 x 252 at 15 assets, 1.98 GB), chunks of 64 paths past
    it, and a refusal where not even 64 paths fit."""
    whole = O.dcc_narrow_plan(15, 256, 252, 131_072)
    assert whole.chunk == 131_072 and 4 * whole.scratch_floats == 1_981_808_640
    assert whole.scratch_floats <= O.NARROW_SCRATCH_FLOATS
    ragged = O.dcc_narrow_plan(7, 17, 5, 70, 2)
    assert ragged.chunk == 70 and ragged.scratch_floats == 2 * 80 * 5 * 7
    big = O.dcc_narrow_plan(16, 64, 252, 1_048_576, 2)
    assert big.chunk % 64 == 0 and 0 < big.chunk < 1_048_576
    assert big.scratch_floats == 2 * 252 * 16 * big.chunk <= O.NARROW_SCRATCH_FLOATS
    small = O.dcc_narrow_plan(5, 17, 7, 150, 2, scratch_floats=4_480)
    assert (small.chunk, small.scratch_floats) == (64, 4_480)
    with pytest.raises(ValueError, match="holds no 64-path chunk"):
        O.dcc_narrow_plan(5, 17, 7, 150, 2, scratch_floats=4_479)
    for a, w in ((0, 1), (17, 1), (3, 0), (3, 257)):
        with pytest.raises(ValueError, match="dcc_dd_kernel takes"):
            O.dcc_narrow_plan(a, w)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """``csrc/dcc.cu`` under the host emulation: the driver binary."""
    if shutil.which("g++") is None:
        pytest.skip("the host emulation of the CUDA sources needs g++")
    sys.path.insert(0, str(EMU))
    try:
        from prep import prep
    finally:
        sys.path.remove(str(EMU))
    work = tmp_path_factory.mktemp("dcc_emu")
    prep(ROOT / "mcport_torch" / "csrc", work / "csrc")
    exe = work / "dcc_emu"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-DDCC_NARROW_SCRATCH",
                    f"-I{EMU}", f"-I{work / 'csrc'}", str(EMU / "dcc_main.cpp"), "-o", str(exe),
                    "-lpthread"], check=True, timeout=300)
    return exe


def test_narrow_plan_is_the_kernels_layout(emu, tmp_path):
    """The Python mirror against ``NarrowLayout``, ``score_groups`` and
    ``score_steps`` compiled from the kernel's source, at every A <= 16, W <=
    256 and 0-4 legs."""
    out = tmp_path / "layout.bin"
    subprocess.run([str(emu), "layout", str(out)], check=True, timeout=60)
    rows = np.fromfile(out, np.int32).reshape(-1, 7)
    assert len(rows) == 16 * 256 * 5 * 3
    modes = {0: "solo", 1: "returns", 2: "score"}
    for a, w, legs, mode, total, groups, steps in rows:
        assert O._narrow_shared(a, w, modes[mode], legs) == 4 * total, (a, w, legs, mode)
        assert O._score_groups(w) == groups
        assert min(max(8192 // (a * 4 * groups), 1), 16) == steps


def _launch(emu, tmp_path, a, w, legs, case, paths=70, steps=5, n_blocks=2, scratch=None):
    """One emulated launch (seed 11, blocks 7 and 8) and the plain form on
    its inputs: (kernel (term, dd), plain, DccTensors, hedge)."""
    out = tmp_path / f"a{a}_w{w}_l{legs}_{scratch}.bin"
    args = [str(emu), "1", str(a), str(paths), str(steps), str(n_blocks), str(w), str(legs),
            str(case), str(out)] + ([str(scratch)] if scratch is not None else [])
    subprocess.run(args, check=True, timeout=120)
    k = torch.from_numpy(np.fromfile(out, np.float32)).reshape(2, n_blocks, w, paths)
    x = np.fromfile(str(out) + ".in", np.float32)
    cut = [a * a, 2 * a * a] + [2 * a * a + i * a for i in range(1, 8)]
    s, q0, mu, omega, alpha, beta, s2_0, e2_0, e0, rest = np.split(x, cut)
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))  # noqa: E731
    d = O.DccTensors(t(mu), t(omega), t(alpha), t(beta), t(s2_0), t(e2_0), t(e0),
                     t(s.reshape(a, a)), t(q0.reshape(a, a)), t(rest[:2]))
    weights = t(rest[2:2 + w * a].reshape(w, a))
    hedge = None
    if legs:
        h = rest[2 + w * a:]
        assert h.size == a * (1 + 4 * legs)
        s0, ty, strike, prem, qty = np.split(h, np.cumsum([a] + 3 * [a * legs]))
        hedge = HedgeTensors(t(s0), t(ty.reshape(a, legs)).to(torch.int32),
                             t(strike.reshape(a, legs)), t(prem.reshape(a, legs)),
                             t(qty.reshape(a, legs)))
    p = O.dcc_multi_dd_reference(11, d, weights, paths, steps, first_block=6, n_blocks=n_blocks,
                                 hedge=hedge, with_bound=hedge is not None)
    return (k[0], k[1]), p, d, hedge


@pytest.mark.parametrize("a", [1, 7, 16])
@pytest.mark.parametrize("w", [1, 5, 256])
@pytest.mark.parametrize("legs", [0, 2])
def test_narrow_kernel_source_matches_plain_form(emu, tmp_path, a, w, legs):
    """The kernel's source, emulated, against the plain form: unhedged to
    ``dcc_shares``, hedged (two legs per asset, every leg type) path by path
    to ``dcc_price_bound``; q0 off S with a large e0 on odd widths."""
    k, p, d, hedge = _launch(emu, tmp_path, a, w, legs, case=a % 2)
    shares = O.dcc_shares(k, p, d, 5, hedge=hedge)
    assert max(shares.values()) <= 1.0, shares
    assert all(bool(torch.isfinite(x).all()) for x in k)


def test_narrow_kernel_source_chunks_its_scratch(emu, tmp_path):
    """Through a scratch that holds 64 paths of the 150 (three chunks, the
    last ragged), the split layout gives the whole launch's outputs bit for
    bit."""
    whole, p, d, hedge = _launch(emu, tmp_path, 5, 17, 2, 1, paths=150, steps=7)
    chunked, *_ = _launch(emu, tmp_path, 5, 17, 2, 1, paths=150, steps=7, scratch=2 * 7 * 5 * 64)
    assert all(torch.equal(x, y) for x, y in zip(whole, chunked))
    assert max(O.dcc_shares(whole, p, d, 7, hedge=hedge).values()) <= 1.0
