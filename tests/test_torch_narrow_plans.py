"""The Merton (#8) and Heston (#10) candidate kernels up to 16 assets on the
CPU: their layout plans and their CUDA sources under a host emulation.

- ``ops.jump.merton_narrow_plan`` picks the solo layout (a thread per path
  scores its own candidates) up to 10 candidates and the split one (the
  returns through a device scratch, then scoring blocks) past them;
  ``ops.heston.heston_narrow_plan`` solo up to 12, split up to 128 and the
  tile layout (a 16-path tile, items and scorers one Philox call apart) past
  them. The layout W picks fits the H100's 232,448 bytes of shared memory
  at every A <= 16, W <= 256 and 0-4 legs, and so does every layout by name
  but Heston's solo one at many candidates (refused with its byte count); the
  split scratch holds the whole launch up to 2 GiB (the frontier's 131,072
  x 252 x 15) and chunks of 64 paths past it. Their arithmetic is the
  kernels': ``narrow_layout``, ``RecurLayout``, ``TileLayout``,
  ``score_floats`` and ``score_groups`` compiled from ``csrc/jump.cu`` and
  ``csrc/heston.cu`` give the same numbers.
- Both sources built with g++ against ``tools/cuda_emu``'s emulation of the
  CUDA runtime (each thread a std::thread, IEEE float32 without
  contraction) and run at A = 1, 7, 16 on each side of the layout switches
  and at 256, hedged (two legs per asset of every type), 5 steps over two
  blocks of 70 paths (a multiple of no block or tile), at a high jump rate
  and at a Feller-violating vol of vol: within ``merton_shares`` and
  ``heston_shares`` of the plain forms, hedged path by path within the
  price bounds; the split layout through a scratch of 64-path chunks bit for
  bit with the whole launch. Skipped where g++ is missing.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcport_torch.ops import heston as H
from mcport_torch.ops import jump as J
from mcport_torch.ops import narrow as N
from mcport_torch.ops.hedged import HedgeTensors

ROOT = Path(__file__).resolve().parents[1]
EMU = ROOT / "tools" / "cuda_emu"
SMEM = 232_448   # an H100 block's shared memory, bytes
PLANS = {"jump": J.merton_narrow_plan, "heston": H.heston_narrow_plan}


@pytest.mark.parametrize("family, w, layout, score_paths", [
    ("jump", 1, "solo", None), ("jump", 10, "solo", None), ("jump", 11, "split", 256),
    ("jump", 128, "split", 32), ("jump", 256, "split", 16),
    ("heston", 1, "solo", None), ("heston", 12, "solo", None), ("heston", 13, "split", 256),
    ("heston", 128, "split", 32), ("heston", 129, "tile", None), ("heston", 256, "tile", None)])
def test_narrow_plans_pick_the_layout_by_w(family, w, layout, score_paths):
    """Each side of every switch: solo (64-thread blocks, a path each),
    split (the recursion's 64-thread blocks, then 256-thread scoring blocks
    whose paths widen as W shrinks), tile (256 threads over 16 paths)."""
    p = PLANS[family](15, w, 252, 131_072)
    assert p.layout == layout
    if layout == "solo":
        assert (p.threads, p.paths, p.scratch_floats) == ((64,), (64,), 0)
    elif layout == "tile":
        assert (p.threads, p.paths, p.scratch_floats) == ((256,), (16,), 0)
    else:
        assert p.threads == (64, 256) and p.paths == (64, score_paths)
        assert p.scratch_floats == 131_072 * 252 * 15 and p.chunk == 131_072


@pytest.mark.parametrize("family", ["jump", "heston"])
def test_narrow_plans_fit_shared_memory(family):
    """The layout W picks at every A <= 16, W <= 256 and 0-4 legs per asset
    within a block's shared memory, its recursion blocks (64 threads) four
    to an SM's 233,472 bytes with the 1 KB the runtime keeps per block; each
    layout by name fits too but Heston's solo one near 256 candidates (its
    variance shocks' slice besides the candidates' state), which is refused
    with its byte count."""
    plan, worst = PLANS[family], 0
    for a in range(1, 17):
        for w in range(1, 257):
            for legs in range(5):
                p = plan(a, w, 5, 100, 1, legs)
                worst = max(worst, *p.shared_bytes)
                assert p.layout == "tile" or 4 * (p.shared_bytes[0] + 1024) <= 233_472
                for name in ("split", "tile") if family == "heston" else ("split",):
                    assert max(plan(a, w, 5, 100, 1, legs, layout=name).shared_bytes) <= SMEM
    assert 0 < worst <= SMEM
    assert plan(16, 64, 5, 100, 1, 4, layout="solo").shared_bytes[0] <= SMEM
    if family == "jump":
        assert plan(16, 256, 5, 100, 1, 4, layout="solo").shared_bytes[0] <= SMEM
    else:   # the variance shocks' slice too
        with pytest.raises(ValueError, match="solo layout needs .* bytes of shared memory"):
            plan(16, 256, 5, 100, 1, 4, layout="solo")


def test_narrow_plans_size_the_scratch():
    """The split layout's scratch holds every block's returns of a chunk of
    paths in whole 16-path tiles: the whole launch up to 2 GiB (the
    frontier's 131,072 x 252 at 15 assets, 1.98 GB), chunks of 64 paths past
    it, a refusal where not even 64 paths fit; the jump kernel has no tile
    layout, and no layout takes more than 16 assets."""
    whole = J.merton_narrow_plan(15, 256, 252, 131_072)
    assert whole.chunk == 131_072 and 4 * whole.scratch_floats == 1_981_808_640
    assert whole.scratch_floats <= N.NARROW_SCRATCH_FLOATS
    ragged = H.heston_narrow_plan(7, 17, 5, 70, 2)
    assert ragged.chunk == 70 and ragged.scratch_floats == 2 * 80 * 5 * 7
    big = H.heston_narrow_plan(16, 64, 252, 1_048_576, 2)
    assert big.chunk % 64 == 0 and 0 < big.chunk < 1_048_576
    assert big.scratch_floats == 2 * 252 * 16 * big.chunk <= N.NARROW_SCRATCH_FLOATS
    small = J.merton_narrow_plan(5, 17, 7, 150, 2, scratch_floats=4_480)
    assert (small.chunk, small.scratch_floats) == (64, 4_480)
    with pytest.raises(ValueError, match="holds no 64-path chunk"):
        J.merton_narrow_plan(5, 17, 7, 150, 2, scratch_floats=4_479)
    with pytest.raises(ValueError, match="has no 'tile' layout"):
        J.merton_narrow_plan(5, 200, layout="tile")
    for plan in PLANS.values():
        for a, w in ((0, 1), (17, 1), (3, 0), (3, 257)):
            with pytest.raises(ValueError, match="takes 1-16 assets"):
                plan(a, w)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """Both kernel sources under the host emulation: ``{family: driver}``."""
    if shutil.which("g++") is None:
        pytest.skip("the host emulation of the CUDA sources needs g++")
    sys.path.insert(0, str(EMU))
    try:
        from prep import prep
    finally:
        sys.path.remove(str(EMU))
    work = tmp_path_factory.mktemp("narrow_emu")
    prep(ROOT / "mcport_torch" / "csrc", work / "csrc")
    procs = {}
    for family in PLANS:
        exe = work / f"{family}_emu"
        procs[family] = (exe, subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-ffp-contract=off", f"-DFAMILY_{family.upper()}",
             "-DNARROW_LAYOUTS", f"-I{EMU}", f"-I{work / 'csrc'}", str(EMU / "narrow_main.cpp"),
             "-o", str(exe), "-lpthread"]))
    for exe, proc in procs.values():
        assert proc.wait(timeout=300) == 0
    return {family: exe for family, (exe, _) in procs.items()}


@pytest.mark.parametrize("family", ["jump", "heston"])
def test_narrow_plans_are_the_kernels_layout(emu, tmp_path, family):
    """The Python mirror against the layout arithmetic compiled from the
    kernel's source, at every A <= 16, W <= 256 and 0-4 legs."""
    out = tmp_path / "layout.bin"
    subprocess.run([str(emu[family]), "layout", str(out)], check=True, timeout=60)
    rows = np.fromfile(out, np.int32).reshape(-1, 9)
    assert len(rows) == 16 * 256 * 5
    plan = PLANS[family]
    names = {0: "solo", 1: "split", 2: "tile"}
    for a, w, legs, layout, own, rets, tile, score, groups in rows:
        assert plan(a, w, 5, 100, 1, legs).layout == names[layout], (a, w)
        solo = plan(a, w, 5, 100, 1, legs, layout="solo") if 4 * own <= SMEM else None
        split = plan(a, w, 5, 100, 1, legs, layout="split")
        assert solo is None or solo.shared_bytes == (4 * own,), (a, w, legs)
        assert split.shared_bytes == (4 * rets, 4 * score), (a, w, legs)
        assert split.paths[1] == 4 * groups
        if family == "heston":
            assert plan(a, w, 5, 100, 1, legs, layout="tile").shared_bytes == (4 * tile,)


def _launch(emu, tmp_path, family, a, w, legs, case, paths=70, steps=5, n_blocks=2,
            layout=-1, scratch=None):
    """One emulated launch (seed 11, blocks 7 and 8) and the plain form on
    its inputs: (kernel (term, dd), plain, the inputs for the shares)."""
    out = tmp_path / f"{family}_a{a}_w{w}_l{legs}_{layout}_{scratch}.bin"
    args = [str(emu[family]), str(a), str(paths), str(steps), str(n_blocks), str(w), str(legs),
            str(layout), str(case), str(out)] + ([str(scratch)] if scratch is not None else [])
    subprocess.run(args, check=True, timeout=120)
    k = torch.from_numpy(np.fromfile(out, np.float32)).reshape(2, n_blocks, w, paths)
    x = np.fromfile(str(out) + ".in", np.float32)
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))  # noqa: E731
    n_params = a * a + (3 if family == "jump" else 7) * a
    params, rest = x[:n_params], x[n_params:]
    if family == "jump":
        rate, rest = float(rest[0]), rest[1:]
    weights = t(rest[:w * a].reshape(w, a))
    hedge = None
    if legs:
        h = rest[w * a:]
        assert h.size == a * (1 + 4 * legs)
        s0, ty, strike, prem, qty = np.split(h, np.cumsum([a] + 3 * [a * legs]))
        hedge = HedgeTensors(t(s0), t(ty.reshape(a, legs)).to(torch.int32),
                             t(strike.reshape(a, legs)), t(prem.reshape(a, legs)),
                             t(qty.reshape(a, legs)))
    kw = dict(first_block=6, n_blocks=n_blocks, hedge=hedge, with_bound=hedge is not None)
    if family == "jump":
        chol = t(params[:a * a].reshape(a, a))
        mean, muj, sigj = (t(v) for v in np.split(params[a * a:], 3))
        p = J.merton_multi_dd_reference(11, mean, chol, rate, muj, sigj, weights, paths, steps,
                                        **kw)
        shares = J.merton_shares((k[0], k[1]), p, chol, mean, sigj, steps, hedge)
    else:
        mu, kappa, theta, xi, rho, rho_c, v0 = (t(v) for v in np.split(params[a * a:], 7))
        h = H.HestonTensors(mu, kappa, theta, xi, rho, v0, t(params[:a * a].reshape(a, a)))
        assert torch.equal(h.packed(), t(params))   # rho_c too, as the wrapper packs it
        p = H.heston_multi_dd_reference(11, h, weights, paths, steps, **kw)
        shares = H.heston_shares((k[0], k[1]), p, h, steps, hedge=hedge)
    return (k[0], k[1]), shares


@pytest.mark.parametrize("family", ["jump", "heston"])
@pytest.mark.parametrize("a", [1, 7, 16])
@pytest.mark.parametrize("w", [1, 13, 256])
@pytest.mark.parametrize("legs", [0, 2])
def test_narrow_kernel_sources_match_plain_form(emu, tmp_path, family, a, w, legs):
    """Each kernel's source, emulated in the layout W picks (solo at 1, split
    at 13, split or tile at 256), against the plain form: unhedged within
    the shares' bound, hedged (two legs per asset, every leg type) path by
    path within the price bound; rate 0.3 or vol of vol 0.05."""
    k, shares = _launch(emu, tmp_path, family, a, w, legs, case=1)
    assert max(shares.values()) <= 1.0, shares
    assert all(bool(torch.isfinite(x).all()) for x in k)


@pytest.mark.parametrize("family", ["jump", "heston"])
def test_narrow_split_source_chunks_its_scratch(emu, tmp_path, family):
    """Through a scratch that holds 64 paths of the 150 (three chunks, the
    last ragged), the split layout gives the whole launch's outputs bit for
    bit, and both the tile layout's where the kernel has one."""
    whole, shares = _launch(emu, tmp_path, family, 5, 17, 2, 1, paths=150, steps=7, layout=1)
    chunked, _ = _launch(emu, tmp_path, family, 5, 17, 2, 1, paths=150, steps=7, layout=1,
                         scratch=2 * 7 * 5 * 64)
    assert all(torch.equal(x, y) for x, y in zip(whole, chunked))
    assert max(shares.values()) <= 1.0
    if family == "heston":
        tile, _ = _launch(emu, tmp_path, family, 5, 17, 2, 1, paths=150, steps=7, layout=2)
        assert all(torch.equal(x, y) for x, y in zip(whole, tile))
