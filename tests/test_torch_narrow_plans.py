"""The GBM (#3, with the path-stats function #2), Merton (#8), Heston (#10),
GARCH (#5) and bootstrap (#7) candidate kernels up to 16 assets on the CPU:
their layout plans and their CUDA sources under a host emulation.

- ``ops.jump.merton_narrow_plan`` picks the solo layout (a thread per path
  scores its own candidates) up to 10 candidates and the split one (the
  returns through a device scratch, then scoring blocks) past them;
  ``ops.heston.heston_narrow_plan`` solo up to 12, split up to 128 and the
  tile layout (a 16-path tile, items and scorers one Philox call apart) past
  them; ``ops.multi_dd.gbm_narrow_plan`` solo (float32 tier only) up to 22
  (23 rebalanced, 14 hedged) and split past them, solo with no steps;
  ``ops.garch.garch_narrow_plan`` solo up to 13 and split past them,
  ``ops.bootstrap.bootstrap_narrow_plan`` solo up to 22 (14 hedged; blocks
  of 128 paths) and split past them. The layout W picks fits the H100's 232,448
  bytes of shared memory at every A <= 16, W <= 256 and 0-4 legs, and so
  does every layout by name but the solo one at many candidates where its
  state outgrows the block (refused with its byte count); the bootstrap's
  365-row history sits in each layout's shared memory where that layout's
  own bytes leave room for it, a longer one in device memory. The split
  scratch holds the whole launch up to 2 GiB (the frontier's 131,072 x 252
  x 15) and chunks of a recursion block's paths past it. Their arithmetic
  is the kernels': ``narrow_layout``, ``RecurLayout``, Heston's tile layout's,
  ``score_floats`` and ``score_groups`` compiled from the four sources give
  the same numbers.
- The four sources built with g++ against ``tools/cuda_emu``'s emulation of
  the CUDA runtime (each thread a std::thread, IEEE float32 without
  contraction) and run at A = 1, 7, 16 on each side of the layout switches
  and at 256, hedged (two legs per asset of every type), 5 steps over two
  blocks of 70 paths (a multiple of no block or tile), at a high jump rate,
  a Feller-violating vol of vol, larger GARCH shocks, and the bootstrap over
  a 365-row history in shared memory (unhedged) and a 4,099-row one in
  device memory (hedged): within ``merton_shares``, ``heston_shares``,
  ``garch_shares`` and ``bootstrap_shares`` of the plain forms, hedged path
  by path within the price bounds; the split layout through a scratch of
  one-block chunks bit for bit with the whole launch, and with the tile
  layout where the kernel has one (Heston).
- The GBM source (``csrc/gbm_narrow.cu``) the same way, with its own
  layout rows (``gbm_layout`` by W, mode and score tier): every layout of
  each mode, score tier and draw tier, and at 0 steps, bit for bit with
  ``csrc/multi_dd.cu``'s tile kernel emulated at the same width (the
  oracle: on the card it runs from 17 assets), within
  ``multi_dd_shares`` of the plain form (hedged path by path); the
  path-stats kernel (``csrc/path_stats.cu``) bit for bit with #3 at one
  candidate, within ``path_stats_shares``; a factor with terms
  above its diagonal (the triangle guard) within the plain form's bound,
  where leaving those terms out would not be.

Skipped where g++ is missing.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcport_torch.ops import bootstrap as B
from mcport_torch.ops import garch as G
from mcport_torch.ops import heston as H
from mcport_torch.ops import jump as J
from mcport_torch.ops import multi_dd as M
from mcport_torch.ops import narrow as N
from mcport_torch.ops import path_stats as PS
from mcport_torch.ops.hedged import HedgeTensors

ROOT = Path(__file__).resolve().parents[1]
EMU = ROOT / "tools" / "cuda_emu"
SMEM = 232_448   # an H100 block's shared memory, bytes


def _bootstrap_plan(a, w, *args, **kw):
    """``bootstrap_narrow_plan`` over the bench's 365-row history, with the
    other plans' positional arguments."""
    return B.bootstrap_narrow_plan(a, w, 365, *args, **kw)


PLANS = {"jump": J.merton_narrow_plan, "heston": H.heston_narrow_plan,
         "garch": G.garch_narrow_plan, "bootstrap": _bootstrap_plan,
         "gbm": M.gbm_narrow_plan}
#: threads (a path each) of each kernel's recursion block
THREADS = {"jump": 64, "heston": 64, "garch": 64, "bootstrap": 128, "gbm": 64}
#: the layouts each kernel takes by name
NAMED = {"jump": ("solo", "split"), "heston": ("solo", "split", "tile"),
         "garch": ("solo", "split"), "bootstrap": ("solo", "split"),
         "gbm": ("solo", "split")}
#: the emulated GBM executables: csrc/gbm_narrow.cu, multi_dd.cu's tile kernel (the
#: oracle) and path_stats.cu's kernels (tools/cuda_emu/gbm_main.inc)
GBM_BUILDS = ("GBM", "GBM_TILE", "GBM_STATS")


@pytest.mark.parametrize("family, w, layout, score_paths", [
    ("jump", 1, "solo", None), ("jump", 10, "solo", None), ("jump", 11, "split", 256),
    ("jump", 128, "split", 32), ("jump", 256, "split", 16),
    ("heston", 1, "solo", None), ("heston", 12, "solo", None), ("heston", 13, "split", 256),
    ("heston", 128, "split", 32), ("heston", 129, "tile", None), ("heston", 256, "tile", None),
    ("garch", 1, "solo", None), ("garch", 13, "solo", None), ("garch", 14, "split", 256),
    ("garch", 256, "split", 16),
    ("bootstrap", 1, "solo", None), ("bootstrap", 22, "solo", None),
    ("bootstrap", 23, "split", 128), ("bootstrap", 256, "split", 16),
    ("bootstrap hedged", 14, "solo", None), ("bootstrap hedged", 15, "split", 256)])
def test_narrow_plans_pick_the_layout_by_w(family, w, layout, score_paths):
    """Each side of every switch: solo (a path per thread of the recursion
    block), split (the recursion's blocks, then 256-thread scoring blocks
    whose paths widen as W shrinks), tile (256 threads over 16 paths); the
    bootstrap's hedged switch (two legs per asset) comes earlier."""
    legs = 2 if family.endswith(" hedged") else 0
    family = family.removesuffix(" hedged")
    p = PLANS[family](15, w, 252, 131_072, 1, legs)
    t = THREADS[family]
    assert p.layout == layout
    if layout == "solo":
        assert (p.threads, p.paths, p.scratch_floats) == ((t,), (t,), 0)
    elif layout == "tile":
        assert (p.threads, p.paths, p.scratch_floats) == ((256,), (16,), 0)
    else:
        assert p.threads == (t, 256) and p.paths == (t, score_paths)
        assert p.scratch_floats == 131_072 * 252 * 15 and p.chunk == 131_072


@pytest.mark.parametrize("family", ["jump", "heston", "garch", "bootstrap", "gbm"])
def test_narrow_plans_fit_shared_memory(family):
    """The layout W picks at every A <= 16, W <= 256 and 0-4 legs per asset
    within a block's shared memory, its recursion blocks at least 256 threads
    to an SM's 233,472 bytes with the 1 KB the runtime keeps per block (four
    blocks of 64, or 128-thread blocks of the bootstrap's walk); each layout by
    name fits too but the solo one near 256 candidates where its state
    outgrows a block (Heston's beside its variance shocks' slice, the
    bootstrap's in 128-path blocks), which is refused with its byte count."""
    plan, worst = PLANS[family], 0
    for a in range(1, 17):
        for w in range(1, 257):
            for legs in range(5):
                p = plan(a, w, 5, 100, 1, legs)
                worst = max(worst, *p.shared_bytes)
                per_sm = 233_472 // (p.shared_bytes[0] + 1024) * p.threads[0]
                assert p.layout == "tile" or per_sm >= 256
                for name in NAMED[family][1:]:
                    assert max(plan(a, w, 5, 100, 1, legs, layout=name).shared_bytes) <= SMEM
    assert 0 < worst <= SMEM
    assert plan(16, 64, 5, 100, 1, 4, layout="solo").shared_bytes[0] <= SMEM
    if family in ("jump", "garch", "gbm"):
        assert plan(16, 256, 5, 100, 1, 4, layout="solo").shared_bytes[0] <= SMEM
    else:   # the variance shocks' slice, or 128 paths' state
        with pytest.raises(ValueError, match="solo layout needs .* bytes of shared memory"):
            plan(16, 256, 5, 100, 1, 4, layout="solo")


def test_bootstrap_layouts_place_the_history():
    """Each bootstrap layout keeps the history in its block's shared memory
    where its own bytes leave room: the bench's 365 rows in every layout W
    picks, an 8,192-row history in none (read through the read-only cache),
    and the solo layout's state can crowd it out at many candidates."""
    for w in (1, 8, 9, 256):
        layout = _bootstrap_plan(15, w).layout
        assert B.bootstrap_layout_holds_history(layout, 15, w, 365, 2)
        assert not B.bootstrap_layout_holds_history(layout, 15, w, 8_192)
        assert B.bootstrap_layout_holds_history(None, 40, w, 365)   # bootstrap_dd_kernel
    assert not B.bootstrap_layout_holds_history(None, 40, 256, 8_192)
    hist = 4 * N.r4(365 * 15)
    solo = B.bootstrap_narrow_plan(15, 8, 365, 252, 131_072)
    assert solo.shared_bytes == (hist + 4 * (8 * 16 + 3 * 8 * 128),)
    assert B.bootstrap_narrow_plan(15, 8, 8_192).shared_bytes == (4 * (8 * 16 + 3 * 8 * 128),)
    assert not B.bootstrap_layout_holds_history("solo", 15, 140, 365)
    crowded = B.bootstrap_narrow_plan(15, 140, layout="solo").shared_bytes[0]
    assert crowded == 4 * (140 * 16 + 3 * 140 * 128) <= SMEM


@pytest.mark.parametrize("family, t", [("jump", 64), ("heston", 64), ("garch", 64),
                                       ("bootstrap", 128), ("gbm", 64)])
def test_narrow_plans_size_the_scratch(family, t):
    """The split layout's scratch holds every block's returns of a chunk of
    paths in whole 16-path tiles: the whole launch up to 2 GiB (the
    frontier's 131,072 x 252 at 15 assets, 1.98 GB), chunks of a recursion
    block's paths past it, a refusal where not even one block's paths fit;
    only the Heston kernel has a tile layout, and no layout takes more than
    16 assets."""
    plan = PLANS[family]
    whole = plan(15, 256, 252, 131_072, layout="split")
    assert whole.chunk == 131_072 and 4 * whole.scratch_floats == 1_981_808_640
    assert whole.scratch_floats <= N.NARROW_SCRATCH_FLOATS
    ragged = plan(7, 17, 5, 70, 2, layout="split")
    assert ragged.chunk == 70 and ragged.scratch_floats == 2 * 80 * 5 * 7
    big = plan(16, 64, 252, 1_048_576, 2)
    assert big.chunk % t == 0 and 0 < big.chunk < 1_048_576
    assert big.scratch_floats == 2 * 252 * 16 * big.chunk <= N.NARROW_SCRATCH_FLOATS
    small = plan(5, 17, 7, 300, 2, scratch_floats=70 * t, layout="split")
    assert (small.chunk, small.scratch_floats) == (t, 70 * t)
    with pytest.raises(ValueError, match=f"holds no {t}-path chunk"):
        plan(5, 17, 7, 300, 2, scratch_floats=70 * t - 1, layout="split")
    if "tile" not in NAMED[family]:
        with pytest.raises(ValueError, match="has no 'tile' layout"):
            plan(5, 200, layout="tile")
    for a, w in ((0, 1), (17, 1), (3, 0), (3, 257)):
        with pytest.raises(ValueError, match="takes 1-16 assets"):
            plan(a, w)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The kernel sources under the host emulation: ``{family: executable}``
    (the GBM sources' three by their names in ``GBM_BUILDS``)."""
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
    for family in [f for f in PLANS if f != "gbm"] + list(GBM_BUILDS):
        exe = work / f"{family}_emu"
        procs[family] = (exe, subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-ffp-contract=off", f"-DFAMILY_{family.upper()}",
             "-DNARROW_LAYOUTS", f"-I{EMU}", f"-I{work / 'csrc'}", str(EMU / "narrow_main.cpp"),
             "-o", str(exe), "-lpthread"]))
    for exe, proc in procs.values():
        assert proc.wait(timeout=300) == 0
    return {family: exe for family, (exe, _) in procs.items()}


@pytest.mark.parametrize("family", ["jump", "heston", "garch", "bootstrap"])
def test_narrow_plans_are_the_kernels_layout(emu, tmp_path, family):
    """The Python mirror against the layout arithmetic compiled from the
    kernel's source, at every A <= 16, W <= 256 and 0-4 legs (the
    bootstrap's with and without a 365-row history in shared memory)."""
    out = tmp_path / "layout.bin"
    subprocess.run([str(emu[family]), "layout", str(out)], check=True, timeout=60)
    cols = 11 if family == "bootstrap" else 9
    rows = np.fromfile(out, np.int32).reshape(-1, cols)
    assert len(rows) == 16 * 256 * 5
    plan = PLANS[family]
    names = {0: "solo", 1: "split", 2: "tile"}
    for row in rows:
        a, w, legs, layout, own, rets, tile, score, groups = row[:9]
        if family == "bootstrap":   # a layout holds the history where it fits
            own, rets = (x_sh if 4 * x_sh <= SMEM else x
                         for x, x_sh in zip((own, rets), row[9:]))
        assert plan(a, w, 5, 100, 1, legs).layout == names[layout], (a, w)
        solo = plan(a, w, 5, 100, 1, legs, layout="solo") if 4 * own <= SMEM else None
        split = plan(a, w, 5, 100, 1, legs, layout="split")
        assert solo is None or solo.shared_bytes == (4 * own,), (a, w, legs)
        assert split.shared_bytes == (4 * rets, 4 * score), (a, w, legs)
        assert split.paths[1] == 4 * groups
        if "tile" in NAMED[family]:
            assert plan(a, w, 5, 100, 1, legs, layout="tile").shared_bytes == (4 * tile,)


def _launch(emu, tmp_path, family, a, w, legs, case, paths=70, steps=5, n_blocks=2,
            layout=-1, scratch=None):
    """One emulated launch (seed 11, blocks 7 and 8) and the plain form on
    its inputs: (kernel (term, dd), the shares of the bound)."""
    out = tmp_path / f"{family}_a{a}_w{w}_l{legs}_{layout}_{scratch}.bin"
    args = [str(emu[family]), str(a), str(paths), str(steps), str(n_blocks), str(w), str(legs),
            str(layout), str(case), str(out)] + ([str(scratch)] if scratch is not None else [])
    subprocess.run(args, check=True, timeout=120)
    k = torch.from_numpy(np.fromfile(out, np.float32)).reshape(2, n_blocks, w, paths)
    x = np.fromfile(str(out) + ".in", np.float32)
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))  # noqa: E731
    n_params = {"jump": a * a + 3 * a, "heston": a * a + 7 * a, "garch": a * a + 6 * a,
                "bootstrap": (4_099 if case else 365) * a}[family]
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
    elif family == "heston":
        mu, kappa, theta, xi, rho, rho_c, v0 = (t(v) for v in np.split(params[a * a:], 7))
        h = H.HestonTensors(mu, kappa, theta, xi, rho, v0, t(params[:a * a].reshape(a, a)))
        assert torch.equal(h.packed(), t(params))   # rho_c too, as the wrapper packs it
        p = H.heston_multi_dd_reference(11, h, weights, paths, steps, **kw)
        shares = H.heston_shares((k[0], k[1]), p, h, steps, hedge=hedge)
    elif family == "garch":
        mu, omega, alpha, beta, s2_0, e2_0 = (t(v) for v in np.split(params[a * a:], 6))
        g = G.GarchTensors(mu, omega, alpha, beta, t(params[:a * a].reshape(a, a)), s2_0, e2_0)
        assert torch.equal(g.packed(g.corr_chol), t(params))
        p = G.garch_multi_dd_reference(11, g, weights, paths, steps, **{**kw, "with_bound": True})
        shares = G.garch_shares((k[0], k[1]), p, g, steps, hedge=hedge)
    else:
        hist = t(params.reshape(-1, a))
        p = B.bootstrap_multi_dd_reference(11, hist, weights, paths, steps, 0.2, **kw)
        shares = B.bootstrap_shares((k[0], k[1]), p, hist, weights, steps, hedge=hedge)
    return (k[0], k[1]), shares


@pytest.mark.parametrize("family", ["jump", "heston", "garch", "bootstrap"])
@pytest.mark.parametrize("a", [1, 7, 16])
@pytest.mark.parametrize("w", [1, 13, 256])
@pytest.mark.parametrize("legs", [0, 2])
def test_narrow_kernel_sources_match_plain_form(emu, tmp_path, family, a, w, legs):
    """Each kernel's source, emulated in the layout W picks (solo at 1, solo
    or split at 13, split or tile at 256), against the plain form: unhedged
    within the shares' bound, hedged (two legs per asset, every leg type) path by
    path within the price bound; rate 0.3, vol of vol 0.05, larger GARCH
    shocks; the bootstrap's history in shared memory unhedged, in device
    memory hedged."""
    case = 0 if family == "bootstrap" and not legs else 1
    k, shares = _launch(emu, tmp_path, family, a, w, legs, case=case)
    assert max(shares.values()) <= 1.0, shares
    assert all(bool(torch.isfinite(x).all()) for x in k)


@pytest.mark.parametrize("family", ["jump", "heston", "garch", "bootstrap"])
def test_narrow_split_source_chunks_its_scratch(emu, tmp_path, family):
    """Through a scratch that holds one recursion block's paths of the 150
    (the last chunk ragged), the split layout gives the whole launch's
    outputs bit for bit, and so does the tile layout where the kernel has
    one (Heston)."""
    t = THREADS[family]
    whole, shares = _launch(emu, tmp_path, family, 5, 17, 2, 1, paths=150, steps=7, layout=1)
    chunked, _ = _launch(emu, tmp_path, family, 5, 17, 2, 1, paths=150, steps=7, layout=1,
                         scratch=2 * 7 * 5 * t)
    assert all(torch.equal(x, y) for x, y in zip(whole, chunked))
    assert max(shares.values()) <= 1.0
    if "tile" in NAMED[family]:
        tile, _ = _launch(emu, tmp_path, family, 5, 17, 2, 1, paths=150, steps=7, layout=2)
        assert all(torch.equal(x, y) for x, y in zip(whole, tile))


# ---- the GBM kernels (#3 and #2): csrc/gbm_narrow.cu ------------------------------------

GBM_MODES = {"buy-hold": 0, "rebalanced": 1, "hedged": 2}
GBM_DRAWS = {"poly": 0, "poly_fast": 1, "t": 2}


@pytest.mark.parametrize("mode, score, w, layout", [
    ("buy-hold", "float32", 1, "solo"), ("buy-hold", "float32", 22, "solo"),
    ("buy-hold", "float32", 23, "split"), ("buy-hold", "float32", 256, "split"),
    ("rebalanced", "float32", 23, "solo"), ("rebalanced", "float32", 24, "split"),
    ("hedged", "float32", 14, "solo"), ("hedged", "float32", 15, "split"),
    ("buy-hold", "bfloat16", 1, "split"), ("hedged", "tensorfloat32", 256, "split")])
def test_gbm_plan_picks_the_layout_by_w_mode_and_tier(mode, score, w, layout):
    """The GBM kernel's switches at 15 assets: solo to 22 candidates (23
    rebalanced, 14 hedged) in the float32 tier, split past them and in every
    reduced-precision tier, and solo in every tier and by any name with no
    steps; the tile (multi_dd.cu's, which the split layout beat at every W)
    is no layout of theirs."""
    legs = 2 if mode == "hedged" else 0
    p = M.gbm_narrow_plan(15, w, 252, 131_072, 1, legs, rebalance=mode == "rebalanced",
                          score_dtype=score)
    assert p.layout == layout
    if layout == "split":
        assert p.threads == (64, 256) and p.paths == (64, 4 * N.score_groups(w))
        assert p.scratch_floats == 131_072 * 252 * 15 and p.chunk == 131_072
    with pytest.raises(ValueError, match="has no 'tile' layout"):
        M.gbm_narrow_plan(15, w, 252, 131_072, 1, legs, layout="tile", score_dtype=score)
    for name in (None, "split"):
        zero = M.gbm_narrow_plan(15, w, 0, 131_072, 1, legs, name, score_dtype=score)
        assert (zero.layout, zero.scratch_floats) == ("solo", 0)


def test_gbm_plan_is_the_kernels_layout(emu, tmp_path):
    """``gbm_narrow_plan`` against ``gbm_layout``, ``GbmRecurLayout``,
    ``gbm_score_floats`` and ``score_groups`` compiled from
    ``csrc/gbm_narrow.cu`` (every A <= 16, W <= 256, score tier, and mode:
    unhedged buy-and-hold and rebalanced, hedged with 1-4 legs); the solo
    layout is the float32 tier's only."""
    out = tmp_path / "gbm_layout.bin"
    subprocess.run([str(emu["GBM"]), "layout", str(out)], check=True, timeout=60)
    rows = np.fromfile(out, np.int32).reshape(-1, 10)
    assert len(rows) == 16 * 256 * 3 * (2 + 4)
    names = {0: "solo", 1: "split"}
    scores = {v: k for k, v in M.SCORE_DTYPES.items()}
    for a, w, legs, s, mode, layout, own, rets, score, groups in rows.tolist():
        kw = dict(rebalance=mode == 1, score_dtype=scores[s])
        assert M.gbm_narrow_plan(a, w, 5, 100, 1, legs, **kw).layout == names[layout], (a, w)
        split = M.gbm_narrow_plan(a, w, 5, 100, 1, legs, layout="split", **kw)
        assert split.shared_bytes == (4 * rets, 4 * score) and split.paths[1] == 4 * groups
        if s == 0 and 4 * own <= SMEM:
            assert M.gbm_narrow_plan(a, w, 5, 100, 1, legs, layout="solo",
                                     **kw).shared_bytes == (4 * own,)
        elif s:
            with pytest.raises(ValueError, match="float32 tier only"):
                M.gbm_narrow_plan(a, w, 5, 100, 1, legs, layout="solo", **kw)


def _gbm_run(emu, tmp_path, build, a, w, legs, code, paths=70, steps=5, n_blocks=2,
             layout=-1, scratch=None):
    """One emulated GBM launch (seed 11, blocks 7 ..) with CASE ``code``
    (tools/cuda_emu/gbm_main.inc: draw tier, mode, score tier, full factor)
    → (outputs, inputs): #3's (term, dd) or, at ``w`` 0, #2's (terminal
    logS, port, dd); the inputs (L, m, weights, hedge or None)."""
    out = tmp_path / f"{build}_a{a}_w{w}_l{legs}_{code}_{layout}_{scratch}_{steps}.bin"
    args = [str(emu[build]), str(a), str(paths), str(steps), str(n_blocks), str(w),
            str(legs), str(layout), code, str(out)] + ([str(scratch)] if scratch else [])
    subprocess.run(args, check=True, timeout=120)
    y = torch.from_numpy(np.fromfile(out, np.float32))
    if w:
        k = tuple(y.reshape(2, n_blocks, w, paths))
    else:
        n = n_blocks * paths
        k = (y[:n * a].reshape(n_blocks, paths, a), y[n * a:n * (a + 1)].reshape(n_blocks, paths),
             y[n * (a + 1):].reshape(n_blocks, paths))
    x = torch.from_numpy(np.fromfile(str(out) + ".in", np.float32))
    chol, mean = x[:a * a].reshape(a, a), x[a * a:a * a + a]
    n_w = max(w, 1)
    weights = x[a * a + a:a * a + a + n_w * a].reshape(n_w, a)
    hedge = None
    if legs:
        h = x[a * a + a + n_w * a:].numpy()
        s0, ty, strike, prem, qty = np.split(h, np.cumsum([a] + 3 * [a * legs]))
        f = lambda v: torch.from_numpy(np.ascontiguousarray(v))  # noqa: E731
        hedge = HedgeTensors(f(s0), f(ty.reshape(a, legs)).to(torch.int32),
                             f(strike.reshape(a, legs)), f(prem.reshape(a, legs)),
                             f(qty.reshape(a, legs)))
    return k, (chol, mean, weights, hedge)


def _code(draw="poly", mode="buy-hold", score="float32", full=False) -> str:
    return f"{GBM_DRAWS[draw]}{GBM_MODES[mode]}{M.SCORE_DTYPES[score]}{int(full)}"


@pytest.mark.parametrize("a", [1, 16])
@pytest.mark.parametrize("w", [1, 13, 256])
@pytest.mark.parametrize("mode", ["buy-hold", "rebalanced", "hedged"])
def test_gbm_source_matches_plain_form(emu, tmp_path, a, w, mode):
    """The GBM source in the layout W picks (float32) against the plain form
    within ``multi_dd_shares`` (hedged, two legs per asset of every type,
    path by path within the price bound), and every layout by name (solo,
    split) bit for bit with multi_dd.cu's tile kernel, the oracle."""
    legs = 2 if mode == "hedged" else 0
    code = _code(mode=mode)
    k, (chol, mean, weights, hedge) = _gbm_run(emu, tmp_path, "GBM", a, w, legs, code)
    kw = dict(first_block=6, n_blocks=2, rebalance=mode == "rebalanced", hedge=hedge,
              with_bound=hedge is not None)
    p = M.multi_dd_reference(11, mean, chol, weights, 70, 5, **kw)
    shares = M.multi_dd_shares(k, p, p, chol, mean, 5, mode == "rebalanced", "float32", hedge)
    assert max(shares.values()) <= 1.0, shares
    tile, _ = _gbm_run(emu, tmp_path, "GBM_TILE", a, w, legs, code)
    assert all(torch.equal(x, y) for x, y in zip(k, tile))
    other = 1 if M.gbm_narrow_plan(a, w, 5, 70, 2, legs).layout == "solo" else 0
    got, _ = _gbm_run(emu, tmp_path, "GBM", a, w, legs, code, layout=other)
    assert all(torch.equal(x, y) for x, y in zip(got, tile)), other


@pytest.mark.parametrize("mode", ["buy-hold", "rebalanced", "hedged"])
@pytest.mark.parametrize("score", ["tensorfloat32", "bfloat16"])
@pytest.mark.parametrize("w", [3, 256])
def test_gbm_source_score_tiers(emu, tmp_path, mode, score, w):
    """The split layout in the reduced-precision score tiers (the solo layout
    takes float32 only) bit for bit with the tile kernel, and within
    ``multi_dd_shares`` of the plain form in that tier (bfloat16 in
    aggregate; the buy-and-hold terminal, float32 in every tier,
    elementwise)."""
    legs = 2 if mode == "hedged" else 0
    code = _code(mode=mode, score=score)
    k, (chol, mean, weights, hedge) = _gbm_run(emu, tmp_path, "GBM", 7, w, legs, code,
                                               paths=37)
    tile, _ = _gbm_run(emu, tmp_path, "GBM_TILE", 7, w, legs, code, paths=37)
    assert all(torch.equal(x, y) for x, y in zip(k, tile))
    kw = dict(first_block=6, n_blocks=2, rebalance=mode == "rebalanced", hedge=hedge,
              with_bound=hedge is not None)
    p = M.multi_dd_reference(11, mean, chol, weights, 37, 5, score_dtype=score, **kw)
    p32 = M.multi_dd_reference(11, mean, chol, weights, 37, 5, **kw)
    shares = M.multi_dd_shares(k, p, p32, chol, mean, 5, mode == "rebalanced", score, hedge)
    assert max(shares.values()) <= 1.0, shares


@pytest.mark.parametrize("mode", ["buy-hold", "rebalanced", "hedged"])
@pytest.mark.parametrize("score", ["float32", "tensorfloat32", "bfloat16"])
def test_gbm_source_zero_steps(emu, tmp_path, mode, score):
    """With no steps every layout, by W and by name, runs the solo recursion
    in every score tier: bit for bit with the tile kernel, the terminal
    ``sum(w) - 1`` in float32 buy-and-hold (mcport's FP32 score of the start)
    and 0 otherwise, the drawdown 0; 256 candidates, where steps would split."""
    legs = 2 if mode == "hedged" else 0
    code = _code(mode=mode, score=score)
    tile, (_, _, weights, _) = _gbm_run(emu, tmp_path, "GBM_TILE", 7, 256, legs, code, steps=0)
    for layout in (-1, 0, 1):
        got, _ = _gbm_run(emu, tmp_path, "GBM", 7, 256, legs, code, layout=layout, steps=0)
        assert all(torch.equal(x, y) for x, y in zip(got, tile)), layout
    want = torch.zeros(256)
    if mode == "buy-hold":
        for a in range(7):
            want = torch.addcmul(want, weights[:, a], torch.ones(256))
        want = want - 1.0
    assert torch.equal(tile[0], want[None, :, None].expand(2, 256, 70))
    assert not tile[1].any()


@pytest.mark.parametrize("draw", ["poly_fast", "t"])
@pytest.mark.parametrize("full", [False, True])
def test_gbm_source_draw_tiers_and_factors(emu, tmp_path, draw, full):
    """The other draw tiers (Student-t: two steps per Philox call) and a
    factor with terms above its diagonal: the source against the plain form
    on the same factor, buy-and-hold and hedged, solo and split bit for bit
    with the tile. The triangle guard: with those terms left out, the
    outputs leave the bound."""
    t_df = 5.5 if draw == "t" else None
    bm = "poly" if draw == "t" else draw
    for mode, w in (("buy-hold", 5), ("hedged", 13)):
        legs = 2 if mode == "hedged" else 0
        code = _code(draw, mode, full=full)
        k, (chol, mean, weights, hedge) = _gbm_run(emu, tmp_path, "GBM", 7, w, legs, code,
                                                   steps=9)
        tile, _ = _gbm_run(emu, tmp_path, "GBM_TILE", 7, w, legs, code, steps=9)
        for layout in (0, 1):
            got, _ = _gbm_run(emu, tmp_path, "GBM", 7, w, legs, code, layout=layout, steps=9)
            assert all(torch.equal(x, y) for x, y in zip(got, tile)), layout
        kw = dict(first_block=6, n_blocks=2, bm=bm, t_df=t_df, hedge=hedge,
                  with_bound=hedge is not None)
        p = M.multi_dd_reference(11, mean, chol, weights, 70, 9, **kw)
        shares = M.multi_dd_shares(k, p, p, chol, mean, 9, False, "float32", hedge)
        assert max(shares.values()) <= 1.0, shares
        assert bool(torch.triu(chol, 1).any()) == full
        if full and mode == "buy-hold":   # the upper terms matter to the plain form
            lower = M.multi_dd_reference(11, mean, torch.tril(chol), weights, 70, 9, **kw)
            cut = M.multi_dd_shares(k, lower, lower, chol, mean, 9, False, "float32")
            assert max(cut.values()) > 1.0, cut


@pytest.mark.parametrize("a", [1, 7, 16])
@pytest.mark.parametrize("draw", ["poly", "t"])
@pytest.mark.parametrize("rebalance", [False, True])
def test_gbm_path_stats_source(emu, tmp_path, a, draw, rebalance):
    """The path-stats kernel up to 16 assets (csrc/path_stats.cu, the lower
    triangle of L) bit for bit with #3 at one candidate (port, dd) and
    within ``path_stats_shares`` of the plain form (terminal logS, port,
    dd); 0 and 5 steps, a Cholesky factor and one with terms above its
    diagonal."""
    mode = "rebalanced" if rebalance else "buy-hold"
    t_df = 5.5 if draw == "t" else None
    for steps, full in ((5, False), (5, True), (0, False)):
        code = _code(draw, mode, full=full)
        k, (chol, mean, weights, _) = _gbm_run(emu, tmp_path, "GBM_STATS", a, 0, 0, code,
                                               paths=130, steps=steps)
        one, _ = _gbm_run(emu, tmp_path, "GBM", a, 1, 0, code, paths=130, steps=steps)
        assert torch.equal(one[0][:, 0], k[1]) and torch.equal(one[1][:, 0], k[2])
        p = PS.path_stats_reference(11, mean, chol, weights[0], 130, steps, first_block=6,
                                    n_blocks=2, rebalance=rebalance, t_df=t_df)
        shares = PS.path_stats_shares(k, p, chol, mean, steps)
        assert max(shares.values()) <= 1.0, shares


def test_gbm_split_source_chunks_its_scratch(emu, tmp_path):
    """Through a scratch that holds one recursion block's paths of the 150,
    the split layout gives the whole launch's outputs bit for bit, in each
    mode."""
    for mode in GBM_MODES:
        legs = 2 if mode == "hedged" else 0
        code = _code(mode=mode)
        whole, _ = _gbm_run(emu, tmp_path, "GBM", 5, 17, legs, code, paths=150, steps=7,
                            layout=1)
        chunked, _ = _gbm_run(emu, tmp_path, "GBM", 5, 17, legs, code, paths=150, steps=7,
                              layout=1, scratch=2 * 7 * 5 * 64)
        assert all(torch.equal(x, y) for x, y in zip(whole, chunked)), mode
