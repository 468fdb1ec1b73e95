"""Philox4x32-10 in plain torch (mcport_torch.rng): Random123 known-answer
vectors, the 16-bit-limb products, broadcasting, and the uint32 → (0, 1]
uniform map (exact in float32, so the kernel and the plain form agree bit for
bit)."""

import numpy as np
import pytest
import torch

from mcport_torch.rng import _mulhilo, bits_to_unit, philox4x32

torch.set_num_threads(1)   # the suite runs several xdist workers on shared cores


@pytest.mark.parametrize("ctr, key, want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's kat_vectors for philox4x32_10 (exact)."""
    got = philox4x32([torch.tensor(c) for c in ctr], key)
    assert tuple(int(w) for w in got) == want


def test_mulhilo_matches_python_integers():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 10_000, dtype=np.uint64).astype(np.int64)
    x[:3] = [0, 1, 2**32 - 1]
    for m in (0xD2511F53, 0xCD9E8D57):
        lo, hi = _mulhilo(m, torch.from_numpy(x))
        full = [m * int(v) for v in x]
        assert lo.tolist() == [f & 0xFFFFFFFF for f in full]
        assert hi.tolist() == [f >> 32 for f in full]


def test_philox_broadcast_equals_elementwise():
    """Broadcast counters (the plain sampler's layout) give the same words as
    one call per counter, with a per-block key tensor."""
    keys = torch.tensor([7, 0xFFFFFFF0], dtype=torch.int64).view(-1, 1, 1)
    asset = torch.arange(3).view(1, 1, -1)
    path = torch.arange(4).view(1, -1, 1)
    words = philox4x32((5, asset, path, 0), (keys, 0))
    assert all(w.shape == (2, 4, 3) for w in words)
    for b, k in enumerate((7, 0xFFFFFFF0)):
        for p in range(4):
            for a in range(3):
                one = philox4x32((5, a, p, 0), (k, 0))
                assert tuple(int(w[b, p, a]) for w in words) == tuple(int(o) for o in one)


def test_bits_to_unit_range_and_exactness():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2**32, 100_000, dtype=np.uint64).astype(np.int64)
    bits[:4] = [0, 2**32 - 1, 511, 512]
    u = bits_to_unit(torch.from_numpy(bits))
    assert u.dtype == torch.float32
    want = 1.0 - (bits >> 9).astype(np.float64) * 2.0**-23      # exact in f64
    np.testing.assert_array_equal(u.numpy().astype(np.float64), want)
    assert float(u.min()) >= 2.0**-23 and float(u.max()) <= 1.0
    assert u[0] == 1.0 and u[1] == 2.0**-23 and u[2] == 1.0 and u[3] == 1.0 - 2.0**-23
