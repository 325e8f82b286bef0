"""The exact replacements that the CUDA coders' steps rest on, proved here
at every precision the formats allow.

- The bit decoder (csrc/bin_decode.cu) tests ``code - low >= r * split`` in
  place of ``min((code - low) // r, 2^dbits - 1) >= split``, with
  ``r = rng >> dbits``.  That needs r >= 1, so rng >= 2^16 >= 2^dbits
  after every renormalisation: checked through the port's own plain coder
  step (``bin_coder._code``) on adversarial and random states.
- The compare itself, for every dbits in 1..16, at the boundary values
  of ``d = code - low`` and random ones.
- The ari encoder (csrc/ari_encode.cu) takes ``rng // tot`` as
  ``umulhi(rng, inv)`` plus one correction, ``inv = (2^32-1) // tot``:
  exact for every tot in [1, 2^16] at ``rng = k*tot - 1``, ``k*tot`` and
  ``2^32 - 1``.
- The bit decoder leaves out two clamps of the APM gate that cannot bind:
  the interpolation of two cells in [1, 4095] stays between them, and a
  cell's update at rate 5 stays in [1, 4095].

All in int64 or uint64 numpy, exact (the tolerance is 0)."""

import numpy as np
import pytest
import torch

from tpuzip_torch.kernels import bin_coder

U32 = (1 << 32) - 1
DBITS = range(1, 17)


def _states(rng, dbits: int):
    """(low, rng, bit, split) int64 arrays: a grid of adversarial values
    (rng at 2^16 and the top of u32, low around the 2^16 and 2^24
    boundaries where the forced renormalisation starts, the extreme
    splits) crossed with both bits, then random ones."""
    denom = 1 << dbits
    lows = [0, 1, 0xFFFF, 0x10000, 0xFEFFFF, 0xFF0001, 0xFFFFFF, 0x1000000,
            0x7FFFFFFF, 0xFFFF0000, 0xFFFFFF00, U32]
    lows += [(k << 24) - d for k in (1, 2, 255) for d in (1, 0x100, 0xFFFF)]
    rngs = [1 << 16, (1 << 16) + 1, 0x1FFFF, 1 << 24, (1 << 24) - 1,
            1 << 31, U32 - 1, U32]
    splits = sorted({1, max(1, denom // 2), denom - 1})
    grid = np.array(np.meshgrid(lows, rngs, (0, 1), splits)).reshape(4, -1)
    n = 20000
    rand = np.stack([
        rng.integers(0, 1 << 32, n, dtype=np.int64),
        rng.integers(1 << 16, 1 << 32, n, dtype=np.int64),
        rng.integers(0, 2, n, dtype=np.int64),
        rng.integers(1, denom, n, dtype=np.int64) if dbits > 1
        else np.ones(n, np.int64)])
    return np.concatenate([grid.astype(np.int64), rand], 1)


@pytest.mark.parametrize("dbits", DBITS)
def test_range_stays_at_least_2_16_after_renormalisation(rng, dbits):
    low, rg, bit, split = _states(rng, dbits)
    m = bin_coder._Model(low.size, dbits, 5, False, "cpu")
    assert int(m.denom_bits[0]) == dbits
    _, rng_out, count, _ = bin_coder._code(
        torch.from_numpy(low), torch.from_numpy(rg),
        torch.from_numpy(bit.astype(bool)), torch.from_numpy(split), m)
    assert int(rng_out.min()) >= 1 << 16
    assert int(rng_out.max()) <= U32
    assert int(count.max()) <= 4
    # and r = rng >> dbits >= 1 before every split
    assert int((torch.from_numpy(rg) >> dbits).min()) >= 1


@pytest.mark.parametrize("dbits", DBITS)
def test_compare_replaces_the_division(rng, dbits):
    denom = 1 << dbits
    _, rg, _, split = _states(rng, dbits)
    r = rg >> dbits
    rs = r * split
    assert int(rs.max()) < 1 << 32 and bool((rs < rg).all())
    for d in (rs - 1, rs, rs + 1, np.full_like(rs, U32), np.zeros_like(rs),
              rng.integers(0, 1 << 32, rs.size, dtype=np.int64)):
        d = np.clip(d, 0, U32)
        v = np.minimum(d // r, denom - 1)
        np.testing.assert_array_equal(v >= split, d >= rs)


@pytest.mark.parametrize("part", range(8))
def test_encoder_quotient_by_reciprocal(rng, part):
    tot = np.arange(1 + part * 8192, 1 + (part + 1) * 8192, dtype=np.uint64)
    inv = np.uint64(U32) // tot
    kmax = np.uint64(U32) // tot
    ks = [np.ones_like(tot), np.full_like(tot, 2), kmax, kmax - 1,
          (rng.random(tot.size) * kmax.astype(np.float64)).astype(np.uint64)
          + 1]
    values = [np.full_like(tot, U32)]
    for k in ks:
        k = np.clip(k, 1, kmax)
        values += [k * tot - 1, k * tot]
    values.append(rng.integers(0, 1 << 32, tot.size, dtype=np.uint64))
    for n in values:
        q = (n * inv) >> np.uint64(32)
        q = q + (n - q * tot >= tot)
        np.testing.assert_array_equal(q, n // tot)


@pytest.mark.parametrize("part", range(4))
def test_apm_interpolation_needs_no_clamp(rng, part):
    """bin_decode.cu's split: (a*(4096-frac) + b*frac) >> 12 equals
    a + (((b-a)*frac) >> 12) and lies between a and b, so the clamp to
    [1, 4095] never binds for cells in [1, 4095]."""
    edges = np.array([1, 2, 31, 32, 2047, 2048, 4064, 4094, 4095])
    a, b = np.meshgrid(edges, edges)
    a, b = a.ravel(), b.ravel()
    frac = np.arange(part * 1024, (part + 1) * 1024)
    grid_a = np.repeat(a, frac.size)
    grid_b = np.repeat(b, frac.size)
    grid_f = np.tile(frac, a.size)
    n = 200000
    ra = rng.integers(1, 4096, n)
    rb = rng.integers(1, 4096, n)
    rf = rng.integers(0, 4096, n)
    for a, b, f in ((grid_a, grid_b, grid_f), (ra, rb, rf)):
        p = (a * (4096 - f) + b * f) >> 12
        np.testing.assert_array_equal(p, a + (((b - a) * f) >> 12))
        assert bool((p >= np.minimum(a, b)).all())
        assert bool((p <= np.maximum(a, b)).all())
        np.testing.assert_array_equal(p, np.clip(p, 1, 4095))


@pytest.mark.parametrize("bit", [0, 1])
def test_apm_cell_update_needs_no_clamp(bit):
    """Every cell in [1, 4095] adapted at rate 5 stays in [1, 4095]."""
    c = np.arange(1, 4096)
    new = c - (c >> 5) if bit else c + ((4096 - c) >> 5)
    np.testing.assert_array_equal(new, np.clip(new, 1, 4095))
    torch_new = bin_coder._bin_update(torch.from_numpy(c),
                                      torch.tensor(bool(bit)), 4096, 5)
    np.testing.assert_array_equal(torch_new.numpy(), new)
