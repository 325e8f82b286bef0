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
- The bit encoder (csrc/bin_encode.cu) takes ``r * (2^dbits - split)`` as
  ``(rng & ~(2^dbits - 1)) - r * split``, tests in one branch whether a
  bit emits any byte, runs the renormalisation's passes with no break,
  and leaves out the gate's two clamps: each checked through the plain
  coder step (``bin_coder._code``) and the plain model
  (``bin_coder._Model``).

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


def _renormalise(low, rg):
    """The carryless renormalisation as bin_encode.cu runs it, in int64:
    four passes and no break, since a pass that moves no byte changes
    nothing."""
    low, rg = low.copy(), rg.copy()
    for _ in range(4):
        settled = (low ^ ((low + rg) & U32)) < bin_coder.TOP
        force = (rg < bin_coder.BOT) & ~settled
        rg = np.where(force, (-low) & (bin_coder.BOT - 1), rg)
        shift = settled | force
        low = np.where(shift, (low << 8) & U32, low)
        rg = np.where(shift, (rg << 8) & U32, rg)
    return low, rg


@pytest.mark.parametrize("dbits", DBITS)
def test_encoder_step_equals_the_plain_coder(rng, dbits):
    """bin_encode.cu's products, rs = (rng >> dbits) * split, low += rs and
    rng = (rng & ~(2^dbits - 1)) - rs on a 1, rng = rs on a 0, then a
    renormalisation only where (low ^ (low + rng)) < 2^24 or rng < 2^16:
    the same low, rng and emitted bytes as the plain step."""
    low, rg, bit, split = _states(rng, dbits)
    m = bin_coder._Model(low.size, dbits, 5, False, "cpu")
    exp_low, exp_rng, count, before = (t.numpy() for t in bin_coder._code(
        torch.from_numpy(low), torch.from_numpy(rg),
        torch.from_numpy(bit.astype(bool)), torch.from_numpy(split), m))
    rs = (rg >> dbits) * split
    dmask = U32 & ~((1 << dbits) - 1)
    k_low = np.where(bit == 1, (low + rs) & U32, low)
    k_rng = np.where(bit == 1, (rg & dmask) - rs, rs)
    np.testing.assert_array_equal(k_low, before)
    emits = ((k_low ^ ((k_low + k_rng) & U32)) < bin_coder.TOP) | (
        k_rng < bin_coder.BOT)
    np.testing.assert_array_equal(emits, count > 0)
    assert emits.any() and not emits.all()
    r_low, r_rng = _renormalise(k_low, k_rng)
    np.testing.assert_array_equal(np.where(emits, r_low, k_low), exp_low)
    np.testing.assert_array_equal(np.where(emits, r_rng, k_rng), exp_rng)


@pytest.mark.parametrize("bits", [1, 8, 12, 16])
def test_encoder_gate_equals_the_plain_model(rng, bits):
    """bin_encode.cu's gate: the split a + (((a1 - a) * frac) >> 12) with no
    clamp, the cell it keeps (a1 if frac >= 2048, else a) and that cell's
    update with no clamp give the plain model's split, slot and cells, on
    random gates and every edge of p0."""
    n = 40000
    top = 1 << bits
    p0 = np.concatenate([np.arange(1, min(top, 4096)),
                         [1, top - 1, top // 2, top // 32 * 31],
                         rng.integers(1, top, n) if top > 2
                         else np.ones(n, np.int64)]).clip(1, top - 1)
    n = p0.size
    gate = rng.integers(1, 4096, (n, 33))
    gate[: n // 4] = rng.choice([1, 2, 4094, 4095], (n // 4, 33))
    m = bin_coder._Model(n, bits, 5, True, "cpu")
    m.p0 = torch.from_numpy(p0)
    m.gate = torch.from_numpy(gate)
    exp = m.split().numpy()
    scaled = p0 * 32
    idx = np.minimum(scaled >> 12, 31)
    frac = scaled & 4095
    at = np.arange(n)
    a, a1 = gate[at, idx], gate[at, idx + 1]
    upper = frac >= 2048
    slot = np.where(upper, idx + 1, idx)
    cell = np.where(upper, a1, a)
    np.testing.assert_array_equal(a + (((a1 - a) * frac) >> 12), exp)
    np.testing.assert_array_equal(slot, m.last[:, 0].numpy())
    bit = rng.integers(0, 2, n).astype(bool)
    m.update(torch.from_numpy(bit), torch.ones(n, dtype=torch.bool))
    v = np.where(bit, cell - (cell >> 5), cell + ((4096 - cell) >> 5))
    np.testing.assert_array_equal(m.gate.numpy()[at, slot], v)
