"""The keyed step that csrc/dc_decode.cu rests on, proved on the CPU: a
PyTorch replica of the kernel's walk, held exact (tolerance 0) on all four
outputs against the port's plain walk (``dc_decode_lanes_plain``) and
through it against tpuzip's Pallas kernel in interpret mode.

Each of the 32 lanes keeps eight scheduler entries; a symbol with no run
to come holds the walk's length.  While the length is below 2^23 and no
entry below -2^23, an entry is position << 8 | symbol and a lane keeps its
eight in ascending order.  The keyed step takes a lane's key as its second
entry if its first is at pos, else its first; the least key is the next
run's head with its symbol; the head's lane drops its first entry and
merges the target (or the length) in.  A run's start, symbol, length and
err come once a group of 32 runs, from the heads the lanes kept.  That is
exact while the head is the one entry at pos and no entry is below it.  A
group that starts off its head, or in which a lane broke that, is run
again from its start by the exact step (every entry compared, every hit
rescheduled, on the unpacked entries), then the lane is sorted again by
the kernel's 19-comparator network.  A walk that does not fit the packing
takes the exact step throughout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_dc import _batch, _cases, _corrupt_inputs
from tpuzip.kernels import dc_scan as jscan
from tpuzip_torch.codecs import dc
from tpuzip_torch.kernels import dc_scan

GROUP = 32
SPAN = 1 << 23
INT_MIN = -(1 << 31)
NET = ((0, 2), (1, 3), (4, 6), (5, 7), (0, 4), (1, 5), (2, 6), (3, 7),
       (0, 1), (2, 3), (4, 5), (6, 7), (2, 4), (3, 5), (1, 4), (3, 6),
       (1, 2), (3, 4), (5, 6))


def _sort8(p):
    """The kernel's sorting network on (..., 8) packed entries."""
    p = p.clone()
    for i, j in NET:
        lo = torch.minimum(p[..., i], p[..., j])
        p[..., j] = torch.maximum(p[..., i], p[..., j])
        p[..., i] = lo
    return p


def _limit(d, length):
    return torch.where(d > 0, length - (d - 1), INT_MIN)


def _merge(p, x):
    """Drop each lane's first entry and merge x (B, 32) in; x = p[0] gives
    the lane back."""
    q = torch.maximum(p, torch.minimum(torch.cat([p[..., 1:], p[..., -1:]],
                                                 -1), x[..., None]))
    q[..., 0] = torch.minimum(p[..., 1], x)
    q[..., 7] = torch.maximum(p[..., 7], x)
    return q


def _exact_step(state, d, length):
    """The TPU kernel's step on unpacked entries (s, y) in any order:
    returns the state after it and the step's (start, len, sym)."""
    s, y, pos, err = state
    active = pos < length
    hit = s == pos[:, None, None]
    nxt = torch.where(hit, length[:, None, None], s).amin((1, 2))
    sym = torch.where(hit, y, 0).sum((1, 2))
    ok = nxt < _limit(d, length)
    put = torch.where(ok, nxt + d - 1, length)
    s = torch.where(active[:, None, None] & hit, put[:, None, None], s)
    out = torch.where(active, torch.stack([pos, dc_scan.wrap32(nxt - pos),
                                           sym]), 0)
    err = err | (active & (~hit.any((1, 2)) | ((d > 0) & ~ok)))
    return (s, y, torch.where(active, nxt, pos), err), out


def _keyed_group(state, d, length):
    """A group's keyed steps on the packed state (d: (B, steps)): the state
    after it, its (3, B, steps) triples, and the rows where it was not
    exact."""
    s, y, pos, err = state
    p = _sort8(s * 256 + y)
    head, L8 = p[..., 0].amin(1), length * 256
    lim = _limit(d, length[:, None])
    lim8 = torch.where(lim > -SPAN, lim * 256, INT_MIN)
    d8 = (d - 1) * 256
    odd = (head & ~255) != pos * 256      # the head is not at pos
    heads = []
    for j in range(d.shape[1]):
        h, phi = head[:, None], (head | 255)[:, None]
        hit = p[..., 0] == h
        key = torch.where(hit, p[..., 1], p[..., 0])
        odd |= ((head & ~255) < L8) & (((p[..., 0] <= phi) & ~hit)
                                       | (p[..., 1] <= phi)).any(1)
        sym0 = p[..., 0] & 255
        kept = torch.where(hit, L8[:, None] | sym0, p[..., 0])
        r = key.amin(1)
        moved = ((r & ~255) + d8[:, j])[:, None] + sym0
        p = _merge(p, torch.where(hit & (r < lim8[:, j])[:, None], moved,
                                  kept))
        heads.append(head)
        head = r
    o_h = torch.stack(heads, 1)
    nxt = torch.cat([o_h[:, 1:], head[:, None]], 1) & ~255
    active = o_h < L8[:, None]
    out = torch.where(active, torch.stack([o_h >> 8, (nxt - (o_h & ~255)) >> 8,
                                           o_h & 255]), 0)
    bad = active & (d > 0) & (nxt >= lim8)
    state = (p >> 8, p & 255, head >> 8, err | bad.any(1))
    return state, out, odd


def _rows(mask, like):
    """A (B,) row mask shaped to broadcast against `like`."""
    return mask.view((-1,) + (1,) * (like.dim() - 1))


def keyed_walk(vals, first, lengths):
    """The kernel's walk: vals (B, T), first (B, 256), lengths (B,) int32
    -> (starts, run_lens, syms (B, T), err (B,) int32, whether each row
    was packed, the (row, group) pairs run again by the exact step)."""
    b, t = vals.shape
    length = lengths.to(torch.int64)
    f = first.to(torch.int64)
    s = torch.where(f < length[:, None], f, length[:, None]).reshape(b, 32, 8)
    y = torch.arange(256).repeat(b, 1).reshape(b, 32, 8)
    packed = (0 < length) & (length < SPAN) & (s.amin((1, 2)) >= -SPAN)
    state = (s, y, torch.zeros(b, dtype=torch.int64),
             torch.zeros(b, dtype=torch.bool))
    out = torch.zeros((3, b, t), dtype=torch.int64)
    d_all = vals.to(torch.int64)
    redone = []
    for t0 in range(0, t, GROUP):
        d = d_all[:, t0:t0 + GROUP]
        go = state[2] < length     # the walk goes on: the group runs
        keyed, part, odd = _keyed_group(state, d, length)
        exact = ~packed | odd
        if bool((go & exact).any()):
            ex, eparts = state, []
            for j in range(d.shape[1]):
                ex, o = _exact_step(ex, d[:, j], length)
                eparts.append(o)
            keyed = tuple(torch.where(_rows(exact, k), e, k)
                          for k, e in zip(keyed, ex))
            part = torch.where(exact[None, :, None],
                               torch.stack(eparts, 2), part)
            redone += [(int(r), t0 // GROUP)
                       for r in (go & packed & odd).nonzero()[:, 0]]
        state = tuple(torch.where(_rows(go, old), new, old)
                      for new, old in zip(keyed, state))
        out[:, :, t0:t0 + GROUP] = torch.where(go[None, :, None], part, 0)
    err = state[3] | (state[2] < length)
    out = out.to(torch.int32)
    return (out[0], out[1], out[2], err.to(torch.int32), packed.tolist(),
            redone)


@pytest.fixture(autouse=True)
def one_thread():
    """The replica runs thousands of small tensor steps: one intra-op
    thread each, so that a worker beside other test workers does not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _encoded(rows):
    blocks, lens = _batch(rows)
    comp, clens = dc.encode_batch(torch.from_numpy(blocks),
                                  torch.from_numpy(lens))
    return comp[:, : int(clens.max())].contiguous(), clens, blocks.shape[1]


def _built(rng, kind):
    """Schedulers made to put two or more entries on one position, on rows
    of lengths 350, 400, 300, 0, -5 and 0x7FFFFFFF.  Within a lane
    (lane_dups): symbols 16, 17, 18 (lane 2) and 40, 47 (lane 5) share a
    head, and random distances reschedule onto taken positions.  Across
    lanes only (cross_lane_dups): symbols 0, 8, 200 and 3, 131 share a
    head, every other head is distinct, and every distance is 0 (no symbol
    comes back).  Past the packing (wide): lengths of 2^23 and more, and
    first entries below -2^23, with random distances."""
    b, t = 6, 512
    first = np.stack([12 + rng.permutation(400)[:256] for _ in range(b)])
    length = np.array([350, 400, 300, 0, -5, 0x7FFFFFFF])
    vals = rng.integers(-2, 40, (b, t))
    if kind == "lane_dups":
        first[:, [16, 17, 18]] = 3
        first[:, [40, 47]] = 11
    elif kind == "cross_lane_dups":
        first[:, [0, 8, 200]] = 3
        first[:, [3, 131]] = 11
        vals[:] = 0
    else:
        length = np.array([SPAN, SPAN + 77, SPAN - 1, 500, 500, 400])
        first[3, 9] = -SPAN - 1
        first[4, 100] = INT_MIN
        first[5, 7] = -SPAN          # still packed
    return (torch.from_numpy(vals.astype(np.int32)),
            torch.from_numpy(first.astype(np.int32)),
            torch.from_numpy(length.astype(np.int32)))


def _inputs(kind):
    rng = np.random.default_rng(23)
    if kind in ("cases", "clobbered_header", "flipped_varint"):
        comp, clens, n = _encoded(_cases(np.random.default_rng(11)))
        if kind == "clobbered_header":    # first[0] reads as -1
            comp[:, 4:8] = 0xFF
        elif kind == "flipped_varint":    # a continuation bit flipped
            comp[:, dc.HDR + 1] ^= 0x80
        return dc.decode_inputs(comp, clens, n)
    if kind == "corrupt":
        rows, lens, n = _corrupt_inputs()
        return dc.decode_inputs(torch.from_numpy(rows),
                                torch.from_numpy(lens), n)
    if kind == "random_vals":
        comp, clens, n = _encoded(_cases(np.random.default_rng(11))[2:6])
        vals, first, length = dc.decode_inputs(comp, clens, n)
        noise = torch.from_numpy(rng.integers(-3, 3000, vals.shape,
                                              dtype=np.int32))
        return noise, first, length
    return _built(rng, kind)


def _interpret(vals, first, length):
    """tpuzip's Pallas kernel in interpret mode, lanes padded to 128, back
    in the port's (B, T) layout.  T is a multiple of its 256-step grid: a
    walk that padding steps would go on with is not the same walk."""
    b, t = vals.shape
    assert t % jscan.CHUNK == 0
    vt = np.zeros((t, 128), np.int32)
    vt[:t, :b] = vals.numpy().T
    ft = np.zeros((256, 128), np.int32)
    ft[:, :b] = first.numpy().T
    lt = np.zeros(128, np.int32)
    lt[:b] = length.numpy()
    exp = jscan.dc_decode_lanes(jnp.array(vt), jnp.array(ft), jnp.array(lt),
                                interpret=True)
    return ([np.asarray(e)[:t, :b].T for e in exp[:3]]
            + [np.asarray(exp[3]).reshape(-1)[:b]])


@pytest.mark.parametrize("kind", [
    "cases", "clobbered_header", "flipped_varint", "corrupt", "random_vals",
    "lane_dups", "cross_lane_dups", "wide"])
def test_keyed_walk_matches_plain_and_pallas(kind):
    vals, first, length = _inputs(kind)
    assert vals.shape[1] <= 2048
    *got, packed, redone = keyed_walk(vals, first, length)
    plain = dc_scan.dc_decode_lanes_plain(vals, first, length)
    for g, p in zip(got, plain):
        assert torch.equal(g, p), kind
    # the plain walk on the corrupt rows is held against the Pallas kernel
    # in test_torch_dc.py
    if kind in ("cases", "lane_dups", "cross_lane_dups", "wide"):
        for g, e in zip(got, _interpret(vals, first, length)):
            np.testing.assert_array_equal(g.numpy(), e)
    # the exact step runs where the keyed one cannot, and only there
    if kind != "wide":
        assert packed == ((length > 0) & (length < SPAN)).tolist()
    if kind == "cases":
        assert redone == []
    if kind == "lane_dups":
        assert {r for r, _ in redone} == {0, 1, 2}
    if kind == "cross_lane_dups":   # heads shared across lanes: group 0
        assert redone == [(r, 0) for r in range(3)]
        assert (got[2] == 0 + 8 + 200).any() and (got[2] == 3 + 131).any()
    if kind == "clobbered_header":   # first[0] = -1 < pos at step 0
        assert {r for r, g in redone if g == 0} == set(
            torch.nonzero(length > 0)[:, 0].tolist())
    if kind == "wide":
        assert packed == [False, False, True, False, False, True]


def test_sorting_network_sorts_every_zero_one_input():
    """The 0-1 principle: a comparator network that sorts every 0/1 input
    of 8 sorts every input of 8."""
    bits = torch.tensor([[(m >> i) & 1 for i in range(8)]
                         for m in range(256)])
    assert torch.equal(_sort8(bits), bits.sort(-1).values)


def test_merge_drops_the_first_entry_and_inserts_in_order(rng):
    p = torch.from_numpy(np.sort(rng.integers(-60, 60, (4, 32, 8)), -1))
    assert torch.equal(_merge(p, p[..., 0]), p)   # a lane without a hit
    x = torch.from_numpy(rng.integers(-70, 70, (4, 32)))
    assert torch.equal(_merge(p, x), torch.cat(
        [p[..., 1:], x[..., None]], -1).sort(-1).values)
