"""tpuzip's device deflate rule (its ``deflate_batch`` / ``deflate``,
tpuzip/codecs/deflate.py, which its compress_from_device writes) against
the port's: the oracle's package-merge copy, a replica of the tuple-order
tables kernel's ranking (csrc/deflate_encode.cu ``tuple_merge``), the
greedy parse against ``lz77_stage``, and the entry points byte for byte,
on the CPU (the port's plain versions; tpuzip's XLA stages on the CPU).
The CUDA kernels are held against those plain versions on the card by
chip_smoke.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuzip
from tpuzip.codecs import deflate as jdef
from tpuzip.core.config import Config
from tpuzip.dist import mesh as meshlib
from tpuzip.dist import runner as jrun
from tpuzip.oracle import deflate as jod
import tpuzip_torch
from tpuzip_torch.codecs import deflate as tdef
from tpuzip_torch.core import blocks as blk
from tpuzip_torch.core.config import config_from_dict
from tpuzip_torch.kernels import deflate_coder as dc
from tpuzip_torch.oracle import deflate as tod

MESH1 = meshlib.make_mesh(1)
N = 4096          # the rows' width: tpuzip's vmapped stages compile a shape
with open(__file__.rsplit("/tests/", 1)[0] + "/SURVEY.md", "rb") as _f:
    TEXT = _f.read()


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for each test here, as in the deflate tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows():
    """7 rows of N bytes and their lengths: text, zeros, random bytes,
    b"ab", a 3,000-byte row, a ramp and an empty row."""
    rng = np.random.default_rng(20)
    rows = [np.frombuffer(TEXT[:N], np.uint8), np.zeros(N, np.uint8),
            rng.integers(0, 256, N, dtype=np.uint8),
            np.resize(np.frombuffer(b"ab", np.uint8), N),
            np.frombuffer(TEXT[N : 2 * N], np.uint8),
            (np.arange(N) % 251).astype(np.uint8),
            np.frombuffer(TEXT[2 * N : 3 * N], np.uint8)]
    lens = np.array([N, N, N, N, 3000, N, 0], np.int32)
    x = np.stack(rows)
    x[np.arange(N)[None, :] >= lens[:, None]] = 0
    return x, lens


def _fib(k):
    out = [1, 1]
    while len(out) < k:
        out.append(out[-1] + out[-2])
    return out[:k]


def _histograms():
    """{name: (freq by symbol, limit)}: tie-stressing histograms of the
    three trees' alphabets and the literal/length and distance histograms
    of the parse of text rows."""
    out = {}
    for nsym, limit in ((286, 15), (30, 15), (19, 7)):
        out[f"equal_{nsym}"] = ([30] * nsym, limit)
        out[f"two_counts_{nsym}"] = ([1 if s % 2 else 50 for s in
                                      range(nsym)], limit)
        out[f"powers_{nsym}"] = ([1 << s % 9 for s in range(nsym)], limit)
        fib = _fib(min(nsym, 24))
        out[f"fibonacci_{nsym}"] = (fib + [0] * (nsym - len(fib)), limit)
        out[f"one_{nsym}"] = ([0] * (nsym - 1) + [5], limit)
        out[f"two_{nsym}"] = ([3] + [0] * (nsym - 2) + [3], limit)
        rng = np.random.default_rng(nsym)
        out[f"small_{nsym}"] = (rng.integers(0, 4, nsym).tolist(), limit)
    x, lens = _rows()
    xt, lt = torch.from_numpy(x[[0, 4]]), torch.from_numpy(lens[[0, 4]])
    tok, nt = dc.deflate_parse_plain(xt, lt, dc.deflate_links_plain(xt, lt),
                                     1, greedy=True)
    for r in range(2):
        lf, df = [0] * 286, [0] * 30
        for t in tok[r, : int(nt[r])].tolist():
            if t < 256:
                lf[t] += 1
            else:
                lf[257 + dc.len_code(t >> 16)] += 1
                df[dc.dist_code(t & 0xFFFF)] += 1
        lf[256] = 1
        out[f"text_{r}_lit"] = (lf, 15)
        out[f"text_{r}_dist"] = (df, 15)
    return out


HISTOGRAMS = _histograms()


def tuple_merge_replica(freq: list, limit: int) -> list:
    """The tables kernel's tuple_merge, step for step: each level's items
    ranked by counting (binary searches over the sorted leaves and the
    packages' non-falling weights, a package's packages below it searched
    only where the package before it has its weight, then the equal-weight
    items compared one by one), its tuples laid out in a pool in rank order, a
    package's tuple a slice of the last level's pool; the lengths counted
    over the last level's first 2n - 2 tuples."""
    act = [(f, s) for s, f in enumerate(freq) if f]
    na = len(act)
    lens = [0] * len(freq)
    if na < 2:
        if na:
            lens[act[0][1]] = 1
        return lens
    lw, ls = [0] * na, [0] * na
    for k, (f, s) in enumerate(act):
        r = sum(g < f or (g == f and j < k) for j, (g, _) in enumerate(act))
        lw[r], ls[r] = f, s
    w, off, pool = list(lw), list(range(na + 1)), list(ls)

    def point(lo, hi, pred):
        while lo < hi:
            mid = (lo + hi) >> 1
            if pred(mid):
                lo = mid + 1
            else:
                hi = mid
        return lo

    def cmp(a0, al, b0, bl):
        for i in range(min(al, bl)):
            if pool[a0 + i] != pool[b0 + i]:
                return -1 if pool[a0 + i] < pool[b0 + i] else 1
        return -1 if al < bl else int(al > bl)

    m = na
    for _ in range(1, limit):
        np_ = m // 2
        mm = na + np_
        pw = [w[2 * j] + w[2 * j + 1] for j in range(np_)]
        nw, nlen, src = [None] * mm, [None] * mm, [None] * mm
        for k in range(mm):
            if k < na:
                wk, s = lw[k], ls[k]
                q = point(0, np_, lambda j: pw[j] < wk)
                r = k + q
                while q < np_ and pw[q] == wk:
                    r += pool[off[2 * q]] < s
                    q += 1
                ln, frm = 1, ("leaf", s)
            else:
                j = k - na
                wk = pw[j]
                a0 = off[2 * j]
                ln = off[2 * j + 2] - a0
                t0 = pool[a0]
                llo = point(0, na, lambda i: lw[i] < wk)
                r = point(llo, na, lambda i: lw[i] == wk and ls[i] <= t0)
                # the packages below it: those before its run of equal
                # weight (the weights do not fall), searched only where the
                # package before it has its weight
                q = j
                if q > 0 and pw[q - 1] == wk:
                    q = point(0, q - 1, lambda i: pw[i] < wk)
                assert q == point(0, np_, lambda i: pw[i] < wk)
                r += q
                while q < np_ and pw[q] == wk:
                    if q != j:
                        b0 = off[2 * q]
                        c = cmp(b0, off[2 * q + 2] - b0, a0, ln)
                        r += c < 0 or (c == 0 and q < j)
                    q += 1
                frm = ("pool", a0)
            assert nw[r] is None, "ranks must be a permutation"
            nw[r], nlen[r], src[r] = wk, ln, frm
        noff = [0]
        for ln in nlen:
            noff.append(noff[-1] + ln)
        npool = []
        for r in range(mm):
            kind, v = src[r]
            npool += [v] if kind == "leaf" else pool[v : v + nlen[r]]
        w, off, pool, m = nw, noff, npool, mm
    for s in pool[: off[min(2 * na - 2, m)]]:
        lens[s] += 1
    return lens


def _oracle(freq, limit):
    got = jod.package_merge({s: f for s, f in enumerate(freq) if f}, limit)
    return [got.get(s, 0) for s in range(len(freq))]


@pytest.mark.parametrize("name", sorted(HISTOGRAMS))
def test_package_merge_copy_and_kernel_replica_equal_oracle(name):
    """The port's package_merge and tuple_package_merge equal tpuzip's
    oracle, and the replica of the kernel's ranking gives its lengths."""
    freq, limit = HISTOGRAMS[name]
    want = _oracle(freq, limit)
    d = {s: f for s, f in enumerate(freq) if f}
    assert tod.package_merge(d, limit) == jod.package_merge(d, limit)
    assert dc.tuple_package_merge(freq, limit) == want
    assert tuple_merge_replica(freq, limit) == want


def test_kernel_replica_on_random_histograms():
    """The replica on 300 random histograms of each alphabet, many with
    repeated counts (where the tuple order decides)."""
    rng = np.random.default_rng(7)
    for nsym, limit in ((286, 15), (30, 15), (19, 7)):
        for k in range(100):
            top = (2, 5, 40, 1000)[k % 4]
            freq = rng.integers(0, top, nsym)
            freq[rng.random(nsym) < 0.3] = 0
            freq = freq.tolist()
            assert tuple_merge_replica(freq, limit) == _oracle(freq, limit)


def test_tuple_order_differs_from_std_sort():
    """The two rules' lengths differ on a text row's histogram (why the
    device rule needs its own tables)."""
    lf, _ = HISTOGRAMS["text_0_lit"]
    assert dc.tuple_package_merge(lf, 15) != dc.package_merge(lf, 15)


def _positions(tokens, length):
    """(is_head, mlen, dist) by position of a token row."""
    head = np.zeros(N, bool)
    mlen = np.zeros(N, np.int32)
    dist = np.zeros(N, np.int32)
    p = 0
    for t in tokens:
        if t < 256:
            p += 1
            continue
        head[p], mlen[p], dist[p] = True, t >> 16, t & 0xFFFF
        p += t >> 16
    assert p == length
    return head, mlen, dist


def test_greedy_parse_equals_lz77_stage():
    """The plain greedy parse over the links at max_chain 1 gives
    lz77_stage's (is_head, mlen, dist) on every row; the kernel's launch
    pair is the same call on a CUDA tensor."""
    x, lens = _rows()
    xt, lt = torch.from_numpy(x), torch.from_numpy(lens)
    tok, nt = dc.deflate_parse_greedy(xt, lt, dc.deflate_links(xt, lt))
    is_head, _, mlen, dist, _, _ = jdef._lz77_stage_vmap(jnp.asarray(x),
                                                         jnp.asarray(lens))
    for r in range(len(x)):
        head, ml, ds = _positions(tok[r, : int(nt[r])].tolist(), lens[r])
        np.testing.assert_array_equal(head, np.asarray(is_head[r]))
        np.testing.assert_array_equal(ml, np.asarray(mlen[r]))
        np.testing.assert_array_equal(ds, np.asarray(dist[r]))
    lazy, _ = dc.deflate_parse(xt, lt, dc.deflate_links(xt, lt), 1)
    assert not torch.equal(lazy, tok)   # the lazy step defers somewhere


def test_deflate_batch_byte_identical():
    """deflate_batch: every row of tpuzip's width (2n + 2048) and every
    length equal; the port's inflate_batch gives the rows back, zero past
    their lengths, and tpuzip's reads the port's streams."""
    x, lens = _rows()
    comp, clens = tdef.deflate_batch(x, lens, device="cpu")
    jc, jl = jdef.deflate_batch(jnp.asarray(x), jnp.asarray(lens))
    assert comp.shape == jc.shape
    np.testing.assert_array_equal(comp.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(clens.numpy(), np.asarray(jl))
    out, olens = tdef.inflate_batch(comp, clens, N, device="cpu")
    np.testing.assert_array_equal(out.numpy(), x)
    np.testing.assert_array_equal(olens.numpy(), lens)
    jout, jol = jdef.inflate_batch(comp.numpy(), clens.numpy(), N)
    np.testing.assert_array_equal(np.asarray(jol), lens)
    for r, ln in enumerate(lens):   # tpuzip's rows hold more past olens
        assert np.asarray(jout)[r, :ln].tobytes() == x[r, :ln].tobytes()


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 5000])
def test_deflate_byte_identical(n):
    """deflate() pads to max(len, 32); its stream equals tpuzip's and
    inflates back, by the port and by tpuzip."""
    data = TEXT[:n]
    mine = tdef.deflate(data, device="cpu")
    assert mine == jdef.deflate(data)
    assert tdef.inflate(mine, max(n, 1), device="cpu") == data
    assert jdef.inflate(mine, max(n, 1)) == data


def test_deflate_n_static():
    """n_static sets the row's width (the same stream); data wider than
    n_static raises ValueError in both."""
    data = TEXT[:100]
    assert tdef.deflate(data, n_static=256, device="cpu") == \
        jdef.deflate(data, n_static=256)
    for call in (lambda: jdef.deflate(TEXT[:300], n_static=256),
                 lambda: tdef.deflate(TEXT[:300], 256, device="cpu")):
        with pytest.raises(ValueError):
            call()


def test_inflate_raises_where_tpuzip_does():
    """An empty stream, a reserved block type, a stored block's LEN/NLEN
    mismatch and output past out_n raise ValueError in both; a 2^31-bit
    row is refused before any launch."""
    good = tdef.deflate(TEXT[:500], device="cpu")
    for bad, out_n in ((b"", 10), (b"\x07", 10), (b"\x01\x05\x00\x00\x00", 10),
                       (good, 499)):
        for call in (lambda: jdef.inflate(bad, out_n),
                     lambda: tdef.inflate(bad, out_n, device="cpu")):
            with pytest.raises(ValueError):
                call()
    with pytest.raises(ValueError, match="2\\^31"):
        dc.check_row_bits(1 << 27)
    dc.check_row_bits((1 << 26) + (1 << 25))


def _from_device(blocks, lens, **kw):
    cfg = kw.pop("config", None)
    mine = tpuzip_torch.compress_from_device(
        blocks, lens, codec="deflate", device="cpu",
        config=cfg and config_from_dict(dataclasses.asdict(cfg)), **kw)
    ref = jrun.compress_from_device(jnp.asarray(blocks), lens, "deflate",
                                    mesh=MESH1, config=cfg, **kw)
    return mine, ref


def _cfg(**deflate):
    cfg = Config()
    cfg.codec.ari.increment = 16
    for k, v in deflate.items():
        setattr(cfg.codec.deflate, k, v)
    return cfg


@pytest.mark.parametrize("kw", [
    {}, {"block_checksums": True, "config": _cfg()},
    {"config": _cfg(mode="fixed", max_chain=8)}],
    ids=["defaults", "checksums_and_knobs", "deflate_config_ignored"])
def test_compress_from_device_byte_identical(kw):
    """compress_from_device(codec="deflate") equals tpuzip's on a one-device
    mesh, with block checksums and the flag-4 knobs, and with a deflate
    config that both ignore; each package decodes the other's container."""
    data = TEXT[: 2 * N + 500]
    blocks, lens = blk.chunk(data, N)
    mine, ref = _from_device(blocks, lens, **kw)
    assert mine == ref
    assert tpuzip.decompress(mine) == data
    assert tpuzip_torch.decompress(ref, device="cpu") == data
