"""The port's plain chunk-indexed ari decoders against tpuzip's XLA
replica of the Pallas decode kernels, ``ari_decode_reference``, symbol for
symbol: ari_decode_indexed_plain under algo="packed" (v3) and algo="cum"
(v2), ari_decode_dot_indexed_plain under algo="dot" (v1, frequency state),
across halvings — the setting of tests/test_kernels.py:227-268, with
ragged and empty lanes — and on garbage streams with a random chunk
index.  tests/test_range_decoder.py:74 parametrizes algo but never passes
it, so these are the only tests of the v1 step; they go through
``ari_decode_reference(algo="dot")`` because ``ari_decode_lanes`` does not
lower in interpret mode on the CPU.  The CUDA kernels are held against
these plain versions on the card.  The dot route launches csrc/
ari_decode.cu on the card; test_dot_function_equals_cum_function is what
licenses that: the v1 function equals the cumulative-state one at every
knob pair the card's smoke runs, on valid streams and on garbage."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuzip.kernels import range_decoder as jrd
from tpuzip_torch.kernels import range_coder as trc
from tpuzip_torch.kernels import range_decoder as trd

LANES = 128
N = 8 * trd.CHUNK_STEPS


def _streams(rng, inc, thr):
    x = np.zeros((LANES, N), np.uint8)
    for lane in range(LANES):
        x[lane] = rng.integers(0, 256 if lane % 2 else 16, N)
    lens = np.full(LANES, N, np.int32)
    lens[5], lens[6], lens[9] = 100, 0, 64           # ragged and empty
    for lane in (5, 6, 9):
        x[lane, lens[lane]:] = 0
    streams, _, deltas = trc.ari_encode_indexed_plain(
        torch.from_numpy(x), torch.from_numpy(lens), inc, thr)
    return x, lens, streams, deltas


def _reference(streams, deltas, lens, inc, thr, algo):
    """tpuzip's own decode wiring: prepacked windows + code0 + the XLA
    replica of the kernel (ari_decode_reference)."""
    st = streams.numpy()
    dt = jnp.array(deltas.numpy().T)
    w = jrd.window_words(max(int(deltas.max()), 1))
    starts = 4 + jnp.cumsum(dt, axis=0) - dt
    wins = jrd.build_windows(jnp.array(st.T), starts, w)
    cu = st[:, :4].astype(np.uint32)
    code0 = jnp.array((cu[:, 0] << 24) | (cu[:, 1] << 16)
                      | (cu[:, 2] << 8) | cu[:, 3])
    return np.asarray(jrd.ari_decode_reference(
        wins, code0, jnp.array(lens), w=w, algo=algo, increment=inc,
        threshold=thr)).T


PLAIN = {"packed": trd.ari_decode_indexed_plain,
         "cum": trd.ari_decode_indexed_plain,
         "dot": trd.ari_decode_dot_indexed_plain}


@pytest.mark.parametrize("algo,knobs", [
    ("packed", (8, 512)), ("cum", (8, 512)), ("cum", (16, 40000)),
    ("dot", (8, 512)), ("dot", (16, 40000))])
def test_plain_decode_matches_reference(rng, algo, knobs):
    inc, thr = knobs
    x, lens, streams, deltas = _streams(rng, inc, thr)
    got = PLAIN[algo](streams, deltas, torch.from_numpy(lens), inc, thr)
    assert got.shape == (LANES, N)
    exp = _reference(streams, deltas, lens, inc, thr, algo)
    for lane in range(LANES):
        n = lens[lane]
        assert got[lane, :n].numpy().tobytes() == exp[lane, :n].tobytes(), \
            (algo, lane)
        assert got[lane, :n].numpy().tobytes() == x[lane, :n].tobytes()
        assert not got[lane, n:].any()              # 0 past the length


def _garbage(rng):
    """Random stream bytes and a random chunk index (deltas 0..260, so some
    chunks read past the row and some barely move), ragged lengths."""
    nc = 6
    streams = torch.from_numpy(rng.integers(0, 256, (LANES, 1200), np.uint8))
    deltas = torch.from_numpy(rng.integers(0, 261, (LANES, nc), np.int32))
    lens = rng.integers(0, nc * trd.CHUNK_STEPS + 1, LANES).astype(np.int32)
    lens[:4] = nc * trd.CHUNK_STEPS
    return streams, deltas, lens


@pytest.mark.parametrize("knobs", [(8, 512), (16, 40000)])
def test_dot_plain_decode_matches_reference_on_garbage(rng, knobs):
    """Both states give the same symbols on garbage, because v <= tot-1
    clamps the search in both."""
    inc, thr = knobs
    streams, deltas, lens = _garbage(rng)
    lt = torch.from_numpy(lens)
    got = trd.ari_decode_dot_indexed_plain(streams, deltas, lt, inc, thr)
    exp = _reference(streams, deltas, lens, inc, thr, "dot")
    cum = trd.ari_decode_indexed_plain(streams, deltas, lt, inc, thr)
    for lane in range(LANES):
        n = lens[lane]
        assert got[lane, :n].numpy().tobytes() == exp[lane, :n].tobytes(), \
            lane
        assert torch.equal(got[lane], cum[lane]), lane


# chip_smoke.KNOBS: the (increment, threshold) pairs the card's smoke runs
SMOKE_KNOBS = ((8, 1 << 13), (8, 512), (16, 40000), (0, 1 << 13))


@pytest.fixture
def one_thread():
    """One intra-op thread for the plain decoders' many small steps, so
    that a worker beside other test workers does not oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("kind", ["valid", "garbage"])
@pytest.mark.parametrize("knobs", SMOKE_KNOBS)
def test_dot_function_equals_cum_function(rng, knobs, kind):
    """The v1 function (frequency state, the table rebuilt every step)
    equals the cumulative-state one: the port's two plain versions agree
    on every symbol, and so do tpuzip's references under algo="dot" and
    "cum" (both take every pair here: f32 sums stay below 2^24, and the
    frequencies' bytes are bf16-exact)."""
    inc, thr = knobs
    if kind == "valid":
        _, lens, streams, deltas = _streams(rng, inc, thr)
    else:
        streams, deltas, lens = _garbage(rng)
    lt = torch.from_numpy(lens)
    dot = trd.ari_decode_dot_indexed_plain(streams, deltas, lt, inc, thr)
    assert torch.equal(dot, trd.ari_decode_indexed_plain(streams, deltas, lt,
                                                         inc, thr))
    jdot = _reference(streams, deltas, lens, inc, thr, "dot")
    jcum = _reference(streams, deltas, lens, inc, thr, "cum")
    for lane in range(LANES):
        n = lens[lane]
        assert jdot[lane, :n].tobytes() == jcum[lane, :n].tobytes(), lane
        assert dot[lane, :n].numpy().tobytes() == jdot[lane, :n].tobytes()


def test_plain_decode_reads_zero_past_the_row(rng):
    """A stream cut to its used length decodes the same: bytes past the
    row read as 0, as the zero-filled capacity does."""
    x, lens, streams, deltas = _streams(rng, 8, 1 << 13)
    lt = torch.from_numpy(lens)
    full = trd.ari_decode_indexed_plain(streams, deltas, lt)
    _, slens, _ = trc.ari_encode_indexed_plain(torch.from_numpy(x), lt)
    cut = trd.ari_decode_indexed_plain(
        streams[:, : int(slens.max())].contiguous(), deltas, lt)
    assert torch.equal(full, cut)


def test_wrapper_takes_plain_version_only_on_cpu(rng):
    x, lens, streams, deltas = _streams(rng, 8, 1 << 13)
    lt = torch.from_numpy(lens)
    before = trd.ari_decode_indexed.launches
    assert torch.equal(trd.ari_decode_indexed(streams, deltas, lt),
                       trd.ari_decode_indexed_plain(streams, deltas, lt))
    assert trd.ari_decode_indexed.launches == before
    with pytest.raises(ValueError):
        trd.ari_decode_indexed(streams.to("meta"), deltas.to("meta"),
                               lt.to("meta"))
    with pytest.raises(TypeError):
        trd.ari_decode_indexed(streams, deltas.to(torch.int64), lt)
    with pytest.raises(ValueError):
        trd.ari_decode_indexed(streams, deltas[:3], lt)


def test_algo_choice_takes_plain_versions_only_on_cpu(rng, monkeypatch):
    """ari_decode_indexed(algo=...) and ari_decode_dot_indexed on CPU
    tensors: the plain versions, no launch counted, the same checks; the
    dot route's CPU path is still the v1 step (its own plain version, not
    the cumulative one) though on the card it launches ari_decode.cu."""
    _, lens, streams, deltas = _streams(rng, 8, 1 << 13)
    deltas = deltas[:, :2].contiguous()          # the first 128 symbols
    lt = torch.from_numpy(lens).clamp(max=2 * trd.CHUNK_STEPS)
    cum = trd.ari_decode_indexed_plain(streams, deltas, lt)
    dot = trd.ari_decode_dot_indexed_plain(streams, deltas, lt)
    assert torch.equal(dot, cum)
    before = (trd.ari_decode_indexed.launches,
              trd.ari_decode_dot_indexed.launches)
    assert torch.equal(trd.ari_decode_indexed(streams, deltas, lt,
                                              algo="dot"), dot)
    assert torch.equal(trd.ari_decode_dot_indexed(streams, deltas, lt), dot)
    for algo in ("packed", "cum"):
        assert torch.equal(trd.ari_decode_indexed(streams, deltas, lt,
                                                  algo=algo), cum)
    assert (trd.ari_decode_indexed.launches,
            trd.ari_decode_dot_indexed.launches) == before
    with pytest.raises(ValueError):
        trd.ari_decode_indexed(streams, deltas, lt, algo="v1")
    with pytest.raises(ValueError):
        trd.ari_decode_dot_indexed(streams.to("meta"), deltas.to("meta"),
                                   lt.to("meta"))
    with pytest.raises(TypeError):
        trd.ari_decode_dot_indexed(streams, deltas.to(torch.int64), lt)
    with pytest.raises(ValueError):
        trd.ari_decode_dot_indexed(streams, deltas[:3], lt)
    with pytest.raises(ValueError):
        trd.ari_decode_dot_indexed(streams, deltas, lt, 8, 1 << 16)
    ran = []
    plain = trd.ari_decode_dot_indexed_plain

    def v1_step(*args):
        ran.append(args[3:])
        return plain(*args)

    def refused(*args):
        raise AssertionError("the dot route ran the cumulative plain version")

    monkeypatch.setattr(trd, "ari_decode_dot_indexed_plain", v1_step)
    monkeypatch.setattr(trd, "ari_decode_indexed_plain", refused)
    assert torch.equal(trd.ari_decode_dot_indexed(streams, deltas, lt, 16,
                                                  512), plain(
        streams, deltas, lt, 16, 512))
    assert torch.equal(trd.ari_decode_indexed(streams, deltas, lt, algo="dot"),
                       dot)
    assert ran == [(16, 512), (8, 1 << 13)]
