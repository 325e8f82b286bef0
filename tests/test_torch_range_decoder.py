"""The port's plain chunk-indexed ari decoder against tpuzip's XLA
replica of the Pallas decode kernels, ``ari_decode_reference``, symbol for
symbol under algo="packed" (v3) and algo="cum" (v2), across halvings —
the setting of tests/test_kernels.py:227-268, with ragged and empty
lanes.  The CUDA kernel is held against this plain version on the card."""

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


@pytest.mark.parametrize("algo,knobs", [
    ("packed", (8, 512)), ("cum", (8, 512)), ("cum", (16, 40000))])
def test_plain_decode_matches_reference(rng, algo, knobs):
    inc, thr = knobs
    x, lens, streams, deltas = _streams(rng, inc, thr)
    got = trd.ari_decode_indexed_plain(streams, deltas,
                                       torch.from_numpy(lens), inc, thr)
    assert got.shape == (LANES, N)
    exp = _reference(streams, deltas, lens, inc, thr, algo)
    for lane in range(LANES):
        n = lens[lane]
        assert got[lane, :n].numpy().tobytes() == exp[lane, :n].tobytes(), \
            (algo, lane)
        assert got[lane, :n].numpy().tobytes() == x[lane, :n].tobytes()
        assert not got[lane, n:].any()              # 0 past the length


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
