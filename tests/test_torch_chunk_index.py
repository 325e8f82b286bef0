"""The port's chunk-index helpers against tpuzip's (kernels/range_decoder).

Inputs are made with numpy from a seed and handed to both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuzip.kernels import range_decoder as jrd
from tpuzip_torch.kernels import range_decoder as trd


def test_constants_match():
    assert trd.CHUNK_STEPS == jrd.CHUNK_STEPS
    assert trd.W_BUCKETS == jrd.W_BUCKETS


def test_window_words_matches():
    for d in range(0, 4 * trd.CHUNK_STEPS + 5):
        assert trd.window_words(d) == jrd.window_words(d), d
    for mod in (trd, jrd):
        with pytest.raises(ValueError):
            mod.window_words(4 * trd.CHUNK_STEPS + 100)


def test_chunk_deltas_matches(rng):
    counts = rng.integers(0, 5, (8 * trd.CHUNK_STEPS, 24), dtype=np.uint8)
    got = trd.chunk_deltas(torch.from_numpy(counts))
    exp = np.asarray(jrd.chunk_deltas(jnp.array(counts)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("escapes", [False, True])
def test_pack_parse_random_deltas(rng, escapes):
    hi = 261 if escapes else 255
    for nc in (0, 1, 7, 64, 1000):
        d = rng.integers(0, hi, nc).astype(np.int32)
        blob = trd.pack_chunk_index(d)
        assert blob == jrd.pack_chunk_index(d), nc
        np.testing.assert_array_equal(trd.parse_chunk_index(blob, nc), d)
        np.testing.assert_array_equal(jrd.parse_chunk_index(blob, nc), d)


def test_chunk_index_escape_truncation_trailing():
    """tests/test_range_decoder.py:49-56 on both packages: the 255/256
    escape round-trips; a trailing byte and a truncation raise."""
    d = np.array([0, 1, 254, 255, 256, 100, 255, 0], np.int32)
    blob = trd.pack_chunk_index(d)
    assert blob == jrd.pack_chunk_index(d)
    for mod in (trd, jrd):
        assert (mod.parse_chunk_index(blob, len(d)) == d).all()
        with pytest.raises(ValueError):
            mod.parse_chunk_index(blob + b"\x01", len(d))
        with pytest.raises(ValueError):
            mod.parse_chunk_index(blob[:-1], len(d))
        with pytest.raises(ValueError):   # escape cut inside its 2 bytes
            mod.parse_chunk_index(b"\x05\xff\x01", 2)
        with pytest.raises(ValueError):   # delta past the codec's bound
            mod.parse_chunk_index(b"\xff" + (261).to_bytes(2, "little"), 1)


def test_parse_takes_the_bin_coders_bound():
    """A delta of 300 (escaped 255, 44, 1) is past the ari bound 4*64+4 but
    inside the bin coder's 4*256+4, which its callers pass as max_delta,
    as tpuzip's runner does for the bin/apm chunk index."""
    blob = bytes((7, 255, 44, 1))
    for mod in (trd, jrd):
        np.testing.assert_array_equal(
            mod.parse_chunk_index(blob, 2, max_delta=4 * 256 + 4), [7, 300])
        with pytest.raises(ValueError, match="exceeds"):
            mod.parse_chunk_index(blob, 2)
    edge = bytes((255,)) + (1028).to_bytes(2, "little")
    assert trd.parse_chunk_index(edge, 1, max_delta=1028).tolist() == [1028]
    with pytest.raises(ValueError):
        trd.parse_chunk_index(bytes((255,)) + (1029).to_bytes(2, "little"),
                              1, max_delta=1028)


def test_chunk_starts(rng):
    d = rng.integers(0, 200, (3, 9)).astype(np.int32)
    got = trd.chunk_starts(torch.from_numpy(d)).numpy()
    exp = 4 + np.cumsum(d, axis=1) - d
    np.testing.assert_array_equal(got, exp)


def test_build_windows_matches(rng):
    cap, lanes, nc, w = 600, 128, 5, 16
    comp = rng.integers(0, 256, (cap, lanes), dtype=np.uint8)
    starts = np.sort(rng.integers(0, cap + 40, (nc, lanes)),
                     axis=0).astype(np.int32)
    got = trd.build_windows(torch.from_numpy(comp),
                            torch.from_numpy(starts), w)
    exp = np.asarray(jrd.build_windows(jnp.array(comp), jnp.array(starts), w))
    np.testing.assert_array_equal(got.numpy(), exp.astype(np.int64))
