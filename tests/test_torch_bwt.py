"""The port's BWT (tpuzip_torch/codecs/bwt.py, torch.sort and
torch.gather on the tensor's device) against tpuzip: the oracle's
``encode_block`` / ``decode_block`` and the XLA batch formulation
``encode_batch`` / ``decode_batch`` of tpuzip/codecs/bwt.py.  Exact: the
tolerance is 0, origins included, on periodic blocks too."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuzip.codecs import bwt as jbwt
from tpuzip.oracle import bwt as obwt
from tpuzip_torch.codecs import bwt


def _cases(rng, n):
    """Rows of width n: random, text, periodic, constant, ragged, length 0
    and length 1."""
    text = (b"she sells sea shells by the sea shore; " * 200)[:n]
    return [bytes(rng.integers(0, 256, n, dtype=np.uint8)), text,
            (b"ab" * n)[:n], (b"abcabcab" * n)[:n], b"\x07" * n,
            text[: n // 2 + 3], bytes(rng.integers(0, 3, max(n - 9, 2),
                                                   dtype=np.uint8)),
            b"", b"z", b"ba"]


def _batch(cases, n):
    blocks = np.zeros((len(cases), n), np.uint8)
    lens = np.array([len(c) for c in cases], np.int32)
    for i, c in enumerate(cases):
        blocks[i, : len(c)] = np.frombuffer(c, np.uint8)
    return blocks, lens


@pytest.mark.parametrize("n", [4096, 1000, 7])   # 1000, 7: not powers of 2
def test_encode_matches_oracle_and_xla(rng, n):
    cases = [c[:n] for c in _cases(rng, n)]
    blocks, lens = _batch(cases, n)
    L, origins = bwt.encode_batch(torch.from_numpy(blocks),
                                  torch.from_numpy(lens))
    assert L.dtype == torch.uint8 and origins.dtype == torch.int32
    L, origins = L.numpy(), origins.numpy()
    for i, c in enumerate(cases):
        exp_L, exp_o = obwt.encode_block(c)
        assert L[i, : len(c)].tobytes() == exp_L, i
        assert int(origins[i]) == exp_o, i
        assert not L[i, len(c):].any(), i
    jL, jo = jax.jit(jbwt.encode_batch)(jnp.array(blocks), jnp.array(lens))
    np.testing.assert_array_equal(L, np.asarray(jL))
    np.testing.assert_array_equal(origins, np.asarray(jo))


@pytest.mark.parametrize("n", [4096, 1000])
def test_decode_matches_oracle_and_xla(rng, n):
    cases = _cases(rng, n)
    pairs = [obwt.encode_block(c) for c in cases]
    Ls, lens = _batch([p[0] for p in pairs], n)
    origins = np.array([p[1] for p in pairs], np.int32)
    out = bwt.decode_batch(torch.from_numpy(Ls), torch.from_numpy(origins),
                           torch.from_numpy(lens)).numpy()
    for i, c in enumerate(cases):
        assert out[i, : len(c)].tobytes() == c, i
        assert not out[i, len(c):].any(), i
    exp = jax.jit(jbwt.decode_batch)(jnp.array(Ls), jnp.array(origins),
                                     jnp.array(lens))
    np.testing.assert_array_equal(out, np.asarray(exp))


def test_round_trip_and_empty_batch(rng):
    cases = _cases(rng, 777)
    blocks, lens = _batch(cases, 777)
    bt, lt = torch.from_numpy(blocks), torch.from_numpy(lens)
    assert torch.equal(bwt.decode_batch(*bwt.encode_batch(bt, lt), lt), bt)
    for shape in ((0, 16), (2, 0)):
        L, o = bwt.encode_batch(torch.zeros(shape, dtype=torch.uint8),
                                torch.zeros(shape[0], dtype=torch.int32))
        assert L.shape == shape and o.shape == (shape[0],)
        assert bwt.decode_batch(L, o, torch.zeros(shape[0])).shape == shape
