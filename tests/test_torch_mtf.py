"""The port's plain MTF (``mtf_batch_plain``) against tpuzip: the masked
XLA scan of tpuzip/codecs/mtf.py on whole rows, the Pallas kernel
``_mtf_kernel`` in interpret mode on each row's valid prefix (it does not
mask by length), and the oracle.  Exact: the tolerance is 0.  The CUDA
kernel is held against this plain version on the card (chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuzip.codecs import mtf as jmtf
from tpuzip.kernels import mtf_scan as jscan
from tpuzip.oracle import mtf as omtf
from tpuzip_torch.kernels import mtf_scan


def _rows(rng, n):
    """(8, n) blocks and lengths: text, random, constant, small alphabet,
    skewed, a ragged row, an empty row and a length-1 row."""
    text = np.frombuffer((b"abracadabra, the quick brown fox! " * 64)[:n],
                         np.uint8)
    zipf = 1.0 / np.arange(1, 257) ** 1.3
    rows = [text, rng.integers(0, 256, n), np.full(n, 200),
            rng.integers(0, 4, n), rng.choice(256, n, p=zipf / zipf.sum()),
            rng.integers(0, 256, n), rng.integers(0, 256, n), text]
    blocks = np.stack(rows).astype(np.uint8)
    lens = np.array([n, n, n, n, n, n // 3 + 5, 0, 1], np.int32)
    return blocks, lens


def _plain(blocks, lens, decode=False):
    return mtf_scan.mtf_batch_plain(torch.from_numpy(blocks),
                                    torch.from_numpy(lens), decode).numpy()


@pytest.mark.parametrize("n", [512, 1000])
def test_plain_matches_xla_scan_and_oracle(rng, n):
    blocks, lens = _rows(rng, n)
    enc = _plain(blocks, lens)
    np.testing.assert_array_equal(
        enc, np.asarray(jax.jit(jmtf.encode_batch)(jnp.array(blocks),
                                                   jnp.array(lens))))
    dec = _plain(enc, lens, decode=True)
    np.testing.assert_array_equal(
        dec, np.asarray(jax.jit(jmtf.decode_batch)(jnp.array(enc),
                                                   jnp.array(lens))))
    for i, m in enumerate(lens):
        row = blocks[i, :m].tobytes()
        assert enc[i, :m].tobytes() == omtf.encode(row), i
        assert dec[i, :m].tobytes() == row, i        # decode of an encode
        assert not enc[i, m:].any() and not dec[i, m:].any(), i


@pytest.mark.parametrize("decode", [False, True], ids=["encode", "decode"])
def test_plain_matches_pallas_kernel_on_valid_prefix(rng, decode):
    """The TPU kernel runs every row to its end; positions past a length
    hold whatever it computed, so only the valid prefix is compared."""
    blocks, lens = _rows(rng, 512)
    got = _plain(blocks, lens, decode)
    exp = np.asarray(jscan.mtf_batch(jnp.array(blocks), decode=decode,
                                     interpret=True))
    for i, m in enumerate(lens):
        np.testing.assert_array_equal(got[i, :m], exp[i, :m], err_msg=str(i))


def test_wrapper_takes_plain_version_only_on_cpu(rng):
    blocks, lens = _rows(rng, 300)
    bt, lt = torch.from_numpy(blocks), torch.from_numpy(lens)
    before = mtf_scan.mtf_batch.launches
    assert torch.equal(mtf_scan.mtf_batch(bt, lt),
                       mtf_scan.mtf_batch_plain(bt, lt))
    assert torch.equal(mtf_scan.mtf_batch(bt, lt, decode=True),
                       mtf_scan.mtf_batch_plain(bt, lt, decode=True))
    assert mtf_scan.mtf_batch.launches == before     # no kernel ran
    with pytest.raises(ValueError):    # neither cpu nor cuda: no plain run
        mtf_scan.mtf_batch(bt.to("meta"), lt.to("meta"))
    with pytest.raises(TypeError):
        mtf_scan.mtf_batch(bt.to(torch.int32), lt)
    with pytest.raises(ValueError):
        mtf_scan.mtf_batch(bt, lt[:-1])
    for b, n in ((0, 5), (3, 0)):      # any B >= 0 and N >= 0
        out = mtf_scan.mtf_batch(torch.zeros((b, n), dtype=torch.uint8),
                                 torch.zeros(b, dtype=torch.int32))
        assert out.shape == (b, n)
