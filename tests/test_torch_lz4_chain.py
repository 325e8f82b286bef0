"""lz4 at max_chain > 1: tpuzip's chained C++ encoder
(``tpz_lz4_compress_chained``, through ``native.lz4_compress_batch``)
against the port's kernels/lz4_chain.py, whose plain versions run here on
the CPU; the CUDA kernels of csrc/lz4_chain.cu are held against them on the
card by chip_smoke.py."""

import dataclasses

import numpy as np
import pytest
import torch

from tpuzip.core.config import Config
from tpuzip.dist import mesh as meshlib
from tpuzip.dist import runner as jrun
from tpuzip.runtime import native
import tpuzip_torch
from tpuzip_torch.core.config import config_from_dict
from tpuzip_torch.kernels import lz4_chain

MESH1 = meshlib.make_mesh(1)
with open(__file__.rsplit("/tests/", 1)[0] + "/SURVEY.md", "rb") as _f:
    TEXT = _f.read()
N = 4096


def _corpus() -> bytes:
    """Text, runs over 255 bytes, random bytes, zeros and a 13-byte tail,
    in blocks of N."""
    rng = np.random.default_rng(14)
    runs = np.repeat(rng.integers(0, 256, N), rng.integers(1, 700, N))[:N]
    return (TEXT[:N] + runs.astype(np.uint8).tobytes()
            + rng.integers(0, 256, N, np.uint8).tobytes() + bytes(N)
            + TEXT[N : N + 13])


DATA = _corpus()


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for each test here: the plain versions run
    thousands of small tensor ops, and beside the other pytest-xdist
    workers each op's thread pool waits for cores they hold (with 8
    threads a worker under 6 workers, one case took 219 s against 0.8 s
    alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(max_chain, hash_log=16, device_encode=False):
    cfg = Config()
    cfg.codec.lz4.max_chain = max_chain
    cfg.codec.lz4.hash_log = hash_log
    cfg.codec.lz4.device_encode = device_encode
    return cfg


def _both(data, cfg, block_size=N):
    """Both packages' containers at cfg, held equal, each decoded by the
    other package."""
    mine = tpuzip_torch.compress(
        data, block_size=block_size, device="cpu",
        config=config_from_dict(dataclasses.asdict(cfg)))
    ref = jrun.compress(data, block_size=block_size, mesh=MESH1, config=cfg)
    assert mine == ref, (len(data), dataclasses.asdict(cfg.codec.lz4))
    assert tpuzip_torch.decompress(ref, device="cpu") == data
    assert jrun.decompress(mine, mesh=MESH1) == data
    return mine


@pytest.mark.parametrize("max_chain", [2, 8, 64])
@pytest.mark.parametrize("hash_log", [4, 12, 16, 30])
def test_container_identical(max_chain, hash_log):
    """Byte-identical containers on text, runs, random, zero and 13-byte
    blocks; hash_log 30 is out of 4..24 and taken as 16, as by the C++."""
    assert native.available()
    blob = _both(DATA, _cfg(max_chain, hash_log))
    if hash_log == 30:
        assert blob == _both(DATA, _cfg(max_chain, 16))
    _both(b"", _cfg(max_chain, hash_log))


def test_chain_is_denser_and_options_order():
    """max_chain 8 writes a smaller container than the single-probe parse;
    max_chain 1 is that parse; device_encode=True wins over max_chain (the
    XLA encoder, as tpuzip's runner)."""
    one = _both(DATA, _cfg(1))
    assert one == _both(DATA, Config())
    assert len(_both(DATA, _cfg(8))) < len(one)
    _both(DATA, _cfg(8, 12, device_encode=True))


def _rows():
    rng = np.random.default_rng(3)
    blocks = [TEXT[:N], TEXT[N : 2 * N - 500] + bytes(500), bytes(N),
              b"ab" * (N // 2), rng.integers(0, 4, N, np.uint8).tobytes(),
              rng.integers(0, 256, N, np.uint8).tobytes(), b"q" * 13,
              b"0123456789abcdefg", b""]
    return _padded(blocks, N)


def _padded(blocks, n):
    out = np.zeros((len(blocks), n), np.uint8)
    for i, b in enumerate(blocks):
        out[i, : len(b)] = np.frombuffer(b, np.uint8)
    return torch.from_numpy(out), torch.tensor([len(b) for b in blocks],
                                               dtype=torch.int32)


@pytest.mark.parametrize("max_chain,hash_log", [(2, 16), (8, 4), (64, 24)])
def test_plain_encoder_equals_native(max_chain, hash_log):
    """Row by row, the plain encoder's streams are the C++ chained
    encoder's: text, text then zeros, all zero, b"ab" runs, 4 symbols,
    random bytes, 13 and 17 bytes, empty; 0 past each stream."""
    x, lens = _rows()
    comp, clens = lz4_chain.lz4_chain_encode_batch(x, lens, hash_log,
                                                   max_chain)
    ref, rlens = native.lz4_compress_batch(x.numpy(), lens.numpy(),
                                           max_chain=max_chain,
                                           hash_log=hash_log)
    assert clens.tolist() == rlens.tolist()
    for r, ln in enumerate(rlens):
        assert comp[r, :ln].numpy().tobytes() == ref[r, :ln].tobytes(), r
        assert not comp[r, ln:].any()


def test_far_repeats_container_identical():
    """A 128 KiB block whose repeats lie 65,533 to 65,540 bytes back: the
    walk ends at the first link past 65,535."""
    rng = np.random.default_rng(9)
    block = rng.integers(0, 256, 1 << 17, np.uint8)
    for k, gap in enumerate(range(65533, 65541)):
        at = 65600 + 700 * k
        block[at : at + 40] = block[at - gap : at - gap + 40]
    _both(block.tobytes(), _cfg(8), block_size=1 << 17)


@pytest.mark.parametrize("hash_log", [4, 12, 16, 24])
def test_plain_links_equal_serial_insert(hash_log):
    """The plain links equal a serial model of the C++ chain's insert: each
    position below length - 12 links to the last one of its hash."""
    x, lens = _rows()
    prev = lz4_chain.lz4_chain_links_plain(x, lens, hash_log)
    for r in range(x.shape[0]):
        row, ln = x[r].numpy().tobytes(), int(lens[r])
        head, want = {}, [-1] * x.shape[1]
        for p in range(max(ln - 12, 0)):
            h = (int.from_bytes(row[p : p + 4], "little") * 2654435761
                 & 0xFFFFFFFF) >> (32 - hash_log)
            want[p] = head.get(h, -1)
            head[h] = p
        assert prev[r].tolist() == want, r


def test_wrappers_check_their_inputs():
    x, lens = _rows()
    prev = lz4_chain.lz4_chain_links(x, lens)
    with pytest.raises(ValueError, match="max_chain"):
        lz4_chain.lz4_chain_parse(x, lens, prev, 0)
    with pytest.raises(ValueError, match="prev"):
        lz4_chain.lz4_chain_parse(x, lens, prev[:, :-1], 8)
    with pytest.raises(TypeError):
        lz4_chain.lz4_chain_links(x.to(torch.int32), lens)
