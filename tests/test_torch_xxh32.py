"""xxHash32 of the LZ4 frame's checksums: kernels/xxh32.py's plain versions
(what the CPU runs; csrc/xxh32.cu is held against them on the card by
chip_smoke.py) and core.checksum's streaming Xxh32Stream and AdlerStream,
against tpuzip's oracle and its streams with its C++ coder loaded."""

import numpy as np
import pytest
import torch

from tpuzip.core import checksum as jchecksum
from tpuzip.oracle import xxh32 as jxxh32
from tpuzip.runtime import native
from tpuzip_torch.core import checksum as tchecksum
from tpuzip_torch.kernels import xxh32 as kx

LENGTHS = list(range(34)) + [4096, 65537]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the plain versions' small tensor ops wait on
    the other pytest-xdist workers' thread pools otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(24)
    return rng.integers(0, 256, (len(LENGTHS), max(LENGTHS)), dtype=np.uint8)


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_equals_the_oracle(rows, seed):
    """Every row's hash at lengths 0-33, 4096 and 65,537 (bytes past a
    row's length are random and must not count)."""
    got = kx.xxh32_batch(torch.from_numpy(rows),
                         torch.tensor(LENGTHS, dtype=torch.int32), seed)
    assert got.tolist() == [jxxh32.xxh32(rows[i, :n].tobytes(), seed)
                            for i, n in enumerate(LENGTHS)]


def test_batch_rows_of_any_pitch(rows):
    """A view whose rows are contiguous but apart (the frame's payload
    rows, a content row cut from its blocks) hashes as a copy does."""
    view = torch.from_numpy(rows)[:, 3:100]
    lens = torch.full((len(LENGTHS),), 97, dtype=torch.int32)
    assert kx.xxh32_batch(view, lens).tolist() == \
        [jxxh32.xxh32(rows[i, 3:100].tobytes()) for i in range(len(LENGTHS))]


@pytest.mark.parametrize("seed", [0, 1])
def test_stripes_equal_native_and_the_state(rows, seed):
    """The stripe update, in place on the four lanes, equals tpuzip's
    tpz_xxh32_stripes and its oracle's Xxh32State over whole stripes."""
    assert native.available()
    data = rows[-1, :4096 + 16 * 5]
    st = jxxh32.Xxh32State(seed)
    v = np.array(st.v, np.uint32)
    native.xxh32_stripes(v, data.tobytes(), len(data) // 16)
    state = tchecksum.Xxh32Stream(seed, device="cpu").state
    kx.xxh32_stripes(state, torch.from_numpy(data.copy()), len(data) // 16)
    st.update(data.tobytes())
    assert [x & 0xFFFFFFFF for x in state.tolist()] == st.v == v.tolist()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n", [0, 5, 16, 33, 4096, 65537])
def test_stream_digest_at_lengths(rows, seed, n):
    """Xxh32Stream over bytes cut into uneven pieces (pieces under 16 bytes
    held on the host, the rest through the stripes) gives the oracle's
    digest, as tpuzip's stream with its C++ coder does."""
    assert native.available()
    data = rows[-1, :n].tobytes()
    mine = tchecksum.Xxh32Stream(seed, device="cpu")
    theirs = jchecksum.Xxh32Stream(seed)
    cuts = sorted({0, min(3, n), min(20, n), n // 2, n})
    for a, b in zip(cuts, cuts[1:]):
        mine.update(data[a:b])
        theirs.update(data[a:b])
    assert mine.digest() == theirs.digest() == jxxh32.xxh32(data, seed)


def test_stream_takes_tensors(rows):
    """Tensor pieces (a view of rows too) feed the stream as their bytes
    do; a tensor on another device or of another type is refused."""
    data = rows[:3, :5000]
    mine = tchecksum.Xxh32Stream(device="cpu")
    t = torch.from_numpy(data)
    mine.update(t[0, :7])
    mine.update(t[0, 7:])
    mine.update(t[1:])
    mine.update(b"tail")
    assert mine.digest() == jxxh32.xxh32(data.tobytes() + b"tail")
    with pytest.raises(ValueError):
        mine.update(t.to(torch.int32))


def test_adler_stream_equals_tpuzips():
    mine, theirs = tchecksum.AdlerStream(), jchecksum.AdlerStream()
    for piece in (b"", b"a", b"abc" * 10000, bytes(70000)):
        mine.feed(piece)
        theirs.feed(piece)
        assert mine.result() == theirs.result()


def test_wrappers_check_their_arguments():
    rows = torch.zeros((2, 16), dtype=torch.uint8)
    with pytest.raises(TypeError):
        kx.xxh32_batch(rows, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        kx.xxh32_batch(rows, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        kx.xxh32_stripes(torch.zeros(4, dtype=torch.int32), rows[0], 2)
    with pytest.raises(TypeError):
        kx.xxh32_stripes(torch.zeros(4, dtype=torch.int64), rows[0], 1)
    with pytest.raises(RuntimeError):
        tchecksum.Xxh32Stream(device="cuda")
