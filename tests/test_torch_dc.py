"""The port's distance coding (tpuzip_torch/codecs/dc.py) and its DC walk
(kernels/dc_scan.py) against tpuzip: ``tpuzip.codecs.dc`` (the XLA
``encode_batch``, ``_parse_varints`` and ``_run_fill``), the Pallas kernel
``dc_decode_lanes`` in interpret mode, and the oracle.  Exact: the
tolerance is 0, corrupt rows included.  The CUDA kernel is held against
the plain version on the card (chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuzip.codecs import dc as jdc
from tpuzip.kernels import dc_scan as jscan
from tpuzip.oracle import bwt as obwt
from tpuzip.oracle import dc as odc
from tpuzip_torch.codecs import dc
from tpuzip_torch.kernels import dc_scan

N = 2048


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


def _cases(rng):
    """Rows of width N: empty, length 1, constant, periodic, random, BWT'd
    text, ragged and small-alphabet."""
    text = (b"abracadabra banana mississippi " * 80)[:N]
    return [b"", b"q", b"\x07" * N, (b"abcab" * N)[:N],
            bytes(rng.integers(0, 256, N, dtype=np.uint8)),
            obwt.encode_block(text)[0], text[: N // 2 + 3],
            bytes(rng.integers(0, 3, 777, dtype=np.uint8)), b"ab"]


def _batch(cases):
    blocks = np.zeros((len(cases), N), np.uint8)
    lens = np.array([len(c) for c in cases], np.int32)
    for i, c in enumerate(cases):
        blocks[i, : len(c)] = np.frombuffer(c, np.uint8)
    return blocks, lens


@pytest.fixture(scope="module")
def encoded():
    cases = _cases(np.random.default_rng(11))
    blocks, lens = _batch(cases)
    comp, clens = dc.encode_batch(torch.from_numpy(blocks),
                                  torch.from_numpy(lens))
    return cases, blocks, lens, comp, clens


def test_encode_matches_xla_and_oracle(encoded):
    cases, blocks, lens, comp, clens = encoded
    assert comp.shape == (len(cases), dc.encode_cap(N))
    jcomp, jlens = jax.jit(jdc.encode_batch)(jnp.array(blocks),
                                             jnp.array(lens))
    np.testing.assert_array_equal(comp.numpy(), np.asarray(jcomp))
    np.testing.assert_array_equal(clens.numpy(), np.asarray(jlens))
    for i, c in enumerate(cases):
        assert comp[i, : clens[i]].numpy().tobytes() == odc.encode(c), i


def test_constants_match():
    assert (dc.HDR, dc.VARINT_MAX) == (jdc.HDR, jdc.VARINT_MAX)
    for n in (0, 1, 2048, 1 << 20):
        assert dc.encode_cap(n) == jdc.encode_cap(n)


def test_varint_bytes_match(rng):
    v = np.concatenate([[0, 1, 127, 128, 16383, 16384, 2**21, 2**28 - 1,
                         2**28, 2**31 - 1],
                        rng.integers(0, 2**31, 200)]).astype(np.int32)
    got_b, got_l = dc.varint_bytes(torch.from_numpy(v))
    exp_b, exp_l = jdc._varint_bytes(jnp.array(v))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(exp_l))
    for i, n in enumerate(got_l.tolist()):   # bytes past a varint: unused
        np.testing.assert_array_equal(got_b[i, :n].numpy(),
                                      np.asarray(exp_b)[i, :n])


def test_parse_varints_matches_on_each_rows_count(encoded):
    """The first num-runs values of every row (past them tpuzip's sort
    leaves values of no varint, the port 0)."""
    cases, _, _, comp, clens = encoded
    width = int(clens.max())
    got = dc.parse_varints(comp[:, :width].contiguous(), clens, N)
    for i, c in enumerate(cases):
        exp = np.asarray(jdc._parse_varints(
            jnp.array(comp[i, :width].numpy().astype(np.int32)),
            jnp.int32(int(clens[i])), N))
        runs = _num_runs(c)
        np.testing.assert_array_equal(got[i, :runs].numpy(), exp[:runs],
                                      err_msg=str(i))
        assert not got[i, runs:].any(), i


def _num_runs(data: bytes) -> int:
    return sum(1 for i in range(len(data)) if i == 0 or data[i] != data[i - 1])


def test_run_fill_matches(rng):
    t, out_n = 300, 900
    starts = np.sort(rng.integers(0, out_n, (3, t)), axis=1).astype(np.int32)
    starts[:, 0] = 0
    lens_ = np.diff(np.concatenate([starts, np.full((3, 1), out_n)], 1),
                    axis=1).astype(np.int32)
    lens_[1, 250:] = 0                      # steps past the walk's end
    syms = rng.integers(0, 256, (3, t)).astype(np.int32)
    length = np.array([out_n, 700, 0], np.int32)
    got = dc.run_fill(torch.from_numpy(starts), torch.from_numpy(lens_),
                      torch.from_numpy(syms), torch.from_numpy(length), out_n)
    for i in range(3):
        exp = np.asarray(jdc._run_fill(jnp.array(starts[i]),
                                       jnp.array(lens_[i]),
                                       jnp.array(syms[i]),
                                       jnp.int32(length[i]), out_n))
        np.testing.assert_array_equal(got[i].numpy(), exp, err_msg=str(i))


def _corrupt_inputs():
    """The setting of tests/test_kernels.py:193-224 (n = 512, four oracle
    streams, then block 2's first-occurrence table clobbered), plus rows
    that read a header field as negative, share a first occurrence, or
    carry a flipped varint continuation bit."""
    rng = np.random.default_rng(7)
    n = 512
    blocks = [(b"abracadabra banana " * 40)[:n],
              rng.integers(0, 3, n, dtype=np.uint8).tobytes(), bytes(n),
              rng.integers(0, 256, n, dtype=np.uint8).tobytes()]
    comps = [odc.encode(b) for b in blocks * 2]
    rows = np.zeros((len(comps), max(len(c) for c in comps) + 8), np.uint8)
    lens = np.array([len(c) for c in comps], np.int32)
    for i, c in enumerate(comps):
        rows[i, : len(c)] = np.frombuffer(c, np.uint8)
    rows[2, 4] = 0xFF                      # test_kernels.py's clobber
    rows[4, 4 + 4 * 200 : 4 + 4 * 201] = 0xFF   # first[200] reads as -1
    rows[5, 4:8] = rows[5, 8:12]           # symbols 0 and 1 share a head
    rows[7, dc.HDR + 1] ^= 0x80            # a continuation bit flipped
    return rows, lens, n


def test_plain_walk_matches_pallas_kernel_interpret():
    """All four outputs of the TPU kernel (interpret mode, lanes padded to
    128, steps to 256) equal the plain walk's, corrupt rows included."""
    rows, lens, n = _corrupt_inputs()
    vals, first, length = dc.decode_inputs(torch.from_numpy(rows),
                                           torch.from_numpy(lens), n)
    b, t = vals.shape
    t_pad = -(-t // jscan.CHUNK) * jscan.CHUNK
    valsT = np.zeros((t_pad, 128), np.int32)
    valsT[:t, :b] = vals.numpy().T
    firstT = np.zeros((256, 128), np.int32)
    firstT[:, :b] = first.numpy().T
    lensT = np.zeros(128, np.int32)
    lensT[:b] = length.numpy()
    exp = jscan.dc_decode_lanes(jnp.array(valsT), jnp.array(firstT),
                                jnp.array(lensT), interpret=True)
    got = dc_scan.dc_decode_lanes_plain(
        torch.from_numpy(np.ascontiguousarray(valsT[:, :b].T)), first,
        length)
    for g, e in zip(got[:3], exp[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e)[:, :b].T)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(exp[3])[:b])
    assert got[3][2] and not got[3][[0, 1, 3]].any()   # as test_kernels.py


def test_decode_batch_round_trip_and_errors(encoded):
    cases, blocks, lens, comp, clens = encoded
    width = int(clens.max())
    out, length, err = dc.decode_batch(comp[:, :width].contiguous(), clens, N)
    assert not err.any()
    np.testing.assert_array_equal(length.numpy(), lens)
    np.testing.assert_array_equal(out.numpy(), blocks)
    # against tpuzip's decode_batch on the same streams
    jout, jlen, jerr = jax.jit(jdc.decode_batch, static_argnums=(2, 3))(
        jnp.array(comp[:, :width].numpy()), jnp.array(clens.numpy()), N, N)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert not np.asarray(jerr).any()
    # an unfinished walk (steps cut short) is an error
    rows, lens_c, n = _corrupt_inputs()
    _, _, err = dc.decode_batch(torch.from_numpy(rows),
                                torch.from_numpy(lens_c), n)
    assert err[2] and not err[[0, 1, 3]].any()
    vals, first, length = dc.decode_inputs(comp[:, :width].contiguous(),
                                           clens, N)
    cut = dc_scan.dc_decode_lanes(vals[:, :5].contiguous(), first, length)
    assert cut[3].tolist() == [int(_num_runs(c) > 5) for c in cases]


def test_wrapper_takes_plain_version_only_on_cpu(encoded):
    _, _, _, comp, clens = encoded
    vals, first, length = dc.decode_inputs(comp, clens, N)
    before = dc_scan.dc_decode_lanes.launches
    for g, e in zip(dc_scan.dc_decode_lanes(vals, first, length),
                    dc_scan.dc_decode_lanes_plain(vals, first, length)):
        assert torch.equal(g, e)
    assert dc_scan.dc_decode_lanes.launches == before   # no kernel ran
    with pytest.raises(ValueError):    # neither cpu nor cuda: no plain run
        dc_scan.dc_decode_lanes(vals.to("meta"), first.to("meta"),
                                length.to("meta"))
    with pytest.raises(TypeError):
        dc_scan.dc_decode_lanes(vals.to(torch.int64), first, length)
    with pytest.raises(ValueError):
        dc_scan.dc_decode_lanes(vals, first[:, :255], length)
    empty = dc_scan.dc_decode_lanes(vals[:, :0], first, length)
    assert empty[0].shape == (len(length), 0)
    # a zero-step walk of a non-empty row is unfinished
    assert empty[3].tolist() == (length > 0).int().tolist()
