"""The port's plain bin/apm coders (tpuzip_torch/kernels/bin_coder.py)
against tpuzip: the Pallas encoder ``bin_encode_lanes`` in interpret mode
(bytes, counts -> deltas, final state), the XLA replica of the decode
kernel ``bin_decode_reference`` (never the interpret-mode decode kernel:
it takes over 40 minutes to compile, tests/test_kernels.py:275-285), the
XLA scan ``codecs.bin_apm.encode_bits`` and the oracle chain.  Exact: the
tolerance is 0.  The CUDA kernels are held against these plain versions
on the card (chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tpuzip.codecs import bin_apm as jbin
from tpuzip.kernels import bin_coder as jbc
from tpuzip.kernels import range_decoder as jrd
from tpuzip.oracle import ari as oari
from tpuzip_torch.codecs import bin_apm
from tpuzip_torch.kernels import bin_coder

KNOBS = [(12, 5), (10, 4), (11, 5)]   # tests/test_dist.py:442, 668


def _blocks(rng, n):
    """(8, n) byte blocks: text, random, constant, two-symbol, skewed
    bits, a ragged row, an empty row and a length-1 row."""
    text = np.frombuffer((b"binary model codec surface " * 40)[:n], np.uint8)
    rows = [text, rng.integers(0, 256, n), np.full(n, 0x55),
            rng.integers(0, 2, n) * 255, (rng.random(n) < 0.05) * 8,
            rng.integers(0, 256, n), rng.integers(0, 256, n), text]
    blocks = np.stack(rows).astype(np.uint8)
    lens = np.array([n, n, n, n, n, n // 3 + 5, 0, 1], np.int32)
    for i, m in enumerate(lens):
        blocks[i, m:] = 0
    return blocks, lens


def _oracle(bits, model_bits, rate, apm):
    """tests/test_jax_bin_apm.py:17-37, with the knobs."""
    model, gate, enc = (oari.BinaryModel(model_bits, rate), oari.ApmGate(),
                        oari.RangeEncoder())
    for b in bits.tolist():
        if apm:
            p0 = gate.pass_through(model.p0)
            lo, hi = (0, p0) if b == 0 else (p0, 1 << oari.ApmBit.BITS)
            enc.encode(lo, hi, 1 << oari.ApmBit.BITS)
            gate.update(b, 5)
        else:
            enc.encode(*model.get_range(b), model.get_denominator())
        model.update(b)
    return enc.finish()


def test_helpers_match(rng):
    blocks, _ = _blocks(rng, 100)
    bits = bin_apm.bytes_to_bits(torch.from_numpy(blocks))
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(jbin.bytes_to_bits(jnp.array(blocks))))
    np.testing.assert_array_equal(bin_apm.bits_to_bytes(bits).numpy(), blocks)
    for n in (0, 8, 4096, 8 << 16):
        assert bin_apm.encode_cap(n) == jbin.encode_cap(n)
    assert (bin_apm.APM_BITS, bin_apm.APM_SLOTS) == (jbin.APM_BITS,
                                                     jbin.APM_SLOTS)
    assert (bin_coder.CHUNK, bin_coder.MAX_DELTA) == (jbc.CHUNK,
                                                      4 * jbc.CHUNK + 4)


@pytest.mark.parametrize("apm", [False, True], ids=["bin", "apm"])
def test_plain_encode_matches_pallas_kernel_interpret(rng, apm):
    """Bytes, per-bit counts (summed into the chunk index) and the final
    low of the TPU kernel in interpret mode, lanes padded to 128."""
    blocks, lens = _blocks(rng, 128)
    streams, slens, deltas = bin_coder.bin_encode_indexed_plain(
        torch.from_numpy(blocks), torch.from_numpy(lens), use_apm=apm)
    bits = np.asarray(jbin.bytes_to_bits(jnp.array(blocks)))
    x = np.zeros((bits.shape[1], 128), np.uint8)
    x[:, : len(lens)] = bits.T
    lt = np.zeros(128, np.int32)
    lt[: len(lens)] = 8 * lens
    out, counts, state = (np.asarray(a) for a in jbc.bin_encode_lanes(
        jnp.array(x), jnp.array(lt), use_apm=apm,
        interpret=pltpu.InterpretParams()))
    nc = deltas.shape[1]
    exp_deltas = counts.astype(np.int32).reshape(nc, jbc.CHUNK, 128).sum(1)
    np.testing.assert_array_equal(deltas.numpy(), exp_deltas[:, :8].T)
    for i in range(len(lens)):
        c = counts[:, i]
        body = b"".join(out[4 * t : 4 * t + c[t], i].tobytes()
                        for t in np.nonzero(c)[0])
        tail = int(state[0, i]).to_bytes(4, "big")   # the final low
        assert int(slens[i]) == len(body) + 4, i
        assert streams[i, : slens[i]].numpy().tobytes() == body + tail, i
        assert not streams[i, slens[i]:].any(), i


@pytest.mark.parametrize("knobs", KNOBS,
                         ids=lambda k: f"bits{k[0]}-rate{k[1]}")
def test_plain_encode_matches_xla_scan_and_oracle(rng, knobs):
    blocks, lens = _blocks(rng, 96)
    for apm in (False, True):
        streams, slens, deltas = bin_coder.bin_encode_indexed_plain(
            torch.from_numpy(blocks), torch.from_numpy(lens), *knobs, apm)
        for i, m in enumerate(lens):
            bits = np.unpackbits(blocks[i, :m])
            padded = np.zeros(8 * blocks.shape[1], np.uint8)
            padded[: len(bits)] = bits
            comp, clen, counts = jbin.encode_bits(
                jnp.array(padded), jnp.int32(len(bits)), *knobs,
                use_apm=apm, with_counts=True)
            got = streams[i, : slens[i]].numpy().tobytes()
            assert got == np.asarray(comp)[: int(clen)].tobytes(), (apm, i)
            assert got == _oracle(bits, *knobs, apm), (apm, i)
            np.testing.assert_array_equal(
                deltas[i].numpy(),
                np.asarray(counts).reshape(-1, jbc.CHUNK).sum(1))


def _reference(streams, deltas, nbits, model_bits, rate, apm):
    """tpuzip's decode wiring (runner._bin_decode_indexed off the TPU):
    windows prepacked from the chunk index, code0, and the XLA replica of
    the decode kernel, lanes padded to 128 -> bytes (B, NC*32)."""
    b = streams.shape[0]
    st = np.zeros((128, streams.shape[1]), np.uint8)
    st[:b] = streams.numpy()
    d = np.zeros((128, deltas.shape[1]), np.int32)
    d[:b] = deltas.numpy()
    w = jbc.bin_window_words(max(int(d.max()), 1))
    dt = jnp.array(d.T)
    wins = jrd.build_windows(jnp.array(st.T), 4 + jnp.cumsum(dt, 0) - dt, w)
    cu = st[:, :4].astype(np.uint32)
    code0 = (cu[:, 0] << 24) | (cu[:, 1] << 16) | (cu[:, 2] << 8) | cu[:, 3]
    nb = np.zeros(128, np.int32)
    nb[:b] = nbits
    bits = np.asarray(jbc.bin_decode_reference(
        wins, jnp.array(code0), jnp.array(nb), w=w, model_bits=model_bits,
        rate=rate, use_apm=apm))
    # the reference leaves the bits past each length as it computed them
    keep = np.arange(bits.shape[0])[:, None] < nb[None, :]
    return np.asarray(jbin.bits_to_bytes(jnp.array(
        np.where(keep, bits, 0).T)))[:b]


@pytest.mark.parametrize("knobs", [(12, 5, True), (10, 4, False),
                                   (11, 5, True)],
                         ids=["apm-12-5", "bin-10-4", "apm-11-5"])
def test_plain_decode_matches_reference(rng, knobs):
    *model, apm = knobs
    blocks, lens = _blocks(rng, 96)
    streams, slens, deltas = bin_coder.bin_encode_indexed_plain(
        torch.from_numpy(blocks), torch.from_numpy(lens), *model, apm)
    # rows cut to the longest stream: past-the-row bytes read as 0
    streams = streams[:, : int(slens.max())].contiguous()
    nbits = torch.from_numpy(8 * lens)
    got = bin_coder.bin_decode_indexed_plain(streams, deltas, nbits, *model,
                                             apm)
    assert got.shape == (len(lens), deltas.shape[1] * jbc.CHUNK // 8)
    exp = _reference(streams, deltas, 8 * lens, *model, apm)
    np.testing.assert_array_equal(got.numpy(), exp)
    for i, m in enumerate(lens):
        assert got[i, :m].numpy().tobytes() == blocks[i, :m].tobytes(), i
        assert not got[i, m:].any(), i


def test_one_plain_run_holds_several_knob_settings(rng):
    """Per-row knobs (how chip_smoke.py holds six kernel launches with one
    plain run) give each row what a run at its own knobs gives."""
    blocks, lens = _blocks(rng, 40)
    pairs = [(k[0], k[1], apm) for apm in (False, True) for k in KNOBS]
    rows = {name: torch.tensor([p[j] for p in pairs]).repeat_interleave(
        len(lens)) for j, name in enumerate(("model_bits", "rate",
                                             "use_apm"))}
    n = len(pairs)
    bt, lt = torch.from_numpy(blocks), torch.from_numpy(lens)
    enc = bin_coder.bin_encode_indexed_plain(bt.repeat(n, 1), lt.repeat(n),
                                             **rows)
    dec = bin_coder.bin_decode_indexed_plain(enc[0], enc[2],
                                             (8 * lt).repeat(n), **rows)
    b = len(lens)
    for j, p in enumerate(pairs):
        one = bin_coder.bin_encode_indexed_plain(bt, lt, *p)
        for x, y in zip(one, enc):
            assert torch.equal(x, y[j * b : (j + 1) * b]), p
        assert torch.equal(dec[j * b : (j + 1) * b], bin_coder.
                           bin_decode_indexed_plain(one[0], one[2], 8 * lt,
                                                    *p)), p


def test_wrappers_take_plain_versions_only_on_cpu(rng):
    blocks, lens = _blocks(rng, 40)
    bt, lt = torch.from_numpy(blocks), torch.from_numpy(lens)
    before = (bin_coder.bin_encode_indexed.launches,
              bin_coder.bin_decode_indexed.launches)
    enc = bin_coder.bin_encode_indexed(bt, lt, 11, 5, True)
    for x, y in zip(enc, bin_coder.bin_encode_indexed_plain(bt, lt, 11, 5,
                                                            True)):
        assert torch.equal(x, y)
    nb = (8 * lt).to(torch.int32)
    assert torch.equal(bin_coder.bin_decode_indexed(enc[0], enc[2], nb, 11, 5,
                                                    True),
                       bin_coder.bin_decode_indexed_plain(enc[0], enc[2], nb,
                                                          11, 5, True))
    assert (bin_coder.bin_encode_indexed.launches,
            bin_coder.bin_decode_indexed.launches) == before
    with pytest.raises(ValueError):    # neither cpu nor cuda: no plain run
        bin_coder.bin_encode_indexed(bt.to("meta"), lt.to("meta"))
    with pytest.raises(TypeError):
        bin_coder.bin_encode_indexed(bt, lt.to(torch.int64))
    with pytest.raises(ValueError):
        bin_coder.bin_decode_indexed(enc[0], enc[2][:3], nb)
    for bad in ((17, 5), (0, 5), (12, 32), (12, -1)):   # r = range >> bits
        with pytest.raises(ValueError, match="bin knobs"):
            bin_coder.bin_encode_indexed(bt, lt, *bad)
    for b, n in ((0, 5), (3, 0)):      # any B >= 0 and n >= 0
        s, sl, d = bin_coder.bin_encode_indexed(
            torch.zeros((b, n), dtype=torch.uint8),
            torch.zeros(b, dtype=torch.int32))
        assert s.shape == (b, bin_apm.encode_cap(8 * n)) and d.shape[0] == b
