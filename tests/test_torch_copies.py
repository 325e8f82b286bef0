"""The port's own copies of tpuzip's modules against the originals: block
chunking, the config tree, the error classes, the format oracles (the LZ4
block and frame codec, xxh32, rle, Adler-32 and the DEFLATE decoder among
them) and the
varint packer of core/bitio (tpuzip_torch imports nothing of tpuzip)."""

import dataclasses
import inspect

import numpy as np
import pytest

import torch

import jax.numpy as jnp

from tpuzip.core import bitio as jbitio
from tpuzip.core import blocks as jblocks
from tpuzip.core import config as jconfig
from tpuzip.oracle import adler as jadler
from tpuzip.oracle import ari as jari
from tpuzip.oracle import bwt as jbwt
from tpuzip.oracle import dc as jdc
from tpuzip.oracle import deflate as jdeflate
from tpuzip.oracle import lz4 as jlz4
from tpuzip.oracle import mtf as jmtf
from tpuzip.oracle import rle as jrle
from tpuzip.oracle import xxh32 as jxxh32
from tpuzip.runtime import errors as jerrors
import tpuzip_torch
from tpuzip_torch.core import bitio as tbitio
from tpuzip_torch.core import blocks as tblocks
from tpuzip_torch.core import config as tconfig
from tpuzip_torch.oracle import adler as tadler
from tpuzip_torch.oracle import ari as tari
from tpuzip_torch.oracle import bwt as tbwt
from tpuzip_torch.oracle import dc as tdc
from tpuzip_torch.oracle import deflate as tdeflate
from tpuzip_torch.oracle import lz4 as tlz4
from tpuzip_torch.oracle import mtf as tmtf
from tpuzip_torch.oracle import rle as trle
from tpuzip_torch.oracle import xxh32 as txxh32
from tpuzip_torch.runtime import errors as terrors


@pytest.mark.parametrize("block_size", [1, 7, 256, 4096])
def test_chunk_and_unchunk_match(samples, block_size):
    for data in samples:
        got, exp = tblocks.chunk(data, block_size), jblocks.chunk(data,
                                                                 block_size)
        for g, e in zip(got, exp):
            assert g.dtype == e.dtype
            np.testing.assert_array_equal(g, e)
        assert tblocks.unchunk(*got) == jblocks.unchunk(*exp) == data


def _non_default():
    cfg = jconfig.Config()
    cfg.codec.ari.increment, cfg.codec.ari.threshold = 16, 40000
    cfg.codec.ari.bin_bits, cfg.codec.ari.bin_rate = 10, 4
    cfg.codec.bwt.block_size, cfg.codec.bwt.use_extra_memory = 4096, False
    cfg.codec.lz4.hash_log, cfg.codec.lz4.max_chain = 14, 8
    cfg.codec.deflate.mode = "fixed"
    cfg.mesh.block_size, cfg.mesh.chips_per_host = 1 << 12, 2
    cfg.checkpoint_dir, cfg.log_level = "ckpt", "debug"
    return cfg


@pytest.mark.parametrize("make", [jconfig.Config, _non_default],
                         ids=["defaults", "non-defaults"])
def test_config_carries_across(make):
    src = make()
    got = tconfig.config_from_dict(dataclasses.asdict(src))
    assert isinstance(got, tconfig.Config)
    assert isinstance(got.codec.bwt, tconfig.BwtConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(src)
    assert tpuzip_torch.Config is tconfig.Config
    assert tpuzip_torch.CodecConfig is tconfig.CodecConfig


def test_config_defaults_and_unknown_keys():
    assert dataclasses.asdict(tconfig.Config()) == \
        dataclasses.asdict(jconfig.Config())
    partial = tconfig.config_from_dict({"codec": {"bwt": {"block_size": 9}}})
    assert partial.codec.bwt.block_size == 9
    assert partial.codec.ari.increment == 8
    with pytest.raises(TypeError, match="no field"):
        tconfig.config_from_dict({"codec": {"bwt": {"blocksize": 9}}})


def _classes(module):
    return {n: c for n, c in inspect.getmembers(module, inspect.isclass)
            if c.__module__ == module.__name__}


def test_error_classes_same_names_and_hierarchy():
    mine, ref = _classes(terrors), _classes(jerrors)
    assert mine.keys() == ref.keys()
    for name, cls in mine.items():
        assert [c.__name__ for c in cls.__mro__] == \
            [c.__name__ for c in ref[name].__mro__], name
    assert issubclass(terrors.TpzError, ValueError)
    err = terrors.CorruptStreamError(range(10))
    assert str(err) == str(jerrors.CorruptStreamError(range(10)))
    assert err.block_ids == list(range(10))


@pytest.mark.parametrize("knobs", [(8, 1 << 13), (16, 512)],
                         ids=lambda k: f"inc{k[0]}-thr{k[1]}")
def test_ari_oracle_same_bytes(samples, knobs):
    for data in samples:
        if len(data) > 8192:
            continue
        comp = tari.encode_bytes(data, *knobs)
        assert comp == jari.encode_bytes(data, *knobs)
        assert tari.decode_bytes(comp, len(data), *knobs) == data


def test_mtf_and_bwt_oracles_same_bytes(samples):
    for data in samples:
        enc = tmtf.encode(data)
        assert enc == jmtf.encode(data)
        assert tmtf.decode(enc) == jmtf.decode(enc) == data
        if len(data) > 8192:
            continue
        L, origin = tbwt.encode_block(data)
        assert (L, origin) == jbwt.encode_block(data)
        assert tbwt.decode_block(L, origin) == data
        np.testing.assert_array_equal(
            tbwt.rotation_sort(np.frombuffer(data, np.uint8)),
            jbwt.rotation_sort(np.frombuffer(data, np.uint8)))


def test_dc_oracle_same_bytes(samples):
    for data in samples:
        if len(data) > 8192:
            continue
        enc = tdc.encode(data)
        assert enc == jdc.encode(data)
        assert tdc.decode(enc) == jdc.decode(enc) == data
    bad = bytearray(tdc.encode(b"abcabcabc" * 30))
    bad[-1] = 0x7F                                   # a bad last distance
    for mod in (tdc, jdc):
        with pytest.raises(ValueError, match="DC decode"):
            mod.decode(bytes(bad))


@pytest.mark.parametrize("hash_log", [12, 16])
def test_lz4_block_oracle_same_bytes(samples, hash_log):
    """The block half of tpuzip/oracle/lz4.py: the same streams, each
    decoder reads the other's, the same bound and hash."""
    for data in samples:
        if len(data) > 8192:
            continue
        comp = tlz4.compress_block(data, hash_log)
        assert comp == jlz4.compress_block(data, hash_log)
        assert len(comp) <= tlz4.worst_case_size(len(data)) \
            == jlz4.worst_case_size(len(data))
        assert tlz4.decompress_block(comp) == jlz4.decompress_block(comp) \
            == data
    for seq in (0, 1, 0x61626364, 0xFFFFFFFF):
        assert tlz4._hash(seq, hash_log) == jlz4._hash(seq, hash_log)
    for mod in (tlz4, jlz4):
        with pytest.raises(ValueError, match="zero offset"):
            mod.decompress_block(b"\x10a\x00\x00")


@pytest.mark.parametrize("seed", [0, 1, 0xFFFFFFFF])
def test_xxh32_oracle_same_hashes(samples, seed):
    """oracle/xxh32.py: the same hash, one call and streamed in pieces."""
    for data in samples:
        assert txxh32.xxh32(data, seed) == jxxh32.xxh32(data, seed)
        mine, theirs = txxh32.Xxh32State(seed), jxxh32.Xxh32State(seed)
        for k in range(0, len(data), 1000):
            mine.update(data[k : k + 1000])
            theirs.update(data[k : k + 1000])
        assert mine.digest() == theirs.digest() == jxxh32.xxh32(data, seed)


@pytest.mark.parametrize("block_checksum", [False, True])
def test_lz4_frame_oracle_same_bytes(samples, block_checksum):
    """The frame half of tpuzip/oracle/lz4.py: the same frames, each reader
    reads the other's; the same constants."""
    assert tlz4.MAGIC == jlz4.MAGIC
    assert tlz4._BD_MAX_SIZES == jlz4._BD_MAX_SIZES
    for data in samples:
        if len(data) > 8192:
            continue
        frame = tlz4.compress_frame(data, 1 << 16, True, block_checksum)
        assert frame == jlz4.compress_frame(data, 1 << 16, True,
                                            block_checksum)
        assert tlz4.decompress_frame(frame) == \
            jlz4.decompress_frame(frame) == data
    window = bytearray(b"0123456789" * 10)
    block = bytes([0x0F]) + b"\x64\x00" + bytes([0x01]) + b"\x10z"
    assert tlz4._decompress_linked(block, window, 1 << 16) == \
        jlz4._decompress_linked(block, window, 1 << 16)


def test_adler_oracle_same_sums(samples):
    """adler32, State32 fed in pieces and combine (zlib's adler32_combine,
    which the corpus checksum folds with) against the original and
    zlib."""
    import zlib

    for data in samples:
        assert tadler.adler32(data) == jadler.adler32(data) == \
            zlib.adler32(data)
        st = tadler.State32()
        for o in range(0, len(data), 777):
            st.feed(data[o : o + 777])
        assert st.result() == zlib.adler32(data)
        for cut in (0, len(data) // 3, len(data)):
            a, b = data[:cut], data[cut:]
            assert tadler.combine(zlib.adler32(a), zlib.adler32(b), len(b)) \
                == jadler.combine(zlib.adler32(a), zlib.adler32(b), len(b)) \
                == zlib.adler32(data)
    assert tadler.adler32(b"abc", start=7) == jadler.adler32(b"abc", start=7)


def test_rle_oracle_same_bytes(samples):
    runs = b"x" * 255 + b"y" * 256 + b"z" * 257 + b"aabbcc"
    for data in samples + [runs]:
        enc = trle.encode(data)
        assert enc == jrle.encode(data)
        assert trle.decode(enc) == jrle.decode(enc) == data
        for got, exp in zip(trle.runs_of(data), jrle.runs_of(data)):
            np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("knobs", [(12, 5), (10, 4), (11, 5)],
                         ids=lambda k: f"bits{k[0]}-rate{k[1]}")
def test_bin_apm_models_same_states(rng, knobs):
    """BinaryModel, ApmBit and ApmGate step for step: the range of each bit,
    the gate's interpolated probability and every cell after it."""
    bits = (rng.random(3000) < 0.2).astype(int).tolist()
    mine = (tari.BinaryModel(*knobs), tari.ApmGate())
    ref = (jari.BinaryModel(*knobs), jari.ApmGate())
    for bit in bits:
        got = [(m.get_range(bit), m.get_denominator(), g.pass_through(m.p0),
                m.find_value(m.p0 - 1)) for m, g in (mine, ref)]
        assert got[0] == got[1]
        for m, g in (mine, ref):
            g.update(bit, 5)
            m.update(bit)
        assert [c.p0 for c in mine[1].cells] == [c.p0 for c in ref[1].cells]
    assert tari.ApmBit().predict() == jari.ApmBit().predict() == 2048


def test_bitio_varint_packer_matches(rng):
    """exclusive_cumsum, and pack_bytes_varlen against both of tpuzip's
    packers (scatter and sort), row by row, with bytes falling past the
    capacity."""
    t, k = 50, 5
    chunks = rng.integers(0, 256, (3, t, k), dtype=np.uint8)
    lens = rng.integers(0, k + 1, (3, t)).astype(np.int32)
    lens[2] = k                                      # overflows cap
    cap = 160
    np.testing.assert_array_equal(
        tbitio.exclusive_cumsum(torch.from_numpy(lens)).numpy()[0],
        np.asarray(jbitio.exclusive_cumsum(jnp.array(lens[0]))))
    out, total = tbitio.pack_bytes_varlen(torch.from_numpy(chunks),
                                          torch.from_numpy(lens), cap)
    for i in range(3):
        for jpack in (jbitio.pack_bytes_varlen,
                      jbitio.pack_bytes_varlen_sorted):
            e_out, e_total = jpack(jnp.array(chunks[i]), jnp.array(lens[i]),
                                   cap)
            np.testing.assert_array_equal(out[i].numpy(), np.asarray(e_out))
            assert int(total[i]) == int(e_total)


def test_deflate_tables_and_codes_match():
    """The length and distance tables, their code lookups and
    canonical_codes equal tpuzip's oracle."""
    for name in ("CLCL_ORDER", "LENGTH_TABLE", "DIST_TABLE", "MAX_BITS",
                 "MAX_CL_BITS", "WINDOW", "MIN_MATCH", "MAX_MATCH"):
        assert getattr(tdeflate, name) == getattr(jdeflate, name), name
    for length in range(3, 259):
        assert tdeflate.length_to_code(length) == \
            jdeflate.length_to_code(length)
    for dist in range(1, 32769):
        assert tdeflate.dist_to_code(dist) == jdeflate.dist_to_code(dist)
    for lens in ([2, 1, 3, 3], [0, 0, 5], tdeflate.fixed_lit_lengths(),
                 tdeflate.fixed_dist_lengths(), []):
        assert tdeflate.canonical_codes(lens) == \
            jdeflate.canonical_codes(lens)


def test_deflate_package_merge_matches(samples):
    """package_merge (the oracle's tuple order, tpuzip's device deflate
    rule) equals the original on each sample's byte histogram at 15 and 7
    bits, on tie-heavy histograms and on the edges (no symbol, one, and an
    alphabet past 2^limit, ValueError in both)."""
    hists = [dict(enumerate(np.bincount(np.frombuffer(d, np.uint8),
                                        minlength=256).tolist()))
             for d in samples]
    hists += [dict.fromkeys(range(286), 7), {s: 1 + s % 3 for s in range(30)},
              {s: 1 << s % 9 for s in range(19)}, {}, {5: 9}, {0: 0, 3: 2}]
    for freqs in hists:
        for limit in (15, 7):
            if sum(1 for f in freqs.values() if f) > 1 << limit:
                continue
            assert tdeflate.package_merge(freqs, limit) == \
                jdeflate.package_merge(freqs, limit)
    for pm in (tdeflate.package_merge, jdeflate.package_merge):
        with pytest.raises(ValueError):
            pm(dict.fromkeys(range(9), 1), 3)


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_deflate_decoder_same_output(samples, level):
    """decompress_ex on zlib's raw streams of every sample equals the
    original's, bytes consumed included; a corrupt stream raises ValueError
    in both."""
    import zlib

    for data in samples:
        stream = zlib.compress(data, level)[2:-4] + b"tail"
        assert tdeflate.decompress_ex(stream) == \
            jdeflate.decompress_ex(stream)
        assert tdeflate.decompress(stream) == data
    for bad in (b"\x07", b"\x04\x00", b""):
        with pytest.raises(ValueError):
            jdeflate.decompress(bad)
        with pytest.raises(ValueError):
            tdeflate.decompress(bad)
