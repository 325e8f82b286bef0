"""The port's own copies of tpuzip's jax-free modules against the
originals: block chunking, the config tree, the error classes and the
format oracles (tpuzip_torch imports nothing of tpuzip)."""

import dataclasses
import inspect

import numpy as np
import pytest

from tpuzip.core import blocks as jblocks
from tpuzip.core import config as jconfig
from tpuzip.oracle import ari as jari
from tpuzip.oracle import bwt as jbwt
from tpuzip.oracle import mtf as jmtf
from tpuzip.runtime import errors as jerrors
import tpuzip_torch
from tpuzip_torch.core import blocks as tblocks
from tpuzip_torch.core import config as tconfig
from tpuzip_torch.oracle import ari as tari
from tpuzip_torch.oracle import bwt as tbwt
from tpuzip_torch.oracle import mtf as tmtf
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
