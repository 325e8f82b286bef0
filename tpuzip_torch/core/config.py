"""Configuration tree of the port: a copy of tpuzip/core/config.py, with the
same dataclasses, fields and defaults.

The codec knobs (BWT block size, ari increment and threshold, ...) are what
a compressor carries the way a model carries weights: ``config_from_dict``
builds the port's Config from ``dataclasses.asdict`` of a tpuzip Config, so
a tpuzip configuration carries across unchanged.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Optional


@dataclasses.dataclass
class Lz4Config:
    block_max: int = 1 << 20        # frame BD max block size (64K..4M)
    content_checksum: bool = True
    block_checksum: bool = False
    hash_log: int = 16              # encoder hash table = 2^hash_log entries
    device_encode: bool = False     # force the batch encoder in the
    #                                 runner (default: C++ host encoder)
    max_chain: int = 1              # match-search chain depth: 1 = the
    #                                 reference-identical single-probe
    #                                 greedy; >1 = denser matches, smaller
    #                                 output (same format)


@dataclasses.dataclass
class AriConfig:
    increment: int = 8              # table model frequency increment
    threshold: int = 1 << 13        # downscale-halving threshold
    bin_bits: int = 12              # bin/apm model probability precision
    #                                 (codecs "bin"/"apm"; recorded in the
    #                                 container's flag-4 trailer)
    bin_rate: int = 5               # bin/apm model adaptation shift


@dataclasses.dataclass
class BwtConfig:
    block_size: int = 1 << 20       # reference Encoder block-size knob
    use_extra_memory: bool = True   # reference Decoder knob (fast inverse)


@dataclasses.dataclass
class DeflateConfig:
    mode: str = "dynamic"           # stored | fixed | dynamic
    max_chain: int = 128            # LZ77 hash-chain search depth


@dataclasses.dataclass
class CodecConfig:
    lz4: Lz4Config = dataclasses.field(default_factory=Lz4Config)
    ari: AriConfig = dataclasses.field(default_factory=AriConfig)
    bwt: BwtConfig = dataclasses.field(default_factory=BwtConfig)
    deflate: DeflateConfig = dataclasses.field(default_factory=DeflateConfig)


@dataclasses.dataclass
class MeshConfig:
    """Device mesh shape of tpuzip's data-parallel pipeline.  The port runs
    on one device and reads only ``block_size`` (the default block size of
    the codecs other than bwt and bwtdc)."""
    chips_per_host: int = 0         # 0 = all local devices (mesh width)
    block_size: int = 1 << 16       # bytes per independent block (DP grain)
    blocks_per_chip: int = 8        # batch width per device per superbatch


@dataclasses.dataclass
class Config:
    codec: CodecConfig = dataclasses.field(default_factory=CodecConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    checkpoint_dir: Optional[str] = None
    log_level: str = "info"


def _build(cls, d: dict):
    """An instance of dataclass `cls` from the dict `d`, nested dataclass
    fields built the same way; an unknown key raises TypeError."""
    unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise TypeError(f"{cls.__name__} has no field(s) {sorted(unknown)}")
    types = typing.get_type_hints(cls)
    return cls(**{k: _build(types[k], v) if dataclasses.is_dataclass(types[k])
                  else v for k, v in d.items()})


def config_from_dict(d: dict) -> Config:
    """The port's Config from ``dataclasses.asdict(cfg)`` of a tpuzip
    Config (or any dict of the same tree); missing keys keep defaults."""
    return _build(Config, d)
