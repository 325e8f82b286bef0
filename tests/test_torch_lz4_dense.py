"""tpuzip's device LZ4 encoder (tpuzip/codecs/lz4.py:179 ``encode``, the
XLA one that compress_from_device and device_encode=True run) against the
port's kernels/lz4_dense.py, whose plain versions run here on the CPU; the
CUDA kernels of csrc/lz4_dense.cu are held against them on the card by
chip_smoke.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpuzip.codecs import lz4 as jlz4
from tpuzip.core.config import Config
from tpuzip.dist import mesh as meshlib
from tpuzip.dist import runner as jrun
import chip_smoke
import tpuzip_torch
from tpuzip_torch.core.config import config_from_dict
from tpuzip_torch.kernels import lz4_dense, lz4_links

MESH1 = meshlib.make_mesh(1)
with open(__file__.rsplit("/tests/", 1)[0] + "/SURVEY.md", "rb") as _f:
    TEXT = _f.read()
N = 4096
HASH_LOGS = [0, 4, 15, 16, 20, 32, 40]
XLA_ENCODE = jax.jit(jlz4.encode_batch, static_argnums=2)


def _shadowed_row(n: int) -> np.ndarray:
    """A row where, at hash_log 4, the nearest earlier position with the
    hash of the last 4 bytes holds other bytes, and an older one the same:
    X, filler, Y, filler, X with h(X) == h(Y) and no filler window of that
    hash."""
    def h4(b):
        return (int.from_bytes(b, "little") * 2654435761 & 0xFFFFFFFF) >> 28

    rng = np.random.default_rng(4)
    for x in (bytes(c) for c in rng.integers(97, 123, (4096, 4), np.uint8)):
        y = next(bytes(c) for c in rng.integers(97, 123, (4096, 4), np.uint8)
                 if bytes(c) != x and h4(bytes(c)) == h4(x))
        row = next((r for r in (x + bytes([f]) * 40 + y + bytes([f]) * 40
                                + x + bytes([f]) * 30 for f in range(256))
                    # y's and the last x's windows have x's hash, no other
                    if [h4(r[p : p + 4]) for p in range(1, len(r) - 4)
                        ].count(h4(x)) == 2), None)
        if row:
            break
    out = np.zeros(n, np.uint8)
    out[: len(row)] = np.frombuffer(row, np.uint8)
    return out


def _rows():
    """(16, N) rows and lengths: text; random; constant; lengths 0, 1, 12,
    13 and 14; periods 2 to 31; random bytes past a length of 3000; the
    shadowed row; text with runs; 4 symbols; Zipf bytes; runs of 255 to 700;
    text whose tail repeats its head."""
    rng = np.random.default_rng(11)
    text = np.frombuffer(TEXT[:N], np.uint8)
    periods = np.concatenate([np.resize(rng.integers(0, 256, p), 136)
                              for p in range(2, 32)])[:N]
    periods = np.pad(periods, (0, N - len(periods)))
    mixed = text.copy()
    for at in range(0, N - 700, 900):
        mixed[at : at + rng.integers(256, 700)] = rng.integers(0, 256)
    zipf = 1.0 / np.arange(1, 257) ** 1.3
    echo = text.copy()
    echo[N // 2:] = text[: N - N // 2]
    rows = [text, rng.integers(0, 256, N), np.full(N, 0x41)] + [text] * 5 + [
        periods, np.frombuffer(TEXT[N : 2 * N], np.uint8).copy(),
        _shadowed_row(N), mixed, rng.integers(0, 4, N),
        rng.choice(256, N, p=zipf / zipf.sum()),
        np.repeat(rng.integers(0, 256, N), rng.integers(255, 701, N))[:N],
        echo]
    lens = [N, N, N, 0, 1, 12, 13, 14, N, 3000, 200] + [N] * 5
    rows = np.stack(rows).astype(np.uint8)
    # zero past each length except the row whose bytes there are random
    for r, ln in enumerate(lens):
        if r != 9:
            rows[r, ln:] = 0
    rows[9, 3000:] = rng.integers(0, 256, N - 3000)
    return rows, np.array(lens, np.int32)


ROWS, LENS = _rows()


def _xla(blocks, lens, hash_log):
    comp, clens = XLA_ENCODE(blocks, lens, hash_log)
    comp, clens = np.asarray(comp), np.asarray(clens)
    return [comp[r, : clens[r]].tobytes() for r in range(len(clens))]


def _port(blocks, lens, hash_log):
    comp, clens = lz4_dense.lz4_dense_encode_batch(
        torch.from_numpy(blocks), torch.from_numpy(lens), hash_log)
    assert not comp.numpy()[np.arange(comp.shape[1])[None, :]
                            >= clens.numpy()[:, None]].any()
    return [comp[r, : clens[r]].numpy().tobytes() for r in range(len(clens))]


@pytest.mark.parametrize("hash_log", HASH_LOGS)
def test_plain_encoder_equals_xla(hash_log):
    """The plain candidates equal XLA's _candidates and the streams XLA's
    encode_batch, row by row; each stream decodes back."""
    counters = (lz4_dense.lz4_dense_words, lz4_dense.lz4_dense_words_links,
                lz4_dense.lz4_dense_words_parse, lz4_links.lz4_links_tiled,
                lz4_links.lz4_links_sorted)
    before = [f.launches for f in counters]
    assert _port(ROWS, LENS, hash_log) == _xla(ROWS, LENS, hash_log)
    got = lz4_dense.lz4_dense_candidates_plain(
        torch.from_numpy(ROWS), torch.from_numpy(LENS), hash_log)
    ref = jax.vmap(lambda b, n: jlz4._candidates(b, n, hash_log))(ROWS, LENS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the wrappers ran their plain versions on the CPU: no launch counted
    assert [f.launches for f in counters] == before
    for st, row, ln in zip(_port(ROWS, LENS, hash_log), ROWS, LENS):
        assert chip_smoke.olz4.decompress_block(st) == row[:ln].tobytes()


def test_shadowed_candidate_is_refused():
    """At hash_log 4 the shadowed row's last X takes Y's position, fails the
    4-byte check and gets -1, though the older X would pass it."""
    row = torch.from_numpy(ROWS[10:11])
    cand = lz4_dense.lz4_dense_candidates_plain(row, torch.tensor([200]), 4)
    last_x = 44 + 4 + 40
    assert int(cand[0, last_x]) == -1
    assert ROWS[10, last_x : last_x + 4].tobytes() == ROWS[10, :4].tobytes()
    whole = lz4_dense.lz4_dense_candidates_plain(row, torch.tensor([200]), 16)
    assert int(whole[0, last_x]) == 0


@pytest.mark.parametrize("hash_log", [15, 20])
def test_far_repeats_equal_xla(hash_log):
    """128 KiB rows whose repeats lie 65,533 to 70,000 bytes back, and of
    periods 65,535 and 65,536 (chip_smoke.far_rows): the offsets up to
    65,535 are taken and the others refused, as in XLA."""
    rows, lens = chip_smoke.far_rows(chip_smoke.SEED + 9)
    rows, lens = rows[[0, 1, 2, 3, 4, 6, 7]], lens[[0, 1, 2, 3, 4, 6, 7]]
    got = _port(rows, lens, hash_log)
    assert got == _xla(rows, lens, hash_log)
    offs = [max(chip_smoke.lz4_offsets(st)) for st in got[:5]]
    assert offs[:3] == [65533, 65534, 65535] and max(offs[3:]) < 65533


@pytest.mark.parametrize("hash_log", [0, 15, 16, 40])
def test_device_encode_container_identical(hash_log):
    """compress(config.codec.lz4.device_encode=True) at the config's
    hash_log, unclamped, against tpuzip's (its XLA encoder), max_chain
    ignored as tpuzip ignores it there; each package decodes the other's."""
    cfg = Config()
    cfg.codec.lz4.device_encode = True
    cfg.codec.lz4.hash_log = hash_log
    cfg.codec.lz4.max_chain = 8
    data = TEXT[:3 * N] + bytes(1500) + b"ab" * 600
    mine = tpuzip_torch.compress(
        data, block_size=N, device="cpu",
        config=config_from_dict(dataclasses.asdict(cfg)))
    ref = jrun.compress(data, block_size=N, mesh=MESH1, config=cfg)
    assert mine == ref
    assert tpuzip_torch.decompress(ref, device="cpu") == data
    assert jrun.decompress(mine, mesh=MESH1) == data
