"""The port's plain ari encoder against tpuzip: the XLA scan
``codecs.ari.encode_with_counts`` (streams, lengths, chunk deltas), the
oracle, and the packed model state of the JAX kernels after halvings.
The CUDA kernel is held against this plain version on the card
(chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpuzip.codecs import ari as jari
from tpuzip.kernels import range_coder as jrc
from tpuzip.kernels import range_decoder as jrd
from tpuzip.oracle import ari as oari
from tpuzip_torch.codecs.ari import encode_cap
from tpuzip_torch.kernels import range_coder as trc
from tpuzip_torch.kernels import range_decoder as trd

N = 1024
KNOBS = [(8, 1 << 13), (8, 512), (16, 40000)]   # the last is past 2^15


def _blocks(rng):
    text = (b"the quick brown fox jumps over the lazy dog; " * 40)[:N]
    zipf = 1.0 / np.arange(1, 257) ** 1.3
    rows = [np.frombuffer(text, np.uint8),
            rng.integers(0, 256, N),
            np.full(N, 77),
            rng.integers(0, 4, N),
            rng.integers(0, 256, N),
            rng.choice(256, N, p=zipf / zipf.sum())]
    blocks = np.stack(rows).astype(np.uint8)
    lens = np.array([N, N, N, 777, 0, N - 5], np.int32)   # ragged, empty
    for i, n in enumerate(lens):
        blocks[i, n:] = 0
    return blocks, lens


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: f"inc{k[0]}-thr{k[1]}")
def test_plain_encode_matches_xla_scan_and_oracle(rng, knobs):
    inc, thr = knobs
    blocks, lens = _blocks(rng)
    streams, slens, deltas = trc.ari_encode_indexed_plain(
        torch.from_numpy(blocks), torch.from_numpy(lens), inc, thr)
    assert streams.shape == (len(lens), encode_cap(N))
    assert deltas.shape == (len(lens), N // trd.CHUNK_STEPS)
    comp, clens, counts = jax.jit(jax.vmap(
        lambda b, n: jari.encode_with_counts(b, n, increment=inc,
                                             threshold=thr)))(
        jnp.array(blocks), jnp.array(lens))
    comp, clens = np.asarray(comp), np.asarray(clens)
    exp_deltas = np.asarray(counts).reshape(len(lens), -1,
                                            trd.CHUNK_STEPS).sum(2)
    np.testing.assert_array_equal(slens.numpy(), clens)
    np.testing.assert_array_equal(deltas.numpy(), exp_deltas)
    for i, n in enumerate(lens):
        row = streams[i].numpy()
        assert row[: clens[i]].tobytes() == comp[i, : clens[i]].tobytes(), i
        assert not row[clens[i]:].any(), i          # zero-filled past length
        assert row[: clens[i]].tobytes() == oari.encode_bytes(
            blocks[i, :n].tobytes(), inc, thr), i
    assert slens[4] == 4            # an empty block keeps its 4 finish bytes


def _packed_step(cum, tot, sym, active, inc, thr):
    """tpuzip's encoder model update on the packed table (the body of
    ``_ari_encode_kernel``), then its gated halving."""
    iota = jnp.arange(128, dtype=jnp.int32)[:, None]
    p, odd = sym >> 1, (sym & 1) == 1
    both, hi = jnp.int32(inc | (inc << 16)), jnp.int32(inc << 16)
    rowadd = (jnp.where(iota > p[None, :], both, 0)
              + jnp.where(iota == p[None, :], jnp.where(odd, hi, both), 0))
    cum = cum + jnp.where(active[None, :], rowadd, 0)
    tot = jnp.where(active, tot + inc, tot)
    return jrc._enc_halving_gated(cum, tot, active, thr)


def test_model_state_after_halving_matches_packed(rng):
    """The port's model (unpacked int64 table) equals the JAX kernels'
    u16-pair-packed state, read through packed_cum_to_cum, across many
    halvings (threshold 512: one every ~32 symbols)."""
    lanes, steps, inc, thr = 16, 300, 8, 512
    syms = rng.integers(0, 256, (steps, lanes))
    syms[:, 1] = rng.integers(0, 3, steps)           # skewed lane
    act = rng.random((steps, lanes)) < 0.9
    act[:, 2] = False                                # frozen lane
    jcum, jtot = jrd._packed_cum_init(lanes), jnp.full(lanes, 256, jnp.int32)
    cum, tot = trd.model_init(lanes, "cpu")
    step = jax.jit(_packed_step, static_argnums=(4, 5))
    halvings = 0
    for t in range(steps):
        s, a = syms[t], act[t]
        jcum, jtot = step(jcum, jtot, jnp.array(s, jnp.int32),
                          jnp.array(a), inc, thr)
        before = tot.clone()
        cum, tot = trd.model_update(cum, tot, torch.from_numpy(s),
                                    torch.from_numpy(a), inc, thr)
        halvings += int((tot < before).sum())
        if t % 25 == 0 or t == steps - 1:
            torch.testing.assert_close(trd.packed_cum_to_cum(jcum), cum,
                                       rtol=0, atol=0)
            np.testing.assert_array_equal(np.asarray(jtot), tot.numpy())
    assert halvings > 50


def test_lane_width_matches():
    for b in (1, 127, 128, 129, 600, 1024, 5000):
        assert trc.lane_width(b) == jrc.lane_width(b)


def test_wrapper_takes_plain_version_only_on_cpu(rng):
    blocks, lens = _blocks(rng)
    bt, lt = torch.from_numpy(blocks), torch.from_numpy(lens)
    before = trc.ari_encode_indexed.launches
    got = trc.ari_encode_indexed(bt, lt)
    exp = trc.ari_encode_indexed_plain(bt, lt)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    assert trc.ari_encode_indexed.launches == before   # no kernel ran
    with pytest.raises(ValueError):    # neither cpu nor cuda: no plain run
        trc.ari_encode_indexed(bt.to("meta"), lt.to("meta"))
    with pytest.raises(TypeError):
        trc.ari_encode_indexed(bt.to(torch.int32), lt)
    with pytest.raises(ValueError):
        trc.ari_encode_indexed(bt, lt[:-1])
    with pytest.raises(ValueError):    # past the coder's 2^16 bound
        trc.ari_encode_indexed(bt, lt, increment=16, threshold=65530)
