#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

The main path is the ari codec's chunk-indexed container round trip,
``tpuzip_torch.compress(codec="ari")`` then ``tpuzip_torch.decompress``,
through the two hand-written kernels tpuzip_torch/csrc/ari_encode.cu and
ari_decode.cu.  Phases, one JSON line each:

1. device   needs torch.cuda; prints nvidia-smi's name and power limit.
2. build    builds both kernels from the checkout (one nvcc each, at once).
3. kernels  each kernel against its plain PyTorch version on the same
            CUDA tensors (128 blocks x 2048 symbols of skewed, random,
            constant, ragged and empty blocks), exact to the byte, at the
            default knobs, at threshold=512 and at (16, 40000), past the
            2^15 bound of tpuzip's packed kernels; times side by side.
4. main     a 64 MiB text-like corpus made from a fixed seed, 64 KiB
            blocks (1024 blocks): compress + decompress on cuda, the bytes
            round-trip, the streams equal tpuzip.oracle.ari on 4 blocks and
            the C++ coder (tpuzip.runtime.native, built with make) on every
            block; both kernels' launch counts > 0; each kernel's one
            launch on that path held, exact, against its plain version on
            the very tensors the path gave it; encode/decode MB/s, a device
            trace and a host profile of one more compress and decompress.

Then the nvidia-smi line, a {"kernels": [...]} line (times at the main
path's shape) and, last, {"ok": true, "device": {...}}.  Any failure exits
non-zero before those.  Imports no JAX: tpuzip's oracle and C++ coder are
jax-free.
"""

from __future__ import annotations

import contextlib
import json
import struct
import subprocess
import sys
import time

import numpy as np
import torch

import tpuzip_torch
from tpuzip_torch.kernels import _build, range_coder, range_decoder

SEED = 20261016
KNOBS = ((8, 1 << 13), (8, 512), (16, 40000))   # (increment, threshold)
BLOCK = 1 << 16
CORPUS_BYTES = 64 << 20   # 1024 blocks: the JAX bench's headline shape


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def text_corpus(nbytes: int, seed: int) -> bytes:
    """Text-like bytes: Zipf-distributed words over a skewed alphabet,
    separated by spaces, some punctuation and line breaks."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
    lp = 1.0 / np.arange(1, len(letters) + 1) ** 0.9
    vocab, maxl = 8192, 12
    wlen = rng.integers(1, maxl + 1, vocab)
    words = rng.choice(letters, size=(vocab, maxl), p=lp / lp.sum())
    wp = 1.0 / np.arange(1, vocab + 1) ** 1.1
    wp /= wp.sum()
    ntok = int(nbytes / ((wlen * wp).sum() + 1) * 1.2) + 64
    tok = rng.choice(vocab, size=ntok, p=wp)
    tlen = wlen[tok] + 1                        # the word and a separator
    ends = np.cumsum(tlen)
    ntok = int(np.searchsorted(ends, nbytes)) + 1
    tok, tlen, ends = tok[:ntok], tlen[:ntok], ends[:ntok]
    at = np.repeat(np.arange(ntok), tlen)[:nbytes]
    off = np.arange(nbytes) - (ends - tlen)[at]
    out = words[tok[at], np.minimum(off, maxl - 1)]
    sep = off == wlen[tok[at]]
    seps = np.frombuffer(b"      ,.\n", np.uint8)
    out[sep] = seps[rng.integers(0, len(seps), int(sep.sum()))]
    return out.tobytes()


def mixed_blocks(b: int, n: int, seed: int):
    """(b, n) u8 blocks and lengths: skewed, random, constant, small
    alphabet and text, full or ragged, and empty blocks."""
    rng = np.random.default_rng(seed)
    text = np.frombuffer(text_corpus(b * n, seed + 1), np.uint8)
    zipf = 1.0 / np.arange(1, 257) ** 1.3
    blocks = np.zeros((b, n), np.uint8)
    lens = np.full(b, n, np.int32)
    for i in range(b):
        kind = i % 8
        if kind == 0:
            blocks[i] = rng.choice(256, n, p=zipf / zipf.sum())
        elif kind == 1:
            blocks[i] = rng.integers(0, 256, n)
        elif kind == 2:
            blocks[i] = rng.integers(0, 256)
        elif kind == 3:
            blocks[i] = rng.integers(0, 4, n)
        else:
            blocks[i] = text[i * n : (i + 1) * n]
        if kind in (5, 6):
            lens[i] = rng.integers(1, n)           # ragged
        elif kind == 7 and i % 16 == 7:
            lens[i] = 0                            # empty
        blocks[i, lens[i]:] = 0
    return blocks, lens


def phase_build() -> None:
    t0 = time.perf_counter()
    secs = _build.build("ari_encode", "ari_decode")
    range_coder._lib()
    range_decoder._lib()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds={k: round(v, 3) for k, v in secs.items()})


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def timed(fn):
    """(fn(), its milliseconds between two CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def phase_kernels() -> dict:
    """Each kernel against its plain version, same CUDA inputs, exact.
    Returns each kernel's max_abs_err over the knob pairs."""
    blocks_np, lens_np = mixed_blocks(128, 2048, SEED)
    blocks = torch.from_numpy(blocks_np).cuda()
    lens = torch.from_numpy(lens_np).cuda()
    errs = {"ari_encode": 0, "ari_decode": 0}
    for inc, thr in KNOBS:
        enc = range_coder.ari_encode_indexed(blocks, lens, inc, thr)
        enc_ref, enc_plain_ms = timed(
            lambda: range_coder.ari_encode_indexed_plain(blocks, lens, inc,
                                                         thr))
        streams, slens, deltas = enc
        dec = range_decoder.ari_decode_indexed(streams, deltas, lens, inc, thr)
        dec_ref, dec_plain_ms = timed(
            lambda: range_decoder.ari_decode_indexed_plain(streams, deltas,
                                                           lens, inc, thr))
        enc_err = max(max_err(x, y) for x, y in zip(enc, enc_ref))
        dec_err = max_err(dec, dec_ref)
        keep = torch.arange(2048, device="cuda")[None, :] < lens[:, None]
        round_trip = bool(torch.equal(torch.where(keep, dec, 0), blocks))
        times = {}
        if (inc, thr) == KNOBS[0]:
            times = {
                "encode_ms": cuda_ms(lambda: range_coder.ari_encode_indexed(
                    blocks, lens, inc, thr), 10),
                "encode_plain_ms": enc_plain_ms,
                "decode_ms": cuda_ms(
                    lambda: range_decoder.ari_decode_indexed(
                        streams, deltas, lens, inc, thr), 10),
                "decode_plain_ms": dec_plain_ms,
            }
        emit("kernels", increment=inc, threshold=thr, blocks=128,
             symbols=2048, encode_max_abs_err=enc_err,
             decode_max_abs_err=dec_err, round_trip=round_trip,
             stream_bytes=int(slens.sum()), **times)
        if enc_err or dec_err or not round_trip:
            raise AssertionError(f"kernel and plain version disagree at "
                                 f"knobs ({inc}, {thr})")
        errs["ari_encode"] = max(errs["ari_encode"], enc_err)
        errs["ari_decode"] = max(errs["ari_decode"], dec_err)
    return errs


def payload_streams(blob: bytes):
    """(chunk index, stream) of every block of a container with flag 2,
    parsed here so the check does not lean on the code under test."""
    flags = blob[5]
    nb = struct.unpack_from("<I", blob, 10)[0]
    clens = np.frombuffer(blob, "<u4", nb, 26)
    off = 26 + 4 * nb + (4 * nb if flags & 1 else 0) + (6 if flags & 4 else 0)
    out = []
    for n in clens:
        (idxlen,) = struct.unpack_from("<I", blob, off)
        out.append((blob[off + 4 : off + 4 + idxlen],
                    blob[off + 4 + idxlen : off + int(n)]))
        off += int(n)
    return out


def traced(fn) -> dict:
    """One more run of fn under torch.profiler: wall time, the time of the
    device's own events (kernels and copies; host ops that launched them and
    the profiler's buffer requests left out) and the ones that took most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if (e.device_type != DeviceType.CUDA
                or e.key.startswith("Activity Buffer")):
            continue
        us = e.self_device_time_total
        if us > 0:
            rows.append((us / 1e3, e.key[:80]))
    rows.sort(reverse=True)
    device_ms = sum(ms for ms, _ in rows)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": 1 - device_ms / wall_ms,
            "top": [[name, ms] for ms, name in rows[:6]]}


def host_profile(fn, top: int = 10) -> list:
    """One more run of fn under cProfile: the functions that took most of
    the host's time themselves (tottime, ms; the profiler's own cost is in
    them).  A wait for the device shows as the call that blocked."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    rows = sorted(((tt * 1e3, f"{f.rsplit('/', 1)[-1]}:{line}({name})")
                   for (f, line, name), (_, _, tt, _, _)
                   in pstats.Stats(prof).stats.items()), reverse=True)
    return [[name, ms] for ms, name in rows[:top]]


@contextlib.contextmanager
def recorded(module, name: str):
    """Keep the arguments and result of every call of module.name (a kernel
    wrapper) while the block runs; the wrapper itself is untouched.  The
    wrapper adds to the `launches` of whatever module.name holds, so the
    stand-in carries the count meanwhile and hands it back."""
    real = getattr(module, name)
    calls = []

    def keep(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out))
        return out

    keep.launches = real.launches
    setattr(module, name, keep)
    try:
        yield calls
    finally:
        real.launches = keep.launches
        setattr(module, name, real)


def against_plain(name: str, kernel, plain, calls) -> dict:
    """The main path's one launch of a kernel held against the plain
    version on the same CUDA tensors, exact; times of both at that shape
    (the kernel's relaunches here come after the launch count was read)."""
    if len(calls) != 1:
        raise AssertionError(f"{name}: {len(calls)} launches on the main "
                             "path, expected 1")
    (args, kw, out), = calls
    outs = out if isinstance(out, tuple) else (out,)
    ref, plain_ms = timed(lambda: plain(*args, **kw))
    refs = ref if isinstance(ref, tuple) else (ref,)
    err = max(max_err(x, y) for x, y in zip(outs, refs))
    if err:
        raise AssertionError(f"{name} disagrees with its plain version on "
                             f"the main path's inputs: max_abs_err {err}")
    return {"inputs": [list(a.shape) for a in args], "max_abs_err": err,
            "ms": cuda_ms(lambda: kernel(*args, **kw), 3),
            "plain_ms": plain_ms}


def phase_main(smi: str):
    data = text_corpus(CORPUS_BYTES, SEED)
    # warm the CUDA context, allocator and host paths outside the timing
    tpuzip_torch.decompress(tpuzip_torch.compress(data[: 4 * BLOCK]))
    encode = range_coder.ari_encode_indexed
    decode = range_decoder.ari_decode_indexed
    with (recorded(range_coder, "ari_encode_indexed") as enc_calls,
          recorded(range_decoder, "ari_decode_indexed") as dec_calls):
        torch.cuda.synchronize()
        range_coder.ari_encode_indexed.launches = 0
        range_decoder.ari_decode_indexed.launches = 0
        t0 = time.perf_counter()
        blob = tpuzip_torch.compress(data, codec="ari", block_size=BLOCK,
                                     device="cuda")
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = tpuzip_torch.decompress(blob, device="cuda")
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
    launches = {"ari_encode": encode.launches,
                "ari_decode": decode.launches}
    if back != data:
        raise AssertionError("64 MiB corpus did not round-trip")
    if min(launches.values()) < 1:
        raise AssertionError(f"main path missed a kernel: {launches}")

    from tpuzip.core import blocks as blk
    from tpuzip.oracle import ari as oari
    from tpuzip.runtime import native

    blocks_np, lens_np = blk.chunk(data, BLOCK)
    parts = payload_streams(blob)
    nb = len(parts)
    checked = sorted({0, 1, nb // 2, nb - 1})
    for i in checked:
        exp = oari.encode_bytes(blocks_np[i, : lens_np[i]].tobytes())
        if parts[i][1] != exp:
            raise AssertionError(f"block {i} stream differs from the oracle")
    if not native.available():
        raise AssertionError("tpuzip's C++ coder (csrc/, make) did not "
                             "build: every block cannot be checked")
    steps = range_decoder.CHUNK_STEPS
    comp, clens, deltas = native.ari_encode_indexed_batch(
        blocks_np, lens_np, BLOCK // steps)
    for i in range(nb):
        nci = -(-int(lens_np[i]) // steps)
        if (parts[i][1] != comp[i, : clens[i]].tobytes()
                or parts[i][0] != range_decoder.pack_chunk_index(
                    deltas[i, :nci])):
            raise AssertionError(f"block {i} differs from the C++ coder")

    # each kernel against its plain version on the main path's own inputs:
    # the 1024 x 64 KiB blocks, and the stream rows decompress cut to the
    # longest stream (so the past-the-row zero reads run)
    kernels = {
        "ari_encode": against_plain("ari_encode", encode,
                                    range_coder.ari_encode_indexed_plain,
                                    enc_calls),
        "ari_decode": against_plain("ari_decode", decode,
                                    range_decoder.ari_decode_indexed_plain,
                                    dec_calls)}
    del enc_calls[:], dec_calls[:]
    trace = {"encode": traced(lambda: tpuzip_torch.compress(data)),
             "decode": traced(lambda: tpuzip_torch.decompress(blob))}
    host = {"encode": host_profile(lambda: tpuzip_torch.compress(data)),
            "decode": host_profile(lambda: tpuzip_torch.decompress(blob))}
    emit("main", corpus_bytes=len(data), block_size=BLOCK, blocks=nb,
         container_bytes=len(blob), ratio=len(blob) / len(data),
         launches=launches, oracle_blocks=checked, native_blocks=nb,
         encode_mb_s=len(data) / 1e6 / t_enc,
         decode_mb_s=len(data) / 1e6 / t_dec, kernels=kernels,
         encode_kernel_mb_s=len(data) / 1e3 / kernels["ari_encode"]["ms"],
         decode_kernel_mb_s=len(data) / 1e3 / kernels["ari_decode"]["ms"],
         trace=trace, host_profile=host, card=smi)
    return launches, kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    smi = nvidia_smi()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    phase_build()
    small = phase_kernels()
    launches, main_path = phase_main(smi)
    if "jax" in sys.modules:
        raise AssertionError("the port's path imported jax")
    print(smi)
    # times at the main path's shape; the error over phases 3 and 4
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"tpuzip_torch/csrc/{name}.cu", "replaces": replaces,
         "launches": launches[name],
         "max_abs_err": max(small[name], main_path[name]["max_abs_err"]),
         "ms": main_path[name]["ms"], "plain_ms": main_path[name]["plain_ms"]}
        for name, replaces in (
            ("ari_encode", "tpuzip/kernels/range_coder.py:128"),
            ("ari_decode", "tpuzip/kernels/range_decoder.py:469"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
