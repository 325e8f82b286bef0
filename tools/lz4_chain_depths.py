#!/usr/bin/env python3
"""Check and time csrc/lz4_chain.cu, csrc/lz4_dense.cu, csrc/lz4_links.cu
and csrc/lz4p.cu on one GPU:

    python3 tools/lz4_chain_depths.py

Builds the four sources with nvcc -Xptxas -v (registers and spills), then
holds every launch exact against its plain version: the chained encoder's
links, best words and parse at hash_log 4, 12, 16 and 24 and max_chain 2, 8
and 64 on 72 rows of 4 KiB (text, text cut short with random bytes past its
length, zeros, b"ab", 4 symbols, random bytes, 13 and 17 bytes, and
chip_smoke's mixed rows), on chip_smoke's cap rows, run rows and
65,536-byte edge rows, and at max_chain 8 on its 128 KiB far rows; the dense encoder's
shared route (its words and the parse over them) at hash_log 0, 4, 12, 15
and 16 on the same rows; lz4p's pack under
both rules (lz4_encode.cu's streams at hash_log 12 and 16, lz4_dense.cu's
at 15, two 64 KiB rows where no 4 bytes repeat) and its decode on the
packed rows and 64 garbage streams.  Then one timed launch of each (CUDA
events) at 1024 x 64 KiB of chip_smoke's text corpus: the links at hash_log
16, best and the parse at max_chain 2, 8 and 64 with each one's ratio, the
dense words and their parse at 15 bits, the sorted links, the words from
them and their parse at 20, lz4_encode.cu, the pack and the decode; and the
links, best and
parse of 1024 all-zero rows (max_chain 64), 1024 b"ab" rows (8) and 1024
random rows (8).  Prints the card, the ptxas lines and one JSON line a
group."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tpuzip_torch.kernels import (_build, lz4_chain, lz4_coder,  # noqa: E402
                                  lz4_dense, lz4_links, lz4p_coder)


def ptxas() -> None:
    nvcc = _build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("lz4_chain", "lz4_dense", "lz4_links", "lz4p"):
            r = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 f"{tmp}/{name}.so", str(_build.CSRC / f"{name}.cu")],
                capture_output=True, text=True, timeout=300)
            print(name, r.returncode, "\n".join(
                line for line in (r.stdout + r.stderr).splitlines()
                if "registers" in line or "error" in line
                or "spill" in line), flush=True)
    _build.build("lz4_chain", "lz4_dense", "lz4_links", "lz4p")


def rows(n: int):
    """(72, n) rows and lengths on the card, as the module note says."""
    rng = np.random.default_rng(5)
    text = np.frombuffer(cs.text_corpus(8 * n, 3), np.uint8)
    kinds = [text[:n], text[n : 2 * n], np.zeros(n),
             np.resize(np.frombuffer(b"ab", np.uint8), n),
             rng.integers(0, 4, n), rng.integers(0, 256, n),
             text[2 * n : 3 * n], text[3 * n : 4 * n]]
    lens = [n, n - 100, n, n, n, n, 13, 17]
    x = np.stack(kinds).astype(np.uint8)
    b2, l2 = cs.mixed_blocks(64, n, 9)
    x = np.concatenate([x, b2])
    lens = np.concatenate([lens, l2]).astype(np.int32)
    x[np.arange(n)[None] >= lens[:, None]] = 0
    x[1, n - 100:] = rng.integers(0, 256, 100)   # bytes past a length
    return torch.from_numpy(x).cuda(), torch.from_numpy(lens).cuda()


def edge_rows():
    """chip_smoke's cap rows (4 KiB, at the best words' cap), run rows (4
    KiB of text broken by byte runs) and 65,536-byte edge rows, each on the
    card with its lengths."""
    sets = {"cap": cs.cap_rows(4096, lz4_chain.BEST_CAP, 20),
            "runs": cs.run_rows(4096, 21),
            "stage_edge": cs.stage_edge_rows(4)}
    x, lens = rows(4096)
    sets["odd_width"] = (x[:, : cs.ODD_WIDTH].cpu().numpy().copy(),
                         lens.clamp(max=cs.ODD_WIDTH).cpu().numpy())
    return {k: tuple(torch.from_numpy(a).cuda() for a in v)
            for k, v in sets.items()}


def chain_check(x, xl, hl: int, depths) -> int:
    """The largest error of the links, the best words and the parse at
    each depth against their plain versions."""
    pk = lz4_chain.lz4_chain_links(x, xl, hl)
    pp = lz4_chain.lz4_chain_links_plain(x, xl, hl)
    err = cs.max_err(pk, pp)
    for mc in depths:
        wk = lz4_chain.lz4_chain_best(x, xl, pk, mc)
        wp = lz4_chain.lz4_chain_best_plain(x, xl, pp, mc)
        ck, lk = lz4_chain.lz4_chain_parse(x, xl, pk, mc, wk)
        cp, lp = lz4_chain.lz4_chain_parse_plain(x, xl, pp, mc, wp)
        err = max(err, cs.max_err(wk, wp), cs.max_err(ck, cp),
                  cs.max_err(lk, lp))
    return err


def chain_checks(x, xl, edges) -> dict:
    res = {f"chain{hl}": chain_check(x, xl, hl, (2, 8, 64))
           for hl in (4, 12, 16, 24)}
    for name, (ex, el) in edges.items():
        res[name] = chain_check(ex, el, 16, (2, 8, 64))
    fx, fl = (torch.from_numpy(a).cuda() for a in cs.far_rows(7))
    for hl in (12, 16):
        res[f"far{hl}"] = chain_check(fx, fl, hl, (8,))
    res["far_odd"] = chain_check(fx[:, :-3].contiguous(),
                                 fl.clamp(max=fx.shape[1] - 3), 16, (8,))
    return res


def dense_checks(x, xl, edges) -> dict:
    """The dense shared route (the words and the parse over them) against
    the plain candidates' stream."""
    res = {}
    for name, (rx, rl) in {"mixed": (x, xl), **edges}.items():
        for hl in (0, 4, 12, 15, 16):
            cp, lp = lz4_dense.lz4_dense_parse_plain(
                rx, rl, lz4_dense.lz4_dense_candidates_plain(rx, rl, hl))
            wp = lz4_dense.lz4_dense_words_plain(rx, rl, hl)
            wk = lz4_dense.lz4_dense_words(rx, rl, hl)
            ck, lk = lz4_dense.lz4_dense_words_parse(rx, rl, wk)
            res[f"dense_{name}_{hl}"] = max(
                cs.max_err(ck, cp), cs.max_err(lk, lp), cs.max_err(wk, wp))
    return res


def lz4p_checks(x, xl, n: int) -> dict:
    res = {}
    for hl in (12, 16):
        c, cl = lz4_coder.lz4_encode_batch(x, xl, hl)
        ok, okl = lz4p_coder.lz4p_pack(c, cl, n, True)
        op, opl = lz4p_coder.lz4p_pack_plain(c, cl, n, True)
        res[f"pack_cpp{hl}"] = max(cs.max_err(ok, op), cs.max_err(okl, opl))
        dk, sk = lz4p_coder.lz4p_decode_batch(ok, okl, n)
        dp, sp = lz4p_coder.lz4p_decode_batch_plain(ok, okl, n)
        res[f"dec{hl}"] = max(cs.max_err(dk, dp), cs.max_err(sk, sp))
    c, cl = lz4_dense.lz4_dense_encode_batch(x, xl, 15)
    ok, okl = lz4p_coder.lz4p_pack(c, cl, n, False)
    op, opl = lz4p_coder.lz4p_pack_plain(c, cl, n, False)
    res["pack_xla"] = max(cs.max_err(ok, op), cs.max_err(okl, opl))
    big = torch.from_numpy(np.stack(
        [cs.unrepeated_row(1 << 16, 2 + 100 * k) for k in range(2)])).cuda()
    bl = torch.full((2,), 1 << 16, dtype=torch.int32, device="cuda")
    for split in (True, False):
        c, cl = (lz4_coder.lz4_encode_batch(big, bl) if split else
                 lz4_dense.lz4_dense_encode_batch(big, bl, 15))
        ok, okl = lz4p_coder.lz4p_pack(c, cl, 1 << 16, split)
        op, opl = lz4p_coder.lz4p_pack_plain(c, cl, 1 << 16, split)
        res[f"big_split_{split}"] = [max(cs.max_err(ok, op),
                                         cs.max_err(okl, opl)), okl.tolist()]
        if split:
            dk, sk = lz4p_coder.lz4p_decode_batch(ok, okl, 1 << 16)
            res["big_decoded"] = bool(torch.equal(dk, big)) and sk.tolist()
    g, gl = cs.padded(cs.lz4p_garbage(1), 400)
    dk, sk = lz4p_coder.lz4p_decode_batch(g, gl, 512)
    dp, sp = lz4p_coder.lz4p_decode_batch_plain(g, gl, 512)
    res["garbage"] = max(cs.max_err(dk, dp), cs.max_err(sk, sp))
    return res


def chain_times(t: dict, name: str, x, lens, depths) -> None:
    prev, t[f"links_{name}_ms"] = cs.timed(
        lambda: lz4_chain.lz4_chain_links(x, lens, 16))
    for mc in depths:
        w, t[f"best_{name}{mc}_ms"] = cs.timed(
            lambda: lz4_chain.lz4_chain_best(x, lens, prev, mc))
        (_, cl), t[f"parse_{name}{mc}_ms"] = cs.timed(
            lambda: lz4_chain.lz4_chain_parse(x, lens, prev, mc, w))
        t[f"ratio_{name}{mc}"] = float(cl.sum()) / x.numel()


def times() -> dict:
    data = cs.text_corpus(cs.CORPUS_BYTES, cs.SEED)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).reshape(
        -1, cs.BLOCK).copy()).cuda()
    lens = torch.full((x.shape[0],), cs.BLOCK, dtype=torch.int32,
                      device="cuda")
    t = {}
    chain_times(t, "text", x, lens, (2, 8, 64))
    w, t["words15_ms"] = cs.timed(
        lambda: lz4_dense.lz4_dense_words(x, lens, 15))
    (_, cl), t["words_parse15_ms"] = cs.timed(
        lambda: lz4_dense.lz4_dense_words_parse(x, lens, w))
    prev, t["links20_ms"] = cs.timed(
        lambda: lz4_links.lz4_links_sorted(x, lens, 20))
    w2, t["words_links20_ms"] = cs.timed(
        lambda: lz4_dense.lz4_dense_words_links(x, lens, prev))
    _, t["words_parse20_ms"] = cs.timed(
        lambda: lz4_dense.lz4_dense_words_parse(x, lens, w2))
    (c, cl), t["lz4_encode_ms"] = cs.timed(
        lambda: lz4_coder.lz4_encode_batch(x, lens, 16))
    (p, pl), t["pack_ms"] = cs.timed(
        lambda: lz4p_coder.lz4p_pack(c, cl, cs.BLOCK, True))
    t["lz4p_ratio"] = float(pl.sum()) / x.numel()
    (d, _), t["decode_ms"] = cs.timed(
        lambda: lz4p_coder.lz4p_decode_batch(p, pl, cs.BLOCK))
    t["decoded"] = bool(torch.equal(d, x))
    del c, p, d, prev, w2
    for name, rows_, mc in (
            ("zero", torch.zeros_like(x), 64),
            ("ab", x.new_tensor(np.resize(np.frombuffer(b"ab", np.uint8),
                                          tuple(x.shape))), 8),
            ("random", torch.from_numpy(np.random.default_rng(3).integers(
                0, 256, tuple(x.shape), np.uint8)).cuda(), 8)):
        chain_times(t, name, rows_, lens, (mc,))
    return t


def main() -> int:
    if not torch.cuda.is_available():
        print("lz4_chain_depths: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    print(cs.nvidia_smi(), flush=True)
    ptxas()
    x, xl = rows(4096)
    edges = edge_rows()
    checks = {**chain_checks(x, xl, edges), **dense_checks(x, xl, edges),
              **lz4p_checks(x, xl, 4096)}
    print(json.dumps(checks), flush=True)
    print(json.dumps(times()), flush=True)
    errs = [v[0] if isinstance(v, list) else v
            for k, v in checks.items() if k != "big_decoded"]
    return 0 if not any(errs) and checks["big_decoded"] else 1


if __name__ == "__main__":
    sys.exit(main())
