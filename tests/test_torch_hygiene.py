"""Import hygiene of the port, by AST scan.

The port imports torch and never jax, and nothing of tpuzip: it keeps its
own copies of what it needs (runtime.errors, core.blocks, core.config,
oracle).  The scan reads the sources instead of sys.modules, because the
test process imports jax anyway (tests/conftest.py)."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "tpuzip_torch"
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "tpuzip")


def _imports(path):
    """(line, dotted module) of every import in a file; ``from a import b``
    yields ``a.b`` so a submodule imported by name is seen."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                yield node.lineno, f"{node.module}.{a.name}"


def _bad(module):
    return module.split(".")[0] in FORBIDDEN_ROOTS


def _offenders(paths):
    return [f"{p.relative_to(ROOT)}:{line} imports {mod}"
            for p in paths for line, mod in _imports(p) if _bad(mod)]


def test_port_imports_no_jax_and_only_jaxfree_tpuzip():
    """No file of the port imports jax or any tpuzip module (the name
    dates from when a few jax-free tpuzip modules were allowed)."""
    paths = sorted(PKG.rglob("*.py"))
    assert len(paths) >= 10
    offenders = _offenders(paths)
    assert not offenders, "\n".join(offenders)


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py imports neither jax nor any tpuzip module, the C++
    coder (tpuzip.runtime.native) included: its references are the port's
    plain versions and its own oracle copies."""
    offenders = _offenders([ROOT / "chip_smoke.py"])
    assert not offenders, "\n".join(offenders)


def test_round_trips_load_no_tpuzip_module():
    """In a fresh interpreter, lz4 (the default codec, and at max_chain
    8), rle, lz4p, deflate, ari, bwt (flag 2 and the segmented flag 8),
    bwtdc and apm round trips on the CPU, compress_from_device with
    decompress(to_device=True) (lz4, rle, lz4p, apm), the corpus API, the
    LZ4 frame and a writer and reader of each format through open load
    neither jax nor any tpuzip module, so the port runs its own code
    there (never tpuzip's C++ coder)."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import tpuzip_torch\n"
        "from tpuzip_torch.core import blocks\n"
        "from tpuzip_torch.dist import runner\n"
        "runner.SEG_THRESHOLD = 512\n"
        "d = b'abracadabra ' * 150\n"
        "for codec, bs in (('rle', 512), ('lz4p', 512), ('deflate', 512),\n"
        "                  ('ari', 512),\n"
        "                  ('bwt', 256), ('bwt', 1024), ('bwtdc', 1024),\n"
        "                  ('apm', 128)):\n"
        "    c = tpuzip_torch.compress(d, codec, bs, device='cpu')\n"
        "    assert tpuzip_torch.decompress(c, device='cpu') == d\n"
        "c = tpuzip_torch.compress(d, device='cpu')\n"
        "assert c[4] == 1 and tpuzip_torch.decompress(c, device='cpu') == d\n"
        "cfg = tpuzip_torch.Config()\n"
        "cfg.codec.lz4.max_chain = 8\n"
        "c8 = tpuzip_torch.compress(d, device='cpu', config=cfg)\n"
        "assert len(c8) < len(c)\n"
        "assert tpuzip_torch.decompress(c8, device='cpu') == d\n"
        "for codec, bs in (('lz4', 512), ('rle', 512), ('lz4p', 512),\n"
        "                  ('apm', 128)):\n"
        "    b, n = blocks.chunk(d, bs)\n"
        "    c = tpuzip_torch.compress_from_device(b, n, codec,\n"
        "                                          device='cpu')\n"
        "    out, olens, orig = tpuzip_torch.decompress(c, device='cpu',\n"
        "                                               to_device=True)\n"
        "    assert np.array_equal(out.numpy(), b) and orig == len(d)\n"
        "c = tpuzip_torch.compress_corpus(d, block_size=256, superbatch=512,\n"
        "                                 device='cpu')\n"
        "assert tpuzip_torch.decompress(c, device='cpu') == d\n"
        "import io\n"
        "from tpuzip_torch.codecs import lz4_frame\n"
        "f = lz4_frame.compress_frame(d, device='cpu')\n"
        "assert lz4_frame.decompress_frame(f, device='cpu') == d\n"
        "for fmt in ('lz4f', 'zlib', 'ari', 'bwt', 'rle', 'mtf', 'dc'):\n"
        "    kw = {} if fmt == 'lz4f' else {'block_size': 512}\n"
        "    b = io.BytesIO()\n"
        "    with tpuzip_torch.open(b, 'wb', format=fmt, device='cpu',\n"
        "                           **kw) as w:\n"
        "        w.write(d)\n"
        "    r = tpuzip_torch.open(io.BytesIO(b.getvalue()), 'rb',\n"
        "                          format=fmt, device='cpu')\n"
        "    assert r.read() == d, fmt\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('tpuzip', 'jax', 'jaxlib')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip() == "[]", out.stdout


def test_deflate_device_rule_and_zlib_load_no_tpuzip_module():
    """In a fresh interpreter, compress_from_device(codec="deflate") (the
    device rule) with decompress(to_device=True), and a zlib_ round trip
    read by Python's zlib, on the CPU load neither jax nor any tpuzip
    module."""
    code = (
        "import sys, zlib\n"
        "import numpy as np\n"
        "import tpuzip_torch\n"
        "from tpuzip_torch.codecs import zlib_\n"
        "from tpuzip_torch.core import blocks\n"
        "d = b'abracadabra ' * 150\n"
        "b, n = blocks.chunk(d, 512)\n"
        "c = tpuzip_torch.compress_from_device(b, n, 'deflate',\n"
        "                                      device='cpu')\n"
        "out, olens, orig = tpuzip_torch.decompress(c, device='cpu',\n"
        "                                           to_device=True)\n"
        "assert np.array_equal(out.numpy(), b) and orig == len(d)\n"
        "z = zlib_.compress(d, device='cpu')\n"
        "assert zlib.decompress(z) == d\n"
        "assert zlib_.decompress(z, len(d), device='cpu') == d\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('tpuzip', 'jax', 'jaxlib')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip() == "[]", out.stdout


def test_scan_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\n"
                   "from tpuzip.kernels import range_decoder\n"
                   "from tpuzip import dist\n"
                   "from tpuzip.runtime import native\n"
                   "from tpuzip.core.config import Config\n"
                   "import torch\n")
    got = [mod for _, mod in _imports(src) if _bad(mod)]
    assert got == ["jax.numpy", "tpuzip.kernels.range_decoder",
                   "tpuzip.dist", "tpuzip.runtime.native",
                   "tpuzip.core.config.Config"]


def test_kernels_build_nothing_at_import():
    """No module of the port calls nvcc or imports triton at import time:
    only function bodies mention the build."""
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in tree.body:
            if isinstance(node, (ast.Expr, ast.Assign)):
                for call in ast.walk(node):
                    if isinstance(call, ast.Call):
                        name = ast.unparse(call.func)
                        assert "build" not in name and "load" not in name, \
                            f"{path.relative_to(ROOT)}:{node.lineno} {name}"
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else [node.module])
                assert "triton" not in mods, path
