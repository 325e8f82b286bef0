"""Import hygiene of the port, by AST scan.

The port imports torch and never jax, and from tpuzip only its jax-free
modules.  The scan reads the sources instead of sys.modules, because the
test process imports jax anyway (tests/conftest.py)."""

import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "tpuzip_torch"
# the jax-free tpuzip modules the port may read
ALLOWED = ("tpuzip.runtime.errors", "tpuzip.core.blocks", "tpuzip.core.config",
           "tpuzip.oracle")
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax")


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


def _bad(module, allowed):
    top = module.split(".")[0]
    if top in FORBIDDEN_ROOTS:
        return True
    if top != "tpuzip":
        return False
    return not any(module == a or module.startswith(a + ".")
                   for a in allowed)


def _offenders(paths, allowed):
    return [f"{p.relative_to(ROOT)}:{line} imports {mod}"
            for p in paths for line, mod in _imports(p)
            if _bad(mod, allowed)]


def test_port_imports_no_jax_and_only_jaxfree_tpuzip():
    paths = sorted(PKG.rglob("*.py"))
    assert len(paths) >= 10
    offenders = _offenders(paths, ALLOWED)
    assert not offenders, "\n".join(offenders)


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py may also use the C++ coder as a reference (jax-free),
    never the jax-bearing tpuzip modules."""
    offenders = _offenders([ROOT / "chip_smoke.py"],
                           ALLOWED + ("tpuzip.runtime.native",))
    assert not offenders, "\n".join(offenders)


def test_scan_catches_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\n"
                   "from tpuzip.kernels import range_decoder\n"
                   "from tpuzip import dist\n"
                   "from tpuzip.runtime import native\n"
                   "from tpuzip.core.config import Config\n"
                   "import torch\n")
    got = [mod for _, mod in _imports(src) if _bad(mod, ALLOWED)]
    assert got == ["jax.numpy", "tpuzip.kernels.range_decoder",
                   "tpuzip.dist", "tpuzip.runtime.native"]


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
