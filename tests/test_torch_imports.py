"""The port stands alone: nothing under mitsuba_tpu_torch/, and not
chip_smoke.py, imports JAX or the JAX package (checked on the source's
syntax tree, so lazy imports inside functions count too)."""

import ast
import glob
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "mitsuba_tpu"}
SOURCES = sorted(
    glob.glob(os.path.join(ROOT, "mitsuba_tpu_torch", "**", "*.py"), recursive=True)
) + [os.path.join(ROOT, "chip_smoke.py")]


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_sources_found():
    assert len(SOURCES) > 20
    assert all(os.path.isfile(p) for p in SOURCES)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
