"""The port stands alone: nothing under mitsuba_tpu_torch/, and neither
chip_smoke.py, profile_pass.py, time_brute.py nor the mesh generator they import
(tests/torch_meshes.py), imports JAX or the JAX package (checked on the source's syntax tree, so
lazy imports inside functions count too), or names a path under
mitsuba_tpu/ in its code (docstrings and comments may cite the
reference, and a "file:line" string may name the TPU kernel a port
replaces).  Its entry points run on the card unless asked otherwise."""

import ast
import glob
import inspect
import os
import re

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "mitsuba_tpu"}
SOURCES = sorted(
    glob.glob(os.path.join(ROOT, "mitsuba_tpu_torch", "**", "*.py"), recursive=True)
) + [os.path.join(ROOT, f) for f in ("chip_smoke.py", "profile_pass.py", "time_brute.py",
                                    "tests/torch_meshes.py")]
# a citation of a TPU kernel: "mitsuba_tpu/<module>.py:<line>"
CITATION = re.compile(r"mitsuba_tpu/[\w/]+\.py:\d+")


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


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                yield body[0].value


def _reference_paths(path):
    """String constants outside docstrings that name a path under
    mitsuba_tpu/: the component itself, or a path through it that is not
    a kernel citation."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    docs = {id(n) for n in _docstrings(tree)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
            text = CITATION.sub("", node.value)
            if node.value == "mitsuba_tpu" or re.search(r"mitsuba_tpu[/\\]", text):
                yield node.value, node.lineno


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, ROOT))
def test_no_reference_paths(path):
    bad = list(_reference_paths(path))
    assert not bad, f"{os.path.relpath(path, ROOT)} names paths of the JAX package: {bad}"


def test_port_sources_lie_in_the_port():
    from mitsuba_tpu_torch import native

    port = os.path.join(ROOT, "mitsuba_tpu_torch") + os.sep
    assert native.CSRC_DIR.startswith(port) and native.HOST_SRC_DIR.startswith(port)
    for src in ("bvh_builder.cpp", "alias_table.cpp"):
        assert os.path.isfile(os.path.join(native.HOST_SRC_DIR, src)), src


def test_entry_points_default_to_the_card():
    from mitsuba_tpu_torch import render
    from mitsuba_tpu_torch.scene.builder import pack_scene

    for fn in (render, pack_scene):
        default = inspect.signature(fn).parameters["device"].default
        assert torch.device(default).type == "cuda", fn.__name__


def test_materials_modules_are_checked():
    """The modules of the materials and envmap slices are among the
    sources checked above."""
    rel = {os.path.relpath(p, ROOT) for p in SOURCES}
    for mod in ("bsdf/microfacet.py", "bsdf/ior.py", "bsdf/rtrans.py", "bsdf/eval.py",
                "bsdf/plugins.py", "scene/textures.py", "scene/texture_eval.py",
                "scene/shapes.py", "accel/intersect.py", "io/exr.py", "io/images.py",
                "io/pfm.py", "io/png.py", "core/distribution.py", "core/sobol.py",
                "sampler/plugins.py", "emitter/eval.py"):
        assert os.path.join("mitsuba_tpu_torch", mod) in rel, mod


def test_media_modules_are_checked():
    """The modules of the smoke slice (media, volpath, the splatting film)
    are among the sources checked above."""
    rel = {os.path.relpath(p, ROOT) for p in SOURCES}
    for mod in ("medium/plugins.py", "medium/eval.py", "integrator/volpath.py",
                "integrator/path.py", "film/film.py", "film/plugins.py", "renderer.py"):
        assert os.path.join("mitsuba_tpu_torch", mod) in rel, mod


def test_light_transport_modules_are_checked():
    """The modules of the light-transport slice (bdpt, ptracer, the delta
    emitters) are among the sources checked above, and their entry points
    run on the card unless asked otherwise."""
    from mitsuba_tpu_torch.integrator import bdpt, ptracer

    rel = {os.path.relpath(p, ROOT) for p in SOURCES}
    for mod in ("integrator/bdpt.py", "integrator/ptracer.py", "integrator/plugins.py",
                "emitter/plugins.py", "emitter/eval.py", "core/warp.py", "core/rng.py",
                "film/film.py"):
        assert os.path.join("mitsuba_tpu_torch", mod) in rel, mod
    for fn in (bdpt.render_bdpt, bdpt.iter_bdpt, ptracer.render_ptracer):
        default = inspect.signature(fn).parameters["device"].default
        assert torch.device(default).type == "cuda", fn.__name__
