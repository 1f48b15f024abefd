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


def test_metropolis_modules_are_checked():
    """The modules of the Metropolis slice (pssmlt, mlt and erpt, the
    manifold walks and perturbation) are among the sources checked above,
    and their entry points run on the card unless asked otherwise."""
    from mitsuba_tpu_torch.integrator import mlt, pssmlt

    rel = {os.path.relpath(p, ROOT) for p in SOURCES}
    for mod in ("integrator/pssmlt.py", "integrator/mlt.py", "integrator/manifold.py",
                "integrator/mut_manifold.py", "integrator/path.py", "integrator/plugins.py",
                "core/spectrum.py", "core/warp.py", "core/rng.py", "renderer.py"):
        assert os.path.join("mitsuba_tpu_torch", mod) in rel, mod
    for fn in (pssmlt.render_pssmlt, pssmlt.iter_pssmlt, mlt.render_mlt, mlt.render_erpt):
        default = inspect.signature(fn).parameters["device"].default
        assert torch.device(default).type == "cuda", fn.__name__


def test_photon_mapping_modules_are_checked():
    """The modules of the photon-mapping slice (sppm and ppm, the
    volumetric photon mapper, vpl) are among the sources checked above,
    and their entry points run on the card unless asked otherwise."""
    from mitsuba_tpu_torch.integrator import photonmapper, sppm, vpl

    rel = {os.path.relpath(p, ROOT) for p in SOURCES}
    for mod in ("integrator/sppm.py", "integrator/photonmapper.py", "integrator/vpl.py",
                "integrator/plugins.py", "renderer.py"):
        assert os.path.join("mitsuba_tpu_torch", mod) in rel, mod
    for fn in (sppm.render_sppm, sppm.iter_sppm, photonmapper.render_photonmapper,
               photonmapper.iter_photonmapper, vpl.render_vpl, vpl.iter_vpl):
        default = inspect.signature(fn).parameters["device"].default
        assert torch.device(default).type == "cuda", fn.__name__


def test_subsurface_and_meta_modules_are_checked():
    """The modules of the subsurface slice and of the meta-integrators
    (subsurface, sss, irrcache, adaptive) are among the sources checked
    above, and their entry points run on the card unless asked otherwise."""
    from mitsuba_tpu_torch.integrator import adaptive, irrcache

    rel = {os.path.relpath(p, ROOT) for p in SOURCES}
    for mod in ("scene/subsurface.py", "integrator/sss.py", "integrator/irrcache.py",
                "integrator/adaptive.py", "integrator/path.py", "integrator/plugins.py",
                "scene/builder.py", "renderer.py"):
        assert os.path.join("mitsuba_tpu_torch", mod) in rel, mod
    for fn in (irrcache.render_irrcache, adaptive.render_adaptive):
        default = inspect.signature(fn).parameters["device"].default
        assert torch.device(default).type == "cuda", fn.__name__


def test_hairball_modules_are_checked():
    """The modules of the hairball slice (the hair shape, the cylinder
    segments and their intersector, the BSDFs) are among the sources
    checked above."""
    rel = {os.path.relpath(p, ROOT) for p in SOURCES}
    for mod in ("scene/hair.py", "accel/cyl.py", "scene/shapes.py", "accel/intersect.py",
                "bsdf/eval.py", "bsdf/plugins.py", "scene/texture_eval.py", "scene/builder.py"):
        assert os.path.join("mitsuba_tpu_torch", mod) in rel, mod


@pytest.mark.parametrize("mod", ["mitsuba_tpu_torch.scene.hair", "mitsuba_tpu_torch.accel.cyl"])
def test_hairball_modules_stand_alone(mod):
    """scene/hair.py and accel/cyl.py import nothing of JAX or of the JAX
    package, and keep their own copies of the reference's code (the hair
    loader and frames, the segment test)."""
    import importlib

    m = importlib.import_module(mod)
    assert not [r for r, _ in _imported_roots(m.__file__) if r in FORBIDDEN]
    for name in (("load_hair", "_fiber_frames", "tessellate_fibers", "fibers_to_segments")
                 if mod.endswith("hair") else ("_seg_test", "cyl_closest", "cyl_any")):
        assert getattr(m, name).__module__ == mod, name


def test_texture_modules_are_checked():
    """The modules of the texture slice (the texture plugins and their
    evaluation, the bump frames, irawan's device and host halves, the
    PLY colours, the weave stream) are among the sources checked above."""
    rel = {os.path.relpath(p, ROOT) for p in SOURCES}
    for mod in ("scene/textures.py", "scene/texture_eval.py", "scene/builder.py",
                "accel/intersect.py", "bsdf/irawan.py", "bsdf/irawan_host.py", "bsdf/eval.py",
                "bsdf/plugins.py", "io/meshes.py", "core/rng.py"):
        assert os.path.join("mitsuba_tpu_torch", mod) in rel, mod


@pytest.mark.parametrize("mod,names", [
    ("mitsuba_tpu_torch.bsdf.irawan_host",
     ("parse_weave", "pack_tables", "tables_have_noise", "compute_normalization", "lane_params",
      "irawan_f", "tea_float_np")),
    ("mitsuba_tpu_torch.bsdf.irawan",
     ("lane_params", "irawan_f", "filament_integrand", "staple_integrand", "perlin1")),
    ("mitsuba_tpu_torch.scene.builder",
     ("_mip_chain", "_downsample2", "_pack_textures", "_vertex_curvatures", "_uv_partials")),
    ("mitsuba_tpu_torch.scene.texture_eval",
     ("eval_texture", "mip_footprint", "shading_params", "shading_frame")),
    ("mitsuba_tpu_torch.scene.textures", ("TextureDesc", "as_texture_or_spectrum")),
])
def test_texture_modules_stand_alone(mod, names):
    """The texture slice's modules import nothing of JAX or of the JAX
    package and keep their own copies of the reference's code (the weave
    parser, presets, tables and normalization; the mip chain and the
    curvature estimate; the lookups)."""
    import importlib

    m = importlib.import_module(mod)
    assert not [r for r, _ in _imported_roots(m.__file__) if r in FORBIDDEN]
    for name in names:
        assert getattr(m, name).__module__ == mod, name
    if mod.endswith("irawan_host"):
        assert "plain" in m.PRESETS


def test_sensor_daylight_spectral_modules_are_checked():
    """The modules of the sensors, the daylight emitters and spectral mode
    are among the sources checked above, and the port reads its own copy
    of the Hosek-Wilkie dataset."""
    from mitsuba_tpu_torch.emitter import sky

    rel = {os.path.relpath(p, ROOT) for p in SOURCES}
    for mod in ("sensor/plugins.py", "emitter/sky.py", "emitter/plugins.py", "core/spectral.py",
                "core/spectrum.py", "scene/xml_loader.py", "scene/builder.py",
                "sampler/plugins.py", "integrator/sppm.py", "renderer.py"):
        assert os.path.join("mitsuba_tpu_torch", mod) in rel, mod
    data = os.path.join(ROOT, "mitsuba_tpu_torch", "data", "hosek_rgb.npz")
    assert os.path.isfile(data)
    assert os.path.realpath(os.path.dirname(sky.__file__)).startswith(
        os.path.realpath(os.path.join(ROOT, "mitsuba_tpu_torch")))


@pytest.mark.parametrize("mod,names", [
    ("mitsuba_tpu_torch.sensor.plugins",
     ("SensorRecord", "generate_rays", "_resolve_xfov", "ThinLens", "Orthographic",
      "Telecentric", "Spherical", "RadianceMeter", "FluenceMeter", "IrradianceMeter",
      "PerspectiveRDist")),
    ("mitsuba_tpu_torch.emitter.sky",
     ("_perez", "sun_direction_from_time", "sun_irradiance_rgb", "_hosek_dataset",
      "_hosek_config", "hosek_sky_image", "preetham_sky_image")),
    ("mitsuba_tpu_torch.emitter.plugins", ("_sun_direction", "_SkyBase", "SkyEmitter",
                                           "SunSkyEmitter", "SunEmitter")),
    ("mitsuba_tpu_torch.core.spectral",
     ("_cie_fine", "SpectralBins", "make_bins", "upsample_rgb", "upsample_illum", "spd_to_bins",
      "cauchy_eta")),
    ("mitsuba_tpu_torch.core.spectrum",
     ("blackbody_rgb", "interpolated_spectrum_to_rgb", "rgb_to_xyz", "xyz_to_rgb")),
    ("mitsuba_tpu_torch.scene.builder", ("apply_spectral_pack",)),
])
def test_sensor_daylight_spectral_modules_stand_alone(mod, names):
    """The slice's modules import nothing of JAX or of the JAX package,
    not even its numpy-only modules (emitter/sky.py, core/spectral.py),
    and keep their own copies of the reference's code."""
    import importlib

    m = importlib.import_module(mod)
    assert not [r for r, _ in _imported_roots(m.__file__) if r in FORBIDDEN]
    for name in names:
        assert getattr(m, name).__module__ == mod, name


def test_motion_and_media_modules_are_checked():
    """The modules of the motion slice (animated and deformable shapes,
    the shutter, the motion integrator) and of the remaining media are
    among the sources checked above."""
    rel = {os.path.relpath(p, ROOT) for p in SOURCES}
    for mod in ("scene/xml_loader.py", "scene/properties.py", "scene/shapes.py",
                "scene/builder.py", "sensor/plugins.py", "accel/intersect.py",
                "integrator/path.py", "integrator/manifold.py", "integrator/plugins.py",
                "medium/plugins.py", "medium/eval.py", "integrator/volpath.py",
                "integrator/photonmapper.py", "integrator/bdpt.py"):
        assert os.path.join("mitsuba_tpu_torch", mod) in rel, mod


@pytest.mark.parametrize("mod,names", [
    ("mitsuba_tpu_torch.scene.properties", ("Properties",)),
    ("mitsuba_tpu_torch.scene.shapes", ("ShapeInstance", "DeformableShape")),
    ("mitsuba_tpu_torch.scene.builder", ("_relative_motion", "_deform_tables",
                                         "_orientation_corners", "_cam_motion")),
    ("mitsuba_tpu_torch.accel.intersect",
     ("_anim_ray", "_anim_closest", "_anim_any", "_deform_frames", "_deform_closest",
      "_deform_any", "intersect", "occluded")),
    ("mitsuba_tpu_torch.integrator.path", ("shutter_time", "_motion_advance", "motion_trace")),
    ("mitsuba_tpu_torch.integrator.manifold", ("chain_trace", "manifold_walk")),
    ("mitsuba_tpu_torch.integrator.plugins", ("MotionIntegrator",)),
    ("mitsuba_tpu_torch.medium.plugins",
     ("_kkay_normalization", "_flake_tables", "KajiyaKayPhase", "MicroflakePhase",
      "HGridVolume", "VolCache")),
    ("mitsuba_tpu_torch.medium.eval",
     ("_orient_at", "_flake_d", "_flake_sigt", "_kkay_eval", "_microflake_eval",
      "phase_eval", "phase_pdf", "phase_sample")),
])
def test_motion_and_media_modules_stand_alone(mod, names):
    """The slice's modules import nothing of JAX or of the JAX package
    and keep their own copies of the reference's code."""
    import importlib

    m = importlib.import_module(mod)
    assert not [r for r, _ in _imported_roots(m.__file__) if r in FORBIDDEN]
    for name in names:
        assert getattr(m, name).__module__ == mod, name


@pytest.mark.parametrize("category,name", [
    ("shape", "deformable"), ("integrator", "motion"), ("phase", "kkay"),
    ("phase", "microflake"), ("volume", "hgridvolume"), ("volume", "volcache"),
])
def test_motion_and_media_plugins_registered(category, name):
    """The slice's plugins are registered in the port as in the reference."""
    from mitsuba_tpu_torch.scene import registry as treg

    assert name in treg.names(category)


def test_animation_element_loads():
    """An <animation> loads: get_transform is keyframe 0, get_animation
    the track, sorted by time."""
    from mitsuba_tpu_torch.scene.xml_loader import load_scene_string

    scene = load_scene_string(
        '<scene version="0.5.0"><sensor type="perspective"/><shape type="cube">'
        '<animation name="toWorld"><transform time="1"><translate x="2"/></transform>'
        '<transform time="0"><translate x="1"/></transform></animation></shape></scene>')
    track = scene.shapes[0].animation
    assert [t for t, _ in track] == [0.0, 1.0]
    assert track[0][1].m[0, 3] == 1.0 and track[1][1].m[0, 3] == 2.0
    assert scene.shapes[0].meshes[0].positions[:, 0].min() == 0.0  # keyframe 0: x + 1


def test_geometry_extras_modules_are_checked():
    """The modules of the geometry extras (the two-level accelerator, the
    disk, obj, serialized, heightfield, shapegroup and instance shapes,
    the mesh readers and writer, the loader's groups) are among the
    sources checked above."""
    rel = {os.path.relpath(p, ROOT) for p in SOURCES}
    for mod in ("accel/tlas.py", "accel/intersect.py", "scene/shapes.py", "scene/xml_loader.py",
                "scene/builder.py", "io/meshes.py", "accel/clusters.py"):
        assert os.path.join("mitsuba_tpu_torch", mod) in rel, mod


@pytest.mark.parametrize("mod,names", [
    ("mitsuba_tpu_torch.accel.tlas",
     ("_world_box", "build_instance_accel", "_rebase", "inst_closest", "inst_any", "_group_view",
      "_inst_lists_tile", "_inst_lists", "inst_closest_pairs", "inst_any_pairs")),
    ("mitsuba_tpu_torch.scene.shapes",
     ("DiskShape", "ObjShape", "SerializedShape", "PlyShape", "HeightfieldShape", "ShapeGroup",
      "InstanceShape")),
    ("mitsuba_tpu_torch.io.meshes", ("load_obj", "load_serialized", "save_serialized")),
    ("mitsuba_tpu_torch.accel.intersect",
     ("_ray_sort_key", "_sorted_chunked", "_use_inst_pairs", "_bvh_traverse",
      "_bvh_traverse_any")),
    ("mitsuba_tpu_torch.scene.builder", ("_instances",)),
])
def test_geometry_extras_modules_stand_alone(mod, names):
    """The slice's modules import nothing of JAX or of the JAX package and
    keep their own copies of the reference's code; every shape plugin of
    the reference is registered."""
    import importlib

    from mitsuba_tpu_torch.scene import registry

    m = importlib.import_module(mod)
    assert not [r for r, _ in _imported_roots(m.__file__) if r in FORBIDDEN]
    for name in names:
        assert getattr(m, name).__module__ == mod, name
    assert {"disk", "obj", "serialized", "heightfield", "shapegroup", "instance"} <= set(
        registry.names("shape"))
