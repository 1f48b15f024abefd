"""Regenerate the port's goldens: the JAX package's render, on the CPU,
at 64x64, 16 spp, seed 0, of scenes/bunny.xml with a seeded stand-in mesh
of tests/torch_meshes.py in place of bunny.ply, and of the matpreview
variant.  chip_smoke.py holds the port's render of the same scene on the
card to each, tests/test_torch_matpreview.py the port's CPU render of
the matpreview variant.

* tests/golden/torch_bigmesh_64_16.npy: `bunny_standin(seed=0)`, 69,168
  triangles (~20 s);
* tests/golden/torch_densemesh_64_16.npy: `dense_standin(seed=0)`,
  870,480 triangles (minutes: the BVH walk of 870k triangles on the CPU);
* tests/golden/torch_matpreview_const_64_16.npy: `matpreview_const_xml`,
  scenes/matpreview.xml under a constant environment with the
  independent sampler (~10 s);
* tests/golden/torch_smoke_64_16.npy: scenes/smoke.xml (volpath, a
  heterogeneous medium in a `null` cube, 1,038 triangles), traced as the
  JAX package traces BVH scenes on its TPU (`reference_pair_traversal`;
  ~80 s on the CPU);
* tests/golden/torch_cbox_mitchell_64_16.npy: scenes/cbox.xml under the
  mitchell filter (the batched wavefront and its splat; ~5 s);
* tests/golden/torch_glass_bdpt_16_4.npy: scenes/glass_caustics.xml as it
  stands (bdpt, maxDepth 24 capped to MTS_BDPT_MAX_EDGES = 16 edges) at
  16x16, 4 spp, through the pair pipeline;
* tests/golden/torch_cbox_ptracer_64_16.npy: scenes/cbox.xml under the
  particle tracer, 16 particles per pixel;
* tests/golden/torch_spot_bdpt_24_16.npy: tests/test_bdpt.py's two-wall
  scene under its spot light, bdpt at maxDepth 8, 24x24, 16 spp;
* tests/golden/torch_media_bdpt_24_16.npy: tests/test_bdpt.py's media
  scene (a homogeneous fog in a `null` sphere), bdpt at maxDepth 6,
  24x24, 16 spp;
* the Metropolis slice, seed 0, luminanceSamples 1,024, one chain per
  pixel (render's default): tests/golden/torch_door_pssmlt_16_4.npy,
  scenes/door.xml as it stands (pssmlt, bidirectional, maxDepth 8) at
  16x16, 4 mutations per pixel, through the pair pipeline;
  torch_door_pssmlt_uni_16_4.npy, the same with bidirectional false;
  torch_door_mlt_16_4.npy and torch_door_erpt_16_1.npy, door under mlt
  (4 mutations per pixel) and erpt (1 seed per pixel, chainLength 8);
  torch_cbox_mlt_24_8.npy and torch_cbox_erpt_24_1.npy, scenes/cbox.xml
  at 24x24, maxDepth 4 under mlt (8 mutations per pixel) and erpt (1
  seed per pixel, chainLength 20); torch_glass_mlt_manifold_16_8.npy,
  scenes/glass_caustics.xml under mlt with manifoldPerturbation at 16x16,
  maxDepth 6, 8 mutations per pixel (steps 3 and 7 are manifold steps),
  through the pair pipeline;
* the photon-mapping slice, seed 0, 4 iterations or passes:
  torch_cbox_sppm_24_4.npy, scenes/cbox.xml under sppm at 24x24 (2^14
  photons an iteration); torch_glass_sppm_16_4.npy, glass_caustics under
  sppm (maxDepth 24) at 16x16 (2^12); torch_homog_photonmapper_32_4.npy,
  tests/test_photonmapper.py's homogeneous slab (tests/torch_meshes.py
  `homog_slab_xml`) under the photon mapper at 32x32 (2^12), through the
  pair pipeline (its cube stands on the floor); torch_cbox_vpl_24_4.npy,
  scenes/cbox.xml under vpl at 24x24 (64 VPL paths a pass);
* the subsurface slice, the path family and the meta-integrators, seed 0,
  4 spp: torch_dipole_32_4.npy, scenes/dipole.xml as it stands at 32x24
  (the irradiance pass of 640 points x 32 rays included), and
  torch_singlescatter_32_4.npy, the same with `singlescatter` in place of
  `dipole`, both through the JAX package's XLA BVH walk (the scene has no
  coplanar faces: through its pair pipeline the two renders move by
  1.3e-8 and 1.7e-8, at 2.5x and 5x the time); at 24x24 on
  scenes/cbox.xml, torch_cbox_ao_24_4.npy (ao), torch_cbox_field_uv_24_4.npy
  (the uv field), torch_cbox_adaptive_24_4.npy and
  torch_cbox_irrcache_24_4.npy (adaptive and irrcache over `path` at
  maxDepth 4);
* the hairball slice and the rest of the BSDFs, seed 0, 4 spp:
  torch_hairball_32_4.npy, scenes/hairball.xml as it stands (68,136
  triangles in 800 clusters: the tessellated fibers and the emissive
  sphere) at 32x24, through the pair pipeline, which the port's K3/K4/K7/K8
  follow (RMSE against the port 8.3e-3, against the XLA walk's render
  9.5e-3); torch_hairball_exact_32_4.npy, the same with exact="true"
  (7,189 cylinder segments; its 1,024 triangles render alike through
  either traversal, so through the faster XLA walk); at 24x24, the
  matpreview variant with its spheres' BSDFs replaced
  (tests/torch_meshes.py `bsdf_gallery_xml`): torch_bsdf_glossy_24_4.npy
  (roughdiffuse, phong, a two-sided ward), torch_bsdf_thin_24_4.npy
  (thindielectric, difftrans, hk with a nested hg phase),
  torch_bsdf_layered_24_4.npy (a mask over a coating over phong, a
  rough coating over diffuse, a three-leaf mixture holding a blend), and
  torch_bsdf_thin_bdpt_24_4.npy (the thin gallery under bdpt at maxDepth
  4).

* the texture slice, seed 0, over the assets that tests/torch_meshes.py
  `feature_assets` writes from seed 0 into build/feature_assets:
  torch_textured_32_4.npy, `textured_xml` (TEXTURED: 2,758 triangles in 35
  clusters, through the pair pipeline) at 32x32, 4 spp;
  torch_tex_bitmap_24_4.npy and torch_tex_bitmap_ewa_24_4.npy,
  `bitmap_xml` under the feline and the ewa filter (MTS_TEX_FILTER);
  torch_tex_normalmap_32_4.npy and torch_tex_bumpmap_32_4.npy,
  `bump_xml("tilted")` and `bump_xml("bump")`; torch_tex_vertexcolors_33_4.npy,
  torch_tex_wireframe_33_4.npy and torch_tex_curvature_33_4.npy,
  `geom_xml`; torch_irawan_cloth_24_4.npy, `cloth_xml`.

* the sensors, the daylight emitters and spectral mode, seed 0, 4 spp:
  torch_dispersion_32_4.npy and torch_dispersion_spectral9_32_4.npy,
  scenes/dispersion.xml at 32x32 in RGB mode and with 9 spectral bins
  (MTS_SPECTRAL_BINS); torch_daylight_32_4.npy, DAYLIGHT
  (`daylight_xml`: matpreview under a Hosek-Wilkie sunsky through a
  thinlens camera) at 32x32; torch_sky_sun_32_4.npy, `sky_sun_xml`
  (a Preetham sky and a separate sun) at 32x32; the sensor gallery at
  24x24 (`sensor_xml`): torch_sensor_{orthographic, telecentric,
  spherical, thinlens, rdist}_24_4.npy.

* the motion slice and the remaining media, seed 0: torch_motion_32_4.npy,
  MOTION (`motion_xml`: cbox with its short block animated, a deformable
  card of three keyframes, a shutter open over [0, 1]) at 32x32, 4 spp;
  torch_deform_card3_32_4.npy, tests/test_deformable.py's card of three
  keyframes (`moving_card_xml("deformable", 3)`); torch_motion_big_32_4.npy,
  MOTION_BIG with 43 seeded cubes (516 static triangles) in place of the
  stand-in, through the pair pipeline; torch_motion_vectors_d_32_1.npy
  and torch_motion_vectors_ttd_32_1.npy, the motion integrator on MOTION
  (config "d") and on tests/test_motion.py's glass slab (config "ttd"),
  1 spp; torch_fiber_kkay_24_4.npy and torch_fiber_microflake_24_4.npy,
  FIBER (`fiber_xml`: scenes/smoke.xml with a fiber phase on the
  orientation volume `fiber_assets` writes into build/fiber_assets) at
  24x24, 4 spp, through the pair pipeline; torch_fiber_slab_bdpt_16_4.npy
  and torch_fiber_slab_photonmapper_16_4.npy, the fiber slab
  (`fiber_slab_xml`) under bdpt and the photon mapper (2^12 photons) at
  16x16, maxDepth 4.
* the geometry extras, seed 0, 32x32, 4 spp: torch_instancing_32_4.npy,
  tests/test_instancing.py's scene (`instancing_xml`: three instances of
  a card group) with its instances copied into plain rows, and
  torch_instancing_tlas_32_4.npy, the same through the two-level
  accelerator (MTS_INSTANCE_EXPAND_MAX=0; the JAX package's loop path on
  the CPU); torch_instancing_two_group_32_4.npy, `instancing_two_group_xml`
  (a second, bump-mapped and textured group, one instance scaled
  unevenly) through the accelerator; torch_shapes_gallery_32_4.npy,
  `shapes_gallery_xml` (disk, obj, serialized, heightfield over the
  files `shape_assets` and `feature_assets` write into
  build/feature_assets); torch_bvh_walk_32_4.npy, scenes/bunny.xml's
  configuration on `bvh_walk_mesh` (3,968 triangles) with the cluster
  budget lowered in the JAX package (`cluster_budget`), so that it packs
  no cluster tables and walks its BVH.

    JAX_PLATFORMS=cpu python -m tests.make_torch_bigmesh_golden [NAME ...]

With no argument all fifty-nine are written.  Each line the script prints
gives the golden's render time, XLA's compile included; the last four
took, on 8 cores of an Intel Xeon CPU: glass_bdpt 1,283.1 s
(the 16-edge program's compile; 16 edges fit, so no smaller cap was
needed), cbox_ptracer 6.4 s, spot_bdpt 25.9 s and media_bdpt 200.8 s:

    JAX_PLATFORMS=cpu python -m tests.make_torch_bigmesh_golden glass_bdpt
    JAX_PLATFORMS=cpu python -m tests.make_torch_bigmesh_golden cbox_ptracer spot_bdpt media_bdpt

The Metropolis goldens took, on the same CPU (XLA's compile included;
door_pssmlt and glass_mlt_manifold shared it with other work): cbox_mlt
6.8 s, cbox_erpt 4.3 s, door_pssmlt_uni 20.2 s, glass_mlt_manifold 271.9
s, door_pssmlt 613.7 s, door_mlt 14.5 s, door_erpt 16.7 s:

    JAX_PLATFORMS=cpu python -m tests.make_torch_bigmesh_golden cbox_mlt cbox_erpt door_pssmlt_uni glass_mlt_manifold door_pssmlt door_mlt door_erpt

The photon-mapping goldens took, on the same CPU (sharing it with other
work): cbox_sppm 67.4 s, cbox_vpl 8.0 s, glass_sppm 83.7 s,
homog_photonmapper 250.8 s:

    JAX_PLATFORMS=cpu python -m tests.make_torch_bigmesh_golden cbox_sppm cbox_vpl glass_sppm homog_photonmapper
"""

import contextlib
import functools
import os
import sys
import time

import numpy as np

from tests.torch_meshes import (
    ROOT,
    bdpt_media_xml,
    bitmap_xml,
    bsdf_gallery_xml,
    bump_xml,
    bunny_scene_xml,
    bunny_standin,
    cbox_chain_xml,
    NESTED_PATH,
    cbox_meta_xml,
    cbox_xml,
    cbox_mitchell_xml,
    cbox_ptracer_xml,
    cloth_xml,
    daylight_xml,
    dense_standin,
    dipole_xml,
    dispersion_xml,
    door_xml,
    feature_assets,
    fiber_assets,
    fiber_slab_xml,
    fiber_xml,
    geom_xml,
    bvh_walk_mesh,
    glass_slab_motion_xml,
    glass_manifold_xml,
    glass_xml,
    hairball_xml,
    homog_slab_xml,
    instancing_two_group_xml,
    instancing_xml,
    matpreview_const_xml,
    motion_big_xml,
    motion_vectors_xml,
    motion_xml,
    moving_card_xml,
    sensor_xml,
    shape_assets,
    shapes_gallery_xml,
    sky_sun_xml,
    smoke_xml,
    textured_xml,
    two_wall_xml,
    with_integrator,
    with_properties,
    write_ply,
)


def _standin_xml(mesh, ply):
    def make():
        os.makedirs(os.path.dirname(ply), exist_ok=True)
        write_ply(ply, *mesh(seed=0))
        return bunny_scene_xml(ply, 64, 64)
    return make


FEATURE_ASSETS = os.path.join(ROOT, "build", "feature_assets")


FIBER_ASSETS = os.path.join(ROOT, "build", "fiber_assets")


def _fiber(make):
    """An XML maker over FIBER's volumes, written first."""
    def xml():
        return make(fiber_assets(FIBER_ASSETS))
    return xml


def _feature(make):
    """An XML maker over the feature assets, written first."""
    def xml():
        return make(feature_assets(FEATURE_ASSETS))
    return xml


def _shapes(make):
    """An XML maker over the feature and shape assets, written first."""
    def xml():
        return make(shape_assets(feature_assets(FEATURE_ASSETS)))
    return xml


BVH_WALK_PLY = os.path.join(ROOT, "build", "bvh_walk.ply")
# a cluster budget below bvh_walk_mesh's 46 clusters of 128
BVH_WALK_BUDGET = 1000


def _bvh_walk():
    os.makedirs(os.path.dirname(BVH_WALK_PLY), exist_ok=True)
    write_ply(BVH_WALK_PLY, *bvh_walk_mesh())
    return bunny_scene_xml(BVH_WALK_PLY, 32, 32)


@contextlib.contextmanager
def cluster_budget(n_bytes):
    """Within the block the JAX package packs cluster tables only up to
    n_bytes (its CLUSTER_HBM_MAX; None leaves it)."""
    from mitsuba_tpu.accel import clusters as jcl

    saved = jcl.CLUSTER_HBM_MAX
    if n_bytes is not None:
        jcl.CLUSTER_HBM_MAX = n_bytes
    try:
        yield
    finally:
        jcl.CLUSTER_HBM_MAX = saved


@contextlib.contextmanager
def texture_filter(name):
    """Within the block the JAX package filters texture footprints with
    `name` (its MTS_TEX_FILTER, which it reads at import)."""
    from mitsuba_tpu.scene import texture_eval as jte

    saved, jte.TEX_FILTER = jte.TEX_FILTER, name
    try:
        yield
    finally:
        jte.TEX_FILTER = saved


@contextlib.contextmanager
def reference_pair_traversal():
    """Within the block the JAX package traces scenes with cluster tables
    as on its TPU: through its pair pipeline (accel/pairs.py), whose
    Pallas kernels run in interpret mode, instead of its XLA BVH walk.
    The port's K3/K4/K7 follow the pair pipeline, which breaks exact-t
    ties (coplanar faces, such as scenes/smoke.xml's cube on its floor)
    differently from the walk.  Patches two module attributes of the JAX
    package for the block's duration."""
    from mitsuba_tpu.accel import intersect as jis
    from mitsuba_tpu.accel import pairs as jprs

    saved = jis._use_clusters, jprs.pair_closest, jprs.pair_any
    jis._use_clusters = lambda pack: pack.meta.get("n_clusters", 0) > 0
    jprs.pair_closest = functools.partial(saved[1], interpret=True)
    jprs.pair_any = functools.partial(saved[2], interpret=True)
    try:
        yield
    finally:
        jis._use_clusters, jprs.pair_closest, jprs.pair_any = saved


# name -> (golden, the scene's XML, [traced through the pair pipeline,
# [spp, [environment settings for the render, [the JAX package's cluster
# budget]]]]); 64x64 at 16 spp unless said otherwise
GOLDENS = {
    "bigmesh": (os.path.join(ROOT, "tests", "golden", "torch_bigmesh_64_16.npy"),
                _standin_xml(bunny_standin, os.path.join(ROOT, "build", "bunny_standin.ply"))),
    "densemesh": (os.path.join(ROOT, "tests", "golden", "torch_densemesh_64_16.npy"),
                  _standin_xml(dense_standin, os.path.join(ROOT, "build", "dense_standin.ply"))),
    "matpreview": (os.path.join(ROOT, "tests", "golden", "torch_matpreview_const_64_16.npy"),
                   lambda: matpreview_const_xml(64, 64)),
    "smoke": (os.path.join(ROOT, "tests", "golden", "torch_smoke_64_16.npy"),
              lambda: smoke_xml(64, 64), True),
    "cbox_mitchell": (os.path.join(ROOT, "tests", "golden", "torch_cbox_mitchell_64_16.npy"),
                      lambda: cbox_mitchell_xml(64, 64)),
    "glass_bdpt": (os.path.join(ROOT, "tests", "golden", "torch_glass_bdpt_16_4.npy"),
                   lambda: glass_xml(16, 16), True, 4),
    "cbox_ptracer": (os.path.join(ROOT, "tests", "golden", "torch_cbox_ptracer_64_16.npy"),
                     lambda: cbox_ptracer_xml(64, 64)),
    "spot_bdpt": (os.path.join(ROOT, "tests", "golden", "torch_spot_bdpt_24_16.npy"),
                  lambda: two_wall_xml("spot", "bdpt", max_depth=8, spp=16), True),
    "media_bdpt": (os.path.join(ROOT, "tests", "golden", "torch_media_bdpt_24_16.npy"),
                   lambda: bdpt_media_xml("bdpt", max_depth=6, spp=16), True),
    "door_pssmlt": (os.path.join(ROOT, "tests", "golden", "torch_door_pssmlt_16_4.npy"),
                    lambda: door_xml(16, 16, luminance_samples=1024), True, 4),
    "door_pssmlt_uni": (os.path.join(ROOT, "tests", "golden", "torch_door_pssmlt_uni_16_4.npy"),
                        lambda: door_xml(16, 16, luminance_samples=1024, bidirectional=False),
                        True, 4),
    "door_mlt": (os.path.join(ROOT, "tests", "golden", "torch_door_mlt_16_4.npy"),
                 lambda: with_integrator(door_xml(16, 16, luminance_samples=1024), "mlt"),
                 True, 4),
    "door_erpt": (os.path.join(ROOT, "tests", "golden", "torch_door_erpt_16_1.npy"),
                  lambda: with_properties(
                      with_integrator(door_xml(16, 16, luminance_samples=1024), "erpt"),
                      '<integer name="chainLength" value="8"/>'), True, 1),
    "cbox_mlt": (os.path.join(ROOT, "tests", "golden", "torch_cbox_mlt_24_8.npy"),
                 lambda: cbox_chain_xml("mlt"), False, 8),
    "cbox_erpt": (os.path.join(ROOT, "tests", "golden", "torch_cbox_erpt_24_1.npy"),
                  lambda: cbox_chain_xml("erpt", chain_length=20), False, 1),
    "glass_mlt_manifold": (os.path.join(ROOT, "tests", "golden",
                                        "torch_glass_mlt_manifold_16_8.npy"),
                           glass_manifold_xml, True, 8),
    "cbox_sppm": (os.path.join(ROOT, "tests", "golden", "torch_cbox_sppm_24_4.npy"),
                  lambda: cbox_xml("sppm", 24, 24), False, 4, {"MTS_SPPM_PHOTONS": "16384"}),
    "glass_sppm": (os.path.join(ROOT, "tests", "golden", "torch_glass_sppm_16_4.npy"),
                   lambda: with_integrator(glass_xml(16, 16), "sppm"), False, 4,
                   {"MTS_SPPM_PHOTONS": "4096"}),
    "homog_photonmapper": (os.path.join(ROOT, "tests", "golden",
                                        "torch_homog_photonmapper_32_4.npy"),
                           homog_slab_xml, True, 4, {"MTS_SPPM_PHOTONS": "4096"}),
    "cbox_vpl": (os.path.join(ROOT, "tests", "golden", "torch_cbox_vpl_24_4.npy"),
                 lambda: cbox_xml("vpl", 24, 24), False, 4, {"MTS_VPL_COUNT": "64"}),
    "dipole": (os.path.join(ROOT, "tests", "golden", "torch_dipole_32_4.npy"),
               lambda: dipole_xml(32, 24), False, 4),
    "singlescatter": (os.path.join(ROOT, "tests", "golden", "torch_singlescatter_32_4.npy"),
                      lambda: dipole_xml(32, 24, "singlescatter"), False, 4),
    "cbox_ao": (os.path.join(ROOT, "tests", "golden", "torch_cbox_ao_24_4.npy"),
                lambda: cbox_xml("ao", 24, 24), False, 4),
    "cbox_field": (os.path.join(ROOT, "tests", "golden", "torch_cbox_field_uv_24_4.npy"),
                   lambda: with_properties(cbox_xml("field", 24, 24),
                                           '<string name="field" value="uv"/>'), False, 4),
    "cbox_adaptive": (os.path.join(ROOT, "tests", "golden", "torch_cbox_adaptive_24_4.npy"),
                      lambda: cbox_meta_xml("adaptive", NESTED_PATH), False, 4),
    "cbox_irrcache": (os.path.join(ROOT, "tests", "golden", "torch_cbox_irrcache_24_4.npy"),
                      lambda: cbox_meta_xml("irrcache", NESTED_PATH), False, 4),
    "hairball": (os.path.join(ROOT, "tests", "golden", "torch_hairball_32_4.npy"),
                 lambda: hairball_xml(32, 24), True, 4),
    "hairball_exact": (os.path.join(ROOT, "tests", "golden", "torch_hairball_exact_32_4.npy"),
                       lambda: hairball_xml(32, 24, exact=True), False, 4),
    "bsdf_glossy": (os.path.join(ROOT, "tests", "golden", "torch_bsdf_glossy_24_4.npy"),
                    lambda: bsdf_gallery_xml("glossy", 24, 24), False, 4),
    "bsdf_thin": (os.path.join(ROOT, "tests", "golden", "torch_bsdf_thin_24_4.npy"),
                  lambda: bsdf_gallery_xml("thin", 24, 24), False, 4),
    "bsdf_layered": (os.path.join(ROOT, "tests", "golden", "torch_bsdf_layered_24_4.npy"),
                     lambda: bsdf_gallery_xml("layered", 24, 24), False, 4),
    "bsdf_thin_bdpt": (os.path.join(ROOT, "tests", "golden", "torch_bsdf_thin_bdpt_24_4.npy"),
                       lambda: bsdf_gallery_xml("thin", 24, 24, "bdpt", 4), False, 4),
    "textured": (os.path.join(ROOT, "tests", "golden", "torch_textured_32_4.npy"),
                 _feature(lambda d: textured_xml(d, 32, 32)), True, 4),
    "tex_bitmap": (os.path.join(ROOT, "tests", "golden", "torch_tex_bitmap_24_4.npy"),
                   _feature(bitmap_xml), False, 4),
    "tex_bitmap_ewa": (os.path.join(ROOT, "tests", "golden", "torch_tex_bitmap_ewa_24_4.npy"),
                       _feature(bitmap_xml), False, 4, {"MTS_TEX_FILTER": "ewa"}),
    "tex_normalmap": (os.path.join(ROOT, "tests", "golden", "torch_tex_normalmap_32_4.npy"),
                      lambda: bump_xml("tilted"), False, 4),
    "tex_bumpmap": (os.path.join(ROOT, "tests", "golden", "torch_tex_bumpmap_32_4.npy"),
                    _feature(lambda d: bump_xml("bump", d)), False, 4),
    "tex_vertexcolors": (os.path.join(ROOT, "tests", "golden", "torch_tex_vertexcolors_33_4.npy"),
                         _feature(lambda d: geom_xml("vertexcolors", d)), False, 4),
    "tex_wireframe": (os.path.join(ROOT, "tests", "golden", "torch_tex_wireframe_33_4.npy"),
                      _feature(lambda d: geom_xml("wireframe", d)), False, 4),
    "tex_curvature": (os.path.join(ROOT, "tests", "golden", "torch_tex_curvature_33_4.npy"),
                      _feature(lambda d: geom_xml("curvature", d)), False, 4),
    "irawan_cloth": (os.path.join(ROOT, "tests", "golden", "torch_irawan_cloth_24_4.npy"),
                     cloth_xml, False, 4),
    "dispersion": (os.path.join(ROOT, "tests", "golden", "torch_dispersion_32_4.npy"),
                   lambda: dispersion_xml(32, 32), False, 4),
    "dispersion_spectral9": (os.path.join(ROOT, "tests", "golden",
                                          "torch_dispersion_spectral9_32_4.npy"),
                             lambda: dispersion_xml(32, 32), False, 4,
                             {"MTS_SPECTRAL_BINS": "9"}),
    "daylight": (os.path.join(ROOT, "tests", "golden", "torch_daylight_32_4.npy"),
                 lambda: daylight_xml(32, 32), False, 4),
    "sky_sun": (os.path.join(ROOT, "tests", "golden", "torch_sky_sun_32_4.npy"),
                lambda: sky_sun_xml(32, 32), False, 4),
    **{f"sensor_{name}": (os.path.join(ROOT, "tests", "golden", f"torch_sensor_{name}_24_4.npy"),
                          lambda name=name: sensor_xml(name), False, 4)
       for name in ("orthographic", "telecentric", "spherical", "thinlens", "rdist")},
    "motion": (os.path.join(ROOT, "tests", "golden", "torch_motion_32_4.npy"),
               lambda: motion_xml(32, 32, 4), False, 4),
    "deform_card3": (os.path.join(ROOT, "tests", "golden", "torch_deform_card3_32_4.npy"),
                     lambda: moving_card_xml("deformable", 3, spp=4, width=32, height=32),
                     False, 4),
    "motion_big": (os.path.join(ROOT, "tests", "golden", "torch_motion_big_32_4.npy"),
                   lambda: motion_big_xml(None, 32, 32, 4), True, 4),
    "motion_vectors_d": (os.path.join(ROOT, "tests", "golden", "torch_motion_vectors_d_32_1.npy"),
                         lambda: motion_vectors_xml("d"), False, 1),
    "motion_vectors_ttd": (os.path.join(ROOT, "tests", "golden",
                                        "torch_motion_vectors_ttd_32_1.npy"),
                           lambda: glass_slab_motion_xml("ttd"), False, 1),
    "fiber_kkay": (os.path.join(ROOT, "tests", "golden", "torch_fiber_kkay_24_4.npy"),
                   _fiber(lambda d: fiber_xml("kkay", d, "grid", 24, 24)), True, 4),
    "fiber_microflake": (os.path.join(ROOT, "tests", "golden", "torch_fiber_microflake_24_4.npy"),
                         _fiber(lambda d: fiber_xml("microflake", d, "grid", 24, 24)), True, 4),
    "fiber_slab_bdpt": (os.path.join(ROOT, "tests", "golden", "torch_fiber_slab_bdpt_16_4.npy"),
                        _fiber(lambda d: fiber_slab_xml("bdpt", d)), True, 4),
    "fiber_slab_photonmapper": (os.path.join(ROOT, "tests", "golden",
                                             "torch_fiber_slab_photonmapper_16_4.npy"),
                                _fiber(lambda d: fiber_slab_xml("photonmapper", d)), True, 4,
                                {"MTS_SPPM_PHOTONS": "4096"}),
    "instancing": (os.path.join(ROOT, "tests", "golden", "torch_instancing_32_4.npy"),
                   instancing_xml, False, 4),
    "instancing_tlas": (os.path.join(ROOT, "tests", "golden", "torch_instancing_tlas_32_4.npy"),
                        instancing_xml, False, 4, {"MTS_INSTANCE_EXPAND_MAX": "0"}),
    "instancing_two_group": (os.path.join(ROOT, "tests", "golden",
                                          "torch_instancing_two_group_32_4.npy"),
                             _feature(instancing_two_group_xml), False, 4,
                             {"MTS_INSTANCE_EXPAND_MAX": "0"}),
    "shapes_gallery": (os.path.join(ROOT, "tests", "golden", "torch_shapes_gallery_32_4.npy"),
                       _shapes(shapes_gallery_xml), False, 4),
    "bvh_walk": (os.path.join(ROOT, "tests", "golden", "torch_bvh_walk_32_4.npy"),
                 _bvh_walk, False, 4, {}, BVH_WALK_BUDGET),
}


def main(names):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import mitsuba_tpu
    from mitsuba_tpu.scene.xml_loader import load_scene_string

    for name in names:
        golden, make_xml, *rest = GOLDENS[name]
        pairs, spp, env, budget = (rest + [False, 16, {}, None][len(rest):])[:4]
        t0 = time.time()
        scene = load_scene_string(make_xml())
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            with reference_pair_traversal() if pairs else contextlib.nullcontext(), \
                    texture_filter(env.get("MTS_TEX_FILTER", "feline")), cluster_budget(budget):
                img = np.asarray(mitsuba_tpu.render(scene, spp=spp, seed=0), np.float32)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        np.save(golden, img)
        print(f"wrote {golden}: shape {img.shape}, mean {img.mean():.6f}, "
              f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:] or list(GOLDENS))
