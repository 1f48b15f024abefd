"""Seeded test meshes for the port's big-mesh slice (plain numpy; imports
neither JAX nor torch, so chip_smoke.py can use it on a machine without
JAX).

`bunny_standin` stands in for the Stanford bunny of scenes/bunny.xml
until bunny.ply is in the repository: a UV sphere of the bunny's size
(264 x 132 gives 69,168 triangles; the bunny has 69,451) whose radius is
displaced by a seeded sum of low-frequency sinusoids, so the surface is
non-convex, shadows and lights itself.  It is scaled into the region the
scene's camera looks at.  `dense_standin` is the same surface at the
Stanford dragon's triangle count.  `bunny_scene_xml` is scenes/bunny.xml with the
mesh file replaced, so the configuration stays the scene's own.
`matpreview_const_xml` is scenes/matpreview.xml with a constant white
environment in place of its envmap and the independent sampler in place
of sobol, the materials slice's scene.  `EMISSIVE_SPHERE_XML` and
`cbox_sphere_xml` hold analytic spheres beside more triangles than
spheres.  `smoke_xml` is scenes/smoke.xml (the media slice's scene) and
`cbox_mitchell_xml` scenes/cbox.xml under the mitchell filter, each
optionally at another film size.  The sensors, daylight and spectral
slice's scenes follow: `dispersion_xml`, DAYLIGHT
(`daylight_xml`), `sky_sun_xml`, the sensor gallery (`sensor_xml`), the
meters (`METERS`, `meter_xml`) and `with_thinlens`.  The motion and fiber
slice's are at the end: MOTION (`motion_xml`), MOTION_BIG
(`motion_big_xml`), the motion-vector scenes (`motion_vectors_xml`,
`glass_slab_motion_xml`), the reference tests' moving cards
(`moving_card_xml`), FIBER (`fiber_xml` over the volumes `fiber_assets`
writes) and the fiber slab (`fiber_slab_xml`).
"""

import os
import re

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY_XML = os.path.join(ROOT, "scenes", "bunny.xml")
MATPREVIEW_XML = os.path.join(ROOT, "scenes", "matpreview.xml")
CBOX_XML = os.path.join(ROOT, "scenes", "cbox.xml")
SMOKE_XML = os.path.join(ROOT, "scenes", "smoke.xml")


def tm_rmse(a, b):
    """The RMSE of two linear HDR images after the tone map x / (1 + x),
    which every golden gate and reference comparison reads."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.sqrt(np.mean((a / (1 + a) - b / (1 + b)) ** 2)))


# where the camera of scenes/bunny.xml looks, and the bunny's extent
STANDIN_CENTER = (-0.02, 0.1, 0.0)
STANDIN_RADIUS = 0.07


def uv_sphere(n_phi, n_theta, seed=None, amp=0.0, n_waves=6):
    """Closed UV sphere (two pole vertices, n_theta - 1 rings of n_phi),
    wound counter-clockwise seen from outside; 2 * n_phi * (n_theta - 1)
    triangles.  With amp > 0 the unit radius is scaled by 1 + amp * (a
    seeded sum of n_waves sinusoids of low frequency along random
    directions).  Returns (positions [V, 3] f32, indices [T, 3] u32)."""
    theta = np.pi * np.arange(1, n_theta) / n_theta  # ring polar angles
    phi = 2.0 * np.pi * np.arange(n_phi) / n_phi
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    ring = np.stack(
        [st * np.cos(phi)[None], ct * np.ones_like(phi)[None], st * np.sin(phi)[None]],
        axis=-1,
    ).reshape(-1, 3)
    dirs = np.concatenate([[[0.0, 1.0, 0.0]], ring, [[0.0, -1.0, 0.0]]])
    if amp > 0.0:
        rng = np.random.default_rng(seed)
        axes = rng.normal(size=(n_waves, 3))
        axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
        freq = rng.uniform(2.0, 5.0, n_waves)
        phase = rng.uniform(0.0, 2.0 * np.pi, n_waves)
        weight = rng.uniform(0.5, 1.0, n_waves)
        waves = np.sin(freq[None] * (dirs @ axes.T) + phase[None]) * weight[None]
        dirs = dirs * (1.0 + amp * waves.sum(axis=-1) / weight.sum())[:, None]

    def vid(ring_i, j):  # vertex id of ring ring_i (0-based), column j
        return 1 + ring_i * n_phi + (j % n_phi)

    south = 1 + (n_theta - 1) * n_phi
    tris = []
    for j in range(n_phi):
        tris.append([0, vid(0, j + 1), vid(0, j)])
        for i in range(n_theta - 2):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j), vid(i + 1, j + 1)
            tris += [[a, b, d], [a, d, c]]
        tris.append([south, vid(n_theta - 2, j), vid(n_theta - 2, j + 1)])
    return dirs.astype(np.float32), np.asarray(tris, np.uint32)


def bunny_standin(seed=0, n_phi=264, n_theta=132):
    """The displaced sphere at the bunny's place and size."""
    pos, idx = uv_sphere(n_phi, n_theta, seed=seed, amp=0.35)
    pos = pos / np.abs(pos).max() * STANDIN_RADIUS + np.asarray(STANDIN_CENTER)
    return pos.astype(np.float32), idx


def dense_standin(seed=0):
    """The displaced sphere at 936 x 466: 870,480 triangles (the Stanford
    dragon has 871,414), 9,856 clusters of <= 128.  Past the reference's
    dense-cull bound (1,890 clusters) and its VMEM-resident tiles (1,365),
    so it takes the two-level cull, the window pair kernel and the
    streamed fallback traversal."""
    return bunny_standin(seed=seed, n_phi=936, n_theta=466)


def write_ply(path, positions, indices, normals=None, texcoords=None,
              fmt="binary_little_endian", colors=None):
    """PLY writer: float vertex properties (x y z [nx ny nz] [u v]), then
    uchar colours (red green blue) where given, and uchar-counted int
    face lists; fmt is "ascii" or a binary format."""
    cols = [positions]
    props = ["x", "y", "z"]
    if normals is not None:
        cols.append(normals)
        props += ["nx", "ny", "nz"]
    if texcoords is not None:
        cols.append(texcoords)
        props += ["u", "v"]
    verts = np.concatenate(cols, axis=1).astype(np.float32)
    cprops = ["red", "green", "blue"] if colors is not None else []
    header = (
        f"ply\nformat {fmt} 1.0\ncomment seeded test mesh\n"
        f"element vertex {len(verts)}\n"
        + "".join(f"property float {p}\n" for p in props)
        + "".join(f"property uchar {p}\n" for p in cprops)
        + f"element face {len(indices)}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if fmt == "ascii":
            for k, row in enumerate(verts):
                vals = [repr(float(x)) for x in row]
                vals += [str(int(c)) for c in colors[k]] if colors is not None else []
                f.write((" ".join(vals) + "\n").encode())
            for tri in indices:
                f.write(("3 " + " ".join(str(int(i)) for i in tri) + "\n").encode())
            return
        end = {"binary_little_endian": "<", "binary_big_endian": ">"}[fmt]
        if colors is None:
            f.write(verts.astype(end + "f4").tobytes())
        else:
            rec = np.zeros(len(verts), np.dtype([("p", end + "f4", verts.shape[1]),
                                                 ("c", "u1", 3)]))
            rec["p"], rec["c"] = verts, colors
            f.write(rec.tobytes())
        faces = np.zeros(len(indices), np.dtype([("n", "u1"), ("i", end + "i4", 3)]))
        faces["n"] = 3
        faces["i"] = indices
        f.write(faces.tobytes())


def bunny_scene_xml(ply_path, width=None, height=None):
    """scenes/bunny.xml reading `ply_path` in place of bunny.ply,
    optionally at another film size."""
    with open(BUNNY_XML) as f:
        xml = f.read()
    # the one file name in the scene is its mesh's
    xml, n = re.subn(r'(<string name="filename" value=")[^"]*(")',
                     lambda m: m.group(1) + ply_path + m.group(2), xml)
    if n != 1:
        raise ValueError(f"{BUNNY_XML} names {n} files, expected its one mesh")
    return _film_size(xml, width, height)


def _film_size(xml, width, height):
    if width is not None:
        xml = re.sub(r'name="width" value="\d+"', f'name="width" value="{width}"', xml)
        xml = re.sub(r'name="height" value="\d+"', f'name="height" value="{height}"', xml)
    return xml


def matpreview_const_xml(width=None, height=None):
    """scenes/matpreview.xml with `<emitter type="constant">` of radiance
    1 in place of its envmap and `independent` in place of its sobol
    sampler (same sample count), optionally at another film size."""
    with open(MATPREVIEW_XML) as f:
        xml = f.read()
    const = '<emitter type="constant"><rgb name="radiance" value="1, 1, 1"/></emitter>'
    xml, n_env = re.subn(r'<emitter type="envmap">.*?</emitter>', const, xml, flags=re.S)
    xml, n_smp = re.subn(r'<sampler type="sobol">', '<sampler type="independent">', xml)
    if (n_env, n_smp) != (1, 1):
        raise ValueError(f"{MATPREVIEW_XML}: {n_env} envmaps and {n_smp} sobol samplers, "
                         "expected one of each")
    return _film_size(xml, width, height)


# an emissive sphere is tessellated (1,024 triangles: the BVH path) beside
# an analytic one and a rectangle under a constant environment, seen from
# the spheres' side at 16 x 16
EMISSIVE_SPHERE_XML = """
<scene version="0.5.0">
  <integrator type="path"><integer name="maxDepth" value="6"/></integrator>
  <sensor type="perspective"><float name="fov" value="50"/>
    <transform name="toWorld"><lookat origin="0.4,1.5,-4" target="0.4,0,-0.5" up="0,1,0"/></transform>
    <sampler type="independent"><integer name="sampleCount" value="8"/></sampler>
    <film type="hdrfilm"><integer name="width" value="16"/><integer name="height" value="16"/>
      <rfilter type="gaussian"/></film>
  </sensor>
  <shape type="rectangle"><bsdf type="roughplastic"><float name="alpha" value="0.2"/></bsdf></shape>
  <shape type="sphere"><point name="center" x="0" y="0" z="-1"/><float name="radius" value="0.3"/>
    <emitter type="area"><rgb name="radiance" value="5"/></emitter></shape>
  <shape type="sphere"><point name="center" x="1" y="0" z="-1"/><float name="radius" value="0.4"/>
    <bsdf type="roughdielectric"><string name="distribution" value="ggx"/></bsdf></shape>
  <emitter type="constant"><rgb name="radiance" value="0.5, 0.5, 0.5"/></emitter>
</scene>
"""


def cbox_sphere_xml(width=None, height=None):
    """scenes/cbox.xml (36 triangles) with one analytic rough-conductor
    sphere on the floor in front of the tall block, optionally at another
    film size."""
    with open(CBOX_XML) as f:
        xml = f.read()
    sphere = ('<shape type="sphere"><point name="center" x="390" y="90" z="150"/>'
              '<float name="radius" value="90"/><bsdf type="roughconductor"/></shape>')
    head, n = re.subn(r"</scene>\s*$", sphere + "\n</scene>\n", xml)
    if n != 1:
        raise ValueError(f"{CBOX_XML} does not end with </scene>")
    return _film_size(head, width, height)


def smoke_xml(width=None, height=None):
    """scenes/smoke.xml with its density grid's file name made absolute (so
    that the text loads from any directory), optionally at another film
    size."""
    with open(SMOKE_XML) as f:
        xml = f.read()
    vol = os.path.join(ROOT, "scenes", "assets", "smoke.vol")
    xml, n = re.subn(r'value="assets/smoke.vol"', f'value="{vol}"', xml)
    if n != 1:
        raise ValueError(f"{SMOKE_XML} names {n} smoke.vol files, expected one")
    return _film_size(xml, width, height)


def cbox_mitchell_xml(width=None, height=None):
    """scenes/cbox.xml with `<rfilter type="mitchell"/>` in place of its
    gaussian filter, optionally at another film size."""
    with open(CBOX_XML) as f:
        xml = f.read()
    xml, n = re.subn(r'<rfilter type="gaussian"\s*/>', '<rfilter type="mitchell"/>', xml)
    if n != 1:
        raise ValueError(f"{CBOX_XML} holds {n} gaussian filters, expected one")
    return _film_size(xml, width, height)


# ---- the light-transport slice: delta lights, bdpt and ptracer ----

GLASS_XML = os.path.join(ROOT, "scenes", "glass_caustics.xml")

# tone-mapped RMSE gates of the light-transport goldens in tests/golden/
# (the JAX package's renders), each a few times above the largest reading
# of the port on the CPU and on an NVIDIA H100 80GB HBM3 (700 W): glass
# 3.4e-7 / 1.3e-7, cbox ptracer 4.6e-6 / 4.7e-6 (nearest-pixel splats; the
# card's adds land in any order), spot bdpt 1.3e-8 / 6.0e-9, media bdpt
# 2.5e-8 / 1.7e-8.  Deep strategies carry little tone-mapped energy: a
# dropped strategy or MIS ratio past 5 edges moves the media render by
# less than tests/test_golden.py's 5e-3.  That gate stays for the
# reference's own glass_caustics_64_16.npy, which came from its other
# traversal (6.6e-4 on the card).
GOLDEN_GATES = {
    "torch_glass_bdpt_16_4.npy": 2e-6,
    "torch_cbox_ptracer_64_16.npy": 1e-5,
    "torch_spot_bdpt_24_16.npy": 1e-7,
    "torch_media_bdpt_24_16.npy": 1e-7,
    # the Metropolis slice (CPU readings: door 3.1e-7, door unidirectional
    # 4.2e-8, door mlt 4.2e-8, door erpt 5.8e-8, glass mlt with the
    # manifold perturbation 1.6e-6).  A chain that takes another path
    # after a last-place difference keeps it, and with one chain per
    # pixel it moves its pixel whole: cbox's paths diverge on ~1 lane in
    # 500 (ROADMAP C), which puts cbox mlt at 2.0e-2 (2.5e-2 on the card)
    # and erpt at 6.0e-3.  So the cbox mlt golden is coverage only (the
    # chains through K1/K2): a squared acceptance ratio reads 2.7e-2, under
    # its gate.  tests/test_torch_mlt.py::test_cbox_one_step holds cbox's
    # mlt step instead.
    "torch_door_pssmlt_16_4.npy": 2e-6,
    "torch_door_pssmlt_uni_16_4.npy": 3e-7,
    "torch_door_mlt_16_4.npy": 3e-7,
    "torch_door_erpt_16_1.npy": 3e-7,
    "torch_glass_mlt_manifold_16_8.npy": 1e-5,
    "torch_cbox_mlt_24_8.npy": 5e-2,
    "torch_cbox_erpt_24_1.npy": 2e-2,
    # the photon-mapping slice (CPU readings: cbox sppm 9.2e-4, glass sppm
    # 4.8e-7, cbox vpl 5.7e-4, the slab under the photon mapper 1.15e-2).
    # cbox's photon and light paths diverge on a last-place difference
    # (ROADMAP C), and a photon that lands elsewhere moves its windows.  The
    # slab's cube stands on the floor: the floor beneath it and the cube's
    # null bottom face tie in t, and the two pair pipelines break a few of
    # those ties apart (with the cube lifted 0.01 the renders agree at
    # 1.4e-6).  Mutations on the CPU (PERF.md): without count/K scaling
    # cbox 3.3e-2, glass 1.5e-2; without the radius update cbox 1.1e-2,
    # glass 2.3e-2; without the beam estimate the slab 7.8e-2; without
    # the VPL clamp cbox vpl 6.1e-3.
    "torch_cbox_sppm_24_4.npy": 3e-3,
    "torch_glass_sppm_16_4.npy": 2e-6,
    "torch_cbox_vpl_24_4.npy": 2e-3,
    "torch_homog_photonmapper_32_4.npy": 3e-2,
    # the subsurface slice, the path family and the meta-integrators (CPU
    # readings: dipole.xml 1.6e-6, singlescatter 1.5e-6, ao 6.7e-3, the uv
    # field 3.6e-8, adaptive 7.0e-3, irrcache 1.1e-3).  Fed the same rays,
    # the two packages' ao agree lane for lane; in the renders 7 of 2,304
    # occlusion rays, cast 1e-4 off a surface whose hit point moved by a
    # camera ray's last place, meet that surface in one package only (ROADMAP
    # C).  adaptive: one NEE shadow ray of the base passes grazes an edge in
    # one package only, and the refinement rounds, whose pixel picks follow
    # every pixel's error, spread that over the image.  irrcache: a gather
    # ray that starts 1e-4 off its record's surface meets it again in one
    # package only, which moves that record's radius (a harmonic mean of hit
    # distances) and its gradients; on the card, whose exp, log and trig
    # differ from the CPU's in the last place, the golden reads 5.3e-3
    # (NVIDIA H100 80GB HBM3, 700 W): other gather rays flip there, and
    # with 36 records for 576 pixels each record moves a patch of the image.
    "torch_dipole_32_4.npy": 1e-5,
    "torch_singlescatter_32_4.npy": 1e-5,
    "torch_cbox_ao_24_4.npy": 2e-2,
    "torch_cbox_field_uv_24_4.npy": 1e-6,
    "torch_cbox_adaptive_24_4.npy": 3e-2,
    "torch_cbox_irrcache_24_4.npy": 1.5e-2,
    # the hairball slice and the rest of the BSDFs (CPU readings: hairball
    # 8.3e-3 against the golden of the pair pipeline (9.5e-3 against the XLA
    # walk's), hairball exact 2.4e-2; the galleries glossy 6.4e-7, thin
    # 5.0e-7, layered 9.1e-7).  The fibers, 0.012 thick, are chaotic for
    # both packages: the JAX package's own render moves by 7.7e-3
    # (tessellated) and 2.5e-2 (exact) when XLA is built without FMA
    # (--xla_cpu_max_isa=AVX), the exact mode's mean by 0.9 %.  A secondary
    # ray that leaves a fiber 1e-4 off a hit point whose last places moved
    # meets that fiber again, or not, and the quadratic of the segment test
    # cancels |p_perp|^2 against r^2 in float32.  Fed the same rays, the two
    # packages agree lane for lane (tests/test_torch_hair.py); the golden
    # tests also hold the mean within 1.5 %.
    "torch_hairball_32_4.npy": 2.5e-2,
    "torch_hairball_exact_32_4.npy": 6e-2,
    "torch_bsdf_glossy_24_4.npy": 1e-5,
    "torch_bsdf_thin_24_4.npy": 1e-5,
    "torch_bsdf_layered_24_4.npy": 1e-5,
    "torch_bsdf_thin_bdpt_24_4.npy": 1e-5,
    # the texture slice (CPU readings: TEXTURED 1.4e-3, the bitmap scene
    # 6.9e-6 under feline and 3.4e-6 under ewa, the tilted normal map 0, the
    # bump map 1.8e-6, vertex colours 1.5e-8, wireframe 1.9e-7, curvature
    # 5.5e-9, the cloth 3.1e-7).  TEXTURED's reading is three pixels of
    # 1,024 (32 x 32, 4 spp) whose paths part: a last-place difference at
    # one bounce (a hit point, a footprint's log2, a bump frame) sends a
    # sample elsewhere, and at 4 spp it moves its pixel by up to 7e-2.
    # Fed the same inputs, the two packages' textures, footprints and
    # frames agree to ~1e-6 (tests/test_torch_textures.py,
    # tests/test_torch_bumpmap.py).
    "torch_textured_32_4.npy": 5e-3,
    "torch_tex_bitmap_24_4.npy": 1e-5,
    "torch_tex_bitmap_ewa_24_4.npy": 1e-5,
    "torch_tex_normalmap_32_4.npy": 1e-5,
    "torch_tex_bumpmap_32_4.npy": 1e-5,
    "torch_tex_vertexcolors_33_4.npy": 1e-6,
    "torch_tex_wireframe_33_4.npy": 1e-6,
    "torch_tex_curvature_33_4.npy": 1e-6,
    "torch_irawan_cloth_24_4.npy": 1e-5,
    # the sensors, the daylight emitters and spectral mode (CPU readings:
    # dispersion 9.4e-7 in RGB mode and 9.5e-7 with 9 bins, DAYLIGHT
    # 4.5e-4, the Preetham sky with its sun 7.3e-6, the sensor gallery 0;
    # on an NVIDIA H100 80GB HBM3 at 700 W: dispersion 5.2e-7 in both
    # modes, DAYLIGHT 4.5e-4, the sky with its sun 4.1e-6, the sensors 0).
    # Each gate is 2-3x its larger reading.  DAYLIGHT's reading is its sun:
    # the sunsky bakes the solar disk into a few texels of ~1e5 radiance,
    # so a sample that meets one of them after a last-place difference
    # moves its pixel by ~1.7 before the tone map.
    "torch_dispersion_32_4.npy": 3e-6,
    "torch_dispersion_spectral9_32_4.npy": 3e-6,
    "torch_daylight_32_4.npy": 1.5e-3,
    "torch_sky_sun_32_4.npy": 2e-5,
    "torch_sensor_orthographic_24_4.npy": 1e-6,
    "torch_sensor_telecentric_24_4.npy": 1e-6,
    "torch_sensor_spherical_24_4.npy": 1e-6,
    "torch_sensor_thinlens_24_4.npy": 1e-6,
    "torch_sensor_rdist_24_4.npy": 1e-6,
    # the motion slice and the remaining media (CPU readings: MOTION
    # 2.2e-3, cbox's own last-place divergence through the moving rows
    # (scenes/cbox.xml sits at 1.8e-3 at this size); the deformable card
    # 0; MOTION_BIG with 43 cubes 1.2e-8; FIBER kkay 1.4e-7, microflake
    # 1.0e-3 (torch.erfinv and XLA's erfinv differ in the last places, and
    # a flake normal that moves redirects its path); the fiber slab under
    # bdpt 8.4e-8, under the photon mapper 1.9e-7; on an NVIDIA H100 80GB
    # HBM3 at 700 W: MOTION 1.1e-3, the card 0, MOTION_BIG 1.4e-8, kkay
    # 1.1e-7, microflake 3.5e-4, the slab 1.1e-7 and 3.1e-7).  Each gate is
    # 2-3x its larger reading.  The motion vectors' gates are the largest
    # difference in pixels, not a tone-mapped RMSE, beside a bound on the
    # share of the pixels off by more than 1e-4 (MOTION_VECTOR_SHARE).
    # Readings: "d" 1.9e-6 (CPU) and 3.8e-6 (card); "ttd" 6.2e-6 on the CPU
    # (its gate here), and on the card 0.078 on one pixel of 1,024, the
    # rest within 1e-5 (CARD_GOLDEN_GATES): that pixel's manifold walk
    # stops after its first Newton step, because a forward-difference
    # probe (fd_eps 1e-4) passes within a last place of the moving card's
    # edge and misses it there (ok false, so no later step moves it); its
    # first step's residual is 0.0779 pixels on the CPU too.
    "torch_motion_32_4.npy": 5e-3,
    "torch_deform_card3_32_4.npy": 1e-6,
    "torch_motion_big_32_4.npy": 3e-8,
    "torch_motion_vectors_d_32_1.npy": 1e-5,
    "torch_motion_vectors_ttd_32_1.npy": 1.5e-5,
    "torch_fiber_kkay_24_4.npy": 4e-7,
    "torch_fiber_microflake_24_4.npy": 2.5e-3,
    "torch_fiber_slab_bdpt_16_4.npy": 2.5e-7,
    "torch_fiber_slab_photonmapper_16_4.npy": 8e-7,
}

# the gates on the card where its reading lies far above the CPU's (see
# GOLDEN_GATES): 2-3x the card's reading
CARD_GOLDEN_GATES = {"torch_motion_vectors_ttd_32_1.npy": 0.2}

# the share of a motion-vector golden's pixels that may differ by more than
# 1e-4 pixels (GOLDEN_GATES bounds the largest difference): 3 of 1,024, 3x
# the card's one pixel on "ttd"
MOTION_VECTOR_SHARE = 0.003

# the delta lights of tests/test_bdpt.py's two-wall scene, and a collimated
# beam aimed at its floor
DELTA_EMITTERS = {
    "point": """<emitter type="point">
      <point name="position" x="0.5" y="2" z="-1"/>
      <rgb name="intensity" value="6, 5, 4"/></emitter>""",
    "spot": """<emitter type="spot">
      <transform name="toWorld"><lookat origin="0,2.5,-1" target="0,0,0" up="0,0,1"/></transform>
      <float name="cutoffAngle" value="40"/><float name="beamWidth" value="25"/>
      <rgb name="intensity" value="8, 8, 8"/></emitter>""",
    "directional": """<emitter type="directional">
      <vector name="direction" x="0.3" y="-1" z="0.4"/>
      <rgb name="irradiance" value="2, 2, 2"/></emitter>""",
    "collimated": """<emitter type="collimated">
      <transform name="toWorld"><lookat origin="0.2,2,-0.5" target="0.2,0,0.3" up="0,0,1"/></transform>
      <rgb name="power" value="3, 3, 3"/></emitter>""",
}


def two_wall_xml(emitter_xml, integrator="path", max_depth=4, spp=64, width=24, height=24):
    """tests/test_bdpt.py's scene: a floor and a back wall (4 triangles,
    box filter) lit by `emitter_xml` (a key of DELTA_EMITTERS or XML)."""
    emitter_xml = DELTA_EMITTERS.get(emitter_xml, emitter_xml)
    return f"""
    <scene version="0.5.0">
      <integrator type="{integrator}">
        <integer name="maxDepth" value="{max_depth}"/>
        <integer name="rrDepth" value="100"/>
      </integrator>
      <sensor type="perspective">
        <float name="fov" value="60"/>
        <transform name="toWorld">
          <lookat origin="0,1,-3.5" target="0,0.5,0" up="0,1,0"/>
        </transform>
        <sampler type="independent">
          <integer name="sampleCount" value="{spp}"/>
        </sampler>
        <film type="hdrfilm">
          <integer name="width" value="{width}"/>
          <integer name="height" value="{height}"/>
          <rfilter type="box"/>
        </film>
      </sensor>
      <shape type="rectangle">
        <transform name="toWorld">
          <rotate x="1" angle="-90"/>
          <scale value="4"/>
        </transform>
        <bsdf type="diffuse">
          <rgb name="reflectance" value="0.6, 0.5, 0.4"/>
        </bsdf>
      </shape>
      <shape type="rectangle">
        <transform name="toWorld">
          <scale value="4"/>
          <translate z="2"/>
        </transform>
        <bsdf type="diffuse">
          <rgb name="reflectance" value="0.4, 0.5, 0.6"/>
        </bsdf>
      </shape>
      {emitter_xml}
    </scene>"""


def bdpt_media_xml(integrator="bdpt", max_depth=6, spp=96, width=24, height=24, extra=""):
    """tests/test_bdpt.py's media scene: a homogeneous fog in a `null`
    analytic sphere over a floor, under a rectangular area light, and
    `extra` (a key of DELTA_EMITTERS or XML) beside them."""
    extra = DELTA_EMITTERS.get(extra, extra)
    return f"""
    <scene version="0.5.0">
      <integrator type="{integrator}">
        <integer name="maxDepth" value="{max_depth}"/>
        <integer name="rrDepth" value="100"/>
      </integrator>
      <sensor type="perspective">
        <float name="fov" value="50"/>
        <transform name="toWorld">
          <lookat origin="0,0.5,-3" target="0,0.3,0" up="0,1,0"/>
        </transform>
        <sampler type="independent">
          <integer name="sampleCount" value="{spp}"/></sampler>
        <film type="hdrfilm">
          <integer name="width" value="{width}"/>
          <integer name="height" value="{height}"/>
          <rfilter type="box"/></film>
      </sensor>
      <shape type="sphere">
        <float name="radius" value="1.2"/>
        <bsdf type="null"/>
        <medium name="interior" type="homogeneous">
          <rgb name="sigmaS" value="0.5, 0.5, 0.5"/>
          <rgb name="sigmaA" value="0.05, 0.05, 0.05"/>
        </medium>
      </shape>
      <shape type="rectangle">
        <transform name="toWorld">
          <rotate x="1" angle="90"/>
          <translate y="2.2"/>
        </transform>
        <emitter type="area">
          <rgb name="radiance" value="6, 5, 4"/>
        </emitter>
      </shape>
      <shape type="rectangle">
        <transform name="toWorld">
          <rotate x="1" angle="-90"/>
          <scale value="4"/>
          <translate y="-1.4"/>
        </transform>
        <bsdf type="diffuse">
          <rgb name="reflectance" value="0.5, 0.5, 0.5"/>
        </bsdf>
      </shape>
      {extra}
    </scene>"""


def glass_xml(width=None, height=None, max_depth=None):
    """scenes/glass_caustics.xml (bdpt; 1,026 triangles with its emissive
    sphere tessellated, one analytic glass sphere), optionally at another
    film size or maxDepth."""
    with open(GLASS_XML) as f:
        xml = f.read()
    if max_depth is not None:
        xml, n = re.subn(r'name="maxDepth" value="\d+"', f'name="maxDepth" value="{max_depth}"',
                         xml)
        if n != 1:
            raise ValueError(f"{GLASS_XML} holds {n} maxDepth values, expected one")
    return _film_size(xml, width, height)


def with_integrator(xml, kind, max_depth=None):
    """`xml` with its integrator replaced by `kind` (keeping maxDepth and
    rrDepth unless max_depth is given)."""
    xml, n = re.subn(r'<integrator type="\w+"', f'<integrator type="{kind}"', xml, count=1)
    if n != 1:
        raise ValueError("no integrator in the scene")
    if max_depth is not None:
        xml = re.sub(r'name="maxDepth" value="-?\d+"', f'name="maxDepth" value="{max_depth}"',
                     xml, count=1)
    return xml


def cbox_ptracer_xml(width=None, height=None):
    """scenes/cbox.xml under the particle tracer (its maxDepth 16),
    optionally at another film size."""
    with open(CBOX_XML) as f:
        return _film_size(with_integrator(f.read(), "ptracer"), width, height)


def delta_mix_xml(integrator="path", max_depth=4, spp=8, width=24, height=24):
    """The two-wall scene lit by all four delta lights at once and a small
    area light (sampling weights 1, 2, 1, 1, 0.5), so that the emitter
    pick reaches every kind."""
    area = """<shape type="rectangle">
      <transform name="toWorld"><scale value="0.3"/><rotate x="1" angle="90"/>
        <translate x="-1" y="2.5" z="0.5"/></transform>
      <emitter type="area"><rgb name="radiance" value="5, 5, 4"/>
        <float name="samplingWeight" value="0.5"/></emitter></shape>"""
    lights = "".join(
        DELTA_EMITTERS[k].replace(
            "</emitter>", f'<float name="samplingWeight" value="{wgt}"/></emitter>'
        )
        for k, wgt in (("point", 1), ("spot", 2), ("directional", 1), ("collimated", 1))
    )
    return two_wall_xml(lights + area, integrator, max_depth, spp, width, height)


# ---- the Metropolis slice: pssmlt, mlt, erpt ----

DOOR_XML = os.path.join(ROOT, "scenes", "door.xml")


def with_properties(xml, props):
    """`xml` with `props` (XML property elements) added to its integrator."""
    xml, n = re.subn(r'(<integrator type="\w+"\s*>)', r"\1" + props, xml, count=1)
    if n != 1:
        raise ValueError("no integrator element with children in the scene")
    return xml


def door_xml(width=None, height=None, luminance_samples=None, bidirectional=True):
    """scenes/door.xml (pssmlt, maxDepth 8; 1,096 triangles with its
    emissive sphere tessellated, an analytic rough-copper sphere),
    optionally at another film size, with fewer bootstrap samples
    (luminanceSamples, 100,000 by default) or with the unidirectional
    technique."""
    with open(DOOR_XML) as f:
        xml = _film_size(f.read(), width, height)
    props = ""
    if luminance_samples is not None:
        props += f'<integer name="luminanceSamples" value="{luminance_samples}"/>'
    if not bidirectional:
        props += '<boolean name="bidirectional" value="false"/>'
    return with_properties(xml, props) if props else xml


def cbox_chain_xml(kind, width=24, height=24, max_depth=4, luminance_samples=1024,
                   chain_length=None):
    """scenes/cbox.xml under a chain integrator (mlt or erpt; the
    reference's tests/test_mlt.py takes cbox at 24x24, maxDepth 4)."""
    with open(CBOX_XML) as f:
        xml = _film_size(with_integrator(f.read(), kind, max_depth=max_depth), width, height)
    props = f'<integer name="luminanceSamples" value="{luminance_samples}"/>'
    if chain_length is not None:
        props += f'<integer name="chainLength" value="{chain_length}"/>'
    return with_properties(xml, props)


def glass_manifold_xml(width=16, height=16, max_depth=6, luminance_samples=1024):
    """scenes/glass_caustics.xml under mlt with the manifold perturbation
    (the reference's tests/test_manifold_mlt.py takes maxDepth 6)."""
    xml = with_integrator(glass_xml(width, height), "mlt", max_depth=max_depth)
    return with_properties(xml, f'<integer name="luminanceSamples" value="{luminance_samples}"/>'
                                '<boolean name="manifoldPerturbation" value="true"/>')


# ---- the photon-mapping slice: sppm, ppm, photonmapper, vpl ----

def cbox_xml(kind, width=None, height=None, max_depth=None):
    """scenes/cbox.xml (maxDepth 16) under the integrator `kind`,
    optionally at another film size or maxDepth."""
    with open(CBOX_XML) as f:
        return _film_size(with_integrator(f.read(), kind, max_depth=max_depth), width, height)


# tests/test_photonmapper.py's scene: a homogeneous slab (sigma_s 1.6, 1.5,
# 1.4; sigma_a 0.12, 0.12, 0.18; hg g = 0.2) in a `null` cube on a diffuse
# floor, lit by an emissive sphere; maxDepth 6, 32x32
HOMOG_SLAB_XML = """
<scene version="0.5.0">
  <integrator type="{integ}">
    <integer name="maxDepth" value="6"/>
  </integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="toWorld">
      <lookat origin="0, 0.6, -2.2" target="0, 0.35, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sampleCount" value="4"/></sampler>
    <film type="hdrfilm">
      <integer name="width" value="32"/><integer name="height" value="32"/>
      <rfilter type="box"/>
    </film>
  </sensor>
  <shape type="cube">
    <transform name="toWorld">
      <scale x="0.45" y="0.45" z="0.45"/><translate y="0.45"/>
    </transform>
    <bsdf type="null"/>
    <medium name="interior" type="homogeneous">
      <rgb name="sigmaS" value="1.6, 1.5, 1.4"/>
      <rgb name="sigmaA" value="0.12, 0.12, 0.18"/>
      <phase type="hg"><float name="g" value="0.2"/></phase>
    </medium>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld">
      <scale value="3"/><rotate x="1" angle="-90"/>
    </transform>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.5, 0.45, 0.4"/></bsdf>
  </shape>
  <shape type="sphere">
    <point name="center" x="1.8" y="2.6" z="-1.2"/>
    <float name="radius" value="0.35"/>
    <emitter type="area"><rgb name="radiance" value="60, 58, 52"/></emitter>
  </shape>
</scene>
"""


def homog_slab_xml(integrator="photonmapper", media=True, width=None, height=None, lift=0.0):
    """HOMOG_SLAB_XML under `integrator`; without its medium when media is
    false (the cube stays, a `null` box), optionally at another film size;
    with `lift`, the cube raised off the floor by that much (its bottom
    face otherwise lies in the floor's plane)."""
    xml = HOMOG_SLAB_XML.format(integ=integrator)
    if lift:
        xml = xml.replace('<translate y="0.45"/>', f'<translate y="{0.45 + lift}"/>')
    if not media:
        xml = re.sub(r'<medium name="interior".*?</medium>', "", xml, flags=re.S)
    return _film_size(xml, width, height)


# ---- the subsurface slice, the path family and the meta-integrators ----

DIPOLE_XML = os.path.join(ROOT, "scenes", "dipole.xml")


def dipole_xml(width=None, height=None, kind="dipole", props="", irr_samples=None):
    """scenes/dipole.xml (path, maxDepth 8; a skimmilk dipole sphere with
    irrSamples 32 on a diffuse slab, lit by an emissive sphere: 1,036
    triangles and one analytic sphere), optionally at another film size,
    with the subsurface plugin `kind` ("dipole" or "singlescatter"),
    another irrSamples, and `props` (XML property elements) added to it."""
    with open(DIPOLE_XML) as f:
        xml = _film_size(f.read(), width, height)
    if irr_samples is not None:
        xml = xml.replace('name="irrSamples" value="32"', f'name="irrSamples" value="{irr_samples}"')
    xml, n = re.subn(r'<subsurface type="dipole">', f'<subsurface type="{kind}">{props}', xml)
    if n != 1:
        raise ValueError(f"{DIPOLE_XML} holds {n} dipole elements, expected one")
    return xml


def cbox_meta_xml(kind, nested, width=24, height=24, props=""):
    """scenes/cbox.xml under the meta-integrator `kind` (adaptive,
    irrcache or multichannel) over the `nested` integrator elements, with
    `props` added to it."""
    return with_properties(cbox_xml(kind, width, height), props + nested)


# nested integrators of the meta-integrator tests
NESTED_PATH = '<integrator type="path"><integer name="maxDepth" value="4"/></integrator>'
NESTED_DIRECT = '<integrator type="direct"/>'


# ---- the hairball slice and the rest of the BSDFs ----

HAIRBALL_XML = os.path.join(ROOT, "scenes", "hairball.xml")


def hairball_xml(width=None, height=None, exact=False):
    """scenes/hairball.xml (path, maxDepth 6; 1,200 fibers of
    scenes/assets/hairball.hair at radius 0.012 under phong, a diffuse
    sphere, a constant environment and an emissive sphere) with the
    fibers' file name made absolute, optionally at another film size, and
    with `exact` the fibers as miter-clipped cylinder segments instead of
    tessellated tubes."""
    with open(HAIRBALL_XML) as f:
        xml = f.read()
    hair = os.path.join(ROOT, "scenes", "assets", "hairball.hair")
    xml, n = re.subn(r'value="assets/hairball.hair"', f'value="{hair}"', xml)
    if n != 1:
        raise ValueError(f"{HAIRBALL_XML} names {n} hairball.hair files, expected one")
    if exact:
        xml, n = re.subn(r'(<string name="filename" value="[^"]*hairball.hair"/>)',
                         r'\1<boolean name="exact" value="true"/>', xml)
    return _film_size(xml, width, height)


# the BSDFs of each gallery golden, one per sphere of scenes/matpreview.xml
# (left to right: its gold, plastic and copper spheres); every type the
# materials slice did not port, the wrappers twosided and mask, a coating
# over phong, a rough coating over diffuse, and an N-ary mixture holding a
# blend (weights below one: the deficit is absorbed)
BSDF_GALLERIES = {
    "glossy": (
        '<bsdf type="roughdiffuse"><rgb name="reflectance" value="0.7, 0.4, 0.2"/>'
        '<float name="alpha" value="0.6"/></bsdf>',
        '<bsdf type="phong"><rgb name="diffuseReflectance" value="0.1, 0.3, 0.5"/>'
        '<rgb name="specularReflectance" value="0.4"/><float name="exponent" value="40"/></bsdf>',
        '<bsdf type="twosided"><bsdf type="ward"><float name="alphaU" value="0.08"/>'
        '<float name="alphaV" value="0.3"/><rgb name="diffuseReflectance" value="0.3, 0.2, 0.1"/>'
        '<rgb name="specularReflectance" value="0.5"/></bsdf></bsdf>',
    ),
    "thin": (
        '<bsdf type="thindielectric"><float name="intIOR" value="1.6"/></bsdf>',
        '<bsdf type="difftrans"><rgb name="transmittance" value="0.6, 0.7, 0.4"/></bsdf>',
        '<bsdf type="hk"><rgb name="sigmaS" value="1.5, 2, 2.5"/><rgb name="sigmaA" value="0.1"/>'
        '<float name="thickness" value="0.5"/><phase type="hg"><float name="g" value="0.4"/>'
        '</phase></bsdf>',
    ),
    "layered": (
        '<bsdf type="mask"><rgb name="opacity" value="0.5"/><bsdf type="coating">'
        '<float name="intIOR" value="1.5"/><rgb name="sigmaA" value="0.2, 0.4, 0.8"/>'
        '<bsdf type="phong"><rgb name="diffuseReflectance" value="0.6, 0.2, 0.2"/>'
        '<float name="exponent" value="15"/></bsdf></bsdf></bsdf>',
        '<bsdf type="roughcoating"><float name="alpha" value="0.2"/>'
        '<string name="distribution" value="ggx"/>'
        '<bsdf type="diffuse"><rgb name="reflectance" value="0.2, 0.5, 0.3"/></bsdf></bsdf>',
        '<bsdf type="mixturebsdf"><string name="weights" value="0.4 0.3 0.2"/>'
        '<bsdf type="diffuse"><rgb name="reflectance" value="0.8, 0.8, 0.2"/></bsdf>'
        '<bsdf type="roughconductor"><float name="alpha" value="0.15"/></bsdf>'
        '<bsdf type="blendbsdf"><float name="weight" value="0.3"/>'
        '<bsdf type="dielectric"/><bsdf type="roughplastic"><float name="alpha" value="0.3"/>'
        '</bsdf></bsdf></bsdf>',
    ),
}


def bsdf_gallery_xml(kind, width=None, height=None, integrator=None, max_depth=None):
    """`matpreview_const_xml` with its three spheres' BSDFs replaced by
    BSDF_GALLERIES[kind], optionally at another film size and under
    another integrator or maxDepth."""
    xml = matpreview_const_xml(width, height)
    bsdfs = iter(BSDF_GALLERIES[kind])
    head, _, spheres = xml.partition("<!-- rough gold sphere -->")
    spheres, n = re.subn(r'<bsdf type="(roughconductor|roughplastic|conductor)">.*?</bsdf>',
                         lambda m: next(bsdfs), spheres, flags=re.S)
    if n != 3:
        raise ValueError(f"{MATPREVIEW_XML} holds {n} sphere BSDFs, expected three")
    xml = head + "<!-- rough gold sphere -->" + spheres
    if integrator is not None or max_depth is not None:
        xml = with_integrator(xml, integrator or "path", max_depth)
    return xml


# ---- the texture slice: bitmaps with mip maps, the procedural and
# geometry-driven textures, bump and normal maps, and the irawan cloth ----

SKY_EXR = os.path.join(ROOT, "scenes", "assets", "sky.exr")


def write_pfm(path, img):
    """A float32 PFM ("PF", little-endian) of an [H, W, 3] image, top row
    first in `img` (PFM stores the bottom row first)."""
    img = np.ascontiguousarray(np.asarray(img, np.float32)[::-1])
    with open(path, "wb") as f:
        f.write(f"PF\n{img.shape[1]} {img.shape[0]}\n-1.0\n".encode("ascii"))
        f.write(img.astype("<f4").tobytes())


def lat_long_sphere(n_phi, n_theta):
    """A unit sphere of (n_theta + 1) x (n_phi + 1) vertices, with uv, as
    the renderers tessellate one (2 n_phi n_theta triangles, those at the
    poles degenerate).  Returns (positions, indices, uv)."""
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi + 1)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    pos = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)],
                   axis=-1).reshape(-1, 3)
    uv = np.stack([pp / (2 * np.pi), 1.0 - tt / np.pi], axis=-1).reshape(-1, 2)
    idx = []
    for i in range(n_theta):
        for j in range(n_phi):
            a = i * (n_phi + 1) + j
            b = a + n_phi + 1
            idx += [[a, b, a + 1], [a + 1, b, b + 1]]
    return pos.astype(np.float32), np.asarray(idx, np.uint32), uv.astype(np.float32)


def textured_assets(directory, seed=0):
    """Write TEXTURED's assets, drawn from np.random.default_rng(seed),
    into `directory`: height.pfm (64 x 64, heights in [0, 0.01)),
    normal.pfm (128 x 128, tangent-space normals tilted by up to ~17
    degrees, encoded as (n + 1) / 2) and ball.ply (the 24 x 12 sphere,
    576 triangles, with per-vertex colours).  Returns the directory."""
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    write_pfm(os.path.join(directory, "height.pfm"),
              np.repeat(0.01 * rng.random((64, 64, 1)), 3, axis=-1))
    n = np.concatenate([0.3 * rng.uniform(-1, 1, (128, 128, 2)), np.ones((128, 128, 1))], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    write_pfm(os.path.join(directory, "normal.pfm"), 0.5 * (n + 1.0))
    pos, idx, uv = lat_long_sphere(24, 12)
    colors = rng.integers(0, 256, (len(pos), 3)).astype(np.uint8)
    write_ply(os.path.join(directory, "ball.ply"), pos, idx, normals=pos, texcoords=uv,
              colors=colors)
    return directory


def _ball(asset_dir, x, texture):
    return f"""
  <shape type="ply">
    <string name="filename" value="{os.path.join(asset_dir, 'ball.ply')}"/>
    <transform name="toWorld"><scale value="0.35"/><translate x="{x}" y="0.35" z="-0.4"/>
    </transform>
    <bsdf type="diffuse">{texture}</bsdf>
  </shape>"""


def textured_xml(asset_dir, width=None, height=None, spp=16):
    """TEXTURED, the texture slice's scene (path, maxDepth 6, independent
    sampler, gaussian filter, 512 x 512 unless given), over the assets of
    `textured_assets`:

    * the floor, an 8 x 8 rectangle under diffuse, its reflectance a
      `scale` (0.002) over a `bitmap` of scenes/assets/sky.exr (512 x 256,
      HDR) repeated 4 x 4: seen at grazing angles, the mip levels and the
      anisotropic probes;
    * the back wall, a `bumpmap` of height.pfm over roughplastic;
    * an analytic sphere, a `normalmap` of normal.pfm over diffuse with a
      `gridtexture` reflectance;
    * three PLY spheres (576 triangles each, vertex colours) under
      `vertexcolors`, `wireframe` (automatic line width) and `curvature`
      (mean);
    * the cloth, a rectangle under twosided irawan (preset "plain",
      repeatU = repeatV = 8);
    * an emissive sphere (tessellated: 1,024 triangles) and a constant
      environment.
    """
    xml = f"""<scene version="0.5.0">
  <integrator type="path"><integer name="maxDepth" value="6"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="toWorld"><lookat origin="0, 1.3, -4.6" target="0, 0.55, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sampleCount" value="{spp}"/></sampler>
    <film type="hdrfilm"><integer name="width" value="512"/><integer name="height" value="512"/>
      <rfilter type="gaussian"/></film>
  </sensor>
  <shape type="rectangle">
    <transform name="toWorld"><scale value="4"/><rotate x="1" angle="-90"/></transform>
    <bsdf type="diffuse">
      <texture name="reflectance" type="scale">
        <spectrum name="scale" value="0.002"/>
        <texture type="bitmap">
          <string name="filename" value="{SKY_EXR}"/>
          <float name="uscale" value="4"/><float name="vscale" value="4"/>
        </texture>
      </texture>
    </bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld"><scale x="4" y="2.5" z="1"/><rotate y="1" angle="180"/>
      <translate y="2.5" z="2"/></transform>
    <bsdf type="bumpmap">
      <texture type="bitmap">
        <string name="filename" value="{os.path.join(asset_dir, 'height.pfm')}"/>
        <float name="uscale" value="3"/><float name="vscale" value="2"/>
      </texture>
      <bsdf type="roughplastic">
        <float name="alpha" value="0.2"/>
        <rgb name="diffuseReflectance" value="0.55, 0.45, 0.35"/>
      </bsdf>
    </bsdf>
  </shape>
  <shape type="sphere">
    <point name="center" x="-1.45" y="0.6" z="0.2"/><float name="radius" value="0.6"/>
    <bsdf type="normalmap">
      <texture type="bitmap">
        <string name="filename" value="{os.path.join(asset_dir, 'normal.pfm')}"/>
      </texture>
      <bsdf type="diffuse">
        <texture name="reflectance" type="gridtexture">
          <rgb name="color0" value="0.7, 0.6, 0.2"/><rgb name="color1" value="0.1, 0.1, 0.3"/>
          <float name="lineWidth" value="0.05"/>
          <float name="uscale" value="6"/><float name="vscale" value="3"/>
        </texture>
      </bsdf>
    </bsdf>
  </shape>
  {_ball(asset_dir, -0.45, '<texture name="reflectance" type="vertexcolors"/>')}
  {_ball(asset_dir, 0.35, '<texture name="reflectance" type="wireframe"/>')}
  {_ball(asset_dir, 1.15, '<texture name="reflectance" type="curvature"><float name="scale" value="0.3"/></texture>')}
  <shape type="rectangle">
    <transform name="toWorld"><scale x="0.7" y="0.9" z="1"/><rotate y="1" angle="150"/>
      <translate x="2.1" y="0.9" z="0.6"/></transform>
    <bsdf type="twosided">
      <bsdf type="irawan">
        <string name="preset" value="plain"/>
        <float name="repeatU" value="8"/><float name="repeatV" value="8"/>
      </bsdf>
    </bsdf>
  </shape>
  <shape type="sphere">
    <point name="center" x="0.3" y="3.3" z="-1.2"/><float name="radius" value="0.4"/>
    <emitter type="area"><rgb name="radiance" value="18, 16, 13"/></emitter>
  </shape>
  <emitter type="constant"><rgb name="radiance" value="0.25, 0.27, 0.3"/></emitter>
</scene>"""
    return _film_size(xml, width, height)


def write_png(path, img):
    """An 8-bit RGB PNG of an [H, W, 3] image in [0, 1] (no gamma:
    the values are stored as they are)."""
    import struct
    import zlib

    a = np.clip(np.round(np.asarray(img, np.float64) * 255.0), 0, 255).astype(np.uint8)
    raw = b"".join(b"\x00" + row.tobytes() for row in a)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", a.shape[1], a.shape[0], 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


def feature_assets(directory, seed=0):
    """TEXTURED's assets (`textured_assets`) and those of the feature
    scenes: checker.png (a 64 x 64 two-texel checker, LDR), quad.ply
    (tests/test_geom_textures.py's quad with red, green, blue and white
    corners) and sphere.ply (the 24 x 12 sphere without colours).
    Returns the directory."""
    textured_assets(directory, seed)
    yy, xx = np.mgrid[0:64, 0:64]
    checker = (((xx // 2) + (yy // 2)) % 2).astype(np.float32)
    write_png(os.path.join(directory, "checker.png"),
              np.stack([checker, 0.3 + 0.5 * checker, 1.0 - checker], axis=-1))
    quad = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    write_ply(os.path.join(directory, "quad.ply"), quad, np.array([[0, 1, 2], [0, 2, 3]]),
              fmt="ascii", colors=np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255],
                                            [255, 255, 255]], np.uint8))
    pos, idx, _ = lat_long_sphere(24, 12)
    write_ply(os.path.join(directory, "sphere.ply"), pos, idx)
    return directory


def bitmap_xml(asset_dir, width=24, height=24, spp=4):
    """The bitmap feature scene (path, maxDepth 3, 24 x 24): a floor
    seen at grazing angles under checker.png (sRGB-linearized) repeated
    8 x 8, a wall under a `scale` of normal.pfm picked by nearest texels,
    a sphere under the same PFM with gamma ignored for HDR files, and a
    constant environment.  MTS_TEX_FILTER chooses the footprint's filter
    ("feline" or "ewa")."""
    nm = os.path.join(asset_dir, "normal.pfm")
    xml = f"""<scene version="0.5.0">
  <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="50"/>
    <transform name="toWorld"><lookat origin="0, 0.6, -4" target="0, 0.2, 2" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sampleCount" value="{spp}"/></sampler>
    <film type="hdrfilm"><integer name="width" value="24"/><integer name="height" value="24"/>
      <rfilter type="box"/></film>
  </sensor>
  <shape type="rectangle">
    <transform name="toWorld"><scale value="6"/><rotate x="1" angle="-90"/></transform>
    <bsdf type="diffuse"><texture name="reflectance" type="bitmap">
      <string name="filename" value="{os.path.join(asset_dir, 'checker.png')}"/>
      <float name="uscale" value="8"/><float name="vscale" value="8"/>
    </texture></bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld"><scale value="2"/><rotate y="1" angle="180"/>
      <translate x="1.5" y="1.5" z="4"/></transform>
    <bsdf type="diffuse"><texture name="reflectance" type="scale">
      <rgb name="scale" value="0.9, 0.7, 0.5"/>
      <texture type="bitmap"><string name="filename" value="{nm}"/>
        <string name="filterType" value="nearest"/><float name="uscale" value="2"/>
      </texture>
    </texture></bsdf>
  </shape>
  <shape type="sphere">
    <point name="center" x="-1.2" y="0.7" z="1"/><float name="radius" value="0.7"/>
    <bsdf type="roughplastic"><texture name="diffuseReflectance" type="bitmap">
      <string name="filename" value="{nm}"/><float name="gamma" value="2.2"/>
      <float name="uoffset" value="0.25"/>
    </texture></bsdf>
  </shape>
  <emitter type="constant"><rgb name="radiance" value="1, 1, 1"/></emitter>
</scene>"""
    return _film_size(xml, width, height)


def bump_xml(kind, asset_dir=None, width=32, height=32, spp=4):
    """tests/test_bumpmap.py's scene (path, maxDepth 2, a rectangle seen
    head-on at 32 x 32) under its oblique directional light, the rectangle
    under `kind`: "plain" (diffuse), "flat" (a normal map of a constant
    (0.5, 0.5, 1) checkerboard), "tilted" (its tilted checkerboard) or
    "bump" (a bumpmap of height.pfm in `asset_dir`, repeated 4 x 4)."""
    bsdfs = {
        "plain": '<bsdf type="diffuse"/>',
        "flat": """<bsdf type="normalmap"><texture type="checkerboard">
          <rgb name="color0" value="0.5,0.5,1"/><rgb name="color1" value="0.5,0.5,1"/>
          </texture><bsdf type="diffuse"/></bsdf>""",
        "tilted": """<bsdf type="normalmap"><texture type="checkerboard">
          <rgb name="color0" value="0.9,0.5,0.6"/><rgb name="color1" value="0.1,0.5,0.6"/>
          </texture><bsdf type="diffuse"/></bsdf>""",
    }
    if kind == "bump":
        bsdfs["bump"] = f"""<bsdf type="bumpmap"><texture type="scale">
          <float name="scale" value="4"/><texture type="bitmap">
          <string name="filename" value="{os.path.join(asset_dir or '', 'height.pfm')}"/>
          <float name="uscale" value="4"/><float name="vscale" value="4"/></texture>
          </texture><bsdf type="diffuse"/></bsdf>"""
    return f"""<scene version="0.5.0">
  <integrator type="path"><integer name="maxDepth" value="2"/></integrator>
  <sensor type="perspective">
    <transform name="toWorld"><lookat origin="0,0,4" target="0,0,0" up="0,1,0"/></transform>
    <sampler type="independent"><integer name="sampleCount" value="{spp}"/></sampler>
    <film type="hdrfilm"><integer name="width" value="{width}"/>
      <integer name="height" value="{height}"/></film>
  </sensor>
  <emitter type="directional"><vector name="direction" x="0.6" y="-0.5" z="-0.8"/>
    <spectrum name="irradiance" value="2"/></emitter>
  <shape type="rectangle">{bsdfs[kind]}</shape>
</scene>"""


def geom_xml(kind, asset_dir, width=33, height=33, spp=4):
    """tests/test_geom_textures.py's scenes under the `field` integrator's
    albedo: quad.ply under `vertexcolors` or `wireframe` (edges black,
    lineWidth 0.08), or sphere.ply under `curvature` (mean, scale 0.5)."""
    tex = {
        "vertexcolors": '<texture name="reflectance" type="vertexcolors"/>',
        "wireframe": """<texture name="reflectance" type="wireframe">
          <rgb name="interiorColor" value="0.9, 0.9, 0.9"/><rgb name="edgeColor" value="0, 0, 0"/>
          <float name="lineWidth" value="0.08"/></texture>""",
        "curvature": """<texture name="reflectance" type="curvature">
          <string name="curvature" value="mean"/><float name="scale" value="0.5"/></texture>""",
    }[kind]
    mesh = os.path.join(asset_dir, "sphere.ply" if kind == "curvature" else "quad.ply")
    return f"""<scene version="0.5.0">
  <integrator type="field"><string name="field" value="albedo"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="40"/>
    <transform name="toWorld"><lookat origin="0,0,-4" target="0,0,0" up="0,1,0"/></transform>
    <sampler type="independent"><integer name="sampleCount" value="{spp}"/></sampler>
    <film type="hdrfilm"><integer name="width" value="{width}"/>
      <integer name="height" value="{height}"/><rfilter type="box"/></film>
  </sensor>
  <shape type="ply"><string name="filename" value="{mesh}"/>
    <bsdf type="diffuse">{tex}</bsdf></shape>
</scene>"""


def cloth_xml(width=24, height=24, spp=16):
    """tests/test_irawan.py's cloth (test_render_cloth): a rectangle under
    twosided irawan (preset "plain", repeatU = repeatV = 8) under a
    constant environment, path at maxDepth 4."""
    return f"""<scene version="0.5.0">
  <integrator type="path"><integer name="maxDepth" value="4"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="toWorld"><lookat origin="0,0,-4" target="0,0,0" up="0,1,0"/></transform>
    <sampler type="independent"><integer name="sampleCount" value="{spp}"/></sampler>
    <film type="hdrfilm"><integer name="width" value="{width}"/>
      <integer name="height" value="{height}"/><rfilter type="box"/></film>
  </sensor>
  <shape type="rectangle">
    <transform name="toWorld"><scale value="1.5"/></transform>
    <bsdf type="twosided"><bsdf type="irawan">
      <string name="preset" value="plain"/>
      <float name="repeatU" value="8"/><float name="repeatV" value="8"/>
    </bsdf></bsdf>
  </shape>
  <emitter type="constant"><rgb name="radiance" value="1,1,1"/></emitter>
</scene>"""


# ---- the sensors, the daylight emitters and spectral mode ----

DISPERSION_XML = os.path.join(ROOT, "scenes", "dispersion.xml")


def dispersion_xml(width=None, height=None):
    """scenes/dispersion.xml (a dispersive glass sphere over a diffuse
    floor, lit by a spot and a dim constant environment), optionally at
    another film size."""
    with open(DISPERSION_XML) as f:
        return _film_size(f.read(), width, height)


def with_thinlens(xml, aperture, focus):
    """`xml` with its perspective camera made a thinlens one of aperture
    radius `aperture`, focused at `focus`."""
    lens = (f'<sensor type="thinlens"><float name="apertureRadius" value="{aperture}"/>'
            f'<float name="focusDistance" value="{focus}"/>')
    xml, n = re.subn(r'<sensor type="perspective">', lens, xml)
    if n != 1:
        raise ValueError(f"{n} perspective sensors, expected one")
    return xml


DAYLIGHT_SUNSKY = ('<emitter type="sunsky"><vector name="sunDirection" x="0.4" y="0.6" z="-0.5"/>'
                   '<float name="turbidity" value="3"/></emitter>')


def daylight_xml(width=None, height=None):
    """DAYLIGHT: scenes/matpreview.xml with a Hosek-Wilkie `sunsky` (sun
    direction (0.4, 0.6, -0.5), turbidity 3) in place of its envmap and a
    `thinlens` camera (aperture radius 0.05, focused at 4.5) in place of
    its perspective one; its sobol sampler and 128 spp stay."""
    with open(MATPREVIEW_XML) as f:
        xml = f.read()
    xml, n_env = re.subn(r'<emitter type="envmap">.*?</emitter>', DAYLIGHT_SUNSKY, xml, flags=re.S)
    if n_env != 1:
        raise ValueError(f"{MATPREVIEW_XML}: {n_env} envmaps, expected one")
    return _film_size(with_thinlens(xml, 0.05, 4.5), width, height)


def sky_sun_xml(width=None, height=None):
    """scenes/matpreview.xml lit by a Preetham `sky` (without its sun) and
    a separate `sun` emitter at the same direction, a lower sun than
    DAYLIGHT's and turbidity 4, with the independent sampler."""
    with open(MATPREVIEW_XML) as f:
        xml = f.read()
    sun = '<vector name="sunDirection" x="-0.5" y="0.35" z="-0.6"/><float name="turbidity" value="4"/>'
    sky = (f'<emitter type="sky"><string name="model" value="preetham"/>{sun}'
           '<integer name="resolution" value="256"/></emitter>'
           f'<emitter type="sun">{sun}<float name="scale" value="0.05"/></emitter>')
    xml, n_env = re.subn(r'<emitter type="envmap">.*?</emitter>', sky, xml, flags=re.S)
    xml, n_smp = re.subn(r'<sampler type="sobol">', '<sampler type="independent">', xml)
    if (n_env, n_smp) != (1, 1):
        raise ValueError(f"{MATPREVIEW_XML}: {n_env} envmaps and {n_smp} sobol samplers, "
                         "expected one of each")
    return _film_size(xml, width, height)


# the sensor gallery: tests/test_sensors.py's checkerboard (the albedo
# field of a 6 x 6 black-and-white checkerboard rectangle), each camera at
# its own settings
SENSOR_GALLERY = {
    "orthographic": ("orthographic", "", False),
    "telecentric": ("telecentric", '<float name="apertureRadius" value="0.4"/>'
                    '<float name="focusDistance" value="0.5"/>', False),
    "spherical": ("spherical", "", False),
    "thinlens": ("thinlens", '<float name="apertureRadius" value="0.3"/>'
                 '<float name="focusDistance" value="2.5"/>', True),
    "rdist": ("perspective_rdist", '<string name="kc" value="-0.3, 0.05"/>', True),
    "perspective": ("perspective", "", True),
}


def sensor_xml(name, width=24, height=24, spp=4):
    """tests/test_sensors.py's checkerboard scene under the camera
    SENSOR_GALLERY[name] (looking at the board from z = -3)."""
    kind, extra, fov = SENSOR_GALLERY[name]
    fov_xml = '<float name="fov" value="45"/>' if fov else ""
    return f"""<scene version="0.5.0">
  <integrator type="field"><string name="field" value="albedo"/></integrator>
  <sensor type="{kind}">{fov_xml}
    <transform name="toWorld"><lookat origin="0,0,-3" target="0,0,0" up="0,1,0"/></transform>
    {extra}
    <sampler type="independent"><integer name="sampleCount" value="{spp}"/></sampler>
    <film type="hdrfilm"><integer name="width" value="{width}"/>
      <integer name="height" value="{height}"/><rfilter type="box"/></film>
  </sensor>
  <shape type="rectangle">
    <transform name="toWorld"><scale value="3"/></transform>
    <bsdf type="diffuse">
      <texture name="reflectance" type="checkerboard">
        <rgb name="color0" value="1, 1, 1"/><rgb name="color1" value="0, 0, 0"/>
        <float name="uscale" value="6"/><float name="vscale" value="6"/>
      </texture>
    </bsdf>
  </shape>
</scene>"""


METER_FILM = ('<sampler type="independent"><integer name="sampleCount" value="64"/></sampler>'
              '<film type="hdrfilm"><integer name="width" value="1"/>'
              '<integer name="height" value="1"/><rfilter type="box"/></film>')
# the meters of tests/test_sensors.py in a unit constant environment:
# (body, the exact value: the average radiance 1, the irradiance pi)
METERS = {
    "fluencemeter": ('<sensor type="fluencemeter"><transform name="toWorld">'
                     f'<translate x="0.3" y="0" z="0"/></transform>{METER_FILM}</sensor>', 1.0),
    "radiancemeter": ('<sensor type="radiancemeter"><transform name="toWorld">'
                      f'<translate x="0.3" y="0" z="0"/></transform>{METER_FILM}</sensor>', 1.0),
    "irradiancemeter_sphere": ('<shape type="sphere"><float name="radius" value="0.7"/>'
                               f'<bsdf type="diffuse"/><sensor type="irradiancemeter">{METER_FILM}'
                               '</sensor></shape>', float(np.pi)),
    "irradiancemeter_mesh": ('<shape type="rectangle"><bsdf type="diffuse"/>'
                             f'<sensor type="irradiancemeter">{METER_FILM}</sensor></shape>',
                             float(np.pi)),
}


def meter_xml(body, integrator="path"):
    """tests/test_sensors.py's meter scene: `body` (a sensor, or a shape
    holding one) in a unit constant environment, path at maxDepth 2."""
    return (f'<scene version="0.5.0"><integrator type="{integrator}">'
            f'<integer name="maxDepth" value="2"/></integrator>{body}'
            '<emitter type="constant"><rgb name="radiance" value="1,1,1"/></emitter></scene>')


# ---- the motion slice: animated and deformable shapes, the shutter ----

def _animation(before, after, x_shift):
    """An <animation> of keyframes at times 0 and 1: the transform
    `before` + `after`, then a translation by x_shift at time 1."""
    return (f'<animation name="toWorld"><transform time="0">{before}{after}</transform>'
            f'<transform time="1">{before}{after}<translate x="{x_shift}"/></transform>'
            '</animation>')


# the deformable card of MOTION: three keyframe rectangles at times 0, 0.5
# and 1 on a bent path (a straight one would hide the segment select)
_DEFORM_CARD = """
  <shape type="deformable">
    <string name="times" value="0, 0.5, 1"/>
    {frames}
    <bsdf type="diffuse"><rgb name="reflectance" value="0.2, 0.3, 0.8"/></bsdf>
  </shape>"""
_CARD_FRAMES = ((150.0, 330.0), (290.0, 420.0), (400.0, 340.0))


def motion_xml(width=None, height=None, spp=16):
    """MOTION: scenes/cbox.xml with its short block on an <animation> that
    translates it by 0.3 of the room's width (166.8) along x over the
    shutter, a deformable card of three keyframes at times 0, 0.5 and 1,
    and a perspective sensor whose shutter is open from 0 to 1; path at
    cbox's maxDepth 16.  24 static triangles (K1/K2), 12 animated, 2
    deformable."""
    with open(CBOX_XML) as f:
        xml = f.read()
    short = (r'<scale x="82.5" y="82.5" z="82.5"/>\s*<rotate y="1" angle="-17"/>\s*'
             r'<translate x="185" y="82.5" z="169"/>')
    pat = r'<transform name="toWorld">\s*(' + short + r')\s*</transform>'
    xml, n = re.subn(pat, lambda m: _animation(m.group(1), "", 166.8), xml)
    if n != 1:
        raise ValueError(f"{CBOX_XML}: {n} short blocks, expected one")
    frames = "".join(
        f'<shape type="rectangle"><transform name="toWorld"><scale x="60" y="60" z="1"/>'
        f'<rotate y="1" angle="180"/><translate x="{x}" y="{y}" z="300"/></transform></shape>'
        for x, y in _CARD_FRAMES)
    xml = xml.replace("</scene>", _DEFORM_CARD.format(frames=frames) + "\n</scene>")
    xml = xml.replace('<sampler type="independent">',
                      '<float name="shutterOpen" value="0"/><float name="shutterClose" value="1"/>'
                      '<sampler type="independent">', 1)
    xml = re.sub(r'(name="sampleCount" value=")\d+', rf"\g<1>{spp}", xml, count=1)
    return _film_size(xml, width, height)


# MOTION_BIG's animated cube: beside the stand-in, moving 0.08 along -x
MOTION_BIG_CUBE = (
    '<shape type="cube">' + _animation('<scale value="0.015"/>', '<translate x="0.05" y="0.07" '
                                       'z="0.03"/>', -0.08)
    + '<bsdf type="diffuse"><rgb name="reflectance" value="0.8, 0.3, 0.2"/></bsdf></shape>')


def cube_cloud_xml(n=43, seed=0):
    """n small cubes at seeded places around the stand-in's centre (12 n
    triangles; 43 give 516, past BRUTE_FORCE_MAX_TRIS: the BVH path)."""
    g = np.random.default_rng(seed)
    pos = np.asarray(STANDIN_CENTER) + g.uniform(-0.06, 0.06, (n, 3))
    return "".join(
        f'<shape type="cube"><transform name="toWorld"><scale value="0.008"/>'
        f'<rotate x="{ax:.4f}" y="{ay:.4f}" z="1" angle="{ang:.3f}"/>'
        f'<translate x="{p[0]:.5f}" y="{p[1]:.5f}" z="{p[2]:.5f}"/></transform>'
        '<bsdf type="diffuse"><rgb name="reflectance" value="0.65, 0.6, 0.5"/></bsdf></shape>'
        for p, ax, ay, ang in zip(pos, g.uniform(-1, 1, n), g.uniform(-1, 1, n),
                                  g.uniform(0, 180, n)))


def motion_big_xml(ply_path=None, width=None, height=None, spp=16):
    """MOTION_BIG: scenes/bunny.xml's configuration (its constant
    environment, path at maxDepth 5) with the static mesh at `ply_path`
    (bunny_standin(seed=0): 69,168 triangles, K3/K4/K7/K8), or without
    one 43 seeded cubes (516 static triangles: the BVH path at a size the
    CPU renders), beside an animated cube, under a shutter open from 0 to
    1."""
    if ply_path is not None:
        xml = bunny_scene_xml(ply_path, width, height)
    else:
        xml = bunny_scene_xml("PLACEHOLDER", width, height)
        xml, n = re.subn(r'<shape type="ply">.*?</shape>', cube_cloud_xml(), xml, flags=re.S)
        if n != 1:
            raise ValueError(f"{BUNNY_XML}: {n} ply shapes, expected one")
    xml = xml.replace("</scene>", MOTION_BIG_CUBE + "\n</scene>")
    xml = xml.replace('<sampler type="independent">',
                      '<float name="shutterOpen" value="0"/><float name="shutterClose" value="1"/>'
                      '<sampler type="independent">', 1)
    return re.sub(r'(name="sampleCount" value=")\d+', rf"\g<1>{spp}", xml, count=1)


def motion_vectors_xml(config="d", width=32, height=32, time=1.0):
    """MOTION_VECTORS: MOTION under the `motion` integrator (screen-space
    motion to `time`, chain `config`), 1 spp."""
    xml = with_integrator(motion_xml(width, height, spp=1), "motion")
    return xml.replace('<integer name="maxDepth" value="16"/>',
                       f'<float name="time" value="{time}"/><string name="config" value="{config}"/>')


def glass_slab_motion_xml(config="ttd", glass=True, width=32, height=32):
    """tests/test_motion.py's motion-vector scene: a card translating by
    0.5 along x behind a thin glass slab (1.5 x 1.5 x 0.02) under a
    constant light, seen through a perspective sensor at 32 x 32, 1 spp."""
    slab = ('<shape type="cube"><transform name="toWorld"><scale x="1.5" y="1.5" z="0.02"/>'
            '</transform><bsdf type="dielectric"/></shape>') if glass else ""
    return f"""
    <scene version="0.5.0">
      <integrator type="motion">
        <float name="time" value="1.0"/><string name="config" value="{config}"/>
      </integrator>
      <sensor type="perspective"><float name="fov" value="40"/>
        <transform name="toWorld"><lookat origin="0,0,-3" target="0,0,0" up="0,1,0"/></transform>
        <sampler type="independent"><integer name="sampleCount" value="1"/></sampler>
        <film type="hdrfilm"><integer name="width" value="{width}"/>
          <integer name="height" value="{height}"/><rfilter type="box"/></film>
      </sensor>
      {slab}
      <shape type="rectangle">
        <animation name="toWorld">
          <transform time="0"><rotate y="1" angle="180"/><translate z="1"/></transform>
          <transform time="1"><rotate y="1" angle="180"/><translate x="0.5" z="1"/></transform>
        </animation>
        <bsdf type="diffuse"/>
      </shape>
      <emitter type="constant"><rgb name="radiance" value="1"/></emitter>
    </scene>"""


def moving_card_xml(kind="animated", frames=2, spp=64, width=64, height=64):
    """tests/test_motion.py's and tests/test_deformable.py's scene: an
    emissive card (0.5 x 1.2) sweeping x from -0.75 to +0.75 over the
    shutter under an orthographic camera, path at maxDepth 2, a black
    background.  kind "animated": a rigid <animation> (no static
    triangles: occluded's intersect branch); "deformable": `frames`
    keyframes on the same straight sweep at evenly spaced times."""
    card = '<scale x="0.25" y="0.6" z="1"/><rotate y="1" angle="180"/>'
    emitter = '<emitter type="area"><rgb name="radiance" value="1, 1, 1"/></emitter>'
    if kind == "animated":
        shape = (f'<shape type="rectangle"><animation name="toWorld">'
                 f'<transform time="0">{card}<translate x="-0.75"/></transform>'
                 f'<transform time="1">{card}<translate x="0.75"/></transform>'
                 f'</animation>{emitter}</shape>')
    else:
        xs = np.linspace(-0.75, 0.75, frames)
        times = ", ".join(f"{t:g}" for t in np.linspace(0.0, 1.0, frames))
        shape = (f'<shape type="deformable"><string name="times" value="{times}"/>'
                 + "".join(f'<shape type="rectangle"><transform name="toWorld">{card}'
                           f'<translate x="{x:g}"/></transform></shape>' for x in xs)
                 + f"{emitter}</shape>")
    return f"""
    <scene version="0.5.0">
      <integrator type="path"><integer name="maxDepth" value="2"/></integrator>
      <sensor type="orthographic">
        <transform name="toWorld"><lookat origin="0,0,-3" target="0,0,0" up="0,1,0"/></transform>
        <float name="shutterOpen" value="0"/><float name="shutterClose" value="1"/>
        <sampler type="independent"><integer name="sampleCount" value="{spp}"/></sampler>
        <film type="hdrfilm"><integer name="width" value="{width}"/>
          <integer name="height" value="{height}"/><rfilter type="box"/></film>
      </sensor>
      {shape}
    </scene>"""


def card_coverage(x):
    """The analytic share of the shutter for which the moving card of
    moving_card_xml covers screen coordinate |x| (its centre -0.75 + 1.5
    t, half-width 0.25; tests/test_motion.py:64-91)."""
    lo = np.maximum((x - 0.25 + 0.75) / 1.5, 0.0)
    hi = np.minimum((x + 0.25 + 0.75) / 1.5, 1.0)
    return np.clip(hi - lo, 0.0, 1.0)


# ---- the remaining media: fiber phases, hgridvolume, volcache ----

def write_vol(path, grid, aabb_min=(0, 0, 0), aabb_max=(1, 1, 1)):
    """A float32 .vol file of grid [D, H, W(, C)] in the reference's
    save_vol format (mitsuba_tpu/medium/plugins.py:249)."""
    grid = np.asarray(grid, np.float32)
    if grid.ndim == 3:
        grid = grid[..., None]
    zres, yres, xres, c = grid.shape
    with open(path, "wb") as f:
        f.write(b"VOL" + bytes([3]))
        f.write(np.asarray([1, xres, yres, zres, c], "<i4").tobytes())
        f.write(np.asarray(list(aabb_min) + list(aabb_max), "<f4").tobytes())
        f.write(grid.astype("<f4").tobytes())


def _read_vol(path):
    with open(path, "rb") as f:
        blob = f.read()
    _, xres, yres, zres, c = np.frombuffer(blob, "<i4", 5, 4)
    box = np.frombuffer(blob, "<f4", 6, 24)
    return np.frombuffer(blob, "<f4", offset=48).reshape(zres, yres, xres, c), box


def fiber_assets(directory, seed=0):
    """Write FIBER's volumes into `directory` (created) and return it:
    orientation.vol, a 48^3 x 3 swirl about the plume's vertical axis
    (tangent, plus a third of the axis) with seeded jitter, over
    smoke.vol's box; and smoke.vol split into 2 x 2 x 2 blocks of 24^3,
    smoke_XXX_YYY_ZZZ.vol, with their dictionary smoke.hgrid (the box,
    the block resolution, the occupied blocks' coordinates)."""
    os.makedirs(directory, exist_ok=True)
    dens, box = _read_vol(os.path.join(ROOT, "scenes", "assets", "smoke.vol"))
    n = dens.shape[0]
    c = (np.arange(n) + 0.5) / n - 0.5
    z, _, x = np.meshgrid(c, c, c, indexing="ij")
    swirl = np.stack([-z, np.full_like(x, 0.3), x], axis=-1)
    swirl += 0.15 * np.random.default_rng(seed).normal(size=swirl.shape)
    swirl /= np.maximum(np.linalg.norm(swirl, axis=-1, keepdims=True), 1e-6)
    write_vol(os.path.join(directory, "orientation.vol"), swirl, box[:3], box[3:])
    b = n // 2
    blocks = []
    for bz in range(2):
        for by in range(2):
            for bx in range(2):
                write_vol(os.path.join(directory, f"smoke_{bx:03d}_{by:03d}_{bz:03d}.vol"),
                          dens[bz * b:(bz + 1) * b, by * b:(by + 1) * b, bx * b:(bx + 1) * b])
                blocks.append((bx, by, bz))
    with open(os.path.join(directory, "smoke.hgrid"), "wb") as f:
        f.write(np.asarray(box, "<f4").tobytes())
        f.write(np.asarray([2, 2, 2] + [i for blk in blocks for i in blk], "<i4").tobytes())
    return directory


FIBER_PHASES = {
    "kkay": '<phase type="kkay"><float name="ks" value="0.5"/><float name="kd" value="0.3"/>'
            '<float name="exponent" value="6"/></phase>',
    "microflake": '<phase type="microflake"><float name="stddev" value="0.25"/></phase>',
}


def _fiber_medium(xml, phase, asset_dir, density):
    """xml's smoke medium with the fiber `phase`, FIBER's orientation
    volume, and its density read through `density`: "grid" (smoke.vol's
    gridvolume), "hgrid" (the blocks' hgridvolume) or "volcache" (a
    volcache around the gridvolume)."""
    vol = os.path.join(ROOT, "scenes", "assets", "smoke.vol")
    grid = (f'<volume name="density" type="gridvolume"><string name="filename" value="{vol}"/>'
            "</volume>")
    src = {
        "grid": grid,
        "hgrid": '<volume name="density" type="hgridvolume"><string name="filename" value="'
                 + os.path.join(asset_dir, "smoke.hgrid")
                 + '"/><string name="prefix" value="smoke_"/><string name="postfix" '
                 'value=".vol"/></volume>',
        "volcache": '<volume name="density" type="volcache">'
                    + grid.replace(' name="density"', "") + "</volume>",
    }[density]
    xml, n = re.subn(r'<volume name="density" type="gridvolume">.*?</volume>', src, xml,
                     flags=re.S)
    orient = ('<volume name="orientation" type="gridvolume"><string name="filename" value="'
              + os.path.join(asset_dir, "orientation.vol") + '"/></volume>')
    xml, m = re.subn(r'<phase type="hg">.*?</phase>', orient + FIBER_PHASES[phase], xml,
                     flags=re.S)
    if (n, m) != (1, 1):
        raise ValueError(f"{n} density volumes and {m} hg phases, expected one of each")
    return xml


def fiber_xml(phase, asset_dir, density="grid", width=None, height=None):
    """FIBER: scenes/smoke.xml (volpath, 192^2 at 32 spp as it stands)
    with the fiber `phase` ("kkay": ks 0.5, kd 0.3, exponent 6;
    "microflake": stddev 0.25) on fiber_assets' orientation volume, the
    density read through `density` (see _fiber_medium), optionally at
    another film size."""
    return _fiber_medium(smoke_xml(width, height), phase, asset_dir, density)


def fiber_slab_xml(integrator, asset_dir, phase="kkay", width=16, height=16, spp=4,
                   max_depth=4):
    """The fiber slab: HOMOG_SLAB_XML's scene (lifted 0.01 off its floor,
    out of the coplanar ties of ROADMAP C) with FIBER's heterogeneous fiber
    medium in its cube in place of the homogeneous one, under
    `integrator`, at maxDepth `max_depth`."""
    medium = ('<medium name="interior" type="heterogeneous"><float name="scale" value="4"/>'
              '<volume name="density" type="gridvolume"><string name="filename" value="x"/>'
              '</volume><phase type="hg"><float name="g" value="0"/></phase></medium>')
    xml = homog_slab_xml(integrator, width=width, height=height, lift=0.01)
    xml = re.sub(r'<medium name="interior".*?</medium>', medium, xml, flags=re.S)
    xml = xml.replace('value="6"/>', f'value="{max_depth}"/>', 1)
    xml = re.sub(r'(name="sampleCount" value=")\d+', rf"\g<1>{spp}", xml, count=1)
    return _fiber_medium(xml, phase, asset_dir, "grid")
