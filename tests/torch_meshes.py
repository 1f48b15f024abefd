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
optionally at another film size.
"""

import os
import re

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY_XML = os.path.join(ROOT, "scenes", "bunny.xml")
MATPREVIEW_XML = os.path.join(ROOT, "scenes", "matpreview.xml")
CBOX_XML = os.path.join(ROOT, "scenes", "cbox.xml")
SMOKE_XML = os.path.join(ROOT, "scenes", "smoke.xml")
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
              fmt="binary_little_endian"):
    """PLY writer: float vertex properties (x y z [nx ny nz] [u v]) and
    uchar-counted int face lists; fmt is "ascii" or a binary format."""
    cols = [positions]
    props = ["x", "y", "z"]
    if normals is not None:
        cols.append(normals)
        props += ["nx", "ny", "nz"]
    if texcoords is not None:
        cols.append(texcoords)
        props += ["u", "v"]
    verts = np.concatenate(cols, axis=1).astype(np.float32)
    header = (
        f"ply\nformat {fmt} 1.0\ncomment seeded test mesh\n"
        f"element vertex {len(verts)}\n"
        + "".join(f"property float {p}\n" for p in props)
        + f"element face {len(indices)}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if fmt == "ascii":
            for row in verts:
                f.write((" ".join(repr(float(x)) for x in row) + "\n").encode())
            for tri in indices:
                f.write(("3 " + " ".join(str(int(i)) for i in tri) + "\n").encode())
            return
        end = {"binary_little_endian": "<", "binary_big_endian": ">"}[fmt]
        f.write(verts.astype(end + "f4").tobytes())
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
}

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
