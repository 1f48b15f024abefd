"""Scene importer: OBJ (+ MTL) -> mitsuba scene XML (port of
mitsuba_tpu/mtsimport.py).

Rebuild of the reference's mtsimport converter
(reference: src/converter/{obj.cpp? via GeometryConverter},
src/mtsimport/mtsimport.cpp — the reference converts COLLADA and OBJ
into Mitsuba's XML schema plus .serialized geometry).  This version:

* OBJ: geometry is re-exported per-material as compact `.serialized`
  meshes (io/meshes.py writer) and an XML scene references them;
  MTL materials map to the closest plugin (diffuse / conductor-ish
  phong / dielectric by transparency), with map_Kd -> bitmap texture.
* COLLADA (.dae): full scene conversion via io/collada.py (geometry
  with node-hierarchy transforms + up-axis/unit fixup, materials,
  cameras, lights), mirroring the reference's converter
  (src/converter/collada.cpp).

Usage: python -m mitsuba_tpu_torch.mtsimport input.obj output_dir/
"""

from __future__ import annotations

import os
import sys

import numpy as np


def _parse_mtl(path):
    mats = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.strip().split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "newmtl":
                cur = tok[1]
                mats[cur] = {}
            elif cur is not None:
                key = tok[0].lower()
                if key in ("kd", "ks", "ke"):
                    mats[cur][key] = [float(x) for x in tok[1:4]]
                elif key in ("ns", "ni", "d", "tr"):
                    mats[cur][key] = float(tok[1])
                elif key == "map_kd":
                    mats[cur]["map_kd"] = tok[-1]
    return mats


def _mat_xml(name, m):
    """MTL -> closest plugin (the reference's material heuristics)."""
    kd = m.get("kd", [0.5, 0.5, 0.5])
    ks = m.get("ks", [0.0, 0.0, 0.0])
    ns = m.get("ns", 0.0)
    d = m.get("d", 1.0 - m.get("tr", 0.0))
    lines = [f'  <bsdf type="{{}}" id="{name}">']
    if d < 0.99 and m.get("ni", 1.0) > 1.0:
        lines[0] = lines[0].format("dielectric")
        lines.append(
            f'    <float name="intIOR" value="{m.get("ni", 1.5)}"/>'
        )
    elif max(ks) > 0.05 and ns > 1.0:
        lines[0] = lines[0].format("phong")
        lines.append(f'    <float name="exponent" value="{ns}"/>')
        lines.append(
            '    <rgb name="specularReflectance" '
            f'value="{ks[0]}, {ks[1]}, {ks[2]}"/>'
        )
        if "map_kd" in m:
            lines.append(
                '    <texture name="diffuseReflectance" type="bitmap">'
                f'<string name="filename" value="{m["map_kd"]}"/>'
                "</texture>"
            )
        else:
            lines.append(
                '    <rgb name="diffuseReflectance" '
                f'value="{kd[0]}, {kd[1]}, {kd[2]}"/>'
            )
    else:
        lines[0] = lines[0].format("diffuse")
        if "map_kd" in m:
            lines.append(
                '    <texture name="reflectance" type="bitmap">'
                f'<string name="filename" value="{m["map_kd"]}"/>'
                "</texture>"
            )
        else:
            lines.append(
                f'    <rgb name="reflectance" value="{kd[0]}, {kd[1]}, '
                f'{kd[2]}"/>'
            )
    lines.append("  </bsdf>")
    return "\n".join(lines)


def import_obj(obj_path, out_dir):
    """Convert an OBJ file into out_dir/{scene.xml, meshes/*.serialized}.

    Returns the scene XML path."""
    from mitsuba_tpu_torch.io.meshes import load_obj, save_serialized

    os.makedirs(os.path.join(out_dir, "meshes"), exist_ok=True)

    mtl = {}
    base = os.path.dirname(obj_path)
    with open(obj_path, "r", errors="replace") as f:
        for line in f:
            tok = line.strip().split()
            if tok and tok[0] == "mtllib":
                mtl.update(_parse_mtl(os.path.join(base, tok[1])))

    meshes = load_obj(obj_path)  # one MeshData per OBJ object/group

    def safe(n):
        return "".join(c if c.isalnum() else "_" for c in n) or "default"

    mat_names = []
    mats_xml = []
    seen = set()
    for mesh in meshes:
        # prefer a material whose name matches the mesh/group name
        name = mesh.name if mesh.name in mtl else next(iter(mtl), "default")
        mat_names.append(safe(name))
        if safe(name) not in seen:
            seen.add(safe(name))
            mats_xml.append(_mat_xml(safe(name), mtl.get(name, {})))

    ser_rel = os.path.join("meshes", "geometry.serialized")
    save_serialized(os.path.join(out_dir, ser_rel), meshes)
    shapes_xml = []
    for i, mesh in enumerate(meshes):
        shapes_xml.append(
            '  <shape type="serialized">\n'
            f'    <string name="filename" value="{ser_rel}"/>\n'
            f'    <integer name="shapeIndex" value="{i}"/>\n'
            f'    <ref id="{mat_names[i]}"/>\n'
            "  </shape>"
        )

    xml = (
        '<?xml version="1.0" encoding="utf-8"?>\n'
        '<scene version="0.5.0">\n'
        '  <integrator type="path"/>\n'
        '  <sensor type="perspective">\n'
        '    <float name="fov" value="45"/>\n'
        "    <transform name=\"toWorld\">\n"
        '      <lookat origin="0, 1, 4" target="0, 0.5, 0" up="0, 1, 0"/>\n'
        "    </transform>\n"
        '    <sampler type="independent">'
        '<integer name="sampleCount" value="64"/></sampler>\n'
        '    <film type="hdrfilm">\n'
        '      <integer name="width" value="768"/>\n'
        '      <integer name="height" value="576"/>\n'
        "    </film>\n"
        "  </sensor>\n"
        '  <emitter type="constant">'
        '<spectrum name="radiance" value="1.0"/></emitter>\n'
        + "\n".join(mats_xml)
        + "\n"
        + "\n".join(shapes_xml)
        + "\n</scene>\n"
    )
    out_xml = os.path.join(out_dir, "scene.xml")
    with open(out_xml, "w") as f:
        f.write(xml)
    return out_xml


def _collada_mat_xml(name, mat):
    """COLLADA effect -> closest plugin (collada.cpp loadMaterial)."""
    kd = [float(x) for x in mat.get("kd", [0.5, 0.5, 0.5])]
    kind = mat.get("kind", "diffuse")
    lines = [f'  <bsdf type="{kind}" id="{name}">']
    if kind == "dielectric":
        lines.append(
            f'    <float name="intIOR" value="{mat.get("ior", 1.5)}"/>'
        )
    elif kind == "phong":
        ks = [float(x) for x in mat.get("ks", [0.2, 0.2, 0.2])]
        lines.append(
            f'    <float name="exponent" value="{mat.get("shininess", 30)}"/>'
        )
        lines.append(
            '    <rgb name="specularReflectance" '
            f'value="{ks[0]}, {ks[1]}, {ks[2]}"/>'
        )
        lines.append(
            f'    <rgb name="diffuseReflectance" value="{kd[0]}, {kd[1]}, '
            f'{kd[2]}"/>'
        )
    else:
        slot = "reflectance"
        if mat.get("kd_tex"):
            lines.append(
                f'    <texture name="{slot}" type="bitmap">'
                f'<string name="filename" value="{mat["kd_tex"]}"/>'
                "</texture>"
            )
        else:
            lines.append(
                f'    <rgb name="{slot}" value="{kd[0]}, {kd[1]}, '
                f'{kd[2]}"/>'
            )
    lines.append("  </bsdf>")
    return "\n".join(lines)


def _mat16(m):
    return ", ".join(f"{x:.8g}" for x in np.asarray(m, float).reshape(-1))


def import_dae(dae_path, out_dir):
    """Convert a COLLADA document into out_dir/{scene.xml,
    meshes/geometry.serialized} (reference src/converter/collada.cpp
    via mtsimport.cpp).  Returns the scene XML path."""
    from mitsuba_tpu_torch.io.collada import Collada
    from mitsuba_tpu_torch.io.meshes import save_serialized

    os.makedirs(os.path.join(out_dir, "meshes"), exist_ok=True)
    doc = Collada(dae_path)

    def safe(n):
        return "".join(c if c.isalnum() else "_" for c in n) or "default"

    meshes, shapes, mats_xml, seen = [], [], [], set()
    cams, lights = [], []
    for item in doc.walk():
        if item[0] == "geometry":
            _, mesh, mat, m = item
            mname = safe(mat["name"])
            if mname not in seen:
                seen.add(mname)
                mats_xml.append(_collada_mat_xml(mname, mat))
            shapes.append((len(meshes), mname, m))
            meshes.append(mesh)
        elif item[0] == "camera":
            cams.append((item[1], item[2]))
        elif item[0] == "light":
            lights.append((item[1], item[2]))

    ser_rel = os.path.join("meshes", "geometry.serialized")
    if meshes:
        save_serialized(os.path.join(out_dir, ser_rel), meshes)

    shapes_xml = []
    for i, mname, m in shapes:
        shapes_xml.append(
            '  <shape type="serialized">\n'
            f'    <string name="filename" value="{ser_rel}"/>\n'
            f'    <integer name="shapeIndex" value="{i}"/>\n'
            '    <transform name="toWorld">'
            f'<matrix value="{_mat16(m)}"/></transform>\n'
            f'    <ref id="{mname}"/>\n'
            "  </shape>"
        )

    sensor_xml = (
        '  <sensor type="perspective">\n'
        '    <float name="fov" value="45"/>\n'
        '    <transform name="toWorld">\n'
        '      <lookat origin="0, 1, 4" target="0, 0.5, 0" '
        'up="0, 1, 0"/>\n'
        "    </transform>\n"
    )
    if cams:
        cam_el, m = cams[0]
        persp = cam_el.find("optics/technique_common/perspective")
        fov = 45.0
        axis = "x"
        if persp is not None:
            xf = persp.findtext("xfov")
            yf = persp.findtext("yfov")
            if xf:
                fov = float(xf)
            elif yf:
                fov, axis = float(yf), "y"
        # COLLADA cameras look down -Z with +Y up; ours look down +Z
        flip = np.diag([-1.0, 1.0, -1.0, 1.0])
        sensor_xml = (
            '  <sensor type="perspective">\n'
            f'    <float name="fov" value="{fov}"/>\n'
            f'    <string name="fovAxis" value="{axis}"/>\n'
            '    <transform name="toWorld">'
            f'<matrix value="{_mat16(np.asarray(m) @ flip)}"/>'
            "</transform>\n"
        )
    sensor_xml += (
        '    <sampler type="independent">'
        '<integer name="sampleCount" value="64"/></sampler>\n'
        '    <film type="hdrfilm">\n'
        '      <integer name="width" value="768"/>\n'
        '      <integer name="height" value="576"/>\n'
        "    </film>\n"
        "  </sensor>\n"
    )

    emitters_xml = []
    for li, m in lights:
        tc = li.find("technique_common")
        if tc is None:
            continue
        pos = np.asarray(m, float)[:3, 3]
        direction = -np.asarray(m, float)[:3, 2]  # -Z spine
        for kind in ("point", "directional", "spot", "ambient"):
            le = tc.find(kind)
            if le is None:
                continue
            col = np.array(
                (le.findtext("color") or "1 1 1").split(), float
            )[:3]
            if kind == "point":
                emitters_xml.append(
                    '  <emitter type="point">\n'
                    f'    <point name="position" x="{pos[0]:.6g}" '
                    f'y="{pos[1]:.6g}" z="{pos[2]:.6g}"/>\n'
                    f'    <rgb name="intensity" value="{col[0]}, '
                    f'{col[1]}, {col[2]}"/>\n  </emitter>'
                )
            elif kind == "directional":
                emitters_xml.append(
                    '  <emitter type="directional">\n'
                    f'    <vector name="direction" x="{direction[0]:.6g}" '
                    f'y="{direction[1]:.6g}" z="{direction[2]:.6g}"/>\n'
                    f'    <rgb name="irradiance" value="{col[0]}, '
                    f'{col[1]}, {col[2]}"/>\n  </emitter>'
                )
            elif kind == "spot":
                ang = float(le.findtext("falloff_angle") or 45.0)
                emitters_xml.append(
                    '  <emitter type="spot">\n'
                    '    <transform name="toWorld">'
                    f'<matrix value="{_mat16(m)}"/></transform>\n'
                    f'    <float name="cutoffAngle" value="{ang}"/>\n'
                    f'    <rgb name="intensity" value="{col[0]}, '
                    f'{col[1]}, {col[2]}"/>\n  </emitter>'
                )
            else:  # ambient
                emitters_xml.append(
                    '  <emitter type="constant">'
                    f'<rgb name="radiance" value="{col[0]}, {col[1]}, '
                    f'{col[2]}"/></emitter>'
                )
    if not emitters_xml:
        emitters_xml.append(
            '  <emitter type="constant">'
            '<spectrum name="radiance" value="1.0"/></emitter>'
        )

    xml = (
        '<?xml version="1.0" encoding="utf-8"?>\n'
        '<scene version="0.5.0">\n'
        '  <integrator type="path"/>\n'
        + sensor_xml
        + "\n".join(emitters_xml) + "\n"
        + "\n".join(mats_xml) + "\n"
        + "\n".join(shapes_xml)
        + "\n</scene>\n"
    )
    out_xml = os.path.join(out_dir, "scene.xml")
    with open(out_xml, "w") as f:
        f.write(xml)
    return out_xml


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(
            "usage: python -m mitsuba_tpu_torch.mtsimport input.{obj,dae} out_dir/",
            file=sys.stderr,
        )
        return 1
    src, out_dir = argv
    ext = os.path.splitext(src)[1].lower()
    if ext == ".obj":
        path = import_obj(src, out_dir)
        print(f"wrote {path}")
        return 0
    if ext == ".dae":
        path = import_dae(src, out_dir)
        print(f"wrote {path}")
        return 0
    raise ValueError(f"mtsimport: unsupported input format {ext}")


if __name__ == "__main__":
    raise SystemExit(main())
