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
  independent sampler (~10 s).

    JAX_PLATFORMS=cpu python -m tests.make_torch_bigmesh_golden [bigmesh] [densemesh] [matpreview]

With no argument all three are written.
"""

import os
import sys
import time

import numpy as np

from tests.torch_meshes import (
    ROOT,
    bunny_scene_xml,
    bunny_standin,
    dense_standin,
    matpreview_const_xml,
    write_ply,
)


def _standin_xml(mesh, ply):
    def make():
        os.makedirs(os.path.dirname(ply), exist_ok=True)
        write_ply(ply, *mesh(seed=0))
        return bunny_scene_xml(ply, 64, 64)
    return make


# name -> (golden, the scene's XML at 64x64)
GOLDENS = {
    "bigmesh": (os.path.join(ROOT, "tests", "golden", "torch_bigmesh_64_16.npy"),
                _standin_xml(bunny_standin, os.path.join(ROOT, "build", "bunny_standin.ply"))),
    "densemesh": (os.path.join(ROOT, "tests", "golden", "torch_densemesh_64_16.npy"),
                  _standin_xml(dense_standin, os.path.join(ROOT, "build", "dense_standin.ply"))),
    "matpreview": (os.path.join(ROOT, "tests", "golden", "torch_matpreview_const_64_16.npy"),
                   lambda: matpreview_const_xml(64, 64)),
}


def main(names):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import mitsuba_tpu
    from mitsuba_tpu.scene.xml_loader import load_scene_string

    for name in names:
        golden, make_xml = GOLDENS[name]
        t0 = time.time()
        scene = load_scene_string(make_xml())
        img = np.asarray(mitsuba_tpu.render(scene, spp=16, seed=0), np.float32)
        np.save(golden, img)
        print(f"wrote {golden}: shape {img.shape}, mean {img.mean():.6f}, "
              f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:] or list(GOLDENS))
