"""Regenerate the big-mesh goldens: the JAX package's render, on the CPU,
of scenes/bunny.xml with a seeded stand-in mesh of tests/torch_meshes.py
in place of bunny.ply, at 64x64, 16 spp, seed 0.  chip_smoke.py holds the
port's render of the same scene on the card to each.

* tests/golden/torch_bigmesh_64_16.npy: `bunny_standin(seed=0)`, 69,168
  triangles (~20 s);
* tests/golden/torch_densemesh_64_16.npy: `dense_standin(seed=0)`,
  870,480 triangles (minutes: the BVH walk of 870k triangles on the CPU).

    JAX_PLATFORMS=cpu python -m tests.make_torch_bigmesh_golden [bigmesh] [densemesh]

With no argument both are written.
"""

import os
import sys
import time

import numpy as np

from tests.torch_meshes import ROOT, bunny_scene_xml, bunny_standin, dense_standin, write_ply

# name -> (mesh, golden, PLY written on the way)
GOLDENS = {
    "bigmesh": (bunny_standin, os.path.join(ROOT, "tests", "golden", "torch_bigmesh_64_16.npy"),
                os.path.join(ROOT, "build", "bunny_standin.ply")),
    "densemesh": (dense_standin, os.path.join(ROOT, "tests", "golden", "torch_densemesh_64_16.npy"),
                  os.path.join(ROOT, "build", "dense_standin.ply")),
}


def main(names):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import mitsuba_tpu
    from mitsuba_tpu.scene.xml_loader import load_scene_string

    for name in names:
        mesh, golden, ply = GOLDENS[name]
        t0 = time.time()
        os.makedirs(os.path.dirname(ply), exist_ok=True)
        write_ply(ply, *mesh(seed=0))
        scene = load_scene_string(bunny_scene_xml(ply, 64, 64))
        img = np.asarray(mitsuba_tpu.render(scene, spp=16, seed=0), np.float32)
        np.save(golden, img)
        print(f"wrote {golden}: shape {img.shape}, mean {img.mean():.6f}, "
              f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:] or list(GOLDENS))
