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
  mitchell filter (the batched wavefront and its splat; ~5 s).

    JAX_PLATFORMS=cpu python -m tests.make_torch_bigmesh_golden [bigmesh] [densemesh] [matpreview] [smoke] [cbox_mitchell]

With no argument all five are written.
"""

import contextlib
import functools
import os
import sys
import time

import numpy as np

from tests.torch_meshes import (
    ROOT,
    bunny_scene_xml,
    bunny_standin,
    cbox_mitchell_xml,
    dense_standin,
    matpreview_const_xml,
    smoke_xml,
    write_ply,
)


def _standin_xml(mesh, ply):
    def make():
        os.makedirs(os.path.dirname(ply), exist_ok=True)
        write_ply(ply, *mesh(seed=0))
        return bunny_scene_xml(ply, 64, 64)
    return make


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


# name -> (golden, the scene's XML at 64x64, traced through the pair pipeline)
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
}


def main(names):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import mitsuba_tpu
    from mitsuba_tpu.scene.xml_loader import load_scene_string

    for name in names:
        golden, make_xml, *pairs = GOLDENS[name]
        t0 = time.time()
        scene = load_scene_string(make_xml())
        with reference_pair_traversal() if pairs else contextlib.nullcontext():
            img = np.asarray(mitsuba_tpu.render(scene, spp=16, seed=0), np.float32)
        np.save(golden, img)
        print(f"wrote {golden}: shape {img.shape}, mean {img.mean():.6f}, "
              f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:] or list(GOLDENS))
