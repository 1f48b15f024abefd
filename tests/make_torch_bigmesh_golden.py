"""Regenerate tests/golden/torch_bigmesh_64_16.npy: the JAX package's
render, on the CPU, of scenes/bunny.xml with the seeded stand-in mesh of
tests/torch_meshes.py in place of bunny.ply, at 64x64, 16 spp, seed 0.
chip_smoke.py holds the port's render of the same scene on the card to it.

    JAX_PLATFORMS=cpu python -m tests.make_torch_bigmesh_golden
"""

import os

import numpy as np

from tests.torch_meshes import ROOT, bunny_scene_xml, bunny_standin, write_ply

GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_bigmesh_64_16.npy")
PLY = os.path.join(ROOT, "build", "bunny_standin.ply")


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import mitsuba_tpu
    from mitsuba_tpu.scene.xml_loader import load_scene_string

    os.makedirs(os.path.dirname(PLY), exist_ok=True)
    write_ply(PLY, *bunny_standin(seed=0))
    scene = load_scene_string(bunny_scene_xml(PLY, 64, 64))
    img = np.asarray(mitsuba_tpu.render(scene, spp=16, seed=0), np.float32)
    np.save(GOLDEN, img)
    print(f"wrote {GOLDEN}: shape {img.shape}, mean {img.mean():.6f}")


if __name__ == "__main__":
    main()
