"""Rank bodies and scenes of the port's multi-process CPU tests
(tests/test_torch_sharding.py, test_torch_elastic.py,
test_torch_multihost.py).  The ranks are spawned processes that import
this module, so it imports neither JAX nor the JAX package.

Each body joins a gloo world through the given init method
(`file://...` or `tcp://127.0.0.1:<port>`), with a 60 s time limit on
the rendezvous and on every collective, renders on the CPU in one
thread (the test runner's workers share the machine's cores), writes
what it rendered to `<out_dir>/rank<r>.npz`, and leaves the group."""

from __future__ import annotations

import os

import numpy as np
import torch

from tests.torch_meshes import cbox_chain_xml, cbox_xml

SPPM_PHOTONS = 8192
TIMEOUT_S = 60.0

# tests/test_volpath.py's fog sphere (sigma_s 0.6, sigma_a 0.1 under a
# constant environment), 24x24 under a box filter, maxDepth 48:
# tests/test_sharding.py's volpath case
FOG_XML = """
<scene version="0.5.0">
  <integrator type="volpath"><integer name="maxDepth" value="48"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="30"/>
    <transform name="toWorld"><lookat origin="0,0,-6" target="0,0,0" up="0,1,0"/></transform>
    <sampler type="independent"><integer name="sampleCount" value="16"/></sampler>
    <film type="hdrfilm">
      <integer name="width" value="24"/><integer name="height" value="24"/>
      <rfilter type="box"/>
    </film>
  </sensor>
  <shape type="sphere">
    <float name="radius" value="1"/>
    <bsdf type="null"/>
    <medium name="interior" type="homogeneous">
      <rgb name="sigmaS" value="0.6, 0.6, 0.6"/>
      <rgb name="sigmaA" value="0.1, 0.1, 0.1"/>
    </medium>
  </shape>
  <emitter type="constant"><rgb name="radiance" value="1, 1, 1"/></emitter>
</scene>"""

# name -> (scene XML, spp, seed): the families of render_sharded at the
# sizes of tests/test_sharding.py (cbox 32x32 for its 64x64)
CASES = {
    "path": (cbox_xml("path", 32, 32), 8, 0),
    "path_64": (cbox_xml("path", 64, 64), 16, 0),
    "path_3spp": (cbox_xml("path", 32, 32), 3, 0),
    "path_2spp": (cbox_xml("path", 32, 32), 2, 0),
    "volpath_fog": (FOG_XML, 16, 0),
    "bdpt": (cbox_xml("bdpt", 32, 32, 4), 8, 2),
    "sppm": (cbox_xml("sppm", 64, 64, 6), 2, 1),
    "ptracer": (cbox_xml("ptracer", 32, 32), 8, 0),
    "vpl": (cbox_xml("vpl", 24, 24, 4), 8, 1),
    "pssmlt": (cbox_chain_xml("pssmlt", 16, 16), 4, 0),
    "mlt": (cbox_chain_xml("mlt", 16, 16), 4, 0),
    "erpt": (cbox_chain_xml("erpt", 16, 16, chain_length=10), 1, 0),
}


def join(rank, world, init_method):
    """Join the gloo world on the CPU; returns its mesh."""
    from mitsuba_tpu_torch.parallel.mesh import init_world, make_mesh

    torch.set_num_threads(1)
    init_world("gloo", init_method, world, rank, device="cpu", timeout_s=TIMEOUT_S)
    return make_mesh(device="cpu", backend="gloo")


def sharded_cases(rank, world, init_method, out_dir, names):
    """render_sharded of each named case of CASES on this rank."""
    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch.parallel.mesh import destroy_world, render_sharded

    os.environ["MTS_SPPM_PHOTONS"] = str(SPPM_PHOTONS)
    mesh = join(rank, world, init_method)
    try:
        out = {}
        for name in names:
            xml, spp, seed = CASES[name]
            out[name] = render_sharded(mt.load_scene_string(xml), mesh=mesh, spp=spp, seed=seed)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        destroy_world()


def elastic_shrink(rank, world, init_method, out_dir):
    """render_elastic whose first mesh fails: the first call of mesh_fn
    raises a SimulatedFault, the second returns a world of one on this
    process alone.  Writes the full world's render_sharded and the
    elastic render."""
    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch.parallel import elastic
    from mitsuba_tpu_torch.parallel.mesh import Mesh, destroy_world, render_sharded

    mesh = join(rank, world, init_method)
    xml, spp, seed = CASES["path"]
    calls = []

    def mesh_fn():
        calls.append(1)
        if len(calls) == 1:
            raise elastic.SimulatedFault("mesh")
        return Mesh(None, 0, 1, torch.device("cpu"), None)

    try:
        full = render_sharded(mt.load_scene_string(xml), mesh=mesh, spp=spp, seed=seed)
        img = elastic.render_elastic(mt.load_scene_string(xml), spp=spp, seed=seed,
                                     mesh_fn=mesh_fn)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), full=full, elastic=img,
                 calls=len(calls))
    finally:
        destroy_world()


def multihost_rank(rank, world, coordinator, out_dir):
    """init_multihost over tcp://coordinator with gloo, then
    render_multihost of CASES["path"] at 4 spp."""
    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch.parallel.mesh import destroy_world
    from mitsuba_tpu_torch.parallel.multihost import init_multihost, render_multihost

    torch.set_num_threads(1)
    n, me = init_multihost(coordinator, world, rank, backend="gloo", device="cpu",
                           timeout_s=TIMEOUT_S)
    try:
        if (n, me) != (world, rank):
            raise RuntimeError(f"init_multihost gave {(n, me)} for {(world, rank)}")
        img = render_multihost(mt.load_scene_string(CASES["path"][0]), spp=4, device="cpu")
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), img=img)
    finally:
        destroy_world()
