"""The port's driver entry points (counterpart of the repository's
`__graft_entry__.py`, which drives the JAX package).

* entry(device) -> (fn, example_args): one render pass of the Cornell box
  at 64x64, 2 samples per pixel (trace, NEE, film accumulate);
  fn(*example_args) -> (film [64, 64, 4], rays traced).
* dryrun_multichip(n, device): n ranks, one process each, joined into
  one process group, each running one sharded step of path, volpath
  (media), bdpt (both films merged), pssmlt (chains split) and sppm
  (photons split) through parallel/mesh.py.  On the card it needs n
  cards (NCCL, rank r on cuda:r) and raises with fewer; with
  device="cpu" the ranks are gloo processes on the CPU.  It never moves
  to the CPU on its own.

    python -m mitsuba_tpu_torch.entry [--cpu] [--ranks N]
"""

from __future__ import annotations

import os
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CBOX_XML = os.path.join(_REPO, "scenes", "cbox.xml")

# a homogeneous fog sphere under a constant environment (the driver
# entry's volpath scene), 16x16 under a box filter: volpath's batched
# wavefront
FOG_XML = """
<scene version="0.5.0">
  <integrator type="volpath"><integer name="maxDepth" value="6"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="toWorld"><lookat origin="0,0,-4" target="0,0,0" up="0,1,0"/></transform>
    <sampler type="independent"><integer name="sampleCount" value="8"/></sampler>
    <film type="hdrfilm">
      <integer name="width" value="16"/><integer name="height" value="16"/>
      <rfilter type="box"/>
    </film>
  </sensor>
  <shape type="sphere">
    <bsdf type="null"/>
    <medium name="interior" type="homogeneous">
      <rgb name="sigmaS" value="0.5, 0.5, 0.5"/>
      <rgb name="sigmaA" value="0.1, 0.1, 0.1"/>
    </medium>
  </shape>
  <emitter type="constant"><rgb name="radiance" value="1,1,1"/></emitter>
</scene>"""


def cbox(width=64, height=64):
    """scenes/cbox.xml at another film size."""
    from mitsuba_tpu_torch.scene.xml_loader import load_scene

    scene = load_scene(CBOX_XML)
    scene.sensor.record.film.width = width
    scene.sensor.record.film.height = height
    return scene


def entry(device="cuda"):
    """(fn, example_args): one pass of cbox at 64x64, spp_chunk 2, on
    `device` (the card unless the caller asks for "cpu")."""
    from mitsuba_tpu_torch.film.film import new_film
    from mitsuba_tpu_torch.parallel.mesh import resolve_device
    from mitsuba_tpu_torch.renderer import make_render_pass
    from mitsuba_tpu_torch.scene.builder import pack_scene

    device = resolve_device(device)
    scene = cbox(64, 64)
    pack = pack_scene(scene, device)
    sen = scene.sensor.record
    fn = make_render_pass(pack, scene.integrator, sen, sen.film, sen.sampler, 2, device)
    return fn, (new_film(64, 64, device), 0, 0)


def dryrun_multichip(n_devices, device="cuda", timeout_s=1200.0):
    """One sharded step of each family on `n_devices` ranks (see the
    module's docstring); raises when a rank fails or the ranks outlast
    `timeout_s`."""
    import torch

    from mitsuba_tpu_torch.parallel.mesh import spawn_ranks

    kind = torch.device(device).type
    if kind == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} CUDA cards, "
                               f"{have} visible (pass device='cpu' for gloo ranks on the CPU)")
    backend = "nccl" if kind == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(prefix="mts_dryrun_") as d:
        spawn_ranks(_dryrun_rank, n_devices, (backend, f"file://{d}/store", kind), timeout_s)


def _dryrun_rank(rank, world, backend, init_method, kind):
    """One rank of dryrun_multichip: rank r on cuda:r, or on the CPU."""
    import numpy as np
    import torch

    from mitsuba_tpu_torch.film.film import new_film
    from mitsuba_tpu_torch.integrator.plugins import IntegratorRecord
    from mitsuba_tpu_torch.parallel.mesh import (
        destroy_world,
        init_world,
        make_mesh,
        make_sharded_bdpt_pass,
        make_sharded_render_pass,
        render_sharded,
    )
    from mitsuba_tpu_torch.scene.builder import pack_scene
    from mitsuba_tpu_torch.scene.xml_loader import load_scene_string

    def check(cond, msg):
        if not cond:
            raise RuntimeError(f"rank {rank}: {msg}")

    device = f"cuda:{rank}" if kind == "cuda" else "cpu"
    if kind == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    init_world(backend, init_method, world, rank, device=device)
    try:
        mesh = make_mesh(device=device, backend=backend)
        check(mesh.world == world and mesh.rank == rank, f"mesh {mesh}")
        # one sharded path pass: at least one sample layer per rank
        for scene in (cbox(32, 32), load_scene_string(FOG_XML)):
            sen = scene.sensor.record
            w, h = sen.film.width, sen.film.height
            rp = make_sharded_render_pass(pack_scene(scene, mesh.device), scene.integrator, sen,
                                          sen.film, sen.sampler, world, mesh)
            film, _ = rp(new_film(h, w, mesh.device), 0, 0)
            check(float(film[..., 3].sum()) > 0, f"empty {scene.integrator.kind} film")
        # one sharded bdpt pass, both films merged
        scene = cbox(32, 32)
        scene.integrator = IntegratorRecord(kind="bdpt", max_depth=4)
        sen = scene.sensor.record
        rp, _ = make_sharded_bdpt_pass(pack_scene(scene, mesh.device), scene.integrator, sen,
                                       sen.film, world, mesh, 0)
        zeros = torch.zeros(32, 32, 3, dtype=torch.float32, device=mesh.device)
        films = rp((zeros, zeros.clone()), 0)
        check(bool(torch.isfinite(films[0]).all()) and float(films[0].sum()) > 0,
              "empty bdpt eye film")
        # pssmlt (chains split) and sppm (photons split)
        os.environ["MTS_SPPM_PHOTONS"] = "4096"
        for kind_, spp in (("pssmlt", 2), ("sppm", 1)):
            scene = cbox(16, 16)
            scene.integrator = IntegratorRecord(kind=kind_, max_depth=4, luminance_samples=1024)
            img = render_sharded(scene, mesh=mesh, spp=spp)
            check(np.isfinite(img).all() and img.sum() > 0, f"empty {kind_} image")
    finally:
        destroy_world()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="the port's entry and sharded dry run")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (gloo ranks)")
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    fn, example = entry(device)
    film, _ = fn(*example)
    print(f"entry ok: {tuple(film.shape)} alpha sum {float(film[..., 3].sum()):.6g} on {device}")
    dryrun_multichip(args.ranks, device)
    print(f"dryrun_multichip({args.ranks}) ok on {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
