#!/usr/bin/env python3
"""The sharded render's scaling over ranks, one process per card.

    python3 sharded_scaling.py [--ranks N] [--size 512] [--spp 16] [--cpu]

Renders scenes/cbox.xml at size x size, spp samples per pixel through
`mitsuba_tpu_torch.parallel.mesh.render_sharded`: first on a world of one
in this process (cuda:0), then on N spawned ranks joined by NCCL over a
file store (rank r on cuda:r), each timed after a 2-spp warm-up (host
clock, synchronised; the ranks start together after a barrier).  Prints
the card's name and power limit, each world's seconds and rays/s, each
rank's K1/K2 launches, and the largest difference between the two
images (only the film's sums are reassociated).  The kernels are built
before any rank is spawned.  With --cpu the ranks are gloo processes on
the CPU, a rehearsal that prints no device numbers.  Nothing of JAX is
imported.
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CBOX = os.path.join(HERE, "scenes", "cbox.xml")
RANK_TIMEOUT_S = 600.0


def timed_render(mesh, size, spp):
    """(image, seconds, rays of all ranks, this rank's K1/K2 launches) of
    render_sharded after a 2-spp warm-up."""
    import torch

    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch.accel import pallas_kernels as pk
    from mitsuba_tpu_torch.parallel.mesh import render_sharded

    scene = mt.load_scene(CBOX)
    scene.sensor.record.film.width = scene.sensor.record.film.height = size
    render_sharded(scene, mesh=mesh, spp=2)
    for fn in (pk.closest_hit_v2, pk.any_hit_v2):
        fn.launches = 0
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    if mesh.group is not None:
        torch.distributed.barrier()
    t0 = time.time()
    img = render_sharded(scene, mesh=mesh, spp=spp)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return (img, time.time() - t0, render_sharded.last_ray_count,
            (pk.closest_hit_v2.launches, pk.any_hit_v2.launches))


def rank_main(rank, world, init_method, out_dir, kind, size, spp):
    """One spawned rank: NCCL on cuda:rank, or gloo on the CPU."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from mitsuba_tpu_torch.parallel.mesh import destroy_world, init_world, make_mesh

    device = f"cuda:{rank}" if kind == "cuda" else "cpu"
    backend = "nccl" if kind == "cuda" else "gloo"
    if kind == "cpu":
        torch.set_num_threads(1)
    init_world(backend, init_method, world, rank, device=device, timeout_s=RANK_TIMEOUT_S)
    try:
        img, sec, rays, launches = timed_render(make_mesh(device=device, backend=backend), size,
                                                spp)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), img=img, sec=sec, rays=rays,
                 launches=np.asarray(launches))
    finally:
        destroy_world()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU (a rehearsal)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from mitsuba_tpu_torch import native
    from mitsuba_tpu_torch.parallel.mesh import make_mesh, spawn_ranks

    kind = "cpu" if args.cpu else "cuda"
    if kind == "cuda":
        if torch.cuda.device_count() < args.ranks:
            print(f"sharded_scaling: {args.ranks} ranks need {args.ranks} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], check=True, capture_output=True,
                              text=True, timeout=60).stdout.strip()
        print(card, flush=True)
        t0 = time.time()
        for name in ("brute_tiled", "cluster_hit", "cluster_stream"):
            native.build(name)
        print(f"kernels built in {time.time() - t0:.2f} s", flush=True)
    else:
        torch.set_num_threads(1)
        card = "the CPU (a rehearsal: no device numbers)"
    img1, sec1, rays1, launches1 = timed_render(make_mesh(device="cuda:0" if kind == "cuda"
                                                          else "cpu"), args.size, args.spp)
    print(f"world of one: cbox {args.size}x{args.size}, {args.spp} spp: {sec1:.3f} s, {rays1} "
          f"rays = {rays1 / sec1:.6g} rays/s, K1/K2 launches {launches1} on {card}", flush=True)
    with tempfile.TemporaryDirectory(prefix="mts_scaling_") as d:
        t0 = time.time()
        spawn_ranks(rank_main, args.ranks, (f"file://{d}/store", d, kind, args.size, args.spp),
                    RANK_TIMEOUT_S)
        ranks = [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(args.ranks)]
        wall = time.time() - t0
    sec = max(float(r["sec"]) for r in ranks)
    rays = int(ranks[0]["rays"])
    diff = float(np.abs(ranks[0]["img"] - img1).max())
    equal = all(np.array_equal(r["img"], ranks[0]["img"]) for r in ranks)
    print(f"{args.ranks} ranks: {sec:.3f} s (ranks {[round(float(r['sec']), 3) for r in ranks]}), "
          f"{rays} rays = {rays / sec:.6g} rays/s ({rays / sec / (rays1 / sec1):.3f}x one "
          f"rank's), K1/K2 launches per rank {[tuple(int(x) for x in r['launches']) for r in ranks]}"
          f"; every rank's image equal: {equal}; largest difference to the world of one "
          f"{diff:.6g} of {float(np.abs(img1).max()):.6g}; {wall:.1f} s with the ranks' start on "
          f"{card}", flush=True)
    if not equal or diff > 1e-4 * float(np.abs(img1).max()):
        print("sharded_scaling: the ranks' image differs", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
