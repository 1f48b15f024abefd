"""Multi-host start-up (port of mitsuba_tpu/parallel/multihost.py;
reference src/mitsuba/mtssrv.cpp and sched_remote.cpp:333-431).

Where the reference ships scene objects over sockets to `mtssrv`
workers, every host here runs the same program: one process per card,
joined into one torch.distributed process group over
`tcp://coordinator`, and `parallel/mesh.py`'s sharded render runs
unchanged across them.  The film's all-reduce is the only traffic
between hosts.  The CLI counterpart of

    mtssrv -p 7554            # the reference's worker
    mitsuba -c host1;host2    # the reference's submit

is the same command on every host (host ids 0 .. n-1; host 0 listens at
the coordinator's address and writes the image):

    python -m mitsuba_tpu_torch.parallel.multihost scene.xml -o out.exr \\
        --coordinator host0:29500 --num-hosts 2 --host-id $ID

The backend is NCCL and the device the card (cuda:LOCAL_RANK) unless the
command names others (`--backend gloo --device cpu` on machines without
one).
"""

from __future__ import annotations

import argparse
import sys


def init_multihost(coordinator=None, num_hosts=None, host_id=None, backend=None,
                   device="cuda", timeout_s=600.0):
    """Join the hosts' process group when more than one host takes part:
    `dist.init_process_group` over tcp://`coordinator` (host:port of host
    0) with `num_hosts` ranks, this one `host_id`.  `backend` None is NCCL
    (the card's); CPU hosts pass "gloo".  One host needs no group.
    Returns (world size, this rank)."""
    import torch

    from mitsuba_tpu_torch.parallel.mesh import init_world

    if coordinator and (num_hosts or 0) > 1:
        init_world(backend or "nccl", f"tcp://{coordinator}", num_hosts, host_id or 0,
                   device=device, timeout_s=timeout_s)
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def render_multihost(scene, spp=None, seed=0, device="cuda"):
    """The sharded render over every host's process group (a world of one
    without a group); every host gets the developed image back."""
    from mitsuba_tpu_torch.parallel.mesh import make_mesh, render_sharded

    return render_sharded(scene, mesh=make_mesh(device=device), spp=spp, seed=seed)


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-host mitsuba_tpu_torch render (mtssrv's "
                                             "counterpart)")
    ap.add_argument("scene")
    ap.add_argument("-o", "--output", default="out.exr")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--coordinator", default=None, help="host:port of host 0")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda", help="'cuda' (cuda:LOCAL_RANK), 'cuda:k' or "
                                                     "'cpu'")
    args = ap.parse_args(argv)

    from mitsuba_tpu_torch.parallel.mesh import destroy_world

    world, rank = init_multihost(args.coordinator, args.num_hosts, args.host_id, args.backend,
                                 args.device)
    try:
        import mitsuba_tpu_torch as mt
        from mitsuba_tpu_torch.core.logging import logger
        from mitsuba_tpu_torch.io.images import write_image

        logger.info("multihost: process %d of %d", rank, world)
        scene = mt.load_scene(args.scene)
        img = render_multihost(scene, spp=args.spp, seed=args.seed, device=args.device)
        if rank == 0:
            # the film's output format, as render_to_file writes it
            write_image(args.output, scene.sensor.record.film.develop_to_array(img))
            logger.info("wrote %s", args.output)
    finally:
        destroy_world()
    return 0


if __name__ == "__main__":
    sys.exit(main())
