"""Whole images back to back through
`mitsuba_tpu_torch.parallel.mesh.render_sharded`, one rank a card.

The run starts `ranks` processes (spawned; NCCL on the card, gloo on the
CPU) that meet over a file store in a temporary directory under TMPDIR.
Each rank loads the scene at the traffic's film size and renders one warm
image of one sample a rank, whose pass has the window's shapes.  After a
barrier the window renders images of `spp` samples with render_sharded's
own plan (its lanes a rank, one all-reduce of the film a pass); after
each image rank 0 tells every rank, through a one-element all-reduce,
whether --seconds have passed.  Rank 0's image is held against the plain
reference once every rank has left its process group.  With --trace 1
each rank profiles one more image once the window has closed; the
window's images give the rates and the wall time an image takes.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

from portbench.lib import ranks
from portbench.lib.context import Outcome

RANK_TIMEOUT_S = 300.0


def run(ctx):
    import torch.multiprocessing as tmp

    world = ctx.traffic["ranks"]
    with tempfile.TemporaryDirectory(prefix="portbench_ranks_") as d:
        payload = dict(
            workload=ctx.workload, config=ctx.config, traffic=ctx.traffic, check=ctx.check,
            seed=ctx.seed, seconds=ctx.seconds, trace=ctx.trace, device=ctx.device,
            t_start_wall=time.time() - (time.perf_counter() - ctx.t_start), dir=d)
        procs = tmp.start_processes(ranks.rank_main, args=(world, payload), nprocs=world,
                                    join=False, start_method="spawn")
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            while not procs.join(timeout=max(min(deadline - time.monotonic(), 5.0), 0.05)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks still running after {RANK_TIMEOUT_S} s")
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        outs = [_read(os.path.join(d, f"rank{r}.json")) for r in range(world)]
    r0 = outs[0]
    found = sorted({m for r in outs for m in r["jax_modules"]})
    if found:
        raise RuntimeError(f"a rank loaded {found}")
    facts = dict(r0["facts"])
    devs = [r["facts"].get("device") for r in outs]
    if all(devs):
        dev = dict(devs[0])
        dev["busy_s"] = sum(x["busy_s"] for x in devs) / world
        dev["window_s"] = sum(x["window_s"] for x in devs) / world
        dev["device_ops_all_ranks"] = sum(x["device_ops"] for x in devs)
        facts["device"] = dev
    return Outcome(
        attempted=r0["images_n"], failed=r0["failed"],
        e2e={"setup_s": r0["t_open_wall"] - payload["t_start_wall"],
             "samples_per_s": r0["samples_per_s"]},
        numbers=r0["numbers"], memory_peak_bytes=max(r["memory_peak_bytes"] for r in outs),
        facts=facts, device_count=world)


def _read(path):
    with open(path) as f:
        return json.load(f)
