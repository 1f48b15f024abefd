"""The body of one rank of the sharded cells (spawned by
drivers/sharded.py; a module of its own so that spawn can import it)."""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from portbench.lib import compare, scenes, trace
from portbench.lib.context import Context, memory_peak, sync
from portbench.lib.facts import render_facts

STORE_TIMEOUT_S = 120.0


def rank_main(rank, world, payload):
    from portbench.lib import cells

    sys.path.insert(0, cells.ROOT)
    from mitsuba_tpu_torch.parallel import mesh as pm
    from mitsuba_tpu_torch.scene.builder import pack_scene

    on_card = torch.device(payload["device"]).type == "cuda"
    device = f"cuda:{rank}" if on_card else "cpu"
    backend = "nccl" if on_card else "gloo"
    if not on_card:
        torch.set_num_threads(1)
    ctx = Context(workload=payload["workload"], config=payload["config"],
                  traffic=payload["traffic"], check=payload["check"], seed=payload["seed"],
                  seconds=payload["seconds"], trace=payload["trace"], device=device,
                  t_start=time.perf_counter())
    pm.init_world(backend, f"file://{payload['dir']}/store", world, rank, device=device,
                  timeout_s=STORE_TIMEOUT_S)
    try:
        out = _window(ctx, pm, pack_scene, rank, world)
    finally:
        pm.destroy_world()
    if rank == 0:
        chk = ctx.traffic["check"]
        out["numbers"] = compare.check_render(
            out.pop("images"), out.pop("ref"), ctx.traffic["spp"], ctx.seed, ctx.dev,
            chk["pixels"], chk["ref_spp"], chk.get("lanes", 1 << 21))
    else:
        out.pop("images")
        out.pop("ref")
    if ctx.trace:
        out["facts"]["device"] = trace.reduce(ctx.dtrace.results)
    out["jax_modules"] = sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib", "flax", "mitsuba_tpu"))
    with open(os.path.join(payload["dir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _window(ctx, pm, pack_scene, rank, world):
    tr = ctx.traffic
    w, h, spp = tr["width"], tr["height"], tr["spp"]
    mesh = pm.make_mesh(device=ctx.device, backend="nccl" if ctx.dev.type == "cuda" else "gloo")
    xml = scenes.scene_xml(ctx.config)
    t0 = time.perf_counter()
    with ctx.spans.span("pack"):
        # render_sharded packs the scene on each call; this pack is timed alone
        scene = scenes.program_scene(xml, w, h)
        pack_scene(scene, ctx.dev)
        sync(ctx.dev)
    pack_s = time.perf_counter() - t0
    ref = scenes.reference_scene(xml, w, h) if rank == 0 else None
    pm.render_sharded(scene, mesh=mesh, spp=world, seed=scenes.image_seed(ctx.seed, -1))
    ctx.spans.wrap_queries()
    ctx.spans.wrap_passes(pm, "make_sharded_render_pass")
    sync(ctx.dev)
    torch.distributed.barrier()
    t_open_wall = time.time()
    images, rays, ends, traced = [], [], [], {}
    t_open = time.perf_counter()
    flag = torch.zeros(1, dtype=torch.int32, device=ctx.dev)
    while True:
        img = _image(ctx, pm, mesh, scene, spp, len(images))
        images.append(img if rank == 0 else None)
        rays.append(pm.render_sharded.last_ray_count)
        t_end = time.perf_counter()
        ends.append(t_end)
        flag.fill_(1 if rank == 0 and t_end - t_open >= ctx.seconds else 0)
        torch.distributed.all_reduce(flag)  # the harness's own exchange, not the program's
        if int(flag.item()):
            break
    window_s = time.perf_counter() - t_open
    if rank == 0:
        walls = [b - a for a, b in zip([t_open] + ends, ends)]
        print("portbench: rank 0 image seconds " + " ".join(f"{x:.4f}" for x in walls),
              file=sys.stderr)
    if ctx.trace:  # after the window: the profiler slows the host that paces the work
        before = dict(ctx.spans.counts)
        with ctx.dtrace.window():
            img = _image(ctx, pm, mesh, scene, spp, len(images))
        traced["queries"] = {c: n - before.get(c, 0) for c, n in ctx.spans.counts.items()}
        images.append(img if rank == 0 else None)
        rays.append(pm.render_sharded.last_ray_count)
    peak = memory_peak(ctx.dev)
    ctx.spans.restore()
    facts = render_facts(ctx, rays, w * h * spp, traced, len(ref.v0) if ref else 0)
    facts["pack_s"] = pack_s
    kept = [img for img in images if img is not None]
    return {
        "images": kept, "ref": ref, "facts": facts, "memory_peak_bytes": peak,
        "t_open_wall": t_open_wall, "samples_per_s": len(ends) * w * h * spp / window_s,
        "images_n": len(images),
        "failed": sum(1 for img in kept if not np.all(np.isfinite(img))),
    }


def _image(ctx, pm, mesh, scene, spp, k):
    with ctx.spans.span("render"):
        return pm.render_sharded(scene, mesh=mesh, spp=spp, seed=scenes.image_seed(ctx.seed, k))
