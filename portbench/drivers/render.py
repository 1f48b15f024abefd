"""Whole images back to back through `mitsuba_tpu_torch.render`.

Set-up loads the scene at the traffic's film size, packs it once (the
span `pack`) and renders one warm image of 1 spp, whose passes have the
window's shapes.  The window renders images of `spp` samples, each with
its own seed, through render(scene, spp, seed, pack=pack), and closes at
the end of the first image that ends after --seconds.  samples_per_s is
W x H x spp per image over the window.  With --trace 1 spans wrap each
image, each pass and each ray query, and one more image is profiled once
the window has closed; the rates, the pass loop's overhead and an
image's wall time are read from the window's images, which run as in an
untraced run.  Every image is checked.
"""

from __future__ import annotations

import sys
import time

import torch

from portbench.lib import compare, scenes
from portbench.lib.facts import render_facts
from portbench.lib.context import Outcome, memory_peak, sync


def run(ctx):
    from mitsuba_tpu_torch import renderer
    from mitsuba_tpu_torch.scene.builder import pack_scene

    tr = ctx.traffic
    w, h, spp = tr["width"], tr["height"], tr["spp"]
    xml = scenes.scene_xml(ctx.config)
    t0 = time.perf_counter()
    with ctx.spans.span("pack"):
        scene = scenes.program_scene(xml, w, h)
        pack = pack_scene(scene, ctx.dev)
        sync(ctx.dev)
    pack_s = time.perf_counter() - t0
    ref = scenes.reference_scene(xml, w, h)
    t0 = time.perf_counter()
    renderer.render(scene, spp=1, seed=scenes.image_seed(ctx.seed, -1), device=ctx.dev, pack=pack)
    warm_s = time.perf_counter() - t0
    ctx.spans.wrap_queries()
    ctx.spans.wrap_passes(renderer, "make_render_pass")
    setup_s = time.perf_counter() - ctx.t_start
    print(f"portbench: set-up {setup_s:.3f} s: pack {pack_s:.3f} s, warm image {warm_s:.3f} s",
          file=sys.stderr)

    images, rays, walls, traced = [], [], [], {}
    t_open = t_prev = time.perf_counter()
    while True:
        images.append(_image(ctx, renderer, scene, spp, len(images), pack))
        rays.append(renderer.render.last_ray_count)
        t_end = time.perf_counter()
        walls.append(t_end - t_prev)
        t_prev = t_end
        if t_end - t_open >= ctx.seconds:
            break
    window_s = t_end - t_open
    print("portbench: image seconds " + " ".join(f"{x:.4f}" for x in walls), file=sys.stderr)
    if ctx.trace:  # after the window: the profiler slows the host that paces the work
        before = dict(ctx.spans.counts)
        with ctx.dtrace.window():
            images.append(_image(ctx, renderer, scene, spp, len(images), pack))
        traced["queries"] = {c: n - before.get(c, 0) for c, n in ctx.spans.counts.items()}
        rays.append(renderer.render.last_ray_count)
    peak = memory_peak(ctx.dev)
    ctx.spans.restore()
    del pack, scene
    if ctx.dev.type == "cuda":
        torch.cuda.empty_cache()

    chk = tr["check"]
    numbers = compare.check_render(images, ref, spp, ctx.seed, ctx.dev, chk["pixels"],
                                   chk["ref_spp"], chk.get("lanes", 1 << 21))
    failed = sum(1 for img in images if not bool(torch.isfinite(torch.as_tensor(img)).all()))
    samples = w * h * spp
    facts = render_facts(ctx, rays, samples, traced, len(ref.v0))
    facts["pack_s"] = pack_s
    return Outcome(
        attempted=len(images), failed=failed,
        e2e={"setup_s": setup_s, "samples_per_s": len(walls) * samples / window_s},
        numbers=numbers, memory_peak_bytes=peak, facts=facts)


def _image(ctx, renderer, scene, spp, k, pack):
    with ctx.spans.span("render"):
        return renderer.render(scene, spp=spp, seed=scenes.image_seed(ctx.seed, k),
                               device=ctx.dev, pack=pack)
