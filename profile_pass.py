#!/usr/bin/env python3
"""Where the time of one render pass of the port goes, on one NVIDIA GPU.

    python3 profile_pass.py [dense|bigmesh|cbox|matpreview|matpreview-const|smoke|glass] [--hits-only]

For scenes/bunny.xml's configuration on the dense stand-in (870,480
triangles, default) or the 69,168-triangle stand-in (tests/torch_meshes.py),
for scenes/cbox.xml, for scenes/matpreview.xml as it stands (envmap,
sobol), or for its variant (a constant environment and the independent
sampler, tests/torch_meshes.py `matpreview_const_xml`), at 512x512 and 16
samples per pass; or for scenes/smoke.xml (volpath, the batched
wavefront) at the reference's bench resolution, 256x256, and 32 samples
per pass (one pass of 2,097,152 lanes); or for scenes/glass_caustics.xml
(bdpt, 16 edges) at its bench resolution, 256x256, where a pass is one
chunk of the lane budget (MTS_BDPT_LANES, 131,072 lanes: 2 samples per
pixel) with its light-image splats:

1. builds the kernels, packs the scene on the card, runs one warm-up pass
   and three timed passes (host clock around work that ends in a
   synchronise), printing seconds and traced rays per second of each;
2. profiles one more pass with torch.profiler (CPU and CUDA activities):
   the pass's wall time, the device time of its kernels, the busy share
   (kernel time over wall time; the profiler's own overhead lengthens the
   wall), the number of kernels, the 15 kernels of most device time, the
   device time of each of the port's own kernels, and the launches of each
   of its kernel wrappers in that pass (their counters); and, by stage of
   the bounce loop (the functions in STAGES, each wrapped in a
   `record_function` range for this pass only; SMOKE_STAGES for smoke,
   whose ranges nest: `_het_track` inside `sample_distance`, the shadow
   segments' `intersect` inside `_attenuated_visibility`; BDPT_STAGES for
   glass, where `intersect` nests inside `_walk` and `occluded` stands for
   the connections' shadow rays), the host time,
   the device time of the kernels launched inside and the calls;
3. for the meshes (dense, bigmesh), holds the pair pipeline's closest hits of one camera ray
   per pixel against the port's stackless BVH walk (accel/intersect.py
   `_bvh_traverse`, plain PyTorch): hit masks, prims and t, and the count
   of prims that differ at unequal t (not an exact-t tie).  Each ray where
   they differ is judged in float64: Moller-Trumbore on the pack's float32
   triangles (tri9) promoted to float64, against every triangle for the
   closest hit, and against each side's prim for its t and barycentrics
   (u, v, w = 1 - u - v; a hit near an edge has one of them near 0).

`--hits-only` skips 1 and 2.

Nothing of JAX is imported.  Exits non-zero without a CUDA device.
"""

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RES = 512  # film width and height
SPP = 16  # samples per pixel of one pass
TOP = 15  # kernels listed by device time


# the bounce loop's stages: (module, functions) whose calls the profiled
# pass wraps in a record_function range named after the function
STAGES = (
    ("mitsuba_tpu_torch.integrator.path",
     ("intersect", "fill_interaction", "occluded", "shading_frame", "shading_params",
      "bsdf_eval", "bsdf_pdf", "bsdf_sample")),
    ("mitsuba_tpu_torch.emitter.eval",
     ("sample_direct", "eval_env", "pdf_direct_env", "pdf_direct_area")),
    ("mitsuba_tpu_torch.core.rng", ("rand4",)),
    ("mitsuba_tpu_torch.integrator.path", ("ld_decision4",)),
)
# the volumetric event loop's stages (scenes/smoke.xml)
SMOKE_STAGES = (
    ("mitsuba_tpu_torch.integrator.volpath",
     ("intersect", "fill_interaction", "_attenuated_visibility", "shading_params",
      "bsdf_eval", "bsdf_pdf", "bsdf_sample")),
    ("mitsuba_tpu_torch.medium.eval",
     ("sample_distance", "_het_track", "transmittance", "phase_sample", "phase_eval",
      "phase_pdf")),
    ("mitsuba_tpu_torch.emitter.eval", ("sample_direct",)),
    ("mitsuba_tpu_torch.core.rng", ("rand4",)),
    ("mitsuba_tpu_torch.renderer", ("splat_grid",)),
)
# a bdpt chunk's stages (scenes/glass_caustics.xml)
BDPT_STAGES = (
    ("mitsuba_tpu_torch.integrator.bdpt",
     ("_walk", "intersect", "fill_interaction", "occluded", "shading_params", "bsdf_eval",
      "bsdf_pdf", "bsdf_sample", "_sample_light_vertex", "_mis_weight", "_v_f", "_v_pdf",
      "_to_area")),
    ("mitsuba_tpu_torch.emitter.eval", ("sample_direct",)),
    ("mitsuba_tpu_torch.core.rng", ("rand4",)),
    ("mitsuba_tpu_torch.film.film", ("splat_add",)),
)
# film size and samples per pass of each scene
RES_SPP = {"smoke": (256, 32), "glass": (256, 2)}


def bdpt_pass(scene, pack, spp, dev):
    """One bdpt chunk of spp samples per pixel (lanes laid out as
    render_bdpt lays them) as a render pass: fn(film, sample_base, seed)
    -> (film, rays traced); the estimates land in film[..., :3], the
    light-image splats in an image of its own.  The chunk draws with seed
    0."""
    import torch

    from mitsuba_tpu_torch.film import film as film_mod
    from mitsuba_tpu_torch.integrator import bdpt

    rec = scene.sensor.record
    w, h = rec.film.width, rec.film.height
    chunk = bdpt.make_bdpt_chunk(pack, scene.integrator, rec, w, h, 0)
    lane = torch.arange(w * h, device=dev).repeat(spp)
    s_i = torch.arange(spp, device=dev).repeat_interleave(w * h)
    light = torch.zeros(h, w, 3, device=dev)

    def rp(film, sample_base, seed):
        nonlocal light
        before = chunk.stats["rays"]
        L, splats = chunk(lane, sample_base + s_i)
        for pos, val, ok in splats:
            light = film_mod.splat_add(light, pos, val, rec.film.rfilter, valid=ok)
        film = film.clone()
        film[..., :3] += L.reshape(spp, h, w, 3).sum(dim=0)
        return film, chunk.stats["rays"] - before

    return rp


def staged(stages):
    """Wrap each function of `stages` in a record_function range
    "stage:<name>"; returns a function that undoes it."""
    import importlib

    import torch

    saved = []
    for modname, names in stages:
        mod = importlib.import_module(modname)
        for name in names:
            fn = getattr(mod, name)

            def wrapped(*a, _fn=fn, _range=f"stage:{name}", **kw):
                with torch.profiler.record_function(_range):
                    return _fn(*a, **kw)

            saved.append((mod, name, fn))
            setattr(mod, name, wrapped)
    return lambda: [setattr(mod, name, fn) for mod, name, fn in saved]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene", nargs="?", default="dense",
                    choices=("dense", "bigmesh", "cbox", "matpreview", "matpreview-const",
                             "smoke", "glass"))
    ap.add_argument("--hits-only", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_pass: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.append(os.path.join(HERE, "tests"))
    import mitsuba_tpu_torch as mt
    from chip_smoke import MATPREVIEW_XML, SOURCES, camera_rays, counters
    from mitsuba_tpu_torch import native
    from mitsuba_tpu_torch.accel import intersect, pairs
    from mitsuba_tpu_torch.accel import pallas_bvh as pb
    from mitsuba_tpu_torch.accel import pallas_kernels as pk
    from mitsuba_tpu_torch.film.film import new_film
    from mitsuba_tpu_torch.renderer import make_render_pass
    from mitsuba_tpu_torch.scene.builder import pack_scene
    from torch_meshes import (
        bunny_scene_xml,
        bunny_standin,
        dense_standin,
        glass_xml,
        matpreview_const_xml,
        smoke_xml,
        write_ply,
    )

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for name in SOURCES:
        native.build(name)

    res, spp = RES_SPP.get(args.scene, (RES, SPP))
    if args.scene == "smoke":
        scene = mt.load_scene_string(smoke_xml(res, res))
    elif args.scene == "glass":
        scene = mt.load_scene_string(glass_xml(res, res))
    elif args.scene == "cbox":
        scene = mt.load_scene(os.path.join(HERE, "scenes", "cbox.xml"))
        scene.sensor.record.film.width = scene.sensor.record.film.height = RES
    elif args.scene == "matpreview":
        scene = mt.load_scene(MATPREVIEW_XML)
        scene.sensor.record.film.width = scene.sensor.record.film.height = RES
    elif args.scene == "matpreview-const":
        scene = mt.load_scene_string(matpreview_const_xml(RES, RES))
    else:
        mesh = dense_standin if args.scene == "dense" else bunny_standin
        ply = os.path.join(HERE, "build", f"{args.scene}_standin.ply")
        os.makedirs(os.path.dirname(ply), exist_ok=True)
        write_ply(ply, *mesh(seed=0))
        scene = mt.load_scene_string(bunny_scene_xml(ply, RES, RES))
    t0 = time.time()
    pack = pack_scene(scene, dev)
    print(f"{args.scene} {res}x{res}, {spp} spp per pass: packed in "
          f"{time.time() - t0:.3f} s; meta n_clusters={pack.meta.get('n_clusters')} "
          f"n_supers={pack.meta.get('n_supers')} cluster_vmem_ok={pack.meta.get('cluster_vmem_ok')}",
          flush=True)

    if not args.hits_only:
        profile_passes(scene, pack, dev, make_render_pass, new_film, pairs,
                       counters(pk, pairs, pb), res, spp,
                       {"smoke": SMOKE_STAGES, "glass": BDPT_STAGES}.get(args.scene, STAGES))
    if args.scene in ("dense", "bigmesh"):
        check_hits(scene, pack, dev, camera_rays, intersect, pairs)
    return 0


def profile_passes(scene, pack, dev, make_render_pass, new_film, pairs, wrappers, res, spp,
                   stages):
    """Steps 1 and 2; wrappers: the port's kernel wrappers by name."""
    import torch

    from chip_smoke import device_events, device_us

    rec = scene.sensor.record
    if scene.integrator.kind == "bdpt":
        rp = bdpt_pass(scene, pack, spp, dev)
    else:
        rp = make_render_pass(pack, scene.integrator, rec, rec.film, rec.sampler, spp, dev)
    film = new_film(res, res, dev)

    def one_pass(i):
        nonlocal film
        t0 = time.time()
        film, n_rays = rp(film, i * spp, 0)
        n = int(n_rays)  # synchronises
        torch.cuda.synchronize()
        return time.time() - t0, n

    s, n = one_pass(0)
    print(f"warm-up pass: {s:.4f} s, {n} rays", flush=True)
    for i in range(1, 4):
        s, n = one_pass(i)
        print(f"pass {i}: {s:.4f} s, {n} rays, {n / s:.6g} rays/s", flush=True)

    from torch.profiler import ProfilerActivity, profile

    from mitsuba_tpu_torch.integrator.volpath import volpath_trace

    for fn in wrappers.values():
        fn.launches = 0
    events = volpath_trace.events
    unstage = staged(stages)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall, n = one_pass(4)
    finally:
        unstage()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    events = volpath_trace.events - events  # volpath's event loop (0 for path)
    # on the device: kernels, and the GPU-side spans of the stage ranges
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("stage:")]
    dev_us = sum(device_us(e) for e in kernels)
    n_k = sum(e.count for e in kernels)
    print(f"profiled pass: wall {wall:.4f} s, {n} rays; device kernel time {dev_us / 1e3:.3f} ms, "
          f"busy share {dev_us / 1e6 / wall:.4f}; {n_k} kernels (raw device events: "
          f"{'%.3f ms, %d' % device_events(prof)})", flush=True)
    kernels.sort(key=device_us, reverse=True)

    def show(evts):
        for e in evts:
            print(f"  {device_us(e) / 1e3:10.3f} ms {100 * device_us(e) / max(dev_us, 1):6.2f} % "
                  f"{e.count:7d} x  {e.key[:110]}", flush=True)

    show(kernels[:TOP])
    # the port's kernels live in the anonymous namespaces of csrc/*.cu
    print("the port's own kernels:", flush=True)
    show([e for e in kernels if e.key.startswith(("(anonymous namespace)::", "void (anonymous"))])
    print(f"kernel launches in the profiled pass: {launches}", flush=True)
    if events:
        print(f"volpath events in the profiled pass: {events}, {n_k / events:.1f} kernels per "
              f"event", flush=True)
    stages = [e for e in prof.key_averages() if e.key.startswith("stage:")
              and e.device_type == torch.autograd.DeviceType.CPU]
    stages.sort(key=lambda e: e.cpu_time_total, reverse=True)
    print("by stage (host ms inside the range, device ms of the kernels launched in it, calls):",
          flush=True)
    for e in stages:
        dev_total = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
        print(f"  {e.key[6:]:18s} host {e.cpu_time_total / 1e3:10.3f} ms  device "
              f"{dev_total / 1e3:10.3f} ms  {e.count:6d} calls", flush=True)
    ov = {k: pairs.pair_closest.__dict__.get(k) for k in ("rays", "overflow_rays")}
    print(f"pair_closest counters over the run: {ov}", flush=True)


def mt64(o, d, tri9):
    """Moller-Trumbore in float64: o, d [R, 1, 3], tri9 [1 or R, N, 9]
    -> (t, u, v, hit) [R, N]."""
    import torch

    v0, e1, e2 = tri9[..., 0:3], tri9[..., 3:6], tri9[..., 6:9]
    p = torch.linalg.cross(d, e2, dim=-1)
    det = (e1 * p).sum(-1)
    ok = det.abs() > 1e-12
    inv = torch.where(ok, 1.0 / det, 0.0)
    tv = o - v0
    u = (tv * p).sum(-1) * inv
    q = torch.linalg.cross(tv, e1, dim=-1)
    v = (d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    return t, u, v, ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4)


def closest64(pack, o, d, cols=1 << 16):
    """(t, prim) of each ray's closest hit among all triangles, in
    float64; o, d [R, 3] float64."""
    import torch

    tri = pack.tri9.double()
    best_t = torch.full((o.shape[0],), float("inf"), dtype=torch.float64, device=o.device)
    best_p = torch.full((o.shape[0],), -1, dtype=torch.int64, device=o.device)
    for s in range(0, tri.shape[0], cols):
        t, _, _, hit = mt64(o[:, None], d[:, None], tri[None, s:s + cols])
        tmin, arg = torch.where(hit, t, float("inf")).min(dim=1)
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_p = torch.where(better, arg + s, best_p)
    return best_t, best_p


def judge(pack, o, d, prim):
    """float64 (t, u, v, w, hit) of ray i against prim[i] (-1: none)."""
    t, u, v, hit = mt64(o[:, None], d[:, None], pack.tri9.double()[prim.clamp(min=0).long()][:, None])
    return [(float(a), float(b), float(c), float(1 - b - c), bool(h) and int(p) >= 0)
            for a, b, c, h, p in zip(t[:, 0], u[:, 0], v[:, 0], hit[:, 0], prim)]


def check_hits(scene, pack, dev, camera_rays, intersect, pairs):
    """Step 3."""
    import torch

    o, d = camera_rays(scene, dev)
    t_big = torch.full((o.shape[0],), pairs.BIG, device=dev)
    t0 = time.time()
    pt, pp, _, _ = pairs.pair_closest(pack, o, d, t_big)
    torch.cuda.synchronize()
    t_pair = time.time() - t0
    t0 = time.time()
    bt, bp, _, _ = intersect._bvh_traverse(pack, o, d, t_big)
    torch.cuda.synchronize()
    t_bvh = time.time() - t0
    hit_p, hit_b = pp >= 0, bp >= 0
    both = hit_p & hit_b
    diff = both & (pp != bp)
    dt = (pt - bt).abs()
    rel = dt[both] / bt[both].abs().clamp(min=1e-30)
    print(f"hits of {o.shape[0]} camera rays, pair pipeline ({t_pair:.3f} s) vs BVH walk "
          f"({t_bvh:.3f} s): hit masks differ on {int((hit_p != hit_b).sum())} rays, "
          f"{int(both.sum())} hit in both; prims differ on {int(diff.sum())} "
          f"({int((diff & (dt > 1e-5)).sum())} at |dt| > 1e-5); max rel t diff "
          f"{float(rel.max()) if rel.numel() else 0.0:.3g}", flush=True)
    idx = torch.nonzero((hit_p != hit_b) | diff).squeeze(1)
    if not idx.numel():
        return
    o64, d64 = o[idx].double(), d[idx].double()
    ft, fp = closest64(pack, o64, d64)
    side_p, side_b = judge(pack, o64, d64, pp[idx]), judge(pack, o64, d64, bp[idx])
    for j, i in enumerate(idx.tolist()):
        right = [name for name, prim in (("pair pipeline", pp[i]), ("BVH walk", bp[i]))
                 if int(prim) == int(fp[j])]
        print(f"  ray {i}: pair pipeline t={float(pt[i]):.9g} prim={int(pp[i])}; BVH walk "
              f"t={float(bt[i]):.9g} prim={int(bp[i])}; float64 closest t={float(ft[j]):.12g} "
              f"prim={int(fp[j])}: agrees with {' and '.join(right) or 'neither'}", flush=True)
        for name, (t, u, v, w, hit) in (("pair pipeline", side_p[j]), ("BVH walk", side_b[j])):
            print(f"    float64 on the {name}'s prim: hit={hit} t={t:.12g} u={u:.3e} v={v:.3e} "
                  f"w={w:.3e} (nearest edge {min(abs(u), abs(v), abs(w)):.3e})", flush=True)


if __name__ == "__main__":
    sys.exit(main())
