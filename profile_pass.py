#!/usr/bin/env python3
"""Where the time of one render pass of the port goes, on one NVIDIA GPU.

    python3 profile_pass.py [dense|bigmesh|cbox|matpreview|matpreview-const|smoke|glass|door|
                             glass-sppm|smoke-pm|cbox-vpl|dipole|hairball|hairball-exact|
                             textured|dispersion|motion|fiber|fiber-microflake|instanced]
                            [--hits-only] [--mutations N]

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
pixel) with its light-image splats; or for scenes/door.xml as it stands
(pssmlt, bidirectional, 8 edges, 256x256: 65,536 chains), where a pass is
one Metropolis step of every chain and the warm-up pass the bootstrap; or
for the photon-mapping slice, where a pass is one iteration: glass-sppm
(scenes/glass_caustics.xml under sppm, maxDepth 24, 256x256, 2^18
photons), smoke-pm (scenes/smoke.xml under the volumetric photon mapper,
256x256, 2^17 photons) and cbox-vpl (scenes/cbox.xml under vpl, 512x512,
64 VPL paths), each with its own ranges "stage:eye", "stage:photon_walk",
"stage:sort", "stage:gather", "stage:bre" and "stage:vpl_shadow"
(integrator/sppm.py, photonmapper.py, vpl.py) around PHOTON_STAGES; or for
scenes/dipole.xml as it stands (512x384, path at maxDepth 8, 10 samples
per pass as `render` chunks its 64), after the irradiance pass (timed),
with the subsurface arm and the dense dipole sum among the stages
(SSS_STAGES); or for scenes/hairball.xml as it stands (512x384, path at
maxDepth 6, 10 samples per pass as `render` chunks its 64; STAGES), or
its exact mode (exact="true", 2 samples per pass), with the segment
scans (accel/cyl.py cyl_closest, cyl_any) among the stages (CYL_STAGES);
or for TEXTURED (tests/torch_meshes.py `textured_xml`, its assets written
from seed 0 into build/feature_assets; 512x512, 16 samples per pass),
with the texture lookups among the stages (TEX_STAGES: mip_footprint, and
eval_texture inside shading_params and shading_frame); or for
scenes/dispersion.xml as it stands (256x256, path at maxDepth 8, 32
samples per pass as `render` chunks its 256) in spectral mode, one bin
group of 9 bins: the group of 595 nm (group 1), whose pack
(scene/builder.py apply_spectral_pack, timed) moves the glass's eta,
with STAGES; or for MOTION (tests/torch_meshes.py `motion_xml`: cbox with
its short block animated and a deformable card, 512x512, 8 samples per
pass as `render` chunks its 16), with the animated and deformable arms
among the stages (MOTION_STAGES); or for FIBER (`fiber_xml`: scenes/
smoke.xml's medium with the kkay, or for fiber-microflake the microflake,
phase on the orientation volume that `fiber_assets` writes into
build/fiber_assets; 256x256, 32 samples per pass), with the orientation
lookup and the fiber arms among the stages (FIBER_STAGES); or for
INSTANCED (tests/torch_meshes.py `instanced_xml`: 1,024 instances of two
stand-in groups through the two-level accelerator, 512x512, 4 samples per
pass), with the instance route's functions (accel/tlas.py) among the
stages (INSTANCE_STAGES):

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
   the connections' shadow rays; for door BDPT_STAGES inside the step's
   own ranges `bootstrap`, `propose`, `trace`, `splat` and `accept`,
   integrator/pssmlt.py), the host time,
   the device time of the kernels launched inside and the calls;
   for door, the steps then go on to N mutations per pixel (`--mutations`,
   default 32), printing at 32, 64, 128, ... and at N the seconds so far
   (the bootstrap and every step, the profiled one included) and the
   tone-mapped RMSE against bench_refs/door_256.npz, and last the time to
   RMSE 0.01 projected from the last point (RMSE taken to fall as the
   inverse square root of the steps);
3. for the meshes (dense, bigmesh), holds the pair pipeline's closest hits of one camera ray
   per pixel against the port's stackless BVH walk (accel/intersect.py
   `_bvh_traverse`, plain PyTorch): hit masks, prims and t, and the count
   of prims that differ at unequal t (not an exact-t tie).  Each ray where
   they differ is judged in float64: Moller-Trumbore on the pack's float32
   triangles (tri9) promoted to float64, against every triangle for the
   closest hit, and against each side's prim for its t and barycentrics
   (u, v, w = 1 - u - v; a hit near an edge has one of them near 0).

`--hits-only` skips 1 and 2.  The last line printed is "profile_pass
<scene>: done in <s> s"; an error goes to standard error, with a non-zero
exit.

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
# the photon-mapping slice's queries and shading, inside the integrators'
# own stage ranges
PHOTON_STAGES = tuple(
    (f"mitsuba_tpu_torch.integrator.{mod}", names) for mod, names in (
        ("sppm", ("intersect", "occluded", "bsdf_eval", "bsdf_sample")),
        ("photonmapper", ("intersect", "_attenuated_visibility", "bsdf_eval", "bsdf_sample")),
        ("vpl", ("intersect", "occluded", "bsdf_eval", "bsdf_sample")))
) + (("mitsuba_tpu_torch.medium.eval", ("sample_distance", "transmittance", "phase_eval")),
     ("mitsuba_tpu_torch.core.rng", ("rand4",)))
# the bounce loop's stages with the subsurface arm (scenes/dipole.xml):
# subsurface_radiance holds sss_lo, the dense dipole sum
SSS_STAGES = STAGES + (
    ("mitsuba_tpu_torch.integrator.path", ("subsurface_radiance",)),
    ("mitsuba_tpu_torch.integrator.sss", ("sss_lo", "single_scatter_lo")),
)
# the bounce loop's stages with the segment scans (the exact hairball),
# which nest inside intersect and occluded
CYL_STAGES = STAGES + (("mitsuba_tpu_torch.accel.cyl", ("cyl_closest", "cyl_any")),)
# the bounce loop's stages with the texture lookups (TEXTURED): eval_texture
# nests inside shading_params and shading_frame
TEX_STAGES = STAGES + (("mitsuba_tpu_torch.integrator.path", ("mip_footprint",)),
                       ("mitsuba_tpu_torch.scene.texture_eval", ("eval_texture",)))
# the bounce loop's stages with the animated and deformable arms (MOTION),
# which nest inside intersect and occluded
MOTION_STAGES = STAGES + (
    ("mitsuba_tpu_torch.accel.intersect",
     ("_anim_closest", "_anim_any", "_deform_closest", "_deform_any")),
)
# the volumetric event loop's stages with the fiber phases' orientation
# lookup and arms (FIBER), which nest inside phase_sample, phase_eval and
# phase_pdf
FIBER_STAGES = SMOKE_STAGES + (
    ("mitsuba_tpu_torch.medium.eval", ("_orient_at", "_kkay_eval", "_microflake_eval")),
)
# the bounce loop's stages with the instance route (INSTANCED): the pair
# path's instance lists and rounds, and the loop path that finishes the
# rays past K_INST boxes, nested inside intersect and occluded
INSTANCE_STAGES = STAGES + (
    ("mitsuba_tpu_torch.accel.tlas",
     ("inst_closest_pairs", "inst_any_pairs", "_inst_lists", "inst_closest", "inst_any")),
    ("mitsuba_tpu_torch.accel.pairs", ("pair_closest", "pair_any")),
)
# film size and samples per pass of each scene (door: one step, one
# mutation per pixel; the photon mappers: one iteration; dipole: its
# film's width, and render's chunk of its 64 spp)
RES_SPP = {"smoke": (256, 32), "glass": (256, 2), "door": (256, 1), "glass-sppm": (256, 1),
           "smoke-pm": (256, 1), "cbox-vpl": (512, 1), "dipole": (512, 10),
           "hairball": (512, 10), "hairball-exact": (512, 2), "dispersion": (256, 32),
           "motion": (512, 8), "fiber": (256, 32), "fiber-microflake": (256, 32),
           "instanced": (512, 1)}
PHOTON_MODES = ("glass-sppm", "smoke-pm", "cbox-vpl")


def chain_pass(scene, pack, dev, mutations):
    """The steps of a PSSMLT render of `mutations` mutations per pixel
    (iter_pssmlt; seed 0) as a render pass: fn(film, sample_base, seed)
    -> (film, rays traced); the first call runs the bootstrap, each later
    one a step.  fn.state holds the last image, the steps done, the steps
    in all and the seconds of all calls so far."""
    import torch

    from mitsuba_tpu_torch.integrator.pssmlt import iter_pssmlt

    steps = iter_pssmlt(scene, pack, mutations, 0, None, dev)
    state = {"seconds": 0.0, "rays": 0}

    def rp(film, sample_base, seed):
        t0 = time.time()
        img, done, n_steps, st = next(steps)
        torch.cuda.synchronize()
        state.update(img=img, done=done, n_steps=n_steps,
                     seconds=state["seconds"] + time.time() - t0)
        rays = int(st["rays"]) - state["rays"]
        state["rays"] = int(st["rays"])
        return film, torch.tensor(rays)

    rp.state = state
    return rp


def iteration_pass(steps):
    """A generator of (image, iterations done, stats) (iter_sppm,
    iter_photonmapper, iter_vpl) as a render pass: fn(film, sample_base,
    seed) -> (film, rays traced by the iteration) runs one iteration."""
    import torch

    state = {"rays": 0}

    def rp(film, sample_base, seed):
        _, _, st = next(steps)
        torch.cuda.synchronize()
        rays = int(st["rays"]) - state["rays"]
        state["rays"] = int(st["rays"])
        return film, torch.tensor(rays)

    return rp


def door_ladder(rp, ref):
    """Step on to the end of the chain pass rp, printing at 32, 64, ...
    steps and at the last the seconds so far and the tone-mapped RMSE of
    the image against ref (an .npz); then the projected time to RMSE
    0.01."""
    import numpy as np
    from torch_meshes import tm_rmse

    gold = np.load(ref)["img"].astype(np.float32)
    st = rp.state

    def point():
        img = st["img"].cpu().numpy()
        rmse = tm_rmse(img, gold)
        print(f"ladder: {st['done']} mutations per pixel, {st['seconds']:.3f} s, tone-mapped "
              f"RMSE vs {os.path.relpath(ref, HERE)} {rmse:.6g}", flush=True)
        return rmse

    mark, rmse = 32, None
    while st["done"] < st["n_steps"]:
        rp(None, 0, 0)
        if st["done"] == mark:
            rmse = point()
            mark *= 2
    if st["done"] != mark // 2:
        rmse = point()
    print(f"ladder: projected time to RMSE 0.01: {st['seconds'] * (rmse / 0.01) ** 2:.1f} s "
          f"(RMSE ~ steps^-1/2 from the last point)", flush=True)


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
    "stage:<name>"; returns a function that undoes it.  While wrapped, a
    function's counters count on the wrapper."""
    import functools
    import importlib

    import torch

    saved = []
    for modname, names in stages:
        mod = importlib.import_module(modname)
        for name in names:
            fn = getattr(mod, name)

            # functools.wraps copies the function's counters (launches,
            # rays), which it updates through its module's name
            @functools.wraps(fn)
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
                             "smoke", "glass", "door", "dipole", "hairball",
                             "hairball-exact", "textured", "dispersion", "motion", "fiber",
                             "fiber-microflake", "instanced") + PHOTON_MODES)
    ap.add_argument("--hits-only", action="store_true")
    ap.add_argument("--mutations", type=int, default=32,
                    help="door: the mutations per pixel the steps go on to")
    args = ap.parse_args()
    t_start = time.time()
    rc = run(args)
    if rc == 0:
        print(f"profile_pass {args.scene}: done in {time.time() - t_start:.1f} s", flush=True)
    return rc


def run(args):
    """Steps 1 to 3 for args.scene; returns the exit code."""

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
        cbox_xml,
        dense_standin,
        feature_assets,
        fiber_assets,
        fiber_xml,
        glass_xml,
        hairball_xml,
        instanced_xml,
        matpreview_const_xml,
        motion_xml,
        smoke_xml,
        textured_xml,
        with_integrator,
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
    elif args.scene == "door":
        scene = mt.load_scene(os.path.join(HERE, "scenes", "door.xml"))
    elif args.scene == "glass-sppm":
        scene = mt.load_scene_string(with_integrator(glass_xml(res, res), "sppm"))
    elif args.scene == "smoke-pm":
        scene = mt.load_scene_string(with_integrator(smoke_xml(res, res), "photonmapper"))
    elif args.scene == "cbox-vpl":
        scene = mt.load_scene_string(cbox_xml("vpl", res, res))
    elif args.scene == "dipole":
        scene = mt.load_scene(os.path.join(HERE, "scenes", "dipole.xml"))
    elif args.scene == "dispersion":
        scene = mt.load_scene(os.path.join(HERE, "scenes", "dispersion.xml"))
    elif args.scene == "textured":
        scene = mt.load_scene_string(textured_xml(
            feature_assets(os.path.join(HERE, "build", "feature_assets")), RES, RES, SPP))
    elif args.scene == "motion":
        scene = mt.load_scene_string(motion_xml(res, res, 16))
    elif args.scene == "instanced":
        from chip_smoke import INSTANCED_B_PLY, INSTANCED_N, STANDIN_PLY

        os.makedirs(os.path.dirname(STANDIN_PLY), exist_ok=True)
        write_ply(STANDIN_PLY, *bunny_standin(seed=0))
        write_ply(INSTANCED_B_PLY, *bunny_standin(seed=1, n_phi=132, n_theta=66))
        scene = mt.load_scene_string(instanced_xml(STANDIN_PLY, INSTANCED_B_PLY, res, res, spp,
                                                   n=INSTANCED_N))
    elif args.scene.startswith("fiber"):
        scene = mt.load_scene_string(fiber_xml(
            "microflake" if args.scene == "fiber-microflake" else "kkay",
            fiber_assets(os.path.join(HERE, "build", "fiber_assets")), "grid", res, res))
    elif args.scene.startswith("hairball"):
        scene = mt.load_scene_string(hairball_xml(exact=args.scene == "hairball-exact"))
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
    film = scene.sensor.record.film
    print(f"{args.scene} {film.width}x{film.height}, {spp} spp per pass: packed in "
          f"{time.time() - t0:.3f} s; meta n_clusters={pack.meta.get('n_clusters')} "
          f"n_supers={pack.meta.get('n_supers')} cluster_vmem_ok={pack.meta.get('cluster_vmem_ok')}",
          flush=True)
    if args.scene == "dispersion":
        from mitsuba_tpu_torch.core.spectral import make_bins
        from mitsuba_tpu_torch.scene.builder import apply_spectral_pack

        t0 = time.time()
        base_eta = pack.mat_eta.tolist()
        pack = apply_spectral_pack(pack, make_bins(9), 1)
        torch.cuda.synchronize()
        print(f"apply_spectral_pack (9 bins, group 1): {time.time() - t0:.4f} s; mat_eta "
              f"{base_eta} -> {pack.mat_eta.tolist()}", flush=True)
    if pack.meta.get("has_sss", False):
        from mitsuba_tpu_torch.integrator.sss import prepare_sss

        t0 = time.time()
        pack = prepare_sss(pack, scene.integrator, 0)
        torch.cuda.synchronize()
        print(f"irradiance pass: {pack.sss_p.shape[0]} points x {pack.meta['sss_irr_samples']} "
              f"rays in {time.time() - t0:.3f} s", flush=True)

    if not args.hits_only:
        rp = profile_passes(scene, pack, dev, make_render_pass, new_film, pairs,
                            counters(pk, pairs, pb), res, spp,
                            {"smoke": SMOKE_STAGES, "glass": BDPT_STAGES, "door": BDPT_STAGES,
                             "dipole": SSS_STAGES, "hairball-exact": CYL_STAGES,
                             "textured": TEX_STAGES, "motion": MOTION_STAGES,
                             "fiber": FIBER_STAGES, "fiber-microflake": FIBER_STAGES,
                             "instanced": INSTANCE_STAGES,
                             **dict.fromkeys(PHOTON_MODES, PHOTON_STAGES)}.get(args.scene, STAGES),
                            args.mutations)
        if args.scene == "door":
            door_ladder(rp, os.path.join(HERE, "bench_refs", "door_256.npz"))
    if args.scene in ("dense", "bigmesh"):
        check_hits(scene, pack, dev, camera_rays, intersect, pairs)
    return 0


def profile_passes(scene, pack, dev, make_render_pass, new_film, pairs, wrappers, res, spp,
                   stages, mutations):
    """Steps 1 and 2; wrappers: the port's kernel wrappers by name.
    Returns the render pass."""
    import torch

    from chip_smoke import stage_summary

    rec = scene.sensor.record
    if scene.integrator.kind == "bdpt":
        rp = bdpt_pass(scene, pack, spp, dev)
    elif scene.integrator.kind == "pssmlt":
        rp = chain_pass(scene, pack, dev, mutations)
    elif scene.integrator.kind in ("sppm", "photonmapper", "vpl"):
        from mitsuba_tpu_torch.integrator import photonmapper, sppm, vpl

        if scene.integrator.kind == "vpl":
            steps = vpl.iter_vpl(scene, pack, 1000, 0, dev)
        else:
            iterate = sppm.iter_sppm if scene.integrator.kind == "sppm" else \
                photonmapper.iter_photonmapper
            steps = iterate(scene, pack, 1000, 0, None, dev)
        rp = iteration_pass(steps)
    else:
        rp = make_render_pass(pack, scene.integrator, rec, rec.film, rec.sampler, spp, dev)
    film = new_film(rec.film.height, rec.film.width, dev)

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
    # on the device: kernels by name, and the kernels launched inside each
    # stage's ranges
    st, by_name, dev_ms, n_k = stage_summary(prof)
    print(f"profiled pass: wall {wall:.4f} s, {n} rays; device kernel time {dev_ms:.3f} ms, "
          f"busy share {dev_ms / 1e3 / wall:.4f}; {n_k} kernels", flush=True)
    kernels = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)

    def show(rows):
        for name, (ms, count) in rows:
            print(f"  {ms:10.3f} ms {100 * ms / max(dev_ms, 1e-9):6.2f} % {count:7d} x  "
                  f"{name[:110]}", flush=True)

    show(kernels[:TOP])
    # the port's kernels live in the anonymous namespaces of csrc/*.cu
    print("the port's own kernels:", flush=True)
    show([kv for kv in kernels if kv[0].startswith(("(anonymous namespace)::",
                                                     "void (anonymous"))])
    print(f"kernel launches in the profiled pass: {launches}", flush=True)
    if events:
        print(f"volpath events in the profiled pass: {events}, {n_k / events:.1f} kernels per "
              f"event", flush=True)
    print("by stage (host ms inside the range, device ms of the kernels launched in it, calls):",
          flush=True)
    for name, (s_dev, calls, s_host) in sorted(st.items(), key=lambda kv: -kv[1][2]):
        print(f"  {name:18s} host {s_host:10.3f} ms  device {s_dev:10.3f} ms  {calls:6d} calls",
              flush=True)
    ov = {k: pairs.pair_closest.__dict__.get(k) for k in ("rays", "overflow_rays")}
    print(f"pair_closest counters over the run: {ov}", flush=True)
    if pack.meta.get("has_instances", False):
        from mitsuba_tpu_torch.accel import tlas

        ov = {fn.__name__: (fn.overflow_rays, fn.rays)
              for fn in (tlas.inst_closest_pairs, tlas.inst_any_pairs)}
        print(f"instance lists past K_INST over the run (rays, of): {ov}", flush=True)
    return rp


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
