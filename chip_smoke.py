#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mitsuba_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and exits non-zero) on failure:

1. require a CUDA device, print the card's name and power limit, and
   build the port's kernels from csrc/ with nvcc (one nvcc per source,
   started together) and its host alias-table builder
   (csrc/host/alias_table.cpp) with g++ beside them, which the envmap's
   table must come from; beside them, ptxas's registers, stack and spills
   of every kernel (K1/K2/K11, K12, K3, K4, K5 and K6 may neither spill
   nor use a stack);
2. hold each kernel against its plain PyTorch version on the card and
   time both (CUDA events, median of 20 runs, the host's launch work
   between the events), and print each kernel's time on the card alone
   beside (the host's work hidden behind a sleep kernel):
   * K1/K2, K11 and K12 (brute_tiled.cu: K1/K2 and K11 run brute_kernel,
     on the sublane pack tri_s and the transposed pack tri_t; K12 runs
     mxu_kernel on the bilinear mt_matrix; t_max inf for the K11/K12
     closest hits), at the Cornell box's shapes (its triangles x 262,144
     camera rays) and on 1,000,000 random rays x 300 random triangles:
     prim and occlusion equal, t within 1 ulp; beside each, the columns
     its kernel tests (pk.live_columns, pk.mxu_live_columns) and, for
     K12, the columns flagged for the full ten-row sums (pk.mxu_flags),
     the tests per ray, the bound of those tests at one FP32 operation per
     lane per cycle (no FMA runs), and on camera rays the former design's
     time (FORMER_MS); then the host's time per call of native.launch
     (R = 0, nothing launched, and R = 1) and of the six brute-force
     wrappers at R = 1;
   * K3/K4/K7/K8 (cluster_hit.cu) on the big-mesh stand-in
     (tests/torch_meshes.py: 69,168 triangles in scenes/bunny.xml's
     configuration) with 262,144 camera rays and 262,144 random
     incoherent rays: K3 exactly equal, with its group and cluster slab
     tests per ray; K4/K7 prim equal and t within 1 ulp, K4/K8 occlusion
     equal, with the columns K4 tests per pair and K6 on K4's lists (the
     pair queue's sort included) timed beside; the former K3/K4's times
     beside (FORMER_MS); also the natural overflow share, and
     K7/K8 equal to plain on the batch the pair pipeline hands its
     fallback and timed there, with the clusters each fallback ray visits
     and its box scans (mean, max), K9/K10 on the same batch (equal
     stats) and the full-rescan kernels' times beside;
   * K5/K6/K9/K10 (cluster_stream.cu) on the dense stand-in (870,480
     triangles, 9,856 clusters) with the same two ray sets: K5 exactly
     equal, with its group, super and member slab tests per ray; K6
     closest/any as K4, with the columns it tests per pair; the former
     design's times beside (FORMER_MS); K9/K10 on a seeded subset of 16,384
     rays of each set (the plain walk is slow at 9,856 clusters, and the
     fallback's batches are of that order), the kernels also timed on
     all rays and on the batch the pair pipeline hands its fallback
     (equal to plain there), with the clusters each fallback ray visits
     and its box scans (mean, max), beside the times of the full-rescan
     kernels they replaced;
     also the natural overflow share at K = 3, KS = 8, and K4 on the
     cluster lists K6 takes (equal results), timed beside K6;
   * K1/K2 on the tri_s of scenes/matpreview.xml (its ground's 2
     triangles), as it stands (envmap, sobol) and as the variant
     (a constant environment and the independent sampler,
     tests/torch_meshes.py `matpreview_const_xml`), bit for bit, on its
     262,144 camera rays and on the shadow rays of their first hits toward
     the environment with the first bounce's NEE draw of a pass (for the
     envmap, alias-sampled directions; t_max 1e7);
   * K3/K4 (closest) on scenes/smoke.xml's closest-hit queries (1,038
     triangles in 11 clusters): the camera rays' query and the three
     shadow segments of the first NEE (through the null cube and the
     smoke, with finite t_max) of a 64x64, 16-spp pass and of the phase-4
     pass (256x256, 32 spp: 2,097,152 rays a query; `smoke_queries`), bit
     for bit (cluster lists; t, prim, u, v), and K7 on the batch each
     query hands the fallback;
   * the light-transport slice (`capture_queries`): K1/K2 (closest and
     any) on the particle tracer's first two camera-connection queries on
     cbox at 512x512, 4 particles per pixel (1,048,576 segments each),
     and K3, K4 (any and closest) on the first three connection queries
     of a 64x64 glass_caustics bdpt chunk (131,072 segments each; lanes
     whose vertices are not both live carry an empty segment), bit for
     bit, with K7/K8 on the batches those queries hand the fallback (at
     K = 1 where none overflows at the natural K);
   * the Metropolis slice (`capture_calls`): K3, K4 (any and closest) on
     the queries of the first bidirectional step of scenes/door.xml as it
     stands (256x256, 65,536 chains after the bootstrap, 8 edges: the
     proposal's camera query and its first three connections;
     `door_step_segments`), with K7/K8 on their fallback batches; K3/K4
     (closest) and K7 on the finite rays of three re-traces of one
     manifold proposal on glass_caustics under mlt at 256x256, maxDepth 6
     (`manifold_segments`); K1/K2 on the first closest-hit and shadow
     queries of one mlt step's path re-trace on cbox at 512x512 (131,072
     chains; `mlt_brute`); all bit for bit;
   * the photon-mapping slice: K3/K4 (closest) with K7 on the first
     closest-hit query of an sppm photon walk on glass_caustics at 256x256
     (262,144 photons; `sppm_walk_segments`) and of the volumetric photon
     mapper's walk on smoke (131,072; `pm_walk_segments`), and K1/K2 on a
     vpl pass's camera query and first VPL's shadow batch on cbox at
     512x512 (`vpl_brute`), bit for bit;
   each kernel's time beside its bound (the larger of its operations
   over the card's FP32 rate and its bytes over the memory rate, from
   this run's inputs, counting only the real triangles of padded
   tables: see `bound`);
3. render through load_scene -> pack_scene -> render on the card, each
   with the launch counters set to 0 just before the render and read just
   after, and fail unless every kernel of the path launched:
   * scenes/cbox.xml at 64x64, 16 spp, seed 0 against
     tests/golden/cbox_64_16.npy (tone-mapped RMSE < 5e-3): K1/K2;
   * scenes/matpreview.xml as it stands at 64x64, 16 spp, seed 0 against
     the reference's own tests/golden/matpreview_64_16.npy (RMSE < 5e-3):
     K1/K2, with the sphere hits counted (> 0), and the calls of the
     sobol decision draws (core/sobol.py `sobol_01_dyn`) and of the
     envmap's alias draw and lookup (emitter/eval.py `_sample_env_dir`,
     `_env_bilinear`) counted (> 0);
   * the matpreview variant at 64x64, 16 spp, seed 0 against
     tests/golden/torch_matpreview_const_64_16.npy (the JAX package's
     render; RMSE < 5e-3): K1/K2, with the sphere hits counted (> 0);
   * K11/K12, which no render path calls, through their own entry points
     (closest_hit / any_hit on pack_scene's tri_t, closest_hit_mxu /
     any_hit_mxu on build_mt_matrix's operand) on the Cornell box's
     262,144 camera rays and shadow rays from below its light to their
     hits: K11 equal to K1/K2, K12 equal to its plain version and the same
     hits as K1/K2 but on edge rays (float32 forms differ there);
   * the stand-in at 64x64, 16 spp, seed 0 against
     tests/golden/torch_bigmesh_64_16.npy (the JAX package's render,
     tests/make_torch_bigmesh_golden.py; RMSE < 5e-3): K3/K4/K7/K8.  If
     no ray overflows its cluster list, the render is repeated with K = 1
     so that the fallback K7/K8 runs;
   * the dense stand-in at 64x64, 16 spp, seed 0 against
     tests/golden/torch_densemesh_64_16.npy (RMSE < 5e-3): K5/K6/K9/K10,
     and none of K3/K4/K7/K8 (the dispatch); K = KS = 1 again if the
     fallback did not run; with its pack time and peak device memory;
   * scenes/smoke.xml at 64x64, 16 spp, seed 0 (volpath through the
     batched wavefront and its splat) against
     tests/golden/torch_smoke_64_16.npy (the JAX package's render, traced
     through its pair pipeline; RMSE < 5e-3): K3/K4 launched, the rays that
     took the K7 fallback, and the medium events and the null boundaries
     crossed by shadow rays counted (> 0);
   * scenes/cbox.xml under the mitchell filter at 64x64, 16 spp, seed 0
     against tests/golden/torch_cbox_mitchell_64_16.npy (RMSE < 5e-3):
     K1/K2 (the kernels line's launches add both renders');
   * scenes/glass_caustics.xml (bdpt, maxDepth 24 capped to 16 edges) at
     64x64, 16 spp against the reference's own
     tests/golden/glass_caustics_64_16.npy (RMSE < 5e-3), and at 16x16,
     4 spp against tests/golden/torch_glass_bdpt_16_4.npy (the JAX
     package's render through its pair pipeline): K3/K4 launched, K7/K8 on
     overflow; scenes/cbox.xml under the particle tracer at 64x64, 16
     particles per pixel against torch_cbox_ptracer_64_16.npy, and bdpt on
     tests/test_bdpt.py's spot-light and media scenes at 24x24, 16 spp
     against torch_spot_bdpt_24_16.npy and torch_media_bdpt_24_16.npy
     (these four goldens at their tests/torch_meshes.py GOLDEN_GATES,
     1e-5 to 1e-7): K1/K2 launched (K1 alone for the media scene, whose connections are
     closest-hit segments through its null sphere);
   * the Metropolis slice, each against its golden (the JAX package's
     render) at its GOLDEN_GATES gate: scenes/door.xml under pssmlt
     (bidirectional and unidirectional), mlt and erpt at 16x16 (K3/K4
     launched), scenes/cbox.xml under mlt and erpt at 24x24 (K1/K2), and
     glass_caustics under mlt with the manifold perturbation at 16x16
     (K3/K4);
   * the photon-mapping slice, each against its golden at its
     GOLDEN_GATES gate with the photons an iteration the golden was made
     with (MTS_SPPM_PHOTONS): scenes/cbox.xml under sppm and ppm at 24x24
     (K1/K2), glass_caustics under sppm at 16x16 (K3/K4), the homogeneous
     slab of tests/torch_meshes.py under the photon mapper at 32x32
     (K3/K4), cbox under vpl at 24x24 (K1/K2), 4 iterations or passes;
4. time passes of the regenerating wavefront at 512x512, 16 spp per
   pass, and report traced rays per second (closest-hit + shadow rays)
   for the Cornell box and both stand-ins (two timed passes),
   scenes/matpreview.xml (one) and the matpreview variant (one timed
   pass, no warm-up); for scenes/matpreview.xml also the tone-mapped RMSE
   of its 16-spp image
   against bench_refs/matpreview_512.npz (no gate; the reference recorded
   0.0112 at 2,048 spp), and from one more pass under torch.profiler
   (CUDA activity) its kernels per pass and per bounce (K1 launches once
   per bounce iteration) and its busy share (device time over the
   profiled pass's wall time); last, scenes/smoke.xml at the reference's
   bench resolution, 256x256, 32 spp, as one pass of 2,097,152 lanes (no
   warm-up): rays/s, peak device memory, the tone-mapped RMSE against
   bench_refs/smoke_256.npz (no gate; the reference recorded 0.0110 at
   256 spp), and from a profiled pass its device ms, events, kernels per
   event and busy share; then glass_caustics with bdpt at 16 edges at its
   bench resolution, 256x256, chunk after chunk of 131,072 lanes (2 spp)
   for about 15 s (at least 2 chunks, at most 32 spp: `generator_throughput`),
   with seconds per chunk, rays/s, peak device memory, K3/K4/K7/K8
   launches per chunk, the tone-mapped RMSE against
   bench_refs/glass_caustics_256.npz (no gate) and a profiled chunk's
   kernels and busy share; one chunk at the scene's own 512x512 (262,144
   lanes); and the particle tracer on cbox at 512x512, 4 particles per
   pixel (one batch of 1,048,576): seconds and rays/s; last the
   Metropolis slice (`generator_throughput` again): scenes/door.xml as it
   stands (pssmlt, bidirectional, 8 edges; 256x256, 65,536 chains) at
   DOOR_MUTATIONS (16) per pixel, then the same with `bidirectional` false, then
   glass_caustics under pssmlt (16 edges, 256x256) for about 8 s: the
   bootstrap's seconds, seconds per step, rays/s, kernels per step and
   busy share (one profiled step of a second run), K3/K4/K7/K8 launches per step (door's
   run is the slice's main path: its counters are set to 0 just before
   and read just after), peak device memory, and the tone-mapped RMSE
   against bench_refs/door_256.npz (the reference's TPU run at 32
   mutations per pixel: 0.0424 bidirectional, 0.0728 unidirectional) or
   bench_refs/glass_caustics_256.npz (no gate); last the photon-mapping
   slice: glass_caustics under sppm (maxDepth 24, 256x256, 2^18 photons
   an iteration) for about 8 s and smoke under the volumetric photon
   mapper (256x256, 2^17 photons) for about 5 s (`photon_throughput`:
   seconds per iteration and the eye and photon passes' means, photons
   stored, the gather's overflow share, kernels and busy share of a
   profiled iteration, peak memory, launches per iteration, RMSE against
   bench_refs), and cbox under vpl at 512x512, 4 passes of 64 VPL paths
   (seconds and K1/K2 launches per pass, RMSE against
   bench_refs/cbox_512.npz).

The hairball slice adds, in phase 2, K3/K4 (closest and any) with K7/K8
on their fallback batches, bit for bit against plain, on
scenes/hairball.xml as it stands (68,136 triangles of tessellated fibers
in 800 clusters): its 196,608 camera rays and a pass's first NEE shadow
rays, each with the share of rays that overflow K = 3 and take the
fallback (`pair_segments`); in phase 3 the hairball at 32x24 (as it
stands and with exact="true") and the BSDF galleries of
tests/torch_meshes.py `bsdf_gallery_xml` at 24x24 (glossy, thin, layered;
thin under bdpt), 4 spp, each against its golden at its GOLDEN_GATES
gate; in phase 4 the hairball as it stands at 512x384 in render's passes
of 10 spp toward its 64 (HAIRBALL_BUDGET_S bounds them: the line says how
many ran): seconds, rays/s, overflow shares and K3/K4/K7/K8 launches of
each pass (the slice's main path: counters set to 0 just before each),
peak memory, and a profiled pass's busy share, kernels and the device ms
of K3, K4 and K7/K8 by kernel name; then its exact mode (7,189 cylinder
segments) at 512x384, one pass of 4 spp: rays/s, the segment scans'
share of the pass's device-stream time (CUDA events around accel/cyl.py's
cyl_closest and cyl_any), busy share and kernels.

The texture slice adds, in phase 2, K3/K4 (closest and any) with K7/K8
on their fallback batches, bit for bit against plain, on TEXTURED
(tests/torch_meshes.py `textured_xml`, its assets written from seed 0
into build/feature_assets: 2,758 triangles in 35 clusters, a bitmap floor
with its mip maps, a bump-mapped wall, a normal-mapped sphere, vertex
colours, wireframe, curvature and irawan cloth) at 512x512: its 262,144
camera rays and a pass's first NEE shadow rays, with the overflow shares
(`pair_segments`); in phase 3 TEXTURED at 32x32 and the feature scenes
(the bitmap scene under the feline and the ewa filter, the tilted normal
map, the bump map, vertex colours, wireframe, curvature, the cloth), 4
spp, each against its golden at its GOLDEN_GATES gate; in phase 4 TEXTURED
at 512x512, 16 spp, in render's passes (`textured_throughput`: seconds,
rays/s and K3/K4/K7/K8 launches of each pass, the counters set to 0 just
before it; peak memory; a profiled pass's busy share and kernels, and
the device ms of shading_params, shading_frame, eval_texture and
mip_footprint in a 1-spp pass, profile_pass.py TEX_STAGES), then one pass
under the ewa filter, timed beside the feline pass.

The sensors, the daylight emitters and spectral mode add, in phase 1,
the numpy version beside torch's and CUDA's (spectral mode's bin tables
are host numpy); in phase 2 K1/K2 bit for bit against plain on the 2
triangles of DAYLIGHT (tests/torch_meshes.py `daylight_xml`:
scenes/matpreview.xml under a Hosek-Wilkie sunsky through a thinlens
camera) at 512x512, its 262,144 camera rays through the lens and their
first NEE shadow rays, on the spherical sensor's 131,072 camera rays
(`sensor_xml("spherical")` at 512x256) and on scenes/dispersion.xml's
65,536 camera rays and their first NEE shadow rays; in phase 3
dispersion.xml at 32x32 in RGB mode and with 9 bins, DAYLIGHT, a
Preetham sky with a separate sun and the sensor gallery (orthographic,
telecentric, spherical, thinlens, perspective_rdist), 4 spp, each against
its golden at its GOLDEN_GATES gate, and the meters (fluencemeter,
radiancemeter, irradiancemeter on a sphere and on a rectangle) against
their exact 1 and pi; in phase 4 scenes/dispersion.xml as it stands
(256x256, path at maxDepth 8) through `render` with its default device,
in RGB mode at its 256 spp and with 9 bins at DISPERSION_BINS_SPP (64)
(rays/s, peak memory, K1/K2
launches: the slice's main path, counters set to 0 just before each
render; then the seconds of each bin group and of each
apply_spectral_pack, timed here over the groups), and
DAYLIGHT at 512x512, 16 spp, in render's passes of 8 spp (seconds,
rays/s, a profiled pass's busy share and kernels).

The motion slice and the fiber media add, in phase 2, K1/K2 bit for bit
against plain on MOTION (tests/torch_meshes.py `motion_xml`: cbox with an
animated short block and a deformable card; its tri_s holds exactly its
24 static columns) at 512x512, its camera rays and their first NEE
shadow rays, and K3/K4 with K7/K8 on MOTION_BIG (`motion_big_xml`: the
69,168-triangle stand-in beside an animated cube; its clusters cover the
static prefix alone, the dummy slot stays n_tris); in phase 3 MOTION,
the deformable card, MOTION_BIG's 43 cubes, FIBER kkay and microflake
(`fiber_xml`), the fiber slab under bdpt and the photon mapper, each
against its golden at its GOLDEN_GATES gate, the motion vectors ("d" on
MOTION, "ttd" through the glass slab) within their gate's pixels (a card
gate in CARD_GOLDEN_GATES where one is set), each pixel off by more than
1e-4 rendered again on the card and on the CPU with the manifold walk's
chain traces recorded per Newton step (`walk_probes`: such a pixel must
be one whose walk lost a chain trace on the card alone), and the moving
cards' blur against their shutter coverage; in phase 4 MOTION and
MOTION_BIG at 512x512, 16 spp, and FIBER kkay and microflake at 256x256,
one 32-spp pass, through `render` (`slice_throughput`: seconds, rays/s,
peak memory, launches with the counters set to 0 just before; FIBER's
medium events; for MOTION and FIBER a profiled pass's busy share and
kernels, and in a 1-spp pass the device ms of the moving arms or of the
phase functions, `_orient_at` and the fiber arms, profile_pass.py
MOTION_STAGES and FIBER_STAGES).

The geometry extras add, in phase 2, INSTANCED (tests/torch_meshes.py
`instanced_xml`: 1,024 instances of two stand-in groups, 44,199,936
instanced triangles, through the two-level accelerator; its splice's rows
checked under 2^24, ROADMAP C7; `instanced_setup`) with K3/K4 (closest on
the camera rays; closest and any on the first NEE) and K7/K8 on their
fallback batches, bit for bit against plain, on each of the 16
template-space batches its pair path hands accel/pairs.py (4 rounds x 2
groups a query, the rays re-based into each lane's instance, t_max 0 on
the lanes of the other groups; non-finite lanes left out), the instance
lists' and K3's overflow shares, and K1/K2 on its 4 static rows
(`instanced_segments`); in phase 3 the instancing scene copied into rows,
through the pair path and through the loop path, the two-group scene, the
shapes gallery (disk, obj, serialized, heightfield) and the BVH walk past
a lowered cluster budget, each against its golden at its GOLDEN_GATES
gate (`extras_goldens`), and the pair path against the loop path on
INSTANCED's camera rays and NEE, each timed, where every disagreement
must be a tie or a hit on a triangle's edge in float64
(`instanced_pair_vs_loop`); in phase 4 INSTANCED through `render` at
512x512, one pass of INSTANCED_SPP (seconds, rays/s, peak memory,
launches with the counters set to 0 just before it, the instance
lists' overflow; `instanced_throughput`) and BIGBVH (`bigbvh_xml`: four
dense stand-ins, 3,481,920 triangles, no cluster tables): one intersect
of its camera rays with sort=True beside sort=False (equal) and one
256x256, BIGBVH_SPP (1) pass through `render` (`bigbvh_throughput`).

5. the host side (`host_phase`): `python -m mitsuba_tpu_torch
   scenes/cbox.xml -s 64 -o build/host/cbox.exr` as a subprocess at the
   scene's own 512x512, its EXR read back equal to render's image in
   process after half rounding (its Msamples/s line printed); that
   render stopped through `progress` after pass 4 of 8 and resumed from
   its checkpoint, equal to the uninterrupted render; cbox under mitchell
   through `tiledhdrfilm` at 1 << 17 lanes a pass (3 row bands), 8 spp,
   against `hdrfilm` at rtol 1e-4, with each one's seconds and peak memory;
   scenes/smoke.xml at 28 spp at 1 << 21 and at 1 << 18 lanes a pass
   (one pass, four), agreeing at rtol 1e-4, the smaller taking less
   memory; `python -m mitsuba_tpu_torch.tools kdbench` on the stand-in's
   scene (10M random rays, best of 3, then --coherent) with its MRays/s
   and its kernels' launches; the cbox and stand-in packs saved to
   .mtspack files, loaded onto the card and rendered equal to the fresh
   packs.  The launches of its renders and of kdbench's timed calls count
   in the kernels line.
6. the parallel slice (`parallel_phase`): an NCCL world of one (a file
   store): `render_sharded` of cbox at 512x512, 16 spp against render's
   image, with K1/K2 bit for bit against plain on the sharded pass's
   camera and NEE rays; the 69k stand-in at 256x256, 4 spp through
   K3/K4/K7/K8 (bit for bit on the sharded pass's queries); bdpt, sppm,
   ptracer, vpl and pssmlt against their unsharded renders at the CPU
   tests' gates; two spawned ranks on cuda:0 over gloo against the world
   of one (rel RMSE 1e-4) with both rays/s; the elastic pass loop
   re-queueing passes 2..7 after a fault at pass 3 of 8, bit for bit; the
   render service with one of two workers killed, its film bit for bit
   the local pass loop's; `python -m mitsuba_tpu_torch.parallel.multihost
   --num-hosts 1`, its EXR equal to render_to_file's; `entry()` on the
   card.  Each part's seconds are printed, every child process has a time
   limit, and the launches of its renders count in the kernels line.

The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.  Nothing of JAX is imported.
"""

import concurrent.futures
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CBOX = os.path.join(HERE, "scenes", "cbox.xml")
GOLDEN = os.path.join(HERE, "tests", "golden", "cbox_64_16.npy")
BIGMESH_GOLDEN = os.path.join(HERE, "tests", "golden", "torch_bigmesh_64_16.npy")
DENSE_GOLDEN = os.path.join(HERE, "tests", "golden", "torch_densemesh_64_16.npy")
MATPREVIEW_GOLDEN = os.path.join(HERE, "tests", "golden", "torch_matpreview_const_64_16.npy")
MATPREVIEW_XML = os.path.join(HERE, "scenes", "matpreview.xml")
MATPREVIEW_REF_GOLDEN = os.path.join(HERE, "tests", "golden", "matpreview_64_16.npy")
MATPREVIEW_REF_512 = os.path.join(HERE, "bench_refs", "matpreview_512.npz")
SMOKE_GOLDEN = os.path.join(HERE, "tests", "golden", "torch_smoke_64_16.npy")
SMOKE_REF_256 = os.path.join(HERE, "bench_refs", "smoke_256.npz")
GLASS_REF_256 = os.path.join(HERE, "bench_refs", "glass_caustics_256.npz")
DOOR_REF_256 = os.path.join(HERE, "bench_refs", "door_256.npz")
CBOX_REF_512 = os.path.join(HERE, "bench_refs", "cbox_512.npz")
GLASS_GOLDEN = os.path.join(HERE, "tests", "golden", "glass_caustics_64_16.npy")
GLASS_PAIR_GOLDEN = os.path.join(HERE, "tests", "golden", "torch_glass_bdpt_16_4.npy")
PTRACER_GOLDEN = os.path.join(HERE, "tests", "golden", "torch_cbox_ptracer_64_16.npy")
SPOT_GOLDEN = os.path.join(HERE, "tests", "golden", "torch_spot_bdpt_24_16.npy")
MEDIA_GOLDEN = os.path.join(HERE, "tests", "golden", "torch_media_bdpt_24_16.npy")
MITCHELL_GOLDEN = os.path.join(HERE, "tests", "golden", "torch_cbox_mitchell_64_16.npy")
HAIRBALL_XML = os.path.join(HERE, "scenes", "hairball.xml")
# the tessellated hairball's timed passes stop once this much has passed
HAIRBALL_BUDGET_S = 60.0
# samples per pixel of the exact hairball's pass (one pass)
HAIRBALL_EXACT_SPP = 4
# the pair pipeline's kernels by the name of their CUDA function
# (csrc/cluster_hit.cu)
PAIR_KERNELS = {"K3": "dense_cull_kernel", "K4": "pair_kernel", "K7/K8": "resident_walk_kernel"}
STANDIN_PLY = os.path.join(HERE, "build", "bunny_standin.ply")
DENSE_PLY = os.path.join(HERE, "build", "dense_standin.ply")
SOURCES = {"brute_tiled": "mitsuba_tpu_torch/csrc/brute_tiled.cu",
           "cluster_hit": "mitsuba_tpu_torch/csrc/cluster_hit.cu",
           "cluster_stream": "mitsuba_tpu_torch/csrc/cluster_stream.cu"}
# (wrapper, kernel source, TPU kernel replaced)
KERNELS = (
    ("closest_hit_v2", "brute_tiled", "mitsuba_tpu/accel/pallas_kernels.py:434"),
    ("any_hit_v2", "brute_tiled", "mitsuba_tpu/accel/pallas_kernels.py:445"),
    ("dense_cull", "cluster_hit", "mitsuba_tpu/accel/pairs.py:196"),
    ("pair_hit_closest", "cluster_hit", "mitsuba_tpu/accel/pairs.py:821"),
    ("pair_hit_any", "cluster_hit", "mitsuba_tpu/accel/pairs.py:821"),
    ("cluster_traverse_closest", "cluster_hit", "mitsuba_tpu/accel/pallas_bvh.py:122"),
    ("cluster_traverse_any", "cluster_hit", "mitsuba_tpu/accel/pallas_bvh.py:189"),
    ("two_level_cull", "cluster_stream", "mitsuba_tpu/accel/pairs.py:310"),
    ("window_hit_closest", "cluster_stream", "mitsuba_tpu/accel/pairs.py:666"),
    ("window_hit_any", "cluster_stream", "mitsuba_tpu/accel/pairs.py:666"),
    ("cluster_stream_closest", "cluster_stream", "mitsuba_tpu/accel/pallas_bvh.py:222"),
    ("cluster_stream_any", "cluster_stream", "mitsuba_tpu/accel/pallas_bvh.py:333"),
    ("closest_hit", "brute_tiled", "mitsuba_tpu/accel/pallas_kernels.py:60"),
    ("any_hit", "brute_tiled", "mitsuba_tpu/accel/pallas_kernels.py:91"),
    ("closest_hit_mxu", "brute_tiled", "mitsuba_tpu/accel/pallas_kernels.py:272"),
    ("any_hit_mxu", "brute_tiled", "mitsuba_tpu/accel/pallas_kernels.py:290"),
)
# each brute-force wrapper: (its plain version, closest or any)
BRUTE = {"closest_hit_v2": ("closest_hit_plain", True), "any_hit_v2": ("any_hit_plain", False),
         "closest_hit": ("closest_hit_v1_plain", True), "any_hit": ("any_hit_v1_plain", False),
         "closest_hit_mxu": ("closest_hit_mxu_plain", True),
         "any_hit_mxu": ("any_hit_mxu_plain", False)}
# The fallback kernels before the warp-per-ray walk (one thread per ray, a
# full box rescan per visit; NVIDIA H100 80GB HBM3, 700 W; the bracketed
# times of PERF.md's kernel table): K9/K10 on the 16,384-ray camera subset
# of the dense stand-in, K7/K8 on the 69k stand-in's 262,144 camera rays
RESCAN_MS = {"cluster_stream_closest": 17.45, "cluster_stream_any": 12.99,
             "cluster_traverse_closest": 2.405, "cluster_traverse_any": 1.865}
# K7/K8's full-rescan kernels per launch in a profiled 512x512, 16-spp pass
# of the 69k stand-in (profile_pass.py bigmesh: 51.5 ms over 40 launches,
# 53.2 ms over 32; same card)
RESCAN_PASS_MS = {"cluster_traverse_closest": 1.29, "cluster_traverse_any": 1.66}
# The kernels before their redesign on their stand-in's 262,144 camera rays
# (same card and timing; PERF.md's kernel table): K5/K6 (a full super scan;
# 8-tile stages of whole Tc-column tiles, one block per 256-pair window) on
# the dense stand-in, K3/K4 (every cluster box slab-tested; one thread per
# (ray, slot) over all Tc columns of cl_tri) on the 69k stand-in; on cbox's
# camera rays K1/K2 (PR 7's table: K11's one-thread-per-ray kernel on
# tri_s), and K11/K12 before this design (one thread per ray over every
# column of tri_t and mt, the features formed by a dozen PyTorch launches;
# time_brute.py on the parent tree, NVIDIA H100 80GB HBM3, 700 W)
FORMER_MS = {"two_level_cull": 0.4622, "window_hit_closest": 0.4286, "window_hit_any": 0.4224,
             "dense_cull": 0.3875, "pair_hit_closest": 0.2915, "pair_hit_any": 0.2716,
             "closest_hit_v2": 0.0692, "any_hit_v2": 0.0843,
             "closest_hit": 0.1384, "any_hit": 0.1219,
             "closest_hit_mxu": 0.3505, "any_hit_mxu": 0.4011}
# a sleep of ~1 ms on an H100: longer than any wrapper's host work
HIDE_HOST_CYCLES = 2_000_000
THROUGHPUT_SPP_CHUNK = 16
THROUGHPUT_PASSES = 2
# scenes/smoke.xml at the reference's bench resolution, as one pass of
# 256 x 256 x 32 = 2,097,152 lanes of the batched wavefront
SMOKE_RES, SMOKE_SPP = 256, 32
N_RAYS = 262_144
N_STREAM_SUBSET = 16_384  # rays of the K9/K10 vs plain comparison
# the card's published peaks (H100 SXM, NVIDIA's data sheet): FP32 outside
# the tensor cores, and HBM3
PEAK_FP32_OPS = 67e12
# the FP32 rate without FMA (one operation per lane per cycle): the kernels
# are built with -fmad=false
PEAK_FP32_NOFMA = PEAK_FP32_OPS / 2
PEAK_BYTES = 3.35e12
# FP32 operations of one test, counted from the kernels' expressions
# (csrc/ray_tri.cuh, csrc/brute_tiled.cu) at the least the function needs:
# Moller-Trumbore 53, a slab test 25, the bilinear Moller-Trumbore 46 (its
# four dots on the nonzero rows of build_mt_matrix's operand: det 3
# products, u and v 6 each, t 4, with their sums, 34; the epilogue 12, as
# in Moller-Trumbore), which is what K12's kernel sums on a column that
# pk.mxu_flags leaves clear.
MT_OPS = 53
SLAB_OPS = 25
MXU_OPS = 46
# padding columns of the triangle tables hold the far triangle (v0 = 1e30),
# which no ray hits: the bounds count only the triangles below this
FAR_V0 = 1e29


T_START = time.time()


def elapsed():
    return f"[{time.time() - T_START:.1f} s]"


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, reps=20, card_only=False):
    """Median time of fn() in ms between CUDA events, after a warm-up: the
    host's launch work (the wrapper's checks, allocations and ctypes call)
    lies between the events.  With card_only a sleep kernel is queued ahead
    of the start event, so that the host's work happens while the card is
    busy and the events time the card's work alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if card_only:
            torch.cuda._sleep(HIDE_HOST_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ulp_diff_max(a, b):
    """Largest distance in units of the last place between float32
    tensors of equal sign (0 when equal)."""
    import torch

    check(bool(((a >= 0) == (b >= 0)).all()), "t changes sign between kernel and plain")
    ia = a.view(torch.int32).to(torch.int64)
    ib = b.view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max()) if a.numel() else 0


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops, n_bytes):
    """(least ms, what bounds it): the larger of the operations over the
    FP32 rate and the bytes (inputs read once, outputs written once) over
    the memory rate."""
    t_ops, t_bytes = ops / PEAK_FP32_OPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def record(stats, name, shape, err, kern, plain, ops, n_bytes, extra="", plain_reps=20):
    ms, plain_ms = time_ms(kern), time_ms(plain, plain_reps)
    card_ms = time_ms(kern, card_only=True)
    bound_ms, bound_by = bound(ops, n_bytes)
    stats.append({"name": name, "shape": shape, "max_abs_err": err, "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by})
    print(f"  {name:24s} {shape:28s} max|err|={err:g} kernel {ms:.4f} ms (card alone "
          f"{card_ms:.4f}), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) {extra}",
          flush=True)


def check_hits(name, kernel_out, plain_out):
    """(t, prim, ...) of a kernel and its plain version: prim equal, t
    within 1 ulp; returns max |t err| over hits and the hit share."""
    import torch

    t1, p1, t2, p2 = kernel_out[0], kernel_out[1], plain_out[0], plain_out[1]
    torch.cuda.synchronize()
    check(torch.equal(p1, p2), f"{name}: prim differs on {int((p1 != p2).sum())} rays")
    ulps = ulp_diff_max(t1, t2)
    check(ulps <= 1, f"{name}: t differs by {ulps} ulp")
    for a, b in zip(kernel_out[2:], plain_out[2:]):
        check(torch.equal(a, b), f"{name}: u/v differ")
    hit = p1 >= 0  # t_max on a miss, which may be inf
    err = float((t1[hit] - t2[hit]).abs().max()) if bool(hit.any()) else 0.0
    return err, float(hit.float().mean())


def compare_brute(pk, name, o, d, t_max, tri, n_tri, stats, exact=False):
    """A brute-force kernel (K1, K2, K11 or K12) against its plain version
    at one shape; tri: its triangle operand, n_tri: the real triangles in
    it.  exact: every output equal, bit for bit (else t within 1 ulp)."""
    import torch

    plain_name, closest = BRUTE[name]
    kern_fn, plain_fn = getattr(pk, name), getattr(pk, plain_name)
    r, tp = o.shape[0], tri.shape[1] // (4 if "mxu" in name else 1)
    shape = f"rays={r} Tp={tp}"
    kern = lambda: kern_fn(o, d, t_max, tri)  # noqa: E731
    plain = lambda: plain_fn(o, d, t_max, tri)  # noqa: E731
    out = kern()
    if exact:
        ref = plain()
        for a, b in zip(out if closest else (out,), ref if closest else (ref,)):
            check(torch.equal(a, b), f"{name}: differs from plain on {int((a != b).sum())} rays")
    if closest:
        err, frac = check_hits(name, out, plain())
        tests = r * n_tri  # every triangle, to prove none is nearer
    else:
        ref = plain()
        check(torch.equal(out, ref), f"{name}: occlusion differs on {int((out != ref).sum())} rays")
        err, frac = 0.0, float(out.float().mean())
        n_occ = int(out.sum())  # an occluded ray needs one test at least
        tests = (r - n_occ) * n_tri + n_occ
        out = (out,)
    ops = tests * (MXU_OPS if "mxu" in name else MT_OPS)
    record(stats, name, shape, err, kern, plain, ops, nbytes(o, d, t_max, tri, *out),
           f"{'hit' if closest else 'occluded'}={frac:.3f}")


def brute_all(pk, o, d, t_any, tri_s, tri_t, mt, n_tri, stats, camera):
    """K1/K2, K11 and K12 against their plain versions on one ray set:
    the closest hits with t_max 1e30 (K1, as the renderer calls it) or inf
    (K11, K12), the occlusion kernels with t_any; beside each, what its
    kernel tests (brute_beside)."""
    import torch

    r = o.shape[0]
    t_far = torch.full((r,), 1e30, device=o.device)
    t_inf = torch.full((r,), float("inf"), device=o.device)
    for name, tri, tm in (("closest_hit_v2", tri_s, t_far), ("any_hit_v2", tri_s, t_any),
                          ("closest_hit", tri_t, t_inf), ("any_hit", tri_t, t_any),
                          ("closest_hit_mxu", mt, t_inf), ("any_hit_mxu", mt, t_any)):
        compare_brute(pk, name, o, d, tm, tri, n_tri, stats)
        brute_beside(pk, stats[-1], o, d, tm, tri, camera)


def brute_tests(pk, name, o, d, t_max, tri):
    """(live columns, tests) of a brute-force kernel on these rays: every
    ray that can hit tests the live columns in order (pk.live_columns, or
    pk.mxu_live_columns for K12), the closest hit all of them, an
    occlusion ray up to its first hit; a ray that cannot hit tests none
    (K12: pk.mxu_can_hit; K1/K2/K11: o and d finite, t_max > RAY_EPS)."""
    import torch

    mxu = "mxu" in name
    cols = pk.mxu_live_columns(tri) if mxu else pk.live_columns(tri)
    n = cols.numel()
    if mxu:
        can = pk.mxu_can_hit(o, d, t_max)
        m = tri[:, torch.cat([cols + b * (tri.shape[1] // 4) for b in range(4)])]
    else:
        can = (torch.isfinite(o).all(dim=1) & torch.isfinite(d).all(dim=1)
               & (t_max > pk.RAY_EPS))
    if BRUTE[name][1]:
        return n, int(can.sum()) * n
    tests = 0
    for a in range(0, o.shape[0], 1 << 16):
        b = a + (1 << 16)
        if mxu:
            _, hit = pk._mxu_hits(pk.ray_features(o[a:b], d[a:b]), m, t_max[a:b])
        else:
            _, hit = pk._mt_hit(o[a:b], d[a:b], tri[:, cols], t_max[a:b])
        first = hit.to(torch.uint8).argmax(dim=1) + 1  # the first maximum
        tests += int(torch.where(can[a:b], torch.where(hit.any(dim=1), first, n), 0).sum())
    return n, tests


def brute_beside(pk, s, o, d, t_max, tri, camera):
    """Beside a brute-force kernel's record s: the columns its kernel tests
    and their tests per ray, for K12 also the flagged columns, the bound
    of those tests at one FP32 operation per lane per cycle (no FMA runs),
    and on camera rays the former design's time."""
    name, r = s["name"], o.shape[0]
    n_live, tests = brute_tests(pk, name, o, d, t_max, tri)
    mxu = "mxu" in name
    ops = MXU_OPS if mxu else MT_OPS
    design_ms = tests * ops / PEAK_FP32_NOFMA * 1e3
    tp = tri.shape[1] // (4 if mxu else 1)
    flags = f", flagged {int(pk.mxu_flags(tri).sum())}" if mxu else ""
    print(f"  {name:24s} {s['shape']:28s} live columns {n_live} of {tp}{flags}, tests per ray "
          f"{tests / r:.3f}: this design's bound {design_ms:.4f} ms ({ops} operations per "
          f"test at {PEAK_FP32_NOFMA:.3g}/s){former(name, camera)}", flush=True)


def launch_cost(pk, native, dev, tri_s, tri_t, mt, calls=2000):
    """Host time per call (perf_counter over `calls` calls, after a
    warm-up) of native.launch on K1's entry point with R = 0 (nothing is
    launched) and R = 1, and of the six brute-force wrappers at R = 1."""
    import torch

    o = torch.zeros((1, 3), device=dev)
    d = torch.ones((1, 3), device=dev)
    tm = torch.ones(1, device=dev)
    t_out = torch.empty(1, device=dev)
    prim = torch.empty(1, dtype=torch.int32, device=dev)

    def host_us(fn):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / calls * 1e6

    us = {}
    for r in (0, 1):
        us[f"native.launch R={r}"] = host_us(lambda: native.launch(
            pk._lib, "mts_closest_hit_v2", dev, o, d, tm, tri_s, r, tri_s.shape[1], t_out, prim))
    for name, tri in (("closest_hit_v2", tri_s), ("any_hit_v2", tri_s), ("closest_hit", tri_t),
                      ("any_hit", tri_t), ("closest_hit_mxu", mt), ("any_hit_mxu", mt)):
        fn = getattr(pk, name)
        us[name] = host_us(lambda: fn(o, d, tm, tri))
    print("  host us per call: " + ", ".join(f"{k} {v:.2f}" for k, v in us.items()), flush=True)
    return us


def brute_entry_points(pk, pack, o, d):
    """K11/K12 through their entry points on pack_scene's tri_t and
    build_mt_matrix's operand, on the camera rays o, d and on shadow rays
    from a point one unit below the centroid of the emitting triangles to
    the camera rays' first hits (stopping 0.1 % short): K11 equal to K1/K2,
    K12 equal to its plain version and the same hits as K1/K2 but on edge
    rays.  (A ray that starts on a surface
    is no test of K12: its bilinear t cancels to ~1e-4 at cbox's 550-unit
    coordinates, about RAY_EPS.)  Returns the four launch counts."""
    import torch

    names = ("closest_hit", "any_hit", "closest_hit_mxu", "any_hit_mxu")
    n = int((pack.tri_t[0] < FAR_V0).sum())
    tris = [pack.arrays[k][:n].cpu().numpy() for k in ("tri_v0", "tri_e1", "tri_e2")]
    mt = torch.as_tensor(pk.build_mt_matrix(*tris, n), device=o.device)
    emit = pack.tri_emit[:n] >= 0
    light = (pack.tri_v0[:n][emit] + (pack.tri_e1[:n][emit] + pack.tri_e2[:n][emit]) / 3).mean(0)
    light = light - torch.tensor([0.0, 1.0, 0.0], device=o.device)
    inf = float("inf")
    for k in names:
        getattr(pk, k).launches = 0
    t1, p1 = pk.closest_hit_v2(o, d, 1e30, pack.tri_s)
    t11, p11 = pk.closest_hit(o, d, inf, pack.tri_t)
    t12, p12 = pk.closest_hit_mxu(o, d, inf, mt)
    hit = p1 >= 0
    to_hit = (o + torch.where(hit, t1, 0.0)[:, None] * d)[hit] - light
    dist = torch.linalg.norm(to_hit, dim=1)
    o_s = light.expand(to_hit.shape[0], 3).contiguous()
    d_s, t_s = (to_hit / dist[:, None]).contiguous(), dist * 0.999
    a2 = pk.any_hit_v2(o_s, d_s, t_s, pack.tri_s)
    a11 = pk.any_hit(o_s, d_s, t_s, pack.tri_t)
    a12 = pk.any_hit_mxu(o_s, d_s, t_s, mt)
    launches = {k: getattr(pk, k).launches for k in names}
    torch.cuda.synchronize()
    check(torch.equal(p11, p1) and torch.equal(t11[hit], t1[hit]) and bool(torch.isinf(t11[~hit]).all()),
          "closest_hit (K11) differs from closest_hit_v2 (K1) on the camera rays")
    check(torch.equal(a11, a2), "any_hit (K11) differs from any_hit_v2 (K2) on the shadow rays")
    t12p, p12p = pk.closest_hit_mxu_plain(o, d, torch.full_like(t1, inf), mt)
    check(torch.equal(p12, p12p) and torch.equal(t12, t12p),
          "closest_hit_mxu (K12) differs from its plain version on the camera rays")
    check(torch.equal(a12, pk.any_hit_mxu_plain(o_s, d_s, t_s, mt)),
          "any_hit_mxu (K12) differs from its plain version on the shadow rays")
    both = hit & (p12 == p1)
    n_prim, n_occ = int((p12 != p1).sum()), int((a12 != a2).sum())
    rel = float(((t12[both] - t1[both]).abs() / t1[both]).max()) if bool(both.any()) else 0.0
    print(f"phase 3: K11/K12 entry points on cbox's {o.shape[0]} camera rays and "
          f"{o_s.shape[0]} shadow rays: K11 equal to K1/K2, K12 equal to its plain version; "
          f"K12 against K1/K2: prim differs on {n_prim} rays, "
          f"occlusion on {n_occ}, max rel t diff where prims agree {rel:.3g}; "
          f"launches {launches}", flush=True)
    check(n_prim <= o.shape[0] // 1000 and n_occ <= o_s.shape[0] // 1000 and rel < 1e-4,
          "closest_hit_mxu / any_hit_mxu (K12) disagree with K1/K2 beyond edge rays")
    return launches


def cluster_sizes(pack):
    """[C] i64: the real triangles of each cluster's Tc slots."""
    tc = pack.meta["cluster_tc"]
    return (pack.cl_tri[0] < FAR_V0).reshape(-1, tc).sum(1)


def pair_tests(cids, sizes, occ=None):
    """Moller-Trumbore tests the (ray, slot) pairs need at least: a
    closest-hit pair tests its cluster's real triangles; an occluded pair
    one."""
    import torch

    c = sizes.numel()
    valid = cids < c
    n = torch.where(valid, sizes[cids.clamp(max=c - 1).long()], 0)
    if occ is not None:
        n = torch.where(valid & occ, 1, n)
    return int(n.sum())


def walk_ops(r, sizes, tc, slot=None, occ=None):
    """Operations a per-ray cluster walk needs at least: closest, every
    ray slab-tests every cluster and a ray with a hit tests its cluster's
    real triangles; any, an unoccluded ray slab-tests every cluster and an
    occluded one tests a box and a triangle."""
    c = sizes.numel()
    if occ is None:
        hit = slot >= 0
        return r * c * SLAB_OPS + int(sizes[(slot[hit] // tc).long()].sum()) * MT_OPS
    n_occ = int(occ.sum())
    return (r - n_occ) * c * SLAB_OPS + n_occ * (SLAB_OPS + MT_OPS)


def compare_walks(pb, label, closest, stream, args, sizes, stats, plain_reps=20):
    """K7/K8 (stream False) or K9/K10 against the plain walk on args =
    (o, d, t_max, cl_box, cl_tri, tc); sizes: cluster_sizes.  On camera
    rays, K7/K8's full-rescan times are printed beside."""
    import torch

    c, tc = sizes.numel(), args[5]
    kind = "closest" if closest else "any"
    name = f"cluster_{'stream' if stream else 'traverse'}_{kind}"
    kern, plain = getattr(pb, name), getattr(pb, f"{name}_plain")
    r = args[0].shape[0]
    shape = f"{label} rays={r} C={c}"
    out = kern(*args)
    if closest:
        err, frac = check_hits(name, out, plain(*args))
        ops = walk_ops(r, sizes, tc, slot=out[1])
    else:
        ref = plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"{name}: occlusion differs")
        err, frac = 0.0, float(out.float().mean())
        ops = walk_ops(r, sizes, tc, occ=out)
    outs = out if closest else (out,)
    extra = f"{'hit' if closest else 'occluded'}={frac:.3f}"
    if not stream and label == "camera":
        extra += f" (full-rescan kernel {RESCAN_MS[name]} ms)"
    record(stats, name, shape, err, lambda: kern(*args), lambda: plain(*args), ops,
           nbytes(*args[:5], *outs), extra, plain_reps=plain_reps)


def compare_cluster(pairs, pb, label, pack, o, d, t_any, stats):
    """K3, K4 (closest, any), K7 and K8 against their plain versions on
    one ray set: t_max = BIG for the closest-hit kernels, t_any for the
    occlusion kernels.  Beside K3 its group and member slab tests per ray;
    beside K4 the columns it tests per pair and K6 on the same lists (the
    pair queue's sort included)."""
    import torch

    c, tc = pack.meta["n_clusters"], pack.meta["cluster_tc"]
    sizes = cluster_sizes(pack)
    kk = min(pairs.K, c)
    r = o.shape[0]
    t_big = torch.full((r,), pairs.BIG, device=o.device)
    tri, box, mbox, p2p = pack.cl_tri, pack.cl_box, pack.cl_mbox, pack.cl_pad2prim
    tabs = (pack.cl_cnt, pairs._tri_rows(pack))  # K4's own inputs beside the plain version's
    shape = f"{label} rays={r} C={c}"

    k3 = pairs.dense_cull(o, d, t_big, mbox, c, kk)
    p3 = pairs.dense_cull_plain(o, d, t_big, mbox, c, kk)
    torch.cuda.synchronize()
    for a, b, what in zip(k3, p3, ("cid", "entry", "n_cl", "kept_max")):
        check(torch.equal(a, b), f"dense_cull: {what} differs on {int((a != b).sum())} values")
    cids = k3[0]
    n_cl = k3[2].float()
    boxes = mbox.reshape(-1, 6)[:c].T  # [6, c]
    n_grp, n_mem = cull_group_tests(pairs, o, d, t_big, boxes, c, pb.kernel_limits()[2])
    design_ms, _ = bound((r * n_grp + n_mem) * SLAB_OPS, 0)
    record(stats, "dense_cull", shape, 0.0,
           lambda: pairs.dense_cull(o, d, t_big, mbox, c, kk),
           lambda: pairs.dense_cull_plain(o, d, t_big, mbox, c, kk),
           r * c * SLAB_OPS, nbytes(o, d, t_big, mbox.reshape(-1, 6)[:c], *k3),
           f"clusters hit/ray={float(n_cl.mean()):.3f}; slab tests/ray: groups {n_grp}, "
           f"members {n_mem / r:.3f} (of {c}); bound of this work {design_ms:.4f} ms"
           f"{former('dense_cull', label == 'camera')}")

    valid = cids < c
    cols = pack.cl_cnt[cids[valid].long()]
    print(f"  K4 lists {shape}: {int(valid.sum())} of {cids.numel()} slots hold a cluster; "
          f"columns tested per pair {float(cols.float().mean()):.3f} (cl_cnt), real triangles "
          f"{float(sizes[cids[valid].long()].float().mean()):.3f}, Tc {tc}", flush=True)
    design_ms, _ = bound(int(cols.sum()) * MT_OPS, 0)
    args = (o, d, t_big, cids, tri, p2p, c, tc)
    out = pairs.pair_hit_closest(*args, *tabs)
    err, frac = check_hits("pair_hit_closest", out, pairs.pair_hit_closest_plain(*args))
    record(stats, "pair_hit_closest", shape, err,
           lambda: pairs.pair_hit_closest(*args, *tabs),
           lambda: pairs.pair_hit_closest_plain(*args),
           pair_tests(cids, sizes) * MT_OPS, nbytes(o, d, t_big, cids, tri, p2p, *out),
           f"slot hit={frac:.3f}; bound of the cl_cnt columns {design_ms:.4f} ms"
           f"{former('pair_hit_closest', label == 'camera')}")
    k6_beside_k4(pairs, "window_hit_closest", out, (o, d, t_big), cids,
                 (tri, p2p, c, tc, *tabs), shape)
    overflow_share(pairs, pack, o, d, t_big, label)

    args_any = (o, d, t_any, cids, tri, c, tc)
    k4a = pairs.pair_hit_any(*args_any, *tabs)
    p4a = pairs.pair_hit_any_plain(*args_any)
    torch.cuda.synchronize()
    check(torch.equal(k4a, p4a), "pair_hit_any: occlusion differs")
    record(stats, "pair_hit_any", shape, 0.0,
           lambda: pairs.pair_hit_any(*args_any, *tabs),
           lambda: pairs.pair_hit_any_plain(*args_any),
           pair_tests(cids, sizes, k4a) * MT_OPS, nbytes(o, d, t_any, cids, tri, k4a),
           f"occluded={float(k4a.float().mean()):.3f}{former('pair_hit_any', label == 'camera')}")
    k6_beside_k4(pairs, "window_hit_any", (k4a,), (o, d, t_any), cids, (tri, c, tc, *tabs), shape)

    compare_walks(pb, label, True, False, (o, d, t_big, box, tri, tc), sizes, stats)
    compare_walks(pb, label, False, False, (o, d, t_any, box, tri, tc), sizes, stats)
    for closest, tm in ((True, t_big), (False, t_any)):
        fallback_walks(pairs, pb, label, pack, o, d, tm, closest)


def k6_beside_k4(pairs, name, k4_out, rays, cids, tabs, shape):
    """K6 (the window kernel over the cluster-sorted pair queue) on K4's
    lists: the same per-slot results, timed with the queue's sort
    (pair_queue) inside, to weigh the K4/K6 dispatch on this mesh."""
    import torch

    fn = getattr(pairs, name)
    kk = cids.shape[1]

    def run():
        return fn(*rays, *pairs.pair_queue(cids), kk, *tabs)

    out = run()
    out = out if isinstance(out, tuple) else (out,)
    torch.cuda.synchronize()
    for a, b in zip(out, k4_out):
        check(torch.equal(a, b), f"{name} differs from K4 on the same lists")
    print(f"  {name + ' (K6)':24s} {shape:28s} on K4's lists, sort included: kernel "
          f"{time_ms(run):.4f} ms (card alone {time_ms(run, card_only=True):.4f})", flush=True)


def overflow_share(pairs, pack, o, d, t_big, label):
    """The share of rays whose cluster lists overflow in pair_closest."""
    pairs.pair_closest.rays = pairs.pair_closest.overflow_rays = 0
    pairs.pair_closest(pack, o, d, t_big)
    n_ov, n = pairs.pair_closest.overflow_rays, pairs.pair_closest.rays
    print(f"  natural overflow ({label}, K={pairs.K}, KS={pairs.KS}): {n_ov} of {n} rays "
          f"({n_ov / n:.4%})", flush=True)


def compare_dense(pairs, pb, label, pack, o, d, t_any, stats, rng):
    """K5, K6 (closest, any), K9 and K10 against their plain versions on
    one ray set of the dense stand-in; K9/K10 on a seeded subset, and
    timed on all rays too."""
    import numpy as np
    import torch

    m = pack.meta
    c, tc, s, g = m["n_clusters"], m["cluster_tc"], m["n_supers"], m["cluster_super_g"]
    ks = min(pairs.KS, s)
    kk = min(pairs.K, ks * g)
    r = o.shape[0]
    t_big = torch.full((r,), pairs.BIG, device=o.device)
    tri, box, sup, mbox, p2p = pack.cl_tri, pack.cl_box, pack.cl_sup, pack.cl_mbox, pack.cl_pad2prim
    sizes = cluster_sizes(pack)
    cnt = pack.cl_cnt
    k6_tabs = (cnt, pairs._tri_rows(pack))  # K6's own inputs beside the plain version's
    shape = f"{label} rays={r} C={c}"
    camera = label == "camera"

    cull_args = (o, d, t_big, sup, mbox, s, c, ks, kk)
    k5 = pairs.two_level_cull(*cull_args)
    p5 = pairs.two_level_cull_plain(*cull_args)
    torch.cuda.synchronize()
    for a, b, what in zip(k5, p5, ("cid", "entry", "n_sup", "kept_max_sup", "n_cl", "kept_max_cl")):
        check(torch.equal(a, b), f"two_level_cull: {what} differs on {int((a != b).sum())} values")
    cids, n_sup = k5[0], k5[2]
    members = int(torch.clamp(n_sup, max=ks).sum()) * g
    n_grp, n_sup_tests = cull_group_tests(pairs, o, d, t_big, sup, s, pb.stream_limits()[3])
    design_ms, _ = bound((r * n_grp + n_sup_tests + members) * SLAB_OPS, 0)
    record(stats, "two_level_cull", shape, 0.0,
           lambda: pairs.two_level_cull(*cull_args), lambda: pairs.two_level_cull_plain(*cull_args),
           (r * s + members) * SLAB_OPS, nbytes(o, d, t_big, sup, mbox, *k5),
           f"supers hit/ray={float(n_sup.float().mean()):.3f} "
           f"clusters hit/ray={float(k5[4].float().mean()):.3f}; slab tests/ray: groups {n_grp}, "
           f"supers {n_sup_tests / r:.3f} (of {s}), members {members / r:.3f}; bound of this work "
           f"{design_ms:.4f} ms{former('two_level_cull', camera)}")

    queue = pairs.pair_queue(cids)
    valid = queue[0] < c
    cols = cnt[queue[0][valid].long()]
    print(f"  pair queue {shape}: {int(valid.sum())} of {queue[0].numel()} slots hold a cluster; "
          f"columns tested per pair {float(cols.float().mean()):.3f} (cl_cnt), real triangles "
          f"{float(sizes[queue[0][valid].long()].float().mean()):.3f}, Tc {tc}", flush=True)
    args = (o, d, t_big, *queue, kk, tri, p2p, c, tc)
    out = pairs.window_hit_closest(*args, *k6_tabs)
    err, frac = check_hits("window_hit_closest", out, pairs.window_hit_closest_plain(*args))
    design_ms, _ = bound(int(cols.sum()) * MT_OPS, 0)
    record(stats, "window_hit_closest", shape, err,
           lambda: pairs.window_hit_closest(*args, *k6_tabs), lambda: pairs.window_hit_closest_plain(*args),
           pair_tests(cids, sizes) * MT_OPS, nbytes(o, d, t_big, *queue, tri, p2p, *out),
           f"slot hit={frac:.3f} queue sort {time_ms(lambda: pairs.pair_queue(cids)):.4f} ms; "
           f"bound of the cl_cnt columns {design_ms:.4f} ms"
           f"{former('window_hit_closest', camera)}")
    k4_beside_k6(pairs, "pair_hit_closest", out, stats[-1]["ms"], shape,
                 (o, d, t_big, cids, tri, p2p, c, tc, *k6_tabs))
    overflow_share(pairs, pack, o, d, t_big, label)

    args_any = (o, d, t_any, *queue, kk, tri, c, tc)
    k6a = pairs.window_hit_any(*args_any, *k6_tabs)
    p6a = pairs.window_hit_any_plain(*args_any)
    torch.cuda.synchronize()
    check(torch.equal(k6a, p6a), "window_hit_any: occlusion differs")
    record(stats, "window_hit_any", shape, 0.0,
           lambda: pairs.window_hit_any(*args_any, *k6_tabs), lambda: pairs.window_hit_any_plain(*args_any),
           pair_tests(cids, sizes, k6a) * MT_OPS, nbytes(o, d, t_any, *queue, tri, k6a),
           f"occluded={float(k6a.float().mean()):.3f}"
           f"{former('window_hit_any', camera)}")
    k4_beside_k6(pairs, "pair_hit_any", (k6a,), stats[-1]["ms"], shape,
                 (o, d, t_any, cids, tri, c, tc, *k6_tabs))
    sub = torch.as_tensor(np.sort(rng.choice(r, N_STREAM_SUBSET, replace=False)), device=o.device)
    o_s, d_s = o[sub].contiguous(), d[sub].contiguous()
    sub_label = f"{label} subset"
    compare_walks(pb, sub_label, True, True, (o_s, d_s, t_big[sub].contiguous(), box, tri, tc),
                  sizes, stats, plain_reps=3)
    compare_walks(pb, sub_label, False, True, (o_s, d_s, t_any[sub].contiguous(), box, tri, tc),
                  sizes, stats, plain_reps=3)
    for name, tm in (("cluster_stream_closest", t_big), ("cluster_stream_any", t_any)):
        fn = getattr(pb, name)
        print(f"  {name:24s} {shape:28s} kernel {time_ms(lambda: fn(o, d, tm, box, tri, tc), 5):.4f} ms "
              f"(all rays; subset {stats[-2 if 'closest' in name else -1]['ms']:.4f} ms, "
              f"full-rescan kernel {RESCAN_MS[name]} ms on the camera subset)", flush=True)
    for closest, tm in ((True, t_big), (False, t_any)):
        fallback_walks(pairs, pb, label, pack, o, d, tm, closest)


def former(name, camera):
    """On camera rays: the former design's time (FORMER_MS)."""
    return f" (former design: {FORMER_MS[name]} ms)" if camera else ""


def cull_group_tests(pairs, o, d, t_max, sup, s, gs):
    """The group level's work at groups of gs boxes (K5: supers, sup the
    [8, Sp] cl_sup; K3: clusters, sup their [6, C] rows): (groups per ray,
    box slab tests over all rays: the boxes of the groups each ray hits)."""
    import torch

    n_grp = -(-s // gs)
    real = sup[:, :s]
    lo = torch.stack([real[0:3, k * gs:(k + 1) * gs].amin(dim=1) for k in range(n_grp)])
    hi = torch.stack([real[3:6, k * gs:(k + 1) * gs].amax(dim=1) for k in range(n_grp)])
    size = torch.tensor([min(gs, s - k * gs) for k in range(n_grp)], device=o.device)
    tests = 0
    for a in range(0, o.shape[0], 1 << 16):
        _, hit = pairs._cull_slab(lo[None], hi[None], o[a:a + (1 << 16)],
                                  pairs.pb.safe_inv(d[a:a + (1 << 16)]), t_max[a:a + (1 << 16)])
        tests += int((hit * size).sum())
    return n_grp, tests


def fallback_walks(pairs, pb, label, pack, o, d, t_max, closest):
    """The batch pair_closest (closest) or pair_any hands its fallback,
    captured at the fallback's entry: the kernel the pack dispatches to
    (K7/K8 when cluster_vmem_ok holds, else K9/K10) against its plain
    version on it (equal results) and timed, with the clusters each of its
    rays visits (tests the triangles of) and its box scans, from the
    kernel's stats output.  For K7/K8 also: K9/K10 on the same batch (the
    same walk over boxes read from L2: equal results and stats), timed
    beside, and the full-rescan kernels' times."""
    import torch

    name = "cluster_closest" if closest else "cluster_any"
    entry, batch = getattr(pb, name), []

    def spy(pack_, o_, d_, t_):
        batch.append((o_, d_, t_))
        return entry(pack_, o_, d_, t_)

    setattr(pb, name, spy)
    try:
        (pairs.pair_closest if closest else pairs.pair_any)(pack, o, d, t_max)
    finally:
        setattr(pb, name, entry)
    kind = "closest" if closest else "any"
    resident = pack.meta.get("cluster_vmem_ok", True)
    kern = getattr(pb, f"cluster_{'traverse' if resident else 'stream'}_{kind}")
    if not batch:
        print(f"  {kern.__name__}: no {label} ray took the fallback", flush=True)
        return False
    o_f, d_f, t_f = batch[0]
    _, t_f = pb.finite_tmax(t_f, o_f)
    args = (o_f.contiguous(), d_f.contiguous(), t_f, pack.cl_box, pack.cl_tri,
            pack.meta["cluster_tc"])

    def run(fn):
        """fn's results and stats on the batch, checked equal to plain."""
        st = torch.zeros(o_f.shape[0], 2, dtype=torch.int32, device=o.device)
        out = fn(*args, stats=st)
        out = out if closest else (out,)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            check(torch.equal(a, b), f"{fn.__name__}: differs from the plain walk on the "
                                     f"{label} fallback batch")
        return out, st

    ref = getattr(pb, f"{kern.__name__}_plain")(*args)
    ref = ref if closest else (ref,)
    _, st = run(kern)
    visits, scans = st[:, 0].float(), st[:, 1].float()
    line = (f"  {kern.__name__:24s} {label} fallback batch of {o_f.shape[0]} rays: kernel "
            f"{time_ms(lambda: kern(*args)):.4f} ms (equal to plain); clusters visited per ray mean "
            f"{float(visits.mean()):.3f} max {int(visits.max())}, box scans mean "
            f"{float(scans.mean()):.3f} max {int(scans.max())}")
    if resident:
        stream = getattr(pb, f"cluster_stream_{kind}")
        _, st_l2 = run(stream)
        check(torch.equal(st_l2, st), f"{kern.__name__}: stats differ from {stream.__name__}'s")
        line += (f"; {stream.__name__} (boxes from L2, same stats) "
                 f"{time_ms(lambda: stream(*args)):.4f} ms; full-rescan kernel "
                 f"{RESCAN_PASS_MS[kern.__name__]} ms per launch in a profiled pass")
    print(line, flush=True)
    return True


class _FirstNEE(Exception):
    """Stops a render pass at its first shadow query."""


def smoke_queries(vp, make_render_pass, new_film, scene, pack, dev, spp):
    """The closest-hit queries of one pass of scenes/smoke.xml (the
    scene's film size, spp samples per pixel) up to its first NEE, as the
    volpath tracer makes them: (label, o, d, t_max) of the camera rays'
    query (t_max inf) and of each of the SHADOW_SEGMENTS closest-hit calls
    of the first NEE (finite t_max; from the event's medium vertices
    inside the cube and its surface hits, then from the null boundaries
    crossed)."""
    import torch

    rec = scene.sensor.record
    w, h = rec.film.width, rec.film.height
    inner, inner_hit, args, queries = vp._attenuated_visibility, vp.intersect, [], []

    def stop(*a):
        args.extend(a)
        raise _FirstNEE

    def spy(pack_, o, d, t_max=float("inf")):
        t = torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(o.shape[0])
        queries.append((o.contiguous(), d.contiguous(), t.contiguous()))
        return inner_hit(pack_, o, d, t_max)

    vp._attenuated_visibility, vp.intersect = stop, spy
    try:
        make_render_pass(pack, scene.integrator, rec, rec.film, rec.sampler, spp, dev)(
            new_film(h, w, dev), 0, 0)
    except _FirstNEE:
        pass
    finally:
        vp._attenuated_visibility = inner
        vp.intersect = inner_hit
    check(len(queries) == 1 and bool(args), "the smoke pass made no shadow query after its "
                                            "camera rays' closest hit")
    check(queries[0][0].shape[0] == w * h * spp,
          f"the smoke pass traced {queries[0][0].shape[0]} camera rays, not {w * h * spp}")
    vp.intersect = spy
    try:
        inner(*args)
    finally:
        vp.intersect = inner_hit
    labels = ["camera"] + [f"segment {k}" for k in range(len(queries) - 1)]
    for label, (o, _, _) in zip(labels, queries):
        inside = ((o[:, 0].abs() < 0.5) & (o[:, 1] > 0) & (o[:, 1] < 1) & (o[:, 2].abs() < 0.5))
        print(f"  smoke {w}x{h}x{spp} {label}: {int(inside.sum())} origins inside the cube's "
              f"box", flush=True)
    return [(label, *q) for label, q in zip(labels, queries)]


def compare_segments(pairs, pb, pack, queries, stats, plain_reps=20, any_hit=False,
                     retry=False):
    """K3 and K4 (closest; with any_hit also any) on (label, o, d, t_max)
    queries against their plain versions, bit for bit (cluster lists; t,
    prim, u, v; occlusion), timed; and the fallback (K7; with any_hit also
    K8) on the batch the pair pipeline hands it, with retry at K = 1 where
    no ray overflows at the natural K.  Returns the fallbacks that ran
    (True: closest, False: any)."""
    import torch

    c, tc = pack.meta["n_clusters"], pack.meta["cluster_tc"]
    kk = min(pairs.K, c)
    sizes = cluster_sizes(pack)
    tabs = (pack.cl_cnt, pairs._tri_rows(pack))
    ran = set()
    for label, o, d, t_seg in queries:
        r = o.shape[0]
        _, t_max = pb.finite_tmax(t_seg, o)  # as pair_closest passes it on
        shape = f"{label} rays={r} C={c}"
        fin = torch.isfinite(t_seg)
        span = (f" in {float(t_seg[fin].min()):.4g}..{float(t_seg[fin].max()):.4g}"
                if bool(fin.any()) else "")
        print(f"  {shape}: {int(fin.sum())} finite t_max{span}", flush=True)
        k3 = pairs.dense_cull(o, d, t_max, pack.cl_mbox, c, kk)
        p3 = pairs.dense_cull_plain(o, d, t_max, pack.cl_mbox, c, kk)
        torch.cuda.synchronize()
        for a, b, what in zip(k3, p3, ("cid", "entry", "n_cl", "kept_max")):
            check(torch.equal(a, b), f"dense_cull on {shape}: {what} differs")
        del p3
        record(stats, "dense_cull", shape, 0.0,
               lambda: pairs.dense_cull(o, d, t_max, pack.cl_mbox, c, kk),
               lambda: pairs.dense_cull_plain(o, d, t_max, pack.cl_mbox, c, kk),
               r * c * SLAB_OPS, nbytes(o, d, t_max, pack.cl_mbox.reshape(-1, 6)[:c], *k3),
               f"clusters hit/ray={float(k3[2].float().mean()):.3f}", plain_reps=plain_reps)
        cids = k3[0]
        if any_hit:
            args_any = (o, d, t_max, cids, pack.cl_tri, c, tc)
            k4a = pairs.pair_hit_any(*args_any, *tabs)
            check(torch.equal(k4a, pairs.pair_hit_any_plain(*args_any)),
                  f"pair_hit_any on {shape}: occlusion differs")
            record(stats, "pair_hit_any", shape, 0.0,
                   lambda: pairs.pair_hit_any(*args_any, *tabs),
                   lambda: pairs.pair_hit_any_plain(*args_any),
                   pair_tests(cids, sizes, k4a) * MT_OPS,
                   nbytes(o, d, t_max, cids, pack.cl_tri, k4a),
                   f"occluded={float(k4a.any(dim=1).float().mean()):.3f}", plain_reps=plain_reps)
        args = (o, d, t_max, cids, pack.cl_tri, pack.cl_pad2prim, c, tc)
        out = pairs.pair_hit_closest(*args, *tabs)
        ref = pairs.pair_hit_closest_plain(*args)
        torch.cuda.synchronize()
        for a, b, what in zip(out, ref, ("t", "prim", "u", "v")):
            check(torch.equal(a, b), f"pair_hit_closest on {shape}: {what} differs")
        del ref
        record(stats, "pair_hit_closest", shape, 0.0,
               lambda: pairs.pair_hit_closest(*args, *tabs),
               lambda: pairs.pair_hit_closest_plain(*args),
               pair_tests(cids, sizes) * MT_OPS,
               nbytes(o, d, t_max, cids, pack.cl_tri, pack.cl_pad2prim, *out),
               f"slot hit={float((out[1] >= 0).float().mean()):.3f}", plain_reps=plain_reps)
        for closest in (True, False) if any_hit else (True,):
            if fallback_walks(pairs, pb, label, pack, o, d, t_max, closest):
                ran.add(closest)
            elif retry:
                natural, pairs.K = pairs.K, 1
                try:
                    if fallback_walks(pairs, pb, f"{label} (K=1)", pack, o, d, t_max, closest):
                        ran.add(closest)
                finally:
                    pairs.K = natural
    return ran


def k4_beside_k6(pairs, name, k6_out, k6_ms, shape, args):
    """K4 (the per-pair kernel, which reads each pair's cluster from L2
    or memory) on the cluster lists K6 just took from the sorted queue:
    the same per-slot results, and both times, to weigh the window
    design on this mesh."""
    import torch

    fn = getattr(pairs, name)
    out = fn(*args)
    out = out if isinstance(out, tuple) else (out,)
    torch.cuda.synchronize()
    for a, b in zip(out, k6_out):
        check(torch.equal(a, b), f"{name} differs from the window kernel on the same lists")
    print(f"  {name + ' (K4)':24s} {shape:28s} on K6's lists: kernel {time_ms(lambda: fn(*args)):.4f} ms, "
          f"K6 {k6_ms:.4f} ms", flush=True)


def counters(pk, pairs, pb):
    """Each kernel's wrapper (and launch counter) by name."""
    return {name: getattr(mod, name) for mod in (pk, pairs, pb) for name, _, _ in KERNELS
            if hasattr(mod, name)}


def render_checked(mt, counted, scene, golden_path, dev, label, pack=None, spp=16, bins=None):
    """Render at the scene's film size (64x64 unless said otherwise), spp
    samples per pixel, seed 0 (with `bins` spectral bins, else in RGB
    mode) with the given launch counters set to 0 just before; check
    finiteness and the golden's gate (tests/torch_meshes.py GOLDEN_GATES,
    else tests/test_golden.py's 5e-3).  Returns the launches."""
    import numpy as np
    import torch
    from torch_meshes import GOLDEN_GATES, tm_rmse

    gate = GOLDEN_GATES.get(os.path.basename(golden_path), 5e-3)

    for fn in counted.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    img = mt.render(scene, spp=spp, seed=0, device=dev, pack=pack, spectral_bins=bins)
    render_s = time.time() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    print(f"  {label}: peak device memory of the render "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    golden = np.load(golden_path)
    check(img.shape == golden.shape, f"{label}: image shape {img.shape} != {golden.shape}")
    check(bool(np.isfinite(img).all()), f"{label}: image has non-finite values")
    rmse = tm_rmse(img, golden)
    print(f"phase 3: {label} {img.shape[1]}x{img.shape[0]} {spp} spp on the card in "
          f"{render_s:.2f} s: "
          f"tone-mapped RMSE vs golden {rmse:.6g} (gate {gate:g}), mean {img.mean():.6f}, "
          f"launches {launches}", flush=True)
    check(rmse < gate, f"{label}: golden gate failed: RMSE {rmse} (gate {gate:g})")
    return launches


def throughput(make_render_pass, new_film, pack, scene, dev, label, card,
               passes=THROUGHPUT_PASSES, warm=True, ref=None, iterations=None,
               spp=THROUGHPUT_SPP_CHUNK, unit="bounce"):
    """Traced rays per second over `passes` passes of `spp` samples per
    pixel at the scene's film size, after one warm-up pass into a film of
    its own unless `warm` is false (where a scene of the same size and
    kernels ran just before).  With `ref` (an .npz of the converged
    image), also the tone-mapped RMSE of the timed passes' image against
    it; with `iterations` (a count that grows by one per iteration of the
    integrator's loop: K1's launches for the path tracer, one per bounce;
    volpath_trace.events, one per event), one more pass under the profiler
    for kernels per pass and per iteration (`unit`) and the busy share."""
    import numpy as np
    import torch
    from torch_meshes import tm_rmse

    from mitsuba_tpu_torch.film.film import develop

    rec = scene.sensor.record
    w, h = rec.film.width, rec.film.height
    rp = make_render_pass(pack, scene.integrator, rec, rec.film, rec.sampler, spp, dev)
    t0 = time.time()
    if warm:
        rp(new_film(h, w, dev), 0, 0)
        torch.cuda.synchronize()
    warm_s = time.time() - t0
    film = new_film(h, w, dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    for i in range(passes):
        film, n_rays = rp(film, i * spp, 0)
        total = total + n_rays
    n_total = int(total)  # synchronises
    elapsed = time.time() - t0
    check(bool(torch.isfinite(film).all()), f"{label} {w}x{h} film has non-finite values")
    rays_s = n_total / elapsed
    out = {"scene": label, "width": w, "height": h, "spp_chunk": spp,
           "passes": passes, "rays": n_total, "seconds": elapsed, "rays_per_s": rays_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card}
    print(f"phase 4: {label} {w}x{h}, {passes} passes x {spp} spp: "
          f"{n_total} rays in {elapsed:.3f} s = {rays_s:.6g} rays/s "
          f"({f'first pass {warm_s:.3f} s' if warm else 'no warm-up pass'}; peak device memory "
          f"{out['peak_gib']:.3f} GiB) on {card}", flush=True)
    if ref is not None:
        img = (develop(film) * rec.ray_weight).cpu().numpy()
        gold = np.load(ref)["img"].astype(np.float32)
        check(img.shape == gold.shape, f"{label}: image {img.shape}, reference {gold.shape}")
        out["rmse_vs_ref"] = tm_rmse(img, gold)
        print(f"  {label}: tone-mapped RMSE of the {passes * spp}-spp image vs "
              f"{os.path.relpath(ref, HERE)}: {out['rmse_vs_ref']:.6g} (no gate)", flush=True)
    if iterations is not None:
        wall, dev_ms, n_k, iters = profiled_pass(rp, new_film(h, w, dev), passes * spp,
                                                iterations)
        check(iters > 0, f"{label}: the profiled pass ran no {unit}")
        out.update(profiled_wall_s=wall, device_ms=dev_ms, kernels_per_pass=n_k,
                   iterations=iters, unit=unit, kernels_per_iteration=n_k / iters,
                   busy=dev_ms / 1e3 / wall)
        print(f"  {label}: profiled pass (CUDA activity) wall {wall:.4f} s, device time "
              f"{dev_ms:.3f} ms, busy share {out['busy']:.4f}; {n_k} kernels over {iters} "
              f"{unit} iterations = {out['kernels_per_iteration']:.1f} per {unit}", flush=True)
    print(json.dumps({"throughput": out}), flush=True)


def camera_rays(scene, dev):
    """One ray through each pixel centre of the scene's sensor, through the
    lens point of the sampler's lens draw for sample 0 where the camera
    reads one (a thinlens, a telecentric camera with an aperture)."""
    import torch

    from mitsuba_tpu_torch.sensor.plugins import generate_rays

    rec = scene.sensor.record
    w, h = rec.film.width, rec.film.height
    cam = rec.pack(w, h, dev)
    ys, xs = torch.meshgrid(
        torch.arange(h, device=dev, dtype=torch.float32),
        torch.arange(w, device=dev, dtype=torch.float32), indexing="ij",
    )
    pos01 = torch.stack([(xs.reshape(-1) + 0.5) / w, (ys.reshape(-1) + 0.5) / h], -1)
    lane = torch.arange(w * h, device=dev)
    u_lens = (rec.sampler.lens_sample(lane, torch.zeros_like(lane)) if cam["use_lens"]
              else torch.zeros_like(pos01))
    o, d = generate_rays(cam, pos01, u_lens)
    return o.contiguous(), d.contiguous()


def matpreview_rays(scene, pack, dev, seed=0):
    """A matpreview scene's camera rays (one per pixel centre) and the
    shadow rays of their first hits as the path tracer spawns them: toward
    a direction sampled from the environment with the NEE draw of a
    pass's first bounce (sample 0, the scene's sampler), from the hit
    point offset along the normal, t_max 1e7."""
    import torch

    from mitsuba_tpu_torch.accel.intersect import fill_interaction, intersect
    from mitsuba_tpu_torch.core import rng
    from mitsuba_tpu_torch.emitter import eval as em
    from mitsuba_tpu_torch.integrator.path import _SLOT_NEE, SHADOW_EPS, _offset_ray
    from mitsuba_tpu_torch.sampler.plugins import ld_decision4

    o, d = camera_rays(scene, dev)
    its = fill_interaction(pack, o, d, intersect(pack, o, d))
    lane = torch.arange(o.shape[0], device=dev)
    sidx = torch.zeros_like(lane)
    dslot = torch.full((o.shape[0],), _SLOT_NEE, dtype=torch.int32, device=dev)
    u_n = ld_decision4(scene.sensor.record.sampler, lane, sidx, dslot,
                       rng.rand4(lane, sidx, dslot, seed), seed)
    ds = em.sample_direct(pack, its.p, u_n[..., :3])
    o_sh = _offset_ray(its.p, its.ng, ds.d)
    t_sh = torch.where(ds.dist >= em.ENV_DIST, 1e7, ds.dist * (1.0 - SHADOW_EPS))
    keep = its.valid
    return (o, d), (o_sh[keep].contiguous(), ds.d[keep].contiguous(), t_sh[keep].contiguous())


def matpreview_brute(pk, scene, pack, dev, stats, label, shadow=True, n_expected=2):
    """K1/K2 on a scene's tri_s of n_expected triangles (matpreview's
    ground, a rectangle; MOTION's static prefix) against their plain
    versions, bit for bit, on its camera rays (t_max 1e30, as the renderer
    calls them) and, unless `shadow` is false (a scene without emitters),
    on their first NEE shadow rays."""
    import torch

    if shadow:
        (o, d), (o_s, d_s, t_s) = matpreview_rays(scene, pack, dev)
    else:
        o, d = camera_rays(scene, dev)
    n_tri = int((pack.tri_s[0] < FAR_V0).sum())
    check(n_tri == n_expected, f"{label}'s tri_s holds {n_tri} triangles, expected {n_expected}")
    t_far = torch.full((o.shape[0],), 1e30, device=dev)
    batches = [((o, d), t_far)]
    if shadow:
        batches.append(((o_s, d_s), t_s))
        print(f"  {label}: {o.shape[0]} camera rays, {o_s.shape[0]} shadow rays "
              f"(t_max {float(t_s.min()):g}..{float(t_s.max()):g}), tri_s "
              f"{tuple(pack.tri_s.shape)}", flush=True)
    else:
        print(f"  {label}: {o.shape[0]} camera rays, tri_s {tuple(pack.tri_s.shape)}", flush=True)
    for rays, tm in batches:
        for name in ("closest_hit_v2", "any_hit_v2"):
            compare_brute(pk, name, *rays, tm, pack.tri_s, n_tri, stats, exact=True)
            brute_beside(pk, stats[-1], *rays, tm, pack.tri_s, False)


def count_calls(mod, name):
    """Wrap mod.name so that it counts its calls in .calls; returns the
    original to restore."""
    inner = getattr(mod, name)

    def counted(*args, **kwargs):
        counted.calls += 1
        return inner(*args, **kwargs)

    counted.calls = 0
    setattr(mod, name, counted)
    return inner


def device_events(prof):
    """(device ms, count) of a finished profile's device events (kernels,
    copies, fills; not the device spans of record_function ranges), read
    from its raw events: key_averages() first builds every CPU and device
    event into a tree of Python objects, which takes tens of seconds for
    a matpreview pass."""
    import torch

    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()]
    return sum(e.duration_ns() for e in evs) / 1e6, len(evs)


def profiled_pass(rp, film, sample_base, iterations):
    """One pass under torch.profiler (CUDA activity only, so that the
    profiler adds little host work): (wall s, device ms, device events,
    loop iterations), the iterations read from the count iterations()
    before and after."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    before = iterations()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        _, n_rays = rp(film, sample_base, 0)
        int(n_rays)
        torch.cuda.synchronize()
        wall = time.time() - t0
    return (wall, *device_events(prof), iterations() - before)


def count_sphere_hits(intersect_mod):
    """Wrap the sphere test so that it counts, in .hits, the lanes where a
    sphere lies nearer than the triangles (closest-hit and shadow queries
    both); returns the original to restore."""
    inner = intersect_mod._intersect_spheres

    def counted(pack, o, d, best_t):
        out = inner(pack, o, d, best_t)
        counted.hits += int(out[0].sum())
        return out

    counted.hits = 0
    intersect_mod._intersect_spheres = counted
    return inner


class _Enough(Exception):
    """Stops a render after the queries it was run for."""


def capture_queries(mod, name, n, run):
    """(o, d, t_max) of the first n calls of mod.name (an occlusion query)
    that run() makes; run stops there."""
    return [as_segment(args)
            for _, args in capture_calls(mod, (name,), run, lambda got: len(got) == n)]


def ptracer_segments(pk, tpt, scene, pack, dev, stats):
    """K1/K2 against their plain versions, bit for bit, on the particle
    tracer's camera connections on cbox (512x512, 4 particles per pixel:
    one batch of 1,048,576): the emitted particles' connection and the
    first surface vertices'; finite t_max between two offset points."""
    import torch

    rec = scene.sensor.record
    w, h = rec.film.width, rec.film.height
    lane = torch.arange(tpt.BATCH_MAX, device=dev)
    run = tpt.make_ptracer_batch(pack, scene.integrator, rec, w, h, 0)
    segs = capture_queries(tpt, "occluded", 2, lambda: run(
        torch.zeros(h, w, 3, device=dev), lane, torch.zeros_like(lane)))
    n_tri = int((pack.tri_s[0] < FAR_V0).sum())
    for label, (o, d, t) in zip(("emitter", "vertex 1"), segs):
        fin = torch.isfinite(t)
        print(f"  ptracer camera connections ({label}): {o.shape[0]} rays, t_max "
              f"{float(t[fin].min()):.4g}..{float(t[fin].max()):.4g}", flush=True)
        for name in ("closest_hit_v2", "any_hit_v2"):
            compare_brute(pk, name, o, d, t, pack.tri_s, n_tri, stats, exact=True)


def bdpt_segments(pairs, pb, tb, scene, pack, dev, stats, n=3):
    """K3/K4/K7/K8 on the connection segments of one bdpt chunk of the
    glass scene (the scene's 16 edges; 64x64 at the lane budget's 32 spp,
    131,072 lanes): the first n connections (t = 2; s = 1, 2, 3) from the
    camera subpath's first vertex, each a finite segment between two
    offset points."""
    import torch

    rec = scene.sensor.record
    w, h = rec.film.width, rec.film.height
    spp_chunk = tb.DEFAULT_LANES // (w * h)
    lane = torch.arange(w * h, device=dev).repeat(spp_chunk)
    sidx = torch.arange(spp_chunk, device=dev).repeat_interleave(w * h)
    chunk = tb.make_bdpt_chunk(pack, scene.integrator, rec, w, h, 0)
    queries = [(f"glass bdpt connection s={k + 1} t=2", *q) for k, q in
               enumerate(capture_queries(tb, "occluded", n, lambda: chunk(lane, sidx)))]
    ran = compare_segments(pairs, pb, pack, queries, stats, any_hit=True, retry=True)
    check(ran == {True, False}, "no bdpt connection segment reached K7 and K8 (even at K=1)")


def generator_throughput(label, steps, counted, w, h, card, unit, budget_s=None, ref=None,
                         note="", setup=False, **info):
    """Times a render that yields after each unit of work (a bdpt chunk, a
    Metropolis step): `steps()` starts one, yielding (image: a tensor or
    a callable giving one; units done; the rays traced so far, an int64
    tensor).  With `setup` the first yield ends the set-up (the chains'
    bootstrap), timed apart.  Runs to the end, or until budget_s has
    passed with at least 2 units; prints seconds per unit, rays/s (as the
    trace counts them: closest-hit rays of live lanes and shadow rays of
    live connections), peak device memory, the kernels' launches per
    unit, the tone-mapped RMSE of the image against `ref` (an .npz);
    then one more unit of a second run under the profiler (CUDA
    activity: kernels per unit, busy share).  Returns the launches of the
    timed run (counters set to 0 just before)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch_meshes import tm_rmse

    for fn in counted.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t_all = t0 = time.time()
    run = steps()
    out = {"scene": label, "width": w, "height": h, **info}
    if setup:
        _, _, rays = next(run)
        torch.cuda.synchronize()
        out["setup_s"] = time.time() - t0
        before = {k: fn.launches for k, fn in counted.items()}
        rays0, t0 = int(rays), time.time()
    else:
        before, rays0 = dict.fromkeys(counted, 0), 0
    times, img, done = [], None, 0
    for img, done, rays in run:
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        t0 = time.time()
        if budget_s is not None and len(times) >= 2 and t0 - t_all >= budget_s:
            break
    n_rays = int(rays) - rays0
    launches = {k: fn.launches for k, fn in counted.items()}
    per_unit = {k: (n - before[k]) / max(len(times), 1) for k, n in launches.items()}
    image = (img() if callable(img) else img).cpu().numpy()
    check(image.shape == (h, w, 3) and bool(np.isfinite(image).all()),
          f"{label}: the image is not finite or of shape {image.shape}")
    total = sum(times)
    units = unit + ("es" if unit.endswith("s") else "s")
    out.update({units: len(times), "done": done, f"seconds_per_{unit}": times,
                "rays": n_rays, "seconds": total, "rays_per_s": n_rays / total if total else None,
                f"launches_per_{unit}": per_unit, "launches": launches,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "card": card})
    rays_s = f"{out['rays_per_s']:.6g}" if total else "-"
    setup_s = f", set-up {out['setup_s']:.3f} s" if setup else ""
    print(f"phase 4: {label} {w}x{h}, {len(times)} {units} = {done} done{setup_s}: seconds "
          f"per {unit} {[round(x, 3) for x in times]}, {n_rays} rays in {total:.3f} s = "
          f"{rays_s} rays/s, peak device memory {out['peak_gib']:.3f} GiB, launches per {unit} "
          f"{per_unit} on {card}", flush=True)
    if ref is not None:
        gold = np.load(ref)["img"].astype(np.float32)
        check(image.shape == gold.shape, f"{label}: image {image.shape}, reference {gold.shape}")
        out["rmse_vs_ref"] = tm_rmse(image, gold)
        print(f"  {label}: tone-mapped RMSE of the image ({done} done) vs "
              f"{os.path.relpath(ref, HERE)}: {out['rmse_vs_ref']:.6g} (no gate{note})", flush=True)
    run = steps()
    if setup:
        next(run)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        next(run)
        torch.cuda.synchronize()
        wall = time.time() - t0
    run.close()
    dev_ms, n_k = device_events(prof)
    out.update({"profiled_wall_s": wall, "device_ms": dev_ms, f"kernels_per_{unit}": n_k,
                "busy": dev_ms / 1e3 / wall})
    print(f"  {label}: profiled {unit} (CUDA activity) wall {wall:.4f} s, device time "
          f"{dev_ms:.3f} ms, busy share {out['busy']:.4f}; {n_k} kernels per {unit}", flush=True)
    print(json.dumps({"throughput": out}), flush=True)
    return launches


def capture_calls(mod, names, run, stop=None):
    """(name, args) of the calls of mod.<names> that run() makes, until
    stop(calls) holds (run stops there), or with no `stop` of every call,
    each passed through.  A function that counts on its module's name (a
    kernel wrapper's `launches`, pair_closest's `rays`) counts on its spy
    meanwhile, and the counts go back to it after."""
    import functools

    inner, got = {n: getattr(mod, n) for n in names}, []

    def make(name):
        @functools.wraps(inner[name])
        def spy(*args, **kwargs):
            got.append((name, args))
            if stop is not None and stop(got):
                raise _Enough
            return inner[name](*args, **kwargs)
        return spy

    spies = {n: make(n) for n in names}
    for n, spy in spies.items():
        setattr(mod, n, spy)
    try:
        run()
    except _Enough:
        pass
    finally:
        for n, fn in inner.items():
            setattr(mod, n, fn)
            fn.__dict__.update({k: v for k, v in spies[n].__dict__.items() if k != "__wrapped__"})
    check(stop is None or stop(got),
          f"{mod.__name__}: the run stopped before its queries ({len(got)} calls)")
    return got


def as_segment(args):
    """(o, d, t_max [R]) of a closest-hit or occlusion query's arguments
    (pack, o, d[, t_max]); t_max inf where the query has none."""
    import math

    import torch

    _, o, d, *t = args
    t = torch.as_tensor(t[0] if t else math.inf, dtype=torch.float32, device=o.device)
    return o.contiguous(), d.contiguous(), t.expand(o.shape[0]).contiguous()


def door_step_segments(pairs, pb, tb, tps, scene, pack, dev, stats, n=3):
    """K3/K4 (closest and any), with K7/K8 on the batches they hand the
    fallback, bit for bit against plain on the queries of door's first
    bidirectional step as it stands (256x256: 65,536 chains after the
    bootstrap; 8 edges): the proposal's camera query and its first n
    connections (finite segments between offset points)."""
    steps = tps.iter_pssmlt(scene, pack, 1, 0, None, dev)
    next(steps)  # the bootstrap
    got = capture_calls(tb, ("intersect", "occluded"), lambda: next(steps),
                        lambda g: sum(c[0] == "occluded" for c in g) == n)
    cam = next(args for name, args in got if name == "intersect")
    conn = [args for name, args in got if name == "occluded"]
    queries = [("door step 1 camera", *as_segment(cam))] + [
        (f"door step 1 connection {k}", *as_segment(c)) for k, c in enumerate(conn)]
    ran = compare_segments(pairs, pb, pack, queries, stats, any_hit=True, retry=True)
    check(ran == {True, False}, "no door query reached K7 and K8 (even at K=1)")


def manifold_segments(pairs, pb, tmm, tps, scene, pack, dev, stats, n_chains=65_536):
    """K3/K4 (closest) with K7 bit for bit against plain on the re-traces
    of one manifold proposal on glass (scene at its film size, maxDepth
    6; n_chains rows seeded as bootstrap batch 0 seeds them): the path
    re-trace's camera query, the first chain-end trace of the current
    state's Jacobian and the first of the Newton solve.  Lanes whose
    chain is not eligible carry non-finite rays there, which no result
    reads; only the finite rays are compared (K3 and its plain version
    differ on NaN, ROADMAP C)."""
    import torch

    rec = scene.sensor.record
    w, h = rec.film.width, rec.film.height
    D = tps.dims_for(6)
    seed_mlt = tps.rng.stream_seed(0, tps.rng.STREAM_MLT)
    U = tps._boot_rows(n_chains, D, 0, seed_mlt, dev)
    lanes = torch.arange(n_chains, device=dev)
    cam = rec.pack(w, h, dev)
    # dmax = 6 path vertices, then 3 residuals of kmax + 1 = 5 traces for
    # the Jacobian, the lens move's camera ray, then the solve's residuals
    picks = {0: "path re-trace camera", 6: "Jacobian chain end", 22: "Newton solve chain end"}
    got = capture_calls(tmm, ("intersect",), lambda: tmm.propose_manifold(
        pack, scene.integrator, cam, w, h, U, 3, seed_mlt, lanes), lambda g: len(g) > max(picks))
    queries = []
    for i, label in picks.items():
        o, d, t = as_segment(got[i][1])
        fin = torch.isfinite(o).all(dim=1) & torch.isfinite(d).all(dim=1)
        print(f"  glass manifold proposal, {label}: {int(fin.sum())} of {o.shape[0]} rays "
              f"finite", flush=True)
        queries.append((f"glass manifold {label}", o[fin].contiguous(), d[fin].contiguous(),
                        t[fin].contiguous()))
    compare_segments(pairs, pb, pack, queries, stats, retry=True)


def mlt_brute(pk, tps, tml, scene, pack, dev, stats):
    """K1/K2 bit for bit against plain on the first closest-hit and shadow
    queries of one mlt step's path_from_primary on cbox (512x512 as it
    stands: 131,072 chains; a Veach proposal from rows seeded as bootstrap
    batch 0 seeds them)."""
    rec = scene.sensor.record
    w, h = rec.film.width, rec.film.height
    n = min(1 << 17, w * h)
    md = scene.integrator.max_depth
    D = tps.dims_for(md)
    seed_mlt = tps.rng.stream_seed(0, tps.rng.STREAM_MLT)
    U, _ = tml.propose_veach(tps._boot_rows(n, D, 0, seed_mlt, dev), 0, seed_mlt, w, h, md, 0.2)
    got = {}
    for name, args in capture_calls(
            pk, ("closest_hit_v2", "any_hit_v2"),
            lambda: tps.path_from_primary(pack, scene.integrator, rec.pack(w, h, dev), w, h, U),
            lambda g: len({c[0] for c in g}) == 2):
        got.setdefault(name, args)
    n_tri = int((pack.tri_s[0] < FAR_V0).sum())
    for name, (o, d, t_max, tri) in got.items():
        print(f"  cbox mlt step ({name}): {o.shape[0]} rays", flush=True)
        compare_brute(pk, name, o, d, t_max, tri, n_tri, stats, exact=True)


def sppm_walk_segments(pairs, pb, tsppm, scene, pack, dev, stats, n_photons=1 << 18):
    """K3/K4 (closest), with K7 on the batch they hand the fallback, bit
    for bit against plain on the first closest-hit query of an sppm photon
    walk on glass at the scene's film size (the first iteration's
    n_photons photons leaving the emitters: finite origins)."""
    import torch

    rec = scene.sensor.record
    w, h = rec.film.width, rec.film.height
    eye, photon, extent = tsppm.make_sppm_passes(pack, scene.integrator, rec, w, h, 0, dev)
    _, vps = eye(torch.arange(w * h, device=dev), 0)
    r0 = tsppm.initial_radius(extent, w, h)
    r2 = torch.full((w * h,), r0 * r0, device=dev)
    lane = torch.arange(n_photons, device=dev)
    got = capture_calls(tsppm, ("intersect",), lambda: photon(lane, 0, vps, r2),
                        lambda g: len(g) == 1)
    check(got[0][1][1].shape[0] == n_photons, "the photon walk's first query is not every photon")
    compare_segments(pairs, pb, pack, [("glass sppm photon walk depth 0", *as_segment(got[0][1]))],
                     stats, retry=True)


def pm_walk_segments(pairs, pb, tpm, tsppm, scene, pack, dev, stats, n_photons=1 << 17):
    """K3/K4 (closest), with K7 on its fallback batch, bit for bit against
    plain on the first closest-hit query of the volumetric photon mapper's
    photon walk on smoke (n_photons photons leaving the emitters)."""
    import torch

    rec = scene.sensor.record
    photon, meta = tpm.make_photon_pass(pack, tsppm.max_depth_of(scene.integrator), 0, dev)
    cell_s = 2.0 * tsppm.initial_radius(meta["extent"], rec.film.width, rec.film.height)
    lane = torch.arange(n_photons, device=dev)
    got = capture_calls(tpm, ("intersect",), lambda: photon(lane, 0, cell_s),
                        lambda g: len(g) == 1)
    check(got[0][1][1].shape[0] == n_photons, "the photon walk's first query is not every photon")
    compare_segments(pairs, pb, pack, [("smoke photonmapper walk event 0",
                                        *as_segment(got[0][1]))], stats, retry=True)


def vpl_brute(pk, tvpl, scene, pack, dev, stats):
    """K1/K2 bit for bit against plain on one VPL pass of cbox at the
    scene's film size: the eye walk's camera query (K1) and the first
    VPL's shadow batch (K2; the pixels it does not light carry an empty
    segment)."""
    import torch

    rec = scene.sensor.record
    w, h = rec.film.width, rec.film.height
    one = tvpl.make_vpl_pass(pack, scene.integrator, rec, w, h, 0, dev)
    got = {}

    def enough(calls):
        for name, args in calls:
            if args[0].shape[0] == w * h:
                got.setdefault(name, args)
        return len(got) == 2

    capture_calls(pk, ("closest_hit_v2", "any_hit_v2"),
                  lambda: one(torch.zeros(h, w, 3, device=dev), 0), enough)
    n_tri = int((pack.tri_s[0] < FAR_V0).sum())
    for name, (o, d, t_max, tri) in got.items():
        print(f"  cbox vpl pass ({name}): {o.shape[0]} rays, "
              f"{int((t_max > 0).sum())} with a segment", flush=True)
        compare_brute(pk, name, o, d, t_max, tri, n_tri, stats, exact=True)


@contextlib.contextmanager
def photon_env(photons):
    """The photons of an iteration (MTS_SPPM_PHOTONS) for the renders of
    the block, as the goldens were made; restored after."""
    saved = os.environ.get("MTS_SPPM_PHOTONS")
    if photons:
        os.environ["MTS_SPPM_PHOTONS"] = str(photons)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("MTS_SPPM_PHOTONS", None)
        else:
            os.environ["MTS_SPPM_PHOTONS"] = saved


def photon_throughput(label, iterate, scene, pack, photons, counted, card, ref, budget_s, dev,
                      note=""):
    """generator_throughput over the iterations of a photon mapper
    (iter_sppm or iter_photonmapper, timed: a synchronise after each
    pass), then the timed run's seconds of the eye and photon passes, the
    photons stored per iteration and, for sppm, the share of the gather's
    windows past PHOTONS_PER_CELL."""
    rec = scene.sensor.record
    w, h = rec.film.width, rec.film.height
    runs = []

    def steps():
        last = {}
        runs.append(last)
        for img, done, st in iterate(scene, pack, 100_000, 0, photons, dev, timed=True):
            last.update(st, done=done)
            yield img, done, st["rays"]

    generator_throughput(label, steps, counted, w, h, card, "iteration", budget_s=budget_s,
                         ref=ref, note=note, photons=photons)
    st = runs[0]
    n = st["done"]
    out = {"scene": label, "iterations": n, "eye_s": st["eye_s"], "photon_s": st["photon_s"],
           "card": card}
    if "photons" in st:
        out.update(photons_stored_per_iteration=st["photons"] / n,
                   overflow_share=st["overflow"] / (8 * n))
    else:
        out.update(volume_photons_per_iteration=st["volume_photons"] / n,
                   surface_photons_per_iteration=st["surface_photons"] / n)
    mean = statistics.mean
    print(f"  {label}: eye pass {mean(st['eye_s']):.4f} s, photon pass "
          f"{mean(st['photon_s']):.4f} s per iteration (means of {n}); "
          + ", ".join(f"{k} {v:.6g}" for k, v in out.items()
                      if k.endswith(("_iteration", "_share"))) + f" on {card}", flush=True)
    print(json.dumps({"photon_mapping": out}), flush=True)


def dipole_segments(pairs, pb, tsss, make_render_pass, new_film, scene, pack, ss_scene, ss_pack,
                    dev, stats):
    """K3/K4 (closest and any) with K7/K8 on their fallback batches, bit
    for bit against plain, on the queries of the subsurface slice: the
    camera rays of scenes/dipole.xml as it stands (512x384), the
    irradiance pass's NEE shadow rays (640 points x 32 rays), and the
    first single-scattering segment of a pass of the singlescatter
    variant at the same size (one sample per pixel): its internal rays
    to the far boundary, its rays from the internal vertex toward the
    light, and its shadow rays from the exit point."""
    import torch

    o, d = camera_rays(scene, dev)
    queries = [("dipole camera", o, d, torch.full((o.shape[0],), float("inf"), device=dev))]
    irr = capture_calls(tsss, ("occluded",),
                        lambda: tsss.compute_sss_irradiance(pack, scene.integrator, 0),
                        lambda g: len(g) == 1)
    shadow = [("dipole irradiance NEE", *as_segment(irr[0][1]))]
    rec = ss_scene.sensor.record
    w, h = rec.film.width, rec.film.height
    got = capture_calls(tsss, ("intersect", "occluded"), lambda: make_render_pass(
        ss_pack, ss_scene.integrator, rec, rec.film, rec.sampler, 1, dev)(new_film(h, w, dev), 0, 0),
                        lambda g: any(c[0] == "occluded" for c in g))
    segs = [args for name, args in got if name == "intersect"]
    check(len(segs) == 2, f"single scattering made {len(segs)} closest-hit queries before its "
                          f"first shadow query, not 2")
    queries += [("singlescatter internal", *as_segment(segs[0])),
                ("singlescatter toward the light", *as_segment(segs[1]))]
    shadow.append(("singlescatter exit shadow", *as_segment(got[-1][1])))
    for label, o, _, _ in queries[1:] + shadow:
        print(f"  {label}: {o.shape[0]} rays", flush=True)
    ran = compare_segments(pairs, pb, pack, queries, stats, retry=True)
    ran |= compare_segments(pairs, pb, pack, shadow, stats, any_hit=True, retry=True)
    check(ran == {True, False}, "no dipole query reached K7 and K8 (even at K=1)")


def dipole_throughput(tsss, make_render_pass, new_film, scene, pack, counted, card, dev):
    """scenes/dipole.xml as it stands (512x384, 64 spp, path at maxDepth
    8) as `render` runs it: the irradiance pass (seconds, points x rays),
    then its passes of DEFAULT_LANES_PER_PASS lanes' worth of samples
    (seconds, rays/s and K3/K4/K7/K8 launches of each, the counters set to
    0 just before the pass), peak device memory, the dipole lanes and
    points of the dense sum, and one more pass under the profiler (CUDA
    activity: kernels per pass, busy share).  Returns the launches of the
    passes and of the irradiance pass, summed."""
    import math

    import numpy as np
    import torch

    from mitsuba_tpu_torch.film.film import develop
    from mitsuba_tpu_torch.renderer import DEFAULT_LANES_PER_PASS

    rec = scene.sensor.record
    w, h, spp = rec.film.width, rec.film.height, rec.sampler.sample_count
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    prepared = tsss.prepare_sss(pack, scene.integrator, 0)
    torch.cuda.synchronize()
    irr_s = time.time() - t0
    total = {k: fn.launches for k, fn in counted.items()}
    p_cnt, k_irr = pack.sss_p.shape[0], pack.meta["sss_irr_samples"]
    print(f"phase 4: dipole irradiance pass: {p_cnt} points x {k_irr} rays = {p_cnt * k_irr} "
          f"lanes in {irr_s:.3f} s, launches {total}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB on {card}", flush=True)
    spp_chunk = max(1, min(spp, DEFAULT_LANES_PER_PASS // (w * h)))
    n_passes = math.ceil(spp / spp_chunk)
    rp = make_render_pass(prepared, scene.integrator, rec, rec.film, rec.sampler, spp_chunk, dev)
    sss_lanes = []
    inner = tsss.sss_lo

    def counted_lo(pack_, p, cos_o, sid):
        sss_lanes.append(p.shape[0])
        return inner(pack_, p, cos_o, sid)

    tsss.sss_lo = counted_lo
    film, passes = new_film(h, w, dev), []
    torch.cuda.reset_peak_memory_stats()
    try:
        for i in range(n_passes):
            for fn in counted.values():
                fn.launches = 0
            t0 = time.time()
            film, n_rays = rp(film, i * spp_chunk, 0)
            n = int(n_rays)
            torch.cuda.synchronize()
            sec = time.time() - t0
            launches = {k: fn.launches for k, fn in counted.items()}
            for k, v in launches.items():
                total[k] += v
            passes.append({"seconds": sec, "rays": n, "rays_per_s": n / sec,
                           "launches": launches})
            print(f"phase 4: dipole pass {i} ({spp_chunk} spp): {sec:.3f} s, {n} rays = "
                  f"{n / sec:.6g} rays/s, launches {launches} on {card}", flush=True)
    finally:
        tsss.sss_lo = inner
    peak = torch.cuda.max_memory_allocated() / 2**30
    img = (develop(film) * rec.ray_weight).cpu().numpy()
    check(img.shape == (h, w, 3) and bool(np.isfinite(img).all()) and img.mean() > 0,
          "the dipole image is not finite")
    wall, dev_ms, n_k, k3 = profiled_pass(rp, new_film(h, w, dev), n_passes * spp_chunk,
                                          lambda: counted["dense_cull"].launches)
    sec = sum(p["seconds"] for p in passes)
    rays = sum(p["rays"] for p in passes)
    out = {"scene": "dipole", "width": w, "height": h, "spp": n_passes * spp_chunk,
           "spp_chunk": spp_chunk, "irradiance_s": irr_s, "irradiance_lanes": p_cnt * k_irr,
           "points": p_cnt, "passes": passes, "seconds": sec, "rays": rays,
           "rays_per_s": rays / sec, "peak_gib": peak,
           "dipole_lanes_per_pass": sum(sss_lanes) / n_passes,
           "dense_sum_calls_per_pass": len(sss_lanes) / n_passes,
           "profiled_wall_s": wall, "device_ms": dev_ms, "kernels_per_pass": n_k,
           "k3_launches_profiled": k3, "busy": dev_ms / 1e3 / wall, "card": card}
    print(f"phase 4: dipole {w}x{h}, {n_passes} passes x {spp_chunk} spp: {rays} rays in "
          f"{sec:.3f} s = {rays / sec:.6g} rays/s, image mean {img.mean():.6f}, peak device "
          f"memory {peak:.3f} GiB; the dense sum: {out['dense_sum_calls_per_pass']:.1f} calls and "
          f"{out['dipole_lanes_per_pass']:.6g} lanes x {p_cnt} points a pass; profiled pass "
          f"wall {wall:.4f} s, device {dev_ms:.3f} ms, busy share {out['busy']:.4f}, {n_k} "
          f"kernels on {card}", flush=True)
    print(json.dumps({"throughput": out}), flush=True)
    return total


def pair_segments(pairs, pb, tpath, make_render_pass, new_film, scene, pack, dev, stats, label):
    """K3/K4 (closest and any) with K7/K8 on their fallback batches, bit for
    bit against plain, on a path-traced BVH scene at its film size
    (scenes/hairball.xml as it stands, 512x384; TEXTURED, 512x512): its
    camera rays and the NEE shadow rays of a pass's first bounce (one
    sample per pixel); beside each, the share of its rays whose cluster
    lists overflow K and take the fallback."""
    import torch

    o, d = camera_rays(scene, dev)
    rec = scene.sensor.record
    w, h = rec.film.width, rec.film.height
    got = capture_calls(tpath, ("occluded",), lambda: make_render_pass(
        pack, scene.integrator, rec, rec.film, rec.sampler, 1, dev)(new_film(h, w, dev), 0, 0),
                        lambda g: len(g) == 1)
    queries = ((f"{label} camera", o, d, torch.full((o.shape[0],), float("inf"), device=dev)),
               (f"{label} NEE", *as_segment(got[0][1])))
    for (label, qo, qd, qt), fn in zip(queries, (pairs.pair_closest, pairs.pair_any)):
        fn.rays = fn.overflow_rays = 0
        fn(pack, qo, qd, qt)
        print(f"  {label}: {fn.overflow_rays} of {fn.rays} rays overflow K={pairs.K} and take the "
              f"fallback ({fn.overflow_rays / fn.rays:.4%})", flush=True)
    ran = compare_segments(pairs, pb, pack, queries[:1], stats)
    ran |= compare_segments(pairs, pb, pack, queries[1:], stats, any_hit=True)
    check(ran == {True, False}, f"no {label} query reached K7 and K8")


def kernel_ms(prof, names):
    """Device ms and launches of the kernels of a finished profile whose
    names hold each of `names`' values, by the kernel's name with its
    template arguments."""
    import re

    import torch

    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        for label, name in names.items():
            m = re.search(rf"{name}(<[^>]*>)?", e.name())
            if m:
                ms, n = out.get(f"{label} {m.group(0)}", (0.0, 0))
                out[f"{label} {m.group(0)}"] = (ms + e.duration_ns() / 1e6, n + 1)
    return out


def hairball_throughput(make_render_pass, new_film, pairs, scene, pack, counted, card, dev):
    """scenes/hairball.xml as it stands (512x384, 64 spp, path at maxDepth
    6) in render's passes of DEFAULT_LANES_PER_PASS lanes' worth of samples,
    each timed with the K3/K4/K7/K8 counters set to 0 just before:
    seconds, rays/s, launches and the overflow share of each; the passes
    stop once HAIRBALL_BUDGET_S has passed (the line says how many of the
    64 spp ran); peak device memory; then one more pass under the profiler
    (CUDA activity): device time, busy share, kernels, and the device ms
    per pass of K3, K4 and K7/K8 by kernel name.  Returns the timed
    passes' launches."""
    import math

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mitsuba_tpu_torch.film.film import develop
    from mitsuba_tpu_torch.renderer import DEFAULT_LANES_PER_PASS

    rec = scene.sensor.record
    w, h, spp = rec.film.width, rec.film.height, rec.sampler.sample_count
    spp_chunk = max(1, min(spp, DEFAULT_LANES_PER_PASS // (w * h)))
    n_passes = math.ceil(spp / spp_chunk)
    rp = make_render_pass(pack, scene.integrator, rec, rec.film, rec.sampler, spp_chunk, dev)
    film, passes = new_film(h, w, dev), []
    total = {k: 0 for k in counted}
    torch.cuda.reset_peak_memory_stats()
    t_all = time.time()
    for i in range(n_passes):
        for fn in counted.values():
            fn.launches = 0
        for fn in (pairs.pair_closest, pairs.pair_any):
            fn.rays = fn.overflow_rays = 0
        torch.cuda.synchronize()
        t0 = time.time()
        film, n_rays = rp(film, i * spp_chunk, 0)
        n = int(n_rays)
        torch.cuda.synchronize()
        sec = time.time() - t0
        launches = {k: fn.launches for k, fn in counted.items()}
        for k, v in launches.items():
            total[k] += v
        ov = {fn.__name__: fn.overflow_rays / max(fn.rays, 1)
              for fn in (pairs.pair_closest, pairs.pair_any)}
        passes.append({"seconds": sec, "rays": n, "rays_per_s": n / sec, "launches": launches,
                       "overflow": ov})
        print(f"phase 4: hairball pass {i} ({spp_chunk} spp): {sec:.3f} s, {n} rays = "
              f"{n / sec:.6g} rays/s, overflow shares {ov}, launches {launches} on {card}",
              flush=True)
        if time.time() - t_all > HAIRBALL_BUDGET_S and i + 1 < n_passes:
            print(f"phase 4: hairball: {i + 1} of {n_passes} passes ran within "
                  f"{HAIRBALL_BUDGET_S:g} s", flush=True)
            break
    peak = torch.cuda.max_memory_allocated() / 2**30
    img = (develop(film) * rec.ray_weight).cpu().numpy()
    check(img.shape == (h, w, 3) and bool(np.isfinite(img).all()) and img.mean() > 0,
          "the hairball image is not finite")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        _, n_rays = rp(new_film(h, w, dev), len(passes) * spp_chunk, 0)
        int(n_rays)
        torch.cuda.synchronize()
        wall = time.time() - t0
    dev_ms, n_k = device_events(prof)
    per_kernel = kernel_ms(prof, PAIR_KERNELS)
    sec = sum(p["seconds"] for p in passes)
    rays = sum(p["rays"] for p in passes)
    out = {"scene": "hairball", "width": w, "height": h, "spp": len(passes) * spp_chunk,
           "spp_chunk": spp_chunk, "passes": passes, "seconds": sec, "rays": rays,
           "rays_per_s": rays / sec, "peak_gib": peak, "profiled_wall_s": wall,
           "device_ms": dev_ms, "kernels_per_pass": n_k, "busy": dev_ms / 1e3 / wall,
           "pair_kernels_ms_per_pass": {k: v[0] for k, v in per_kernel.items()},
           "pair_kernel_launches_per_pass": {k: v[1] for k, v in per_kernel.items()},
           "card": card}
    print(f"phase 4: hairball {w}x{h}, {len(passes)} passes x {spp_chunk} spp: {rays} rays in "
          f"{sec:.3f} s = {rays / sec:.6g} rays/s ({sec / len(passes):.3f} s per pass), image mean "
          f"{img.mean():.6f}, peak device memory {peak:.3f} GiB; profiled pass wall {wall:.4f} s, "
          f"device {dev_ms:.3f} ms, busy share {out['busy']:.4f}, {n_k} kernels; the pair "
          f"pipeline's kernels in it (ms, launches): "
          f"{({k: (round(v[0], 3), v[1]) for k, v in per_kernel.items()})} on {card}", flush=True)
    print(json.dumps({"throughput": out}), flush=True)
    return total


def hairball_exact_throughput(make_render_pass, new_film, tcyl, scene, pack, card, dev):
    """The exact mode (scenes/hairball.xml with exact="true": 7,189
    cylinder segments, their scan in plain tensor operations) at 512x384,
    one pass of HAIRBALL_EXACT_SPP samples per pixel: seconds and rays/s,
    with CUDA events recorded on the stream around each segment scan
    (accel/cyl.py cyl_closest, cyl_any) and around the pass, whose
    intervals give the scans' share of the pass's device-stream time;
    then the same pass under the profiler (CUDA activity): device time,
    busy share and kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rec = scene.sensor.record
    w, h, spp = rec.film.width, rec.film.height, HAIRBALL_EXACT_SPP
    rp = make_render_pass(pack, scene.integrator, rec, rec.film, rec.sampler, spp, dev)
    saved, spans = {name: getattr(tcyl, name) for name in ("cyl_closest", "cyl_any")}, []

    def timed(fn):
        def run(*a):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a)
            ev[1].record()
            spans.append(ev)
            return out
        return run

    for name, fn in saved.items():
        setattr(tcyl, name, timed(fn))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    try:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.time()
        start.record()
        film, n_rays = rp(new_film(h, w, dev), 0, 0)
        end.record()
        n = int(n_rays)
        torch.cuda.synchronize()
        sec = time.time() - t0
    finally:
        for name, fn in saved.items():
            setattr(tcyl, name, fn)
    check(bool(torch.isfinite(film).all()), "the exact hairball's film is not finite")
    stream_ms = start.elapsed_time(end)
    scan_ms = sum(a.elapsed_time(b) for a, b in spans)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        _, n_rays = rp(new_film(h, w, dev), spp, 0)
        int(n_rays)
        torch.cuda.synchronize()
        wall = time.time() - t1
    dev_ms, n_k = device_events(prof)
    out = {"scene": "hairball-exact", "width": w, "height": h, "spp": spp, "seconds": sec,
           "rays": n, "rays_per_s": n / sec, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "stream_ms": stream_ms, "scan_ms": scan_ms, "scan_calls": len(spans),
           "scan_share": scan_ms / stream_ms, "profiled_wall_s": wall, "device_ms": dev_ms,
           "kernels": n_k, "busy": dev_ms / 1e3 / wall, "card": card}
    check(len(spans) > 0 and scan_ms > 0, "the exact pass ran no segment scan")
    print(f"phase 4: hairball exact {w}x{h}, 1 pass x {spp} spp: {n} rays in {sec:.3f} s = "
          f"{n / sec:.6g} rays/s, peak device memory {out['peak_gib']:.3f} GiB; the segment scans "
          f"({len(spans)} calls) {scan_ms:.3f} of the pass's {stream_ms:.3f} stream ms = "
          f"{out['scan_share']:.4f} (CUDA events); profiled pass wall {wall:.4f} s, device "
          f"{dev_ms:.3f} ms, busy share {out['busy']:.4f}, {n_k} kernels on {card}", flush=True)
    print(json.dumps({"throughput": out}), flush=True)


def textured_throughput(make_render_pass, new_film, ttex, scene, pack, counted, card, dev):
    """TEXTURED at 512x512, 16 spp, in render's passes of
    DEFAULT_LANES_PER_PASS lanes' worth of samples (8 spp), each timed with
    the K3/K4/K7/K8 counters set to 0 just before: seconds, rays/s and
    launches; peak device memory; then one more pass under the profiler
    (CUDA activity): its wall time, device time, busy share and kernels;
    a pass of 1 spp under CPU and CUDA activity with profile_pass.py's
    TEX_STAGES ranges: the device ms and calls of shading_params,
    shading_frame, eval_texture and mip_footprint (eval_texture nests in
    the other two); last one pass under the ewa
    filter (MTS_TEX_FILTER), timed beside the first feline pass.  Returns
    the timed passes' launches."""
    import math

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mitsuba_tpu_torch.film.film import develop
    from mitsuba_tpu_torch.renderer import DEFAULT_LANES_PER_PASS
    from profile_pass import TEX_STAGES

    rec = scene.sensor.record
    w, h, spp = rec.film.width, rec.film.height, rec.sampler.sample_count
    spp_chunk = max(1, min(spp, DEFAULT_LANES_PER_PASS // (w * h)))
    n_passes = math.ceil(spp / spp_chunk)
    rp = make_render_pass(pack, scene.integrator, rec, rec.film, rec.sampler, spp_chunk, dev)
    film, passes = new_film(h, w, dev), []
    total = {k: 0 for k in counted}
    torch.cuda.reset_peak_memory_stats()
    for i in range(n_passes):
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        film, n_rays = rp(film, i * spp_chunk, 0)
        n = int(n_rays)
        torch.cuda.synchronize()
        sec = time.time() - t0
        launches = {k: fn.launches for k, fn in counted.items()}
        for k, v in launches.items():
            total[k] += v
        passes.append({"seconds": sec, "rays": n, "rays_per_s": n / sec, "launches": launches})
        print(f"phase 4: textured pass {i} ({spp_chunk} spp): {sec:.3f} s, {n} rays = "
              f"{n / sec:.6g} rays/s, launches {launches} on {card}", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    img = (develop(film) * rec.ray_weight).cpu().numpy()
    check(img.shape == (h, w, 3) and bool(np.isfinite(img).all()) and img.mean() > 0,
          "the TEXTURED image is not finite")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        _, n_rays = rp(new_film(h, w, dev), n_passes * spp_chunk, 0)
        int(n_rays)
        torch.cuda.synchronize()
        wall = time.time() - t0
    dev_ms, n_k = device_events(prof)
    per_kernel = kernel_ms(prof, PAIR_KERNELS)
    # the stages' device ms from a pass of 1 spp (262,144 lanes)
    rp1 = make_render_pass(pack, scene.integrator, rec, rec.film, rec.sampler, 1, dev)
    stages, _, _ = stage_device_ms(rp1, new_film(h, w, dev), TEX_STAGES)
    texture_stages = {k: stages.get(k, (0.0, 0)) for k in
                      ("shading_params", "shading_frame", "eval_texture", "mip_footprint")}
    check(all(n > 0 for _, n in texture_stages.values()),
          f"the profiled TEXTURED pass missed a texture stage: {texture_stages}")
    ttex.TEX_FILTER = "ewa"
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        ewa_film, n_rays = rp(new_film(h, w, dev), 0, 0)
        n_ewa = int(n_rays)
        torch.cuda.synchronize()
        ewa_s = time.time() - t0
    finally:
        ttex.TEX_FILTER = "feline"
    check(bool(torch.isfinite(ewa_film).all()), "the TEXTURED ewa pass's film is not finite")
    sec = sum(p["seconds"] for p in passes)
    rays = sum(p["rays"] for p in passes)
    out = {"scene": "textured", "width": w, "height": h, "spp": spp, "spp_chunk": spp_chunk,
           "passes": passes, "seconds": sec, "rays": rays, "rays_per_s": rays / sec,
           "peak_gib": peak, "profiled_wall_s": wall, "device_ms": dev_ms, "kernels_per_pass": n_k,
           "busy": dev_ms / 1e3 / wall,
           "texture_stage_device_ms_1spp": {k: v[0] for k, v in texture_stages.items()},
           "texture_stage_calls_1spp": {k: v[1] for k, v in texture_stages.items()},
           "pair_kernels_ms_per_pass": {k: v[0] for k, v in per_kernel.items()},
           "pair_kernel_launches_per_pass": {k: v[1] for k, v in per_kernel.items()},
           "ewa_pass_s": ewa_s, "ewa_rays": n_ewa, "feline_pass_s": passes[0]["seconds"],
           "card": card}
    print(f"phase 4: textured {w}x{h}, {n_passes} passes x {spp_chunk} spp: {rays} rays in "
          f"{sec:.3f} s = {rays / sec:.6g} rays/s ({sec / n_passes:.3f} s per pass), image mean "
          f"{img.mean():.6f}, peak device memory {peak:.3f} GiB; profiled pass wall {wall:.4f} s, "
          f"device {dev_ms:.3f} ms, busy share {out['busy']:.4f}, {n_k} kernels; texture stages "
          f"of a profiled 1-spp pass (device ms, calls): "
          f"{({k: (round(v[0], 3), v[1]) for k, v in texture_stages.items()})}; the pair "
          f"pipeline's kernels (ms, launches): "
          f"{({k: (round(v[0], 3), v[1]) for k, v in per_kernel.items()})}; one ewa pass "
          f"{ewa_s:.3f} s ({n_ewa} rays) beside feline's {passes[0]['seconds']:.3f} s on {card}",
          flush=True)
    print(json.dumps({"throughput": out}), flush=True)
    return total


def dispersion_throughput(mt, scene, counted, card, dev):
    """scenes/dispersion.xml as it stands through `render` (packed by
    render itself), once in RGB mode at the scene's own 256 spp and once
    with 9 spectral bins at DISPERSION_BINS_SPP (for the script's time
    limit), the launch counters set to 0 just before each render:
    seconds, rays/s, peak device memory and launches of each.  Then the
    9-bin render again as its bin groups, timed here: each group's
    apply_spectral_pack and its render on that pack, whose projected sum
    must give the entry point's image.  Returns the launches of the two
    entry-point renders."""
    import numpy as np
    import torch

    from mitsuba_tpu_torch.core.spectral import make_bins
    from mitsuba_tpu_torch.core.spectrum import _XYZ_TO_RGB
    from mitsuba_tpu_torch.scene.builder import apply_spectral_pack, pack_scene

    rec = scene.sensor.record
    total = {k: 0 for k in counted}
    for bins in (None, 9):
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        # the default device: the card; 9 bins at DISPERSION_BINS_SPP
        img = mt.render(scene, spp=DISPERSION_BINS_SPP if bins else None, spectral_bins=bins)
        secs = time.time() - t0
        launches = {k: fn.launches for k, fn in counted.items()}
        check(img.shape == (rec.film.height, rec.film.width, 3) and bool(np.isfinite(img).all())
              and img.mean() > 0, f"dispersion.xml ({bins} bins): the image is not finite")
        rays = mt.render.last_ray_count
        spp = DISPERSION_BINS_SPP if bins else rec.sampler.sample_count
        out = {"scene": "dispersion", "bins": bins or 3, "width": rec.film.width,
               "height": rec.film.height, "spp": spp, "seconds": secs,
               "rays": rays, "rays_per_s": rays / secs,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
               "mean": float(img.mean()), "card": card}
        if bins:
            sb = make_bins(bins)
            pack = pack_scene(scene, dev)
            xyz, group_s, pack_s = 0.0, [], []
            for g in range(sb.n_groups):
                t0 = time.time()
                pack_g = apply_spectral_pack(pack, sb, g)
                torch.cuda.synchronize()
                pack_s.append(time.time() - t0)
                t0 = time.time()
                img_g = mt.render(scene, spp=spp, device=dev, pack=pack_g,
                                  _spectral_inner=True)
                group_s.append(time.time() - t0)
                xyz = xyz + img_g @ np.asarray(sb.group(g)[0], np.float32).T
            img_groups = np.maximum(xyz @ _XYZ_TO_RGB.T, 0.0)
            diff = float(np.abs(img_groups - img).max())
            out.update(group_s=group_s, pack_s=pack_s, groups_max_abs_diff=diff)
            # the film's index_add_ lands in any order on the card, so the
            # two renders' sums may part in their last places
            check(abs(float(img_groups.mean()) - out["mean"]) <= 1e-4 * out["mean"],
                  f"dispersion.xml: the bin groups' mean {img_groups.mean()} is not the "
                  f"entry point's {out['mean']}")
        print(f"phase 4: dispersion.xml {rec.film.width}x{rec.film.height}, "
              f"{spp} spp, {f'{bins} bins' if bins else 'RGB mode'}: {rays} "
              f"rays in {secs:.3f} s = {rays / secs:.6g} rays/s"
              + (f" (bin groups rendered alone {['%.3f' % x for x in out['group_s']]} s, "
                 f"apply_spectral_pack {['%.4f' % x for x in out['pack_s']]} s, their image "
                 f"within {out['groups_max_abs_diff']:.3g} of the entry point's)" if bins else "")
              + f", peak device memory {out['peak_gib']:.3f} GiB, mean {out['mean']:.6f}, "
              f"launches {launches} on {card}", flush=True)
        print(json.dumps({"throughput": out}), flush=True)
        for k, n in launches.items():
            total[k] += n
    return total


def meta_throughput(mt, scene, pack, counted, card, dev, label, stats_of, spp):
    """One render of a meta-integrator on the card (irrcache or adaptive,
    at the scene's film size, spp samples per pixel): seconds, its stats
    (stats_of(): the rays it traced, and its records or rounds), rays/s,
    peak device memory and K1/K2 launches."""
    import numpy as np
    import torch

    for fn in counted.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    img = mt.render(scene, spp=spp, seed=0, device=dev, pack=pack)
    sec = time.time() - t0
    check(bool(np.isfinite(img).all()) and img.mean() > 0, f"the {label} image is not finite")
    st = stats_of()
    out = {"scene": label, "width": img.shape[1], "height": img.shape[0], "spp": spp,
           "seconds": sec, **st,
           "rays_per_s": st["rays"] / sec,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": {k: fn.launches for k, fn in counted.items()}, "card": card}
    print(f"phase 4: {label} {img.shape[1]}x{img.shape[0]}, {out['spp']} spp: {sec:.3f} s, "
          f"{st}, {out['rays_per_s']:.6g} rays/s, peak device memory {out['peak_gib']:.3f} GiB, "
          f"launches {out['launches']} on {card}", flush=True)
    print(json.dumps({"throughput": out}), flush=True)


def stage_summary(prof):
    """A finished profile's device time by stage and by kernel, from its
    raw events: key_averages() builds every event into Python objects,
    which took 60-115 s on a FIBER pass and minutes on an INSTANCED one.
    A device event counts toward a stage when the runtime call that
    launched it (matched by correlation id) lies inside one of the stage's
    record_function ranges "stage:<name>".  Returns ({stage: (device ms,
    calls, host ms)}, {kernel name: (device ms, launches)}, the device
    ms, the device events).  Fails where fewer than 90 % of the device
    events find their launch."""
    import numpy as np
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ranges, launch, kern, by_name = {}, {}, [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                kern.append((e.correlation_id(), e.duration_ns()))
                k = by_name.setdefault(e.name(), [0.0, 0])
                k[0] += e.duration_ns() / 1e6
                k[1] += 1
        elif e.name().startswith("stage:"):
            ranges.setdefault(e.name()[6:], []).append((e.start_ns(),
                                                        e.start_ns() + e.duration_ns()))
        elif e.name().startswith("cu"):  # runtime and driver calls
            launch[e.correlation_id()] = e.start_ns()
    ts = np.array([launch.get(c, -1) for c, _ in kern], np.int64)
    dur = np.array([d for _, d in kern], np.float64)
    matched = float((ts >= 0).mean()) if len(kern) else 0.0
    check(matched >= 0.9, f"stage_summary: only {matched:.3f} of the device events matched "
          f"the runtime call that launched them")
    out = {}
    for name, iv in ranges.items():
        iv = np.array(sorted(iv), np.int64)
        i = np.searchsorted(iv[:, 0], ts, side="right") - 1
        inside = (ts >= 0) & (i >= 0) & (ts <= iv[np.maximum(i, 0), 1])
        out[name] = (float(dur[inside].sum()) / 1e6, len(iv),
                     float((iv[:, 1] - iv[:, 0]).sum()) / 1e6)
    return out, {k: tuple(v) for k, v in by_name.items()}, float(dur.sum()) / 1e6, len(kern)


def stage_device_ms(rp, film, stages):
    """One pass of rp under CPU and CUDA activity with the functions of
    `stages` (profile_pass.py) in record_function ranges: ({stage: (device
    ms, calls)}, the pass's device ms, its device events), by
    `stage_summary`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from profile_pass import staged

    unstage = staged(stages)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, n_rays = rp(film, 0, 0)
            int(n_rays)
            torch.cuda.synchronize()
    finally:
        unstage()
    st, _, dev_ms, n_k = stage_summary(prof)
    return {k: v[:2] for k, v in st.items()}, dev_ms, n_k


def walk_probes(mt, xml, dev, lanes):
    """Render xml (1 spp, seed 0) on dev with the manifold walk's
    newton_step spied on: (the image, {lane: per Newton step, whether each
    of its four chain traces reached its end: at x, the two
    forward-difference probes, the trial point}) for each of `lanes`
    (pixel y * width + x at 1 spp)."""
    from mitsuba_tpu_torch.integrator import manifold as mf

    steps = {lane: [] for lane in lanes}
    step = mf.newton_step

    def spy(res, x, eps):
        oks = []

        def res_seen(xx):
            e, ok = res(xx)
            oks.append(ok[lanes].tolist())
            return e, ok

        x1 = step(res_seen, x, eps)
        for j, lane in enumerate(lanes):
            steps[lane].append([o[j] for o in oks])
        return x1

    mf.newton_step = spy
    try:
        img = mt.render(mt.load_scene_string(xml), spp=1, seed=0, device=dev)
    finally:
        mf.newton_step = step
    return img, steps


def slice_throughput(mt, make_render_pass, new_film, scene, pack, counted, card, dev, label,
                     stages=None, arms=(), nested=(), extra=None):
    """A scene of the motion slice or of the fiber media through `render`
    with its default device, in render's passes of DEFAULT_LANES_PER_PASS
    lanes' worth of samples (MOTION and MOTION_BIG: 512x512 as 2 passes
    of 8 spp; FIBER: 256x256 as one pass of 32), the launch counters set
    to 0 just before: seconds, rays/s, peak device memory, launches, and
    extra()'s counts (each must be above 0).  With `stages`
    (profile_pass.py), one more pass under the profiler (CUDA activity):
    busy share and kernels per pass; and a pass of 1 spp under CPU and
    CUDA activity with the stages' ranges: the device ms and calls of
    `arms` and of `nested` (stages inside the arms), each of which must
    run, and the arms' share of that pass's device time.  Returns the
    render's launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mitsuba_tpu_torch.renderer import DEFAULT_LANES_PER_PASS

    rec = scene.sensor.record
    w, h, spp = rec.film.width, rec.film.height, rec.sampler.sample_count
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    img = mt.render(scene, pack=pack)  # the default device: the card
    sec = time.time() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    rays = int(mt.render.last_ray_count)
    counts = extra() if extra else {}
    counts_s = "".join(f"{n} {k.replace('_', ' ')}, " for k, n in counts.items())
    check(img.shape == (h, w, 3) and bool(np.isfinite(img).all()) and img.mean() > 0
          and all(n > 0 for n in counts.values()),
          f"the {label} image is not finite, or a count is 0: {counts}")
    spp_chunk = max(1, min(spp, DEFAULT_LANES_PER_PASS // (w * h)))
    out = {"scene": label, "width": w, "height": h, "spp": spp, "spp_chunk": spp_chunk,
           "seconds": sec, "rays": rays, "rays_per_s": rays / sec, **counts,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
           "mean": float(img.mean()), "card": card}
    line = (f"phase 4: {label} {w}x{h}, {spp} spp in passes of {spp_chunk}: {rays} rays in "
            f"{sec:.3f} s = {rays / sec:.6g} rays/s, {counts_s}peak device memory "
            f"{out['peak_gib']:.3f} GiB, launches {launches}")
    if stages is not None:
        rp = make_render_pass(pack, scene.integrator, rec, rec.film, rec.sampler, spp_chunk, dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            _, n_rays = rp(new_film(h, w, dev), spp, 0)
            int(n_rays)
            torch.cuda.synchronize()
            wall = time.time() - t0
        dev_ms, n_k = device_events(prof)
        rp1 = make_render_pass(pack, scene.integrator, rec, rec.film, rec.sampler, 1, dev)
        st, dev1_ms, _ = stage_device_ms(rp1, new_film(h, w, dev), stages)
        named = {k: st.get(k, (0.0, 0)) for k in arms + nested}
        check(all(n > 0 for _, n in named.values()),
              f"{label}: the profiled pass missed a stage: {named}")
        share = sum(named[k][0] for k in arms) / max(dev1_ms, 1e-9)
        out.update(profiled_wall_s=wall, device_ms=dev_ms, kernels_per_pass=n_k,
                   busy=dev_ms / 1e3 / wall, device_ms_1spp=dev1_ms,
                   stage_device_ms_1spp={k: v[0] for k, v in named.items()},
                   stage_calls_1spp={k: v[1] for k, v in named.items()}, arms_share=share)
        line += (f"; a profiled pass of {spp_chunk} spp: wall {wall:.4f} s, device {dev_ms:.3f} "
                 f"ms, busy share {out['busy']:.4f}, {n_k} kernels; in a profiled 1-spp pass "
                 f"(device {dev1_ms:.3f} ms) the stages (device ms, calls) "
                 f"{({k: (round(v[0], 3), v[1]) for k, v in named.items()})}: {', '.join(arms)} "
                 f"take {share:.4f} of its device time")
    print(line + f" on {card}", flush=True)
    print(json.dumps({"throughput": out}), flush=True)
    return launches


# INSTANCED's second group's mesh, and its instances along each side
INSTANCED_B_PLY = os.path.join(HERE, "build", "bunny_standin_b.ply")
INSTANCED_N = 32
# INSTANCED's instanced triangles: 512 x 69,168 + 512 x 17,160
INSTANCED_TRIS = 44_199_936
# samples per pixel of each of INSTANCED's two timed passes: a 1-spp pass
# takes ~23 s on an H100, ~70 % of it the loop path that finishes the rays
# past K_INST instance boxes (PERF.md), so that passes of 4 spp would not
# fit the script's time limit beside the earlier slices
INSTANCED_SPP = 1
# BIGBVH's film size and samples per pixel of its one pass, and the film
# size of its camera rays' sorted and unsorted intersect
# the depth of earlier phases' paths, cut so that the whole script, phase 6
# included, stays well inside its time limit: door's mutations per pixel
# (32 before), dispersion.xml's spp with 9 bins (its own 256 before)
DOOR_MUTATIONS = 16
DISPERSION_BINS_SPP = 64
BIGBVH_RES = 256
BIGBVH_RAYS_RES = 512
BIGBVH_SPP = 1
# the BVH route's golden scene packs no cluster tables below this budget
BVH_WALK_BUDGET = 1000


def instanced_setup(mt, pack_scene, dev, label="INSTANCED"):
    """INSTANCED (tests/torch_meshes.py instanced_xml: 1,024 instances of
    two stand-in groups, 512x512, path at maxDepth 8) packed on the card:
    past MTS_INSTANCE_EXPAND_MAX, so the two-level accelerator, with the
    splice's rows (float32 indices: under 2^24, ROADMAP C7), each group's
    clusters and the pack's seconds printed and checked.  Returns (scene,
    pack)."""
    from torch_meshes import bunny_standin, instanced_xml, write_ply

    from mitsuba_tpu_torch.scene.builder import SPLICE_EXACT_ROWS

    os.makedirs(os.path.dirname(INSTANCED_B_PLY), exist_ok=True)
    if not os.path.exists(STANDIN_PLY):
        write_ply(STANDIN_PLY, *bunny_standin(seed=0))
    write_ply(INSTANCED_B_PLY, *bunny_standin(seed=1, n_phi=132, n_theta=66))
    scene = mt.load_scene_string(instanced_xml(STANDIN_PLY, INSTANCED_B_PLY, n=INSTANCED_N))
    t0 = time.time()
    pack = pack_scene(scene, dev)
    sec = time.time() - t0
    m = pack.meta
    n_inst = m["n_instances"]
    counts = [c for _, c, _ in m["inst_groups"]]
    per_group = pack.inst_group[:n_inst].bincount(minlength=len(counts)).tolist()
    n_tris = sum(n * c for n, c in zip(per_group, counts))
    rows = pack.inst_nodes.shape[0]
    clusters = [dict(g)["n_clusters"] for _, _, g in m["inst_groups"]]
    print(f"  {label}: {n_inst} instances of {len(counts)} groups ({per_group} instances of "
          f"{counts} triangles in {clusters} clusters): {n_tris} instanced triangles; "
          f"{m['n_static_tris']} static rows; splice {rows} rows "
          f"({pack.inst_nodes.numel() * 4 / 2**30:.3f} GiB, under 2^24 = {SPLICE_EXACT_ROWS}); "
          f"packed in {sec:.2f} s", flush=True)
    check(m["has_instances"] and m["inst_pairs_ok"] and n_inst == INSTANCED_N ** 2
          and m["n_static_tris"] == 4 and not m["use_bvh"] and n_tris == INSTANCED_TRIS
          and rows < SPLICE_EXACT_ROWS,
          f"{label} does not pack into {INSTANCED_N ** 2} instances of {INSTANCED_TRIS} "
          "triangles through the accelerator, with a splice under 2^24 rows")
    return scene, pack


def instanced_queries(tpath, make_render_pass, new_film, scene, pack, dev):
    """INSTANCED's camera rays (t_max inf) and the NEE shadow rays of a
    pass's first bounce (one sample per pixel): [(label, o, d, t_max)]."""
    import torch

    o, d = camera_rays(scene, dev)
    rec = scene.sensor.record
    w, h = rec.film.width, rec.film.height
    got = capture_calls(tpath, ("occluded",), lambda: make_render_pass(
        pack, scene.integrator, rec, rec.film, rec.sampler, 1, dev)(new_film(h, w, dev), 0, 0),
                        lambda g: len(g) == 1)
    return [("camera", o, d, torch.full((o.shape[0],), float("inf"), device=dev)),
            ("NEE", *as_segment(got[0][1]))]


def instanced_segments(pairs, pb, pk, tlas, tis, queries, scene, pack, dev, stats, label):
    """K3/K4 (closest on the camera rays, closest and any on the NEE) and
    K7/K8 on their fallback batches, bit for bit against plain, on the
    template-space batches INSTANCED's pair path hands accel/pairs.py: per
    round of the instance lists and per group, the world rays re-based
    into each lane's instance (directions unnormalized), t_max 0 on the
    lanes of the other groups and rounds; then K1/K2 on its 4 static rows.
    Prints the overflow share of the instance lists (more than K_INST
    boxes) and of K3's lists over the lanes of each batch that hold a
    ray."""
    import torch

    ran = set()
    for (qlabel, o, d, t_max), any_hit in zip(queries, (False, True)):
        entry = "pair_any" if any_hit else "pair_closest"
        inst_fn = tlas.inst_any_pairs if any_hit else tlas.inst_closest_pairs
        inst_fn.rays = inst_fn.overflow_rays = 0
        fn = getattr(pairs, entry)
        fn.rays = fn.overflow_rays = 0
        got = capture_calls(pairs, (entry,), lambda: (
            tis.occluded(pack, o, d, t_max) if any_hit else tis.intersect(pack, o, d, t_max)))
        live = sum(int((args[3] > 0).sum()) for _, args in got)
        print(f"  {label} {qlabel}: {len(got)} template-space batches of {o.shape[0]} rays "
              f"(K_INST={tlas.K_INST} rounds x {len(pack.meta['inst_groups'])} groups), "
              f"{live} lanes holding a ray; instance lists: {inst_fn.overflow_rays} of "
              f"{inst_fn.rays} rays meet more than K_INST boxes "
              f"({inst_fn.overflow_rays / max(inst_fn.rays, 1):.4%}) and finish on the loop "
              f"path; K3: {fn.overflow_rays} of the {live} lanes overflow K={pairs.K} "
              f"({fn.overflow_rays / max(live, 1):.4%})", flush=True)
        check(len(got) == tlas.K_INST * len(pack.meta["inst_groups"]),
              f"{label} {qlabel}: {len(got)} pair batches")
        for k, (_, (gv, o2, d2, tm)) in enumerate(got):
            rd, gi = divmod(k, len(pack.meta["inst_groups"]))
            # a camera ray that left the scene has its shadow ray start at
            # infinity: K3 and its plain version part only on such
            # non-finite rays, whose results nothing reads (ROADMAP)
            fin = (torch.isfinite(o2).all(1) & torch.isfinite(d2).all(1)).nonzero().squeeze(1)
            if fin.numel() < o2.shape[0]:
                print(f"  {label} {qlabel} round {rd} group {gi}: {o2.shape[0] - fin.numel()} "
                      f"lanes with non-finite rays left out", flush=True)
            ran |= compare_segments(pairs, pb, gv, [(f"{label} {qlabel} round {rd} group {gi}",
                                                     o2[fin], d2[fin], tm[fin])], stats,
                                    plain_reps=1, any_hit=any_hit, retry=rd == 0)
    check(ran == {True, False}, f"no {label} batch reached K7 and K8")
    matpreview_brute(pk, scene, pack, dev, stats, label, n_expected=4)


# a hit whose smallest float64 barycentric lies within this many float32
# rounding scales of 0 sits on a triangle's edge, where the pair kernels'
# float32 Moller-Trumbore (csrc/ray_tri.cuh, pallas_kernels.mt_test) and
# the loop path's (intersect._moller_trumbore) may each leak through the
# seam between two triangles.  The scale is the float32 epsilon times the
# barycentrics' dot products' magnitudes over |det|: INSTANCED's camera
# sits ~20-40 units from triangles ~0.01 wide, where it reaches ~1e-3
EDGE_SCALES = 16


def edge_hit64(tis, tlas, pack, o, d, prim, inst):
    """(t, smallest barycentric, its float32 rounding scale) of each ray
    against its own triangle in float64: the ray taken into its
    instance's frame (inst >= 0) by the pack's inst_inv, Moller-Trumbore
    on the pack's float32 triangle rows (a barycentric below 0 is a miss
    by that much)."""
    import torch

    from mitsuba_tpu_torch.core import math as mm

    p = torch.clamp(prim, min=0).long()
    v0, e1, e2 = (pack.arrays[k][p].double() for k in ("tri_v0", "tri_e1", "tri_e2"))
    inv = pack.inst_inv[torch.clamp(inst, min=0).long()].double()
    on = (inst >= 0)[:, None]
    o2 = torch.where(on, tlas.matvec(inv[:, :9], o.double()) + inv[:, 9:], o.double())
    d2 = torch.where(on, tlas.matvec(inv[:, :9], d.double()), d.double())
    _, t, u, v = tis._moller_trumbore(o2, d2, v0, e1, e2, float("inf"))
    tvec, pvec = o2 - v0, mm.cross(d2, e2)
    qvec = mm.cross(tvec, e1)
    det = mm.dot(e1, pvec).abs()
    scale = 2.0 ** -24 * (tvec.norm(dim=-1) * pvec.norm(dim=-1)
                          + d2.norm(dim=-1) * qvec.norm(dim=-1)) / det
    return t, torch.minimum(torch.minimum(u, v), 1.0 - u - v), scale


def instanced_pair_vs_loop(tis, tlas, queries, pack, label, card):
    """The pair path against the loop path on INSTANCED's camera rays and
    NEE (intersect / occluded with MTS_TLAS_PAIRS unset and "0"), each
    path timed (host clock around a synchronised call).  Where the prims
    or instances differ, or the occlusion, the nearer hit (for the NEE:
    the occluding path's closest hit below t_max) must lie on a triangle's
    edge in float64: the two paths' float32 Moller-Trumbore
    forms leak through seams in different places (ROADMAP's known
    differences): within EDGE_SCALES float32 rounding scales of one.  t
    within rtol 1e-4 where the prims agree."""
    import torch

    def timed(fn, loop):
        saved = os.environ.pop("MTS_TLAS_PAIRS", None)
        if loop:
            os.environ["MTS_TLAS_PAIRS"] = "0"
        try:
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn()
            torch.cuda.synchronize()
            return out, 1e3 * (time.time() - t0)
        finally:
            os.environ.pop("MTS_TLAS_PAIRS", None)
            if saved is not None:
                os.environ["MTS_TLAS_PAIRS"] = saved

    def at_edges(hit, idx):
        """Each lane's hit (a Hit on those lanes) on a triangle's edge."""
        _, bary, scale = edge_hit64(tis, tlas, pack, o[idx], d[idx], hit.prim, hit.inst)
        return (hit.prim >= 0) & (bary.abs() < EDGE_SCALES * scale)

    out = {}
    for qlabel, o, d, t_max in queries:
        if qlabel == "camera":
            (hp, ms_p), (hl, ms_l) = (timed(lambda: tis.intersect(pack, o, d, t_max), loop)
                                      for loop in (False, True))
            diff = (hp.valid != hl.valid) | (hp.valid & ((hp.prim != hl.prim)
                                                        | (hp.inst != hl.inst)))
            same = hp.valid & ~diff
            rel = ((hp.t - hl.t).abs() / torch.clamp(hl.t.abs(), min=1e-30))[same]
            idx = diff.nonzero().squeeze(1)
            near = (hp.t <= hl.t)[idx]
            tie = ((hp.t - hl.t).abs() <= 1e-5 * torch.clamp(hl.t.abs(), min=1.0))[idx]
            pick = lambda h: type(h)(*[x[idx] if torch.is_tensor(x) else x for x in h])
            sp, sl = pick(hp), pick(hl)
            edge = torch.where(near, at_edges(sp, idx), at_edges(sl, idx)) & ~tie
            n_inst = int((hp.inst >= 0).sum())
            print(f"  {label} camera, pair path vs loop path: {int(hp.valid.sum())} hits "
                  f"({n_inst} on instances); prim or inst differ on {idx.numel()} rays: "
                  f"{int(tie.sum())} at a tie (t within 1e-5), {int(edge.sum())} where the "
                  f"nearer hit lies on a triangle's edge in float64 (the pair path's nearer on "
                  f"{int((near & edge).sum())}); t max rel diff where they agree "
                  f"{float(rel.max()) if rel.numel() else 0.0:.3g}; pair path {ms_p:.1f} ms, "
                  f"loop path {ms_l:.1f} ms on {card}", flush=True)
            odd = (~edge & ~tie).nonzero().squeeze(1)
            for k in odd[:8].tolist():
                j = idx[k:k + 1]
                tb = [edge_hit64(tis, tlas, pack, o[j], d[j], h.prim[j], h.inst[j])
                      for h in (hp, hl)]
                print(f"    ray {int(j)}: pair prim {int(hp.prim[j])} inst {int(hp.inst[j])} t "
                      f"{float(hp.t[j]):.7g} (float64 t {float(tb[0][0]):.7g}, smallest "
                      f"barycentric {float(tb[0][1]):.3g}, rounding scale {float(tb[0][2]):.3g});"
                      f" loop prim {int(hl.prim[j])} inst {int(hl.inst[j])} t "
                      f"{float(hl.t[j]):.7g} (float64 t {float(tb[1][0]):.7g}, "
                      f"{float(tb[1][1]):.3g}, {float(tb[1][2]):.3g})", flush=True)
            check(not odd.numel() and (not rel.numel() or float(rel.max()) < 1e-4)
                  and n_inst > o.shape[0] // 4,
                  f"{label} camera: the pair and loop paths disagree off triangle edges")
        else:
            (op, ms_p), (ol, ms_l) = (timed(lambda: tis.occluded(pack, o, d, t_max), loop)
                                      for loop in (False, True))
            idx = (op != ol).nonzero().squeeze(1)
            occluder = torch.zeros(idx.numel(), dtype=torch.bool, device=o.device)
            for loop in (False, True):  # the occluding path's closest hit
                mine = (ol if loop else op)[idx]
                if bool(mine.any()):
                    h, _ = timed(lambda: tis.intersect(pack, o[idx], d[idx], t_max[idx]), loop)
                    occluder |= mine & at_edges(h, idx)
            print(f"  {label} NEE, pair path vs loop path: {int(op.sum())} of {o.shape[0]} "
                  f"occluded; {idx.numel()} differ ({int((op & ~ol).sum())} occluded by the "
                  f"pair path alone), the occluder on a triangle's edge in float64 on "
                  f"{int(occluder.sum())}; pair path {ms_p:.1f} ms, loop path {ms_l:.1f} ms on "
                  f"{card}", flush=True)
            check(bool(occluder.all()), f"{label} NEE: the pair and loop paths disagree off "
                                        "triangle edges")
        out[qlabel] = {"pair_ms": ms_p, "loop_ms": ms_l, "differ": idx.numel()}
    print(json.dumps({"pair_vs_loop": {"scene": label, "rays": queries[0][1].shape[0],
                                       "instances": pack.meta["n_instances"], **out,
                                       "card": card}}), flush=True)


def extras_goldens(mt, counted, dev, feature_dir, clusters):
    """The geometry extras' goldens on the card, each at its GOLDEN_GATES
    gate, the launch counters set to 0 just before each render: the
    instancing scene copied into rows (K1/K2), through the accelerator's
    pair path (K1/K2 on the floor and light, K3/K4 per group) and its loop
    path (MTS_TLAS_PAIRS=0), the two-group scene, the shapes gallery
    (K3/K4), and the BVH walk with the cluster budget lowered (no kernel
    of the pair pipeline).  Returns the launches summed."""
    from torch_meshes import (
        bunny_scene_xml,
        bvh_walk_mesh,
        instancing_two_group_xml,
        instancing_xml,
        shape_assets,
        shapes_gallery_xml,
        write_ply,
    )

    walk_ply = os.path.join(HERE, "build", "bvh_walk.ply")
    write_ply(walk_ply, *bvh_walk_mesh())
    shape_assets(feature_dir)
    tlas_env = {"MTS_INSTANCE_EXPAND_MAX": "0"}
    total = {}
    for label, xml, golden, env, budget, must in (
            ("instancing (rows)", instancing_xml(), "torch_instancing_32_4.npy", {}, None,
             ("closest_hit_v2", "any_hit_v2")),
            ("instancing (pair path)", instancing_xml(), "torch_instancing_tlas_32_4.npy",
             tlas_env, None, ("closest_hit_v2", "any_hit_v2", "dense_cull", "pair_hit_closest",
                              "pair_hit_any")),
            ("instancing (loop path)", instancing_xml(), "torch_instancing_tlas_32_4.npy",
             {**tlas_env, "MTS_TLAS_PAIRS": "0"}, None, ("closest_hit_v2", "any_hit_v2")),
            ("instancing, two groups", instancing_two_group_xml(feature_dir),
             "torch_instancing_two_group_32_4.npy", tlas_env, None,
             ("dense_cull", "pair_hit_closest", "pair_hit_any")),
            ("shapes gallery", shapes_gallery_xml(feature_dir), "torch_shapes_gallery_32_4.npy",
             {}, None, ("dense_cull", "pair_hit_closest", "pair_hit_any")),
            ("BVH walk", bunny_scene_xml(walk_ply, 32, 32), "torch_bvh_walk_32_4.npy", {},
             BVH_WALK_BUDGET, ())):
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        budget_saved = clusters.CLUSTER_HBM_MAX
        if budget is not None:
            clusters.CLUSTER_HBM_MAX = budget
        try:
            scene = mt.load_scene_string(xml)
            got = render_checked(mt, counted, scene, os.path.join(HERE, "tests", "golden", golden),
                                 dev, label, spp=4)
        finally:
            clusters.CLUSTER_HBM_MAX = budget_saved
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        for k in must:
            check(got[k] > 0, f"the {label} render never launched {k}")
        if budget is not None:
            check(not any(got.values()), f"the {label} render launched a kernel: {got}")
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
    return total


def instanced_throughput(mt, scene, pack, counted, tlas, card, spp=INSTANCED_SPP,
                         passes=1):
    """INSTANCED through `render` at its film size: `passes` timed renders
    of `spp` samples per pixel, the launch counters set to 0 just before
    each (phases 2 and 3 ran every part of the route on this pack: no
    warm-up render): seconds, rays/s, peak device memory, launches and
    the instance lists' overflow per pass.  Returns the launches summed."""
    import numpy as np
    import torch

    rec = scene.sensor.record
    w, h = rec.film.width, rec.film.height
    total = {}
    for i in range(passes):
        for fn in counted.values():
            fn.launches = 0
        for fn in (tlas.inst_closest_pairs, tlas.inst_any_pairs):
            fn.rays = fn.overflow_rays = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        img = mt.render(scene, spp=spp, seed=i + 1, pack=pack)
        sec = time.time() - t0
        rays = int(mt.render.last_ray_count)
        launches = {k: fn.launches for k, fn in counted.items()}
        check(img.shape == (h, w, 3) and bool(np.isfinite(img).all()) and img.mean() > 0,
              "the INSTANCED image is not finite")
        ov = {n: (fn.overflow_rays, fn.rays) for n, fn in (
            ("closest", tlas.inst_closest_pairs), ("any", tlas.inst_any_pairs))}
        out = {"scene": "INSTANCED", "width": w, "height": h, "spp": spp, "pass": i + 1,
               "seconds": sec, "rays": rays, "rays_per_s": rays / sec,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
               "inst_overflow": ov, "mean": float(img.mean()), "card": card}
        print(f"phase 4: INSTANCED {w}x{h}, pass {i + 1} of {spp} spp through render: {rays} "
              f"rays in {sec:.3f} s = {rays / sec:.6g} rays/s, peak device memory {out['peak_gib']:.3f} GiB, launches {launches}, instance lists "
              f"past K_INST (rays, of) {ov} on {card}", flush=True)
        print(json.dumps({"throughput": out}), flush=True)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total


def bigbvh_throughput(mt, tis, pack_scene, counted, dev, card):
    """BIGBVH (tests/torch_meshes.py bigbvh_xml: four copies of the dense
    stand-in, 3,481,920 triangles, past the cluster budget): packed without
    cluster tables; one intersect of its 262,144 camera rays at 512x512
    with sort=True beside sort=False (equal, both timed); one render of BIGBVH_SPP samples at
    BIGBVH_RES^2 through render, which launches none of the port's
    kernels: seconds, rays/s, peak device memory."""
    import numpy as np
    import torch
    from torch_meshes import bigbvh_xml, dense_standin, write_ply

    if not os.path.exists(DENSE_PLY):
        write_ply(DENSE_PLY, *dense_standin(seed=0))
    scene = mt.load_scene_string(bigbvh_xml(DENSE_PLY, BIGBVH_RES, BIGBVH_RES))
    t0 = time.time()
    pack = pack_scene(scene, dev)
    m = pack.meta
    print(f"  BIGBVH: {m['n_tris']} triangles, BVH of {pack.bvh_nodes.shape[0]} node rows in "
          f"{m['bvh_n_layouts']} layout(s), clusters {m.get('n_clusters', 0)}; packed in "
          f"{time.time() - t0:.2f} s", flush=True)
    check(m["use_bvh"] and m.get("n_clusters", 0) == 0 and m["n_tris"] == 4 * 870_480,
          "BIGBVH does not pack 3,481,920 triangles without cluster tables")
    film = scene.sensor.record.film
    film.width = film.height = BIGBVH_RAYS_RES  # 262,144 camera rays
    o, d = camera_rays(scene, dev)
    film.width = film.height = BIGBVH_RES
    times = {}
    for sort in (False, True):
        torch.cuda.synchronize()
        t0 = time.time()
        hit = tis.intersect(pack, o, d, sort=sort)
        torch.cuda.synchronize()
        times.setdefault(sort, []).append(1e3 * (time.time() - t0))
        if sort:
            check(all(torch.equal(a, b) for a, b in zip(
                (hit.t, hit.prim, hit.u, hit.v), (ref.t, ref.prim, ref.u, ref.v))),
                "BIGBVH: intersect with sort=True differs from sort=False")
        else:
            ref = hit
    print(f"  BIGBVH: intersect of {o.shape[0]} camera rays ({int(ref.valid.sum())} hits): "
          f"sort=False {[round(t, 1) for t in times[False]]} ms, sort=True "
          f"{[round(t, 1) for t in times[True]]} ms (equal) on {card}", flush=True)
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    img = mt.render(scene, spp=BIGBVH_SPP, seed=0, pack=pack)
    sec = time.time() - t0
    rays = int(mt.render.last_ray_count)
    launches = {k: fn.launches for k, fn in counted.items()}
    check(bool(np.isfinite(img).all()) and img.mean() > 0 and not any(launches.values()),
          f"the BIGBVH image is not finite, or it launched a kernel: {launches}")
    out = {"scene": "BIGBVH", "width": BIGBVH_RES, "height": BIGBVH_RES, "spp": BIGBVH_SPP,
           "seconds": sec, "rays": rays, "rays_per_s": rays / sec,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "intersect_ms": {"sort": times[True], "unsorted": times[False]}, "card": card}
    print(f"phase 4: BIGBVH {BIGBVH_RES}x{BIGBVH_RES}, one pass of {BIGBVH_SPP} spp through "
          f"render: {rays} rays in {sec:.3f} s = {rays / sec:.6g} rays/s, peak device memory "
          f"{out['peak_gib']:.3f} GiB on {card}", flush=True)
    print(json.dumps({"throughput": out}), flush=True)


def run_cli(args, label):
    """Run `python <args>` from the checkout's root; returns (its standard
    output, wall seconds).  Fails on a non-zero exit."""
    env = {**os.environ, "PYTHONPATH": HERE + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.time()
    out = subprocess.run([sys.executable, *args], cwd=HERE, env=env, capture_output=True,
                         text=True, timeout=300)
    wall = time.time() - t0
    check(out.returncode == 0, f"{label} exited {out.returncode}: {out.stderr[-2000:]}")
    return out.stdout, wall


# runs `python -m mitsuba_tpu_torch <arguments>` as -m runs it (runpy, the
# package's __main__) with every kernel wrapper's count set to 0 just
# before, then prints the CLI's own launches on a last line of its own
CLI_COUNTED = """
import json, runpy, sys
from mitsuba_tpu_torch.tools import _kernel_wrappers
wrappers = _kernel_wrappers()
for fn in wrappers.values():
    fn.launches = 0
try:
    runpy.run_module("mitsuba_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    if e.code:
        raise
print("launches", json.dumps({k: fn.launches for k, fn in wrappers.items() if fn.launches}))
"""


def zeroed(counted):
    """Set the given launch counters to 0; returns them."""
    for fn in counted.values():
        fn.launches = 0
    return counted


def read_launches(counted, into, names, label):
    """The counters' launches since they were set to 0, added to `into`;
    fails unless each of `names` launched."""
    got = {k: fn.launches for k, fn in counted.items()}
    for k in names:
        check(got[k] > 0, f"{label} never launched {k}")
    for k, n in got.items():
        into[k] = into.get(k, 0) + n
    return got


def peak_gib(fn):
    """(fn's result, the device memory it allocated at its peak above what
    was allocated before it, GiB)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = fn()
    torch.cuda.synchronize()
    return res, (torch.cuda.max_memory_allocated() - base) / 2**30


def host_phase(mt, brute, cluster_counted, big, big_pack, dev, card):
    """The host side (phase 5): the CLI, checkpoint and resume, the
    out-of-core film, lanes_per_pass, kdbench and the .mtspack round trip.
    Returns the launches of the paths it drives, each read from its own run
    with the counters set to 0 just before it: the CLI's (read in its
    process), the checkpointed and resumed renders', the tiled film's, each
    lane budget's, kdbench's timed calls' and the loaded packs' renders."""
    import ast

    import numpy as np
    import torch
    from mitsuba_tpu_torch.io.exr import read_exr
    from mitsuba_tpu_torch.renderer import band_plan
    from mitsuba_tpu_torch.scene.serialize import load_pack, save_pack
    from mitsuba_tpu_torch.scene.builder import pack_scene
    from torch_meshes import bunny_scene_xml, cbox_mitchell_xml, smoke_xml

    launches = {}
    out_dir = os.path.join(HERE, "build", "host")
    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.empty_cache()  # room for the subprocesses
    # the CLI at the scene's own 512x512, 64 spp, against render in process
    exr = os.path.join(out_dir, "cbox.exr")
    stdout, wall = run_cli(["-c", CLI_COUNTED, CBOX, "-s", "64", "-o", exr], "the CLI")
    lines = stdout.strip().splitlines()
    cli = json.loads(lines[-1].split("launches", 1)[1])
    for k in brute:
        check(cli.get(k, 0) > 0, f"the CLI never launched {k}")
    for k, n in cli.items():
        launches[k] = launches.get(k, 0) + n
    written, _ = read_exr(exr)
    scene = mt.load_scene(CBOX)
    t0 = time.time()
    img = mt.render(scene, spp=64, seed=0, device=dev)
    render_s = time.time() - t0
    diff = float(np.abs(written - img.astype(np.float16).astype(np.float32)).max())
    print(f"phase 5: CLI cbox 512x512, 64 spp: {lines[-2].strip()}; wall {wall:.2f} s with the "
          f"process's start; the CLI's launches {cli}; the EXR against render in process "
          f"({render_s:.2f} s) after half rounding: largest difference {diff:.6g} on {card}",
          flush=True)
    check(written.shape == img.shape and diff == 0.0, "the CLI's EXR differs from render's image")
    # checkpoint: stop after pass 4 of 8, resume, and hold to the whole render
    ck = os.path.join(out_dir, "cbox_ck.npz")
    if os.path.exists(ck):
        os.remove(ck)

    class Stop(Exception):
        pass

    def interrupt(i, n):
        if i == n // 2:
            raise Stop

    zeroed(brute)
    try:
        mt.render(scene, spp=64, seed=0, device=dev, checkpoint=ck, checkpoint_every=1,
                  progress=interrupt)
        check(False, "the interrupted render was not interrupted")
    except Stop:
        pass
    before = read_launches(brute, launches, brute, "the interrupted render")
    done = int(np.load(ck)["passes_done"])
    zeroed(brute)
    t0 = time.time()
    resumed = mt.render(scene, spp=64, seed=0, device=dev, checkpoint=ck, checkpoint_every=1)
    resumed_s = time.time() - t0
    after = read_launches(brute, launches, brute, "the resumed render")
    diff = float(np.abs(resumed - img).max())
    print(f"phase 5: checkpoint cbox 512x512, 64 spp: interrupted after pass {done} of 8 "
          f"(launches {before}), resumed in {resumed_s:.2f} s (launches {after}); largest "
          f"difference to the uninterrupted render {diff:.6g}", flush=True)
    check(done == 4 and diff == 0.0, "the resumed render differs from the uninterrupted one")
    # the out-of-core film against hdrfilm, both under mitchell (the batched
    # splat), 8 spp; the tiled film in passes of 1 << 17 lanes: 3 bands
    hdr_scene = mt.load_scene_string(cbox_mitchell_xml(), base_dir=os.path.dirname(CBOX))
    tiled_scene = mt.load_scene_string(cbox_mitchell_xml().replace('type="hdrfilm"',
                                                                   'type="tiledhdrfilm"'),
                                       base_dir=os.path.dirname(CBOX))
    check(tiled_scene.sensor.record.film.out_of_core, "tiledhdrfilm did not load out of core")
    t0 = time.time()
    ref, ref_gib = peak_gib(lambda: mt.render(hdr_scene, spp=8, seed=0, device=dev))
    ref_s = time.time() - t0
    zeroed(brute)
    t0 = time.time()
    tiled, tiled_gib = peak_gib(lambda: mt.render(tiled_scene, spp=8, seed=0, device=dev,
                                                  lanes_per_pass=1 << 17))
    tiled_s = time.time() - t0
    tiled_launches = read_launches(brute, launches, brute, "tiledhdrfilm")
    hb, pad, n_bands, chunk, passes = band_plan(tiled_scene.sensor.record.film, 8, 1 << 17)
    rel = float(np.abs(np.asarray(tiled) - ref).max() / max(np.abs(ref).max(), 1e-30))
    print(f"phase 5: tiledhdrfilm cbox 512x512 mitchell, 8 spp: {n_bands} bands of {hb} rows "
          f"(halo {pad}), {passes} passes of {chunk} spp each, {tiled_s:.2f} s, peak "
          f"{tiled_gib:.3f} GiB, launches {tiled_launches}; hdrfilm {ref_s:.2f} s, peak "
          f"{ref_gib:.3f} GiB; largest difference {rel:.3g} of the image's largest value "
          f"(rtol 1e-4)", flush=True)
    check(isinstance(tiled, np.memmap) and n_bands > 1, "tiledhdrfilm did not render in bands")
    check(np.allclose(np.asarray(tiled), ref, rtol=1e-4, atol=1e-4),
          "tiledhdrfilm differs from hdrfilm")
    # lanes_per_pass: smoke as it stands (192x192) at 28 spp, one pass of
    # 1,032,192 lanes at 1 << 21 and four of 7 spp at 1 << 18 (at its 32
    # spp, 1 << 18 lanes would render 5 passes of 7 spp, 35 in all)
    smoke = mt.load_scene_string(smoke_xml())
    runs = {}
    for lanes in (1 << 21, 1 << 18):
        zeroed(cluster_counted)
        t0 = time.time()
        img_l, gib = peak_gib(lambda: mt.render(smoke, spp=28, seed=0, device=dev,
                                                lanes_per_pass=lanes))
        sec = time.time() - t0
        # K3/K4 must launch; K7 only on the rays that overflow K3's 3 clusters
        got = read_launches(cluster_counted, launches, ("dense_cull", "pair_hit_closest"),
                            f"smoke at {lanes} lanes")
        runs[lanes] = (img_l, gib, sec, got)
    (a, gib_a, s_a, n_a), (b, gib_b, s_b, n_b) = runs[1 << 21], runs[1 << 18]
    rel = float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))
    print(f"phase 5: lanes_per_pass smoke 192x192, 28 spp: 1 << 21 lanes {s_a:.2f} s, peak "
          f"{gib_a:.3f} GiB, launches {n_a}; 1 << 18 lanes {s_b:.2f} s, peak {gib_b:.3f} GiB, "
          f"launches {n_b}; largest difference {rel:.3g} of the image's largest value (rtol "
          f"1e-4: the order of the float sums)", flush=True)
    check(np.allclose(a, b, rtol=1e-4, atol=1e-5) and gib_b < gib_a,
          "the two lane budgets disagree, or the smaller one did not take less memory")
    # kdbench on the 69k stand-in: 10M random rays, then coherent ones
    xml = os.path.join(out_dir, "bunny_standin.xml")
    with open(xml, "w") as f:
        f.write(bunny_scene_xml(STANDIN_PLY))
    for extra in ([], ["--coherent"]):
        stdout, wall = run_cli(["-m", "mitsuba_tpu_torch.tools", "kdbench", xml, *extra],
                               "kdbench")
        lines = stdout.strip().splitlines()
        got = ast.literal_eval(lines[-1].split("launches", 1)[1].strip())
        print(f"phase 5: {lines[-2].strip()}; wall {wall:.2f} s with the process's start and the "
              f"pack; launches over the timed calls {got}", flush=True)
        check(got.get("dense_cull", 0) > 0 and got.get("pair_hit_closest", 0) > 0,
              "kdbench did not run the pair pipeline")
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
    # the .mtspack round trip: cbox's and the stand-in's packs saved, loaded
    # onto the card, and rendered against the fresh packs
    for label, sc, fresh, counted, names in (
            ("cbox", scene, None, brute, tuple(brute)),
            ("stand-in", big, big_pack, cluster_counted, ("dense_cull", "pair_hit_closest"))):
        fresh = fresh if fresh is not None else pack_scene(sc, dev)
        path = os.path.join(out_dir, f"{label}.mtspack")
        save_pack(fresh, path)
        loaded = load_pack(path, device=dev)
        a = mt.render(sc, spp=4, seed=0, device=dev, pack=fresh)
        zeroed(counted)
        b = mt.render(sc, spp=4, seed=0, device=dev, pack=loaded)
        got = read_launches(counted, launches, names, f"the loaded {label} pack's render")
        print(f"phase 5: .mtspack {label}: {os.path.getsize(path)} bytes, render from the loaded "
              f"pack equal to the fresh pack's: {np.array_equal(a, b)} (largest difference "
              f"{float(np.abs(a - b).max()):.6g}); launches {got}", flush=True)
        check(np.array_equal(a, b), f"{label}: the loaded pack renders otherwise")
    return launches


# ---- phase 6: the parallel slice (parallel/ and the port's entry) ----

PARALLEL_DIR = os.path.join(HERE, "build", "parallel")
RANK_TIMEOUT_S = 300.0
# sppm's photons a pass in phase 6's sharded render (its unsharded twin
# passes the same count)
PARALLEL_SPPM_PHOTONS = 8192


def rel_rmse(a, b):
    """RMSE of a against b over b's mean magnitude (tests/conftest.py)."""
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(float(np.abs(b).mean()), 1e-6))


def gloo_pair_rank(rank, world, init_method, out_dir):
    """Phase 6 (b): one of `world` ranks on cuda:0 over gloo (NCCL takes
    one rank per card): cbox at 512x512, 16 spp, through render_sharded
    after a 2-spp warm-up, its film all-reduced as CUDA tensors.  Before
    it, rank 0 renders the same on a world of one while the others wait,
    so that one rank's rays/s are taken in a fresh process too.  Writes
    the image, the seconds, the rays of all ranks, this rank's K1/K2
    launches and rank 0's world-of-one seconds and rays to
    out_dir/rank<r>.npz."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch.accel import pallas_kernels as pk
    from mitsuba_tpu_torch.parallel.mesh import (
        Mesh,
        destroy_world,
        init_world,
        make_mesh,
        render_sharded,
    )

    def timed(mesh_):
        torch.cuda.synchronize()
        t0 = time.time()
        img_ = render_sharded(scene, mesh=mesh_, spp=16)
        torch.cuda.synchronize()
        return img_, time.time() - t0, render_sharded.last_ray_count

    init_world("gloo", init_method, world, rank, timeout_s=RANK_TIMEOUT_S)
    try:
        mesh = make_mesh(device="cuda:0", backend="gloo")
        scene = mt.load_scene(CBOX)
        render_sharded(scene, mesh=mesh, spp=2)
        one_s = one_rays = 0
        torch.distributed.barrier()
        if rank == 0:
            _, one_s, one_rays = timed(Mesh(None, 0, 1, mesh.device, None))
        torch.distributed.barrier()
        for fn in (pk.closest_hit_v2, pk.any_hit_v2):
            fn.launches = 0
        img, sec, rays = timed(mesh)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), img=img, sec=sec, rays=rays,
                 k1=pk.closest_hit_v2.launches, k2=pk.any_hit_v2.launches, one_s=one_s,
                 one_rays=one_rays)
    finally:
        destroy_world()


def sharded_pass_builder(make_sharded_render_pass, mesh):
    """A make_render_pass stand-in whose pass is the sharded one on `mesh`
    (for pair_segments' capture of a pass's first NEE query)."""
    def build(pack, integ, rec, film_rec, sampler, spp_chunk, dev):
        return make_sharded_render_pass(pack, integ, rec, film_rec, sampler, spp_chunk, mesh)
    return build


def parallel_phase(mt, pk, pairs, pb, tpath, brute, cluster_counted, dev, card, stats):
    """The parallel slice (phase 6), on one card:

    (a) an NCCL world of one (a file store in a temporary directory):
        render_sharded of cbox at 512x512, 16 spp, against render's image
        (its largest difference: 0, or the order of the film's sums), with
        K1/K2 bit for bit against plain on the sharded pass's camera rays
        and first NEE rays; the 69k stand-in at 256x256, 4 spp, through
        K3/K4/K7/K8 (bit for bit on the sharded pass's queries); bdpt,
        sppm, ptracer, vpl and pssmlt small renders against their
        unsharded renders at the CPU tests' gates;
    (b) two spawned ranks on cuda:0 over gloo: cbox at 512x512, 16 spp,
        within rel RMSE 1e-4 of (a)'s image, and both ranks' rays/s;
    (c) elastic: a SimulatedFault at pass 3 of 8 with a checkpoint every 2
        passes re-queues passes 2..7 and gives the uninterrupted image bit
        for bit;
    (d) the render service: two workers on cuda:0, one killed once its
        first unit has arrived; the film equals the local pass loop's bit
        for bit;
    (e) the multi-host CLI with --num-hosts 1: its EXR equals
        render_to_file's;
    (f) entry() on the card.

    Each part's seconds are printed; every child process has a time
    limit.  Returns the launches of the paths it drives, each read from
    its own run with the counters set to 0 just before it."""
    import shutil
    import signal
    import tempfile

    import numpy as np
    import torch
    from mitsuba_tpu_torch.entry import entry
    from mitsuba_tpu_torch.film.film import new_film
    from mitsuba_tpu_torch.integrator.pssmlt import render_pssmlt
    from mitsuba_tpu_torch.integrator.sppm import render_sppm
    from mitsuba_tpu_torch.io.exr import read_exr
    from mitsuba_tpu_torch.parallel import elastic
    from mitsuba_tpu_torch.parallel.mesh import (
        destroy_world,
        init_world,
        make_mesh,
        make_sharded_render_pass,
        render_sharded,
        spawn_ranks,
    )
    from mitsuba_tpu_torch.parallel.service import RenderService
    from mitsuba_tpu_torch.renderer import render_to_file
    from mitsuba_tpu_torch.scene.builder import pack_scene
    from torch_meshes import bunny_scene_xml, cbox_chain_xml, cbox_xml

    launches = {}
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    os.makedirs(PARALLEL_DIR)
    torch.cuda.empty_cache()  # room for the ranks and workers
    t_phase = time.time()

    # (a) an NCCL world of one
    t0 = time.time()
    store = tempfile.mkdtemp(prefix="nccl_", dir=PARALLEL_DIR)
    init_world("nccl", f"file://{store}/store", 1, 0, device=dev, timeout_s=RANK_TIMEOUT_S)
    try:
        mesh = make_mesh(device=dev, backend="nccl")
        check(mesh.group is not None and (mesh.rank, mesh.world) == (0, 1),
              f"the NCCL world of one is {mesh}")
        scene = mt.load_scene(CBOX)
        ref = mt.render(scene, spp=16, seed=0, device=dev)
        render_sharded(scene, mesh=mesh, spp=2)  # warm-up, as (b)'s ranks do
        zeroed(brute)
        t1 = time.time()
        a_img = render_sharded(scene, mesh=mesh, spp=16)
        torch.cuda.synchronize()
        a_s = time.time() - t1
        a_rays = render_sharded.last_ray_count
        got = read_launches(brute, launches, brute, "the sharded cbox render")
        diff = float(np.abs(a_img - ref).max())
        print(f"phase 6 (a): NCCL world of one, render_sharded cbox 512x512, 16 spp: {a_s:.3f} s, "
              f"{a_rays} rays = {a_rays / a_s:.6g} rays/s, launches {got} (2 passes); largest "
              f"difference to render {diff:.6g}, rel RMSE {rel_rmse(a_img, ref):.3g} on {card}",
              flush=True)
        check(rel_rmse(a_img, ref) < 1e-4, "the sharded cbox render differs from render's")
        # K1/K2 on the sharded pass's camera rays and its first NEE query
        pack = pack_scene(scene, dev)
        rec = scene.sensor.record
        n_box = int((pack.tri_t[0] < FAR_V0).sum())
        o, d = camera_rays(scene, dev)
        compare_brute(pk, "closest_hit_v2", o, d, torch.full((o.shape[0],), 1e30, device=dev),
                      pack.tri_s, n_box, stats, exact=True)
        rp = make_sharded_render_pass(pack, scene.integrator, rec, rec.film, rec.sampler, 8, mesh)
        seg = capture_calls(tpath, ("occluded",),
                            lambda: rp(new_film(rec.film.height, rec.film.width, dev), 0, 0),
                            lambda g: len(g) == 1)
        compare_brute(pk, "any_hit_v2", *as_segment(seg[0][1]), pack.tri_s, n_box, stats,
                      exact=True)
        # the 69k stand-in through the pair pipeline
        big = mt.load_scene_string(bunny_scene_xml(STANDIN_PLY, 256, 256))
        zeroed(cluster_counted)
        big_img = render_sharded(big, mesh=mesh, spp=4)
        got = read_launches(cluster_counted, launches, ("dense_cull", "pair_hit_closest",
                                                        "pair_hit_any", "cluster_traverse_closest",
                                                        "cluster_traverse_any"),
                            "the sharded stand-in render")
        big_ref = mt.render(big, spp=4, seed=0, device=dev)
        print(f"phase 6 (a): render_sharded 69k stand-in 256x256, 4 spp (1 pass): launches {got}; "
              f"largest "
              f"difference to render {float(np.abs(big_img - big_ref).max()):.6g}, rel RMSE "
              f"{rel_rmse(big_img, big_ref):.3g}", flush=True)
        check(rel_rmse(big_img, big_ref) < 1e-4, "the sharded stand-in differs from render's")
        big_pack = pack_scene(big, dev)
        pair_segments(pairs, pb, tpath, sharded_pass_builder(make_sharded_render_pass, mesh),
                      new_film, big, big_pack, dev, stats, "sharded stand-in")
        # the other families, each against its unsharded render
        os.environ["MTS_SPPM_PHOTONS"] = str(PARALLEL_SPPM_PHOTONS)
        families = (
            ("bdpt", cbox_xml("bdpt", 64, 64, 4), 8, 2, 1e-4, mt.render),
            ("sppm", cbox_xml("sppm", 64, 64, 6), 2, 1, 0.05,
             lambda s, **kw: render_sppm(s, photons_per_pass=PARALLEL_SPPM_PHOTONS, **kw)),
            ("ptracer", cbox_xml("ptracer", 64, 64), 8, 0, 1e-4, mt.render),
            ("vpl", cbox_xml("vpl", 64, 64, 4), 8, 1, 1e-4, mt.render),
            ("pssmlt", cbox_chain_xml("pssmlt", 32, 32), 4, 0, None, render_pssmlt),
        )
        for kind, xml, spp, seed, gate, unsharded in families:
            zeroed(brute)
            t1 = time.time()
            img = render_sharded(mt.load_scene_string(xml), mesh=mesh, spp=spp, seed=seed)
            sec = time.time() - t1
            got = read_launches(brute, launches, brute, f"the sharded {kind} render")
            ref_k = unsharded(mt.load_scene_string(xml), spp=spp, seed=seed, device=dev)
            err = rel_rmse(img, ref_k)
            big_err = float(np.abs(img - ref_k).max() / np.abs(ref_k).max())
            print(f"phase 6 (a): render_sharded {kind}: {sec:.3f} s, launches {got}; rel RMSE "
                  f"{err:.3g}, largest difference {big_err:.3g} of the image's largest value "
                  f"(gate {'rel RMSE %g' % gate if gate else 'largest 1e-5'})", flush=True)
            check(np.isfinite(img).all() and (err < gate if gate else big_err <= 1e-5),
                  f"the sharded {kind} render differs from its unsharded render")
    finally:
        destroy_world()
    print(f"phase 6 (a): {time.time() - t0:.2f} s", flush=True)

    # (b) two ranks on cuda:0 over gloo
    t0 = time.time()
    out = tempfile.mkdtemp(prefix="gloo_", dir=PARALLEL_DIR)
    spawn_ranks(gloo_pair_rank, 2, (f"file://{out}/store", out), RANK_TIMEOUT_S)
    ranks = [np.load(os.path.join(out, f"rank{r}.npz")) for r in range(2)]
    b_s = max(float(r["sec"]) for r in ranks)
    b_rays = int(ranks[0]["rays"])
    err = rel_rmse(ranks[0]["img"], a_img)
    one_s, one_rays = float(ranks[0]["one_s"]), int(ranks[0]["one_rays"])
    print(f"phase 6 (b): two gloo ranks on cuda:0, render_sharded cbox 512x512, 16 spp: "
          f"{b_s:.3f} s (rank seconds {[round(float(r['sec']), 3) for r in ranks]}), {b_rays} rays "
          f"= {b_rays / b_s:.6g} rays/s; a world of one in rank 0's fresh process {one_s:.3f} s "
          f"= {one_rays / one_s:.6g} rays/s (in this process, (a): {a_rays / a_s:.6g}); K1/K2 "
          f"launches per rank {[(int(r['k1']), int(r['k2'])) for r in ranks]}; rel RMSE to (a) "
          f"{err:.3g}, ranks equal {np.array_equal(ranks[0]['img'], ranks[1]['img'])}; "
          f"{time.time() - t0:.2f} s", flush=True)
    check(err < 1e-4 and np.array_equal(ranks[0]["img"], ranks[1]["img"]),
          "the two gloo ranks' image differs from the world of one's, or between the ranks")
    check(all(int(r["k1"]) > 0 and int(r["k2"]) > 0 for r in ranks),
          "a gloo rank launched no K1/K2")

    # (e) the multi-host CLI on one host, run beside (c) and (d), which
    # time nothing
    t_e = time.time()
    exr = os.path.join(PARALLEL_DIR, "multihost.exr")
    cli = subprocess.Popen(
        [sys.executable, "-m", "mitsuba_tpu_torch.parallel.multihost", CBOX, "-o", exr, "--spp",
         "16", "--num-hosts", "1"], cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": HERE + os.pathsep
                        + os.environ.get("PYTHONPATH", "")})
    try:
        # (c) elastic: a fault at pass 3 of 8, a checkpoint every 2 passes
        t0 = time.time()
        w, h = scene.sensor.record.film.width, scene.sensor.record.film.height
        lanes = w * h * 2  # 8 passes of 2 spp
        clean = mt.render(scene, spp=16, seed=0, device=dev, lanes_per_pass=lanes)
        seen = []

        def fault(i):
            seen.append(i)
            if i == 3 and seen.count(3) == 1:
                raise elastic.SimulatedFault(i)

        ck = os.path.join(PARALLEL_DIR, "elastic_ck.npz")
        elastic._fault_hook = fault
        zeroed(brute)
        try:
            img = mt.render(scene, spp=16, seed=0, device=dev, lanes_per_pass=lanes,
                            checkpoint=ck, checkpoint_every=2)
        finally:
            elastic._fault_hook = None
        got = read_launches(brute, launches, brute, "the elastic render")
        requeued = seen[seen.index(3) + 1:]
        print(f"phase 6 (c): elastic cbox {w}x{h}, 16 spp in 8 passes: passes run {seen}, "
              f"re-queued {requeued[0]}..{requeued[-1]}; launches {got}; difference to the "
              f"uninterrupted render {float(np.abs(img - clean).max()):.6g}; "
              f"{time.time() - t0:.2f} s", flush=True)
        check(requeued == list(range(2, 8)) and np.array_equal(img, clean),
              "the elastic render did not re-queue passes 2..7, or differs")

        # (d) the render service: two workers on cuda:0, one killed
        t0 = time.time()
        size, spp, chunk = 256, 8, 1
        svc_scene = mt.load_scene(CBOX)
        svc_scene.sensor.record.film.width = svc_scene.sensor.record.film.height = size
        _, local_film = mt.render(svc_scene, spp=spp, seed=0, device=dev,
                                  lanes_per_pass=size * size * chunk, return_film=True)
        killed = []

        def kill_first(done, n, pid):
            if not killed:
                killed.append(pid)
                os.kill(pid, signal.SIGKILL)

        svc = RenderService(n_workers=2, device="cuda")
        try:
            sid = svc.broadcast_scene(CBOX, film_size={"width": size, "height": size})
            _, film = svc.render(sid, w=size, h=size, spp=spp, spp_chunk=chunk,
                                 progress=kill_first)
            dead = [wk.pid for wk in svc.workers if wk.dead]
            requeued = list(svc.requeued)
        finally:
            svc.shutdown()
        equal = np.array_equal(film, local_film.cpu().numpy())
        print(f"phase 6 (d): service, two workers on cuda:0, cbox {size}x{size}, {spp} units "
              f"of {chunk} spp: worker {killed} killed after its first unit, units re-queued "
              f"{requeued}; film equal to the local pass loop's: {equal}; "
              f"{time.time() - t0:.2f} s", flush=True)
        check(dead == killed and requeued and equal,
              "the service did not survive its killed worker, or its film differs")
        _, err = cli.communicate(timeout=300)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait(30)
    check(cli.returncode == 0, f"the multi-host CLI exited {cli.returncode}: {err[-2000:]}")
    wall = time.time() - t_e
    ref_path, _ = render_to_file(mt.load_scene(CBOX), os.path.join(PARALLEL_DIR, "ref.exr"),
                                 spp=16, device=dev)
    got_exr, ref_exr = read_exr(exr)[0], read_exr(ref_path)[0]
    equal = got_exr.shape == ref_exr.shape and np.array_equal(got_exr, ref_exr)
    print(f"phase 6 (e): python -m mitsuba_tpu_torch.parallel.multihost --num-hosts 1, cbox "
          f"512x512, 16 spp: wall {wall:.2f} s with the process's start (beside (c) and (d)); its "
          f"EXR equal to render_to_file's: {equal}", flush=True)
    check(equal, "the multi-host CLI's EXR differs from render_to_file's")

    # (f) the entry on the card
    t0 = time.time()
    zeroed(brute)
    fn, args = entry()
    film, rays = fn(*args)
    torch.cuda.synchronize()
    got = read_launches(brute, launches, brute, "entry()")
    print(f"phase 6 (f): entry() on {film.device}: film {tuple(film.shape)}, alpha > 0 "
          f"everywhere: {bool((film[..., 3] > 0).all())}, {int(rays)} rays, launches {got}; "
          f"{time.time() - t0:.2f} s", flush=True)
    check(tuple(film.shape) == (64, 64, 4) and film.device.type == "cuda"
          and bool((film[..., 3] > 0).all()), "entry() gave no film on the card")
    print(f"phase 6: {time.time() - t_phase:.2f} s", flush=True)
    return launches



def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import mitsuba_tpu_torch as mt
    from mitsuba_tpu_torch import native
    from mitsuba_tpu_torch.accel import pairs
    from mitsuba_tpu_torch.accel import pallas_bvh as pb
    from mitsuba_tpu_torch.accel import pallas_kernels as pk
    from mitsuba_tpu_torch.core import sobol
    from mitsuba_tpu_torch.core.distribution import alias_library
    from mitsuba_tpu_torch.emitter import eval as em
    from mitsuba_tpu_torch.film.film import new_film
    from mitsuba_tpu_torch.sampler.plugins import SOBOL
    from mitsuba_tpu_torch.renderer import make_render_pass
    from mitsuba_tpu_torch.scene.builder import pack_scene
    sys.path.append(os.path.join(HERE, "tests"))
    from mitsuba_tpu_torch.integrator import adaptive as tad
    from mitsuba_tpu_torch.integrator import bdpt as tb
    from mitsuba_tpu_torch.integrator import irrcache as tic
    from mitsuba_tpu_torch.integrator import mlt as tml
    from mitsuba_tpu_torch.accel import cyl as tcyl
    from mitsuba_tpu_torch.integrator import mut_manifold as tmm
    from mitsuba_tpu_torch.integrator import path as tpath
    from mitsuba_tpu_torch.integrator import photonmapper as tpm
    from mitsuba_tpu_torch.integrator import pssmlt as tps
    from mitsuba_tpu_torch.integrator import ptracer as tpt
    from mitsuba_tpu_torch.integrator import sppm as tsppm
    from mitsuba_tpu_torch.integrator import sss as tsss
    from mitsuba_tpu_torch.integrator import volpath as vp
    from mitsuba_tpu_torch.integrator import vpl as tvpl
    from mitsuba_tpu_torch.scene import texture_eval as ttex
    from torch_meshes import (
        DIPOLE_XML,
        DISPERSION_XML,
        DOOR_XML,
        METERS,
        NESTED_PATH,
        bdpt_media_xml,
        bitmap_xml,
        bsdf_gallery_xml,
        bump_xml,
        bunny_scene_xml,
        bunny_standin,
        cbox_chain_xml,
        cbox_meta_xml,
        cbox_mitchell_xml,
        cbox_ptracer_xml,
        cbox_xml,
        cloth_xml,
        daylight_xml,
        dense_standin,
        dipole_xml,
        dispersion_xml,
        door_xml,
        card_coverage,
        feature_assets,
        fiber_assets,
        fiber_slab_xml,
        fiber_xml,
        geom_xml,
        glass_manifold_xml,
        glass_slab_motion_xml,
        glass_xml,
        hairball_xml,
        homog_slab_xml,
        matpreview_const_xml,
        meter_xml,
        motion_big_xml,
        motion_vectors_xml,
        motion_xml,
        moving_card_xml,
        sensor_xml,
        sky_sun_xml,
        smoke_xml,
        textured_xml,
        two_wall_xml,
        with_integrator,
        with_properties,
        write_ply,
    )

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # camera transforms in full fp32
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} numpy {np.__version__} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- phase 1: build (one nvcc per source, in parallel) ----
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(2 * len(SOURCES) + 1) as ex:
        alias = ex.submit(alias_library)
        usage = [ex.submit(native.resource_usage, n) for n in SOURCES]
        libs = dict(zip(SOURCES, ex.map(native.build, SOURCES)))
        usage = {fn: u for f in usage for fn, u in f.result().items()}
        check(alias.result() is not None,
              "g++ could not build the alias-table builder csrc/host/alias_table.cpp")
    print(f"phase 1: built {sorted(os.path.relpath(p, HERE) for p in libs.values())} "
          f"and {os.path.relpath(alias.result()._name, HERE)} in {time.time() - t0:.2f} s "
          f"{elapsed()}", flush=True)
    for fn, u in sorted(usage.items()):
        print(f"  ptxas {fn}: {u}", flush=True)
        if any(k in fn for k in ("brute_kernel", "mxu_kernel", "dense_cull", "pair_kernel",
                                 "two_level_cull", "window_kernel")):  # K1-K6, K11, K12
            check(u.get("stack", 1) == u.get("spill_stores", 1) == u.get("spill_loads", 1) == 0,
                  f"{fn} uses a stack or spills: {u}")

    # ---- phase 2: kernels vs plain on the card ----
    print(f"phase 2: kernels vs plain versions {elapsed()}", flush=True)
    stats = []
    scene = mt.load_scene(CBOX)
    scene.sensor.record.film.width = scene.sensor.record.film.height = 512
    pack = pack_scene(scene, dev)
    o, d = camera_rays(scene, dev)
    n_cam = o.shape[0]
    n_box = int((pack.tri_t[0] < FAR_V0).sum())
    box_tris = [pack.arrays[k][:n_box].cpu().numpy() for k in ("tri_v0", "tri_e1", "tri_e2")]
    box_mt = torch.as_tensor(pk.build_mt_matrix(*box_tris, n_box), device=dev)
    brute_all(pk, o, d, torch.full((n_cam,), 1000.0, device=dev), pack.tri_s, pack.tri_t,
              box_mt, n_box, stats, True)
    rng = np.random.default_rng(0)
    n_tri, n_ray = 300, 1_000_000
    v0 = rng.uniform(-1, 1, (n_tri, 3)).astype(np.float32)
    e1 = rng.uniform(-0.2, 0.2, (n_tri, 3)).astype(np.float32)
    e2 = rng.uniform(-0.2, 0.2, (n_tri, 3)).astype(np.float32)
    o_r = torch.as_tensor(rng.uniform(-2, 2, (n_ray, 3)).astype(np.float32), device=dev)
    d_r = rng.normal(size=(n_ray, 3)).astype(np.float32)
    d_r /= np.linalg.norm(d_r, axis=-1, keepdims=True)
    d_r = torch.as_tensor(d_r, device=dev)
    brute_all(pk, o_r, d_r, torch.as_tensor(rng.uniform(0.2, 3, n_ray).astype(np.float32), device=dev),
              torch.as_tensor(pk.pack_triangles_sublane(v0, e1, e2, n_tri), device=dev),
              torch.as_tensor(pk.pack_triangles_transposed(v0, e1, e2, n_tri), device=dev),
              torch.as_tensor(pk.build_mt_matrix(v0, e1, e2, n_tri), device=dev), n_tri, stats,
              False)
    launch_cost(pk, native, dev, pack.tri_s, pack.tri_t, box_mt)
    real = mt.load_scene(MATPREVIEW_XML)  # 512x512, envmap and sobol
    real_pack = pack_scene(real, dev)
    check(real_pack.meta["has_envmap"], "scenes/matpreview.xml packed without its envmap")
    matpreview_brute(pk, real, real_pack, dev, stats, "matpreview")
    mp = mt.load_scene_string(matpreview_const_xml())  # 512x512
    mp_pack = pack_scene(mp, dev)
    matpreview_brute(pk, mp, mp_pack, dev, stats, "matpreview variant")

    os.makedirs(os.path.dirname(STANDIN_PLY), exist_ok=True)
    write_ply(STANDIN_PLY, *bunny_standin(seed=0))
    big = mt.load_scene_string(bunny_scene_xml(STANDIN_PLY))  # 512x512
    t0 = time.time()
    big_pack = pack_scene(big, dev)
    print(f"  stand-in mesh: {len(big.shapes[0].meshes[0].indices)} triangles, "
          f"C = {big_pack.meta['n_clusters']} clusters of <= {big_pack.meta['cluster_tc']} "
          f"(cluster_vmem_ok={big_pack.meta['cluster_vmem_ok']}), packed in "
          f"{time.time() - t0:.2f} s", flush=True)
    o, d = camera_rays(big, dev)
    t_any = torch.as_tensor(rng.uniform(0.02, 0.3, N_RAYS).astype(np.float32), device=dev)
    compare_cluster(pairs, pb, "camera", big_pack, o, d, t_any, stats)
    center = torch.tensor([-0.02, 0.1, 0.0], device=dev)
    o_r = center + torch.as_tensor(rng.uniform(-0.15, 0.15, (N_RAYS, 3)).astype(np.float32),
                                   device=dev)
    d_r = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d_r /= np.linalg.norm(d_r, axis=-1, keepdims=True)
    o_r, d_r = o_r.contiguous(), torch.as_tensor(d_r, device=dev)
    compare_cluster(pairs, pb, "random", big_pack, o_r, d_r, t_any, stats)

    write_ply(DENSE_PLY, *dense_standin(seed=0))
    dense = mt.load_scene_string(bunny_scene_xml(DENSE_PLY))  # 512x512
    t0 = time.time()
    dense_pack = pack_scene(dense, dev)
    dense_pack_s = time.time() - t0
    dm = dense_pack.meta
    print(f"  dense stand-in mesh: {len(dense.shapes[0].meshes[0].indices)} triangles, "
          f"C = {dm['n_clusters']} clusters, S = {dm['n_supers']} superclusters "
          f"(cluster_vmem_ok={dm['cluster_vmem_ok']}), packed in {dense_pack_s:.2f} s", flush=True)
    check(dm["n_clusters"] > pairs.DENSE_C and not dm["cluster_vmem_ok"],
          "the dense stand-in does not take the dense-mesh path")
    o, d = camera_rays(dense, dev)
    compare_dense(pairs, pb, "camera", dense_pack, o, d, t_any, stats, rng)
    compare_dense(pairs, pb, "random", dense_pack, o_r, d_r, t_any, stats, rng)

    smoke64 = mt.load_scene_string(smoke_xml(64, 64))
    smoke_pack = pack_scene(smoke64, dev)
    check(smoke_pack.meta["use_bvh"] and smoke_pack.meta["has_media"],
          "scenes/smoke.xml packed without its BVH or its media")
    print(f"  smoke: {smoke_pack.meta['n_tris']} triangles in {smoke_pack.meta['n_clusters']} "
          f"clusters, {smoke_pack.meta['n_het']} grid of {tuple(smoke_pack.het_dims[0].tolist())}",
          flush=True)
    # at 64x64x16, and at the shapes the phase-4 pass hands these kernels:
    # 2,097,152 rays a query
    smoke = mt.load_scene_string(smoke_xml(SMOKE_RES, SMOKE_RES))
    for sc, spp, reps in ((smoke64, 16, 20), (smoke, SMOKE_SPP, 3)):
        res = f"{sc.sensor.record.film.width}x{sc.sensor.record.film.height}x{spp}"
        queries = smoke_queries(vp, make_render_pass, new_film, sc, smoke_pack, dev, spp)
        compare_segments(pairs, pb, smoke_pack, [(f"smoke {res} {q[0]}", *q[1:]) for q in queries],
                         stats, plain_reps=reps)

    # the light-transport slice: the particle tracer's camera connections
    # on cbox (K1/K2), bdpt's connection segments on glass (K3/K4, K7/K8)
    print(f"  light transport {elapsed()}", flush=True)
    pt_scene = mt.load_scene_string(cbox_ptracer_xml())  # 512x512
    ptracer_segments(pk, tpt, pt_scene, pack, dev, stats)
    glass64 = mt.load_scene_string(glass_xml(64, 64))
    glass_pack = pack_scene(glass64, dev)
    check(glass_pack.meta["use_bvh"] and glass_pack.meta["n_tris"] == 1026,
          "scenes/glass_caustics.xml does not pack into 1,026 triangles with cluster tables")
    bdpt_segments(pairs, pb, tb, glass64, glass_pack, dev, stats)

    # the Metropolis slice: door's first bidirectional step as it stands
    # (K3/K4, K7/K8), the re-traces of a manifold proposal on glass
    # (K3/K4, K7) and one mlt step's path re-trace on cbox (K1/K2)
    print(f"  Metropolis {elapsed()}", flush=True)
    door = mt.load_scene(DOOR_XML)  # 256x256, pssmlt, maxDepth 8
    door_pack = pack_scene(door, dev)
    dm = door_pack.meta
    print(f"  door: {dm['n_tris']} triangles in {dm['n_clusters']} clusters, "
          f"{dm['n_spheres']} analytic sphere(s), use_bvh={dm['use_bvh']}", flush=True)
    check(dm["use_bvh"] and dm["n_tris"] == 1096 and dm["n_spheres"] == 1,
          "scenes/door.xml does not pack into 1,096 triangles and one sphere with cluster tables")
    door_step_segments(pairs, pb, tb, tps, door, door_pack, dev, stats)
    glass_mani = mt.load_scene_string(with_integrator(glass_xml(256, 256), "mlt", max_depth=6))
    manifold_segments(pairs, pb, tmm, tps, glass_mani, glass_pack, dev, stats)
    with open(CBOX) as f:
        cbox_mlt = mt.load_scene_string(with_integrator(f.read(), "mlt", max_depth=4))
    mlt_brute(pk, tps, tml, cbox_mlt, pack, dev, stats)

    # the photon-mapping slice: an sppm photon walk's first query on glass
    # (K3/K4, K7), a vpl pass's camera and shadow batches on cbox (K1/K2),
    # the volumetric photon mapper's first walk query on smoke (K3/K4, K7)
    print(f"  photon mapping {elapsed()}", flush=True)
    glass_sppm = mt.load_scene_string(with_integrator(glass_xml(256, 256), "sppm"))
    sppm_walk_segments(pairs, pb, tsppm, glass_sppm, glass_pack, dev, stats)
    with open(CBOX) as f:
        cbox_vpl = mt.load_scene_string(with_integrator(f.read(), "vpl"))  # 512x512
    vpl_brute(pk, tvpl, cbox_vpl, pack, dev, stats)
    smoke_pm = mt.load_scene_string(with_integrator(smoke_xml(SMOKE_RES, SMOKE_RES),
                                                    "photonmapper"))
    pm_walk_segments(pairs, pb, tpm, tsppm, smoke_pm, smoke_pack, dev, stats)

    # the subsurface slice: dipole.xml's camera rays, its irradiance pass's
    # NEE and a singlescatter pass's first segment (K3/K4, K7/K8)
    print(f"  subsurface {elapsed()}", flush=True)
    dipole = mt.load_scene(DIPOLE_XML)  # 512x384, 64 spp, path at maxDepth 8
    dipole_pack = pack_scene(dipole, dev)
    dm = dipole_pack.meta
    print(f"  dipole: {dm['n_tris']} triangles in {dm['n_clusters']} clusters, "
          f"{dm['n_spheres']} analytic sphere(s), {dipole_pack.sss_p.shape[0]} subsurface points "
          f"x {dm['sss_irr_samples']} irradiance rays", flush=True)
    check(dm["use_bvh"] and dm["n_tris"] == 1036 and dm["n_spheres"] == 1 and dm["has_sss"]
          and dipole_pack.sss_p.shape[0] == 640,
          "scenes/dipole.xml does not pack into 1,036 triangles, one sphere and 640 points")
    ss = mt.load_scene_string(dipole_xml(kind="singlescatter"))
    ss_pack = pack_scene(ss, dev)
    dipole_segments(pairs, pb, tsss, make_render_pass, new_film, dipole, dipole_pack, ss, ss_pack,
                    dev, stats)

    # the hairball slice: scenes/hairball.xml as it stands (68,136
    # triangles in 800 clusters), its camera rays and NEE (K3/K4, K7/K8)
    print(f"  hairball {elapsed()}", flush=True)
    hairball = mt.load_scene(HAIRBALL_XML)  # 512x384, 64 spp, path at maxDepth 6
    t0 = time.time()
    hair_pack = pack_scene(hairball, dev)
    hm = hair_pack.meta
    print(f"  hairball: {hm['n_tris']} triangles in {hm['n_clusters']} clusters, "
          f"{hm['n_spheres']} analytic sphere(s), packed in {time.time() - t0:.2f} s", flush=True)
    check(hm["use_bvh"] and hm["n_tris"] == 68136 and hm["n_clusters"] == 800
          and hm["present_types"] == (0, 9),
          "scenes/hairball.xml does not pack into 68,136 triangles in 800 clusters, "
          "diffuse and phong")
    pair_segments(pairs, pb, tpath, make_render_pass, new_film, hairball, hair_pack, dev, stats,
                  "hairball")
    hair_exact = mt.load_scene_string(hairball_xml(exact=True))
    exact_pack = pack_scene(hair_exact, dev)
    check(exact_pack.meta["n_cyls"] == 7189, "the exact hairball does not pack 7,189 segments")

    # the texture slice: TEXTURED at 512x512 (2,758 triangles in 35
    # clusters), its camera rays and NEE (K3/K4, K7/K8)
    print(f"  textured {elapsed()}", flush=True)
    feat_dir = feature_assets(os.path.join(HERE, "build", "feature_assets"))
    textured = mt.load_scene_string(textured_xml(feat_dir))  # 512x512, 16 spp
    t0 = time.time()
    tex_pack = pack_scene(textured, dev)
    tm_ = tex_pack.meta
    print(f"  textured: {tm_['n_tris']} triangles in {tm_['n_clusters']} clusters, atlas "
          f"{tuple(tex_pack.tex_atlas.shape)}, mip levels {tex_pack.tex_n_lev.tolist()}, packed in "
          f"{time.time() - t0:.2f} s", flush=True)
    check(tm_["use_bvh"] and tm_["n_tris"] == 2758 and tm_["present_types"] == (0, 8, 17)
          and tm_["has_mips"] and tm_["geom_tex_kinds"] == (4, 5, 6) and tm_["has_bumpmaps"]
          and tm_["has_irawan"],
          "TEXTURED does not pack into 2,758 triangles with diffuse, roughplastic and irawan, "
          "mip maps, the geometry kinds and bump maps")
    pair_segments(pairs, pb, tpath, make_render_pass, new_film, textured, tex_pack, dev, stats,
                  "textured")

    # the sensors, the daylight emitters and spectral mode (K1/K2): DAYLIGHT's
    # camera rays through the thinlens and their first NEE, the spherical
    # sensor's camera rays, dispersion.xml's camera rays and first NEE
    print(f"  sensors, daylight, spectral {elapsed()}", flush=True)
    daylight = mt.load_scene_string(daylight_xml())  # 512x512, sobol
    t0 = time.time()
    day_pack = pack_scene(daylight, dev)
    dm = day_pack.meta
    print(f"  DAYLIGHT: sunsky baked and packed in {time.time() - t0:.2f} s, env "
          f"{tuple(day_pack.env_image.shape)}, emitter kinds {dm['emitter_kinds']}", flush=True)
    check(dm["has_envmap"] and dm["emitter_kinds"] == (6,)
          and daylight.sensor.record.pack(8, 8, dev)["use_lens"],
          "DAYLIGHT does not pack its sunsky as an envmap behind a thinlens camera")
    matpreview_brute(pk, daylight, day_pack, dev, stats, "DAYLIGHT")
    spherical = mt.load_scene_string(sensor_xml("spherical", 512, 256))
    matpreview_brute(pk, spherical, pack_scene(spherical, dev), dev, stats, "spherical sensor",
                     shadow=False)
    dispersion = mt.load_scene(DISPERSION_XML)  # 256x256, 256 spp, path at maxDepth 8
    disp_pack = pack_scene(dispersion, dev)
    dm = disp_pack.meta
    print(f"  dispersion: {dm['n_tris']} triangles, {dm['n_spheres']} analytic sphere(s), "
          f"emitter kinds {dm['emitter_kinds']}, types {dm['present_types']}, mat_disp "
          f"{disp_pack.mat_disp.tolist()}", flush=True)
    check(not dm["use_bvh"] and dm["n_tris"] == 2 and dm["n_spheres"] == 1
          and dm["emitter_kinds"] == (2, 5) and dm["present_types"] == (0, 4)
          and abs(float(disp_pack.mat_disp.max()) - 0.0042) < 1e-7,
          "scenes/dispersion.xml does not pack into 2 triangles, a dispersive glass sphere, "
          "a spot and a constant environment")
    matpreview_brute(pk, dispersion, disp_pack, dev, stats, "dispersion")

    # the motion slice: MOTION's camera rays and first NEE through K1/K2 on
    # its static prefix alone (24 of its 38 rows), MOTION_BIG's through
    # K3/K4 with K7/K8 on the 69k stand-in's static prefix
    print(f"  motion {elapsed()}", flush=True)
    motion = mt.load_scene_string(motion_xml())  # 512x512, 16 spp
    motion_pack = pack_scene(motion, dev)
    mm_ = motion_pack.meta
    print(f"  MOTION: {mm_['n_tris']} triangles, {mm_['n_static_tris']} static, animated "
          f"{mm_['anim_ranges']}, deformable {mm_['deform_ranges']}, shutter "
          f"[{mm_['shutter_open']}, {mm_['shutter_close']}]", flush=True)
    check(mm_["n_tris"] == 38 and mm_["n_static_tris"] == 24 and mm_["anim_ranges"] == ((24, 12),)
          and mm_["deform_ranges"] == ((36, 2, (0.0, 0.5, 1.0)),) and not mm_["use_bvh"],
          "MOTION does not pack into 24 static, 12 animated and 2 deformable rows")
    check(pk.live_columns(motion_pack.tri_s).tolist() == list(range(24)),
          "MOTION's tri_s does not hold exactly its 24 static columns")
    matpreview_brute(pk, motion, motion_pack, dev, stats, "MOTION", n_expected=24)
    motion_big = mt.load_scene_string(motion_big_xml(STANDIN_PLY))  # 512x512, 16 spp
    t0 = time.time()
    mb_pack = pack_scene(motion_big, dev)
    mb = mb_pack.meta
    print(f"  MOTION_BIG: {mb['n_tris']} triangles, {mb['n_static_tris']} static in "
          f"{mb['n_clusters']} clusters, animated {mb['anim_ranges']}, packed in "
          f"{time.time() - t0:.2f} s", flush=True)
    check(mb["use_bvh"] and mb["n_static_tris"] == 69168 and mb["anim_ranges"] == ((69168, 12),)
          and int(mb_pack.cl_pad2prim.max()) == mb["n_tris"]
          and int(mb_pack.cl_pad2prim[mb_pack.cl_pad2prim < mb["n_tris"]].max()) < 69168,
          "MOTION_BIG's clusters do not cover its static prefix alone, dummy slot n_tris")
    pair_segments(pairs, pb, tpath, make_render_pass, new_film, motion_big, mb_pack, dev, stats,
                  "MOTION_BIG")

    # the geometry extras: INSTANCED (1,024 instances, 44.2M instanced
    # triangles) through the accelerator's pair path: K3/K4 with K7/K8 on
    # each round's and group's template-space batch of its camera rays and
    # first NEE, K1/K2 on its 4 static rows
    print(f"  geometry extras {elapsed()}", flush=True)
    from mitsuba_tpu_torch.accel import clusters
    from mitsuba_tpu_torch.accel import intersect as tis
    from mitsuba_tpu_torch.accel import tlas

    instanced, inst_pack = instanced_setup(mt, pack_scene, dev)
    inst_queries = instanced_queries(tpath, make_render_pass, new_film, instanced, inst_pack, dev)
    instanced_segments(pairs, pb, pk, tlas, tis, inst_queries, instanced, inst_pack, dev, stats,
                       "INSTANCED")

    # ---- phase 3: the slices on the card, through the kernels ----
    print(f"phase 3: renders {elapsed()}", flush=True)
    counted = counters(pk, pairs, pb)
    scene64 = mt.load_scene(CBOX)
    scene64.sensor.record.film.width = scene64.sensor.record.film.height = 64
    launches = render_checked(
        mt, {k: counted[k] for k in ("closest_hit_v2", "any_hit_v2")},
        scene64, GOLDEN, dev, "cbox")
    launches.update(brute_entry_points(pk, pack, *camera_rays(scene, dev)))
    from mitsuba_tpu_torch.accel import intersect as intersect_mod

    real64 = mt.load_scene(MATPREVIEW_XML)
    real64.sensor.record.film.width = real64.sensor.record.film.height = 64
    check(real64.sensor.record.sampler.kind == SOBOL, "scenes/matpreview.xml is not sobol")
    inner = count_sphere_hits(intersect_mod)
    arms = [(mod, name, count_calls(mod, name)) for mod, name in (
        (sobol, "sobol_01_dyn"), (em, "_sample_env_dir"), (em, "_env_bilinear"))]
    real_launches = render_checked(
        mt, {k: counted[k] for k in ("closest_hit_v2", "any_hit_v2")},
        real64, MATPREVIEW_REF_GOLDEN, dev, "matpreview")
    sphere_hits = intersect_mod._intersect_spheres.hits
    calls = {name: getattr(mod, name).calls for mod, name, _ in arms}
    intersect_mod._intersect_spheres = inner
    for mod, name, fn in arms:
        setattr(mod, name, fn)
    print(f"  matpreview: {sphere_hits} sphere hits (closest-hit and shadow queries); calls of "
          f"the sobol decision draw and the envmap arms {calls}", flush=True)
    check(sphere_hits > 0, "the matpreview render hit no sphere")
    for k, n in {**real_launches, **calls}.items():
        check(n > 0, f"the matpreview render never ran {k}")
    inner = count_sphere_hits(intersect_mod)
    mp_launches = render_checked(
        mt, {k: counted[k] for k in ("closest_hit_v2", "any_hit_v2")},
        mt.load_scene_string(matpreview_const_xml(64, 64)), MATPREVIEW_GOLDEN, dev,
        "matpreview variant")
    sphere_hits = intersect_mod._intersect_spheres.hits
    intersect_mod._intersect_spheres = inner
    print(f"  matpreview variant: {sphere_hits} sphere hits (closest-hit and shadow queries)",
          flush=True)
    check(sphere_hits > 0, "the matpreview variant's render hit no sphere")
    for k, n in mp_launches.items():
        check(n > 0, f"the matpreview variant's render never launched {k}")
    big64 = mt.load_scene_string(bunny_scene_xml(STANDIN_PLY, 64, 64))
    cluster_names = [k for k, src, _ in KERNELS if src == "cluster_hit"]
    for fn in (pairs.pair_closest, pairs.pair_any):
        fn.rays = fn.overflow_rays = 0
    big_launches = render_checked(mt, {k: counted[k] for k in cluster_names},
                                  big64, BIGMESH_GOLDEN, dev, "stand-in")
    for fn in (pairs.pair_closest, pairs.pair_any):
        print(f"  {fn.__name__}: {fn.overflow_rays} of {fn.rays} rays overflowed "
              f"(K={pairs.K}) and took the fallback", flush=True)
    if not (big_launches["cluster_traverse_closest"] and big_launches["cluster_traverse_any"]):
        natural_k = pairs.K
        pairs.K = 1
        print(f"  the fallback did not run at K={natural_k}; again with K=1", flush=True)
        big_launches = render_checked(mt, {k: counted[k] for k in cluster_names},
                                      big64, BIGMESH_GOLDEN, dev, "stand-in (K=1)")
        pairs.K = natural_k
    launches.update(big_launches)

    dense64 = mt.load_scene_string(bunny_scene_xml(DENSE_PLY, 64, 64))
    stream_names = [k for k, src, _ in KERNELS if src == "cluster_stream"]
    dense_counted = {k: counted[k] for k in cluster_names + stream_names}
    print(f"  dense stand-in: pack_scene {dense_pack_s:.2f} s (phase 2; the pack does "
          f"not depend on the film size)", flush=True)
    for fn in (pairs.pair_closest, pairs.pair_any):
        fn.rays = fn.overflow_rays = 0
    dense_launches = render_checked(mt, dense_counted, dense64, DENSE_GOLDEN, dev,
                                    "dense stand-in", pack=dense_pack)
    for fn in (pairs.pair_closest, pairs.pair_any):
        print(f"  {fn.__name__}: {fn.overflow_rays} of {fn.rays} rays overflowed "
              f"(K={pairs.K}, KS={pairs.KS}) and took the fallback", flush=True)
    if not (dense_launches["cluster_stream_closest"] and dense_launches["cluster_stream_any"]):
        natural = pairs.K, pairs.KS
        pairs.K = pairs.KS = 1
        print(f"  the fallback did not run at K, KS = {natural}; again with K = KS = 1", flush=True)
        dense_launches = render_checked(mt, dense_counted, dense64, DENSE_GOLDEN, dev,
                                        "dense stand-in (K = KS = 1)", pack=dense_pack)
        pairs.K, pairs.KS = natural
    for k in cluster_names:  # the dispatch: none of the big-mesh kernels
        check(dense_launches[k] == 0, f"the dense render launched {k}")
    launches.update({k: dense_launches[k] for k in stream_names})

    # the smoke slice: volpath through K3/K4 (K7 on overflow)
    smoke_names = ("dense_cull", "pair_hit_closest", "cluster_traverse_closest")
    for fn in (pairs.pair_closest, pairs.pair_any):
        fn.rays = fn.overflow_rays = 0
    smoke_launches = render_checked(mt, {k: counted[k] for k in smoke_names}, smoke64,
                                    SMOKE_GOLDEN, dev, "smoke", pack=smoke_pack)
    events = {"medium events": int(vp.volpath_trace.last_medium_events),
              "null boundaries crossed by shadow rays": int(vp.volpath_trace.last_null_crossings)}
    print(f"  smoke: {pairs.pair_closest.overflow_rays} of {pairs.pair_closest.rays} closest-hit "
          f"rays overflowed (K={pairs.K}) and took the fallback (K7 launched "
          f"{smoke_launches['cluster_traverse_closest']} times); {events}", flush=True)
    for k, n in {**{k: smoke_launches[k] for k in smoke_names[:2]}, **events}.items():
        check(n > 0, f"the smoke render ran no {k}")
    mitchell_launches = render_checked(
        mt, {k: counted[k] for k in ("closest_hit_v2", "any_hit_v2")},
        mt.load_scene_string(cbox_mitchell_xml(64, 64)), MITCHELL_GOLDEN, dev, "cbox mitchell")
    for k, n in {**smoke_launches, **mitchell_launches}.items():
        launches[k] += n

    # the light-transport slice: bdpt on glass as it stands (16 edges)
    # through K3/K4 (K7/K8 on overflow), ptracer and bdpt under delta
    # lights and in a medium through K1/K2
    print(f"  light transport {elapsed()}", flush=True)
    glass_names = ("dense_cull", "pair_hit_closest", "pair_hit_any", "cluster_traverse_closest",
                   "cluster_traverse_any")
    for fn in (pairs.pair_closest, pairs.pair_any):
        fn.rays = fn.overflow_rays = 0
    glass_launches = render_checked(mt, {k: counted[k] for k in glass_names}, glass64,
                                    GLASS_GOLDEN, dev, "glass_caustics bdpt", pack=glass_pack)
    print(f"  glass: {pairs.pair_closest.overflow_rays} of {pairs.pair_closest.rays} closest-hit "
          f"and {pairs.pair_any.overflow_rays} of {pairs.pair_any.rays} shadow rays overflowed "
          f"(K={pairs.K}) and took the fallback; {int(tb.render_bdpt.last_ray_count)} rays",
          flush=True)
    for k in glass_names[:3]:
        check(glass_launches[k] > 0, f"the glass render never launched {k}")
    glass_launches = {k: glass_launches[k] + n for k, n in render_checked(
        mt, {k: counted[k] for k in glass_names}, mt.load_scene_string(glass_xml(16, 16)),
        GLASS_PAIR_GOLDEN, dev, "glass_caustics bdpt (pair-pipeline golden)", spp=4).items()}
    brute = {k: counted[k] for k in ("closest_hit_v2", "any_hit_v2")}
    lt_launches = {}
    for label, xml, golden, spp in (
            ("cbox ptracer", cbox_ptracer_xml(64, 64), PTRACER_GOLDEN, 16),
            ("two-wall spot bdpt", two_wall_xml("spot", "bdpt", max_depth=8, spp=16), SPOT_GOLDEN,
             16),
            ("media bdpt", bdpt_media_xml("bdpt", max_depth=6, spp=16), MEDIA_GOLDEN, 16)):
        got = render_checked(mt, brute, mt.load_scene_string(xml), golden, dev, label, spp=spp)
        for k, n in got.items():
            # the media scene's shadow rays are closest-hit segments
            # through its null sphere (volpath._attenuated_visibility)
            check(n > 0 or (label == "media bdpt" and k == "any_hit_v2"),
                  f"the {label} render never launched {k}")
            lt_launches[k] = lt_launches.get(k, 0) + n
    for k, n in {**glass_launches, **lt_launches}.items():
        launches[k] += n

    # the Metropolis slice: pssmlt on door as it stands (bidirectional,
    # 8 edges) and unidirectional, mlt and erpt on door and cbox, mlt with
    # the manifold perturbation on glass, each against its golden
    print(f"  Metropolis {elapsed()}", flush=True)
    chain_names = glass_names  # K3/K4, K7/K8 on overflow
    for label, xml, golden, spp, names, pk_ in (
            ("door pssmlt", door_xml(16, 16, 1024), "torch_door_pssmlt_16_4.npy", 4,
             chain_names, door_pack),
            ("door pssmlt unidirectional", door_xml(16, 16, 1024, bidirectional=False),
             "torch_door_pssmlt_uni_16_4.npy", 4, chain_names, door_pack),
            ("door mlt", with_integrator(door_xml(16, 16, 1024), "mlt"), "torch_door_mlt_16_4.npy",
             4, chain_names, door_pack),
            ("door erpt", with_properties(with_integrator(door_xml(16, 16, 1024), "erpt"),
                                          '<integer name="chainLength" value="8"/>'),
             "torch_door_erpt_16_1.npy", 1, chain_names, door_pack),
            ("cbox mlt", cbox_chain_xml("mlt"), "torch_cbox_mlt_24_8.npy", 8,
             ("closest_hit_v2", "any_hit_v2"), pack),
            ("cbox erpt", cbox_chain_xml("erpt", chain_length=20), "torch_cbox_erpt_24_1.npy", 1,
             ("closest_hit_v2", "any_hit_v2"), pack),
            ("glass mlt, manifold perturbation", glass_manifold_xml(),
             "torch_glass_mlt_manifold_16_8.npy", 8, chain_names, glass_pack)):
        got = render_checked(mt, {k: counted[k] for k in names}, mt.load_scene_string(xml),
                             os.path.join(HERE, "tests", "golden", golden), dev, label, pack=pk_,
                             spp=spp)
        for k in names[:3] if "cbox" not in label else names:
            check(got[k] > 0, f"the {label} render never launched {k}")

    # the photon-mapping slice, each against its golden (the JAX package's
    # render) at its GOLDEN_GATES gate, with the photons an iteration the
    # golden was made with: sppm and ppm on cbox (K1/K2), sppm on glass
    # (K3/K4), the volumetric photon mapper on the homogeneous slab
    # (K3/K4), vpl on cbox (K1/K2)
    print(f"  photon mapping {elapsed()}", flush=True)
    for label, xml, golden, names, pk_, photons in (
            ("cbox sppm", cbox_xml("sppm", 24, 24), "torch_cbox_sppm_24_4.npy", brute, pack,
             1 << 14),
            ("cbox ppm", cbox_xml("ppm", 24, 24), "torch_cbox_sppm_24_4.npy", brute, pack,
             1 << 14),
            ("glass sppm", with_integrator(glass_xml(16, 16), "sppm"),
             "torch_glass_sppm_16_4.npy", {k: counted[k] for k in glass_names}, glass_pack,
             1 << 12),
            ("slab photonmapper", homog_slab_xml(), "torch_homog_photonmapper_32_4.npy",
             {k: counted[k] for k in glass_names}, None, 1 << 12),
            ("cbox vpl", cbox_xml("vpl", 24, 24), "torch_cbox_vpl_24_4.npy", brute, pack, None)):
        with photon_env(photons):
            got = render_checked(mt, names, mt.load_scene_string(xml),
                                 os.path.join(HERE, "tests", "golden", golden), dev, label,
                                 pack=pk_, spp=4)
        for k in list(names)[:2]:  # K1/K2, or K3 and K4's closest hit
            check(got[k] > 0, f"the {label} render never launched {k}")
        for k, n in got.items():
            launches[k] += n

    # the subsurface slice (K3/K4, K7/K8 on overflow), the path family's ao
    # and field and the meta-integrators on cbox (K1/K2), each against its
    # golden at its GOLDEN_GATES gate
    print(f"  subsurface, path family, meta-integrators {elapsed()}", flush=True)
    uv = '<string name="field" value="uv"/>'
    for label, xml, golden, names, pk_ in (
            ("dipole", dipole_xml(32, 24), "torch_dipole_32_4.npy", glass_names, dipole_pack),
            ("singlescatter", dipole_xml(32, 24, "singlescatter"), "torch_singlescatter_32_4.npy",
             glass_names, ss_pack),
            ("cbox ao", cbox_xml("ao", 24, 24), "torch_cbox_ao_24_4.npy", tuple(brute), pack),
            ("cbox field uv", with_properties(cbox_xml("field", 24, 24), uv),
             "torch_cbox_field_uv_24_4.npy", ("closest_hit_v2",), pack),
            ("cbox adaptive", cbox_meta_xml("adaptive", NESTED_PATH),
             "torch_cbox_adaptive_24_4.npy", tuple(brute), pack),
            ("cbox irrcache", cbox_meta_xml("irrcache", NESTED_PATH),
             "torch_cbox_irrcache_24_4.npy", tuple(brute), pack)):
        got = render_checked(mt, {k: counted[k] for k in names}, mt.load_scene_string(xml),
                             os.path.join(HERE, "tests", "golden", golden), dev, label, pack=pk_,
                             spp=4)
        for k in names[:3]:  # K3 and K4, or K1/K2
            check(got[k] > 0, f"the {label} render never launched {k}")
        for k, n in got.items():
            launches[k] += n
    # the hairball slice (as it stands: K3/K4, most rays through K7/K8;
    # exact: the emissive sphere's triangles through K3/K4, the segments
    # in plain tensor operations) and the BSDF galleries (K1/K2), each
    # against its golden at its GOLDEN_GATES gate
    print(f"  hairball, BSDF galleries {elapsed()}", flush=True)
    for label, xml, golden, names, pk_ in (
            ("hairball", hairball_xml(32, 24), "torch_hairball_32_4.npy", glass_names, hair_pack),
            ("hairball exact", hairball_xml(32, 24, exact=True), "torch_hairball_exact_32_4.npy",
             glass_names[:3], exact_pack),
            ("gallery glossy", bsdf_gallery_xml("glossy", 24, 24), "torch_bsdf_glossy_24_4.npy",
             tuple(brute), None),
            ("gallery thin", bsdf_gallery_xml("thin", 24, 24), "torch_bsdf_thin_24_4.npy",
             tuple(brute), None),
            ("gallery layered", bsdf_gallery_xml("layered", 24, 24),
             "torch_bsdf_layered_24_4.npy", tuple(brute), None),
            ("gallery thin bdpt", bsdf_gallery_xml("thin", 24, 24, "bdpt", 4),
             "torch_bsdf_thin_bdpt_24_4.npy", tuple(brute), None)):
        for fn in (pairs.pair_closest, pairs.pair_any):
            fn.rays = fn.overflow_rays = 0
        got = render_checked(mt, {k: counted[k] for k in names}, mt.load_scene_string(xml),
                             os.path.join(HERE, "tests", "golden", golden), dev, label, pack=pk_,
                             spp=4)
        if label.startswith("hairball"):
            print(f"  {label}: {pairs.pair_closest.overflow_rays} of {pairs.pair_closest.rays} "
                  f"closest-hit and {pairs.pair_any.overflow_rays} of {pairs.pair_any.rays} shadow "
                  f"rays overflowed (K={pairs.K})", flush=True)
        for k in names if label == "hairball" else names[:2]:
            check(got[k] > 0, f"the {label} render never launched {k}")
        for k, n in got.items():
            launches[k] += n
    # the texture slice: TEXTURED (K3/K4 with K7/K8) and the feature scenes
    # (K1/K2; the albedo field casts no shadow rays: K1 only, and K3/K4 for
    # the curvature sphere's 576 triangles), each against
    # its golden at its GOLDEN_GATES gate, the bitmap scene under both
    # footprint filters
    print(f"  textured, texture features {elapsed()}", flush=True)
    for label, xml, golden, names, checked, filt in (
            ("textured", textured_xml(feat_dir, 32, 32), "torch_textured_32_4.npy", glass_names,
             3, "feline"),
            ("bitmap feline", bitmap_xml(feat_dir), "torch_tex_bitmap_24_4.npy", tuple(brute), 2,
             "feline"),
            ("bitmap ewa", bitmap_xml(feat_dir), "torch_tex_bitmap_ewa_24_4.npy", tuple(brute), 2,
             "ewa"),
            ("normal map", bump_xml("tilted"), "torch_tex_normalmap_32_4.npy", tuple(brute), 2,
             "feline"),
            ("bump map", bump_xml("bump", feat_dir), "torch_tex_bumpmap_32_4.npy", tuple(brute), 2,
             "feline"),
            ("vertexcolors", geom_xml("vertexcolors", feat_dir), "torch_tex_vertexcolors_33_4.npy",
             tuple(brute), 1, "feline"),
            ("wireframe", geom_xml("wireframe", feat_dir), "torch_tex_wireframe_33_4.npy",
             tuple(brute), 1, "feline"),
            ("curvature", geom_xml("curvature", feat_dir), "torch_tex_curvature_33_4.npy",
             glass_names, 2, "feline"),  # 576 triangles: K3/K4
            ("irawan cloth", cloth_xml(), "torch_irawan_cloth_24_4.npy", tuple(brute), 2,
             "feline")):
        # each scene packs at its own film size: the pack's camera cone
        # (cam_pix_angle) sets the mip footprints
        ttex.TEX_FILTER = filt
        try:
            got = render_checked(mt, {k: counted[k] for k in names}, mt.load_scene_string(xml),
                                 os.path.join(HERE, "tests", "golden", golden), dev, label, spp=4)
        finally:
            ttex.TEX_FILTER = "feline"
        for k in names[:checked]:
            check(got[k] > 0, f"the {label} render never launched {k}")
        for k, n in got.items():
            launches[k] += n
    # the sensors, the daylight emitters and spectral mode (K1/K2; the
    # gallery's albedo field casts no shadow rays: K1 only), each against
    # its golden at its GOLDEN_GATES gate, and the meters against their
    # exact values
    print(f"  sensors, daylight, spectral {elapsed()}", flush=True)
    for label, xml, golden, checked, bins in (
            ("dispersion", dispersion_xml(32, 32), "torch_dispersion_32_4.npy", 2, None),
            ("dispersion 9 bins", dispersion_xml(32, 32), "torch_dispersion_spectral9_32_4.npy",
             2, 9),
            ("DAYLIGHT", daylight_xml(32, 32), "torch_daylight_32_4.npy", 2, None),
            ("preetham sky and sun", sky_sun_xml(32, 32), "torch_sky_sun_32_4.npy", 2, None),
            *((f"sensor {name}", sensor_xml(name), f"torch_sensor_{name}_24_4.npy", 1, None)
              for name in ("orthographic", "telecentric", "spherical", "thinlens", "rdist"))):
        got = render_checked(mt, brute, mt.load_scene_string(xml),
                             os.path.join(HERE, "tests", "golden", golden), dev, label, spp=4,
                             bins=bins)
        for k in list(brute)[:checked]:
            check(got[k] > 0, f"the {label} render never launched {k}")
        for k, n in got.items():
            launches[k] += n
    for name, (body, exact) in sorted(METERS.items()):
        img = mt.render(mt.load_scene_string(meter_xml(body)), seed=3, device=dev)
        err = float(abs(img - exact).max() / exact)
        print(f"phase 3: {name} in a unit constant environment: {img.reshape(-1).tolist()} "
              f"(exact {exact:.7g}, relative error {err:.3g})", flush=True)
        check(img.shape == (1, 1, 3) and err < (1e-5 if exact == 1.0 else 1e-3),
              f"{name}: {img.reshape(-1).tolist()} is not {exact}")
    # the motion slice and the remaining media, each against its golden at
    # its GOLDEN_GATES gate: MOTION (K1/K2), the deformable card (no static
    # rows), MOTION_BIG's 43 cubes and FIBER's media (K3/K4, K7/K8 on
    # overflow); the motion vectors within their gate's pixels; the moving
    # card's blur against its analytic shutter coverage
    print(f"  motion and fiber media {elapsed()}", flush=True)
    fiber_dir = fiber_assets(os.path.join(HERE, "build", "fiber_assets"))
    for label, xml, golden, names, photons in (
            ("MOTION", motion_xml(32, 32, 4), "torch_motion_32_4.npy", tuple(brute), None),
            ("deformable card", moving_card_xml("deformable", 3, spp=4, width=32, height=32),
             "torch_deform_card3_32_4.npy", (), None),
            ("MOTION_BIG 43 cubes", motion_big_xml(None, 32, 32, 4), "torch_motion_big_32_4.npy",
             glass_names, None),
            ("FIBER kkay", fiber_xml("kkay", fiber_dir, "grid", 24, 24),
             "torch_fiber_kkay_24_4.npy", smoke_names, None),
            ("FIBER microflake", fiber_xml("microflake", fiber_dir, "grid", 24, 24),
             "torch_fiber_microflake_24_4.npy", smoke_names, None),
            ("fiber slab bdpt", fiber_slab_xml("bdpt", fiber_dir),
             "torch_fiber_slab_bdpt_16_4.npy", glass_names, None),
            ("fiber slab photonmapper", fiber_slab_xml("photonmapper", fiber_dir),
             "torch_fiber_slab_photonmapper_16_4.npy", glass_names, 1 << 12)):
        with photon_env(photons):
            got = render_checked(mt, {k: counted[k] for k in names}, mt.load_scene_string(xml),
                                 os.path.join(HERE, "tests", "golden", golden), dev, label,
                                 spp=4)
        for k in names[:2]:  # K1/K2, or K3 and K4's closest hit
            check(got[k] > 0, f"the {label} render never launched {k}")
        for k, n in got.items():
            launches[k] += n
    from torch_meshes import CARD_GOLDEN_GATES, GOLDEN_GATES, MOTION_VECTOR_SHARE

    for golden, xml in (("torch_motion_vectors_d_32_1.npy", motion_vectors_xml("d")),
                        ("torch_motion_vectors_ttd_32_1.npy", glass_slab_motion_xml("ttd"))):
        gate = CARD_GOLDEN_GATES.get(golden, GOLDEN_GATES[golden])
        gold = np.load(os.path.join(HERE, "tests", "golden", golden))
        img = mt.render(mt.load_scene_string(xml), spp=1, seed=0, device=dev)
        check(img.shape == gold.shape, f"{golden}: image shape {img.shape} != {gold.shape}")
        diff = np.abs(img - gold).max(-1)
        off = float((diff > 1e-4).mean())
        print(f"phase 3: motion vectors {golden}: largest difference {float(diff.max()):.6g} "
              f"pixels (gate {gate:g}), {off:.4f} of the pixels off by more than 1e-4 (gate "
              f"{MOTION_VECTOR_SHARE}), largest motion {float(np.abs(gold).max()):.4f} pixels",
              flush=True)
        check(float(diff.max()) < gate and off <= MOTION_VECTOR_SHARE,
              f"{golden}: the motion vectors differ by {float(diff.max())} pixels")
        # each pixel off by more than 1e-4: its walk on the card and on the
        # CPU, step by step; on the card a chain trace of the walk must have
        # missed where the CPU's reached its end
        for y, x in np.argwhere(diff > 1e-4):
            lanes = [int(y) * img.shape[1] + int(x)]
            card_img, card_steps = walk_probes(mt, xml, dev, lanes)
            cpu_img, cpu_steps = walk_probes(mt, xml, "cpu", lanes)
            missed = [i for i, s in enumerate(card_steps[lanes[0]]) if not all(s)]
            print(f"  pixel ({y}, {x}): {diff[y, x]:.6g} pixels off (again on the card "
                  f"{float(np.abs(card_img[y, x] - gold[y, x]).max()):.6g}, the port on the CPU "
                  f"{float(np.abs(cpu_img[y, x] - gold[y, x]).max()):.6g}); the walk's chain "
                  f"traces that reached their end (at x, the two probes, the trial point) "
                  f"per Newton step on the card {card_steps[lanes[0]]}, on the CPU "
                  f"{cpu_steps[lanes[0]]}", flush=True)
            check(missed and all(all(s) for s in cpu_steps[lanes[0]]),
                  f"{golden}: pixel ({y}, {x}) is off, but not by a chain trace that missed "
                  f"on the card alone")
    for kind, frames in (("animated", 2), ("deformable", 3)):
        img = mt.render(mt.load_scene_string(moving_card_xml(kind, frames, spp=256)), spp=256,
                        seed=0, device=dev)
        row = img[img.shape[0] // 2].mean(axis=-1)
        expect = card_coverage(np.abs(1.0 - 2.0 * (np.arange(img.shape[1]) + 0.5)
                                      / img.shape[1]))
        sel = expect > 0.02
        err = float(np.abs(row - expect)[sel].max())
        energy = abs(float(row.sum() - expect.sum())) / float(expect.sum())
        print(f"phase 3: the {kind} card's blur ({frames} keyframes, 64x64, 256 spp) against "
              f"its shutter coverage: largest error {err:.4f} (gate 0.12), energy "
              f"{energy:.4f} (gate 0.03)", flush=True)
        check(err < 0.12 and energy < 0.03, f"the {kind} card's blur misses its coverage")
    # the geometry extras: the instancing, shapes and BVH-walk goldens;
    # the pair path against the loop path on INSTANCED's camera rays and
    # NEE
    print(f"  geometry extras {elapsed()}", flush=True)
    for k, n in extras_goldens(mt, counted, dev, feat_dir, clusters).items():
        launches[k] = launches.get(k, 0) + n
    instanced_pair_vs_loop(tis, tlas, inst_queries, inst_pack, "INSTANCED", card)
    for k, n in launches.items():
        check(n > 0, f"the render never launched {k}")

    # ---- phase 4: throughput at 512x512 ----
    print(f"phase 4: throughput {elapsed()}", flush=True)
    throughput(make_render_pass, new_film, pack, scene, dev, "cbox", card)
    throughput(make_render_pass, new_film, big_pack, big, dev, "bigmesh-standin", card)
    throughput(make_render_pass, new_film, dense_pack, dense, dev, "densemesh-standin", card)
    throughput(make_render_pass, new_film, real_pack, real, dev, "matpreview", card, passes=1,
               ref=MATPREVIEW_REF_512, iterations=lambda: pk.closest_hit_v2.launches)
    throughput(make_render_pass, new_film, mp_pack, mp, dev, "matpreview-const", card, passes=1,
               warm=False)
    throughput(make_render_pass, new_film, smoke_pack, smoke, dev, "smoke", card, passes=1,
               warm=False, ref=SMOKE_REF_256, iterations=lambda: vp.volpath_trace.events,
               spp=SMOKE_SPP, unit="event")
    print(f"phase 4: light transport {elapsed()}", flush=True)
    glass_counted = {k: counted[k] for k in glass_names}
    glass256 = mt.load_scene_string(glass_xml(256, 256))
    generator_throughput(
        "glass_caustics-bdpt", lambda: tb.iter_bdpt(glass256, glass_pack, 32, 0, dev),
        glass_counted, 256, 256, card, "chunk", budget_s=15.0, ref=GLASS_REF_256,
        note="; the reference's curve: 0.062 at 32 spp with 8 edges")
    # the scene's own film size: spp_chunk floors at 1, 262,144 lanes
    glass512 = mt.load_scene(os.path.join(HERE, "scenes", "glass_caustics.xml"))
    generator_throughput(
        "glass_caustics-bdpt", lambda: tb.iter_bdpt(glass512, glass_pack, 1, 0, dev),
        glass_counted, 512, 512, card, "chunk", budget_s=0.0)
    for fn in brute.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    img = tpt.render_ptracer(pt_scene, spp=4, pack=pack, device=dev)
    pt_s = time.time() - t0
    pt_rays = int(tpt.render_ptracer.last_ray_count)
    check(bool(np.isfinite(img).all()) and img.mean() > 0, "the ptracer image is not finite")
    print(f"phase 4: cbox ptracer 512x512, 4 particles per pixel (one batch of "
          f"{tpt.BATCH_MAX}): {pt_rays} rays in {pt_s:.3f} s = {pt_rays / pt_s:.6g} rays/s (no "
          f"warm-up), peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
          f"launches {({k: fn.launches for k, fn in brute.items()})} on {card}", flush=True)

    # the Metropolis slice: door as it stands (pssmlt, bidirectional, 8
    # edges; 65,536 chains) at DOOR_MUTATIONS per pixel, and unidirectional;
    # glass_caustics under pssmlt (16 edges) for about 8 s
    print(f"phase 4: Metropolis {elapsed()}", flush=True)
    door_counted = {k: counted[k] for k in glass_names}

    def pssmlt_steps(scene, pack):
        return lambda: ((img, done, st["rays"])
                        for img, done, _, st in tps.iter_pssmlt(scene, pack, DOOR_MUTATIONS, 0,
                                                                None, dev))

    door_uni = mt.load_scene_string(door_xml(bidirectional=False))
    glass_pssmlt = mt.load_scene_string(with_integrator(glass_xml(256, 256), "pssmlt"))
    door_launches = generator_throughput(
        "door-pssmlt", pssmlt_steps(door, door_pack), door_counted, 256, 256, card, "step",
        ref=DOOR_REF_256, setup=True, chains=65_536,
        note="; the reference's TPU run at 32 mutations per pixel: 0.0424 bidirectional, "
             "0.0728 unidirectional")
    for k in glass_names[:3]:
        check(door_launches[k] > 0, f"door's pssmlt never launched {k}")
    for k in glass_names:
        launches[k] += door_launches[k]
    generator_throughput(
        "door-pssmlt-unidirectional", pssmlt_steps(door_uni, door_pack), door_counted, 256,
        256, card, "step", ref=DOOR_REF_256, setup=True, chains=65_536,
        note="; the reference's TPU run at 32 mutations per pixel: 0.0728")
    generator_throughput(
        "glass-pssmlt", pssmlt_steps(glass_pssmlt, glass_pack), door_counted, 256, 256, card,
        "step", budget_s=8.0, ref=GLASS_REF_256, setup=True, chains=65_536,
        note="; never measured on the TPU")

    # the photon-mapping slice: glass under sppm (maxDepth 24, 2^18
    # photons an iteration) for about 8 s, smoke under the volumetric
    # photon mapper (2^17 photons) for about 5 s, both at 256x256, and
    # cbox under vpl at 512x512, 4 passes of 64 VPL paths
    print(f"phase 4: photon mapping {elapsed()}", flush=True)
    photon_throughput("glass_caustics-sppm", tsppm.iter_sppm, glass_sppm, glass_pack, 1 << 18,
                      glass_counted, card, GLASS_REF_256, 8.0, dev,
                      note="; bdpt's 0.0634 at 32 spp")
    photon_throughput("smoke-photonmapper", tpm.iter_photonmapper, smoke_pm, smoke_pack,
                      1 << 17, {k: counted[k] for k in smoke_names}, card, SMOKE_REF_256, 5.0,
                      dev)
    generator_throughput(
        "cbox-vpl", lambda: ((img, done, st["rays"])
                             for img, done, st in tvpl.iter_vpl(cbox_vpl, pack, 4, 0, dev)),
        brute, 512, 512, card, "pass", ref=CBOX_REF_512, vpls=tvpl.vpl_count())

    # the subsurface slice: dipole.xml as it stands (its launches are the
    # slice's main path: counters set to 0 just before each pass); cbox at
    # 256x256, 16 spp, under irrcache and adaptive over path at maxDepth 4
    print(f"phase 4: subsurface {elapsed()}", flush=True)
    dipole_launches = dipole_throughput(tsss, make_render_pass, new_film, dipole, dipole_pack,
                                        glass_counted, card, dev)
    for k in glass_names[:3]:
        check(dipole_launches[k] > 0, f"dipole.xml never launched {k}")
    for k in glass_names:
        launches[k] += dipole_launches[k]
    for kind, fn in (("irrcache", tic.render_irrcache), ("adaptive", tad.render_adaptive)):
        meta_throughput(mt, mt.load_scene_string(cbox_meta_xml(kind, NESTED_PATH, 256, 256)),
                        pack, brute, card, dev, f"cbox-{kind}", lambda fn=fn: dict(fn.last_stats),
                        16)

    # the hairball slice: scenes/hairball.xml as it stands (its launches
    # are the slice's main path: counters set to 0 just before each pass),
    # and its exact mode at the same size
    print(f"phase 4: hairball {elapsed()}", flush=True)
    hair_launches = hairball_throughput(make_render_pass, new_film, pairs, hairball, hair_pack,
                                        glass_counted, card, dev)
    for k in glass_names:
        check(hair_launches[k] > 0, f"hairball.xml never launched {k}")
        launches[k] += hair_launches[k]
    hairball_exact_throughput(make_render_pass, new_film, tcyl, hair_exact, exact_pack, card, dev)

    # the texture slice: TEXTURED at 512x512, 16 spp (its launches are the
    # slice's main path: counters set to 0 just before each pass), then a
    # pass under the ewa filter
    print(f"phase 4: textured {elapsed()}", flush=True)
    tex_launches = textured_throughput(make_render_pass, new_film, ttex, textured, tex_pack,
                                       glass_counted, card, dev)
    for k in glass_names:
        check(tex_launches[k] > 0, f"TEXTURED never launched {k}")
        launches[k] += tex_launches[k]

    # the sensors, the daylight emitters and spectral mode: dispersion.xml
    # as it stands in RGB mode and with 9 bins (its launches are the
    # slice's main path: counters set to 0 just before each render), then
    # DAYLIGHT at 512x512, 16 spp, in render's passes
    print(f"phase 4: sensors, daylight, spectral {elapsed()}", flush=True)
    disp_launches = dispersion_throughput(mt, dispersion, brute, card, dev)
    for k in brute:
        check(disp_launches[k] > 0, f"dispersion.xml never launched {k}")
        launches[k] += disp_launches[k]
    throughput(make_render_pass, new_film, day_pack, daylight, dev, "daylight", card, spp=8,
               iterations=lambda: pk.closest_hit_v2.launches)

    # the motion slice and the remaining media: MOTION at 512x512, 16 spp
    # in render's passes of 8, MOTION_BIG the same, FIBER kkay and
    # microflake at 256x256, one 32-spp pass (each render's launches are the
    # slice's main path: counters set to 0 just before it)
    print(f"phase 4: motion and fiber media {elapsed()}", flush=True)
    from profile_pass import FIBER_STAGES, MOTION_STAGES

    mot_launches = slice_throughput(
        mt, make_render_pass, new_film, motion, motion_pack, brute, card, dev, "MOTION",
        MOTION_STAGES, ("_anim_closest", "_anim_any", "_deform_closest", "_deform_any"))
    big_launches = slice_throughput(mt, make_render_pass, new_film, motion_big, mb_pack,
                                    glass_counted, card, dev, "MOTION_BIG")
    for k in brute:
        check(mot_launches[k] > 0, f"MOTION never launched {k}")
    for k in glass_names[:3]:
        check(big_launches[k] > 0, f"MOTION_BIG never launched {k}")
    for k, n in {**mot_launches, **big_launches}.items():
        launches[k] += n
    for phase in ("kkay", "microflake"):
        fiber = mt.load_scene_string(fiber_xml(phase, fiber_dir, "grid", 256, 256))
        fib_launches = slice_throughput(
            mt, make_render_pass, new_film, fiber, pack_scene(fiber, dev),
            {k: counted[k] for k in smoke_names}, card, dev, f"FIBER {phase}", FIBER_STAGES,
            ("phase_sample", "phase_eval", "phase_pdf"), ("_orient_at", f"_{phase}_eval"),
            lambda: {"medium_events": int(vp.volpath_trace.last_medium_events)})
        for k in smoke_names[:2]:
            check(fib_launches[k] > 0, f"FIBER {phase} never launched {k}")
            launches[k] += fib_launches[k]

    # the geometry extras: INSTANCED at 512x512 through render, one pass
    # of INSTANCED_SPP (its launches are the slice's main path: counters
    # set to 0 just before it); BIGBVH's pass and sorted intersect
    print(f"phase 4: geometry extras {elapsed()}", flush=True)
    inst_launches = instanced_throughput(mt, instanced, inst_pack, {**brute, **glass_counted},
                                         tlas, card)
    for k in glass_names[:3] + tuple(brute):
        check(inst_launches[k] > 0, f"INSTANCED never launched {k}")
    for k, n in inst_launches.items():
        launches[k] += n
    del inst_pack
    bigbvh_throughput(mt, tis, pack_scene, counted, dev, card)

    # the host side: the CLI and kdbench as subprocesses, checkpoint and
    # resume, the out-of-core film, lanes_per_pass, the .mtspack round
    # trip (each render's launches are the phase's main path: counters set
    # to 0 just before it; kdbench's are its timed calls')
    print(f"phase 5: host side {elapsed()}", flush=True)
    host_launches = host_phase(mt, brute, {k: counted[k] for k in glass_names}, big, big_pack,
                               dev, card)
    for k in ("closest_hit_v2", "any_hit_v2", "dense_cull", "pair_hit_closest",
              "cluster_traverse_closest"):
        check(host_launches.get(k, 0) > 0, f"the host phase never launched {k}")
    for k, n in host_launches.items():
        launches[k] += n

    # the parallel slice: the sharded render over an NCCL world of one and
    # two gloo ranks on the card, the elastic pass loop, the service, the
    # multi-host CLI and the entry (each render's launches are the phase's
    # main path: counters set to 0 just before it)
    print(f"phase 6: parallel {elapsed()}", flush=True)
    par_launches = parallel_phase(mt, pk, pairs, pb, tpath, brute,
                                  {k: counted[k] for k in glass_names}, dev, card, stats)
    for k in ("closest_hit_v2", "any_hit_v2", "dense_cull", "pair_hit_closest", "pair_hit_any",
              "cluster_traverse_closest", "cluster_traverse_any"):
        check(par_launches.get(k, 0) > 0, f"the parallel phase never launched {k}")
    for k, n in par_launches.items():
        launches[k] += n

    # the main shape of each kernel: cbox camera rays for K1/K2, K11 and
    # K12, the stand-ins' camera rays for the others (K9/K10: the seeded
    # subset);
    # no single PyTorch call computes any of these functions, so no
    # library time
    first = {}
    for s in stats:
        first.setdefault(s["name"], s)
    kernels = []
    for name, src, replaces in KERNELS:
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[src],
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(s["max_abs_err"] for s in stats if s["name"] == name),
            "ms": first[name]["ms"],
            "plain_ms": first[name]["plain_ms"],
            "bound_ms": first[name]["bound_ms"],
            "bound_by": first[name]["bound_by"],
            "library_ms": None,
        })
    print(f"done {elapsed()}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
