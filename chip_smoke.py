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
4. time passes of the regenerating wavefront at 512x512, 16 spp per
   pass, and report traced rays per second (closest-hit + shadow rays)
   for the Cornell box, both stand-ins, scenes/matpreview.xml and the
   matpreview variant (one timed pass, no warm-up); for
   scenes/matpreview.xml also the tone-mapped RMSE of its 32-spp image
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
   for about 60 s (at least 2 chunks, at most 32 spp: `glass_throughput`),
   with seconds per chunk, rays/s, peak device memory, K3/K4/K7/K8
   launches per chunk, the tone-mapped RMSE against
   bench_refs/glass_caustics_256.npz (no gate) and a profiled chunk's
   kernels and busy share; one chunk at the scene's own 512x512 (262,144
   lanes); and the particle tracer on cbox at 512x512, 4 particles per
   pixel (one batch of 1,048,576): seconds and rays/s.

The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.  Nothing of JAX is imported.
"""

import concurrent.futures
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
GLASS_GOLDEN = os.path.join(HERE, "tests", "golden", "glass_caustics_64_16.npy")
GLASS_PAIR_GOLDEN = os.path.join(HERE, "tests", "golden", "torch_glass_bdpt_16_4.npy")
PTRACER_GOLDEN = os.path.join(HERE, "tests", "golden", "torch_cbox_ptracer_64_16.npy")
SPOT_GOLDEN = os.path.join(HERE, "tests", "golden", "torch_spot_bdpt_24_16.npy")
MEDIA_GOLDEN = os.path.join(HERE, "tests", "golden", "torch_media_bdpt_24_16.npy")
MITCHELL_GOLDEN = os.path.join(HERE, "tests", "golden", "torch_cbox_mitchell_64_16.npy")
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


def render_checked(mt, counted, scene, golden_path, dev, label, pack=None, spp=16):
    """Render at the scene's film size (64x64 unless said otherwise), spp
    samples per pixel, seed 0 with the given launch counters set to 0 just
    before; check finiteness and the golden's gate (tests/torch_meshes.py
    GOLDEN_GATES, else tests/test_golden.py's 5e-3).  Returns the
    launches."""
    import numpy as np
    import torch
    from torch_meshes import GOLDEN_GATES

    gate = GOLDEN_GATES.get(os.path.basename(golden_path), 5e-3)

    for fn in counted.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    img = mt.render(scene, spp=spp, seed=0, device=dev, pack=pack)
    render_s = time.time() - t0
    launches = {k: fn.launches for k, fn in counted.items()}
    print(f"  {label}: peak device memory of the render "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    golden = np.load(golden_path)
    check(img.shape == golden.shape, f"{label}: image shape {img.shape} != {golden.shape}")
    check(bool(np.isfinite(img).all()), f"{label}: image has non-finite values")
    rmse = float(np.sqrt(np.mean((img / (1 + img) - golden / (1 + golden)) ** 2)))
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
        out["rmse_vs_ref"] = float(np.sqrt(np.mean((img / (1 + img) - gold / (1 + gold)) ** 2)))
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
    """One ray through each pixel centre of the scene's sensor."""
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
    o, d = generate_rays(cam, pos01, torch.zeros_like(pos01))
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


def matpreview_brute(pk, scene, pack, dev, stats, label):
    """K1/K2 on a matpreview scene's tri_s (its ground's two triangles)
    against their plain versions, bit for bit, on its camera rays (t_max
    1e30, as the renderer calls them) and on its shadow rays."""
    import torch

    (o, d), (o_s, d_s, t_s) = matpreview_rays(scene, pack, dev)
    n_tri = int((pack.tri_s[0] < FAR_V0).sum())
    check(n_tri == 2, f"{label}'s tri_s holds {n_tri} triangles, expected 2")
    t_far = torch.full((o.shape[0],), 1e30, device=dev)
    print(f"  {label}: {o.shape[0]} camera rays, {o_s.shape[0]} shadow rays "
          f"(t_max {float(t_s.min()):g}..{float(t_s.max()):g}), tri_s {tuple(pack.tri_s.shape)}",
          flush=True)
    for rays, tm in (((o, d), t_far), ((o_s, d_s), t_s)):
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


def device_us(evt):
    """Self device time of a profiler event average, in microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return getattr(evt, attr)
    return 0.0


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
    import torch

    inner, got = getattr(mod, name), []

    def spy(pack_, o, d, t_max):
        t = torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(o.shape[0])
        got.append((o.contiguous(), d.contiguous(), t.contiguous()))
        if len(got) == n:
            raise _Enough
        return inner(pack_, o, d, t_max)

    setattr(mod, name, spy)
    try:
        run()
    except _Enough:
        pass
    finally:
        setattr(mod, name, inner)
    check(len(got) == n, f"{mod.__name__}.{name} was called {len(got)} times, expected {n}")
    return got


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


def glass_throughput(tb, counted, scene, pack, dev, card, budget_s=60.0, max_spp=32):
    """bdpt on the glass scene at the scene's film size, chunk by chunk
    (iter_bdpt: MTS_BDPT_LANES lanes a chunk) until budget_s has passed,
    at least 2 chunks and up to max_spp: seconds per chunk, rays/s
    (closest-hit rays of live walk lanes plus the shadow rays of live
    connections), peak device memory, the kernels' launches per chunk, the
    tone-mapped RMSE against bench_refs/glass_caustics_256.npz where the
    film is 256x256; then one more chunk under the profiler: kernels per
    chunk and busy share."""
    import numpy as np
    import torch

    rec = scene.sensor.record
    w, h = rec.film.width, rec.film.height
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, img, done, rays = [], None, 0, 0
    t_all = t0 = time.time()
    for img, done, rays in tb.iter_bdpt(scene, pack, max_spp, 0, dev):
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        t0 = time.time()
        if len(times) >= 2 and time.time() - t_all >= budget_s:
            break
    n_rays = int(rays)
    launches = {k: fn.launches for k, fn in counted.items()}
    image = img().cpu().numpy()
    check(bool(np.isfinite(image).all()), f"glass {w}x{h}: image has non-finite values")
    total = sum(times)
    out = {"scene": "glass_caustics-bdpt", "width": w, "height": h, "chunks": len(times),
           "spp": done, "seconds_per_chunk": times, "rays": n_rays, "seconds": total,
           "rays_per_s": n_rays / total, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches_per_chunk": {k: n / len(times) for k, n in launches.items()}, "card": card}
    print(f"phase 4: glass_caustics bdpt {w}x{h}, {len(times)} chunks = {done} spp: seconds per "
          f"chunk {[round(x, 3) for x in times]}, {n_rays} rays in {total:.3f} s = "
          f"{out['rays_per_s']:.6g} rays/s, peak device memory {out['peak_gib']:.3f} GiB, "
          f"launches per chunk {out['launches_per_chunk']} on {card}", flush=True)
    if (w, h) == (256, 256):
        gold = np.load(GLASS_REF_256)["img"].astype(np.float32)
        out["rmse_vs_ref"] = float(np.sqrt(np.mean((image / (1 + image) - gold / (1 + gold)) ** 2)))
        print(f"  glass_caustics: tone-mapped RMSE of the {done}-spp image vs "
              f"{os.path.relpath(GLASS_REF_256, HERE)}: {out['rmse_vs_ref']:.6g} (no gate; the "
              f"reference's curve: 0.062 at 32 spp with 8 edges)", flush=True)
    from torch.profiler import ProfilerActivity, profile

    chunks = tb.iter_bdpt(scene, pack, max_spp, 0, dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        next(chunks)
        torch.cuda.synchronize()
        wall = time.time() - t0
    dev_ms, n_k = device_events(prof)
    out.update(profiled_wall_s=wall, device_ms=dev_ms, kernels_per_chunk=n_k,
               busy=dev_ms / 1e3 / wall)
    print(f"  glass_caustics: profiled chunk (CUDA activity) wall {wall:.4f} s, device time "
          f"{dev_ms:.3f} ms, busy share {out['busy']:.4f}; {n_k} kernels per chunk", flush=True)
    print(json.dumps({"throughput": out}), flush=True)
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
    from mitsuba_tpu_torch.integrator import bdpt as tb
    from mitsuba_tpu_torch.integrator import ptracer as tpt
    from mitsuba_tpu_torch.integrator import volpath as vp
    from torch_meshes import (
        bdpt_media_xml,
        bunny_scene_xml,
        bunny_standin,
        cbox_mitchell_xml,
        cbox_ptracer_xml,
        dense_standin,
        glass_xml,
        matpreview_const_xml,
        smoke_xml,
        two_wall_xml,
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
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
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
    for k, n in launches.items():
        check(n > 0, f"the render never launched {k}")

    # ---- phase 4: throughput at 512x512 ----
    print(f"phase 4: throughput {elapsed()}", flush=True)
    throughput(make_render_pass, new_film, pack, scene, dev, "cbox", card)
    throughput(make_render_pass, new_film, big_pack, big, dev, "bigmesh-standin", card)
    throughput(make_render_pass, new_film, dense_pack, dense, dev, "densemesh-standin", card)
    throughput(make_render_pass, new_film, real_pack, real, dev, "matpreview", card,
               ref=MATPREVIEW_REF_512, iterations=lambda: pk.closest_hit_v2.launches)
    throughput(make_render_pass, new_film, mp_pack, mp, dev, "matpreview-const", card, passes=1,
               warm=False)
    throughput(make_render_pass, new_film, smoke_pack, smoke, dev, "smoke", card, passes=1,
               warm=False, ref=SMOKE_REF_256, iterations=lambda: vp.volpath_trace.events,
               spp=SMOKE_SPP, unit="event")
    print(f"phase 4: light transport {elapsed()}", flush=True)
    glass_counted = {k: counted[k] for k in glass_names}
    glass256 = mt.load_scene_string(glass_xml(256, 256))
    glass_throughput(tb, glass_counted, glass256, glass_pack, dev, card)
    # the scene's own film size: spp_chunk floors at 1, 262,144 lanes
    glass512 = mt.load_scene(os.path.join(HERE, "scenes", "glass_caustics.xml"))
    glass_throughput(tb, glass_counted, glass512, glass_pack, dev, card, budget_s=0.0, max_spp=1)
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
