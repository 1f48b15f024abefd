// Dense-mesh intersection over the BVH's treelet clusters (meshes past the
// reference's dense-cull bound of 1,890 clusters and its VMEM-resident
// triangle tiles): the two-level cull, the cluster-sorted pair kernel and
// the streamed per-ray fallback traversal.
//
// Replaces four TPU kernels of the reference:
//   K5  mitsuba_tpu/accel/pairs.py:310 _cull_kernel      -> mts_two_level_cull
//   K6  mitsuba_tpu/accel/pairs.py:666 _pair_kernel      -> mts_window_closest,
//                                                           mts_window_any
//   K9  mitsuba_tpu/accel/pallas_bvh.py:222 _mxu_closest_kernel
//                                                        -> mts_stream_closest
//   K10 mitsuba_tpu/accel/pallas_bvh.py:333 _mxu_any_kernel -> mts_stream_any
//
// Layouts as in cluster_hit.cu: rays [R, 3] row-major (o, d) plus a finite
// t_max [R]; cl_sup and cl_box [8, Sp/Cp] (rows lo xyz, hi xyz; padded rows
// are inverted boxes); cl_mbox [Sp, G*6] (member m of super s at row
// s*G + m of 6 floats); cl_tri [9, C*Tc]; cl_tri_rows [C*Tc, 9], the same
// triangles with each one's nine floats together (accel/pairs.py
// _tri_rows); cl_cnt [C], the columns of each cluster's tile that can hold
// a hit (scene/builder.py cluster_columns).
//
// K5 (two-level cull): one thread per ray.  The s <= 1536 super boxes are
// staged in shared memory as SoA rows (super j at j + j / kGroup: a word of
// skew per group, so lanes in different groups read different banks), and
// beside them the boxes of groups of kGroup consecutive supers (the union of
// the group's real supers: fminf of the lo rows, fmaxf of the hi rows).  Level 1
// slab-tests every group, keeping a bit mask of the hit ones, then each lane
// pops its own next hit group and tests its supers: a warp takes as many
// group steps as its busiest lane, not the union of its lanes' groups (the
// difference on incoherent rays).  Each thread keeps the nearest supers in a
// sorted list, then walks the kept supers in kept order and each one's G
// member boxes, read from L2 as three 8-byte loads per 24-byte box, two
// boxes loaded before they are tested (cl_mbox is 236 KB at 9,856 clusters,
// too much for shared memory beside the supers), in the reference's
// candidate order j*G + m, keeping the nearest members.  Strict '<'
// insertion reproduces the first-index tie-break of the reference's k-pass
// argmin at both levels.
//   Exactness of the group level: every real super box has lo <= hi (it is
// a union of cluster boxes), and so has the group box.  Correctly rounded
// '-', '*', fminf and fmaxf are monotone, and inv = safe_inv(d) is finite, so
// per axis the group's slab interval [min(t0, t1), max(t0, t1)] contains
// each member's, whatever the sign of inv; hence the group's tn is <= and
// its tf >= those of each member, and its entry max(tn, 0) <= theirs.  A
// super that passes cull_slab's (tf >= entry) & (tn < t_max) makes its
// group pass it: every super the ray hits lies in a group it hits.  The
// supers still arrive in index order, so n_sup, the kept list, its tie
// order and kept_max are those of the full scan.
//   Lists: each insertion runs over the compile-time capacity (kMaxKs,
// kMaxK), unrolled and select-based, so that the lists stay in registers.
// The kept lists are the first ks / kk entries of these longer lists: with
// ties ordered by arrival, the n smallest of a stream are the first n of its
// N smallest.
//   Bound: FP32 ALU, ~25 operations per slab test.  The function needs s
// super tests and G per kept super hit per ray (its bound: 0.0669 ms at
// 262k camera rays of the 9,856-cluster stand-in); this design does
// ceil(s / kGroup) group tests, the supers of the hit groups and the same
// member tests, which chip_smoke.py prints per ray (0.0166 ms there).
// Groups of 16 were the fastest on an H100 (PERF.md: 8 and 32 measured);
// the kernel takes the group size as an argument all the same, since the
// build with it a compile-time constant ran 7-8 % slower.
//
// K6 (window pair kernel): the caller sorts the flattened [R, K] cluster
// lists by cluster id (the pair queue: cid_q [P], pair_q [P] = ray*K + slot;
// empty slots carry cid = c and sort last).  Persistent blocks of 4 warps,
// each warp on its own: it finds where the empty slots start (a 32-way
// search of the sorted cid_q), writes its share of the empty slots' outputs
// without staging anything, and walks its own contiguous share of the
// non-empty queue run by run (a run: the entries of one cluster).  A run's
// tile, the first cl_cnt[cid] triangles of the cluster, is one contiguous
// block of cl_tri_rows, copied into the warp's buffer with one Hopper bulk
// copy (cp.async.bulk, issued by lane 0) that completes an mbarrier in
// shared memory (nine per-row copies of cl_tri were 3-16 % slower,
// PERF.md).  One buffer per warp: the other resident warps hide a copy's
// wait (two and three buffers, each warp prefetching its next runs, were
// slower, at fewer warps per SM).  A run's entries go 32 at
// a time: lane e loads entry e's ray; a batch of at least kSplit entries
// gives each lane its own pair (all lanes read the same triangle: a
// broadcast), a smaller one tests its pairs one after the other with the
// lanes splitting the triangles (lane l takes l, l + 32, ...; the closest
// hit is the lexicographic minimum of (t, column) over the lanes: the first
// column of the smallest t, as the plain scan keeps it).  No warp waits for
// another or tests a triangle of a cluster its pair does not hold.  Results
// land in [R, K] order at pair_q.  Nothing is dropped: the queue holds
// every slot.
//   Exactness of cl_cnt: past the last column whose e2 row is not all zero,
// p = d x e2 = 0 and det = 0, which mt_hit never accepts; so testing only
// the first cl_cnt columns changes no result, whoever built the pack.
//   Bound: each pair's real triangles at ~53 operations per test (the
// function's bound; it counts an FMA as two of the 67 TFLOP/s FP32 peak's
// operations, but -fmad=false runs none, so for this arithmetic the bound
// is about 2x optimistic) and each run's tile read once; this design tests
// cl_cnt columns per pair (0.0212 ms at the stand-in's camera rays).
//
// K9/K10 (streamed cluster traversal, the overflow fallback): the
// warp-per-ray walk of cluster_walk.cuh, which K7/K8 (cluster_hit.cu)
// share, with the [8, Cp] boxes read from L2.  K7/K8 stage every box in
// shared memory, which caps them at 1,920 clusters; from L2 (236 KB of
// boxes at 9,856 clusters, just past a block's 227 KB) Cp has no cap.  One
// warp per ray, blocks of 4 warps that never wait for each
// other: a fallback launch of 10-30k rays puts 10-30k warps in flight, and
// no ray waits for another's longer walk.  What bounds the walk is the box
// scan: 25 operations and 24 bytes of L2 per (ray, box), over every box of
// the mesh, and a visit's 4.6 KB of triangles (53 operations per real
// triangle).  An optional stats output counts, per ray, the clusters whose
// triangles were tested and the box scans.
//
// Arithmetic: expressions follow the plain PyTorch versions (accel/pairs.py,
// accel/pallas_bvh.py) in order, through the helpers of ray_tri.cuh, and the
// file is built with -fmad=false, so kernel and plain versions round
// identically.
//
// Each entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for arguments it cannot take).

#include <climits>

#include "cluster_walk.cuh"
#include "ray_tri.cuh"

namespace {

using namespace mts;

constexpr int kThreads = 256;      // K5
constexpr int kMaxSupers = 1536;   // K5 super capacity (36 KB of shared memory)
constexpr int kGroup = 16;         // K5 consecutive supers per group box
constexpr int kMaxGroups = kMaxSupers / kGroup;
constexpr int kGroupWords = (kMaxGroups + 31) / 32;  // K5 words of hit-group bits
constexpr int kMaxKs = 8;          // longest kept-super list
constexpr int kMaxK = 8;           // longest per-ray cluster list
constexpr int kMemberStep = 2;     // K5 member boxes loaded together
constexpr int kWinWarps = 4;       // K6 warps per block
constexpr int kSplit = 16;         // K6 batch entries from which each lane takes a pair
constexpr int kWalkWarps = 4;      // K9/K10 rays (one warp each) per block

// ---------------------------------------------------------------- K5
// Shared memory: [6][stride] super rows, super j at j + j / gs (one word
// of skew per group of gs = kGroup supers, so lanes in different groups
// read different banks), then [6][n_grp] group rows.
__global__ void __launch_bounds__(kThreads)
two_level_cull_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ t_max,
                      const float* __restrict__ sup,
                      const float* __restrict__ mbox, int n_rays, int sp,
                      int s, int c, int g, int ks, int kk, int gs,
                      int* __restrict__ cid_out, float* __restrict__ ent_out,
                      int* __restrict__ n_sup_out,
                      float* __restrict__ kept_sup_out,
                      int* __restrict__ n_cl_out,
                      float* __restrict__ kept_cl_out) {
  extern __shared__ float s_cull[];
  const int n_grp = (s + gs - 1) / gs;
  const int stride = s + n_grp;
  float* s_sup = s_cull;
  float* s_grp = s_cull + 6 * stride;
  // each thread stages supers tid + 256 m, all its loads issued at once
#pragma unroll
  for (int m = 0; m < kMaxSupers / kThreads; ++m) {
    const int j = threadIdx.x + kThreads * m;
    if (j < s) {
      float v[6];
#pragma unroll
      for (int a = 0; a < 6; ++a) v[a] = sup[(long)a * sp + j];
#pragma unroll
      for (int a = 0; a < 6; ++a) s_sup[a * stride + j + j / gs] = v[a];
    }
  }
  __syncthreads();
  // group boxes: the union of each group's real supers
  for (int k = threadIdx.x; k < 6 * n_grp; k += blockDim.x) {
    const int a = k / n_grp;
    const int gi = k - a * n_grp;
    const float* row = s_sup + a * stride + gi * (gs + 1);
    const int n = min(gs, s - gi * gs);
    float v = row[0];
    for (int t = 1; t < n; ++t) v = a < 3 ? fminf(v, row[t]) : fmaxf(v, row[t]);
    s_grp[a * n_grp + gi] = v;
  }
  __syncthreads();
  // no early return: the warp pops groups together (__any_sync)
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays;
  const Ray r =
      live ? load_ray(o, d, i) : Ray{0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f};
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  const float tm = live ? t_max[i] : 0.0f;

  // level 1a: the groups the ray hits, as bit masks
  unsigned gmask[kGroupWords];
#pragma unroll
  for (int w = 0; w < kGroupWords; ++w) {
    unsigned m = 0;
    const int g1 = min(n_grp, 32 * w + 32);
    for (int gi = 32 * w; gi < g1; ++gi) {
      float ent;
      if (cull_slab(s_grp[gi], s_grp[n_grp + gi], s_grp[2 * n_grp + gi],
                    s_grp[3 * n_grp + gi], s_grp[4 * n_grp + gi],
                    s_grp[5 * n_grp + gi], r, ix, iy, iz, tm, &ent))
        m |= 1u << (gi - 32 * w);
    }
    gmask[w] = live ? m : 0u;
  }

  // level 1b: the supers of the hit groups, in index order; each lane
  // pops its own next hit group, so the warp runs as many group steps as
  // its busiest lane (not the union of its lanes' groups)
  float skey[kMaxKs];
  int sid[kMaxKs];
#pragma unroll
  for (int j = 0; j < kMaxKs; ++j) {
    skey[j] = kBig;
    sid[j] = 0;
  }
  int n_sup = 0;
#pragma unroll
  for (int w = 0; w < kGroupWords; ++w) {
    unsigned m = gmask[w];
    while (__any_sync(kFull, m != 0)) {
      if (m != 0) {
        const int gi = 32 * w + __ffs(m) - 1;
        m &= m - 1;
        const int j0 = gi * gs, n = min(gs, s - j0);
        const float* row = s_sup + gi * (gs + 1);
        for (int t = 0; t < n; ++t) {
          float ent;
          if (!cull_slab(row[t], row[stride + t], row[2 * stride + t],
                         row[3 * stride + t], row[4 * stride + t],
                         row[5 * stride + t], r, ix, iy, iz, tm, &ent))
            continue;
          ++n_sup;
          keep_smallest_reg(skey, sid, ent, j0 + t);
        }
      }
    }
  }
  int kept[kMaxKs];  // the ks kept supers, -1 for an empty entry
#pragma unroll
  for (int j = 0; j < kMaxKs; ++j)
    kept[j] = j < ks && skey[j] < kBig ? sid[j] : -1;

  // level 2: the nearest members of the ks kept supers, in candidate
  // order, kMemberStep boxes loaded before they are tested
  float ckey[kMaxK];
  int cid[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    ckey[j] = kBig;
    cid[j] = c;
  }
  int n_cl = 0;
  const float2* mb = reinterpret_cast<const float2*>(mbox);
#pragma unroll
  for (int j = 0; j < kMaxKs; ++j) {
    if (kept[j] < 0) continue;  // sorted: the rest are empty
    const int first = kept[j] * g;
    const int last = min(c, first + g);  // padded members of the last super
    for (int m0 = first; m0 < last; m0 += kMemberStep) {
      float2 b[kMemberStep][3];
#pragma unroll
      for (int u = 0; u < kMemberStep; ++u) {
        const long cl = min(m0 + u, last - 1);
        b[u][0] = __ldg(mb + 3 * cl);
        b[u][1] = __ldg(mb + 3 * cl + 1);
        b[u][2] = __ldg(mb + 3 * cl + 2);
      }
#pragma unroll
      for (int u = 0; u < kMemberStep; ++u) {
        float ent;
        if (m0 + u < last &&
            cull_slab(b[u][0].x, b[u][0].y, b[u][1].x, b[u][1].y, b[u][2].x,
                      b[u][2].y, r, ix, iy, iz, tm, &ent)) {
          ++n_cl;
          keep_smallest_reg(ckey, cid, ent, m0 + u);
        }
      }
    }
  }

  if (!live) return;
  n_sup_out[i] = n_sup;
  kept_sup_out[i] = pick(skey, ks - 1);
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < kk) {
      cid_out[(long)i * kk + j] = ckey[j] < kBig ? cid[j] : c;
      ent_out[(long)i * kk + j] = ckey[j];
    }
  }
  n_cl_out[i] = n_cl;
  kept_cl_out[i] = pick(ckey, kk - 1);
}

size_t cull_smem(int s) {
  const int n_grp = (s + kGroup - 1) / kGroup;
  return sizeof(float) * 6 * ((size_t)s + 2 * n_grp);
}

// ---------------------------------------------------------------- K6
// a batch entry's ray and t_max, staged in shared memory as two float4
__device__ __forceinline__ Ray staged_ray(const float4 (&s)[2], float* tm) {
  const float4 a = s[0], b = s[1];
  *tm = b.z;
  return Ray{a.x, a.y, a.z, a.w, b.x, b.y};
}

// One warp walks its own share of the non-empty queue run by run: a run
// (the entries of one cluster) is copied into the warp's tile buffer, then
// tested.  The entries of a run are taken 32 at a time (a batch): lane e
// stages entry e's ray in shared memory; a batch of at least kSplit entries
// gives each lane its own pair (all lanes read the same column: a
// broadcast), a smaller one tests its pairs one after the other, the lanes
// splitting the columns (lane l takes l, l + 32, ...; the closest hit is
// the lexicographic minimum of (t, column) over the lanes, the first column
// of the smallest t, as in the plain version's scan).
template <bool kClosest>
__global__ void __launch_bounds__(32 * kWinWarps)
window_kernel(const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ t_max, const int* __restrict__ cid_q,
              const int* __restrict__ pair_q, long n_pairs, int kk,
              const float* __restrict__ rows, const int* __restrict__ cl_cnt,
              const int* __restrict__ pad2prim, int c, int tc,
              float* __restrict__ t_out, int* __restrict__ prim_out,
              float* __restrict__ u_out, float* __restrict__ v_out,
              int* __restrict__ occ_out) {
  extern __shared__ __align__(128) float s_tiles[];  // [warps][tc][9]
  __shared__ float4 s_ray[kWinWarps][32][2];  // a batch's rays and t_max
  __shared__ __align__(8) unsigned long long s_full[kWinWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // empty slots sort last: [n_valid, n_pairs) get their outputs directly.
  // Each warp finds n_valid, the first entry with cid >= c, by probing 32
  // evenly spaced entries of [lo, hi) per step (the predicate holds on a
  // prefix); ~4 dependent loads at the dense stand-in's 786k entries.
  long lo = 0, hi = n_pairs;
  while (lo < hi) {
    const long step = (hi - lo + 31) / 32;
    const long pos = lo + lane * step;
    const int below = __popc(__ballot_sync(kFull, pos < hi && cid_q[pos] < c));
    if (below == 0) {
      hi = lo;
    } else {
      const long next_lo = lo + (below - 1) * step + 1;
      const long next_hi = lo + below * step;
      hi = next_hi < hi ? next_hi : hi;
      lo = next_lo;
    }
  }
  const long n_valid = lo;
  for (long p = n_valid + (long)blockIdx.x * blockDim.x + threadIdx.x;
       p < n_pairs; p += (long)gridDim.x * blockDim.x) {
    const long pair = pair_q[p];
    if (kClosest) {
      t_out[pair] = kBig;
      prim_out[pair] = -1;
      u_out[pair] = 0.0f;
      v_out[pair] = 0.0f;
    } else {
      occ_out[pair] = 0;
    }
  }

  // this warp's share [w0, w1) of the non-empty queue
  const long n_warps = (long)gridDim.x * kWinWarps;
  const long gw = (long)blockIdx.x * kWinWarps + warp;
  const long w0 = n_valid * gw / n_warps, w1 = n_valid * (gw + 1) / n_warps;
  if (w0 >= w1) return;  // the whole warp; no block barrier follows
  const unsigned bar = smem_addr(&s_full[warp]);
  if (lane == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  float* tile = s_tiles + (long)warp * 9 * tc;

  // lanes hold cid_q[base + lane] (-1 past w1), to find where runs end
  long base = w0;
  int wcid = base + lane < w1 ? cid_q[base + lane] : -1;
  unsigned parity = 0;  // of the mbarrier's current phase
  for (long first = w0; first < w1; parity ^= 1) {
    // the run [first, end): the entries of cluster cid; warp-uniform
    while (first >= base + 32) {
      base += 32;
      wcid = base + lane < w1 ? cid_q[base + lane] : -1;
    }
    int at = (int)(first - base);
    const int cid = __shfl_sync(kFull, wcid, at);
    long end;
    for (;;) {
      const unsigned m = __ballot_sync(kFull, lane >= at && wcid != cid);
      if (m) {
        end = base + __ffs(m) - 1;
        break;
      }
      base += 32;
      wcid = base + lane < w1 ? cid_q[base + lane] : -1;
      at = 0;
    }
    const int cnt = min(tc, (cl_cnt[cid] + 3) & ~3);
    __syncwarp();  // every lane is done with the last run's tile
    if (lane == 0) {
      // the buffer was last read through the generic proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive_expect_tx(bar, 36 * cnt);
      if (cnt > 0) bulk_copy(tile, rows + (long)cid * tc * 9, 36 * cnt, bar);
    }
    mbar_wait(bar, parity);
    for (long q = first; q < end; q += 32) {
      const int n = (int)min(32L, end - q);
      const bool mine = lane < n;
      int pair = 0;
      __syncwarp();  // every lane is done with the last batch's rays
      if (mine) {
        pair = pair_q[q + lane];
        const int ray = pair / kk;
        const Ray r = load_ray(o, d, ray);
        s_ray[warp][lane][0] = make_float4(r.ox, r.oy, r.oz, r.dx);
        s_ray[warp][lane][1] = make_float4(r.dy, r.dz, t_max[ray], 0.0f);
      }
      __syncwarp();
      if (kClosest) {
        float best_t = 0.0f, best_u = 0.0f, best_v = 0.0f;
        int best = -1;
        if (n >= kSplit) {  // a pair per lane
          if (mine) {
            const Ray r = staged_ray(s_ray[warp][lane], &best_t);
            for (int j = 0; j < cnt; ++j) {
              float t, u, v;
              if (mt_hit_row(tile, j, r, best_t, &t, &u, &v)) {
                best_t = t;
                best = j;
                best_u = u;
                best_v = v;
              }
            }
          }
        } else {  // the lanes split each pair's columns
          for (int e = 0; e < n; ++e) {
            float lt, lu = 0.0f, lv = 0.0f;
            const Ray re = staged_ray(s_ray[warp][e], &lt);
            int lj = INT_MAX;
#pragma unroll 4
            for (int j = lane; j < cnt; j += 32) {
              float t, u, v;
              if (mt_hit_row(tile, j, re, lt, &t, &u, &v)) {
                lt = t;
                lj = j;
                lu = u;
                lv = v;
              }
            }
            // lexicographic minimum of (t, column); a lane without a hit
            // holds (t_max, INT_MAX), and every hit has t < t_max
            float mt = lt;
            int mj = lj;
            warp_min(&mt, &mj);
            // the winning column's lane holds its u, v as its own best
            const int src = mj == INT_MAX ? 0 : (mj & 31);
            const float wu = __shfl_sync(kFull, lu, src);
            const float wv = __shfl_sync(kFull, lv, src);
            if (lane == e) {
              best_t = mt;
              best = mj == INT_MAX ? -1 : mj;
              best_u = wu;
              best_v = wv;
            }
          }
        }
        if (mine) {
          t_out[pair] = best_t;
          prim_out[pair] = best >= 0 ? pad2prim[(long)cid * tc + best] : -1;
          u_out[pair] = best_u;
          v_out[pair] = best_v;
        }
      } else {
        int occ = 0;
        if (n >= kSplit) {  // a pair per lane
          if (mine) {
            float tm;
            const Ray r = staged_ray(s_ray[warp][lane], &tm);
            occ = tm <= 0.0f;
            for (int j = 0; j < cnt && !occ; ++j) {
              float t, u, v;
              occ = mt_hit_row(tile, j, r, tm, &t, &u, &v);
            }
          }
        } else {  // the lanes split each pair's columns, 32 at a time
          for (int e = 0; e < n; ++e) {
            float te;
            const Ray re = staged_ray(s_ray[warp][e], &te);
            bool hit = te <= 0.0f;
            for (int j0 = 0; j0 < cnt && !hit; j0 += 32) {
              float t, u, v;
              const bool h = j0 + lane < cnt &&
                             mt_hit_row(tile, j0 + lane, re, te, &t, &u, &v);
              hit = __any_sync(kFull, h);
            }
            if (lane == e) occ = hit;
          }
        }
        if (mine) occ_out[pair] = occ;
      }
    }
    first = end;
  }
}

// ---------------------------------------------------------------- K9/K10
// One warp per ray (cluster_walk.cuh), boxes read from L2.
__global__ void __launch_bounds__(32 * kWalkWarps)
walk_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ t_max, const float* __restrict__ box,
                const float* __restrict__ tri, int n_rays, int cp, int tc,
                long ct, int* __restrict__ occ_out, int* __restrict__ stats) {
  const long i = (long)blockIdx.x * kWalkWarps + (threadIdx.x >> 5);
  if (i >= n_rays) return;  // the whole warp
  walk_any(L2Boxes{box, cp}, o, d, t_max, tri, tc, ct, i, occ_out, stats);
}

__global__ void __launch_bounds__(32 * kWalkWarps)
walk_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_max,
                    const float* __restrict__ box,
                    const float* __restrict__ tri, int n_rays, int cp, int tc,
                    long ct, float* __restrict__ t_out,
                    int* __restrict__ slot_out, float* __restrict__ u_out,
                    float* __restrict__ v_out, int* __restrict__ stats) {
  const long i = (long)blockIdx.x * kWalkWarps + (threadIdx.x >> 5);
  if (i >= n_rays) return;  // the whole warp
  walk_closest(L2Boxes{box, cp}, o, d, t_max, tri, tc, ct, i, t_out, slot_out,
               u_out, v_out, stats);
}


int blocks_for(long n, int threads) { return (int)((n + threads - 1) / threads); }

// K6's tile buffers per block: one [tc, 9] tile per warp
size_t window_smem(int tc) { return sizeof(float) * kWinWarps * 9 * (size_t)tc; }

// Launch K6 with as many blocks as the card holds at once (no more than
// one warp per 32 queue entries).
template <bool kClosest>
int launch_window(const float* o, const float* d, const float* t_max,
                  const int* cid_q, const int* pair_q, long n_pairs, int kk,
                  const float* rows, const int* cl_cnt, const int* pad2prim,
                  int c, int tc, float* t_out, int* prim_out, float* u_out,
                  float* v_out, int* occ_out, void* stream) {
  if (tc % 4 != 0 || tc <= 0 || window_smem(tc) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs > 0) {
    const size_t smem = window_smem(tc);
    int resident = 0;
    const cudaError_t err = resident_blocks(
        reinterpret_cast<const void*>(window_kernel<kClosest>), 32 * kWinWarps,
        smem, &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long need = blocks_for(n_pairs, 32 * kWinWarps);
    const int grid = (int)(need < (long)resident ? need : (long)resident);
    window_kernel<kClosest><<<grid > 0 ? grid : 1, 32 * kWinWarps, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        o, d, t_max, cid_q, pair_q, n_pairs, kk, rows, cl_cnt, pad2prim, c,
        tc, t_out, prim_out, u_out, v_out, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mts_stream_limits(int* max_supers, int* max_ks, int* max_k, int* group) {
  *max_supers = kMaxSupers;
  *max_ks = kMaxKs;
  *max_k = kMaxK;
  *group = kGroup;
  return 0;
}

int mts_two_level_cull(const float* o, const float* d, const float* t_max,
                       const float* sup, const float* mbox, int n_rays, int sp,
                       int s, int c, int g, int ks, int kk, int* cid_out,
                       float* ent_out, int* n_sup_out, float* kept_sup_out,
                       int* n_cl_out, float* kept_cl_out, void* stream) {
  if (s > kMaxSupers || ks < 1 || ks > kMaxKs || kk < 1 || kk > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays > 0) {
    two_level_cull_kernel<<<blocks_for(n_rays, kThreads), kThreads,
                            cull_smem(s), static_cast<cudaStream_t>(stream)>>>(
        o, d, t_max, sup, mbox, n_rays, sp, s, c, g, ks, kk, kGroup, cid_out,
        ent_out, n_sup_out, kept_sup_out, n_cl_out, kept_cl_out);
  }
  return static_cast<int>(cudaGetLastError());
}

int mts_window_closest(const float* o, const float* d, const float* t_max,
                       const int* cid_q, const int* pair_q, long n_pairs,
                       int kk, const float* rows, const int* cl_cnt,
                       const int* pad2prim, int c, int tc, float* t_out,
                       int* prim_out, float* u_out, float* v_out,
                       void* stream) {
  return launch_window<true>(o, d, t_max, cid_q, pair_q, n_pairs, kk, rows,
                             cl_cnt, pad2prim, c, tc, t_out, prim_out, u_out,
                             v_out, nullptr, stream);
}

int mts_window_any(const float* o, const float* d, const float* t_max,
                   const int* cid_q, const int* pair_q, long n_pairs, int kk,
                   const float* rows, const int* cl_cnt, int c, int tc,
                   int* occ_out, void* stream) {
  return launch_window<false>(o, d, t_max, cid_q, pair_q, n_pairs, kk, rows,
                              cl_cnt, nullptr, c, tc, nullptr, nullptr,
                              nullptr, nullptr, occ_out, stream);
}

int mts_stream_closest(const float* o, const float* d, const float* t_max,
                       const float* box, const float* tri, int n_rays, int cp,
                       int tc, long ct, float* t_out, int* slot_out,
                       float* u_out, float* v_out, int* stats, void* stream) {
  if (n_rays > 0) {
    walk_closest_kernel<<<blocks_for(n_rays, kWalkWarps), 32 * kWalkWarps, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        o, d, t_max, box, tri, n_rays, cp, tc, ct, t_out, slot_out, u_out,
        v_out, stats);
  }
  return static_cast<int>(cudaGetLastError());
}

int mts_stream_any(const float* o, const float* d, const float* t_max,
                   const float* box, const float* tri, int n_rays, int cp,
                   int tc, long ct, int* occ_out, int* stats, void* stream) {
  if (n_rays > 0) {
    walk_any_kernel<<<blocks_for(n_rays, kWalkWarps), 32 * kWalkWarps, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        o, d, t_max, box, tri, n_rays, cp, tc, ct, occ_out, stats);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
