// Big-mesh intersection over the BVH's treelet clusters (<= 128 triangles
// each, accel/clusters.py): the pair pipeline's cull and hit kernels and its
// per-ray fallback traversal.
//
// Replaces four TPU kernels of the reference:
//   K3 mitsuba_tpu/accel/pairs.py:196 _dense_cull_kernel -> mts_dense_cull
//   K4 mitsuba_tpu/accel/pairs.py:821 _runs_kernel       -> mts_pair_closest,
//                                                           mts_pair_any
//   K7 mitsuba_tpu/accel/pallas_bvh.py:122 _closest_kernel -> mts_cluster_closest
//   K8 mitsuba_tpu/accel/pallas_bvh.py:189 _any_kernel     -> mts_cluster_any
//
// Layouts: rays are [R, 3] row-major float32 (o, d) plus t_max [R] (finite:
// the caller maps inf to BIG).  Cluster boxes come as the reference packs
// them: cl_mbox as [rows, 6] (lo xyz, hi xyz; K3 reads the first c rows) and
// cl_box as [8, Cp] (rows lo xyz, hi xyz; padded clusters are inverted
// boxes).  Triangles: cl_tri [9, C*Tc] (rows v0xyz, e1xyz, e2xyz; column
// cid*Tc + j is slot j of cluster cid; dummy slots hold a far triangle with
// e2 = 0), read by K7/K8; cl_tri_rows [C*Tc, 9], the same triangles with each
// one's nine floats together (accel/pairs.py _tri_rows), and cl_cnt [C], the
// columns of each cluster's tile that can hold a hit (scene/builder.py
// cluster_columns), read by K4.
//
// K3 (dense cull): K5's group level (cluster_stream.cu) over the cluster
// boxes.  Persistent blocks of 256 threads, as many as the card holds at
// once, take rays grid-stride, one per thread.  Each block stages the c
// cluster boxes once, as SoA rows in dynamic shared memory (cluster j at
// j + j / 16: a word of skew per group, so lanes in different groups read
// different banks), and beside them the union boxes of groups of 16
// consecutive cluster ids (fminf of the lo rows, fmaxf of the hi rows; the
// last group may be partial): 51.8 KB at 1,920 clusters, past the 48 KB a
// block gets without cudaFuncSetAttribute.  Level 1 slab-tests every group
// into bit masks; then each lane pops its own hit groups in group order and
// slab-tests their clusters, so a warp takes as many group steps as its
// busiest lane.  The nearest entries go into a register list of kMaxK with
// strict '<' insertion (ray_tri.cuh keep_smallest_reg; the kk kept are its
// first kk).  Clusters arrive in cid order, so cid, entry, n_cl and kept_max
// are those of the full scan, tie order included: jnp.argmin's first index
// in the reference's k-pass extraction.
//   Exactness of the group level (K5's argument): a real cluster box has
// lo <= hi, and so has its group's union.  Correctly rounded '-', '*', fminf
// and fmaxf are monotone and safe_inv is finite, so per axis the group's
// slab interval [min(t0, t1), max(t0, t1)] contains each member's, whatever
// the sign of inv: the group's tn is <= and its tf >= each member's, and its
// entry max(tn, 0) is no later.  A cluster that passes cull_slab's
// (tf >= entry) & (tn < t_max) makes its group pass it.
//   Bound: FP32 ALU, ~25 operations per slab test.  The function needs c
// tests per ray (0.0756 ms at 262k rays and 773 clusters); this design does
// ceil(c / 16) group tests and the clusters of the hit groups (49 + 68 per
// camera ray of the 69k stand-in, 0.0115 ms), which chip_smoke.py prints.
// Groups of 8 and 32 were timed (PERF.md): 16 was the fastest in a render
// pass.  As in K5, the kernel takes the group size as an argument and the
// entry point passes kCullGroup.
//
// K4 (pair hit): one warp per ray over its kk slots, persistent blocks of 4
// warps.  A slot's tile, the first cl_cnt[cid] triangles of its cluster, is
// one contiguous block of cl_tri_rows, copied into the warp's buffer in
// shared memory by one Hopper bulk copy that completes an mbarrier (as in
// K6).  The lanes split the tile's columns (lane l takes l, l + 32, ...; a
// row is nine words, an odd stride, so the lanes read distinct banks).
// Closest: each lane keeps its first column of smallest t against the
// slot's own t_max (no tightening across slots: the [R, kk] outputs are the
// plain version's, slot by slot), and the lexicographic minimum of
// (t, column) over the lanes is the plain scan's first column of the
// smallest t (cluster_walk.cuh warp_min).  Any hit: 64 columns per
// __any_sync (two per lane), leaving at the first hit.  Empty slots are
// written without a load; lane k holds slot k's result and writes it.
//   Exactness of cl_cnt (K6's argument): past the last column whose e2 row
// is not all zero, p = d x e2 = 0 and det = 0, which mt_hit never accepts.
//   Bound: each pair's real triangles at ~53 operations per test (the
// function's bound; for this arithmetic about 2x optimistic, since
// -fmad=false runs no FMA); this design tests cl_cnt columns per pair (95.7
// per camera pair of the 69k stand-in, 94.3 real triangles).  Timed against
// it (PERF.md): one thread per (ray, slot) on cl_cnt columns (faster on
// coherent camera rays, 3-4x slower on random ones, slower in a render
// pass), the warp reading cl_tri through L1, unrolled column loops, ten
// blocks per SM, and a warp per 32 consecutive rays sharing one copy over
// each run of equal clusters: none was faster in a render pass.
//
// K7/K8 (cluster traversal, the overflow fallback): the reference's chunk
// kernel visits, per 1024-ray chunk, the union of the clusters its lanes hit
// in order of the chunk's nearest entry; each lane's own result is that of
// visiting its slab-hit clusters in order of its own entry (ties by cid, as
// a stable sort orders them), stopping once the next entry exceeds its best
// t (closest) or at its first hit (any).  These kernels compute exactly that
// walk per ray with the warp-per-ray walk of cluster_walk.cuh, which K9/K10
// (cluster_stream.cu) share; here the boxes come from shared memory, as the
// reference keeps them in SMEM and the tiles in VMEM:
//   * blocks of 8 warps, one ray per warp at a time, and as many blocks as
//     the card holds at once: a fallback batch of ~23k rays keeps every SM
//     busy, and a warp never waits for another's longer walk;
//   * each block stages the first six rows of cl_box ([6][Cp] SoA, 24 bytes
//     per cluster: 18.5 KB at 773 clusters, at most 46 KB) once with
//     cp.async, behind the block's only barrier;
//   * the warps take rays grid-stride, so the boxes are staged once per
//     resident block rather than once per few rays (a ray counter taken by
//     atomicAdd measured no faster on the H100: its zeroing costs a launch
//     and the fallback's walks are short);
//   * triangles stay in cl_tri (2.5 MB at 773 clusters), read from L2.
// Bound: the box scan, 25 FP32 operations and 24 bytes of shared memory per
// (ray, box) (six conflict-free word loads per 32 boxes), and 53 operations
// per real triangle of the clusters visited.  On the H100 the walk runs
// ~12x above that bound, and not for want of box bandwidth: at 773 clusters
// the boxes are as quick to read from L1 (K9/K10) as from shared memory.
// The compares, selects, list moves and shuffles around the arithmetic are
// the likely cost.
//
// Arithmetic: expressions follow the plain PyTorch versions (accel/pairs.py,
// accel/pallas_bvh.py) in order, and the file is built with -fmad=false, so
// kernel and plain versions round identically.  fminf/fmaxf differ from
// torch.minimum/maximum only on NaN, which no finite ray produces: 1/d is
// clamped to |d| >= 1e-20.
//
// Each entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for arguments it cannot take).

#include <climits>

#include "cluster_walk.cuh"
#include "ray_tri.cuh"

namespace {

using namespace mts;

constexpr int kCullThreads = 256;   // K3
constexpr int kCullGroup = 16;      // K3 consecutive clusters per group box
constexpr int kMaxClusters = 1920;  // K3 and K7/K8 shared-memory box capacity
constexpr int kGroupWords = (kMaxClusters / kCullGroup + 31) / 32;  // K3 words of hit-group bits
constexpr int kMaxK = 8;            // longest per-ray cluster list
constexpr int kPairWarps = 4;       // K4 rays (one warp each) per block
constexpr int kResidentWarps = 8;   // K7/K8 warps (one ray each) per block

int blocks_for(long n, int threads) { return (int)((n + threads - 1) / threads); }

// grid of a persistent kernel: as many blocks as the card holds at once
// (resident_blocks), no more than `need`
int persistent_grid(int resident, long need) {
  const long g = need < (long)resident ? need : (long)resident;
  return (int)(g > 0 ? g : 1);
}

// ---------------------------------------------------------------- K3
// Shared memory: [6][c + n_grp] box rows, cluster j at j + j / gs (a word of
// skew per group of gs clusters, so lanes in different groups read
// different banks), then [6][n_grp] group rows.
size_t cull_smem(int c, int gs) {
  const int n_grp = (c + gs - 1) / gs;
  return sizeof(float) * 6 * ((size_t)c + 2 * n_grp);
}

__global__ void __launch_bounds__(kCullThreads)
dense_cull_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t_max,
                  const float* __restrict__ mbox, int n_rays, int c, int kk,
                  int gs, int* __restrict__ cid_out,
                  float* __restrict__ ent_out, int* __restrict__ n_cl_out,
                  float* __restrict__ kept_out) {
  extern __shared__ float s_cull[];
  const int n_grp = (c + gs - 1) / gs;
  const int stride = c + n_grp;
  float* s_box = s_cull;
  float* s_grp = s_cull + 6 * stride;
  // cluster j's box (lo xyz, hi xyz: row j of cl_mbox) as three float2
  const float2* mb = reinterpret_cast<const float2*>(mbox);
  for (int j = threadIdx.x; j < c; j += blockDim.x) {
    const float2 b0 = __ldg(mb + 3L * j), b1 = __ldg(mb + 3L * j + 1),
                 b2 = __ldg(mb + 3L * j + 2);
    float* s = s_box + j + j / gs;
    s[0] = b0.x;
    s[stride] = b0.y;
    s[2 * stride] = b1.x;
    s[3 * stride] = b1.y;
    s[4 * stride] = b2.x;
    s[5 * stride] = b2.y;
  }
  __syncthreads();
  // group boxes: the union of each group's clusters
  for (int k = threadIdx.x; k < 6 * n_grp; k += blockDim.x) {
    const int a = k / n_grp;
    const int gi = k - a * n_grp;
    const float* row = s_box + a * stride + gi * (gs + 1);
    const int n = min(gs, c - gi * gs);
    float v = row[0];
    for (int t = 1; t < n; ++t) v = a < 3 ? fminf(v, row[t]) : fmaxf(v, row[t]);
    s_grp[a * n_grp + gi] = v;
  }
  __syncthreads();

  // rays grid-stride, the block's threads in step (no early exit: a warp
  // pops groups together, __any_sync)
  for (long base = (long)blockIdx.x * blockDim.x; base < n_rays;
       base += (long)gridDim.x * blockDim.x) {
    const long i = base + threadIdx.x;
    const bool live = i < n_rays;
    const Ray r =
        live ? load_ray(o, d, i) : Ray{0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f};
    const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
    const float tm = live ? t_max[i] : 0.0f;

    // level 1: the groups the ray hits, as bit masks
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

    // level 2: the clusters of the hit groups, in cid order; each lane
    // pops its own next hit group, so the warp runs as many group steps as
    // its busiest lane
    float key[kMaxK];
    int idx[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      key[j] = kBig;
      idx[j] = c;
    }
    int n_cl = 0;
#pragma unroll
    for (int w = 0; w < kGroupWords; ++w) {
      unsigned m = gmask[w];
      while (__any_sync(kFull, m != 0)) {
        if (m != 0) {
          const int gi = 32 * w + __ffs(m) - 1;
          m &= m - 1;
          const int j0 = gi * gs, n = min(gs, c - j0);
          const float* row = s_box + gi * (gs + 1);
          for (int t = 0; t < n; ++t) {
            float ent;
            if (!cull_slab(row[t], row[stride + t], row[2 * stride + t],
                           row[3 * stride + t], row[4 * stride + t],
                           row[5 * stride + t], r, ix, iy, iz, tm, &ent))
              continue;
            ++n_cl;
            keep_smallest_reg(key, idx, ent, j0 + t);
          }
        }
      }
    }

    if (live) {
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (j < kk) {
          cid_out[i * kk + j] = key[j] < kBig ? idx[j] : c;
          ent_out[i * kk + j] = key[j];
        }
      }
      n_cl_out[i] = n_cl;
      kept_out[i] = pick(key, kk - 1);
    }
  }
}

// ---------------------------------------------------------------- K4
// One warp per ray, over its kk slots.  Shared memory: one [tc, 9] tile
// buffer per warp (dynamic) and its mbarrier.
template <bool kClosest>
__global__ void __launch_bounds__(32 * kPairWarps)
pair_kernel(const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ t_max, const int* __restrict__ cids,
            const float* __restrict__ rows, const int* __restrict__ cl_cnt,
            const int* __restrict__ pad2prim, int n_rays, int kk, int c,
            int tc, float* __restrict__ t_out, int* __restrict__ prim_out,
            float* __restrict__ u_out, float* __restrict__ v_out,
            int* __restrict__ occ_out) {
  extern __shared__ __align__(128) float s_tiles[];  // [warps][tc][9]
  __shared__ __align__(8) unsigned long long s_full[kPairWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned bar = smem_addr(&s_full[warp]);
  if (lane == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  float* tile = s_tiles + (long)warp * 9 * tc;
  unsigned parity = 0;  // of the mbarrier's current phase
  for (long i = (long)blockIdx.x * kPairWarps + warp; i < n_rays;
       i += (long)gridDim.x * kPairWarps) {
    // lane k < kk holds slot k's cluster, the columns of its tile (the
    // first cl_cnt triangles: past them e2 = 0) and, at the end, its result
    const int my_cid = lane < kk ? cids[i * kk + lane] : c;
    const int my_cnt = my_cid < c ? min(tc, (cl_cnt[my_cid] + 3) & ~3) : 0;
    float res_t = kBig, res_u = 0.0f, res_v = 0.0f;
    int res = kClosest ? -1 : 0;
    if (__any_sync(kFull, my_cid < c)) {
      const Ray r = load_ray(o, d, i);
      const float tm = t_max[i];
      for (int k = 0; k < kk; ++k) {
        const int cid = __shfl_sync(kFull, my_cid, k);
        if (cid >= c) continue;  // an empty slot: no load
        if (!kClosest && tm <= 0.0f) {  // the reference's initial occlusion
          if (lane == k) res = 1;
          continue;
        }
        // the slot's tile: one contiguous block of cl_tri_rows
        const int cnt = __shfl_sync(kFull, my_cnt, k);
        __syncwarp();  // every lane is done with the last tile
        if (lane == 0) {
          // the buffer was last read through the generic proxy
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive_expect_tx(bar, 36 * cnt);
          if (cnt > 0) bulk_copy(tile, rows + (long)cid * tc * 9, 36 * cnt, bar);
        }
        mbar_wait(bar, parity);
        parity ^= 1;
        if (kClosest) {
          // lane l tests columns l, l + 32, ... against its own best;
          // the lexicographic minimum of (t, column) over the lanes is the
          // plain scan's first column of the smallest t.  A lane without
          // a hit holds (t_max, INT_MAX), and every hit has t < t_max.
          float lt = tm, lu = 0.0f, lv = 0.0f;
          int lj = INT_MAX;
          for (int j = lane; j < cnt; j += 32) {
            float t, u, v;
            if (mt_hit_row(tile, j, r, lt, &t, &u, &v)) {
              lt = t;
              lj = j;
              lu = u;
              lv = v;
            }
          }
          warp_min(&lt, &lj);
          // the winning column's lane holds its u, v as its own best
          const int src = lj == INT_MAX ? 0 : (lj & 31);
          const float wu = __shfl_sync(kFull, lu, src);
          const float wv = __shfl_sync(kFull, lv, src);
          if (lane == k) {
            res_t = lt;
            res = lj == INT_MAX ? -1 : pad2prim[(long)cid * tc + lj];
            res_u = lj == INT_MAX ? 0.0f : wu;
            res_v = lj == INT_MAX ? 0.0f : wv;
          }
        } else {
          constexpr int kCols = 64;  // columns per __any_sync: two per lane
          bool hit = false;
          for (int j0 = 0; j0 < cnt && !hit; j0 += kCols) {
            bool h = false;
#pragma unroll
            for (int s = 0; s < kCols; s += 32) {
              float t, u, v;
              const int j = j0 + s + lane;
              h = h | (j < cnt && mt_hit_row(tile, j, r, tm, &t, &u, &v));
            }
            hit = __any_sync(kFull, h);
          }
          if (lane == k) res = hit;
        }
      }
    }
    if (lane < kk) {
      const long out = i * kk + lane;
      if (kClosest) {
        t_out[out] = res_t;
        prim_out[out] = res;
        u_out[out] = res_u;
        v_out[out] = res_v;
      } else {
        occ_out[out] = res;
      }
    }
  }
}

// K4's tile buffers per block: one [tc, 9] tile per warp
size_t pair_smem(int tc) { return sizeof(float) * kPairWarps * 9 * (size_t)tc; }

// ---------------------------------------------------------------- K7/K8
// Ray i's walk (cluster_walk.cuh) over the boxes staged in shared memory,
// one ray per warp, grid-stride.
template <bool kClosest>
__global__ void __launch_bounds__(32 * kResidentWarps)
resident_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_max,
                     const float* __restrict__ box,
                     const float* __restrict__ tri, int n_rays, int cp, int tc,
                     long ct, float* __restrict__ t_out,
                     int* __restrict__ slot_out, float* __restrict__ u_out,
                     float* __restrict__ v_out, int* __restrict__ occ_out,
                     int* __restrict__ stats) {
  extern __shared__ float s_box[];  // rows lo xyz, hi xyz of cl_box: [6][cp]
  for (int k = threadIdx.x; k < 6 * cp; k += blockDim.x)
    cp_async4(s_box + k, box + k);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // the only barrier: from here each warp runs on its own
  const SharedBoxes boxes{s_box, cp};
  const long stride = (long)gridDim.x * kResidentWarps;
  for (long i = (long)blockIdx.x * kResidentWarps + (threadIdx.x >> 5);
       i < n_rays; i += stride) {
    if constexpr (kClosest) {
      walk_closest(boxes, o, d, t_max, tri, tc, ct, i, t_out, slot_out, u_out,
                   v_out, stats);
    } else {
      walk_any(boxes, o, d, t_max, tri, tc, ct, i, occ_out, stats);
    }
  }
}

// Launch K7 or K8 with as many blocks as the card holds at once (no more
// than the rays need), each staging the 24 * cp bytes of boxes once.
template <bool kClosest>
int launch_resident(const float* o, const float* d, const float* t_max,
                    const float* box, const float* tri, int n_rays, int cp,
                    int tc, long ct, float* t_out, int* slot_out, float* u_out,
                    float* v_out, int* occ_out, int* stats, void* stream) {
  if (cp > kMaxClusters) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays > 0) {
    const size_t smem = 6 * sizeof(float) * (size_t)cp;
    int resident = 0;
    const cudaError_t err = resident_blocks(
        reinterpret_cast<const void*>(resident_walk_kernel<kClosest>),
        32 * kResidentWarps, smem, &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident_walk_kernel<kClosest><<<persistent_grid(resident, blocks_for(n_rays, kResidentWarps)),
                                     32 * kResidentWarps, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
        o, d, t_max, box, tri, n_rays, cp, tc, ct, t_out, slot_out, u_out,
        v_out, occ_out, stats);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kClosest>
int launch_pairs(const float* o, const float* d, const float* t_max,
                 const int* cids, const float* rows, const int* cl_cnt,
                 const int* pad2prim, int n_rays, int kk, int c, int tc,
                 float* t_out, int* prim_out, float* u_out, float* v_out,
                 int* occ_out, void* stream) {
  if (kk < 1 || kk > kMaxK || tc <= 0 || tc % 4 != 0 ||
      pair_smem(tc) > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays > 0) {
    const size_t smem = pair_smem(tc);
    int resident = 0;
    const cudaError_t err = resident_blocks(
        reinterpret_cast<const void*>(pair_kernel<kClosest>), 32 * kPairWarps,
        smem, &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    pair_kernel<kClosest><<<persistent_grid(resident, blocks_for(n_rays, kPairWarps)),
                            32 * kPairWarps, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        o, d, t_max, cids, rows, cl_cnt, pad2prim, n_rays, kk, c, tc, t_out,
        prim_out, u_out, v_out, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mts_cluster_limits(int* max_clusters, int* max_k, int* group) {
  *max_clusters = kMaxClusters;
  *max_k = kMaxK;
  *group = kCullGroup;
  return 0;
}

int mts_dense_cull(const float* o, const float* d, const float* t_max,
                   const float* mbox, int n_rays, int c, int kk, int* cid_out,
                   float* ent_out, int* n_cl_out, float* kept_out,
                   void* stream) {
  if (c < 1 || c > kMaxClusters || kk < 1 || kk > kMaxK || kk > c)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays > 0) {
    const size_t smem = cull_smem(c, kCullGroup);
    int resident = 0;
    const cudaError_t err = resident_blocks(
        reinterpret_cast<const void*>(dense_cull_kernel), kCullThreads, smem,
        &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    dense_cull_kernel<<<persistent_grid(resident, blocks_for(n_rays, kCullThreads)),
                        kCullThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        o, d, t_max, mbox, n_rays, c, kk, kCullGroup, cid_out, ent_out,
        n_cl_out, kept_out);
  }
  return static_cast<int>(cudaGetLastError());
}

int mts_pair_closest(const float* o, const float* d, const float* t_max,
                     const int* cids, const float* rows, const int* cl_cnt,
                     const int* pad2prim, int n_rays, int kk, int c, int tc,
                     float* t_out, int* prim_out, float* u_out, float* v_out,
                     void* stream) {
  return launch_pairs<true>(o, d, t_max, cids, rows, cl_cnt, pad2prim, n_rays,
                            kk, c, tc, t_out, prim_out, u_out, v_out, nullptr,
                            stream);
}

int mts_pair_any(const float* o, const float* d, const float* t_max,
                 const int* cids, const float* rows, const int* cl_cnt,
                 int n_rays, int kk, int c, int tc, int* occ_out,
                 void* stream) {
  return launch_pairs<false>(o, d, t_max, cids, rows, cl_cnt, nullptr, n_rays,
                             kk, c, tc, nullptr, nullptr, nullptr, nullptr,
                             occ_out, stream);
}

int mts_cluster_closest(const float* o, const float* d, const float* t_max,
                        const float* box, const float* tri, int n_rays, int cp,
                        int tc, long ct, float* t_out, int* slot_out,
                        float* u_out, float* v_out, int* stats, void* stream) {
  return launch_resident<true>(o, d, t_max, box, tri, n_rays, cp, tc, ct,
                               t_out, slot_out, u_out, v_out, nullptr, stats,
                               stream);
}

int mts_cluster_any(const float* o, const float* d, const float* t_max,
                    const float* box, const float* tri, int n_rays, int cp,
                    int tc, long ct, int* occ_out, int* stats, void* stream) {
  return launch_resident<false>(o, d, t_max, box, tri, n_rays, cp, tc, ct,
                                nullptr, nullptr, nullptr, nullptr, occ_out,
                                stats, stream);
}

}  // extern "C"
