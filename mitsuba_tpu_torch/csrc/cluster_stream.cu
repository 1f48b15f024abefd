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
// s*G + m of 6 floats); cl_tri [9, C*Tc].
//
// K5 (two-level cull): one thread per ray.  The s <= 1536 super boxes
// (36 KB) are staged in shared memory as SoA rows; only the first s are
// tested, which masks the inverted padding by index (a symmetric slab test
// cannot reject an inverted box).  Each thread keeps the ks nearest supers in
// a sorted register list, then walks the kept supers in kept order and each
// one's G member boxes, read from global memory (G*24 bytes per super, from
// L2: cl_mbox is 236 KB at 9,856 clusters, too much for shared memory), in
// the reference's candidate order j*G + m, keeping the kk nearest.  Strict
// '<' insertion reproduces the first-index tie-break of the reference's
// k-pass argmin at both levels.  Bound: FP32 ALU, ~25 operations per slab
// test, s + G per kept super hit tests per ray: ~4.5 GFLOP at 262k camera
// rays of the 9,856-cluster stand-in.
//
// K6 (window pair kernel): the caller sorts the flattened [R, K] cluster
// lists by cluster id (the pair queue: cid_q [P], pair_q [P] = ray*K + slot;
// empty slots carry cid = c and sort last).  One block of 256 threads takes
// a window of 256 consecutive queue entries.  The window's runs of equal
// clusters are found with a block prefix count; their [9, Tc] triangle
// tiles (4.6 KB each) are staged in shared memory in stages of 8 tiles with
// cp.async, double-buffered so that stage n+1 loads while stage n is
// tested, the counterpart of the TPU kernel's double-buffered DMA.  Each
// thread runs Moller-Trumbore over its pair's staged tile (directly, not the
// bilinear cl_mt form of the MXU) and writes the slot's closest (t, prim, u,
// v) or occlusion at pair_q: results land in [R, K] order by index.  Nothing
// is dropped: the queue holds every slot.  Bound: each cluster's 4.6 KB
// read once per window that holds it (K4 reads it once per pair, from L2,
// which cl_tri's 45 MB at 9,856 clusters no longer fits), and ~50
// operations per (pair, triangle).  Tiles of one stage start 4 floats
// apart in bank order, so a warp spanning several runs does not conflict.
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

#include "cluster_walk.cuh"
#include "ray_tri.cuh"

namespace {

using namespace mts;

constexpr int kThreads = 256;      // K5
constexpr int kMaxSupers = 1536;   // K5 shared-memory super capacity (36 KB)
constexpr int kMaxKs = 8;          // longest kept-super list
constexpr int kMaxK = 8;           // longest per-ray cluster list
constexpr int kWindow = 256;       // K6 pairs per window = threads per block
constexpr int kStageTiles = 8;     // K6 cluster tiles per stage
constexpr int kWalkWarps = 4;      // K9/K10 rays (one warp each) per block

// ---------------------------------------------------------------- K5
__global__ void __launch_bounds__(kThreads)
two_level_cull_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ t_max,
                      const float* __restrict__ sup,
                      const float* __restrict__ mbox, int n_rays, int sp,
                      int s, int c, int g, int ks, int kk,
                      int* __restrict__ cid_out, float* __restrict__ ent_out,
                      int* __restrict__ n_sup_out,
                      float* __restrict__ kept_sup_out,
                      int* __restrict__ n_cl_out,
                      float* __restrict__ kept_cl_out) {
  __shared__ float s_sup[6 * kMaxSupers];
  for (int k = threadIdx.x; k < 6 * s; k += blockDim.x) {
    const int a = k / s;
    const int j = k - a * s;
    s_sup[a * kMaxSupers + j] = sup[(long)a * sp + j];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(o, d, i);
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  const float tm = t_max[i];

  // level 1: the ks nearest supers
  float skey[kMaxKs];
  int sid[kMaxKs];
  for (int j = 0; j < kMaxKs; ++j) {
    skey[j] = kBig;
    sid[j] = 0;
  }
  int n_sup = 0;
  for (int j = 0; j < s; ++j) {
    float ent;
    if (!cull_slab(s_sup[0 * kMaxSupers + j], s_sup[1 * kMaxSupers + j],
                   s_sup[2 * kMaxSupers + j], s_sup[3 * kMaxSupers + j],
                   s_sup[4 * kMaxSupers + j], s_sup[5 * kMaxSupers + j], r,
                   ix, iy, iz, tm, &ent))
      continue;
    ++n_sup;
    keep_smallest(skey, sid, ks, ent, j);
  }

  // level 2: the kk nearest members of the kept supers, in candidate order
  float ckey[kMaxK];
  int cid[kMaxK];
  for (int j = 0; j < kMaxK; ++j) {
    ckey[j] = kBig;
    cid[j] = c;
  }
  int n_cl = 0;
  for (int j = 0; j < ks; ++j) {
    if (!(skey[j] < kBig)) break;  // the list is sorted: the rest are empty
    for (int m = 0; m < g; ++m) {
      const int cl = sid[j] * g + m;
      if (cl >= c) break;  // padded members of the last super
      const float* b = mbox + (long)cl * 6;
      float ent;
      if (!cull_slab(b[0], b[1], b[2], b[3], b[4], b[5], r, ix, iy, iz, tm,
                     &ent))
        continue;
      ++n_cl;
      keep_smallest(ckey, cid, kk, ent, cl);
    }
  }

  for (int j = 0; j < kk; ++j) {
    cid_out[(long)i * kk + j] = ckey[j] < kBig ? cid[j] : c;
    ent_out[(long)i * kk + j] = ckey[j];
  }
  n_sup_out[i] = n_sup;
  kept_sup_out[i] = skey[ks - 1];
  n_cl_out[i] = n_cl;
  kept_cl_out[i] = ckey[kk - 1];
}

// ---------------------------------------------------------------- K6
template <bool kClosest>
__global__ void __launch_bounds__(kWindow)
window_kernel(const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ t_max, const int* __restrict__ cid_q,
              const int* __restrict__ pair_q, long n_pairs, int kk,
              const float* __restrict__ tri, const int* __restrict__ pad2prim,
              int c, int tc, long ct, float* __restrict__ t_out,
              int* __restrict__ prim_out, float* __restrict__ u_out,
              float* __restrict__ v_out, int* __restrict__ occ_out) {
  extern __shared__ __align__(16) float s_tiles[];  // [2][kStageTiles][stride]
  __shared__ int s_cid[kWindow];
  __shared__ int s_run_cid[kWindow];
  __shared__ int s_warp_runs[kWindow / 32];
  const int stride = 9 * tc + 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const long p = (long)blockIdx.x * kWindow + threadIdx.x;
  const bool in_q = p < n_pairs;
  const int cid = in_q ? cid_q[p] : c;
  const long pair = in_q ? pair_q[p] : 0;
  s_cid[threadIdx.x] = cid;
  __syncthreads();

  // runs of equal clusters: run index = inclusive count of run starts - 1
  const bool first = cid < c && (threadIdx.x == 0 || s_cid[threadIdx.x - 1] != cid);
  const unsigned starts = __ballot_sync(0xffffffffu, first);
  if (lane == 0) s_warp_runs[warp] = __popc(starts);
  __syncthreads();
  int run = __popc(starts & (0xffffffffu >> (31 - lane))) - 1;
  int n_runs = 0;
  for (int w = 0; w < kWindow / 32; ++w) {
    if (w < warp) run += s_warp_runs[w];
    n_runs += s_warp_runs[w];
  }
  if (first) s_run_cid[run] = cid;
  __syncthreads();

  // start the cp.async copies of stage st's tiles into buffer st % 2
  const int row_chunks = tc / 4;
  auto load_stage = [&](int st) {
    const int r0 = st * kStageTiles;
    const int n_t = min(kStageTiles, n_runs - r0);
    float* buf = s_tiles + (st & 1) * kStageTiles * stride;
    for (int k = threadIdx.x; k < n_t * 9 * row_chunks; k += kWindow) {
      const int t = k / (9 * row_chunks);
      const int rem = k - t * 9 * row_chunks;
      const int row = rem / row_chunks;
      const int q = rem - row * row_chunks;
      cp_async16(buf + t * stride + row * tc + 4 * q,
                 tri + row * ct + (long)s_run_cid[r0 + t] * tc + 4 * q);
    }
    cp_async_commit();
  };

  Ray r{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float tm = 0.0f;
  if (cid < c) {
    const long ray = pair / kk;
    r = load_ray(o, d, ray);
    tm = t_max[ray];
  }
  float best_t = tm, best_u = 0.0f, best_v = 0.0f;
  int best = -1;
  int occ = tm <= 0.0f;

  const int n_stages = (n_runs + kStageTiles - 1) / kStageTiles;
  if (n_stages > 0) load_stage(0);
  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) {
      load_stage(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (cid < c && run / kStageTiles == st) {
      const float* tile =
          s_tiles + ((st & 1) * kStageTiles + run - st * kStageTiles) * stride;
      if (kClosest) {
        for (int j = 0; j < tc; ++j) {
          float t, u, v;
          if (mt_hit(tile, tc, j, r, best_t, &t, &u, &v)) {
            best_t = t;
            best = j;
            best_u = u;
            best_v = v;
          }
        }
      } else {
        for (int j = 0; j < tc && !occ; ++j) {
          float t, u, v;
          occ = mt_hit(tile, tc, j, r, tm, &t, &u, &v);
        }
      }
    }
    __syncthreads();  // the buffer is refilled by stage st + 2
  }

  if (!in_q) return;
  if (kClosest) {
    const bool valid = cid < c;
    t_out[pair] = valid ? best_t : kBig;
    prim_out[pair] = valid && best >= 0 ? pad2prim[(long)cid * tc + best] : -1;
    u_out[pair] = valid ? best_u : 0.0f;
    v_out[pair] = valid ? best_v : 0.0f;
  } else {
    occ_out[pair] = cid < c ? occ : 0;
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

size_t window_smem(int tc) {
  return sizeof(float) * 2 * kStageTiles * (size_t)(9 * tc + 4);
}

template <bool kClosest>
int launch_window(const float* o, const float* d, const float* t_max,
                  const int* cid_q, const int* pair_q, long n_pairs, int kk,
                  const float* tri, const int* pad2prim, int c, int tc, long ct,
                  float* t_out, int* prim_out, float* u_out, float* v_out,
                  int* occ_out, void* stream) {
  if (tc % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs > 0) {
    const size_t smem = window_smem(tc);
    cudaError_t err = cudaFuncSetAttribute(
        window_kernel<kClosest>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    window_kernel<kClosest><<<blocks_for(n_pairs, kWindow), kWindow, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        o, d, t_max, cid_q, pair_q, n_pairs, kk, tri, pad2prim, c, tc, ct,
        t_out, prim_out, u_out, v_out, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mts_stream_limits(int* max_supers, int* max_ks, int* max_k) {
  *max_supers = kMaxSupers;
  *max_ks = kMaxKs;
  *max_k = kMaxK;
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
    two_level_cull_kernel<<<blocks_for(n_rays, kThreads), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        o, d, t_max, sup, mbox, n_rays, sp, s, c, g, ks, kk, cid_out, ent_out,
        n_sup_out, kept_sup_out, n_cl_out, kept_cl_out);
  }
  return static_cast<int>(cudaGetLastError());
}

int mts_window_closest(const float* o, const float* d, const float* t_max,
                       const int* cid_q, const int* pair_q, long n_pairs,
                       int kk, const float* tri, const int* pad2prim, int c,
                       int tc, long ct, float* t_out, int* prim_out,
                       float* u_out, float* v_out, void* stream) {
  return launch_window<true>(o, d, t_max, cid_q, pair_q, n_pairs, kk, tri,
                             pad2prim, c, tc, ct, t_out, prim_out, u_out,
                             v_out, nullptr, stream);
}

int mts_window_any(const float* o, const float* d, const float* t_max,
                   const int* cid_q, const int* pair_q, long n_pairs, int kk,
                   const float* tri, int c, int tc, long ct, int* occ_out,
                   void* stream) {
  return launch_window<false>(o, d, t_max, cid_q, pair_q, n_pairs, kk, tri,
                              nullptr, c, tc, ct, nullptr, nullptr, nullptr,
                              nullptr, occ_out, stream);
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
