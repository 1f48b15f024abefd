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
// cid*Tc + j is slot j of cluster cid; dummy slots hold a far triangle).
//
// K3 (dense cull): one thread per ray.  The c cluster boxes (<= 1920,
// 46 KB) are staged in shared memory once per block as SoA rows, so a warp
// reads one broadcast word per box.  Each thread slab-tests every box in cid
// order and keeps the kk nearest entries in a sorted register list; an entry
// is inserted with a strict '<', so equal entries keep cid order: jnp.argmin's
// first-index tie-break of the reference's k-pass extraction.  Bound: FP32
// ALU, ~20 operations per (ray, box); 262k rays x 1k boxes is ~5 GFLOP.
//
// K4 (pair hit): one thread per (ray, list slot), slot-major so that the
// threads of a warp are neighbouring rays of one slot and mostly read the
// same cluster (broadcast loads from L2: cl_tri is ~5 MB for 1k clusters).
// Each thread runs Moller-Trumbore over its cluster's Tc triangles against
// the ray's t_max (the reference evaluates the same test as a bilinear form
// on the MXU; the port tests cl_tri directly, as K1 and K7 do) and writes
// the closest (t, prim, u, v) or the occlusion bit of its slot; the caller
// takes the min over the slots.  Bound: L2 bandwidth, 4.6 KB of triangles
// per (ray, slot).
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

#include <mutex>

#include "cluster_walk.cuh"
#include "ray_tri.cuh"

namespace {

using namespace mts;

constexpr int kThreads = 256;       // K3, K4
constexpr int kMaxClusters = 1920;  // shared-memory box capacity (46 KB)
constexpr int kMaxK = 8;            // longest per-ray cluster list
constexpr int kResidentWarps = 8;   // K7/K8 warps (one ray each) per block

// Stage the first n boxes of a [rows, 6] table as SoA rows
// s[a * kMaxClusters + cid], a = lox..hiz.
__device__ __forceinline__ void stage_boxes(float* s, const float* box, int n) {
  for (int k = threadIdx.x; k < 6 * n; k += blockDim.x) {
    const int a = k / n;
    const int cid = k - a * n;
    s[a * kMaxClusters + cid] = box[cid * 6 + a];
  }
  __syncthreads();
}

// ---------------------------------------------------------------- K3
__global__ void __launch_bounds__(kThreads)
dense_cull_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t_max,
                  const float* __restrict__ mbox, int n_rays, int c, int kk,
                  int* __restrict__ cid_out, float* __restrict__ ent_out,
                  int* __restrict__ n_cl_out, float* __restrict__ kept_out) {
  __shared__ float s_box[6 * kMaxClusters];
  stage_boxes(s_box, mbox, c);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(o, d, i);
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  const float tm = t_max[i];
  float key[kMaxK];
  int idx[kMaxK];
  for (int j = 0; j < kMaxK; ++j) {
    key[j] = kBig;
    idx[j] = c;
  }
  int n_cl = 0;
  for (int cid = 0; cid < c; ++cid) {
    float ent;
    if (!cull_slab(s_box[0 * kMaxClusters + cid], s_box[1 * kMaxClusters + cid],
                   s_box[2 * kMaxClusters + cid], s_box[3 * kMaxClusters + cid],
                   s_box[4 * kMaxClusters + cid], s_box[5 * kMaxClusters + cid],
                   r, ix, iy, iz, tm, &ent))
      continue;
    ++n_cl;
    keep_smallest(key, idx, kk, ent, cid);
  }
  for (int j = 0; j < kk; ++j) {
    cid_out[(long)i * kk + j] = key[j] < kBig ? idx[j] : c;
    ent_out[(long)i * kk + j] = key[j];
  }
  n_cl_out[i] = n_cl;
  kept_out[i] = key[kk - 1];
}

// ---------------------------------------------------------------- K4
template <bool kClosest>
__global__ void __launch_bounds__(kThreads)
pair_kernel(const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ t_max, const int* __restrict__ cids,
            const float* __restrict__ tri, const int* __restrict__ pad2prim,
            int n_rays, int kk, int c, int tc, long ct,
            float* __restrict__ t_out, int* __restrict__ prim_out,
            float* __restrict__ u_out, float* __restrict__ v_out,
            int* __restrict__ occ_out) {
  const long p = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long)n_rays * kk) return;
  const int k = (int)(p / n_rays);
  const int i = (int)(p - (long)k * n_rays);
  const long out = (long)i * kk + k;
  const int cid = cids[out];
  if (cid >= c) {  // empty list slot
    if (kClosest) {
      t_out[out] = kBig;
      prim_out[out] = -1;
      u_out[out] = 0.0f;
      v_out[out] = 0.0f;
    } else {
      occ_out[out] = 0;
    }
    return;
  }
  const Ray r = load_ray(o, d, i);
  const float tm = t_max[i];
  const long base = (long)cid * tc;
  if (kClosest) {
    float best_t = tm, best_u = 0.0f, best_v = 0.0f;
    int best = -1;
    for (int j = 0; j < tc; ++j) {
      float t, u, v;
      if (mt_hit(tri, ct, base + j, r, best_t, &t, &u, &v)) {
        best_t = t;
        best = j;
        best_u = u;
        best_v = v;
      }
    }
    t_out[out] = best_t;
    prim_out[out] = best >= 0 ? pad2prim[base + best] : -1;
    u_out[out] = best_u;
    v_out[out] = best_v;
  } else {
    int occ = tm <= 0.0f;
    for (int j = 0; j < tc && !occ; ++j) {
      float t, u, v;
      occ = mt_hit(tri, ct, base + j, r, tm, &t, &u, &v);
    }
    occ_out[out] = occ;
  }
}

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

// Blocks of K7 or K8 the current device holds at once with smem bytes of
// boxes each.  The runtime is asked once per (device, smem) and the answer
// kept: a pass launches the kernel ~70 times on one pack.
template <bool kClosest>
cudaError_t resident_blocks(size_t smem, int* blocks) {
  static std::mutex mu;
  static int last_dev = -1, last_blocks = 0;
  static size_t last_smem = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (dev != last_dev || smem != last_smem) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, resident_walk_kernel<kClosest>, 32 * kResidentWarps, smem);
    if (err != cudaSuccess) return err;
    last_dev = dev;
    last_smem = smem;
    last_blocks = sms * per_sm;
  }
  *blocks = last_blocks;
  return cudaSuccess;
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
    const cudaError_t err = resident_blocks<kClosest>(smem, &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long need = (n_rays + kResidentWarps - 1) / kResidentWarps;
    const int grid = (int)(need < (long)resident ? need : (long)resident);
    resident_walk_kernel<kClosest><<<grid > 0 ? grid : 1, 32 * kResidentWarps,
                                     smem, static_cast<cudaStream_t>(stream)>>>(
        o, d, t_max, box, tri, n_rays, cp, tc, ct, t_out, slot_out, u_out,
        v_out, occ_out, stats);
  }
  return static_cast<int>(cudaGetLastError());
}

int blocks_for(long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

int mts_cluster_limits(int* max_clusters, int* max_k) {
  *max_clusters = kMaxClusters;
  *max_k = kMaxK;
  return 0;
}

int mts_dense_cull(const float* o, const float* d, const float* t_max,
                   const float* mbox, int n_rays, int c, int kk, int* cid_out,
                   float* ent_out, int* n_cl_out, float* kept_out,
                   void* stream) {
  if (n_rays > 0) {
    dense_cull_kernel<<<blocks_for(n_rays), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        o, d, t_max, mbox, n_rays, c, kk, cid_out, ent_out, n_cl_out,
        kept_out);
  }
  return static_cast<int>(cudaGetLastError());
}

int mts_pair_closest(const float* o, const float* d, const float* t_max,
                     const int* cids, const float* tri, const int* pad2prim,
                     int n_rays, int kk, int c, int tc, long ct, float* t_out,
                     int* prim_out, float* u_out, float* v_out, void* stream) {
  if (n_rays > 0) {
    pair_kernel<true><<<blocks_for((long)n_rays * kk), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        o, d, t_max, cids, tri, pad2prim, n_rays, kk, c, tc, ct, t_out,
        prim_out, u_out, v_out, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

int mts_pair_any(const float* o, const float* d, const float* t_max,
                 const int* cids, const float* tri, int n_rays, int kk, int c,
                 int tc, long ct, int* occ_out, void* stream) {
  if (n_rays > 0) {
    pair_kernel<false><<<blocks_for((long)n_rays * kk), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        o, d, t_max, cids, tri, nullptr, n_rays, kk, c, tc, ct, nullptr,
        nullptr, nullptr, nullptr, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
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
