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
// K7/K8 (cluster traversal, the overflow fallback): one thread per ray.  The
// reference's chunk kernel visits, per 1024-ray chunk, the union of the
// clusters its lanes hit in order of the chunk's nearest entry; each lane's
// own result is that of visiting its slab-hit clusters in order of its own
// entry (ties by cid, as a stable sort orders them), stopping once the next
// entry exceeds its best t (closest) or at its first hit (any).  This kernel
// computes exactly that per ray: each step scans the shared-memory boxes for
// the next (entry, cid) after the last one visited.  Bound: the latency of
// those serial per-thread scans (O(C) per visit); at its main-path shape (the
// ~15k rays of a 262k-ray batch that overflow) a launch is a third of a wave,
// and K7 + K8 took more device time than K3 + K4 in a profiled 512x512 pass.
// A simple kernel that is right; making it fast is later work.
//
// Arithmetic: expressions follow the plain PyTorch versions (accel/pairs.py,
// accel/pallas_bvh.py) in order, and the file is built with -fmad=false, so
// kernel and plain versions round identically.  fminf/fmaxf differ from
// torch.minimum/maximum only on NaN, which no finite ray produces: 1/d is
// clamped to |d| >= 1e-20.
//
// Each entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of the launch.

#include "ray_tri.cuh"

namespace {

using namespace mts;

constexpr int kThreads = 256;
constexpr int kMaxClusters = 1920;  // shared-memory box capacity (46 KB)
constexpr int kMaxK = 8;            // longest per-ray cluster list

// Stage n boxes as SoA rows s[a * kMaxClusters + cid], a = lox..hiz, from
// a box table with element (cid, a) at box[cid * cid_stride + a * a_stride].
__device__ __forceinline__ void stage_boxes(float* s, const float* box, int n,
                                            long cid_stride, long a_stride) {
  for (int k = threadIdx.x; k < 6 * n; k += blockDim.x) {
    const int a = k / n;
    const int cid = k - a * n;
    s[a * kMaxClusters + cid] = box[cid * cid_stride + a * a_stride];
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
  stage_boxes(s_box, mbox, c, 6, 1);
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
// Slab test of shared-memory box cid (SoA rows of stride kMaxClusters).
__device__ __forceinline__ void box_slab(const float* s, int cid, const Ray& r,
                                         float ix, float iy, float iz,
                                         float* tn, float* tf) {
  slab(s[0 * kMaxClusters + cid], s[1 * kMaxClusters + cid],
       s[2 * kMaxClusters + cid], s[3 * kMaxClusters + cid],
       s[4 * kMaxClusters + cid], s[5 * kMaxClusters + cid], r, ix, iy, iz,
       tn, tf);
}

// The next cluster after (last_e, last_c) in (entry, cid) order among the
// ray's prepass hits: valid (hi >= lo on x), (tf >= max(tn, 0)) and
// tn < t_max.  Returns its cid (-1 when none is left), entry and tn.
__device__ __forceinline__ int next_cluster(const float* s, int cp,
                                            const Ray& r, float ix, float iy,
                                            float iz, float tm, float last_e,
                                            int last_c, float* e_out,
                                            float* tn_out) {
  int best_c = -1;
  float best_e = 0.0f, best_tn = 0.0f;
  for (int cid = 0; cid < cp; ++cid) {
    if (!(s[3 * kMaxClusters + cid] >= s[0 * kMaxClusters + cid])) continue;
    float tn, tf;
    box_slab(s, cid, r, ix, iy, iz, &tn, &tf);
    const float e = fmaxf(tn, 0.0f);
    if (!(tf >= e && tn < tm)) continue;
    if (e < last_e || (e == last_e && cid <= last_c)) continue;
    if (best_c < 0 || e < best_e) {  // cid ascends: ties keep the first
      best_c = cid;
      best_e = e;
      best_tn = tn;
    }
  }
  *e_out = best_e;
  *tn_out = best_tn;
  return best_c;
}

template <bool kClosest>
__global__ void __launch_bounds__(kThreads)
traverse_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ t_max, const float* __restrict__ box,
                const float* __restrict__ tri, int n_rays, int cp, int tc,
                long ct, float* __restrict__ t_out, int* __restrict__ slot_out,
                float* __restrict__ u_out, float* __restrict__ v_out,
                int* __restrict__ occ_out) {
  __shared__ float s_box[6 * kMaxClusters];
  stage_boxes(s_box, box, cp, 1, cp);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(o, d, i);
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  const float tm = t_max[i];
  float best_t = tm, best_u = 0.0f, best_v = 0.0f;
  int best_slot = -1;
  int occ = tm <= 0.0f;
  float last_e = -1.0f;  // entries are >= 0
  int last_c = -1;
  while (kClosest || !occ) {
    float e, tn;
    const int cid =
        next_cluster(s_box, cp, r, ix, iy, iz, tm, last_e, last_c, &e, &tn);
    if (cid < 0) break;
    if (kClosest && !(e <= best_t)) break;  // front to back: nothing closer
    last_e = e;
    last_c = cid;
    const long base = (long)cid * tc;
    if (kClosest) {
      if (!(tn < best_t)) continue;
      for (int j = 0; j < tc; ++j) {
        float t, u, v;
        if (mt_hit(tri, ct, base + j, r, best_t, &t, &u, &v)) {
          best_t = t;
          best_slot = (int)(base + j);
          best_u = u;
          best_v = v;
        }
      }
    } else {
      for (int j = 0; j < tc && !occ; ++j) {
        float t, u, v;
        occ = mt_hit(tri, ct, base + j, r, tm, &t, &u, &v);
      }
    }
  }
  if (kClosest) {
    t_out[i] = best_t;
    slot_out[i] = best_slot;
    u_out[i] = best_u;
    v_out[i] = best_v;
  } else {
    occ_out[i] = occ;
  }
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
                        float* u_out, float* v_out, void* stream) {
  if (n_rays > 0) {
    traverse_kernel<true><<<blocks_for(n_rays), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        o, d, t_max, box, tri, n_rays, cp, tc, ct, t_out, slot_out, u_out,
        v_out, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

int mts_cluster_any(const float* o, const float* d, const float* t_max,
                    const float* box, const float* tri, int n_rays, int cp,
                    int tc, long ct, int* occ_out, void* stream) {
  if (n_rays > 0) {
    traverse_kernel<false><<<blocks_for(n_rays), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        o, d, t_max, box, tri, n_rays, cp, tc, ct, nullptr, nullptr, nullptr,
        nullptr, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
