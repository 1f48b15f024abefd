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

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxClusters = 1920;  // shared-memory box capacity (46 KB)
constexpr int kMaxK = 8;            // longest per-ray cluster list
constexpr float kBig = 3e38f;       // the reference's BIG
constexpr float kRayEps = 1e-4f;
constexpr float kDetEps = 1e-12f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* o, const float* d, int i) {
  return Ray{o[3 * i], o[3 * i + 1], o[3 * i + 2],
             d[3 * i], d[3 * i + 1], d[3 * i + 2]};
}

// 1 / where(|c| < 1e-20, 1e-20, c)
__device__ __forceinline__ float safe_inv(float c) {
  return 1.0f / (fabsf(c) < 1e-20f ? 1e-20f : c);
}

// Moller-Trumbore against column col of cl_tri (row stride ct); same
// expression order as K1 (brute_hit.cu) and the plain versions.
__device__ __forceinline__ bool mt_hit(const float* __restrict__ tri, long ct,
                                       long col, const Ray& r, float t_lim,
                                       float* t_hit, float* u_hit,
                                       float* v_hit) {
  const float v0x = tri[0 * ct + col], v0y = tri[1 * ct + col],
              v0z = tri[2 * ct + col];
  const float e1x = tri[3 * ct + col], e1y = tri[4 * ct + col],
              e1z = tri[5 * ct + col];
  const float e2x = tri[6 * ct + col], e2y = tri[7 * ct + col],
              e2z = tri[8 * ct + col];

  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok = fabsf(det) > kDetEps;
  const float inv_det = ok ? 1.0f / det : 0.0f;
  const float tx = r.ox - v0x;
  const float ty = r.oy - v0y;
  const float tz = r.oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  *t_hit = t;
  *u_hit = u;
  *v_hit = v;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > kRayEps &&
         t < t_lim;
}

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
// Slab order of the reference's dense cull: per axis (box - o) * inv, then
// tn = max(tn, min(t0, t1)) and tf = min(tf, max(t0, t1)) from -BIG / BIG.
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
    float tn = -kBig, tf = kBig;
    {
      const float t0 = (s_box[0 * kMaxClusters + cid] - r.ox) * ix;
      const float t1 = (s_box[3 * kMaxClusters + cid] - r.ox) * ix;
      tn = fmaxf(tn, fminf(t0, t1));
      tf = fminf(tf, fmaxf(t0, t1));
    }
    {
      const float t0 = (s_box[1 * kMaxClusters + cid] - r.oy) * iy;
      const float t1 = (s_box[4 * kMaxClusters + cid] - r.oy) * iy;
      tn = fmaxf(tn, fminf(t0, t1));
      tf = fminf(tf, fmaxf(t0, t1));
    }
    {
      const float t0 = (s_box[2 * kMaxClusters + cid] - r.oz) * iz;
      const float t1 = (s_box[5 * kMaxClusters + cid] - r.oz) * iz;
      tn = fmaxf(tn, fminf(t0, t1));
      tf = fminf(tf, fmaxf(t0, t1));
    }
    const float ent = fmaxf(tn, 0.0f);
    if (!(tf >= ent && tn < tm)) continue;
    ++n_cl;
    if (!(ent < key[kk - 1])) continue;
    // insert after every kept entry <= ent (keeps cid order on ties)
    int j = kk - 1;
    while (j > 0 && ent < key[j - 1]) {
      key[j] = key[j - 1];
      idx[j] = idx[j - 1];
      --j;
    }
    key[j] = ent;
    idx[j] = cid;
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
// The pallas_bvh slab (reference _slab): per axis (box - o) * inv,
// tn = max of the per-axis mins, tf = min of the per-axis maxes.
__device__ __forceinline__ void slab(const float* s, int cid, const Ray& r,
                                     float ix, float iy, float iz, float* tn,
                                     float* tf) {
  const float t0x = (s[0 * kMaxClusters + cid] - r.ox) * ix;
  const float t1x = (s[3 * kMaxClusters + cid] - r.ox) * ix;
  const float t0y = (s[1 * kMaxClusters + cid] - r.oy) * iy;
  const float t1y = (s[4 * kMaxClusters + cid] - r.oy) * iy;
  const float t0z = (s[2 * kMaxClusters + cid] - r.oz) * iz;
  const float t1z = (s[5 * kMaxClusters + cid] - r.oz) * iz;
  *tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  *tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
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
    slab(s, cid, r, ix, iy, iz, &tn, &tf);
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
