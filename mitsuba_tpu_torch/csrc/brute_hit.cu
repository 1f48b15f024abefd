// Brute-force ray/triangle intersection for small scenes (<= 512 triangles).
//
// Replaces the two TPU kernels of mitsuba_tpu/accel/pallas_kernels.py:
//   K1 _closest_kernel_v2 (:434)  -> mts_closest_hit_v2
//   K2 _any_kernel_v2     (:445)  -> mts_any_hit_v2
// Both test every ray against every triangle with Moller-Trumbore
// (RAY_EPS 1e-4, |det| > 1e-12).
//
// Layout: rays are [R, 3] row-major float32 (o, d) plus t_max [R]; the
// triangle set is the sublane pack tri_s [9, Tp] (rows v0xyz, e1xyz, e2xyz),
// Tp a multiple of 8, padding rows with v0 = 1e30 and zero edges (never hit).
//
// What bounds it on Hopper: FP32 ALU.  Each ray costs ~30 flops per triangle
// and moves 28 B in (o, d, t_max) and 8 B out (t, prim) or 4 B (occluded),
// so at 40 triangles it already does ~40 flops per byte, and the scene
// (<= 18 KB) sits in shared memory.  Design: one thread per ray; each block
// stages the whole triangle set in shared memory once and every thread loops
// over it in index order, so all threads of a warp read the same shared word
// (a broadcast, no bank conflicts).  The closest-hit loop keeps (t, prim) with
// a strict '<', which is argmin's first-index tie-break (shared rectangle
// diagonals make ties real); the any-hit loop leaves on its first hit.
//
// Arithmetic: the expressions are written in the same order as the plain
// PyTorch version (accel/pallas_kernels.py _mt_hit), and the file is built
// with -fmad=false, so kernel and plain version round identically.
//
// Each entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTris = 512;
constexpr int kThreads = 256;
constexpr float kRayEps = 1e-4f;
constexpr float kDetEps = 1e-12f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// Moller-Trumbore against triangle column j of the shared [9][kMaxTris] set.
__device__ __forceinline__ bool mt_hit(const float* s, int j, const Ray& r,
                                       float t_lim, float* t_hit) {
  const float v0x = s[0 * kMaxTris + j], v0y = s[1 * kMaxTris + j],
              v0z = s[2 * kMaxTris + j];
  const float e1x = s[3 * kMaxTris + j], e1y = s[4 * kMaxTris + j],
              e1z = s[5 * kMaxTris + j];
  const float e2x = s[6 * kMaxTris + j], e2y = s[7 * kMaxTris + j],
              e2z = s[8 * kMaxTris + j];

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
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > kRayEps &&
         t < t_lim;
}

__device__ __forceinline__ void stage_triangles(float* s, const float* tri_s,
                                                int tp) {
  for (int k = threadIdx.x; k < 9 * tp; k += blockDim.x) {
    const int row = k / tp;
    s[row * kMaxTris + (k - row * tp)] = tri_s[k];
  }
  __syncthreads();
}

__device__ __forceinline__ Ray load_ray(const float* o, const float* d,
                                        int i) {
  return Ray{o[3 * i], o[3 * i + 1], o[3 * i + 2],
             d[3 * i], d[3 * i + 1], d[3 * i + 2]};
}

__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ t_max,
               const float* __restrict__ tri_s, int n_rays, int tp,
               float* __restrict__ t_out, int* __restrict__ prim_out) {
  __shared__ float s_tri[9 * kMaxTris];
  stage_triangles(s_tri, tri_s, tp);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(o, d, i);
  const float t_lim = t_max[i];
  float best_t = __int_as_float(0x7f800000);  // +inf
  int best = 0;
  for (int j = 0; j < tp; ++j) {
    float t;
    if (mt_hit(s_tri, j, r, t_lim, &t) && t < best_t) {
      best_t = t;
      best = j;
    }
  }
  prim_out[i] = best_t < t_lim ? best : -1;
  t_out[i] = fminf(best_t, t_lim);
}

__global__ void __launch_bounds__(kThreads)
any_kernel(const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ t_max, const float* __restrict__ tri_s,
           int n_rays, int tp, int* __restrict__ occ_out) {
  __shared__ float s_tri[9 * kMaxTris];
  stage_triangles(s_tri, tri_s, tp);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(o, d, i);
  const float t_lim = t_max[i];
  int occ = 0;
  for (int j = 0; j < tp; ++j) {
    float t;
    if (mt_hit(s_tri, j, r, t_lim, &t)) {
      occ = 1;
      break;
    }
  }
  occ_out[i] = occ;
}

int grid_for(int n_rays) { return (n_rays + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int mts_max_tris() { return kMaxTris; }

int mts_closest_hit_v2(const float* o, const float* d, const float* t_max,
                       const float* tri_s, int n_rays, int tp, float* t_out,
                       int* prim_out, void* stream) {
  if (n_rays > 0) {
    closest_kernel<<<grid_for(n_rays), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        o, d, t_max, tri_s, n_rays, tp, t_out, prim_out);
  }
  return static_cast<int>(cudaGetLastError());
}

int mts_any_hit_v2(const float* o, const float* d, const float* t_max,
                   const float* tri_s, int n_rays, int tp, int* occ_out,
                   void* stream) {
  if (n_rays > 0) {
    any_kernel<<<grid_for(n_rays), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(o, d, t_max, tri_s,
                                                      n_rays, tp, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
