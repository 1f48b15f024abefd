// Ray and triangle primitives shared by the cluster kernels
// (cluster_hit.cu, cluster_stream.cu, cluster_walk.cuh) and the tiled brute
// force (brute_tiled.cu), with the register lists, the Hopper bulk copy and
// the occupancy query the cluster kernels share.  Every expression follows
// the plain PyTorch versions in order (accel/pallas_kernels.py mt_test,
// accel/pallas_bvh.py safe_inv), and the sources are built with
// -fmad=false, so kernels and plain versions round identically.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace mts {

constexpr float kBig = 3e38f;  // the reference's BIG
constexpr float kRayEps = 1e-4f;
constexpr float kDetEps = 1e-12f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* o, const float* d, long i) {
  return Ray{o[3 * i], o[3 * i + 1], o[3 * i + 2],
             d[3 * i], d[3 * i + 1], d[3 * i + 2]};
}

// 1 / where(|c| < 1e-20, 1e-20, c)
__device__ __forceinline__ float safe_inv(float c) {
  return 1.0f / (fabsf(c) < 1e-20f ? 1e-20f : c);
}

// Moller-Trumbore against column col of a [9, ct] triangle table (rows
// v0xyz, e1xyz, e2xyz; global or shared memory); same expression order as
// the plain versions.
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

// mt_hit against row j of a [n, 9] triangle table (each triangle's nine
// floats together: accel/pairs.py _tri_rows)
__device__ __forceinline__ bool mt_hit_row(const float* __restrict__ tri,
                                           int j, const Ray& r, float t_lim,
                                           float* t_hit, float* u_hit,
                                           float* v_hit) {
  return mt_hit(tri + 9 * j, 1, 0, r, t_lim, t_hit, u_hit, v_hit);
}

// The pallas_bvh slab (reference _slab) against box (lo xyz, hi xyz): per
// axis (box - o) * inv, tn = max of the per-axis mins, tf = min of the
// per-axis maxes.
__device__ __forceinline__ void slab(float lox, float loy, float loz,
                                     float hix, float hiy, float hiz,
                                     const Ray& r, float ix, float iy,
                                     float iz, float* tn, float* tf) {
  const float t0x = (lox - r.ox) * ix;
  const float t1x = (hix - r.ox) * ix;
  const float t0y = (loy - r.oy) * iy;
  const float t1y = (hiy - r.oy) * iy;
  const float t0z = (loz - r.oz) * iz;
  const float t1z = (hiz - r.oz) * iz;
  *tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  *tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
}

// The pair cull's slab (reference pairs.py _cull_kernel / _dense_cull_kernel
// `slab`): per axis (box - o) * inv, then tn = max(tn, min(t0, t1)) and
// tf = min(tf, max(t0, t1)) folded from -BIG / BIG.  Returns the hit test
// (tf >= ent) & (tn < t_max) and writes ent = max(tn, 0).
__device__ __forceinline__ bool cull_slab(float lox, float loy, float loz,
                                          float hix, float hiy, float hiz,
                                          const Ray& r, float ix, float iy,
                                          float iz, float tm, float* ent) {
  float tn = -kBig, tf = kBig;
  {
    const float t0 = (lox - r.ox) * ix;
    const float t1 = (hix - r.ox) * ix;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
  {
    const float t0 = (loy - r.oy) * iy;
    const float t1 = (hiy - r.oy) * iy;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
  {
    const float t0 = (loz - r.oz) * iz;
    const float t1 = (hiz - r.oz) * iz;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
  const float e = fmaxf(tn, 0.0f);
  *ent = e;
  return tf >= e && tn < tm;
}

// Insert (key, id) into the ascending list keys[0, N) if key < keys[N-1],
// after every kept key <= key: equal keys keep their arrival order, the
// first-index tie-break of the reference's k-pass argmin.  Unrolled over the
// compile-time length and select-based, so that the list stays in
// registers.  A caller keeping n < N entries takes the first n: with ties
// ordered by arrival, the n smallest of a stream are the first n of its N
// smallest.
template <int N>
__device__ __forceinline__ void keep_smallest_reg(float (&keys)[N],
                                                  int (&idx)[N], float key,
                                                  int id) {
  if (!(key < keys[N - 1])) return;
#pragma unroll
  for (int j = N - 1; j > 0; --j) {
    const bool shift = key < keys[j - 1];
    const bool here = !shift && key < keys[j];
    keys[j] = shift ? keys[j - 1] : (here ? key : keys[j]);
    idx[j] = shift ? idx[j - 1] : (here ? id : idx[j]);
  }
  if (key < keys[0]) {
    keys[0] = key;
    idx[0] = id;
  }
}

// entry n of a register list, for a run-time n < N
template <int N, typename T>
__device__ __forceinline__ T pick(const T (&v)[N], int n) {
  T out = v[0];
#pragma unroll
  for (int j = 1; j < N; ++j) out = j == n ? v[j] : out;
  return out;
}

// cp.async of 4 bytes from global to shared memory, and its group
// bookkeeping (sm_80+).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// mbarrier and bulk copy (sm_90)
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar,
                                                      unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16, both ends 16-byte aligned) from global to shared
// memory, completing on the mbarrier bar
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(bar)
      : "memory");
}

// Host: blocks of kernel fn the current device holds at once with `threads`
// threads and `smem` bytes of dynamic shared memory each (the attribute for
// more than 48 KB set first).  The runtime is asked once per (kernel,
// device, smem) and the answer kept: a pass launches each kernel ~40-80
// times on one pack.
inline cudaError_t resident_blocks(const void* fn, int threads, size_t smem,
                                   int* blocks) {
  struct Entry {
    const void* fn;
    int dev;
    size_t smem;
    int blocks;
  };
  constexpr int kEntries = 16;
  static std::mutex mu;
  static Entry cache[kEntries];
  static int n_cached = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int k = 0; k < n_cached && k < kEntries; ++k) {
    if (cache[k].fn == fn && cache[k].dev == dev && cache[k].smem == smem) {
      *blocks = cache[k].blocks;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                        smem);
  if (err != cudaSuccess) return err;
  cache[n_cached++ % kEntries] = Entry{fn, dev, smem, sms * per_sm};
  *blocks = sms * per_sm;
  return cudaSuccess;
}

}  // namespace mts
