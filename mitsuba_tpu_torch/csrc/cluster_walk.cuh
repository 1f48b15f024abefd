// The per-ray cluster walk of the overflow fallback, one warp per ray,
// shared by K7/K8 (cluster_hit.cu: the boxes staged in shared memory) and
// K9/K10 (cluster_stream.cu: the boxes read from L2).  The two differ only
// in where box c is read, which the walk takes as a template argument
// (L2Boxes, SharedBoxes).
//
// The walk: a ray's slab-hit clusters (valid box, tf >= max(tn, 0),
// tn < t_max) in (entry, cid) order, stopping once the next entry exceeds
// its best t (closest) or at its first hit (any): what each lane of the
// reference's chunk kernels computes (mitsuba_tpu/accel/pallas_bvh.py
// _closest_kernel, _any_kernel, _mxu_*_kernel), and what the plain version
// (accel/pallas_bvh.py _traverse_plain) computes per ray.
//   * The lanes split the box scan (box base + lane, neighbouring lanes on
//     neighbouring addresses, the next 32 boxes loaded while these are
//     tested) and a cluster's Tc triangles (triangle j by lane j % 32,
//     neighbouring columns of cl_tri, so the loads coalesce).
//   * walk_any needs no order: the answer is whether some slab-hit cluster
//     holds a hit in (1e-4, t_max), or t_max <= 0, and the walk has no stop
//     on the entry.  So one pass over the boxes tests each slab-hit
//     cluster's triangles as soon as the warp's ballot finds its box, and
//     stops at the first hit (__any_sync).
//   * walk_closest needs the order (the stop at entry > best t, and ties in
//     t between clusters go to the first one visited).  One scan collects a
//     window of the 32 smallest (entry, cid) after the cursor, with entries
//     <= best t and tn < best t (best t only falls, so a cluster that fails
//     either would stop the walk or be skipped): each lane keeps its 8
//     smallest in registers, and 32 rounds of warp-shuffle minima merge
//     them into the window (lane k holds entry k), cut at the smallest key
//     a full lane may have dropped, so the window is exact.  The warp visits
//     the window in order under the walk's stop rule (!(entry <= best t))
//     and skip rule (!(tn < best t)), reducing each cluster's (t, j) by
//     lexicographic minimum, which is the serial strict '<' scan.  It
//     rescans, strictly after the last (entry, cid) taken, only when the
//     window was full and is used up.
// Each walk writes ray i's result and, when stats is given, the clusters
// whose triangles it tested and its box scans (stats[2i], stats[2i + 1]).
// Every lane of the warp must call it with the same i.
//
// Arithmetic goes through ray_tri.cuh's slab and mt_hit, in the plain
// versions' order; the sources are built with -fmad=false.

#pragma once

#include "ray_tri.cuh"

namespace mts {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLaneList = 8;  // candidates each lane keeps per closest-hit scan

struct Box {
  float lox, loy, loz, hix, hiy, hiz;
};

__device__ __forceinline__ Box inverted_box() {
  return Box{1.0f, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f};
}

// Box c of the [8, cp] table (rows lo xyz, hi xyz) through the read-only
// cache, or an inverted box past its end.
struct L2Boxes {
  const float* __restrict__ box;
  int cp;
  __device__ __forceinline__ Box operator()(int c) const {
    if (c >= cp) return inverted_box();
    return Box{__ldg(box + c), __ldg(box + cp + c), __ldg(box + 2L * cp + c),
               __ldg(box + 3L * cp + c), __ldg(box + 4L * cp + c),
               __ldg(box + 5L * cp + c)};
  }
};

// Box c of the table's first six rows staged in shared memory as [6][cp]
// SoA rows (lane l of a scan step reads word base + l of each row: no bank
// conflict), or an inverted box past its end.
struct SharedBoxes {
  const float* s;
  int cp;
  __device__ __forceinline__ Box operator()(int c) const {
    if (c >= cp) return inverted_box();
    return Box{s[c], s[cp + c], s[2 * cp + c], s[3 * cp + c], s[4 * cp + c],
               s[5 * cp + c]};
  }
};

// the walk's slab hit: a valid box (hi x >= lo x; padding is inverted) with
// tf >= e = max(tn, 0) and tn < tm; writes e and tn
__device__ __forceinline__ bool walk_hit(const Box& b, const Ray& r, float ix,
                                         float iy, float iz, float tm, float* e,
                                         float* tn) {
  if (!(b.hix >= b.lox)) return false;
  float tf;
  slab(b.lox, b.loy, b.loz, b.hix, b.hiy, b.hiz, r, ix, iy, iz, tn, &tf);
  *e = fmaxf(*tn, 0.0f);
  return tf >= *e && *tn < tm;
}

// (e1, c1) < (e2, c2) lexicographically
__device__ __forceinline__ bool key_less(float e1, int c1, float e2, int c2) {
  return e1 < e2 || (e1 == e2 && c1 < c2);
}

// the warp's lexicographic minimum of (e, c), in every lane
__device__ __forceinline__ void warp_min(float* e, int* c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float oe = __shfl_xor_sync(kFull, *e, off);
    const int oc = __shfl_xor_sync(kFull, *c, off);
    if (key_less(oe, oc, *e, *c)) {
      *e = oe;
      *c = oc;
    }
  }
}

template <class Boxes>
__device__ __forceinline__ void walk_any(const Boxes& boxes,
                                         const float* __restrict__ o,
                                         const float* __restrict__ d,
                                         const float* __restrict__ t_max,
                                         const float* __restrict__ tri, int tc,
                                         long ct, long i,
                                         int* __restrict__ occ_out,
                                         int* __restrict__ stats) {
  const int lane = threadIdx.x & 31;
  const int cp = boxes.cp;
  const Ray r = load_ray(o, d, i);
  const float tm = t_max[i];
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  bool occ = tm <= 0.0f;
  int visits = 0;
  Box next = boxes(lane);
  for (int base = 0; base < cp && !occ; base += 32) {
    const Box b = next;
    next = boxes(base + 32 + lane);
    float e, tn;
    unsigned found = __ballot_sync(kFull, walk_hit(b, r, ix, iy, iz, tm, &e, &tn));
    while (found) {  // the slab-hit clusters of these 32 boxes, any order
      const long first = (long)(base + __ffs(found) - 1) * tc;
      found &= found - 1;
      ++visits;
      bool hit = false;
      for (int j = lane; j < tc && !hit; j += 32) {
        float t, u, v;
        hit = mt_hit(tri, ct, first + j, r, tm, &t, &u, &v);
      }
      if (__any_sync(kFull, hit)) {
        occ = true;
        break;
      }
    }
  }
  if (lane == 0) {
    occ_out[i] = occ;
    if (stats) {
      stats[2 * i] = visits;
      stats[2 * i + 1] = 1;
    }
  }
}

template <class Boxes>
__device__ __forceinline__ void walk_closest(
    const Boxes& boxes, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ t_max,
    const float* __restrict__ tri, int tc, long ct, long i,
    float* __restrict__ t_out, int* __restrict__ slot_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ stats) {
  const float kInf = __int_as_float(0x7f800000);
  constexpr int kNone = 0x7fffffff;  // cid of an empty list slot
  const int lane = threadIdx.x & 31;
  const int cp = boxes.cp;
  const Ray r = load_ray(o, d, i);
  const float tm = t_max[i];
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  float best_t = tm, best_u = 0.0f, best_v = 0.0f;
  int best_slot = -1;
  float cur_e = -1.0f;  // the cursor: the last (entry, cid) taken; entries >= 0
  int cur_c = -1;
  int visits = 0, scans = 0;
  bool more = true;
  while (more) {
    ++scans;
    // 1. scan: each lane keeps its kLaneList smallest candidates after the
    // cursor, sorted; its cids ascend, so equal entries keep cid order
    float le[kLaneList];
    int lc[kLaneList];
#pragma unroll
    for (int j = 0; j < kLaneList; ++j) {
      le[j] = kInf;
      lc[j] = kNone;
    }
    bool dropped = false;  // this lane let a candidate go
    Box next = boxes(lane);
    for (int base = 0; base < cp; base += 32) {
      const Box b = next;
      next = boxes(base + 32 + lane);
      const int c = base + lane;
      float e, tn;
      if (!walk_hit(b, r, ix, iy, iz, tm, &e, &tn) ||
          !key_less(cur_e, cur_c, e, c) || !(e <= best_t) || !(tn < best_t))
        continue;
      if (!(e < le[kLaneList - 1])) {
        dropped = true;
        continue;
      }
      if (lc[kLaneList - 1] != kNone) dropped = true;  // the last one goes
      bool placed = false;
#pragma unroll
      for (int j = kLaneList - 1; j > 0; --j) {
        if (!placed) {
          if (e < le[j - 1]) {
            le[j] = le[j - 1];
            lc[j] = lc[j - 1];
          } else {
            le[j] = e;
            lc[j] = c;
            placed = true;
          }
        }
      }
      if (!placed) {
        le[0] = e;
        lc[0] = c;
      }
    }
    // 2. merge: the window, lane k holding its k-th entry, exact up to the
    // smallest last key of a lane that dropped candidates
    float cut_e = dropped ? le[kLaneList - 1] : kInf;
    int cut_c = dropped ? lc[kLaneList - 1] : kNone;
    warp_min(&cut_e, &cut_c);
    float win_e = kInf;
    int win_c = kNone;
    int n_win = 0;
    for (; n_win < 32; ++n_win) {
      float me = le[0];
      int mc = lc[0];
      warp_min(&me, &mc);
      if (mc == kNone || key_less(cut_e, cut_c, me, mc)) break;
      if (lane == n_win) {
        win_e = me;
        win_c = mc;
      }
      if (lc[0] == mc) {  // the one lane that held it pops its head
#pragma unroll
        for (int j = 0; j < kLaneList - 1; ++j) {
          le[j] = le[j + 1];
          lc[j] = lc[j + 1];
        }
        le[kLaneList - 1] = kInf;
        lc[kLaneList - 1] = kNone;
      }
    }
    more = __any_sync(kFull, dropped || lc[0] != kNone);
    // 3. visit the window in order
    for (int k = 0; k < n_win; ++k) {
      const float e = __shfl_sync(kFull, win_e, k);
      const int c = __shfl_sync(kFull, win_c, k);
      if (!(e <= best_t)) {  // none left can be nearer
        more = false;
        break;
      }
      cur_e = e;
      cur_c = c;
      const Box b = boxes(c);
      float tn, tf;
      slab(b.lox, b.loy, b.loz, b.hix, b.hiy, b.hiz, r, ix, iy, iz, &tn, &tf);
      if (!(tn < best_t)) continue;
      ++visits;
      const long first = (long)c * tc;
      float lt = kInf, lu = 0.0f, lv = 0.0f;
      int lj = kNone;
      for (int j = lane; j < tc; j += 32) {
        float t, u, v;
        if (mt_hit(tri, ct, first + j, r, best_t, &t, &u, &v) && t < lt) {
          lt = t;
          lj = j;
          lu = u;
          lv = v;
        }
      }
      float min_t = lt;
      int mj = lj;
      warp_min(&min_t, &mj);
      if (mj != kNone) {  // every hit lies before best_t
        best_u = __shfl_sync(kFull, lu, mj & 31);
        best_v = __shfl_sync(kFull, lv, mj & 31);
        best_t = min_t;
        best_slot = (int)(first + mj);
      }
    }
  }
  if (lane == 0) {
    t_out[i] = best_t;
    slot_out[i] = best_slot;
    u_out[i] = best_u;
    v_out[i] = best_v;
    if (stats) {
      stats[2 * i] = visits;
      stats[2 * i + 1] = scans;
    }
  }
}

}  // namespace mts
