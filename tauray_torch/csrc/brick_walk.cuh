// The brick walk (brick_walk_kernel) of L4-L7 and L12 mt, for Hopper
// (sm_90a): a warp walks a tile, R rays a lane, FMA bodies, running
// bests met by (t, slot) after the walk. brick_lab.cu states its design
// and launches L4-L7's instances; mxu_lab.cu launches L12 mt's, which
// reads L12's own layout (kLab 12: o3, d3 and mm2 apart, order rows of
// 64 entries).

#pragma once

#include <climits>
#include <cuda_runtime.h>

#include "lab_common.cuh"

namespace {

constexpr int kCluster = 128;          // triangles per cluster
constexpr int kQuads = kCluster / 4;   // float4 of a cluster row
constexpr int kRow = 1024;             // meta entries of a tile
constexpr int kRowL12 = 64;            // L12's order entries of a tile
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTilesBlock = 4;         // the walk: tiles (warps) a block
// the walk's R, rays a lane, at TILE 8 and 16 (4 at TILE 32)
constexpr int kRays8 = 4;
constexpr int kRays16 = 4;

enum Body { kMT = 0, kMTFast = 1, kBW = 2 };
enum Variant { kFixed = 0, kCid = 1, kWhile = 2, kWhile2 = 3 };

constexpr int kBrick = 9 * kQuads;     // float4 of a tris9 cluster, 4,608 B
// L4's ring: two cluster slots a warp (36 KB of shared memory a block)
constexpr size_t kL4Smem = kTilesBlock * 2 * kBrick * sizeof(float4);

// kernel_lab2.py mtfast_body's key of one triangle, (t bits & ~1023) |
// lane, against best, the ray's best t from before the step, its products
// as mt_hit_fma forms them: t = t_n / |a| on a hit (an IEEE division, taken
// on a hit only; negative where a < 0, as the script has it), 3e38 on a
// miss.
__device__ __forceinline__ int mtfast_key_fma(const Ray& r,
                                              const float (&w)[9],
                                              float best, int lane) {
  const float v0x = w[0], v0y = w[1], v0z = w[2];
  const float e1x = w[3], e1y = w[4], e1z = w[5];
  const float e2x = w[6], e2y = w[7], e2z = w[8];
  const float hx = __fmaf_rn(r.dy, e2z, -(r.dz * e2y));
  const float hy = __fmaf_rn(r.dz, e2x, -(r.dx * e2z));
  const float hz = __fmaf_rn(r.dx, e2y, -(r.dy * e2x));
  const float a = __fmaf_rn(e1z, hz, __fmaf_rn(e1y, hy, e1x * hx));
  const float sx = r.ox - v0x;
  const float sy = r.oy - v0y;
  const float sz = r.oz - v0z;
  const float u_n = __fmaf_rn(sz, hz, __fmaf_rn(sy, hy, sx * hx));
  const float qx = __fmaf_rn(sy, e1z, -(sz * e1y));
  const float qy = __fmaf_rn(sz, e1x, -(sx * e1z));
  const float qz = __fmaf_rn(sx, e1y, -(sy * e1x));
  const float v_n = __fmaf_rn(r.dz, qz, __fmaf_rn(r.dy, qy, r.dx * qx));
  const float t_n = __fmaf_rn(e2z, qz, __fmaf_rn(e2y, qy, e2x * qx));
  const float sa = a < 0.0f ? -1.0f : 1.0f;
  const float na = a * sa;
  const float nu = u_n * sa;
  const float nv = v_n * sa;
  const float nt = t_n * sa;
  float tt = kBig;
  if (nu >= 0.0f && nv >= 0.0f && nu + nv <= na && nt >= r.tmin * na &&
      nt < best * na && na > 0.0f)
    tt = __fdiv_rn(t_n, na);
  return (__float_as_int(tt) & ~1023) | lane;
}

// The cluster of a meta entry: clipped to the table (L7: entry & 1023, at
// most C - 1).
template <bool kLab7>
__device__ __forceinline__ int order_of(int m, int n_clusters) {
  return kLab7 ? min(m & 1023, n_clusters - 1)
               : max(0, min(m, n_clusters - 1));
}

// One step of the walk for worker wk: its quads (wk, wk + workers, ...) of
// the step's kb clusters (lane j < kb of orders names slot j's), rows read
// in place, each triangle against the lane's R rays (FMA body), a hit
// closer than ct[k] taking (ct[k], cs[k]). odd: see rcp_in_range.
template <int kBody, int R, int kWorkers, bool kExact>
__device__ __forceinline__ void walk_step(const float4* t4, int orders,
                                          int kb, int s, int wk,
                                          const Ray (&r)[R], float (&ct)[R],
                                          int (&cs)[R], bool& odd) {
  constexpr int NF = kBody == kBW ? 12 : 9;
  const int slot0 = s * kb * kCluster;
#pragma unroll 1
  for (int quad = wk; quad < kb * kQuads; quad += kWorkers) {
    const int c = __shfl_sync(kFull, orders, quad / kQuads);
    const float4* b = t4 + static_cast<size_t>(c) * NF * kQuads +
                      quad % kQuads;
    float4 v[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j) v[j] = __ldg(b + j * kQuads);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float w[NF];
#pragma unroll
      for (int j = 0; j < NF; ++j) w[j] = comp(v[j], cc);
      const int slot = slot0 + 4 * quad + cc;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        float tt;
        bool h;
        if constexpr (kBody == kBW)
          h = bw_hit_fma<kExact>(r[k], w, ct[k], tt, odd);
        else
          h = mt_hit_fma<kExact>(r[k], w, ct[k], tt, odd);
        if (h) {
          ct[k] = tt;
          cs[k] = slot;
        }
      }
    }
  }
}

// L4: worker wk's quads (wk, wk + kWorkers, ...) of one cluster's rows b
// (a ring slot), each triangle against the lane's R rays. mt: a hit closer
// than ct[k] takes (ct[k], cs[k]) with slot0 + its lane in the cluster
// (odd: see rcp_in_range); mtfast: kmin[k] keeps the smallest key against
// ct[k], the best from before the step, its lane slot0 + the triangle's
// lane in the cluster.
template <int kBody, int R, int kWorkers, bool kExact>
__device__ __forceinline__ void brick_cluster(const float4* b, int slot0,
                                              int wk, const Ray (&r)[R],
                                              float (&ct)[R], int (&cs)[R],
                                              int (&kmin)[R], bool& odd) {
#pragma unroll 1
  for (int quad = wk; quad < kQuads; quad += kWorkers) {
    float4 v[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) v[j] = b[j * kQuads + quad];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float w[9];
#pragma unroll
      for (int j = 0; j < 9; ++j) w[j] = comp(v[j], cc);
      const int slot = slot0 + 4 * quad + cc;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if constexpr (kBody == kMTFast) {
          kmin[k] = min(kmin[k], mtfast_key_fma(r[k], w, ct[k], slot));
        } else {
          float tt;
          if (mt_hit_fma<kExact>(r[k], w, ct[k], tt, odd)) {
            ct[k] = tt;
            cs[k] = slot;
          }
        }
      }
    }
  }
}

// L4's walk for the lane's R rays (see the head of this file): the steps'
// kb clusters one at a time, walk position g = s kb + j, through the
// warp's ring of two slots: cluster g + 1 is copied while cluster g is
// tested.
template <int kBody, int R, int kLanes>
__device__ __forceinline__ void l4_walk(const int* mrow, const float4* t4,
                                        int n_clusters, int kb, int steps,
                                        int lane, float4* ring,
                                        const Ray (&r)[R], float (&ct)[R],
                                        int (&cs)[R]) {
  constexpr int kWorkers = 32 / kLanes;
  const int wk = lane / kLanes;
  const int n = steps * kb;  // clusters of the walk
  // lane l: the cluster at walk position (p & ~31) + l, for stage(p)
  // asked with p = 0, 1, ... in turn by every lane
  int kc = 0;
  auto stage = [&](int p) {  // walk position p's rows into slot p & 1
    if ((p & 31) == 0)
      kc = p + lane < n ? order_of<false>(mrow[p + lane], n_clusters) : 0;
    const int c = __shfl_sync(kFull, kc, p & 31);
    cp_async_rows<9, kQuads>(ring + (p & 1) * kBrick,
                             t4 + static_cast<size_t>(c) * kBrick, lane);
  };
  if (n > 0) stage(0);
  int kmin[R];
  bool odd = false;  // mt: a den outside rcp_in_range's range
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int k = 0; k < R; ++k) kmin[k] = INT_MAX;
    for (int j = 0; j < kb; ++j) {
      const int g = s * kb + j;
      if (g + 1 < n) {
        stage(g + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();  // cluster g's rows are in for every lane
      const float4* b = ring + (g & 1) * kBrick;
      if constexpr (kBody == kMTFast) {
        brick_cluster<kMTFast, R, kWorkers, false>(b, j * kCluster, wk, r,
                                                   ct, cs, kmin, odd);
      } else {
        float st[R];
        int ss[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
          st[k] = ct[k];
          ss[k] = cs[k];
        }
        odd = false;
        brick_cluster<kMT, R, kWorkers, false>(b, g * kCluster, wk, r, ct,
                                               cs, kmin, odd);
        if (__any_sync(kFull, odd)) {  // the cluster again with __frcp_rn
#pragma unroll
          for (int k = 0; k < R; ++k) {
            ct[k] = st[k];
            cs[k] = ss[k];
          }
          brick_cluster<kMT, R, kWorkers, true>(b, g * kCluster, wk, r, ct,
                                                cs, kmin, odd);
        }
      }
      __syncwarp();  // every lane is done with b
    }
    if constexpr (kBody == kMTFast) {
      // the step's smallest key of each ray, met over its workers
#pragma unroll
      for (int k = 0; k < R; ++k) {
        int m = kmin[k];
        for (int o = kLanes; o < 32; o <<= 1)
          m = min(m, __shfl_xor_sync(kFull, m, o));
        if (m < __float_as_int(ct[k])) {
          ct[k] = __int_as_float(m & ~1023);
          cs[k] = s * kb * kCluster + (m & 1023);
        }
      }
    }
  }
}

// L4 (kLab 4), L5, L6 (kLab 6), L7 (kLab 7) and L12 mt (kLab 12): a warp
// walks a tile of kTile rays, R rays a lane (see the head of
// brick_lab.cu); L4's rings take kL4Smem bytes of dynamic shared memory.
// rays: L4-L7's (n_tiles, kTile, 8) [o | d | t_min | t_max] (d3 and mm2
// unread); L12's o3 (n_tiles, 32, 3), with d3 (n_tiles, 32, 3) and mm2
// (n_tiles, 32, 2) [t_min | t_max], read in place as scalars. meta: rows of
// 1,024 entries (L12: its order rows of 64).
template <int kLab, int kBody, int kVariant, int kTile, int R>
__global__ void __launch_bounds__(kTilesBlock * 32)
brick_walk_kernel(const int* __restrict__ meta,
                  const float* __restrict__ rays,
                  const float* __restrict__ d3,
                  const float* __restrict__ mm2,
                  const float* __restrict__ tris, int n_tiles,
                  int n_clusters, int kb, int steps,
                  float* __restrict__ out) {
  constexpr int kLanes = kTile / R;       // lanes a worker
  constexpr int kWorkers = 32 / kLanes;   // workers a warp
  static_assert(kLanes * R == kTile && kLanes * kWorkers == 32,
                "R rays a lane and whole workers");
  constexpr bool kL7 = kLab == 7;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tile = blockIdx.x * kTilesBlock + warp;
  if (tile >= n_tiles) return;
  const int wk = lane / kLanes;
  const int* mrow =
      meta + static_cast<size_t>(tile) * (kLab == 12 ? kRowL12 : kRow);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  const float4* r4 = reinterpret_cast<const float4*>(rays);
  Ray r[R];
  float ct[R];
  int cs[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const size_t ray = static_cast<size_t>(tile) * kTile + lane % kLanes +
                       k * kLanes;
    float tmax;
    if constexpr (kLab == 12) {
      const float2 mm = reinterpret_cast<const float2*>(mm2)[ray];
      r[k] = Ray{rays[ray * 3], rays[ray * 3 + 1], rays[ray * 3 + 2],
                 d3[ray * 3], d3[ray * 3 + 1], d3[ray * 3 + 2], mm.x};
      tmax = mm.y;
    } else {
      const float4 ra = r4[ray * 2];
      const float4 rb = r4[ray * 2 + 1];
      r[k] = Ray{ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z};
      tmax = rb.w;
    }
    ct[k] = kL7 ? kBig : tmax > kBig ? kBig : tmax;  // a NaN t_max kept
    cs[k] = -1;
  }
  if constexpr (kLab == 4) {
    extern __shared__ float4 smem[];
    l4_walk<kBody, R, kLanes>(mrow, t4, n_clusters, kb, steps, lane,
                              smem + warp * 2 * kBrick, r, ct, cs);
  } else {
    // lane j < kb: the meta entry of the next step's slot j, read a step
    // ahead
    int m_next = lane < kb && steps > 0 ? mrow[lane] : 0;
    for (int s = 0; s < steps; ++s) {
      const int orders = order_of<kL7>(m_next, n_clusters);
      if (lane < kb && s + 1 < steps) m_next = mrow[(s + 1) * kb + lane];
      float st[R];
      int ss[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        st[k] = ct[k];
        ss[k] = cs[k];
      }
      bool odd = false;  // a den outside rcp_in_range's range
      walk_step<kBody, R, kWorkers, false>(t4, orders, kb, s, wk, r, ct, cs,
                                           odd);
      if (__any_sync(kFull, odd)) {  // the step again with __frcp_rn
#pragma unroll
        for (int k = 0; k < R; ++k) {
          ct[k] = st[k];
          cs[k] = ss[k];
        }
        walk_step<kBody, R, kWorkers, true>(t4, orders, kb, s, wk, r, ct, cs,
                                            odd);
      }
      if (kVariant == kWhile || (kVariant == kWhile2 && (s & 1))) {
        // the tile stops once every ray's best t bits are <= the unclipped
        // meta entry of the next step's first slot
        const int nxt = mrow[min((s + 1) * kb, kRow - 1)];
        bool done = true;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          float m = ct[k];
          for (int o = kLanes; o < 32; o <<= 1) {
            const float u = __shfl_xor_sync(kFull, m, o);
            m = u < m ? u : m;
          }
          done &= __float_as_int(m) <= nxt;
        }
        if (__all_sync(kFull, done)) break;
      }
    }
  }
  if constexpr (kBody != kMTFast) {  // mtfast's workers hold one best
#pragma unroll
    for (int k = 0; k < R; ++k) workers_best(ct[k], cs[k], kLanes);
  }
  if (wk != 0) return;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    int id = cs[k];
    if (kVariant == kCid && id >= 0)
      id = order_of<false>(mrow[id / kCluster], n_clusters) * kCluster +
           id % kCluster;
    const float idf = kL7 ? static_cast<float>(id < 0 ? 0 : id)
                          : __int_as_float(id);
    reinterpret_cast<float2*>(out)[static_cast<size_t>(tile) * kTile +
                                   lane + k * kLanes] =
        make_float2(ct[k], idf);
  }
}

}  // namespace
