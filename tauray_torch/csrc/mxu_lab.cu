// L12, a ray-triangle test in Plücker form as matrix products on the
// tensor cores against FP32 Möller-Trumbore, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of tauray_tpu's TPU lab script
// scripts/mxu_lab.py, common(kernel_body) (:80) launched by run
// (pallas_call :66): 32-ray tiles, 32 tiles a grid step, a fixed 6 steps
// of 8 clusters a tile, the clusters named by order (n_tiles, 64), with
//   * mt: mt_body (:133), Möller-Trumbore over tris9 (C, 9, 1, 128);
//   * plucker: plucker_body (:169), four products a step over tris24 (C,
//     24, 1, 128): the ray's Plücker coordinates [d | d x o] (32, 6) times
//     each edge's rows 0-5, 6-11 and 12-17 (s0, s1, s2), and [-o | 1] (32,
//     4) times rows 18-21 (tnum); a hit where s0, s1 and s2 share a sign,
//     their sum den is not 0 and t = tnum / den lies in [t_min, best).
// Both keep the script's ids, the order slot step * 1,024 + the
// triangle's lane in the step, and its start, t = min(t_max, 3e38) and id
// -1. It computes the script's functions, not its TPU schedule: one block
// of 8 warps a tile (no group of 32 tiles), and the rows read in place
// from L2 through the read-only path (tris9 2.9 MB, tris24 7.8 MB; the
// card's L2 is 50 MB) rather than staged: staging tris24 as the script
// does is 96 KB a step, 192 KB double buffered, one block an SM, and
// in-place reads ran as fast as staged ones on this card (L5 against L4,
// PERF.md).
// Rows 22-23 of tris24 are never read. An order outside [0, C) is clamped
// (the script's DMA would read out of bounds).
//   * mt: lane = ray; warp w tests the step's quads w, w + 8, ..., 4
//     triangles a 16-byte row load (a broadcast), running best (t, slot)
//     with strict <, the warps' bests combined by (t, slot) after the walk
//     (see tile_lab.cu: the script's per-step argmin gives the same).
//   * plucker: per 8-triangle column block (warp w takes blocks w, w + 8,
//     ...) and 16-ray row block, s0, s1 and s2 as two mma.sync m16n8k4
//     each (K = 6 padded to 8 with zeros) and tnum as one, every product
//     in TF32 split in two (x = hi + lo: lo.hi + hi.lo + hi.hi, as L11 in
//     k1_lab.cu), which brings it near FP32 (a single TF32 pass is not
//     near enough: the smallest t wins, and its numerator is tiny). Lane l
//     holds rays g, g + 8, g + 16, g + 24 (g = l / 4) and, of each column
//     block, triangles 2k and 2k + 1 (k = l % 4); the epilogue (the sign
//     tests, den, the IEEE division, the hit test) runs on the CUDA cores
//     in FP32 with a running best per ray and lane; the 4 lanes of a row
//     group, then the warps, combine by (t, slot).
// The result is the script's (n_tiles, 32, 2) f32 block: t, then the
// slot's int32 bits.
//
// What bounds it on the card: mt the FP32 instruction rate (46 operations
// a test, none fused under -fmad=false); plucker its TF32 products, 44
// operations a test at the script's K, three times over for the split, at
// 495 TFLOP/s, beside an FP32 epilogue of 14 operations a test.
//
// Built with -fmad=false (trace_kernel.NVCC_FLAGS): mt rounds like its
// plain torch version, bit for bit; plucker's products differ from FP32 by
// the split's error, so it is held to the plain FP32 version tie-aware
// (lab/mxu_lab.plucker_agreement).

#include <cuda_runtime.h>

#include "lab_common.cuh"

namespace {

constexpr int kCluster = 128;         // triangles per cluster
constexpr int kQuads = kCluster / 4;  // float4 of a cluster row
constexpr int kTile = 32;             // rays per tile = lanes per warp
constexpr int kKB = 8;                // clusters per step
constexpr int kBK = kKB * kCluster;   // triangles per step
constexpr int kSteps = 6;             // steps a tile (the script's STEPS)
constexpr int kOrder = 64;            // order entries a tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kTile;
constexpr int kRows9 = 9;
constexpr int kRows24 = 24;
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int order_at(const int* order, int tile, int k,
                                        int n_clusters) {
  return max(0, min(order[static_cast<size_t>(tile) * kOrder + k],
                    n_clusters - 1));
}

// The warps' (t, slot) of each ray (warp w's in tcomb[w][r], scomb[w][r])
// combined by smallest t, then smallest slot, and written by warp 0.
__device__ __forceinline__ void combine_write(float (*tcomb)[kTile],
                                              int (*scomb)[kTile], int tile,
                                              float* out) {
  __syncthreads();
  if (threadIdx.x >= kTile) return;
  const int r = threadIdx.x;
  float bt = tcomb[0][r];
  int bs = scomb[0][r];
  for (int w = 1; w < kWarps; ++w) {
    const float ut = tcomb[w][r];
    const int us = scomb[w][r];
    if (ut < bt || (ut == bt && us < bs)) {
      bt = ut;
      bs = us;
    }
  }
  reinterpret_cast<float2*>(out)[static_cast<size_t>(tile) * kTile + r] =
      make_float2(bt, __int_as_float(bs));
}

__global__ void __launch_bounds__(kThreads)
lab12_mt_kernel(const int* __restrict__ order, const float* __restrict__ o3,
                const float* __restrict__ d3, const float* __restrict__ mm2,
                const float* __restrict__ tris, int n_clusters,
                float* __restrict__ out) {
  __shared__ float tcomb[kWarps][kTile];
  __shared__ int scomb[kWarps][kTile];
  const int warp = threadIdx.x / kTile;
  const int lane = threadIdx.x % kTile;
  const int tile = blockIdx.x;
  const size_t ray = static_cast<size_t>(tile) * kTile + lane;
  const Ray R{o3[ray * 3], o3[ray * 3 + 1], o3[ray * 3 + 2], d3[ray * 3],
              d3[ray * 3 + 1], d3[ray * 3 + 2], mm2[ray * 2]};
  const float tmax = mm2[ray * 2 + 1];
  float bt = tmax > kBig ? kBig : tmax;  // jnp.minimum: NaN kept
  int bs = -1;
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  for (int s = 0; s < kSteps; ++s) {
    // lane j < 8: the cluster of the step's slot j
    const int orders =
        lane < kKB ? order_at(order, tile, s * kKB + lane, n_clusters) : 0;
    for (int quad = warp; quad < kBK / 4; quad += kWarps) {
      const int c = __shfl_sync(kFull, orders, quad / kQuads);
      const float4* b =
          t4 + static_cast<size_t>(c) * kRows9 * kQuads + quad % kQuads;
      float4 v[kRows9];
#pragma unroll
      for (int j = 0; j < kRows9; ++j) v[j] = __ldg(b + j * kQuads);
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        float w[kRows9];
#pragma unroll
        for (int j = 0; j < kRows9; ++j) w[j] = comp(v[j], c4);
        float tt;
        if (mt_hit(R, w, bt, tt)) {
          bt = tt;
          bs = s * kBK + 4 * quad + c4;
        }
      }
    }
  }
  tcomb[warp][lane] = bt;
  scomb[warp][lane] = bs;
  combine_write(tcomb, scomb, tile, out);
}

__global__ void __launch_bounds__(kThreads)
lab12_plucker_kernel(const int* __restrict__ order,
                     const float* __restrict__ o3,
                     const float* __restrict__ d3,
                     const float* __restrict__ mm2,
                     const float* __restrict__ tris, int n_clusters,
                     float* __restrict__ out) {
  __shared__ float tcomb[kWarps][kTile];
  __shared__ int scomb[kWarps][kTile];
  const int warp = threadIdx.x / kTile;
  const int lane = threadIdx.x % kTile;
  const int g = lane / 4;
  const int k = lane % 4;
  const int tile = blockIdx.x;
  // A fragments of ray m (rays g, g + 8, g + 16, g + 24): the Plücker row
  // [d | d x o | 0 0] in two K = 4 chunks (column k of each), and [-o | 1]
  Split a6[4][2], a4[4];
  float tmin[4], bt[4];
  int bs[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const size_t ray = static_cast<size_t>(tile) * kTile + m * 8 + g;
    const float ox = o3[ray * 3], oy = o3[ray * 3 + 1], oz = o3[ray * 3 + 2];
    const float dx = d3[ray * 3], dy = d3[ray * 3 + 1], dz = d3[ray * 3 + 2];
    const float u6[8] = {dx, dy, dz, dy * oz - dz * oy, dz * ox - dx * oz,
                         dx * oy - dy * ox, 0.0f, 0.0f};
    const float u4[4] = {-ox, -oy, -oz, 1.0f};
    a6[m][0] = split(u6[k]);
    a6[m][1] = split(u6[4 + k]);
    a4[m] = split(u4[k]);
    tmin[m] = mm2[ray * 2];
    const float tmax = mm2[ray * 2 + 1];
    bt[m] = tmax > kBig ? kBig : tmax;
    bs[m] = -1;
  }
  for (int s = 0; s < kSteps; ++s) {
    const int orders =
        lane < kKB ? order_at(order, tile, s * kKB + lane, n_clusters) : 0;
    for (int nb = warp; nb < kBK / 8; nb += kWarps) {
      // B fragments: row k (and 4 + k) of triangle nb * 8 + g
      const int c = __shfl_sync(kFull, orders, nb / (kCluster / 8));
      const float* base = tris + static_cast<size_t>(c) * kRows24 * kCluster +
                          (nb % (kCluster / 8)) * 8 + g;
      Split b0[3], b1[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        b0[e] = split(__ldg(base + (6 * e + k) * kCluster));
        b1[e] = split(k < 2 ? __ldg(base + (6 * e + 4 + k) * kCluster) : 0.0f);
      }
      const Split bn = split(__ldg(base + (18 + k) * kCluster));
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rays 16h + (g, g + 8)
        float s0[4], s1[4], s2[4], tn[4];
        mma_3xtf32(s0, a6[2 * h][0], a6[2 * h + 1][0], b0[0]);
        mma_3xtf32_acc(s0, a6[2 * h][1], a6[2 * h + 1][1], b1[0]);
        mma_3xtf32(s1, a6[2 * h][0], a6[2 * h + 1][0], b0[1]);
        mma_3xtf32_acc(s1, a6[2 * h][1], a6[2 * h + 1][1], b1[1]);
        mma_3xtf32(s2, a6[2 * h][0], a6[2 * h + 1][0], b0[2]);
        mma_3xtf32_acc(s2, a6[2 * h][1], a6[2 * h + 1][1], b1[2]);
        mma_3xtf32(tn, a4[2 * h], a4[2 * h + 1], bn);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // element e: ray 16h + g + 8 (e / 2), triangle nb * 8 + 2k + e % 2
          const int m = 2 * h + e / 2;
          const float den = s0[e] + s1[e] + s2[e];
          const bool inside =
              (s0[e] >= 0.0f && s1[e] >= 0.0f && s2[e] >= 0.0f) ||
              (s0[e] <= 0.0f && s1[e] <= 0.0f && s2[e] <= 0.0f);
          const float f = den != 0.0f ? 1.0f / den : 0.0f;
          const float tt = tn[e] * f;
          if (inside && den != 0.0f && tt >= tmin[m] && tt < bt[m]) {
            bt[m] = tt;
            bs[m] = s * kBK + nb * 8 + 2 * k + e % 2;
          }
        }
      }
    }
  }
  // the 4 lanes of a row group hold the same rays: smallest t, then the
  // smallest slot
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      const float ot = __shfl_xor_sync(kFull, bt[m], x);
      const int os = __shfl_xor_sync(kFull, bs[m], x);
      if (ot < bt[m] || (ot == bt[m] && os < bs[m])) {
        bt[m] = ot;
        bs[m] = os;
      }
    }
    if (k == 0) {
      tcomb[warp][m * 8 + g] = bt[m];
      scomb[warp][m * 8 + g] = bs[m];
    }
  }
  combine_write(tcomb, scomb, tile, out);
}

}  // namespace

// mode 0 (mt) or 1 (plucker): order (n_tiles, 64) i32 whose first 6 x 8
// entries a tile name the clusters, o3 and d3 (n_tiles, 32, 3)
// f32, mm2 (n_tiles, 32, 2) f32 [t_min | t_max], tris (n_clusters, 9, 1,
// 128) f32 for mt or (n_clusters, 24, 1, 128) for plucker; out (n_tiles,
// 32, 2) f32. Returns the CUDA error of the launch (0 on success).
extern "C" int mxu_lab_launch(int mode, const int* order, const float* o3,
                              const float* d3, const float* mm2,
                              const float* tris, int n_tiles, int n_clusters,
                              float* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_clusters < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  if (mode == 0)
    lab12_mt_kernel<<<n_tiles, kThreads, 0, st>>>(
        order, o3, d3, mm2, tris, n_clusters, out);
  else if (mode == 1)
    lab12_plucker_kernel<<<n_tiles, kThreads, 0, st>>>(
        order, o3, d3, mm2, tris, n_clusters, out);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
