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
// -1. It computes the script's functions, not its TPU schedule: no group
// of 32 tiles, and the rows read in place from L2 (tris9 2.9 MB, tris24
// 7.8 MB; the card's L2 is 50 MB). Rows 22-23 of tris24 are never read.
// An order outside [0, C) is clamped (the script's DMA would read out of
// bounds).
//   * mt: the brick walk of L4-L7 (brick_walk.cuh brick_walk_kernel, kLab
//     12, which reads L12's o3, d3, mm2 and 64-entry order rows in the
//     kernel): a warp a tile, 4 tiles a block, 4 rays a lane, 4 workers of
//     8 lanes, worker w taking the quads w, w + 4, ... of the step's 8
//     clusters; mt_hit_fma with rcp_in_range and a step redone with
//     __frcp_rn where the warp met an odd denominator; running bests from
//     min(t_max, 3e38) (a NaN kept) and id -1, one compare a test, and the
//     workers met by (t, slot) after the walk.
//   * plucker (lab12_plucker_kernel): a warp a tile, 4 tiles a block. Lane
//     l is row group g = l / 4 and column k = l % 4 of the mma fragments:
//     it holds rays g, g + 8, g + 16, g + 24 and, of each 8-triangle
//     column block, triangles 2k and 2k + 1. The warp walks the tile's
//     768 column blocks (6 steps x 8 clusters x 16) in order; each lane
//     reads its 7 B values of block i + 1 before the products of block i
//     (the rows read in place through the read-only path), splits them in
//     two (x = hi + lo) and takes, per 16-ray row block, s0, s1 and s2 as
//     one mma.sync m16n8k8 each (K = 6 padded to 8 with zeros) and tnum as
//     one m16n8k4, each in TF32 split in two (lo.hi + hi.lo + hi.hi, as L11
//     in k1_lab.cu: a single TF32 pass is not near enough, since the
//     smallest t wins and its numerator is tiny). The epilogue runs on the
//     CUDA cores in FP32: den = (s0 + s1) + s2 and t = tnum x
//     rcp_in_range(den), a step redone with __frcp_rn where the warp met
//     an odd denominator, so t is tnum times the correctly rounded 1 / den
//     either way; then t in [t_min, best), one compare against the running
//     best; only where a lane of the warp found such a t does the rest of
//     the test run: the sides share a sign unless min(s0, s1, s2) < 0 <
//     max(s0, s1, s2), and den != 0, tested once (with t_min = -inf a t of
//     -inf would pass otherwise). After the walk the 4 lanes of a row group
//     meet by (t, slot).
//   The design was chosen by measurement in turns on the H100
//   (app/lab_bench.py, NVIDIA H100 80GB HBM3 at 700 W) against builds with
//   one choice changed (the first four before t was tested first): reading
//   ahead ran 5% ahead of reads in place and
//   1.4x ahead of staging each cluster through a two-stage cp.async ring;
//   m16n8k8 5% ahead of two m16n8k4 a side; a warp a tile 6% ahead of 8
//   warps a tile; testing t first 1.36x ahead of the whole test on every
//   element.
// The result is the script's (n_tiles, 32, 2) f32 block: t, then the
// slot's int32 bits.
//
// What bounds it on the card: mt the FP32 instruction rate (46 operations
// a test); plucker its TF32 products, 44 operations a test at the script's
// K, three times over for the split, at 495 TFLOP/s, beside an FP32
// epilogue of 14 operations a test. PR 13's first design took a block of 8
// warps a tile, one ray a lane and the unfused Möller-Trumbore with an
// IEEE 1 / a in every test (mt), and, for plucker, two m16n8k4 a side,
// loads that each block waited out, and an IEEE division and the whole
// hit test on every element.
//
// Built with -fmad=false (trace_kernel.NVCC_FLAGS): mt's FMAs are written
// out, so it is held to its unfused plain version tie-aware
// (lab/mxu_lab.mt_agreement); plucker's products differ from FP32 by the
// split's error, so it is held to the plain FP32 version tie-aware
// (lab/mxu_lab.plucker_agreement).

#include <cuda_runtime.h>

#include "brick_walk.cuh"
#include "lab_common.cuh"

namespace {

constexpr int kTile = 32;             // rays per tile = lanes per warp
constexpr int kKB = 8;                // clusters per step
constexpr int kSteps = 6;             // steps a tile (the script's STEPS)
constexpr int kRows24 = 24;
constexpr int kColBlocks = kCluster / 8;          // 8-triangle blocks
constexpr int kStepBlocks = kKB * kColBlocks;     // of a step: 128

// The order entry of tile row orow at k, clamped to [0, C)
__device__ __forceinline__ int order_at(const int* orow, int k,
                                        int n_clusters) {
  return max(0, min(orow[k], n_clusters - 1));
}

// Lane (g, k)'s B values of one column block, its rows read from base (the
// block's column g of its cluster's row 0) through the read-only path:
// v[e] row 6e + k and v[3 + e] row 6e + 4 + k (0 for k >= 2: K's padding)
// of side e, v[6] row 18 + k (tnum).
__device__ __forceinline__ void load_b(float (&v)[7], const float* base,
                                       int k) {
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    v[e] = __ldg(base + (6 * e + k) * kCluster);
    v[3 + e] = k < 2 ? __ldg(base + (6 * e + 4 + k) * kCluster) : 0.0f;
  }
  v[6] = __ldg(base + (18 + k) * kCluster);
}

// One column block against the lane's 4 rays: the four products of each
// 16-ray row block h in TF32 split in two, then the epilogue; slot0 = the
// block's first slot (i * 8, i its place in the walk) + 2k. Element e of a
// product is ray 16h + g + 8 (e / 2) (m = 2h + e / 2), triangle 2k + e % 2
// of the block. Each element's t is tested against [t_min, best) first;
// the rest of the hit test (the signs, den != 0, and t against a best that
// the row block's earlier elements may have lowered) runs only where a
// lane of the warp found such a t. odd: see rcp_in_range.
template <bool kExact>
__device__ __forceinline__ void plucker_block(
    const float (&v)[7], int slot0, const Split (&a6)[4][2],
    const Split (&a4)[4], const float (&tmin)[4], float (&bt)[4],
    int (&bs)[4], bool& odd) {
  Split b0[3], b1[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    b0[e] = split(v[e]);
    b1[e] = split(v[3 + e]);
  }
  const Split bn = split(v[6]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s[3][4], tn[4];
#pragma unroll
    for (int e = 0; e < 3; ++e)
      mma_3xtf32_k8(s[e], a6[2 * h][0], a6[2 * h + 1][0], a6[2 * h][1],
                    a6[2 * h + 1][1], b0[e], b1[e]);
    mma_3xtf32(tn, a4[2 * h], a4[2 * h + 1], bn);
    float den[4], tt[4];
    bool cand = false;  // a t in [t_min, best) among the lane's elements
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 2 * h + e / 2;
      den[e] = s[0][e] + s[1][e] + s[2][e];
      tt[e] = tn[e] * rcp_rn<kExact>(den[e], odd);
      cand |= tt[e] >= tmin[m] && tt[e] < bt[m];
    }
    if (!__any_sync(kFull, cand)) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 2 * h + e / 2;
      // the sides share a sign unless one is below 0 and another above
      const bool mixed =
          fminf(fminf(s[0][e], s[1][e]), s[2][e]) < 0.0f &&
          fmaxf(fmaxf(s[0][e], s[1][e]), s[2][e]) > 0.0f;
      if (!mixed && den[e] != 0.0f && tt[e] >= tmin[m] && tt[e] < bt[m]) {
        bt[m] = tt[e];
        bs[m] = slot0 + (e & 1);
      }
    }
  }
}

__global__ void __launch_bounds__(kTilesBlock * kTile)
lab12_plucker_kernel(const int* __restrict__ order,
                     const float* __restrict__ o3,
                     const float* __restrict__ d3,
                     const float* __restrict__ mm2,
                     const float* __restrict__ tris, int n_tiles,
                     int n_clusters, float* __restrict__ out) {
  const int warp = threadIdx.x / kTile;
  const int lane = threadIdx.x % kTile;
  const int tile = blockIdx.x * kTilesBlock + warp;
  if (tile >= n_tiles) return;
  const int g = lane / 4;
  const int k = lane % 4;
  // A fragments of ray m (rays g, g + 8, g + 16, g + 24): the Plücker row
  // [d | d x o | 0 0], columns k and 4 + k, and [-o | 1], column k
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
    const float2 mm = reinterpret_cast<const float2*>(mm2)[ray];
    tmin[m] = mm.x;
    bt[m] = mm.y > kBig ? kBig : mm.y;  // jnp.minimum: a NaN kept
    bs[m] = -1;
  }
  // lane l: the clamped order entries l and 32 + l (the walk's 48)
  const int* orow = order + static_cast<size_t>(tile) * kRowL12;
  const int o_lo = order_at(orow, lane, n_clusters);
  const int o_hi = lane < kSteps * kKB - 32
                       ? order_at(orow, 32 + lane, n_clusters) : 0;
  auto cluster = [&](int p) {  // the cluster at walk position p
    return __shfl_sync(kFull, p < 32 ? o_lo : o_hi, p & 31);
  };
  // column block i's rows: cluster position i / 16, column (i % 16) 8 + g
  auto base = [&](int i) {
    return tris +
           static_cast<size_t>(cluster(i / kColBlocks)) * kRows24 *
               kCluster +
           (i % kColBlocks) * 8 + g;
  };
  float nxt[7];  // the B values of the next block, read ahead
  for (int s = 0; s < kSteps; ++s) {
    float st[4];
    int ss[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      st[m] = bt[m];
      ss[m] = bs[m];
    }
    bool odd = false;  // a den outside rcp_in_range's range
    // (a step's blocks only: nothing read ahead stays live across a redo)
    load_b(nxt, base(s * kStepBlocks), k);
#pragma unroll 1
    for (int i = s * kStepBlocks; i < (s + 1) * kStepBlocks; ++i) {
      float v[7];
#pragma unroll
      for (int j = 0; j < 7; ++j) v[j] = nxt[j];
      if (i + 1 < (s + 1) * kStepBlocks) load_b(nxt, base(i + 1), k);
      plucker_block<false>(v, i * 8 + 2 * k, a6, a4, tmin, bt, bs, odd);
    }
    if (__any_sync(kFull, odd)) {  // the step again with __frcp_rn
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        bt[m] = st[m];
        bs[m] = ss[m];
      }
#pragma unroll 1
      for (int i = s * kStepBlocks; i < (s + 1) * kStepBlocks; ++i) {
        float v[7];
        load_b(v, base(i), k);
        plucker_block<true>(v, i * 8 + 2 * k, a6, a4, tmin, bt, bs, odd);
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
  }
  if (k == 0) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
      reinterpret_cast<float2*>(out)[static_cast<size_t>(tile) * kTile +
                                     m * 8 + g] =
          make_float2(bt[m], __int_as_float(bs[m]));
  }
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
  const int blocks = (n_tiles + kTilesBlock - 1) / kTilesBlock;
  if (mode == 0)
    brick_walk_kernel<12, kMT, kFixed, kTile, 4>
        <<<blocks, kTilesBlock * kTile, 0, st>>>(order, o3, d3, mm2, tris,
                                                 n_tiles, n_clusters, kKB,
                                                 kSteps, out);
  else if (mode == 1)
    lab12_plucker_kernel<<<blocks, kTilesBlock * kTile, 0, st>>>(
        order, o3, d3, mm2, tris, n_tiles, n_clusters, out);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
