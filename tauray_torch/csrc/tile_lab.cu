// The three labs of K2's Möller-Trumbore tile walk at 128-ray tiles, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernels of tauray_tpu's TPU lab script
// scripts/kernel_lab.py:
//   * L1, k0 (:72), k1 (:80), k2 (:105) and k3 (:161), launched by run
//     (pallas_call :61): the walk stripped piece by piece. k0 writes the
//     outputs only; k1 adds the copy of the tile's meta row (3 x 1,024
//     int32) and writes its first entry, unclipped, as the id; k2 adds each
//     step's copy of 8 clusters of tris9 rows and writes the FP32 sum, in
//     step order, of each step's first element (no test); k3 adds the
//     Möller-Trumbore test of every ray against the step's 1,024
//     triangles, with no exit;
//   * L2, k4 (:271, pallas_call :424): k3 plus the tile's exit after each
//     step, 8 tiles walked in turn a grid step, rays as planes (8, 128)
//     and out as (2, 128) a tile;
//   * L3, make_k5(G) (:433, pallas_call :586): k4 with rays as rows (128,
//     8) and out (128, 2), G tiles a grid step.
// It computes the script's functions (tauray_torch/lab/kernel_lab.py
// states them), not its TPU schedule.
//
// L1 and L2 (tile_lab_kernel): the meta row's SMEM double buffer across
// grid steps is not carried; G tiles walked in turn by one block is, since
// L2 asks about it. One block of 8 warps walks G tiles (L1: one): every
// mode from k1 on copies the tile's meta row into shared memory with
// cp.async and waits, as the script's DMA does; k2 and later stage each
// step's 8 clusters x 9 rows x 128 floats (36 KB; 72 KB double buffered)
// with cp.async 16-byte copies one step ahead, so k2 performs and waits
// for every copy of the walk although it reads one float a step.
//   * Threads: warps 0-3 and 4-7 are two workers over the tile's 128 rays,
//     one lane a ray (thread = worker * 128 + ray): worker p tests the
//     step's quads p, p + 2, ..., 4 triangles a 16-byte row load, each
//     warp's 32 lanes reading one address (a broadcast). No lane idles.
//   * Each worker keeps a running best (t, slot), strict <, slot = step *
//     1,024 + the triangle's lane in the step: a step's candidate (the
//     first smallest, tested against the best from before the step) beats
//     that best exactly when it beats the running best, so the walk's
//     result is the smallest t, then the smallest slot. The two workers'
//     bests are combined by (t, slot), never by id (the script's random
//     meta repeats clusters within a tile), once after the walk; the id is
//     then the slot's cluster, clip(meta[min(slot / 128, 1,023)], 0, C -
//     1), x 128 + slot % 128. Slots at or past the tile's count are
//     skipped (the script's slot_ok).
//   * The exit (k4): after each step the workers' t meet in shared memory
//     and the block votes with __syncthreads_and whether every ray's best
//     t, as int32 bits, is <= the unclipped tnear entry meta[tile * 3,072
//     + 1,024 + min((step + 1) * 8, 1,023)]. After an early exit the
//     prefetch of the next step is still in flight: the block drains its
//     copies before the next tile reuses the buffers.
// Blocks: 512 tiles give L1 512 blocks and L2 64 against the card's 132
// SMs; that is what these labs measure. Two blocks fit an SM (86 KB of
// shared memory each).
//
// L3 (lab3_kernel, redesigned for this card): one block a 128-ray tile
// whatever G is (G amortised a TPU grid step's fixed cost; here a tile's
// fixed cost is ~0.1 us and G only took blocks away: 512 / G blocks walked
// G tiles in turn), so 512 tiles give 512 blocks. R = 4 rays a lane (lane
// l holds rays l + 32k, k < 4), so each warp holds the whole tile, and the
// block's W = 8 warps are workers over a step's 256 quads: warp w takes
// the quads w, w + 8, ..., each 16-byte row load (a shared-memory
// broadcast) serving 4 triangles x 4 rays, the loop and address steps 16
// tests. The step's rows are staged one step ahead by the whole block with
// cp.async, as L1 and L2 stage them (72 KB; two blocks an SM at 128
// registers, 16 warps). Each worker starts its candidates at the best from
// before the step (the one compare tt < ct of mt_hit_fma); after the step
// the warps meet in shared memory (a double buffer, one __syncthreads a
// step) and every warp combines the W bests of its 128 rays by smallest
// t, then smallest slot, so every warp holds the tile's best and votes the
// exit alone (__all_sync; the warps' votes agree). The next step starts
// from the combined best. A warp whose step met a denominator outside
// rcp_in_range's range redoes its share with __frcp_rn. After an early
// exit the block drains the next step's copies. Measured on the H100
// against builds of this design's variants, in turns: W = 4 (4 blocks an
// SM) ran within 1% of W = 8; rows read in place from L2 (L7's way) ran
// 2-3% slower than the staged ring.
//
// What bounds it on the card: k0 and k1 move bytes only (12 bytes a ray,
// the 12 KB meta row a tile); k2 the rows (the 2.9 MB table stays in the
// 50 MB L2); k3-k5 the FP32 instruction rate, 46 operations a test, none
// fused under -fmad=false in k3 and k4; L3 takes mt_hit_fma (31 FP32
// instructions).
//
// Built with -fmad=false (trace_kernel.NVCC_FLAGS) and 1 / a an IEEE
// division, so k0-k4 round like their plain torch versions: t and ids
// compare bit for bit. L3's FMA body rounds otherwise and is held by
// kernel_lab.lab3_agreement (lab/common.py tie_aware_hold).

#include <cuda_runtime.h>

#include "lab_common.cuh"

namespace {

constexpr int kCluster = 128;              // triangles per cluster
constexpr int kQuads = kCluster / 4;       // float4 of a cluster row
constexpr int kTile = 128;                 // rays per tile
constexpr int kKB = 8;                     // clusters per step
constexpr int kBK = kKB * kCluster;        // triangles per step
constexpr int kStepQuads = kBK / 4;        // float4 of a step's row
constexpr int kCpad = 1024;                // cluster entries of a meta row
constexpr int kRow = 3 * kCpad;            // meta entries of a tile
constexpr int kRows = 9;                   // floats per triangle (tris9)
constexpr int kWorkers = 2;
constexpr int kThreads = kWorkers * kTile;  // 8 warps
constexpr int kStage = kRows * kStepQuads;  // float4 of a staged step
constexpr float kBig = 3.0e38f;

enum Mode { kK0 = 0, kK1 = 1, kK2 = 2, kK3 = 3, kK4 = 4 };
// the rays' and the output's layout: L1's 8 (and 2) columns of n_rays,
// L2's planes (8, 128) (and (2, 128)) a tile
enum Layout { kColumns = 0, kPlanes = 1 };

template <int kMode>
constexpr size_t smem_bytes() {
  return (kMode >= kK2 ? 2 * kStage * sizeof(float4) : 0) +
         (kMode >= kK1 ? kRow * sizeof(int) : 0) +
         (kMode >= kK3 ? 2 * kThreads * sizeof(float) : 0);
}

template <int kLayout>
__device__ __forceinline__ float ray_field(const float* rays, size_t n_rays,
                                           int tile, int r, int f) {
  const size_t ray = static_cast<size_t>(tile) * kTile + r;
  if (kLayout == kColumns) return rays[f * n_rays + ray];
  if (kLayout == kPlanes)
    return rays[(static_cast<size_t>(tile) * 8 + f) * kTile + r];
  return rays[ray * 8 + f];
}

// kMode's walk (see the head of this file) over group tiles a block, in
// turn: tile = blockIdx.x * group + g.
template <int kMode, int kLayout>
__global__ void __launch_bounds__(kThreads, 2)
tile_lab_kernel(const int* __restrict__ counts, const int* __restrict__ meta,
                const float* __restrict__ rays, const float* __restrict__ tris,
                int n_tiles, int n_clusters, int group,
                float* __restrict__ out) {
  extern __shared__ float4 smem[];
  float4* stage_buf = smem;
  int* mrow = reinterpret_cast<int*>(smem + (kMode >= kK2 ? 2 * kStage : 0));
  float* tcomb = reinterpret_cast<float*>(mrow + kRow);
  int* scomb = reinterpret_cast<int*>(tcomb + kThreads);
  const int p = threadIdx.x / kTile;  // worker
  const int r = threadIdx.x % kTile;  // ray of the tile
  const size_t n_rays = static_cast<size_t>(n_tiles) * kTile;
  const float4* t4 = reinterpret_cast<const float4*>(tris);

  for (int g = 0; g < group; ++g) {
    const int tile = blockIdx.x * group + g;
    const size_t ray = static_cast<size_t>(tile) * kTile + r;
    Ray R;
    const float tmax = ray_field<kLayout>(rays, n_rays, tile, r, 7);
    if (kMode >= kK3) {
      R = Ray{ray_field<kLayout>(rays, n_rays, tile, r, 0),
              ray_field<kLayout>(rays, n_rays, tile, r, 1),
              ray_field<kLayout>(rays, n_rays, tile, r, 2),
              ray_field<kLayout>(rays, n_rays, tile, r, 3),
              ray_field<kLayout>(rays, n_rays, tile, r, 4),
              ray_field<kLayout>(rays, n_rays, tile, r, 5),
              ray_field<kLayout>(rays, n_rays, tile, r, 6)};
    }
    float bt = tmax > kBig ? kBig : tmax;  // jnp.minimum: NaN kept
    int bslot = -1;
    int id = -1;

    if (kMode >= kK1) {
      // the tile's meta row into shared memory, 16 bytes a copy
      const int* src = meta + static_cast<size_t>(tile) * kRow;
      for (int e = threadIdx.x; e < kRow / 4; e += kThreads)
        cp_async16(mrow + 4 * e, src + 4 * e);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    if (kMode == kK1) id = mrow[0];

    if (kMode >= kK2) {
      const int count = counts[tile];
      const int steps = (count + kKB - 1) / kKB;
      // step s's 8 clusters into buffer s & 1: [row][cluster][quad]
      auto stage = [&](int s) {
        float4* dst = stage_buf + (s & 1) * kStage;
        for (int e = threadIdx.x; e < kStage; e += kThreads) {
          const int j = e / (kRows * kQuads);
          const int row = e / kQuads % kRows;
          const int q = e % kQuads;
          const int m = mrow[min(s * kKB + j, kCpad - 1)];
          const int c = max(0, min(m, n_clusters - 1));
          cp_async16(dst + row * kStepQuads + j * kQuads + q,
                     t4 + (static_cast<size_t>(c) * kRows + row) * kQuads + q);
        }
        cp_async_commit();
      };
      float acc = 0.0f;
      if (steps > 0) stage(0);
      for (int s = 0; s < steps; ++s) {
        if (s + 1 < steps) {
          stage(s + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // step s's rows are in for every thread
        const float4* buf = stage_buf + (s & 1) * kStage;
        if (kMode == kK2) {
          acc = acc + reinterpret_cast<const float*>(buf)[0];
        } else {
          for (int quad = p; quad < kStepQuads; quad += kWorkers) {
            if (s * kKB + quad / kQuads >= count) continue;  // slot_ok
            float4 v[kRows];
#pragma unroll
            for (int j = 0; j < kRows; ++j) v[j] = buf[j * kStepQuads + quad];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              float w[kRows];
#pragma unroll
              for (int j = 0; j < kRows; ++j) w[j] = comp(v[j], c);
              float tt;
              if (mt_hit(R, w, bt, tt)) {
                bt = tt;
                bslot = s * kBK + 4 * quad + c;
              }
            }
          }
        }
        if (kMode == kK4) {
          // every ray's best t against the next step's tnear entry
          tcomb[threadIdx.x] = bt;
          __syncthreads();
          const float u = tcomb[r];
          const float v = tcomb[kTile + r];
          const float best = v < u ? v : u;
          const int nk = min((s + 1) * kKB, kCpad - 1);
          if (__syncthreads_and(__float_as_int(best) <= mrow[kCpad + nk]))
            break;
        } else {
          __syncthreads();  // every thread is done with buffer s & 1
        }
      }
      // an exit leaves the next step's copies in flight: drain them
      cp_async_wait<0>();
      if (kMode == kK2 && steps > 0) bt = acc;
    }

    if (kMode >= kK3) {
      // the workers' bests: smallest t, then smallest slot
      tcomb[threadIdx.x] = bt;
      scomb[threadIdx.x] = bslot;
      __syncthreads();
      if (p == 0) {
        const float ut = tcomb[kTile + r];
        const int us = scomb[kTile + r];
        if (ut < bt || (ut == bt && us < bslot)) {
          bt = ut;
          bslot = us;
        }
        if (bslot >= 0) {
          const int m = mrow[min(bslot / kCluster, kCpad - 1)];
          id = max(0, min(m, n_clusters - 1)) * kCluster + bslot % kCluster;
        }
      }
    }

    if (p == 0) {
      const float idf = __int_as_float(id);
      if (kLayout == kColumns) {
        out[ray] = bt;
        out[n_rays + ray] = idf;
      } else {
        out[static_cast<size_t>(tile) * 2 * kTile + r] = bt;
        out[(static_cast<size_t>(tile) * 2 + 1) * kTile + r] = idf;
      }
    }
    // the next tile overwrites the meta row, the buffers and the combines
    if (kMode >= kK1) __syncthreads();
  }
}

template <int kMode, int kLayout>
int launch(const int* counts, const int* meta, const float* rays,
           const float* tris, int n_tiles, int n_clusters, int group,
           float* out, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<kMode>();
  auto kernel = tile_lab_kernel<kMode, kLayout>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<n_tiles / group, kThreads, smem, st>>>(
      counts, meta, rays, tris, n_tiles, n_clusters, group, out);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// L3, redesigned for this card (see the head of this file)
// ---------------------------------------------------------------------------

constexpr int kWarps3 = 8;  // W: warps of a block, workers over a step
constexpr int kRays3 = 4;   // R: rays a lane; a warp holds the whole tile
constexpr unsigned kFull = 0xffffffffu;

// Warp w's share of step s: the quads w, w + W, ... of the step's 8
// clusters staged in buf ([row][quad of the step]), each triangle against
// the lane's R rays (FMA body); slots at or past count are skipped. A hit
// closer than ct[k] takes (ct[k], cs[k]) with its t and its slot. odd:
// see bw_hit_fma (lab_common.cuh).
template <int R, bool kExact>
__device__ __forceinline__ void lab3_step(const float4* buf, int count, int s,
                                          int warp, const Ray (&r)[R],
                                          float (&ct)[R], int (&cs)[R],
                                          bool& odd) {
#pragma unroll 1
  for (int q = warp; q < kStepQuads; q += kWarps3) {
    const int j = q / kQuads;
    if (s * kKB + j >= count) break;  // slot_ok; the later quads' too
    float4 v[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) v[i] = buf[i * kStepQuads + q];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float w[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) w[i] = comp(v[i], cc);
      const int slot = s * kBK + 4 * q + cc;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        float tt;
        if (mt_hit_fma<kExact>(r[k], w, ct[k], tt, odd)) {
          ct[k] = tt;
          cs[k] = slot;
        }
      }
    }
  }
}

// One block walks one tile of 128 rows-layout rays; every warp holds its
// 128 rays (lane l: rays l + 32k) and takes 1/W of each step's quads.
// Each step's 8 clusters x 9 rows (36 KB) are staged by the whole block
// one step ahead, in a ring of two stages (72 KB of dynamic shared
// memory), as tile_lab_kernel stages them.
template <int R>
__global__ void __launch_bounds__(kWarps3 * 32, 16 / kWarps3)
lab3_kernel(const int* __restrict__ counts, const int* __restrict__ meta,
            const float* __restrict__ rays, const float* __restrict__ tris,
            int n_clusters, float* __restrict__ out) {
  static_assert(R * 32 == kTile, "a warp holds the tile's rays");
  // the warps' bests after a step, double buffered by the step's parity
  __shared__ float tcomb[2][kWarps3][kTile];
  __shared__ int scomb[2][kWarps3][kTile];
  extern __shared__ float4 ring[];  // 2 stages of kStage
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tile = blockIdx.x;
  const int* mrow = meta + static_cast<size_t>(tile) * kRow;
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  const float4* r4 = reinterpret_cast<const float4*>(rays) +
                     static_cast<size_t>(tile) * kTile * 2;
  Ray r[R];
  float bt[R];
  int bs[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const float4 a = r4[(lane + 32 * k) * 2];
    const float4 b = r4[(lane + 32 * k) * 2 + 1];
    r[k] = Ray{a.x, a.y, a.z, a.w, b.x, b.y, b.z};
    bt[k] = b.w > kBig ? kBig : b.w;  // jnp.minimum keeps a NaN
    bs[k] = -1;
  }
  const int count = counts[tile];
  const int steps = (count + kKB - 1) / kKB;
  // step s's clusters into stage s & 1, one cp.async group a thread
  auto stage = [&](int s) {
    float4* dst = ring + (s & 1) * kStage;
    for (int e = threadIdx.x; e < kStage; e += kWarps3 * 32) {
      const int j = e / (kRows * kQuads);
      const int row = e / kQuads % kRows;
      const int q = e % kQuads;
      const int m = mrow[min(s * kKB + j, kCpad - 1)];
      const int c = max(0, min(m, n_clusters - 1));
      cp_async16(dst + row * kStepQuads + j * kQuads + q,
                 t4 + (static_cast<size_t>(c) * kRows + row) * kQuads + q);
    }
    cp_async_commit();
  };
  if (steps > 0) stage(0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step s's rows are in for every thread
    const float4* buf = ring + (s & 1) * kStage;
    float ct[R];
    int cs[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      ct[k] = bt[k];
      cs[k] = bs[k];
    }
    bool odd = false;  // a den outside rcp_in_range's range
    lab3_step<R, false>(buf, count, s, warp, r, ct, cs, odd);
    if (__any_sync(kFull, odd)) {  // the warp's share again with __frcp_rn
#pragma unroll
      for (int k = 0; k < R; ++k) {
        ct[k] = bt[k];
        cs[k] = bs[k];
      }
      lab3_step<R, true>(buf, count, s, warp, r, ct, cs, odd);
    }
    // the workers' bests: smallest t, then smallest slot
    const int par = s & 1;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      tcomb[par][warp][lane + 32 * k] = ct[k];
      scomb[par][warp][lane + 32 * k] = cs[k];
    }
    __syncthreads();
    bool done = true;
    const int nk = mrow[kCpad + min((s + 1) * kKB, kCpad - 1)];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float t = tcomb[par][0][lane + 32 * k];
      int slot = scomb[par][0][lane + 32 * k];
      for (int w = 1; w < kWarps3; ++w) {
        const float ut = tcomb[par][w][lane + 32 * k];
        const int us = scomb[par][w][lane + 32 * k];
        if (ut < t || (ut == t && us < slot)) {
          t = ut;
          slot = us;
        }
      }
      bt[k] = t;
      bs[k] = slot;
      done &= __float_as_int(t) <= nk;
    }
    // every warp holds the tile's bests: the votes agree
    if (__all_sync(kFull, done)) break;
  }
  cp_async_wait<0>();  // an exit leaves the next step's copies in flight
  if (warp != 0) return;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    int id = -1;
    if (bs[k] >= 0) {
      const int m = mrow[min(bs[k] / kCluster, kCpad - 1)];
      id = max(0, min(m, n_clusters - 1)) * kCluster + bs[k] % kCluster;
    }
    reinterpret_cast<float2*>(out)[static_cast<size_t>(tile) * kTile + lane +
                                   32 * k] =
        make_float2(bt[k], __int_as_float(id));
  }
}

}  // namespace

// kernel 0-3: L1's k0-k3, rays (8, n_tiles * 128) f32 columns [o | d |
// t_min | t_max], out (2, n_tiles * 128) f32 [t | id bits], group 1;
// kernel 4: L2's k4, rays (n_tiles, 8, 128) planes, out (n_tiles, 2, 128);
// kernel 5: L3's k5, rays (n_tiles, 128, 8) rows, out (n_tiles, 128, 2),
// one block a tile whatever the group.
// counts (n_tiles,) i32, meta (n_tiles x 3,072,) i32, tris (n_clusters, 9,
// 1, 128) f32; group divides n_tiles. Returns the CUDA error of the launch
// (0 on success).
extern "C" int tile_lab_launch(int kernel, const int* counts,
                               const int* meta, const float* rays,
                               const float* tris, int n_tiles,
                               int n_clusters, int group, float* out,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group < 1 || n_tiles % group || n_clusters < 1 ||
      (kernel < 4 && group != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
#define TILE_ARGS counts, meta, rays, tris, n_tiles, n_clusters, group, out, st
  switch (kernel) {
    case 0:
      return launch<kK0, kColumns>(TILE_ARGS);
    case 1:
      return launch<kK1, kColumns>(TILE_ARGS);
    case 2:
      return launch<kK2, kColumns>(TILE_ARGS);
    case 3:
      return launch<kK3, kColumns>(TILE_ARGS);
    case 4:
      return launch<kK4, kPlanes>(TILE_ARGS);
    case 5: {
      constexpr int smem = 2 * kStage * sizeof(float4);
      const cudaError_t e = cudaFuncSetAttribute(
          lab3_kernel<kRays3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      lab3_kernel<kRays3><<<n_tiles, kWarps3 * 32, smem, st>>>(
          counts, meta, rays, tris, n_clusters, out);
      return static_cast<int>(cudaGetLastError());
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TILE_ARGS
}
