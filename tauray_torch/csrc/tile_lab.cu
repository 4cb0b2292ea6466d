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
//     step, rays as planes (8, 128) and out as (2, 128) a tile, 8 tiles a
//     TPU grid step;
//   * L3, make_k5(G) (:433, pallas_call :586): k4 with rays as rows (128,
//     8) and out (128, 2), G tiles a grid step.
// It computes the script's functions (tauray_torch/lab/kernel_lab.py
// states them), not its TPU schedule.
//
// One template, tile_walk_kernel<kMode, kLayout, R>, runs all six: k0-k3
// in L1's columns, k4 (kExit) in L2's planes, k5 (kExit) in L3's rows. The
// layout says only where field f of a ray is read and where its t and id
// are written; every mode has the same block shape.
//   * One block of W = 8 warps a 128-ray tile, whatever the script's G (G
//     amortised a TPU grid step's fixed cost; here a tile's fixed cost is
//     ~0.1 us and G tiles walked in turn only took blocks away), so 512
//     tiles give 512 blocks in every mode.
//   * R = 4 rays a lane: lane l holds rays l + 32k, k < 4, so each warp
//     holds the whole tile, and a warp's loads of one field in columns or
//     planes are 128 contiguous bytes (rows: two 16-byte loads a ray).
//   * Each mode does what the mode before it does, then its own piece:
//     k0 writes min(t_max, 3e38) and -1 (warp 0 writes the tile);
//     k1 copies the tile's 12 KB meta row into shared memory with
//     cp.async and waits, as the script's DMA into SMEM does, and writes
//     its first entry as the id; k2 and later read every order (and the
//     exit's tnear entries) from that copy and stage each step's 8
//     clusters x 9 rows x 128 floats (36 KB) with cp.async 16-byte copies
//     one step ahead in a ring of two stages (72 KB), so k2 performs and
//     waits for every copy of the walk although it reads one float a step;
//     k3 adds the test. So "k2 - k1" is the staging and "k3 - k2" the
//     test (with its combine).
//   * The ring takes one block barrier a step: at the top of step s, after
//     each thread waited for its copies of step s, the barrier makes them
//     visible to the block and tells it that every warp is done with step
//     s - 1, whose stage the copies of step s + 1 (issued right after it)
//     overwrite.
//   * The test (k3-k5): warp w takes the quads w, w + W, ... of each step's
//     256, each 16-byte row load (a shared-memory broadcast) serving 4
//     triangles x the lane's 4 rays, with mt_hit_fma (lab_common.cuh): a
//     candidate beats the best it started from with one compare tt < ct,
//     so each warp keeps the first smallest hit of its quads. A warp whose
//     share met a denominator outside rcp_in_range's range redoes it with
//     __frcp_rn. Slots at or past the tile's count are skipped (the
//     script's slot_ok); the clip clip(meta[min(8s + j, 1,023)], 0, C - 1)
//     is the script's.
//   * k3 (no exit): each warp keeps its own running best over the whole
//     walk; the warps combine once, after it, by smallest t, then smallest
//     slot (slot = step * 1,024 + the triangle's lane in the step). That
//     is the per-step combine's result: mt_hit_fma's t does not depend on
//     the best it is compared with, and each warp visits its slots in
//     ascending order, so both give the walk's smallest (t, slot).
//   * k4, k5 (kExit): after each step the warps' bests meet in shared
//     memory (a double buffer by the step's parity, read after the next
//     step's barrier), every warp combines the W bests of its 128 rays by
//     (t, slot), never by id (the script's random meta repeats clusters
//     within a tile), and votes alone with __all_sync whether every ray's
//     combined t, as int32 bits, is <= the unclipped tnear entry
//     meta[tile * 3,072 + 1,024 + min(8 (s + 1), 1,023)] (the warps' votes
//     agree). The next step starts from the combined best. The vote comes
//     after the wait for the next step's copies, so an exit leaves none in
//     flight.
//   * The id is the winning slot's cluster, clip(meta[min(slot / 128,
//     1,023)], 0, C - 1), x 128 + slot % 128.
// Shared memory: k1 12 KB, k2 84 KB, k3 92 KB, k4 / k5 100 KB (the ring,
// the meta row, the combine's t and slot); two blocks an SM (16 warps at
// <= 128 registers). The attribute that allows more than 48 KB is set once
// per instance, at its first launch, not in every launch.
//
// What bounds it on the card: k0 and k1 move bytes only (12 bytes a ray,
// the 12 KB meta row a tile); k2 the rows (the 2.9 MB table stays in the
// 50 MB L2); k3-k5 the FP32 instruction rate (46 operations a test,
// mt_hit_fma's 31 FP32 instructions).
//
// Built with -fmad=false (trace_kernel.NVCC_FLAGS): k0-k2 compare bit for
// bit with their plain torch versions; k3-k5's FMA body rounds otherwise
// than the unfused plain version and is held by kernel_lab.lab3_agreement
// (lab/common.py tie_aware_hold). k3, k4 and k5 share that body, so on the
// script's meta, where the exit never fires, they equal one another bit for
// bit.

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
constexpr int kStage = kRows * kStepQuads;  // float4 of a staged step
constexpr int kWarps = 8;                  // W: warps of a block
constexpr int kThreads = kWarps * 32;
constexpr int kRays = 4;                   // R: rays a lane
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

// the script's kernels; k4 and k5 are one walk (kExit) in two layouts
enum Mode { kK0 = 0, kK1 = 1, kK2 = 2, kK3 = 3, kExit = 4 };
// where a ray's 8 fields are read and its t and id written: L1's columns
// (8, n_rays) and (2, n_rays), L2's planes (n_tiles, 8, 128) and (n_tiles,
// 2, 128), L3's rows (n_tiles, 128, 8) and (n_tiles, 128, 2)
enum Layout { kColumns = 0, kPlanes = 1, kRayRows = 2 };

// the combine's sets of W x 128 (t, slot): k3 one, after the walk; the
// exit two, a double buffer by the step's parity
template <int kMode>
__host__ __device__ constexpr int combine_sets() {
  return kMode == kExit ? 2 : kMode == kK3 ? 1 : 0;
}

template <int kMode>
constexpr size_t smem_bytes() {
  return (kMode >= kK2 ? 2 * kStage * sizeof(float4) : 0) +
         (kMode >= kK1 ? kRow * sizeof(int) : 0) +
         combine_sets<kMode>() * kWarps * kTile * (sizeof(float) + sizeof(int));
}

// Ray r of tile (its fields 0-6 and t_max) in kLayout
template <int kLayout>
__device__ __forceinline__ void load_ray(const float* rays, size_t n_rays,
                                         int tile, int r, Ray& ray,
                                         float& tmax) {
  const size_t i = static_cast<size_t>(tile) * kTile + r;
  if (kLayout == kRayRows) {
    const float4* r4 = reinterpret_cast<const float4*>(rays) + i * 2;
    const float4 a = r4[0];
    const float4 b = r4[1];
    ray = Ray{a.x, a.y, a.z, a.w, b.x, b.y, b.z};
    tmax = b.w;
  } else {
    float v[8];
#pragma unroll
    for (int f = 0; f < 8; ++f)
      v[f] = kLayout == kColumns
                 ? rays[f * n_rays + i]
                 : rays[(static_cast<size_t>(tile) * 8 + f) * kTile + r];
    ray = Ray{v[0], v[1], v[2], v[3], v[4], v[5], v[6]};
    tmax = v[7];
  }
}

// Ray r of tile's t and id (as its int32 bits) in kLayout
template <int kLayout>
__device__ __forceinline__ void store_out(float* out, size_t n_rays,
                                          int tile, int r, float t, int id) {
  const size_t i = static_cast<size_t>(tile) * kTile + r;
  const float idf = __int_as_float(id);
  if (kLayout == kColumns) {
    out[i] = t;
    out[n_rays + i] = idf;
  } else if (kLayout == kPlanes) {
    out[static_cast<size_t>(tile) * 2 * kTile + r] = t;
    out[(static_cast<size_t>(tile) * 2 + 1) * kTile + r] = idf;
  } else {
    reinterpret_cast<float2*>(out)[i] = make_float2(t, idf);
  }
}

// Warp w's share of step s: the quads w, w + W, ... of the step's 8
// clusters staged in buf ([row][quad of the step]), each triangle against
// the lane's R rays (FMA body); slots at or past count are skipped. A hit
// closer than ct[k] takes (ct[k], cs[k]) with its t and its slot. odd:
// see rcp_in_range (lab_common.cuh).
template <int R, bool kExact>
__device__ __forceinline__ void walk_step(const float4* buf, int count, int s,
                                          int warp, const Ray (&r)[R],
                                          float (&ct)[R], int (&cs)[R],
                                          bool& odd) {
#pragma unroll 1
  for (int q = warp; q < kStepQuads; q += kWarps) {
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

// Warp w's share of step s from the best (bt, bs): its first smallest hits
// below it in (ct, cs), the share redone with __frcp_rn where the warp met
// an odd denominator.
template <int R>
__device__ __forceinline__ void test_step(const float4* buf, int count, int s,
                                          int warp, const Ray (&r)[R],
                                          const float (&bt)[R],
                                          const int (&bs)[R], float (&ct)[R],
                                          int (&cs)[R]) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    ct[k] = bt[k];
    cs[k] = bs[k];
  }
  bool odd = false;  // a den outside rcp_in_range's range
  walk_step<R, false>(buf, count, s, warp, r, ct, cs, odd);
  if (__any_sync(kFull, odd)) {  // the warp's share again, __frcp_rn
#pragma unroll
    for (int k = 0; k < R; ++k) {
      ct[k] = bt[k];
      cs[k] = bs[k];
    }
    walk_step<R, true>(buf, count, s, warp, r, ct, cs, odd);
  }
}

// The W warps' bests of the lane's R rays in one combine set ([warp][ray]
// of t in tc, of slots in sc): smallest t, then smallest slot.
template <int R>
__device__ __forceinline__ void combine(const float* tc, const int* sc,
                                        int lane, float (&bt)[R],
                                        int (&bs)[R]) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    float t = tc[lane + 32 * k];
    int slot = sc[lane + 32 * k];
    for (int w = 1; w < kWarps; ++w) {
      const float ut = tc[w * kTile + lane + 32 * k];
      const int us = sc[w * kTile + lane + 32 * k];
      if (ut < t || (ut == t && us < slot)) {
        t = ut;
        slot = us;
      }
    }
    bt[k] = t;
    bs[k] = slot;
  }
}

// kMode's walk (see the head of this file) of tile blockIdx.x.
template <int kMode, int kLayout, int R>
__global__ void __launch_bounds__(kThreads, 2)
tile_walk_kernel(const int* __restrict__ counts, const int* __restrict__ meta,
                 const float* __restrict__ rays,
                 const float* __restrict__ tris, int n_tiles, int n_clusters,
                 float* __restrict__ out) {
  static_assert(R * 32 == kTile, "a warp holds the tile's rays");
  extern __shared__ float4 smem[];
  float4* ring = smem;  // 2 stages of kStage
  int* mrow = reinterpret_cast<int*>(smem + (kMode >= kK2 ? 2 * kStage : 0));
  float* tcomb = reinterpret_cast<float*>(mrow + (kMode >= kK1 ? kRow : 0));
  int* scomb = reinterpret_cast<int*>(tcomb + combine_sets<kMode>() *
                                                  kWarps * kTile);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tile = blockIdx.x;
  const size_t n_rays = static_cast<size_t>(n_tiles) * kTile;
  Ray r[R];
  float bt[R];
  int bs[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    float tmax;
    load_ray<kLayout>(rays, n_rays, tile, lane + 32 * k, r[k], tmax);
    bt[k] = tmax > kBig ? kBig : tmax;  // jnp.minimum keeps a NaN
    bs[k] = -1;
  }
  int id = -1;  // k0-k2's id

  if constexpr (kMode >= kK1) {
    // the tile's meta row into shared memory, 16 bytes a copy
    const int* src = meta + static_cast<size_t>(tile) * kRow;
    for (int e = threadIdx.x; e < kRow / 4; e += kThreads)
      cp_async16(mrow + 4 * e, src + 4 * e);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  if constexpr (kMode == kK1) id = mrow[0];

  if constexpr (kMode >= kK2) {
    const int count = counts[tile];
    const int steps = (count + kKB - 1) / kKB;
    const float4* t4 = reinterpret_cast<const float4*>(tris);
    // step s's 8 clusters into stage s & 1 ([row][cluster][quad]), one
    // cp.async group a thread
    auto stage = [&](int s) {
      float4* dst = ring + (s & 1) * kStage;
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
    int s = 0;
    for (; s < steps; ++s) {
      cp_async_wait<0>();
      // step s's rows are in for every thread, and every warp is done
      // with step s - 1 (its stage, which stage(s + 1) overwrites)
      __syncthreads();
      if (kMode == kExit && s > 0) {  // the vote on step s - 1's bests
        const int par = (s - 1) & 1;
        combine<R>(tcomb + par * kWarps * kTile, scomb + par * kWarps * kTile,
                   lane, bt, bs);
        const int nk = mrow[kCpad + min(s * kKB, kCpad - 1)];
        bool done = true;
#pragma unroll
        for (int k = 0; k < R; ++k) done &= __float_as_int(bt[k]) <= nk;
        if (__all_sync(kFull, done)) break;  // every warp votes alike
      }
      if (s + 1 < steps) stage(s + 1);
      const float4* buf = ring + (s & 1) * kStage;
      if constexpr (kMode == kK2) {
        acc = acc + reinterpret_cast<const float*>(buf)[0];
      } else {
        float ct[R];
        int cs[R];
        test_step<R>(buf, count, s, warp, r, bt, bs, ct, cs);
#pragma unroll
        for (int k = 0; k < R; ++k) {
          if constexpr (kMode == kExit) {  // to the combine; bt stays
            const int at = ((s & 1) * kWarps + warp) * kTile + lane + 32 * k;
            tcomb[at] = ct[k];
            scomb[at] = cs[k];
          } else {  // k3: the warp's own running best
            bt[k] = ct[k];
            bs[k] = cs[k];
          }
        }
      }
    }
    if constexpr (kMode == kK2) {
      if (steps > 0) {  // no step: k1's t
#pragma unroll
        for (int k = 0; k < R; ++k) bt[k] = acc;
      }
    }
    // the warps' bests after the last step (k3: after the walk); an exit
    // combined them already
    if (kMode >= kK3 && steps > 0 && s == steps) {
      const int par = kMode == kExit ? (steps - 1) & 1 : 0;
      if (kMode == kK3) {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          tcomb[warp * kTile + lane + 32 * k] = bt[k];
          scomb[warp * kTile + lane + 32 * k] = bs[k];
        }
      }
      __syncthreads();
      combine<R>(tcomb + par * kWarps * kTile, scomb + par * kWarps * kTile,
                 lane, bt, bs);
    }
  }

  if (warp != 0) return;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    int idk = id;
    if (kMode >= kK3 && bs[k] >= 0) {
      const int m = mrow[min(bs[k] / kCluster, kCpad - 1)];
      idk = max(0, min(m, n_clusters - 1)) * kCluster + bs[k] % kCluster;
    }
    store_out<kLayout>(out, n_rays, tile, lane + 32 * k, bt[k], idk);
  }
}

template <int kMode, int kLayout>
int launch(const int* counts, const int* meta, const float* rays,
           const float* tris, int n_tiles, int n_clusters, float* out,
           cudaStream_t st) {
  constexpr size_t smem = smem_bytes<kMode>();
  const auto kernel = tile_walk_kernel<kMode, kLayout, kRays>;
  if (smem > 48 * 1024) {
    // once per instance: a host call that would sit in every launch
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  kernel<<<n_tiles, kThreads, smem, st>>>(counts, meta, rays, tris, n_tiles,
                                          n_clusters, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kernel 0-3: L1's k0-k3, rays (8, n_tiles * 128) f32 columns [o | d |
// t_min | t_max], out (2, n_tiles * 128) f32 [t | id bits], group 1;
// kernel 4: L2's k4, rays (n_tiles, 8, 128) planes, out (n_tiles, 2, 128);
// kernel 5: L3's k5, rays (n_tiles, 128, 8) rows, out (n_tiles, 128, 2).
// counts (n_tiles,) i32, meta (n_tiles x 3,072,) i32, tris (n_clusters, 9,
// 1, 128) f32; group (the script's tiles a grid step) divides n_tiles and
// is checked, but every kernel walks one tile a block. Returns the CUDA
// error of the launch (0 on success).
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
#define TILE_ARGS counts, meta, rays, tris, n_tiles, n_clusters, out, st
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
      return launch<kExit, kPlanes>(TILE_ARGS);
    case 5:
      return launch<kExit, kRayRows>(TILE_ARGS);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TILE_ARGS
}
