// The four labs that take K1 (_kernel_vm3) apart, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of tauray_tpu's TPU lab scripts:
//   * L8, scripts/kernel_lab8.py make_kernel (pallas_call :105): a tile's
//     fixed cost with no triangle work, modes 0-3 (writes; + ray loads;
//     + the copy of a group's key heads; + a loop of ceil(count / 8)
//     steps over the heads);
//   * L9, scripts/kernel_lab9.py make_kernel (:189): one Baldwin-Weber
//     step of 8 clusters bisected: full, exit (a tile-level exit vote),
//     loads (the rows summed, no test), math (cluster 0's rows for every
//     order: no copy in the loop), nocat (8 per-cluster minima);
//   * L10, scripts/kernel_lab10.py make_kernel (:193): K1's walk stripped
//     on a sorted wave: full, noray (constant rays), fixord (orders 0..7
//     every step), nowrite (only each group's last best is written);
//   * L11, scripts/kernel_lab11.py _kernel (:139): the Baldwin-Weber test
//     over a synthetic stream, as K1's FP32 step (vpu) or as six matrix
//     products on the tensor cores (mxu).
// It computes the scripts' functions, not their TPU schedules:
//   * L8 (redesigned for this card as a streaming kernel): a warp a tile,
//     8 tiles a block (mode 0, writes only, 32); each lane issues 16-byte
//     cp.async copies of the tile's rows into the warp's shared memory,
//     neighbouring lanes on neighbouring addresses, the heads' first (mode
//     2-3), then o3, d3 and mm2, waits once, and reads its ray from there
//     (t_max once). PR 11's first design took the TPU's group of 32 tiles
//     as one block of 1,024 threads, copied the group's heads and waited
//     before any ray load, and read each ray as 7 scalar loads at a
//     12-byte stride and t_max again;
//   * L11 vpu (redesigned for this card, on L9's plan): a warp per tile (4
//     a block), R = 4 rays a lane, 4 workers of 8 lanes, worker w taking the
//     quads w, w + 4, ... of each cluster (test_quads, the FMA body); the
//     walk's clusters pass through L9's ring of two 6 KB stages a warp
//     (stage_async); running bests from 3e38, combined by (t, slot) after
//     the walk (lab11_vpu_kernel);
//   * L9 (redesigned for this card): a warp per tile (4 a block), R = 4 rays a
//     lane. The warp's 32 lanes are 4 workers of 8 lanes over the tile's
//     32 rays (lane l holds rays l % 8 + 8k, k < 4) and worker w takes the
//     quads w, w + 4, ... of each cluster, so each 16-byte row load serves
//     4 triangles x 4 rays and the loop and address steps are shared by
//     16 tests. The walk's clusters pass through a ring of two 6 KB stages
//     a warp (48 KB a block): cluster g + 1 is copied (one cp.async group)
//     while cluster g is tested. "full" starts each worker's candidate at
//     the best from before the step (one compare, tt < ct, for the two of
//     the unfused version) and combines the workers by smallest t, then
//     smallest slot, after the step; "nocat" combines after every cluster
//     (8 per-cluster minima); both return the same t and id.
//   * L10 (redesigned for this card, on L9's plan): a warp per tile (4 a
//     block), R = 4 rays a lane, 4 workers of 8 lanes, worker w taking the
//     quads w, w + 4, ... of each cluster; the walk's clusters (the tile's
//     keys, read 32 at a time and shuffled, or fixord's orders) pass
//     through the same ring of two 6 KB stages a warp, cluster g + 1
//     copied while cluster g is tested. Each worker keeps a running best
//     of its own (FMA body, one compare) over the walk, and the workers
//     meet by smallest t, then smallest slot (the walk's position x 128 +
//     the triangle's lane), never by id: fixord repeats clusters. A
//     cluster whose test met an odd denominator is tested again, from the
//     staged rows, with __frcp_rn. The tiles are walked in the order the
//     wrapper gives, most clusters first: a sorted wave's tiles walk 1 to
//     ~250 clusters, and in index order the card ended on its longest
//     walks alone (a warp a block instead of 4 ran 2% slower, so it is
//     not the block's idle warps);
//   * L11 mxu (redesigned for this card): per 8-triangle column block and
//     16-ray row block, the six products o4 @ [v | -v.v0] (K = 4) and d4 @
//     [v | -v.v0] with d4's fourth column 0 (so K = 3 in effect) for v = n,
//     r1, r2, each as mma.sync.aligned.m16n8k4 in TF32 split in two (x =
//     hi + lo): lo.hi + hi.lo + hi.hi, which brings each product near FP32
//     accuracy (m16n8k8 over [o4 | d4], the same count of products at
//     twice the K, ran 1.34x slower in turns on the H100, app/lab_bench.py
//     against a build of it);
//     each lane splits the B values it reads once a cluster (48: no two
//     lanes read the same), from a two-stage ring of padded stages that
//     copies cluster j + 1 while cluster j is tested; the epilogue runs on
//     the CUDA cores in FMAs (t = -(n.o - n.v0) rcp(n.d), u, v), with
//     rcp_in_range and a cluster redone with __frcp_rn where the warp met
//     an odd denominator, each hit held against the lane's running best by
//     one compare; each lane holds 4 rays x 2 triangles of a block, and the
//     4 lanes of a row group meet by (t, position) after the walk.
// The results are the scripts' raw (n_tiles, 32, 2) f32 blocks: t, then
// the slot id's int32 bits (-1 on a miss; t is then the starting best,
// min(t_max, 3e38), not +inf).
//
// What bounds it on the card: L8 moves bytes only (at most 56 bytes a ray and
// 516 a tile: the write, the ray loads, the heads, the count); L9-L11 are
// bound by the FP32 instruction rate as K1 is (32 FP32 operations a
// Baldwin-Weber test), L11 mxu by 3 x 42 TF32 operations a test on the tensor
// cores plus its FP32 epilogue. The tables (13 MB and 6.3 MB) stay in the 50
// MB L2. L9's test loop took 63.25 SASS instructions a test before the
// redesign (one ray a lane, unfused, __frcp_rn's range test and branch in
// every test) and 32.06 after it (phase 2 of chip_smoke.py): the FMA body
// (bw_hit_fma: 17 FP32 instructions, not 31), 16 tests a load, loop and
// address step, and __frcp_rn's in-range fast path alone. R = 4, not 2: 4-8%
// faster on the H100 at 128 registers, no spill (app/lab_bench.py against an R
// = 2 build); the ring keeps the copies off the test loop's path now that the
// loop is short (full within 2% of math, which copies nothing). The reciprocal
// stays correctly rounded: t must differ from the unfused version's only by
// the FMAs' roundings, so that the tie-aware hold can bound it; a step whose
// warp met a subnormal denominator or one of at least 2^126 is redone with
// __frcp_rn. L10 takes the same body, split and ring (K1, whose walk it
// strips, takes 63.75 SASS instructions a test).
//
// Built with -fmad=false (trace_kernel.NVCC_FLAGS): L8 and L9 loads round
// exactly like their plain torch versions in lab/kernel_lab*.py (t and ids
// bit for bit). L9's other modes, L10 and L11 vpu take the FMA body and are
// held by kernel_lab9.lab9_agreement, kernel_lab10.lab10_agreement and
// kernel_lab11.vpu_agreement, L11 mxu by kernel_lab11.mxu_agreement.

#include <cuda_runtime.h>

#include "lab_common.cuh"

namespace {

constexpr int kCluster = 128;  // triangles per cluster
constexpr int kTile = 32;      // rays per tile = lanes per warp
constexpr int kRows = 12;      // floats per triangle (both layouts)
constexpr int kQuads = kCluster / 4;
constexpr int kBuf = kRows * kQuads;  // float4 of one staged cluster
constexpr int kStep = 8;       // clusters per step
constexpr int kGroup = 32;     // tiles per group
constexpr int kHeads = 128;    // key-head lanes per tile
// L8: tiles (warps) a block, chosen by measurement in turns on the H100
// (app/lab_bench.py, NVIDIA H100 80GB HBM3 at 700 W, by CUDA-graph
// replay): modes 1-3 8 (4 and 16 within 1%), mode 0, which only writes, 32
// (PR 11's group; 8 ran 5% behind it)
constexpr int kTiles8 = 8;
constexpr int kTiles8Write = 32;
constexpr int kWarpsPerBlock = 4;  // L9 and L11: tiles per block
constexpr int kRays9 = 4;      // L9, L10: rays a lane (R), workers a warp
constexpr int kTiles10 = 4;    // L10: tiles (warps) a block
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;
// L11 mxu: a staged row of 128 floats takes 136, so that the four rows a
// B fragment reads (k = 0..3) fall on different banks
constexpr int kPadRow = 34;    // float4 per padded row

// The smaller of a and b with a NaN kept (jnp.minimum / torch.minimum).
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}

// L9 "loads": the smallest over the staged cluster's 128 triangles of
// 0 + row 0 + ... + row 11 (kernel_lab9.py:113-114), every lane alike.
__device__ __forceinline__ float row_sum_min(const float4* buf, float m) {
  for (int q = 0; q < kQuads; ++q) {
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 v = buf[i * kQuads + q];
      s.x = s.x + v.x;
      s.y = s.y + v.y;
      s.z = s.z + v.z;
      s.w = s.w + v.w;
    }
    m = nan_min(nan_min(nan_min(nan_min(m, s.x), s.y), s.z), s.w);
  }
  return m;
}

// ---------------------------------------------------------------------------
// L8: a tile's fixed cost
// ---------------------------------------------------------------------------

// A warp a tile, kTiles tiles a block (no group of 32 but for mode 0): lane
// l copies the tile's rows into the warp's own shared memory as 16-byte
// cp.async copies, neighbouring lanes on neighbouring addresses, the heads'
// row first (modes 2-3: 512 bytes, one copy a lane), then o3's and d3's 384
// bytes (24 copies each) and mm2's 256 (16), and waits once; then ray l's
// o, d and [t_min | t_max] are read from there (t_max once), summed in the
// script's order and written as one float2. Mode 0 writes only.
template <int kMode, int kTiles>
__global__ void __launch_bounds__(kTiles * kTile)
lab8_kernel(const int* __restrict__ counts, const int* __restrict__ heads,
            const float* __restrict__ o3, const float* __restrict__ d3,
            const float* __restrict__ mm2, int n_tiles,
            float* __restrict__ out) {
  // a tile's rows: o3 float4 0-23, d3 24-47, mm2 48-63, heads 64-95
  __shared__ float4 rows[kMode == 0 ? 1 : kTiles][96];
  const int warp = threadIdx.x / kTile;
  const int lane = threadIdx.x % kTile;
  const int tile = blockIdx.x * kTiles + warp;
  if (tile >= n_tiles) return;
  float2* o2 = reinterpret_cast<float2*>(out) +
               static_cast<size_t>(tile) * kTile + lane;
  if (kMode == 0) {
    *o2 = make_float2(1.0f, 2.0f);
    return;
  }
  float4* r = rows[warp];
  const size_t t = static_cast<size_t>(tile);
  if (kMode >= 2)
    cp_async16(r + 64 + lane,
               reinterpret_cast<const float4*>(heads) + t * 32 + lane);
  if (lane < 24) {
    cp_async16(r + lane, reinterpret_cast<const float4*>(o3) + t * 24 + lane);
    cp_async16(r + 24 + lane,
               reinterpret_cast<const float4*>(d3) + t * 24 + lane);
  }
  if (lane < 16)
    cp_async16(r + 48 + lane,
               reinterpret_cast<const float4*>(mm2) + t * 16 + lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();  // the tile's rows are in for every lane
  const float* o = reinterpret_cast<const float*>(r) + 3 * lane;
  const float* d = reinterpret_cast<const float*>(r + 24) + 3 * lane;
  const float2 mm = reinterpret_cast<const float2*>(r + 48)[lane];
  float acc = o[0] + o[1] + o[2] + d[0] + d[1] + d[2] + mm.x;
  if (kMode == 3) {
    const int* hs = reinterpret_cast<const int*>(r + 64);
    const int steps = (counts[tile] + kStep - 1) / kStep;
    float acc2 = 0.0f;
    for (int s = 0; s < steps; ++s)
      acc2 = acc2 + static_cast<float>(hs[min(s, kHeads - 1)]);
    acc = acc + acc2;
  }
  *o2 = make_float2(acc, mm.y);
}

// ---------------------------------------------------------------------------
// L9: one Baldwin-Weber step bisected, redesigned for this card
// ---------------------------------------------------------------------------

enum Lab9Mode { kFull9 = 0, kExit9 = 1, kLoads9 = 2, kMath9 = 3, kNocat9 = 4 };

// Issues the copy of cluster c's 12 x 512 bytes into buf as one cp.async
// group of 12 16-byte copies a lane (a row every kStride float4 of buf:
// L11 mxu's padded rows take kPadRow), and does not wait for it.
template <int kStride = kQuads>
__device__ __forceinline__ void stage_async(float4* buf, const float* tris,
                                            int c, int lane) {
  cp_async_rows<kRows, kStride>(
      buf,
      reinterpret_cast<const float4*>(tris +
                                      static_cast<size_t>(c) * kRows *
                                          kCluster),
      lane);
}

// Worker wk's share of a cluster's rows (staged, or the table's in place:
// one layout), quads wk, wk + R, ..., each triangle against the lane's R
// rays (FMA body): a hit closer than ct[k] takes (ct[k], cs[k]) with its t
// and its slot, slot0 + its lane in the cluster, so a worker keeps the
// first smallest in its slot order. odd: see bw_hit_fma.
template <int R, bool kExact>
__device__ __forceinline__ void test_quads(const float4* buf, int slot0,
                                           int wk, const Ray (&r)[R],
                                           float (&ct)[R], int (&cs)[R],
                                           bool& odd) {
#pragma unroll 1
  for (int q = wk; q < kQuads; q += R) {
    const float4* b = buf + q;
    float4 v[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) v[i] = b[i * kQuads];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float w[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) w[i] = comp(v[i], c);
      const int slot = slot0 + 4 * q + c;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        float tt;
        if (bw_hit_fma<kExact>(r[k], w, ct[k], tt, odd)) {
          ct[k] = tt;
          cs[k] = slot;
        }
      }
    }
  }
}

// A warp walks a tile of 32 rays, R rays a lane: lane l is lane l % (32 /
// R) of worker l / (32 / R) and holds rays l % (32 / R) + k (32 / R), k <
// R. The walk's clusters (step s, slot j: the (8s + j)-th) pass through a
// ring of two 6 KB stages: cluster g + 1 is copied while cluster g is
// tested. Modes: full (each step's candidates start at the best from
// before the step; the workers' bests combined after the step), nocat
// (combined after every cluster: 8 per-cluster minima), math (cluster 0
// staged once, tested for every order), exit (full, then the warp's vote),
// loads (the rows summed, unfused, every lane alike; no test).
template <int kMode, int R>
__global__ void __launch_bounds__(kWarpsPerBlock * kTile)
lab9_kernel(const int* __restrict__ counts, const int* __restrict__ heads,
            const float* __restrict__ o3, const float* __restrict__ d3,
            const float* __restrict__ mm2, const float* __restrict__ tris,
            int n_tiles, int n_clusters, float* __restrict__ out) {
  constexpr int kLanes = kTile / R;  // lanes a worker
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x / kTile;
  const int lane = threadIdx.x % kTile;
  const int tile = blockIdx.x * kWarpsPerBlock + warp;
  if (tile >= n_tiles) return;
  float4* ring = smem + warp * 2 * kBuf;
  const int wk = lane / kLanes;
  Ray r[R];
  float bt[R];
  int bi[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const size_t ray = static_cast<size_t>(tile) * kTile + lane % kLanes +
                       k * kLanes;
    r[k] = Ray{o3[ray * 3], o3[ray * 3 + 1], o3[ray * 3 + 2], d3[ray * 3],
               d3[ray * 3 + 1], d3[ray * 3 + 2], mm2[ray * 2]};
    const float tmax = mm2[ray * 2 + 1];
    bt[k] = tmax > kBig ? kBig : tmax;  // jnp.minimum keeps a NaN
    bi[k] = -1;
  }
  const int* hrow = heads + static_cast<size_t>(tile) * kHeads;
  const int steps = (counts[tile] + kStep - 1) / kStep;
  const int n = steps * kStep;  // clusters of the walk
  if (n > 0)
    stage_async(ring, tris,
                kMode == kMath9 ? 0 : min(hrow[0] & 1023, n_clusters - 1),
                lane);
  for (int step = 0; step < steps; ++step) {
    // lane j < 8: the order of the step's slot j; lane 8: the next step's
    // first key (the next step's first cluster, the exit's bound)
    const int key = hrow[min(step * kStep + lane, kHeads - 1)];
    const int orders = min(key & 1023, n_clusters - 1);
    float ct[R];
    int cs[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      ct[k] = bt[k];
      cs[k] = -1;
    }
    float m = __int_as_float(0x7f800000);
    bool odd = false;  // a den outside rcp_in_range's range
    for (int j = 0; j < kStep; ++j) {
      const int g = step * kStep + j;
      const float4* buf = ring;
      if (kMode == kMath9) {
        if (g == 0) cp_async_wait<0>();
      } else {
        if (g + 1 < n) {
          stage_async(ring + ((g + 1) & 1) * kBuf, tris,
                      __shfl_sync(kFull, orders, j + 1), lane);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        buf = ring + (g & 1) * kBuf;
      }
      __syncwarp();  // cluster g's rows are in for every lane
      if (kMode == kLoads9) {
        m = row_sum_min(buf, m);
      } else {
        test_quads<R, false>(buf, j * kCluster, wk, r, ct, cs, odd);
        if (kMode == kNocat9) {
#pragma unroll
          for (int k = 0; k < R; ++k) workers_best(ct[k], cs[k], kLanes);
        }
      }
      if (kMode != kMath9) __syncwarp();  // every lane is done with buf
    }
    if (kMode != kLoads9 && __any_sync(kFull, odd)) {
      // the step again with __frcp_rn, the rows read in place
#pragma unroll
      for (int k = 0; k < R; ++k) {
        ct[k] = bt[k];
        cs[k] = -1;
      }
      for (int j = 0; j < kStep; ++j) {
        const int c = kMode == kMath9 ? 0 : __shfl_sync(kFull, orders, j);
        test_quads<R, true>(reinterpret_cast<const float4*>(tris) +
                                static_cast<size_t>(c) * kBuf,
                            j * kCluster, wk, r, ct, cs, odd);
      }
    }
    if (kMode == kLoads9) {
#pragma unroll
      for (int k = 0; k < R; ++k) bt[k] = nan_min(bt[k], m);
    } else {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        // (nocat combined after each cluster; again here for a redone step)
        workers_best(ct[k], cs[k], kLanes);
        const int win = __shfl_sync(kFull, orders,
                                    cs[k] < 0 ? 0 : cs[k] / kCluster);
        if (cs[k] >= 0) {
          bt[k] = ct[k];
          bi[k] = win * kCluster + cs[k] % kCluster;
        }
      }
    }
    if (kMode == kExit9) {
      const int next = __shfl_sync(kFull, key, kStep) & ~1023;
      bool done = true;
#pragma unroll
      for (int k = 0; k < R; ++k) done &= __float_as_int(bt[k]) <= next;
      if (__all_sync(kFull, done)) break;
    }
  }
  cp_async_wait<0>();  // no copy outlives the warp (exit's last prefetch)
  if (wk != 0) return;
#pragma unroll
  for (int k = 0; k < R; ++k)
    reinterpret_cast<float2*>(out)[static_cast<size_t>(tile) * kTile + lane +
                                   k * kLanes] =
        make_float2(bt[k], __int_as_float(bi[k]));
}

// ---------------------------------------------------------------------------
// L10: K1's walk stripped
// ---------------------------------------------------------------------------

enum Lab10Mode { kFull10 = 0, kNoray10 = 1, kFixord10 = 2, kNowrite10 = 3 };

// A warp walks a tile of 32 rays of a sorted wave, R rays a lane (as L9:
// lane l is lane l % (32 / R) of worker l / (32 / R), rays l % (32 / R) +
// k (32 / R)). The tiles are taken in `order`, longest walk first, so that
// the longest walks start first and the short ones fill the card's tail.
// A tile's count clusters, in key order (fixord: g % 8 at walk position
// g), pass through the ring of two stages: cluster g + 1 is copied while
// cluster g is tested. Each worker keeps its own running best over the
// walk from the pre-set best (noray: 1e30 where count > 0), slot = g * 128
// + the triangle's lane; the workers meet after the walk.
template <int kMode, int R>
__global__ void __launch_bounds__(kTiles10 * kTile, 16 / kTiles10)
lab10_kernel(const int* __restrict__ counts, const int* __restrict__ keys,
             int key_stride, const float* __restrict__ rays8,
             const float* __restrict__ tris, int n_tiles, int n_clusters,
             int idmask, const int* __restrict__ order,
             float* __restrict__ out) {
  constexpr int kLanes = kTile / R;  // lanes a worker
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x / kTile;
  const int lane = threadIdx.x % kTile;
  if (blockIdx.x * kTiles10 + warp >= n_tiles) return;
  const int tile = order[blockIdx.x * kTiles10 + warp];
  float4* ring = smem + warp * 2 * kBuf;
  const int wk = lane / kLanes;
  const int count = counts[tile];
  const float4* r4 = reinterpret_cast<const float4*>(rays8);
  Ray r[R];
  float pre[R], bt[R];
  int bs[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const size_t ray = static_cast<size_t>(tile) * kTile + lane % kLanes +
                       k * kLanes;
    const float4 a = r4[ray * 2];
    const float4 b = r4[ray * 2 + 1];
    r[k] = kMode == kNoray10 ? Ray{0.1f, 0.2f, 0.3f, 0.4f, 0.5f, 0.6f, 0.0f}
                             : Ray{a.x, a.y, a.z, a.w, b.x, b.y, b.z};
    pre[k] = b.w > kBig ? kBig : b.w;  // min(t_max, 3e38), NaN kept
    bt[k] = kMode == kNoray10 && count > 0 ? 1e30f : pre[k];
    bs[k] = -1;
  }
  const int* krow = keys + static_cast<size_t>(tile) * key_stride;
  // the cluster at walk position g, asked for g = 0, 1, ... in turn: the
  // keys a warp-load of 32 at a time, shuffled
  int kc = 0;
  auto cluster = [&](int g) {
    if (kMode == kFixord10) return g % kStep;
    if ((g & 31) == 0)
      kc = g + lane < count ? min(krow[g + lane] & idmask, n_clusters - 1)
                            : 0;
    return __shfl_sync(kFull, kc, g & 31);
  };
  if (count > 0) stage_async(ring, tris, cluster(0), lane);
  for (int g = 0; g < count; ++g) {
    if (g + 1 < count) {
      stage_async(ring + ((g + 1) & 1) * kBuf, tris, cluster(g + 1), lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // cluster g's rows are in for every lane
    const float4* buf = ring + (g & 1) * kBuf;
    float st[R];
    int ss[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      st[k] = bt[k];
      ss[k] = bs[k];
    }
    bool odd = false;  // a den outside rcp_in_range's range
    test_quads<R, false>(buf, g * kCluster, wk, r, bt, bs, odd);
    if (__any_sync(kFull, odd)) {  // the cluster again with __frcp_rn
#pragma unroll
      for (int k = 0; k < R; ++k) {
        bt[k] = st[k];
        bs[k] = ss[k];
      }
      test_quads<R, true>(buf, g * kCluster, wk, r, bt, bs, odd);
    }
    __syncwarp();  // every lane is done with buf
  }
  int id[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    workers_best(bt[k], bs[k], kLanes);
    const int g = bs[k] / kCluster;
    id[k] = bs[k] < 0 ? -1
                      : (kMode == kFixord10
                             ? g % kStep
                             : min(krow[g] & idmask, n_clusters - 1)) *
                                kCluster +
                            bs[k] % kCluster;
  }
  float2* o2 = reinterpret_cast<float2*>(out);
  if (kMode != kNowrite10) {
    if (wk != 0) return;
#pragma unroll
    for (int k = 0; k < R; ++k)
      o2[static_cast<size_t>(tile) * kTile + lane + k * kLanes] =
          make_float2(bt[k], __int_as_float(id[k]));
    return;
  }
  // nowrite: every tile keeps its pre-set (t_max, -1); tile 0 of each
  // group of 32 takes the t of the group's last tile with a cluster (the
  // TPU walk's final best), or 0 with none
  const int group = tile / kGroup;
  const int gi = tile % kGroup;
  const unsigned act = __ballot_sync(
      kFull, counts[static_cast<size_t>(group) * kGroup + lane] > 0);
  const int last = act ? 31 - __clz(act) : -1;
  if (wk != 0) return;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int rr = lane + k * kLanes;  // the ray's lane in the tile
    const size_t ray = static_cast<size_t>(tile) * kTile + rr;
    if (gi == 0 && last > 0) {
      out[ray * 2 + 1] = __int_as_float(-1);  // the last active tile writes t
      continue;
    }
    o2[ray] = make_float2(gi == 0 ? (last < 0 ? 0.0f : bt[k]) : pre[k],
                          __int_as_float(-1));
    if (gi == last && gi > 0)
      out[(static_cast<size_t>(group) * kGroup * kTile + rr) * 2] = bt[k];
  }
}

// ---------------------------------------------------------------------------
// L11: the Baldwin-Weber test as FP32 vector work or as matrix products
// ---------------------------------------------------------------------------

// L11 vpu, on L9's plan: a warp walks a tile of 32 rays, R rays a lane
// (lane l is lane l % (32 / R) of worker l / (32 / R), rays l % (32 / R) +
// k (32 / R)). The walk's clusters, position g = 8i + j (step i, slot j)
// naming cluster (g + tile) mod C, pass through the ring of two stages:
// cluster g + 1 is copied while cluster g is tested. Each worker keeps a
// running best from 3e38 (FMA body, one compare), slot g * 128 + the
// triangle's lane; a cluster whose test met an odd denominator is tested
// again, from its stage, with __frcp_rn; the workers meet by smallest t,
// then smallest slot, after the walk, and only then is the slot mapped to
// cluster x 128 + lane.
template <int R>
__global__ void __launch_bounds__(kWarpsPerBlock * kTile)
lab11_vpu_kernel(const int* __restrict__ steps, const float* __restrict__ rays,
                 const float* __restrict__ tris, int n_tiles, int n_clusters,
                 float* __restrict__ out) {
  constexpr int kLanes = kTile / R;  // lanes a worker
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x / kTile;
  const int lane = threadIdx.x % kTile;
  const int tile = blockIdx.x * kWarpsPerBlock + warp;
  if (tile >= n_tiles) return;
  float4* ring = smem + warp * 2 * kBuf;
  const int wk = lane / kLanes;
  const float4* r4 = reinterpret_cast<const float4*>(rays);
  Ray r[R];
  float bt[R];
  int bs[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const size_t ray = static_cast<size_t>(tile) * kTile + lane % kLanes +
                       k * kLanes;
    const float4 a = r4[ray * 2];
    const float4 b = r4[ray * 2 + 1];
    r[k] = Ray{a.x, a.y, a.z, a.w, b.x, b.y, b.z};
    bt[k] = kBig;
    bs[k] = -1;
  }
  const int n = steps[tile] * kStep;  // clusters of the walk
  if (n > 0) stage_async(ring, tris, tile % n_clusters, lane);
  for (int g = 0; g < n; ++g) {
    if (g + 1 < n) {
      stage_async(ring + ((g + 1) & 1) * kBuf, tris,
                  (g + 1 + tile) % n_clusters, lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // cluster g's rows are in for every lane
    const float4* buf = ring + (g & 1) * kBuf;
    float st[R];
    int ss[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      st[k] = bt[k];
      ss[k] = bs[k];
    }
    bool odd = false;  // a den outside rcp_in_range's range
    test_quads<R, false>(buf, g * kCluster, wk, r, bt, bs, odd);
    if (__any_sync(kFull, odd)) {  // the cluster again with __frcp_rn
#pragma unroll
      for (int k = 0; k < R; ++k) {
        bt[k] = st[k];
        bs[k] = ss[k];
      }
      test_quads<R, true>(buf, g * kCluster, wk, r, bt, bs, odd);
    }
    __syncwarp();  // every lane is done with buf
  }
#pragma unroll
  for (int k = 0; k < R; ++k) workers_best(bt[k], bs[k], kLanes);
  if (wk != 0) return;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int id = bs[k] < 0 ? -1
                             : (bs[k] / kCluster + tile) % n_clusters *
                                       kCluster +
                                   bs[k] % kCluster;
    reinterpret_cast<float2*>(out)[static_cast<size_t>(tile) * kTile + lane +
                                   k * kLanes] =
        make_float2(bt[k], __int_as_float(id));
  }
}

// L11 mxu: one staged cluster (fbuf, padded rows) against the lane's 4
// rays, its 16 blocks of 8 triangles in order; the epilogue in FMAs with
// rcp_in_range (odd: see it), a hit taking (ct[m], cp[m]) with its walk
// position pos0 + the triangle's lane when closer than ct[m].
template <bool kExact>
__device__ __forceinline__ void mxu_cluster(const float* fbuf, int pos0,
                                            int g, int k,
                                            const Split (&ao)[4],
                                            const Split (&ad)[4],
                                            const float (&tmin)[4],
                                            float (&ct)[4], int (&cp)[4],
                                            bool& odd) {
#pragma unroll 1
  for (int nb = 0; nb < kCluster / 8; ++nb) {
    // B fragment of type v: row k, column (triangle) nb * 8 + g
    Split bv[3];
#pragma unroll
    for (int v = 0; v < 3; ++v)
      bv[v] = split(fbuf[(v * 4 + k) * kPadRow * 4 + nb * 8 + g]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rays 16h + (g, g + 8)
      const Split &o0 = ao[2 * h], &o1 = ao[2 * h + 1];
      const Split &d0 = ad[2 * h], &d1 = ad[2 * h + 1];
      float on[4], or1[4], or2[4], dn[4], dr1[4], dr2[4];
      mma_3xtf32(on, o0, o1, bv[0]);
      mma_3xtf32(or1, o0, o1, bv[1]);
      mma_3xtf32(or2, o0, o1, bv[2]);
      mma_3xtf32(dn, d0, d1, bv[0]);
      mma_3xtf32(dr1, d0, d1, bv[1]);
      mma_3xtf32(dr2, d0, d1, bv[2]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // element e: ray 16h + g + 8 (e / 2), triangle nb*8 + 2k + e%2
        const int m = 2 * h + e / 2;
        const float tt = -on[e] * rcp_rn<kExact>(dn[e], odd);
        const float uu = __fmaf_rn(tt, dr1[e], or1[e]);
        const float vv = __fmaf_rn(tt, dr2[e], or2[e]);
        if (uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt >= tmin[m] &&
            tt < ct[m]) {
          ct[m] = tt;
          cp[m] = pos0 + nb * 8 + 2 * k + e % 2;
        }
      }
    }
  }
}

// One warp per tile. Lane l is row group g = l / 4 and column k = l % 4 of
// the mma fragments: it holds rays g, g + 8, g + 16, g + 24 (m = 0..3) of
// the A operands and, of each 8-triangle block, triangles 2k and 2k + 1.
// The walk's clusters (position w = 8i + j: cluster (w + tile) mod C) pass
// through a ring of two padded 6.4 KB stages a warp, cluster w + 1 copied
// while cluster w is tested; each lane keeps a running best from 3e38 per
// ray, position w * 128 + the triangle's lane, a cluster redone with
// __frcp_rn where the warp met an odd denominator; after the walk the 4
// lanes of a row group meet by smallest t, then smallest position, and
// the position is mapped to cluster x 128 + lane.
__global__ void __launch_bounds__(kWarpsPerBlock * kTile)
lab11_mxu_kernel(const int* __restrict__ steps, const float* __restrict__ rays,
                 const float* __restrict__ tris, int n_tiles, int n_clusters,
                 float* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x / kTile;
  const int lane = threadIdx.x % kTile;
  const int tile = blockIdx.x * kWarpsPerBlock + warp;
  if (tile >= n_tiles) return;
  constexpr int kStage = kRows * kPadRow;  // float4 of a padded stage
  float4* ring = smem + warp * 2 * kStage;
  const int g = lane / 4;
  const int k = lane % 4;
  const float* trow = rays + static_cast<size_t>(tile) * kTile * 8;
  // A fragments: o4 = [o | 1] and d4 = [d | 0], row m * 8 + g, column k
  Split ao[4], ad[4];
  float tmin[4], ct[4];
  int cp[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float* rr = trow + (m * 8 + g) * 8;
    ao[m] = split(k < 3 ? rr[k] : 1.0f);
    ad[m] = split(k < 3 ? rr[3 + k] : 0.0f);
    tmin[m] = rr[6];
    ct[m] = kBig;
    cp[m] = -1;
  }
  const int n = steps[tile] * kStep;  // clusters of the walk
  if (n > 0) stage_async<kPadRow>(ring, tris, tile % n_clusters, lane);
  for (int w = 0; w < n; ++w) {
    if (w + 1 < n) {
      stage_async<kPadRow>(ring + ((w + 1) & 1) * kStage, tris,
                           (w + 1 + tile) % n_clusters, lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // cluster w's rows are in for every lane
    const float* fbuf = reinterpret_cast<const float*>(ring + (w & 1) *
                                                                  kStage);
    float st[4];
    int sp[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      st[m] = ct[m];
      sp[m] = cp[m];
    }
    bool odd = false;  // a den outside rcp_in_range's range
    mxu_cluster<false>(fbuf, w * kCluster, g, k, ao, ad, tmin, ct, cp,
                           odd);
    if (__any_sync(kFull, odd)) {  // the cluster again with __frcp_rn
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        ct[m] = st[m];
        cp[m] = sp[m];
      }
      mxu_cluster<true>(fbuf, w * kCluster, g, k, ao, ad, tmin, ct, cp,
                            odd);
    }
    __syncwarp();  // every lane is done with the stage
  }
  // the 4 lanes of a row group hold the same rays: smallest t, then the
  // first position
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      const float ot = __shfl_xor_sync(kFull, ct[m], x);
      const int op = __shfl_xor_sync(kFull, cp[m], x);
      if (ot < ct[m] || (ot == ct[m] && op < cp[m])) {
        ct[m] = ot;
        cp[m] = op;
      }
    }
  }
  if (k == 0) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int id = cp[m] < 0 ? -1
                               : (cp[m] / kCluster + tile) % n_clusters *
                                         kCluster +
                                     cp[m] % kCluster;
      reinterpret_cast<float2*>(out)[static_cast<size_t>(tile) * kTile +
                                     m * 8 + g] =
          make_float2(ct[m], __int_as_float(id));
    }
  }
}

}  // namespace

// lab 8, 9, 10 or 11 in one of its modes (the order of lab_kernel.MODES):
//   8: counts (n_tiles,), keys = heads (n_tiles, 128), rays = o3
//      (n_tiles, 32, 3), d3, mm2 (n_tiles, 32, 2); n_tiles a multiple of 32;
//   9: the same and tris (C, 12, 1, 128);
//  10: counts, keys (n_tiles, key_stride) ascending cluster ids, rays =
//      rays8 (n_tiles, 32, 8), tris (C, 12, 1, 128), idmask, order
//      (n_tiles,) i32, a permutation of the tiles (the order to walk them
//      in); n_tiles a multiple of 32 (warps, the W of L10's earlier design,
//      is read by no kernel here);
//  11: counts = steps (n_tiles,), rays = rays8, tris (C, 12, 1, 128) for
//      mode 0 (vpu) or (C, 3, 4, 128) for mode 1 (mxu).
// out is (n_tiles, 32, 2) f32. Returns the CUDA error of the launch (0 on
// success).
extern "C" int k1_lab_launch(int lab, int mode, const int* counts,
                             const int* keys, int key_stride,
                             const float* rays, const float* d3,
                             const float* mm2, const float* tris,
                             int n_tiles, int n_clusters, int idmask,
                             int warps, float* out, void* stream,
                             const int* order) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks4 = (n_tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem4 = kWarpsPerBlock * kBuf * sizeof(float4);
  switch (lab * 10 + mode) {
#define K1_LAB8(M, T)                                                       \
  case 80 + M:                                                              \
    lab8_kernel<M, T><<<(n_tiles + T - 1) / T, T * kTile, 0, st>>>(         \
        counts, keys, rays, d3, mm2, n_tiles, out);                         \
    break;
    K1_LAB8(0, kTiles8Write)
    K1_LAB8(1, kTiles8)
    K1_LAB8(2, kTiles8)
    K1_LAB8(3, kTiles8)
#undef K1_LAB8
#define K1_LAB9(M)                                                          \
  case 90 + M:                                                              \
    lab9_kernel<M, kRays9><<<blocks4, kWarpsPerBlock * kTile,               \
                             2 * smem4, st>>>(counts, keys, rays, d3, mm2,  \
                                              tris, n_tiles, n_clusters,    \
                                              out);                         \
    break;
    K1_LAB9(0)
    K1_LAB9(1)
    K1_LAB9(2)
    K1_LAB9(3)
    K1_LAB9(4)
#undef K1_LAB9
#define K1_LAB10(M)                                                         \
  case 100 + M:                                                             \
    lab10_kernel<M, kRays9>                                                 \
        <<<(n_tiles + kTiles10 - 1) / kTiles10, kTiles10 * kTile,           \
           kTiles10 * 2 * kBuf * sizeof(float4), st>>>(                     \
            counts, keys, key_stride, rays, tris, n_tiles, n_clusters,      \
            idmask, order, out);                                            \
    break;
    K1_LAB10(0)
    K1_LAB10(1)
    K1_LAB10(2)
    K1_LAB10(3)
#undef K1_LAB10
    case 110:
      lab11_vpu_kernel<kRays9><<<blocks4, kWarpsPerBlock * kTile,
                                 2 * smem4, st>>>(counts, rays, tris, n_tiles,
                                                  n_clusters, out);
      break;
    case 111: {
      auto kernel = lab11_mxu_kernel;
      const int smem = kWarpsPerBlock * 2 * kRows * kPadRow * sizeof(float4);
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      kernel<<<blocks4, kWarpsPerBlock * kTile, smem, st>>>(
          counts, rays, tris, n_tiles, n_clusters, out);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
