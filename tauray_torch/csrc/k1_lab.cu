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
//   * L8: one block per group of 32 tiles (a TPU grid step), a warp per
//     tile, a lane per ray; mode 2 copies the block's own group of heads
//     (32 x 128 i32, 16 KB) into shared memory with cp.async and waits
//     (no prefetch of the next group: a block has no next group);
//   * L11: a warp per tile (4 a block), a lane per ray; each cluster's
//     6 KB of rows staged in the warp's shared buffer with cp.async
//     16-byte copies and waited for, then read as 16-byte broadcasts, 4
//     triangles at a time, as K1 does (vpu: the step L9 took before its
//     redesign, unchanged);
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
//   * L10: K1's own design (csrc/trace_tiles.cu, kExit = false): a block
//     per tile, its W warps taking the key slots j = w (mod W), a lane per
//     ray, each warp's best combined by smallest t, then smallest id;
//   * L11 mxu: per 8-triangle column block and 16-ray row block, the six
//     products o4 @ [v | -v.v0] (K = 4) and d4 @ [v | -v.v0] with d4's
//     fourth column 0 (so K = 3 in effect) for v = n, r1, r2, each as
//     mma.sync.aligned.m16n8k4 in TF32 split in two (x = hi + lo): lo.hi
//     + hi.lo + hi.hi, which brings each product near FP32 accuracy; the
//     epilogue (division, the hit test, the per-ray minimum) runs on the
//     CUDA cores, each lane holding 4 rays x 2 triangles of a block, then
//     the 4 lanes of a row group reduce with shuffles.
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
// __frcp_rn.
//
// Built with -fmad=false (trace_kernel.NVCC_FLAGS): L8, L10, L11 vpu and
// L9 loads round exactly like their plain torch versions in
// lab/kernel_lab*.py (t and ids bit for bit). L9's other modes take the
// FMA body and are held by kernel_lab9.lab9_agreement, L11 mxu by
// kernel_lab11.mxu_agreement.

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
constexpr int kWarpsPerBlock = 4;  // L9 and L11: tiles per block
constexpr int kRays9 = 4;      // L9: rays a lane (R), workers a warp
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;
// L11 mxu: a staged row of 128 floats takes 136, so that the four rows a
// B fragment reads (k = 0..3) fall on different banks
constexpr int kPadRow = 34;    // float4 per padded row

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies cluster c's 12 x 512 bytes into buf (12 16-byte copies a lane,
// neighbouring lanes on neighbouring addresses; padded rows of kPadRow
// float4 with kPad) and waits for this lane's copies.
template <bool kPad>
__device__ __forceinline__ void stage(float4* buf, const float* tris, int c,
                                      int lane) {
  const float4* src = reinterpret_cast<const float4*>(
      tris + static_cast<size_t>(c) * kRows * kCluster);
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    float4* dst = kPad ? buf + j * kPadRow + lane : buf + j * kTile + lane;
    cp_async16(dst, src + j * kTile + lane);
  }
  cp_async_wait_all();
}

// One Baldwin-Weber test in the order of pallas_trace.py:1108-1117 (and
// of trace_kernel._bw_test): whether it hits closer than bound, with its
// t in tt.
__device__ __forceinline__ bool bw_hit(const Ray& r, float nx, float ny,
                                       float nz, float nd, float r1x,
                                       float r1y, float r1z, float r1d,
                                       float r2x, float r2y, float r2z,
                                       float r2d, float bound, float& tt) {
  const float den = nx * r.dx + ny * r.dy + nz * r.dz;
  const float num = nd - (nx * r.ox + ny * r.oy + nz * r.oz);
  const float f = den != 0.0f ? 1.0f / den : 0.0f;
  tt = num * f;
  const float px = r.ox + tt * r.dx;
  const float py = r.oy + tt * r.dy;
  const float pz = r.oz + tt * r.dz;
  const float uu = r1x * px + r1y * py + r1z * pz - r1d;
  const float vv = r2x * px + r2y * py + r2z * pz - r2d;
  return den != 0.0f && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f &&
         tt >= r.tmin && tt < bound;
}

// The ray against the 128 triangles staged in buf (ids id0 + lane), in
// lane order. kRunning: each hit must beat the running best (bt, bi),
// which it replaces (strict <). Otherwise a hit must beat bound, the best
// from before the step, and replaces the candidate (ct, ci) when closer
// than it: the first smallest, as an argmin over the step's lanes.
template <bool kRunning>
__device__ __forceinline__ void test_cluster(const float4* buf, int id0,
                                             const Ray& r, float bound,
                                             float& ct, int& ci) {
  for (int q = 0; q < kQuads; ++q) {
    const float4* b = buf + q;
    const float4 nx = b[0 * kQuads], ny = b[1 * kQuads];
    const float4 nz = b[2 * kQuads], nd = b[3 * kQuads];
    const float4 r1x = b[4 * kQuads], r1y = b[5 * kQuads];
    const float4 r1z = b[6 * kQuads], r1d = b[7 * kQuads];
    const float4 r2x = b[8 * kQuads], r2y = b[9 * kQuads];
    const float4 r2z = b[10 * kQuads], r2d = b[11 * kQuads];
    const int id = id0 + 4 * q;
    float tt;
#define K1_LAB_TEST(c, k)                                                  \
  if (bw_hit(r, nx.c, ny.c, nz.c, nd.c, r1x.c, r1y.c, r1z.c, r1d.c, r2x.c, \
             r2y.c, r2z.c, r2d.c, kRunning ? ct : bound, tt) &&            \
      tt < ct) {                                                           \
    ct = tt;                                                               \
    ci = id + k;                                                           \
  }
    K1_LAB_TEST(x, 0)
    K1_LAB_TEST(y, 1)
    K1_LAB_TEST(z, 2)
    K1_LAB_TEST(w, 3)
#undef K1_LAB_TEST
  }
}

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

template <int kMode>
__global__ void __launch_bounds__(kGroup * kTile)
lab8_kernel(const int* __restrict__ counts, const int* __restrict__ heads,
            const float* __restrict__ o3, const float* __restrict__ d3,
            const float* __restrict__ mm2, float* __restrict__ out) {
  __shared__ __align__(16) int hs[kGroup * kHeads];
  const int warp = threadIdx.x / kTile;
  const int lane = threadIdx.x % kTile;
  const int tile = blockIdx.x * kGroup + warp;
  const size_t ray = static_cast<size_t>(tile) * kTile + lane;
  if (kMode >= 2) {
    // 16 KB: one 16-byte copy a thread
    cp_async16(hs + 4 * threadIdx.x,
               heads + static_cast<size_t>(blockIdx.x) * kGroup * kHeads +
                   4 * threadIdx.x);
    cp_async_wait_all();
    __syncthreads();
  }
  float2 res;
  if (kMode == 0) {
    res = make_float2(1.0f, 2.0f);
  } else {
    const float* o = o3 + ray * 3;
    const float* d = d3 + ray * 3;
    float acc = o[0] + o[1] + o[2] + d[0] + d[1] + d[2] + mm2[ray * 2];
    if (kMode == 3) {
      const int steps = (counts[tile] + kStep - 1) / kStep;
      float acc2 = 0.0f;
      for (int s = 0; s < steps; ++s)
        acc2 = acc2 + static_cast<float>(
                          hs[warp * kHeads + min(s, kHeads - 1)]);
      acc = acc + acc2;
    }
    res = make_float2(acc, mm2[ray * 2 + 1]);
  }
  reinterpret_cast<float2*>(out)[ray] = res;
}

// ---------------------------------------------------------------------------
// L11 vpu's step (and L9's before its redesign): 8 clusters, each staged and
// waited for, then tested by every lane against its one ray
// ---------------------------------------------------------------------------

// One step over the 8 clusters lane j < 8 of `orders` names: each hit
// must beat bt, the best from before the step, and the first smallest
// replaces it (the concatenated block's argmin).
__device__ __forceinline__ void bw_step(float4* buf, const float* tris,
                                        int orders, int lane, const Ray& r,
                                        float& bt, int& bi) {
  float ct = kBig;
  int ci = -1;
  for (int j = 0; j < kStep; ++j) {
    const int c = __shfl_sync(kFull, orders, j);
    stage<false>(buf, tris, c, lane);
    __syncwarp();
    test_cluster<false>(buf, c * kCluster, r, bt, ct, ci);
    __syncwarp();  // every lane is done with buf
  }
  if (ct < bt) {
    bt = ct;
    bi = ci;
  }
}

// ---------------------------------------------------------------------------
// L9: one Baldwin-Weber step bisected, redesigned for this card
// ---------------------------------------------------------------------------

enum Lab9Mode { kFull9 = 0, kExit9 = 1, kLoads9 = 2, kMath9 = 3, kNocat9 = 4 };

// Issues the copy of cluster c's 12 x 512 bytes into buf as one cp.async
// group of 12 16-byte copies a lane, and does not wait for it.
__device__ __forceinline__ void stage_async(float4* buf, const float* tris,
                                            int c, int lane) {
  const float4* src = reinterpret_cast<const float4*>(
      tris + static_cast<size_t>(c) * kRows * kCluster);
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    cp_async16(buf + j * kQuads + lane, src + j * kQuads + lane);
  cp_async_commit();
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

struct Cand {
  float t;
  int id;
};

template <int W, int kMode>
__global__ void __launch_bounds__(kTile * W, 16 / W)
lab10_kernel(const int* __restrict__ counts, const int* __restrict__ keys,
             int key_stride, const float* __restrict__ rays8,
             const float* __restrict__ tris, int n_clusters, int idmask,
             float* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x / kTile;
  const int lane = threadIdx.x % kTile;
  const int tile = blockIdx.x;
  float4* buf = smem + warp * kBuf;
  Cand* comb = reinterpret_cast<Cand*>(smem + W * kBuf);

  const size_t ray = static_cast<size_t>(tile) * kTile + lane;
  const float4 a = reinterpret_cast<const float4*>(rays8)[ray * 2];
  const float4 b = reinterpret_cast<const float4*>(rays8)[ray * 2 + 1];
  const Ray r = kMode == kNoray10
                    ? Ray{0.1f, 0.2f, 0.3f, 0.4f, 0.5f, 0.6f, 0.0f}
                    : Ray{a.x, a.y, a.z, a.w, b.x, b.y, b.z};
  // the block's pre-set best: min(t_max, 3e38), NaN kept
  const float pre = b.w > kBig ? kBig : b.w;
  const int count = counts[tile];
  float bt = kMode == kNoray10 && count > 0 ? 1e30f : pre;
  int bi = -1;
  const int* krow = keys + static_cast<size_t>(tile) * key_stride;
  const int n_mine = count > warp ? (count - warp + W - 1) / W : 0;
  int kc = 0;
  for (int i = 0; i < n_mine; ++i) {
    const int slot = warp + i * W;
    int c;
    if (kMode == kFixord10) {
      c = slot % kStep;
    } else {
      if ((i & 31) == 0 && i + lane < n_mine)
        kc = min(krow[warp + (i + lane) * W] & idmask, n_clusters - 1);
      c = __shfl_sync(kFull, kc, i & 31);
    }
    stage<false>(buf, tris, c, lane);
    __syncwarp();
    test_cluster<true>(buf, c * kCluster, r, bt, bt, bi);
    __syncwarp();
  }
  comb[warp * kTile + lane] = Cand{bt, bi};
  __syncthreads();
  if (warp != 0) return;
  for (int v = 1; v < W; ++v) {
    const Cand e = comb[v * kTile + lane];
    if (e.t < bt || (e.t == bt && e.id < bi)) {
      bt = e.t;
      bi = e.id;
    }
  }
  float2* o2 = reinterpret_cast<float2*>(out);
  if (kMode != kNowrite10) {
    o2[ray] = make_float2(bt, __int_as_float(bi));
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
  if (gi == 0 && last > 0) {
    out[ray * 2 + 1] = __int_as_float(-1);  // the last active tile writes t
    return;
  }
  o2[ray] = make_float2(gi == 0 ? (last < 0 ? 0.0f : bt) : pre,
                        __int_as_float(-1));
  if (gi == last && gi > 0)
    out[(static_cast<size_t>(group) * kGroup * kTile + lane) * 2] = bt;
}

// ---------------------------------------------------------------------------
// L11: the Baldwin-Weber test as FP32 vector work or as matrix products
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kWarpsPerBlock * kTile)
lab11_vpu_kernel(const int* __restrict__ steps, const float* __restrict__ rays,
                 const float* __restrict__ tris, int n_tiles, int n_clusters,
                 float* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x / kTile;
  const int lane = threadIdx.x % kTile;
  const int tile = blockIdx.x * kWarpsPerBlock + warp;
  if (tile >= n_tiles) return;
  float4* buf = smem + warp * kBuf;
  const size_t ray = static_cast<size_t>(tile) * kTile + lane;
  const float4 a = reinterpret_cast<const float4*>(rays)[ray * 2];
  const float4 b = reinterpret_cast<const float4*>(rays)[ray * 2 + 1];
  const Ray r{a.x, a.y, a.z, a.w, b.x, b.y, b.z};
  float bt = kBig;
  int bi = -1;
  const int n = steps[tile];
  for (int i = 0; i < n; ++i) {
    const int orders = (i * kStep + lane + tile) % n_clusters;
    bw_step(buf, tris, orders, lane, r, bt, bi);
  }
  reinterpret_cast<float2*>(out)[ray] = make_float2(bt, __int_as_float(bi));
}

// One warp per tile. Lane l is row group g = l / 4 and column k = l % 4 of
// the mma fragments: it holds rays g, g + 8, g + 16, g + 24 (m = 0..3) of
// the A operands and, of each 8-triangle block, triangles 2k and 2k + 1.
__global__ void __launch_bounds__(kWarpsPerBlock * kTile)
lab11_mxu_kernel(const int* __restrict__ steps, const float* __restrict__ rays,
                 const float* __restrict__ tris, int n_tiles, int n_clusters,
                 float* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x / kTile;
  const int lane = threadIdx.x % kTile;
  const int tile = blockIdx.x * kWarpsPerBlock + warp;
  if (tile >= n_tiles) return;
  float4* buf = smem + warp * kRows * kPadRow;
  const float* fbuf = reinterpret_cast<const float*>(buf);
  const int g = lane / 4;
  const int k = lane % 4;
  const float* trow = rays + static_cast<size_t>(tile) * kTile * 8;
  // A fragments: o4 = [o | 1] and d4 = [d | 0], row m * 8 + g, column k
  Split ao[4], ad[4];
  float tmin[4], bt[4], ct[4];
  int bi[4], cp[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float* rr = trow + (m * 8 + g) * 8;
    ao[m] = split(k < 3 ? rr[k] : 1.0f);
    ad[m] = split(k < 3 ? rr[3 + k] : 0.0f);
    tmin[m] = rr[6];
    bt[m] = kBig;
    bi[m] = -1;
  }
  const int n = steps[tile];
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      ct[m] = kBig;
      cp[m] = 0x7fffffff;
    }
    for (int j = 0; j < kStep; ++j) {
      const int c = (i * kStep + j + tile) % n_clusters;
      stage<true>(buf, tris, c, lane);
      __syncwarp();
      for (int nb = 0; nb < kCluster / 8; ++nb) {
        // B fragment of type v: row k, column (triangle) nb * 8 + g
        Split bv[3];
#pragma unroll
        for (int v = 0; v < 3; ++v)
          bv[v] = split(fbuf[(v * 4 + k) * kPadRow * 4 + nb * 8 + g]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rays 16h + (g, g + 8)
          float on[4], or1[4], or2[4], dn[4], dr1[4], dr2[4];
          mma_3xtf32(on, ao[2 * h], ao[2 * h + 1], bv[0]);
          mma_3xtf32(or1, ao[2 * h], ao[2 * h + 1], bv[1]);
          mma_3xtf32(or2, ao[2 * h], ao[2 * h + 1], bv[2]);
          mma_3xtf32(dn, ad[2 * h], ad[2 * h + 1], bv[0]);
          mma_3xtf32(dr1, ad[2 * h], ad[2 * h + 1], bv[1]);
          mma_3xtf32(dr2, ad[2 * h], ad[2 * h + 1], bv[2]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // element e: ray 16h + g + 8 (e / 2), triangle nb*8 + 2k + e%2
            const int m = 2 * h + e / 2;
            const float den = dn[e];
            const float f = den != 0.0f ? 1.0f / den : 0.0f;
            const float tt = -on[e] * f;
            const float uu = or1[e] + tt * dr1[e];
            const float vv = or2[e] + tt * dr2[e];
            if (den != 0.0f && uu >= 0.0f && vv >= 0.0f &&
                uu + vv <= 1.0f && tt >= tmin[m] && tt < bt[m] &&
                tt < ct[m]) {
              ct[m] = tt;
              cp[m] = j * kCluster + nb * 8 + 2 * k + e % 2;
            }
          }
        }
      }
      __syncwarp();  // every lane is done with buf
    }
    // the 4 lanes of a row group hold the same rays: smallest t, then
    // the first position
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
      if (ct[m] < bt[m]) {
        bt[m] = ct[m];
        bi[m] = ((i * kStep + cp[m] / kCluster + tile) % n_clusters) *
                    kCluster + cp[m] % kCluster;
      }
    }
  }
  if (k == 0) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
      reinterpret_cast<float2*>(out)[static_cast<size_t>(tile) * kTile +
                                     m * 8 + g] =
          make_float2(bt[m], __int_as_float(bi[m]));
  }
}

// Lets kernel take smem bytes of dynamic shared memory.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int W, int M>
int launch10(const int* counts, const int* keys, int key_stride,
             const float* rays8, const float* tris, int n_tiles,
             int n_clusters, int idmask, float* out, cudaStream_t st) {
  const size_t smem = W * kBuf * sizeof(float4) + W * kTile * sizeof(Cand);
  const int e = allow_smem(lab10_kernel<W, M>, smem);
  if (e != 0) return e;
  lab10_kernel<W, M><<<n_tiles, kTile * W, smem, st>>>(
      counts, keys, key_stride, rays8, tris, n_clusters, idmask, out);
  return 0;
}

template <int M>
int launch10_w(int warps, const int* counts, const int* keys, int key_stride,
               const float* rays8, const float* tris, int n_tiles,
               int n_clusters, int idmask, float* out, cudaStream_t st) {
  if (warps == 4)
    return launch10<4, M>(counts, keys, key_stride, rays8, tris, n_tiles,
                          n_clusters, idmask, out, st);
  if (warps == 8)
    return launch10<8, M>(counts, keys, key_stride, rays8, tris, n_tiles,
                          n_clusters, idmask, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// lab 8, 9, 10 or 11 in one of its modes (the order of lab_kernel.MODES):
//   8: counts (n_tiles,), keys = heads (n_tiles, 128), rays = o3
//      (n_tiles, 32, 3), d3, mm2 (n_tiles, 32, 2); n_tiles a multiple of 32;
//   9: the same and tris (C, 12, 1, 128);
//  10: counts, keys (n_tiles, key_stride) ascending cluster ids, rays =
//      rays8 (n_tiles, 32, 8), tris (C, 12, 1, 128), idmask, warps (4 or
//      8); n_tiles a multiple of 32;
//  11: counts = steps (n_tiles,), rays = rays8, tris (C, 12, 1, 128) for
//      mode 0 (vpu) or (C, 3, 4, 128) for mode 1 (mxu).
// out is (n_tiles, 32, 2) f32. Returns the CUDA error of the launch (0 on
// success).
extern "C" int k1_lab_launch(int lab, int mode, const int* counts,
                             const int* keys, int key_stride,
                             const float* rays, const float* d3,
                             const float* mm2, const float* tris,
                             int n_tiles, int n_clusters, int idmask,
                             int warps, float* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks4 = (n_tiles + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem4 = kWarpsPerBlock * kBuf * sizeof(float4);
  switch (lab * 10 + mode) {
#define K1_LAB8(M)                                                          \
  case 80 + M:                                                              \
    lab8_kernel<M><<<n_tiles / kGroup, kGroup * kTile, 0, st>>>(            \
        counts, keys, rays, d3, mm2, out);                                  \
    break;
    K1_LAB8(0)
    K1_LAB8(1)
    K1_LAB8(2)
    K1_LAB8(3)
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
  case 100 + M: {                                                           \
    const int e = launch10_w<M>(warps, counts, keys, key_stride, rays, tris, \
                                n_tiles, n_clusters, idmask, out, st);      \
    if (e != 0) return e;                                                   \
    break;                                                                  \
  }
    K1_LAB10(0)
    K1_LAB10(1)
    K1_LAB10(2)
    K1_LAB10(3)
#undef K1_LAB10
    case 110:
      lab11_vpu_kernel<<<blocks4, kWarpsPerBlock * kTile, smem4, st>>>(
          counts, rays, tris, n_tiles, n_clusters, out);
      break;
    case 111: {
      const size_t smem = kWarpsPerBlock * kRows * kPadRow * sizeof(float4);
      lab11_mxu_kernel<<<blocks4, kWarpsPerBlock * kTile, smem, st>>>(
          counts, rays, tris, n_tiles, n_clusters, out);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
