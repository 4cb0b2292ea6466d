// The four labs that take K2's Möller-Trumbore tile walk apart, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernels of tauray_tpu's TPU lab scripts:
//   * L4, scripts/kernel_lab2.py make_kernel (pallas_call :234): KB whole
//     128-triangle clusters ("bricks") a step, copied into VMEM one step
//     ahead by double-buffered DMA, tested by mt_body (:120) or by the
//     deferred-division mtfast_body (:157);
//   * L5, scripts/kernel_lab3.py make_kernel (:172): L4's mt step over the
//     table held in VMEM and indexed in place, with no per-step copy;
//   * L6, scripts/kernel_lab4.py make_kernel (:199): L5's loop and its
//     per-step machinery: fixed and slot (ids as order slots), cid (the
//     slot's cluster id), while / while2 (the tile's exit test after every
//     step / every second step);
//   * L7, scripts/kernel_lab5.py make_kernel (:159): L5's loop with
//     Möller-Trumbore over tris9 against Baldwin-Weber over tris12.
// It computes the scripts' functions (tauray_torch/lab/brick.py states
// them), not their TPU schedules: no group of 32 tiles a grid step, no
// meta copy into SMEM.
//
// L4-L7 (brick_walk_kernel<kLab, kBody, kVariant, kTile, R>, one walk,
// L7's redesign for this card extended to L5 and L6, then to L4; L5 runs
// L6 fixed's instance, as it computes its function):
//   * A warp walks a tile, 4 tiles a block. Lane l is lane l % (TILE / R)
//     of worker l / (TILE / R) and holds the R rays l % (TILE / R) + k TILE
//     / R, k < R: TILE 32 gives 4 workers of 8 lanes, TILE 16 8 of 4,
//     TILE 8 16 of 2. Each step, worker w takes the quads w, w + 32 R /
//     TILE, ... of the step's KB clusters (the same quads w, w + 32 R /
//     TILE, ... of each cluster), so each 16-byte row load serves 4
//     triangles x R rays, and the loop and address steps 4R tests. L5-L7
//     read the rows in place through the read-only path (the table, 2.9
//     MB, stays in the 50 MB L2; the workers of a load read neighbouring
//     quads).
//   * mt_hit_fma (lab_common.cuh), with rcp_in_range's fast path and a
//     step redone with __frcp_rn where the warp met a subnormal
//     denominator or one of at least 2^126.
//   * Each worker keeps a running best from L4-L6's start, min(t_max,
//     3e38) with a NaN kept (L7: 3e38), and id -1: a candidate beats it
//     with one compare, tt < ct. A step's candidate beats the best from
//     before the step whenever it beats the running best, and each worker
//     visits its slots in ascending order, so the workers' bests, met by
//     smallest t, then smallest slot, after the last step, are the walk's
//     first smallest (t, slot).
//   * The meta entries of step s + 1 (lane j < KB reads slot j's) are read
//     while step s tests; each quad takes its cluster from them with a
//     shuffle.
//   * while / while2: after every step (after odd steps), each ray's best
//     t is met over its workers by shuffles (a minimum), and the warp
//     votes with __all_sync whether every ray's t bits are <= the
//     unclipped meta entry min((s + 1) KB, 1,023): no shared memory and no
//     barrier. On the script's meta the exit never fires (every entry is a
//     cluster id below 636), as on the TPU.
//   * The id is the winning slot, s KB 128 + the triangle's lane in the
//     step, as int32 bits (-1: none); cid resolves it after the combine to
//     the slot's clipped cluster x 128 + lane; L7 writes float(slot), 0 on
//     a miss.
//   * R by TILE (kRays8, kRays16, 4 at TILE 32; L7 takes TILE 32 only),
//     chosen by measurement (app/lab_bench.py against builds with the
//     other R, back to back, NVIDIA H100 80GB HBM3 at 700 W): R = 4 at
//     every TILE. At TILE 32 it ran 3-4% ahead of R = 2 (L7's walk); at
//     TILE 16 2.5-3.4% ahead of R = 2 and 0.9-1.3% ahead of R = 8; at
//     TILE 8 within 0.5% of R = 2 and 2.3-3.2% ahead of R = 8 (the 16
//     workers' per-step work, a meta read, the snapshot and the vote, does
//     not show).
// L4 (kLab 4; the lab's question is whether staging bricks pays, so its
// clusters pass through shared memory):
//   * The tile's clusters, walk position g = s KB + j (step s, slot j),
//     pass one at a time through a ring of two cluster slots of the warp's
//     own, whatever KB is (L10's ring: 16-byte cp.async copies, 9 a lane,
//     cluster g + 1 copied while cluster g is tested; one tris9 cluster is
//     9 x 512 = 4,608 contiguous bytes of the (C, 9, 1, 128) table: 9 KB a
//     warp, 36 KB a block, 16 warps an SM at 128 registers). KB decides
//     only where a step ends (mtfast's update) and the slots' numbering,
//     s KB 128 + j 128 + lane. The ring was chosen by
//     measurement in turns on the H100 (app/lab_bench.py, back to back,
//     NVIDIA H100 80GB HBM3 at 700 W) against two other builds of the same
//     walk: a ring of three slots a warp, each filled by one 1-D bulk copy
//     (cp.async.bulk, the TMA path) issued by lane 0 two clusters ahead
//     and completed on the slot's mbarrier, and the rows read in place as
//     L5 reads them. The three came within 3% of each other at every
//     configuration: the cp.async ring ran 0.8-2.4% ahead of the bulk
//     ring on mt and at TILE 16, 0.5-1.3% behind it on mtfast at TILE 32,
//     0.7% ahead over the 12 configurations together; reads in place ran
//     0.4-2.0% ahead of the bulk ring at TILE 16 and 0.8-2.8% behind it at
//     TILE 32. So staging bricks pays a little at TILE 32 and costs a
//     little at TILE 16: the 2.9 MB table stays in the 50 MB L2, and each
//     ring keeps the SM its 16 warps.
//   * mt: mt_hit_fma and the running bests above, each cluster redone
//     from its slot with __frcp_rn where the warp met an odd denominator;
//     the bests combined by (t, slot) after the walk.
//   * mtfast: mtfast_key_fma, the script's key (t bits & ~1023) | lane of
//     every triangle of a step against the ray's best from before the
//     step (t = t_n / |a|, an IEEE division on a hit only), each worker's
//     smallest over its share, met over the workers by shuffles after the
//     step's last cluster (no shared memory, no barrier); cand <
//     bits(best) then takes (cand & ~1023, s KB 128 + (cand & 1023)). The
//     script's faults stay: t < 0 for a hit with a < 0, and lane bit 10
//     lost at KB = 16.
// The results are the scripts' raw (n_tiles, TILE, 2) f32 blocks: t, then
// the id's int32 bits (L7: float(id)).
//
// What bounds it on the card: the FP32 instruction rate (46 operations a
// Möller-Trumbore test, 49 deferred-division, 32 Baldwin-Weber); the bytes
// are the rays and a few meta entries a tile. The first designs' loops took
// 79.25-85.25 SASS instructions a Möller-Trumbore test (unfused, one ray a
// lane, __frcp_rn's range test and branch in every test, a block barrier a
// step in while and while2, L4's 8-warp staging loop and mtfast's
// shared-memory minimum); the walk takes about 46 (mt), 64 (mtfast, whose
// IEEE division stands in the loop though it runs on a hit only) and 32
// (bw) (phase 2 of chip_smoke.py): the FMA bodies (bw_hit_fma,
// mt_hit_fma: 17 and 31 FP32 instructions, not 31 and 45), 4R tests a
// load, loop and address step, and __frcp_rn's in-range fast path alone.
// The reciprocal stays correctly rounded, so that t differs from the
// unfused version's only by the FMAs' roundings, which the tie-aware holds
// bound (lab/brick.py brick_agreement; mtfast_agreement for mtfast's
// truncated keys).
//
// Built with -fmad=false (trace_kernel.NVCC_FLAGS): the FMAs are written
// out (__fmaf_rn).

#include <climits>
#include <cuda_runtime.h>

#include "lab_common.cuh"

namespace {

constexpr int kCluster = 128;          // triangles per cluster
constexpr int kQuads = kCluster / 4;   // float4 of a cluster row
constexpr int kRow = 1024;             // meta entries of a tile
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

// L4 (kLab 4), L5, L6 (kLab 6) and L7 (kLab 7): a warp walks a tile of
// kTile rays, R rays a lane (see the head of this file); L4's rings take
// kL4Smem bytes of dynamic shared memory.
template <int kLab, int kBody, int kVariant, int kTile, int R>
__global__ void __launch_bounds__(kTilesBlock * 32)
brick_walk_kernel(const int* __restrict__ meta,
                  const float* __restrict__ rays,
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
  const int* mrow = meta + static_cast<size_t>(tile) * kRow;
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  const float4* r4 = reinterpret_cast<const float4*>(rays);
  Ray r[R];
  float ct[R];
  int cs[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const size_t ray = static_cast<size_t>(tile) * kTile + lane % kLanes +
                       k * kLanes;
    const float4 ra = r4[ray * 2];
    const float4 rb = r4[ray * 2 + 1];
    r[k] = Ray{ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z};
    ct[k] = kL7 ? kBig : rb.w > kBig ? kBig : rb.w;  // a NaN t_max kept
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

template <int kLab, int kBody, int kVariant, int kTile, int R>
int launch_walk(const int* meta, const float* rays, const float* tris,
                int n_tiles, int n_clusters, int kb, int steps, float* out,
                cudaStream_t st) {
  brick_walk_kernel<kLab, kBody, kVariant, kTile, R>
      <<<(n_tiles + kTilesBlock - 1) / kTilesBlock, kTilesBlock * 32,
         kLab == 4 ? kL4Smem : 0, st>>>(meta, rays, tris, n_tiles,
                                        n_clusters, kb, steps, out);
  return static_cast<int>(cudaGetLastError());
}

// the walk at tile_rays 8, 16 or 32 (L7: 32 only)
template <int kLab, int kBody, int kVariant>
int launch_walk(const int* meta, const float* rays, const float* tris,
                int n_tiles, int tile_rays, int n_clusters, int kb,
                int steps, float* out, cudaStream_t st) {
  if constexpr (kLab != 7) {
    if (tile_rays == 8)
      return launch_walk<kLab, kBody, kVariant, 8, kRays8>(
          meta, rays, tris, n_tiles, n_clusters, kb, steps, out, st);
    if (tile_rays == 16)
      return launch_walk<kLab, kBody, kVariant, 16, kRays16>(
          meta, rays, tris, n_tiles, n_clusters, kb, steps, out, st);
  }
  if (tile_rays != 32) return static_cast<int>(cudaErrorInvalidValue);
  return launch_walk<kLab, kBody, kVariant, 32, 4>(
      meta, rays, tris, n_tiles, n_clusters, kb, steps, out, st);
}

}  // namespace

// lab 4, 5, 6 or 7 in one of its modes (the order of lab_kernel.MODES):
//   4: mt, mtfast; 5: mt; 6: fixed, slot, cid, while, while2; 7: mt, bw.
// meta (n_tiles x 1024,) i32, rays (n_tiles, tile_rays, 8) f32 with
// tile_rays 8, 16 or 32, tris (n_clusters, 9, 1, 128) f32 ((.., 12, ..)
// for 7 bw), 1 <= kb <= 16, steps * kb <= 1024; out (n_tiles, tile_rays, 2)
// f32. Returns the CUDA error of the launch (0 on success).
extern "C" int brick_lab_launch(int lab, int mode, const int* meta,
                                const float* rays, const float* tris,
                                int n_tiles, int tile_rays, int n_clusters,
                                int kb, int steps, float* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((tile_rays != 8 && tile_rays != 16 && tile_rays != 32) || kb < 1 ||
      kb > 16 || steps < 0 || steps * kb > kRow || n_clusters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
#define BRICK_ARGS meta, rays, tris, n_tiles, tile_rays, n_clusters, kb, \
                   steps, out, st
  switch (lab * 10 + mode) {
    case 40:
      return launch_walk<4, kMT, kFixed>(BRICK_ARGS);
    case 41:
      return launch_walk<4, kMTFast, kFixed>(BRICK_ARGS);
    case 50:  // L5 computes L6 fixed's function
    case 60:
    case 61:  // slot: fixed's ids are the order slots
      return launch_walk<6, kMT, kFixed>(BRICK_ARGS);
    case 62:
      return launch_walk<6, kMT, kCid>(BRICK_ARGS);
    case 63:
      return launch_walk<6, kMT, kWhile>(BRICK_ARGS);
    case 64:
      return launch_walk<6, kMT, kWhile2>(BRICK_ARGS);
    case 70:
      return launch_walk<7, kMT, kFixed>(BRICK_ARGS);
    case 71:
      return launch_walk<7, kBW, kFixed>(BRICK_ARGS);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BRICK_ARGS
}
