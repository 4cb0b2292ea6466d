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
// L4 (brick_kernel, the first design): one block of 8 warps walks one tile.
// Each of a tile's rays takes P = 32 / TILE lanes of each warp (TILE 8, 16
// or 32); its 8P workers split every step's KB * 128 triangles, 4 at a
// time (float4 rows), worker q taking the quads q, q + 8P, ... in order.
// The next step's KB x 9 rows (4.5 KB a cluster) are staged into a shared
// double buffer with cp.async 16-byte copies while the step tests the other
// (KB 16: 144 KB, one block an SM). mt keeps a running best per worker,
// combined once after the last step (shuffles over the P lanes, shared
// memory over the warps); mtfast tests every triangle of a step against
// the best from before it, and its keys meet in one int32 minimum over the
// tile's workers each step, so the faults kept from the script (t < 0
// where a < 0; lane bit 10 lost at KB = 16) come out as the script has
// them. Built unfused (-fmad=false, IEEE divisions): t and ids compare bit
// for bit with the plain version. Only L4 instantiates it; its unstaged
// path and its variants were L5's and L6's until they moved to the walk
// below.
//
// L5, L6 and L7 (brick_walk_kernel<kLab, kBody, kVariant, kTile, R>, one
// in-place walk, L7's redesign for this card extended to L5 and L6; L5
// runs L6 fixed's instance, as it computes its function):
//   * A warp walks a tile, 4 tiles a block. Lane l is lane l % (TILE / R)
//     of worker l / (TILE / R) and holds the R rays l % (TILE / R) + k TILE
//     / R, k < R: TILE 32 gives 4 workers of 8 lanes, TILE 16 8 of 4,
//     TILE 8 16 of 2. Each step, worker w takes the quads w, w + 32 R /
//     TILE, ... of the step's KB clusters, rows read in place through the
//     read-only path (the table, 2.9 MB, stays in the 50 MB L2; the
//     workers of a load read neighbouring quads), so each 16-byte row load
//     serves 4 triangles x R rays, and the loop and address steps 4R
//     tests.
//   * mt_hit_fma (lab_common.cuh), with rcp_in_range's fast path and a
//     step redone with __frcp_rn where the warp met a subnormal
//     denominator or one of at least 2^126.
//   * Each worker keeps a running best from L5 / L6's start, min(t_max,
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
// The results are the scripts' raw (n_tiles, TILE, 2) f32 blocks: t, then
// the id's int32 bits (L7: float(id)).
//
// What bounds it on the card: the FP32 instruction rate (46 operations a
// Möller-Trumbore test, 49 deferred-division, 32 Baldwin-Weber); the bytes
// are the rays and a few meta entries a tile. The first design's loop took
// 79.25 SASS instructions a Möller-Trumbore test (unfused, one ray a lane,
// __frcp_rn's range test and branch in every test, a block barrier a step
// in while and while2); the walk takes about 46 (mt) and 32 (bw) (phase 2
// of chip_smoke.py): the FMA bodies (bw_hit_fma, mt_hit_fma: 17 and 31
// FP32 instructions, not 31 and 45), 4R tests a load, loop and address
// step, and __frcp_rn's in-range fast path alone. The reciprocal stays
// correctly rounded, so that t differs from the unfused version's only by
// the FMAs' roundings, which the tie-aware hold bounds (lab/brick.py
// brick_agreement).
//
// Built with -fmad=false (trace_kernel.NVCC_FLAGS): L4's arithmetic rounds
// like its plain torch version in lab/brick.py. The walk's FMAs are written
// out (__fmaf_rn).

#include <climits>
#include <cuda_runtime.h>

#include "lab_common.cuh"

namespace {

constexpr int kCluster = 128;          // triangles per cluster
constexpr int kQuads = kCluster / 4;   // float4 of a cluster row
constexpr int kRow = 1024;             // meta entries of a tile
constexpr int kWarps = 8;              // L4: warps of a block (one tile)
constexpr int kThreads = kWarps * 32;
// shared memory of the combines: a float and an int per warp and lane
constexpr int kCombFloat4 = 2 * kWarps * 32 / 4;
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTilesBlock = 4;         // the walk: tiles (warps) a block
// the walk's R, rays a lane, at TILE 8 and 16 (4 at TILE 32)
constexpr int kRays8 = 4;
constexpr int kRays16 = 4;

enum Body { kMT = 0, kMTFast = 1, kBW = 2 };
enum Variant { kFixed = 0, kCid = 1, kWhile = 2, kWhile2 = 3 };

// kernel_lab2.py mtfast_body's key of one triangle, (t bits & ~1023) |
// lane, against best, the tile's best t from before the step; t = t_n /
// |a| on a hit (negative where a < 0, as the script has it), 3e38 on a
// miss.
__device__ __forceinline__ int mtfast_key(const Ray& r, const float (&w)[9],
                                          float best, int lane) {
  const float v0x = w[0], v0y = w[1], v0z = w[2];
  const float e1x = w[3], e1y = w[4], e1z = w[5];
  const float e2x = w[6], e2y = w[7], e2z = w[8];
  const float hx = r.dy * e2z - r.dz * e2y;
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const float sx = r.ox - v0x;
  const float sy = r.oy - v0y;
  const float sz = r.oz - v0z;
  const float u_n = sx * hx + sy * hy + sz * hz;
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v_n = r.dx * qx + r.dy * qy + r.dz * qz;
  const float t_n = e2x * qx + e2y * qy + e2z * qz;
  const float sa = a < 0.0f ? -1.0f : 1.0f;
  const float na = a * sa;
  const float nu = u_n * sa;
  const float nv = v_n * sa;
  const float nt = t_n * sa;
  const bool hit = nu >= 0.0f && nv >= 0.0f && nu + nv <= na &&
                   nt >= r.tmin * na && nt < best * na && na > 0.0f;
  const float tt = hit ? t_n / (na == 0.0f ? 1.0f : a * sa) : kBig;
  return (__float_as_int(tt) & ~1023) | lane;
}

// The smallest of v over the P lanes of a ray (aligned groups of P).
__device__ __forceinline__ int lanes_min(int v, int P) {
  for (int o = 1; o < P; o <<= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float lanes_min(float v, int P) {
  for (int o = 1; o < P; o <<= 1) {
    const float u = __shfl_xor_sync(kFull, v, o);
    v = u < v ? u : v;
  }
  return v;
}

// (t, slot) with the smaller t, then the smaller slot, over the P lanes of
// a ray.
__device__ __forceinline__ void lanes_best(float& t, int& slot, int P) {
  for (int o = 1; o < P; o <<= 1) {
    const float ut = __shfl_xor_sync(kFull, t, o);
    const int us = __shfl_xor_sync(kFull, slot, o);
    if (ut < t || (ut == t && us < slot)) {
      t = ut;
      slot = us;
    }
  }
}

// The cluster of a meta entry: clipped to the table (L7: entry & 1023, at
// most C - 1).
template <bool kLab7>
__device__ __forceinline__ int order_of(int m, int n_clusters) {
  return kLab7 ? min(m & 1023, n_clusters - 1)
               : max(0, min(m, n_clusters - 1));
}

// One tile of tile_rays rays a block: steps steps of kb clusters (see the
// head of this file). kStaged: L4's shared double buffer, otherwise rows
// read in place.
template <bool kStaged, int kBody, int kVariant>
__global__ void __launch_bounds__(kThreads)
brick_kernel(const int* __restrict__ meta, const float* __restrict__ rays,
             const float* __restrict__ tris, int tile_rays, int n_clusters,
             int kb, int steps, float* __restrict__ out) {
  constexpr int NF = 9;
  extern __shared__ float4 smem[];
  float* tcomb = reinterpret_cast<float*>(smem);
  int* icomb = reinterpret_cast<int*>(smem) + kWarps * 32;
  float4* stage_buf = smem + kCombFloat4;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int P = 32 / tile_rays;      // lanes a ray
  const int r = lane / P;
  const int q = warp * P + lane % P;  // this thread's worker
  const int Q = kWarps * P;
  const int tile = blockIdx.x;
  const int* mrow = meta + static_cast<size_t>(tile) * kRow;
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  const size_t ray = static_cast<size_t>(tile) * tile_rays + r;
  const float4 ra = reinterpret_cast<const float4*>(rays)[ray * 2];
  const float4 rb = reinterpret_cast<const float4*>(rays)[ray * 2 + 1];
  const Ray R{ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z};
  // mtfast: the tile's best t and id; otherwise this worker's running
  // best t and its slot (-1: none)
  float bt = rb.w > kBig ? kBig : rb.w;  // NaN kept
  int bi = -1;
  const int bk = kb * kCluster;
  const int nq = kb * kQuads;        // quads a step
  const int per_buf = NF * nq;       // float4 of a staged step

  // L4: step s's clusters into buffer s & 1, one 16-byte copy a thread
  // at a time, neighbouring threads on neighbouring addresses
  auto stage = [&](int s) {
    float4* dst = stage_buf + (s & 1) * per_buf;
    for (int e = threadIdx.x; e < per_buf; e += kThreads) {
      const int j = e / (NF * kQuads);
      const int row = e / kQuads % NF;
      const int qc = e % kQuads;
      const int c = order_of<false>(mrow[s * kb + j], n_clusters);
      cp_async16(dst + row * nq + j * kQuads + qc,
                 t4 + (static_cast<size_t>(c) * NF + row) * kQuads + qc);
    }
    cp_async_commit();
  };

  if (kStaged && steps > 0) stage(0);
  for (int s = 0; s < steps; ++s) {
    int orders = 0;  // lane j < kb: the cluster of the step's slot j
    if (kStaged) {
      if (s + 1 < steps) {
        stage(s + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // step s's rows are in for every thread
    } else if (lane < kb) {
      orders = order_of<false>(mrow[s * kb + lane], n_clusters);
    }
    int kmin = INT_MAX;
    for (int quad = q; quad < nq; quad += Q) {
      const float4* b;
      int stride;
      if (kStaged) {
        b = stage_buf + (s & 1) * per_buf + quad;
        stride = nq;
      } else {
        const int c = __shfl_sync(kFull, orders, quad / kQuads);
        b = t4 + static_cast<size_t>(c) * NF * kQuads + quad % kQuads;
        stride = kQuads;
      }
      float4 v[NF];
#pragma unroll
      for (int j = 0; j < NF; ++j) v[j] = kStaged ? b[j * stride]
                                                  : __ldg(b + j * stride);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float w[NF];
#pragma unroll
        for (int j = 0; j < NF; ++j) w[j] = comp(v[j], c);
        const int id = 4 * quad + c;  // the triangle's lane in the step
        if constexpr (kBody == kMTFast) {
          kmin = min(kmin, mtfast_key(R, w, bt, id));
        } else {
          float tt;
          if (mt_hit(R, w, bt, tt)) {
            bt = tt;
            bi = s * bk + id;
          }
        }
      }
    }
    if (kBody == kMTFast) {
      kmin = lanes_min(kmin, P);
      if (lane % P == 0) icomb[warp * 32 + r] = kmin;
    }
    // every thread is done with buffer s & 1 (staged again at step s + 2)
    // and with the combines of step s - 1; this step's are written
    if (kStaged) __syncthreads();
    if (kBody == kMTFast) {
      int cand = icomb[r];
      for (int w = 1; w < kWarps; ++w) cand = min(cand, icomb[w * 32 + r]);
      if (cand < __float_as_int(bt)) {
        bt = __int_as_float(cand & ~1023);
        bi = s * bk + (cand & 1023);
      }
    }
    if (kVariant == kWhile || (kVariant == kWhile2 && (s & 1))) {
      // the tile stops once every ray's best t bits are <= the unclipped
      // meta entry of the next step's first slot
      const float m = lanes_min(bt, P);
      if (lane % P == 0) tcomb[warp * 32 + r] = m;
      __syncthreads();
      float mr = tcomb[r];
      for (int w = 1; w < kWarps; ++w) {
        const float u = tcomb[w * 32 + r];
        mr = u < mr ? u : mr;
      }
      const int nxt = mrow[min((s + 1) * kb, kRow - 1)];
      if (__syncthreads_and(__float_as_int(mr) <= nxt)) break;
    }
  }
  if (kBody != kMTFast) {
    // the workers' bests: smallest t, then smallest slot
    lanes_best(bt, bi, P);
    if (lane % P == 0) {
      tcomb[warp * 32 + r] = bt;
      icomb[warp * 32 + r] = bi;
    }
    __syncthreads();
    if (warp != 0) return;
    for (int w = 1; w < kWarps; ++w) {
      const float ut = tcomb[w * 32 + r];
      const int us = icomb[w * 32 + r];
      if (ut < bt || (ut == bt && us < bi)) {
        bt = ut;
        bi = us;
      }
    }
    if (kVariant == kCid && bi >= 0)
      bi = order_of<false>(mrow[bi / kCluster], n_clusters) * kCluster +
           bi % kCluster;
  } else if (warp != 0) {
    return;
  }
  if (lane % P != 0) return;
  reinterpret_cast<float2*>(out)[ray] = make_float2(bt, __int_as_float(bi));
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

// L5, L6 (kLab 6) and L7 (kLab 7): a warp walks a tile of kTile rays, R
// rays a lane (see the head of this file).
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
#pragma unroll
  for (int k = 0; k < R; ++k) workers_best(ct[k], cs[k], kLanes);
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

template <bool kStaged, int kBody, int kVariant>
int launch(const int* meta, const float* rays, const float* tris,
           int n_tiles, int tile_rays, int n_clusters, int kb, int steps,
           float* out, cudaStream_t st) {
  const size_t smem =
      (kCombFloat4 + (kStaged ? 2 * 9 * kb * kQuads : 0)) * sizeof(float4);
  auto kernel = brick_kernel<kStaged, kBody, kVariant>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<n_tiles, kThreads, smem, st>>>(meta, rays, tris, tile_rays,
                                          n_clusters, kb, steps, out);
  return static_cast<int>(cudaGetLastError());
}

template <int kLab, int kBody, int kVariant, int kTile, int R>
int launch_walk(const int* meta, const float* rays, const float* tris,
                int n_tiles, int n_clusters, int kb, int steps, float* out,
                cudaStream_t st) {
  brick_walk_kernel<kLab, kBody, kVariant, kTile, R>
      <<<(n_tiles + kTilesBlock - 1) / kTilesBlock, kTilesBlock * 32, 0,
         st>>>(meta, rays, tris, n_tiles, n_clusters, kb, steps, out);
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
      return launch<true, kMT, kFixed>(BRICK_ARGS);
    case 41:
      return launch<true, kMTFast, kFixed>(BRICK_ARGS);
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
