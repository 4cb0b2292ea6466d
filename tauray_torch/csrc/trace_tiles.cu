// Cluster traversal for Hopper (sm_90a): every traversal kernel, K1-K5.
//
// Replaces these TPU kernels of tauray_tpu/ops/pallas_trace.py:
//   * _kernel_vm3 / pallas_trace_tiles_vm3 (K1, kExit = false, Baldwin-
//     Weber): closest hit over id-only ascending key rows (n_tiles, >= C),
//     no exit;
//   * _kernel_vm2 / pallas_trace_tiles_vm2 (K4) and _kernel_vm /
//     pallas_trace_tiles_vm (K5), kExit = true over the Baldwin-Weber rows
//     tris12 (C, 12, 1, 128);
//   * _kernel / pallas_trace_tiles (K2), kExit = true over the
//     Möller-Trumbore rows tris9 (C, 9, 1, 128);
//   * _kernel_inst / pallas_trace_tiles_inst (K3): K2 over
//     cluster-instances (kInst): key k names object cluster k_cluster[k]
//     and instance k_inst[k], the ray is moved into that instance's space
//     with its world -> object 3x4 rows (direction unnormalized, so t stays
//     in world units), and the id is k * 128 + lane.
// The kExit kernels walk entry-t key rows (n_tiles, >= n_keys + 8), sorted
// by (entry-t bits & ~idmask) | id, in steps of KB = 8 keys with a
// tile-wide front-to-back exit and, in any-hit mode, an exit on hits in
// all-opaque clusters; optionally they write the steps each tile walked
// (debug_steps).
// It computes their contract, not their TPU schedule:
//   * one block per 32-ray tile; all W warps of the block hold the same
//     32 rays, one per lane, and warp w tests the key slots j = w (mod W),
//     so a small wave still fills the card and a heavy tile is shared; the
//     wrapper picks W (4 or 8) per launch (trace_kernel.bw_warps);
//   * each warp stages its clusters' rows (6 KB of tris12 or 4.5 KB of
//     tris9; for K3 also the instance's 48-byte row) in its slice of shared
//     memory with cp.async 16-byte copies and waits for them; the other
//     warps on the SM hide the copy, which measured faster than keeping
//     the next cluster, or half-cluster, in flight in a second buffer
//     (PERF.md);
//   * the inner loop takes 4 triangles at a time, each of the 12 (or 9)
//     components of 4 adjacent triangles one 16-byte shared read;
//   * keys (and, in any-hit mode, their opacities; for K3 their cluster
//     and instance) are read once per warp, 32 at a time, lane l holding
//     the warp's l-th key, and handed out with __shfl_sync;
//   * K3 moves the ray into the key's instance space once per (lane, key),
//     in the order of pallas_trace.py:395-398 (left to right, + iv[3]
//     last), before the key's 128 tests;
//   * the combine is exact. K1: each warp keeps its own best (t, slot id);
//     the block takes, per ray, the smallest t and on a tie the smallest
//     slot id, which is what a strict-< walk over ascending cluster ids
//     returns. K2-K5: per step each warp tests its share of the step's 8
//     keys against the best from before the step (a running minimum with
//     strict < in key order); the block takes the smallest t and on a tie
//     the smallest key position, with the winner's opacity: the TPU's
//     per-step argmin (pallas_trace.py:188-208, :437-456, :856-872). Every
//     warp then holds the same best, takes the same vote, and all stop at
//     the same step.
// Semantics kept from the TPU kernels: the arithmetic order of
// pallas_trace.py:1108-1117 / :841-855 (Baldwin-Weber) and :170-183 /
// :420-433 (Möller-Trumbore), the hit test (denominator != 0, u >= 0,
// v >= 0, u + v <= 1, t >= tmin, strict t < best), best t starting at
// min(tmax, 3e38) with a NaN kept, slots past the tile's count never
// tested, the key clamps min(max(k, 0), C - 1) (K1) and
// min(k & idmask, n_keys - 1) (K2-K5), and on a miss t = +inf and id -1.
//
// What bounds it on the card: each (ray, triangle) test is 32 (Baldwin-
// Weber) or 46 (Möller-Trumbore) FP32 operations, a division among them,
// plus compares and selects, so the kernel is bound by the FP32
// instruction rate; under -fmad=false none of them fuse. The
// Möller-Trumbore test takes its reciprocal without a branch around it (of
// 1 where the determinant is 0, as the plain version does), which cut its
// loop from 78.5 to 74.25 instructions a test (PERF.md). Its bytes are one
// cluster block per (warp, cluster) visit, read from L2 (a 2,197-cluster
// tris12 table is 13.5 MB, a 3,926-cluster tris9 table 18 MB; both stay in
// the 50 MB L2), hidden behind the other warps' tests.
//
// Built with -fmad=false so its arithmetic rounds exactly like the plain
// torch versions (trace_kernel.trace_tiles_vm3_reference and
// _mt_reference): ids and t compare bit for bit. Outputs: t (f32, +inf on
// miss) and the slot id (i32, -1 on miss) in two arrays, so an id never
// passes through a float.

#include <cuda_runtime.h>

namespace {

constexpr int kCluster = 128;   // triangles per cluster
constexpr int kTile = 32;       // rays per tile = lanes per warp
constexpr int kBW = 12;         // Baldwin-Weber floats per triangle
constexpr int kMT = 9;          // Möller-Trumbore floats per triangle
constexpr int kStep = 8;        // keys per step of K2-K5 (KB)
constexpr int kQuads = kCluster / 4;
// A block of W warps is declared to run at least kMinWarps / W times on
// one SM, which caps its registers at 65,536 / (32 x kMinWarps) = 128 a
// thread: without a cap, ptxas held some instances to 72-80 registers and
// spilled.
constexpr int kMinWarps = 16;
constexpr float kBig = 3.0e38f;
constexpr int kNone = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// float4 of one warp's buffer: a cluster's rows (6,144 B of tris12 or
// 4,608 B of tris9), then, for K3, the instance's 3x4 row (48 B)
template <int kRows, bool kInst>
__host__ __device__ constexpr int buf_quads() {
  return kRows * kQuads + (kInst ? 3 : 0);
}

// one warp's best for one ray, as the block combine exchanges it
struct Cand {
  float t;
  int id;
  int pos;   // K2-K5: key slot of this step's winner (kNone: none)
  int opq;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Copies cluster c's kRows x 512 bytes of rows into buf with kRows 16-byte
// cp.async copies a lane, neighbouring lanes on neighbouring addresses
// (for K3 lanes 0-2 also copy the instance row inv_row after them), and
// waits for this lane's copies.
template <int kRows, bool kInst>
__device__ __forceinline__ void stage(float4* buf, const float* tris, int c,
                                      const float* inv_row, int lane) {
  const float4* src = reinterpret_cast<const float4*>(
      tris + static_cast<size_t>(c) * kRows * kCluster);
#pragma unroll
  for (int j = 0; j < kRows * kQuads / kTile; ++j)
    cp_async16(buf + j * kTile + lane, src + j * kTile + lane);
  if (kInst && lane < 3)
    cp_async16(buf + kRows * kQuads + lane, inv_row + 4 * lane);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin;
};

// One Baldwin-Weber test in the order of pallas_trace.py:1108-1117; on a
// hit closer than bt, takes it. Returns whether it did.
__device__ __forceinline__ bool bw_test(
    const Ray& r, float nx, float ny, float nz, float nd, float r1x,
    float r1y, float r1z, float r1d, float r2x, float r2y, float r2z,
    float r2d, int id, float& bt, int& bi) {
  const float den = nx * r.dx + ny * r.dy + nz * r.dz;
  const float num = nd - (nx * r.ox + ny * r.oy + nz * r.oz);
  const float f = den != 0.0f ? 1.0f / den : 0.0f;
  const float tt = num * f;
  const float px = r.ox + tt * r.dx;
  const float py = r.oy + tt * r.dy;
  const float pz = r.oz + tt * r.dz;
  const float uu = r1x * px + r1y * py + r1z * pz - r1d;
  const float vv = r2x * px + r2y * py + r2z * pz - r2d;
  if (den != 0.0f && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f &&
      tt >= r.tmin && tt < bt) {
    bt = tt;
    bi = id;
    return true;
  }
  return false;
}

// One Möller-Trumbore test over [v0 | e1 | e2], h = cross(d, e2), in the
// order of pallas_trace.py:170-183; on a hit closer than bt, takes it.
// Returns whether it did.
__device__ __forceinline__ bool mt_test(
    const Ray& r, float v0x, float v0y, float v0z, float e1x, float e1y,
    float e1z, float e2x, float e2y, float e2z, int id, float& bt,
    int& bi) {
  const float hx = r.dy * e2z - r.dz * e2y;
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  // the reciprocal on every lane, of 1 where a == 0 (as the plain version
  // takes it), then a select: no branch around the division, and no
  // degenerate triangle sends it down its slow path
  const bool nonzero = a != 0.0f;
  const float ra = 1.0f / (nonzero ? a : 1.0f);
  const float f = nonzero ? ra : 0.0f;
  const float sx = r.ox - v0x;
  const float sy = r.oy - v0y;
  const float sz = r.oz - v0z;
  const float uu = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float vv = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  const float tt = f * (e2x * qx + e2y * qy + e2z * qz);
  if (nonzero && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f &&
      tt >= r.tmin && tt < bt) {
    bt = tt;
    bi = id;
    return true;
  }
  return false;
}

// The ray against the 128 triangles of key k staged in buf, in lane
// order, four at a time: component m of triangles 4q..4q+3 is the float4
// buf[m * 32 + q]. Returns whether the best changed.
template <int kRows>
__device__ __forceinline__ bool test_cluster(const float4* buf, int k,
                                             const Ray& r, float& bt,
                                             int& bi) {
  bool upd = false;
  for (int q = 0; q < kQuads; ++q) {
    const float4* b = buf + q;
    const int id = k * kCluster + 4 * q;
    if constexpr (kRows == kBW) {
      const float4 nx = b[0 * kQuads], ny = b[1 * kQuads];
      const float4 nz = b[2 * kQuads], nd = b[3 * kQuads];
      const float4 r1x = b[4 * kQuads], r1y = b[5 * kQuads];
      const float4 r1z = b[6 * kQuads], r1d = b[7 * kQuads];
      const float4 r2x = b[8 * kQuads], r2y = b[9 * kQuads];
      const float4 r2z = b[10 * kQuads], r2d = b[11 * kQuads];
      upd |= bw_test(r, nx.x, ny.x, nz.x, nd.x, r1x.x, r1y.x, r1z.x, r1d.x,
                     r2x.x, r2y.x, r2z.x, r2d.x, id, bt, bi);
      upd |= bw_test(r, nx.y, ny.y, nz.y, nd.y, r1x.y, r1y.y, r1z.y, r1d.y,
                     r2x.y, r2y.y, r2z.y, r2d.y, id + 1, bt, bi);
      upd |= bw_test(r, nx.z, ny.z, nz.z, nd.z, r1x.z, r1y.z, r1z.z, r1d.z,
                     r2x.z, r2y.z, r2z.z, r2d.z, id + 2, bt, bi);
      upd |= bw_test(r, nx.w, ny.w, nz.w, nd.w, r1x.w, r1y.w, r1z.w, r1d.w,
                     r2x.w, r2y.w, r2z.w, r2d.w, id + 3, bt, bi);
    } else {
      const float4 v0x = b[0 * kQuads], v0y = b[1 * kQuads];
      const float4 v0z = b[2 * kQuads], e1x = b[3 * kQuads];
      const float4 e1y = b[4 * kQuads], e1z = b[5 * kQuads];
      const float4 e2x = b[6 * kQuads], e2y = b[7 * kQuads];
      const float4 e2z = b[8 * kQuads];
      upd |= mt_test(r, v0x.x, v0y.x, v0z.x, e1x.x, e1y.x, e1z.x, e2x.x,
                     e2y.x, e2z.x, id, bt, bi);
      upd |= mt_test(r, v0x.y, v0y.y, v0z.y, e1x.y, e1y.y, e1z.y, e2x.y,
                     e2y.y, e2z.y, id + 1, bt, bi);
      upd |= mt_test(r, v0x.z, v0y.z, v0z.z, e1x.z, e1y.z, e1z.z, e2x.z,
                     e2y.z, e2z.z, id + 2, bt, bi);
      upd |= mt_test(r, v0x.w, v0y.w, v0z.w, e1x.w, e1y.w, e1z.w, e2x.w,
                     e2y.w, e2z.w, id + 3, bt, bi);
    }
  }
  return upd;
}

// The world ray r moved into an instance's space by its staged 3x4
// world -> object rows iv, in the order of pallas_trace.py:395-398.
__device__ __forceinline__ Ray to_instance(const float4* iv, const Ray& r) {
  const float4 a = iv[0], b = iv[1], c = iv[2];
  return Ray{a.x * r.ox + a.y * r.oy + a.z * r.oz + a.w,
             b.x * r.ox + b.y * r.oy + b.z * r.oz + b.w,
             c.x * r.ox + c.y * r.oy + c.z * r.oz + c.w,
             a.x * r.dx + a.y * r.dy + a.z * r.dz,
             b.x * r.dx + b.y * r.dy + b.z * r.dz,
             c.x * r.dx + c.y * r.dy + c.z * r.dz,
             r.tmin};
}

// One warp's walk over its key slots warp + i * W, i < n_mine: the keys
// read 32 at a time (lane l holds the key id, its opacity and, for K3, its
// cluster and instance, of the warp's slot base + l) and handed out with
// __shfl_sync, each cluster's rows staged in the warp's buffer and tested.
template <int W, bool kExit, int kRows, bool kInst>
struct Walk {
  const int* krow;
  const float* tris;
  const int* opaque;
  const int* k_cluster;
  const int* k_inst;
  const float* inv12;
  float4* buf;
  int warp, lane, n_mine, n_keys, idmask, any_hit;
  int kc, oc;   // this lane's key (id, opacity) of the current 32
  int cc, ic;   // K3: its object cluster and instance

  // Tests this warp's slot i; returns whether the best changed, with the
  // slot's opacity in opq.
  __device__ __forceinline__ bool visit(int i, const Ray& r, float& bt,
                                        int& bi, int& opq) {
    if ((i & 31) == 0) {
      kc = 0;
      oc = 0;
      cc = 0;
      ic = 0;
      if (i + lane < n_mine) {
        const int key = krow[warp + (i + lane) * W];
        kc = kExit ? min(key & idmask, n_keys - 1)
                   : min(max(key, 0), n_keys - 1);
        if (kExit && any_hit) oc = opaque[kc];
        if (kInst) {
          cc = k_cluster[kc];
          ic = k_inst[kc];
        }
      }
    }
    const int k = __shfl_sync(kFull, kc, i & 31);
    opq = __shfl_sync(kFull, oc, i & 31);
    bool upd;
    if constexpr (kInst) {
      const int c = __shfl_sync(kFull, cc, i & 31);
      const int inst = __shfl_sync(kFull, ic, i & 31);
      stage<kRows, true>(buf, tris, c,
                         inv12 + static_cast<size_t>(inst) * 12, lane);
      __syncwarp();
      const Ray ri = to_instance(buf + kRows * kQuads, r);
      upd = test_cluster<kRows>(buf, k, ri, bt, bi);
    } else {
      stage<kRows, false>(buf, tris, k, nullptr, lane);
      __syncwarp();
      upd = test_cluster<kRows>(buf, k, r, bt, bi);
    }
    __syncwarp();  // every lane is done with buf before it is refilled
    return upd;
  }
};

// Shared memory of one block: a buffer for each of the W warps, then the
// combine's candidates (two rows of W x 32 for K2-K5, one for K1).
template <int W, bool kExit, int kRows, bool kInst>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(W) * buf_quads<kRows, kInst>() *
             sizeof(float4) +
         (kExit ? 2 : 1) * W * kTile * sizeof(Cand);
}

template <int W, bool kExit, int kRows, bool kInst>
__global__ void __launch_bounds__(kTile * W, kMinWarps / W)
trace_tiles_kernel(const int* __restrict__ counts,
                   const int* __restrict__ keys, int key_stride,
                   const float* __restrict__ rays8,
                   const float* __restrict__ tris,
                   const int* __restrict__ opaque,
                   const int* __restrict__ k_cluster,
                   const int* __restrict__ k_inst,
                   const float* __restrict__ inv12, int n_keys, int idmask,
                   int any_hit, float* __restrict__ t_out,
                   int* __restrict__ tid_out, int* __restrict__ steps_out) {
  static_assert(kExit || (kRows == kBW && !kInst), "K1 is Baldwin-Weber");
  extern __shared__ float4 smem[];
  constexpr int kWarpBuf = buf_quads<kRows, kInst>();
  const int warp = threadIdx.x / kTile;
  const int lane = threadIdx.x % kTile;
  const int tile = blockIdx.x;
  Cand* comb = reinterpret_cast<Cand*>(smem + W * kWarpBuf);

  const size_t ray = static_cast<size_t>(tile) * kTile + lane;
  const float4 a = reinterpret_cast<const float4*>(rays8)[ray * 2];
  const float4 b = reinterpret_cast<const float4*>(rays8)[ray * 2 + 1];
  const Ray r{a.x, a.y, a.z, a.w, b.x, b.y, b.z};
  float bt = b.w > kBig ? kBig : b.w;  // jnp.minimum keeps a NaN
  int bi = -1;
  int bopq = 0;

  const int count = counts[tile];
  Walk<W, kExit, kRows, kInst> walk;
  walk.krow = keys + static_cast<size_t>(tile) * key_stride;
  walk.tris = tris;
  walk.opaque = opaque;
  walk.k_cluster = k_cluster;
  walk.k_inst = k_inst;
  walk.inv12 = inv12;
  walk.buf = smem + warp * kWarpBuf;
  walk.warp = warp;
  walk.lane = lane;
  walk.n_mine = count > warp ? (count - warp + W - 1) / W : 0;
  walk.n_keys = n_keys;
  walk.idmask = idmask;
  walk.any_hit = any_hit;
  int i = 0;  // this warp's next slot: warp + i * W

  if (!kExit) {
    for (; i < walk.n_mine; ++i) {
      int opq;
      walk.visit(i, r, bt, bi, opq);
    }
    comb[warp * kTile + lane] = Cand{bt, bi, 0, 0};
    __syncthreads();
    if (warp != 0) return;
    for (int v = 1; v < W; ++v) {
      const Cand e = comb[v * kTile + lane];
      if (e.t < bt || (e.t == bt && e.id < bi)) {
        bt = e.t;
        bi = e.id;
      }
    }
  } else {
    constexpr int kPer = kStep / W;   // this warp's slots per step
    static_assert(kStep % W == 0, "W divides the step");
    const int steps = (count + kStep - 1) / kStep;
    int walked = 0;
    for (int step = 0; step < steps; ++step) {
      ++walked;
      const int next =
          walk.krow[min((step + 1) * kStep, key_stride - 1)] & ~idmask;
      int pos = kNone;
      const int iend = min((step + 1) * kPer, walk.n_mine);
      for (; i < iend; ++i) {
        int opq;
        if (walk.visit(i, r, bt, bi, opq)) {
          pos = warp + i * W;
          bopq = opq;
        }
      }
      Cand* cb = comb + (step & 1) * W * kTile;
      cb[warp * kTile + lane] = Cand{bt, bi, pos, bopq};
      __syncthreads();
      Cand w = cb[lane];
      for (int v = 1; v < W; ++v) {
        const Cand e = cb[v * kTile + lane];
        if (e.t < w.t || (e.t == w.t && e.pos < w.pos)) w = e;
      }
      bt = w.t;
      bi = w.id;
      bopq = w.opq;
      // the tile-level front-to-back exit (bit-space compare of t >= 0);
      // every warp holds the same best, so every warp takes the same vote
      bool done = __float_as_int(bt) <= next;
      if (any_hit) done = done || (bi >= 0 && bopq > 0);
      if (__all_sync(kFull, done)) break;
    }
    if (warp != 0) return;
    if (steps_out != nullptr && lane == 0) steps_out[tile] = walked;
  }
  t_out[ray] = bi < 0 ? __int_as_float(0x7f800000) : bt;
  tid_out[ray] = bi;
}

struct Args {
  const int* counts;
  const int* keys;
  int key_stride;
  const float* rays8;
  const float* tris;
  const int* opaque;
  const int* k_cluster;
  const int* k_inst;
  const float* inv12;
  int n_tiles, n_keys, idmask, any_hit;
  float* t_out;
  int* tid_out;
  int* steps_out;
  cudaStream_t st;
};

template <int W, bool kExit, int kRows, bool kInst>
int launch(const Args& g) {
  constexpr size_t smem = smem_bytes<W, kExit, kRows, kInst>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trace_tiles_kernel<W, kExit, kRows, kInst>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  trace_tiles_kernel<W, kExit, kRows, kInst>
      <<<g.n_tiles, kTile * W, smem, g.st>>>(
          g.counts, g.keys, g.key_stride, g.rays8, g.tris, g.opaque,
          g.k_cluster, g.k_inst, g.inv12, g.n_keys, g.idmask, g.any_hit,
          g.t_out, g.tid_out, g.steps_out);
  return 0;
}

template <int W>
int launch_kind(int kind, const Args& g) {
  switch (kind) {
    case 0:
      return launch<W, false, kBW, false>(g);
    case 1:
      return launch<W, true, kBW, false>(g);
    case 2:
      return launch<W, true, kMT, false>(g);
    case 3:
      return launch<W, true, kMT, true>(g);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// kind 0 launches K1 over tris12 (C, 12, 1, 128) (keys are ascending
// cluster ids; opaque, idmask and any_hit are not read), 1 K4/K5 over
// tris12, 2 K2 over tris9 (C, 9, 1, 128), 3 K3 over tris9 with the
// cluster-instance tables k_cluster, k_inst (n_keys,) and inv12 (I, 12);
// kinds 1-3 take entry-t keys in rows of >= n_keys + 8 and opaque
// (n_keys,). The instance tables are read by kind 3 only. warps is W, the
// warps sharing one tile (4 or 8). steps_out (n_tiles,) may be nullptr.
// Returns the CUDA error of the launch (0 on success).
extern "C" int trace_tiles_launch(const int* counts, const int* keys,
                                  int key_stride, const float* rays8,
                                  const float* tris, const int* opaque,
                                  const int* k_cluster, const int* k_inst,
                                  const float* inv12, int n_tiles,
                                  int n_keys, int idmask, int any_hit,
                                  int kind, int warps, float* t_out,
                                  int* tid_out, int* steps_out,
                                  void* stream) {
  if (n_tiles > 0) {
    const Args g{counts,  keys,    key_stride, rays8,  tris,
                 opaque,  k_cluster, k_inst,   inv12,  n_tiles,
                 n_keys,  idmask,  any_hit,    t_out,  tid_out,
                 steps_out, static_cast<cudaStream_t>(stream)};
    int err;
    switch (warps) {
      case 4:
        err = launch_kind<4>(kind, g);
        break;
      case 8:
        err = launch_kind<8>(kind, g);
        break;
      default:
        err = static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}
