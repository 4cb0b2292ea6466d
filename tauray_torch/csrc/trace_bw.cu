// Baldwin-Weber cluster traversal for Hopper (sm_90a): K1 and K4/K5.
//
// Replaces these TPU kernels of tauray_tpu/ops/pallas_trace.py:
//   * _kernel_vm3 / pallas_trace_tiles_vm3 (K1, kExit = false): closest
//     hit over id-only ascending key rows (n_tiles, >= C), no exit;
//   * _kernel_vm2 / pallas_trace_tiles_vm2 (K4) and _kernel_vm /
//     pallas_trace_tiles_vm (K5), kExit = true: entry-t key rows
//     (n_tiles, >= C + 8), sorted by (entry-t bits & ~idmask) | id, walked
//     in steps of KB = 8 keys with a tile-wide front-to-back exit and, in
//     any-hit mode, an exit on hits in all-opaque clusters; optionally the
//     steps each tile walked (debug_steps).
// It computes their contract, not their TPU schedule:
//   * one block per 32-ray tile; all W warps of the block hold the same
//     32 rays, one per lane, and warp w tests the key slots j = w (mod W),
//     so a small wave still fills the card and a heavy tile is shared; the
//     wrapper picks W (4 or 8) per launch (trace_kernel.bw_warps);
//   * each warp stages its clusters' tris12 rows in its 6 KB of shared
//     memory with cp.async 16-byte copies and waits for them; the other
//     warps on the SM hide the copy, which measured faster than keeping
//     the next cluster, or half-cluster, in flight in a second buffer
//     (PERF.md);
//   * the inner loop takes 4 triangles at a time, each of the 12
//     components of 4 adjacent triangles one 16-byte shared read;
//   * keys (and, in any-hit mode, their opacities) are read once per warp,
//     32 at a time, lane l holding the warp's l-th key, and handed out with
//     __shfl_sync;
//   * the combine is exact. K1: each warp keeps its own best (t, slot id);
//     the block takes, per ray, the smallest t and on a tie the smallest
//     slot id, which is what a strict-< walk over ascending cluster ids
//     returns. K4/K5: per step each warp tests its share of the step's 8
//     keys against the best from before the step (a running minimum with
//     strict < in key order); the block takes the smallest t and on a tie
//     the smallest key position, with the winner's opacity: the TPU's
//     per-step argmin (pallas_trace.py:856-872). Every warp then holds the
//     same best, takes the same vote, and all stop at the same step.
// Semantics kept from the TPU kernels: the arithmetic order of
// pallas_trace.py:1108-1117 / :841-855, the hit test (den != 0, u >= 0,
// v >= 0, u + v <= 1, t >= tmin, strict t < best), best t starting at
// min(tmax, 3e38) with a NaN kept, slots past the tile's count never
// tested, the key clamps min(max(k, 0), C - 1) (K1) and
// min(k & idmask, n_keys - 1) (K4/K5), and on a miss t = +inf and id -1.
//
// What bounds it on the card: each (ray, triangle) test is 32 FP32
// operations (a division among them) plus compares and selects, so the
// kernel is bound by the FP32 instruction rate; under -fmad=false none of
// them fuse. Its bytes are one 6 KB cluster block per (warp, cluster)
// visit, read from L2 (a 2,197-cluster table is 13.5 MB and stays in the
// 50 MB L2), hidden behind the other warps' tests.
//
// Built with -fmad=false so its arithmetic rounds exactly like the plain
// torch versions (trace_kernel.trace_tiles_vm3_reference and
// trace_tiles_vm2_reference): ids and t compare bit for bit. Outputs: t
// (f32, +inf on miss) and the slot id (i32, -1 on miss) in two arrays, so
// an id never passes through a float.

#include <cuda_runtime.h>

namespace {

constexpr int kCluster = 128;   // triangles per cluster
constexpr int kTile = 32;       // rays per tile = lanes per warp
constexpr int kRows = 12;       // Baldwin-Weber floats per triangle
constexpr int kStep = 8;        // keys per step of K4/K5 (KB)
constexpr int kQuads = kCluster / 4;
constexpr int kBuf = kRows * kQuads;   // float4 per cluster (6,144 B)
// A block of W warps is declared to run at least kMinWarps / W times on
// one SM, which caps its registers at 65,536 / (32 x kMinWarps) = 128 a
// thread: without a cap, ptxas held some instances to 72-80 registers and
// spilled.
constexpr int kMinWarps = 16;
constexpr float kBig = 3.0e38f;
constexpr int kNone = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// one warp's best for one ray, as the block combine exchanges it
struct Cand {
  float t;
  int id;
  int pos;   // K4/K5: key slot of this step's winner (kNone: none)
  int opq;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Copies cluster c's 6,144 bytes of rows into buf with 12 16-byte
// cp.async copies a lane, neighbouring lanes on neighbouring addresses,
// and waits for this lane's copies.
__device__ __forceinline__ void stage(float4* buf, const float* tris12,
                                      int c, int lane) {
  const float4* src = reinterpret_cast<const float4*>(
      tris12 + static_cast<size_t>(c) * kRows * kCluster);
#pragma unroll
  for (int j = 0; j < kBuf / kTile; ++j)
    cp_async16(buf + j * kTile + lane, src + j * kTile + lane);
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

// The ray against the 128 triangles of cluster c staged in buf, in lane
// order, four at a time: component m of triangles 4q..4q+3 is the float4
// buf[m * 32 + q]. Returns whether the best changed.
__device__ __forceinline__ bool test_cluster(const float4* buf, int c,
                                             const Ray& r, float& bt,
                                             int& bi) {
  bool upd = false;
  for (int q = 0; q < kQuads; ++q) {
    const float4* b = buf + q;
    const float4 nx = b[0 * kQuads], ny = b[1 * kQuads];
    const float4 nz = b[2 * kQuads], nd = b[3 * kQuads];
    const float4 r1x = b[4 * kQuads], r1y = b[5 * kQuads];
    const float4 r1z = b[6 * kQuads], r1d = b[7 * kQuads];
    const float4 r2x = b[8 * kQuads], r2y = b[9 * kQuads];
    const float4 r2z = b[10 * kQuads], r2d = b[11 * kQuads];
    const int id = c * kCluster + 4 * q;
    upd |= bw_test(r, nx.x, ny.x, nz.x, nd.x, r1x.x, r1y.x, r1z.x, r1d.x,
                   r2x.x, r2y.x, r2z.x, r2d.x, id, bt, bi);
    upd |= bw_test(r, nx.y, ny.y, nz.y, nd.y, r1x.y, r1y.y, r1z.y, r1d.y,
                   r2x.y, r2y.y, r2z.y, r2d.y, id + 1, bt, bi);
    upd |= bw_test(r, nx.z, ny.z, nz.z, nd.z, r1x.z, r1y.z, r1z.z, r1d.z,
                   r2x.z, r2y.z, r2z.z, r2d.z, id + 2, bt, bi);
    upd |= bw_test(r, nx.w, ny.w, nz.w, nd.w, r1x.w, r1y.w, r1z.w, r1d.w,
                   r2x.w, r2y.w, r2z.w, r2d.w, id + 3, bt, bi);
  }
  return upd;
}

// One warp's walk over its key slots warp + i * W, i < n_mine: the keys
// read 32 at a time (lane l holds the cluster, and its opacity, of the
// warp's slot base + l) and handed out with __shfl_sync, each cluster's
// rows staged in the warp's buffer and tested.
template <int W, bool kExit>
struct Walk {
  const int* krow;
  const float* tris12;
  const int* opaque;
  float4* buf;
  int warp, lane, n_mine, n_keys, idmask, any_hit;
  int kc, oc;   // this lane's key (cluster, opacity) of the current 32

  // Tests this warp's slot i; returns whether the best changed, with the
  // slot's opacity in opq.
  __device__ __forceinline__ bool visit(int i, const Ray& r, float& bt,
                                        int& bi, int& opq) {
    if ((i & 31) == 0) {
      kc = 0;
      oc = 0;
      if (i + lane < n_mine) {
        const int key = krow[warp + (i + lane) * W];
        kc = kExit ? min(key & idmask, n_keys - 1)
                   : min(max(key, 0), n_keys - 1);
        if (kExit && any_hit) oc = opaque[kc];
      }
    }
    const int c = __shfl_sync(kFull, kc, i & 31);
    opq = __shfl_sync(kFull, oc, i & 31);
    stage(buf, tris12, c, lane);
    __syncwarp();
    const bool upd = test_cluster(buf, c, r, bt, bi);
    __syncwarp();  // every lane is done with buf before it is refilled
    return upd;
  }
};

// Shared memory of one block: a cluster buffer for each of the W warps,
// then the combine's candidates (two rows of W x 32 for K4/K5, one for K1).
template <int W, bool kExit>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(W) * kBuf * sizeof(float4) +
         (kExit ? 2 : 1) * W * kTile * sizeof(Cand);
}

template <int W, bool kExit>
__global__ void __launch_bounds__(kTile * W, kMinWarps / W)
trace_bw_kernel(const int* __restrict__ counts,
                const int* __restrict__ keys, int key_stride,
                const float* __restrict__ rays8,
                const float* __restrict__ tris12,
                const int* __restrict__ opaque, int n_keys, int idmask,
                int any_hit, float* __restrict__ t_out,
                int* __restrict__ tid_out, int* __restrict__ steps_out) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x / kTile;
  const int lane = threadIdx.x % kTile;
  const int tile = blockIdx.x;
  Cand* comb = reinterpret_cast<Cand*>(smem + W * kBuf);

  const size_t ray = static_cast<size_t>(tile) * kTile + lane;
  const float4 a = reinterpret_cast<const float4*>(rays8)[ray * 2];
  const float4 b = reinterpret_cast<const float4*>(rays8)[ray * 2 + 1];
  const Ray r{a.x, a.y, a.z, a.w, b.x, b.y, b.z};
  float bt = b.w > kBig ? kBig : b.w;  // jnp.minimum keeps a NaN
  int bi = -1;
  int bopq = 0;

  const int count = counts[tile];
  Walk<W, kExit> walk;
  walk.krow = keys + static_cast<size_t>(tile) * key_stride;
  walk.tris12 = tris12;
  walk.opaque = opaque;
  walk.buf = smem + warp * kBuf;
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

template <int W, bool kExit>
int launch(const int* counts, const int* keys, int key_stride,
           const float* rays8, const float* tris12, const int* opaque,
           int n_tiles, int n_keys, int idmask, int any_hit, float* t_out,
           int* tid_out, int* steps_out, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<W, kExit>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trace_bw_kernel<W, kExit>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  trace_bw_kernel<W, kExit><<<n_tiles, kTile * W, smem, st>>>(
      counts, keys, key_stride, rays8, tris12, opaque, n_keys, idmask,
      any_hit, t_out, tid_out, steps_out);
  return 0;
}

template <bool kExit>
int launch_w(int warps, const int* counts, const int* keys, int key_stride,
             const float* rays8, const float* tris12, const int* opaque,
             int n_tiles, int n_keys, int idmask, int any_hit, float* t_out,
             int* tid_out, int* steps_out, cudaStream_t st) {
  switch (warps) {
    case 4:
      return launch<4, kExit>(counts, keys, key_stride, rays8, tris12,
                              opaque, n_tiles, n_keys, idmask, any_hit,
                              t_out, tid_out, steps_out, st);
    case 8:
      return launch<8, kExit>(counts, keys, key_stride, rays8, tris12,
                              opaque, n_tiles, n_keys, idmask, any_hit,
                              t_out, tid_out, steps_out, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// tris12 (n_keys, 12, 1, 128) Baldwin-Weber rows. exit == 0 launches K1
// (keys are ascending cluster ids; opaque, idmask and any_hit are not
// read), exit != 0 K4/K5 (entry-t keys, rows of >= n_keys + 8). warps is
// W, the warps sharing one tile (4 or 8). steps_out (n_tiles,) may
// be nullptr. Returns the CUDA error of the launch (0 on success).
extern "C" int trace_bw_launch(const int* counts, const int* keys,
                               int key_stride, const float* rays8,
                               const float* tris12, const int* opaque,
                               int n_tiles, int n_keys, int idmask,
                               int any_hit, int exit, int warps,
                               float* t_out, int* tid_out, int* steps_out,
                               void* stream) {
  if (n_tiles > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int err =
        exit != 0
            ? launch_w<true>(warps, counts, keys, key_stride, rays8, tris12,
                             opaque, n_tiles, n_keys, idmask, any_hit,
                             t_out, tid_out, steps_out, st)
            : launch_w<false>(warps, counts, keys, key_stride, rays8,
                              tris12, opaque, n_tiles, n_keys, idmask,
                              any_hit, t_out, tid_out, steps_out, st);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}
