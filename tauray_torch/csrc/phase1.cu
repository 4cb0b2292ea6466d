// Phase 1 of the flat tracer's id-key path for Hopper (sm_90a): the slab
// cull of every ray against every cluster box and each 32-ray tile's
// ascending row of active cluster ids, in one pass (P1).
//
// Replaces no TPU kernel. tauray_tpu computes phase 1 in XLA
// (ops/cluster.py _trace_padded_pallas, v3 branch: _slab_t_soa, a per-tile
// any, a row sort), which fuses it on the TPU; eager torch materialises
// every (blocks, C, 128) float of it instead (ops/cluster._slab_blocks and
// phase1_ids_reference, ~26 dense passes and a sort of every key row).
//
// Contract: rays8 (R, 8) f32 [o|d|t_min|t_max], R a multiple of 128;
// cmin, cmax (C, 3) f32. For each tile of 32 consecutive rays, counts[tile]
// is the number of clusters that any of its rays hits within [t_min,
// t_max], and keys[tile] (C wide) those cluster ids ascending, then
// 0x7FFFFFFF to the end of the row. Both equal the torch passes bit for
// bit, since the keys fix K1's tie order:
//   * inv = d == 0 ? 3e38 : 1 / d, correctly rounded (-0.0 == 0 too);
//   * t0 = (bmin - o) * inv and t1 = (bmax - o) * inv, each step rounded
//     alone (-fmad=false, and the _rn intrinsics);
//   * min and max propagate NaN (PTX min.NaN / max.NaN), as torch.minimum
//     and torch.maximum do: a denormal direction component has an infinite
//     inverse, 0 * inf is NaN, and the box is then inactive for that ray
//     (fminf would drop the NaN);
//   * tn = max(min(t0x, t1x), min(t0y, t1y), min(t0z, t1z), t_min),
//     tf = min(max(t0x, t1x), max(t0y, t1y), max(t0z, t1z)), and the box is
//     active when tf >= tn and tn <= t_max.
// min and max are exact, so only the rounded steps need torch's order.
//
// What bounds it on the card: R x C tests of ~26 instructions each (6
// FADD, 6 FMUL, 11 FMNMX, 2 FSETP and the predicated OR of the ray's bit),
// the 14 after the products on the ALU pipe, which issues at half the FP32
// rate. Its bytes are the key rows it writes (R / 32 x C x 4: 277 MB for a
// 2^20-ray wave on 2,116 clusters, 0.08 ms at 3.35 TB/s). The design:
//   * each block stages the whole box table once in shared memory, as six
//     rows (x, y, z of cmin, then of cmax) padded to a multiple of 32 with
//     NaN boxes, which no ray hits (53 KB at C = 2,197: dynamic shared
//     memory), then its warps walk their tasks (a persistent grid);
//   * a warp task is kRays tiles of 32 rays, lane l holding ray l of
//     each, so one broadcast 16-byte shared load (one coordinate of 4
//     boxes) feeds 4 kRays tests; 2 tiles (80 registers, 3 blocks an SM)
//     beat 1 and 4 (128 registers, 2 blocks an SM) on the card
//     (PERF.md);
//   * clusters are visited in ascending order, 32 at a time: a lane sets
//     bit j of its word for a tile when its ray hits cluster c0 + j; one
//     __reduce_or_sync a tile gives the tile's word, and the lanes of its
//     set bits write c0 + lane at count + popc(word & the lanes below):
//     one coalesced store of ascending ids, so no row is ever sorted;
//   * the rest of each row is filled with the sentinel, 32 ids a store.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;      // rays a kernel tile (one per lane)
constexpr int kWarps = 8;      // warps a block
// 32-ray tiles a warp task (rays a lane): 2 beat 1 and 4 on the card
constexpr int kRays = 2;
constexpr int kRows = 6;       // staged rows: cmin x, y, z, cmax x, y, z
constexpr int kSentinel = 0x7FFFFFFF;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// the torch passes' 1 / d, 3e38 where d is +0.0 or -0.0
__device__ __forceinline__ float inverse(float d) {
  return d == 0.0f ? 3e38f : __frcp_rn(d);
}

struct Ray {
  float ox, oy, oz, ix, iy, iz, tmin, tmax;
};

// the slab test of ops/cluster._slab_blocks / _slab_t_soa, step for step
__device__ __forceinline__ bool active(const Ray& r, float x0, float y0,
                                       float z0, float x1, float y1,
                                       float z1) {
  const float t0x = __fmul_rn(__fsub_rn(x0, r.ox), r.ix);
  const float t1x = __fmul_rn(__fsub_rn(x1, r.ox), r.ix);
  const float t0y = __fmul_rn(__fsub_rn(y0, r.oy), r.iy);
  const float t1y = __fmul_rn(__fsub_rn(y1, r.oy), r.iy);
  const float t0z = __fmul_rn(__fsub_rn(z0, r.oz), r.iz);
  const float t1z = __fmul_rn(__fsub_rn(z1, r.oz), r.iz);
  float tn = max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y));
  tn = max_nan(tn, min_nan(t0z, t1z));
  float tf = min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y));
  tf = min_nan(tf, max_nan(t0z, t1z));
  tn = max_nan(tn, r.tmin);
  return (tf >= tn) & (tn <= r.tmax);
}

// n_tasks = R / (32 kRays); cpad = C rounded up to 32.
__global__ void __launch_bounds__(kTile * kWarps)
    phase1_kernel(const float* __restrict__ rays8,
                  const float* __restrict__ cmin,
                  const float* __restrict__ cmax, int n_tasks, int n_boxes,
                  int cpad, int* __restrict__ counts,
                  int* __restrict__ keys) {
  extern __shared__ float4 smem[];
  float* box = reinterpret_cast<float*>(smem);
  for (int i = threadIdx.x; i < kRows * cpad; i += blockDim.x) {
    const int k = i / cpad;
    const int c = i - k * cpad;
    box[i] = c < n_boxes ? (k < 3 ? cmin : cmax)[c * 3 + k % 3]
                         : __int_as_float(0x7fc00000);
  }
  __syncthreads();
  const int lane = threadIdx.x & (kTile - 1);
  const unsigned below = (1u << lane) - 1u;
  for (int task = blockIdx.x * kWarps + (threadIdx.x >> 5); task < n_tasks;
       task += gridDim.x * kWarps) {
    Ray ray[kRays];
    int* row[kRays];
    int count[kRays];
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      const size_t tile = static_cast<size_t>(task) * kRays + r;
      const float4* p =
          reinterpret_cast<const float4*>(rays8 + (tile * kTile + lane) * 8);
      const float4 a = __ldg(p);
      const float4 b = __ldg(p + 1);
      ray[r] = Ray{a.x,        a.y,        a.z, inverse(a.w),
                   inverse(b.x), inverse(b.y), b.z, b.w};
      row[r] = keys + tile * n_boxes;
      count[r] = 0;
    }
    for (int c0 = 0; c0 < cpad; c0 += kTile) {
      unsigned bits[kRays];
#pragma unroll
      for (int r = 0; r < kRays; ++r) bits[r] = 0u;
#pragma unroll
      for (int j = 0; j < kTile; j += 4) {
        const float* b = box + c0 + j;
        const float4 x0 = *reinterpret_cast<const float4*>(b);
        const float4 y0 = *reinterpret_cast<const float4*>(b + cpad);
        const float4 z0 = *reinterpret_cast<const float4*>(b + 2 * cpad);
        const float4 x1 = *reinterpret_cast<const float4*>(b + 3 * cpad);
        const float4 y1 = *reinterpret_cast<const float4*>(b + 4 * cpad);
        const float4 z1 = *reinterpret_cast<const float4*>(b + 5 * cpad);
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
          if (active(ray[r], x0.x, y0.x, z0.x, x1.x, y1.x, z1.x))
            bits[r] |= 1u << j;
          if (active(ray[r], x0.y, y0.y, z0.y, x1.y, y1.y, z1.y))
            bits[r] |= 2u << j;
          if (active(ray[r], x0.z, y0.z, z0.z, x1.z, y1.z, z1.z))
            bits[r] |= 4u << j;
          if (active(ray[r], x0.w, y0.w, z0.w, x1.w, y1.w, z1.w))
            bits[r] |= 8u << j;
        }
      }
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        const unsigned word = __reduce_or_sync(kFull, bits[r]);
        if ((word >> lane) & 1u)
          row[r][count[r] + __popc(word & below)] = c0 + lane;
        count[r] += __popc(word);
      }
    }
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      for (int p = count[r] + lane; p < n_boxes; p += kTile)
        row[r][p] = kSentinel;
      if (lane == 0) counts[static_cast<size_t>(task) * kRays + r] = count[r];
    }
  }
}

}  // namespace

// rays8 (n_rays, 8) with n_rays a multiple of 128, cmin / cmax (n_boxes,
// 3); writes counts (n_rays / 32,) and keys (n_rays / 32, n_boxes).
// Returns the CUDA error of the launch (0 on success).
extern "C" int phase1_launch(const float* rays8, const float* cmin,
                             const float* cmax, int n_rays, int n_boxes,
                             int* counts, int* keys, void* stream) {
  if (n_rays > 0) {
    const int cpad = (n_boxes + kTile - 1) / kTile * kTile;
    const size_t smem = sizeof(float) * kRows * cpad;
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(phase1_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    int dev = 0, n_sm = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, phase1_kernel, kTile * kWarps, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int n_tasks = n_rays / (kTile * kRays);
    const int need = (n_tasks + kWarps - 1) / kWarps;
    const int cap = (per_sm > 0 ? per_sm : 1) * n_sm;
    phase1_kernel
        <<<need < cap ? need : cap, kTile * kWarps, smem,
           static_cast<cudaStream_t>(stream)>>>(
            rays8, cmin, cmax, n_tasks, n_boxes, cpad, counts, keys);
  }
  return static_cast<int>(cudaGetLastError());
}
