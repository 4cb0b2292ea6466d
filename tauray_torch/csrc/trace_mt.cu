// Front-to-back Möller-Trumbore cluster traversal for Hopper (sm_90a):
// one walk and one exit, flat (K2) and instanced (K3).
//
// Replaces these TPU kernels of tauray_tpu/ops/pallas_trace.py:
//   * _kernel / pallas_trace_tiles (K2): Möller-Trumbore over tris9, flat
//     scenes whose table exceeds the resident-table budget;
//   * _kernel_inst / pallas_trace_tiles_inst (K3): K2 over
//     cluster-instances, the instanced TLAS path;
// (The Baldwin-Weber kernels K1 and K4/K5 are csrc/trace_bw.cu.)
// It computes their contract, not their TPU schedule (no SMEM key ring, no
// key heads or overflow row, no double-buffered DMA, no G-tile grid):
//   * one warp per 32-ray tile, one thread per ray;
//   * the warp walks its tile's key row keys[tile, 0:counts[tile]], sorted
//     by (entry-t bits & ~idmask) | id, in steps of KB = 8 keys; each key's
//     128 triangles (9 floats each, 4.5 KB) are staged in the warp's slice
//     of shared memory and every thread tests its ray against them,
//     reading each component as a broadcast;
//   * K3 (kInst): key k names object cluster k_cluster[k] and instance
//     k_inst[k]; the ray is moved into that instance's space with its
//     world -> object 3x4 rows (direction unnormalized, so t stays in world
//     units) and the id is k * 128 + lane;
//   * after each step the WHOLE tile stops when every ray has
//     bits(best t) <= key[(step + 1) * KB] & ~idmask (no later cluster can
//     hold a closer hit) or, in any-hit mode, its best hit lies in an
//     all-opaque cluster. The decision is one warp vote, as the TPU kernel
//     takes it for the tile, because any-hit ids depend on it;
//   * optionally, the steps each tile walked (the step that set the vote
//     included; 0 for an empty tile): the TPU kernels' debug_steps output.
// Semantics kept from the TPU kernels: the arithmetic order of
// pallas_trace.py:170-189, the hit test (a != 0, u >= 0, v >= 0, u + v <= 1,
// t >= tmin, strict t < best), best t starting at min(tmax, 3e38), slots
// past the tile's count never tested, and a step's ties going to its first
// lane in key order (a running minimum with strict < over the keys in
// order gives the TPU's per-step argmin).
//
// What bounds it on the card: each (ray, triangle) test is 46 FP32
// operations, one of them a division, plus 9 shared-memory broadcasts, so
// the kernel is bound by the FP32 instruction rate; its bytes are one
// triangle block per (tile, cluster) visit, read from L2 and staged once
// per warp instead of once per ray. The front-to-back exit cuts the tests
// themselves.
//
// Built with -fmad=false so its arithmetic rounds exactly like the plain
// torch version (trace_kernel._mt_reference): ids and t compare bit for
// bit. Outputs: t (f32, +inf on miss) and the slot id (i32, -1 on miss) in
// separate arrays, so an id never passes through a float.

#include <cuda_runtime.h>

namespace {

constexpr int kCluster = 128;   // triangles per cluster
constexpr int kTile = 32;       // rays per tile = lanes per warp
constexpr int kStep = 8;        // keys per step (KB)
constexpr int kWarps = 4;       // tiles per block
constexpr float kBig = 3.0e38f;

template <bool kInst>
__global__ void __launch_bounds__(kTile * kWarps)
trace_mt_kernel(const int* __restrict__ counts,
                const int* __restrict__ keys, int key_stride,
                const float* __restrict__ rays8,
                const float* __restrict__ tris,
                const int* __restrict__ opaque,
                const int* __restrict__ k_cluster,
                const int* __restrict__ k_inst,
                const float* __restrict__ inv12,
                int n_tiles, int n_keys, int idmask, int any_hit,
                float* __restrict__ t_out, int* __restrict__ tid_out,
                int* __restrict__ steps_out) {
  // floats per triangle: [v0 | e1 | e2], each by lane
  constexpr int kComps = 9;
  __shared__ float4 tri[kWarps][kComps * kCluster / 4];
  const int warp = threadIdx.x / kTile;
  const int lane = threadIdx.x % kTile;
  const int tile = blockIdx.x * kWarps + warp;
  if (tile >= n_tiles) return;  // uniform per warp; only warp-level sync

  const size_t ray = static_cast<size_t>(tile) * kTile + lane;
  const float4 r0 = reinterpret_cast<const float4*>(rays8)[ray * 2];
  const float4 r1 = reinterpret_cast<const float4*>(rays8)[ray * 2 + 1];
  const float wox = r0.x, woy = r0.y, woz = r0.z;
  const float wdx = r0.w, wdy = r1.x, wdz = r1.y;
  const float tmin = r1.z, tmax = r1.w;
  float bt = tmax > kBig ? kBig : tmax;  // jnp.minimum keeps a NaN
  int bi = -1;
  int bopq = 0;

  const int count = counts[tile];
  const int* krow = keys + static_cast<size_t>(tile) * key_stride;
  const float* s = reinterpret_cast<const float*>(tri[warp]);
  const int steps = (count + kStep - 1) / kStep;
  int walked = 0;
  for (int step = 0; step < steps; ++step) {
    ++walked;
    const int jend = min(kStep, count - step * kStep);
    for (int j = 0; j < jend; ++j) {
      const int k = min(krow[step * kStep + j] & idmask, n_keys - 1);
      float ox = wox, oy = woy, oz = woz, dx = wdx, dy = wdy, dz = wdz;
      int c = k;
      if (kInst) {
        c = k_cluster[k];
        const float* iv = inv12 + static_cast<size_t>(k_inst[k]) * 12;
        ox = iv[0] * wox + iv[1] * woy + iv[2] * woz + iv[3];
        oy = iv[4] * wox + iv[5] * woy + iv[6] * woz + iv[7];
        oz = iv[8] * wox + iv[9] * woy + iv[10] * woz + iv[11];
        dx = iv[0] * wdx + iv[1] * wdy + iv[2] * wdz;
        dy = iv[4] * wdx + iv[5] * wdy + iv[6] * wdz;
        dz = iv[8] * wdx + iv[9] * wdy + iv[10] * wdz;
      }
      const int copq = any_hit ? opaque[k] : 0;
      const float4* src = reinterpret_cast<const float4*>(
          tris + static_cast<size_t>(c) * kComps * kCluster);
      __syncwarp();
      for (int i = lane; i < kComps * kCluster / 4; i += kTile)
        tri[warp][i] = src[i];
      __syncwarp();
      for (int m = 0; m < kCluster; ++m) {
        const float v0x = s[0 * kCluster + m], v0y = s[1 * kCluster + m];
        const float v0z = s[2 * kCluster + m], e1x = s[3 * kCluster + m];
        const float e1y = s[4 * kCluster + m], e1z = s[5 * kCluster + m];
        const float e2x = s[6 * kCluster + m], e2y = s[7 * kCluster + m];
        const float e2z = s[8 * kCluster + m];
        const float hx = dy * e2z - dz * e2y;
        const float hy = dz * e2x - dx * e2z;
        const float hz = dx * e2y - dy * e2x;
        const float a = e1x * hx + e1y * hy + e1z * hz;
        const float f = a != 0.0f ? 1.0f / a : 0.0f;
        const float sx = ox - v0x;
        const float sy = oy - v0y;
        const float sz = oz - v0z;
        const float uu = f * (sx * hx + sy * hy + sz * hz);
        const float qx = sy * e1z - sz * e1y;
        const float qy = sz * e1x - sx * e1z;
        const float qz = sx * e1y - sy * e1x;
        const float vv = f * (dx * qx + dy * qy + dz * qz);
        const float tt = f * (e2x * qx + e2y * qy + e2z * qz);
        const bool hit =
            a != 0.0f && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f;
        if (hit && tt >= tmin && tt < bt) {
          bt = tt;
          bi = k * kCluster + m;
          bopq = copq;
        }
      }
    }
    // the tile-level front-to-back exit (bit-space compare of t >= 0)
    const int next = krow[min((step + 1) * kStep, key_stride - 1)] & ~idmask;
    bool done = __float_as_int(bt) <= next;
    if (any_hit) done = done || (bi >= 0 && bopq > 0);
    if (__all_sync(0xffffffffu, done)) break;
  }
  t_out[ray] = bi < 0 ? __int_as_float(0x7f800000) : bt;
  tid_out[ray] = bi;
  if (steps_out != nullptr && lane == 0) steps_out[tile] = walked;
}

template <bool kInst>
void launch(const int* counts, const int* keys, int key_stride,
            const float* rays8, const float* tris, const int* opaque,
            const int* k_cluster, const int* k_inst, const float* inv12,
            int n_tiles, int n_keys, int idmask, int any_hit, float* t_out,
            int* tid_out, int* steps_out, cudaStream_t st) {
  const int blocks = (n_tiles + kWarps - 1) / kWarps;
  trace_mt_kernel<kInst><<<blocks, kTile * kWarps, 0, st>>>(
      counts, keys, key_stride, rays8, tris, opaque, k_cluster, k_inst,
      inv12, n_tiles, n_keys, idmask, any_hit, t_out, tid_out, steps_out);
}

}  // namespace

// tris holds tris9 (C, 9, 1, 128); k_cluster == nullptr selects the flat
// kernel (K2), else the instanced one (K3). steps_out (n_tiles,) may be
// nullptr. Returns the CUDA error of the launch (0 on success).
extern "C" int trace_mt_launch(const int* counts, const int* keys,
                               int key_stride, const float* rays8,
                               const float* tris, const int* opaque,
                               const int* k_cluster, const int* k_inst,
                               const float* inv12, int n_tiles, int n_keys,
                               int idmask, int any_hit, float* t_out,
                               int* tid_out, int* steps_out, void* stream) {
  if (n_tiles > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (k_cluster != nullptr) {
      launch<true>(counts, keys, key_stride, rays8, tris, opaque, k_cluster,
                   k_inst, inv12, n_tiles, n_keys, idmask, any_hit, t_out,
                   tid_out, steps_out, st);
    } else {
      launch<false>(counts, keys, key_stride, rays8, tris, opaque, k_cluster,
                    k_inst, inv12, n_tiles, n_keys, idmask, any_hit, t_out,
                    tid_out, steps_out, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
