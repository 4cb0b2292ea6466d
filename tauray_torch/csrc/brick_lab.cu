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

#include <cuda_runtime.h>

#include "brick_walk.cuh"
#include "lab_common.cuh"

namespace {

template <int kLab, int kBody, int kVariant, int kTile, int R>
int launch_walk(const int* meta, const float* rays, const float* tris,
                int n_tiles, int n_clusters, int kb, int steps, float* out,
                cudaStream_t st) {
  brick_walk_kernel<kLab, kBody, kVariant, kTile, R>
      <<<(n_tiles + kTilesBlock - 1) / kTilesBlock, kTilesBlock * 32,
         kLab == 4 ? kL4Smem : 0, st>>>(meta, rays, nullptr, nullptr, tris,
                                        n_tiles, n_clusters, kb, steps, out);
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
