#!/usr/bin/env python3
"""Smoke run of the torch port (tauray_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits
non-zero:
  1. the card's name and power limit (nvidia-smi); no CUDA -> error;
  2. build the traversal kernels (csrc/trace_tiles.cu, every instance of
     K1-K5), the K1 labs (csrc/k1_lab.cu), the brick labs
     (csrc/brick_lab.cu), the tile labs (csrc/tile_lab.cu) and the Plücker
     lab (csrc/mxu_lab.cu; one nvcc per source, started together) and print
     what ptxas reports, and the SASS of each K1-K5 instance's inner
     test loop (cuobjdump) and of the redesigned labs' L9, L4-L7 (each
     instance of the walk, L4's per body and TILE, L6's per variant and
     TILE), L10, L11 vpu and mxu, L12 mt (the walk's kLab 12 instance) and
     plucker and L1 k3, L2 and L3 (app/sass.lab_test_loops: instructions
     per test) and the registers of the walk and of L8's, L11's and L12's
     kernels; any spill or shared load narrower than 16 bytes in a test
     loop of trace_tiles fails, as does a spill in an instance of L8's,
     L9's, L4-L7's, L10's, L11's, L12's or L1-L3's kernel, or more than 128
     registers in L4-L7's;
  3. each kernel against its plain torch version, ids identical and t
     bit-identical (the kernels are built with -fmad=false), on 2^18-ray
     waves: a camera wave in pixel-block order and a signature-sorted
     random-direction wave leaving its hits, of
       3a. K1 (trace_vm3): proc://sponza?tris=262144, flat, plus the
           2^20-ray sorted bounce wave, a 32,768-ray slice of the foliage
           scene's sorted bounce wave (an alpha re-trace's size) and the
           duplicate-triangle wave (app/kernel_waves.tie_stack: exact ties
           across clusters, tiles of 0, 1, 10 and 29 clusters, NaN and
           t_max < t_min rays; 2^18 rays);
       3b. K2 (trace_mt): proc://sponza?tris=524288, flat (C > 2,197),
           plus its 2^20-ray sorted bounce wave and the duplicate-triangle
           wave;
       3c. K3 (trace_mt_inst): proc://sponza?tris=262144, per-model,
           plus the bounce wave unsorted, as the instanced path traces it,
           at 2^18 and 2^20 rays, and the duplicate triangles under two
           instances (app/kernel_waves.tie_stack_instanced);
       3d. K4 (trace_vm2): proc://sponza?tris=262144&foliage=1, flat (it
           has clusters that are not opaque), plus a signature-sorted
           shadow wave toward a point light (finite t_max);
       3e. K5 (trace_vm): the same waves with debug_steps, whose steps per
           tile equal the plain version's;
       3d and 3e also take the foliage scene's 2^20-ray sorted bounce
       wave, its 32,768-ray slice and the duplicate-triangle wave;
     K2-K5 run each wave as closest hit and as any hit (finite t_max);
  4. `python -m tauray_torch` main path: 1920x1080, 1 spp, depth 4,
     2 frames, headless EXR; checks the image and K1's launch count;
  5. the same scene at 256x256, 16 spp in one pass, depth 4;
  6. the main path with --as-strategy=per-model at 1920x1080: K3 launched,
     K1 never; the image is held to phase 4's;
  7. the main path on proc://sponza?tris=524288 at 1920x1080: K2 launched;
  8. the main path on the foliage scene at 1920x1080: (a) by default K1
     launched and the alpha rounds skip transparent hits; (b) under
     TAURAY_VM_KERNEL=v2 K4 launched and K1 never, the image held to (a)'s;
     both print each wave's pending rays at the start of each alpha round
     and after the last (path_tracer.ALPHA_PENDING);
  9. --sampler=sobol-owen on the foliage scene at 256x256, 4 spp;
  10. `python -m tauray_torch.app.wave_stats` at its default size: K5
     launched, one line per wave;
  11. the device scene update: the phase 4 scene with a keyframed
     translation on one entity, 3 frames through PathTracerRenderer
     (update_frame goes through device_update_frame); after each update
     the host path (host_update_frame) runs too and its triangle tables
     must agree within 1e-4 of scale; both update_frame times and the
     frame times are printed, K1 launched;
  12. the post stack through the CLI at 1920x1080, 1 spp, depth 4, 3
     frames, once each with --denoiser=svgf, --denoiser=bmfr,
     --temporal-reprojection=0.5 and --taa=8: K1 launched; the last
     frame's G-buffer and the pipeline's history go through post.process
     on the CPU too, held to the card's output by the CPU tests' rule
     (tests/test_torch_post.py); frame and post-stack ms;
  13. the 10 feature renderers at 1920x1080 through one FeatureRenderer:
     K1 launched; the 8x4-pixel blocks at every 32nd row and column traced
     again on the CPU, ray by ray: instance-id equal, the others within
     1e-4 of scale;
  14. `python -m tauray_torch.app.bench --cells=headline`: its JSON line;
  15. ReSTIR (renderer/restir_renderer.py, stages/restir*.py) and the
     restir-hybrid SH probe bake (renderer/sh_renderer.py):
       15a. `python -m tauray_torch --renderer=restir` at 1920x1080, depth
           4, 3 frames: each frame checked, its ms, the peak memory and
           K1's launches (raises if K1 never launched);
       15b. the same scene and camera at 240x135, 2 frames: the second
           frame's restir_di_pass and restir_gi_pass run again on the CPU
           from the card's inputs (the same previous reservoirs), their
           waves traced by the card's kernel, which phase 3 and 15e/15f
           hold bit for bit to the plain version (the plain tracer takes
           minutes a wave on the CPU here): where
           the kept sample agrees, integers exact and floats within 1e-3
           relative; the share of pixels whose kept sample differs, or
           whose result departs otherwise, at most HOLD_DI_OFF (0.1%) and
           HOLD_GI_OFF (0.5%);
       15c. the random replay and hybrid shifts at 256x256, depth 3, 2
           frames each, held to the CPU as in 15b;
       15d. --preset=restir-hybrid (SVGF and TAA on) on the scene with an
           8x8x8 SH grid added over its bounds, 1920x1080, 3 frames: bake
           ms per frame; the last frame's bake runs again on the CPU from
           the card's previous coefficients (waves as in 15b) and is held
           to the card's;
       15e. one --renderer=restir frame of proc://sponza?tris=524288 at
           256x256: K2 launched; each of the frame's 10 waves, as traced
           (unsorted; the DI and GI visibility waves any hit with finite
           t_max), held bit for bit to K2's plain version;
       15f. a second frame of 15a's run, built as 15b builds it: each of
           its 10 waves of 2,073,600 rays (G-buffer, DI temporal and final
           visibility, GI bounces, NEE and final visibility), unsorted as
           traced, held bit for bit to K1's plain version;
  16. the raster renderer (renderer/raster_renderer.py, stages/raster.py,
     stages/shadow_map.py, ops/brdf_lut.py) and DSHGI
     (renderer/dshgi_renderer.py, net/dshgi.py):
       16a. `python -m tauray_torch --renderer=raster` at 1920x1080 with
           the defaults (2048^2 maps, 4 cascades, --pcf=64, --pcss=32, 1
           sample per pixel), 2 frames: each frame checked, its ms split
           into the shadow maps and the draw, the peak memory and K1's
           launches, which must equal the count the code gives (every map
           at set_scene and at update_frame, a camera wave a frame);
       16b. frame 2's waves of 16a, as traced (16 maps of 4,194,304 rays:
           the sun's 4 cascades of parallel rays and two omni lights' 6
           cube faces, each sharing an origin; the camera wave of
           2,073,600), each held bit for bit to K1's plain version;
       16c. frame 2's render_raster again on the CPU from the card's maps,
           camera and scene, its camera wave traced by the card's kernel:
           at most HOLD_RASTER_OFF (0.1%) of the pixels with shadow_vis off
           by more than one PCF tap (1/64) or another value by more than
           1e-4 of its key's scale;
       16d. --preset=ddish-gi (renderer dshgi, depth 4, 512 samples a
           probe, 8 samples per pixel: a shaded pass and 8 coverage waves;
           its 4096^2 maps clamp to 2048^2) on the scene with an 8x8x8 SH
           grid over its bounds, 1920x1080, 3 frames: ms split into bake,
           maps and draw, K1's launches; the last bake held to a CPU bake
           as in 15d; the grid through net/dshgi's message and back, bit
           for bit;
       16e. one raster frame of the foliage scene at 1920x1080: its maps
           traced through trace_alpha (cutoff 0.5) and the alpha rounds;
           K1's launches equal the count the code gives;
       16f. one raster frame of proc://sponza?tris=524288 at 1920x1080
           with 1024^2 maps: K2's launches equal the count the code gives,
           and each of its 17 waves, as traced, held bit for bit to K2's
           plain version;
  17. multi-device rendering on the one card (renderer/distributed.py,
     parallel/, the probe-sharded bake of renderer/sh_renderer.py):
       17a. `python -m tauray_torch --fake-devices=4` (shuffled strips) at
           1920x1080, depth 4, 2 frames: ms, lane Mrays/s (ops/cluster
           TRACED), peak memory and K1's launches; frame 1 held to a
           one-device PathTracerRenderer frame of the same options (at
           most HOLD_DIST_OFF, 0.01%, of the pixels off by more than
           1e-3; the largest difference and the pixels not bit-equal
           printed);
       17b. skewed times into LoadBalancer.update between two frames of
           4 workloads with --accumulation: the new shares cover every
           pixel once and the second frame is held to the one-device
           2-frame accumulation by 17a's rule; one frame of scanline over
           3 workloads (interleaved rows) held to the one-device frame;
       17c. the bench's quilt_5x9 (45 views at 256x256, depth 2)
           view-sharded over [cuda:0] * 4, held to the one-device render
           of the same views by 17a's rule; ms per view and K1's launches;
       17d. the probe-sharded bake (an 8x8x8 grid, --preset=ddish-gi's
           512 samples a probe) over [cuda:0] * 2, held to the one-device
           bake within 1e-5 of the largest coefficient;
  18. Looking Glass, the interactive frame stream and --validation:
       18a. `python -m tauray_torch --display=looking-glass` with 8 views
           at 256x256: one image per view; compose_quilt and lkg_compose
           of those views on the card held bit-equal to the CPU;
       18b. the interactive viewer streaming to a loopback FrameClient,
           which takes 3 frames of the right size, not all zero, then
           sends a key, a mouse move and quit;
       18c. --validation passes a clean frame and, with a NaN injected
           into the shading's input, raises naming bounce 0's shading;
  19. the native host library (tauray_torch/native, built with g++): a
     seeded 1024x512 sky written as a half RGB PIZ EXR with the port's
     writer (the headless default; timed), read back through the native
     Huffman decoder and under TAURAY_NATIVE=0 (timed, bit-equal to each
     other and to the sky in half), then one frame at 1920x1080 through
     the CLI without and with --envmap=<that file>: the image checked,
     more than a tenth of its pixels off the frame without the map by
     more than 1e-3, the map's 16 chunks decoded natively, K1 launched;
  20. the K1 labs (tauray_torch/lab, the counterparts of
     scripts/kernel_lab8-11.py) through their entry points' run() at the
     scripts' sizes, every mode timed (CUDA events) with its bound, each
     lab's launches counted over that run alone: L8 (2^20 rays, modes
     0-3; also back to back and by CUDA-graph replay, lab/common.time_graph,
     which leaves the wrapper's host path out; bit for bit), L9 (2^20
     rays on phase 3's Sponza table, 5 modes at 1, 2 and 4
     steps a tile), L10 (phase 3's sorted 2^18- and 2^20-ray bounce
     waves, 4 modes), L11 (4,096 tiles x 8 steps, vpu and mxu); then each
     mode held to its plain version on the same inputs, bit for bit (L9
     and L10 on 32,768 rays of each input), L11 vpu (FMA body) by
     kernel_lab11.vpu_agreement (the rules of L9's below), L11 mxu
     tie-aware (t within
     1e-5 of max(1, |t|), or on at most 1e-4 of the rays, ill-conditioned,
     within the TF32 split's error bound of t in FP64; a differing id only
     at a tie; kernel_lab11.mxu_agreement), L9's modes with a test (FMA
     body) by kernel_lab9.lab9_agreement (t within the two bodies' rounding
     bound, ids equal or at an FP64 tie, or on at most 1e-4 of the rays a
     verdict that rounding decides, each such ray printed), L9 loads bit
     for bit, exit and nocat equal to full on the card (lab9_exits: no
     tile could exit early), L9 full again on rays whose denominator
     leaves the in-range reciprocal's range (subnormal: the step redone
     with __frcp_rn; 0; NaN); L10 (FMA body) by
     kernel_lab10.lab10_agreement, the same rules (nowrite bit for bit to
     what its kernel's full computes), full also to K1 (trace_vm3) on both
     whole waves, and K1 and L10 full timed in turns (K1, L10, L10, K1) on
     each wave, with their ratio and the wave's spread of clusters a tile;
  21. the brick and resident-table labs (tauray_torch/lab, the
     counterparts of scripts/kernel_lab2-5.py; csrc/brick_lab.cu, built
     in phase 2, which prints each instance's SASS instructions per test)
     through their entry points' run() at the scripts' sizes, every
     configuration of each main timed (median and min of 5 CUDA-event
     runs of one call, and of 5 windows of 20 calls back to back) with its
     bound, the launches counted over that run alone: L4 (k6, k7, k6f, k7f
     at KB 4, 8, 16), L5 (TILE 8, 16, 32 x KB 1, 2, 4, 8), L6 (5 variants
     x 3 shapes), L7 (mt and bw x 3); each held to its plain version (one
     walk, the FMA bodies): L4 mt, L5-L7 by brick.brick_agreement (phase
     20's rule; L4-L6 on all 65,536 rays, L7 on 1,024 tiles of each), L4
     mtfast by brick.mtfast_agreement (t's bits within a key quantum, two
     where both keys carry bit 10, the sign of t equal on every ray, ids
     equal but on at most 1e-4 of the rays where FP64 puts a winner's test
     or the keys' order within rounding of turning), and again with
     subnormal and NaN denominators (L4 mt and mtfast at k7 KB 4, L5 at
     TILE 32 KB 1 and TILE 8 KB 1, L6's five variants at its headline
     shape, L7 at KB 8 steps 6); mtfast's rays with t < 0 counted beside
     the plain version's, and L6 while / while2 on a meta where the exit
     fires, held
     the same way with the steps walked per tile (brick.walked_steps) held
     to the plain version's, and walking fewer steps and hitting less than
     fixed;
  22. the 128-ray tile labs and the Plücker lab (tauray_torch/lab, the
     counterparts of scripts/kernel_lab.py and mxu_lab.py; csrc/tile_lab.cu
     and csrc/mxu_lab.cu, built in phase 2) through kernel_lab.run and
     mxu_lab.run at the scripts' sizes, the launches counted over that run
     alone: L1 k0 and k1 at 0 and 1 steps, k2 and k3 at 0, 1, 2, 4 and 8,
     L2 (k4) and L3 (k5 at G 8 and 32) at the same steps, L12 mt and
     plucker; each timed (median and min of 5 CUDA-event runs of one call;
     also back to back, 5 windows of 20 calls; L1 k0-k2 also by CUDA-graph
     replay) with its bound and held to its plain version: L1 k0-k2 bit
     for bit; L12 mt (the brick walk's FMA body) by mxu_lab.mt_agreement
     (phase 21's rule) on all 65,536 rays, and again on odd denominators
     (subnormal, 0, NaN); k3, k4 and k5 (one template, the FMA body) by
     kernel_lab.lab3_agreement;
     plucker by mxu_lab.plucker_agreement (t within 1e-5 of max(1, |t|),
     ids equal or at a tie, as L11; or, on at most 1e-4 of the rays, where
     the two sides' verdicts on one winner's test differ and FP64 puts
     that test within rounding of turning, with t within its bound of the
     FP64 t of the kernel's triangle; each such ray printed with its
     margin); k4 and k5 equal to k3 bit for bit at each step count on the
     script's meta, and on a meta whose tnear third is 0x7f000000 their
     exit firing after one step (fewer hits than k3), held the same way
     with the steps walked per tile (kernel_lab.walked_steps) held to the
     plain version's; k3, k4 and k5 again on odd denominators; the
     intercept and slope over steps of k2-k5 of ms and of ms back to back.
The last lines are the card, the kernel table (each K row also with W, the
SASS instructions per test, the bound under the -fmad=false contract and
the number of waves held; K1 and K2 with the ReSTIR and the raster waves'
times; K1 with its launches on 17a's and 17c's paths; each lab row with
its modes or configurations), and {"ok": true, "device": {...}}.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENE = "proc://sponza?tris=262144"
# 502,528 triangles, >= 3,926 clusters: past the 2,197 clusters of the
# id-only key path, so the flat tracer takes entry-t keys and K2
SCENE_LARGE = "proc://sponza?tris=524288"
# the Sponza-class scene with alpha-cutout leaf cards (2,128 clusters, 9 of
# them not opaque): still on the Baldwin-Weber path (C <= 2,197)
SCENE_FOLIAGE = "proc://sponza?tris=262144&foliage=1"
# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): FP32 outside
# the tensor cores, and HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per (ray, triangle) test, counted in csrc/trace_tiles.cu:
# Baldwin-Weber 32, Möller-Trumbore 46; and K3's transform of a ray into a
# key's instance space, 33 per (ray, key) (9 products and 9 sums for the
# origin, 9 products and 6 sums for the direction)
FLOPS_BW = 32
FLOPS_MT = 46
FLOPS_XFORM = 33
LANES_1080P = 2097152 * 1 * (2 * 4 - 1)   # padded pixels x spp x waves
# the share of pixels whose restir pass on the card may depart from the
# CPU's in phases 15b and 15c; sound runs read at most 3.1e-5 (DI) and
# 1.24e-3 (GI) (PERF.md), and tests/test_torch_smoke_holds.py reads what a
# lost hit on 1 ray in 64 gives
HOLD_DI_OFF = 1e-3
HOLD_GI_OFF = 5e-3


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn over reps calls after one warm-up call (CUDA
    events)."""
    fn()
    return timed(fn, reps)[1]


def timed(fn, reps: int = 1):
    """(fn's last result, mean ms over reps calls), CUDA events."""
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b) / reps


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi), Hz."""
    return 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def ptxas_lines(log: str):
    """What ptxas reports per kernel: entry, registers, shared, spills."""
    return [ln.strip() for ln in log.splitlines()
            if re.search(r"registers|spill|Compiling entry", ln)]


# trace_tiles_kernel<W, kExit, kRows, kInst>'s mangled template arguments
_TARGS = re.compile(r"trace_tiles_kernelILi(\d+)ELb([01])ELi(\d+)ELb([01])E")
# each wrapper's instance: (kExit, kRows, kInst)
INSTANCE = {"trace_vm3": (0, 12, 0), "trace_vm2": (1, 12, 0),
            "trace_vm": (1, 12, 0), "trace_mt": (1, 9, 0),
            "trace_mt_inst": (1, 9, 1)}


def sass_loops(lib_path: str):
    """{kernel: stats of its inner test loop} from cuobjdump -sass: of the
    innermost loops, the one holding the most shared-load words, with its
    instructions, 16-byte (LDS.128) and narrower shared loads, the tests
    one pass makes (shared words / the 12 Baldwin-Weber or 9
    Möller-Trumbore components of a triangle, the instance's kRows
    template argument) and instructions per test."""
    from tauray_torch.app import sass as sass_mod
    out = {}
    for name, chunk in sass_mod.functions(lib_path).items():
        best = None
        for body in sass_mod.inner_loops(chunk):
            lds128 = sum(bool(re.match(r"(@!?P\d+\s+)?LDS\.128\b", o))
                         for o in body)
            lds64 = sum(bool(re.match(r"(@!?P\d+\s+)?LDS\.64\b", o))
                        for o in body)
            lds32 = sum(bool(re.match(r"(@!?P\d+\s+)?LDS(\.U?32)?\s", o))
                        for o in body)
            words = 4 * lds128 + 2 * lds64 + lds32
            if best is None or words > best["words"] or (
                    words == best["words"] and len(body) < best["insns"]):
                best = dict(insns=len(body), words=words, lds128=lds128,
                            lds_narrow=lds64 + lds32)
        if best is None or best["words"] == 0:
            continue
        targs = _TARGS.search(name)
        if targs is None:
            raise RuntimeError(f"no template arguments in {name}")
        tests = best["words"] / int(targs.group(3))
        out[name] = dict(loop_instructions=best["insns"],
                         lds128=best["lds128"],
                         lds_narrow=best["lds_narrow"], tests=tests,
                         instructions_per_test=best["insns"] / tests)
    return out


def bound(flops: float, nbytes: float):
    """(least ms the card could take, what sets it)."""
    f_ms = flops / PEAK_FP32 * 1e3
    b_ms = nbytes / PEAK_BYTES * 1e3
    return (f_ms, "operations") if f_ms >= b_ms else (b_ms, "bytes")


def hits(t) -> int:
    import torch
    return int(torch.isfinite(t).sum())


def _compare(name, t_k, id_k, t_r, id_r):
    """(ids identical, t bit-identical, max |t_k - t_r| over hits)."""
    import torch
    same_id = bool(torch.equal(id_k, id_r))
    same_t = bool(torch.equal(t_k.view(torch.int32), t_r.view(torch.int32)))
    fin = torch.isfinite(t_r)
    err = float((t_k[fin] - t_r[fin]).abs().max()) if fin.any() else 0.0
    if not torch.equal(torch.isfinite(t_k), fin):
        err = float("inf")
    if not (same_id and same_t):
        raise RuntimeError(f"kernel disagrees with plain version on the "
                           f"{name} wave (ids {same_id}, t {same_t})")
    return same_id, same_t, err


def kernel_check(tracer, waves, reps: int = 5, tag: str = "3a K1",
                 plain_slice=None):
    """K1 vs its plain version on each wave; returns per-wave results.
    plain_slice: run the plain version over slices of that many tiles
    (the same per-tile work, in less memory)."""
    import torch
    from tauray_torch.ops.cluster import _phase1
    from tauray_torch.ops.trace_kernel import (trace_tiles_vm3,
                                               trace_tiles_vm3_reference)
    out = {}
    C = tracer.n_clusters

    def plain(counts, keys, r3, tris12):
        n = plain_slice or counts.shape[0]
        parts = [trace_tiles_vm3_reference(counts[a:a + n], keys[a:a + n],
                                           r3[a:a + n], tris12)
                 for a in range(0, counts.shape[0], n)]
        return tuple(torch.cat(x) for x in zip(*parts))
    for name, rays8 in waves.items():
        counts, keys = _phase1(tracer, rays8)
        r3 = rays8.reshape(-1, 32, 8)
        args = (counts, keys, r3, tracer.tris12)
        t_k, id_k = trace_tiles_vm3(*args)
        (t_r, id_r), plain_ms = timed(lambda: plain(*args))
        same_id, same_t, err = _compare(name, t_k, id_k, t_r, id_r)
        ms = cuda_ms(lambda: trace_tiles_vm3(*args), reps)
        n_tiles, R = counts.shape[0], rays8.shape[0]
        visits = int(counts.sum())
        bound_ms, bound_by = bound(
            visits * 128 * 32 * FLOPS_BW,
            4 * (n_tiles + visits) + 32 * R + C * 12 * 128 * 4 + 8 * R)
        out[name] = dict(rays=R, hits=hits(t_r),
                         clusters_per_tile=visits / n_tiles,
                         tests=visits * 128 * 32,
                         ids_identical=same_id, t_bit_identical=same_t,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        print(f"phase {tag} [{name}] " + json.dumps(out[name]), flush=True)
    return out


def kernel_check_mt(tracer, waves, kind: str, reps: int = 5, traced=None,
                    tag=None):
    """K2 (flat), K3 (instanced), K4 (trace_vm2) or K5 (trace_vm with
    debug_steps) against the plain version on each wave, as closest hit
    and as any hit; K2, K3 and K5 also with their steps per tile held to
    the plain version's (K2/K3 through _launch_mt's debug_steps). The any
    hit runs take finite t_max: half to 1.5x each ray's closest hit, 20 on
    a miss, except the shadow and duplicate-triangle waves, which keep
    their own. traced: {wave: any_hit} of waves captured from a renderer,
    each run once, in the mode and with the t_max it was traced with.
    Returns per-(wave, mode) results."""
    import numpy as np
    import torch
    from tauray_torch.ops import trace_kernel as tk
    from tauray_torch.ops.cluster import _phase1_entry
    C = tracer.n_clusters
    if kind == "K3":
        tables = (tracer.tris9, tracer.opaque, tracer.k_cluster,
                  tracer.k_inst, tracer.inv.reshape(-1, 12).contiguous())
        kern, ref = tk.trace_tiles_inst, tk.trace_tiles_inst_reference
        name_tag, flops_test = "3c K3", FLOPS_MT
        table_bytes = (tracer.tris9.numel() * 4 + C * 12 +
                       tracer.inv.numel() * 4)
    elif kind == "K2":
        tables = (tracer.tris9, tracer.opaque)
        kern, ref = tk.trace_tiles, tk.trace_tiles_reference
        name_tag, flops_test = "3b K2", FLOPS_MT
        table_bytes = tracer.tris9.numel() * 4 + C * 4
    else:
        tables = (tracer.tris12, tracer.opaque)
        kern = tk.trace_tiles_vm2 if kind == "K4" else tk.trace_tiles_vm

        def ref(*a, stats):
            return tk.trace_tiles_vm2_reference(*a, stats=stats)[:2]
        name_tag = "3d K4" if kind == "K4" else "3e K5"
        flops_test = FLOPS_BW
        table_bytes = tracer.tris12.numel() * 4 + C * 4
    tag = tag or name_tag
    out = {}
    rng = np.random.default_rng(7)
    for name, rays8 in waves.items():
        closest_t = None
        for any_hit in (traced[name],) if traced else (False, True):
            r8 = rays8
            if any_hit and not traced and name not in ("shadow", "ties"):
                scale = torch.from_numpy(rng.uniform(
                    0.5, 1.5, r8.shape[0]).astype(np.float32)).to(r8.device)
                r8 = r8.clone()
                r8[:, 7] = torch.where(torch.isfinite(closest_t),
                                       closest_t * scale, 20.0)
            counts, keys, idmask = _phase1_entry(tracer.cmin, tracer.cmax,
                                                 r8)
            r3 = r8.reshape(-1, 32, 8)
            args = (counts, keys, r3, *tables, idmask, any_hit)
            steps_k = None
            if kind == "K5":
                t_k, id_k, steps_k = kern(*args, debug_steps=True)
            else:
                t_k, id_k = kern(*args)
            if kind in ("K2", "K3"):
                steps_k = tk._launch_mt(counts, keys, r3, *tables[:2],
                                        tables[2:] or None, idmask, any_hit,
                                        debug_steps=True)[2]
            stats = {}
            (t_r, id_r), plain_ms = timed(lambda: ref(*args, stats=stats))
            key = f"{name}/{'any' if any_hit else 'closest'}"
            same_id, same_t, err = _compare(key, t_k, id_k, t_r, id_r)
            extra = {}
            if steps_k is not None:
                if not torch.equal(steps_k, stats["tile_steps"]):
                    raise RuntimeError(f"{kind} steps per tile disagree "
                                       f"with the plain version on {key}")
                extra = dict(steps_identical=True,
                             steps_mean=float(steps_k.float().mean()))
            if not any_hit:
                closest_t = t_r
            ms = cuda_ms(lambda: kern(*args), reps)
            n_tiles, R = counts.shape[0], r8.shape[0]
            visits = stats["clusters"]
            flops = visits * 32 * (128 * flops_test + (FLOPS_XFORM
                                                       if kind == "K3"
                                                       else 0))
            nbytes = (4 * (n_tiles + visits + stats["steps"]) + 32 * R +
                      table_bytes + 8 * R)
            bound_ms, bound_by = bound(flops, nbytes)
            out[key] = dict(
                rays=R, hits=hits(t_r),
                clusters_per_tile=float(counts.float().mean()),
                clusters_tested_per_tile=visits / n_tiles,
                tests=visits * 128 * 32,
                steps_skipped_share=1 - stats["steps"] / max(
                    stats["steps_total"], 1),
                ids_identical=same_id, t_bit_identical=same_t,
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, **extra)
            print(f"phase {tag} [{key}] " + json.dumps(out[key]),
                  flush=True)
    return out


@contextlib.contextmanager
def alpha_rays():
    """Counts the rounds of the path tracer's alpha re-trace program, the
    rays they skip past a transparent hit, and each wave's pending rays at
    the start of each round it runs and after the last
    (path_tracer.ALPHA_PENDING; summed on the card, read once at the end):
    yields a dict filled on exit."""
    import torch
    from tauray_torch.stages import path_tracer as pt
    impl = pt._alpha_skip_impl
    acc = []
    counts = {}

    def counting(*a, **k):
        out = impl(*a, **k)
        acc.append(out[0].sum())
        return out
    pt._alpha_skip_impl = counting
    pt.ALPHA_PENDING = []
    try:
        yield counts
    finally:
        pt._alpha_skip_impl = impl
        pending, pt.ALPHA_PENDING = pt.ALPHA_PENDING, None
        counts.update(rounds=len(acc),
                      skipped=int(torch.stack(acc).sum()) if acc else 0,
                      pending=[[r] + p.tolist() for r, p in pending])


def run_main(args, tmp, tag, scene=SCENE, every=False):
    """python -m tauray_torch's main() with frame timing to a file.
    Returns (host ms per frame, image (H, W, C) of the last frame, or the
    list of every frame's with every=True)."""
    from tauray_torch.app.main import main
    from tauray_torch.io.exr import read_rgb
    from tauray_torch.log import logger
    timing = os.path.join(tmp, f"{tag}_timing.txt")
    prefix = os.path.join(tmp, tag)
    rc = main(args + [f"--headless={prefix}", "--timing",
                      f"--timing-output={timing}", "--compression=zip",
                      scene])
    logger.timing.stream.close()
    logger.timing.stream = None
    if rc != 0:
        raise RuntimeError(f"main() returned {rc}")
    with open(timing) as f:
        ms = [float(m) for m in re.findall(r"HOST: ([0-9.]+)ms", f.read())]
    frames = sorted((n for n in os.listdir(tmp)
                     if re.fullmatch(re.escape(tag) + r"\d+\.exr", n)),
                    key=lambda n: int(n[len(tag):-4]))
    if every:
        return ms, [read_rgb(os.path.join(tmp, n)) for n in frames]
    return ms, read_rgb(os.path.join(tmp, frames[-1]))


def check_image(img, w, h, tag):
    import numpy as np
    rgb = np.asarray(img)[..., :3]
    if rgb.shape != (h, w, 3) or not np.isfinite(rgb).all() or \
            not rgb.mean() > 0:
        raise RuntimeError(f"{tag}: bad image {rgb.shape}, finite="
                           f"{np.isfinite(rgb).all()}, mean={rgb.mean()}")
    return float(rgb.mean())


def main_path(tmp, tag, args, scene=SCENE, every=False):
    """Drive the CLI once with every launch count at 0 just before and
    read just after. Returns (ms per frame, image (or every frame's),
    launches, peak GiB)."""
    import torch
    from tauray_torch.ops import trace_kernel
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trace_kernel.reset_launch_counts()
    ms, img = run_main(args, tmp, tag, scene, every)
    launches = dict(trace_kernel.LAUNCHES)
    return ms, img, launches, torch.cuda.max_memory_allocated() / 2**30


HD_W, HD_H = 1920, 1080
HD = ["--renderer=path-tracer", f"--width={HD_W}", f"--height={HD_H}",
      "--samples-per-pixel=1", "--max-ray-depth=4", "--tonemap=linear",
      "--frames=2"]


def sync_ms(fn):
    """(fn's result, host ms of fn to a device synchronize)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def agree(got, want, atol: float = 1e-4):
    """tests/test_torch_post.py's rule: the share of elements within
    atol + 1e-3 x |want| (NaN matching NaN), and the two means over the
    finite elements. Returns (share, mean got, mean want, ok)."""
    import numpy as np
    ok = (np.abs(got - want) <= atol + 1e-3 * np.abs(want)) | \
        (np.isnan(got) & np.isnan(want))
    fin = np.isfinite(got) & np.isfinite(want)
    mg, mw = float(got[fin].mean()), float(want[fin].mean())
    share = float(ok.mean())
    good = bool((np.isnan(got) == np.isnan(want)).all()) and \
        share >= 0.995 and abs(mg - mw) <= 1e-3 * max(abs(mw), 1e-3)
    return share, mg, mw, good


def slide(scene):
    """A keyframed translation on the scene's first model entity, as
    tests/test_camera_anim.py animates its floor; plays it."""
    import numpy as np
    from tauray_torch.scene import animation as anim
    e = next(e for e in scene.entities if e.model is not None)
    a = anim.Animation()
    a.add_channel("translation", anim.AnimationChannel(
        times=np.array([0.0, 1.0], np.float32),
        values=np.array([[0, 0, 0], [0.5, 0.2, -0.3]], np.float32)))
    e.animations = {"slide": a}
    anim.play(scene, "slide", False)


def device_update_phase():
    """Phase 11; returns K1's launches."""
    import numpy as np
    import torch
    from tauray_torch.app.main import create_renderer, load_scenes
    from tauray_torch.ops import trace_kernel
    from tauray_torch.options import parse_command_line_options
    from tauray_torch.scene import animation as anim
    opt = parse_command_line_options(HD + ["--headless=unused",
                                           "--filetype=none", SCENE])
    scene = load_scenes(opt)
    slide(scene)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trace_kernel.reset_launch_counts()
    rr = create_renderer(opt, scene, torch.device("cuda"))
    rr.set_scene(scene)
    res = dict(size=f"{HD_W}x{HD_H}", spp=1, depth=4, frame_ms=[],
               update_ms_device=[], update_ms_host=[], worst_rel=0.0)
    for k in range(3):
        if k:
            anim.update(scene, 250000, True)
            _, ms = sync_ms(rr.update_frame)
            res["update_ms_device"].append(ms)
            dev_scene, dev_bvh = rr.device_scene, rr.bvh
            host_bvh, ms = sync_ms(
                lambda: rr.host_update_frame(dev_bvh, rr._perm))
            res["update_ms_host"].append(ms)
            for name in ("tri_pos", "tri_normal", "tri_tangent",
                         "tri_hard_normal"):
                want = getattr(rr.device_scene, name)
                d = float((getattr(dev_scene, name) - want).abs().max())
                rel = d / (float(want.abs().max()) + 1.0)
                res["worst_rel"] = max(res["worst_rel"], rel)
                if rel >= 1e-4:
                    raise RuntimeError(f"phase 11: device {name} departs "
                                       f"from the host path's by {d}")
            for name in ("cmin", "cmax"):
                d = float((getattr(dev_bvh, name) -
                           getattr(host_bvh, name)).abs().max())
                if d > 1e-3:
                    raise RuntimeError(f"phase 11: refit {name} off by {d}")
            rr.device_scene = dev_scene
        rr.reset_accumulation()
        img, ms = sync_ms(rr.render_device)
        res["frame_ms"].append(ms)
        check_image(img[0].cpu().numpy(), HD_W, HD_H, f"phase 11 frame {k}")
    res.update(launches=dict(trace_kernel.LAUNCHES),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    print("phase 11 " + json.dumps(res), flush=True)
    if res["launches"]["trace_vm3"] <= 0:
        raise RuntimeError("phase 11 never launched trace_vm3")
    return res["launches"]["trace_vm3"]


@contextlib.contextmanager
def post_capture(last: int):
    """Times every PostProcessingPipeline.process call (CUDA events around
    it) and, on call number `last` (from 0), records the history before
    it, the G-buffer and the output as numpy arrays. Yields the record;
    post_ms is filled on exit."""
    import numpy as np
    import torch
    from tauray_torch.renderer import post_processing as pp
    orig = pp.PostProcessingPipeline.process
    rec = {"events": []}

    def process(self, gbuf, cam_origin=None):
        keep = len(rec["events"]) == last
        if keep:
            rec["state"] = pp.post_state_numpy(self)
            rec["gbuf"] = {k: v.cpu().numpy() for k, v in gbuf.items()}
            rec["cam_origin"] = np.array(cam_origin)
            rec["opt"], rec["shape"] = self.opt, (self.W, self.H, self.V)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = orig(self, gbuf, cam_origin)
        b.record()
        rec["events"].append((a, b))
        if keep:
            rec["out"] = out.cpu().numpy()
        return out
    pp.PostProcessingPipeline.process = process
    try:
        yield rec
    finally:
        pp.PostProcessingPipeline.process = orig
        torch.cuda.synchronize()
        rec["post_ms"] = [a.elapsed_time(b) for a, b in rec["events"]]


def post_phase(tmp):
    """Phase 12; returns K1's launches of its first run."""
    import numpy as np
    import torch
    from tauray_torch.renderer.post_processing import PostProcessingPipeline
    l_k1 = None
    for flag in ("--denoiser=svgf", "--denoiser=bmfr",
                 "--temporal-reprojection=0.5", "--taa=8"):
        args = HD[:-1] + ["--frames=3", flag]
        # the third frame's copies to the host count in its frame_ms
        with post_capture(2) as rec:
            ms, img, launches, peak = main_path(tmp, "post", args)
        check_image(img, HD_W, HD_H, f"phase 12 {flag}")
        if launches["trace_vm3"] <= 0 or len(rec["post_ms"]) != 3:
            raise RuntimeError(f"phase 12 {flag}: launches {launches}, "
                               f"{len(rec['post_ms'])} post calls")
        l_k1 = l_k1 or launches["trace_vm3"]
        # the last frame's post stack again on the CPU, from the same
        # history and G-buffer
        W, H, V = rec["shape"]
        cpu = PostProcessingPipeline(rec["opt"], W, H, V, "cpu")
        cpu.load_state_numpy(rec["state"])
        (want, cpu_ms) = sync_ms(lambda: cpu.process(
            {k: torch.from_numpy(v) for k, v in rec["gbuf"].items()},
            cam_origin=rec["cam_origin"]).numpy())
        atol = 2e-3 * float(np.abs(want).max()) if "bmfr" in flag \
            else 1e-4
        share, mg, mw, good = agree(rec["out"], want, atol)
        print("phase 12 " + json.dumps(dict(
            size=f"{HD_W}x{HD_H}", spp=1, depth=4, option=flag, frame_ms=ms,
            post_ms=rec["post_ms"], launches=launches, peak_mem_gb=peak,
            image_mean=float(np.asarray(img)[..., :3].mean()),
            cpu_share_within_tol=share, mean_card=mg, mean_cpu=mw,
            cpu_post_ms=cpu_ms)), flush=True)
        if not good:
            raise RuntimeError(f"phase 12 {flag}: the card's post stack "
                               f"departs from the CPU's ({share})")
        del rec
    return l_k1


def to_cpu(tracer):
    """The flat tracer's tables on the CPU (tracer_from_numpy)."""
    from tauray_torch.ops.cluster import tracer_from_numpy
    fields = {k: getattr(tracer, k).cpu().numpy() for k in (
        "v0", "e1", "e2", "tri_valid", "to_orig", "cmin", "cmax", "opaque")}
    fields.update(n_clusters=tracer.n_clusters,
                  alpha_base=tracer.alpha_base, slot_ids=tracer.slot_ids)
    return tracer_from_numpy(fields, "cpu")


def feature_phase():
    """Phase 13; returns K1's launches."""
    import numpy as np
    import torch
    from tauray_torch.app.main import create_renderer, load_scenes
    from tauray_torch.ops import trace_kernel
    from tauray_torch.options import parse_command_line_options
    from tauray_torch.scene.device import to_camera_uniforms
    from tauray_torch.stages.feature import (FEATURES, feature_values,
                                             trace_pixels)
    opt = parse_command_line_options([
        "--renderer=albedo", f"--width={HD_W}", f"--height={HD_H}",
        "--headless=unused", "--filetype=none", SCENE])
    scene = load_scenes(opt)
    torch.cuda.empty_cache()
    trace_kernel.reset_launch_counts()
    rr = create_renderer(opt, scene, torch.device("cuda"))
    rr.set_scene(scene)
    imgs, ms = {}, {}
    for f in FEATURES:
        rr.feature = f
        img, ms[f] = sync_ms(rr.render_device)
        imgs[f] = img[0].cpu().numpy()
    launches = dict(trace_kernel.LAUNCHES)
    # the 8x4-pixel blocks at every 32nd row and column, traced again on
    # the CPU; the card traced the image in scanline order, so its tiles
    # differ from these and the check is per ray
    by, bx, iy, ix = np.meshgrid(np.arange(0, HD_H - 3, 32),
                                 np.arange(0, HD_W - 7, 32), np.arange(4),
                                 np.arange(8), indexing="ij")
    ys, xs = (by + iy).reshape(-1), (bx + ix).reshape(-1)
    pix = torch.from_numpy(np.stack([xs, ys], -1))
    vp = torch.zeros(pix.shape[0], dtype=torch.int64)
    size = torch.tensor([float(HD_W), float(HD_H)])
    scene_c = rr.device_scene._replace(**{
        k: v.cpu() for k, v in rr.device_scene._asdict().items()
        if isinstance(v, torch.Tensor)})
    tracer_c = to_cpu(rr.bvh)
    cam = to_camera_uniforms(rr.arrays.camera_uniforms(rr.viewports()),
                             "cpu")
    hit, d = trace_pixels(scene_c, tracer_c, cam, vp, pix, size,
                          float(opt.min_ray_dist),
                          rr.arrays.any_alpha_materials)
    res = {}
    for f in FEATURES:
        want = feature_values(scene_c, cam, cam, f, vp, hit, d,
                              float(opt.default_value)).numpy()
        got = imgs[f][ys, xs]
        if f == "instance-id":
            ok = bool(np.array_equal(got, want, equal_nan=True))
            err = 0.0 if ok else float("inf")
        else:
            fin = np.isfinite(want)
            scale = 1.0 + float(np.abs(want[fin]).max())
            diff = np.abs(got - want)
            ok = bool((np.isnan(got) == np.isnan(want)).all() and
                      (diff[fin] <= 1e-4 * scale).all())
            err = float(diff[fin].max() / scale)
        res[f] = dict(ms=ms[f], max_err_of_scale=err,
                      misses=int(np.isnan(want).all(-1).sum()))
        if not ok:
            raise RuntimeError(f"phase 13 {f}: the card departs from the "
                               f"CPU ({err})")
    print("phase 13 " + json.dumps(dict(
        size=f"{HD_W}x{HD_H}", checked_pixels=int(pix.shape[0]),
        features=res, launches=launches)), flush=True)
    if launches["trace_vm3"] <= 0:
        raise RuntimeError("phase 13 never launched trace_vm3")
    return launches["trace_vm3"]


def bench_phase():
    """Phase 14: the bench's headline cell; returns its JSON line."""
    from tauray_torch.app import bench
    from tauray_torch.ops import trace_kernel
    trace_kernel.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main(["--cells=headline"])
    line = buf.getvalue().strip().splitlines()[-1]
    out = json.loads(line)
    print(f"phase 14 {line}", flush=True)
    print("phase 14 launches " + json.dumps(dict(trace_kernel.LAUNCHES)),
          flush=True)
    if trace_kernel.LAUNCHES["trace_vm3"] <= 0 or not out["value"] > 0:
        raise RuntimeError("phase 14: the bench launched no trace_vm3")
    return out


RESTIR_HD = ["--renderer=restir", f"--width={HD_W}", f"--height={HD_H}",
             "--max-ray-depth=4", "--tonemap=linear", "--frames=3"]


def restir_cli_phase(tmp):
    """Phase 15a; returns K1's launches."""
    import numpy as np
    ms, imgs, launches, peak = main_path(tmp, "restir", RESTIR_HD,
                                         every=True)
    means = [check_image(img, HD_W, HD_H, f"phase 15a frame {k}")
             for k, img in enumerate(imgs)]
    print("phase 15a " + json.dumps(dict(
        size=f"{HD_W}x{HD_H}", depth=4, shift="reconnection-shift",
        frames=len(imgs), frame_ms=ms, launches=launches, peak_mem_gb=peak,
        image_means=means,
        image_mean_rel_spread=float(np.ptp(means) / np.mean(means)))),
        flush=True)
    if len(imgs) != 3 or launches["trace_vm3"] <= 0:
        raise RuntimeError(f"phase 15a: {len(imgs)} frames, launches "
                           f"{launches}")
    return launches["trace_vm3"]


def _to(x, dev):
    """Tensors (in tuples, NamedTuples and dicts too) moved to dev."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, dev) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    return x


@contextlib.contextmanager
def restir_capture(last: int):
    """Records the arguments (on the CPU) and results of call number
    `last` (from 0) of the renderer's restir_di_pass and restir_gi_pass.
    Yields {"di": {...}, "gi": {...}}."""
    from tauray_torch.renderer import restir_renderer as rmod
    orig = {"di": rmod.restir_di_pass, "gi": rmod.restir_gi_pass}
    rec, calls = {}, {"di": 0, "gi": 0}

    def wrap(kind):
        def fn(scene, tracer, *args, **kw):
            keep = calls[kind] == last
            calls[kind] += 1
            if keep:
                rec[kind] = dict(args=_to(args, "cpu"), kw=_to(kw, "cpu"))
            out = orig[kind](scene, tracer, *args, **kw)
            if keep:
                rec[kind]["out"] = _to(out, "cpu")
            return out
        return fn
    rmod.restir_di_pass, rmod.restir_gi_pass = wrap("di"), wrap("gi")
    try:
        yield rec
    finally:
        rmod.restir_di_pass, rmod.restir_gi_pass = orig["di"], orig["gi"]


class CardTraced:
    """A CPU-side view of the card's tracer: waves given on the CPU are
    traced by the card's kernel and their hits come back to the CPU. The
    kernels equal their plain versions bit for bit (phase 3, and on every
    wave of a ReSTIR frame in 15e/15f), so this traces as the CPU's plain
    tracer would, without its hours on the full scene's incoherent
    waves."""

    def __init__(self, tracer):
        self.tracer = tracer

    def __getattr__(self, name):
        return getattr(self.tracer, name)

    def trace(self, *args, **kw):
        return _to(self.tracer.trace(*_to(args, "cuda"), **kw), "cpu")

    def trace_flagged(self, *args, **kw):
        return _to(self.tracer.trace_flagged(*_to(args, "cuda"), **kw),
                   "cpu")


def scene_to_cpu(scene):
    return scene._replace(**{k: v.cpu() for k, v in scene._asdict().items()
                             if hasattr(v, "cpu")})


def _float_off(g, w):
    """Per pixel (first axis): any element beyond 1e-5 + 1e-3 x |w|."""
    import numpy as np
    g, w = g.reshape(g.shape[0], -1), w.reshape(w.shape[0], -1)
    return ~(np.abs(g - w) <= 1e-5 + 1e-3 * np.abs(w)).all(-1)


def hold_di_cpu(card, cpu, tag):
    """Card against CPU restir_di_pass results: the kept sample's share
    that differs, and the pixels departing otherwise; at most HOLD_DI_OFF
    of the pixels off. Returns stats."""
    import numpy as np
    (gc, rc), (gw, rw) = card, cpu
    t = {k: v.numpy().reshape(-1, *v.shape[2:]) for k, v in
         rc._asdict().items()}
    w = {k: v.numpy().reshape(-1, *v.shape[2:]) for k, v in
         rw._asdict().items()}
    same = (t["strategy"] == w["strategy"]) & \
        (t["light_idx"] == w["light_idx"]) & (t["u"] == w["u"]).all(-1)
    off = ~same | _float_off(gc.numpy().reshape(-1, 3),
                             gw.numpy().reshape(-1, 3))
    for k in ("w_sum", "M", "target_p"):
        off |= _float_off(t[k], w[k])
    res = dict(pixels=int(same.size), kept_differs=float(1 - same.mean()),
               off=float(off.mean()))
    if res["off"] > HOLD_DI_OFF:
        raise RuntimeError(f"phase {tag}: the card's restir_di_pass departs "
                           f"from the CPU's: {res}")
    return res


def hold_gi_cpu(card, cpu, tag):
    """Card against CPU restir_gi_pass results, as hold_di_cpu, at most
    HOLD_GI_OFF of the pixels off."""
    import numpy as np
    from tauray_torch.stages.restir_gi import RC_SURF
    (gc, rc), (gw, rw) = card, cpu
    t = {k: v.numpy().reshape(v.shape[0] * v.shape[1], -1) for k, v in
         rc._asdict().items()}
    w = {k: v.numpy().reshape(v.shape[0] * v.shape[1], -1) for k, v in
         rw._asdict().items()}
    same = (t["seed"] == w["seed"]).all(-1) & \
        (t["rc_kind"] == w["rc_kind"]).all(-1)
    surf = w["rc_kind"][:, 0] == RC_SURF
    off = ~same | _float_off(gc.numpy().reshape(-1, 3),
                             gw.numpy().reshape(-1, 3))
    for k in ("rc_pos", "rc_emit", "w_sum", "M", "target_p"):
        off |= _float_off(t[k], w[k])
    for k in ("rc_normal", "rc_alb", "rc_mr", "rc_nee_dir", "rc_nee_L",
              "rc_in_dir", "rc_in_L"):
        off |= surf & _float_off(t[k], w[k])
    res = dict(pixels=int(same.size), kept_differs=float(1 - same.mean()),
               off=float(off.mean()))
    if res["off"] > HOLD_GI_OFF:
        raise RuntimeError(f"phase {tag}: the card's restir_gi_pass departs "
                           f"from the CPU's: {res}")
    return res


def restir_renderer(W, H, depth, shift, scene=SCENE):
    """A ReSTIRRenderer on the card, as --renderer=restir builds it."""
    import torch
    from tauray_torch.app.main import create_renderer, load_scenes
    from tauray_torch.options import parse_command_line_options
    opt = parse_command_line_options([
        "--renderer=restir", f"--width={W}", f"--height={H}",
        f"--max-ray-depth={depth}", "--tonemap=linear",
        f"--restir.shift-mapping-type={shift}", "--headless=unused",
        "--filetype=none", scene])
    s = load_scenes(opt)
    rr = create_renderer(opt, s, torch.device("cuda"))
    rr.set_scene(s)
    return rr


def restir_hold_phase(tag, W, H, depth, shift):
    """Phases 15b/15c: 2 frames on the card; the second frame's passes
    again on the CPU from the card's inputs, their waves traced by the
    card's kernel (CardTraced)."""
    from tauray_torch.stages.restir import restir_di_pass
    from tauray_torch.stages.restir_gi import restir_gi_pass
    rr = restir_renderer(W, H, depth, shift)
    card_ms = []
    with restir_capture(1) as rec:
        for k in range(2):
            if k:
                rr.update_frame()
            img, ms = sync_ms(rr.render_device)
            card_ms.append(ms)
            check_image(img[0].cpu().numpy(), W, H, f"phase {tag} frame {k}")
    scene_c, tracer_c = scene_to_cpu(rr.device_scene), CardTraced(rr.bvh)
    out = dict(size=f"{W}x{H}", depth=depth, shift=shift, frame_ms=card_ms)
    for kind, fn, hold in (("di", restir_di_pass, hold_di_cpu),
                           ("gi", restir_gi_pass, hold_gi_cpu)):
        r = rec[kind]
        want, ms = sync_ms(lambda: fn(scene_c, tracer_c, *r["args"],
                                      **r["kw"]))
        out[kind] = dict(hold(r["out"], want, tag), cpu_ms=ms,
                         color_mean_card=float(r["out"][0].mean()),
                         color_mean_cpu=float(want[0].mean()))
    print(f"phase {tag} " + json.dumps(out), flush=True)
    return out


def probe_phase(tag, preset):
    """Phases 15d and 16d: --preset=<preset> on SCENE with an 8x8x8 SH
    grid over its bounds, 1920x1080, 3 frames: frame and bake ms, the
    frames' parts (app/bench.raster_split), K1's launches and the peak
    memory; the last frame's bake runs again on the CPU from the card's
    previous coefficients, its waves traced by the card's kernel
    (CardTraced), and is held to the card's. Returns (stats, the grid's
    last coefficients on the CPU, world_to_local)."""
    import types
    import numpy as np
    import torch
    from tauray_torch.app.bench import grid_over, raster_split
    from tauray_torch.app.main import create_renderer, load_scenes
    from tauray_torch.ops import trace_kernel
    from tauray_torch.options import parse_command_line_options
    from tauray_torch.renderer.sh_renderer import SHRenderer
    W, H = HD_W, HD_H
    opt = parse_command_line_options([
        f"--preset={preset}", f"--width={W}", f"--height={H}",
        "--headless=unused", "--filetype=none", SCENE])
    scene = load_scenes(opt)
    grid = grid_over(scene).sh_grid
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trace_kernel.reset_launch_counts()
    frame_ms, update_frame_ms, prev = [], [], {}
    with raster_split() as split:
        rr = create_renderer(opt, scene, torch.device("cuda"))
        rr.set_scene(scene)
        sh = rr.sh_source
        step = sh.step

        def tracked_step(host):
            prev["frame"] = sh.frame
            prev["coef"] = (None if sh.frame == 0 else
                            torch.as_tensor(grid.coefficients).cpu().clone())
            step(host)
        sh.step = tracked_step
        for k in range(3):
            if k:
                update_frame_ms.append(sync_ms(rr.update_frame)[1])
            img, ms = sync_ms(rr.render_device)
            frame_ms.append(ms)
            check_image(img[0].cpu().numpy(), W, H, f"phase {tag} frame {k}")
    launches = dict(trace_kernel.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    got = grid.coefficients.cpu().numpy()
    w2l = sh.current_grid_data()[1].cpu().numpy()
    # the last bake again on the CPU, from the card's previous grid, its
    # waves traced by the card's kernel
    cpu = SHRenderer(opt, "cpu")
    cpu.frame = prev["frame"]
    grid.coefficients = prev["coef"]
    host = types.SimpleNamespace(arrays=rr.arrays,
                                 device_scene=scene_to_cpu(rr.device_scene),
                                 bvh=CardTraced(rr.bvh))
    _, cpu_ms = sync_ms(lambda: cpu.step(host))
    want = grid.coefficients.numpy()
    scale = float(np.abs(want).max())
    diff = np.abs(got - want)
    res = dict(size=f"{W}x{H}", preset=preset, renderer=opt.renderer,
               grid=list(grid.resolution), probes=grid.probe_count(),
               samples_per_probe=min(opt.samples_per_probe, 512),
               depth=opt.max_ray_depth, frame_ms=frame_ms,
               update_frame_ms=update_frame_ms,
               frame_with_update_ms=[f + u for f, u in zip(
                   frame_ms[1:], update_frame_ms)],
               bake_ms=split["bake"], update_ms=split["update"],
               cpu_bake_ms=cpu_ms, launches=launches, peak_mem_gb=peak,
               coef_scale=scale, coef_max_diff_of_scale=float(diff.max()) /
               scale, coef_share_within_1e3_of_scale=float(
                   (diff <= 1e-3 * scale).mean()))
    if split["maps"]:
        res.update(maps_ms=split["maps"], draw_ms=split["draw"],
                   shadow_maps=int(rr.shadow_maps.depth.shape[0]),
                   map_resolution=rr.shadow_maps.resolution,
                   samples_per_pixel=opt.samples_per_pixel)
    del rr
    torch.cuda.empty_cache()
    if launches["trace_vm3"] <= 0 or \
            res["coef_share_within_1e3_of_scale"] < 0.999 or \
            res["coef_max_diff_of_scale"] > 2e-3:
        raise RuntimeError(f"phase {tag}: the card's bake departs from the "
                           f"CPU's, or K1 never launched: {res}")
    return res, got, w2l


@contextlib.contextmanager
def traced_waves(after=None, host: bool = False):
    """Records every wave the flat tracer traces inside the block as its
    kernel is handed it (padded, in the order traced). Yields a dict
    {label: (rays8, any_hit)}, each label the file:line that asked for
    the trace (#k on its k-th wave), and "tracer": the tracer. after: a
    (class, method name) pair: record only from the first call of that
    method on. host: keep the copies on the host, so the recording does
    not raise the device's peak memory."""
    from tauray_torch.ops import cluster
    impl = cluster._trace_padded
    rec, on = {}, [after is None]

    def recording(tracer, rays8, any_hit, need_uv):
        if on[0]:
            f = sys._getframe(1)
            while f.f_code.co_filename.endswith(("cluster.py",
                                                 "trace_utils.py")):
                f = f.f_back
            base = f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
            label, k = base, 1
            while label in rec:
                k += 1
                label = f"{base}#{k}"
            rec[label] = (rays8.cpu() if host else rays8.clone(), any_hit)
            rec["tracer"] = tracer
        return impl(tracer, rays8, any_hit, need_uv)
    cluster._trace_padded = recording
    if after is not None:
        cls, name = after
        method = getattr(cls, name)

        def started(self, *args, **kw):
            on[0] = True
            return method(self, *args, **kw)
        setattr(cls, name, started)
    try:
        yield rec
    finally:
        cluster._trace_padded = impl
        if after is not None:
            setattr(cls, name, method)


def restir_wave_phase():
    """Phase 15f: every wave of the second frame of 15a's ReSTIR run
    (1080p, depth 4, reconnection) held to K1's plain version; returns
    the per-wave results."""
    import torch
    rr = restir_renderer(HD_W, HD_H, 4, "reconnection-shift")
    rr.render_device()
    rr.update_frame()
    with traced_waves() as rec:
        rr.render_device()
        torch.cuda.synchronize()
    tracer = rec.pop("tracer")
    del rr
    torch.cuda.empty_cache()
    if len(rec) != 10:
        raise RuntimeError(f"phase 15f: {len(rec)} waves, not 10")
    return kernel_check(tracer, {k: r8 for k, (r8, _) in rec.items()},
                        tag="15f K1")


def restir_large_phase(tmp):
    """Phase 15e; returns K2's launches and the per-(wave, mode) results
    of its waves, each held to K2's plain version in the mode traced."""
    with traced_waves() as rec:
        ms, img, launches, peak = main_path(tmp, "restir_lg", [
            "--renderer=restir", "--width=256", "--height=256",
            "--max-ray-depth=4", "--tonemap=linear", "--frames=1"],
            SCENE_LARGE)
    check_image(img, 256, 256, "phase 15e")
    print("phase 15e " + json.dumps(dict(
        size="256x256", depth=4, scene=SCENE_LARGE, frame_ms=ms,
        launches=launches, peak_mem_gb=peak)), flush=True)
    if launches["trace_mt"] <= 0:
        raise RuntimeError(f"phase 15e launched {launches}")
    tracer = rec.pop("tracer")
    held = kernel_check_mt(tracer, {k: r8 for k, (r8, _) in rec.items()},
                           "K2", traced={k: a for k, (_, a) in rec.items()},
                           tag="15e K2")
    return launches["trace_mt"], held


RASTER_HD = ["--renderer=raster", f"--width={HD_W}", f"--height={HD_H}",
             "--tonemap=linear"]
# the share of pixels whose render_raster on the card may depart from the
# CPU's in phase 16c: shadow_vis by more than one PCF tap, or another
# G-buffer value by more than 1e-4 of its key's scale
# (tests/test_torch_smoke_holds.py reads what a broken map gives)
HOLD_RASTER_OFF = 1e-3


def raster_waves_expected(args, scene, frames: int):
    """K1 launches a raster run of `frames` frames should make, from the
    code: the maps stages/shadow_map.map_layout lays out (each directional
    light's cascades, a spotlight's map, an omni light's 6 faces), traced
    at set_scene and at every update_frame, and one camera wave a frame;
    on a scene with alpha materials each wave is three traces
    (trace_alpha's first trace and its 2 rounds). Returns (maps, waves
    per map or camera trace, launches)."""
    from tauray_torch.app.main import load_scenes
    from tauray_torch.options import parse_command_line_options
    from tauray_torch.scene.arrays import SceneArrays
    from tauray_torch.stages.shadow_map import map_layout
    opt = parse_command_line_options(args + ["--headless=unused",
                                             "--filetype=none", scene])
    arrays = SceneArrays(load_scenes(opt), opt)
    maps = len(map_layout(arrays, opt)["view"])
    traces = 3 if arrays.any_alpha_materials else 1
    return maps, traces, traces * (maps * frames + frames)


@contextlib.contextmanager
def raster_capture(last: int):
    """Holds on to the arguments and result of call number `last` (from
    0) of the raster renderer's render_raster, by reference (no copy, so
    neither the frame's time nor its peak memory moves). Yields a dict."""
    from tauray_torch.renderer import raster_renderer as rmod
    orig, rec, calls = rmod.render_raster, {}, [0]

    def fn(*args, **kw):
        out = orig(*args, **kw)
        if calls[0] == last:
            rec.update(args=args, kw=kw, out=out)
        calls[0] += 1
        return out
    rmod.render_raster = fn
    try:
        yield rec
    finally:
        rmod.render_raster = orig


def raster_cli_phase(tmp):
    """Phase 16a: `python -m tauray_torch --renderer=raster` at 1920x1080
    with the defaults, 2 frames: each frame checked, its ms, the shadow
    maps' and the draw's ms, the peak memory and K1's launches, held to
    the count the code gives. Returns (K1 launches, frame 2's waves,
    frame 2's render_raster call)."""
    from tauray_torch.app.bench import raster_split
    from tauray_torch.renderer.raster_renderer import RasterRenderer
    args = RASTER_HD + ["--frames=2"]
    maps, traces, expected = raster_waves_expected(args, SCENE, 2)
    with raster_split() as split, raster_capture(1) as cap, \
            traced_waves((RasterRenderer, "update_frame"), True) as waves:
        ms, imgs, launches, peak = main_path(tmp, "raster", args,
                                             every=True)
    means = [check_image(img, HD_W, HD_H, f"phase 16a frame {k}")
             for k, img in enumerate(imgs)]
    res = dict(size=f"{HD_W}x{HD_H}", renderer="raster", frames=len(imgs),
               frame_ms=ms, maps_ms=split["maps"], draw_ms=split["draw"],
               update_ms=split["update"], shadow_maps=maps,
               map_resolution=cap["args"][4].resolution,
               launches=launches, launches_expected=expected,
               peak_mem_gb=peak, image_means=means,
               waves_recorded=len(waves) - 1)
    print("phase 16a " + json.dumps(res), flush=True)
    if len(imgs) != 2 or launches["trace_vm3"] != expected or \
            len(waves) - 1 != maps + 1:
        raise RuntimeError(f"phase 16a: {len(imgs)} frames, launches "
                           f"{launches}, expected {expected} K1 launches "
                           f"and {maps + 1} waves in frame 2")
    return launches["trace_vm3"], waves, cap


def raster_wave_phase(waves):
    """Phase 16b: frame 2's waves of 16a, each (4,194,304 rays a map,
    2,073,600 the camera wave) held bit for bit to K1's plain version (run
    in slices of 2^20 rays: the same per-tile work); returns the per-wave
    results."""
    import torch
    tracer = waves.pop("tracer")
    out = {}
    for name in list(waves):
        r8 = waves.pop(name)[0].cuda()
        out.update(kernel_check(tracer, {name: r8}, tag="16b K1",
                                plain_slice=1 << 15))
        del r8
    torch.cuda.empty_cache()
    return out


def hold_raster_cpu(card, cpu, tag, taps: int):
    """Card against CPU render_raster G-buffers (each (V, H, W, ...)): a
    pixel is off where shadow_vis departs by more than one PCF tap
    (1/taps), or another value by more than 1e-4 of its key's scale (the
    largest magnitude over the pixels that hit) + 1e-5 relative, or NaN
    differs; at most HOLD_RASTER_OFF of the pixels off. Returns stats."""
    import numpy as np
    hit = card["color"][..., 3].cpu().numpy().reshape(-1) > 0
    sg = card["shadow_vis"].cpu().numpy().reshape(-1)
    sw = cpu["shadow_vis"].cpu().numpy().reshape(-1)
    shadow_off = ~(np.abs(sg - sw) <= 1.0 / taps + 1e-5)
    float_off = np.zeros_like(shadow_off)
    worst = {}
    for k, w in cpu.items():
        if k == "shadow_vis":
            continue
        g = card[k].cpu().numpy().reshape(hit.size, -1)
        w = w.cpu().numpy().reshape(hit.size, -1)
        fin = np.isfinite(w)
        sel = fin & hit[:, None] if (fin & hit[:, None]).any() else fin
        scale = max(float(np.abs(w[sel]).max()) if sel.any() else 1.0,
                    1e-6)
        d = np.abs(g - w)
        bad = ~(d <= 1e-4 * scale + 1e-5 * np.abs(w)) & \
            ~(np.isnan(g) & np.isnan(w))
        float_off |= bad.any(-1)
        worst[k] = float(np.nanmax(np.where(fin, d, 0.0))) / scale
    off = shadow_off | float_off
    res = dict(pixels=int(off.size), shadow_off=float(shadow_off.mean()),
               float_off=float(float_off.mean()), off=float(off.mean()),
               max_diff_of_scale=worst)
    if res["off"] > HOLD_RASTER_OFF:
        raise RuntimeError(f"phase {tag}: the card's render_raster departs "
                           f"from the CPU's: {res}")
    return res


def raster_hold_phase(cap):
    """Phase 16c: frame 2's render_raster of 16a again on the CPU, from
    the card's shadow maps, camera uniforms and scene, its camera wave
    traced by the card's kernel (CardTraced), held to the card's
    G-buffer by hold_raster_cpu at one tap of its --pcf."""
    from tauray_torch.stages.raster import render_raster
    taps = max(min(cap["args"][14], 64), 1)       # pcf_samples
    args = list(_to(cap["args"], "cpu"))
    args[0] = scene_to_cpu(cap["args"][0])
    args[1] = CardTraced(cap["args"][1])
    want, ms = sync_ms(lambda: render_raster(*args, **_to(cap["kw"],
                                                          "cpu")))
    res = dict(hold_raster_cpu(cap["out"], want, "16c", taps), cpu_ms=ms,
               size=f"{HD_W}x{HD_H}",
               color_mean_card=float(cap["out"]["color"].mean()),
               color_mean_cpu=float(want["color"].mean()))
    print("phase 16c " + json.dumps(res), flush=True)
    return res


def dshgi_phase():
    """Phase 16d: --preset=ddish-gi as probe_phase runs it, then the
    baked grid through net/dshgi's message format and back, bit for
    bit."""
    import numpy as np
    from tauray_torch.net.dshgi import _grid_message, _parse_grid_message
    res, coef, w2l = probe_phase("16d", "ddish-gi")
    msg = _grid_message(0, int(np.sqrt(coef.shape[3])) - 1, 0.0, w2l, coef)
    _, _, _, w2l_back, coef_back = _parse_grid_message(msg)
    res.update(message_bytes=len(msg), message_round_trip=bool(
        coef_back.tobytes() == coef.tobytes() and
        w2l_back.tobytes() == w2l.tobytes()))
    print("phase 16d " + json.dumps(res), flush=True)
    if not res["message_round_trip"]:
        raise RuntimeError("phase 16d: the grid does not come back bit for "
                           "bit through _grid_message/_parse_grid_message")
    return res


def raster_foliage_phase(tmp):
    """Phase 16e: one raster frame of the foliage scene at 1920x1080: its
    maps go through trace_alpha (cutoff 0.5) and the alpha rounds; K1's
    launches held to the count the code gives."""
    from tauray_torch.app.bench import raster_split
    args = RASTER_HD + ["--frames=1"]
    maps, traces, expected = raster_waves_expected(args, SCENE_FOLIAGE, 1)
    with raster_split() as split:
        ms, img, launches, peak = main_path(tmp, "raster_fol", args,
                                            SCENE_FOLIAGE)
    mean = check_image(img, HD_W, HD_H, "phase 16e")
    res = dict(size=f"{HD_W}x{HD_H}", scene=SCENE_FOLIAGE, frame_ms=ms,
               maps_ms=split["maps"], draw_ms=split["draw"],
               shadow_maps=maps, traces_per_wave=traces, launches=launches,
               launches_expected=expected, peak_mem_gb=peak,
               image_mean=mean)
    print("phase 16e " + json.dumps(res), flush=True)
    if traces != 3 or launches["trace_vm3"] != expected:
        raise RuntimeError(f"phase 16e: launches {launches}, expected "
                           f"{expected} in {traces} traces a wave")
    return launches["trace_vm3"]


def raster_large_phase(tmp):
    """Phase 16f: one raster frame of SCENE_LARGE (past 2,197 clusters, so
    K2) at 1920x1080 with 1024^2 maps: K2's launches held to the count the
    code gives, and each of the frame's waves (16 maps of 1,048,576 rays,
    the camera wave), as traced, held bit for bit to K2's plain version.
    Returns (K2 launches, the per-wave results)."""
    args = RASTER_HD + ["--frames=1", "--shadow-map-resolution=1024"]
    maps, traces, expected = raster_waves_expected(args, SCENE_LARGE, 1)
    with traced_waves() as rec:
        ms, img, launches, peak = main_path(tmp, "raster_lg", args,
                                            SCENE_LARGE)
    check_image(img, HD_W, HD_H, "phase 16f")
    print("phase 16f " + json.dumps(dict(
        size=f"{HD_W}x{HD_H}", scene=SCENE_LARGE, map_resolution=1024,
        shadow_maps=maps, frame_ms=ms, launches=launches,
        launches_expected=expected, peak_mem_gb=peak)), flush=True)
    if launches["trace_mt"] != expected or launches["trace_vm3"] != 0:
        raise RuntimeError(f"phase 16f launched {launches}, expected "
                           f"{expected} of trace_mt")
    tracer = rec.pop("tracer")
    held = kernel_check_mt(tracer, {k: r8 for k, (r8, _) in rec.items()},
                           "K2", traced={k: a for k, (_, a) in rec.items()},
                           tag="16f K2")
    return launches["trace_mt"], held


# ---------------------------------------------------------------------------
# Phases 17-18: multi-device rendering on one card, Looking Glass, the
# interactive frame stream and --validation
# ---------------------------------------------------------------------------

# 17a-17c: the share of pixels that may differ by more than HOLD_DIST_ATOL
# between a distributed frame and the one-device frame of the same options
# (hits are per ray, so only the rounding of a ray's place in its wave
# may differ)
HOLD_DIST_OFF = 1e-4
HOLD_DIST_ATOL = 1e-3
DIST = ["--fake-devices=4", "--distribution-strategy=shuffled-strips"]


def hold_frames(got, want, tag):
    """17a's rule: at most HOLD_DIST_OFF of the pixels (over every view)
    differ by more than HOLD_DIST_ATOL in a channel. Returns the largest
    difference and the counts of pixels off and not bit-equal."""
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise RuntimeError(f"phase {tag}: {got.shape} against {want.shape}"
                           f", finite={np.isfinite(got).all()}")
    d = np.abs(got - want).reshape(-1, got.shape[-1]).max(-1)
    res = dict(max_abs_diff=float(d.max()), pixels=int(d.size),
               pixels_off=int((d > HOLD_DIST_ATOL).sum()),
               pixels_not_bit_equal=int((d > 0).sum()))
    if res["pixels_off"] > HOLD_DIST_OFF * d.size:
        raise RuntimeError(f"phase {tag}: the distributed frame departs "
                           f"from the one-device frame: {res}")
    return res


def pt_renderer(args, W, H, dev, devices=None, views=1, depth=4):
    """A path tracer of SCENE on dev: the one-device renderer, or with
    devices the distributed one over them; views > 1 adds the bench's
    quilt cameras."""
    from tauray_torch.app.bench import quilt_cameras
    from tauray_torch.app.main import load_scenes
    from tauray_torch.options import parse_command_line_options
    from tauray_torch.renderer.distributed import \
        DistributedPathTracerRenderer
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer
    opt = parse_command_line_options([
        "--renderer=path-tracer", f"--width={W}", f"--height={H}",
        "--samples-per-pixel=1", f"--max-ray-depth={depth}",
        "--tonemap=linear"] + list(args) + [
        "--headless=unused", "--filetype=none", SCENE])
    s = load_scenes(opt)
    if views > 1:
        quilt_cameras(s, views)
    rr = PathTracerRenderer(opt, dev) if devices is None else \
        DistributedPathTracerRenderer(opt, dev, devices=devices)
    rr.set_scene(s)
    return rr


def frame(rr):
    """One frame (reset_accumulation, render_device) on the host, and its
    ms to a device synchronize."""
    rr.reset_accumulation()
    img, ms = sync_ms(rr.render_device)
    return img.cpu().numpy(), ms


def distributed_phase(tmp, W=HD_W, H=HD_H, dev=None):
    """Phases 17a and 17b. Returns K1's launches of 17a's CLI run."""
    import numpy as np
    import torch
    from tauray_torch.ops import cluster
    from tauray_torch.parallel.load_balancer import LoadBalancer
    dev = dev or torch.device("cuda")
    size = [f"--width={W}", f"--height={H}"]
    # 17a: the CLI, 4 workloads on the card, 2 frames, float32 EXRs
    cluster.reset_traced()
    ms, imgs, launches, peak = main_path(
        tmp, "dist", HD + size + DIST + ["--format=rgba32"], every=True)
    traced = dict(cluster.TRACED)
    for k, img in enumerate(imgs):
        check_image(img, W, H, f"phase 17a frame {k}")
    if launches["trace_vm3"] <= 0:
        raise RuntimeError(f"phase 17a launched {launches}")
    # the one-device frames of the same options (with --accumulation its
    # second frame is the running mean that 17b's rebalanced frame is)
    one = pt_renderer(["--accumulation"], W, H, dev)
    f1, one_ms = frame(one)
    res = dict(size=f"{W}x{H}", workloads=4, strategy="shuffled-strips",
               frame_ms=ms, frame2_ms=ms[-1],
               mrays_s=traced["rays"] / 2 / (ms[-1] * 1e3),
               lanes_per_frame=traced["rays"] // 2,
               waves_per_frame=traced["waves"] // 2, launches=launches,
               peak_mem_gb=peak, one_device_frame_ms=one_ms,
               **hold_frames(imgs[0][..., :3], f1[0, ..., :3], "17a"))
    print("phase 17a " + json.dumps(res), flush=True)
    # 17b: skewed times into the load balancer between two frames
    rr = pt_renderer(DIST + ["--accumulation"], W, H, dev,
                     devices=[dev])
    frame(rr)
    times = [0.3, 0.1, 0.1, 0.1]
    workloads = LoadBalancer(rr.n_devices).update(rr, times)
    cover = torch.bincount(rr._lin[0].long(), minlength=W * H)
    if not bool((cover == 1).all()) or rr._stitch_blend != 0.5:
        raise RuntimeError("phase 17b: the rebalanced shares do not cover "
                           "the frame once")
    f2, ms2 = frame(rr)
    g2, _ = frame(one)
    res = dict(workloads=workloads,
               pixels_per_workload=[int(w[3]) for w in rr._work],
               frame_ms=ms2, **hold_frames(f2, g2, "17b"))
    print("phase 17b " + json.dumps(res), flush=True)
    del rr, one
    # 17b: scanline with 3 workloads, interleaved rows
    rr = pt_renderer(["--fake-devices=3", "--distribution-strategy=scanline"],
                     W, H, dev, devices=[dev])
    if rr.strategy != "scanline" or rr.n_devices != 3:
        raise RuntimeError(f"phase 17b: {rr.strategy} over {rr.n_devices}")
    f3, ms3 = frame(rr)
    res = dict(strategy="scanline", workloads=3,
               rows_per_workload=[int(w[3]) // W for w in rr._work],
               frame_ms=ms3, **hold_frames(f3, f1, "17b scanline"))
    print("phase 17b " + json.dumps(res), flush=True)
    del rr
    torch.cuda.empty_cache()
    return launches["trace_vm3"]


def view_sharded_phase(W=256, H=256, dev=None):
    """Phase 17c: the bench's quilt_5x9 (45 views, depth 2) over the card
    named four times, held to the one-device render of the same views.
    Returns K1's launches of the view-sharded frame."""
    import torch
    from tauray_torch.app.bench import QUILT_VIEWS
    from tauray_torch.ops import trace_kernel
    dev = dev or torch.device("cuda")
    rr = pt_renderer([], W, H, dev, devices=[dev] * 4, views=QUILT_VIEWS,
                     depth=2)
    if not rr.view_sharded:
        raise RuntimeError("phase 17c: 45 views over 4 devices did not "
                           "shard the views")
    trace_kernel.reset_launch_counts()
    got, ms = frame(rr)
    launches = dict(trace_kernel.LAUNCHES)
    one = pt_renderer([], W, H, dev, views=QUILT_VIEWS, depth=2)
    want, one_ms = frame(one)
    for v in (0, QUILT_VIEWS // 2, QUILT_VIEWS - 1):
        check_image(got[v], W, H, f"phase 17c view {v}")
    res = dict(views=QUILT_VIEWS, size=f"{W}x{H}", devices=4, frame_ms=ms,
               ms_per_view=ms / QUILT_VIEWS, one_device_frame_ms=one_ms,
               one_device_ms_per_view=one_ms / QUILT_VIEWS,
               launches=launches, **hold_frames(got, want, "17c"))
    print("phase 17c " + json.dumps(res), flush=True)
    if launches["trace_vm3"] <= 0:
        raise RuntimeError(f"phase 17c launched {launches}")
    return launches["trace_vm3"]


def sharded_bake_phase(dev=None):
    """Phase 17d: the probe-sharded bake (an 8x8x8 grid over SCENE,
    --preset=ddish-gi's 512 samples a probe at depth 4) over the card
    named twice, held to the one-device bake within 1e-5 of the largest
    coefficient."""
    import numpy as np
    import torch
    from tauray_torch.app.bench import grid_over
    from tauray_torch.app.main import load_scenes
    from tauray_torch.options import parse_command_line_options
    from tauray_torch.renderer.raster_renderer import FlatTracerHost
    from tauray_torch.renderer.sh_renderer import SHRenderer
    dev = dev or torch.device("cuda")
    opt = parse_command_line_options([
        "--preset=ddish-gi", "--headless=unused", "--filetype=none", SCENE])
    s = load_scenes(opt)
    grid = grid_over(s).sh_grid
    host = FlatTracerHost(opt, dev)
    host.set_scene(s)
    out = {}
    for name, devices in (("sharded", [dev] * 2), ("one", None)):
        sh = SHRenderer(opt, dev)
        sh.devices = devices
        _, ms = sync_ms(lambda: sh.step(host))
        out[name] = (torch.as_tensor(grid.coefficients).cpu().numpy().copy(),
                     ms)
    got, want = out["sharded"][0], out["one"][0]
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max()) / scale
    res = dict(probes=grid.probe_count(), devices=2,
               bake_ms=out["sharded"][1], one_device_bake_ms=out["one"][1],
               coef_scale=scale, max_diff_of_scale=err,
               bit_equal=bool((got == want).all()))
    print("phase 17d " + json.dumps(res), flush=True)
    if not np.isfinite(got).all() or err > 1e-5:
        raise RuntimeError(f"phase 17d: the sharded bake departs: {res}")


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def lkg_phase(tmp, W=256, H=256, n=8):
    """Phase 18a: --display=looking-glass through the CLI with n
    views, one image per view; compose_quilt and lkg_compose of those
    views on the card held bit-equal to the CPU."""
    import numpy as np
    import torch
    from tauray_torch.io.exr import read_rgb
    from tauray_torch.stages.looking_glass import (LKGCalibration,
                                                   compose_quilt,
                                                   lkg_compose)
    from tauray_torch.app.main import main
    from tauray_torch.log import logger
    from tauray_torch.ops import trace_kernel
    timing = os.path.join(tmp, "lkg_timing.txt")
    trace_kernel.reset_launch_counts()
    rc = main([
        "--display=looking-glass", f"--lkg-params.viewports={n}",
        f"--width={W}", f"--height={H}", "--samples-per-pixel=1",
        "--max-ray-depth=2", "--tonemap=linear", "--format=rgba32",
        f"--headless={os.path.join(tmp, 'lkg')}", "--compression=zip",
        "--timing", f"--timing-output={timing}", SCENE])
    launches = dict(trace_kernel.LAUNCHES)
    logger.timing.stream.close()
    logger.timing.stream = None
    with open(timing) as f:
        ms = [float(m) for m in re.findall(r"HOST: ([0-9.]+)ms", f.read())]
    if rc != 0:
        raise RuntimeError(f"phase 18a: main() returned {rc}")
    files = sorted(f for f in os.listdir(tmp) if re.fullmatch(
        r"lkg\d+_\.exr", f))
    if len(files) != n:
        raise RuntimeError(f"phase 18a: {len(files)} images for {n} views")
    views = np.stack([read_rgb(os.path.join(tmp, f"lkg{v}_.exr"))
                      for v in range(n)]).astype(np.float32)
    for v in range(n):
        check_image(views[v], W, H, f"phase 18a view {v}")
    cal = LKGCalibration()
    args = (cal.pitch, cal.slope, cal.center, cal.screenW, cal.screenH, n)
    cpu = torch.from_numpy(views)
    card = cpu.cuda()
    same = dict(
        quilt=bool(torch.equal(compose_quilt(card).cpu(),
                               compose_quilt(cpu))),
        lenticular=bool(torch.equal(lkg_compose(card, *args).cpu(),
                                    lkg_compose(cpu, *args))))
    res = dict(views=n, size=f"{W}x{H}", frame_ms=ms, launches=launches,
               images=len(files), bit_equal_to_cpu=same)
    print("phase 18a " + json.dumps(res), flush=True)
    if not all(same.values()) or launches["trace_vm3"] <= 0:
        raise RuntimeError(f"phase 18a: {res}")


def interactive_phase(W=256, H=256, dev=None):
    """Phase 18b: the interactive viewer streaming to a FrameClient on
    loopback, which takes 3 frames, sends a key, a mouse move and quit."""
    import threading
    import numpy as np
    import torch
    from tauray_torch.app.interactive import interactive_viewer
    from tauray_torch.app.main import load_scenes
    from tauray_torch.net.frame_stream import (EVENT_KEY_DOWN, EVENT_KEY_UP,
                                               EVENT_MOUSE_MOTION,
                                               EVENT_QUIT, FrameClient)
    from tauray_torch.options import parse_command_line_options
    dev = dev or torch.device("cuda")
    port = _free_port()
    opt = parse_command_line_options([
        f"--width={W}", f"--height={H}", "--samples-per-pixel=1",
        "--max-ray-depth=2", f"--port={port}", SCENE])
    s = load_scenes(opt)
    frames, errors = [], []

    def viewer():
        try:
            end = time.monotonic() + 120
            while True:
                try:
                    client = FrameClient(f"127.0.0.1:{port}")
                    break
                except OSError:
                    if time.monotonic() > end:
                        raise
                    time.sleep(0.05)
            try:
                client.sock.settimeout(120)
                while len(frames) < 3:
                    frames.append(client.recv_frame())
                client.send_events([(EVENT_KEY_DOWN, ord("w"), 0),
                                    (EVENT_MOUSE_MOTION, 5, -3),
                                    (EVENT_KEY_UP, ord("w"), 0),
                                    (EVENT_QUIT, 0, 0)])
                while client.recv_frame() is not None:
                    pass
            finally:
                client.close()
        except Exception as e:  # reported below
            errors.append(repr(e))
    th = threading.Thread(target=viewer, daemon=True)
    th.start()
    t0 = time.perf_counter()
    interactive_viewer(opt, s, dev, read_line=lambda: None)
    th.join(120)
    wall = time.perf_counter() - t0
    ok = not th.is_alive() and not errors and len(frames) >= 3 and all(
        f is not None and f.shape == (H, W, 3) and f.any() for f in frames)
    res = dict(size=f"{W}x{H}", frames_received=len(frames),
               wall_s=wall, errors=errors,
               frame_means=[float(np.mean(f)) for f in frames
                            if f is not None])
    print("phase 18b " + json.dumps(res), flush=True)
    if not ok:
        raise RuntimeError(f"phase 18b: {res}")


def validation_phase(W=256, H=256, dev=None):
    """Phase 18c: --validation passes a clean frame, and names the stage
    when a NaN is injected into the shading's input (every triangle's
    albedo factor)."""
    import numpy as np
    import torch
    from tauray_torch.scene.device import IP_ALBEDO, TP_IP
    dev = dev or torch.device("cuda")
    rr = pt_renderer(["--validation"], W, H, dev, depth=2)
    clean, ms = frame(rr)
    check_image(clean[0], W, H, "phase 18c clean")
    tp = rr.device_scene.tri_packed.clone()
    tp[:, TP_IP + IP_ALBEDO:TP_IP + IP_ALBEDO + 3] = float("nan")
    rr.device_scene = rr.device_scene._replace(tri_packed=tp)
    try:
        frame(rr)
        msg = None
    except FloatingPointError as e:
        msg = str(e)
    res = dict(clean_frame_ms=ms, raised=msg)
    print("phase 18c " + json.dumps(res), flush=True)
    if msg is None or "bounce 0 shade" not in msg:
        raise RuntimeError(f"phase 18c: {res}")


# ---------------------------------------------------------------------------
# Phase 19: the native host library (tauray_torch/native) on a scene load
# ---------------------------------------------------------------------------

ENVMAP_W, ENVMAP_H = 1024, 512


def envmap_phase(tmp):
    """Phase 19: a seeded 1024x512 sky (app/exr_io.sky) written as a half
    RGB PIZ EXR with the port's writer (the headless writer's default
    codec; timed), read back through the native Huffman decoder and under
    TAURAY_NATIVE=0 (each timed; both bit-equal to each other and to the
    sky rounded to half); then one frame of SCENE at 1920x1080, 1 spp,
    depth 4 through the CLI, first without the map and then with
    --envmap=<that file>, the same frame and seed: the image checked, the
    map's 16 chunks decoded natively, K1 launched, and the map's light
    seen. A map read and then ignored would leave the two frames equal;
    the check asks for more than a tenth of the pixels off by more than
    1e-3 relative, the share by which phase 6 lets two tracers differ."""
    import numpy as np
    from tauray_torch import native
    from tauray_torch.app.exr_io import piz_roundtrip, sky
    path = os.path.join(tmp, "sky.exr")
    res = piz_roundtrip(path, sky(ENVMAP_W, ENVMAP_H, seed=19))
    print("phase 19 envmap " + json.dumps(res), flush=True)
    args = [a for a in HD if a != "--frames=2"] + ["--frames=1"]
    _, bare, _, _ = main_path(tmp, "noenv", args)
    bare = np.asarray(bare)[..., :3]
    decode = native.huf_decode
    calls = []

    def counting(*a):
        calls.append(1)
        return decode(*a)
    native.huf_decode = counting
    try:
        t0 = time.perf_counter()
        ms, img, launches, peak = main_path(
            tmp, "env", args + [f"--envmap={path}"])
        cli_s = time.perf_counter() - t0
    finally:
        native.huf_decode = decode
    mean = check_image(img, HD_W, HD_H, "phase 19")
    rgb = np.asarray(img)[..., :3]
    rel = np.abs(rgb - bare) / np.maximum(np.abs(bare), 1e-6)
    out = dict(size=f"{HD_W}x{HD_H}", spp=1, depth=4, scene=SCENE,
               envmap=f"{ENVMAP_W}x{ENVMAP_H} piz half", frame_ms=ms,
               cli_s=cli_s, native_decodes=len(calls), launches=launches,
               peak_mem_gb=peak, image_mean=mean,
               no_envmap_mean=float(bare.mean()),
               pixels_off_no_envmap=float((rel.max(-1) > 1e-3).mean()))
    print("phase 19 render " + json.dumps(out), flush=True)
    # a PIZ chunk holds 32 scanlines
    if len(calls) != ENVMAP_H // 32 or launches["trace_vm3"] <= 0 or \
            out["pixels_off_no_envmap"] <= 0.1:
        raise RuntimeError(f"phase 19: {out}")



# ---------------------------------------------------------------------------
# Phase 20: the K1 labs (tauray_torch/lab, csrc/k1_lab.cu)
# ---------------------------------------------------------------------------

# tiles of a plain version's hold where its full size would take more than
# a few seconds: 32,768 rays
LAB_SLICE_TILES = 1024
# each lab's TPU kernel: the script's pallas_call line
LAB_SITES = {"lab8": "scripts/kernel_lab8.py:105",
             "lab9": "scripts/kernel_lab9.py:189",
             "lab10": "scripts/kernel_lab10.py:193",
             "lab11": "scripts/kernel_lab11.py:139"}
# the mode whose times stand at the top of each lab's kernels-line row
LAB_HEADLINE = {"lab8": "mode3/count16", "lab9": "full/s4",
                "lab10": "full/bounce_512", "lab11": "mxu"}


def _mid_tiles(n_tiles: int, n: int = LAB_SLICE_TILES) -> slice:
    """n tiles from the middle of a wave, whole groups of 32."""
    if n_tiles <= n:
        return slice(0, n_tiles)
    a = (n_tiles - n) // 2 // 32 * 32
    return slice(a, a + n)


def lab_phase(dev, tracer, bounce):
    """Phase 20: the four K1 labs through their entry points' run() at the
    scripts' sizes (L9 on tracer's table; L10 on bounce, phase 3's sorted
    2^18- and 2^20-ray waves of tracer's scene), every mode timed (L8 also
    back to back and by CUDA-graph replay); the launches counted over that
    run alone. Then each mode held to its plain
    version on the same inputs, bit for bit (L9 and L10 on LAB_SLICE_TILES
    tiles of each input), L11 mxu by kernel_lab11.mxu_agreement, L9's and
    L10's FMA bodies by lab9_agreement and lab10_agreement, and L10 full to
    K1 (trace_vm3) on both whole waves, the two timed in turns. Returns the
    kernels line's rows."""
    import torch
    from tauray_torch.lab import kernel_lab8 as l8
    from tauray_torch.lab import kernel_lab9 as l9
    from tauray_torch.lab import kernel_lab10 as l10
    from tauray_torch.lab import kernel_lab11 as l11
    from tauray_torch.lab import lab_kernel
    from tauray_torch.lab.common import time_cuda
    from tauray_torch.ops.trace_kernel import trace_tiles_vm3
    t0 = time.perf_counter()
    lab_kernel.reset_launch_counts()
    in8, res8 = l8.run(dev)
    in9, res9 = l9.run(dev, tracer=tracer)
    _, args10, res10 = l10.run(dev, waves=(tracer, bounce))
    in11, res11 = l11.run(dev)
    torch.cuda.synchronize()
    launches = {lab: lab_kernel.LAUNCHES[lab] for lab in LAB_SITES}
    run_s = time.perf_counter() - t0
    print("phase 20 launches " + json.dumps(launches), flush=True)
    if any(v <= 0 for v in launches.values()):
        raise RuntimeError(f"phase 20: a lab never launched: {launches}")
    failures, modes = [], {}

    def hold(tag, out, plain):
        """(plain ms, max |t - t_plain|): plain() against the kernel's
        out, t and id bits alike."""
        ref, ms = timed(plain)
        off = int((out.view(torch.int32) != ref.view(torch.int32)).any(
            -1).sum())
        if off:
            failures.append(f"{tag}: {off} rays depart from the plain "
                            f"version")
        return ms, float((out[..., 0] - ref[..., 0]).abs().max())

    def emit(lab, key, r, plain_ms, err, **extra):
        e = dict(ms=r["ms"], min_ms=r["min_ms"], plain_ms=plain_ms,
                 bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                 max_abs_err=err, **extra)
        modes.setdefault(lab, {})[key] = e
        print(f"phase 20 {lab} {key} " + json.dumps(e), flush=True)

    for r in res8:
        key = f"mode{r['mode']}/count{r['count']}"
        ms, err = hold(f"lab8 {key}", r["out"], lambda: l8.lab8_reference(
            r["counts"], in8["heads"], in8["o3"], in8["d3"], in8["mm2"],
            r["mode"]))
        emit("lab8", key, r, ms, err, us_per_tile=r["us_per_tile"],
             plain_rays=r["out"].shape[0] * 32,
             **{k: r[k] for k in ("ms_back_to_back", "min_ms_back_to_back",
                                  "ms_graph", "min_ms_graph",
                                  "max_ms_graph")})
    sl = slice(0, LAB_SLICE_TILES)
    for r in res9:
        key = f"{r['mode']}/s{r['count'] // 8}"
        stats = {}

        def plain():
            return l9.lab9_reference(
                r["counts"][sl], in9["heads"][sl], in9["o3"][sl],
                in9["d3"][sl], in9["mm2"][sl], in9["tris12"], r["mode"],
                stats)
        extra = {}
        if r["mode"] == "loads":     # no test: bit for bit
            ms, err = hold(f"lab9 {key}", r["out"][sl], plain)
        else:                        # the FMA body: tie-aware
            ref, ms = timed(plain)
            extra = l9.lab9_agreement(r["out"][sl], ref, in9["o3"][sl],
                                      in9["d3"][sl], in9["mm2"][sl],
                                      in9["tris12"], r["mode"])
            err = extra["max_abs_t"]
            if not extra["ok"]:
                failures.append(f"lab9 {key}: {extra}")
        if r["mode"] == "exit":
            # no tile could stop early on these inputs, so exit computes
            # full's function and is held as full
            extra.update(plain_steps=stats["steps"],
                         tiles_that_could_exit=l9.lab9_exits(
                             r["out"], in9["n_clusters"]))
            if extra["tiles_that_could_exit"]:
                failures.append(f"lab9 {key}: a tile could exit early")
        emit("lab9", key, r, ms, err, us_per_tile=r["us_per_tile"],
             gtests_s=r["gtests_s"], hits=r["hits"],
             plain_rays=r["out"][sl].shape[0] * 32, **extra)
    # the in-range reciprocal (csrc/lab_common.cuh rcp_in_range): every
    # 13th direction scaled by 1e-39 (a subnormal den: every step redone
    # with __frcp_rn), every 7th axis-aligned (den exactly 0 against the
    # table's axis-aligned walls) and every 17th NaN
    d_odd = in9["d3"][sl].clone()
    d_odd.view(-1, 3)[::7] = torch.tensor([1.0, 0.0, 0.0], device=dev)
    d_odd.view(-1, 3)[::13] *= 1e-39
    d_odd.view(-1, 3)[::17] = float("nan")
    args = (torch.full((LAB_SLICE_TILES,), 32, dtype=torch.int32,
                       device=dev), in9["heads"][sl], in9["o3"][sl], d_odd,
            in9["mm2"][sl], in9["tris12"], "full")
    odd = l9.lab9_agreement(l9.lab9(*args), l9.lab9_reference(*args),
                            *args[2:6], "full")
    print("phase 20 lab9 full/s4 odd denominators " + json.dumps(odd),
          flush=True)
    if not odd["ok"]:
        failures.append(f"lab9 odd denominators: {odd}")
    by = {(r["mode"], r["count"]): r["out"] for r in res9}
    nocat_same = all(torch.equal(by["full", c].view(torch.int32),
                                 by[m, c].view(torch.int32))
                     for c in l9.COUNTS for m in ("nocat", "exit"))
    if not nocat_same:
        failures.append("lab9: nocat or exit departs from full on the card")
    full10 = {r["wave"]: r["out"] for r in res10 if r["mode"] == "full"}
    for r in res10:
        key = f"{r['mode']}/{r['wave']}"
        counts, keys, r3, idmask = args10[r["wave"]]
        ts = _mid_tiles(counts.shape[0])
        ref, ms = timed(lambda: l10.lab10_reference(
            counts[ts], keys[ts], r3[ts], tracer.tris12, r["mode"], idmask))
        extra = l10.lab10_agreement(r["out"][ts], ref, counts[ts], r3[ts],
                                    tracer.tris12, r["mode"],
                                    full=full10[r["wave"]][ts])
        if not extra["ok"]:
            failures.append(f"lab10 {key}: {extra}")
        if r["mode"] == "full":
            # K1 on the whole wave, tie-aware, and timed in turns with it
            t, tid = trace_tiles_vm3(counts, keys, r3, tracer.tris12)
            k1 = l10.lab10_agreement(r["out"], l10.k1_raw(t, tid, r3),
                                     counts, r3, tracer.tris12, "full")
            if not k1["ok"]:
                failures.append(f"lab10 {key}: departs from trace_vm3: {k1}")
            turns = {"k1": [], "lab10": []}
            for side in ("k1", "lab10", "lab10", "k1"):
                fn = (lambda: trace_tiles_vm3(counts, keys, r3,
                                              tracer.tris12)) \
                    if side == "k1" else (lambda: l10.lab10(
                        counts, keys, r3, tracer.tris12, "full", idmask))
                turns[side].append(time_cuda(fn)["ms"])
            extra.update(
                held_to_trace_vm3={k: k1[k] for k in (
                    "ok", "ids_differ", "ties", "ill_conditioned",
                    "t_bits_differ", "max_t_over_bound", "rays_off")},
                trace_vm3_ms=turns["k1"], lab10_full_ms=turns["lab10"],
                lab10_over_trace_vm3=min(turns["lab10"]) / min(turns["k1"]),
                tile_spread=r["tile_spread"])
            print(f"phase 20 lab10 against K1 {r['wave']} " + json.dumps(
                {k: extra[k] for k in ("trace_vm3_ms", "lab10_full_ms",
                                       "lab10_over_trace_vm3",
                                       "tile_spread")}), flush=True)
        extra.pop("rays")        # the held rays: plain_rays
        emit("lab10", key, r, ms, extra["max_abs_t"], rays=r["rays"],
             us_per_tile=r["us_per_tile"], gtests_s=r["gtests_s"],
             tiles_over_heads=r["tiles_over_heads"],
             plain_rays=(ts.stop - ts.start) * 32, **extra)
    # L10's redo of a cluster with __frcp_rn: full on the 2^18 wave's held
    # tiles, every 13th direction scaled by 1e-39, every 17th NaN
    counts, keys, r3, idmask = args10["bounce_512"]
    ts = _mid_tiles(counts.shape[0])
    r_odd = r3[ts].clone()
    r_odd.view(-1, 8)[::13, 3:6] *= 1e-39
    r_odd.view(-1, 8)[::17, 3:6] = float("nan")
    args = (counts[ts], keys[ts], r_odd, tracer.tris12, "full", idmask)
    odd = l10.lab10_agreement(l10.lab10(*args), l10.lab10_reference(*args),
                              counts[ts], r_odd, tracer.tris12, "full")
    print("phase 20 lab10 full/bounce_512 odd denominators " +
          json.dumps(odd), flush=True)
    if not odd["ok"]:
        failures.append(f"lab10 odd denominators: {odd}")
    for r in res11:
        tris = in11["tris12"] if r["mode"] == "vpu" else in11["m"]

        def plain():
            return l11.lab11_reference(in11["steps"], in11["rays"], tris,
                                       r["mode"])
        if r["mode"] == "vpu":     # the FMA body: tie-aware
            ref, ms = timed(plain)
            extra = l11.vpu_agreement(r["out"], ref, in11["rays"],
                                      in11["tris12"])
            err = extra["max_abs_t"]
            if not extra["ok"]:
                failures.append(f"lab11 vpu: {extra}")
        else:
            ref, ms = timed(plain)
            extra = l11.mxu_agreement(r["out"], ref, in11["rays"],
                                      in11["m"])
            err = float((r["out"][..., 0] - ref[..., 0]).abs().max())
            if not extra["ok"]:
                failures.append(f"lab11 mxu: {extra}")
        emit("lab11", r["mode"], r, ms, err, us_per_step=r["us_per_step"],
             gtests_s=r["gtests_s"], plain_rays=r["out"].shape[0] * 32,
             **extra)
    print("phase 20 " + json.dumps(dict(
        run_s=run_s, seconds=time.perf_counter() - t0,
        lab9_full_equals_nocat_and_exit=nocat_same)), flush=True)
    if failures:
        raise RuntimeError("phase 20: " + "; ".join(failures))
    rows = []
    for lab, ms in modes.items():
        head = ms[LAB_HEADLINE[lab]]
        rows.append({
            "name": lab, "route": "cuda",
            "source": "tauray_torch/csrc/k1_lab.cu",
            "replaces": LAB_SITES[lab], "launches": launches[lab],
            "max_abs_err": max(m["max_abs_err"] for m in ms.values()),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            # no single PyTorch call computes any lab's function
            "library_ms": None, "mode": LAB_HEADLINE[lab],
            "modes": {k: {f: m[f] for f in (
                "ms", "ms_back_to_back", "ms_graph", "plain_ms", "bound_ms",
                "bound_by") if f in m} for k, m in ms.items()}})
        if lab == "lab8":    # the kernel's own time, the host path left out
            rows[-1].update(ms_back_to_back=head["ms_back_to_back"],
                            ms_graph=head["ms_graph"])
    return rows


# ---------------------------------------------------------------------------
# Phase 21: the brick and resident-table labs (tauray_torch/lab,
# csrc/brick_lab.cu)
# ---------------------------------------------------------------------------

BRICK_SITES = {"lab4": "scripts/kernel_lab2.py:234",
               "lab5": "scripts/kernel_lab3.py:172",
               "lab6": "scripts/kernel_lab4.py:199",
               "lab7": "scripts/kernel_lab5.py:159"}
# the configuration (mode, rays a tile, KB, steps) whose times stand at the
# top of each lab's kernels-line row: bounds.CONFIGS's
BRICK_HEADLINE = {"lab4": ("mt", 32, 4, 13), "lab5": ("mt", 32, 1, 52),
                  "lab6": ("fixed", 32, 8, 6), "lab7": ("mt", 32, 8, 6)}
def brick_phase(dev):
    """Phase 21: L4-L7 through their entry points' run() at the scripts'
    sizes, every configuration of each main timed (one call, and back to
    back); the launches counted over that run alone. Then each
    configuration held to its plain version on the same inputs by
    brick.agreement (L4 mtfast by mtfast_agreement; L4 mt and L5-L7 by
    brick_agreement, L7 on LAB_SLICE_TILES tiles of each); L4 at k7 KB 4
    and L5-L7 again on odd denominators; and L6's while / while2 on a
    meta where the exit fires (every 8th entry 0x7f000000, at the
    headline's inputs), held the same way with their steps walked per
    tile, and walking fewer steps and hitting less than fixed. Returns the
    kernels line's rows."""
    import torch
    from tauray_torch.lab import brick, lab_kernel
    from tauray_torch.lab import kernel_lab2 as l4
    from tauray_torch.lab import kernel_lab3 as l5
    from tauray_torch.lab import kernel_lab4 as l6
    from tauray_torch.lab import kernel_lab5 as l7
    from tauray_torch.lab.bounds import brick_bound
    from tauray_torch.lab.common import ROW, time_cuda
    t0 = time.perf_counter()
    lab_kernel.reset_launch_counts()
    res = {"lab4": l4.run(dev), "lab5": l5.run(dev), "lab6": l6.run(dev),
           "lab7": l7.run(dev)}
    torch.cuda.synchronize()
    launches = {lab: lab_kernel.LAUNCHES[lab] for lab in BRICK_SITES}
    run_s = time.perf_counter() - t0
    print("phase 21 launches " + json.dumps(launches), flush=True)
    if any(v <= 0 for v in launches.values()):
        raise RuntimeError(f"phase 21: a lab never launched: {launches}")
    failures, configs = [], {}

    def hold(tag, cfg, out, plain, meta, rays, tris, steps=None):
        """(plain ms, max |t - t_plain|, the hold's record): plain()
        against the kernel's out on their inputs, by brick.agreement (L4
        mtfast by mtfast_agreement, the others by brick_agreement; with
        steps: both sides' walked steps)."""
        ref, ms = timed(plain)
        agree = brick.agreement(cfg.lab, cfg.mode, out, ref, meta, rays,
                                tris, cfg.kb, steps)
        if not agree["ok"]:
            failures.append(f"{tag}: {agree}")
        return ms, float((out[..., 0] - ref[..., 0]).abs().max()), agree

    for lab, rs in res.items():
        for r in rs:
            c = r["cfg"]
            n = min(c.n_tiles, LAB_SLICE_TILES) if lab == "lab7" else \
                c.n_tiles
            key = f"{c.label.strip()} steps={c.steps}"

            def plain():
                return brick.walk_reference(
                    c.lab, c.mode, r["meta"][:n * ROW], r["rays"][:n],
                    r["tris"], c.kb, c.steps)
            ms, err, agree = hold(f"{lab} {key}", c, r["out"][:n], plain,
                                  r["meta"][:n * ROW], r["rays"][:n],
                                  r["tris"])
            e = dict(ms=r["ms"], min_ms=r["min_ms"],
                     ms_back_to_back=r["ms_back_to_back"],
                     us_per_tile=r["us_per_tile"], gtests_s=r["gtests_s"],
                     bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                     plain_ms=ms, plain_rays=n * c.tile, max_abs_err=err,
                     hits=brick.hits(r["out"], c), **agree)
            if c.mode == "mtfast":     # the kernel's, the plain version's
                e["t_negative"], e["t_negative_plain"] = agree["t_negative"]
            e["headline"] = (c.mode, c.tile, c.kb, c.steps) == \
                BRICK_HEADLINE[lab]
            configs.setdefault(lab, {})[key] = e
            print(f"phase 21 {lab} {key} " + json.dumps(e), flush=True)
    # the walk's redo of a step (L4: a cluster) with __frcp_rn: every 13th
    # direction scaled by 1e-39 (a subnormal den), every 17th NaN
    odd_runs = {"lab4": (("mt", 32, 4, 13), ("mtfast", 32, 4, 13)),
                "lab5": (("mt", 32, 1, 52), ("mt", 8, 1, 14)),
                "lab6": tuple((v, 32, 8, 6) for v in (
                    "fixed", "slot", "cid", "while", "while2")),
                "lab7": (("mt", 32, 8, 6), ("bw", 32, 8, 6))}
    for lab, shapes in odd_runs.items():
        for r in res[lab]:
            c = r["cfg"]
            if (c.mode, c.tile, c.kb, c.steps) not in shapes:
                continue
            n = min(c.n_tiles, LAB_SLICE_TILES) if lab == "lab7" else \
                c.n_tiles
            rays = r["rays"][:n].clone()
            rays.view(-1, 8)[::13, 3:6] *= 1e-39
            rays.view(-1, 8)[::17, 3:6] = float("nan")
            args = (lab, c.mode, r["meta"][:n * ROW], rays, r["tris"], c.kb,
                    c.steps)
            odd = brick.agreement(*args[:2], brick.brick(*args),
                                  brick.walk_reference(*args), *args[2:5],
                                  c.kb)
            tag = f"{lab} {c.label.strip()} steps={c.steps} odd denominators"
            print(f"phase 21 {tag} " + json.dumps(odd), flush=True)
            if not odd["ok"]:
                failures.append(f"{tag}: {odd}")
    # L6's exit where it fires, on the headline's inputs
    r = next(r for r in res["lab6"] if (
        r["cfg"].mode, r["cfg"].tile, r["cfg"].kb, r["cfg"].steps) ==
        BRICK_HEADLINE["lab6"])
    meta = r["meta"].clone()
    meta[::8] = 0x7F000000
    lab_kernel.reset_launch_counts()
    fixed = brick.walk_reference("lab6", "fixed", meta, r["rays"], r["tris"],
                                 r["cfg"].kb, r["cfg"].steps)
    for v in ("while", "while2"):
        c = r["cfg"]._replace(mode=v)

        def walk(steps=c.steps):
            return brick.brick("lab6", v, meta, r["rays"], r["tris"], c.kb,
                               steps)

        def walk_plain(steps=c.steps, stats=None):
            return brick.walk_reference("lab6", v, meta, r["rays"],
                                        r["tris"], c.kb, steps, stats)
        t = time_cuda(walk)
        out = walk()
        walked = [brick.walked_steps(f, c.steps) for f in (walk, walk_plain)]
        stats = {}
        ms, err, agree = hold(f"lab6 {v} exit", c, out,
                              lambda: walk_plain(stats=stats), meta,
                              r["rays"], r["tris"], walked)
        e = dict(ms=t["ms"], min_ms=t["min_ms"], plain_ms=ms,
                 max_abs_err=err, tile_steps=stats["steps"],
                 tile_steps_needed=int(walked[0].sum()),
                 tile_steps_needed_plain=int(walked[1].sum()),
                 tile_steps_fixed=c.n_tiles * c.steps,
                 hits=brick.hits(out, c), hits_fixed=brick.hits(fixed, c),
                 **agree)
        e["bound_ms"], e["bound_by"] = brick_bound(c, stats["steps"])
        if not (e["tile_steps"] < e["tile_steps_fixed"] and
                e["tile_steps_needed"] < e["tile_steps_fixed"] and
                e["hits"] < e["hits_fixed"]):
            failures.append(f"lab6 {v}: the exit did not fire: {e}")
        configs["lab6"][f"{v} exit fires"] = e
        print(f"phase 21 lab6 {v} exit fires " + json.dumps(e), flush=True)
    if lab_kernel.LAUNCHES["lab6"] < 2:
        failures.append("lab6's exit runs never launched")
    print("phase 21 " + json.dumps(dict(
        run_s=run_s, seconds=time.perf_counter() - t0)), flush=True)
    if failures:
        raise RuntimeError("phase 21: " + "; ".join(failures))
    rows = []
    for lab, cs in configs.items():
        head = next(e for e in cs.values() if e.get("headline"))
        rows.append({
            "name": lab, "route": "cuda",
            "source": "tauray_torch/csrc/brick_lab.cu",
            "replaces": BRICK_SITES[lab], "launches": launches[lab],
            "max_abs_err": max(e["max_abs_err"] for e in cs.values()),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            # no single PyTorch call computes any lab's function
            "library_ms": None,
            "ms_back_to_back": head["ms_back_to_back"],
            "configuration": next(k for k, e in cs.items()
                                  if e.get("headline")),
            "configurations": {k: {f: e[f] for f in (
                "ms", "ms_back_to_back", "plain_ms", "bound_ms", "bound_by")
                if f in e} for k, e in cs.items()}})
    return rows


# ---------------------------------------------------------------------------
# Phase 22: the 128-ray tile labs and the Plücker lab (tauray_torch/lab,
# csrc/tile_lab.cu, csrc/mxu_lab.cu)
# ---------------------------------------------------------------------------

TILE_SITES = {"lab1": "scripts/kernel_lab.py:61",
              "lab2": "scripts/kernel_lab.py:424",
              "lab3": "scripts/kernel_lab.py:586",
              "lab12": "scripts/mxu_lab.py:66"}
TILE_SOURCES = {"lab1": "tauray_torch/csrc/tile_lab.cu",
                "lab2": "tauray_torch/csrc/tile_lab.cu",
                "lab3": "tauray_torch/csrc/tile_lab.cu",
                "lab12": "tauray_torch/csrc/mxu_lab.cu"}
# the configuration whose times stand at the top of each row: k3, k4 and
# k5 G = 8 at 8 steps; L12 plucker (mt beside it)
TILE_HEADLINE = {"lab1": "k3 G=1 steps=8", "lab2": "k4 G=8 steps=8",
                 "lab3": "k5 G=8 steps=8", "lab12": "plucker"}


def tile_phase(dev):
    """Phase 22: L1-L3 through kernel_lab.run(dev) at the script's size
    (k0 and k1 at 0 and 1 steps; k2, k3, k4, k5 at G 8 and 32 at 0, 1, 2,
    4 and 8) and L12 through mxu_lab.run(dev), each timed (median and min
    of 5 CUDA-event runs of one call, and of 5 windows of 20 calls back to
    back; k0-k2 also by CUDA-graph replay); the launches counted over that
    run alone. Then L1 k0-k2 held to their plain versions bit for bit; k3,
    k4 and k5 (one template, the FMA body) by kernel_lab.lab3_agreement,
    L12 mt (the brick walk's FMA body) by mxu_lab.mt_agreement on every
    ray and again on odd denominators, plucker by
    mxu_lab.plucker_agreement; k4 and k5 equal to k3 bit for bit at each
    step count on the script's meta (the exit never fires there and the
    three share the body); on a meta whose tnear third is 0x7f000000 the
    exit of k4 and k5 fires (one step a tile, fewer hits than k3), held the
    same way with the steps walked per tile (kernel_lab.walked_steps) held
    to the plain version's, each timed both ways too; k3, k4 and k5 again
    on odd denominators. Prints the intercept and slope of ms, and of the
    ms back to back, over steps of k2-k5. Returns the kernels line's
    rows."""
    import torch
    from tauray_torch.lab import kernel_lab as kl
    from tauray_torch.lab import lab_kernel
    from tauray_torch.lab import mxu_lab as ml
    from tauray_torch.lab.bounds import tile_bound
    from tauray_torch.lab.common import (CPAD, ROW_L1, time_back_to_back,
                                         time_cuda)
    t0 = time.perf_counter()
    lab_kernel.reset_launch_counts()
    inp, res = kl.run(dev, ("k0", "k1", "k2", "k3", "k4", "k5", "k532"))
    linp, lres = ml.run(dev)
    torch.cuda.synchronize()
    launches = {lab: lab_kernel.LAUNCHES[lab] for lab in TILE_SITES}
    run_s = time.perf_counter() - t0
    print("phase 22 launches " + json.dumps(launches), flush=True)
    if any(v <= 0 for v in launches.values()):
        raise RuntimeError(f"phase 22: a lab never launched: {launches}")
    failures, configs = [], {}
    n_tiles = inp["n_tiles"]
    lab_of = {"k4": "lab2", "k5": "lab3"}

    def hold(tag, name, out, plain):
        """(plain ms, max |t - t_plain|): plain() against the kernel's
        out, t and id bits alike."""
        ref, ms = timed(plain)
        (t, i), (t_r, i_r) = kl.flat(name, out), kl.flat(name, ref)
        off = int(((t.view(torch.int32) != t_r.view(torch.int32)) |
                   (i != i_r)).sum())
        if off:
            failures.append(f"{tag}: {off} rays depart from the plain "
                            f"version")
        return ms, float((t - t_r).abs().max())

    def hold3(tag, name, out, ref, data, steps=None):
        """lab3_agreement of name's out against ref (as name's kernel
        returns it) on data's meta and rows: the agreement, without its
        list of turned rays where it is empty."""
        agree = kl.lab3_agreement(out, ref, data["meta"], data["rows"],
                                  data["tris9"], steps, name)
        if not agree["ok"]:
            failures.append(f"{tag}: {agree}")
        if not agree["held"]:
            del agree["held"]
        return agree

    k3 = {r["cfg"].steps: kl.flat("k3", r["out"]) for r in res
          if r["cfg"].name == "k3"}
    for r in res:
        c = r["cfg"]
        lab = lab_of.get(c.name, "lab1")
        key = f"{c.name} G={c.group} steps={c.steps}"
        agree = {}
        if c.name in ("k3", "k4", "k5"):     # the FMA body: tie-aware
            ref, ms = timed(lambda: kl.call_reference(c, inp, r["counts"]))
            agree = hold3(f"{lab} {key}", c.name, r["out"], ref, inp)
            err = agree["max_abs_t"]
        else:
            ms, err = hold(f"{lab} {key}", c.name, r["out"],
                           lambda: kl.call_reference(c, inp, r["counts"]))
        e = dict(ms=r["ms"], min_ms=r["min_ms"], max_ms=r["max_ms"],
                 ms_back_to_back=r["ms_back_to_back"],
                 min_ms_back_to_back=r["min_ms_back_to_back"],
                 max_ms_back_to_back=r["max_ms_back_to_back"],
                 ms_graph=r["ms_graph"], min_ms_graph=r["min_ms_graph"],
                 max_ms_graph=r["max_ms_graph"],
                 us_per_tile=r["us_per_tile"],
                 gtests_s=r["gtests_s"], bound_ms=r["bound_ms"],
                 bound_by=r["bound_by"], plain_ms=ms, max_abs_err=err,
                 blocks=n_tiles, staged_bytes=r["staged_bytes"], **agree)
        e.pop("rays", None)
        if c.name in ("k4", "k5"):   # one body: bit for bit to k3
            t3, i3 = k3[c.steps]
            t, i = kl.flat(c.name, r["out"])
            e["equals_k3"] = bool(torch.equal(i, i3) and torch.equal(
                t.view(torch.int32), t3.view(torch.int32)))
            if not e["equals_k3"]:
                failures.append(f"{lab} {key}: departs from k3")
        configs.setdefault(lab, {})[key] = e
        print(f"phase 22 {lab} {key} " + json.dumps(e), flush=True)
    for key in ("ms", "ms_back_to_back"):
        for (name, group), (icpt, slope) in kl.step_fit(res, key).items():
            if name not in ("k0", "k1"):
                print(f"phase 22 fit {key} {name} G={group} " + json.dumps(
                    dict(intercept_ms=icpt, slope_ms_a_step=slope)),
                    flush=True)
    # the exit where it fires: the tnear third of every row 0x7f000000
    meta = inp["meta"].view(n_tiles, ROW_L1).clone()
    meta[:, CPAD:2 * CPAD] = 0x7F000000
    crafted = dict(inp, meta=meta.view(-1))
    counts = kl.counts_of(n_tiles, 8, dev)
    hits3 = int((k3[8][1] >= 0).sum())
    lab_kernel.reset_launch_counts()
    for name, group in (("k4", 8), ("k5", 8), ("k5", 32)):
        c = kl.TileConfig(name, group, 8, "")
        lab = lab_of[name]
        t = time_cuda(lambda: kl.call(c, crafted, counts))
        t.update(time_back_to_back(lambda: kl.call(c, crafted, counts)))
        out = kl.call(c, crafted, counts)
        stats = {}
        # and the steps each tile walked
        ref, ms = timed(lambda: kl.call_reference(c, crafted, counts,
                                                  stats))
        walked = [kl.walked_steps(lambda n: fn(c, crafted, n), counts)
                  for fn in (kl.call, kl.call_reference)]
        agree = hold3(f"{lab} {name} G={group} exit", name, out, ref,
                      crafted, walked)
        agree.pop("rays")
        agree["walked_steps_kernel"] = int(walked[0].sum())
        agree["walked_steps_plain"] = int(walked[1].sum())
        hits = int((kl.flat(name, out)[1] >= 0).sum())
        e = dict(**t, plain_ms=ms,
                 max_abs_err=agree["max_abs_t"], tile_steps=stats["steps"],
                 tile_steps_k3=n_tiles * 8, hits=hits, hits_k3=hits3,
                 **agree)
        e["bound_ms"], e["bound_by"] = tile_bound(name, 8, n_tiles,
                                                  stats["steps"])
        if not (e["tile_steps"] == n_tiles and hits < hits3):
            failures.append(f"{lab} {name}: the exit did not fire: {e}")
        configs[lab][f"{name} G={group} steps=8 exit fires"] = e
        print(f"phase 22 {lab} {name} G={group} exit fires " + json.dumps(e),
              flush=True)
    if lab_kernel.LAUNCHES["lab2"] < 1 or lab_kernel.LAUNCHES["lab3"] < 2:
        failures.append("the exit runs never launched")
    # the redo of a warp's share with __frcp_rn: k3, k4 and k5 at 8 steps,
    # every 13th direction scaled by 1e-39, every 17th NaN
    rows = inp["rows"].clone()
    rows.view(-1, 8)[::13, 3:6] *= 1e-39
    rows.view(-1, 8)[::17, 3:6] = float("nan")
    odd_inp = dict(inp, rows=rows,
                   cols=rows.view(-1, 8).t().contiguous(),
                   planes=rows.transpose(1, 2).contiguous())
    for name, lab in (("k3", "lab1"), ("k4", "lab2"), ("k5", "lab3")):
        c = kl.TileConfig(name, 1 if name == "k3" else 8, 8, "")
        odd = hold3(f"{lab} {name} odd denominators", name,
                    kl.call(c, odd_inp, counts),
                    kl.call_reference(c, odd_inp, counts), odd_inp)
        print(f"phase 22 {lab} {name} G={c.group} steps=8 odd denominators "
              + json.dumps(odd), flush=True)
    for r in lres:
        tris = linp["tris9" if r["mode"] == "mt" else "tris24"]

        def plain():
            return ml.lab12_reference(linp["order"], linp["o3"], linp["d3"],
                                      linp["mm2"], tris, r["mode"])
        e = dict(ms=r["ms"], min_ms=r["min_ms"],
                 ms_back_to_back=r["ms_back_to_back"],
                 min_ms_back_to_back=r["min_ms_back_to_back"],
                 us_per_tile=r["ms"] * 1e3 / linp["order"].shape[0],
                 gtests_s=r["gtests_s"], bound_ms=r["bound_ms"],
                 bound_by=r["bound_by"], blocks=linp["order"].shape[0])
        ref, e["plain_ms"] = timed(plain)
        # mt: the walk's FMA body, tie-aware on every ray
        agree = (ml.mt_agreement if r["mode"] == "mt" else
                 ml.plucker_agreement)(r["out"], ref, linp)
        e["max_abs_err"] = agree["max_abs_t"]
        e.update(agree)
        if not agree["ok"]:
            failures.append(f"lab12 {r['mode']}: {agree}")
        configs.setdefault("lab12", {})[r["mode"]] = e
        print(f"phase 22 lab12 {r['mode']} " + json.dumps(e), flush=True)
    # mt's redo of a step with __frcp_rn: every 13th direction scaled by
    # 1e-39 (a subnormal a), every 17th NaN, and every 7th along x against
    # every 5th triangle laid in the xy plane (a exactly 0)
    d_odd = linp["d3"].clone()
    d_odd.view(-1, 3)[::7] = torch.tensor([1.0, 0.0, 0.0], device=dev)
    d_odd.view(-1, 3)[::13] *= 1e-39
    d_odd.view(-1, 3)[::17] = float("nan")
    t_odd = linp["tris9"].clone()
    t_odd[:, 5, 0, ::5] = 0.0
    t_odd[:, 8, 0, ::5] = 0.0
    odd_inp = dict(linp, d3=d_odd, tris9=t_odd)
    args = (linp["order"], linp["o3"], d_odd, linp["mm2"], t_odd, "mt")
    odd = ml.mt_agreement(ml.lab12(*args), ml.lab12_reference(*args),
                          odd_inp)
    print("phase 22 lab12 mt odd denominators " + json.dumps(odd),
          flush=True)
    if not odd["ok"]:
        failures.append(f"lab12 mt odd denominators: {odd}")
    print("phase 22 " + json.dumps(dict(
        run_s=run_s, seconds=time.perf_counter() - t0)), flush=True)
    if failures:
        raise RuntimeError("phase 22: " + "; ".join(failures))
    rows = []
    for lab, cs in configs.items():
        head = cs[TILE_HEADLINE[lab]]
        row = {
            "name": lab, "route": "cuda", "source": TILE_SOURCES[lab],
            "replaces": TILE_SITES[lab], "launches": launches[lab],
            "max_abs_err": max(e["max_abs_err"] for e in cs.values()),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            # no single PyTorch call computes any lab's function
            "library_ms": None, "configuration": TILE_HEADLINE[lab],
            "configurations": {k: {f: e[f] for f in (
                "ms", "ms_back_to_back", "ms_graph", "plain_ms", "bound_ms",
                "bound_by") if f in e} for k, e in cs.items()},
            "ms_back_to_back": head["ms_back_to_back"]}
        rows.append(row)
    return rows


def main() -> int:
    t_main = time.perf_counter()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    from tauray_torch.app.kernel_waves import (kernel_waves, retrace_slice,
                                               tie_rays, tie_stack,
                                               tie_stack_instanced)
    from tauray_torch.ops import trace_kernel
    dev = torch.device("cuda")
    card = card_line()
    print(f"phase 1 card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # a build directory of this run's own: every kernel is built here from
    # the checkout's sources, so phase 2 reads ptxas's report of each
    trace_kernel.BUILD_DIR = os.path.join(trace_kernel.BUILD_DIR,
                                          f"smoke-{os.getpid()}")
    trace_kernel.build_all()
    sass = {}
    for name, info in sorted(trace_kernel.BUILD_INFO.items()):
        print(f"phase 2 build {name}: {info['seconds']:.2f} s; " +
              " | ".join(ptxas_lines(str(info["log"]))), flush=True)
        if name == "trace_tiles":     # K1-K5; the labs' are 20's, 21's
            sass.update(sass_loops(str(info["path"])))
    for fn, st in sorted(sass.items()):
        print(f"phase 2 sass {fn}: " + json.dumps(st), flush=True)
    # the redesigned labs' kernels (L9, L4-L7, L10, L11, L1-L3): SASS a
    # test, and no spill (L1-L3: the six instances of tile_walk_kernel,
    # three with a test)
    from tauray_torch.app import sass as sass_mod
    lab_sass, spilled = {}, {}
    for lib in ("k1_lab", "brick_lab", "tile_lab", "mxu_lab"):
        info = trace_kernel.BUILD_INFO[lib]
        lab_sass.update(sass_mod.lab_test_loops(str(info["path"])))
        spilled.update(sass_mod.spills(
            str(info["log"]), r"lab8_kernel|lab9_kernel|brick_walk_kernel|"
                              r"lab10_kernel|lab11_|lab12_|tile_walk_kernel"))
    walk_regs = sass_mod.registers(
        str(trace_kernel.BUILD_INFO["brick_lab"]["log"]), r"brick_walk_kernel")
    l11_regs = sass_mod.registers(
        str(trace_kernel.BUILD_INFO["k1_lab"]["log"]), r"lab11_")
    l8_regs = sass_mod.registers(
        str(trace_kernel.BUILD_INFO["k1_lab"]["log"]), r"lab8_kernel")
    l12_regs = sass_mod.registers(
        str(trace_kernel.BUILD_INFO["mxu_lab"]["log"]),
        r"brick_walk_kernel|lab12_")
    for inst, st in sorted(lab_sass.items()):
        print(f"phase 2 sass {inst}: " + json.dumps(st), flush=True)
    print("phase 2 spills " + json.dumps(spilled), flush=True)
    print("phase 2 registers brick_walk_kernel " + json.dumps(walk_regs),
          flush=True)
    print("phase 2 registers lab11 " + json.dumps(l11_regs), flush=True)
    print("phase 2 registers lab8 " + json.dumps(l8_regs), flush=True)
    print("phase 2 registers lab12 " + json.dumps(l12_regs), flush=True)
    # L9 5 modes, L10 4, L11 2, L12 2, L1-L3 3 with a test; the walk: L4 2
    # x 3 tiles, L7 2, L6 4 x 3 tiles; spills: L8 4, L9 5, L10 4, L11 2,
    # L12 2, the tile walk 6, the brick walk 20
    walk_insts = {f"lab6 {v} TILE={t}" for v in sass_mod.VARIANTS
                  for t in (8, 16, 32)} | {"lab7 mt", "lab7 bw"} | {
        f"lab4 {b} TILE={t}" for b in ("mt", "mtfast") for t in (8, 16, 32)}
    if len(lab_sass) != 36 or len(spilled) != 43 or any(spilled.values()) \
            or not {"lab1 k3", "lab2", "lab3", "lab11 vpu", "lab11 mxu",
                    "lab12 mt", "lab12 plucker"} | \
            walk_insts <= set(lab_sass) or len(walk_regs) != 20 or \
            max(walk_regs.values()) > 128 or len(l11_regs) != 2 or \
            len(l8_regs) != 4 or len(l12_regs) != 2:
        raise RuntimeError(f"the redesigned labs' instances: "
                           f"{sorted(lab_sass)}, spills {spilled}, "
                           f"registers {walk_regs}, {l11_regs}, {l8_regs}, "
                           f"{l12_regs}")
    if len(sass) != 2 * 4 or any(st["lds_narrow"] for st in sass.values()):
        raise RuntimeError("not every instance of trace_tiles has a test "
                           "loop of 16-byte shared loads only")
    if any(int(n) for n in re.findall(
            r"(\d+) bytes spill", str(trace_kernel.BUILD_INFO[
                "trace_tiles"]["log"]))):
        raise RuntimeError("an instance of trace_tiles spills")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = sm_clock_hz()

    def sass_of(kernel: str, w: int):
        """The test loop statistics of kernel's instance at W = w."""
        e, rows, inst = INSTANCE[kernel]
        tag = f"trace_tiles_kernelILi{w}ELb{e}ELi{rows}ELb{inst}E"
        return next(st for fn, st in sass.items() if tag in fn)

    tracer, waves = kernel_waves(dev)
    k1 = kernel_check(tracer, waves)
    # phase 20's L9 table and L10 waves
    lab_tracer, lab_bounce = tracer, {"bounce_512": waves["bounce"]}
    del tracer, waves
    tracer, waves = kernel_waves(dev, size=1024)
    k1.update(kernel_check(tracer, {"bounce_2^20": waves["bounce"]}))
    lab_bounce["bounce_1024"] = waves["bounce"]
    del tracer, waves
    ties = tie_stack(dev)
    tie_wave = {"ties": torch.from_numpy(tie_rays(8192)).to(dev)}
    k1.update(kernel_check(ties, tie_wave))
    tracer, waves = kernel_waves(dev, SCENE_LARGE)
    if tracer.n_clusters <= 2197:
        raise RuntimeError(f"{SCENE_LARGE} has {tracer.n_clusters} clusters"
                           ", not past the id-only key path")
    k2 = kernel_check_mt(tracer, waves, "K2")
    del tracer, waves
    tracer, waves = kernel_waves(dev, SCENE_LARGE, size=1024)
    k2.update(kernel_check_mt(tracer, {"bounce_2^20": waves["bounce"]},
                              "K2"))
    del tracer, waves
    k2.update(kernel_check_mt(ties, tie_wave, "K2"))
    tracer, waves = kernel_waves(dev, strategy="per-model")
    k3 = kernel_check_mt(tracer, waves, "K3")
    del tracer, waves
    tracer, waves = kernel_waves(dev, strategy="per-model", size=1024)
    k3.update(kernel_check_mt(tracer, {
        "bounce_unsorted_2^20": waves["bounce_unsorted"]}, "K3"))
    del tracer, waves
    k3.update(kernel_check_mt(tie_stack_instanced(dev), tie_wave, "K3"))
    tracer, waves = kernel_waves(dev, SCENE_FOLIAGE, shadow=True)
    if tracer.n_clusters > 2197 or bool(tracer.opaque.all()):
        raise RuntimeError(f"{SCENE_FOLIAGE}: {tracer.n_clusters} clusters, "
                           f"{int((tracer.opaque == 0).sum())} not opaque")
    waves["bounce_32768"] = retrace_slice(waves["bounce"])
    k1.update(kernel_check(tracer, {"foliage_bounce_32768":
                                    waves["bounce_32768"]}))
    k4 = kernel_check_mt(tracer, waves, "K4")
    k5 = kernel_check_mt(tracer, waves, "K5")
    del tracer, waves
    tracer, waves = kernel_waves(dev, SCENE_FOLIAGE, size=1024)
    waves = {"bounce_2^20": waves["bounce"]}
    k4.update(kernel_check_mt(tracer, waves, "K4"))
    k5.update(kernel_check_mt(tracer, waves, "K5"))
    del tracer, waves
    k4.update(kernel_check_mt(ties, tie_wave, "K4"))
    k5.update(kernel_check_mt(ties, tie_wave, "K5"))
    del ties, tie_wave
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        ms, img, launches, peak = main_path(tmp, "hd", HD)
        mean = check_image(img, 1920, 1080, "1080p")
        if launches["trace_vm3"] <= 0:
            raise RuntimeError("1080p run never launched trace_vm3")
        l_k1 = launches["trace_vm3"]
        print("phase 4 " + json.dumps(dict(
            size="1920x1080", spp=1, depth=4, frame_ms=ms,
            frame2_ms=ms[-1], mrays_s=LANES_1080P / (ms[-1] * 1e3),
            launches=launches, peak_mem_gb=peak, image_mean=mean)),
            flush=True)
        flat_img = np.asarray(img)[..., :3]

        ms2, img2, launches2, peak2 = main_path(tmp, "sq", [
            "--renderer=path-tracer", "--width=256", "--height=256",
            "--samples-per-pixel=16", "--samples-per-pass=16",
            "--max-ray-depth=4", "--tonemap=linear", "--frames=2"])
        mean2 = check_image(img2, 256, 256, "256^2")
        if launches2["trace_vm3"] <= 0:
            raise RuntimeError("256^2 run never launched trace_vm3")
        lanes2 = 65536 * 16 * (2 * 4 - 1)
        print("phase 5 " + json.dumps(dict(
            size="256x256", spp=16, depth=4, frame_ms=ms2,
            frame2_ms=ms2[-1], mrays_s=lanes2 / (ms2[-1] * 1e3),
            launches=launches2, peak_mem_gb=peak2, image_mean=mean2)),
            flush=True)

        ms6, img6, launches6, peak6 = main_path(
            tmp, "pm", HD + ["--as-strategy=per-model"])
        mean6 = check_image(img6, 1920, 1080, "per-model 1080p")
        if launches6["trace_mt_inst"] <= 0 or launches6["trace_vm3"] != 0:
            raise RuntimeError(f"per-model run launched {launches6}")
        l_k3 = launches6["trace_mt_inst"]
        # the same scene, camera and seeds as phase 4 through the other
        # tracer: the image agrees with phase 4's
        got = np.asarray(img6)[..., :3]
        rel = np.abs(got - flat_img) / np.maximum(np.abs(flat_img), 1e-6)
        within = float((rel.max(-1) <= 1e-3).mean())
        mean_rel = abs(mean6 / mean - 1)
        print("phase 6 " + json.dumps(dict(
            size="1920x1080", spp=1, depth=4, strategy="per-model",
            frame_ms=ms6, frame2_ms=ms6[-1],
            mrays_s=LANES_1080P / (ms6[-1] * 1e3), launches=launches6,
            peak_mem_gb=peak6, image_mean=mean6,
            pixels_within_1e3_of_flat=within, mean_rel_to_flat=mean_rel)),
            flush=True)
        if mean_rel > 1e-2 or within < 0.9:
            raise RuntimeError("per-model image departs from the flat one")

        ms7, img7, launches7, peak7 = main_path(tmp, "lg", HD, SCENE_LARGE)
        mean7 = check_image(img7, 1920, 1080, "large 1080p")
        if launches7["trace_mt"] <= 0:
            raise RuntimeError(f"{SCENE_LARGE} run launched {launches7}")
        l_k2 = launches7["trace_mt"]
        print("phase 7 " + json.dumps(dict(
            size="1920x1080", spp=1, depth=4, scene=SCENE_LARGE,
            frame_ms=ms7, frame2_ms=ms7[-1],
            mrays_s=LANES_1080P / (ms7[-1] * 1e3), launches=launches7,
            peak_mem_gb=peak7, image_mean=mean7)), flush=True)

        # the foliage scene: K1 by default, K4 under TAURAY_VM_KERNEL=v2
        fol = {}
        for tag, vm in (("8a", ""), ("8b", "v2")):
            os.environ["TAURAY_VM_KERNEL"] = vm
            try:
                with alpha_rays() as alpha:
                    ms8, img8, launches8, peak8 = main_path(
                        tmp, f"fol{vm}", HD, SCENE_FOLIAGE)
            finally:
                del os.environ["TAURAY_VM_KERNEL"]
            mean8 = check_image(img8, 1920, 1080, f"foliage 1080p {tag}")
            fol[tag] = (np.asarray(img8)[..., :3], mean8, launches8)
            res = dict(size="1920x1080", spp=1, depth=4, scene=SCENE_FOLIAGE,
                       vm_kernel=vm or "default", frame_ms=ms8,
                       frame2_ms=ms8[-1],
                       mrays_s=LANES_1080P / (ms8[-1] * 1e3),
                       launches=launches8, peak_mem_gb=peak8,
                       image_mean=mean8, alpha_rounds=alpha["rounds"],
                       alpha_rays_skipped=alpha["skipped"],
                       # per wave: its rays, then its pending rays at the
                       # start of each round it ran and after the last
                       alpha_pending=alpha["pending"])
            if tag == "8b":
                ref_img, ref_mean, _ = fol["8a"]
                rel = np.abs(img8[..., :3] - ref_img) / np.maximum(
                    np.abs(ref_img), 1e-6)
                res.update(pixels_within_1e3_of_8a=float(
                    (rel.max(-1) <= 1e-3).mean()),
                    mean_rel_to_8a=abs(mean8 / ref_mean - 1))
            print(f"phase {tag} " + json.dumps(res), flush=True)
            if alpha["skipped"] <= 0:
                raise RuntimeError(f"phase {tag}: no alpha ray serviced")
        if fol["8a"][2]["trace_vm3"] <= 0 or fol["8a"][2]["trace_vm2"] != 0:
            raise RuntimeError(f"foliage default launched {fol['8a'][2]}")
        l_k4 = fol["8b"][2]["trace_vm2"]
        if l_k4 <= 0 or fol["8b"][2]["trace_vm3"] != 0:
            raise RuntimeError(f"foliage v2 launched {fol['8b'][2]}")
        if res["mean_rel_to_8a"] > 1e-2 or \
                res["pixels_within_1e3_of_8a"] < 0.9:
            raise RuntimeError("the v2 foliage image departs from 8a's")

        ms9, img9, launches9, peak9 = main_path(tmp, "sob", [
            "--renderer=path-tracer", "--width=256", "--height=256",
            "--samples-per-pixel=4", "--samples-per-pass=4",
            "--max-ray-depth=4", "--tonemap=linear", "--frames=2",
            "--sampler=sobol-owen"], SCENE_FOLIAGE)
        mean9 = check_image(img9, 256, 256, "sobol-owen 256^2")
        print("phase 9 " + json.dumps(dict(
            size="256x256", spp=4, depth=4, sampler="sobol-owen",
            scene=SCENE_FOLIAGE, frame_ms=ms9, launches=launches9,
            peak_mem_gb=peak9, image_mean=mean9)), flush=True)

    # the wave-statistics tool, the only entry to K5
    from tauray_torch.app import wave_stats
    trace_kernel.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        wave_stats.main()
    l_k5 = trace_kernel.LAUNCHES["trace_vm"]
    lines = buf.getvalue().splitlines()
    for ln in lines:
        print(f"phase 10 {ln}", flush=True)
    n_waves = sum(bool(re.match(r"\d+:", ln)) for ln in lines)
    if l_k5 <= 0 or n_waves != 7:
        raise RuntimeError(f"wave_stats launched K5 {l_k5} times over "
                           f"{n_waves} waves")

    device_update_phase()
    with tempfile.TemporaryDirectory() as tmp:
        post_phase(tmp)
    feature_phase()
    bench_phase()
    with tempfile.TemporaryDirectory() as tmp:
        l_k1_restir = restir_cli_phase(tmp)
        l_k2_restir, k2_restir = restir_large_phase(tmp)
    k1_restir = restir_wave_phase()
    restir_hold_phase("15b", 240, 135, 4, "reconnection-shift")
    restir_hold_phase("15c", 256, 256, 3, "random-replay-shift")
    restir_hold_phase("15c", 256, 256, 3, "hybrid-shift")
    print("phase 15d " + json.dumps(probe_phase("15d", "restir-hybrid")[0]),
          flush=True)
    print("phase 15 launches " + json.dumps(dict(
        trace_vm3_restir_1080p_3_frames=l_k1_restir,
        trace_mt_restir_524k_1_frame=l_k2_restir)), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        l_k1_raster, raster_waves, raster_cap = raster_cli_phase(tmp)
        k1_raster = raster_wave_phase(raster_waves)
        raster_hold_phase(raster_cap)
        del raster_cap
        torch.cuda.empty_cache()
        dshgi = dshgi_phase()
        l_k1_foliage = raster_foliage_phase(tmp)
        l_k2_raster, k2_raster = raster_large_phase(tmp)
    print("phase 16 launches " + json.dumps(dict(
        trace_vm3_raster_1080p_2_frames=l_k1_raster,
        trace_vm3_ddish_gi_1080p_3_frames=dshgi["launches"]["trace_vm3"],
        trace_vm3_raster_foliage_1080p_1_frame=l_k1_foliage,
        trace_mt_raster_524k_1080p_1_frame=l_k2_raster)), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        l_k1_dist = distributed_phase(tmp)
    l_k1_quilt = view_sharded_phase()
    sharded_bake_phase()
    with tempfile.TemporaryDirectory() as tmp:
        lkg_phase(tmp)
    interactive_phase()
    validation_phase()
    with tempfile.TemporaryDirectory() as tmp:
        envmap_phase(tmp)
    lab_rows = lab_phase(dev, lab_tracer, lab_bounce)
    del lab_tracer, lab_bounce
    lab_rows += brick_phase(dev)
    torch.cuda.empty_cache()
    lab_rows += tile_phase(dev)
    torch.cuda.empty_cache()

    def row(name, replaces, launches, r, held, restir=None, raster=None):
        """One kernel's entry, its times on wave r: also W and the SASS
        instructions per test of the instance this wave launches, and the
        bound under -fmad=false: those instructions for every 32 tests
        over 4 issue slots x the SMs x the clock. max_abs_err is the
        largest over every wave held; restir / raster: the waves of a
        ReSTIR frame (15e/15f) and of a raster frame (16b) held, with
        their rays, times and bounds."""
        w = trace_kernel.bw_warps(r["rays"] // 32, n_sm, name)
        st = sass_of(name, w)
        held = {**held, **(restir or {}), **(raster or {})}
        extra = {f"{kind}_waves": {
            k: {f: v[f] for f in ("rays", "ms", "plain_ms", "bound_ms")}
            for k, v in waves.items()}
            for kind, waves in (("restir", restir), ("raster", raster))
            if waves is not None}
        return {"name": name, "route": "cuda",
                "source": "tauray_torch/csrc/trace_tiles.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(v["max_abs_err"] for v in held.values()),
                "waves_held": len(held), "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                # no single PyTorch call computes a closest-hit traversal
                "library_ms": None, "warps": w,
                "sass_instructions_per_test": st["instructions_per_test"],
                "bound_contract_ms": r["tests"] / 32 *
                st["instructions_per_test"] / (4 * n_sm * clock) * 1e3,
                **extra}
    kernels = {"kernels": [
        row("trace_vm3", "tauray_tpu/ops/pallas_trace.py:979", l_k1,
            k1["bounce"], k1, k1_restir, k1_raster),
        row("trace_mt", "tauray_tpu/ops/pallas_trace.py:64", l_k2,
            k2["bounce/closest"], k2, k2_restir, k2_raster),
        # the unsorted wave: the instanced tracer does not sort its rays
        row("trace_mt_inst", "tauray_tpu/ops/pallas_trace.py:297", l_k3,
            k3["bounce_unsorted/closest"], k3),
        row("trace_vm2", "tauray_tpu/ops/pallas_trace.py:745", l_k4,
            k4["bounce/closest"], k4),
        row("trace_vm", "tauray_tpu/ops/pallas_trace.py:565", l_k5,
            k5["bounce/closest"], k5)]}
    kernels["kernels"][0]["launches_raster_1080p_2_frames"] = l_k1_raster
    kernels["kernels"][0]["launches_distributed_1080p_2_frames"] = l_k1_dist
    kernels["kernels"][0]["launches_quilt_5x9"] = l_k1_quilt
    kernels["kernels"][1]["launches_raster_524k_1_frame"] = l_k2_raster
    for r in lab_rows:       # the redesigned labs' SASS a test
        if r["name"] in ("lab2", "lab3"):
            r["sass_instructions_per_test"] = \
                lab_sass[r["name"]]["instructions_per_test"]
        elif r["name"] == "lab1":
            r["sass_instructions_per_test"] = \
                lab_sass["lab1 k3"]["instructions_per_test"]
        elif r["name"] == "lab12":
            r["sass_instructions_per_test"] = {
                m: lab_sass[f"lab12 {m}"]["instructions_per_test"]
                for m in ("mt", "plucker")}
            r["registers"] = {"mt" if "brick_walk" in f else "plucker": n
                              for f, n in l12_regs.items()}
        elif r["name"] == "lab8":
            r["registers"] = l8_regs
        elif r["name"] in ("lab7", "lab9", "lab10", "lab11"):
            r["sass_instructions_per_test"] = {
                k.split()[1]: v["instructions_per_test"]
                for k, v in lab_sass.items()
                if k.split()[0] == r["name"]}
        elif r["name"] in ("lab4", "lab5", "lab6"):  # L5 runs L6 fixed's
            lead = "lab6 fixed " if r["name"] == "lab5" else \
                r["name"] + " "
            r["sass_instructions_per_test"] = {
                k[len(lead):]: v["instructions_per_test"]
                for k, v in lab_sass.items() if k.startswith(lead)}
    kernels["kernels"] += lab_rows
    print(f"chip_smoke seconds {time.perf_counter() - t_main:.1f}",
          flush=True)
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
