"""Times the traversal kernels (K1, K4/K5, K2 and K3, csrc/trace_tiles.cu)
at each W, the warps that share one tile, and phase 1's kernel (P1,
csrc/phase1.cu), on one CUDA card.

    python -m tauray_torch.app.bw_bench [--reps N] [--out FILE]
        [--parent DIR]

P1 runs on the signature-sorted 2^20-ray bounce wave and the 1920x1080
camera wave (2,073,600 rays) of proc://sponza?tris=262144: each result
held bit for bit to the torch passes (ops/cluster.phase1_ids_reference),
then timed with CUDA events beside its issue bound, the SASS instructions
of its cluster loop a ray-box test (app/sass.phase1_loop) times the
wave's tests over the card's issue rate (4 schedulers of 32 lanes an SM
at the maximum SM clock), and beside the torch passes' time; the line
also gives P1's registers and spills (ptxas).

The waves (app/kernel_waves.py), closest hit:
  * K1 and K4: the signature-sorted wave of random directions leaving the
    hits of a 512x512 (2^18 rays) or 1024x1024 (2^20 rays) camera wave, on
    the plain and on the foliage Sponza; a 32,768-ray slice from the middle
    of the 2^18-ray foliage wave (the size of an alpha re-trace); 2^18 rays
    on the duplicate-triangle stack;
  * K2: the sorted 2^18- and 2^20-ray waves of proc://sponza?tris=524288
    (past the id-only key path), its 32,768-ray slice, and the
    duplicate-triangle stack;
  * K3: the per-model Sponza's 2^18-ray wave sorted and unsorted (the
    instanced tracer traces it unsorted), its 2^20-ray wave unsorted, a
    32,768-ray slice of the unsorted 2^18 wave, and the duplicate-triangle
    stack under two instances.
On each it times the kernel at every W it is built for
(trace_kernel.BW_WARPS) with CUDA events, after holding each result bit
for bit to its plain version (K2-K4 also as any hit). With --parent DIR,
the checkout at DIR (its tauray_torch/ops/trace_kernel.py, which builds
that checkout's csrc/ into its own _build/) runs the same inputs through
its public wrapper too, checked against the plain version and timed in
turns with this tree's wrapper: parent, this tree, this tree, parent.
Every line it prints is one JSON object; `w` is the W that
trace_kernel.bw_warps picks for the wave.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

from tauray_torch.app.kernel_waves import (RETRACE_RAYS, SCENE,
                                           SCENE_FOLIAGE, kernel_waves,
                                           retrace_slice, tie_rays,
                                           tie_stack, tie_stack_instanced)
from tauray_torch.app.wave_stats import _ms as cuda_ms
from tauray_torch.ops import trace_kernel as tk

SCENE_LARGE = "proc://sponza?tris=524288"
# kernel -> (LAUNCHES key, public wrapper)
KERNELS = {"K1": ("trace_vm3", "trace_tiles_vm3"),
           "K4": ("trace_vm2", "trace_tiles_vm2"),
           "K2": ("trace_mt", "trace_tiles"),
           "K3": ("trace_mt_inst", "trace_tiles_inst")}


def bench_waves(device):
    """(scene, tracer, {wave: rays8}, kernels) of every wave the tool
    times."""
    tie_wave = {"ties262144": torch.from_numpy(tie_rays(8192)).to(device)}
    for scene in (SCENE, SCENE_FOLIAGE):
        for size in (512, 1024):
            tracer, waves = kernel_waves(device, scene, size)
            rays = {f"bounce{size * size}": waves["bounce"]}
            if size == 512 and scene == SCENE_FOLIAGE:
                rays[f"bounce{RETRACE_RAYS}"] = retrace_slice(
                    waves["bounce"])
            yield scene, tracer, rays, ("K1", "K4")
    yield "tie_stack", tie_stack(device), tie_wave, ("K1", "K4", "K2")
    for size in (512, 1024):
        tracer, waves = kernel_waves(device, SCENE_LARGE, size)
        rays = {f"bounce{size * size}": waves["bounce"]}
        if size == 512:
            rays[f"bounce{RETRACE_RAYS}"] = retrace_slice(waves["bounce"])
        yield SCENE_LARGE, tracer, rays, ("K2",)
    for size in (512, 1024):
        tracer, waves = kernel_waves(device, SCENE, size,
                                     strategy="per-model")
        rays = {f"bounce_unsorted{size * size}": waves["bounce_unsorted"]}
        if size == 512:
            rays[f"bounce{size * size}"] = waves["bounce"]
            rays[f"bounce_unsorted{RETRACE_RAYS}"] = retrace_slice(
                waves["bounce_unsorted"])
        yield f"{SCENE} per-model", tracer, rays, ("K3",)
    yield "tie_stack_instanced", tie_stack_instanced(device), tie_wave, \
        ("K3",)


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi), Hz."""
    return 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def phase1_lines(device, reps, emit):
    """P1's line on each of its two waves (see the module docstring)."""
    from tauray_torch.app import sass
    from tauray_torch.ops.cluster import phase1_ids_reference
    info = tk.BUILD_INFO["phase1"]
    loop = sass.phase1_loop(str(info["path"]), tk.SOURCES["phase1"])
    ptxas = dict(registers=sass.registers(str(info["log"]), "phase1_kernel"),
                 spills=sass.spills(str(info["log"]), "phase1_kernel"))
    issue = torch.cuda.get_device_properties(
        device).multi_processor_count * 4 * 32 * sm_clock_hz()
    tracer, waves = kernel_waves(device, SCENE, 1024)
    rays = {"bounce1048576": waves["bounce"]}
    rays["camera2073600"] = kernel_waves(device, SCENE, 1920, height=1080
                                         )[1]["camera"][:1920 * 1080]
    for wave, r8 in rays.items():
        a = (r8, tracer.cmin, tracer.cmax)
        want = phase1_ids_reference(*a)
        tests = r8.shape[0] * tracer.n_clusters
        res = dict(kernel="P1", scene=SCENE, wave=wave, rays=r8.shape[0],
                   clusters=tracer.n_clusters, tests=tests,
                   clusters_per_tile=float(want[0].double().mean()),
                   torch_ms=cuda_ms(lambda: phase1_ids_reference(*a), 2))
        got = tk.phase1_ids(*a)
        if not (torch.equal(got[0], want[0]) and
                torch.equal(got[1], want[1])):
            raise RuntimeError(f"P1 disagrees on {wave}")
        ms = cuda_ms(lambda: tk.phase1_ids(*a), reps)
        bound = loop["instructions_per_test"] * tests / issue * 1e3
        res.update(ms=ms, bound_ms=bound, pct_of_bound=100 * bound / ms,
                   gtests_per_s=tests / ms * 1e-6)
        emit(**res, sass=loop, **ptxas)
        del want
    del tracer, waves, rays
    torch.cuda.empty_cache()


def wave_args(tracer, rays8, kname):
    """(the public wrapper's arguments but any_hit, clusters visited) of
    kernel kname on one wave."""
    from tauray_torch.ops.cluster import _phase1, _phase1_entry
    r3 = rays8.reshape(-1, 32, 8)
    if kname == "K1":
        counts, keys = _phase1(tracer, rays8)
        return (counts, keys, r3, tracer.tris12), int(counts.sum())
    counts, keys, idmask = _phase1_entry(tracer.cmin, tracer.cmax, rays8)
    if kname == "K4":
        tables = (tracer.tris12, tracer.opaque)
    elif kname == "K2":
        tables = (tracer.tris9, tracer.opaque)
    else:
        tables = (tracer.tris9, tracer.opaque, tracer.k_cluster,
                  tracer.k_inst, tracer.inv.reshape(-1, 12).contiguous())
    return (counts, keys, r3, *tables, idmask), int(counts.sum())


def wrapper(mod, kname, a, any_hit):
    """(t, id) of module mod's public wrapper of kname on arguments a."""
    fn = getattr(mod, KERNELS[kname][1])
    return fn(*a) if kname == "K1" else fn(*a, any_hit)


def plain(kname, a, any_hit):
    """The plain version's (t, id) on arguments a."""
    fn = getattr(tk, KERNELS[kname][1] + "_reference")
    return (fn(*a) if kname == "K1" else fn(*a, any_hit))[:2]


def at_w(kname, a, any_hit, w):
    """(t, id) of this tree's kernel kname at W = w."""
    if kname == "K1":
        return tk._launch_bw(*a, None, 0, False, "trace_vm3", warps=w)[:2]
    if kname == "K4":
        return tk._launch_bw(*a, any_hit, "trace_vm2", warps=w)[:2]
    inst = None if kname == "K2" else a[5:8]
    return tk._launch_mt(*a[:5], inst, a[-1], any_hit, warps=w)[:2]


def same_bits(a, b) -> bool:
    """ids identical and t bit-identical."""
    return (torch.equal(a[1], b[1]) and
            torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)))


def load_parent(root: str):
    """The trace_kernel module of the checkout at root, loaded by path
    under its own name."""
    path = os.path.join(root, "tauray_torch", "ops", "trace_kernel.py")
    spec = importlib.util.spec_from_file_location("parent_trace_kernel",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the lines here")
    ap.add_argument("--parent", default=None,
                    help="a checkout whose kernels are timed in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bw_bench needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    lines = []

    def emit(**kw):
        lines.append(json.dumps(kw))
        print(lines[-1], flush=True)

    emit(card=card, warps=tk.BW_WARPS, parent=args.parent)
    tk.build_all()
    parent = None
    if args.parent:
        parent = load_parent(args.parent)
        parent.build_all()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    phase1_lines(dev, args.reps, emit)
    for scene, tracer, rays, kernels in bench_waves(dev):
        for wave, r8 in rays.items():
            for kname in kernels:
                a, visits = wave_args(tracer, r8, kname)
                n_tiles = a[0].shape[0]
                res = dict(scene=scene, wave=wave, kernel=kname,
                           rays=r8.shape[0], tiles=n_tiles,
                           clusters_per_tile=visits / n_tiles,
                           w=tk.bw_warps(n_tiles, n_sm, KERNELS[kname][0]))
                # the front-to-back kernels also as any hit (checked, not
                # timed)
                modes = (False,) if kname == "K1" else (False, True)
                wants = [plain(kname, a, m) for m in modes]
                for w in tk.BW_WARPS:
                    for m, want in zip(modes, wants):
                        if not same_bits(at_w(kname, a, m, w), want):
                            raise RuntimeError(f"{kname} at W = {w} "
                                               f"disagrees on {wave}")
                    res[f"ms_w{w}"] = cuda_ms(
                        lambda w=w: at_w(kname, a, False, w), args.reps)
                if parent is not None:
                    for m, want in zip(modes, wants):
                        if not same_bits(wrapper(parent, kname, a, m), want):
                            raise RuntimeError(f"the parent's {kname} "
                                               f"disagrees on {wave}")
                    runs = {"parent_ms": [], "ms": []}
                    for side in ("parent_ms", "ms", "ms", "parent_ms"):
                        mod = parent if side == "parent_ms" else tk
                        runs[side].append(cuda_ms(
                            lambda mod=mod: wrapper(mod, kname, a, False),
                            args.reps))
                    res.update(runs)
                emit(**res)
        del tracer, rays
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
