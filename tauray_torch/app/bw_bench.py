"""Times the Baldwin-Weber traversal kernels (K1 and K4/K5,
csrc/trace_bw.cu) at each W, the warps that share one tile, on one CUDA
card.

    python -m tauray_torch.app.bw_bench [--reps N] [--out FILE]

The waves (app/kernel_waves.py): the signature-sorted wave of random
directions leaving the hits of a 512x512 (2^18 rays) or 1024x1024 (2^20
rays) camera wave, on the plain and on the foliage Sponza; a 32,768-ray
slice from the middle of the 2^18-ray foliage wave (the size of an alpha
re-trace); 2^18 rays on the duplicate-triangle stack. On each it times K1
and K4, closest hit, at every W the kernel is built for
(trace_kernel.BW_WARPS) with CUDA events, after holding each result bit
for bit to its plain version (K4 also as any hit). Every line it prints
is one JSON object; `w` is the W that trace_kernel.bw_warps picks for the
wave.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from tauray_torch.app.kernel_waves import (RETRACE_RAYS, SCENE,
                                           SCENE_FOLIAGE, kernel_waves,
                                           retrace_slice, tie_rays,
                                           tie_stack)
from tauray_torch.app.wave_stats import _ms as cuda_ms
from tauray_torch.ops import trace_kernel as tk


def bench_waves(device):
    """(scene, tracer, {wave: rays8}) of every wave the tool times."""
    for scene in (SCENE, SCENE_FOLIAGE):
        for size in (512, 1024):
            tracer, waves = kernel_waves(device, scene, size)
            rays = {f"bounce{size * size}": waves["bounce"]}
            if size == 512 and scene == SCENE_FOLIAGE:
                rays[f"bounce{RETRACE_RAYS}"] = retrace_slice(
                    waves["bounce"])
            yield scene, tracer, rays
    yield "tie_stack", tie_stack(device), {
        "ties262144": torch.from_numpy(tie_rays(8192)).to(device)}


def bw_args(tracer, rays8, exit_):
    """(the arguments of trace_kernel._launch_bw before the kernel name,
    clusters visited) of K1 (exit_ False: id-only keys) or K4 (entry-t
    keys), closest hit, on one wave."""
    from tauray_torch.ops.cluster import _phase1, _phase1_entry
    r3 = rays8.reshape(-1, 32, 8)
    if not exit_:
        counts, keys = _phase1(tracer, rays8)
        return (counts, keys, r3, tracer.tris12, None, 0, False), \
            int(counts.sum())
    counts, keys, idmask = _phase1_entry(tracer.cmin, tracer.cmax, rays8)
    return (counts, keys, r3, tracer.tris12, tracer.opaque, idmask,
            False), int(counts.sum())


def plain(a, exit_):
    """The plain version's (t, id) for _launch_bw's arguments a."""
    if exit_:
        return tk.trace_tiles_vm2_reference(*a)[:2]
    return tk.trace_tiles_vm3_reference(*a[:4])


def same_bits(a, b) -> bool:
    """ids identical and t bit-identical."""
    return (torch.equal(a[1], b[1]) and
            torch.equal(a[0].view(torch.int32), b[0].view(torch.int32)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the lines here")
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

    emit(card=card, warps=tk.BW_WARPS)
    tk.build_all()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for scene, tracer, rays in bench_waves(dev):
        for wave, r8 in rays.items():
            for kname, kernel in (("K1", "trace_vm3"), ("K4", "trace_vm2")):
                exit_ = kernel == "trace_vm2"
                a, visits = bw_args(tracer, r8, exit_)
                n_tiles = a[0].shape[0]
                res = dict(scene=scene, wave=wave, kernel=kname,
                           rays=r8.shape[0], tiles=n_tiles,
                           clusters_per_tile=visits / n_tiles,
                           w=tk.bw_warps(n_tiles, n_sm, exit_))
                # K4 also as any hit (checked, not timed)
                modes = [a] + ([a[:6] + (True,)] if exit_ else [])
                wants = [plain(m, exit_) for m in modes]
                for w in tk.BW_WARPS:
                    for m, want in zip(modes, wants):
                        if not same_bits(tk._launch_bw(*m, kernel, warps=w),
                                         want):
                            raise RuntimeError(f"{kname} at W = {w} "
                                               f"disagrees on {wave}")
                    res[f"ms_w{w}"] = cuda_ms(
                        lambda w=w: tk._launch_bw(*a, kernel, warps=w),
                        args.reps)
                emit(**res)
        del tracer, rays
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
