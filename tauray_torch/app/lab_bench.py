"""Times the labs redesigned for this card, L8-L11 (csrc/k1_lab.cu
lab8_kernel, lab9_kernel, lab10_kernel, lab11_vpu_kernel,
lab11_mxu_kernel), L4-L7 (csrc/brick_lab.cu brick_walk_kernel), L1-L3
(csrc/tile_lab.cu tile_walk_kernel) and L12 (csrc/mxu_lab.cu: mt on the
brick walk, lab12_plucker_kernel), against an older checkout's kernels on
the same inputs, in turns, on one CUDA card.

    python -m tauray_torch.app.lab_bench --parent DIR [--reps N]
        [--labs lab4,lab5,...]

DIR is a checkout of the repo (an unpacked `git archive` of an older
commit in a git-ignored directory, or a copy of this tree built another
way). Its csrc/k1_lab.cu, brick_lab.cu, tile_lab.cu and mxu_lab.cu (those
that --labs needs; default every lab) are built with this tree's nvcc flags
(ops/trace_kernel.NVCC_FLAGS) into DIR/tauray_torch/_build/; their C
interfaces are this tree's, so this tree's wrappers launch either library
(L10 is launched with K1's W, trace_kernel.bw_warps, which an older L10
reads and this tree's ignores, and with kernel_lab10.walk_order, computed
once a wave outside the timing, which an older L10 does not read). Every
configuration of the labs' mains at the scripts' sizes (L9: 2^20 rays on
proc://sponza?tris=262144's table, 5 modes at 8, 16 and 32 clusters a
tile; L4: k6, k7, k6f, k7f at KB 4, 8, 16; L5: TILE 8, 16, 32 x KB 1, 2,
4, 8; L6: 5 variants at (TILE, KB) (32, 8), (32, 16), (16, 8), each over
65,536 rays; L7: 32,768 tiles of 32, mt and bw at (KB, steps) (8, 6), (8,
4), (4, 8); L1: k0 and k1 at 0 and 1 steps, k2 and k3 at 0, 1, 2, 4 and
8, L2: k4 and L3: k5 at G 8 and 32 at 0, 1, 2, 4 and 8 steps, over the
script's 512 tiles; L10: its 4 modes on the sorted bounce waves of 2^18
and 2^20 rays; L11: vpu and mxu over 4,096 tiles x 8 steps; L12: mt and
plucker over 2,048 tiles x 6 steps; L8: modes 0-3 over 2^20 rays, mode 3
at counts 0, 8 and 16) is timed with CUDA events (median of --reps single
calls after a warm-up; L1-L8, L11 and L12 also back to back,
common.time_back_to_back; L8 and L1 k0-k2 also by CUDA-graph replay,
common.time_graph) in the order parent, this tree, this tree, parent.
Both sides are held to the plain versions first
(kernel_lab9.lab9_agreement; L4 by brick.agreement on every ray, mtfast
by mtfast_agreement, which an unfused parent meets bit for bit; L5 and L6
by brick.brick_agreement on every ray, or bit for bit for a parent whose
brick_lab has no brick_walk_kernel (an unfused kernel); L7 by
brick.brick_agreement on the first 1,024 tiles; L9 loads, L8 bit for
bit; L12 mt by mxu_lab.mt_agreement and plucker by
mxu_lab.plucker_agreement on every ray; L1 k0-k2 bit for bit and k3-k5
by kernel_lab.lab3_agreement on every tile;
kernel_lab10.lab10_agreement on 1,024 tiles from the wave's middle,
nowrite against the same side's full; L11 vpu by
kernel_lab11.vpu_agreement, mxu by kernel_lab11.mxu_agreement, on every
ray). It prints, one JSON object a line: the card's name and power limit,
each library's test loops (app/sass.lab_test_loops: instructions per
test), then per configuration the two sides' times, Gtests/s and share of
the bound."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from tauray_torch.app import sass
from tauray_torch.lab import brick, common, lab_kernel
from tauray_torch.lab import kernel_lab as l3
from tauray_torch.lab import kernel_lab8 as l8
from tauray_torch.lab import kernel_lab9 as l9
from tauray_torch.lab import kernel_lab10 as l10
from tauray_torch.lab import kernel_lab11 as l11
from tauray_torch.lab import mxu_lab as l12
from tauray_torch.lab.bounds import brick_bound, lab12_bound, tile_bound
from tauray_torch.ops import trace_kernel as tk

LIBS = ("k1_lab", "brick_lab", "tile_lab", "mxu_lab")
# each lab's library, in the order configs times them
LAB_LIB = {"lab9": "k1_lab", "lab4": "brick_lab", "lab5": "brick_lab",
           "lab6": "brick_lab", "lab7": "brick_lab", "lab1": "tile_lab",
           "lab2": "tile_lab", "lab3": "tile_lab", "lab10": "k1_lab",
           "lab11": "k1_lab", "lab12": "mxu_lab", "lab8": "k1_lab"}
# L1's configurations also timed by CUDA-graph replay (as every L8 one):
# those whose kernel runs shorter than its wrapper's host path
GRAPH_L1 = ("k0 ", "k1 ", "k2 ")
SLICE = 1024  # tiles of each hold
TILE_LAB = {"k0": "lab1", "k1": "lab1", "k2": "lab1", "k3": "lab1",
            "k4": "lab2", "k5": "lab3"}


def build_parent(root: str, libs=LIBS):
    """{library: (ctypes handle, path)} of the checkout at root's libs
    (k1_lab, brick_lab, tile_lab), built with this tree's flags; a failed
    build raises."""
    out_dir = os.path.join(root, "tauray_torch", "_build")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in libs:
        src = os.path.join(root, "tauray_torch", "csrc", f"{name}.cu")
        path = os.path.join(out_dir, f"lib{name}_parent.so")
        procs[name] = (path, subprocess.Popen(
            [tk._nvcc(), *tk.NVCC_FLAGS, "-o", path, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the parent's {name}:\n{log}")
        lib = ctypes.CDLL(path)
        fn = getattr(lib, f"{name}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = tk._ARGTYPES[f"{name}_launch"]
        libs[name] = (lib, path)
    return libs


def _lab9(dev):
    tracer = common.scene_tracer(dev)
    o3, d3, mm2, heads = (torch.from_numpy(x).to(dev) for x in
                          common.lab9_inputs(tracer.n_clusters))
    n_tiles, sl = o3.shape[0], slice(0, SLICE)
    for mode in lab_kernel.MODES["lab9"]:
        for count in l9.COUNTS:
            counts = torch.full((n_tiles,), count, dtype=torch.int32,
                                device=dev)
            ref = l9.lab9_reference(counts[sl], heads[sl], o3[sl], d3[sl],
                                    mm2[sl], tracer.tris12, mode)

            def hold(out, exact, mode=mode, ref=ref):
                if mode == "loads":
                    return dict(ok=torch.equal(out[sl].view(torch.int32),
                                               ref.view(torch.int32)))
                return l9.lab9_agreement(out[sl], ref, o3[sl], d3[sl],
                                         mm2[sl], tracer.tris12, mode)
            yield ("lab9", f"{mode}/s{count // 8}",
                   lambda counts=counts, mode=mode: l9.lab9(
                       counts, heads, o3, d3, mm2, tracer.tris12, mode),
                   hold, n_tiles * 32 * count * common.CLUSTER,
                   l9.lab9_bound(n_tiles, mode, count, tracer.n_clusters)[0])


def _brick(dev, lab):
    """L4-L7's configurations: L4 held by brick.agreement, L5 and L6 on
    every ray by brick_agreement (bit for bit where exact), L7 on its first
    SLICE tiles by brick_agreement."""
    tables, draws = {"lab4": common.lab4_inputs, "lab5": common.lab5_inputs,
                     "lab6": common.lab6_inputs,
                     "lab7": common.lab7_inputs}[lab]()
    tabs = {k: torch.from_numpy(v).to(dev) for k, v in tables.items()}
    for cfg, meta, rays in draws:
        meta = torch.from_numpy(meta).to(dev)
        rays = torch.from_numpy(rays).to(dev)
        tris = tabs["tris12" if cfg.mode == "bw" else "tris9"]
        n = SLICE if lab == "lab7" else cfg.n_tiles
        m, r = meta[:n * common.ROW], rays[:n]
        ref = brick.walk_reference(lab, cfg.mode, m, r, tris, cfg.kb,
                                   cfg.steps)

        def hold(out, exact, m=m, r=r, tris=tris, ref=ref, cfg=cfg, n=n):
            if exact and lab in ("lab5", "lab6"):
                return dict(ok=torch.equal(out.view(torch.int32),
                                           ref.view(torch.int32)))
            return brick.agreement(lab, cfg.mode, out[:n], ref, m, r, tris,
                                   cfg.kb)
        key = f"{cfg.mode} KB={cfg.kb}" if lab == "lab7" else \
            cfg.label.strip()
        yield (lab, f"{key} steps={cfg.steps}",
               lambda meta=meta, rays=rays, tris=tris, cfg=cfg: brick.brick(
                   lab, cfg.mode, meta, rays, tris, cfg.kb, cfg.steps),
               hold, cfg.n_tiles * cfg.tile * cfg.steps * cfg.kb *
               common.CLUSTER, brick_bound(cfg)[0])


def _tile(dev, labs):
    inp = l3.tile_inputs(dev)
    n_tiles = inp["n_tiles"]
    for cfg in l3.configs(("k0", "k1", "k2", "k3", "k4", "k5", "k532")):
        if TILE_LAB[cfg.name] not in labs:
            continue
        counts = l3.counts_of(n_tiles, cfg.steps, dev)
        ref = l3.call_reference(cfg, inp, counts)

        def hold(out, exact, ref=ref, name=cfg.name):
            if name in ("k0", "k1", "k2"):
                (t, i), (t_p, i_p) = l3.flat(name, out), l3.flat(name, ref)
                return dict(ok=torch.equal(t.view(torch.int32),
                                           t_p.view(torch.int32)) and
                            torch.equal(i, i_p))
            return l3.lab3_agreement(out, ref, inp["meta"], inp["rows"],
                                     inp["tris9"], name=name)
        tests = n_tiles * common.TILE_L1 * cfg.steps * l3.BK \
            if cfg.name in ("k3", "k4", "k5") else 0
        yield (TILE_LAB[cfg.name], f"{cfg.name} G={cfg.group} "
               f"steps={cfg.steps}",
               lambda cfg=cfg, counts=counts: l3.call(cfg, inp, counts),
               hold, tests, tile_bound(cfg.name, cfg.steps, n_tiles)[0])


def _lab10(dev):
    from tauray_torch.app.kernel_waves import kernel_waves
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for size in l10.SIZES:
        tracer, waves = kernel_waves(dev, size=size)
        counts, keys, r3, idmask = l10.wave_args(tracer, waves["bounce"])
        del waves
        n = counts.shape[0]
        a = (n - SLICE) // 2 // common.G * common.G if n > SLICE else 0
        ts = slice(a, min(n, a + SLICE))
        w = tk.bw_warps(n, n_sm, "trace_vm3")
        order = l10.walk_order(counts)

        def launch(mode, counts=counts, keys=keys, r3=r3, tracer=tracer,
                   idmask=idmask, w=w, order=order):
            return lab_kernel.launch("lab10", mode, counts, keys, r3,
                                     tris=tracer.tris12, idmask=idmask,
                                     warps=w, order=order)
        for mode in lab_kernel.MODES["lab10"]:
            ref = l10.lab10_reference(counts[ts], keys[ts], r3[ts],
                                      tracer.tris12, mode, idmask)

            def hold(out, exact, mode=mode, ref=ref, counts=counts, r3=r3,
                     tracer=tracer, launch=launch):
                full = launch("full")[ts] if mode == "nowrite" else None
                return l10.lab10_agreement(out[ts], ref, counts[ts], r3[ts],
                                           tracer.tris12, mode, full)
            yield ("lab10", f"{mode}/bounce_{size}",
                   lambda mode=mode, launch=launch: launch(mode), hold,
                   int(counts.sum()) * common.CLUSTER * common.TILE,
                   l10.lab10_bound(counts, mode, tracer.n_clusters)[0])


def _lab11(dev):
    steps, rays, tris12, m = (torch.from_numpy(x).to(dev)
                              for x in common.lab11_inputs())
    n_tiles, n_steps = steps.shape[0], int(steps[0])
    for mode, tris in (("vpu", tris12), ("mxu", m)):
        ref = l11.lab11_reference(steps, rays, tris, mode)

        def hold(out, exact, mode=mode, ref=ref):
            if mode == "vpu":
                return l11.vpu_agreement(out, ref, rays, tris12)
            return l11.mxu_agreement(out, ref, rays, m)
        yield ("lab11", mode,
               lambda mode=mode, tris=tris: l11.lab11(steps, rays, tris,
                                                      mode),
               hold, n_tiles * n_steps * common.KBV * common.CLUSTER *
               common.TILE,
               l11.lab11_bound(n_tiles, n_steps, tris.shape[0], mode)[0])


def _lab12(dev):
    inp = {k: torch.from_numpy(v).to(dev)
           for k, v in common.lab12_inputs().items()}
    n_tiles = inp["order"].shape[0]
    for mode in lab_kernel.MODES["lab12"]:
        tris = inp["tris9" if mode == "mt" else "tris24"]
        args = (inp["order"], inp["o3"], inp["d3"], inp["mm2"], tris, mode)
        ref = l12.lab12_reference(*args)

        def hold(out, exact, mode=mode, ref=ref):
            if mode == "mt":
                return l12.mt_agreement(out, ref, inp)
            return l12.plucker_agreement(out, ref, inp)
        yield ("lab12", mode, lambda args=args: l12.lab12(*args), hold,
               n_tiles * common.TILE * common.STEPS_L12 * l12.BK,
               lab12_bound(mode, n_tiles)[0])


def _lab8(dev):
    o3, d3, mm2, heads = (torch.from_numpy(x).to(dev)
                          for x in common.lab8_inputs())
    n_tiles = o3.shape[0]
    for mode in l8.NAMES:
        for count in ((0,) if mode < 3 else (0, 8, 16)):
            counts = torch.full((n_tiles,), count, dtype=torch.int32,
                                device=dev)
            args = (counts, heads, o3, d3, mm2, mode)
            ref = l8.lab8_reference(*args)

            def hold(out, exact, ref=ref):
                return dict(ok=torch.equal(out.view(torch.int32),
                                           ref.view(torch.int32)))
            yield ("lab8", f"mode{mode}/count{count}",
                   lambda args=args: l8.lab8(*args), hold, 0,
                   l8.lab8_bound(n_tiles, mode, count)[0])


def configs(dev, labs=tuple(LAB_LIB)):
    """(lab, key, launch(), hold(out, exact) -> dict, tests, bound ms) of
    every configuration the mains of labs run, in LAB_LIB's order; exact
    asks L5's and L6's hold for bit-identity (an unfused parent)."""
    if "lab9" in labs:
        yield from _lab9(dev)
    for lab in ("lab4", "lab5", "lab6", "lab7"):
        if lab in labs:
            yield from _brick(dev, lab)
    if {"lab1", "lab2", "lab3"} & set(labs):
        yield from _tile(dev, labs)
    if "lab10" in labs:
        yield from _lab10(dev)
    if "lab11" in labs:
        yield from _lab11(dev)
    if "lab12" in labs:
        yield from _lab12(dev)
    if "lab8" in labs:
        yield from _lab8(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout whose lab kernels to time")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--labs", default=",".join(LAB_LIB),
                    help="the labs to time, comma-separated (default: "
                         "all)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    labs = args.labs.split(",")
    if not set(labs) <= set(LAB_LIB):
        raise ValueError(f"--labs: not labs of the bench: {labs}")
    if not torch.cuda.is_available():
        raise RuntimeError("lab_bench times kernels on a CUDA card; none "
                           "is available")
    dev = torch.device("cuda")
    names = tuple(n for n in LIBS if n in {LAB_LIB[lab] for lab in labs})

    def emit(**kw):
        print(json.dumps(kw), flush=True)
    emit(card=common.card(), parent=args.parent, labs=labs)
    mine = {n: (tk.build_all()[n], str(tk.BUILD_INFO[n]["path"]))
            for n in LIBS}
    theirs = build_parent(args.parent, names)
    for side, libs in (("parent", theirs), ("change", mine)):
        loops = {}
        for n in names:
            loops.update(sass.lab_test_loops(libs[n][1]))
        emit(side=side, sass=loops)
    # a parent's L5 and L6 without the walk are unfused: bit for bit
    unfused = "brick_lab" in names and not any(
        "brick_walk_kernel" in f
        for f in sass.functions(theirs["brick_lab"][1]))

    def use(libs):
        for n in names:
            tk._libs[n] = libs[n][0]
    try:
        for lab, key, launch, hold, tests, bound_ms in configs(dev, labs):
            row = dict(lab=lab, config=key, bound_ms=bound_ms)
            for side, libs in (("parent", theirs), ("change", mine)):
                use(libs)
                agree = hold(launch(), side == "parent" and unfused)
                row[f"{side}_hold"] = {k: agree[k] for k in (
                    "ok", "ids_differ", "ties", "ill_conditioned",
                    "max_t_over_bound", "rays_off") if k in agree}
                if not agree["ok"]:
                    raise RuntimeError(f"{lab} {key}: the {side}'s kernel "
                                       f"breaks the hold: {agree}")
            runs = {"parent_ms": [], "ms": []}
            b2b = {"parent_ms_back_to_back": [], "ms_back_to_back": [],
                   "parent_ms_graph": [], "ms_graph": []}
            graph = lab == "lab8" or (lab == "lab1" and
                                      key.startswith(GRAPH_L1))
            for side in ("parent_ms", "ms", "ms", "parent_ms"):
                use(theirs if side == "parent_ms" else mine)
                runs[side].append(common.time_cuda(launch, args.reps)["ms"])
                if lab not in ("lab7", "lab9", "lab10"):
                    b2b[f"{side}_back_to_back"].append(
                        common.time_back_to_back(
                            launch, args.reps)["ms_back_to_back"])
                if graph:
                    b2b[f"{side}_graph"].append(common.time_graph(
                        launch, args.reps)["ms_graph"])
            for side, ms in runs.items():
                row[side] = ms
                best = min(ms)
                row[side.replace("ms", "gtests_s")] = tests / (best * 1e6)
                row[side.replace("ms", "share_of_bound")] = bound_ms / best
            row.update({k: v for k, v in b2b.items() if v})
            emit(**row)
    finally:
        use(mine)
    return 0


if __name__ == "__main__":
    sys.exit(main())
