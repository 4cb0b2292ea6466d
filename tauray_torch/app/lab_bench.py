"""Times the two labs redesigned with FMA bodies, L9 (csrc/k1_lab.cu
lab9_kernel) and L7 (csrc/brick_lab.cu lab7_kernel), against an older
checkout's kernels on the same inputs, in turns, on one CUDA card.

    python -m tauray_torch.app.lab_bench --parent DIR [--reps N]

DIR is a checkout of the repo (an unpacked `git archive` of an older
commit in a git-ignored directory). Its csrc/k1_lab.cu and brick_lab.cu
are built with this tree's nvcc flags (ops/trace_kernel.NVCC_FLAGS) into
DIR/tauray_torch/_build/; their C interfaces are this tree's, so this
tree's wrappers launch either library. Every configuration of the two
labs' mains at the scripts' sizes (L9: 2^20 rays on
proc://sponza?tris=262144's table, 5 modes at 8, 16 and 32 clusters a
tile; L7: 32,768 tiles of 32, mt and bw at (KB, steps) (8, 6), (8, 4), (4,
8)) is timed with CUDA events (median of --reps after a warm-up) in the
order parent, this tree, this tree, parent. Both sides are held to the
plain versions on the first 1,024 tiles first (kernel_lab9.lab9_agreement,
kernel_lab5.lab7_agreement; L9 loads bit for bit). It prints, one JSON
object a line: the card's name and power limit, each library's test loops
(app/sass.lab_test_loops: instructions per test), then per configuration
the two sides' times, Gtests/s and share of the bound."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from tauray_torch.app import sass
from tauray_torch.lab import common, lab_kernel
from tauray_torch.lab import kernel_lab5 as l7
from tauray_torch.lab import kernel_lab9 as l9
from tauray_torch.lab.bounds import brick_bound
from tauray_torch.ops import trace_kernel as tk

LIBS = ("k1_lab", "brick_lab")
SLICE = 1024  # tiles of each hold


def build_parent(root: str):
    """{library: ctypes handle} of the checkout at root's k1_lab and
    brick_lab, built with this tree's flags; a failed build raises."""
    out_dir = os.path.join(root, "tauray_torch", "_build")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in LIBS:
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


def configs(dev):
    """(lab, key, launch(), hold(out) -> dict, tests, bound ms) of every
    configuration the two mains run."""
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

            def hold(out, mode=mode, ref=ref):
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
    del o3, d3, mm2, heads
    tables, draws = common.lab7_inputs()
    tabs = {k: torch.from_numpy(v).to(dev) for k, v in tables.items()}
    for cfg, meta, rays in draws:
        meta = torch.from_numpy(meta).to(dev)
        rays = torch.from_numpy(rays).to(dev)
        tris = tabs["tris12" if cfg.mode == "bw" else "tris9"]
        m, r = meta[:SLICE * common.ROW], rays[:SLICE]
        ref = l7.lab7_reference(m, r, tris, cfg.mode, cfg.kb, cfg.steps)

        def hold(out, m=m, r=r, tris=tris, ref=ref, mode=cfg.mode):
            return l7.lab7_agreement(out[:SLICE], ref, m, r, tris, mode)
        yield ("lab7", f"{cfg.mode} KB={cfg.kb} steps={cfg.steps}",
               lambda meta=meta, rays=rays, tris=tris, cfg=cfg: l7.lab7(
                   meta, rays, tris, cfg.mode, cfg.kb, cfg.steps),
               hold, cfg.n_tiles * 32 * cfg.steps * cfg.kb * common.CLUSTER,
               brick_bound(cfg)[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout whose L9 and L7 kernels to time")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        raise RuntimeError("lab_bench times kernels on a CUDA card; none "
                           "is available")
    dev = torch.device("cuda")

    def emit(**kw):
        print(json.dumps(kw), flush=True)
    emit(card=common.card(), parent=args.parent)
    mine = {n: (tk.build_all()[n], str(tk.BUILD_INFO[n]["path"]))
            for n in LIBS}
    theirs = build_parent(args.parent)
    for side, libs in (("parent", theirs), ("change", mine)):
        loops = {}
        for _, path in libs.values():
            loops.update(sass.lab_test_loops(path))
        emit(side=side, sass=loops)

    def use(libs):
        for n in LIBS:
            tk._libs[n] = libs[n][0]
    try:
        for lab, key, launch, hold, tests, bound_ms in configs(dev):
            row = dict(lab=lab, config=key, bound_ms=bound_ms)
            for side, libs in (("parent", theirs), ("change", mine)):
                use(libs)
                agree = hold(launch())
                row[f"{side}_hold"] = {k: agree[k] for k in (
                    "ok", "ids_differ", "ties", "ill_conditioned",
                    "max_t_over_bound") if k in agree}
                if not agree["ok"]:
                    raise RuntimeError(f"{lab} {key}: the {side}'s kernel "
                                       f"breaks the hold: {agree}")
            runs = {"parent_ms": [], "ms": []}
            for side in ("parent_ms", "ms", "ms", "parent_ms"):
                use(theirs if side == "parent_ms" else mine)
                runs[side].append(common.time_cuda(launch, args.reps)["ms"])
            for side, ms in runs.items():
                row[side] = ms
                best = min(ms)
                row[side.replace("ms", "gtests_s")] = tests / (best * 1e6)
                row[side.replace("ms", "share_of_bound")] = bound_ms / best
            emit(**row)
    finally:
        use(mine)
    return 0


if __name__ == "__main__":
    sys.exit(main())
