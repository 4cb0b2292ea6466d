"""Reads what nvcc compiled: each kernel's SASS (cuobjdump -sass, from the
CUDA toolkit or Triton's copy), its innermost loops, and the test loops of
the TPU labs' kernels, instructions per ray-triangle test, and phase 1's
cluster loop (P1), instructions per ray-box test. chip_smoke.py phase 2,
app/lab_bench.py and app/bw_bench.py read the libraries that
ops/trace_kernel.build_all builds; nothing here runs a kernel."""

from __future__ import annotations

import importlib.util
import os
import re
import shutil
import subprocess
from typing import Dict, List

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
# a 16-byte row load: from shared memory (a staged cluster) or through
# the read-only path (a table read in place)
_ROW_LOAD = re.compile(r"(@!?P\d+\s+)?(LDS|LDG)\S*\.128\b")
# lab9_kernel<kMode, R>, L4-L7's brick_walk_kernel<kLab, kBody, kVariant,
# kTile, R>, lab10_kernel<kMode, R>, lab11_vpu_kernel<R>, lab11_mxu_kernel
# (or lab11_mxu_kernel<kK>, a build with m16n8k8) and L1-L3's
# tile_walk_kernel<kMode, kLayout, R>; in older checkouts, L4 as
# brick_kernel<true, kBody, kFixed> and L11 vpu as lab11_vpu_kernel (one
# ray a lane), lab9_kernel<kMode>
# (R = 1), L7 as lab7_kernel<kBody, R> or brick_kernel<false, true, kBody,
# kFixed> (R = 1), L5 and L6 as brick_kernel<false, kMT, kVariant> (R = 1,
# every TILE), lab10_kernel<W, kMode> (W = 4 or 8 warps a tile, R = 1), L3
# as lab3_kernel<R> and L1-L3 as tile_lab_kernel<kMode, kLayout> (R = 1)
_LAB9 = re.compile(r"lab9_kernelILi(\d)E(?:Li(\d+)E)?E")
_WALK = re.compile(r"brick_walk_kernelILi(\d+)ELi(\d)ELi(\d)ELi(\d+)"
                   r"ELi(\d+)EE")
_LAB7 = re.compile(r"lab7_kernelILi(\d)ELi(\d+)EE")
_LAB7_OLD = re.compile(r"brick_kernelILb0ELb1ELi(\d)ELi0EE")
_LAB6_OLD = re.compile(r"brick_kernelILb0ELi0ELi(\d)EE")
_LAB4_OLD = re.compile(r"brick_kernelILb1ELi(\d)ELi0EE")
_LAB11 = re.compile(r"lab11_(vpu|mxu)_kernel(?:ILi(\d+)EE)?")
# a tensor-core product (L11 mxu: 36 a block of 8 triangles, 8 tests a
# lane), with its shape where SASS names it (1684: m16n8k4, 1688: m16n8k8)
_HMMA = re.compile(r"(@!?P\d+\s+)?HMMA\b(?:\.(\d+))?")
# L12: plucker's kernel, and an older checkout's mt (one ray a lane)
_LAB12 = re.compile(r"lab12_plucker_kernel")
_LAB12_MT_OLD = re.compile(r"lab12_mt_kernel")
# the tensor-core work of one plucker column block (8 tests a lane), in
# m16n8k4 products: 2 row blocks x (3 sides x K 8 + tnum's K 4) / 4 x 3
# for the split
PLUCKER_K4_BLOCK = 42
_LAB10 = re.compile(r"lab10_kernelILi(\d)ELi(\d)EE")
_TILE = re.compile(r"tile_walk_kernelILi(\d)ELi(\d)ELi(\d+)EE")
_LAB3 = re.compile(r"lab3_kernelILi(\d)EE")
_TILE_OLD = re.compile(r"tile_lab_kernelILi(\d)ELi(\d)EE")
LAB9_MODES = ("full", "exit", "loads", "math", "nocat")
LAB10_MODES = ("full", "noray", "fixord", "nowrite")
BODIES = {0: "mt", 1: "mtfast", 2: "bw"}
# L6's variants by kVariant (L5 and L6 slot run fixed's instance)
VARIANTS = ("fixed", "cid", "while", "while2")
# the instances of L1-L3 with a test, by (kMode, kLayout): k3 in columns,
# the exit in planes (L2) and in rows (L3); k0-k2 have no test loop
TILE_INSTANCES = {(3, 0): "lab1 k3", (4, 1): "lab2", (4, 2): "lab3"}


def cuobjdump() -> str:
    """The CUDA toolkit's cuobjdump, or the copy in Triton's package."""
    cands = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cands.append(os.path.join(os.path.dirname(spec.origin), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found")


def functions(lib_path: str) -> Dict[str, str]:
    """{function name: its cuobjdump -sass text}."""
    text = subprocess.run([cuobjdump(), "-sass", lib_path],
                          capture_output=True, text=True,
                          check=True).stdout
    return {chunk.split()[0]: chunk
            for chunk in text.split("Function : ")[1:]}


def inner_loops(chunk: str) -> List[List[str]]:
    """The innermost loops (a backward branch with no other inside it) of
    one function of cuobjdump -sass: each loop's instructions."""
    insns, labels, pending = [], {}, []
    for ln in chunk.splitlines():
        m = _LABEL.match(ln)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(ln)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            insns.append((addr, m.group(2)))
    loops = []
    for addr, op in insns:
        if not re.search(r"\bBRA\b", op):
            continue
        m = re.search(r"\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b", op)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else \
            int(m.group(2), 16)
        if target is not None and target <= addr:
            loops.append((target, addr))
    return [[o for a, o in insns if target <= a <= addr]
            for target, addr in loops
            if not any((t2, a2) != (target, addr) and target <= t2 and
                       a2 <= addr for t2, a2 in loops)]


def row_loop(chunk: str) -> List[str]:
    """Of a function's innermost loops, the one with the most 16-byte row
    loads (the test loop), fewest instructions first among equals."""
    loops = inner_loops(chunk) or [[]]
    return max(loops, key=lambda body: (
        sum(bool(_ROW_LOAD.match(o)) for o in body), -len(body)))


def lab_test_loops(lib_path: str) -> Dict[str, dict]:
    """{instance: its test loop}: L9's lab9_kernel and L10's lab10_kernel
    per mode, L4's per body and TILE ("lab4 mtfast TILE=16"; an older
    checkout's staged brick_kernel per body), L7's per body, L6's per
    variant and TILE ("lab6 fixed TILE=32", the instance L5 runs too; an
    older checkout's per variant, every TILE), L11's vpu and mxu and the
    tile walks of L1 k3, L2 and L3 (the redesigned kernels or older ones;
    an older L10 per mode and W) in the library at lib_path: the loop's
    instructions, its 16-byte row loads, R (rays a lane), the tests one
    pass makes (4 triangles a load of each of the rows, 12 or 9, times R;
    none for L9 loads, which has no test; L11 mxu's loop holds no row load:
    8 tests a lane for each 36 tensor-core products, hmma) and instructions
    per test; also L12's mt (the walk's instance, or an older checkout's
    lab12_mt_kernel) and plucker (8 tests a lane for each
    PLUCKER_K4_BLOCK products' worth, an m16n8k8, hmma_k8, counting
    two)."""
    out = {}
    for name, chunk in functions(lib_path).items():
        m9, mw, m7, m7o, m6o, m4o, m11, m10, mt, m3, mto = (
            p.search(name) for p in (_LAB9, _WALK, _LAB7, _LAB7_OLD,
                                     _LAB6_OLD, _LAB4_OLD, _LAB11, _LAB10,
                                     _TILE, _LAB3, _TILE_OLD))
        if _LAB12.search(name):
            # of the loops with the most products, the one with the fewest
            # branches: the step's first pass (rcp_in_range), not its redo
            # (__frcp_rn branches to its slow path)
            loops = inner_loops(chunk) or [[]]
            body = max(loops, key=lambda b: (
                sum(bool(_HMMA.match(o)) for o in b),
                -sum(bool(re.search(r"\bBRA\b", o)) for o in b), -len(b)))
            shapes = [m.group(2) for m in map(_HMMA.match, body) if m]
            k8 = shapes.count("1688")
            tests = 8 * (len(shapes) + k8) / PLUCKER_K4_BLOCK
            out["lab12 plucker"] = dict(
                loop_instructions=len(body), hmma=len(shapes), hmma_k8=k8,
                tests=tests,
                instructions_per_test=len(body) / tests if tests else None)
            continue
        if m11 and m11.group(1) == "mxu":
            loops = inner_loops(chunk) or [[]]
            body = max(loops, key=lambda b: (
                sum(bool(_HMMA.match(o)) for o in b), -len(b)))
            hmma = sum(bool(_HMMA.match(o)) for o in body)
            tests = 8 * hmma / 36
            out["lab11 mxu"] = dict(
                loop_instructions=len(body), hmma=hmma, tests=tests,
                instructions_per_test=len(body) / tests if tests else None)
            continue
        if m9:
            inst = f"lab9 {LAB9_MODES[int(m9.group(1))]}"
            rays, nf, test = int(m9.group(2) or 1), 12, m9.group(1) != "2"
        elif mw:
            lab, body, variant, tile, rays = map(int, mw.groups())
            inst = "lab12 mt" if lab == 12 else \
                f"lab7 {BODIES[body]}" if lab == 7 else \
                f"lab4 {BODIES[body]} TILE={tile}" if lab == 4 else \
                f"lab6 {VARIANTS[variant]} TILE={tile}"
            nf, test = (12 if body == 2 else 9), True
        elif _LAB12_MT_OLD.search(name):
            inst, rays, nf, test = "lab12 mt", 1, 9, True
        elif m4o:
            inst, rays = f"lab4 {BODIES[int(m4o.group(1))]}", 1
            nf, test = 9, True
        elif m11:
            inst, rays = "lab11 vpu", int(m11.group(2) or 1)
            nf, test = 12, True
        elif m6o:
            inst, rays = f"lab6 {VARIANTS[int(m6o.group(1))]}", 1
            nf, test = 9, True
        elif m7 or m7o:
            m = m7 or m7o
            body = BODIES[int(m.group(1))]
            inst = f"lab7 {body}"
            rays = int(m.group(2)) if m7 else 1
            nf, test = (12 if body == "bw" else 9), True
        elif m10:
            a, b = int(m10.group(1)), int(m10.group(2))
            if a in (4, 8):     # the older <W, kMode>
                inst, rays = f"lab10 {LAB10_MODES[b]} W={a}", 1
            else:
                inst, rays = f"lab10 {LAB10_MODES[a]}", b
            nf, test = 12, True
        elif m3:
            inst, rays, nf, test = "lab3", int(m3.group(1)), 9, True
        elif mt or mto:
            m = mt or mto
            inst = TILE_INSTANCES.get((int(m.group(1)), int(m.group(2))))
            if inst is None:
                continue
            rays, nf, test = int(mt.group(3)) if mt else 1, 9, True
        else:
            continue
        body = row_loop(chunk)
        loads = sum(bool(_ROW_LOAD.match(o)) for o in body)
        tests = 4 * rays * loads / nf if test else 0
        out[inst] = dict(loop_instructions=len(body), loads128=loads,
                         rays_a_lane=rays, tests=tests,
                         instructions_per_test=len(body) / tests
                         if tests else None)
    return out


def phase1_loop(lib_path: str, src_path: str) -> dict:
    """P1's cluster loop: the largest innermost loop of phase1_kernel
    (csrc/phase1.cu, src_path), one step of 32 clusters against the kRays
    rays a lane that the source sets (32 kRays tests), its emission of the
    step's ids included."""
    with open(src_path) as f:
        rays = int(re.search(r"constexpr int kRays = (\d+);",
                             f.read()).group(1))
    chunk = next(c for name, c in functions(lib_path).items()
                 if "phase1_kernel" in name)
    body = max(inner_loops(chunk) or [[]], key=len)
    return dict(loop_instructions=len(body), tests=32 * rays,
                instructions_per_test=len(body) / (32 * rays),
                fmnmx=sum("FMNMX" in o for o in body))


def spills(log: str, pattern: str) -> Dict[str, int]:
    """{function: its spill stores + loads, in bytes} from ptxas -v's log
    for the functions whose names match pattern."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and fn and re.search(pattern, fn):
            out[fn] = int(m.group(1)) + int(m.group(2))
            fn = None
    return out


def registers(log: str, pattern: str) -> Dict[str, int]:
    """{function: the registers a thread} from ptxas -v's log for the
    functions whose names match pattern."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn and re.search(pattern, fn):
            out[fn] = int(m.group(1))
            fn = None
    return out
