"""Reads what nvcc compiled: each kernel's SASS (cuobjdump -sass, from the
CUDA toolkit or Triton's copy), its innermost loops, and the test loops of
the TPU labs' kernels, instructions per ray-triangle test. chip_smoke.py
phase 2 and app/lab_bench.py read the libraries that
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
# lab9_kernel<kMode, R>, lab7_kernel<kBody, R>, lab10_kernel<kMode, R>
# and L1-L3's tile_walk_kernel<kMode, kLayout, R>; in older checkouts,
# lab9_kernel<kMode> (R = 1), L7 as brick_kernel<false, true, kBody,
# kFixed> (R = 1), lab10_kernel<W, kMode> (W = 4 or 8 warps a tile, R =
# 1), L3 as lab3_kernel<R> and L1-L3 as tile_lab_kernel<kMode, kLayout>
# (R = 1)
_LAB9 = re.compile(r"lab9_kernelILi(\d)E(?:Li(\d+)E)?E")
_LAB7 = re.compile(r"lab7_kernelILi(\d)ELi(\d+)EE")
_LAB7_OLD = re.compile(r"brick_kernelILb0ELb1ELi(\d)ELi0EE")
_LAB10 = re.compile(r"lab10_kernelILi(\d)ELi(\d)EE")
_TILE = re.compile(r"tile_walk_kernelILi(\d)ELi(\d)ELi(\d+)EE")
_LAB3 = re.compile(r"lab3_kernelILi(\d)EE")
_TILE_OLD = re.compile(r"tile_lab_kernelILi(\d)ELi(\d)EE")
LAB9_MODES = ("full", "exit", "loads", "math", "nocat")
LAB10_MODES = ("full", "noray", "fixord", "nowrite")
BODIES = {0: "mt", 2: "bw"}
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
    per mode, L7's per body and the tile walks of L1 k3, L2 and L3 (the
    redesigned kernels or older ones; an older L10 per mode and W) in the
    library at lib_path: the
    loop's instructions, its 16-byte row loads, R (rays a lane), the tests
    one pass makes (4 triangles a load of each of the rows, 12 or 9, times
    R; none for L9 loads, which has no test) and instructions per test."""
    out = {}
    for name, chunk in functions(lib_path).items():
        m9, m7, m7o, m10, mt, m3, mto = (p.search(name) for p in (
            _LAB9, _LAB7, _LAB7_OLD, _LAB10, _TILE, _LAB3, _TILE_OLD))
        if m9:
            inst = f"lab9 {LAB9_MODES[int(m9.group(1))]}"
            rays, nf, test = int(m9.group(2) or 1), 12, m9.group(1) != "2"
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
