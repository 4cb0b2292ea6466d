"""Importing tauray_torch and every one of its modules never imports JAX,
and no module of the package imports jax, pallas or triton; every CUDA
source of the package is one the kernel wrappers build."""

import ast
import os
import pathlib
import subprocess
import sys

PKG = pathlib.Path(__file__).resolve().parent.parent / "tauray_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        if parts[-1] == "__main__":
            continue
        yield ".".join(parts), path


def test_import_all_modules_without_jax():
    names = [n for n, _ in _modules()]
    assert len(names) > 30
    code = ("import importlib, sys\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "from tauray_torch.ops.cluster import (InstancedClusterTracer,"
            " build_instanced_from_arrays, instanced_tracer_from_numpy)\n"
            "from tauray_torch.ops.trace_kernel import (trace_tiles,"
            " trace_tiles_inst, trace_tiles_vm, trace_tiles_vm2,"
            " trace_tiles_vm3)\n"
            "from tauray_torch.ops.trace_utils import trace_alpha\n"
            "from tauray_torch.ops.sobol import sobol_owen_sample_uint\n"
            "from tauray_torch.app.wave_stats import wave_stats\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'triton',"
            " 'tauray_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_forbidden_imports():
    for name, path in _modules():
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                root = m.split(".")[0]
                assert root not in ("jax", "jaxlib", "triton",
                                    "tauray_tpu"), (name, m)
                assert "pallas" not in m, (name, m)


def test_every_cuda_source_is_built():
    """Each csrc/*.cu is a library of trace_kernel.SOURCES (one nvcc
    process each; a .cuh header is included, not built), and the build hash
    covers every file of csrc/."""
    from tauray_torch.ops import trace_kernel
    srcs = sorted(str(p) for p in (PKG / "csrc").glob("*.cu"))
    assert srcs == sorted(trace_kernel.SOURCES.values())
    assert set(trace_kernel.LAUNCHES) == {"trace_vm3", "trace_mt",
                                          "trace_mt_inst", "trace_vm2",
                                          "trace_vm", "phase1_ids"}
    assert len(trace_kernel._digest()) == 16
