"""The port stays complete: every module of tauray_tpu has its counterpart
under tauray_torch, and every option of tauray_tpu/options.py exists in the
port's options with the same kind, default and fields.

The one module without a namesake is ops/pallas_trace.py, whose Pallas
kernels are ops/trace_kernel.py's wrappers over csrc/trace_tiles.cu. A
module added to tauray_tpu without a counterpart fails here."""

import math
import pathlib

import pytest

from tauray_torch import options as topt
from tauray_tpu import options as jopt

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "tauray_tpu"
PORT = ROOT / "tauray_torch"

# tauray_tpu module -> the port's files that take its place
MAPPED = {"ops/pallas_trace.py": ("ops/trace_kernel.py",
                                  "csrc/trace_tiles.cu")}


def _jax_modules():
    return sorted(p.relative_to(JAX_PKG).as_posix()
                  for p in JAX_PKG.rglob("*.py")
                  if "__pycache__" not in p.parts)


@pytest.mark.parametrize("module", _jax_modules())
def test_module_has_counterpart(module):
    for rel in MAPPED.get(module, (module,)):
        assert (PORT / rel).is_file(), \
            f"tauray_tpu/{module} has no counterpart tauray_torch/{rel}"


def test_native_source_has_counterpart():
    """The native host library's C++ source is carried too."""
    for src in (JAX_PKG / "native").glob("*.cpp"):
        assert (PORT / "native" / src.name).is_file()


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and \
            math.isnan(a) and math.isnan(b):
        return True
    return a == b


def _assert_same_opt(name, j, t):
    assert t.kind == j.kind, name
    assert t.choices == j.choices, name
    if j.kind == "struct":
        assert list(t.fields) == list(j.fields), name
        for f in j.fields:
            _assert_same_opt(f"{name}.{f}", j.fields[f], t.fields[f])
    elif j.kind in ("vec3", "vecfloat"):
        assert len(t.default) == len(j.default), name
        assert all(_same(a, b) for a, b in zip(t.default, j.default)), name
    else:
        assert _same(t.default, j.default), (name, t.default, j.default)


def test_every_option_with_its_default():
    missing = sorted(set(jopt.OPTIONS) - set(topt.OPTIONS))
    assert not missing, missing
    for name, j in jopt.OPTIONS.items():
        _assert_same_opt(name, j, topt.OPTIONS[name])
