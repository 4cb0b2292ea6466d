"""The port stays complete: every module of tauray_tpu has its counterpart
under tauray_torch, and every option of tauray_tpu/options.py exists in the
port's options with the same kind, default and fields.

The one module without a namesake is ops/pallas_trace.py, whose Pallas
kernels are ops/trace_kernel.py's wrappers over csrc/trace_tiles.cu. A
module added to tauray_tpu without a counterpart fails here.

Every pl.pallas_call site of the repo (tauray_tpu/ and the TPU lab
scripts) is ported: it maps to the source of its Hopper counterpart. A new
or moved site fails here."""

import math
import pathlib
import re

import pytest

from tauray_torch import options as topt
from tauray_tpu import options as jopt

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "tauray_tpu"
PORT = ROOT / "tauray_torch"

# tauray_tpu module -> the port's files that take its place
MAPPED = {"ops/pallas_trace.py": ("ops/trace_kernel.py",
                                  "csrc/trace_tiles.cu")}


# every pl.pallas_call site, file:line -> the port's source of its Hopper
# counterpart (K1-K5, the tile labs L1-L3, the brick labs L4-L7, the K1
# labs L8-L11 and the Plücker lab L12)
PALLAS_SITES = {
    "tauray_tpu/ops/pallas_trace.py:281": "csrc/trace_tiles.cu",    # K2
    "tauray_tpu/ops/pallas_trace.py:525": "csrc/trace_tiles.cu",    # K3
    "tauray_tpu/ops/pallas_trace.py:942": "csrc/trace_tiles.cu",    # K4
    "tauray_tpu/ops/pallas_trace.py:1197": "csrc/trace_tiles.cu",   # K1
    "tauray_tpu/ops/pallas_trace.py:1247": "csrc/trace_tiles.cu",   # K5
    "scripts/kernel_lab.py:61": "csrc/tile_lab.cu",                 # L1
    "scripts/kernel_lab.py:424": "csrc/tile_lab.cu",                # L2
    "scripts/kernel_lab.py:586": "csrc/tile_lab.cu",                # L3
    "scripts/kernel_lab2.py:234": "csrc/brick_lab.cu",              # L4
    "scripts/kernel_lab3.py:172": "csrc/brick_lab.cu",              # L5
    "scripts/kernel_lab4.py:199": "csrc/brick_lab.cu",              # L6
    "scripts/kernel_lab5.py:159": "csrc/brick_lab.cu",              # L7
    "scripts/kernel_lab8.py:105": "csrc/k1_lab.cu",                 # L8
    "scripts/kernel_lab9.py:189": "csrc/k1_lab.cu",                 # L9
    "scripts/kernel_lab10.py:193": "csrc/k1_lab.cu",                # L10
    "scripts/kernel_lab11.py:139": "csrc/k1_lab.cu",                # L11
    "scripts/mxu_lab.py:66": "csrc/mxu_lab.cu",                     # L12
}
_CALL = re.compile(r"^[^#]*\bpl\.pallas_call\(")


def _pallas_sites():
    found = set()
    for root in ("tauray_tpu", "scripts"):
        for path in sorted((ROOT / root).rglob("*.py")):
            for n, line in enumerate(path.read_text().splitlines(), 1):
                if _CALL.match(line):
                    found.add(f"{path.relative_to(ROOT).as_posix()}:{n}")
    return found


def test_every_pallas_call_site_is_accounted_for():
    assert _pallas_sites() == set(PALLAS_SITES)
    assert len(PALLAS_SITES) == 17


@pytest.mark.parametrize("site", sorted(PALLAS_SITES))
def test_pallas_call_site_has_its_counterpart(site):
    """Every site is ported: its Hopper source exists and names the TPU
    kernel's file."""
    src = PALLAS_SITES[site]
    path = site.split(":")[0]
    assert src is not None and src.startswith("csrc/")
    text = (PORT / src).read_text()
    assert pathlib.PurePosixPath(path).name in text


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
