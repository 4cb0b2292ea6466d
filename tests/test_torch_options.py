"""The port's option parser against tauray_tpu's on every preset: the
port reads its own copies of the presets (tauray_torch/data/presets), and
`--preset=<name>` gives the same option values in both packages."""

import math
import os

import pytest

import tauray_torch.options as topt
import tauray_tpu.options as jopt

JAX_PRESETS = os.path.join(os.path.dirname(jopt.__file__), "data",
                           "presets")
PRESETS = sorted(n[:-4] for n in os.listdir(JAX_PRESETS)
                 if n.endswith(".cfg"))


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and \
            math.isnan(a) and math.isnan(b):
        return True
    return a == b


def _fields(o):
    """Every option value of an Options object; struct options by
    attribute."""
    out = {}
    for name in list(jopt.OPTIONS) + ["scene_paths", "animation_flag"]:
        v = getattr(o, name)
        if hasattr(v, "__dict__") and not isinstance(v, type):
            for k, x in vars(v).items():
                out[f"{name}.{k}"] = x
        else:
            out[name] = v
    return out


def test_preset_files_are_the_ports_own():
    """The port's data directory lies inside its own package and holds
    every preset of tauray_tpu byte for byte; loading one works."""
    pkg = os.path.dirname(os.path.abspath(topt.__file__))
    assert os.path.commonpath([os.path.abspath(topt._DATA_DIR), pkg]) == pkg
    assert len(PRESETS) == 8
    for name in PRESETS:
        with open(os.path.join(JAX_PRESETS, name + ".cfg"), "rb") as f:
            want = f.read()
        with open(os.path.join(topt._DATA_DIR, "presets", name + ".cfg"),
                  "rb") as f:
            assert f.read() == want, name
    o = topt.Options()
    topt.load_preset(o, "restir-hybrid")
    assert (o.renderer, o.max_ray_depth, o.denoiser) == \
        ("restir-hybrid", 2, "svgf")


@pytest.mark.parametrize("name", PRESETS)
def test_preset_matches_jax(name):
    """Every field of the two parsed Options is equal."""
    argv = [f"--preset={name}", "x.glb"]
    got = _fields(topt.parse_command_line_options(argv))
    want = _fields(jopt.parse_command_line_options(argv))
    assert set(got) == set(want)
    bad = {k: (got[k], want[k]) for k in want if not _same(got[k], want[k])}
    assert not bad, bad
