"""The port's builders take no CPU default: without a device they put the
scene on the CUDA card, and on a machine without one they raise instead of
building CPU tensors (whose traces would quietly take the kernels' plain
versions). Each test decides at run time whether a card is present."""

import numpy as np
import pytest
import torch

from tauray_torch.ops import cluster as tcl
from tauray_torch.scene import device as tdev


@pytest.fixture(scope="module")
def arrays():
    """SceneArrays of the procedural Sponza (shared meshes, so the
    instanced build applies) and its viewports."""
    from tauray_torch.io.gltf import load_scene
    from tauray_torch.options import Options
    from tauray_torch.scene.arrays import SceneArrays
    from tauray_torch.scene.scene import Scene
    opt = Options()
    opt.width = opt.height = 16
    opt.as_strategy = "per-model"
    s = Scene()
    load_scene("proc://sponza?tris=8192", s)
    vps = [(e.camera, e.transform) for e in s.entities
           if e.camera is not None and e.camera_enabled]
    return SceneArrays(s, opt), vps


def _soup(n=300, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, 3, 3)).astype(np.float32)


def _tensors(obj):
    """The tensors a builder returned (NamedTuple, dataclass or tuple)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if hasattr(obj, "__dataclass_fields__"):
        obj = [getattr(obj, f) for f in obj.__dataclass_fields__]
    return [x for v in obj if isinstance(v, (tuple, list, torch.Tensor))
            or hasattr(v, "__dataclass_fields__") for x in _tensors(v)]


BUILDERS = {
    "to_device_scene": lambda sa, vps, **k: tdev.to_device_scene(sa, **k),
    "to_camera_uniforms": lambda sa, vps, **k: tdev.to_camera_uniforms(
        sa.camera_uniforms(vps), **k),
    "build_cluster_tracer": lambda sa, vps, **k: tcl.build_cluster_tracer(
        _soup(), np.zeros(300, np.int32), **k),
    "build_instanced_tracer": lambda sa, vps, **k: tcl.build_instanced_tracer(
        [_soup(200)], np.zeros(3, np.int64),
        np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)), np.ones(3, bool),
        np.arange(3, dtype=np.int64) * 200, **k),
    "build_instanced_from_arrays": lambda sa, vps, **k:
        tcl.build_instanced_from_arrays(sa, **k),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_without_device_needs_the_card(arrays, name):
    """device=None raises on a machine without CUDA; the same call with an
    explicit CPU device builds CPU tensors."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None builds there")
    build = BUILDERS[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(*arrays)
    leaves = _tensors(build(*arrays, device="cpu"))
    assert leaves and all(v.device.type == "cpu" for v in leaves)


def test_resolve_device():
    assert tdev.resolve_device("cpu") == torch.device("cpu")
    assert tdev.resolve_device(torch.device("cpu")) == torch.device("cpu")
    if torch.cuda.is_available():
        assert tdev.resolve_device() == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdev.resolve_device()
