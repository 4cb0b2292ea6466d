"""chip_smoke.py's card-against-CPU holds of phases 15b and 15c
(hold_di_cpu, hold_gi_cpu) and their limits (HOLD_DI_OFF, HOLD_GI_OFF), on
the CPU: the port renders 2 ReSTIR frames of the room of
tests/test_torch_restir.py, closed by a ceiling and four walls (as the
Sponza-class scene of those phases is, so that nearly every ray hits), at
64x64, depth 3; the second frame's
restir_di_pass and restir_gi_pass run again from the same inputs. Through
the same tracer no pixel is off; through a tracer that loses the hit of 1
ray in 64 of every wave (a fault of a traversal kernel on a class of rays)
the hold reads more than its limit and raises.

Phase 16c's hold (hold_raster_cpu, HOLD_RASTER_OFF): 2 raster frames of
the raster test scene (tests/test_torch_raster.py) at 64x64 with 256^2
maps, --pcf=16 --pcss=8; the second frame's render_raster again from the
same inputs reads no pixel off, and from maps broken as a build fault
would break them (the bias dropped, or every texel shifted by one) more
than the limit. Each case prints its readings."""

import numpy as np
import pytest
import torch

import chip_smoke
from tauray_torch.ops.intersect import Hit

from test_torch_restir import room_scene

torch.set_num_threads(2)

CPU = torch.device("cpu")
N = 64


class LosesHits:
    """The tracer, with 1 ray in 64 of every wave missing (the same seeded
    draw for every wave)."""

    def __init__(self, tracer):
        self.tracer = tracer

    def __getattr__(self, name):
        return getattr(self.tracer, name)

    def trace(self, *args, **kw):
        hit = self.tracer.trace(*args, **kw)
        g = torch.Generator().manual_seed(64)
        lost = torch.rand(hit.t.shape[0], generator=g) < 1 / 64
        return Hit(torch.where(lost, float("inf"), hit.t),
                   torch.where(lost, -1, hit.tri_id), hit.u, hit.v)


def closed_room():
    """The room with a ceiling at y = 5 and walls at x = -6, 6 and
    z = -6, 8 around its camera and lights."""
    from tauray_torch.scene.material import Material
    from tauray_torch.scene.mesh import Mesh, Model
    from tauray_torch.scene.transformable import Transformable
    s = room_scene("tauray_torch")
    for name, verts in (
            ("ceiling", [[-6, 5, -6], [6, 5, -6], [6, 5, 8], [-6, 5, 8]]),
            ("west", [[-6, 0, -6], [-6, 0, 8], [-6, 5, 8], [-6, 5, -6]]),
            ("east", [[6, 0, -6], [6, 0, 8], [6, 5, 8], [6, 5, -6]]),
            ("north", [[-6, 0, -6], [6, 0, -6], [6, 5, -6], [-6, 5, -6]]),
            ("south", [[-6, 0, 8], [6, 0, 8], [6, 5, 8], [-6, 5, 8]])):
        model = Model()
        model.add_vertex_group(Material(
            albedo_factor=np.array([0.6, 0.6, 0.6, 1], np.float32),
            metallic_factor=0.0, roughness_factor=1.0, double_sided=True),
            Mesh(positions=np.asarray(verts, np.float32),
                 indices=np.array([[0, 2, 1], [0, 3, 2]], np.int32)))
        e = s.add(name)
        e.transform = Transformable()
        e.model = model
    return s


@pytest.fixture(scope="module")
def second_frame():
    """The port's renderer and its second frame's recorded passes."""
    from tauray_torch.app.main import create_renderer
    from tauray_torch.options import Options
    opt = Options()
    opt.width = opt.height = N
    opt.renderer = "restir"
    opt.max_ray_depth = 3
    opt.tonemap = "linear"
    s = closed_room()
    rr = create_renderer(opt, s, CPU)
    rr.set_scene(s)
    with chip_smoke.restir_capture(1) as rec:
        for k in range(2):
            if k:
                rr.update_frame()
            rr.render_device()
    return rr, rec


@pytest.mark.parametrize("kind", ["di", "gi"])
def test_hold_limits_catch_lost_hits(second_frame, kind):
    from tauray_torch.stages.restir import restir_di_pass
    from tauray_torch.stages.restir_gi import restir_gi_pass
    rr, rec = second_frame
    fn, hold, limit = {
        "di": (restir_di_pass, chip_smoke.hold_di_cpu,
               chip_smoke.HOLD_DI_OFF),
        "gi": (restir_gi_pass, chip_smoke.hold_gi_cpu,
               chip_smoke.HOLD_GI_OFF)}[kind]
    r = rec[kind]
    sound = hold(r["out"], fn(rr.device_scene, rr.bvh, *r["args"],
                              **r["kw"]), "sound")
    print(kind, "sound", sound)
    assert sound["off"] == 0.0
    fault = fn(rr.device_scene, LosesHits(rr.bvh), *r["args"], **r["kw"])
    with pytest.raises(RuntimeError, match="departs") as err:
        hold(r["out"], fault, "fault")
    print(kind, "fault", err.value, "limit", limit)


@pytest.fixture(scope="module")
def raster_frame():
    """The second frame's render_raster call of a 2-frame raster run."""
    from tauray_torch.renderer.raster_renderer import RasterRenderer
    from test_torch_raster import options, raster_scene
    opt = options("tauray_torch", width=N, height=N, pcf=16, pcss=8,
                  shadow_map_resolution=256)
    rr = RasterRenderer(opt, CPU)
    rr.set_scene(raster_scene("tauray_torch"))
    with chip_smoke.raster_capture(1) as cap:
        rr.render_device()
        rr.update_frame()
        rr.render_device()
    return cap


def _broken(maps, fault):
    if fault == "bias":
        return maps._replace(min_bias=torch.zeros_like(maps.min_bias),
                             max_bias=torch.zeros_like(maps.max_bias))
    return maps._replace(depth=torch.roll(maps.depth, 1, dims=2))


@pytest.mark.parametrize("fault", ["bias", "shift"])
def test_raster_hold_catches_broken_maps(raster_frame, fault):
    from tauray_torch.stages.raster import render_raster
    args, kw = list(raster_frame["args"]), raster_frame["kw"]
    sound = chip_smoke.hold_raster_cpu(raster_frame["out"],
                                       render_raster(*args, **kw), "sound",
                                       taps=16)
    print("raster sound", sound)
    assert sound["off"] == 0.0
    args[4] = _broken(args[4], fault)
    with pytest.raises(RuntimeError, match="departs") as err:
        chip_smoke.hold_raster_cpu(raster_frame["out"],
                                   render_raster(*args, **kw), "fault",
                                   taps=16)
    print("raster", fault, err.value, "limit", chip_smoke.HOLD_RASTER_OFF)
