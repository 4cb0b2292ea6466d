"""DSHGI of tauray_torch (renderer/dshgi_renderer.py, net/dshgi.py)
against tauray_tpu's: the raster renderer with a local SH probe source on
the raster test scene (tests/test_torch_raster.py) with a 2x2x2 grid, 64
samples a probe, depth 2, over 3 frames; the warm-up path; the grid
messages; and a server -> client round trip over loopback TCP.

The probe coefficients after each bake hold to BAKE_TOL (1e-5) of the
grid's largest magnitude (tests/test_torch_sh.py's rule), the G-buffer
and image as tests/test_torch_raster.py holds them. `_grid_message`
writes the same bytes as tauray_tpu's. The parse takes the channel count
from the payload's length: tauray_tpu's reads three channels, so it
garbles the four-channel grids its own server publishes (the bake's RGB
and visibility distance); the port's gives every grid back bit for
bit."""

import socket
import time

import numpy as np
import pytest
import torch

from tauray_torch.net import dshgi as tnet
from tauray_tpu.net import dshgi as jnet

from test_torch_raster import (CPU, _np, hold_gbuf, options, raster_scene)

torch.set_num_threads(2)

BAKE_TOL = 1e-5
ROUND_TRIP_S = 5.0


def _grid_scene(pkg):
    return raster_scene(pkg, grid=True)


def dshgi_pair(**opts):
    """(port DSHGIRenderer on the CPU, tauray_tpu DSHGIRenderer) with the
    local probe source: 64 samples a probe, depth 2."""
    from tauray_torch.renderer.dshgi_renderer import DSHGIRenderer as TR
    from tauray_tpu.renderer.dshgi_renderer import DSHGIRenderer as JR
    kw = dict(samples_per_probe=64, max_ray_depth=2, **opts)
    t = TR(options("tauray_torch", **kw), CPU)
    j = JR(options("tauray_tpu", **kw))
    # the single-device bake (conftest's 8 virtual devices would shard it;
    # the sharded bake is bit-identical)
    j.sh_source.mesh = None
    t.set_scene(_grid_scene("tauray_torch"))
    j.set_scene(_grid_scene("tauray_tpu"))
    return t, j


def hold_bake(t, j, what):
    got, w2l_t = t.sh_source.current_grid_data()
    want, w2l_j = j.sh_source.current_grid_data()
    got, want = _np(got), _np(want)
    assert got.shape == want.shape == (2, 2, 2, 9, 4)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max()) / scale
    print(f"{what}: max |diff| {err:.3e} of the largest coefficient "
          f"{scale:.4g}")
    assert err <= BAKE_TOL, (what, err)
    np.testing.assert_allclose(_np(w2l_t), _np(w2l_j), rtol=1e-6, atol=1e-6)


def test_dshgi_frames_match_jax():
    """3 frames: each frame's bake (the blend of frame k) and its
    G-buffer and image."""
    t, j = dshgi_pair()
    for k in range(3):
        if k:
            t.update_frame()
            j.update_frame()
        img_t, img_j = t.render_device(), j.render_device()
        hold_bake(t, j, f"dshgi frame {k}")
        hold_gbuf(dict(t.last_gbuf, image=img_t),
                  dict(j.last_gbuf, image=img_j), f"dshgi frame {k}")
    assert t.sh_source.frame == 3


def test_warmup_step_advances_only_the_bake(monkeypatch):
    """warmup_step bakes (the probe blend advances) and draws nothing; the
    CLI's warm-up loop takes it, so --warmup-frames=2 with 1 frame draws
    once and bakes three times."""
    from tauray_torch.app.main import replay_viewer
    from tauray_torch.renderer import dshgi_renderer
    t, _ = dshgi_pair()
    t.warmup_step()
    assert t.sh_source.frame == 1 and t.last_gbuf is None
    draws = []
    orig = dshgi_renderer.DSHGIRenderer.render_device

    def counted(self):
        draws.append(self.sh_source.frame)
        return orig(self)
    monkeypatch.setattr(dshgi_renderer.DSHGIRenderer, "render_device",
                        counted)
    made = []
    monkeypatch.setattr(
        "tauray_torch.app.main.create_renderer",
        lambda opt, s, device: made.append(
            dshgi_renderer.DSHGIRenderer(opt, device)) or made[-1])
    opt = options("tauray_torch", renderer="dshgi", samples_per_probe=16,
                  max_ray_depth=1, warmup_frames=2, frames=1,
                  headless="")
    replay_viewer(opt, _grid_scene("tauray_torch"), CPU)
    assert draws == [2]
    assert made[0].sh_source.frame == 3


def test_grid_message_bytes_match_jax():
    rng = np.random.default_rng(8)
    w2l = rng.standard_normal((4, 4)).astype(np.float32)
    for K in (3, 4):
        coef = rng.standard_normal((2, 3, 4, 9, K)).astype(np.float32)
        got = tnet._grid_message(1, 2, 0.5, w2l, coef)
        assert got == jnet._grid_message(1, 2, 0.5, w2l, coef)
        index, order, radius, transform, back = tnet._parse_grid_message(
            got)
        assert (index, order, radius) == (1, 2, 0.5)
        np.testing.assert_array_equal(transform, w2l)
        assert back.tobytes() == coef.tobytes() and back.shape == coef.shape
        jback = jnet._parse_grid_message(got)[4]
        # tauray_tpu's parse reads 3 channels: right for RGB grids only
        assert (jback.tobytes() == coef.tobytes()) == (K == 3)
    with pytest.raises(ValueError):
        tnet._parse_grid_message(got[:-4])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_to_client_round_trip():
    """A DSHGIServer bakes the grid scene and publishes it; a DSHGIClient
    on loopback TCP receives it bit for bit, and a dshgi-client renderer
    draws with it. Publishing repeats until the subscription has arrived,
    within ROUND_TRIP_S."""
    pytest.importorskip("zmq")
    from tauray_torch.renderer.dshgi_renderer import (DSHGIRenderer,
                                                      DSHGIServer)
    port = _free_port()
    opt = options("tauray_torch", renderer="dshgi-server", port=port,
                  samples_per_probe=16, max_ray_depth=1)
    server = DSHGIServer(opt, CPU)
    server.set_scene(_grid_scene("tauray_torch"))
    assert tuple(server.render_device().shape) == (1, 1, 1, 4)
    grids = server.sh.grid_payloads()
    copt = options("tauray_torch", renderer="dshgi-client",
                   connect=f"localhost:{port}")
    client = DSHGIRenderer(copt, CPU, remote=True)
    try:
        deadline = time.monotonic() + ROUND_TRIP_S
        got = None
        while got is None and time.monotonic() < deadline:
            server.transport.publish(grids)
            time.sleep(0.05)
            got = client.sh_source.current_grid_data()
        assert got is not None, "no grid within the deadline"
        coef, w2l = grids[0]
        assert got[0].device == CPU
        assert got[0].numpy().tobytes() == coef.numpy().tobytes()
        np.testing.assert_array_equal(got[1].numpy(), w2l.numpy())
        client.set_scene(raster_scene("tauray_torch"))
        img = client.render_device()
        assert tuple(img.shape) == (1, 16, 16, 4)
        assert bool(torch.isfinite(img).all())
    finally:
        client.sh_source.close()
        server.transport.close()


def test_server_starts_without_a_scene(monkeypatch):
    """main() takes --renderer=dshgi-server with no scene path (it goes on
    to ask for the card); without the server a scene path is required."""
    from tauray_torch.app.main import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--renderer=dshgi-server", "--frames=1"])
    assert main(["--renderer=raster", "--headless=x"]) == 1
