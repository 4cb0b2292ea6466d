"""DSHGI renderers (reference: src/dshgi_renderer.cc, src/dshgi_server.cc);
the torch counterparts of tauray_tpu.renderer.dshgi_renderer on one
device.

* DSHGIRenderer = the raster renderer with an SH probe source: the local
  SHRenderer, or a network DSHGIClient for --renderer=dshgi-client.
* DSHGIServer = the headless probe service: each frame bakes the probes
  and publishes them over ZMQ (reference: the dshgi_server render loop,
  src/tauray.cc:1134-1167).
"""

from __future__ import annotations

import torch

from .base import Renderer
from .raster_renderer import FlatTracerHost, RasterRenderer
from .sh_renderer import SHRenderer


class DSHGIRenderer(RasterRenderer):
    def __init__(self, opt, device, remote: bool = False):
        if remote:
            from ..net.dshgi import DSHGIClient
            src = DSHGIClient(opt.connect, device)
        else:
            src = SHRenderer(opt, device)
        super().__init__(opt, device, sh_source=src)

    def warmup_step(self):
        """Warm-up frames only advance the SH probe source (its temporal
        blend, reference src/sh_path_tracer_stage.hh temporal_ratio); the
        raster draw carries no state across frames, so --warmup-frames
        skips it."""
        self.sh_source.step(self)


class DSHGIServer(Renderer):
    """Renderer-shaped service: each render_device() bakes the probes and
    publishes them, and returns a (1, 1, 1, 4) placeholder frame (the
    server draws nothing)."""

    def __init__(self, opt, device):
        super().__init__(opt, device)
        self.sh = SHRenderer(opt, device)
        from ..net.dshgi import DSHGIServerTransport
        self.transport = DSHGIServerTransport(opt.port)
        self._host = None

    def set_scene(self, scene):
        # the bake's scene and tracer; the server draws nothing, so it
        # builds no shadow maps (tauray_tpu's server hosts a whole
        # RasterRenderer, whose maps the bake never reads)
        self._host = FlatTracerHost(self.opt, self.device)
        self._host.set_scene(scene)
        self.scene = scene
        self.arrays = self._host.arrays

    def update_frame(self):
        self._host.update_frame()

    def _render_device(self) -> torch.Tensor:
        self.sh.step(self._host)
        grids = self.sh.grid_payloads()
        if grids:
            self.transport.publish(grids)
        return torch.zeros((1, 1, 1, 4), device=self.device)
