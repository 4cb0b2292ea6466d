"""Multi-device distributed path tracing over a list of torch devices; the
torch counterpart of tauray_tpu.renderer.distributed (reference:
src/rt_renderer.cc:84-183).

Each logical workload renders its slice of the frame per the distribution
strategy on its physical device; the partial frames are gathered onto the
first device and stitched there into the accumulation (reference:
src/device_transfer.cc, src/stitch_stage.cc). `--fake-devices=F` puts F
workloads on every physical device, and a device list that repeats one
card (`[cuda:0] * 4`) runs every per-physical-device path on it.

The scene and tracer are replicated once per distinct physical device
(fake workloads share their device's copy). Each workload traces only its
valid pixels, in waves of at most WAVE_CAP rays: tauray_tpu's static
pad-to-max_count lanes are a TPU schedule and are not carried. Dynamic
load balancing re-slices the shuffled-strips ranges; when accumulation is
active the re-sliced frame is blended into the existing accumulation
with ratio 1/(frames+1) (reference: src/rt_renderer.cc:164-183).

Multi-view renders with at least as many views as devices shard the VIEW
axis instead (reference: src/restir_renderer.cc:84-106): each device
renders whole frames of a contiguous range of views.

The rendered image is the tonemapped stitch; the post stack is not run,
as tauray_tpu's render_device returns it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import tracing
from ..parallel import distribution as dist_mod
from ..parallel.mesh import make_devices, to_device
from ..scene.device import to_camera_uniforms
from ..stages.path_tracer import pt_trace_pass
from ..stages.tonemap import tonemap
from ..validation import check_nan
from .rt_renderer import WAVE_CAP, PathTracerRenderer


class DistributedPathTracerRenderer(PathTracerRenderer):
    """Path tracer spread over `devices` (default: make_devices of
    --mesh-shape on `device`), each carrying --fake-devices workloads."""

    def __init__(self, opt, device, direct_only: bool = False,
                 devices: Optional[Sequence] = None):
        self.devices = [torch.device(d) for d in (
            devices if devices is not None
            else make_devices(opt.mesh_shape, device))]
        self.fake = max(int(opt.fake_devices), 1)
        self.n_devices = len(self.devices) * self.fake
        super().__init__(opt, self.devices[0], direct_only=direct_only)

    # ------------------------------------------------------------------
    def _scene_changed(self):
        super()._scene_changed()
        opt = self.opt
        D = self.n_devices
        strategy = opt.distribution_strategy
        if D <= 1:
            strategy = dist_mod.DUPLICATE  # (reference: tauray.cc:520-521)
        self.strategy = strategy
        # --workload: initial per-device ratios (reference: options.hh
        # workload + rt_renderer.cc initial distribution); normalized,
        # padded with the mean for missing devices
        wl = list(opt.workload or [])[:D]
        if wl and any(w > 0 for w in wl):
            wl = [max(float(w), 0.0) for w in wl]
            wl += [sum(wl) / len(wl)] * (D - len(wl))
            tot = sum(wl)
            self.workloads = [w / tot for w in wl]
        else:
            self.workloads = [1.0 / D] * D
        self.accumulated_frames = 0
        self._stitch_blend = 1.0
        V = self.cfg.n_views
        self.view_sharded = V >= D > 1 and self.fake == 1 and \
            strategy != dist_mod.DUPLICATE
        # pixels per call: samples_per_pass samples of them trace as one
        # wave of at most WAVE_CAP rays
        self._per_call = max(1, WAVE_CAP // max(self.samples_per_pass, 1))
        if self.view_sharded:
            self._split_views()
        else:
            self._refresh_distribution()

    def _workload_device(self, i: int) -> torch.device:
        """Workload i's physical device: the F workloads of device k are
        k*F .. k*F + F - 1, as tauray_tpu's P('dev') blocks."""
        return self.devices[i // self.fake]

    def _refresh_distribution(self):
        """Each workload's params, its valid pixels (x, y) on its device
        and their frame indices on the first device. Every pixel of every
        share is taken: tauray_tpu's static cap of ceil(4WH / (128 D)) *
        128 slots under shuffled strips drops the pixels of a share past
        it (ROADMAP, faults of the reference)."""
        opt = self.opt
        D = self.n_devices
        V = self.cfg.n_views
        cumulative = 0.0
        self.dist_params = []
        self._work = []
        lins = []
        for i in range(D):
            ratio = min(max(self.workloads[i], 0.0), 1.0 - cumulative)
            p = dist_mod.get_device_distribution_params(
                (opt.width, opt.height), self.strategy, cumulative, ratio,
                i, D, i == 0)
            if self.strategy == dist_mod.SHUFFLED_STRIPS:
                cumulative += ratio
            self.dist_params.append(p)
            pix, valid, lin = dist_mod.device_pixel_positions(
                p, dist_mod.get_distribution_render_count(p))
            pix, lin = pix[valid], lin[valid]
            dev = self._workload_device(i)
            N = pix.shape[0]
            # every view of the workload's pixels, view-major
            self._work.append((
                dev, torch.from_numpy(np.tile(pix, (V, 1))).to(dev),
                torch.from_numpy(np.repeat(np.arange(V, dtype=np.int32),
                                           N)).to(dev), N))
            lins.append(lin)
        lin = np.concatenate(lins)
        self._lin = torch.from_numpy(lin[None]).to(self.device)
        self._valid = torch.ones(lin.shape, dtype=torch.bool,
                                 device=self.device)[None]

    def _split_views(self):
        """The view-sharded split: views padded with the last view to a
        multiple of the device count and cut into contiguous ranges; each
        device traces its distinct views, whole frames in scanline
        order."""
        V = self.cfg.n_views
        D = self.n_devices
        W, H = self.cfg.width, self.cfg.height
        vpad = -(-V // D) * D
        vids = np.minimum(np.arange(vpad).reshape(D, -1), V - 1)
        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        pix = np.stack([xs.reshape(-1), ys.reshape(-1)],
                       axis=-1).astype(np.int32)
        self._view_work = []
        for k, dev in enumerate(self.devices):
            views = np.unique(vids[k]).astype(np.int32)
            self._view_work.append((
                dev, views,
                torch.from_numpy(np.tile(pix, (len(views), 1))).to(dev),
                torch.from_numpy(np.repeat(views, H * W)).to(dev)))

    # ------------------------------------------------------------------
    def set_device_workloads(self, ratios: List[float]):
        """(reference: src/rt_renderer.cc set_device_workloads)"""
        if self.strategy in (dist_mod.DUPLICATE, dist_mod.SCANLINE) or \
                self.view_sharded:
            return
        self.workloads = list(ratios)
        self._refresh_distribution()
        if self.opt.accumulation:
            self._stitch_blend = 1.0 / (self.accumulated_frames + 1)

    def _replicas(self, cam, prev_cam):
        """(scene, tracer, cam, prev_cam) on each distinct physical
        device, from the first device's."""
        scene = self._slot_scene()
        return {dev: (to_device(scene, dev), to_device(self.bvh, dev),
                      to_device(cam, dev), to_device(prev_cam, dev))
                for dev in dict.fromkeys(self.devices)}

    def _trace(self, rep, pix, vp, prev: int) -> torch.Tensor:
        """One pass of colour for pixels pix / views vp on their device, in
        calls of at most _per_call pixels. Returns (R, 4)."""
        scene, bvh, cam, prev_cam = rep
        out = []
        for s in range(0, pix.shape[0], self._per_call):
            n = min(self._per_call, pix.shape[0] - s)
            prev_arr = torch.full((n,), prev, dtype=torch.int64,
                                  device=pix.device)
            out.append(pt_trace_pass(self.cfg, scene, bvh, cam, prev_cam,
                                     pix[s:s + n], vp[s:s + n],
                                     prev_arr).color)
        return torch.cat(out) if out else \
            torch.zeros((0, 4), device=pix.device)

    def _render_device(self) -> torch.Tensor:
        cfg = self.cfg
        opt = self.opt
        cam = to_camera_uniforms(
            self.arrays.camera_uniforms(self.viewports()), self.device)
        prev_cam = self._prev_cam if self._prev_cam is not None else cam
        reps = self._replicas(cam, prev_cam)
        n_passes = self.samples_per_pixel // self.samples_per_pass
        sample_base = self.samples_accumulated
        W, H, V = cfg.width, cfg.height, cfg.n_views
        color_full = self.accum_color
        if color_full is None or tuple(color_full.shape) != (V, H, W, 4):
            color_full = torch.zeros((V, H, W, 4), device=self.device)
        for p in range(n_passes):
            prev_n = sample_base + p * self.samples_per_pass
            if self.view_sharded:
                color_full = self._view_pass(reps, color_full, prev_n)
                continue
            # enqueue every workload's waves before the first gather
            parts = []
            for i, (dev, pix, vp, N) in enumerate(self._work):
                with tracing.span("path tracing", dev, i):
                    parts.append((self._trace(reps[dev], pix, vp, prev_n),
                                  N))
            with tracing.span("stitch"):
                chunks = torch.cat([c.to(self.device).reshape(V, N, 4)
                                    for c, N in parts], dim=1)
                if p == 0 and self._stitch_blend < 1.0:
                    t = 1.0 - self._stitch_blend
                elif prev_n == 0:
                    t = 0.0
                else:
                    t = prev_n / (prev_n + self.samples_per_pass)
                color_full = dist_mod.stitch_accumulate(
                    (H, W), chunks[None], self._lin, self._valid,
                    color_full, t)
            check_nan(cfg.validate, "stitch", color_full)
        self._stitch_blend = 1.0
        self.accum_color = color_full
        self.samples_accumulated = sample_base + self.samples_per_pixel
        self.accumulated_frames += 1
        self.frame_counter += 1
        self._prev_cam = cam
        img = tonemap(color_full, opt.tonemap, opt.exposure, opt.gamma)
        check_nan(cfg.validate, "tonemap", img)
        return img

    def _view_pass(self, reps, color_full, prev_n: int) -> torch.Tensor:
        """One pass of the view-sharded path: every device's views, then
        the gather onto the first device and the running mean."""
        cfg = self.cfg
        H, W = cfg.height, cfg.width
        parts = []
        for k, (dev, views, pix, vp) in enumerate(self._view_work):
            with tracing.span("path tracing", dev, k):
                parts.append((views, self._trace(reps[dev], pix, vp,
                                                 prev_n)))
        with tracing.span("stitch"):
            frame = torch.empty_like(color_full)
            for views, c in parts:
                frame[torch.from_numpy(views).long().to(self.device)] = \
                    c.to(self.device).reshape(len(views), H, W, 4)
            t = 0.0 if prev_n == 0 else \
                prev_n / (prev_n + self.samples_per_pass)
            # the weights as tauray_tpu's weakly typed Python floats
            # round them
            color_full = color_full * float(np.float32(t)) + \
                frame * float(np.float32(1.0 - t))
        check_nan(cfg.validate, "stitch", color_full)
        return color_full
