"""SH probe renderer (reference: src/sh_renderer.cc,
shader/sh_path_tracer.rgen + sh_compact.comp); the torch counterpart of
tauray_tpu.renderer.sh_renderer on one device.

Per SH grid: path-trace `samples_per_probe` rays from each probe center,
project the sampled radiance onto the SH basis (the sh_compact reduction)
and blend it into the grid over time with `--dshgi-temporal-ratio`
(reference: src/sh_path_tracer_stage.hh temporal_ratio). Draws nothing
itself (reference: src/sh_renderer.hh:15-47): restir-hybrid and DSHGI
read the first grid. With more than one device (several cards, or an
explicit list) the probe axis is sharded over them, as tauray_tpu shards it
over its mesh (sh_renderer.py:133-185)."""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import rng as rng_ops
from ..ops import sh as sh_ops
from ..ops.ggx import modulate_color
from ..ops.lights import NEEWeights
from ..ops.sampling import sample_blackman_harris, sample_sphere
from ..parallel.mesh import make_devices, to_device
from ..stages.path_tracer import PTConfig, _FirstHit, evaluate_ray


def _mat3(m, v):
    """m (3, 3) applied to every row of v (R, 3), summed in column order
    as separate products and sums (the same rounding on every device)."""
    return v[:, 0:1] * m[:, 0] + v[:, 1:2] * m[:, 1] + v[:, 2:3] * m[:, 2]


def _bake_grid_impl(cfg, scene, tracer, coord, u_even, nt, fwd, w2l_lin,
                    res3, probes, order: int, S: int):
    """A whole grid bake: probe ray generation (even sphere sampling +
    Blackman-Harris position jitter), the wavefront path trace, probe
    colour and visibility, and the SH projection (the sh_compact
    reduction). Returns (P, C, 4) coefficients."""
    P = probes.shape[0]
    seed = rng_ops.init_random_sampler(coord)
    seed, u = rng_ops.generate_uniform_random(seed)
    dirs_local = sample_sphere(u_even)
    dirs = _mat3(nt, dirs_local)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    origins = torch.repeat_interleave(probes, S, dim=0)
    # spatial prefilter: probe positions jitter per sample in a
    # Blackman-Harris ball of film_radius voxels (reference:
    # sh_path_tracer.rgen:58-66 USE_BLACKMAN_HARRIS_FILTER +
    # sh_path_tracer_stage.hh:18-21 film=BLACKMAN_HARRIS, radius=1.0)
    ball_dir = sample_sphere(u[:, :2])
    r = (2.0 * sample_blackman_harris(u[:, 2]) - 1.0).abs() ** (1.0 / 3.0)
    loc_off = (ball_dir * r[:, None]) * (2.0 / res3)
    origins = origins + _mat3(fwd, loc_off)
    diffuse, refl, fh, _ = evaluate_ray(cfg, scene, tracer, seed, origins,
                                        dirs)
    # probe colour = modulate_color(mat, diffuse, reflection) with NO
    # first-hit emission term (reference: sh_path_tracer.rgen:95)
    color = modulate_color(_FirstHit(fh["albedo"], fh["metallic"]),
                           diffuse[:, :3], refl[:, :3])
    # visibility channel: first-hit distance in VOXEL units, clamped to
    # sqrt(3) (reference: sh_path_tracer.rgen:88-95; cell_scale from
    # sh_path_tracer_stage.cc:132 folded into w2l_lin * res/2)
    dl = _mat3(w2l_lin, dirs) * (0.5 * res3)
    world_dist = torch.linalg.norm(fh["vertex_pos"] - origins, dim=-1)
    dist = torch.where(
        fh["instance_id"] >= 0,
        torch.clamp(world_dist * torch.linalg.norm(dl, dim=-1), 0.0,
                    math.sqrt(3.0)),
        math.sqrt(3.0))
    color4 = torch.cat([color, dist[:, None]], dim=-1)
    # SH projection on the grid-LOCAL sample direction (reference:
    # sh_path_tracer.rgen:95 eval_sh_basis(local_ray_dir))
    basis = sh_ops.sh_basis(dirs_local, order)           # (P*S, C)
    w = 4.0 * math.pi / S
    return torch.einsum("psc,psk->pck", basis.reshape(P, S, -1),
                        color4.reshape(P, S, 4)) * w


def _blend_coefficients(prev, coef, ratio: float, first: bool):
    if first:
        return coef
    r = np.float32(ratio)
    return prev * float(np.float32(1.0) - r) + coef * float(r)


def _pcg_host(seed) -> np.uint32:
    """Host-side PCG hash (reference: shader/math.glsl:75-81), used for the
    per-frame even-sampling rotation (sh_path_tracer_stage.cc:133-134)."""
    s = np.uint32(np.uint64(seed) & np.uint64(0xFFFFFFFF))
    with np.errstate(over="ignore"):
        s = np.uint32(s * np.uint32(747796405) + np.uint32(2891336453))
        s = np.uint32(((s >> np.uint32((s >> np.uint32(28)) + np.uint32(4)))
                       ^ s) * np.uint32(277803737))
        s = np.uint32((s >> np.uint32(22)) ^ s)
    return s


class SHRenderer:
    """Bakes every SH grid of the scene on one device; the `sh_source` of
    restir-hybrid (reference: src/dshgi_renderer.hh local SH source)."""

    def __init__(self, opt, device):
        self.opt = opt
        self.device = torch.device(device)
        self.frame = 0
        self._grids = None
        # the probe-sharded bake's devices: every card (cut by
        # --mesh-shape) when there is more than one, as tauray_tpu builds
        # its mesh only when len(jax.devices()) > 1; --fake-devices alone
        # bakes on one device. Callers may set an explicit list.
        devs = make_devices(opt.mesh_shape, self.device)
        self.devices: Optional[List[torch.device]] = \
            devs if len(devs) > 1 else None

    def _bake_sharded(self, cfg, scene, tracer, coord, u_even, nt, fwd,
                      w2l_lin, res3, probes, order: int, S: int):
        """Probe-sharded bake: pad P to a multiple of the device count by
        repeating probe 0 (its sample rows with coord[:, 0] offset by P),
        bake each device's contiguous probe slice on its copy of the scene
        and tracer, concatenate on the first device and cut back to P."""
        devs = self.devices
        D = len(devs)
        Pn = probes.shape[0]
        pad = (-Pn) % D
        if pad:
            probes = torch.cat([probes, probes[:1].expand(pad, 3)])
            extra = coord[:S * pad].clone()
            extra[:, 0] += Pn
            coord = torch.cat([coord, extra])
            u_even = torch.cat([u_even, u_even[:S * pad]])
        per = probes.shape[0] // D
        reps = {d: (to_device(scene, d), to_device(tracer, d))
                for d in dict.fromkeys(devs)}
        parts = []
        for k, d in enumerate(devs):
            rows = slice(k * per * S, (k + 1) * per * S)
            parts.append(_bake_grid_impl(
                cfg, *reps[d], coord[rows].to(d), u_even[rows].to(d),
                nt.to(d), fwd.to(d), w2l_lin.to(d), res3.to(d),
                probes[k * per:(k + 1) * per].to(d), order=order, S=S))
        return torch.cat([p.to(self.device) for p in parts])[:Pn]

    def current_grid_data(self) -> Optional[Tuple]:
        """(coef_grid, world_to_local) of the first grid."""
        if not self._grids:
            return None
        return self._grids[0]

    def grid_payloads(self):
        """Every grid's (coef_grid, world_to_local)."""
        return self._grids or []

    def step(self, host_renderer):
        """Advance probe baking by one frame on the host renderer's device
        scene and tracer."""
        opt = self.opt
        dev = self.device
        arrays = host_renderer.arrays
        # the host (ReSTIRRenderer, RasterRenderer or the DSHGI server's
        # scene) traces without slot ids, so its device scene is in
        # original triangle order as the tracer's ids
        scene = host_renderer.device_scene
        tracer = host_renderer.bvh
        grids = arrays.scene.sh_grids()
        if not grids:
            self._grids = None
            return
        out = []
        for gi, e in enumerate(grids):
            g = e.sh_grid
            g.set_order(opt.sh_order)
            probes = g.probe_positions(e.transform)      # (P, 3)
            P = probes.shape[0]
            S = min(opt.samples_per_probe, 512)
            cfg = PTConfig(
                width=1, height=1, n_views=1,
                max_bounces=max(opt.max_ray_depth, 1),
                nee=NEEWeights.from_options(opt, arrays),
                min_ray_dist=opt.min_ray_dist,
                mis_mode=opt.multiple_importance_sampling,
                bounce_mode=opt.bounce_mode,
                tri_light_mode=opt.tri_light_mode,
                indirect_clamping=opt.indirect_clamping,
                regularization_gamma=opt.regularization,
                has_envmap=arrays.environment_map is not None,
                has_point_lights=arrays.point_count > 0,
                has_alpha_materials=arrays.any_alpha_materials,
                rng_seed=opt.rng_seed,
                # the reference's sh_path_tracer.rgen defines HIDE_LIGHTS +
                # INDIRECT_CLAMP_FIRST_BOUNCE: probes never see light
                # geometry directly and clamping applies from bounce 0
                hide_lights=True,
                clamp_first_bounce=True)
            # deterministic per-(probe, sample, grid, frame) seeds
            pid = np.repeat(np.arange(P, dtype=np.int64), S)
            sid = np.tile(np.arange(S, dtype=np.int64), P)
            coord = np.stack([pid, sid, np.full(P * S, gi, np.int64),
                              np.full(P * S, self.frame, np.int64)],
                             axis=-1)
            # EVEN (Fibonacci-spiral) sphere sampling with a per-frame
            # random rotation (reference: sh_path_tracer.rgen:68-73,
            # math.glsl:336-340 even_sample_sphere; rotation from pcg per
            # frame, sh_path_tracer_stage.cc:133-134). Directions are
            # sampled in grid-LOCAL space and the SH basis is evaluated on
            # the LOCAL direction; rays trace along the
            # normal-transformed global direction.
            fr = np.uint64(self.frame)
            off = np.array(
                [_pcg_host(2 * fr + np.uint64(gi) * 977),
                 _pcg_host(2 * fr + np.uint64(gi) * 977 + 1)],
                np.float64) / float(0xFFFFFFFF)
            si = np.tile(np.arange(S, dtype=np.float64), P)
            u_even = np.stack([
                (si + off[1]) / S,
                np.mod((si + off[0]) * 0.38196601125, 1.0)], axis=-1)
            # normal_transform = the transform's ROTATION only (reference:
            # sh_path_tracer_stage.cc:130 mat4(get_matrix_orientation(...)))
            M = np.asarray(e.transform.get_global_transform())
            fwd = M[:3, :3]
            nt = fwd / np.linalg.norm(fwd, axis=0, keepdims=True)
            w2l = np.linalg.inv(M).astype(np.float32)
            res3 = np.array(g.resolution[:3], np.float32)

            def t(x):
                return torch.from_numpy(
                    np.ascontiguousarray(x, np.float32)).to(dev)
            bake = _bake_grid_impl if self.devices is None else \
                self._bake_sharded
            coef = bake(
                cfg, scene, tracer, torch.from_numpy(coord).to(dev),
                t(u_even), t(nt), t(fwd), t(w2l[:3, :3]), t(res3),
                t(probes), order=g.order, S=S)             # (P, C, 4)
            rz, ry, rx = g.resolution[2], g.resolution[1], g.resolution[0]
            coef = coef.reshape(rx, ry, rz, -1, 4).permute(2, 1, 0, 3, 4)
            # mix = max(1/history, temporal_ratio): a true running mean
            # until the EMA ratio takes over (reference:
            # sh_path_tracer_stage.cc:129 guni->mix_ratio)
            ratio = max(1.0 / (self.frame + 1), opt.dshgi_temporal_ratio)
            g.coefficients = _blend_coefficients(
                None if self.frame == 0 else torch.as_tensor(
                    g.coefficients, device=dev),
                coef.contiguous(), ratio, first=self.frame == 0)
            out.append((g.coefficients, t(w2l)))
        self._grids = out
        self.frame += 1
