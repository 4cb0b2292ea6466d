"""Faults planted in the timed path, for the harness's tests and for the
readings of benchmark/control.py: each breaks the renderer that a run has
built, after its warm-up, and returns a function that mends it. `correct`
has to come out false under every fault that a cell can have.

FAULTS maps a name to (the fault, the renderers it applies to; None for
every renderer)."""

from __future__ import annotations

import dataclasses


def state_unchanged(rr):
    """render_device returns the last image without rendering."""
    img = rr.render_device()
    orig = rr.render_device
    rr.render_device = lambda: img

    def undo():
        rr.render_device = orig
    return undo


def _patch(module, name, new):
    orig = getattr(module, name)
    setattr(module, name, new)
    return lambda: setattr(module, name, orig)


def half_left_out(rr):
    """Every wave traces its first half only; the rest come back as
    misses."""
    from tauray_torch.ops import cluster
    from tauray_torch.ops.intersect import Hit
    orig = cluster._trace_padded

    def half(tracer, rays8, any_hit, need_uv):
        hit = orig(tracer, rays8, any_hit, need_uv)
        n = rays8.shape[0] // 2
        t = hit.t.clone()
        tid = hit.tri_id.clone()
        t[n:] = float("inf")
        tid[n:] = -1
        return Hit(t, tid, hit.u, hit.v)
    return _patch(cluster, "_trace_padded", half)


def answer_altered(rr):
    """K1's t comes back 1% long."""
    from tauray_torch.ops import cluster
    orig = cluster.trace_tiles_vm3
    return _patch(cluster, "trace_tiles_vm3", lambda *a: (
        lambda t, i: (t * 1.01, i))(*orig(*a)))


def pixels_halved(rr):
    """The path tracer traces the first half of each call's pixels and
    leaves the rest black."""
    import torch

    from tauray_torch.renderer import rt_renderer
    orig = rt_renderer.pt_trace_pass

    def half(cfg, scene, bvh, cam, prev_cam, pix, vp, prev):
        n = pix.shape[0] // 2
        out = orig(cfg, scene, bvh, cam, prev_cam, pix[:n], vp[:n],
                   prev[:n])
        return out._replace(color=torch.cat(
            [out.color, torch.zeros_like(out.color)]))
    return _patch(rt_renderer, "pt_trace_pass", half)


def _replace_cfg(rr, **kw):
    orig = rr.cfg
    rr.cfg = dataclasses.replace(orig, **kw)

    def undo():
        rr.cfg = orig
    return undo


def bounce_dropped(rr):
    """The path tracer's paths stop a bounce early."""
    return _replace_cfg(rr, max_bounces=rr.cfg.max_bounces - 1)


def nee_off(rr):
    """The path tracer's next-event estimation, and its shadow waves, are
    skipped."""
    return _replace_cfg(rr, nee=rr.cfg.nee._replace(
        point=0.0, triangle=0.0, directional=0.0, envmap=0.0))


def temporal_visibility_off(rr):
    """ReSTIR DI reuses its temporal samples without their visibility
    re-trace."""
    orig = rr.cfg_key
    rr.cfg_key = orig._replace(temporal_visibility=False)

    def undo():
        rr.cfg_key = orig
    return undo


def gi_off(rr):
    """ReSTIR GI is skipped."""
    orig = rr.gi_cfg
    rr.gi_cfg = None

    def undo():
        rr.gi_cfg = orig
    return undo


FAULTS = {
    "state_unchanged": (state_unchanged, None),
    "half_left_out": (half_left_out, None),
    "answer_altered": (answer_altered, None),
    "pixels_halved": (pixels_halved, {"path-tracer"}),
    "bounce_dropped": (bounce_dropped, {"path-tracer"}),
    "nee_off": (nee_off, {"path-tracer"}),
    "temporal_visibility_off": (temporal_visibility_off, {"restir"}),
    "gi_off": (gi_off, {"restir"}),
}


def for_renderer(renderer: str):
    """The names of the faults a renderer can have."""
    return [n for n, (_, r) in FAULTS.items() if r is None or renderer in r]
