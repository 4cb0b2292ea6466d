"""ReSTIR GI of tauray_torch (stages/restir_gi.py) against tauray_tpu's,
with all three shift mappings, on the room of tests/test_torch_restir.py.

The path functions run against tauray_tpu's op by op (jax.disable_jit):
from one seed every integer field is exact and the floats within 1e-4
relative (a tail of 1% within 1e-3; tests/test_torch_shading.py's rule).
restir_gi_pass and the renderer run against tauray_tpu's jitted programs,
where XLA:CPU contracts multiply-adds into FMAs: a path's positions then
differ by ulps, which moves grazing shadow rays and the reservoir
selections near their thresholds. Where the kept path (its seed) agrees,
rc_kind is exact and the path's floats within 1e-3 relative; the share of
pixels whose kept path differs is printed and at most GI_FLIP_MAX. These
run in the room without its emissive panel, whose triangle lights tie
every NEE ray with the emitter at the ray's end (tests/test_torch_restir's
emitter ties).

The port's versions of tests/test_restir.py's furnace and glossy checks,
and the ReSTIR-against-PT image MSE of both packages, close the file."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauray_torch.stages import restir_gi as tg
from tauray_tpu.stages import restir_gi as jg

from test_torch_restir import (CPU, GB, N, frames, hold_images, renderers,
                               room_scene)
from test_torch_shading import _close

torch.set_num_threads(2)

SHIFTS = ["reconnection-shift", "random-replay-shift", "hybrid-shift"]
GI_FLIP_MAX = 0.03
SURF_ONLY = ("rc_normal", "rc_alb", "rc_mr", "rc_nee_dir", "rc_nee_L",
             "rc_in_dir", "rc_in_L")


def _no_panel(pkg):
    return room_scene(pkg, panel=False)


@pytest.fixture(scope="module")
def rooms():
    """{panel: (port renderer, tauray_tpu renderer, two port G-buffers)}
    at depth 3; the G-buffers as tests/test_torch_restir's room fixture
    makes them."""
    from tauray_torch.renderer.restir_renderer import _gbuffer_pass
    from tauray_torch.scene.device import to_camera_uniforms
    out = {}
    for panel in (True, False):
        t, j = renderers(room_scene if panel else _no_panel,
                         max_ray_depth=3)
        cam_e = next(e for e in t.scene.entities if e.camera is not None)
        cams = []
        for k in range(2):
            cam_e.transform.set_position((0.06 * k, 2.0, 4.0 - 0.05 * k))
            cams.append(to_camera_uniforms(t.arrays.camera_uniforms(
                t.viewports()), CPU))
        out[panel] = (t, j, [
            {k: v.numpy() for k, v in _gbuffer_pass(
                t.device_scene, t.bvh, cams[f], cams[max(f - 1, 0)], N, N,
                1e-4, False).items()} for f in range(2)])
    return out


def _mats(g):
    R = N * N
    return (tg._mat_from_stored(torch.from_numpy(g["albedo"]),
                                torch.from_numpy(g["mr"]), R),
            jg._mat_from_stored(jnp.asarray(g["albedo"]),
                                jnp.asarray(g["mr"]), (R,)))


def _flat(g, k):
    x = g[k]
    return x.reshape((N * N,) + x.shape[2:])


def _seeds(seed):
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, (N * N, 4), dtype=np.uint64).astype(np.uint32)


def hold_fields(got: dict, want: dict, what, extra=None, ties=0.0):
    """Path fields (and extra {name: (port, tauray_tpu)} per-pixel values,
    when given): integers exact; rc_pos/rc_emit
    everywhere and the other floats on surface paths (the rest are never
    read) within 1e-4 relative (+1e-5), a 1% tail of the elements within
    1e-3. ties: the share of pixels allowed off (printed), whose NEE ray
    ended on an emitter's plane (tests/test_torch_restir's emitter
    ties); the rule holds on the others."""
    extra = extra or {}
    R = N * N
    surf = np.asarray(want["rc_kind"]) == tg.RC_SURF if want else \
        np.ones(R, bool)
    items = dict(want, **{k: v[1] for k, v in extra.items()})
    gots = dict(got, **{k: v[0] for k, v in extra.items()})
    pairs, off = {}, np.zeros(R, bool)
    for k, w in items.items():
        g = gots[k].numpy() if isinstance(gots[k], torch.Tensor) \
            else gots[k]
        g, w = g.reshape(R, -1), np.asarray(w).reshape(R, -1)
        if k == "seed":
            g = g.astype(np.uint32)
        if w.dtype.kind in "iu":
            off |= (g != w).any(-1)
            continue
        sel = surf if k in SURF_ONLY else np.ones(R, bool)
        off |= sel & ~np.isclose(g, w, rtol=1e-3, atol=1e-5).all(-1)
        pairs[k] = (g, w, sel)
    print(f"{what}: {off.mean():.4f} of pixels off")
    assert off.mean() <= ties, (what, off.mean(), np.argwhere(off))
    for k, (g, w, sel) in pairs.items():
        _close(g[sel & ~off], w[sel & ~off], f"{what}/{k}", rtol=1e-4,
               atol=1e-5)


@pytest.mark.parametrize("panel", [True, False])
@pytest.mark.parametrize("depth", [2, 3])
def test_generate_path_matches_jax(rooms, depth, panel):
    """_generate_path from one seed per pixel: C, p1 and every field."""
    t, j, gb = rooms[panel]
    g = gb[1]
    seed = _seeds(depth)
    mt, mj = _mats(g)
    nee = t.gi_cfg.nee
    got = tg._generate_path(
        t.device_scene, t.bvh, torch.from_numpy(seed.astype(np.int64)),
        *(torch.from_numpy(_flat(g, k)) for k in ("pos", "normal", "view")),
        mt, nee, depth, "material", 1e-4, False, True)
    with jax.disable_jit():
        want = jg._generate_path(
            j.device_scene, j.bvh, jnp.asarray(seed),
            *(jnp.asarray(_flat(g, k)) for k in ("pos", "normal", "view")),
            mj, nee, depth, "material", 1e-4, False, True)
    hold_fields(got[2], want[2], f"path d{depth} panel {panel}",
                {"C": (got[0], want[0]), "p1": (got[1], want[1])},
                ties=0.02 if panel else 0.0)
    kinds = np.bincount(np.asarray(want[2]["rc_kind"]), minlength=3)
    print(f"depth {depth} panel {panel}: rc_kind counts {kinds}")
    assert kinds[tg.RC_SURF] > 0 and kinds[tg.RC_ENV] > 0


@pytest.fixture(scope="module")
def paths(rooms):
    """Paths of G-buffer 1's pixels generated by the port (depth 3,
    room with the panel): fields (numpy, the seed as uint32)."""
    t, _, gb = rooms[True]
    g = gb[1]
    mt, _ = _mats(g)
    _, _, f = tg._generate_path(
        t.device_scene, t.bvh, torch.from_numpy(_seeds(7).astype(np.int64)),
        *(torch.from_numpy(_flat(g, k)) for k in ("pos", "normal", "view")),
        mt, t.gi_cfg.nee, 3, "material", 1e-4, False, True)
    return {k: (v.numpy().astype(np.uint32) if k == "seed" else v.numpy())
            for k, v in f.items()}


def _port_fields(paths):
    return {k: torch.from_numpy(v.astype(np.int64) if k == "seed" else v)
            for k, v in paths.items()}


def _shifted(g):
    """The receiving pixels: G-buffer 1 rolled by (3, -2) pixels, so each
    path is re-rooted at another pixel's vertex."""
    return np.roll(np.roll(_flat(g, "pos").reshape(N, N, 3), 3, 0), -2,
                   1).reshape(-1, 3)


def test_reconnect_eval_and_geom_term(rooms, paths):
    """_reconnect_eval at the path's own vertex and re-rooted at another
    pixel's, and _geom_term at both."""
    t, j, gb = rooms[True]
    g = gb[1]
    mt, mj = _mats(g)
    nee = t.gi_cfg.nee
    ft = _port_fields(paths)
    fj = {k: jnp.asarray(v) for k, v in paths.items()}
    for pos in (_flat(g, "pos"), _shifted(g)):
        args = [_flat(g, "normal"), _flat(g, "view")]
        with jax.disable_jit():
            want = jg._reconnect_eval(
                j.device_scene, fj, jnp.asarray(pos),
                *(jnp.asarray(a) for a in args), mj, "material", nee)
            want_g = jg._geom_term(fj, jnp.asarray(pos))
        got = tg._reconnect_eval(t.device_scene, ft, torch.from_numpy(pos),
                                 *(torch.from_numpy(a) for a in args), mt,
                                 "material", nee)
        hold_fields({}, {}, "reconnect", {
            "C": (got, want),
            "geom": (tg._geom_term(ft, torch.from_numpy(pos)), want_g)},
            ties=0.0)


@pytest.mark.parametrize("shift", SHIFTS)
def test_shift_matches_jax(rooms, paths, shift):
    """_shift of the paths into other pixels under each mapping: p-hat,
    |J| and the shifted fields (random replay traces the path again from
    its seed at the receiving vertex)."""
    t, j, gb = rooms[True]
    g = gb[1]
    mt, mj = _mats(g)
    nee = t.gi_cfg.nee
    src_pos = _flat(g, "pos")
    pos = _shifted(g)
    cfg = (nee, shift, "material", 1e-4, False, True, 2.0)
    args = (pos, _flat(g, "normal"), _flat(g, "view"))
    got = tg._shift(t.device_scene, t.bvh, _port_fields(paths),
                    torch.from_numpy(src_pos),
                    *(torch.from_numpy(a) for a in args), mt, cfg, 3)
    with jax.disable_jit():
        want = jg._shift(j.device_scene, j.bvh,
                         {k: jnp.asarray(v) for k, v in paths.items()},
                         jnp.asarray(src_pos),
                         *(jnp.asarray(a) for a in args), mj, cfg, 3)
    hold_fields(got[2], want[2], shift, {"phat": (got[0], want[0]),
                                         "J": (got[1], want[1])},
                ties=0.02)


# ---- restir_gi_pass --------------------------------------------------------

def gi_both(rooms, gb, prev, prev_pos, frame, shift, **cfg):
    t, j, _ = rooms[False]
    kt = t.gi_cfg._replace(shift=shift, **cfg)
    kj = j.gi_cfg._replace(shift=shift, **cfg)
    got = tg.restir_gi_pass(
        t.device_scene, t.bvh, *(torch.from_numpy(gb[k]) for k in GB),
        tg.PathReservoir.from_numpy(prev, CPU), torch.from_numpy(prev_pos),
        frame, kt, gbuf_inst=torch.from_numpy(gb["inst"]),
        prev_inst=torch.from_numpy(gb["inst"]))
    want = jg.restir_gi_pass(
        j.device_scene, j.bvh, *(jnp.asarray(gb[k]) for k in GB),
        jg.PathReservoir(**{k: jnp.asarray(v) for k, v in prev.items()}),
        jnp.asarray(prev_pos), jnp.uint32(frame), kj,
        gbuf_inst=jnp.asarray(gb["inst"]), prev_inst=jnp.asarray(gb["inst"]))
    return got, want


def hold_gi(got, want, what):
    """Path reservoirs and colours by hold_fields' rule, at most
    GI_FLIP_MAX of the pixels off: those whose kept path differs (a
    selection flip) or whose shadow ray flipped."""
    t_res = got[1].to_numpy()
    j_res = tg.PathReservoir.from_numpy(want[1], CPU).to_numpy()
    flat = {k: v.reshape((N * N,) + v.shape[2:]) for k, v in t_res.items()}
    jflat = {k: v.reshape((N * N,) + v.shape[2:]) for k, v in j_res.items()}
    same = (flat["seed"] == jflat["seed"]).all(-1)
    print(f"{what}: kept path differs at {1 - same.mean():.4f} of pixels")
    keys = tg.PathReservoir._fields[:11]
    hold_fields({k: flat[k] for k in keys}, {k: jflat[k] for k in keys},
                what, {k: (flat[k], jflat[k]) for k in
                       ("w_sum", "M", "target_p")} |
                {"color": (got[0].numpy().reshape(-1, 3),
                           np.asarray(want[0]).reshape(-1, 3))},
                ties=GI_FLIP_MAX)


@pytest.fixture(scope="module")
def gi_history(rooms):
    """tauray_tpu's frame-0 path reservoir (numpy) on G-buffer 0 of the
    room without the panel, per shift, from an empty history."""
    t, j, gbs = rooms[False]
    g = gbs[0]
    empty = tg.PathReservoir.empty(N, N, CPU).to_numpy()
    out = {}
    for shift in SHIFTS:
        _, res = jg.restir_gi_pass(
            j.device_scene, j.bvh, *(jnp.asarray(g[k]) for k in GB),
            jg.PathReservoir(**{k: jnp.asarray(v)
                                for k, v in empty.items()}),
            jnp.asarray(g["pos"]), jnp.uint32(0),
            j.gi_cfg._replace(shift=shift),
            gbuf_inst=jnp.asarray(g["inst"]),
            prev_inst=jnp.asarray(g["inst"]))
        out[shift] = tg.PathReservoir.from_numpy(res, CPU).to_numpy()
    return out, g["pos"]


@pytest.mark.parametrize("shift", SHIFTS)
def test_gi_pass_matches_jax(rooms, gi_history, shift):
    """Frame 1 of both packages from tauray_tpu's frame-0 path reservoir:
    canonical paths, temporal and spatial reuse through the shift."""
    hist, prev_pos = gi_history
    gb = rooms[False][2][1]
    got, want = gi_both(rooms, gb, hist[shift], prev_pos, 1, shift)
    hold_gi(got, want, f"gi {shift}")


def test_gi_pass_nonfinite_motion(rooms, gi_history):
    """Temporal reuse of paths where the motion is NaN or infinite."""
    hist, prev_pos = gi_history
    g = dict(rooms[False][2][1])
    motion = g["motion"].copy()
    motion[4:7] = np.nan
    motion[7, :, 0] = np.inf
    motion[8, :, 1] = -np.inf
    g["motion"] = motion
    got, want = gi_both(rooms, g, hist["reconnection-shift"], prev_pos, 1,
                        "reconnection-shift")
    hold_gi(got, want, "gi nonfinite motion")


def test_path_reservoir_numpy_round_trip():
    """to_numpy / from_numpy keep every field; seeds are uint32 in numpy
    and full 32-bit values survive."""
    rng = np.random.default_rng(1)
    f = tg.PathReservoir.empty(4, 5, CPU).to_numpy()
    f = {k: rng.random(v.shape).astype(v.dtype) if v.dtype.kind == "f"
         else v for k, v in f.items()}
    f["seed"] = rng.integers(0, 2 ** 32, (4, 5, 4),
                             dtype=np.uint64).astype(np.uint32)
    f["seed"][0, 0] = [0xFFFFFFFF, 0x80000000, 0, 1]
    back = tg.PathReservoir.from_numpy(f, CPU)
    assert back.seed.dtype == torch.int64
    for k, v in back.to_numpy().items():
        assert v.dtype == f[k].dtype, k
        np.testing.assert_array_equal(v, f[k], err_msg=k)


# ---- the renderer ----------------------------------------------------------

@pytest.mark.parametrize("shift", SHIFTS)
def test_gi_render_matches_jax(shift):
    """Depth 3 (DI + GI), 3 frames with a moving point light, in the room
    without its panel: at least 90% of the pixels within 1e-3 and the
    means within 1%. The selection flips of the passes above carry into
    the next frames through temporal reuse."""
    from test_torch_restir import _slide
    t, j = renderers(_no_panel, max_ray_depth=3,
                     **{"restir.shift-mapping-type": shift})
    hold_images(frames(t, 3, _slide), frames(j, 3, _slide), f"GI {shift}",
                share=0.9, mean_rel=0.01)


# ---- checks on the port ----------------------------------------------------

def _port_frames(s, n, **overrides):
    from tauray_torch.options import Options
    from tauray_torch.renderer.restir_renderer import ReSTIRRenderer
    opt = Options()
    opt.width = opt.height = 16
    opt.tonemap = "linear"
    opt.max_ray_depth = 2
    for k, v in overrides.items():
        if "." in k:
            opt.set(k, str(v))
        else:
            setattr(opt, k, v)
    rr = ReSTIRRenderer(opt, CPU)
    rr.set_scene(s)
    return [rr.render()[0] for _ in range(n)]


def _furnace(glossy=False, L=1.5, albedo=0.6):
    from tauray_torch.scene.environment_map import EnvironmentMap
    from tauray_torch.scene.material import Material
    from test_torch_scene import floor_scene
    s = floor_scene("tauray_torch")
    s.entities[1].light = None
    s.entities[0].model.groups[0].mat = Material(
        albedo_factor=np.array([albedo, albedo, albedo, 1], np.float32),
        metallic_factor=1.0 if glossy else 0.0,
        roughness_factor=0.35 if glossy else 1.0, double_sided=True)
    e = s.add("env")
    e.environment_map = EnvironmentMap(
        image=np.full((8, 16, 3), L, np.float32))
    return s


@pytest.mark.parametrize("shift", SHIFTS)
def test_port_furnace_all_shifts(shift):
    """A constant environment over a Lambertian floor: albedo x L within
    30% for every shift mapping."""
    imgs = _port_frames(_furnace(), 5, max_ray_depth=3,
                        **{"restir.shift-mapping-type": shift})
    img = np.mean(imgs[1:], axis=0)
    got = img[6:10, 6:10, :3].mean()
    assert np.isfinite(img).all()
    assert abs(got - 0.6 * 1.5) / (0.6 * 1.5) < 0.3, (got, shift)


def _port_pt(s, spp=256, depth=2):
    from tauray_torch.options import Options
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer
    opt = Options()
    opt.width = opt.height = 16
    opt.tonemap = "linear"
    opt.max_ray_depth = depth
    opt.samples_per_pixel = spp
    rr = PathTracerRenderer(opt, CPU)
    rr.set_scene(s)
    return rr.render()[0]


@pytest.mark.parametrize("shift", SHIFTS)
def test_port_glossy_matches_pt(shift):
    """A rough-metal floor under a constant environment: ReSTIR's mean
    over the centre within 20% of the port's path tracer."""
    imgs = _port_frames(_furnace(glossy=True, L=1.2, albedo=0.7), 8,
                        **{"restir.shift-mapping-type": shift})
    got = np.mean(imgs[1:], axis=0)[6:10, 6:10, :3].mean()
    want = _port_pt(_furnace(glossy=True, L=1.2, albedo=0.7))[
        6:10, 6:10, :3].mean()
    assert abs(got - want) / want < 0.2, (got, want)


def test_restir_against_pt_mse():
    """The ReSTIR-against-PT image MSE of both packages on the room
    without its panel (depth 3, reconnection shift, the mean of frames
    2-8 against a 256-spp path-traced frame of the same package). Both
    are printed with the image means; they agree within 5% of each other.
    Relative to the path-traced frame's mean square they are 0.22 here
    (tauray_tpu's own error; 7 frames of 1-sample reservoirs at 16x16),
    held below 0.35."""
    from tauray_tpu.options import Options as JOpt
    from tauray_tpu.renderer.rt_renderer import PathTracerRenderer as JPT
    t, j = renderers(_no_panel, max_ray_depth=3)
    got = np.mean(frames(t, 8)[1:], axis=0)
    want = np.mean(frames(j, 8)[1:], axis=0)
    ref_t = _port_pt(_no_panel("tauray_torch"), depth=3)[..., :3]
    opt = JOpt()
    opt.width = opt.height = 16
    opt.tonemap = "linear"
    opt.max_ray_depth = 3
    opt.samples_per_pixel = 256
    jpt = JPT(opt)
    jpt.set_scene(_no_panel("tauray_tpu"))
    ref_j = np.asarray(jpt.render()[0])[..., :3]
    mse_t = float(((got - ref_t) ** 2).mean())
    mse_j = float(((want - ref_j) ** 2).mean())
    ms = float((ref_j ** 2).mean())
    print(f"ReSTIR-against-PT MSE: tauray_torch {mse_t:.6g}, tauray_tpu "
          f"{mse_j:.6g} (path-traced mean square {ms:.6g}; means: ReSTIR "
          f"{got.mean():.6g} / {want.mean():.6g}, PT {ref_t.mean():.6g} / "
          f"{ref_j.mean():.6g})")
    assert abs(mse_t / mse_j - 1) <= 0.05, (mse_t, mse_j)
    assert max(mse_t, mse_j) <= 0.35 * ms, (mse_t, mse_j, ms)
