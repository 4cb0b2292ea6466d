"""ReSTIR DI of tauray_torch (stages/restir.py, renderer/restir_renderer.py)
against tauray_tpu's, on a small room built here in both packages: a
floor, a wall, an emissive panel (triangle lights), a point light, a sun
and an environment map, so every light strategy and occlusion occur; the
camera sees sky in its top rows.

Stage functions run against tauray_tpu's on seeded inputs (tolerances as
tests/test_torch_shading.py states them). restir_di_pass runs in both
packages from the same G-buffer and from tauray_tpu's previous reservoir
(Reservoir.from_numpy). Reservoir selection is a threshold on floats, and
XLA:CPU contracts multiply-adds into FMAs where eager torch does not, so
a candidate within a few ulps of the threshold may be kept in one package
and not in the other. Where the kept sample (strategy, light index, u)
agrees, every integer field is exact and the floats within 1e-3
relative; the share of pixels whose kept sample differs is printed and at
most FLIP_MAX. With one canonical sample and no reuse the selection is
exact (take iff w > 0) and must agree at every pixel.

The port's versions of tests/test_restir.py's analytic checks close the
file."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauray_torch.stages import restir as tr
from tauray_tpu.stages import restir as jr

from test_torch_shading import _close

# the tests run in several worker processes at once: keep torch's
# intra-op pool small so they do not oversubscribe the cores
torch.set_num_threads(2)

CPU = torch.device("cpu")
N = 16
FLIP_MAX = 0.01


def _quat_x(deg):
    h = np.radians(deg) / 2
    return np.array([np.sin(h), 0, 0, np.cos(h)], np.float32)


def room_scene(pkg: str, glossy: bool = False, grid: bool = False,
               panel: bool = True):
    """The test room with `pkg`'s own scene classes. glossy: a rough-metal
    floor. grid: a 2x2x2 SH probe grid over the floor. panel: the
    emissive panel."""
    m = {n: importlib.import_module(f"{pkg}.scene.{n}") for n in (
        "scene", "mesh", "material", "light", "transformable", "camera",
        "environment_map", "sh_grid")}
    s = m["scene"].Scene()
    s.textures = []
    s.texture_meta = []
    T = m["transformable"].Transformable

    def quad(name, verts, albedo, metallic=0.0, roughness=1.0,
             emission=(0.0, 0.0, 0.0)):
        model = m["mesh"].Model()
        model.add_vertex_group(m["material"].Material(
            albedo_factor=np.array(list(albedo) + [1], np.float32),
            metallic_factor=metallic, roughness_factor=roughness,
            emission_factor=np.array(emission, np.float32),
            double_sided=True), m["mesh"].Mesh(
            positions=np.asarray(verts, np.float32),
            indices=np.array([[0, 2, 1], [0, 3, 2]], np.int32)))
        e = s.add(name)
        e.transform = T()
        e.model = model
    quad("floor", [[-20, 0, -20], [20, 0, -20], [20, 0, 20], [-20, 0, 20]],
         (0.7, 0.6, 0.5), metallic=1.0 if glossy else 0.0,
         roughness=0.35 if glossy else 1.0)
    quad("wall", [[1.5, 0, -6], [1.5, 0, 6], [1.5, 3, 6], [1.5, 3, -6]],
         (0.3, 0.8, 0.4), roughness=0.6)
    if panel:
        quad("panel", [[-1, 2.5, -1.5], [0, 2.5, -1.5], [0, 2.5, -0.5],
                       [-1, 2.5, -0.5]], (0, 0, 0), emission=(4.0, 3.0, 2.0))
    le = s.add("sun")
    le.transform = T()
    q = np.array([-np.sin(np.pi / 6), 0.2, 0, np.cos(np.pi / 6)])
    le.transform.set_orientation((q / np.linalg.norm(q)).astype(np.float32))
    le.light = m["light"].DirectionalLight((1.5, 1.4, 1.2), 0.0)
    pe = s.add("bulb")
    pe.transform = T(position=(-0.5, 1.5, 1.0))
    pe.light = m["light"].PointLight((6.0, 5.0, 4.0), radius=0.05)
    rng = np.random.default_rng(3)
    e = s.add("env")
    e.environment_map = m["environment_map"].EnvironmentMap(
        image=(0.2 + rng.random((8, 16, 3))).astype(np.float32))
    ce = s.add("cam")
    ce.transform = T(position=(0, 2, 4))
    ce.transform.set_orientation(_quat_x(-25))
    ce.camera = m["camera"].Camera()
    ce.camera.perspective(60, 1.0, 0.1, 100.0)
    ce.camera_enabled = True
    if grid:
        ge = s.add("probes")
        ge.transform = T(position=(0, 1.5, 0), scaling=(3, 1.5, 3))
        ge.sh_grid = m["sh_grid"].SHGrid(resolution=(2, 2, 2), order=2)
    return s


def renderers(scene_fn=room_scene, hybrid=False, **opts):
    """(port ReSTIRRenderer, tauray_tpu ReSTIRRenderer) on scene_fn's
    scene, 16x16, linear tonemap; opts are Options attributes, or
    dotted option names with dashes."""
    from tauray_torch.options import Options as TOpt
    from tauray_torch.renderer.restir_renderer import ReSTIRRenderer as TR
    from tauray_tpu.options import Options as JOpt
    from tauray_tpu.renderer.restir_renderer import ReSTIRRenderer as JR
    out = []
    for pkg, O, R in (("tauray_torch", TOpt, TR), ("tauray_tpu", JOpt, JR)):
        opt = O()
        opt.width = opt.height = N
        opt.tonemap = "linear"
        for k, v in opts.items():
            if "." in k:
                opt.set(k, str(v))
            else:
                setattr(opt, k, v)
        rr = R(opt, CPU, hybrid=hybrid) if pkg == "tauray_torch" else \
            R(opt, hybrid=hybrid)
        if hybrid and pkg == "tauray_tpu":
            # the single-device bake (conftest's 8 virtual devices would
            # shard it; the sharded bake is bit-identical)
            rr.sh_source.mesh = None
        rr.set_scene(scene_fn(pkg))
        out.append(rr)
    return out


@pytest.fixture(scope="module")
def room():
    """Both renderers (depth 1) and two G-buffers of the port (numpy):
    frame 0, and frame 1 after the camera moved, whose motion points into
    frame 0."""
    from tauray_torch.renderer.restir_renderer import _gbuffer_pass
    from tauray_torch.scene.device import to_camera_uniforms
    t, j = renderers(max_ray_depth=1)
    cams = []
    cam_e = next(e for e in t.scene.entities if e.camera is not None)
    for k in range(2):
        cam_e.transform.set_position((0.06 * k, 2.0, 4.0 - 0.05 * k))
        cams.append(to_camera_uniforms(t.arrays.camera_uniforms(
            t.viewports()), CPU))
    gbufs = [
        {k: v.numpy() for k, v in _gbuffer_pass(
            t.device_scene, t.bvh, cams[f], cams[max(f - 1, 0)], N, N,
            1e-4, False).items()} for f in range(2)]
    return t, j, gbufs


GB = ("pos", "normal", "view", "albedo", "mr", "transmittance", "motion")


def di_both(room, gb, prev, prev_pos, frame, **cfg):
    """restir_di_pass of both packages on one G-buffer from the same
    previous reservoir (numpy fields). Returns ((color, Reservoir) port,
    (color, Reservoir) tauray_tpu)."""
    t, j, _ = room
    kt = t.cfg_key._replace(**cfg)
    kj = j.cfg_key._replace(**cfg)
    got = tr.restir_di_pass(
        t.device_scene, t.bvh, *(torch.from_numpy(gb[k]) for k in GB),
        tr.Reservoir.from_numpy(prev, CPU), torch.from_numpy(prev_pos),
        frame, kt, gbuf_inst=torch.from_numpy(gb["inst"]),
        prev_inst=torch.from_numpy(gb["inst"]))
    want = jr.restir_di_pass(
        j.device_scene, j.bvh, *(jnp.asarray(gb[k]) for k in GB),
        jr.Reservoir(**{k: jnp.asarray(v) for k, v in prev.items()}),
        jnp.asarray(prev_pos), jnp.uint32(frame), kj,
        gbuf_inst=jnp.asarray(gb["inst"]), prev_inst=jnp.asarray(gb["inst"]))
    return got, want


def kept_agrees(t_res: dict, j_res: dict):
    """Pixels whose kept sample (strategy, light index, u) is the same."""
    return ((t_res["strategy"] == j_res["strategy"]) &
            (t_res["light_idx"] == j_res["light_idx"]) &
            (t_res["u"] == j_res["u"]).all(-1))


def emitter_ties(t, pos, res) -> np.ndarray:
    """Pixels whose final visibility ray (run to the light's distance, as
    the reference runs it) is decided within 1e-5 of its length: the
    emitter's own triangle lies at t_max, so one ulp of the distance
    decides whether the light shadows itself. The port's tracer on
    lengths 1e-5 shorter and longer disagree there."""
    _, d, dist, _ = tr._eval_light_sample(
        t.device_scene, t.cfg_key.nee, res.strategy, res.light_idx, res.u,
        pos)
    o, d = pos.reshape(-1, 3), tr._safe_dir(d).reshape(-1, 3)
    dist = torch.clamp(dist.reshape(-1), max=1e30)
    t_min = torch.full_like(dist, 1e-4)
    vis = [t.bvh.trace(o, d, t_min, dist * f, any_hit=True).tri_id < 0
           for f in (1 - 1e-5, 1 + 1e-5)]
    return (vis[0] != vis[1]).reshape(pos.shape[:2]).numpy()


def hold_di(got, want, what, t=None, pos=None, exact_selection=False):
    """Reservoirs: exact where the kept sample agrees (at least 1 -
    FLIP_MAX of the pixels). Colours there within 1e-3 relative, except
    at emitter ties (emitter_ties; their share printed), where the
    packages' visibility may differ."""
    t_res = got[1].to_numpy()
    j_res = tr.Reservoir.from_numpy(want[1], CPU).to_numpy()
    same = kept_agrees(t_res, j_res)
    print(f"{what}: kept sample differs at {1 - same.mean():.4f} of "
          f"pixels")
    if exact_selection:
        assert same.all(), what
    assert 1 - same.mean() <= FLIP_MAX, what
    for k in ("w_sum", "M", "target_p"):
        _close(t_res[k][same], j_res[k][same], f"{what}/{k}", rtol=1e-3,
               atol=1e-5)
    if got[0] is None:
        return
    g, w = got[0].numpy(), np.asarray(want[0])
    ties = emitter_ties(t, pos, got[1])
    off = ~(np.abs(g - w) <= 1e-5 + 1e-3 * np.abs(w)).all(-1) & same
    print(f"{what}: emitter ties at {ties.mean():.4f} of pixels, colour "
          f"off at {off.mean():.4f}")
    assert not (off & ~ties).any(), (what, np.argwhere(off & ~ties))


# ---- stage functions ------------------------------------------------------

def _samples(rng, n, strategy, counts):
    strat = np.full(n, strategy, np.int32)
    strat[rng.random(n) < 0.1] = -1
    # light indices past the table, clipped by both packages
    li = rng.integers(0, counts[strategy] + 2, n).astype(np.int32)
    u = rng.random((n, 2), dtype=np.float32)
    u[:4] = [[0.0, 0.0], [1.0, 1.0], [0.5, 1.0], [1.0, 0.0]]
    pos = np.stack([rng.uniform(-3, 1.4, n), rng.uniform(0.01, 2.4, n),
                    rng.uniform(-3, 3, n)], -1).astype(np.float32)
    return strat, li, u, pos


@pytest.mark.parametrize("strategy", [0, 1, 2, 3])
def test_light_sample_and_target_phat(room, strategy):
    """_eval_light_sample and _target_phat for each light strategy (0
    point, 1 triangle, 2 env, 3 directional) at random points, normals,
    views and materials; tauray_tpu runs op by op."""
    from test_torch_shading import _material, _unit, _view
    from tauray_torch.ops.shading import SampledMaterial as TM
    from tauray_tpu.ops.shading import SampledMaterial as JM
    t, j, _ = room
    sc = t.device_scene
    counts = [sc.point_light_count, sc.tri_light_count, 1,
              sc.directional_light_count]
    rng = np.random.default_rng(40 + strategy)
    n = 4096
    strat, li, u, pos = _samples(rng, n, strategy, counts)
    nee = t.cfg_key.nee
    got = tr._eval_light_sample(sc, nee, *(torch.from_numpy(x) for x in (
        strat, li, u, pos)))
    want = jr._eval_light_sample(j.device_scene, nee, *(jnp.asarray(x)
                                 for x in (strat, li, u, pos)))
    _close(got, want, f"eval/{strategy}", rtol=1e-4, atol=1e-5)
    normal, view = _unit(rng, n), -_view(rng)
    mats = [_material(np.random.default_rng(strategy), m, lib, n=n)
            for m, lib in ((TM, torch.from_numpy), (JM, jnp.asarray))]
    mats = [m._replace(transmittance=m.transmittance * 0) for m in mats]
    for mode in ("material", "cosine"):
        got = tr._target_phat(sc, nee, *(torch.from_numpy(x) for x in (
            strat, li, u, pos, normal, view)), mats[0], mode)
        want = jr._target_phat(j.device_scene, nee, *(
            jnp.asarray(x) for x in (strat, li, u, pos, normal, view)),
            mats[1], mode)
        _close(got, want, f"phat/{strategy}/{mode}", rtol=1e-4, atol=1e-5)


def test_merge_is_exact():
    """_merge on random reservoirs, candidates with zero and tied weights:
    every field identical."""
    rng = np.random.default_rng(5)
    H = W = 32

    def res():
        return dict(strategy=rng.integers(-1, 4, (H, W)).astype(np.int32),
                    light_idx=rng.integers(0, 9, (H, W)).astype(np.int32),
                    u=rng.random((H, W, 2), dtype=np.float32),
                    w_sum=rng.random((H, W), dtype=np.float32),
                    M=rng.integers(0, 20, (H, W)).astype(np.float32),
                    target_p=rng.random((H, W), dtype=np.float32))
    r, c = res(), res()
    w = rng.random((H, W), dtype=np.float32)
    w[rng.random((H, W)) < 0.2] = 0.0
    rand = rng.random((H, W), dtype=np.float32)
    rand[:4] = 0.0
    cand = (c["strategy"], c["light_idx"], c["u"], c["target_p"], w, c["M"],
            rand)
    got = tr._merge(tr.Reservoir.from_numpy(r, CPU),
                    *(torch.from_numpy(x) for x in cand))
    want = jr._merge(jr.Reservoir(**{k: jnp.asarray(v)
                                     for k, v in r.items()}),
                     *(jnp.asarray(x) for x in cand))
    w_t = got.to_numpy()
    for k, v in tr.Reservoir.from_numpy(want, CPU).to_numpy().items():
        np.testing.assert_array_equal(w_t[k], v, err_msg=k)
    np.testing.assert_array_equal(got.W.numpy(), np.asarray(want.W))


def test_reprojection_offsets_and_light_index():
    """The float -> int32 conversions of the reuse passes, as XLA
    converts: temporal indices of non-finite motion (index 0 for NaN, the
    clamped edge for +-inf), spatial disk offsets, light indices (u = 1
    clipped to the last light)."""
    H, W = 12, 20
    rng = np.random.default_rng(9)
    motion = rng.uniform(-0.3, 1.3, (H, W, 2)).astype(np.float32)
    motion[0, :5] = np.nan
    motion[1, :3, 0] = np.inf
    motion[2, :3, 1] = -np.inf
    motion[3, :2] = [np.nan, np.inf]
    px, py = tr.reproject(torch.from_numpy(motion), H, W)
    mx = jnp.clip(jnp.asarray(motion[..., 0]) * W - 0.5, 0, W - 1)
    my = jnp.clip((1 - jnp.asarray(motion[..., 1])) * H - 0.5, 0, H - 1)
    np.testing.assert_array_equal(px.numpy(),
                                  np.asarray(jnp.round(mx).astype(jnp.int32)))
    np.testing.assert_array_equal(py.numpy(),
                                  np.asarray(jnp.round(my).astype(jnp.int32)))
    assert (px.numpy()[0, :5] == 0).all() and (py.numpy()[0, :5] == 0).all()

    r = rng.random((H * W, 2), dtype=np.float32)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    nx, ny = tr.disk_neighbour(torch.from_numpy(r), torch.from_numpy(xs),
                               torch.from_numpy(ys), H, W, 32.0)
    ang = jnp.asarray(r[:, 0]).reshape(H, W) * (2 * np.pi)
    rad = jnp.sqrt(jnp.asarray(r[:, 1]).reshape(H, W)) * 32.0
    jx = jnp.clip(xs + jnp.round(jnp.cos(ang) * rad).astype(jnp.int32),
                  0, W - 1)
    jy = jnp.clip(ys + jnp.round(jnp.sin(ang) * rad).astype(jnp.int32),
                  0, H - 1)
    # cos/sin of the two libraries differ by an ulp at most: a rounding
    # boundary may move one offset by one pixel, nowhere here
    np.testing.assert_array_equal(nx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ny.numpy(), np.asarray(jy))


def test_light_pick_matches_jax(room):
    """Strategy and light index of the canonical candidates: pick_light
    against tauray_tpu's inline selection, u = 1 included."""
    t, _, _ = room
    sc, nee = t.device_scene, t.cfg_key.nee
    rng = np.random.default_rng(2)
    rnd = rng.random((4096, 2), dtype=np.float32)
    rnd[:3] = [[1.0, 1.0], [0.0, 1.0], [0.99999994, 0.25000250]]
    strat, lidx = tr.pick_light(sc, nee, torch.from_numpy(rnd[:, 1]),
                                torch.from_numpy(rnd[:, 0]))
    weights = jnp.array([nee.point, nee.triangle, nee.envmap,
                         nee.directional], jnp.float32)
    cum = jnp.cumsum(weights)
    uw = jnp.asarray(rnd[:, 1])
    js = jnp.full(uw.shape, -1, jnp.int32)
    for si in range(4):
        js = jnp.where((weights[si] > 0) & (uw >= cum[si] - weights[si]) &
                       (uw < cum[si]), si, js)
    counts = jnp.array([max(sc.point_light_count, 1),
                        max(sc.tri_light_count, 1), 1,
                        max(sc.directional_light_count, 1)])
    nl = counts[jnp.maximum(js, 0)]
    jl = jnp.clip((jnp.asarray(rnd[:, 0]) * nl).astype(jnp.int32), 0,
                  nl - 1)
    np.testing.assert_array_equal(strat.numpy(), np.asarray(js))
    np.testing.assert_array_equal(lidx.numpy(), np.asarray(jl))


# ---- restir_di_pass ------------------------------------------------------

@pytest.fixture(scope="module")
def di_history(room):
    """tauray_tpu's frame-0 reservoir (numpy) on G-buffer 0, from an empty
    history, and its G-buffer."""
    _, j, gbufs = room
    g = gbufs[0]
    empty = tr.Reservoir.empty(N, N, CPU).to_numpy()
    _, res = jr.restir_di_pass(
        j.device_scene, j.bvh, *(jnp.asarray(g[k]) for k in GB),
        jr.Reservoir(**{k: jnp.asarray(v) for k, v in empty.items()}),
        jnp.asarray(g["pos"]), jnp.uint32(0), j.cfg_key,
        gbuf_inst=jnp.asarray(g["inst"]), prev_inst=jnp.asarray(g["inst"]))
    return tr.Reservoir.from_numpy(res, CPU).to_numpy(), g["pos"]


@pytest.mark.parametrize("canonical,temporal,passes", [
    (1, False, 0), (1, True, 0), (1, False, 1), (2, True, 1)])
def test_di_pass_matches_jax(room, di_history, canonical, temporal, passes):
    """Frame 1 of both packages from tauray_tpu's frame-0 reservoir, with
    the temporal visibility trace on."""
    _, _, gbufs = room
    prev, prev_pos = di_history
    got, want = di_both(room, gbufs[1], prev, prev_pos, 1,
                        canonical_samples=canonical, temporal=temporal,
                        passes=passes, temporal_visibility=True)
    t = room[0]
    hold_di(got, want, f"di c{canonical} t{int(temporal)} p{passes}", t,
            torch.from_numpy(gbufs[1]["pos"]),
            exact_selection=(canonical == 1 and not temporal and
                             passes == 0))


def test_di_pass_nonfinite_motion(room, di_history):
    """Temporal reuse where the motion is NaN or infinite: those pixels
    read the previous reservoir at XLA's indices (NaN -> 0)."""
    _, _, gbufs = room
    prev, prev_pos = di_history
    g = dict(gbufs[1])
    motion = g["motion"].copy()
    motion[5:8] = np.nan
    motion[8, :, 0] = np.inf
    motion[9, :, 1] = -np.inf
    g["motion"] = motion
    got, want = di_both(room, g, prev, prev_pos, 1, passes=0)
    hold_di(got, want, "di nonfinite motion", room[0],
            torch.from_numpy(g["pos"]))


# ---- the renderer ----------------------------------------------------------

def frames(rr, n, move=None, ties=False):
    """n frames (RGB, numpy), update_frame before each after the first;
    move(rr, k) changes the scene before frame k. ties: also the emitter
    ties of each frame's final DI reservoir (the port's renderer only)."""
    imgs, tie = [], []
    for k in range(n):
        if move is not None:
            move(rr, k)
        if k:
            rr.update_frame()
        imgs.append(np.asarray(rr.render()[0][..., :3]))
        if ties:
            tie.append(emitter_ties(rr, rr.prev_pos, rr.prev_res))
    return (imgs, tie) if ties else imgs


def hold_images(got, want, what, ties=None, share=0.99, mean_rel=1e-3):
    """Per frame: the share of pixels within 1e-3 relative (+1e-5) outside
    the emitter ties, and the image means."""
    for k, (g, w) in enumerate(zip(got, want)):
        ok = (np.abs(g - w) <= 1e-5 + 1e-3 * np.abs(w)).all(-1)
        tie = np.zeros(ok.shape, bool) if ties is None else ties[k]
        rel = abs(float(g.mean()) / float(w.mean()) - 1)
        print(f"{what} frame {k}: {ok[~tie].mean():.4f} of pixels within "
              f"1e-3 outside {tie.mean():.4f} emitter ties, mean "
              f"{g.mean():.6f} vs {w.mean():.6f} (rel {rel:.2e})")
        assert np.isfinite(g).all(), what
        assert ok[~tie].mean() >= share, (what, k, ok[~tie].mean())
        assert rel <= mean_rel, (what, k, rel)


def _slide(rr, k):
    """Moves the point light a little every frame."""
    e = next(e for e in rr.scene.entities if e.name == "bulb")
    e.transform.set_position((-0.5 + 0.1 * k, 1.5, 1.0))


def _no_panel(pkg):
    return room_scene(pkg, panel=False)


@pytest.mark.parametrize("denoiser", ["none", "svgf"])
def test_di_render_matches_jax(denoiser):
    """Depth 1 (DI only), 3 frames with a moving point light, with and
    without SVGF (whose input is the DI colour against a white albedo),
    in the room without its emissive panel: no emitter ties."""
    t, j = renderers(_no_panel, max_ray_depth=1, denoiser=denoiser)
    hold_images(frames(t, 3, _slide), frames(j, 3, _slide),
                f"DI {denoiser}")
    assert 1 - kept_agrees(t.prev_res.to_numpy(), tr.Reservoir.from_numpy(
        j.prev_res, CPU).to_numpy()).mean() <= FLIP_MAX


def test_di_render_emitter_ties():
    """The room with its emissive panel: outside the emitter ties the
    frames agree as above; the ties move the image mean by up to 2%."""
    t, j = renderers(max_ray_depth=1)
    got, ties = frames(t, 3, _slide, ties=True)
    hold_images(got, frames(j, 3, _slide), "DI panel", ties, mean_rel=0.02)


# ---- analytic checks on the port (tests/test_restir.py's) ---------------

def _port_render(s, frames, **overrides):
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
    return rr, [rr.render()[0] for _ in range(frames)]


def _bulb_floor(x=2.0, L=50.0, h=4.0, albedo=0.8):
    from tauray_torch.scene.light import PointLight
    from tauray_torch.scene.transformable import Transformable
    from test_torch_scene import floor_scene
    s = floor_scene("tauray_torch")
    s.entities[0].model.groups[0].mat.albedo_factor[:3] = albedo
    s.entities[1].light = None
    pe = s.add("bulb")
    pe.transform = Transformable(position=(x, h, 0))
    pe.light = PointLight((L, L, L), radius=0.05)
    return s, pe


def _analytic(lx, L=50.0, h=4.0, albedo=0.8):
    d2 = lx * lx + h * h
    return L * (h / np.sqrt(d2)) / d2 * albedo / np.pi


def test_port_di_point_light():
    """A point light over a Lambertian floor: the DI value within 25%."""
    s, _ = _bulb_floor()
    _, imgs = _port_render(s, 6, max_ray_depth=1)
    got = np.mean(imgs[1:], axis=0)[7:9, 7:9, :3].mean()
    want = _analytic(2.0)
    assert abs(got - want) / want < 0.25, (got, want)


def test_port_moving_light():
    """The light moves every frame; temporal reservoirs reference stale
    positions and are evaluated again at the current one: within 30% of
    the analytic value at the final position."""
    s, pe = _bulb_floor(x=3.0)
    from tauray_torch.options import Options
    from tauray_torch.renderer.restir_renderer import ReSTIRRenderer
    opt = Options()
    opt.width = opt.height = 16
    opt.tonemap = "linear"
    opt.max_ray_depth = 1
    rr = ReSTIRRenderer(opt, CPU)
    rr.set_scene(s)
    xs = np.linspace(3.0, 1.0, 8)
    for x in xs:
        pe.transform.set_position((float(x), 4.0, 0.0))
        rr.update_frame()
        img = rr.render()[0]
    got = img[7:9, 7:9, :3].mean()
    want = _analytic(float(xs[-1]))
    assert abs(got - want) / want < 0.3, (got, want)


def test_port_moving_camera():
    """A moving camera against a static one: converged means within
    25%."""
    from tauray_torch.options import Options
    from tauray_torch.renderer.restir_renderer import ReSTIRRenderer

    def run(move):
        s, _ = _bulb_floor()
        opt = Options()
        opt.width = opt.height = 16
        opt.tonemap = "linear"
        opt.max_ray_depth = 1
        rr = ReSTIRRenderer(opt, CPU)
        rr.set_scene(s)
        cam_e = next(e for e in s.entities if e.camera is not None)
        base = np.asarray(cam_e.transform.position, np.float32).copy()
        acc = []
        for i in range(8):
            if move:
                cam_e.transform.set_position(
                    (float(base[0] + 0.03 * i), float(base[1]),
                     float(base[2])))
            rr.update_frame()
            acc.append(rr.render()[0])
        return np.mean(acc[4:], axis=0)[4:12, 4:12, :3].mean()
    moving, static = run(True), run(False)
    assert abs(moving - static) / static < 0.25, (moving, static)


@pytest.mark.parametrize("renderer,depth,shift,waves", [
    ("path-tracer", 3, None, 5),
    ("restir", 1, "reconnection-shift", 3),
    ("restir", 3, "reconnection-shift", 8),
    ("restir", 3, "random-replay-shift", 20)])
def test_traced_waves_per_frame(renderer, depth, shift, waves):
    """The tracer's own count of waves and rays (ops/cluster.TRACED, the
    bench's lanes) over one frame on the room, which has no alpha: the
    path tracer's 2 x depth - 1 waves of padded pixels x spp; ReSTIR's
    G-buffer 1 + DI 2 + GI 2 x depth - 2 + GI final 1 waves of H x W
    rays, and 3 x (2 x depth - 2) more where random replay regenerates
    the path for temporal reuse and for each of the 2 spatial samples
    (depth 1 traces no GI)."""
    from tauray_torch.app.main import create_renderer
    from tauray_torch.ops import cluster
    from tauray_torch.options import Options
    opt = Options()
    opt.width = opt.height = N
    opt.renderer = renderer
    opt.max_ray_depth = depth
    opt.samples_per_pixel = opt.samples_per_pass = 2
    if shift:
        opt.set("restir.shift-mapping-type", shift)
    s = room_scene("tauray_torch")
    rr = create_renderer(opt, s, CPU)
    rr.set_scene(s)
    rr.render_device()
    rr.update_frame()
    cluster.reset_traced()
    rr.render_device()
    lanes = rr._pix.shape[0] * 2 if renderer == "path-tracer" else N * N
    assert cluster.TRACED == {"waves": waves, "rays": waves * lanes}
