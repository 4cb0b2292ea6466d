"""The on-device per-frame scene update of tauray_torch
(scene/device_update.py, Renderer.device_update_frame) against
tauray_tpu's and against the port's host path (SceneArrays.update), on a
scene built here: a floor with a keyframed translation carrying an
emissive panel (moving triangle lights), and two skinned two-joint
strips (two skinned entities, so the joint table's per-entity
offsets matter), seen by a camera that also sees sky. Geometry agrees
within 1e-4 of the scene's scale (tests/test_device_update.py's
criterion)."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from tauray_torch.scene import device_update as tdu
from tauray_tpu.scene import device_update as jdu

# the tests run in several worker processes at once: keep torch's
# intra-op pool small so they do not oversubscribe the cores
torch.set_num_threads(2)

CPU = torch.device("cpu")
FRAME_DT = (250000, 250000)      # microseconds between animated frames


def _quat_x(deg):
    h = np.radians(deg) / 2
    return np.array([np.sin(h), 0, 0, np.cos(h)], np.float32)


def anim_scene(pkg: str, pitch: float = -8.0):
    """The animated test scene, built with `pkg`'s own scene classes. The
    camera looks down by `pitch` degrees: at the default the top rows see
    sky, at -35 none do."""
    m = {n: importlib.import_module(f"{pkg}.scene.{n}") for n in (
        "scene", "mesh", "material", "light", "transformable", "camera",
        "animation")}
    T = m["transformable"].Transformable
    s = m["scene"].Scene()
    s.textures = []
    s.texture_meta = []

    def mat(albedo, metallic=0.0, roughness=1.0):
        return m["material"].Material(
            albedo_factor=np.array(albedo + [1], np.float32),
            metallic_factor=metallic, roughness_factor=roughness,
            double_sided=True)

    # floor, sliding on a keyframed translation
    verts = np.array([[-20, 0, -20], [20, 0, -20], [20, 0, 20],
                      [-20, 0, 20]], np.float32)
    floor = m["mesh"].Model()
    floor.add_vertex_group(mat([0.8, 0.7, 0.6]), m["mesh"].Mesh(
        positions=verts, indices=np.array([[0, 2, 1], [0, 3, 2]])))
    e = s.add("floor")
    e.transform = T()
    e.model = floor
    a = m["animation"].Animation()
    a.add_channel("translation", m["animation"].AnimationChannel(
        times=np.array([0.0, 1.0], np.float32),
        values=np.array([[0, 0, 0], [0.3, 0, -0.2]], np.float32)))
    e.animations = {"slide": a}
    # an emissive panel riding on the floor: its triangle lights move
    panel = m["mesh"].Model()
    panel.add_vertex_group(
        m["material"].Material(
            albedo_factor=np.array([0, 0, 0, 1], np.float32),
            emission_factor=np.array([4.0, 3.0, 2.0], np.float32),
            double_sided=True, metallic_factor=0.0),
        m["mesh"].Mesh(positions=np.array(
            [[-0.5, 1.5, -1], [0.5, 1.5, -1], [0.5, 2.2, -1],
             [-0.5, 2.2, -1]], np.float32),
            indices=np.array([[0, 1, 2], [0, 2, 3]])))
    pe = s.add("panel")
    pe.transform = T(parent=e.transform)
    pe.model = panel

    # two skinned strips, each bent by its own two joints
    for k, x0 in enumerate((-1.6, 0.6)):
        xs = np.array([0.0, 0.5, 1.0], np.float32) + x0
        pos = np.array([[x, y, 1.0] for y in (0.1, 1.1) for x in xs],
                       np.float32)
        idx = np.array([[0, 1, 4], [0, 4, 3], [1, 2, 5], [1, 5, 4]])
        w = {0: [1, 0], 1: [0.5, 0.5], 2: [0, 1]}
        weights = np.array([w[i % 3] + [0, 0] for i in range(6)], np.float32)
        joints = np.tile(np.array([0, 1, 0, 0], np.int32), (6, 1))
        model = m["mesh"].Model()
        model.add_vertex_group(
            mat([0.3, 0.5, 0.9] if k else [0.9, 0.4, 0.2], metallic=0.5,
                roughness=0.4),
            m["mesh"].Mesh(positions=pos, indices=idx, joints=joints,
                           weights=weights))
        jts = []
        for j, jx in enumerate((xs[0], xs[2])):
            je = s.add(f"strip{k}_joint{j}")
            je.transform = T(position=(jx, 0.1, 1.0))
            jts.append(je)
        model.joint_nodes = [je.transform for je in jts]
        model.inverse_bind_matrices = np.stack([
            np.linalg.inv(je.transform.get_global_transform())
            for je in jts]).astype(np.float32)
        bend = m["animation"].Animation()
        q = _quat_x(35.0 if k else -25.0)
        bend.add_channel("rotation", m["animation"].AnimationChannel(
            times=np.array([0.0, 1.0], np.float32),
            values=np.array([[0, 0, 0, 1], q], np.float32)))
        jts[1].animations = {"bend": bend}
        se = s.add(f"strip{k}")
        # the strip's own transform cancels out of skinned positions
        se.transform = T(position=(0.2 * k, 0.3, -0.1))
        se.model = model

    sun = s.add("sun")
    sun.transform = T()
    sun.transform.set_orientation(_quat_x(-60.0))
    sun.light = m["light"].DirectionalLight((2.0, 2.0, 2.0), 0.0)
    bulb = s.add("bulb")
    bulb.transform = T(position=(0.5, 2.0, 2.5))
    bulb.light = m["light"].PointLight((3.0, 3.0, 3.0), radius=0.05)
    ce = s.add("cam")
    ce.transform = T(position=(0, 1.2, 4.0))
    ce.transform.set_orientation(_quat_x(pitch))
    ce.camera = m["camera"].Camera()
    ce.camera.perspective(60, 1.0, 0.1, 100.0)
    ce.camera_enabled = True
    m["animation"].play(s, "", False)
    return s


def advance(pkg: str, scene, dt: int):
    importlib.import_module(f"{pkg}.scene.animation").update(scene, dt, True)


def scene_pair():
    from tauray_torch.options import Options as TOptions
    from tauray_torch.scene.arrays import SceneArrays as TSA
    from tauray_tpu.options import Options as JOptions
    from tauray_tpu.scene.arrays import SceneArrays as JSA
    js, ts = anim_scene("tauray_tpu"), anim_scene("tauray_torch")
    return (js, JSA(js, JOptions())), (ts, TSA(ts, TOptions()))


def _close(got, want, what):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    d = np.abs(got - want).max() if got.size else 0.0
    scale = np.abs(want).max() + 1.0
    assert d / scale < 1e-4, (what, d)


def test_geom_static_matches_jax():
    """The static tables are the same numpy arrays in both packages; the
    second strip's corners index joints 2 and 3 of the joint table."""
    (_, jsa), (_, tsa) = scene_pair()
    jgs, jskin = jdu.build_geom_static(jsa)
    tgs, tskin = tdu.build_geom_static(tsa, CPU)
    assert jskin and tskin
    for name in tdu.GeomStatic._fields:
        np.testing.assert_array_equal(getattr(tgs, name).numpy(),
                                      np.asarray(getattr(jgs, name)), name)
    cj = tgs.corner_joint.numpy()
    w = tgs.corner_weight.numpy()
    skinned = w.sum(-1) > 0
    assert skinned.sum() == 8 * 3
    assert set(np.unique(cj[skinned][w[skinned] > 0])) == {0, 1, 2, 3}
    # from numpy: tauray_tpu's arrays give the same tables
    back = tdu.geom_static_from_numpy(
        {k: np.asarray(getattr(jgs, k)) for k in jdu.GeomStatic._fields},
        CPU)
    for name in tdu.GeomStatic._fields:
        assert torch.equal(getattr(back, name), getattr(tgs, name)), name


def test_update_geometry_matches_jax_and_host():
    """Two animated frames: the port's update_geometry against
    tauray_tpu's (the same host inputs) and against the port's host
    SceneArrays.update, within 1e-4 of scale."""
    import jax.numpy as jnp
    (js, jsa), (ts, tsa) = scene_pair()
    jgs, skin = jdu.build_geom_static(jsa)
    tgs, _ = tdu.build_geom_static(tsa, CPU)
    moved = 0.0
    for dt in FRAME_DT:
        advance("tauray_tpu", js, dt)
        advance("tauray_torch", ts, dt)
        jin = jdu.host_frame_inputs(jsa)
        tin = tdu.host_frame_inputs(tsa)
        for a, b in zip(tin, jin):
            np.testing.assert_array_equal(a, b)
        jg = jdu.update_geometry(jgs, *(jnp.asarray(x) for x in jin), skin)
        tg = tdu.update_geometry(tgs, *(torch.from_numpy(x) for x in tin),
                                 skin)
        before = tsa.tri_pos.copy()
        tsa.update(keep_prev=True)
        moved = max(moved, float(np.abs(tsa.tri_pos - before).max()))
        for name in tdu.GeomFrame._fields:
            _close(getattr(tg, name), getattr(jg, name), f"jax {name}")
            _close(getattr(tg, name), getattr(tsa, name), f"host {name}")
    assert moved > 0.05, moved


def test_pack_and_apply_frame_update_match_jax():
    """pack_frame's tri_packed (original triangle order) and tl_packed,
    and every field apply_frame_update replaces, against tauray_tpu's,
    over two frames (the second with a previous frame)."""
    import jax.numpy as jnp
    from tauray_torch.scene.device import to_device_scene as tds
    from tauray_tpu.scene.device import to_device_scene as jds
    (js, jsa), (ts, tsa) = scene_pair()
    jscene, tscene = jds(jsa), tds(tsa, device=CPU)
    jgs, skin = jdu.build_geom_static(jsa)
    tgs, _ = tdu.build_geom_static(tsa, CPU)
    jprev = tprev = None
    for dt in FRAME_DT:
        advance("tauray_tpu", js, dt)
        advance("tauray_torch", ts, dt)
        jsa._update_lights()
        tsa._update_lights()
        jin = jdu.host_frame_inputs(jsa)
        tin = tdu.host_frame_inputs(tsa)
        jg = jdu.update_geometry(jgs, *(jnp.asarray(x) for x in jin), skin)
        tg = tdu.update_geometry(tgs, *(torch.from_numpy(x) for x in tin),
                                 skin)
        pp = tg.tri_pos if tprev is None else tprev.tri_pos
        for got, want in zip(
                tdu.pack_frame(tgs, tg, pp, tscene.inst_packed),
                jdu.pack_frame(jgs, jg, jg.tri_pos if jprev is None
                               else jprev.tri_pos, jscene.inst_packed)):
            _close(got, want, "pack_frame")
        jscene = jdu.apply_frame_update(jscene, jgs, jg, jprev, jsa)
        tscene = tdu.apply_frame_update(tscene, tgs, tg, tprev, tsa)
        for name in ("tri_pos", "tri_normal", "tri_tangent",
                     "tri_hard_normal", "tri_pos_prev", "tri_packed",
                     "tl_packed", "tl_pos", "pl_packed", "dl_packed",
                     "pl_color", "pl_pos", "pl_dir", "dl_color", "dl_dir"):
            _close(getattr(tscene, name), getattr(jscene, name), name)
        jprev, tprev = jg, tg


def _opt(cls, **kw):
    opt = cls()
    opt.width = opt.height = 16
    opt.samples_per_pixel = 2
    opt.max_ray_depth = 3
    opt.tonemap = "linear"
    for k, v in kw.items():
        setattr(opt, k, v)
    return opt


def test_device_update_frame_matches_host_update_frame():
    """PathTracerRenderer.update_frame goes through device_update_frame;
    the scene and tracer it leaves agree with host_update_frame's. On the
    first update the device path's previous positions are the current
    ones (tauray_tpu's rule), the host path's the frame before; from the
    second update on they agree too."""
    from tauray_torch.options import Options
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer
    sides = []
    for _ in range(2):
        s = anim_scene("tauray_torch")
        rr = PathTracerRenderer(_opt(Options), CPU)
        rr.set_scene(s)
        sides.append((s, rr))
    (sd, dev), (sh, host) = sides
    for k, dt in enumerate(FRAME_DT):
        advance("tauray_torch", sd, dt)
        advance("tauray_torch", sh, dt)
        dev.update_frame()
        host.bvh = host.host_update_frame(host.bvh, host._perm)
        names = ["tri_pos", "tri_normal", "tri_tangent", "tri_hard_normal",
                 "tl_pos", "tl_packed"]
        if k:
            names += ["tri_pos_prev", "tri_packed"]
        for name in names:
            _close(getattr(dev.device_scene, name),
                   getattr(host.device_scene, name), name)
        for name in ("cmin", "cmax", "v0", "e1", "e2"):
            _close(getattr(dev.bvh, name), getattr(host.bvh, name), name)


def test_animated_frames_match_jax():
    """Two animated 16x16 frames (2 spp, depth 3) through both packages'
    PathTracerRenderer and update_frame, by test_sponza_image_matches_jax's
    criterion: >= 99% of pixels within 1e-3 relative, image mean within
    0.1%."""
    from tauray_torch.options import Options as TOptions
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer as TPT
    from tauray_tpu.options import Options as JOptions
    from tauray_tpu.renderer.rt_renderer import PathTracerRenderer as JPT
    js, ts = anim_scene("tauray_tpu"), anim_scene("tauray_torch")
    jr, tr = JPT(_opt(JOptions)), TPT(_opt(TOptions), CPU)
    jr.set_scene(js)
    tr.set_scene(ts)
    for k in range(2):
        if k:
            advance("tauray_tpu", js, FRAME_DT[0])
            advance("tauray_torch", ts, FRAME_DT[0])
            jr.update_frame()
            tr.update_frame()
        jr.reset_accumulation()
        tr.reset_accumulation()
        want = jr.render()[0][..., :3]
        got = tr.render()[0][..., :3]
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
        within = float((rel.max(axis=-1) <= 1e-3).mean())
        mean_rel = abs(float(got.mean()) / float(want.mean()) - 1.0)
        print(f"frame {k}: within {within:.4f}, mean rel {mean_rel:.2e}")
        assert np.isfinite(got).all() and got.mean() > 0
        assert within >= 0.99
        assert mean_rel <= 1e-3


def test_count_rays_matches_jax():
    """PTConfig.count_rays: the port's useful-ray count of a frame equals
    tauray_tpu's exactly (alive bounce lanes plus shadow lanes of nonzero
    length), on a scene with sky, so lanes die."""
    from tauray_torch.options import Options as TOptions
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer as TPT
    from tauray_tpu.options import Options as JOptions
    from tauray_tpu.renderer.rt_renderer import PathTracerRenderer as JPT
    jr = JPT(_opt(JOptions, max_ray_depth=4))
    tr = TPT(_opt(TOptions, max_ray_depth=4), CPU)
    jr.set_scene(anim_scene("tauray_tpu"))
    tr.set_scene(anim_scene("tauray_torch"))
    jr.cfg = dataclasses.replace(jr.cfg, count_rays=True)
    tr.cfg = dataclasses.replace(tr.cfg, count_rays=True)
    jr.render_device()
    tr.render_device()
    want = int(np.asarray(jr.last_useful_rays))
    got = int(tr.last_useful_rays)
    lanes = 16 * 16 * 2 * (2 * 4 - 1)
    print(f"useful rays {got} of {lanes} lanes")
    assert got == want
    assert 0 < got < lanes


@pytest.mark.parametrize("strategy", ["per-model", "all-merged-static"])
def test_device_update_refits_each_tracer(strategy):
    """device_update_frame refits the tracer the strategy built: the
    instanced tracer from the new instance transforms (a scene of shared
    meshes, the floor moving), the flat one from the new positions; both
    match the host path's refit."""
    from tauray_torch.ops.cluster import InstancedClusterTracer
    from tauray_torch.options import Options
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer
    from tauray_torch.scene.mesh import Model

    def scene():
        s = anim_scene("tauray_torch")
        # a second floor entity sharing the first's mesh; no skinning
        s.entities = [e for e in s.entities
                      if not e.name.startswith("strip")]
        floor = s.entities[0]
        twin = s.add("floor_twin")
        twin.transform = type(floor.transform)(position=(0, -0.5, -30))
        twin.model = Model(list(floor.model.groups))
        return s
    sides = []
    for _ in range(2):
        s = scene()
        rr = PathTracerRenderer(_opt(Options, as_strategy=strategy), CPU)
        rr.set_scene(s)
        sides.append((s, rr))
    (sd, dev), (sh, host) = sides
    assert isinstance(dev.bvh, InstancedClusterTracer) == \
        (strategy == "per-model")
    advance("tauray_torch", sd, FRAME_DT[0])
    advance("tauray_torch", sh, FRAME_DT[0])
    before = torch.cat([dev.bvh.cmin, dev.bvh.cmax])
    dev.update_frame()
    assert dev._geom_static.corner_joint.shape == (0, 3, 4)   # no skin
    host.bvh = host.host_update_frame(host.bvh, host._perm)
    assert not torch.equal(before, torch.cat([dev.bvh.cmin, dev.bvh.cmax]))
    for name in ("cmin", "cmax"):
        _close(getattr(dev.bvh, name), getattr(host.bvh, name), name)
    _close(dev.render(), host.render(), "image")
