"""The instanced (TLAS) tracer of tauray_torch against tauray_tpu's, on the
CPU: the build (--as-strategy=per-model's cluster-instance list), the
per-frame refit, traces through the whole path (entry-t phase 1, the
plain K3, the object-space barycentric post-pass) and a per-model image.

  * the build is the same numpy code: k_cluster, k_inst, to_orig, opaque,
    alpha_base, the object blocks and AABBs and tris9 are EQUAL;
  * the refit's inverses and world AABBs agree within INV_TOL / AABB_TOL:
    both take float32 LU inverses, but LAPACK (torch) and XLA:CPU order
    and fuse the elimination differently, so the inverses differ by a few
    ulps of their largest entries, and the AABB corners (products summed
    in float32) by a few ulps of the scene's coordinates;
  * traces agree with tauray_tpu's InstancedClusterTracer.trace on the
    CPU (its XLA traversal): closest-hit ids equal except at exact-t ties
    (the XLA traversal walks clusters by id, the kernel front to back),
    any-hit rays hit or miss alike.
"""

import numpy as np
import pytest
import torch

from tauray_torch.ops import cluster as tcl
from tauray_tpu.ops import cluster as jcl

from test_instancing import _mesh, _transforms
from test_torch_cluster import T_ATOL, T_RTOL, _assert_ids_match_up_to_ties

# the tests run in several worker processes at once: keep torch's
# intra-op pool small so they do not oversubscribe the cores
torch.set_num_threads(2)

CPU = torch.device("cpu")
SPONZA = "proc://sponza?tris=8192"
# relative to the largest entry of each 3x4 inverse / to the scene extent
INV_TOL = 1e-5
AABB_TOL = 1e-5
EXACT = ("k_cluster", "k_inst", "to_orig", "opaque", "v0", "e1", "e2",
         "tri_valid", "obj_min", "obj_max", "tris9")


def _instancing_scene():
    """tests/test_instancing.py's scene: 100 instances of one 600-triangle
    mesh; every fifth instance is alpha-capable."""
    mesh = _mesh(600)
    models = _transforms(100)
    opaque = np.arange(100) % 5 != 2
    args = ([mesh], np.zeros(100, np.int64), models, opaque,
            np.arange(100, dtype=np.int64) * len(mesh))
    return args, models


@pytest.fixture(scope="module")
def sponza():
    """Both packages' SceneArrays of proc://sponza?tris=8192 under
    --as-strategy=per-model."""
    from tauray_torch.io.gltf import load_scene as tload
    from tauray_torch.options import Options as TOpt
    from tauray_torch.scene.arrays import SceneArrays as TSA
    from tauray_torch.scene.scene import Scene as TScene
    from tauray_tpu.io.gltf import load_scene as jload
    from tauray_tpu.options import Options as JOpt
    from tauray_tpu.scene.arrays import SceneArrays as JSA
    from tauray_tpu.scene.scene import Scene as JScene
    out = []
    for load, opt_cls, sa_cls, scene_cls in ((tload, TOpt, TSA, TScene),
                                              (jload, JOpt, JSA, JScene)):
        s = scene_cls()
        load(SPONZA, s)
        opt = opt_cls()
        opt.as_strategy = "per-model"
        out.append(sa_cls(s, opt))
    return out


def _assert_build_equal(tt, jt):
    assert tt.n_clusters == jt.n_clusters
    assert tt.alpha_base == jt.alpha_base
    for name in EXACT:
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)),
                                      err_msg=name)
    _assert_refit_close(tt, jt)


def _assert_refit_close(tt, jt):
    inv, jinv = tt.inv.numpy(), np.asarray(jt.inv)
    scale = np.abs(jinv).max(axis=(1, 2), keepdims=True)
    np.testing.assert_array_less(
        np.abs(inv - jinv), np.broadcast_to(INV_TOL * scale, inv.shape))
    jmin, jmax = np.asarray(jt.cmin), np.asarray(jt.cmax)
    ext = float(np.abs(np.concatenate([jmin, jmax])).max())
    for a, b in ((tt.cmin.numpy(), jmin), (tt.cmax.numpy(), jmax)):
        np.testing.assert_array_less(np.abs(a - b),
                                     np.full(a.shape, AABB_TOL * ext))


def test_build_and_refit_match_instancing_scene():
    args, models = _instancing_scene()
    jt, _ = jcl.build_instanced_tracer(*args, use_pallas=True)
    tt = tcl.build_instanced_tracer(*args, device=CPU)
    assert tt.v0.shape[0] == -(-600 // 128)        # one mesh's clusters
    assert tt.n_clusters == 100 * tt.v0.shape[0]
    assert 0 < tt.alpha_base < tt.n_clusters * 128
    _assert_build_equal(tt, jt)
    # refit after moving instance 3: only transforms and AABBs change
    moved = models.copy()
    moved[3, :3, 3] += np.array([100.0, 0, 0], np.float32)
    tt2 = tcl.refit_instanced_tracer(tt, moved)
    jt2 = jcl.refit_instanced_tracer(jt, moved)
    assert tt2.v0 is tt.v0 and tt2.tris9 is tt.tris9
    _assert_refit_close(tt2, jt2)
    k3 = (tt.k_inst == 3).numpy()
    assert (tt2.cmin.numpy()[k3, 0] > tt.cmin.numpy()[k3, 0] + 99).all()
    np.testing.assert_array_equal(tt2.cmin.numpy()[~k3],
                                  tt.cmin.numpy()[~k3])


def test_build_matches_per_model_sponza(sponza):
    tsa, jsa = sponza
    jt = jcl.build_instanced_from_arrays(jsa, use_pallas=True)
    tt = tcl.build_instanced_from_arrays(tsa, CPU)
    assert isinstance(tt, tcl.InstancedClusterTracer) and jt is not None
    # the procedural atrium shares its column mesh between instances
    assert tt.v0.shape[0] * 128 < tsa.tri_pos.shape[0]
    _assert_build_equal(tt, jt)
    # a field-by-field copy of the JAX tracer traces like the port's build
    fields = {k: np.asarray(getattr(jt, k)) for k in (
        "v0", "e1", "e2", "tri_valid", "to_orig", "cmin", "cmax",
        "k_cluster", "k_inst", "inv", "obj_min", "obj_max", "opaque")}
    fields.update(n_clusters=jt.n_clusters, alpha_base=jt.alpha_base)
    ft = tcl.instanced_tracer_from_numpy(fields, CPU)
    for name in EXACT:
        assert torch.equal(getattr(ft, name), getattr(tt, name)), name


def test_flat_build_when_nothing_is_shared():
    """No instance shares a mesh: build_instanced_from_arrays declines, as
    tauray_tpu's does, and the renderer builds the flat tracer."""
    from test_torch_scene import floor_scene
    from tauray_torch.options import Options
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer
    from tauray_torch.scene.arrays import SceneArrays
    opt = Options()
    opt.as_strategy = "per-model"
    s = floor_scene("tauray_torch")
    assert tcl.build_instanced_from_arrays(SceneArrays(s, opt), CPU) is None
    rr = PathTracerRenderer(opt, CPU)
    rr.set_scene(s)
    assert isinstance(rr.bvh, tcl.ClusterTracer) and rr.bvh.slot_ids


def _camera_and_bounce(tsa, seed):
    """A 32x32 camera wave of the scene's camera and a random-direction
    wave leaving its hits (through the port's flat tracer)."""
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer
    from tauray_torch.scene.device import to_camera_uniforms
    from tauray_torch.stages.path_tracer import _begin_sample
    from tauray_torch.options import Options
    opt = Options()
    opt.width = opt.height = 32
    rr = PathTracerRenderer(opt, CPU)
    rr.scene = tsa.scene
    rr.arrays = tsa
    rr._scene_changed()
    cam = to_camera_uniforms(tsa.camera_uniforms(rr.viewports()), CPU)
    prev = torch.zeros(rr._pix.shape[0], dtype=torch.int64)
    _, o, d, _ = _begin_sample(rr.cfg, cam, rr._pix, rr._vp, prev)
    hit = rr.bvh.trace(o, d, 0.0, float("inf"), need_uv=False)
    p = torch.where((hit.tri_id >= 0)[:, None], o + hit.t[:, None] * d, o)
    rng = np.random.default_rng(seed)
    nd = rng.standard_normal((o.shape[0], 3)).astype(np.float32)
    nd /= np.linalg.norm(nd, axis=1, keepdims=True)
    return (o, d), (p, torch.from_numpy(nd))


def test_trace_matches_jax_instanced_tracer(sponza):
    """Camera and bounce waves (closest hit) and a shadow wave toward a
    point light (any hit, finite t_max) through the port's per-model
    tracer and tauray_tpu's."""
    import jax.numpy as jnp
    tsa, jsa = sponza
    jt = jcl.build_instanced_from_arrays(jsa, use_pallas=False)
    tt = tcl.build_instanced_from_arrays(tsa, CPU)
    (co, cd), (bo, bd) = _camera_and_bounce(tsa, seed=1)
    light = torch.from_numpy(tsa.pl_pos[0])
    to_l = light[None] - bo
    dist = to_l.norm(dim=1)
    inf = torch.full((co.shape[0],), float("inf"))
    tri_world = tsa.tri_pos
    for name, o, d, tmin, tmax in (
            ("camera", co, cd, 0.0, inf), ("bounce", bo, bd, 1e-4, inf),
            ("shadow", bo, to_l / dist[:, None], 1e-4, dist - 1e-4)):
        any_hit = name == "shadow"
        h, flag = tt.trace_flagged(o, d, tmin, tmax, any_hit=any_hit)
        jh = jt.trace(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), tmin,
                      jnp.asarray(tmax.numpy()), any_hit=any_hit)
        jid = np.asarray(jh.tri_id)
        assert h.tri_id.dtype == torch.int32
        assert (jid >= 0).any() and (name != "shadow" or (jid < 0).any()), \
            name
        if any_hit:
            # tauray_tpu's XLA traversal has no any-hit exit: hits agree,
            # and the port's any-hit t is never nearer than the closest
            np.testing.assert_array_equal(h.tri_id.numpy() < 0, jid < 0)
            hit = jid >= 0
            jtt = np.asarray(jh.t)
            assert (h.t.numpy()[hit] >= jtt[hit] * (1 - T_RTOL) - T_ATOL
                    ).all()
            continue
        _assert_ids_match_up_to_ties(tri_world, o.numpy(), d.numpy(),
                                     h.t.numpy(), h.tri_id.numpy(),
                                     np.asarray(jh.t), jid)
        same = h.tri_id.numpy() == jid
        np.testing.assert_allclose(h.u.numpy()[same], np.asarray(jh.u)[same],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(h.v.numpy()[same], np.asarray(jh.v)[same],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
        assert not bool(flag.any())      # no alpha-capable instance


def test_per_model_image_matches_jax():
    """16x16, 2 spp, depth 3, linear tonemap, --as-strategy=per-model:
    the port (instanced tracer, plain K3) against tauray_tpu's renderer
    (instanced tracer, XLA traversal). Criterion of test_torch_pt.py:
    >= 99% of pixels within 1e-3 relative and the mean within 0.1%."""
    from tauray_tpu.io.gltf import load_scene as jload
    from tauray_tpu.options import Options as JOptions
    from tauray_tpu.renderer.rt_renderer import PathTracerRenderer as JPT
    from tauray_tpu.scene.scene import Scene as JScene
    from tauray_torch.io.gltf import load_scene as tload
    from tauray_torch.options import Options as TOptions
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer
    from tauray_torch.scene.scene import Scene as TScene
    from test_torch_pt import _opt
    js, ts = JScene(), TScene()
    jload(SPONZA, js)
    tload(SPONZA, ts)
    jr = JPT(_opt(JOptions, as_strategy="per-model"))
    jr.set_scene(js)
    assert isinstance(jr.bvh, jcl.InstancedClusterTracer)
    want = jr.render()[0][..., :3]
    rr = PathTracerRenderer(_opt(TOptions, as_strategy="per-model"), CPU)
    rr.set_scene(ts)
    assert isinstance(rr.bvh, tcl.InstancedClusterTracer)
    got = rr.render()[0][..., :3]
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    within = float((rel.max(axis=-1) <= 1e-3).mean())
    mean_rel = abs(float(got.mean()) / float(want.mean()) - 1.0)
    print(f"pixels within 1e-3: {within:.4f}; image mean port "
          f"{got.mean():.6f} jax {want.mean():.6f} (rel {mean_rel:.2e})")
    assert np.isfinite(got).all() and got.mean() > 0
    assert within >= 0.99
    assert mean_rel <= 1e-3


def test_frame_update_refits_instances():
    """update_frame (device_update_frame) moves the instanced tracer with
    the scene: after an entity moves, the next frame's tracer holds the
    new transforms (refit from the instance transforms that
    host_frame_inputs walks, alone; triangle tables untouched)."""
    from tauray_torch.io.gltf import load_scene
    from tauray_torch.options import Options
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer
    from tauray_torch.scene.scene import Scene
    opt = Options()
    opt.width = opt.height = 8
    opt.as_strategy = "per-model"
    s = Scene()
    load_scene(SPONZA, s)
    rr = PathTracerRenderer(opt, CPU)
    rr.set_scene(s)
    before = rr.bvh
    ent = next(e for e in s.entities
               if e.model is not None and e.transform is not None)
    ent.transform.set_position(ent.transform.position +
                               np.array([0.0, 5.0, 0.0], np.float32))
    rr.update_frame()
    after = rr.bvh
    assert after.v0 is before.v0 and after.tris9 is before.tris9
    from tauray_torch.scene.device_update import host_frame_inputs
    want = tcl.refit_instanced_tracer(before,
                                      host_frame_inputs(rr.arrays)[0])
    assert torch.equal(after.inv, want.inv)
    assert torch.equal(after.cmin, want.cmin)
    assert not torch.equal(after.cmin, before.cmin)
