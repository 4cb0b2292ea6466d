"""The flat cluster tracer of tauray_torch against tauray_tpu's.

  * the host build is the same numpy code: perm, cluster AABBs, validity
    and the alpha split are EQUAL; the Baldwin-Weber table tris12 agrees
    to a few ulps (XLA:CPU contracts the cross and dot products into FMAs,
    torch on the CPU does not);
  * phase 1 (slab cull + per-tile key rows) is EQUAL: the slab test is
    subtractions, products, min and max only, exact in both; also on
    planted rays (signed-zero, denormal and NaN inputs, origins on faces
    and inside boxes, corner touches, t_min > 0, the dead filler), which
    pin the NaN and signed-zero semantics that the card's kernel
    (trace_kernel.phase1_ids) is held to bit for bit. One departure is
    held exactly: XLA on the CPU reads a denormal input as a zero of its
    sign (so 1 / d is 3e38 for a denormal direction component there, and
    an origin one ulp off 0.0 lies on the face at 0.0), while the port
    computes with the denormal (1 / d is infinite, and 0 * inf makes the
    ray inactive for a box whose face holds its origin); the JAX
    package's phase 1 equals the port's on the same rays with every
    denormal flushed;
  * the plain traversal (trace_tiles_vm3_reference) matches the real Pallas
    kernel _kernel_vm3 run in interpret mode on identical inputs: ids
    equal, t within 1e-5 relative;
  * ClusterTracer.trace matches tauray_tpu's ClusterTracer.trace (phase 1 +
    the Pallas kernel in interpret mode) on camera, sorted bounce and
    any-hit shadow waves. Ids are equal except at exact-t ties: where they
    differ, both hit, their t agree within 1e-5 relative, and BOTH chosen
    triangles are hit by the ray at that t when tested in float64 (a shared
    edge or a duplicated padding triangle). An id check is never loosened
    beyond that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauray_torch.app.kernel_waves import (flush_denormals, one_per_tile,
                                           planted_rays)
from tauray_torch.ops import cluster as tcl
from tauray_torch.ops import trace_kernel as tk
from tauray_torch.ops.trace_kernel import trace_tiles_vm3_reference
from tauray_tpu.ops import cluster as jcl
from tauray_tpu.ops.pallas_trace import pallas_trace_tiles_vm3

# the tests run in several worker processes at once: keep torch's
# intra-op pool small so they do not oversubscribe the cores
torch.set_num_threads(2)

CPU = torch.device("cpu")
# t: 1e-5 relative, and 1e-5 absolute (world units) for hits near the ray
# origin: t = (n.v0 - n.o) / (n.d) cancels there, and with and without FMA
# contraction the numerator differs by a few ulps of the scene's
# coordinates (O(10) here), which no relative bound covers as t -> 0
T_RTOL = 1e-5
T_ATOL = 1e-5


@pytest.fixture(scope="module")
def sponza():
    """Port renderer state on proc://sponza?tris=8192 (scene arrays, the
    port's tracer) and a 32x32 camera wave in pixel-block order."""
    from tauray_torch.io.gltf import load_scene
    from tauray_torch.options import Options
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer
    from tauray_torch.scene.device import to_camera_uniforms
    from tauray_torch.scene.scene import Scene
    from tauray_torch.stages.path_tracer import _begin_sample
    opt = Options()
    opt.width = opt.height = 32
    s = Scene()
    load_scene("proc://sponza?tris=8192", s)
    rr = PathTracerRenderer(opt, CPU)
    rr.set_scene(s)
    cam = to_camera_uniforms(rr.arrays.camera_uniforms(rr.viewports()), CPU)
    prev = torch.zeros(rr._pix.shape[0], dtype=torch.int64)
    _, o, d, _ = _begin_sample(rr.cfg, cam, rr._pix, rr._vp, prev)
    return rr, o, d


def _build_args(sa):
    return dict(tri_pos=sa.tri_pos, tri_instance=sa.tri_instance,
                tri_opaque=tcl.tri_opacity(sa.tri_instance,
                                           sa.inst_has_alpha),
                strategy="static-merged-dynamic-per-model",
                inst_dynamic=sa.inst_dynamic, inst_entity=sa.inst_entity)


@pytest.fixture(scope="module")
def jax_tracer(sponza):
    rr = sponza[0]
    jt, jperm = jcl.build_cluster_tracer(**_build_args(rr.arrays))
    return jt.with_pallas_layout(), jperm


def _assert_tris12_close(a, b, e1, e2, v0):
    """Baldwin-Weber rows of the two packages, per triangle. XLA:CPU
    contracts the cross products into FMAs and torch does not, so:
      * a triangle whose edges are parallel in float32 (e1 x e2 == 0
        exactly in the port) has an all-zero row in the port and a JAX
        normal at the rounding level of |e1||e2|;
      * every other row agrees within 1e-4 of its own scale: |n|, |r1|,
        |r2| for the direction parts and |v0| times that for the plane
        offsets (the cross product of a thin triangle cancels, so its
        relative error is ulp / sin(angle between the edges))."""
    rows_a = a[:, :, 0, :].transpose(0, 2, 1).reshape(-1, 3, 4)
    rows_b = b[:, :, 0, :].transpose(0, 2, 1).reshape(-1, 3, 4)
    e1, e2, v0 = (x.reshape(-1, 3).astype(np.float64) for x in (e1, e2, v0))
    edge = np.linalg.norm(e1, axis=1) * np.linalg.norm(e2, axis=1)
    flat = (rows_b[:, 0, :3] == 0).all(1)
    assert (rows_b[flat] == 0).all()
    np.testing.assert_array_less(np.linalg.norm(rows_a[flat, 0, :3], axis=1),
                                 1e-6 * edge[flat] + 1e-30)
    ok = ~flat
    scale = np.linalg.norm(rows_a[ok, :, :3], axis=2)           # (T, 3)
    vlen = 1.0 + np.linalg.norm(v0[ok], axis=1)[:, None]
    tol = 1e-4 * np.concatenate(
        [np.repeat(scale[..., None], 3, 2), (scale * vlen)[..., None]], 2)
    np.testing.assert_array_less(np.abs(rows_b[ok] - rows_a[ok]),
                                 tol + 1e-30)


def test_build_matches(sponza, jax_tracer):
    rr = sponza[0]
    jt, jperm = jax_tracer
    tt, tperm = tcl.build_cluster_tracer(**_build_args(rr.arrays),
                                         device=CPU)
    np.testing.assert_array_equal(tperm, jperm)
    assert tt.n_clusters == jt.n_clusters and tt.alpha_base == jt.alpha_base
    for name in ("tri_valid", "to_orig", "cmin", "cmax", "v0",
                 "e1", "e2"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)),
                                      err_msg=name)
    a = np.asarray(jt.tris12)
    b = tt.tris12.numpy()
    assert a.shape == b.shape
    _assert_tris12_close(a, b, tt.e1.numpy(), tt.e2.numpy(), tt.v0.numpy())
    np.testing.assert_array_equal(tt.tris_flat.numpy(),
                                  np.asarray(jt.tris_flat))
    # the default strategy pads the last cluster with duplicate slots
    assert not bool(tt.tri_valid.all())


def _jax_phase1(jt, rays8):
    """tauray_tpu _trace_padded_pallas phase 1, v3 branch (cluster.py
    :937-1016), on the JAX package's own _slab_t_soa; C-wide key rows."""
    R = rays8.shape[0]
    C = jt.n_clusters
    nb = R // 128
    r = jnp.asarray(rays8).reshape(nb, 128, 8)
    ro, rd = r[..., 0:3], r[..., 3:6]
    inv_d = jnp.where(rd == 0, jnp.float32(3e38),
                      1.0 / jnp.where(rd == 0, 1.0, rd))
    tn, tf = jcl._slab_t_soa(
        ro[:, None, :, 0], ro[:, None, :, 1], ro[:, None, :, 2],
        inv_d[:, None, :, 0], inv_d[:, None, :, 1], inv_d[:, None, :, 2],
        jt.cmin, jt.cmax)
    tn = jnp.maximum(tn, r[:, None, :, 6])
    act = (tf >= tn) & (tn <= r[:, None, :, 7])
    tile_act = jnp.any(act.reshape(nb, C, 4, 32), axis=3)
    tile_act = jnp.transpose(tile_act, (0, 2, 1)).reshape(nb * 4, C)
    counts = jnp.sum(tile_act, axis=1).astype(jnp.int32)
    key = jnp.where(tile_act, jnp.arange(C, dtype=jnp.int32)[None, :],
                    jnp.int32(0x7FFFFFFF))
    return np.asarray(counts), np.asarray(jnp.sort(key, axis=1))


def _bounce_rays(rr, o, d, seed=0):
    """A bounce-like wave: random directions leaving the camera hits."""
    hit = rr.bvh.trace(o, d, 0.0, float("inf"), need_uv=False)
    p = torch.where((hit.tri_id >= 0)[:, None], o + hit.t[:, None] * d, o)
    rng = np.random.default_rng(seed)
    nd = rng.standard_normal((o.shape[0], 3)).astype(np.float32)
    nd /= np.linalg.norm(nd, axis=1, keepdims=True)
    return p, torch.from_numpy(nd)


def _rays8(o, d, tmin, tmax):
    R = o.shape[0]
    return torch.cat([o, d, torch.full((R, 1), tmin),
                      torch.as_tensor(tmax, dtype=torch.float32).expand(R)
                      [:, None]], 1)


def test_phase1_counts_and_keys_equal(sponza, jax_tracer):
    rr, o, d = sponza
    jt, _ = jax_tracer
    p, nd = _bounce_rays(rr, o, d)
    for rays8 in (_rays8(o, d, 0.0, float("inf")),
                  _rays8(p, nd, 1e-4, float("inf"))):
        counts, keys = tcl._phase1(rr.bvh, rays8)
        jc, jk = _jax_phase1(jt, rays8.numpy())
        np.testing.assert_array_equal(counts.numpy(), jc)
        np.testing.assert_array_equal(keys.numpy(), jk)
        assert counts.max() > 1


def _slab_act(rays8, cmin, cmax, nan_minmax=True, zero_guard=True):
    """(activity, tn, tf) of every ray against every box, each (R, C): the
    slab test written out once more. nan_minmax=False takes min and max
    that drop a NaN (torch.fmin / fmax, as C's fminf does); zero_guard=False
    takes 1 / d for d = +-0.0 (+-inf) in place of 3e38."""
    o = rays8[:, None, 0:3]
    d = rays8[:, None, 3:6]
    inv = 1.0 / d
    if zero_guard:
        inv = torch.where(d == 0, tcl.BIG, inv)
    mn, mx = ((torch.minimum, torch.maximum) if nan_minmax
              else (torch.fmin, torch.fmax))
    t0 = (cmin[None] - o) * inv
    t1 = (cmax[None] - o) * inv
    tn = mx(mx(mn(t0[..., 0], t1[..., 0]), mn(t0[..., 1], t1[..., 1])),
            mn(t0[..., 2], t1[..., 2]))
    tf = mn(mn(mx(t0[..., 0], t1[..., 0]), mx(t0[..., 1], t1[..., 1])),
            mx(t0[..., 2], t1[..., 2]))
    tn = mx(tn, rays8[:, None, 6])
    return (tf >= tn) & (tn <= rays8[:, None, 7]), tn, tf


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_phase1_planted_rays_equal_jax(sponza, jax_tracer, seed):
    """The torch phase 1 against tauray_tpu's on planted rays, packed
    (several kinds a tile) and one a tile (a tile's row is its ray's), the
    denormals flushed on the port's side (module docstring).
    The planted set tells the semantics apart, denormals aside: min / max
    that drop a NaN, or 1 / d at a signed zero, change some ray's
    activity, and some active rays touch their box at one point
    (tn == tf). The denormals do change some ray's activity in the port:
    that is the departure."""
    rr = sponza[0]
    jt, _ = jax_tracer
    cmin, cmax = rr.bvh.cmin, rr.bvh.cmax
    planted = torch.from_numpy(planted_rays(cmin.numpy(), cmax.numpy(),
                                            seed=seed))
    act, tn, tf = _slab_act(planted, cmin, cmax)
    blocks = tcl._slab_blocks(planted, 0, planted.shape[0] // tcl.TILE,
                              cmin, cmax)[1]
    assert torch.equal(blocks.permute(0, 2, 1).reshape(act.shape), act)
    flushed = torch.from_numpy(flush_denormals(planted.numpy()))
    f_act, f_tn, f_tf = _slab_act(flushed, cmin, cmax)
    assert bool((f_act & (f_tn == f_tf)).any())
    assert bool((f_act & (f_tn > 0)).any()) and bool((~f_act).any())
    for variant in (dict(nan_minmax=False), dict(zero_guard=False)):
        assert bool((_slab_act(flushed, cmin, cmax, **variant)[0]
                     != f_act).any()), variant
    assert bool((f_act != act).any())
    spread = torch.from_numpy(one_per_tile(planted.numpy()))
    for rays8 in (planted, spread):
        counts, keys = tcl._phase1(
            rr.bvh, torch.from_numpy(flush_denormals(rays8.numpy())))
        jc, jk = _jax_phase1(jt, rays8.numpy())
        np.testing.assert_array_equal(counts.numpy(), jc)
        np.testing.assert_array_equal(keys.numpy(), jk)
    counts, keys = tcl._phase1(rr.bvh, spread)
    assert torch.equal(counts, act.sum(1, dtype=torch.int32))
    ids = torch.arange(act.shape[1], dtype=torch.int32)
    want = torch.where(act, ids, tcl.KEY_SENTINEL).sort(dim=1).values
    assert torch.equal(keys, want)


def test_phase1_on_cpu_tensors_launches_nothing(sponza):
    """On the CPU phase 1 is the torch passes: phase1_ids gives
    _phase1's bits, and neither launches the card's kernel."""
    rr, o, d = sponza
    tk.reset_launch_counts()
    rays8 = tcl._pack_rays(o, d, 0.0, float("inf"))
    counts, keys = tcl._phase1(rr.bvh, rays8)
    c2, k2 = tk.phase1_ids(rays8, rr.bvh.cmin, rr.bvh.cmax)
    assert torch.equal(counts, c2) and torch.equal(keys, k2)
    rr.bvh.trace(o, d, 0.0, float("inf"))
    assert tk.LAUNCHES["phase1_ids"] == 0


def test_phase1_goes_through_the_wrapper(sponza, monkeypatch):
    """_phase1 hands every wave to trace_kernel.phase1_ids, which alone
    checks the arguments and picks the card or the torch passes."""
    rr, o, d = sponza
    seen = []

    def spy(rays8, cmin, cmax):
        seen.append(rays8.shape[0])
        return tk.phase1_ids(rays8, cmin, cmax)
    monkeypatch.setattr(tcl, "phase1_ids", spy)
    rays8 = tcl._pack_rays(o, d, 0.0, float("inf"))
    tcl._phase1(rr.bvh, rays8)
    assert seen == [rays8.shape[0]]
    with pytest.raises(ValueError):
        tcl._phase1(rr.bvh, rays8[:96])
    assert seen == [rays8.shape[0], 96]


def _bad_phase1_args(case):
    rays8 = torch.zeros((256, 8))
    cmin = torch.zeros((5, 3))
    cmax = torch.ones((5, 3))
    return {
        "rays_f64": (rays8.double(), cmin, cmax),
        "rays_3d": (rays8.reshape(2, 128, 8), cmin, cmax),
        "rays_7_wide": (rays8[:, :7].contiguous(), cmin, cmax),
        "rays_not_128": (rays8[:96], cmin, cmax),
        "no_rays": (rays8[:0], cmin, cmax),
        "rays_strided": (torch.zeros((8, 256)).t(), cmin, cmax),
        "boxes_int": (rays8, cmin.int(), cmax),
        "boxes_4_wide": (rays8, torch.zeros((5, 4)), cmax),
        "boxes_unequal": (rays8, cmin, cmax[:4]),
        "no_boxes": (rays8, cmin[:0], cmax[:0]),
        "too_many_boxes": (rays8, torch.zeros((tcl.VM_FITS_CLUSTERS + 1, 3)),
                           torch.ones((tcl.VM_FITS_CLUSTERS + 1, 3))),
    }[case]


@pytest.mark.parametrize("case", [
    "rays_f64", "rays_3d", "rays_7_wide", "rays_not_128", "no_rays",
    "rays_strided", "boxes_int", "boxes_4_wide", "boxes_unequal",
    "no_boxes", "too_many_boxes"])
def test_phase1_ids_rejects_what_the_kernel_does_not_take(case):
    """phase1_ids checks its arguments before it picks the card or the
    torch passes, so a CPU call raises where a card call would."""
    with pytest.raises(ValueError):
        tk.phase1_ids(*_bad_phase1_args(case))


def test_phase1_ids_takes_the_largest_table():
    """C = VM_FITS_CLUSTERS passes the checks; one ray a tile and one box
    it hits give count 1 and that id first."""
    C = tcl.VM_FITS_CLUSTERS
    cmin = torch.full((C, 3), 10.0)
    cmax = torch.full((C, 3), 11.0)
    cmin[C - 1], cmax[C - 1] = -1.0, 1.0
    rays8 = torch.from_numpy(one_per_tile(np.array(
        [[0, 0, 0, 0, 0, 1, 0, np.inf]] * 4, np.float32)))
    counts, keys = tk.phase1_ids(rays8, cmin, cmax)
    assert counts.tolist() == [1] * 4
    assert keys[:, 0].tolist() == [C - 1] * 4
    assert bool((keys[:, 1:] == tcl.KEY_SENTINEL).all())


def test_sig_sort_key_matches(sponza, jax_tracer):
    rr, o, d = sponza
    jt, _ = jax_tracer
    p, nd = _bounce_rays(rr, o, d, seed=3)
    rays8 = _rays8(p, nd, 1e-4, float("inf"))
    rays8[::7, 7] = 0.0                     # some dead rays sort last
    want = np.asarray(jcl._sig_sort_key(
        jt, jnp.asarray(rays8[:, 0:3].numpy()),
        jnp.asarray(rays8[:, 3:6].numpy()),
        jnp.asarray(rays8[:, 6].numpy()), jnp.asarray(rays8[:, 7].numpy())))
    got = tcl._sig_sort_key(rr.bvh, rays8).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(
        tcl._sig_sort_perm(rr.bvh, rays8).numpy(),
        np.asarray(jcl._sig_sort_perm(
            jt, *(jnp.asarray(rays8[:, a:b].numpy()).reshape(
                (-1, b - a) if b - a > 1 else (-1,))
                for a, b in ((0, 3), (3, 6), (6, 7), (7, 8))))))


def test_plain_traversal_matches_pallas_kernel_interpret():
    """trace_tiles_vm3_reference vs _kernel_vm3 in interpret mode on the
    SAME counts/keys/rays8/tris12; a random soup whose last cluster is
    padded with duplicate slots."""
    rng = np.random.default_rng(5)
    T = 8 * 128 - 37
    v0 = rng.uniform(-4, 4, (T, 3)).astype(np.float32)
    tri = (v0[:, None] + rng.normal(0, 0.7, (T, 3, 3))).astype(np.float32)
    tt, _ = tcl.build_cluster_tracer(tri, np.zeros(T, np.int32),
                                     strategy="per-material", device=CPU)
    assert not bool(tt.tri_valid.all())
    R = 4096
    o = torch.from_numpy(rng.uniform(-6, 6, (R, 3)).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((R, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    tmax = torch.from_numpy(np.where(rng.random(R) < 0.2, 3.0,
                                     np.inf).astype(np.float32))
    rays8 = _rays8(o, d, 0.0, tmax)
    counts, keys = tcl._phase1(tt, rays8)
    C = tt.n_clusters
    cpad = 1024 * (-(-(C + 8) // 1024))
    kp = np.full((keys.shape[0], cpad), 0x7FFFFFFF, np.int32)
    kp[:, :C] = keys.numpy()
    idmask = (1 << max(int(np.ceil(np.log2(max(C, 2)))), 1)) - 1
    r3 = rays8.reshape(-1, 32, 8)
    jt_, jid = pallas_trace_tiles_vm3(
        jnp.asarray(counts.numpy()), jnp.asarray(kp),
        jnp.asarray(r3.numpy()), jnp.asarray(tt.tris12.numpy()), C, cpad,
        idmask, interpret=True)
    t, tid = trace_tiles_vm3_reference(counts, torch.from_numpy(kp), r3,
                                       tt.tris12)
    jid = np.asarray(jid)
    np.testing.assert_array_equal(tid.numpy(), jid)
    assert (jid >= 0).sum() > R // 4 and (jid < 0).sum() > 0
    jt_ = np.asarray(jt_)
    np.testing.assert_array_equal(np.isinf(t.numpy()), np.isinf(jt_))
    fin = np.isfinite(jt_)
    np.testing.assert_allclose(t.numpy()[fin], jt_[fin], rtol=T_RTOL,
                               atol=T_ATOL)


def _f64_hit_t(o, d, tri):
    """Möller-Trumbore in float64: t per (ray, triangle), nan on miss."""
    o, d, tri = (np.asarray(x, np.float64) for x in (o, d, tri))
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    h = np.cross(d, e2)
    a = np.sum(e1 * h, -1)
    f = 1.0 / np.where(a == 0, np.nan, a)
    s = o - tri[:, 0]
    u = f * np.sum(s * h, -1)
    q = np.cross(s, e1)
    v = f * np.sum(d * q, -1)
    t = f * np.sum(e2 * q, -1)
    eps = 1e-5
    ok = (u >= -eps) & (v >= -eps) & (u + v <= 1 + eps)
    return np.where(ok, t, np.nan)


def _assert_ids_match_up_to_ties(tri_slot, o, d, t_a, id_a, t_b, id_b):
    """Ids equal, except at exact-t ties (see the module docstring)."""
    t_a, t_b = np.asarray(t_a), np.asarray(t_b)
    id_a, id_b = np.asarray(id_a), np.asarray(id_b)
    np.testing.assert_array_equal(id_a < 0, id_b < 0)
    hit = id_a >= 0
    np.testing.assert_allclose(t_a[hit], t_b[hit], rtol=T_RTOL,
                               atol=T_ATOL)
    diff = np.flatnonzero(id_a != id_b)
    assert len(diff) <= max(len(id_a) // 100, 2), len(diff)
    for ids in (id_a[diff], id_b[diff]):
        t64 = _f64_hit_t(np.asarray(o)[diff], np.asarray(d)[diff],
                         tri_slot[ids])
        np.testing.assert_allclose(t64, t_b[diff], rtol=T_RTOL,
                                   atol=T_ATOL)


def test_trace_matches_jax_tracer(sponza, jax_tracer, monkeypatch):
    """camera (pixel order), bounce (signature-sorted) and any-hit shadow
    (sorted, finite t_max toward a point light) waves, slot-id mode."""
    monkeypatch.setattr(jcl, "_PALLAS_INTERPRET", True)
    rr, o, d = sponza
    jt, jperm = jax_tracer
    jt.slot_ids = True
    tri_slot = rr.arrays.tri_pos[jperm]
    p, nd = _bounce_rays(rr, o, d, seed=1)
    light = torch.from_numpy(rr.arrays.pl_pos[0])
    to_l = light[None] - p
    dist = to_l.norm(dim=1)
    waves = [("camera", o, d, 0.0, torch.full((o.shape[0],), float("inf")),
              False, False),
             ("bounce", p, nd, 1e-4, torch.full((o.shape[0],),
                                                 float("inf")), True, False),
             ("shadow", p, to_l / dist[:, None], 1e-4, dist - 1e-4, True,
              True)]
    for name, wo, wd, tmin, tmax, sort, any_hit in waves:
        h = rr.bvh.trace(wo, wd, tmin, tmax, any_hit=any_hit,
                         sort_rays=sort, need_uv=True)
        jh = jt.trace(jnp.asarray(wo.numpy()), jnp.asarray(wd.numpy()),
                      tmin, jnp.asarray(tmax.numpy()), any_hit=any_hit,
                      sort_rays=sort, need_uv=True)
        _assert_ids_match_up_to_ties(tri_slot, wo.numpy(), wd.numpy(),
                                     h.t.numpy(), h.tri_id.numpy(),
                                     np.asarray(jh.t), np.asarray(jh.tri_id))
        same = h.tri_id.numpy() == np.asarray(jh.tri_id)
        np.testing.assert_allclose(h.u.numpy()[same], np.asarray(jh.u)[same],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
        assert h.tri_id.dtype == torch.int32, name
        if name == "shadow":
            assert (h.tri_id.numpy() < 0).any() and \
                (h.tri_id.numpy() >= 0).any()


def test_tracer_from_numpy(sponza, jax_tracer):
    """The port's tracer rebuilt from tauray_tpu's tracer fields traces
    exactly like the port's own build."""
    rr, o, d = sponza
    jt, _ = jax_tracer
    fields = {k: np.asarray(getattr(jt, k)) for k in (
        "v0", "e1", "e2", "tri_valid", "to_orig", "cmin", "cmax")}
    fields.update(n_clusters=jt.n_clusters, alpha_base=jt.alpha_base,
                  slot_ids=True)
    ft = tcl.tracer_from_numpy(fields, CPU)
    assert ft.slot_ids and ft.n_clusters == rr.bvh.n_clusters
    p, nd = _bounce_rays(rr, o, d, seed=2)
    a = ft.trace(p, nd, 1e-4, float("inf"), sort_rays=True)
    b = rr.bvh.trace(p, nd, 1e-4, float("inf"), sort_rays=True)
    assert torch.equal(a.tri_id, b.tri_id)
    assert torch.equal(a.t, b.t)
