"""The front-to-back traversal of tauray_torch against tauray_tpu's, on the
CPU: the entry-t keyed phase 1, the plain versions of K2 (trace_tiles) and
K3 (trace_tiles_inst) against the real Pallas kernels _kernel and
_kernel_inst run in interpret mode on the same inputs, and the flat
tracer's choice of kernel by scene size.

  * phase 1 is EQUAL: the slab test is subtractions, products, min and
    max only, exact in both packages, and the keys are bit patterns of
    its results;
  * the kernels are fed ONE key row (the port's, bit-equal to JAX's) and
    the same tables; ids are identical in closest-hit and any-hit modes,
    and t agrees within T_RTOL / T_ATOL: XLA:CPU contracts the
    Möller-Trumbore products into FMAs and torch on the CPU does not, so
    t differs by a few ulps of its terms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauray_torch.ops import cluster as tcl
from tauray_torch.ops import trace_kernel as tk
from tauray_tpu.ops import cluster as jcl
from tauray_tpu.ops.pallas_trace import (pallas_trace_tiles,
                                         pallas_trace_tiles_inst)

from test_instancing import _bake_world, _mesh, _rand_rays, _transforms

# the tests run in several worker processes at once: keep torch's
# intra-op pool small so they do not oversubscribe the cores
torch.set_num_threads(2)

CPU = torch.device("cpu")
T_RTOL = 1e-5
T_ATOL = 1e-5
N_INST = 20
# instances 3, 7, 11, ... are alpha-capable: their clusters are not opaque,
# so the any-hit exit must walk past their hits
INST_OPAQUE = np.arange(N_INST) % 4 != 3
R = 1024


@pytest.fixture(scope="module")
def scene():
    """20 instances of one 600-triangle mesh (tests/test_instancing.py),
    as the port's instanced tracer and as a world-baked flat tracer, and
    1,024 random rays with finite t_max for the any-hit runs."""
    mesh = _mesh(600)
    models = _transforms(N_INST, spread=5.0)
    world, tri_inst = _bake_world(mesh, models)
    inst = tcl.build_instanced_tracer(
        [mesh], np.zeros(N_INST, np.int64), models, INST_OPAQUE,
        np.arange(N_INST, dtype=np.int64) * len(mesh), device=CPU)
    flat, _ = tcl.build_cluster_tracer(
        world, tri_inst, tri_opaque=INST_OPAQUE[tri_inst],
        strategy="per-material", device=CPU)
    # rays toward jittered triangle centroids, so most hit and many pass
    # other instances first. The first half: one ray each from a random
    # point. The second half: 32-ray tiles sharing an origin outside the
    # instance cloud and a target (a coherent wave whose tiles hit early
    # and have instances behind the hit: the front-to-back exits fire).
    rng = np.random.default_rng(4)
    half = R // 2
    o = rng.uniform(-5, 5, (R, 3)).astype(np.float32)
    far = rng.standard_normal((half // 32, 3))
    far *= 9.0 / np.linalg.norm(far, axis=1, keepdims=True)
    o[half:] = np.repeat(far, 32, axis=0)
    pick = rng.integers(0, len(world), R)
    pick[half:] = np.repeat(pick[half::32], 32)
    target = world[pick].mean(1) + rng.normal(0, 0.3, (R, 3)) * \
        np.where(np.arange(R) < half, 1.0, 0.05)[:, None]
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(2.0, 14.0, R).astype(np.float32)
    return inst, flat, torch.from_numpy(o), torch.from_numpy(d), tmax


def _rays8(o, d, tmax):
    n = o.shape[0]
    return torch.cat([o, d, torch.zeros((n, 1)),
                      torch.as_tensor(tmax, dtype=torch.float32
                                      ).expand(n)[:, None]], 1)


def _jax_phase1_entry(cmin, cmax, rays8):
    """tauray_tpu's entry-t keyed phase 1 (_trace_padded_pallas_inst,
    cluster.py:1467-1494) on the JAX package's _slab_t_soa; C-wide rows."""
    C = cmin.shape[0]
    nb = rays8.shape[0] // 128
    r = jnp.asarray(rays8).reshape(nb, 128, 8)
    ro, rd = r[..., 0:3], r[..., 3:6]
    inv_d = jnp.where(rd == 0, jnp.float32(3e38),
                      1.0 / jnp.where(rd == 0, 1.0, rd))
    tn, tf = jcl._slab_t_soa(
        ro[:, None, :, 0], ro[:, None, :, 1], ro[:, None, :, 2],
        inv_d[:, None, :, 0], inv_d[:, None, :, 1], inv_d[:, None, :, 2],
        jnp.asarray(cmin), jnp.asarray(cmax))
    tn = jnp.maximum(tn, r[:, None, :, 6])
    act = (tf >= tn) & (tn <= r[:, None, :, 7])
    tnear = jnp.min(jnp.where(act, tn, jnp.inf).reshape(nb, C, 4, 32),
                    axis=3)
    tnear = jnp.transpose(tnear, (0, 2, 1)).reshape(nb * 4, C)
    counts = jnp.sum(tnear < jnp.inf, axis=1).astype(jnp.int32)
    idmask = (1 << max(int(np.ceil(np.log2(max(C, 2)))), 1)) - 1
    key = (jax.lax.bitcast_convert_type(tnear, jnp.int32) & ~idmask) | \
        jnp.arange(C, dtype=jnp.int32)[None, :]
    key = jnp.where(jnp.isfinite(tnear), key, jnp.int32(0x7FFFFFFF))
    return np.asarray(counts), np.asarray(jnp.sort(key, axis=1)), idmask


@pytest.mark.parametrize("kind", ["flat", "instanced"])
def test_phase1_entry_keys_equal(scene, kind):
    inst, flat, o, d, tmax = scene
    tracer = flat if kind == "flat" else inst
    for rays8 in (_rays8(o, d, float("inf")), _rays8(o, d, tmax)):
        counts, keys, idmask = tcl._phase1_entry(tracer.cmin, tracer.cmax,
                                                 rays8)
        jc, jk, jmask = _jax_phase1_entry(tracer.cmin.numpy(),
                                          tracer.cmax.numpy(), rays8.numpy())
        C = tracer.n_clusters
        assert idmask == jmask == tcl.key_idmask(C)
        assert keys.shape == (rays8.shape[0] // 32, C + tk.KB)
        np.testing.assert_array_equal(counts.numpy(), jc)
        np.testing.assert_array_equal(keys.numpy()[:, :C], jk)
        assert (keys.numpy()[:, C:] == tk.KEY_SENTINEL).all()
        assert counts.max() > tk.KB    # more than one step per tile


def _padded(keys, C, opaque):
    """The JAX kernels' operand layout: key rows and the opacity table
    padded to 1024 multiples with sentinels / zeros."""
    cpad = 1024 * (-(-(C + tk.KB) // 1024))
    kp = np.full((keys.shape[0], cpad), 0x7FFFFFFF, np.int32)
    kp[:, :keys.shape[1]] = keys
    opad = np.zeros(1024 * (-(-C // 1024)), np.int32)
    opad[:C] = opaque
    return cpad, jnp.asarray(kp), jnp.asarray(opad)


def _assert_same(t, tid, jt, jid):
    jid = np.asarray(jid)
    jt = np.asarray(jt)
    np.testing.assert_array_equal(tid.numpy(), jid)
    assert (jid >= 0).sum() > R // 8 and (jid < 0).sum() > 0
    np.testing.assert_array_equal(np.isinf(t.numpy()), np.isinf(jt))
    fin = np.isfinite(jt)
    np.testing.assert_allclose(t.numpy()[fin], jt[fin], rtol=T_RTOL,
                               atol=T_ATOL)


def _wave(tracer, o, d, tmax, any_hit):
    rays8 = _rays8(o, d, tmax if any_hit else float("inf"))
    counts, keys, idmask = tcl._phase1_entry(tracer.cmin, tracer.cmax, rays8)
    r3 = rays8.reshape(-1, 32, 8)
    jr = r3.numpy()
    jrays = (jnp.asarray(jr[..., 0:3]), jnp.asarray(jr[..., 3:6]),
             jnp.asarray(jr[..., 6:8]))
    return counts, keys, idmask, r3, jrays


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_plain_k2_matches_pallas_kernel_interpret(scene, any_hit):
    """trace_tiles_reference vs _kernel (pallas_trace_tiles) in interpret
    mode: the world-baked flat tracer, some clusters not opaque."""
    _, flat, o, d, tmax = scene
    counts, keys, idmask, r3, jrays = _wave(flat, o, d, tmax, any_hit)
    C = flat.n_clusters
    assert not bool(flat.opaque.all()) and bool(flat.opaque.any())
    stats = {}
    t, tid = tk.trace_tiles_reference(counts, keys, r3, flat.tris9,
                                      flat.opaque, idmask, any_hit, stats)
    cpad, kp, opq = _padded(keys.numpy(), C, flat.opaque.numpy())
    jt, jid = pallas_trace_tiles(
        jnp.asarray(counts.numpy()), kp, *jrays,
        jnp.asarray(flat.tris9.numpy()), opq, C, cpad, idmask,
        any_hit=any_hit, interpret=True)
    _assert_same(t, tid, jt, jid)
    # the front-to-back exit skipped steps on this wave
    assert stats["steps"] < stats["steps_total"]
    # the wrapper takes the plain version for CPU tensors
    t2, tid2 = tk.trace_tiles(counts, keys, r3, flat.tris9, flat.opaque,
                              idmask, any_hit)
    assert torch.equal(tid2, tid) and torch.equal(t2, t)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_plain_k3_matches_pallas_kernel_interpret(scene, any_hit):
    """trace_tiles_inst_reference vs _kernel_inst (pallas_trace_tiles_inst)
    in interpret mode on the instanced tracer's tables."""
    inst, _, o, d, tmax = scene
    counts, keys, idmask, r3, jrays = _wave(inst, o, d, tmax, any_hit)
    K = inst.n_clusters
    inv12 = inst.inv.reshape(-1, 12)
    args = (inst.tris9, inst.opaque, inst.k_cluster, inst.k_inst, inv12,
            idmask, any_hit)
    t, tid = tk.trace_tiles_inst_reference(counts, keys, r3, *args)
    cpad, kp, opq = _padded(keys.numpy(), K, inst.opaque.numpy())
    kpad = 1024 * (-(-K // 1024))
    kcl = np.zeros(kpad, np.int32)
    kcl[:K] = inst.k_cluster.numpy()
    kin = np.zeros(kpad, np.int32)
    kin[:K] = inst.k_inst.numpy()
    ipad = np.zeros((-(-inv12.shape[0] // 8) * 8, 12), np.float32)
    ipad[:inv12.shape[0]] = inv12.numpy()
    jt, jid = pallas_trace_tiles_inst(
        jnp.asarray(counts.numpy()), kp, *jrays,
        jnp.asarray(inst.tris9.numpy()), opq, jnp.asarray(kcl),
        jnp.asarray(kin), jnp.asarray(ipad.reshape(-1)), K, cpad, idmask,
        any_hit=any_hit, interpret=True)
    _assert_same(t, tid, jt, jid)
    t2, tid2 = tk.trace_tiles_inst(counts, keys, r3, *args)
    assert torch.equal(tid2, tid) and torch.equal(t2, t)


def _plane_stack(n_planes=20, alpha_first=False):
    """A flat tracer of n_planes clusters, each one quad (two triangles
    plus degenerate fillers) on the plane z = 1 + 0.01 k + x over
    x, y in [-1, 1]: every cluster AABB overlaps the others, so the
    front-to-back exit on entry t never fires for rays going +z, and
    plane 0 is the closest for all of them."""
    C = n_planes
    quad = np.array([[-1, -1, 0], [1, -1, 2], [1, 1, 2], [-1, 1, 0]],
                    np.float32)
    v0 = np.zeros((C, 128, 3), np.float32)
    e1 = np.zeros((C, 128, 3), np.float32)
    e2 = np.zeros((C, 128, 3), np.float32)
    for k in range(C):
        q = quad + np.array([0, 0, 1 + 0.01 * k], np.float32)
        v0[k] = q[0]
        e1[k, 0], e2[k, 0] = q[1] - q[0], q[2] - q[0]
        e1[k, 1], e2[k, 1] = q[2] - q[0], q[3] - q[0]
    corners = np.concatenate([v0, v0 + e1, v0 + e2], 1)
    opaque = np.ones(C, np.int32)
    opaque[0] = 0 if alpha_first else 1
    return tcl.tracer_from_numpy(dict(
        v0=v0, e1=e1, e2=e2, tri_valid=np.ones((C, 128), bool),
        to_orig=np.arange(C * 128, dtype=np.int32), cmin=corners.min(1),
        cmax=corners.max(1), n_clusters=C, opaque=opaque), CPU)


@pytest.mark.parametrize("alpha_first", [False, True],
                         ids=["opaque", "alpha-first"])
def test_any_hit_stops_at_opaque_hits(alpha_first):
    """Rays going +z through the plane stack: the closest-hit walk visits
    every step. The any-hit walk stops a tile once every ray holds a hit in
    an all-opaque cluster, so it takes one step and keeps plane 0's hit;
    when plane 0 is alpha-capable its hits do not end the walk, which then
    runs as far as the closest-hit walk and finds the same hits."""
    tracer = _plane_stack(alpha_first=alpha_first)
    rng = np.random.default_rng(9)
    o = np.zeros((128, 3), np.float32)
    o[:, :2] = rng.uniform(-0.5, 0.5, (128, 2))
    d = np.tile(np.array([[0, 0, 1]], np.float32), (128, 1))
    rays8 = _rays8(torch.from_numpy(o), torch.from_numpy(d), float("inf"))
    counts, keys, idmask = tcl._phase1_entry(tracer.cmin, tracer.cmax, rays8)
    r3 = rays8.reshape(-1, 32, 8)
    steps = [{}, {}]
    closest, anyh = (tk.trace_tiles_reference(
        counts, keys, r3, tracer.tris9, tracer.opaque, idmask, any_hit, st)
        for any_hit, st in zip((False, True), steps))
    assert bool((counts == 20).all()) and bool((closest[1] >= 0).all())
    assert steps[0]["steps"] == steps[0]["steps_total"] == 4 * 3
    assert torch.equal(closest[1] // 128, torch.zeros_like(closest[1]))
    assert torch.equal(anyh[1], closest[1])
    assert torch.equal(anyh[0], closest[0])
    assert steps[1]["steps"] == (4 * 3 if alpha_first else 4)


def _big_flat_tracer(n_clusters, seed=0, n_max=2198):
    """A flat tracer of the first n_clusters of n_max full clusters of
    small random triangles (built from arrays, skipping the SAH build)."""
    rng = np.random.default_rng(seed)
    T = n_max * 128
    v0 = rng.uniform(-20, 20, (T, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.3, (T, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.3, (T, 3)).astype(np.float32)
    C = n_clusters
    v0, e1, e2 = (x.reshape(n_max, 128, 3)[:C] for x in (v0, e1, e2))
    corners = np.concatenate([v0, v0 + e1, v0 + e2], 1)
    fields = dict(v0=v0, e1=e1, e2=e2, tri_valid=np.ones((C, 128), bool),
                  to_orig=np.arange(C * 128, dtype=np.int32),
                  cmin=corners.min(1), cmax=corners.max(1), n_clusters=C)
    return tcl.tracer_from_numpy(fields, CPU)


def test_large_scene_routes_to_trace_tiles(monkeypatch):
    """C <= 2,197 (tauray_tpu's vm_fits) keeps id-only keys and
    trace_tiles_vm3; one cluster more takes entry-t keys and trace_tiles,
    as _trace_padded_pallas dispatches. Both find the same hits."""
    calls = []
    for name in ("trace_tiles", "trace_tiles_vm3"):
        fn = getattr(tcl, name)
        monkeypatch.setattr(
            tcl, name, lambda *a, _n=name, _f=fn, **k:
            (calls.append(_n), _f(*a, **k))[1])
    assert tcl.VM_FITS_CLUSTERS == 2197
    o, d = _rand_rays(256, seed=8, spread=30.0)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    hits = []
    for C in (2197, 2198):
        tracer = _big_flat_tracer(C)
        assert tracer.tris9.shape == (C, 9, 1, 128)
        hits.append(tracer.trace(o, d, 0.0, float("inf"), need_uv=False))
    assert calls == ["trace_tiles_vm3", "trace_tiles"]
    # the 2,198-cluster scene holds the 2,197-cluster one plus a cluster:
    # wherever the smaller scene's hit is nearer than anything in the
    # extra cluster, both kernels report the same triangle. Their t comes
    # from two formulas (Baldwin-Weber (n.v0 - n.o) / (n.d) and
    # Möller-Trumbore f (e2 . q)) that round differently: 1e-4 relative.
    small, big = hits
    same = (small.tri_id == big.tri_id)
    assert float(same.float().mean()) > 0.95
    both = same & (small.tri_id >= 0)
    assert bool(both.any())
    np.testing.assert_allclose(small.t[both].numpy(), big.t[both].numpy(),
                               rtol=1e-4, atol=1e-4)
