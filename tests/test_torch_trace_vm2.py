"""K4/K5 of tauray_torch against tauray_tpu's, on the CPU: the plain
version of the front-to-back Baldwin-Weber traversal
(trace_kernel.trace_tiles_vm2_reference) against the real Pallas kernels
_kernel_vm2 (pallas_trace_tiles_vm2) and _kernel_vm (pallas_trace_tiles_vm)
run in interpret mode, and the flat tracer's route to it under
TAURAY_VM_KERNEL.

  * the kernels are fed ONE key row (the port's entry-t phase 1, which
    tests/test_torch_trace_mt.py holds equal to JAX's) and the same tris12
    and opacity tables; ids are identical in closest-hit and any-hit
    modes, the steps each tile walked (debug_steps) are equal, and t
    agrees within T_RTOL / T_ATOL: XLA:CPU contracts the Baldwin-Weber
    products into FMAs and torch on the CPU does not;
  * the scene has tiles of more than 120 active clusters, which send
    _kernel_vm2 to its overflow row (count + 8 > 128 keys), and tiles
    whose front-to-back exit fires.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauray_torch.ops import cluster as tcl
from tauray_torch.ops import trace_kernel as tk
from tauray_tpu.ops.pallas_trace import (KC, pallas_trace_tiles_vm,
                                         pallas_trace_tiles_vm2)

from test_instancing import _bake_world, _mesh, _transforms
from test_torch_trace_mt import _padded, _rays8

# the tests run in several worker processes at once: keep torch's
# intra-op pool small so they do not oversubscribe the cores
torch.set_num_threads(2)

CPU = torch.device("cpu")
T_RTOL = 1e-5
T_ATOL = 1e-5
N_INST = 60
R = 1024


@pytest.fixture(scope="module")
def scene():
    """60 instances of one 600-triangle mesh baked into a flat tracer of
    300 clusters (5 per instance); every fourth instance is alpha-capable,
    so its clusters are not opaque. 1,024 rays toward jittered triangle
    centroids: the first half one each from a random point inside the
    cloud (tiles of 150-200 active clusters), the second half 32-ray tiles
    sharing an origin outside it and a target (the exits fire); t_max
    finite for the any-hit runs."""
    mesh = _mesh(600)
    models = _transforms(N_INST, spread=6.0)
    world, tri_inst = _bake_world(mesh, models)
    opaque = np.arange(N_INST) % 4 != 3
    flat, _ = tcl.build_cluster_tracer(world, tri_inst,
                                       tri_opaque=opaque[tri_inst],
                                       strategy="per-material", device=CPU)
    rng = np.random.default_rng(4)
    half = R // 2
    o = rng.uniform(-6, 6, (R, 3)).astype(np.float32)
    far = rng.standard_normal((half // 32, 3))
    far *= 11.0 / np.linalg.norm(far, axis=1, keepdims=True)
    o[half:] = np.repeat(far, 32, axis=0)
    pick = rng.integers(0, len(world), R)
    pick[half:] = np.repeat(pick[half::32], 32)
    target = world[pick].mean(1) + rng.normal(0, 0.3, (R, 3)) * \
        np.where(np.arange(R) < half, 1.0, 0.05)[:, None]
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(2.0, 16.0, R).astype(np.float32)
    return flat, torch.from_numpy(o), torch.from_numpy(d), tmax


def _wave(flat, o, d, tmax, any_hit):
    rays8 = _rays8(o, d, tmax if any_hit else float("inf"))
    counts, keys, idmask = tcl._phase1_entry(flat.cmin, flat.cmax, rays8)
    r3 = rays8.reshape(-1, 32, 8)
    jr = r3.numpy()
    jrays = (jnp.asarray(jr[..., 0:3]), jnp.asarray(jr[..., 3:6]),
             jnp.asarray(jr[..., 6:8]))
    return counts, keys, idmask, r3, jrays


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("entry", ["vm2", "vm"])
def test_plain_k4_matches_pallas_kernels_interpret(scene, any_hit, entry):
    """trace_tiles_vm2_reference vs _kernel_vm2 (K4) and _kernel_vm (K5)
    in interpret mode: ids equal, t within T_RTOL / T_ATOL, and the
    per-tile steps of debug_steps equal."""
    flat, o, d, tmax = scene
    counts, keys, idmask, r3, jrays = _wave(flat, o, d, tmax, any_hit)
    C = flat.n_clusters
    assert not bool(flat.opaque.all()) and bool(flat.opaque.any())
    # tiles on _kernel_vm2's overflow branch and on its head branch
    assert int(counts.max()) + tk.KB > KC and int(counts.min()) + tk.KB <= KC
    stats = {}
    t, tid, steps = tk.trace_tiles_vm2_reference(
        counts, keys, r3, flat.tris12, flat.opaque, idmask, any_hit, stats)
    cpad, kp, opq = _padded(keys.numpy(), C, flat.opaque.numpy())
    pallas = pallas_trace_tiles_vm2 if entry == "vm2" else \
        pallas_trace_tiles_vm
    jargs = (jnp.asarray(counts.numpy()), kp, *jrays,
             jnp.asarray(flat.tris12.numpy()), opq, C, cpad, idmask)
    jt, jid = pallas(*jargs, any_hit=any_hit, interpret=True)
    jid = np.asarray(jid)
    jt = np.asarray(jt)
    np.testing.assert_array_equal(tid.numpy(), jid)
    assert (jid >= 0).sum() > R // 2 and (jid < 0).sum() > 0
    np.testing.assert_array_equal(np.isinf(t.numpy()), np.isinf(jt))
    fin = np.isfinite(jt)
    np.testing.assert_allclose(t.numpy()[fin], jt[fin], rtol=T_RTOL,
                               atol=T_ATOL)
    jsteps, jcounts = pallas(*jargs, any_hit=any_hit, interpret=True,
                             debug_steps=True)
    np.testing.assert_array_equal(np.asarray(jcounts), counts.numpy())
    np.testing.assert_array_equal(np.asarray(jsteps), steps.numpy())
    assert int(steps.sum()) == stats["steps"]
    # the front-to-back exit skipped steps on this wave
    assert stats["steps"] < stats["steps_total"]
    # the wrappers take the plain version for CPU tensors
    args = (counts, keys, r3, flat.tris12, flat.opaque, idmask, any_hit)
    t2, tid2 = tk.trace_tiles_vm2(*args)
    t3, tid3, steps3 = tk.trace_tiles_vm(*args, debug_steps=True)
    assert torch.equal(tid2, tid) and torch.equal(t2, t)
    assert torch.equal(tid3, tid) and torch.equal(t3, t)
    assert torch.equal(steps3, steps)
    assert len(tk.trace_tiles_vm(*args)) == 2


def test_plain_k4_steps_on_plane_stack():
    """The plane stack of tests/test_torch_trace_mt.py (20 clusters whose
    AABBs all overlap, plane 0 nearest): closest hit walks all 3 steps of
    every tile; any hit stops each tile after its first step."""
    from test_torch_trace_mt import _plane_stack
    tracer = _plane_stack()
    rng = np.random.default_rng(9)
    o = np.zeros((128, 3), np.float32)
    o[:, :2] = rng.uniform(-0.5, 0.5, (128, 2))
    d = np.tile(np.array([[0, 0, 1]], np.float32), (128, 1))
    rays8 = _rays8(torch.from_numpy(o), torch.from_numpy(d), float("inf"))
    counts, keys, idmask = tcl._phase1_entry(tracer.cmin, tracer.cmax, rays8)
    args = (counts, keys, rays8.reshape(-1, 32, 8), tracer.tris12,
            tracer.opaque, idmask)
    closest = tk.trace_tiles_vm(*args, False, debug_steps=True)
    anyh = tk.trace_tiles_vm(*args, True, debug_steps=True)
    assert bool((counts == 20).all()) and bool((closest[1] >= 0).all())
    assert closest[2].tolist() == [3] * 4 and anyh[2].tolist() == [1] * 4
    assert torch.equal(anyh[1], closest[1])
    assert torch.equal(closest[1] // 128, torch.zeros_like(closest[1]))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_vm_kernel_v2_routes_to_plain_k4(scene, monkeypatch, any_hit):
    """Under TAURAY_VM_KERNEL=v2 the flat tracer's _trace_padded takes
    entry-t keys and trace_tiles_vm2 (K4) instead of trace_tiles_vm3
    (K1), as tauray_tpu's _trace_padded_pallas does; the variable is read
    at trace time. Hits and misses equal the default path's (any-hit ids
    may differ under the exit), and closest-hit ids equal them too."""
    flat, o, d, tmax = scene
    calls = []
    for name in ("trace_tiles_vm2", "trace_tiles_vm3", "trace_tiles"):
        fn = getattr(tcl, name)
        monkeypatch.setattr(
            tcl, name, lambda *a, _n=name, _f=fn, **k:
            (calls.append(_n), _f(*a, **k))[1])
    rays8 = _rays8(o, d, tmax if any_hit else float("inf"))
    default = tcl._trace_padded(flat, rays8, any_hit, need_uv=True)
    monkeypatch.setenv("TAURAY_VM_KERNEL", "v2")
    v2 = tcl._trace_padded(flat, rays8, any_hit, need_uv=True)
    monkeypatch.setenv("TAURAY_VM_KERNEL", "v3")
    v3 = tcl._trace_padded(flat, rays8, any_hit, need_uv=True)
    assert calls == ["trace_tiles_vm3", "trace_tiles_vm2", "trace_tiles_vm3"]
    assert torch.equal(v3.tri_id, default.tri_id)
    assert torch.equal(v2.tri_id >= 0, default.tri_id >= 0)
    assert int((v2.tri_id >= 0).sum()) > R // 2
    if not any_hit:
        # the same Baldwin-Weber arithmetic on the same table
        assert torch.equal(v2.tri_id, default.tri_id)
        assert torch.equal(v2.t, default.t)
