"""The tie rules of the traversal kernels, on the CPU: on a scene built so
that hits tie exactly (the same quad in several clusters and twice in one,
nothing else near it), the plain K1 (trace_tiles_vm3_reference) against
_kernel_vm3, the plain K4 (trace_tiles_vm2_reference) against _kernel_vm2,
the plain K2 (trace_tiles_reference) against _kernel, and, on the same
clusters under two instances, the plain K3 (trace_tiles_inst_reference)
against _kernel_inst, every Pallas kernel in interpret mode.

Duplicates tie in both frameworks, since each computes the same rows with
the same operations, so ids must be exactly equal: K1 gives a tie to the
lowest slot id (its walk is in ascending cluster order), K2-K4 to the
first key position of the step in entry-t order, which puts the tie
clusters whose entry t was pulled forward ahead of lower ids. These are
the rules the card's split-walk combine (csrc/trace_tiles.cu) reproduces.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauray_torch.app.kernel_waves import (tie_rays, tie_stack,
                                           tie_stack_instanced)
from tauray_torch.ops import cluster as tcl
from tauray_torch.ops import trace_kernel as tk
from tauray_tpu.ops.pallas_trace import (pallas_trace_tiles,
                                         pallas_trace_tiles_inst,
                                         pallas_trace_tiles_vm2,
                                         pallas_trace_tiles_vm3)

from test_torch_trace_mt import _padded

torch.set_num_threads(2)

CPU = torch.device("cpu")
# t within the tolerance of the other CPU tests (XLA:CPU contracts the
# Baldwin-Weber and Möller-Trumbore products into FMAs, torch does not);
# ids exact
T_RTOL = 1e-5
T_ATOL = 1e-5
N_TILES = 32        # a multiple of the Pallas grid step (32 tiles)


@pytest.fixture(scope="module")
def ties():
    tracer = tie_stack(CPU)
    rays8 = torch.from_numpy(tie_rays(N_TILES))
    return tracer, rays8


def _assert_t_close(t, jt):
    jt = np.asarray(jt)
    np.testing.assert_array_equal(np.isinf(t.numpy()), np.isinf(jt))
    fin = np.isfinite(jt)
    np.testing.assert_allclose(t.numpy()[fin], jt[fin], rtol=T_RTOL,
                               atol=T_ATOL)


def _tied(tid):
    """The ids of the tiles aimed at the tied quads (tie_rays' first kind,
    every fourth tile)."""
    return tid.reshape(N_TILES, 32)[0::4].reshape(-1)


def test_plain_k1_ties_match_kernel_vm3(ties):
    tracer, rays8 = ties
    counts, keys = tcl._phase1(tracer, rays8)
    C = tracer.n_clusters
    cpad = 1024 * (-(-(C + tk.KB) // 1024))
    kp = np.full((keys.shape[0], cpad), 0x7FFFFFFF, np.int32)
    kp[:, :C] = keys.numpy()
    idmask = (1 << max(int(np.ceil(np.log2(max(C, 2)))), 1)) - 1
    r3 = rays8.reshape(-1, 32, 8)
    jt, jid = pallas_trace_tiles_vm3(
        jnp.asarray(counts.numpy()), jnp.asarray(kp), jnp.asarray(r3.numpy()),
        jnp.asarray(tracer.tris12.numpy()), C, cpad, idmask, interpret=True)
    t, tid = tk.trace_tiles_vm3_reference(counts, keys, r3, tracer.tris12)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    _assert_t_close(t, jt)
    # counts 0, 1 and more on one wave; every tied ray takes cluster 0's
    # first copy (slot 0 or 1), the lowest slot id among 20 equal hits
    assert {0, 1}.issubset(set(counts.tolist())) and int(counts.max()) > 8
    tied = _tied(tid)
    assert bool((tied >= 0).all()) and bool((tied <= 1).all())


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_plain_k4_ties_match_kernel_vm2(ties, any_hit):
    tracer, rays8 = ties
    counts, keys, idmask = tcl._phase1_entry(tracer.cmin, tracer.cmax, rays8)
    C = tracer.n_clusters
    r3 = rays8.reshape(-1, 32, 8)
    cpad, kp, opq = _padded(keys.numpy(), C, tracer.opaque.numpy())
    jr = r3.numpy()
    jt, jid = pallas_trace_tiles_vm2(
        jnp.asarray(counts.numpy()), kp, jnp.asarray(jr[..., 0:3]),
        jnp.asarray(jr[..., 3:6]), jnp.asarray(jr[..., 6:8]),
        jnp.asarray(tracer.tris12.numpy()), opq, C, cpad, idmask,
        any_hit=any_hit, interpret=True)
    t, tid, steps = tk.trace_tiles_vm2_reference(
        counts, keys, r3, tracer.tris12, tracer.opaque, idmask, any_hit)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    _assert_t_close(t, jt)
    # the tie goes to the first key in entry-t order: cluster 3, whose
    # degenerate triangle at z = 0.53 puts it ahead of cluster 0
    tied = _tied(tid)
    assert bool((tied // tk.CLUSTER == 3).all())
    assert bool(((tied % tk.CLUSTER) <= 7).all())
    assert int(steps.max()) == 2 and int(steps.min()) == 0


def _entry_wave(tracer, rays8):
    """Entry-t phase 1 on rays8: the plain version's (counts, keys,
    idmask, tiles) and the Pallas kernels' padded keys and opacities and
    split rays."""
    counts, keys, idmask = tcl._phase1_entry(tracer.cmin, tracer.cmax, rays8)
    r3 = rays8.reshape(-1, 32, 8)
    cpad, kp, opq = _padded(keys.numpy(), tracer.n_clusters,
                            tracer.opaque.numpy())
    jr = r3.numpy()
    jrays = (jnp.asarray(jr[..., 0:3]), jnp.asarray(jr[..., 3:6]),
             jnp.asarray(jr[..., 6:8]))
    return counts, keys, idmask, r3, (jnp.asarray(counts.numpy()), kp,
                                      *jrays), cpad, opq


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_plain_k2_ties_match_kernel(ties, any_hit):
    tracer, rays8 = ties
    C = tracer.n_clusters
    counts, keys, idmask, r3, jargs, cpad, opq = _entry_wave(tracer, rays8)
    jt, jid = pallas_trace_tiles(
        *jargs, jnp.asarray(tracer.tris9.numpy()), opq, C, cpad, idmask,
        any_hit=any_hit, interpret=True)
    stats = {}
    t, tid = tk.trace_tiles_reference(counts, keys, r3, tracer.tris9,
                                      tracer.opaque, idmask, any_hit, stats)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    _assert_t_close(t, jt)
    # K4's rule over the Möller-Trumbore rows: cluster 3 first
    tied = _tied(tid)
    assert bool((tied // tk.CLUSTER == 3).all())
    assert bool(((tied % tk.CLUSTER) <= 7).all())
    steps = stats["tile_steps"]
    assert int(steps.max()) == 2 and int(steps.min()) == 0


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_plain_k3_ties_match_kernel_inst(ties, any_hit):
    """The tie clusters under two instances, the second moved in front of
    the first: ties within an instance go to the first key position in
    entry-t order, across the instances' interleaved keys."""
    _, rays8 = ties
    tracer = tie_stack_instanced(CPU)
    K = tracer.n_clusters
    counts, keys, idmask, r3, jargs, cpad, opq = _entry_wave(tracer, rays8)
    inv12 = tracer.inv.reshape(-1, 12)
    kpad = 1024 * (-(-K // 1024))
    kcl = np.zeros(kpad, np.int32)
    kcl[:K] = tracer.k_cluster.numpy()
    kin = np.zeros(kpad, np.int32)
    kin[:K] = tracer.k_inst.numpy()
    ipad = np.zeros((8, 12), np.float32)
    ipad[:inv12.shape[0]] = inv12.numpy()
    jt, jid = pallas_trace_tiles_inst(
        *jargs, jnp.asarray(tracer.tris9.numpy()), opq, jnp.asarray(kcl),
        jnp.asarray(kin), jnp.asarray(ipad.reshape(-1)), K, cpad, idmask,
        any_hit=any_hit, interpret=True)
    t, tid = tk.trace_tiles_inst_reference(
        counts, keys, r3, tracer.tris9, tracer.opaque, tracer.k_cluster,
        tracer.k_inst, inv12, idmask, any_hit)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    _assert_t_close(t, jt)
    # instance 1's copy of cluster 3 (cluster-instance C + 3), whose
    # degenerate triangle enters first
    tied = _tied(tid)
    assert bool((tied // tk.CLUSTER == K // 2 + 3).all())
    assert bool(((tied % tk.CLUSTER) <= 7).all())


@pytest.mark.parametrize("kernel,w_2e18", [
    ("trace_vm3", 8), ("trace_vm2", 4), ("trace_vm", 4), ("trace_mt", 4),
    ("trace_mt_inst", 4)], ids=["K1", "K4", "K5", "K2", "K3"])
def test_bw_warps_rule(kernel, w_2e18):
    """W per launch on 132 SMs: 8 warps a tile for the 32,768-ray alpha
    re-traces, 4 for 2^20-ray waves; on 2^18-ray waves w_2e18 (8 for K1,
    4 for the front-to-back kernels); always one of the kernel's
    instances."""
    assert tk.bw_warps(1024, 132, kernel) == 8           # 32,768 rays
    assert tk.bw_warps(8192, 132, kernel) == w_2e18      # 2^18 rays
    assert tk.bw_warps(32768, 132, kernel) == 4          # 2^20 rays
    assert all(tk.bw_warps(n, sm, kernel) in tk.BW_WARPS
               for n in (1, 100, 10**4, 10**6) for sm in (1, 114, 132))
