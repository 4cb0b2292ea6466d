"""The K1 labs (tauray_torch/lab/) against the TPU lab scripts they port,
scripts/kernel_lab8.py to kernel_lab11.py, on the CPU: the same seeded
numpy inputs go through each script's Pallas kernel in interpret mode
(pl.pallas_call patched to interpret=True inside the test; no file
changes) and through the lab's plain torch version, which the wrappers
take for CPU tensors.

Tolerances: L8 is exact (sums in the script's order, no products). The
Baldwin-Weber modes hold t within 1e-5, relative and absolute, the
tolerance of tests/test_torch_trace_mt.py (XLA:CPU contracts the products
into FMAs, torch does not: one ray of L10's wave differs by 1.43e-5 at
t = 0.5), and ids exactly; L11 mxu holds t within 1e-5
of |t| (at least 1) and ids equal except at exact ties of t, by
kernel_lab11.mxu_agreement, the rule chip_smoke holds the card to (here
no ray needs its FP64 rule for ill-conditioned rays)."""

import contextlib
import functools
import importlib.util
import io
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tauray_torch.app.kernel_waves import kernel_waves, retrace_slice
from tauray_torch.lab import common, kernel_lab8, kernel_lab9, \
    kernel_lab10, kernel_lab11, lab_kernel
from tauray_torch.ops import trace_kernel as tk

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"
CPU = torch.device("cpu")
SMALL = "proc://sponza?tris=8192"
T_TOL = 1e-5
N_TILES = 64


def _script(name, monkeypatch):
    """scripts/<name>.py as a module, its Pallas kernels in interpret
    mode."""
    monkeypatch.syspath_prepend(str(SCRIPTS))
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location(
        f"_lab_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_close(got, want, rtol=T_TOL, atol=T_TOL):
    """Raw (n_tiles, 32, 2) blocks: ids exact, t within the tolerance."""
    got = got.numpy()
    want = np.asarray(want)
    np.testing.assert_array_equal(got[..., 1].view(np.int32),
                                  want[..., 1].view(np.int32))
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def small_tracer():
    return common.scene_tracer(CPU, SMALL)


@pytest.fixture(scope="module")
def small_wave(small_tracer):
    """A signature-sorted bounce wave of 2,048 rays of the small scene, as
    kernel_lab10 takes it."""
    tracer, waves = kernel_waves(CPU, scene=SMALL, size=64)
    rays8 = retrace_slice(waves["bounce"], 2048)
    return tracer, kernel_lab10.wave_args(tracer, rays8)


# ---------------------------------------------------------------------------
# L8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("count", [0, 8, 16])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_lab8_matches_script(monkeypatch, mode, count):
    kl8 = _script("kernel_lab8", monkeypatch)
    o3, d3, mm2, _ = common.lab8_inputs(N_TILES * 32, seed=3)
    heads = np.random.default_rng(4).integers(
        -50, 1000, (N_TILES, common.KC)).astype(np.int32)
    counts = np.full(N_TILES, count, np.int32)
    counts[::5] = 0
    want = kl8.run_mode(jnp.asarray(counts), jnp.asarray(heads),
                        jnp.asarray(o3), jnp.asarray(d3), jnp.asarray(mm2),
                        mode)
    got = kernel_lab8.lab8(*map(_t, (counts, heads, o3, d3, mm2)), mode)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


def test_lab8_inputs_are_the_scripts(monkeypatch):
    """main's seeded inputs, captured from the script's own main with its
    kernel replaced, equal common.lab8_inputs bit for bit."""
    kl8 = _script("kernel_lab8", monkeypatch)
    seen = []

    def fake(counts, heads, o3, d3, mm2, mode):
        seen.append((np.asarray(heads), np.asarray(o3), np.asarray(d3),
                     np.asarray(mm2)))
        return jnp.zeros((1,))
    monkeypatch.setattr(kl8, "run_mode", fake)
    with contextlib.redirect_stdout(io.StringIO()):
        kl8.main()
    o3, d3, mm2, heads = common.lab8_inputs()
    for got, want in zip(seen[0], (heads, o3, d3, mm2)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# L9
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "exit", "loads", "math", "nocat"])
def test_lab9_matches_script(monkeypatch, small_tracer, mode):
    kl9 = _script("kernel_lab9", monkeypatch)
    tris12 = small_tracer.tris12
    C = small_tracer.n_clusters
    o3, d3, mm2, heads = common.lab9_inputs(C, N_TILES * 32, seed=5)
    for count in (8, 16, 32):
        counts = np.full(N_TILES, count, np.int32)
        want = kl9.run_mode(jnp.asarray(counts), jnp.asarray(heads),
                            jnp.asarray(o3), jnp.asarray(d3),
                            jnp.asarray(mm2), jnp.asarray(tris12.numpy()),
                            mode)
        got = kernel_lab9.lab9(*map(_t, (counts, heads, o3, d3, mm2)),
                               tris12, mode)
        _assert_close(got, want)
        if mode in ("full", "nocat"):
            assert (got[..., 1].view(torch.int32) >= 0).any()


def test_lab9_full_and_nocat_agree(small_tracer):
    """The concatenated step and the 8 per-cluster minima compute one
    function; the exit never fires on rays with t_max 1e30 and t > 0."""
    C = small_tracer.n_clusters
    o3, d3, mm2, heads = map(_t, common.lab9_inputs(C, N_TILES * 32, seed=6))
    counts = torch.full((N_TILES,), 32, dtype=torch.int32)
    outs = {m: kernel_lab9.lab9(counts, heads, o3, d3, mm2,
                                small_tracer.tris12, m)
            for m in ("full", "nocat", "exit")}
    assert torch.equal(outs["full"].view(torch.int32),
                       outs["nocat"].view(torch.int32))
    stats = {}
    kernel_lab9.lab9_reference(counts, heads, o3, d3, mm2,
                               small_tracer.tris12, "exit", stats)
    assert stats["steps"] == 4 * N_TILES
    assert kernel_lab9.lab9_exits(outs["exit"], C) == 0


def test_lab9_inputs_are_the_scripts(monkeypatch):
    """main's rays and heads, captured from the script's own main (its
    captured-table file and tracer replaced by a stub of C = 2,116
    clusters), equal common.lab9_inputs bit for bit."""
    kl9 = _script("kernel_lab9", monkeypatch)
    C = 2116

    class Stub:
        n_clusters = C
        tris12 = jnp.zeros((1,))
    seen = []

    def fake(counts, heads, o3, d3, mm2, tris12, mode):
        seen.append((np.asarray(heads), np.asarray(o3), np.asarray(d3),
                     np.asarray(mm2)))
        return jnp.zeros((1, 1, 2))
    monkeypatch.setattr(kl9.np, "load", lambda path: {
        "tri_pos": None, "tri_instance": None})
    monkeypatch.setattr(kl9, "build_cluster_tracer", lambda *a: (Stub, None))
    monkeypatch.setattr(kl9, "run_mode", fake)
    with contextlib.redirect_stdout(io.StringIO()):
        kl9.main()
    o3, d3, mm2, heads = common.lab9_inputs(C)
    for got, want in zip(seen[0], (heads, o3, d3, mm2)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# The redesigned kernel (csrc/k1_lab.cu lab9_kernel): R rays a lane, the
# step's triangles split over R workers, their bests combined by (t, slot)

def _bw_rows(v0, e1, e2):
    """Baldwin-Weber rows (m, 12) [n | n.v0 | r1 | r1.v0 | r2 | r2.v0] of
    the triangles (v0, v0 + e1, v0 + e2), built as
    common.lab11_inputs builds them."""
    n = np.cross(e1, e2)
    inv = 1.0 / (n * n).sum(-1, keepdims=True)
    r1 = np.cross(e2, n) * inv
    r2 = np.cross(n, e1) * inv

    def dv(x):
        return (x * v0).sum(-1, keepdims=True)
    return np.concatenate([n, dv(n), r1, dv(r1), r2, dv(r2)],
                          -1).astype(np.float32)


def _dup_scene(seed=11, n_clusters=24, n_tiles=16):
    """A table with exact duplicate triangles and rays aimed at them: (v0,
    e1, e2) (C * 128, 3) each, the tiles' heads and o3, d3, mm2. Cluster 1
    copies cluster 0, and in cluster 0 lane 2 copies lane 0 (one quad, one
    worker) and quad 1 copies quad 0 (two workers); every tile's slot 1
    names cluster 1 (a duplicate in the step) and slot 8 cluster 0 (across
    steps). Half the rays aim at a triangle of cluster 0's first quads;
    some rays are NaN and some have t_max < t_min."""
    rng = np.random.default_rng(seed)
    m = n_clusters * common.CLUSTER
    v0 = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    e1 = rng.uniform(-0.5, 0.5, (m, 3)).astype(np.float32)
    e2 = rng.uniform(-0.5, 0.5, (m, 3)).astype(np.float32)
    for x in (v0, e1, e2):
        x[2] = x[0]
        x[4:8] = x[0:4]
        x[128:256] = x[0:128]
    heads = rng.integers(0, n_clusters, (n_tiles, common.KC)).astype(np.int32)
    heads[:, 0] = 0
    heads[:, 1] = 1
    heads[:, 8] = 0
    n = n_tiles * 32
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 2] += 4.0
    tgt = rng.integers(0, 8, n)
    w = rng.uniform(0.1, 0.4, (n, 2))
    hit = v0[tgt] + w[:, :1] * e1[tgt] + w[:, 1:] * e2[tgt]
    d = np.where(rng.random((n, 1)) < 0.5, hit - o,
                 rng.standard_normal((n, 3))).astype(np.float32)
    mm = np.stack([np.zeros(n), np.full(n, 1e30)], -1).astype(np.float32)
    o[5::97] = np.nan
    mm[7::89] = (1.0, 0.5)
    return (v0, e1, e2), heads, (o.reshape(n_tiles, 32, 3),
                                 d.reshape(n_tiles, 32, 3),
                                 mm.reshape(n_tiles, 32, 2))


def _dup_lab9(seed=11):
    (v0, e1, e2), heads, (o3, d3, mm2) = _dup_scene(seed)
    C = v0.shape[0] // common.CLUSTER
    tris12 = np.ascontiguousarray(np.swapaxes(
        _bw_rows(v0, e1, e2).reshape(C, common.CLUSTER, 12), 1, 2)[
            :, :, None, :])
    return tuple(map(_t, (heads, o3, d3, mm2, tris12)))


def _first_min(t, slot):
    """Per row of (..., W) candidates: the smallest t, then the smallest
    slot (inf / a large slot where a worker has none)."""
    best = t.min(-1, keepdim=True).values
    s = torch.where(t == best, slot, 1 << 30).min(-1).values
    return best[..., 0], s


def workers_lab9(counts, heads, o3, d3, mm2, tris12, mode, R):
    """A plain torch model of lab9_kernel's work split (unfused body):
    lane l of worker l // (32 / R) holds rays l % (32 / R) + k (32 / R);
    worker w takes the quads q = w (mod R) of each cluster, keeps the
    first smallest hit (strict <) from the best before the step (nocat:
    from the running best), and the workers' bests meet by smallest t, then
    smallest slot, after each step (nocat: after each cluster). Returns
    what lab9 returns."""
    lanes = 32 // R
    ray_of = (torch.arange(lanes)[:, None] + lanes * torch.arange(R)).T
    assert sorted(ray_of.reshape(-1).tolist()) == list(range(32))
    n_tiles, C = counts.shape[0], tris12.shape[0]
    rows = tris12.reshape(C, 12, common.CLUSTER)
    worker = torch.arange(common.CLUSTER) // 4 % R
    bt = torch.where(mm2[..., 1] > common.BIG, common.BIG, mm2[..., 1])
    bi = torch.full((n_tiles, 32), -1, dtype=torch.int32)
    steps = (counts.long() + 7) // 8
    walking = steps > 0
    inf = torch.tensor(float("inf"))
    for s in range(int(steps.max())):
        act = torch.nonzero(walking & (steps > s)).squeeze(1)
        slots = (s * 8 + torch.arange(8)).clamp(max=common.KC - 1)
        orders = (heads[act][:, slots] & 1023).clamp(max=C - 1).long()
        src = torch.zeros_like(orders) if mode == "math" else orders
        o, d, tmin = o3[act], d3[act], mm2[act][..., 0]
        ct, cs = bt[act].clone(), torch.full_like(bi[act], -1)
        groups = [range(8)] if mode != "nocat" else [[j] for j in range(8)]
        for js in groups:
            per_w = []
            for w in range(R):
                mine = worker == w
                cols = [(j, lane) for j in js
                        for lane in torch.nonzero(mine).squeeze(1).tolist()]
                slot = torch.tensor([j * 128 + ln for j, ln in cols])
                tri = rows[src[:, [j for j, _ in cols]], :,
                           torch.tensor([ln for _, ln in cols])]
                hit, tt = kernel_lab9._hit(
                    [tri[:, None, :, i] for i in range(12)], o, d, tmin, ct)
                t_w, a = torch.where(hit, tt, inf).min(dim=2)
                per_w.append((t_w, torch.where(t_w < inf, slot[a], 1 << 30)))
            t_c, s_c = _first_min(torch.stack([x[0] for x in per_w], -1),
                                  torch.stack([x[1] for x in per_w], -1))
            closer = t_c < ct
            ct = torch.where(closer, t_c, ct)
            cs = torch.where(closer, s_c.int(), cs)
        win = torch.gather(orders, 1, (cs.clamp(min=0) // 128).long())
        got = cs >= 0
        bt[act] = torch.where(got, ct, bt[act])
        bi[act] = torch.where(got, (win * 128 + cs.clamp(min=0) % 128).int(),
                              bi[act])
        if mode == "exit":
            nk = heads[act, min((s + 1) * 8, common.KC - 1)] & ~1023
            walking[act] = ~(bt[act].view(torch.int32) <= nk[:, None]).all(1)
    return torch.stack([bt, bi.view(torch.float32)], -1)


@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("mode", ["full", "exit", "math", "nocat"])
def test_lab9_worker_split_matches_reference(mode, R):
    """The model of the card's R-worker split and (t, slot) combine equals
    lab9_reference bit for bit on exact duplicate triangles within a quad,
    across workers, within a step and across steps, on NaN rays and rays
    with t_max < t_min, at uneven counts."""
    heads, o3, d3, mm2, tris12 = _dup_lab9()
    counts = torch.tensor([0, 3, 8, 9, 16, 17, 24, 32] * 2,
                          dtype=torch.int32)
    want = kernel_lab9.lab9_reference(counts, heads, o3, d3, mm2, tris12,
                                      mode)
    got = workers_lab9(counts, heads, o3, d3, mm2, tris12, mode, R)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ids = want[..., 1].view(torch.int32)
    # the duplicates win: cluster 0's quads 0 and 1 and cluster 1's
    assert int(((ids >= 0) & (ids < 256) & (ids % 128 < 8)).sum()) >= 20


def _lab9_fma(monkeypatch, *args):
    """lab9_reference with the card's FMA body (common.bw_test_fma)."""
    monkeypatch.setattr(kernel_lab9, "_bw_test", common.bw_test_fma)
    try:
        return kernel_lab9.lab9_reference(*args)
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("mode", ["full", "math", "nocat"])
def test_lab9_agreement_holds_the_fma_body(monkeypatch, small_tracer, mode):
    """The FMA body's results (emulated in FP64) meet lab9_agreement
    against the plain version on the script's kind of rays over the small
    scene and on the duplicate scene, with t off by at most 1/2 of its
    bound."""
    C = small_tracer.n_clusters
    o3, d3, mm2, heads = map(_t, common.lab9_inputs(C, 256 * 32, seed=8))
    cases = [(heads, o3, d3, mm2, small_tracer.tris12), _dup_lab9(12)]
    for heads, o3, d3, mm2, tris12 in cases:
        counts = torch.full((heads.shape[0],), 32, dtype=torch.int32)
        args = (counts, heads, o3, d3, mm2, tris12, mode)
        ref = kernel_lab9.lab9_reference(*args)
        fma = _lab9_fma(monkeypatch, *args)
        agree = kernel_lab9.lab9_agreement(fma, ref, o3, d3, mm2, tris12,
                                           mode)
        assert agree["ok"] and agree["max_t_over_bound"] <= 0.5, agree


def test_lab9_agreement_rules():
    """lab9_agreement accepts a t one ulp off and a tie swap (the same
    triangle's copy in cluster 1), and refuses a wrong id and a t off by
    more than its bound."""
    heads, o3, d3, mm2, tris12 = _dup_lab9()
    counts = torch.full((heads.shape[0],), 16, dtype=torch.int32)
    ref = kernel_lab9.lab9_reference(counts, heads, o3, d3, mm2, tris12,
                                     "full")

    def hold(out):
        return kernel_lab9.lab9_agreement(out, ref, o3, d3, mm2, tris12,
                                          "full")
    assert hold(ref)["ok"]
    flat = ref.reshape(-1, 2)
    ids = flat[:, 1].view(torch.int32)
    dup = int(torch.nonzero((ids >= 0) & (ids < 128)).reshape(-1)[0])
    hit = int(torch.nonzero((ids >= 0) & (flat[:, 0] > 0.5)).reshape(-1)[0])

    def moved(i, t=None, id_=None):
        out = flat.clone()
        if t is not None:
            out[i, 0] = t
        if id_ is not None:
            out[i, 1] = torch.tensor([id_], dtype=torch.int32).view(
                torch.float32)
        return out.reshape(ref.shape)
    a = hold(moved(hit, t=float(np.nextafter(np.float32(flat[hit, 0]),
                                             np.float32(np.inf)))))
    assert a["ok"] and a["t_bits_differ"] == 1
    a = hold(moved(dup, id_=int(ids[dup]) + 128))
    assert a["ok"] and a["ties"] == 1 and a["ill_conditioned"] == 0
    a = hold(moved(hit, id_=(int(ids[hit]) + 37) % (128 * 24)))
    assert not a["ok"] and a["rays_off"] == 1
    c, lane = int(ids[hit]) // 128, int(ids[hit]) % 128
    f = common.bw_fp64(tris12[c, :, 0, lane][None], o3.reshape(-1, 3)[[hit]],
                       d3.reshape(-1, 3)[[hit]], mm2.reshape(-1, 2)[[hit], 0])
    a = hold(moved(hit, t=float(flat[hit, 0] + 4 * f["b_t"][0])))
    assert not a["ok"] and a["rays_off"] == 1 and a["max_t_over_bound"] > 1


# ---------------------------------------------------------------------------
# L10
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "noray", "fixord", "nowrite"])
def test_lab10_matches_script(monkeypatch, small_wave, mode):
    kl10 = _script("kernel_lab10", monkeypatch)
    tracer, (counts, keys, r3, idmask) = small_wave
    C = tracer.n_clusters
    # the script reads its heads (the first 128 keys) only: every tile
    # here has fewer clusters, where that equals the whole row
    assert 0 < int(counts.max()) <= common.KC
    # tiles with no cluster: one inside the first group, its last four
    # (the group's last active tile is then its 28th), and the whole
    # second group
    counts = counts.clone()
    counts[5] = 0
    counts[28:] = 0
    cpad = 1024 * (-(-(C + tk.KB) // 1024))
    kp = np.full((keys.shape[0], cpad), 0x7FFFFFFF, np.int32)
    kp[:, :C] = keys.numpy()
    jr = r3.numpy()
    want = kl10.run_mode(
        jnp.asarray(counts.numpy()), jnp.asarray(kp),
        jnp.asarray(jr[..., 0:3]), jnp.asarray(jr[..., 3:6]),
        jnp.asarray(jr[..., 6:8]), jnp.asarray(tracer.tris12.numpy()), mode,
        C, cpad, idmask)
    got = kernel_lab10.lab10(counts, keys, r3, tracer.tris12, mode, idmask)
    _assert_close(got, want)


def test_lab10_full_is_k1(small_wave):
    """full equals K1's plain version bit for bit (t where it hits, +inf
    against the pre-set best where it misses), a tile walking every one of
    the scene's clusters (past the script's 128 heads) included."""
    tracer, (counts, keys, r3, idmask) = small_wave
    counts, keys = counts.clone(), keys.clone()
    C = tracer.n_clusters
    counts[3] = C
    keys[3] = torch.arange(C, dtype=torch.int32)
    out = kernel_lab10.lab10(counts, keys, r3, tracer.tris12, "full", idmask)
    t, tid = tk.trace_tiles_vm3_reference(counts, keys, r3, tracer.tris12)
    ids = out[..., 1].reshape(-1).view(torch.int32)
    assert torch.equal(ids, tid)
    t_lab = torch.where(ids < 0, float("inf"), out[..., 0].reshape(-1))
    assert torch.equal(t_lab.view(torch.int32), t.view(torch.int32))
    assert bool((tid.reshape(-1, 32)[3] >= 0).any())


# The redesigned kernel (csrc/k1_lab.cu lab10_kernel): a warp a tile, R rays
# a lane, each cluster's quads split over R workers with running bests of
# their own, combined by (t, slot) after the walk

def _dup_lab10(seed=13, n_tiles=96):
    """The duplicate scene (_dup_scene) as L10 takes it: counts, keys
    (n_tiles, C) i32, rays8 (n_tiles, 32, 8), tris12 and the id mask.
    Every tile with a cluster walks cluster 0 first and cluster 1 (its
    copy) second, then an ascending random draw of the others; counts run
    0-12 (fixord then repeats its orders 0-7), every 7th tile has none,
    group 0's last four have none and group 2 none at all."""
    (v0, e1, e2), _, (o3, d3, mm2) = _dup_scene(seed, n_tiles=n_tiles)
    C = v0.shape[0] // common.CLUSTER
    tris12 = np.ascontiguousarray(np.swapaxes(
        _bw_rows(v0, e1, e2).reshape(C, common.CLUSTER, 12), 1, 2)[
            :, :, None, :])
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 13, n_tiles).astype(np.int32)
    counts[::7] = 0
    counts[28:32] = 0
    counts[64:] = 0
    keys = np.full((n_tiles, C), 0x7FFFFFFF, np.int32)
    for i, n in enumerate(counts):
        rest = np.sort(rng.choice(np.arange(2, C), max(n - 2, 0), False))
        keys[i, :n] = np.concatenate([[0, 1], rest])[:n]
    rays8 = np.concatenate([o3, d3, mm2], -1)
    return tuple(map(_t, (counts, keys, rays8, tris12))) + (31,)


def workers_lab10(counts, keys, rays8, tris12, mode, idmask, R):
    """A plain torch model of lab10_kernel's work split (unfused body):
    lane l of worker l // (32 / R) holds rays l % (32 / R) + k (32 / R);
    worker w takes the quads q = w (mod R) of each cluster of the walk and
    keeps its own running best (the first smallest hit, strict <) from the
    ray's start; the workers' bests meet by smallest t, then smallest slot
    (walk position x 128 + lane), after the walk. Returns what lab10
    returns."""
    lanes = 32 // R
    ray_of = (torch.arange(lanes)[:, None] + lanes * torch.arange(R)).T
    assert sorted(ray_of.reshape(-1).tolist()) == list(range(32))
    n_tiles, C = counts.shape[0], tris12.shape[0]
    rows = tris12.reshape(C, 12, common.CLUSTER)
    worker = torch.arange(common.CLUSTER) // 4 % R
    rays = kernel_lab10._rays(rays8, mode)
    start = kernel_lab10._start(counts, rays8, mode)
    ct = start[..., None].repeat(1, 1, R)
    cs = torch.full((n_tiles, 32, R), -1, dtype=torch.int64)
    inf = torch.tensor(float("inf"))
    for j in range(int(counts.max())):
        sel = torch.nonzero(counts > j).squeeze(1)
        c = torch.full_like(sel, j % 8) if mode == "fixord" else \
            (keys[sel, j] & idmask).clamp(max=C - 1).long()
        r = rays[sel]
        hit, tt = kernel_lab9._hit([rows[c][:, None, i] for i in range(12)],
                                   r[..., 0:3], r[..., 3:6], r[..., 6],
                                   torch.full(r.shape[:2], inf))
        for w in range(R):
            ct_w = ct[sel, :, w]
            mine = hit & (worker == w) & (tt < ct_w[..., None])
            t_w, arg = torch.where(mine, tt, inf).min(dim=2)
            closer = t_w < ct_w
            ct[sel, :, w] = torch.where(closer, t_w, ct_w)
            cs[sel, :, w] = torch.where(closer, j * 128 + arg, cs[sel, :, w])
    t, slot = _first_min(ct, torch.where(cs >= 0, cs, 1 << 30))
    got = slot < (1 << 30)
    g = torch.where(got, slot, 0) // 128
    cl = g % 8 if mode == "fixord" else \
        (torch.gather(keys.long(), 1, g.reshape(n_tiles, -1)).reshape(
            g.shape) & idmask).clamp(max=C - 1)
    ids = torch.where(got, cl * 128 + slot % 128, -1).int()
    out = torch.stack([t, ids.view(torch.float32)], -1)
    if mode == "nowrite":
        full = workers_lab10(counts, keys, rays8, tris12, "full", idmask, R)
        return kernel_lab10.nowrite_of(full, counts, rays8)
    return out


@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("mode", ["full", "noray", "fixord", "nowrite"])
def test_lab10_worker_split_matches_reference(mode, R):
    """The model of the card's R-worker split and (t, slot) combine equals
    lab10_reference bit for bit on exact duplicate triangles within a quad,
    across workers and across clusters of the walk, fixord's repeated
    clusters, tiles of no cluster (a group's last ones, a whole group), NaN
    rays and rays with t_max < t_min."""
    counts, keys, rays8, tris12, idmask = _dup_lab10()
    want = kernel_lab10.lab10_reference(counts, keys, rays8, tris12, mode,
                                        idmask)
    got = workers_lab10(counts, keys, rays8, tris12, mode, idmask, R)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if mode in ("full", "fixord"):
        ids = want[..., 1].view(torch.int32)
        # the duplicates win: cluster 0's quads 0 and 1
        assert int(((ids >= 0) & (ids < 256) & (ids % 128 < 8)).sum()) >= 20


def test_lab10_walk_order_and_spread():
    """The card's kernel walks the tiles most clusters first, ties in
    index order (walk_order, a stable sort, a permutation); tile_spread
    reads the counts and the idle share of the card's blocks of 4 tiles in
    either order."""
    counts = torch.tensor([3, 0, 7, 3, 7, 1, 0, 2], dtype=torch.int32)
    order = kernel_lab10.walk_order(counts)
    assert order.dtype == torch.int32
    assert order.tolist() == [2, 4, 0, 3, 7, 5, 1, 6]
    sp = kernel_lab10.tile_spread(counts)
    assert (sp["min"], sp["max"], sp["mean"]) == (0, 7, 23 / 8)
    assert sp["block_idle_share"] == pytest.approx(1 - 23 / 56)
    assert sp["block_idle_share_walk_order"] == pytest.approx(1 - 23 / 36)


def _lab10_fma(monkeypatch, *args):
    """lab10_reference with the card's FMA body (common.bw_test_fma)."""
    monkeypatch.setattr(kernel_lab9, "_bw_test", common.bw_test_fma)
    try:
        return kernel_lab10.lab10_reference(*args)
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("mode", ["full", "noray", "fixord", "nowrite"])
def test_lab10_agreement_holds_the_fma_body(monkeypatch, small_wave, mode):
    """The FMA body's results (emulated in FP64) meet lab10_agreement
    against the plain version on the small scene's sorted wave and on the
    duplicate scene, with t off by at most 1/2 of its bound (nowrite: bit
    for bit to what the FMA body's full computes)."""
    tracer, (counts, keys, r3, idmask) = small_wave
    cases = [(counts, keys, r3, tracer.tris12, idmask), _dup_lab10(14)]
    for counts, keys, r3, tris12, idmask in cases:
        args = (counts, keys, r3, tris12, mode, idmask)
        ref = kernel_lab10.lab10_reference(*args)
        fma = _lab10_fma(monkeypatch, *args)
        full = _lab10_fma(monkeypatch, *args[:4], "full", idmask)
        agree = kernel_lab10.lab10_agreement(fma, ref, counts, r3, tris12,
                                             mode, full=full)
        if mode == "nowrite":
            assert agree["ok"], agree
            continue
        assert agree["rays_off"] == 0 and agree["ill_conditioned"] <= 1 \
            and agree["max_t_over_bound"] <= 0.5, agree
        if mode == "full":
            assert int((ref[..., 1].view(torch.int32) >= 0).sum()) > 50


def test_lab10_agreement_rules():
    """lab10_agreement accepts a t one ulp off and a tie swap (a winner's
    copy in cluster 1), and refuses a wrong id and a t off by more than its
    bound; nowrite refuses a t that its full did not compute."""
    counts, keys, r3, tris12, idmask = _dup_lab10()
    ref = kernel_lab10.lab10_reference(counts, keys, r3, tris12, "full",
                                       idmask)

    def hold(out, mode="full", want=ref, full=None):
        return kernel_lab10.lab10_agreement(out, want, counts, r3, tris12,
                                            mode, full=full)
    assert hold(ref)["ok"]
    flat = ref.reshape(-1, 2)
    ids = flat[:, 1].view(torch.int32)
    dup = int(torch.nonzero((ids >= 0) & (ids < 128)).reshape(-1)[0])
    hit = int(torch.nonzero((ids >= 0) & (flat[:, 0] > 0.5)).reshape(-1)[0])

    def moved(i, t=None, id_=None, x=flat):
        out = x.clone()
        if t is not None:
            out[i, 0] = t
        if id_ is not None:
            out[i, 1] = torch.tensor([id_], dtype=torch.int32).view(
                torch.float32)
        return out.reshape(ref.shape)
    a = hold(moved(hit, t=float(np.nextafter(np.float32(flat[hit, 0]),
                                             np.float32(np.inf)))))
    assert a["ok"] and a["t_bits_differ"] == 1
    a = hold(moved(dup, id_=int(ids[dup]) + 128))
    assert a["ok"] and a["ties"] == 1 and a["ill_conditioned"] == 0
    a = hold(moved(hit, id_=(int(ids[hit]) + 37) % (128 * 24)))
    assert not a["ok"] and a["rays_off"] == 1
    c, lane = int(ids[hit]) // 128, int(ids[hit]) % 128
    f = common.bw_fp64(tris12[c, :, 0, lane][None], r3.reshape(-1, 8)[
        [hit], 0:3], r3.reshape(-1, 8)[[hit], 3:6], r3.reshape(-1, 8)[
            [hit], 6])
    a = hold(moved(hit, t=float(flat[hit, 0] + 4 * f["b_t"][0])))
    assert not a["ok"] and a["rays_off"] == 1 and a["max_t_over_bound"] > 1
    nowrite = kernel_lab10.lab10_reference(counts, keys, r3, tris12,
                                           "nowrite", idmask)
    assert hold(nowrite, "nowrite", nowrite, ref)["ok"]
    nw = nowrite.reshape(-1, 2)
    for ray in (6, 32 * 40 + 3):        # tile 0's t, a pre-set t
        assert float(nw[ray, 0]) != 0.125
        a = hold(moved(ray, t=0.125, x=nw), "nowrite", nowrite, ref)
        assert not a["ok"] and a["rays_off"] == 1
    with pytest.raises(ValueError, match="full output"):
        hold(nowrite, "nowrite", nowrite)


# ---------------------------------------------------------------------------
# L11
# ---------------------------------------------------------------------------

L11_SMALL = dict(C=16, n_tiles=8, n_steps=2)


@pytest.mark.parametrize("mode", ["vpu", "mxu"])
def test_lab11_matches_script(monkeypatch, mode):
    kl11 = _script("kernel_lab11", monkeypatch)
    steps, rays, tris12, m = common.lab11_inputs(seed=7, **L11_SMALL)
    tris = tris12 if mode == "vpu" else m
    want = np.asarray(kl11.run(
        jnp.asarray(steps), jnp.asarray(rays), jnp.asarray(tris), mode,
        L11_SMALL["n_steps"], L11_SMALL["C"], L11_SMALL["n_tiles"]))
    got = kernel_lab11.lab11(_t(steps), _t(rays), _t(tris), mode)
    assert (got[..., 1].view(torch.int32) >= 0).sum() >= 8
    if mode == "vpu":
        _assert_close(got, want)
    else:
        agree = kernel_lab11.mxu_agreement(got, _t(want.copy()),
                                           _t(rays), _t(m))
        assert agree["ok"] and agree["ill_conditioned"] == 0, agree


def test_lab11_tables_are_the_scripts(monkeypatch):
    """The script's own main, its kernel replaced, builds the rays, the
    rows and the (C, 3, 4, 128) table that common.lab11_inputs builds, bit
    for bit."""
    kl11 = _script("kernel_lab11", monkeypatch)
    seen = {}

    def fake(steps, rays, tris, mode, n_steps, C, n_tiles):
        seen[mode] = (np.asarray(steps), np.asarray(rays), np.asarray(tris))
        return jnp.zeros((n_tiles, common.TILE, 2), jnp.float32)
    monkeypatch.setattr(kl11, "run", fake)
    with contextlib.redirect_stdout(io.StringIO()):
        kl11.main()
    steps, rays, tris12, m = common.lab11_inputs()
    assert m.shape == (1024, 3, 4, 128) and m.dtype == np.float32
    for mode, tris in (("vpu", tris12), ("mxu", m)):
        for got, want in zip(seen[mode], (steps, rays, tris)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_mxu_agreement_flags_departures():
    """The tie-aware hold passes the plain version against itself and an
    exact tie, and counts a t moved by 1e-4 and a wrong triangle."""
    steps, rays, _, m = map(_t, common.lab11_inputs(seed=8, **L11_SMALL))
    ref = kernel_lab11.lab11(steps, rays, m, "mxu")
    agree = kernel_lab11.mxu_agreement(ref, ref, rays, m)
    assert agree["ok"] and agree["id_match"] == 1.0
    flat = ref.reshape(-1, 2).clone()
    ids = flat[:, 1].view(torch.int32)
    hit = torch.nonzero(ids >= 0).squeeze(1)
    a, b = int(hit[0]), int(hit[1])
    flat[a, 0] += 1e-4 * max(1.0, abs(float(flat[a, 0])))
    orig = int(ids[b])
    other = orig ^ 1                    # a neighbouring triangle
    flat[b, 1] = torch.tensor([other], dtype=torch.int32).view(
        torch.float32)[0]
    agree = kernel_lab11.mxu_agreement(flat.reshape(ref.shape), ref, rays, m)
    assert agree["rays_off"] == 2 and agree["ids_differ"] == 1
    assert agree["ill_conditioned"] == 0 and not agree["ok"]
    # the same triangle twice in the table: the second copy ties
    m2 = m.clone()
    c, lane = divmod(orig, common.CLUSTER)
    m2[c, :, :, lane ^ 1] = m2[c, :, :, lane]
    agree = kernel_lab11.mxu_agreement(flat.reshape(ref.shape), ref, rays,
                                       m2)
    assert agree["rays_off"] == 1 and agree["ties"] == 1


# L11 vpu on the card (csrc/k1_lab.cu lab11_vpu_kernel, L9's plan): R rays a
# lane, worker w taking the quads w (mod R) of each cluster, running bests
# from 3e38 over the whole walk (slot g * 128 + lane at walk position g =
# 8i + j), combined by (t, slot) after the walk; the FMA body, held by
# kernel_lab11.vpu_agreement

def _dup_lab11(seed=15, C=16, n_tiles=8, n_steps=2):
    """L11's stream over a table with exact duplicates: cluster 1 copies
    cluster 0, and in cluster 0 lane 2 copies lane 0 and quad 1 quad 0;
    half the rays aim at cluster 0's first quads, some are NaN. Returns
    (steps, rays, tris12) as L11's wrappers take them."""
    (v0, e1, e2), _, (o3, d3, _) = _dup_scene(seed, n_clusters=C,
                                               n_tiles=n_tiles)
    tris12 = np.ascontiguousarray(np.swapaxes(
        _bw_rows(v0, e1, e2).reshape(C, common.CLUSTER, 12), 1, 2)[
            :, :, None, :])
    rays = np.concatenate([o3, d3, np.zeros_like(o3[..., :2])], -1)
    rays[..., 7] = common.BIG
    steps = np.full((n_tiles,), n_steps, np.int32)
    return tuple(map(_t, (steps, rays.astype(np.float32), tris12)))


def workers_lab11(steps, rays, tris12, R):
    """A plain torch model of lab11_vpu_kernel's split (unfused body): lane
    l of worker l // (32 / R) holds rays l % (32 / R) + k (32 / R); worker
    w takes the quads q = w (mod R) of each cluster and keeps the first
    smallest hit (strict <) of its slots over the walk, from 3e38; the
    workers' bests meet by smallest t, then smallest slot, and the winning
    slot g * 128 + lane names cluster (g + tile) mod C. Returns what lab11
    returns."""
    n_tiles, C = steps.shape[0], tris12.shape[0]
    rows = tris12.reshape(C, 12, common.CLUSTER)
    n = int(steps.max()) * common.KBV
    g = torch.arange(n)
    clusters = (g[None] + torch.arange(n_tiles)[:, None]) % C   # (T, n)
    slot = (g[:, None] * common.CLUSTER +
            torch.arange(common.CLUSTER)[None]).reshape(-1)
    tri = rows[clusters].permute(0, 2, 1, 3).reshape(n_tiles, 1, 12, -1)
    bt = torch.full((n_tiles, 32), common.BIG)
    hit, tt = kernel_lab9._hit([tri[:, :, i] for i in range(12)],
                               rays[..., 0:3], rays[..., 3:6], rays[..., 6],
                               bt)
    walked = slot[None, None] < (steps.long() * common.KBV *
                                 common.CLUSTER)[:, None, None]
    worker = slot % common.CLUSTER // 4 % R
    inf = torch.tensor(float("inf"))
    per_w = []
    for w in range(R):
        t_w, a = torch.where(hit & walked & (worker == w), tt, inf).min(-1)
        per_w.append((t_w, torch.where(t_w < inf, slot[a], 1 << 30)))
    t, s_ = _first_min(torch.stack([x[0] for x in per_w], -1),
                       torch.stack([x[1] for x in per_w], -1))
    won = s_ < (1 << 30)
    c = torch.gather(clusters, 1, torch.where(won, s_, 0) // common.CLUSTER)
    ids = torch.where(won, c * common.CLUSTER + s_ % common.CLUSTER, -1)
    return torch.stack([torch.where(won, t, common.BIG),
                        ids.int().view(torch.float32)], -1)


@pytest.mark.parametrize("R", [1, 2, 4])
def test_lab11_vpu_worker_split_matches_reference(R):
    """The model of the card's R-worker split over the walk (running bests
    from 3e38, the (t, slot) combine after the walk, the slot mapped to
    cluster x 128 + lane only then) equals lab11_reference bit for bit on
    exact duplicate triangles (within a quad, across workers, across
    clusters of a step) and NaN rays, and on the script's stream, at
    uneven steps."""
    cases = [_dup_lab11(), tuple(map(_t, common.lab11_inputs(
        seed=7, **L11_SMALL)[:3]))]
    for steps, rays, tris12 in cases:
        steps = steps.clone()
        steps[::3] = 1
        steps[1] = 0
        want = kernel_lab11.lab11_reference(steps, rays, tris12, "vpu")
        got = workers_lab11(steps, rays, tris12, R)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert int((want[..., 1].view(torch.int32) >= 0).sum()) >= 8
    ids = want[..., 1].view(torch.int32)
    assert int(((ids >= 0) & (ids < 256)).sum()) >= 1


def test_lab11_vpu_agreement_holds_the_fma_body(monkeypatch):
    """The FMA body's results (emulated in FP64) meet vpu_agreement
    against the plain version on the script's stream and on the duplicate
    table, with t off by at most 1/2 of its bound."""
    cases = [tuple(map(_t, common.lab11_inputs(seed=5, C=32, n_tiles=64,
                                               n_steps=2)[:3])),
             _dup_lab11()]
    for steps, rays, tris12 in cases:
        ref = kernel_lab11.lab11_reference(steps, rays, tris12, "vpu")
        monkeypatch.setattr(kernel_lab9, "_bw_test", common.bw_test_fma)
        try:
            fma = kernel_lab11.lab11_reference(steps, rays, tris12, "vpu")
        finally:
            monkeypatch.undo()
        agree = kernel_lab11.vpu_agreement(fma, ref, rays, tris12)
        assert agree["ok"] and agree["max_t_over_bound"] <= 0.5, agree


def test_lab11_vpu_agreement_rules():
    """vpu_agreement accepts a t one ulp off and a tie swap (the winner's
    copy in cluster 1), and refuses a wrong id, a lost hit and a t off by
    more than its bound."""
    steps, rays, tris12 = _dup_lab11()
    ref = kernel_lab11.lab11_reference(steps, rays, tris12, "vpu")

    def hold(out):
        return kernel_lab11.vpu_agreement(out, ref, rays, tris12)
    assert hold(ref)["ok"]
    flat = ref.reshape(-1, 2)
    ids = flat[:, 1].view(torch.int32)
    dup = int(torch.nonzero((ids >= 0) & (ids < 128)).reshape(-1)[0])
    hit = int(torch.nonzero((ids >= 256) & (flat[:, 0] > 0.5)).reshape(-1)[0])

    def moved(i, t=None, id_=None):
        out = flat.clone()
        if t is not None:
            out[i, 0] = t
        if id_ is not None:
            out[i, 1] = torch.tensor([id_], dtype=torch.int32).view(
                torch.float32)[0]
        return out.reshape(ref.shape)
    a = hold(moved(hit, t=float(np.nextafter(np.float32(flat[hit, 0]),
                                             np.float32(np.inf)))))
    assert a["ok"] and a["t_bits_differ"] == 1
    a = hold(moved(dup, id_=int(ids[dup]) + 128))
    assert a["ok"] and a["ties"] == 1 and a["ill_conditioned"] == 0
    a = hold(moved(hit, id_=int(ids[hit]) + 37))
    assert not a["ok"] and a["rays_off"] == 1
    a = hold(moved(hit, t=common.BIG, id_=-1))
    assert not a["ok"] and a["rays_off"] == 1
    c, lane = int(ids[hit]) // 128, int(ids[hit]) % 128
    r8 = rays.reshape(-1, 8)
    f = common.bw_fp64(tris12[c, :, 0, lane][None], r8[[hit], 0:3],
                       r8[[hit], 3:6], r8[[hit], 6])
    a = hold(moved(hit, t=float(flat[hit, 0] + 4 * f["b_t"][0])))
    assert not a["ok"] and a["rays_off"] == 1 and a["max_t_over_bound"] > 1


def test_lab_test_loops_names_lab11(monkeypatch):
    """app/sass.lab_test_loops names L11's kernels, this tree's
    (lab11_vpu_kernel<4>: 4 rays a lane, 12 row loads a pass, 16 tests;
    lab11_mxu_kernel: its loop's 36 tensor-core products, 8 tests a lane)
    and an older checkout's (vpu one ray a lane), and a templated mxu
    kernel's."""
    from tauray_torch.app import sass
    vpu = ".L_x_1:\n" + "".join(
        f"        /*{16 * i:04x}*/   LDS.128 R{4 * i}, [R2+0x{i:x}] ;\n"
        for i in range(12)) + \
        "        /*00c0*/   FFMA R3, R3, R3, R3 ;\n" \
        "        /*00d0*/   @P0 BRA `(.L_x_1) ;\n"
    mxu = ".L_x_2:\n" + "".join(
        f"        /*{16 * i:04x}*/   HMMA.1684.F32.TF32 R{i}, R1, R2, R3 ;"
        "\n" for i in range(36)) + \
        "        /*0300*/   FFMA R3, R3, R3, R3 ;\n" \
        "        /*0310*/   @P0 BRA `(.L_x_2) ;\n"
    for vname, mname, rays in (("lab11_vpu_kernelILi4EE",
                                "lab11_mxu_kernel", 4),
                               ("lab11_vpu_kernel", "lab11_mxu_kernelILi4EE",
                                1)):
        monkeypatch.setattr(sass, "functions", lambda path: {
            f"_ZN12_GLOBAL__N_116{vname}EvPKiPKfS4_iiPf": vpu,
            f"_ZN12_GLOBAL__N_116{mname}EvPKiPKfS4_iiPf": mxu})
        loops = sass.lab_test_loops("lib.so")
        assert set(loops) == {"lab11 vpu", "lab11 mxu"}
        st = loops["lab11 vpu"]
        assert st["rays_a_lane"] == rays and st["loads128"] == 12
        assert st["tests"] == pytest.approx(4 * rays)
        st = loops["lab11 mxu"]
        assert st["hmma"] == 36 and st["tests"] == 8
        assert st["instructions_per_test"] == pytest.approx(38 / 8)


# ---------------------------------------------------------------------------
# Entry points, the build, the wrappers
# ---------------------------------------------------------------------------

def test_lab8_entry_point_on_the_cpu(capsys):
    assert kernel_lab8.main(["--device=cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6
    assert lines[0].startswith("mode0 (write-only) counts=  0:")
    assert lines[-1].startswith("mode3 (+while(count/8) smem reads) "
                                "counts= 16:")
    assert all("host ms (cpu plain)" in ln and "us/tile" in ln
               for ln in lines)


@pytest.mark.parametrize("reps,n", [(3, 5), (1, 20)])
def test_time_graph_replays_n_captured_calls(monkeypatch, reps, n):
    """common.time_graph calls fn twice on a side stream, captures n calls
    in one CUDA graph, replays it once as a warm-up, then reps times
    between two CUDA events, and gives each replay's ms over n: the median,
    min and max (a card's clock stood in for by the replays' lengths)."""
    clock = {"ms": 0.0, "captured": 0, "capturing": False}
    lengths = iter([99.0, 10.0, 30.0, 20.0][:reps + 1])
    calls = []

    class Stream:
        def wait_stream(self, other):
            pass

    class Graph:
        def replay(self):
            assert clock["captured"] == n
            clock["ms"] += next(lengths)

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            self.at = clock["ms"]

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return end.at - self.at

    @contextlib.contextmanager
    def graph(g):
        clock["capturing"] = True
        yield
        clock["capturing"] = False

    def fn():
        calls.append(clock["capturing"])
        clock["captured"] += clock["capturing"]
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    t = common.time_graph(fn, reps, n)
    assert calls == [False, False] + [True] * n
    want = [10.0, 30.0, 20.0][:reps]
    assert t["ms_graph"] == pytest.approx(sorted(want)[len(want) // 2] / n)
    assert t["min_ms_graph"] == pytest.approx(min(want) / n)
    assert t["max_ms_graph"] == pytest.approx(max(want) / n)


@pytest.mark.parametrize("lab", [kernel_lab8, kernel_lab9, kernel_lab10,
                                 kernel_lab11],
                         ids=["L8", "L9", "L10", "L11"])
def test_lab_entry_point_needs_a_card(monkeypatch, lab):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        lab.main([])


def test_k1_lab_builds_beside_trace_tiles(monkeypatch, tmp_path):
    """build_all compiles csrc/k1_lab.cu, brick_lab.cu, tile_lab.cu and
    mxu_lab.cu with trace_tiles.cu's nvcc flags (sm_90a, -fmad=false), one
    process per source started together, into the build directory, and
    binds each lab's launch function; nothing is built at import."""
    calls = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            calls.append(cmd)
            pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")

        def communicate(self):
            return ("",)

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn
    monkeypatch.setattr(tk, "_libs", {})
    monkeypatch.setattr(tk, "BUILD_INFO", {})
    monkeypatch.setattr(tk, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tk, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(tk.subprocess, "Popen", Proc)
    monkeypatch.setattr(tk.ctypes, "CDLL", lambda path: Lib())
    libs = tk.build_all()
    labs = ["brick_lab", "k1_lab", "mxu_lab", "tile_lab"]
    assert sorted(libs) == sorted(labs + ["trace_tiles"])
    srcs = {pathlib.Path(c[-1]).name: c for c in calls}
    assert sorted(srcs) == sorted(f"{n}.cu" for n in labs + ["trace_tiles"])
    for cmd in srcs.values():
        assert cmd[1:1 + len(tk.NVCC_FLAGS)] == tk.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in tk.NVCC_FLAGS
    assert "-fmad=false" in tk.NVCC_FLAGS
    for name in labs:
        fn = getattr(libs[name], f"{name}_launch")
        assert fn.argtypes == tk._ARGTYPES[f"{name}_launch"]
    assert all(p.parent == tmp_path for p in map(
        lambda c: pathlib.Path(tk.BUILD_INFO[c]["path"]), libs))


def test_lab_wrappers_take_no_other_device():
    o3 = torch.zeros((32, 32, 3), device="meta")
    with pytest.raises(ValueError, match="no lab kernel"):
        kernel_lab8.lab8(torch.zeros(32, dtype=torch.int32), None, o3, o3,
                         None, 1)
    with pytest.raises(ValueError, match="no mode"):
        kernel_lab10.lab10_reference(*[None] * 4, "nope", 1)


def test_mxu_t64_bounds_the_fp32_t():
    """mxu_t64's FP64 t of each hit's triangle lies within its bound of the
    plain FP32 t (whose own error is 8 times smaller than the bound's
    per-product rate), and a ray moved off by more than its bound is not
    rescued by the FP64 rule."""
    steps, rays, _, m = map(_t, common.lab11_inputs(seed=9, **L11_SMALL))
    ref = kernel_lab11.lab11(steps, rays, m, "mxu")
    flat = ref.reshape(-1, 2)
    ids = flat[:, 1].view(torch.int32)
    hit = torch.nonzero(ids >= 0).squeeze(1)
    t64, bound = kernel_lab11.mxu_t64(rays.reshape(-1, 8)[hit], m, ids[hit])
    assert bool(((flat[hit, 0].double() - t64).abs() <= bound).all())
    assert bool((bound > 0).all())
    moved = flat.clone()
    i = int(hit[0])
    moved[i, 0] += max(1e-4, 4 * float(bound[0]))
    agree = kernel_lab11.mxu_agreement(moved.reshape(ref.shape), ref, rays, m)
    assert agree["rays_off"] == 1 and agree["ill_conditioned"] == 0


def test_lab_bounds_name_every_lab_kernel(capsys):
    """python -m tauray_torch.lab.bounds gives a bound to every lab kernel
    of scripts/ (L10's comes from its wave, in chip_smoke), each at the
    site tests/test_torch_coverage.py accounts for."""
    from tauray_torch.lab import bounds
    from test_torch_coverage import PALLAS_SITES
    assert bounds.main() == 0
    lines = capsys.readouterr().out.splitlines()
    labs = {ln.split(":")[0].split()[0] for ln in lines}
    assert labs == {f"L{i}" for i in range(1, 13)} - {"L10"}
    for lab, site, _, ms, by in bounds.rows():
        assert site in PALLAS_SITES and ms > 0 and by in ("operations",
                                                         "bytes")
