"""The brick and resident-table labs L4-L7 (tauray_torch/lab/kernel_lab2-5.py)
against the TPU lab scripts they port, scripts/kernel_lab2.py to
kernel_lab5.py, on the CPU. Each script's own make_kernel runs under
pl.pallas_call(..., interpret=True) with its run's grid spec at 64 tiles
(two grid steps of G = 32; the pallas_call patched inside the test, no
file changed), on the first 64 tiles of the inputs its main draws first at
that tile size, and the lab's plain torch version (the wrappers take it
for CPU tensors) runs on the same inputs.

Tolerances: Möller-Trumbore (mt) and Baldwin-Weber (bw): t within 1e-5
relative and absolute, the tolerance of tests/test_torch_lab.py (XLA:CPU
contracts the products into FMAs, torch does not), and ids exact but
where the rounding decides the test: an id may differ on at most 2 rays of
a run, and only where the two winners' t tie within 1e-5 or one of the two
triangles lies within 1e-5 of an edge or of t_min in FP64 (L7 mt, KB 8: one
ray, its triangle 2.5e-8 below t_min). The deferred-division body
(mtfast): ids exact; t's int32 bits within one quantum of its truncated
key as t sees it, since an FMA can move t across a quantum: 1,024, or
2,048 where both keys carry bit 10 (at KB = 16 a lane >= 1,024 sets it,
fault 3, and a crossing then moves the key by two quanta; 2 rays of 512 at
TILE 8).

The card's walk of L5-L7 (csrc/brick_lab.cu brick_walk_kernel) is held
here through a plain model of its work split (workers_brick), equal to the
plain version bit for bit under the unfused body, and through
brick.brick_agreement, the tie-aware hold that its FMA body meets.

The faults of the scripts that the port keeps (ROADMAP Queue 3) each have
a test: mtfast's t < 0 for back-facing hits, its lane bit 10 lost at
KB = 16, and L6's exit that never fires on the script's own meta. The
scripts' mains are also run with their kernels replaced by a recorder:
their seeded inputs equal common.lab4_inputs-lab7_inputs bit for bit, and
their tests a ray (as run counts them) give bounds.CONFIGS."""

import ast
import contextlib
import functools
import hashlib
import importlib.util
import io
import pathlib
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tauray_torch.lab import (bounds, brick, common, kernel_lab2, kernel_lab3,
                              kernel_lab4, kernel_lab5, lab_kernel)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"
T_TOL = 1e-5
# an id may depart only where one of the two triangles lies this near an
# edge or t_min in FP64 (or the two t tie within T_TOL), on at most
# MAX_DEPARTING rays of a run: XLA:CPU's FMAs move such a test across
EDGE = 1e-5
MAX_DEPARTING = 2
N_TILES = 64
G = 32
# lab -> its script
SCRIPT = {"lab4": "kernel_lab2", "lab5": "kernel_lab3", "lab6": "kernel_lab4",
          "lab7": "kernel_lab5"}
# every L4 name: main's and the 8-ray tiles it runs when asked
L4_NAMES = ("k8", "k6", "k7", "k8f", "k6f", "k7f")
CONFIGS = {"lab4": common.lab4_configs(L4_NAMES),
           "lab5": common.lab5_configs(), "lab6": common.lab6_configs(),
           "lab7": common.lab7_configs()}


def _load(name):
    """scripts/<name>.py as a module (its module-level draws run)."""
    spec = importlib.util.spec_from_file_location(
        f"_brick_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _script(name, monkeypatch):
    """scripts/<name>.py as a module, its Pallas kernels in interpret
    mode."""
    monkeypatch.syspath_prepend(str(SCRIPTS))
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    return _load(name)


def _config(lab, mode, tile, kb):
    return next(c for c in CONFIGS[lab] if (c.mode, c.tile, c.kb) ==
                (mode, tile, kb))


@functools.lru_cache(maxsize=None)
def _inputs(lab, tile):
    """The tables and the first N_TILES tiles of the first inputs that
    lab's main draws at tile rays a tile (L4's k8 from a run of k8 alone):
    ({name: table}, meta, rays) as numpy."""
    names = {8: ("k8",), 16: ("k6",), 32: ("k7",)}[tile]
    tables, draws = {"lab4": lambda: common.lab4_inputs(names),
                     "lab5": common.lab5_inputs, "lab6": common.lab6_inputs,
                     "lab7": common.lab7_inputs}[lab]()
    _, meta, rays = next(d for d in draws if d[0].tile == tile)
    return tables, meta[:N_TILES * common.ROW], rays[:N_TILES]


def _pallas(mod, lab, cfg, meta, rays, tris):
    """The script's kernel for cfg over N_TILES tiles, with its run's grid
    spec (kernel_lab2.py:238-252, kernel_lab3.py:195-208,
    kernel_lab4.py:203-217, kernel_lab5.py:166-180)."""
    n_tiles = rays.shape[0]
    hbm = pl.BlockSpec(memory_space=pltpu.MemorySpace.HBM)
    ray_spec = pl.BlockSpec((G, cfg.tile, 8), lambda b: (b, 0, 0),
                            memory_space=pltpu.VMEM)
    out_spec = pl.BlockSpec((G, cfg.tile, 2), lambda b: (b, 0, 0),
                            memory_space=pltpu.VMEM)
    meta_scr = [pltpu.SMEM((2 * G * 1024,), jnp.int32),
                pltpu.SemaphoreType.DMA((2,))]
    nf = tris.shape[1]
    table_spec = pl.BlockSpec((common.CC, nf, 1, 128),
                              lambda b: (0, 0, 0, 0), memory_space=pltpu.VMEM)
    if lab == "lab4":
        body = mod.mtfast_body if cfg.mode == "mtfast" else mod.mt_body
        kernel, bk = mod.make_kernel(cfg.tile, cfg.kb, body, G)
        in_specs = [hbm, ray_spec, hbm]
        scratch = [pltpu.VMEM((2, 9, 1, bk), jnp.float32), *meta_scr,
                   pltpu.SemaphoreType.DMA((2, cfg.kb))]
    elif lab == "lab5":
        kernel, _ = mod.make_kernel(cfg.tile, cfg.kb, G)
        resident = kernel

        def kernel(meta_ref, rays_ref, tris_in, out_ref, tri_scr, meta_scr,
                   meta_sem, *, steps):
            # the script's kernel_wrap (kernel_lab3.py:187-192)
            @pl.when(pl.program_id(0) == 0)
            def _():
                tri_scr[...] = tris_in[...]
            resident(meta_ref, rays_ref, out_ref, tri_scr, meta_scr,
                     meta_sem, steps=steps)
        in_specs = [hbm, ray_spec, table_spec]
        scratch = [pltpu.VMEM((common.CC, 9, 1, 128), jnp.float32),
                   *meta_scr]
    elif lab == "lab6":
        kernel, _ = mod.make_kernel(cfg.tile, cfg.kb, G, cfg.mode)
        in_specs = [hbm, ray_spec, table_spec]
        scratch = [pltpu.VMEM((common.CC, 9, 1, 128), jnp.float32),
                   *meta_scr]
    else:
        kernel, _ = mod.make_kernel(cfg.kb, cfg.mode)
        in_specs = [hbm, ray_spec, table_spec]
        scratch = meta_scr
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=0, grid=(n_tiles // G,), in_specs=in_specs,
        out_specs=out_spec, scratch_shapes=scratch)
    out_shape = jax.ShapeDtypeStruct((n_tiles, cfg.tile, 2), jnp.float32)
    return np.asarray(pl.pallas_call(
        partial(kernel, steps=cfg.steps), out_shape=out_shape,
        grid_spec=grid_spec)(jnp.asarray(meta), jnp.asarray(rays),
                             jnp.asarray(tris)))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _plain(lab, cfg, meta, rays, tris, stats=None):
    return brick.walk_reference(lab, cfg.mode, _t(meta), _t(rays), _t(tris),
                                cfg.kb, cfg.steps, stats)


def _triangle(lab, cfg, meta, tris, tile, rid):
    """The (rows,) of the triangle that id rid names in tile's walk, as
    float64: a slot's (lab4-lab7) or, for cid, a cluster * 128 + lane."""
    if cfg.mode == "cid":
        return tris[rid // 128, :, 0, rid % 128].astype(np.float64)
    step, lane = divmod(rid, cfg.kb * 128)
    m = int(meta[tile * common.ROW + step * cfg.kb + lane // 128])
    c = min(m & 1023, common.CC - 1) if lab == "lab7" else \
        min(max(m, 0), common.CC - 1)
    return tris[c, :, 0, lane % 128].astype(np.float64)


def _fp64_test(w, ray):
    """The triangle's hit test for ray in FP64: (t, the signed distance
    from its nearest boundary: u, v, 1 - u - v and (t - t_min) / max(1,
    |t|), positive inside)."""
    o, d, tmin = ray[0:3], ray[3:6], ray[6]
    if w.shape[0] == 9:
        v0, e1, e2 = w[0:3], w[3:6], w[6:9]
        h = np.cross(d, e2)
        f = 1.0 / (e1 @ h)
        s = o - v0
        q = np.cross(s, e1)
        u, v, t = f * (s @ h), f * (d @ q), f * (e2 @ q)
    else:
        t = (w[3] - w[0:3] @ o) / (w[0:3] @ d)
        p = o + t * d
        u, v = w[4:7] @ p - w[7], w[8:11] @ p - w[11]
    return t, min(u, v, 1 - u - v, (t - tmin) / max(1.0, abs(t)))


def _departures(got, want, lab, cfg, meta, rays, tris):
    """Rays whose ids differ, each checked to lie within rounding of the
    test's boundaries (tie-aware), in FP64: one of the two winners within
    EDGE of an edge or of t_min (kept by one package's rounding, dropped by
    the other's), or both hits whose t tie within T_TOL of max(1, |t|).
    Returns (departing mask, the ones not so explained)."""
    if lab == "lab7":
        ids = [np.where(x[..., 0] < common.BIG, x[..., 1], -1).astype(
            np.int64) for x in (got, want)]
    else:
        ids = [x[..., 1].view(np.int32) for x in (got, want)]
    off = ids[0] != ids[1]
    unexplained = []
    for tile, r in np.argwhere(off):
        ray = rays[tile, r].astype(np.float64)
        tests = [_fp64_test(_triangle(lab, cfg, meta, tris, tile, int(i)),
                            ray)
                 for i in (ids[0][tile, r], ids[1][tile, r]) if i >= 0]
        edge = min(abs(m) for _, m in tests) <= EDGE
        tie = len(tests) == 2 and min(m for _, m in tests) >= -EDGE and \
            abs(tests[0][0] - tests[1][0]) <= T_TOL * max(1.0,
                                                         abs(tests[0][0]))
        if not (edge or tie):
            unexplained.append((int(tile), int(r)))
    return off, unexplained


def _hold(got, want, lab, cfg, meta, rays, tris):
    """Raw (n_tiles, tile, 2) blocks under the module's tolerances; returns
    the rays whose ids depart (each within rounding of a boundary)."""
    got = got.numpy()
    if cfg.mode == "mtfast":
        np.testing.assert_array_equal(got[..., 1].view(np.int32),
                                      want[..., 1].view(np.int32))
        g, w = (x[..., 0].view(np.int32) for x in (got, want))
        d = np.abs(g.astype(np.int64) - w)
        lane_bit = (g & 1024 != 0) & (w & 1024 != 0)
        assert bool(((d <= 1024) | ((d == 2048) & lane_bit)).all())
        return 0
    off, unexplained = _departures(got, want, lab, cfg, meta, rays, tris)
    assert not unexplained, unexplained
    assert off.sum() <= MAX_DEPARTING
    np.testing.assert_allclose(got[..., 0][~off], want[..., 0][~off],
                               rtol=T_TOL, atol=T_TOL)
    return int(off.sum())


def _check_script(monkeypatch, lab, cfg, meta=None):
    """The script's kernel and the lab's wrapper (its plain version here)
    on the same inputs, held; returns the wrapper's output."""
    mod = _script(SCRIPT[lab], monkeypatch)
    tables, meta0, rays = _inputs(lab, cfg.tile)
    meta = meta0 if meta is None else meta
    tris = tables["tris12" if cfg.mode == "bw" else "tris9"]
    np.testing.assert_array_equal(tris, np.asarray(
        getattr(mod, "tris12" if cfg.mode == "bw" else "tris9")))
    want = _pallas(mod, lab, cfg, meta, rays, tris)
    args = (_t(meta), _t(rays), _t(tris))
    if lab == "lab4":
        got = kernel_lab2.lab4(*args, cfg.mode, cfg.kb, cfg.steps)
    elif lab == "lab5":
        got = kernel_lab3.lab5(*args, cfg.kb, cfg.steps)
    elif lab == "lab6":
        got = kernel_lab4.lab6(*args, cfg.mode, cfg.kb, cfg.steps)
    else:
        got = kernel_lab5.lab7(*args, cfg.mode, cfg.kb, cfg.steps)
    _hold(got, want, lab, cfg, meta, rays, tris)
    assert brick.hits(got, cfg) >= N_TILES * cfg.tile // 4
    return got


# ---------------------------------------------------------------------------
# Every mode and body against its script
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile,kb", [(8, 16), (16, 8), (32, 4)])
@pytest.mark.parametrize("mode", ["mt", "mtfast"])
def test_lab4_matches_script(monkeypatch, mode, tile, kb):
    _check_script(monkeypatch, "lab4", _config("lab4", mode, tile, kb))


@pytest.mark.parametrize("tile,kb", [(8, 1), (16, 2), (32, 8)])
def test_lab5_matches_script(monkeypatch, tile, kb):
    _check_script(monkeypatch, "lab5", _config("lab5", "mt", tile, kb))


@pytest.mark.parametrize("variant,tile,kb", [
    ("fixed", 32, 8), ("slot", 32, 16), ("cid", 16, 8), ("while", 32, 16),
    ("while2", 16, 8)])
def test_lab6_matches_script(monkeypatch, variant, tile, kb):
    _check_script(monkeypatch, "lab6", _config("lab6", variant, tile, kb))


@pytest.mark.parametrize("body,kb", [("mt", 8), ("bw", 4)])
def test_lab7_matches_script(monkeypatch, body, kb):
    _check_script(monkeypatch, "lab7", _config("lab7", body, 32, kb))


def test_hold_flags_a_wrong_id():
    """The tie-aware hold passes the plain version against itself, and
    refuses a ray whose id names another triangle away from every edge."""
    cfg = _config("lab7", "mt", 32, 8)
    tables, meta, rays = _inputs("lab7", 32)
    tris = tables["tris9"]
    ref = _plain("lab7", cfg, meta, rays, tris)
    assert _hold(ref, ref.numpy(), "lab7", cfg, meta, rays, tris) == 0
    want = ref.numpy().copy()
    tile, r = map(int, np.argwhere(want[..., 0] < common.BIG)[0])
    want[tile, r, 1] = (int(want[tile, r, 1]) + 1) % (cfg.kb * 128)
    off, unexplained = _departures(ref.numpy(), want, "lab7", cfg, meta,
                                   rays, tris)
    assert int(off.sum()) == 1 and unexplained == [(tile, r)]


# ---------------------------------------------------------------------------
# L7 on the card's walk (csrc/brick_lab.cu brick_walk_kernel): R rays a
# lane, each step's quads split over R workers, their bests combined by
# (t, slot) after the last step; the FMA bodies, held tie-aware
# ---------------------------------------------------------------------------

def _dup_lab7(seed=21, n_tiles=16, kb=4, steps=3):
    """test_torch_lab's duplicate scene as L7 takes it: tris9 [v0 | e1 |
    e2] and tris12 (Baldwin-Weber rows) (C, nf, 1, 128), meta naming
    cluster 0 at slot 0 and at the next step's first slot and cluster 1
    (cluster 0's copy) at slot 1, and rays (n_tiles, 32, 8); the rays with
    t_max < t_min have t_min 5 (L7 reads no t_max)."""
    from test_torch_lab import _bw_rows, _dup_scene
    (v0, e1, e2), heads, (o3, d3, mm2) = _dup_scene(seed, n_tiles=n_tiles)
    C = v0.shape[0] // common.CLUSTER

    def table(rows):
        return _t(np.swapaxes(rows.reshape(C, common.CLUSTER, -1), 1, 2)[
            :, :, None, :])
    tris = {"mt": table(np.concatenate([v0, e1, e2], -1)),
            "bw": table(_bw_rows(v0, e1, e2))}
    meta = np.random.default_rng(seed).integers(
        0, C, (n_tiles, common.ROW)).astype(np.int32)
    meta[:, 0], meta[:, 1], meta[:, kb] = 0, 1, 0
    mm = mm2.copy()
    mm[mm[..., 0] > mm[..., 1]] = (5.0, 1.0)
    rays = np.concatenate([o3, d3, mm], -1)
    return tris, _t(meta.reshape(-1)), _t(rays), kb, steps


def workers_brick(lab, mode, meta, rays, tris, kb, steps, R, stats=None):
    """A plain torch model of brick_walk_kernel's work split (unfused
    bodies) at TILE = rays.shape[1] rays a tile and R rays a lane: worker w
    of the 32 R / TILE takes the quads q = w (mod 32 R / TILE) of each
    step's kb clusters and keeps the first smallest hit (strict <) of all
    its slots from the start (min(t_max, 3e38), a NaN kept; L7 3e38);
    while / while2 after every step / odd step meet each ray's t over its
    workers (a minimum) and stop the tile once every ray's t bits are <=
    the unclipped meta entry min((s + 1) kb, 1,023); the workers' bests
    meet by smallest t, then smallest slot, after the walk, and cid
    resolves the winning slot's cluster then. Returns what brick returns;
    `stats` (a dict), when given, receives the steps the tiles walked."""
    from test_torch_lab import _first_min
    n_tiles, tile = rays.shape[:2]
    C = tris.shape[0]
    rows = tris.reshape(C, tris.shape[1], common.CLUSTER)
    m2 = meta.reshape(n_tiles, common.ROW)
    bk = kb * common.CLUSTER
    W = 32 * R // tile
    worker = torch.arange(bk) // 4 % W
    test = brick._bw_test if mode == "bw" else brick._mt_test
    inf = torch.tensor(float("inf"))
    tmax = rays[..., 7]
    start = torch.full_like(tmax, common.BIG) if lab == "lab7" else \
        torch.where(tmax > common.BIG, common.BIG, tmax)
    ct = start[..., None].repeat(1, 1, W)
    cs = torch.full((n_tiles, tile, W), -1)
    o = [rays[..., k, None] for k in range(3)]
    d = [rays[..., 3 + k, None] for k in range(3)]
    tmin = rays[..., 6, None]
    vote = {"while": 1, "while2": 2}.get(mode)
    walking = torch.ones(n_tiles, dtype=torch.bool)
    walked = 0
    for s in range(steps):
        walked += int(walking.sum())
        ent = m2[:, s * kb:(s + 1) * kb]
        orders = ((ent & 1023).clamp(max=C - 1) if lab == "lab7" else
                  ent.clamp(0, C - 1)).long()
        tri = rows[orders].permute(0, 2, 1, 3).reshape(n_tiles, -1, 1, bk)
        a, tt, uu, vv = test([tri[:, i] for i in range(tri.shape[1])], *o,
                             *d)
        hit = (a != 0) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & \
            (tt >= tmin)
        for w in range(W):
            t_w, arg = torch.where(hit & (worker == w), tt, inf).min(dim=2)
            closer = (t_w < ct[..., w]) & walking[:, None]
            ct[..., w] = torch.where(closer, t_w, ct[..., w])
            cs[..., w] = torch.where(closer, s * bk + arg, cs[..., w])
        if vote and s % vote == vote - 1:
            best = ct.min(-1).values.view(torch.int32)
            nxt = m2[:, min((s + 1) * kb, common.ROW - 1)]
            walking &= ~(best <= nxt[:, None]).all(1)
    if stats is not None:
        stats["steps"] = walked
    t, slot = _first_min(torch.where(cs >= 0, ct, inf),
                         torch.where(cs >= 0, cs, 1 << 30))
    won = slot < (1 << 30)
    if mode == "cid":
        c = torch.gather(m2, 1, torch.where(won, slot, 0) // common.CLUSTER)
        slot = c.clamp(0, C - 1) * common.CLUSTER + slot % common.CLUSTER
    if lab == "lab7":
        return torch.stack([torch.where(won, t, common.BIG),
                            torch.where(won, slot, 0).float()], -1)
    ids = torch.where(won, slot, -1).int()
    return torch.stack([torch.where(won, t, start), ids.view(torch.float32)],
                       -1)


@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("body", ["mt", "bw"])
def test_lab7_worker_split_matches_reference(body, R):
    """The model of the card's R-worker split and its (t, slot) combine
    equals lab7_reference bit for bit on exact duplicate triangles within
    a quad, across workers, within a step and across steps, and on NaN
    rays and rays with t_max < t_min; and on the script's own first
    tiles."""
    tris, meta, rays, kb, steps = _dup_lab7()
    cases = [(tris[body], meta, rays, kb, steps)]
    tables, m, r = _inputs("lab7", 32)
    cfg = _config("lab7", body, 32, 8)
    cases.append((_t(tables["tris12" if body == "bw" else "tris9"]), _t(m),
                  _t(r), cfg.kb, cfg.steps))
    for tr, me, ra, kb_, st in cases:
        want = kernel_lab5.lab7_reference(me, ra, tr, body, kb_, st)
        got = workers_brick("lab7", body, me, ra, tr, kb_, st, R)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    hits = want[..., 0] < common.BIG
    assert int(hits.sum()) > 100


def _fma_walk(monkeypatch, lab, mode, *args, stats=None):
    """walk_reference with the card's FMA bodies (common.bw_test_fma,
    mt_test_fma)."""
    monkeypatch.setattr(brick, "_bw_test", common.bw_test_fma)
    monkeypatch.setattr(brick, "_mt_test", common.mt_test_fma)
    try:
        return brick.walk_reference(lab, mode, *args, stats=stats)
    finally:
        monkeypatch.undo()


def _lab7_fma(monkeypatch, meta, rays, tris, body, kb, steps):
    """lab7_reference with the card's FMA bodies."""
    return _fma_walk(monkeypatch, "lab7", body, meta, rays, tris, kb, steps)


@pytest.mark.parametrize("body", ["mt", "bw"])
def test_lab7_agreement_holds_the_fma_body(monkeypatch, body):
    """Every ray of the FMA bodies' results (emulated in FP64) meets a rule
    of lab7_agreement against the plain version, on the script's first 256
    tiles at each (KB, steps) and on the duplicate scene, with t off by at
    most 1/2 of its bound."""
    tables, draws = common.lab7_inputs()
    tris = _t(tables["tris12" if body == "bw" else "tris9"])
    cases = []
    for cfg, meta, rays in draws:
        if cfg.mode == body:
            cases.append((_t(meta[:256 * common.ROW]), _t(rays[:256]), tris,
                          cfg.kb, cfg.steps))
    dup, meta, rays, kb, steps = _dup_lab7()
    cases.append((meta, rays, dup[body], kb, steps))
    for meta, rays, tris, kb, steps in cases:
        args = (meta, rays, tris, body, kb, steps)
        ref = kernel_lab5.lab7_reference(*args)
        fma = _lab7_fma(monkeypatch, *args)
        agree = kernel_lab5.lab7_agreement(fma, ref, meta, rays, tris, body)
        assert agree["rays_off"] == 0 and agree["ill_conditioned"] <= 1 and \
            agree["max_t_over_bound"] <= 0.5, agree


@pytest.mark.parametrize("body", ["mt", "bw"])
def test_lab7_agreement_rules(body):
    """lab7_agreement accepts a t one ulp off and a tie swap (a winner's
    copy one quad over), and refuses a wrong slot and a t off by more than
    its bound."""
    tris, meta, rays, kb, steps = _dup_lab7()
    tris = tris[body]
    ref = kernel_lab5.lab7_reference(meta, rays, tris, body, kb, steps)

    def hold(out):
        return kernel_lab5.lab7_agreement(out, ref, meta, rays, tris, body)
    assert hold(ref)["ok"]
    flat = ref.reshape(-1, 2)
    t, slot = flat[:, 0], flat[:, 1].long()
    hit = t < common.BIG
    # a winner in cluster 0's quad 0 at slot 0 (its copy: quad 1)
    dup = int(torch.nonzero(hit & (slot < 4)).reshape(-1)[0])
    far = int(torch.nonzero(hit & (t > 0.5)).reshape(-1)[0])

    def moved(i, t_=None, slot_=None):
        out = flat.clone()
        if t_ is not None:
            out[i, 0] = t_
        if slot_ is not None:
            out[i, 1] = float(slot_)
        return out.reshape(ref.shape)
    a = hold(moved(far, t_=float(np.nextafter(np.float32(t[far]),
                                              np.float32(np.inf)))))
    assert a["ok"] and a["t_bits_differ"] == 1
    a = hold(moved(dup, slot_=int(slot[dup]) + 4))
    assert a["ok"] and a["ties"] == 1 and a["ill_conditioned"] == 0
    a = hold(moved(far, slot_=(int(slot[far]) + 37) % (kb * 128 * steps)))
    assert not a["ok"] and a["rays_off"] == 1
    a = hold(moved(dup, slot_=int(slot[dup]) + 128))   # cluster 1's copy
    assert a["ok"] and a["ties"] == 1
    m = meta.reshape(rays.shape[0], common.ROW)
    s_ = int(slot[far])
    c = min(int(m[far // 32, s_ // 128]) & 1023, tris.shape[0] - 1)
    test = common.bw_fp64 if body == "bw" else common.mt_fp64
    r8 = rays.reshape(-1, 8)
    f = test(tris[c, :, 0, s_ % 128][None], r8[[far], 0:3], r8[[far], 3:6],
             r8[[far], 6])
    a = hold(moved(far, t_=float(t[far] + 4 * f["b_t"][0])))
    assert not a["ok"] and a["rays_off"] == 1 and a["max_t_over_bound"] > 1


def test_lab7_takes_32_ray_tiles_only():
    tables, meta, rays = _inputs("lab7", 32)
    with pytest.raises(ValueError, match="not tiles of 32"):
        lab_kernel.check_brick("lab7", "mt", _t(meta[:16 * common.ROW]),
                               _t(rays[:32].reshape(-1, 16, 8)[:32]),
                               _t(tables["tris9"]), 8, 6)


# ---------------------------------------------------------------------------
# L5's and L6's walk on L7's design (csrc/brick_lab.cu brick_walk_kernel):
# a warp a tile, R rays a lane at every TILE, running bests from
# min(t_max, 3e38), one (t, slot) combine after the walk, the exit a warp
# vote on each ray's t met over its workers; the FMA body, held tie-aware
# by brick.brick_agreement
# ---------------------------------------------------------------------------

WALK_MODES = [("lab5", "mt"), ("lab6", "fixed"), ("lab6", "slot"),
              ("lab6", "cid"), ("lab6", "while"), ("lab6", "while2")]


def _dup_brick(tile, seed=21):
    """The duplicate scene of _dup_lab7 for L5 and L6 at tile rays a
    tile: tris9, meta naming cluster 0 at slot 0 and at the next step's
    first slot and cluster 1 (cluster 0's copy) at slot 1 in every tile,
    and the rays, those with t_max < t_min kept so (t_min 5, t_max 1) and
    every 61st with a NaN t_max besides the NaN origins: (tris9, meta,
    rays, kb, steps)."""
    tris, _, rays, kb, steps = _dup_lab7(seed)
    rays = rays.clone()
    rays.view(-1, 8)[11::61, 7] = float("nan")
    rays = rays.reshape(-1, tile, 8)
    C = tris["mt"].shape[0]
    meta = np.random.default_rng(seed).integers(
        0, C, (rays.shape[0], common.ROW)).astype(np.int32)
    meta[:, 0], meta[:, 1], meta[:, kb] = 0, 1, 0
    return tris["mt"], _t(meta.reshape(-1)), rays, kb, steps


def _walk_cases(tile, n=16):
    """(meta, rays, tris9, kb, steps) on which the walk is held at tile
    rays a tile: the duplicate scene, and the first n tiles of the
    script's inputs (L6's (32, 8, 6) and (16, 8, 3), L5's (8, 2, 7)), each
    also with the crafted meta where the exit fires."""
    tris, meta, rays, kb, steps = _dup_brick(tile)
    cases = [(meta, rays, tris, kb, steps),
             (_t(_crafted(meta.numpy())), rays, tris, kb, steps)]
    src = "lab5" if tile == 8 else "lab6"
    cfg = next(c for c in CONFIGS[src] if c.tile == tile and
               c.kb == (2 if tile == 8 else 8))
    tables, m, r = _inputs(src, tile)
    m, r, tris = m[:n * common.ROW], _t(r[:n]), _t(tables["tris9"])
    cases += [(_t(mm), r, tris, cfg.kb, cfg.steps)
              for mm in (m, _crafted(m))]
    return cases


@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("tile", [8, 16, 32])
@pytest.mark.parametrize("lab,mode", WALK_MODES)
def test_walk_split_matches_reference(lab, mode, tile, R):
    """The model of the card's split at TILE 8, 16 and 32 and R = 1, 2, 4
    (32 R / TILE workers) equals walk_reference bit for bit, steps walked
    included, on exact duplicate triangles within a quad, across workers,
    within a step and across steps, on NaN rays and rays with t_max < t_min
    or a NaN t_max, and on the script's first tiles, each with the crafted
    meta too: while and while2 stop early there and nowhere else."""
    fired = False
    for meta, rays, tris, kb, steps in _walk_cases(tile):
        st_p, st_m = {}, {}
        want = brick.walk_reference(lab, mode, meta, rays, tris, kb, steps,
                                    st_p)
        got = workers_brick(lab, mode, meta, rays, tris, kb, steps, R, st_m)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert st_m == st_p
        fired |= st_p["steps"] < rays.shape[0] * steps
        assert brick.hits(want, _config("lab6", "fixed", 32, 8)) > 50
    assert fired == mode.startswith("while")


@pytest.mark.parametrize("lab,mode,tile,kb", [
    ("lab5", "mt", 8, 1), ("lab5", "mt", 32, 1), ("lab6", "cid", 16, 8),
    ("lab6", "while", 32, 8), ("lab6", "while2", 32, 8)])
def test_brick_agreement_holds_the_fma_body(monkeypatch, lab, mode, tile,
                                            kb):
    """Every ray of the FMA body's results (emulated in FP64) meets a rule
    of brick_agreement against the plain version, with t off by at most
    1/2 of its bound, on the script's first tiles (256; 64 at TILE 32 KB 1)
    and on the duplicate scene; while and while2 on the crafted meta (both
    inputs), where the FMA walk needs the plain version's steps per tile
    (walked_steps) and fewer than fixed."""
    cfg = _config(lab, mode, tile, kb)
    tables, meta, rays = _inputs(lab, tile)
    n = 64 if cfg.steps > 26 else 256
    meta = meta[:n * common.ROW]
    if mode.startswith("while"):
        meta = _crafted(meta)
    tris, dmeta, drays, dkb, dsteps = _dup_brick(tile)
    if mode.startswith("while"):
        dmeta = _t(_crafted(dmeta.numpy()))
    cases = [(_t(meta), _t(rays[:n]), _t(tables["tris9"]), cfg.kb,
              cfg.steps), (dmeta, drays, tris, dkb, dsteps)]
    for meta, rays, tris, kb_, steps in cases:
        args = (meta, rays, tris, kb_, steps)
        ref = brick.walk_reference(lab, mode, *args)
        fma = _fma_walk(monkeypatch, lab, mode, *args)
        walked = None
        if mode.startswith("while"):
            walked = [brick.walked_steps(lambda s, f=f: f(
                meta, rays, tris, kb_, s), steps) for f in (
                partial(_fma_walk, monkeypatch, lab, mode),
                partial(brick.walk_reference, lab, mode))]
        agree = brick.brick_agreement(lab, mode, fma, ref, meta, rays, tris,
                                      walked, kb_)
        assert agree["rays_off"] == 0 and agree["ill_conditioned"] <= 1 and \
            agree["max_t_over_bound"] <= 0.5 and agree["ok"], agree
        if walked is not None:
            assert agree["steps_differ"] == 0
            assert int(walked[0].sum()) < rays.shape[0] * steps


@pytest.mark.parametrize("mode", ["fixed", "cid"])
def test_brick_agreement_rules(mode):
    """brick_agreement accepts a t one ulp off and a tie swap (a winner's
    copy one quad over, or in cluster 1, cluster 0's copy), and refuses a
    wrong slot or cluster id, a t off by more than its bound, and a tile
    whose walked steps differ away from the exit's bound."""
    tris, meta, rays, kb, steps = _dup_brick(32)
    ref = brick.walk_reference("lab6", mode, meta, rays, tris, kb, steps)

    def hold(out, walked=None):
        return brick.brick_agreement("lab6", mode, out, ref, meta, rays,
                                     tris, walked, kb)
    assert hold(ref)["ok"]
    flat = ref.reshape(-1, 2)
    t, ids = flat[:, 0], flat[:, 1].view(torch.int32)
    hit = ids >= 0
    # a winner in cluster 0's quad 0 at slot 0 (its copy: quad 1, then
    # cluster 1), and one far from any copy
    dup = int(torch.nonzero(hit & (ids < 4)).reshape(-1)[0])
    far = int(torch.nonzero(hit & (t > 0.5) & (ids >= 256)).reshape(-1)[0])

    def moved(i, t_=None, id_=None):
        out = flat.clone()
        if t_ is not None:
            out[i, 0] = t_
        if id_ is not None:
            out[i, 1] = torch.tensor([id_], dtype=torch.int32).view(
                torch.float32)[0]
        return out.reshape(ref.shape)
    a = hold(moved(far, t_=float(np.nextafter(np.float32(t[far]),
                                              np.float32(np.inf)))))
    assert a["ok"] and a["t_bits_differ"] == 1
    a = hold(moved(dup, id_=int(ids[dup]) + 4))
    assert a["ok"] and a["ties"] == 1 and a["ill_conditioned"] == 0
    a = hold(moved(dup, id_=int(ids[dup]) + 128))
    assert a["ok"] and a["ties"] == 1
    a = hold(moved(far, id_=int(ids[far]) + 37))
    assert not a["ok"] and a["rays_off"] == 1
    a = hold(moved(far, id_=-1))
    assert not a["ok"] and a["rays_off"] == 1
    f = brick.brick_agreement("lab6", mode, ref, ref, meta, rays, tris)
    r8 = rays.reshape(-1, 8)
    c = int(ids[far]) // 128 if mode == "cid" else int(
        meta.reshape(-1, common.ROW)[far // 32, int(ids[far]) // 128])
    b = common.mt_fp64(tris[c, :, 0, int(ids[far]) % 128][None],
                       r8[[far], 0:3], r8[[far], 3:6], r8[[far], 6])
    a = hold(moved(far, t_=float(t[far] + 4 * b["b_t"][0])))
    assert f["ok"] and not a["ok"] and a["max_t_over_bound"] > 1
    n = rays.shape[0]
    same = torch.full((n,), steps)
    assert hold(ref, (same, same))["steps_differ"] == 0
    fewer = same.clone()
    fewer[far // 32] = 1
    a = hold(ref, (fewer, same))
    assert not a["ok"] and a["steps_differ"] == 1 and a["steps_off"] == 1


# ---------------------------------------------------------------------------
# L4 on the walk (csrc/brick_lab.cu brick_walk_kernel, kLab 4): each
# cluster staged in the warp's ring, worker w taking the quads w, w + 32 R /
# TILE, ... of each cluster (the quads of the step it would take in place);
# mt as L5 (running bests, the (t, slot) combine after the walk), mtfast
# each worker's smallest key of a step against the best from before it,
# met over the workers after the step; held by brick_agreement (mt) and
# brick.mtfast_agreement (mtfast)
# ---------------------------------------------------------------------------

def workers_mtfast(meta, rays, tris, kb, steps, R):
    """A plain torch model of L4 mtfast's split on the card (unfused body):
    worker w of the 32 R / TILE takes the quads q = w (mod 32 R / TILE) of
    each cluster of a step; each keeps the smallest key (t bits & ~1023) |
    lane of its share against the ray's best from before the step; the
    workers' keys meet in a minimum after the step's last cluster, and
    cand < bits(best) takes (cand & ~1023, step KB 128 + (cand & 1023)).
    Returns what brick returns."""
    n_tiles, tile = rays.shape[:2]
    C = tris.shape[0]
    rows = tris.reshape(C, 9, common.CLUSTER)
    m2 = meta.reshape(n_tiles, common.ROW)
    bk = kb * common.CLUSTER
    W = 32 * R // tile
    lane = torch.arange(bk, dtype=torch.int32)
    worker = lane % common.CLUSTER // 4 % W
    tmax = rays[..., 7]
    bt = torch.where(tmax > common.BIG, common.BIG, tmax)
    bi = torch.full((n_tiles, tile), -1, dtype=torch.int32)
    o = [rays[..., k, None] for k in range(3)]
    d = [rays[..., 3 + k, None] for k in range(3)]
    big = torch.iinfo(torch.int32).max
    for s in range(steps):
        orders = m2[:, s * kb:(s + 1) * kb].clamp(0, C - 1).long()
        tri = rows[orders].permute(0, 2, 1, 3).reshape(n_tiles, 9, 1, bk)
        keys = brick._mtfast_keys([tri[:, i] for i in range(9)], *o, *d,
                                  rays[..., 6, None], bt[..., None], lane)
        per_w = torch.stack([torch.where(worker == w, keys, big).min(-1)
                             .values for w in range(W)], -1)
        cand = per_w.min(-1).values
        closer = cand < bt.view(torch.int32)
        bt = torch.where(closer, (cand & ~1023).view(torch.float32), bt)
        bi = torch.where(closer, s * bk + (cand & 1023), bi)
    return torch.stack([bt, bi.view(torch.float32)], -1)


def _l4_cases(tile, kb):
    """(meta, rays, tris9, steps) of L4 at tile rays a tile and KB kb: the
    first 16 tiles of the script's inputs at its steps, and the duplicate
    scene (_dup_brick) at 3 steps."""
    cfg = _config("lab4", "mt", tile, kb)
    tables, meta, rays = _inputs("lab4", tile)
    tris, dmeta, drays, _, _ = _dup_brick(tile)
    return [(_t(meta[:16 * common.ROW]), _t(rays[:16]), _t(tables["tris9"]),
             cfg.steps), (dmeta, drays, tris, 3)]


@pytest.mark.parametrize("kb", [4, 8, 16])
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("mode", ["mt", "mtfast"])
def test_lab4_staged_split_matches_reference(mode, tile, kb):
    """The models of the card's L4 split at R = 4 (workers_brick for mt,
    its per-worker running bests and (t, slot) combine; workers_mtfast for
    mtfast, its per-worker key minima met after each step) equal
    walk_reference bit for bit at TILE 16 and 32 and KB 4, 8 and 16, on
    the script's first tiles and on the duplicate scene (NaN rays, NaN
    t_max, t_max < t_min); at KB 16 the models lose lane bit 10 as the
    script does."""
    lost = 0
    for meta, rays, tris, steps in _l4_cases(tile, kb):
        want = brick.walk_reference("lab4", mode, meta, rays, tris, kb, steps)
        got = (workers_brick("lab4", "mt", meta, rays, tris, kb, steps, 4)
               if mode == "mt" else
               workers_mtfast(meta, rays, tris, kb, steps, 4))
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert int((_ids(want) >= 0).sum()) > 50
        if mode == "mtfast" and kb == 16:
            mt = brick.walk_reference("lab4", "mt", meta, rays, tris, kb,
                                      steps)
            high = (got[..., 0] >= 0) & (_ids(mt) % 2048 >= 1024)
            lost += int((_ids(got)[high] == _ids(mt)[high] - 1024).sum())
    if mode == "mtfast" and kb == 16:
        assert lost > 0


_fma = common._fma


def _mtfast_keys_fma(rows, ox, oy, oz, dx, dy, dz, tmin, bt, lane):
    """csrc/brick_lab.cu mtfast_key_fma's arithmetic on the CPU (FMAs
    emulated in FP64, as common.mt_test_fma), brick._mtfast_keys's
    signature."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = rows
    hx = _fma(dy, e2z, -(dz * e2y))
    hy = _fma(dz, e2x, -(dx * e2z))
    hz = _fma(dx, e2y, -(dy * e2x))
    a = _fma(e1z, hz, _fma(e1y, hy, e1x * hx))
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u_n = _fma(sz, hz, _fma(sy, hy, sx * hx))
    qx = _fma(sy, e1z, -(sz * e1y))
    qy = _fma(sz, e1x, -(sx * e1z))
    qz = _fma(sx, e1y, -(sy * e1x))
    v_n = _fma(dz, qz, _fma(dy, qy, dx * qx))
    t_n = _fma(e2z, qz, _fma(e2y, qy, e2x * qx))
    sa = torch.where(a < 0, -1.0, 1.0)
    na, nu, nv, nt = a * sa, u_n * sa, v_n * sa, t_n * sa
    hit = (nu >= 0) & (nv >= 0) & (nu + nv <= na) & (nt >= tmin * na) & \
        (nt < bt * na) & (na > 0)
    tt = torch.where(hit, t_n / torch.where(na == 0, 1.0, na), common.BIG)
    return (tt.view(torch.int32) & ~1023) | lane


def _l4_fma(monkeypatch, mode, *args):
    """walk_reference of L4 with the card's FMA bodies."""
    monkeypatch.setattr(brick, "_mt_test", common.mt_test_fma)
    monkeypatch.setattr(brick, "_mtfast_keys", _mtfast_keys_fma)
    try:
        return brick.walk_reference("lab4", mode, *args)
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("tile,kb", [(16, 4), (32, 4), (32, 16)])
@pytest.mark.parametrize("mode", ["mt", "mtfast"])
def test_lab4_holds_the_fma_bodies(monkeypatch, mode, tile, kb):
    """The FMA bodies' results (emulated in FP64) meet L4's holds against
    the plain version, on the script's first 256 tiles and on the
    duplicate scene: mt by brick_agreement (t within 1/2 of its bound),
    mtfast by mtfast_agreement (t within a quantum, signs equal)."""
    cfg = _config("lab4", mode, tile, kb)
    tables, meta, rays = _inputs("lab4", tile)
    tris, dmeta, drays, _, _ = _dup_brick(tile)
    cases = [(_t(meta[:256 * common.ROW]), _t(rays[:256]),
              _t(tables["tris9"]), cfg.steps), (dmeta, drays, tris, 3)]
    for meta, rays, tris, steps in cases:
        args = (meta, rays, tris, kb, steps)
        ref = brick.walk_reference("lab4", mode, *args)
        fma = _l4_fma(monkeypatch, mode, *args)
        if mode == "mt":
            agree = brick.brick_agreement("lab4", mode, fma, ref, meta, rays,
                                          tris)
            assert agree["ok"] and agree["max_t_over_bound"] <= 0.5, agree
        else:
            agree = brick.mtfast_agreement(fma, ref, meta, rays, tris, kb,
                                           ill_share=1e-3)
            assert agree["ok"] and agree["max_quanta"] <= 1, agree
            assert agree["t_negative"][0] == agree["t_negative"][1] > 0


def test_mtfast_agreement_rules():
    """mtfast_agreement accepts the plain version against itself and a t
    one quantum off (a crossing), and flags a wrong id off a tie, a t two
    quanta off (no bit 10 on either side), a turned sign, and an id
    moved at more than its share of the rays."""
    cfg = _config("lab4", "mtfast", 32, 4)
    tables, meta, rays = _inputs("lab4", 32)
    meta, rays, tris = _t(meta), _t(rays), _t(tables["tris9"])
    ref = brick.walk_reference("lab4", "mtfast", meta, rays, tris, cfg.kb,
                               cfg.steps)

    def hold(out, share=common.ILL_SHARE):
        return brick.mtfast_agreement(out, ref, meta, rays, tris, cfg.kb,
                                      share)
    a = hold(ref)
    assert a["ok"] and a["ids_differ"] == 0 and a["rays_off"] == 0
    flat = ref.reshape(-1, 2)
    bits = flat[:, 0].contiguous().view(torch.int32)
    ids = flat[:, 1].contiguous().view(torch.int32)
    hit = torch.nonzero((ids >= 0) & (flat[:, 0] > 0.5) &
                        (bits & 1024 == 0)).reshape(-1)
    i, j = int(hit[0]), int(hit[1])

    def moved(ray, dbits=0, id_=None, neg=False):
        out = flat.clone()
        b = out[:, 0].contiguous().view(torch.int32)
        b[ray] += dbits
        out[:, 0] = b.view(torch.float32)
        if neg:
            out[ray, 0] = -out[ray, 0]
        if id_ is not None:
            out[ray, 1] = torch.tensor([id_], dtype=torch.int32).view(
                torch.float32)[0]
        return out.reshape(ref.shape)
    for db in (1024, -1024):
        a = hold(moved(i, db))
        assert a["ok"] and a["t_bits_differ"] == 1 and a["max_quanta"] == 1
    a = hold(moved(i, 2048))
    assert not a["ok"] and a["rays_off"] == 1 and a["max_quanta"] == 2
    a = hold(moved(i, neg=True))
    assert not a["ok"] and a["signs_differ"] == 1 and a["rays_off"] == 1
    a = hold(moved(j, id_=int(ids[j]) + 37))
    assert not a["ok"] and a["ids_differ"] == 1 and a["rays_off"] == 1
    assert not a["held"][0]["ok"]
    # a key tie: the winner's triangle copied one quad over, the copy named
    tris2 = tris.clone()
    c = int(meta.reshape(-1, common.ROW)[j // 32, int(ids[j]) // 128])
    lane = int(ids[j]) % 128
    tris2[c, :, 0, lane ^ 4] = tris2[c, :, 0, lane]
    tie = moved(j, id_=int(ids[j]) ^ 4)
    a = brick.mtfast_agreement(tie, ref, meta, rays, tris2, cfg.kb, 1.0)
    assert a["ok"] and a["ids_differ"] == 1 and a["held"][0]["key_tie"]
    a = brick.mtfast_agreement(tie, ref, meta, rays, tris2, cfg.kb)
    assert not a["ok"] and a["rays_off"] == 0    # 1 of 2,048 rays: > 1e-4


@pytest.mark.parametrize("names", [
    {"brick_walk_kernelILi6ELi0ELi0ELi32ELi4EE": ("lab6 fixed TILE=32", 4,
                                                  9),
     "brick_walk_kernelILi6ELi0ELi1ELi8ELi2EE": ("lab6 cid TILE=8", 2, 9),
     "brick_walk_kernelILi7ELi2ELi0ELi32ELi4EE": ("lab7 bw", 4, 12),
     "brick_walk_kernelILi4ELi0ELi0ELi32ELi4EE": ("lab4 mt TILE=32", 4, 9),
     "brick_walk_kernelILi4ELi1ELi0ELi16ELi4EE": ("lab4 mtfast TILE=16", 4,
                                                  9)},
    {"brick_walk_kernelILi6ELi0ELi3ELi16ELi4EE": ("lab6 while2 TILE=16", 4,
                                                  9),
     "brick_walk_kernelILi7ELi2ELi0ELi32ELi4EE": ("lab7 bw", 4, 12),
     "brick_kernelILb1ELi1ELi0EE": ("lab4 mtfast", 1, 9)},
    {"brick_kernelILb0ELi0ELi0EE": ("lab6 fixed", 1, 9),
     "brick_kernelILb0ELi0ELi2EE": ("lab6 while", 1, 9),
     "lab7_kernelILi0ELi4EE": ("lab7 mt", 4, 9),
     "brick_kernelILb1ELi0ELi0EE": ("lab4 mt", 1, 9)}],
    ids=["this tree", "one slice older", "two slices older"])
def test_lab_test_loops_names_the_brick_walks(monkeypatch, names):
    """app/sass.lab_test_loops names L4-L7's instances of the walk (L4's
    per body and TILE, L6's per variant and TILE, L5 being fixed's) and
    older checkouts' brick_kernel (L4 staged per body, L5 and L6 per
    variant, R = 1) and lab7_kernel, with their rays a lane and
    instructions per test (9 row loads a pass: 4 R tests of
    Möller-Trumbore, 3 R of Baldwin-Weber)."""
    from test_torch_tile_lab import _SASS_LOOP
    from tauray_torch.app import sass
    monkeypatch.setattr(sass, "functions", lambda path: {
        f"_ZN12_GLOBAL__N_1{len(n)}{n}EvPKiPKfS4_iiiiPf": _SASS_LOOP
        for n in names})
    loops = sass.lab_test_loops("lib.so")
    assert set(loops) == {v[0] for v in names.values() if v}
    for want in names.values():
        if want is None:
            continue
        inst, rays, nf = want
        st = loops[inst]
        assert st["rays_a_lane"] == rays and st["loads128"] == 9
        assert st["tests"] == pytest.approx(4 * rays * 9 / nf)
        assert st["instructions_per_test"] == pytest.approx(
            11 / (4 * rays * 9 / nf))


# ---------------------------------------------------------------------------
# The faults of the scripts, kept (ROADMAP Queue 3)
# ---------------------------------------------------------------------------

def _ids(out):
    return out[..., 1].view(torch.int32)


def test_mtfast_negates_t_of_back_facing_hits():
    """Fault 2 (kernel_lab2.py:195 divides t_n by |a|): on the first 64
    tiles of k7 (TILE 32, KB 4, 13 steps) mtfast gives t < 0 exactly on the
    rays where it departs from mt (884 of the 965 that hit: a back-facing
    hit's negative key wins every later minimum); wherever its t >= 0 it
    names mt's triangle, its t within one quantum of the key (2^-13)."""
    tables, meta, rays = _inputs("lab4", 32)
    mt, fast = (_plain("lab4", _config("lab4", m, 32, 4), meta, rays,
                       tables["tris9"]) for m in ("mt", "mtfast"))
    neg = fast[..., 0] < 0
    bits = (mt[..., 0].view(torch.int32).long() -
            fast[..., 0].view(torch.int32)).abs()
    departs = (_ids(mt) != _ids(fast)) | (bits > 1024)
    assert torch.equal(departs, neg)
    assert int(neg.sum()) == 884 and int((_ids(mt) >= 0).sum()) == 965
    assert torch.equal(_ids(fast)[~neg], _ids(mt)[~neg])
    assert bool((bits[~neg] <= 1024).all())


def test_mtfast_loses_lane_bit_10_at_kb_16():
    """Fault 3 (kernel_lab2.py:198, :204): at KB = 16 a step has 2,048
    lanes, and the key's 10 id bits drop lane bit 10. On the rays where
    mtfast's t >= 0 and mt's winning slot in its step is >= 1,024 (30 of
    the first 64 tiles of k7f, TILE 32, KB 16, 3 steps), mtfast's id is
    mt's less 1,024; no ray there has two keys tied within one quantum
    (0 exceptions), and below slot 1,024 (20 rays) the ids agree."""
    tables, meta, rays = _inputs("lab4", 32)
    mt, fast = (_plain("lab4", _config("lab4", m, 32, 16), meta, rays,
                       tables["tris9"]) for m in ("mt", "mtfast"))
    im, i_f = _ids(mt), _ids(fast)
    ok = (fast[..., 0] >= 0) & (im >= 0)
    high = ok & (im % 2048 >= 1024)
    assert int(high.sum()) == 30 and int((ok & ~high).sum()) == 20
    assert int((i_f[high] != im[high] - 1024).sum()) == 0
    assert torch.equal(i_f[ok & ~high], im[ok & ~high])


def _crafted(meta):
    """The script's meta with every 8th entry 0x7f000000: the exit's bound
    (the entry of the next step's first slot) then exceeds every t < 1."""
    meta = meta.copy()
    meta[::8] = 0x7F000000
    return meta


def test_lab6_exit_never_fires_on_the_scripts_meta():
    """Fault 4 (kernel_lab4.py:135-138 compares t bits with a cluster id
    below 636): on the script's own inputs while and while2 walk every
    step and equal fixed bit for bit; on the crafted meta they stop after
    the first / second step, with fewer hits than fixed."""
    tables, meta, rays = _inputs("lab6", 32)
    tris = tables["tris9"]
    fixed = _config("lab6", "fixed", 32, 8)
    for m, exits in ((meta, False), (_crafted(meta), True)):
        want = _plain("lab6", fixed, m, rays, tris)
        for v, first in (("while", 1), ("while2", 2)):
            stats = {}
            got = _plain("lab6", fixed._replace(mode=v), m, rays, tris,
                         stats)
            if exits:
                assert stats["steps"] == first * N_TILES
                assert brick.hits(got, fixed) < brick.hits(want, fixed)
            else:
                assert stats["steps"] == fixed.steps * N_TILES
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32))


@pytest.mark.parametrize("variant", ["while", "while2"])
def test_lab6_exit_fires_in_the_script_alike(monkeypatch, variant):
    """On the crafted meta the script's while / while2 stop as the plain
    version does (fault 4's other side)."""
    cfg = _config("lab6", variant, 32, 8)
    tables, meta, rays = _inputs("lab6", 32)
    got = _check_script(monkeypatch, "lab6", cfg, _crafted(meta))
    fixed = _plain("lab6", cfg._replace(mode="fixed"), _crafted(meta), rays,
                   tables["tris9"])
    assert brick.hits(got, cfg) < brick.hits(fixed, cfg)


# ---------------------------------------------------------------------------
# The scripts' mains: inputs and tests a ray
# ---------------------------------------------------------------------------

def _digest(x):
    x = np.asarray(x)
    return x.dtype.str, x.shape, hashlib.sha256(x.tobytes()).hexdigest()


def _main_block(path):
    """The code under the script's `if __name__ == "__main__":`."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.If) and "__main__" in ast.unparse(node.test):
            return compile(ast.Module(body=node.body, type_ignores=[]),
                           str(path), "exec")
    raise AssertionError(f"{path} has no main block")


@functools.lru_cache(maxsize=None)
def _captured(lab):
    """Runs lab's script's main with pl.pallas_call replaced by a recorder
    that returns zeros, jax.jit by the identity and scan_time by one call
    of f(0): ({table: digest}, [one dict per run: make_kernel's arguments
    and BK, steps, rays a run, the meta and rays digests])."""
    name = SCRIPT[lab]
    runs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(SCRIPTS))
        mp.setattr(sys, "argv", [name])

        def record(kernel, out_shape, grid_spec):
            def call(meta, rays, tris):
                runs[-1].update(steps=kernel.keywords["steps"],
                                rays=_digest(rays), meta=_digest(meta),
                                n_rays=rays.shape[0] * rays.shape[1])
                return jnp.zeros(out_shape.shape, out_shape.dtype)
            return call
        mp.setattr(pl, "pallas_call", record)
        mp.setattr(jax, "jit", lambda f: f)
        mod = _load(name)
        tables = {k: _digest(getattr(mod, k)) for k in ("tris9", "tris12")
                  if hasattr(mod, k)}
        make = mod.make_kernel

        def make_kernel(*args):
            kernel, second = make(*args)
            runs.append(dict(args=args, second=second))
            return kernel, second

        def scan_time(f, n=32, warmup=True):
            f(jnp.int32(0))
            return 1.0
        mp.setattr(mod, "make_kernel", make_kernel)
        mp.setattr(mod, "scan_time", scan_time)
        with contextlib.redirect_stdout(io.StringIO()):
            exec(_main_block(SCRIPTS / f"{name}.py"), mod.__dict__)
    return tables, runs


def _bk(lab, run):
    """The run's triangles a step, as its run counts tests: make_kernel's
    BK (kernel_lab2-4.py), or KB * 128 (kernel_lab5.py:189)."""
    return run["args"][0] * 128 if lab == "lab7" else run["second"]


@pytest.mark.parametrize("lab", ["lab4", "lab5", "lab6", "lab7"])
def test_inputs_are_the_scripts(lab):
    """Each script's main, its kernel recorded, draws the table(s) and each
    run's meta and rays that common.labN_inputs draws, bit for bit, for
    configurations that match common.labN_configs (rays a tile, KB, steps)
    in main's order. Digests, not arrays: L7's six 128 MB metas never sit
    in memory together."""
    tables, runs = _captured(lab)
    mine, draws = {"lab4": common.lab4_inputs, "lab5": common.lab5_inputs,
                   "lab6": common.lab6_inputs,
                   "lab7": common.lab7_inputs}[lab]()
    assert {k: _digest(v) for k, v in mine.items()} == tables
    n = 0
    for (cfg, meta, rays), run in zip(draws, runs):
        assert (run["meta"], run["rays"]) == (_digest(meta), _digest(rays))
        assert run["steps"] == cfg.steps
        assert _bk(lab, run) == cfg.kb * 128
        assert run["n_rays"] == cfg.n_tiles * cfg.tile
        n += 1
    assert n == len(runs) == len(CONFIGS[lab]) - 6 * (lab == "lab4")


@pytest.mark.parametrize("lab", ["lab4", "lab5", "lab6", "lab7"])
def test_bound_counts_the_scripts_tests(lab):
    """bounds.CONFIGS's rays and tests a ray are those of the largest
    configuration of the script's main, reckoned as its run reckons tests
    (R * steps * BK); L4's is 13 steps of 4 clusters of 128 (6,656 tests
    a ray, 0.2995 ms), and brick_bound's headline equals lab_bound's."""
    _, runs = _captured(lab)
    per_ray = max(r["steps"] * _bk(lab, r) for r in runs)
    n_rays = {r["n_rays"] for r in runs}
    key = f"L{lab[3:]}"
    site, rays, tests, *_ = bounds.CONFIGS[key]
    assert (n_rays, tests) == ({rays}, per_ray)
    assert site.startswith(f"scripts/{SCRIPT[lab]}.py:")
    head = {"lab4": ("mt", 32, 4), "lab5": ("mt", 32, 1),
            "lab6": ("fixed", 32, 8), "lab7": ("mt", 32, 8)}[lab]
    cfg = _config(lab, *head)
    assert cfg.steps * cfg.kb * 128 == per_ray
    assert bounds.brick_bound(cfg) == bounds.lab_bound(key)
    if lab == "lab4":
        assert per_ray == 6656
        assert round(bounds.lab_bound(key)[0], 4) == 0.2995


# ---------------------------------------------------------------------------
# Entry points, wrappers, the build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lab", [kernel_lab2, kernel_lab3, kernel_lab4,
                                 kernel_lab5], ids=["L4", "L5", "L6", "L7"])
def test_brick_entry_point_needs_a_card(monkeypatch, lab):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        lab.main([])


@pytest.mark.parametrize("lab", [kernel_lab2, kernel_lab3, kernel_lab4,
                                 kernel_lab5], ids=["L4", "L5", "L6", "L7"])
def test_brick_run_on_the_cpu(lab):
    """run() walks every configuration of the script's main, in its order,
    on its inputs (here their first tile): each result is the plain
    version's, with its tests' rate and bound."""
    res = lab.run(torch.device("cpu"), tiles=1)
    name = lab.__name__.rsplit(".", 1)[1]
    labkey = next(k for k, v in SCRIPT.items() if v == name)
    want = [c.label for c in CONFIGS[labkey] if not c.label.startswith("k8")]
    assert [r["cfg"].label for r in res] == want
    for r in res:
        c = r["cfg"]
        assert r["out"].shape == (1, c.tile, 2) and c.n_tiles == 1
        ref = brick.walk_reference(c.lab, c.mode, r["meta"], r["rays"],
                                   r["tris"], c.kb, c.steps)
        assert torch.equal(r["out"].view(torch.int32),
                           ref.view(torch.int32))
        assert r["bound_ms"] > 0 and r["gtests_s"] > 0


@pytest.mark.parametrize("lab,first", [
    (kernel_lab2, "k6 TILE=16 KB=4" + " " * 19 + " steps=6: "),
    (kernel_lab3, "vmem TILE=8 KB=1" + " " * 12 + " steps=14: "),
    (kernel_lab4, "fixed  TILE=32 KB= 8 steps=6: "),
    (kernel_lab5, "mt  KB= 8 steps=6: ")], ids=["L4", "L5", "L6", "L7"])
def test_brick_entry_point_prints_the_scripts_lines(monkeypatch, capsys,
                                                    lab, first):
    """main(["--device=cpu"]) prints the script's line per configuration
    (here with run cut to one tile of each): label, steps, ms, us a tile,
    G tests/s, then the bound."""
    run = lab.run
    monkeypatch.setattr(lab, "run", lambda dev: run(dev, reps=1, tiles=1))
    assert lab.main(["--device=cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == {kernel_lab2: 12, kernel_lab3: 12,
                          kernel_lab4: 15, kernel_lab5: 6}[lab]
    assert lines[0].startswith(first)
    assert all("host ms (cpu plain)" in ln and "us/tile" in ln and
               "G tests/s; bound " in ln for ln in lines)


def test_brick_wrappers_check_their_arguments():
    cfg = _config("lab4", "mt", 32, 4)
    tables, meta, rays = _inputs("lab4", 32)
    args = [_t(meta), _t(rays), _t(tables["tris9"])]
    with pytest.raises(ValueError, match="no mode"):
        lab_kernel.check_brick("lab5", "mtfast", *args, 4, 13)
    with pytest.raises(ValueError, match="meta entries"):
        lab_kernel.check_brick("lab4", "mt", args[0][:-1], *args[1:], 4, 13)
    with pytest.raises(ValueError, match=r"not \(C, 12, 1, 128\)"):
        lab_kernel.check_brick("lab7", "bw", *args, 8, 6)
    with pytest.raises(ValueError, match="KB 32"):
        lab_kernel.check_brick("lab4", "mt", *args, 32, 1)
    lab_kernel.check_brick("lab4", "mt", *args, cfg.kb, cfg.steps)
    meta_dev = torch.zeros(1, device="meta")
    with pytest.raises(ValueError, match="no lab kernel"):
        kernel_lab2.lab4(args[0], meta_dev, args[2], "mt", 4, 13)
