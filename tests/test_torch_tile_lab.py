"""The last four TPU lab kernels' ports (tauray_torch/lab/kernel_lab.py:
L1-L3; tauray_torch/lab/mxu_lab.py: L12) against the scripts they port,
scripts/kernel_lab.py and scripts/mxu_lab.py, on the CPU. Each script's own
kernel functions (k0-k3, k4, make_k5(G), common(mt_body),
common(plucker_body)) run under pl.pallas_call(..., interpret=True) with
its run's grid spec (the pallas_call patched inside the test, no file
changed): L1 and L2 at 16 tiles (L2: two grid steps of 8), L3 at 16 and 32
tiles with G 8 and 16, L12 at 64 tiles (two grid steps of 32); the lab's
plain torch version (the wrappers take it for CPU tensors) runs on the
same inputs. mxu_lab.py runs both its benchmarks when imported: it is
executed here with its two top-level run(...) calls dropped.

Tolerances:
  * k0, k1, k2: bit for bit;
  * k3, k4, k5 and L12 mt: t within 1e-5 relative and absolute (XLA:CPU
    contracts products into FMAs, torch does not), ids exact but on at
    most 2 rays of a run, each within 1e-5 of an edge or of t_min in FP64,
    or whose two winners' t tie within 1e-5 (tests/test_torch_brick_lab.py's
    rule);
  * L12 plucker: ids exact but where a side value or the denominator of
    either winner lies within 1e-5 of 0 in FP64, or the two t tie within
    1e-5; t within 1e-6 relative (only the products' summation order
    differs).

The exit of k4 and k5 never fires on the script's meta (its tnear entries
are cluster ids below 636, and no t in (0, 1) has int32 bits that small): k4
and k5 equal k3 bit for bit there, in the plain version and in the script.
With the tnear third of each row set to 0x7f000000 they stop after the
first step, in both. The scripts' mains also run with pallas_call
replaced by a recorder: their seeded inputs equal common.lab1_inputs and
common.lab12_inputs (sha256 digests) and their tests a ray give
bounds.CONFIGS.

The card's one template for k0-k5 (csrc/tile_lab.cu tile_walk_kernel) is
modelled here: its W-warp splits (k4, k5: a (t, slot) combine after every
step and the exit on the combined best; k3: each warp's own best and one
combine after the walk) equal the plain versions bit for bit; its
addressing of the three layouts reads tile_inputs' arrays and writes in
flat's order; its FMA body (common.mt_test_fma) meets
kernel_lab.lab3_agreement for k3, k4 and k5, and makes the three equal bit
for bit where the exit never fires."""

import ast
import contextlib
import functools
import hashlib
import importlib.util
import io
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tauray_torch.lab import (bounds, common, kernel_lab, kernel_lab11,
                              lab_kernel, mxu_lab)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"
T_TOL = 1e-5
EDGE = 1e-5
MAX_DEPARTING = 2
PLUCKER_RTOL = 1e-6
N_TILES = 16
N_TILES_L12 = 64


def _load(name, drop_calls=False):
    """scripts/<name>.py as a module (its module-level draws run); with
    drop_calls, its top-level expression statements (mxu_lab.py's two
    run(...) calls) are left out."""
    path = SCRIPTS / f"{name}.py"
    if not drop_calls:
        spec = importlib.util.spec_from_file_location(f"_tile_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    tree = ast.parse(path.read_text())
    tree.body = [n for n in tree.body if not isinstance(n, ast.Expr) or
                 isinstance(n.value, ast.Constant)]
    mod = types.ModuleType(f"_tile_{name}")
    mod.__file__ = str(path)
    exec(compile(tree, str(path), "exec"), mod.__dict__)
    return mod


def _script(name, monkeypatch, drop_calls=False):
    """scripts/<name>.py as a module, its Pallas kernels in interpret
    mode."""
    monkeypatch.syspath_prepend(str(SCRIPTS))
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    return _load(name, drop_calls)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@functools.lru_cache(maxsize=None)
def _l1_inputs(n_tiles=N_TILES):
    """The first n_tiles tiles of the script's rays (columns (8, R)), its
    tris9 and meta, as numpy."""
    cols, tris9, meta = common.lab1_inputs()
    return (cols[:, :n_tiles * common.TILE_L1], tris9,
            meta[:n_tiles * common.ROW_L1])


def _crafted(meta):
    """The script's meta with the tnear third of every row (entries 1,024
    to 2,047) 0x7f000000: the exit's bound then exceeds every t < 1."""
    m = meta.reshape(-1, common.ROW_L1).copy()
    m[:, common.CPAD:2 * common.CPAD] = 0x7F000000
    return m.reshape(-1)


def _counts(n_tiles, steps):
    return np.full((n_tiles,), steps * common.KB_L1, np.int32)


# ---------------------------------------------------------------------------
# The scripts' kernels in interpret mode, with their runs' grid specs
# ---------------------------------------------------------------------------

def _hbm():
    return pl.BlockSpec(memory_space=pltpu.MemorySpace.HBM)


def _l1_pallas(mod, kernel, steps, meta, cols, tris9):
    """run's call (kernel_lab.py:38-64): t (R, 1) f32, id (R, 1) i32."""
    n_tiles = cols.shape[1] // mod.TILE
    col = pl.BlockSpec((mod.TILE, 1), lambda t, *_: (t, 0),
                       memory_space=pltpu.VMEM)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(n_tiles,),
        in_specs=[_hbm()] + [col] * 8 + [_hbm()], out_specs=[col] * 2,
        scratch_shapes=[pltpu.VMEM((2, 9, 1, mod.BK), jnp.float32),
                        pltpu.SMEM((2 * mod.row,), jnp.int32),
                        pltpu.SemaphoreType.DMA((2,)),
                        pltpu.SemaphoreType.DMA((2, mod.KB))])
    out_shapes = [jax.ShapeDtypeStruct((n_tiles * mod.TILE, 1), jnp.float32),
                  jax.ShapeDtypeStruct((n_tiles * mod.TILE, 1), jnp.int32)]
    t, i = pl.pallas_call(kernel, out_shape=out_shapes, grid_spec=grid_spec)(
        jnp.asarray(_counts(n_tiles, steps)), jnp.asarray(meta),
        *[jnp.asarray(c[:, None]) for c in cols], jnp.asarray(tris9))
    return np.asarray(t), np.asarray(i)


def _grouped_pallas(mod, kernel, g, rays, ray_block, out_block, steps, meta,
                    tris9):
    """run_k4's and run_k5's call (kernel_lab.py:401-426, :564-588)."""
    n_tiles = rays.shape[0]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(n_tiles // g,),
        in_specs=[_hbm(),
                  pl.BlockSpec((g, *ray_block), lambda b, *_: (b, 0, 0),
                               memory_space=pltpu.VMEM), _hbm()],
        out_specs=pl.BlockSpec((g, *out_block), lambda b, *_: (b, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((2, 9, 1, mod.BK), jnp.float32),
                        pltpu.SMEM((2 * g * mod.row,), jnp.int32),
                        pltpu.SemaphoreType.DMA((2,)),
                        pltpu.SemaphoreType.DMA((2, mod.KB))])
    out_shape = jax.ShapeDtypeStruct((n_tiles, *out_block), jnp.float32)
    return np.asarray(pl.pallas_call(kernel, out_shape=out_shape,
                                     grid_spec=grid_spec)(
        jnp.asarray(_counts(n_tiles, steps)), jnp.asarray(meta),
        jnp.asarray(rays), jnp.asarray(tris9)))


def _rows(cols):
    return np.ascontiguousarray(cols.T).reshape(-1, common.TILE_L1, 8)


def _k4_pallas(mod, steps, meta, cols, tris9):
    planes = np.ascontiguousarray(_rows(cols).transpose(0, 2, 1))
    return _grouped_pallas(mod, mod.k4, mod.G, planes, (8, mod.TILE),
                           (2, mod.TILE), steps, meta, tris9)


def _k5_pallas(mod, g, steps, meta, cols, tris9):
    return _grouped_pallas(mod, mod.make_k5(g), g, _rows(cols),
                           (mod.TILE, 8), (mod.TILE, 2), steps, meta, tris9)


def _l12_pallas(mod, mode, inp):
    """run's call (mxu_lab.py:45-69) over inp's tiles."""
    n_tiles = inp["order"].shape[0]
    G, TILE = mod.G, mod.TILE
    body, tris = ((mod.mt_body, inp["tris9"]) if mode == "mt" else
                  (mod.plucker_body, inp["tris24"]))

    def spec(w):
        return pl.BlockSpec((G, TILE, w), lambda b, *_: (b, 0, 0),
                            memory_space=pltpu.VMEM)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(n_tiles // G,),
        in_specs=[spec(3), spec(3), spec(2), _hbm()], out_specs=spec(2),
        scratch_shapes=[pltpu.VMEM((2, tris.shape[1], 1, mod.BK),
                                   jnp.float32),
                        pltpu.SemaphoreType.DMA((2, mod.KB))])
    out_shape = jax.ShapeDtypeStruct((n_tiles, TILE, 2), jnp.float32)
    return np.asarray(pl.pallas_call(mod.common(body), out_shape=out_shape,
                                     grid_spec=grid_spec)(
        *(jnp.asarray(inp[k]) for k in ("order", "o3", "d3", "mm2")),
        jnp.asarray(tris)))


# ---------------------------------------------------------------------------
# The tie-aware holds
# ---------------------------------------------------------------------------

def _mt64(w, o, d, tmin):
    """Möller-Trumbore in FP64: (t, the signed distance from the nearest
    boundary: u, v, 1 - u - v and (t - t_min) / max(1, |t|))."""
    v0, e1, e2 = w[0:3], w[3:6], w[6:9]
    h = np.cross(d, e2)
    f = 1.0 / (e1 @ h)
    s = o - v0
    q = np.cross(s, e1)
    u, v, t = f * (s @ h), f * (d @ q), f * (e2 @ q)
    return t, min(u, v, 1 - u - v, (t - tmin) / max(1.0, abs(t)))


def _plucker64(w, o, d):
    """plucker_body in FP64: (t, the smallest |s0|, |s1|, |s2|, |den|)."""
    u6 = np.concatenate([d, np.cross(d, o)])
    s = [u6 @ w[6 * e:6 * e + 6] for e in range(3)]
    den = sum(s)
    t = (-o @ w[18:21] + w[21]) / den
    return t, min(abs(x) for x in (*s, den))


def _departures(got_t, got_id, want_t, want_id, tri_of, ray_of, plucker):
    """Rays whose ids differ, each checked in FP64 (tie-aware): a winner
    within EDGE of a boundary (an edge or t_min; plucker: a side value or
    den near 0), or the two winners' t tie within T_TOL of max(1, |t|).
    Returns (departing mask, the ones not so explained)."""
    off = got_id != want_id
    unexplained = []
    for idx in map(tuple, np.argwhere(off)):
        o, d, tmin = ray_of(idx)
        tests = []
        for i in (got_id[idx], want_id[idx]):
            if i >= 0:
                w = tri_of(idx, int(i)).astype(np.float64)
                tests.append(_plucker64(w, o, d) if plucker else
                             _mt64(w, o, d, tmin))
        edge = min(abs(m) for _, m in tests) <= EDGE
        tie = len(tests) == 2 and abs(tests[0][0] - tests[1][0]) <= \
            T_TOL * max(1.0, abs(tests[0][0]))
        if not (edge or tie):
            unexplained.append(idx)
    return off, unexplained


def _hold(got_t, got_id, want_t, want_id, tri_of, ray_of, plucker=False):
    off, unexplained = _departures(got_t, got_id, want_t, want_id, tri_of,
                                   ray_of, plucker)
    assert not unexplained, unexplained
    if plucker:
        np.testing.assert_allclose(got_t[~off], want_t[~off],
                                   rtol=PLUCKER_RTOL, atol=0)
    else:
        assert off.sum() <= MAX_DEPARTING
        np.testing.assert_allclose(got_t[~off], want_t[~off], rtol=T_TOL,
                                   atol=T_TOL)
    return int(off.sum())


def _tile_hold(got_t, got_id, want_t, want_id, cols, tris9):
    """L1-L3's hold on (n_tiles, 128) t and ids: an id is cluster * 128 +
    lane."""
    rows = _rows(cols).astype(np.float64)

    def tri_of(idx, i):
        return tris9[i // 128, :, 0, i % 128]

    def ray_of(idx):
        r = rows[idx]
        return r[0:3], r[3:6], r[6]
    return _hold(got_t, got_id, want_t, want_id, tri_of, ray_of)


def _ids(x):
    return np.ascontiguousarray(x).view(np.int32)


# ---------------------------------------------------------------------------
# L1-L3 against the script
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["k0", "k1", "k2", "k3"])
def test_lab1_matches_script(monkeypatch, mode):
    """L1's mode at 0, 1 and (k2, k3) 8 steps: k0-k2 bit for bit, k3 by
    the tie-aware rule."""
    mod = _script("kernel_lab", monkeypatch)
    cols, tris9, meta = _l1_inputs()
    np.testing.assert_array_equal(tris9, np.asarray(mod.tris9))
    for steps in (0, 1) if mode in ("k0", "k1") else (0, 1, 8):
        want_t, want_id = _l1_pallas(mod, getattr(mod, mode), steps, meta,
                                     cols, tris9)
        got_t, got_id = kernel_lab.lab1(_t(_counts(N_TILES, steps)),
                                        _t(meta), _t(cols), _t(tris9), mode)
        assert got_t.shape == want_t.shape and got_id.dtype == torch.int32
        got_t, got_id = got_t.numpy(), got_id.numpy()
        if mode == "k3" and steps:
            _tile_hold(got_t.reshape(N_TILES, 128),
                       got_id.reshape(N_TILES, 128),
                       want_t.reshape(N_TILES, 128),
                       want_id.reshape(N_TILES, 128), cols, tris9)
            assert (got_id >= 0).sum() >= N_TILES * 128 // 4
        else:
            np.testing.assert_array_equal(got_t.view(np.int32),
                                          want_t.view(np.int32))
            np.testing.assert_array_equal(got_id, want_id)


def test_lab2_matches_script(monkeypatch):
    """L2 (k4, 8 tiles a grid step, planes) at 0, 1 and 8 steps."""
    mod = _script("kernel_lab", monkeypatch)
    cols, tris9, meta = _l1_inputs()
    planes = np.ascontiguousarray(_rows(cols).transpose(0, 2, 1))
    for steps in (0, 1, 8):
        want = _k4_pallas(mod, steps, meta, cols, tris9)
        got = kernel_lab.lab2(_t(_counts(N_TILES, steps)), _t(meta),
                              _t(planes), _t(tris9)).numpy()
        assert got.shape == want.shape == (N_TILES, 2, 128)
        _tile_hold(got[:, 0], _ids(got[:, 1]), want[:, 0], _ids(want[:, 1]),
                   cols, tris9)


@pytest.mark.parametrize("g,n_tiles,steps", [(8, 16, (0, 1, 8)),
                                             (16, 32, (0, 8))])
def test_lab3_matches_script(monkeypatch, g, n_tiles, steps):
    """L3 (make_k5(G), rows) at 0, 1 and 8 steps (G 16: 0 and 8)."""
    mod = _script("kernel_lab", monkeypatch)
    cols, tris9, meta = _l1_inputs(n_tiles)
    for steps in steps:
        want = _k5_pallas(mod, g, steps, meta, cols, tris9)
        got = kernel_lab.lab3(_t(_counts(n_tiles, steps)), _t(meta),
                              _t(_rows(cols)), _t(tris9), g).numpy()
        assert got.shape == want.shape == (n_tiles, 128, 2)
        _tile_hold(got[..., 0], _ids(got[..., 1]), want[..., 0],
                   _ids(want[..., 1]), cols, tris9)


def _plain_l1(meta, cols, tris9, exit_mode=None, stats=None, steps=8):
    """k3, or with exit_mode (k4 / k5) the walk with its exit, on the
    plain version: (n_tiles, 128) t and ids as numpy."""
    counts = _t(_counts(cols.shape[1] // 128, steps))
    if exit_mode is None:
        t, i = kernel_lab.lab1_reference(counts, _t(meta), _t(cols),
                                         _t(tris9), "k3")
        return t.numpy().reshape(-1, 128), i.numpy().reshape(-1, 128)
    if exit_mode == "k4":
        out = kernel_lab.lab2_reference(
            counts, _t(meta), _t(np.ascontiguousarray(
                _rows(cols).transpose(0, 2, 1))), _t(tris9), stats).numpy()
        return out[:, 0], _ids(out[:, 1])
    out = kernel_lab.lab3_reference(counts, _t(meta), _t(_rows(cols)),
                                    _t(tris9), stats).numpy()
    return out[..., 0], _ids(out[..., 1])


def test_exit_never_fires_on_the_scripts_meta():
    """The quirk (kernel_lab.py:376-378, :538-540 compare t bits with
    cluster ids below 636): on the script's meta k4 and k5 walk every step
    and equal k3 bit for bit; with the tnear third at 0x7f000000 they stop
    after the first step, with fewer hits than k3."""
    cols, tris9, meta = _l1_inputs()
    t3, i3 = _plain_l1(meta, cols, tris9)
    for exit_mode in ("k4", "k5"):
        stats = {}
        t, i = _plain_l1(meta, cols, tris9, exit_mode, stats)
        assert stats["steps"] == 8 * N_TILES
        np.testing.assert_array_equal(t.view(np.int32), t3.view(np.int32))
        np.testing.assert_array_equal(i, i3)
        crafted = _crafted(meta)
        t3c, i3c = _plain_l1(crafted, cols, tris9)
        np.testing.assert_array_equal(i3c, i3)   # k3 never reads tnear
        t, i = _plain_l1(crafted, cols, tris9, exit_mode, stats)
        assert stats["steps"] == N_TILES
        assert (i >= 0).sum() < (i3 >= 0).sum()
        t1, i1 = _plain_l1(meta, cols, tris9, steps=1)
        np.testing.assert_array_equal(i, i1)


@pytest.mark.parametrize("exit_mode", ["k4", "k5"])
def test_exit_fires_in_the_script_alike(monkeypatch, exit_mode):
    """On the crafted meta the script's k4 / k5 stop after one step as the
    plain version does, and hit less than k3 (the quirk's other side)."""
    mod = _script("kernel_lab", monkeypatch)
    cols, tris9, meta = _l1_inputs()
    crafted = _crafted(meta)
    if exit_mode == "k4":
        want = _k4_pallas(mod, 8, crafted, cols, tris9)
        want_t, want_id = want[:, 0], _ids(want[:, 1])
    else:
        want = _k5_pallas(mod, 8, 8, crafted, cols, tris9)
        want_t, want_id = want[..., 0], _ids(want[..., 1])
    got_t, got_id = _plain_l1(crafted, cols, tris9, exit_mode)
    _tile_hold(got_t, got_id, want_t, want_id, cols, tris9)
    _, i3 = _plain_l1(meta, cols, tris9)
    assert (want_id >= 0).sum() < (i3 >= 0).sum()


# ---------------------------------------------------------------------------
# L3's walk on the card (csrc/tile_lab.cu tile_walk_kernel): a block a tile, R
# = 4 rays a lane (a warp holds the tile), W warps over each step's quads,
# their bests combined by (t, slot) after every step and the exit voted on
# the combined best; the FMA body, held tie-aware
# ---------------------------------------------------------------------------

def _dup_lab3(seed=31, n_tiles=8, crafted=False):
    """tests/test_torch_lab.py's duplicate scene as L3 takes it: meta
    (n_tiles x 3,072,) naming cluster 0 at slot 0 and at the next step's
    first slot (8), cluster 1 (cluster 0's copy) at slot 1 and random
    clusters elsewhere, its tnear third random cluster ids (the script's:
    the exit never fires) or, crafted, 0x7f000000; rays (n_tiles, 128, 8)
    with NaN rays and rays with t_max < t_min; tris9 (C, 9, 1, 128)."""
    from test_torch_lab import _dup_scene
    (v0, e1, e2), _, (o3, d3, mm2) = _dup_scene(seed, n_tiles=4 * n_tiles)
    C = v0.shape[0] // 128
    tris9 = np.swapaxes(np.concatenate([v0, e1, e2], -1).reshape(C, 128, 9),
                        1, 2)[:, :, None, :]
    meta = np.random.default_rng(seed).integers(
        0, C, (n_tiles, common.ROW_L1)).astype(np.int32)
    meta[:, 0], meta[:, 1], meta[:, 8] = 0, 1, 0
    if crafted:
        meta[:, common.CPAD:2 * common.CPAD] = 0x7F000000
    rays = np.concatenate([o3, d3, mm2], -1).reshape(n_tiles, 128, 8)
    return tuple(map(_t, (meta.reshape(-1), rays, tris9)))


def workers_lab3(counts, meta, rays, tris9, W, R=4, exit=True, test=None):
    """A plain torch model of tile_walk_kernel's work split: lane l of a
    warp holds rays l + 32 k, k < R (R = 4: the tile); warp w takes the
    quads q = w (mod W) of each step's 256 and keeps the first smallest
    hit (strict <) below the best its candidates start from. With exit
    (k4, k5) that is the tile's best from before the step: after the step
    the warps' bests meet by smallest t, then smallest slot, and the tile
    stops once every ray's combined best t bits are <= the tnear entry
    meta[1,024 + min(8 (s + 1), 1,023)]. Without it (k3) each warp keeps
    its own running best over the whole walk and the warps' bests meet
    once, after it. test is the body, (a, t, u, v) as
    trace_kernel._mt_test gives them (the unfused body, the default) or
    common.mt_test_fma (the card's). Returns what lab3 returns."""
    from test_torch_lab import _first_min
    test = test or kernel_lab._mt_test
    ray_of = torch.arange(32)[:, None] + 32 * torch.arange(R)
    assert sorted(ray_of.reshape(-1).tolist()) == list(range(32 * R))
    n_tiles, C = rays.shape[0], tris9.shape[0]
    rows = tris9.reshape(C, 9, 128)
    m2 = meta.reshape(n_tiles, common.ROW_L1)
    bk = common.KB_L1 * 128
    worker = torch.arange(bk) // 4 % W
    start = torch.where(rays[..., 7] > common.BIG, common.BIG, rays[..., 7])
    bt = start.clone()
    bs = torch.full((n_tiles, 128), -1, dtype=torch.int64)
    wt = start[..., None].repeat(1, 1, W)        # k3: each warp's best
    ws = torch.full((n_tiles, 128, W), -1, dtype=torch.int64)
    steps = (counts.long() + 7) // 8
    walking = steps > 0
    inf = torch.tensor(float("inf"))
    s = 0
    while True:
        act = torch.nonzero(walking & (steps > s)).squeeze(1)
        if act.numel() == 0:
            break
        k = (s * 8 + torch.arange(8)).clamp(max=common.CPAD - 1)
        orders = m2[act][:, k].clamp(0, C - 1).long()
        tri = rows[orders].permute(0, 2, 1, 3).reshape(-1, 9, 1, bk)
        ray = rays[act]
        a, tt, uu, vv = test([tri[:, i] for i in range(9)],
                             *(ray[..., q, None] for q in range(6)))
        slot_ok = (s * 8 + torch.arange(bk) // 128)[None] < \
            counts.long()[act, None]
        base = (a != 0) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & \
            (tt >= ray[..., 6, None]) & slot_ok[:, None, :]
        if not exit:
            for w in range(W):
                b = wt[act, :, w]
                hit = base & (worker == w) & (tt < b[..., None])
                t_w, arg = torch.where(hit, tt, inf).min(dim=2)
                closer = t_w < b
                wt[act, :, w] = torch.where(closer, t_w, b)
                ws[act, :, w] = torch.where(closer, s * bk + arg,
                                            ws[act, :, w])
            s += 1
            continue
        b = bt[act]
        hit = base & (tt < b[..., None])
        per_w = [torch.where(hit & (worker == w), tt, inf).min(dim=2)
                 for w in range(W)]
        t_c, s_c = _first_min(
            torch.stack([x[0] for x in per_w], -1),
            torch.stack([torch.where(x[0] < inf, s * bk + x[1], 1 << 30)
                         for x in per_w], -1))
        closer = t_c < b
        bt[act] = torch.where(closer, t_c, b)
        bs[act] = torch.where(closer, s_c, bs[act])
        nk = m2[act, common.CPAD + min((s + 1) * 8, common.CPAD - 1)]
        walking[act] = ~(bt[act].view(torch.int32) <= nk[:, None]).all(1)
        s += 1
    if not exit:    # the one combine, after the walk
        t_c, s_c = _first_min(torch.where(ws >= 0, wt, inf),
                              torch.where(ws >= 0, ws, 1 << 30))
        got = t_c < start
        bt = torch.where(got, t_c, start)
        bs = torch.where(got, s_c, -1)
    got = bs >= 0
    g = torch.where(got, bs, 0) // 128
    cl = torch.gather(m2.long(), 1, g.clamp(max=common.CPAD - 1)).clamp(
        0, C - 1)
    ids = torch.where(got, cl * 128 + bs % 128, -1).int()
    return torch.stack([bt, ids.view(torch.float32)], -1)


@pytest.mark.parametrize("W", [1, 2, 8])
def test_lab3_worker_split_matches_reference(W):
    """The model of the card's W-worker split, its (t, slot) combine after
    each step and its exit on the combined best equals lab3_reference bit
    for bit: exact duplicate triangles within a quad, across workers,
    within a step and across steps, tiles of count 0 and uneven counts, NaN
    rays and rays with t_max < t_min, on the script's kind of meta and on
    the crafted one whose tnear third is 0x7f000000; and on the script's
    own first tiles."""
    counts = torch.tensor([0, 3, 8, 9, 17, 24, 40, 64], dtype=torch.int32)
    cases = [_dup_lab3(), _dup_lab3(crafted=True)]
    cols, tris9, meta = _l1_inputs()
    cases.append((_t(meta), _t(_rows(cols)), _t(tris9)))
    for meta, rays, tris9 in cases:
        c = counts.repeat(rays.shape[0] // 8)
        want = kernel_lab.lab3_reference(c, meta, rays, tris9)
        got = workers_lab3(c, meta, rays, tris9, W)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ids = kernel_lab.lab3_reference(c[:8], *_dup_lab3())[..., 1].view(
        torch.int32)
    # the duplicates win: cluster 0's quads 0 and 1
    assert int(((ids >= 0) & (ids < 256) & (ids % 128 < 8)).sum()) >= 20


def _lab3_fma(monkeypatch, *args):
    """lab3_reference with the card's FMA body (common.mt_test_fma)."""
    monkeypatch.setattr(kernel_lab, "_mt_test", common.mt_test_fma)
    try:
        return kernel_lab.lab3_reference(*args)
    finally:
        monkeypatch.undo()


def test_lab3_agreement_holds_the_fma_body(monkeypatch):
    """The FMA body's results (emulated in FP64) meet lab3_agreement
    against the plain version on the script's first 16 tiles and on the
    duplicate scene, with t off by at most 1/2 of its bound; on the
    crafted meta with the steps each tile walked (walked_steps) held too,
    one a tile that hits in its first step."""
    cols, tris9, meta = _l1_inputs()
    cases = [(_t(meta), _t(_rows(cols)), _t(tris9), None),
             _dup_lab3() + (None,),
             (_t(_crafted(meta)), _t(_rows(cols)), _t(tris9), 1)]
    for meta, rays, tris9, walked in cases:
        counts = torch.full((rays.shape[0],), 64, dtype=torch.int32)
        ref = kernel_lab.lab3_reference(counts, meta, rays, tris9)
        fma = _lab3_fma(monkeypatch, counts, meta, rays, tris9)
        steps = None
        if walked is not None:
            steps = [kernel_lab.walked_steps(
                lambda c: fn(c, meta, rays, tris9), counts) for fn in (
                    lambda *a: _lab3_fma(monkeypatch, *a),
                    kernel_lab.lab3_reference)]
            assert bool((steps[1] <= walked).all())
            assert int((steps[1] == walked).sum()) > rays.shape[0] // 2
        agree = kernel_lab.lab3_agreement(fma, ref, meta, rays, tris9, steps)
        assert agree["rays_off"] == 0 and agree["ill_conditioned"] <= 1 \
            and agree["max_t_over_bound"] <= 0.5, agree
        assert agree.get("steps_off", 0) == 0, agree
        assert int((ref[..., 1].view(torch.int32) >= 0).sum()) > 100


def test_lab3_agreement_rules():
    """lab3_agreement accepts a t one ulp off and a tie swap (a winner's
    copy in cluster 1), and refuses a wrong id, a t off by more than its
    bound and, on the crafted meta, a tile that walked one step more where
    rounding did not decide it (no tie and no t near the exit's bound),
    but not where a tie did."""
    counts = torch.full((8,), 16, dtype=torch.int32)
    meta, rays, tris9 = _dup_lab3()
    ref = kernel_lab.lab3_reference(counts, meta, rays, tris9)

    def hold(out, want=ref, meta=meta, steps=None):
        return kernel_lab.lab3_agreement(out, want, meta, rays, tris9, steps)
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
    r8 = rays.reshape(-1, 8)
    f = common.mt_fp64(tris9[c, :, 0, lane][None], r8[[hit], 0:3],
                       r8[[hit], 3:6], r8[[hit], 6])
    a = hold(moved(hit, t=float(flat[hit, 0] + 4 * f["b_t"][0])))
    assert not a["ok"] and a["rays_off"] == 1 and a["max_t_over_bound"] > 1
    # the exit: every tile stops after its first step
    cmeta, _, _ = _dup_lab3(crafted=True)
    cref = kernel_lab.lab3_reference(counts, cmeta, rays, tris9)
    walked = kernel_lab.walked_steps(lambda n: kernel_lab.lab3_reference(
        n, cmeta, rays, tris9), counts)
    assert walked.tolist() == [1] * 8
    more = walked.clone()
    more[2] += 1
    a = hold(cref, cref, cmeta, (more, walked))
    assert not a["ok"] and a["steps_differ"] == 1 and a["steps_off"] == 1
    cflat = cref.reshape(-1, 2)
    cids = cflat[:, 1].view(torch.int32)
    tie = int(torch.nonzero((cids >= 0) & (cids < 128)).reshape(-1)[0])
    more = walked.clone()
    more[tie // 128] += 1
    a = hold(moved(tie, id_=int(cids[tie]) + 128, x=cflat), cref, cmeta,
             (more, walked))
    assert a["ok"] and a["steps_differ"] == 1 and a["steps_off"] == 0


# ---------------------------------------------------------------------------
# L1 and L2 on L3's template (csrc/tile_lab.cu tile_walk_kernel): one block
# a tile in every mode, R = 4 rays a lane, the FMA body; k3 with no exit
# combines its warps' bests once, after the walk; the layout decides only
# where a ray is read and its t and id written
# ---------------------------------------------------------------------------

def _cols(rows):
    return rows.reshape(-1, 8).t().contiguous()


def _data(meta, rows, tris9):
    """What tile_inputs returns, from rows (n_tiles, 128, 8)."""
    return dict(meta=meta, rows=rows, tris9=tris9, cols=_cols(rows),
                planes=rows.transpose(1, 2).contiguous(),
                n_tiles=rows.shape[0])


def _cfg(name):
    return kernel_lab.TileConfig(name, {"k3": 1, "k4": 8, "k5": 8}[name], 0,
                                 "")


def _fma_call(monkeypatch, name, data, counts):
    """name's plain version with the card's FMA body (common.mt_test_fma),
    as name's wrapper returns it."""
    monkeypatch.setattr(kernel_lab, "_mt_test", common.mt_test_fma)
    try:
        return kernel_lab.call_reference(_cfg(name), data, counts)
    finally:
        monkeypatch.undo()


def _script_tiles():
    cols, tris9, meta = _l1_inputs()
    return _t(meta), _t(_rows(cols)), _t(tris9)


@pytest.mark.parametrize("W", [1, 2, 8])
def test_k3_worker_split_matches_reference(W):
    """The model of k3's split, each of W warps keeping its own best over
    the whole walk and one (t, slot) combine after it, equals
    lab1_reference(..., "k3") bit for bit: exact duplicate triangles
    within a quad, across warps, within a step and across steps, tiles of
    count 0 and uneven counts, NaN rays and rays with t_max < t_min, on the
    script's kind of meta and on the crafted one (k3 reads no tnear), and
    on the script's own first tiles."""
    counts = torch.tensor([0, 3, 8, 9, 17, 24, 40, 64], dtype=torch.int32)
    for meta, rays, tris9 in (_dup_lab3(), _dup_lab3(crafted=True),
                              _script_tiles()):
        c = counts.repeat(rays.shape[0] // 8)
        t, i = kernel_lab.lab1_reference(c, meta, _cols(rays), tris9, "k3")
        got = workers_lab3(c, meta, rays, tris9, W, exit=False)
        assert torch.equal(got[..., 0].reshape(-1, 1).view(torch.int32),
                           t.view(torch.int32))
        assert torch.equal(got[..., 1].reshape(-1, 1).view(torch.int32), i)
        assert int((i >= 0).sum()) > 100


def _ray_index(layout, n_tiles, tile, lane, k, f):
    """Where tile_walk_kernel reads field f of the ray lane + 32 k of tile
    (load_ray): columns (8, n_rays), planes (n_tiles, 8, 128), rows
    (n_tiles, 128, 8), as flat indices."""
    r = lane + 32 * k
    ray = tile * 128 + r
    if layout == "columns":
        return f * n_tiles * 128 + ray
    if layout == "planes":
        return (tile * 8 + f) * 128 + r
    return ray * 8 + f


def _out_index(layout, n_tiles, tile, lane, k, c):
    """Where it writes that ray's t (c = 0) and id bits (c = 1)
    (store_out): columns (2, n_rays), planes (n_tiles, 2, 128), rows
    (n_tiles, 128, 2)."""
    r = lane + 32 * k
    ray = tile * 128 + r
    if layout == "columns":
        return c * n_tiles * 128 + ray
    if layout == "planes":
        return (tile * 2 + c) * 128 + r
    return ray * 2 + c


@pytest.mark.parametrize("layout,name", [("columns", "k3"),
                                         ("planes", "k4"), ("rows", "k5")])
def test_tile_walk_addressing(layout, name):
    """The kernel's addressing at R = 4 reads each field of each ray of
    tile_inputs' array of the layout exactly once, at the ray lane + 32 k,
    a warp's 32 lanes on 128 contiguous bytes of a field in columns and
    planes; its writes fill the layout's output exactly once, in the order
    flat reads back (ray order)."""
    inp = kernel_lab.tile_inputs(torch.device("cpu"), tiles=4)
    n = inp["n_tiles"]
    arr = inp[{"columns": "cols", "planes": "planes", "rows": "rows"}[
        layout]].reshape(-1).numpy()
    tile, lane, k, f = np.ix_(range(n), range(32), range(4), range(8))
    idx = _ray_index(layout, n, tile, lane, k, f)
    assert sorted(idx.reshape(-1).tolist()) == list(range(arr.size))
    rows = inp["rows"].numpy()
    want = rows[tile, lane + 32 * k, f]
    np.testing.assert_array_equal(arr[idx].view(np.int32),
                                  want.view(np.int32))
    if layout != "rows":
        assert (np.diff(idx, axis=1) == 1).all()
    tile, lane, k, c = np.ix_(range(n), range(32), range(4), range(2))
    at = _out_index(layout, n, tile, lane, k, c)
    size = n * 128 * 2
    assert sorted(at.reshape(-1).tolist()) == list(range(size))
    ray = (tile * 128 + lane + 32 * k) * np.ones_like(c)
    out = np.empty(size, np.float32)
    out[at] = np.where(c == 0, ray.astype(np.float32),
                       (ray + 1000).astype(np.int32).view(np.float32))
    shape = {"columns": (2, n * 128), "planes": (n, 2, 128),
             "rows": (n, 128, 2)}[layout]
    out = torch.from_numpy(out).view(shape)
    if layout == "columns":     # as lab1 returns it
        out = (out[0].view(-1, 1), out[1].view(torch.int32).view(-1, 1))
    t, i = kernel_lab.flat(name, out)
    assert torch.equal(t, torch.arange(n * 128, dtype=torch.float32))
    assert torch.equal(i, torch.arange(n * 128, dtype=torch.int32) + 1000)


@pytest.mark.parametrize("name", ["k3", "k4", "k5"])
def test_tile_agreement_holds_the_fma_body(monkeypatch, name):
    """k3 (columns, (R, 1) outputs), k4 (planes) and k5 (rows) with the
    card's FMA body (emulated in FP64) meet lab3_agreement against their
    plain versions on the script's first 16 tiles and on the duplicate
    scene, t within 1/2 of its bound; k4 and k5 also on the crafted meta,
    with the steps each tile walked (walked_steps) held, one a tile that
    hits in its first step."""
    cases = [_script_tiles() + (None,), _dup_lab3() + (None,)]
    if name != "k3":
        meta, rows, tris9 = _script_tiles()
        cases.append((_t(_crafted(meta.numpy())), rows, tris9, 1))
    for meta, rays, tris9, walked in cases:
        data = _data(meta, rays, tris9)
        counts = torch.full((rays.shape[0],), 64, dtype=torch.int32)
        ref = kernel_lab.call_reference(_cfg(name), data, counts)
        fma = _fma_call(monkeypatch, name, data, counts)
        steps = None
        if walked is not None:
            steps = [kernel_lab.walked_steps(fn, counts) for fn in (
                lambda c: _fma_call(monkeypatch, name, data, c),
                lambda c: kernel_lab.call_reference(_cfg(name), data, c))]
            assert bool((steps[1] <= walked).all())
            assert int((steps[1] == walked).sum()) > rays.shape[0] // 2
        agree = kernel_lab.lab3_agreement(fma, ref, meta, rays, tris9, steps,
                                          name)
        assert agree["rays_off"] == 0 and agree["ill_conditioned"] <= 1 \
            and agree["max_t_over_bound"] <= 0.5, agree
        assert agree.get("steps_off", 0) == 0, agree
        assert int((kernel_lab.flat(name, ref)[1] >= 0).sum()) > 100


def test_k3_k4_k5_equal_under_the_fma_body(monkeypatch):
    """Under the FMA body k3, k4 and k5 equal one another bit for bit
    where the exit never fires (the script's meta, the duplicate scene's):
    the body's t and its odd flag depend on the ray and the triangle only,
    not on the best a candidate is compared with, so a per-step combine
    (k4, k5) and one final combine (k3) pick the same (t, slot). The
    models of the two splits with the FMA body give the same bits."""
    counts = torch.tensor([0, 3, 8, 9, 17, 24, 40, 64], dtype=torch.int32)
    for meta, rays, tris9 in (_script_tiles(), _dup_lab3()):
        data = _data(meta, rays, tris9)
        for c in (torch.full((rays.shape[0],), 64, dtype=torch.int32),
                  counts.repeat(rays.shape[0] // 8)):
            outs = [kernel_lab.flat(n, _fma_call(monkeypatch, n, data, c))
                    for n in ("k3", "k4", "k5")]
            for t, i in outs[1:]:
                assert torch.equal(t.view(torch.int32),
                                   outs[0][0].view(torch.int32))
                assert torch.equal(i, outs[0][1])
            for exit in (False, True):
                got = workers_lab3(c, meta, rays, tris9, 8, exit=exit,
                                   test=common.mt_test_fma)
                assert torch.equal(got[..., 0].reshape(-1).view(torch.int32),
                                   outs[0][0].view(torch.int32))
                assert torch.equal(got[..., 1].reshape(-1).view(torch.int32),
                                   outs[0][1])


def _as(name, t, i, n_tiles):
    """Flat t (R,) f32 and ids (R,) i32 as name's wrapper returns them."""
    if name == "k3":
        return t.view(-1, 1), i.view(-1, 1)
    idf = i.view(torch.float32)
    if name == "k4":
        return torch.stack([t.view(n_tiles, 128), idf.view(n_tiles, 128)], 1)
    return torch.stack([t.view(n_tiles, 128), idf.view(n_tiles, 128)], -1)


@pytest.mark.parametrize("name", ["k3", "k4"])
def test_tile_agreement_rules(name):
    """lab3_agreement holds L1's k3 and L2's k4 by L3's rules: it accepts
    a t one ulp off and a tie swap (a winner's copy in cluster 1), and
    refuses a wrong id and a t off by more than its bound; for k4, on the
    crafted meta, a tile that walked one step more where rounding did not
    decide it fails, but not where a tie did."""
    counts = torch.full((8,), 16, dtype=torch.int32)
    meta, rays, tris9 = _dup_lab3()
    data = _data(meta, rays, tris9)
    ref = kernel_lab.call_reference(_cfg(name), data, counts)

    def hold(out, want=ref, meta=meta, steps=None):
        return kernel_lab.lab3_agreement(out, want, meta, rays, tris9, steps,
                                         name)
    assert hold(ref)["ok"]
    t0, i0 = kernel_lab.flat(name, ref)
    dup = int(torch.nonzero((i0 >= 0) & (i0 < 128)).reshape(-1)[0])
    hit = int(torch.nonzero((i0 >= 0) & (t0 > 0.5)).reshape(-1)[0])

    def moved(ray, t=None, id_=None, base=(t0, i0)):
        tm, im = base[0].clone(), base[1].clone()
        if t is not None:
            tm[ray] = t
        if id_ is not None:
            im[ray] = id_
        return _as(name, tm, im, 8)
    a = hold(moved(hit, t=float(np.nextafter(np.float32(t0[hit]),
                                             np.float32(np.inf)))))
    assert a["ok"] and a["t_bits_differ"] == 1
    a = hold(moved(dup, id_=int(i0[dup]) + 128))
    assert a["ok"] and a["ties"] == 1 and a["ill_conditioned"] == 0
    a = hold(moved(hit, id_=(int(i0[hit]) + 37) % (128 * 24)))
    assert not a["ok"] and a["rays_off"] == 1
    c, lane = int(i0[hit]) // 128, int(i0[hit]) % 128
    r8 = rays.reshape(-1, 8)
    f = common.mt_fp64(tris9[c, :, 0, lane][None], r8[[hit], 0:3],
                       r8[[hit], 3:6], r8[[hit], 6])
    a = hold(moved(hit, t=float(t0[hit] + 4 * f["b_t"][0])))
    assert not a["ok"] and a["rays_off"] == 1 and a["max_t_over_bound"] > 1
    if name == "k3":
        return
    # k4's exit: every tile stops after its first step
    cmeta, _, _ = _dup_lab3(crafted=True)
    cdata = dict(data, meta=cmeta)
    cref = kernel_lab.call_reference(_cfg(name), cdata, counts)
    walked = kernel_lab.walked_steps(lambda n: kernel_lab.call_reference(
        _cfg(name), cdata, n), counts)
    assert walked.tolist() == [1] * 8
    more = walked.clone()
    more[2] += 1
    a = hold(cref, cref, cmeta, (more, walked))
    assert not a["ok"] and a["steps_differ"] == 1 and a["steps_off"] == 1
    ct, ci = kernel_lab.flat(name, cref)
    tie = int(torch.nonzero((ci >= 0) & (ci < 128)).reshape(-1)[0])
    more = walked.clone()
    more[tie // 128] += 1
    a = hold(moved(tie, id_=int(ci[tie]) + 128, base=(ct, ci)), cref, cmeta,
             (more, walked))
    assert a["ok"] and a["steps_differ"] == 1 and a["steps_off"] == 0


# ---------------------------------------------------------------------------
# L12 against the script
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _l12_inputs(n_tiles=N_TILES_L12):
    inp = common.lab12_inputs()
    return {k: v if k.startswith("tris") else v[:n_tiles]
            for k, v in inp.items()}


@pytest.mark.parametrize("mode", ["mt", "plucker"])
def test_lab12_matches_script(monkeypatch, mode):
    """mt by the tie-aware rule of L1-L3; plucker by its own (ids exact but
    near a zero side or den, or at a tie; t within 1e-6 relative). Every
    ray hits under plucker on the script's inputs."""
    mod = _script("mxu_lab", monkeypatch, drop_calls=True)
    inp = _l12_inputs()
    for k in ("tris9", "tris24"):
        np.testing.assert_array_equal(inp[k], np.asarray(getattr(mod, k)))
    want = _l12_pallas(mod, mode, inp)
    tris = inp["tris9" if mode == "mt" else "tris24"]
    got = mxu_lab.lab12(*(_t(inp[k]) for k in ("order", "o3", "d3", "mm2")),
                        _t(tris), mode).numpy()
    assert got.shape == want.shape == (N_TILES_L12, 32, 2)

    def tri_of(idx, slot):
        return mxu_lab.triangle_rows(
            _t(inp["order"]), _t(tris), torch.tensor([idx[0]]),
            torch.tensor([slot])).numpy()[0]

    def ray_of(idx):
        return (inp["o3"][idx].astype(np.float64),
                inp["d3"][idx].astype(np.float64), 0.0)
    _hold(got[..., 0], _ids(got[..., 1]), want[..., 0], _ids(want[..., 1]),
          tri_of, ray_of, plucker=mode == "plucker")
    hits = int((_ids(got[..., 1]) >= 0).sum())
    assert hits == N_TILES_L12 * 32 if mode == "plucker" else \
        hits >= N_TILES_L12 * 32 // 2


def test_plucker_agreement_flags_a_wrong_id():
    """The card's tie-aware hold passes the plain version against itself
    and refuses a ray whose id names a triangle whose t is far from the
    best, or whose t moved by more than TOL."""
    inp = {k: _t(v) for k, v in _l12_inputs(32).items()}
    ref = mxu_lab.lab12_reference(inp["order"], inp["o3"], inp["d3"],
                                  inp["mm2"], inp["tris24"], "plucker")
    agree = mxu_lab.plucker_agreement(ref, ref, inp)
    assert agree["ok"] and agree["ids_differ"] == 0
    ids = ref[..., 1].contiguous().view(torch.int32)
    alt = mxu_lab.plucker_plain_of(inp, torch.zeros(1024, dtype=torch.long),
                                   torch.zeros(1024, dtype=torch.long),
                                   torch.arange(1024, dtype=torch.int32))[1]
    far = int(torch.nonzero((alt - ref[0, 0, 0]).abs() > 1e-3)[0])
    assert far != int(ids[0, 0])
    moved = ref.clone()
    moved[0, 0, 1] = torch.tensor([far], dtype=torch.int32).view(
        torch.float32)[0]
    moved[1, 3, 0] += 10 * kernel_lab11.TOL
    agree = mxu_lab.plucker_agreement(moved, ref, inp)
    assert not agree["ok"] and agree["rays_off"] == 2
    assert agree["ids_differ"] == 1 and agree["ties"] == 0


def _runner_up(inp, ids, tile, lane):
    """The slot and plain t of the first closest plain hit of a ray but
    its winner's: what a kernel that rejected the winner would choose."""
    slots = torch.arange(common.STEPS_L12 * mxu_lab.BK, dtype=torch.int32)
    pos = torch.full(slots.shape, tile), torch.full(slots.shape, lane)
    hit, t = mxu_lab.plucker_plain_of(inp, *pos, slots)
    hit[int(ids[tile, lane])] = False
    t = torch.where(hit, t, mxu_lab.BIG)
    return int(t.argmin()), t.min()


def test_plucker_agreement_holds_a_rounding_turn():
    """A kernel that rejects a winner whose test FP64 puts within rounding
    of turning (t within its bound of t_min = 0), and takes the runner-up
    at its t, is held by the FP64 rule; with that t moved by more than its
    bound it is not, and neither is the runner-up of a winner whose test
    rounding cannot turn. 320 tiles, so that ILL_SHARE allows one ray."""
    inp = {k: _t(v) for k, v in _l12_inputs(320).items()}
    ref = mxu_lab.lab12_reference(inp["order"], inp["o3"], inp["d3"],
                                  inp["mm2"], inp["tris24"], "plucker")
    ids = ref[..., 1].contiguous().view(torch.int32)
    tiles, lanes = (x.reshape(-1) for x in torch.meshgrid(
        torch.arange(320), torch.arange(32), indexing="ij"))
    margin = mxu_lab.plucker_t64(inp, tiles, lanes, ids.reshape(-1))["margin"]
    found = {}
    for ray in range(320 * 32):
        tile, lane = divmod(ray, 32)
        turns = bool(margin[ray] <= 1)
        if turns in found:
            continue
        slot, t = _runner_up(inp, ids, tile, lane)
        if (t - ref[tile, lane, 0]).abs() > 2 * kernel_lab11.TOL:
            found[turns] = tile, lane, slot, t
        if len(found) == 2:
            break
    tile, lane, slot, t = found[True]

    def kernel_out(tile, lane, slot, t):
        out = ref.clone()
        out[tile, lane, 0] = t
        out[tile, lane, 1] = torch.tensor([slot], dtype=torch.int32).view(
            torch.float32)[0]
        return out
    agree = mxu_lab.plucker_agreement(kernel_out(tile, lane, slot, t), ref,
                                      inp)
    assert agree["ok"] and agree["rays_off"] == 0, agree
    assert agree["ids_differ"] == 1 and agree["ill_conditioned"] == 1
    (held,) = agree["held"]
    assert held["rule"] == "turn" and held["margin"] <= 1
    assert held["t_err"] <= held["b_t"]
    agree = mxu_lab.plucker_agreement(
        kernel_out(tile, lane, slot, t + 4 * held["b_t"]), ref, inp)
    assert not agree["ok"] and agree["rays_off"] == 1 and not agree["held"]
    agree = mxu_lab.plucker_agreement(kernel_out(*found[False]), ref, inp)
    assert not agree["ok"] and agree["rays_off"] == 1 and not agree["held"]


def _l12_crafted(n_tiles=8):
    """The script's first tiles with what the walk must get right: every
    cluster's quad 1 a copy of its quad 0 (ties across workers 0 and 1), a
    step naming one cluster twice (ties across steps' slots within a
    worker), order entries below 0 and at or past C (clamped), a NaN t_max
    and a t_max below t_min."""
    inp = {k: np.array(v) for k, v in _l12_inputs(n_tiles).items()}
    inp["tris9"][..., 4:8] = inp["tris9"][..., 0:4]
    order = inp["order"]
    order[:, 1] = order[:, 0]
    order[0, 3], order[1, 10], order[2, 47] = -5, common.CC, common.CC + 7
    order[3, 60] = -1                      # past the walk's 48: unread
    inp["mm2"][0, 0, 1] = np.nan
    inp["mm2"][0, 1] = (2.0, 1.0)
    return {k: _t(v) for k, v in inp.items()}


def _l12_workers(inp, W=4):
    """A plain torch model of L12 mt's split on the card (the brick walk,
    csrc/brick_walk.cuh brick_walk_kernel<12, ...>, unfused body): a warp a
    tile, 4 rays a lane and W = 4 workers of 8 lanes; worker w takes the
    quads q = w (mod W) of each step's 8 clusters (the order entries
    clamped to [0, C)) and keeps the first smallest hit (strict <) of all
    its slots, step * 1,024 + the triangle's lane in the step, from
    min(t_max, 3e38) (a NaN kept) and id -1; the workers meet by smallest
    t, then smallest slot, after the walk. Returns lab12's block and the
    per-worker bests."""
    order, o3, d3, mm2, tris = (inp[k] for k in ("order", "o3", "d3", "mm2",
                                                 "tris9"))
    n_tiles, C = order.shape[0], tris.shape[0]
    rows = tris.reshape(C, 9, common.CLUSTER)
    bk = mxu_lab.BK
    worker = torch.arange(bk) // 4 % W
    inf = torch.tensor(float("inf"))
    start = torch.where(mm2[..., 1] > common.BIG, common.BIG, mm2[..., 1])
    ct = start[..., None].repeat(1, 1, W)
    cs = torch.full((n_tiles, 32, W), -1)
    o = [o3[..., k, None] for k in range(3)]
    d = [d3[..., k, None] for k in range(3)]
    tmin = mm2[..., 0, None]
    for s in range(common.STEPS_L12):
        orders = order[:, s * common.KBV:(s + 1) * common.KBV].clamp(
            0, C - 1).long()
        tri = rows[orders].permute(0, 2, 1, 3).reshape(n_tiles, 9, 1, bk)
        a, tt, uu, vv = mxu_lab._mt_test([tri[:, i] for i in range(9)], *o,
                                         *d)
        hit = (a != 0) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & \
            (tt >= tmin)
        for w in range(W):
            t_w, arg = torch.where(hit & (worker == w), tt, inf).min(dim=2)
            closer = t_w < ct[..., w]
            ct[..., w] = torch.where(closer, t_w, ct[..., w])
            cs[..., w] = torch.where(closer, s * bk + arg, cs[..., w])
    bt, bs = ct[..., 0].clone(), cs[..., 0].clone()
    for w in range(1, W):       # the (t, slot) meeting, in any order
        ut, us = ct[..., w], cs[..., w]
        better = (ut < bt) | ((ut == bt) & (us < bs))
        bt, bs = torch.where(better, ut, bt), torch.where(better, us, bs)
    return torch.stack([bt, bs.int().view(torch.float32)], -1), (ct, cs)


def test_lab12_mt_worker_split_matches_reference():
    """The model of the card's L12 mt split (4 workers of 8 lanes, running
    bests from min(t_max, 3e38), the (t, slot) meeting after the walk)
    equals lab12_reference bit for bit at the script's KB 8 and 6 steps,
    on ties across workers and across a step's slots, clamped orders, a NaN
    t_max and t_max < t_min; the winners' slots span the walk's 6,144, and
    every worker's best holds hits."""
    inp = _l12_crafted()
    args = [inp[k] for k in ("order", "o3", "d3", "mm2", "tris9")]
    want = mxu_lab.lab12_reference(*args, "mt")
    got, (ct, cs) = _l12_workers(inp)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    slots = want[..., 1].contiguous().view(torch.int32)
    hit = slots[slots >= 0]
    assert int(hit.numel()) >= 8 * 32 // 2
    assert int(hit.max()) < common.STEPS_L12 * mxu_lab.BK
    assert int(hit.max()) >= (common.STEPS_L12 - 1) * mxu_lab.BK
    assert bool((cs >= 0).reshape(-1, 4).any(0).all())
    assert bool(torch.isnan(want[0, 0, 0])) and int(slots[0, 0]) == -1
    assert int(slots[0, 1]) == -1
    # a winner in a copied quad 0 beats its copy one worker over
    q = (hit % mxu_lab.BK) % common.CLUSTER
    assert int(((q >= 0) & (q < 4)).sum()) > 0 and \
        int(((q >= 4) & (q < 8)).sum()) == 0


@pytest.mark.parametrize("tmin", [0.0, float("-inf")])
def test_plucker_epilogue_gives_the_scripts_verdict(tmin):
    """The card's epilogue (mxu_lab.plucker_epilogue: the sign test by
    min(s0, s1, s2) < 0 < max(s0, s1, s2), t = tnum x the correctly rounded
    1 / den, one test of den != 0) gives plucker_body's verdict
    (plucker_verdict: six compares, den != 0 twice) and its t on every hit,
    over every triple of sides from +-0, +-1, 2.5, -3, a subnormal, +-inf
    and NaN (one side zero, all three equal among them), at t_min 0 and
    -inf."""
    vals = torch.tensor([0.0, -0.0, 1.0, -1.0, 2.5, -3.0, 1e-40, -1e-40,
                         float("inf"), float("-inf"), float("nan")])
    s0, s1, s2 = (x.reshape(-1) for x in torch.meshgrid(vals, vals, vals,
                                                        indexing="ij"))
    hits = 0
    for tn in (1.0, -2.0, 0.0, float("inf")):
        tnum = torch.full_like(s0, tn)
        args = (s0, s1, s2, tnum, torch.full_like(s0, tmin),
                torch.full_like(s0, common.BIG))
        hit_k, t_k = mxu_lab.plucker_epilogue(*args)
        hit_s, t_s = mxu_lab.plucker_verdict(*args)
        assert torch.equal(hit_k, hit_s), tn
        assert torch.equal(t_k[hit_k].view(torch.int32),
                           t_s[hit_s].view(torch.int32)), tn
        hits += int(hit_k.sum())
    assert hits > 0
    eq = torch.nonzero((s0 == s1) & (s1 == s2) & (s0 == 1.0)).reshape(-1)
    assert bool(mxu_lab.plucker_epilogue(
        s0[eq], s1[eq], s2[eq], torch.ones(eq.numel()),
        torch.zeros(eq.numel()), torch.full((eq.numel(),), 9.0))[0].all())


def test_mt_agreement_holds_the_fma_body(monkeypatch):
    """The card's L12 mt takes the walk's FMA body: its result (the plain
    version with common.mt_test_fma, FMAs emulated in FP64) meets
    mxu_lab.mt_agreement against the unfused plain version on the
    script's first 64 tiles and on the crafted tiles; mt_agreement takes a
    t one ulp off and refuses a wrong slot and a lost hit."""
    for inp in ({k: _t(v) for k, v in _l12_inputs().items()},
                _l12_crafted()):
        args = [inp[k] for k in ("order", "o3", "d3", "mm2", "tris9")]
        ref = mxu_lab.lab12_reference(*args, "mt")
        with monkeypatch.context() as m:
            m.setattr(mxu_lab, "_mt_test", common.mt_test_fma)
            fma = mxu_lab.lab12_reference(*args, "mt")
        agree = mxu_lab.mt_agreement(fma, ref, inp)
        assert agree["ok"] and agree["rays_off"] == 0, agree
        assert agree["max_t_over_bound"] <= 0.5
    flat = ref.reshape(-1, 2)
    ids = flat[:, 1].view(torch.int32)
    i = int(torch.nonzero(ids >= 0).reshape(-1)[-1])

    def moved(t_=None, id_=None):
        out = flat.clone()
        if t_ is not None:
            out[i, 0] = t_
        if id_ is not None:
            out[i, 1] = torch.tensor([id_], dtype=torch.int32).view(
                torch.float32)[0]
        return out.reshape(ref.shape)
    a = mxu_lab.mt_agreement(moved(t_=float(np.nextafter(
        np.float32(flat[i, 0]), np.float32(np.inf)))), ref, inp)
    assert a["ok"] and a["t_bits_differ"] == 1
    a = mxu_lab.mt_agreement(moved(id_=int(ids[i]) ^ 64), ref, inp)
    assert not a["ok"] and a["rays_off"] == 1
    a = mxu_lab.mt_agreement(moved(t_=common.BIG, id_=-1), ref, inp)
    assert not a["ok"] and a["rays_off"] == 1


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


def _scan_time(f, n=32, warmup=True):
    f(jnp.int32(0))
    return 1.0


def _recorder(runs):
    """A pallas_call that records each call's kernel and inputs and
    returns zeros."""
    def record(kernel, out_shape, grid_spec):
        def call(*args):
            runs.append(dict(kernel=kernel, args=[np.asarray(a) for a in args],
                             grid=grid_spec.grid))
            if isinstance(out_shape, (list, tuple)):
                return [jnp.zeros(s.shape, s.dtype) for s in out_shape]
            return jnp.zeros(out_shape.shape, out_shape.dtype)
        return call
    return record


@functools.lru_cache(maxsize=None)
def _captured(script, argv=()):
    """The runs of the script's main (kernel_lab.py with argv; mxu_lab.py
    executed whole, its scan_time from a stub honest_timing) with
    pallas_call recorded and jax.jit the identity: [one dict per run:
    kernel, args as numpy, grid]."""
    runs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(SCRIPTS))
        mp.setattr(sys, "argv", [script, *argv])
        mp.setattr(pl, "pallas_call", _recorder(runs))
        mp.setattr(jax, "jit", lambda f: f)
        stub = types.ModuleType("honest_timing")
        stub.scan_time = _scan_time
        mp.setitem(sys.modules, "honest_timing", stub)
        with contextlib.redirect_stdout(io.StringIO()):
            mod = _load(script)
            if script == "kernel_lab":
                exec(_main_block(SCRIPTS / "kernel_lab.py"), mod.__dict__)
    return runs


@pytest.mark.parametrize("argv", [(), ("k5",)], ids=["default", "k5"])
def test_kernel_lab_inputs_are_the_scripts(argv):
    """kernel_lab.py's main (k0-k4 by default, or k5) passes, in each run,
    the rays, meta and tris9 that common.lab1_inputs draws, bit for bit
    (as 8 columns to k0-k3, planes to k4, rows to k5), with counts of steps
    * 8 for every tile at the steps kernel_lab.configs lists."""
    runs = _captured("kernel_lab", argv)
    cols, tris9, meta = common.lab1_inputs()
    rows = _rows(cols)
    planes = np.ascontiguousarray(rows.transpose(0, 2, 1))
    cfgs = kernel_lab.configs(argv or kernel_lab.NAMES)
    assert len(runs) == len(cfgs)
    for run, cfg in zip(runs, cfgs):
        counts, m, *rays, tris = run["args"]
        assert _digest(m) == _digest(meta) and _digest(tris) == _digest(tris9)
        assert set(counts.tolist()) == {cfg.steps * 8}
        assert counts.shape == (512,)
        if cfg.name == "k4":
            assert _digest(rays[0]) == _digest(planes)
            assert run["grid"] == (512 // 8,)
        elif cfg.name == "k5":
            assert _digest(rays[0]) == _digest(rows)
            assert run["grid"] == (512 // cfg.group,)
        else:
            assert _digest(np.stack([r[:, 0] for r in rays])) == \
                _digest(cols)
            assert run["kernel"].__name__ == cfg.name


def test_mxu_lab_inputs_are_the_scripts():
    """mxu_lab.py, executed whole, runs mt over tris9 then plucker over
    tris24 on the o3, d3, mm2 and order that common.lab12_inputs draws, bit
    for bit (o3 as run perturbs it by i * 1e-7, at i = 0)."""
    runs = _captured("mxu_lab")
    inp = common.lab12_inputs()
    assert len(runs) == 2
    for run, tris in zip(runs, ("tris9", "tris24")):
        order, o3, d3, mm2, t = run["args"]
        for k, v in (("order", order), ("o3", o3), ("d3", d3), ("mm2", mm2),
                     (tris, t)):
            assert _digest(v) == _digest(inp[k]), k
        assert run["grid"] == (common.N_TILES_L12 // 32,)


@pytest.mark.parametrize("lab", ["L1", "L2", "L3", "L12"])
def test_bound_counts_the_scripts_tests(lab):
    """bounds.CONFIGS's rays and tests a ray are those of the largest run
    of the script's main, reckoned as the script reckons them: R * nsteps
    * BK (kernel_lab.py), R * STEPS * BK (mxu_lab.py); tile_bound and
    lab12_bound's mt give lab_bound's headline."""
    site, rays, per_ray, *_ = bounds.CONFIGS[lab]
    if lab == "L12":
        runs = _captured("mxu_lab")
        n_rays = {r["args"][1].shape[0] * r["args"][1].shape[1]
                  for r in runs}
        tests = {common.STEPS_L12 * common.KBV * 128}
        assert bounds.lab12_bound("mt") == bounds.lab_bound(lab)
    else:
        name = {"L1": "k3", "L2": "k4", "L3": "k5"}[lab]
        names = ("k3", "k4", "k5")
        runs = [r for r, c in zip(_captured("kernel_lab", names),
                                  kernel_lab.configs(names))
                if c.name == name]
        n_rays = {r["args"][0].shape[0] * 128 for r in runs}
        tests = {max(int(r["args"][0][0]) // 8 for r in runs) * 8 * 128}
        assert bounds.tile_bound(name, 8) == bounds.lab_bound(lab)
    assert (n_rays, tests) == ({rays}, {per_ray})
    script = "mxu_lab" if lab == "L12" else "kernel_lab"
    assert site.startswith(f"scripts/{script}.py:")


def test_matrix_bounds_count_the_split_alike():
    """L11's and L12's matrix forms count their TF32 products SPLIT times
    over, one constant: L12's plucker bound is 0.107 ms, set by the TF32
    products (3 x 44 a test), above its FP32 epilogue's 0.084 ms."""
    assert bounds.SPLIT is kernel_lab11.SPLIT == 3
    tests12 = 65536 * 6 * 1024
    ms, by = bounds.lab12_bound("plucker")
    assert by == "operations"
    assert ms == pytest.approx(tests12 * bounds.L12_TF32_OPS *
                               kernel_lab11.SPLIT / common.PEAK_TF32 * 1e3)
    assert round(ms, 3) == 0.107 and round(bounds.lab12_epilogue_ms(), 3) == \
        0.084
    tests11 = 4096 * 8 * 8 * 128 * 32
    ms11, _ = kernel_lab11.lab11_bound(4096, 8, 1024, "mxu")
    assert ms11 == pytest.approx(tests11 * kernel_lab11.TF32_OPS *
                                 kernel_lab11.SPLIT / common.PEAK_TF32 * 1e3)
    row = next(r for r in bounds.rows() if r[0] == "L12 matrix")
    assert row[3:] == (ms, by)


def test_tile_bounds():
    """k0 moves 12 bytes a ray, k1 adds the meta rows (6.3 MB), k2 the
    table (2.9 MB) where a step is walked; k3-k5 are set by 46 FP32
    operations a test (0.0461 ms a step); k2 stages 151 MB at 8 steps."""
    assert bounds.tile_bound("k0", 8) == (65536 * 12 / 3.35e12 * 1e3,
                                          "bytes")
    k1 = bounds.tile_bound("k1", 1)[0]
    assert k1 == pytest.approx((65536 * 12 + 512 * 3072 * 4) / 3.35e9)
    assert bounds.tile_bound("k2", 0)[0] == k1
    assert bounds.tile_bound("k2", 8)[0] == pytest.approx(
        k1 + 636 * 9 * 128 * 4 / 3.35e9)
    for k in ("k3", "k4", "k5"):
        assert round(bounds.tile_bound(k, 1)[0], 4) == 0.0461
        assert round(bounds.tile_bound(k, 8)[0], 3) == 0.369
        assert bounds.tile_bound(k, 8, tile_steps=512)[0] == \
            pytest.approx(bounds.tile_bound(k, 1)[0])
    assert bounds.staged_bytes(8) == 512 * 8 * 8 * 4608


# ---------------------------------------------------------------------------
# Entry points, wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lab", [kernel_lab, mxu_lab], ids=["L1-L3", "L12"])
def test_entry_point_needs_a_card(monkeypatch, lab):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        lab.main([])


def test_kernel_lab_run_on_the_cpu():
    """run() walks every run of the script's main for its names (here with
    k5 and k5<16>, on the first 8 tiles): each result is its plain
    version's, with its tests' rate and bound; k4 and k5 equal k3."""
    inp, res = kernel_lab.run(torch.device("cpu"),
                              ("k0", "k1", "k2", "k3", "k4", "k5", "k516"),
                              reps=1, tiles=8)
    cfgs = [r["cfg"] for r in res]
    assert [(c.name, c.group, c.steps) for c in cfgs] == \
        [(c.name, c.group, c.steps) for c in kernel_lab.configs(
            ("k0", "k1", "k2", "k3", "k4", "k5", "k516"))]
    k3 = {r["cfg"].steps: r["out"] for r in res if r["cfg"].name == "k3"}
    for r in res:
        c = r["cfg"]
        assert r["bound_ms"] > 0 and r["us_per_tile"] > 0
        assert (r["gtests_s"] > 0) == (c.name in ("k3", "k4", "k5") and
                                       c.steps > 0)
        if c.name in ("k4", "k5"):
            t3, i3 = k3[c.steps]
            out = r["out"] if c.name == "k5" else r["out"].transpose(1, 2)
            assert torch.equal(out[..., 0].reshape(-1, 1).view(torch.int32),
                               t3.view(torch.int32))
            assert torch.equal(out[..., 1].reshape(-1, 1).view(torch.int32),
                               i3)
    fit = kernel_lab.step_fit(res)
    assert set(fit) == {("k0", 1), ("k1", 1), ("k2", 1), ("k3", 1),
                        ("k4", 8), ("k5", 8), ("k5", 16)}


def test_kernel_lab_entry_point_prints_the_scripts_lines(monkeypatch,
                                                         capsys):
    """main(["--device=cpu", ...]) prints the script's line per run (label
    padded to 38, steps, ms, us a tile) with G tests/s and the bound, then
    a line per fitted kernel."""
    run = kernel_lab.run
    monkeypatch.setattr(kernel_lab, "run",
                        lambda dev, names: run(dev, names, reps=1, tiles=8))
    assert kernel_lab.main(["--device=cpu", "k1", "k4", "k58"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 + 5 + 5 + 2
    assert lines[0].startswith("k1" + " " * 37 + "steps=0: ")
    assert lines[2].startswith("k4 (8 tiles/step, packed io)" + " " * 11 +
                               "steps=0: ")
    assert lines[7].startswith("k5 G= 8 (no transpose, lane-pad)     "
                               "steps=0: ")
    assert all("host ms (cpu plain)" in ln and "us/tile" in ln and
               "G tests/s; bound " in ln for ln in lines[:12])
    assert lines[12].startswith("k4 G=8: ") and " a step" in lines[12]
    with pytest.raises(ValueError, match="no kernel k9"):
        kernel_lab.main(["--device=cpu", "k9"])


def test_step_fit_reads_either_window():
    """step_fit fits ms by default and, given the key, the ms back to back,
    leaving out the runs without that reading (the CPU's)."""
    res = [dict(cfg=kernel_lab.TileConfig("k3", 1, n, ""), ms=1.0 + 2 * n,
                ms_back_to_back=0.5 + n) for n in (0, 1, 2, 4, 8)]
    res.append(dict(cfg=kernel_lab.TileConfig("k2", 1, 0, ""), ms=1.0,
                    ms_back_to_back=None))
    res.append(dict(cfg=kernel_lab.TileConfig("k2", 1, 1, ""), ms=2.0,
                    ms_back_to_back=None))
    fit = kernel_lab.step_fit(res)
    assert set(fit) == {("k3", 1), ("k2", 1)}
    assert fit["k3", 1] == pytest.approx((1.0, 2.0))
    b2b = kernel_lab.step_fit(res, "ms_back_to_back")
    assert set(b2b) == {("k3", 1)}
    assert b2b["k3", 1] == pytest.approx((0.5, 1.0))


def test_kernel_lab_entry_point_prints_the_back_to_back_reading(
        monkeypatch, capsys):
    """Where run reports the ms back to back (the card), each line gives
    it beside the single call's ms, and each fit line its fit too."""
    run = kernel_lab.run

    def with_b2b(dev, names):
        inp, res = run(dev, names, reps=1, tiles=8)
        for r in res:
            r["ms_back_to_back"] = r["ms"] / 2
        return inp, res
    monkeypatch.setattr(kernel_lab, "run", with_b2b)
    assert kernel_lab.main(["--device=cpu", "k1", "k4"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 + 5 + 1
    assert all(" ms back to back)" in ln for ln in lines[:7])
    assert lines[7].startswith("k4 G=8: ") and \
        "; back to back " in lines[7]


_SASS_LOOP = (
    ".L_x_1:\n" + "".join(
        f"        /*{16 * i:04x}*/   LDS.128 R{4 * i}, [R2+0x{i:x}] ;\n"
        for i in range(9)) +
    "        /*0090*/   FFMA R3, R3, R3, R3 ;\n"
    "        /*00a0*/   @P0 BRA `(.L_x_1) ;\n")


@pytest.mark.parametrize("names,want", [
    ({"tile_walk_kernelILi3ELi0ELi4EE": "lab1 k3",
      "tile_walk_kernelILi4ELi1ELi4EE": "lab2",
      "tile_walk_kernelILi4ELi2ELi4EE": "lab3",
      "tile_walk_kernelILi2ELi0ELi4EE": None}, 4),
    ({"tile_lab_kernelILi3ELi0EE": "lab1 k3",
      "tile_lab_kernelILi4ELi1EE": "lab2", "lab3_kernelILi4EE": "lab3",
      "tile_lab_kernelILi1ELi0EE": None}, None),
    ({"tile_lab_kernelILi3ELi0EE": "lab1 k3",
      "tile_lab_kernelILi4ELi1EE": "lab2",
      "tile_lab_kernelILi4ELi2EE": "lab3"}, 1)],
    ids=["this tree", "one slice older", "two slices older"])
def test_lab_test_loops_names_the_tile_walks(monkeypatch, names, want):
    """app/sass.lab_test_loops names L1-L3's instances with a test (L1 k3,
    L2, L3) in this tree's template and in an older checkout's kernels,
    with their rays a lane (R, or 1 for tile_lab_kernel) and instructions
    per test (a loop of 9 row loads serves 4 triangles x R rays); k0-k2
    have no test loop and no entry."""
    from tauray_torch.app import sass
    monkeypatch.setattr(sass, "functions", lambda path: {
        f"_ZN12_GLOBAL__N_1{len(n)}{n}EvPKiS2_PKfS4_iiPf": _SASS_LOOP
        for n in names})
    loops = sass.lab_test_loops("lib.so")
    assert set(loops) == {v for v in names.values() if v}
    for name, inst in names.items():
        if inst is None:
            continue
        rays = want or (4 if name.startswith("lab3_kernel") else 1)
        st = loops[inst]
        assert st["rays_a_lane"] == rays and st["loads128"] == 9
        assert st["tests"] == 4 * rays
        assert st["instructions_per_test"] == pytest.approx(11 / (4 * rays))


def test_mxu_lab_entry_point_prints_the_scripts_lines(monkeypatch, capsys):
    run = mxu_lab.run
    monkeypatch.setattr(mxu_lab, "run", lambda dev: run(dev, reps=1,
                                                        tiles=32))
    assert mxu_lab.main(["--device=cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4
    assert lines[0].startswith("VPU Moller-Trumbore" + " " * 9 + ": ")
    assert lines[1].startswith("MXU Plucker" + " " * 17 + ": ")
    assert all("G ray-tri/s; bound " in ln for ln in lines[:2])
    assert lines[2].startswith("mt against its plain version: ")
    assert lines[3].startswith("plucker against its plain version: ")
    assert all("ok True" in ln for ln in lines[2:])


_PLUCKER_LOOP = (
    ".L_x_7:\n" + "".join(
        f"        /*{16 * i:04x}*/   HMMA.{1688 if i < 18 else 1684}.F32.TF32"
        f" R{i}, R1, R2, R3 ;\n" for i in range(24)) +
    "        /*0180*/   FFMA R3, R3, R3, R3 ;\n"
    "        /*0190*/   @P0 BRA `(.L_x_7) ;\n")


@pytest.mark.parametrize("older", [False, True],
                         ids=["this tree", "PR 13's kernels"])
def test_lab_test_loops_names_l12(monkeypatch, older):
    """app/sass.lab_test_loops names L12's mt, the walk's kLab 12 instance
    (4 rays a lane; an older checkout's lab12_mt_kernel, one ray a lane),
    and plucker: a loop of 18 m16n8k8 and 6 m16n8k4 products serves one
    column block, 8 tests a lane, as 42 m16n8k4 did."""
    from tauray_torch.app import sass
    mt = "lab12_mt_kernel" if older else \
        "brick_walk_kernelILi12ELi0ELi0ELi32ELi4EE"
    plucker = _PLUCKER_LOOP.replace("HMMA.1688", "HMMA.1684") + "".join(
        f"        /*{16 * i:04x}*/   HMMA.1684.F32.TF32 R1, R1, R2, R3 ;\n"
        for i in range(18)) if older else _PLUCKER_LOOP
    if older:       # the 18 extra products inside the loop, before its BRA
        plucker = plucker.replace("        /*0190*/   @P0 BRA `(.L_x_7) ;\n",
                                  "") + "        /*0400*/   @P0 BRA " \
            "`(.L_x_7) ;\n"
    monkeypatch.setattr(sass, "functions", lambda path: {
        f"_ZN12_GLOBAL__N_1{len(mt)}{mt}EvPKiPKfS4_": _SASS_LOOP,
        "_ZN12_GLOBAL__N_120lab12_plucker_kernelEPKiPKfS3_": plucker})
    loops = sass.lab_test_loops("lib.so")
    assert set(loops) == {"lab12 mt", "lab12 plucker"}
    rays = 1 if older else 4
    assert loops["lab12 mt"]["rays_a_lane"] == rays
    assert loops["lab12 mt"]["tests"] == 4 * rays
    st = loops["lab12 plucker"]
    assert st["tests"] == 8
    assert st["hmma"] == (42 if older else 24)
    assert st["hmma_k8"] == (0 if older else 18)
    assert st["instructions_per_test"] == pytest.approx(
        st["loop_instructions"] / 8)


def test_tile_wrappers_check_their_arguments():
    cols, tris9, meta = _l1_inputs()
    c, m, r, t = (_t(x) for x in (_counts(N_TILES, 1), meta, cols, tris9))
    lab_kernel.check_tile("lab1", "k3", c, m, r, t, 1)
    with pytest.raises(ValueError, match="no mode"):
        lab_kernel.check_tile("lab1", "k4", c, m, r, t, 1)
    with pytest.raises(ValueError, match="meta entries"):
        lab_kernel.check_tile("lab1", "k3", c, m[:-4], r, t, 1)
    with pytest.raises(ValueError, match="rays"):
        lab_kernel.check_tile("lab2", "k4", c, m, r, t, 8)
    with pytest.raises(ValueError, match="groups of 3"):
        lab_kernel.check_tile("lab3", "k5", c, m, _t(_rows(cols)), t, 3)
    with pytest.raises(ValueError, match="groups of 2"):
        lab_kernel.check_tile("lab1", "k3", c, m, r, t, 2)
    inp = {k: _t(v) for k, v in _l12_inputs(32).items()}
    args = [inp[k] for k in ("order", "o3", "d3", "mm2")]
    lab_kernel.check_lab12("plucker", *args, inp["tris24"])
    with pytest.raises(ValueError, match=r"not \(C, 24, 1, 128\)"):
        lab_kernel.check_lab12("plucker", *args, inp["tris9"])
    with pytest.raises(ValueError, match="order rows of 48, not 64"):
        lab_kernel.check_lab12("mt", args[0][:, :48].contiguous(), *args[1:],
                               inp["tris9"])
    meta_dev = torch.zeros(1, device="meta")
    with pytest.raises(ValueError, match="no lab kernel"):
        kernel_lab.lab1(c, m, meta_dev, t, "k3")
    with pytest.raises(ValueError, match="no lab kernel"):
        mxu_lab.lab12(args[0], meta_dev, *args[2:], inp["tris9"], "mt")


def test_the_shared_header_is_in_the_build_hash(monkeypatch, tmp_path):
    """csrc/lab_common.cuh, which four sources include, is built into none
    alone but rebuilds them all when it changes: the build hash reads
    every file of csrc/."""
    import shutil
    from tauray_torch.ops import trace_kernel as tk
    shutil.copytree(pathlib.Path(tk._PKG) / "csrc", tmp_path / "csrc")
    monkeypatch.setattr(tk, "_PKG", str(tmp_path))
    before = tk._digest()
    header = tmp_path / "csrc" / "lab_common.cuh"
    assert "lab_common.cuh" not in {pathlib.Path(v).name
                                    for v in tk.SOURCES.values()}
    for src in ("brick_lab", "k1_lab", "tile_lab", "mxu_lab"):
        assert '#include "lab_common.cuh"' in (
            tmp_path / "csrc" / f"{src}.cu").read_text()
    header.write_text(header.read_text() + "\n")
    assert tk._digest() != before
