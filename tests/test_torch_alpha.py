"""Alpha-tested traversal and the Sobol samplers of tauray_torch against
tauray_tpu's, on the CPU.

  * the alpha test (_alpha_skip_impl) and the fixed-round trace_alpha of
    ops/trace_utils on the same hits of a stack of leaf cards: skips equal,
    re-trace t_min within 1e-6 relative (XLA:CPU may contract
    t * (1 + 1e-5) + 1e-6 into one FMA);
  * the compacted re-trace rounds (_trace_alpha_program) on a wave with
    more than 8,192 pending rays, so that rounds service a capped sub-wave
    and leave the rest pending; its pending rays per round (ALPHA_PENDING),
    and rounds run once nothing is pending changing nothing, bit for bit;
  * 16x16 foliage images under the flat default (K1), flat
    TAURAY_VM_KERNEL=v2 (K4) and per-model (K3) tracers against
    tauray_tpu's renderer (its XLA traversal on the CPU), with the bar of
    tests/test_torch_pt.py;
  * an analytic check: a floor under a sun, shadowed by a half-alpha
    card, receives half the unshadowed light;
  * the Sobol streams bit-equal for all three samplers, and a 16x16 Sponza
    image under sobol-owen against tauray_tpu's.

Hits are compared with tests/test_torch_cluster.py's tie-aware rule: the
two packages walk triangles in other orders and round t differently (FMA
contraction), so at an exact-t tie they may pick different triangles,
each verified in float64.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauray_torch.ops import rng as trng
from tauray_torch.ops import sobol as tsobol
from tauray_torch.ops import trace_utils as ttu
from tauray_torch.stages import path_tracer as tpt
from tauray_tpu.ops import rng as jrng
from tauray_tpu.ops import sobol as jsobol
from tauray_tpu.ops import trace_utils as jtu
from tauray_tpu.stages import path_tracer as jpt

from test_torch_cluster import T_ATOL, T_RTOL, _assert_ids_match_up_to_ties
from test_torch_pt import _opt

# the tests run in several worker processes at once: keep torch's
# intra-op pool small so they do not oversubscribe the cores
torch.set_num_threads(2)

CPU = torch.device("cpu")
FOLIAGE = "proc://sponza?tris=8192&foliage=1"
SPONZA = "proc://sponza?tris=8192"


def _render(pkg: str, scene, **kw):
    """`pkg`'s PathTracerRenderer on `scene` (16x16, 2 spp, depth 3,
    linear tonemap unless kw says) and its first frame's RGB."""
    gltf = importlib.import_module(f"{pkg}.io.gltf")
    options = importlib.import_module(f"{pkg}.options")
    renderer = importlib.import_module(f"{pkg}.renderer.rt_renderer")
    s = importlib.import_module(f"{pkg}.scene.scene").Scene()
    gltf.load_scene(scene, s)
    args = (CPU,) if pkg == "tauray_torch" else ()
    r = renderer.PathTracerRenderer(_opt(options.Options, **kw), *args)
    r.set_scene(s)
    return r, r.render()[0][..., :3]


def _quad_stack(pkg: str):
    """A wave target built with `pkg`'s own scene classes: six 8x8 leaf
    cards (the foliage Sponza's alpha-cutout texture, repeated 4x4 and
    shifted per card) facing the ray direction at z = 1..6, an opaque
    white wall at z = 8, a sun and a camera. The cards are never hit at a
    grazing angle, where t = (n.v0 - n.o) / (n.d) would cancel and the
    packages' roundings (FMA) would part by more than the K1 tolerance."""
    m = {n: importlib.import_module(f"{pkg}.scene.{n}") for n in (
        "scene", "mesh", "material", "light", "transformable", "camera")}
    proc = importlib.import_module(f"{pkg}.io.procedural")
    s = m["scene"].Scene()
    s.textures = [proc._leaf_texture()]
    s.texture_meta = [{}]
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)

    def quad(half, z, mat, uv0=0.0):
        verts = np.array([[-half, -half, z], [half, -half, z],
                          [half, half, z], [-half, half, z]], np.float32)
        uvs = np.array([[0, 0], [4, 0], [4, 4], [0, 4]], np.float32) + uv0
        model = m["mesh"].Model()
        model.add_vertex_group(mat, m["mesh"].Mesh(positions=verts,
                                                   indices=idx, uvs=uvs))
        return model
    leaf = m["material"].Material(albedo_tex=0, metallic_factor=0.0,
                                  alpha_cutoff=0.5, double_sided=True)
    wall = m["material"].Material(metallic_factor=0.0, double_sided=True)
    for k in range(6):
        e = s.add(f"card_{k}")
        e.transform = m["transformable"].Transformable()
        e.model = quad(4.0, 1.0 + k, leaf, uv0=0.37 * k)
    e = s.add("wall")
    e.transform = m["transformable"].Transformable()
    e.model = quad(20.0, 8.0, wall)
    le = s.add("sun")
    le.transform = m["transformable"].Transformable()
    le.light = m["light"].DirectionalLight((2.0, 2.0, 2.0), 0.0)
    ce = s.add("cam")
    ce.transform = m["transformable"].Transformable(position=(0, 0, -5))
    ce.camera = m["camera"].Camera()
    ce.camera.perspective(30, 1.0, 0.1, 100.0)
    ce.camera_enabled = True
    return s


@pytest.fixture(scope="module")
def quads():
    """Both renderers on the card stack (flat tracers in slot-id mode, the
    slot-ordered scenes) and 16,384 rays from z = 0 toward +z, tilted by
    up to 0.3: nearly every first hit lies on a card, so it is flagged."""
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer
    from tauray_tpu.renderer.rt_renderer import PathTracerRenderer as JPT
    from tauray_tpu.options import Options as JOptions
    rr = PathTracerRenderer(_opt_port(), CPU)
    rr.set_scene(_quad_stack("tauray_torch"))
    jr = JPT(_opt(JOptions))
    jr.set_scene(_quad_stack("tauray_tpu"))
    assert rr.cfg.has_alpha_materials
    assert rr.bvh.alpha_base == jr.bvh.alpha_base < rr.bvh.n_clusters * 128
    rng = np.random.default_rng(21)
    R = 16384
    o = np.zeros((R, 3), np.float32)
    o[:, :2] = rng.uniform(-3, 3, (R, 2))
    d = np.concatenate([rng.uniform(-0.3, 0.3, (R, 2)), np.ones((R, 1))],
                       axis=1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dict(rr=rr, jr=jr, tscene=rr._slot_scene(),
                jscene=jr._slot_scene(),
                tri_slot=rr.arrays.tri_pos[rr._perm], o=o, d=d)


def _assert_hits_match(f, o, d, h, jh):
    _assert_ids_match_up_to_ties(f["tri_slot"], o, d, h.t.numpy(),
                                 h.tri_id.numpy(), np.asarray(jh.t),
                                 np.asarray(jh.tri_id))


def test_alpha_skip_matches_jax(quads):
    """_alpha_skip_impl on the same hits and cutoffs (barycentrics
    recomputed from the gathered rows, as after need_uv=False traces)."""
    f = quads
    o, d = f["o"][:4096], f["d"][:4096]
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    hit, flag = f["rr"].bvh.trace_flagged(to, td, 0.0, float("inf"),
                                          need_uv=False)
    R = o.shape[0]
    cut = np.random.default_rng(5).random(R).astype(np.float32)
    tmin = np.full(R, 1e-4, np.float32)
    skip, ntmin = tpt._alpha_skip_impl(
        f["tscene"], hit.t, hit.tri_id, hit.u, hit.v, torch.from_numpy(cut),
        torch.from_numpy(tmin), o=to, d=td, recompute_uv=True)
    jskip, jntmin, janyskip = jpt._alpha_skip_impl(
        f["jscene"], jnp.asarray(hit.t.numpy()),
        jnp.asarray(hit.tri_id.numpy()), jnp.asarray(hit.u.numpy()),
        jnp.asarray(hit.v.numpy()), jnp.asarray(cut), jnp.asarray(tmin),
        o=jnp.asarray(o), d=jnp.asarray(d), recompute_uv=True)
    np.testing.assert_array_equal(skip.numpy(), np.asarray(jskip))
    assert bool(janyskip)
    assert int(flag.sum()) > R // 2
    assert 0 < int(skip.sum()) < int(flag.sum())     # some leaves, some gaps
    np.testing.assert_allclose(ntmin.numpy(), np.asarray(jntmin), rtol=1e-6,
                               atol=0)
    # only flagged (alpha-capable) hits can be skipped
    assert not bool((skip & ~flag).any())


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_trace_alpha_fixed_rounds_matches_jax(quads, any_hit):
    """ops/trace_utils.trace_alpha (2 fixed rounds) against tauray_tpu's on
    the same rays and cutoffs; shadow_visibility_alpha equally."""
    f = quads
    o, d = f["o"][:2048], f["d"][:2048]
    R = o.shape[0]
    cut = np.random.default_rng(6).random(R).astype(np.float32)
    tmax = np.random.default_rng(7).uniform(0.5, 12, R).astype(np.float32)
    tm = tmax if any_hit else np.full(R, np.inf, np.float32)
    h = ttu.trace_alpha(f["tscene"], f["rr"].bvh, torch.from_numpy(o),
                        torch.from_numpy(d), 1e-4, torch.from_numpy(tm),
                        torch.from_numpy(cut), True, any_hit=any_hit,
                        need_uv=False)
    jh = jtu.trace_alpha(f["jscene"], f["jr"].bvh, jnp.asarray(o),
                         jnp.asarray(d), 1e-4, jnp.asarray(tm),
                         jnp.asarray(cut), True, any_hit=any_hit,
                         need_uv=False)
    _assert_hits_match(f, o, d, h, jh)
    first = f["rr"].bvh.trace(torch.from_numpy(o), torch.from_numpy(d),
                              1e-4, torch.from_numpy(tm), need_uv=False)
    assert int((h.tri_id != first.tri_id).sum()) > R // 8   # rays skipped
    if any_hit:
        vis = ttu.shadow_visibility_alpha(
            f["tscene"], f["rr"].bvh, torch.from_numpy(o),
            torch.from_numpy(d), 1e-4, torch.from_numpy(tm),
            torch.from_numpy(cut), True)
        jvis = jtu.shadow_visibility_alpha(
            f["jscene"], f["jr"].bvh, jnp.asarray(o), jnp.asarray(d), 1e-4,
            jnp.asarray(tm), jnp.asarray(cut), True)
        np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
        assert 0 < float(vis.mean()) < 1


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_trace_alpha_program_past_the_cap(quads, any_hit):
    """_trace_alpha_program (compacted rounds, cap 8,192 of 16,384 rays)
    against tauray_tpu's on the same rays and cutoffs: more rays are
    pending than one round services, rounds end with rays still pending
    or serviced, ids equal (tie-aware) and t within the K1 tolerance."""
    f = quads
    o, d = f["o"], f["d"]
    R = o.shape[0]
    cut = np.random.default_rng(8).random(R).astype(np.float32)
    tmax = np.random.default_rng(9).uniform(0.5, 12, R).astype(np.float32)
    tm = tmax if any_hit else np.full(R, np.inf, np.float32)
    rounds = []
    skip_impl = tpt._alpha_skip_impl

    def counting(*a, **k):
        rounds.append(1)
        return skip_impl(*a, **k)
    tpt._alpha_skip_impl = counting
    try:
        _, pending = f["rr"].bvh.trace_flagged(
            torch.from_numpy(o), torch.from_numpy(d), 1e-4,
            torch.from_numpy(tm), any_hit=any_hit, sort_rays=True,
            need_uv=False)
        h = tpt._trace_alpha_program(
            f["tscene"], f["rr"].bvh, torch.from_numpy(o),
            torch.from_numpy(d), 1e-4, torch.from_numpy(tm),
            torch.from_numpy(cut), True, any_hit=any_hit, rounds=6,
            sort=True)
    finally:
        tpt._alpha_skip_impl = skip_impl
    cap = min(R, max(8192, (R // 32) // 8192 * 8192))
    assert cap == 8192 and int(pending.sum()) > cap
    assert len(rounds) >= 2
    jh = jpt._trace_alpha_program(
        f["jscene"], f["jr"].bvh, jnp.asarray(o), jnp.asarray(d), 1e-4,
        jnp.asarray(tm), jnp.asarray(cut), True, any_hit=any_hit, rounds=6,
        sort=True)
    _assert_hits_match(f, o, d, h, jh)
    assert h.tri_id.dtype == torch.int32
    np.testing.assert_allclose(h.t.numpy()[h.tri_id.numpy() >= 0],
                               np.asarray(jh.t)[h.tri_id.numpy() >= 0],
                               rtol=T_RTOL, atol=T_ATOL)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_alpha_pending_per_round(quads, monkeypatch, any_hit):
    """_trace_alpha_program runs every round with no host read. On the
    capped wave of test_trace_alpha_program_past_the_cap with 16 rounds:
    ALPHA_PENDING holds the wave's pending rays at the start of each
    round and after the last, falling to 0 within the rounds; the rounds
    run after that change nothing, so the hits equal, bit for bit, those
    of a run that stops at the first round with nothing pending."""
    f = quads
    R = f["o"].shape[0]
    cut = torch.from_numpy(np.random.default_rng(8).random(R).astype(
        np.float32))
    tmax = torch.from_numpy(np.random.default_rng(9).uniform(
        0.5, 12, R).astype(np.float32)) if any_hit else float("inf")

    def trace(rounds):
        monkeypatch.setattr(tpt, "ALPHA_PENDING", [])
        hit = tpt._trace_alpha_program(
            f["tscene"], f["rr"].bvh, torch.from_numpy(f["o"]),
            torch.from_numpy(f["d"]), 1e-4, tmax, cut, True,
            any_hit=any_hit, rounds=rounds, sort=True)
        [(rays, c)] = tpt.ALPHA_PENDING
        assert rays == R
        return hit, c.tolist()

    hit, run = trace(16)
    assert len(run) == 17 and run[0] > 8192 and run[-1] == 0
    assert all(a >= b for a, b in zip(run, run[1:]))
    n = run.index(0)
    assert 1 < n < 16
    short, run_n = trace(n)
    assert run_n == run[:n + 1]
    for a, b in zip(hit, short):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)


# tauray_tpu's images by (scene, options): the flat foliage image serves
# both flat tests (the JAX renderer has no TAURAY_VM_KERNEL choice on the
# CPU), and rendering it costs the JAX compiles
_JAX_IMAGES = {}


def _image_pair(scene, monkeypatch=None, v2=False, **kw):
    """(port renderer, port image, tauray_tpu's image) of `scene`, 16x16;
    the port renders under TAURAY_VM_KERNEL=v2 when v2 is set."""
    key = (scene, tuple(sorted(kw.items())))
    if key not in _JAX_IMAGES:
        _JAX_IMAGES[key] = _render("tauray_tpu", scene, **kw)[1]
    want = _JAX_IMAGES[key]
    if v2:
        monkeypatch.setenv("TAURAY_VM_KERNEL", "v2")
    serviced = []
    skip_impl = tpt._alpha_skip_impl

    def counting(*a, **k):
        out = skip_impl(*a, **k)
        serviced.append(int(out[0].sum()))
        return out
    tpt._alpha_skip_impl = counting
    try:
        rr, got = _render("tauray_torch", scene, **kw)
    finally:
        tpt._alpha_skip_impl = skip_impl
    return rr, got, want, serviced


def _assert_image_close(got, want):
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    within = float((rel.max(axis=-1) <= 1e-3).mean())
    mean_rel = abs(float(got.mean()) / float(want.mean()) - 1.0)
    print(f"pixels within 1e-3: {within:.4f}; image mean port "
          f"{got.mean():.6f} jax {want.mean():.6f} (rel {mean_rel:.2e})")
    assert np.isfinite(got).all() and got.mean() > 0
    assert within >= 0.99
    assert mean_rel <= 1e-3


@pytest.mark.parametrize("path", ["flat", "flat-v2", "per-model"])
def test_foliage_image_matches_jax(monkeypatch, path):
    """16x16, 2 spp, depth 3, linear tonemap on the foliage Sponza: the
    port (plain K1, plain K4 under TAURAY_VM_KERNEL=v2, or the instanced
    tracer's plain K3) against tauray_tpu's renderer; the frame's alpha
    rounds skip transparent hits."""
    from tauray_torch.ops import cluster as tcl
    calls = []
    for name in ("trace_tiles_vm2", "trace_tiles_vm3", "trace_tiles_inst"):
        fn = getattr(tcl, name)
        monkeypatch.setattr(
            tcl, name, lambda *a, _n=name, _f=fn, **k:
            (calls.append(_n), _f(*a, **k))[1])
    kw = dict(as_strategy="per-model") if path == "per-model" else {}
    rr, got, want, serviced = _image_pair(FOLIAGE, monkeypatch,
                                          v2=path == "flat-v2", **kw)
    assert rr.cfg.has_alpha_materials
    assert sum(serviced) > 0                     # transparent hits skipped
    kernel = {"flat": "trace_tiles_vm3", "flat-v2": "trace_tiles_vm2",
              "per-model": "trace_tiles_inst"}[path]
    assert set(calls) == {kernel}
    _assert_image_close(got, want)


def test_half_alpha_card_halves_sunlight():
    """tests/test_torch_pt.py's Lambertian floor under a sun straight down
    (L = 2, albedo 0.8), with a black card of constant alpha 0.5 between
    the sun and the floor (above the camera): each shadow ray passes the
    card with probability 1/2, so the floor reflects 0.5 * L * 0.8 / pi.
    8x8 pixels at 64 spp: 4,096 shadow rays, 0.8% standard error."""
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer
    from tauray_torch.scene.material import Material
    from tauray_torch.scene.mesh import Mesh, Model
    from tauray_torch.scene.transformable import Transformable
    from test_torch_scene import floor_scene
    s = floor_scene("tauray_torch")
    verts = np.array([[-50, 10, -50], [50, 10, -50], [50, 10, 50],
                      [-50, 10, 50]], np.float32)
    card = Model()
    card.add_vertex_group(
        Material(albedo_factor=np.array([0, 0, 0, 0.5], np.float32),
                 metallic_factor=0.0, double_sided=True),
        Mesh(positions=verts,
             indices=np.array([[0, 2, 1], [0, 3, 2]], np.int32)))
    e = s.add("card")
    e.transform = Transformable()
    e.model = card
    rr = PathTracerRenderer(_opt_port(width=8, height=8,
                                      samples_per_pixel=64,
                                      samples_per_pass=64,
                                      max_ray_depth=2), CPU)
    rr.set_scene(s)
    assert rr.cfg.has_alpha_materials
    got = float(rr.render()[0][..., :3].mean())
    expected = 0.5 * 2.0 * 0.8 / np.pi
    assert abs(got - expected) / expected < 0.05, (got, expected)


def _opt_port(**kw):
    from tauray_torch.options import Options
    return _opt(Options, **kw)


def test_sobol_streams_bit_equal():
    """sobol_uint, the Owen scramble, both samplers at every slot (past
    MAX_SOBOL_BOUNCES too) and draw_ray_sample under every sampler, on
    seeded uint32 inputs: bit-equal to tauray_tpu's."""
    rng = np.random.default_rng(12)
    n = 512
    coord = np.stack([rng.integers(0, 4096, n), rng.integers(0, 4096, n),
                      rng.integers(0, 2**32, n), rng.integers(0, 2**20, n)],
                     axis=1).astype(np.uint32)
    tc = torch.from_numpy(coord.astype(np.int64))
    jc = jnp.asarray(coord)

    def eq(t, j):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(
            np.int64))
    np.testing.assert_array_equal(tsobol._V, jsobol._V)
    assert tsobol.MAX_SOBOL_BOUNCES == jsobol.MAX_SOBOL_BOUNCES == 8
    eq(tsobol.sobol_uint(tc[:, 3], list(range(32))),
       jsobol.sobol_uint(jc[:, 3], list(range(32))))
    eq(tsobol.owen_scramble(tc[:, 2], tc[:, 0]),
       jsobol.owen_scramble(jc[:, 2], jc[:, 0]))
    pixel_seed = trng.pcg4d(tc)
    jpixel_seed = jrng.pcg4d(jc)
    eq(pixel_seed, jpixel_seed)
    for slot in range(10):
        eq(tsobol.sobol_owen_sample_uint(pixel_seed, tc[:, 3], slot),
           jsobol.sobol_owen_sample_uint(jpixel_seed, jc[:, 3], slot))
        eq(tsobol.sobol_z_sample_uint(tc[:, :2], tc[:, 3], slot),
           jsobol.sobol_z_sample_uint(jc[:, :2], jc[:, 3], slot))
    seed = torch.from_numpy(rng.integers(0, 2**32, (n, 4)))
    for sampler in ("uniform-random", "sobol-owen", "sobol-z2", "sobol-z3"):
        tcfg = tpt.PTConfig(width=8, height=8, n_views=1, max_bounces=3,
                            sampler=sampler)
        jcfg = jpt.PTConfig(width=8, height=8, n_views=1, max_bounces=3,
                            sampler=sampler)
        for slot in (-1, 0, 5, 9):
            ts, tr = tpt.draw_ray_sample(tcfg, seed, tc, slot)
            js, jr = jpt.draw_ray_sample(
                jcfg, jnp.asarray(seed.numpy().astype(np.uint32)), jc, slot)
            eq(ts, js)
            eq(tr, jr)


def test_sobol_owen_image_matches_jax():
    """16x16 Sponza under --sampler=sobol-owen against tauray_tpu's, with
    the bar of tests/test_torch_pt.py."""
    rr, got, want, _ = _image_pair(SPONZA, sampler="sobol-owen")
    assert rr.cfg.sampler == "sobol-owen"
    _assert_image_close(got, want)
