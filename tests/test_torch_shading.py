"""Shading math of tauray_torch against tauray_tpu on seeded random inputs:
sampling primitives, the GGX BSDF, NEE light sampling, camera rays,
vertex interpolation and texture/material sampling.

Tolerance: every element within 1e-5 relative (plus ATOL absolute),
except a tail of at most TAIL of the elements, which must be within 1e-3
relative. Reason: XLA:CPU contracts multiply-adds into FMAs and torch does
not, so a value that is a difference of nearly equal terms (a cross
product of near-parallel vectors, 1 - cos near 0, a dot product near zero
that is then divided by) differs by a few ulps of the TERMS, not of the
result; the few ill-conditioned elements of a random batch amplify that
past 1e-5."""

import math
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauray_torch.ops import ggx as tg
from tauray_torch.ops import lights as tl
from tauray_torch.ops import sampling as ts
from tauray_torch.ops import shading as tsh
from tauray_tpu.ops import ggx as jg
from tauray_tpu.ops import lights as jl
from tauray_tpu.ops import sampling as js
from tauray_tpu.ops import shading as jsh

# the tests run in several worker processes at once: keep torch's
# intra-op pool small so they do not oversubscribe the cores
torch.set_num_threads(2)

RTOL = 1e-5
ATOL = 2e-6
TAIL = 0.01
TAIL_RTOL = 1e-3
N = 4096


def _close(got, want, name="", rtol=RTOL, atol=ATOL, tail_rtol=TAIL_RTOL):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{name}[{i}]", rtol, atol, tail_rtol)
        return
    w = np.asarray(want)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g, w, err_msg=name)
    else:
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w),
                                      err_msg=name)
        fin = np.isfinite(w)
        np.testing.assert_array_equal(g[~fin], w[~fin], err_msg=name)
        g, w = g[fin], w[fin]
        bad = ~np.isclose(g, w, rtol=rtol, atol=atol)
        assert bad.sum() <= TAIL * max(bad.size, 1), _worst(name, g, w, bad)
        np.testing.assert_allclose(g, w, rtol=tail_rtol, atol=atol,
                                   err_msg=_worst(name, g, w, bad))


def _worst(name, g, w, bad):
    """A failure's report: the name, how many finite elements are off, and
    the worst one (by |got - want| over the tolerance's scale) with both
    values."""
    excess = np.abs(g - w) / (ATOL + RTOL * np.abs(w))
    i = int(np.argmax(excess)) if excess.size else 0
    worst = (f"; worst element {i}: got {g.flat[i]!r}, want {w.flat[i]!r}"
             if excess.size else "")
    return f"{name}: {int(bad.sum())} of {bad.size} elements off{worst}"


def _unit(rng, n=N):
    v = rng.standard_normal((n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _u(rng, *shape):
    return rng.random(shape, dtype=np.float32)


def _both(fn_j, fn_t, *args):
    return (fn_t(*(torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray)
                   else a
                   for a in args)),
            fn_j(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                   for a in args)))


SAMPLING = {
    "normalize": lambda r: (r.standard_normal((N, 3)).astype(np.float32),),
    "create_tangent_space": lambda r: (_unit(r),),
    "view_to_tangent_space": lambda r: tuple(_unit(r) for _ in range(4)),
    "sample_concentric_disk": lambda r: (_u(r, N, 2),),
    "sample_cosine_hemisphere": lambda r: (_u(r, N, 2),),
    "sample_sphere": lambda r: (_u(r, N, 2),),
    "sample_hemisphere": lambda r: (_u(r, N, 2),),
    "sample_blackman_harris_concentric_disk": lambda r: (_u(r, N, 2),),
    "sample_cone": lambda r: (_u(r, N, 2), _unit(r),
                              r.uniform(-1, 1, N).astype(np.float32)),
    "sample_triangle_area": lambda r: (_u(r, N, 2), *_tri(r)),
    "triangle_area_pdf": lambda r: (r.standard_normal((N, 3)).astype(
        np.float32), *_tri(r)),
    "spherical_triangle_solid_angle": lambda r: tuple(
        x / np.linalg.norm(x, axis=1, keepdims=True) for x in _tri(r)),
    "sample_spherical_triangle": lambda r: (_u(r, N, 2), *_tri(r)),
    "ray_plane_intersection_dist": lambda r: (_unit(r), *_tri(r)),
    "get_barycentric_coords": lambda r: (r.standard_normal((N, 3)).astype(
        np.float32), *_tri(r)),
}


def _tri(rng):
    """Roughly equilateral triangles of radius 0.3-1, 2-6 units away from
    the origin (light-sampling setups; no slivers, whose solid angle and
    normal are ill-conditioned)."""
    c = _unit(rng) * rng.uniform(2, 6, (N, 1)).astype(np.float32)
    u = _unit(rng)
    v = np.cross(u, _unit(rng))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    s = rng.uniform(0.3, 1.0, (N, 1))
    return tuple((c + s * (np.cos(a) * u + np.sin(a) * v) +
                  rng.normal(0, 0.05, (N, 3))).astype(np.float32)
                 for a in (0.0, 2.1, 4.2))


@pytest.mark.parametrize("name", sorted(SAMPLING))
def test_sampling(name):
    args = SAMPLING[name](np.random.default_rng(zlib.crc32(name.encode())))
    got, want = _both(getattr(js, name), getattr(ts, name), *args)
    _close(got, want, name)


def _material(rng, pkg_mat, lib, n=N):
    """SampledMaterial with zero-rough, metallic, transmissive and back-face
    refraction cases."""
    back = rng.random(n) < 0.3
    trans = np.where(rng.random(n) < 0.3, rng.random(n), 0).astype(np.float32)
    ior = rng.uniform(1.2, 1.8, n).astype(np.float32)
    refr = back & (trans > 1e-4)
    ior_in = np.where(refr, ior, 1.0).astype(np.float32)
    ior_out = np.where(refr, 1.0, ior).astype(np.float32)
    # roughness >= 0.05 (the scenes' materials use 0.06-0.81) or exactly
    # zero: below that the GGX peak 1 - cos^2(h) cancels and amplifies
    # ulp differences in h without bound
    rough = rng.uniform(0.05, 1.0, n).astype(np.float32)
    rough[rng.random(n) < 0.1] = 0.0
    f = dict(albedo=_u(rng, n, 4),
             metallic=np.where(rng.random(n) < 0.3, 1.0,
                               rng.random(n)).astype(np.float32),
             roughness=rough, emission=_u(rng, n, 3), transmittance=trans,
             ior_in=ior_in, ior_out=ior_out,
             f0=(((ior_out - ior_in) / (ior_out + ior_in)) ** 2
                 ).astype(np.float32),
             double_sided=rng.random(n) < 0.5,
             shadow_terminator_mul=np.ones(n, np.float32))
    return pkg_mat(**{k: lib(v) for k, v in f.items()})


def _view(rng):
    v = _unit(rng)
    v[:, 2] = np.abs(v[:, 2]) + 1e-3
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.mark.parametrize("mode", ["material", "hemisphere", "cosine"])
def test_bsdf_sample_and_pdf(mode):
    seed = {"material": 11, "hemisphere": 12, "cosine": 13}[mode]
    mats = [_material(np.random.default_rng(seed), m, lib) for m, lib in (
        (tsh.SampledMaterial, torch.from_numpy),
        (jsh.SampledMaterial, jnp.asarray))]
    rng = np.random.default_rng(seed + 100)
    u4, view, out = _u(rng, N, 4), _view(rng), _unit(rng)
    got = tg.material_bsdf_sample(torch.from_numpy(u4),
                                  torch.from_numpy(view), mats[0], mode)
    want = jg.material_bsdf_sample(jnp.asarray(u4), jnp.asarray(view),
                                   mats[1], mode)
    # the tail of zero-roughness samples carries lobe weights pre-divided
    # by their (near-delta) pdf, which amplifies the FMA differences
    _close(got, want, f"sample/{mode}", atol=1e-5, tail_rtol=1e-2)
    got = tg.material_bsdf_pdf(torch.from_numpy(out), torch.from_numpy(view),
                               mats[0], mode)
    want = jg.material_bsdf_pdf(jnp.asarray(out), jnp.asarray(view),
                                mats[1], mode)
    _close(got, want, f"pdf/{mode}", atol=1e-5)
    lobes_t, lobes_j = got[0], want[0]
    _close(tg.modulate_bsdf(mats[0], lobes_t),
           jg.modulate_bsdf(mats[1], lobes_j), "modulate_bsdf", atol=1e-5)
    dif, refl = _u(rng, N, 3), _u(rng, N, 3)
    _close(tg.modulate_color(mats[0], torch.from_numpy(dif),
                             torch.from_numpy(refl)),
           jg.modulate_color(mats[1], jnp.asarray(dif), jnp.asarray(refl)),
           "modulate_color")


def test_ggx_bsdf_and_attenuated_fresnel():
    """The raster path's full two-sided GGX eval and the roughness-damped
    Schlick term of its split-sum indirect light."""
    mats = [_material(np.random.default_rng(14), m, lib) for m, lib in (
        (tsh.SampledMaterial, torch.from_numpy),
        (jsh.SampledMaterial, jnp.asarray))]
    rng = np.random.default_rng(114)
    view, out = _view(rng), _unit(rng)
    _close(tuple(tg.ggx_bsdf(torch.from_numpy(out), torch.from_numpy(view),
                             mats[0])),
           tuple(jg.ggx_bsdf(jnp.asarray(out), jnp.asarray(view), mats[1])),
           "ggx_bsdf", atol=1e-5)
    cos = np.concatenate([rng.random(N - 4), [0.0, 1.0, -0.5, 1.5]]
                         ).astype(np.float32)
    _close(tg.fresnel_schlick_attenuated(torch.from_numpy(cos),
                                         mats[0].f0, mats[0].roughness),
           jg.fresnel_schlick_attenuated(jnp.asarray(cos), mats[1].f0,
                                         mats[1].roughness),
           "fresnel_schlick_attenuated")


@pytest.fixture(scope="module")
def scenes():
    """(port DeviceScene, JAX DeviceScene) of proc://sponza?tris=8192."""
    from tauray_torch.io.gltf import load_scene as tload
    from tauray_torch.options import Options as TOpt
    from tauray_torch.scene.arrays import SceneArrays as TSA
    from tauray_torch.scene.device import to_device_scene as tdev
    from tauray_torch.scene.scene import Scene as TScene
    from tauray_tpu.io.gltf import load_scene as jload
    from tauray_tpu.options import Options as JOpt
    from tauray_tpu.scene.arrays import SceneArrays as JSA
    from tauray_tpu.scene.device import to_device_scene as jdev
    from tauray_tpu.scene.scene import Scene as JScene
    ts_, js_ = TScene(), JScene()
    tload("proc://sponza?tris=8192", ts_)
    jload("proc://sponza?tris=8192", js_)
    tsa, jsa = TSA(ts_, TOpt()), JSA(js_, JOpt())
    return tdev(tsa, device=torch.device("cpu")), jdev(jsa), tsa


def test_point_and_directional_lights(scenes):
    td, jd, _ = scenes
    rng = np.random.default_rng(21)
    pos = rng.uniform(-8, 8, (N, 3)).astype(np.float32)
    u2, view = _u(rng, N, 2), _unit(rng)
    li = rng.integers(0, td.point_light_count, N)
    t = [torch.from_numpy(x) for x in (li, u2, pos, view)]
    j = [jnp.asarray(x) for x in (li.astype(np.int32), u2, pos, view)]
    # out_length = -b - sqrt(b*b - dist2 + r*r): the discriminant cancels
    # terms of size dist2 (up to ~300 here), so its absolute error is a
    # few ulps of dist2; 1e-4 world units covers that after the sqrt
    _close(tl.sample_point_light(td, t[0], t[1], t[2]),
           jl.sample_point_light(jd, j[0], j[1], j[2]), "sample_point",
           atol=1e-4)
    _close(tl.sample_point_light_pdf(td, t[0], t[2]),
           jl.sample_point_light_pdf(jd, j[0], j[2]), "point_pdf")
    _close(tl.point_light_radiance(td, t[0], t[3]),
           jl.point_light_radiance(jd, j[0], j[3]), "point_radiance")
    dli = np.zeros(N, np.int64)
    _close(tl.sample_directional_light(td, torch.from_numpy(dli), t[1]),
           jl.sample_directional_light(jd, jnp.asarray(dli.astype(np.int32)),
                                       j[1]), "sample_directional")
    # directions inside the sun's 1-degree cone must see it
    sun = -np.asarray(jd.dl_dir[0])
    view[: N // 2] = sun + 0.005 * rng.standard_normal((N // 2, 3))
    view /= np.linalg.norm(view, axis=1, keepdims=True)
    got = tl.directional_light_radiance(td, torch.from_numpy(view))
    want = jl.directional_light_radiance(jd, jnp.asarray(view))
    _close(got, want, "directional_radiance")
    assert (np.asarray(want[1]) > 0).sum() > 0
    _close(tl.environment_radiance(td, torch.from_numpy(view), False),
           jl.environment_radiance(jd, jnp.asarray(view), False), "env")


@pytest.mark.parametrize("mode", ["area", "solid-angle", "hybrid"])
def test_triangle_light_sampling(mode):
    rng = np.random.default_rng(31)
    u2 = _u(rng, N, 2)
    A, B, C = _tri(rng)
    got, want = _both(lambda *a: jl.sample_triangle_light(*a, mode),
                      lambda *a: tl.sample_triangle_light(*a, mode),
                      u2, A, B, C)
    _close(got, want, f"sample_triangle_light/{mode}", rtol=1e-4, atol=1e-5)
    P = want[0] * 3.0
    got, want = _both(lambda *a: jl.sample_triangle_light_pdf(*a, mode),
                      lambda *a: tl.sample_triangle_light_pdf(*a, mode),
                      np.asarray(P), A, B, C)
    _close(got, want, f"sample_triangle_light_pdf/{mode}", rtol=1e-4)


def test_camera_rays_and_projection(scenes):
    from tauray_torch.scene.device import to_camera_uniforms as tcu
    from tauray_tpu.scene.device import to_camera_uniforms as jcu
    _, _, tsa = scenes
    vps = [(e.camera, e.transform) for e in tsa.scene.entities
           if e.camera is not None and e.camera_enabled]
    d = tsa.camera_uniforms(vps)
    tc, jc = tcu(d, torch.device("cpu")), jcu(d)
    rng = np.random.default_rng(41)
    W, H = 64, 48
    pix = np.stack([rng.integers(0, W, N), rng.integers(0, H, N)],
                   1).astype(np.int32)
    vp = np.zeros(N, np.int32)
    off = rng.uniform(-1, 1, (N, 2)).astype(np.float32)
    size = np.array([W, H], np.float32)
    dof_u = _u(rng, N, 2)
    for o, du in ((None, None), (off, None), (off, dof_u)):
        got = tsh.get_screen_camera_ray(
            tc, torch.from_numpy(vp).long(), torch.from_numpy(pix),
            torch.from_numpy(size),
            None if o is None else torch.from_numpy(o),
            None if du is None else torch.from_numpy(du))
        want = jsh.get_screen_camera_ray(
            jc, jnp.asarray(vp), jnp.asarray(pix), size,
            None if o is None else jnp.asarray(o),
            None if du is None else jnp.asarray(du))
        _close(got, want, "camera_ray")
    wp = rng.uniform(-5, 5, (N, 3)).astype(np.float32) + \
        np.asarray(d["origin"][0, :3])
    _close(tsh.get_camera_projection(tc, torch.from_numpy(vp).long(),
                                     torch.from_numpy(wp)),
           jsh.get_camera_projection(jc, jnp.asarray(vp), jnp.asarray(wp)),
           "projection", atol=1e-5)


def test_vertex_interpolation_and_material(scenes):
    """Rays aimed at random points of random triangles of the textured
    scene: barycentrics from the row, interpolated vertex, textured
    material (albedo atlas lookups)."""
    td, jd, tsa = scenes
    rng = np.random.default_rng(51)
    # well-shaped triangles only: a degenerate one has e1 x e2 == 0 in
    # the port but a rounding-level normal under XLA's FMAs, and no ray
    # can hit it in either tracer (den == 0)
    pos = tsa.tri_pos[:tsa.num_triangles].astype(np.float64)
    e1, e2 = pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0]
    sin = np.linalg.norm(np.cross(e1, e2), axis=1) / np.maximum(
        np.linalg.norm(e1, axis=1) * np.linalg.norm(e2, axis=1), 1e-30)
    tri = rng.choice(np.flatnonzero(sin > 1e-2), N).astype(np.int32)
    b = rng.dirichlet([1, 1, 1], N).astype(np.float32)
    corners = tsa.tri_pos[tri]
    target = np.einsum("nc,ncj->nj", b, corners).astype(np.float32)
    origin = (target + _unit(rng) * 2.0).astype(np.float32)
    direction = target - origin
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    z = np.zeros(N, np.float32)
    tv = tsh.interpolate_vertex(td, torch.from_numpy(tri),
                                torch.from_numpy(z), torch.from_numpy(z),
                                torch.from_numpy(direction),
                                ray_origin=torch.from_numpy(origin))
    jv = jsh.interpolate_vertex(jd, jnp.asarray(tri), jnp.asarray(z),
                                jnp.asarray(z), jnp.asarray(direction),
                                ray_origin=jnp.asarray(origin))
    _close(tuple(tv), tuple(jv), "vertex", rtol=1e-4, atol=1e-5)
    slots = tuple(bool((tsa.inst_tex[:, k] >= 0).any()) for k in range(4))
    assert slots[0]
    tm, tv2 = tsh.sample_material(td, tv, slots=slots)
    jm, jv2 = jsh.sample_material(jd, jv, slots=slots)
    _close(tuple(tm), tuple(jm), "material", rtol=1e-4, atol=1e-5)
    _close(tv2.mapped_normal, jv2.mapped_normal, "mapped", atol=1e-5)
    col = rng.random((N, 3)).astype(np.float32)
    _close(tsh.inverse_srgb_correction(torch.from_numpy(col)),
           jsh.inverse_srgb_correction(jnp.asarray(col)), "srgb")


def test_texture_quad_floor_mod(scenes):
    """uv outside [0, 1) wraps with floor-mod (jnp.mod, torch.remainder)."""
    td, jd, tsa = scenes
    rng = np.random.default_rng(61)
    uv = rng.uniform(-3, 3, (N, 2)).astype(np.float32)
    tex = np.full(N, 0, np.int32)
    tex[::5] = -1
    size = np.repeat(tsa.texture_size[:1].astype(np.float32), N, 0)
    blk = np.repeat(tsa.tex_meta[0, 0, :2][None].astype(np.float32), N, 0)
    got = tsh.sample_texture_quad(td, torch.from_numpy(tex),
                                  torch.from_numpy(size),
                                  torch.from_numpy(uv),
                                  block=torch.from_numpy(blk))
    want = jsh.sample_texture_quad(jd, jnp.asarray(tex), jnp.asarray(size),
                                   jnp.asarray(uv), block=jnp.asarray(blk))
    _close(got, want, "texture", atol=1e-5)
    assert math.isclose(float(np.asarray(want)[::5].min()), 1.0)


def test_texture_lod_and_ray_cone(scenes):
    """The raster path's trilinear mip sample (sample_texture_lod, lods
    below 0 and past the last level included), its ray-cone lod and
    sample_material's lod_uv, on the textured scene."""
    td, jd, tsa = scenes
    rng = np.random.default_rng(71)
    uv = rng.uniform(-2, 2, (N, 2)).astype(np.float32)
    tex = rng.integers(-1, tsa.tex_meta.shape[0], N).astype(np.int32)
    lod = rng.uniform(-2, 9, N).astype(np.float32)
    _close(tsh.sample_texture_lod(td, torch.from_numpy(tex),
                                  torch.from_numpy(uv),
                                  torch.from_numpy(lod)),
           jsh.sample_texture_lod(jd, jnp.asarray(tex), jnp.asarray(uv),
                                  jnp.asarray(lod)), "texture lod",
           atol=1e-5)
    # well-shaped triangles only: a degenerate one's world area is 0 in
    # the port and rounding noise under XLA's FMAs, so its texel density
    # differs without bound (ROADMAP Queue 3), and no ray hits it
    pos = tsa.tri_pos[:tsa.num_triangles].astype(np.float64)
    e1, e2 = pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0]
    sin = np.linalg.norm(np.cross(e1, e2), axis=1) / np.maximum(
        np.linalg.norm(e1, axis=1) * np.linalg.norm(e2, axis=1), 1e-30)
    tri = rng.choice(np.flatnonzero(sin > 1e-2), N).astype(np.int32)
    b = rng.dirichlet([1, 1, 1], N).astype(np.float32)
    d = _unit(rng)
    fp = rng.uniform(1e-4, 1e-1, N).astype(np.float32)
    tv = tsh.interpolate_vertex(td, torch.from_numpy(tri),
                                torch.from_numpy(b[:, 1]),
                                torch.from_numpy(b[:, 2]),
                                torch.from_numpy(d))
    jv = jsh.interpolate_vertex(jd, jnp.asarray(tri), jnp.asarray(b[:, 1]),
                                jnp.asarray(b[:, 2]), jnp.asarray(d))
    lod_t = tsh.ray_cone_lod(td, tv, torch.from_numpy(fp),
                             torch.from_numpy(d))
    lod_j = jsh.ray_cone_lod(jd, jv, jnp.asarray(fp), jnp.asarray(d))
    _close(lod_t, lod_j, "ray cone lod", atol=1e-4)
    tm, _ = tsh.sample_material(td, tv, lod_uv=lod_t)
    jm, _ = jsh.sample_material(jd, jv, lod_uv=lod_j)
    _close(tuple(tm), tuple(jm), "material lod", rtol=1e-4, atol=1e-5)


def test_environment_map_sampling():
    """NEE on an image environment map (alias table) and the escaped-ray
    radiance lookup, on both packages' DeviceScene of the same image."""
    from tauray_torch.scene.device import to_device_scene as tdev
    from tauray_tpu.scene.device import to_device_scene as jdev
    from test_torch_scene import floor_scene
    rng = np.random.default_rng(71)
    img = rng.uniform(0.1, 4.0, (8, 16, 3)).astype(np.float32)
    dev = []
    for pkg, to_dev in (("tauray_torch",
                         lambda sa: tdev(sa, device=torch.device("cpu"))),
                        ("tauray_tpu", jdev)):
        import importlib
        s = floor_scene(pkg)
        env = importlib.import_module(f"{pkg}.scene.environment_map")
        s.add("env").environment_map = env.EnvironmentMap(image=img)
        sa = importlib.import_module(f"{pkg}.scene.arrays").SceneArrays(
            s, importlib.import_module(f"{pkg}.options").Options())
        dev.append(to_dev(sa))
    td, jd = dev
    rand = rng.integers(0, 2**32, (N, 3), dtype=np.uint64).astype(np.uint32)
    _close(tl.sample_environment_map(td, torch.from_numpy(
        rand.astype(np.int64))), jl.sample_environment_map(
            jd, jnp.asarray(rand)), "sample_environment_map")
    view = _unit(rng)
    _close(tl.environment_radiance(td, torch.from_numpy(view), True),
           jl.environment_radiance(jd, jnp.asarray(view), True),
           "environment_radiance")
