"""The raster renderer of tauray_torch (stages/raster.py,
renderer/raster_renderer.py) against tauray_tpu's, at 16x16 with small
tap counts (--pcf=4 --pcss=4, 64^2 maps), on a scene built here in both
packages: a textured floor (the ray-cone trilinear LOD), a wall, an
alpha-cutout leaf card over the floor (the maps trace it through the
alpha test), a sun, a spotlight and an omni point light (cascades, the
spot map and the 6 cube faces), and an environment map seen in the top
rows. Options add an alpha-BLEND pane and an SH grid.

Every G-buffer key of the last pass (`last_gbuf`) and the final image
are compared. XLA:CPU contracts multiply-adds into FMAs and eager torch
does not, so a shadow comparison `z_cmp <= d` within a few ulps of its
threshold may flip: a flip moves a pixel's visibility by 1/4 of one
light's tap (--pcf=4). Per key, at least 99% of the elements within
1e-4 + 1e-3 x |value| (RAST_SHARE), and every key's mean within 1e-3 of
its largest magnitude (measured: see the printed shares)."""

import importlib

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

CPU = torch.device("cpu")
N = 16
RAST_SHARE = 0.99
SMALL = dict(pcf=4, pcss=4, shadow_map_resolution=64)


def _quat_x(deg):
    a = np.radians(deg) / 2
    return np.array([np.sin(a), 0, 0, np.cos(a)], np.float32)


def _checker(n=32):
    ys, xs = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    m = ((xs // 4) + (ys // 4)) % 2
    img = np.where(m[..., None] == 0, np.array([200, 180, 150]),
                   np.array([90, 110, 160]))
    return np.concatenate([img, np.full((n, n, 1), 255)], -1).astype(
        np.uint8)


def _leaf(n=32):
    """An opaque disc on a transparent background (alpha 0 outside)."""
    ys, xs = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                         indexing="ij")
    a = ((xs ** 2 + ys ** 2) < 0.6).astype(np.float32) * 255
    img = np.stack([a * 0.3, a * 0.8, a * 0.2, a], -1)
    return img.astype(np.uint8)


def raster_scene(pkg: str, blend: bool = False, grid: bool = False,
                 spot: bool = True, omni: bool = True):
    """The raster test scene with `pkg`'s own scene classes. blend: an
    alpha-BLEND pane in front of the wall. grid: a 2x2x2 SH grid over the
    floor."""
    m = {n: importlib.import_module(f"{pkg}.scene.{n}") for n in (
        "scene", "mesh", "material", "light", "transformable", "camera",
        "environment_map", "sh_grid")}
    s = m["scene"].Scene()
    s.textures = [_checker(), _leaf()]
    s.texture_meta = [{}, {}]
    T = m["transformable"].Transformable
    Mat = m["material"].Material

    def quad(name, verts, mat, uv_scale=1.0):
        model = m["mesh"].Model()
        uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) * \
            uv_scale
        model.add_vertex_group(mat, m["mesh"].Mesh(
            positions=np.asarray(verts, np.float32),
            indices=np.array([[0, 2, 1], [0, 3, 2]], np.int32), uvs=uvs))
        e = s.add(name)
        e.transform = T()
        e.model = model
    quad("floor", [[-20, 0, -20], [20, 0, -20], [20, 0, 20], [-20, 0, 20]],
         Mat(albedo_factor=np.array([0.9, 0.9, 0.9, 1], np.float32),
             metallic_factor=0.0, roughness_factor=0.8, albedo_tex=0,
             double_sided=True), uv_scale=8.0)
    quad("wall", [[1.5, 0, -6], [1.5, 0, 6], [1.5, 3, 6], [1.5, 3, -6]],
         Mat(albedo_factor=np.array([0.3, 0.8, 0.4, 1], np.float32),
             metallic_factor=0.3, roughness_factor=0.5, double_sided=True))
    quad("leaf", [[-1.2, 1.2, -1.0], [0.2, 1.2, -1.0], [0.2, 1.2, 0.4],
                  [-1.2, 1.2, 0.4]],
         Mat(albedo_tex=1, alpha_cutoff=0.5, metallic_factor=0.0,
             roughness_factor=0.9, double_sided=True))
    if blend:
        quad("pane", [[0.5, 0.2, -1.5], [0.5, 0.2, 1.5], [0.5, 2.2, 1.5],
                      [0.5, 2.2, -1.5]],
             Mat(albedo_factor=np.array([0.9, 0.2, 0.2, 0.4], np.float32),
                 metallic_factor=0.0, roughness_factor=0.3, blend=True,
                 double_sided=True))
    le = s.add("sun")
    le.transform = T()
    q = np.array([-np.sin(np.pi / 6), 0.2, 0, np.cos(np.pi / 6)])
    le.transform.set_orientation((q / np.linalg.norm(q)).astype(np.float32))
    le.light = m["light"].DirectionalLight((1.5, 1.4, 1.2), 2.0)
    if spot:
        se = s.add("spot")
        se.transform = T(position=(-0.3, 2.6, 0.8))
        se.transform.set_orientation(_quat_x(-80))
        se.light = m["light"].Spotlight((8.0, 6.0, 5.0), cutoff_angle=40.0,
                                        falloff_exponent=2.0, radius=0.1)
    if omni:
        pe = s.add("bulb")
        pe.transform = T(position=(-0.5, 1.8, 1.0))
        pe.light = m["light"].PointLight((6.0, 5.0, 4.0), radius=0.05)
    rng = np.random.default_rng(3)
    e = s.add("env")
    e.environment_map = m["environment_map"].EnvironmentMap(
        image=(0.2 + rng.random((8, 16, 3))).astype(np.float32))
    ce = s.add("cam")
    ce.transform = T(position=(-1.0, 2.0, 4.0))
    ce.transform.set_orientation(_quat_x(-25))
    ce.camera = m["camera"].Camera()
    ce.camera.perspective(60, 1.0, 0.1, 100.0)
    ce.camera_enabled = True
    if grid:
        ge = s.add("probes")
        ge.transform = T(position=(0, 1.5, 0), scaling=(3, 1.5, 3))
        ge.sh_grid = m["sh_grid"].SHGrid(resolution=(2, 2, 2), order=2)
    return s


def options(pkg: str, **opts):
    """`pkg`'s Options at N x N, linear tonemap, the small tap counts;
    opts are Options attributes."""
    O = importlib.import_module(f"{pkg}.options").Options
    opt = O()
    opt.width = opt.height = N
    opt.tonemap = "linear"
    for k, v in {**SMALL, **opts}.items():
        setattr(opt, k, v)
    return opt


class FixedGrid:
    """An sh_source holding one seeded SH grid (rz, ry, rx, 9, 4) over the
    floor: RGB radiance coefficients and a visibility channel near the
    probe spacing. `to` makes the arrays the package's own."""

    def __init__(self, to):
        rng = np.random.default_rng(21)
        coef = rng.normal(0.0, 0.15, (2, 2, 2, 9, 4)).astype(np.float32)
        coef[:, :, :, 0, :3] += 1.2
        coef[:, :, :, 0, 3] = 3.0 + rng.random((2, 2, 2))
        M = np.diag([3.0, 1.5, 3.0, 1.0]).astype(np.float32)
        M[:3, 3] = (0.0, 1.5, 0.0)
        self.data = (to(coef), to(np.linalg.inv(M).astype(np.float32)))

    def step(self, host):
        pass

    def current_grid_data(self):
        return self.data


def raster_pair(scene_fn=raster_scene, sh=False, **opts):
    """(port RasterRenderer on the CPU, tauray_tpu RasterRenderer) on
    scene_fn's scene; sh: both take FixedGrid as their SH source."""
    from tauray_torch.renderer.raster_renderer import RasterRenderer as TR
    from tauray_tpu.renderer.raster_renderer import RasterRenderer as JR
    t = TR(options("tauray_torch", **opts), CPU,
           sh_source=FixedGrid(torch.from_numpy) if sh else None)
    j = JR(options("tauray_tpu", **opts),
           sh_source=FixedGrid(jax.numpy.asarray) if sh else None)
    t.set_scene(scene_fn("tauray_torch"))
    j.set_scene(scene_fn("tauray_tpu"))
    return t, j


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def hold_gbuf(got: dict, want: dict, what: str, share=RAST_SHARE):
    """Every key: the share of elements within 1e-4 + 1e-3 x |want| (NaN
    matching NaN) at least `share`, the means within 1e-3 of the largest
    magnitude. Returns {key: share}."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    out = {}
    for k in sorted(want):
        g, w = _np(got[k]).astype(np.float64), _np(want[k]).astype(
            np.float64)
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        ok = (np.abs(g - w) <= 1e-4 + 1e-3 * np.abs(w)) | \
            (np.isnan(g) & np.isnan(w))
        fin = np.isfinite(w)
        scale = max(float(np.abs(w[fin]).max()) if fin.any() else 1.0, 1e-6)
        dmean = abs(float(g[fin].mean() - w[fin].mean())) / scale
        out[k] = float(ok.mean())
        print(f"{what} {k}: {ok.mean():.4f} within, mean diff "
              f"{dmean:.2e} of {scale:.4g}")
        assert np.array_equal(np.isfinite(g), fin), (what, k)
        assert ok.mean() >= share, (what, k, ok.mean())
        assert dmean <= 1e-3, (what, k, dmean)
    return out


def frame_pair(t, j, what, move=None, frames=1):
    """Render `frames` frames in both (update_frame before each after the
    first, move(renderer, k) before it) and hold each frame's G-buffer and
    image."""
    for k in range(frames):
        for rr in (t, j):
            if move is not None:
                move(rr, k)
            if k:
                rr.update_frame()
        img_t = t.render_device()
        img_j = j.render_device()
        hold_gbuf(dict(t.last_gbuf, image=img_t),
                  dict(j.last_gbuf, image=img_j), f"{what} frame {k}")


@pytest.fixture(scope="module")
def plain():
    return raster_pair()


def test_shadow_maps_match_jax(plain):
    """The renderer's maps and light table: layout exact, depths within
    1e-4 relative where both hit."""
    t, j = plain
    from test_torch_shadow_maps import hold_maps
    hold_maps(t.shadow_maps, j.shadow_maps, "renderer")
    for a, b in zip(t.map_table, j.map_table):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_single_pass_matches_jax(plain):
    t, j = plain
    frame_pair(t, j, "single pass")
    assert float(_np(t.last_gbuf["shadow_vis"]).min()) < 1.0


@pytest.mark.parametrize("sample_shading,post_resolve", [
    (False, False), (True, False), (False, True), (True, True)])
def test_msaa_matches_jax(plain, sample_shading, post_resolve):
    """MSAA 4: per-sample shading, or one shaded pass plus 4 coverage
    waves; with the tonemap before or after the resolve."""
    t, j = plain
    for rr in (t, j):
        rr.opt.samples_per_pixel = 4
        rr.opt.sample_shading = sample_shading
        rr.opt.tonemap_post_resolve = post_resolve
        rr.opt.tonemap = "filmic"
    try:
        frame_pair(t, j, f"msaa4 shading={sample_shading} "
                   f"post={post_resolve}")
    finally:
        for rr in (t, j):
            rr.opt.samples_per_pixel = 1
            rr.opt.sample_shading = False
            rr.opt.tonemap_post_resolve = False
            rr.opt.tonemap = "linear"


def _turn(rr, k):
    """Moves and turns the camera a little every frame."""
    e = next(e for e in rr.scene.entities if e.name == "cam")
    e.transform.set_position((-1.0 + 0.15 * k, 2.0, 4.0 - 0.1 * k))
    e.transform.set_orientation(_quat_x(-25 - 2 * k))


def test_moving_camera_matches_jax(plain):
    """2 frames with a moving camera: screen_motion from the previous
    camera, the cascades re-centred on the new camera."""
    t, j = plain
    frame_pair(t, j, "moving camera", move=_turn, frames=2)
    assert np.abs(_np(t.last_gbuf["screen_motion"])).max() > 0


@pytest.mark.parametrize("probe_vis", [False, True])
def test_sh_grid_matches_jax(probe_vis):
    t, j = raster_pair(sh=True, use_probe_visibility=probe_vis)
    frame_pair(t, j, f"sh grid probe_vis={probe_vis}")


def test_alpha_blend_matches_jax():
    t, j = raster_pair(lambda pkg: raster_scene(pkg, blend=True))
    assert t.arrays.any_blend_materials
    frame_pair(t, j, "alpha blend")


def test_cascades_and_svgf_match_jax():
    """4 cascades and --denoiser=svgf over 2 frames."""
    t, j = raster_pair(shadow_map_cascades=4, denoiser="svgf")
    frame_pair(t, j, "svgf", move=_turn, frames=2)
