"""Shadow maps of tauray_torch (stages/shadow_map.py) against
tauray_tpu's, on the raster test scene (tests/test_torch_raster.py: a
sun, a spotlight, an omni light and an alpha-cutout leaf card) and on
proc://sponza?tris=8192.

build_shadow_maps at 64^2 with 1 and 4 cascades: the layout (views,
params, biases, radii, cascade counts, light indices) equal, and the
depths where both hit within DEPTH_RTOL (1e-5) relative: the maps' rays
are made in float64 and rounded once in both packages (they come out
equal), and the traversal's t differs by a few ulps where XLA:CPU
contracts multiply-adds into FMAs. On the CPU tauray_tpu traces with its
XLA fallback (Moller-Trumbore), the port with the plain K1
(Baldwin-Weber), so a ray through a triangle's edge can hit in one and
miss in the other, or pass between two triangles that share an edge and
hit a farther surface. At most EDGE_SHARE (1e-3) of the texels differ
(measured: 1 of 32,768 on the test scene, a ray along the wall's top
edge; 16 of 262,144 on Sponza), each one such edge: hit or miss differs
only on a silhouette (a texel whose 3x3 neighbourhood in its map holds
both hits and misses), and where the depths differ one package's depth
is within 1e-4 of a neighbouring texel's (the other's ray went through
the crack).

pcf_visibility runs eagerly (not jitted) in both packages on the same
maps (tauray_tpu's, copied), at full tap counts: pcf 0/16/64, pcss 0/32,
cascades 1 and 4, on seeded points near the scene's surfaces. Each tap
compares `z_cmp <= stored depth`, a threshold that an ulp of rounding
(FMA, or the rotation's cos/sin) can flip; a flip moves a point's
visibility by at most 1/taps, unless it flips a PCSS blocker and with it
the penumbra. At least 99% of the points within 1e-5 (PCF_SHARE), every
point within 2/taps + 1e-5 where the blocker search agrees, and the
means within 1e-3.

The last three tests make the assertions of tests/test_shadow_maps.py
(which needs the unmounted test.glb) on proc://sponza?tris=8192, for
both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauray_torch.stages import shadow_map as tsm
from tauray_tpu.stages import shadow_map as jsm

from test_torch_raster import CPU, options, raster_scene

torch.set_num_threads(2)

DEPTH_RTOL = 1e-5
EDGE_SHARE = 1e-3
PCF_SHARE = 0.99
SPONZA = "proc://sponza?tris=8192"


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _build(pkg, scene, opt, center=None, cam_pos=None):
    """(maps, arrays) of `pkg` on `scene` with `opt`, the alpha test on."""
    import importlib
    SA = importlib.import_module(f"{pkg}.scene.arrays").SceneArrays
    cl = importlib.import_module(f"{pkg}.ops.cluster")
    dv = importlib.import_module(f"{pkg}.scene.device")
    sm = importlib.import_module(f"{pkg}.stages.shadow_map")
    arrays = SA(scene, opt)
    kw = dict(tri_opaque=cl.tri_opacity(arrays.tri_instance,
                                        arrays.inst_has_alpha))
    if pkg == "tauray_torch":
        kw["device"] = CPU
        ds = dv.to_device_scene(arrays, False, CPU)
    else:
        ds = dv.to_device_scene(arrays, False)
    tracer, _ = cl.build_cluster_tracer(arrays.tri_pos, arrays.tri_instance,
                                        **kw)
    if center is None:
        center = arrays.tri_pos.reshape(-1, 3).mean(axis=0)
    maps = sm.build_shadow_maps(arrays, tracer, opt, center,
                                device_scene=ds, cam_pos=cam_pos)
    return maps, arrays


def _silhouette(hit):
    """(L, H, W) bool: texels whose 3x3 neighbourhood (clipped) in their
    map holds both hits and misses."""
    L, H, W = hit.shape
    pad = np.pad(hit, ((0, 0), (1, 1), (1, 1)), mode="edge")
    win = np.stack([pad[:, dy:dy + H, dx:dx + W] for dy in range(3)
                    for dx in range(3)])
    return win.any(0) & ~win.all(0)


def _near_neighbour(depth, val):
    """(L, H, W) bool: val within 1e-4 relative of one of the 8
    neighbouring texels of depth (clipped)."""
    L, H, W = depth.shape
    pad = np.pad(depth, ((0, 0), (1, 1), (1, 1)), mode="edge")
    near = np.zeros(depth.shape, bool)
    for dy in range(3):
        for dx in range(3):
            if dy == dx == 1:
                continue
            nb = pad[:, dy:dy + H, dx:dx + W]
            near |= np.abs(val - nb) <= 1e-4 * np.abs(nb)
    return near


def hold_maps(got, want, what):
    """Layout equal; depths within DEPTH_RTOL relative but on at most
    EDGE_SHARE of the texels, each an edge: hit/miss differing on a
    silhouette, or one package's depth within 1e-4 of a neighbour's.
    Returns the largest relative depth difference elsewhere."""
    assert got.resolution == want.resolution
    for k in ("view", "proj_kind", "params", "light_index", "min_bias",
              "max_bias", "pcf_radius", "cascade_count"):
        np.testing.assert_array_equal(_np(getattr(got, k)),
                                      _np(getattr(want, k)), err_msg=k)
    g, w = _np(got.depth), _np(want.depth)
    far = _np(want.params)[:, 3][:, None, None]
    hit_g, hit_w = g < far, w < far
    rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-6)
    flip = hit_g != hit_w
    crack = hit_g & hit_w & (rel > DEPTH_RTOL)
    same = hit_g & hit_w & ~crack
    worst = float(rel[same].max()) if same.any() else 0.0
    print(f"{what}: {g.shape[0]} maps, {hit_w.mean():.4f} of texels hit, "
          f"{int(flip.sum())} hit/miss differ, {int(crack.sum())} cracks, "
          f"depth rel {worst:.2e} elsewhere")
    assert (flip | crack).mean() <= EDGE_SHARE, (what, int(flip.sum()),
                                                 int(crack.sum()))
    assert not (flip & ~_silhouette(hit_w)).any(), what
    assert not (crack & ~(_near_neighbour(w, g) |
                          _near_neighbour(w, w))).any(), what
    assert worst <= DEPTH_RTOL, (what, worst)
    return worst


@pytest.mark.parametrize("cascades", [1, 4])
def test_build_matches_jax(cascades):
    """Sun, spot and omni light with the alpha-cutout caster: 1 or 4
    cascades, a spot map and 6 cube faces, cam_pos off the centre."""
    opt_t = options("tauray_torch", shadow_map_cascades=cascades,
                    shadow_map_radius=2.0)
    opt_j = options("tauray_tpu", shadow_map_cascades=cascades,
                    shadow_map_radius=2.0)
    cam = np.array([-1.0, 2.0, 4.0], np.float32)
    mt, at = _build("tauray_torch", raster_scene("tauray_torch"), opt_t,
                    cam_pos=cam)
    mj, aj = _build("tauray_tpu", raster_scene("tauray_tpu"), opt_j,
                    cam_pos=cam)
    assert at.any_alpha_materials
    assert mt.depth.shape == (cascades + 1 + 6, 64, 64)
    np.testing.assert_array_equal(_np(mt.cascade_count)[:cascades],
                                  np.arange(cascades, 0, -1))
    hold_maps(mt, mj, f"cascades={cascades}")
    # the leaf card's cutout: its opaque disc shadows the floor, its
    # transparent corners do not (the spot map looks straight down at it)
    spot = _np(mt.depth)[cascades]
    assert (spot < 1.5).any() and (spot > 2.0).any()


def _to_torch_maps(m) -> tsm.ShadowMaps:
    return tsm.ShadowMaps(*(torch.from_numpy(np.array(x)) for x in m[:-1]),
                          resolution=m.resolution)


@pytest.fixture(scope="module")
def filter_case():
    """tauray_tpu's maps of the raster scene (4 cascades, 64^2) in both
    packages' types, and seeded points on and near its surfaces: floor
    points, points on the wall, some in the leaf's shadow, with their
    ndotl and pixel coordinates, and a map id per light."""
    opt = options("tauray_tpu", shadow_map_cascades=4, shadow_map_radius=1.0)
    mj, aj = _build("tauray_tpu", raster_scene("tauray_tpu"), opt)
    rng = np.random.default_rng(5)
    n = 512
    floor = np.stack([rng.uniform(-3, 3, n), np.zeros(n),
                      rng.uniform(-3, 3, n)], -1)
    wall = np.stack([np.full(n // 4, 1.5), rng.uniform(0, 3, n // 4),
                     rng.uniform(-3, 3, n // 4)], -1)
    pts = np.concatenate([floor, wall]).astype(np.float32)
    R = pts.shape[0]
    ndotl = rng.random(R).astype(np.float32)
    pix = rng.integers(0, 1920, (R, 2)).astype(np.int32)
    idx = _np(mj.light_index)
    ids = {"sun": np.zeros(R, np.int32),
           "spot": np.full(R, int(np.nonzero(idx == 0)[0][0]), np.int32),
           "cube": int(np.nonzero(idx == 1)[0][0]) + rng.integers(
               0, 6, R).astype(np.int32)}
    return mj, _to_torch_maps(mj), pts, ndotl, pix, ids


@pytest.mark.parametrize("light", ["sun", "spot", "cube"])
@pytest.mark.parametrize("pcf,pcss", [(0, 0), (16, 0), (64, 0), (16, 32),
                                      (64, 32)])
def test_pcf_visibility_matches_jax(filter_case, light, pcf, pcss):
    mj, mt, pts, ndotl, pix, ids = filter_case
    cascades = 4 if light == "sun" else 1
    res = {}
    for casc in sorted({1, cascades}):
        got = tsm.pcf_visibility(
            mt, torch.from_numpy(ids[light]), torch.from_numpy(pts), pcf,
            ndotl=torch.from_numpy(ndotl), screen_xy=torch.from_numpy(pix),
            pcss_samples=pcss, cascades=casc).numpy()
        want = np.asarray(jsm.pcf_visibility(
            mj, jnp.asarray(ids[light]), jnp.asarray(pts), pcf,
            ndotl=jnp.asarray(ndotl), screen_xy=jnp.asarray(pix),
            pcss_samples=pcss, cascades=casc))
        taps = max(min(pcf, 64), 1)
        off = np.abs(got - want) > 1e-5
        print(f"{light} pcf={pcf} pcss={pcss} cascades={casc}: "
              f"{int(off.sum())} of {off.size} points flip, largest "
              f"{np.abs(got - want).max():.4f}; shadowed "
              f"{(want < 1).mean():.3f}, mean {want.mean():.4f}")
        assert 1.0 - off.mean() >= PCF_SHARE, (light, casc, off.mean())
        if pcss == 0:
            assert np.abs(got - want).max() <= 2.0 / taps + 1e-5
        assert abs(got.mean() - want.mean()) <= 1e-3
        res[casc] = want
    # the points see both lit and shadowed taps
    assert (res[cascades] < 1).any() and (res[cascades] > 0).any()


def test_pcf_noise_texture_matches_jax(filter_case, tmp_path, monkeypatch):
    """The rotation from a noise texture (TAURAY_NOISE_2D), read by both
    packages from the same EXR."""
    from tauray_torch.io.exr import write
    mj, mt, pts, ndotl, pix, ids = filter_case
    rng = np.random.default_rng(9)
    ang = rng.random((8, 8)) * 2 * np.pi
    path = str(tmp_path / "noise.exr")
    write(path, {"R": np.cos(ang).astype(np.float32),
                 "G": np.sin(ang).astype(np.float32),
                 "B": np.zeros((8, 8), np.float32)}, compression="zip")
    monkeypatch.setenv("TAURAY_NOISE_2D", path)
    for mod in (tsm, jsm):
        monkeypatch.setattr(mod, "_NOISE_2D", None)
        monkeypatch.setattr(mod, "_NOISE_2D_TRIED", False)
    assert tsm._load_noise_2d()[1] == (8, 8)
    got = tsm.pcf_visibility(mt, torch.from_numpy(ids["sun"]),
                             torch.from_numpy(pts), 16,
                             ndotl=torch.from_numpy(ndotl),
                             screen_xy=torch.from_numpy(pix),
                             pcss_samples=0, cascades=4).numpy()
    want = np.asarray(jsm.pcf_visibility(
        mj, jnp.asarray(ids["sun"]), jnp.asarray(pts), 16,
        ndotl=jnp.asarray(ndotl), screen_xy=jnp.asarray(pix),
        pcss_samples=0, cascades=4))
    off = np.abs(got - want) > 1e-5
    assert 1.0 - off.mean() >= PCF_SHARE
    assert np.abs(got - want).max() <= 2.0 / 16 + 1e-5
    for mod in (tsm, jsm):
        monkeypatch.setattr(mod, "_NOISE_2D", None)
        monkeypatch.setattr(mod, "_NOISE_2D_TRIED", False)


# ---- the assertions of tests/test_shadow_maps.py, on a procedural scene ---

@pytest.fixture(scope="module")
def sponza_maps():
    """Both packages' maps of proc://sponza?tris=8192 with radius 2 at 128^2
    and 4 cascades, centred on the scene: most geometry is outside the
    base map, so shadowing there depends on the cascades."""
    import importlib
    out = {}
    for pkg in ("tauray_torch", "tauray_tpu"):
        opts = importlib.import_module(f"{pkg}.options")
        app = importlib.import_module(f"{pkg}.app.main")
        opt = opts.parse_command_line_options([
            "--renderer=raster", "--shadow-map-resolution=128",
            "--shadow-map-radius=2", "--shadow-map-cascades=4",
            "--headless=unused", "--filetype=none", SPONZA])
        s = app.load_scenes(opt)
        SA = importlib.import_module(f"{pkg}.scene.arrays").SceneArrays
        center = SA(s, opt).tri_pos.reshape(-1, 3).mean(axis=0)
        out[pkg] = _build(pkg, s, opt, center=center, cam_pos=center)
    hold_maps(out["tauray_torch"][0], out["tauray_tpu"][0], "sponza")
    return out


def _vis(pkg, maps, pts, cascades):
    sm = tsm if pkg == "tauray_torch" else jsm
    arr = torch.from_numpy if pkg == "tauray_torch" else jnp.asarray
    n = pts.shape[0]
    return _np(sm.pcf_visibility(maps, arr(np.zeros(n, np.int32)),
                                 arr(pts), 16,
                                 ndotl=arr(np.ones(n, np.float32)),
                                 cascades=cascades))


@pytest.mark.parametrize("pkg", ["tauray_torch", "tauray_tpu"])
def test_cascade_layout(sponza_maps, pkg):
    maps, arrays = sponza_maps[pkg]
    casc = _np(maps.cascade_count)
    rx = _np(maps.params)[:, 0]
    assert arrays.dir_count >= 1
    # 4 layers with doubling extents and descending remaining counts
    assert list(casc[:4]) == [4, 3, 2, 1]
    assert np.allclose(rx[:4], [2.0, 4.0, 8.0, 16.0])
    # bias scales with sqrt(2^k) (reference scene_stage.cc:559)
    mb = _np(maps.max_bias)[:4]
    assert np.allclose(mb / mb[0], np.sqrt([1, 2, 4, 8]), rtol=1e-5)


@pytest.mark.parametrize("pkg", ["tauray_torch", "tauray_tpu"])
def test_find_cascade_recovers_out_of_base_points(sponza_maps, pkg):
    """Occluded points outside the base map are lit without cascades (out
    of range, so no shadow) and shadowed with them."""
    maps, _ = sponza_maps[pkg]
    D = _np(maps.depth)
    far = float(_np(maps.params)[0, 3])
    k = 2                                 # the rx = 8 cascade
    res = maps.resolution
    inv = np.linalg.inv(_np(maps.view)[k])
    rx = float(_np(maps.params)[k, 0])
    js, iis = np.nonzero(D[k] < far - 1)
    xs = ((iis + 0.5) / res * 2 - 1) * rx
    ys = -(((js + 0.5) / res * 2 - 1) * rx)
    m = np.abs(xs) > 2.8                  # outside the base map (rx 2)
    assert m.sum() > 100
    idx = np.nonzero(m)[0][::max(int(m.sum()) // 8, 1)][:8]
    pts = np.stack([np.array([xs[i], ys[i], -(D[k, js[i], iis[i]] + 0.5)],
                             np.float32) @ inv[:3, :3].T + inv[:3, 3]
                    for i in idx]).astype(np.float32)
    v4 = _vis(pkg, maps, pts, 4)
    v1 = _vis(pkg, maps, pts, 1)
    assert np.all(v1 == 1.0), v1          # the base map cannot see them
    assert np.all(v4 < 0.95), v4          # the cascades shadow them
    assert v4.mean() < 0.6, v4


@pytest.mark.parametrize("pkg", ["tauray_torch", "tauray_tpu"])
def test_in_base_points_identical_with_and_without_cascades(sponza_maps,
                                                            pkg):
    """Points inside the base map (with margin) never switch layers."""
    maps, _ = sponza_maps[pkg]
    inv = np.linalg.inv(_np(maps.view)[0])
    rng = np.random.default_rng(0)
    lx = (rng.random((16, 2), np.float32) - 0.5) * 2.4   # |x|,|y| < 1.2
    pts = np.stack([np.array([x, y, -50.0], np.float32) @ inv[:3, :3].T +
                    inv[:3, 3] for x, y in lx]).astype(np.float32)
    v4 = _vis(pkg, maps, pts, 4)
    v1 = _vis(pkg, maps, pts, 1)
    assert np.allclose(v4, v1)
