"""tauray_torch.stages.looking_glass against tauray_tpu's, and the CLI's
--display=looking-glass.

setup_lkg_cameras' cameras give equal camera uniforms; compose_quilt is a
gather, equal bit for bit. lkg_compose is a gather too, but the view,
column and row it reads are picked by float32 arithmetic that XLA:CPU
compiles with fused multiply-adds: the test decodes which texel each subpixel
read in both packages, requires the same texel on all but 1% (0.02% at
the defaults, 0.26% with the image flipped), and every other one to be a
neighbour (the next view,
wrapping, the next column or row) whose pick lies within rounding of
its boundary."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauray_torch.stages import looking_glass as T
from tauray_tpu.stages import looking_glass as J

torch.set_num_threads(2)

CPU = torch.device("cpu")
SPONZA = "proc://sponza?tris=8192"


def _lkg_scene(pkg, n):
    main = __import__(f"{pkg}.app.main", fromlist=["x"])
    opts = __import__(f"{pkg}.options", fromlist=["x"])
    opt = opts.parse_command_line_options([
        "--width=16", "--height=16", f"--lkg-params.viewports={n}",
        "--lkg-params.midplane=1.5", "--lkg-calibration.viewCone=35",
        SPONZA])
    s = main.load_scenes(opt)
    base = next(e for e in s.entities
                if e.camera is not None and e.camera_enabled)
    views = __import__(f"{pkg}.stages.looking_glass",
                       fromlist=["x"]).setup_lkg_cameras(s, base, opt)
    return opt, s, views


@pytest.mark.parametrize("n", [1, 5, 48])
def test_lkg_cameras_match_jax(n):
    """The arc's cameras: the same count and order, and equal camera
    uniforms (view, projection, pan) from each package's SceneArrays."""
    from tauray_torch.scene.arrays import SceneArrays as TA
    from tauray_tpu.scene.arrays import SceneArrays as JA
    out = []
    for pkg, A in (("tauray_torch", TA), ("tauray_tpu", JA)):
        opt, s, views = _lkg_scene(pkg, n)
        assert len(views) == n
        enabled = [e for e in s.entities
                   if e.camera is not None and e.camera_enabled]
        assert enabled == views
        vps = [(e.camera, e.transform) for e in views]
        out.append(A(s, opt).camera_uniforms(vps))
    t, j = out
    assert t.keys() == j.keys()
    for k in t:
        np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]),
                                      err_msg=k)


@pytest.mark.parametrize("V,cols", [(45, 0), (45, 5), (7, 0), (1, 0)])
def test_compose_quilt_matches_jax(V, cols):
    views = np.random.default_rng(V + cols).random((V, 6, 10, 4),
                                                   dtype=np.float32)
    got = T.compose_quilt(torch.from_numpy(views), cols).numpy()
    want = np.asarray(J.compose_quilt(jnp.asarray(views), cols))
    np.testing.assert_array_equal(got, want)


def _texel_views(V, H, W):
    """Views whose every texel holds its own index (exact in float32),
    so an output subpixel names the (view, row, column) it read."""
    idx = np.arange(V * H * W, dtype=np.float32).reshape(V, H, W, 1)
    return np.repeat(idx, 3, axis=-1)


@pytest.mark.parametrize("flags", [
    dict(), dict(inv_view=0), dict(flip_x=1, flip_y=1, flip_subp=1)],
    ids=["default", "no_inv", "flipped"])
def test_lkg_compose_matches_jax(flags):
    """The default calibration's 1536x2048 screen over 45 views of 64x48:
    the texel each subpixel reads, in both packages."""
    V, H, W = 45, 64, 48
    cal = T.LKGCalibration()
    sw, sh = cal.screenW, cal.screenH
    views = _texel_views(V, H, W)
    args = (cal.pitch, cal.slope, cal.center, sw, sh, V)
    got = T.lkg_compose(torch.from_numpy(views), *args, **flags).numpy()
    want = np.asarray(J.lkg_compose(jnp.asarray(views), *args, **flags))
    assert got.shape == want.shape == (sh, sw, 3)
    off = got != want
    share = float(off.mean())
    print(f"{flags}: {int(off.sum())} of {off.size} subpixels read "
          f"another texel ({share:.2e})")
    assert share <= 1e-2
    g = got[off].astype(np.int64)
    w = want[off].astype(np.int64)
    gv, gy, gx = g // (H * W), g // W % H, g % W
    wv, wy, wx = w // (H * W), w // W % H, w % W
    dv, dy, dx = np.abs(gv - wv), np.abs(gy - wy), np.abs(gx - wx)
    # each pick that differs is a neighbour, within rounding of the
    # boundary between the two, in exact arithmetic
    ys, xs, sub = np.nonzero(off)
    u = xs / sw
    v = ys / sh
    if flags.get("flip_x"):
        u = 1.0 - u
    if flags.get("flip_y"):
        v = 1.0 - v
    s = np.where(flags.get("flip_subp", 0), 2 - sub, sub)
    pitch, slope, center = (np.float64(np.float32(x))
                            for x in (cal.pitch, cal.slope, cal.center))
    a = (u + s / (3.0 * sw) + v * slope) * pitch - center
    # the float32 rounding of the unwrapped phase: 16 ulps of its largest
    # terms (u and v up to 1, flipped or not)
    tol = 16 * 2.0 ** -24 * ((1 + 1 / sw + abs(slope)) * pitch +
                             abs(center))
    a = a - np.floor(a)
    if flags.get("inv_view", 1):
        a = 1.0 - a
    view_edge = np.minimum(np.abs(a * V - np.round(a * V)) / V,
                           np.abs(a - np.round(a))) <= tol
    cell = 16 * 2.0 ** -24
    x_edge = np.abs(u * W - np.round(u * W)) <= cell * W
    y_edge = np.abs((1 - v) * H - np.round((1 - v) * H)) <= cell * H
    assert ((dv == 0) | (((dv == 1) | (dv == V - 1)) & view_edge)).all()
    assert ((dx == 0) | ((dx == 1) & x_edge)).all()
    assert ((dy == 0) | ((dy == 1) & y_edge)).all()


def test_cli_looking_glass_writes_each_view(tmp_path):
    """--display=looking-glass --headless: the CLI's display setup puts
    lkg-params.viewports cameras in the scene and the replay loop writes
    one image per view, not the one scene camera. tauray_tpu's headless
    output counts the camera grid only, so its views all go to one file
    name."""
    from tauray_torch.app.main import (load_scenes, replay_viewer,
                                       setup_display)
    from tauray_torch.options import parse_command_line_options
    prefix = str(tmp_path / "lkg")
    opt = parse_command_line_options([
        "--display=looking-glass", f"--headless={prefix}",
        "--lkg-params.viewports=3", "--width=8", "--height=8",
        "--samples-per-pixel=1", "--max-ray-depth=2", "--filetype=exr",
        "--compression=zip", SPONZA])
    s = load_scenes(opt)
    setup_display(opt, s)
    replay_viewer(opt, s, CPU)
    files = sorted(os.listdir(tmp_path))
    assert files == ["lkg0_.exr", "lkg1_.exr", "lkg2_.exr"], files
    from tauray_torch.io.exr import read_rgb
    imgs = [read_rgb(str(tmp_path / f)) for f in files]
    assert all(i.shape[:2] == (8, 8) and i[..., :3].mean() > 0
               for i in imgs)
    # tauray_tpu's HeadlessOutput as its replay loop builds it for the
    # same run (display count camera_grid.w * h = 1): one file for 3 views
    from tauray_tpu.app.headless import HeadlessOutput
    jdir = tmp_path / "jax"
    opt.headless = str(jdir / "lkg")
    out = HeadlessOutput(opt, (8, 8), opt.camera_grid.w * opt.camera_grid.h)
    out.save_frame(np.stack(imgs).astype(np.float32))
    out.finish()
    assert os.listdir(jdir) == ["lkg.exr"]
