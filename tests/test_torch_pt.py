"""The slice end to end on the CPU: tauray_torch's PathTracerRenderer
against tauray_tpu's on the same scene and seeds, an analytic radiance
check, and a headless run through the port's replay loop."""

import os

import numpy as np
import pytest
import torch

from tauray_torch.options import Options as TOptions
from tauray_torch.renderer.rt_renderer import PathTracerRenderer

from test_torch_scene import floor_scene

# the tests run in several worker processes at once: keep torch's
# intra-op pool small so they do not oversubscribe the cores
torch.set_num_threads(2)

CPU = torch.device("cpu")
SPONZA = "proc://sponza?tris=8192"


def _opt(cls, **kw):
    opt = cls()
    opt.width = opt.height = 16
    opt.samples_per_pixel = 2
    opt.max_ray_depth = 3
    opt.tonemap = "linear"
    for k, v in kw.items():
        setattr(opt, k, v)
    return opt


def _render_port(scene, **kw):
    rr = PathTracerRenderer(_opt(TOptions, **kw), CPU)
    rr.set_scene(scene)
    return rr.render()[0]


def test_sponza_image_matches_jax():
    """16x16, 2 spp, depth 3, linear tonemap. The JAX renderer is used
    directly: conftest's 8 fake devices would route create_renderer to the
    distributed renderer. Criterion: >= 99% of pixels within 1e-3
    relative and the image mean within 0.1%."""
    from tauray_tpu.io.gltf import load_scene as jload
    from tauray_tpu.options import Options as JOptions
    from tauray_tpu.renderer.rt_renderer import PathTracerRenderer as JPT
    from tauray_tpu.scene.scene import Scene as JScene
    from tauray_torch.io.gltf import load_scene as tload
    from tauray_torch.scene.scene import Scene as TScene
    js, ts = JScene(), TScene()
    jload(SPONZA, js)
    tload(SPONZA, ts)
    jr = JPT(_opt(JOptions))
    jr.set_scene(js)
    want = jr.render()[0][..., :3]
    got = _render_port(ts)[..., :3]
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    within = float((rel.max(axis=-1) <= 1e-3).mean())
    mean_rel = abs(float(got.mean()) / float(want.mean()) - 1.0)
    print(f"pixels within 1e-3: {within:.4f}; image mean port "
          f"{got.mean():.6f} jax {want.mean():.6f} (rel {mean_rel:.2e}); "
          f"max pixel rel {rel.max():.2e}")
    assert np.isfinite(got).all() and got.mean() > 0
    assert within >= 0.99
    assert mean_rel <= 1e-3


def test_lambertian_direct_lighting():
    """A Lambertian floor under a delta sun straight down reflects
    L * albedo / pi (tests/test_pt_radiance.py's analytic check)."""
    img = _render_port(floor_scene("tauray_torch"), width=8, height=8,
                       samples_per_pixel=4, max_ray_depth=2)
    expected = 2.0 * 0.8 / np.pi
    got = float(img[..., :3].mean())
    assert abs(got - expected) / expected < 0.05, (got, expected)


def test_emissive_floor_seen_directly():
    """Directly viewed emission appears exactly once; the floor is a
    triangle light, so this drives the emissive-triangle NEE branch."""
    import importlib
    s = floor_scene("tauray_torch")
    s.entities[1].light = None
    mat = importlib.import_module("tauray_torch.scene.material")
    s.entities[0].model.groups[0].mat = mat.Material(
        albedo_factor=np.array([0, 0, 0, 1], np.float32),
        emission_factor=np.array([1.5, 1.5, 1.5], np.float32),
        double_sided=True, metallic_factor=0.0)
    img = _render_port(s, width=8, height=8, samples_per_pixel=4,
                       max_ray_depth=2, sample_emissive_triangles=1.0)
    got = float(img[..., :3].mean())
    assert abs(got - 1.5) / 1.5 < 0.05, got


def test_headless_replay_writes_exr(tmp_path):
    """The port's replay loop on the CPU: parse the CLI grammar, load the
    scene, render two frames and write them as EXR. Read back, both equal
    a direct render of the same loaded scene (static scene, no
    accumulation) to half precision (the default --format=rgb16)."""
    from tauray_torch.app.main import load_scenes, replay_viewer
    from tauray_torch.io.exr import read_rgb
    from tauray_torch.options import parse_command_line_options
    prefix = os.path.join(tmp_path, "f")
    opt = parse_command_line_options([
        f"--headless={prefix}", "--width=16", "--height=8",
        "--samples-per-pixel=2", "--max-ray-depth=2", "--tonemap=linear",
        "--frames=2", SPONZA])
    replay_viewer(opt, load_scenes(opt), CPU)
    rr = PathTracerRenderer(opt, CPU)
    rr.set_scene(load_scenes(opt))
    want = rr.render()[0][..., :3]
    assert want.mean() > 0
    for frame in (0, 1):
        img = read_rgb(f"{prefix}{frame}.exr")
        assert img.shape[:2] == (8, 16)
        np.testing.assert_allclose(img[..., :3], want, rtol=2e-3, atol=1e-4)


def test_main_requires_cuda():
    from tauray_torch.app.main import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--headless=/nonexistent/x", SPONZA])


def test_bench_requires_cuda():
    from tauray_torch.app.bench import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--cells=headline"])


@pytest.mark.parametrize("args", [
    ["--denoiser=svgf"], ["--denoiser=bmfr"], ["--taa=8"],
    ["--temporal-reprojection=0.5"], ["--renderer=albedo"],
    ["--fake-devices=2", "--camera-grid=2,1,0.1,0.1",
     "--spatial-reprojection=0"], ["--renderer=whitted"],
    ["--renderer=restir"], ["--preset=restir-hybrid"],
    ["--renderer=raster", "--shadow-map-resolution=32", "--pcf=4",
     "--pcss=4"],
    ["--renderer=dshgi", "--shadow-map-resolution=32", "--pcf=4",
     "--pcss=4"],
    ["--preset=ddish-gi", "--shadow-map-resolution=32"],
    # the multi-device forms: on one device the bake is not sharded and
    # the path tracer runs its workloads on it
    ["--renderer=dshgi", "--mesh-shape=2", "--shadow-map-resolution=32",
     "--pcf=4", "--pcss=4"],
    ["--renderer=restir-hybrid", "--fake-devices=2"],
    ["--renderer=dshgi-server", "--fake-devices=2"],
    ["--mesh-shape=2"],
    ["--renderer=dshgi", "--fake-devices=2", "--shadow-map-resolution=32",
     "--pcf=4", "--pcss=4"],
    ["--fake-devices=2"]])
def test_ported_features_render(args):
    """What this slice ported renders through the CLI's renderer choice
    (two frames, the second after update_frame): a finite image of the
    right shape, no NotImplementedError."""
    from tauray_torch.app.main import (create_renderer, generate_cameras,
                                       load_scenes)
    from tauray_torch.options import parse_command_line_options
    server = "--renderer=dshgi-server" in args
    if server:
        args = args + [f"--port={_free_port()}"]
    opt = parse_command_line_options(args + [
        "--width=16", "--height=8", "--samples-per-pixel=1",
        "--max-ray-depth=2", SPONZA])
    s = load_scenes(opt)
    generate_cameras(s, opt)
    rr = create_renderer(opt, s, CPU)
    rr.set_scene(s)
    try:
        for k in range(2):
            if k:
                rr.update_frame()
            rr.reset_accumulation()
            img = rr.render_device().cpu().numpy()
    finally:
        if server:
            rr.transport.close()
    if server:
        # the probe server draws nothing: a (1, 1, 1, 4) placeholder
        assert img.shape == (1, 1, 1, 4)
        return
    views = opt.camera_grid.w * opt.camera_grid.h
    assert img.shape == (views, 8, 16, 4)
    if opt.renderer in ("path-tracer", "whitted", "restir",
                        "restir-hybrid", "raster", "dshgi"):
        assert np.isfinite(img).all() and img[..., :3].mean() > 0
    for v in range(views):
        assert img[v, ..., :3].max() > 0, v


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def test_wave_stats_requires_cuda():
    from tauray_torch.app.wave_stats import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main()


def test_whitted_equals_path_tracer():
    """--renderer=whitted is the path tracer with direct_only off, as in
    tauray_tpu: at 8x8 its image equals --renderer=path-tracer's with the
    same options and seeds."""
    from tauray_torch.app.main import create_renderer, load_scenes
    from tauray_torch.options import parse_command_line_options
    imgs = []
    for r in ("whitted", "path-tracer"):
        opt = parse_command_line_options([
            f"--renderer={r}", "--width=8", "--height=8",
            "--samples-per-pixel=2", "--max-ray-depth=3", "--tonemap=linear",
            SPONZA])
        s = load_scenes(opt)
        rr = create_renderer(opt, s, CPU)
        rr.set_scene(s)
        imgs.append(rr.render())
    assert imgs[0][..., :3].mean() > 0
    np.testing.assert_array_equal(imgs[0], imgs[1])
