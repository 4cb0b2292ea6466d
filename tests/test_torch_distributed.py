"""tauray_torch's DistributedPathTracerRenderer over [cpu] * 8 against
tauray_tpu's on conftest's 8 virtual CPU devices, and the probe-sharded
SH bake against tauray_tpu's mesh bake.

Both packages render proc://sponza?tris=8192 at 16x16 to 32x32, depth 2,
with the same options and seeds. Against tauray_tpu an image meets
tests/test_torch_pt.py's rule for the single-device port: at least 99%
of the pixels within 1e-3 relative, the mean within 1e-3 (a ray through
a triangle edge may hit in one package and miss in the other). Against
the port's own single-device frame the distributed one agrees within
1e-5: hits are per ray, whatever the tiles, and only the rounding of the
CPU's vectorised loops, which depends on a ray's place in its wave,
differs (measured: at most 1.2e-7). The port renders every pixel of
every share, so where tauray_tpu's static per-device budget drops pixels
(the over-cap fault, ROADMAP) the port is held to the single-device image
and to tauray_tpu only where tauray_tpu rendered."""

import numpy as np
import pytest
import torch

import jax

torch.set_num_threads(2)

CPU = torch.device("cpu")
SPONZA = "proc://sponza?tris=8192"
TOL = 1e-3


def _opt(pkg, args, size=16):
    mod = __import__(f"{pkg}.options", fromlist=["x"])
    return mod.parse_command_line_options([
        f"--width={size}", f"--height={size}", "--max-ray-depth=2",
        "--tonemap=linear", "--samples-per-pixel=1"] + list(args) + [
        "--headless=unused", "--filetype=none", SPONZA])


def _scene(pkg, opt):
    main = __import__(f"{pkg}.app.main", fromlist=["x"])
    s = main.load_scenes(opt)
    main.generate_cameras(s, opt)
    return s


def pair(args=(), size=16, devices=8):
    """(port, tauray_tpu) DistributedPathTracerRenderer with the scene
    set; the port over [cpu] * devices."""
    from tauray_torch.renderer.distributed import \
        DistributedPathTracerRenderer as T
    from tauray_tpu.renderer.distributed import \
        DistributedPathTracerRenderer as J
    t = T(_opt("tauray_torch", args, size), CPU, devices=[CPU] * devices)
    t.set_scene(_scene("tauray_torch", t.opt))
    j = J(_opt("tauray_tpu", args, size))
    j.set_scene(_scene("tauray_tpu", j.opt))
    return t, j


def single(args=(), size=16):
    """The port's single-device render of the same frame."""
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer
    opt = _opt("tauray_torch", args, size)
    rr = PathTracerRenderer(opt, CPU)
    rr.set_scene(_scene("tauray_torch", opt))
    return rr.render()


def _like_jax(got, want, tag):
    """tests/test_torch_pt.py's rule, over every view's RGB."""
    assert got.shape == want.shape, tag
    got, want = got[..., :3], want[..., :3]
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    within = float((rel.max(axis=-1) <= TOL).mean())
    mean_rel = abs(float(got.mean()) / float(want.mean()) - 1.0)
    print(f"{tag}: pixels within 1e-3 {within:.4f}, mean rel "
          f"{mean_rel:.2e}, max |diff| {np.abs(got - want).max():.3e}")
    assert np.isfinite(got).all() and got.mean() > 0
    assert within >= 0.99 and mean_rel <= TOL, tag


def _same(got, want, tag):
    assert got.shape == want.shape, tag
    print(f"{tag}: max |diff| {np.abs(got - want).max():.3e}")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=tag)


def test_jax_mesh_has_eight_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("args", [
    ["--distribution-strategy=shuffled-strips"],
    ["--distribution-strategy=scanline"],
    ["--fake-devices=2"],
    ["--workload=3,1,1,0.5,2"]],
    ids=["shuffled", "scanline", "fake2", "workload"])
def test_distributed_matches_jax(args):
    """One frame: the same workloads and params as tauray_tpu, the image
    held to tauray_tpu's and equal to the port's single-device frame."""
    t, j = pair(args)
    assert t.n_devices == j.n_devices
    assert t.strategy == j.strategy and not t.view_sharded
    np.testing.assert_allclose(t.workloads, j.workloads, rtol=1e-12)
    assert [p.__dict__ for p in t.dist_params] == \
        [p.__dict__ for p in j.dist_params]
    got = t.render()
    _like_jax(got, np.asarray(j.render()), f"{args} against tauray_tpu")
    _same(got, single(), f"{args} against one device")


def test_duplicate_on_one_device():
    """One device and no fake workloads: DUPLICATE is forced, whatever
    --distribution-strategy says, as in tauray_tpu."""
    from tauray_torch.renderer.distributed import \
        DistributedPathTracerRenderer as T
    opt = _opt("tauray_torch", ["--mesh-shape=1"])
    t = T(opt, CPU)
    t.set_scene(_scene("tauray_torch", opt))
    assert t.devices == [CPU] and t.strategy == "duplicate"
    _same(t.render(), single(), "duplicate")


def test_rebalance_then_second_frame():
    """Frame 1, skewed times into the LoadBalancer, frame 2 (without
    accumulation: a fresh frame over the new shares; with accumulation:
    blended into frame 1 with 1/(frames + 1)): the same shares and images
    as tauray_tpu's, every pixel covered."""
    from tauray_torch.parallel.load_balancer import LoadBalancer as TLB
    from tauray_tpu.parallel.load_balancer import LoadBalancer as JLB
    for acc in ([], ["--accumulation"]):
        t, j = pair(acc)
        t.render()
        j.render()
        times = [0.3] + [0.1] * 7
        TLB(8).update(t, times)
        JLB(8).update(j, times)
        np.testing.assert_allclose(t.workloads, j.workloads, rtol=1e-12)
        assert t.workloads[0] < 1 / 8
        assert t._stitch_blend == j._stitch_blend
        t.reset_accumulation()
        j.reset_accumulation()
        got = t.render()
        _like_jax(got, np.asarray(j.render()), f"rebalanced {acc}")
        assert (got[..., 3] > 0).all()
        if not acc:
            _same(got, single(), "rebalanced against one device")


def test_over_cap_share_renders_every_pixel():
    """A share past tauray_tpu's static budget (0.9 on device 0 of 8 at
    32x32; the cap is 512 of its 922 pixels): tauray_tpu leaves 40.0% of
    the frame black, the port renders it all, equal to one device; where
    tauray_tpu rendered, the two agree."""
    t, j = pair(size=32)
    w = [0.9] + [0.1 / 7] * 7
    t.set_device_workloads(w)
    j.set_device_workloads(w)
    got, want = t.render(), np.asarray(j.render())
    dropped = (want[0] == 0).all(-1)
    assert round(float(dropped.mean()), 3) == 0.400
    assert (got[0, ..., 3] > 0).all()
    _same(got, single(size=32), "over cap against one device")
    _like_jax(got[0][~dropped], want[0][~dropped], "over cap where rendered")


def test_view_sharded_grid_matches_jax():
    """An 8-view camera grid over 8 devices shards the views in both
    packages; the views held to tauray_tpu's and equal to the port's
    single-device render."""
    args = ["--camera-grid=4,2,0.05,0.05",
            "--distribution-strategy=shuffled-strips"]
    t, j = pair(args)
    assert t.view_sharded and j.view_sharded
    got = t.render()
    assert got.shape == (8, 16, 16, 4)
    _like_jax(got, np.asarray(j.render()), "view-sharded against tauray_tpu")
    _same(got, single(args), "view-sharded against one device")


def test_denoiser_ignored_with_fake_devices():
    """tauray_tpu's distributed render_device returns the tonemapped
    stitch: --denoiser=svgf with --fake-devices changes nothing in the
    port, and tauray_tpu's frame is held to the port's frame without a
    denoiser (ROADMAP, quirks of the reference)."""
    from tauray_torch.renderer.distributed import \
        DistributedPathTracerRenderer as T
    t, j = pair(["--fake-devices=2", "--denoiser=svgf"])
    assert t.use_post and j.use_post
    t0 = T(_opt("tauray_torch", ["--fake-devices=2"]), CPU,
           devices=[CPU] * 8)
    t0.set_scene(_scene("tauray_torch", t0.opt))
    got, plain = t.render(), t0.render()
    np.testing.assert_array_equal(got, plain)
    _like_jax(plain, np.asarray(j.render()), "tauray_tpu's, denoiser on")


def test_accumulation_and_checkpoint(tmp_path):
    """Two frames accumulate into the (V, H, W, 4) stitch as a running
    mean; a checkpoint saved after frame 1 and loaded into a new renderer
    gives frame 2 again; reset_accumulation drops it without
    --accumulation."""
    from tauray_torch.renderer.distributed import \
        DistributedPathTracerRenderer as T

    def make(args):
        r = T(_opt("tauray_torch", args), CPU, devices=[CPU] * 8)
        r.set_scene(_scene("tauray_torch", r.opt))
        return r
    t = make(["--fake-devices=2", "--accumulation"])
    f1 = t.render()
    path = str(tmp_path / "acc.npz")
    t.save_checkpoint(path)
    f2 = t.render()
    assert t.samples_accumulated == 2 and t.accum_color.shape == \
        (1, 16, 16, 4)
    assert np.abs(f2 - f1).max() > 0
    r = make(["--fake-devices=2", "--accumulation"])
    assert r.load_checkpoint(path) and r.samples_accumulated == 1
    np.testing.assert_array_equal(r.render(), f2)
    t2 = make(["--fake-devices=2"])
    t2.render()
    t2.reset_accumulation()
    assert t2.accum_color is None and t2.samples_accumulated == 0


def test_probe_sharded_bake_matches_jax():
    """The SH bake of the room's 2x2x2 grid sharded over [cpu] * 3 (8
    probes padded to 9 with probe 0) against tauray_tpu's bake sharded
    over its 8-device mesh, and against the port's one-device bake:
    within 1e-5 of the largest coefficient (tests/test_torch_sh.py's
    bound), 3 frames."""
    from tauray_tpu.parallel.mesh import make_mesh
    from test_torch_restir import renderers
    from test_torch_sh import BAKE_TOL, _grid_room
    t, j = renderers(_grid_room, hybrid=True, max_ray_depth=2,
                     samples_per_probe=64)
    j.sh_source.mesh = make_mesh("")
    assert t.sh_source.devices is None
    t.sh_source.devices = [CPU] * 3
    # the one-device bake on its own copy of the room: a grid keeps its
    # coefficients between steps
    from tauray_torch.renderer.restir_renderer import ReSTIRRenderer
    one = ReSTIRRenderer(t.opt, CPU, hybrid=True)
    one.set_scene(_grid_room("tauray_torch"))
    for k in range(3):
        t.sh_source.step(t)
        j.sh_source.step(j)
        one.sh_source.step(one)
        got = t.sh_source.current_grid_data()[0].numpy()
        want = np.asarray(j.sh_source.current_grid_data()[0])
        base = one.sh_source.current_grid_data()[0].numpy()
        scale = float(np.abs(want).max())
        for other, tag in ((want, "tauray_tpu"), (base, "one device")):
            err = float(np.abs(got - other).max()) / scale
            print(f"bake frame {k} against {tag}: {err:.3e}")
            assert got.shape == other.shape and err <= BAKE_TOL, (k, tag)
