"""Hand-written CUDA kernels against their plain torch versions, on the
card. Every test here needs a CUDA device and skips without one."""

import numpy as np
import pytest
import torch

from tauray_torch.app.kernel_waves import (tie_rays, tie_stack,
                                           tie_stack_instanced)
from tauray_torch.ops.trace_kernel import BW_WARPS

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _soup_tracer(device, seed=0, T=4000):
    from tauray_torch.ops.cluster import build_cluster_tracer
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-4, 4, (T, 3)).astype(np.float32)
    tri = (v0[:, None] + rng.normal(0, 0.7, (T, 3, 3))).astype(np.float32)
    tracer, _ = build_cluster_tracer(tri, np.zeros(T, np.int32),
                                     strategy="per-material", device=device)
    return tracer, rng


def test_trace_vm3_matches_plain_version(cuda):
    """ids identical and t bit-identical: the kernel is built with
    -fmad=false and rounds like the unfused torch ops."""
    from tauray_torch.ops.cluster import _phase1, _sig_sort_perm
    from tauray_torch.ops.trace_kernel import (LAUNCHES, trace_tiles_vm3,
                                               trace_tiles_vm3_reference)
    tracer, rng = _soup_tracer(cuda)
    R = 1 << 15
    o = rng.uniform(-6, 6, (R, 3)).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(R) < 0.2, 3.0, np.inf).astype(np.float32)
    rays8 = torch.from_numpy(np.concatenate(
        [o, d, np.zeros((R, 1), np.float32), tmax[:, None]], 1)).to(cuda)
    for sort in (False, True):
        r8 = rays8[_sig_sort_perm(tracer, rays8)] if sort else rays8
        counts, keys = _phase1(tracer, r8.contiguous())
        r3 = r8.reshape(-1, 32, 8).contiguous()
        before = LAUNCHES["trace_vm3"]
        t, tid = trace_tiles_vm3(counts, keys, r3, tracer.tris12)
        torch.cuda.synchronize()
        assert LAUNCHES["trace_vm3"] == before + 1
        tr, idr = trace_tiles_vm3_reference(counts, keys, r3, tracer.tris12)
        assert torch.equal(tid, idr)
        assert torch.equal(t.view(torch.int32), tr.view(torch.int32))
        assert (tid >= 0).any() and (tid < 0).any()


def test_trace_vm3_rejects_bad_inputs(cuda):
    from tauray_torch.ops.trace_kernel import trace_tiles_vm3
    tracer, _ = _soup_tracer(cuda, T=300)
    counts = torch.zeros(4, dtype=torch.int32, device=cuda)
    keys = torch.zeros((4, tracer.n_clusters), dtype=torch.int32,
                       device=cuda)
    rays = torch.zeros((4, 32, 8), device=cuda)
    with pytest.raises(ValueError):
        trace_tiles_vm3(counts.long(), keys, rays, tracer.tris12)
    with pytest.raises(ValueError):
        trace_tiles_vm3(counts, keys, rays[:, :16], tracer.tris12)
    t, tid = trace_tiles_vm3(counts, keys, rays, tracer.tris12)
    assert (tid == -1).all() and torch.isinf(t).all()


def test_render_goes_through_kernel(cuda):
    """A small render on the card launches the kernel and matches the
    same render on the CPU (the CPU runs the plain version)."""
    from tauray_torch.io.gltf import load_scene
    from tauray_torch.ops.trace_kernel import LAUNCHES, reset_launch_counts
    from tauray_torch.options import Options
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer
    from tauray_torch.scene.scene import Scene
    imgs = []
    for dev in (cuda, torch.device("cpu")):
        opt = Options()
        opt.width = opt.height = 32
        opt.samples_per_pixel = 2
        opt.max_ray_depth = 3
        opt.tonemap = "linear"
        s = Scene()
        load_scene("proc://sponza?tris=8192", s)
        rr = PathTracerRenderer(opt, dev)
        rr.set_scene(s)
        reset_launch_counts()
        imgs.append(rr.render()[0])
        if dev.type == "cuda":
            assert LAUNCHES["trace_vm3"] > 0
    a, b = imgs
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-6)
    assert (rel.max(-1) <= 1e-3).mean() >= 0.99


def _mt_waves(tracer, device, seed, R=1 << 14):
    """(rays8, counts, keys, idmask) for an unsorted and a signature-sorted
    wave of random rays, t_max finite for a fifth of them."""
    from tauray_torch.ops.cluster import _phase1_entry, _sig_sort_perm
    rng = np.random.default_rng(seed)
    lo = tracer.cmin.amin(0).cpu().numpy()
    hi = tracer.cmax.amax(0).cpu().numpy()
    o = rng.uniform(lo, hi, (R, 3)).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.where(rng.random(R) < 0.2, 3.0, np.inf).astype(np.float32)
    rays8 = torch.from_numpy(np.concatenate(
        [o, d, np.zeros((R, 1), np.float32), tmax[:, None]], 1)).to(device)
    for sort in (False, True):
        r8 = (rays8[_sig_sort_perm(tracer, rays8)] if sort
              else rays8).contiguous()
        counts, keys, idmask = _phase1_entry(tracer.cmin, tracer.cmax, r8)
        yield sort, r8.reshape(-1, 32, 8), counts, keys, idmask


def _instanced(device):
    from tauray_torch.ops.cluster import build_instanced_tracer
    rng = np.random.default_rng(3)
    mesh = (rng.random((600, 1, 3)) - 0.5 +
            rng.random((600, 3, 3)) * 0.2).astype(np.float32)
    n = 40
    models = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    models[:, :3, :3] *= rng.uniform(0.5, 1.5, (n, 1, 1))
    models[:, :3, 3] = rng.uniform(-6, 6, (n, 3))
    return build_instanced_tracer([mesh], np.zeros(n, np.int64), models,
                                  np.arange(n) % 4 != 1,
                                  np.arange(n, dtype=np.int64) * 600,
                                  device=device)


@pytest.mark.parametrize("kind", ["trace_mt", "trace_mt_inst"])
def test_trace_mt_matches_plain_version(cuda, kind):
    """K2 / K3 against their plain versions on sorted and unsorted waves,
    closest hit and any hit: ids identical, t bit-identical."""
    from tauray_torch.ops import trace_kernel as tk
    if kind == "trace_mt":
        tracer, _ = _soup_tracer(cuda)
        tracer.opaque[::3] = 0
        tables = (tracer.tris9, tracer.opaque)
        kern, ref = tk.trace_tiles, tk.trace_tiles_reference
    else:
        tracer = _instanced(cuda)
        tables = (tracer.tris9, tracer.opaque, tracer.k_cluster,
                  tracer.k_inst, tracer.inv.reshape(-1, 12).contiguous())
        kern, ref = tk.trace_tiles_inst, tk.trace_tiles_inst_reference
    for sort, r3, counts, keys, idmask in _mt_waves(tracer, cuda, seed=2):
        for any_hit in (False, True):
            before = tk.LAUNCHES[kind]
            t, tid = kern(counts, keys, r3, *tables, idmask, any_hit)
            torch.cuda.synchronize()
            assert tk.LAUNCHES[kind] == before + 1
            tr, idr = ref(counts, keys, r3, *tables, idmask, any_hit)
            assert torch.equal(tid, idr), (sort, any_hit)
            assert torch.equal(t.view(torch.int32), tr.view(torch.int32))
            assert (tid >= 0).any() and (tid < 0).any()


def test_trace_mt_rejects_bad_inputs(cuda):
    from tauray_torch.ops.trace_kernel import KB, trace_tiles
    tracer, _ = _soup_tracer(cuda, T=300)
    C = tracer.n_clusters
    counts = torch.zeros(4, dtype=torch.int32, device=cuda)
    keys = torch.full((4, C + KB), 0x7FFFFFFF, dtype=torch.int32,
                      device=cuda)
    rays = torch.zeros((4, 32, 8), device=cuda)
    args = (tracer.tris9, tracer.opaque, 3)
    for bad in ((counts.long(), keys, rays), (counts, keys[:, :C], rays),
                (counts, keys, rays[:, :16]), (counts, keys.cpu(), rays)):
        with pytest.raises(ValueError):
            trace_tiles(*bad, *args)
    with pytest.raises(ValueError):                      # idmask too small
        trace_tiles(counts, keys, rays, tracer.tris9, tracer.opaque, 0)
    with pytest.raises(ValueError):
        trace_tiles(counts, keys, rays, tracer.tris9, tracer.opaque[:1], 3)
    t, tid = trace_tiles(counts, keys, rays, *args)
    assert (tid == -1).all() and torch.isinf(t).all()


def test_per_model_render_goes_through_kernel(cuda):
    """A per-model render on the card launches K3 and never K1, and
    matches the same render on the CPU (plain version)."""
    from tauray_torch.io.gltf import load_scene
    from tauray_torch.ops.trace_kernel import LAUNCHES, reset_launch_counts
    from tauray_torch.options import Options
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer
    from tauray_torch.scene.scene import Scene
    imgs = []
    for dev in (cuda, torch.device("cpu")):
        opt = Options()
        opt.width = opt.height = 32
        opt.samples_per_pixel = 2
        opt.max_ray_depth = 3
        opt.tonemap = "linear"
        opt.as_strategy = "per-model"
        s = Scene()
        load_scene("proc://sponza?tris=8192", s)
        rr = PathTracerRenderer(opt, dev)
        rr.set_scene(s)
        reset_launch_counts()
        imgs.append(rr.render()[0])
        if dev.type == "cuda":
            assert LAUNCHES["trace_mt_inst"] > 0
            assert LAUNCHES["trace_vm3"] == 0
    a, b = imgs
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-6)
    assert (rel.max(-1) <= 1e-3).mean() >= 0.99


@pytest.mark.parametrize("entry", ["trace_vm2", "trace_vm"])
def test_trace_vm2_matches_plain_version(cuda, entry):
    """K4 (trace_tiles_vm2) and K5 (trace_tiles_vm, with debug_steps)
    against their plain version on sorted and unsorted waves, closest hit
    and any hit: ids identical, t bit-identical, steps per tile equal."""
    from tauray_torch.ops import trace_kernel as tk
    tracer, _ = _soup_tracer(cuda)
    tracer.opaque[::3] = 0
    for sort, r3, counts, keys, idmask in _mt_waves(tracer, cuda, seed=5):
        for any_hit in (False, True):
            args = (counts, keys, r3, tracer.tris12, tracer.opaque, idmask,
                    any_hit)
            before = tk.LAUNCHES[entry]
            if entry == "trace_vm2":
                t, tid = tk.trace_tiles_vm2(*args)
            else:
                t, tid, steps = tk.trace_tiles_vm(*args, debug_steps=True)
            torch.cuda.synchronize()
            assert tk.LAUNCHES[entry] == before + 1
            tr, idr, sr = tk.trace_tiles_vm2_reference(*args)
            assert torch.equal(tid, idr), (sort, any_hit)
            assert torch.equal(t.view(torch.int32), tr.view(torch.int32))
            assert (tid >= 0).any() and (tid < 0).any()
            if entry == "trace_vm":
                assert torch.equal(steps, sr), (sort, any_hit)
                assert int(sr.max()) > 1


def test_trace_vm2_rejects_bad_inputs(cuda):
    from tauray_torch.ops.trace_kernel import KB, trace_tiles_vm2
    tracer, _ = _soup_tracer(cuda, T=300)
    C = tracer.n_clusters
    counts = torch.zeros(4, dtype=torch.int32, device=cuda)
    keys = torch.full((4, C + KB), 0x7FFFFFFF, dtype=torch.int32,
                      device=cuda)
    rays = torch.zeros((4, 32, 8), device=cuda)
    with pytest.raises(ValueError):                      # tris9, not tris12
        trace_tiles_vm2(counts, keys, rays, tracer.tris9, tracer.opaque, 3)
    with pytest.raises(ValueError):
        trace_tiles_vm2(counts, keys[:, :C], rays, tracer.tris12,
                        tracer.opaque, 3)
    t, tid = trace_tiles_vm2(counts, keys, rays, tracer.tris12,
                             tracer.opaque, 3)
    assert (tid == -1).all() and torch.isinf(t).all()


@pytest.mark.parametrize("vm_kernel", ["", "v2"])
def test_foliage_render_goes_through_kernel(cuda, monkeypatch, vm_kernel):
    """The foliage Sponza on the card, 32x32, 2 spp: the default launches
    K1, TAURAY_VM_KERNEL=v2 launches K4 and never K1; the alpha rounds
    run; each matches the same render on the CPU (plain versions)."""
    from tauray_torch.io.gltf import load_scene
    from tauray_torch.ops.trace_kernel import LAUNCHES, reset_launch_counts
    from tauray_torch.options import Options
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer
    from tauray_torch.scene.scene import Scene
    monkeypatch.setenv("TAURAY_VM_KERNEL", vm_kernel)
    imgs = []
    for dev in (cuda, torch.device("cpu")):
        opt = Options()
        opt.width = opt.height = 32
        opt.samples_per_pixel = 2
        opt.max_ray_depth = 3
        opt.tonemap = "linear"
        s = Scene()
        load_scene("proc://sponza?tris=8192&foliage=1", s)
        rr = PathTracerRenderer(opt, dev)
        rr.set_scene(s)
        assert rr.cfg.has_alpha_materials
        reset_launch_counts()
        imgs.append(rr.render()[0])
        if dev.type == "cuda":
            k = "trace_vm2" if vm_kernel else "trace_vm3"
            assert LAUNCHES[k] > 0
            assert LAUNCHES["trace_vm3" if vm_kernel else "trace_vm2"] == 0
    a, b = imgs
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-6)
    assert (rel.max(-1) <= 1e-3).mean() >= 0.99


def _bw_every_w(tracer, r8, warps, any_hit):
    """K1, and K4/K5 with debug_steps, at W = warps against their plain
    versions on one wave: ids identical, t bit-identical, steps equal.
    K1 has no any-hit mode (the tracer's any-hit traces take it as it
    is), so its any-hit run is the same wave with t_max cut to 2."""
    from tauray_torch.ops import trace_kernel as tk
    from tauray_torch.ops.cluster import _phase1, _phase1_entry
    if any_hit:
        r8 = r8.clone()
        r8[:, 7] = torch.where(torch.isinf(r8[:, 7]), 2.0, r8[:, 7])
    r3 = r8.reshape(-1, 32, 8)
    counts, keys = _phase1(tracer, r8)
    t, tid, _ = tk._launch_bw(counts, keys, r3, tracer.tris12, None, 0,
                              False, "trace_vm3", warps=warps)
    tr, idr = tk.trace_tiles_vm3_reference(counts, keys, r3, tracer.tris12)
    torch.cuda.synchronize()
    assert torch.equal(tid, idr), ("K1", warps, any_hit)
    assert torch.equal(t.view(torch.int32), tr.view(torch.int32))
    counts, keys, idmask = _phase1_entry(tracer.cmin, tracer.cmax, r8)
    t, tid, steps = tk._launch_bw(counts, keys, r3, tracer.tris12,
                                  tracer.opaque, idmask, any_hit, "trace_vm",
                                  debug_steps=True, warps=warps)
    tr, idr, sr = tk.trace_tiles_vm2_reference(
        counts, keys, r3, tracer.tris12, tracer.opaque, idmask, any_hit)
    torch.cuda.synchronize()
    assert torch.equal(tid, idr), ("K4", warps, any_hit)
    assert torch.equal(t.view(torch.int32), tr.view(torch.int32))
    assert torch.equal(steps, sr), ("K5", warps, any_hit)
    return counts, tid


@pytest.mark.parametrize("warps", BW_WARPS)
def test_trace_bw_ties_at_every_w(cuda, warps):
    """The split walk's combine on tie_stack, a 32,768-ray wave: exact
    duplicates in several clusters (so equal t land in different warps'
    shares and inside one K4 step), tile counts 0, 1, 10 and 29 (not
    multiples of W or 8), NaN and t_max < t_min rays; closest and any
    hit, at every W the kernel is built for (4: two of a K4 step's keys a
    warp; 8: one)."""
    tracer = tie_stack(cuda)
    r8 = torch.from_numpy(tie_rays(1024)).to(cuda)
    seen = set()
    for any_hit in (False, True):
        counts, tid = _bw_every_w(tracer, r8, warps, any_hit)
        seen |= set(counts.tolist())
        assert (tid >= 0).any() and (tid < 0).any()
    assert {0, 1, 10, 29}.issubset(seen)


@pytest.mark.parametrize("warps", BW_WARPS)
def test_trace_bw_random_soup_at_every_w(cuda, warps):
    """K1 and K4/K5 at every W on sorted and unsorted random waves of the
    triangle soup (some clusters not opaque)."""
    tracer, _ = _soup_tracer(cuda)
    tracer.opaque[::3] = 0
    for sort, r3, *_ in _mt_waves(tracer, cuda, seed=11):
        for any_hit in (False, True):
            _bw_every_w(tracer, r3.reshape(-1, 8), warps, any_hit)


def _mt_every_w(tracer, r8, warps, any_hit):
    """K2 (a flat tracer) or K3 (an instanced one) at W = warps against
    the plain version on one wave: ids identical, t bit-identical, steps
    per tile equal."""
    from tauray_torch.ops import trace_kernel as tk
    from tauray_torch.ops.cluster import _phase1_entry
    r3 = r8.reshape(-1, 32, 8)
    counts, keys, idmask = _phase1_entry(tracer.cmin, tracer.cmax, r8)
    inst = None
    if hasattr(tracer, "k_inst"):
        inst = (tracer.k_cluster, tracer.k_inst,
                tracer.inv.reshape(-1, 12).contiguous())
    t, tid, steps = tk._launch_mt(counts, keys, r3, tracer.tris9,
                                  tracer.opaque, inst, idmask, any_hit,
                                  debug_steps=True, warps=warps)
    stats = {}
    tr, idr = tk._mt_reference(counts, keys, r3, tracer.tris9, tracer.opaque,
                               inst, idmask, any_hit, stats)
    torch.cuda.synchronize()
    kind = "K2" if inst is None else "K3"
    assert torch.equal(tid, idr), (kind, warps, any_hit)
    assert torch.equal(t.view(torch.int32), tr.view(torch.int32))
    assert torch.equal(steps, stats["tile_steps"]), (kind, warps, any_hit)
    return counts, tid


@pytest.mark.parametrize("warps", BW_WARPS)
def test_trace_mt_ties_at_every_w(cuda, warps):
    """K2 on tie_stack and K3 on its two-instance form, a 32,768-ray wave
    of exact duplicates, closest and any hit, at every W."""
    r8 = torch.from_numpy(tie_rays(1024)).to(cuda)
    for tracer in (tie_stack(cuda), tie_stack_instanced(cuda)):
        for any_hit in (False, True):
            counts, tid = _mt_every_w(tracer, r8, warps, any_hit)
            assert (tid >= 0).any() and (tid < 0).any()
            assert int(counts.max()) > 8 and int(counts.min()) == 0


@pytest.mark.parametrize("warps", BW_WARPS)
def test_trace_mt_random_soup_at_every_w(cuda, warps):
    """K2 on the triangle soup (some clusters not opaque) and K3 on the
    instanced scene, sorted and unsorted random waves, closest and any hit,
    at every W."""
    soup, _ = _soup_tracer(cuda)
    soup.opaque[::3] = 0
    for tracer in (soup, _instanced(cuda)):
        for sort, r3, *_ in _mt_waves(tracer, cuda, seed=13):
            for any_hit in (False, True):
                _mt_every_w(tracer, r3.reshape(-1, 8), warps, any_hit)


def _sponza_renderer(device, args, animate=False):
    from tauray_torch.app.main import create_renderer, load_scenes
    from tauray_torch.options import parse_command_line_options
    from tauray_torch.scene import animation as anim
    opt = parse_command_line_options(args + [
        "--width=64", "--height=48", "--samples-per-pixel=1",
        "--max-ray-depth=3", "--tonemap=linear", "proc://sponza?tris=8192"])
    s = load_scenes(opt)
    if animate:
        e = next(e for e in s.entities if e.model is not None)
        a = anim.Animation()
        a.add_channel("translation", anim.AnimationChannel(
            times=np.array([0.0, 1.0], np.float32),
            values=np.array([[0, 0, 0], [0.5, 0.2, -0.3]], np.float32)))
        e.animations = {"slide": a}
        anim.play(s, "slide", False)
    rr = create_renderer(opt, s, device)
    rr.set_scene(s)
    return rr, s


def test_device_update_on_card_matches_host_path(cuda):
    """update_frame (device_update_frame) on the card against the host
    path on the card, within 1e-4 of scale, over two animated frames."""
    from tauray_torch.scene import animation as anim
    rr, s = _sponza_renderer(cuda, [], animate=True)
    for _ in range(2):
        anim.update(s, 250000, True)
        rr.update_frame()
        dev_scene, dev_bvh = rr.device_scene, rr.bvh
        host_bvh = rr.host_update_frame(dev_bvh, rr._perm)
        for name in ("tri_pos", "tri_normal", "tri_tangent",
                     "tri_hard_normal"):
            want = getattr(rr.device_scene, name)
            d = float((getattr(dev_scene, name) - want).abs().max())
            assert d / (float(want.abs().max()) + 1.0) < 1e-4, name
        assert torch.allclose(dev_bvh.cmin, host_bvh.cmin, atol=1e-3)
        rr.device_scene = dev_scene
    assert dev_scene.tri_pos.is_cuda


@pytest.mark.parametrize("denoiser", ["svgf", "bmfr"])
def test_post_stack_on_card_matches_cpu(cuda, denoiser):
    """The post-processing pipeline (denoiser, temporal reprojection,
    TAA) on the card and on the CPU over three frames of one seeded
    G-buffer sequence, by tests/test_torch_post.py's rule (>= 99.5% of
    the elements within atol + 1e-3 relative; BMFR's atol 2e-3 of the
    largest value)."""
    from tauray_torch.options import Options
    from tauray_torch.renderer.post_processing import PostProcessingPipeline
    H, W = 72, 80
    rng = np.random.default_rng(11)
    opt = Options()
    opt.denoiser = denoiser
    opt.temporal_reprojection = 0.5
    opt.taa.sequence_length = 8
    opt.tonemap = "linear"
    sides = [PostProcessingPipeline(opt, W, H, 1, d) for d in (cuda, "cpu")]
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    for k in range(3):
        n = rng.normal(0, 0.1, (H, W, 3)) + [0, 1, 0]
        motion = np.stack([(xs + 0.5) / W, 1 - (ys + 0.5) / H,
                           np.ones_like(xs)], -1) + \
            rng.normal(0, 0.002, (H, W, 3))
        g = dict(color=rng.uniform(0, 1, (H, W, 4)),
                 diffuse=rng.uniform(0, 1, (H, W, 4)),
                 reflection=rng.uniform(0, 0.5, (H, W, 4)),
                 albedo=rng.uniform(0, 1, (H, W, 4)),
                 normal=n / np.linalg.norm(n, axis=-1, keepdims=True),
                 pos=np.stack([xs * 0.01, np.zeros_like(xs), ys * 0.01], -1),
                 screen_motion=motion,
                 metallic_roughness=rng.uniform(0, 1, (H, W, 2)),
                 emission=np.zeros((H, W, 3)),
                 view_z=-rng.uniform(1, 2, (H, W)))
        g = {key: v[None].astype(np.float32) for key, v in g.items()}
        origin = np.zeros((1, 4), np.float32)
        outs = [p.process({key: torch.from_numpy(v).to(p.device)
                           for key, v in g.items()}, cam_origin=origin)
                .cpu().numpy() for p in sides]
    got, want = outs
    atol = 2e-3 * float(np.abs(want).max()) if denoiser == "bmfr" else 1e-4
    ok = np.abs(got - want) <= atol + 1e-3 * np.abs(want)
    assert float(ok.mean()) >= 0.995
    assert abs(got.mean() - want.mean()) <= 1e-3 * abs(want.mean())


def test_feature_render_goes_through_kernel(cuda):
    """The instance-id feature at 64x48 launches K1 and equals the CPU's
    image exactly."""
    from tauray_torch.ops.trace_kernel import LAUNCHES
    before = LAUNCHES["trace_vm3"]
    rr, _ = _sponza_renderer(cuda, ["--renderer=instance-id"])
    got = rr.render()
    assert LAUNCHES["trace_vm3"] > before
    ref, _ = _sponza_renderer(torch.device("cpu"),
                              ["--renderer=instance-id"])
    np.testing.assert_array_equal(got, ref.render())


def _gbuf_share(got: dict, want: dict) -> dict:
    """Per G-buffer key, the share of elements within 1e-4 + 1e-3 x |want|
    (NaN matching NaN)."""
    out = {}
    for k, w in want.items():
        g, w = got[k].cpu().numpy(), w.cpu().numpy()
        ok = (np.abs(g - w) <= 1e-4 + 1e-3 * np.abs(w)) | \
            (np.isnan(g) & np.isnan(w))
        out[k] = float(ok.mean())
    return out


RASTER_SMALL = ["--renderer=raster", "--shadow-map-resolution=256",
                "--pcf=16", "--pcss=8"]


def test_raster_on_card_matches_cpu(cuda):
    """--renderer=raster at 64x48 with 256^2 maps, two frames: the maps'
    waves go through K1; the card's maps and every G-buffer key of the
    second frame agree with the CPU's (>= 99% of the elements within
    1e-4 + 1e-3 relative; shadow_vis off by more than one PCF tap (1/16)
    on at most 0.5% of the pixels). The second frame's maps trace the
    geometry of update_frame, whose transforms round differently on the
    card (cuBLAS contracts into FMAs), so a ray through a crack between
    two triangles may hit a farther surface on one side: at most 0.1% of
    the texels differ, hit or miss or depth beyond 1e-5 relative."""
    from tauray_torch.ops.trace_kernel import LAUNCHES
    before = LAUNCHES["trace_vm3"]
    sides = []
    for dev in (cuda, torch.device("cpu")):
        rr, _ = _sponza_renderer(dev, RASTER_SMALL)
        rr.render_device()
        rr.update_frame()
        rr.render_device()
        sides.append(rr)
    # 16 maps at set_scene and 16 at update_frame, 1 camera wave a frame
    assert LAUNCHES["trace_vm3"] - before == 34, LAUNCHES
    card, cpu = sides
    dc, dw = card.shadow_maps.depth.cpu(), cpu.shadow_maps.depth
    far = cpu.shadow_maps.params[:, 3, None, None]
    differ = ((dc < far) != (dw < far)) | \
        ((dc - dw).abs() > 1e-5 * dw.abs())
    assert float(differ.float().mean()) <= 1e-3, int(differ.sum())
    shares = _gbuf_share(card.last_gbuf, cpu.last_gbuf)
    assert min(shares.values()) >= 0.99, shares
    sv = (card.last_gbuf["shadow_vis"].cpu() -
          cpu.last_gbuf["shadow_vis"]).abs()
    off = float((sv > 1 / 16 + 1e-5).float().mean())
    assert off <= 5e-3, off


def test_dshgi_on_card_matches_cpu(cuda):
    """--renderer=dshgi with a 2x2x2 SH grid over the scene, 64 samples a
    probe, two frames: the bake within 2e-3 of the largest coefficient
    (99.9% within 1e-3) and the G-buffer as the raster test holds it."""
    from tauray_torch.app.main import create_renderer, load_scenes
    from tauray_torch.options import parse_command_line_options
    from tauray_torch.scene.sh_grid import SHGrid
    from tauray_torch.scene.transformable import Transformable
    sides = []
    for dev in (cuda, torch.device("cpu")):
        opt = parse_command_line_options(
            ["--renderer=dshgi", "--shadow-map-resolution=128", "--pcf=8",
             "--pcss=8", "--samples-per-probe=64", "--width=64",
             "--height=48", "--samples-per-pixel=1", "--max-ray-depth=2",
             "--tonemap=linear", "proc://sponza?tris=8192"])
        s = load_scenes(opt)
        ge = s.add("probes")
        ge.transform = Transformable(position=(0, 4, 0),
                                     scaling=(10, 4, 6))
        ge.sh_grid = SHGrid(resolution=(2, 2, 2), order=2)
        rr = create_renderer(opt, s, dev)
        rr.set_scene(s)
        for k in range(2):
            if k:
                rr.update_frame()
            rr.render_device()
        sides.append(rr)
    card, cpu = sides
    got = card.sh_source.current_grid_data()[0].cpu().numpy()
    want = cpu.sh_source.current_grid_data()[0].numpy()
    scale = float(np.abs(want).max())
    diff = np.abs(got - want)
    assert float(diff.max()) <= 2e-3 * scale
    assert float((diff <= 1e-3 * scale).mean()) >= 0.999
    shares = _gbuf_share(card.last_gbuf, cpu.last_gbuf)
    assert min(shares.values()) >= 0.99, shares


def test_distributed_on_card_matches_one_device(cuda):
    """DistributedPathTracerRenderer over the card named twice, 3
    workloads each (shuffled strips), and the view-sharded path over a
    4x2 camera grid: every workload's waves through K1, each image equal
    to the one-device render within 1e-5 (hits are per ray)."""
    from tauray_torch.app.main import generate_cameras, load_scenes
    from tauray_torch.ops.trace_kernel import LAUNCHES
    from tauray_torch.options import parse_command_line_options
    from tauray_torch.renderer.distributed import \
        DistributedPathTracerRenderer
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer
    for extra, views in ((["--fake-devices=3"], False),
                         (["--camera-grid=4,2,0.05,0.05"], True)):
        opt = parse_command_line_options([
            "--width=64", "--height=48", "--max-ray-depth=2",
            "--tonemap=linear"] + extra + [
            "--headless=unused", "--filetype=none",
            "proc://sponza?tris=8192"])
        imgs = []
        for devices in ([cuda] * 2, None):
            s = load_scenes(opt)
            generate_cameras(s, opt)
            rr = PathTracerRenderer(opt, cuda) if devices is None else \
                DistributedPathTracerRenderer(opt, cuda, devices=devices)
            rr.set_scene(s)
            before = LAUNCHES["trace_vm3"]
            imgs.append(rr.render())
            assert LAUNCHES["trace_vm3"] > before
            if devices is not None:
                assert rr.view_sharded == views
        np.testing.assert_allclose(imgs[0], imgs[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("lab", ["lab8", "lab9", "lab10", "lab11"])
def test_k1_lab_matches_plain_version(cuda, lab):
    """Every mode of each K1 lab (csrc/k1_lab.cu) at a small size against
    its plain torch version on the same card inputs: t and id bits equal
    (-fmad=false), L11 mxu by kernel_lab11.mxu_agreement, L9's modes with
    a test, L10's and L11 vpu (their kernels take the FMA body) by
    kernel_lab9.lab9_agreement, kernel_lab10.lab10_agreement (nowrite
    bit for bit to what the kernel's full computes) and
    kernel_lab11.vpu_agreement, L9 loads bit for bit; each launch
    counted."""
    from tauray_torch.app.kernel_waves import kernel_waves, retrace_slice
    from tauray_torch.lab import common, lab_kernel
    from tauray_torch.lab import kernel_lab8, kernel_lab9, kernel_lab10, \
        kernel_lab11

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
    runs = []
    if lab == "lab8":
        o3, d3, mm2, _ = map(t, common.lab8_inputs(4096, seed=1))
        heads = t(np.random.default_rng(2).integers(
            0, 999, (128, common.KC)).astype(np.int32))
        for mode in lab_kernel.MODES[lab]:
            counts = t(np.arange(128, dtype=np.int32) % 24)
            args = (counts, heads, o3, d3, mm2, mode)
            runs.append((mode, kernel_lab8.lab8(*args),
                         kernel_lab8.lab8_reference(*args)))
    elif lab == "lab9":
        tracer = common.scene_tracer(cuda, "proc://sponza?tris=8192")
        o3, d3, mm2, heads = map(t, common.lab9_inputs(
            tracer.n_clusters, 4096, seed=3))
        counts = t(np.arange(128, dtype=np.int32) % 40)
        for mode in lab_kernel.MODES[lab]:
            args = (counts, heads, o3, d3, mm2, tracer.tris12, mode)
            runs.append((mode, kernel_lab9.lab9(*args),
                         kernel_lab9.lab9_reference(*args)))
    elif lab == "lab10":
        tracer, waves = kernel_waves(cuda, scene="proc://sponza?tris=8192",
                                     size=64)
        counts, keys, r3, idmask = kernel_lab10.wave_args(
            tracer, retrace_slice(waves["bounce"], 2048))
        counts[40:] = 0
        counts[3] = 0
        for mode in lab_kernel.MODES[lab]:
            args = (counts, keys, r3, tracer.tris12, mode, idmask)
            runs.append((mode, kernel_lab10.lab10(*args),
                         kernel_lab10.lab10_reference(*args)))
    else:
        steps, rays, tris12, m = map(t, common.lab11_inputs(
            C=64, n_tiles=96, n_steps=3, seed=4))
        for mode, tris in (("vpu", tris12), ("mxu", m)):
            args = (steps, rays, tris, mode)
            runs.append((mode, kernel_lab11.lab11(*args),
                         kernel_lab11.lab11_reference(*args)))
    torch.cuda.synchronize()
    assert lab_kernel.LAUNCHES[lab] >= len(runs)
    for mode, got, want in runs:
        if mode == "mxu":
            agree = kernel_lab11.mxu_agreement(got, want, rays, m)
            assert agree["ok"], agree
        elif mode == "vpu":
            # 3,072 rays: ILL_SHARE admits no turned verdict, so at most
            # one, as the CPU tests of the FMA bodies allow
            agree = kernel_lab11.vpu_agreement(got, want, rays, tris12)
            assert agree["ill_conditioned"] <= 1 and \
                agree["rays_off"] == 0, agree
        elif lab == "lab9" and mode != "loads":
            agree = kernel_lab9.lab9_agreement(got, want, o3, d3, mm2,
                                               tracer.tris12, mode)
            assert agree["ok"], agree
        elif lab == "lab10":
            # 2,048 rays: ILL_SHARE admits no turned verdict, so at most
            # one, as the CPU tests of the FMA bodies allow
            agree = kernel_lab10.lab10_agreement(
                got, want, counts, r3, tracer.tris12, mode, full=runs[0][1])
            assert agree.get("ill_conditioned", 0) <= 1 and \
                agree["rays_off"] == 0, (mode, agree)
        else:
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), mode


@pytest.mark.parametrize("lab", ["lab4", "lab5", "lab6", "lab7"])
def test_brick_lab_matches_plain_version(cuda, lab):
    """Every configuration of each brick lab's script main (csrc/
    brick_lab.cu) against its plain version on the same card inputs (one
    walk, the FMA bodies), as chip_smoke holds them (brick.agreement): L4
    mtfast by brick.mtfast_agreement, L4 mt and L5-L7 by
    brick.brick_agreement, L4 (with k8 and k8f too), L5 and L6 on all
    65,536 rays, L7 on the first 1,024 tiles (the share of 1e-4 of the
    rays for a verdict that rounding decides admits none on 2,048 rays);
    L6's while and while2 also where the exit fires (every 8th meta entry
    0x7f000000), their steps walked per tile held too; each launch
    counted."""
    from tauray_torch.lab import brick, common, lab_kernel
    tables, draws = {
        "lab4": lambda: common.lab4_inputs(
            ("k8", "k6", "k7", "k8f", "k6f", "k7f")),
        "lab5": common.lab5_inputs, "lab6": common.lab6_inputs,
        "lab7": common.lab7_inputs}[lab]()
    tabs = {k: torch.from_numpy(v).to(cuda) for k, v in tables.items()}
    before = lab_kernel.LAUNCHES[lab]
    n = 0
    tiles = {"lab7": 1024}.get(lab)
    for cfg, meta, rays in draws:
        tiles_ = tiles or cfg.n_tiles
        meta = meta[:tiles_ * common.ROW]
        metas = [meta]
        if cfg.mode.startswith("while"):
            crafted = meta.copy()
            crafted[::8] = 0x7F000000
            metas.append(crafted)
        r = torch.from_numpy(rays[:tiles_]).to(cuda)
        tris = tabs["tris12" if cfg.mode == "bw" else "tris9"]
        for i, m in enumerate(metas):
            m = torch.from_numpy(m).to(cuda)
            args = (cfg.lab, cfg.mode, m, r, tris, cfg.kb, cfg.steps)
            got = brick.brick(*args)
            want = brick.walk_reference(*args)
            n += 1
            walked = None
            if i:       # the exit fires: the steps each tile needed
                walked = [brick.walked_steps(
                    lambda s, f=f: f(*args[:5], cfg.kb, s), cfg.steps)
                    for f in (brick.brick, brick.walk_reference)]
                n += cfg.steps + 1
                assert int(walked[0].sum()) < tiles_ * cfg.steps
            agree = brick.agreement(cfg.lab, cfg.mode, got, want, m, r,
                                    tris, cfg.kb, walked)
            assert agree["ok"], (cfg.label, agree)
    torch.cuda.synchronize()
    assert lab_kernel.LAUNCHES[lab] - before == n


def test_fma_labs_redo_steps_with_odd_denominators(cuda):
    """L9 full, L7 mt / bw, L4 mt / mtfast, L5, L6 and L11 vpu on rays
    whose denominator leaves the in-range reciprocal's range: directions
    scaled by 1e-39 (a subnormal den, where the kernels redo the step, or
    the cluster, with __frcp_rn, here every one of every tile), NaN
    directions and axis-aligned ones against axis-aligned triangles (the
    Sponza table's walls; for L4 and L11 triangles made so in the table:
    den NaN or exactly 0, a miss without a redo): held to the plain
    versions by the tie-aware rules (L4 mtfast, which takes no
    reciprocal, by brick.mtfast_agreement)."""
    from tauray_torch.lab import brick, common, kernel_lab5, kernel_lab9, \
        kernel_lab11
    tracer = common.scene_tracer(cuda, "proc://sponza?tris=8192")
    o3, d3, mm2, heads = (torch.from_numpy(x).to(cuda) for x in
                          common.lab9_inputs(tracer.n_clusters, 4096,
                                             seed=7))
    d3 = d3.clone()
    d3.view(-1, 3)[::7] = torch.tensor([1.0, 0.0, 0.0], device=cuda)
    d3.view(-1, 3)[::13] *= 1e-39
    d3.view(-1, 3)[::17] = float("nan")
    counts = torch.full((128,), 32, dtype=torch.int32, device=cuda)
    args = (counts, heads, o3, d3, mm2, tracer.tris12, "full")
    got, want = kernel_lab9.lab9(*args), kernel_lab9.lab9_reference(*args)
    agree = kernel_lab9.lab9_agreement(got, want, o3, d3, mm2,
                                       tracer.tris12, "full")
    assert agree["ok"], agree
    hits = want[..., 1].view(torch.int32) >= 0
    assert bool(hits.view(-1)[::7].any())
    tables, draws = common.lab7_inputs()
    for cfg, meta, rays in draws:
        if (cfg.kb, cfg.steps) != (8, 4):
            continue
        meta = torch.from_numpy(meta[:1024 * common.ROW]).to(cuda)
        rays = torch.from_numpy(rays[:1024]).to(cuda).clone()
        rays.view(-1, 8)[::13, 3:6] *= 1e-39
        rays.view(-1, 8)[::17, 3:6] = float("nan")
        tris = torch.from_numpy(
            tables["tris12" if cfg.mode == "bw" else "tris9"]).to(cuda)
        args = (meta, rays, tris, cfg.mode, cfg.kb, cfg.steps)
        got = kernel_lab5.lab7(*args)
        agree = kernel_lab5.lab7_agreement(
            got, kernel_lab5.lab7_reference(*args), meta, rays, tris,
            cfg.mode)
        assert agree["ok"], (cfg.label, agree)
    for lab, inputs, picks in (
            ("lab5", common.lab5_inputs, {("mt", 8, 1), ("mt", 32, 8)}),
            ("lab6", common.lab6_inputs, {("cid", 32, 8), ("while", 16, 8)})):
        tables, draws = inputs()
        tris = torch.from_numpy(tables["tris9"]).to(cuda)
        for cfg, meta, rays in draws:
            if (cfg.mode, cfg.tile, cfg.kb) not in picks:
                continue
            meta = torch.from_numpy(meta).to(cuda)
            rays = torch.from_numpy(rays).to(cuda).clone()
            rays.view(-1, 8)[::13, 3:6] *= 1e-39
            rays.view(-1, 8)[::17, 3:6] = float("nan")
            args = (lab, cfg.mode, meta, rays, tris, cfg.kb, cfg.steps)
            agree = brick.brick_agreement(
                lab, cfg.mode, brick.brick(*args),
                brick.walk_reference(*args), meta, rays, tris)
            assert agree["ok"], (cfg.label, agree)
    # L4 at k7 KB 4: every 5th triangle with e1 and e2 in the xy plane, so
    # that every 7th ray, along x, meets it with a = 0
    tables, draws = common.lab4_inputs(("k7", "k7f"))
    tris = torch.from_numpy(tables["tris9"]).to(cuda).clone()
    tris[:, 5, 0, ::5] = 0.0
    tris[:, 8, 0, ::5] = 0.0
    for cfg, meta, rays in draws:
        if cfg.kb != 4:
            continue
        meta = torch.from_numpy(meta).to(cuda)
        rays = torch.from_numpy(rays).to(cuda).clone()
        rays.view(-1, 8)[::7, 3:6] = torch.tensor([1.0, 0.0, 0.0],
                                                  device=cuda)
        rays.view(-1, 8)[::13, 3:6] *= 1e-39
        rays.view(-1, 8)[::17, 3:6] = float("nan")
        args = ("lab4", cfg.mode, meta, rays, tris, cfg.kb, cfg.steps)
        agree = brick.agreement(*args[:2], brick.brick(*args),
                                brick.walk_reference(*args), meta, rays,
                                tris, cfg.kb)
        assert agree["ok"], (cfg.label, agree)
    # L11 vpu: every 5th triangle's normal with x = 0, every 7th ray along
    # x (den exactly 0 there)
    steps, rays, tris12, _ = (torch.from_numpy(x).to(cuda) for x in
                              common.lab11_inputs(C=256, n_tiles=1024,
                                                  n_steps=4, seed=6))
    tris12 = tris12.clone()
    tris12[:, 0, 0, ::5] = 0.0
    rays = rays.clone()
    rays.view(-1, 8)[::7, 3:6] = torch.tensor([1.0, 0.0, 0.0], device=cuda)
    rays.view(-1, 8)[::13, 3:6] *= 1e-39
    rays.view(-1, 8)[::17, 3:6] = float("nan")
    args = (steps, rays, tris12, "vpu")
    agree = kernel_lab11.vpu_agreement(kernel_lab11.lab11(*args),
                                       kernel_lab11.lab11_reference(*args),
                                       rays, tris12)
    assert agree["ok"], agree


@pytest.mark.parametrize("lab", ["lab1", "lab2", "lab3"])
def test_tile_lab_matches_plain_version(cuda, lab):
    """Each L1-L3 kernel (csrc/tile_lab.cu) on the first 64 tiles of
    scripts/kernel_lab.py's inputs, at 0, 1, 3 and 8 steps and on uneven
    counts (slots past a tile's count skipped), against its plain version
    on the same card inputs: k0-k2 t and id bits equal (-fmad=false); k3,
    k4 and k5 (one template, the FMA body) by kernel_lab.lab3_agreement,
    also at 8 steps on odd denominators (every 13th direction scaled by
    1e-39, every 17th NaN: a warp's share redone with __frcp_rn); k4 and
    k5 (at G 8 and 32) also where the exit fires (the tnear third of each
    row 0x7f000000), walking one step a tile, the steps walked per tile
    (kernel_lab.walked_steps) held too; each launch counted."""
    from tauray_torch.lab import common, kernel_lab, lab_kernel
    inp = kernel_lab.tile_inputs(cuda, tiles=64)
    meta = inp["meta"].view(64, common.ROW_L1).clone()
    meta[:, common.CPAD:2 * common.CPAD] = 0x7F000000
    crafted = dict(inp, meta=meta.view(-1))
    rows = inp["rows"].clone()
    rows.view(-1, 8)[::13, 3:6] *= 1e-39
    rows.view(-1, 8)[::17, 3:6] = float("nan")
    odd = dict(inp, rows=rows, cols=rows.view(-1, 8).t().contiguous(),
               planes=rows.transpose(1, 2).contiguous())
    cfgs = {"lab1": [kernel_lab.TileConfig(k, 1, 0, "")
                     for k in ("k0", "k1", "k2", "k3")],
            "lab2": [kernel_lab.TileConfig("k4", 8, 0, "")],
            "lab3": [kernel_lab.TileConfig("k5", g, 0, "")
                     for g in (8, 32)]}[lab]
    uneven = torch.arange(64, dtype=torch.int32, device=cuda) % 23
    before = lab_kernel.LAUNCHES[lab]
    n = 0
    for cfg in cfgs:
        runs = [(inp, kernel_lab.counts_of(64, s, cuda))
                for s in (0, 1, 3, 8)]
        runs.append((inp, uneven))
        if cfg.name in ("k3", "k4", "k5"):
            runs.append((odd, kernel_lab.counts_of(64, 8, cuda)))
        if lab != "lab1":
            runs.append((crafted, kernel_lab.counts_of(64, 8, cuda)))
        for data, counts in runs:
            out = kernel_lab.call(cfg, data, counts)
            stats = {}
            ref = kernel_lab.call_reference(cfg, data, counts, stats)
            n += 1
            if data is crafted:
                assert stats["steps"] == 64
            if cfg.name in ("k3", "k4", "k5"):
                walked = None
                if data is crafted:
                    walked = [kernel_lab.walked_steps(
                        lambda c: fn(cfg, data, c), counts)
                        for fn in (kernel_lab.call, kernel_lab.call_reference)]
                    n += 1 + (int(counts.max()) + 7) // 8
                agree = kernel_lab.lab3_agreement(out, ref, data["meta"],
                                                  data["rows"], data["tris9"],
                                                  walked, cfg.name)
                assert agree["ok"], (cfg, counts, agree)
                continue
            got, want = kernel_lab.flat(cfg.name, out), \
                kernel_lab.flat(cfg.name, ref)
            assert torch.equal(got[0].view(torch.int32),
                               want[0].view(torch.int32)), (cfg, counts)
            assert torch.equal(got[1], want[1]), (cfg, counts)
    torch.cuda.synchronize()
    assert lab_kernel.LAUNCHES[lab] - before == n


def test_mxu_lab_matches_plain_version(cuda):
    """L12 (csrc/mxu_lab.cu) on scripts/mxu_lab.py's inputs, all 2,048
    tiles: mt (the brick walk's FMA body) held to its plain version by
    mxu_lab.mt_agreement, also on odd denominators (every 13th direction
    scaled by 1e-39, a subnormal a whose step is redone with __frcp_rn;
    every 17th NaN; every 7th along x against every 5th triangle in the xy
    plane, a = 0); plucker by mxu_lab.plucker_agreement; each launch
    counted."""
    from tauray_torch.lab import common, lab_kernel, mxu_lab
    inp = {k: torch.from_numpy(v).to(cuda)
           for k, v in common.lab12_inputs().items()}
    before = lab_kernel.LAUNCHES["lab12"]
    args = [inp[k] for k in ("order", "o3", "d3", "mm2")]
    for mode in ("mt", "plucker"):
        tris = inp["tris9" if mode == "mt" else "tris24"]
        got = mxu_lab.lab12(*args, tris, mode)
        want = mxu_lab.lab12_reference(*args, tris, mode)
        hold = mxu_lab.mt_agreement if mode == "mt" else \
            mxu_lab.plucker_agreement
        agree = hold(got, want, inp)
        assert agree["ok"], (mode, agree)
    d_odd = inp["d3"].clone()
    d_odd.view(-1, 3)[::7] = torch.tensor([1.0, 0.0, 0.0], device=cuda)
    d_odd.view(-1, 3)[::13] *= 1e-39
    d_odd.view(-1, 3)[::17] = float("nan")
    t_odd = inp["tris9"].clone()
    t_odd[:, 5, 0, ::5] = 0.0
    t_odd[:, 8, 0, ::5] = 0.0
    odd = (inp["order"], inp["o3"], d_odd, inp["mm2"], t_odd, "mt")
    agree = mxu_lab.mt_agreement(mxu_lab.lab12(*odd),
                                 mxu_lab.lab12_reference(*odd),
                                 dict(inp, d3=d_odd, tris9=t_odd))
    assert agree["ok"], agree
    torch.cuda.synchronize()
    assert lab_kernel.LAUNCHES["lab12"] - before == 3


def test_lab8_every_mode_and_count_bit_for_bit(cuda):
    """L8 (csrc/k1_lab.cu lab8_kernel: a warp a tile, 8 tiles a block, the
    rows through shared memory by cp.async) on 2^20 seeded rays, every mode
    at the script's counts (0; mode 3 also 8 and 16) and on uneven counts
    up to 1,031 (ceil(count / 8) past the 128 heads), equal to its plain
    version bit for bit; each launch counted."""
    from tauray_torch.lab import common, kernel_lab8, lab_kernel
    o3, d3, mm2, _ = (torch.from_numpy(x).to(cuda)
                      for x in common.lab8_inputs())
    n_tiles = o3.shape[0]
    heads = torch.from_numpy(np.random.default_rng(5).integers(
        -999, 999, (n_tiles, common.KC)).astype(np.int32)).to(cuda)
    before = lab_kernel.LAUNCHES["lab8"]
    n = 0
    for mode in kernel_lab8.NAMES:
        counts = [torch.full((n_tiles,), c, dtype=torch.int32, device=cuda)
                  for c in ((0,) if mode < 3 else (0, 8, 16))]
        counts.append(torch.arange(n_tiles, dtype=torch.int32,
                                   device=cuda) % 1032)
        for c in counts:
            args = (c, heads, o3, d3, mm2, mode)
            got = kernel_lab8.lab8(*args)
            want = kernel_lab8.lab8_reference(*args)
            n += 1
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), mode
    torch.cuda.synchronize()
    assert lab_kernel.LAUNCHES["lab8"] - before == n


def test_time_graph_leaves_the_host_path_out(cuda):
    """common.time_graph gives L8 mode 3 at count 16 (2^20 rays) a positive
    time a call, no larger than one call's between CUDA events (which holds
    the wrapper's host path too)."""
    from tauray_torch.lab import common, kernel_lab8
    o3, d3, mm2, heads = (torch.from_numpy(x).to(cuda)
                          for x in common.lab8_inputs())
    counts = torch.full((o3.shape[0],), 16, dtype=torch.int32, device=cuda)

    def call():
        return kernel_lab8.lab8(counts, heads, o3, d3, mm2, 3)
    graph = common.time_graph(call)
    one = common.time_cuda(call)
    assert 0 < graph["min_ms_graph"] <= graph["ms_graph"] <= \
        graph["max_ms_graph"]
    assert graph["ms_graph"] <= one["ms"], (graph, one)
