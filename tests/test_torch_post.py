"""The post-processing stack of tauray_torch (stages/temporal.py, svgf.py,
bmfr.py, taa.py, renderer/post_processing.py) against tauray_tpu's, stage
by stage on the same G-buffers, then end to end through both renderers.

The G-buffers are three animated frames of tests/test_torch_device_update
's scene rendered by the port at 40x36: the top rows see sky, BMFR pads
the image to 64x64 blocks, and every neighbourhood tap that wraps around
an edge is part of the comparison. Each package carries its own history
(SVGF/BMFR state, TAA history) over the three frames.

Tolerance (`agree`): an element agrees when it is within 1e-4 + 1e-3 x
|tauray_tpu's value|. XLA:CPU contracts multiply-adds into FMAs and eager
torch does not, so the validity tests of the reprojections (cosine and
distance thresholds) can flip at a rare pixel; at least 99.5% of the
elements of every output must agree, and the image means within 1e-3
relative. BMFR's fit solves every block's 10x10 normal equations in
float32 in both packages; against a float64 solve of the same blocks the
fits are off by up to 2.9e-3 (the port) and 1.1e-3 (tauray_tpu) on values
up to 2.2 here, so BMFR outputs take an absolute term of 2e-3 x the
output's largest value instead of 1e-4."""

import numpy as np
import pytest
import torch

from tauray_torch.renderer import post_processing as tpost
from tauray_torch.stages import bmfr as tbmfr
from tauray_torch.stages import svgf as tsvgf
from tauray_torch.stages import taa as ttaa
from tauray_torch.stages import temporal as ttemp
from tauray_tpu.stages import bmfr as jbmfr
from tauray_tpu.stages import svgf as jsvgf
from tauray_tpu.stages import taa as jtaa
from tauray_tpu.stages import temporal as jtemp

from test_torch_device_update import FRAME_DT, advance, anim_scene

torch.set_num_threads(2)

CPU = torch.device("cpu")
W, H = 40, 36


def agree(got, want, what, frac=0.995, atol=1e-4):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    same_nan = np.isnan(got) == np.isnan(want)
    ok = (np.abs(got - want) <= atol + 1e-3 * np.abs(want)) | \
        (np.isnan(got) & np.isnan(want)) | (got == want)
    share = float(ok.mean())
    fin = np.isfinite(want) & np.isfinite(got)
    mg, mw = float(got[fin].mean()), float(want[fin].mean())
    print(f"{what}: {share:.5f} agree, mean {mg:.6g} vs {mw:.6g}")
    assert same_nan.all(), what
    assert share >= frac, (what, share)
    assert abs(mg - mw) <= 1e-3 * max(abs(mw), 1e-3), (what, mg, mw)


def bmfr_atol(want):
    return 2e-3 * float(np.abs(np.asarray(want)).max())


def _j(x):
    import jax.numpy as jnp
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def gbufs():
    """Three frames of the port's G-buffer (numpy, (H, W, C) each field of
    view 0) and the camera origins."""
    from tauray_torch.options import Options
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer
    opt = Options()
    opt.width, opt.height = W, H
    opt.samples_per_pixel = 1
    opt.max_ray_depth = 3
    opt.tonemap = "linear"
    opt.temporal_reprojection = 0.5
    s = anim_scene("tauray_torch")
    rr = PathTracerRenderer(opt, CPU)
    rr.set_scene(s)
    frames = []
    process = rr.post.process

    def capture(gbuf, cam_origin=None):
        frames.append(dict({k: v[0].numpy().copy() for k, v in gbuf.items()},
                           cam_origin=np.asarray(cam_origin[0][:3])))
        return process(gbuf, cam_origin)
    rr.post.process = capture
    for k in range(3):
        if k:
            advance("tauray_torch", s, FRAME_DT[0])
            rr.update_frame()
        rr.reset_accumulation()
        rr.render_device()
    sky = frames[0]["albedo"][..., 3] == 0
    assert 0.05 < sky.mean() < 0.7, sky.mean()
    assert sky[0].all() and not sky[-1].any()
    return frames


def test_temporal_reprojection_matches_jax(gbufs):
    for k in (1, 2):
        cur, prev = gbufs[k], gbufs[k - 1]
        args = (cur["color"], cur["normal"], cur["pos"],
                cur["screen_motion"], prev["color"], prev["normal"],
                prev["pos"])
        want = jtemp.temporal_reprojection(*map(_j, args), 0.5)
        got = ttemp.temporal_reprojection(*map(_t, args), 0.5)
        agree(got, want, f"temporal frame {k}")
        # something was reused, and not everywhere
        assert 0 < float((got != _t(cur["color"])).float().mean()) < 1


def test_svgf_stages_match_jax(gbufs):
    """svgf_temporal (each package on its own state over 3 frames),
    svgf_atrous and svgf_hit_dist_reconstruction on the same inputs."""
    jp, tp = jsvgf.SVGFParams(), tsvgf.SVGFParams()
    js, ts = jsvgf.SVGFState.zeros(H, W), tsvgf.SVGFState.zeros(H, W, CPU)
    for k, g in enumerate(gbufs):
        motion = g["screen_motion"][..., :2]
        spec = g["reflection"]
        jspec = jsvgf.svgf_hit_dist_reconstruction(
            _j(spec), _j(g["normal"]), _j(g["pos"]),
            _j(g["metallic_roughness"][..., 1]), _j(g["cam_origin"]))
        tspec = tsvgf.svgf_hit_dist_reconstruction(
            _t(spec), _t(g["normal"]), _t(g["pos"]),
            _t(g["metallic_roughness"][..., 1]), _t(g["cam_origin"]))
        agree(tspec, jspec, f"hit distance frame {k}")
        args = (g["diffuse"], np.asarray(jspec), motion, g["normal"],
                g["pos"])
        jc, jv, js = jsvgf.svgf_temporal(jp, js, *map(_j, args))
        tc, tv, ts = tsvgf.svgf_temporal(tp, ts, *map(_t, args))
        agree(tc, jc, f"svgf temporal color frame {k}")
        agree(tv, jv, f"svgf temporal variance frame {k}")
        for name in tsvgf.SVGFState._fields:
            agree(getattr(ts, name), getattr(js, name), f"state {name}")
        atrous_in = (np.asarray(jc), np.asarray(jv), g["normal"],
                     g["view_z"])
        agree(tsvgf.svgf_atrous(tp, *map(_t, atrous_in)),
              jsvgf.svgf_atrous(jp, *map(_j, atrous_in)),
              f"svgf atrous frame {k}")
    assert float(ts.history_len.max()) == 3.0


def test_bmfr_matches_jax(gbufs):
    """_fit_blocks (the batched ridge solve, padded 40x36 -> 64x64) and
    bmfr_denoise, each package on its own state over 3 frames."""
    js = jbmfr.BMFRState.zeros(H, W)
    ts = tbmfr.BMFRState.zeros(H, W, CPU)
    for k, g in enumerate(gbufs):
        cur = np.concatenate([g["diffuse"][..., :3],
                              g["reflection"][..., :3]], -1)
        fit_in = (cur, g["normal"], g["pos"])
        want = jbmfr._fit_blocks(*map(_j, fit_in))
        agree(tbmfr._fit_blocks(*map(_t, fit_in)), want,
              f"bmfr fit frame {k}", atol=bmfr_atol(want))
        args = (g["diffuse"], g["reflection"],
                g["screen_motion"][..., :2], g["normal"], g["pos"],
                g["albedo"])
        jd, jsp, js = jbmfr.bmfr_denoise(js, *map(_j, args))
        td, tsp, ts = tbmfr.bmfr_denoise(ts, *map(_t, args))
        agree(td, jd, f"bmfr diffuse frame {k}", atol=bmfr_atol(jd))
        agree(tsp, jsp, f"bmfr specular frame {k}", atol=bmfr_atol(jsp))
    assert float(ts.history_len.max()) == 3.0


@pytest.mark.parametrize("edge_dilation", [True, False])
@pytest.mark.parametrize("anti_shimmer", [False, True])
def test_taa_matches_jax(gbufs, edge_dilation, anti_shimmer):
    jh = th = None
    for k, g in enumerate(gbufs):
        args = (g["screen_motion"][..., :2], g["view_z"])
        kw = dict(alpha=0.125, gamma=2.2, edge_dilation=edge_dilation,
                  anti_shimmer=anti_shimmer)
        src = g["color"]
        jo, jh = jtaa.taa(_j(src), jh if jh is not None else _j(src),
                          *map(_j, args), **kw)
        to, th = ttaa.taa(_t(src), th if th is not None else _t(src),
                          *map(_t, args), **kw)
        agree(to, jo, f"taa frame {k}")


def test_nonfinite_motion_takes_xla_taps():
    """Motion vectors that are NaN, infinite or far outside the image turn
    into pixel indices as XLA converts floats (NaN to 0, saturating), so
    every reprojection takes the same taps in both packages: the results
    agree to float rounding (1e-6), where another tap would differ by the
    difference of two random pixels."""
    rng = np.random.default_rng(3)
    h, w = 12, 16
    motion = rng.uniform(-0.2, 1.2, (h, w, 2)).astype(np.float32)
    bad = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 1e5], np.float32)
    motion.reshape(-1)[rng.choice(h * w * 2, 60, replace=False)] = \
        rng.choice(bad, 60)
    normal = np.tile(np.array([0, 1, 0], np.float32), (h, w, 1))
    pos = rng.normal(0, 0.01, (h, w, 3)).astype(np.float32)
    color = rng.uniform(0, 1, (h, w, 4)).astype(np.float32)
    prev = rng.uniform(0, 1, (h, w, 4)).astype(np.float32)
    depth = rng.uniform(1, 2, (h, w)).astype(np.float32)
    args = (color, normal, pos, motion, prev, normal, pos)

    def same(a, b):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    same(ttemp.temporal_reprojection(*map(_t, args), 0.5),
         jtemp.temporal_reprojection(*map(_j, args), 0.5))
    st = dict(color=np.tile(color[..., :3], 2), moments=color,
              history_len=depth, normal=normal, pos=pos)
    want = jsvgf._reproject(jsvgf.SVGFState(**{k: _j(v) for k, v in
                                                st.items()}),
                            _j(motion), _j(normal), _j(pos))
    got = tsvgf._reproject(tsvgf.SVGFState.from_numpy(st, CPU), _t(motion),
                           _t(normal), _t(pos))
    for a, b in zip(got, want):
        same(a, b)
    bst = dict(history=np.tile(color[..., :3], 2), history_len=depth,
               normal=normal, pos=pos)
    want = jbmfr._reproject_history(
        jbmfr.BMFRState(**{k: _j(v) for k, v in bst.items()}), _j(motion),
        _j(normal), _j(pos))
    got = tbmfr._reproject_history(tbmfr.BMFRState.from_numpy(bst, CPU),
                                   _t(motion), _t(normal), _t(pos))
    for a, b in zip(got, want):
        same(a, b)
    same(ttaa._bilinear(_t(prev), _t(motion[..., 0] * w),
                        _t(motion[..., 1] * h)),
         jtaa._bilinear(_j(prev), _j(motion[..., 0] * w),
                        _j(motion[..., 1] * h)))


def test_spatial_reprojection_matches_jax():
    """Two source views splat into a target view whose projection is the
    identity on x, y and w: every source pixel lands on a chosen target
    pixel centre at a chosen depth. Some target pixels receive two
    sources at clearly different depths (the nearer wins), some none, and
    some sources are invalid or behind the camera; no pixel has two
    winners, so both packages give the same image. Ties (several sources
    within 1e-6 of the winning depth) pick the highest source index."""
    rng = np.random.default_rng(5)
    S, h, w = 2, 8, 12
    n = S * h * w
    tx = rng.integers(0, w, n)
    ty = rng.integers(0, h, n)
    depth = rng.uniform(1.0, 9.0, n).astype(np.float32)
    # target uv of the pixel centre; x/w and y/w are what the projection
    # divides, so positions are (uv - 0.5) * 2 * depth
    u = (tx + 0.5) / w
    v = 1.0 - (ty + 0.5) / h
    pos = np.stack([(u - 0.5) * 2 * depth, (v - 0.5) * 2 * depth, depth],
                   -1).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    pos[rng.choice(n, 5, replace=False), 2] *= -1      # behind the camera
    vp = np.eye(4, dtype=np.float32)
    vp[3] = [0, 0, 1, 0]                               # w = z
    colors = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    args = (vp, colors.reshape(S, h, w, 4), pos.reshape(S, h, w, 3),
            valid.reshape(S, h, w))
    jc, jf = jtemp.spatial_reprojection(*map(_j, args))
    tc, tf = ttemp.spatial_reprojection(*map(_t, args))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert 0.3 < float(tf.float().mean()) < 1.0
    # a tie: two sources on one pixel at the same depth, nearer than any
    # other source
    pos2 = pos.copy()
    pos2[0] *= 0.5 / depth[0]
    pos2[1] = pos2[0]
    valid2 = valid.copy()
    valid2[:2] = True
    tc2, _ = ttemp.spatial_reprojection(
        _t(vp), _t(colors.reshape(S, h, w, 4)), _t(pos2.reshape(S, h, w, 3)),
        _t(valid2.reshape(S, h, w)))
    np.testing.assert_array_equal(tc2[ty[0], tx[0]].numpy(), colors[1])


@pytest.mark.parametrize("denoiser", ["svgf", "bmfr"])
def test_pipeline_from_jax_history(gbufs, denoiser):
    """PostProcessingPipeline with a denoiser, temporal reprojection and
    TAA: tauray_tpu's pipeline processes frames 0 and 1; the port's
    pipeline takes over its history (post_state_numpy, load_state_numpy)
    and both process frame 2."""
    from tauray_torch.options import Options as TOptions
    from tauray_tpu.options import Options as JOptions
    from tauray_tpu.renderer.post_processing import \
        PostProcessingPipeline as JPost

    def opt(cls):
        o = cls()
        o.denoiser = denoiser
        o.temporal_reprojection = 0.5
        o.taa.sequence_length = 8
        o.tonemap = "linear"
        return o
    jpost = JPost(opt(JOptions), W, H, 1)
    tpost_ = tpost.PostProcessingPipeline(opt(TOptions), W, H, 1, CPU)
    fields = [k for k in gbufs[0] if k != "cam_origin"]
    for g in gbufs[:2]:
        jpost.process({k: _j(g[k][None]) for k in fields},
                      cam_origin=g["cam_origin"][None])
    tpost_.load_state_numpy(tpost.post_state_numpy(jpost))
    g = gbufs[2]
    want = jpost.process({k: _j(g[k][None]) for k in fields},
                         cam_origin=g["cam_origin"][None])
    got = tpost_.process({k: _t(g[k][None]) for k in fields},
                         cam_origin=g["cam_origin"][None])
    agree(got, want, f"{denoiser} pipeline frame 2",
          atol=bmfr_atol(want) if denoiser == "bmfr" else 1e-4)
    state = tpost.post_state_numpy(tpost_)
    for k in ("prev_color", "prev_normal", "prev_pos"):
        agree(state[k], np.asarray(getattr(jpost, k)), k)


def _render_opt(cls, **kw):
    opt = cls()
    opt.width = opt.height = 16
    opt.samples_per_pixel = 1
    opt.max_ray_depth = 3
    opt.tonemap = "linear"
    for k, v in kw.items():
        if k == "taa":
            opt.taa.sequence_length = v
            opt.taa.edge_dilation = False
        else:
            setattr(opt, k, v)
    return opt


@pytest.mark.parametrize("post", [dict(denoiser="svgf"),
                                  dict(denoiser="bmfr"), dict(taa=8)])
def test_post_renders_match_jax(post):
    """Three animated 16x16 frames (1 spp, depth 3) through both
    packages' PathTracerRenderer with the post stage on. The last frame
    takes test_sponza_image_matches_jax's criterion (>= 99% of pixels
    within 1e-3 relative, image mean within 0.1%), where a pixel also
    agrees within 1e-4 absolute: TAA blends in x^2.2 and maps back, which
    grows the relative error of dark pixels (3 of 256 pixels of values
    below 3e-3 were off by up to 3.7e-5 when this was measured). TAA runs
    without edge
    dilation here. The dilation takes the motion of the 3x3 neighbour of
    least view depth, and on a floor seen without roll every pixel of an
    image row has the same view depth up to rounding (so do the sky
    pixels, which carry the depth of the first triangle's plane), so the
    neighbour it picks is decided by the last bits of the G-buffer. The
    two packages' G-buffers agree to 5e-6, and each package's TAA agrees
    with the other's on one G-buffer to 2.4e-7, yet on the two G-buffers
    the dilated frame differed by up to 1.24 (measured while writing this
    test): a one-pixel change of motion moves the history fetch.
    test_taa_matches_jax holds the dilation to tauray_tpu on one
    G-buffer."""
    from tauray_torch.options import Options as TOptions
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer as TPT
    from tauray_tpu.options import Options as JOptions
    from tauray_tpu.renderer.rt_renderer import PathTracerRenderer as JPT
    js, ts = anim_scene("tauray_tpu"), anim_scene("tauray_torch")
    jr, tr = JPT(_render_opt(JOptions, **post)), \
        TPT(_render_opt(TOptions, **post), CPU)
    jr.set_scene(js)
    tr.set_scene(ts)
    for k in range(3):
        if k:
            advance("tauray_tpu", js, FRAME_DT[0])
            advance("tauray_torch", ts, FRAME_DT[0])
            jr.update_frame()
            tr.update_frame()
        jr.reset_accumulation()
        tr.reset_accumulation()
        want = jr.render()[0][..., :3]
        got = tr.render()[0][..., :3]
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    within = float(((rel <= 1e-3) | (np.abs(got - want) <= 1e-4))
                   .all(axis=-1).mean())
    mean_rel = abs(float(got.mean()) / float(want.mean()) - 1.0)
    print(f"{post}: within {within:.4f}, mean rel {mean_rel:.2e}, "
          f"max abs {np.abs(got - want).max():.2e}")
    assert np.isfinite(got).all() and got.mean() > 0
    assert within >= 0.99
    assert mean_rel <= 1e-3


@pytest.mark.parametrize("denoiser", ["none", "svgf", "bmfr"])
def test_only_the_active_denoiser_holds_state(denoiser):
    """A renderer with no post stage keeps no denoiser history on the
    device (the plain frame's peak memory), and one with a denoiser keeps
    that denoiser's only, one per view."""
    from tauray_torch.options import Options
    from tauray_torch.renderer.rt_renderer import PathTracerRenderer
    opt = _render_opt(Options, denoiser=denoiser)
    rr = PathTracerRenderer(opt, CPU)
    rr.set_scene(anim_scene("tauray_torch"))
    assert rr.use_post == (denoiser != "none")
    assert len(rr.post.svgf_state) == (denoiser == "svgf")
    assert len(rr.post.bmfr_state) == (denoiser == "bmfr")
