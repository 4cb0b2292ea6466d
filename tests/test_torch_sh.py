"""Spherical harmonics (ops/sh.py), the SH probe bake
(renderer/sh_renderer.py) and restir-hybrid of tauray_torch against
tauray_tpu's.

The basis and its lookups on seeded directions hold to 1e-5 relative
(tests/test_torch_shading.py's rule). The bake path-traces a 2x2x2 grid
of the room of tests/test_torch_restir.py in both packages from the same
seeds; tauray_tpu's bake runs its jitted bounce programs, where XLA:CPU
contracts multiply-adds into FMAs. A probe's coefficients are a sum over
its 64 samples: every coefficient within BAKE_TOL (1e-5) of the grid's
largest magnitude, the mean within 1e-6 of it (measured: 8.4e-8 and 0;
a grazing ray that flipped would move a coefficient by about 1/64).

tauray_tpu's restir-hybrid multiplies the probe grid's four channels
(RGB and the visibility distance) by the RGB albedo and raises; the port
lights RGB only. The render test runs tauray_tpu's renderer with that one
repair patched into its irradiance lookup (tauray_tpu's files stay as
they are)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauray_torch.ops import sh as tsh
from tauray_torch.renderer import sh_renderer as tshr
from tauray_tpu.ops import sh as jsh

from test_torch_restir import frames, hold_images, renderers, room_scene
from test_torch_shading import _close, _unit

torch.set_num_threads(2)

BAKE_TOL = 1e-5


@pytest.mark.parametrize("order", [0, 1, 2, 3, 4])
def test_sh_basis(order):
    d = _unit(np.random.default_rng(order))
    _close(tsh.sh_basis(torch.from_numpy(d), order),
           jsh.sh_basis(jnp.asarray(d), order), f"basis {order}")


@pytest.mark.parametrize("order", [2, 4])
def test_projection_and_lookups(order):
    """project_radiance, eval_irradiance, eval_ggx_specular (with the
    fitted zonal curve) on random coefficients, normals and roughness."""
    rng = np.random.default_rng(10 + order)
    d = _unit(rng)
    rad = rng.random((d.shape[0], 3), dtype=np.float32)
    _close(tsh.project_radiance(torch.from_numpy(d), torch.from_numpy(rad),
                                order),
           jsh.project_radiance(jnp.asarray(d), jnp.asarray(rad), order),
           "project", rtol=1e-4)
    C = (order + 1) ** 2
    coef = rng.standard_normal((d.shape[0], C, 3)).astype(np.float32)
    n = _unit(rng)
    _close(tsh.eval_irradiance(torch.from_numpy(coef), torch.from_numpy(n),
                               order),
           jsh.eval_irradiance(jnp.asarray(coef), jnp.asarray(n), order),
           "irradiance", atol=1e-5)
    rough = rng.random(d.shape[0], dtype=np.float32)
    _close(tsh._ggx_zh_fitted(torch.from_numpy(rough)),
           jsh._ggx_zh_fitted(jnp.asarray(rough)), "zh", atol=1e-5)
    ref = rng.standard_normal((d.shape[0], 3)).astype(np.float32)
    _close(tsh.eval_ggx_specular(torch.from_numpy(coef),
                                 torch.from_numpy(ref),
                                 torch.from_numpy(rough), order),
           jsh.eval_ggx_specular(jnp.asarray(coef), jnp.asarray(ref),
                                 jnp.asarray(rough), order),
           "ggx specular", atol=1e-5)


def test_ggx_zh_table_and_host_pcg():
    """The numpy Legendre fit and the host PCG are copies: equal."""
    from tauray_tpu.renderer import sh_renderer as jshr
    np.testing.assert_array_equal(tsh._ggx_zh_table(4),
                                  jsh._ggx_zh_table(4))
    for s in (0, 1, 977, 2 ** 32 + 5, 123456789):
        assert tshr._pcg_host(s) == jshr._pcg_host(s)


def _grid_room(pkg):
    return room_scene(pkg, panel=False, grid=True)


@pytest.fixture(scope="module")
def hybrid_pair():
    """(port, tauray_tpu) restir-hybrid renderers on the room with its SH
    grid: depth 2, 64 samples a probe."""
    return renderers(_grid_room, hybrid=True, max_ray_depth=2,
                     samples_per_probe=64)


def test_sh_bake_matches_jax(hybrid_pair):
    """Three bake frames of the 2x2x2 grid: the probe coefficients after
    each step (the first frame a plain bake, then the running mean of
    _blend_coefficients)."""
    t, j = hybrid_pair
    for k in range(3):
        t.sh_source.step(t)
        j.sh_source.step(j)
        got, w2l_t = t.sh_source.current_grid_data()
        want, w2l_j = j.sh_source.current_grid_data()
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape == (2, 2, 2, 9, 4)
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max()) / scale
        mean = abs(float(got.mean() - want.mean())) / scale
        print(f"bake frame {k}: max |diff| {err:.3e}, mean diff "
              f"{mean:.3e} of the largest coefficient {scale:.4g}")
        assert err <= BAKE_TOL and mean <= 1e-6, (k, err, mean)
        np.testing.assert_allclose(w2l_t.numpy(), np.asarray(w2l_j),
                                   rtol=1e-6, atol=1e-6)
    assert t.sh_source.frame == 3


def test_blend_coefficients():
    """The first frame takes the bake; later ones blend by the ratio."""
    rng = np.random.default_rng(4)
    prev, coef = (rng.random((2, 2, 2, 9, 4), dtype=np.float32)
                  for _ in range(2))
    for first, ratio in ((True, 1.0), (False, 0.5), (False, 1 / 3),
                         (False, 0.02)):
        got = tshr._blend_coefficients(torch.from_numpy(prev),
                                       torch.from_numpy(coef), ratio, first)
        want = jax.jit(lambda p, c, r: p * (1.0 - r) + c * r)(
            jnp.asarray(prev), jnp.asarray(coef), jnp.float32(ratio)) \
            if not first else jnp.asarray(coef)
        _close(got, want, f"blend {ratio}", rtol=1e-6, atol=1e-7)


def test_multi_device_bake_is_not_offered():
    """On one device --mesh-shape and --fake-devices do not shard the bake
    (tauray_tpu shards it only when len(jax.devices()) > 1): the renderer
    builds with a one-device bake; an explicit device list shards it
    (tests/test_torch_distributed.py)."""
    from tauray_torch.options import parse_command_line_options
    from tauray_torch.renderer.restir_renderer import ReSTIRRenderer
    for flag in ("--mesh-shape=2", "--fake-devices=2"):
        opt = parse_command_line_options(["--renderer=restir-hybrid", flag,
                                          "x.glb"])
        rr = ReSTIRRenderer(opt, "cpu", hybrid=True)
        assert rr.sh_source.devices is None


@pytest.fixture
def rgb_irradiance(monkeypatch):
    """tauray_tpu's eval_irradiance as restir-hybrid reads it, with the
    port's repair: RGB only."""
    orig = jsh.eval_irradiance
    monkeypatch.setattr(jsh, "eval_irradiance",
                        lambda c, n, o: orig(c, n, o)[..., :3])


@pytest.mark.parametrize("denoiser", ["none", "svgf"])
def test_hybrid_render_matches_jax(rgb_irradiance, denoiser):
    """restir-hybrid (DI + the nearest probe's irradiance, no GI), 3
    frames, with and without SVGF: the frames as tests/test_torch_restir
    holds DI's, the image means within 1e-3 relative."""
    t, j = renderers(_grid_room, hybrid=True, max_ray_depth=2,
                     samples_per_probe=64, denoiser=denoiser)
    got, want = frames(t, 3), frames(j, 3)
    hold_images(got, want, f"hybrid {denoiser}")
    assert t.gi_cfg is None and t.sh_source.current_grid_data() is not None


def test_nearest_probe_lookup():
    """The hybrid lookup against tauray_tpu's expression (with the RGB
    repair): the nearest probe by truncation, clipped to the grid, for
    points inside, outside and non-finite."""
    from tauray_torch.renderer.restir_renderer import \
        nearest_probe_irradiance
    rng = np.random.default_rng(6)
    H, W = 8, 12
    coef = rng.standard_normal((2, 3, 4, 9, 4)).astype(np.float32)
    w2l = np.eye(4, dtype=np.float32)
    w2l[:3, :3] = rng.standard_normal((3, 3)) * 0.3
    w2l[:3, 3] = rng.standard_normal(3) * 0.2
    pos = rng.uniform(-4, 4, (H, W, 3)).astype(np.float32)
    pos[0, :3] = [np.nan, np.inf, -np.inf]
    n = _unit(rng, H * W).reshape(H, W, 3)
    got = nearest_probe_irradiance(*(torch.from_numpy(x) for x in (
        coef, w2l, pos, n)), 2)
    local = jnp.einsum("ij,hwj->hwi", w2l[:3, :3], pos) + w2l[:3, 3]
    rz, ry, rx = coef.shape[:3]
    g = jnp.clip(((local * 0.5 + 0.5) *
                  jnp.array([rx, ry, rz])).astype(jnp.int32),
                 0, jnp.array([rx - 1, ry - 1, rz - 1]))
    c = jnp.asarray(coef)[g[..., 2], g[..., 1], g[..., 0]]
    want = jsh.eval_irradiance(c, jnp.asarray(n), 2)[..., :3]
    fin = np.isfinite(pos).all(-1)
    _close(got.numpy()[fin], np.asarray(want)[fin], "lookup", atol=1e-5)
    # non-finite points: XLA's conversion (NaN -> 0, +-inf saturated, then
    # clipped) picks the same probe
    _close(got.numpy()[~fin], np.asarray(want)[~fin], "lookup non-finite",
           atol=1e-5)


def test_denoised_restir_shows_di_only():
    """A quirk of tauray_tpu's renderer, kept: with a denoiser on, the
    denoiser reads DI alone (against a white albedo) and the image is its
    output plus emission, so GI, the SH term and the sky leave the image.
    restir-hybrid with SVGF equals DI-only ReSTIR with SVGF; without a
    denoiser the sky pixels are the environment factor."""
    from tauray_torch.options import Options
    from tauray_torch.renderer.restir_renderer import ReSTIRRenderer
    out = {}
    for hybrid, den in ((True, "svgf"), (False, "svgf"), (True, "none")):
        opt = Options()
        opt.width = opt.height = 16
        opt.tonemap = "linear"
        opt.max_ray_depth = 1 if not hybrid else 2
        opt.samples_per_probe = 16
        opt.denoiser = den
        rr = ReSTIRRenderer(opt, "cpu", hybrid=hybrid)
        rr.set_scene(_grid_room("tauray_torch"))
        out[hybrid, den] = [rr.render()[0] for _ in range(2)]
        if den == "none":
            sky = rr.prev_inst.numpy() < 0
            assert sky.any()
            np.testing.assert_array_equal(
                out[hybrid, den][-1][sky][:, :3],
                np.broadcast_to(rr.device_scene.env_factor[:3].numpy(),
                                (int(sky.sum()), 3)))
    for a, b in zip(out[True, "svgf"], out[False, "svgf"]):
        np.testing.assert_array_equal(a, b)
    assert out[True, "none"][-1][..., :3].mean() > \
        out[True, "svgf"][-1][..., :3].mean()
