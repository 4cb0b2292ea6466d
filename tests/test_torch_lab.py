"""The K1 labs (tauray_torch/lab/) against the TPU lab scripts they port,
scripts/kernel_lab8.py to kernel_lab11.py, on the CPU: the same seeded
numpy inputs go through each script's Pallas kernel in interpret mode
(pl.pallas_call patched to interpret=True inside the test; no file
changes) and through the lab's plain torch version, which the wrappers
take for CPU tensors.

Tolerances: L8 is exact (sums in the script's order, no products). The
Baldwin-Weber modes hold t within 1e-5, relative and absolute, the
tolerance of tests/test_torch_trace_mt.py (XLA:CPU contracts the products
into FMAs, torch does not: one ray of L10's wave differs by 1.43e-5 at
t = 0.5), and ids exactly; L11 mxu holds t within 1e-5
of |t| (at least 1) and ids equal except at exact ties of t, by
kernel_lab11.mxu_agreement, the rule chip_smoke holds the card to (here
no ray needs its FP64 rule for ill-conditioned rays)."""

import contextlib
import functools
import importlib.util
import io
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tauray_torch.app.kernel_waves import kernel_waves, retrace_slice
from tauray_torch.lab import common, kernel_lab8, kernel_lab9, \
    kernel_lab10, kernel_lab11, lab_kernel
from tauray_torch.ops import trace_kernel as tk

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"
CPU = torch.device("cpu")
SMALL = "proc://sponza?tris=8192"
T_TOL = 1e-5
N_TILES = 64


def _script(name, monkeypatch):
    """scripts/<name>.py as a module, its Pallas kernels in interpret
    mode."""
    monkeypatch.syspath_prepend(str(SCRIPTS))
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location(
        f"_lab_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_close(got, want, rtol=T_TOL, atol=T_TOL):
    """Raw (n_tiles, 32, 2) blocks: ids exact, t within the tolerance."""
    got = got.numpy()
    want = np.asarray(want)
    np.testing.assert_array_equal(got[..., 1].view(np.int32),
                                  want[..., 1].view(np.int32))
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def small_tracer():
    return common.scene_tracer(CPU, SMALL)


@pytest.fixture(scope="module")
def small_wave(small_tracer):
    """A signature-sorted bounce wave of 2,048 rays of the small scene, as
    kernel_lab10 takes it."""
    tracer, waves = kernel_waves(CPU, scene=SMALL, size=64)
    rays8 = retrace_slice(waves["bounce"], 2048)
    return tracer, kernel_lab10.wave_args(tracer, rays8)


# ---------------------------------------------------------------------------
# L8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("count", [0, 8, 16])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_lab8_matches_script(monkeypatch, mode, count):
    kl8 = _script("kernel_lab8", monkeypatch)
    o3, d3, mm2, _ = common.lab8_inputs(N_TILES * 32, seed=3)
    heads = np.random.default_rng(4).integers(
        -50, 1000, (N_TILES, common.KC)).astype(np.int32)
    counts = np.full(N_TILES, count, np.int32)
    counts[::5] = 0
    want = kl8.run_mode(jnp.asarray(counts), jnp.asarray(heads),
                        jnp.asarray(o3), jnp.asarray(d3), jnp.asarray(mm2),
                        mode)
    got = kernel_lab8.lab8(*map(_t, (counts, heads, o3, d3, mm2)), mode)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


def test_lab8_inputs_are_the_scripts(monkeypatch):
    """main's seeded inputs, captured from the script's own main with its
    kernel replaced, equal common.lab8_inputs bit for bit."""
    kl8 = _script("kernel_lab8", monkeypatch)
    seen = []

    def fake(counts, heads, o3, d3, mm2, mode):
        seen.append((np.asarray(heads), np.asarray(o3), np.asarray(d3),
                     np.asarray(mm2)))
        return jnp.zeros((1,))
    monkeypatch.setattr(kl8, "run_mode", fake)
    with contextlib.redirect_stdout(io.StringIO()):
        kl8.main()
    o3, d3, mm2, heads = common.lab8_inputs()
    for got, want in zip(seen[0], (heads, o3, d3, mm2)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# L9
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "exit", "loads", "math", "nocat"])
def test_lab9_matches_script(monkeypatch, small_tracer, mode):
    kl9 = _script("kernel_lab9", monkeypatch)
    tris12 = small_tracer.tris12
    C = small_tracer.n_clusters
    o3, d3, mm2, heads = common.lab9_inputs(C, N_TILES * 32, seed=5)
    for count in (8, 16, 32):
        counts = np.full(N_TILES, count, np.int32)
        want = kl9.run_mode(jnp.asarray(counts), jnp.asarray(heads),
                            jnp.asarray(o3), jnp.asarray(d3),
                            jnp.asarray(mm2), jnp.asarray(tris12.numpy()),
                            mode)
        got = kernel_lab9.lab9(*map(_t, (counts, heads, o3, d3, mm2)),
                               tris12, mode)
        _assert_close(got, want)
        if mode in ("full", "nocat"):
            assert (got[..., 1].view(torch.int32) >= 0).any()


def test_lab9_full_and_nocat_agree(small_tracer):
    """The concatenated step and the 8 per-cluster minima compute one
    function; the exit never fires on rays with t_max 1e30 and t > 0."""
    C = small_tracer.n_clusters
    o3, d3, mm2, heads = map(_t, common.lab9_inputs(C, N_TILES * 32, seed=6))
    counts = torch.full((N_TILES,), 32, dtype=torch.int32)
    outs = {m: kernel_lab9.lab9(counts, heads, o3, d3, mm2,
                                small_tracer.tris12, m)
            for m in ("full", "nocat", "exit")}
    assert torch.equal(outs["full"].view(torch.int32),
                       outs["nocat"].view(torch.int32))
    stats = {}
    kernel_lab9.lab9_reference(counts, heads, o3, d3, mm2,
                               small_tracer.tris12, "exit", stats)
    assert stats["steps"] == 4 * N_TILES
    assert kernel_lab9.lab9_exits(outs["exit"], C) == 0


def test_lab9_inputs_are_the_scripts(monkeypatch):
    """main's rays and heads, captured from the script's own main (its
    captured-table file and tracer replaced by a stub of C = 2,116
    clusters), equal common.lab9_inputs bit for bit."""
    kl9 = _script("kernel_lab9", monkeypatch)
    C = 2116

    class Stub:
        n_clusters = C
        tris12 = jnp.zeros((1,))
    seen = []

    def fake(counts, heads, o3, d3, mm2, tris12, mode):
        seen.append((np.asarray(heads), np.asarray(o3), np.asarray(d3),
                     np.asarray(mm2)))
        return jnp.zeros((1, 1, 2))
    monkeypatch.setattr(kl9.np, "load", lambda path: {
        "tri_pos": None, "tri_instance": None})
    monkeypatch.setattr(kl9, "build_cluster_tracer", lambda *a: (Stub, None))
    monkeypatch.setattr(kl9, "run_mode", fake)
    with contextlib.redirect_stdout(io.StringIO()):
        kl9.main()
    o3, d3, mm2, heads = common.lab9_inputs(C)
    for got, want in zip(seen[0], (heads, o3, d3, mm2)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# L10
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "noray", "fixord", "nowrite"])
def test_lab10_matches_script(monkeypatch, small_wave, mode):
    kl10 = _script("kernel_lab10", monkeypatch)
    tracer, (counts, keys, r3, idmask) = small_wave
    C = tracer.n_clusters
    # the script reads its heads (the first 128 keys) only: every tile
    # here has fewer clusters, where that equals the whole row
    assert 0 < int(counts.max()) <= common.KC
    # tiles with no cluster: one inside the first group, its last four
    # (the group's last active tile is then its 28th), and the whole
    # second group
    counts = counts.clone()
    counts[5] = 0
    counts[28:] = 0
    cpad = 1024 * (-(-(C + tk.KB) // 1024))
    kp = np.full((keys.shape[0], cpad), 0x7FFFFFFF, np.int32)
    kp[:, :C] = keys.numpy()
    jr = r3.numpy()
    want = kl10.run_mode(
        jnp.asarray(counts.numpy()), jnp.asarray(kp),
        jnp.asarray(jr[..., 0:3]), jnp.asarray(jr[..., 3:6]),
        jnp.asarray(jr[..., 6:8]), jnp.asarray(tracer.tris12.numpy()), mode,
        C, cpad, idmask)
    got = kernel_lab10.lab10(counts, keys, r3, tracer.tris12, mode, idmask)
    _assert_close(got, want)


def test_lab10_full_is_k1(small_wave):
    """full equals K1's plain version bit for bit (t where it hits, +inf
    against the pre-set best where it misses), a tile walking every one of
    the scene's clusters (past the script's 128 heads) included."""
    tracer, (counts, keys, r3, idmask) = small_wave
    counts, keys = counts.clone(), keys.clone()
    C = tracer.n_clusters
    counts[3] = C
    keys[3] = torch.arange(C, dtype=torch.int32)
    out = kernel_lab10.lab10(counts, keys, r3, tracer.tris12, "full", idmask)
    t, tid = tk.trace_tiles_vm3_reference(counts, keys, r3, tracer.tris12)
    ids = out[..., 1].reshape(-1).view(torch.int32)
    assert torch.equal(ids, tid)
    t_lab = torch.where(ids < 0, float("inf"), out[..., 0].reshape(-1))
    assert torch.equal(t_lab.view(torch.int32), t.view(torch.int32))
    assert bool((tid.reshape(-1, 32)[3] >= 0).any())


# ---------------------------------------------------------------------------
# L11
# ---------------------------------------------------------------------------

L11_SMALL = dict(C=16, n_tiles=8, n_steps=2)


@pytest.mark.parametrize("mode", ["vpu", "mxu"])
def test_lab11_matches_script(monkeypatch, mode):
    kl11 = _script("kernel_lab11", monkeypatch)
    steps, rays, tris12, m = common.lab11_inputs(seed=7, **L11_SMALL)
    tris = tris12 if mode == "vpu" else m
    want = np.asarray(kl11.run(
        jnp.asarray(steps), jnp.asarray(rays), jnp.asarray(tris), mode,
        L11_SMALL["n_steps"], L11_SMALL["C"], L11_SMALL["n_tiles"]))
    got = kernel_lab11.lab11(_t(steps), _t(rays), _t(tris), mode)
    assert (got[..., 1].view(torch.int32) >= 0).sum() >= 8
    if mode == "vpu":
        _assert_close(got, want)
    else:
        agree = kernel_lab11.mxu_agreement(got, _t(want.copy()),
                                           _t(rays), _t(m))
        assert agree["ok"] and agree["ill_conditioned"] == 0, agree


def test_lab11_tables_are_the_scripts(monkeypatch):
    """The script's own main, its kernel replaced, builds the rays, the
    rows and the (C, 3, 4, 128) table that common.lab11_inputs builds, bit
    for bit."""
    kl11 = _script("kernel_lab11", monkeypatch)
    seen = {}

    def fake(steps, rays, tris, mode, n_steps, C, n_tiles):
        seen[mode] = (np.asarray(steps), np.asarray(rays), np.asarray(tris))
        return jnp.zeros((n_tiles, common.TILE, 2), jnp.float32)
    monkeypatch.setattr(kl11, "run", fake)
    with contextlib.redirect_stdout(io.StringIO()):
        kl11.main()
    steps, rays, tris12, m = common.lab11_inputs()
    assert m.shape == (1024, 3, 4, 128) and m.dtype == np.float32
    for mode, tris in (("vpu", tris12), ("mxu", m)):
        for got, want in zip(seen[mode], (steps, rays, tris)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_mxu_agreement_flags_departures():
    """The tie-aware hold passes the plain version against itself and an
    exact tie, and counts a t moved by 1e-4 and a wrong triangle."""
    steps, rays, _, m = map(_t, common.lab11_inputs(seed=8, **L11_SMALL))
    ref = kernel_lab11.lab11(steps, rays, m, "mxu")
    agree = kernel_lab11.mxu_agreement(ref, ref, rays, m)
    assert agree["ok"] and agree["id_match"] == 1.0
    flat = ref.reshape(-1, 2).clone()
    ids = flat[:, 1].view(torch.int32)
    hit = torch.nonzero(ids >= 0).squeeze(1)
    a, b = int(hit[0]), int(hit[1])
    flat[a, 0] += 1e-4 * max(1.0, abs(float(flat[a, 0])))
    orig = int(ids[b])
    other = orig ^ 1                    # a neighbouring triangle
    flat[b, 1] = torch.tensor([other], dtype=torch.int32).view(
        torch.float32)[0]
    agree = kernel_lab11.mxu_agreement(flat.reshape(ref.shape), ref, rays, m)
    assert agree["rays_off"] == 2 and agree["ids_differ"] == 1
    assert agree["ill_conditioned"] == 0 and not agree["ok"]
    # the same triangle twice in the table: the second copy ties
    m2 = m.clone()
    c, lane = divmod(orig, common.CLUSTER)
    m2[c, :, :, lane ^ 1] = m2[c, :, :, lane]
    agree = kernel_lab11.mxu_agreement(flat.reshape(ref.shape), ref, rays,
                                       m2)
    assert agree["rays_off"] == 1 and agree["ties"] == 1


# ---------------------------------------------------------------------------
# Entry points, the build, the wrappers
# ---------------------------------------------------------------------------

def test_lab8_entry_point_on_the_cpu(capsys):
    assert kernel_lab8.main(["--device=cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6
    assert lines[0].startswith("mode0 (write-only) counts=  0:")
    assert lines[-1].startswith("mode3 (+while(count/8) smem reads) "
                                "counts= 16:")
    assert all("host ms (cpu plain)" in ln and "us/tile" in ln
               for ln in lines)


@pytest.mark.parametrize("lab", [kernel_lab8, kernel_lab9, kernel_lab10,
                                 kernel_lab11],
                         ids=["L8", "L9", "L10", "L11"])
def test_lab_entry_point_needs_a_card(monkeypatch, lab):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        lab.main([])


def test_k1_lab_builds_beside_trace_tiles(monkeypatch, tmp_path):
    """build_all compiles csrc/k1_lab.cu, brick_lab.cu, tile_lab.cu and
    mxu_lab.cu with trace_tiles.cu's nvcc flags (sm_90a, -fmad=false), one
    process per source started together, into the build directory, and
    binds each lab's launch function; nothing is built at import."""
    calls = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            calls.append(cmd)
            pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")

        def communicate(self):
            return ("",)

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn
    monkeypatch.setattr(tk, "_libs", {})
    monkeypatch.setattr(tk, "BUILD_INFO", {})
    monkeypatch.setattr(tk, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tk, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(tk.subprocess, "Popen", Proc)
    monkeypatch.setattr(tk.ctypes, "CDLL", lambda path: Lib())
    libs = tk.build_all()
    labs = ["brick_lab", "k1_lab", "mxu_lab", "tile_lab"]
    assert sorted(libs) == sorted(labs + ["trace_tiles"])
    srcs = {pathlib.Path(c[-1]).name: c for c in calls}
    assert sorted(srcs) == sorted(f"{n}.cu" for n in labs + ["trace_tiles"])
    for cmd in srcs.values():
        assert cmd[1:1 + len(tk.NVCC_FLAGS)] == tk.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in tk.NVCC_FLAGS
    assert "-fmad=false" in tk.NVCC_FLAGS
    for name in labs:
        fn = getattr(libs[name], f"{name}_launch")
        assert fn.argtypes == tk._ARGTYPES[f"{name}_launch"]
    assert all(p.parent == tmp_path for p in map(
        lambda c: pathlib.Path(tk.BUILD_INFO[c]["path"]), libs))


def test_lab_wrappers_take_no_other_device():
    o3 = torch.zeros((32, 32, 3), device="meta")
    with pytest.raises(ValueError, match="no lab kernel"):
        kernel_lab8.lab8(torch.zeros(32, dtype=torch.int32), None, o3, o3,
                         None, 1)
    with pytest.raises(ValueError, match="no mode"):
        kernel_lab10.lab10_reference(*[None] * 4, "nope", 1)


def test_mxu_t64_bounds_the_fp32_t():
    """mxu_t64's FP64 t of each hit's triangle lies within its bound of the
    plain FP32 t (whose own error is 8 times smaller than the bound's
    per-product rate), and a ray moved off by more than its bound is not
    rescued by the FP64 rule."""
    steps, rays, _, m = map(_t, common.lab11_inputs(seed=9, **L11_SMALL))
    ref = kernel_lab11.lab11(steps, rays, m, "mxu")
    flat = ref.reshape(-1, 2)
    ids = flat[:, 1].view(torch.int32)
    hit = torch.nonzero(ids >= 0).squeeze(1)
    t64, bound = kernel_lab11.mxu_t64(rays.reshape(-1, 8)[hit], m, ids[hit])
    assert bool(((flat[hit, 0].double() - t64).abs() <= bound).all())
    assert bool((bound > 0).all())
    moved = flat.clone()
    i = int(hit[0])
    moved[i, 0] += max(1e-4, 4 * float(bound[0]))
    agree = kernel_lab11.mxu_agreement(moved.reshape(ref.shape), ref, rays, m)
    assert agree["rays_off"] == 1 and agree["ill_conditioned"] == 0


def test_lab_bounds_name_every_lab_kernel(capsys):
    """python -m tauray_torch.lab.bounds gives a bound to every lab kernel
    of scripts/ (L10's comes from its wave, in chip_smoke), each at the
    site tests/test_torch_coverage.py accounts for."""
    from tauray_torch.lab import bounds
    from test_torch_coverage import PALLAS_SITES
    assert bounds.main() == 0
    lines = capsys.readouterr().out.splitlines()
    labs = {ln.split(":")[0].split()[0] for ln in lines}
    assert labs == {f"L{i}" for i in range(1, 13)} - {"L10"}
    for lab, site, _, ms, by in bounds.rows():
        assert site in PALLAS_SITES and ms > 0 and by in ("operations",
                                                         "bytes")
