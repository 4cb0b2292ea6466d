"""tauray_torch.parallel (distribution, stitch, load balancer) against
tauray_tpu.parallel on seeded inputs: the index math bit for bit, the
stitch and the EMA equal, and the over-cap fault of tauray_tpu's
distributed renderer shown on its own index math."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauray_torch.parallel import distribution as TD
from tauray_torch.parallel.load_balancer import LoadBalancer as TLB
from tauray_tpu.parallel import distribution as JD
from tauray_tpu.parallel.load_balancer import LoadBalancer as JLB

torch.set_num_threads(2)

STRATEGIES = [TD.SCANLINE, TD.SHUFFLED_STRIPS]
SIZES = [(64, 48), (37, 23), (8, 8), (5, 3), (1920, 1080)]


@pytest.mark.parametrize("size", SIZES)
def test_permute_region_id_and_b(size):
    """b, the region size and the bit-reversal permutation, including
    b = 0 (fewer than 256 pixels: the shift by 32 gives 0, as in XLA) and
    indices past the frame."""
    b = TD.calculate_shuffled_strips_b(size)
    assert b == JD.calculate_shuffled_strips_b(size)
    n = size[0] * size[1]
    assert TD.get_region_size(n, b) == JD.get_region_size(n, b)
    rng = np.random.default_rng(n)
    i = np.concatenate([np.arange(min(n, 4096), dtype=np.uint32),
                        rng.integers(0, 2 * n + 2, 512).astype(np.uint32),
                        np.array([n, n + 1, 2 ** 32 - 1], np.uint32)])
    got = TD.permute_region_id(i, size, b)
    want = np.asarray(JD.permute_region_id(i, size, b))
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    for bb in (0, 1, b):
        np.testing.assert_array_equal(
            TD.permute_region_id(i, size, bb),
            np.asarray(JD.permute_region_id(i, size, bb)))


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("n_dev", [2, 3, 8])
def test_device_pixel_positions(strategy, n_dev):
    """Every device's params, render count and (pix, valid, lin), even and
    seeded uneven workloads, at the static max count and past it."""
    rng = np.random.default_rng(n_dev)
    for size in ((64, 48), (37, 23)):
        mc = TD.get_distribution_max_count(size, strategy, n_dev)
        assert mc == JD.get_distribution_max_count(size, strategy, n_dev)
        for weights in (np.full(n_dev, 1.0 / n_dev),
                        rng.dirichlet(np.ones(n_dev))):
            cum = 0.0
            for i, w in enumerate(weights):
                args = (size, strategy, cum, float(w), i, n_dev, i == 0)
                p = TD.get_device_distribution_params(*args)
                assert p.__dict__ == \
                    JD.get_device_distribution_params(*args).__dict__
                assert TD.get_distribution_render_count(p) == \
                    JD.get_distribution_render_count(p)
                if strategy == TD.SHUFFLED_STRIPS:
                    cum += float(w)
                for count in (mc, mc + 77):
                    for g, j in zip(TD.device_pixel_positions(p, count),
                                    JD.device_pixel_positions(p, count)):
                        assert g.dtype == np.asarray(j).dtype
                        np.testing.assert_array_equal(g, np.asarray(j))


def _chunks(rng, D, N, total, V=None, C=4, partial=False):
    """Seeded chunks with a permutation of the frame's pixels spread over
    D devices (the tail lanes invalid), and with partial a quarter of the
    pixels left to no device."""
    lin = rng.permutation(total)[:D * N].reshape(D, N).astype(np.int32)
    valid = np.ones((D, N), bool)
    valid[:, -3:] = False
    if partial:
        valid &= rng.random((D, N)) > 0.25
    shape = (D, N, C) if V is None else (D, V, N, C)
    return rng.standard_normal(shape).astype(np.float32), lin, valid


@pytest.mark.parametrize("blend", [1.0, 0.25, 0.1])
@pytest.mark.parametrize("partial", [False, True])
def test_stitch(blend, partial):
    rng = np.random.default_rng(int(blend * 100) + partial)
    H, W = 12, 20
    chunks, lin, valid = _chunks(rng, 3, 80, H * W, partial=partial)
    old = rng.standard_normal((H, W, 4)).astype(np.float32)
    got = TD.stitch((H, W), torch.from_numpy(chunks), torch.from_numpy(lin),
                    torch.from_numpy(valid), torch.from_numpy(old), blend)
    want = JD.stitch((H, W), jnp.asarray(chunks), jnp.asarray(lin),
                     jnp.asarray(valid), jnp.asarray(old), blend)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if blend < 1.0:
        # pixels no device covered keep the old value
        cover = np.zeros(H * W, bool)
        cover[lin[valid]] = True
        np.testing.assert_array_equal(got.numpy().reshape(-1, 4)[~cover],
                                      old.reshape(-1, 4)[~cover])


def _accumulate_inputs(seed, partial):
    rng = np.random.default_rng(seed)
    H, W, V = 8, 16, 2
    chunks, lin, valid = _chunks(rng, 4, 30, H * W, V=V, partial=partial)
    old = rng.standard_normal((V, H, W, 4)).astype(np.float32)
    return (H, W), chunks, lin, valid, old


def _accumulate_pair(inputs, t):
    shape, chunks, lin, valid, old = inputs
    got = TD.stitch_accumulate(shape, *map(torch.from_numpy, (
        chunks, lin, valid, old)), t)
    want = JD.stitch_accumulate(shape, *map(jnp.asarray, (
        chunks, lin, valid, old)), jnp.float32(t))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("t", [0.0, 0.75, 0.5])
@pytest.mark.parametrize("partial", [False, True])
def test_stitch_accumulate(t, partial):
    """(D, V, N, 4) chunks into a (V, H, W, 4) accumulation, blended with
    t as a float32: replace (blend 1), blend 0.25 and the running mean of
    the second sample, whose products are exact; bit for bit. Pixels no
    lane covers keep the old value."""
    inputs = _accumulate_inputs(int(t * 1000) + 7 * partial, partial)
    got, want = _accumulate_pair(inputs, t)
    np.testing.assert_array_equal(got, want)
    _, _, lin, valid, old = inputs
    cover = np.zeros(old.shape[1] * old.shape[2], bool)
    cover[lin[valid]] = True
    np.testing.assert_array_equal(got.reshape(2, -1, 4)[:, ~cover],
                                  old.reshape(2, -1, 4)[:, ~cover])


@pytest.mark.parametrize("partial", [False, True])
def test_stitch_accumulate_running_mean(partial):
    """t = 2/3 (the third sample's running mean): XLA:CPU contracts
    new * (1 - t) + old * t into fma(new, 1 - t, old * t) and the port does
    not (ROADMAP, FMA), so the two differ by one rounding of the product
    new * (1 - t): at most 2^-23 of the terms' magnitude. tauray_tpu's
    result equals that fma of the same inputs bit for bit."""
    t = np.float32(2.0 / 3.0)
    inputs = _accumulate_inputs(11 + partial, partial)
    got, want = _accumulate_pair(inputs, t)
    new, _ = _accumulate_pair(inputs, 0.0)      # the stitched new values
    old = inputs[-1]
    terms = np.abs(new) * (np.float32(1) - t) + np.abs(old) * t
    assert (np.abs(got - want) <= terms * 2.0 ** -23).all()
    # the product new * (1 - t) is exact in float64
    fma = (new.astype(np.float64) * (np.float32(1) - t) +
           (old * t)).astype(np.float32)
    cover = new != old
    np.testing.assert_array_equal(want[cover], fma[cover])


class _Sink:
    def set_device_workloads(self, w):
        self.w = list(w)


@pytest.mark.parametrize("n", [2, 3, 8])
def test_load_balancer_ema(n):
    """The EMA (alpha 0.1) over 20 updates of seeded skewed times, with
    initial weights, zero times and a NaN time: equal workloads, and the
    renderer receives them."""
    rng = np.random.default_rng(n)
    for init in (None, list(rng.random(n - 1))):
        t, j = TLB(n, init), JLB(n, init)
        assert t.workloads == j.workloads
        rt, rj = _Sink(), _Sink()
        for k in range(20):
            times = list(rng.random(n) + 0.05)
            if k == 5:
                times[0] = 0.0
            if k == 9:
                times[-1] = float("nan")
            assert t.update(rt, times) == j.update(rj, times)
            assert rt.w == rj.w == t.workloads
        assert abs(sum(t.workloads) - 1.0) < 1e-9


def _coverage(mod, size, workloads, max_count=None):
    """Each frame pixel's cover count under shuffled strips with
    `workloads`, slots cut at max_count (tauray_tpu's static budget) or,
    with None, each device's whole share."""
    total = size[0] * size[1]
    seen = np.zeros(total, np.int32)
    cum = 0.0
    for i, w in enumerate(workloads):
        ratio = min(max(w, 0.0), 1.0 - cum)
        p = mod.get_device_distribution_params(
            size, mod.SHUFFLED_STRIPS, cum, ratio, i, len(workloads), i == 0)
        cum += ratio
        count = max_count or mod.get_distribution_render_count(p)
        _, valid, lin = mod.device_pixel_positions(p, count)
        np.add.at(seen, np.asarray(lin)[np.asarray(valid)], 1)
    return seen


def test_over_cap_drops_pixels_in_tauray_tpu():
    """tauray_tpu caps a shuffled-strips device at ceil(4WH / (128 D)) *
    128 slots (renderer/distributed.py:71-76), and its clamp
    `valid[max_count:] = False` cannot act on an array of that length: a
    share past the cap loses the rest of its pixels. D = 8 at 32x32 with
    0.9 on device 0 (the cap is 512 of its 922 pixels): 40.0% of the
    frame is left to no device. The port's renderer takes each device's
    whole share (its render count), which covers every pixel once."""
    size, D = (32, 32), 8
    cap = -(-(4 * size[0] * size[1]) // (128 * D)) * 128
    assert cap == 512
    w = [0.9] + [0.1 / 7] * 7
    jax_seen = _coverage(JD, size, w, cap)
    assert round(float((jax_seen == 0).mean()), 3) == 0.400
    assert (jax_seen <= 1).all()
    port_seen = _coverage(TD, size, w)
    assert (port_seen == 1).all()
    # within the cap the two agree pixel for pixel
    even = [1.0 / D] * D
    np.testing.assert_array_equal(_coverage(JD, size, even, cap),
                                  _coverage(TD, size, even))
