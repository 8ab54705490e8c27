"""Port parity: the host-replay device plane (dist_dqn_tpu_torch/replay/
host.py ``DevicePrioritySampler``) and its three-level draw
(ops/sampler.py ``stratified_sample_rows``).

``stratified_sample_rows`` is held to the JAX package's XLA twin at
explicit uniforms on planes without ties, bit for bit; the port's plane on
the CPU follows the JAX plane through a seeded sequence of writes and
draws with equal picks, an equal mirror total and equal zeroing; and at
the host plane's shape ``[1954, 512]`` the kernel's plain version and the
three-level draw pick the same cells, to float32 rounding (the twin of
tests/test_device_sharded_sampling.py
``test_interpret_kernel_matches_xla_three_level_draw``). The kernel
itself runs on the card only (tests/test_torch_kernels_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu.ops import pallas_sampler as jps
from dist_dqn_tpu.replay.host import DevicePrioritySampler as JaxPlane
from dist_dqn_tpu_torch.ops import sampler as tps
from dist_dqn_tpu_torch.replay.host import DevicePrioritySampler


def _plane(rng, T, B, zero_frac=0.3):
    w = rng.uniform(0.1, 2.0, (T, B)).astype(np.float32)
    w[rng.uniform(size=(T, B)) < zero_frac] = 0.0
    return w


@pytest.mark.parametrize("T,B,S", [(8, 512, 64), (40, 512, 256),
                                   (100, 32, 16), (300, 64, 128)])
def test_stratified_sample_rows_matches_jax(T, B, S):
    """Equal (t, b, mass) bit for bit and total to rtol 1e-6, from the same
    block sums, at rows no longer than one scan block (the JAX package's
    CPU cumsum and the port's scan then add in one order)."""
    rng = np.random.default_rng(T + B)
    w = _plane(rng, T, B)
    blk = np.array(jnp.asarray(w).reshape(T, -1, tps.SAMPLE_BLOCK)
                   .sum(axis=2))
    u = ((np.arange(S) + rng.uniform(size=S)) / S).astype(np.float32)
    want = [np.asarray(x) for x in jps.stratified_sample_rows(
        jnp.asarray(w), jnp.asarray(blk), jnp.asarray(u))]
    got = [x.numpy() for x in tps.stratified_sample_rows(
        torch.from_numpy(w), torch.from_numpy(blk), torch.from_numpy(u))]
    for g, x in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, x)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)
    assert (got[2] > 0).all()


def _sequence(capacity: int, lanes: int, steps: int = 12, seed: int = 0):
    """A seeded sequence of write batches (with duplicate indices and
    zeros) and draws: (idx, mass, uniforms, size) per step."""
    rng = np.random.default_rng(seed)
    for k in range(steps):
        n = int(rng.integers(1, 3 * lanes))
        idx = rng.integers(0, capacity, n)
        mass = rng.uniform(0.0, 3.0, n).astype(np.float32)
        mass[rng.uniform(size=n) < 0.1] = 0.0
        S = 64
        u = (np.arange(S) + rng.uniform(size=S)) / S
        size = capacity if k % 3 else int(rng.integers(capacity // 2,
                                                       capacity))
        yield idx, mass, u, size


@pytest.mark.parametrize("capacity,lanes", [(4096, 512), (1000, 128),
                                            (3000, 64)])
def test_device_priority_sampler_follows_jax(capacity, lanes):
    """The port's plane on the CPU (the three-level torch draw) and the
    JAX plane (its XLA draw) through the same writes and draws: equal
    picks and masses, an equal mirror total after every write (float64,
    exact), equal zeroing of picks past ``size``; the plane itself equals
    the JAX plane bit for bit after every draw, and its block sums to
    float32 rounding."""
    ours = DevicePrioritySampler(capacity, lanes=lanes, device="cpu")
    jax_plane = JaxPlane(capacity, lanes=lanes, use_pallas=False)
    assert not ours.use_kernel
    for idx, mass, u, size in _sequence(capacity, lanes):
        for s in (ours, jax_plane):
            # Two writes per flush: the cross-batch last-wins pass.
            s.set(idx[: len(idx) // 2], mass[: len(idx) // 2])
            s.set(idx, mass)
        assert ours.total == jax_plane.total
        got = ours.sample_at(u, size)
        want = jax_plane.sample_at(u, size)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert (got[0] < size).all()
        np.testing.assert_array_equal(ours.plane.numpy(),
                                      np.asarray(jax_plane._plane))
        # The block sums reduce 32 lanes in each framework's own order:
        # equal to float32 rounding (rtol 1e-6).
        np.testing.assert_allclose(ours._blk_sums.numpy(),
                                   np.asarray(jax_plane._blk_sums),
                                   rtol=1e-6)
    assert ours.writeback_rows == jax_plane.writeback_rows
    assert ours.draw_dispatches == jax_plane.draw_dispatches


def test_device_priority_sampler_resums_its_total():
    """Every _TOTAL_RESUM_EVERY flushes the mirror's running total is
    re-summed exactly, as in the JAX plane."""
    ours = DevicePrioritySampler(2048, device="cpu")
    jax_plane = JaxPlane(2048, use_pallas=False)
    rng = np.random.default_rng(2)
    for _ in range(ours._TOTAL_RESUM_EVERY + 3):
        idx = rng.integers(0, 2048, 7)
        mass = rng.uniform(0, 1, 7).astype(np.float32)
        for s in (ours, jax_plane):
            s.set(idx, mass)
            s._flush_writes()
        assert ours.total == jax_plane.total
    assert ours.total == float(ours._mirror.sum()) or \
        ours._flushes % ours._TOTAL_RESUM_EVERY != 0


def test_kernel_plain_version_and_three_level_draw_agree_at_host_plane():
    """The apex preset's plane [1954, 512] (1M slots, the last 448 cells
    unwritten), drawn at stratum midpoints by the kernel's route (its plain
    version on the CPU) and by the three-level route at the same targets
    (the kernel aims at u * total * (1 - 1e-5), about 10 cells short of u
    * total at this total, so the three-level draw gets u * (1 - 1e-5)).
    The kernel sums in float64 and the three-level draw in float32, whose
    ulp at a total mass of 1.6e6 is 0.125 against cells of 0.2-3: bars,
    at least 95 % of the picks equal and every other one the next cell,
    each pick's mass that of its cell, none past the last slot."""
    capacity = 1_000_000
    kernel = DevicePrioritySampler(capacity, device="cpu", use_kernel=True)
    rows = DevicePrioritySampler(capacity, device="cpu", use_kernel=False)
    assert kernel.plane.shape == (1954, 512)
    rng = np.random.default_rng(5)
    pr = rng.uniform(0.2, 3.0, capacity).astype(np.float32)
    for s in (kernel, rows):
        s.set(np.arange(capacity), pr)
    u = (np.arange(512) + 0.5) / 512.0
    idx_k, mass_k = kernel.sample_at(u, capacity)
    idx_r, mass_r = rows.sample_at(u * (1.0 - 1e-5), capacity)
    assert np.mean(idx_k == idx_r) >= 0.95
    assert np.abs(idx_k - idx_r).max() <= 1
    np.testing.assert_array_equal(mass_k, pr[idx_k])
    np.testing.assert_array_equal(mass_r, pr[idx_r])
    assert max(idx_k.max(), idx_r.max()) < capacity


def test_kernel_route_counts_one_launch_per_draw(monkeypatch):
    """With the kernel's route, each draw calls its wrapper once: on the
    CPU the wrapper runs the plain version, and counts no launch."""
    calls = []
    real = tps.plain_stratified_sample
    monkeypatch.setattr(tps, "plain_stratified_sample",
                        lambda w, u: calls.append(w.shape) or real(w, u))
    plane = DevicePrioritySampler(200_000, device="cpu", use_kernel=True)
    plane.set(np.arange(1000), np.ones(1000, np.float32))
    before = tps.kernel_stratified_sample.launches
    for _ in range(3):
        plane.sample_at((np.arange(32) + 0.5) / 32, 200_000)
    assert tps.kernel_stratified_sample.launches == before
    assert calls == [(391, 512)] * 3


def test_device_priority_sampler_needs_a_device():
    """Like the entry points, the plane runs on the card unless asked for
    the CPU: without CUDA it raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DevicePrioritySampler(1024)
