"""Port parity: the priority sampler (dist_dqn_tpu_torch/ops/sampler.py).

The kernel's plain PyTorch version is held against the JAX package's
Pallas kernel run in interpret mode, on the cases and bars of
tests/test_pallas_sampler.py; the non-kernel draw against the JAX XLA
path, whose scan of fixed order (``fixed_order_cumsum``) draws the same
picks call after call; ``importance_weights`` against its JAX twin. The
CUDA kernel itself runs only on the card (tests/test_torch_kernels_cuda.py,
and chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu.ops import pallas_sampler as jps
from dist_dqn_tpu_torch.ops import sampler as tps
from torch_sampler_model import model_draw


def _mass(rng, T, B, zero_frac=0.3):
    w = rng.uniform(0.1, 2.0, (T, B)).astype(np.float32)
    w[rng.uniform(size=(T, B)) < zero_frac] = 0.0
    return w


def _uniforms(rng, S):
    return ((np.arange(S) + rng.uniform(size=S)) / S).astype(np.float32)


def _both(w, u):
    pallas = tuple(map(np.asarray, jps.pallas_stratified_sample(
        jnp.asarray(w), jnp.asarray(u), interpret=True)))
    plain = tuple(x.numpy() for x in tps.plain_stratified_sample(
        torch.from_numpy(w), torch.from_numpy(u)))
    return pallas, plain


def test_plain_matches_pallas_and_numpy_reference():
    rng = np.random.default_rng(0)
    T, B, S = 300, 16, 64
    w = _mass(rng, T, B)
    u = _uniforms(rng, S)
    (tj, bj, pj, totj), (t, b, p, tot) = _both(w, u)
    cdf = np.cumsum(w.reshape(-1).astype(np.float64))
    ref = np.searchsorted(cdf, u * tot * (1.0 - 1e-5), side="right")
    # Bars of test_pallas_sampler.py, for both implementations, and their
    # agreement with each other.
    for tt, bb, pp, total in ((t, b, p, tot), (tj, bj, pj, totj)):
        assert np.mean((tt * B + bb) == ref) >= 0.98
        np.testing.assert_allclose(pp, w[tt, bb], rtol=1e-6)
        np.testing.assert_allclose(total, cdf[-1], rtol=1e-5)
    assert np.mean((t == tj) & (b == bj)) >= 0.98
    assert t.dtype == np.int32 and b.dtype == np.int32
    assert p.dtype == np.float32 and tot.dtype == np.float32


@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
def test_wide_path_model_and_plain_match_pallas(zero_frac):
    """A small wide plane ([64, 512], S = 64), which the kernel draws on its
    wide-row path: the numpy model of that path and the plain version both
    meet the bars against the Pallas kernel in interpret mode, and pick
    the same cells as each other."""
    rng = np.random.default_rng(9)
    T, B, S = 64, 512, 64
    assert tps.launch_geometry(T, S, B=B).wide
    w = _mass(rng, T, B, zero_frac)
    u = _uniforms(rng, S)
    (tj, bj, pj, totj), (t, b, p, tot) = _both(w, u)
    tm, bm, pm, totm = model_draw(w, u)
    for tt, bb, pp, total in ((t, b, p, tot), (tm, bm, pm, totm)):
        assert np.mean((tt == tj) & (bb == bj)) >= 0.98
        np.testing.assert_allclose(pp, w[tt, bb], rtol=1e-6)
        np.testing.assert_allclose(total, totj, rtol=1e-5)
        assert (pp > 0).all()
    np.testing.assert_array_equal(tm, t)
    np.testing.assert_array_equal(bm, b)


def test_plain_never_selects_zero_mass():
    rng = np.random.default_rng(1)
    T, B, S = 700, 8, 128                   # the Pallas padding case
    w = _mass(rng, T, B, zero_frac=0.9)
    u = _uniforms(rng, S)
    (tj, bj, _, _), (t, b, p, _) = _both(w, u)
    assert (p > 0).all()
    assert (w[t, b] > 0).all()
    assert (t < T).all()
    assert np.mean((t == tj) & (b == bj)) >= 0.98


def test_plain_distribution_tracks_mass():
    rng = np.random.default_rng(2)
    T, B, S = 64, 4, 4096
    w = _mass(rng, T, B, zero_frac=0.5)
    u = _uniforms(rng, S)
    (tj, bj, _, _), (t, b, _, _) = _both(w, u)
    counts = np.zeros((T, B))
    np.add.at(counts, (t, b), 1.0)
    expect = w / w.sum() * S
    assert np.abs(counts - expect).max() < 2.0   # stratified: within 2
    assert np.mean((t == tj) & (b == bj)) >= 0.98


def test_plain_picks_exact_cells_between_zero_rows():
    """Zero-mass rows and lanes interleaved: each pick lands on the cell
    whose mass interval holds its target. u=0 gives target 0, which the
    count rule alone would place on the zero-mass row 0; the zero-row rule
    moves it to row 1, the first with mass."""
    w = np.zeros((6, 3), np.float32)
    w[1] = [0.0, 2.0, 0.0]
    w[3] = [1.0, 0.0, 0.5]
    u = np.array([0.0, 0.5, 0.99999994], np.float32)
    t, b, p, tot = (x.numpy() for x in tps.plain_stratified_sample(
        torch.from_numpy(w), torch.from_numpy(u)))
    assert (p > 0).all()
    np.testing.assert_array_equal(t, [1, 1, 3])
    np.testing.assert_array_equal(b, [1, 1, 2])
    assert float(tot) == 3.5


def test_wrapper_routes_cpu_tensors_to_plain_version():
    rng = np.random.default_rng(4)
    w = torch.from_numpy(_mass(rng, 40, 4))
    u = torch.from_numpy(_uniforms(rng, 16))
    before = tps.kernel_stratified_sample.launches
    got = tps.kernel_stratified_sample(w, u)
    want = tps.plain_stratified_sample(w, u)
    for g, x in zip(got, want):
        torch.testing.assert_close(g, x, rtol=0, atol=0)
    # The count is of kernel launches only.
    assert tps.kernel_stratified_sample.launches == before
    with pytest.raises(TypeError):
        tps.kernel_stratified_sample(w.double(), u)
    with pytest.raises(ValueError):
        tps.kernel_stratified_sample(w, u[:, None])


def test_xla_twin_matches_jax_xla_path():
    rng = np.random.default_rng(5)
    w = _mass(rng, 128, 8)
    u = _uniforms(rng, 64)
    want = tuple(map(np.asarray, jps.stratified_sample_at(
        jnp.asarray(w), jnp.asarray(u))))
    got = tuple(x.numpy() for x in tps.stratified_sample_at(
        torch.from_numpy(w), torch.from_numpy(u)))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)


def test_stratified_uniforms_ladder():
    g = torch.Generator().manual_seed(0)
    u = tps.stratified_uniforms(g, 32, "cpu").numpy()
    assert ((u >= np.arange(32) / 32) & (u < (np.arange(32) + 1) / 32)).all()


@pytest.mark.parametrize("beta", [0.4, 1.0])
def test_importance_weights_match_jax(beta):
    rng = np.random.default_rng(6)
    mass = rng.uniform(0.0, 3.0, 64).astype(np.float32)
    mass[::7] = 0.0
    total = np.float32(mass.sum() * 3.0)
    n_valid = np.float32(500.0)
    want = np.asarray(jps.importance_weights(
        jnp.asarray(mass), jnp.asarray(total), jnp.asarray(n_valid),
        jnp.float32(beta)))
    got = tps.importance_weights(
        torch.from_numpy(mass), torch.tensor(total), torch.tensor(n_valid),
        beta).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (got[::7] == 0).all()


def test_fixed_order_cumsum_is_a_scan():
    """The blocked scan equals a float64 scan to float32 rounding, equals
    torch.cumsum exactly up to one block, and scans each member's row of a
    stacked plane on its own."""
    rng = np.random.default_rng(3)
    for n in (1, 1000, 1024, 1025, 5000):
        x = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
        got = tps.fixed_order_cumsum(x)
        want = np.cumsum(x.numpy().astype(np.float64))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
        if n <= tps.SCAN_BLOCK:
            assert torch.equal(got, torch.cumsum(x, dim=0))
    x = torch.from_numpy(rng.uniform(0, 1, (3, 4000)).astype(np.float32))
    stacked = tps.fixed_order_cumsum(x)
    for m in range(3):
        assert torch.equal(stacked[m], tps.fixed_order_cumsum(x[m]))


def test_cumsum_twin_draws_the_same_twice():
    """C3's case: the cumsum twin (stratified_sample_at without the kernel)
    gives the same picks twice, solo and member-axis, over a 200k plane,
    and still agrees with the JAX XLA path where both scan in one block."""
    rng = np.random.default_rng(8)
    w = torch.from_numpy(_mass(rng, 12_500, 16))
    u = torch.from_numpy(((np.arange(256) + rng.uniform(size=256))
                          / 256).astype(np.float32))
    first = tps.stratified_sample_at(w, u)
    for got in (tps.stratified_sample_at(w, u),
                tuple(x[0] for x in tps.stratified_sample_at(
                    w[None], u[None]))):
        for g, x in zip(got, first):
            assert torch.equal(g, x)
    small = _mass(rng, 64, 16)
    want = [np.asarray(x) for x in jps.stratified_sample_at(
        jnp.asarray(small), jnp.asarray(u.numpy()))]
    got = [x.numpy() for x in tps.stratified_sample_at(
        torch.from_numpy(small), u)]
    for g, x in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, x)
