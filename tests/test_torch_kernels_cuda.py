"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without an NVIDIA
card. This file imports no JAX, so it runs on a machine that has only
PyTorch and the CUDA toolkit. The repository's conftest.py imports JAX,
so run it there without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from dist_dqn_tpu_torch.ops import sampler as tps


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on one)")
    return torch.device("cuda")


def _mass(rng, T, B, zero_frac):
    w = rng.uniform(0.1, 2.0, (T, B)).astype(np.float32)
    w[rng.uniform(size=(T, B)) < zero_frac] = 0.0
    return w


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,S,zero_frac", [
    (62500, 16, 512, 0.3),   # the apex preset's priority plane
    (700, 8, 128, 0.9),      # ragged and mostly zero
])
def test_sampler_kernel_matches_plain_version(cuda, T, B, S, zero_frac):
    """Bars: >= 98% (t, b) agreement, mass_sel == w[t, b] to rtol 1e-6,
    no zero-mass pick, t < T, total to rtol 1e-5."""
    rng = np.random.default_rng(7)
    w_np = _mass(rng, T, B, zero_frac)
    u_np = ((np.arange(S) + rng.uniform(size=S)) / S).astype(np.float32)
    w = torch.from_numpy(w_np).to(cuda)
    u = torch.from_numpy(u_np).to(cuda)
    before = tps.kernel_stratified_sample.launches
    tk, bk, pk, totk = tps.kernel_stratified_sample(w, u)
    torch.cuda.synchronize()
    assert tps.kernel_stratified_sample.launches == before + 1
    tp, bp, _, totp = tps.plain_stratified_sample(w, u)
    tk, bk, pk = (x.cpu().numpy() for x in (tk, bk, pk))
    assert np.mean((tk == tp.cpu().numpy())
                   & (bk == bp.cpu().numpy())) >= 0.98
    np.testing.assert_allclose(pk, w_np[tk, bk], rtol=1e-6)
    assert (pk > 0).all() and (tk < T).all() and (tk >= 0).all()
    np.testing.assert_allclose(float(totk), float(totp), rtol=1e-5)


@pytest.mark.cuda
def test_sampler_kernel_picks_exact_cells_between_zero_rows(cuda):
    """The zero-mass rules on the card: u=0 would land on the zero-mass
    row 0 and moves to row 1; the top target stops at the last lane with
    mass (the CPU twin of this case is in test_torch_sampler.py)."""
    w = np.zeros((6, 3), np.float32)
    w[1] = [0.0, 2.0, 0.0]
    w[3] = [1.0, 0.0, 0.5]
    u = np.array([0.0, 0.5, 0.99999994], np.float32)
    t, b, p, tot = (x.cpu().numpy() for x in tps.kernel_stratified_sample(
        torch.from_numpy(w).to(cuda), torch.from_numpy(u).to(cuda)))
    assert (p > 0).all()
    np.testing.assert_array_equal(t, [1, 1, 3])
    np.testing.assert_array_equal(b, [1, 1, 2])
    assert float(tot) == 3.5


@pytest.mark.cuda
def test_sampler_kernel_refuses_bad_inputs(cuda):
    w = torch.ones((8, 4), device=cuda)
    u = torch.full((4,), 0.5, device=cuda)
    with pytest.raises(TypeError):
        tps.kernel_stratified_sample(w.double(), u)
    with pytest.raises(ValueError):
        tps.kernel_stratified_sample(w.t(), u)        # not contiguous
    with pytest.raises(ValueError):
        tps.kernel_stratified_sample(w, u.cpu())      # devices differ
