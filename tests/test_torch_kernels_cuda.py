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


R = tps.launch_geometry(62500).rows_per_chunk     # rows per block's chunk
# Chunk edges: one row, one partial chunk, a chunk short of, equal to and
# one row past R, and a partial last chunk; B=1 and 5 take the scalar
# loads, B=8 and 16 the float4 ones.
CHUNK_EDGES = [(T, B, 128, zero_frac)
               for T in (1, 6, R - 1, R, R + 1, 3 * R + 7)
               for B in (1, 5, 8, 16) for zero_frac in (0.0, 0.9)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,S,zero_frac", [
    (62500, 16, 512, 0.3),   # the apex preset's priority plane
    (700, 8, 128, 0.9),      # ragged and mostly zero
    *CHUNK_EDGES,
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
    assert (tk < T).all() and (tk >= 0).all()
    # A plane with no mass at all (one of the one-row cases) has no cell
    # with mass to pick.
    assert (pk > 0).all() or not w_np.any()
    np.testing.assert_allclose(float(totk), float(totp), rtol=1e-5)


def _draw_inputs(cuda, T=62500, B=16, S=512, zero_frac=0.3, seed=8):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(_mass(rng, T, B, zero_frac)).to(cuda)
    u = torch.from_numpy(
        ((np.arange(S) + rng.uniform(size=S)) / S).astype(np.float32)).to(cuda)
    return w, u


def _assert_same_draw(got, want):
    for g, x in zip(got, want):
        assert torch.equal(g, x)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
def test_sampler_kernel_near_chunk_boundaries(cuda, B):
    """Integer masses and uniforms one f32 step either side of each chunk
    boundary's: the kernel picks exactly the plain version's cells."""
    rng = np.random.default_rng(9)
    T = 6 * R + 9
    w_np = rng.integers(0, 3, (T, B)).astype(np.float32)
    w_np[rng.uniform(size=T) < 0.3] = 0.0
    cdf = np.cumsum(w_np.astype(np.float64).sum(axis=1))
    bounds = (cdf[R - 1::R][:-1] / cdf[-1] / (1.0 - 1e-5)).astype(np.float32)
    u_np = np.concatenate([np.nextafter(bounds, np.float32(0.0)), bounds,
                           np.nextafter(bounds, np.float32(1.0))])
    w = torch.from_numpy(w_np).to(cuda)
    u = torch.from_numpy(u_np).to(cuda)
    _assert_same_draw(tps.kernel_stratified_sample(w, u),
                      tps.plain_stratified_sample(w, u))


@pytest.mark.cuda
def test_sampler_kernel_misaligned_plane_takes_scalar_loads(cuda):
    """w 4 bytes off a 16-byte boundary (B % 4 == 0 all the same): the
    kernel must not take its float4 path."""
    w0, u = _draw_inputs(cuda, T=3 * R + 7, B=8)
    flat = torch.empty(w0.numel() + 1, device=cuda)
    w = flat[1:].view(w0.shape)
    w.copy_(w0)
    assert w.data_ptr() % 16 != 0 and w.is_contiguous()
    _assert_same_draw(tps.kernel_stratified_sample(w, u),
                      tps.kernel_stratified_sample(w0, u))


@pytest.mark.cuda
def test_sampler_kernel_replays_in_a_cuda_graph(cuda):
    """Two back-to-back calls, and a CUDA graph of 20 calls replayed twice,
    give what one eager call gives: the kernel's sync words are back at
    zero after every launch."""
    w, u = _draw_inputs(cuda)
    want = [x.clone() for x in tps.kernel_stratified_sample(w, u)]
    _assert_same_draw(tps.kernel_stratified_sample(w, u), want)
    _assert_same_draw(tps.kernel_stratified_sample(w, u), want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tps.kernel_stratified_sample(w, u)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [tps.kernel_stratified_sample(w, u) for _ in range(20)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for got in outs:
            _assert_same_draw(got, want)
    _assert_same_draw(tps.kernel_stratified_sample(w, u), want)


@pytest.mark.cuda
def test_sampler_draw_is_one_device_kernel(cuda):
    """One draw is one launch of one kernel on the card, and nothing else
    (no memset, no copy), counted from torch.profiler's device events."""
    from torch.autograd import DeviceType
    w, u = _draw_inputs(cuda)
    tps.kernel_stratified_sample(w, u)
    torch.cuda.synchronize()
    calls = 10
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            tps.kernel_stratified_sample(w, u)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == calls, names
    assert len(set(names)) == 1 and "sample_kernel" in names[0], names


@pytest.mark.cuda
def test_sampler_kernel_shared_memory_matches_launch_geometry(cuda):
    lib = tps._load()
    assert (lib.dqn_stratified_sample_static_smem()
            == tps.launch_geometry(62500).static_smem_bytes)


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
