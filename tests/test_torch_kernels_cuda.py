"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without an NVIDIA
card. This file imports no JAX, so it runs on a machine that has only
PyTorch and the CUDA toolkit. The repository's conftest.py imports JAX,
so run it there without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py
"""
import contextlib
import time

import numpy as np
import pytest
import torch

from dist_dqn_tpu_torch.ops import sampler as tps

# torch.profiler stamps device records with the card's clock converted to
# the host's, off by up to a few milliseconds (a kernel can be stamped
# before the host call that launched it), and keeps only the records inside
# its session's window: a kernel launched right after the session opens
# can be stamped before it and dropped (ROADMAP.md C7). A counted session
# idles this long after it opens and before it closes.
_PROFILE_SETTLE_S = 0.05


@contextlib.contextmanager
def _counted_profile():
    """A torch.profiler session (host and card) whose window has room for
    the clock error at both ends; the body's work is synchronised."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(_PROFILE_SETTLE_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(_PROFILE_SETTLE_S)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m cuda on one)")
    return torch.device("cuda")


def _mass(rng, T, B, zero_frac):
    w = rng.uniform(0.1, 2.0, (T, B)).astype(np.float32)
    w[rng.uniform(size=(T, B)) < zero_frac] = 0.0
    return w


R = tps.launch_geometry(62500, B=16).rows_per_chunk  # rows per chunk
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
    with _counted_profile() as prof:
        for _ in range(calls):
            tps.kernel_stratified_sample(w, u)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == calls, names
    assert len(set(names)) == 1 and "sample_kernel" in names[0], names


@pytest.mark.cuda
def test_sampler_kernel_shared_memory_matches_launch_geometry(cuda):
    lib = tps._load()
    assert (lib.dqn_stratified_sample_static_smem()
            == tps.launch_geometry(62500, B=16).static_smem_bytes)


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


def _sequence_plane(rng, live_rows, T=6250, B=16, stride=40):
    """R2D2's [T, B] sequence plane: window starts are seeded every
    ``stride`` writes, so mass sits only in every 40th row of the live
    rows, in all lanes of those rows."""
    w = np.zeros((T, B), np.float32)
    rows = np.arange(T)
    live = np.isin(rows, live_rows) & (rows % stride == 0)
    w[live] = rng.uniform(0.1, 2.0, (int(live.sum()), B))
    return w


@pytest.mark.cuda
@pytest.mark.parametrize("live", [
    "full",        # a wrapped ring: every 40th row of all 6,250
    "filling",     # before the ring wraps: rows past 1,200 (chunks 5-24)
                   # hold no mass at all
    "band",        # a band in the middle: whole empty chunks on both sides
])
def test_sampler_kernel_on_the_r2d2_sequence_plane(cuda, live):
    """The r2d2 preset's draw (T=6,250, B=16, S=64: 25 chunk blocks and 2
    draw blocks): the kernel picks exactly the plain version's cells, all
    on live rows, across zero rows and whole zero chunks."""
    T, S = 6250, 64
    geo = tps.launch_geometry(T, S, B=16)
    assert (geo.chunks, geo.draw_blocks) == (25, 2)
    live_rows = {"full": np.arange(T), "filling": np.arange(1200),
                 "band": np.arange(2000, 3300)}[live]
    rng = np.random.default_rng(10)
    w_np = _sequence_plane(rng, live_rows)
    u_np = ((np.arange(S) + rng.uniform(size=S)) / S).astype(np.float32)
    w = torch.from_numpy(w_np).to(cuda)
    u = torch.from_numpy(u_np).to(cuda)
    got = tps.kernel_stratified_sample(w, u)
    _assert_same_draw(got, tps.plain_stratified_sample(w, u))
    t, b, p, _ = (x.cpu().numpy() for x in got)
    assert (t % 40 == 0).all() and np.isin(t, live_rows).all()
    np.testing.assert_array_equal(p, w_np[t, b])
    assert (p > 0).all()


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


# --------------------------------------------------------------------------
# The member axis: M planes [M, T, B] in one launch (the population).
# --------------------------------------------------------------------------

def _member_inputs(cuda, M, T, B, S, zero_frac=0.3, seed=20):
    rng = np.random.default_rng(seed)
    w = np.stack([_mass(rng, T, B, zero_frac) for _ in range(M)])
    u = ((np.arange(S) + rng.uniform(size=(M, S))) / S).astype(np.float32)
    return torch.from_numpy(w).to(cuda), torch.from_numpy(u).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("M,T,B,S", [
    (4, 62500, 16, 512),     # the population_apex_dedup plane
    (3, 3 * R + 7, 5, 128),  # a partial last chunk, scalar loads
    (2, 1, 8, 32),           # one row
    (5, 700, 8, 33),         # a partial last draw block
])
def test_member_axis_launch_equals_one_launch_per_plane(cuda, M, T, B, S):
    """One launch over [M, T, B] gives, for member m, bit for bit what a
    2-D launch on plane m alone gives; and agrees with the plain
    member-axis version as the 2-D kernel does."""
    w, u = _member_inputs(cuda, M, T, B, S)
    before = tps.kernel_stratified_sample.launches
    got = tps.kernel_stratified_sample(w, u)
    assert tps.kernel_stratified_sample.launches == before + 1
    assert [tuple(x.shape) for x in got] == [(M, S)] * 3 + [(M,)]
    for m in range(M):
        _assert_same_draw([x[m] for x in got],
                          tps.kernel_stratified_sample(w[m], u[m]))
    tp, bp, _, totp = tps.plain_stratified_sample(w, u)
    tk, bk, pk, totk = got
    assert ((tk == tp) & (bk == bp)).float().mean() >= 0.98
    wk = w[torch.arange(M, device=cuda)[:, None], tk.long(), bk.long()]
    assert torch.equal(pk, wk) and bool((pk > 0).all())
    torch.testing.assert_close(totk, totp, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
def test_member_axis_with_zero_mass_members_and_rows(cuda):
    """A member whose plane holds no mass, one with mass in a single row,
    and two ordinary ones: each draw equals its own 2-D launch and the
    plain version, and only the empty member picks zero mass."""
    w, u = _member_inputs(cuda, 4, 3 * R + 7, 16, 256, seed=21)
    w[1] = 0.0
    w[2, :] = 0.0
    w[2, 2 * R + 3, 5] = 1.5
    got = tps.kernel_stratified_sample(w, u)
    for m in range(4):
        _assert_same_draw([x[m] for x in got],
                          tps.kernel_stratified_sample(w[m], u[m]))
    _assert_same_draw(got[:2], tps.plain_stratified_sample(w, u)[:2])
    assert float(got[3][1]) == 0.0 and bool((got[2][1] == 0).all())
    assert bool((got[0][2] == 2 * R + 3).all() and (got[1][2] == 5).all())
    assert bool((got[2][[0, 2, 3]] > 0).all())


@pytest.mark.cuda
def test_member_axis_of_one_is_the_2d_call(cuda):
    w, u = _draw_inputs(cuda)
    got = tps.kernel_stratified_sample(w[None], u[None])
    _assert_same_draw([x[0] for x in got], tps.kernel_stratified_sample(w, u))


@pytest.mark.cuda
def test_member_axis_replays_in_a_cuda_graph(cuda):
    """Eager calls at M = 4 and a graph of 10 of them replayed twice all
    equal one eager call: every member's sync words are back at zero."""
    w, u = _member_inputs(cuda, 4, 62500, 16, 512)
    want = [x.clone() for x in tps.kernel_stratified_sample(w, u)]
    _assert_same_draw(tps.kernel_stratified_sample(w, u), want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tps.kernel_stratified_sample(w, u)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [tps.kernel_stratified_sample(w, u) for _ in range(10)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for got in outs:
            _assert_same_draw(got, want)
    # A 2-D call between member-axis calls reuses the same workspace.
    tps.kernel_stratified_sample(w[0], u[0])
    _assert_same_draw(tps.kernel_stratified_sample(w, u), want)


@pytest.mark.cuda
def test_member_axis_draw_is_one_device_kernel(cuda):
    from torch.autograd import DeviceType
    w, u = _member_inputs(cuda, 4, 62500, 16, 512)
    tps.kernel_stratified_sample(w, u)
    torch.cuda.synchronize()
    with _counted_profile() as prof:
        for _ in range(10):
            tps.kernel_stratified_sample(w, u)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 10 and all("sample_kernel" in n for n in names)


@pytest.mark.cuda
@pytest.mark.parametrize("w_shape,u_shape", [
    ((3, 8, 4), (4,)),        # 3-D plane, 1-D uniforms
    ((3, 8, 4), (2, 4)),      # members disagree
    ((8, 4), (3, 4)),         # 2-D plane, 2-D uniforms
    ((0, 8, 4), (0, 4)),      # no members
    ((2, 2, 8, 4), (2, 4)),   # 4-D
])
def test_member_axis_refuses_bad_shapes(cuda, w_shape, u_shape):
    with pytest.raises(ValueError):
        tps.kernel_stratified_sample(torch.ones(w_shape, device=cuda),
                                     torch.full(u_shape, 0.5, device=cuda))


# The host-replay device plane of the apex preset's 1M slots.
HOST_T, HOST_B, HOST_LIVE = 1954, 512, 1_000_000


@pytest.mark.cuda
@pytest.mark.parametrize("zero_frac", [0.0, 0.3])
def test_sampler_kernel_on_the_host_plane(cuda, zero_frac):
    """The plane [1954, 512] with its last 448 cells unwritten, S = 512:
    the kernel picks exactly the plain version's cells, never one past
    slot 999,999."""
    rng = np.random.default_rng(11)
    w_np = _mass(rng, HOST_T, HOST_B, zero_frac)
    w_np.reshape(-1)[HOST_LIVE:] = 0.0
    u_np = ((np.arange(512) + rng.uniform(size=512)) / 512).astype(
        np.float32)
    w = torch.from_numpy(w_np).to(cuda)
    u = torch.from_numpy(u_np).to(cuda)
    got = tps.kernel_stratified_sample(w, u)
    _assert_same_draw(got, tps.plain_stratified_sample(w, u))
    flat = got[0].long() * HOST_B + got[1].long()
    assert int(flat.max()) < HOST_LIVE
    assert bool((got[2] > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [200_000, 1_000_000])
def test_fixed_order_scan_repeats_on_the_card(cuda, n):
    """The cumsum twin's blocked scan gives the same sums call after call
    (a flat torch.cumsum of this length does not), solo and with a member
    axis, and the draw through it the same picks."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand(n, generator=gen, device=cuda)
    x = x * (torch.rand(n, generator=gen, device=cuda) > 0.3)
    first = tps.fixed_order_cumsum(x)
    for _ in range(4):
        assert torch.equal(tps.fixed_order_cumsum(x), first)
        assert torch.equal(tps.fixed_order_cumsum(x[None])[0], first)
    w = x.view(-1, 16)
    u = tps.stratified_uniforms(gen, 256, cuda)
    want = tps.stratified_sample_at(w, u)
    for _ in range(3):
        _assert_same_draw(tps.stratified_sample_at(w, u), want)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [1_000_000, 20_000])
def test_device_priority_sampler_routes_by_plane_size(cuda, capacity):
    """DevicePrioritySampler on the card draws through the kernel at or
    above 100,000 cells (one launch per draw), else through the
    three-level torch draw, and both pick cells with mass."""
    from dist_dqn_tpu_torch.replay.host import DevicePrioritySampler

    sampler = DevicePrioritySampler(capacity, device=cuda)
    rng = np.random.default_rng(12)
    sampler.set(np.arange(capacity),
                rng.uniform(0.2, 3.0, capacity).astype(np.float32))
    before = tps.kernel_stratified_sample.launches
    idx, mass = sampler.sample_at((np.arange(512) + 0.5) / 512, capacity)
    assert tps.kernel_stratified_sample.launches - before == \
        int(capacity >= 100_000)
    assert (idx < capacity).all() and (mass > 0).all()
    np.testing.assert_allclose(mass, sampler._mirror[idx], rtol=1e-6)


@pytest.mark.cuda
def test_device_priority_sampler_sample_is_one_launch_in_range(cuda):
    """The Ape-X store's draw (``DevicePrioritySampler.sample``, uniforms
    from the plane's own generator) at the plane [1954, 512] of apex's 1M
    slots, 40,000 of them written as a 40,000-step run leaves them: one
    kernel launch per call, every pick inside [0, size), every weight
    positive and at most 1, the same picks from the same seed."""
    from dist_dqn_tpu_torch.replay.host import DevicePrioritySampler

    capacity, size = 1_000_000, 40_000
    draws = []
    for _ in range(2):
        sampler = DevicePrioritySampler(capacity, device=cuda, seed=5)
        assert sampler.use_kernel
        assert tuple(sampler.plane.shape) == (HOST_T, HOST_B)
        rng = np.random.default_rng(13)
        sampler.set(np.arange(size),
                    rng.uniform(0.2, 3.0, size).astype(np.float32))
        picks = []
        for _ in range(20):
            before = tps.kernel_stratified_sample.launches
            idx, w = sampler.sample(512, 0.4, size)
            assert tps.kernel_stratified_sample.launches - before == 1
            assert idx.shape == (512,) and (idx >= 0).all()
            assert (idx < size).all()
            assert (w > 0).all() and w.max() == np.float32(1.0)
            picks.append(idx)
        draws.append(np.stack(picks))
        assert sampler.draw_dispatches == 20
    np.testing.assert_array_equal(draws[0], draws[1])


@pytest.mark.cuda
def test_kernel_draw_on_a_restored_plane(cuda):
    """A replay snapshot of apex's 1M slots (30,000 written, priorities
    updated, as a service run saves it) restored into a fresh store on the
    card through ``replay/sharded.py restore_replay_snapshot``: the plane
    holds the snapshot's mass bit for bit, and the kernel's draw on it at
    explicit uniforms equals the plain version's on the same plane."""
    from dist_dqn_tpu_torch.replay.host import PrioritizedHostReplay
    from dist_dqn_tpu_torch.replay.sharded import restore_replay_snapshot

    rng = np.random.default_rng(14)
    capacity, size = 1_000_000, 30_000
    src = PrioritizedHostReplay(capacity, sampler="device",
                                sampler_device=cuda)
    src.add({"x": np.arange(size, dtype=np.int64)},
            priorities=rng.uniform(0.05, 4.0, size))
    idx = rng.integers(0, size, 4096)
    src.update_priorities(idx, rng.uniform(0.0, 6.0, 4096),
                          expected_gen=src.generation(idx))
    state = src.state_dict()
    dst = PrioritizedHostReplay(capacity, sampler="device",
                                sampler_device=cuda)
    info = restore_replay_snapshot(dst, state)
    assert info["records"] == size and not info["resharded"]
    sampler = dst.device_sampler
    sampler._flush_writes()
    plane = sampler.plane
    assert tuple(plane.shape) == (HOST_T, HOST_B) and sampler.use_kernel
    np.testing.assert_array_equal(
        plane.reshape(-1)[:capacity].cpu().numpy(),
        state["mass"].astype(np.float32))
    u = torch.from_numpy(((np.arange(512) + rng.uniform(size=512)) / 512)
                         .astype(np.float32)).to(cuda)
    before = tps.kernel_stratified_sample.launches
    got = tps.kernel_stratified_sample(plane, u)
    assert tps.kernel_stratified_sample.launches == before + 1
    _assert_same_draw(got, tps.plain_stratified_sample(plane, u))
    flat = got[0].long() * HOST_B + got[1].long()
    assert int(flat.max()) < size and bool((got[2] > 0).all())


# --------------------------------------------------------------------------
# The wide-row path: one warp per row and per sample, from
# SAMPLER_WIDE_MIN_LANES lanes on.
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_wide_min_lanes_mirrors_the_kernel(cuda):
    lib = tps._load()
    assert (lib.dqn_stratified_sample_wide_min_lanes()
            == tps.SAMPLER_WIDE_MIN_LANES)
    assert tps.launch_geometry(HOST_T, 512, B=HOST_B).wide
    assert not tps.launch_geometry(62500, 512, B=16).wide


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,S,zero_frac", [
    (7813, 128, 512, 0.3),   # about 1M cells at B = 128
    (977, 500, 256, 0.3),    # a partial span
    (1954, 512, 512, 0.0),   # the host plane, every cell with mass
    (977, 1024, 256, 0.3),   # two spans
    (50, 520, 64, 0.9),      # a second span of 8 cells, mostly zero
    (1, 512, 32, 0.5),       # one row
])
def test_wide_path_picks_the_plain_version_cells(cuda, T, B, S, zero_frac):
    w, u = _draw_inputs(cuda, T=T, B=B, S=S, zero_frac=zero_frac, seed=30)
    assert tps.launch_geometry(T, S, B=B).wide
    before = tps.kernel_stratified_sample.launches
    got = tps.kernel_stratified_sample(w, u)
    assert tps.kernel_stratified_sample.launches == before + 1
    _assert_same_draw(got[:3], tps.plain_stratified_sample(w, u)[:3])
    assert bool((got[2] > 0).all())


@pytest.mark.cuda
def test_wide_path_misaligned_plane_takes_scalar_loads(cuda):
    """A [977, 512] plane 4 bytes off a 16-byte boundary: the wide path's
    scalar loads pick what its float4 loads pick on an aligned copy."""
    w0, u = _draw_inputs(cuda, T=977, B=512, S=256, seed=31)
    flat = torch.empty(w0.numel() + 1, device=cuda)
    w = flat[1:].view(w0.shape)
    w.copy_(w0)
    assert w.data_ptr() % 16 != 0 and w.is_contiguous()
    _assert_same_draw(tps.kernel_stratified_sample(w, u),
                      tps.kernel_stratified_sample(w0, u))


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,S", [(HOST_T, HOST_B, 512), (977, 520, 256)])
def test_wide_path_replays_in_a_cuda_graph(cuda, T, B, S):
    """Eager calls and a CUDA graph of 20 calls replayed twice give what one
    eager call gives: the wide path leaves its sync words at zero too."""
    w, u = _draw_inputs(cuda, T=T, B=B, S=S, seed=32)
    want = [x.clone() for x in tps.kernel_stratified_sample(w, u)]
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
    # A narrow call between wide ones shares the workspace.
    tps.kernel_stratified_sample(*_draw_inputs(cuda))
    _assert_same_draw(tps.kernel_stratified_sample(w, u), want)


@pytest.mark.cuda
def test_wide_path_draw_is_one_device_kernel(cuda):
    from torch.autograd import DeviceType
    w, u = _draw_inputs(cuda, T=HOST_T, B=HOST_B, S=512, seed=33)
    tps.kernel_stratified_sample(w, u)
    torch.cuda.synchronize()
    with _counted_profile() as prof:
        for _ in range(10):
            tps.kernel_stratified_sample(w, u)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 10 and all("sample_kernel" in n for n in names)


@pytest.mark.cuda
def test_wide_path_member_axis_equals_one_launch_per_plane(cuda):
    """Two host planes [2, 1954, 512] in one launch: each member's draw bit
    for bit a 2-D launch on its plane, and the plain version's cells."""
    w, u = _member_inputs(cuda, 2, HOST_T, HOST_B, 512, seed=34)
    got = tps.kernel_stratified_sample(w, u)
    for m in range(2):
        _assert_same_draw([x[m] for x in got],
                          tps.kernel_stratified_sample(w[m], u[m]))
    _assert_same_draw(got[:3], tps.plain_stratified_sample(w, u)[:3])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 32, 64, 128, 256, 512])
def test_both_paths_pick_the_same_cells(cuda, B):
    """Forced onto either path at about 1M cells, the kernel picks the
    plain version's cells: the crossover changes the time, never the
    draw."""
    T = -(-1_000_000 // B)
    w, u = _draw_inputs(cuda, T=T, B=B, S=512, seed=35)
    want = tps.plain_stratified_sample(w, u)
    for wide in (False, True):
        got = tps._launch(w, u, tps.launch_geometry(T, 512, B=B, wide=wide))
        _assert_same_draw(got[:3], want[:3])
