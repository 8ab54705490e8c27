"""The sampler kernel's chunked design, modelled in numpy and held against
its plain PyTorch version.

``csrc/stratified_sample.cu`` draws in one launch: each chunk block sums
and scans its own chunk of R rows into a chunk-local row CDF, the last of
them to finish scans the chunk totals into chunk offsets, and the draw
blocks search in two levels (the chunk, then the row within it). The CUDA
kernel runs only on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py). Here a numpy model of that draw, with the R that
``launch_geometry`` gives the kernel, must pick exactly the cells
``plain_stratified_sample`` picks.
"""
import numpy as np
import pytest
import torch

from dist_dqn_tpu_torch.ops import sampler as tps

R = tps.launch_geometry(62500).rows_per_chunk
APEX = (62500, 16)


def _mass(rng, T, B, zero_frac):
    w = rng.uniform(0.1, 2.0, (T, B)).astype(np.float32)
    w[rng.uniform(size=(T, B)) < zero_frac] = 0.0
    return w


def _uniforms(rng, S):
    return ((np.arange(S) + rng.uniform(size=S)) / S).astype(np.float32)


def _chunks(w):
    """Phase 1 of every chunk block and the chunk offsets: row sums in
    lane order, chunk-local inclusive row CDFs, and offset [G + 1] (the
    exclusive scan of the chunk totals; offset[G] is the total)."""
    T = w.shape[0]
    geo = tps.launch_geometry(T)
    rows, G = geo.rows_per_chunk, geo.chunks
    rs = np.cumsum(w.astype(np.float64), axis=1)[:, -1]
    local = np.concatenate([np.cumsum(rs[c * rows:(c + 1) * rows])
                            for c in range(G)])
    chunk_total = local[np.minimum(np.arange(1, G + 1) * rows, T) - 1]
    offset = np.concatenate([[0.0], np.cumsum(chunk_total)])
    return rows, G, rs, local, offset


def _model_draw(w, u):
    """The draw blocks' phase 2, sample by sample."""
    T, B = w.shape
    rows, G, rs, local, offset = _chunks(w)
    total = offset[G]
    targets = u.astype(np.float64) * total * (1.0 - 1e-5)

    def cdf_before(r):
        c = r // rows
        return offset[c] if r == c * rows else offset[c] + local[r - 1]

    t_out, b_out, m_out = [], [], []
    for target in targets:
        # Level 1: the first chunk whose end reaches the target; level 2:
        # the first row of that chunk whose offset + local CDF does.
        c = int(np.searchsorted(offset[1:], target, side="left"))
        count = T
        if c < G:
            lo, hi = c * rows, min(c * rows + rows, T)
            count = lo + int(np.searchsorted(offset[c] + local[lo:hi], target,
                                             side="left"))
        t = min(count, T - 1)
        prev = cdf_before(count)
        if rs[t] == 0.0:
            f = t
            while f < T and rs[f] == 0.0:
                f += 1
            if f == T:
                f = t
                while f > 0 and rs[f] == 0.0:
                    f -= 1
            if f != t:
                t = f
                prev = cdf_before(t)
        residual = min(target - prev, rs[t] * (1.0 - 1e-6))
        cum, b, last = 0.0, -1, B - 1
        for j in range(B):
            m = float(w[t, j])
            cum += m
            if m > 0.0:
                last = j
                if cum >= residual:
                    b = j
                    break
        b = last if b < 0 else b
        t_out.append(t)
        b_out.append(b)
        m_out.append(w[t, b])
    return (np.array(t_out, np.int32), np.array(b_out, np.int32),
            np.array(m_out, np.float32), np.float32(total))


def _assert_model_matches_plain(w, u):
    t, b, m, tot = _model_draw(w, u)
    tp, bp, mp, totp = (x.numpy() for x in tps.plain_stratified_sample(
        torch.from_numpy(w), torch.from_numpy(u)))
    np.testing.assert_array_equal(t, tp)
    np.testing.assert_array_equal(b, bp)
    np.testing.assert_array_equal(m, mp)
    np.testing.assert_allclose(tot, totp, rtol=1e-7)
    return t, b, m


SHAPES_T = [1, 6, R - 1, R, R + 1, 3 * R + 7, 62500]


@pytest.mark.parametrize("zero_frac", [0.0, 0.9])
@pytest.mark.parametrize("B", [1, 5, 8, 16])
@pytest.mark.parametrize("T", SHAPES_T)
def test_chunked_model_matches_plain(T, B, zero_frac):
    rng = np.random.default_rng(T * 100 + B + int(zero_frac * 10))
    w = _mass(rng, T, B, zero_frac)
    u = _uniforms(rng, 512 if (T, B) == APEX else 128)
    _, _, m = _assert_model_matches_plain(w, u)
    if w.any():
        assert (m > 0).all()


def test_chunked_model_with_wide_chunks_matches_plain():
    """Past SAMPLER_MAX_CHUNKS tiles, a chunk holds two tiles of rows."""
    T = tps.SAMPLER_THREADS * tps.SAMPLER_MAX_CHUNKS + 5
    assert tps.launch_geometry(T).rows_per_chunk == 2 * tps.SAMPLER_THREADS
    rng = np.random.default_rng(11)
    w = _mass(rng, T, 1, 0.3)
    _assert_model_matches_plain(w, _uniforms(rng, 64))


@pytest.mark.parametrize("B", [4, 5])
def test_chunked_model_zero_chunks_at_both_ends(B):
    """Whole chunks of zero mass at the start and the end of the plane:
    u = 0 lands on row 0 and moves forward across two chunks; u near 1
    stops at the last row with mass, two chunks before the end."""
    rng = np.random.default_rng(12)
    T = 5 * R + 3
    w = _mass(rng, T, B, 0.5)
    w[:2 * R] = 0.0
    w[4 * R:] = 0.0
    u = np.concatenate([[0.0, 0.99999994], _uniforms(rng, 64)]
                       ).astype(np.float32)
    t, _, m = _assert_model_matches_plain(w, u)
    assert t[0] == np.flatnonzero(w.sum(axis=1))[0] >= 2 * R
    assert t[1] == np.flatnonzero(w.sum(axis=1))[-1] < 4 * R
    assert (m > 0).all()


@pytest.mark.parametrize("T,B,zero_frac", [(6, 3, 0.5), (R + 1, 16, 0.9),
                                           (62500, 16, 0.3)])
def test_chunked_model_extreme_uniforms(T, B, zero_frac):
    rng = np.random.default_rng(13)
    w = _mass(rng, T, B, zero_frac)
    u = np.array([0.0, 0.0, 0.5, 0.99999994, 0.99999994], np.float32)
    _, _, m = _assert_model_matches_plain(w, u)
    assert (m > 0).all()


def _integer_plane(rng, T, B):
    """Integer masses (zero rows included) topped up in the last cell so
    the total is a power of two: then u * total is exact, and some f64 u
    gives every integer target exactly."""
    w = rng.integers(0, 3, (T, B)).astype(np.float32)
    w[rng.uniform(size=T) < 0.3] = 0.0
    total = int(w.sum())
    w[-1, -1] += float(2 ** int(np.ceil(np.log2(total + 1))) - total)
    return w


def _u_for_target(target, total):
    q = 1.0 - 1e-5
    u = target / total / q
    for _ in range(64):
        got = u * total * q
        if got == target:
            return u
        u = np.nextafter(u, np.inf if got < target else -np.inf)
    raise AssertionError(f"no f64 u reaches target {target}")


@pytest.mark.parametrize("B", [1, 8])
def test_chunked_model_targets_exactly_on_chunk_boundaries(B):
    """Targets equal to each chunk offset, exactly, and one f32 step to
    either side of it: the lower bound must take the last row of the
    chunk before (or the nearest row with mass), as the global search
    does. The exact targets need an f64 u, which the plain version takes
    as it is."""
    rng = np.random.default_rng(14)
    T = 6 * R + 9
    w = _integer_plane(rng, T, B)
    _, G, _, _, offset = _chunks(w)
    total = offset[G]
    exact = np.array([_u_for_target(o, total) for o in offset[1:G]])
    _assert_model_matches_plain(w, exact)
    near = np.concatenate([
        np.nextafter(exact.astype(np.float32), np.float32(0.0)),
        exact.astype(np.float32),
        np.nextafter(exact.astype(np.float32), np.float32(1.0))])
    _assert_model_matches_plain(w, near)


@pytest.mark.parametrize("zero_frac", [0.0, 0.9])
@pytest.mark.parametrize("T", SHAPES_T)
def test_chunk_offset_plus_local_cdf_is_the_global_cumsum(T, zero_frac):
    """offset[c] + local[t] == torch.cumsum(row sums) bit for bit: the
    plane's f64 sums are exact at these shapes (module note of
    csrc/stratified_sample.cu)."""
    rng = np.random.default_rng(T + 3)
    w = _mass(rng, T, 16, zero_frac)
    rows, _, rs, local, offset = _chunks(w)
    split = offset[np.arange(T) // rows] + local
    want = torch.cumsum(torch.from_numpy(w).double().sum(dim=1), 0).numpy()
    np.testing.assert_array_equal(split, want)


@pytest.mark.parametrize("T", [1, 6, 255, 256, 257, 775, 62500, 524288,
                               524289, 2 ** 31 - 1])
def test_launch_geometry_covers_every_row(T):
    geo = tps.launch_geometry(T)
    R_, G = geo.rows_per_chunk, geo.chunks
    assert G * R_ >= T > (G - 1) * R_
    assert R_ % geo.threads == 0 and geo.threads == tps.SAMPLER_THREADS
    assert 1 <= G <= tps.SAMPLER_MAX_CHUNKS
    # Row sums and local CDF [T] each, chunk totals [G].
    assert geo.scratch_f64 == 2 * T + G
    assert geo.static_smem_bytes < 48 * 1024


@pytest.mark.parametrize("S", [1, 31, 32, 33, 512, 4096])
def test_launch_geometry_draw_blocks_cover_every_sample(S):
    P = tps.launch_geometry(100, S).draw_blocks
    per = -(-S // P)
    assert per <= tps.SAMPLER_DRAW_SAMPLES
    assert P * per >= S > (P - 1) * per


def test_launch_geometry_fills_the_card_at_the_apex_shape():
    geo = tps.launch_geometry(APEX[0], 512)
    assert geo.chunks >= 132          # the H100's SMs
    assert (geo.rows_per_chunk, geo.chunks, geo.draw_blocks) == (256, 245, 16)


@pytest.mark.parametrize("members", [1, 2, 4, 7])
def test_launch_geometry_member_axis(members):
    """A member axis keeps each member's grid and grows the workspace: a
    scratch and a done and a drawn count per member, one ticket counter."""
    solo = tps.launch_geometry(APEX[0], 512)
    geo = tps.launch_geometry(APEX[0], 512, members)
    assert geo[:4] == solo[:4]
    assert geo.scratch_f64 == members * solo.scratch_f64
    assert geo.sync_words == 1 + 2 * members and solo.sync_words == 3
