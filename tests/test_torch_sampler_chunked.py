"""The sampler kernel's chunked design, modelled in numpy and held against
its plain PyTorch version.

``csrc/stratified_sample.cu`` draws in one launch: each chunk block sums
and scans its own chunk of R rows into a chunk-local row CDF, the draw
blocks scan the chunk totals into chunk offsets and search in two levels
(the chunk, then the row within it), then pick the lane. Planes of at
least ``SAMPLER_WIDE_MIN_LANES`` lanes take the wide-row path: a warp per
row and per sample, a tree-order row sum and a warp-scan lane pick. The
CUDA kernel runs only on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py). Here a numpy model of that draw (tests/torch_sampler_model.py),
on the path and with the R that ``launch_geometry`` gives the kernel, must
pick exactly the cells ``plain_stratified_sample`` picks.
"""
import numpy as np
import pytest
import torch

from dist_dqn_tpu_torch.ops import sampler as tps
from torch_sampler_model import chunks, model_draw, wide_row_sums

R = tps.launch_geometry(62500, B=16).rows_per_chunk
APEX = (62500, 16)
HOST_PLANE = (1954, 512)
# The wide path's chunk at the host plane (8 rows, one per warp).
WIDE_R = tps.launch_geometry(*HOST_PLANE[:1], B=HOST_PLANE[1]).rows_per_chunk


def _mass(rng, T, B, zero_frac):
    w = rng.uniform(0.1, 2.0, (T, B)).astype(np.float32)
    w[rng.uniform(size=(T, B)) < zero_frac] = 0.0
    return w


def _uniforms(rng, S):
    return ((np.arange(S) + rng.uniform(size=S)) / S).astype(np.float32)


def _chunks(w):
    geo, rs, local, offset = chunks(w)
    return geo.rows_per_chunk, geo.chunks, rs, local, offset


def _assert_model_matches_plain(w, u):
    t, b, m, tot = model_draw(w, u)
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


# The wide path's planes: the host plane with its last 448 cells never
# written (apex's 1M slots), a rank's or shard's plane with its last 224,
# ragged widths (a partial span; a second span of 8 cells; B % 4 != 0),
# two spans, and chunk edges around its R.
WIDE_CASES = [
    (1954, 512, 512, 0.3, 1_000_000),
    (977, 512, 256, 0.3, 500_000),
    (977, 500, 256, 0.3, None),
    (977, 520, 256, 0.3, None),
    (400, 510, 128, 0.5, None),
    (300, 1024, 128, 0.3, None),
    (1, 512, 32, 0.5, None),
    (6, 128, 64, 0.9, None),
    (WIDE_R - 1, 512, 64, 0.0, None),
    (WIDE_R + 1, 512, 64, 0.9, None),
    (3 * WIDE_R + 7, 128, 128, 0.9, None),
]


@pytest.mark.parametrize("T,B,S,zero_frac,live", WIDE_CASES)
def test_wide_model_matches_plain(T, B, S, zero_frac, live):
    rng = np.random.default_rng(T * 10 + B)
    w = _mass(rng, T, B, zero_frac)
    if live is not None:
        w.reshape(-1)[live:] = 0.0
    assert tps.launch_geometry(T, S, B=B).wide
    t, b, m = _assert_model_matches_plain(w, _uniforms(rng, S))
    if live is not None:
        assert (t.astype(np.int64) * B + b < live).all()
    if w.any():
        assert (m > 0).all()


@pytest.mark.parametrize("B", [16, 32, 64, 128, 256, 512])
def test_both_model_paths_pick_the_same_cells(B):
    """Forced onto either path, the model picks the plain version's cells at
    every width of the crossover sweep: the path changes the time, never
    the draw."""
    rng = np.random.default_rng(B)
    T = 65536 // B
    w = _mass(rng, T, B, 0.3)
    u = _uniforms(rng, 128)
    want = [x.numpy() for x in tps.plain_stratified_sample(
        torch.from_numpy(w), torch.from_numpy(u))]
    for wide in (False, True):
        got = model_draw(w, u, wide=wide)
        for g, x in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("T,B", [(tps.SAMPLER_THREADS * tps.SAMPLER_MAX_CHUNKS
                                  + 5, 1),
                                 (8 * tps.SAMPLER_MAX_CHUNKS + 5, 512)])
def test_chunked_model_with_wide_chunks_matches_plain(T, B):
    """Past SAMPLER_MAX_CHUNKS chunks of their usual size, chunks grow: two
    tiles of rows on the narrow path, nine rows (not eight) on the wide
    one."""
    geo = tps.launch_geometry(T, B=B)
    assert geo.rows_per_chunk == (9 if geo.wide else
                                  2 * tps.SAMPLER_THREADS)
    assert geo.chunks <= tps.SAMPLER_MAX_CHUNKS
    rng = np.random.default_rng(11)
    w = _mass(rng, T, B, 0.3)
    _assert_model_matches_plain(w, _uniforms(rng, 64))


@pytest.mark.parametrize("B", [4, 5, 500, 512])
def test_chunked_model_zero_chunks_at_both_ends(B):
    """Whole chunks of zero mass at the start and the end of the plane:
    u = 0 lands on row 0 and moves forward across two chunks (many on the
    wide path); u near 1 stops at the last row with mass, chunks before
    the end."""
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


@pytest.mark.parametrize("B", [512, 520])
def test_wide_model_zero_rows_on_chunk_boundaries(B):
    """On the wide path (chunks of 8 rows at B = 512, 7 at B = 520): zero
    rows at the first and last row of chunks, and a whole zero chunk;
    uniforms on either side of each zero row's place in the CDF."""
    rng = np.random.default_rng(15)
    T = 140 * WIDE_R + 3
    geo = tps.launch_geometry(T, B=B)
    rows = geo.rows_per_chunk
    assert geo.wide and rows == 4096 // B
    w = _mass(rng, T, B, 0.3)
    zero = [r for c in range(1, geo.chunks, 9) for r in (c * rows - 1,
                                                          c * rows)]
    w[zero] = 0.0
    w[10 * rows:11 * rows] = 0.0
    cdf = np.cumsum(w.astype(np.float64).sum(axis=1))
    at = (cdf[zero] / cdf[-1] / (1.0 - 1e-5)).astype(np.float32)
    u = np.sort(np.concatenate([
        np.nextafter(at, np.float32(0.0)), at,
        np.nextafter(at, np.float32(1.0)), _uniforms(rng, 64)]))
    _, _, m = _assert_model_matches_plain(w, np.clip(u, 0, 0.99999994))
    assert (m > 0).all()


@pytest.mark.parametrize("T,B,zero_frac", [(6, 3, 0.5), (R + 1, 16, 0.9),
                                           (62500, 16, 0.3),
                                           (1954, 512, 0.3),
                                           (977, 520, 0.9)])
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


@pytest.mark.parametrize("B", [1, 8, 512])
def test_chunked_model_targets_exactly_on_chunk_boundaries(B):
    """Targets equal to each chunk offset, exactly, and one f32 step to
    either side of it: the lower bound must take the last row of the
    chunk before (or the nearest row with mass), as the global search
    does. The exact targets need an f64 u, which the plain version takes
    as it is. At B = 512 the chunks are the wide path's."""
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


@pytest.mark.parametrize("T,B,live", [(1954, 512, 1_000_000),
                                      (977, 512, 500_000), (977, 520, None),
                                      (400, 510, None)])
def test_wide_row_sums_are_the_in_order_sums(T, B, live):
    """The wide path's tree-order row sums (lane partials, then the
    butterfly) equal the in-order f64 sums bit for bit, and so do its
    chunk offsets plus local CDFs and the global cumsum: the sums are
    exact at these shapes, so the order does not matter."""
    rng = np.random.default_rng(T + B)
    w = _mass(rng, T, B, 0.3)
    if live is not None:
        w.reshape(-1)[live:] = 0.0
    in_order = np.cumsum(w.astype(np.float64), axis=1)[:, -1]
    np.testing.assert_array_equal(wide_row_sums(w), in_order)
    rows, _, rs, local, offset = _chunks(w)
    np.testing.assert_array_equal(rs, in_order)
    split = offset[np.arange(T) // rows] + local
    want = torch.cumsum(torch.from_numpy(w).double().sum(dim=1), 0).numpy()
    np.testing.assert_array_equal(split, want)


@pytest.mark.parametrize("B", [16, 512])
@pytest.mark.parametrize("T", [1, 6, 255, 256, 257, 775, 62500, 524288,
                               524289, 2 ** 31 - 1])
def test_launch_geometry_covers_every_row(T, B):
    """Both paths: G chunks of R rows cover T, within the chunk offsets a
    block's shared memory holds; narrow chunks are whole tiles of rows,
    wide ones at most SAMPLER_CHUNK_CELLS cells unless T needs more."""
    geo = tps.launch_geometry(T, B=B)
    R_, G = geo.rows_per_chunk, geo.chunks
    assert geo.wide == (B >= tps.SAMPLER_WIDE_MIN_LANES)
    assert G * R_ >= T > (G - 1) * R_
    assert geo.threads == tps.SAMPLER_THREADS
    if geo.wide:
        assert R_ <= max(1, tps.SAMPLER_CHUNK_CELLS // B,
                         -(-T // tps.SAMPLER_MAX_CHUNKS))
    else:
        assert R_ % geo.threads == 0
    assert 1 <= G <= tps.SAMPLER_MAX_CHUNKS
    # Row sums and local CDF [T] each, chunk totals [G].
    assert geo.scratch_f64 == 2 * T + G
    assert geo.static_smem_bytes < 48 * 1024


@pytest.mark.parametrize("B", [16, 512])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 512, 4096])
def test_launch_geometry_draw_blocks_cover_every_sample(S, B):
    geo = tps.launch_geometry(100, S, B=B)
    P = geo.draw_blocks
    per = -(-S // P)
    assert per <= (tps.SAMPLER_WIDE_DRAW_SAMPLES if geo.wide
                   else tps.SAMPLER_DRAW_SAMPLES)
    assert P * per >= S > (P - 1) * per


def test_launch_geometry_fills_the_card_at_the_apex_shape():
    geo = tps.launch_geometry(APEX[0], 512, B=APEX[1])
    assert geo.chunks >= 132          # the H100's SMs
    assert not geo.wide
    assert (geo.rows_per_chunk, geo.chunks, geo.draw_blocks) == (256, 245, 16)


@pytest.mark.parametrize("T,S,shape", [(1954, 512, (8, 245, 64)),
                                       (977, 256, (7, 140, 32))])
def test_launch_geometry_fills_the_card_at_the_host_planes(T, S, shape):
    """The host plane and a rank's or shard's plane take the wide path, with
    at least 132 chunk blocks (the H100's SMs; 8 at [1954, 512] on the
    narrow path) and one draw block per 8 samples."""
    geo = tps.launch_geometry(T, S, B=512)
    assert geo.wide and geo.chunks >= 132
    assert (geo.rows_per_chunk, geo.chunks, geo.draw_blocks) == shape
    assert tps.launch_geometry(T, S, B=512, wide=False).chunks <= 8


@pytest.mark.parametrize("B", [16, 512])
@pytest.mark.parametrize("members", [1, 2, 4, 7])
def test_launch_geometry_member_axis(members, B):
    """A member axis keeps each member's grid and grows the workspace: a
    scratch and a done and a drawn count per member, one ticket counter."""
    T = APEX[0] if B == 16 else HOST_PLANE[0]
    solo = tps.launch_geometry(T, 512, B=B)
    geo = tps.launch_geometry(T, 512, members, B=B)
    assert geo[:4] == solo[:4] and geo.wide == solo.wide
    assert geo.scratch_f64 == members * solo.scratch_f64
    assert geo.sync_words == 1 + 2 * members and solo.sync_words == 3
