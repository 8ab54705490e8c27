"""A numpy model of the sampler kernel's draw (csrc/stratified_sample.cu),
path by path, for the CPU tests.

The CUDA kernel runs only on the card. This model follows its arithmetic
with the geometry ``launch_geometry`` gives it: the chunk blocks' row sums
(in lane order on the narrow path; on the wide path 32 lane partials of
float4 groups, reduced by a butterfly), chunk-local row CDFs and chunk
offsets; the draw blocks' two-level row search and zero-mass rule; and the
lane pick (in lane order on the narrow path; on the wide path a warp
inclusive scan over rounds of 128 cells and a ballot). The chunk-local
CDFs are in-order scans where the kernel scans in a tree: the plane's f64
sums are exact at the tested shapes, so the two agree (the module note of
the kernel says why).
"""
import numpy as np

from dist_dqn_tpu_torch.ops import sampler as tps

LANES = 32          # a warp
ROUND = 4 * LANES   # cells of one warp-wide float4 load
SPAN = 4 * ROUND    # cells a lane has in flight: four float4 loads


def _quads(rows):
    """[N, B] rows as the wide path reads them: [N, spans, 4 rounds, 32
    lanes, 4 cells] in f64, zeros past B."""
    n, B = rows.shape
    spans = -(-B // SPAN)
    padded = np.zeros((n, spans * SPAN), np.float64)
    padded[:, :B] = rows
    return padded.reshape(n, spans, 4, LANES, 4)


def _quad_sum(q):
    """Each lane's four cells summed in cell order."""
    return ((q[..., 0] + q[..., 1]) + q[..., 2]) + q[..., 3]


def wide_row_sums(w):
    """The wide path's row sums: each lane adds its four-cell sums span by
    span and round by round, then a butterfly over the lanes
    (``__shfl_xor_sync`` at 16, 8, 4, 2, 1); every lane ends with the same
    value, lane 0's is returned."""
    sums = _quad_sum(_quads(w))             # [T, spans, 4, 32]
    part = np.zeros((w.shape[0], LANES), np.float64)
    for k in range(sums.shape[1]):
        for q in range(4):
            part = part + sums[:, k, q]
    lane = np.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        part = part + part[:, lane ^ o]
    return part[:, 0]


def chunks(w, wide=None):
    """Phase 1 of every chunk block and the chunk offsets: the geometry,
    row sums, chunk-local inclusive row CDFs, and offset [G + 1] (the
    exclusive scan of the chunk totals; offset[G] is the total)."""
    T, B = w.shape
    geo = tps.launch_geometry(T, B=B, wide=wide)
    rows, G = geo.rows_per_chunk, geo.chunks
    if geo.wide:
        rs = wide_row_sums(w)
    else:
        rs = np.cumsum(w.astype(np.float64), axis=1)[:, -1]
    local = np.concatenate([np.cumsum(rs[c * rows:(c + 1) * rows])
                            for c in range(G)])
    chunk_total = local[np.minimum(np.arange(1, G + 1) * rows, T) - 1]
    offset = np.concatenate([[0.0], np.cumsum(chunk_total)])
    return geo, rs, local, offset


def _pick_lane(row, residual):
    """The narrow path's lane pick: one thread walks the row in order."""
    cum, last = 0.0, len(row) - 1
    for j, m in enumerate(row.astype(np.float64)):
        cum += m
        if m > 0.0:
            last = j
            if cum >= residual:
                return j
    return last


def _warp_inclusive_scan(x):
    """``__shfl_up_sync`` steps 1, 2, 4, 8, 16: lane l adds lane l - o's
    value of the step before, where l >= o."""
    for o in (1, 2, 4, 8, 16):
        x = np.concatenate([x[:o], x[o:] + x[:-o]])
    return x


def _pick_lane_wide(row, residual):
    """The wide path's lane pick: per round of 128 cells, a warp scan of
    the lanes' four-cell sums plus the carry of the rounds before; the
    first lane that reaches the residual and holds a cell with mass (a
    ballot) walks its four cells; else the last cell with mass."""
    B = len(row)
    quads = _quads(row[None])[0]             # [spans, 4, 32, 4]
    carry, last = 0.0, B - 1
    for k in range(quads.shape[0]):
        for q in range(4):
            c0 = k * SPAN + q * ROUND
            if c0 >= B:
                break
            cells = quads[k, q]              # [32, 4]
            incl = _warp_inclusive_scan(_quad_sum(cells))
            before = np.concatenate([[0.0], incl[:-1]])
            held = (cells > 0).any(axis=1)
            hits = np.flatnonzero(held & (carry + incl >= residual))
            if hits.size:
                src = hits[0]
                cum, pick, lj = carry + before[src], -1, 0
                for e in range(4):
                    cum += cells[src, e]
                    if cells[src, e] > 0.0:
                        lj = e
                        if pick < 0 and cum >= residual:
                            pick = e
                return c0 + 4 * src + (lj if pick < 0 else pick)
            holders = np.flatnonzero(held)
            if holders.size:
                src = holders[-1]
                last = c0 + 4 * src + int(np.flatnonzero(cells[src] > 0)[-1])
            carry = carry + incl[-1]
    return last


def model_draw(w, u, wide=None):
    """The draw blocks' phase 2, sample by sample, on the path
    ``launch_geometry`` routes ``w`` to (or the one ``wide`` forces).
    Returns (t_idx, b_idx, mass_sel, total) as numpy arrays."""
    T, B = w.shape
    geo, rs, local, offset = chunks(w, wide)
    rows, G = geo.rows_per_chunk, geo.chunks
    total = offset[G]
    targets = u.astype(np.float64) * total * (1.0 - 1e-5)

    def cdf_before(r):
        c = r // rows
        return offset[c] if r == c * rows else offset[c] + local[r - 1]

    pick = _pick_lane_wide if geo.wide else _pick_lane
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
        b = pick(w[t], residual)
        t_out.append(t)
        b_out.append(b)
        m_out.append(w[t, b])
    return (np.array(t_out, np.int32), np.array(b_out, np.int32),
            np.array(m_out, np.float32), np.float32(total))
