// Stratified inverse-CDF priority sampler for Hopper (sm_90a), one launch.
//
// Replaces the TPU kernel `_sample_kernel` / `pallas_stratified_sample`
// of dist_dqn_tpu/ops/pallas_sampler.py (body :70, wrapper :262). Same
// contract: given a non-negative mass plane w [T, B] (f32, row-major) and
// S stratified uniforms u [S] in [0, 1), return for each sample the ring
// row t_idx, the env lane b_idx, the selected mass w[t, b] and the total
// mass. A population draws M planes at once, w [M, T, B] and u [M, S], the
// counterpart of the JAX package's vmapped `pallas_call` (a member axis on
// its grid): one launch, each member's draw computed exactly as a launch on
// its plane alone would compute it. Targets are u * total * (1 - 1e-5); the row is the first one whose
// cumulative mass reaches the target (= the TPU kernel's count of row-CDF
// entries below it); the lane is the first one whose in-row cumulative
// mass reaches the residual, clamped to row_total * (1 - 1e-6). t_idx is
// clamped to T - 1 and zero-mass cells are never chosen.
//
// What bounds it. The plane is read once: at the apex preset's shape
// (T=62500, B=16) that is 4.0 MB, about 1.2 us at 3.35 TB/s, so bytes
// bound it. At this size the card never comes near that bound: launch
// gaps and the latency of a scan over T rows and of S dependent searches
// set the time. So the design spends as few of those as it can, in one of
// two paths that the wrapper picks by the row width B (kWideMinLanes,
// mirrored as SAMPLER_WIDE_MIN_LANES in ops/sampler.py; no flag or
// environment variable picks it). The narrow path:
//   * One launch of G + P blocks. G chunk blocks each own a chunk of R
//     consecutive rows (launch_geometry in ops/sampler.py: R=256, G=245 at
//     the apex shape, so every SM scans a chunk; no block walks all T
//     rows). P draw blocks take 32 samples each (P=16 at S=512).
//   * Phase 1, in every chunk block: one thread per row sums its lanes in
//     lane order, read as float4 (scalar loads when B % 4 != 0 or w is not
//     16-byte aligned); a block scan turns the chunk's row sums into a
//     chunk-local row CDF; the row sums, the local CDF and the chunk's
//     total go to scratch.
//   * Hand-off, with no grid-wide barrier: each chunk block fences its
//     writes and counts itself done.
//   * Phase 2, in the draw blocks, which start with the chunk blocks and
//     wait for that count: each scans the G chunk totals in shared memory
//     into chunk offsets and the total; then one thread per sample finds
//     the chunk by binary search of the offsets, the row by a search of
//     that chunk's R local CDF entries (not all T) in rounds of 16
//     independent loads (two rounds for R=256, where a binary search would
//     wait on eight loads one after another), and the lane from the row
//     read as float4 in flight with its mass.
//   * Why draw blocks, and not the last chunk block, draw: in a first
//     version that block drew all 512 samples, which took over half the
//     kernel's time on an H100 and kept it slower than one torch.cumsum +
//     torch.searchsorted: the draws' scattered loads queued on one SM's
//     load unit. Spread over 16 SMs they wait on latency only. A second
//     launch would spread them too, at the price of a launch gap.
//
// The wide-row path. The narrow path's cost grows with B, not with the
// bytes: at the host-replay plane [1954, 512] (the same 4.0 MB as apex) it
// took 0.0546 ms against apex's 0.0101, and 0.0538 ms at [977, 512], half
// the bytes (PERF.md). Three causes, each one float4 round at B=16: chunks
// of 256 rows leave 8 (or 4) chunk blocks to scan the whole plane; one
// thread sums a whole row, 32 rounds of loads 2 KB apart from its
// neighbours' (every warp-wide load touches 32 segments) and a chain of
// 512 dependent f64 adds; and one thread walks a whole row per sample,
// in only S / 32 draw blocks. The wide path puts a warp where the narrow
// one puts a thread:
//   * Phase 1: one warp per row. Lane l loads float4 number l, l + 32,
//     l + 64 and l + 96 of each span of 512 cells, all four in flight, so
//     each warp-wide load reads 512 contiguous bytes (wider rows take more
//     spans; scalar loads under the narrow path's rule). Each lane sums its
//     cells in f64 and a butterfly of __shfl_xor_sync gives every lane the
//     row sum. A chunk holds about as many cells as a narrow chunk at the
//     apex shape (4096), in whole rows, but fewer rows where that would
//     leave fewer than 132 chunk blocks (the H100's SMs) and T allows
//     more: R = 8 and G = 245 at [1954, 512], R = 7 and G = 140 at
//     [977, 512]. The chunk-local CDF, the chunk totals, the fence and the
//     done count are the narrow path's.
//   * Phase 2: one warp per sample, 8 samples per draw block (P=64 at
//     S=512). The chunk and row search are the narrow path's, run alike in
//     every lane (every probe is one broadcast load). The lane pick reads
//     the row in the same coalesced layout, a span's four loads in flight:
//     in round q (cells [128q, 128q + 128) of a span) each lane sums its
//     four cells in f64, a 5-step warp inclusive scan plus the carry of
//     the rounds before gives each lane its cumulative mass in cell order,
//     and a ballot finds the first lane whose cumulative mass reaches the
//     residual and that holds a positive cell. Only that lane walks its
//     four cells. The "last cell with mass" fallback comes from a ballot
//     of the lanes that hold mass.
//   * Where the crossover lies: B = 128 (kWideMinLanes below says why).
//
// Both paths: every sync word goes back to zero before the kernel ends
// (atomicInc wraps at its last ticket; the last draw block to see the
// done count resets it), so a CUDA graph captures the launch and replays
// it. One set of sync words and one scratch buffer serve one stream at a
// time, which is how the port draws. The member axis: M * (G + P) blocks.
// Member m's chunk blocks hold tickets m * G + c, its draw blocks tickets
// M * G + m * P + d, so every chunk ticket is handed out before any draw
// ticket; member m has its own done and drawn counts and its own scratch,
// so a draw block waits only for its own member's chunks and reads only
// their sums. Each path is its own instantiation of the kernel, so the
// narrow path compiles as it did before the wide one existed.
//
// Precision: the sums and the CDF are accumulated in f64, where the TPU
// kernel uses f32. At the apex shape (1M cells, total ~7e5) an f32 CDF is
// quantized to 1/16 of a cell's mass, and two f32 summation orders drift
// apart by many ulps: an f32 version of this kernel agreed with the plain
// f32 version on only 96.1% of picks (chip_smoke.py on an H100). In f64 a
// plane of f32 values sums exactly whenever its values span less than
// 2^53 of the smallest one's ulps, whatever the order, so the kernel, its
// plain version and a float64 reference pick the same cells. Inputs and
// outputs stay f32. The same argument covers the wide path, whose row sum
// is a tree (lane partials, then the butterfly) and whose in-row
// cumulative mass is a warp scan of lane sums plus a carry, where the
// narrow path and the plain version add in lane order: every one of those
// sums is exact, so each equals the in-order sum, and both paths pick the
// plain version's cells. Where the sums are not exact, the wide path stays
// defined: the lane that the ballot finds walks its own four cells, and
// should rounding leave none of them at the residual it takes its last
// cell with mass.
//
// Why the split into chunks is exact. The row CDF at row t of chunk c is
// offset[c] + local[t]. Whenever the plane's sums are exact in f64 (values
// in [0.1, 2) over 1M cells need under 53 bits), that equals the global
// cumsum at t, so the two-level search picks the row a search of the
// global CDF picks. Whatever the rounding, the search stays defined: a
// search within the chunk that finds no row there returns the next
// chunk's first row, whose CDF is at least that chunk's offset.
//
// Zero-mass safety. A zero lane adds exactly nothing to an in-order sum,
// so the first lane whose cumulative mass reaches a positive residual has
// mass (the TPU kernel's plateau-start argument). A zero adds nothing to
// the warp scan either, so in the wide path the first lane whose
// cumulative mass reaches the residual and that holds a positive cell
// holds the first cell with mass that reaches it. Should a rounded CDF
// still land a pick on a zero-mass row, the draw moves it to the nearest
// row with mass after it (else before it), across chunk boundaries. With
// exact sums only a target of 0 gets there. The plain PyTorch version in
// ops/sampler.py applies the same rules.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Mirrored by SAMPLER_THREADS, SAMPLER_MAX_CHUNKS and SAMPLER_WIDE_MIN_LANES
// in ops/sampler.py.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 2048;
constexpr int kGroup = 16;  // lanes loaded at once
constexpr int kFan = 16;    // independent probes per search round
constexpr unsigned kFullMask = 0xffffffffu;
// The wide path from this row width on: where it starts to win. At about
// 1M cells and S = 512 (chip_smoke.py's width sweep on an H100 80GB HBM3
// at 700 W; PERF.md), the narrow path wins at B = 16 and 32 (0.0101 and
// 0.0122 ms against 0.0303 and 0.0197): its thread reads a row in one or
// two float4 groups, where a warp would leave most of its lanes idle on a
// 64- or 128-byte row. At B = 64 the two tie (0.0141 against 0.0143 ms).
// From B = 128 on the wide path wins and holds its time (0.0117, 0.0111
// and 0.0107 ms at 128, 256 and 512 lanes) while the narrow path's grows
// with B (0.0199, 0.0314, 0.0550 ms): its thread sums a row in B / 16
// dependent rounds of loads, and walks one for each sample.
constexpr int kWideMinLanes = 128;
// The wide path reads a row in spans of kSpan cells: kRounds float4 loads
// a lane, each one warp-wide read of kRound consecutive cells.
constexpr int kRounds = 4;
constexpr int kRound = 128;
constexpr int kSpan = kRounds * kRound;

// The kernel's only shared memory (16,464 bytes). Draw blocks use
// `offset`; the wide path's chunk blocks use `rows`.
struct Shared {
  union {
    double offset[kMaxChunks + 1];  // chunk totals, then chunk offsets
    double rows[kThreads];          // one tile's row sums
  };
  double warp[kWarps];            // block_scan's per-warp sums
  unsigned ticket;                // this block's start ticket
};

// Block-wide scan of one f64 per thread: returns the inclusive sum and
// sets the exclusive sum and the block's total. Every thread calls it.
__device__ double block_scan(double x, double* warp_sums, double* exclusive,
                             double* block_total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x += y;
  }
  double before = __shfl_up_sync(kFullMask, x, 1);
  if (lane == 0) before = 0.0;
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    double s = lane < kWarps ? warp_sums[lane] : 0.0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const double y = __shfl_up_sync(kFullMask, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  if (warp > 0) {
    x += warp_sums[warp - 1];
    before += warp_sums[warp - 1];
  }
  *exclusive = before;
  *block_total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is free for the next call
  return x;
}

// Lanes [j, j + kGroup) of a row into m, zeros past B: four float4 or
// sixteen scalar loads, all issued before any is used.
__device__ __forceinline__ void load_lanes(const float* __restrict__ row,
                                           int j, int B, bool vec,
                                           float (&m)[kGroup]) {
  if (vec) {
    const float4* r4 = reinterpret_cast<const float4*>(row + j);
#pragma unroll
    for (int q = 0; q < kGroup / 4; ++q) {
      const float4 v = j + 4 * q < B ? __ldg(r4 + q)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
      m[4 * q] = v.x;
      m[4 * q + 1] = v.y;
      m[4 * q + 2] = v.z;
      m[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) m[k] = j + k < B ? __ldg(row + j + k) : 0.f;
  }
}

// The row's lanes summed in lane order (the zeros past B add nothing).
__device__ __forceinline__ double row_sum(const float* __restrict__ row,
                                          int B, bool vec) {
  double s = 0.0;
  for (int j = 0; j < B; j += kGroup) {
    float m[kGroup];
    load_lanes(row, j, B, vec, m);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) s += m[k];
  }
  return s;
}

// The first lane with mass whose in-order cumulative mass reaches
// `residual`; the last lane with mass when none does (B - 1 when the row
// has none). `m` holds the row's first kGroup lanes, already loaded; the
// selected lane's mass goes to *mass.
__device__ __forceinline__ int pick_lane(const float* __restrict__ row,
                                         int B, bool vec, double residual,
                                         float (&m)[kGroup], float* mass) {
  double cum = 0.0;
  int last = B - 1;
  float last_mass = 0.f;
  for (int j = 0; j < B; j += kGroup) {
    if (j > 0) load_lanes(row, j, B, vec, m);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      cum += m[k];
      if (m[k] > 0.f) {
        last = j + k;
        last_mass = m[k];
        if (cum >= residual) {
          *mass = m[k];
          return j + k;
        }
      }
    }
  }
  *mass = last_mass;
  return last;
}

// Cells [4f, 4f + 4) of a row, zeros past B: one float4 load, or four
// scalar loads when the row is not float4-aligned (when vec is false).
__device__ __forceinline__ float4 load_quad(const float* __restrict__ row,
                                            int f, int B, bool vec) {
  const int c = 4 * f;
  if (vec)
    return c < B ? __ldg(reinterpret_cast<const float4*>(row) + f)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(c < B ? __ldg(row + c) : 0.f,
                     c + 1 < B ? __ldg(row + c + 1) : 0.f,
                     c + 2 < B ? __ldg(row + c + 2) : 0.f,
                     c + 3 < B ? __ldg(row + c + 3) : 0.f);
}

// This lane's cells of span k of a row (the wide path's layout): in round
// q, cells [k * kSpan + q * kRound + 4 * lane, ... + 4), so each warp-wide
// load reads kRound consecutive cells. All kRounds loads are issued before
// any is used.
__device__ __forceinline__ void load_span(const float* __restrict__ row,
                                          int k, int B, bool vec, int lane,
                                          float4 (&m)[kRounds]) {
#pragma unroll
  for (int q = 0; q < kRounds; ++q)
    m[q] = load_quad(row, (k * kSpan + q * kRound) / 4 + lane, B, vec);
}

// A lane's four cells summed in cell order, in f64.
__device__ __forceinline__ double quad_sum(const float4& v) {
  return ((static_cast<double>(v.x) + v.y) + v.z) + v.w;
}

// The wide path's row sum, the same in every lane of the warp: each lane
// sums its cells span by span and round by round, then a butterfly adds
// the 32 lane partials (each pair adds the same two values, so every lane
// ends with the same sum).
__device__ __forceinline__ double warp_row_sum(const float* __restrict__ row,
                                               int B, bool vec, int lane) {
  double s = 0.0;
  for (int k = 0; k * kSpan < B; ++k) {
    float4 m[kRounds];
    load_span(row, k, B, vec, lane, m);
#pragma unroll
    for (int q = 0; q < kRounds; ++q) s += quad_sum(m[q]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFullMask, s, o);
  return s;
}

// The wide path's pick_lane, the same in every lane of the warp: the first
// cell with mass whose cumulative mass reaches `residual`; the last cell
// with mass when none does (B - 1 when the row has none). `m` holds the
// row's first span, already loaded. In each round a warp inclusive scan of
// the lanes' four-cell sums, plus the carry of the rounds before, gives
// each lane its cumulative mass at its last cell; a ballot finds the first
// lane that reaches the residual and holds a cell with mass, and that
// lane's walk of its four cells gives the cell. The selected cell's mass
// goes to *mass.
__device__ __forceinline__ int pick_lane_wide(const float* __restrict__ row,
                                              int B, bool vec,
                                              double residual, int lane,
                                              float4 (&m)[kRounds],
                                              float* mass) {
  double carry = 0.0;
  int last = B - 1;
  float last_mass = 0.f;
  for (int k = 0; k * kSpan < B; ++k) {
    if (k > 0) load_span(row, k, B, vec, lane, m);
#pragma unroll
    for (int q = 0; q < kRounds; ++q) {
      const int c0 = k * kSpan + q * kRound;  // the round's first cell
      if (c0 >= B) break;
      const float cell[4] = {m[q].x, m[q].y, m[q].z, m[q].w};
      double incl = quad_sum(m[q]);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double y = __shfl_up_sync(kFullMask, incl, o);
        if (lane >= o) incl += y;
      }
      double before = __shfl_up_sync(kFullMask, incl, 1);
      if (lane == 0) before = 0.0;
      const bool held = cell[0] > 0.f || cell[1] > 0.f || cell[2] > 0.f ||
                        cell[3] > 0.f;
      const unsigned hits =
          __ballot_sync(kFullMask, held && carry + incl >= residual);
      if (hits) {
        // The walk: the lane's first cell with mass at the residual, else
        // (only where rounding leaves none) its last cell with mass.
        const int src = __ffs(hits) - 1;
        double cum = carry + before;
        int j = -1, lj = 0;
        float jm = 0.f, lm = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          cum += cell[e];
          if (cell[e] > 0.f) {
            lj = e;
            lm = cell[e];
            if (j < 0 && cum >= residual) {
              j = e;
              jm = cell[e];
            }
          }
        }
        if (j < 0) {
          j = lj;
          jm = lm;
        }
        *mass = __shfl_sync(kFullMask, jm, src);
        return c0 + 4 * src + __shfl_sync(kFullMask, j, src);
      }
      const unsigned holders = __ballot_sync(kFullMask, held);
      if (holders) {
        const int src = 31 - __clz(holders);
        const int lj = cell[3] > 0.f   ? 3
                       : cell[2] > 0.f ? 2
                       : cell[1] > 0.f ? 1
                                       : 0;
        const float lm = cell[3] > 0.f   ? cell[3]
                         : cell[2] > 0.f ? cell[2]
                         : cell[1] > 0.f ? cell[1]
                                         : cell[0];
        last = c0 + 4 * src + __shfl_sync(kFullMask, lj, src);
        last_mass = __shfl_sync(kFullMask, lm, src);
      }
      carry += __shfl_sync(kFullMask, incl, 31);
    }
  }
  *mass = last_mass;
  return last;
}

// Row CDF before row r (r in [0, T]): offset[c] at the start of chunk c,
// else offset[c] + local[r - 1].
__device__ double cdf_before(const double* offset, const double* local, int r,
                             int R) {
  const int c = r / R;
  return r == c * R ? offset[c] : offset[c] + __ldcg(local + r - 1);
}

// Level 2 of the search: the first row of chunk c whose offset[c] +
// local[t] reaches `target`, in rounds of kFan independent loads. Each
// round cuts [a, b) into kFan parts and keeps the first part whose last
// entry reaches the target; the last round reads every entry left.
// Returns that row (the chunk's end when no row reaches the target, which
// only rounding can cause) and sets *prev to offset[c] + local[row - 1]
// (offset[c] for the chunk's first row).
__device__ __forceinline__ int search_chunk(const double* local,
                                            const double* offset, int c,
                                            int R, int T, double target,
                                            double* prev) {
  const double base = offset[c];
  int a = c * R;
  int b = T - a < R ? T : a + R;
  double before = base;  // the row CDF before row a
  while (b - a > kFan) {
    const int part = (b - a + kFan - 1) / kFan;
    double v[kFan];
#pragma unroll
    for (int k = 0; k < kFan; ++k)
      v[k] = base + __ldcg(local + min(a + (k + 1) * part, b) - 1);
    int keep = 0;
#pragma unroll
    for (int k = 0; k < kFan; ++k) {
      if (v[k] < target) {
        keep = k + 1;
        before = v[k];
      }
    }
    const int na = min(a + keep * part, b);
    b = min(a + (keep + 1) * part, b);
    a = na;
  }
  double v[kFan];
#pragma unroll
  for (int k = 0; k < kFan; ++k)
    v[k] = a + k < b ? base + __ldcg(local + a + k) : target;
  int row = a;
#pragma unroll
  for (int k = 0; k < kFan; ++k) {
    if (v[k] < target) {
      row = a + k + 1;
      before = v[k];
    }
  }
  *prev = before;
  return row;
}

// Every block's role comes from a ticket it takes when it starts, not from
// blockIdx: the first M * G tickets scan chunks (member m's chunk c at
// m * G + c), the next M * P draw samples (member m's draw block d at
// M * G + m * P + d). A draw block waits for its member's chunk blocks,
// and it holds a ticket that was handed out after all of theirs, so every
// block it waits for is already running and waits for nothing itself. The
// wait cannot deadlock, however the card schedules blocks, and needs no
// cooperative launch. Sync words (_sync_words in ops/sampler.py): the
// ticket counter, then M done counts, then M drawn counts.
constexpr int kStart = 0;
__device__ __forceinline__ unsigned int* done_count(unsigned int* sync,
                                                    int m) {
  return sync + 1 + m;
}
__device__ __forceinline__ unsigned int* drawn_count(unsigned int* sync,
                                                     int M, int m) {
  return sync + 1 + M + m;
}

// A draw block that has waited this long traps (an error the wrapper's
// caller sees) rather than hang the card.
constexpr unsigned long long kMaxWaitNs = 10000000000ull;

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct Scratch {
  double* rs;           // [T] row sums
  double* local;        // [T] chunk-local inclusive row CDF
  double* chunk_total;  // [G]
};

// Phase 1 for chunk c, then the hand-off. Scratch is written here and read
// by the draw blocks of this launch, which read it with __ldcg (from L2,
// never a stale L1 line).
template <bool kWide>
__device__ void scan_chunk(Shared& sh, const float* __restrict__ w, int c,
                           int T, int B, int R, bool vec, const Scratch& sc,
                           unsigned int* done) {
  // Rows [r0, r1), one row per thread per tile of kThreads rows; `carry`
  // is the chunk's sum before the tile.
  const long long r0 = static_cast<long long>(c) * R;
  const long long r1 = r0 + R < T ? r0 + R : T;
  double carry = 0.0;
  for (long long base = r0; base < r1; base += kThreads) {
    const long long t = base + threadIdx.x;
    const bool mine = t < r1;
    double s;
    if constexpr (kWide) {
      // Warp k sums rows k, k + kWarps, ... of the tile into shared
      // memory, where each thread picks up its row's sum.
      const int n = r1 - base < kThreads ? static_cast<int>(r1 - base)
                                         : kThreads;
      const int lane = threadIdx.x & 31;
      for (int k = threadIdx.x >> 5; k < n; k += kWarps) {
        const double rs = warp_row_sum(w + (base + k) * B, B, vec, lane);
        if (lane == 0) sh.rows[k] = rs;
      }
      __syncthreads();
      s = mine ? sh.rows[threadIdx.x] : 0.0;
    } else {
      s = mine ? row_sum(w + t * B, B, vec) : 0.0;
    }
    double before, tile;
    const double incl = carry + block_scan(s, sh.warp, &before, &tile);
    if (mine) {
      sc.rs[t] = s;
      sc.local[t] = incl;
      if (t == r1 - 1) sc.chunk_total[c] = incl;
    }
    carry += tile;
  }
  // Hand-off: publish the chunk, then count it done.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(done, 1u);
  }
}

// Phase 2 for draw block d: samples [d * per, (d + 1) * per), once every
// chunk is done; one thread per sample, or one warp in the wide path.
template <bool kWide>
__device__ void draw_samples(Shared& sh, const float* __restrict__ w,
                             const float* __restrict__ u, int d, int T,
                             int B, int S, int R, int G, int P, bool vec,
                             const Scratch& sc, unsigned int* done,
                             unsigned int* drawn,
                             int32_t* __restrict__ t_out,
                             int32_t* __restrict__ b_out,
                             float* __restrict__ mass_out,
                             float* __restrict__ total_out) {
  const int per = (S + P - 1) / P;
  const int i0 = d * per;
  const int i1 = S - i0 < per ? S : i0 + per;
  const int lane = threadIdx.x & 31;
  const int first = i0 + static_cast<int>(kWide ? threadIdx.x >> 5
                                                : threadIdx.x);
  constexpr int stride = kWide ? kWarps : kThreads;
  // The first uniform is in flight while the block waits.
  float u_next = first < i1 ? __ldg(u + first) : 0.f;
  if (threadIdx.x == 0) {
    const unsigned long long start = now_ns();
    while (*reinterpret_cast<volatile unsigned*>(done) <
           static_cast<unsigned>(G)) {
      __nanosleep(32);
      if (now_ns() - start > kMaxWaitNs) __trap();
    }
    __threadfence();
    // Every draw block of the member has seen the count once the last of
    // them counts itself here, so the count goes back to zero for the next
    // launch.
    const unsigned last = static_cast<unsigned>(P - 1);
    if (atomicInc(drawn, last) == last) atomicExch(done, 0u);
  }
  __syncthreads();

  // Chunk offsets, in every draw block: each thread owns `seg` consecutive
  // chunks; a block scan of the segment sums gives each segment's start.
  const int seg = (G + kThreads - 1) / kThreads;
  const int c0 = threadIdx.x * seg;
  double seg_sum = 0.0;
  for (int k = 0; k < seg; ++k) {
    const int c = c0 + k;
    if (c < G) {
      const double v = __ldcg(sc.chunk_total + c);
      sh.offset[c] = v;
      seg_sum += v;
    }
  }
  double running, unused;
  block_scan(seg_sum, sh.warp, &running, &unused);
  for (int k = 0; k < seg; ++k) {
    const int c = c0 + k;
    if (c < G) {
      const double v = sh.offset[c];
      sh.offset[c] = running;
      running += v;
      if (c == G - 1) {
        sh.offset[G] = running;
        if (d == 0) *total_out = static_cast<float>(running);
      }
    }
  }
  __syncthreads();
  const double total = sh.offset[G];

  // In the wide path every lane of a warp runs the row search alike, and
  // the lanes share the lane pick.
  for (int i = first; i < i1; i += stride) {
    const float ui = u_next;
    if (i + stride < i1) u_next = __ldg(u + i + stride);
    const double target = static_cast<double>(ui) * total * (1.0 - 1e-5);
    // Row: the lower bound on the row CDF, in two levels. The chunk is the
    // first whose end offset[c + 1] reaches the target (shared memory);
    // the row, the first of that chunk whose offset[c] + local[t] does.
    int lo = 0, hi = G;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sh.offset[mid + 1] < target) lo = mid + 1; else hi = mid;
    }
    double prev = 0.0;
    const int count = lo < G ? search_chunk(sc.local, sh.offset, lo, R, T,
                                            target, &prev)
                             : T;
    if (count % R == 0) {
      prev = sh.offset[count / R];  // a chunk's first row, or T = G * R
    } else if (lo == G) {
      prev = cdf_before(sh.offset, sc.local, T, R);
    }
    int t = count < T ? count : T - 1;
    const float* row = w + static_cast<size_t>(t) * B;
    // The row's first cells, in flight with its mass.
    float m[kGroup];
    float4 span[kRounds];
    if constexpr (kWide) load_span(row, 0, B, vec, lane, span);
    else load_lanes(row, 0, B, vec, m);
    double row_mass = __ldcg(sc.rs + t);
    if (row_mass == 0.0) {
      int f = t;
      while (f < T && __ldcg(sc.rs + f) == 0.0) ++f;
      if (f == T) {
        f = t;
        while (f > 0 && __ldcg(sc.rs + f) == 0.0) --f;
      }
      if (f != t) {
        t = f;
        prev = cdf_before(sh.offset, sc.local, t, R);
        row = w + static_cast<size_t>(t) * B;
        if constexpr (kWide) load_span(row, 0, B, vec, lane, span);
        else load_lanes(row, 0, B, vec, m);
        row_mass = __ldcg(sc.rs + t);
      }
    }
    const double residual = fmin(target - prev, row_mass * (1.0 - 1e-6));
    float mass;
    int b;
    if constexpr (kWide)
      b = pick_lane_wide(row, B, vec, residual, lane, span, &mass);
    else
      b = pick_lane(row, B, vec, residual, m, &mass);
    if (!kWide || lane == 0) {
      t_out[i] = t;
      b_out[i] = b;
      mass_out[i] = mass;
    }
  }
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
sample_kernel(const float* __restrict__ w, const float* __restrict__ u,
              int M, int T, int B, int S, int R, int G, int P,
              double* scratch, unsigned int* sync, int32_t* __restrict__ t_out,
              int32_t* __restrict__ b_out, float* __restrict__ mass_out,
              float* __restrict__ total_out) {
  __shared__ Shared sh;
  if (threadIdx.x == 0)
    sh.ticket = atomicInc(sync + kStart,
                          static_cast<unsigned>(M * (G + P) - 1));
  __syncthreads();
  const int ticket = static_cast<int>(sh.ticket);
  const bool chunk = ticket < M * G;
  const int m = chunk ? ticket / G : (ticket - M * G) / P;
  // Member m's plane, uniforms, scratch and outputs.
  const float* wm = w + static_cast<size_t>(m) * T * B;
  const bool vec = (B & 3) == 0 && (reinterpret_cast<uintptr_t>(wm) & 15) == 0;
  double* base = scratch + static_cast<size_t>(m) * (2LL * T + G);
  const Scratch sc{base, base + T, base + 2LL * T};
  if (chunk) {
    scan_chunk<kWide>(sh, wm, ticket - m * G, T, B, R, vec, sc,
                      done_count(sync, m));
  } else {
    const size_t o = static_cast<size_t>(m) * S;
    draw_samples<kWide>(sh, wm, u + o, ticket - M * G - m * P, T, B, S, R,
                        G, P, vec, sc, done_count(sync, m),
                        drawn_count(sync, M, m), t_out + o, b_out + o,
                        mass_out + o, total_out + m);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` for M planes w [M, T, B] and uniforms
// u [M, S]: per member, G chunk blocks of R rows and P draw blocks, on the
// wide-row path when `wide` is nonzero (the caller's launch_geometry);
// outputs t_idx, b_idx and mass [M, S] and total [M]. Returns the
// cudaGetLastError() code, or cudaErrorInvalidValue for sizes the kernel
// does not take. `scratch` holds M * (2 * T + G) f64 (per member: row
// sums, local CDF, chunk totals); `sync` is 1 + 2 * M zeroed u32 words
// that the kernel leaves at zero. One `sync` (and one scratch) serves one
// stream at a time. Nothing here allocates or synchronises.
int dqn_stratified_sample(const float* w, const float* u, int M, int T, int B,
                          int S, int R, int G, int P, int wide,
                          double* scratch, unsigned int* sync, int32_t* t_idx,
                          int32_t* b_idx, float* mass, float* total,
                          void* stream) {
  if (M <= 0 || T <= 0 || B <= 0 || S <= 0 || R <= 0 || R > (1 << 24) ||
      (!wide && R % kThreads != 0) || T > 0x7fffffff - 2 * R || G <= 0 ||
      G > kMaxChunks || (static_cast<long long>(T) + R - 1) / R != G ||
      P <= 0 || P > S || P > (1 << 30) ||
      static_cast<long long>(M) * (G + P) > 0x7fffffff ||
      static_cast<long long>(M) * S > 0x7fffffff)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide)
    sample_kernel<true><<<M * (G + P), kThreads, 0, s>>>(
        w, u, M, T, B, S, R, G, P, scratch, sync, t_idx, b_idx, mass, total);
  else
    sample_kernel<false><<<M * (G + P), kThreads, 0, s>>>(
        w, u, M, T, B, S, R, G, P, scratch, sync, t_idx, b_idx, mass, total);
  return cudaGetLastError();
}

// The larger of the two paths' static shared memory in bytes, or minus a
// CUDA error code.
int dqn_stratified_sample_static_smem() {
  cudaFuncAttributes narrow, wide;
  cudaError_t err = cudaFuncGetAttributes(&narrow, sample_kernel<false>);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&wide, sample_kernel<true>);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return static_cast<int>(narrow.sharedSizeBytes > wide.sharedSizeBytes
                              ? narrow.sharedSizeBytes
                              : wide.sharedSizeBytes);
}

// The row width from which the wrapper takes the wide path.
int dqn_stratified_sample_wide_min_lanes() { return kWideMinLanes; }

const char* dqn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
