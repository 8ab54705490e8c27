// Stratified inverse-CDF priority sampler for Hopper (sm_90a).
//
// Replaces the TPU kernel `_sample_kernel` / `pallas_stratified_sample`
// of dist_dqn_tpu/ops/pallas_sampler.py (body :70, wrapper :262). Same
// contract: given a non-negative mass plane w [T, B] (f32, row-major) and
// S stratified uniforms u [S] in [0, 1), return for each sample the ring
// row t_idx, the env lane b_idx, the selected mass w[t, b] and the total
// mass. Targets are u * total * (1 - 1e-5); the row is the first one whose
// cumulative mass reaches the target (= the TPU kernel's count of row-CDF
// entries below it); the lane is the first one whose in-row cumulative
// mass reaches the residual, clamped to row_total * (1 - 1e-6). t_idx is
// clamped to T - 1 and zero-mass cells are never chosen.
//
// Design for this card, not the TPU's: the TPU kernel builds prefix sums
// from triangular matmuls and gathers rows with one-hot matmuls only
// because Mosaic has no cumsum and no dynamic indexing. Here three plain
// launches on the caller's stream do the work:
//   (a) row_sums_kernel: one thread per row sums its B lanes in order;
//   (b) row_cdf_kernel:  one block scans the T row sums tile by tile
//       (cub::BlockScan, carried offset) into the row CDF and the total;
//   (c) draw_kernel:     one thread per sample binary-searches the row
//       CDF and walks the selected row's lanes in order.
//
// Precision: the sums and the CDF are accumulated in f64, where the TPU
// kernel uses f32. At the apex shape (1M cells, total ~7e5) an f32 CDF is
// quantized to 1/16 of a cell's mass, and two f32 summation orders drift
// apart by many ulps: an f32 version of this kernel agreed with the plain
// f32 version on only 96.1% of picks (chip_smoke.py on an H100). In f64 a
// plane of f32 values sums exactly whenever its values span less than
// 2^53, whatever the order, so the kernel, its plain version and a float64
// reference pick the same cells. Inputs and outputs stay f32.
//
// Bound: the plane is read once. At the apex preset's shape (T=62500,
// B=16, 4.0 MB) that is about 1.2 us at 3.35 TB/s. At this size the three
// launches and the single-block scan, not bytes, set the time; making the
// kernel fast is later work (ROADMAP.md).
//
// Zero-mass safety. A zero lane adds exactly nothing to an in-order sum,
// so the first lane whose cumulative mass reaches a positive residual has
// mass (the TPU kernel's plateau-start argument). Should a rounded CDF
// still land a pick on a zero-mass row, (c) moves it to the nearest row
// with mass after it (else before it). The plain PyTorch version in
// ops/sampler.py applies the same rules.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kRowThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int kDrawThreads = 128;

__global__ void row_sums_kernel(const float* __restrict__ w, int T, int B,
                                double* __restrict__ rs) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const float* row = w + static_cast<size_t>(t) * B;
  double s = 0.0;
  for (int j = 0; j < B; ++j) s += row[j];
  rs[t] = s;
}

__global__ void __launch_bounds__(kScanThreads)
row_cdf_kernel(const double* __restrict__ rs, int T,
               double* __restrict__ cdf, float* __restrict__ total) {
  using BlockScan = cub::BlockScan<double, kScanThreads>;
  __shared__ typename BlockScan::TempStorage scratch;
  __shared__ double carry;
  if (threadIdx.x == 0) carry = 0.0;
  __syncthreads();
  constexpr int kTile = kScanThreads * kScanItems;
  for (int base = 0; base < T; base += kTile) {
    double items[kScanItems];
    const int first = base + threadIdx.x * kScanItems;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i)
      items[i] = first + i < T ? rs[first + i] : 0.0;
    double tile_total;
    BlockScan(scratch).InclusiveSum(items, items, tile_total);
    const double offset = carry;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i)
      if (first + i < T) cdf[first + i] = offset + items[i];
    __syncthreads();  // every thread has read `carry`; scratch is free
    if (threadIdx.x == 0) carry = offset + tile_total;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = static_cast<float>(cdf[T - 1]);
}

__global__ void draw_kernel(const float* __restrict__ w,
                            const double* __restrict__ rs,
                            const double* __restrict__ cdf,
                            const float* __restrict__ u, int T, int B, int S,
                            int32_t* __restrict__ t_out,
                            int32_t* __restrict__ b_out,
                            float* __restrict__ mass_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S) return;
  const double target = static_cast<double>(u[i]) * cdf[T - 1] * (1.0 - 1e-5);
  // Row: first t with cdf[t] >= target (lower bound).
  int lo = 0, hi = T;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cdf[mid] < target) lo = mid + 1; else hi = mid;
  }
  int t = lo < T ? lo : T - 1;
  double prev = lo > 0 ? cdf[lo - 1] : 0.0;
  if (rs[t] == 0.0) {
    int f = t;
    while (f < T && rs[f] == 0.0) ++f;
    if (f == T) {
      f = t;
      while (f > 0 && rs[f] == 0.0) --f;
    }
    if (f != t) {
      t = f;
      prev = t > 0 ? cdf[t - 1] : 0.0;
    }
  }
  // Lane: first lane with mass whose in-order cumulative mass reaches the
  // residual; the last lane with mass when none does.
  const float* row = w + static_cast<size_t>(t) * B;
  const double residual = fmin(target - prev, rs[t] * (1.0 - 1e-6));
  double cum = 0.0;
  int b = -1, last = B - 1;
  for (int j = 0; j < B; ++j) {
    const float m = row[j];
    cum += m;
    if (m > 0.f) {
      last = j;
      if (cum >= residual) { b = j; break; }
    }
  }
  if (b < 0) b = last;
  t_out[i] = t;
  b_out[i] = b;
  mass_out[i] = row[b];
}

}  // namespace

extern "C" {

// Launches (a), (b), (c) on `stream`; returns the first nonzero
// cudaGetLastError() code, or 0. `rs` [T] and `cdf` [T] (f64) are scratch
// the caller allocates; nothing here allocates or synchronises.
int dqn_stratified_sample(const float* w, const float* u, int T, int B,
                          int S, double* rs, double* cdf, float* total,
                          int32_t* t_idx, int32_t* b_idx, float* mass,
                          void* stream) {
  if (T <= 0 || B <= 0 || S <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  row_sums_kernel<<<(T + kRowThreads - 1) / kRowThreads, kRowThreads, 0,
                    s>>>(w, T, B, rs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  row_cdf_kernel<<<1, kScanThreads, 0, s>>>(rs, T, cdf, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  draw_kernel<<<(S + kDrawThreads - 1) / kDrawThreads, kDrawThreads, 0, s>>>(
      w, rs, cdf, u, T, B, S, t_idx, b_idx, mass);
  return cudaGetLastError();
}

const char* dqn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
