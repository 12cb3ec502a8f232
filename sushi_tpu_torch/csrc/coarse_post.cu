// Fused coarse-pass post-processing (kernels K2 + K3 as one design).
//
// Replaces the Pallas TPU kernels in sushi_tpu/ops/pallas_coarse.py:
// _kernel (rows <= 2^17, VMEM-resident; entry coarse_post_pallas) and
// _kernel_tiled (rows > 2^17, a 3-phase sequential grid; entry
// _coarse_post_tiled).  That split existed only for the v5e's VMEM; a GPU
// has no sequential grid to carry state in, so one tiled design covers
// every n (n % 128 == 0) in four launches:
//
//   A. tile_sums:   per-(row, 4096-sample tile) sum of w^2 in float64 and
//                   count of nonzero samples, read coalesced (4 B/sample);
//   B. carry_scan:  one block per row scans the tile sums in place into
//                   exclusive carries, a block-wide scan (not one thread
//                   per row); entry num_tiles holds the row's totals;
//   C. scores:      one block per (row, tile of 4096 lags).  It copies
//                   w over its own lags and the one or two prefix tiles
//                   that cover [u0 + L, u0 + L + 4096), and corr over its
//                   lags, into shared memory with cp.async; rebuilds P and
//                   Z over both ranges there and in registers; computes
//                   the scores and writes only each 128-lag block's first
//                   minimum and first lane, and the lag tile's minimum;
//   D. ties:        one block per row: the row minimum over the tile
//                   minima, then for each tie band (8e-6 and 1e-4) the
//                   first tile whose minimum lies in it; that tile's 4096
//                   scores are recomputed by the same device function as
//                   in C and the first lag in the band is taken.
//
// P(x) = sum_{j<x} w[j]^2 (float64) and Z(x) = #{j < x : w[j] != 0} are
// pure functions of x: P(x) = carry[x / 4096] + the exclusive in-tile
// prefix at x % 4096, by one scan routine (tile_prefix) with one thread
// order, for x < n; P(x) = the row total for x >= n (spans past n read
// P(n)).  So the scores that D recomputes are C's to the bit.  E(u) =
// P(min(u + L, n)) - P(u) rounded to float32, exactly 0 where Z says the
// span holds no nonzero sample (a parallel scan is not constant along a
// run of zeros, so only the integer count decides such spans); the score
// has coarse_scores' conventions (den == 0 -> 2.0, u >= lag_count -> 2.0)
// with the _rn intrinsics (no FMA contraction), op for op the plain
// PyTorch version (ops/coarse.py), so both round alike.  Squares of
// float32 values are exact in float64, so a contracted w*w + s rounds as
// the separate ops would.
//
// Bound on the H100: device-memory bandwidth.  The function must read corr
// and w once and write the block outputs: ~8 B per sample.  This design
// moves ~12-16 B per sample (w twice from device memory, the far tiles
// mostly from L2) and keeps P, Z and the scores out of device memory,
// where writing and reading them back would move ~44 B per sample.
// The wrapper's scratch is [B, n/4096 + 1] carries and [B, n/4096] tile
// minima.  The 128-lag block width is semantic (it fixes the candidate set
// of the exact rescore), not a lane width.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4096;                   // samples per prefix tile = lags per score block
constexpr int kThreads = 256;                 // threads of passes A, C and D
constexpr int kPerThread = kTile / kThreads;  // consecutive samples (lags) per thread
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;                   // candidate block width (semantic)
constexpr int kScanThreads = 1024;            // threads of pass B
constexpr float kPastRow = 3.0f;              // above every score (<= 2): lags >= n

struct TileSmem {
  float near_w[kTile];     // w over the block's own lags
  float far_w[2][kTile];   // the prefix tiles that cover [u0 + L, u0 + L + 4096)
  float corr[kTile];
  // P and Z at u0 + L + k for the k-th lag, at swizzled position
  // (k % 16) * 256 + k / 16, so that a thread's 16 lags are read without
  // bank conflicts
  double far_p[kTile];
  int far_z[kTile];
  double warp_p[kWarps];
  int warp_z[kWarps];
  float warp_min[kWarps];
  int warp_int[kWarps];
};

__device__ __forceinline__ int swizzle(int k) { return (k % kPerThread) * kThreads + k / kPerThread; }

template <typename T>
__device__ __forceinline__ T warp_sum(T value) {
  for (int offset = 16; offset > 0; offset >>= 1) value += __shfl_down_sync(0xffffffffu, value, offset);
  return value;
}

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T value, int lane) {
  for (int offset = 1; offset < 32; offset <<= 1) {
    const T up = __shfl_up_sync(0xffffffffu, value, offset);
    if (lane >= offset) value += up;
  }
  return value;
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void copy_async16(void* shared, const void* global, bool valid) {
  const unsigned address = static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(address), "l"(global),
               "r"(valid ? 16 : 0)
               : "memory");
}

// tile `tile` of a row into shared memory, zeros past n (n % 128 == 0, so a
// group of 4 floats lies wholly inside or wholly past the row)
__device__ __forceinline__ void load_tile_async(float* shared, const float* row, int tile, int n) {
  const long long start = (long long)tile * kTile;
  for (int i = threadIdx.x * 4; i < kTile; i += kThreads * 4) {
    const bool valid = start + i < n;
    copy_async16(shared + i, valid ? row + start + i : row, valid);
  }
}

__device__ __forceinline__ void wait_async_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// The one definition of P and Z inside a tile: for the 16 samples this
// thread owns, x = tile * 4096 + 16 * threadIdx.x + j, p[j] = P(x) and
// z[j] = Z(x), from the tile's carries and an exclusive block scan in a
// fixed order.  Every block that needs P(x) calls this, so the same x
// gives the same bits.
__device__ __forceinline__ void tile_prefix(const float* tile_w, double carry, int count_carry,
                                            double* p, int* z, TileSmem& s) {
  const float4* w4 = reinterpret_cast<const float4*>(tile_w + threadIdx.x * kPerThread);
  double running = 0.0;
  int running_count = 0;
#pragma unroll
  for (int q = 0; q < kPerThread / 4; ++q) {
    const float4 v = w4[q];
    const float values[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[4 * q + e] = running;
      z[4 * q + e] = running_count;
      const double value = values[e];
      running += value * value;
      running_count += values[e] != 0.0f;
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const double inclusive = warp_inclusive_scan(running, lane);
  const int inclusive_count = warp_inclusive_scan(running_count, lane);
  double exclusive = __shfl_up_sync(0xffffffffu, inclusive, 1);
  int exclusive_count = __shfl_up_sync(0xffffffffu, inclusive_count, 1);
  if (lane == 0) {
    exclusive = 0.0;
    exclusive_count = 0;
  }
  if (lane == 31) {
    s.warp_p[warp] = inclusive;
    s.warp_z[warp] = inclusive_count;
  }
  __syncthreads();
  double offset = carry;
  int count_offset = count_carry;
  for (int w = 0; w < warp; ++w) {
    offset += s.warp_p[w];
    count_offset += s.warp_z[w];
  }
  offset += exclusive;
  count_offset += exclusive_count;
  __syncthreads();  // warp_p and warp_z are reused by the next call
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    p[j] = offset + p[j];
    z[j] += count_offset;
  }
}

struct Rows {
  const float* corr;
  const float* windows;
  const int* pat_lens;
  const int* lag_counts;
  const float* pat_energy;
  const double* carry;     // [B, num_tiles + 1]
  const int* count_carry;  // [B, num_tiles + 1]
  int n;
  int num_tiles;
};

// The scores of lags u = tile * 4096 + 16 * threadIdx.x + j (j < 16) of row
// b; kPastRow for u >= n.  All threads of the block call it together.
__device__ __forceinline__ void tile_scores(const Rows& r, int b, int tile, TileSmem& s, float* score) {
  const int n = r.n;
  const float* row_w = r.windows + (size_t)b * n;
  const double* row_carry = r.carry + (size_t)b * (r.num_tiles + 1);
  const int* row_count = r.count_carry + (size_t)b * (r.num_tiles + 1);
  const int u0 = tile * kTile;
  const int pat_len = min(max(r.pat_lens[b], 0), n);
  const long long far_start = (long long)u0 + pat_len;
  // the prefix tiles over [far_start, far_start + 4096) that start before n
  // (ops/coarse.py score_block_tiles says the same)
  const int far_first = far_start < n ? (int)(far_start / kTile) : 0;
  const int far_count = far_start >= n ? 0
                        : (far_start % kTile == 0 || (long long)(far_first + 1) * kTile >= n) ? 1 : 2;

  __syncthreads();  // a previous call's readers are done with the buffers
  load_tile_async(s.near_w, row_w, tile, n);
  load_tile_async(s.corr, r.corr + (size_t)b * n, tile, n);
  for (int k = 0; k < far_count; ++k) load_tile_async(s.far_w[k], row_w, far_first + k, n);
  wait_async_copies();

  const int base = threadIdx.x * kPerThread;
  const double p_total = row_carry[r.num_tiles];
  const int z_total = row_count[r.num_tiles];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (far_start + base + j >= n) {  // spans that end at or past n read P(n)
      s.far_p[swizzle(base + j)] = p_total;
      s.far_z[swizzle(base + j)] = z_total;
    }
  }
  double p[kPerThread];
  int z[kPerThread];
  for (int k = 0; k < far_count; ++k) {
    const int far_tile = far_first + k;
    tile_prefix(s.far_w[k], row_carry[far_tile], row_count[far_tile], p, z, s);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const long long x = (long long)far_tile * kTile + base + j;
      const long long at = x - far_start;
      if (x < n && at >= 0 && at < kTile) {
        s.far_p[swizzle((int)at)] = p[j];
        s.far_z[swizzle((int)at)] = z[j];
      }
    }
  }
  tile_prefix(s.near_w, row_carry[tile], row_count[tile], p, z, s);
  __syncthreads();  // far_p and far_z are complete

  const float pe = r.pat_energy[b];
  const int lag_count = r.lag_counts[b];
  const float4* corr4 = reinterpret_cast<const float4*>(s.corr + base);
#pragma unroll
  for (int q = 0; q < kPerThread / 4; ++q) {
    const float4 v = corr4[q];
    const float corr[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * q + e;
      const int u = u0 + base + j;
      const int at = swizzle(base + j);
      const float energy = s.far_z[at] == z[j] ? 0.0f : fmaxf((float)(s.far_p[at] - p[j]), 0.0f);
      const float num = fmaxf(__fadd_rn(__fsub_rn(pe, __fmul_rn(2.0f, corr[e])), energy), 0.0f);
      const float den = __fsqrt_rn(__fmul_rn(pe, energy));
      float value = den > 0.0f ? __fdiv_rn(num, den) : 2.0f;
      if (u >= lag_count) value = 2.0f;
      score[j] = u < n ? value : kPastRow;
    }
  }
}

__device__ float block_min(float value, TileSmem& s) {
  for (int offset = 16; offset > 0; offset >>= 1) value = fminf(value, __shfl_xor_sync(0xffffffffu, value, offset));
  if ((threadIdx.x & 31) == 0) s.warp_min[threadIdx.x >> 5] = value;
  __syncthreads();
  float result = s.warp_min[0];
  for (int w = 1; w < kWarps; ++w) result = fminf(result, s.warp_min[w]);
  __syncthreads();
  return result;
}

__device__ int block_min_int(int value, TileSmem& s) {
  for (int offset = 16; offset > 0; offset >>= 1) value = min(value, __shfl_xor_sync(0xffffffffu, value, offset));
  if ((threadIdx.x & 31) == 0) s.warp_int[threadIdx.x >> 5] = value;
  __syncthreads();
  int result = s.warp_int[0];
  for (int w = 1; w < kWarps; ++w) result = min(result, s.warp_int[w]);
  __syncthreads();
  return result;
}

// A: per-tile sums of w^2 and counts of nonzero samples, into the carry
// arrays (scanned in place by B)
__global__ void __launch_bounds__(kThreads) tile_sums_kernel(
    const float* __restrict__ windows, double* __restrict__ carry, int* __restrict__ count_carry,
    int n, int num_tiles) {
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const float* window = windows + (size_t)b * n;
  const int start = tile * kTile;
  const int end = min(start + kTile, n);
  double sum = 0.0;
  int count = 0;
  for (int x = start + threadIdx.x * 4; x < end; x += kThreads * 4) {
    const float4 v = *reinterpret_cast<const float4*>(window + x);
    const float values[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const double value = values[e];
      sum += value * value;
      count += values[e] != 0.0f;
    }
  }
  __shared__ double partial[kWarps];
  __shared__ int partial_count[kWarps];
  sum = warp_sum(sum);
  count = warp_sum(count);
  if ((threadIdx.x & 31) == 0) {
    partial[threadIdx.x >> 5] = sum;
    partial_count[threadIdx.x >> 5] = count;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    int total_count = 0;
    for (int w = 0; w < kWarps; ++w) {
      total += partial[w];
      total_count += partial_count[w];
    }
    carry[(size_t)b * (num_tiles + 1) + tile] = total;
    count_carry[(size_t)b * (num_tiles + 1) + tile] = total_count;
  }
}

// B: exclusive scan of the tile sums in place, one block per row, in
// chunks of 1024 tiles; entry num_tiles gets the row totals
__global__ void __launch_bounds__(kScanThreads) carry_scan_kernel(
    double* __restrict__ carry, int* __restrict__ count_carry, int num_tiles) {
  __shared__ double warp_totals[kScanThreads / 32];
  __shared__ int warp_counts[kScanThreads / 32];
  double* row = carry + (size_t)blockIdx.x * (num_tiles + 1);
  int* row_count = count_carry + (size_t)blockIdx.x * (num_tiles + 1);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  double running = 0.0;  // the same in every thread
  int running_count = 0;
  for (int start = 0; start < num_tiles; start += kScanThreads) {
    const int t = start + threadIdx.x;
    const double value = t < num_tiles ? row[t] : 0.0;
    const int count = t < num_tiles ? row_count[t] : 0;
    const double inclusive = warp_inclusive_scan(value, lane);
    const int inclusive_count = warp_inclusive_scan(count, lane);
    if (lane == 31) {
      warp_totals[warp] = inclusive;
      warp_counts[warp] = inclusive_count;
    }
    __syncthreads();
    double offset = running;
    int count_offset = running_count;
    for (int w = 0; w < warp; ++w) {
      offset += warp_totals[w];
      count_offset += warp_counts[w];
    }
    if (t < num_tiles) {
      row[t] = offset + (inclusive - value);
      row_count[t] = count_offset + (inclusive_count - count);
    }
    for (int w = 0; w < kScanThreads / 32; ++w) {
      running += warp_totals[w];
      running_count += warp_counts[w];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    row[num_tiles] = running;
    row_count[num_tiles] = running_count;
  }
}

// C: scores of one (row, lag tile); each 128-lag block's first minimum and
// first lane, and the lag tile's minimum
__global__ void __launch_bounds__(kThreads) scores_kernel(
    Rows r, float* __restrict__ block_min_out, int* __restrict__ block_arg_out,
    float* __restrict__ tile_min_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem& s = *reinterpret_cast<TileSmem*>(smem_raw);
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  float score[kPerThread];
  tile_scores(r, b, tile, s, score);

  // first minimum of this thread's 16 lags, then of its 128-lag block (8
  // threads): min value, lowest lane on ties
  float value = score[0];
  int arg = 0;
#pragma unroll
  for (int j = 1; j < kPerThread; ++j) {
    if (score[j] < value) {
      value = score[j];
      arg = j;
    }
  }
  int lane = (threadIdx.x % (kLanes / kPerThread)) * kPerThread + arg;
  for (int offset = 1; offset < kLanes / kPerThread; offset <<= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, value, offset);
    const int other_lane = __shfl_xor_sync(0xffffffffu, lane, offset);
    if (other < value || (other == value && other_lane < lane)) {
      value = other;
      lane = other_lane;
    }
  }
  const int num_blocks = r.n / kLanes;
  const int block = tile * (kTile / kLanes) + threadIdx.x / (kLanes / kPerThread);
  if (threadIdx.x % (kLanes / kPerThread) == 0 && block < num_blocks) {
    block_min_out[(size_t)b * num_blocks + block] = value;
    block_arg_out[(size_t)b * num_blocks + block] = lane;
  }
  const float tile_min = block_min(value, s);
  if (threadIdx.x == 0) tile_min_out[(size_t)b * r.num_tiles + tile] = tile_min;
}

// first lag of `tile` whose score is <= threshold (scores from tile_scores)
__device__ __forceinline__ int first_lag_in_band(const float* score, int tile, float threshold, TileSmem& s) {
  int first = kTile;
#pragma unroll
  for (int j = kPerThread - 1; j >= 0; --j) {
    if (score[j] <= threshold) first = threadIdx.x * kPerThread + j;
  }
  return tile * kTile + block_min_int(first, s);
}

// first tile whose minimum is <= threshold, num_tiles when none
__device__ int first_tile_in_band(const float* row_tile_min, int num_tiles, float threshold, TileSmem& s) {
  int first = num_tiles;
  for (int t = threadIdx.x; t < num_tiles; t += kThreads) {
    if (row_tile_min[t] <= threshold) {
      first = t;
      break;
    }
  }
  return block_min_int(first, s);
}

// D: row minimum, then the tight / loose tie seeds; one block per row.  A
// seed is the first lag inside its band (0 when none, like argmax of an
// all-false mask); the first tile whose minimum lies in the band holds it.
__global__ void __launch_bounds__(kThreads) ties_kernel(
    Rows r, const float* __restrict__ tile_min, int* __restrict__ first_tight,
    int* __restrict__ first_loose) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem& s = *reinterpret_cast<TileSmem*>(smem_raw);
  const int b = blockIdx.x;
  const float* row_tile_min = tile_min + (size_t)b * r.num_tiles;
  float value = kPastRow;
  for (int t = threadIdx.x; t < r.num_tiles; t += kThreads) value = fminf(value, row_tile_min[t]);
  const float gmin = block_min(value, s);
  const float scale = __fadd_rn(1.0f, fabsf(gmin));
  const float tight = __fadd_rn(gmin, __fmul_rn(8e-6f, scale));
  const float loose = __fadd_rn(gmin, __fmul_rn(1e-4f, scale));
  // loose >= tight, so the loose band's tile comes first or is the same
  const int loose_tile = first_tile_in_band(row_tile_min, r.num_tiles, loose, s);
  const int tight_tile = first_tile_in_band(row_tile_min, r.num_tiles, tight, s);
  int loose_lag = 0;
  int tight_lag = 0;
  float score[kPerThread];
  if (loose_tile < r.num_tiles) {
    tile_scores(r, b, loose_tile, s, score);
    loose_lag = first_lag_in_band(score, loose_tile, loose, s);
  }
  if (tight_tile < r.num_tiles) {
    if (tight_tile != loose_tile) tile_scores(r, b, tight_tile, s, score);
    tight_lag = first_lag_in_band(score, tight_tile, tight, s);
  }
  if (threadIdx.x == 0) {
    first_tight[b] = tight_lag;
    first_loose[b] = loose_lag;
  }
}

}  // namespace

extern "C" int sushi_coarse_post(
    const float* corr, const float* windows, const int* pat_lens, const int* lag_counts,
    const float* pat_energy, float* block_min, int* block_arg, int* first_tight,
    int* first_loose, double* carry, int* count_carry, float* tile_min, int batch, int n,
    void* stream_ptr) {
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int num_tiles = (n + kTile - 1) / kTile;
  const int smem = static_cast<int>(sizeof(TileSmem));
  cudaError_t status;
  if ((status = cudaFuncSetAttribute(scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
    return static_cast<int>(status);
  if ((status = cudaFuncSetAttribute(ties_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
    return static_cast<int>(status);
  const Rows rows{corr, windows, pat_lens, lag_counts, pat_energy, carry, count_carry, n, num_tiles};

  tile_sums_kernel<<<dim3(num_tiles, batch), kThreads, 0, stream>>>(windows, carry, count_carry, n, num_tiles);
  if ((status = cudaGetLastError()) != cudaSuccess) return static_cast<int>(status);
  carry_scan_kernel<<<batch, kScanThreads, 0, stream>>>(carry, count_carry, num_tiles);
  if ((status = cudaGetLastError()) != cudaSuccess) return static_cast<int>(status);
  scores_kernel<<<dim3(num_tiles, batch), kThreads, smem, stream>>>(rows, block_min, block_arg, tile_min);
  if ((status = cudaGetLastError()) != cudaSuccess) return static_cast<int>(status);
  ties_kernel<<<batch, kThreads, smem, stream>>>(rows, tile_min, first_tight, first_loose);
  return static_cast<int>(cudaGetLastError());
}
