// Exact SSD rescore at candidate lags (kernel K1).
//
// Replaces the Pallas TPU kernel sushi_tpu/ops/pallas_ssd.py
// (_rescore_kernel, entry rescore_candidates_pallas).  For batch row b and
// candidate k with lag = lags[b, k]:
//
//   num[b, k]    = sum_{i < pat_len[b]} (p[b, i] - w[b, lag + i])^2
//   energy[b, k] = sum_{i < pat_len[b]} w[b, lag + i]^2
//
// with w zero outside [0, n).  The TPU kernel's whole trick — rows laid out
// as (n/128, 128) so a dynamic lag becomes one sublane-start load plus one
// lane roll — existed to keep a row resident in VMEM; a GPU reads the
// window at any offset directly, so the lag is just a pointer offset.
//
// Bound on the H100: device-memory bandwidth.  The function must read each
// row's pattern once and the union of its K candidate spans once (at most
// pat_len * (1 + K) floats); 3 flops per term.  Design: one block per
// (row, chunk of C pattern terms) — C chosen by the wrapper
// (ops/rescore.py rescore_geometry) so that even a lone row fills the
// card's 132 SMs twice over.  The block copies its pattern chunk into
// shared memory once and then streams the K candidates' window segments
// [lag + i0, lag + i0 + C) against it, six candidates at a time so that
// each thread has six independent reads in flight (neighbouring threads
// on neighbouring addresses), so the pattern is read once, not K times.  A
// row's pattern longer than S * C chunks is walked in strides of S chunks.
// The per-warp sums of the candidates live in shared memory, so K is
// walked in slabs of at most k_slab candidates (ops/rescore.py
// rescore_slab, 384), one launch of the partial kernel each, at the slab's
// offset into the rows of lags and partials (their row stride k_stride is
// K): shared memory is bounded by k_slab, not K, and any K launches (the
// pooled search asks for 90 * P candidates a row).  Each candidate's terms
// are summed in the same order in every slab, so the order depends on the
// row, C and S alone, never on B or K; a launch of K <= k_slab is one
// slab, the kernel as it was before slabs.
// float32 terms (the _rn intrinsics keep nvcc from contracting them into
// FMAs), float64 partial sums per (row, chunk, candidate) into a [B, S, K]
// scratch, which a second kernel sums in a fixed order and rounds to
// float32.  float64 sums make the result the float32 rounding of the exact
// sum of float32 terms, independent of the reduction order — so the
// kernel and its plain PyTorch version (ops/rescore.py) agree to the last
// ulp.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 6;  // candidates streamed together (K = 18 is three groups)

__device__ __forceinline__ double warp_sum(double value) {
  for (int offset = 16; offset > 0; offset >>= 1) value += __shfl_down_sync(0xffffffffu, value, offset);
  return value;
}

// partial sums of one (chunk, row) over the k_count candidates of one
// slab; lags and the partials hold rows of k_stride candidates
__global__ void __launch_bounds__(kThreads) rescore_partial_kernel(
    const float* __restrict__ patterns, const float* __restrict__ windows,
    const int* __restrict__ pat_lens, const int* __restrict__ lags,
    double* __restrict__ num_part, double* __restrict__ energy_part,
    int n, int k_count, int k_stride, int chunk, int chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* warp_num = reinterpret_cast<double*>(smem_raw);  // [k_count][kWarps]
  double* warp_energy = warp_num + (size_t)k_count * kWarps;
  float* pattern_chunk = reinterpret_cast<float*>(warp_energy + (size_t)k_count * kWarps);
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pat_len = min(max(pat_lens[b], 0), n);
  const float* pattern = patterns + (size_t)b * n;
  const float* window = windows + (size_t)b * n;
  const int* row_lags = lags + (size_t)b * k_stride;

  for (int i = threadIdx.x; i < k_count * kWarps; i += kThreads) {
    warp_num[i] = 0.0;
    warp_energy[i] = 0.0;
  }
  for (long long start = (long long)c * chunk; start < pat_len; start += (long long)chunks * chunk) {
    const int len = (int)min((long long)chunk, pat_len - start);
    __syncthreads();  // the previous stride's readers are done with the chunk
    for (int i = threadIdx.x; i < len; i += kThreads) pattern_chunk[i] = pattern[start + i];
    __syncthreads();
    // kGroup candidates at a time: their loads are independent, so each
    // thread keeps kGroup window reads in flight instead of one
    for (int k0 = 0; k0 < k_count; k0 += kGroup) {
      long long lag[kGroup];
      double num[kGroup];
      double energy[kGroup];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        lag[q] = (k0 + q < k_count ? (long long)row_lags[k0 + q] : 0LL) + start;
        num[q] = 0.0;
        energy[q] = 0.0;
      }
#pragma unroll 2
      for (int i = threadIdx.x; i < len; i += kThreads) {
        const float p = pattern_chunk[i];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          const long long j = lag[q] + i;
          const float seg = (j >= 0 && j < n) ? window[j] : 0.0f;
          // the _rn intrinsics keep nvcc from contracting into FMAs, so each
          // term is rounded exactly like the plain version's separate ops
          const float diff = __fsub_rn(p, seg);
          num[q] += (double)__fmul_rn(diff, diff);
          energy[q] += (double)__fmul_rn(seg, seg);
        }
      }
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        if (k0 + q < k_count) {  // the same in every lane
          const double warp_num_q = warp_sum(num[q]);
          const double warp_energy_q = warp_sum(energy[q]);
          if (lane == 0) {  // only this warp's lane 0 touches its entries
            warp_num[(k0 + q) * kWarps + warp] += warp_num_q;
            warp_energy[(k0 + q) * kWarps + warp] += warp_energy_q;
          }
        }
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < k_count; k += kThreads) {
    double num = 0.0;
    double energy = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      num += warp_num[k * kWarps + w];
      energy += warp_energy[k * kWarps + w];
    }
    const size_t at = ((size_t)b * chunks + c) * k_stride + k;
    num_part[at] = num;
    energy_part[at] = energy;
  }
}

// sum of the [B, S, K] partials over S in a fixed order (lane-strided,
// then a fixed shuffle tree), rounded to float32; one warp per output
__global__ void __launch_bounds__(kThreads) rescore_finish_kernel(
    const double* __restrict__ num_part, const double* __restrict__ energy_part,
    float* __restrict__ num_out, float* __restrict__ energy_out, int batch, int k_count, int chunks) {
  const int at = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (at >= batch * k_count) return;  // whole warps
  const int b = at / k_count;
  const int k = at % k_count;
  double num = 0.0;
  double energy = 0.0;
  for (int c = lane; c < chunks; c += 32) {
    const size_t part = ((size_t)b * chunks + c) * k_count + k;
    num += num_part[part];
    energy += energy_part[part];
  }
  num = warp_sum(num);
  energy = warp_sum(energy);
  if (lane == 0) {
    num_out[at] = (float)num;
    energy_out[at] = (float)energy;
  }
}

constexpr size_t kDefaultSmem = 48 * 1024;  // the default limit of dynamic shared memory
// the most a partial block takes: a full slab (ops/rescore.py K_SLAB, 384)
// and the longest pattern chunk (MAX_CHUNK, 4096).  The limit is always
// set to this one value, so threads that launch at once never lower it
// under each other.
constexpr size_t kMaxSmem = 384 * kWarps * 2 * sizeof(double) + 4096 * sizeof(float);

}  // namespace

extern "C" int sushi_rescore(
    const float* patterns, const float* windows, const int* pat_lens, const int* lags,
    float* num, float* energy, double* num_part, double* energy_part, int batch, int n,
    int k_count, int k_slab, int chunk, int chunks, void* stream_ptr) {
  if (batch <= 0 || k_count <= 0) return static_cast<int>(cudaGetLastError());
  if (k_slab <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (k_slab > k_count) k_slab = k_count;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // ops/rescore.py rescore_smem_bytes: one slab's per-warp sums + the pattern chunk
  const size_t smem = (size_t)k_slab * kWarps * 2 * sizeof(double) + (size_t)chunk * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t status;
  if (smem > kDefaultSmem &&
      (status = cudaFuncSetAttribute(rescore_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     static_cast<int>(kMaxSmem))) != cudaSuccess)
    return static_cast<int>(status);
  for (int k_begin = 0; k_begin < k_count; k_begin += k_slab) {  // ops/rescore.py rescore_slabs
    const int slab = k_count - k_begin < k_slab ? k_count - k_begin : k_slab;
    rescore_partial_kernel<<<dim3(chunks, batch), kThreads, smem, stream>>>(
        patterns, windows, pat_lens, lags + k_begin, num_part + k_begin, energy_part + k_begin, n, slab,
        k_count, chunk, chunks);
    if ((status = cudaGetLastError()) != cudaSuccess) return static_cast<int>(status);
  }
  const int warps = batch * k_count;
  rescore_finish_kernel<<<(warps * 32 + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      num_part, energy_part, num, energy, batch, k_count, chunks);
  return static_cast<int>(cudaGetLastError());
}
