// Chunk row gather: a chunk's pattern and window rows from two
// device-resident streams named by address in the chunk's table.
//
// Replaces no TPU kernel: the JAX package gathers inside its jitted match
// with XLA's dynamic_slice (sushi_tpu/ops/sqdiff.py gather_rows).  Added so
// that a chunk's whole chain, from the gather to the packed [2, B] result,
// is one CUDA graph for any pair of streams: the streams' addresses,
// lengths and dtypes travel as data in the table, never as launch
// arguments, so a graph captured on one episode's streams replays on
// another's (ops/gather.py, align/chunk_graphs.py).
//
// table (int64, ops/gather.py pack_table):
//   [src address, src length, src dtype, dst address, dst length, dst dtype,
//    pat_start[B], pat_len[B], win_start[B], win_len[B]]
// dtype 0 is float32, 1 is uint8.  Side 0 (patterns) reads src at
// pat_start / pat_len, side 1 (windows) dst at win_start / win_len.
//
// Each output row is sqdiff.gather_rows's, bit for bit: the start clamps to
// [0, length - slice_len] (min after max, as torch.clamp), sample i of the
// row is stream[start + i] below the row's length and 0 from it on, and
// uint8 converts as float32(x) * float32(1/255) (the double 1/255 rounded
// to float32 once, as PyTorch rounds a Python scalar against a float32
// tensor; __fmul_rn keeps the product a single rounded multiply).  The
// kernel also writes the lengths as int32, the match's pat_lens/win_lens.
//
// Bound on the H100: device-memory bandwidth, B * slice_len * (4 + the
// stream's bytes a sample) bytes a side, read once and written once.  One
// pass per side where the plain version makes four (index, convert,
// multiply, mask), each a full [B, slice_len] array.  Design: a grid of
// (slice_len / 1024, B, 2); each thread writes four consecutive samples of
// one row as one 16-byte store (slice_len is a multiple of 128, so every
// row and every group of four is aligned), reading the stream sample by
// sample (a row's start has any alignment); neighbouring threads on
// neighbouring addresses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kHeader = 6;  // ops/gather.py TABLE_HEADER
constexpr int kUint8 = 1;   // ops/gather.py DTYPE_CODES[torch.uint8]

__device__ __forceinline__ float load_sample(int64_t base, int64_t dtype, int64_t index) {
  if (dtype == kUint8) {
    const unsigned char x = __ldg(reinterpret_cast<const unsigned char*>(base) + index);
    return __fmul_rn(static_cast<float>(x), static_cast<float>(1.0 / 255.0));
  }
  return __ldg(reinterpret_cast<const float*>(base) + index);
}

__global__ void __launch_bounds__(kThreads) gather_kernel(
    const int64_t* __restrict__ table, float* __restrict__ patterns, float* __restrict__ windows,
    int* __restrict__ pat_lens, int* __restrict__ win_lens, int batch, int slice_len) {
  const int row = blockIdx.y;
  const int side = blockIdx.z;
  const int64_t* stream = table + 3 * side;
  const int64_t base = stream[0];
  const int64_t dtype = stream[2];
  const int64_t* bounds = table + kHeader + (int64_t)2 * side * batch;
  const int64_t length = bounds[batch + row];
  int64_t start = bounds[row];
  start = start > 0 ? start : 0;
  const int64_t last_start = stream[1] - slice_len;
  start = start < last_start ? start : last_start;

  if (blockIdx.x == 0 && threadIdx.x == 0) (side ? win_lens : pat_lens)[row] = static_cast<int>(length);
  const int i0 = (blockIdx.x * kThreads + threadIdx.x) * kPerThread;
  if (i0 >= slice_len) return;
  float v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = i0 + j;
    v[j] = i < length ? load_sample(base, dtype, start + i) : 0.0f;
  }
  float* out = (side ? windows : patterns) + (size_t)row * slice_len + i0;
  *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
}

}  // namespace

extern "C" int sushi_gather(
    const int64_t* table, float* patterns, float* windows, int* pat_lens, int* win_lens, int batch,
    int slice_len, void* stream_ptr) {
  if (batch <= 0 || slice_len <= 0) return static_cast<int>(cudaGetLastError());
  if (slice_len % kPerThread) return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = kThreads * kPerThread;
  const dim3 grid((slice_len + per_block - 1) / per_block, batch, 2);
  gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      table, patterns, windows, pat_lens, win_lens, batch, slice_len);
  return static_cast<int>(cudaGetLastError());
}
