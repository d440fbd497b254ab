// Shared pieces of the port's hand-written Hopper kernels: the C export
// macro, the block shape, block-wide reductions, and the dispatch over the
// number of row items each thread holds in registers.
//
// Every kernel here runs one CTA of kThreads threads per row.  Thread t
// holds the row's columns t, t + kThreads, t + 2*kThreads, ... so each
// load round is coalesced; ITEMS = ceil(cols / kThreads) is a template
// parameter (1..16, i.e. rows up to 4096 wide) so the items stay in
// registers.
#pragma once

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxItems = 16;  // rows up to kThreads * kMaxItems = 4096 wide
constexpr unsigned kFullMask = 0xffffffffu;

// Block-wide integer sum; every thread receives the total.  ``scratch``
// holds kWarps ints in shared memory.  Integer addition is exact, so the
// order of the partial sums does not matter.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += scratch[w];
  __syncthreads();  // scratch may be reused by the next call
  return total;
}

// Block-wide maximum; every thread receives it.  Exact in any order.
__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float m = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, scratch[w]);
  __syncthreads();
  return m;
}

}  // namespace repro

// Runs the statement(s) after ``items`` with ``constexpr int ITEMS`` set to
// ``items`` (1..16); returns cudaErrorInvalidValue from the enclosing
// function for wider rows.
#define REPRO_CASE_ITEMS(N, ...) \
  case N: {                      \
    constexpr int ITEMS = N;     \
    __VA_ARGS__;                 \
  } break;
#define REPRO_DISPATCH_ITEMS(items, ...)                                        \
  switch (items) {                                                              \
    REPRO_CASE_ITEMS(1, __VA_ARGS__) REPRO_CASE_ITEMS(2, __VA_ARGS__)           \
    REPRO_CASE_ITEMS(3, __VA_ARGS__) REPRO_CASE_ITEMS(4, __VA_ARGS__)           \
    REPRO_CASE_ITEMS(5, __VA_ARGS__) REPRO_CASE_ITEMS(6, __VA_ARGS__)           \
    REPRO_CASE_ITEMS(7, __VA_ARGS__) REPRO_CASE_ITEMS(8, __VA_ARGS__)           \
    REPRO_CASE_ITEMS(9, __VA_ARGS__) REPRO_CASE_ITEMS(10, __VA_ARGS__)          \
    REPRO_CASE_ITEMS(11, __VA_ARGS__) REPRO_CASE_ITEMS(12, __VA_ARGS__)         \
    REPRO_CASE_ITEMS(13, __VA_ARGS__) REPRO_CASE_ITEMS(14, __VA_ARGS__)         \
    REPRO_CASE_ITEMS(15, __VA_ARGS__) REPRO_CASE_ITEMS(16, __VA_ARGS__)         \
    default:                                                                    \
      return static_cast<int>(cudaErrorInvalidValue);                           \
  }

REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
