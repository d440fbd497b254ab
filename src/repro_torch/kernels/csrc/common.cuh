// Shared pieces of the port's hand-written Hopper kernels: the C export
// macro, the block shape and the error string.
//
// The row kernels run one CTA of kThreads threads per row (B2, B3, B5, B6,
// B7) or one warp per row (B1, B4: threshold.cuh); rows are at most
// kThreads * kMaxItems = 4096 wide where a row lives in registers.
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

}  // namespace repro

REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
