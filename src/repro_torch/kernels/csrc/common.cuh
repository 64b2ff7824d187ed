// Launch geometry shared by the kernels in this directory: grid-stride
// loops over 256-thread blocks, and the int32 -> f32 count conversion
// the counting kernels end with.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// 132 SMs x 8 resident blocks of 256 threads, twice over: enough blocks
// to fill the card; the grid-stride loop covers the rest.
constexpr long long kMaxBlocks = 132LL * 8 * 2;

inline int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  if (b < 1) b = 1;
  return static_cast<int>(b);
}

__device__ __forceinline__ long long first_index() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

__global__ void count_to_f32_kernel(const int32_t* __restrict__ count,
                                    float* __restrict__ out, long long n) {
  for (long long i = first_index(); i < n; i += grid_stride()) {
    out[i] = static_cast<float>(count[i]);
  }
}

}  // namespace
