// Launch geometry shared by the kernels in this directory: grid-stride
// loops over 256-thread blocks sized from the device's SM count, a
// launcher's error code, and the int32 -> f32 count conversion
// histogram_bin ends with.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// The current device's SM count (cudaDevAttrMultiProcessorCount), read
// on every call (the runtime answers from its own tables).  Returns the
// query's error; `sms` is left untouched on failure.
inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int got = 0;
  err = cudaDeviceGetAttribute(&got, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) *sms = got;
  return err;
}

// One block per kThreads elements, at most 8 resident blocks of kThreads
// on every SM, twice over: enough to fill the card; the grid-stride loop
// covers the rest.  A failed SM-count query gives one block and leaves
// its error for the launcher's cudaGetLastError().
inline int blocks_for(long long n) {
  int sms = 1;
  sm_count(&sms);
  const long long most = 16LL * sms;
  long long b = (n + kThreads - 1) / kThreads;
  if (b > most) b = most;
  if (b < 1) b = 1;
  return static_cast<int>(b);
}

// The CUDA error of a launch (`err`, else the last one recorded), with
// the last error cleared either way.
inline int launch_status(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
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
