// The multi-launch design of segment_combine and deliver_fused, kept as
// the yardstick of scripts/engine_kernel_variants.py; the package's
// kernels are src/repro_torch/kernels/csrc/engine_kernels.cu.  Not part
// of the package and not on any path of it.
//
// segment_combine  an identity fill, then one scatter of float atomics
//                  (two launches)
// deliver_fused    a copy of the mailbox and a zeroed int32 count
//                  scratch, a scatter of float atomics for the value and
//                  int atomics for the count, then a launch that
//                  converts the counts to f32 (three launches)
//
// min uses atomicMin on order-preserving float bits (bitwise order-free);
// add uses atomicAdd(float).  Ids < 0 and past the end are padding.
// Launch geometry: grid-stride loops over 256-thread blocks, at most
// 132 SMs x 8 resident blocks, twice over.

#include <cuda_runtime.h>
#include <stdint.h>

#include <limits>

namespace {

constexpr int kThreads = 256;
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

__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  const int bits = __float_as_int(v);
  if (bits >= 0) {
    atomicMin(reinterpret_cast<int*>(addr), bits);
  } else {
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

__global__ void fill_kernel(float* __restrict__ out, long long n,
                            float value) {
  for (long long i = first_index(); i < n; i += grid_stride()) {
    out[i] = value;
  }
}

__global__ void segment_scatter_kernel(const int32_t* __restrict__ seg,
                                       const float* __restrict__ val,
                                       float* __restrict__ out,
                                       long long n, long long num_segments,
                                       int is_min) {
  for (long long i = first_index(); i < n; i += grid_stride()) {
    const int32_t s = seg[i];
    if (s < 0 || s >= num_segments) continue;
    if (is_min) {
      atomic_min_f32(out + s, val[i]);
    } else {
      atomicAdd(out + s, val[i]);
    }
  }
}

__global__ void deliver_init_kernel(const float* __restrict__ mail,
                                    float* __restrict__ out,
                                    int32_t* __restrict__ count,
                                    long long nd) {
  for (long long i = first_index(); i < nd; i += grid_stride()) {
    out[i] = mail[i];
    count[i] = 0;
  }
}

__global__ void deliver_scatter_kernel(const int32_t* __restrict__ seg,
                                       const float* __restrict__ val,
                                       float* __restrict__ out,
                                       int32_t* __restrict__ count,
                                       long long n, long long nd,
                                       int is_min) {
  for (long long i = first_index(); i < n; i += grid_stride()) {
    const int32_t s = seg[i];
    if (s < 0 || s >= nd) continue;
    if (is_min) {
      atomic_min_f32(out + s, val[i]);
    } else {
      atomicAdd(out + s, val[i]);
    }
    atomicAdd(count + s, 1);
  }
}

__global__ void count_to_f32_kernel(const int32_t* __restrict__ count,
                                    float* __restrict__ out, long long n) {
  for (long long i = first_index(); i < n; i += grid_stride()) {
    out[i] = static_cast<float>(count[i]);
  }
}

}  // namespace

extern "C" {

int segment_combine_launch(const void* seg, const void* val, void* out,
                           long long n, long long num_segments, int is_min,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float identity =
      is_min ? std::numeric_limits<float>::infinity() : 0.0f;
  fill_kernel<<<blocks_for(num_segments), kThreads, 0, s>>>(
      static_cast<float*>(out), num_segments, identity);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  segment_scatter_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const int32_t*>(seg), static_cast<const float*>(val),
      static_cast<float*>(out), n, num_segments, is_min);
  return static_cast<int>(cudaGetLastError());
}

// count_i32 (nd int32) is scratch.
int deliver_fused_launch(const void* seg, const void* val, const void* mail,
                         void* out, void* count_i32, void* count_f32,
                         long long n, long long nd, int is_min,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  deliver_init_kernel<<<blocks_for(nd), kThreads, 0, s>>>(
      static_cast<const float*>(mail), static_cast<float*>(out),
      static_cast<int32_t*>(count_i32), nd);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  deliver_scatter_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const int32_t*>(seg), static_cast<const float*>(val),
      static_cast<float*>(out), static_cast<int32_t*>(count_i32), n, nd,
      is_min);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  count_to_f32_kernel<<<blocks_for(nd), kThreads, 0, s>>>(
      static_cast<const int32_t*>(count_i32), static_cast<float*>(count_f32),
      nd);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
