// A design variant of histogram_bin, timed by scripts/histogram_variants.py
// and not used by the package: the window-privatized count.  Each block
// takes contiguous chunks of kChunk ids; per chunk it finds the least
// valid id and counts the ids within kWindow bins of it into a window of
// shared memory, the others straight into the int32 counts with global
// atomics; then it adds the window's non-zero bins to the counts, one
// coalesced global atomic each, and clears them.  Where neighbouring ids
// fall in neighbouring bins (the Histogram app's input) nearly every id
// is a shared-memory atomic and device memory sees about one coalesced
// atomic a bin a chunk; where they do not, it is the global design plus
// the window's cost.  Same launcher signature as
// scripts/histogram_bin_global.cu; counts are integers until the one
// conversion, so the bits are the plain version's.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kWinThreads = 512;
constexpr int kChunk = kWinThreads * 8;   // two int4 loads a thread
constexpr int kWindow = 8192;             // bins, 32 KB of shared memory
constexpr int kWarps = kWinThreads / 32;

__device__ __forceinline__ int valid_or(int32_t v, int num_bins, int fill) {
  return static_cast<unsigned>(v) < static_cast<unsigned>(num_bins) ? v
                                                                    : fill;
}

__global__ void __launch_bounds__(kWinThreads)
histogram_window_kernel(const int32_t* __restrict__ idx,
                        int32_t* __restrict__ count, long long n,
                        int num_bins) {
  __shared__ int32_t win[kWindow];
  __shared__ int red_lo[kWarps], red_hi[kWarps];
  for (int b = threadIdx.x; b < kWindow; b += kWinThreads) win[b] = 0;
  const bool vec = (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long base = static_cast<long long>(blockIdx.x) * kChunk;
       base < n; base += static_cast<long long>(gridDim.x) * kChunk) {
    int32_t v[8];
    if (vec && base + kChunk <= n) {
      const int4* p = reinterpret_cast<const int4*>(idx + base) + threadIdx.x;
      const int4 a = __ldcs(p);
      const int4 c = __ldcs(p + kWinThreads);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
    } else {
      for (int k = 0; k < 8; ++k) {
        const long long i = base + (k >> 2) * 4 * kWinThreads +
                            4 * threadIdx.x + (k & 3);
        v[k] = i < n ? idx[i] : -1;
      }
    }
    int lo = INT_MAX, hi = -1;
    for (int k = 0; k < 8; ++k) {
      lo = min(lo, valid_or(v[k], num_bins, INT_MAX));
      hi = max(hi, valid_or(v[k], num_bins, -1));
    }
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    __syncthreads();   // the last chunk's flush has read red_lo / red_hi
    if (lane == 0) {
      red_lo[warp] = lo;
      red_hi[warp] = hi;
    }
    __syncthreads();
    lo = red_lo[0];
    hi = red_hi[0];
    for (int w = 1; w < kWarps; ++w) {
      lo = min(lo, red_lo[w]);
      hi = max(hi, red_hi[w]);
    }
    if (hi < 0) continue;    // no valid id in the chunk (uniform branch)
    for (int k = 0; k < 8; ++k) {
      if (static_cast<unsigned>(v[k]) >= static_cast<unsigned>(num_bins)) {
        continue;
      }
      const int d = v[k] - lo;
      if (d < kWindow) {
        atomicAdd(win + d, 1);
      } else {
        atomicAdd(count + v[k], 1);
      }
    }
    __syncthreads();
    const int span = min(kWindow, hi - lo + 1);
    for (int b = threadIdx.x; b < span; b += kWinThreads) {
      const int32_t c = win[b];
      if (c != 0) {
        atomicAdd(count + lo + b, c);
        win[b] = 0;
      }
    }
  }
}

}  // namespace

extern "C" {

int histogram_bin_launch(const void* idx, void* count_i32, void* count_f32,
                         long long n, long long num_bins, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* cnt = static_cast<int32_t*>(count_i32);
  cudaError_t err = cudaMemsetAsync(cnt, 0, num_bins * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    int sms = 0, per_sm = 0;
    err = sm_count(&sms);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, histogram_window_kernel, kWinThreads, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    long long blocks = (n + kChunk - 1) / kChunk;
    if (blocks > static_cast<long long>(per_sm) * sms) {
      blocks = static_cast<long long>(per_sm) * sms;
    }
    histogram_window_kernel<<<static_cast<int>(blocks), kWinThreads, 0, s>>>(
        static_cast<const int32_t*>(idx), cnt, n,
        static_cast<int>(num_bins));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  count_to_f32_kernel<<<blocks_for(num_bins), kThreads, 0, s>>>(
      cnt, static_cast<float*>(count_f32), num_bins);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
