// Histogram binning, written by hand for Hopper (sm_90a): count the bin
// ids of a record stream, ignoring negative (padding) ids, and return
// f32 counts.  Built by kernels/_build.py with nvcc into a shared
// library with a plain C interface; the Python wrapper
// (histogram_bin.py) allocates the int32 scratch and the f32 output and
// checks its inputs.  The launcher allocates nothing, does not
// synchronise, and returns the launches' cudaGetLastError().
//
// histogram_bin  replaces src/repro/kernels/histogram_bin.py:39
//
// What bounds it on this card: device-memory bytes.  It reads each 4 B
// id once and writes each 4 B count once; at the Histogram app's shape
// (67,108,864 ids into 524,288 bins) that is 270 MB, 0.08 ms at
// 3.35 TB/s.  One integer add per id is far below any arithmetic limit.
//
// What the design does about it.  The TPU kernel built a one-hot
// (records x bins) block in VMEM and summed it, because the TPU's vector
// unit has no scatter: O(records x bins) work.  Here each id is one
// integer atomicAdd, O(records):
//  * when the bins fit in 48 KB of shared memory, each block counts into
//    its own private copy of the bins (shared-memory atomics, no
//    device-memory traffic per id) and merges it into the global counts
//    once at the end, one atomic per non-zero bin;
//  * otherwise (the app's 524,288 bins need 2 MB) the ids go straight to
//    global integer atomics, which resolve in the 50 MB L2: a uniform id
//    stream spreads them over many addresses, so they rarely collide.
// The ids are read in a grid-stride loop, neighbouring threads on
// neighbouring ids, so the one read of the stream is coalesced.  Counts
// are integers, so the result is the same bits in any order, and exact
// as f32 below 2^24 per bin, as the plain version and the Pallas kernel
// are.

#include "common.cuh"

namespace {

constexpr long long kSharedBinsMax = 48 * 1024 / 4;

__global__ void histogram_shared_kernel(const int32_t* __restrict__ idx,
                                        int32_t* __restrict__ count,
                                        long long n, int num_bins) {
  extern __shared__ int32_t bins[];
  for (int b = threadIdx.x; b < num_bins; b += blockDim.x) bins[b] = 0;
  __syncthreads();
  for (long long i = first_index(); i < n; i += grid_stride()) {
    const int32_t v = idx[i];
    if (v >= 0 && v < num_bins) atomicAdd(bins + v, 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < num_bins; b += blockDim.x) {
    const int32_t c = bins[b];
    if (c != 0) atomicAdd(count + b, c);
  }
}

__global__ void histogram_global_kernel(const int32_t* __restrict__ idx,
                                        int32_t* __restrict__ count,
                                        long long n, long long num_bins) {
  for (long long i = first_index(); i < n; i += grid_stride()) {
    const int32_t v = idx[i];
    if (v >= 0 && v < num_bins) atomicAdd(count + v, 1);
  }
}

}  // namespace

extern "C" {

// histogram_bin: count_f32[b] = number of i with idx[i] == b; count_i32
// (num_bins int32) is scratch.
int histogram_bin_launch(const void* idx, void* count_i32, void* count_f32,
                         long long n, long long num_bins, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* cnt = static_cast<int32_t*>(count_i32);
  int err = static_cast<int>(
      cudaMemsetAsync(cnt, 0, num_bins * sizeof(int32_t), s));
  if (err) return err;
  if (n > 0) {
    if (num_bins <= kSharedBinsMax) {
      histogram_shared_kernel<<<blocks_for(n), kThreads,
                                num_bins * sizeof(int32_t), s>>>(
          static_cast<const int32_t*>(idx), cnt, n,
          static_cast<int>(num_bins));
    } else {
      histogram_global_kernel<<<blocks_for(n), kThreads, 0, s>>>(
          static_cast<const int32_t*>(idx), cnt, n, num_bins);
    }
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  count_to_f32_kernel<<<blocks_for(num_bins), kThreads, 0, s>>>(
      cnt, static_cast<float*>(count_f32), num_bins);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
