// Histogram binning, written by hand for Hopper (sm_90a): count the bin
// ids of a record stream, skipping ids below 0 (padding) or at or above
// num_bins, and return f32 counts.  Built by kernels/_build.py with nvcc
// into a shared library with a plain C interface; the Python wrapper
// (histogram_bin.py) picks the path and its geometry (`plan`), allocates
// the int32 scratch and the f32 output and checks its inputs.  The
// launchers allocate nothing, do not synchronise, and return the CUDA
// error of what they did.
//
// histogram_bin  replaces src/repro/kernels/histogram_bin.py:39
//
// What bounds it on this card.  The byte bound: each 4 B id read once,
// each 4 B count written once; at the Histogram app's shape (67,108,864
// ids into 524,288 bins) 270.5 MB, 0.0808 ms at 3.35 TB/s.  What bounds
// it in practice is where its one atomic per id resolves.  Measured for
// those 67.1 M ids on an H100 SXM at 700 W (scripts/histogram_variants.py):
//  * a block's own shared memory: 0.17 ms at random bins;
//  * L2 (global atomics): 0.16 ms when a warp's ids are neighbouring
//    bins, 0.63 ms on the app's ids ((i + w_i) mod bins, w_i in [1, 255]:
//    a warp's 32 ids spread over ~9 lines), 0.79-0.94 ms when scattered;
//  * another block's shared memory through a thread-block cluster
//    (distributed shared memory, generic or PTX red.shared::cluster):
//    0.69 ms at neighbouring bins, 1.11 ms at random ones -- slower than
//    L2 at every pattern, so no path here sends an atomic to another
//    block (scripts/histogram_bin_cluster.cu keeps that design).
//
// What the design does about it: count in a block's own shared memory
// whatever the block can own, and send only the rest to L2.  Paths,
// chosen in Python from num_bins and the card's attributes
// (histogram_bin.plan):
//  * private: the bins fit one block's opt-in shared memory (58,112 bins
//    on an H100).  Every resident block counts into its own copy, then
//    adds its non-zero bins to the int32 counts, one coalesced global
//    atomic each.
//  * sliced: more bins, cut into the fewest S (a power of two) slices of
//    per_block bins that each fit one block (16 x 32,768 at the app's
//    bins).  Block b owns slice b mod S: an id of its slice is a shared
//    atomic, any other id a global one.  Its chunks of ids are per_block
//    long and the grid a multiple of S, so where an id follows its
//    position modulo num_bins (the app's input) the chunks a block takes
//    fall in its own slice; elsewhere it is the global design with 1/S
//    of the atomics kept on chip.  Slices for two blocks an SM (32 x
//    16,384) read 1-2.5% slower on the app's input, 3-4% on scattered
//    ids.
//  * global: more slices than SMs; one global atomic per id.
// A block is 1,024 threads, two 16-byte loads a thread in flight.  Counts
// are integers until the one conversion, so every path gives the same
// bits in any order: exact as f32 below 2^24 a bin, rounded to nearest
// above, as the plain version.

#include "common.cuh"

namespace {

// path codes, as histogram_bin.PATHS
constexpr int kPathSliced = 1;
constexpr int kPathGlobal = 2;

constexpr int kHistThreads = 1024;
constexpr long long kPrivateChunk = 32768;   // ids a private block's chunk

// Count the ids of contiguous chunks of `chunk` ids (block b: chunks b,
// b + gridDim.x, ...): ids in slice b mod `slices` (per_block bins from
// (b mod slices) x per_block) into the block's shared memory, other
// valid ids into `count`; then add the slice to `count`.  chunk is a
// multiple of 4 ids, so 16-byte loads stay aligned.
__global__ void __launch_bounds__(kHistThreads, 2)
histogram_slice_kernel(const int32_t* __restrict__ idx,
                       int32_t* __restrict__ count, long long n,
                       int num_bins, int per_block, int slices,
                       long long chunk) {
  extern __shared__ int32_t bins[];
  const int lo = static_cast<int>(blockIdx.x % slices) * per_block;
  const int width = max(0, min(per_block, num_bins - lo));
  for (int b = threadIdx.x; b < width; b += kHistThreads) bins[b] = 0;
  __syncthreads();
  const unsigned nb = static_cast<unsigned>(num_bins);
  const unsigned w = static_cast<unsigned>(width);
  const unsigned ulo = static_cast<unsigned>(lo);
  auto add = [&](int32_t v) {
    const unsigned u = static_cast<unsigned>(v);   // v < 0 wraps past nb
    if (u - ulo < w) {
      atomicAdd(bins + (u - ulo), 1);
    } else if (u < nb) {
      atomicAdd(count + u, 1);
    }
  };
  const bool vec = (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  const long long step = 4LL * kHistThreads;
  for (long long base = blockIdx.x * chunk; base < n;
       base += static_cast<long long>(gridDim.x) * chunk) {
    const long long end = base + chunk < n ? base + chunk : n;
    long long i = base;
    if (vec) {
      const long long whole = base + ((end - base) & ~3LL);
      long long j = base + 4LL * threadIdx.x;
      for (; j + step < whole; j += 2 * step) {
        const int4 a = __ldcs(reinterpret_cast<const int4*>(idx + j));
        const int4 c = __ldcs(reinterpret_cast<const int4*>(idx + j + step));
        add(a.x); add(a.y); add(a.z); add(a.w);
        add(c.x); add(c.y); add(c.z); add(c.w);
      }
      if (j < whole) {
        const int4 a = __ldcs(reinterpret_cast<const int4*>(idx + j));
        add(a.x); add(a.y); add(a.z); add(a.w);
      }
      i = whole;
    }
    for (i += threadIdx.x; i < end; i += kHistThreads) add(__ldcs(idx + i));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < width; b += kHistThreads) {
    const int32_t c = bins[b];
    if (c != 0) atomicAdd(count + lo + b, c);
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

// The current device's SM count and opt-in shared memory a block (the
// two attributes histogram_bin.plan reads).
int histogram_bin_card(void* sms, void* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(static_cast<int*>(sms),
                                 cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(static_cast<int*>(smem_optin),
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  }
  return launch_status(err);
}

// How many blocks of the private or sliced path, smem bytes of shared
// memory each, the card holds at once (per SM x SMs).
int histogram_bin_resident(long long smem, void* out) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      histogram_slice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, histogram_slice_kernel, kHistThreads, smem);
  }
  if (err == cudaSuccess) *static_cast<int*>(out) = per_sm * sms;
  return launch_status(err);
}

// histogram_bin: count_f32[b] = number of i with idx[i] == b; count_i32
// (num_bins int32) is scratch.  path, slices and per_block from
// histogram_bin.plan (private: 1 slice of num_bins); resident: the blocks
// histogram_bin_resident reports.  The grid is a multiple of the slices,
// at most the resident blocks (at least one block a slice), cut to the
// chunks there are.  Three stream operations: memset, count, convert.
int histogram_bin_launch(const void* idx, void* count_i32, void* count_f32,
                         long long n, long long num_bins, int path,
                         int slices, int per_block, int resident,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* cnt = static_cast<int32_t*>(count_i32);
  const int32_t* ids = static_cast<const int32_t*>(idx);
  cudaError_t err = cudaMemsetAsync(cnt, 0, num_bins * sizeof(int32_t), s);
  if (err != cudaSuccess) return launch_status(err);
  if (n > 0) {
    if (path == kPathGlobal) {
      histogram_global_kernel<<<blocks_for(n), kThreads, 0, s>>>(
          ids, cnt, n, num_bins);
    } else {
      const int smem = per_block * 4;
      err = cudaFuncSetAttribute(histogram_slice_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return launch_status(err);
      const long long chunk = path == kPathSliced ? per_block : kPrivateChunk;
      const long long rounds_needed = (n + chunk * slices - 1) /
                                      (chunk * slices);
      long long rounds = resident / slices;
      if (rounds > rounds_needed) rounds = rounds_needed;
      if (rounds < 1) rounds = 1;
      histogram_slice_kernel<<<static_cast<int>(rounds * slices),
                               kHistThreads, smem, s>>>(
          ids, cnt, n, static_cast<int>(num_bins), per_block, slices, chunk);
    }
    const int launched = launch_status(cudaSuccess);
    if (launched != 0) return launched;
  }
  count_to_f32_kernel<<<blocks_for(num_bins), kThreads, 0, s>>>(
      cnt, static_cast<float*>(count_f32), num_bins);
  return launch_status(cudaSuccess);
}

}  // extern "C"
