// A design variant of histogram_bin, timed by scripts/histogram_variants.py
// and not used by the package: the bins in a thread-block cluster's
// distributed shared memory.  Past one block's opt-in shared memory, a
// cluster of the smallest power-of-two size up to 16 holds one copy of
// the bins, per_block = ceil(num_bins / cluster) each; the grid is the
// resident clusters (cudaOccupancyMaxActiveClusters), a block taking
// contiguous chunks of one slice's worth of ids.  A warp instruction's
// ids go to their owners' slices (cluster.map_shared_rank) when they
// reach at most two neighbouring owners, else to global atomics; after a
// second cluster.sync() each block adds its slice to the int32 counts.
// Up to 16 x 58,112 bins; beyond, and up to one block, the launcher
// refuses (the variant is timed at 524,288 bins).  Same launcher
// signature as scripts/histogram_bin_global.cu.
//
// On an H100 SXM at 700 W it read 0.160 ms on the Histogram app's input
// and 0.92 ms on the RMAT-22 degree histogram (global atomics: 0.63 and
// 0.88): a remote atomic costs more than an L2 atomic at every address
// pattern probed, and the app's input was fast only because its
// chunking keeps 99% of the atomics in a block's own slice.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kHistThreads = 1024;
constexpr int kStep = kHistThreads * 8;               // two int4 a thread
constexpr unsigned kNearOwners = 1;
constexpr int kClusterMax = 16;

__global__ void __launch_bounds__(kHistThreads)
histogram_cluster_kernel(const int32_t* __restrict__ idx,
                         int32_t* __restrict__ count, long long n,
                         int num_bins, int per_block, long long chunk) {
  extern __shared__ int32_t bins[];
  cg::cluster_group cluster = cg::this_cluster();
  for (int b = threadIdx.x; b < per_block; b += kHistThreads) bins[b] = 0;
  const unsigned nb = static_cast<unsigned>(num_bins);
  const unsigned pb = static_cast<unsigned>(per_block);
  auto add = [&](int32_t v) {
    const unsigned u = static_cast<unsigned>(v);   // v < 0 wraps past nb
    const bool ok = u < nb;
    const unsigned owner = u / pb;
    const unsigned mask = __activemask();
    const unsigned lo = __reduce_min_sync(mask, ok ? owner : ~0u);
    const unsigned hi = __reduce_max_sync(mask, ok ? owner : 0u);
    if (!ok) return;
    if (hi - lo <= kNearOwners) {
      atomicAdd(cluster.map_shared_rank(bins, owner) + u % pb, 1);
    } else {
      atomicAdd(count + u, 1);
    }
  };
  cluster.sync();                 // every slice zeroed before any add
  const bool vec = (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
  for (long long base = blockIdx.x * chunk; base < n;
       base += static_cast<long long>(gridDim.x) * chunk) {
    const long long end = base + chunk < n ? base + chunk : n;
    long long i = base;
    if (vec) {
      for (; i + kStep <= end; i += kStep) {
        const int4* p = reinterpret_cast<const int4*>(idx + i) + threadIdx.x;
        const int4 a = __ldcs(p);
        const int4 c = __ldcs(p + kHistThreads);
        add(a.x); add(a.y); add(a.z); add(a.w);
        add(c.x); add(c.y); add(c.z); add(c.w);
      }
    }
    for (i += threadIdx.x; i < end; i += kHistThreads) add(__ldcs(idx + i));
  }
  cluster.sync();                 // no slice read or left while written
  const int lo = static_cast<int>(cluster.block_rank()) * per_block;
  for (int b = threadIdx.x; b < per_block && lo + b < num_bins;
       b += kHistThreads) {
    const int32_t c = bins[b];
    if (c != 0) atomicAdd(count + lo + b, c);
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
  int dev = 0, optin = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long fit = optin / 4;
  int cluster = 2;
  while (cluster * fit < num_bins && cluster < kClusterMax) cluster *= 2;
  if (num_bins <= fit || cluster * fit < num_bins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_block = static_cast<int>((num_bins + cluster - 1) / cluster);
  const int smem = per_block * 4;
  err = cudaFuncSetAttribute(histogram_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(histogram_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kHistThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int resident = 0;
  err = cudaOccupancyMaxActiveClusters(&resident, histogram_cluster_kernel,
                                       &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long chunk = (per_block + kStep - 1) / kStep * kStep;
  if (n > 0) {
    const long long chunks = (n + chunk * cluster - 1) / (chunk * cluster);
    cfg.gridDim = dim3(cluster * static_cast<int>(
        chunks < resident ? chunks : resident));
    err = cudaLaunchKernelEx(&cfg, histogram_cluster_kernel,
                             static_cast<const int32_t*>(idx), cnt, n,
                             static_cast<int>(num_bins), per_block, chunk);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  count_to_f32_kernel<<<blocks_for(num_bins), kThreads, 0, s>>>(
      cnt, static_cast<float*>(count_f32), num_bins);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
