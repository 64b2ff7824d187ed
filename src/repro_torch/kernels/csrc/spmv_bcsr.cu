// Block-sparse matrix-vector product y = A @ x over ELL-padded BCSR,
// written by hand for Hopper (sm_90a).  Built by kernels/_build.py with
// nvcc into a shared library with a plain C interface; the Python
// wrapper (spmv_csr.py) allocates y and checks its inputs.  The launcher
// allocates nothing, does not synchronise, and returns the launch's
// cudaGetLastError().
//
// spmv_bcsr  replaces src/repro/kernels/spmv_csr.py:95
//
// The format: every one of the Mb block-rows holds exactly kmax dense
// (bm x bk) f32 blocks, row-major; cols[m, k] is the block-column of
// block (m, k); absent blocks are all-zero with column 0.
//
// What bounds it on this card: device-memory bytes.  Every block element
// is read once and used in one multiply-add (2 flops per 4 B), a GEMV
// far below the ridge point; x and y are small beside the blocks (at
// RMAT-14 with 128 x 128 blocks: 1 GiB of blocks, 64 KB of x).
//
// What the design does about it.  The TPU kernel walked a sequential
// (Mb, kmax) grid, let the scalar-prefetched cols table pick the x block
// for each step, and accumulated one block-row's y in VMEM across the k
// steps on the MXU.  Here one block of threads takes one block-row and
// loops over its kmax blocks itself: it stages the x block that
// cols[m, k] picks in shared memory, then each warp takes rows of the
// (bm x bk) block, its 32 lanes reading neighbouring elements of a row
// (coalesced, each block byte read once), multiplies by the staged x and
// reduces the lane partials with warp shuffles.  The warp that owns a
// row adds it into the block-row's y accumulator in shared memory, and
// y is written once at the end.  No tensor cores: a GEMV has one
// multiply-add per element loaded, so they would not help.
//
// The summation order is fixed -- per row, per block k in order: lane
// partials over the row's elements in order, then a fixed shuffle tree
// -- so the result is the same bits from run to run.  It differs from
// the plain version (a batched product) by f32 re-association only.

#include "common.cuh"

namespace {

constexpr int kSpmvThreads = 1024;   // 32 warps: bytes in flight per SM

__global__ void spmv_bcsr_kernel(const float* __restrict__ blocks,
                                 const int32_t* __restrict__ cols,
                                 const float* __restrict__ x,
                                 float* __restrict__ y, long long m_rows,
                                 long long k_cols, int kmax, int bm,
                                 int bk) {
  extern __shared__ float smem[];
  float* xs = smem;          // (bk,) the x block of the current k
  float* acc = smem + bk;    // (bm,) the block-row's y
  const long long mb = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = threadIdx.x; r < bm; r += blockDim.x) acc[r] = 0.0f;
  for (int k = 0; k < kmax; ++k) {
    __syncthreads();   // the previous block's xs reads are done
    const long long c0 = static_cast<long long>(cols[mb * kmax + k]) * bk;
    for (int c = threadIdx.x; c < bk; c += blockDim.x) {
      xs[c] = (c0 + c < k_cols) ? x[c0 + c] : 0.0f;
    }
    __syncthreads();
    const float* a = blocks + (mb * kmax + k) * static_cast<long long>(bm) *
                                  bk;
    for (int r = warp; r < bm; r += nwarps) {
      const float* row = a + static_cast<long long>(r) * bk;
      float p = 0.0f;
#pragma unroll 4
      for (int c = lane; c < bk; c += 32) p = fmaf(row[c], xs[c], p);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        p += __shfl_xor_sync(0xffffffffu, p, off);
      }
      if (lane == 0) acc[r] += p;
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < bm; r += blockDim.x) {
    const long long i = mb * bm + r;
    if (i < m_rows) y[i] = acc[r];
  }
}

}  // namespace

extern "C" {

// spmv_bcsr: y[0:m_rows] = A @ x for A in ELL-padded BCSR (mb block-rows
// of kmax (bm x bk) blocks) and x of k_cols entries.
int spmv_bcsr_launch(const void* blocks, const void* cols, const void* x,
                     void* y, long long mb, long long m_rows,
                     long long k_cols, int kmax, int bm, int bk,
                     void* stream) {
  if (mb == 0) return 0;
  const size_t shared = static_cast<size_t>(bk + bm) * sizeof(float);
  if (shared > 48 * 1024) {
    int err = static_cast<int>(cudaFuncSetAttribute(
        spmv_bcsr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared)));
    if (err) return err;
  }
  spmv_bcsr_kernel<<<static_cast<unsigned int>(mb), kSpmvThreads, shared,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blocks), static_cast<const int32_t*>(cols),
      static_cast<const float*>(x), static_cast<float*>(y), m_rows, k_cols,
      kmax, bm, bk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
