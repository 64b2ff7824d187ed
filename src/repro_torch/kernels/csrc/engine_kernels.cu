// The data-local engine's three hot spots, written by hand for Hopper
// (sm_90a).  Built by kernels/_build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes; the Python wrappers
// (relax_min.py, segment_combine.py, deliver_fused.py) allocate every
// output and scratch buffer, check device, dtype, shape and contiguity,
// choose the counting path, and pass raw pointers and PyTorch's current
// stream.  No launcher allocates or synchronises; each returns the CUDA
// error of its launch.
//
// relax            replaces src/repro/kernels/relax_min.py:32 (relax)
// segment_combine  replaces src/repro/kernels/segment_combine.py:55
// deliver_fused    replaces src/repro/kernels/deliver_fused.py:68
//
// What bounds them on this card.  Each moves a few bytes per element and
// does one compare or add on them: device-memory bytes (3.35 TB/s on an
// H100 SXM) where the element count is large, and otherwise the launch
// itself and the L2 atomics of the scatter.  On the engine's path
// (RMAT-22 on 4096 tiles, oq_cap 32) relax streams 14 B x 4.19 M
// elements; segment_combine reads the 4 B id of each of 131 K records and
// the 4 B value of each live one and writes 4 B x 131 K segments, a job
// of 1.4 MB that a launch outlasts; deliver_fused does the same over
// 262 K records, reads the 16.8 MB mailbox and writes the 16.8 MB
// mailbox and 16.8 MB of counts.  In the write-back flush wave the
// records outnumber the mailbox (2.1 M into 524 K) and the L2 atomics,
// not the bytes, set the pace.
//
// What the design does about it.  The TPU kernels reduced records into
// segments with a one-hot (records x segments) compare-and-reduce,
// because the TPU's vector unit has no fast scatter: O(records x
// segments) work.  A GPU has atomics in L2, so here a reduction is one
// scatter pass, O(records):
//
//  * One launch a call.  segment_combine and deliver_fused are
//    cooperative kernels (cudaLaunchCooperativeKernel): an init phase
//    (the identity fill; the mailbox copy and zeroed counts), a barrier
//    across the grid (cooperative_groups grid sync), then the scatter.
//    The grid is what can be resident at once, from the occupancy query
//    times the device's SM count, cut to kItemsPerThread elements a
//    thread so that a small job syncs few blocks.  Init stores are
//    float4 where the pointers allow.
//  * Counts straight as f32.  Below 2^24 records every partial count is
//    an integer below 2^24, so f32 atomicAdd is exact and order-free:
//    the scatter writes the f32 counts itself, with no int32 scratch and
//    no conversion pass.  At 2^24 records or more (the wrapper picks the
//    path from the record count, a host-known shape) the counts are
//    int32 atomics into the same buffer, converted to f32 in place after
//    a second grid barrier, still in the one launch.
//  * Loads in flight together.  A thread loads kItemsPerThread ids, then
//    their live values, before it scatters any of them.
//  * segment_combine folds runs within a warp where atomics set the
//    pace.  Runs of equal ids in neighbouring lanes of a warp slice are
//    found with head flags (a shuffle up and a ballot) and folded by a
//    segmented reduction down the lanes; the run's first lane makes the
//    one atomic.  The engine hands over sorted group ids, so every
//    repeat in a slice is a neighbour: on its RMAT-22 calls 12-16% of
//    the live records of a P$ call (BFS, SpMV), 83% (Histogram) and 56%
//    of the flush wave's sit in runs.  The fold's shuffles lengthen
//    each warp's path, which pays only where a thread of the resident
//    grid takes more than one batch (records > kItemsPerThread x the
//    grid's threads): the 2.1 M-record flush wave folds, a 131 K-record
//    P$ call does not.  On an H100 SXM (scripts/engine_kernel_variants.py,
//    on the engine's own calls) folding was 11% faster at the flush wave
//    and 2-12% slower at P$ calls, runs or none.
//  * deliver_fused does not fold: on the engine's RMAT-22 calls (P$
//    group leaders and flushed P$ entries) no live id repeats within a
//    warp slice, neighbour or not, so a fold, __match_any_sync's
//    included, finds nothing to save.  Nor does it pair value and count
//    in one atomicAdd(float2): on the engine's flush waves, a quarter of
//    the records live, the paired scratch cost more than the atomics it
//    saved (10-28% slower on the same card and script).
//
// Semantics (those of the plain versions, kernels/ref.py):
//  * min uses atomicMin on order-preserving float bits: a non-negative
//    float's bits order like a signed int, a negative float's bits order
//    in reverse like an unsigned int.  The warp fold compares the same
//    order (order_key), so -inf, +inf and -0.0 fold as the atomics would;
//    the result is the same bits whatever order the atomics land in: min
//    is bitwise deterministic.
//  * add uses atomicAdd(float): the order of the adds across warps, and
//    so the f32 rounding, varies from run to run.  Add results agree
//    with the plain version to f32 re-association only.
//  * The identity of min is the true +inf.  The TPU kernels used the
//    finite stand-in 3.4e38 and mapped results >= 3.4e38 to +inf, so a
//    record value in [3.4e38, FLT_MAX] is the one input where the two
//    differ (tests/test_torch_kernels.py pins it).
//  * Ids < 0 are padding and are skipped, as are ids past the end (the
//    TPU kernels' one-hot compare never matched them either).  The ids
//    need not be sorted.
//
// relax is a plain elementwise pass; Triton would serve it equally well.
// It is CUDA C so that all three kernels share one nvcc build of a few
// seconds.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kInfBits = 0x7f800000;   // +inf, the identity of min
// Elements a thread takes in the larger phase of a cooperative kernel
// before the grid grows by a block, and records a thread loads at once in
// the scatter (one batch each where the grid is not cut to residency).
constexpr int kItemsPerThread = 4;

// Order-free float minimum through integer atomics (see the note above).
__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  const int bits = __float_as_int(v);
  if (bits >= 0) {
    atomicMin(reinterpret_cast<int*>(addr), bits);
  } else {
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// An int that orders as atomic_min_f32 orders floats (-0.0 below +0.0);
// the map is its own inverse.
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// Fold the warp's runs of equal ids (neighbouring lanes; sorted ids put
// every repeat beside its kin, and unsorted repeats that are not
// neighbours simply stay separate) and call leader(index, folded value,
// records) once per run with an id >= 0, on its first lane; without
// `fold` (warp-uniform), once per lane with an id >= 0.  Every lane of the
// warp calls it; s < 0 marks a lane without a record.  A slice whose ids
// all differ from their neighbours goes straight to the atomics;
// otherwise a segmented reduction down the lanes (log2 of the longest
// run's length in shuffle steps, each lane adding its partner's partial
// while the partner is in its run) leaves each run's fold on its first
// lane, in a fixed order.  min folds in order_key order.
template <typename Leader>
__device__ __forceinline__ void fold_runs(int s, float v, bool is_min,
                                          bool fold, Leader leader) {
  const int lane = threadIdx.x & 31;
  if (!__any_sync(kFullWarp, s >= 0)) return;      // a slice of padding
  unsigned heads = kFullWarp;                       // no fold: every lane
  if (fold) {
    const int prev = __shfl_up_sync(kFullWarp, s, 1);
    heads = __ballot_sync(kFullWarp, lane == 0 || s != prev);
  }
  const unsigned later = heads & (0xfffffffeu << lane);
  const int end = later ? __ffs(later) - 1 : 32;  // this lane's run: [., end)
  float x = v;
  if (heads != kFullWarp) {
    // as many steps as the slice's longest run needs
    const int longest = __reduce_max_sync(kFullWarp, end - lane);
    if (is_min) {
      int k = order_key(v);
      for (int d = 1; d < longest; d <<= 1) {
        const int y = __shfl_down_sync(kFullWarp, k, d);
        if (lane + d < end) k = min(k, y);
      }
      x = key_float(k);
    } else {
      for (int d = 1; d < longest; d <<= 1) {
        const float y = __shfl_down_sync(kFullWarp, x, d);
        if (lane + d < end) x += y;
      }
    }
  }
  if (s >= 0 && ((heads >> lane) & 1)) leader(s, x, end - lane);
}

// Walk the records [0, n) in warp slices, the lanes of a warp together
// (every lane reaches the warp intrinsics), kItemsPerThread slices a
// batch: a thread loads the ids of its batch, then the values of its live
// records, then scatters slice by slice (folding runs where `fold`), so a
// batch's loads are in flight together.  Ids < 0 or >= limit are padding,
// and the value of a padding record is not read.
template <typename Leader>
__device__ __forceinline__ void scatter_batched(
    const int32_t* __restrict__ seg, const float* __restrict__ val,
    long long n, long long limit, bool is_min, bool fold, Leader leader) {
  const int lane = threadIdx.x & 31;
  const long long stride = grid_stride();
  for (long long base = first_index() - lane; base < n;
       base += kItemsPerThread * stride) {
    int s[kItemsPerThread];
    float v[kItemsPerThread];
#pragma unroll
    for (int k = 0; k < kItemsPerThread; ++k) {
      const long long i = base + k * stride + lane;
      s[k] = i < n ? seg[i] : -1;
      if (s[k] < 0 || s[k] >= limit) s[k] = -1;
    }
#pragma unroll
    for (int k = 0; k < kItemsPerThread; ++k) {
      v[k] = s[k] >= 0 ? val[base + k * stride + lane] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kItemsPerThread; ++k) {
      fold_runs(s[k], v[k], is_min, fold, leader);
    }
  }
}

// out[j] = src[j] (src given) or value, and zero[j] = 0 (zero given), for
// j < n; float4 accesses where `vec` (every pointer 16-byte aligned).
__device__ __forceinline__ void init_phase(const float* __restrict__ src,
                                           float value,
                                           float* __restrict__ out,
                                           float* __restrict__ zero,
                                           long long n, bool vec) {
  const long long t = first_index(), stride = grid_stride();
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    const float4 fill = make_float4(value, value, value, value);
    const float4 zeros = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (long long j = t; j < n4; j += stride) {
      reinterpret_cast<float4*>(out)[j] =
          src ? reinterpret_cast<const float4*>(src)[j] : fill;
      if (zero) reinterpret_cast<float4*>(zero)[j] = zeros;
    }
    done = n4 * 4;
  }
  for (long long j = done + t; j < n; j += stride) {
    out[j] = src ? src[j] : value;
    if (zero) zero[j] = 0.0f;
  }
}

struct SegmentArgs {
  const int32_t* seg;
  const float* val;
  float* out;
  long long n, num_segments;
  int is_min, vec;
};

__global__ void __launch_bounds__(kThreads)
    segment_combine_kernel(const SegmentArgs a) {
  init_phase(nullptr, a.is_min ? __int_as_float(kInfBits) : 0.0f, a.out,
             nullptr, a.num_segments, a.vec);
  cg::this_grid().sync();
  // fold where a thread takes more than one batch (see the note above)
  const bool fold = a.n > kItemsPerThread * grid_stride();
  scatter_batched(a.seg, a.val, a.n, a.num_segments, a.is_min, fold,
                  [&](int s, float x, int) {
                    if (a.is_min) {
                      atomic_min_f32(a.out + s, x);
                    } else {
                      atomicAdd(a.out + s, x);
                    }
                  });
}

struct DeliverArgs {
  const int32_t* seg;
  const float* val;
  const float* mail;
  float* out;
  float* count;   // f32 counts; int32 bits until the last phase (int_counts)
  long long n, nd;
  int is_min, int_counts, vec;
};

__global__ void __launch_bounds__(kThreads)
    deliver_fused_kernel(const DeliverArgs a) {
  cg::grid_group grid = cg::this_grid();
  // int32 zero and f32 zero are the same bits
  init_phase(a.mail, 0.0f, a.out, a.count, a.nd, a.vec);
  grid.sync();
  // min touches only the indices some record hits: the mailbox
  // legitimately holds +inf elsewhere and keeps it.  No fold (see the
  // note above).
  scatter_batched(a.seg, a.val, a.n, a.nd, a.is_min, false,
                  [&](int s, float x, int records) {
                    if (a.is_min) {
                      atomic_min_f32(a.out + s, x);
                    } else {
                      atomicAdd(a.out + s, x);
                    }
                    if (a.int_counts) {
                      atomicAdd(reinterpret_cast<int*>(a.count) + s,
                                records);
                    } else {
                      atomicAdd(a.count + s, static_cast<float>(records));
                    }
                  });
  if (!a.int_counts) return;
  grid.sync();
  for (long long j = first_index(); j < a.nd; j += grid_stride()) {
    a.count[j] = static_cast<float>(__float_as_int(a.count[j]));
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The CUDA error of a launch (`err`, else the last one recorded), with
// the last error cleared either way.
int launch_status(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// A cooperative launch of `kernel` over `work` elements in its larger
// phase: kItemsPerThread a thread, at most the blocks that can be
// resident at once (occupancy x the device's SM count, both read on every
// call).  A query or launch that CUDA refuses is returned, not retried.
cudaError_t launch_cooperative(const void* kernel, long long work,
                               void* args, cudaStream_t stream) {
  int sms = 0, per_sm = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long per_block = static_cast<long long>(kThreads) *
                              kItemsPerThread;
  long long blocks = (work + per_block - 1) / per_block;
  if (blocks > static_cast<long long>(per_sm) * sms) {
    blocks = static_cast<long long>(per_sm) * sms;
  }
  if (blocks < 1) blocks = 1;
  void* params[] = {args};
  return cudaLaunchCooperativeKernel(kernel, dim3(static_cast<int>(blocks)),
                                     dim3(kThreads), params, 0, stream);
}

__global__ void relax_kernel(const float* __restrict__ values,
                             const float* __restrict__ mail,
                             const uint8_t* __restrict__ flag,
                             float* __restrict__ out_values,
                             int8_t* __restrict__ out_improved,
                             long long n, int is_min) {
  for (long long i = first_index(); i < n; i += grid_stride()) {
    const float v = values[i];
    const float m = mail[i];
    const bool f = flag[i] != 0;
    bool imp;
    float out;
    if (is_min) {
      imp = f && (m < v);
      out = imp ? m : v;
    } else {
      imp = f;
      out = f ? v + m : v;
    }
    out_values[i] = out;
    out_improved[i] = imp ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// relax: out_values, out_improved = fold of (values, mail, flag).
int relax_launch(const void* values, const void* mail, const void* flag,
                 void* out_values, void* out_improved, long long n,
                 int is_min, void* stream) {
  relax_kernel<<<blocks_for(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const float*>(mail),
      static_cast<const uint8_t*>(flag), static_cast<float*>(out_values),
      static_cast<int8_t*>(out_improved), n, is_min);
  return launch_status(cudaSuccess);
}

// segment_combine: out[s] = combine of val[i] over seg[i] == s; untouched
// segments hold the identity (+inf for min, 0 for add).  One launch.
int segment_combine_launch(const void* seg, const void* val, void* out,
                           long long n, long long num_segments, int is_min,
                           void* stream) {
  SegmentArgs a{static_cast<const int32_t*>(seg),
                static_cast<const float*>(val), static_cast<float*>(out),
                n, num_segments, is_min, aligned16(out)};
  const long long fill = a.vec ? num_segments / 4 : num_segments;
  return launch_status(launch_cooperative(
      reinterpret_cast<const void*>(segment_combine_kernel),
      n > fill ? n : fill, &a, static_cast<cudaStream_t>(stream)));
}

// deliver_fused: out = mail with every record folded in at seg[i];
// count[j] = number of records with seg == j, as f32.  int_counts: count
// with int32 atomics and convert in place (2^24 records or more).  One
// launch.
int deliver_fused_launch(const void* seg, const void* val, const void* mail,
                         void* out, void* count, long long n, long long nd,
                         int is_min, int int_counts, void* stream) {
  DeliverArgs a{static_cast<const int32_t*>(seg),
                static_cast<const float*>(val),
                static_cast<const float*>(mail),
                static_cast<float*>(out),
                static_cast<float*>(count),
                n,
                nd,
                is_min,
                int_counts,
                aligned16(mail) && aligned16(out) && aligned16(count)};
  const long long init = a.vec ? nd / 4 : nd;
  return launch_status(launch_cooperative(
      reinterpret_cast<const void*>(deliver_fused_kernel),
      n > init ? n : init, &a, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
