// The data-local engine's three hot spots, written by hand for Hopper
// (sm_90a).  Built by kernels/_build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes; the Python wrappers
// (relax_min.py, segment_combine.py, deliver_fused.py) allocate every
// output and scratch buffer, check device, dtype, shape and contiguity,
// and pass raw pointers and PyTorch's current stream.  No launcher
// allocates or synchronises; each returns the launch's cudaGetLastError().
//
// relax            replaces src/repro/kernels/relax_min.py:32 (relax)
// segment_combine  replaces src/repro/kernels/segment_combine.py:55
// deliver_fused    replaces src/repro/kernels/deliver_fused.py:68
//
// What bounds them on this card: all three move a few bytes per element
// and do one compare or add on them, so they are bound by device-memory
// bytes (3.35 TB/s on an H100 SXM), never by arithmetic.  On the engine's
// path (RMAT-22 on 4096 tiles, oq_cap 32) relax streams 14 B x 4.19 M
// elements; segment_combine reads the 4 B id of each of 131 K records
// and the 4 B value of each live one, and writes 4 B x 131 K segments;
// deliver_fused does the same over 262 K records, reads the 16.8 MB
// mailbox and writes the 16.8 MB mailbox and 16.8 MB of counts.
//
// What the design does about it: each kernel is a grid-stride loop with
// neighbouring threads on neighbouring elements, so every load and store
// is coalesced and each byte is read or written once.  The TPU kernels
// reduced records into segments with a one-hot (records x segments)
// compare-and-reduce, because the TPU's vector unit has no fast scatter;
// that costs O(records x segments) work.  A GPU has atomics in L2, so the
// segment and mailbox reductions here are one scatter pass: O(records).
//
//  * min uses atomicMin on order-preserving float bits: a non-negative
//    float's bits order like a signed int, a negative float's bits order
//    in reverse like an unsigned int.  Bit patterns compare in a total
//    order, so the result is the same bits whatever order the atomics
//    land in: min is bitwise deterministic.
//  * add uses atomicAdd(float): the order of the adds, and so the f32
//    rounding, varies from run to run.  Add results agree with the plain
//    version to f32 re-association only.
//  * The identity of min is the true +inf.  The TPU kernels used the
//    finite stand-in 3.4e38 and mapped results >= 3.4e38 to +inf, so a
//    record value in [3.4e38, FLT_MAX] is the one input where the two
//    differ (tests/test_torch_kernels.py pins it).
//  * Segment ids < 0 are padding and are skipped, as are ids past the
//    end (the TPU kernels' one-hot compare never matched them either).
//
// relax is a plain elementwise pass; Triton would serve it equally well.
// It is CUDA C so that all three kernels share one nvcc build of a few
// seconds.  The engine hands segment_combine sorted segment ids, which a
// later change may exploit with a segmented scan (no atomics, fixed add
// order); the kernel's contract does not require sorted ids.

#include <limits>

#include "common.cuh"

namespace {

// Order-free float minimum through integer atomics (see the note above).
__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  const int bits = __float_as_int(v);
  if (bits >= 0) {
    atomicMin(reinterpret_cast<int*>(addr), bits);
  } else {
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
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
    // min touches only the indices some record hits: the mailbox
    // legitimately holds +inf elsewhere and keeps it
    if (is_min) {
      atomic_min_f32(out + s, val[i]);
    } else {
      atomicAdd(out + s, val[i]);
    }
    atomicAdd(count + s, 1);
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
  return static_cast<int>(cudaGetLastError());
}

// segment_combine: out[s] = combine of val[i] over seg[i] == s; untouched
// segments hold the identity (+inf for min, 0 for add).
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

// deliver_fused: out = mail with every record folded in at seg[i];
// count_f32[j] = number of records with seg == j.  count_i32 is scratch.
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
