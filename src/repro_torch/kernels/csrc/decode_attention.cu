// Flash-decode GQA attention, written by hand for Hopper (sm_90a): one
// query token per (batch, head) against a KV cache with a length per
// batch row.  Built by kernels/_build.py with nvcc into a shared library
// with a plain C interface; the Python wrapper (decode_attention.py)
// checks its inputs, plans the split and allocates the f32 workspace and
// the output.  The launcher allocates nothing, does not synchronise, and
// returns the launches' cudaGetLastError().
//
// decode_attention  replaces src/repro/kernels/decode_attention.py:61
//
// The function is the Pallas kernel's, edges included: K and V padded
// with zero rows to s_pad (a multiple of its block_s), positions
// >= length scored with the finite -1e30, an f32 softmax over s_pad.
// Without the padding in memory that is:
//  * length >= 1: the positions < min(length, S) with their scores, and
//    n_zero = min(length, s_pad) - min(length, S) positions of score 0
//    and value 0 (the padded rows below the length); the masked ones
//    contribute exactly 0 in f32;
//  * length <= 0: every score is -1e30, so every position weighs 1: the
//    sum of V over S over s_pad.  Scoring the S positions 0 and adding
//    n_zero = s_pad - S zero rows gives the same.
//
// What bounds it on this card: device-memory bytes.  Each K and V row is
// read once and scored against the G = H / Hkv query heads that share
// it, 4 flops per (head, position, dim); at starcoder2-3b's width
// (G = 12, D = 128) that is 12 flops per bf16 byte, far below the
// ~20 f32 flops per byte at which 67 TFLOP/s would bound it.
//
// What the design does about it.  The TPU kernel walked a sequential
// (batch, head, kv_block) grid, one query head at a time, carrying the
// online-softmax state in VMEM.  Here:
//  * GQA sharing: one block of threads per (split, KV head, batch) reads
//    each K/V tile once from device memory and scores it against all G
//    heads of the group, whose q is kept in shared memory as f32.  A
//    block per query head would read K/V G times.
//  * Split-KV: the positions are cut into chunks so that the grid fills
//    the 132 SMs even at batch 1; each split writes its partial
//    (max, sum, acc[G][D]) to an f32 workspace, and a second launch
//    merges the splits (and the n_zero padded positions) with the
//    log-sum-exp rescale, in a fixed order, and writes q's dtype.
//  * Within a split, tiles of 32 positions, copied into shared memory as
//    they are (bf16 stays bf16) with 16-byte cp.async, two stages deep,
//    so the next tile is in flight while this one is computed.  Shared
//    memory bandwidth, not device memory, is what a tile costs here: so
//    each 16-byte chunk of K read from it is scored against every head
//    its warp owns, and each V element is used for all of them, before
//    the next is read.
//  * Scores: lane = position (the row stride is padded to an odd number
//    of 16-byte units, so a warp's 16-byte reads of 32 rows hit distinct
//    banks); one rescale per tile and head; then lane = 4 dims of the
//    output for P @ V, the weights read back from the warp's own row of
//    shared memory.  Warp w owns GPW = ceil(G / 8) heads in a row.  The
//    hot loops are unrolled with independent partial sums and hold no
//    branch, because a warp's own latency, more than device memory, is
//    what a tile costs: a loop that waits on each shared-memory load,
//    shuffle or branch in turn leaves the tile's bytes idle.  expf, not
//    __expf: the error stays within 1e-4 of the plain version in f32.
//  * The merge: one block per (batch row, head); the common max, the
//    weights and the denominator over the splits' threads, then
//    thread = output dim over the splits.
// Tensor cores (mma / wgmma for the G x D by D x 32 products), TMA loads
// and a persistent, warp-specialised tile ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;              // positions per tile: one per lane
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 128;
constexpr int kMaxSplits = 1024;       // MAX_SPLITS in decode_attention.py
constexpr int kStages = 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// The 16 / sizeof(T) values of one 16-byte chunk, as f32.
__device__ __forceinline__ void unpack16(uint4 u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(uint4 u, float (&x)[8]) {
  x[0] = bf_lo(u.x); x[1] = bf_hi(u.x);
  x[2] = bf_lo(u.y); x[3] = bf_hi(u.y);
  x[4] = bf_lo(u.z); x[5] = bf_hi(u.z);
  x[6] = bf_lo(u.w); x[7] = bf_hi(u.w);
}

// Four consecutive values at p (8- or 16-byte aligned), as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf_lo(u.x), bf_hi(u.x), bf_lo(u.y), bf_hi(u.y));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16 bytes from global to shared memory, asynchronously; src_bytes 0
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Row stride (elements) of a tile in shared memory: an odd number of
// 16-byte units, so 32 lanes reading 16 bytes of 32 rows hit every bank.
template <typename T>
__host__ __device__ __forceinline__ int tile_ld(int d) {
  const int units = d * static_cast<int>(sizeof(T)) / 16;
  return (units % 2 ? units : units + 1) * 16 / static_cast<int>(sizeof(T));
}

// Issue the copy of `rows` K and V rows (d elements each, from kp / vp)
// into the tiles ks / vs; the rows past `rows` are zero-filled.
template <typename T>
__device__ __forceinline__ void issue_tile(T* ks, T* vs, const T* kp,
                                           const T* vp, int rows, int d,
                                           int ld) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = d / kVec;
  for (int i = threadIdx.x; i < kTile * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * kVec;
    const bool in = r < rows;
    const long long off = in ? static_cast<long long>(r) * d + c : 0;
    cp_async16(ks + r * ld + c, kp + off, in ? 16 : 0);
    cp_async16(vs + r * ld + c, vp + off, in ? 16 : 0);
  }
}

// One block per (split, KV head, batch row); warp w owns the group's
// heads w * GPW .. w * GPW + GPW - 1 (the warps past the last head idle;
// a head number past the group is clamped to a real row, computed and
// never stored, so that the hot loops hold no branch).
template <typename T, int GPW>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ lengths,
                    float* __restrict__ ws_m, float* __restrict__ ws_l,
                    float* __restrict__ ws_acc, int h, int hkv, long long s,
                    int d, int splits, long long chunk, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = tile_ld<T>(d);
  T* tiles = reinterpret_cast<T*>(smem);           // [stage][K, V][kTile][ld]
  float* qs = reinterpret_cast<float*>(tiles + 2 * kStages * kTile * ld);
  const int group = h / hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* pw = qs + group * d + warp * GPW * kTile;  // this warp's [GPW][kTile] p
  const bool computes = warp * GPW < group;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int d4 = d / 4;
  const int col = lane < d4 ? 4 * lane : 0;         // this lane's output dims

  const long long len = lengths[b];
  const bool uniform = len <= 0;        // every score is the mask's
  const long long n_read = uniform ? s : (len < s ? len : s);
  const long long start = static_cast<long long>(split) * chunk;
  const long long end = start + chunk < n_read ? start + chunk : n_read;
  const int n_tiles =
      start < end ? static_cast<int>((end - start + kTile - 1) / kTile) : 0;

  const long long pair = static_cast<long long>(b) * hkv + kvh;
  const T* kp = k + pair * s * d;
  const T* vp = v + pair * s * d;
  if (n_tiles > 0)
    issue_tile<T>(tiles, tiles + kTile * ld, kp + start * d, vp + start * d,
                  static_cast<int>(end - start < kTile ? end - start : kTile),
                  d, ld);
  cp_async_commit();

  const T* qg = q + (static_cast<long long>(b) * h +
                     static_cast<long long>(kvh) * group) * d;
  for (int i = threadIdx.x; i < group * d; i += kThreads)
    qs[i] = to_f32(qg[i]);
  const float* qrow[GPW];
  float m[GPW], l[GPW], acc[GPW][4];
#pragma unroll
  for (int j = 0; j < GPW; ++j) {
    const int g = warp * GPW + j;
    qrow[j] = qs + (g < group ? g : group - 1) * d;
    m[j] = -INFINITY;
    l[j] = 0.f;
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    const long long t0 = start + static_cast<long long>(i) * kTile;
    const int rows = static_cast<int>(end - t0 < kTile ? end - t0 : kTile);
    if (i + 1 < n_tiles) {              // the next tile into the other stage
      const long long t1 = t0 + kTile;
      T* ks1 = tiles + ((i + 1) % kStages) * 2 * kTile * ld;
      issue_tile<T>(ks1, ks1 + kTile * ld, kp + t1 * d, vp + t1 * d,
                    static_cast<int>(end - t1 < kTile ? end - t1 : kTile), d,
                    ld);
    }
    cp_async_commit();
    cp_async_wait_one();                // this tile has landed
    __syncthreads();
    if (computes) {                     // warp-uniform
      const T* ks = tiles + (i % kStages) * 2 * kTile * ld;
      const T* vs = ks + kTile * ld;
      const bool valid = lane < rows;

      // scores of this lane's position for the warp's heads: four
      // partial sums each, the chunk loop unrolled, so that loads and
      // FMAs overlap
      float sc[GPW][4];
#pragma unroll
      for (int j = 0; j < GPW; ++j)
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      if (!uniform) {
        const T* kr = ks + lane * ld;
#pragma unroll 4
        for (int c = 0; c < d; c += kVec) {
          float kx[kVec];
          unpack16(*reinterpret_cast<const uint4*>(kr + c), kx);
#pragma unroll
          for (int j = 0; j < GPW; ++j) {
#pragma unroll
            for (int e = 0; e < kVec; e += 4) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(qrow[j] + c + e);
              sc[j][0] = fmaf(kx[e], qv.x, sc[j][0]);
              sc[j][1] = fmaf(kx[e + 1], qv.y, sc[j][1]);
              sc[j][2] = fmaf(kx[e + 2], qv.z, sc[j][2]);
              sc[j][3] = fmaf(kx[e + 3], qv.w, sc[j][3]);
            }
          }
        }
      }

      // online softmax over the tile, one rescale per head; the weights
      // go to the warp's row of shared memory for P @ V
#pragma unroll
      for (int j = 0; j < GPW; ++j) {
        const float x =
            valid ? ((sc[j][0] + sc[j][1]) + (sc[j][2] + sc[j][3])) * scale
                  : -INFINITY;
        const float m_new = fmaxf(m[j], warp_max(x));   // lane 0 is valid
        const float p = valid ? expf(x - m_new) : 0.f;
        const float corr = expf(m[j] - m_new);          // 0 on the first tile
        l[j] = l[j] * corr + warp_sum(p);
        m[j] = m_new;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= corr;
        pw[j * kTile + lane] = p;
      }
      __syncwarp();

      // P @ V: lane = output dims col .. col + 3, over all 32 rows (those
      // past `rows` are zero and weigh 0), 8 rows per step with their
      // loads issued together
#pragma unroll
      for (int r0 = 0; r0 < kTile; r0 += 8) {
        float4 vv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) vv[u] = load4(vs + (r0 + u) * ld + col);
#pragma unroll
        for (int j = 0; j < GPW; ++j) {
          const float4 pa =
              *reinterpret_cast<const float4*>(pw + j * kTile + r0);
          const float4 pb =
              *reinterpret_cast<const float4*>(pw + j * kTile + r0 + 4);
          const float pt[8] = {pa.x, pa.y, pa.z, pa.w,
                               pb.x, pb.y, pb.z, pb.w};
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            acc[j][0] = fmaf(pt[u], vv[u].x, acc[j][0]);
            acc[j][1] = fmaf(pt[u], vv[u].y, acc[j][1]);
            acc[j][2] = fmaf(pt[u], vv[u].z, acc[j][2]);
            acc[j][3] = fmaf(pt[u], vv[u].w, acc[j][3]);
          }
        }
      }
    }
    __syncthreads();                    // this stage is free for tile i + 2
  }

  // partials; an empty split writes (-inf, 0, 0), which the merge weighs 0
#pragma unroll
  for (int j = 0; j < GPW; ++j) {
    const int g = warp * GPW + j;
    if (g < group) {
      const long long idx = (pair * splits + split) * group + g;
      if (lane == 0) {
        ws_m[idx] = m[j];
        ws_l[idx] = l[j];
      }
      if (lane < d4)
        *reinterpret_cast<float4*>(ws_acc + idx * d + col) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
  }
}

// The max (or the sum) of x over a block of kMaxD threads.
__device__ __forceinline__ float block_reduce(float x, bool is_max,
                                              float* red) {
  x = is_max ? warp_max(x) : warp_sum(x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kMaxD / 32; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

// One block per (batch row, head): the common max of the splits (and of
// the n_zero padded positions' score 0), each split's weight and the
// denominator over the threads, then thread = output dim over the
// splits, in split order; writes q's dtype.
template <typename T>
__global__ void __launch_bounds__(kMaxD)
decode_merge_kernel(const float* __restrict__ ws_m,
                    const float* __restrict__ ws_l,
                    const float* __restrict__ ws_acc,
                    const int32_t* __restrict__ lengths, T* __restrict__ out,
                    int h, int hkv, long long s, long long s_pad, int d,
                    int splits) {
  __shared__ float w[kMaxSplits];
  __shared__ float red[kMaxD / 32];
  const int bh = blockIdx.x;
  const int b = bh / h, head = bh % h;
  const int group = h / hkv;
  const int kvh = head / group, g = head % group;
  const long long len = lengths[b];
  const long long n_zero =
      len <= 0 ? s_pad - s
               : (len < s_pad ? len : s_pad) - (len < s ? len : s);
  const long long base = (static_cast<long long>(b) * hkv + kvh) * splits;

  float mx = n_zero > 0 ? 0.f : -INFINITY;
  for (int sp = threadIdx.x; sp < splits; sp += blockDim.x)
    mx = fmaxf(mx, ws_m[(base + sp) * group + g]);
  mx = block_reduce(mx, true, red);
  float l = 0.f;
  for (int sp = threadIdx.x; sp < splits; sp += blockDim.x) {
    const long long idx = (base + sp) * group + g;
    w[sp] = expf(ws_m[idx] - mx);
    l += ws_l[idx] * w[sp];
  }
  l = block_reduce(l, false, red);      // its barrier publishes w
  if (n_zero > 0) l += static_cast<float>(n_zero) * expf(-mx);
  const int dim = threadIdx.x;
  if (dim < d) {
    const float* a = ws_acc + (base * group + g) * d + dim;
    const long long stride = static_cast<long long>(group) * d;
    float o = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp) o = fmaf(a[sp * stride], w[sp], o);
    from_f32(o / fmaxf(l, 1e-30f), out + static_cast<long long>(bh) * d + dim);
  }
}

template <typename T, int GPW>
int launch_split(const void* q, const void* k, const void* v,
                 const int32_t* len, float* ws_m, float* ws_l, float* ws_acc,
                 long long b, long long h, long long hkv, long long s,
                 long long d, long long splits, long long chunk, float scale,
                 cudaStream_t stream) {
  auto kernel = decode_split_kernel<T, GPW>;
  const size_t smem = 2 * kStages * kTile * tile_ld<T>(static_cast<int>(d)) *
                          sizeof(T) +
                      ((h / hkv) * d + kWarps * GPW * kTile) * sizeof(float);
  if (smem > 48 * 1024) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err) return err;
  }
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(hkv),
                  static_cast<unsigned>(b));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), len, ws_m, ws_l, ws_acc,
      static_cast<int>(h), static_cast<int>(hkv), s, static_cast<int>(d),
      static_cast<int>(splits), chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_all(const void* q, const void* k, const void* v,
               const int32_t* len, void* out, float* ws_m, float* ws_l,
               float* ws_acc, long long b, long long h, long long hkv,
               long long s, long long d, long long splits, long long chunk,
               long long s_pad, float scale, cudaStream_t stream) {
  const long long gpw = (h / hkv + kWarps - 1) / kWarps;
  int err;
  if (gpw <= 1)
    err = launch_split<T, 1>(q, k, v, len, ws_m, ws_l, ws_acc, b, h, hkv, s,
                             d, splits, chunk, scale, stream);
  else if (gpw <= 2)
    err = launch_split<T, 2>(q, k, v, len, ws_m, ws_l, ws_acc, b, h, hkv, s,
                             d, splits, chunk, scale, stream);
  else if (gpw <= 4)
    err = launch_split<T, 4>(q, k, v, len, ws_m, ws_l, ws_acc, b, h, hkv, s,
                             d, splits, chunk, scale, stream);
  else
    err = launch_split<T, 8>(q, k, v, len, ws_m, ws_l, ws_acc, b, h, hkv, s,
                             d, splits, chunk, scale, stream);
  if (err) return err;
  decode_merge_kernel<T><<<static_cast<unsigned>(b * h), kMaxD, 0, stream>>>(
      ws_m, ws_l, ws_acc, len, static_cast<T*>(out), static_cast<int>(h),
      static_cast<int>(hkv), s, s_pad, static_cast<int>(d),
      static_cast<int>(splits));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// decode_attention: out (B, H, D) in the inputs' dtype (bf16 != 0: bf16,
// else f32) from q (B, H, D), k, v (B, Hkv, S, D), lengths (B,) int32.
// ws_m, ws_l: (B, Hkv, splits, G) f32; ws_acc: (B, Hkv, splits, G, D)
// f32; split i covers positions [i * chunk, (i + 1) * chunk), chunk a
// multiple of 32, at most 1024 splits.  D a multiple of 8 up to 128,
// G = H / Hkv up to 64.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, void* ws_m,
                            void* ws_l, void* ws_acc, long long b,
                            long long h, long long hkv, long long s,
                            long long d, long long splits, long long chunk,
                            long long s_pad, int bf16, float scale,
                            void* stream) {
  if (b < 1 || hkv < 1 || h % hkv != 0 || h / hkv > 8 * kWarps || s < 1 ||
      d < 8 || d > kMaxD || d % 8 != 0 || chunk % kTile != 0 ||
      splits < 1 || splits > kMaxSplits || splits * chunk < s)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* len = static_cast<const int32_t*>(lengths);
  float* m = static_cast<float*>(ws_m);
  float* l = static_cast<float*>(ws_l);
  float* acc = static_cast<float*>(ws_acc);
  if (bf16)
    return launch_all<__nv_bfloat16>(q, k, v, len, out, m, l, acc, b, h, hkv,
                                     s, d, splits, chunk, s_pad, scale, st);
  return launch_all<float>(q, k, v, len, out, m, l, acc, b, h, hkv, s, d,
                           splits, chunk, s_pad, scale, st);
}

}  // extern "C"
