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
// it, 4 flops per (head, position, dim): at starcoder2-3b's width
// (G = 12, D = 128) 12 flops per bf16 byte, where the tensor cores would
// bound it only past ~295.  What set the pace of the first version (all
// products on the CUDA cores, warps owning heads, still the f32 path) was
// a warp's chain of dependent FMAs, shared-memory loads and shuffles: 43%
// of the byte bound at G = 12, batch 128, 2.1x cuDNN's attention.
//
// The design.  The TPU kernel walked a sequential (batch, head,
// kv_block) grid, one query head at a time, carrying the online-softmax
// state in VMEM.  Here:
//  * GQA sharing: one block of threads per (split, KV head, batch) reads
//    each K/V tile once from device memory and scores it against all G
//    heads of the group.  A block per query head would read K/V G times.
//  * Split-KV: the positions are cut into chunks so that the grid fills
//    the 132 SMs even at batch 1; each split writes its partial
//    (max, sum, acc[G][D]) to an f32 workspace, and a second launch
//    merges the splits (and the n_zero padded positions) with the
//    log-sum-exp rescale: every split's weight in one round of loads,
//    warps over ranges of splits, then the warps' sums in a fixed order.
//  * bf16 (decode_split_tc_kernel): both products on the tensor cores,
//    mma.sync m16n8k16 bf16 -> f32 with operands from shared memory by
//    ldmatrix (.trans for V).  The group's query heads are the M rows of
//    the tile (heads past G have q = 0 and are never stored; G > 16 takes
//    one block per 16 heads, each reading K/V, the later ones from L2: no
//    model in the registry has G > 12), so the score fragments are masked,
//    rescaled and turned into P's A fragments in registers.  Q.K^T of bf16
//    values is exact in f32 products; P keeps f32 accuracy in P.V as
//    bf16 hi + bf16 lo, two mma per step.  Warps split positions: each of
//    the 4 takes 16 positions of every 64-position tile for all heads and
//    keeps its own (max, sum, acc); the block merges the 4 in shared
//    memory at the end of its split.  Row maxima take two quad shuffles.
//    Tiles come by 16-byte cp.async into a 3-stage ring (two in flight
//    while one is computed); the row stride is an odd number of 16-byte
//    units, so ldmatrix is free of bank conflicts, and D is padded with
//    zero columns to a multiple of 16 (D = 120 reads zeros in its last
//    k16 step).  Two blocks fit on an SM (231 registers at D = 128, no
//    spills).
//    On an H100 SXM at 700 W (chip_smoke.py phase 8, one layer at
//    S = 32,768, lengths S, two runs on two cards; PERF.md has them):
//    86-90% of the byte bound at starcoder2-3b's batch 128 (1.495 and
//    1.421 ms; the first version 2.994, cuDNN's attention 1.409 and
//    1.363 on the same cards), 87-92% at h2o-danube-3-4b's and at
//    deepseek-7b's (G = 1), 47% for one request (0.0215 ms, cuDNN 0.030
//    to 0.031).  Against it (scripts/decode_variants.py, the same two
//    runs): a 4-stage ring at one block an SM, or 8 warps on
//    128-position tiles, 0.5-0.9% faster at G = 12 and up to 7% slower
//    elsewhere; 2 stages at three blocks an SM 15-31% slower; two blocks
//    an SM in the split plan 7-9% slower for one request.
//  * f32 (decode_split_kernel): the CUDA cores, since the tensor cores
//    give f32 products only through a 3-way bf16 split, and the path is
//    held to 1e-4.  Tiles of 32 positions, lane = position for the
//    scores, lane = 4 output dims for P @ V, warp w owning GPW =
//    ceil(G / 8) heads; expf and f32 sums throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 128;
constexpr int kMaxGroup = 64;
constexpr int kMaxSplits = 1024;       // MAX_SPLITS in decode_attention.py
constexpr int kChunkUnit = 64;         // TILE in decode_attention.py
constexpr float kLn2 = 0.69314718055994531f;
constexpr float kLog2e = 1.44269504088896341f;

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
// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row stride (elements of `bytes` bytes) of a tile row of d elements in
// shared memory: an odd number of 16-byte units, so 8 or 32 lanes
// reading 16 bytes of as many rows hit distinct banks.
__host__ __device__ constexpr int tile_ld(int d, int bytes) {
  return ((d * bytes / 16) % 2 ? d * bytes / 16 : d * bytes / 16 + 1) * 16 /
         bytes;
}

// ------------------------------------------------ bf16: tensor cores

constexpr int kTcTile = 64;                 // positions per tile
constexpr int kTcWarps = 4;                 // each takes 16 of them
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcStages = 3;
constexpr int kTcRows = 16;                 // query heads per block: M

using bf16 = __nv_bfloat16;

// Four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8, and r[j] is matrix j's fragment.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as a bf16 pair hi (x in the low half) and the pair of what it
// rounded off, lo: hi + lo holds x and y to ~2^-17.
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Two bf16 of q (row `head` of the group, dims col, col + 1), or zeros
// past the group or past d.
__device__ __forceinline__ uint32_t q_pair(const bf16* qg, int head, int col,
                                           int group, int d) {
  return head < group && col < d
             ? *reinterpret_cast<const uint32_t*>(qg + head * d + col)
             : 0u;
}

// Issue the copy of `rows` K and V rows (d elements each) into the tiles
// ks / vs (16 * KS columns, the ones past d zero-filled); the rows past
// `rows` are zero-filled too.
template <int KS>
__device__ __forceinline__ void issue_tc_tile(bf16* ks, bf16* vs,
                                              const bf16* kp, const bf16* vp,
                                              int rows, int d) {
  constexpr int kCpr = 2 * KS;              // 16-byte chunks a padded row
  constexpr int kLd = tile_ld(16 * KS, 2);
#pragma unroll
  for (int j = 0; j < kTcTile * kCpr / kTcThreads; ++j) {
    const int i = threadIdx.x + j * kTcThreads;
    const int r = i / kCpr, c = (i % kCpr) * 8;
    const bool in = r < rows && c < d;
    const long long off = in ? static_cast<long long>(r) * d + c : 0;
    cp_async16(ks + r * kLd + c, kp + off, in ? 16 : 0);
    cp_async16(vs + r * kLd + c, vp + off, in ? 16 : 0);
  }
}

template <int KS>
constexpr size_t tc_smem_bytes() {
  constexpr size_t ring =
      sizeof(bf16) * kTcStages * 2 * kTcTile * tile_ld(16 * KS, 2);
  constexpr size_t partials =
      sizeof(float) * kTcWarps * kTcRows * (16 * KS + 3);
  return ring > partials ? ring : partials;
}

// One block per (split, 16-head chunk of the group, KV head, batch row):
// blockIdx.x = split * n_chunks + chunk.  Lane (gq, tq) = (lane / 4,
// lane % 4) holds the fragments' rows (heads) gq and gq + 8.
template <int KS>
__global__ void __launch_bounds__(kTcThreads, 2)
decode_split_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const int32_t* __restrict__ lengths,
                       float* __restrict__ ws_m, float* __restrict__ ws_l,
                       float* __restrict__ ws_acc, int h, int hkv,
                       long long s, int d, int splits, long long chunk,
                       float scale_log2) {
  constexpr int kDp = 16 * KS;              // D padded to the k16 steps
  constexpr int kLd = tile_ld(kDp, 2);
  constexpr int kStage = 2 * kTcTile * kLd; // elements: K and V tiles
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);   // [stage][K, V][tile][kLd]
  const int group = h / hkv;
  const int n_chunks = (group + kTcRows - 1) / kTcRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int split = blockIdx.x / n_chunks;
  const int head0 = (blockIdx.x % n_chunks) * kTcRows;
  const int kvh = blockIdx.y, b = blockIdx.z;

  const long long len = lengths[b];
  const bool uniform = len <= 0;        // every score is the mask's
  const long long n_read = uniform ? s : (len < s ? len : s);
  const long long start = static_cast<long long>(split) * chunk;
  const long long end = start + chunk < n_read ? start + chunk : n_read;
  const int n_tiles =
      start < end ? static_cast<int>((end - start + kTcTile - 1) / kTcTile)
                  : 0;
  const long long pair = static_cast<long long>(b) * hkv + kvh;
  const bf16* kp = k + (pair * s + start) * d;
  const bf16* vp = v + (pair * s + start) * d;

#pragma unroll
  for (int t = 0; t < kTcStages - 1; ++t) {
    if (t < n_tiles) {
      const long long t0 = static_cast<long long>(t) * kTcTile;
      issue_tc_tile<KS>(ring + t * kStage, ring + t * kStage + kTcTile * kLd,
                        kp + t0 * d, vp + t0 * d,
                        static_cast<int>(end - start - t0 < kTcTile
                                             ? end - start - t0
                                             : kTcTile),
                        d);
    }
    cp_async_commit();
  }

  // q as the A operand of every k16 step, zero past the group and past d
  const bf16* qg = q + (static_cast<long long>(b) * h +
                        static_cast<long long>(kvh) * group) * d;
  const int ha = head0 + gq, hb = ha + 8;
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + 2 * tq;
    qa[ks][0] = q_pair(qg, ha, c, group, d);
    qa[ks][1] = q_pair(qg, hb, c, group, d);
    qa[ks][2] = q_pair(qg, ha, c + 8, group, d);
    qa[ks][3] = q_pair(qg, hb, c + 8, group, d);
  }

  // this lane's ldmatrix row addresses within a stage: for K, matrix
  // i / 8 is (positions +8 if i >= 16, dims +8 if i odd); for V^T,
  // (positions +8 if i odd, dims +8 if i >= 16)
  const int mi = lane >> 3, r8 = lane & 7;
  const uint32_t ring_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const uint32_t k_off = static_cast<uint32_t>(
      ((warp * 16 + (mi >> 1) * 8 + r8) * kLd + (mi & 1) * 8) * 2);
  const uint32_t v_off = static_cast<uint32_t>(
      (kTcTile * kLd + (warp * 16 + (mi & 1) * 8 + r8) * kLd +
       (mi >> 1) * 8) * 2);

  // rows gq, gq + 8: running max (log2 units), this lane's part of the
  // sum, and the accumulator's fragments over the 2 * KS dim tiles
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[2 * KS][4];
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kTcStages - 2>();     // tile i has landed
    __syncthreads();                    // and tile i - 1's stage is free
    {
      const int t = i + kTcStages - 1;
      if (t < n_tiles) {
        const long long t0 = static_cast<long long>(t) * kTcTile;
        bf16* ks = ring + (t % kTcStages) * kStage;
        issue_tc_tile<KS>(ks, ks + kTcTile * kLd, kp + t0 * d, vp + t0 * d,
                          static_cast<int>(end - start - t0 < kTcTile
                                               ? end - start - t0
                                               : kTcTile),
                          d);
      }
      cp_async_commit();
    }
    const long long t0 = start + static_cast<long long>(i) * kTcTile;
    const int rows = static_cast<int>(end - t0 < kTcTile ? end - t0 : kTcTile);
    const uint32_t stage = ring_s + (i % kTcStages) * kStage * 2;

    // S = Q K^T over this warp's 16 positions (two n8 tiles), the even
    // and odd k16 steps in separate accumulators
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if (!uniform) {
      float sx[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kb[4];
        ldsm_x4(stage + k_off + ks * 32, kb);
        if (ks % 2) {
          mma_bf16(sx[0], qa[ks], kb[0], kb[1]);
          mma_bf16(sx[1], qa[ks], kb[2], kb[3]);
        } else {
          mma_bf16(sc[0], qa[ks], kb[0], kb[1]);
          mma_bf16(sc[1], qa[ks], kb[2], kb[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] += sx[j][e];
    }

    // online softmax on the fragments: positions past `rows` -inf, row
    // maxima over the quad, one rescale per row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = warp * 16 + j * 8 + 2 * tq + (e & 1) < rows;
        sc[j][e] = valid ? sc[j][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    float base[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      base[r] = m_new == -INFINITY ? 0.f : m_new;  // no -inf - -inf
      corr[r] = exp2f(m[r] - base[r]);             // 0 while m is -inf
      m[r] = m_new;
    }
    float p[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = exp2f(sc[j][e] - base[e >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] = l[r] * corr[r] + ((p[0][2 * r] + p[0][2 * r + 1]) +
                               (p[1][2 * r] + p[1][2 * r + 1]));
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // P (16 heads x 16 positions) as the A operand, bf16 hi + lo
    uint32_t ph[4], pl[4];
    split_bf16x2(p[0][0], p[0][1], ph[0], pl[0]);
    split_bf16x2(p[0][2], p[0][3], ph[1], pl[1]);
    split_bf16x2(p[1][0], p[1][1], ph[2], pl[2]);
    split_bf16x2(p[1][2], p[1][3], ph[3], pl[3]);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t vb[4];
      ldsm_x4_t(stage + v_off + kk * 32, vb);
      mma_bf16(acc[2 * kk], ph, vb[0], vb[1]);
      mma_bf16(acc[2 * kk + 1], ph, vb[2], vb[3]);
      mma_bf16(acc[2 * kk], pl, vb[0], vb[1]);
      mma_bf16(acc[2 * kk + 1], pl, vb[2], vb[3]);
    }
  }

  // the 4 warps' partials through shared memory (the ring is free once
  // every copy has landed and every warp is past its last tile)
  cp_async_wait<0>();
  __syncthreads();
  float* pm = reinterpret_cast<float*>(smem);   // [warp][16]
  float* psum = pm + kTcWarps * kTcRows;        // [warp][16]
  float* pw = psum + kTcWarps * kTcRows;        // [warp][16]: weights
  float* pacc = pw + kTcWarps * kTcRows;        // [warp][16][kDp]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row = warp * kTcRows + gq;
  if (tq == 0) {
    pm[row] = m[0];
    pm[row + 8] = m[1];
    psum[row] = l[0];
    psum[row + 8] = l[1];
  }
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j) {
    const int c = j * 8 + 2 * tq;
    *reinterpret_cast<float2*>(pacc + row * kDp + c) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(pacc + (row + 8) * kDp + c) =
        make_float2(acc[j][2], acc[j][3]);
  }
  __syncthreads();
  const long long out0 = (pair * splits + split) * group;
  if (threadIdx.x < kTcRows) {
    const int r = threadIdx.x;
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) mb = fmaxf(mb, pm[w * kTcRows + r]);
    const float b0 = mb == -INFINITY ? 0.f : mb;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) {
      const float e = exp2f(pm[w * kTcRows + r] - b0);
      pw[w * kTcRows + r] = e;
      sum += e * psum[w * kTcRows + r];
    }
    if (head0 + r < group) {            // an empty split: (-inf, 0, 0)
      ws_m[out0 + head0 + r] = mb * kLn2;
      ws_l[out0 + head0 + r] = sum;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTcRows * kDp; i += kTcThreads) {
    const int r = i / kDp, c = i % kDp;
    if (head0 + r < group && c < d) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kTcWarps; ++w)
        o = fmaf(pw[w * kTcRows + r], pacc[(w * kTcRows + r) * kDp + c], o);
      ws_acc[(out0 + head0 + r) * d + c] = o;
    }
  }
}

// --------------------------------------------------- f32: CUDA cores

constexpr int kTile = 32;              // positions per tile: one per lane
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;

// Issue the copy of `rows` K and V rows (d floats each, from kp / vp)
// into the tiles ks / vs; the rows past `rows` are zero-filled.
__device__ __forceinline__ void issue_tile(float* ks, float* vs,
                                           const float* kp, const float* vp,
                                           int rows, int d, int ld) {
  const int per_row = d / 4;
  for (int i = threadIdx.x; i < kTile * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * 4;
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
template <int GPW>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int32_t* __restrict__ lengths,
                    float* __restrict__ ws_m, float* __restrict__ ws_l,
                    float* __restrict__ ws_acc, int h, int hkv, long long s,
                    int d, int splits, long long chunk, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = tile_ld(d, 4);
  float* tiles = reinterpret_cast<float*>(smem);   // [stage][K, V][kTile][ld]
  float* qs = tiles + 2 * kStages * kTile * ld;
  const int group = h / hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* pw = qs + group * d + warp * GPW * kTile;  // [GPW][kTile] p
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
  const float* kp = k + pair * s * d;
  const float* vp = v + pair * s * d;
  if (n_tiles > 0)
    issue_tile(tiles, tiles + kTile * ld, kp + start * d, vp + start * d,
               static_cast<int>(end - start < kTile ? end - start : kTile), d,
               ld);
  cp_async_commit();

  const float* qg = q + (static_cast<long long>(b) * h +
                         static_cast<long long>(kvh) * group) * d;
  for (int i = threadIdx.x; i < group * d; i += kThreads) qs[i] = qg[i];
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
      float* ks1 = tiles + ((i + 1) % kStages) * 2 * kTile * ld;
      issue_tile(ks1, ks1 + kTile * ld, kp + t1 * d, vp + t1 * d,
                 static_cast<int>(end - t1 < kTile ? end - t1 : kTile), d,
                 ld);
    }
    cp_async_commit();
    cp_async_wait<1>();                 // this tile has landed
    __syncthreads();
    if (computes) {                     // warp-uniform
      const float* ks = tiles + (i % kStages) * 2 * kTile * ld;
      const float* vs = ks + kTile * ld;
      const bool valid = lane < rows;

      // scores of this lane's position for the warp's heads: four
      // partial sums each, the chunk loop unrolled, so that loads and
      // FMAs overlap
      float sc[GPW][4];
#pragma unroll
      for (int j = 0; j < GPW; ++j)
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      if (!uniform) {
        const float* kr = ks + lane * ld;
#pragma unroll 4
        for (int c = 0; c < d; c += 4) {
          const float4 kx = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
          for (int j = 0; j < GPW; ++j) {
            const float4 qv = *reinterpret_cast<const float4*>(qrow[j] + c);
            sc[j][0] = fmaf(kx.x, qv.x, sc[j][0]);
            sc[j][1] = fmaf(kx.y, qv.y, sc[j][1]);
            sc[j][2] = fmaf(kx.z, qv.z, sc[j][2]);
            sc[j][3] = fmaf(kx.w, qv.w, sc[j][3]);
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
        for (int u = 0; u < 8; ++u)
          vv[u] = *reinterpret_cast<const float4*>(vs + (r0 + u) * ld + col);
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

// ------------------------------------------------------------- merge

constexpr int kMergeWarps = 8;
constexpr int kMergeThreads = kMergeWarps * 32;

__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, bf16* out) {
  *out = __float2bfloat16_rn(x);
}

// One block per (batch row, head).  Each thread loads up to 4 splits'
// (max, sum): the common max over the splits (and the n_zero padded
// positions' score 0), the splits' weights into shared memory and the
// denominator; then warp w sums the weighted partials of its range of
// splits, lane = 4 output dims, loads independent of the weights;
// thread = output dim adds the warps' sums in warp order, divides, and
// writes q's dtype.  With lse (not null), thread 0 also writes the row's
// log-sum-exp, max + log(denominator), over the positions the row
// attends (-inf where its length is <= 0: such a row weighs nothing
// when blocks of positions are merged, whatever its output).
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
decode_merge_kernel(const float* __restrict__ ws_m,
                    const float* __restrict__ ws_l,
                    const float* __restrict__ ws_acc,
                    const int32_t* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ lse, int h, int hkv, long long s,
                    long long s_pad, int d, int splits) {
  constexpr int kPer = kMaxSplits / kMergeThreads;
  __shared__ float w[kMaxSplits];
  __shared__ float red[2][kMergeWarps];
  __shared__ __align__(16) float part[kMergeWarps][kMaxD];
  const int bh = blockIdx.x;
  const int b = bh / h, head = bh % h;
  const int group = h / hkv;
  const int kvh = head / group, g = head % group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long len = lengths[b];
  const long long n_zero =
      len <= 0 ? s_pad - s
               : (len < s_pad ? len : s_pad) - (len < s ? len : s);
  const long long base = (static_cast<long long>(b) * hkv + kvh) * splits;

  float mv[kPer], lv[kPer];
  float mx = n_zero > 0 ? 0.f : -INFINITY;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int sp = threadIdx.x + j * kMergeThreads;
    const long long idx = (base + sp) * group + g;
    mv[j] = sp < splits ? ws_m[idx] : -INFINITY;
    lv[j] = sp < splits ? ws_l[idx] : 0.f;
    mx = fmaxf(mx, mv[j]);
  }
  mx = warp_max(mx);
  if (lane == 0) red[0][warp] = mx;
  __syncthreads();
  mx = red[0][0];
#pragma unroll
  for (int i = 1; i < kMergeWarps; ++i) mx = fmaxf(mx, red[0][i]);
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int sp = threadIdx.x + j * kMergeThreads;
    const float e = expf(mv[j] - mx);   // 0 for an empty split
    if (sp < splits) w[sp] = e;
    l = fmaf(lv[j], e, l);
  }
  l = warp_sum(l);
  if (lane == 0) red[1][warp] = l;
  __syncthreads();                      // publishes w too

  const int per = (splits + kMergeWarps - 1) / kMergeWarps;
  const int s0 = warp * per;
  const int s1 = s0 + per < splits ? s0 + per : splits;
  const int col = 4 * lane;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < d) {
#pragma unroll 8
    for (int sp = s0; sp < s1; ++sp) {
      const float4 a = *reinterpret_cast<const float4*>(
          ws_acc + ((base + sp) * group + g) * d + col);
      const float e = w[sp];
      o.x = fmaf(a.x, e, o.x);
      o.y = fmaf(a.y, e, o.y);
      o.z = fmaf(a.z, e, o.z);
      o.w = fmaf(a.w, e, o.w);
    }
    *reinterpret_cast<float4*>(&part[warp][col]) = o;
  }
  __syncthreads();
  const int dim = threadIdx.x;
  if (dim < d) {
    float acc = 0.f, sum = 0.f;
#pragma unroll
    for (int i = 0; i < kMergeWarps; ++i) {
      acc += part[i][dim];
      sum += red[1][i];
    }
    if (n_zero > 0) sum += static_cast<float>(n_zero) * expf(-mx);
    from_f32(acc / fmaxf(sum, 1e-30f),
             out + static_cast<long long>(bh) * d + dim);
    if (lse != nullptr && dim == 0)
      lse[bh] = len <= 0 ? -INFINITY : mx + logf(sum);
  }
}

// ---------------------------------------------------------- launchers

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int KS>
int launch_split_tc(const void* q, const void* k, const void* v,
                    const int32_t* len, float* ws_m, float* ws_l,
                    float* ws_acc, long long b, long long h, long long hkv,
                    long long s, long long d, long long splits,
                    long long chunk, float scale, cudaStream_t stream) {
  auto kernel = decode_split_tc_kernel<KS>;
  constexpr size_t smem = tc_smem_bytes<KS>();
  const int err = set_smem(kernel, smem);
  if (err) return err;
  const long long n_chunks = (h / hkv + kTcRows - 1) / kTcRows;
  const dim3 grid(static_cast<unsigned>(splits * n_chunks),
                  static_cast<unsigned>(hkv), static_cast<unsigned>(b));
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), len, ws_m, ws_l, ws_acc,
      static_cast<int>(h), static_cast<int>(hkv), s, static_cast<int>(d),
      static_cast<int>(splits), chunk, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int GPW>
int launch_split_f32(const void* q, const void* k, const void* v,
                     const int32_t* len, float* ws_m, float* ws_l,
                     float* ws_acc, long long b, long long h, long long hkv,
                     long long s, long long d, long long splits,
                     long long chunk, float scale, cudaStream_t stream) {
  auto kernel = decode_split_kernel<GPW>;
  const size_t smem =
      (2 * kStages * kTile * tile_ld(static_cast<int>(d), 4) +
       (h / hkv) * d + kWarps * GPW * kTile) * sizeof(float);
  const int err = set_smem(kernel, smem);
  if (err) return err;
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(hkv),
                  static_cast<unsigned>(b));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), len, ws_m, ws_l, ws_acc,
      static_cast<int>(h), static_cast<int>(hkv), s, static_cast<int>(d),
      static_cast<int>(splits), chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

using SplitLauncher = int (*)(const void*, const void*, const void*,
                              const int32_t*, float*, float*, float*,
                              long long, long long, long long, long long,
                              long long, long long, long long, float,
                              cudaStream_t);

// bf16: the tensor-core kernel for D's k16 steps; f32: the CUDA-core
// kernel for GPW heads a warp.
SplitLauncher split_launcher(bool bf16_in, long long d, long long group) {
  if (bf16_in) {
    constexpr SplitLauncher by_steps[8] = {
        launch_split_tc<1>, launch_split_tc<2>, launch_split_tc<3>,
        launch_split_tc<4>, launch_split_tc<5>, launch_split_tc<6>,
        launch_split_tc<7>, launch_split_tc<8>};
    return by_steps[(d + 15) / 16 - 1];
  }
  const long long gpw = (group + kWarps - 1) / kWarps;
  return gpw <= 1   ? launch_split_f32<1>
         : gpw <= 2 ? launch_split_f32<2>
         : gpw <= 4 ? launch_split_f32<4>
                    : launch_split_f32<8>;
}

}  // namespace

extern "C" {

// decode_attention: out (B, H, D) in the inputs' dtype (bf16 != 0: bf16,
// else f32) from q (B, H, D), k, v (B, Hkv, S, D), lengths (B,) int32;
// lse, where not null, (B, H) f32: each row's log-sum-exp.
// ws_m, ws_l: (B, Hkv, splits, G) f32; ws_acc: (B, Hkv, splits, G, D)
// f32; split i covers positions [i * chunk, (i + 1) * chunk), chunk a
// multiple of 64, at most 1024 splits.  D a multiple of 8 up to 128,
// G = H / Hkv up to 64, B and Hkv up to 65,535.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* lengths, void* out, void* lse,
                            void* ws_m, void* ws_l, void* ws_acc,
                            long long b,
                            long long h, long long hkv, long long s,
                            long long d, long long splits, long long chunk,
                            long long s_pad, int bf16_in, float scale,
                            void* stream) {
  if (b < 1 || b > 65535 || hkv < 1 || hkv > 65535 || h % hkv != 0 ||
      h / hkv > kMaxGroup || s < 1 || d < 8 || d > kMaxD || d % 8 != 0 ||
      chunk % kChunkUnit != 0 || splits < 1 || splits > kMaxSplits ||
      splits * chunk < s)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* len = static_cast<const int32_t*>(lengths);
  float* m = static_cast<float*>(ws_m);
  float* l = static_cast<float*>(ws_l);
  float* acc = static_cast<float*>(ws_acc);
  const int err = split_launcher(bf16_in != 0, d, h / hkv)(
      q, k, v, len, m, l, acc, b, h, hkv, s, d, splits, chunk, scale, st);
  if (err) return err;
  const unsigned blocks = static_cast<unsigned>(b * h);
  float* row_lse = static_cast<float*>(lse);
  if (bf16_in)
    decode_merge_kernel<bf16><<<blocks, kMergeThreads, 0, st>>>(
        m, l, acc, len, static_cast<bf16*>(out), row_lse,
        static_cast<int>(h), static_cast<int>(hkv), s, s_pad,
        static_cast<int>(d), static_cast<int>(splits));
  else
    decode_merge_kernel<float><<<blocks, kMergeThreads, 0, st>>>(
        m, l, acc, len, static_cast<float*>(out), row_lse,
        static_cast<int>(h), static_cast<int>(hkv), s, s_pad,
        static_cast<int>(d), static_cast<int>(splits));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
