// One-token GQA decode attention over a KV cache, split across blocks
// along the cache (flash-decoding), with an online softmax: two split
// kernels and one combine.
//
// Replaces the Pallas TPU kernel `decode_attention` / `_decode_kernel` of
// src/repro/kernels/decode_attention.py: q (B, Hq, D), cache_k and cache_v
// (B, S, Hkv, D) in bf16 or f32, kv_len (B,) int32, output (B, Hq, D) in
// q's dtype. Query head h attends over cache rows 0 .. kv_len[b]-1 of KV
// head h / G, G = Hq / Hkv, with the scores scaled by 1/sqrt(D) in f32, as
// in the reference kernel.
//
// Which split kernel serves a call (the wrapper names it,
// `kernels/decode_attention.py` `decode_kernel`):
//   bf16, D = 64, 80, 128, G <= 64  decode_split_mma_kernel<D> (tensor
//                                   cores, 64-row tiles)
//   f32; bf16 at D = 16, 32         decode_split_kernel<T, D> (FP32 FMAs,
//                                   128-row tiles)
// (measured on the H100, the tensor-core kernel beat the FMA kernel at
// every bf16 group from G = 1 to 48, at D = 64, 80 and 128, so there is no
// group threshold and the FMA kernel is not built for bf16 at those head
// dims; a bf16 group above 64 at them is refused)
//
// What bounds it on the H100: memory, while the products stay off the
// critical path. Each live cache row is read once and used for 2*G*D
// multiply-adds, about G/2 FLOP per byte in bf16, under the card's ~295
// FLOP per byte of the tensor cores. On FP32 FMAs (67 TFLOP/s, about 20
// FLOP per byte) a wide group is not: at granite-34b's G = 48 every
// 128-row tile costs 48 x 128 x 128 x 2 FMAs in each block, and the CUDA
// cores set the pace. Both kernels:
//   * GQA is an index, never a copy: one block serves all G query heads of
//     its KV head, so each K/V row is read from device memory once (the TPU
//     grid runs one step per query head and streams the KV block G times);
//   * only live rows are read: a block stops at kv_len[b]. The TPU kernel
//     streams the whole capacity and masks it. Rows past kv_len are never
//     touched, so any capacity S works (the TPU kernel asserted
//     S % blk_k == 0);
//   * kv_len is read on the device, clamped to [0, S]; the host never
//     syncs on it;
//   * one block per (KV head, batch row) would run only B*Hkv blocks (4
//     for granite-34b at B = 4) on 132 SMs, each walking ~17 tiles in
//     series. So the cache rows of each (KV head, batch row) are split
//     across blocks: grid (splits, Hkv, B), each split a whole number of
//     the kernel's tiles, planned on the host from the capacity S, B, Hkv
//     and the kernel's tile (never from kv_len) to aim at 8 blocks per SM
//     where S allows (`split_plan`); granite's 2144-row cache at B = 4
//     runs 34 splits of one 64-row tile, 136 blocks (68 with 128-row
//     tiles). Each block writes its partial (m, l, acc[G, D]) in f32 to
//     scratch; the combine kernel rescales the partials by exp(m_i - M)
//     and writes acc / max(l, 1e-30). A split that starts at or past
//     kv_len[b] writes m = -inf, l = 0 and acc = 0 and reads no row; its
//     weight in the combine is 0. Split 0 holds row 0, so with kv_len >= 1
//     (the contract) M is finite.
//
// The tensor-core kernel (bf16, wide groups):
//   * scores and PV are mma.sync.m16n8k16 with bf16 operands and f32
//     accumulation: the A operand of Q K^T is the group's query heads,
//     16 per warp (ceil(G / 16) warps, rows past G zero), loaded once from
//     device memory into registers; K and V come from shared memory by
//     ldmatrix (.trans for V). mma.sync rather than wgmma was reasoned
//     from the shape, not measured (no wgmma variant of this kernel has
//     been built or timed): its 16-row A operand pads G = 48 to 48
//     (wgmma's 64-row one to 64) and G = 8 or 9 to 16 in one warp, and a
//     decode block holds a split of one or two tiles, which looked too
//     short to amortise wgmma's warpgroup fences and commit groups;
//   * the online softmax stays in f32 as in the FMA kernel, with the
//     m == -inf guard; Q is not scaled in bf16, the f32 scores take
//     log2(e)/sqrt(D) in the FMA that feeds exp2 (the running max kept in
//     log2 units, written out as m * ln 2 for the combine); P is rounded to
//     bf16 only as the PV operand (at most 2^-9 relative per p, the order
//     of the bf16 output cast); l sums the f32 p;
//   * each 64-row K and V tile is loaded by TMA (csrc/tma.cuh) into a
//     two-stage ring counted by an mbarrier, one thread issuing the copies:
//     the cache is a 4-D map (D, Hkv, S, B), so a box never runs into the
//     next batch row; rows are 128-byte swizzled images (D = 128 as two),
//     so ldmatrix's eight rows hit eight bank groups; D = 80's last 16
//     columns are a third image of 32-byte rows, swizzled to match. A partial last tile
//     (nv live rows) is loaded as the 64 rows that end at its last live
//     row, rows before the split masked (before row 0 TMA reads zeros):
//     no row at or past kv_len is read.
//
// The FMA kernel (f32; bf16 at D = 16, 32), per tile of 128
// rows in a block of 256 threads (a split is short, so a block's time is a
// chain of latencies; 8 warps hide more of it than 4):
//   * each tile's K and V rows are copied to shared memory as they are
//     stored (bf16 or f32) with 16-byte cp.async copies, each cache's
//     tile issued whole before it is waited on, and pipelined with no
//     second buffer: the next tile's K is copied while this tile's softmax
//     and PV run, its V while the next tile's scores run (a two-stage ring
//     of whole tiles, measured on the H100, was no faster: it halves the
//     blocks an SM holds). Rows are padded by 16 bytes, so the 16-byte
//     reads of neighbouring rows in the score phase hit distinct banks;
//   * scores: threads j and j + 128 own row j of the tile and compute its
//     dot products with alternate groups of 4 query heads (q pre-scaled in
//     f32 in shared memory, read as broadcast float4s);
//   * online softmax: one warp per query head takes the tile's max and
//     sum by shuffles; the running (m, l) and the tile's rescale live in
//     shared memory, and exp(m_old - m_new) is taken as 0 while m_old is
//     still -inf, so no NaN enters;
//   * PV: each thread owns four output columns of one query head, its loop
//     over the tile's rows unrolled by 4 so that shared-memory loads
//     overlap; when G*D/4 < 256 the rows are split across threads and the
//     partial sums are added in shared memory.
// The combine is one block per (query head, batch row): its threads read
// the splits' (m, l) at once and reduce M and l by shuffles, the weights
// go to shared memory, and each thread then sums one output column over
// the splits. With one split the weight is exp(0) = 1: the output is the
// one block's acc / max(l, 1e-30). With no live row (kv_len = 0, outside
// the contract) the output is 0.
// Built without --use_fast_math (IEEE expf and division).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kBK = 128;        // cache rows per tile
constexpr int kThreads = 256;   // two threads per tile row in the scores
constexpr int kGC = 4;          // query heads per pass of the score phase
constexpr size_t kMaxSmem = 232448;   // 227 KB, the most a block can use
// splits the combine takes: its (m, l) of each split in its 48 KB of
// default shared memory
constexpr int kMaxSplits = 4096;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// one 16-byte chunk of shared memory as f32: 4 floats or 8 bf16
__device__ __forceinline__ void chunk_f32(const float* p, float (&x)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void chunk_f32(const __nv_bfloat16* p,
                                          float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// elements of T in a padded cache row of shared memory (16 bytes of pad)
template <typename T>
__host__ __device__ constexpr int row_elems(int D) {
  return D + 16 / static_cast<int>(sizeof(T));
}

// shared memory of one split block, in bytes: f32 regions first (each a
// multiple of 16 bytes), then the K and V tiles, then the per-head stats
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int G, int D) {
  return 4 * (2 * static_cast<size_t>(G) * D          // Qs, Acc
              + static_cast<size_t>(G) * kBK           // Ss
              + 4 * static_cast<size_t>(kThreads)      // Red (float4 each)
              + 3 * static_cast<size_t>(G))            // Ms, Ls, As
       + 2 * static_cast<size_t>(kBK) * row_elems<T>(D) * sizeof(T);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int B, int S, int Hq,
                    int Hkv, float scale, int rows_per_split) {
  extern __shared__ float4 smem4[];
  constexpr int VE = 16 / sizeof(T);       // elements per 16-byte chunk
  constexpr int RS = row_elems<T>(D);      // padded row, in elements
  constexpr int CH = D / VE;               // chunks per row
  constexpr int D4 = D / 4;
  const int G = Hq / Hkv;
  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float* Qs = reinterpret_cast<float*>(smem4);  // G x D, pre-scaled
  float* Acc = Qs + G * D;                       // G x D
  float* Ss = Acc + G * D;                       // G x kBK: scores, then p
  float4* Red = reinterpret_cast<float4*>(Ss + G * kBK);  // kThreads partials
  T* Ks = reinterpret_cast<T*>(Red + kThreads);  // kBK x RS
  T* Vs = Ks + kBK * RS;                         // kBK x RS
  float* Ms = reinterpret_cast<float*>(Vs + kBK * RS);  // G running max
  float* Ls = Ms + G;                                    // G running sum
  float* As = Ls + G;                                    // G tile rescale

  const int n = min(max(kv_len[b], 0), S);
  const int r0 = split * rows_per_split;
  const int r1 = min(r0 + rows_per_split, n);
  // partials of this block's G heads: index (split, b, hk * G + g)
  const int64_t p0 = (static_cast<int64_t>(split) * B + b) * Hq +
                     static_cast<int64_t>(hk) * G;
  if (r0 >= r1) {                                // no live row in this split
    for (int g = tid; g < G; g += kThreads) {
      part_m[p0 + g] = -INFINITY;
      part_l[p0 + g] = 0.0f;
    }
    float4* pa = reinterpret_cast<float4*>(part_acc + p0 * D);
    for (int i = tid; i < G * D4; i += kThreads)
      pa[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }

  const int64_t row = static_cast<int64_t>(Hkv) * D;    // per cache row
  const int64_t kv_off = static_cast<int64_t>(b) * S * row +
                         static_cast<int64_t>(hk) * D;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;
  const int64_t q_off = (static_cast<int64_t>(b) * Hq +
                         static_cast<int64_t>(hk) * G) * D;

  for (int i = tid; i < G * D4; i += kThreads) {
    float4 x = load4(q + q_off + 4 * i);
    x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    reinterpret_cast<float4*>(Qs)[i] = x;
    reinterpret_cast<float4*>(Acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = -INFINITY;
    Ls[g] = 0.0f;
  }

  const int NI = G * D4;                      // float4 output items
  // row split of the PV phase; any count works (at D = 80, G = 1: 20
  // items x 12 splits, 240 of 256 threads), Red holds NI * nsplit <= kThreads
  const int nsplit = max(1, kThreads / NI);

  // the live rows of the tile at row k0 of one cache into its tile buffer,
  // as one cp.async group
  auto issue = [&](const T* src, T* dst, int k0) {
    const int nv = min(kBK, r1 - k0);
    for (int i = tid; i < nv * CH; i += kThreads) {
      const int r = i / CH, c = i - r * CH;
      cp_async16(dst + r * RS + c * VE,
                 src + static_cast<int64_t>(k0 + r) * row + c * VE);
    }
    cp_async_commit();
  };
  issue(kb, Ks, r0);
  issue(vb, Vs, r0);

  // software pipeline over the tiles: K of the next tile loads during this
  // tile's softmax and PV, V of the next tile during its scores and softmax
  for (int k0 = r0; k0 < r1; k0 += kBK) {
    const int nv = min(kBK, r1 - k0);         // live rows of this tile
    const bool more = k0 + kBK < r1;
    cp_async_wait<1>();                       // this tile's K (V may pend)
    __syncthreads();

    const int rr = tid % kBK, hh = tid / kBK;   // row; first head group
    if (rr < nv) {
      const T* kr = Ks + rr * RS;
      for (int g0 = hh * kGC; g0 < G; g0 += (kThreads / kBK) * kGC) {
        float s[kGC];
#pragma unroll
        for (int gg = 0; gg < kGC; ++gg) s[gg] = 0.0f;
        for (int c = 0; c < CH; ++c) {
          float kk[VE];
          chunk_f32(kr + c * VE, kk);
#pragma unroll
          for (int gg = 0; gg < kGC; ++gg) {
            if (g0 + gg < G) {
              const float4* qq =
                  reinterpret_cast<const float4*>(Qs + (g0 + gg) * D + c * VE);
              float a = s[gg];
#pragma unroll
              for (int e4 = 0; e4 < VE / 4; ++e4) {
                const float4 qv = qq[e4];
                a = fmaf(qv.x, kk[4 * e4 + 0], a);
                a = fmaf(qv.y, kk[4 * e4 + 1], a);
                a = fmaf(qv.z, kk[4 * e4 + 2], a);
                a = fmaf(qv.w, kk[4 * e4 + 3], a);
              }
              s[gg] = a;
            }
          }
        }
#pragma unroll
        for (int gg = 0; gg < kGC; ++gg)
          if (g0 + gg < G) Ss[(g0 + gg) * kBK + rr] = s[gg];
      }
    }
    __syncthreads();                          // K consumed
    if (more) issue(kb, Ks, k0 + kBK);

    for (int g = warp; g < G; g += kThreads / 32) {
      float* sr = Ss + g * kBK;
      float tmax = -INFINITY;
      for (int j = lane; j < nv; j += 32) tmax = fmaxf(tmax, sr[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, tmax);
      const float alpha = (m_old == -INFINITY) ? 0.0f : expf(m_old - m_new);
      float psum = 0.0f;
      for (int j = lane; j < nv; j += 32) {
        const float p = expf(sr[j] - m_new);
        sr[j] = p;
        psum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      if (lane == 0) {
        Ms[g] = m_new;
        Ls[g] = Ls[g] * alpha + psum;
        As[g] = alpha;
      }
    }
    if (more) {
      cp_async_wait<1>();                     // this tile's V (next K pends)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    for (int it = tid; it < NI * nsplit; it += kThreads) {
      const int item = it % NI, sp = it / NI;
      const int g = item / D4, c = item - g * D4;
      const float* pr = Ss + g * kBK;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int j = sp; j < nv; j += nsplit) {
        const float p = pr[j];
        const float4 vv = load4(Vs + j * RS + 4 * c);
        a.x = fmaf(p, vv.x, a.x);
        a.y = fmaf(p, vv.y, a.y);
        a.z = fmaf(p, vv.z, a.z);
        a.w = fmaf(p, vv.w, a.w);
      }
      if (nsplit == 1) {
        float4* acc = reinterpret_cast<float4*>(Acc) + item;
        const float al = As[g];
        float4 o = *acc;
        o.x = o.x * al + a.x;
        o.y = o.y * al + a.y;
        o.z = o.z * al + a.z;
        o.w = o.w * al + a.w;
        *acc = o;
      } else {
        Red[it] = a;
      }
    }
    __syncthreads();                          // V consumed
    if (more) issue(vb, Vs, k0 + kBK);
    if (nsplit > 1) {
      for (int item = tid; item < NI; item += kThreads) {
        const int g = item / D4;
        float4 a = Red[item];
        for (int sp = 1; sp < nsplit; ++sp) {
          const float4 r = Red[sp * NI + item];
          a.x += r.x; a.y += r.y; a.z += r.z; a.w += r.w;
        }
        float4* acc = reinterpret_cast<float4*>(Acc) + item;
        const float al = As[g];
        float4 o = *acc;
        o.x = o.x * al + a.x;
        o.y = o.y * al + a.y;
        o.z = o.z * al + a.z;
        o.w = o.w * al + a.w;
        *acc = o;
      }
    }
  }
  __syncthreads();

  float4* pa = reinterpret_cast<float4*>(part_acc + p0 * D);
  for (int i = tid; i < G * D4; i += kThreads)
    pa[i] = reinterpret_cast<const float4*>(Acc)[i];
  for (int g = tid; g < G; g += kThreads) {
    part_m[p0 + g] = Ms[g];
    part_l[p0 + g] = Ls[g];
  }
}

// one block per (query head, batch row), one thread per output column;
// shared memory: the splits' weights, their l, and 64 floats of scratch
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ out, int B, int Hq,
                                      int D, int splits) {
  extern __shared__ float W[];
  float* Lw = W + splits;
  float* red = Lw + splits;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int64_t base = static_cast<int64_t>(b) * Hq + h;
  const int64_t stride = static_cast<int64_t>(B) * Hq;
  float M = -INFINITY;
  for (int s = tid; s < splits; s += blockDim.x) {
    const float m = part_m[s * stride + base];
    W[s] = m;
    Lw[s] = part_l[s * stride + base];
    M = fmaxf(M, m);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  if (lane == 0) red[warp] = M;
  __syncthreads();
  M = red[0];
  for (int w = 1; w < nw; ++w) M = fmaxf(M, red[w]);
  float l = 0.0f;
  for (int s = tid; s < splits; s += blockDim.x) {
    const float m = W[s];
    const float w = (m == -INFINITY) ? 0.0f : expf(m - M);
    W[s] = w;
    l += Lw[s] * w;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    l += __shfl_xor_sync(0xffffffffu, l, o);
  if (lane == 0) red[32 + warp] = l;
  __syncthreads();
  l = 0.0f;
  for (int w = 0; w < nw; ++w) l += red[32 + w];
  for (int d = tid; d < D; d += blockDim.x) {
    float acc = 0.0f;
#pragma unroll 4
    for (int s = 0; s < splits; ++s)
      acc = fmaf(part_acc[(s * stride + base) * D + d], W[s], acc);
    out[base * D + d] =
        from_f32<T>(M == -INFINITY ? 0.0f : acc / fmaxf(l, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// bf16 at D = 64, 80, 128: the tensor-core split kernel
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 64;     // cache rows per tile
constexpr int kMmaMaxGroup = 64; // query heads a block takes (4 warps x 16)

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// shared memory of one tensor-core split block: `stages` x (K tile, V tile),
// each tile D / 64 images of 64 rows x 128 bytes and, at D = 80, one of
// 64 rows x 32 bytes, and 1 KB of alignment
__host__ __device__ constexpr size_t mma_smem_bytes(int D, int stages) {
  return static_cast<size_t>(stages) * 2 *
             ((D / 64) * kMmaRows * 128 + (D % 64) * 2 * kMmaRows) +
         1024;
}

// One block of ceil(G / 16) warps per (split, KV head, batch row); warp w
// owns query heads 16w .. 16w + 15 of the group as the 16 rows of its
// mma.sync A operand (rows past G are zero and never written).
template <int D>
__global__ void __launch_bounds__(128)
decode_split_mma_kernel(const __grid_constant__ CUtensorMap tmk,
                        const __grid_constant__ CUtensorMap tmv,
                        const __grid_constant__ CUtensorMap tmk1,
                        const __grid_constant__ CUtensorMap tmv1,
                        const __nv_bfloat16* __restrict__ q,
                        const int* __restrict__ kv_len,
                        float* __restrict__ part_m, float* __restrict__ part_l,
                        float* __restrict__ part_acc, int B, int S, int Hq,
                        int Hkv, float scale_log2, int rows_per_split) {
  using repro_tma::mbar_wait;
  using repro_tma::smem_u32;
  using repro_tma::swizzle_offset;
  constexpr int NA = D / 64;             // 128-byte images per row
  constexpr int IMG = kMmaRows * 128;    // one such image of a tile
  constexpr int W1 = D % 64;             // D = 80: 16 more columns, an
  constexpr int IMG1 = kMmaRows * W1 * 2;  // image of 32-byte rows
  constexpr int TILE = NA * IMG + IMG1;  // one cache's tile
  constexpr int KS = D / 16;             // k-steps of QK^T
  constexpr int NB = D / 8;              // 8-column blocks of the output
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[2];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int G = Hq / Hkv;
  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n = min(max(kv_len[b], 0), S);
  const int r0 = split * rows_per_split;
  const int r1 = min(r0 + rows_per_split, n);
  const int64_t p0 = (static_cast<int64_t>(split) * B + b) * Hq +
                     static_cast<int64_t>(hk) * G;
  if (r0 >= r1) {                                // no live row in this split
    for (int g = tid; g < G; g += blockDim.x) {
      part_m[p0 + g] = -INFINITY;
      part_l[p0 + g] = 0.0f;
    }
    float4* pa = reinterpret_cast<float4*>(part_acc + p0 * D);
    for (int i = tid; i < G * D / 4; i += blockDim.x)
      pa[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int n_t = (r1 - r0 + kMmaRows - 1) / kMmaRows;

  if (tid == 0) {
    repro_tma::mbar_init(&full[0], 1);
    repro_tma::mbar_init(&full[1], 1);
    repro_tma::mbar_fence_init();
  }
  __syncthreads();

  // tile t of the split into stage t % 2: a whole tile at its first row,
  // a partial last tile (nv < 64 live rows) as the 64 rows ending at r1,
  // so that no row at or past kv_len is read; rows before the split's
  // start (live, or zero-filled before row 0) are masked
  auto issue = [&](int t) {
    const int s = t & 1;
    const int k0 = r0 + t * kMmaRows;
    const int row = (r1 - k0 >= kMmaRows) ? k0 : r1 - kMmaRows;
    unsigned char* ks = base + s * 2 * TILE;
    repro_tma::mbar_expect_tx(&full[s], 2 * TILE);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      repro_tma::tma_load_4d(ks + a * IMG, &tmk, &full[s], 64 * a, hk, row, b);
      repro_tma::tma_load_4d(ks + TILE + a * IMG, &tmv, &full[s], 64 * a, hk,
                             row, b);
    }
    if (W1) {
      repro_tma::tma_load_4d(ks + NA * IMG, &tmk1, &full[s], 64 * NA, hk,
                             row, b);
      repro_tma::tma_load_4d(ks + TILE + NA * IMG, &tmv1, &full[s], 64 * NA,
                             hk, row, b);
    }
  };
  if (tid == 0) {
    issue(0);
    if (n_t > 1) issue(1);
  }

  // Q fragments straight from device memory: rows g and g + 8 of the
  // warp's 16 heads, bf16 pairs as mma.sync's A layout (never scaled in
  // bf16: the scale enters the f32 scores)
  const int g = lane >> 2, tg = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;       // ldmatrix: matrix, row
  const int h0 = 16 * warp + g, h1 = h0 + 8;
  const uint32_t* qw = reinterpret_cast<const uint32_t*>(
      q + (static_cast<int64_t>(b) * Hq + static_cast<int64_t>(hk) * G) * D);
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = (kk * 16 + 2 * tg) / 2;        // in bf16 pairs
    qf[kk][0] = h0 < G ? qw[h0 * (D / 2) + c] : 0u;
    qf[kk][1] = h1 < G ? qw[h1 * (D / 2) + c] : 0u;
    qf[kk][2] = h0 < G ? qw[h0 * (D / 2) + c + 4] : 0u;
    qf[kk][3] = h1 < G ? qw[h1 * (D / 2) + c + 4] : 0u;
  }
  float o[NB][4];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.0f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.0f, 0.0f};

  for (int t = 0; t < n_t; ++t) {
    const int s = t & 1;
    const int k0 = r0 + t * kMmaRows;
    const int shift = kMmaRows - min(kMmaRows, r1 - k0);  // masked rows
    const uint32_t ks = smem_u32(base + s * 2 * TILE);
    const uint32_t vs = ks + TILE;
    mbar_wait(&full[s], (t >> 1) & 1);

    // S = Q K^T: 16 heads x 64 rows per warp, eight 16x8 blocks
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];   // rows np*16 + 0-7 and + 8-15, d kk*16 + 0-15
        const int r = np * 16 + (mi >> 1) * 8 + mr;
        ldsm_x4(bk, kk < 4 * NA
                        ? ks + (kk / 4) * IMG +
                              swizzle_offset<128>(r, (kk % 4) * 32 +
                                                         (mi & 1) * 16)
                        : ks + NA * IMG +
                              swizzle_offset<32>(r, (mi & 1) * 16));
        mma_bf16(sc[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }
    if (shift) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * 8 + 2 * tg + (e & 1) < shift) sc[j][e] = -INFINITY;
    }

    // online softmax in f32 for heads h0 (e = 0, 1) and h1 (e = 2, 3):
    // the running max kept scaled (log2 units), p = 2^(s * scale_log2 - m)
    float alpha[2], mbase[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx * scale_log2);
      alpha[r] = (m_r[r] == -INFINITY) ? 0.0f : exp2f(m_r[r] - m_new);
      mbase[r] = (m_new == -INFINITY) ? 0.0f : m_new;
      m_r[r] = m_new;
    }
    float psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(sc[j][e], scale_log2, -mbase[e >> 1]));
        sc[j][e] = p;
        psum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + psum[r];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += P V: P from the score registers, rounded to bf16
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kt][0], sc[2 * kt][1]);
      pa[1] = pack_bf16(sc[2 * kt][2], sc[2 * kt][3]);
      pa[2] = pack_bf16(sc[2 * kt + 1][0], sc[2 * kt + 1][1]);
      pa[3] = pack_bf16(sc[2 * kt + 1][2], sc[2 * kt + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];   // rows kt*16 + 0-15, d dp*16 + 0-7 and + 8-15
        const int r = kt * 16 + (mi & 1) * 8 + mr;
        ldsm_x4_trans(bv, dp < 4 * NA
                              ? vs + (dp / 4) * IMG +
                                    swizzle_offset<128>(r, (dp % 4) * 32 +
                                                               (mi >> 1) * 16)
                              : vs + NA * IMG +
                                    swizzle_offset<32>(r, (mi >> 1) * 16));
        mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();                              // stage s consumed
    if (tid == 0 && t + 2 < n_t) issue(t + 2);
  }

  // partials: m back in natural-log units for the combine
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int head = r ? h1 : h0;
    if (head < G) {
      if (tg == 0) {
        part_m[p0 + head] = m_r[r] * 0.69314718055994531f;
        part_l[p0 + head] = l;
      }
      float* pa = part_acc + (p0 + head) * D;
#pragma unroll
      for (int i = 0; i < NB; ++i)
        *reinterpret_cast<float2*>(pa + i * 8 + 2 * tg) =
            make_float2(o[i][2 * r], o[i][2 * r + 1]);
    }
  }
}

// the combine of every launch: one block per (query head, batch row)
template <typename T>
int combine(const float* part, void* out, int B, int Hq, int D, int splits,
            cudaStream_t stream) {
  const size_t heads = static_cast<size_t>(splits) * B * Hq;
  const float* part_m = part + heads * D;
  const float* part_l = part_m + heads;
  const int threads = (D + 31) / 32 * 32;
  decode_combine_kernel<T><<<dim3(Hq, B), threads,
                             (2 * splits + 64) * sizeof(float), stream>>>(
      part_m, part_l, part, static_cast<T*>(out), B, Hq, D, splits);
  return cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* out, float* part, int B, int S, int Hq, int Hkv, float scale,
           int splits, int rows_per_split, cudaStream_t stream) {
  if (rows_per_split % kBK != 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(Hq / Hkv, D);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static size_t configured = 0;   // per instantiation and process
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  const size_t heads = static_cast<size_t>(splits) * B * Hq;
  float* part_acc = part;               // heads x D, 16-byte aligned
  float* part_m = part + heads * D;     // heads
  float* part_l = part_m + heads;       // heads
  dim3 grid(splits, Hkv, B);
  decode_split_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, part_m, part_l, part_acc, B, S, Hq,
      Hkv, scale, rows_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return combine<T>(part, out, B, Hq, D, splits, stream);
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v,
               const int* kv_len, void* out, float* part, int B, int S,
               int Hq, int Hkv, float scale, int splits, int rows_per_split,
               cudaStream_t stream) {
  const int G = Hq / Hkv;
  if (G > kMmaMaxGroup || rows_per_split % kMmaRows != 0)
    return cudaErrorInvalidValue;
  const int w1 = D % 64 ? D % 64 : 64;   // D = 80's last 16 columns
  CUtensorMap mk, mv, mk1, mv1;
  if (!repro_tma::bf16_map(&mk, k, B, S, Hkv, D, kMmaRows, 64) ||
      !repro_tma::bf16_map(&mv, v, B, S, Hkv, D, kMmaRows, 64) ||
      !repro_tma::bf16_map(&mk1, k, B, S, Hkv, D, kMmaRows, w1) ||
      !repro_tma::bf16_map(&mv1, v, B, S, Hkv, D, kMmaRows, w1))
    return cudaErrorInvalidValue;
  const size_t smem = mma_smem_bytes(D, rows_per_split > kMmaRows ? 2 : 1);
  static size_t configured = 0;   // per instantiation and process
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_split_mma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  const size_t heads = static_cast<size_t>(splits) * B * Hq;
  float* part_m = part + heads * D;
  float* part_l = part_m + heads;
  dim3 grid(splits, Hkv, B);
  decode_split_mma_kernel<D><<<grid, 32 * ((G + 15) / 16), smem, stream>>>(
      mk, mv, mk1, mv1, static_cast<const __nv_bfloat16*>(q), kv_len, part_m,
      part_l, part, B, S, Hq, Hkv, scale * 1.4426950408889634f,
      rows_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return combine<__nv_bfloat16>(part, out, B, Hq, D, splits, stream);
}

// kernel codes of the wrapper (`kernels/decode_attention.py` `KERNELS`)
enum Kernel { kFma = 0, kMma = 1 };

int launch_k(int kernel, int dtype, int D, const void* q, const void* k,
             const void* v, const int* kv_len, void* out, float* part, int B,
             int S, int Hq, int Hkv, float scale, int splits, int rows,
             cudaStream_t s) {
#define REPRO_ARGS q, k, v, kv_len, out, part, B, S, Hq, Hkv, scale, splits, \
                   rows, s
  if (kernel == kMma) {
    if (dtype != 1) return cudaErrorInvalidValue;
    switch (D) {
      case 64: return launch_mma<64>(REPRO_ARGS);
      case 80: return launch_mma<80>(REPRO_ARGS);
      case 128: return launch_mma<128>(REPRO_ARGS);
    }
    return cudaErrorInvalidValue;
  }
  if (kernel != kFma) return cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (D) {
      case 16: return launch<float, 16>(REPRO_ARGS);
      case 32: return launch<float, 32>(REPRO_ARGS);
      case 64: return launch<float, 64>(REPRO_ARGS);
      case 80: return launch<float, 80>(REPRO_ARGS);
      case 128: return launch<float, 128>(REPRO_ARGS);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: return launch<__nv_bfloat16, 16>(REPRO_ARGS);
      case 32: return launch<__nv_bfloat16, 32>(REPRO_ARGS);
    }
  }
#undef REPRO_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// kernel: 0 = the FP32-FMA split kernel (f32; bf16 at D 16 or 32), 1 = the
// tensor-core split kernel (bf16, D 64, 80 or 128, Hq / Hkv <= 64). dtype: 0 = float32,
// 1 = bfloat16. q (B, Hq, D) and the caches (B, S, Hkv, D) contiguous and
// 16-byte aligned; kv_len (B,) int32 on the device. D in {16, 32, 64, 80,
// 128}; Hq % Hkv == 0. part: 16-byte aligned f32 scratch of splits * B *
// Hq * (D + 2) floats (acc, then m, then l); at most 4096 splits of
// rows_per_split rows (a multiple of the kernel's tile: 128 rows for the
// FMA kernel, 64 for the tensor-core one) cover [0, S).
// Launches the split kernel and the combine. Returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments the kernels do not take, among them
// a group Hq / Hkv too large for one block, or a tensor map
// cuTensorMapEncodeTiled refuses).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* kv_len, void* out, void* part, int B,
                            int S, int Hq, int Hkv, int D, int dtype,
                            float scale, int splits, int rows_per_split,
                            int kernel, void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (S <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  if (splits <= 0 || splits > kMaxSplits || B > 65535 || Hkv > 65535 ||
      rows_per_split <= 0 ||
      static_cast<int64_t>(splits) * rows_per_split < S)
    return cudaErrorInvalidValue;
  return launch_k(kernel, dtype, D, q, k, v, static_cast<const int*>(kv_len),
                  out, static_cast<float*>(part), B, S, Hq, Hkv, scale,
                  splits, rows_per_split, static_cast<cudaStream_t>(stream));
}

// dynamic shared memory of one split block, in bytes: the FMA kernel at
// group G (0 for a group too large for one block), the tensor-core kernel
// with one tile of 64 rows per split or more
int decode_attention_smem_bytes(int kernel, int dtype, int D, int G,
                                int rows_per_split) {
  if (kernel == kMma)
    return static_cast<int>(
        mma_smem_bytes(D, rows_per_split > kMmaRows ? 2 : 1));
  const size_t s = dtype == 0 ? smem_bytes<float>(G, D)
                              : smem_bytes<__nv_bfloat16>(G, D);
  return s > kMaxSmem ? 0 : static_cast<int>(s);
}

}  // extern "C"
