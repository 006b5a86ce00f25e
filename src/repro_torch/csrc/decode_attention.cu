// One-token GQA decode attention over a KV cache, split across blocks
// along the cache (flash-decoding), with an online softmax.
//
// Replaces the Pallas TPU kernel `decode_attention` / `_decode_kernel` of
// src/repro/kernels/decode_attention.py: q (B, Hq, D), cache_k and cache_v
// (B, S, Hkv, D) in bf16 or f32, kv_len (B,) int32, output (B, Hq, D) in
// q's dtype. Query head h attends over cache rows 0 .. kv_len[b]-1 of KV
// head h / G, G = Hq / Hkv, with q scaled by 1/sqrt(D) in f32 before the
// dot products, as in the reference kernel.
//
// What bounds it on the H100: memory. Each live cache row is read once and
// used for 2*G*D multiply-adds, about G/2 FLOP per byte in bf16, far under
// the card's ~295 FLOP per byte. So the design is about bytes, and about
// keeping enough of them in flight:
//   * GQA is an index, never a copy: one block serves all G query heads of
//     its KV head, so each K/V row is read from device memory once (the TPU
//     grid runs one step per query head and streams the KV block G times);
//   * only live rows are read: a block stops at kv_len[b] and the last tile
//     loads only its live rows. The TPU kernel streams the whole capacity
//     and masks it. Rows past kv_len are never touched, so any capacity S
//     works (the TPU kernel asserted S % blk_k == 0);
//   * kv_len is read on the device, clamped to [0, S]; the host never
//     syncs on it;
//   * one block per (KV head, batch row) would run only B*Hkv blocks (16
//     for TinyLlama at B = 4) on 132 SMs, each walking ~17 tiles in
//     series, and leave the card mostly idle. So the cache rows of each
//     (KV head, batch row) are split across blocks: grid (splits, Hkv, B),
//     each split a whole number of 128-row tiles, planned on the host from
//     the capacity S, B and Hkv (never from kv_len) to aim at 8 blocks per
//     SM where S allows (`kernels/decode_attention.py`, `split_plan`).
//     Each block writes its partial (m, l, acc[G, D]) in f32 to scratch; a
//     second kernel rescales the partials by exp(m_i - M) and writes
//     acc / max(l, 1e-30). A split that starts at or past kv_len[b] writes
//     m = -inf, l = 0 and acc = 0 and reads no row; its weight in the
//     combine is 0. Split 0 holds row 0, so with kv_len >= 1 (the
//     contract) M is finite;
//   * each tile's K and V rows are copied to shared memory as they are
//     stored (bf16 or f32) with 16-byte cp.async copies, each cache's
//     tile issued whole before it is waited on, and pipelined with no
//     second buffer: the next tile's K is copied while this tile's softmax
//     and PV run, its V while the next tile's scores run (a two-stage ring
//     of whole tiles, measured on the H100, was no faster: it halves the
//     blocks an SM holds). Rows are padded by 16 bytes, so the 16-byte
//     reads of neighbouring rows in the score phase hit distinct banks.
//
// Per tile, in a block of 256 threads (a split is short, so a block's time
// is a chain of latencies; 8 warps hide more of it than 4, and the PV
// phase below gets twice the threads):
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* out, float* part, int B, int S, int Hq, int Hkv, float scale,
           int splits, int rows_per_split, cudaStream_t stream) {
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
  const int threads = (D + 31) / 32 * 32;
  decode_combine_kernel<T><<<dim3(Hq, B), threads,
                             (2 * splits + 64) * sizeof(float), stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), B, Hq, D, splits);
  return cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const int* kv_len, void* out, float* part, int B, int S, int Hq,
             int Hkv, float scale, int splits, int rows, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, kv_len, out, part, B, S, Hq, Hkv, scale, splits, rows, s);
    case 32: return launch<T, 32>(q, k, v, kv_len, out, part, B, S, Hq, Hkv, scale, splits, rows, s);
    case 64: return launch<T, 64>(q, k, v, kv_len, out, part, B, S, Hq, Hkv, scale, splits, rows, s);
    case 80: return launch<T, 80>(q, k, v, kv_len, out, part, B, S, Hq, Hkv, scale, splits, rows, s);
    case 128: return launch<T, 128>(q, k, v, kv_len, out, part, B, S, Hq, Hkv, scale, splits, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16. q (B, Hq, D) and the caches
// (B, S, Hkv, D) contiguous and 16-byte aligned; kv_len (B,) int32 on the
// device. D in {16, 32, 64, 80, 128}; Hq % Hkv == 0. part: 16-byte aligned
// f32 scratch of splits * B * Hq * (D + 2) floats (acc, then m, then l);
// at most 4096 splits of rows_per_split rows (a multiple of 128) cover
// [0, S).
// Launches the split kernel and the combine. Returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments the kernels do not take, among them
// a group Hq / Hkv too large for one block's shared memory).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* kv_len, void* out, void* part, int B,
                            int S, int Hq, int Hkv, int D, int dtype,
                            float scale, int splits, int rows_per_split,
                            void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (S <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  if (splits <= 0 || splits > kMaxSplits || B > 65535 || Hkv > 65535 ||
      rows_per_split <= 0 || rows_per_split % kBK != 0 ||
      static_cast<int64_t>(splits) * rows_per_split < S)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(kv_len);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, len, out, p, B, S, Hq, Hkv, scale,
                           splits, rows_per_split, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, len, out, p, B, S, Hq, Hkv,
                                   scale, splits, rows_per_split, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
