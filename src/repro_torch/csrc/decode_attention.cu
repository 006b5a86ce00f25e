// One-token GQA decode attention over a KV cache, with an online softmax.
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
// the card's ~295 FLOP per byte. So the design is about bytes:
//   * GQA is an index, never a copy: one block per (KV head, batch row)
//     serves all G query heads of that KV head, so each K/V row is read
//     from device memory once (the TPU grid runs one step per query head
//     and streams the KV block G times);
//   * only live rows are read: the tile loop stops at kv_len[b] and the
//     last tile loads only its live rows. The TPU kernel streams the whole
//     capacity and masks it. Rows past kv_len are never touched, so any
//     capacity S works (the TPU kernel asserted S % blk_k == 0);
//   * kv_len is read on the device, clamped to [0, S]; the host never
//     syncs on it.
// This first version is simple, not fast: one block per (KV head, batch)
// runs only B*Hkv blocks (80 for GPT-2 Large at B = 4, 16 for TinyLlama)
// against 132 SMs, one block of 4 warps per SM, which leaves little to
// hide each tile's memory and shared-memory latency behind; each block
// loads a tile, then computes on it, with no copy in flight during the
// compute. (Holding 8 loads of K and 8 of V in flight per thread before
// storing them made it slower on the H100, so the load is the plain
// loop.) Splitting the sequence across blocks (flash-decoding) and
// overlapping the loads with the compute are later work.
//
// Design, per block of 128 threads:
//   * a tile of 128 cache rows of K and V is converted to f32 in shared
//     memory (rows padded to D+4 floats, so float4 reads of neighbouring
//     rows hit distinct banks); bf16 goes through __bfloat1622float2;
//   * scores: thread j owns row j of the tile and computes its dot product
//     with every query head (q pre-scaled in shared memory, read as
//     broadcast float4s), 8 heads per pass;
//   * online softmax: one warp per query head takes the tile's max and
//     sum by shuffles; the running (m, l) and the tile's rescale live in
//     shared memory, and exp(m_old - m_new) is taken as 0 while m_old is
//     still -inf, so no NaN enters;
//   * PV: each thread owns four output columns of one query head; when
//     G*D/4 < 128 the tile's rows are split across threads and the partial
//     sums are added in shared memory;
//   * the output is acc / max(l, 1e-30) in q's dtype; with no live row
//     (kv_len = 0, outside the contract) it is 0.
// Built without --use_fast_math (IEEE expf and division).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBK = 128;        // cache rows per tile
constexpr int kThreads = 128;   // one thread per tile row in the score phase
constexpr int kGC = 8;          // query heads per pass of the score phase
constexpr size_t kMaxSmem = 232448;   // 227 KB, the most a block can use

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// shared memory of one block, in floats (every region a multiple of 4)
__host__ __device__ constexpr size_t smem_floats(int G, int D) {
  return 2 * static_cast<size_t>(G) * D            // Qs, Acc
       + 2 * static_cast<size_t>(kBK) * (D + 4)     // Ks, Vs
       + static_cast<size_t>(G) * kBK               // Ss
       + 4 * static_cast<size_t>(kThreads)          // Red (float4 each)
       + 3 * static_cast<size_t>(G);                // Ms, Ls, As
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ kv_len,
              T* __restrict__ out, int S, int Hq, int Hkv, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int DP = D + 4;
  constexpr int D4 = D / 4;
  const int G = Hq / Hkv;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float* Qs = reinterpret_cast<float*>(smem4);  // G x D, pre-scaled
  float* Ks = Qs + G * D;                        // kBK x DP
  float* Vs = Ks + kBK * DP;                     // kBK x DP
  float* Ss = Vs + kBK * DP;                     // G x kBK: scores, then p
  float* Acc = Ss + G * kBK;                     // G x D
  float4* Red = reinterpret_cast<float4*>(Acc + G * D);  // kThreads partials
  float* Ms = reinterpret_cast<float*>(Red + kThreads);  // G running max
  float* Ls = Ms + G;                                    // G running sum
  float* As = Ls + G;                                    // G tile rescale

  const int n = min(max(kv_len[b], 0), S);
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
  // items x 6 splits, 120 of 128 threads), Red holds NI * nsplit <= kThreads
  const int nsplit = max(1, kThreads / NI);

  for (int k0 = 0; k0 < n; k0 += kBK) {
    const int nv = min(kBK, n - k0);          // live rows of this tile
    __syncthreads();                          // previous tile consumed
    for (int i = tid; i < nv * D4; i += kThreads) {
      const int r = i / D4, c = i - r * D4;
      const int64_t off = static_cast<int64_t>(k0 + r) * row + 4 * c;
      *reinterpret_cast<float4*>(Ks + r * DP + 4 * c) = load4(kb + off);
      *reinterpret_cast<float4*>(Vs + r * DP + 4 * c) = load4(vb + off);
    }
    __syncthreads();

    if (tid < nv) {
      const float4* kr = reinterpret_cast<const float4*>(Ks + tid * DP);
      for (int g0 = 0; g0 < G; g0 += kGC) {
        float s[kGC];
#pragma unroll
        for (int gg = 0; gg < kGC; ++gg) s[gg] = 0.0f;
        for (int c = 0; c < D4; ++c) {
          const float4 kk = kr[c];
#pragma unroll
          for (int gg = 0; gg < kGC; ++gg) {
            if (g0 + gg < G) {
              const float4 qq =
                  reinterpret_cast<const float4*>(Qs + (g0 + gg) * D)[c];
              float a = s[gg];
              a = fmaf(qq.x, kk.x, a);
              a = fmaf(qq.y, kk.y, a);
              a = fmaf(qq.z, kk.z, a);
              a = fmaf(qq.w, kk.w, a);
              s[gg] = a;
            }
          }
        }
#pragma unroll
        for (int gg = 0; gg < kGC; ++gg)
          if (g0 + gg < G) Ss[(g0 + gg) * kBK + tid] = s[gg];
      }
    }
    __syncthreads();

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
    __syncthreads();

    for (int it = tid; it < NI * nsplit; it += kThreads) {
      const int item = it % NI, sp = it / NI;
      const int g = item / D4, c = item - g * D4;
      const float* pr = Ss + g * kBK;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = sp; j < nv; j += nsplit) {
        const float p = pr[j];
        const float4 vv = *reinterpret_cast<const float4*>(Vs + j * DP + 4 * c);
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
    if (nsplit > 1) {
      __syncthreads();
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

  T* ob = out + q_off;
  for (int i = tid; i < G * D4; i += kThreads) {
    const float den = fmaxf(Ls[i / D4], 1e-30f);
    const float4 a = reinterpret_cast<const float4*>(Acc)[i];
    ob[4 * i + 0] = from_f32<T>(a.x / den);
    ob[4 * i + 1] = from_f32<T>(a.y / den);
    ob[4 * i + 2] = from_f32<T>(a.z / den);
    ob[4 * i + 3] = from_f32<T>(a.w / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* out, int B, int S, int Hq, int Hkv, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats(Hq / Hkv, D) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static size_t configured = 0;   // per instantiation and process
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  dim3 grid(Hkv, B);
  decode_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(out), S, Hq, Hkv,
      scale);
  return cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const int* kv_len, void* out, int B, int S, int Hq, int Hkv,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, kv_len, out, B, S, Hq, Hkv, scale, stream);
    case 32: return launch<T, 32>(q, k, v, kv_len, out, B, S, Hq, Hkv, scale, stream);
    case 64: return launch<T, 64>(q, k, v, kv_len, out, B, S, Hq, Hkv, scale, stream);
    case 80: return launch<T, 80>(q, k, v, kv_len, out, B, S, Hq, Hkv, scale, stream);
    case 128: return launch<T, 128>(q, k, v, kv_len, out, B, S, Hq, Hkv, scale, stream);
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
// device. D in {16, 32, 64, 80, 128}; Hq % Hkv == 0. Returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments the kernel does not take, among them
// a group Hq / Hkv too large for one block's shared memory).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* kv_len, void* out, int B, int S,
                            int Hq, int Hkv, int D, int dtype, float scale,
                            void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (S <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(kv_len);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, len, out, B, S, Hq, Hkv, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, len, out, B, S, Hq, Hkv, scale, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
