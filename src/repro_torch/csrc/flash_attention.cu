// Blocked causal GQA flash attention with an online softmax.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` of
// src/repro/kernels/flash_attention.py: q (B, Sq, Hq, D), k and v
// (B, Sk, Hkv, D) in bf16 or f32, output (B, Sq, Hq, D) in q's dtype.
// Query head h reads KV head h / (Hq / Hkv): GQA is resolved by indexing,
// never by repeating KV. Causal masking aligns query and key positions at 0
// (key j is visible to query i iff j <= i), as the reference does.
//
// What bounds it on the H100: at the serving shapes (B = 1, Hq = Hkv = 20,
// D = 64, S up to a few hundred) attention is a small share of a stage's
// work and the kernel is bound by latency and by its own arithmetic, not by
// device memory: q, k, v and the output are read or written once (S*Hq*D
// elements each), while the scores never leave the SM. This first version
// computes QK^T and PV with FP32 FMAs from shared memory, not with tensor
// cores (wgmma / mma.sync are later work), so its arithmetic ceiling is the
// 67 TFLOP/s of FP32, not the 989 TFLOP/s of bf16 tensor cores.
//
// Design:
//   * one block of 128 threads per (query tile of 64 rows, query head,
//     batch); two threads per query row, each owning 32 of the tile's 64
//     keys for the scores and D/2 interleaved output columns for PV;
//   * K/V tiles of 64 keys are staged in shared memory as f32 (rows padded
//     to D+1 words against bank conflicts); the running (m, l, acc) of the
//     online softmax stay in f32 registers;
//   * q is scaled by 1/sqrt(D) in f32 before the QK^T product, as in the
//     reference kernel; the output is acc / max(l, 1e-30) cast to q's dtype;
//   * causal blocks loop over KV tiles only up to the tile's last query
//     row; the ragged tail (S not a multiple of 64) is masked in the
//     kernel, so any S works (the TPU kernel required S % block == 0);
//   * masked keys get probability exactly 0. Every row sees key 0 in its
//     first tile, so the running max is finite from the first tile on.
// Built without --use_fast_math (IEEE expf and division).
#include <cuda_bf16.h>
#include <math.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per KV tile
constexpr int kThreads = 128; // two threads per query row
constexpr int kHalfK = kBK / 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr int smem_floats() {
  // Q, K, V tiles at stride D+1, P tile at stride kBK+1
  return 3 * kBQ * (D + 1) + kBQ * (kBK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             int Sq, int Sk, int Hq, int Hkv, float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int DS = D + 1;
  constexpr int PS = kBK + 1;
  constexpr int DH = D / 2;
  float* Qs = smem;                 // kBQ x DS, pre-scaled
  float* Ks = Qs + kBQ * DS;        // kBK x DS
  float* Vs = Ks + kBK * DS;        // kBK x DS
  float* Ps = Vs + kBK * DS;        // kBQ x PS

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int row = tid >> 1;         // query row within the tile
  const int half = tid & 1;
  const int q0 = qt * kBQ;
  const int qrow = q0 + row;

  const int64_t q_stride = static_cast<int64_t>(Hq) * D;     // per position
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
  const T* qb = q + (static_cast<int64_t>(b) * Sq) * q_stride + static_cast<int64_t>(h) * D;
  const T* kb = k + (static_cast<int64_t>(b) * Sk) * kv_stride + static_cast<int64_t>(hk) * D;
  const T* vb = v + (static_cast<int64_t>(b) * Sk) * kv_stride + static_cast<int64_t>(hk) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, c = i - rr * D;
    const int pos = q0 + rr;
    Qs[rr * DS + c] = (pos < Sq) ? to_f32(qb[pos * q_stride + c]) * scale : 0.0f;
  }

  float m = -INFINITY, l = 0.0f;
  float acc[DH];
#pragma unroll
  for (int c = 0; c < DH; ++c) acc[c] = 0.0f;

  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) {
    const int last = min(q0 + kBQ, Sq) - 1;       // last real row of the tile
    n_tiles = min(n_tiles, last / kBK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                               // previous tile consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int rr = i / D, c = i - rr * D;
      const int pos = k0 + rr;
      const bool ok = pos < Sk;
      Ks[rr * DS + c] = ok ? to_f32(kb[pos * kv_stride + c]) : 0.0f;
      Vs[rr * DS + c] = ok ? to_f32(vb[pos * kv_stride + c]) : 0.0f;
    }
    __syncthreads();

    float sc[kHalfK];
#pragma unroll
    for (int j = 0; j < kHalfK; ++j) sc[j] = 0.0f;
    const float* qr = Qs + row * DS;
    for (int d = 0; d < D; ++d) {
      const float qv = qr[d];
#pragma unroll
      for (int j = 0; j < kHalfK; ++j) sc[j] += qv * Ks[(2 * j + half) * DS + d];
    }

    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kHalfK; ++j) {
      const int key = k0 + 2 * j + half;
      const bool vis = key < Sk && (!causal || key <= qrow);
      if (!vis) sc[j] = -INFINITY;
      tmax = fmaxf(tmax, sc[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = (m == -INFINITY) ? 0.0f : expf(m - m_new);
    float psum = 0.0f;
    float* pr = Ps + row * PS;
#pragma unroll
    for (int j = 0; j < kHalfK; ++j) {
      const float p = (sc[j] == -INFINITY) ? 0.0f : expf(sc[j] - m_new);
      psum += p;
      pr[2 * j + half] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();                                  // both halves' P written
#pragma unroll
    for (int c = 0; c < DH; ++c) acc[c] *= alpha;
    for (int j = 0; j < kBK; ++j) {
      const float p = pr[j];
      const float* vr = Vs + j * DS + half;
#pragma unroll
      for (int c = 0; c < DH; ++c) acc[c] += p * vr[2 * c];
    }
    __syncwarp();
  }

  if (qrow < Sq) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = out + (static_cast<int64_t>(b) * Sq + qrow) * q_stride + static_cast<int64_t>(h) * D;
#pragma unroll
    for (int c = 0; c < DH; ++c) orow[2 * c + half] = from_f32<T>(acc[c] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
           cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  static bool configured = false;   // once per instantiation and process
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, Hq, Hkv, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* out,
             int B, int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
             cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 80: return launch<T, 80>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16. Tensors contiguous in (B, S, H, D).
// D in {16, 32, 64, 80, 128}; Hq % Hkv == 0. Returns cudaGetLastError().
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                           int D, int dtype, float scale, int causal,
                           void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
