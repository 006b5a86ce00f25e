// Chunked Mamba2 SSD scan, one block per (batch row, SSM head).
//
// Replaces the Pallas TPU kernel `ssd_chunked` / `_ssd_kernel` of
// src/repro/kernels/ssd_chunk.py: x (B, S, H, P) f32, dt and la (B, S, H)
// f32 with the log-decay la <= 0, Bm and Cm (B, S, N) f32 shared by all
// heads (n_groups = 1), h0 (B, H, N, P) f32 -> y (B, S, H, P) f32 and the
// final state (B, H, N, P) f32. Per head, with state h (N x P),
//   h_t = exp(la_t) h_{t-1} + dt_t B_t x_t^T,   y_t = h_t^T C_t,
// taken chunk by chunk as in the reference, with cum the inclusive prefix
// sum of la along the chunk and dx = dt * x:
//   M[t, s] = (C_t . B_s) exp(cum_t - cum_s) for s <= t, else 0
//   y_t     = sum_s M[t, s] dx_s + exp(cum_t) (C_t . h)   (h before the chunk)
//   h      <- exp(cum_last) h + sum_s exp(cum_last - cum_s) B_s dx_s^T
// The D skip term and the gated RMSNorm stay in the model.
//
// Every exponent is <= 0, so nothing overflows at any decay strength: the
// prefix sums of la <= 0 are taken left to right in f32, a non-increasing
// sequence, so cum_t - cum_s (s <= t), cum_last - cum_s and cum_t are <= 0
// in floating point too; only s <= t is exponentiated (the TPU kernel takes
// exp over the whole (C, C) tile and masks it afterwards, where the upper
// triangle's exponent is positive and would overflow to inf, and inf * 0
// is NaN); and no exp(a - b) is split into exp(a) * exp(-b).
//
// What bounds it on the H100: at the engine's prefill shape (B = 4,
// S = 2048, H = 80, P = N = 64) the function must move 355.5 MB (x in, y
// out, dt, la, Bm, Cm, h0 and the final state), 0.106 ms at 3.35 TB/s,
// against three (64 x 64 x 64) products per (batch row, head, chunk) plus
// C . B^T once per (batch row, chunk), ~16.2 GFLOP, 0.24 ms at the
// 67 TFLOP/s FP32 peak: operations. This first version is simple, not
// fast: the products are FP32 FMAs from shared memory (no tensor cores),
// C . B^T is recomputed by each of the H heads of a batch row (as the TPU
// kernel does), each block loads a chunk and then computes on it with no
// load in flight, and the chunks of one head are a sequential loop (the
// state carries). Computing C . B^T once per (batch row, chunk), TF32 or
// bf16 tensor cores and overlapping the loads are later work.
//
// Design, per block of 256 threads, chunks of kC = 64 tokens (the TPU
// kernel's and the reference model's chunk):
//   * the N x P f32 state stays in shared memory for the whole sequence;
//   * the chunk's dx = dt * x (C x P), B and C (C x N, rows padded to N + 1
//     floats so the 16 rows a warp reads fall in distinct banks) and la are
//     loaded; tokens past S load as x = dt = la = 0 and B = C = 0, which
//     leaves the state unchanged, and their y is not stored, so any S works
//     (the TPU kernel asserts S % chunk == 0);
//   * thread t < C sums la[0..t] and la[0..C-1] left to right: every
//     thread's cum_last is the same sum, bit for bit, and cum is the
//     sequential prefix sum;
//   * thread (t-group, s-group) computes a 4 x 4 tile of M;
//   * thread (row group, 4 columns p) accumulates y for its rows and the new
//     state for its state rows in registers, reading the state from before
//     the update; after a barrier it writes the new state in place.
// Built without --use_fast_math (IEEE expf).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;          // tokens per chunk
constexpr int kThreads = 256;

template <int P, int N>
struct Smem {
  float st[N][P];             // state h: row n (state channel), column p
  float dx[kC][P];            // dt * x
  float Bc[kC][N + 1];
  float Cc[kC][N + 1];
  float M[kC][kC + 1];        // (C . B^T) * L, zero above the diagonal
  float la[kC];
  float cum[kC];              // inclusive prefix sum of la
  float ecum[kC];             // exp(cum_t)
  float rdec[kC];             // exp(cum_last - cum_t)
  float elast;                // exp(cum_last): the chunk's state decay
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ la, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, const float* __restrict__ h0,
                 float* __restrict__ y, float* __restrict__ hout, int S,
                 int H) {
  static_assert(P % 4 == 0 && kThreads % (P / 4) == 0, "P must be 16..128");
  constexpr int kTX = P / 4;                       // threads across columns
  constexpr int kTY = kThreads / kTX;              // threads across rows
  static_assert(kC % kTY == 0, "P too small for the row split");
  constexpr int kRY = kC / kTY;                    // y rows per thread
  constexpr int kRS = (N + kTY - 1) / kTY;         // state rows per thread
  extern __shared__ float4 smem4[];
  Smem<P, N>& sm = *reinterpret_cast<Smem<P, N>*>(smem4);

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;        // y / state phase
  const int mx = tid % 16, my = tid / 16;          // M phase: 4 x 4 tiles
  const size_t xrow = static_cast<size_t>(H) * P;  // x, y: between tokens
  const size_t xbase = (static_cast<size_t>(b) * S * H + h) * P;
  const size_t hbase = static_cast<size_t>(b) * S * H + h;   // dt, la
  const size_t bbase = static_cast<size_t>(b) * S * N;       // Bm, Cm
  const size_t sbase = (static_cast<size_t>(b) * H + h) * N * P;

  for (int e = tid; e < N * P; e += kThreads) (&sm.st[0][0])[e] = h0[sbase + e];

  for (int t0 = 0; t0 < S; t0 += kC) {
    // 1. the chunk's tiles; the ragged tail loads as zeros
    for (int e = tid; e < kC * P; e += kThreads) {
      const int t = e / P, p = e % P;
      float v = 0.f;
      if (t0 + t < S)
        v = x[xbase + static_cast<size_t>(t0 + t) * xrow + p] *
            __ldg(dt + hbase + static_cast<size_t>(t0 + t) * H);
      sm.dx[t][p] = v;
    }
    for (int e = tid; e < kC * N; e += kThreads) {
      const int t = e / N, n = e % N;
      float bv = 0.f, cv = 0.f;
      if (t0 + t < S) {
        const size_t off = bbase + static_cast<size_t>(t0 + t) * N + n;
        bv = Bm[off];
        cv = Cm[off];
      }
      sm.Bc[t][n] = bv;
      sm.Cc[t][n] = cv;
    }
    if (tid < kC)
      sm.la[tid] = (t0 + tid < S)
                       ? la[hbase + static_cast<size_t>(t0 + tid) * H]
                       : 0.f;
    __syncthreads();

    // 2. prefix sums of la, left to right, and the decays they give
    if (tid < kC) {
      float c = 0.f, ct = 0.f;
      for (int s = 0; s < kC; ++s) {
        c += sm.la[s];
        if (s == tid) ct = c;
      }
      sm.cum[tid] = ct;
      sm.ecum[tid] = expf(ct);
      sm.rdec[tid] = expf(c - ct);
      if (tid == 0) sm.elast = expf(c);
    }
    __syncthreads();

    // 3. M = (C . B^T) * L on and below the diagonal, 4 x 4 per thread
    {
      float g[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sm.Cc[my + 16 * i][n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sm.Bc[mx + 16 * j][n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = my + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = mx + 16 * j;
          sm.M[t][s] = (s <= t) ? g[i][j] * expf(sm.cum[t] - sm.cum[s]) : 0.f;
        }
      }
    }
    __syncthreads();

    // 4. y for this thread's rows and the new state for its state rows,
    //    both from the state before this chunk's update
    float yin[kRY][4], yst[kRY][4], sacc[kRS][4];
    const float el = sm.elast;
#pragma unroll
    for (int i = 0; i < kRY; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) yin[i][j] = yst[i][j] = 0.f;
#pragma unroll
    for (int i = 0; i < kRS; ++i) {
      const int n = ty + kTY * i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sacc[i][j] = (n < N) ? el * sm.st[n][tx + kTX * j] : 0.f;
    }
    for (int s = 0; s < kC; ++s) {
      float d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) d[j] = sm.dx[s][tx + kTX * j];
#pragma unroll
      for (int i = 0; i < kRY; ++i) {
        const float m = sm.M[ty + kTY * i][s];
#pragma unroll
        for (int j = 0; j < 4; ++j) yin[i][j] = fmaf(m, d[j], yin[i][j]);
      }
      const float rd = sm.rdec[s];
#pragma unroll
      for (int i = 0; i < kRS; ++i) {
        const int n = ty + kTY * i;
        if (n < N) {
          const float bw = sm.Bc[s][n] * rd;
#pragma unroll
          for (int j = 0; j < 4; ++j) sacc[i][j] = fmaf(bw, d[j], sacc[i][j]);
        }
      }
    }
    for (int n = 0; n < N; ++n) {
      float hv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) hv[j] = sm.st[n][tx + kTX * j];
#pragma unroll
      for (int i = 0; i < kRY; ++i) {
        const float c = sm.Cc[ty + kTY * i][n];
#pragma unroll
        for (int j = 0; j < 4; ++j) yst[i][j] = fmaf(c, hv[j], yst[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRY; ++i) {
      const int t = ty + kTY * i;
      if (t0 + t < S) {
        const float ec = sm.ecum[t];
        float* yr = y + xbase + static_cast<size_t>(t0 + t) * xrow;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          yr[tx + kTX * j] = fmaf(ec, yst[i][j], yin[i][j]);
      }
    }
    __syncthreads();          // every read of the old state is done

    // 5. the state carry, in place
#pragma unroll
    for (int i = 0; i < kRS; ++i) {
      const int n = ty + kTY * i;
      if (n < N) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sm.st[n][tx + kTX * j] = sacc[i][j];
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < N * P; e += kThreads) hout[sbase + e] = (&sm.st[0][0])[e];
}

template <int P, int N>
int launch(const float* x, const float* dt, const float* la, const float* Bm,
           const float* Cm, const float* h0, float* y, float* hout, int B,
           int S, int H, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem<P, N>));
  static bool configured = false;   // once per instantiation and process
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(H, B);
  ssd_chunk_kernel<P, N><<<grid, kThreads, smem, stream>>>(
      x, dt, la, Bm, Cm, h0, y, hout, S, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, S, H, P), dt and la (B, S, H), Bm and Cm (B, S, N), h0 (B, H, N, P)
// and the outputs y (B, S, H, P), hout (B, H, N, P): float32, contiguous,
// on the device. (P, N) in {(16, 8), (32, 16), (64, 64)}; S >= 0
// (S = 0 copies h0 to hout). Returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments the kernel does not take).
int ssd_chunked_launch(const void* x, const void* dt, const void* la,
                       const void* Bm, const void* Cm, const void* h0,
                       void* y, void* hout, int B, int S, int H, int P,
                       int N, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S < 0 || B > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* dp = static_cast<const float*>(dt);
  const float* lp = static_cast<const float*>(la);
  const float* bp = static_cast<const float*>(Bm);
  const float* cp = static_cast<const float*>(Cm);
  const float* hp = static_cast<const float*>(h0);
  float* yp = static_cast<float*>(y);
  float* op = static_cast<float*>(hout);
  // the (P, N) pairs a caller uses: Zamba2's (64, 64) and the reference
  // kernel test's (16, 8) and (32, 16); add a pair when a config needs it
  if (P == 64 && N == 64)
    return launch<64, 64>(xp, dp, lp, bp, cp, hp, yp, op, B, S, H, st);
  if (P == 16 && N == 8)
    return launch<16, 8>(xp, dp, lp, bp, cp, hp, yp, op, B, S, H, st);
  if (P == 32 && N == 16)
    return launch<32, 16>(xp, dp, lp, bp, cp, hp, yp, op, B, S, H, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
