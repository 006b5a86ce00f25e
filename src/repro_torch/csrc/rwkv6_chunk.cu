// Chunked RWKV6 WKV scan, one block per (batch row, head).
//
// Replaces the Pallas TPU kernel `wkv6_chunked` / `_wkv6_kernel` of
// src/repro/kernels/rwkv6_chunk.py: r, k, v, lw (B, S, H, K) f32 with the
// log-decay lw <= 0, u (H, K), state0 (B, H, K, K) -> y (B, S, H, K) f32
// and the final state (B, H, K, K). Per head, with state S (K x K),
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),
//   S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T,
// taken chunk by chunk as in the reference:
//   inter: y_t += (r_t * exp(cum_prev_t)) . S
//   intra: y_t += sum_{s<t} A[t,s] v_s, A[t,s] = sum_i r_ti k_si exp(cum_prev_ti - cum_si)
//   bonus: y_t += (sum_i r_ti u_i k_ti) v_t
//   S <- exp(cum_last) * S + sum_s (k_s * exp(cum_last - cum_s)) v_s^T
//
// Every exponent is <= 0, so nothing overflows at any decay strength
// (lw = -20 stays finite): the prefix sums of lw are taken sequentially in
// f32, a non-increasing sequence, so cum_prev_t - cum_s (s < t) and
// cum_last - cum_s are <= 0 in floating point too; only the strict lower
// triangle of A is evaluated (the TPU kernel computes the whole (C, C, K)
// tile and masks it, which is where exp(positive) would appear), and no
// exp(a - b) is split into exp(a) * exp(-b).
//
// What bounds it on the H100: at the engine's prefill shape (B = 4,
// S = 2048, H = 32, K = 64) the function must move 5 x 67 MB (r, k, v, lw
// in, y out) plus the states, 0.10 ms at 3.35 TB/s, against 4 K^2 FLOP per
// token and head (4.3 GFLOP, 0.064 ms at the 67 TFLOP/s FP32 peak): bytes.
// This first version is simple, not fast: the chunks of one head are a
// sequential loop (the state carries), B*H blocks (128 at the engine's
// shape, one wave on 132 SMs) of 8 warps each, five barriers per chunk and
// no load in flight during the compute, so it sits well above the bound.
// Splitting the state's V columns across blocks (they evolve
// independently), overlapping the next chunk's loads and tensor-core
// products are later work.
//
// Design, per block of 256 threads, chunks of kC = 16 tokens (the chunk
// size is the kernel's own: the C^2 K exponentials of the intra term cost
// 4x less than at 64, and the state products cost the same per token):
//   * the K x K f32 state stays in shared memory for the whole sequence;
//   * the chunk's r, k, v and lw tiles are loaded (each token row is K
//     contiguous floats at stride H*K); tokens past S load as r = k = v = 0
//     and lw = 0, which leaves the state unchanged, and their y is not
//     stored, so any S works (the TPU kernel asserts S % chunk == 0);
//   * one thread per channel takes the inclusive and exclusive prefix sums
//     of lw along the chunk;
//   * all threads form r * exp(cum_prev) and k * exp(cum_last - cum), and
//     one thread per (t, s) pair the score A[t, s] (s < t) or the bonus
//     (s == t); rows of r, k and the sums are padded to K + 1 floats so the
//     16 s-rows a warp reads fall in distinct banks;
//   * thread (row group, column j) accumulates y[t, j] for its rows, each
//     state element S[i, j] read once into a register;
//   * thread (row group, column j) advances its state elements in place.
// Built without --use_fast_math (IEEE expf).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kC = 16;          // tokens per chunk
constexpr int kThreads = 256;

template <int K>
struct Smem {
  float S[K][K];              // state: row i (key channel), column j (value)
  float r[kC][K + 1];
  float k[kC][K + 1];
  float cum[kC][K + 1];       // lw on load, then its inclusive prefix sum
  float cp[kC][K + 1];        // exclusive prefix sum (through t - 1)
  float v[kC][K];
  float rdec[kC][K];          // r * exp(cum_prev)
  float kdec[kC][K];          // k * exp(cum_last - cum)
  float A[kC][kC];            // scores: s < t intra, s == t bonus, else 0
  float u[K];
  float wlast[K];             // exp(cum_last): the chunk's state decay
};

template <int K>
__global__ void __launch_bounds__(kThreads)
wkv6_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ lw,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ y, float* __restrict__ sout, int S,
                  int H) {
  static_assert(kThreads % K == 0, "K must divide the block");
  constexpr int kTPR = kThreads / K;                 // thread rows
  constexpr int kRowsY = (kC + kTPR - 1) / kTPR;     // y rows per thread
  constexpr int kRowsS = (K + kTPR - 1) / kTPR;      // state rows per thread
  __shared__ Smem<K> sm;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int j = tid % K, row0 = tid / K;
  const size_t stride = static_cast<size_t>(H) * K;  // between tokens
  const size_t base = (static_cast<size_t>(b) * S * H + h) * K;
  const size_t sbase = (static_cast<size_t>(b) * H + h) * K * K;

  for (int e = tid; e < K * K; e += kThreads) (&sm.S[0][0])[e] = s0[sbase + e];
  for (int i = tid; i < K; i += kThreads) sm.u[i] = u[h * K + i];

  for (int t0 = 0; t0 < S; t0 += kC) {
    // 1. the chunk's tiles; the ragged tail loads as zeros (lw = 0)
    for (int e = tid; e < kC * K; e += kThreads) {
      const int t = e / K, i = e % K;
      float rv = 0.f, kv = 0.f, vv = 0.f, lv = 0.f;
      if (t0 + t < S) {
        const size_t off = base + static_cast<size_t>(t0 + t) * stride + i;
        rv = r[off];
        kv = k[off];
        vv = v[off];
        lv = lw[off];
      }
      sm.r[t][i] = rv;
      sm.k[t][i] = kv;
      sm.v[t][i] = vv;
      sm.cum[t][i] = lv;
    }
    __syncthreads();

    // 2. prefix sums of lw along the chunk, one thread per channel
    if (tid < K) {
      float c = 0.f;
      for (int t = 0; t < kC; ++t) {
        sm.cp[t][tid] = c;
        c += sm.cum[t][tid];
        sm.cum[t][tid] = c;
      }
      sm.wlast[tid] = expf(c);
    }
    __syncthreads();

    // 3. decayed r and k; the scores A[t, s] for s <= t
    for (int e = tid; e < kC * K; e += kThreads) {
      const int t = e / K, i = e % K;
      sm.rdec[t][i] = sm.r[t][i] * expf(sm.cp[t][i]);
      sm.kdec[t][i] = sm.k[t][i] * expf(sm.cum[kC - 1][i] - sm.cum[t][i]);
    }
    for (int e = tid; e < kC * kC; e += kThreads) {
      const int t = e / kC, s = e % kC;
      float a = 0.f;
      if (s < t) {
        for (int i = 0; i < K; ++i)
          a += sm.r[t][i] * sm.k[s][i] * expf(sm.cp[t][i] - sm.cum[s][i]);
      } else if (s == t) {
        for (int i = 0; i < K; ++i) a += sm.r[t][i] * sm.u[i] * sm.k[t][i];
      }
      sm.A[t][s] = a;
    }
    __syncthreads();

    // 4. y = inter + intra + bonus for this thread's rows, column j
    if (row0 < kC) {
      float acc[kRowsY];
#pragma unroll
      for (int m = 0; m < kRowsY; ++m) acc[m] = 0.f;
      for (int i = 0; i < K; ++i) {
        const float sij = sm.S[i][j];
#pragma unroll
        for (int m = 0; m < kRowsY; ++m) {
          const int t = row0 + m * kTPR;
          if (t < kC) acc[m] += sm.rdec[t][i] * sij;
        }
      }
#pragma unroll
      for (int m = 0; m < kRowsY; ++m) {
        const int t = row0 + m * kTPR;
        if (t < kC) {
          float a = acc[m];
          for (int s = 0; s <= t; ++s) a += sm.A[t][s] * sm.v[s][j];
          if (t0 + t < S)
            y[base + static_cast<size_t>(t0 + t) * stride + j] = a;
        }
      }
    }
    __syncthreads();

    // 5. the state carry, in place: S[i, j] for this thread's rows
    if (row0 < K) {
      float vj[kC];
#pragma unroll
      for (int s = 0; s < kC; ++s) vj[s] = sm.v[s][j];
#pragma unroll 4
      for (int m = 0; m < kRowsS; ++m) {
        const int i = row0 + m * kTPR;
        if (i < K) {
          float st = sm.wlast[i] * sm.S[i][j];
#pragma unroll
          for (int s = 0; s < kC; ++s) st += sm.kdec[s][i] * vj[s];
          sm.S[i][j] = st;
        }
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < K * K; e += kThreads) sout[sbase + e] = (&sm.S[0][0])[e];
}

template <int K>
int launch(const float* r, const float* k, const float* v, const float* lw,
           const float* u, const float* s0, float* y, float* sout, int B,
           int S, int H, cudaStream_t stream) {
  dim3 grid(H, B);
  wkv6_chunk_kernel<K><<<grid, kThreads, 0, stream>>>(r, k, v, lw, u, s0, y,
                                                      sout, S, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// r, k, v, lw (B, S, H, K), u (H, K), state0 (B, H, K, K) and the outputs
// y (B, S, H, K), state (B, H, K, K): float32, contiguous, on the device.
// K in {8, 16, 32, 64}; S >= 0 (S = 0 copies state0 to state). Returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments the kernel does
// not take).
int wkv6_chunked_launch(const void* r, const void* k, const void* v,
                        const void* lw, const void* u, const void* state0,
                        void* y, void* state, int B, int S, int H, int K,
                        void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S < 0 || B > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rp = static_cast<const float*>(r);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* lp = static_cast<const float*>(lw);
  const float* up = static_cast<const float*>(u);
  const float* sp = static_cast<const float*>(state0);
  float* yp = static_cast<float*>(y);
  float* op = static_cast<float*>(state);
  switch (K) {
    case 8: return launch<8>(rp, kp, vp, lp, up, sp, yp, op, B, S, H, st);
    case 16: return launch<16>(rp, kp, vp, lp, up, sp, yp, op, B, S, H, st);
    case 32: return launch<32>(rp, kp, vp, lp, up, sp, yp, op, B, S, H, st);
    case 64: return launch<64>(rp, kp, vp, lp, up, sp, yp, op, B, S, H, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
