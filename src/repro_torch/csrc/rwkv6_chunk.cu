// Chunked RWKV6 WKV scan: a parallel pre-pass, then a scan on the tensor
// cores over slices of V.
//
// Replaces the Pallas TPU kernel `wkv6_chunked` / `_wkv6_kernel` of
// src/repro/kernels/rwkv6_chunk.py: r, k, v, lw (B, S, H, K) f32 with the
// log-decay lw <= 0, u (H, K), state0 (B, H, K, K) -> y (B, S, H, K) f32
// and the final state (B, H, K, K). Per head, with state S (K x K),
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),
//   S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T,
// taken chunk by chunk as in the reference, with cum the inclusive and cp
// the exclusive prefix sum of lw along the chunk:
//   inter: y_t += (r_t * exp(cp_t)) . S
//   intra: y_t += sum_{s<t} A[t,s] v_s, A[t,s] = sum_i r_ti k_si exp(cp_ti - cum_si)
//   bonus: y_t += (sum_i r_ti u_i k_ti) v_t
//   S <- exp(cum_last) * S + sum_s (k_s * exp(cum_last - cum_s)) v_s^T
//
// Every exponent is <= 0, so nothing overflows at any decay strength
// (lw = -20 stays finite): the prefix sums of lw <= 0 are made
// non-increasing in floating point (below), and cp_t is cum_{t-1}, so
// cp_t - cum_s (s < t), cum_last - cum_s and cp_t are <= 0; only the strict
// lower triangle of A is evaluated (the TPU kernel computes the whole
// (C, C, K) tile and masks it, which is where exp(positive) would appear),
// and no exp(a - b) is split into exp(a) * exp(-b). Every expf is IEEE
// (no --use_fast_math).
//
// What bounds it on the H100: at the engine's prefill shape (B = 4,
// S = 2048, H = 32, K = 64) the function must move 5 x 67 MB (r, k, v, lw
// in, y out) plus the states, 0.10 ms at 3.35 TB/s, against 4 K^2 FLOP per
// token and head (4.3 GFLOP; 0.026 ms as the scan's split 3xTF32 products,
// three TF32 passes at the 495 TFLOP/s peak): bytes. This design moves
// more than that: the pre-pass writes rdec, kdec and A (~0.15 GB) and the
// scan reads them back, so the pre-pass is a pass over memory; it trades
// those bytes for the latency of the sequential scan, which was the limit
// (one block per (batch row, head), one block on each of 128 SMs, serial
// expf chains). The scan's 128 chunk steps of each head stay in order,
// two barriers each.
//
// Design. Two kernels, launched back to back on one stream:
//   * wkv6_prep_kernel, one block of 160 threads per (chunk, head, batch
//     row), fully parallel: the prefix sums of lw along the chunk (a
//     shuffle scan over 16-lane segments, one per channel, then a shuffle
//     min-scan that makes them non-increasing), and from them
//     rdec = r * exp(cp) and kdec = k * exp(cum_last - cum) (B, S, H, K),
//     wlast = exp(cum_last) (B, H, chunks, K), and the scores A (B, H,
//     chunks, 16, 16): threads 0..119 each one pair s < t, a K-long
//     sequence of expf and FMAs, threads 128..143 the bonus diagonal, and
//     zeros above it. All of the kernels' expf are here, once per chunk.
//   * wkv6_scan_kernel, one block per (V slice of VS = 16 columns, head,
//     batch row): a column j of the state, of y and of v evolves alone, so
//     each block carries a K x VS slice of the state and the grid is
//     (K / VS, H, B), 512 blocks at the engine's shape, four per SM, one
//     wave. Per chunk of kC = 16 tokens its tiles (rdec, kdec, v, A, wlast)
//     arrive by 16-byte cp.async, kStages - 1 chunks ahead. The products
//     run on the tensor cores (mma.sync m16n8k8, split 3xTF32): one warp per
//     8 columns computes y = rdec . S + A . v (16 x 8, over K and then the
//     16 tokens), and one warp per 16 key rows keeps that part of the state
//     in its accumulator registers and updates it, S = exp(cum_last) S +
//     kdec^T . v; after a barrier the state warps write the new state to
//     shared memory (transposed) for the next chunk's y. Two barriers per
//     chunk; shared-memory rows are padded so that no fragment load
//     conflicts in banks.
// The chunk is the kernel's own choice: at 16 the pre-pass's C^2 K / 2
// exponentials per chunk cost 8 K per token (4x fewer than at 64), and the
// state products cost the same per token at any chunk. Tokens past S load
// as r = k = v = 0 and lw = 0, which leaves the state unchanged, and their
// y is not stored, so any S works (the TPU kernel asserts
// S % chunk == 0).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kC = 16;            // tokens per chunk
constexpr int kPrepThreads = 160; // 4 warps of pairs s < t, 1 of diagonals
constexpr int kStages = 4;        // scan: chunks in flight
constexpr int kARow = kC + 4;     // padded row of A

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with full == false the bytes are
// zero-filled and nothing is read (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Pre-pass: prefix sums, rdec, kdec, wlast and A per (chunk, head, row)
// ---------------------------------------------------------------------------

template <int K>
struct PrepSmem {
  float r[kC][K + 4];         // rows padded to whole 16-byte lines
  float k[kC][K + 4];
  float cum[kC][K + 4];       // lw on load, then its inclusive prefix sum
  float cp[kC][K + 4];        // exclusive prefix sum (cum of t - 1)
  float u[K];
  float A[kC][kC];
};

template <int K>
__global__ void __launch_bounds__(kPrepThreads)
wkv6_prep_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ lw, const float* __restrict__ u,
                 float* __restrict__ rdec, float* __restrict__ kdec,
                 float* __restrict__ wlast, float* __restrict__ A, int S,
                 int H) {
  __shared__ __align__(16) PrepSmem<K> sm;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int t0 = c * kC, nch = gridDim.x;
  const size_t stride = static_cast<size_t>(H) * K;  // between tokens
  const size_t base = (static_cast<size_t>(b) * S * H + h) * K;
  const size_t cbase = ((static_cast<size_t>(b) * H + h) * nch + c);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int e = tid; e < kC * K / 4; e += kPrepThreads) {
    const int t = e / (K / 4), i = 4 * (e % (K / 4));
    float4 rv = zero, kv = zero, lv = zero;
    if (t0 + t < S) {
      const size_t off = base + static_cast<size_t>(t0 + t) * stride + i;
      rv = *reinterpret_cast<const float4*>(r + off);
      kv = *reinterpret_cast<const float4*>(k + off);
      lv = *reinterpret_cast<const float4*>(lw + off);
    }
    *reinterpret_cast<float4*>(&sm.r[t][i]) = rv;
    *reinterpret_cast<float4*>(&sm.k[t][i]) = kv;
    *reinterpret_cast<float4*>(&sm.cum[t][i]) = lv;
  }
  for (int i = tid; i < K; i += kPrepThreads) sm.u[i] = u[h * K + i];
  __syncthreads();

  // prefix sums along the chunk: one 16-lane segment per channel, a
  // shuffle scan, then the min of each value and all before it, so the
  // sums are non-increasing after rounding too (lw <= 0)
  for (int i0 = 2 * w; i0 < K; i0 += 2 * (kPrepThreads / 32)) {
    const int t = lane & 15, i = i0 + (lane >> 4);
    float cs = (i < K) ? sm.cum[t][i] : 0.f;
#pragma unroll
    for (int d = 1; d < kC; d <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, cs, d, kC);
      if (t >= d) cs += o;
    }
#pragma unroll
    for (int d = 1; d < kC; d <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, cs, d, kC);
      if (t >= d) cs = fminf(cs, o);
    }
    float prev = __shfl_up_sync(0xffffffffu, cs, 1, kC);
    if (t == 0) prev = 0.f;
    if (i < K) {
      sm.cum[t][i] = cs;
      sm.cp[t][i] = prev;
    }
  }
  __syncthreads();

  // rdec, kdec (rows past S are not stored) and wlast
  for (int e = tid; e < kC * K / 4; e += kPrepThreads) {
    const int t = e / (K / 4), i = 4 * (e % (K / 4));
    if (t0 + t < S) {
      const size_t off = base + static_cast<size_t>(t0 + t) * stride + i;
      const float4 rv = *reinterpret_cast<const float4*>(&sm.r[t][i]);
      const float4 kv = *reinterpret_cast<const float4*>(&sm.k[t][i]);
      const float4 pv = *reinterpret_cast<const float4*>(&sm.cp[t][i]);
      const float4 cv = *reinterpret_cast<const float4*>(&sm.cum[t][i]);
      const float4 lv = *reinterpret_cast<const float4*>(&sm.cum[kC - 1][i]);
      *reinterpret_cast<float4*>(rdec + off) =
          make_float4(rv.x * expf(pv.x), rv.y * expf(pv.y),
                      rv.z * expf(pv.z), rv.w * expf(pv.w));
      *reinterpret_cast<float4*>(kdec + off) =
          make_float4(kv.x * expf(lv.x - cv.x), kv.y * expf(lv.y - cv.y),
                      kv.z * expf(lv.z - cv.z), kv.w * expf(lv.w - cv.w));
    }
  }
  for (int i = tid; i < K; i += kPrepThreads)
    wlast[cbase * K + i] = expf(sm.cum[kC - 1][i]);

  // A: pair p < 120 is (t, s) with s < t, p = t (t - 1) / 2 + s, and its
  // mirror (s, t) above the diagonal is 0; threads 128..143 the diagonal
  if (tid < kC * (kC - 1) / 2) {
    int t = 1;
    while ((t + 1) * t / 2 <= tid) ++t;
    const int s = tid - t * (t - 1) / 2;
    float a = 0.f;
#pragma unroll 4
    for (int i = 0; i < K; i += 4) {
      const float4 rv = *reinterpret_cast<const float4*>(&sm.r[t][i]);
      const float4 kv = *reinterpret_cast<const float4*>(&sm.k[s][i]);
      const float4 pv = *reinterpret_cast<const float4*>(&sm.cp[t][i]);
      const float4 cv = *reinterpret_cast<const float4*>(&sm.cum[s][i]);
      a += rv.x * kv.x * expf(pv.x - cv.x);
      a += rv.y * kv.y * expf(pv.y - cv.y);
      a += rv.z * kv.z * expf(pv.z - cv.z);
      a += rv.w * kv.w * expf(pv.w - cv.w);
    }
    sm.A[t][s] = a;
    sm.A[s][t] = 0.f;
  } else if (tid >= 128 && tid < 128 + kC) {
    const int t = tid - 128;
    float a = 0.f;
    for (int i = 0; i < K; ++i) a += sm.r[t][i] * sm.u[i] * sm.k[t][i];
    sm.A[t][t] = a;
  }
  __syncthreads();
  float4* Ac = reinterpret_cast<float4*>(A + cbase * kC * kC);
  for (int e = tid; e < kC * kC / 4; e += kPrepThreads)
    Ac[e] = reinterpret_cast<const float4*>(&sm.A[0][0])[e];
}

// ---------------------------------------------------------------------------
// The scan over chunks, one block per (V slice, head, batch row)
// ---------------------------------------------------------------------------

template <int K, int VS>
struct ScanSmem {
  float St[VS][K + 4];                  // state slice, transposed: St[j][i]
  float rd[kStages][kC][K + 4];         // rdec
  float kd[kStages][kC][K + 8];         // kdec
  float v[kStages][kC][VS + 8];
  float A[kStages][kC][kARow];
  float wl[kStages][K];                 // exp(cum_last)
};  // rows padded so that each fragment load below is free of conflicts

// warps 0 .. VS/8 - 1: y, one 8-column tile each; the next ceil(K/16):
// the state, one 16-row tile each (its columns all VS)
template <int K, int VS>
struct ScanShape {
  static constexpr int kYWarps = VS / 8;
  static constexpr int kSWarps = (K + 15) / 16;
  static constexpr int kThreads = 32 * (kYWarps + kSWarps);
};

// The 3xTF32 product on the tensor cores: x = hi + lo with hi = x rounded
// to TF32 (10 mantissa bits, to nearest, by integer arithmetic on its bits)
// and lo = x - hi (exact in f32, |lo| <= 2^-11 |x|), which the tensor core
// reads as TF32 (its low 13 bits ignored), so hi + lo keeps ~21 bits of x;
// a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi (the a_lo b_lo term, <= 2^-22 of
// a b, is dropped): close to f32 accuracy, unlike one TF32 product
// (~2^-11). The split is three instructions (cvt.rna.tf32.f32 is a slow
// conversion).
struct Tf32x2 {
  uint32_t hi, lo;
};
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ Tf32x2 split_tf32(float x) {
  const uint32_t hi = round_tf32(x);
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// fragments as mma.m16n8k8 lays them out (lane = 4 g + t):
// a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; b = B[t][g], B[t+4][g];
// d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]
struct FragA {
  Tf32x2 x[4];
};
struct FragB {
  Tf32x2 x[2];
};
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  return {{split_tf32(a0), split_tf32(a1), split_tf32(a2), split_tf32(a3)}};
}
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  return {{split_tf32(b0), split_tf32(b1)}};
}
// d (16 x 8) += a (16 x 8) b (8 x 8): the main term into dm, the two small
// ones into dc, two accumulators so that consecutive products do not wait
// for each other (the caller adds dc to dm at the end)
__device__ __forceinline__ void mma_3xtf32(float (&dm)[4], float (&dc)[4],
                                           const FragA& a, const FragB& b) {
  mma_tf32(dc, a.x[0].lo, a.x[1].lo, a.x[2].lo, a.x[3].lo, b.x[0].hi,
           b.x[1].hi);
  mma_tf32(dc, a.x[0].hi, a.x[1].hi, a.x[2].hi, a.x[3].hi, b.x[0].lo,
           b.x[1].lo);
  mma_tf32(dm, a.x[0].hi, a.x[1].hi, a.x[2].hi, a.x[3].hi, b.x[0].hi,
           b.x[1].hi);
}

__device__ __forceinline__ void add4(float (&d)[4], const float (&e)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += e[i];
}

template <int K, int VS>
__global__ void __launch_bounds__(ScanShape<K, VS>::kThreads, 4)
wkv6_scan_kernel(const float* __restrict__ rdec,
                 const float* __restrict__ kdec, const float* __restrict__ v,
                 const float* __restrict__ A, const float* __restrict__ wlast,
                 const float* __restrict__ s0, float* __restrict__ y,
                 float* __restrict__ sout, int S, int H) {
  using Shape = ScanShape<K, VS>;
  constexpr int kThreads = Shape::kThreads;
  static_assert(VS % 8 == 0 && K % VS == 0 && K % 8 == 0, "K, VS");
  extern __shared__ float4 smem4[];
  ScanSmem<K, VS>& sm = *reinterpret_cast<ScanSmem<K, VS>*>(smem4);

  const int j0 = blockIdx.x * VS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nch = (S + kC - 1) / kC;
  const size_t stride = static_cast<size_t>(H) * K;  // between tokens
  const size_t base = (static_cast<size_t>(b) * S * H + h) * K;
  const size_t cbase = (static_cast<size_t>(b) * H + h) * nch;
  const size_t sbase = (static_cast<size_t>(b) * H + h) * K * K + j0;

  auto issue = [&](int c) {
    const int st = c % kStages, t0 = c * kC;
    for (int e = tid; e < kC * K / 4; e += kThreads) {
      const int t = e / (K / 4), q = e % (K / 4);
      const bool ok = t0 + t < S;
      const size_t off =
          base + static_cast<size_t>(ok ? t0 + t : 0) * stride + 4 * q;
      cp_async16(&sm.rd[st][t][4 * q], rdec + off, ok);
      cp_async16(&sm.kd[st][t][4 * q], kdec + off, ok);
    }
    for (int e = tid; e < kC * VS / 4; e += kThreads) {
      const int t = e / (VS / 4), q = e % (VS / 4);
      const bool ok = t0 + t < S;
      cp_async16(&sm.v[st][t][4 * q],
                 v + base + static_cast<size_t>(ok ? t0 + t : 0) * stride +
                     j0 + 4 * q,
                 ok);
    }
    const float* Ac = A + (cbase + c) * kC * kC;
    for (int e = tid; e < kC * kC / 4; e += kThreads)
      cp_async16(&sm.A[st][e / (kC / 4)][4 * (e % (kC / 4))], Ac + 4 * e,
                 true);
    for (int e = tid; e < K / 4; e += kThreads)
      cp_async16(&sm.wl[st][4 * e], wlast + (cbase + c) * K + 4 * e, true);
  };

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nch) issue(c);
    cp_async_commit();
  }

  // y warp nt: rows g, g + 8 of the chunk, columns nt*8 + 2 t4 (+1);
  // state warp mt: key rows i0 = 16 mt + g and i0 + 8, every column
  const bool is_y = w < Shape::kYWarps;
  const int nt = w, mt = w - Shape::kYWarps;
  const int i0 = 16 * mt + g, i1 = i0 + 8;
  const bool r0 = i0 < K, r1 = i1 < K;                // K = 8: half a tile
  float acc[VS / 8][4];                               // the state (S warps)
  if (!is_y) {
#pragma unroll
    for (int n = 0; n < VS / 8; ++n) {
      const int j = 8 * n + 2 * t4;
      acc[n][0] = r0 ? s0[sbase + static_cast<size_t>(i0) * K + j] : 0.f;
      acc[n][1] = r0 ? s0[sbase + static_cast<size_t>(i0) * K + j + 1] : 0.f;
      acc[n][2] = r1 ? s0[sbase + static_cast<size_t>(i1) * K + j] : 0.f;
      acc[n][3] = r1 ? s0[sbase + static_cast<size_t>(i1) * K + j + 1] : 0.f;
      if (r0) {
        sm.St[j][i0] = acc[n][0];
        sm.St[j + 1][i0] = acc[n][1];
      }
      if (r1) {
        sm.St[j][i1] = acc[n][2];
        sm.St[j + 1][i1] = acc[n][3];
      }
    }
  }

  for (int c = 0; c < nch; ++c) {
    const int st = c % kStages, t0 = c * kC;
    cp_async_wait<kStages - 2>();
    __syncthreads();          // (1) chunk c landed; the state is current
    if (c + kStages - 1 < nch) issue(c + kStages - 1);
    cp_async_commit();

    if (is_y) {
      // y = rdec . S (over the K key rows) + A . v (over the 16 tokens),
      // even and odd 8-row steps into separate accumulators
      float dm[2][4] = {}, dc[2][4] = {};
      const int jc = 8 * nt + g;                      // B fragment column
#pragma unroll
      for (int k8 = 0; k8 < K; k8 += 8) {
        const int e = (k8 >> 3) & 1;
        const FragA a = frag_a(sm.rd[st][g][k8 + t4], sm.rd[st][g + 8][k8 + t4],
                               sm.rd[st][g][k8 + t4 + 4],
                               sm.rd[st][g + 8][k8 + t4 + 4]);
        const FragB bb = frag_b(sm.St[jc][k8 + t4], sm.St[jc][k8 + t4 + 4]);
        mma_3xtf32(dm[e], dc[e], a, bb);
      }
#pragma unroll
      for (int k8 = 0; k8 < kC; k8 += 8) {
        const int e = (k8 >> 3) & 1;
        const FragA a = frag_a(sm.A[st][g][k8 + t4], sm.A[st][g + 8][k8 + t4],
                               sm.A[st][g][k8 + t4 + 4],
                               sm.A[st][g + 8][k8 + t4 + 4]);
        const FragB bb = frag_b(sm.v[st][k8 + t4][jc],
                                sm.v[st][k8 + t4 + 4][jc]);
        mma_3xtf32(dm[e], dc[e], a, bb);
      }
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        d[i] = (dm[0][i] + dm[1][i]) + (dc[0][i] + dc[1][i]);
      const int jy = j0 + 8 * nt + 2 * t4;
      if (t0 + g < S) {
        float* yr = y + base + static_cast<size_t>(t0 + g) * stride + jy;
        yr[0] = d[0];
        yr[1] = d[1];
      }
      if (t0 + g + 8 < S) {
        float* yr = y + base + static_cast<size_t>(t0 + g + 8) * stride + jy;
        yr[0] = d[2];
        yr[1] = d[3];
      }
    } else {
      // S = exp(cum_last) S + kdec^T . v
      const float w0 = r0 ? sm.wl[st][i0] : 0.f;
      const float w1 = r1 ? sm.wl[st][i1] : 0.f;
#pragma unroll
      for (int n = 0; n < VS / 8; ++n) {
        acc[n][0] *= w0;
        acc[n][1] *= w0;
        acc[n][2] *= w1;
        acc[n][3] *= w1;
      }
      float dc[VS / 8][4] = {};
#pragma unroll
      for (int k8 = 0; k8 < kC; k8 += 8) {
        const FragA a = frag_a(r0 ? sm.kd[st][k8 + t4][i0] : 0.f,
                               r1 ? sm.kd[st][k8 + t4][i1] : 0.f,
                               r0 ? sm.kd[st][k8 + t4 + 4][i0] : 0.f,
                               r1 ? sm.kd[st][k8 + t4 + 4][i1] : 0.f);
#pragma unroll
        for (int n = 0; n < VS / 8; ++n) {
          const FragB bb = frag_b(sm.v[st][k8 + t4][8 * n + g],
                                  sm.v[st][k8 + t4 + 4][8 * n + g]);
          mma_3xtf32(acc[n], dc[n], a, bb);
        }
      }
#pragma unroll
      for (int n = 0; n < VS / 8; ++n) add4(acc[n], dc[n]);
    }
    __syncthreads();          // (2) every read of the old state is done
    if (!is_y) {
#pragma unroll
      for (int n = 0; n < VS / 8; ++n) {
        const int j = 8 * n + 2 * t4;
        if (r0) {
          sm.St[j][i0] = acc[n][0];
          sm.St[j + 1][i0] = acc[n][1];
        }
        if (r1) {
          sm.St[j][i1] = acc[n][2];
          sm.St[j + 1][i1] = acc[n][3];
        }
      }
    }
  }
  cp_async_wait<0>();

  if (!is_y) {
#pragma unroll
    for (int n = 0; n < VS / 8; ++n) {
      const int j = 8 * n + 2 * t4;
      if (r0) {
        sout[sbase + static_cast<size_t>(i0) * K + j] = acc[n][0];
        sout[sbase + static_cast<size_t>(i0) * K + j + 1] = acc[n][1];
      }
      if (r1) {
        sout[sbase + static_cast<size_t>(i1) * K + j] = acc[n][2];
        sout[sbase + static_cast<size_t>(i1) * K + j + 1] = acc[n][3];
      }
    }
  }
}

template <int K, int VS>
int scan_smem_bytes() {
  return static_cast<int>(sizeof(ScanSmem<K, VS>));
}

template <int K, int VS>
cudaError_t configure() {
  static cudaError_t status = [] {
    return cudaFuncSetAttribute(wkv6_scan_kernel<K, VS>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                scan_smem_bytes<K, VS>());
  }();
  return status;
}

template <int K, int VS>
int launch(const float* r, const float* k, const float* v, const float* lw,
           const float* u, const float* s0, float* rdec, float* kdec,
           float* wlast, float* A, float* y, float* sout, int B, int S, int H,
           cudaStream_t stream) {
  const int nch = (S + kC - 1) / kC;
  if (nch > 0) {
    dim3 pg(nch, H, B);
    wkv6_prep_kernel<K><<<pg, kPrepThreads, 0, stream>>>(
        r, k, lw, u, rdec, kdec, wlast, A, S, H);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const cudaError_t e = configure<K, VS>();
  if (e != cudaSuccess) return e;
  dim3 grid(K / VS, H, B);
  wkv6_scan_kernel<K, VS>
      <<<grid, ScanShape<K, VS>::kThreads, scan_smem_bytes<K, VS>(), stream>>>(
          rdec, kdec, v, A, wlast, s0, y, sout, S, H);
  return cudaGetLastError();
}

template <int K, int VS>
int occupancy(int* blocks_per_sm, int* slices) {
  const cudaError_t e = configure<K, VS>();
  if (e != cudaSuccess) return e;
  *slices = K / VS;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, wkv6_scan_kernel<K, VS>, ScanShape<K, VS>::kThreads,
      scan_smem_bytes<K, VS>());
}

}  // namespace

// The head sizes K, each with its V slice VS (the columns one scan block
// carries).
#define REPRO_WKV6_SHAPES(X) \
  X(8, 8)                    \
  X(16, 16)                  \
  X(32, 16)                  \
  X(64, 16)

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// r, k, v, lw (B, S, H, K), u (H, K), state0 (B, H, K, K), the scratch
// rdec and kdec (B, S, H, K), wlast (B, H, ceil(S / 16), K) and A (B, H,
// ceil(S / 16), 16, 16), and the outputs y (B, S, H, K), state (B, H, K, K):
// float32, contiguous, on the device; v 16-byte aligned. K one of
// REPRO_WKV6_SHAPES; S >= 0 (S = 0 copies state0 to state). Launches the
// pre-pass, then the scan. Returns cudaGetLastError() (cudaErrorInvalidValue
// for arguments the kernels do not take).
int wkv6_chunked_launch(const void* r, const void* k, const void* v,
                        const void* lw, const void* u, const void* state0,
                        void* rdec, void* kdec, void* wlast, void* A,
                        void* y, void* state, int B, int S, int H, int K,
                        void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S < 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rp = static_cast<const float*>(r);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* lp = static_cast<const float*>(lw);
  const float* up = static_cast<const float*>(u);
  const float* sp = static_cast<const float*>(state0);
  float* rd = static_cast<float*>(rdec);
  float* kd = static_cast<float*>(kdec);
  float* wl = static_cast<float*>(wlast);
  float* ap = static_cast<float*>(A);
  float* yp = static_cast<float*>(y);
  float* op = static_cast<float*>(state);
#define REPRO_WKV6_LAUNCH(KK, VSS)                                         \
  if (K == KK)                                                             \
    return launch<KK, VSS>(rp, kp, vp, lp, up, sp, rd, kd, wl, ap, yp, op, \
                           B, S, H, st);
  REPRO_WKV6_SHAPES(REPRO_WKV6_LAUNCH)
#undef REPRO_WKV6_LAUNCH
  return cudaErrorInvalidValue;
}

// How the scan kernel for head size K sits on this device: its blocks per
// SM (from the occupancy calculator, with its shared memory) and its V
// slices per head. Returns a cudaError_t.
int wkv6_chunked_occupancy(int K, int* blocks_per_sm, int* slices) {
#define REPRO_WKV6_OCC(KK, VSS) \
  if (K == KK) return occupancy<KK, VSS>(blocks_per_sm, slices);
  REPRO_WKV6_SHAPES(REPRO_WKV6_OCC)
#undef REPRO_WKV6_OCC
  return cudaErrorInvalidValue;
}

}  // extern "C"
