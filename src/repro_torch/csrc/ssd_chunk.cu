// Chunked Mamba2 SSD scan: a parallel pre-pass, then a scan on the tensor
// cores.
//
// Replaces the Pallas TPU kernel `ssd_chunked` / `_ssd_kernel` of
// src/repro/kernels/ssd_chunk.py: x (B, S, H, P) f32, dt and la (B, S, H)
// f32 with the log-decay la <= 0, Bm and Cm (B, S, N) f32 shared by all
// heads (n_groups = 1), h0 (B, H, N, P) f32 -> y (B, S, H, P) f32 and the
// final state (B, H, N, P) f32. Per head, with state h (N x P),
//   h_t = exp(la_t) h_{t-1} + dt_t B_t x_t^T,   y_t = h_t^T C_t,
// taken chunk by chunk as in the reference, with cum the inclusive prefix
// sum of la along the chunk:
//   M[t, s] = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t, else 0
//   y_t     = exp(cum_t) (C_t . h) + sum_s M[t, s] x_s   (h before the chunk)
//   h      <- exp(cum_last) h + sum_s (B_s exp(cum_last - cum_s) dt_s) x_s^T
// The D skip term and the gated RMSNorm stay in the model.
//
// Every exponent is <= 0, so nothing overflows at any decay strength: the
// prefix sums of la <= 0 are taken left to right in f32 (a non-increasing
// sequence), so cum_t - cum_s (s <= t), cum_last - cum_s and cum_t are <= 0
// in floating point too; only s <= t is exponentiated (the TPU kernel takes
// exp over the whole (C, C) tile and masks it afterwards, where the upper
// triangle's exponent is positive and would overflow to inf, and inf * 0
// is NaN); and no exp(a - b) is split into exp(a) * exp(-b).
//
// What bounds it on the H100: at the engine's prefill shape (B = 4,
// S = 2048, H = 80, P = N = 64) the function must move 355.5 MB (x in, y
// out, dt, la, Bm, Cm, h0 and the final state), 0.106 ms at 3.35 TB/s; its
// ~13.5 GFLOP of products (4 N P per token and head, the s <= t triangles
// of the intra-chunk product per head and of C . B^T per batch row) run on
// the tensor cores as split 3xTF32 products, three TF32 passes, 0.082 ms
// at a third of the 495 TFLOP/s TF32 peak: bytes. What holds the kernel
// above that: the chunks of one head are a sequential loop (the state
// carries), 32 steps of three barrier-separated phases each; a block needs
// 160 KB of shared memory, so one runs on each SM and its serial phases
// (M's exponentials, the state's write-back) overlap no other block's
// products; 320 blocks take 2.42 waves of 132; and the products go through
// mma.sync, the warp-level instruction, not Hopper's wgmma.
//
// Design. Two kernels, launched back to back on one stream:
//   * ssd_prep_kernel, one block of 8 warps per (quarter of a chunk's rows,
//     chunk, batch row), fully parallel:
//       - G = C . B^T, the s <= t triangle of each (64 x 64) tile, in FP32
//         FMAs into a scratch (B, ceil(S/64), 64, 64) array (2.1 MB at the
//         engine's shape): C . B^T is shared by all H heads (n_groups = 1),
//         so the scan reads it instead of recomputing it per head;
//       - one warp per head (h = q, q + 4, ...): the chunk's 64-long prefix
//         sum of la, lane 0 adding the values in order (the f32 sums a
//         sequential scan takes: the 1e-5 gates at strong decay need the
//         same rounding as the plain version's cumsum), and from it
//         cum, exp(cum), exp(cum_last - cum) * dt and dt, each
//         (B, H, chunks, 64) in a scratch aux array.
//   * ssd_scan_kernel, one block of two warps per 16 columns for each
//     (column slice, head, batch row): a column p of the state, of y and of
//     x evolves alone, so a block carries an N x PS slice of the state in
//     shared memory; PS = P (an 8-warp block for each of Zamba2's 320
//     heads at the engine's shape; PS = 32, two blocks per SM, ran
//     slower). Per chunk of kC = 64 tokens:
//       - the next chunk's x, Bm, Cm, G and per-token factors are already in
//         flight: two stages of 16-byte cp.async copies, issued one chunk
//         ahead;
//       - M = G * exp(cum_t - cum_s) * dt_s (s <= t, 2,080 expf) in place of
//         G, and Bm scaled in place by exp(cum_last - cum_s) * dt_s;
//       - the products on the tensor cores (mma.sync m16n8k8, 3xTF32): a
//         warp owns 2 x 2 tiles of 16 x 8 of y (row tiles {0, 3} or {1, 2},
//         so every warp does the same share of the triangle s <= t) and 2 x 2
//         of the new state, over the same columns, so each fragment of x
//         feeds both; y = exp(cum) (C . h) + M . x and the new state
//         exp(cum_last) h + B'^T . x read the old state, which is written in
//         place after a barrier. Three barriers per chunk; shared-memory
//         rows are padded so that no fragment load conflicts in banks.
//     Tokens past S load as zeros (x = dt = la = 0, B = C = 0), which
//     leaves the state unchanged, and their y is not stored, so any S works
//     (the TPU kernel asserts S % chunk == 0).
// Built without --use_fast_math (IEEE expf).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;          // tokens per chunk
constexpr int kGramRows = 16;   // rows of G per pre-pass block
constexpr int kMRow = kC + 4;   // padded row of M: the 8 rows of a
                                // fragment load fall in distinct banks

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared copies; with full == false the bytes are zero-filled and
// nothing is read (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}


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
// for each other (the caller adds dc to dm)
__device__ __forceinline__ void mma_3xtf32(float (&dm)[4], float (&dc)[4],
                                           const FragA& a, const FragB& b) {
  mma_tf32(dc, a.x[0].lo, a.x[1].lo, a.x[2].lo, a.x[3].lo, b.x[0].hi,
           b.x[1].hi);
  mma_tf32(dc, a.x[0].hi, a.x[1].hi, a.x[2].hi, a.x[3].hi, b.x[0].lo,
           b.x[1].lo);
  mma_tf32(dm, a.x[0].hi, a.x[1].hi, a.x[2].hi, a.x[3].hi, b.x[0].hi,
           b.x[1].hi);
}

// ---------------------------------------------------------------------------
// Pre-pass, one block of 8 warps per (quarter of the chunk's rows, chunk,
// batch row):
//   G[b, c, t, s] = C_t . B_s for s <= t (0 above the diagonal), and for
//   the heads h = q, q + 4, ... the chunk's per-token factors
//   aux[0] = cum (inclusive prefix sum of la, left to right), aux[1] =
//   exp(cum), aux[2] = exp(cum_last - cum) * dt, aux[3] = dt, each
//   (B, H, chunks, 64)
// ---------------------------------------------------------------------------

template <int N>
__global__ void __launch_bounds__(256)
ssd_prep_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ la, const float* __restrict__ dt,
                float* __restrict__ G, float* __restrict__ aux, int S,
                int H, int B) {
  __shared__ float Bs[kC][N + 1];         // +1: 16 rows a warp reads differ
  __shared__ float Cs[kGramRows][N + 1];  // in bank
  __shared__ __align__(16) float lsum[8][kC];
  const int q = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, t0 = c * kC;
  const int nch = gridDim.y;
  const size_t base = static_cast<size_t>(b) * S * N;
  for (int e = tid; e < kC * N; e += 256) {
    const int s = e / N, n = e % N;
    Bs[s][n] = (t0 + s < S) ? Bm[base + static_cast<size_t>(t0 + s) * N + n]
                            : 0.f;
  }
  for (int e = tid; e < kGramRows * N; e += 256) {
    const int r = e / N, n = e % N, t = t0 + q * kGramRows + r;
    Cs[r][n] = (t < S) ? Cm[base + static_cast<size_t>(t) * N + n] : 0.f;
  }

  // the per-token factors, one warp per head h = q, q + 4, ...: the lanes
  // load two tokens each, lane 0 adds the 64 values left to right (the
  // sums a sequential scan takes), the lanes exponentiate their two
  const int w = tid >> 5, lane = tid & 31;
  float* lw_s = lsum[w];
  const size_t plane = static_cast<size_t>(B) * H * nch * kC;
  for (int h = q + 4 * w; h < H; h += 4 * 8) {
    float2 lv = make_float2(0.f, 0.f), dv = make_float2(0.f, 0.f);
    const size_t off = (static_cast<size_t>(b) * S + t0 + 2 * lane) * H + h;
    if (t0 + 2 * lane < S) {
      lv.x = la[off];
      dv.x = dt[off];
    }
    if (t0 + 2 * lane + 1 < S) {
      lv.y = la[off + H];
      dv.y = dt[off + H];
    }
    *reinterpret_cast<float2*>(lw_s + 2 * lane) = lv;
    __syncwarp();
    if (lane == 0) {
      float cum = 0.f;
#pragma unroll 16
      for (int t = 0; t < kC; ++t) {
        cum += lw_s[t];
        lw_s[t] = cum;
      }
    }
    __syncwarp();
    const float2 cv = *reinterpret_cast<const float2*>(lw_s + 2 * lane);
    const float clast = lw_s[kC - 1];
    float* a = aux + ((static_cast<size_t>(b) * H + h) * nch + c) * kC +
               2 * lane;
    *reinterpret_cast<float2*>(a) = cv;
    *reinterpret_cast<float2*>(a + plane) =
        make_float2(expf(cv.x), expf(cv.y));
    *reinterpret_cast<float2*>(a + 2 * plane) = make_float2(
        expf(clast - cv.x) * dv.x, expf(clast - cv.y) * dv.y);
    *reinterpret_cast<float2*>(a + 3 * plane) = dv;
    __syncwarp();
  }
  __syncthreads();            // Bs and Cs are complete

  const int r = tid >> 4, t = q * kGramRows + r;
  float* Gt = G + ((static_cast<size_t>(b) * nch + c) * kC + t) * kC;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s = (tid & 15) + 16 * j;
    float g = 0.f;
    if (s <= t) {
#pragma unroll 8
      for (int n = 0; n < N; ++n) g = fmaf(Cs[r][n], Bs[s][n], g);
    }
    Gt[s] = g;
  }
}

// ---------------------------------------------------------------------------
// The scan over chunks, one block per (column slice, head, batch row)
// ---------------------------------------------------------------------------

template <int N, int PS>
struct ScanSmem {
  float h[N][PS + 8];           // the state slice: row n, column p
  float x[2][kC][PS + 8];       // x slice, two stages
  float Bt[2][kC][N + 8];       // Bm, then Bm * exp(cum_last - cum) * dt
  float Ct[2][kC][N + 4];       // Cm
  float M[2][kC][kMRow];        // G, then G * L * dt (zero above the diagonal)
  float aux[2][4][kC];          // cum, exp(cum), exp(cum_last - cum) dt, dt
};  // rows padded so that each fragment load below is free of conflicts

// the scan block: two warps for each 16 columns of the slice
template <int PS>
struct ScanShape {
  static constexpr int kThreads = 64 * (PS / 16);
};

template <int P, int N, int PS>
__global__ void __launch_bounds__(ScanShape<PS>::kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ G,
                const float* __restrict__ aux, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ hout, int S,
                int H, int B) {
  constexpr int kThreads = ScanShape<PS>::kThreads;
  constexpr int kGq = kC * kC / 4 / kThreads;   // M float4 per thread
  static_assert(PS == 16 || PS == 32 || PS == 64, "PS in {16, 32, 64}");
  static_assert(P % PS == 0 && N % 4 == 0 && N <= 64, "P, N");
  extern __shared__ float4 smem4[];
  ScanSmem<N, PS>& sm = *reinterpret_cast<ScanSmem<N, PS>*>(smem4);

  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;            // fragment row, column
  const int nch = (S + kC - 1) / kC;
  const size_t xrow = static_cast<size_t>(H) * P;            // x, y: per token
  const size_t xbase = (static_cast<size_t>(b) * S * H + h) * P + p0;
  const size_t bbase = static_cast<size_t>(b) * S * N;       // Bm, Cm
  const size_t sbase = (static_cast<size_t>(b) * H + h) * N * P + p0;
  const size_t plane = static_cast<size_t>(B) * H * nch * kC;
  const float* auxb = aux + (static_cast<size_t>(b) * H + h) * nch * kC;
  const float4* Gb = reinterpret_cast<const float4*>(
      G + static_cast<size_t>(b) * nch * kC * kC);

  for (int e = tid; e < N * PS; e += kThreads)
    sm.h[e / PS][e % PS] = h0[sbase + static_cast<size_t>(e / PS) * P + e % PS];

  // chunk c's tiles into stage st; rows past S are zero-filled
  auto issue = [&](int c, int st) {
    const int t0 = c * kC;
    for (int e = tid; e < kC * PS / 4; e += kThreads) {
      const int t = e / (PS / 4), q = e % (PS / 4);
      const bool ok = t0 + t < S;
      cp_async16(&sm.x[st][t][4 * q],
                 x + xbase + static_cast<size_t>(ok ? t0 + t : 0) * xrow + 4 * q,
                 ok);
    }
    for (int e = tid; e < kC * N / 4; e += kThreads) {
      const int t = e / (N / 4), q = e % (N / 4);
      const bool ok = t0 + t < S;
      const size_t off = bbase + static_cast<size_t>(ok ? t0 + t : 0) * N + 4 * q;
      cp_async16(&sm.Bt[st][t][4 * q], Bm + off, ok);
      cp_async16(&sm.Ct[st][t][4 * q], Cm + off, ok);
    }
    for (int e = tid; e < kC; e += kThreads) {       // 4 planes x 16 float4
      const int k = e >> 4, q = e & 15;
      cp_async16(&sm.aux[st][k][4 * q],
                 auxb + k * plane + static_cast<size_t>(c) * kC + 4 * q, true);
    }
    // G's lower triangle (s0 <= t), in whole 16-byte pieces
    const float4* Gc = Gb + static_cast<size_t>(c) * (kC * kC / 4);
    for (int f = tid; f < kC * kC / 4; f += kThreads) {
      const int t = f >> 4, s0 = (f & 15) * 4;
      if (s0 <= t) cp_async16(&sm.M[st][t][s0], Gc + f, true);
    }
  };

  if (nch > 0) issue(0, 0);
  cp_async_commit();

  // this warp's 16 x 8 tiles: y rows (m-tiles of 16) ym[0], ym[1], state
  // rows hm[0], hm[1], each over the slice's columns (n-tiles of 8) with
  // fragment columns nc[0], nc[1]; the pairs {0, 3} and {1, 2} give every
  // warp the same share of the triangle s <= t
  const int par = w & 1;
  const int ym[2] = {par, 3 - par};
  const int hm[2] = {2 * par, 2 * par + 1};
  const int nc[2] = {16 * (w >> 1) + g, 16 * (w >> 1) + 8 + g};
  bool hon[2], hr0[2], hr1[2];                  // state tile / rows present
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    hon[m] = 16 * hm[m] < N;
    hr0[m] = 16 * hm[m] + g < N;
    hr1[m] = 16 * hm[m] + g + 8 < N;
  }

  for (int c = 0; c < nch; ++c) {
    const int st = c & 1, t0 = c * kC;
    cp_async_wait_all();
    __syncthreads();          // (1) chunk c landed; the state is current
    if (c + 1 < nch) issue(c + 1, st ^ 1);
    cp_async_commit();
    const float* cum = sm.aux[st][0];
    const float* ecum = sm.aux[st][1];
    const float* bw = sm.aux[st][2];
    const float* dtc = sm.aux[st][3];

    // M = G * exp(cum_t - cum_s) * dt_s for s <= t, in place
    float (*Ms)[kMRow] = sm.M[st];
#pragma unroll
    for (int j = 0; j < kGq; ++j) {
      const int f = tid + kThreads * j, t = f >> 4, s0 = (f & 15) * 4;
      float4 mv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s0 <= t) {
        const float4 g = *reinterpret_cast<const float4*>(&Ms[t][s0]);
        const float ct = cum[t];
        const float4 cs = *reinterpret_cast<const float4*>(cum + s0);
        const float4 ds = *reinterpret_cast<const float4*>(dtc + s0);
        mv.x = g.x * expf(ct - cs.x) * ds.x;
        if (s0 + 1 <= t) mv.y = g.y * expf(ct - cs.y) * ds.y;
        if (s0 + 2 <= t) mv.z = g.z * expf(ct - cs.z) * ds.z;
        if (s0 + 3 <= t) mv.w = g.w * expf(ct - cs.w) * ds.w;
      }
      *reinterpret_cast<float4*>(&Ms[t][s0]) = mv;
    }
    // B_s *= exp(cum_last - cum_s) * dt_s
    for (int e = tid; e < kC * N / 4; e += kThreads) {
      const int s = e / (N / 4), q = e % (N / 4);
      const float wgt = bw[s];
      float4* p4 = reinterpret_cast<float4*>(&sm.Bt[st][s][4 * q]);
      float4 v = *p4;
      v.x *= wgt;
      v.y *= wgt;
      v.z *= wgt;
      v.w *= wgt;
      *p4 = v;
    }
    __syncthreads();          // (2) M and B' are complete

    // y = exp(cum_t) (C_t . h) + M_t . x and the new state el h + B'^T x,
    // all from the old state, on the tensor cores: main terms in *d, the
    // small ones of the 3xTF32 split in *c
    float yd[2][2][4] = {}, yc[2][2][4] = {};   // [m-tile][n-tile][frag]
    float hd[2][2][4], hc[2][2][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 8) {
      FragB bh[2];
#pragma unroll
      for (int n = 0; n < 2; ++n)
        bh[n] = frag_b(sm.h[k0 + t4][nc[n]], sm.h[k0 + t4 + 4][nc[n]]);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* c0 = sm.Ct[st][16 * ym[m] + g];
        const float* c1 = sm.Ct[st][16 * ym[m] + g + 8];
        const FragA a = frag_a(c0[k0 + t4], c1[k0 + t4], c0[k0 + t4 + 4],
                               c1[k0 + t4 + 4]);
#pragma unroll
        for (int n = 0; n < 2; ++n) mma_3xtf32(yd[m][n], yc[m][n], a, bh[n]);
      }
    }
    const float el = ecum[kC - 1];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float e0 = ecum[16 * ym[m] + g], e1 = ecum[16 * ym[m] + g + 8];
      const int r0 = 16 * hm[m] + g, r1 = r0 + 8;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          yd[m][n][i] = (yd[m][n][i] + yc[m][n][i]) * (i < 2 ? e0 : e1);
          yc[m][n][i] = 0.f;
        }
        const int col = nc[n] - g + 2 * t4;
        hd[m][n][0] = hr0[m] ? el * sm.h[r0][col] : 0.f;
        hd[m][n][1] = hr0[m] ? el * sm.h[r0][col + 1] : 0.f;
        hd[m][n][2] = hr1[m] ? el * sm.h[r1][col] : 0.f;
        hd[m][n][3] = hr1[m] ? el * sm.h[r1][col + 1] : 0.f;
      }
    }
    // one pass over s: each x fragment feeds the y and the state tiles;
    // y m-tile m stops after its diagonal block (s < 16 (m + 1))
#pragma unroll 2
    for (int k0 = 0; k0 < kC; k0 += 8) {
      FragB bx[2];
#pragma unroll
      for (int n = 0; n < 2; ++n)
        bx[n] = frag_b(sm.x[st][k0 + t4][nc[n]], sm.x[st][k0 + t4 + 4][nc[n]]);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (k0 < 16 * (ym[m] + 1)) {
          const float* m0 = Ms[16 * ym[m] + g];
          const float* m1 = Ms[16 * ym[m] + g + 8];
          const FragA a = frag_a(m0[k0 + t4], m1[k0 + t4], m0[k0 + t4 + 4],
                                 m1[k0 + t4 + 4]);
#pragma unroll
          for (int n = 0; n < 2; ++n)
            mma_3xtf32(yd[m][n], yc[m][n], a, bx[n]);
        }
        if (hon[m]) {                          // A = B'^T: row n, column s
          const int r0 = 16 * hm[m] + g, r1 = r0 + 8;
          const float* b0 = sm.Bt[st][k0 + t4];
          const float* b1 = sm.Bt[st][k0 + t4 + 4];
          const FragA a = frag_a(hr0[m] ? b0[r0] : 0.f, hr1[m] ? b0[r1] : 0.f,
                                 hr0[m] ? b1[r0] : 0.f, hr1[m] ? b1[r1] : 0.f);
#pragma unroll
          for (int n = 0; n < 2; ++n)
            mma_3xtf32(hd[m][n], hc[m][n], a, bx[n]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int r0 = 16 * ym[m] + g, r1 = r0 + 8;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = nc[n] - g + 2 * t4;
        // streaming stores: y is not read again here
        if (t0 + r0 < S)
          __stcs(reinterpret_cast<float2*>(
                     y + xbase + static_cast<size_t>(t0 + r0) * xrow + col),
                 make_float2(yd[m][n][0] + yc[m][n][0],
                             yd[m][n][1] + yc[m][n][1]));
        if (t0 + r1 < S)
          __stcs(reinterpret_cast<float2*>(
                     y + xbase + static_cast<size_t>(t0 + r1) * xrow + col),
                 make_float2(yd[m][n][2] + yc[m][n][2],
                             yd[m][n][3] + yc[m][n][3]));
      }
    }
    __syncthreads();          // (3) every read of the old state is done
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int r0 = 16 * hm[m] + g, r1 = r0 + 8;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = nc[n] - g + 2 * t4;
        if (hr0[m])
          *reinterpret_cast<float2*>(&sm.h[r0][col]) =
              make_float2(hd[m][n][0] + hc[m][n][0], hd[m][n][1] + hc[m][n][1]);
        if (hr1[m])
          *reinterpret_cast<float2*>(&sm.h[r1][col]) =
              make_float2(hd[m][n][2] + hc[m][n][2], hd[m][n][3] + hc[m][n][3]);
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < N * PS; e += kThreads)
    hout[sbase + static_cast<size_t>(e / PS) * P + e % PS] = sm.h[e / PS][e % PS];
}

template <int P, int N, int PS>
int scan_smem_bytes() {
  return static_cast<int>(sizeof(ScanSmem<N, PS>));
}

template <int P, int N, int PS>
cudaError_t configure() {
  static cudaError_t status = [] {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<P, N, PS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        scan_smem_bytes<P, N, PS>());
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(ssd_scan_kernel<P, N, PS>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }();
  return status;
}

template <int P, int N, int PS>
int launch(const float* x, const float* dt, const float* la, const float* Bm,
           const float* Cm, const float* h0, float* G, float* aux, float* y,
           float* hout, int B, int S, int H, cudaStream_t stream) {
  const int nch = (S + kC - 1) / kC;
  if (nch > 65535) return cudaErrorInvalidValue;
  if (nch > 0) {
    dim3 pg(kC / kGramRows, nch, B);
    ssd_prep_kernel<N><<<pg, 256, 0, stream>>>(Bm, Cm, la, dt, G, aux, S, H,
                                               B);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const cudaError_t e = configure<P, N, PS>();
  if (e != cudaSuccess) return e;
  dim3 grid(P / PS, H, B);
  ssd_scan_kernel<P, N, PS>
      <<<grid, ScanShape<PS>::kThreads, scan_smem_bytes<P, N, PS>(), stream>>>(
          x, Bm, Cm, G, aux, h0, y, hout, S, H, B);
  return cudaGetLastError();
}

template <int P, int N, int PS>
int occupancy(int* blocks_per_sm, int* slices) {
  const cudaError_t e = configure<P, N, PS>();
  if (e != cudaSuccess) return e;
  *slices = P / PS;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, ssd_scan_kernel<P, N, PS>, ScanShape<PS>::kThreads,
      scan_smem_bytes<P, N, PS>());
}

}  // namespace

// The (P, N) pairs a caller uses: Zamba2's (64, 64) and the reference
// kernel test's (16, 8) and (32, 16); add a pair when a config needs it. A
// scan block carries all P columns (PS = P; at Zamba2's shape PS = 32, two
// blocks per SM, ran slower).
#define REPRO_SSD_SHAPES(X) \
  X(64, 64)                 \
  X(16, 8)                  \
  X(32, 16)

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, S, H, P), dt and la (B, S, H), Bm and Cm (B, S, N), h0 (B, H, N, P),
// the scratch G (B, ceil(S / 64), 64, 64) and aux (4, B, H, ceil(S / 64),
// 64), and the outputs y (B, S, H, P), hout (B, H, N, P): float32,
// contiguous, on the device; x, Bm and Cm 16-byte aligned. (P, N) one of
// REPRO_SSD_SHAPES; S >= 0 (S = 0 copies h0 to hout). Launches the
// pre-pass, then the scan. Returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments the kernels do not take).
int ssd_chunked_launch(const void* x, const void* dt, const void* la,
                       const void* Bm, const void* Cm, const void* h0,
                       void* G, void* aux, void* y, void* hout, int B, int S,
                       int H, int P, int N, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S < 0 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* dp = static_cast<const float*>(dt);
  const float* lp = static_cast<const float*>(la);
  const float* bp = static_cast<const float*>(Bm);
  const float* cp = static_cast<const float*>(Cm);
  const float* hp = static_cast<const float*>(h0);
  float* gp = static_cast<float*>(G);
  float* ap = static_cast<float*>(aux);
  float* yp = static_cast<float*>(y);
  float* op = static_cast<float*>(hout);
#define REPRO_SSD_LAUNCH(PP, NN)                                          \
  if (P == PP && N == NN)                                                 \
    return launch<PP, NN, PP>(xp, dp, lp, bp, cp, hp, gp, ap, yp, op, B, S, \
                              H, st);
  REPRO_SSD_SHAPES(REPRO_SSD_LAUNCH)
#undef REPRO_SSD_LAUNCH
  return cudaErrorInvalidValue;
}

// How the scan kernel for (P, N) sits on this device: its blocks per SM
// (from the occupancy calculator, with its shared memory) and its column
// slices per head. Returns a cudaError_t.
int ssd_chunked_occupancy(int P, int N, int* blocks_per_sm, int* slices) {
#define REPRO_SSD_OCC(PP, NN) \
  if (P == PP && N == NN) return occupancy<PP, NN, PP>(blocks_per_sm, slices);
  REPRO_SSD_SHAPES(REPRO_SSD_OCC)
#undef REPRO_SSD_OCC
  return cudaErrorInvalidValue;
}

}  // extern "C"
