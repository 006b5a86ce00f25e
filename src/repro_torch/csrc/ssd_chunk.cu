// Chunked Mamba2 SSD scan on the H100: at Zamba2's (P, N) = (64, 64) a
// C . B^T pre-pass and a warp-specialised scan on TMA and wgmma
// (`ssd_gram_kernel`, `ssd_wgmma_kernel`); at the reference kernel test's
// (16, 8) and (32, 16) and at Granite-4.0-H's (64, 128) the pre-pass and
// mma.sync scan (`ssd_prep_kernel`, `ssd_scan_kernel`), below it.
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
// ~13.5 GFLOP of products run on the tensor cores as split 3xTF32
// products, three TF32 passes, 0.082 ms at a third of the 495 TFLOP/s TF32
// peak: bytes.
//
// What held the mma.sync design (0.627-0.629 ms) above that: the 32
// chunks of a head were a sequential loop of three barrier-separated
// phases each (M's exponentials, the products, the state's write-back),
// all of a block's warps in every phase; a block needed 160 KB of shared
// memory, so one ran on each SM and nothing overlapped its serial phases;
// its products went through mma.sync m16n8k8 and its copies through
// 16-byte cp.async, Ampere's tools.
//
// The Hopper design: `ssd_gram_kernel`, then `ssd_wgmma_kernel`, one block
// of four warpgroups per (head, batch row), steps of kT = 32 tokens. Of
// each step only two things depend on the carried state: the inter-step
// term of y and the update h <- e h + L; the intra-step product and the
// step's local state L do not. So:
//   * ssd_gram_kernel, fully parallel: G = C . B^T of each step's diagonal
//     32 x 32 block, once per batch row (shared by the heads), in FP32
//     FMAs into a scratch (B, steps, 32, 32) array;
//   * warpgroup 3, the producer (24 registers by setmaxnreg): one thread
//     keeps TMA loads of the next steps' x, Bm and Cm tiles (32 tokens x
//     64 f32, two 128-byte swizzled boxes each, described 4-D so that a
//     box past S reads zeros) in flight, kStages steps ahead, each stage a
//     full/empty mbarrier pair;
//   * warpgroups 0 and 1, chunk-parallel, the even and the odd steps, each
//     up to one step of its own ahead of the chain: the prefix sums of la
//     (each lane the sum up to its token, added left to right from the
//     plain version's 64-token chunk start, so every exponent has the
//     plain version's f32 rounding; an odd step first adds the even step's
//     32 values), M = G exp(cum_t - cum_s) dt_s, B'^T and C' =
//     C exp(cum_t - cum_start) written as hi / lo B images, and on wgmma
//     intra^T = x^T M^T (m64n32) and L^T = x^T B' (m64n64), x^T the
//     register A operand (no transpose of x in shared memory); each hands
//     intra^T, L^T, C' and e = exp(cum_end - cum_start) to the chain
//     through its own slot;
//   * warpgroup 2, the chain: per step one m64n32k64 product, y^T =
//     h^T C'^T + intra^T, with h^T the register A operand, and meanwhile
//     the elementwise h^T <- e h^T + L^T; y^T goes through a swizzled
//     staging tile to a TMA store (rows past S are not written).
// h^T is kept in registers in the A fragment's layout for the whole scan;
// it never goes through shared memory. A step factors its decays through
// the step's start: exp(cum_t - cum_start) (C' and e) and exp(cum_end -
// cum_s) (B'), each exponent <= 0; across the two steps of a 64-token
// chunk they multiply to the plain version's exp(cum_t) and
// exp(cum_last - cum_s). M is written whole: above the diagonal G is 0 and
// the exponent, positive there, is clamped to 0, so no exponent taken is
// positive and M is 0. Tokens past S load as zeros (x = B = C = 0; dt =
// la = 0 from the masked loads), which leaves the state unchanged, and
// their y is not stored, so any S works (the TPU kernel asserts
// S % chunk == 0). The grid is (H, B), 320 blocks at the engine's shape,
// one per SM (219 KB of shared memory, 512 threads): 2.42 waves.
//
// Candidates measured and dropped (development calls on an H100 80GB
// HBM3, engine shape, ms per call by CUDA events in a development driver
// that the repo does not keep; PERF.md): 16-token steps with G
// made per head in the block, one chunk-parallel warpgroup, 1.43; G by a
// pre-pass, factors by shuffles, 0.61; 32-token steps, 0.49; two
// chunk-parallel warpgroups in 416 threads without setmaxnreg (128
// registers, spills), 0.60; one chunk-parallel warpgroup with y by TMA
// store, every load before the stores, M without branches and the
// descriptors made once, 0.415; the factors on a spare warp of the
// producer warpgroup, 0.50 (it takes issue slots of the same schedulers).
// Kept: two chunk-parallel warpgroups at 512 threads, 0.412: no faster
// than one, since the two share the SM's schedulers with the chain, which
// is then the longer side (clock counters in a development build: the
// state's update and y's staging take most of its step).
//
// Built without --use_fast_math (IEEE expf).
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "scan_wgmma.cuh"
#include "tma.cuh"


// ---------------------------------------------------------------------------
// The mma.sync kernels, for (P, N) = (16, 8), (32, 16) and (64, 128): a
// parallel pre-pass and a scan on mma.sync.
//   * ssd_prep_kernel, one block of 8 warps per (quarter of a chunk's rows,
//     chunk, batch row), fully parallel: G = C . B^T, the s <= t triangle
//     of each (64 x 64) tile, in FP32 FMAs into a scratch (B, ceil(S/64),
//     64, 64) array, and per head the chunk's 64-long prefix sum of la,
//     lane 0 adding the values in order, with cum, exp(cum),
//     exp(cum_last - cum) * dt and dt into a scratch aux array;
//   * ssd_scan_kernel, one block of two warps per 16 columns per (column
//     slice, head, batch row), carrying an N x PS slice of the state in
//     shared memory; per chunk of kC = 64 tokens the next chunk's tiles in
//     flight by cp.async, M and B' in place, and y and the new state on
//     mma.sync m16n8k8 (3xTF32); three barriers per chunk.
// At (64, 128) a block of all 64 columns would need 247,808 bytes of
// shared memory (the double-buffered Bm and Cm tiles are 64 x 128 floats
// each), more than a block may have (232,448); in slices of PS = 32
// columns it needs 215,040, one block per SM, two slices a head. Each warp
// then carries four of the state's eight 16-row tiles (two at N <= 64).
// ---------------------------------------------------------------------------

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
  // the state's 16-row tiles each warp carries: the two warps of a column
  // group split the N rows, two tiles each up to N = 64
  constexpr int kHm = N > 64 ? N / 32 : 2;
  static_assert(PS == 16 || PS == 32 || PS == 64, "PS in {16, 32, 64}");
  static_assert(P % PS == 0 && N % 4 == 0 && (N <= 64 || N % 32 == 0) &&
                    N <= 128, "P, N");
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
  const int nc[2] = {16 * (w >> 1) + g, 16 * (w >> 1) + 8 + g};
  int hm[kHm];
  bool hon[kHm], hr0[kHm], hr1[kHm];            // state tile / rows present
#pragma unroll
  for (int m = 0; m < kHm; ++m) {
    hm[m] = kHm * par + m;
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
    float hd[kHm][2][4], hc[kHm][2][4] = {};
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
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          yd[m][n][i] = (yd[m][n][i] + yc[m][n][i]) * (i < 2 ? e0 : e1);
          yc[m][n][i] = 0.f;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kHm; ++m) {
      const int r0 = 16 * hm[m] + g, r1 = r0 + 8;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
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
      }
#pragma unroll
      for (int m = 0; m < kHm; ++m) {
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
    for (int m = 0; m < kHm; ++m) {
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

// ---------------------------------------------------------------------------
// (P, N) = (64, 64): the Hopper kernels
// ---------------------------------------------------------------------------

namespace ssd_hop {

namespace sc = repro_scan;
using repro_tma::mbar_arrive;
using repro_tma::mbar_expect_tx;
using repro_tma::mbar_wait;
using repro_tma::smem_u32;
using repro_tma::tma_load_4d;

constexpr int kP = 64, kN = 64;
constexpr int kT = 32;            // tokens per step: one lane each
constexpr int kGroup = 64;        // tokens per prefix-sum chunk (the plain
                                  // version's CHUNK)
constexpr int kStages = 3;        // steps of x, Bm, Cm in flight
// warpgroups 0 and 1: chunk-parallel (even and odd steps), 2: the chain,
// 3: the producer
constexpr int kThreads = 512;
constexpr int kImgT = kT * 128;   // a 32-row image of 32 f32 columns
constexpr int kImg64 = 64 * 128;  // a 64-row image
constexpr int kTile = 2 * kImgT;  // 32 tokens x 64 f32: two images
constexpr int kStage = 3 * kTile; // x, Bm, Cm
// shared memory, from a 1024-byte aligned base
constexpr int kRing = 0;
// per chunk-parallel warpgroup: M hi, lo (row t, k = s), B'^T hi, lo
// (row n, k = s)
constexpr int kBuild = kRing + kStages * kStage;
constexpr int kKd = 2 * kImgT;
constexpr int kBuildBytes = kKd + 2 * kImg64;
constexpr int kSlots = kBuild + 2 * kBuildBytes;
// a slot (one per chunk-parallel warpgroup): C' hi (two images), C' lo
// (two), intra^T (64 x 32), L^T (64 x 64), e
constexpr int kSlotQ = 0;
constexpr int kSlotIntra = 4 * kImgT;
constexpr int kSlotL = kSlotIntra + 64 * kT * 4;
constexpr int kSlotW = kSlotL + 64 * 64 * 4;
constexpr int kSlot = (kSlotW + 256 + 1023) / 1024 * 1024;
// y's staging for its TMA stores: two buffers of a 32 x 64 tile
constexpr int kYOut = kSlots + 2 * kSlot;
constexpr int kSmem = kYOut + 2 * kTile + 1024;   // + alignment slack
static_assert(kP == 64 && kN == 64 && kT == 32 && kGroup == 2 * kT,
              "one warpgroup's 64 rows; a chunk of two steps");

__device__ __forceinline__ float4 ld4(const unsigned char* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float ld1(const unsigned char* p) {
  return *reinterpret_cast<const float*>(p);
}
__device__ __forceinline__ void st_split(unsigned char* hi, unsigned char* lo,
                                         float v) {
  uint32_t h, l;
  sc::split_tf32(v, h, l);
  *reinterpret_cast<uint32_t*>(hi) = h;
  *reinterpret_cast<uint32_t*>(lo) = l;
}

}  // namespace ssd_hop

// The pre-pass: G = C . B^T of each 32-token step's diagonal block, shared
// by all heads (n_groups = 1), per (step, batch row): G[b][step][t][s] for
// s <= t, 0 above the diagonal, in FP32 FMAs (n from 0 to 63).
__global__ void __launch_bounds__(256)
ssd_gram_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                float* __restrict__ G, int S) {
  constexpr int kT = ssd_hop::kT, kN = ssd_hop::kN;
  __shared__ float Bs[kT][kN + 1];    // +1: the rows a warp reads differ
  __shared__ float Cs[kT][kN + 1];    // in bank
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int t0 = c * kT;
  for (int e = tid; e < kT * kN; e += 256) {
    const int t = e / kN, n = e % kN;
    const bool ok = t0 + t < S;
    const size_t off = (static_cast<size_t>(b) * S + (ok ? t0 + t : 0)) * kN
                       + n;
    Bs[t][n] = ok ? Bm[off] : 0.f;
    Cs[t][n] = ok ? Cm[off] : 0.f;
  }
  __syncthreads();
  float* Gc = G + (static_cast<size_t>(b) * gridDim.x + c) * kT * kT;
  for (int e = tid; e < kT * kT; e += 256) {
    const int t = e / kT, s = e % kT;
    float g = 0.f;
    if (s <= t) {
#pragma unroll 16
      for (int n = 0; n < kN; ++n) g = fmaf(Cs[t][n], Bs[s][n], g);
    }
    Gc[e] = g;
  }
}

// One block per (head, batch row): two chunk-parallel warpgroups (even
// and odd steps), the chain and the producer (see the note at the top).
__global__ void __launch_bounds__(ssd_hop::kThreads, 1)
ssd_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tc,
                 const __grid_constant__ CUtensorMap ty,
                 const float* __restrict__ dt, const float* __restrict__ la,
                 const float* __restrict__ G, const float* __restrict__ h0,
                 float* __restrict__ hout, int S, int H) {
  using namespace ssd_hop;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ __align__(8) uint64_t slot_full[2];
  __shared__ __align__(8) uint64_t slot_empty[2];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int nstep = (S + kT - 1) / kT;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      repro_tma::mbar_init(&full[s], 1);
      repro_tma::mbar_init(&empty[s], 128);
    }
    for (int q = 0; q < 2; ++q) {
      repro_tma::mbar_init(&slot_full[q], 128);
      repro_tma::mbar_init(&slot_empty[q], 128);
    }
    repro_tma::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 3) {
    // the producer: stage s is refilled once the chunk-parallel
    // warpgroup of its step has released it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 3 * 128) {
      for (int c = 0; c < nstep; ++c) {
        const int s = c % kStages;
        mbar_wait(&empty[s], ((c / kStages) & 1) ^ 1);
        unsigned char* st = base + kRing + s * kStage;
        mbar_expect_tx(&full[s], kStage);
        for (int a = 0; a < 2; ++a) {
          tma_load_4d(st + a * kImgT, &tx, &full[s], 32 * a, h, c * kT, b);
          tma_load_4d(st + kTile + a * kImgT, &tb, &full[s], 32 * a, 0,
                      c * kT, b);
          tma_load_4d(st + 2 * kTile + a * kImgT, &tc, &full[s], 32 * a, 0,
                      c * kT, b);
        }
      }
    }
  } else if (wg < 2) {
    // chunk-parallel warpgroup `wg`: the steps c = wg, wg + 2, ...; an odd
    // step is a chunk's second half, whose prefix sums start from the even
    // step's total
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
    const int bt = tid & 127, w = bt >> 5, lane = bt & 31;
    const int g = lane >> 2, t4 = lane & 3;
    unsigned char* const scp = base + kBuild + wg * kBuildBytes;   // M
    unsigned char* const kdp = scp + kKd;                          // B'^T
    const uint64_t sc_hd = sc::bdesc(smem_u32(scp), 0);
    const uint64_t sc_ld = sc_hd + sc::dbytes(kImgT);
    const uint64_t kd_hd = sc::bdesc(smem_u32(kdp), 0);
    const uint64_t kd_ld = kd_hd + sc::dbytes(kImg64);
    const unsigned full_mask = 0xffffffffu;
    // each warp's copy of this head's dt and la (token `lane` of a step)
    // and the thread's entries bt + 128 r of G, a step ahead
    const size_t hb = static_cast<size_t>(b) * S * H + h;
    const float* Gb = G + static_cast<size_t>(b) * nstep * kT * kT;
    auto at = [&](const float* a, int t) {
      return t < S ? a[hb + static_cast<size_t>(t) * H] : 0.f;
    };
    float la_r = at(la, wg * kT + lane), dt_r = at(dt, wg * kT + lane);
    float la_p = wg ? at(la, lane) : 0.f;  // la of the step before
    float gn[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      gn[r] = wg < nstep ? Gb[wg * kT * kT + bt + 128 * r] : 0.f;

    for (int c = wg; c < nstep; c += 2) {
      const int s = c % kStages, q = wg, t0 = c * kT;
      const unsigned char* xs = base + kRing + s * kStage;
      const unsigned char* bs = xs + kTile;
      const unsigned char* cs = xs + 2 * kTile;
      unsigned char* slot = base + kSlots + q * kSlot;

      // the step's prefix sums, left to right from the chunk's start (each
      // lane the sum up to its token), and the factors of its token
      float c0 = 0.f;
      if (wg) {
#pragma unroll
        for (int j = 0; j < kT; ++j) c0 += __shfl_sync(full_mask, la_p, j);
      }
      float lav[kT];
#pragma unroll
      for (int j = 0; j < kT; ++j) lav[j] = __shfl_sync(full_mask, la_r, j);
      float cum = c0;
#pragma unroll
      for (int j = 0; j < kT; ++j) cum = j <= lane ? cum + lav[j] : cum;
      const float c1 = __shfl_sync(full_mask, cum, kT - 1);
      const float dtv = dt_r;
      const float qf = expf(cum - c0);             // C' factor of the token
      const float kf = expf(c1 - cum) * dtv;       // B' factor
      const float ev = expf(c1 - c0);              // the state's decay
      float gc[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) gc[r] = gn[r];
      la_r = at(la, t0 + 2 * kT + lane);          // step c + 2's
      dt_r = at(dt, t0 + 2 * kT + lane);
      if (wg) la_p = at(la, t0 + kT + lane);
      if (c + 2 < nstep) {
#pragma unroll
        for (int r = 0; r < 8; ++r)
          gn[r] = Gb[(c + 2) * kT * kT + bt + 128 * r];
      }
      mbar_wait(&full[s], (c / kStages) & 1);

      // M[t][s] = G[t][s] exp(cum_t - cum_s) dt_s: row t = 4 r + w, column
      // s = lane, every entry of the 32 x 32 block. Above the diagonal G is
      // 0, and the exponent, positive there, is clamped to 0, so M is 0 and
      // every exponent taken is <= 0.
      {
        float ct[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          ct[r] = __shfl_sync(full_mask, cum, 4 * r + w);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const uint32_t off = sc::img_off(4 * r + w, lane);
          st_split(scp + off, scp + kImgT + off,
                   gc[r] * expf(fminf(ct[r] - cum, 0.f)) * dtv);
        }
      }
      // B'^T[n][s] = B_s[n] exp(cum_end - cum_s) dt_s: token s = lane, 16
      // columns n0 .. n0 + 15
      {
        const int n0 = 16 * w;
        const unsigned char* bi = bs + (n0 >> 5) * kImgT;
        float4 v[4];                   // every load before the first store
#pragma unroll
        for (int m = 0; m < 4; ++m)
          v[m] = ld4(bi + sc::img_off(lane, (n0 & 31) + 4 * m));
        // row n0 + e (n0 a multiple of 16), column lane: the swizzle
        // flips the column's chunk by (e % 8)
        unsigned char* kd = kdp + n0 * 128;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float vals[4] = {v[m].x * kf, v[m].y * kf, v[m].z * kf,
                                 v[m].w * kf};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int e = 4 * m + i;
            const uint32_t off = e * 128 + ((4 * lane) ^ ((e & 7) << 4));
            st_split(kd + off, kd + kImg64 + off, vals[i]);
          }
        }
      }
      // x^T as the A operand: rows p = 16w + g (+ 8), k = token
      uint32_t xh[4][4], xl[4][4];
      {
        // rows 8j + t4 (+ 4), columns pc (+ 8) of x's image: the swizzle
        // flips a column's chunk by the row % 8, t4 (+ 4) here
        const unsigned char* xi = xs + (w >> 1) * kImgT + t4 * 128;
        const int pc = 16 * (w & 1) + g;
        const uint32_t o0 = (4 * pc) ^ (t4 << 4);
        const uint32_t o1 = (4 * pc + 32) ^ (t4 << 4);
        const uint32_t o2 = 512 + ((4 * pc) ^ ((t4 + 4) << 4));
        const uint32_t o3 = 512 + ((4 * pc + 32) ^ ((t4 + 4) << 4));
        float xv[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned char* row = xi + 8 * j * 128;
          xv[j][0] = ld1(row + o0);
          xv[j][1] = ld1(row + o1);
          xv[j][2] = ld1(row + o2);
          xv[j][3] = ld1(row + o3);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            sc::split_tf32(xv[j][i], xh[j][i], xl[j][i]);
      }
      sc::fence_async_smem();
      sc::wg_bar(1 + wg, 128);

      // intra^T = x^T M^T (m64n32) and L^T = x^T B' (m64n64), k = 32 tokens
      float ia[16], lacc[32];
#pragma unroll
      for (int i = 0; i < 16; ++i) ia[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) lacc[i] = 0.f;
      sc::hold(ia);
      sc::hold(lacc);
      sc::hold(xh);
      sc::hold(xl);
      sc::wg_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc::mma3<32>(ia, ia, xh[j], xl[j], sc_hd + sc::kstep(j),
                     sc_ld + sc::kstep(j));
        sc::mma3<64>(lacc, lacc, xh[j], xl[j], kd_hd + sc::kstep(j),
                     kd_ld + sc::kstep(j));
      }
      sc::wg_commit();

      // meanwhile: C' = C exp(cum_t - cum_start) and e into the slot (512
      // float4 of C: row t = (bt + 128 r) / 16)
      float4 cv[4];
      float qt[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = bt + 128 * r, t = e >> 4, n = 4 * (e & 15);
        qt[r] = __shfl_sync(full_mask, qf, t);
        cv[r] = ld4(cs + (n >> 5) * kImgT + sc::img_off(t, n & 31));
      }
      mbar_wait(&slot_empty[q], ((c >> 1) & 1) ^ 1);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = bt + 128 * r, t = e >> 4, n = 4 * (e & 15);
        const int off = (n >> 5) * kImgT + sc::img_off(t, n & 31);
        uint4 hi, lo;
        sc::split_tf32(cv[r].x * qt[r], hi.x, lo.x);
        sc::split_tf32(cv[r].y * qt[r], hi.y, lo.y);
        sc::split_tf32(cv[r].z * qt[r], hi.z, lo.z);
        sc::split_tf32(cv[r].w * qt[r], hi.w, lo.w);
        *reinterpret_cast<uint4*>(slot + kSlotQ + off) = hi;
        *reinterpret_cast<uint4*>(slot + kSlotQ + 2 * kImgT + off) = lo;
      }
      if (bt == 0) reinterpret_cast<float*>(slot + kSlotW)[0] = ev;
      sc::fence_async_smem();
      mbar_arrive(&empty[s]);                 // stage s is read

      sc::wg_wait<0>();
      sc::hold(ia);
      sc::hold(lacc);
      sc::hold(xh);
      sc::hold(xl);
      float* si = reinterpret_cast<float*>(slot + kSlotIntra);
#pragma unroll
      for (int i = 0; i < 16; ++i) si[i * 128 + bt] = ia[i];
      float* sl = reinterpret_cast<float*>(slot + kSlotL);
      const int r0 = 16 * w + g;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = 8 * jj + 2 * t4;
        *reinterpret_cast<float2*>(sl + sc::handoff_idx(r0, col)) =
            make_float2(lacc[4 * jj], lacc[4 * jj + 1]);
        *reinterpret_cast<float2*>(sl + sc::handoff_idx(r0 + 8, col)) =
            make_float2(lacc[4 * jj + 2], lacc[4 * jj + 3]);
      }
      mbar_arrive(&slot_full[q]);
      sc::wg_bar(1 + wg, 128);           // every warp's products are done
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
    const int ct = tid & 127, w = ct >> 5, lane = ct & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int p0 = 16 * w + g;
    // h^T in the A fragment's layout: hs[j][r] = h^T[p0 + 8 (r & 1)]
    // [8j + t4 + 4 (r >> 1)] = h[n][p]
    const size_t sbase = (static_cast<size_t>(b) * H + h) * kN * kP;
    float hs[8][4];
    uint32_t ah[8][4], al[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = p0 + 8 * (r & 1), n = 8 * j + t4 + 4 * (r >> 1);
        hs[j][r] = h0[sbase + static_cast<size_t>(n) * kP + p];
        sc::split_tf32(hs[j][r], ah[j][r], al[j][r]);
      }

    for (int c = 0; c < nstep; ++c) {
      const int q = c & 1;
      const unsigned char* slot = base + kSlots + q * kSlot;
      unsigned char* yo = base + kYOut + q * kTile;
      mbar_wait(&slot_full[q], (c >> 1) & 1);
      float ya[16], yc[16];
      const float* si = reinterpret_cast<const float*>(slot + kSlotIntra);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        ya[i] = si[i * 128 + ct];
        yc[i] = 0.f;
      }
      const uint64_t qh = sc::bdesc(smem_u32(slot + kSlotQ), 0);
      const uint64_t ql = qh + sc::dbytes(2 * kImgT);
      sc::hold(ya);
      sc::hold(yc);
      sc::hold(ah);
      sc::hold(al);
      sc::wg_fence();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint64_t k = sc::dbytes((j >> 2) * kImgT) + sc::kstep(j & 3);
        sc::mma3<32>(ya, yc, ah[j], al[j], qh + k, ql + k);
      }
      sc::wg_commit();
      // meanwhile the state: h^T <- e h^T + L^T
      const float e = reinterpret_cast<const float*>(slot + kSlotW)[0];
      const float* sl = reinterpret_cast<const float*>(slot + kSlotL);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = p0 + 8 * (r & 1), n = 8 * j + t4 + 4 * (r >> 1);
          hs[j][r] = fmaf(hs[j][r], e, sl[sc::handoff_idx(p, n)]);
        }
      // y's staging buffer q is free once the TMA store of two steps ago
      // has read it
      if (ct == 0) repro_tma::bulk_wait_read<1>();
      sc::wg_wait<0>();
      sc::hold(ya);
      sc::hold(yc);
      sc::hold(ah);
      sc::hold(al);
      sc::wg_bar(3, 128);
      // y^T[p][t] into the staging tile (row t, column p, as TMA's box):
      // ya[4 jj + r] at p0 + 8 (r >> 1), t = 8 jj + 2 t4 + (r & 1)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = p0 + 8 * (r >> 1), t = 8 * jj + 2 * t4 + (r & 1);
          *reinterpret_cast<float*>(yo + (p >> 5) * kImgT +
                                    sc::img_off(t, p & 31)) =
              ya[4 * jj + r] + yc[4 * jj + r];
        }
      sc::fence_async_smem();
      sc::wg_bar(3, 128);
      if (ct == 0) {
        repro_tma::tma_store_4d(&ty, yo, 0, h, c * kT, b);
        repro_tma::tma_store_4d(&ty, yo + kImgT, 32, h, c * kT, b);
        repro_tma::bulk_commit();
      }
      mbar_arrive(&slot_empty[q]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          sc::split_tf32(hs[j][r], ah[j][r], al[j][r]);
    }
    if (ct == 0) repro_tma::bulk_wait<0>();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = p0 + 8 * (r & 1), n = 8 * j + t4 + 4 * (r >> 1);
        hout[sbase + static_cast<size_t>(n) * kP + p] = hs[j][r];
      }
  }
}

namespace ssd_hop {

cudaError_t configure() {
  static cudaError_t status = cudaFuncSetAttribute(
      ssd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  return status;
}

int launch(const float* x, const float* dt, const float* la, const float* Bm,
           const float* Cm, const float* h0, float* G, float* y, float* hout,
           int B, int S, int H, cudaStream_t stream) {
  const int nstep = (S + kT - 1) / kT;
  CUtensorMap mx, mb, mc, my;
  if (S > 0) {
    if (!repro_tma::tensor_map(&mx, x, B, S, H, kP, kT, 32, 4) ||
        !repro_tma::tensor_map(&mb, Bm, B, S, 1, kN, kT, 32, 4) ||
        !repro_tma::tensor_map(&mc, Cm, B, S, 1, kN, kT, 32, 4) ||
        !repro_tma::tensor_map(&my, y, B, S, H, kP, kT, 32, 4))
      return cudaErrorInvalidValue;
    ssd_gram_kernel<<<dim3(nstep, B), 256, 0, stream>>>(Bm, Cm, G, S);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  } else {                // nothing is loaded: the kernel copies h0
    memset(&mx, 0, sizeof(mx));
    memset(&mb, 0, sizeof(mb));
    memset(&mc, 0, sizeof(mc));
    memset(&my, 0, sizeof(my));
  }
  const cudaError_t e = configure();
  if (e != cudaSuccess) return e;
  ssd_wgmma_kernel<<<dim3(H, B), kThreads, kSmem, stream>>>(
      mx, mb, mc, my, dt, la, G, h0, hout, S, H);
  return cudaGetLastError();
}

}  // namespace ssd_hop

// The (P, N) pairs the mma.sync kernels serve, each with the columns PS a
// block carries: the reference kernel test's (16, 8) and (32, 16), all P
// columns; Granite-4.0-H's (64, 128), slices of 32 (shared memory). Zamba2's
// (64, 64) is ssd_wgmma_kernel's.
#define REPRO_SSD_SHAPES(X) \
  X(16, 8, 16)              \
  X(32, 16, 32)             \
  X(64, 128, 32)

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, S, H, P), dt and la (B, S, H), Bm and Cm (B, S, N), h0 (B, H, N, P)
// and the outputs y (B, S, H, P), hout (B, H, N, P): float32, contiguous,
// on the device; x, Bm and Cm 16-byte aligned. (P, N) = (64, 64) launches
// ssd_gram_kernel, then ssd_wgmma_kernel, with the scratch G
// (B, ceil(S / 32), 32, 32) (aux unused, may be null); a pair of
// REPRO_SSD_SHAPES launches the mma.sync pre-pass, then its scan, with the
// scratch G (B, ceil(S / 64), 64, 64) and aux (4, B, H, ceil(S / 64), 64).
// S >= 0 (S = 0 copies h0 to hout). Returns cudaGetLastError()
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
  if (P == ssd_hop::kP && N == ssd_hop::kN)
    return ssd_hop::launch(xp, dp, lp, bp, cp, hp, gp, yp, op, B, S, H, st);
#define REPRO_SSD_LAUNCH(PP, NN, PS)                                      \
  if (P == PP && N == NN)                                                 \
    return launch<PP, NN, PS>(xp, dp, lp, bp, cp, hp, gp, ap, yp, op, B, S, \
                              H, st);
  REPRO_SSD_SHAPES(REPRO_SSD_LAUNCH)
#undef REPRO_SSD_LAUNCH
  return cudaErrorInvalidValue;
}

// How the scan kernel for (P, N) sits on this device: its blocks per SM
// (from the occupancy calculator, with its shared memory) and its column
// slices per head (P / PS; 1 where a block carries all P columns). Returns
// a cudaError_t.
int ssd_chunked_occupancy(int P, int N, int* blocks_per_sm, int* slices) {
  if (P == ssd_hop::kP && N == ssd_hop::kN) {
    const cudaError_t e = ssd_hop::configure();
    if (e != cudaSuccess) return e;
    *slices = 1;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, ssd_wgmma_kernel, ssd_hop::kThreads, ssd_hop::kSmem);
  }
#define REPRO_SSD_OCC(PP, NN, PS) \
  if (P == PP && N == NN) return occupancy<PP, NN, PS>(blocks_per_sm, slices);
  REPRO_SSD_SHAPES(REPRO_SSD_OCC)
#undef REPRO_SSD_OCC
  return cudaErrorInvalidValue;
}

// The scan kernel for (P, N): its dynamic shared memory per block in bytes
// and its threads per block. Returns a cudaError_t.
int ssd_chunked_smem(int P, int N, int* bytes, int* threads) {
  if (P == ssd_hop::kP && N == ssd_hop::kN) {
    *bytes = ssd_hop::kSmem;
    *threads = ssd_hop::kThreads;
    return 0;
  }
#define REPRO_SSD_SMEM(PP, NN, PS)              \
  if (P == PP && N == NN) {                     \
    *bytes = scan_smem_bytes<PP, NN, PS>();     \
    *threads = ScanShape<PS>::kThreads;         \
    return 0;                                   \
  }
  REPRO_SSD_SHAPES(REPRO_SSD_SMEM)
#undef REPRO_SSD_SMEM
  return cudaErrorInvalidValue;
}

}  // extern "C"
