// Blocked causal GQA flash attention with an online softmax: two kernels,
// one per input type.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` of
// src/repro/kernels/flash_attention.py: q (B, Sq, Hq, D), k and v
// (B, Sk, Hkv, D) in bf16 or f32, output (B, Sq, Hq, D) in q's dtype.
// Query head h reads KV head h / (Hq / Hkv): GQA is resolved by indexing,
// never by repeating KV. Causal masking aligns query and key positions at 0
// (key j is visible to query i iff j <= i), as the reference does. Any S
// works: the ragged tail is masked in the kernel (the TPU kernel required
// S % block == 0). The output is acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on the H100: arithmetic. At the engine's prefill shapes
// (B = 4, S = 1024-2048, D = 64-80) the causal QK^T and PV are 10-86 GFLOP
// against 4-84 MB of q, k, v and output, hundreds of FLOP per byte, so
// the ceiling is the tensor cores' 989 TFLOP/s in bf16 (67 TFLOP/s for
// FP32 FMAs outside them). The scores never leave the SM.
//
// bf16: flash_bf16_mma_kernel, on the tensor cores.
//   * One block of 4 warps per (64-row query tile, query head, batch row);
//     each warp owns 16 query rows. The Q tile's fragments are loaded once
//     into registers with ldmatrix. Q is not pre-scaled in bf16: the f32
//     scores are multiplied by log2(e)/sqrt(D) after the product (in the
//     FMA that feeds exp2), so no scale (D = 80's 1/sqrt(80) included) is
//     ever rounded to bf16.
//   * 64-key K and V tiles are staged in shared memory as bf16, in a
//     two-stage ring filled by 16-byte cp.async copies: the next tile's
//     copy is in flight while the current one is computed. Rows are padded
//     by 16 bytes, so the 8 rows an ldmatrix reads fall in distinct banks.
//     Rows past Sk are zero-filled by the copy itself (src-size 0).
//   * QK^T and PV are mma.sync.m16n8k16 with bf16 inputs and f32
//     accumulation; V is read with ldmatrix.trans. The online softmax (row
//     max and sum by quad shuffles, the m == -inf guard) stays in f32
//     registers, each thread summing its own share of l until the end.
//   * P is rounded to bf16 in registers and reused as the A operand of PV:
//     the one rounding the plain version does not make (relative error at
//     most 2^-9 per p, the order of the bf16 output cast). l sums the f32
//     p.
//   * The causal and ragged-tail masks are applied only on the tiles that
//     need them (a warp's diagonal tile, the tile holding Sk). Query tiles
//     launch heaviest first (reverse tile order) to shorten the causal
//     tail, and the query heads of one tile are adjacent in launch order,
//     so a KV group's tiles are served from L2 to its G heads.
//   * Shared memory 640 * (D + 8) bytes (87 KB at D = 128), set through
//     cudaFuncSetAttribute above 48 KB.
//
// f32: flash_f32_kernel, FP32 FMAs (TF32 tensor cores would break the
// 2e-4 tolerance and the f32 token parity).
//   * one block of 128 threads per (query tile of 64 rows, query head,
//     batch); two threads per query row, each owning 32 of the tile's 64
//     keys for the scores and D/2 interleaved output columns for PV;
//   * K/V tiles of 64 keys are staged in shared memory as f32 (rows padded
//     to D+1 words against bank conflicts), loaded synchronously; the
//     running (m, l, acc) of the online softmax stay in f32 registers;
//   * q is scaled by 1/sqrt(D) in f32 before the QK^T product, as in the
//     reference kernel;
//   * causal blocks loop over KV tiles only up to the tile's last query
//     row; masked keys get probability exactly 0. Every row sees key 0 in
//     its first tile, so the running max is finite from the first tile on.
// Built without --use_fast_math (IEEE expf and division).
#include <cuda_bf16.h>
#include <math.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per KV tile
constexpr int kThreads = 128; // f32: two threads per query row; bf16: 4 warps
constexpr int kHalfK = kBK / 2;

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with full == false the 16 bytes are
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
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

template <int D>
constexpr int mma_smem_bytes() {
  // Q tile + two stages of K and V tiles, rows of D + 8 bf16
  return (kBQ + 4 * kBK) * (D + 8) * 2;
}

// The minimum of 2 blocks per SM changes only ptxas's register choice (146
// rather than 133 at D = 80), which timed faster at D = 80 on the H100.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bf16_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, int Sq, int Sk, int Hq,
                      int Hkv, float scale_log2, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DP = D + 8;        // padded row, in bf16
  constexpr int CH = D / 8;        // 16-byte chunks per row
  constexpr int KS = D / 16;       // k-steps of QK^T
  constexpr int NB = D / 8;        // 8-wide column blocks of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * DP;           // 2 stages of kBK x DP
  __nv_bfloat16* Vs = Ks + 2 * kBK * DP;       // 2 stages of kBK x DP

  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = qt * kBQ;

  const int64_t q_stride = static_cast<int64_t>(Hq) * D;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * D;
  const __nv_bfloat16* qb = q + static_cast<int64_t>(b) * Sq * q_stride +
                            static_cast<int64_t>(h) * D;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * Sk * kv_stride +
                            static_cast<int64_t>(hk) * D;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * Sk * kv_stride +
                            static_cast<int64_t>(hk) * D;

  for (int i = tid; i < kBQ * CH; i += kThreads) {
    const int r = i / CH, c = i - r * CH;
    const int pos = q0 + r;
    const bool ok = pos < Sq;
    cp_async16(Qs + r * DP + c * 8,
               qb + static_cast<int64_t>(ok ? pos : 0) * q_stride + c * 8, ok);
  }
  auto load_kv = [&](int t, int stage) {
    __nv_bfloat16* ks = Ks + stage * kBK * DP;
    __nv_bfloat16* vs = Vs + stage * kBK * DP;
    for (int i = tid; i < kBK * CH; i += kThreads) {
      const int r = i / CH, c = i - r * CH;
      const int pos = t * kBK + r;
      const bool ok = pos < Sk;
      const int64_t off = static_cast<int64_t>(ok ? pos : 0) * kv_stride + c * 8;
      cp_async16(ks + r * DP + c * 8, kb + off, ok);
      cp_async16(vs + r * DP + c * 8, vb + off, ok);
    }
  };

  cp_async_commit();                               // group 0: the Q tile
  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) {
    const int last = min(q0 + kBQ, Sq) - 1;       // last real row of the tile
    n_tiles = min(n_tiles, last / kBK + 1);
  }
  load_kv(0, 0);
  cp_async_commit();                               // group 1: KV tile 0

  const int g = lane >> 2;                         // row within 8
  const int tg = lane & 3;                         // column pair
  const int wrow = q0 + warp * 16;                 // the warp's first row
  const int row0 = wrow + g;                       // rows row0, row0 + 8
  const int mi = lane >> 3;                        // ldmatrix: which matrix
  const int mr = lane & 7;                         // ldmatrix: which row

  cp_async_wait<1>();                              // the Q tile has landed
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * DP + kk * 16 +
                        (lane >> 4) * 8);
  float o[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.0f, 0.0f};

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1, (t + 1) & 1);                 // stage freed at t - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = Ks + (t & 1) * kBK * DP;
    const __nv_bfloat16* vs = Vs + (t & 1) * kBK * DP;
    const int k0 = t * kBK;

    // S = Q K^T: 16 rows x 64 keys per warp, eight 16x8 blocks
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];   // keys np*16 + 0-7 and + 8-15, d kk*16 + 0-15
        ldsm_x4(bk, ks + (np * 16 + (mi >> 1) * 8 + mr) * DP + kk * 16 +
                        (mi & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // mask where this warp's tile needs it (the diagonal, the tail past Sk)
    if ((k0 + kBK > Sk) || (causal && k0 + kBK - 1 > wrow)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + 2 * tg + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (key >= Sk || (causal && key > row)) s[j][e] = -INFINITY;
        }
      }
    }

    // online softmax, rows row0 (e = 0, 1) and row0 + 8 (e = 2, 3); the
    // running max m_r is kept scaled (log2 units), the scores raw: the
    // scale enters in f32 as p = 2^(s * scale_log2 - m), one FMA
    float alpha[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx * scale_log2);
      alpha[r] = (m_r[r] == -INFINITY) ? 0.0f : exp2f(m_r[r] - m_new);
      base[r] = (m_new == -INFINITY) ? 0.0f : m_new;
      m_r[r] = m_new;
    }
    float psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[j][e], scale_log2, -base[e >> 1]));
        s[j][e] = p;
        psum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + psum[r];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P from the score registers, rounded to bf16
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
      pa[1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
      pa[2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      pa[3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
#pragma unroll
      for (int dp = 0; dp < NB / 2; ++dp) {
        uint32_t bv[4];   // keys kt*16 + 0-15, d dp*16 + 0-7 and + 8-15
        ldsm_x4_trans(bv, vs + (kt * 16 + (mi & 1) * 8 + mr) * DP + dp * 16 +
                              (mi >> 1) * 8);
        mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();                               // stage t & 1 consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + r * 8;
    if (row < Sq) {
      const float den = fmaxf(l, 1e-30f);
      __nv_bfloat16* orow = out + (static_cast<int64_t>(b) * Sq + row) * q_stride +
                            static_cast<int64_t>(h) * D;
#pragma unroll
      for (int n = 0; n < NB; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * tg) =
            __floats2bfloat162_rn(o[n][2 * r] / den, o[n][2 * r + 1] / den);
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
                cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>();
  static bool configured = false;   // once per instantiation and process
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bf16_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  if (n_qt > 65535 || B > 65535) return cudaErrorInvalidValue;
  dim3 grid(Hq, n_qt, B);
  const float scale_log2 = scale * 1.4426950408889634f;   // log2(e)
  flash_bf16_mma_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Sq, Sk, Hq, Hkv, scale_log2, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 on FP32 FMAs
// ---------------------------------------------------------------------------

template <int D>
constexpr int smem_floats() {
  // Q, K, V tiles at stride D+1, P tile at stride kBK+1
  return 3 * kBQ * (D + 1) + kBQ * (kBK + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
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
  const float* qb = q + (static_cast<int64_t>(b) * Sq) * q_stride + static_cast<int64_t>(h) * D;
  const float* kb = k + (static_cast<int64_t>(b) * Sk) * kv_stride + static_cast<int64_t>(hk) * D;
  const float* vb = v + (static_cast<int64_t>(b) * Sk) * kv_stride + static_cast<int64_t>(hk) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, c = i - rr * D;
    const int pos = q0 + rr;
    Qs[rr * DS + c] = (pos < Sq) ? qb[pos * q_stride + c] * scale : 0.0f;
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
      Ks[rr * DS + c] = ok ? kb[pos * kv_stride + c] : 0.0f;
      Vs[rr * DS + c] = ok ? vb[pos * kv_stride + c] : 0.0f;
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
    float* orow = out + (static_cast<int64_t>(b) * Sq + qrow) * q_stride + static_cast<int64_t>(h) * D;
#pragma unroll
    for (int c = 0; c < DH; ++c) orow[2 * c + half] = acc[c] / den;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
               cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  static bool configured = false;   // once per instantiation and process
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, Hq, Hkv,
      scale, causal);
  return cudaGetLastError();
}

template <bool kBf16>
int launch_d(int D, const void* q, const void* k, const void* v, void* out,
             int B, int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
             cudaStream_t s) {
#define REPRO_FLASH_CASE(DD)                                                  \
  case DD:                                                                    \
    return kBf16 ? launch_bf16<DD>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale,   \
                                   causal, s)                                 \
                 : launch_f32<DD>(q, k, v, out, B, Sq, Sk, Hq, Hkv, scale,    \
                                  causal, s);
  switch (D) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(80)
    REPRO_FLASH_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16. Tensors contiguous in (B, S, H, D) and
// 16-byte aligned. D in {16, 32, 64, 80, 128}; Hq % Hkv == 0. Returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments the kernels do
// not take).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                           int D, int dtype, float scale, int causal,
                           void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<false>(D, q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, s);
  if (dtype == 1)
    return launch_d<true>(D, q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
