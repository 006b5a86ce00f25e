// Blocked causal GQA flash attention with an online softmax: three kernels,
// chosen by input type and head dim.
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
// (B = 4, S = 1024-2048, D = 64-128) the causal QK^T and PV are 10-200
// GFLOP against 4-100 MB of q, k, v and output, hundreds of FLOP per byte,
// so the ceiling is the tensor cores' 989 TFLOP/s in bf16 (67 TFLOP/s for
// FP32 FMAs outside them). The scores never leave the SM.
//
// Which kernel serves which call (the wrapper names it,
// `kernels/flash_attention.py` `flash_kernel`):
//   bf16, D = 64, 80, 128   flash_bf16_wgmma_kernel<D, NC>: NC = 1 consumer
//                           warpgroup (64 query rows) when Sq <= 64, else 2
//   bf16, D = 16, 32        flash_bf16_mma_kernel<D> (mma.sync; these head
//                           dims appear only in reduced configs)
//   f32, every D            flash_f32_kernel<D> (FP32 FMAs)
//
// Numerics of both bf16 kernels (the tests' emulation): Q is not
// pre-scaled in bf16; the f32 scores are multiplied by log2(e)/sqrt(D) in
// the FMA that feeds exp2, so no scale (D = 80's 1/sqrt(80) included) is
// ever rounded to bf16. (The wgmma kernel takes exp2 as ex2.approx.ftz,
// exp2f's approximation without its subnormal fix-up.) The online softmax (row max and sum by quad
// shuffles, the m == -inf guard) stays in f32 registers, each thread
// summing its own share of l until the end. P is rounded to bf16 as the A
// operand of PV: the one rounding the plain version does not make
// (relative error at most 2^-9 per p, the order of the bf16 output cast).
// l sums the f32 p. The causal and ragged-tail masks are applied only on
// the tiles that need them (the diagonal, the tile holding Sk). Query tiles
// launch heaviest first (reverse tile order) to shorten the causal tail,
// and the query heads of one tile are adjacent in launch order, so a KV
// group's tiles are served from L2 to its G heads.
//
// bf16 on wgmma (the Hopper design; the mma.sync kernel below ran 228
// TFLOP/s at D = 128 with 198 registers, a quarter of the peak: every warp
// loaded, waited and multiplied in turn, and mma.sync cannot reach the
// tensor cores' full rate):
//   * one producer warpgroup drops to 24 registers (setmaxnreg) and one
//     of its threads issues every load by TMA (src/repro_torch/csrc/
//     tma.cuh): the block's Q tile once, then 128-key K and V tiles into a
//     two-stage ring, each stage with a full barrier per tensor (the
//     consumers start QK^T as soon as K lands, V may still be in flight)
//     and an empty barrier that every consumer warp arrives on when its PV
//     has read the stage. Tensors are 4-D maps (D, H, S, B), so a tile past
//     Sq or Sk reads zeros, never the next batch row;
//   * NC consumer warpgroups (240 registers each) own 64 query rows each:
//     S = Q K^T by wgmma.mma_async m64n128k16 with both operands in
//     swizzled shared memory (K-major descriptors), f32 accumulators in
//     registers; the softmax on the accumulator fragments; O += P V by
//     m64n64k16 (m64n16k16 for D = 80's last 16 columns) with P from
//     registers and V read MN-major through the descriptor's transpose bit.
//     The two warpgroups run at once, so one's softmax overlaps the
//     other's products. Measured on the H100 and not kept: a third ring
//     stage, issuing tile t's QK^T with tile t - 1's PV to overlap the
//     softmax within a warpgroup (10-20% slower), named-barrier turns
//     between the warpgroups and D = 128's PV as one m64n128k16 (both
//     within 1%), three consumer warpgroups over 64-key tiles (1-15%
//     slower causal);
//   * head dims are cut into images of whole swizzle rows: 64 elements
//     (128-byte rows, 128-byte swizzle), and above 64 a second image of 64
//     (D = 128) or 16 elements (D = 80: 32-byte rows and swizzle, so its
//     160-byte rows need no padding);
//   * shared memory 64 * NC * 2D + 2 * 2 * 128 * 2D bytes + 1 KB of
//     alignment (161 KB at D = 128, NC = 2): one block of 384 threads per
//     SM.
//
// bf16 on mma.sync, D = 16 and 32 (the first tensor-core design):
//   * one block of 4 warps per (64-row query tile, query head, batch row);
//     each warp owns 16 query rows, its Q fragments loaded once by
//     ldmatrix;
//   * 64-key K and V tiles staged in shared memory in a two-stage ring
//     filled by 16-byte cp.async copies, rows padded by 16 bytes so that
//     an ldmatrix's 8 rows fall in distinct banks; rows past Sk are
//     zero-filled by the copy itself;
//   * QK^T and PV are mma.sync.m16n8k16 with bf16 inputs and f32
//     accumulation; V is read with ldmatrix.trans.
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
#include <cuda.h>
#include <cuda_bf16.h>
#include <math.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per KV tile
constexpr int kThreads = 128; // f32: two threads per query row; bf16: 4 warps
constexpr int kHalfK = kBK / 2;

// ---------------------------------------------------------------------------
// bf16 at D = 16, 32: mma.sync
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

// (The minimum of 2 blocks per SM was set for D = 80, which now runs on
// the wgmma kernel.)
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
// bf16 at D = 64, 80, 128: wgmma on TMA tiles, warp-specialised
// ---------------------------------------------------------------------------

namespace wgk {

using repro_tma::mbar_arrive;
using repro_tma::mbar_expect_tx;
using repro_tma::mbar_wait;
using repro_tma::smem_u32;
using repro_tma::tma_load_4d;

constexpr int kBN = 128;     // keys per K/V tile
constexpr int kStages = 2;   // K/V tiles in flight

// A head dim is cut into images of whole swizzle rows: the first 64
// elements (128-byte rows, 128-byte swizzle) and, above 64, a second image
// of W1 elements: D = 64 none, 80 one of 16 (32-byte rows and swizzle), 128
// one of 64
template <int D>
__host__ __device__ constexpr int second_width() {
  return D == 64 ? 0 : D - 64;
}

// the bytes of one image of R rows: 128-byte rows, and W1-element rows
template <int R>
__host__ __device__ constexpr int img0() { return R * 128; }
template <int R, int W1>
__host__ __device__ constexpr int img1() { return R * W1 * 2; }

template <int D, int NC>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int W1 = second_width<D>();
  constexpr int BM = 64 * NC;
  return img0<BM>() + img1<BM, W1>()
         + 2 * kStages * (img0<kBN>() + img1<kBN, W1>())
         + 1024;                          // slack to align to 1024 bytes
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode (1: 128 B, 2: 64 B,
// 3: 32 B rows)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(mode) << 62);
}
template <int RowBytes>
__host__ __device__ constexpr uint32_t swizzle_mode() {
  return RowBytes == 128 ? 1 : RowBytes == 64 ? 2 : 3;
}
// a K-major operand (Q as A, K as B): rows of RowBytes hold the reduction
// dimension; k-step kk (16 elements) starts 32 bytes further along the
// row; 8-row groups are 8 * RowBytes apart
template <int RowBytes>
__device__ __forceinline__ uint64_t kmajor(uint32_t img, int kk) {
  return make_desc(img + 32 * kk, 16, 8 * RowBytes, swizzle_mode<RowBytes>());
}
// an MN-major B operand (V in P V: rows are keys, the output columns run
// along the row): k-step kt (16 keys) starts 16 rows further; 8-key groups
// are 8 * RowBytes apart (one image spans the instruction's N, so the
// offset between images is never used)
template <int RowBytes>
__device__ __forceinline__ uint64_t mnmajor(uint32_t img, int kt) {
  return make_desc(img + kt * 16 * RowBytes, 8 * RowBytes, 8 * RowBytes,
                   swizzle_mode<RowBytes>());
}


// 2^x by the SFU's ex2.approx.ftz: the approximation exp2f makes (2 ulp),
// without exp2f's fix-up for subnormal results (a p below 2^-126 is 0,
// which no bf16 P or f32 sum of them can tell); 5-10% of the kernel's time
// at the engine's shapes on the H100
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from touching accumulators across an async wgmma
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void hold(uint32_t (&d)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// d (m64 x n128 f32) (+)= A (m64 x k16, smem) * B (k16 x n128, smem),
// both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                                uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63" "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// d (m64 x n64 f32) += A (m64 x k16, bf16 registers) * B (k16 x n64,
// smem, MN-major: the descriptor's transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31" "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64 x n16 f32) += A (m64 x k16, bf16 registers) * B (k16 x n16,
// smem, MN-major: the descriptor's transpose bit)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7" "}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

}  // namespace wgk

// One block per (query tile of 64 * NC rows, query head, batch row): NC
// consumer warpgroups of 64 query rows each and one producer warpgroup, of
// which one thread issues every TMA load (the other 127 leave at once).
template <int D, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
flash_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tq0,
                        const __grid_constant__ CUtensorMap tq1,
                        const __grid_constant__ CUtensorMap tk0,
                        const __grid_constant__ CUtensorMap tk1,
                        const __grid_constant__ CUtensorMap tv0,
                        const __grid_constant__ CUtensorMap tv1,
                        __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                        int Hq, int Hkv, float scale_log2, int causal) {
  using namespace wgk;
  constexpr int W1 = second_width<D>();
  constexpr int BM = 64 * NC;
  constexpr int Q0 = img0<BM>(), QB = Q0 + img1<BM, W1>();
  constexpr int T0 = img0<kBN>(), TB = T0 + img1<kBN, W1>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t k_full[kStages];
  __shared__ __align__(8) uint64_t v_full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = base;                  // Q images
  unsigned char* Ks = base + QB;             // stage s at s * TB
  unsigned char* Vs = Ks + kStages * TB;

  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BM;
  int n_tiles = (Sk + kBN - 1) / kBN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BM, Sq) - 1) / kBN + 1);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;

  if (tid == 0) {
    repro_tma::mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      repro_tma::mbar_init(&k_full[s], 1);
      repro_tma::mbar_init(&v_full[s], 1);
      repro_tma::mbar_init(&empty[s], 4 * NC);   // one arrival per warp
    }
    repro_tma::mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {
    // producer: Q once, then the K and V tiles through the ring; a stage
    // is refilled once every consumer warp has released it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == NC * 128) {
      mbar_expect_tx(&q_full, QB);
      tma_load_4d(Qs, &tq0, &q_full, 0, h, q0, b);
      if (W1) tma_load_4d(Qs + Q0, &tq1, &q_full, 64, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        unsigned char* ks = Ks + s * TB;
        unsigned char* vs = Vs + s * TB;
        mbar_expect_tx(&k_full[s], TB);
        tma_load_4d(ks, &tk0, &k_full[s], 0, hk, t * kBN, b);
        if (W1) tma_load_4d(ks + T0, &tk1, &k_full[s], 64, hk, t * kBN, b);
        mbar_expect_tx(&v_full[s], TB);
        tma_load_4d(vs, &tv0, &v_full[s], 0, hk, t * kBN, b);
        if (W1) tma_load_4d(vs + T0, &tv1, &v_full[s], 64, hk, t * kBN, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wt = tid & 127;
    const int warp = wt >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;                     // row within 8
    const int tg = lane & 3;                     // column pair
    const int rbase = q0 + 64 * wg;              // the warpgroup's first row
    const int row0 = rbase + 16 * warp + g;      // rows row0, row0 + 8
    const uint32_t qa = smem_u32(Qs) + 64 * wg * 128;
    const uint32_t qb = smem_u32(Qs + Q0) + 64 * wg * W1 * 2;

    float oa[32];                                // output columns 0-63
    float ob[W1 ? W1 / 2 : 1];                   // columns 64 - D
#pragma unroll
    for (int i = 0; i < 32; ++i) oa[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < (W1 ? W1 / 2 : 1); ++i) ob[i] = 0.0f;
    float m_r[2] = {-INFINITY, -INFINITY};
    float l_r[2] = {0.0f, 0.0f};

    float sc[64];                                // scores, then p
    uint32_t pa[8][4];                           // p in bf16, 16 keys a step

    // S = Q K^T of tile t: 64 rows x 128 keys per warpgroup, issued
    // asynchronously (the caller fences before and commits after)
    auto issue_qk = [&](int t) {
      const uint32_t ka = smem_u32(Ks + (t % kStages) * TB);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n128(sc, kmajor<128>(qa, kk), kmajor<128>(ka, kk), kk);
      if constexpr (W1 == 64) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n128(sc, kmajor<128>(qb, kk), kmajor<128>(ka + T0, kk), 1);
      } else if constexpr (W1 == 16) {
        wgmma_ss_n128(sc, kmajor<32>(qb, 0), kmajor<32>(ka + T0, 0), 1);
      }
    };
    // O += P V of tile t, P from registers
    auto issue_pv = [&](int t) {
      const uint32_t va = smem_u32(Vs + (t % kStages) * TB);
#pragma unroll
      for (int kt = 0; kt < 8; ++kt) {
        wgmma_rs_n64(oa, pa[kt], mnmajor<128>(va, kt));
        if constexpr (W1 == 64) {
          wgmma_rs_n64(ob, pa[kt], mnmajor<128>(va + T0, kt));
        } else if constexpr (W1 == 16) {
          wgmma_rs_n16(ob, pa[kt], mnmajor<32>(va + T0, kt));
        }
      }
    };
    // the masks and the online softmax of tile t on sc (p left in sc, l
    // updated); returns nothing, the rescale of O in alpha
    float alpha[2];
    auto softmax = [&](int t) {
      const int k0 = t * kBN;
      // mask where this warpgroup's tile needs it (diagonal, tail past Sk)
      if ((k0 + kBN > Sk) || (causal && k0 + kBN - 1 > rbase)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int key = k0 + 8 * (i >> 2) + 2 * tg + (i & 1);
          const int row = row0 + ((i >> 1) & 1) * 8;
          if (key >= Sk || (causal && key > row)) sc[i] = -INFINITY;
        }
      }
      // rows row0 (i & 2 == 0) and row0 + 8; the running max is kept
      // scaled (log2 units), the scores raw: the scale enters in f32 as
      // p = 2^(s * scale_log2 - m), one FMA
      float mbase[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[r], mx * scale_log2);
        alpha[r] = (m_r[r] == -INFINITY) ? 0.0f : ex2_ftz(m_r[r] - m_new);
        mbase[r] = (m_new == -INFINITY) ? 0.0f : m_new;
        m_r[r] = m_new;
      }
      float psum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1;
        const float p = ex2_ftz(fmaf(sc[i], scale_log2, -mbase[r]));
        sc[i] = p;
        psum[r] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + psum[r];
    };
    // P rounded to bf16 as wgmma's register A operand
    auto pack_p = [&]() {
#pragma unroll
      for (int kt = 0; kt < 8; ++kt) {
        pa[kt][0] = pack_bf16(sc[8 * kt + 0], sc[8 * kt + 1]);
        pa[kt][1] = pack_bf16(sc[8 * kt + 2], sc[8 * kt + 3]);
        pa[kt][2] = pack_bf16(sc[8 * kt + 4], sc[8 * kt + 5]);
        pa[kt][3] = pack_bf16(sc[8 * kt + 6], sc[8 * kt + 7]);
      }
    };
    // (the first k-step of QK^T overwrites the scores; zeroing them keeps
    // undefined values out of the wgmma's "+f" operands)
    auto zero_sc = [&]() {
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.0f;
    };

    // per tile: the scores, the softmax, then P V (each product waited
    // on before its result is read; the two consumer warpgroups, in
    // flight at once, overlap one's softmax with the other's products)
    mbar_wait(&q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int ph = (t / kStages) & 1;
      zero_sc();
      mbar_wait(&k_full[s], ph);
      hold(sc);
      wg_fence();
      issue_qk(t);
      wg_commit();
      wg_wait<0>();
      hold(sc);
      softmax(t);
#pragma unroll
      for (int i = 0; i < 32; ++i) oa[i] *= alpha[(i >> 1) & 1];
      if constexpr (W1 != 0) {
#pragma unroll
        for (int i = 0; i < W1 / 2; ++i) ob[i] *= alpha[(i >> 1) & 1];
      }
      pack_p();
      mbar_wait(&v_full[s], ph);
      hold(oa);
      hold(ob);
      hold(pa);
      wg_fence();
      issue_pv(t);
      wg_commit();
      wg_wait<0>();
      hold(oa);
      hold(ob);
      if (lane == 0) mbar_arrive(&empty[s]);       // stage s released
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_r[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row0 + r * 8;
      if (row < Sq) {
        const float den = fmaxf(l, 1e-30f);
        __nv_bfloat16* orow =
            out + (static_cast<int64_t>(b) * Sq + row) * Hq * D +
            static_cast<int64_t>(h) * D;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * tg) =
              __floats2bfloat162_rn(oa[4 * n + 2 * r] / den,
                                    oa[4 * n + 2 * r + 1] / den);
        if constexpr (W1 != 0) {
#pragma unroll
          for (int n = 0; n < W1 / 8; ++n)
            *reinterpret_cast<__nv_bfloat162*>(orow + 64 + n * 8 + 2 * tg) =
                __floats2bfloat162_rn(ob[4 * n + 2 * r] / den,
                                      ob[4 * n + 2 * r + 1] / den);
        }
      }
    }
  }
}

template <int D, int NC>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int Sq, int Sk, int Hq, int Hkv, float scale,
                 int causal, cudaStream_t stream) {
  constexpr int W1 = wgk::second_width<D>();
  constexpr int BM = 64 * NC;
  constexpr int smem = wgk::smem_bytes<D, NC>();
  const int w1 = W1 ? W1 : 64;
  CUtensorMap m[6];
  if (!repro_tma::bf16_map(&m[0], q, B, Sq, Hq, D, BM, 64) ||
      !repro_tma::bf16_map(&m[1], q, B, Sq, Hq, D, BM, w1) ||
      !repro_tma::bf16_map(&m[2], k, B, Sk, Hkv, D, wgk::kBN, 64) ||
      !repro_tma::bf16_map(&m[3], k, B, Sk, Hkv, D, wgk::kBN, w1) ||
      !repro_tma::bf16_map(&m[4], v, B, Sk, Hkv, D, wgk::kBN, 64) ||
      !repro_tma::bf16_map(&m[5], v, B, Sk, Hkv, D, wgk::kBN, w1))
    return cudaErrorInvalidValue;
  static bool configured = false;   // once per instantiation and process
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bf16_wgmma_kernel<D, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int n_qt = (Sq + BM - 1) / BM;
  if (n_qt > 65535 || B > 65535) return cudaErrorInvalidValue;
  dim3 grid(Hq, n_qt, B);
  const float scale_log2 = scale * 1.4426950408889634f;   // log2(e)
  flash_bf16_wgmma_kernel<D, NC><<<grid, 128 * (NC + 1), smem, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], static_cast<__nv_bfloat16*>(out),
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

// kernel codes of the wrapper (`kernels/flash_attention.py` `KERNELS`)
enum Kernel { kF32 = 0, kMma = 1, kWgmma1 = 2, kWgmma2 = 3 };

int launch_k(int kernel, int D, const void* q, const void* k, const void* v,
             void* out, int B, int Sq, int Sk, int Hq, int Hkv, float scale,
             int causal, cudaStream_t s) {
#define REPRO_ARGS q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal, s
  switch (kernel) {
    case kF32:
      switch (D) {
        case 16: return launch_f32<16>(REPRO_ARGS);
        case 32: return launch_f32<32>(REPRO_ARGS);
        case 64: return launch_f32<64>(REPRO_ARGS);
        case 80: return launch_f32<80>(REPRO_ARGS);
        case 128: return launch_f32<128>(REPRO_ARGS);
      }
      break;
    case kMma:
      switch (D) {
        case 16: return launch_bf16<16>(REPRO_ARGS);
        case 32: return launch_bf16<32>(REPRO_ARGS);
      }
      break;
    case kWgmma1:
      switch (D) {
        case 64: return launch_wgmma<64, 1>(REPRO_ARGS);
        case 80: return launch_wgmma<80, 1>(REPRO_ARGS);
        case 128: return launch_wgmma<128, 1>(REPRO_ARGS);
      }
      break;
    case kWgmma2:
      switch (D) {
        case 64: return launch_wgmma<64, 2>(REPRO_ARGS);
        case 80: return launch_wgmma<80, 2>(REPRO_ARGS);
        case 128: return launch_wgmma<128, 2>(REPRO_ARGS);
      }
      break;
  }
#undef REPRO_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// kernel: 0 = f32 (float32 tensors), 1 = bf16 mma.sync (D 16, 32),
// 2 / 3 = bf16 wgmma with 1 / 2 consumer warpgroups (D 64, 80, 128).
// Tensors contiguous in (B, S, H, D) and 16-byte aligned; Hq % Hkv == 0.
// Returns cudaGetLastError() (cudaErrorInvalidValue for arguments the
// kernels do not take, or a tensor map cuTensorMapEncodeTiled refuses).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                           int D, int kernel, float scale, int causal,
                           void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  return launch_k(kernel, D, q, k, v, out, B, Sq, Sk, Hq, Hkv, scale, causal,
                  static_cast<cudaStream_t>(stream));
}

// dynamic shared memory of one block of `kernel` at head dim D, in bytes
// (-1 for a pair the kernels do not take)
int flash_attention_smem_bytes(int kernel, int D) {
  switch (kernel * 1000 + D) {
    case kF32 * 1000 + 16: return smem_floats<16>() * 4;
    case kF32 * 1000 + 32: return smem_floats<32>() * 4;
    case kF32 * 1000 + 64: return smem_floats<64>() * 4;
    case kF32 * 1000 + 80: return smem_floats<80>() * 4;
    case kF32 * 1000 + 128: return smem_floats<128>() * 4;
    case kMma * 1000 + 16: return mma_smem_bytes<16>();
    case kMma * 1000 + 32: return mma_smem_bytes<32>();
    case kWgmma1 * 1000 + 64: return wgk::smem_bytes<64, 1>();
    case kWgmma1 * 1000 + 80: return wgk::smem_bytes<80, 1>();
    case kWgmma1 * 1000 + 128: return wgk::smem_bytes<128, 1>();
    case kWgmma2 * 1000 + 64: return wgk::smem_bytes<64, 2>();
    case kWgmma2 * 1000 + 80: return wgk::smem_bytes<80, 2>();
    case kWgmma2 * 1000 + 128: return wgk::smem_bytes<128, 2>();
  }
  return -1;
}

}  // extern "C"
