// Hopper's asynchronous copies for the attention kernels (K3, K4): tensor
// maps for the Tensor Memory Accelerator (TMA), built on the host and
// cached, the 4-D tiled TMA load, and the shared-memory barriers
// (mbarrier) that count its bytes.
//
// Every tensor is described to TMA as 4-D (B, S, H, D), innermost first
// (D, H, S, B), never with B and S flattened: a box that runs past S reads
// zeros, not the next batch row, and a box that starts before row 0 (a
// negative coordinate) reads zeros too. A box holds `box_rows` rows of S
// and `box_cols` head-dim elements of one (batch row, head); its shared
// memory image is box_rows rows of box_cols * 2 bytes, swizzled by the
// mode that matches the row's width (128, 64 or 32 bytes): 16-byte chunk c
// of row r lands at chunk c ^ f(r), so eight rows read at one logical
// chunk hit eight distinct bank groups. `swizzle_offset` gives the byte
// offset of a logical (row, byte) in that image. Images are placed at
// 1024-byte aligned offsets, where the pattern starts.
//
// cuTensorMapEncodeTiled (libcuda's) is reached through the runtime's
// entry-point query, so nothing links against libcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace repro_tma {

// ---------------------------------------------------------------------------
// device side
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic to wait for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// spin until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one box of a 4-D tensor map into shared memory at `dst`, counted on
// `bar`; coordinates innermost first: (d, head, row, batch)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int d, int h,
                                            int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d),
      "r"(h), "r"(row), "r"(b)
      : "memory");
}

// byte offset of logical byte `byte` of row `row` in a swizzled image
// whose rows are `RowBytes` (128, 64 or 32) wide
template <int RowBytes>
__host__ __device__ constexpr uint32_t swizzle_offset(int row, int byte) {
  // 128 B: chunk ^= row % 8; 64 B: chunk ^= (row / 2) % 4; 32 B: chunk ^=
  // (row / 4) % 2 -- address bits [4, 4 + n) ^= bits [7, 7 + n)
  return static_cast<uint32_t>(row * RowBytes + byte) ^
         ((static_cast<uint32_t>(row * RowBytes) >> 7 &
           (RowBytes / 16 - 1)) << 4);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn lookup_encode_fn() {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
  cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                          cudaEnableDefault, &status);
#endif
  if (e != cudaSuccess || status != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<EncodeTiledFn>(p);
}

inline EncodeTiledFn encode_fn() {
  static const EncodeTiledFn fn = lookup_encode_fn();   // once per process
  return fn;
}

inline CUtensorMapSwizzle swizzle_for(int row_bytes) {
  return row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

// A bf16 tensor (B, S, H, D), contiguous, as a 4-D tensor map whose box is
// `box_rows` rows of S by `box_cols` elements of D (box_cols * 2 bytes:
// 128, 64 or 32, swizzled to match). Maps are cached by (pointer, shape,
// box): the engine and the window loop launch thousands of times on a few
// buffers. Returns false when cuTensorMapEncodeTiled refuses the map.
struct MapKey {
  const void* ptr;
  int B, S, H, D, box_rows, box_cols;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && B == o.B && S == o.S && H == o.H && D == o.D &&
           box_rows == o.box_rows && box_cols == o.box_cols;
  }
};

inline bool bf16_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                     int D, int box_rows, int box_cols) {
  constexpr int kSlots = 256;
  struct Slot {
    MapKey key;
    CUtensorMap map;
    bool used;
  };
  static Slot slots[kSlots];
  static std::mutex mu;
  const MapKey key{ptr, B, S, H, D, box_rows, box_cols};
  uint64_t hsh = reinterpret_cast<uint64_t>(ptr) >> 8;
  hsh = hsh * 0x9E3779B97F4A7C15ull ^
        (static_cast<uint64_t>(S) * 131 + H * 31 + D * 7 + box_rows * 3 +
         box_cols + B * 1009);
  Slot& slot = slots[(hsh ^ (hsh >> 29)) % kSlots];
  std::lock_guard<std::mutex> lock(mu);
  if (slot.used && slot.key == key) {
    *map = slot.map;
    return true;
  }
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(H) * D * 2,
                                 static_cast<cuuint64_t>(S) * H * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_for(box_cols * 2),
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return false;
  slot.key = key;
  slot.map = *map;
  slot.used = true;
  return true;
}

}  // namespace repro_tma
