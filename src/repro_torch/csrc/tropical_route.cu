// K-best min-plus (tropical) routing DP over the trust-pruned layered DAG.
//
// Replaces the Pallas TPU kernel `tropical_route_kbest` / `_route_kernel_kbest`
// of src/repro/kernels/tropical_route.py. Computes, for each request row r
// and each boundary b = 1..L, the K smallest extension candidates
//
//     cand[p, k] = distK[start_p, k] + costs[r, p]     over peers with end_p == b
//
// in (value, flat index p*K+k) order, exactly as routing_torch's plain
// `layered_dp_kbest` does with K rounds of (min, argmin, mask): outputs
// distK (R, L+1, K) f32, pedge / prank (R, L+1, K) i32, -1 where infeasible.
//
// What bounds it on the H100: latency, not bandwidth or arithmetic. At the
// serving shapes (L = 36, P = 108, K = 4, R = 1..64) the whole problem is a
// few KB and ~1e5 operations; the DP is a chain of L dependent boundary
// steps, each a K-round block-wide argmin. The TPU kernel gathered
// d[start_p] through a Kronecker one-hot matmul on the MXU; on Hopper a
// direct gather from shared memory is cheaper, so the design is:
//   * one thread block per request row; no padding of R to a block size,
//     and R == 0 launches nothing (the wrapper returns empty outputs);
//   * the row's (L+1)*K distances, edges and ranks, and the peers' starts,
//     ends and costs, live in shared memory for the whole DP; the outputs
//     are written to device memory once, coalesced, at the end;
//   * each round k is a block-wide lexicographic argmin over the candidates
//     strictly after the previous round's winner in (value, index) order.
//     That excludes exactly the already-selected candidates, so no mask
//     array is needed and ties go to the lowest p*K+k, as in the plain DP;
//   * a boundary's K winners are written only after all K rounds, because a
//     degenerate peer with start == end == b reads distK[b] as a candidate.
// Compiled without --use_fast_math: the outputs must equal the plain DP's
// bit for bit. INF + INF overflows to +inf, which is "not < INF" and is
// written back as INF with edge and rank -1, like the reference.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.0e38f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// (value, index) lexicographic "a before b"; index -1 marks "no candidate"
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  if (ib < 0) return ia >= 0;
  if (ia < 0) return false;
  return va < vb || (va == vb && ia < ib);
}

__global__ void route_kbest_kernel(const int* __restrict__ starts,
                                   const int* __restrict__ ends,
                                   const float* __restrict__ costs,
                                   float* __restrict__ dist_out,
                                   int* __restrict__ pedge_out,
                                   int* __restrict__ prank_out,
                                   int P, int L, int K) {
  extern __shared__ unsigned char smem_raw[];
  const int LK = (L + 1) * K;
  float* dist = reinterpret_cast<float*>(smem_raw);        // (L+1)*K
  int* pedge = reinterpret_cast<int*>(dist + LK);           // (L+1)*K
  int* prank = pedge + LK;                                  // (L+1)*K
  float* cost = reinterpret_cast<float*>(prank + LK);       // P
  int* sidx = reinterpret_cast<int*>(cost + P);             // P
  int* endb = sidx + P;                                     // P
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ float win_v[32];
  __shared__ int win_i[32];

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* crow = costs + static_cast<int64_t>(r) * P;

  for (int i = tid; i < LK; i += kThreads) {
    dist[i] = (i == 0) ? 0.0f : kInf;
    pedge[i] = -1;
    prank[i] = -1;
  }
  for (int p = tid; p < P; p += kThreads) {
    cost[p] = crow[p];
    const int s = starts[p];
    sidx[p] = s < 0 ? 0 : (s > L ? L : s);   // clip(starts, 0, L)
    endb[p] = ends[p];
  }
  __syncthreads();

  const int PK = P * K;
  for (int b = 1; b <= L; ++b) {
    float last_v = 0.0f;
    int last_i = -1;                 // previous round's winner (none yet)
    for (int k = 0; k < K; ++k) {
      float best_v = kInf;
      int best_i = -1;
      for (int i = tid; i < PK; i += kThreads) {
        const int p = i / K;
        if (endb[p] != b) continue;
        const float v = dist[sidx[p] * K + (i - p * K)] + cost[p];
        if (!(v < kInf)) continue;               // infeasible, incl. +inf
        if (last_i >= 0 && !before(last_v, last_i, v, i)) continue;
        if (before(v, i, best_v, best_i)) { best_v = v; best_i = i; }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best_v, off);
        const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
        if (before(ov, oi, best_v, best_i)) { best_v = ov; best_i = oi; }
      }
      if (lane == 0) { warp_v[warp] = best_v; warp_i[warp] = best_i; }
      __syncthreads();
      if (tid == 0) {
        float v = warp_v[0];
        int ix = warp_i[0];
        for (int w = 1; w < kWarps; ++w)
          if (before(warp_v[w], warp_i[w], v, ix)) { v = warp_v[w]; ix = warp_i[w]; }
        win_v[k] = v;
        win_i[k] = ix;
      }
      __syncthreads();
      last_v = win_v[k];
      last_i = win_i[k];
      if (last_i < 0) {                 // nothing finite left: rest stay INF
        if (tid == 0)
          for (int kk = k + 1; kk < K; ++kk) win_i[kk] = -1;
        __syncthreads();
        break;
      }
    }
    if (tid < K) {
      const int ix = win_i[tid];
      const int o = b * K + tid;
      if (ix >= 0) {
        dist[o] = win_v[tid];
        pedge[o] = ix / K;
        prank[o] = ix % K;
      }
    }
    __syncthreads();
  }

  const int64_t base = static_cast<int64_t>(r) * LK;
  for (int i = tid; i < LK; i += kThreads) {
    dist_out[base + i] = dist[i];
    pedge_out[base + i] = pedge[i];
    prank_out[base + i] = prank[i];
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory the kernel needs for P peers, L layers and K ranks.
int tropical_route_kbest_smem_bytes(int P, int L, int K) {
  return 3 * (L + 1) * K * 4 + 3 * P * 4;
}

// starts/ends (P,) i32, costs (R, P) f32 row-major; outputs (R, L+1, K).
// K <= 32. Returns cudaGetLastError() after the launch.
int tropical_route_kbest_launch(const void* starts, const void* ends,
                                const void* costs, void* dist, void* pedge,
                                void* prank, int R, int P, int L, int K,
                                void* stream) {
  if (R <= 0) return 0;
  if (K < 1 || K > 32 || L < 1 || P < 1) return cudaErrorInvalidValue;
  const int smem = tropical_route_kbest_smem_bytes(P, L, K);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        route_kbest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  route_kbest_kernel<<<R, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts), static_cast<const int*>(ends),
      static_cast<const float*>(costs), static_cast<float*>(dist),
      static_cast<int*>(pedge), static_cast<int*>(prank), P, L, K);
  return cudaGetLastError();
}

}  // extern "C"
