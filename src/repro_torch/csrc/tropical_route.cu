// Min-plus (tropical) routing DPs over the trust-pruned layered DAG:
// kernel K2 (single best) and kernel K1 (K best), one file, one library.
//
// ---- K2: route_kernel ------------------------------------------------------
// Replaces the Pallas TPU kernel `tropical_route` / `_route_kernel` of
// src/repro/kernels/tropical_route.py:65. For each request row r and each
// boundary b = 1..L, in ascending order,
//
//     dist[b] = min over ALL peers p of  (end_p == b ? dist[start_p] + C[r,p] : INF)
//     pred[b] = argmin (the lowest such p) where dist[b] < INF, else -1
//
// exactly as routing_torch's plain `layered_dp` (the reference's jnp DP):
// outputs dist (R, L+1) f32 and pred (R, L+1) i32.
//
// What bounds it on the H100: latency. The work is one add and one compare
// per (row, peer): at R = 512, P = 1000 the inputs and outputs are ~2.2 MB,
// under 1 us at 3.35 TB/s, and the operations far less. What costs is the
// chain of L dependent boundary steps. The TPU kernel gathered dist[start_p]
// for every peer through a one-hot (L+1, P) MXU matmul and took a masked min
// over all P peers at every boundary. On Hopper:
//   * one warp per request row (four rows per block), the row's dist and
//     pred in shared memory for the whole DP, written out once at the end;
//     rows never meet, so a boundary step needs no block barrier, only the
//     warp's own shuffles;
//   * peers bucketed by end boundary (a CSR built once per topology by the
//     wrapper, peer indices ascending in each bucket): boundary b scans only
//     its own bucket, each lane a strided share, then a warp-shuffle
//     (value, index) argmin. Ties go to the lowest peer index, as argmin's
//     first minimum does;
//   * the reference's min also covers the peers NOT ending at b, whose
//     candidate is INF. So dist[b] = min(bucket_min, INF) when some peer
//     ends elsewhere, the bare bucket_min (possibly +inf, from INF + INF)
//     when every peer ends at b, and INF for an empty bucket. A degenerate
//     peer with start == end == b reads dist[b] before it is written (INF),
//     as in the reference;
//   * R needs no padding: the last block's spare warps idle, R == 0 launches
//     nothing (the wrapper returns empty outputs).
//
// ---- K1: route_kbest_kernel -------------------------------------------------
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
//
// Both are compiled without --use_fast_math: the outputs must equal the
// plain DPs' bit for bit. INF + INF overflows to +inf; K1 filters it as
// "not < INF" and writes INF with edge and rank -1, like its reference.
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

constexpr int kRowsPerBlock = 4;     // K2: one warp per request row

__global__ void route_kernel(const int* __restrict__ offsets,
                             const int* __restrict__ order,
                             const int* __restrict__ sstart,
                             const float* __restrict__ costs,
                             float* __restrict__ dist_out,
                             int* __restrict__ pred_out,
                             int R, int P, int L) {
  extern __shared__ unsigned char smem_raw[];
  int* off = reinterpret_cast<int*>(smem_raw);              // L+2
  int* peer = off + (L + 2);                                // P
  int* start = peer + P;                                    // P
  float* dist_all = reinterpret_cast<float*>(start + P);    // rows*(L+1)
  int* pred_all = reinterpret_cast<int*>(dist_all + kRowsPerBlock * (L + 1));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < L + 2; i += blockDim.x) off[i] = offsets[i];
  for (int i = tid; i < P; i += blockDim.x) {
    peer[i] = order[i];
    start[i] = sstart[i];
  }
  float* dist = dist_all + warp * (L + 1);
  int* pred = pred_all + warp * (L + 1);
  for (int i = lane; i <= L; i += 32) {
    dist[i] = (i == 0) ? 0.0f : kInf;
    pred[i] = -1;
  }
  __syncthreads();                   // the only block barrier
  const int r = blockIdx.x * kRowsPerBlock + warp;
  if (r >= R) return;
  const float* crow = costs + static_cast<int64_t>(r) * P;

  for (int b = 1; b <= L; ++b) {
    const int lo = off[b];
    const int hi = off[b + 1];
    float best_v = kInf;
    int best_i = -1;                 // no candidate yet
    for (int j = lo + lane; j < hi; j += 32) {
      const int p = peer[j];
      const float v = dist[start[j]] + crow[p];
      if (before(v, p, best_v, best_i)) { best_v = v; best_i = p; }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best_v, o);
      const int oi = __shfl_down_sync(0xffffffffu, best_i, o);
      if (before(ov, oi, best_v, best_i)) { best_v = ov; best_i = oi; }
    }
    if (lane == 0) {
      float v = best_v;
      if (best_i < 0) v = kInf;                    // empty bucket
      else if (hi - lo < P) v = fminf(v, kInf);    // INF of the other peers
      dist[b] = v;
      pred[b] = (v < kInf) ? best_i : -1;
    }
    __syncwarp();
  }

  const int64_t base = static_cast<int64_t>(r) * (L + 1);
  for (int i = lane; i <= L; i += 32) {
    dist_out[base + i] = dist[i];
    pred_out[base + i] = pred[i];
  }
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

// Shared memory K2 needs for P peers and L layers.
int tropical_route_smem_bytes(int P, int L) {
  return 4 * ((L + 2) + 2 * P + 2 * kRowsPerBlock * (L + 1));
}

// offsets (L+2,), order / sstart (P,) i32: the end-boundary CSR; costs
// (R, P) f32 row-major; outputs dist / pred (R, L+1). Returns
// cudaGetLastError() after the launch.
int tropical_route_launch(const void* offsets, const void* order,
                          const void* sstart, const void* costs, void* dist,
                          void* pred, int R, int P, int L, void* stream) {
  if (R <= 0) return 0;
  if (L < 1 || P < 1) return cudaErrorInvalidValue;
  const int smem = tropical_route_smem_bytes(P, L);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  route_kernel<<<blocks, 32 * kRowsPerBlock, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(offsets), static_cast<const int*>(order),
      static_cast<const int*>(sstart), static_cast<const float*>(costs),
      static_cast<float*>(dist), static_cast<int*>(pred), R, P, L);
  return cudaGetLastError();
}

// Shared memory K1 needs for P peers, L layers and K ranks.
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
