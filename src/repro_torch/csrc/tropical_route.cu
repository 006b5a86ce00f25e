// Min-plus (tropical) routing DPs over the trust-pruned layered DAG:
// kernels K2 (single best) and K1 (K best), and the fused window entries
// that route a whole serving window in one launch. One file, one library.
//
// ---- What they compute --------------------------------------------------
// K2 (`route_kernel`) replaces the Pallas TPU kernel `tropical_route` /
// `_route_kernel` of src/repro/kernels/tropical_route.py:65. For each
// request row r and each boundary b = 1..L, in ascending order,
//
//     dist[b] = min over ALL peers p of  (end_p == b ? dist[start_p] + C[r,p] : INF)
//     pred[b] = argmin (the lowest such p) where dist[b] < INF, else -1
//
// exactly as routing_torch's plain `layered_dp` (the reference's jnp DP).
//
// K1 (`route_kbest_kernel`) replaces `tropical_route_kbest` /
// `_route_kernel_kbest` of the same file (:168): for each row and boundary
// the K smallest extension candidates
//
//     cand[p, k] = distK[start_p, k] + C[r, p]     over peers with end_p == b
//
// in (value, flat index p*K+k) order, exactly as the plain
// `layered_dp_kbest`'s K rounds of (min, argmin, mask); -1 where infeasible.
//
// The window entries (`route_window_kernel`, `route_window_kbest_kernel`)
// run the same DPs between a prologue and an epilogue that the plain path
// runs as separate torch ops: the prologue computes the pruned effective
// costs from the registry state and the row's trust floor, bit-identical to
// routing_torch's `effective_costs` (lat + (1 - trust) * timeout as three
// separately rounded f32 operations, pruned where !(alive && trust >= tau));
// the epilogue is the backtrack (`backtrack` / `backtrack_kbest`): chains
// followed over the predecessors sink-first, written into reversed
// positions so the result is in stage order with -1 padding in front.
// Outputs: hops (R, k_max) / (R, K, k_max) int32 and the costs dist[L] /
// distK[L] — one launch per window instead of ~370 small ones.
//
// ---- What bounds them on the H100 ---------------------------------------
// Latency. At the serving shapes (P = 108, L = 36, K = 4, R = 1..64) the
// problem is a few KB and ~1e5 operations, under a microsecond of bytes or
// FLOPs; what costs is the chain of L dependent boundary steps. The TPU
// kernels gathered dist[start_p] through one-hot MXU matmuls over all P
// peers at every boundary. Here:
//   * one warp per request row, up to four rows per block; rows never
//     meet, so after the block has staged the topology (the end-boundary
//     CSR of `route_csr`: offsets, order, clamped starts) no block barrier
//     is taken, only the warp's own reductions and __syncwarp. Every
//     global load of the prologue is issued before that barrier, ahead of
//     its shared store, so at P <= 1024 the prologue is one round trip;
//   * each row's cost row (given, or the window's pruned effective costs)
//     is staged once per warp in shared memory before the chain starts,
//     and the row's dist/pred (K2) or distK/pedge/prank (K1) live there
//     for the whole DP: a boundary step reads shared memory only. The warp
//     walks its non-empty buckets only, and loads the chain-independent
//     operands of its next bucket (bounds, the lane's first candidate's
//     start, peer and cost) a step ahead;
//   * boundary b reads only its CSR bucket, its peers in ascending index
//     order;
//   * a bucket of up to 32 candidates holds one per lane in ascending
//     index order (lane l the l-th; K1's flat candidate l = (slot l / K,
//     rank l % K)), so the argmin is one redux.sync min of the value's
//     order-preserving word and a ballot for the lowest lane holding it:
//     ties go to the lowest index, as argmin's first minimum does. K1's K
//     rounds each take that winner lane out (the successor rule: every
//     later winner comes strictly after it) and, after all rounds, each
//     winner writes its own candidate — after, because a degenerate peer
//     with start == end == b reads distK[b];
//   * a larger bucket is scanned lane-strided (K1's (slot, rank) stepped
//     without a divide), each lane keeping its least (value, index) as one
//     64-bit key in lexicographic order; the argmin is two redux.sync mins
//     (the value word, then the index word among the lanes holding the
//     least value word), and K1's rounds take the least key strictly
//     after the previous winner (key > last), excluding exactly the
//     winners so far with no mask;
//   * K1's infeasible candidates (not < INF, which includes INF + INF =
//     +inf) are no candidates. No candidate is -0.0 (dist[0] is +0.0 and
//     x + y is -0.0 only for -0.0 + -0.0) or NaN;
//   * K2 folds in the INF of the peers NOT ending at b: dist[b] =
//     fminf(bucket min, INF) when some peer ends elsewhere, the bare bucket
//     min (possibly +inf) when every peer ends at b, INF (as initialised)
//     for an empty bucket. A degenerate peer reads dist[b] before it is
//     written, as in the reference;
//   * R needs no padding (spare warps of the last block idle) and R == 0
//     launches nothing.
//
// Compiled without --use_fast_math and with the prologue's arithmetic in
// explicit round-to-nearest intrinsics (the shared flags leave FMA
// contraction on): every output equals its plain version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.0e38f;
constexpr int kMaxRows = 4;                      // request rows (warps) per block
constexpr int kBatch = 8;     // topology loads in flight per thread when staging
constexpr int kRow = 32;      // cost-row loads in flight per lane when staging
constexpr int kMaxSmem = 232448;                 // shared memory of one H100 block
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;      // "no candidate"

struct Args {
  const int* offsets;       // (L+2,) CSR by end boundary
  const int* order;         // (P,) peers sorted by end boundary
  const int* sstart;        // (P,) clamp(starts[order], 0, L)
  const float* costs;       // kernel entries: (R, P) row-major
  const int* starts;        // window entries: (P,) unclamped, peer order
  const float* latency;     // window entries: (P,)
  const float* trust;       // window entries: (P,)
  const unsigned char* alive;  // window entries: (P,) alive && valid
  const float* tau;         // window entries: (R,)
  float timeout;
  float* dist;              // kernel entries' outputs: (R, L+1[, K])
  int* pedge;               //   pred (K2) / pedge (K1)
  int* prank;
  int* hops;                // window entries' outputs: (R, [K,] k_max)
  float* cost_out;          //   (R[, K])
  int R, P, L, K, k_max, rows;
};

// 32-bit words of shared memory: the block's topology, and one row's,
// each a multiple of four so that every row's bucket records are 16-byte
// aligned.
__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int block_words(int P, int L, bool window) {
  return round4((L + 2) + (window ? 3 : 2) * P);
}
__host__ __device__ inline int row_words(int P, int L, int K, bool kbest) {
  return round4(4 * L + P + (kbest ? 3 * (L + 1) * K : 2 * (L + 1)));
}
int smem_bytes(int P, int L, int K, bool kbest, bool window, int rows) {
  return 4 * (block_words(P, L, window) + rows * row_words(P, L, K, kbest));
}

// (value, index) as a 64-bit key in lexicographic order
__device__ __forceinline__ unsigned long long make_key(float v, int i) {
  unsigned u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(i);
}
__device__ __forceinline__ float key_value(unsigned long long key) {
  unsigned u = static_cast<unsigned>(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}
__device__ __forceinline__ int key_index(unsigned long long key) {
  return static_cast<int>(static_cast<unsigned>(key));
}
__device__ __forceinline__ unsigned long long kmin(unsigned long long a,
                                                   unsigned long long b) {
  return b < a ? b : a;
}

// The warp's lexicographic argmin of one key per lane, in every lane: two
// warp-wide redux.sync mins, of the value word and then of the index word
// over the lanes holding the least value word. (A 64-bit xor shuffle tree,
// five levels of two shuffles each, was slower on the H100.)
__device__ __forceinline__ unsigned long long warp_argmin(
    unsigned long long key) {
  const unsigned hi = static_cast<unsigned>(key >> 32);
  const unsigned lo = static_cast<unsigned>(key);
  const unsigned mh = __reduce_min_sync(kFull, hi);
  const unsigned ml = __reduce_min_sync(kFull, hi == mh ? lo : 0xffffffffu);
  return (static_cast<unsigned long long>(mh) << 32) | ml;
}

// The warp's non-empty buckets in ascending boundary order, as (b, lo,
// hi) records: a step reads its successor's bounds in one 16-byte load,
// and empty boundaries (every other one on the serving topology) cost
// nothing. Returns their count.
__device__ __forceinline__ int bucket_list(const int* off, int4* segs, int L,
                                           int lane) {
  int nseg = 0;
  for (int base = 1; base <= L; base += 32) {
    const int b = base + lane;
    const int lo = b <= L ? off[b] : 0, hi = b <= L ? off[b + 1] : 0;
    const unsigned m = __ballot_sync(kFull, hi > lo);
    if (hi > lo)
      segs[nseg + __popc(m & ((1u << lane) - 1u))] = make_int4(b, lo, hi, 0);
    nseg += __popc(m);
  }
  __syncwarp();
  return nseg;
}

// the order-preserving word of an f32 value (the high word of its key)
__device__ __forceinline__ unsigned value_word(float v) {
  return static_cast<unsigned>(make_key(v, 0) >> 32);
}

// The warp's winner lane when every lane holds at most one candidate in
// ascending index order (lane l the bucket's l-th): the least value word
// by one redux.sync, and among the lanes holding it the lowest, which
// holds the lowest index.
__device__ __forceinline__ int winner_lane(unsigned word, unsigned* least) {
  *least = __reduce_min_sync(kFull, word);
  return __ffs(__ballot_sync(kFull, word == *least)) - 1;
}

// K2's chain over one row: dist / pred (L+1) in shared memory.
__device__ __forceinline__ void dp_single(const int4* segs, int nseg,
                                          const int* peer, const int* sst,
                                          const float* crow, float* dist,
                                          int* pred, int P, int lane) {
  if (nseg == 0) return;
  // the lane's first candidate (slot lo + lane, clamped into range and
  // masked by lane < n): start, peer, cost. The next bucket's bounds are
  // read at the top of a step, its first candidate's start and peer after
  // the scan and its cost at the end, so no load waits on the chain.
  int4 sg = segs[0];
  int j = min(sg.y + lane, P - 1);
  int s = sst[j], p = peer[j];
  float c = crow[p];
  for (int si = 0; si < nseg; ++si) {
    const int b = sg.x, lo = sg.y, hi = sg.z, n = hi - lo;
    const int4 nsg = segs[min(si + 1, nseg - 1)];
    const float v0 = dist[s] + c;
    if (n <= 32) {
      // one candidate per lane (lanes >= n hold none, the all-ones word)
      j = min(nsg.y + lane, P - 1);
      const int ns = sst[j], np = peer[j];
      unsigned least;
      const int w = winner_lane(lane < n ? value_word(v0) : ~0u, &least);
      if (lane == w) {
        const float v = n < P ? fminf(v0, kInf) : v0;   // INF of the others
        dist[b] = v;
        pred[b] = v < kInf ? p : -1;
      }
      __syncwarp();
      sg = nsg; s = ns; p = np;
      c = crow[np];
      continue;
    }
    // over 32 peers: each lane the least key of its share, four loads at a
    // time ahead of their use, then the warp argmin
    unsigned long long best = make_key(v0, p);
    for (int jj = lo + lane + 32; jj < hi; jj += 128) {
      int s4[4], p4[4];
      #pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = min(jj + 32 * u, P - 1);
        s4[u] = sst[q];
        p4[u] = peer[q];
      }
      #pragma unroll
      for (int u = 0; u < 4; ++u) {
        const unsigned long long key =
            make_key(dist[s4[u]] + crow[p4[u]], p4[u]);
        if (jj + 32 * u < hi) best = kmin(best, key);
      }
    }
    j = min(nsg.y + lane, P - 1);
    const int ns = sst[j], np = peer[j];
    best = warp_argmin(best);
    if (lane == 0) {
      float v = key_value(best);
      if (n < P) v = fminf(v, kInf);
      dist[b] = v;
      pred[b] = v < kInf ? key_index(best) : -1;
    }
    __syncwarp();
    sg = nsg; s = ns; p = np;
    c = crow[np];
  }
}

// K1's candidate (bucket slot j, rank kk): no candidate unless < INF
__device__ __forceinline__ unsigned long long kbest_key(
    const float* distK, const int* sst, const int* peer, const float* crow,
    int j, int kk, int K) {
  const int p = peer[j];
  const float v = distK[sst[j] * K + kk] + crow[p];
  return v < kInf ? make_key(v, p * K + kk) : kNone;
}

// K1's chain over one row: distK / pedge / prank ((L+1) x K) in shared
// memory.
__device__ __forceinline__ void dp_kbest(const int4* segs, int nseg,
                                         const int* peer, const int* sst,
                                         const float* crow, float* distK,
                                         int* pedge, int* prank, int P,
                                         int K, int lane) {
  if (nseg == 0) return;
  // candidate c = (slot c / K, rank c % K); the lane's first is c = lane,
  // and a step of 32 adds (q32, r32): the only divisions
  const int q0 = lane / K, r0 = lane - q0 * K;
  const int q32 = 32 / K, r32 = 32 - q32 * K;
  // the lane's first candidate, loaded as in dp_single
  int4 sg = segs[0];
  int j = min(sg.y + q0, P - 1);
  int s = sst[j], p = peer[j];
  float c = crow[p];
  for (int si = 0; si < nseg; ++si) {
    const int b = sg.x, lo = sg.y, ncand = (sg.z - sg.y) * K;
    const int4 nsg = segs[min(si + 1, nseg - 1)];
    const int rounds = ncand < K ? ncand : K;
    const float v0 = lane < ncand ? distK[s * K + r0] + c : kInf;
    j = min(nsg.y + q0, P - 1);
    const int ns = sst[j], np = peer[j];
    if (ncand <= 32) {
      // one candidate per lane, in ascending flat index: a round's winner
      // is the winner lane, which then leaves (the successor rule with
      // one candidate per lane) and, after all rounds, writes itself
      unsigned word = v0 < kInf ? value_word(v0) : ~0u;
      int won = -1;
      for (int k = 0; k < rounds; ++k) {
        unsigned least;
        const int w = winner_lane(word, &least);
        if (least == ~0u) break;      // nothing finite left (uniform)
        if (lane == w) { won = k; word = ~0u; }
      }
      __syncwarp();                   // every read of distK[b] is done
      if (won >= 0) {
        distK[b * K + won] = v0;
        pedge[b * K + won] = p;
        prank[b * K + won] = r0;
      }
    } else {
      // more candidates than lanes: K rounds of the warp argmin over each
      // lane's least candidate strictly after the previous winner
      const unsigned long long first = v0 < kInf ? make_key(v0, p * K + r0)
                                                 : kNone;
      unsigned long long last = 0, mine = kNone;   // every key is > 0
      for (int k = 0; k < rounds; ++k) {
        unsigned long long best = first > last ? first : kNone;
        int q = q0 + q32, r = r0 + r32;
        if (r >= K) { r -= K; ++q; }
        for (int cc = lane + 32; cc < ncand; cc += 32) {
          const unsigned long long key =
              kbest_key(distK, sst, peer, crow, lo + q, r, K);
          if (key > last && key < best) best = key;
          q += q32; r += r32;
          if (r >= K) { r -= K; ++q; }
        }
        best = warp_argmin(best);
        if (lane == k) mine = best;
        last = best;
      }
      __syncwarp();                   // every read of distK[b] is done
      if (lane < K && mine != kNone) {
        const int i = key_index(mine);
        const int pe = i / K;
        distK[b * K + lane] = key_value(mine);
        pedge[b * K + lane] = pe;
        prank[b * K + lane] = i - pe * K;
      }
    }
    __syncwarp();
    sg = nsg; s = ns; p = np;
    c = crow[np];
  }
}

template <bool kKBest, bool kWindow>
__device__ __forceinline__ void route_rows(const Args& a) {
  extern __shared__ __align__(16) int smem[];
  const int P = a.P, L = a.L;
  const int K = kKBest ? a.K : 1;
  const int LK = (L + 1) * K;
  int* off = smem;                                        // L+2
  int* peer = off + (L + 2);                              // P, CSR order
  int* sst = peer + P;                                    // P, CSR order
  int* st = sst + P;                                      // P (window)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int4* segs = reinterpret_cast<int4*>(
      smem + block_words(P, L, kWindow) + warp * row_words(P, L, K, kKBest));
  float* crow = reinterpret_cast<float*>(segs + L);             // P, peer order
  float* dist = crow + P;                                       // LK
  int* pedge = reinterpret_cast<int*>(dist + LK);               // LK
  int* prank = pedge + LK;                                      // LK (K1)
  const int r = blockIdx.x * a.rows + warp;

  // The prologue's global loads: the row's cost row (peer order: given,
  // or the window's pruned effective costs as three separately rounded
  // f32 operations, INF unless alive && trust >= tau), kRow per lane, and
  // the block's topology, kBatch per thread. Every load of a first batch
  // is issued before any shared store, so at P <= 1024 the prologue is
  // one round trip; larger P loops over further batches.
  const bool row = r < a.R;
  const float tau = kWindow && row ? __ldg(a.tau + r) : 0.0f;
  const float* cr = kWindow || !row ? nullptr
                                    : a.costs + static_cast<int64_t>(r) * P;
  const int nt = blockDim.x;
  auto load_row = [&](int p0, float* v) {
    #pragma unroll
    for (int u = 0; u < kRow; ++u) {
      const int q = min(p0 + 32 * u, P - 1);
      if (kWindow) {
        const float t = __ldg(a.trust + q);
        const float c = __fadd_rn(__ldg(a.latency + q),
                                  __fmul_rn(__fsub_rn(1.0f, t), a.timeout));
        v[u] = __ldg(a.alive + q) && t >= tau ? c : kInf;
      } else {
        v[u] = __ldg(cr + q);
      }
    }
  };
  auto store_row = [&](int p0, const float* v) {
    #pragma unroll
    for (int u = 0; u < kRow; ++u)
      if (p0 + 32 * u < P) crow[p0 + 32 * u] = v[u];
  };
  auto load_topo = [&](int j0, int* o, int* ss, int* s0) {
    #pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = min(j0 + u * nt, P - 1);
      o[u] = __ldg(a.order + q);
      ss[u] = __ldg(a.sstart + q);
      if (kWindow) s0[u] = __ldg(a.starts + q);
    }
  };
  auto store_topo = [&](int j0, const int* o, const int* ss, const int* s0) {
    #pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = j0 + u * nt;
      if (q < P) {
        peer[q] = o[u];
        sst[q] = ss[u];
        if (kWindow) st[q] = s0[u];   // unclamped, peer order
      }
    }
  };
  {
    float v[kRow];
    int o[kBatch], ss[kBatch], s0[kBatch];
    const int o0 = tid < L + 2 ? __ldg(a.offsets + tid) : 0;
    if (row) load_row(lane, v);
    load_topo(tid, o, ss, s0);
    if (tid < L + 2) off[tid] = o0;
    if (row) store_row(lane, v);
    store_topo(tid, o, ss, s0);
  }
  for (int i = tid + nt; i < L + 2; i += nt) off[i] = __ldg(a.offsets + i);
  for (int p0 = lane + 32 * kRow; row && p0 < P; p0 += 32 * kRow) {
    float v[kRow];
    load_row(p0, v);
    store_row(p0, v);
  }
  for (int j0 = tid + kBatch * nt; j0 < P; j0 += kBatch * nt) {
    int o[kBatch], ss[kBatch], s0[kBatch];
    load_topo(j0, o, ss, s0);
    store_topo(j0, o, ss, s0);
  }
  for (int i = lane; i < LK; i += 32) {
    dist[i] = i == 0 ? 0.0f : kInf;
    pedge[i] = -1;
    if (kKBest) prank[i] = -1;
  }
  __syncthreads();                    // the only block barrier
  if (r >= a.R) return;
  const int nseg = bucket_list(off, segs, L, lane);

  if (kKBest)
    dp_kbest(segs, nseg, peer, sst, crow, dist, pedge, prank, P, K, lane);
  else
    dp_single(segs, nseg, peer, sst, crow, dist, pedge, P, lane);

  if (!kWindow) {                     // the DP's own outputs
    const int64_t base = static_cast<int64_t>(r) * LK;
    for (int i = lane; i < LK; i += 32) {
      a.dist[base + i] = dist[i];
      a.pedge[base + i] = pedge[i];
      if (kKBest) a.prank[base + i] = prank[i];
    }
    return;
  }
  // the backtrack: lane j < K follows chain j (K2: lane 0 the one chain);
  // once a step is invalid its state stays, so every later hop is -1
  const int km = a.k_max;
  if (lane < K) {
    int* out = a.hops + (static_cast<int64_t>(r) * K + lane) * km;
    int b = L, rank = lane, t = 0;
    for (; t < km; ++t) {
      int e;
      if (kKBest) {
        int idx = b * K + rank;                 // clamped, as the plain
        idx = idx < 0 ? 0 : (idx > LK - 1 ? LK - 1 : idx);
        e = pedge[idx];
        if (!(b > 0 && rank >= 0 && e >= 0)) break;
        rank = prank[idx];
      } else {
        if (b <= 0 || b > L) break;             // as the reference's
        e = pedge[b];                           // out-of-range read
        if (e < 0) break;
      }
      out[km - 1 - t] = e;
      b = st[e];                                 // unclamped starts
    }
    for (; t < km; ++t) out[km - 1 - t] = -1;
    a.cost_out[static_cast<int64_t>(r) * K + lane] = dist[L * K + lane];
  }
}

__global__ void __launch_bounds__(32 * kMaxRows) route_kernel(const Args a) {
  route_rows<false, false>(a);
}
__global__ void __launch_bounds__(32 * kMaxRows)
route_kbest_kernel(const Args a) {
  route_rows<true, false>(a);
}
__global__ void __launch_bounds__(32 * kMaxRows)
route_window_kernel(const Args a) {
  route_rows<false, true>(a);
}
__global__ void __launch_bounds__(32 * kMaxRows)
route_window_kbest_kernel(const Args a) {
  route_rows<true, true>(a);
}
// an empty kernel: the launch floor the routing kernels' times stand beside
__global__ void route_launch_floor_kernel() {}

// Rows per block (4, else fewer when P is large), shared memory, launch.
int launch(void (*kernel)(Args), Args a, bool kbest, bool window,
           void* stream) {
  if (a.R <= 0) return 0;
  if (a.L < 1 || a.P < 1 || a.k_max < 0 || (kbest && (a.K < 1 || a.K > 32)))
    return cudaErrorInvalidValue;
  if (!kbest) a.K = 1;
  int rows = kMaxRows;
  while (rows > 1 && smem_bytes(a.P, a.L, a.K, kbest, window, rows) > kMaxSmem)
    rows >>= 1;
  const int smem = smem_bytes(a.P, a.L, a.K, kbest, window, rows);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  a.rows = rows;
  kernel<<<(a.R + rows - 1) / rows, 32 * rows, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory one block needs at one row per block (the least a launch
// takes); the launcher puts up to four rows in a block where they fit.
int route_smem_bytes(int P, int L, int K, int kbest, int window) {
  return smem_bytes(P, L, kbest ? K : 1, kbest != 0, window != 0, 1);
}

// K2: CSR (offsets (L+2,), order / sstart (P,) i32), costs (R, P) f32
// row-major; outputs dist / pred (R, L+1). Each entry returns
// cudaGetLastError() after the launch.
int tropical_route_launch(const void* offsets, const void* order,
                          const void* sstart, const void* costs, void* dist,
                          void* pred, int R, int P, int L, void* stream) {
  Args a{};
  a.offsets = static_cast<const int*>(offsets);
  a.order = static_cast<const int*>(order);
  a.sstart = static_cast<const int*>(sstart);
  a.costs = static_cast<const float*>(costs);
  a.dist = static_cast<float*>(dist);
  a.pedge = static_cast<int*>(pred);
  a.R = R; a.P = P; a.L = L; a.K = 1;
  return launch(route_kernel, a, false, false, stream);
}

// K1: the same CSR and costs; outputs distK / pedge / prank (R, L+1, K),
// 1 <= K <= 32.
int tropical_route_kbest_launch(const void* offsets, const void* order,
                                const void* sstart, const void* costs,
                                void* dist, void* pedge, void* prank, int R,
                                int P, int L, int K, void* stream) {
  Args a{};
  a.offsets = static_cast<const int*>(offsets);
  a.order = static_cast<const int*>(order);
  a.sstart = static_cast<const int*>(sstart);
  a.costs = static_cast<const float*>(costs);
  a.dist = static_cast<float*>(dist);
  a.pedge = static_cast<int*>(pedge);
  a.prank = static_cast<int*>(prank);
  a.R = R; a.P = P; a.L = L; a.K = K;
  return launch(route_kbest_kernel, a, true, false, stream);
}

// The window entries: CSR, starts (P,) i32 unclamped, latency / trust (P,)
// f32, alive (P,) bool, tau (R,) f32, the timeout; outputs hops
// (R, [K,] k_max) i32 and costs (R[, K]) f32. K = 0 runs the single-best
// DP (K2), 1 <= K <= 32 the K-best one (K1).
int route_window_launch(const void* offsets, const void* order,
                        const void* sstart, const void* starts,
                        const void* latency, const void* trust,
                        const void* alive, const void* tau, float timeout,
                        void* hops, void* costs, int R, int P, int L, int K,
                        int k_max, void* stream) {
  Args a{};
  a.offsets = static_cast<const int*>(offsets);
  a.order = static_cast<const int*>(order);
  a.sstart = static_cast<const int*>(sstart);
  a.starts = static_cast<const int*>(starts);
  a.latency = static_cast<const float*>(latency);
  a.trust = static_cast<const float*>(trust);
  a.alive = static_cast<const unsigned char*>(alive);
  a.tau = static_cast<const float*>(tau);
  a.timeout = timeout;
  a.hops = static_cast<int*>(hops);
  a.cost_out = static_cast<float*>(costs);
  a.R = R; a.P = P; a.L = L; a.K = K; a.k_max = k_max;
  if (K == 0) return launch(route_window_kernel, a, false, true, stream);
  return launch(route_window_kbest_kernel, a, true, true, stream);
}

// The empty kernel, one block of one warp.
int route_launch_floor(void* stream) {
  route_launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

}  // extern "C"
