// batch_score_topk — masked squared-L2 top-k per query, two entries on one
// kernel body:
//   * batch_score_topk_launch:        qs (B, d), cands (B, M, d), ok (B, M)
//     (the reference kernel's own signature; row (b, m) is cands[b, m]);
//   * batch_score_topk_gather_launch: qs (B, d), points (N, d), cand (B, M)
//     int32 slot ids (-1 allowed), ok (B, M); row (b, m) is
//     points[max(cand[b, m], 0)], so the (B, M, d) gather is never written.
// Both return d2 (B, k) ascending and idx (B, k) int32 positions in 0..M-1;
// masked entries score +inf, ties go to the lowest index (lax.top_k), and a
// fully masked row gives inf with idx 0..k-1.  Inputs are assumed finite.
//
// Replaces: the Pallas kernel `batch_score_topk` in
// src/repro/kernels/batch_score.py (the MXU matmul identity with a running
// top-k carried across M tiles in a revisited output block), and for the
// gather entry also the `points[cand]` gather in front of it
// (src/repro/core/sann.py, sann_score_candidates_batch and
// sann_query_topk_batch).
//
// Bound on the H100: bytes.  Each live candidate costs 3 fp32 operations
// per element of a row it reads, far below the card's ratio of operations
// to bytes, and each query has its own candidates, so no operand is reused
// and tensor cores have nothing to exploit.  The gather entry must read
// qs, cand and ok once, each distinct point row that a live entry names
// once, and write the outputs.  On the S-ANN query path the point store
// (63 395 x 128 fp32, 32.5 MB) fits in the 50 MB L2, so the rows a query
// reads again come from L2: the practical limit is the L2 rate for the
// rows read per entry, and the fast path is many independent 16-byte loads
// in flight.
//
// Design, one block of 8 warps per query, over chunks of 512 candidates:
//   1. score: each warp holds up to 64 positions of the chunk, lane j the
//      j-th and (j + 32)-th; it loads their masks and slot ids at once (one
//      coalesced load each) and ballots the live ones.  Masked candidates
//      are not read at all (on the top-50 path about three in four are
//      masked: invalid slots and duplicates).  The live ones are scored 4
//      at a time: their rows' ids come from the owning lanes by shuffles,
//      then the lanes split d.  With d % 4 == 0 and 16-byte aligned rows,
//      lane j reads float4s j, j + 32, ... of all 4 rows (one 512-byte row
//      a warp-load at d = 128, 4 rows in flight a warp), else
//      single floats; each sums the squared differences in fp32 (the diff
//      form of the plain version) and a butterfly of shuffles adds the
//      lanes.  The result goes back to the candidate's lane as one 64-bit
//      key (float bits of d2 << 32 | m): d2 >= 0, so the keys order as
//      (d2, m), which is lax.top_k's order with ties to the lowest index.
//   2. select: k = 1 keeps a running minimum key a lane (the positions
//      then spread thin over the warps, so a short row is scored by all of
//      them) and reduces it over the block.  k > 1: each warp sorts its 64
//      keys in registers (a bitonic network of shuffles), then a tree of
//      merges halves the runs (3 levels, one barrier each; a merge keeps
//      the 64 smallest of two runs), and warp 0 merges the chunk's best 64
//      into the best so far, carried in its registers across chunks.  So M
//      has no limit, k <= 64, and shared memory holds only the 8 runs
//      (4 KB).
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::clampi;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 64;                  // keys a warp holds: 2 a lane
constexpr int kChunk = kWarps * kRun;     // candidates a block takes at once
constexpr int kRows = 4;                  // candidate rows a warp has in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPad = ~0ull;

typedef unsigned long long Key;

__device__ __forceinline__ Key make_key(float d2, int m) {
  return (static_cast<Key>(__float_as_uint(d2)) << 32) | static_cast<unsigned>(m);
}

__device__ __forceinline__ Key kmin(Key a, Key b) { return a < b ? a : b; }
__device__ __forceinline__ Key kmax(Key a, Key b) { return a < b ? b : a; }

// One compare-exchange step of a bitonic network over the warp's run of 64
// keys (lane j holds positions j in `a` and j + 32 in `b`), partners at
// distance `stride` < 32, direction ascending where (position & size) == 0.
__device__ __forceinline__ void cx_lanes(Key& a, Key& b, int stride, int size) {
  const int lane = threadIdx.x & 31;
  const bool lower = (lane & stride) == 0;
  const Key pa = __shfl_xor_sync(kFull, a, stride);
  const Key pb = __shfl_xor_sync(kFull, b, stride);
  const bool up_a = (lane & size) == 0;
  const bool up_b = ((lane + 32) & size) == 0;
  a = lower == up_a ? kmin(a, pa) : kmax(a, pa);
  b = lower == up_b ? kmin(b, pb) : kmax(b, pb);
}

// Sorts the warp's 64 keys ascending (bitonic, in registers).
__device__ __forceinline__ void warp_sort(Key& a, Key& b) {
#pragma unroll
  for (int size = 2; size < kRun; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) cx_lanes(a, b, stride, size);
  const Key lo = kmin(a, b), hi = kmax(a, b);   // size 64, stride 32
  a = lo;
  b = hi;
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) cx_lanes(a, b, stride, kRun);
}

// (a, b) and the ascending run `oa` / `ob` (another warp-held run of 64, in
// the same layout) → the 64 smallest of both, ascending.  The first step
// pairs position p with the other run's 63 - p, which leaves the 64
// smallest as a bitonic sequence; a bitonic merge then sorts it.
__device__ __forceinline__ void warp_merge(Key& a, Key& b, Key oa, Key ob) {
  const int lane = threadIdx.x & 31;
  const Key ra = __shfl_sync(kFull, ob, 31 - lane);   // other[63 - lane]
  const Key rb = __shfl_sync(kFull, oa, 31 - lane);   // other[31 - lane]
  a = kmin(a, ra);
  b = kmin(b, rb);
  const Key lo = kmin(a, b), hi = kmax(a, b);
  a = lo;
  b = hi;
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) cx_lanes(a, b, stride, kRun);
}

template <bool kGather, bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
batch_score_topk_kernel(const float* __restrict__ qs,
                        const float* __restrict__ rows,
                        const int* __restrict__ cand,
                        const unsigned char* __restrict__ ok,
                        float* __restrict__ out_d, int* __restrict__ out_i,
                        int M, int d, int k, int N) {
  __shared__ Key runs[kChunk];           // the warps' sorted runs
  __shared__ Key warp_best[kWarps];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* q = qs + static_cast<long long>(b) * d;
  const unsigned char* okb = ok + static_cast<long long>(b) * M;
  const int* cb = kGather ? cand + static_cast<long long>(b) * M : nullptr;
  Key best = kPad;                       // k == 1: this lane's minimum
  Key carry_a = kPad, carry_b = kPad;    // k > 1, warp 0: the best 64 so far

  for (int c0 = 0; c0 < M; c0 += kChunk) {
    const int len = min(kChunk, M - c0);
    // positions per warp: runs of 64 for the sort, spread thin for k = 1
    const int per = k == 1 ? min(kRun, (len + kWarps - 1) / kWarps) : kRun;
    const int first = c0 + warp * per;
    const int mine = max(0, min(per, len - warp * per));

    // 1. score; lane j holds positions first + j (slot 0), first + j + 32
    //    (slot 1): their masks and rows, fetched at once
    bool live0 = false, live1 = false;
    long long row0 = 0, row1 = 0;
    if (lane < mine) {
      live0 = okb[first + lane] != 0;
      row0 = kGather ? clampi(cb[first + lane], 0, N - 1)
                     : static_cast<long long>(b) * M + first + lane;
    }
    if (lane + 32 < mine) {
      live1 = okb[first + lane + 32] != 0;
      row1 = kGather ? clampi(cb[first + lane + 32], 0, N - 1)
                     : static_cast<long long>(b) * M + first + lane + 32;
    }
    float d2_0 = INFINITY, d2_1 = INFINITY;
    unsigned long long live = __ballot_sync(kFull, live0) |
        (static_cast<unsigned long long>(__ballot_sync(kFull, live1)) << 32);
    while (live) {                       // warp-uniform: the live ones only
      int from[kRows];
      const float* src[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        from[u] = live ? __ffsll(live) - 1 : -1;
        live &= live - 1;
        const int f = from[u] < 0 ? 0 : from[u];
        const long long r0 = __shfl_sync(kFull, row0, f & 31);
        const long long r1 = __shfl_sync(kFull, row1, f & 31);
        src[u] = rows + (f < 32 ? r0 : r1) * d;
      }
      float acc[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) acc[u] = 0.f;
      if (kVec) {
        const float4* q4 = reinterpret_cast<const float4*>(q);
        for (int j = lane; j < (d >> 2); j += 32) {
          const float4 qv = __ldg(q4 + j);
          float4 v[kRows];
#pragma unroll
          for (int u = 0; u < kRows; ++u)
            if (from[u] >= 0) v[u] = __ldg(reinterpret_cast<const float4*>(src[u]) + j);
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            if (from[u] < 0) continue;
            const float dx = v[u].x - qv.x, dy = v[u].y - qv.y;
            const float dz = v[u].z - qv.z, dw = v[u].w - qv.w;
            acc[u] += dx * dx + dy * dy + dz * dz + dw * dw;
          }
        }
      } else {
        for (int j = lane; j < d; j += 32) {
          const float qv = __ldg(q + j);
          float v[kRows];
#pragma unroll
          for (int u = 0; u < kRows; ++u)
            if (from[u] >= 0) v[u] = __ldg(src[u] + j);
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            if (from[u] < 0) continue;
            const float dx = v[u] - qv;
            acc[u] += dx * dx;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (from[u] < 0) break;          // warp-uniform
        float s = acc[u];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
        if (lane == (from[u] & 31)) {
          if (from[u] < 32) d2_0 = s;
          else d2_1 = s;
        }
      }
    }
    Key ka = lane < mine ? make_key(d2_0, first + lane) : kPad;
    Key kb = lane + 32 < mine ? make_key(d2_1, first + lane + 32) : kPad;

    // 2. select
    if (k == 1) {
      best = kmin(best, kmin(ka, kb));
      continue;
    }
    warp_sort(ka, kb);
    Key* run = runs + warp * kRun;
    run[lane] = ka;
    run[lane + 32] = kb;
    __syncthreads();
    for (int step = 1; step < kWarps; step <<= 1) {   // a tree of merges
      if ((warp & (2 * step - 1)) == 0) {
        const Key* other = runs + (warp + step) * kRun;
        warp_merge(ka, kb, other[lane], other[lane + 32]);
        run[lane] = ka;
        run[lane + 32] = kb;
      }
      __syncthreads();
    }
    if (warp == 0) {
      warp_merge(ka, kb, carry_a, carry_b);
      carry_a = ka;
      carry_b = kb;
    }
    __syncthreads();                     // runs are rewritten next chunk
  }

  if (k == 1) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      best = kmin(best, __shfl_xor_sync(kFull, best, off));
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    if (threadIdx.x == 0) {
      Key v = warp_best[0];
      for (int w = 1; w < kWarps; ++w) v = kmin(v, warp_best[w]);
      out_d[b] = __uint_as_float(static_cast<unsigned>(v >> 32));
      out_i[b] = static_cast<int>(static_cast<unsigned>(v));
    }
    return;
  }
  if (warp == 0) {
    const long long o = static_cast<long long>(b) * k;
    if (lane < k) {
      out_d[o + lane] = __uint_as_float(static_cast<unsigned>(carry_a >> 32));
      out_i[o + lane] = static_cast<int>(static_cast<unsigned>(carry_a));
    }
    if (lane + 32 < k) {
      out_d[o + lane + 32] = __uint_as_float(static_cast<unsigned>(carry_b >> 32));
      out_i[o + lane + 32] = static_cast<int>(static_cast<unsigned>(carry_b));
    }
  }
}

template <bool kGather>
int launch(const float* qs, const float* rows, const int* cand,
           const unsigned char* ok, float* out_d, int* out_i, int B, int M,
           int d, int k, int N, void* stream) {
  if (B < 1 || M < 1 || d < 1 || k < 1 || k > M || k > kRun)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(qs) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    batch_score_topk_kernel<kGather, true><<<B, kThreads, 0, s>>>(
        qs, rows, cand, ok, out_d, out_i, M, d, k, N);
  else
    batch_score_topk_kernel<kGather, false><<<B, kThreads, 0, s>>>(
        qs, rows, cand, ok, out_d, out_i, M, d, k, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int batch_score_topk_launch(const float* qs, const float* cands,
                                       const unsigned char* ok, float* out_d,
                                       int* out_i, int B, int M, int d, int k,
                                       void* stream) {
  return launch<false>(qs, cands, nullptr, ok, out_d, out_i, B, M, d, k, 0,
                       stream);
}

extern "C" int batch_score_topk_gather_launch(
    const float* qs, const float* points, const int* cand,
    const unsigned char* ok, float* out_d, int* out_i, int B, int M, int d,
    int k, int N, void* stream) {
  if (N < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(qs, points, cand, ok, out_d, out_i, B, M, d, k, N,
                      stream);
}
