// batch_score_topk — masked squared-L2 top-k per query:
// qs (B, d), cands (B, M, d), ok (B, M) -> d2 (B, k) ascending, idx (B, k).
//
// Replaces: the Pallas kernel `batch_score_topk` in
// src/repro/kernels/batch_score.py (the MXU matmul identity with a running
// top-k carried across M tiles in a revisited output block).
//
// Bound on the H100: bytes.  Every candidate vector is read once
// (B*M*d*4 bytes) for 3 fp32 operations per element, far below the card's
// ratio of operations to bytes.  Each query has its own candidates, so no
// operand is reused and tensor cores have nothing to exploit.
//
// Design: one warp per query.  The warp scores candidates in index order;
// for each one the lanes split the d axis (lane j reads elements j, j+32,
// ..., so each load instruction reads 128 contiguous bytes) and a butterfly
// of shuffles sums the squared differences in fp32, diff-based like the
// plain version.  The running top-k (k <= 64) lives in registers: lane j
// holds entries j and j+32 as (d2, index).  A candidate's rank among them is
// one ballot per half; when it is below k, the entries above it shift one
// place up through __shfl_up_sync.  Entries compare by (d2, index), so ties
// go to the lowest index as lax.top_k does; masked candidates score +inf
// and still enter in index order, so a fully masked row gives inf with
// idx 0..k-1 like the plain version.  Inputs are assumed finite.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool less_than(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

__global__ void batch_score_topk_kernel(const float* __restrict__ qs,
                                        const float* __restrict__ cands,
                                        const unsigned char* __restrict__ ok,
                                        float* __restrict__ out_d,
                                        int* __restrict__ out_i, int B, int M,
                                        int d, int k) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // uniform per warp
  const float* q = qs + static_cast<long long>(b) * d;
  const float* cb = cands + static_cast<long long>(b) * M * d;
  const unsigned char* okb = ok + static_cast<long long>(b) * M;

  // Entry j = lane in (lo_d, lo_i); entry j = lane + 32 in (hi_d, hi_i).
  float lo_d = INFINITY, hi_d = INFINITY;
  int lo_i = INT_MAX, hi_i = INT_MAX;
  for (int m = 0; m < M; ++m) {
    const float* c = cb + static_cast<long long>(m) * d;
    float part = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float diff = c[j] - q[j];
      part += diff * diff;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
    const float dn = okb[m] ? part : INFINITY;
    const bool lo_less = lane < k && less_than(lo_d, lo_i, dn, m);
    const bool hi_less = lane + 32 < k && less_than(hi_d, hi_i, dn, m);
    const int pos = __popc(__ballot_sync(kFull, lo_less)) +
                    __popc(__ballot_sync(kFull, hi_less));
    if (pos >= k) continue;  // uniform per warp
    float up_lo_d = __shfl_up_sync(kFull, lo_d, 1);
    int up_lo_i = __shfl_up_sync(kFull, lo_i, 1);
    float up_hi_d = __shfl_up_sync(kFull, hi_d, 1);
    int up_hi_i = __shfl_up_sync(kFull, hi_i, 1);
    const float last_lo_d = __shfl_sync(kFull, lo_d, 31);
    const int last_lo_i = __shfl_sync(kFull, lo_i, 31);
    if (lane == 0) {  // entry 32's predecessor is entry 31
      up_hi_d = last_lo_d;
      up_hi_i = last_lo_i;
    }
    if (lane > pos) {
      lo_d = up_lo_d;
      lo_i = up_lo_i;
    } else if (lane == pos) {
      lo_d = dn;
      lo_i = m;
    }
    if (lane + 32 > pos) {
      hi_d = up_hi_d;
      hi_i = up_hi_i;
    } else if (lane + 32 == pos) {
      hi_d = dn;
      hi_i = m;
    }
  }
  const long long o = static_cast<long long>(b) * k;
  if (lane < k) {
    out_d[o + lane] = lo_d;
    out_i[o + lane] = lo_i;
  }
  if (lane + 32 < k) {
    out_d[o + lane + 32] = hi_d;
    out_i[o + lane + 32] = hi_i;
  }
}

}  // namespace

extern "C" int batch_score_topk_launch(const float* qs, const float* cands,
                                       const unsigned char* ok, float* out_d,
                                       int* out_i, int B, int M, int d, int k,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (B + kWarps - 1) / kWarps;
  batch_score_topk_kernel<<<blocks, kWarps * 32, 0, s>>>(qs, cands, ok, out_d,
                                                         out_i, B, M, d, k);
  return static_cast<int>(cudaGetLastError());
}
