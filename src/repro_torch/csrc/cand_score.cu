// cand_score — squared L2 distances of one query to M candidate rows:
// q (d,), cands (M, d) -> d2 (M,), fp32, diff-based: sum_j (c_j - q_j)^2.
//
// Replaces: the Pallas kernel `cand_score` in src/repro/kernels/cand_score.py
// (one (TM, d) tile of candidates per sequential grid step, scored on the
// TPU's vector unit).  The per-query S-ANN oracles call it: `sann_query`
// with M = 3L candidates and `sann_query_topk` with M = L * bucket_cap.
//
// Bound on the H100: bytes.  It reads M*d*4 bytes of candidates once (plus
// the query) for 3 fp32 operations per element and writes M floats.  At the
// oracles' shapes (M <= 384, d = 128) that is under 200 KB: one launch is
// far shorter than the launch latency, so the design only has to keep
// every load wide and every warp busy.
//
// Design: one warp per candidate row.  When d is a multiple of 4 and both
// pointers are 16-byte aligned, lane j reads float4 j, j+32, ... of the row
// and of the query (16-byte loads, 512 contiguous bytes per warp
// instruction); otherwise it reads scalars j, j+32, ...  Each lane sums its
// squared differences in fp32 and a butterfly of shuffles adds the lanes.
// It is the diff form, not the |c|^2 - 2 c.q + |q|^2 identity: the
// identity cancels catastrophically for the small distances that decide the
// (c, r) contract.  Sums run in another order than the plain version's, so
// the two agree to fp32 rounding (rtol 1e-5, atol 1e-6).
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void cand_score_kernel(const float* __restrict__ q,
                                  const float* __restrict__ cands,
                                  float* __restrict__ out, int M, int d,
                                  int vec4) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (m >= M) return;  // uniform per warp
  const float* c = cands + static_cast<long long>(m) * d;
  float part = 0.f;
  if (vec4) {
    const float4* c4 = reinterpret_cast<const float4*>(c);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const int d4 = d >> 2;
    for (int j = lane; j < d4; j += 32) {
      const float4 a = c4[j];
      const float4 b = q4[j];
      const float t0 = a.x - b.x, t1 = a.y - b.y, t2 = a.z - b.z, t3 = a.w - b.w;
      part = fmaf(t0, t0, part);
      part = fmaf(t1, t1, part);
      part = fmaf(t2, t2, part);
      part = fmaf(t3, t3, part);
    }
  } else {
    for (int j = lane; j < d; j += 32) {
      const float t = c[j] - q[j];
      part = fmaf(t, t, part);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
  if (lane == 0) out[m] = part;
}

}  // namespace

extern "C" int cand_score_launch(const float* q, const float* cands,
                                 float* out, int M, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(cands);
  const int vec4 = (d % 4 == 0) && (addr % 16 == 0);
  const int blocks = (M + kWarps - 1) / kWarps;
  cand_score_kernel<<<blocks, kWarps * 32, 0, s>>>(q, cands, out, M, d, vec4);
  return static_cast<int>(cudaGetLastError());
}
