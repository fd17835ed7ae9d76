// swakde_segment_pass — one closed-form, expiry-free DGIM cascade settle per
// (row, segment) of the SW-AKDE chunk commit.
//
// Replaces: the Pallas kernel `swakde_segment_pass` in
// src/repro/kernels/ingest_commit.py, which tiled (row, segment-block) and
// ran the vectorised oracle `swakde_segment_pass_ref`
// (src/repro/kernels/ref.py) on each tile, including an O(C) masked count per
// segment to find the pass length.
//
// Bound on the H100: bytes.  One pass reads the gathered rings
// (R*G*levels*slots int32), the per-level counts, done/seg_first/seg_len and
// the stamps a segment consumes, and writes rings, counts and done once.  The
// arithmetic is a few dozen integer operations per ring entry.  At the main
// path's size (R = G = 96, 18 x 7 rings) that is about 9 MB per pass, so the
// launch and the host's check between passes cost more than the traffic.
//
// Design: one thread per (row, segment), so the per-level recurrence runs as
// scalar code with the level's ring, the carried prefix P and its successor
// in local arrays (slots <= 32).  The thread
//   1. expires its cell at the segment's first remaining arrival (counts and
//      the oldest live stamp, as the oracle's `live` mask);
//   2. finds the expiry-free length p by walking the segment forward and
//      stopping at the first arrival that fails.  Stamps ascend within a
//      segment, so both conditions select a prefix and the walk equals the
//      oracle's masked count; `cap` and the remaining length bound it;
//   3. settles each level in closed form: merge count mu, the new ring
//      (newest arrivals first, then the old ring shifted), and the carried-up
//      stamps (an explicit prefix of ring/P entries, then a stride-doubled
//      window into sorted_ts).
// Inactive segments (done == seg_len) run the same arithmetic with p = 0, as
// the oracle does.  One launch is one pass; the host loop in
// core/swakde.py drains the segments.  Divisions that can see a negative
// operand floor, and the int32 index arithmetic wraps as the reference's.
#include "common.cuh"

namespace {

using repro_torch::clampi;
using repro_torch::floor_div;
using repro_torch::wrap_add_mul;

constexpr int kThreads = 128;
constexpr int kMaxSlots = 32;

struct Queue {
  // Oldest-first queue of arrivals at one level: the live ring reversed,
  // then the explicit prefix P, then sorted_ts[b + (i - K) * stride].
  const int* ring;
  const int* pre;
  const int* row_ts;
  int m0, K, b, stride, S, C;

  __device__ __forceinline__ int operator()(int i) const {
    if (i < m0) return ring[clampi(m0 - 1 - i, 0, S - 1)];
    if (i < K) return pre[clampi(i - m0, 0, S - 1)];
    return row_ts[clampi(wrap_add_mul(b, i - K, stride), 0, C - 1)];
  }
};

__global__ void swakde_segment_pass_kernel(
    const int* __restrict__ cell_ts, const int* __restrict__ cell_num,
    const int* __restrict__ done, const int* __restrict__ sorted_ts,
    const int* __restrict__ seg_first, const int* __restrict__ seg_len,
    int* __restrict__ ts_out, int* __restrict__ num_out,
    int* __restrict__ done_out, int R, int G, int LV, int S, int C, int window,
    int maxb, int n_levels, int cap) {
  const long long cell = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (cell >= static_cast<long long>(R) * G) return;
  const int r = static_cast<int>(cell / G);
  const int* row_ts = sorted_ts + static_cast<long long>(r) * C;
  const int* ts_in = cell_ts + cell * LV * S;
  const int* num_in = cell_num + cell * LV;
  int* ts_o = ts_out + cell * LV * S;
  int* num_o = num_out + cell * LV;

  const int dn = done[cell];
  const int len = seg_len[cell];
  const int first = seg_first[cell];
  const bool active = dn < len;
  const int start = first + dn;
  const int t_first = row_ts[clampi(start, 0, C - 1)];

  // 1. expire at the first arrival; the oldest live stamp bounds the pass.
  int oldest = INT_MAX;
  for (int l = 0; l < LV; ++l) {
    const int m = num_in[l];
    int n_live = 0;
    for (int s = 0; s < S; ++s) {
      const int v = ts_in[l * S + s];
      if (s < m && v > t_first - window) {
        ++n_live;
        oldest = min(oldest, v);
      }
    }
    num_o[l] = active ? n_live : m;
  }

  // 2. expiry-free pass length: walk the remaining arrivals.
  int p = 0;
  if (active) {
    const int limit = cap > 0 ? min(len - dn, cap) : len - dn;
    const int end = min(first + len, C);
    for (int pos = max(start, 0); pos < end && p < limit; ++pos) {
      const int thr = row_ts[pos] - window;
      if (!(thr < oldest && thr < t_first)) break;
      ++p;
    }
  }

  // 3. per-level closed form.
  int ring[kMaxSlots], P[kMaxSlots], Pn[kMaxSlots];
  for (int s = 0; s < S; ++s) P[s] = 0;
  int np = 0, b = clampi(start, 0, C - 1), stride = 1, rr = p;
  for (int l = 0; l < LV; ++l) {
    for (int s = 0; s < S; ++s) ring[s] = ts_in[l * S + s];
    const int m0 = num_o[l];
    const int p_l = np + rr;  // arrivals at this level
    const int K = m0 + np;
    const int total = m0 + p_l;
    // The level fills to maxb+1 once, then every second arrival fires a
    // merge; the top level never merges.
    const int mu = (total <= maxb || l == n_levels - 1)
                       ? 0
                       : 1 + floor_div(p_l - (maxb + 1 - m0), 2);
    num_o[l] = total - 2 * mu;
    const Queue q{ring, P, row_ts, m0, K, b, stride, S, C};
    for (int s = 0; s < S; ++s) {
      ts_o[l * S + s] = s < p_l ? q(total - 1 - s) : ring[clampi(s - p_l, 0, S - 1)];
    }
    // Merge j consumes queue[2j], queue[2j+1] and carries up queue[2j+1].
    const int np_n = min(mu, floor_div(K, 2));
    for (int s = 0; s < S; ++s) Pn[s] = q(2 * s + 1);
    const int b_n = clampi(wrap_add_mul(b, 2 * np_n + 1 - K, stride), 0, C - 1);
    for (int s = 0; s < S; ++s) P[s] = Pn[s];
    rr = mu - np_n;
    np = np_n;
    b = b_n;
    stride = wrap_add_mul(0, stride, 2);
  }
  done_out[cell] = dn + p;
}

}  // namespace

extern "C" int swakde_segment_pass_launch(
    const int* cell_ts, const int* cell_num, const int* done,
    const int* sorted_ts, const int* seg_first, const int* seg_len,
    int* ts_out, int* num_out, int* done_out, int R, int G, int LV, int S,
    int C, int window, int maxb, int n_levels, int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(R) * G;
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  swakde_segment_pass_kernel<<<blocks, kThreads, 0, s>>>(
      cell_ts, cell_num, done, sorted_ts, seg_first, seg_len, ts_out, num_out,
      done_out, R, G, LV, S, C, window, maxb, n_levels, cap);
  return static_cast<int>(cudaGetLastError());
}
