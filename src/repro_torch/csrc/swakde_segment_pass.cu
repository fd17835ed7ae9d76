// swakde_segment_pass — the closed-form, expiry-free DGIM cascade settle of
// the SW-AKDE chunk commit, one warp per (row, segment).
//
// Replaces: the Pallas kernel `swakde_segment_pass` in
// src/repro/kernels/ingest_commit.py, which tiled (row, segment-block) and
// ran the vectorised oracle `swakde_segment_pass_ref`
// (src/repro/kernels/ref.py) on each tile, including an O(C) masked count per
// segment to find the pass length, and the `lax.while_loop` around it in
// src/repro/core/swakde.py (`swakde_commit_chunk`) that drains the segments.
//
// Two C entries run the same device code:
//   * swakde_segment_pass_launch — exactly one pass over gathered cells
//     (R, G, levels, slots), the reference's one-pass contract;
//   * swakde_segment_commit_launch — the whole commit of a chunk: each warp
//     reads its hit cell straight from the state grid (L, W, levels, slots)
//     by seg_code, runs passes until its segment is drained, and writes the
//     settled cell into the output grid (a copy of the state made by the
//     wrapper).  Sentinel segments (seg_code outside [0, W)) are skipped.
// The drain is exact because segments are independent: a pass reads only
// its own cell, its own `done` and the read-only stamps, and a drained
// segment's pass (p = 0) is the identity, so running each segment's passes
// back to back equals the reference's loop over all segments.  Every active
// pass consumes at least one arrival (thr = t - window lies below t_first
// and below every live stamp), so the loop is bounded by seg_len passes.
//
// Bound on the H100: bytes.  The commit returns a new grid: it reads the
// state grid, the stamps and the segments once and writes the grid once,
// about 11 MB at the main path's size (L = W = 96, 18 x 7 rings, 4096
// stamps a row), ~3 us at 3.35 TB/s; the grid copy is the wrapper's clone,
// and the kernel overwrites the hit cells.  The arithmetic is a few dozen
// integer operations per ring entry and pass, but it is serial along a
// segment's passes and levels, so a warp's time is latency: clustered data
// hits few cells a row, whose segments are long.
//
// Design: lane s of the warp owns ring slot s (slots <= 32); the cell lives
// in the warp's slice of shared memory for all passes.
//   1. expiry at the segment's first remaining arrival: the live mask of a
//      level is a ballot, its count a popcount, the oldest live stamp a warp
//      min over all levels;
//   2. the expiry-free length p: a ballot over 32 stamps at a time, whose
//      trailing ones count the prefix (stamps ascend within a segment, so
//      both conditions select a prefix), with 4 x 32 stamps loaded before
//      the ballots so that a long segment waits on memory once per 128;
//      `cap` and the remaining length bound it;
//   3. each level in closed form: merge count mu, the new ring (newest
//      arrivals first, then the old ring shifted) and the carried-up stamps
//      (an explicit prefix of ring/P entries, then a stride-doubled window
//      into the segment's own stamps).  Ring and P entries come from the
//      owning lane by __shfl_sync; only the strided tail reads memory.
// Blocks of 4 warps over one row.  Divisions that can see a negative operand
// floor, and the int32 index arithmetic wraps as the reference's.
#include "common.cuh"

namespace {

using repro_torch::clampi;
using repro_torch::floor_div;
using repro_torch::wrap_add_mul;

constexpr int kWarps = 4;            // warps (segments) per block
constexpr int kMaxSlots = 32;
constexpr int kWalk = 4;             // 32-stamp ballots per load round
constexpr unsigned kFull = 0xffffffffu;

struct Geometry {
  int C, S, LV, window, maxb, n_levels, cap;
};

// Oldest-first queue of arrivals at one level, looked up at a per-lane
// index i: the live ring reversed, then the explicit prefix P, then
// row_ts[b + (i - K) * stride].  Every lane must call it (shuffles).
__device__ __forceinline__ int queue_at(int i, int ring, int P, int m0, int K,
                                        int b, int stride,
                                        const int* __restrict__ row_ts,
                                        const Geometry& g) {
  const int rv = __shfl_sync(kFull, ring, clampi(m0 - 1 - i, 0, g.S - 1));
  const int pv = __shfl_sync(kFull, P, clampi(i - m0, 0, g.S - 1));
  if (i < m0) return rv;
  if (i < K) return pv;
  return row_ts[clampi(wrap_add_mul(b, i - K, stride), 0, g.C - 1)];
}

// One pass over the warp's cell in shared memory (ts: LV x 32, num and m0s:
// LV).  Returns the arrivals consumed.
__device__ int settle_pass(int* ts, int* num, int* m0s, int dn, int len,
                           int first, const int* __restrict__ row_ts,
                           const Geometry& g) {
  const int lane = threadIdx.x & 31;
  const bool active = dn < len;
  const int start = first + dn;
  const int t_first = row_ts[clampi(start, 0, g.C - 1)];

  // 1. expire at the first arrival; the oldest live stamp bounds the pass.
  int oldest = INT_MAX;
  for (int l = 0; l < g.LV; ++l) {
    const int m = num[l];
    const int v = ts[l * 32 + lane];
    const bool live = lane < g.S && lane < m && v > t_first - g.window;
    const int n_live = __popc(__ballot_sync(kFull, live));
    if (live) oldest = min(oldest, v);
    if (lane == 0) m0s[l] = active ? n_live : m;
  }
  oldest = __reduce_min_sync(kFull, oldest);
  __syncwarp();

  // 2. expiry-free pass length: the prefix of remaining arrivals that pass.
  int p = 0;
  if (active) {
    const int limit = g.cap > 0 ? min(len - dn, g.cap) : len - dn;
    const int end = min(first + len, g.C);
    bool stop = false;
    for (int base = max(start, 0); !stop && base < end && p < limit;
         base += 32 * kWalk) {
      int v[kWalk];  // all loads first: one memory latency per kWalk * 32
#pragma unroll
      for (int j = 0; j < kWalk; ++j) {
        const int pos = base + 32 * j + lane;
        v[j] = pos < end ? row_ts[pos] : 0;
      }
#pragma unroll
      for (int j = 0; j < kWalk; ++j) {
        const int thr = v[j] - g.window;
        const bool ok = base + 32 * j + lane < end && thr < oldest && thr < t_first;
        const unsigned bal = __ballot_sync(kFull, ok);
        if (bal != kFull) {  // warp-uniform
          p += __ffs(~bal) - 1;
          stop = true;
          break;
        }
        p += 32;
      }
    }
    p = min(p, limit);
  }

  // 3. per-level closed form; lane s holds ring[s], P[s].
  int P = 0, np = 0, b = clampi(start, 0, g.C - 1), stride = 1, rr = p;
  for (int l = 0; l < g.LV; ++l) {
    const int ring = ts[l * 32 + lane];
    const int m0 = m0s[l];
    const int p_l = np + rr;  // arrivals at this level
    const int K = m0 + np;
    const int total = m0 + p_l;
    // The level fills to maxb+1 once, then every second arrival fires a
    // merge; the top level never merges.
    const int mu = (total <= g.maxb || l == g.n_levels - 1)
                       ? 0
                       : 1 + floor_div(p_l - (g.maxb + 1 - m0), 2);
    const int arr = queue_at(total - 1 - lane, ring, P, m0, K, b, stride,
                             row_ts, g);
    const int old = __shfl_sync(kFull, ring, clampi(lane - p_l, 0, g.S - 1));
    // Merge j consumes queue[2j], queue[2j+1] and carries up queue[2j+1].
    const int pn = queue_at(2 * lane + 1, ring, P, m0, K, b, stride, row_ts, g);
    if (lane < g.S) ts[l * 32 + lane] = lane < p_l ? arr : old;
    if (lane == 0) num[l] = total - 2 * mu;
    const int np_n = min(mu, floor_div(K, 2));
    b = clampi(wrap_add_mul(b, 2 * np_n + 1 - K, stride), 0, g.C - 1);
    P = pn;
    rr = mu - np_n;
    np = np_n;
    stride = wrap_add_mul(0, stride, 2);
  }
  __syncwarp();
  return p;
}

// kDrain = false: one pass over gathered cells (R, G, ...), every segment,
// done read and written.  kDrain = true: the commit over the state grid
// (R, W, ...), passes until the segment is drained, sentinels skipped.
template <bool kDrain>
__global__ void __launch_bounds__(kWarps * 32)
swakde_segment_pass_kernel(const int* __restrict__ cell_ts,
                           const int* __restrict__ cell_num,
                           const int* __restrict__ done,
                           const int* __restrict__ sorted_ts,
                           const int* __restrict__ seg_code,
                           const int* __restrict__ seg_first,
                           const int* __restrict__ seg_len,
                           int* __restrict__ ts_out, int* __restrict__ num_out,
                           int* __restrict__ done_out, int G, int W,
                           Geometry g) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg = blockIdx.x * kWarps + warp;
  if (seg >= G) return;  // warp-uniform
  const int r = blockIdx.y;
  const long long rg = static_cast<long long>(r) * G + seg;
  int* ts = smem + warp * g.LV * 34;
  int* num = ts + g.LV * 32;
  int* m0s = num + g.LV;

  long long cell;
  int dn = 0;
  if (kDrain) {
    const int code = seg_code[rg];
    if (code < 0 || code >= W) return;  // sentinel segment
    cell = static_cast<long long>(r) * W + code;
  } else {
    cell = rg;
    dn = done[rg];
  }
  const int len = seg_len[rg];
  const int first = seg_first[rg];
  const int* row_ts = sorted_ts + static_cast<long long>(r) * g.C;
  const int n_ts = g.LV * g.S;
  const int* ts_in = cell_ts + cell * n_ts;
  const int* num_in = cell_num + cell * g.LV;

  for (int i = lane; i < n_ts; i += 32) {  // coalesced: the cell is contiguous
    const int l = i / g.S;
    ts[l * 32 + (i - l * g.S)] = ts_in[i];
  }
  for (int l = lane; l < g.LV; l += 32) num[l] = num_in[l];
  __syncwarp();

  if (kDrain) {
    for (int pass = 0; dn < len && pass < len; ++pass)
      dn += settle_pass(ts, num, m0s, dn, len, first, row_ts, g);
  } else {
    dn += settle_pass(ts, num, m0s, dn, len, first, row_ts, g);
  }

  int* ts_o = ts_out + cell * n_ts;
  int* num_o = num_out + cell * g.LV;
  for (int i = lane; i < n_ts; i += 32) {
    const int l = i / g.S;
    ts_o[i] = ts[l * 32 + (i - l * g.S)];
  }
  for (int l = lane; l < g.LV; l += 32) num_o[l] = num[l];
  if (!kDrain && lane == 0) done_out[rg] = dn;
}

template <bool kDrain>
int launch(const int* cell_ts, const int* cell_num, const int* done,
           const int* sorted_ts, const int* seg_code, const int* seg_first,
           const int* seg_len, int* ts_out, int* num_out, int* done_out, int R,
           int G, int W, const Geometry& g, void* stream) {
  if (g.S < 1 || g.S > kMaxSlots || g.LV < 1 || g.C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kWarps) * g.LV * 34 * sizeof(int);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((G + kWarps - 1) / kWarps, R);
  swakde_segment_pass_kernel<kDrain>
      <<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
          cell_ts, cell_num, done, sorted_ts, seg_code, seg_first, seg_len,
          ts_out, num_out, done_out, G, W, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One pass over gathered cells (R, G, LV, S): the reference's contract.
extern "C" int swakde_segment_pass_launch(
    const int* cell_ts, const int* cell_num, const int* done,
    const int* sorted_ts, const int* seg_first, const int* seg_len,
    int* ts_out, int* num_out, int* done_out, int R, int G, int LV, int S,
    int C, int window, int maxb, int n_levels, int cap, void* stream) {
  const Geometry g{C, S, LV, window, maxb, n_levels, cap};
  return launch<false>(cell_ts, cell_num, done, sorted_ts, nullptr, seg_first,
                       seg_len, ts_out, num_out, done_out, R, G, 0, g, stream);
}

// The drained commit: reads cells from the grid (R, W, LV, S) by seg_code
// and writes the settled ones into ts_out / num_out (a copy of the grid).
extern "C" int swakde_segment_commit_launch(
    const int* ts, const int* num, const int* sorted_ts, const int* seg_code,
    const int* seg_first, const int* seg_len, int* ts_out, int* num_out,
    int R, int G, int W, int LV, int S, int C, int window, int maxb,
    int n_levels, int cap, void* stream) {
  const Geometry g{C, S, LV, window, maxb, n_levels, cap};
  return launch<true>(ts, num, nullptr, sorted_ts, seg_code, seg_first,
                      seg_len, ts_out, num_out, nullptr, R, G, W, g, stream);
}
