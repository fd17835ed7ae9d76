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
// Design: one warp per segment; lane j owns ring slots j, j + 32, ... of
// every level (ceil(S / 32) of them).  The cell lives in the warp's slice of
// shared memory (or, past 227 KB, of a global scratch buffer) for all passes.
//   1. expiry at the segment's first remaining arrival: the live mask of a
//      level is one ballot per 32 slots, its count the sum of their
//      popcounts, the oldest live stamp a warp min over every slot a lane
//      holds;
//   2. the expiry-free length p: a ballot over 32 stamps at a time, whose
//      trailing ones count the prefix (stamps ascend within a segment, so
//      both conditions select a prefix), with 4 x 32 stamps loaded before
//      the ballots so that a long segment waits on memory once per 128;
//      `cap` and the remaining length bound it;
//   3. each level in closed form: merge count mu, the new ring (newest
//      arrivals first, then the old ring shifted) and the carried-up stamps
//      (an explicit prefix of ring/P entries, then a stride-doubled window
//      into the segment's own stamps).  Only the strided tail reads memory.
// Three forms, chosen per launch:
//   * S <= 32 (the common case, e.g. eps = 0.1 gives 7 slots): one slot a
//     lane; the ring is read from shared memory, the carried prefix P lives
//     in a register and every ring or P lookup is a __shfl_sync to the
//     owning lane.  Shared memory a warp: LV * 34 ints.
//   * S > 32, the cell in shared memory: the lookups read the owning slot
//     from shared memory, where P (double-buffered across levels) and the
//     new ring (staged, then copied over the old one after a __syncwarp)
//     also live.  A warp's cell: LV * (S_pad + 2) + 3 * S_pad ints,
//     S_pad = 32 * ceil(S / 32).  A block holds up to 4 warps over one row,
//     fewer when their cells do not fit in 227 KB (above 48 KB the launch
//     raises the kernel's dynamic shared-memory limit).
//   * S > 32, the cell in global memory: the same code and layout, on the
//     warp's own slice of a scratch buffer that the wrapper allocates once a
//     call (one slice per (row, segment)), for a cell larger than the
//     232 448 bytes a block may use (at window 65 536, eps 1e-4: 18 levels x
//     5002 slots, 422 160 bytes).  __syncwarp orders the lanes' global
//     writes and reads as it does in shared memory; the slice stays hot in
//     L1/L2 across a warp's passes.  4 warps a block, no shared memory.
// The wrapper chooses the form by the cell's size before the launch
// (`kernels.ingest_commit.swakde_cell_form`): a non-null scratch pointer
// selects the global form.  Divisions that can see a negative operand
// floor, and the int32 index arithmetic wraps as the reference's.
#include "common.cuh"

namespace {

using repro_torch::clampi;
using repro_torch::floor_div;
using repro_torch::wrap_add_mul;

constexpr int kMaxWarps = 4;         // warps (segments) per block, at most
constexpr int kWalk = 4;             // 32-stamp ballots per load round
constexpr int kSmemLimit = 232448;   // bytes of shared memory a block may use
constexpr unsigned kFull = 0xffffffffu;

struct Geometry {
  int C, S, Sp, LV, window, maxb, n_levels, cap;
};

// Ints a warp's cell takes in the S > 32 layout (shared or global).
__host__ __device__ __forceinline__ int wide_cell_ints(const Geometry& g) {
  return g.LV * (g.Sp + 2) + 3 * g.Sp;
}

// Ints of memory a warp's cell takes in a form (see the design note).
__host__ __device__ __forceinline__ int warp_cell_ints(const Geometry& g,
                                                       bool wide) {
  return wide ? wide_cell_ints(g) : g.LV * 34;
}

// Oldest-first queue of arrivals at one level, looked up at a per-lane
// index i: the live ring reversed, then the explicit prefix P, then
// row_ts[b + (i - K) * stride].  S <= 32 form: ring and P are the lane's
// own slot, fetched from the owner by shuffles, so every lane must call it.
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

// The same lookup with ring and P in shared memory (S > 32 form).
__device__ __forceinline__ int queue_smem(int i, const int* ring, const int* P,
                                          int m0, int K, int b, int stride,
                                          const int* __restrict__ row_ts,
                                          const Geometry& g) {
  if (i < m0) return ring[clampi(m0 - 1 - i, 0, g.S - 1)];
  if (i < K) return P[clampi(i - m0, 0, g.S - 1)];
  return row_ts[clampi(wrap_add_mul(b, i - K, stride), 0, g.C - 1)];
}

// Step 2: the expiry-free length of the pass starting at arrival `dn`.
__device__ __forceinline__ int pass_length(int dn, int len, int first,
                                           int start, int t_first, int oldest,
                                           const int* __restrict__ row_ts,
                                           const Geometry& g) {
  const int lane = threadIdx.x & 31;
  int p = 0;
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
  return min(p, limit);
}

// One pass over the warp's cell (in shared memory or its global slice): ts
// (LV x Sp), num and m0s (LV each), and for S > 32 the scratch P0, P1 and
// staged ring (Sp each).
// Returns the arrivals consumed.
template <bool kWide>
__device__ int settle_pass(int* ts, int* num, int* m0s, int* scratch, int dn,
                           int len, int first, const int* __restrict__ row_ts,
                           const Geometry& g) {
  const int lane = threadIdx.x & 31;
  const bool active = dn < len;
  const int start = first + dn;
  const int t_first = row_ts[clampi(start, 0, g.C - 1)];

  // 1. expire at the first arrival; the oldest live stamp bounds the pass.
  int oldest = INT_MAX;
  for (int l = 0; l < g.LV; ++l) {
    const int m = num[l];
    int n_live = 0;
    for (int s = lane; s < (kWide ? g.Sp : 32); s += 32) {  // warp-uniform trips
      const int v = ts[l * g.Sp + s];
      const bool live = s < g.S && s < m && v > t_first - g.window;
      n_live += __popc(__ballot_sync(kFull, live));
      if (live) oldest = min(oldest, v);
    }
    if (lane == 0) m0s[l] = active ? n_live : m;
  }
  oldest = __reduce_min_sync(kFull, oldest);
  __syncwarp();

  // 2. expiry-free pass length: the prefix of remaining arrivals that pass.
  const int p = active ? pass_length(dn, len, first, start, t_first, oldest,
                                     row_ts, g)
                       : 0;

  // 3. per-level closed form.
  int np = 0, b = clampi(start, 0, g.C - 1), stride = 1, rr = p;
  int P = 0;                                   // S <= 32: lane s holds P[s]
  int* Pc = scratch;                           // S > 32: P in the cell,
  int* Pn = scratch + g.Sp;                    // the next level's P,
  int* staged = scratch + 2 * g.Sp;            // and the new ring
  for (int l = 0; l < g.LV; ++l) {
    int* ring_l = ts + l * g.Sp;
    const int m0 = m0s[l];
    const int p_l = np + rr;  // arrivals at this level
    const int K = m0 + np;
    const int total = m0 + p_l;
    // The level fills to maxb+1 once, then every second arrival fires a
    // merge; the top level never merges.
    const int mu = (total <= g.maxb || l == g.n_levels - 1)
                       ? 0
                       : 1 + floor_div(p_l - (g.maxb + 1 - m0), 2);
    if (kWide) {
      // Merge j consumes queue[2j], queue[2j+1] and carries up queue[2j+1].
      for (int s = lane; s < g.S; s += 32) {
        staged[s] = s < p_l
            ? queue_smem(total - 1 - s, ring_l, Pc, m0, K, b, stride, row_ts, g)
            : ring_l[clampi(s - p_l, 0, g.S - 1)];
        Pn[s] = queue_smem(2 * s + 1, ring_l, Pc, m0, K, b, stride, row_ts, g);
      }
      __syncwarp();  // every lane has read the old ring and P
      for (int s = lane; s < g.S; s += 32) ring_l[s] = staged[s];
      int* t = Pc;
      Pc = Pn;
      Pn = t;
    } else {
      const int ring = ring_l[lane];
      const int arr = queue_at(total - 1 - lane, ring, P, m0, K, b, stride,
                               row_ts, g);
      const int old = __shfl_sync(kFull, ring, clampi(lane - p_l, 0, g.S - 1));
      // Merge j consumes queue[2j], queue[2j+1] and carries up queue[2j+1].
      const int pn = queue_at(2 * lane + 1, ring, P, m0, K, b, stride, row_ts, g);
      if (lane < g.S) ring_l[lane] = lane < p_l ? arr : old;
      P = pn;
    }
    if (lane == 0) num[l] = total - 2 * mu;
    const int np_n = min(mu, floor_div(K, 2));
    b = clampi(wrap_add_mul(b, 2 * np_n + 1 - K, stride), 0, g.C - 1);
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
// kGlobal: the cell lives in scratch[(r * G + seg) * wide_cell_ints] instead
// of shared memory (kWide layout).
template <bool kDrain, bool kWide, bool kGlobal>
__global__ void __launch_bounds__(kMaxWarps * 32)
swakde_segment_pass_kernel(const int* __restrict__ cell_ts,
                           const int* __restrict__ cell_num,
                           const int* __restrict__ done,
                           const int* __restrict__ sorted_ts,
                           const int* __restrict__ seg_code,
                           const int* __restrict__ seg_first,
                           const int* __restrict__ seg_len,
                           int* __restrict__ ts_out, int* __restrict__ num_out,
                           int* __restrict__ done_out,
                           int* scratch_all, int G, int W,
                           Geometry g) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg = blockIdx.x * (blockDim.x >> 5) + warp;
  if (seg >= G) return;  // warp-uniform
  const int r = blockIdx.y;
  const long long rg = static_cast<long long>(r) * G + seg;
  int* ts = kGlobal ? scratch_all + rg * wide_cell_ints(g)
                    : smem + warp * warp_cell_ints(g, kWide);
  int* num = ts + g.LV * g.Sp;
  int* m0s = num + g.LV;
  int* scratch = m0s + g.LV;

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
    ts[l * g.Sp + (i - l * g.S)] = ts_in[i];
  }
  for (int l = lane; l < g.LV; l += 32) num[l] = num_in[l];
  __syncwarp();

  if (kDrain) {
    for (int pass = 0; dn < len && pass < len; ++pass)
      dn += settle_pass<kWide>(ts, num, m0s, scratch, dn, len, first, row_ts, g);
  } else {
    dn += settle_pass<kWide>(ts, num, m0s, scratch, dn, len, first, row_ts, g);
  }

  int* ts_o = ts_out + cell * n_ts;
  int* num_o = num_out + cell * g.LV;
  for (int i = lane; i < n_ts; i += 32) {
    const int l = i / g.S;
    ts_o[i] = ts[l * g.Sp + (i - l * g.S)];
  }
  for (int l = lane; l < g.LV; l += 32) num_o[l] = num[l];
  if (!kDrain && lane == 0) done_out[rg] = dn;
}

template <bool kDrain, bool kWide, bool kGlobal>
int launch_form(const int* cell_ts, const int* cell_num, const int* done,
                const int* sorted_ts, const int* seg_code, const int* seg_first,
                const int* seg_len, int* ts_out, int* num_out, int* done_out,
                int* scratch, int R, int G, int W, const Geometry& g,
                void* stream) {
  int warps = kMaxWarps;
  size_t smem = 0;
  if (!kGlobal) {
    const size_t cell =
        static_cast<size_t>(warp_cell_ints(g, kWide)) * sizeof(int);
    if (cell > static_cast<size_t>(kSmemLimit))
      return static_cast<int>(cudaErrorInvalidValue);
    warps = static_cast<int>(cell * kMaxWarps <= static_cast<size_t>(kSmemLimit)
                                 ? kMaxWarps
                                 : static_cast<size_t>(kSmemLimit) / cell);
    smem = cell * warps;
  }
  auto kernel = swakde_segment_pass_kernel<kDrain, kWide, kGlobal>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((G + warps - 1) / warps, R);
  kernel<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      cell_ts, cell_num, done, sorted_ts, seg_code, seg_first, seg_len, ts_out,
      num_out, done_out, scratch, G, W, g);
  return static_cast<int>(cudaGetLastError());
}

// scratch == nullptr: the cell in shared memory (refused past 227 KB);
// otherwise the global form on R * G slices of wide_cell_ints(g) ints.
template <bool kDrain>
int launch(const int* cell_ts, const int* cell_num, const int* done,
           const int* sorted_ts, const int* seg_code, const int* seg_first,
           const int* seg_len, int* ts_out, int* num_out, int* done_out,
           int* scratch, int R, int G, int W, const Geometry& g,
           void* stream) {
  if (g.S < 1 || g.LV < 1 || g.C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (scratch != nullptr)
    return launch_form<kDrain, true, true>(cell_ts, cell_num, done, sorted_ts,
                                           seg_code, seg_first, seg_len, ts_out,
                                           num_out, done_out, scratch, R, G, W,
                                           g, stream);
  if (g.S <= 32)
    return launch_form<kDrain, false, false>(
        cell_ts, cell_num, done, sorted_ts, seg_code, seg_first, seg_len,
        ts_out, num_out, done_out, nullptr, R, G, W, g, stream);
  return launch_form<kDrain, true, false>(cell_ts, cell_num, done, sorted_ts,
                                          seg_code, seg_first, seg_len, ts_out,
                                          num_out, done_out, nullptr, R, G, W,
                                          g, stream);
}

Geometry geometry(int C, int S, int LV, int window, int maxb, int n_levels,
                  int cap) {
  const int Sp = S <= 32 ? 32 : 32 * ((S + 31) / 32);
  return Geometry{C, S, Sp, LV, window, maxb, n_levels, cap};
}

}  // namespace

// One pass over gathered cells (R, G, LV, S): the reference's contract.
// scratch: null, or R * G * (LV * (S_pad + 2) + 3 * S_pad) ints for the
// global form.
extern "C" int swakde_segment_pass_launch(
    const int* cell_ts, const int* cell_num, const int* done,
    const int* sorted_ts, const int* seg_first, const int* seg_len,
    int* ts_out, int* num_out, int* done_out, int* scratch, int R, int G,
    int LV, int S, int C, int window, int maxb, int n_levels, int cap,
    void* stream) {
  const Geometry g = geometry(C, S, LV, window, maxb, n_levels, cap);
  return launch<false>(cell_ts, cell_num, done, sorted_ts, nullptr, seg_first,
                       seg_len, ts_out, num_out, done_out, scratch, R, G, 0, g,
                       stream);
}

// The drained commit: reads cells from the grid (R, W, LV, S) by seg_code
// and writes the settled ones into ts_out / num_out (a copy of the grid).
// scratch as for the one-pass entry (R * G slices).
extern "C" int swakde_segment_commit_launch(
    const int* ts, const int* num, const int* sorted_ts, const int* seg_code,
    const int* seg_first, const int* seg_len, int* ts_out, int* num_out,
    int* scratch, int R, int G, int W, int LV, int S, int C, int window,
    int maxb, int n_levels, int cap, void* stream) {
  const Geometry g = geometry(C, S, LV, window, maxb, n_levels, cap);
  return launch<true>(ts, num, nullptr, sorted_ts, seg_code, seg_first,
                      seg_len, ts_out, num_out, nullptr, scratch, R, G, W, g,
                      stream);
}
