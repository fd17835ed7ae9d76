// sketch_decode_attn — sketch-pruned flash-decode attention over the live
// KV blocks of each request, GQA, softcap and kv_len mask:
//   q (B, Hkv, G, dh) fp32|bf16, k/v (B, S, Hkv, dh) bf16|fp32,
//   block_ids (B, nb_max) int32 (live block ids first, -1 padded),
//   n_live (B,) int32, scalars kv_len, block_size, softcap
//   -> out (B, Hkv, G, dh) fp32
// For each (request b, KV head h) and each of its G query rows:
//   softmax over the positions p of the first n_live[b] listed blocks with
//   p < kv_len of  s = softcap * tanh((q . k_p) * scale / softcap)  (or
//   (q . k_p) * scale when softcap <= 0), scale = 1/sqrt(dh), times v_p;
//   out = acc / max(l, 1e-30) where l > 0, else 0 (an empty list gives 0).
// The partial entry (sketch_decode_attn_lse_launch) runs the same kernels
// over one rank's block of a sequence split over a mesh and also writes
// lse (B, Hkv, G) fp32 = m + log(l) of each query row, -inf where nothing
// is live, so the ranks' outputs merge by their log-sum-exps.
//
// Replaces: the Pallas kernel `sketch_decode_attn` in
// src/repro/kernels/sketch_decode_attn.py (grid (Hkv, nb_max) for one
// request; the live-list axis runs in order on the TPU core and carries the
// running (m, l, acc) in VMEM scratch from one grid step to the next).
//
// Bound on the H100: bytes.  Every live K and V row below kv_len is read
// once (2 * Hkv * dh * sizeof(kv) bytes a position); each element costs
// 2 * G flops against q and 2 * G against p, and G = 2 for gemma3-4b, so the
// work is ~1 flop a byte, far below the card's ridge point.  No tensor
// cores are needed.  At B = 1, S = 131 072, Hkv = 4, dh = 256 in bf16 with
// every block live the bound is 0.16 ms (537 MB at 3.35 TB/s).
//
// Design: blocks run in parallel and nothing carries over between them, so
// the live list is split.  Grid (B * Hkv, n_split): block (bh, s) walks a
// contiguous share of its request's live list in tiles of rows (a tile
// never crosses a sketch block; rows at or past kv_len are never read) and
// writes its partial (m, l, acc) to scratch that the wrapper allocates.  A
// second small launch combines the splits in split order, so the result
// does not depend on scheduling; there are no atomics.  The kernel reads
// n_live and block_ids on the device, so the host never waits.  Sums run
// in another order than the plain version's: the two agree to fp32
// rounding.
//
// The fast path (`sketch_decode_attn_pipe`; bf16 K/V, dh in {64, 128, 256,
// 512}, 16-byte aligned K and V, G <= 8) is a latency problem, not an
// arithmetic one: it keeps bytes in flight.
//   * K/V tiles of kTile = 32 rows arrive through a ring of up to 6
//     stages in shared memory by cp.async 16-byte copies (rows past the
//     tile's end are zero-filled, not read), so tiles t+1 ... t+5 load
//     while tile t is computed; one __syncthreads a tile.  A stage is
//     2 * 32 * dh * 2 bytes: at dh 256, 6 stages are 192 KB, one block an
//     SM with 160 KB in flight (chosen over two blocks of 3 stages each by
//     timing both on the H100).  dh 512 has 3.
//   * Every row of a tile has one owner, a group of LPG = min(32, dh / 8)
//     lanes of one warp; each lane owns 8 * NCH contiguous columns of dh
//     (NCH = 2 at dh 512, else 1) and keeps q's and the accumulator's
//     values for them in registers.  A score is 16-byte shared reads and
//     8 * NCH FMAs a query row; one group reduction then sums all of an
//     owner's rows and query rows of the tile at once (`group_sum_all`:
//     5 + 8 shuffles for gemma3's 4 rows x 2 query rows, not 40).  P.V is
//     16-byte shared reads of V into the lane's own columns, no shuffle.
//     The tile's index arithmetic is 32-bit, done once a tile by each thread
//     when it issues the copies; the row count reaches the compute through
//     shared memory.
//   * Each owner runs its own online softmax (running m, l, acc) over its
//     rows, so no warp waits for another within the tile loop.  The owners
//     of a warp merge by shuffles, the warps through shared memory, once a
//     split.
// Any other shape (fp32 K/V, other dh, unaligned rows) takes the simple
// path `sketch_decode_attn_split`: tiles of 64 rows read from global
// memory one tile at a time, a 32-lane butterfly a row.
//
// Constants that kernels/sketch_decode_attn.py mirrors: kTile (TILE),
// kMaxG (MAX_G), kMaxDh (MAX_DH), kBlocksPerSm (BLOCKS_PER_SM: the fast
// path's occupancy at dh 256, which the wrapper's split count targets).
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;        // query rows per KV head
constexpr int kMaxDh = 512;     // = kThreads * kMaxCols
constexpr unsigned kFull = 0xffffffffu;
// fast path
constexpr int kTile = 32;       // K/V rows per tile
constexpr int kRingBytes = 192 * 1024;  // the ring's shared memory at dh >= 256
constexpr int kMaxStages = 6;   // tiles in the ring
constexpr int kBlocksPerSm = 1; // one block of 192 KB an SM at dh 256
// Ring stages for CPR 16-byte chunks a row: 6 at dh <= 256, 3 at dh 512.
__host__ __device__ constexpr int stages_for(int cpr) {
  return kRingBytes / (2 * kTile * cpr * 16) < kMaxStages
             ? kRingBytes / (2 * kTile * cpr * 16) : kMaxStages;
}
// simple path
constexpr int kSimpleTile = 64;
constexpr int kMaxCols = 2;     // dh <= kThreads * kMaxCols

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of a row as fp32.
template <typename T> struct Chunk;
template <> struct Chunk<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
};
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <typename QT, typename KT, bool kVec>
__global__ void __launch_bounds__(kThreads) sketch_decode_attn_split(
    const QT* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, const int* __restrict__ block_ids,
    const int* __restrict__ n_live, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int Hkv, int G, int dh, int S, int nb_max,
    int kv_len, int block_size, int n_split, float scale, float softcap,
    float inv_softcap) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;               // (G, dh) query rows, fp32
  float* s_s = smem + G * dh;      // (G, kSimpleTile) scores, then p
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];

  const int bh = blockIdx.x;
  const int b = bh / Hkv, h = bh % Hkv;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const QT* qb = q + static_cast<long long>(bh) * G * dh;
  for (int i = tid; i < G * dh; i += kThreads) q_s[i] = to_f32(qb[i]);
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kMaxG][kMaxCols];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[g][c] = 0.f;

  const int nl = repro_torch::clampi(n_live[b], 0, nb_max);
  const int n_blocks = S / block_size;
  const int tpb = (block_size + kSimpleTile - 1) / kSimpleTile;   // tiles per block
  const long long total = static_cast<long long>(nl) * tpb;
  const long long t_begin = total * split / n_split;
  const long long t_end = total * (split + 1) / n_split;
  const long long row_stride = static_cast<long long>(Hkv) * dh;

  for (long long t = t_begin; t < t_end; ++t) {
    const int bid = max(block_ids[static_cast<long long>(b) * nb_max + t / tpb], 0);
    const int off = static_cast<int>(t % tpb) * kSimpleTile;
    const int start = bid * block_size + off;
    const int rows = min(min(kSimpleTile, block_size - off), kv_len - start);
    if (bid >= n_blocks || rows <= 0) continue;     // uniform over the block
    const long long base = (static_cast<long long>(b) * S + start) * row_stride +
                           static_cast<long long>(h) * dh;
    __syncthreads();   // q_s loaded; the previous tile's p and alpha consumed

    // scores: warp w takes rows w, w + kWarps, ...
    for (int r = warp; r < rows; r += kWarps) {
      const KT* kr = k + base + r * row_stride;
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
      if (kVec) {
        constexpr int N = Chunk<KT>::N;
        for (int d0 = lane * N; d0 < dh; d0 += 32 * N) {
          float kf[N];
          Chunk<KT>::load(kr + d0, kf);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
              const float4* q4 = reinterpret_cast<const float4*>(q_s + g * dh + d0);
#pragma unroll
              for (int e4 = 0; e4 < N / 4; ++e4) {
                const float4 qv = q4[e4];
                part[g] = fmaf(qv.x, kf[4 * e4], part[g]);
                part[g] = fmaf(qv.y, kf[4 * e4 + 1], part[g]);
                part[g] = fmaf(qv.z, kf[4 * e4 + 2], part[g]);
                part[g] = fmaf(qv.w, kf[4 * e4 + 3], part[g]);
              }
            }
          }
        }
      } else {
        for (int d = lane; d < dh; d += 32) {
          const float kf = to_f32(kr[d]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) part[g] = fmaf(q_s[g * dh + d], kf, part[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float x = part[g];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
          if (lane == 0) {
            float s = x * scale;
            if (softcap > 0.f) s = softcap * tanhf(s * inv_softcap);
            s_s[g * kSimpleTile + r] = s;
          }
        }
      }
    }
    __syncthreads();

    // online softmax: warp g folds the tile into row g's running (m, l)
    if (warp < G) {
      float* sg = s_s + warp * kSimpleTile;
      float mx = -INFINITY;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, sg[r]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_prev = m_s[warp];
      const float m_new = fmaxf(m_prev, mx);
      // the reference's -inf - -inf guard: alpha and p are 0 there
      const float alpha = (m_new == -INFINITY) ? 0.f : expf(m_prev - m_new);
      float psum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float p = (m_new == -INFINITY) ? 0.f : expf(sg[r] - m_new);
        sg[r] = p;
        psum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(kFull, psum, o);
      __syncwarp();
      if (lane == 0) {
        l_s[warp] = l_s[warp] * alpha + psum;
        m_s[warp] = m_new;
        alpha_s[warp] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v, one column of dh per thread (and column)
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int d = tid + c * kThreads;
      if (d < dh) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g][c] *= alpha_s[g];
        const KT* vc = v + base + d;
        for (int r = 0; r < rows; ++r) {
          const float vf = to_f32(vc[r * row_stride]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) acc[g][c] = fmaf(s_s[g * kSimpleTile + r], vf, acc[g][c]);
        }
      }
    }
  }
  __syncthreads();

  const long long slot = static_cast<long long>(bh) * n_split + split;
  if (tid < G) {
    part_ml[(slot * G + tid) * 2] = m_s[tid];
    part_ml[(slot * G + tid) * 2 + 1] = l_s[tid];
  }
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int d = tid + c * kThreads;
    if (d < dh) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) part_acc[(slot * G + g) * dh + d] = acc[g][c];
    }
  }
}

// ---- fast path -----------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;   // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 bf16 (16 bytes) as fp32: a bf16 is the high half of its fp32.
__device__ __forceinline__ void unpack8(const uint4 raw, float* f) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Tile t of one (request, head) list: element offset of its first row and
// its row count (<= 0: nothing to read).
struct TileRef {
  long long base;
  int rows;
};
__device__ __forceinline__ TileRef tile_ref(const int* ids_b, int t,
                                            int tpb, int n_blocks,
                                            int block_size, int kv_len,
                                            long long head_off,
                                            long long row_stride) {
  const int bid = max(ids_b[t / tpb], 0);
  const int off = (t % tpb) * kTile;
  const int start = bid * block_size + off;
  const int rows = bid >= n_blocks
                       ? 0 : min(min(kTile, block_size - off), kv_len - start);
  return {head_off + static_cast<long long>(start) * row_stride, rows};
}

// Sum each of the V values x[] over the W lanes of an aligned lane group
// and give every lane of the group all V sums (V <= W, both powers of 2).
// The first log2(V) butterfly steps halve the values a lane carries (each
// lane keeps one half and sends the other), so the group pays
// log2(W) + V shuffles instead of V * log2(W).
template <int V, int W>
__device__ __forceinline__ void group_sum_all(float (&x)[V], int lane) {
  static_assert(V <= W && (V & (V - 1)) == 0 && (W & (W - 1)) == 0, "");
  int cnt = V;
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) {
    if (cnt > 1) {
      const bool up = lane & o;
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        if (i < cnt / 2) {
          const float keep = up ? x[i + cnt / 2] : x[i];
          const float send = up ? x[i] : x[i + cnt / 2];
          x[i] = keep + __shfl_xor_sync(kFull, send, o);
        }
      }
      cnt /= 2;
    } else {
      x[0] += __shfl_xor_sync(kFull, x[0], o);
    }
  }
  // value j now sits in the lanes whose halving-step bits spell j
  const float mine = x[0];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    int src = 0, o = W / 2;
#pragma unroll
    for (int bit = V / 2; bit > 0; bit >>= 1, o >>= 1)
      if (j & bit) src |= o;
    x[j] = __shfl_sync(kFull, mine, src, W);
  }
}

template <int CPR, int GM>   // CPR: 16-byte chunks a row (dh / 8)
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
sketch_decode_attn_pipe(
    const void* __restrict__ q, int q_bf16, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ block_ids,
    const int* __restrict__ n_live, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int Hkv, int G, int S, int nb_max,
    int kv_len, int block_size, int n_split, float scale, float softcap,
    float inv_softcap) {
  constexpr int dh = CPR * 8;
  constexpr int LPG = CPR < 32 ? CPR : 32;   // lanes a row owner
  constexpr int NCH = CPR / LPG;             // 16-byte chunks a lane
  constexpr int GPW = 32 / LPG;              // owners a warp
  constexpr int OWNERS = kWarps * GPW;
  constexpr int RPO = kTile / OWNERS;        // rows an owner a tile
  static_assert(RPO >= 1 && RPO * OWNERS == kTile, "tile/owner mismatch");
  constexpr int KV_ELEMS = kTile * dh;       // bf16 elements of K (or V)
  constexpr int COPIES = 2 * kTile * CPR;    // 16-byte copies a tile
  constexpr int kStages = stages_for(CPR);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ float ml_s[kWarps][kMaxG][2];
  __shared__ int rows_s[kMaxStages];   // row count of the tile in each stage

  const int bh = blockIdx.x;
  const int b = bh / Hkv, h = bh % Hkv;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane % LPG;
  const int owner = warp * GPW + lane / LPG;

  // this lane's columns of q, and its running softmax state, in registers
  float qr[GM][NCH][8], acc[GM][NCH][8], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const long long at = (static_cast<long long>(bh) * G + g) * dh +
                           (sub + j * LPG) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        acc[g][j][e] = 0.f;
        qr[g][j][e] = 0.f;
      }
      if (g < G) {
        if (q_bf16) {
          unpack8(*reinterpret_cast<const uint4*>(
                      static_cast<const __nv_bfloat16*>(q) + at), qr[g][j]);
        } else {
          const float4* q4 = reinterpret_cast<const float4*>(
              static_cast<const float*>(q) + at);
          const float4 x = q4[0], y = q4[1];
          qr[g][j][0] = x.x; qr[g][j][1] = x.y; qr[g][j][2] = x.z;
          qr[g][j][3] = x.w; qr[g][j][4] = y.x; qr[g][j][5] = y.y;
          qr[g][j][6] = y.z; qr[g][j][7] = y.w;
        }
      }
    }
  }

  const int nl = repro_torch::clampi(n_live[b], 0, nb_max);
  const int n_blocks = S / block_size;
  const int tpb = (block_size + kTile - 1) / kTile;   // tiles per block
  const int total = nl * tpb;
  const int t_begin = static_cast<int>(static_cast<long long>(total) * split / n_split);
  const int t_end = static_cast<int>(static_cast<long long>(total) * (split + 1) / n_split);
  const long long row_stride = static_cast<long long>(Hkv) * dh;
  const long long head_off =
      static_cast<long long>(b) * S * row_stride + static_cast<long long>(h) * dh;
  const int* ids_b = block_ids + static_cast<long long>(b) * nb_max;

  // Start the copies of tile t into ring stage `stage` (one commit group,
  // empty past the share's end) and note its row count there.
  auto issue = [&](int t, int stage) {
    int rows = 0;
    if (t < t_end) {
      const TileRef tr = tile_ref(ids_b, t, tpb, n_blocks, block_size, kv_len,
                                  head_off, row_stride);
      rows = tr.rows;
      if (tr.rows > 0) {
        __nv_bfloat16* dst = ring + stage * 2 * KV_ELEMS;
        for (int i = tid; i < COPIES; i += kThreads) {
          const int kv = i / (kTile * CPR);
          const int rem = i - kv * (kTile * CPR);
          const int r = rem / CPR, c = rem % CPR;
          const bool ok = r < tr.rows;
          const __nv_bfloat16* src =
              (kv ? v : k) + tr.base + (ok ? r : 0) * row_stride + c * 8;
          cp_async16(dst + kv * KV_ELEMS + r * dh + c * 8, src, ok);
        }
      }
    }
    if (tid == 0) rows_s[stage] = rows;
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(t_begin + s, s);

  int stage = 0;
  for (int t = t_begin; t < t_end; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile t visible to all; every warp done with t - 1
    issue(t + kStages - 1, stage == 0 ? kStages - 1 : stage - 1);
    const int rows = rows_s[stage];
    const __nv_bfloat16* ks = ring + stage * 2 * KV_ELEMS;
    const __nv_bfloat16* vs = ks + KV_ELEMS;
    stage = stage == kStages - 1 ? 0 : stage + 1;
    if (rows <= 0) continue;                        // uniform over the block

    // the owner's rows' scores: lane partial sums, then one group reduction
    float part[RPO * GM];
#pragma unroll
    for (int i = 0; i < RPO; ++i) {
      const int r = owner + i * OWNERS;
#pragma unroll
      for (int g = 0; g < GM; ++g) part[i * GM + g] = 0.f;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        float kf[8];
        unpack8(*reinterpret_cast<const uint4*>(ks + r * dh + (sub + j * LPG) * 8),
                kf);
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            part[i * GM + g] = fmaf(qr[g][j][e], kf[e], part[i * GM + g]);
      }
    }
    group_sum_all<RPO * GM, LPG>(part, lane);
    float sc[RPO][GM];
#pragma unroll
    for (int i = 0; i < RPO; ++i) {
      const int r = owner + i * OWNERS;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float x = part[i * GM + g] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x * inv_softcap);
        sc[i][g] = r < rows ? x : -INFINITY;
      }
    }

#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        float mx = sc[0][g];
#pragma unroll
        for (int i = 1; i < RPO; ++i) mx = fmaxf(mx, sc[i][g]);
        const float m_new = fmaxf(m[g], mx);
        // the reference's -inf - -inf guard: alpha and p are 0 there
        const bool none = m_new == -INFINITY;
        const float alpha = none ? 0.f : expf(m[g] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int i = 0; i < RPO; ++i) {
          sc[i][g] = none ? 0.f : expf(sc[i][g] - m_new);
          psum += sc[i][g];
        }
        l[g] = l[g] * alpha + psum;
        m[g] = m_new;
#pragma unroll
        for (int j = 0; j < NCH; ++j)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][j][e] *= alpha;
      }
    }

#pragma unroll
    for (int i = 0; i < RPO; ++i) {
      const int r = owner + i * OWNERS;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        float vf[8];
        unpack8(*reinterpret_cast<const uint4*>(vs + r * dh + (sub + j * LPG) * 8),
                vf);
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < G)
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][j][e] = fmaf(sc[i][g], vf[e], acc[g][j][e]);
      }
    }
  }
  cp_async_wait<0>();

  // merge the owners of each warp (a butterfly over the lane groups) ...
#pragma unroll
  for (int o = LPG; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        const float mo = __shfl_xor_sync(kFull, m[g], o);
        const float lo = __shfl_xor_sync(kFull, l[g], o);
        const float mn = fmaxf(m[g], mo);
        const bool none = mn == -INFINITY;
        const float wa = none ? 0.f : expf(m[g] - mn);
        const float wb = none ? 0.f : expf(mo - mn);
        l[g] = l[g] * wa + lo * wb;
        m[g] = mn;
#pragma unroll
        for (int j = 0; j < NCH; ++j)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[g][j][e] = acc[g][j][e] * wa +
                           __shfl_xor_sync(kFull, acc[g][j][e], o) * wb;
      }
    }
  }
  // ... then the warps, in warp order, through the (now idle) ring
  __syncthreads();
  float* acc_s = reinterpret_cast<float*>(smem_raw);   // (kWarps, G, dh)
  if (lane < LPG) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
#pragma unroll
        for (int j = 0; j < NCH; ++j)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc_s[(warp * G + g) * dh + (sub + j * LPG) * 8 + e] = acc[g][j][e];
        if (lane == 0) {
          ml_s[warp][g][0] = m[g];
          ml_s[warp][g][1] = l[g];
        }
      }
    }
  }
  __syncthreads();
  const long long slot = static_cast<long long>(bh) * n_split + split;
  for (int i = tid; i < G * dh; i += kThreads) {
    const int g = i / dh;
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, ml_s[w][g][0]);
    float a = 0.f, l_all = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = ml_s[w][g][0];
      const float wt = mw == -INFINITY ? 0.f : expf(mw - m_all);
      a = fmaf(acc_s[(w * G + g) * dh + (i - g * dh)], wt, a);
      l_all = fmaf(ml_s[w][g][1], wt, l_all);
    }
    part_acc[slot * G * dh + i] = a;
    if (i - g * dh == 0) {
      part_ml[(slot * G + g) * 2] = m_all;
      part_ml[(slot * G + g) * 2 + 1] = l_all;
    }
  }
}

template <int CPR, int GM>
cudaError_t launch_pipe(const void* q, int q_bf16, const void* k,
                        const void* v, const int* block_ids, const int* n_live,
                        float* part_ml, float* part_acc, int B, int Hkv, int G,
                        int S, int nb_max, int kv_len, int block_size,
                        int n_split, float scale, float softcap,
                        float inv_softcap, cudaStream_t s) {
  constexpr int smem = stages_for(CPR) * 2 * kTile * CPR * 16;
  // once a card and instantiation: a function's attributes are per device
  static bool configured[repro_torch::kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= repro_torch::kMaxDevices)
    return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        sketch_decode_attn_pipe<CPR, GM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(sketch_decode_attn_pipe<CPR, GM>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  sketch_decode_attn_pipe<CPR, GM><<<dim3(B * Hkv, n_split), kThreads, smem, s>>>(
      q, q_bf16, static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), block_ids, n_live, part_ml,
      part_acc, Hkv, G, S, nb_max, kv_len, block_size, n_split, scale,
      softcap, inv_softcap);
  return cudaGetLastError();
}

template <int CPR>
cudaError_t launch_pipe_g(const void* q, int q_bf16, const void* k,
                          const void* v, const int* block_ids,
                          const int* n_live, float* part_ml, float* part_acc,
                          int B, int Hkv, int G, int S, int nb_max, int kv_len,
                          int block_size, int n_split, float scale,
                          float softcap, float inv_softcap, cudaStream_t s) {
  if (G <= 2)
    return launch_pipe<CPR, 2>(q, q_bf16, k, v, block_ids, n_live, part_ml,
                               part_acc, B, Hkv, G, S, nb_max, kv_len,
                               block_size, n_split, scale, softcap,
                               inv_softcap, s);
  return launch_pipe<CPR, kMaxG>(q, q_bf16, k, v, block_ids, n_live, part_ml,
                                 part_acc, B, Hkv, G, S, nb_max, kv_len,
                                 block_size, n_split, scale, softcap,
                                 inv_softcap, s);
}

// Combine the n_split partials of each (request, KV head) in split order.
// Grid (B * Hkv, ceil(G * dh / kThreads)): one output element a thread;
// every block first stages the splits' (m, l) in shared memory.  With lse
// (the partial entry of a rank that holds one block of a sequence split
// over a mesh), the first block of each (request, KV head) also writes
// each query row's log-sum-exp, m + log(l), or -inf where nothing is live.
__global__ void __launch_bounds__(kThreads) sketch_decode_attn_combine(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    float* __restrict__ out, float* __restrict__ lse, int G, int dh,
    int n_split) {
  extern __shared__ float ml_sh[];   // (n_split, G) m, then weights; then l
  float* w_s = ml_sh;
  float* l_s = ml_sh + n_split * G;
  __shared__ float m_all_s[kMaxG], total_s[kMaxG];
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = n_split * G;
  const float* ml = part_ml + static_cast<long long>(bh) * n * 2;
  for (int i = tid; i < n; i += kThreads) {
    w_s[i] = ml[2 * i];
    l_s[i] = ml[2 * i + 1];
  }
  __syncthreads();
  if (tid < G) {
    float m_all = -INFINITY;
    for (int s = 0; s < n_split; ++s) m_all = fmaxf(m_all, w_s[s * G + tid]);
    m_all_s[tid] = m_all;
  }
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) {
    const float m = w_s[i];
    w_s[i] = (m == -INFINITY) ? 0.f : expf(m - m_all_s[i % G]);
  }
  __syncthreads();
  if (tid < G) {
    float l_all = 0.f;
    for (int s = 0; s < n_split; ++s)
      l_all = fmaf(l_s[s * G + tid], w_s[s * G + tid], l_all);
    total_s[tid] = l_all;
    if (lse != nullptr && blockIdx.y == 0)
      lse[bh * G + tid] = l_all > 0.f ? m_all_s[tid] + logf(l_all) : -INFINITY;
  }
  __syncthreads();
  const int i = blockIdx.y * kThreads + tid;
  if (i >= G * dh) return;
  const int g = i / dh;
  const float* pa = part_acc + static_cast<long long>(bh) * n * dh + i;
  float a = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s)
    a = fmaf(w_s[s * G + g], pa[static_cast<long long>(s) * G * dh], a);
  const float l = total_s[g];
  out[static_cast<long long>(bh) * G * dh + i] = l > 0.f ? a / fmaxf(l, 1e-30f) : 0.f;
}

template <typename QT, typename KT>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* block_ids, const int* n_live,
                         float* part_ml, float* part_acc, int B, int Hkv,
                         int G, int dh, int S, int nb_max, int kv_len,
                         int block_size, int n_split, float scale,
                         float softcap, float inv_softcap, cudaStream_t s) {
  const dim3 grid(B * Hkv, n_split);
  const size_t smem = static_cast<size_t>(G) * (dh + kSimpleTile) * sizeof(float);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const bool vec = (dh % (32 * Chunk<KT>::N) == 0) && (addr % 16 == 0);
  const QT* qt = static_cast<const QT*>(q);
  const KT* kt = static_cast<const KT*>(k);
  const KT* vt = static_cast<const KT*>(v);
  if (vec)
    sketch_decode_attn_split<QT, KT, true><<<grid, kThreads, smem, s>>>(
        qt, kt, vt, block_ids, n_live, part_ml, part_acc, Hkv, G, dh, S,
        nb_max, kv_len, block_size, n_split, scale, softcap, inv_softcap);
  else
    sketch_decode_attn_split<QT, KT, false><<<grid, kThreads, smem, s>>>(
        qt, kt, vt, block_ids, n_live, part_ml, part_acc, Hkv, G, dh, S,
        nb_max, kv_len, block_size, n_split, scale, softcap, inv_softcap);
  return cudaGetLastError();
}

// Both launches of one call; returns the first launch error (0 if none).
// lse: null, or (B, Hkv, G) fp32 that the combine fills.
int launch_both(
    const void* q, const void* k, const void* v, const int* block_ids,
    const int* n_live, float* part_ml, float* part_acc, float* out,
    float* lse, int B, int Hkv, int G, int dh, int S, int nb_max, int kv_len,
    int block_size, int n_split, int q_bf16, int kv_bf16, float scale,
    float softcap, float inv_softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  const bool pipe = kv_bf16 && aligned && G <= kMaxG;
  if (pipe && dh == 64)
    err = launch_pipe_g<8>(q, q_bf16, k, v, block_ids, n_live, part_ml,
                           part_acc, B, Hkv, G, S, nb_max, kv_len, block_size,
                           n_split, scale, softcap, inv_softcap, s);
  else if (pipe && dh == 128)
    err = launch_pipe_g<16>(q, q_bf16, k, v, block_ids, n_live, part_ml,
                            part_acc, B, Hkv, G, S, nb_max, kv_len, block_size,
                            n_split, scale, softcap, inv_softcap, s);
  else if (pipe && dh == 256)
    err = launch_pipe_g<32>(q, q_bf16, k, v, block_ids, n_live, part_ml,
                            part_acc, B, Hkv, G, S, nb_max, kv_len, block_size,
                            n_split, scale, softcap, inv_softcap, s);
  else if (pipe && dh == 512)
    err = launch_pipe_g<64>(q, q_bf16, k, v, block_ids, n_live, part_ml,
                            part_acc, B, Hkv, G, S, nb_max, kv_len, block_size,
                            n_split, scale, softcap, inv_softcap, s);
  else if (q_bf16 && kv_bf16)
    err = launch_typed<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, block_ids, n_live, part_ml, part_acc, B, Hkv, G, dh, S,
        nb_max, kv_len, block_size, n_split, scale, softcap, inv_softcap, s);
  else if (q_bf16)
    err = launch_typed<__nv_bfloat16, float>(
        q, k, v, block_ids, n_live, part_ml, part_acc, B, Hkv, G, dh, S,
        nb_max, kv_len, block_size, n_split, scale, softcap, inv_softcap, s);
  else if (kv_bf16)
    err = launch_typed<float, __nv_bfloat16>(
        q, k, v, block_ids, n_live, part_ml, part_acc, B, Hkv, G, dh, S,
        nb_max, kv_len, block_size, n_split, scale, softcap, inv_softcap, s);
  else
    err = launch_typed<float, float>(
        q, k, v, block_ids, n_live, part_ml, part_acc, B, Hkv, G, dh, S,
        nb_max, kv_len, block_size, n_split, scale, softcap, inv_softcap, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 2 * static_cast<size_t>(n_split) * G * sizeof(float);
  const dim3 grid(B * Hkv, (G * dh + kThreads - 1) / kThreads);
  sketch_decode_attn_combine<<<grid, kThreads, smem, s>>>(
      part_ml, part_acc, out, lse, G, dh, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The whole-cache entry: out only.
extern "C" int sketch_decode_attn_launch(
    const void* q, const void* k, const void* v, const int* block_ids,
    const int* n_live, float* part_ml, float* part_acc, float* out, int B,
    int Hkv, int G, int dh, int S, int nb_max, int kv_len, int block_size,
    int n_split, int q_bf16, int kv_bf16, float scale, float softcap,
    float inv_softcap, void* stream) {
  return launch_both(q, k, v, block_ids, n_live, part_ml, part_acc, out,
                     nullptr, B, Hkv, G, dh, S, nb_max, kv_len, block_size,
                     n_split, q_bf16, kv_bf16, scale, softcap, inv_softcap,
                     stream);
}

// The partial entry of a rank's block of a sequence: out and its lse.
extern "C" int sketch_decode_attn_lse_launch(
    const void* q, const void* k, const void* v, const int* block_ids,
    const int* n_live, float* part_ml, float* part_acc, float* out,
    float* lse, int B, int Hkv, int G, int dh, int S, int nb_max, int kv_len,
    int block_size, int n_split, int q_bf16, int kv_bf16, float scale,
    float softcap, float inv_softcap, void* stream) {
  return launch_both(q, k, v, block_ids, n_live, part_ml, part_acc, out, lse,
                     B, Hkv, G, dh, S, nb_max, kv_len, block_size, n_split,
                     q_bf16, kv_bf16, scale, softcap, inv_softcap, stream);
}
