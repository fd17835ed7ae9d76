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
// contiguous share of its request's live list in tiles of kTile rows (a
// tile never crosses a sketch block; rows at or past kv_len are never
// read), keeping the G query rows in shared memory and the running
// (m, l, acc) in fp32, and writes its partial (m, l, acc) to scratch that
// the wrapper allocates.  Per tile: each warp scores rows (a lane reads 16
// bytes of the K row, a butterfly of shuffles adds the lanes), warp g
// updates row g's running max and sum and turns the scores into p, then
// each thread accumulates p . v for its columns of dh.  A second small
// launch combines the splits in split order, so the result does not depend
// on scheduling; there are no atomics.  The kernel reads n_live and
// block_ids on the device, so the host never waits.  Sums run in another
// order than the plain version's: the two agree to fp32 rounding.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;       // K/V rows per tile
constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;        // query rows per KV head
constexpr int kMaxCols = 2;     // dh <= kThreads * kMaxCols
constexpr unsigned kFull = 0xffffffffu;

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
  float* s_s = smem + G * dh;      // (G, kTile) scores, then p
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
  const int tpb = (block_size + kTile - 1) / kTile;   // tiles per block
  const long long total = static_cast<long long>(nl) * tpb;
  const long long t_begin = total * split / n_split;
  const long long t_end = total * (split + 1) / n_split;
  const long long row_stride = static_cast<long long>(Hkv) * dh;

  for (long long t = t_begin; t < t_end; ++t) {
    const int bid = max(block_ids[static_cast<long long>(b) * nb_max + t / tpb], 0);
    const int off = static_cast<int>(t % tpb) * kTile;
    const int start = bid * block_size + off;
    const int rows = min(min(kTile, block_size - off), kv_len - start);
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
            s_s[g * kTile + r] = s;
          }
        }
      }
    }
    __syncthreads();

    // online softmax: warp g folds the tile into row g's running (m, l)
    if (warp < G) {
      float* sg = s_s + warp * kTile;
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
            if (g < G) acc[g][c] = fmaf(s_s[g * kTile + r], vf, acc[g][c]);
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

// Combine the n_split partials of each (request, KV head) in split order.
__global__ void __launch_bounds__(kThreads) sketch_decode_attn_combine(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    float* __restrict__ out, int G, int dh, int n_split) {
  extern __shared__ float w_s[];   // (n_split, G) weights
  __shared__ float total_s[kMaxG];
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const float* ml = part_ml + static_cast<long long>(bh) * n_split * G * 2;
  if (tid < G) {
    float m_all = -INFINITY;
    for (int s = 0; s < n_split; ++s) m_all = fmaxf(m_all, ml[(s * G + tid) * 2]);
    float l_all = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float m = ml[(s * G + tid) * 2];
      const float w = (m == -INFINITY) ? 0.f : expf(m - m_all);
      w_s[s * G + tid] = w;
      l_all = fmaf(ml[(s * G + tid) * 2 + 1], w, l_all);
    }
    total_s[tid] = l_all;
  }
  __syncthreads();
  const float* pa = part_acc + static_cast<long long>(bh) * n_split * G * dh;
  for (int i = tid; i < G * dh; i += kThreads) {
    const int g = i / dh;
    float a = 0.f;
    for (int s = 0; s < n_split; ++s)
      a = fmaf(w_s[s * G + g], pa[static_cast<long long>(s) * G * dh + i], a);
    const float l = total_s[g];
    out[static_cast<long long>(bh) * G * dh + i] = l > 0.f ? a / fmaxf(l, 1e-30f) : 0.f;
  }
}

template <typename QT, typename KT>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* block_ids, const int* n_live,
                         float* part_ml, float* part_acc, int B, int Hkv,
                         int G, int dh, int S, int nb_max, int kv_len,
                         int block_size, int n_split, float scale,
                         float softcap, float inv_softcap, cudaStream_t s) {
  const dim3 grid(B * Hkv, n_split);
  const size_t smem = static_cast<size_t>(G) * (dh + kTile) * sizeof(float);
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

}  // namespace

// Both launches of one call; returns the first launch error (0 if none).
extern "C" int sketch_decode_attn_launch(
    const void* q, const void* k, const void* v, const int* block_ids,
    const int* n_live, float* part_ml, float* part_acc, float* out, int B,
    int Hkv, int G, int dh, int S, int nb_max, int kv_len, int block_size,
    int n_split, int q_bf16, int kv_bf16, float scale, float softcap,
    float inv_softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_bf16 && kv_bf16)
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
  const size_t smem = static_cast<size_t>(n_split) * G * sizeof(float);
  sketch_decode_attn_combine<<<B * Hkv, kThreads, smem, s>>>(
      part_ml, part_acc, out, G, dh, n_split);
  return static_cast<int>(cudaGetLastError());
}
