// race_hist — per-row histogram of LSH codes, out[l, w] = #{b : codes[b, l] = w}.
//
// Replaces: the Pallas kernel `race_hist` in src/repro/kernels/race_update.py,
// a one-hot compare-reduce over a (1, W) output block that the TPU's
// sequential grid revisits across batch chunks.  That form only pays on the
// TPU's vector unit, and Hopper's blocks run in no order, so nothing can be
// carried between them.
//
// Bound on the H100: bytes.  It reads B*L int32 codes once and writes L*W
// int32 counts; there is about one integer add per 4 bytes read.  At the
// main path's (4096, 96) codes and W = 96 that is 1.6 MB, 0.5 us at the
// memory rate, so one launch and its latency set the time.
//
// Design: one launch, every bin of `out` written exactly once by a plain
// store (zeros included, so the wrapper allocates with torch.empty), no
// global atomics.  Codes outside [0, W) are ignored.  One block of 16 warps
// per row (and tile of bins) reads that row's whole column of codes, so no
// histogram is ever split across blocks.  Each thread has 8 loads in
// flight before it adds any (a block waits on memory once per 4096 codes).
// Lanes holding the same code combine first: __match_any_sync, then one
// shared atomicAdd of the popcount by the lowest lane.  Clustered data (a few hit cells a
// row, as on the main path) is where that matters: a warp-load of 32 codes
// becomes a handful of atomics.  With 16 * W bins in 48 KB (W <= 768) each
// warp adds into its own sub-histogram, so warps never contend for a bin,
// and the block sums the 16 at the end; wider rows share one block
// histogram per tile of 12 288 bins.  A cluster of 8 blocks per 8 rows,
// splitting the batch and summing through distributed shared memory, was
// 2x slower at the main shape on the card.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;        // codes a thread loads before adding
constexpr int kSmemInts = 48 * 1024 / 4;
constexpr unsigned kFull = 0xffffffffu;

// Adds one to hist[key] for every lane of the warp holding key >= 0: lanes
// with equal keys combine, and their lowest lane adds the count.
__device__ __forceinline__ void warp_add(int* hist, int key) {
  const unsigned peers = __match_any_sync(kFull, key);
  if (key >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[key], __popc(peers));
}

// Block (row l, tile y) histograms codes[:, l] over bins [y*TW, y*TW + TW).
template <bool kPerWarp>
__global__ void __launch_bounds__(kThreads)
race_hist_kernel(const int* __restrict__ codes, int* __restrict__ out, int B,
                 int L, int W, int TW) {
  extern __shared__ int hist[];  // kPerWarp: kWarps x TW, else TW
  const int l = blockIdx.x;
  const int w0 = blockIdx.y * TW;
  const int nw = min(TW, W - w0);
  for (int i = threadIdx.x; i < (kPerWarp ? kWarps : 1) * TW; i += kThreads)
    hist[i] = 0;
  __syncthreads();
  int* mine = kPerWarp ? hist + (threadIdx.x >> 5) * TW : hist;
  for (int i0 = 0; i0 < B; i0 += kThreads * kPerThread) {  // block-uniform
    int key[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {  // all loads in flight at once
      const int i = i0 + j * kThreads + threadIdx.x;
      key[j] = -1;
      if (i < B) {
        const int c = codes[static_cast<long long>(i) * L + l];
        if (c >= w0 && c < w0 + nw) key[j] = c - w0;
      }
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) warp_add(mine, key[j]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nw; i += kThreads) {
    int s = hist[i];
    if (kPerWarp)
      for (int w = 1; w < kWarps; ++w) s += hist[w * TW + i];
    out[static_cast<long long>(l) * W + w0 + i] = s;
  }
}

}  // namespace

extern "C" int race_hist_launch(const int* codes, int* out, int B, int L,
                                int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 0 || L < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(kWarps) * W <= kSmemInts) {
    race_hist_kernel<true><<<dim3(L, 1), kThreads, kWarps * W * sizeof(int), s>>>(
        codes, out, B, L, W, W);
  } else {
    const int TW = W < kSmemInts ? W : kSmemInts;
    race_hist_kernel<false><<<dim3(L, (W + TW - 1) / TW), kThreads,
                              TW * sizeof(int), s>>>(codes, out, B, L, W, TW);
  }
  return static_cast<int>(cudaGetLastError());
}
