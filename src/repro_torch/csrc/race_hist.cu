// race_hist — per-row histogram of LSH codes, out[l, w] = #{b : codes[b, l] = w}.
//
// Replaces: the Pallas kernel `race_hist` in src/repro/kernels/race_update.py,
// a one-hot compare-reduce over a (1, W) output block that the TPU's
// sequential grid revisits across batch chunks.  That form only pays on the
// TPU's vector unit, and Hopper's blocks run in no order, so nothing can be
// carried between them.
//
// Bound on the H100: bytes.  It reads B*L int32 codes once and writes L*W
// int32 counts; there is about one integer add per 4 bytes read.
//
// Design: one block per (row tile, batch tile).  The block builds a
// shared-memory int32 histogram of its tile with atomicAdd, then adds each
// nonzero bin into the output with one global atomicAdd.  Integer addition
// commutes, so the result is exact in any order.  Threads walk the tile
// row-major, so a warp reads whole runs of the tile's columns.  The wrapper
// zero-fills `out`.  When W is too wide for a shared histogram (more than
// 48 KB for one row) the kernel adds straight into global memory.  Codes
// outside [0, W) are ignored.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBatchTile = 512;
constexpr int kMaxRowTile = 8;
constexpr int kSmemInts = 48 * 1024 / 4;

__global__ void race_hist_smem(const int* __restrict__ codes,
                               int* __restrict__ out, int B, int L, int W,
                               int row_tile) {
  extern __shared__ int hist[];  // rows * W
  const int l0 = blockIdx.x * row_tile;
  const int rows = min(row_tile, L - l0);
  const int b0 = blockIdx.y * kBatchTile;
  const int nb = min(kBatchTile, B - b0);
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const int n = nb * rows;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int b = b0 + i / rows;
    const int lr = i - (i / rows) * rows;
    const int c = codes[static_cast<long long>(b) * L + l0 + lr];
    if (c >= 0 && c < W) atomicAdd(&hist[lr * W + c], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
    const int v = hist[i];
    if (v) atomicAdd(&out[static_cast<long long>(l0) * W + i], v);
  }
}

__global__ void race_hist_global(const int* __restrict__ codes,
                                 int* __restrict__ out, int B, int L, int W) {
  const long long n = static_cast<long long>(B) * L;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int l = static_cast<int>(i % L);
    const int c = codes[i];
    if (c >= 0 && c < W) atomicAdd(&out[static_cast<long long>(l) * W + c], 1);
  }
}

}  // namespace

extern "C" int race_hist_launch(const int* codes, int* out, int B, int L,
                                int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W <= kSmemInts) {
    const int row_tile = std::min(L, std::min(kMaxRowTile, kSmemInts / W));
    dim3 grid((L + row_tile - 1) / row_tile, (B + kBatchTile - 1) / kBatchTile);
    race_hist_smem<<<grid, kThreads, row_tile * W * sizeof(int), s>>>(
        codes, out, B, L, W, row_tile);
  } else {
    const long long n = static_cast<long long>(B) * L;
    const int blocks = static_cast<int>(std::min((n + kThreads - 1) / kThreads, 8192LL));
    race_hist_global<<<blocks, kThreads, 0, s>>>(codes, out, B, L, W);
  }
  return static_cast<int>(cudaGetLastError());
}
