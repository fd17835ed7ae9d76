// srp_hash — signed-random-projection LSH codes in one launch:
// x (B, d) f32, proj (d, L*k) f32, mix (L, k) uint32 (held as int64)
//   -> codes (B, L) int32 = ((sum_j [x.proj_(l,j) >= 0] * mix[l, j]) * 2654435761)
//                           mod n_buckets, all in wrapping uint32 arithmetic.
//
// Replaces: the Pallas kernel `srp_hash` in src/repro/kernels/srp_hash.py
// (one MXU matmul per batch tile with proj pinned whole in VMEM, then the
// sign bits and the multiply-shift fold on the vector unit).
//
// Bound on the H100: fp32 operations.  2*B*d*L*k flops (0.60 GFLOP at
// B = 4096, d = 384, L*k = 192: ~9 us at 67 TFLOP/s without tensor cores)
// against B*d*4 + d*L*k*4 bytes read (6.6 MB: ~2 us at 3.35 TB/s).  The
// sign test is exact only in full fp32, so TF32 tensor cores are not used.
//
// Design: a tiled fp32 GEMM whose epilogue is the hash.  proj does not fit
// in one block's shared memory (295 KB at d = 384, L*k = 192), so each block
// owns a 64-row tile of x and a 64-column tile of proj made of whole hash
// rows (64 / k of them), and walks d in slices of 32: both slices are staged
// in shared memory with coalesced loads, and each of 256 threads accumulates
// a 4 x 4 micro-tile (rows ty + 16 i, columns tx + 16 j, so a warp reads
// 16 consecutive proj columns and broadcasts x) with fmaf.  After the last
// slice the sign bits go to shared memory, and one thread per (row, hash
// row) folds its k bits with the uint32 mix and the golden-ratio multiply,
// which wrap mod 2^32 like the reference's uint32 arrays, then takes the
// remainder by n_buckets.  The fp32 sums run in another order than the
// plain version's matmul, so a code can differ only where some |y| is
// within rounding of 0.
#include "common.cuh"

namespace {

constexpr int kTileB = 64;     // rows of x per block
constexpr int kTileN = 64;     // projection columns per block (whole hash rows)
constexpr int kTileD = 32;     // depth of one staged slice
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr unsigned kMix = 2654435761u;

__global__ void srp_hash_kernel(const float* __restrict__ x,
                                const float* __restrict__ proj,
                                const long long* __restrict__ mix,
                                int* __restrict__ out, int B, int d, int L,
                                int k, unsigned n_buckets, int rows_per_block) {
  __shared__ float xs[kTileB][kTileD + 1];
  __shared__ float ps[kTileD][kTileN];
  __shared__ unsigned char bits[kTileB][kTileN];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b0 = blockIdx.x * kTileB;
  const int l0 = blockIdx.y * rows_per_block;
  const int nrows = min(rows_per_block, L - l0);
  const int ncols = nrows * k;
  const long long LK = static_cast<long long>(L) * k;
  const long long col0 = static_cast<long long>(l0) * k;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < d; d0 += kTileD) {
    for (int i = tid; i < kTileB * kTileD; i += kThreads) {
      const int r = i / kTileD;
      const int c = i - r * kTileD;
      const int b = b0 + r;
      const int j = d0 + c;
      xs[r][c] = (b < B && j < d) ? x[static_cast<long long>(b) * d + j] : 0.f;
    }
    for (int i = tid; i < kTileD * kTileN; i += kThreads) {
      const int r = i / kTileN;
      const int c = i - r * kTileN;
      const int j = d0 + r;
      ps[r][c] = (j < d && c < ncols) ? proj[static_cast<long long>(j) * LK + col0 + c]
                                      : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTileD; ++kk) {
      float a[4], p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] = ps[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], p[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bits[ty + 16 * i][tx + 16 * j] = acc[i][j] >= 0.f ? 1 : 0;
  __syncthreads();

  for (int i = tid; i < kTileB * nrows; i += kThreads) {
    const int r = i / nrows;
    const int hl = i - r * nrows;
    const int b = b0 + r;
    if (b >= B) continue;
    const int l = l0 + hl;
    unsigned a = 0u;
    for (int j = 0; j < k; ++j)
      if (bits[r][hl * k + j]) a += static_cast<unsigned>(mix[static_cast<long long>(l) * k + j]);
    a *= kMix;
    out[static_cast<long long>(b) * L + l] = static_cast<int>(a % n_buckets);
  }
}

}  // namespace

extern "C" int srp_hash_launch(const float* x, const float* proj,
                               const long long* mix, int* out, int B, int d,
                               int L, int k, int n_buckets, void* stream) {
  if (k < 1 || k > kTileN || n_buckets < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_per_block = kTileN / k;
  dim3 grid((B + kTileB - 1) / kTileB, (L + rows_per_block - 1) / rows_per_block);
  srp_hash_kernel<<<grid, kThreads, 0, s>>>(x, proj, mix, out, B, d, L, k,
                                            static_cast<unsigned>(n_buckets),
                                            rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
