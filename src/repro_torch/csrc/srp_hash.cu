// srp_hash — signed-random-projection LSH codes in one launch:
// x (B, d) f32, proj (d, L*k) f32, mix (L, k) uint32 (held as int64)
//   -> codes (B, L) int32 = ((sum_j [x.proj_(l,j) >= 0] * mix[l, j]) * 2654435761)
//                           mod n_buckets, all in wrapping uint32 arithmetic.
//
// Replaces: the Pallas kernel `srp_hash` in src/repro/kernels/srp_hash.py
// (one MXU matmul per batch tile with proj pinned whole in VMEM, then the
// sign bits and the multiply-shift fold on the vector unit).
//
// Bound on the H100: operations.  2*B*d*L*k flops (0.60 GFLOP at B = 4096,
// d = 384, L*k = 192): ~9 us at 67 TFLOP/s on the fp32 CUDA cores; on the
// TF32 tensor cores the 3xTF32 product below is 3 x 0.60 GFLOP, ~3.6 us at
// 495 TFLOP/s.  B*d*4 + d*L*k*4 bytes read (6.6 MB) take ~2 us at 3.35 TB/s.
//
// Precision: 3xTF32.  Each fp32 operand v is split into two TF32 values,
// big = v rounded to nearest and small = the exact remainder v - big
// truncated, so v = big + small + e with |e| <= 2^-21 |v|.  The product is
// big*big + big*small + small*big, each on the tensor cores with fp32
// accumulation: the dropped small*small term (<= 2^-22 |x_i p_i|) and the
// split residues (<= 2 * 2^-21 |x_i p_i|) sum to at most ~1.2e-6 *
// sum_i |x_i p_i| <= 1.2e-6 * |x| * |proj column| (Cauchy-Schwarz), and the
// fp32 accumulation error is of the order of any fp32 GEMM's.  A sign (and
// so a code) can then differ from the plain fp32 matmul's only where |y| is
// within ~1e-6 of |x| * |proj column|, inside the 1e-5 flip rule
// (`ref.srp_code_flips`).  Plain TF32 (one product) would not do: its
// ~2^-11 error moves signs.
//
// Design: a tensor-core GEMM whose epilogue is the hash.  A block owns a
// 64-row tile of x and a 96-column tile of proj made of whole hash rows
// (96 / k of them), so the (4096 x 192) output of the main path is 128
// blocks: one wave on 132 SMs.  d is walked in 32-deep slices,
// double-buffered in shared memory with cp.async (16-byte copies where d,
// L*k and the tile's first column allow it, else 4-byte copies; the ragged
// edges of B, d and the columns are zero-filled).  Eight warps each own a
// 32 x 24 sub-tile: per 8-deep step, 2 x 3 mma.sync.m16n8k8 TF32 tiles, 3
// products each, split in registers as the fragments are read.  Row pads of
// 4 (x) and 8 (proj) words make the fragment reads conflict-free.
// mma.sync's TF32 rate on Hopper, well below wgmma's 495 TFLOP/s, and the
// 31 MB that 64 x 96 tiles read through L2 bound this design, not the
// 3.6 us above (PERF.md).  After the last slice the sign bits (y >= 0) go to
// shared memory, and one thread per (row, hash row) folds its k bits with
// the uint32 mix and the golden-ratio multiply, which wrap mod 2^32 like the
// reference's uint32 arrays, then takes the remainder by n_buckets.
#include "common.cuh"

namespace {

constexpr int kTileB = 64;     // rows of x per block
constexpr int kTileN = 96;     // projection columns per block (whole hash rows)
constexpr int kTileD = 32;     // depth of one staged slice
constexpr int kPadX = 4;       // xs row pad: rows 36 words apart
constexpr int kPadP = 8;       // ps row pad: rows 104 words apart
constexpr int kThreads = 256;  // 8 warps: 2 (rows) x 4 (columns)
constexpr int kWarpM = 32;     // rows of a warp's sub-tile (2 m16 tiles)
constexpr int kWarpN = 24;     // columns of a warp's sub-tile (3 n8 tiles)
constexpr unsigned kMix = 2654435761u;

struct __align__(16) Stage {
  float xs[kTileB][kTileD + kPadX];
  float ps[kTileD][kTileN + kPadP];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (4 or 16) with zero fill when `valid` is false.
template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const float* src,
                                           bool valid) {
  const int n = valid ? kBytes : 0;
  if (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// v = big + small + e, both TF32 (fp32 bit patterns with the low 13 bits
// clear): big is v rounded to nearest (ties away), small the exact
// remainder v - big truncated, so |e| <= 2^-21 |v|.  Two integer operations
// each, where cvt.rna.tf32.f32 would cost more issue slots.
__device__ __forceinline__ void split(float v, unsigned& big, unsigned& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage one d-slice of x (rows b0..) and proj (columns col0.., ncols of them).
template <int kBytes>
__device__ __forceinline__ void load_slice(Stage& st, const float* __restrict__ x,
                                           const float* __restrict__ proj,
                                           int B, int d, long long LK, int b0,
                                           long long col0, int ncols, int d0) {
  constexpr int kVec = kBytes / 4;
  const int tid = threadIdx.x;
  for (int i = tid; i < kTileB * kTileD / kVec; i += kThreads) {
    const int r = i / (kTileD / kVec);
    const int c = (i - r * (kTileD / kVec)) * kVec;
    const int b = b0 + r;
    const int j = d0 + c;
    const bool ok = b < B && j < d;
    copy_async<kBytes>(&st.xs[r][c], ok ? x + static_cast<long long>(b) * d + j : x, ok);
  }
  for (int i = tid; i < kTileD * kTileN / kVec; i += kThreads) {
    const int r = i / (kTileN / kVec);
    const int c = (i - r * (kTileN / kVec)) * kVec;
    const int j = d0 + r;
    const bool ok = j < d && c < ncols;
    copy_async<kBytes>(&st.ps[r][c], ok ? proj + static_cast<long long>(j) * LK + col0 + c : proj,
                       ok);
  }
}

template <int kBytes>
__global__ void __launch_bounds__(kThreads)
srp_hash_kernel(const float* __restrict__ x, const float* __restrict__ proj,
                const long long* __restrict__ mix, int* __restrict__ out, int B,
                int d, int L, int k, unsigned n_buckets, int rows_per_block) {
  __shared__ Stage stages[2];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread in group
  const int wm = (warp >> 2) * kWarpM;
  const int wn = (warp & 3) * kWarpN;
  const int b0 = blockIdx.x * kTileB;
  const int l0 = blockIdx.y * rows_per_block;
  const int nrows = min(rows_per_block, L - l0);
  const int ncols = nrows * k;
  const long long LK = static_cast<long long>(L) * k;
  const long long col0 = static_cast<long long>(l0) * k;

  // big*big and the two cross products in separate accumulators: two
  // shorter dependency chains, added once at the end
  float acc[2][3][4], cross[2][3][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = cross[i][j][e] = 0.f;

  const int n_slices = (d + kTileD - 1) / kTileD;
  load_slice<kBytes>(stages[0], x, proj, B, d, LK, b0, col0, ncols, 0);
  commit_group();
  for (int s = 0; s < n_slices; ++s) {
    if (s + 1 < n_slices) {
      load_slice<kBytes>(stages[(s + 1) & 1], x, proj, B, d, LK, b0, col0, ncols,
                         (s + 1) * kTileD);
      commit_group();
      wait_group<1>();
    } else {
      wait_group<0>();
    }
    __syncthreads();
    const Stage& st = stages[s & 1];
#pragma unroll
    for (int kk = 0; kk < kTileD; kk += 8) {
      unsigned a_big[2][4], a_small[2][4], b_big[3][2], b_small[3][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + 16 * i + g;
        split(st.xs[r][kk + t], a_big[i][0], a_small[i][0]);
        split(st.xs[r + 8][kk + t], a_big[i][1], a_small[i][1]);
        split(st.xs[r][kk + t + 4], a_big[i][2], a_small[i][2]);
        split(st.xs[r + 8][kk + t + 4], a_big[i][3], a_small[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int c = wn + 8 * j + g;
        split(st.ps[kk + t][c], b_big[j][0], b_small[j][0]);
        split(st.ps[kk + t + 4][c], b_big[j][1], b_small[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          mma_tf32(cross[i][j], a_small[i], b_big[j]);
          mma_tf32(cross[i][j], a_big[i], b_small[j]);
          mma_tf32(acc[i][j], a_big[i], b_big[j]);
        }
    }
    __syncthreads();
  }

  // Sign bits into shared memory (over the first stage, no longer read).
  auto bits = reinterpret_cast<unsigned char(*)[kTileN]>(&stages[0]);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int r = wm + 16 * i + g;
      const int c = wn + 8 * j + 2 * t;
      bits[r][c] = acc[i][j][0] + cross[i][j][0] >= 0.f;
      bits[r][c + 1] = acc[i][j][1] + cross[i][j][1] >= 0.f;
      bits[r + 8][c] = acc[i][j][2] + cross[i][j][2] >= 0.f;
      bits[r + 8][c + 1] = acc[i][j][3] + cross[i][j][3] >= 0.f;
    }
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
  const long long LK = static_cast<long long>(L) * k;
  dim3 grid((B + kTileB - 1) / kTileB, (L + rows_per_block - 1) / rows_per_block);
  // 16-byte copies need every copied row and tile start on a 16-byte boundary.
  const bool vec = d % 4 == 0 && LK % 4 == 0 && (rows_per_block * k) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(proj) % 16 == 0;
  if (vec) {
    srp_hash_kernel<16><<<grid, kThreads, 0, s>>>(x, proj, mix, out, B, d, L, k,
                                                  static_cast<unsigned>(n_buckets),
                                                  rows_per_block);
  } else {
    srp_hash_kernel<4><<<grid, kThreads, 0, s>>>(x, proj, mix, out, B, d, L, k,
                                                 static_cast<unsigned>(n_buckets),
                                                 rows_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}
