// sann_table_scatter — the S-ANN sorted-segment ring append, in place:
// tables[s_l, s_c, (table_ptr[s_l, s_c] + rank) mod cap] = val where mask.
//
// Replaces: the Pallas kernel `sann_table_scatter` in
// src/repro/kernels/ingest_commit.py, where every table row walks all E
// entries in a serial fori_loop (O(L*E) steps).
//
// Bound on the H100: bytes, and those are scattered.  It reads the E entries
// (s_l, s_c, rank, val: 4 bytes each, mask: 1 byte) once, and for each masked
// entry reads one 4-byte ring pointer and writes one 4-byte slot id.  Each
// scattered 4-byte access costs a 32-byte sector of DRAM traffic.
//
// Design: one thread per entry; no ordering is needed.  `mask` is the
// commit's `entry_win` (the last bucket_cap ranks of each bucket), so the
// ring positions of the masked entries of one bucket are distinct and no
// two writes collide.  The modulus floors (rank and pointer are
// non-negative in practice; floor_mod keeps the reference's semantics
// regardless).  Entries whose (row, code) lies outside the table are dropped.
//
// sann_table_commit — the S-ANN commit's whole table update, old tables in,
// new tables out, in two launches on one stream:
//   1. sann_table_scatter_tombstone: out = in with every slot id v >= 0 that
//      points at a slot recycled this chunk replaced by -1, where recycled
//      means floor_mod(min(v, capacity - 1) - write_ptr, capacity) < n_kept
//      (the reference's `overwritten[jnp.maximum(tables, 0)]` with its
//      clamped gather, src/repro/core/sann.py `sann_commit_chunk`);
//   2. sann_table_scatter_kernel, the ring append above, into `out`.
// write_ptr and n_kept are int32 scalars on the device: the host never
// waits.  Bound: bytes, one read and one write of the table (779 MB for the
// SIFT1M-shaped cell, 0.23 ms at 3.35 TB/s), plus the scatter's.  The pass
// is a grid-stride copy in 16-byte vectors, four in flight a thread, with
// a few integer operations an id (no division: write_ptr is reduced once a
// thread), where the plain PyTorch sequence materialised an int64 copy and
// a gathered table.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void sann_table_scatter_kernel(
    int* __restrict__ tables, const int* __restrict__ table_ptr,
    const int* __restrict__ s_l, const int* __restrict__ s_c,
    const int* __restrict__ rank, const int* __restrict__ val,
    const unsigned char* __restrict__ mask, int E, int L, int NB, int cap) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E || !mask[e]) return;
  const int l = s_l[e];
  const int c = s_c[e];
  if (l < 0 || l >= L || c < 0 || c >= NB) return;
  const long long bucket = static_cast<long long>(l) * NB + c;
  const long long pos = repro_torch::floor_mod(
      static_cast<long long>(table_ptr[bucket]) + rank[e], cap);
  tables[bucket * cap + pos] = val[e];
}

// `wp` is write_ptr reduced into [0, capacity): then min(v, capacity - 1)
// - wp lies in (-capacity, capacity) and one conditional add floors it.
__device__ __forceinline__ int tombstone(int v, int wp, int n_kept,
                                         int capacity) {
  if (v < 0) return v;
  int off = min(v, capacity - 1) - wp;
  if (off < 0) off += capacity;
  return off < n_kept ? -1 : v;
}

constexpr int kUnroll = 4;   // 16-byte vectors in flight per thread

__global__ void __launch_bounds__(kThreads) sann_table_scatter_tombstone(
    const int* __restrict__ in, int* __restrict__ out,
    const int* __restrict__ write_ptr_p, const int* __restrict__ n_kept_p,
    long long n, int capacity) {
  const int wp = static_cast<int>(repro_torch::floor_mod(*write_ptr_p, capacity));
  const int nk = *n_kept_p;
  const long long n4 = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const int4* in4 = reinterpret_cast<const int4*>(in);
  int4* out4 = reinterpret_cast<int4*>(out);
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n4; i += kUnroll * stride) {
    int4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = __ldcs(in4 + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int4 y;
      y.x = tombstone(x[u].x, wp, nk, capacity);
      y.y = tombstone(x[u].y, wp, nk, capacity);
      y.z = tombstone(x[u].z, wp, nk, capacity);
      y.w = tombstone(x[u].w, wp, nk, capacity);
      out4[i + u * stride] = y;
    }
  }
  for (; i < n4; i += stride) {
    const int4 x = __ldcs(in4 + i);
    out4[i] = make_int4(tombstone(x.x, wp, nk, capacity),
                        tombstone(x.y, wp, nk, capacity),
                        tombstone(x.z, wp, nk, capacity),
                        tombstone(x.w, wp, nk, capacity));
  }
  // the n % 4 tail
  const long long t = n4 * 4 + static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t < n) out[t] = tombstone(in[t], wp, nk, capacity);
}

int n_sms() {
  static int sms = 0;   // one card a process
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

}  // namespace

extern "C" int sann_table_scatter_launch(int* tables, const int* table_ptr,
                                         const int* s_l, const int* s_c,
                                         const int* rank, const int* val,
                                         const unsigned char* mask, int E,
                                         int L, int NB, int cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (E + kThreads - 1) / kThreads;
  sann_table_scatter_kernel<<<blocks, kThreads, 0, s>>>(
      tables, table_ptr, s_l, s_c, rank, val, mask, E, L, NB, cap);
  return static_cast<int>(cudaGetLastError());
}

// Both launches of one commit; `in` and `out` are distinct (L, NB, cap)
// tables, 16-byte aligned.  Returns the first launch error (0 if none).
extern "C" int sann_table_commit_launch(
    const int* in, int* out, const int* table_ptr, const int* s_l,
    const int* s_c, const int* rank, const int* val, const unsigned char* mask,
    const int* write_ptr, const int* n_kept, int E, int L, int NB, int cap,
    int capacity, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(L) * NB * cap;
  if (n > 0) {
    const long long want = (n / 4 + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(
        want < 1 ? 1 : (want < 8LL * n_sms() ? want : 8LL * n_sms()));
    sann_table_scatter_tombstone<<<blocks, kThreads, 0, s>>>(
        in, out, write_ptr, n_kept, n, capacity);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (E > 0 && cap > 0) {
    const int blocks = (E + kThreads - 1) / kThreads;
    sann_table_scatter_kernel<<<blocks, kThreads, 0, s>>>(
        out, table_ptr, s_l, s_c, rank, val, mask, E, L, NB, cap);
  }
  return static_cast<int>(cudaGetLastError());
}
