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
