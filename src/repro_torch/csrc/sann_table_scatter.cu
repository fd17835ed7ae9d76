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
// write_ptr and n_kept are int32 arrays of T entries on the device (one per
// tenant of a stacked fleet; T = 1 for one sketch): the host never waits.
// The tables hold T * rows_per_tenant rows, and row r belongs to tenant
// r / rows_per_tenant, so one launch commits every tenant of a fleet chunk.
// Bound: bytes, one read and one write of the table (779 MB for the
// SIFT1M-shaped cell, 0.23 ms at 3.35 TB/s), plus the scatter's.  The pass
// is a grid-stride copy in 16-byte vectors, four in flight a thread, with
// a few integer operations an id (no division: each of a thread's four
// vector streams caches its tenant's range and reduced write_ptr, and
// divides only when a vector leaves that range, about once every 13
// strides at the fleet's tenant size), where the plain PyTorch sequence
// materialised an int64 copy and a gathered table.  When a tenant's span is
// not a whole number of vectors a scalar pass, cached the same way, runs
// instead.
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

// A tenant's range of units (16-byte vectors or single ids), its
// write_ptr reduced into [0, capacity) and its n_kept.
struct Tenant {
  long long lo, hi;
  int wp, nk;
};

// The tenant owning unit `i`; a tenant spans `span` units.
__device__ __forceinline__ Tenant tenant_of(long long i, long long span,
                                            const int* __restrict__ wp_p,
                                            const int* __restrict__ nk_p,
                                            int capacity) {
  const long long t = i / span;
  Tenant r;
  r.lo = t * span;
  r.hi = r.lo + span;
  r.wp = static_cast<int>(repro_torch::floor_mod(wp_p[t], capacity));
  r.nk = nk_p[t];
  return r;
}

__device__ __forceinline__ int4 tombstone4(int4 x, const Tenant& t,
                                           int capacity) {
  return make_int4(tombstone(x.x, t.wp, t.nk, capacity),
                   tombstone(x.y, t.wp, t.nk, capacity),
                   tombstone(x.z, t.wp, t.nk, capacity),
                   tombstone(x.w, t.wp, t.nk, capacity));
}

// Vector pass: each tenant spans `span4` whole 16-byte vectors.
__global__ void __launch_bounds__(kThreads) sann_table_scatter_tombstone(
    const int* __restrict__ in, int* __restrict__ out,
    const int* __restrict__ write_ptr_p, const int* __restrict__ n_kept_p,
    long long n, long long span4, int capacity) {
  const long long n4 = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const int4* in4 = reinterpret_cast<const int4*>(in);
  int4* out4 = reinterpret_cast<int4*>(out);
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  Tenant ten[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) ten[u].lo = ten[u].hi = -1;
  for (; i + (kUnroll - 1) * stride < n4; i += kUnroll * stride) {
    int4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = __ldcs(in4 + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * stride;
      if (j >= ten[u].hi || j < ten[u].lo)
        ten[u] = tenant_of(j, span4, write_ptr_p, n_kept_p, capacity);
      out4[j] = tombstone4(x[u], ten[u], capacity);
    }
  }
  for (; i < n4; i += stride) {
    const int4 x = __ldcs(in4 + i);
    if (i >= ten[0].hi || i < ten[0].lo)
      ten[0] = tenant_of(i, span4, write_ptr_p, n_kept_p, capacity);
    out4[i] = tombstone4(x, ten[0], capacity);
  }
  // the n % 4 tail (only with one tenant: tenant 0)
  const long long t = n4 * 4 + static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t < n) {
    const Tenant last = tenant_of(t, 4 * span4, write_ptr_p, n_kept_p,
                                  capacity);
    out[t] = tombstone(in[t], last.wp, last.nk, capacity);
  }
}

// Scalar pass, for tenants whose span is not a whole number of vectors.
__global__ void __launch_bounds__(kThreads) sann_table_scatter_tombstone1(
    const int* __restrict__ in, int* __restrict__ out,
    const int* __restrict__ write_ptr_p, const int* __restrict__ n_kept_p,
    long long n, long long span, int capacity) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  Tenant ten;
  ten.lo = ten.hi = -1;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    if (i >= ten.hi || i < ten.lo)
      ten = tenant_of(i, span, write_ptr_p, n_kept_p, capacity);
    out[i] = tombstone(__ldcs(in + i), ten.wp, ten.nk, capacity);
  }
}

int n_sms() {
  // per card: one process may launch on several
  static int sms[repro_torch::kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  const bool cached = dev >= 0 && dev < repro_torch::kMaxDevices;
  if (cached && sms[dev] > 0) return sms[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  n = n > 0 ? n : 1;
  if (cached) sms[dev] = n;
  return n;
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

// Both launches of one commit; `in` and `out` are distinct (T * R, NB, cap)
// tables, 16-byte aligned, R = rows_per_tenant; write_ptr and n_kept hold T
// entries.  Returns the first launch error (0 if none).
extern "C" int sann_table_commit_launch(
    const int* in, int* out, const int* table_ptr, const int* s_l,
    const int* s_c, const int* rank, const int* val, const unsigned char* mask,
    const int* write_ptr, const int* n_kept, int E, int L, int NB, int cap,
    int capacity, int rows_per_tenant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(L) * NB * cap;
  if (n > 0) {
    const long long span = static_cast<long long>(rows_per_tenant) * NB * cap;
    // one tenant: every vector (and the n % 4 tail) is tenant 0's
    const bool one = rows_per_tenant >= L;
    const bool vec = one || span % 4 == 0;
    const long long lanes = vec ? n / 4 : n;
    const long long want = (lanes + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(
        want < 1 ? 1 : (want < 8LL * n_sms() ? want : 8LL * n_sms()));
    if (vec) {
      sann_table_scatter_tombstone<<<blocks, kThreads, 0, s>>>(
          in, out, write_ptr, n_kept, n, one ? n / 4 + 1 : span / 4,
          capacity);
    } else {
      sann_table_scatter_tombstone1<<<blocks, kThreads, 0, s>>>(
          in, out, write_ptr, n_kept, n, span, capacity);
    }
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
