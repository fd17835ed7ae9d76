// Shared helpers for the repro_torch CUDA kernels (sm_90a).
//
// CUDA's integer `/` and `%` truncate toward zero; the reference (jnp) floors.
// Every division or modulus whose operand can be negative goes through
// floor_div / floor_mod.  Index arithmetic that the reference does in int32
// (and may wrap there) goes through wrap_add_mul, which wraps the same way
// without signed-overflow undefined behaviour.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// Host-side caches keyed by card (a process may launch on several).
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ long long floor_mod(long long a, long long m) {
  long long r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// a + b * c in two's-complement int32 (the reference's wrap semantics).
__device__ __forceinline__ int wrap_add_mul(int a, int b, int c) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b) * static_cast<unsigned>(c));
}

}  // namespace repro_torch
