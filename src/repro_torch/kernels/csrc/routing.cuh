// Device helpers shared by the routing kernels (porc_snapshot.cu,
// porc_assign.cu): the salted hash family, cached reads of state that may
// live in shared or global memory, warp and block reductions, the stable
// load order, and the dynamic shared-memory limit of a launch.
//
// Every float operation is an explicit round-to-nearest intrinsic so
// that nvcc cannot contract it into an FMA; build without
// --use_fast_math.

#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// repro/core/hashing.py::hash_to_bins for one (key, salt).
__device__ __forceinline__ int hash_to_bin(uint32_t key, uint32_t salt,
                                           uint32_t n_bins) {
  uint32_t h = mix32(key + salt * 0x9E3779B9u);
  h = mix32(h ^ (salt * 0x7F4A7C15u + 0x165667B1u));
  return static_cast<int>(h % n_bins);
}

// The same bin by multiplication instead of a division: h % n ==
// umulhi64(M * h, n) for every 32-bit h, with M = mod_magic(n) (Lemire,
// Kaser and Kurz, "Faster remainder by direct computation", 2019).
__host__ __device__ inline uint64_t mod_magic(uint32_t n) {
  return 0xFFFFFFFFFFFFFFFFull / n + 1;
}

__device__ __forceinline__ int hash_to_bin_by(uint32_t key, uint32_t salt,
                                              uint32_t n, uint64_t magic) {
  uint32_t h = mix32(key + salt * 0x9E3779B9u);
  h = mix32(h ^ (salt * 0x7F4A7C15u + 0x165667B1u));
  return static_cast<int>(__umul64hi(magic * h, n));
}

template <bool kSmem>
__device__ __forceinline__ float rd(const float* p) {
  if constexpr (kSmem) {
    return *p;
  } else {
    return __ldcg(p);  // L2: sees the CTA's own atomics after a barrier
  }
}

// (value, index) pair that wins: smaller value, then smaller index.
__device__ __forceinline__ void argmin_merge(float& v, int& i, float v2,
                                             int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    float v2 = __shfl_xor_sync(0xFFFFFFFFu, v, off);
    int i2 = __shfl_xor_sync(0xFFFFFFFFu, i, off);
    argmin_merge(v, i, v2, i2);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
  return v;
}

// Block-wide argmin of load[0..n), lowest index on ties. Every thread of
// the CTA must call it; every thread gets the result.
template <bool kSmem>
__device__ int block_argmin(const float* load, int n) {
  __shared__ float red_v[kWarp];
  __shared__ int red_i[kWarp];
  float v = INFINITY;
  int idx = 0x7FFFFFFF;
  for (int c = threadIdx.x; c < n; c += blockDim.x)
    argmin_merge(v, idx, rd<kSmem>(load + c), c);
  warp_argmin(v, idx);
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = idx;
  }
  __syncthreads();
  const int n_warps = (blockDim.x + kWarp - 1) / kWarp;
  v = lane < n_warps ? red_v[lane] : INFINITY;
  idx = lane < n_warps ? red_i[lane] : 0x7FFFFFFF;
  warp_argmin(v, idx);
  __syncthreads();  // red_* reusable by the next call
  return idx;
}

// Block-wide sum (integer-valued f32: exact in any order below 2^24).
template <bool kSmem>
__device__ float block_sum(const float* x, int n) {
  __shared__ float red[kWarp];
  float acc = 0.0f;
  for (int c = threadIdx.x; c < n; c += blockDim.x)
    acc = __fadd_rn(acc, rd<kSmem>(x + c));
  acc = warp_sum(acc);
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  const int n_warps = (blockDim.x + kWarp - 1) / kWarp;
  acc = warp_sum(lane < n_warps ? red[lane] : 0.0f);
  __syncthreads();
  return acc;
}

// Sortable bits of (value, index): ascending order of the keys is the
// stable ascending order of the values.
__device__ __forceinline__ uint64_t sort_key(float v, int i) {
  if (v == 0.0f) v = 0.0f;  // -0 sorts with +0, as torch's argsort
  uint32_t u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<uint64_t>(u) << 32) | static_cast<uint32_t>(i);
}

// Stable ascending order of value(0..n) into order[0..P), P a power of two
// >= n (the index is the low 32 bits of each entry): a bitonic network over
// (value, index) keys in a global scratch buffer, padding sorted last.
// Every thread of the CTA must call it; it ends with a barrier.
template <typename Value>
__device__ void stable_order(Value value, int n, uint64_t* order, int P) {
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    order[i] = i < n ? sort_key(value(i), i) : ~0ull;
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t a = __ldcg(order + i), b = __ldcg(order + ixj);
          if ((a > b) == ((i & k) == 0)) {
            order[i] = b;
            order[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Largest dynamic shared memory a launch asks for; above it the state
// lives in the output buffers in global memory.
constexpr size_t kSmemLimit = 220 * 1024;

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
