// CG MoE dispatch (capacity-bounded top-k with overflow probing) for
// Hopper (sm_90a).
//
// Replaces, in the JAX package:
//   cg_dispatch_kernel <- repro/kernels/cg_dispatch.py::cg_dispatch
//                         (body _dispatch_kernel)
// and computes, bit for bit, the plain torch version
// repro_torch/kernels/ref.py::ref_cg_dispatch.
//
// Semantics of one token group. Blocks of `block` tokens run in order
// with the per-expert load [E] carried. Within a block, rank by rank
// (r < D): every token with fewer than k accepted slots bids pref[t, r];
// its position is the number of earlier tokens of the block that still
// want a slot and bid the same expert, accepted or not; the bid is
// accepted iff load[e] + position < cap[e], with the load read before any
// add of this rank, and writes the expert, the slot load[e] + position and
// the gate to column nacc of the token; then the accepted bids add 1 to
// their experts. After the ranks, a token's weights are divided by
// max(sum of its k weights, 1e-9), summed left to right.
//
// What bounds it. Groups are independent; within a group each block
// depends on the loads the one before left, and each rank on the adds of
// the rank before. The least time the card could take is set by the bytes
// the function must move (pref and gates in, assign, slot, weights and
// load out) over 3.35 TB/s; in practice the chain of ranks sets the pace:
// two barriers per rank, and the position scan.
//
// Design. One CTA per group (at prefill a group is a sequence, G CTAs on
// G SMs; at decode the whole batch is one group). The load and the
// capacities stay in shared memory; a thread owns a token of the block.
// The bids of a rank go to a shared array, and a token's position is a
// plain scan over the bids of the tokens before it in its block, O(block)
// per token and rank, which keeps the block order that atomics alone
// would lose. A rank takes two barriers: after the bids, and after the
// accept decisions (__syncthreads_or, which also tells whether a token
// still wants a slot: the ranks stop early when none does, which changes
// nothing since such ranks make no bid); the adds of a rank land before
// the next rank's bids are read. Adds are atomicAdd of 1.0 on
// integer-valued f32, exact in any order below 2^24. A token's outputs
// are written by the thread that owns it, straight to global memory.
//
// Numerics. The position enters the compare as an f32, exact below 2^24,
// added with __fadd_rn; the weight sum is __fadd_rn left to right and the
// division __fdiv_rn, as torch divides. Build without --use_fast_math.
//
// C interface (bound with ctypes): the launcher returns the cudaError_t
// of the launch, 0 on success.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;

__global__ void cg_dispatch_kernel(
    const int* __restrict__ pref, const float* __restrict__ gates,
    const float* __restrict__ caps, int* __restrict__ assign,
    int* __restrict__ slot, float* __restrict__ wts,
    float* __restrict__ load_out, int T, int D, int n_experts, int k,
    int block) {
  extern __shared__ float smem[];
  const int E = n_experts;
  float* load = smem;                                     // [E]
  float* cap = load + E;                                  // [E]
  int* bid = reinterpret_cast<int*>(cap + E);             // [block]
  int* nacc = bid + block;                                // [block]
  int* took = nacc + block;                               // [block]

  const size_t g = blockIdx.x;
  pref += g * T * D;
  gates += g * T * D;
  assign += g * T * k;
  slot += g * T * k;
  wts += g * T * k;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    load[e] = 0.0f;
    cap[e] = caps[e];
  }

  for (int b0 = 0; b0 < T; b0 += block) {
    for (int j = threadIdx.x; j < block; j += blockDim.x) {
      nacc[j] = 0;
      const size_t row = static_cast<size_t>(b0 + j) * k;
      for (int c = 0; c < k; ++c) {
        assign[row + c] = -1;
        slot[row + c] = -1;
        wts[row + c] = 0.0f;
      }
    }
    int left = 1;
    for (int r = 0; r < D && left; ++r) {
      for (int j = threadIdx.x; j < block; j += blockDim.x) {
        const int e = pref[static_cast<size_t>(b0 + j) * D + r];
        bid[j] = (nacc[j] < k && e >= 0 && e < E) ? e : -1;
      }
      __syncthreads();  // bids written; the previous rank's adds landed
      int want = 0;
      for (int j = threadIdx.x; j < block; j += blockDim.x) {
        const int e = bid[j];
        took[j] = -1;
        if (e >= 0) {
          int pos = 0;
          for (int jj = 0; jj < j; ++jj) pos += bid[jj] == e;
          const float my = __fadd_rn(load[e], static_cast<float>(pos));
          if (my < cap[e]) {
            const size_t at = static_cast<size_t>(b0 + j) * k + nacc[j];
            assign[at] = e;
            slot[at] = static_cast<int>(my);
            wts[at] = gates[static_cast<size_t>(b0 + j) * D + r];
            took[j] = e;
            ++nacc[j];
          }
        }
        want |= nacc[j] < k;
      }
      left = __syncthreads_or(want);  // every load of this rank was read
      for (int j = threadIdx.x; j < block; j += blockDim.x)
        if (took[j] >= 0) atomicAdd(load + took[j], 1.0f);
    }
    // renormalize the block's weights over the placed slots
    for (int j = threadIdx.x; j < block; j += blockDim.x) {
      float* w = wts + static_cast<size_t>(b0 + j) * k;
      float denom = w[0];
      for (int c = 1; c < k; ++c) denom = __fadd_rn(denom, w[c]);
      denom = fmaxf(denom, 1e-9f);
      for (int c = 0; c < k; ++c) w[c] = __fdiv_rn(w[c], denom);
    }
    __syncthreads();  // the adds of the last rank landed; bid reusable
  }
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    load_out[g * E + e] = load[e];
}

// Dynamic shared memory of a launch: load and capacities [E] f32, and the
// bids, accepted counts and accepted experts of a block [block] i32 each
// (the wrapper checks the same sum against the card's limit).
size_t smem_bytes(int n_experts, int block) {
  return sizeof(float) * 2 * static_cast<size_t>(n_experts) +
         sizeof(int) * 3 * static_cast<size_t>(block);
}

}  // namespace

extern "C" int cg_dispatch_launch(const void* pref, const void* gates,
                                  const void* caps, void* assign, void* slot,
                                  void* wts, void* load_out, int n_groups,
                                  int T, int D, int n_experts, int k,
                                  int block, void* stream) {
  const size_t bytes = smem_bytes(n_experts, block);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cg_dispatch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // one thread per token of a block, in [32, 1024]
  int threads = (block + kWarp - 1) / kWarp * kWarp;
  threads = threads > 1024 ? 1024 : threads;
  cg_dispatch_kernel<<<n_groups, threads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pref), static_cast<const float*>(gates),
      static_cast<const float*>(caps), static_cast<int*>(assign),
      static_cast<int*>(slot), static_cast<float*>(wts),
      static_cast<float*>(load_out), T, D, n_experts, k, block);
  return static_cast<int>(cudaGetLastError());
}
