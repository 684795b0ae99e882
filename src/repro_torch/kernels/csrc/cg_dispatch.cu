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
// load out) over 3.35 TB/s; what sets the pace is the chain of ranks.
//
// Two designs, both with the loads in shared memory as integers (a float
// atomic add on shared memory is a compare-and-swap loop), the block's
// pref and gates rows staged there by cp.async (the next block's while
// this one routes, `stages` = 2; or one stage; or, when even one does not
// fit, read from global memory: `stages` = 0), and the block's outputs
// built there, renormalized and written once, coalesced. The positions
// within a warp come from `peers`, the lanes that bid the same expert
// (one ballot per bit of the expert index; __match_any_sync in the
// one-warp kernel for blocks of up to 32 tokens): popc(peers &
// lanemask_lt).
// The wrapper's plan picks the kernel by the sizes (`cta`).
//
// cg_dispatch_kernel_cta: a CTA a group and a thread a token of the block
// (blocks of up to 1,024). Rank by rank, each warp's lowest lane of a
// peer group writes the warp's count of bids of that expert to a table
// [warps][E] (stamped with the rank, so it is never cleared); after one
// barrier a bid's position is its lanes' position plus the counts of the
// earlier warps, the bid is decided against the load before the rank, and
// each group's leader adds its accepted count with an integer atomic.
// The load is double-buffered by rank parity so that this one barrier a
// rank orders every read before every add (see the kernel); the table is
// double-buffered the same way. Needs 8·warps·E bytes for the table: at
// E = 16,384 that does not fit.
//
// cg_dispatch_kernel_warp: one warp a group (any E and block). The warp
// walks a block 32 tokens at a time in block order, keeping a running
// load: the group's leader stores load + its accepted count after all
// lanes read it. Walking in order with the adds landed is exact for these
// semantics: the bids a rank accepts for an expert are a prefix of its
// bidders in block order (position p is accepted iff load + p < cap), so
// while every earlier bid was accepted the running load is the load plus
// the earlier bids, and once one was refused the running load has reached
// the cap and every later bid is refused too, as it is with the load read
// before the rank. The bids of four sub-groups are read and matched
// together before the chain over their loads. The ranks stop early, in
// both kernels, when no token of the block wants a slot.
//
// Numerics. Loads are counts below 2^24 (the wrapper requires T·k < 2^24),
// exact as integers and as f32; the compare is __fadd_rn(float(load),
// float(position)) < cap[e] in f32 and the slot (int) of that sum, as in
// the plain version; the weight sum is __fadd_rn left to right and the
// division __fdiv_rn, as torch divides. Build without --use_fast_math.
//
// C interface (bound with ctypes): the launcher returns the cudaError_t
// of the launch, 0 on success (cudaErrorInvalidValue when the caller's
// plan disagrees with the layout here). The wrapper requires T·k < 2^24
// and T/block·D < 2^25 (the table's stamps).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 4;  // sub-groups whose bids a warp reads together
constexpr int kSmemLimit = 232448;
constexpr int kMaxWarps = 32;  // the CTA kernel: blocks of up to 1,024

__host__ __device__ inline size_t pad16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Shared memory of a launch, in bytes from the start: the load [E] i32 and
// the capacities [E] f32; the accepted counts [block] i32; the block's
// assign, slot [block·k] i32 and weights [block·k] f32; `stages` buffers
// of the block's pref [block·D] i32 and gates [block·D] f32; for the CTA
// kernel (`cta`) also the load's second buffer [E] i32 and the per-warp
// bid counts [2][warps][E] i32.
struct Layout {
  size_t load, cap, nacc, oa, os, ow, rows, row_bytes, load2, counts, bytes;
  __host__ __device__ Layout(int E, int block, int D, int k, int stages,
                             int cta) {
    const size_t bk = static_cast<size_t>(block) * k;
    const size_t e4 = pad16(4 * static_cast<size_t>(E));
    load = 0;
    cap = load + e4;
    nacc = cap + e4;
    oa = nacc + pad16(4 * static_cast<size_t>(block));
    os = oa + pad16(4 * bk);
    ow = os + pad16(4 * bk);
    rows = ow + pad16(4 * bk);
    row_bytes = pad16(4 * static_cast<size_t>(block) * D);
    load2 = rows + 2 * row_bytes * stages;
    counts = load2 + (cta ? e4 : 0);
    const size_t warps = (static_cast<size_t>(block) + kWarp - 1) / kWarp;
    bytes = counts + (cta ? pad16(8 * warps * E) : 0);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dst (shared) <- src (global), `count` words, by the CTA's threads, 16
// bytes a copy where both are aligned. The caller commits and waits.
__device__ void stage_words(void* dst, const void* src, int count) {
  const bool vec = ((reinterpret_cast<uintptr_t>(dst) |
                     reinterpret_cast<uintptr_t>(src)) & 15) == 0;
  const int n4 = vec ? count / 4 : 0;
  auto* d = static_cast<uint32_t*>(dst);
  const auto* s = static_cast<const uint32_t*>(src);
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    cp_async16(d + 4 * i, s + 4 * i);
  for (int i = 4 * n4 + threadIdx.x; i < count; i += blockDim.x)
    cp_async4(d + i, s + i);
}

// dst (global) <- src (shared), `count` words, then src <- fill: the
// block's outputs written once, coalesced, and their buffer reset.
template <typename T>
__device__ void flush_words(T* __restrict__ dst, T* src, int count, T fill) {
  const bool vec = (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  const int n4 = vec ? count / 4 : 0;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
    T* s = src + 4 * i;
    s[0] = fill;
    s[1] = fill;
    s[2] = fill;
    s[3] = fill;
  }
  for (int i = 4 * n4 + threadIdx.x; i < count; i += blockDim.x) {
    dst[i] = src[i];
    src[i] = fill;
  }
}

// The lanes of the warp whose `e` equals this lane's, among those with
// e >= 0 (e in [0, 2^ebits)): one ballot per bit of the expert index.
// (__match_any_sync costs about as many cycles as the warp has distinct
// values: the one-warp kernel at 8 groups of 1,024 tokens in blocks of
// 128 over 128 experts took 0.134 ms with it, 0.092 with the ballots;
// at decode, one block of 8 tokens, 0.0079 with it and 0.0094 with the
// ballots, so the one-warp kernel matches blocks of up to 32 tokens.)
__device__ __forceinline__ unsigned peers_of(int e, int ebits) {
  unsigned m = __ballot_sync(kFull, e >= 0);
  for (int bit = 0; bit < ebits; ++bit) {
    const bool on = (e >> bit) & 1;
    const unsigned with = __ballot_sync(kFull, on);
    m &= on ? with : ~with;
  }
  return m;
}

// Renormalizes the weights of the block's tokens t = first, first + step,
// ... over their k slots (sum left to right, clamped at 1e-9).
__device__ void renormalize(float* ow, int block, int k, int first,
                            int step) {
  for (int t = first; t < block; t += step) {
    float* w = ow + t * k;
    float denom = w[0];
    for (int c = 1; c < k; ++c) denom = __fadd_rn(denom, w[c]);
    denom = fmaxf(denom, 1e-9f);
    for (int c = 0; c < k; ++c) w[c] = __fdiv_rn(w[c], denom);
  }
}

struct Smem {
  int *load, *load2, *nacc, *oa, *os, *counts;
  float *cap, *ow;
  unsigned char* rows;
  size_t row_bytes;
  __device__ Smem(unsigned char* base, const Layout& at)
      : load(reinterpret_cast<int*>(base + at.load)),
        load2(reinterpret_cast<int*>(base + at.load2)),
        nacc(reinterpret_cast<int*>(base + at.nacc)),
        oa(reinterpret_cast<int*>(base + at.oa)),
        os(reinterpret_cast<int*>(base + at.os)),
        counts(reinterpret_cast<int*>(base + at.counts)),
        cap(reinterpret_cast<float*>(base + at.cap)),
        ow(reinterpret_cast<float*>(base + at.ow)),
        rows(base + at.rows),
        row_bytes(at.row_bytes) {}
  __device__ int* pref(int s) const {
    return reinterpret_cast<int*>(rows + 2 * s * row_bytes);
  }
  __device__ float* gates(int s) const {
    return reinterpret_cast<float*>(rows + (2 * s + 1) * row_bytes);
  }
};

// The rows of block b: staged (the next block's issued first, with two
// stages) and waited for, or read from global memory (no stage). Every
// thread of the CTA calls it; it ends with the CTA's barrier.
__device__ void block_rows(const Smem& sm, int stages, int b, int n_blocks,
                           int block, int D, const int*& pr,
                           const float*& gr) {
  const int bd = block * D;
  if (stages == 2) {
    const int nxt = (b + 1) & 1;
    if (b + 1 < n_blocks) {
      stage_words(sm.pref(nxt), pr + bd, bd);
      stage_words(sm.gates(nxt), gr + bd, bd);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this block's rows landed
    pr = sm.pref(b & 1);
    gr = sm.gates(b & 1);
  } else if (stages == 1) {
    if (b > 0) {  // the previous block's reads of the stage are done
      stage_words(sm.pref(0), pr, bd);
      stage_words(sm.gates(0), gr, bd);
      cp_async_commit();
    }
    cp_async_wait<0>();
    pr = sm.pref(0);
    gr = sm.gates(0);
  }
  __syncthreads();
}

// One warp a group (any E and block; the layout without `cta`).
__global__ void __launch_bounds__(kWarp) cg_dispatch_kernel_warp(
    const int* __restrict__ pref, const float* __restrict__ gates,
    const float* __restrict__ caps, int* __restrict__ assign,
    int* __restrict__ slot, float* __restrict__ wts,
    float* __restrict__ load_out, int T, int D, int E, int k, int block,
    int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm(smem, Layout(E, block, D, k, stages, 0));
  int* load = sm.load;
  const int lane = threadIdx.x;
  const unsigned lt = (1u << lane) - 1u;
  const size_t g = blockIdx.x;
  pref += g * T * D;
  gates += g * T * D;
  assign += g * T * k;
  slot += g * T * k;
  wts += g * T * k;
  const int bk = block * k;
  const int n_blocks = T / block;
  const int ebits = E > 1 ? 32 - __clz(E - 1) : 0;  // bits of an expert
  const bool by_match = block <= kWarp;  // few distinct experts: match
  const int bits = by_match ? 0 : ebits;

  if (stages > 0) {
    stage_words(sm.pref(0), pref, block * D);
    stage_words(sm.gates(0), gates, block * D);
  }
  cp_async_commit();
  for (int e = lane; e < E; e += kWarp) {
    load[e] = 0;
    sm.cap[e] = __ldg(caps + e);
  }
  for (int j = lane; j < block; j += kWarp) sm.nacc[j] = 0;
  for (int i = lane; i < bk; i += kWarp) {
    sm.oa[i] = -1;
    sm.os[i] = -1;
    sm.ow[i] = 0.0f;
  }

  for (int b = 0; b < n_blocks; ++b) {
    const size_t b0 = static_cast<size_t>(b) * block;
    const int* pr = pref + b0 * D;
    const float* gr = gates + b0 * D;
    block_rows(sm, stages, b, n_blocks, block, D, pr, gr);

    bool left = true;
    for (int r = 0; r < D && left; ++r) {
      bool want = false;
      for (int j0 = 0; j0 < block; j0 += kChunk * kWarp) {
        int e[kChunk], na[kChunk], pos[kChunk];
        unsigned peers[kChunk];
        float cp[kChunk];
        // the bids of up to four sub-groups, read and matched together
        const int n_sub = min(kChunk, (block - j0 + kWarp - 1) / kWarp);
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          e[u] = -1;
          na[u] = k;
          const int t = j0 + u * kWarp + lane;
          if (u < n_sub && t < block) {
            na[u] = sm.nacc[t];
            const int x = pr[t * D + r];
            if (na[u] < k && x >= 0 && x < E) e[u] = x;
          }
          peers[u] = u < n_sub ? __ballot_sync(kFull, e[u] >= 0) : 0u;
          if (by_match && u < n_sub)
            peers[u] &= __match_any_sync(kFull, e[u]);
        }
        // peers_of for the sub-groups side by side
        for (int bit = 0; bit < bits; ++bit) {
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            if (u < n_sub) {  // uniform
              const bool on = (e[u] >> bit) & 1;
              const unsigned with = __ballot_sync(kFull, on);
              peers[u] &= on ? with : ~with;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          pos[u] = __popc(peers[u] & lt);
          cp[u] = e[u] >= 0 ? sm.cap[e[u]] : 0.0f;
        }
        // the chain: each sub-group reads the loads the one before left
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (u >= n_sub) break;  // uniform
          const int t = j0 + u * kWarp + lane;
          int L = 0;
          float my = 0.0f;
          bool ok = false;
          if (e[u] >= 0) {
            L = load[e[u]];
            my = __fadd_rn(static_cast<float>(L),
                           static_cast<float>(pos[u]));
            ok = my < cp[u];
          }
          const unsigned oks = __ballot_sync(kFull, ok);
          if (e[u] >= 0 && (peers[u] & lt) == 0) {  // the group's leader
            const int n_ok = __popc(peers[u] & oks);
            if (n_ok) load[e[u]] = L + n_ok;
          }
          __syncwarp();  // the adds land before the next sub-group reads
          if (ok) {
            const int c = t * k + na[u];
            sm.oa[c] = e[u];
            sm.os[c] = static_cast<int>(my);
            sm.ow[c] = gr[t * D + r];
            sm.nacc[t] = na[u] + 1;
          }
          want |= t < block && na[u] + (ok ? 1 : 0) < k;
        }
      }
      left = __any_sync(kFull, want);
    }

    renormalize(sm.ow, block, k, lane, kWarp);
    for (int t = lane; t < block; t += kWarp) sm.nacc[t] = 0;
    __syncwarp();
    flush_words(assign + b0 * k, sm.oa, bk, -1);
    flush_words(slot + b0 * k, sm.os, bk, -1);
    flush_words(wts + b0 * k, sm.ow, bk, 0.0f);
    __syncwarp();
  }
  for (int e = lane; e < E; e += kWarp)
    load_out[g * E + e] = static_cast<float>(load[e]);
}

// A CTA a group, a thread a token of the block (blocks of up to 1,024;
// the layout with `cta`).
__global__ void __launch_bounds__(kMaxWarps * kWarp) cg_dispatch_kernel_cta(
    const int* __restrict__ pref, const float* __restrict__ gates,
    const float* __restrict__ caps, int* __restrict__ assign,
    int* __restrict__ slot, float* __restrict__ wts,
    float* __restrict__ load_out, int T, int D, int E, int k, int block,
    int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm(smem, Layout(E, block, D, k, stages, 1));

  const int t = threadIdx.x;  // the token of the block this thread owns
  const int lane = t % kWarp, w = t / kWarp;
  const int W = blockDim.x / kWarp;
  const unsigned lt = (1u << lane) - 1u;
  const size_t g = blockIdx.x;
  pref += g * T * D;
  gates += g * T * D;
  assign += g * T * k;
  slot += g * T * k;
  wts += g * T * k;
  const int bk = block * k;
  const int n_blocks = T / block;
  const int ebits = E > 1 ? 32 - __clz(E - 1) : 0;

  if (stages > 0) {
    stage_words(sm.pref(0), pref, block * D);
    stage_words(sm.gates(0), gates, block * D);
  }
  cp_async_commit();
  for (int e = t; e < E; e += blockDim.x) {
    sm.load[e] = 0;
    sm.load2[e] = 0;
    sm.cap[e] = __ldg(caps + e);
  }
  for (int i = t; i < 2 * W * E; i += blockDim.x) sm.counts[i] = -1;
  for (int i = t; i < bk; i += blockDim.x) {
    sm.oa[i] = -1;
    sm.os[i] = -1;
    sm.ow[i] = 0.0f;
  }

  // Rank q (counted over the group's blocks) reads the load in buffer
  // q & 1 (`cur`) and adds its accepted bids to the other (`nxt`), which
  // the rank before left short by its own adds: those (`pend`) are added
  // there too, by the thread that made them, one rank late. Entering rank
  // q, `cur` is the load and `nxt` + pend is the load. So one barrier a
  // rank orders every read before every add.
  int q = 0, pend_e = 0, pend_n = 0;
  for (int b = 0; b < n_blocks; ++b) {
    const size_t b0 = static_cast<size_t>(b) * block;
    const int* pr = pref + b0 * D;
    const float* gr = gates + b0 * D;
    block_rows(sm, stages, b, n_blocks, block, D, pr, gr);

    int nacc = 0;
    for (int r = 0; r < D; ++r, ++q) {
      const int p = q & 1;
      int* const cur = p ? sm.load2 : sm.load;   // the load
      int* const nxt = p ? sm.load : sm.load2;   // the load after the rank
      int* cnt = sm.counts + p * W * E;
      int e = -1;
      if (t < block && nacc < k) {
        const int x = pr[t * D + r];
        if (x >= 0 && x < E) e = x;
      }
      const unsigned peers = peers_of(e, ebits);
      const bool lead = e >= 0 && (peers & lt) == 0;
      // the warp's bids of expert e, stamped with the rank
      if (lead) cnt[w * E + e] = (q << 6) | __popc(peers);
      if (!__syncthreads_or(t < block && nacc < k)) {
        // no token wants a slot: no bid was made; settle `nxt`
        if (pend_n) atomicAdd(nxt + pend_e, pend_n);
        pend_n = 0;
        break;
      }
      int pos = __popc(peers & lt);  // bids of e before this one
      bool ok = false;
      float my = 0.0f;
      if (e >= 0) {
        for (int v = 0; v < w; ++v) {
          const int c = cnt[v * E + e];
          if ((c >> 6) == q) pos += c & 63;
        }
        my = __fadd_rn(static_cast<float>(cur[e]), static_cast<float>(pos));
        ok = my < sm.cap[e];
      }
      const unsigned oks = __ballot_sync(kFull, ok);
      if (pend_n) atomicAdd(nxt + pend_e, pend_n);
      pend_n = 0;
      if (lead) {
        const int n_ok = __popc(peers & oks);
        if (n_ok) {
          atomicAdd(nxt + e, n_ok);
          pend_e = e;
          pend_n = n_ok;
        }
      }
      if (ok) {
        const int c = t * k + nacc;
        sm.oa[c] = e;
        sm.os[c] = static_cast<int>(my);
        sm.ow[c] = gr[t * D + r];
        ++nacc;
      }
    }
    __syncthreads();  // the block's outputs are written
    renormalize(sm.ow, block, k, t, blockDim.x);
    __syncthreads();
    flush_words(assign + b0 * k, sm.oa, bk, -1);
    flush_words(slot + b0 * k, sm.os, bk, -1);
    flush_words(wts + b0 * k, sm.ow, bk, 0.0f);
  }
  __syncthreads();  // the last adds landed: the load is buffer q & 1
  const int* load = (q & 1) ? sm.load2 : sm.load;
  for (int e = t; e < E; e += blockDim.x)
    load_out[g * E + e] = static_cast<float>(load[e]);
}

// the kernels' dynamic shared-memory ceilings, set once each to the
// limit: a set per launch costs host time
bool g_smem_set[2] = {false, false};

}  // namespace

extern "C" int cg_dispatch_launch(const void* pref, const void* gates,
                                  const void* caps, void* assign, void* slot,
                                  void* wts, void* load_out, int n_groups,
                                  int T, int D, int n_experts, int k,
                                  int block, int stages, int cta,
                                  int plan_bytes, void* stream) {
  const size_t bytes = Layout(n_experts, block, D, k, stages, cta).bytes;
  if (stages < 0 || stages > 2 || bytes != static_cast<size_t>(plan_bytes) ||
      bytes > kSmemLimit || (cta && block > kMaxWarps * kWarp))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = cta ? cg_dispatch_kernel_cta : cg_dispatch_kernel_warp;
  if (bytes > 48 * 1024 && !g_smem_set[cta]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_set[cta] = true;
  }
  const int threads = cta ? (block + kWarp - 1) / kWarp * kWarp : kWarp;
  kernel<<<n_groups, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pref), static_cast<const float*>(gates),
      static_cast<const float*>(caps), static_cast<int*>(assign),
      static_cast<int*>(slot), static_cast<float*>(wts),
      static_cast<float*>(load_out), T, D, n_experts, k, block, stages);
  return static_cast<int>(cudaGetLastError());
}
