// Snapshot-probing PoRC block engines for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   porc_snapshot_kernel    <- repro/kernels/porc_snapshot.py::porc_snapshot
//                              (body _snapshot_kernel)
//   porc_multisource_kernel <- repro/kernels/porc_snapshot.py::
//                              porc_multisource_scan, policy-free branch
//                              (body _multisource_kernel)
//   porc_multisource_hh_kernel <- the same function's HHPolicy branch
//                              (_multisource_kernel with a policy)
// and computes, bit for bit, the plain torch engines
// repro_torch/kernels/ref.py::ref_porc_snapshot / _porc_multisource_scan.
//
// What bounds it. The work is a chain of blocks: block b routes against
// the loads that block b-1 left, so the blocks run in order. Per block a
// key hashes a few salts, reads a few loads and adds one. The least time
// the card could take is the bytes the function must move -- the keys
// read once and the assignments written once, 8 bytes per message --
// over 3.35 TB/s; in practice the chain of dependent blocks sets the
// pace: a few barriers and shared-memory round trips per block.
//
// Design. One persistent CTA walks the blocks in order, because each
// block depends on the previous one. The load vector (and, multisource,
// the merged base and the S delta lanes) stays in dynamic shared memory
// for the whole stream while it fits, and in the output buffers in
// global memory (read through L2 with __ldcg) above that. One thread per
// key of the block, looping when the block has more keys than the CTA
// threads; the salted candidate chain is hashed in the kernel, as the
// Pallas kernel fuses it. The fallback argmin of the snapshot (lowest
// index on ties) is taken before any add and only when some key of the
// block exhausted its chain. Adds are atomicAdd on the load, which is
// exact: the counts are integers below 2^24.
//
// Numerics. The capacity is evaluated as the reference compiles it:
// (1+eps)*x/n folds to x*K with K = f32(1+eps)*f32(1/n), computed once on
// the host. Every float operation is an explicit round-to-nearest
// intrinsic so that nvcc cannot contract it into an FMA; build without
// --use_fast_math. Mass and load sums are integer-valued f32, exact in
// any order only while the stream stays below 2^24 messages.
//
// C interface (bound with ctypes): each launcher returns the
// cudaError_t of the launch, 0 on success.

#include "routing.cuh"

namespace {

// ---------------------------------------------------------------------------
// Single source: ref_porc_snapshot
// ---------------------------------------------------------------------------

template <bool kSmem>
__global__ void porc_snapshot_kernel(const int* __restrict__ keys,
                                     const float* __restrict__ load0,
                                     const float* __restrict__ m0_ptr,
                                     int* __restrict__ assign,
                                     float* __restrict__ load_out,
                                     int n_blocks, int block, int n_bins,
                                     int chunk, float cap_scale) {
  extern __shared__ float smem[];
  float* load = kSmem ? smem : load_out;
  for (int c = threadIdx.x; c < n_bins; c += blockDim.x) load[c] = load0[c];
  __syncthreads();

  const float m0 = *m0_ptr;
  const int max_probes = 4 * n_bins;
  // block=1 walks the whole chain of Alg. 1 (the sequential oracle);
  // block>1 probes the first `chunk` salts
  const int budget = block == 1 ? max_probes : min(chunk, max_probes);
  const float fblock = static_cast<float>(block);

  for (int b = 0; b < n_blocks; ++b) {
    // cap = (m0 + (b+1)*block) * K, the reference's f32 order
    const float mt =
        __fadd_rn(m0, __fmul_rn(__fadd_rn(static_cast<float>(b), 1.0f), fblock));
    const float cap = __fmul_rn(mt, cap_scale);
    const int base_i = b * block;
    int miss = 0;
    for (int k = threadIdx.x; k < block; k += blockDim.x) {
      const uint32_t key = static_cast<uint32_t>(keys[base_i + k]);
      int pick = -1;
      for (int s = 1; s <= budget; ++s) {
        const int c = hash_to_bin(key, static_cast<uint32_t>(s),
                                  static_cast<uint32_t>(n_bins));
        if (rd<kSmem>(load + c) < cap) {
          pick = c;
          break;
        }
      }
      assign[base_i + k] = pick;
      miss |= pick < 0;
    }
    // barrier: every key has read the snapshot before any add
    if (__syncthreads_or(miss)) {
      const int amin = block_argmin<kSmem>(load, n_bins);
      for (int k = threadIdx.x; k < block; k += blockDim.x)
        if (assign[base_i + k] < 0) assign[base_i + k] = amin;
    }
    for (int k = threadIdx.x; k < block; k += blockDim.x)
      atomicAdd(load + assign[base_i + k], 1.0f);
    __syncthreads();
  }
  if (kSmem)
    for (int c = threadIdx.x; c < n_bins; c += blockDim.x)
      load_out[c] = load[c];
}

// ---------------------------------------------------------------------------
// Multi-source: ref._porc_multisource_scan, policy-free
// ---------------------------------------------------------------------------
//
// keys is the round-robin-interleaved stream: message i belongs to
// source i % S, and step b covers keys[b*S*block, (b+1)*S*block). Thread
// items walk that range in stream order (coalesced): item j of step b is
// source j % S; assignments are written in stream order, so no
// transpose is needed on either side.

template <bool kSmem>
__global__ void porc_multisource_kernel(
    const int* __restrict__ keys, const float* __restrict__ base0,
    const float* __restrict__ delta0, const int* __restrict__ ticks0_ptr,
    int* __restrict__ assign, float* __restrict__ base_out,
    float* __restrict__ delta_out, int* __restrict__ ticks_out, int n_steps,
    int n_sources, int block, int n_bins, int chunk, int sync_every,
    float cap_scale, float lookahead) {
  extern __shared__ float smem[];
  const int S = n_sources;
  float* cap = smem;                                   // [S]
  int* need = reinterpret_cast<int*>(smem + S);        // [S] fallback flag
  int* amin = need + S;                                // [S] fallback bin
  float* base = kSmem ? smem + 3 * S : base_out;       // [n]
  float* delta = kSmem ? base + n_bins : delta_out;    // [S, n]
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;

  for (int c = threadIdx.x; c < n_bins; c += blockDim.x) base[c] = base0[c];
  for (int c = threadIdx.x; c < S * n_bins; c += blockDim.x)
    delta[c] = delta0[c];
  __syncthreads();

  const int ticks0 = *ticks0_ptr;
  const int max_probes = 4 * n_bins;
  const int budget = block == 1 ? max_probes : min(chunk, max_probes);
  const int per_step = S * block;

  for (int b = 0; b < n_steps; ++b) {
    // 1. per-source local-view mass and capacity
    const float base_mass = block_sum<kSmem>(base, n_bins);
    for (int s = warp; s < S; s += n_warps) {
      float acc = 0.0f;
      for (int c = lane; c < n_bins; c += kWarp)
        acc = __fadd_rn(acc, rd<kSmem>(delta + s * n_bins + c));
      acc = warp_sum(acc);
      if (lane == 0) {
        const float mass = __fadd_rn(base_mass, acc);
        cap[s] = __fmul_rn(__fadd_rn(mass, lookahead), cap_scale);
        need[s] = 0;
      }
    }
    __syncthreads();

    // 2. every (source, key) resolves against base + delta[s]
    const int base_i = b * per_step;
    for (int j = threadIdx.x; j < per_step; j += blockDim.x) {
      const int s = j % S;
      const uint32_t key = static_cast<uint32_t>(keys[base_i + j]);
      const float* d = delta + s * n_bins;
      const float cs = cap[s];
      int pick = -1;
      for (int t = 1; t <= budget; ++t) {
        const int c = hash_to_bin(key, static_cast<uint32_t>(t),
                                  static_cast<uint32_t>(n_bins));
        if (__fadd_rn(rd<kSmem>(base + c), rd<kSmem>(d + c)) < cs) {
          pick = c;
          break;
        }
      }
      assign[base_i + j] = pick;
      if (pick < 0) need[s] = 1;
    }
    __syncthreads();

    // 3. each source's own fallback: argmin of its view, lowest index
    for (int s = warp; s < S; s += n_warps) {
      if (!need[s]) continue;
      const float* d = delta + s * n_bins;
      float v = INFINITY;
      int idx = 0x7FFFFFFF;
      for (int c = lane; c < n_bins; c += kWarp)
        argmin_merge(v, idx,
                     __fadd_rn(rd<kSmem>(base + c), rd<kSmem>(d + c)), c);
      warp_argmin(v, idx);
      if (lane == 0) amin[s] = idx;
    }
    __syncthreads();

    // 4. add into the source's delta lane
    for (int j = threadIdx.x; j < per_step; j += blockDim.x) {
      const int s = j % S;
      int a = assign[base_i + j];
      if (a < 0) {
        a = amin[s];
        assign[base_i + j] = a;
      }
      atomicAdd(delta + s * n_bins + a, 1.0f);
    }
    __syncthreads();

    // 5. piggyback merge on the sync phase carried in ticks
    if ((ticks0 + b + 1) % sync_every == 0) {
      for (int c = threadIdx.x; c < n_bins; c += blockDim.x) {
        float acc = 0.0f;
        for (int s = 0; s < S; ++s) {
          acc = __fadd_rn(acc, rd<kSmem>(delta + s * n_bins + c));
          delta[s * n_bins + c] = 0.0f;
        }
        base[c] = __fadd_rn(rd<kSmem>(base + c), acc);
      }
      __syncthreads();
    }
  }

  if (kSmem) {
    for (int c = threadIdx.x; c < n_bins; c += blockDim.x)
      base_out[c] = base[c];
    for (int c = threadIdx.x; c < S * n_bins; c += blockDim.x)
      delta_out[c] = delta[c];
  }
  if (threadIdx.x == 0) *ticks_out = (ticks0 + n_steps) % sync_every;
}

// ---------------------------------------------------------------------------
// Multi-source with an HHPolicy: ref._porc_multisource_scan, policy branch
// ---------------------------------------------------------------------------
//
// Per step, on top of the policy-free kernel: each (source, key) item
// estimates its key's count on the source's sketch view skb + skd[s]
// (min over the rows), turns it into a probe budget (hh_budgets), and
// walks the first min(budget, C) salted candidates of its chain in the
// rotated order of its in-block duplicate rank, stopping at the first bin
// below the cap. A key that finds none takes the least-loaded of its own
// candidates (score load + rotated position), or, when its budget is
// beyond the chain, the full choice set: the argmin of the source's view,
// or -- spread fallback -- the r-th bin of the view's stable load order,
// r counting such keys in block order. Then the block's keys go into the
// source's sketch lane, and the lanes merge with the loads.
//
// The sketch lanes ([D, W] and [S, D, W], 64 KB + S * 64 KB at the
// defaults) do not fit in shared memory beside the views: they live in
// the output buffers and are read through L2. The stable load order is a
// bitonic sort of (sortable float bits, index) pairs in a global scratch
// buffer, built only in a step where some key of that source needs it.
// Sketch counts are integer-valued below 2^24 and every add is the same
// 1.0, so the atomics give one result in any order; lanes merge in index
// order 0..S-1, as the plain engine adds them.

constexpr uint32_t kSketchSalt0 = 0x5EEDC0DEu;

struct HHParams {
  int depth, width, chain, d_tail, ceiling, rotate, spread, sort_n;
  float hot_fraction, need_scale;
};

template <bool kSmem>
__global__ void porc_multisource_hh_kernel(
    const int* __restrict__ keys, const float* __restrict__ base0,
    const float* __restrict__ delta0, const int* __restrict__ ticks0_ptr,
    const float* __restrict__ skb0, const float* __restrict__ skd0,
    int* __restrict__ assign, float* __restrict__ base_out,
    float* __restrict__ delta_out, int* __restrict__ ticks_out,
    float* __restrict__ skb, float* __restrict__ skd,
    int* __restrict__ flags, uint64_t* __restrict__ order, int n_steps,
    int n_sources, int block, int n_bins, int sync_every, float cap_scale,
    float lookahead, HHParams hp) {
  extern __shared__ float smem[];
  const int S = n_sources;
  float* cap = smem;                                   // [S]
  float* mass = smem + S;                              // [S]
  int* need = reinterpret_cast<int*>(smem + 2 * S);    // [S] argmin flag
  int* sneed = need + S;                               // [S] spread flag
  int* amin = sneed + S;                               // [S] argmin bin
  float* base = kSmem ? smem + 5 * S : base_out;       // [n]
  float* delta = kSmem ? base + n_bins : delta_out;    // [S, n]
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;
  const int D = hp.depth, W = hp.width, C = hp.chain;
  const int DW = D * W;

  for (int c = threadIdx.x; c < n_bins; c += blockDim.x) base[c] = base0[c];
  for (int c = threadIdx.x; c < S * n_bins; c += blockDim.x)
    delta[c] = delta0[c];
  for (int c = threadIdx.x; c < DW; c += blockDim.x) skb[c] = skb0[c];
  for (int c = threadIdx.x; c < S * DW; c += blockDim.x) skd[c] = skd0[c];
  __syncthreads();

  const int ticks0 = *ticks0_ptr;
  const int per_step = S * block;

  for (int b = 0; b < n_steps; ++b) {
    // 1. per-source local-view mass and capacity
    const float base_mass = block_sum<kSmem>(base, n_bins);
    for (int s = warp; s < S; s += n_warps) {
      float acc = 0.0f;
      for (int c = lane; c < n_bins; c += kWarp)
        acc = __fadd_rn(acc, rd<kSmem>(delta + s * n_bins + c));
      acc = warp_sum(acc);
      if (lane == 0) {
        const float m = __fadd_rn(base_mass, acc);
        mass[s] = m;
        cap[s] = __fmul_rn(__fadd_rn(m, lookahead), cap_scale);
        need[s] = 0;
        sneed[s] = 0;
      }
    }
    __syncthreads();

    // 2. every (source, key): sketch estimate, budget, budget-masked
    //    first-fit in rotated order; candidate-min fallback inline
    const int base_i = b * per_step;
    for (int j = threadIdx.x; j < per_step; j += blockDim.x) {
      const int s = j % S, k = j / S;
      const int key_i = keys[base_i + j];
      const uint32_t key = static_cast<uint32_t>(key_i);
      const float* d = delta + s * n_bins;
      const float* lane_d = skd + static_cast<size_t>(s) * DW;
      float est = INFINITY;
      for (int r = 0; r < D; ++r) {
        const int col = hash_to_bin(key, kSketchSalt0 + r,
                                    static_cast<uint32_t>(W));
        est = fminf(est, __fadd_rn(__ldcg(skb + r * W + col),
                                   __ldcg(lane_d + r * W + col)));
      }
      // hh_budgets, in the reference's compiled order
      const float m = fmaxf(mass[s], 1.0f);
      int bud = hp.d_tail;
      if (est >= __fmul_rn(m, hp.hot_fraction)) {
        const float want = fminf(
            ceilf(__fmul_rn(__fdiv_rn(est, m), hp.need_scale)),
            static_cast<float>(hp.ceiling));
        bud = min(max(static_cast<int>(want) + hp.d_tail, hp.d_tail + 1),
                  hp.ceiling);
      }
      const int window = min(bud, C);
      int offset = 0;
      if (hp.rotate && window > 0) {
        int dup = 0, count = 0;
        for (int kk = 0; kk < block; ++kk) {
          if (__ldg(keys + base_i + kk * S + s) == key_i) {
            ++count;
            dup += kk < k;
          }
        }
        offset = static_cast<int>(static_cast<long long>(dup) * window /
                                  max(count, 1));
      }
      const float cs = cap[s];
      // candidate-min fallback: least score, lowest chain index on ties
      int pick = -1, best_c = -1, best_i = 0x7FFFFFFF;
      float best_v = INFINITY;
      for (int p = 0; p < window; ++p) {
        int idx = offset + p;
        if (idx >= window) idx -= window;
        const int c = hash_to_bin(key, static_cast<uint32_t>(idx + 1),
                                  static_cast<uint32_t>(n_bins));
        const float v = __fadd_rn(rd<kSmem>(base + c), rd<kSmem>(d + c));
        if (v < cs) {
          pick = c;
          break;
        }
        const float score = hp.rotate ? __fadd_rn(v, static_cast<float>(p))
                                      : v;
        if (score < best_v || (score == best_v && idx < best_i)) {
          best_v = score;
          best_i = idx;
          best_c = c;
        }
      }
      int flag = 0;
      if (pick < 0) {
        if (bud > C) {
          flag = 1;  // the full choice set: resolved in pass 3
          if (hp.spread) sneed[s] = 1;
          else need[s] = 1;
        } else {
          // an empty window scores every candidate inf: index 0 wins
          pick = best_c >= 0 ? best_c
                             : hash_to_bin(key, 1u,
                                           static_cast<uint32_t>(n_bins));
        }
      }
      assign[base_i + j] = pick;
      if (hp.spread) flags[j] = flag;
    }
    __syncthreads();

    // 3a. argmin of the view for the sources that need it
    for (int s = warp; s < S; s += n_warps) {
      if (!need[s]) continue;
      const float* d = delta + s * n_bins;
      float v = INFINITY;
      int idx = 0x7FFFFFFF;
      for (int c = lane; c < n_bins; c += kWarp)
        argmin_merge(v, idx,
                     __fadd_rn(rd<kSmem>(base + c), rd<kSmem>(d + c)), c);
      warp_argmin(v, idx);
      if (lane == 0) amin[s] = idx;
    }
    // 3b. spread fallback: the r-th key of a source that needs the full
    //     set takes the (r mod n)-th bin of its view's stable load order
    if (hp.spread) {
      for (int s = 0; s < S; ++s) {
        if (!sneed[s]) continue;  // uniform: read after a barrier
        const float* d = delta + s * n_bins;
        stable_order(
            [&](int i) {
              return __fadd_rn(rd<kSmem>(base + i), rd<kSmem>(d + i));
            },
            n_bins, order, hp.sort_n);
        for (int k = threadIdx.x; k < block; k += blockDim.x) {
          const int j = k * S + s;
          if (!flags[j]) continue;
          int r = 0;
          for (int kk = 0; kk < k; ++kk) r += flags[kk * S + s];
          assign[base_i + j] = static_cast<int>(
              static_cast<uint32_t>(__ldcg(order + r % n_bins)));
        }
        __syncthreads();
      }
    }
    __syncthreads();

    // 4. add into the source's delta lane and its sketch lane
    for (int j = threadIdx.x; j < per_step; j += blockDim.x) {
      const int s = j % S;
      int a = assign[base_i + j];
      if (a < 0) {
        a = amin[s];
        assign[base_i + j] = a;
      }
      atomicAdd(delta + s * n_bins + a, 1.0f);
      const uint32_t key = static_cast<uint32_t>(keys[base_i + j]);
      float* lane_d = skd + static_cast<size_t>(s) * DW;
      for (int r = 0; r < D; ++r)
        atomicAdd(lane_d + r * W +
                      hash_to_bin(key, kSketchSalt0 + r,
                                  static_cast<uint32_t>(W)),
                  1.0f);
    }
    __syncthreads();

    // 5. piggyback merge of loads and sketch lanes, lanes in index order
    if ((ticks0 + b + 1) % sync_every == 0) {
      for (int c = threadIdx.x; c < n_bins; c += blockDim.x) {
        float acc = 0.0f;
        for (int s = 0; s < S; ++s) {
          acc = __fadd_rn(acc, rd<kSmem>(delta + s * n_bins + c));
          delta[s * n_bins + c] = 0.0f;
        }
        base[c] = __fadd_rn(rd<kSmem>(base + c), acc);
      }
      for (int c = threadIdx.x; c < DW; c += blockDim.x) {
        float acc = __ldcg(skd + c);
        skd[c] = 0.0f;
        for (int s = 1; s < S; ++s) {
          acc = __fadd_rn(acc, __ldcg(skd + static_cast<size_t>(s) * DW + c));
          skd[static_cast<size_t>(s) * DW + c] = 0.0f;
        }
        skb[c] = __fadd_rn(__ldcg(skb + c), acc);
      }
      __syncthreads();
    }
  }

  if (kSmem) {
    for (int c = threadIdx.x; c < n_bins; c += blockDim.x)
      base_out[c] = base[c];
    for (int c = threadIdx.x; c < S * n_bins; c += blockDim.x)
      delta_out[c] = delta[c];
  }
  if (threadIdx.x == 0) *ticks_out = (ticks0 + n_steps) % sync_every;
}

}  // namespace

extern "C" int porc_snapshot_launch(const void* keys, const void* load0,
                                    const void* m0, void* assign,
                                    void* load_out, int n_blocks, int block,
                                    int n_bins, int chunk, float cap_scale,
                                    void* stream) {
  const size_t bytes = sizeof(float) * static_cast<size_t>(n_bins);
  const int threads = 256;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bytes <= kSmemLimit) {
    err = set_smem(porc_snapshot_kernel<true>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    porc_snapshot_kernel<true><<<1, threads, bytes, st>>>(
        static_cast<const int*>(keys), static_cast<const float*>(load0),
        static_cast<const float*>(m0), static_cast<int*>(assign),
        static_cast<float*>(load_out), n_blocks, block, n_bins, chunk,
        cap_scale);
  } else {
    porc_snapshot_kernel<false><<<1, threads, 0, st>>>(
        static_cast<const int*>(keys), static_cast<const float*>(load0),
        static_cast<const float*>(m0), static_cast<int*>(assign),
        static_cast<float*>(load_out), n_blocks, block, n_bins, chunk,
        cap_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int porc_multisource_launch(
    const void* keys, const void* base0, const void* delta0,
    const void* ticks0, void* assign, void* base_out, void* delta_out,
    void* ticks_out, int n_steps, int n_sources, int block, int n_bins,
    int chunk, int sync_every, float cap_scale, float lookahead,
    void* stream) {
  const size_t small = sizeof(float) * 3 * static_cast<size_t>(n_sources);
  const size_t state = sizeof(float) * (static_cast<size_t>(n_sources) + 1) *
                       static_cast<size_t>(n_bins);
  const int threads = 1024;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (small + state <= kSmemLimit) {
    err = set_smem(porc_multisource_kernel<true>, small + state);
    if (err != cudaSuccess) return static_cast<int>(err);
    porc_multisource_kernel<true><<<1, threads, small + state, st>>>(
        static_cast<const int*>(keys), static_cast<const float*>(base0),
        static_cast<const float*>(delta0), static_cast<const int*>(ticks0),
        static_cast<int*>(assign), static_cast<float*>(base_out),
        static_cast<float*>(delta_out), static_cast<int*>(ticks_out),
        n_steps, n_sources, block, n_bins, chunk, sync_every, cap_scale,
        lookahead);
  } else {
    err = set_smem(porc_multisource_kernel<false>, small);
    if (err != cudaSuccess) return static_cast<int>(err);
    porc_multisource_kernel<false><<<1, threads, small, st>>>(
        static_cast<const int*>(keys), static_cast<const float*>(base0),
        static_cast<const float*>(delta0), static_cast<const int*>(ticks0),
        static_cast<int*>(assign), static_cast<float*>(base_out),
        static_cast<float*>(delta_out), static_cast<int*>(ticks_out),
        n_steps, n_sources, block, n_bins, chunk, sync_every, cap_scale,
        lookahead);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int porc_multisource_hh_launch(
    const void* keys, const void* base0, const void* delta0,
    const void* ticks0, const void* skb0, const void* skd0, void* assign,
    void* base_out, void* delta_out, void* ticks_out, void* skb_out,
    void* skd_out, void* flags, void* order, int n_steps, int n_sources,
    int block, int n_bins, int sync_every, int depth, int width, int chain,
    int d_tail, int ceiling, int rotate, int spread, int sort_n,
    float cap_scale, float lookahead, float hot_fraction, float need_scale,
    void* stream) {
  const size_t small = sizeof(float) * 5 * static_cast<size_t>(n_sources);
  const size_t state = sizeof(float) * (static_cast<size_t>(n_sources) + 1) *
                       static_cast<size_t>(n_bins);
  const int threads = 1024;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const HHParams hp{depth,  width,  chain,        d_tail,    ceiling,
                    rotate, spread, sort_n, hot_fraction, need_scale};
  const bool in_smem = small + state <= kSmemLimit;
  auto kernel = in_smem ? porc_multisource_hh_kernel<true>
                        : porc_multisource_hh_kernel<false>;
  const size_t bytes = in_smem ? small + state : small;
  cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, threads, bytes, st>>>(
      static_cast<const int*>(keys), static_cast<const float*>(base0),
      static_cast<const float*>(delta0), static_cast<const int*>(ticks0),
      static_cast<const float*>(skb0), static_cast<const float*>(skd0),
      static_cast<int*>(assign), static_cast<float*>(base_out),
      static_cast<float*>(delta_out), static_cast<int*>(ticks_out),
      static_cast<float*>(skb_out), static_cast<float*>(skd_out),
      static_cast<int*>(flags), static_cast<uint64_t*>(order), n_steps,
      n_sources, block, n_bins, sync_every, cap_scale, lookahead, hp);
  return static_cast<int>(cudaGetLastError());
}
