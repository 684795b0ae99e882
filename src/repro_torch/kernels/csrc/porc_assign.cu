// Rank-sequential strict-cap PoRC (the block-synchronous Alg. 1) for
// Hopper (sm_90a).
//
// Replaces, in the JAX package:
//   porc_assign_kernel             <- repro/kernels/porc_assign.py::
//                                     porc_assign (body _porc_kernel)
//   porc_multisource_strict_kernel <- the strict branch of
//                                     repro/kernels/ref.py::
//                                     _porc_multisource_scan (vmapped
//                                     _porc_block, jnp; no Pallas kernel)
// and computes, bit for bit, the plain torch engines
// repro_torch/kernels/ref.py::ref_porc_assign and
// _porc_multisource_scan(engine="strict").
//
// Semantics of one block (strict_step). Per rank r, while r < d and some
// key of the block is unassigned: every unassigned key bids c = H(key,
// r+1); its position is the number of earlier unassigned keys of its
// block that bid the same bin at this rank, accepted or not; it is
// accepted iff load[c] + position < cap, with load read before any add
// of this rank; then the accepted keys add 1 to their bins. Keys still
// unassigned after d ranks take, in block order, order[leftpos mod n]:
// order is the stable ascending order of the load after the ranks,
// leftpos the number of earlier leftovers of the block.
//
// What bounds it. Each block depends on the loads the one before left,
// and each rank on the adds of the rank before, so the work is a chain of
// ranks. The least time the card could take is set by the bytes the
// function must move (keys in, assignments out, the loads or views in and
// out) over 3.35 TB/s; in practice the chain sets the pace: two barriers
// per rank, and the position scan.
//
// Design. One persistent CTA walks the blocks (multisource: the steps of S
// source blocks) in order. The load (multisource: the merged base and the
// S delta lanes) stays in dynamic shared memory while it fits and in the
// output buffers in global memory, read through L2, above that. The bids
// of a rank go to a shared array (global scratch when a step's keys do
// not fit); a key's position is a plain scan over the bids of the keys
// before it in its block, O(block) per key and rank, which keeps the
// block order that atomics alone would lose. A rank takes two barriers:
// after the bids, and after the accept decisions (__syncthreads_or, which
// also tells whether a key is left); the adds of a rank land before the
// next rank's bids are read. Adds are atomicAdd of 1.0 on integer-valued
// f32, exact in any order below 2^24. Leftovers are rare (after 4*n ranks
// by default): the stable order is a bitonic sort of (sortable float bits,
// index) pairs, taken only for a source that has one.
//
// Numerics. The cap is evaluated as the reference compiles it: (1+eps)*x/n
// folds to x*K with K = f32(1+eps)*f32(1/n), computed once on the host.
// The position enters the compare as an f32, exact below 2^24.
//
// C interface (bound with ctypes): each launcher returns the cudaError_t
// of the launch, 0 on success.

#include "routing.cuh"

namespace {

// The running load of a single source.
template <bool kSmem>
struct LoadView {
  float* load;
  __device__ float get(int, int c) const { return rd<kSmem>(load + c); }
  __device__ void add(int, int c) const { atomicAdd(load + c, 1.0f); }
};

// Source s's local view base + delta[s]; its adds go to its delta lane.
template <bool kSmem>
struct LaneView {
  const float* base;
  float* delta;
  int n_bins;
  __device__ float get(int s, int c) const {
    return __fadd_rn(rd<kSmem>(base + c), rd<kSmem>(delta + s * n_bins + c));
  }
  __device__ void add(int s, int c) const {
    atomicAdd(delta + s * n_bins + c, 1.0f);
  }
};

// Routes one step: S source blocks of B keys, item j = k*S + s (key k of
// source s, the stream order of the interleave). Writes assign[j].
// cap[s] must be set and need[s] zero before the call; bid holds S*B ints.
// Every thread of the CTA must call it; it ends with a barrier.
template <typename View>
__device__ void strict_step(const int* __restrict__ keys,
                            int* __restrict__ assign, int S, int B,
                            int n_bins, int d, const float* cap, View view,
                            int* bid, int* need, uint64_t* order,
                            int sort_n) {
  const int N = S * B;
  for (int j = threadIdx.x; j < N; j += blockDim.x) assign[j] = -1;
  int left = N > 0;
  for (int r = 0; r < d && left; ++r) {
    const uint32_t salt = static_cast<uint32_t>(r + 1);
    for (int j = threadIdx.x; j < N; j += blockDim.x)
      bid[j] = assign[j] < 0
                   ? hash_to_bin(static_cast<uint32_t>(keys[j]), salt,
                                 static_cast<uint32_t>(n_bins))
                   : -1;
    __syncthreads();  // bids written; the previous rank's adds landed
    int rem = 0;
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      const int c = bid[j];
      if (c < 0) continue;
      const int s = j % S;
      int pos = 0;
      for (int jj = s; jj < j; jj += S) pos += bid[jj] == c;
      if (__fadd_rn(view.get(s, c), static_cast<float>(pos)) < cap[s])
        assign[j] = c;
      else
        rem = 1;
    }
    left = __syncthreads_or(rem);  // every load of this rank was read
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      const int c = bid[j];
      if (c >= 0 && assign[j] == c) view.add(j % S, c);
    }
  }
  if (left) {
    // leftovers: flag them, then per source the stable load order
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      const int miss = assign[j] < 0;
      bid[j] = miss;
      if (miss) need[j % S] = 1;
    }
    __syncthreads();
    for (int s = 0; s < S; ++s) {
      if (!need[s]) continue;  // uniform: read after a barrier
      stable_order([&](int i) { return view.get(s, i); }, n_bins, order,
                   sort_n);
      for (int k = threadIdx.x; k < B; k += blockDim.x) {
        const int j = k * S + s;
        if (!bid[j]) continue;
        int leftpos = 0;
        for (int jj = s; jj < j; jj += S) leftpos += bid[jj];
        const int a = static_cast<int>(
            static_cast<uint32_t>(__ldcg(order + leftpos % n_bins)));
        assign[j] = a;
        view.add(s, a);
      }
      __syncthreads();  // order is reused by the next source
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Single source: ref_porc_assign
// ---------------------------------------------------------------------------

template <bool kSmem>
__global__ void porc_assign_kernel(
    const int* __restrict__ keys, const float* __restrict__ load0,
    const float* __restrict__ m0_ptr, int* __restrict__ assign,
    float* __restrict__ load_out, int* __restrict__ bid_scratch,
    uint64_t* __restrict__ order, int n_blocks, int block, int n_bins, int d,
    int sort_n, int bid_in_smem, float cap_scale) {
  extern __shared__ float smem[];
  float* cap = smem;                                    // [1]
  int* need = reinterpret_cast<int*>(smem + 1);         // [1]
  int* bid = bid_in_smem ? need + 1 : bid_scratch;      // [block]
  float* load = kSmem ? smem + 2 + block : load_out;    // [n]
  for (int c = threadIdx.x; c < n_bins; c += blockDim.x) load[c] = load0[c];

  const float m0 = *m0_ptr;
  const float fblock = static_cast<float>(block);
  const LoadView<kSmem> view{load};
  for (int b = 0; b < n_blocks; ++b) {
    if (threadIdx.x == 0) {
      // cap = (m0 + (b+1)*block) * K, the reference's f32 order
      const float mt = __fadd_rn(
          m0, __fmul_rn(__fadd_rn(static_cast<float>(b), 1.0f), fblock));
      *cap = __fmul_rn(mt, cap_scale);
      *need = 0;
    }
    __syncthreads();
    const size_t off = static_cast<size_t>(b) * block;
    strict_step(keys + off, assign + off, 1, block, n_bins, d, cap, view,
                bid, need, order, sort_n);
  }
  if (kSmem)
    for (int c = threadIdx.x; c < n_bins; c += blockDim.x)
      load_out[c] = load[c];
}

// ---------------------------------------------------------------------------
// Multi-source: ref._porc_multisource_scan(engine="strict")
// ---------------------------------------------------------------------------
//
// The framing of porc_multisource_kernel: per step, each source's cap
// from the mass of its local view plus block/S, the step's S blocks
// routed against base + delta[s] (strict_step, all sources at once), a
// merge of the lanes into the base every sync_every steps with the phase
// carried in ticks.

template <bool kSmem>
__global__ void porc_multisource_strict_kernel(
    const int* __restrict__ keys, const float* __restrict__ base0,
    const float* __restrict__ delta0, const int* __restrict__ ticks0_ptr,
    int* __restrict__ assign, float* __restrict__ base_out,
    float* __restrict__ delta_out, int* __restrict__ ticks_out,
    int* __restrict__ bid_scratch, uint64_t* __restrict__ order, int n_steps,
    int n_sources, int block, int n_bins, int sync_every, int sort_n,
    int bid_in_smem, float cap_scale, float lookahead) {
  extern __shared__ float smem[];
  const int S = n_sources;
  const int per_step = S * block;
  float* cap = smem;                                        // [S]
  int* need = reinterpret_cast<int*>(smem + S);             // [S]
  int* bid = bid_in_smem ? need + S : bid_scratch;          // [S*block]
  float* base = kSmem ? smem + 2 * S + per_step : base_out; // [n]
  float* delta = kSmem ? base + n_bins : delta_out;         // [S, n]
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;

  for (int c = threadIdx.x; c < n_bins; c += blockDim.x) base[c] = base0[c];
  for (int c = threadIdx.x; c < S * n_bins; c += blockDim.x)
    delta[c] = delta0[c];
  __syncthreads();

  const int ticks0 = *ticks0_ptr;
  const LaneView<kSmem> view{base, delta, n_bins};
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

    // 2. the step's S blocks, rank by rank, against base + delta[s]
    const size_t off = static_cast<size_t>(b) * per_step;
    strict_step(keys + off, assign + off, S, block, n_bins, 4 * n_bins, cap,
                view, bid, need, order, sort_n);

    // 3. piggyback merge on the sync phase carried in ticks
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

// Dynamic shared memory of a launch: the small per-source arrays, the bids
// while they fit, and the load state while it fits beside the bids.
struct Layout {
  size_t bytes;
  bool bid_in_smem, state_in_smem;
};

Layout layout(size_t small, size_t bids, size_t state) {
  if (small + bids + state <= kSmemLimit) return {small + bids + state, true,
                                                  true};
  if (small + bids <= kSmemLimit) return {small + bids, true, false};
  return {small, false, false};
}

// Threads of a CTA: one per key of a step, in [128, 1024].
int threads_for(int items) {
  const int t = (items + kWarp - 1) / kWarp * kWarp;
  return t < 128 ? 128 : (t > 1024 ? 1024 : t);
}

}  // namespace

extern "C" int porc_assign_launch(const void* keys, const void* load0,
                                  const void* m0, void* assign,
                                  void* load_out, void* bid_scratch,
                                  void* order, int n_blocks, int block,
                                  int n_bins, int d, int sort_n,
                                  float cap_scale, void* stream) {
  const Layout lay =
      layout(2 * sizeof(float), sizeof(int) * static_cast<size_t>(block),
             sizeof(float) * static_cast<size_t>(n_bins));
  auto kernel = lay.state_in_smem ? porc_assign_kernel<true>
                                  : porc_assign_kernel<false>;
  cudaError_t err = set_smem(kernel, lay.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, threads_for(block), lay.bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const float*>(load0),
      static_cast<const float*>(m0), static_cast<int*>(assign),
      static_cast<float*>(load_out), static_cast<int*>(bid_scratch),
      static_cast<uint64_t*>(order), n_blocks, block, n_bins, d, sort_n,
      lay.bid_in_smem ? 1 : 0, cap_scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int porc_multisource_strict_launch(
    const void* keys, const void* base0, const void* delta0,
    const void* ticks0, void* assign, void* base_out, void* delta_out,
    void* ticks_out, void* bid_scratch, void* order, int n_steps,
    int n_sources, int block, int n_bins, int sync_every, int sort_n,
    float cap_scale, float lookahead, void* stream) {
  const size_t per_step =
      static_cast<size_t>(n_sources) * static_cast<size_t>(block);
  const Layout lay = layout(
      2 * sizeof(float) * static_cast<size_t>(n_sources),
      sizeof(int) * per_step,
      sizeof(float) * (static_cast<size_t>(n_sources) + 1) *
          static_cast<size_t>(n_bins));
  auto kernel = lay.state_in_smem ? porc_multisource_strict_kernel<true>
                                  : porc_multisource_strict_kernel<false>;
  cudaError_t err = set_smem(kernel, lay.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, 1024, lay.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const float*>(base0),
      static_cast<const float*>(delta0), static_cast<const int*>(ticks0),
      static_cast<int*>(assign), static_cast<float*>(base_out),
      static_cast<float*>(delta_out), static_cast<int*>(ticks_out),
      static_cast<int*>(bid_scratch), static_cast<uint64_t*>(order), n_steps,
      n_sources, block, n_bins, sync_every, sort_n, lay.bid_in_smem ? 1 : 0,
      cap_scale, lookahead);
  return static_cast<int>(cudaGetLastError());
}
