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
// Semantics of one block (route_block). Per rank r, while r < d and some
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
// out) over 3.35 TB/s; in practice the chain sets the pace, so the design
// shortens each link of it.
//
// Design.
// - One warp routes one source block, all its ranks, with no block
//   barrier: nothing couples the sources of a step while they route (a
//   source reads only base + delta[s] and adds only to delta[s]). The
//   multisource CTA's 32 warps take sources s = warp, warp + 32, ...; in
//   the single-source kernel warp 0 routes and the other warps wait at
//   one barrier per block, there for the leftover fallback. Each
//   source's load has one writer while it routes, so a group's add is a
//   plain store of the count it read plus its accepted keys, ordered by
//   __syncwarp.
// - While more than 32 keys bid, the warp walks a list of them (key
//   index, key, this rank's bin), in block order, 32 at a time; after
//   each rank a ballot/popc prefix packs the rejected keys into the front
//   of the same list, with the next rank's bin hashed while the load is
//   read. From 32 bidders on (most ranks: 32.68 ranks per block at phase
//   3's shape, most with a handful of keys), lane i keeps the i-th bidder
//   in registers, never packed again, with the bins of the next two
//   ranks hashed ahead: a rank is then a load read, a match, a ballot,
//   the adds and one __syncwarp.
// - Positions without a scan. Within 32 keys, __match_any_sync on the bin
//   gives each key's group; its position among the group's is
//   __popc(group & lanemask_lt). Across the earlier groups of 32, the
//   running load itself carries the prefix: a group adds its accepted
//   count to load[c] before the next 32 keys read it. That decides as
//   the reference does. Let load[c] be L before the rank and T the number
//   of positions p with L + p < cap. A key at position P_prev + p among
//   the bidders of c, P_prev of them in earlier groups of 32, reads
//   L + min(P_prev, T): if P_prev < T it compares L + P_prev + p, the
//   reference's L + position; else it reads L + T >= cap and is refused,
//   as the reference refuses position >= T. The sums are exact (integer
//   counts below 2^24), so the f32 compares agree bit for bit.
// - A stable sort of (bin, index) pairs (cub::BlockRadixSort) would give
//   the positions too, but with passes and block barriers at every rank;
//   the warp's list needs neither.
// - The list lives in dynamic shared memory while it fits beside the
//   small per-source arrays (16 bytes a key a warp), else in a global
//   scratch buffer; the load (multisource: the merged base and the S
//   delta lanes) in shared memory while it fits beside them, else in the
//   output buffers, read through L2.
// - Leftovers are rare (after 4*n ranks by default): the warp marks them
//   -1, and after a block barrier the CTA takes the stable order of the
//   source's load (a bitonic sort of (sortable float bits, index) pairs)
//   and warp 0 hands them out in block order with atomicAdd (integer-
//   valued f32, exact in any order below 2^24).
//
// Numerics. The cap is evaluated as the reference compiles it: (1+eps)*x/n
// folds to x*K with K = f32(1+eps)*f32(1/n), computed once on the host.
// The position enters the compare as an f32, exact below 2^24.
//
// C interface (bound with ctypes): each launcher returns the cudaError_t
// of the launch, 0 on success.

#include "routing.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

// The running load of a single source. A routing warp reads a bin's own
// count (``own``), compares its view (``view``: the count itself) and,
// as the load's one writer while it routes, stores the new count
// (``set``); ``add`` is the atomic add of the leftover fallback.
template <bool kSmem>
struct LoadView {
  float* load;
  __device__ float own(int, int c) const { return rd<kSmem>(load + c); }
  __device__ float view(int, int, float own) const { return own; }
  __device__ void set(int, int c, float x) const { load[c] = x; }
  __device__ float get(int, int c) const { return rd<kSmem>(load + c); }
  __device__ void add(int, int c, float v) const { atomicAdd(load + c, v); }
};

// Source s's local view base + delta[s]; its adds go to its delta lane.
template <bool kSmem>
struct LaneView {
  const float* base;
  float* delta;
  int n_bins;
  __device__ float own(int s, int c) const {
    return rd<kSmem>(delta + s * n_bins + c);
  }
  __device__ float view(int, int c, float own) const {
    return __fadd_rn(rd<kSmem>(base + c), own);
  }
  __device__ void set(int s, int c, float x) const {
    delta[s * n_bins + c] = x;
  }
  __device__ float get(int s, int c) const { return view(s, c, own(s, c)); }
  __device__ void add(int s, int c, float v) const {
    atomicAdd(delta + s * n_bins + c, v);
  }
};

// Routes source s's block of B keys (key k at keys[k*S + s], the stream
// order of the interleave) rank by rank, at most d ranks, with the calling
// warp alone; every lane of the warp must call it, and no other warp may
// touch source s's load meanwhile. While more than 32 keys bid, ``list``
// (B entries of this warp's own; x: key index, y: key, z: bin at this
// rank) holds them, packed after every rank; from 32 on, each lane keeps
// at most one bidder in registers, in block order, with the bins of the
// next two ranks hashed ahead. Writes assign[k*S + s]: the bin, or -1 for
// a key left after the ranks. Returns, on every lane, whether a key was
// left.
template <typename View>
__device__ bool route_block(const int* __restrict__ keys,
                            int* __restrict__ assign, int s, int S, int B,
                            int n_bins, int d, float cap, View view,
                            int4* list) {
  const int lane = threadIdx.x % kWarp;
  const unsigned lt = (1u << lane) - 1u;
  const uint32_t n = static_cast<uint32_t>(n_bins);
  int n_left = B;
  int r = 0;
  if (B > kWarp) {
#pragma unroll 4
    for (int k = lane; k < B; k += kWarp) {
      const int key = __ldg(keys + static_cast<size_t>(k) * S + s);
      list[k] = make_int4(k, key,
                          hash_to_bin(static_cast<uint32_t>(key), 1u, n), 0);
    }
    __syncwarp();
    for (; r < d && n_left > kWarp; ++r) {
      const uint32_t next_salt = static_cast<uint32_t>(r + 2);
      int kept = 0;
      for (int q = 0; q < n_left; q += kWarp) {  // n_left: warp-uniform
        const bool act = q + lane < n_left;
        const int4 e = act ? list[q + lane] : make_int4(0, 0, -1, 0);
        const int c = e.z;
        const float own = act ? view.own(s, c) : 0.0f;
        const float v = act ? view.view(s, c, own) : 0.0f;
        const unsigned grp = __match_any_sync(kFull, c);
        const int next =
            hash_to_bin(static_cast<uint32_t>(e.y), next_salt, n);
        const int pos = __popc(grp & lt);
        const bool ok =
            act && __fadd_rn(v, static_cast<float>(pos)) < cap;
        const unsigned oks = __ballot_sync(kFull, ok);
        const unsigned miss = __ballot_sync(kFull, act && !ok);
        __syncwarp();  // these 32 entries and loads are read
        if (ok) assign[static_cast<size_t>(e.x) * S + s] = c;
        if (act && (grp & lt) == 0) {  // the group's lowest lane
          const int n_ok = __popc(grp & oks);
          if (n_ok) view.set(s, c, __fadd_rn(own, static_cast<float>(n_ok)));
        }
        if (act && !ok)
          list[kept + __popc(miss & lt)] = make_int4(e.x, e.y, next, 0);
        kept += __popc(miss);
        __syncwarp();  // the adds and the packed entries land
      }
      n_left = kept;
    }
    if (n_left > kWarp) {  // the d ranks are spent
      for (int i = lane; i < n_left; i += kWarp)
        assign[static_cast<size_t>(list[i].x) * S + s] = -1;
      return true;
    }
  }
  // at most 32 bidders: lane i holds the i-th, no packing from here on
  bool act = lane < n_left;
  int k = lane, key = 0, c = -1;
  if (act) {
    if (B > kWarp) {
      const int4 e = list[lane];
      k = e.x;
      key = e.y;
      c = e.z;
    } else {
      key = __ldg(keys + static_cast<size_t>(lane) * S + s);
      c = hash_to_bin(static_cast<uint32_t>(key), 1u, n);
    }
  }
  int next = hash_to_bin(static_cast<uint32_t>(key),
                         static_cast<uint32_t>(r + 2), n);
  for (; r < d && n_left > 0; ++r) {
    const float own = act ? view.own(s, c) : 0.0f;
    const float v = act ? view.view(s, c, own) : 0.0f;
    const unsigned grp = __match_any_sync(kFull, act ? c : -1);
    const int after = hash_to_bin(static_cast<uint32_t>(key),
                                  static_cast<uint32_t>(r + 3), n);
    const int pos = __popc(grp & lt);
    const bool ok = act && __fadd_rn(v, static_cast<float>(pos)) < cap;
    const unsigned oks = __ballot_sync(kFull, ok);
    if (ok) assign[static_cast<size_t>(k) * S + s] = c;
    if (act && (grp & lt) == 0) {
      const int n_ok = __popc(grp & oks);
      if (n_ok) view.set(s, c, __fadd_rn(own, static_cast<float>(n_ok)));
    }
    act = act && !ok;
    n_left -= __popc(oks);
    c = next;
    next = after;
    __syncwarp();  // the adds land before the next rank reads
  }
  if (act) assign[static_cast<size_t>(k) * S + s] = -1;
  return n_left > 0;
}

// The leftover fallback of a step: for each source s with need[s], the
// keys still at -1 take, in block order, order[leftpos mod n]: order is
// the stable ascending order of the source's load after the ranks,
// leftpos the number of earlier leftovers of the block. Every thread of
// the CTA must call it, after a barrier that follows the routing; it ends
// with a barrier.
template <typename View>
__device__ void leftover_fallback(int* __restrict__ assign, int S, int B,
                                  int n_bins, View view, const int* need,
                                  uint64_t* order, int sort_n) {
  const int lane = threadIdx.x % kWarp;
  const unsigned lt = (1u << lane) - 1u;
  for (int s = 0; s < S; ++s) {
    if (!need[s]) continue;  // uniform: read after a barrier
    stable_order([&](int i) { return view.get(s, i); }, n_bins, order,
                 sort_n);
    if (threadIdx.x < kWarp) {
      int before = 0;
      for (int q = 0; q < B; q += kWarp) {
        const size_t j = static_cast<size_t>(q + lane) * S + s;
        const bool miss = q + lane < B && __ldcg(assign + j) < 0;
        const unsigned misses = __ballot_sync(kFull, miss);
        if (miss) {
          const int leftpos = before + __popc(misses & lt);
          const int a = static_cast<int>(
              static_cast<uint32_t>(__ldcg(order + leftpos % n_bins)));
          assign[j] = a;
          view.add(s, a, 1.0f);
        }
        before += __popc(misses);
      }
    }
    __syncthreads();  // order is reused by the next source
  }
}

// ---------------------------------------------------------------------------
// Single source: ref_porc_assign
// ---------------------------------------------------------------------------

constexpr int kAssignThreads = 256;   // warp 0 routes; all sort leftovers
constexpr int kStrictThreads = 1024;  // 32 routing warps
constexpr int kStrictWarps = kStrictThreads / kWarp;

template <bool kSmem>
__global__ void __launch_bounds__(kAssignThreads) porc_assign_kernel(
    const int* __restrict__ keys, const float* __restrict__ load0,
    const float* __restrict__ m0_ptr, int* __restrict__ assign,
    float* __restrict__ load_out, int* __restrict__ list_scratch,
    uint64_t* __restrict__ order, int n_blocks, int block, int n_bins, int d,
    int sort_n, int list_in_smem, float cap_scale) {
  // dynamic shared memory: the list (while it fits), the load (while it
  // fits beside it)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int need;
  int4* list = list_in_smem ? reinterpret_cast<int4*>(smem)
                            : reinterpret_cast<int4*>(list_scratch);
  float* load = kSmem ? reinterpret_cast<float*>(
                            smem + (list_in_smem ? 16 * block : 0))
                      : load_out;                           // [n]
  for (int c = threadIdx.x; c < n_bins; c += blockDim.x) load[c] = load0[c];
  __syncthreads();

  const float m0 = *m0_ptr;
  const float fblock = static_cast<float>(block);
  const LoadView<kSmem> view{load};
  for (int b = 0; b < n_blocks; ++b) {
    const size_t off = static_cast<size_t>(b) * block;
    int left = 0;
    if (threadIdx.x < kWarp) {
      // cap = (m0 + (b+1)*block) * K, the reference's f32 order
      const float mt = __fadd_rn(
          m0, __fmul_rn(__fadd_rn(static_cast<float>(b), 1.0f), fblock));
      left = route_block(keys + off, assign + off, 0, 1, block, n_bins, d,
                         __fmul_rn(mt, cap_scale), view, list);
      if (threadIdx.x == 0) need = left;
    }
    if (__syncthreads_or(left))
      leftover_fallback(assign + off, 1, block, n_bins, view, &need, order,
                        sort_n);
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
// routed against base + delta[s] (route_block, one warp a source), a
// merge of the lanes into the base every sync_every steps with the phase
// carried in ticks.

template <bool kSmem>
__global__ void __launch_bounds__(kStrictThreads)
    porc_multisource_strict_kernel(
        const int* __restrict__ keys, const float* __restrict__ base0,
        const float* __restrict__ delta0, const int* __restrict__ ticks0_ptr,
        int* __restrict__ assign, float* __restrict__ base_out,
        float* __restrict__ delta_out, int* __restrict__ ticks_out,
        int* __restrict__ list_scratch, uint64_t* __restrict__ order,
        int n_steps, int n_sources, int block, int n_bins, int sync_every,
        int sort_n, int list_in_smem, float cap_scale, float lookahead) {
  // dynamic shared memory: the routing warps' lists (while they fit), the
  // small per-source arrays, the load state (while it fits beside them)
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = n_sources;
  const int per_step = S * block;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;
  const size_t list_bytes =
      list_in_smem ? 16 * static_cast<size_t>(min(S, n_warps)) * block : 0;
  int4* list = (list_in_smem ? reinterpret_cast<int4*>(smem)
                             : reinterpret_cast<int4*>(list_scratch)) +
               static_cast<size_t>(warp) * block;       // this warp's
  float* cap = reinterpret_cast<float*>(smem + list_bytes);  // [S]
  int* need = reinterpret_cast<int*>(cap + S);              // [S]
  float* base = kSmem ? reinterpret_cast<float*>(need + S) : base_out;  // [n]
  float* delta = kSmem ? base + n_bins : delta_out;         // [S, n]

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

    // 2. the step's S blocks, one warp a source, against base + delta[s]
    const size_t off = static_cast<size_t>(b) * per_step;
    int left = 0;
    for (int s = warp; s < S; s += n_warps) {
      if (route_block(keys + off, assign + off, s, S, block, n_bins,
                      4 * n_bins, cap[s], view, list)) {
        left = 1;
        if (lane == 0) need[s] = 1;
      }
    }
    if (__syncthreads_or(left))
      leftover_fallback(assign + off, S, block, n_bins, view, need, order,
                        sort_n);

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

// Dynamic shared memory of a launch: the lists while they fit beside the
// small per-source arrays, and the load state while it fits beside both.
struct Layout {
  size_t bytes;
  bool list_in_smem, state_in_smem;
};

Layout layout(size_t small, size_t lists, size_t state) {
  if (small + lists + state <= kSmemLimit)
    return {small + lists + state, true, true};
  if (small + lists <= kSmemLimit) return {small + lists, true, false};
  return {small, false, false};
}

}  // namespace

extern "C" int porc_assign_launch(const void* keys, const void* load0,
                                  const void* m0, void* assign,
                                  void* load_out, void* list_scratch,
                                  void* order, int n_blocks, int block,
                                  int n_bins, int d, int sort_n,
                                  float cap_scale, void* stream) {
  const Layout lay = layout(0, 16 * static_cast<size_t>(block),
                            sizeof(float) * static_cast<size_t>(n_bins));
  auto kernel = lay.state_in_smem ? porc_assign_kernel<true>
                                  : porc_assign_kernel<false>;
  cudaError_t err = set_smem(kernel, lay.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, kAssignThreads, lay.bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const float*>(load0),
      static_cast<const float*>(m0), static_cast<int*>(assign),
      static_cast<float*>(load_out), static_cast<int*>(list_scratch),
      static_cast<uint64_t*>(order), n_blocks, block, n_bins, d, sort_n,
      lay.list_in_smem ? 1 : 0, cap_scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int porc_multisource_strict_launch(
    const void* keys, const void* base0, const void* delta0,
    const void* ticks0, void* assign, void* base_out, void* delta_out,
    void* ticks_out, void* list_scratch, void* order, int n_steps,
    int n_sources, int block, int n_bins, int sync_every, int sort_n,
    float cap_scale, float lookahead, void* stream) {
  const size_t S = static_cast<size_t>(n_sources);
  const size_t n_lists = S < kStrictWarps ? S : kStrictWarps;
  const Layout lay = layout(2 * sizeof(float) * S,
                            16 * n_lists * static_cast<size_t>(block),
                            sizeof(float) * (S + 1) *
                                static_cast<size_t>(n_bins));
  auto kernel = lay.state_in_smem ? porc_multisource_strict_kernel<true>
                                  : porc_multisource_strict_kernel<false>;
  cudaError_t err = set_smem(kernel, lay.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, kStrictThreads, lay.bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const float*>(base0),
      static_cast<const float*>(delta0), static_cast<const int*>(ticks0),
      static_cast<int*>(assign), static_cast<float*>(base_out),
      static_cast<float*>(delta_out), static_cast<int*>(ticks_out),
      static_cast<int*>(list_scratch), static_cast<uint64_t*>(order),
      n_steps, n_sources, block, n_bins, sync_every, sort_n,
      lay.list_in_smem ? 1 : 0, cap_scale, lookahead);
  return static_cast<int>(cudaGetLastError());
}
