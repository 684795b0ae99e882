// Snapshot-probing PoRC block engines for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   porc_snapshot_kernel    <- repro/kernels/porc_snapshot.py::porc_snapshot
//                              (body _snapshot_kernel)
//   porc_multisource_cluster_kernel<false, ...>
//                           <- repro/kernels/porc_snapshot.py::
//                              porc_multisource_scan, policy-free branch
//                              (body _multisource_kernel)
//   porc_multisource_cluster_kernel<true, ...>
//                           <- the same function's HHPolicy branch
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
// Single source. One persistent CTA walks the blocks in order. The load
// vector stays in dynamic shared memory for the whole stream while it
// fits, and in the output buffer in global memory (read through L2 with
// __ldcg) above that; the keys are staged in shared memory beside it
// before they are routed (porc_snapshot.py::snapshot_plan sizes both).
// A block of 2..1,024 keys takes a key a thread, its first salts hashed
// ahead and read side by side; block 1 walks its key's chain 32 salts a
// round by ballot, on one warp. The salted candidate chain is hashed in
// the kernel, as the Pallas kernel fuses it. The fallback argmin (lowest
// index on ties) is taken before any add and only when some key of the
// block exhausted its chain. Adds are atomic, exact: the counts are
// integers below 2^24. Between two blocks only the routing warps meet.
//
// Multi-source (both branches, one template). Between two merges the S
// sources do not see each other: each routes against its own view base +
// delta[s]. So one launch is a cluster of G = min(S, 8) CTAs (the
// portable cluster size) and CTA g owns sources g, g+G, g+2G, ...:
//   - it keeps their delta lanes ([n] each) and, with a policy, their
//     sketch lanes ([D, W] each) in its own shared memory, beside a
//     replica of the merged base [n] and of the merged sketch skb [D, W],
//     all loaded by cp.async at the launch's start;
//   - a step routes its sources with CTA barriers only: caps, estimates,
//     budgets, the probe chains, the fallbacks and the adds all read and
//     write its own shared memory. The step's keys of its sources are
//     staged a step ahead (cp.async), so the duplicate rank of the policy
//     reads them there. Without a policy, a key probes its chain four
//     salts at a time (hashes and reads in flight together), and warps
//     that hold no key take each own view's argmin while the others
//     route; with a policy, the fallback pass runs only when some key
//     needs it (__syncthreads_or). The spread fallback sorts a needing source's view inside the owning CTA (the
//     CTAs' sorts run side by side), and a flagged key's rank is a
//     popcount over a bitmask of the flags, not a loop over the keys;
//   - the cluster meets only at a merge (every sync_every steps, phase
//     carried in ticks). A thread that stores into another CTA's shared
//     memory waits about a round trip, while its reads of it can all be
//     in flight at once, so the loads merge by reads:
//     Loads: each CTA sums its own lanes per column into its row of a
//     [2, n] buffer (the parity of the merge picks the half); after a
//     cluster barrier every CTA reads the G rows, in rank order and 16
//     bytes a read, and adds them into its own base replica. A row half
//     is written again two merges later, after the next barrier, which
//     no CTA reaches before its reads are done; after a launch's last
//     merge a last barrier keeps every CTA alive until all have read.
//     The base mass moves by the lanes' total mass, sent to every CTA.
//     Sketch: only the cells that some key hit since the last merge can
//     have changed. Each add marks its cell in the bitmap of the CTA that
//     merges it (bitmap word w belongs to CTA w % G; red.shared::cluster);
//     that CTA lists its marked cells, sums the S lanes of each in source
//     order 0..S-1 (as lane_sum does, 8 remote reads in flight), adds the
//     sum to its skb once and stores the result into the other replicas.
//     After a second barrier each CTA zeroes the cells its own lanes
//     changed (a bitmap of its own). A launch whose skd0 enters non-zero
//     marks its non-zero cells first, so its first merge covers them too.
//     A merge in a launch's last step only feeds the output: each CTA
//     reads the columns of its own slice of base, the one it writes out.
// A state that does not fit in shared memory (kSmemLimit) keeps its
// loads, or its sketch, in the output buffers in global memory instead,
// each lane written by its owning CTA and read through L2; the loads then
// merge there, CTA g over columns [lo_g, hi_g). The wrapper
// (porc_snapshot.py::multisource_plan) picks the layout and the threads
// from the sizes before the launch; the launcher checks its byte count
// against MSLayout and a refused launch returns its error.
//
// Why it is exact. Loads and sketch counts are integer-valued f32 below
// 2^24 and every add is 1.0, so the atomics, the column sums and the
// masses (a lane's mass moves by block per step, as every key of a
// source's block adds one to its lane; the base mass by the lanes' total
// at a merge) give the plain engine's values in any order. A sketch cell
// is merged with one rounding, skb + (lane sum in source order), as the
// plain engine does, so rescaled (non-integer) sketch counts agree too;
// a cell that no key hit and that entered zero adds 0 in the plain engine
// and is left as it is here.
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

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "routing.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChainGroup = 4;   // salts a key probes at once
constexpr int kMaxDevices = 64;  // devices whose smem ceiling is recorded

// ---------------------------------------------------------------------------
// Single source: ref_porc_snapshot
// ---------------------------------------------------------------------------
//
// One persistent CTA. The launch's keys are copied into shared memory
// first (cp.async), in one window when they fit beside the loads, else
// in a ring of two windows: the next window's copies are issued, by
// every thread, before the current one is routed, and waited for after
// it (one CTA barrier a window). Nothing global is on the chain: the keys
// and the loads are read from shared memory (or the loads through L2
// above kSmemLimit), the picks stay in registers and are stored once.
//
// block >= 2: key t of a block on thread t, so ceil(block / 32) warps
// route (a 16-key tail and block 32 one warp, block 128 four). Each
// thread hashes its key's first kAhead salts (the default chunk) and
// reads them side by side; the next block's key and its salts are hashed
// while this block votes and adds, as they do not depend on the loads.
// Only when some key's budget holds no bin under the cap (a vote:
// __any_sync in one warp, bar.red.or among several) does each warp take
// the argmin of the loads (lowest index on ties), before any add. (Helper
// warps that hashed the next block and took the argmin while the routing
// warps routed measured slower on the H100, PERF.md section 5.) The adds
// are atomics on the loads, then one barrier of the routing warps
// (__syncwarp for one).
// While every load is a count below 2^24 (checked at the launch's start)
// the loads in shared memory are kept as integers: a float atomic add on
// shared memory is a compare-and-swap loop, and a block's copies of a hot
// key all add to one bin.
//
// block == 1 (the sequential oracle's full chain of 4 n_bins salts): one
// warp; lane i hashes salt s + i and reads that bin's load; the first set
// bit of __ballot_sync(load < cap) is the serial walk's pick. The next
// key's first round is hashed and read before this key's add lands (then
// corrected by comparing its bins with the pick), so no shared-memory
// round trip lies between two keys; the lane that found the pick adds to
// it from the load it read.
//
// The loads in global memory (n_bins above kSmemLimit): the adds are
// atomics in L2 and the reads go through L2 (__ldcg); __threadfence_block
// and the barrier order a block's adds before the next block's reads.

constexpr int kSnapMaxBlock = 1024;   // one key a thread
constexpr int kAhead = 8;             // salts of a key hashed ahead
constexpr int kSnapMinThreads = 256;  // the key copies need no fewer

__host__ __device__ inline int snap_words(int count) {
  return (count + 3) & ~3;  // 16-byte aligned regions
}

// Issues the copies of keys[0, n) into dst, threads t, t + nt, ..., as one
// cp.async group.
__device__ __forceinline__ void stage_keys(const int* __restrict__ keys,
                                           int* dst, int n, int t, int nt) {
  for (int i = t; i < n; i += nt)
    __pipeline_memcpy_async(dst + i, keys + i, sizeof(int));
  __pipeline_commit();
}

// Load c as f32: from shared or global memory, or (kInt) from the copy in
// integers that the kernel keeps in shared memory while every load is a
// count below 2^24, so that the adds are native integer atomics.
template <bool kSmem, bool kInt>
__device__ __forceinline__ float load_at(const float* load, int c) {
  if constexpr (kInt)
    return static_cast<float>(reinterpret_cast<const int*>(load)[c]);
  else
    return rd<kSmem>(load + c);
}

// A load the integer copy holds exactly: a count below 2^24 (not -0).
__device__ __forceinline__ bool is_count(float v) {
  return v >= 0.0f && v < 16777216.0f &&
         __float_as_uint(v) ==
             __float_as_uint(static_cast<float>(static_cast<int>(v)));
}

// Warp-wide argmin of load[0..n), lowest index on ties; every lane of
// the warp calls it and gets the result.
template <bool kSmem, bool kInt = false>
__device__ __forceinline__ int warp_load_argmin(const float* load, int n) {
  float v = INFINITY;
  int idx = 0x7FFFFFFF;
  for (int c = threadIdx.x % kWarp; c < n; c += kWarp)
    argmin_merge(v, idx, load_at<kSmem, kInt>(load, c), c);
  warp_argmin(v, idx);
  return idx;
}

// The routing threads' barrier (the first `nt` threads, whole warps: named
// barrier 1; one warp: __syncwarp), and the same with an OR vote.
__device__ __forceinline__ void route_sync(int nt) {
  if (nt == kWarp)
    __syncwarp();
  else
    asm volatile("bar.sync 1, %0;" ::"r"(nt) : "memory");
}
__device__ __forceinline__ bool route_any(bool pred, int nt) {
  if (nt == kWarp) return __any_sync(0xFFFFFFFFu, pred);
  int any;
  asm volatile(
      "{\n .reg .pred p, q;\n setp.ne.s32 p, %1, 0;\n"
      " bar.red.or.pred q, 1, %2, p;\n selp.s32 %0, 1, 0, q;\n}"
      : "=r"(any)
      : "r"(static_cast<int>(pred)), "r"(nt)
      : "memory");
  return any != 0;
}

// cap = (m0 + (b+1)*block) * K, the reference's f32 order
__device__ __forceinline__ float snapshot_cap_at(float m0, int b,
                                                 float fblock, float K) {
  const float mt = __fadd_rn(
      m0, __fmul_rn(__fadd_rn(static_cast<float>(b), 1.0f), fblock));
  return __fmul_rn(mt, K);
}

// Blocks [b0, b1) of block >= 2 keys; wk holds keys from key k0 on. Every
// routing thread (the first ceil(block/32) warps) calls it. kInt: the
// loads are the integer copy in shared memory.
template <bool kSmem, bool kInt>
__device__ void route_blocks(const int* wk, int k0, int b0, int b1,
                             int block, float* load, int* assign, float m0,
                             int n_bins, int budget, float K) {
  const int t = threadIdx.x;
  const int nt = (block + kWarp - 1) / kWarp * kWarp;
  const bool live = t < block;
  const uint32_t n = static_cast<uint32_t>(n_bins);
  const uint64_t magic = mod_magic(n);
  const float fblock = static_cast<float>(block);
  const auto key_of = [&](int b) {
    return static_cast<uint32_t>(b < b1 ? wk[b * block - k0 + (live ? t : 0)]
                                        : 0);
  };
  uint32_t key = key_of(b0);
  int c[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j)
    c[j] = hash_to_bin_by(key, static_cast<uint32_t>(1 + j), n, magic);
  for (int b = b0; b < b1; ++b) {
    const float cap = snapshot_cap_at(m0, b, fblock, K);
    float v[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      v[j] = j < budget ? load_at<kSmem, kInt>(load, c[j]) : INFINITY;
    // the next block's key and first salts
    const uint32_t next = key_of(b + 1);
    int cn[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      cn[j] = hash_to_bin_by(next, static_cast<uint32_t>(1 + j), n, magic);
    int p = -1;
#pragma unroll
    for (int j = kAhead - 1; j >= 0; --j)
      if (v[j] < cap) p = c[j];
    // a budget beyond the salts hashed ahead, a group at a time
    for (int s0 = 1 + kAhead; p < 0 && s0 <= budget; s0 += kChainGroup) {
      int cc[kChainGroup];
      float vv[kChainGroup];
#pragma unroll
      for (int j = 0; j < kChainGroup; ++j) {
        cc[j] = hash_to_bin_by(key, static_cast<uint32_t>(s0 + j), n, magic);
        vv[j] = load_at<kSmem, kInt>(load, cc[j]);
      }
#pragma unroll
      for (int j = kChainGroup - 1; j >= 0; --j)
        if (s0 + j <= budget && vv[j] < cap) p = cc[j];
    }
    // every thread has read the snapshot before any add
    if (route_any(live && p < 0, nt)) {
      const int amin = warp_load_argmin<kSmem, kInt>(load, n_bins);
      if (p < 0) p = amin;
      route_sync(nt);
    }
    if (live) {
      if constexpr (kInt)
        atomicAdd(reinterpret_cast<int*>(load) + p, 1);
      else
        atomicAdd(load + p, 1.0f);
      assign[b * block + t] = p;
    }
    if (!kSmem) __threadfence_block();
    route_sync(nt);
    key = next;
#pragma unroll
    for (int j = 0; j < kAhead; ++j) c[j] = cn[j];
  }
}

// Keys [k0, k1) at block 1, each walking its chain 32 salts a round, on
// one warp. The next key's first round is hashed and read while this key
// is routed: its loads then lack only this key's add, which it adds by
// comparing its bins with the pick. The lane that finds the pick adds to
// it, from the load it read.
template <bool kSmem>
__device__ void route_keys(const int* wk, int k0, int k1, float* load,
                           int* assign, float m0, int n_bins, float K) {
  const int lane = threadIdx.x % kWarp;
  const uint32_t n = static_cast<uint32_t>(n_bins);
  const uint64_t magic = mod_magic(n);
  const uint32_t salt = static_cast<uint32_t>(1 + lane);
  const int max_probes = 4 * n_bins;
  const bool live0 = 1 + lane <= max_probes;
  const int len = k1 - k0;
  const auto first_bin = [&](int i) {
    return hash_to_bin_by(static_cast<uint32_t>(i < len ? wk[i] : 0), salt,
                          n, magic);
  };
  int bin = first_bin(0), bin1 = first_bin(1);
  float v = rd<kSmem>(load + bin);
  int prev = -1;  // the pick whose add v does not hold yet
  int mine = 0;   // lane i keeps the pick of key i of each 32
  for (int i = 0; i < len; ++i) {
    // the next key's first round: every add but this key's is visible
    const float v1 = rd<kSmem>(load + bin1);
    const int bin2 = first_bin(i + 2);
    const float cap = snapshot_cap_at(m0, k0 + i, 1.0f, K);
    if (bin == prev) v = __fadd_rn(v, 1.0f);
    const unsigned ok = __ballot_sync(0xFFFFFFFFu, live0 && v < cap);
    int win, pick = bin;
    float pv = v;
    if (ok) {
      win = __ffs(ok) - 1;
    } else {
      const uint32_t key = static_cast<uint32_t>(wk[i]);
      win = -1;
      for (int s = 1 + kWarp; win < 0 && s <= max_probes; s += kWarp) {
        const int c = hash_to_bin_by(key, static_cast<uint32_t>(s + lane), n,
                                     magic);
        const float vc = rd<kSmem>(load + c);
        const unsigned okr =
            __ballot_sync(0xFFFFFFFFu, s + lane <= max_probes && vc < cap);
        if (okr) {
          win = __ffs(okr) - 1;
          pick = c;
          pv = vc;
        }
      }
      if (win < 0) {  // the chain exhausted: the least-loaded bin
        win = 0;
        pick = warp_load_argmin<kSmem>(load, n_bins);
        pv = rd<kSmem>(load + pick);
      }
    }
    __syncwarp();  // v1 was read before this add
    if (lane == win) {
      if constexpr (kSmem)
        load[pick] = __fadd_rn(pv, 1.0f);
      else
        atomicAdd(load + pick, 1.0f);
    }
    prev = __shfl_sync(0xFFFFFFFFu, pick, win);
    const int slot = i % kWarp;
    if (lane == slot) mine = prev;
    if (slot == kWarp - 1 || i + 1 == len)
      if (lane <= slot) assign[k0 + i - slot + lane] = mine;
    bin = bin1;
    bin1 = bin2;
    v = v1;
    if (!kSmem) __threadfence_block();
    __syncwarp();
  }
}

template <bool kSmem, bool kBlock1>
__global__ void __launch_bounds__(kSnapMaxBlock)
    porc_snapshot_kernel(const int* __restrict__ keys,
                         const float* __restrict__ load0,
                         const float* __restrict__ m0_ptr,
                         int* __restrict__ assign,
                         float* __restrict__ load_out, int n_blocks,
                         int block, int n_bins, int chunk, float cap_scale,
                         int window, int buffers) {
  extern __shared__ __align__(16) float smem[];
  float* load = kSmem ? smem : load_out;
  int* ring = reinterpret_cast<int*>(smem + (kSmem ? snap_words(n_bins) : 0));
  const int ring_words = snap_words(window);
  const int M = n_blocks * block;
  const int n_windows = (M + window - 1) / window;
  bool counts = true;
  for (int c = threadIdx.x; c < n_bins; c += blockDim.x) {
    const float v = load0[c];
    load[c] = v;
    counts &= is_count(v);
  }
  stage_keys(keys, ring, min(window, M), threadIdx.x, blockDim.x);
  __pipeline_wait_prior(0);
  // blocks >= 2 add with integer atomics when every load is a count
  constexpr bool kMayInt = kSmem && !kBlock1;
  const bool ints = kMayInt ? __syncthreads_and(counts) : false;
  if (!kMayInt) __syncthreads();
  int* iload = reinterpret_cast<int*>(load);
  if (ints) {
    for (int c = threadIdx.x; c < n_bins; c += blockDim.x)
      iload[c] = static_cast<int>(load[c]);
    __syncthreads();
  }

  const int route_threads = (block + kWarp - 1) / kWarp * kWarp;
  const float m0 = *m0_ptr;
  // block=1 walks the whole chain of Alg. 1 (the sequential oracle);
  // block>1 probes the first `chunk` salts
  const int budget = min(chunk, 4 * n_bins);
  for (int w = 0; w < n_windows; ++w) {
    const int k0 = w * window;
    const int k1 = min(k0 + window, M);
    if (k1 < M)  // the next window, into the buffer read two windows ago
      stage_keys(keys + k1, ring + ((w + 1) % buffers) * ring_words,
                 min(window, M - k1), threadIdx.x, blockDim.x);
    const int* wk = ring + (w % buffers) * ring_words;
    if constexpr (kBlock1) {
      if (threadIdx.x < kWarp)
        route_keys<kSmem>(wk, k0, k1, load, assign, m0, n_bins, cap_scale);
    } else if (threadIdx.x < route_threads) {
      if (kMayInt && ints)
        route_blocks<kSmem, kMayInt>(wk, k0, k0 / block, k1 / block, block,
                                     load, assign, m0, n_bins, budget,
                                     cap_scale);
      else
        route_blocks<kSmem, false>(wk, k0, k0 / block, k1 / block, block,
                                   load, assign, m0, n_bins, budget,
                                   cap_scale);
    }
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  if (kSmem)
    for (int c = threadIdx.x; c < n_bins; c += blockDim.x)
      load_out[c] = ints ? static_cast<float>(iload[c]) : load[c];
}

template <bool kSmem, bool kBlock1>
cudaError_t launch_snapshot(const int* keys, const float* load0,
                            const float* m0, int* assign, float* load_out,
                            int n_blocks, int block, int n_bins, int chunk,
                            float cap_scale, int window, int buffers,
                            size_t bytes, cudaStream_t st) {
  auto kernel = porc_snapshot_kernel<kSmem, kBlock1>;
  // the shared-memory ceiling once per instance and device
  static bool ceiling_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !ceiling_set[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemLimit));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) ceiling_set[dev] = true;
  }
  const int threads =
      max(kSnapMinThreads, (block + kWarp - 1) / kWarp * kWarp);
  kernel<<<1, threads, bytes, st>>>(keys, load0, m0, assign, load_out,
                                    n_blocks, block, n_bins, chunk,
                                    cap_scale, window, buffers);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Multi-source: ref._porc_multisource_scan, both branches, as a cluster
// ---------------------------------------------------------------------------
//
// keys is the round-robin-interleaved stream: message i belongs to
// source i % S, and step b covers keys[b*S*block, (b+1)*S*block); key k of
// source s in step b is keys[b*S*block + k*S + s], and its assignment is
// written at the same index, so no transpose is needed on either side.
//
// With an HHPolicy, per step and on top of the policy-free engine: each
// (source, key) item estimates its key's count on the source's sketch
// view skb + skd[s] (min over the rows), turns it into a probe budget
// (hh_budgets), and walks the first min(budget, C) salted candidates of
// its chain in the rotated order of its in-block duplicate rank, stopping
// at the first bin below the cap. A key that finds none takes the
// least-loaded of its own candidates (score load + rotated position), or,
// when its budget is beyond the chain, the full choice set: the argmin of
// the source's view, or -- spread fallback -- the r-th bin of the view's
// stable load order, r counting such keys in block order. Then the
// block's keys go into the source's sketch lane.

constexpr uint32_t kSketchSalt0 = 0x5EEDC0DEu;
constexpr int kMsThreads = 1024;
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kInFlight = 8;     // lane reads a merge keeps in flight

// The cluster barrier in two halves: arrive (release) early, wait
// (acquire) where another CTA's shared memory or global state is first
// touched, so a launch's loads overlap the other CTAs' start.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// Stores and ORs into CTA `rank`'s shared memory at the place of `local`
// in this CTA's (the next cluster barrier, release, makes them visible),
// and a 16-byte read from there.
__device__ __forceinline__ uint32_t cluster_addr(const void* local,
                                                 int rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(local));
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(float* local, int rank, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(cluster_addr(local,
                                                                     rank)),
               "f"(v));
}
__device__ __forceinline__ float4 ld_cluster4(const float* local,
                                              int rank) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(cluster_addr(local, rank))
               : "memory");
  return v;
}
__device__ __forceinline__ void red_or_cluster(uint32_t* local, int rank,
                                               uint32_t v) {
  asm volatile("red.shared::cluster.or.b32 [%0], %1;" ::"r"(cluster_addr(
                   local, rank)),
               "r"(v));
}

struct HHParams {
  int depth, width, chain, d_tail, ceiling, rotate, spread, sort_n;
  float hot_fraction, need_scale;
};

struct MSArgs {
  const int* keys;
  const float* base0;
  const float* delta0;
  const int* ticks0;
  const float* skb0;
  const float* skd0;
  int* assign;
  float* base_out;
  float* delta_out;
  int* ticks_out;
  float* skb_out;
  float* skd_out;
  uint64_t* order;  // [G, sort_n] scratch of the spread fallback
  int n_steps, n_sources, block, n_bins, chunk, sync_every;
  int lanes;        // ceil(S / G): the most sources a CTA owns
  float cap_scale, lookahead;
};

__host__ __device__ inline size_t pad4(size_t count) {
  return (count + 3) & ~static_cast<size_t>(3);  // 16-byte aligned regions
}

__host__ __device__ inline size_t take_words(size_t& at, size_t count) {
  const size_t off = at;
  at += pad4(count);
  return off;
}

// Start of CTA g's slice of [0, count), a multiple of 4 (16-byte copies).
__host__ __device__ inline int slice_lo(int g, int G, int count) {
  if (g >= G) return count;
  return static_cast<int>(static_cast<long long>(g) * (count / 4) / G) * 4;
}

// One CTA's dynamic shared memory, in 4-byte words. The wrapper's
// porc_snapshot.py::multisource_plan sums the same regions.
struct MSLayout {
  size_t skb = 0, skd = 0, base = 0, delta = 0, gather = 0, touched = 0,
         own = 0, cells = 0, kst = 0, pick = 0, scal = 0, fbits = 0,
         words = 0;
  __host__ __device__ MSLayout(int n, int block, int L, int G, int DW,
                               bool hh, bool loads_smem, bool sketch_smem) {
    size_t at = 0;
    const size_t nL = static_cast<size_t>(L);
    const size_t nw = (static_cast<size_t>(DW) + 31) / 32;
    if (hh && sketch_smem) {
      skb = take_words(at, DW);                     // merged sketch replica
      skd = take_words(at, nL * DW);                // own sketch lanes
    }
    if (loads_smem) {
      base = take_words(at, n);                     // merged load replica
      delta = take_words(at, nL * n);               // own load lanes
      // this CTA's column sums, two merges' worth
      gather = take_words(at, 2 * pad4(n));
    }
    if (hh) {
      touched = take_words(at, nw);                 // changed sketch cells
      own = take_words(at, nw);                     // own lanes' changed
      cells = take_words(at, (nw + G - 1) / G * 32);  // their list
    }
    kst = take_words(at, 2 * pad4(nL * block));    // keys, two steps
    pick = take_words(at, nL * block);              // their picks
    scal = take_words(at, 4 * nL + 2 * kMaxCluster + kWarp + 4);
    if (hh) fbits = take_words(at, nL * ((block + 31) / 32));
    words = at;
  }
};

// dst (shared) <- src (global) by cp.async, 16 bytes a copy where both
// are aligned. The caller commits and waits.
__device__ void async_copy(float* dst, const float* src, int count) {
  const bool vec = ((reinterpret_cast<uintptr_t>(dst) |
                     reinterpret_cast<uintptr_t>(src)) & 15) == 0;
  const int n4 = vec ? count / 4 : 0;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
  for (int i = 4 * n4 + threadIdx.x; i < count; i += blockDim.x)
    __pipeline_memcpy_async(dst + i, src + i, 4);
}

// dst[0, count) = src[0, count), 16 bytes a thread where both are aligned.
__device__ void copy_plain(float* dst, const float* src, int count) {
  const bool vec = ((reinterpret_cast<uintptr_t>(dst) |
                     reinterpret_cast<uintptr_t>(src)) & 15) == 0;
  const int n4 = vec ? count / 4 : 0;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    reinterpret_cast<float4*>(dst)[i] =
        reinterpret_cast<const float4*>(src)[i];
  for (int i = 4 * n4 + threadIdx.x; i < count; i += blockDim.x)
    dst[i] = src[i];
}

// x_0 + x_1 + ... + x_{S-1} in source order (lane_sum's order), each x_s
// read at cell(s), kInFlight reads in flight at a time.
template <bool kSmem, typename Cell>
__device__ float sum_lanes(int S, Cell cell) {
  float acc = 0.0f;
  for (int s0 = 0; s0 < S; s0 += kInFlight) {
    float v[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j)
      if (s0 + j < S) v[j] = rd<kSmem>(cell(s0 + j));
#pragma unroll
    for (int j = 0; j < kInFlight; ++j)
      if (s0 + j < S) acc = s0 + j == 0 ? v[j] : __fadd_rn(acc, v[j]);
  }
  return acc;
}

template <bool kHH, bool kLoadsSmem, bool kSketchSmem>
__global__ void __launch_bounds__(kMsThreads, 1)
porc_multisource_cluster_kernel(MSArgs a, HHParams hp) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int g = static_cast<int>(cluster.block_rank());
  const int G = static_cast<int>(cluster.num_blocks());
  const int S = a.n_sources, n = a.n_bins, block = a.block, L = a.lanes;
  const int nl = (S - g + G - 1) / G;  // own sources g, g+G, ...
  const int D = kHH ? hp.depth : 0, W = kHH ? hp.width : 0, DW = D * W;
  const int fw = (block + 31) / 32;    // flag words per lane
  const int tid = threadIdx.x, bd = blockDim.x;
  const int lane_id = tid % kWarp, warp = tid / kWarp, n_warps = bd / kWarp;
  const MSLayout lay(n, block, L, G, DW, kHH, kLoadsSmem, kSketchSmem);
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  float* base = kLoadsSmem ? smem + lay.base : a.base_out;
  float* gather = smem + lay.gather;   // [2, pad4(n)] own column sums
  const int gs = static_cast<int>(pad4(n));
  float* skb = kSketchSmem ? smem + lay.skb : a.skb_out;
  uint32_t* touched = words + lay.touched;
  uint32_t* own_cells = words + lay.own;  // cells own sketch lanes changed
  int* cells = reinterpret_cast<int*>(smem + lay.cells);
  uint32_t* fbits = words + lay.fbits;
  int* kbuf = reinterpret_cast<int*>(smem + lay.kst);
  const int kstride = static_cast<int>(pad4(static_cast<size_t>(L) * block));
  int* pick = reinterpret_cast<int*>(smem + lay.pick);
  float* lmass = smem + lay.scal;                       // [L]
  int* need = reinterpret_cast<int*>(lmass + L);        // [L]
  int* sneed = need + L;                                // [L]
  int* amin = sneed + L;                                // [L]
  float* lane_in = reinterpret_cast<float*>(amin + L);  // [2, 8] totals
  float* bsum = lane_in + 2 * kMaxCluster;              // [32] base sums
  int* n_cells = reinterpret_cast<int*>(bsum + kWarp);  // marked cells
  // load lane and sketch lane of own source l (source g + l*G)
  auto lane = [&](int l) -> float* {
    return kLoadsSmem ? smem + lay.delta + static_cast<size_t>(l) * n
                      : a.delta_out + static_cast<size_t>(g + l * G) * n;
  };
  auto sk_lane = [&](int l) -> float* {
    return kSketchSmem ? smem + lay.skd + static_cast<size_t>(l) * DW
                       : a.skd_out + static_cast<size_t>(g + l * G) * DW;
  };
  // a sketch cell changed since the last merge: marked in the bitmap of
  // the CTA that merges it (word w belongs to CTA w % G)
  auto mark = [&](int cell) {
    const int w = cell >> 5;
    red_or_cluster(touched + w, w % G, 1u << (cell & 31));
  };
  // the keys of step b of own sources into buffer b & 1, by cp.async
  auto stage_keys = [&](int b) {
    int* dst = kbuf + (b & 1) * kstride;
    const int* src = a.keys + static_cast<size_t>(b) * S * block + g;
    for (int i = tid; i < nl * block; i += bd) {
      const int l = i / block, k = i - l * block;
      __pipeline_memcpy_async(dst + i, src + k * S + l * G, 4);
    }
    __pipeline_commit();
  };
  const bool fence = !kLoadsSmem || (kHH && !kSketchSmem);
  const int lo = slice_lo(g, G, n), hi = slice_lo(g + 1, G, n);
  const int nw = (DW + 31) / 32;
  const int ticks0 = *a.ticks0;
  // The launch's last merge step (-1: none). Marks land in other CTAs'
  // shared memory, so none is made after it: nothing reads them, and a
  // CTA may have exited.
  const int last_merge = a.n_steps - 1 - (ticks0 + a.n_steps) % a.sync_every;
  bool joined = false;
  auto join = [&]() {  // once, at one point for all threads of the CTA
    if (!joined) cluster_wait();
    joined = true;
  };

  // 1. own lanes and the replicas (in global memory: own lanes and one
  //    slice of the merged state each), the first step's keys
  if (kHH)
    for (int w = tid; w < nw; w += bd) touched[w] = own_cells[w] = 0u;
  if (kLoadsSmem) {
    async_copy(base, a.base0, n);
    for (int l = 0; l < nl; ++l)
      async_copy(lane(l), a.delta0 + static_cast<size_t>(g + l * G) * n, n);
  } else {
    copy_plain(base + lo, a.base0 + lo, hi - lo);
    for (int l = 0; l < nl; ++l)
      copy_plain(lane(l), a.delta0 + static_cast<size_t>(g + l * G) * n, n);
  }
  if constexpr (kHH) {
    if (kSketchSmem) {
      async_copy(skb, a.skb0, DW);
      for (int l = 0; l < nl; ++l)
        async_copy(sk_lane(l), a.skd0 + static_cast<size_t>(g + l * G) * DW,
                   DW);
    } else {
      const int klo = slice_lo(g, G, DW), khi = slice_lo(g + 1, G, DW);
      copy_plain(skb + klo, a.skb0 + klo, khi - klo);
      for (int l = 0; l < nl; ++l)
        copy_plain(sk_lane(l), a.skd0 + static_cast<size_t>(g + l * G) * DW,
                   DW);
    }
  }
  for (int l = tid; l < nl; l += bd) lmass[l] = 0.0f;
  stage_keys(0);
  __syncthreads();  // the bitmap is zero before any CTA may mark it
  if (fence) __threadfence();
  cluster_arrive();
  if (fence) join();  // the global state of every CTA is in place
  __pipeline_wait_prior(0);
  __syncthreads();

  // a launch whose sketch lanes enter non-zero merges those cells too
  if (kHH && last_merge >= 0) {
    join();
    for (int l = 0; l < nl; ++l) {
      const float* sl = sk_lane(l);
      for (int c = tid; c < DW; c += bd)
        if (rd<kSketchSmem>(sl + c) != 0.0f) {
          mark(c);
          atomicOr(own_cells + (c >> 5), 1u << (c & 31));
        }
    }
  }
  // masses (integer-valued: exact in any order): each own lane split
  // over n_warps / nl warps, their warp sums added by shared atomics; the
  // base in warp sums, added up by every thread after the first step's
  // barrier
  const int per_lane = max(n_warps / nl, 1);
  for (int w = warp; w < nl * per_lane; w += n_warps) {
    const int l = w % nl;
    const float* d = lane(l);
    float acc = 0.0f;
    for (int c = (w / nl) * kWarp + lane_id; c < n; c += per_lane * kWarp)
      acc = __fadd_rn(acc, rd<kLoadsSmem>(d + c));
    acc = warp_sum(acc);
    if (lane_id == 0) atomicAdd(lmass + l, acc);
  }
  {
    float acc = 0.0f;
    for (int c = tid; c < n; c += bd)
      acc = __fadd_rn(acc, rd<kLoadsSmem>(base + c));
    acc = warp_sum(acc);
    if (lane_id == 0) bsum[warp] = acc;
  }
  float base_mass = 0.0f;

  const int items = nl * block;
  const int budget = block == 1 ? 4 * n : min(a.chunk, 4 * n);
  // policy-free, when the last nl warps hold no key: they take the argmin
  // of every own view while the others route, in case a key needs it
  const bool spec_argmin = !kHH && items + kWarp * nl <= bd;
  const int C = hp.chain;
  int merges = 0;

  for (int b = 0; b < a.n_steps; ++b) {
    const size_t base_i = static_cast<size_t>(b) * S * block;
    const int* kst = kbuf + (b & 1) * kstride;
    // 2. this step's keys are in (staged a step ahead)
    __pipeline_wait_prior(0);
    if (b + 1 < a.n_steps) stage_keys(b + 1);
    for (int l = tid; l < nl; l += bd) {
      need[l] = 0;
      sneed[l] = 0;
    }
    if (kHH)
      for (int w = tid; w < nl * fw; w += bd) fbits[w] = 0u;
    __syncthreads();
    if (b == 0) base_mass = warp_sum(lane_id < n_warps ? bsum[lane_id] : 0.0f);

    // 3. every (own source, key) resolves against base + delta[s], the
    //    cap from the mass of that view
    int miss = 0;
    for (int i = tid; i < items; i += bd) {
      const int l = i / block, k = i - l * block;
      const int key_i = kst[i];
      const uint32_t key = static_cast<uint32_t>(key_i);
      const float* d = lane(l);
      const float mass = __fadd_rn(base_mass, lmass[l]);
      const float cs = __fmul_rn(__fadd_rn(mass, a.lookahead), a.cap_scale);
      int p = -1;
      if constexpr (!kHH) {
        // the chain kChainGroup salts at a time: their hashes and reads
        // in flight together, the first bin below the cap wins
        for (int t0 = 1; t0 <= budget && p < 0; t0 += kChainGroup) {
          int cand[kChainGroup];
          float v[kChainGroup];
#pragma unroll
          for (int j = 0; j < kChainGroup; ++j)
            cand[j] = hash_to_bin(key, static_cast<uint32_t>(t0 + j),
                                  static_cast<uint32_t>(n));
#pragma unroll
          for (int j = 0; j < kChainGroup; ++j)
            v[j] = __fadd_rn(rd<kLoadsSmem>(base + cand[j]),
                             rd<kLoadsSmem>(d + cand[j]));
#pragma unroll
          for (int j = 0; j < kChainGroup; ++j)
            if (p < 0 && t0 + j <= budget && v[j] < cs) p = cand[j];
        }
        if (p < 0) need[l] = 1;
      } else {
        const float* sl = sk_lane(l);
        float est = INFINITY;
        for (int r = 0; r < D; ++r) {
          const int cell = r * W + hash_to_bin(key, kSketchSalt0 + r,
                                               static_cast<uint32_t>(W));
          est = fminf(est, __fadd_rn(rd<kSketchSmem>(skb + cell),
                                     rd<kSketchSmem>(sl + cell)));
        }
        // hh_budgets, in the reference's compiled order
        const float m = fmaxf(mass, 1.0f);
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
          // in-block duplicate rank and count, from the staged keys
          const int* kb = kst + l * block;
          int dup = 0, count = 0;
          if ((block & 3) == 0) {
            const int4* kb4 = reinterpret_cast<const int4*>(kb);
            for (int q = 0; q < block / 4; ++q) {
              const int4 v = kb4[q];
              const int kk = 4 * q;
              const int s0 = v.x == key_i, s1 = v.y == key_i,
                        s2 = v.z == key_i, s3 = v.w == key_i;
              count += s0 + s1 + s2 + s3;
              dup += (s0 & (kk < k)) + (s1 & (kk + 1 < k)) +
                     (s2 & (kk + 2 < k)) + (s3 & (kk + 3 < k));
            }
          } else {
            for (int kk = 0; kk < block; ++kk) {
              const int same = kb[kk] == key_i;
              count += same;
              dup += same & (kk < k);
            }
          }
          offset = static_cast<int>(static_cast<long long>(dup) * window /
                                    max(count, 1));
        }
        // candidate-min fallback: least score, lowest chain index on ties
        int best_c = -1, best_i = 0x7FFFFFFF;
        float best_v = INFINITY;
        for (int q = 0; q < window; ++q) {
          int idx = offset + q;
          if (idx >= window) idx -= window;
          const int c = hash_to_bin(key, static_cast<uint32_t>(idx + 1),
                                    static_cast<uint32_t>(n));
          const float v =
              __fadd_rn(rd<kLoadsSmem>(base + c), rd<kLoadsSmem>(d + c));
          if (v < cs) {
            p = c;
            break;
          }
          const float score =
              hp.rotate ? __fadd_rn(v, static_cast<float>(q)) : v;
          if (score < best_v || (score == best_v && idx < best_i)) {
            best_v = score;
            best_i = idx;
            best_c = c;
          }
        }
        if (p < 0) {
          if (bud > C) {  // the full choice set: resolved in pass 4
            if (hp.spread) {
              sneed[l] = 1;
              atomicOr(fbits + l * fw + k / 32, 1u << (k % 32));
            } else {
              need[l] = 1;
            }
          } else {
            // an empty window scores every candidate inf: index 0 wins
            p = best_c >= 0 ? best_c
                            : hash_to_bin(key, 1u, static_cast<uint32_t>(n));
          }
        }
      }
      pick[i] = p;
      miss |= p < 0;
    }
    if (spec_argmin && warp >= n_warps - nl) {
      const int l = warp - (n_warps - nl);
      const float* d = lane(l);
      float v = INFINITY;
      int idx = 0x7FFFFFFF;
#pragma unroll 4
      for (int c = lane_id; c < n; c += kWarp)
        argmin_merge(
            v, idx,
            __fadd_rn(rd<kLoadsSmem>(base + c), rd<kLoadsSmem>(d + c)), c);
      warp_argmin(v, idx);
      if (lane_id == 0) amin[l] = idx;
    }
    const int any_miss = __syncthreads_or(miss) && !spec_argmin;

    // 4. only when some key needs the full choice set
    if (any_miss) {
      // 4a. argmin of the view for the own sources that need it
      for (int l = warp; l < nl; l += n_warps) {
        if (!need[l]) continue;
        const float* d = lane(l);
        float v = INFINITY;
        int idx = 0x7FFFFFFF;
#pragma unroll 4
        for (int c = lane_id; c < n; c += kWarp)
          argmin_merge(
              v, idx,
              __fadd_rn(rd<kLoadsSmem>(base + c), rd<kLoadsSmem>(d + c)), c);
        warp_argmin(v, idx);
        if (lane_id == 0) amin[l] = idx;
      }
      // 4b. spread fallback: the r-th flagged key of a source takes the
      //     (r mod n)-th bin of its view's stable load order
      if (kHH && hp.spread) {
        uint64_t* ord = a.order + static_cast<size_t>(g) * hp.sort_n;
        for (int l = 0; l < nl; ++l) {
          if (!sneed[l]) continue;  // uniform: read after a barrier
          const float* d = lane(l);
          stable_order(
              [&](int c) {
                return __fadd_rn(rd<kLoadsSmem>(base + c),
                                 rd<kLoadsSmem>(d + c));
              },
              n, ord, hp.sort_n);
          const uint32_t* fb = fbits + l * fw;
          for (int k = tid; k < block; k += bd) {
            const uint32_t wbits = fb[k / 32];
            if (!((wbits >> (k % 32)) & 1u)) continue;
            int r = __popc(wbits & ((1u << (k % 32)) - 1u));
            for (int w = 0; w < k / 32; ++w) r += __popc(fb[w]);
            pick[l * block + k] = static_cast<int>(
                static_cast<uint32_t>(__ldcg(ord + r % n)));
          }
          __syncthreads();  // the order scratch is reused by the next lane
        }
      }
      __syncthreads();
    }

    // 5. write the assignments; add into the own load and sketch lanes
    //    (a thread per key, with a policy per key and sketch row: a
    //    remote mark costs its thread a round trip, so one a thread)
    for (int q = tid; q < items * (kHH ? D : 1); q += bd) {
      const int i = kHH ? q / D : q, r = kHH ? q - i * D : 0;
      const int l = i / block, k = i - l * block;
      if (r == 0) {
        int p = pick[i];
        if (p < 0) p = amin[l];
        a.assign[base_i + static_cast<size_t>(k) * S + g + l * G] = p;
        atomicAdd(lane(l) + p, 1.0f);
      }
      if constexpr (kHH) {
        const int cell =
            r * W + hash_to_bin(static_cast<uint32_t>(kst[i]),
                                kSketchSalt0 + r, static_cast<uint32_t>(W));
        atomicAdd(sk_lane(l) + cell, 1.0f);
        if (b <= last_merge) {
          mark(cell);
          atomicOr(own_cells + (cell >> 5), 1u << (cell & 31));
        }
      }
    }
    // every key of a source's block added one to its lane
    for (int l = tid; l < nl; l += bd)
      lmass[l] = __fadd_rn(lmass[l], static_cast<float>(block));
    __syncthreads();

    // 6. piggyback merge on the sync phase carried in ticks (the
    //    cluster meets only here: CTAs run ahead freely in between)
    if ((ticks0 + b + 1) % a.sync_every == 0) {
      join();
      const int par = merges & 1;
      ++merges;
      // a merge in the launch's last step only writes the output: each
      // CTA merges the columns of its slice of base
      const bool last = b == a.n_steps - 1;
      float* row = gather + par * gs;  // this merge's half
      // every column's sum over own lanes into this CTA's row; the own
      // lanes' total mass into every CTA
      if (kLoadsSmem) {
        for (int c = tid; c < n; c += bd) {
          float acc = 0.0f;
          for (int l = 0; l < nl; ++l) {
            float* d = lane(l);
            acc = __fadd_rn(acc, d[c]);
            d[c] = 0.0f;
          }
          row[c] = acc;
        }
      }
      if (tid < G && !last) {
        float total = 0.0f;
        for (int l = 0; l < nl; ++l) total = __fadd_rn(total, lmass[l]);
        st_cluster(lane_in + par * kMaxCluster + g, tid, total);
      }
      if (fence) __threadfence();
      cluster.sync();  // A: every CTA's row and total are in place
      float lanes_total = 0.0f;
      for (int r = 0; r < G && !last; ++r)
        lanes_total = __fadd_rn(lanes_total, lane_in[par * kMaxCluster + r]);
      if (kLoadsSmem) {
        // every CTA merges all n columns into its own replica (at the
        // last merge: its slice, the one it writes out), reading the G
        // rows 4 columns at a time, all G reads in flight (slices start
        // at multiples of 4; the row's pad is never added)
        const int c0 = last ? lo : 0, c1 = last ? hi : n;
        for (int c = c0 + 4 * tid; c < c1; c += 4 * bd) {
          float4 v[kMaxCluster];
#pragma unroll
          for (int r = 0; r < kMaxCluster; ++r)
            if (r < G) v[r] = ld_cluster4(row + c, r);
          float acc[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
#pragma unroll
          for (int r = 1; r < kMaxCluster; ++r)
            if (r < G) {
              acc[0] = __fadd_rn(acc[0], v[r].x);
              acc[1] = __fadd_rn(acc[1], v[r].y);
              acc[2] = __fadd_rn(acc[2], v[r].z);
              acc[3] = __fadd_rn(acc[3], v[r].w);
            }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < c1) base[c + j] = __fadd_rn(base[c + j], acc[j]);
        }
        // the launch's last merge: no CTA exits before every CTA has
        // read its rows (the matching wait ends the launch)
        if (!kHH && b == last_merge) cluster_arrive();
      } else {
        // CTA g merges columns [lo, hi) of the lanes in global memory
        for (int c = lo + tid; c < hi; c += bd) {
          const float acc = sum_lanes<false>(S, [&](int s) {
            return a.delta_out + static_cast<size_t>(s) * n + c;
          });
          for (int s = 0; s < S; ++s)
            a.delta_out[static_cast<size_t>(s) * n + c] = 0.0f;
          base[c] = __fadd_rn(__ldcg(base + c), acc);
        }
      }
      if constexpr (kHH) {
        // sketch: list the marked cells of the bitmap words CTA g owns,
        // then merge one cell a thread
        const int nown = (nw - g + G - 1) / G;
        if (tid == 0) *n_cells = 0;
        __syncthreads();
        for (int j = tid; j < nown; j += bd) {
          const int w = g + j * G;
          uint32_t bits = touched[w];
          if (!bits) continue;
          touched[w] = 0u;
          int at = atomicAdd(n_cells, __popc(bits));
          while (bits) {
            const int bit = __ffs(bits) - 1;
            bits &= bits - 1;
            cells[at++] = 32 * w + bit;
          }
        }
        __syncthreads();
        const int count = *n_cells;
        for (int i = tid; i < count; i += bd) {
          const int c = cells[i];
          if (c >= DW) continue;
          const float acc = sum_lanes<kSketchSmem>(S, [&](int s) {
            return kSketchSmem
                       ? cluster.map_shared_rank(
                             smem + lay.skd + static_cast<size_t>(s / G) * DW +
                                 c,
                             s % G)
                       : a.skd_out + static_cast<size_t>(s) * DW + c;
          });
          skb[c] = __fadd_rn(rd<kSketchSmem>(skb + c), acc);
        }
        if (kSketchSmem) {
          // the merged cells into the other replicas, one (cell, CTA)
          // pair a thread
          __syncthreads();
          for (int q = tid; q < count * (G - 1); q += bd) {
            const int c = cells[q % count];
            if (c < DW) st_cluster(skb + c, (g + 1 + q / count) % G, skb[c]);
          }
        }
      }
      if (!kLoadsSmem || kHH) {
        if (fence) __threadfence();
        cluster.sync();  // B: every replica holds the merge
      }
      if constexpr (kHH) {
        // every lane has been read: zero the cells own lanes changed
        for (int w = tid; w < nw; w += bd) {
          uint32_t bits = own_cells[w];
          if (!bits) continue;
          own_cells[w] = 0u;
          while (bits) {
            const int c = 32 * w + __ffs(bits) - 1;
            bits &= bits - 1;
            for (int l = 0; l < nl; ++l) sk_lane(l)[c] = 0.0f;
          }
        }
        __syncthreads();
      }
      base_mass = __fadd_rn(base_mass, lanes_total);
      for (int l = tid; l < nl; l += bd) lmass[l] = 0.0f;
    }
  }
  join();

  // 7. write back own lanes and one slice of each replica (another CTA's
  //    shared memory was last touched before the last merge's closing
  //    barrier: B, or with the loads alone the arrive above and the wait
  //    below)
  if (kLoadsSmem) {
    copy_plain(a.base_out + lo, base + lo, hi - lo);
    for (int l = 0; l < nl; ++l)
      copy_plain(a.delta_out + static_cast<size_t>(g + l * G) * n, lane(l),
                 n);
  }
  if constexpr (kHH && kSketchSmem) {
    const int klo = slice_lo(g, G, DW), khi = slice_lo(g + 1, G, DW);
    copy_plain(a.skb_out + klo, skb + klo, khi - klo);
    for (int l = 0; l < nl; ++l)
      copy_plain(a.skd_out + static_cast<size_t>(g + l * G) * DW, sk_lane(l),
                 DW);
  }
  if (g == 0 && tid == 0) *a.ticks_out = (ticks0 + a.n_steps) % a.sync_every;
  if (!kHH && kLoadsSmem && last_merge >= 0) cluster_wait();
}

template <bool kHH, bool kLoadsSmem, bool kSketchSmem>
cudaError_t launch_cluster(const MSArgs& a, const HHParams& hp, int G,
                           int threads, size_t bytes, cudaStream_t st) {
  auto kernel = porc_multisource_cluster_kernel<kHH, kLoadsSmem, kSketchSmem>;
  // the shared-memory ceiling once per instance and device, not at every
  // launch: a driver call on the host that the main path would pay five
  // times a slot
  static bool ceiling_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !ceiling_set[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemLimit));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) ceiling_set[dev] = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, hp);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Checks the wrapper's plan (cluster size, layout flags, bytes) against
// the sizes and launches the matching instance.
cudaError_t launch_multisource(const MSArgs& a, const HHParams& hp, bool hh,
                               int G, int threads, int loads_smem,
                               int sketch_smem, int bytes, cudaStream_t st) {
  const int S = a.n_sources;
  if (G < 1 || G > kMaxCluster || G > S || a.lanes != (S + G - 1) / G ||
      (!hh && sketch_smem) || threads < kWarp || threads > kMsThreads ||
      threads % kWarp)
    return cudaErrorInvalidValue;
  const MSLayout lay(a.n_bins, a.block, a.lanes, G,
                     hh ? hp.depth * hp.width : 0, hh, loads_smem != 0,
                     sketch_smem != 0);
  const size_t want = sizeof(float) * lay.words;
  if (bytes < 0 || want != static_cast<size_t>(bytes) || want > kSmemLimit)
    return cudaErrorInvalidValue;
  const int T = threads;
  if (hh) {
    if (loads_smem)
      return sketch_smem
                 ? launch_cluster<true, true, true>(a, hp, G, T, want, st)
                 : launch_cluster<true, true, false>(a, hp, G, T, want, st);
    return sketch_smem
               ? launch_cluster<true, false, true>(a, hp, G, T, want, st)
               : launch_cluster<true, false, false>(a, hp, G, T, want, st);
  }
  return loads_smem
             ? launch_cluster<false, true, false>(a, hp, G, T, want, st)
             : launch_cluster<false, false, false>(a, hp, G, T, want, st);
}

}  // namespace

// The wrapper's plan (porc_snapshot.py::snapshot_plan): the loads in
// shared memory or not, and a key window of `window` keys (a multiple of
// the block) in `buffers` buffers (1: every key of the call at once).
// A plan whose bytes differ from this layout's is refused.
extern "C" int porc_snapshot_launch(const void* keys, const void* load0,
                                    const void* m0, void* assign,
                                    void* load_out, int n_blocks, int block,
                                    int n_bins, int chunk, int loads_smem,
                                    int window, int buffers, int smem_bytes,
                                    float cap_scale, void* stream) {
  const long long M = static_cast<long long>(n_blocks) * block;
  const size_t want =
      sizeof(float) * ((loads_smem ? snap_words(n_bins) : 0) +
                       static_cast<size_t>(buffers) * snap_words(window));
  if (n_blocks < 1 || block < 1 || block > kSnapMaxBlock || n_bins < 1 ||
      chunk < 1 || window < block || window % block ||
      (buffers == 1) != (window == M) || buffers < 1 || buffers > 2 ||
      smem_bytes < 0 || want != static_cast<size_t>(smem_bytes) ||
      want > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* k = static_cast<const int*>(keys);
  const auto* l0 = static_cast<const float*>(load0);
  const auto* m = static_cast<const float*>(m0);
  auto* a = static_cast<int*>(assign);
  auto* lo = static_cast<float*>(load_out);
  auto* st = static_cast<cudaStream_t>(stream);
#define SNAPSHOT_LAUNCH(SMEM, BLOCK1)                                        \
  launch_snapshot<SMEM, BLOCK1>(k, l0, m, a, lo, n_blocks, block, n_bins, \
                                chunk, cap_scale, window, buffers, want, st)
  cudaError_t err;
  if (loads_smem)
    err = block == 1 ? SNAPSHOT_LAUNCH(true, true)
                     : SNAPSHOT_LAUNCH(true, false);
  else
    err = block == 1 ? SNAPSHOT_LAUNCH(false, true)
                     : SNAPSHOT_LAUNCH(false, false);
#undef SNAPSHOT_LAUNCH
  return static_cast<int>(err);
}

extern "C" int porc_multisource_launch(
    const void* keys, const void* base0, const void* delta0,
    const void* ticks0, void* assign, void* base_out, void* delta_out,
    void* ticks_out, int n_steps, int n_sources, int block, int n_bins,
    int chunk, int sync_every, int cluster, int threads, int loads_smem,
    int smem_bytes, float cap_scale, float lookahead, void* stream) {
  MSArgs a{};
  a.keys = static_cast<const int*>(keys);
  a.base0 = static_cast<const float*>(base0);
  a.delta0 = static_cast<const float*>(delta0);
  a.ticks0 = static_cast<const int*>(ticks0);
  a.assign = static_cast<int*>(assign);
  a.base_out = static_cast<float*>(base_out);
  a.delta_out = static_cast<float*>(delta_out);
  a.ticks_out = static_cast<int*>(ticks_out);
  a.n_steps = n_steps;
  a.n_sources = n_sources;
  a.block = block;
  a.n_bins = n_bins;
  a.chunk = chunk;
  a.sync_every = sync_every;
  a.lanes = cluster > 0 ? (n_sources + cluster - 1) / cluster : 0;
  a.cap_scale = cap_scale;
  a.lookahead = lookahead;
  const HHParams hp{};
  return static_cast<int>(launch_multisource(
      a, hp, false, cluster, threads, loads_smem, 0, smem_bytes,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int porc_multisource_hh_launch(
    const void* keys, const void* base0, const void* delta0,
    const void* ticks0, const void* skb0, const void* skd0, void* assign,
    void* base_out, void* delta_out, void* ticks_out, void* skb_out,
    void* skd_out, void* order, int n_steps, int n_sources, int block,
    int n_bins, int sync_every, int depth, int width, int chain, int d_tail,
    int ceiling, int rotate, int spread, int sort_n, int cluster,
    int threads, int loads_smem, int sketch_smem, int smem_bytes,
    float cap_scale,
    float lookahead, float hot_fraction, float need_scale, void* stream) {
  MSArgs a{};
  a.keys = static_cast<const int*>(keys);
  a.base0 = static_cast<const float*>(base0);
  a.delta0 = static_cast<const float*>(delta0);
  a.ticks0 = static_cast<const int*>(ticks0);
  a.skb0 = static_cast<const float*>(skb0);
  a.skd0 = static_cast<const float*>(skd0);
  a.assign = static_cast<int*>(assign);
  a.base_out = static_cast<float*>(base_out);
  a.delta_out = static_cast<float*>(delta_out);
  a.ticks_out = static_cast<int*>(ticks_out);
  a.skb_out = static_cast<float*>(skb_out);
  a.skd_out = static_cast<float*>(skd_out);
  a.order = static_cast<uint64_t*>(order);
  a.n_steps = n_steps;
  a.n_sources = n_sources;
  a.block = block;
  a.n_bins = n_bins;
  a.sync_every = sync_every;
  a.lanes = cluster > 0 ? (n_sources + cluster - 1) / cluster : 0;
  a.cap_scale = cap_scale;
  a.lookahead = lookahead;
  const HHParams hp{depth,  width,  chain,  d_tail,       ceiling,
                    rotate, spread, sort_n, hot_fraction, need_scale};
  return static_cast<int>(launch_multisource(
      a, hp, true, cluster, threads, loads_smem, sketch_smem, smem_bytes,
      static_cast<cudaStream_t>(stream)));
}
