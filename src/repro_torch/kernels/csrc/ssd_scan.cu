// Mamba-2 SSD chunked scan (state-space duality) for Hopper (sm_90a).
//
// Replaces, in the JAX package:
//   ssd_scan_kernel_tc / ssd_scan_kernel_f32
//       <- repro/kernels/ssd_scan.py::ssd_scan (body _ssd_kernel)
// and computes, to float tolerance, the plain torch version
// repro_torch/models/mamba2.py::ssd_chunked, including its final state
// (return_state=True), which the Pallas kernel keeps in VMEM and drops.
//
// Semantics, per (batch b, head h), over chunks of Q steps in order, with
// the [P, N] state h0 carried (zero at the start), a = A[h], and the
// head's group g = h / (H / G) for B and C:
//   s_i   = cumsum_{j<=i} dt_j * a                           (inclusive)
//   y_i   = sum_{j<=i} e^{s_i - s_j} * dt_j * (C_i . B_j) * x_j
//         + e^{s_i} * (C_i . h0^T)
//   h'    = e^{s_{Q-1}} * h0 + sum_j (x_j * dt_j * e^{s_{Q-1} - s_j}) (x) B_j
// y is stored in x's dtype (f32 or bf16), the final state in f32.
//
// What bounds it. Per chunk, four products: C.B^T [Q, Q] over N, the
// masked weights times x [Q, P] over Q, C.h0^T [Q, P] over N, and the
// state update [P, N] over Q. In bf16 (the models) the products run on
// the tensor cores at up to 989 TF/s, so the least time is the bytes:
// x, B, C read once and y written once in bf16, dt and the final state
// in f32 (PERF.md section 6, row 5).
//
// Both kernels keep one CTA per (b, h) walking its chunks in order, with
// the state on chip for the whole sequence, as the Pallas kernel keeps it
// in VMEM: chunk states in device memory would move more bytes than the
// whole scan's bound. The cumsum of a chunk is a warp scan (four values a
// lane, then __shfl_up_sync).
//
// bf16 (ssd_scan_kernel_tc<kN>, 4 warps). x, B and C are staged as
// stored, in bf16, by cp.async into XOR-swizzled tiles (ldmatrix reads
// them without bank conflicts), one chunk at a time: the next chunk's C
// loads while this chunk's state updates, its x, B and dt once the state
// is done. A second buffer for x and B (the next chunk's tiles loading
// while this one computes) measured slower on the H100: it costs a CTA an
// SM at zamba2's chunk (3 CTAs fit an SM with one buffer, 2 with two),
// and with one buffer mamba2's chunk (N 128) fits 2 CTAs an SM exactly;
// the other CTAs of an SM hide a chunk's loads. All four products are
// mma.sync m16n8k16 bf16 with f32 accumulation:
//   - C.B^T takes its bf16 operands as they are, so its products are
//     exact. Warp w owns row blocks w and 7 - w of the chunk (16 rows
//     each), which balances the causal triangle; tiles above the
//     diagonal are skipped.
//   - The masked weights w are made from the C.B^T accumulator fragments
//     in registers (the accumulator layout of two n8 tiles is the A
//     operand layout of one k16 step), as flash attention keeps its
//     probabilities: 16 columns of C.B^T at a time, each used at once
//     by the w.x product, so a warp holds one such tile, not a row.
//   - Operands the kernel computes in f32 -- w, h0 and x.coef -- enter as
//     a hi + lo pair of bf16 (two MMAs, ~16 bits of mantissa); none is
//     rounded once to bf16.
//   - y accumulates e^{s_i} (C.h0^T) first, scaled in the accumulator,
//     then the intra-chunk sum.
//   - The state: warp w owns rows [16w, 16w + 16) of h in f32 registers
//     for the whole sequence; after each update it writes the hi/lo bf16
//     copy that the next chunk's C.h0^T reads.
// P and N must be multiples of 8 (padded to 16 with zeros), Q at most
// 128 (padded to a multiple of 16; padded steps have dt = 0 and zero
// inputs, so they change nothing), P at most 64, N at most 128.
//
// f32 (ssd_scan_kernel_f32, 8 warps). f32 inputs are held to 1e-5
// against ssd_chunked, tighter than a bf16 pair (~2^-17) is sure to
// meet, so this instantiation keeps the products in f32 FMAs: the chunk
// staged in shared memory as f32, the weight matrix in row tiles of kTQ
// rows, each product a register-tiled loop over shared memory (a 16 x 16
// grid of threads, each owning an RM x RN tile of the output). The
// causal mask skips j > i and never takes exp there (e^{s_i - s_j}
// overflows for j > i, and inf * 0 is NaN); the intra-chunk products stop
// at the tile's last row. It serves the checks and the f32 configs only.
//
// C interface (bound with ctypes): the launcher returns the cudaError_t
// of the launch, 0 on success.

#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxDevices = 64;  // devices whose smem ceiling is recorded
constexpr int kMaxSmem = 232448;  // 227 KB, the most a CTA may ask for

// Sets a kernel's dynamic shared-memory ceiling once per device: `set`
// is the call site's own record.
template <typename Kernel>
cudaError_t smem_ceiling(Kernel kernel, bool* set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && set[dev])) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices) set[dev] = true;
  return err;
}

// One warp: s[j] = sum_{i <= j} dt[i] * a for j < Qp, four values a lane
// and a warp scan over 128 values at a time (dt[j] counts as 0 from Q
// on). Returns s[Q - 1] to every lane.
__device__ float warp_cumsum(const float* dt, float a, int Q, int Qp,
                             float* s) {
  const int lane = threadIdx.x % kWarp;
  float carry = 0.0f;
  for (int j0 = 0; j0 < Qp; j0 += 4 * kWarp) {
    float v[4];
    float run = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + 4 * lane + e;
      run = __fadd_rn(run, j < Q ? __fmul_rn(dt[j], a) : 0.0f);
      v[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const float up = __shfl_up_sync(0xFFFFFFFFu, incl, off);
      if (lane >= off) incl = __fadd_rn(incl, up);
    }
    float excl = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
    excl = __fadd_rn(carry, lane == 0 ? 0.0f : excl);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + 4 * lane + e;
      if (j < Qp) s[j] = __fadd_rn(excl, v[e]);
    }
    carry = __fadd_rn(carry, __shfl_sync(0xFFFFFFFFu, incl, kWarp - 1));
  }
  __syncwarp();
  return s[Q - 1];
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * kWarp;
constexpr int kTcMaxQ = 128;  // rows of a (padded) chunk
constexpr int kTcMaxP = 64;   // state rows: one 16-row block a warp

using bf16 = __nv_bfloat16;

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// Byte offsets of the bf16 kernel's shared memory (16-byte aligned
// regions): the chunk's x, B and C, the state's hi and lo bf16 copies,
// the chunk's dt and its cumsum s.
struct TcLayout {
  size_t x, b, c, hhi, hlo, dt, s, bytes;
  __host__ __device__ TcLayout(int Qp, int Pp, int Np) {
    const size_t xt = 2ull * Qp * Pp, bt = 2ull * Qp * Np,
                 ht = 2ull * Pp * Np, vt = 4ull * Qp;
    x = 0;
    b = x + xt;
    c = b + bt;
    hhi = c + bt;
    hlo = hhi + ht;
    dt = hlo + ht;
    s = dt + vt;
    bytes = s + vt;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of (row, col) in a tile of rows of R bf16 (R a multiple
// of 16): the 16-byte chunk index is XORed with the row, over as many
// low bits as the chunks of a row allow (at most 3), so the 8 rows an
// ldmatrix reads at one column fall in different banks.
__device__ __forceinline__ int swz(int row, int col, int R) {
  const int cpr = R >> 3;
  const int mask = min(8, cpr & -cpr) - 1;
  return row * R + ((((col >> 3) ^ (row & mask))) << 3) + (col & 7);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [0, Qp) of a tile of row length R from `src` (row stride
// `stride` elements): rows from `rows` on and columns from `cols` on are
// zero-filled.
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           size_t stride, int rows, int Qp,
                                           int cols, int R) {
  const int cpr = R >> 3;
  for (int i = threadIdx.x; i < Qp * cpr; i += kTcThreads) {
    const int r = i / cpr, c = i % cpr;
    const bool ok = r < rows && 8 * c < cols;
    cp_async16(dst + swz(r, 8 * c, R), ok ? src + r * stride + 8 * c : src,
               ok ? 16 : 0);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
// Not volatile: a pure function of its registers, which the compiler may
// schedule between the fragment loads.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
}

// (v0, v1) as a hi + lo pair of bf16x2: hi = bf16(v), lo = bf16(v - hi)
// (v - hi is exact in f32).
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(__fsub_rn(v0, hf.x),
                                    __fsub_rn(v1, hf.y)));
}

template <int kN>
__global__ void __launch_bounds__(kTcThreads)
    ssd_scan_kernel_tc(const bf16* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const bf16* __restrict__ Bm,
                       const bf16* __restrict__ Cm, bf16* __restrict__ y,
                       float* __restrict__ h_out, int L, int H, int P, int G,
                       int N, int Q) {
  static_assert(kN % 16 == 0 && kN <= 128, "N: 16..128");
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int Qp = round16(Q), Pp = round16(P);
  const TcLayout lay(Qp, Pp, kN);
  bf16* xc = reinterpret_cast<bf16*>(tc_smem + lay.x);
  bf16* bc = reinterpret_cast<bf16*>(tc_smem + lay.b);
  bf16* sc = reinterpret_cast<bf16*>(tc_smem + lay.c);
  bf16* hhi = reinterpret_cast<bf16*>(tc_smem + lay.hhi);
  bf16* hlo = reinterpret_cast<bf16*>(tc_smem + lay.hlo);
  float* dtc = reinterpret_cast<float*>(tc_smem + lay.dt);
  float* s = reinterpret_cast<float*>(tc_smem + lay.s);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;

  const int bh = blockIdx.x;
  const int b = bh / H, hd = bh % H;
  const int grp = hd / (H / G);
  const float a = A[hd];
  const int n_chunks = L / Q;
  const int g8 = lane >> 2, t2 = 2 * (lane & 3);  // fragment row, column
  const int lr = lane & 7, lm = lane >> 3;          // ldmatrix row, matrix

  const auto stage_xb = [&](int c) {
    const size_t row0 =
        static_cast<size_t>(b) * L + static_cast<size_t>(c) * Q;
    stage_tile(xc, x + (row0 * H + hd) * P, static_cast<size_t>(H) * P, Q,
               Qp, P, Pp);
    stage_tile(bc, Bm + (row0 * G + grp) * N, static_cast<size_t>(G) * N, Q,
               Qp, N, kN);
    for (int j = threadIdx.x; j < Qp; j += kTcThreads)
      cp_async4(dtc + j, dt + (row0 + (j < Q ? j : 0)) * H + hd,
                j < Q ? 4 : 0);
  };
  const auto stage_c = [&](int c) {
    const size_t row0 =
        static_cast<size_t>(b) * L + static_cast<size_t>(c) * Q;
    stage_tile(sc, Cm + (row0 * G + grp) * N, static_cast<size_t>(G) * N, Q,
               Qp, N, kN);
  };

  // warp w: row blocks w and nrb - 1 - w of each chunk; rows [16w, 16w+16)
  // of the state
  const int nrb = Qp / 16;
  const int p0 = 16 * warp;
  const bool owns_state = p0 < Pp;
  float hacc[kN / 8][4];
#pragma unroll
  for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) hacc[nt][e] = 0.0f;

  stage_xb(0);
  stage_c(0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c staged
    if (warp == 0) warp_cumsum(dtc, a, Q, Qp, s);
    __syncthreads();
    const float s_last = s[Q - 1];
    const size_t row0 =
        static_cast<size_t>(b) * L + static_cast<size_t>(c) * Q;

    // y, one 16-row block at a time
    for (int pass = 0; pass < 2; ++pass) {
      const int rb = pass == 0 ? warp : nrb - 1 - warp;
      if (warp >= (nrb + 1) / 2 || (pass == 1 && rb == warp)) break;
      const int i0 = 16 * rb;
      const int ia = i0 + g8, ib = ia + 8;
      const float sa = s[ia], sbv = s[ib];
      // the block's rows of C, as A fragments for every k step over N
      uint32_t cf[kN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        ldsm_x4(cf[kk], sc + swz(i0 + (lm & 1) * 8 + lr,
                                 16 * kk + (lm >> 1) * 8, kN));
      float yacc[kTcMaxP / 8][4];
#pragma unroll
      for (int nt = 0; nt < kTcMaxP / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[nt][e] = 0.0f;
      if (c > 0) {
        // e^{s_i} (C_i . h0^T), h0 as its hi + lo pair
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) {
#pragma unroll
          for (int q = 0; q < kTcMaxP / 16; ++q) {
            if (16 * q >= Pp) break;
            uint32_t fh[4], fl[4];
            const int at = swz(16 * q + (lm >> 1) * 8 + lr,
                               16 * kk + (lm & 1) * 8, kN);
            ldsm_x4(fh, hhi + at);
            ldsm_x4(fl, hlo + at);
            mma(yacc[2 * q], cf[kk], fh[0], fh[1]);
            mma(yacc[2 * q + 1], cf[kk], fh[2], fh[3]);
            mma(yacc[2 * q], cf[kk], fl[0], fl[1]);
            mma(yacc[2 * q + 1], cf[kk], fl[2], fl[3]);
          }
        }
        const float ea = __expf(sa), eb = __expf(sbv);
#pragma unroll
        for (int nt = 0; nt < kTcMaxP / 8; ++nt) {
          yacc[nt][0] = __fmul_rn(yacc[nt][0], ea);
          yacc[nt][1] = __fmul_rn(yacc[nt][1], ea);
          yacc[nt][2] = __fmul_rn(yacc[nt][2], eb);
          yacc[nt][3] = __fmul_rn(yacc[nt][3], eb);
        }
      }
      // + sum_j w_ij x_j over the column tiles up to the diagonal, 16
      // columns at a time: C.B^T of the tile, its weights w_ij =
      // [j <= i < Q] e^{s_i - s_j} (C_i . B_j) dt_j in the accumulator,
      // then w as its hi + lo pair times x
#pragma unroll
      for (int jp = 0; jp < kTcMaxQ / 16; ++jp) {
        if (jp > rb) break;
        float g[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) {
          uint32_t bf[4];
          ldsm_x4(bf, bc + swz(16 * jp + (lm >> 1) * 8 + lr,
                               16 * kk + (lm & 1) * 8, kN));
          mma(g[0], cf[kk], bf[0], bf[1]);
          mma(g[1], cf[kk], bf[2], bf[3]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 16 * jp + 8 * h + t2 + e;
            const float sj = s[j], dj = dtc[j];
            g[h][e] = j <= ia && ia < Q
                          ? __fmul_rn(
                                __fmul_rn(__expf(__fsub_rn(sa, sj)), g[h][e]),
                                dj)
                          : 0.0f;
            g[h][2 + e] =
                j <= ib && ib < Q
                    ? __fmul_rn(
                          __fmul_rn(__expf(__fsub_rn(sbv, sj)), g[h][2 + e]),
                          dj)
                    : 0.0f;
          }
        uint32_t ah[4], al[4];
        split(g[0][0], g[0][1], ah[0], al[0]);
        split(g[0][2], g[0][3], ah[1], al[1]);
        split(g[1][0], g[1][1], ah[2], al[2]);
        split(g[1][2], g[1][3], ah[3], al[3]);
#pragma unroll
        for (int q = 0; q < kTcMaxP / 16; ++q) {
          if (16 * q >= Pp) break;
          uint32_t xf[4];
          ldsm_x4_t(xf, xc + swz(16 * jp + (lm & 1) * 8 + lr,
                                 16 * q + (lm >> 1) * 8, Pp));
          mma(yacc[2 * q], ah, xf[0], xf[1]);
          mma(yacc[2 * q + 1], ah, xf[2], xf[3]);
          mma(yacc[2 * q], al, xf[0], xf[1]);
          mma(yacc[2 * q + 1], al, xf[2], xf[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kTcMaxP / 8; ++nt) {
        const int p = 8 * nt + t2;
        if (p >= P) break;
        if (ia < Q)
          *reinterpret_cast<__nv_bfloat162*>(y + ((row0 + ia) * H + hd) * P +
                                             p) =
              __floats2bfloat162_rn(yacc[nt][0], yacc[nt][1]);
        if (ib < Q)
          *reinterpret_cast<__nv_bfloat162*>(y + ((row0 + ib) * H + hd) * P +
                                             p) =
              __floats2bfloat162_rn(yacc[nt][2], yacc[nt][3]);
      }
    }
    __syncthreads();  // every warp is done with C and with h0's copy
    if (c + 1 < n_chunks) {
      stage_c(c + 1);
      cp_async_commit();
    }

    // h' = e^{s_Q} h0 + sum_j (x_j coef_j) (x) B_j, x.coef as hi + lo
    if (owns_state) {
      const float decay = __expf(s_last);
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hacc[nt][e] = __fmul_rn(decay, hacc[nt][e]);
#pragma unroll
      for (int kk = 0; kk < kTcMaxQ / 16; ++kk) {
        if (16 * kk >= Qp) break;
        uint32_t xf[4], ah[4], al[4];
        ldsm_x4_t(xf, xc + swz(16 * kk + (lm >> 1) * 8 + lr,
                               p0 + (lm & 1) * 8, Pp));
        // coef_j = dt_j e^{s_Q - s_j} at this lane's steps j
        float2 ca, cb;
        const int ja = 16 * kk + t2, jb = ja + 8;
        ca.x = __fmul_rn(dtc[ja], __expf(__fsub_rn(s_last, s[ja])));
        ca.y = __fmul_rn(dtc[ja + 1], __expf(__fsub_rn(s_last, s[ja + 1])));
        cb.x = __fmul_rn(dtc[jb], __expf(__fsub_rn(s_last, s[jb])));
        cb.y = __fmul_rn(dtc[jb + 1], __expf(__fsub_rn(s_last, s[jb + 1])));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 v = unpack(xf[r]);
          const float2 cv = r < 2 ? ca : cb;
          split(__fmul_rn(v.x, cv.x), __fmul_rn(v.y, cv.y), ah[r], al[r]);
        }
#pragma unroll
        for (int q = 0; q < kN / 16; ++q) {
          uint32_t bf[4];
          ldsm_x4_t(bf, bc + swz(16 * kk + (lm & 1) * 8 + lr,
                                 16 * q + (lm >> 1) * 8, kN));
          mma(hacc[2 * q], ah, bf[0], bf[1]);
          mma(hacc[2 * q + 1], ah, bf[2], bf[3]);
          mma(hacc[2 * q], al, bf[0], bf[1]);
          mma(hacc[2 * q + 1], al, bf[2], bf[3]);
        }
      }
      // the hi/lo copy that the next chunk's C.h0^T reads
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
        uint32_t h0, l0, h1, l1;
        split(hacc[nt][0], hacc[nt][1], h0, l0);
        split(hacc[nt][2], hacc[nt][3], h1, l1);
        const int ata = swz(p0 + g8, 8 * nt + t2, kN);
        const int atb = swz(p0 + g8 + 8, 8 * nt + t2, kN);
        *reinterpret_cast<uint32_t*>(hhi + ata) = h0;
        *reinterpret_cast<uint32_t*>(hlo + ata) = l0;
        *reinterpret_cast<uint32_t*>(hhi + atb) = h1;
        *reinterpret_cast<uint32_t*>(hlo + atb) = l1;
      }
    }
    __syncthreads();  // every warp is done with x, B, dt and s
    if (c + 1 < n_chunks) {
      stage_xb(c + 1);
      cp_async_commit();
    }
  }

  if (h_out != nullptr && owns_state) {
    float* out = h_out + static_cast<size_t>(bh) * P * N;
    const int pa = p0 + g8, pb = pa + 8;
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
      const int n = 8 * nt + t2;
      if (n >= N) break;
      if (pa < P)
        *reinterpret_cast<float2*>(out + pa * N + n) =
            make_float2(hacc[nt][0], hacc[nt][1]);
      if (pb < P)
        *reinterpret_cast<float2*>(out + pb * N + n) =
            make_float2(hacc[nt][2], hacc[nt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMAs
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kGrid = 16;  // threads per side of the 16 x 16 tile grid
constexpr int kTQ = 32;    // rows of the weight matrix built at once

// out(m, n) = sum_{k < K1} a1(m, k) b1(k, n) and, beside it,
// out2(m, n) = sum_{k < K2} a2(m, k) b2(k, n) (K2 = 0 for one product),
// over an M x Nn output tiled over the CTA: thread (tm, tn) of the 16 x 16
// grid owns rows m0 + tm + 16 r (r < RM) and columns n0 + tn + 16 c
// (c < RN) of each (16 RM) x (16 RN) block. Rows and columns past the edge
// read a clamped index (a valid address) and are not handed to
// `epi(m, n, out, out2)`.
template <int RM, int RN, class FA1, class FB1, class FA2, class FB2,
          class Epi>
__device__ __forceinline__ void tile_products(int M, int Nn, int K1, FA1 a1,
                                              FB1 b1, int K2, FA2 a2, FB2 b2,
                                              Epi epi) {
  const int tm = threadIdx.x / kGrid, tn = threadIdx.x % kGrid;
  for (int m0 = 0; m0 < M; m0 += kGrid * RM) {
    for (int n0 = 0; n0 < Nn; n0 += kGrid * RN) {
      int mi[RM], ni[RN];
#pragma unroll
      for (int r = 0; r < RM; ++r) mi[r] = min(m0 + tm + kGrid * r, M - 1);
#pragma unroll
      for (int c = 0; c < RN; ++c) ni[c] = min(n0 + tn + kGrid * c, Nn - 1);
      float acc[RM][RN], acc2[RM][RN];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) acc[r][c] = acc2[r][c] = 0.0f;
      for (int k = 0; k < K1; ++k) {
        float av[RM], bv[RN];
#pragma unroll
        for (int r = 0; r < RM; ++r) av[r] = a1(mi[r], k);
#pragma unroll
        for (int c = 0; c < RN; ++c) bv[c] = b1(k, ni[c]);
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int c = 0; c < RN; ++c)
            acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
      for (int k = 0; k < K2; ++k) {
        float av[RM], bv[RN];
#pragma unroll
        for (int r = 0; r < RM; ++r) av[r] = a2(mi[r], k);
#pragma unroll
        for (int c = 0; c < RN; ++c) bv[c] = b2(k, ni[c]);
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int c = 0; c < RN; ++c)
            acc2[r][c] = fmaf(av[r], bv[c], acc2[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) {
          const int m = m0 + tm + kGrid * r, n = n0 + tn + kGrid * c;
          if (m < M && n < Nn) epi(m, n, acc[r][c], acc2[r][c]);
        }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel_f32(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm, float* __restrict__ y,
                        float* __restrict__ h_out, int L, int H, int P, int G,
                        int N, int Q) {
  extern __shared__ float smem[];
  const int sn = N + 1;                  // padded row of B, C and h
  float* h = smem;                       // [P][sn]   the carried state
  float* sb = h + P * sn;                // [Q][sn]   B of the chunk
  float* sc = sb + Q * sn;               // [Q][sn]   C of the chunk
  float* sx = sc + Q * sn;               // [Q][P]    x of the chunk
  float* sw = sx + Q * P;                // [kTQ][Q]  a row tile of weights
  float* s = sw + kTQ * Q;               // [Q]       cumsum of dt * a
  float* sdt = s + Q;                    // [Q]       dt
  float* coef = sdt + Q;                 // [Q]       dt_j e^{s_Q - s_j}

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, hd = bh % H;
  const int g = hd / (H / G);
  const float a = A[hd];
  const auto none = [](int, int) { return 0.0f; };  // no second product

  for (int i = tid; i < P * sn; i += kThreads) h[i] = 0.0f;

  for (int c0 = 0; c0 < L; c0 += Q) {
    const size_t row0 = static_cast<size_t>(b) * L + c0;  // (b, c0) row
    for (int i = tid; i < Q * P; i += kThreads) {
      const int j = i / P, p = i % P;
      sx[i] = x[((row0 + j) * H + hd) * P + p];
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int j = i / N, n = i % N;
      const size_t at = ((row0 + j) * G + g) * N + n;
      sb[j * sn + n] = Bm[at];
      sc[j * sn + n] = Cm[at];
    }
    for (int j = tid; j < Q; j += kThreads) sdt[j] = dt[(row0 + j) * H + hd];
    __syncthreads();
    if (tid < kWarp) warp_cumsum(sdt, a, Q, Q, s);
    __syncthreads();
    const float s_last = s[Q - 1];
    for (int j = tid; j < Q; j += kThreads)
      coef[j] = __fmul_rn(sdt[j], expf(s_last - s[j]));

    // y, kTQ rows at a time: the row tile of weights, then its products
    for (int i0 = 0; i0 < Q; i0 += kTQ) {
      const int rows = min(kTQ, Q - i0);
      const int cols = i0 + rows;  // columns j <= the tile's last row
      // sw[ii, j] = [j <= i] e^{s_i - s_j} (C_i . B_j) dt_j, i = i0 + ii
      tile_products<2, 8>(
          rows, cols, N,
          [&](int ii, int n) { return sc[(i0 + ii) * sn + n]; },
          [&](int n, int j) { return sb[j * sn + n]; }, 0, none, none,
          [&](int ii, int j, float gij, float) {
            const int i = i0 + ii;
            sw[ii * Q + j] =
                j <= i ? __fmul_rn(__fmul_rn(expf(s[i] - s[j]), gij), sdt[j])
                       : 0.0f;
          });
      __syncthreads();
      // y_i = sum_{j <= i} sw[ii, j] x_j + e^{s_i} (C_i . h0^T); sw is 0
      // above the diagonal, so the sum runs over the tile's columns
      tile_products<2, 4>(
          rows, P, cols, [&](int ii, int j) { return sw[ii * Q + j]; },
          [&](int j, int p) { return sx[j * P + p]; }, N,
          [&](int ii, int n) { return sc[(i0 + ii) * sn + n]; },
          [&](int n, int p) { return h[p * sn + n]; },
          [&](int ii, int p, float intra, float inter) {
            const int i = i0 + ii;
            y[((row0 + i) * H + hd) * P + p] =
                __fadd_rn(intra, __fmul_rn(expf(s[i]), inter));
          });
      __syncthreads();  // sw is rewritten by the next tile
    }

    // h' = e^{s_Q} h0 + sum_j (x_j coef_j) (x) B_j
    for (int i = tid; i < Q * P; i += kThreads)
      sx[i] = __fmul_rn(sx[i], coef[i / P]);
    __syncthreads();
    const float decay = expf(s_last);
    tile_products<4, 4>(
        P, N, Q, [&](int p, int j) { return sx[j * P + p]; },
        [&](int j, int n) { return sb[j * sn + n]; }, 0, none, none,
        [&](int p, int n, float v, float) {
          h[p * sn + n] = __fadd_rn(__fmul_rn(decay, h[p * sn + n]), v);
        });
    __syncthreads();  // the next chunk overwrites sx, sb, sc
  }

  if (h_out != nullptr) {
    float* out = h_out + static_cast<size_t>(bh) * P * N;
    for (int i = tid; i < P * N; i += kThreads)
      out[i] = h[(i / N) * sn + i % N];
  }
}

// Dynamic shared memory of the f32 kernel, in bytes: h [P][N+1], B and C
// [Q][N+1], x [Q][P], a weight row tile [kTQ][Q] and three [Q] vectors.
size_t f32_smem_bytes(int P, int N, int Q) {
  const size_t sn = static_cast<size_t>(N) + 1;
  return sizeof(float) *
         (P * sn + 2 * Q * sn + static_cast<size_t>(Q) * P +
          static_cast<size_t>(kTQ) * Q + 3 * static_cast<size_t>(Q));
}

template <int kN>
cudaError_t launch_tc(const void* x, const void* dt, const void* A,
                      const void* Bm, const void* Cm, void* y, void* h_out,
                      int batch, int L, int H, int P, int G, int N, int Q,
                      size_t bytes, cudaStream_t st) {
  static bool set[kMaxDevices] = {};
  const cudaError_t err = smem_ceiling(ssd_scan_kernel_tc<kN>, set);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel_tc<kN><<<batch * H, kTcThreads, bytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<bf16*>(y),
      static_cast<float*>(h_out), L, H, P, G, N, Q);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The backward: f32 FMAs (ssd_scan_bwd_kernel, ssd_bwd_reduce_kernel)
// ---------------------------------------------------------------------------
//
// Replaces no TPU kernel: the reference has no VJP for its Pallas scan and
// trains through XLA's autodiff of ssd_chunked (repro/models/mamba2.py,
// _ssd). Computes, to float tolerance, the plain torch version
// repro_torch/models/mamba2.py::ssd_chunked_bwd, whose docstring gives the
// formulas: for a cotangent dy of y (from a zero initial state), dx, ddt,
// dA, dB and dC.
//
// One CTA per (b, h), 8 warps, everything in f32 FMAs (tile_products):
//   pass 1 walks the chunks in order and writes the state entering each
//     to an f32 scratch [B, H, L/Q, P, N] (the state kept in shared
//     memory, as the f32 forward keeps it);
//   pass 2 walks them in reverse with dh [P, N] in shared memory. Per
//     chunk x, dy, B and C are staged in their own dtype, and the Q x Q
//     products G = C.B^T and D = dy.x^T are built kBT rows or columns at
//     a time, twice: a column sweep (kBT columns j, rows i >= j) gives dx
//     and dB of those columns and m_j = sum_i E G D, a row sweep (kBT rows
//     i, columns j <= i) gives dC and sum_j T_ij of those rows. Then one
//     warp forms ds, its reverse cumsum dda, ddt and the chunk's share of
//     dA, and the block updates dh.
// dB and dC are written per head as f32 partials [B, L, H, N], and dA per
// (b, h); ssd_bwd_reduce_kernel then sums the heads of each group (and dA
// over the batch) in a fixed order. No float atomics: the result is the
// same from run to run.
//
// What bounds it: the operations. Per chunk the two sweeps build G and D
// twice over the causal triangle and form dx, dB, dC over it, plus five
// [P, N] x Q products (the state, the three inter-chunk terms, dh): in
// f32 FMAs at 67 TF/s this is several times the bytes' time (PERF.md
// section 6, row 5b). The design is the simple one: tensor cores, wgmma
// and TMA wait for a later pass (ROADMAP Queue 2).

constexpr int kBT = 32;          // rows or columns of a Q x Q tile at once
constexpr int kBwdVecs = 10;     // [Q] vectors of the chunk
constexpr int kWarps = kThreads / kWarp;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  return v;
}

// One warp: v[k] <- sum_{i >= k} v[i] for k < n (a reverse inclusive
// scan, in place: a lane writes only the entries it read).
__device__ void warp_rcumsum(float* v, int n) {
  const int lane = threadIdx.x % kWarp;
  float carry = 0.0f;
  for (int r0 = 0; r0 < n; r0 += 4 * kWarp) {
    float run[4];
    float acc = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 4 * lane + e;  // r-th entry from the end
      acc += r < n ? v[n - 1 - r] : 0.0f;
      run[e] = acc;
    }
    float incl = acc;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const float up = __shfl_up_sync(0xFFFFFFFFu, incl, off);
      if (lane >= off) incl += up;
    }
    float excl = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
    excl = carry + (lane == 0 ? 0.0f : excl);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 4 * lane + e;
      if (r < n) v[n - 1 - r] = excl + run[e];
    }
    carry += __shfl_sync(0xFFFFFFFFu, incl, kWarp - 1);
  }
  __syncwarp();
}

// Shared memory of the backward: f32 first (dh [P][N+1], three tile
// regions of `rs` floats, the chunk's vectors, the block sum's per-warp
// slots), then x, dy [Q][P+1] and B, C [Q][N+1] in the inputs' dtype. A
// tile region holds a column tile [Q][kBT+1] or a row tile [kBT][Q+1],
// or [kBT][max(P, N)+1] of a sweep's side product.
struct BwdLayout {
  size_t dh, r1, r2, r3, vec, red, nf;  // in floats
  size_t x, dy, b, c, nt;               // in elements of the inputs' dtype
  size_t rs, bytes;
  __host__ __device__ BwdLayout(int Q, int P, int N, size_t esize) {
    const size_t sp = P + 1, sn = N + 1;
    const int most = Q > N ? (Q > P ? Q : P) : (N > P ? N : P);
    const size_t col_tile = static_cast<size_t>(Q) * (kBT + 1);
    const size_t row_tile = static_cast<size_t>(kBT) * (most + 1);
    rs = col_tile > row_tile ? col_tile : row_tile;
    dh = 0;
    r1 = dh + P * sn;
    r2 = r1 + rs;
    r3 = r2 + rs;
    vec = r3 + rs;
    red = vec + static_cast<size_t>(kBwdVecs) * Q;
    nf = red + kWarps;
    x = 0;
    dy = x + Q * sp;
    b = dy + Q * sp;
    c = b + Q * sn;
    nt = c + Q * sn;
    bytes = 4 * nf + esize * nt;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A, const T* __restrict__ Bm,
                        const T* __restrict__ Cm, const T* __restrict__ dy,
                        T* __restrict__ dx, float* __restrict__ ddt,
                        float* __restrict__ dB_part,
                        float* __restrict__ dC_part,
                        float* __restrict__ dA_part, float* states, int L,
                        int H, int P, int G, int N, int Q) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const BwdLayout lay(Q, P, N, sizeof(T));
  float* f = reinterpret_cast<float*>(bwd_smem);
  float* dh = f + lay.dh;   // [P][sn]: the state in pass 1, dh in pass 2
  float* r1 = f + lay.r1;
  float* r2 = f + lay.r2;
  float* r3 = f + lay.r3;
  float* sdt = f + lay.vec;  // dt
  float* s = sdt + Q;        // cumsum of dt * a
  float* es = s + Q;         // e^{s_i}
  float* ex = es + Q;        // e^{s_Q - s_j}
  float* coef = ex + Q;      // dt_j e^{s_Q - s_j}
  float* rowt = coef + Q;    // sum_j T_ij
  float* mv = rowt + Q;      // m_j = sum_i E_ij G_ij D_ij
  float* uv = mv + Q;        // u_j = e^{s_Q - s_j} x_j . (B_j dh^T)
  float* rv = uv + Q;        // r_i = C_i . (dy_i h0)
  float* dsv = rv + Q;       // ds, then dda
  float* red = f + lay.red;  // the block sum's per-warp slots
  T* sx = reinterpret_cast<T*>(bwd_smem + 4 * lay.nf) + lay.x;
  T* sdy = reinterpret_cast<T*>(bwd_smem + 4 * lay.nf) + lay.dy;
  T* sb = reinterpret_cast<T*>(bwd_smem + 4 * lay.nf) + lay.b;
  T* sc = reinterpret_cast<T*>(bwd_smem + 4 * lay.nf) + lay.c;
  const int sp = P + 1, sn = N + 1;

  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int bh = blockIdx.x;
  const int b = bh / H, hd = bh % H;
  const int g = hd / (H / G);
  const float a = A[hd];
  const int nc = L / Q;
  float* st = states + static_cast<size_t>(bh) * nc * P * N;
  const auto none = [](int, int) { return 0.0f; };  // no second product

  // chunk c's x, B and dt (and dy, C with `all`), its cumsum and the
  // vectors made from it
  const auto load = [&](int c, bool all) {
    const size_t row0 =
        static_cast<size_t>(b) * L + static_cast<size_t>(c) * Q;
    for (int i = tid; i < Q * P; i += kThreads) {
      const int j = i / P, p = i % P;
      const size_t at = ((row0 + j) * H + hd) * P + p;
      sx[j * sp + p] = x[at];
      if (all) sdy[j * sp + p] = dy[at];
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int j = i / N, n = i % N;
      const size_t at = ((row0 + j) * G + g) * N + n;
      sb[j * sn + n] = Bm[at];
      if (all) sc[j * sn + n] = Cm[at];
    }
    for (int j = tid; j < Q; j += kThreads) sdt[j] = dt[(row0 + j) * H + hd];
    __syncthreads();
    if (tid < kWarp) warp_cumsum(sdt, a, Q, Q, s);
    __syncthreads();
    const float s_last = s[Q - 1];
    for (int j = tid; j < Q; j += kThreads) {
      ex[j] = expf(s_last - s[j]);
      coef[j] = sdt[j] * ex[j];
      es[j] = expf(s[j]);
    }
    __syncthreads();
  };

  // pass 1: the state entering each chunk, to the scratch
  for (int i = tid; i < P * sn; i += kThreads) dh[i] = 0.0f;
  for (int c = 0; c < nc; ++c) {
    __syncthreads();  // the last update of the state is done
    float* out = st + static_cast<size_t>(c) * P * N;
    for (int i = tid; i < P * N; i += kThreads)
      out[i] = dh[(i / N) * sn + i % N];
    if (c == nc - 1) break;  // the state leaving the last is not needed
    load(c, false);
    const float decay = expf(s[Q - 1]);
    tile_products<4, 4>(
        P, N, Q,
        [&](int p, int j) { return to_f(sx[j * sp + p]) * coef[j]; },
        [&](int j, int n) { return to_f(sb[j * sn + n]); }, 0, none, none,
        [&](int p, int n, float v, float) {
          dh[p * sn + n] = decay * dh[p * sn + n] + v;
        });
  }

  // pass 2: the chunks in reverse, dh carried
  __syncthreads();  // pass 1's scratch written, its last copy of h read
  for (int i = tid; i < P * sn; i += kThreads) dh[i] = 0.0f;
  float dA_acc = 0.0f;  // thread 0's sum over the chunks
  for (int c = nc - 1; c >= 0; --c) {
    __syncthreads();  // dh updated; the last chunk's operands read
    load(c, true);
    const float* h0 = st + static_cast<size_t>(c) * P * N;
    const size_t row0 =
        static_cast<size_t>(b) * L + static_cast<size_t>(c) * Q;
    const float s_last = s[Q - 1];

    // column sweep: dx, dB and m for kBT columns j at a time, rows i >= j
    for (int j0 = 0; j0 < Q; j0 += kBT) {
      const int cols = min(kBT, Q - j0), rows = Q - j0;
      const int tw = kBT + 1;  // r1..r3[ii * tw + jj], i = j0 + ii
      // r1 = E dt_j G (W), r2 = E dt_j D (V), r3 = E G D
      tile_products<2, 2>(
          rows, cols, N,
          [&](int ii, int n) { return to_f(sc[(j0 + ii) * sn + n]); },
          [&](int n, int jj) { return to_f(sb[(j0 + jj) * sn + n]); }, P,
          [&](int ii, int p) { return to_f(sdy[(j0 + ii) * sp + p]); },
          [&](int p, int jj) { return to_f(sx[(j0 + jj) * sp + p]); },
          [&](int ii, int jj, float gij, float dij) {
            float w = 0.0f, v = 0.0f, m = 0.0f;
            if (jj <= ii) {
              const float e = expf(s[j0 + ii] - s[j0 + jj]);
              const float edt = e * sdt[j0 + jj];
              w = edt * gij;
              v = edt * dij;
              m = e * gij * dij;
            }
            r1[ii * tw + jj] = w;
            r2[ii * tw + jj] = v;
            r3[ii * tw + jj] = m;
          });
      __syncthreads();
      for (int jj = warp; jj < cols; jj += kWarps) {
        float acc = 0.0f;
        for (int ii = lane; ii < rows; ii += kWarp) acc += r3[ii * tw + jj];
        acc = warp_sum(acc);
        if (lane == 0) mv[j0 + jj] = acc;
      }
      __syncthreads();  // r3 now takes B_j dh^T [kBT][P+1]
      // dx_j = sum_i W_ij dy_i + coef_j (B_j dh^T)
      tile_products<2, 4>(
          cols, P, rows, [&](int jj, int ii) { return r1[ii * tw + jj]; },
          [&](int ii, int p) { return to_f(sdy[(j0 + ii) * sp + p]); }, N,
          [&](int jj, int n) { return to_f(sb[(j0 + jj) * sn + n]); },
          [&](int n, int p) { return dh[p * sn + n]; },
          [&](int jj, int p, float intra, float bd) {
            const int j = j0 + jj;
            dx[((row0 + j) * H + hd) * P + p] =
                from_f<T>(intra + coef[j] * bd);
            r3[jj * sp + p] = bd;
          });
      // dB_j = sum_i V_ij C_i + coef_j (x_j dh), this head's share
      tile_products<2, 4>(
          cols, N, rows, [&](int jj, int ii) { return r2[ii * tw + jj]; },
          [&](int ii, int n) { return to_f(sc[(j0 + ii) * sn + n]); }, P,
          [&](int jj, int p) { return to_f(sx[(j0 + jj) * sp + p]); },
          [&](int p, int n) { return dh[p * sn + n]; },
          [&](int jj, int n, float intra, float xd) {
            const int j = j0 + jj;
            dB_part[((row0 + j) * H + hd) * N + n] = intra + coef[j] * xd;
          });
      __syncthreads();
      for (int jj = warp; jj < cols; jj += kWarps) {
        float acc = 0.0f;
        for (int p = lane; p < P; p += kWarp)
          acc += to_f(sx[(j0 + jj) * sp + p]) * r3[jj * sp + p];
        acc = warp_sum(acc);
        if (lane == 0) uv[j0 + jj] = ex[j0 + jj] * acc;
      }
      __syncthreads();  // the next tile rewrites r1..r3
    }

    // row sweep: dC and sum_j T_ij for kBT rows i at a time, columns j <= i
    for (int i0 = 0; i0 < Q; i0 += kBT) {
      const int rows = min(kBT, Q - i0), cols = i0 + rows;
      const int tq = Q + 1;  // r1, r2[ii * tq + j], i = i0 + ii
      // r1 = E dt_j D (V), r2 = E dt_j G D (T)
      tile_products<2, 2>(
          rows, cols, N,
          [&](int ii, int n) { return to_f(sc[(i0 + ii) * sn + n]); },
          [&](int n, int j) { return to_f(sb[j * sn + n]); }, P,
          [&](int ii, int p) { return to_f(sdy[(i0 + ii) * sp + p]); },
          [&](int p, int j) { return to_f(sx[j * sp + p]); },
          [&](int ii, int j, float gij, float dij) {
            float v = 0.0f, t = 0.0f;
            if (j <= i0 + ii) {
              v = expf(s[i0 + ii] - s[j]) * sdt[j] * dij;
              t = v * gij;
            }
            r1[ii * tq + j] = v;
            r2[ii * tq + j] = t;
          });
      __syncthreads();
      for (int ii = warp; ii < rows; ii += kWarps) {
        float acc = 0.0f;
        for (int j = lane; j < cols; j += kWarp) acc += r2[ii * tq + j];
        acc = warp_sum(acc);
        if (lane == 0) rowt[i0 + ii] = acc;
      }
      __syncthreads();  // r2 now takes dy_i h0 [kBT][N+1]
      // dC_i = sum_j V_ij B_j + e^{s_i} (dy_i h0), this head's share
      tile_products<2, 4>(
          rows, N, cols, [&](int ii, int j) { return r1[ii * tq + j]; },
          [&](int j, int n) { return to_f(sb[j * sn + n]); }, P,
          [&](int ii, int p) { return to_f(sdy[(i0 + ii) * sp + p]); },
          [&](int p, int n) { return h0[p * N + n]; },
          [&](int ii, int n, float intra, float dhv) {
            const int i = i0 + ii;
            dC_part[((row0 + i) * H + hd) * N + n] = intra + es[i] * dhv;
            r2[ii * sn + n] = dhv;
          });
      __syncthreads();
      for (int ii = warp; ii < rows; ii += kWarps) {
        float acc = 0.0f;
        for (int n = lane; n < N; n += kWarp)
          acc += to_f(sc[(i0 + ii) * sn + n]) * r2[ii * sn + n];
        acc = warp_sum(acc);
        if (lane == 0) rv[i0 + ii] = acc;
      }
      __syncthreads();
    }

    // <h0, dh>, summed in a fixed order
    float part = 0.0f;
    for (int i = tid; i < P * N; i += kThreads)
      part += h0[i] * dh[(i / N) * sn + i % N];
    part = warp_sum(part);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    if (warp == 0) {
      float hdot = 0.0f;
      for (int w = 0; w < kWarps; ++w) hdot += red[w];
      float su = 0.0f;
      for (int j = lane; j < Q; j += kWarp) su += sdt[j] * uv[j];
      su = warp_sum(su);
      for (int i = lane; i < Q; i += kWarp) {
        float v = rowt[i] - sdt[i] * mv[i] + es[i] * rv[i] - sdt[i] * uv[i];
        if (i == Q - 1) v += expf(s_last) * hdot + su;
        dsv[i] = v;
      }
      __syncwarp();
      warp_rcumsum(dsv, Q);
      float da = 0.0f;
      for (int j = lane; j < Q; j += kWarp) {
        ddt[(row0 + j) * H + hd] = a * dsv[j] + mv[j] + uv[j];
        da += sdt[j] * dsv[j];
      }
      da = warp_sum(da);
      if (lane == 0) dA_acc += da;
    }
    if (c == 0) break;
    __syncthreads();  // the block sum read dh
    // dh <- e^{s_Q} dh + sum_i e^{s_i} dy_i (x) C_i
    const float decay = expf(s_last);
    tile_products<4, 4>(
        P, N, Q, [&](int p, int i) { return es[i] * to_f(sdy[i * sp + p]); },
        [&](int i, int n) { return to_f(sc[i * sn + n]); }, 0, none, none,
        [&](int p, int n, float v, float) {
          dh[p * sn + n] = decay * dh[p * sn + n] + v;
        });
  }
  if (tid == 0) dA_part[bh] = dA_acc;
}

// dBm, dCm [B, L, G, N] = the heads of each group of the partials
// [B, L, H, N] summed in order; dA [H] = dA_part [B, H] summed over b.
template <typename T>
__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ dB_part,
                                      const float* __restrict__ dC_part,
                                      const float* __restrict__ dA_part,
                                      T* __restrict__ dBm,
                                      T* __restrict__ dCm,
                                      float* __restrict__ dA, int batch,
                                      int L, int H, int G, int N) {
  const int rep = H / G;
  const size_t n_bc = static_cast<size_t>(batch) * L * G * N;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_bc + H; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    if (i < n_bc) {
      const size_t n = i % N, lg = i / N;
      const size_t grp = lg % G, bl = lg / G;
      const size_t at = (bl * H + grp * rep) * N + n;
      float sb = 0.0f, sc = 0.0f;
      for (int k = 0; k < rep; ++k) {
        sb += dB_part[at + static_cast<size_t>(k) * N];
        sc += dC_part[at + static_cast<size_t>(k) * N];
      }
      dBm[i] = from_f<T>(sb);
      dCm[i] = from_f<T>(sc);
    } else {
      const int h = static_cast<int>(i - n_bc);
      float sa = 0.0f;
      for (int bb = 0; bb < batch; ++bb) sa += dA_part[bb * H + h];
      dA[h] = sa;
    }
  }
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* dy,
                       void* dx, void* ddt, void* dBm, void* dCm, void* dA,
                       void* dB_part, void* dC_part, void* dA_part,
                       void* states, int batch, int L, int H, int P, int G,
                       int N, int Q, size_t bytes, cudaStream_t st) {
  static bool set[kMaxDevices] = {};
  cudaError_t err = smem_ceiling(ssd_scan_bwd_kernel<T>, set);
  if (err != cudaSuccess) return err;
  ssd_scan_bwd_kernel<T><<<batch * H, kThreads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dB_part), static_cast<float*>(dC_part),
      static_cast<float*>(dA_part), static_cast<float*>(states), L, H, P, G,
      N, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t work = static_cast<size_t>(batch) * L * G * N + H;
  const int blocks = static_cast<int>(
      std::min<size_t>((work + kThreads - 1) / kThreads, 132 * 16));
  ssd_bwd_reduce_kernel<T><<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(dB_part), static_cast<const float*>(dC_part),
      static_cast<const float*>(dA_part), static_cast<T*>(dBm),
      static_cast<T*>(dCm), static_cast<float*>(dA), batch, L, H, G, N);
  return cudaGetLastError();
}

}  // namespace

// CTAs of the kernel that one SM holds at once for these sizes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1.
extern "C" int ssd_scan_resident_ctas(int P, int N, int Q, int dtype) {
  int ctas = -1;
  cudaError_t err;
  if (dtype == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, ssd_scan_kernel_f32, kThreads, f32_smem_bytes(P, N, Q));
  } else {
    const int Qp = round16(Q), Pp = round16(P), Np = round16(N);
    const size_t bytes = TcLayout(Qp, Pp, Np).bytes;
    switch (Np) {
      case 16:
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &ctas, ssd_scan_kernel_tc<16>, kTcThreads, bytes);
        break;
      case 32:
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &ctas, ssd_scan_kernel_tc<32>, kTcThreads, bytes);
        break;
      case 64:
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &ctas, ssd_scan_kernel_tc<64>, kTcThreads, bytes);
        break;
      case 128:
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &ctas, ssd_scan_kernel_tc<128>, kTcThreads, bytes);
        break;
      default:
        err = cudaErrorInvalidValue;
    }
  }
  return err == cudaSuccess ? ctas : -1;
}

// dtype: 0 = f32, 1 = bf16 (x, Bm, Cm and y); dt and A are f32; h_out is
// f32 [B, H, P, N] or null. smem_bytes is the wrapper's sum
// (ssd_scan.py::smem_bytes); a launch whose sizes or bytes this kernel
// does not take is refused.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* h_out, int batch, int L, int H, int P,
                               int G, int N, int Q, int dtype,
                               int smem_bytes, void* stream) {
  auto* st = static_cast<cudaStream_t>(stream);
  if (Q < 1 || L % Q || G < 1 || H % G || smem_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    const size_t bytes = f32_smem_bytes(P, N, Q);
    if (bytes != static_cast<size_t>(smem_bytes) || bytes > kMaxSmem)
      return static_cast<int>(cudaErrorInvalidValue);
    static bool set[kMaxDevices] = {};
    const cudaError_t err = smem_ceiling(ssd_scan_kernel_f32, set);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_scan_kernel_f32<<<batch * H, kThreads, bytes, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), static_cast<float*>(y),
        static_cast<float*>(h_out), L, H, P, G, N, Q);
    return static_cast<int>(cudaGetLastError());
  }
  const int Qp = round16(Q), Pp = round16(P), Np = round16(N);
  const size_t bytes = TcLayout(Qp, Pp, Np).bytes;
  if (dtype != 1 || P % 8 || N % 8 || Qp > kTcMaxQ || Pp > kTcMaxP ||
      Np > 128 || bytes != static_cast<size_t>(smem_bytes) ||
      bytes > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (Np) {
    case 16:
      err = launch_tc<16>(x, dt, A, Bm, Cm, y, h_out, batch, L, H, P, G, N,
                          Q, bytes, st);
      break;
    case 32:
      err = launch_tc<32>(x, dt, A, Bm, Cm, y, h_out, batch, L, H, P, G, N,
                          Q, bytes, st);
      break;
    case 64:
      err = launch_tc<64>(x, dt, A, Bm, Cm, y, h_out, batch, L, H, P, G, N,
                          Q, bytes, st);
      break;
    case 128:
      err = launch_tc<128>(x, dt, A, Bm, Cm, y, h_out, batch, L, H, P, G, N,
                           Q, bytes, st);
      break;
    default:
      err = cudaErrorInvalidValue;  // N = 40, 56, ...: not a template
  }
  return static_cast<int>(err);
}

// The backward of ssd_scan_launch's y (from a zero state) for the
// cotangent dy: dx, dBm, dCm in the inputs' dtype (0 = f32, 1 = bf16),
// ddt [B, L, H] and dA [H] in f32. The caller's scratch: dB_part, dC_part
// f32 [B, L, H, N], dA_part f32 [B, H], states f32 [B, H, L/Q, P, N].
// smem_bytes is the wrapper's sum (ssd_scan.py::bwd_smem_bytes); a launch
// whose sizes or bytes this kernel does not take is refused. Two kernels
// launch: the scan, then the sum over heads.
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt,
                                   const void* A, const void* Bm,
                                   const void* Cm, const void* dy, void* dx,
                                   void* ddt, void* dBm, void* dCm, void* dA,
                                   void* dB_part, void* dC_part,
                                   void* dA_part, void* states, int batch,
                                   int L, int H, int P, int G, int N, int Q,
                                   int dtype, int smem_bytes, void* stream) {
  auto* st = static_cast<cudaStream_t>(stream);
  if (Q < 1 || L % Q || G < 1 || H % G || P < 1 || N < 1 || smem_bytes < 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = BwdLayout(Q, P, N, dtype == 0 ? 4 : 2).bytes;
  if (bytes != static_cast<size_t>(smem_bytes) || bytes > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      dtype == 0
          ? launch_bwd<float>(x, dt, A, Bm, Cm, dy, dx, ddt, dBm, dCm, dA,
                              dB_part, dC_part, dA_part, states, batch, L, H,
                              P, G, N, Q, bytes, st)
          : launch_bwd<bf16>(x, dt, A, Bm, Cm, dy, dx, ddt, dBm, dCm, dA,
                             dB_part, dC_part, dA_part, states, batch, L, H,
                             P, G, N, Q, bytes, st);
  return static_cast<int>(err);
}
