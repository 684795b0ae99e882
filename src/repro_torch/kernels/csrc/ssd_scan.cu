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
// `stride` elements), by a CTA of kThr threads: rows from `rows` on and
// columns from `cols` on are zero-filled.
template <int kThr = kTcThreads>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           size_t stride, int rows, int Qp,
                                           int cols, int R) {
  const int cpr = R >> 3;
  for (int i = threadIdx.x; i < Qp * cpr; i += kThr) {
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
// The backward
// ---------------------------------------------------------------------------
//
// Replaces no TPU kernel: the reference has no VJP for its Pallas scan and
// trains through XLA's autodiff of ssd_chunked (repro/models/mamba2.py,
// _ssd). Computes, to float tolerance, the plain torch version
// repro_torch/models/mamba2.py::ssd_chunked_bwd, whose docstring gives the
// formulas and the order of work: for a cotangent dy of y (from a zero
// initial state), dx, ddt, dA, dB and dC. No float atomics anywhere: every
// sum runs in a fixed order, so two launches give the same bits.
//
// bf16 (the models): six kernels, parallel over (b, chunk, head) rather
// than (b, head), every product with a bf16 operand on the tensor cores
// (mma.sync m16n8k16, f32 accumulation). An operand computed in f32 (the
// weights W and V, h0, dh, x.coef, dy.e^s) enters as a hi + lo bf16 pair,
// so each product has one bf16 operand as stored and at most one f32
// operand as a pair (~16 bits); none is rounded once to bf16:
//   1. ssd_bwd_increments_kernel, a CTA per (b, h, chunk): the chunk's state
//      increment S_c = sum_j coef_j x_j (x) B_j and its cotangent increment
//      Lam_c = sum_i e^{s_i} dy_i (x) C_i, [P, N] each (the forward's state
//      update, twice), and e^{s_Q} of the chunk;
//   2. ssd_bwd_states_kernel, a thread per four entries of [P, N] of a
//      (b, h): h0_{c+1} = e^{s_Q,c} h0_c + S_c in order and dh_c =
//      e^{s_Q,c+1} dh_{c+1} + Lam_{c+1} in reverse, in place (S becomes the
//      entering states, Lam their cotangents);
//   3. ssd_bwd_chunk_kernel, a CTA per (b, chunk, group, tile of up to
//      kBwdTile heads of the group), 4 warps: G^T = B C^T of the chunk is
//      built once for the tile (it does not depend on the head) and kept in
//      shared memory as accumulator fragments; then per head B dh^T (dh
//      staged once), D^T = x dy^T, and from the fragments W = E dt G,
//      V = E dt D and M = E G D (expf once per entry of the triangle);
//      dx = W^T dy + coef (B dh^T), u (from B dh^T), m and sum_j T_ij (the
//      row and column sums of M). V summed over the tile's heads (Vbar)
//      stays in registers and is written once a tile;
//   4. ssd_bwd_group_kernel, a CTA per (b, chunk, group, tile, N-slab), 8
//      warps: dB = Vbar^T C + sum_h coef^h (x^h dh^h) and dC = Vbar B +
//      sum_h e^{s^h} (dy^h h0^h) over the tile's heads, and each head's
//      share of r_i = C_i . (dy_i h0) and of <h0, dh> over the slab. The
//      head sum of dB and dC runs inside these products (Vbar) and in
//      registers, so no per-head partial of them is written;
//   5. ssd_bwd_ds_kernel, a warp per (b, h, chunk): ds, its reverse cumsum,
//      ddt and the chunk's share of dA;
//   6. ssd_bwd_sum_kernel: the tiles' partials of dB and dC (only when a
//      group has more heads than a tile) and dA over batch and chunks, in
//      a fixed order.
// Work tiles: the chunk body's warp w owns row blocks w and nrb - 1 - w (16
// rows each) of the chunk, which balances the causal triangle (9 tiles of
// 16 x 16 a warp at a chunk of 128); a warp's tiles sit in static register
// slots (pass 0 from slot 0 up, pass 1 from slot 8 down), so Vbar never
// leaves the registers. The states [P, N] stream through shared memory in
// slabs as hi/lo bf16.
//
// What bounds it on this card: the function's own bound is its bytes or
// its bf16 products (PERF.md section 6, row 5b). This design moves more
// bytes than that: the entering states and their cotangents, f32
// [B, H, L/Q, P, N] each, are written by 1, rewritten by 2 and read by 3
// and 4, and Vbar, f32 [B, L/Q, G, tiles, Q, Q], once each way; in
// exchange every kernel's grid grows with the chunks, and the chunk body,
// which holds two CTAs an SM, waits on a slab's loads once per head.
//
// f32 (ssd_scan_bwd_kernel, ssd_bwd_reduce_kernel) keeps the simple FMA
// design below, for the f32 checks and configs: one CTA per (b, h), 8
// warps, everything in f32 FMAs (tile_products):
//   pass 1 walks the chunks in order and writes the state entering each
//     to an f32 scratch [B, H, L/Q, P, N] (the state kept in shared
//     memory, as the f32 forward keeps it);
//   pass 2 walks them in reverse with dh [P, N] in shared memory. Per
//     chunk x, dy, B and C are staged, and the Q x Q products G = C.B^T
//     and D = dy.x^T are built kBT rows or columns at a time, twice: a
//     column sweep (kBT columns j, rows i >= j) gives dx and dB of those
//     columns and m_j = sum_i E G D, a row sweep (kBT rows i, columns
//     j <= i) gives dC and sum_j T_ij of those rows. Then one warp forms
//     ds, its reverse cumsum dda, ddt and the chunk's share of dA, and the
//     block updates dh.
// dB and dC are written per head as f32 partials [B, L, H, N], and dA per
// (b, h); ssd_bwd_reduce_kernel then sums the heads of each group (and dA
// over the batch) in a fixed order.

constexpr int kBwdTile = 8;        // heads of a group in one chunk-body CTA
constexpr int kSlots = 9;          // 16 x 16 tiles a chunk-body warp owns
constexpr int kGroupWarps = 8;
constexpr int kGroupThreads = kGroupWarps * kWarp;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  return v;
}

// Sum over the four lanes of a fragment row (lanes of equal g8).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xFFFFFFFFu, v, 1);
  return v + __shfl_xor_sync(0xFFFFFFFFu, v, 2);
}

// Sum over the eight fragment rows (lanes of equal t2).
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xFFFFFFFFu, v, 4);
  v += __shfl_xor_sync(0xFFFFFFFFu, v, 8);
  return v + __shfl_xor_sync(0xFFFFFFFFu, v, 16);
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

// Columns [n0, n0 + NS) of the f32 [P, N] state a (and b, unless it is
// null) as hi/lo bf16 tiles [Pp][NS] (zeros past P or N), by a CTA of kThr
// threads; returns this thread's share of sum(a * b) when `dot`. A thread
// issues all its loads before it converts and stores any.
template <int NS, int kThr>
__device__ __forceinline__ float stage_states(
    bf16* ahi, bf16* alo, bf16* bhi, bf16* blo, const float* a,
    const float* b, int P, int Pp, int N, int n0, bool dot) {
  constexpr int kC4 = NS / 4;
  constexpr int kPer = (kTcMaxP * kC4 + kThr - 1) / kThr;
  float4 va[kPer], vb[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThr;
    const int p = i / kC4, n = 4 * (i % kC4);
    va[k] = vb[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (p < P && p < Pp && n0 + n < N) {
      const size_t off = static_cast<size_t>(p) * N + n0 + n;
      va[k] = *reinterpret_cast<const float4*>(a + off);
      if (b != nullptr) vb[k] = *reinterpret_cast<const float4*>(b + off);
    }
  }
  float part = 0.0f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThr;
    if (i >= Pp * kC4) break;
    const int p = i / kC4, n = 4 * (i % kC4);
    const int at = swz(p, n, NS);
    uint32_t h0, l0, h1, l1;
    split(va[k].x, va[k].y, h0, l0);
    split(va[k].z, va[k].w, h1, l1);
    *reinterpret_cast<uint2*>(ahi + at) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(alo + at) = make_uint2(l0, l1);
    if (b == nullptr) continue;
    if (dot)
      part += va[k].x * vb[k].x + va[k].y * vb[k].y + va[k].z * vb[k].z +
              va[k].w * vb[k].w;
    split(vb[k].x, vb[k].y, h0, l0);
    split(vb[k].z, vb[k].w, h1, l1);
    *reinterpret_cast<uint2*>(bhi + at) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(blo + at) = make_uint2(l0, l1);
  }
  return part;
}

// One warp, after `dt` of a chunk is staged: s = cumsum(dt a), and
// es = e^{s}, coef = dt e^{s_Q - s} over [0, Qp) (dt is zero past Q).
__device__ __forceinline__ void chunk_vectors(const float* dt, float a,
                                              int Q, int Qp, float* s,
                                              float* es, float* coef) {
  const float s_last = warp_cumsum(dt, a, Q, Qp, s);
  for (int j = threadIdx.x % kWarp; j < Qp; j += kWarp) {
    es[j] = expf(s[j]);
    coef[j] = __fmul_rn(dt[j], expf(__fsub_rn(s_last, s[j])));
  }
}

// 1. The chunk increments. Shared memory: x, dy [Qp][Pp], B, C [Qp][kN]
// (bf16), then dt, s, coef, e^s [Qp] (f32).
struct IncrLayout {
  size_t x, dy, b, c, vec, bytes;
  __host__ __device__ IncrLayout(int Qp, int Pp, int Np) {
    x = 0;
    dy = x + 2ull * Qp * Pp;
    b = dy + 2ull * Qp * Pp;
    c = b + 2ull * Qp * Np;
    vec = c + 2ull * Qp * Np;
    bytes = vec + 4ull * 4 * Qp;
  }
};

template <int kN>
__global__ void __launch_bounds__(kTcThreads, 2)
    ssd_bwd_increments_kernel(const bf16* __restrict__ x,
                              const float* __restrict__ dt,
                              const float* __restrict__ A,
                              const bf16* __restrict__ Bm,
                              const bf16* __restrict__ Cm,
                              const bf16* __restrict__ dy,
                              float* __restrict__ incr,
                              float* __restrict__ lam,
                              float* __restrict__ decay, int L, int H, int P,
                              int G, int N, int Q) {
  extern __shared__ __align__(128) unsigned char in_smem[];
  const int Qp = round16(Q), Pp = round16(P);
  const IncrLayout lay(Qp, Pp, kN);
  bf16* xs = reinterpret_cast<bf16*>(in_smem + lay.x);
  bf16* dys = reinterpret_cast<bf16*>(in_smem + lay.dy);
  bf16* bs = reinterpret_cast<bf16*>(in_smem + lay.b);
  bf16* cs = reinterpret_cast<bf16*>(in_smem + lay.c);
  float* dtc = reinterpret_cast<float*>(in_smem + lay.vec);
  float* s = dtc + Qp;
  float* coef = s + Qp;
  float* es = coef + Qp;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g8 = lane >> 2, t2 = 2 * (lane & 3);
  const int lr = lane & 7, lm = lane >> 3;

  const int nc = L / Q;
  const int blk = blockIdx.x;  // ((b * H) + h) * nc + c
  const int c = blk % nc, bh = blk / nc;
  const int b = bh / H, hd = bh % H;
  const int grp = hd / (H / G);
  const size_t row0 = static_cast<size_t>(b) * L + static_cast<size_t>(c) * Q;
  stage_tile(xs, x + (row0 * H + hd) * P, static_cast<size_t>(H) * P, Q, Qp,
             P, Pp);
  stage_tile(dys, dy + (row0 * H + hd) * P, static_cast<size_t>(H) * P, Q,
             Qp, P, Pp);
  stage_tile(bs, Bm + (row0 * G + grp) * N, static_cast<size_t>(G) * N, Q,
             Qp, N, kN);
  stage_tile(cs, Cm + (row0 * G + grp) * N, static_cast<size_t>(G) * N, Q,
             Qp, N, kN);
  for (int j = threadIdx.x; j < Qp; j += kTcThreads)
    cp_async4(dtc + j, dt + (row0 + (j < Q ? j : 0)) * H + hd, j < Q ? 4 : 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (warp == 0) {
    chunk_vectors(dtc, A[hd], Q, Qp, s, es, coef);
    if (lane == 0) decay[blk] = expf(s[Q - 1]);
  }
  __syncthreads();

  // warp w: rows [16w, 16w + 16) of S and Lam; S of the last chunk and Lam
  // of the first are never read
  const int p0 = 16 * warp;
  if (p0 >= Pp) return;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    if (which == 0 ? c == nc - 1 : c == 0) continue;
    const bf16* lhs = which == 0 ? xs : dys;
    const bf16* rhs = which == 0 ? bs : cs;
    const float* scale = which == 0 ? coef : es;
    float acc[kN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kTcMaxQ / 16; ++kk) {
      if (16 * kk >= Qp) break;
      uint32_t xf[4], ah[4], al[4];
      ldsm_x4_t(xf, lhs + swz(16 * kk + (lm >> 1) * 8 + lr,
                              p0 + (lm & 1) * 8, Pp));
      const int ja = 16 * kk + t2, jb = ja + 8;
      const float2 ca = make_float2(scale[ja], scale[ja + 1]);
      const float2 cb = make_float2(scale[jb], scale[jb + 1]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = unpack(xf[r]);
        const float2 cv = r < 2 ? ca : cb;
        split(__fmul_rn(v.x, cv.x), __fmul_rn(v.y, cv.y), ah[r], al[r]);
      }
#pragma unroll
      for (int q = 0; q < kN / 16; ++q) {
        uint32_t bf[4];
        ldsm_x4_t(bf, rhs + swz(16 * kk + (lm & 1) * 8 + lr,
                                16 * q + (lm >> 1) * 8, kN));
        mma(acc[2 * q], ah, bf[0], bf[1]);
        mma(acc[2 * q + 1], ah, bf[2], bf[3]);
        mma(acc[2 * q], al, bf[0], bf[1]);
        mma(acc[2 * q + 1], al, bf[2], bf[3]);
      }
    }
    float* out = (which == 0 ? incr : lam) + static_cast<size_t>(blk) * P * N;
    const int pa = p0 + g8, pb = pa + 8;
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
      const int n = 8 * nt + t2;
      if (n >= N) break;
      if (pa < P)
        *reinterpret_cast<float2*>(out + pa * N + n) =
            make_float2(acc[nt][0], acc[nt][1]);
      if (pb < P)
        *reinterpret_cast<float2*>(out + pb * N + n) =
            make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// 2. The states, in place: a thread per float4 of [P, N] of one (b, h),
// blocks of 256 threads, `per_bh` blocks per (b, h). The recurrence in
// order and the one in reverse run interleaved, each reading kAhead
// chunks ahead, so a thread keeps loads in flight.
constexpr int kAhead = 4;

__global__ void __launch_bounds__(256)
    ssd_bwd_states_kernel(float* __restrict__ incr, float* __restrict__ lam,
                          const float* __restrict__ decay, int nc, int pn4,
                          int per_bh) {
  const int bh = blockIdx.x / per_bh;
  const int e = (blockIdx.x % per_bh) * 256 + threadIdx.x;
  if (e >= pn4) return;
  const size_t base = static_cast<size_t>(bh) * nc * pn4 + e;
  float4* s4 = reinterpret_cast<float4*>(incr) + base;
  float4* l4 = reinterpret_cast<float4*>(lam) + base;
  const float* dec = decay + static_cast<size_t>(bh) * nc;
  const auto step = [](float f, float4 h, float4 v) {
    return make_float4(__fadd_rn(__fmul_rn(f, h.x), v.x),
                       __fadd_rn(__fmul_rn(f, h.y), v.y),
                       __fadd_rn(__fmul_rn(f, h.z), v.z),
                       __fadd_rn(__fmul_rn(f, h.w), v.w));
  };
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // S_c for c < nc - 1 and Lam_c for c > 0 are read; the others are not
  // written by the increments
  const auto s_at = [&](int c) {
    return c < nc - 1 ? s4[static_cast<size_t>(c) * pn4] : zero;
  };
  const auto l_at = [&](int c) {
    return c > 0 ? l4[static_cast<size_t>(c) * pn4] : zero;
  };
  float4 fwd[kAhead], rev[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    fwd[k] = s_at(k);
    rev[k] = l_at(nc - 1 - k);
  }
  float4 h = zero, d = zero;
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c0 + k, cr = nc - 1 - c;
      if (c >= nc) break;
      const float4 vf = fwd[k], vr = rev[k];
      fwd[k] = s_at(c + kAhead);
      rev[k] = l_at(cr - kAhead);
      s4[static_cast<size_t>(c) * pn4] = h;   // h0_c
      h = step(dec[c], h, vf);
      l4[static_cast<size_t>(cr) * pn4] = d;  // dh_cr
      d = step(dec[cr], d, vr);
    }
  }
}

// 3. The chunk body. Shared memory: x, dy [Qp][Pp] (bf16); G^T as
// accumulator fragments, a warp's kSlots tiles of 256 f32 each; a B slab
// [Qp][NS] (bf16); a dh slab as hi/lo bf16 [Pp][NS] (a C slab [Qp][NS]
// while G^T is built); each warp's second row block of coef (B dh^T)
// [16, Pp] f32 until its turn; dt, s, e^{s_Q - s} and coef [Qp]; the
// column sums of M per row block [8][Qp].
struct ChunkLayout {
  size_t x, dy, gt, b, dhh, dhl, keep, vec, rowt, bytes;
  __host__ __device__ ChunkLayout(int Qp, int Pp, int ns) {
    x = 0;
    dy = x + 2ull * Qp * Pp;
    gt = dy + 2ull * Qp * Pp;
    b = gt + 4ull * kTcWarps * kSlots * 256;
    dhh = b + 2ull * Qp * ns;
    dhl = dhh + 2ull * Pp * ns;
    const size_t dh_end = dhl + 2ull * Pp * ns, c_end = dhh + 2ull * Qp * ns;
    keep = dh_end > c_end ? dh_end : c_end;
    vec = keep + 4ull * kTcWarps * 16 * Pp;
    rowt = vec + 4ull * 4 * Qp;
    bytes = rowt + 4ull * 8 * Qp;
  }
};

template <int kN>
__global__ void __launch_bounds__(kTcThreads, 2)
    ssd_bwd_chunk_kernel(const bf16* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ A,
                         const bf16* __restrict__ Bm,
                         const bf16* __restrict__ Cm,
                         const bf16* __restrict__ dy,
                         const float* __restrict__ dhs,
                         bf16* __restrict__ dx, float* __restrict__ rowt_out,
                         float* __restrict__ m_out, float* __restrict__ u_out,
                         float* __restrict__ vbar, int L, int H, int P, int G,
                         int N, int Q, int tile, int T) {
  constexpr int NS = kN < 32 ? kN : 32;
  extern __shared__ __align__(128) unsigned char ck_smem[];
  const int Qp = round16(Q), Pp = round16(P), nrb = Qp / 16;
  const ChunkLayout lay(Qp, Pp, NS);
  bf16* xs = reinterpret_cast<bf16*>(ck_smem + lay.x);
  bf16* dys = reinterpret_cast<bf16*>(ck_smem + lay.dy);
  float* gt = reinterpret_cast<float*>(ck_smem + lay.gt);
  bf16* bs = reinterpret_cast<bf16*>(ck_smem + lay.b);
  bf16* dhh = reinterpret_cast<bf16*>(ck_smem + lay.dhh);
  bf16* dhl = reinterpret_cast<bf16*>(ck_smem + lay.dhl);
  float* keep = reinterpret_cast<float*>(ck_smem + lay.keep);
  float* dtc = reinterpret_cast<float*>(ck_smem + lay.vec);
  float* s = dtc + Qp;
  float* ex = s + Qp;      // e^{s_Q - s_j}
  float* coef = ex + Qp;   // dt_j e^{s_Q - s_j}
  float* rowtp = reinterpret_cast<float*>(ck_smem + lay.rowt);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g8 = lane >> 2, t2 = 2 * (lane & 3);
  const int lr = lane & 7, lm = lane >> 3;

  const int nc = L / Q;
  int blk = blockIdx.x;  // ((b * nc + c) * G + g) * T + t
  const int t = blk % T;
  blk /= T;
  const int g = blk % G;
  blk /= G;
  const int c = blk % nc, b = blk / nc;
  const int rep = H / G, h_first = g * rep + t * tile;
  const int n_heads = min(tile, rep - t * tile);
  const size_t row0 = static_cast<size_t>(b) * L + static_cast<size_t>(c) * Q;
  // the warp's row blocks: rb[0] = w, rb[1] = nrb - 1 - w
  const int rbs[2] = {warp, nrb - 1 - warp};
  const bool acts[2] = {warp < (nrb + 1) / 2,
                        warp < (nrb + 1) / 2 && nrb - 1 - warp > warp};
  float* kept = keep + (warp * 16 * Pp + lane * 4);  // [nt][lane][4]

  // the tile's G^T, then Vbar, in the warp's slots: pass 0's tile (rb0,
  // rb0 + d) in slot d, pass 1's (rb1, rb1 + d) in slot 8 - d. The C slab
  // takes the dh slab's place while G^T is built.
  bf16* cs = dhh;
  float vb[kSlots][2][4];
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) vb[k][e / 4][e % 4] = 0.0f;
  for (int n0 = 0; n0 < kN; n0 += NS) {
    __syncthreads();
    stage_tile(bs, Bm + (row0 * G + g) * N + n0, static_cast<size_t>(G) * N,
               Q, Qp, N - n0, NS);
    stage_tile(cs, Cm + (row0 * G + g) * N + n0, static_cast<size_t>(G) * N,
               Q, Qp, N - n0, NS);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int rb = rbs[pass];
      if (!acts[pass]) continue;
#pragma unroll
      for (int kk = 0; kk < NS / 16; ++kk) {
        uint32_t ba[4];
        ldsm_x4(ba, bs + swz(16 * rb + (lm & 1) * 8 + lr,
                             16 * kk + (lm >> 1) * 8, NS));
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          const int ib = rb + d;
          if (ib >= nrb) break;
          const int slot = pass == 0 ? d : 8 - d;
          uint32_t f[4];
          ldsm_x4(f, cs + swz(16 * ib + (lm >> 1) * 8 + lr,
                              16 * kk + (lm & 1) * 8, NS));
          mma(vb[slot][0], ba, f[0], f[1]);
          mma(vb[slot][1], ba, f[2], f[3]);
        }
      }
    }
  }
  float* gw = gt + warp * kSlots * 256 + lane * 8;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    *reinterpret_cast<float4*>(gw + k * 256) =
        make_float4(vb[k][0][0], vb[k][0][1], vb[k][0][2], vb[k][0][3]);
    *reinterpret_cast<float4*>(gw + k * 256 + 4) =
        make_float4(vb[k][1][0], vb[k][1][1], vb[k][1][2], vb[k][1][3]);
#pragma unroll
    for (int e = 0; e < 8; ++e) vb[k][e / 4][e % 4] = 0.0f;
  }

  for (int hh = 0; hh < n_heads; ++hh) {
    const int hd = h_first + hh;
    const float* dh = dhs + ((static_cast<size_t>(b) * H + hd) * nc + c) * P * N;
    const size_t vrow = (static_cast<size_t>(b) * H + hd) * L + c * Q;
    // B dh^T [16, P] of both row blocks, over N, a slab of NS columns at a
    // time; the head's x, dy and dt come with the first slab
    float bd[2][kTcMaxP / 8][4];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass)
#pragma unroll
      for (int nt = 0; nt < kTcMaxP / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) bd[pass][nt][e] = 0.0f;
    for (int n0 = 0; n0 < kN; n0 += NS) {
      __syncthreads();  // the last slab's (and head's) readers are done
      if (n0 == 0) {
        stage_tile(xs, x + (row0 * H + hd) * P, static_cast<size_t>(H) * P,
                   Q, Qp, P, Pp);
        stage_tile(dys, dy + (row0 * H + hd) * P, static_cast<size_t>(H) * P,
                   Q, Qp, P, Pp);
        for (int j = threadIdx.x; j < Qp; j += kTcThreads)
          cp_async4(dtc + j, dt + (row0 + (j < Q ? j : 0)) * H + hd,
                    j < Q ? 4 : 0);
      }
      stage_tile(bs, Bm + (row0 * G + g) * N + n0,
                 static_cast<size_t>(G) * N, Q, Qp, N - n0, NS);
      cp_async_commit();
      stage_states<NS, kTcThreads>(dhh, dhl, nullptr, nullptr, dh, nullptr,
                                   P, Pp, N, n0, false);
      cp_async_wait_all();
      __syncthreads();
      if (n0 == 0 && warp == 0) {
        // the chunk's vectors (published by the sync after the slabs)
        const float s_last = warp_cumsum(dtc, A[hd], Q, Qp, s);
        for (int j = lane; j < Qp; j += kWarp) {
          ex[j] = expf(__fsub_rn(s_last, s[j]));
          coef[j] = __fmul_rn(dtc[j], ex[j]);
        }
      }
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        const int rb = rbs[pass];
        if (!acts[pass]) continue;
#pragma unroll
        for (int kk = 0; kk < NS / 16; ++kk) {
          uint32_t ba[4];
          ldsm_x4(ba, bs + swz(16 * rb + (lm & 1) * 8 + lr,
                               16 * kk + (lm >> 1) * 8, NS));
#pragma unroll
          for (int q = 0; q < kTcMaxP / 16; ++q) {
            if (16 * q >= Pp) break;
            uint32_t fh[4], fl[4];
            const int at = swz(16 * q + (lm >> 1) * 8 + lr,
                               16 * kk + (lm & 1) * 8, NS);
            ldsm_x4(fh, dhh + at);
            ldsm_x4(fl, dhl + at);
            mma(bd[pass][2 * q], ba, fh[0], fh[1]);
            mma(bd[pass][2 * q + 1], ba, fh[2], fh[3]);
            mma(bd[pass][2 * q], ba, fl[0], fl[1]);
            mma(bd[pass][2 * q + 1], ba, fl[2], fl[3]);
          }
        }
      }
    }
    __syncthreads();  // the vectors are published
    // u_j = e^{s_Q - s_j} x_j . (B_j dh^T), from the x rows as A fragments
    // (their layout is the accumulators' of two n8 tiles); dx starts as
    // coef_j (B_j dh^T), the second row block's kept in shared memory
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int rb = rbs[pass];
      if (!acts[pass]) continue;
      const int ja = 16 * rb + g8, jb = ja + 8;
      float ua = 0.0f, ub = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kTcMaxP / 16; ++kk) {
        if (16 * kk >= Pp) break;
        uint32_t xf[4];
        ldsm_x4(xf, xs + swz(16 * rb + (lm & 1) * 8 + lr,
                             16 * kk + (lm >> 1) * 8, Pp));
#pragma unroll
        for (int hn = 0; hn < 2; ++hn) {
          const float2 x0 = unpack(xf[2 * hn]), x1 = unpack(xf[2 * hn + 1]);
          const int nt = 2 * kk + hn;
          ua += x0.x * bd[pass][nt][0] + x0.y * bd[pass][nt][1];
          ub += x1.x * bd[pass][nt][2] + x1.y * bd[pass][nt][3];
        }
      }
      ua = quad_sum(ua);
      ub = quad_sum(ub);
      if ((lane & 3) == 0) {
        if (ja < Q) u_out[vrow + ja] = __fmul_rn(ex[ja], ua);
        if (jb < Q) u_out[vrow + jb] = __fmul_rn(ex[jb], ub);
      }
      const float ca = coef[ja], cb = coef[jb];
#pragma unroll
      for (int nt = 0; nt < kTcMaxP / 8; ++nt) {
        if (8 * nt >= Pp) break;
        bd[pass][nt][0] = __fmul_rn(bd[pass][nt][0], ca);
        bd[pass][nt][1] = __fmul_rn(bd[pass][nt][1], ca);
        bd[pass][nt][2] = __fmul_rn(bd[pass][nt][2], cb);
        bd[pass][nt][3] = __fmul_rn(bd[pass][nt][3], cb);
        if (pass == 1)
          *reinterpret_cast<float4*>(kept + nt * 128) =
              make_float4(bd[1][nt][0], bd[1][nt][1], bd[1][nt][2],
                          bd[1][nt][3]);
      }
    }

#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int rb = rbs[pass];
      if (!acts[pass]) continue;
      const int ja = 16 * rb + g8, jb = ja + 8;
      float acc[kTcMaxP / 8][4];
#pragma unroll
      for (int nt = 0; nt < kTcMaxP / 8; ++nt) {
        if (pass == 0 || 8 * nt >= Pp) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = pass == 0 ? bd[0][nt][e]
                                                             : 0.0f;
        } else {
          const float4 v = *reinterpret_cast<const float4*>(kept + nt * 128);
          acc[nt][0] = v.x;
          acc[nt][1] = v.y;
          acc[nt][2] = v.z;
          acc[nt][3] = v.w;
        }
      }
      uint32_t xa[kTcMaxP / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTcMaxP / 16; ++kk) {
        if (16 * kk >= Pp) break;
        ldsm_x4(xa[kk], xs + swz(16 * rb + (lm & 1) * 8 + lr,
                                 16 * kk + (lm >> 1) * 8, Pp));
      }

      // the row block's tiles (rb, ib >= rb)
      const float sj[2] = {s[ja], s[jb]}, dj[2] = {dtc[ja], dtc[jb]};
      float mrow[2] = {0.0f, 0.0f};
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        const int ib = rb + d;
        if (ib >= nrb) break;
        const int slot = pass == 0 ? d : 8 - d;
        // D^T_ji = x_j . dy_i
        float dd[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kTcMaxP / 16; ++kk) {
          if (16 * kk >= Pp) break;
          uint32_t f[4];
          ldsm_x4(f, dys + swz(16 * ib + (lm >> 1) * 8 + lr,
                               16 * kk + (lm & 1) * 8, Pp));
          mma(dd[0], xa[kk], f[0], f[1]);
          mma(dd[1], xa[kk], f[2], f[3]);
        }
        const float4 g0 = *reinterpret_cast<const float4*>(gw + slot * 256);
        const float4 g1 =
            *reinterpret_cast<const float4*>(gw + slot * 256 + 4);
        const float gg[2][4] = {{g0.x, g0.y, g0.z, g0.w},
                                {g1.x, g1.y, g1.z, g1.w}};
        float w[2][4];
#pragma unroll
        for (int hn = 0; hn < 2; ++hn) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 16 * ib + 8 * hn + t2 + e;
            const float si = s[i];
            float col = 0.0f;  // sum over this thread's rows j of M_ij dt_j
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int k = 2 * hr + e;
              const int j = hr == 0 ? ja : jb;
              float wv = 0.0f, vv = 0.0f, mm = 0.0f;
              if (j <= i && i < Q) {
                const float ee = __expf(__fsub_rn(si, sj[hr]));
                const float edt = __fmul_rn(ee, dj[hr]);
                wv = __fmul_rn(edt, gg[hn][k]);
                vv = __fmul_rn(edt, dd[hn][k]);
                mm = __fmul_rn(__fmul_rn(ee, gg[hn][k]), dd[hn][k]);
              }
              w[hn][k] = wv;
              vb[slot][hn][k] += vv;
              mrow[hr] += mm;
              col += mm * dj[hr];
            }
            col = column_sum(col);
            if (g8 == 0) rowtp[rb * Qp + i] = col;
          }
        }
        // dx_j += sum_i W^T_ji dy_i, W^T as its hi + lo pair
        uint32_t ah[4], al[4];
        split(w[0][0], w[0][1], ah[0], al[0]);
        split(w[0][2], w[0][3], ah[1], al[1]);
        split(w[1][0], w[1][1], ah[2], al[2]);
        split(w[1][2], w[1][3], ah[3], al[3]);
#pragma unroll
        for (int q = 0; q < kTcMaxP / 16; ++q) {
          if (16 * q >= Pp) break;
          uint32_t f[4];
          ldsm_x4_t(f, dys + swz(16 * ib + (lm & 1) * 8 + lr,
                                 16 * q + (lm >> 1) * 8, Pp));
          mma(acc[2 * q], ah, f[0], f[1]);
          mma(acc[2 * q + 1], ah, f[2], f[3]);
          mma(acc[2 * q], al, f[0], f[1]);
          mma(acc[2 * q + 1], al, f[2], f[3]);
        }
      }
      mrow[0] = quad_sum(mrow[0]);
      mrow[1] = quad_sum(mrow[1]);
      if ((lane & 3) == 0) {
        if (ja < Q) m_out[vrow + ja] = mrow[0];
        if (jb < Q) m_out[vrow + jb] = mrow[1];
      }
#pragma unroll
      for (int nt = 0; nt < kTcMaxP / 8; ++nt) {
        const int p = 8 * nt + t2;
        if (p >= P) break;
        if (ja < Q)
          *reinterpret_cast<__nv_bfloat162*>(dx + ((row0 + ja) * H + hd) * P +
                                             p) =
              __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
        if (jb < Q)
          *reinterpret_cast<__nv_bfloat162*>(dx + ((row0 + jb) * H + hd) * P +
                                             p) =
              __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
      }
    }
    // sum_j T_ij: the row blocks' column sums of M dt, in order
    __syncthreads();
    for (int i = threadIdx.x; i < Q; i += kTcThreads) {
      float rt = 0.0f;
      for (int jb = 0; jb <= i / 16; ++jb) rt += rowtp[jb * Qp + i];
      rowt_out[vrow + i] = rt;
    }
  }

  // Vbar^T of the tile, [Qp][Qp] f32 (rows j, columns i); only the tiles
  // ib >= jb are written, and only they are read
  float* vout = vbar + static_cast<size_t>(blockIdx.x) * Qp * Qp;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int rb = rbs[pass];
    if (!acts[pass]) continue;
    const int ja = 16 * rb + g8, jb = ja + 8;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const int ib = rb + d;
      if (ib >= nrb) break;
      const int slot = pass == 0 ? d : 8 - d;
#pragma unroll
      for (int hn = 0; hn < 2; ++hn) {
        const int i = 16 * ib + 8 * hn + t2;
        *reinterpret_cast<float2*>(vout + ja * Qp + i) =
            make_float2(vb[slot][hn][0], vb[slot][hn][1]);
        *reinterpret_cast<float2*>(vout + jb * Qp + i) =
            make_float2(vb[slot][hn][2], vb[slot][hn][3]);
      }
    }
  }
}

// 4. The group products, with each head's share of r_i = dy_i . (C_i h0^T)
// and of <h0, dh> over the slab's columns. Shared memory: region 1, per
// head x, dy [Qp][Pp] and the dh, h0 slabs as hi/lo bf16 [Pp][NS], then
// Vbar^T as hi/lo bf16 [Qp][Qp]; B, C slabs [Qp][NS] (bf16); dt, s, coef,
// e^s [Qp]; a slot a warp.
struct GroupLayout {
  size_t x, dy, dhh, dhl, h0h, h0l, vth, vtl, b, c, vec, red, bytes;
  __host__ __device__ GroupLayout(int Qp, int Pp, int ns) {
    x = 0;
    dy = x + 2ull * Qp * Pp;
    dhh = dy + 2ull * Qp * Pp;
    dhl = dhh + 2ull * Pp * ns;
    h0h = dhl + 2ull * Pp * ns;
    h0l = h0h + 2ull * Pp * ns;
    const size_t heads = h0l + 2ull * Pp * ns, vt = 4ull * Qp * Qp;
    vth = 0;
    vtl = 2ull * Qp * Qp;
    b = heads > vt ? heads : vt;
    c = b + 2ull * Qp * ns;
    vec = c + 2ull * Qp * ns;
    red = vec + 4ull * 4 * Qp;
    bytes = red + 4ull * kGroupWarps;
  }
};

template <int kN>
__global__ void __launch_bounds__(kGroupThreads, 2)
    ssd_bwd_group_kernel(const bf16* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ A,
                         const bf16* __restrict__ Bm,
                         const bf16* __restrict__ Cm,
                         const bf16* __restrict__ dy,
                         const float* __restrict__ h0s,
                         const float* __restrict__ dhs,
                         const float* __restrict__ vbar,
                         bf16* __restrict__ dBm, bf16* __restrict__ dCm,
                         float* __restrict__ dB_part,
                         float* __restrict__ dC_part,
                         float* __restrict__ r_part,
                         float* __restrict__ hdot_part, int batch, int L,
                         int H, int P, int G, int N, int Q, int tile,
                         int T) {
  constexpr int NS = kN < 64 ? kN : 64;
  extern __shared__ __align__(128) unsigned char gr_smem[];
  const int Qp = round16(Q), Pp = round16(P), nrb = Qp / 16;
  const GroupLayout lay(Qp, Pp, NS);
  bf16* xs = reinterpret_cast<bf16*>(gr_smem + lay.x);
  bf16* dys = reinterpret_cast<bf16*>(gr_smem + lay.dy);
  bf16* dhh = reinterpret_cast<bf16*>(gr_smem + lay.dhh);
  bf16* dhl = reinterpret_cast<bf16*>(gr_smem + lay.dhl);
  bf16* h0h = reinterpret_cast<bf16*>(gr_smem + lay.h0h);
  bf16* h0l = reinterpret_cast<bf16*>(gr_smem + lay.h0l);
  bf16* vth = reinterpret_cast<bf16*>(gr_smem + lay.vth);
  bf16* vtl = reinterpret_cast<bf16*>(gr_smem + lay.vtl);
  bf16* bs = reinterpret_cast<bf16*>(gr_smem + lay.b);
  bf16* cs = reinterpret_cast<bf16*>(gr_smem + lay.c);
  float* dtc = reinterpret_cast<float*>(gr_smem + lay.vec);
  float* s = dtc + Qp;
  float* coef = s + Qp;
  float* es = coef + Qp;
  float* red = reinterpret_cast<float*>(gr_smem + lay.red);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g8 = lane >> 2, t2 = 2 * (lane & 3);
  const int lr = lane & 7, lm = lane >> 3;

  const int nc = L / Q;
  int blk = blockIdx.x;  // ((b * nc + c) * G + g) * T + t
  const int t = blk % T;
  blk /= T;
  const int g = blk % G;
  blk /= G;
  const int c = blk % nc, b = blk / nc;
  const int n0 = blockIdx.y * NS;
  const int rep = H / G, h_first = g * rep + t * tile;
  const int n_heads = min(tile, rep - t * tile);
  const size_t row0 = static_cast<size_t>(b) * L + static_cast<size_t>(c) * Q;
  const int rb = warp;  // rows j of dB and rows i of dC
  const bool act = rb < nrb;
  const int ja = 16 * rb + g8, jb = ja + 8;

  stage_tile<kGroupThreads>(bs, Bm + (row0 * G + g) * N + n0,
                            static_cast<size_t>(G) * N, Q, Qp, N - n0, NS);
  stage_tile<kGroupThreads>(cs, Cm + (row0 * G + g) * N + n0,
                            static_cast<size_t>(G) * N, Q, Qp, N - n0, NS);
  float db[NS / 8][4], dc[NS / 8][4];
#pragma unroll
  for (int nt = 0; nt < NS / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) db[nt][e] = dc[nt][e] = 0.0f;

  for (int hh = 0; hh < n_heads; ++hh) {
    const int hd = h_first + hh;
    const size_t st = ((static_cast<size_t>(b) * H + hd) * nc + c) * P * N;
    __syncthreads();  // the last head's readers are done
    stage_tile<kGroupThreads>(xs, x + (row0 * H + hd) * P,
                              static_cast<size_t>(H) * P, Q, Qp, P, Pp);
    stage_tile<kGroupThreads>(dys, dy + (row0 * H + hd) * P,
                              static_cast<size_t>(H) * P, Q, Qp, P, Pp);
    for (int j = threadIdx.x; j < Qp; j += kGroupThreads)
      cp_async4(dtc + j, dt + (row0 + (j < Q ? j : 0)) * H + hd,
                j < Q ? 4 : 0);
    cp_async_commit();
    const float hpart = warp_sum(stage_states<NS, kGroupThreads>(
        dhh, dhl, h0h, h0l, dhs + st, h0s + st, P, Pp, N, n0, true));
    if (lane == 0) red[warp] = hpart;
    cp_async_wait_all();
    __syncthreads();
    // the slab's rows of this head's r and <h0, dh>, [slab][B][H][..]
    const size_t slot = static_cast<size_t>(blockIdx.y) * batch * H +
                        static_cast<size_t>(b) * H + hd;
    if (warp == 0) {
      chunk_vectors(dtc, A[hd], Q, Qp, s, es, coef);
      if (lane == 0) {
        float hdot = 0.0f;
        for (int w = 0; w < kGroupWarps; ++w) hdot += red[w];
        hdot_part[slot * nc + c] = hdot;
      }
    }
    __syncthreads();
    if (!act) continue;
    // dB_j += coef_j (x_j dh), then dC_i += e^{s_i} (dy_i h0) with r_i's
    // share sum_n C_in (dy_i h0)_n, over the slab's columns
    float ra = 0.0f, rb2 = 0.0f;
    const auto side = [&](const bf16* lhs, const bf16* rhi, const bf16* rlo,
                          float fa, float fb, float (&acc)[NS / 8][4],
                          bool with_r) {
      uint32_t la[kTcMaxP / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTcMaxP / 16; ++kk) {
        if (16 * kk >= Pp) break;
        ldsm_x4(la[kk], lhs + swz(16 * rb + (lm & 1) * 8 + lr,
                                  16 * kk + (lm >> 1) * 8, Pp));
      }
#pragma unroll
      for (int q = 0; q < NS / 16; ++q) {
        float tt[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kTcMaxP / 16; ++kk) {
          if (16 * kk >= Pp) break;
          uint32_t fh[4], fl[4];
          const int at = swz(16 * kk + (lm & 1) * 8 + lr,
                             16 * q + (lm >> 1) * 8, NS);
          ldsm_x4_t(fh, rhi + at);
          ldsm_x4_t(fl, rlo + at);
          mma(tt[0], la[kk], fh[0], fh[1]);
          mma(tt[1], la[kk], fh[2], fh[3]);
          mma(tt[0], la[kk], fl[0], fl[1]);
          mma(tt[1], la[kk], fl[2], fl[3]);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[2 * q + e][0] += fa * tt[e][0];
          acc[2 * q + e][1] += fa * tt[e][1];
          acc[2 * q + e][2] += fb * tt[e][2];
          acc[2 * q + e][3] += fb * tt[e][3];
          if (with_r) {
            const int col = 16 * q + 8 * e + t2;
            const float2 ca = unpack(
                *reinterpret_cast<const uint32_t*>(cs + swz(ja, col, NS)));
            const float2 cb = unpack(
                *reinterpret_cast<const uint32_t*>(cs + swz(jb, col, NS)));
            ra += ca.x * tt[e][0] + ca.y * tt[e][1];
            rb2 += cb.x * tt[e][2] + cb.y * tt[e][3];
          }
        }
      }
    };
    side(xs, dhh, dhl, coef[ja], coef[jb], db, false);
    side(dys, h0h, h0l, es[ja], es[jb], dc, true);
    ra = quad_sum(ra);
    rb2 = quad_sum(rb2);
    if ((lane & 3) == 0) {
      const size_t at = slot * L + static_cast<size_t>(c) * Q;
      if (ja < Q) r_part[at + ja] = ra;
      if (jb < Q) r_part[at + jb] = rb2;
    }
  }

  // Vbar^T of the tile as hi/lo bf16, its tiles ib >= jb
  __syncthreads();
  const float* vin = vbar + static_cast<size_t>(blockIdx.x) * Qp * Qp;
  const int c4 = Qp / 4;
  for (int i = threadIdx.x; i < Qp * c4; i += kGroupThreads) {
    const int r = i / c4, col = 4 * (i % c4);
    if (col / 16 < r / 16) continue;
    const float4 v = *reinterpret_cast<const float4*>(vin + r * Qp + col);
    uint32_t h0, l0, h1, l1;
    split(v.x, v.y, h0, l0);
    split(v.z, v.w, h1, l1);
    const int at = swz(r, col, Qp);
    *reinterpret_cast<uint2*>(vth + at) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(vtl + at) = make_uint2(l0, l1);
  }
  cp_async_wait_all();  // B and C, when the tile had no head to wait on
  __syncthreads();
  if (!act) return;
  // dB_j += sum_{i >= j} Vbar^T_ji C_i
  for (int ib = rb; ib < nrb; ++ib) {
    uint32_t ah[4], al[4];
    const int at = swz(16 * rb + (lm & 1) * 8 + lr, 16 * ib + (lm >> 1) * 8,
                       Qp);
    ldsm_x4(ah, vth + at);
    ldsm_x4(al, vtl + at);
#pragma unroll
    for (int q = 0; q < NS / 16; ++q) {
      uint32_t f[4];
      ldsm_x4_t(f, cs + swz(16 * ib + (lm & 1) * 8 + lr,
                            16 * q + (lm >> 1) * 8, NS));
      mma(db[2 * q], ah, f[0], f[1]);
      mma(db[2 * q + 1], ah, f[2], f[3]);
      mma(db[2 * q], al, f[0], f[1]);
      mma(db[2 * q + 1], al, f[2], f[3]);
    }
  }
  // dC_i += sum_{j <= i} Vbar_ij B_j: Vbar's rows are Vbar^T's columns,
  // read with ldmatrix.trans
  for (int jb2 = 0; jb2 <= rb; ++jb2) {
    uint32_t ah[4], al[4];
    const int at = swz(16 * jb2 + (lm >> 1) * 8 + lr, 16 * rb + (lm & 1) * 8,
                       Qp);
    ldsm_x4_t(ah, vth + at);
    ldsm_x4_t(al, vtl + at);
#pragma unroll
    for (int q = 0; q < NS / 16; ++q) {
      uint32_t f[4];
      ldsm_x4_t(f, bs + swz(16 * jb2 + (lm & 1) * 8 + lr,
                            16 * q + (lm >> 1) * 8, NS));
      mma(dc[2 * q], ah, f[0], f[1]);
      mma(dc[2 * q + 1], ah, f[2], f[3]);
      mma(dc[2 * q], al, f[0], f[1]);
      mma(dc[2 * q + 1], al, f[2], f[3]);
    }
  }
  const size_t n_bc = static_cast<size_t>(gridDim.x / T) * Q * N;  // B L G N
#pragma unroll
  for (int nt = 0; nt < NS / 8; ++nt) {
    const int n = n0 + 8 * nt + t2;
    if (n >= N) break;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int j = hr == 0 ? ja : jb;
      if (j >= Q) continue;
      const size_t at = ((row0 + j) * G + g) * N + n;
      const float2 vb2 = make_float2(db[nt][2 * hr], db[nt][2 * hr + 1]);
      const float2 vc2 = make_float2(dc[nt][2 * hr], dc[nt][2 * hr + 1]);
      if (T == 1) {
        *reinterpret_cast<__nv_bfloat162*>(dBm + at) =
            __floats2bfloat162_rn(vb2.x, vb2.y);
        *reinterpret_cast<__nv_bfloat162*>(dCm + at) =
            __floats2bfloat162_rn(vc2.x, vc2.y);
      } else {
        *reinterpret_cast<float2*>(dB_part + t * n_bc + at) = vb2;
        *reinterpret_cast<float2*>(dC_part + t * n_bc + at) = vc2;
      }
    }
  }
}

// 5. ds, its reverse cumsum, ddt and the chunk's share of dA, a warp per
// (b, h, chunk), from the chunk body's sum_j T_ij, m and u and the group
// kernel's slabs of r and <h0, dh> (all [.., B, H, L] or [.., B, H, L/Q]):
//   ds_i = sum_j T_ij - dt_i m_i + e^{s_i} r_i - dt_i u_i
//          (+ e^{s_Q} <h0, dh> + sum_j dt_j u_j at i = Q - 1).
constexpr int kDsWarps = 4;

__global__ void __launch_bounds__(kDsWarps * kWarp)
    ssd_bwd_ds_kernel(const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ rowt,
                      const float* __restrict__ mvec,
                      const float* __restrict__ uvec,
                      const float* __restrict__ r_part,
                      const float* __restrict__ hdot_part,
                      float* __restrict__ ddt, float* __restrict__ dA_part,
                      int batch, int L, int H, int Q, int slabs) {
  __shared__ float sm[kDsWarps][3][kTcMaxQ];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nc = L / Q, Qp = round16(Q);
  const int idx = blockIdx.x * kDsWarps + warp;  // (b * H + h) * nc + c
  if (idx >= batch * H * nc) return;
  const int c = idx % nc, bh = idx / nc;
  const int b = bh / H, h = bh % H;
  float* dtw = sm[warp][0];
  float* s = sm[warp][1];
  float* ds = sm[warp][2];
  const size_t row0 = static_cast<size_t>(b) * L + static_cast<size_t>(c) * Q;
  const size_t v0 = static_cast<size_t>(bh) * L + static_cast<size_t>(c) * Q;
  const size_t n_v = static_cast<size_t>(batch) * H * L;
  const float a = A[h];
  for (int j = lane; j < Qp; j += kWarp)
    dtw[j] = j < Q ? dt[(row0 + j) * H + h] : 0.0f;
  __syncwarp();
  const float s_last = warp_cumsum(dtw, a, Q, Qp, s);
  float hdot = 0.0f;
  for (int k = 0; k < slabs; ++k)
    hdot += hdot_part[(k * static_cast<size_t>(batch) * H + bh) * nc + c];
  float su = 0.0f;
  for (int j = lane; j < Q; j += kWarp) su += dtw[j] * uvec[v0 + j];
  su = warp_sum(su);
  for (int i = lane; i < Q; i += kWarp) {
    float r = 0.0f;
    for (int k = 0; k < slabs; ++k) r += r_part[k * n_v + v0 + i];
    float v = rowt[v0 + i] - dtw[i] * mvec[v0 + i] + expf(s[i]) * r -
              dtw[i] * uvec[v0 + i];
    if (i == Q - 1) v += expf(s_last) * hdot + su;
    ds[i] = v;
  }
  __syncwarp();
  warp_rcumsum(ds, Q);
  float da = 0.0f;
  for (int j = lane; j < Q; j += kWarp) {
    ddt[(row0 + j) * H + h] = a * ds[j] + mvec[v0 + j] + uvec[v0 + j];
    da += dtw[j] * ds[j];
  }
  da = warp_sum(da);
  if (lane == 0) dA_part[(static_cast<size_t>(b) * nc + c) * H + h] = da;
}

// 6. dBm, dCm [n_bc] = the T tiles' partials summed in order (n_bc = 0
// when one tile holds a group's heads: the group kernel wrote them);
// dA [H] = dA_part [B * L/Q, H] summed over batch and chunks in order.
__global__ void ssd_bwd_sum_kernel(const float* __restrict__ dB_part,
                                   const float* __restrict__ dC_part,
                                   const float* __restrict__ dA_part,
                                   bf16* __restrict__ dBm,
                                   bf16* __restrict__ dCm,
                                   float* __restrict__ dA, size_t n_bc, int T,
                                   int n_bchunks, int H) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_bc + H; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    if (i < n_bc) {
      float sb = 0.0f, sc = 0.0f;
      for (int t = 0; t < T; ++t) {
        sb += dB_part[t * n_bc + i];
        sc += dC_part[t * n_bc + i];
      }
      dBm[i] = __float2bfloat16_rn(sb);
      dCm[i] = __float2bfloat16_rn(sc);
    } else {
      const int h = static_cast<int>(i - n_bc);
      float sa = 0.0f;
      for (int k = 0; k < n_bchunks; ++k) sa += dA_part[k * H + h];
      dA[h] = sa;
    }
  }
}

// The bf16 backward's f32 scratch, offsets in floats of one buffer: the
// increments (then entering states) and their cotangents [B, H, L/Q, P, N],
// e^{s_Q} [B, H, L/Q], the tiles' Vbar [B * L/Q * G * T, Qp, Qp], the
// tiles' dB and dC [T, B, L, G, N] (only when T > 1), sum_j T_ij, m and u
// [B, H, L], the slabs' r [slabs, B, H, L] and <h0, dh> [slabs, B, H, L/Q],
// dA's shares [B, L/Q, H].
struct BwdScratch {
  size_t incr, lam, decay, vbar, dB, dC, rowt, m, u, r, hdot, dA, floats;
  int T, slabs;
  BwdScratch(int batch, int L, int H, int P, int G, int N, int Q, int tile) {
    const size_t nc = L / Q, Qp = round16(Q), Np = round16(N);
    const size_t bh = static_cast<size_t>(batch) * H;
    T = (H / G + tile - 1) / tile;
    slabs = static_cast<int>(Np / (Np < 64 ? Np : 64));
    const size_t states = bh * nc * P * N;
    const size_t parts = T > 1 ? static_cast<size_t>(T) * batch * L * G * N
                               : 0;
    incr = 0;
    lam = incr + states;
    decay = lam + states;
    vbar = decay + bh * nc;
    dB = vbar + static_cast<size_t>(batch) * nc * G * T * Qp * Qp;
    dC = dB + parts;
    rowt = dC + parts;
    m = rowt + bh * L;
    u = m + bh * L;
    r = u + bh * L;
    hdot = r + slabs * bh * L;
    dA = hdot + slabs * bh * nc;
    floats = dA + static_cast<size_t>(batch) * nc * H;
  }
};

template <int kN>
cudaError_t launch_bwd_tc(const void* x, const void* dt, const void* A,
                          const void* Bm, const void* Cm, const void* dy,
                          void* dx, void* ddt, void* dBm, void* dCm, void* dA,
                          float* scratch, const BwdScratch& sc, int batch,
                          int L, int H, int P, int G, int N, int Q, int tile,
                          size_t incr_bytes, size_t chunk_bytes,
                          size_t group_bytes, cudaStream_t st) {
  static bool set1[kMaxDevices] = {}, set3[kMaxDevices] = {},
              set4[kMaxDevices] = {};
  cudaError_t err = smem_ceiling(ssd_bwd_increments_kernel<kN>, set1);
  if (err == cudaSuccess) err = smem_ceiling(ssd_bwd_chunk_kernel<kN>, set3);
  if (err == cudaSuccess) err = smem_ceiling(ssd_bwd_group_kernel<kN>, set4);
  if (err != cudaSuccess) return err;
  const int nc = L / Q;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  const auto* Bb = static_cast<const bf16*>(Bm);
  const auto* Cb = static_cast<const bf16*>(Cm);
  const auto* dyb = static_cast<const bf16*>(dy);
  float* incr = scratch + sc.incr;
  float* lam = scratch + sc.lam;
  ssd_bwd_increments_kernel<kN><<<batch * H * nc, kTcThreads, incr_bytes,
                                   st>>>(xb, dtf, Af, Bb, Cb, dyb, incr, lam,
                                         scratch + sc.decay, L, H, P, G, N,
                                         Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int pn4 = P * N / 4, per_bh = (pn4 + 255) / 256;
  ssd_bwd_states_kernel<<<batch * H * per_bh, 256, 0, st>>>(
      incr, lam, scratch + sc.decay, nc, pn4, per_bh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int tiles = batch * nc * G * sc.T;
  ssd_bwd_chunk_kernel<kN><<<tiles, kTcThreads, chunk_bytes, st>>>(
      xb, dtf, Af, Bb, Cb, dyb, lam, static_cast<bf16*>(dx),
      scratch + sc.rowt, scratch + sc.m, scratch + sc.u, scratch + sc.vbar, L,
      H, P, G, N, Q, tile, sc.T);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_group_kernel<kN><<<dim3(tiles, sc.slabs), kGroupThreads,
                              group_bytes, st>>>(
      xb, dtf, Af, Bb, Cb, dyb, incr, lam, scratch + sc.vbar,
      static_cast<bf16*>(dBm), static_cast<bf16*>(dCm), scratch + sc.dB,
      scratch + sc.dC, scratch + sc.r, scratch + sc.hdot, batch, L, H, P, G,
      N, Q, tile, sc.T);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n_chunks = batch * H * nc;
  ssd_bwd_ds_kernel<<<(n_chunks + kDsWarps - 1) / kDsWarps,
                      kDsWarps * kWarp, 0, st>>>(
      dtf, Af, scratch + sc.rowt, scratch + sc.m, scratch + sc.u,
      scratch + sc.r, scratch + sc.hdot, static_cast<float*>(ddt),
      scratch + sc.dA, batch, L, H, Q, sc.slabs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t n_bc = sc.T > 1 ? static_cast<size_t>(batch) * L * G * N : 0;
  const int blocks = static_cast<int>(
      std::min<size_t>((n_bc + H + 255) / 256, 132 * 16));
  ssd_bwd_sum_kernel<<<blocks, 256, 0, st>>>(
      scratch + sc.dB, scratch + sc.dC, scratch + sc.dA,
      static_cast<bf16*>(dBm), static_cast<bf16*>(dCm),
      static_cast<float*>(dA), n_bc, sc.T, batch * nc, H);
  return cudaGetLastError();
}

constexpr int kBT = 32;          // rows or columns of a Q x Q tile at once
constexpr int kBwdVecs = 10;     // [Q] vectors of the chunk
constexpr int kWarps = kThreads / kWarp;

// Shared memory of the f32 backward, in floats: dh [P][N+1], three tile
// regions of `rs` floats, the chunk's vectors, the block sum's per-warp
// slots, then x, dy [Q][P+1] and B, C [Q][N+1]. A tile region holds a
// column tile [Q][kBT+1] or a row tile [kBT][Q+1], or [kBT][max(P, N)+1]
// of a sweep's side product.
struct BwdLayout {
  size_t dh, r1, r2, r3, vec, red, nf;  // the f32 work space
  size_t x, dy, b, c, nt;               // the chunk's inputs
  size_t rs, bytes;
  __host__ __device__ BwdLayout(int Q, int P, int N) {
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
    bytes = 4 * (nf + nt);
  }
};

__global__ void __launch_bounds__(kThreads)
    ssd_scan_bwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm,
                        const float* __restrict__ dy, float* __restrict__ dx,
                        float* __restrict__ ddt,
                        float* __restrict__ dB_part,
                        float* __restrict__ dC_part,
                        float* __restrict__ dA_part, float* states, int L,
                        int H, int P, int G, int N, int Q) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const BwdLayout lay(Q, P, N);
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
  float* sx = f + lay.nf + lay.x;
  float* sdy = f + lay.nf + lay.dy;
  float* sb = f + lay.nf + lay.b;
  float* sc = f + lay.nf + lay.c;
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
        [&](int p, int j) { return (sx[j * sp + p]) * coef[j]; },
        [&](int j, int n) { return (sb[j * sn + n]); }, 0, none, none,
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
          [&](int ii, int n) { return (sc[(j0 + ii) * sn + n]); },
          [&](int n, int jj) { return (sb[(j0 + jj) * sn + n]); }, P,
          [&](int ii, int p) { return (sdy[(j0 + ii) * sp + p]); },
          [&](int p, int jj) { return (sx[(j0 + jj) * sp + p]); },
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
          [&](int ii, int p) { return (sdy[(j0 + ii) * sp + p]); }, N,
          [&](int jj, int n) { return (sb[(j0 + jj) * sn + n]); },
          [&](int n, int p) { return dh[p * sn + n]; },
          [&](int jj, int p, float intra, float bd) {
            const int j = j0 + jj;
            dx[((row0 + j) * H + hd) * P + p] =
                intra + coef[j] * bd;
            r3[jj * sp + p] = bd;
          });
      // dB_j = sum_i V_ij C_i + coef_j (x_j dh), this head's share
      tile_products<2, 4>(
          cols, N, rows, [&](int jj, int ii) { return r2[ii * tw + jj]; },
          [&](int ii, int n) { return (sc[(j0 + ii) * sn + n]); }, P,
          [&](int jj, int p) { return (sx[(j0 + jj) * sp + p]); },
          [&](int p, int n) { return dh[p * sn + n]; },
          [&](int jj, int n, float intra, float xd) {
            const int j = j0 + jj;
            dB_part[((row0 + j) * H + hd) * N + n] = intra + coef[j] * xd;
          });
      __syncthreads();
      for (int jj = warp; jj < cols; jj += kWarps) {
        float acc = 0.0f;
        for (int p = lane; p < P; p += kWarp)
          acc += (sx[(j0 + jj) * sp + p]) * r3[jj * sp + p];
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
          [&](int ii, int n) { return (sc[(i0 + ii) * sn + n]); },
          [&](int n, int j) { return (sb[j * sn + n]); }, P,
          [&](int ii, int p) { return (sdy[(i0 + ii) * sp + p]); },
          [&](int p, int j) { return (sx[j * sp + p]); },
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
          [&](int j, int n) { return (sb[j * sn + n]); }, P,
          [&](int ii, int p) { return (sdy[(i0 + ii) * sp + p]); },
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
          acc += (sc[(i0 + ii) * sn + n]) * r2[ii * sn + n];
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
        P, N, Q, [&](int p, int i) { return es[i] * (sdy[i * sp + p]); },
        [&](int i, int n) { return (sc[i * sn + n]); }, 0, none, none,
        [&](int p, int n, float v, float) {
          dh[p * sn + n] = decay * dh[p * sn + n] + v;
        });
  }
  if (tid == 0) dA_part[bh] = dA_acc;
}

// dBm, dCm [B, L, G, N] = the heads of each group of the partials
// [B, L, H, N] summed in order; dA [H] = dA_part [B, H] summed over b.
__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ dB_part,
                                      const float* __restrict__ dC_part,
                                      const float* __restrict__ dA_part,
                                      float* __restrict__ dBm,
                                      float* __restrict__ dCm,
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
      dBm[i] = sb;
      dCm[i] = sc;
    } else {
      const int h = static_cast<int>(i - n_bc);
      float sa = 0.0f;
      for (int bb = 0; bb < batch; ++bb) sa += dA_part[bb * H + h];
      dA[h] = sa;
    }
  }
}

cudaError_t launch_bwd(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* dy,
                       void* dx, void* ddt, void* dBm, void* dCm, void* dA,
                       void* dB_part, void* dC_part, void* dA_part,
                       void* states, int batch, int L, int H, int P, int G,
                       int N, int Q, size_t bytes, cudaStream_t st) {
  static bool set[kMaxDevices] = {};
  cudaError_t err = smem_ceiling(ssd_scan_bwd_kernel, set);
  if (err != cudaSuccess) return err;
  ssd_scan_bwd_kernel<<<batch * H, kThreads, bytes, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(dy),
      static_cast<float*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dB_part), static_cast<float*>(dC_part),
      static_cast<float*>(dA_part), static_cast<float*>(states), L, H, P, G,
      N, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t work = static_cast<size_t>(batch) * L * G * N + H;
  const int blocks = static_cast<int>(
      std::min<size_t>((work + kThreads - 1) / kThreads, 132 * 16));
  ssd_bwd_reduce_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(dB_part), static_cast<const float*>(dC_part),
      static_cast<const float*>(dA_part), static_cast<float*>(dBm),
      static_cast<float*>(dCm), static_cast<float*>(dA), batch, L, H, G, N);
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
// cotangent dy, f32 (dtype 0) only: dx, dBm, dCm in f32, ddt [B, L, H] and
// dA [H]. The caller's scratch: dB_part, dC_part f32 [B, L, H, N], dA_part
// f32 [B, H], states f32 [B, H, L/Q, P, N]. smem_bytes is the wrapper's sum
// (ssd_scan.py::bwd_smem_bytes); a launch whose sizes or bytes this kernel
// does not take is refused. Two kernels launch: the scan, then the sum
// over heads. bf16 takes ssd_scan_bwd_tc_launch.
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
      dtype != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = BwdLayout(Q, P, N).bytes;
  if (bytes != static_cast<size_t>(smem_bytes) || bytes > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_bwd(x, dt, A, Bm, Cm, dy, dx, ddt, dBm, dCm,
                                     dA, dB_part, dC_part, dA_part, states,
                                     batch, L, H, P, G, N, Q, bytes, st));
}

// The bf16 backward (six kernels, see the header of the backward).
// `scratch` is the caller's f32 buffer of ssd_scan_bwd_scratch_floats
// floats (BwdScratch). incr_bytes, chunk_bytes and group_bytes are the
// wrapper's sums (ssd_scan.py::bwd_plan); a launch whose sizes or bytes the
// kernels do not take is refused.
extern "C" int ssd_scan_bwd_tc_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, void* dx, void* ddt, void* dBm, void* dCm,
    void* dA, void* scratch, int batch, int L, int H, int P, int G, int N,
    int Q, int tile, int incr_bytes, int chunk_bytes, int group_bytes,
    void* stream) {
  auto* st = static_cast<cudaStream_t>(stream);
  const int Qp = round16(Q), Pp = round16(P), Np = round16(N);
  if (Q < 1 || L % Q || G < 1 || H % G || P % 8 || N % 8 || P < 1 ||
      N < 1 || Qp > kTcMaxQ || Pp > kTcMaxP || tile < 1 ||
      tile > kBwdTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ns = Np < 32 ? Np : 32, ns4 = Np < 64 ? Np : 64;
  const size_t bytes[3] = {IncrLayout(Qp, Pp, Np).bytes,
                           ChunkLayout(Qp, Pp, ns).bytes,
                           GroupLayout(Qp, Pp, ns4).bytes};
  const int want[3] = {incr_bytes, chunk_bytes, group_bytes};
  for (int k = 0; k < 3; ++k)
    if (want[k] < 0 || bytes[k] != static_cast<size_t>(want[k]) ||
        bytes[k] > kMaxSmem)
      return static_cast<int>(cudaErrorInvalidValue);
  const BwdScratch sc(batch, L, H, P, G, N, Q, tile);
  cudaError_t err;
#define SSD_BWD_TC(NP)                                                      \
  launch_bwd_tc<NP>(x, dt, A, Bm, Cm, dy, dx, ddt, dBm, dCm, dA,            \
                    static_cast<float*>(scratch), sc, batch, L, H, P, G, N, \
                    Q, tile, bytes[0], bytes[1], bytes[2], st)
  switch (Np) {
    case 16:
      err = SSD_BWD_TC(16);
      break;
    case 32:
      err = SSD_BWD_TC(32);
      break;
    case 64:
      err = SSD_BWD_TC(64);
      break;
    case 128:
      err = SSD_BWD_TC(128);
      break;
    default:
      err = cudaErrorInvalidValue;  // N = 40, 56, ...: not a template
  }
#undef SSD_BWD_TC
  return static_cast<int>(err);
}

// Floats of the bf16 backward's scratch at these sizes (BwdScratch).
extern "C" long long ssd_scan_bwd_scratch_floats(int batch, int L, int H,
                                                 int P, int G, int N, int Q,
                                                 int tile) {
  if (Q < 1 || L % Q || G < 1 || H % G || tile < 1) return -1;
  return static_cast<long long>(
      BwdScratch(batch, L, H, P, G, N, Q, tile).floats);
}

// CTAs of one of the bf16 backward's kernels that one SM holds at once
// for these sizes (cudaOccupancyMaxActiveBlocksPerMultiprocessor: shared
// memory, registers and threads): kernel 0 the increments, 1 the chunk
// body, 2 the group products; -1 for sizes they do not take.
extern "C" int ssd_scan_bwd_resident_ctas(int P, int N, int Q, int kernel) {
  const int Qp = round16(Q), Pp = round16(P), Np = round16(N);
  const int ns = Np < 32 ? Np : 32, ns4 = Np < 64 ? Np : 64;
  int ctas = -1;
  cudaError_t err = cudaErrorInvalidValue;
#define SSD_BWD_OCC(NP)                                                      \
  if (kernel == 0)                                                           \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                     \
        &ctas, ssd_bwd_increments_kernel<NP>, kTcThreads,                    \
        IncrLayout(Qp, Pp, NP).bytes);                                       \
  else if (kernel == 1)                                                      \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                     \
        &ctas, ssd_bwd_chunk_kernel<NP>, kTcThreads,                         \
        ChunkLayout(Qp, Pp, ns).bytes);                                      \
  else if (kernel == 2)                                                      \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                     \
        &ctas, ssd_bwd_group_kernel<NP>, kGroupThreads,                      \
        GroupLayout(Qp, Pp, ns4).bytes);
  switch (Np) {
    case 16:
      SSD_BWD_OCC(16)
      break;
    case 32:
      SSD_BWD_OCC(32)
      break;
    case 64:
      SSD_BWD_OCC(64)
      break;
    case 128:
      SSD_BWD_OCC(128)
      break;
    default:
      break;
  }
#undef SSD_BWD_OCC
  return err == cudaSuccess ? ctas : -1;
}
