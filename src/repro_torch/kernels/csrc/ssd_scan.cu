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
