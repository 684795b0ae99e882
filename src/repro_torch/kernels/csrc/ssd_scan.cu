// Mamba-2 SSD chunked scan (state-space duality) for Hopper (sm_90a).
//
// Replaces, in the JAX package:
//   ssd_scan_kernel <- repro/kernels/ssd_scan.py::ssd_scan (body _ssd_kernel)
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
// Everything is computed in f32 from inputs of any of the two dtypes
// (f32, bf16); y is stored in x's dtype, the final state in f32.
//
// What bounds it. Per chunk, three products: C.B^T [Q, Q] over N, the
// masked weights times x [Q, P] over Q, C.h0^T [Q, P] over N, and the
// state update [P, N] over Q: 2Q^2 N + 2Q^2 P + 4QPN flops. At the
// models' prefill shapes (Q=128, P=64, N=64 or 128, bf16 in and out) that
// is 176-283 flops per byte moved, far above the f32 ridge of 67 TF/s over
// 3.35 TB/s (20 flops per byte): operations bind, at the f32 rate, since
// this kernel computes in f32 as the reference does.
//
// Design (simple first; wgmma, TMA and bf16 tensor cores are later work).
// One CTA of 256 threads per (b, h) walks its chunks in order. The state
// h0 [P, N] lives in shared memory for the whole sequence and leaves it
// only when the final state is asked for. A chunk's x [Q, P], B and C
// [Q, N] are staged in shared memory as f32 (rows of B, C and h padded to
// N + 1 floats, so threads reading different rows at one n hit different
// banks). The [Q, Q] weight matrix is built in row tiles of kTQ rows, so
// mamba2-130m's chunk (N = 128) fits in f32: at most kTQ x Q floats of it
// live at once. Every product is a register-tiled loop over shared
// memory: a 16 x 16 grid of threads, each owning an RM x RN tile of the
// output, f32 FMAs. The causal mask skips j > i and never takes exp
// there (e^{s_i - s_j} overflows for j > i, and inf * 0 is NaN); the
// intra-chunk products stop at the tile's last row, so the upper triangle
// is neither computed nor read.
//
// C interface (bound with ctypes): the launcher returns the cudaError_t
// of the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGrid = 16;  // threads per side of the 16 x 16 tile grid
constexpr int kTQ = 32;    // rows of the weight matrix built at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, T* __restrict__ y,
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
      sx[i] = to_f32(x[((row0 + j) * H + hd) * P + p]);
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int j = i / N, n = i % N;
      const size_t at = ((row0 + j) * G + g) * N + n;
      sb[j * sn + n] = to_f32(Bm[at]);
      sc[j * sn + n] = to_f32(Cm[at]);
    }
    for (int j = tid; j < Q; j += kThreads) sdt[j] = dt[(row0 + j) * H + hd];
    __syncthreads();
    if (tid == 0) {  // the inclusive cumsum, in order
      float acc = 0.0f;
      for (int j = 0; j < Q; ++j) {
        acc = __fadd_rn(acc, __fmul_rn(sdt[j], a));
        s[j] = acc;
      }
    }
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
            store(y + ((row0 + i) * H + hd) * P + p,
                  __fadd_rn(intra, __fmul_rn(expf(s[i]), inter)));
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

// Dynamic shared memory of a launch, in bytes (the wrapper checks the same
// sum against the card's limit): h [P][N+1], B and C [Q][N+1], x [Q][P],
// a weight row tile [kTQ][Q] and three [Q] vectors, all f32.
size_t smem_bytes(int P, int N, int Q) {
  const size_t sn = static_cast<size_t>(N) + 1;
  return sizeof(float) *
         (P * sn + 2 * Q * sn + static_cast<size_t>(Q) * P +
          static_cast<size_t>(kTQ) * Q + 3 * static_cast<size_t>(Q));
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (x, Bm, Cm and y); dt and A are f32; h_out is
// f32 [B, H, P, N] or null.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* h_out, int batch, int L, int H, int P,
                               int G, int N, int Q, int dtype, void* stream) {
  const size_t bytes = smem_bytes(P, N, Q);
  const dim3 grid(batch * H);
  auto* st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(ssd_scan_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_scan_kernel<float><<<grid, kThreads, bytes, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), static_cast<float*>(y),
        static_cast<float*>(h_out), L, H, P, G, N, Q);
  } else {
    err = cudaFuncSetAttribute(ssd_scan_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_scan_kernel<__nv_bfloat16><<<grid, kThreads, bytes, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(Bm),
        static_cast<const __nv_bfloat16*>(Cm),
        static_cast<__nv_bfloat16*>(y), static_cast<float*>(h_out), L, H, P,
        G, N, Q);
  }
  return static_cast<int>(cudaGetLastError());
}
