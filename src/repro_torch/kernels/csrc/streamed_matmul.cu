// Streamed matmul (K3) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/streamed_matmul/kernel.py:37
// (`streamed_matmul`, Pallas call at :51): (M, K) @ (K, N) -> (M, N) in
// x's dtype, with an fp32 accumulator carried across the K grid axis and
// the weight tiles streamed through VMEM -- the Tensor Prefetcher at tile
// grain.  Here one CTA owns one output tile and loops over K itself: that
// loop takes the place of the TPU's sequential K axis, and the next K
// slice is loaded from device memory into registers while the tensor cores
// consume the current one from shared memory (a register double buffer).
// Ragged edges of M, N and K are masked in the kernel (zeros), so the
// wrapper pads nothing; the TPU wrapper's bm/bk/bn do not reach the card.
//
// What bounds it on this card: at decode widths (M = 4) the weight bytes,
// 2 * K * N at 3.35 TB/s; at prefill widths (M in the thousands) the
// tensor-core rate, 2 * M * K * N at 989 TFLOP/s in bf16.  fp32 runs on the
// CUDA cores in full fp32 (no TF32: the reference holds it to 2e-4), bound
// by 67 TFLOP/s.
//
// Design (a first, simple version; wgmma + TMA pipelines are later work):
//   * bf16: 128 x 128 output tiles, 32-deep K slices, 8 warps of 64 x 32
//     each, wmma 16x16x16 fragments with fp32 accumulators; 16-byte loads
//     when K, N, the row strides and the pointers allow, scalar masked
//     loads otherwise.  Decode rows (M = 4) still run a full 128-row tile:
//     the weight stream, not the wasted tensor work, is the bound there.
//   * fp32: 64 x 64 tiles, 16-deep slices, 4 x 4 outputs a thread, fmaf in
//     K order.
// No library GEMM (cuBLAS, CUTLASS device GEMMs) is called.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

// ---------------------------------------------------------------- bf16
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int NT = 256;                    // 8 warps: 2 (rows) x 4 (cols)
constexpr int WM = 64, WN = 32;            // one warp's sub-tile
constexpr int FM = WM / 16, FN = WN / 16;  // its 4 x 2 wmma fragments
constexpr int LDA = BK + 8, LDB = BN + 8;  // padded rows, 16-byte aligned

// 8 consecutive elements p[row * ld + col .. +8), zero outside
// [0, rows) x [0, cols).  VEC: 16-byte aligned and cols % 8 == 0, so a
// chunk is either wholly inside or wholly outside.
template <bool VEC>
__device__ __forceinline__ uint4 load8(const bf16* __restrict__ p, int row,
                                       int col, int rows, int cols,
                                       long long ld) {
  if constexpr (VEC) {
    if (row < rows && col < cols)
      return *reinterpret_cast<const uint4*>(p + row * ld + col);
    return make_uint4(0u, 0u, 0u, 0u);
  } else {
    union {
      uint4 v;
      bf16 h[8];
    } u;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      u.h[e] = (row < rows && col + e < cols) ? p[row * ld + col + e]
                                              : __float2bfloat16(0.f);
    return u.v;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NT) matmul_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    bf16* __restrict__ out, int M, int N, int K, long long ldx,
    long long ldw) {
  __shared__ __align__(128) bf16 As[2][BM][LDA];
  __shared__ __align__(128) bf16 Bs[2][BK][LDB];
  __shared__ __align__(128) float Cs[NT / 32][16][16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // each thread moves two 8-element chunks of each tile per K slice:
  // A is BM x BK (4 chunks a row), B is BK x BN (16 chunks a row)
  uint4 ra[2], rb[2];
  auto gload = [&](int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tid + j * NT;
      ra[j] = load8<VEC>(x, m0 + (c >> 2), k0 + (c & 3) * 8, M, K, ldx);
      rb[j] = load8<VEC>(w, k0 + (c >> 4), n0 + (c & 15) * 8, K, N, ldw);
    }
  };
  auto sstore = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tid + j * NT;
      *reinterpret_cast<uint4*>(&As[buf][c >> 2][(c & 3) * 8]) = ra[j];
      *reinterpret_cast<uint4*>(&Bs[buf][c >> 4][(c & 15) * 8]) = rb[j];
    }
  };

  const int nk = (K + BK - 1) / BK;
  gload(0);
  sstore(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) gload(kt + 1);   // in flight while this slice computes
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], &As[buf][wm * WM + i * 16][kk], LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], &Bs[buf][kk][wn * WN + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    // buf ^ 1 was last read in slice kt - 1, behind the barrier below
    if (kt + 1 < nk) sstore(buf ^ 1);
    __syncthreads();
  }

  // epilogue: each fragment through this warp's 16 x 16 fp32 staging
  // tile, rounded once to bf16, masked at the ragged edges
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(&Cs[warp][0][0], acc[i][j], 16,
                              wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, c = e & 15;
        const int row = m0 + wm * WM + i * 16 + r;
        const int col = n0 + wn * WN + j * 16 + c;
        if (row < M && col < N)
          out[(long long)row * N + col] = __float2bfloat16(Cs[warp][r][c]);
      }
      __syncwarp();
    }
}

// ---------------------------------------------------------------- fp32
constexpr int FBM = 64, FBN = 64, FBK = 16;

__global__ void __launch_bounds__(NT) matmul_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ out, int M, int N, int K, long long ldx,
    long long ldw) {
  __shared__ float As[FBK][FBM + 4];   // transposed: As[k][m]
  __shared__ float Bs[FBK][FBN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FBK) {
    for (int e = tid; e < FBM * FBK; e += NT) {
      const int r = e / FBK, c = e % FBK;
      const int row = m0 + r, k = k0 + c;
      As[c][r] = (row < M && k < K) ? x[row * ldx + k] : 0.f;
    }
    for (int e = tid; e < FBK * FBN; e += NT) {
      const int r = e / FBN, c = e % FBN;
      const int k = k0 + r, col = n0 + c;
      Bs[r][c] = (k < K && col < N) ? w[k * ldw + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty * 4 + i, col = n0 + tx * 4 + j;
      if (row < M && col < N) out[(long long)row * N + col] = acc[i][j];
    }
}

}  // namespace

// x: (M, K) with row stride ldx, w: (K, N) with row stride ldw, both with
// a contiguous last dim; out: a contiguous (M, N).  dtype: 0 = float32,
// 1 = bfloat16.  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int streamed_matmul_launch(const void* x, const void* w,
                                      void* out, int M, int N, int K,
                                      long long ldx, long long ldw,
                                      int dtype, void* stream) {
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    matmul_f32_kernel<<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), M, N, K, ldx, ldw);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    const bool vec = K % 8 == 0 && N % 8 == 0 && ldx % 8 == 0 &&
                     ldw % 8 == 0 &&
                     ((reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(w)) & 15) == 0;
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    bf16* ob = static_cast<bf16*>(out);
    if (vec)
      matmul_bf16_kernel<true><<<grid, NT, 0, s>>>(xb, wb, ob, M, N, K, ldx,
                                                   ldw);
    else
      matmul_bf16_kernel<false><<<grid, NT, 0, s>>>(xb, wb, ob, M, N, K, ldx,
                                                    ldw);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
