// Streamed matmul (K3) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/streamed_matmul/kernel.py:37
// (`streamed_matmul`, Pallas call at :51): (M, K) @ (K, N) -> (M, N) in
// x's dtype, with an fp32 accumulator carried across the K grid axis and
// the weight tiles streamed through VMEM -- the Tensor Prefetcher at tile
// grain.  The TPU's sequential K axis becomes a K loop inside a CTA (and,
// where one CTA per output tile would leave SMs idle, a split of K over
// CTAs whose fp32 partials are summed in split order); ragged edges are
// masked or zero-filled here, so the wrapper pads nothing and the TPU
// wrapper's bm/bk/bn do not reach the card.
//
// What bounds it on this card: at decode widths (M <= 8) the weight bytes,
// 2 * K * N at 3.35 TB/s; at prefill widths the tensor-core rate,
// 2 * M * K * N at 989 TFLOP/s in bf16.  fp32 runs on the CUDA cores in
// full fp32 (no TF32: the reference holds it to 2e-4), bound by 67 TFLOP/s.
//
// Four routes, chosen by the wrapper's `plan` (kernel.py) from the shape,
// the dtype and the alignment alone -- never after a failure:
//   * wgmma (bf16, M > 8, TMA-describable): 128 x 256 output tiles, a ring
//     of 4 stages of 128 x 64 A and 64 x 256 B tiles loaded by TMA with the
//     128-byte swizzle, full/empty mbarriers; one producer warpgroup (one
//     thread issues the loads) and two consumer warpgroups, each running
//     wgmma.mma_async m64n256k16 with fp32 accumulators in registers.  A is
//     K-major, B (w, row-major (K, N)) is N-major: its descriptors carry the
//     transpose bit and the MN-major SW128 strides (LBO = the 64-column
//     chunk stride, SBO = 8 K rows).  Tiles are walked in groups of 16 row
//     tiles so that a wave of CTAs shares each weight tile in L2.  The
//     epilogue rounds once to bf16 and masks the ragged M/N edges.
//   * splitk (bf16, small M, 16-byte aligned): weight streaming.  A CTA
//     owns 256 columns and a K chunk; each warp streams its rows with two
//     ping-pong batches of 16-byte loads a lane (one in flight while the
//     other is consumed) and FMAs them against x (held as fp32 in shared
//     memory, up to 96 KB).  K is split so that the grid is as close to
//     one full wave of resident CTAs (two an SM) as the column tiles allow:
//     216 and 260 CTAs at Qwen2.5-14B's two MLP shapes.  Partials go to an
//     fp32 scratch; the last CTA of a column tile (a counter behind
//     __threadfence, reset by that CTA) sums them in split order and
//     rounds once: two launches give the same bits.
//   * wmma (bf16 that TMA cannot describe: ragged K or N, unaligned
//     views): 128 x 128 tiles, 32-deep K slices, register double buffer,
//     wmma 16x16x16 fragments -- the first version of this kernel.
//   * f32: 64 x 64 tiles, 4 x 4 outputs a thread, fmaf in K order; K split
//     over CTAs as in splitk when the tiles alone would not fill the SMs.
// No library GEMM (cuBLAS, CUTLASS device GEMMs) is called.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

// The last CTA of a split group: every thread calls this after writing its
// partial; it returns true in the one CTA that arrived last, which then
// reads the others' partials (behind the fences) and resets the counter.
__device__ bool arrive_last(int* counter, int splits) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == splits - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// ------------------------------------------------ wmma (bf16, unaligned)
namespace wr {
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

}  // namespace wr

// ---------------------------------------------------------------- fp32
namespace f32 {
constexpr int BM = 64, BN = 64, BK = 16, NT = 256;

// grid (N tiles, M tiles, splits): split z covers K rows
// [z * kchunk, (z + 1) * kchunk)
__global__ void __launch_bounds__(NT) matmul_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    float* __restrict__ out, float* __restrict__ partial,
    int* __restrict__ counters, int M, int N, int K, long long ldx,
    long long ldw, int kchunk, int splits) {
  __shared__ float As[BK][BM + 4];   // transposed: As[k][m]
  __shared__ float Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * kchunk, ke = min(K, kb + kchunk);
  float acc[4][4] = {};
  for (int k0 = kb; k0 < ke; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      const int row = m0 + r, k = k0 + c;
      As[c][r] = (row < M && k < ke) ? x[row * ldx + k] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int r = e / BN, c = e % BN;
      const int k = k0 + r, col = n0 + c;
      Bs[r][c] = (k < ke && col < N) ? w[k * ldw + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
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
  float* dst = splits == 1 ? out : partial + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty * 4 + i, col = n0 + tx * 4 + j;
      if (row < M && col < N) dst[(size_t)row * N + col] = acc[i][j];
    }
  if (splits == 1 ||
      !arrive_last(&counters[blockIdx.y * gridDim.x + blockIdx.x], splits))
    return;
  // the last CTA of this tile: the partials in split order, fp32, four
  // splits' loads in flight at a time
  float sum[4][4] = {};
  for (int z0 = 0; z0 < splits; z0 += 4) {
    float v[4][4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = m0 + ty * 4 + i, col = n0 + tx * 4 + j;
          v[u][i][j] = (z0 + u < splits && row < M && col < N)
              ? __ldcg(partial + ((size_t)(z0 + u) * M + row) * N + col)
              : 0.f;
        }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (z0 + u < splits) sum[i][j] += v[u][i][j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty * 4 + i, col = n0 + tx * 4 + j;
      if (row < M && col < N) out[(size_t)row * N + col] = sum[i][j];
    }
}
}  // namespace f32

// ------------------------------------------------- splitk (bf16 decode)
namespace sk {
constexpr int NT = 256, WARPS = NT / 32;
constexpr int BN = 256;      // 32 lanes x 8 columns (16 bytes) each
// CTAs an SM is guaranteed to hold (launch bounds, and at most SMEM of
// shared memory each): the planner sizes the grid to one wave of them, so
// no SM waits on a short last wave
constexpr int RESIDENT = 2;
constexpr int SMEM = 96 * 1024;
// 16-byte weight loads a lane issues at once; two such batches ping-pong,
// so the next batch is in flight while this one is consumed
__host__ __device__ constexpr int unroll(int mt) { return mt <= 4 ? 8 : 4; }

__device__ __forceinline__ uint4 load_stream(const bf16* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void widen8(const uint4& v, float (&f)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// MT >= M rows of x; grid (N / BN tiles, splits); dynamic shared memory
// (MT * kchunk + WARPS * BN) floats, at most SMEM.  Needs w 16-byte aligned with
// ldw % 8 == 0 and N % 8 == 0 (a lane's 8 columns are wholly in or out).
template <int MT>
__global__ void __launch_bounds__(NT, RESIDENT) matmul_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    bf16* __restrict__ out, float* __restrict__ partial,
    int* __restrict__ counters, int M, int N, int K, long long ldx,
    long long ldw, int kchunk, int splits) {
  extern __shared__ float smem[];
  float* xs = smem;                  // MT x kchunk, fp32
  float* red = smem + MT * kchunk;   // WARPS x BN
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BN;
  const int kb = blockIdx.y * kchunk, kl = min(K, kb + kchunk) - kb;
  // x's chunk in 16-byte loads (kchunk, kb, ldx: multiples of 8)
  const int row8 = kchunk / 8;
  for (int i = tid; i < MT * row8; i += NT) {
    const int m = i / row8, kk = (i - m * row8) * 8;
    float f[8];
    if (m < M && kk < kl) {
      widen8(*reinterpret_cast<const uint4*>(x + m * ldx + kb + kk), f);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(xs + m * kchunk + kk);
    d[0] = make_float4(f[0], f[1], f[2], f[3]);
    d[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  __syncthreads();

  const int n = n0 + lane * 8;
  const bool live = n < N;
  const bf16* wp = w + (long long)kb * ldw + n;
  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;

  constexpr int UNROLL = unroll(MT), STEP = WARPS * UNROLL;
  // rows r, r + WARPS, ... of this warp: batch a while b flies, and back
  uint4 va[UNROLL], vb[UNROLL];
  auto issue = [&](uint4 (&v)[UNROLL], int r) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u * WARPS;
      v[u] = (live && rr < kl) ? load_stream(wp + (long long)rr * ldw)
                               : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto consume = [&](const uint4 (&v)[UNROLL], int r) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u * WARPS;
      if (rr >= kl) break;
      float f[8];
      widen8(v[u], f);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = xs[m * kchunk + rr];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xv, f[j], acc[m][j]);
      }
    }
  };
  issue(va, warp);
  for (int r = warp; r < kl; r += 2 * STEP) {
    issue(vb, r + STEP);
    consume(va, r);
    issue(va, r + 2 * STEP);
    consume(vb, r + STEP);
  }

  // the warps' sums, one row at a time, in warp order
  float* dst = splits == 1 ? nullptr : partial + (size_t)blockIdx.y * M * N;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float4* rw = reinterpret_cast<float4*>(red + warp * BN + lane * 8);
    rw[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    rw[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) s += red[q * BN + tid];
    const int col = n0 + tid;
    if (m < M && col < N) {
      if (splits == 1)
        out[(size_t)m * N + col] = __float2bfloat16(s);
      else
        dst[(size_t)m * N + col] = s;
    }
    __syncthreads();
  }
  if (splits == 1 || !arrive_last(&counters[blockIdx.x], splits)) return;
  // the last CTA of this column tile: the partials in split order, four
  // splits' loads in flight at a time
  const int col = n0 + tid;
  if (col >= N) return;
  float sum[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) sum[m] = 0.f;
  for (int z0 = 0; z0 < splits; z0 += 4) {
    float v[4][MT];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        v[u][m] = (z0 + u < splits && m < M)
            ? __ldcg(partial + ((size_t)(z0 + u) * M + m) * N + col) : 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (z0 + u < splits) sum[m] += v[u][m];
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
    if (m < M) out[(size_t)m * N + col] = __float2bfloat16(sum[m]);
}
}  // namespace sk

// --------------------------------------------- wgmma (bf16, TMA-aligned)
namespace wg {
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4, NT = 384;
constexpr int GROUP_M = 16;                // row tiles walked together
constexpr int A_BYTES = BM * BK * 2;       // 16 KB: 128 rows x 128 B
constexpr int B_CHUNK = BK * 64 * 2;       // 8 KB: 64 K rows x 64 columns
constexpr int B_BYTES = B_CHUNK * (BN / 64);
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

using namespace hopper;   // mbarriers, TMA loads, SW128 descriptors

__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 256, fp32) += A (64 x 16, K-major) * B (16 x 256, N-major:
// transpose bit set)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// grid: one CTA per 128 x 256 output tile (1-D, grouped by 16 row tiles);
// 384 threads: warpgroups 0 and 1 consume (rows 0-63 and 64-127 of the
// tile), warpgroup 2 produces.
__global__ void __launch_bounds__(NT, 1) matmul_kernel(
    const __grid_constant__ CUtensorMap tm_x,
    const __grid_constant__ CUtensorMap tm_w, bf16* __restrict__ out, int M,
    int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t a0 = smem_u32(base);
  const uint32_t b0 = a0 + STAGES * A_BYTES;
  const uint32_t full0 = a0 + STAGES * STAGE_BYTES;
  const uint32_t empty0 = full0 + STAGES * 8;

  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int per_group = GROUP_M * tiles_n;
  const int group = blockIdx.x / per_group, first_m = group * GROUP_M;
  const int gsize = min(tiles_m - first_m, GROUP_M);
  const int in_group = blockIdx.x - group * per_group;
  const int tile_m = first_m + in_group % gsize, tile_n = in_group / gsize;
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(empty0 + 8 * s, ph ^ 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, STAGE_BYTES);
        tma_load(a0 + s * A_BYTES, &tm_x, bar, kt * BK, tile_m * BM);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load(b0 + s * B_BYTES + j * B_CHUNK, &tm_w, bar,
                   tile_n * BN + j * 64, kt * BK);
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: wgmma on the stages that have landed
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    const int lane = threadIdx.x & 31;
    int s = 0, prev = 0;
    uint32_t ph = 0;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(full0 + 8 * s, ph);
      // A: this warpgroup's 64 rows, K-major, SBO = 8 rows of 128 B;
      // B: N-major, LBO = one 64-column chunk, SBO = 8 K rows
      const uint64_t da =
          sw128_desc(a0 + s * A_BYTES + wgi * 64 * 128, 16, 1024);
      const uint64_t db = sw128_desc(b0 + s * B_BYTES, B_CHUNK, 1024);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n256k16(acc, da + 2 * kk,          // 32 B along K
                         db + (16 * 128 >> 4) * kk);  // 16 K rows
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      fence_acc(acc);
      // the previous stage's products are done: release its buffers
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_acc(acc);
      if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
      prev = s;
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);

    // epilogue: d[4j + 2h + e] is row (warp * 16 + lane / 4 + 8h), column
    // (8j + 2 (lane % 4) + e) of this warpgroup's 64 x 256 block
    const int warp = (threadIdx.x & 127) >> 5;
    const int row0 = tile_m * BM + wgi * 64 + warp * 16 + (lane >> 2);
    const int col0 = tile_n * BN + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + j * 8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < M && col < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

}  // namespace wg

template <int MT>
int launch_splitk(const bf16* x, const bf16* w, bf16* out, float* partial,
                  int* counters, int M, int N, int K, long long ldx,
                  long long ldw, int kchunk, int splits, cudaStream_t s) {
  const size_t smem = sizeof(float) * ((size_t)MT * kchunk + sk::WARPS * sk::BN);
  if (smem > sk::SMEM) return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        sk::matmul_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        sk::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  dim3 grid((N + sk::BN - 1) / sk::BN, splits);
  sk::matmul_kernel<MT><<<grid, sk::NT, smem, s>>>(
      x, w, out, partial, counters, M, N, K, ldx, ldw, kchunk, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Route codes (kernel.py's ROUTES order): 0 = wgmma, 1 = splitk, 2 = wmma,
// 3 = f32.  x: (M, K) with row stride ldx, w: (K, N) with row stride ldw,
// both with a contiguous last dim; out: a contiguous (M, N) of x's dtype
// (fp32 for f32, bf16 otherwise).  splits > 1 (splitk, f32): partial is an
// fp32 (splits, M, N) scratch and counters one zeroed int per output tile
// (left zeroed again); K is split into chunks of kchunk rows.  Returns
// cudaGetLastError() after the launch (0 = launched) or an error code for
// arguments the route does not take.
extern "C" int streamed_matmul_launch(const void* x, const void* w,
                                      void* out, void* partial,
                                      void* counters, int M, int N, int K,
                                      long long ldx, long long ldw, int route,
                                      int splits, int kchunk, void* stream) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 || kchunk < 1 ||
      (long long)splits * kchunk < K || (splits > 1 && !(partial && counters)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  float* pf = static_cast<float*>(partial);
  int* ct = static_cast<int*>(counters);
  const bool aligned = K % 8 == 0 && N % 8 == 0 && ldx % 8 == 0 &&
                       ldw % 8 == 0 &&
                       ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  if (route == 0) {   // wgmma
    if (!aligned || splits != 1) return (int)cudaErrorInvalidValue;
    const long long tiles = (long long)((M + wg::BM - 1) / wg::BM) *
                            ((N + wg::BN - 1) / wg::BN);
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    CUtensorMap tm_x, tm_w;
    int rc = wg::encode(&tm_x, x, K, M, ldx * 2, wg::BK, wg::BM);
    if (rc == 0) rc = wg::encode(&tm_w, w, N, K, ldw * 2, 64, wg::BK);
    if (rc != 0) return rc;
    static bool attr = false;
    if (!attr) {
      cudaError_t err = cudaFuncSetAttribute(
          wg::matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          wg::SMEM);
      if (err != cudaSuccess) return (int)err;
      attr = true;
    }
    wg::matmul_kernel<<<(unsigned)tiles, wg::NT, wg::SMEM, s>>>(tm_x, tm_w, ob,
                                                               M, N, K);
    return (int)cudaGetLastError();
  }
  if (route == 1) {   // splitk
    if (!aligned || M > 8) return (int)cudaErrorInvalidValue;
    if (M == 1)
      return launch_splitk<1>(xb, wb, ob, pf, ct, M, N, K, ldx, ldw, kchunk,
                              splits, s);
    if (M == 2)
      return launch_splitk<2>(xb, wb, ob, pf, ct, M, N, K, ldx, ldw, kchunk,
                              splits, s);
    if (M <= 4)
      return launch_splitk<4>(xb, wb, ob, pf, ct, M, N, K, ldx, ldw, kchunk,
                              splits, s);
    return launch_splitk<8>(xb, wb, ob, pf, ct, M, N, K, ldx, ldw, kchunk,
                            splits, s);
  }
  if (route == 2) {   // wmma
    dim3 grid((N + wr::BN - 1) / wr::BN, (M + wr::BM - 1) / wr::BM);
    if (grid.y > 65535 || splits != 1) return (int)cudaErrorInvalidValue;
    if (aligned)
      wr::matmul_bf16_kernel<true><<<grid, wr::NT, 0, s>>>(xb, wb, ob, M, N, K,
                                                          ldx, ldw);
    else
      wr::matmul_bf16_kernel<false><<<grid, wr::NT, 0, s>>>(xb, wb, ob, M, N,
                                                           K, ldx, ldw);
    return (int)cudaGetLastError();
  }
  if (route == 3) {   // f32
    dim3 grid((N + f32::BN - 1) / f32::BN, (M + f32::BM - 1) / f32::BM, splits);
    if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
    f32::matmul_kernel<<<grid, f32::NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), pf, ct, M, N, K, ldx, ldw, kchunk, splits);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
