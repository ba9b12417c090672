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
// full fp32 (no TF32: the reference holds it to 2e-4), at most 67 TFLOP/s;
// fp32-accurate products could run at 3xTF32's 495 / 3 = 165.
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
//   * realign (bf16 that TMA cannot describe: any base offset, any row
//     stride, ragged K or N, any M): the wgmma route's consumers -- its
//     128 x 256 tiles, wgmma m64n256k16 over 128-byte-swizzled stages,
//     mbarrier ring and epilogue (single stores where N is odd) -- fed by
//     a producer warpgroup in place of the TMA thread.  For each row of an
//     A (128 x 64) or B (64 x 256) tile it copies the aligned 16-byte
//     chunks that cover the row (cp.async, into a raw ring of 2 stages;
//     only chunks that hold an element of the operand are read, so no
//     read leaves its pages), then realigns: each output chunk from the
//     words that hold it, shifted by the row's offset in its chunk (0-7
//     elements, which changes from row to row at an odd stride but not
//     from stage to stage, nor between rows 8 apart: a warp takes rows of
//     one offset at a time and switches on it uniformly), zeroed past K,
//     N and M, stored at its 128-byte-swizzle address; then every producer
//     thread fences for the async proxy (wgmma's reads) and arrives on the
//     stage's full barrier (a thread count, no transaction bytes).
//     setmaxnreg caps the producer's registers.  What bounds it,
//     measured on the H100 (tools/kernel_variants.py, PERF.md): the
//     producer -- its raw copies with wgmma alone take 0.76 ms at
//     (2048, 5120) @ (5120, 13824), 1.7x the wgmma route's time, and its
//     realign adds as much again.  Loading the chunks into registers
//     (ld.global.nc) held too few bytes in flight to keep up, and 1-D bulk
//     copies, one a row, were slower (set aside while this route was
//     written).
//   * f32: 64 x 64 tiles, 4 x 4 outputs a thread, fmaf in K order; K split
//     over CTAs as in splitk when the tiles alone would not fill the SMs.
// No library GEMM (cuBLAS, CUTLASS device GEMMs) is called.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

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

// this CTA's output tile: a 1-D grid walked in groups of GROUP_M row
// tiles, so that a wave of CTAs shares each weight tile in L2
__device__ __forceinline__ void tile_of(int M, int N, int& tile_m,
                                        int& tile_n) {
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int per_group = GROUP_M * tiles_n;
  const int group = blockIdx.x / per_group, first_m = group * GROUP_M;
  const int gsize = min(tiles_m - first_m, GROUP_M);
  const int in_group = blockIdx.x - group * per_group;
  tile_m = first_m + in_group % gsize;
  tile_n = in_group / gsize;
}

// one consumer warpgroup (wgi 0 or 1: rows 64 wgi .. 64 wgi + 63 of the
// tile): wgmma on the stages that have landed, each stage released to the
// producer once the next one's products are issued; then the epilogue
template <int NS>
__device__ __forceinline__ void consume(uint32_t a0, uint32_t b0,
                                        uint32_t full0, uint32_t empty0,
                                        bf16* __restrict__ out, int M, int N,
                                        int tile_m, int tile_n, int nk,
                                        int wgi) {
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
    if (++s == NS) {
      s = 0;
      ph ^= 1;
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(acc);

  // epilogue: d[4j + 2h + e] is row (warp * 16 + lane / 4 + 8h), column
  // (8j + 2 (lane % 4) + e) of this warpgroup's 64 x 256 block; pairs of
  // columns where N is even, single ones where it is odd (ragged N)
  const int warp = (threadIdx.x & 127) >> 5;
  const int row0 = tile_m * BM + wgi * 64 + warp * 16 + (lane >> 2);
  const int col0 = tile_n * BN + (lane & 3) * 2;
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + j * 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M || col >= N) continue;
      bf16* dst = out + (size_t)row * N + col;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      } else {
        dst[0] = __float2bfloat16(acc[4 * j + 2 * h]);
        if (col + 1 < N) dst[1] = __float2bfloat16(acc[4 * j + 2 * h + 1]);
      }
    }
  }
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
  int tile_m, tile_n;
  tile_of(M, N, tile_m, tile_n);
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
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    consume<STAGES>(a0, b0, full0, empty0, out, M, N, tile_m, tile_n, nk,
                    wgi);
  }
}

}  // namespace wg

// ------------------------------- realign (bf16 that TMA cannot describe)
namespace ra {
using namespace hopper;
using wg::BM;
using wg::BN;
using wg::BK;
using wg::A_BYTES;
using wg::B_BYTES;
using wg::B_CHUNK;
using wg::NT;                              // 2 consumer + 1 producer warpgroup
constexpr int SW = 2;                      // swizzled stages (wgmma's)
constexpr int RAW = 2;                     // raw stages (cp.async)
constexpr int RA_PITCH = 9 * 16;           // an A row's aligned chunks
constexpr int RB_PITCH = 33 * 16;          // a B row's
constexpr int RA_BYTES = BM * RA_PITCH;    // 18 KB
constexpr int RAW_BYTES = RA_BYTES + BK * RB_PITCH;   // + 33 KB
constexpr int SMEM = 1024 + SW * (A_BYTES + B_BYTES) + RAW * RAW_BYTES +
                     8 * (2 * SW + RAW);
static_assert(SMEM <= 232448, "fits the SM's shared memory");
// registers a thread after setmaxnreg.  ptxas compiles the whole kernel
// at the launch bound's 168 and a region after a setmaxnreg.dec at its
// count: the consumers keep their 128 accumulators, and the producer's
// fully unrolled loops fit 120 (at 88 they spill, and unrolled by 4 take
// 1.18x the time; tools/kernel_variants.py, PERF.md)
constexpr int PRODUCER_REGS = 120, CONSUMER_REGS = 192;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 65536,
              "the register file");

// the 16 bytes at byte `shift` (even, 0..14) of p[0 .. 32): the words
// that hold them read with the widest loads their alignment allows (a
// warp-uniform shift: no divergence), then one funnel shift
__device__ __forceinline__ uint4 realign_at(const uint8_t* p, int shift) {
  uint32_t w0, w1, w2, w3, w4;
  switch (shift >> 2) {
    case 0: {
      const uint4 a = *reinterpret_cast<const uint4*>(p);
      w0 = a.x, w1 = a.y, w2 = a.z, w3 = a.w;
      w4 = *reinterpret_cast<const uint32_t*>(p + 16);
      break;
    }
    case 1: {
      const uint2 a = *reinterpret_cast<const uint2*>(p + 8);
      const uint2 b = *reinterpret_cast<const uint2*>(p + 16);
      w0 = *reinterpret_cast<const uint32_t*>(p + 4);
      w1 = a.x, w2 = a.y, w3 = b.x, w4 = b.y;
      break;
    }
    case 2: {
      const uint2 a = *reinterpret_cast<const uint2*>(p + 8);
      const uint4 b = *reinterpret_cast<const uint4*>(p + 16);
      w0 = a.x, w1 = a.y, w2 = b.x, w3 = b.y, w4 = b.z;
      break;
    }
    default: {
      const uint4 b = *reinterpret_cast<const uint4*>(p + 16);
      w0 = *reinterpret_cast<const uint32_t*>(p + 12);
      w1 = b.x, w2 = b.y, w3 = b.z, w4 = b.w;
    }
  }
  const uint32_t sh = (shift & 2) * 8;
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

// the first `keep` of 8 elements, the rest zeroed (past K, N or M)
__device__ __forceinline__ uint4 head(uint4 v, int keep) {
  if (keep >= 8) return v;
  auto word = [keep](uint32_t u, int i) {
    return 2 * i + 2 <= keep ? u : 2 * i + 1 == keep ? u & 0xffffu : 0u;
  };
  return make_uint4(word(v.x, 0), word(v.y, 1), word(v.z, 2), word(v.w, 3));
}

// 16 bytes from the aligned global chunk `a` into shared memory at dst,
// if ok (a chunk that holds no element of the row is never read, so no
// read leaves the operand's pages, whatever the view's offset and stride)
__device__ __forceinline__ void cp16(uint32_t dst, uintptr_t a, bool ok) {
  if (ok)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                 "l"(a)
                 : "memory");
}

// The producer warpgroup (warps pw = 0..3) over a tile's K loop.  Raw
// stage kt % RAW gets, by 16-byte cp.async, the aligned chunks that cover
// each row segment of the stage -- A rows of x (64 K elements: 9 chunks
// at most), B rows of w (256 N elements: 33 at most) -- and each producer
// thread arrives on the stage's mbarrier once its copies have landed
// (cp.async.mbarrier.arrive.noinc).  Warp pw copies A rows 32 pw .. 32 pw
// + 31, four at a time (lane c = lane % 8 of row 32 pw + 4 i + lane / 8:
// chunk c; chunk 8 of row 32 pw + j by lane j), and B rows 16 pw .. 16 pw
// + 15, one at a time (lane q: chunk q; chunk 32 by lane 0).  Output chunk
// c of a row is bytes [s + 16 c, s + 16 c + 16) of its raw chunks, s the
// row's offset in its first chunk, zeroed past K, N or M and stored at
// its 128-byte-swizzle address (chunk c of 128-byte row r at c ^ (r % 8)):
// the layout TMA gives the wgmma route.  s is the same at every stage (a
// stage advances x's rows by 128 bytes and w's by 64 rows, 128 ldw bytes)
// and for rows 8 apart (16 ldx bytes), so the realign is given rows of one
// shift at a time: warp pw realigns the A rows r = 2 pw, 2 pw + 1 (mod 8),
// four at a time (lane c of row r + 8 (4 j + lane / 8)), and B rows 16 pw
// .. 16 pw + 15, one at a time (lane q: output chunk q), each by a
// warp-uniform switch on the words that hold the chunk.  Shared memory is
// read and written through plain pointers (the mbarrier waits and the
// proxy fence order them), so the compiler may overlap one chunk's loads
// with another's shifts.
__device__ __forceinline__ void produce(
    const bf16* __restrict__ x, const bf16* __restrict__ w, int M, int N,
    int K, long long ldx, long long ldw, int m0, int n0, int nk,
    uint8_t* base, uint32_t a0, uint32_t b0, uint32_t raw0, uint32_t full0,
    uint32_t empty0, uint32_t rawbar0) {
  const uint32_t s0 = smem_u32(base);
  const int pw = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int c = lane & 7;
  const int nn = min(BN, N - n0);
  const uintptr_t xb = reinterpret_cast<uintptr_t>(x);
  const uintptr_t wb = reinterpret_cast<uintptr_t>(w) + 2 * (uintptr_t)n0;
  const uintptr_t xstep = 8 * (uintptr_t)ldx;   // 4 rows of x, bytes
  const uintptr_t wrow = 2 * (uintptr_t)ldw;
  // the A rows this lane copies: 32 pw + 4 i + lane / 8 (row i at xa + i
  // xstep) and, for chunk 8, 32 pw + lane (at xe)
  const int ra = 32 * pw + (lane >> 3);
  const uintptr_t xa = xb + 2 * (uintptr_t)((long long)(m0 + ra) * ldx);
  const int a_rows = M - m0 - ra;               // rows i with 4 i < a_rows
  const uintptr_t xe =
      xb + 2 * (uintptr_t)((long long)(m0 + 32 * pw + lane) * ldx);
  const bool e_live = m0 + 32 * pw + lane < M;
  // the warp's B rows 16 pw + i, at wb + (64 kt + 16 pw + i) wrow
  const uintptr_t wp = wb + (uintptr_t)(16 * pw) * wrow;
  // offsets in the first chunk, the same for every lane: of the A rows
  // 2 pw and 2 pw + 1 (mod 8) this warp realigns, and of its B rows (4
  // bits each)
  auto x_shift = [&](int r) {
    return (int)((xb + 2 * (uintptr_t)((long long)(m0 + r) * ldx)) & 15);
  };
  const int a_sh0 = x_shift(2 * pw), a_sh1 = x_shift(2 * pw + 1);
  uint64_t b_shift = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    b_shift |= (uint64_t)((wp + i * wrow) & 15) << (4 * i);

  auto issue = [&](int kt) {   // raw stage kt % RAW: this warp's rows
    const int k0 = kt * BK, r = kt % RAW;
    const int ka = 2 * min(BK, K - k0);         // bytes of an A row segment
    const uint32_t ra_s = raw0 + r * RAW_BYTES, rb_s = ra_s + RA_BYTES;
    const uintptr_t xs = 128 * (uintptr_t)kt;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uintptr_t ad = xa + i * xstep + xs;
      cp16(ra_s + (ra + 4 * i) * RA_PITCH + 16 * c,
           (ad & ~uintptr_t(15)) + 16 * c,
           4 * i < a_rows && 16 * c - (int)(ad & 15) < ka);
    }
    {
      const uintptr_t ad = xe + xs;
      cp16(ra_s + (32 * pw + lane) * RA_PITCH + 128,
           (ad & ~uintptr_t(15)) + 128, e_live && 128 - (int)(ad & 15) < ka);
    }
    const uintptr_t wk = wp + (uintptr_t)(64 * kt) * wrow;
    const int kb_rows = K - k0 - 16 * pw;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uintptr_t ad = wk + i * wrow;
      const uintptr_t al = ad & ~uintptr_t(15);
      const int sh = (int)(ad & 15);
      const uint32_t dst = rb_s + (16 * pw + i) * RB_PITCH;
      const bool live = i < kb_rows;
      cp16(dst + 16 * lane, al + 16 * lane, live && 16 * lane - sh < 2 * nn);
      if (lane == 0) cp16(dst + 512, al + 512, live && 512 - sh < 2 * nn);
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                     rawbar0 + 8 * r)
                 : "memory");
  };
#pragma unroll 1
  for (int kt = 0; kt < RAW && kt < nk; ++kt) issue(kt);

  int s = 0;
  uint32_t ph = 0;
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK, r = kt % RAW;
    const int ka = min(BK, K - k0);             // K elements of the stage
    const int kb_rows = K - k0 - 16 * pw;       // B rows i < kb_rows live
    const uint8_t* ra_p = base + (raw0 - s0) + r * RAW_BYTES;
    const uint8_t* rb_p = ra_p + RA_BYTES;
    uint8_t* a_p = base + (a0 - s0) + s * A_BYTES;
    uint8_t* b_p = base + (b0 - s0) + s * B_BYTES;
    mbar_wait(rawbar0 + 8 * r, (kt / RAW) & 1);
    mbar_wait(empty0 + 8 * s, ph ^ 1);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int rho = 2 * pw + (i & 1);
      const int row = rho + 8 * (4 * (i >> 1) + (lane >> 3));
      *reinterpret_cast<uint4*>(a_p + row * 128 + ((c ^ rho) << 4)) =
          head(realign_at(ra_p + row * RA_PITCH + 16 * c,
                          i & 1 ? a_sh1 : a_sh0),
               (m0 + row < M ? ka : 0) - 8 * c);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int row = 16 * pw + i;
      const int sh = (int)((b_shift >> (4 * i)) & 15);
      *reinterpret_cast<uint4*>(b_p + (lane >> 3) * B_CHUNK + row * 128 +
                                (((lane & 7) ^ (row & 7)) << 4)) =
          head(realign_at(rb_p + row * RB_PITCH + 16 * lane, sh),
               (i < kb_rows ? nn : 0) - 8 * lane);
    }
    fence_proxy_async();
    mbar_arrive(full0 + 8 * s);
    // every producer thread is done with raw stage r: refill it
    asm volatile("bar.sync 1, 128;" ::: "memory");
    if (kt + RAW < nk) issue(kt + RAW);
    if (++s == SW) {
      s = 0;
      ph ^= 1;
    }
  }
}

// the wgmma route's consumers over SW swizzled stages, fed by a producer
// warpgroup that realigns in place of the TMA thread: its 128 threads
// arrive on a stage's full barrier once their chunks are stored and
// fenced for the async proxy
__global__ void __launch_bounds__(NT, 1) matmul_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    bf16* __restrict__ out, int M, int N, int K, long long ldx,
    long long ldw) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // SW stages of A, of B (1024-aligned), the raw stages, the barriers
  const uint32_t a0 = smem_u32(base);
  const uint32_t b0 = a0 + SW * A_BYTES;
  const uint32_t raw0 = b0 + SW * B_BYTES;
  const uint32_t full0 = raw0 + RAW * RAW_BYTES;
  const uint32_t empty0 = full0 + 8 * SW;
  const uint32_t rawbar0 = empty0 + 8 * SW;
  int tile_m, tile_n;
  wg::tile_of(M, N, tile_m, tile_n);
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SW; ++s) {
      mbar_init(full0 + 8 * s, 128);  // every producer thread
      mbar_init(empty0 + 8 * s, 8);   // one arrival per consumer warp
    }
    for (int r = 0; r < RAW; ++r) mbar_init(rawbar0 + 8 * r, 128);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    produce(x, w, M, N, K, ldx, ldw, tile_m * BM, tile_n * BN, nk, base, a0,
            b0, raw0, full0, empty0, rawbar0);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    wg::consume<SW>(a0, b0, full0, empty0, out, M, N, tile_m, tile_n, nk,
                    wgi);
  }
}
}  // namespace ra


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

// Route codes (kernel.py's ROUTES order): 0 = wgmma, 1 = splitk, 2 =
// realign, 3 = f32.  x: (M, K) with row stride ldx, w: (K, N) with row stride ldw,
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
  if (route == 2) {   // realign
    const long long tiles = (long long)((M + wg::BM - 1) / wg::BM) *
                            ((N + wg::BN - 1) / wg::BN);
    if (tiles > 0x7fffffffLL || splits != 1 ||
        ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) &
         1))
      return (int)cudaErrorInvalidValue;
    static bool attr = false;
    if (!attr) {
      cudaError_t err = cudaFuncSetAttribute(
          ra::matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          ra::SMEM);
      if (err != cudaSuccess) return (int)err;
      attr = true;
    }
    ra::matmul_kernel<<<(unsigned)tiles, ra::NT, ra::SMEM, s>>>(
        xb, wb, ob, M, N, K, ldx, ldw);
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
