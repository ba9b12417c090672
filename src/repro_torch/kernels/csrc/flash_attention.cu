// Flash prefill attention (K2) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:73
// (`flash_attention`, Pallas call at :91; wrapper ops.py:15): blocked
// online-softmax attention with a causal mask, a sliding window, a query
// offset (prefix-cached and chunked prefill) and a kv_valid padding mask.
// It takes (B, S, H, D) tensors with any batch/sequence/head strides and a
// contiguous last dim, D in {32, 64, 128, 256}, and reads KV head
// h / (Hq / Hkv) in place for GQA, where the TPU wrapper repeated K and V
// and folded the heads.  The output is a contiguous (B, Sq, Hq, D) in q's
// dtype, rounded once.
//
// What bounds it on this card: 4 * Sq * Sk * D flops per query head (about
// half of that under the causal mask) on 2 * Sk * D input bytes per KV
// head.  Up to a few hundred tokens the bytes (and, below that, the launch)
// bound it; past that the tensor-core rate, 989 TFLOP/s in bf16, which
// only wgmma reaches.
//
// Two routes, chosen by the wrapper's `plan` (kernel.py) from the dtype, D,
// G and the alignment before launch -- never after a failure:
//   * wgmma (bf16 that TMA can describe: 16-byte aligned bases, strides of
//     16-byte multiples; G = Hq / Hkv <= 64).  One CTA takes one (batch, kv
//     head) and one query tile whose rows are (position, head of the group)
//     pairs: the G query heads of the kv head at npos = 64 NC / G
//     consecutive positions, so a K/V tile is read once for all G heads and
//     an 8-token prompt of 5-head groups fills 40 of the 64 MMA rows.  NC =
//     1 or 2 consumer warpgroups own 64 rows each; one producer warp issues
//     every copy: Q once (a 4-D TMA box (64 d, G heads, npos positions)),
//     then K and V tiles of BK = 64 keys through a ring of 6 stages (3 at
//     D = 256) with full/empty mbarriers, all with the 128-byte swizzle
//     (64-byte at D = 32).  S = Q K^T is wgmma m64n64k16 with both operands
//     K-major in shared memory; the masks and the online softmax (max and
//     sum over the four threads that hold a row, fp32, m from the finite
//     -1e30, 2^x of log2(e)-scaled scores, scale and subtract in one fma
//     for every score that counts, on every tile) run in registers; P is rounded to bf16 in registers, as the reference
//     rounds it to V's dtype, and is the register A operand of wgmma
//     m64n{D}k16 against the V tile (MN-major: transpose bit, the MN-major
//     strides); O accumulates in fp32 registers and is rounded once.  Each
//     warpgroup issues the next tile's S and this tile's P V together and
//     runs the next tile's softmax while P V is on the tensor cores.
//     Measured on the H100, the softmax's instructions, not the tensor
//     cores or the K/V bytes, set the time past a few hundred tokens
//     (PERF.md).
//   * simt (fp32 -- held to 1e-4, which TF32 would break -- and bf16 views
//     TMA cannot describe): the first version of this kernel.  One CTA of
//     128 threads per (16-row query tile, batch * query head) streams 32-key
//     K/V tiles through shared memory as fp32 and does both products with
//     fmaf on the CUDA cores; P is rounded to the input type before the PV
//     sum.  Dynamic shared memory (84 KB at D = 256).
//
// The prefix contract: a prefix-cached admission (q_offset > 0) gives the
// same bits as an unshared one, port against port (the contract of
// src/repro/models/layers.py:338).  Both routes keep it the same way:
//   * KV tiles sit at fixed absolute positions 0, BK, 2 BK, ...;
//   * keys are never split across CTAs; and
//   * a row's result depends on nothing but that row: its MMA row (or its
//     sequential dots), its own max and sum reductions in a fixed order,
//     its own rescaling, and each of its unmasked scores rounded the same
//     way whether or not the tile crosses an edge of the query tile (whose
//     rows, and so edges, move with q_offset).
// Tiles past the causal frontier of the query tile's last row, or past
// kv_valid, are skipped: for every row they would add exp(-1e30 - m) == 0
// after its own diagonal, with alpha == 1.  The wgmma route also skips the
// tiles wholly below the window of the tile's first row when no row of the
// tile is wholly masked: for a row they are all-masked leading tiles, whose
// sums the first live tile multiplies by alpha == 0.  So the bits do not
// change.  Two launches give the same bits (no atomics, no split).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ------------------------------------------------------------------ simt
namespace simt {
constexpr int NT = 128;   // threads per CTA
constexpr int BQ = 16;    // query rows per CTA
constexpr int BK = 32;    // keys per tile (one warp lane each)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// a probability as the PV product takes it: rounded to the input type
__device__ __forceinline__ float round_as(float p, const float*) { return p; }
__device__ __forceinline__ float round_as(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)BQ * D + BK * (D + 1) + BK * D + BQ * BK + 3 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out,  // out: (B, Sq, Hq, D)
    int Sq, int Sk, int Hq, int Hkv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int causal, int window, int q_offset, int kv_valid, float scale) {
  constexpr int ACC = BQ * D / NT;
  extern __shared__ float smem[];
  float(*qs)[D] = reinterpret_cast<float(*)[D]>(smem);
  float(*ks)[D + 1] = reinterpret_cast<float(*)[D + 1]>(smem + BQ * D);
  // padded rows above: conflict-free score dots
  float(*vs)[D] = reinterpret_cast<float(*)[D]>(smem + BQ * D + BK * (D + 1));
  float(*ss)[BK] = reinterpret_cast<float(*)[BK]>(
      smem + BQ * D + BK * (D + 1) + BK * D);
  float* m_s = smem + BQ * D + BK * (D + 1) + BK * D + BQ * BK;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / Hq, h = blockIdx.y - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i - r * D, row = q0 + r;
    qs[r][c] = row < Sq ? to_f(qb[row * q_ss + c]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = 0.f;

  const int rows = min(BQ, Sq - q0);
  int k_end = min(Sk, kv_valid);
  if (causal) k_end = min(k_end, q_offset + q0 + rows);
  const int n_tiles = max((k_end + BK - 1) / BK, 1);
  __syncthreads();

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    for (int i = tid; i < BK * D; i += NT) {
      const int t = i / D, c = i - t * D, kr = k0 + t;
      const bool in = kr < Sk;
      ks[t][c] = in ? to_f(kb[kr * k_ss + c]) : 0.f;
      vs[t][c] = in ? to_f(vb[kr * v_ss + c]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += NT) {
      const int r = i / BK, t = i - r * BK;
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) s = fmaf(qs[r][c], ks[t][c], s);
      const int qp = q_offset + q0 + r, kp = k0 + t;
      bool ok = kp < kv_valid;
      if (causal) ok = ok && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      ss[r][t] = ok ? s * scale : NEG_INF;
    }
    __syncthreads();
    // online softmax: one warp per query row, one lane per key
    for (int r = warp; r < BQ; r += NT / 32) {
      const float s = ss[r][lane];
      float mx = s;
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(s - m_new);
      float sum = p;
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ss[r][lane] = round_as(p, q);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < ACC; ++jj) {
      const int e = tid + jj * NT, r = e / D, c = e - r * D;
      float pv = 0.f;
#pragma unroll 8
      for (int t = 0; t < BK; ++t) pv = fmaf(ss[r][t], vs[t][c], pv);
      acc[jj] = acc[jj] * a_s[r] + pv;
    }
    __syncthreads();
  }

#pragma unroll
  for (int jj = 0; jj < ACC; ++jj) {
    const int e = tid + jj * NT, r = e / D, c = e - r * D, row = q0 + r;
    if (row < Sq)
      store(out + (((size_t)b * Sq + row) * Hq + h) * D + c,
            acc[jj] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, const long long* st, int causal,
           int window, int q_offset, int kv_valid, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool attr = false;
  if (smem > 48 * 1024 && !attr) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  if ((long long)B * Hq > 65535) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, Hq, Hkv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
      window, q_offset, kv_valid, scale);
  return (int)cudaGetLastError();
}
}  // namespace simt

// ----------------------------------------------------------------- wgmma
namespace wg {
using namespace hopper;
using bf16 = __nv_bfloat16;
constexpr int BK = 64;      // keys per tile (kernel.py's KEY_TILE)
constexpr int ROWS = 64;    // rows of one consumer warpgroup (wgmma's M)
constexpr int MAX_G = 64;   // a query tile holds at least one position

template <int D, int NC>
struct Tile {
  static constexpr int CH = D < 64 ? D : 64;     // columns a swizzled row
  static constexpr int ROW_B = 2 * CH;          // 128 (64 at D = 32) bytes
  static constexpr int NCH = D / CH;            // column chunks
  static constexpr uint32_t LAYOUT = ROW_B == 128 ? 1 : 2;  // SW128 / SW64
  static constexpr int ATOM = 8 * ROW_B;        // 8 rows: the SBO
  static constexpr int Q_CHUNK = NC * ROWS * ROW_B;
  static constexpr int Q_BYTES = NCH * Q_CHUNK;
  static constexpr int KV_CHUNK = BK * ROW_B;
  static constexpr int KV_TILE = NCH * KV_CHUNK;   // BK x D bf16
  static constexpr int STAGES = D == 256 ? 3 : 6;
  static constexpr int NT = NC * 128 + 32;      // + one producer warp
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_TILE + 8 * (2 * STAGES + 1);
};

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x on the SFU, denormals flushed (what remains of a masked score,
// 2^(-1e30 - m), is exactly 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// accumulator operand lists, 16 registers at a time
#define ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC16(i) ACC4(i), ACC4(i + 4), ACC4(i + 8), ACC4(i + 12)

// D (64 x 64, fp32) (+)= A (64 x 16, K-major) * B (16 x 64, K-major), both
// from shared memory; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC16(0), ACC16(16)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x N, fp32) += A (64 x 16 bf16, registers) * B (16 x N, from shared
// memory, MN-major: transpose bit set), N = 32, 64, 128 or 256 (D's size
// picks the overload)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : ACC16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ACC16(0), ACC16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : ACC16(0), ACC16(16), ACC16(32), ACC16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : ACC16(0), ACC16(16), ACC16(32), ACC16(48),
        ACC16(64), ACC16(80), ACC16(96), ACC16(112)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC16
#undef ACC4

// S = Q K^T of one key tile into acc, issued (not committed): D / 16 k16
// steps, 32 bytes along a swizzled row, then the next column chunk
template <typename T>
__device__ __forceinline__ void issue_s(float (&acc)[BK / 2], uint32_t qa,
                                        uint32_t kb) {
  // descriptors address 16-byte units: a step adds its offset / 16
  const uint64_t da = smem_desc(qa, 16, T::ATOM, T::LAYOUT);
  const uint64_t db = smem_desc(kb, 16, T::ATOM, T::LAYOUT);
  fence_regs(acc);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < T::NCH * T::CH / 16; ++kk) {
    const int c = kk / (T::CH / 16), j = kk % (T::CH / 16);
    wgmma_ss(acc, da + ((c * T::Q_CHUNK + 32 * j) >> 4),
             db + ((c * T::KV_CHUNK + 32 * j) >> 4), kk > 0);
  }
}

// what masks a thread's two rows: their positions, the query tile's first
// and last, and the launch's causal / window / kv_valid
struct Mask {
  int qpos0, qpos1, qp_first, qp_last, causal, window, kv_valid;
};

// The online softmax of the key tile at k0 over a thread's two rows
// (accumulator layout): S (sc) becomes P in place, in fp32; m, l and the
// rescale factor alpha of each row move on.  Masks are applied only on
// tiles that cross a boundary, and they decide only which scores count:
// every unmasked score is rounded the same way on every tile (the max of
// the raw scores scaled once, exact since the scale is positive; p =
// 2^(s * scale - m) with the scale and the subtraction in one fma), so a
// row's bits do not depend on which tiles its query tile finds at an
// edge.  A masked score gives p = 2^(-1e30 - m).  Max and sum of a row:
// its 16 values here, then over the four threads that hold it, in a
// fixed order.
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int k0,
                                               const Mask& mk, int lane,
                                               float scale_log2) {
  const bool edge = k0 + BK > mk.kv_valid ||
                    (mk.causal && k0 + BK - 1 > mk.qp_first) ||
                    (mk.window > 0 && k0 <= mk.qp_last - mk.window);
  float mx[2] = {NEG_INF, NEG_INF};
  uint32_t ok_bits = 0xffffffffu;   // bit i: score i counts
  if (edge) {
    ok_bits = 0;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1;
      const int kp = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int qp = h ? mk.qpos1 : mk.qpos0;
      bool ok = kp < mk.kv_valid;
      if (mk.causal) ok = ok && kp <= qp;
      if (mk.window > 0) ok = ok && kp > qp - mk.window;
      if (ok) {
        ok_bits |= 1u << i;
        mx[h] = fmaxf(mx[h], sc[i]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  }
  // scaled once; a row half with no score that counts keeps -1e30
  mx[0] = ok_bits & 0x33333333u ? mx[0] * scale_log2 : NEG_INF;
  mx[1] = ok_bits & 0xccccccccu ? mx[1] * scale_log2 : NEG_INF;
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = ex2(m[h] - m_new);
    m[h] = m_new;
  }
  if (edge) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float mi = m[(i >> 1) & 1];
      sc[i] = ex2((ok_bits >> i) & 1 ? fmaf(sc[i], scale_log2, -mi)
                                     : NEG_INF - mi);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      sc[i] = ex2(fmaf(sc[i], scale_log2, -m[(i >> 1) & 1]));
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sum[(i >> 1) & 1] += sc[i];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    l[h] = l[h] * alpha[h] + sum[h];
  }
}

// P in bf16 as wgmma's register A operand: the k16 slice kb is
// accumulator columns 16 kb .. 16 kb + 15 in the same thread layout
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&sc)[BK / 2]) {
#pragma unroll
  for (int kb = 0; kb < BK / 16; ++kb)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kb][r] = pack_bf16(sc[8 * kb + 2 * r], sc[8 * kb + 2 * r + 1]);
}

// O += P V of one key tile, issued (not committed): V is (keys, D)
// row-major, so B is MN-major; 16 keys a step
template <typename T, int N>
__device__ __forceinline__ void issue_pv(float (&o)[N],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t vb) {
  const uint64_t db = smem_desc(vb, T::KV_CHUNK, T::ATOM, T::LAYOUT);
  fence_regs(o);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int kb = 0; kb < BK / 16; ++kb)
    wgmma_rs(o, pa[kb], db + ((kb * 16 * T::ROW_B) >> 4));
}

// O *= alpha row by row, skipped where every row of the warp keeps its
// max (alpha == 1: the product would change no bit)
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// grid: (query tiles, B * Hkv), the longest tiles (last under the causal
// mask) first; NC * 128 + 32 threads: warpgroups 0 .. NC-1 consume (rows
// 64 w .. 64 w + 63 of the tile), the last warp produces.  Row r of the
// tile is position pos0 + r / G, head hk * G + r % G.
template <int D, int NC>
__global__ void __launch_bounds__(NC * 128 + 32, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
    int Sq, int Sk, int Hq, int Hkv, int G, int npos, int causal, int window,
    int q_offset, int kv_valid, float scale_log2) {
  using T = Tile<D, NC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t q_s = smem_u32(base);
  const uint32_t k_s = q_s + T::Q_BYTES;
  const uint32_t v_s = k_s + T::STAGES * T::KV_TILE;
  const uint32_t full0 = v_s + T::STAGES * T::KV_TILE;
  const uint32_t empty0 = full0 + 8 * T::STAGES;
  const uint32_t q_bar = empty0 + 8 * T::STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y - b * Hkv;
  const int pos0 = qt * npos;
  const int n_here = min(npos, Sq - pos0);
  const int qp_first = q_offset + pos0, qp_last = qp_first + n_here - 1;
  // the key tiles this query tile reads: [t_lo, t_hi)
  int k_end = min(Sk, kv_valid);
  if (causal) k_end = min(k_end, qp_last + 1);
  const int t_hi = max((k_end + BK - 1) / BK, 1);
  int t_lo = 0;
  if (window > 0 && max(0, qp_last - window + 1) < kv_valid)
    t_lo = min(max(0, qp_first - window + 1) / BK, t_hi - 1);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * NC);   // one arrival per consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NC) {
    // ---- producer: one thread issues Q once, then keeps the ring full
    if (lane == 0) {
      mbar_expect_tx(q_bar, T::NCH * npos * G * T::ROW_B);
      for (int c = 0; c < T::NCH; ++c)
        tma_load_4d(q_s + c * T::Q_CHUNK, &tm_q, q_bar, c * T::CH, hk * G,
                    pos0, b);
      int s = 0;
      uint32_t ph = 0;
      for (int t = t_lo; t < t_hi; ++t) {
        mbar_wait(empty0 + 8 * s, ph ^ 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, 2 * T::KV_TILE);
        for (int c = 0; c < T::NCH; ++c) {
          tma_load_4d(k_s + s * T::KV_TILE + c * T::KV_CHUNK, &tm_k, bar,
                      c * T::CH, hk, t * BK, b);
          tma_load_4d(v_s + s * T::KV_TILE + c * T::KV_CHUNK, &tm_v, bar,
                      c * T::CH, hk, t * BK, b);
        }
        if (++s == T::STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers.  Accumulator element 4 j + 2 h + e of a thread is row
  // (16 warp + lane / 4 + 8 h) of its warpgroup, column 8 j + 2 (lane % 4)
  // + e.
  const int wgi = warp >> 2;
  int qpos[2];
  bool live[2];
  size_t orow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wgi * ROWS + (warp & 3) * 16 + (lane >> 2) + 8 * h;
    const int pos = r / G, gi = r - pos * G;
    live[h] = pos < n_here;
    qpos[h] = qp_first + pos;
    orow[h] = live[h] ? (((size_t)b * Sq + pos0 + pos) * Hq + hk * G + gi) * D
                      : 0;
  }
  float o[D / 2], sc[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t pa[BK / 16][4];
  const Mask mk{qpos[0], qpos[1], qp_first, qp_last, causal, window,
                kv_valid};
  const uint32_t qa = q_s + wgi * ROWS * T::ROW_B;
  mbar_wait(q_bar, 0);

  // Tile t_lo's S and softmax first.  Then each step but the last issues
  // the next tile's S and this tile's P V, and runs the next tile's
  // softmax while P V is on the tensor cores: wgmma groups complete in
  // order, so waiting for all but the newest group (P V) lands the next S.
  // No branch lies between an issue and its wait (ptxas would serialize
  // the groups otherwise); O is rescaled once P V has landed.
  int s = 0;
  uint32_t ph = 0;
  mbar_wait(full0, 0);
  issue_s<T>(sc, qa, k_s);
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_regs(sc);
  online_softmax(sc, m, l, alpha, t_lo * BK, mk, lane, scale_log2);
  pack_p(pa, sc);
  for (int t = t_lo; t < t_hi - 1; ++t) {
    int s1 = s + 1;
    uint32_t ph1 = ph;
    if (s1 == T::STAGES) {
      s1 = 0;
      ph1 ^= 1;
    }
    mbar_wait(full0 + 8 * s1, ph1);
    issue_s<T>(sc, qa, k_s + s1 * T::KV_TILE);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    issue_pv<T>(o, pa, v_s + s * T::KV_TILE);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_regs(sc);
    online_softmax(sc, m, l, alpha, (t + 1) * BK, mk, lane, scale_log2);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty0 + 8 * s);   // stage s is free again
    pack_p(pa, sc);
    rescale(o, alpha);   // for the next tile's P V
    s = s1;
    ph = ph1;
  }
  issue_pv<T>(o, pa, v_s + s * T::KV_TILE);
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_regs(o);

  // epilogue: O / l, rounded once to bf16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    bf16* dst = out + orow[h] + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
  }
}

// the tile shape a launch takes: two consumer warpgroups once the rows
// outgrow one (D <= 128: at D = 256 one warpgroup keeps O in registers)
inline int consumers(int D, int Sq, int G) {
  return D <= 128 && (long long)Sq * G > ROWS ? 2 : 1;
}

template <int D, int NC>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, const long long* st, int causal,
           int window, int q_offset, int kv_valid, cudaStream_t stream) {
  using T = Tile<D, NC>;
  const int G = Hq / Hkv;
  const int npos = NC * ROWS / G;
  const long long tiles = (Sq + npos - 1) / npos;
  if (G > MAX_G || npos < 1 || tiles > 0x7fffffffLL ||
      (long long)B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  const CUtensorMapSwizzle sw =
      T::ROW_B == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tm_q, tm_k, tm_v;
  const uint64_t qd[4] = {(uint64_t)D, (uint64_t)Hq, (uint64_t)Sq, (uint64_t)B};
  const uint64_t kd[4] = {(uint64_t)D, (uint64_t)Hkv, (uint64_t)Sk,
                          (uint64_t)B};
  const uint64_t qs[3] = {2ull * st[2], 2ull * st[1], 2ull * st[0]};
  const uint64_t ks[3] = {2ull * st[5], 2ull * st[4], 2ull * st[3]};
  const uint64_t vs[3] = {2ull * st[8], 2ull * st[7], 2ull * st[6]};
  const uint32_t qbox[4] = {(uint32_t)T::CH, (uint32_t)G, (uint32_t)npos, 1};
  const uint32_t kbox[4] = {(uint32_t)T::CH, 1, (uint32_t)BK, 1};
  int rc = encode_4d(&tm_q, q, qd, qs, qbox, sw);
  if (rc == 0) rc = encode_4d(&tm_k, k, kd, ks, kbox, sw);
  if (rc == 0) rc = encode_4d(&tm_v, v, kd, vs, kbox, sw);
  if (rc != 0) return rc;
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<D, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  dim3 grid((unsigned)tiles, B * Hkv);
  flash_wgmma_kernel<D, NC><<<grid, T::NT, T::SMEM, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(out), Sq, Sk, Hq, Hkv, G, npos,
      causal, window, q_offset, kv_valid, scale_log2);
  return (int)cudaGetLastError();
}

template <int D>
int launch_nc(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int Hq, int Hkv, const long long* st, int causal,
              int window, int q_offset, int kv_valid, cudaStream_t stream) {
  if constexpr (D <= 128) {
    if (consumers(D, Sq, Hq / Hkv) == 2)
      return launch<D, 2>(q, k, v, out, B, Sq, Sk, Hq, Hkv, st, causal,
                          window, q_offset, kv_valid, stream);
  }
  return launch<D, 1>(q, k, v, out, B, Sq, Sk, Hq, Hkv, st, causal, window,
                      q_offset, kv_valid, stream);
}
}  // namespace wg

}  // namespace

// route: 0 = wgmma (bf16, TMA-describable), 1 = simt.  strides: (q_sb,
// q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh) in elements; the last dim
// is contiguous.  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch (0 = launched) or an error code for
// arguments the route does not take.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, const long long* strides, int causal,
    int window, int q_offset, int kv_valid, int dtype, int route,
    void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq % Hkv || kv_valid < 0 ||
      kv_valid > Sk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* st = strides;
  if (route == 0) {
    bool aligned = dtype == 1 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
    for (int i = 0; i < 9; ++i) aligned = aligned && st[i] % 8 == 0;
    if (!aligned) return (int)cudaErrorInvalidValue;
    switch (D) {
      case 32: return wg::launch_nc<32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, st, causal, window, q_offset, kv_valid, s);
      case 64: return wg::launch_nc<64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, st, causal, window, q_offset, kv_valid, s);
      case 128: return wg::launch_nc<128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, st, causal, window, q_offset, kv_valid, s);
      case 256: return wg::launch_nc<256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, st, causal, window, q_offset, kv_valid, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (route != 1) return (int)cudaErrorInvalidValue;
#define SIMT(T, DD)                                                         \
  simt::launch<T, DD>(q, k, v, out, B, Sq, Sk, Hq, Hkv, st, causal, window, \
                      q_offset, kv_valid, s)
  if (dtype == 0) {
    switch (D) {
      case 32: return SIMT(float, 32);
      case 64: return SIMT(float, 64);
      case 128: return SIMT(float, 128);
      case 256: return SIMT(float, 256);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return SIMT(__nv_bfloat16, 32);
      case 64: return SIMT(__nv_bfloat16, 64);
      case 128: return SIMT(__nv_bfloat16, 128);
      case 256: return SIMT(__nv_bfloat16, 256);
    }
  }
#undef SIMT
  return (int)cudaErrorInvalidValue;
}
