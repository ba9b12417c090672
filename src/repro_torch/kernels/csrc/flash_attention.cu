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
// bound it; past that the tensor cores: 989 TFLOP/s in bf16, which only
// wgmma reaches, and for fp32-accurate products 3xTF32 at 495 / 3 = 165.
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
//   * mma (fp32; bf16 views TMA cannot describe; G > 64).  The same rows
//     -- (position, head) pairs, here numbered across tiles so that any G
//     fits -- in CTAs of 8 warps x 16 rows (2 warps for fp32 at D = 256),
//     so a K/V tile is read once for all G heads.  K and V tiles of BK =
//     64 keys at absolute positions go through a ring of 4 slots (2 for
//     fp32 at D >= 128), one K or V tile a slot, by cp.async: 16 bytes where
//     a row's address allows it, else 4 (any fp32 row, a bf16 row at an
//     even element), else (a bf16 row at an odd element) the five aligned
//     words that cover each 16 bytes, shifted in registers.  Rows are
//     padded so that fragment loads are free of bank conflicts.  Both
//     products are mma.sync on the tensor cores.  fp32 runs as 3xTF32
//     (m16n8k8): each operand x is split into hi = tf32(x) and lo = tf32(x
//     - hi) (cvt.rna's rounding) and hi hi + hi lo + lo hi accumulate in
//     fp32, which keeps fp32's 1e-4 where one tf32 product misses it ~10x;
//     Q is split once when it lands, K, V and P as they are read; P V
//     permutes the keys of each block of 8 so that P's accumulator layout
//     is the A operand as it stands.  bf16 runs m16n8k16 with ldmatrix (.trans for
//     V) and P rounded to bf16 as above.  The softmax is the wgmma route's
//     code; O stays in registers (D / 2 floats a thread).  Measured on the
//     H100 (tools/kernel_variants.py, PERF.md), the products are ~8 % of
//     the fp32 time: the splits (every warp splits every K and V element),
//     the fragment loads and one CTA an SM (198 KB) set it; a bf16 view's
//     odd rows wait on their register-staged copy.
//
// The prefix contract: a prefix-cached admission (q_offset > 0) gives the
// same bits as an unshared one, port against port (the contract of
// src/repro/models/layers.py:338).  Both routes keep it the same way:
//   * KV tiles sit at fixed absolute positions 0, BK, 2 BK, ...;
//   * keys are never split across CTAs; and
//   * a row's result depends on nothing but that row: its MMA row, its
//     own max and sum reductions in a fixed order, its own rescaling,
//     and each of its unmasked scores rounded the same
//     way whether or not the tile crosses an edge of the query tile (whose
//     rows, and so edges, move with q_offset).
// Tiles past the causal frontier of the query tile's last row, or past
// kv_valid, are skipped: for every row they would add exp(-1e30 - m) == 0
// after its own diagonal, with alpha == 1.  Both routes also skip the
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
using bf16 = __nv_bfloat16;

// ------------------------------------------- the online softmax, both routes
// Both routes hold S and O in the accumulator layout of a 16-row MMA tile
// (mma.sync m16n8 blocks, and each warp's quarter of a wgmma m64 tile):
// element 4 j + 2 h + e of a thread is row lane / 4 + 8 h, column 8 j +
// 2 (lane % 4) + e.  So the softmax is one code for both.
namespace softmax {
constexpr int BK = 64;      // keys per tile: both routes' BK

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

// O *= alpha row by row, skipped where every row of the warp keeps its
// max (alpha == 1: the product would change no bit)
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}
}  // namespace softmax

// -------------------------------------------------------------------- mma
namespace mma {
using namespace softmax;
constexpr int BK = 64;      // keys per tile (kernel.py's KEY_TILE["mma"])
static_assert(BK == softmax::BK, "one key tile for the shared softmax");

// The shared-memory plan of one launch shape.  Rows are padded so that
// every fragment load is free of bank conflicts: fp32 rows of D + 4
// floats put the 8 x 4 threads of a fragment on 32 distinct banks (row
// stride 4 banks), bf16 rows of D + 8 halves give ldmatrix 8 rows on
// distinct 16-byte bank groups.  Q is split once into tf32 hi and
// lo halves (fp32); K and V tiles of BK keys go through a ring of SLOTS
// slots, one K or V tile each.  Eight warps (128 rows) a CTA: with one
// warp a sub-core every latency is exposed (four warps took 1.4-1.5x the
// time on the H100: tools/kernel_variants.py, PERF.md), and eight share
// each K/V tile.  fp32 at D = 128 holds two slots (198
// KB); at D = 256 two warps (32 rows) and two slots (195 KB).
template <typename T, int D>
struct Tile {
  using Elem = T;
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int LD = F32 ? D + 4 : D + 8;   // row pitch, elements
  static constexpr int WARPS = F32 && D == 256 ? 2 : 8;
  static constexpr int ROWS = 16 * WARPS;
  static constexpr int NT = 32 * WARPS;
  static constexpr int Q_ELEMS = (F32 ? 2 : 1) * ROWS * LD;   // fp32: hi, lo
  static constexpr int SLOT = BK * LD;
  static constexpr int SLOTS = F32 && D >= 128 ? 2 : 4;
  static constexpr int SMEM = (int)sizeof(T) * (Q_ELEMS + SLOTS * SLOT);
  static constexpr int CPR = D * (int)sizeof(T) / 16;   // 16-byte chunks a row
  static_assert(LD * sizeof(T) % 16 == 0, "16-byte aligned rows");
  static_assert(SMEM <= 232448, "fits the SM's shared memory");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint32_t a,
                                            uint32_t b, uint32_t c,
                                            uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(dst), "r"(a),
               "r"(b), "r"(c), "r"(d)
               : "memory");
}

// One 16-byte chunk of a row (8 bf16 or 4 fp32 elements at src) into the
// 16-byte aligned dst, by the widest copy src's alignment allows: one
// 16-byte cp.async, four 4-byte ones, or -- a bf16 row at an odd element
// offset -- the five aligned words that cover it, read into registers and
// shifted by one element.  Each word read holds an element of the chunk,
// so no read leaves the operand's pages.
__device__ __forceinline__ void copy16(uint32_t dst, const char* src) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  if ((a & 15) == 0) {
    cp_async16(dst, src);
  } else if ((a & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) cp_async4(dst + 4 * i, src + 4 * i);
  } else {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a - 2);
    uint32_t v[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) v[i] = __ldg(w + i);
    st_shared16(dst, __funnelshift_r(v[0], v[1], 16),
                __funnelshift_r(v[1], v[2], 16),
                __funnelshift_r(v[2], v[3], 16),
                __funnelshift_r(v[3], v[4], 16));
  }
}

// rows [0, ROWS_) of a tile, row r at src(r) (null: zeros), into smem at
// dst with the tile's pitch
template <typename TL, int ROWS_, typename Src>
__device__ __forceinline__ void load_rows(uint32_t dst, Src src, int tid) {
  for (int i = tid; i < ROWS_ * TL::CPR; i += TL::NT) {
    const int r = i / TL::CPR, c = i - r * TL::CPR;
    const uint32_t d = dst + (r * TL::LD) * (int)sizeof(typename TL::Elem) +
                       16 * c;
    const char* s = src(r);
    if (s)
      copy16(d, s + 16 * c);
    else
      st_shared16(d, 0u, 0u, 0u, 0u);
  }
}

// cvt.rna.tf32.f32 -- fp32 rounded to a 10-bit mantissa, to the nearest,
// ties away from zero -- as two integer ops on the bits (add half of the
// 13 dropped bits' weight to the magnitude, clear them): the same bits for
// every finite x, on full-rate pipes; the conversion instruction (~1100 a
// warp and key tile) made the fp32 route 13-16 % slower on the H100
// (tools/kernel_variants.py, PERF.md)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each a tf32 value: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += a b, tf32 operands.  3xTF32 runs three of these a product, small
// terms first (lo hi, hi lo, then hi hi); only lo lo (2^-22 relative) is
// dropped
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// S = Q K^T of one key tile for a warp's 16 rows.  fp32: 3xTF32 m16n8k8;
// A = Q's hi and lo (split when Q was loaded) at (g, t) and (g, t + 4),
// B = K's row g (a key) at d = t and t + 4, split here.  Each of the three
// passes runs over all 8 key blocks before the next: 8 independent
// accumulators between two dependent products.
template <int D>
__device__ __forceinline__ void tile_s(float (&sc)[BK / 2], const float* qh,
                                       const float* ql, const float* ks,
                                       int lane) {
  using TL = Tile<float, D>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < D / 8; ++kk) {
    const int c = 8 * kk + t;
    uint32_t ah[4], al[4];
    ah[0] = __float_as_uint(qh[g * TL::LD + c]);
    ah[1] = __float_as_uint(qh[(g + 8) * TL::LD + c]);
    ah[2] = __float_as_uint(qh[g * TL::LD + c + 4]);
    ah[3] = __float_as_uint(qh[(g + 8) * TL::LD + c + 4]);
    al[0] = __float_as_uint(ql[g * TL::LD + c]);
    al[1] = __float_as_uint(ql[(g + 8) * TL::LD + c]);
    al[2] = __float_as_uint(ql[g * TL::LD + c + 4]);
    al[3] = __float_as_uint(ql[(g + 8) * TL::LD + c + 4]);
    uint32_t bh[BK / 8][2], bl[BK / 8][2];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float* kr = ks + (8 * j + g) * TL::LD + c;
      split(kr[0], bh[j][0], bl[j][0]);
      split(kr[4], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mma_tf32(sc + 4 * j, al, bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mma_tf32(sc + 4 * j, ah, bl[j][0], bl[j][1]);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mma_tf32(sc + 4 * j, ah, bh[j][0], bh[j][1]);
  }
}

// bf16: m16n8k16, A = Q by ldmatrix, B = K (key-major rows) by ldmatrix,
// two key blocks of 8 a load
template <int D>
__device__ __forceinline__ void tile_s(float (&sc)[BK / 2], uint32_t qs,
                                       uint32_t ks, int lane) {
  using TL = Tile<bf16, D>;
  constexpr int RB = 2 * TL::LD;     // row bytes
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  const uint32_t qa = qs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * RB +
                      16 * (lane >> 4);
  const uint32_t ka = ks + ((lane & 7) + 8 * (lane >> 4)) * RB +
                      16 * ((lane >> 3) & 1);
#pragma unroll 2
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, qa + 32 * kk);
#pragma unroll
    for (int jj = 0; jj < BK / 16; ++jj) {
      uint32_t b[4];
      ldsm_x4(b, ka + 16 * jj * RB + 32 * kk);
      mma_bf16(sc + 8 * jj, a, b[0], b[1]);
      mma_bf16(sc + 8 * jj + 4, a, b[2], b[3]);
    }
  }
}

// O += P V of one key tile.  fp32: 3xTF32 with the key order permuted
// inside each block of 8 so that P's accumulator layout is the A operand
// as it stands: k index t is key 8 j + 2 t and k index t + 4 is key 8 j +
// 2 t + 1, so a = (P(g, 2t), P(g+8, 2t), P(g, 2t+1), P(g+8, 2t+1)) = the
// accumulator's (0, 2, 1, 3), and B reads V's rows 2 t and 2 t + 1 at
// column g (bank 8 t + g: conflict-free).  P is split here, V as read,
// eight d blocks at a time, each pass over the eight before the next.
template <int D>
__device__ __forceinline__ void tile_pv(float (&o)[D / 2],
                                        const float (&sc)[BK / 2],
                                        const float* vs, int lane) {
  using TL = Tile<float, D>;
  constexpr int NG = D / 8 < 8 ? D / 8 : 8;     // d blocks a group
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    uint32_t ph[4], pl[4];
    split(sc[4 * j], ph[0], pl[0]);
    split(sc[4 * j + 2], ph[1], pl[1]);
    split(sc[4 * j + 1], ph[2], pl[2]);
    split(sc[4 * j + 3], ph[3], pl[3]);
    const float* v0 = vs + (8 * j + 2 * t) * TL::LD + g;
#pragma unroll   // o's index: registers only under a full unroll
    for (int n0 = 0; n0 < D / 8; n0 += NG) {
      uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        split(v0[8 * (n0 + n)], bh[n][0], bl[n][0]);
        split(v0[TL::LD + 8 * (n0 + n)], bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int n = 0; n < NG; ++n)
        mma_tf32(o + 4 * (n0 + n), pl, bh[n][0], bh[n][1]);
#pragma unroll
      for (int n = 0; n < NG; ++n)
        mma_tf32(o + 4 * (n0 + n), ph, bl[n][0], bl[n][1]);
#pragma unroll
      for (int n = 0; n < NG; ++n)
        mma_tf32(o + 4 * (n0 + n), ph, bh[n][0], bh[n][1]);
    }
  }
}

// bf16: P rounded to bf16 in registers (the accumulator layout of two key
// blocks is m16n8k16's A operand), V by ldmatrix.trans (V is key-major:
// the MN-major B operand), two d blocks of 8 a load
template <int D>
__device__ __forceinline__ void tile_pv(float (&o)[D / 2],
                                        const float (&sc)[BK / 2],
                                        uint32_t vs, int lane) {
  using TL = Tile<bf16, D>;
  constexpr int RB = 2 * TL::LD;
  uint32_t pa[BK / 16][4];
  pack_p(pa, sc);
  const uint32_t va = vs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * RB +
                      16 * (lane >> 4);
#pragma unroll
  for (int kb = 0; kb < BK / 16; ++kb) {
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn) {
      uint32_t b[4];
      ldsm_x4_t(b, va + 16 * kb * RB + 32 * nn);
      mma_bf16(o + 8 * nn, pa[kb], b[0], b[1]);
      mma_bf16(o + 8 * nn + 4, pa[kb], b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// grid: (query tiles, B * Hkv), the longest tiles (last under the causal
// mask) first; WARPS warps of 16 rows each.  Row r of tile qt is the pair
// f = qt * ROWS + r of the (position, head of the group) pairs, position
// f / G, head hk * G + f % G: a K/V tile is read once for all G heads, and
// any G fits (the pairs of one position may span two tiles).
template <typename T, int D>
__global__ void __launch_bounds__(Tile<T, D>::NT, 1) flash_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out,  // out: (B, Sq, Hq, D)
    int Sq, int Sk, int Hq, int Hkv, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, int window,
    int q_offset, int kv_valid, float scale_log2) {
  using TL = Tile<T, D>;
  constexpr int SZ = (int)sizeof(T);
  extern __shared__ __align__(16) uint8_t fa_smem[];
  const uint32_t q_s = hopper::smem_u32(fa_smem);
  const uint32_t kv_s = q_s + SZ * TL::Q_ELEMS;

  const int G = Hq / Hkv;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y - b * Hkv;
  const long long pairs = (long long)Sq * G;
  const long long f0 = (long long)qt * TL::ROWS;
  const int n_here = (int)min((long long)TL::ROWS, pairs - f0);
  const int qp_first = q_offset + (int)(f0 / G);
  const int qp_last = q_offset + (int)((f0 + n_here - 1) / G);
  // the key tiles this query tile reads: [t_lo, t_hi) (the wgmma route's
  // rule: the header's prefix contract)
  int k_end = min(Sk, kv_valid);
  if (causal) k_end = min(k_end, qp_last + 1);
  const int t_hi = max((k_end + BK - 1) / BK, 1);
  int t_lo = 0;
  if (window > 0 && max(0, qp_last - window + 1) < kv_valid)
    t_lo = min(max(0, qp_first - window + 1) / BK, t_hi - 1);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* qb = q + b * q_sb + (long long)hk * G * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  // Q: fp32 lands raw in the lo half and is split below; its own group
  const uint32_t q_dst = TL::F32 ? q_s + SZ * TL::ROWS * TL::LD : q_s;
  load_rows<TL, TL::ROWS>(q_dst, [&](int r) -> const char* {
    const long long f = f0 + r;
    if (r >= n_here) return nullptr;
    const long long pos = f / G, gi = f - pos * G;
    return reinterpret_cast<const char*>(qb + pos * q_ss + gi * q_sh);
  }, tid);
  cp_commit();
  // the ring: item i is tile t_lo + i / 2, K for even i, V for odd, in slot
  // i % SLOTS; one commit group an item (empty past the last)
  const int items = 2 * (t_hi - t_lo);
  auto load_item = [&](int i) {
    if (i < items) {
      const int k0 = (t_lo + i / 2) * BK;
      const T* base = i & 1 ? vb : kb;
      const long long ss = i & 1 ? v_ss : k_ss;
      load_rows<TL, BK>(kv_s + SZ * (i % TL::SLOTS) * TL::SLOT,
                        [&](int r) -> const char* {
        return k0 + r < Sk ? reinterpret_cast<const char*>(
                                 base + (long long)(k0 + r) * ss)
                           : nullptr;
      }, tid);
    }
    cp_commit();
  };
#pragma unroll 1
  for (int i = 0; i < TL::SLOTS - 1; ++i) load_item(i);
  if constexpr (TL::F32) {
    cp_wait<TL::SLOTS - 1>();   // Q has landed
    __syncthreads();
    float* qh = reinterpret_cast<float*>(fa_smem);
    float* ql = qh + TL::ROWS * TL::LD;
    for (int i = tid; i < TL::ROWS * D; i += TL::NT) {
      const int r = i / D, c = i - r * D;
      uint32_t hi, lo;
      split(ql[r * TL::LD + c], hi, lo);
      qh[r * TL::LD + c] = __uint_as_float(hi);
      ql[r * TL::LD + c] = __uint_as_float(lo);
    }
  }

  // this thread's two rows (accumulator layout)
  int qpos[2];
  bool live[2];
  size_t orow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + (lane >> 2) + 8 * h;
    const long long f = f0 + r;
    const long long pos = f / G, gi = f - pos * G;
    live[h] = r < n_here;
    qpos[h] = q_offset + (int)pos;
    orow[h] = live[h] ? (((size_t)b * Sq + pos) * Hq + (size_t)hk * G + gi) * D
                      : 0;
  }
  const Mask mk{qpos[0], qpos[1], qp_first, qp_last, causal, window,
                kv_valid};
  float o[D / 2], sc[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];

#pragma unroll 1
  for (int i = 0; i < items; ++i) {
    cp_wait<TL::SLOTS - 2>();   // item i has landed (this thread's copies)
    __syncthreads();            // ... everyone's; slot i - 1 is free
    load_item(i + TL::SLOTS - 1);
    const uint32_t slot = kv_s + SZ * (i % TL::SLOTS) * TL::SLOT;
    if (!(i & 1)) {
      if constexpr (TL::F32) {
        const float* qh = reinterpret_cast<const float*>(fa_smem) +
                          16 * warp * TL::LD;
        tile_s<D>(sc, qh, qh + TL::ROWS * TL::LD,
                  reinterpret_cast<const float*>(fa_smem + (slot - q_s)),
                  lane);
      } else {
        tile_s<D>(sc, q_s + SZ * 16 * warp * TL::LD, slot, lane);
      }
      online_softmax(sc, m, l, alpha, (t_lo + i / 2) * BK, mk, lane,
                     scale_log2);
      rescale(o, alpha);
    } else {
      if constexpr (TL::F32)
        tile_pv<D>(o, sc,
                   reinterpret_cast<const float*>(fa_smem + (slot - q_s)),
                   lane);
      else
        tile_pv<D>(o, sc, slot, lane);
    }
  }

  // epilogue: O / l, rounded once to T
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    T* dst = out + orow[h] + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(dst + 8 * j, o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, const long long* st, int causal,
           int window, int q_offset, int kv_valid, cudaStream_t stream) {
  using TL = Tile<T, D>;
  const long long tiles =
      ((long long)Sq * (Hq / Hkv) + TL::ROWS - 1) / TL::ROWS;
  if (tiles > 0x7fffffffLL || (long long)B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TL::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  dim3 grid((unsigned)tiles, B * Hkv);
  flash_mma_kernel<T, D><<<grid, TL::NT, TL::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, Hq, Hkv, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, window,
      q_offset, kv_valid, scale_log2);
  return (int)cudaGetLastError();
}
}  // namespace mma

// ----------------------------------------------------------------- wgmma
namespace wg {
using namespace hopper;
using namespace softmax;
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

// route: 0 = wgmma (bf16, TMA-describable), 1 = mma.  strides: (q_sb,
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
  // fp32 views are 4-byte aligned by construction, bf16 ones 2-byte
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & (dtype == 0 ? 3 : 1)) != 0)
    return (int)cudaErrorInvalidValue;
#define MMA(T, DD)                                                         \
  mma::launch<T, DD>(q, k, v, out, B, Sq, Sk, Hq, Hkv, st, causal, window, \
                     q_offset, kv_valid, s)
  if (dtype == 0) {
    switch (D) {
      case 32: return MMA(float, 32);
      case 64: return MMA(float, 64);
      case 128: return MMA(float, 128);
      case 256: return MMA(float, 256);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return MMA(bf16, 32);
      case 64: return MMA(bf16, 64);
      case 128: return MMA(bf16, 128);
      case 256: return MMA(bf16, 256);
    }
  }
#undef MMA
  return (int)cudaErrorInvalidValue;
}
