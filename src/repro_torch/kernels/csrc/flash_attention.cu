// Flash prefill attention (K2) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:73
// (`flash_attention`, Pallas call at :91; wrapper ops.py:15): blocked
// online-softmax attention with a causal mask, a sliding window, a query
// offset (prefix-cached and chunked prefill) and a kv_valid padding mask.
// It takes (B, S, H, D) tensors with any batch/sequence/head strides and a
// contiguous last dim, and reads KV head h / (Hq / Hkv) in place for GQA,
// where the TPU wrapper repeated K and V and folded the heads.
//
// What bounds it on this card: at prefill shapes it does 4 * Sq * Sk * D
// flops per head (half of that under the causal mask) on 2 * Sk * D input
// bytes per KV head, so past a few hundred tokens the tensor-core rate
// (989 TFLOP/s bf16) is the bound.  This first version does its dots on
// the CUDA cores in fp32 and stays far from that bound; the tiles are
// sized so a wgmma/TMA version can replace the inner loops later.
//
// Design: one CTA (128 threads) per (16-row query tile, batch * query
// head).  Each CTA streams 32-row K/V tiles through shared memory as fp32
// and keeps m/l in shared memory and acc in registers.  Two rules make a
// prefix-cached admission (q_offset > 0) give the same bits as an unshared
// one, port against port (the contract of src/repro/models/layers.py:338):
//   * KV tiles sit at fixed absolute positions 0, 32, 64, ...; and
//   * a row's result depends on nothing but that row: its scores are
//     sequential dots, its softmax statistics warp reductions over its own
//     scores, its output sums over t in a fixed order.  No split-K.
// Tiles past the causal frontier of the whole query tile, or past
// kv_valid, are skipped: for every row they would add exp(-1e30 - m) == 0
// after its own diagonal, so the bits do not change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int NT = 128;   // threads per CTA
constexpr int BQ = 16;    // query rows per CTA
constexpr int BK = 32;    // keys per tile (one warp lane each)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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
  __shared__ float qs[BQ][D];
  __shared__ float ks[BK][D + 1];   // padded rows: conflict-free score dots
  __shared__ float vs[BK][D];
  __shared__ float ss[BQ][BK];
  __shared__ float m_s[BQ], l_s[BQ], a_s[BQ];

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
      ss[r][lane] = p;
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
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  flash_fwd_kernel<T, D><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, Hq, Hkv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
      window, q_offset, kv_valid, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* out,
             int B, int Sq, int Sk, int Hq, int Hkv, const long long* st,
             int causal, int window, int q_offset, int kv_valid,
             cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, st, causal, window, q_offset, kv_valid, s);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, st, causal, window, q_offset, kv_valid, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, st, causal, window, q_offset, kv_valid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: (q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh) in
// elements; the last dim is contiguous.  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Sk, int Hq, int Hkv, int D, const long long* strides, int causal,
    int window, int q_offset, int kv_valid, int dtype, void* stream) {
  if (Sq < 1 || Sk < 1 || Hkv < 1 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, out, B, Sq, Sk, Hq, Hkv, strides,
                           causal, window, q_offset, kv_valid, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, out, B, Sq, Sk, Hq, Hkv,
                                   strides, causal, window, q_offset,
                                   kv_valid, s);
  return (int)cudaErrorInvalidValue;
}
