// Paged decode attention (K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py:107
// (`paged_attention`, Pallas call at :168): one query token per slot, GQA,
// attending the slot's pages of a (P, page, Hkv, D) pool through a
// (B, n_pages) int32 page table, masked to pos < seq_lens[b], with an
// optional current-token column `extra_kv` folded in last.
//
// What bounds it on this card: bytes.  Each (slot, kv-head) reads its live
// K and V rows once (~2 * len * D * 2 bytes in bf16) and does 4 * G * D
// flops per row, about 2.5 flops a byte against the H100's ~295 at the
// bf16 ridge, so the least time is bytes / 3.35 TB/s -- well under a
// microsecond at serving shapes, below the cost of a launch.
//
// Design: one CTA (128 threads) per (kv-head, slot).  The CTA reads its
// own page-table row (the TPU kernel's scalar prefetch), stages each page's
// (page x D) K and V tiles in shared memory as fp32, and keeps the
// online-softmax state m/l in shared memory and acc in registers for its G
// query rows, so the G query heads of a group read each K/V tile once.  The
// loop ends after the last live page: trailing pages contribute exactly
// zero (exp(-1e30 - m) underflows), so skipping them keeps the bits.  m
// starts at the reference's finite NEG_INF = -1e30, never -inf: a
// seq_len == 0 slot then accumulates finite garbage that the extra column
// multiplies by exp(-1e30 - s0) == 0, and comes out as exactly v0.  Idle
// slots point at the null page 0; their reads are masked, not skipped.
// Page ids are clamped into the pool so a bad table cannot read out of
// bounds.  Simple and right first: no cp.async/TMA pipeline, fp32 CUDA-core
// dots; making it fast is later work.
//
// Scaled variant (the TPU kernel's `has_scales` branch): the pool element
// type KV is int8 or fp8_e4m3 while q, extra_kv and out stay in T (bf16 or
// fp32).  Each staged element is widened to fp32 and multiplied by its bf16
// (page, slot, kv-head) scale, so full-precision KV exists only in the
// shared-memory tile, and p meets fp32 V unrounded.  One-byte pools halve
// the bytes of the bound; the tiles are staged as fp32 as before, so the
// shared-memory budget does not change.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 128;           // threads per CTA
constexpr int MAX_ACC = 16;       // accumulators per thread: G * D <= NT * MAX_ACC
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// T: q / extra_kv / out; KV: pool elements (T itself, or int8 / fp8_e4m3
// with bf16 scales)
template <typename T, typename KV>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const T* __restrict__ q,          // (B, Hkv, G, D)
    const KV* __restrict__ k_pages,   // (P, page, Hkv, D)
    const KV* __restrict__ v_pages,   // (P, page, Hkv, D)
    const __nv_bfloat16* __restrict__ k_scales,  // (P, page, Hkv), scaled only
    const __nv_bfloat16* __restrict__ v_scales,
    const int* __restrict__ table,    // (B, n_pages)
    const int* __restrict__ seq_lens, // (B,)
    const T* __restrict__ k0,         // (B, Hkv, D) or null
    const T* __restrict__ v0,         // (B, Hkv, D) or null
    T* __restrict__ out,              // (B, Hkv, G, D)
    int Hkv, int G, int D, int P, int page, int n_pages, float scale) {
  constexpr bool kScaled = !std::is_same<KV, T>::value;
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = NT / 32;
  const int GD = G * D;
  float* qs = smem;                  // G * D
  float* ks = qs + GD;               // page * (D + 1), padded rows
  float* vs = ks + page * (D + 1);   // page * D
  float* ps = vs + page * D;         // G * page: scores, then probabilities
  float* m_s = ps + G * page;        // G running maxima
  float* l_s = m_s + G;              // G running sums
  float* a_s = l_s + G;              // G rescale factors of the current step

  const T* qb = q + ((size_t)b * Hkv + h) * GD;
  for (int i = tid; i < GD; i += NT) qs[i] = to_f(qb[i]);
  for (int g = tid; g < G; g += NT) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  float acc[MAX_ACC];
#pragma unroll
  for (int j = 0; j < MAX_ACC; ++j) acc[j] = 0.f;

  const int len = seq_lens[b];
  const bool has_extra = k0 != nullptr;
  // pages past the last live one contribute exactly zero once a live
  // position set m; with no live position and no extra column every page
  // is attended (the reference's all-masked softmax), so none is skipped
  const int n_live = len > 0 ? min(n_pages, (len + page - 1) / page)
                             : (has_extra ? 0 : n_pages);
  const size_t row_stride = (size_t)Hkv * D;
  __syncthreads();

  for (int pi = 0; pi < n_live; ++pi) {
    int pid = table[(size_t)b * n_pages + pi];
    pid = min(max(pid, 0), P - 1);
    const KV* kp = k_pages + ((size_t)pid * page * Hkv + h) * D;
    const KV* vp = v_pages + ((size_t)pid * page * Hkv + h) * D;
    for (int i = tid; i < page * D; i += NT) {
      const int t = i / D, c = i - t * D;
      float kx = to_f(kp[t * row_stride + c]);
      float vx = to_f(vp[t * row_stride + c]);
      if constexpr (kScaled) {  // fused dequant by the (pid, t, h) scale
        const size_t si = ((size_t)pid * page + t) * Hkv + h;
        kx *= __bfloat162float(k_scales[si]);
        vx *= __bfloat162float(v_scales[si]);
      }
      ks[t * (D + 1) + c] = kx;
      vs[i] = vx;
    }
    __syncthreads();
    for (int i = tid; i < G * page; i += NT) {
      const int g = i / page, t = i - g * page;
      const float* qr = qs + g * D;
      const float* kr = ks + t * (D + 1);
      float s = 0.f;
      for (int c = 0; c < D; ++c) s = fmaf(qr[c], kr[c], s);
      ps[i] = (pi * page + t < len) ? s * scale : NEG_INF;
    }
    __syncthreads();
    // online softmax: one warp per query row, one lane per page slot
    for (int g = warp; g < G; g += nwarps) {
      const float s = lane < page ? ps[g * page + lane] : -INFINITY;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = lane < page ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      if (lane < page) ps[g * page + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAX_ACC; ++j) {
      const int e = tid + j * NT;
      if (e < GD) {
        const int g = e / D, c = e - g * D;
        const float* pr = ps + g * page;
        float pv = 0.f;
        for (int t = 0; t < page; ++t) pv = fmaf(pr[t], vs[t * D + c], pv);
        acc[j] = acc[j] * a_s[g] + pv;
      }
    }
    __syncthreads();
  }

  if (has_extra) {
    // the current token's (k, v): one more online-softmax column
    const T* k0b = k0 + ((size_t)b * Hkv + h) * D;
    const T* v0b = v0 + ((size_t)b * Hkv + h) * D;
    for (int g = warp; g < G; g += nwarps) {
      float s = 0.f;
      for (int c = lane; c < D; c += 32) s = fmaf(qs[g * D + c], to_f(k0b[c]), s);
      s = warp_sum(s) * scale;
      if (lane == 0) {
        const float m_p = m_s[g];
        const float m_f = fmaxf(m_p, s);
        const float alpha = expf(m_p - m_f);
        const float p0 = expf(s - m_f);
        l_s[g] = l_s[g] * alpha + p0;
        a_s[g] = alpha;
        ps[g] = p0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAX_ACC; ++j) {
      const int e = tid + j * NT;
      if (e < GD) {
        const int g = e / D, c = e - g * D;
        acc[j] = acc[j] * a_s[g] + ps[g] * to_f(v0b[c]);
      }
    }
  }

  T* ob = out + ((size_t)b * Hkv + h) * GD;
#pragma unroll
  for (int j = 0; j < MAX_ACC; ++j) {
    const int e = tid + j * NT;
    if (e < GD) store(ob + e, acc[j] / fmaxf(l_s[e / D], 1e-30f));
  }
}

template <typename T, typename KV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales, const void* table,
           const void* seq_lens, const void* k0, const void* v0, void* out,
           int B, int Hkv, int G, int D, int P, int page, int n_pages,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)G * D + (size_t)page * (D + 1) + (size_t)page * D +
       (size_t)G * page + 3 * (size_t)G);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid(Hkv, B);
  paged_decode_kernel<T, KV><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_pages),
      static_cast<const KV*>(v_pages),
      static_cast<const __nv_bfloat16*>(k_scales),
      static_cast<const __nv_bfloat16*>(v_scales),
      static_cast<const int*>(table), static_cast<const int*>(seq_lens),
      static_cast<const T*>(k0), static_cast<const T*>(v0),
      static_cast<T*>(out), Hkv, G, D, P, page, n_pages, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pool(int kv_dtype, const void* q, const void* k_pages,
                const void* v_pages, const void* k_scales,
                const void* v_scales, const void* table, const void* seq_lens,
                const void* k0, const void* v0, void* out, int B, int Hkv,
                int G, int D, int P, int page, int n_pages,
                cudaStream_t stream) {
  const bool scaled = k_scales != nullptr && v_scales != nullptr;
  if (kv_dtype == 0 && !scaled)
    return launch<T, T>(q, k_pages, v_pages, nullptr, nullptr, table,
                        seq_lens, k0, v0, out, B, Hkv, G, D, P, page,
                        n_pages, stream);
  if (kv_dtype == 1 && scaled)
    return launch<T, int8_t>(q, k_pages, v_pages, k_scales, v_scales, table,
                             seq_lens, k0, v0, out, B, Hkv, G, D, P, page,
                             n_pages, stream);
  if (kv_dtype == 2 && scaled)
    return launch<T, __nv_fp8_e4m3>(q, k_pages, v_pages, k_scales, v_scales,
                                    table, seq_lens, k0, v0, out, B, Hkv, G,
                                    D, P, page, n_pages, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (q, extra_kv, out): 0 = float32, 1 = bfloat16.  kv_dtype (pools):
// 0 = q's dtype, unscaled; 1 = int8 and 2 = fp8_e4m3, each with bf16
// k_scales/v_scales (both non-null).  k0/v0 null = no extra column.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* table,
    const void* seq_lens, const void* k0, const void* v0, void* out, int B,
    int Hkv, int G, int D, int P, int page, int n_pages, int dtype,
    int kv_dtype, void* stream) {
  if (G * D > NT * MAX_ACC || page < 1 || page > 32 || D < 32 || D % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_pool<float>(kv_dtype, q, k_pages, v_pages, k_scales,
                              v_scales, table, seq_lens, k0, v0, out, B, Hkv,
                              G, D, P, page, n_pages, s);
  if (dtype == 1)
    return launch_pool<__nv_bfloat16>(kv_dtype, q, k_pages, v_pages, k_scales,
                                      v_scales, table, seq_lens, k0, v0, out,
                                      B, Hkv, G, D, P, page, n_pages, s);
  return (int)cudaErrorInvalidValue;
}
