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
// bf16 ridge, so the least time is bytes / 3.35 TB/s -- under a
// microsecond at serving shapes, below the cost of a launch.  What a
// launch actually pays is latency: how long the longest chain of
// dependent page loads takes.
//
// Design: flash-decoding over pages.  The TPU walks a slot's pages in
// order on one core; here the walk is split over CTAs.  The grid is
// (Hkv, B, S): split s covers the fixed page range [s * PPS, (s + 1) *
// PPS), PPS a constant of the kernel, S = ceil(n_pages / PPS) from the
// table's width alone.  So a slot's bits depend only on its own pages and
// length, never on the other slots, and the grid only on shapes.
//     PPS = 2 (32 positions at page 16) was the fastest of 1, 2, 4 and 8 at
//     both of chip_smoke.py's K1 shapes taken together.
//   * A split issues 16-byte cp.async copies of all its pages' K and V
//     rows at once, in their native type (2 or 1 bytes), one commit group
//     a page, and computes page i while the later pages are in flight.
//     Elements are widened to fp32 (and int8 / fp8 scaled) as they are
//     read from shared memory.
//   * Scores: 8 lanes take a position (a warp 4 positions), each lane 4
//     consecutive d at a time (vector shared-memory reads) for all MAXG
//     query rows at once, then a reduce-scatter over the 8 lanes per group
//     of 8 rows: 7 shuffles for 8 rows, where a shuffle reduce per row
//     would chain 5 per row.  Online softmax in fp32 with m starting at the
//     finite -1e30; PV with a thread per column d (two at d = 256) holding
//     all MAXG rows' accumulators, so one V element feeds G independent
//     FMAs.  Three barriers a page.  MAXG is 8 for G <= 8 and 16 for G <=
//     16 (two row groups, twice the registers); G <= 8 runs the 8-row
//     instantiation, whose code is the 8-row kernel's alone.
//   * Splits past the slot's last live page exit at once.  A slot with one
//     live split finishes in that CTA; otherwise each split writes
//     (m, l, acc) in fp32 to a scratch, and the last CTA of the (slot,
//     head) -- a counter behind __threadfence, reset by that CTA -- merges
//     them in split order, staging the partials into shared memory with
//     16-byte cp.async so their loads overlap.  Either way the extra column
//     is folded in last, in full precision.  One launch a layer.
//   * A seq_len == 0 slot with extra_kv has no live page: its merged state
//     is m = -1e30, l = 0, acc = 0, and the extra column's alpha =
//     exp(-1e30 - s0) == 0 makes it exactly v0.  With neither live
//     positions nor an extra column every page is attended, all masked (the
//     reference's all-masked softmax).  Page ids are clamped into the pool.
//
// Scaled variant (the TPU kernel's `has_scales` branch): the pool element
// type KV is int8 or fp8_e4m3 while q, extra_kv and out stay in T (bf16 or
// fp32).  A position's bf16 K scale multiplies its dot product and its V
// scale its probability in the PV sum, so full-precision KV exists only
// in registers.  One template on the pool element type serves all three.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 128;           // threads per CTA
constexpr int NWARPS = NT / 32;
constexpr int PPS = 2;            // pages per split (kernel.py mirrors it)
constexpr int MAX_GROUP = 16;     // G a launch takes (kernel.py's MAX_G)
constexpr int DPT = 2;            // columns a thread owns: D <= NT * DPT
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// four consecutive pool elements from shared memory, widened to fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}
__device__ __forceinline__ float4 load4(const __nv_fp8_e4m3* p) {
  return make_float4(to_f(p[0]), to_f(p[1]), to_f(p[2]), to_f(p[3]));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

// wait until at most `pending` (< PPS) commit groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
  }
}

// The last CTA of a split group: every thread calls this after writing its
// partial; it returns true in the one CTA that arrived last, which then
// reads the others' partials and resets the counter.
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

// the 8 lanes of an aligned group each hold 8 partial sums v[0..8); after
// three xor-shuffle steps lane j of the group holds the group's total of
// v[j] (a reduce-scatter: 7 shuffles for 8 sums, in a fixed order)
__device__ __forceinline__ float reduce_scatter8(const float* v, int lane) {
  const bool h4 = lane & 4, h2 = lane & 2, h1 = lane & 1;
  float a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = h4 ? v[i + 4] : v[i], send = h4 ? v[i] : v[i + 4];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = h2 ? a[i + 2] : a[i], send = h2 ? a[i] : a[i + 2];
    b[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
  }
  const float keep = h1 ? b[1] : b[0], send = h1 ? b[0] : b[1];
  return keep + __shfl_xor_sync(0xffffffffu, send, 1);
}


// bytes of the page tiles, reused to stage the splits' partials in a merge
__host__ __device__ inline size_t tile_bytes(int G, int D, int page,
                                             size_t kv_size) {
  const size_t tiles = 2 * (size_t)PPS * page * D * kv_size;
  const size_t one = sizeof(float) * (size_t)G * D;   // one split's acc
  return tiles > one ? tiles : one;
}

// dynamic shared memory of one CTA, in bytes
__host__ __device__ inline size_t smem_bytes(int maxg, int G, int D, int page,
                                             int S, size_t kv_size) {
  return tile_bytes(G, D, page, kv_size) +
         sizeof(float) * ((size_t)maxg * D + 2 * (size_t)D +
                          2 * (size_t)G * page + 4 * (size_t)G +
                          2 * (size_t)PPS * page + 3 * (size_t)S * G) +
         sizeof(int) * PPS;
}

// T: q / extra_kv / out; KV: pool elements (T itself, or int8 / fp8_e4m3
// with bf16 scales); MAXG: 8 or 16 query rows (G <= MAXG)
template <typename T, typename KV, int MAXG>
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
    float* __restrict__ partial,      // (B, Hkv, S, G * D) acc, then (B, Hkv, S, G, 2) m/l
    int* __restrict__ counters,       // (B * Hkv,), zero
    int Hkv, int G, int D, int P, int page, int n_pages, float scale) {
  constexpr bool kScaled = !std::is_same<KV, T>::value;
  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int B = gridDim.y, S = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int GD = G * D;
  const int len = seq_lens[b];
  const bool has_extra = k0 != nullptr;
  // pages past the last live one contribute exactly zero once a live
  // position set m; with no live position and no extra column every page
  // is attended (the reference's all-masked softmax)
  const int n_live = len > 0 ? min(n_pages, (len + page - 1) / page)
                             : (has_extra ? 0 : n_pages);
  const int n_sp = max(1, (n_live + PPS - 1) / PPS);
  if (sp >= n_sp) return;
  const int p0 = sp * PPS;
  const int p_cnt = max(0, min(PPS, n_live - p0));

  extern __shared__ __align__(16) unsigned char smem[];
  KV* kt = reinterpret_cast<KV*>(smem);              // PPS x page x D
  KV* vt = kt + (size_t)PPS * page * D;
  float* stage = reinterpret_cast<float*>(smem);     // merge: splits' acc
  float* qs = reinterpret_cast<float*>(smem + tile_bytes(G, D, page, sizeof(KV)));
  float* k0s = qs + MAXG * D;      // D: the extra column's k and v
  float* v0s = k0s + D;
  float* ps = v0s + D;             // 2 x G x page: scores, then probabilities
  float* a_s = ps + 2 * G * page;  // 2 x G rescale factors
  float* m_s = a_s + 2 * G;        // G running maxima
  float* l_s = m_s + G;            // G running sums
  float* ksc = l_s + G;            // PPS x page scales (scaled only)
  float* vsc = ksc + PPS * page;
  float* wts = vsc + PPS * page;   // S x G merge weights
  float* mls = wts + S * G;        // S x G x 2 merged splits' (m, l)
  int* pid_s = reinterpret_cast<int*>(mls + 2 * S * G);

  if (tid < p_cnt)
    pid_s[tid] = min(max(table[(size_t)b * n_pages + p0 + tid], 0), P - 1);
  __syncthreads();
  // every page of the split in flight at once, one commit group a page
  const int chunk = 16 / (int)sizeof(KV), row_chunks = D / chunk;
  const size_t row_stride = (size_t)Hkv * D;
  for (int pi = 0; pi < p_cnt; ++pi) {
    const size_t base = ((size_t)pid_s[pi] * page * Hkv + h) * D;
    for (int i = tid; i < page * row_chunks; i += NT) {
      const int t = i / row_chunks, c = (i - t * row_chunks) * chunk;
      const size_t src = base + t * row_stride + c;
      const size_t dst = ((size_t)pi * page + t) * D + c;
      cp_async16(kt + dst, k_pages + src);
      cp_async16(vt + dst, v_pages + src);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  // while they fly: q (rows past G zero), the extra column, the scales
  const T* qb = q + ((size_t)b * Hkv + h) * GD;
  for (int i = tid; i < MAXG * D; i += NT) qs[i] = i < GD ? to_f(qb[i]) : 0.f;
  if (has_extra) {
    const size_t o = ((size_t)b * Hkv + h) * D;
    for (int c = tid; c < D; c += NT) {
      k0s[c] = to_f(k0[o + c]);
      v0s[c] = to_f(v0[o + c]);
    }
  }
  if constexpr (kScaled) {
    for (int i = tid; i < p_cnt * page; i += NT) {
      const int pi = i / page, t = i - pi * page;
      const size_t si = ((size_t)pid_s[pi] * page + t) * Hkv + h;
      ksc[i] = __bfloat162float(k_scales[si]);
      vsc[i] = __bfloat162float(v_scales[si]);
    }
  }
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  // this thread's accumulators: columns tid + NT * dd, every query row
  float acc[DPT][MAXG];
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd)
#pragma unroll
    for (int g = 0; g < MAXG; ++g) acc[dd][g] = 0.f;

  const int sub = lane & 7, grp = lane >> 3;
  for (int pi = 0; pi < p_cnt; ++pi) {
    cp_async_wait(p_cnt - 1 - pi);
    __syncthreads();   // page pi (and, at pi = 0, q, scales, m, l) visible
    const int buf = pi & 1;
    float* pb = ps + buf * G * page;
    const KV* kp = kt + (size_t)pi * page * D;
    // scores: 8 lanes a position (4 positions a warp), each lane 4
    // consecutive d at a time; the MAXG query rows (rows past G zero)
    // reduced together, 8 at a time
    for (int t0 = warp * 4; t0 < page; t0 += NWARPS * 4) {
      const int t = t0 + grp;
      const bool tv = t < page;
      float ks = scale;
      if constexpr (kScaled) ks *= tv ? ksc[pi * page + t] : 0.f;
      const bool valid = tv && (p0 + pi) * page + t < len;
      float part[MAXG];
#pragma unroll
      for (int i = 0; i < MAXG; ++i) part[i] = 0.f;
      if (tv) {
        for (int c = sub * 4; c < D; c += 32) {
          const float4 k4 = load4(kp + t * D + c);
#pragma unroll
          for (int i = 0; i < MAXG; ++i) {
            const float4 q4 = *reinterpret_cast<const float4*>(qs + i * D + c);
            part[i] = fmaf(q4.x, k4.x, fmaf(q4.y, k4.y,
                      fmaf(q4.z, k4.z, fmaf(q4.w, k4.w, part[i]))));
          }
        }
      }
#pragma unroll
      for (int rg = 0; rg < MAXG / 8; ++rg) {
        const float s = reduce_scatter8(part + 8 * rg, lane);
        const int g = 8 * rg + sub;
        if (tv && g < G) pb[g * page + t] = valid ? s * ks : NEG_INF;
      }
    }
    __syncthreads();
    // online softmax: a warp per query row, a lane per page slot
    for (int g = warp; g < G; g += NWARPS) {
      const float s = lane < page ? pb[g * page + lane] : -INFINITY;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = lane < page ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      if (lane < page) {
        float pv = p;
        if constexpr (kScaled) pv *= vsc[pi * page + lane];
        pb[g * page + lane] = pv;
      }
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[buf * G + g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // PV: a thread's columns against every row's probabilities
    const KV* vp = vt + (size_t)pi * page * D;
    float pv[DPT][MAXG];
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd)
#pragma unroll
      for (int g = 0; g < MAXG; ++g) pv[dd][g] = 0.f;
    for (int t = 0; t < page; ++t) {
      float pr[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) pr[g] = g < G ? pb[g * page + t] : 0.f;
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        const int c = tid + dd * NT;
        if (c < D) {
          const float v = to_f(vp[t * D + c]);
#pragma unroll
          for (int g = 0; g < MAXG; ++g) pv[dd][g] = fmaf(pr[g], v, pv[dd][g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      const float alpha = g < G ? a_s[buf * G + g] : 0.f;
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd)
        acc[dd][g] = acc[dd][g] * alpha + pv[dd][g];
    }
  }
  __syncthreads();

  if (n_sp > 1) {
    // this split's (m, l, acc) to the scratch; the last split merges
    const size_t bh = (size_t)b * Hkv + h;
    float* accp = partial + bh * S * GD;
    float* ml = partial + (size_t)B * Hkv * S * GD + bh * S * G * 2;
    if (tid < G) {
      ml[(sp * G + tid) * 2] = m_s[tid];
      ml[(sp * G + tid) * 2 + 1] = l_s[tid];
    }
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd)
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        const int c = tid + dd * NT;
        if (c < D && g < G) accp[(size_t)sp * GD + g * D + c] = acc[dd][g];
      }
    if (!arrive_last(&counters[bh], n_sp)) return;
    for (int i = tid; i < n_sp * G * 2; i += NT) mls[i] = __ldcg(ml + i);
    __syncthreads();
    if (tid < G) {
      float m = NEG_INF;
      for (int s = 0; s < n_sp; ++s) m = fmaxf(m, mls[(s * G + tid) * 2]);
      float l = 0.f;
      for (int s = 0; s < n_sp; ++s) {
        const float wgt = expf(mls[(s * G + tid) * 2] - m);
        wts[s * G + tid] = wgt;
        l += mls[(s * G + tid) * 2 + 1] * wgt;
      }
      m_s[tid] = m;
      l_s[tid] = l;
    }
    __syncthreads();
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd)
#pragma unroll
      for (int g = 0; g < MAXG; ++g) acc[dd][g] = 0.f;
    // the splits' acc through shared memory, as many at a time as fit,
    // summed in split order
    const int per = (int)(tile_bytes(G, D, page, sizeof(KV)) / (sizeof(float) * GD));
    for (int s0 = 0; s0 < n_sp; s0 += per) {
      const int s1 = min(n_sp, s0 + per);
      const float* src = accp + (size_t)s0 * GD;
      for (int i = tid * 4; i < (s1 - s0) * GD; i += NT * 4)
        cp_async16(stage + i, src + i);
      asm volatile("cp.async.commit_group;" ::: "memory");
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();
      for (int s = s0; s < s1; ++s) {
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd)
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            const int c = tid + dd * NT;
            if (c < D && g < G)
              acc[dd][g] += stage[(s - s0) * GD + g * D + c] * wts[s * G + g];
          }
      }
      __syncthreads();
    }
  }

  if (has_extra) {
    // the current token's (k, v): one more online-softmax column
    for (int g = warp; g < G; g += NWARPS) {
      float s = 0.f;
      for (int c = lane; c < D; c += 32) s = fmaf(qs[g * D + c], k0s[c], s);
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
    for (int dd = 0; dd < DPT; ++dd)
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        const int c = tid + dd * NT;
        if (c < D && g < G) acc[dd][g] = acc[dd][g] * a_s[g] + ps[g] * v0s[c];
      }
  }

  T* ob = out + ((size_t)b * Hkv + h) * GD;
#pragma unroll
  for (int dd = 0; dd < DPT; ++dd)
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      const int c = tid + dd * NT;
      if (c < D && g < G)
        store(ob + g * D + c, acc[dd][g] / fmaxf(l_s[g], 1e-30f));
    }
}

template <typename T, typename KV, int MAXG>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales, const void* table,
           const void* seq_lens, const void* k0, const void* v0, void* out,
           void* partial, void* counters, int B, int Hkv, int G, int D, int P,
           int page, int n_pages, cudaStream_t stream) {
  const int S = (n_pages + PPS - 1) / PPS;
  if (S > 1 && (partial == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(MAXG, G, D, page, S, sizeof(KV));
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  static size_t attr = 48 * 1024;   // largest dynamic size allowed so far
  if (smem > attr) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, KV, MAXG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr = smem;
  }
  if (B > 65535 || S > 65535) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid(Hkv, B, S);
  paged_decode_kernel<T, KV, MAXG><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_pages),
      static_cast<const KV*>(v_pages),
      static_cast<const __nv_bfloat16*>(k_scales),
      static_cast<const __nv_bfloat16*>(v_scales),
      static_cast<const int*>(table), static_cast<const int*>(seq_lens),
      static_cast<const T*>(k0), static_cast<const T*>(v0),
      static_cast<T*>(out), static_cast<float*>(partial),
      static_cast<int*>(counters), Hkv, G, D, P, page, n_pages, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int launch_g(const void* q, const void* k_pages, const void* v_pages,
             const void* k_scales, const void* v_scales, const void* table,
             const void* seq_lens, const void* k0, const void* v0, void* out,
             void* partial, void* counters, int B, int Hkv, int G, int D,
             int P, int page, int n_pages, cudaStream_t stream) {
  if (G <= 8)
    return launch<T, KV, 8>(q, k_pages, v_pages, k_scales, v_scales, table,
                            seq_lens, k0, v0, out, partial, counters, B, Hkv,
                            G, D, P, page, n_pages, stream);
  return launch<T, KV, 16>(q, k_pages, v_pages, k_scales, v_scales, table,
                           seq_lens, k0, v0, out, partial, counters, B, Hkv,
                           G, D, P, page, n_pages, stream);
}

template <typename T>
int launch_pool(int kv_dtype, const void* q, const void* k_pages,
                const void* v_pages, const void* k_scales,
                const void* v_scales, const void* table, const void* seq_lens,
                const void* k0, const void* v0, void* out, void* partial,
                void* counters, int B, int Hkv, int G, int D, int P, int page,
                int n_pages, cudaStream_t stream) {
  const bool scaled = k_scales != nullptr && v_scales != nullptr;
  if (kv_dtype == 0 && !scaled)
    return launch_g<T, T>(q, k_pages, v_pages, nullptr, nullptr, table,
                        seq_lens, k0, v0, out, partial, counters, B, Hkv, G, D,
                        P, page, n_pages, stream);
  if (kv_dtype == 1 && scaled)
    return launch_g<T, int8_t>(q, k_pages, v_pages, k_scales, v_scales, table,
                             seq_lens, k0, v0, out, partial, counters, B, Hkv,
                             G, D, P, page, n_pages, stream);
  if (kv_dtype == 2 && scaled)
    return launch_g<T, __nv_fp8_e4m3>(q, k_pages, v_pages, k_scales, v_scales,
                                    table, seq_lens, k0, v0, out, partial,
                                    counters, B, Hkv, G, D, P, page, n_pages,
                                    stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (q, extra_kv, out): 0 = float32, 1 = bfloat16.  kv_dtype (pools):
// 0 = q's dtype, unscaled; 1 = int8 and 2 = fp8_e4m3, each with bf16
// k_scales/v_scales (both non-null).  k0/v0 null = no extra column.
// partial: B * Hkv * S * G * (D + 2) floats and counters: B * Hkv zeroed
// ints (left zeroed), S = ceil(n_pages / PPS); both may be null when
// S == 1.  Pools 16-byte aligned.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* table,
    const void* seq_lens, const void* k0, const void* v0, void* out,
    void* partial, void* counters, int B, int Hkv, int G, int D, int P,
    int page, int n_pages, int dtype, int kv_dtype, void* stream) {
  if (G < 1 || G > MAX_GROUP || D > NT * DPT || page < 1 || page > 32 ||
      D < 32 || D % 32 || n_pages < 1 ||
      ((reinterpret_cast<uintptr_t>(k_pages) |
        reinterpret_cast<uintptr_t>(v_pages)) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_pool<float>(kv_dtype, q, k_pages, v_pages, k_scales,
                              v_scales, table, seq_lens, k0, v0, out, partial,
                              counters, B, Hkv, G, D, P, page, n_pages, s);
  if (dtype == 1)
    return launch_pool<__nv_bfloat16>(kv_dtype, q, k_pages, v_pages, k_scales,
                                      v_scales, table, seq_lens, k0, v0, out,
                                      partial, counters, B, Hkv, G, D, P,
                                      page, n_pages, s);
  return (int)cudaErrorInvalidValue;
}
