// Write-accumulate (K4) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/write_accumulate/kernel.py:38
// (`write_accumulate`, Pallas call at :46): the TAB's in-memory reduction
// (paper 3.3.1), N contributions of (rows, cols) summed elementwise into
// one output in an fp32 accumulator.  The TPU kernel kept the output block
// resident in VMEM while the shard axis ran innermost on its sequential
// grid; here each thread keeps its output elements in registers and loops
// over the N shards itself, in index order, and writes once in the input
// dtype.  The order is fixed, so a run gives the same bits every time.
// The wrapper hands over the flat length; nothing is padded.
//
// What bounds it on this card: the bytes, N reads and one write of every
// element at 3.35 TB/s; it does one add per byte or two.  Design for that:
// one thread per 16 bytes of output (8 bf16 or 4 fp32), 16-byte loads of
// every shard when the flat length and the pointers allow it (one element
// a thread otherwise), N independent loads in flight per thread, and a
// grid-stride loop over a grid of a few CTAs per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// VEC elements (16 bytes, or 1 element) per group; x: (n, len) row-major
template <typename T, int VEC>
__global__ void __launch_bounds__(NT) write_accumulate_kernel(
    const T* __restrict__ x, T* __restrict__ out, int n, long long len) {
  const long long groups = len / VEC;
  const long long stride = (long long)gridDim.x * NT;
  for (long long g = (long long)blockIdx.x * NT + threadIdx.x; g < groups;
       g += stride) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int s = 0; s < n; ++s) {
      const T* p = x + s * len + g * VEC;
      if constexpr (VEC == 1) {
        acc[0] += to_f(*p);
      } else {
        union {
          uint4 v;
          T e[VEC];
        } u;
        u.v = *reinterpret_cast<const uint4*>(p);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += to_f(u.e[e]);
      }
    }
    if constexpr (VEC == 1) {
      from_f(out + g, acc[0]);
    } else {
      union {
        uint4 v;
        T e[VEC];
      } u;
#pragma unroll
      for (int e = 0; e < VEC; ++e) from_f(&u.e[e], acc[e]);
      *reinterpret_cast<uint4*>(out + g * VEC) = u.v;
    }
  }
}

template <typename T>
int launch(const void* x, void* out, int n, long long len, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = len % VEC == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long groups = vec ? len / VEC : len;
  static int sms = 0;   // SMs of the card, read once
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return (int)cudaGetLastError();
  }
  long long blocks = (groups + NT - 1) / NT;
  if (blocks > 16LL * sms) blocks = 16LL * sms;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vec)
    write_accumulate_kernel<T, VEC><<<(unsigned)blocks, NT, 0, s>>>(xt, ot, n,
                                                                    len);
  else
    write_accumulate_kernel<T, 1><<<(unsigned)blocks, NT, 0, s>>>(xt, ot, n,
                                                                  len);
  return (int)cudaGetLastError();
}

}  // namespace

// x: a contiguous (n, len); out: (len,).  dtype: 0 = float32,
// 1 = bfloat16.  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int write_accumulate_launch(const void* x, void* out, int n,
                                       long long len, int dtype,
                                       void* stream) {
  if (n < 1 || len < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, out, n, len, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, out, n, len, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The TAB's collective (K4 redesigned for this card): write, completion
// notice and read in one kernel, issued on the rank's stream.
//
// The ranks of a mesh are processes that share one region of device
// memory: two halves of N slots each, and a flag area of one 64-bit
// arrival word per (rank, CTA) followed by one error word per rank.  A
// collective runs on a fixed grid of CTAS CTAs, whatever its size; CTA b
// owns chunk b of the contribution.  CTA b:
//   1. reads its sequence number s from its own arrival word (the last
//      collective it published, plus one) -- the sequence lives on the
//      device, so a captured CUDA graph bakes in no half and no count,
//      and a block with an odd number of collectives replays safely;
//   2. writes chunk b of this rank's contribution into this rank's slot
//      of half s % 2 (16-byte stores where the sizes and pointers allow);
//   3. publishes s with a system-scope release (every thread fences its
//      stores first), then spins with a system-scope acquire on chunk b's
//      arrival word of every peer, with a __nanosleep back-off;
//   4. reads chunk b of the N slots through L2 (ld.global.cg): either
//      their fp32 sum in slot order, rounded once to the input dtype
//      (K4's body, so the sum is equal on every rank), or a copy of all
//      N (the gather mode that all-gather, all-to-all, ppermute and the
//      vote are built from).
// No CTA waits on another CTA of its own kernel, so no co-residency is
// assumed.  Two halves are enough: a rank that reaches s + 2 has seen
// every peer arrive at s + 1, and stream order means each peer's kernel
// for s (its reads of half s % 2 included) had ended by then.
//
// The watchdog: a spin is bounded by %globaltimer to the wrapper's
// timeout.  Past it the CTA writes (s << 8) | (peer + 1) into its rank's
// error word and exits; every later collective of a rank that sees an
// error word set exits at once without arriving, so a fault reaches
// every rank within one timeout.  The host reads the error words where
// it already waits for the device and raises; it never carries on.
//
// What bounds it: bytes, n written + N n read + the output written
// (n for the sum, N n for the gather) at 3.35 TB/s, and the sum's
// (N - 1) fp32 adds an element.  At decode shapes (N x 40 KB) that is
// tens of nanoseconds: there it is bound by the peers' arrival, which
// for ranks that are processes time-sliced on one card is a context
// switch.  What the design does about it: one kernel a collective and no
// host round trip, so a rank's whole decode block can be one CUDA graph
// and the card never waits for the host between collectives; the spin
// polls one word per CTA in L2.
// ---------------------------------------------------------------------------

namespace {

constexpr int CTAS = 32;   // the fixed grid; Python's FLAG_CTAS equals it

struct Region {
  unsigned char* data;           // the two halves
  unsigned long long* flags;     // (size, CTAS) arrival words, size errors
  long long half;                // bytes of a half
  long long stride;              // bytes of a slot
  int rank, size;
  unsigned long long timeout_ns;
};

__device__ __forceinline__ unsigned long long ld_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// CTA blockIdx.x's share [lo, hi) of `units` units
__device__ __forceinline__ void cta_share(long long units, long long* lo,
                                          long long* hi) {
  const long long per = (units + CTAS - 1) / CTAS;
  *lo = min(units, (long long)blockIdx.x * per);
  *hi = min(units, *lo + per);
}

// Step 1: this CTA's sequence number, 0 when a rank's error word is set
__device__ unsigned long long tab_begin(const Region& g) {
  __shared__ unsigned long long s_seq;
  if (threadIdx.x == 0) {
    unsigned long long seq =
        *reinterpret_cast<volatile unsigned long long*>(
            g.flags + (long long)g.rank * CTAS + blockIdx.x) + 1;
    const unsigned long long* err = g.flags + (long long)g.size * CTAS;
    for (int p = 0; p < g.size; ++p)
      if (ld_acquire_sys(err + p) != 0) seq = 0;
    s_seq = seq;
  }
  __syncthreads();
  return s_seq;
}

// Step 3: publish this CTA's arrival at `seq`, wait for every peer's
// CTA of the same index; false when the watchdog fired
__device__ bool tab_notice(const Region& g, unsigned long long seq) {
  __shared__ int s_ok;
  __threadfence_system();          // this thread's slot stores first
  __syncthreads();
  if (threadIdx.x == 0) {
    st_release_sys(g.flags + (long long)g.rank * CTAS + blockIdx.x, seq);
    int ok = 1;
    const unsigned long long t0 = global_ns();
    for (int p = 0; p < g.size && ok; ++p) {
      if (p == g.rank) continue;
      const unsigned long long* f = g.flags + (long long)p * CTAS +
                                    blockIdx.x;
      unsigned ns = 32;
      while (ld_acquire_sys(f) < seq) {
        if (global_ns() - t0 > g.timeout_ns) {
          atomicCAS_system(g.flags + (long long)g.size * CTAS + g.rank,
                           0ULL, (seq << 8) | (unsigned long long)(p + 1));
          ok = 0;
          break;
        }
        __nanosleep(ns);
        if (ns < 1024) ns *= 2;
      }
    }
    s_ok = ok;
  }
  __syncthreads();
  return s_ok != 0;
}

// The sum: len elements of T, VEC (16 bytes) or 1 a unit
template <typename T, int VEC>
__global__ void __launch_bounds__(NT) tab_sum_kernel(
    Region g, const T* __restrict__ src, T* __restrict__ out,
    long long len) {
  const unsigned long long seq = tab_begin(g);
  if (seq == 0) return;
  unsigned char* base = g.data + (long long)(seq & 1) * g.half;
  long long lo, hi;
  cta_share(len / VEC, &lo, &hi);
  if constexpr (VEC == 1) {
    T* mine = reinterpret_cast<T*>(base + g.rank * g.stride);
    for (long long u = lo + threadIdx.x; u < hi; u += NT) mine[u] = src[u];
  } else {
    uint4* mine = reinterpret_cast<uint4*>(base + g.rank * g.stride);
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (long long u = lo + threadIdx.x; u < hi; u += NT) mine[u] = s4[u];
  }
  if (!tab_notice(g, seq)) return;
  for (long long u = lo + threadIdx.x; u < hi; u += NT) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int s = 0; s < g.size; ++s) {
      const unsigned char* slot = base + s * g.stride;
      if constexpr (VEC == 1) {
        acc[0] += to_f(__ldcg(reinterpret_cast<const T*>(slot) + u));
      } else {
        union {
          uint4 v;
          T e[VEC];
        } w;
        w.v = __ldcg(reinterpret_cast<const uint4*>(slot) + u);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += to_f(w.e[e]);
      }
    }
    if constexpr (VEC == 1) {
      from_f(out + u, acc[0]);
    } else {
      union {
        uint4 v;
        T e[VEC];
      } w;
#pragma unroll
      for (int e = 0; e < VEC; ++e) from_f(&w.e[e], acc[e]);
      reinterpret_cast<uint4*>(out)[u] = w.v;
    }
  }
}

// The gather: `units` units of U (uint4, or bytes) from every slot, into
// out (size, units) in slot order
template <typename U>
__global__ void __launch_bounds__(NT) tab_gather_kernel(
    Region g, const U* __restrict__ src, U* __restrict__ out,
    long long units) {
  const unsigned long long seq = tab_begin(g);
  if (seq == 0) return;
  unsigned char* base = g.data + (long long)(seq & 1) * g.half;
  long long lo, hi;
  cta_share(units, &lo, &hi);
  U* mine = reinterpret_cast<U*>(base + g.rank * g.stride);
  for (long long u = lo + threadIdx.x; u < hi; u += NT) mine[u] = src[u];
  if (!tab_notice(g, seq)) return;
  for (int s = 0; s < g.size; ++s) {
    const U* slot = reinterpret_cast<const U*>(base + s * g.stride);
    for (long long u = lo + threadIdx.x; u < hi; u += NT)
      out[s * units + u] = __ldcg(slot + u);
  }
}

}  // namespace

// The grid every collective runs on (the flag area has CTAS arrival
// words a rank).
extern "C" int tab_collective_ctas() { return CTAS; }

// One collective of this rank.  data: the region's two halves of `half`
// bytes each; flags: size * CTAS arrival words then size error words;
// src: this rank's nbytes; stride: a slot's bytes (>= nbytes).  mode 0:
// out (nbytes) = the sum of the slots, dtype 0 = float32, 1 = bfloat16;
// mode 1: out (size, nbytes) = every slot.  timeout_ns bounds each CTA's
// wait.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int tab_collective_launch(void* data, void* flags, const void* src,
                                     void* out, long long nbytes,
                                     long long stride, long long half,
                                     int rank, int size, int mode, int dtype,
                                     unsigned long long timeout_ns,
                                     void* stream) {
  if (nbytes < 1 || size < 1 || rank < 0 || rank >= size ||
      stride < nbytes || (long long)size * stride > half)
    return (int)cudaErrorInvalidValue;
  Region g{static_cast<unsigned char*>(data),
           static_cast<unsigned long long*>(flags), half, stride, rank, size,
           timeout_ns};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = nbytes % 16 == 0 && stride % 16 == 0 && half % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(data) |
                     reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (mode == 0 && dtype == 0) {
    const float* x = static_cast<const float*>(src);
    float* o = static_cast<float*>(out);
    if (vec)
      tab_sum_kernel<float, 4><<<CTAS, NT, 0, s>>>(g, x, o, nbytes / 4);
    else
      tab_sum_kernel<float, 1><<<CTAS, NT, 0, s>>>(g, x, o, nbytes / 4);
  } else if (mode == 0 && dtype == 1) {
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(src);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    if (vec)
      tab_sum_kernel<__nv_bfloat16, 8><<<CTAS, NT, 0, s>>>(g, x, o,
                                                           nbytes / 2);
    else
      tab_sum_kernel<__nv_bfloat16, 1><<<CTAS, NT, 0, s>>>(g, x, o,
                                                           nbytes / 2);
  } else if (mode == 1) {
    if (vec)
      tab_gather_kernel<uint4><<<CTAS, NT, 0, s>>>(
          g, static_cast<const uint4*>(src), static_cast<uint4*>(out),
          nbytes / 16);
    else
      tab_gather_kernel<unsigned char><<<CTAS, NT, 0, s>>>(
          g, static_cast<const unsigned char*>(src),
          static_cast<unsigned char*>(out), nbytes);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
