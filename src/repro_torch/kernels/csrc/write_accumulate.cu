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
