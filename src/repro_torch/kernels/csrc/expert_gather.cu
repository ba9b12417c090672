// Expert gather for Hopper, sm_90a: pages the routed experts' rows of an
// MoE layer's expert banks into device memory.
//
// Port-only: no TPU kernel corresponds to it.  The reference pages expert
// rows with an XLA gather (`jnp.take` + `page_in` in
// src/repro/memory/policies.py, TopKExpertPrefetch.gather), one bank row
// per (token, choice).  Here the banks (E, ...) rest in pinned host memory
// mapped into the device's address space, and one launch copies, for
// every bank, the rows of the experts whose byte in the (E,) device mask
// is set into a device buffer, packed: expert e's row into row slot[e]
// of a buffer of min(N, E) + 1 rows (the slot map, a prefix sum over the
// mask, is built on the device too).  The kernel reads the mask itself
// (written by the router's top-k on the same stream), so the host never
// learns which experts were routed and never waits; rows of
// unrouted experts are not touched.  Each CTA adds the bytes it copied to
// a device counter, so a run can show that only routed rows moved.
//
// What bounds it on this card: the bytes, read across PCIe (Gen5 x16, 64
// GB/s a direction) by the SMs themselves (zero-copy loads of mapped host
// memory) and written once to HBM.  How fast the SMs read the link
// depends on the machine and on the host memory: on H100 80GB HBM3
// machines 48 GB/s on some, and on the others 19.7 GB/s from malloc'd
// memory registered with cudaHostRegisterMapped against 28.5 GB/s from
// memory cudaHostAlloc mapped, where a copy engine moved 42.5 GB/s from
// the same memory.  So the banks rest in cudaHostAlloc'd memory
// (host_alloc.cu).  A copy engine is started only by the host, which must
// not learn the routing: copies chosen on the device (conditional graph
// nodes, run as memcpy128 kernels, and device-launched graphs) ran no
// faster than this kernel over the banks' memory, and cp.async.bulk
// reads of the mapped rows slower (tools/gather_designs.py measures each
// beside it).
//
// Design: enough 16-byte loads in flight to cover the link's latency --
// CTAs of 256 threads, each thread holding 4 loads in flight, each CTA
// one 64 KB chunk of one row, one grid over (chunk, expert, bank), CTAs of
// unrouted experts leaving at once.  Rows whose length or pointers are
// not 16-byte multiples take a byte-wise path.  Other launch shapes (128
// to 1024 threads, 4 to 16 loads in flight, 16 KB to 256 KB chunks) moved
// the rate by a few percent.  Banks in device memory take the same path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                 // threads a CTA
constexpr int UNROLL = 4;               // 16-byte loads in flight a thread
constexpr long long CHUNK = 64 * 1024;  // bytes of a row per CTA
constexpr int MAX_BANKS = 4;

struct Banks {
  const char* src[MAX_BANKS];
  char* dst[MAX_BANKS];
  long long row[MAX_BANKS];   // bytes of one expert's row
};

// the banks stay in parameter memory (__grid_constant__): indexing them
// with blockIdx.z would otherwise copy the struct to the local stack
template <bool VEC>
__global__ void __launch_bounds__(NT) expert_gather_kernel(
    const __grid_constant__ Banks b, const uint8_t* __restrict__ mask,
    const int* __restrict__ slot, unsigned long long* __restrict__ counter) {
  const int e = blockIdx.y;
  const int k = blockIdx.z;
  if (!mask[e]) return;
  const long long row = b.row[k];
  const long long lo = (long long)blockIdx.x * CHUNK;
  if (lo >= row) return;
  const long long hi = lo + CHUNK < row ? lo + CHUNK : row;
  const char* src = b.src[k] + (long long)e * row;
  char* dst = b.dst[k] + (long long)slot[e] * row;
  if constexpr (VEC) {
    const uint4* s = reinterpret_cast<const uint4*>(src + lo);
    uint4* d = reinterpret_cast<uint4*>(dst + lo);
    const long long n = (hi - lo) / 16;
    long long i = threadIdx.x;
    for (; i + (UNROLL - 1) * NT < n; i += UNROLL * NT) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = s[i + u * NT];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) d[i + u * NT] = v[u];
    }
    for (; i < n; i += NT) d[i] = s[i];
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += NT) dst[i] = src[i];
  }
  if (threadIdx.x == 0) atomicAdd(counter, (unsigned long long)(hi - lo));
}

}  // namespace

// src[i]: bank i (E rows of row[i] bytes), host memory when bit i of
// host_banks is set (mapped through cudaHostGetDevicePointer), device
// memory otherwise; dst[i]: its device buffer of rows of the same
// bytes; mask: (E,) bytes on the device; slots: (E,) int32 on the device,
// the buffer row of each routed expert; counter: one
// unsigned 64-bit device word the bytes copied are added to.  Returns
// the first CUDA error (0 if none).
extern "C" int expert_gather_launch(const void* const* src,
                                    void* const* dst, const long long* row,
                                    int n_banks, int host_banks,
                                    const void* mask, const void* slots,
                                    int num_experts, void* counter,
                                    void* stream) {
  if (n_banks < 1 || n_banks > MAX_BANKS || num_experts < 1 ||
      num_experts > 65535 || slots == nullptr)
    return (int)cudaErrorInvalidValue;
  Banks b = {};
  long long longest = 0;
  bool vec = true;
  for (int i = 0; i < n_banks; ++i) {
    const void* s = src[i];
    if (host_banks & (1 << i)) {
      void* mapped = nullptr;
      cudaError_t rc = cudaHostGetDevicePointer(
          &mapped, const_cast<void*>(s), 0);
      if (rc != cudaSuccess) return (int)rc;
      s = mapped;
    }
    b.src[i] = static_cast<const char*>(s);
    b.dst[i] = static_cast<char*>(dst[i]);
    b.row[i] = row[i];
    if (row[i] > longest) longest = row[i];
    vec = vec && row[i] % 16 == 0 &&
          reinterpret_cast<uintptr_t>(s) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(dst[i]) % 16 == 0;
  }
  if (longest < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((longest + CHUNK - 1) / CHUNK), num_experts,
            n_banks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const int* sl = static_cast<const int*>(slots);
  unsigned long long* c = static_cast<unsigned long long*>(counter);
  if (vec)
    expert_gather_kernel<true><<<grid, NT, 0, st>>>(b, m, sl, c);
  else
    expert_gather_kernel<false><<<grid, NT, 0, st>>>(b, m, sl, c);
  return (int)cudaGetLastError();
}
