// The expert-gather designs measured beside the port's SM kernel
// (src/repro_torch/kernels/csrc/expert_gather.cu) and set aside: each
// copies, for every bank, the rows of the experts whose byte in an (E,)
// device mask is set, from banks in mapped pinned host memory into device
// buffers of the banks' shapes, without the host learning the routing.
// Built and driven by tools/gather_designs.py; not part of the port.
//
//   cond:   one CUDA graph built with the runtime's graph API -- a setter
//           kernel reads the mask and switches one conditional IF node an
//           expert (cudaGraphSetConditional), whose body holds one memcpy
//           node a bank;
//   launch: one device-launchable graph an expert (one memcpy node a bank)
//           and a launcher kernel, itself in a graph, that starts the
//           routed experts' graphs from the device (fire and forget);
//   tma:    the SM kernel's grid, each CTA moving its 64 KB chunk of a row
//           with cp.async.bulk into shared memory (four 16 KB stages on
//           one mbarrier each) and from there to the buffer.
//
// The graphs bake in every address they copy from and to, the mask's and
// the byte word's; they write the routed bytes into the word.  Every
// function returns the first CUDA error (0 if none).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int MAX_BANKS = 4;
constexpr int MAX_EXPERTS = 120;   // fire-and-forget launches a graph
constexpr int CHUNK = 64 * 1024;   // bytes of a row per CTA (tma)
constexpr int STAGES = 4;          // 16 KB cp.async.bulk copies a CTA

struct Banks {
  const char* src[MAX_BANKS];
  char* dst[MAX_BANKS];
  long long row[MAX_BANKS];
};

struct Handles {
  cudaGraphConditionalHandle h[MAX_EXPERTS];
};

struct Execs {
  cudaGraphExec_t h[MAX_EXPERTS];
};

int resolve(Banks* b, const void* const* src, void* const* dst,
            const long long* row, int n_banks, int num_experts,
            long long* expert_bytes) {
  if (n_banks < 1 || n_banks > MAX_BANKS || num_experts < 1 ||
      num_experts > MAX_EXPERTS)
    return (int)cudaErrorInvalidValue;
  *expert_bytes = 0;
  for (int i = 0; i < n_banks; ++i) {
    void* mapped = nullptr;
    cudaError_t rc =
        cudaHostGetDevicePointer(&mapped, const_cast<void*>(src[i]), 0);
    if (rc != cudaSuccess) return (int)rc;
    if (row[i] % 16 || reinterpret_cast<uintptr_t>(mapped) % 16 ||
        reinterpret_cast<uintptr_t>(dst[i]) % 16)
      return (int)cudaErrorInvalidValue;
    b->src[i] = static_cast<const char*>(mapped);
    b->dst[i] = static_cast<char*>(dst[i]);
    b->row[i] = row[i];
    *expert_bytes += row[i];
  }
  return 0;
}

__global__ void setter(const __grid_constant__ Handles hs,
                       const uint8_t* __restrict__ mask, int num_experts,
                       long long expert_bytes,
                       unsigned long long* __restrict__ word) {
  const int e = threadIdx.x;
  const int on = e < num_experts && mask[e] != 0;
  if (e < num_experts) cudaGraphSetConditional(hs.h[e], on ? 1u : 0u);
  const int routed = __syncthreads_count(on);
  if (e == 0) *word = (unsigned long long)routed * expert_bytes;
}

__global__ void launcher(const __grid_constant__ Execs ex,
                         const uint8_t* __restrict__ mask, int num_experts,
                         long long expert_bytes,
                         unsigned long long* __restrict__ word) {
  const int e = threadIdx.x;
  const int on = e < num_experts && mask[e] != 0;
  if (on) cudaGraphLaunch(ex.h[e], cudaStreamGraphFireAndForget);
  const int routed = __syncthreads_count(on);
  if (e == 0) *word = (unsigned long long)routed * expert_bytes;
}

__global__ void __launch_bounds__(32) tma_gather(
    const __grid_constant__ Banks b, const uint8_t* __restrict__ mask,
    unsigned long long* __restrict__ counter) {
  extern __shared__ __align__(128) char stage[];
  __shared__ __align__(8) uint64_t bar[STAGES];
  const int e = blockIdx.y;
  const int k = blockIdx.z;
  if (threadIdx.x != 0 || !mask[e]) return;
  const long long row = b.row[k];
  const long long lo = (long long)blockIdx.x * CHUNK;
  if (lo >= row) return;
  const long long hi = lo + CHUNK < row ? lo + CHUNK : row;
  const char* src = b.src[k] + (long long)e * row + lo;
  char* dst = b.dst[k] + (long long)e * row + lo;
  const int piece = CHUNK / STAGES;
  const int n = (int)((hi - lo + piece - 1) / piece);
  for (int s = 0; s < n; ++s) hopper::mbar_init(hopper::smem_u32(&bar[s]), 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  for (int s = 0; s < n; ++s) {
    const uint32_t bytes = (uint32_t)(hi - lo - (long long)s * piece < piece
                                          ? hi - lo - (long long)s * piece
                                          : piece);
    const uint32_t b_s = hopper::smem_u32(&bar[s]);
    hopper::mbar_expect_tx(b_s, bytes);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(hopper::smem_u32(stage + s * piece)),
        "l"(src + (long long)s * piece), "r"(bytes), "r"(b_s)
        : "memory");
  }
  for (int s = 0; s < n; ++s) {
    const uint32_t bytes = (uint32_t)(hi - lo - (long long)s * piece < piece
                                          ? hi - lo - (long long)s * piece
                                          : piece);
    hopper::mbar_wait(hopper::smem_u32(&bar[s]), 0);
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
            dst + (long long)s * piece),
        "r"(hopper::smem_u32(stage + s * piece)), "r"(bytes)
        : "memory");
  }
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  atomicAdd(counter, (unsigned long long)(hi - lo));
}

int add_copies(cudaGraph_t g, const Banks& b, int n_banks, int e) {
  for (int i = 0; i < n_banks; ++i) {
    cudaGraphNode_t copy;
    cudaError_t rc = cudaGraphAddMemcpyNode1D(
        &copy, g, nullptr, 0, b.dst[i] + (long long)e * b.row[i],
        b.src[i] + (long long)e * b.row[i], (size_t)b.row[i],
        cudaMemcpyDefault);
    if (rc != cudaSuccess) return (int)rc;
  }
  return 0;
}

#define TRY(x)                    \
  do {                            \
    int rc_ = (int)(x);           \
    if (rc_) {                    \
      cudaGraphDestroy(g);        \
      return rc_;                 \
    }                             \
  } while (0)

}  // namespace

// design "cond": *exec_out gets the executable graph
extern "C" int designs_cond_build(const void* const* src, void* const* dst,
                                  const long long* row, int n_banks,
                                  const void* mask, int num_experts,
                                  void* word, void** exec_out) {
  Banks b = {};
  long long expert_bytes = 0;
  int rc = resolve(&b, src, dst, row, n_banks, num_experts, &expert_bytes);
  if (rc) return rc;
  cudaGraph_t g = nullptr;
  rc = (int)cudaGraphCreate(&g, 0);
  if (rc) return rc;
  Handles hs = {};
  for (int e = 0; e < num_experts; ++e)
    TRY(cudaGraphConditionalHandleCreate(&hs.h[e], g, 0,
                                         cudaGraphCondAssignDefault));
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  unsigned long long* w = static_cast<unsigned long long*>(word);
  void* args[] = {&hs, &m, &num_experts, &expert_bytes, &w};
  cudaKernelNodeParams kp = {};
  kp.func = (void*)setter;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3((unsigned)((num_experts + 31) / 32 * 32));
  kp.kernelParams = args;
  cudaGraphNode_t set;
  TRY(cudaGraphAddKernelNode(&set, g, nullptr, 0, &kp));
  for (int e = 0; e < num_experts; ++e) {
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = hs.h[e];
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
    cudaGraphNode_t node;
    TRY(cudaGraphAddNode(&node, g, &set, 1, &cp));
    TRY(add_copies(cp.conditional.phGraph_out[0], b, n_banks, e));
  }
  cudaGraphExec_t exec = nullptr;
  TRY(cudaGraphInstantiate(&exec, g, 0));
  cudaGraphDestroy(g);
  *exec_out = exec;
  return 0;
}

// design "launch": *exec_out gets the launcher's graph, every graph
// uploaded to `stream`
extern "C" int designs_launch_build(const void* const* src, void* const* dst,
                                    const long long* row, int n_banks,
                                    const void* mask, int num_experts,
                                    void* word, void* stream,
                                    void** exec_out) {
  Banks b = {};
  long long expert_bytes = 0;
  int rc = resolve(&b, src, dst, row, n_banks, num_experts, &expert_bytes);
  if (rc) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Execs ex = {};
  cudaGraph_t g = nullptr;
  for (int e = 0; e < num_experts; ++e) {
    rc = (int)cudaGraphCreate(&g, 0);
    if (rc) return rc;
    TRY(add_copies(g, b, n_banks, e));
    TRY(cudaGraphInstantiateWithFlags(&ex.h[e], g,
                                      cudaGraphInstantiateFlagDeviceLaunch));
    TRY(cudaGraphUpload(ex.h[e], st));
    cudaGraphDestroy(g);
  }
  rc = (int)cudaGraphCreate(&g, 0);
  if (rc) return rc;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  unsigned long long* w = static_cast<unsigned long long*>(word);
  void* args[] = {&ex, &m, &num_experts, &expert_bytes, &w};
  cudaKernelNodeParams kp = {};
  kp.func = (void*)launcher;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3((unsigned)((num_experts + 31) / 32 * 32));
  kp.kernelParams = args;
  cudaGraphNode_t node;
  TRY(cudaGraphAddKernelNode(&node, g, nullptr, 0, &kp));
  cudaGraphExec_t exec = nullptr;
  TRY(cudaGraphInstantiateWithFlags(&exec, g,
                                    cudaGraphInstantiateFlagDeviceLaunch));
  TRY(cudaGraphUpload(exec, st));
  cudaGraphDestroy(g);
  *exec_out = exec;
  return 0;
}

extern "C" int designs_graph_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                              static_cast<cudaStream_t>(stream));
}

// design "tma": counter gets the bytes copied added
extern "C" int designs_tma_launch(const void* const* src, void* const* dst,
                                  const long long* row, int n_banks,
                                  const void* mask, int num_experts,
                                  void* counter, void* stream) {
  Banks b = {};
  long long expert_bytes = 0;
  int rc = resolve(&b, src, dst, row, n_banks, num_experts, &expert_bytes);
  if (rc) return rc;
  long long longest = 0;
  for (int i = 0; i < n_banks; ++i)
    if (row[i] > longest) longest = row[i];
  rc = (int)cudaFuncSetAttribute(tma_gather,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 CHUNK);
  if (rc) return rc;
  dim3 grid((unsigned)((longest + CHUNK - 1) / CHUNK), num_experts, n_banks);
  tma_gather<<<grid, 32, CHUNK, static_cast<cudaStream_t>(stream)>>>(
      b, static_cast<const uint8_t*>(mask),
      static_cast<unsigned long long*>(counter));
  return (int)cudaGetLastError();
}
