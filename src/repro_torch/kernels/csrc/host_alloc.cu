// Pinned host memory mapped into the devices' address space, at its exact
// size: the memory layer's allocation for data that kernels read in place
// over PCIe (the expert banks at rest, read by expert_gather.cu).  Not a
// kernel.  cudaHostAlloc'd memory reads faster from the SMs than malloc'd
// memory registered with cudaHostRegisterMapped on some H100 machines
// (expert_gather.cu), and PyTorch's pinned allocator rounds every block up
// to a power of two.

#include <cuda_runtime.h>

// *out gets the host pointer, which under unified addressing is also the
// devices'.  Returns the CUDA error (0 if none).
extern "C" int host_alloc_mapped(long long bytes, void** out) {
  return (int)cudaHostAlloc(out, (size_t)bytes,
                            cudaHostAllocPortable | cudaHostAllocMapped);
}

extern "C" int host_alloc_free(void* p) { return (int)cudaFreeHost(p); }
