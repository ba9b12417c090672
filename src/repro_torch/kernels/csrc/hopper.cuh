// Hopper (sm_90a) building blocks shared by the kernels that stream tiles
// with the Tensor Memory Accelerator (or store them from registers) and
// multiply them with wgmma: mbarriers, TMA tile loads, the async-proxy
// fence, shared-memory matrix descriptors and the host-side tensor-map
// encoding.  Included by streamed_matmul.cu (K3) and
// flash_attention.cu (K2); build.py hashes it with every source that
// includes it, so an edit here rebuilds both.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// orders this thread's generic-proxy writes to shared memory before the
// async proxy's reads (wgmma operands stored by threads, not by TMA): each
// writing thread runs it before it arrives on the barrier the readers wait
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// one tile of a 2-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the same for a 4-D tensor map
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// a shared-memory matrix descriptor; layout 1 = 128-byte swizzle, 2 =
// 64-byte swizzle (the wgmma descriptor's layout-type field)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// a shared-memory matrix descriptor with the 128-byte swizzle
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return smem_desc(addr, lbo, sbo, 1);
}

// a 2-D bf16 tensor map, 128-byte swizzle: dims (inner, outer), the outer
// stride in bytes, a box of (box_inner, box_outer) elements
inline int encode(CUtensorMap* map, const void* ptr, uint64_t inner,
                  uint64_t outer, uint64_t stride_bytes, uint32_t box_inner,
                  uint32_t box_outer) {
  cuuint64_t dims[2] = {inner, outer};
  cuuint64_t strides[1] = {stride_bytes};
  cuuint32_t box[2] = {box_inner, box_outer};
  cuuint32_t estr[2] = {1, 1};
  CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// a 4-D bf16 tensor map: dims[0] contiguous, strides (bytes) of dims 1-3,
// a box of box[0..3] elements, the given swizzle; out-of-bounds elements
// of a box land as zeros
inline int encode_4d(CUtensorMap* map, const void* ptr, const uint64_t dims[4],
                     const uint64_t stride_bytes[3], const uint32_t box[4],
                     CUtensorMapSwizzle swizzle) {
  cuuint64_t d[4] = {dims[0], dims[1], dims[2], dims[3]};
  cuuint64_t s[3] = {stride_bytes[0], stride_bytes[1], stride_bytes[2]};
  cuuint32_t b[4] = {box[0], box[1], box[2], box[3]};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), d, s,
      b, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hopper
