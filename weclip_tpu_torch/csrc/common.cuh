// Shared helpers of the port's CUDA kernels: bf16 packing, the bf16
// tensor-core product, warp and fragment-row reductions, index
// clamping, cp.async copies and ldmatrix loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace weclip {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// two floats -> bf16x2 (round to nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row-major fragments) * b (16x8, column fragments)
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// reductions over the 4 lanes (t = lane & 3) that share a fragment row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// asynchronous global -> shared copies (cp.async): `src_bytes` of `bytes`
// are read, the rest of the destination is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i receives matrix i's fragment (row
// lane / 4, columns 2 (lane % 4) and the next); .trans transposes each
// matrix on the way
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// A kernel's large shared arrays: each declared static (`st`) where they
// fit the 48 KB of static shared memory (kStatic), else the same array of
// the dynamic shared memory laid out as a struct T
// (dynamic_block<T>().member), the static one collapsed to one element.
// The static arrays stay separate declarations: grouped in a struct, the
// same arrays compile to other code (attn_map_kernel<32>: 127 registers
// instead of 96 on sm_90a).
template <typename T>
__device__ __forceinline__ T& dynamic_block() {
  extern __shared__ __align__(16) uint8_t dynamic_smem[];
  return *reinterpret_cast<T*>(dynamic_smem);
}

template <bool kStatic, typename S, typename D>
__device__ __forceinline__ auto& static_or_dynamic(S& st, D& dyn) {
  if constexpr (kStatic)
    return st;
  else
    return dyn;
}

// the dynamic shared memory of a launch of `kern`: 0 where its arrays are
// static, else sizeof(T), which the kernel is opted in to
template <typename T, bool kStatic, typename Kernel>
cudaError_t smem_bytes(Kernel kern, int* bytes) {
  *bytes = kStatic ? 0 : (int)sizeof(T);
  if (*bytes == 0) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
}

}  // namespace weclip

// F(DH, PAD) for the instance that runs head width Dh: the exact width
// where it is one, else the next one up with padded lanes; Dh > 128 or < 1
// is refused
#define WECLIP_DISPATCH_DH(Dh, F)                            \
  do {                                                       \
    if ((Dh) == 64) return F(64, false);                     \
    if ((Dh) == 32) return F(32, false);                     \
    if ((Dh) == 16) return F(16, false);                     \
    if ((Dh) == 128) return F(128, false);                   \
    if ((Dh) >= 1 && (Dh) < 16) return F(16, true);          \
    if ((Dh) > 16 && (Dh) < 32) return F(32, true);          \
    if ((Dh) > 32 && (Dh) < 64) return F(64, true);          \
    if ((Dh) > 64 && (Dh) < 128) return F(128, true);        \
    return cudaErrorInvalidValue;                            \
  } while (0)
