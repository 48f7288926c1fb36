// Shared helpers of the port's CUDA kernels: bf16 packing and scaling, the bf16
// tensor-core product, warp and fragment-row reductions, index
// clamping, cp.async copies and ldmatrix loads; and (weclip::tc) the
// split-TF32 and bf16 fragment products with the tiles they read.
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

// two bf16 values x (the first in the low half) -> bf16(float(x) * s)
__device__ __forceinline__ uint32_t scale2(uint32_t x, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack_bf16(f.x * s, f.y * s);
}

// eight bf16 values x -> bf16(float(x) * s)
__device__ __forceinline__ uint4 scale8(uint4 x, float s) {
  return make_uint4(scale2(x.x, s), scale2(x.y, s), scale2(x.z, s), scale2(x.w, s));
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

// ===========================================================================
// weclip::tc, the tensor-core products on mma.sync and their tiles, shared
// by cross_attention.cu (the attention forward and backward), attention.cu
// (K1's map) and crf.cu (K7).  A namespace of its own, which `using
// namespace weclip` does not bring in: flash_attention.cu has helpers of
// the same names.
// ===========================================================================

namespace weclip {
namespace tc {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// The products: Ops<float> as three TF32 products of split operands
// (m16n8k8), Ops<bf16> as one bf16 product (m16n8k16).  g = lane / 4, t =
// lane % 4.  A is 16 x kK (rows r0 + g and r0 + g + 8), B kK x 8, C 16 x 8
// (c0, c1 at row g, columns 2t and 2t + 1; c2, c3 at row g + 8)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// the same split for finite x in two integer operations a part: cvt.rna
// adds half a tf32 ulp to the bits and clears the low 13 where x is finite
// (its guard for inf and NaN costs two more instructions a conversion)
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32_finite(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
struct Ops;

template <>
struct Ops<float> {
  static constexpr int kK = 8;     // k of one product
  static constexpr int kPad = 4;   // row stride DH + 4 floats: conflict-free fragment loads
  struct A { uint32_t h[4], l[4]; };
  struct B { uint32_t h[2], l[2]; };
  // A[r][k] = s[(r0 + r) * ss + k0 + k]: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
  static __device__ __forceinline__ void load_a(A& a, const float* s, int ss, int r0, int k0,
                                                int g, int t) {
    const float* p = s + (r0 + g) * ss + k0 + t;
    split_tf32(p[0], a.h[0], a.l[0]);
    split_tf32(p[8 * ss], a.h[1], a.l[1]);
    split_tf32(p[4], a.h[2], a.l[2]);
    split_tf32(p[8 * ss + 4], a.h[3], a.l[3]);
  }
  // B[k][n] = s[(n0 + n) * ss + k0 + k]: b0 (t, g), b1 (t + 4, g)
  static __device__ __forceinline__ void load_bt(B& b, const float* s, int ss, int n0, int k0,
                                                 int g, int t) {
    const float* p = s + (n0 + g) * ss + k0 + t;
    split_tf32(p[0], b.h[0], b.l[0]);
    split_tf32(p[4], b.h[1], b.l[1]);
  }
  // B[k][n] = s[(k0 + o(k)) * ss + n0 + n], o = (0, 2, 4, 6, 1, 3, 5, 7):
  // b0 from row 2t, b1 from row 2t + 1, the order of from_acc
  static __device__ __forceinline__ void load_b(B& b, const float* s, int ss, int k0, int n0,
                                                int g, int t) {
    const float* p = s + (k0 + 2 * t) * ss + n0 + g;
    split_tf32(p[0], b.h[0], b.l[0]);
    split_tf32(p[ss], b.h[1], b.l[1]);
  }
  // one accumulator tile (16 x 8) as an A operand, its columns in the
  // order o: a0 = c0 (column 2t), a1 = c2, a2 = c1 (column 2t + 1), a3 = c3
  static __device__ __forceinline__ void from_acc(A& a, const float (*c)[4]) {
    split_tf32(c[0][0], a.h[0], a.l[0]);
    split_tf32(c[0][2], a.h[1], a.l[1]);
    split_tf32(c[0][1], a.h[2], a.l[2]);
    split_tf32(c[0][3], a.h[3], a.l[3]);
  }
  // c += hi B_hi, small += lo B_hi + hi B_lo (lo lo dropped; small may be
  // c).  Apart, the small terms are not truncated against the large sum:
  // the tensor cores align each addend to the accumulator's exponent
  static constexpr bool kSmall = true;
  static __device__ __forceinline__ void mma(float (&c)[4], float (&small)[4], const A& a,
                                             const B& b) {
    mma_tf32(small, a.l, b.h[0], b.h[1]);
    mma_tf32(c, a.h, b.h[0], b.h[1]);
    mma_tf32(small, a.h, b.l[0], b.l[1]);
  }
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pair(const bf16* lo, const bf16* hi) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(lo) |
         ((uint32_t)*reinterpret_cast<const uint16_t*>(hi) << 16);
}

template <>
struct Ops<bf16> {
  static constexpr int kK = 16;
  static constexpr int kPad = 8;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  // a0 (g, 2t..2t+1), a1 (g + 8, ...), a2 (g, 2t+8..2t+9), a3 (g + 8, ...)
  static __device__ __forceinline__ void load_a(A& a, const bf16* s, int ss, int r0, int k0,
                                                int g, int t) {
    const bf16* p = s + (r0 + g) * ss + k0 + 2 * t;
    a.r[0] = ld32(p);
    a.r[1] = ld32(p + 8 * ss);
    a.r[2] = ld32(p + 8);
    a.r[3] = ld32(p + 8 * ss + 8);
  }
  // b0 (2t..2t+1, g), b1 (2t+8..2t+9, g)
  static __device__ __forceinline__ void load_bt(B& b, const bf16* s, int ss, int n0, int k0,
                                                 int g, int t) {
    const bf16* p = s + (n0 + g) * ss + k0 + 2 * t;
    b.r[0] = ld32(p);
    b.r[1] = ld32(p + 8);
  }
  static __device__ __forceinline__ void load_b(B& b, const bf16* s, int ss, int k0, int n0,
                                                int g, int t) {
    const bf16* p = s + (k0 + 2 * t) * ss + n0 + g;
    b.r[0] = pair(p, p + ss);
    b.r[1] = pair(p + 8 * ss, p + 9 * ss);
  }
  // two accumulator tiles (16 x 16) as an A operand, rounded to bf16
  static __device__ __forceinline__ void from_acc(A& a, const float (*c)[4]) {
    a.r[0] = pack_bf16(c[0][0], c[0][1]);
    a.r[1] = pack_bf16(c[0][2], c[0][3]);
    a.r[2] = pack_bf16(c[1][0], c[1][1]);
    a.r[3] = pack_bf16(c[1][2], c[1][3]);
  }
  static constexpr bool kSmall = false;   // one product: no small terms
  static __device__ __forceinline__ void mma(float (&c)[4], float (&)[4], const A& a,
                                             const B& b) {
    mma_bf16(c, a.r[0], a.r[1], a.r[2], a.r[3], b.r[0], b.r[1]);
  }
};

// Ops<float> splitting its operands by split_tf32_finite: the same parts
// for finite operands, in fewer instructions
struct OpsFinite : Ops<float> {
  static __device__ __forceinline__ void load_a(A& a, const float* s, int ss, int r0, int k0,
                                                int g, int t) {
    const float* p = s + (r0 + g) * ss + k0 + t;
    split_tf32_finite(p[0], a.h[0], a.l[0]);
    split_tf32_finite(p[8 * ss], a.h[1], a.l[1]);
    split_tf32_finite(p[4], a.h[2], a.l[2]);
    split_tf32_finite(p[8 * ss + 4], a.h[3], a.l[3]);
  }
  static __device__ __forceinline__ void load_bt(B& b, const float* s, int ss, int n0, int k0,
                                                 int g, int t) {
    const float* p = s + (n0 + g) * ss + k0 + t;
    split_tf32_finite(p[0], b.h[0], b.l[0]);
    split_tf32_finite(p[4], b.h[1], b.l[1]);
  }
};

// ---------------------------------------------------------------------------
// Staging
// ---------------------------------------------------------------------------

__device__ __forceinline__ float scaled(float x, float s) { return x * s; }
__device__ __forceinline__ bf16 scaled(bf16 x, float s) {
  return __float2bfloat16_rn(__bfloat162float(x) * s);
}

template <typename T>
__device__ __forceinline__ T zero_of() {
  if constexpr (sizeof(T) == 4) {
    return T(0.f);
  } else {
    return __float2bfloat16_rn(0.f);
  }
}

// rows [0, n) of src (row stride ld), columns [c0, c0 + DH) of them, into
// the ROWS x DH tile dst (row stride SS) by a block of NTHR threads; zeros
// in rows [n, ROWS) and at columns >= ld
template <typename T, int DH, int ROWS, int SS, int NTHR>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int n, int ld, int c0,
                                           int tid) {
  constexpr int V = 16 / sizeof(T), C = DH / V;
  for (int i = tid; i < ROWS * C; i += NTHR) {
    const int r = i / C, c = (i % C) * V, col = c0 + c;
    T* d = dst + r * SS + c;
    if (ld % V == 0) {
      const bool on = r < n && col < ld;
      cp_async16(d, src + (on ? (size_t)r * ld + col : 0), on ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        d[e] = r < n && col + e < ld ? src[(size_t)r * ld + col + e] : zero_of<T>();
    }
  }
}

// a tile staged by stage_tile, scaled in place by the threads that staged
// each part (after their copies completed, before the barrier that
// publishes the tile)
template <typename T, int DH, int ROWS, int SS, int NTHR>
__device__ __forceinline__ void scale_tile(T* tile, float s, int tid) {
  constexpr int V = 16 / sizeof(T), C = DH / V;
  for (int i = tid; i < ROWS * C; i += NTHR) {
    T* d = tile + (i / C) * SS + (i % C) * V;
#pragma unroll
    for (int e = 0; e < V; ++e) d[e] = scaled(d[e], s);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
}

// c[N] += small[N] (the small terms' accumulator, where the products have one)
template <typename T, int N>
__device__ __forceinline__ void add_small(float (&c)[N][4], const float (&small)[N][4]) {
  if constexpr (Ops<T>::kSmall) {
#pragma unroll
    for (int nt = 0; nt < N; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[nt][i] += small[nt][i];
  }
}

// c[nt] += A (16 rows from r0 of tile a) times the tile b's rows [8 nt,
// 8 nt + 8) transposed, over the DH columns of both.  Under split-TF32 each
// 32 columns are summed in accumulators of their own (hi hi, and the small
// terms) and then added to c in fp32, rounded to nearest: a sum truncated
// over all of Dh drifts toward zero (modelled in
// tests/test_torch_attention.py::test_split_tf32_product_error)
template <typename T, int DH, int SS, int N, typename M = Ops<T>>
__device__ __forceinline__ void product_bt(float (&c)[N][4], const T* a, int r0, const T* b,
                                           int g, int t) {
  constexpr int kGroup = M::kSmall && DH > 32 ? 32 : DH;   // columns summed apart
#pragma unroll
  for (int k0 = 0; k0 < DH; k0 += kGroup) {
    float part[N][4], small[N][4];
    zero(part);
    zero(small);
#pragma unroll
    for (int kk = k0; kk < k0 + kGroup; kk += M::kK) {
      typename M::A fa;
      M::load_a(fa, a, SS, r0, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < N; ++nt) {
        typename M::B fb;
        M::load_bt(fb, b, SS, nt * 8, kk, g, t);
        M::mma(part[nt], small[nt], fa, fb);
      }
    }
    add_small<T>(part, small);
#pragma unroll
    for (int nt = 0; nt < N; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[nt][i] += part[nt][i];
  }
}

}  // namespace tc
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
