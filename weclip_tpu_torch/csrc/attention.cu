// Self-attention forward with the head-mean map (K1), for sm_90a.  Plain C
// entry point, loaded with ctypes by weclip_tpu_torch/kernels.py; wrapper
// in ops/attention_kernels.py.  The forward without the map (K2) and the
// backward (K3) are the key-tiled kernels of flash_attention.cu.
//
// Replaces (weclip_tpu/ops/pallas_attention.py):
//   K1  attention_core_pallas(export_weights=True)   (_attn_kernel; :195, pallas_call :260)
//
// Numerics follow the Pallas kernel: q scaled in fp32 then rounded to the
// score type, fp32 scores and softmax, additive -1e30 key bias, all-masked
// row guard max(smax, -5e29), denominator >= 1e-30; under bf16 the matmul
// operands (q, P) are rounded to bf16 and both products accumulate in fp32.
//
// What bounds it on the H100: at the eval shapes (B=8, H=12, L=1025,
// Dh=64) it does 4*B*H*L^2*Dh = 25.8 GFLOP of products (26 us at the bf16
// tensor-core peak) and must write the (B, L, L) fp32 map (34 MB, 10 us at
// 3.35 TB/s): operations bound it.  Under bf16 it runs its two products on
// the tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate);
// under fp32 it runs fp32 FMA loops on the CUDA cores (67 TFLOP/s peak),
// which keeps fp32 parity with the plain version.  What the design keeps
// out of device memory: the (L, L) score rows of one query tile live in
// shared memory; the head sum of the map is kept in shared memory by a
// block that owns its query rows and loops over all heads itself, so the
// map is written once, without atomics, deterministically (the TPU kernel
// summed it in an output block revisited across a sequential head axis,
// which Hopper's unordered blocks cannot do).  The whole-row buffers bound
// L to what one block's shared memory holds (about 1500 under bf16).

#include <math_constants.h>

#include "common.cuh"

using namespace weclip;

namespace {

constexpr int kThreads = 256;
constexpr int kTQ = 16;   // query rows per block
constexpr int kTK = 64;   // keys per staged K or V tile

// fp32 forward on the CUDA cores (the fp32 policy)
template <int DH>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ kbias,
                float* __restrict__ out, float* __restrict__ map,
                int H, int L, float scale) {
  constexpr int kRows = kTQ / (kThreads / kTK);       // score rows per thread
  constexpr int kRpt = kTQ * DH / kThreads;           // PV rows per thread
  extern __shared__ float smem[];
  float* q_s = smem;                                  // [kTQ][DH]
  float* kv_s = q_s + kTQ * DH;                       // [kTK][DH + 1]
  float* s_s = kv_s + kTK * (DH + 1);                 // [kTQ][L]
  float* m_s = s_s + kTQ * L;                         // [kTQ][L]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTQ;
  const int nq = min(kTQ, L - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* bias = kbias + (size_t)b * L;

  for (int h = 0; h < H; ++h) {
    const size_t base = ((size_t)b * H + h) * L;
    for (int i = tid; i < kTQ * DH; i += kThreads) {
      const int r = i / DH;
      q_s[i] = r < nq ? q[(base + q0 + r) * DH + (i % DH)] * scale : 0.f;
    }
    // S = q K^T + bias over staged K tiles
    const int jj = tid % kTK, rg = (tid / kTK) * kRows;
    for (int j0 = 0; j0 < L; j0 += kTK) {
      const int nk = min(kTK, L - j0);
      __syncthreads();
      for (int i = tid; i < kTK * DH; i += kThreads) {
        const int j = i / DH, d = i % DH;
        kv_s[j * (DH + 1) + d] = j < nk ? k[(base + j0 + j) * DH + d] : 0.f;
      }
      __syncthreads();
      if (jj < nk) {
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 16
        for (int d = 0; d < DH; ++d) {
          const float kd = kv_s[jj * (DH + 1) + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r] = fmaf(q_s[(rg + r) * DH + d], kd, acc[r]);
        }
        const float bj = bias[j0 + jj];
#pragma unroll
        for (int r = 0; r < kRows; ++r) s_s[(rg + r) * L + j0 + jj] = acc[r] + bj;
      }
    }
    __syncthreads();
    // fp32 row softmax, one warp per row; the map's head sum beside it
    for (int r = warp; r < kTQ; r += kThreads / 32) {
      float* srow = s_s + (size_t)r * L;
      float mx = -CUDART_INF_F;
      for (int j = lane; j < L; j += 32) mx = fmaxf(mx, srow[j]);
      mx = fmaxf(warp_max(mx), -5e29f);
      float sum = 0.f;
      for (int j = lane; j < L; j += 32) {
        const float e = expf(srow[j] - mx);
        srow[j] = e;
        sum += e;
      }
      const float recip = 1.f / fmaxf(warp_sum(sum), 1e-30f);
      float* mrow = m_s + (size_t)r * L;
      for (int j = lane; j < L; j += 32) {
        const float a = srow[j] * recip;
        mrow[j] = h == 0 ? a : mrow[j] + a;
        srow[j] = a;
      }
    }
    // out = P V over staged V tiles
    const int d = tid % DH, rb = (tid / DH) * kRpt;
    float acc[kRpt];
#pragma unroll
    for (int r = 0; r < kRpt; ++r) acc[r] = 0.f;
    for (int j0 = 0; j0 < L; j0 += kTK) {
      const int nk = min(kTK, L - j0);
      __syncthreads();
      for (int i = tid; i < kTK * DH; i += kThreads) {
        const int j = i / DH, dd = i % DH;
        kv_s[j * (DH + 1) + dd] = j < nk ? v[(base + j0 + j) * DH + dd] : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < nk; ++j) {
        const float vd = kv_s[j * (DH + 1) + d];
#pragma unroll
        for (int r = 0; r < kRpt; ++r) acc[r] = fmaf(s_s[(rb + r) * L + j0 + j], vd, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRpt; ++r) {
      if (rb + r < nq) out[(base + q0 + rb + r) * DH + d] = acc[r];
    }
    __syncthreads();
  }
  const float inv_h = 1.f / (float)H;
  for (int r = 0; r < nq; ++r) {
    float* dst = map + ((size_t)b * L + q0 + r) * L;
    const float* src = m_s + (size_t)r * L;
    for (int j = tid; j < L; j += kThreads) dst[j] = src[j] * inv_h;
  }
}

// ---------------------------------------------------------------------------
// bf16 forward on the tensor cores: mma.sync m16n8k16, fp32 accumulation.
// One block of 4 warps per (batch, 16 query rows), looping over the heads.
// K and V are staged 256 keys at a time (few block-wide round trips: with
// one or two blocks per SM, load latency is what this kernel waits on).
// S = q K^T: each warp owns 64 keys of every staged tile.  The fp32 softmax
// is the FMA kernel's.  O = P V: each warp owns Dh/32 8-wide column tiles
// of the output and walks all keys in steps of 16.
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaTK = 256;                    // keys per staged K / V tile

// rows [0, nk) of a (DH)-wide bf16 tile into shared memory (row stride
// DH + 8), zeros in rows [nk, nrows); 16-byte vectors
template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int nk,
                                          int nrows, int tid) {
  constexpr int kVec = DH / 8;
  for (int i = tid; i < nrows * kVec; i += kMmaThreads) {
    const int j = i / kVec, c = (i % kVec) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (j < nk) x = *reinterpret_cast<const uint4*>(src + (size_t)j * DH + c);
    *reinterpret_cast<uint4*>(dst + j * (DH + 8) + c) = x;
  }
}

// The score and map rows take most of an SM's shared memory (172 KB at L
// 1025), so one block per SM is what runs: the launch bound tells ptxas so,
// and it schedules the loops with the registers that frees (a third less
// time at the eval shape, the same output bit for bit; PERF.md, K1).
template <int DH>
__global__ void __launch_bounds__(kMmaThreads, 1)
attn_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ kbias, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ map, int H, int L, int sp, float scale) {
  constexpr int QS = DH + 8;                   // bf16 row stride of q / k / v tiles
  constexpr int NT = DH / 8 / kMmaWarps;       // output column tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_s = reinterpret_cast<float*>(smem_raw);           // [kTQ][sp]
  float* m_s = s_s + kTQ * sp;                                // [kTQ][sp]
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(m_s + kTQ * sp);  // [kTQ][QS]
  __nv_bfloat16* kv_s = q_s + kTQ * QS;                       // [kMmaTK][QS]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTQ;
  const int nq = min(kTQ, L - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;       // fragment row / column pair
  const float* bias = kbias + (size_t)b * L;
  const int l16 = (L + 15) & ~15;              // keys the P V product covers

  for (int h = 0; h < H; ++h) {
    const size_t base = ((size_t)b * H + h) * L;
    for (int i = tid; i < kTQ * DH; i += kMmaThreads) {
      const int r = i / DH, d = i % DH;
      const float x = r < nq ? __bfloat162float(q[(base + q0 + r) * DH + d]) * scale : 0.f;
      q_s[r * QS + d] = __float2bfloat16_rn(x);
    }
    // S = q K^T + bias, over the keys [0, l16)
    for (int j0 = 0; j0 < l16; j0 += kMmaTK) {
      __syncthreads();
      load_tile<DH>(kv_s, k + (base + j0) * DH, min(kMmaTK, L - j0),
                    min(kMmaTK, l16 - j0), tid);
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < kMmaTK / kMmaWarps / 8; ++nt) {
        const int nb = warp * (kMmaTK / kMmaWarps) + nt * 8;
        if (j0 + nb >= l16) break;             // uniform across the warp
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < DH; kk += 16) {
          const __nv_bfloat16* qa = q_s + g * QS + kk + 2 * t;
          const __nv_bfloat16* kp = kv_s + (nb + g) * QS + kk + 2 * t;
          mma_bf16(c, ld_u32(qa), ld_u32(qa + 8 * QS), ld_u32(qa + 8),
                   ld_u32(qa + 8 * QS + 8), ld_u32(kp), ld_u32(kp + 8));
        }
        const int col = j0 + nb + 2 * t;
        const float b0 = col < L ? bias[col] : 0.f;
        const float b1 = col + 1 < L ? bias[col + 1] : 0.f;
        *reinterpret_cast<float2*>(s_s + g * sp + col) = make_float2(c[0] + b0, c[1] + b1);
        *reinterpret_cast<float2*>(s_s + (g + 8) * sp + col) =
            make_float2(c[2] + b0, c[3] + b1);
      }
    }
    __syncthreads();
    // fp32 row softmax, one warp per row; the map's head sum beside it
    for (int r = warp; r < kTQ; r += kMmaWarps) {
      float* srow = s_s + (size_t)r * sp;
      float mx = -CUDART_INF_F;
      for (int j = lane; j < L; j += 32) mx = fmaxf(mx, srow[j]);
      mx = fmaxf(warp_max(mx), -5e29f);
      float sum = 0.f;
      for (int j = lane; j < L; j += 32) {
        const float e = expf(srow[j] - mx);
        srow[j] = e;
        sum += e;
      }
      const float recip = 1.f / fmaxf(warp_sum(sum), 1e-30f);
      float* mrow = m_s + (size_t)r * sp;
      for (int j = lane; j < L; j += 32) {
        const float a = srow[j] * recip;
        mrow[j] = h == 0 ? a : mrow[j] + a;
        srow[j] = round_bf16(a);
      }
      for (int j = L + lane; j < l16; j += 32) srow[j] = 0.f;
    }
    // O = P V
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    for (int j0 = 0; j0 < l16; j0 += kMmaTK) {
      const int kend = min(kMmaTK, l16 - j0);
      __syncthreads();
      load_tile<DH>(kv_s, v + (base + j0) * DH, min(kMmaTK, L - j0), kend, tid);
      __syncthreads();
      for (int kb = 0; kb < kend; kb += 16) {
        const float* p0 = s_s + g * sp + j0 + kb + 2 * t;
        const float* p1 = p0 + 8 * sp;
        const uint32_t a0 = pack_bf16(p0[0], p0[1]), a1 = pack_bf16(p1[0], p1[1]);
        const uint32_t a2 = pack_bf16(p0[8], p0[9]), a3 = pack_bf16(p1[8], p1[9]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const __nv_bfloat16* vc = kv_s + (kb + 2 * t) * QS + (warp * NT + nt) * 8 + g;
          mma_bf16(acc[nt], a0, a1, a2, a3, pack_raw(vc[0], vc[QS]),
                   pack_raw(vc[8 * QS], vc[9 * QS]));
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = (warp * NT + nt) * 8 + 2 * t;
      if (g < nq)
        *reinterpret_cast<__nv_bfloat162*>(out + (base + q0 + g) * DH + col) =
            __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
      if (g + 8 < nq)
        *reinterpret_cast<__nv_bfloat162*>(out + (base + q0 + g + 8) * DH + col) =
            __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
    }
    __syncthreads();
  }
  const float inv_h = 1.f / (float)H;
  for (int r = 0; r < nq; ++r) {
    float* dst = map + ((size_t)b * L + q0 + r) * L;
    const float* src = m_s + (size_t)r * sp;
    for (int j = tid; j < L; j += kMmaThreads) dst[j] = src[j] * inv_h;
  }
}

size_t fwd_smem_bytes(int L, int dh) {
  return sizeof(float) * ((size_t)kTQ * dh + (size_t)kTK * (dh + 1) + 2 * (size_t)kTQ * L);
}

// fp32 row stride of the tensor-core kernel's score rows: L rounded up to
// whole 16-key steps, plus 4 to spread the rows over banks
int mma_row_stride(int L) { return (L + 15) / 16 * 16 + 4; }

size_t fwd_mma_smem_bytes(int L, int dh) {
  return sizeof(float) * 2 * kTQ * (size_t)mma_row_stride(L) +
         sizeof(__nv_bfloat16) * (size_t)(kTQ + kMmaTK) * (dh + 8);
}

// an L whose score rows exceed the block's shared memory fails here; the
// error is cleared so that it is not reported again by a later launch
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem) {
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

template <int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* kbias, void* out, void* map, int B, int H,
                       int L, float scale, int bf16, cudaStream_t stream) {
  const dim3 grid((L + kTQ - 1) / kTQ, B);
  if (bf16) {
    const size_t smem = fwd_mma_smem_bytes(L, DH);
    auto kern = attn_fwd_mma_kernel<DH>;
    const cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    using bf = __nv_bfloat16;
    kern<<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k),
        static_cast<const bf*>(v), static_cast<const float*>(kbias),
        static_cast<bf*>(out), static_cast<float*>(map), H, L, mma_row_stride(L),
        scale);
    return cudaGetLastError();
  }
  const size_t smem = fwd_smem_bytes(L, DH);
  auto kern = attn_fwd_kernel<DH>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(kbias),
      static_cast<float*>(out), static_cast<float*>(map), H, L, scale);
  return cudaGetLastError();
}

}  // namespace

// K1: q (unscaled), k, v (B, H, L, Dh) in the score type (bf16 if bf16,
// else fp32); kbias (B, L) fp32; out (B, H, L, Dh) in the score type and
// the head-mean map (B, L, L) fp32
extern "C" int attn_fwd(const void* q, const void* k, const void* v,
                        const void* kbias, void* out, void* map, int B, int H,
                        int L, int Dh, float scale, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 64) return launch_fwd<64>(q, k, v, kbias, out, map, B, H, L, scale, bf16, s);
  if (Dh == 32) return launch_fwd<32>(q, k, v, kbias, out, map, B, H, L, scale, bf16, s);
  return cudaErrorInvalidValue;
}
