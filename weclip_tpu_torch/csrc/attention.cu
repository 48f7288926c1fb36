// Self-attention forward with the head-mean map (K1) under the fp32 score
// type, for sm_90a.  Plain C entry point, loaded with ctypes by
// weclip_tpu_torch/kernels.py; wrapper in ops/attention_kernels.py.  Under
// bf16, K1 is flash_attention.cu's key-tiled forward with row statistics
// plus its map kernel; this fp32 kernel serves the fp32 policy's parity
// checks only.
//
// Replaces (weclip_tpu/ops/pallas_attention.py), under fp32:
//   K1  attention_core_pallas(export_weights=True)   (_attn_kernel; :195, pallas_call :260)
//
// Numerics follow the Pallas kernel: q scaled in fp32, fp32 scores and
// softmax, additive -1e30 key bias, all-masked row guard max(smax, -5e29),
// denominator >= 1e-30; both products are fp32 FMA loops on the CUDA
// cores, which keeps fp32 parity with the plain version.
//
// What bounds it on the H100: operations.  At (8, 12, 1025, 64) it does
// 4*B*H*L^2*Dh = 25.8 GFLOP of FMA (0.39 ms at the 67 TFLOP/s fp32 peak),
// every operand read from shared memory.  Design: one block per (image, 16
// query rows) loops over all heads and keeps those rows' whole fp32 score
// and map rows in shared memory, so the head sum of the map is written
// once, deterministically, without atomics.  The whole rows bound L to
// what one block's shared memory holds (about 1650 at Dh 64): a longer L
// is refused at launch, and the wrapper raises.

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

size_t fwd_smem_bytes(int L, int dh) {
  return sizeof(float) * ((size_t)kTQ * dh + (size_t)kTK * (dh + 1) + 2 * (size_t)kTQ * L);
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
cudaError_t launch_fwd(const float* q, const float* k, const float* v, const float* kbias,
                       float* out, float* map, int B, int H, int L, float scale,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(L, DH);
  auto kern = attn_fwd_kernel<DH>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((L + kTQ - 1) / kTQ, B), kThreads, smem, stream>>>(q, k, v, kbias, out, map, H,
                                                                  L, scale);
  return cudaGetLastError();
}

}  // namespace

// K1 under fp32: q (unscaled), k, v (B, H, L, Dh) fp32; kbias (B, L)
// fp32; out (B, H, L, Dh) fp32 and the head-mean map (B, L, L) fp32
extern "C" int attn_fwd(const void* q, const void* k, const void* v, const void* kbias,
                        void* out, void* map, int B, int H, int L, int Dh, float scale,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto c = [](const void* p) { return static_cast<const float*>(p); };
  const auto m = [](void* p) { return static_cast<float*>(p); };
  if (Dh == 64) return launch_fwd<64>(c(q), c(k), c(v), c(kbias), m(out), m(map), B, H, L, scale, s);
  if (Dh == 32) return launch_fwd<32>(c(q), c(k), c(v), c(kbias), m(out), m(map), B, H, L, scale, s);
  return cudaErrorInvalidValue;
}
