// The head-mean attention map of K1 under the fp32 score type, and under
// bf16 above head width 128, for sm_90a (FMA loops on the CUDA cores).
// Plain C entry points, loaded with ctypes by weclip_tpu_torch/kernels.py;
// wrapper in ops/attention_kernels.py.  K1 under fp32 is two launches:
// cross_attention.cu's key-tiled forward, which writes each row's (max,
// 1/sum), then this map kernel.  Under bf16 K1 is flash_attention.cu's
// forward with row statistics plus its map kernel up to Dh 128, and
// cross_attention.cu's forward plus this map kernel above.
//
// Replaces (weclip_tpu/ops/pallas_attention.py), under fp32:
//   K1  attention_core_pallas(export_weights=True)   (_attn_kernel; :195, pallas_call :260)
//
// Numerics follow the Pallas kernel: q scaled as it is staged (x * scale in
// fp32; bf16(float(x) * scale) under bf16, as the forward stages it), fp32
// scores (one FMA chain over Dh in order; the forward takes its scores as
// split-TF32 (fp32) or bf16 tensor-core products, so a score here differs
// from the forward's by their rounding, about 2^-21 of |q| |k| under fp32),
// an additive -1e30 key bias, and P = exp(s - max) * (1/sum) from the
// forward's final row statistics.
//
// What bounds it on the H100: operations.  At (8, 12, 1025, 64) it
// recomputes S, 2*B*H*L^2*Dh = 12.9 GFLOP of FMA (0.19 ms at the 67 TFLOP/s
// fp32 peak), and writes the (B, L, L) map (34 MB, 10 us).  Design: one
// block of 256 threads per (image, 16 query rows, 64 keys) loops over the
// heads in order, staging each head's 16 scaled q rows and 64 keys in
// shared memory; a thread keeps the head sum of 4 rows of one key in
// registers and stores it once: any L, deterministic, no atomics.  (The
// TPU kernel summed the map in an output block revisited across a
// sequential head axis.)  A head width Dh between the compiled ones (16,
// 32, 64, 128) runs the next one up with zeros in the lanes past Dh; above
// 128 the 128 instance sums each score over the row's 128-column chunks in
// turn, in the same thread, so the sum's order is fixed.

#include "common.cuh"

using namespace weclip;

namespace {

using bf = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kTQ = 16;                                 // query rows per block
constexpr int kTK = 64;                                 // keys per block
constexpr int kRowsPerThread = kTQ / (kThreads / kTK);  // 4

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(bf x) { return __bfloat162float(x); }
// q scaled as the forward stages it
__device__ __forceinline__ float scaled(float x, float s) { return x * s; }
__device__ __forceinline__ float scaled(bf x, float s) {
  return __bfloat162float(__float2bfloat16_rn(__bfloat162float(x) * s));
}

template <typename T, int DH, bool PAD>
__global__ void __launch_bounds__(kThreads)
attn_map_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const float* __restrict__ kbias, const float* __restrict__ stats,
                    float* __restrict__ map, int H, int L, int ld, float scale) {
  __shared__ float q_s[kTQ][DH];       // read as broadcasts
  __shared__ float k_s[kTK][DH + 1];   // one key a thread: conflict-free columns
  __shared__ float st_s[kTQ][2];
  const int rw = PAD ? ld : DH;   // the row width in global memory
  const int b = blockIdx.z, q0 = blockIdx.y * kTQ, j0 = blockIdx.x * kTK;
  const int nq = min(kTQ, L - q0), nk = min(kTK, L - j0);
  const int tid = threadIdx.x, jj = tid % kTK, rg = (tid / kTK) * kRowsPerThread;
  // the bias is padded with -1e30 to whole 64-key tiles
  const float bj = kbias[(size_t)b * ((L + kTK - 1) / kTK * kTK) + j0 + jj];

  float acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;
  for (int h = 0; h < H; ++h) {
    const size_t base = ((size_t)b * H + h) * L;
    float s[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) s[r] = 0.f;
    // the row's chunks of DH columns (one below Dh 128)
    for (int c0 = 0; c0 < rw; c0 += DH) {
      __syncthreads();   // the last chunk's tiles are read
      for (int i = tid; i < kTQ * DH; i += kThreads) {
        const int r = i / DH, d = i % DH;
        q_s[r][d] = r < nq && c0 + d < rw ? scaled(q[(base + q0 + r) * rw + c0 + d], scale) : 0.f;
      }
      for (int i = tid; i < kTK * DH; i += kThreads) {
        const int j = i / DH, d = i % DH;
        k_s[j][d] = j < nk && c0 + d < rw ? as_float(k[(base + j0 + j) * rw + c0 + d]) : 0.f;
      }
      // rows past L get zero statistics (their map entries are not stored)
      if (c0 == 0 && tid < kTQ * 2)
        st_s[tid / 2][tid % 2] = tid / 2 < nq ? stats[(base + q0) * 2 + tid] : 0.f;
      __syncthreads();
#pragma unroll 16
      for (int d = 0; d < DH; ++d) {
        const float kd = k_s[jj][d];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) s[r] = fmaf(q_s[rg + r][d], kd, s[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
      acc[r] += expf((s[r] + bj) - st_s[rg + r][0]) * st_s[rg + r][1];
  }
  if (jj >= nk) return;
  const float inv_h = 1.f / (float)H;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
    if (rg + r < nq) map[((size_t)b * L + q0 + rg + r) * L + j0 + jj] = acc[r] * inv_h;
}

template <typename T, int DH, bool PAD>
cudaError_t launch_map(const T* q, const T* k, const float* kbias, const float* stats,
                       float* map, int B, int H, int L, int ld, float scale, cudaStream_t s) {
  attn_map_fma_kernel<T, DH, PAD><<<dim3((L + kTK - 1) / kTK, (L + kTQ - 1) / kTQ, B), kThreads,
                                    0, s>>>(q, k, kbias, stats, map, H, L, ld, scale);
  return cudaGetLastError();
}

}  // namespace

// K1's map under fp32: q (unscaled: scaled by `scale` as the forward
// staged it), k (B, H, L, Dh) fp32, any L and any Dh >= 1; kbias (B, L
// rounded up to 64) fp32, -1e30 in the padding; stats (B, H, L, 2) from
// cross_attention.cu's xattn_fwd; map (B, L, L) fp32, the mean over heads
// of P
extern "C" int attn_map_f32(const void* q, const void* k, const void* kbias, const void* stats,
                            void* map, int B, int H, int L, int Dh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto c = [](const void* p) { return static_cast<const float*>(p); };
  float* m = static_cast<float*>(map);
  if (Dh > 128) return launch_map<float, 128, true>(c(q), c(k), c(kbias), c(stats), m, B, H, L, Dh, scale, s);
#define F(DH, PAD) launch_map<float, DH, PAD>(c(q), c(k), c(kbias), c(stats), m, B, H, L, Dh, scale, s)
  WECLIP_DISPATCH_DH(Dh, F);
#undef F
}

// K1's map under bf16 above Dh 128: q (unscaled: taken as bf16(float(q) *
// scale)), k bf16; the rest as attn_map_f32, stats from cross_attention.cu's
// xattn_fwd_bf16
extern "C" int attn_map_bf16(const void* q, const void* k, const void* kbias, const void* stats,
                             void* map, int B, int H, int L, int Dh, float scale, void* stream) {
  if (Dh <= 128) return cudaErrorInvalidValue;   // flash_attention.cu's attn_map
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const bf* qb = static_cast<const bf*>(q);
  const bf* kb = static_cast<const bf*>(k);
  return launch_map<bf, 128, true>(qb, kb, f(kbias), f(stats), static_cast<float*>(map), B, H,
                                   L, Dh, scale, s);
}
