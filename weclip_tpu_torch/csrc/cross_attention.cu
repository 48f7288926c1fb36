// The fp32 attention kernels (FMA loops on the CUDA cores), for sm_90a:
// the forward for any (Lq, Lk) (K6, and K2, under fp32) and the backward
// for any (Lq, Lk) (K3 and K3-rect under fp32).  Plain C entry points,
// loaded with ctypes by weclip_tpu_torch/kernels.py; wrappers in
// ops/attention_kernels.py.  They serve the fp32 policy's parity checks;
// under bf16, K6 is hopper_attention.cu's wgmma kernel and K2, K3 and
// K3-rect are flash_attention.cu's.
//
// Replaces (weclip_tpu/ops/pallas_attention.py), under the fp32 score type:
//   K6             cross_attention_core_pallas   (_attn_kernel, no export; :539, pallas_call :582)
//   K2             attention_core_pallas(export_weights=False) (the eval decoder; :195,
//                  pallas_call :260)
//   K3, K3-rect    attention_bwd_pallas (_attn_bwd_kernel; :395, pallas_call :441)
//
// Numerics follow the Pallas kernels: q arrives pre-scaled, fp32 scores and
// softmax, additive -1e30 key bias, all-masked row guard max(smax, -5e29),
// denominator >= 1e-30; the forward normalizes after the value product and
// returns fp32; the backward recomputes the softmax (the forward saves no
// row statistics), takes delta = rowsum(P * dP) as the plain version does,
// and returns fp32 dq, dk, dv.
//
// Design: one query row (or key) per thread, the other side staged in
// shared memory tile by tile, scores in registers, so any length runs.
// The forward makes one sweep with online softmax, its accumulator
// rescaled when a tile raises the row max.  The backward's dQ kernel makes
// four sweeps (max; sum; P, dP and delta; dS and dQ = dS K) and writes each
// row's (max, 1/sum, delta); a second kernel per key tile loops over all
// query rows to sum dK and dV from those statistics.  Deterministic, no
// atomics.
//
// What bounds them on the H100: operations.  The forward at the decoder's
// (16, 8, 1024, 32) does 17 GFLOP of FMA (0.26 ms at the 67 TFLOP/s fp32
// peak), every operand read from shared memory: operations, and
// shared-memory bandwidth beside them.

#include <math_constants.h>

#include "common.cuh"

using namespace weclip;

namespace {

constexpr int kF32Rows = 64;            // query rows (or keys) per FMA block, one per thread
constexpr int kF32Keys = 16;            // keys (or query rows) per staged tile there
constexpr int kF32FwdKeys = 32;         // keys per staged tile of the FMA forward
constexpr float kMasked = -1e30f;       // bias of a masked key, and of keys past Lk

// key biases [0, n) of a staged tile, kMasked for the rest
template <int NT>
__device__ __forceinline__ void stage_bias(float* dst, const float* src, int n, int tid,
                                           int nthreads) {
  for (int i = tid; i < NT; i += nthreads) dst[i] = i < n ? src[i] : kMasked;
}

// ---------------------------------------------------------------------------
// K6 and K2, fp32: one thread per query row, q in registers, K and V staged
// 32 keys at a time (read by every thread at once: shared-memory
// broadcasts); one sweep with online softmax
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(kF32Rows)
xattn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ kbias,
                     float* __restrict__ out, int H, int Lq, int Lk) {
  __shared__ float q_s[kF32Rows][DH + 1];
  __shared__ float k_s[kF32FwdKeys][DH], v_s[kF32FwdKeys][DH];
  __shared__ float b_s[kF32FwdKeys];

  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * kF32Rows, tid = threadIdx.x;
  const float* kb = k + (size_t)bh * Lk * DH;
  const float* vb = v + (size_t)bh * Lk * DH;
  const float* bias = kbias + (size_t)b * Lk;

  for (int i = tid; i < kF32Rows * DH; i += kF32Rows) {
    const int r = i / DH;
    q_s[r][i % DH] = q0 + r < Lq ? q[((size_t)bh * Lq + q0) * DH + i] : 0.f;
  }
  __syncthreads();
  float qr[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = q_s[tid][d];
    acc[d] = 0.f;
  }
  // the running max starts at the all-masked row guard
  float m = -5e29f, l = 0.f;
  for (int j0 = 0; j0 < Lk; j0 += kF32FwdKeys) {
    const int nk = min(kF32FwdKeys, Lk - j0);
    __syncthreads();
    for (int i = tid; i < kF32FwdKeys * DH; i += kF32Rows) {
      const bool in = i / DH < nk;
      k_s[i / DH][i % DH] = in ? kb[(size_t)j0 * DH + i] : 0.f;
      v_s[i / DH][i % DH] = in ? vb[(size_t)j0 * DH + i] : 0.f;
    }
    stage_bias<kF32FwdKeys>(b_s, bias + j0, nk, tid, kF32Rows);
    __syncthreads();
    float sc[kF32FwdKeys];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kF32FwdKeys; ++j) {
      float x = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) x = fmaf(qr[d], k_s[j][d], x);
      sc[j] = x + b_s[j];
      mx = fmaxf(mx, sc[j]);
    }
    const float a = expf(m - mx);   // 1 while the max holds
    m = mx;
    l *= a;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= a;
#pragma unroll
    for (int j = 0; j < kF32FwdKeys; ++j) {
      const float e = expf(sc[j] - m);
      l += e;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(e, v_s[j][d], acc[d]);
    }
  }
  if (q0 + tid < Lq) {
    const float r = 1.f / fmaxf(l, 1e-30f);
    float* dst = out + ((size_t)bh * Lq + q0 + tid) * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) dst[d] = acc[d] * r;
  }
}

// ---------------------------------------------------------------------------
// K3-rect, fp32 (the fp32 policy): dQ and the row statistics with one
// thread per query row, then dK/dV with one thread per key
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(kF32Rows)
xattn_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ kbias, float* __restrict__ dq,
                        float* __restrict__ stats, int H, int Lq, int Lk) {
  __shared__ float q_s[kF32Rows][DH + 1], do_s[kF32Rows][DH + 1];
  __shared__ float k_s[kF32Keys][DH], v_s[kF32Keys][DH];
  __shared__ float b_s[kF32Keys];

  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * kF32Rows, tid = threadIdx.x;
  const float* kb = k + (size_t)bh * Lk * DH;
  const float* vb = v + (size_t)bh * Lk * DH;
  const float* bias = kbias + (size_t)b * Lk;
  const size_t row0 = (size_t)bh * Lq + q0;

  for (int i = tid; i < kF32Rows * DH; i += kF32Rows) {
    const bool in = q0 + i / DH < Lq;
    q_s[i / DH][i % DH] = in ? q[row0 * DH + i] : 0.f;
    do_s[i / DH][i % DH] = in ? dout[row0 * DH + i] : 0.f;
  }
  const float* qr = q_s[tid];
  const float* dr = do_s[tid];

  float m = -CUDART_INF_F, l = 0.f, rc = 0.f, delta = 0.f, acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  // sweep 0: max; 1: sum; 2: delta = rowsum(P dP); 3: dS and dQ = dS K
  for (int sweep = 0; sweep < 4; ++sweep) {
    const bool want_dp = sweep >= 2;
    for (int j0 = 0; j0 < Lk; j0 += kF32Keys) {
      const int nk = min(kF32Keys, Lk - j0);
      __syncthreads();
      for (int i = tid; i < kF32Keys * DH; i += kF32Rows) {
        const bool in = i / DH < nk;
        k_s[i / DH][i % DH] = in ? kb[(size_t)j0 * DH + i] : 0.f;
        if (want_dp) v_s[i / DH][i % DH] = in ? vb[(size_t)j0 * DH + i] : 0.f;
      }
      stage_bias<kF32Keys>(b_s, bias + j0, nk, tid, kF32Rows);
      __syncthreads();
      for (int j = 0; j < kF32Keys; ++j) {
        float s = b_s[j], sd = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) sd = fmaf(qr[d], k_s[j][d], sd);
        s += sd;
        if (sweep == 0) {
          m = fmaxf(m, s);
          continue;
        }
        if (sweep == 1) {
          l += expf(s - m);
          continue;
        }
        float dp = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) dp = fmaf(dr[d], v_s[j][d], dp);
        const float p = expf(s - m) * rc;
        if (sweep == 2) {
          delta = fmaf(p, dp, delta);
          continue;
        }
        const float ds = p * (dp - delta);
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] = fmaf(ds, k_s[j][d], acc[d]);
      }
    }
    if (sweep == 0) m = fmaxf(m, -5e29f);
    if (sweep == 1) rc = 1.f / fmaxf(l, 1e-30f);
  }
  if (q0 + tid < Lq) {
    float* dst = dq + (row0 + tid) * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) dst[d] = acc[d];
    float* st = stats + (row0 + tid) * 3;
    st[0] = m;
    st[1] = rc;
    st[2] = delta;
  }
}

template <int DH>
__global__ void __launch_bounds__(kF32Rows)
xattn_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ kbias, const float* __restrict__ stats,
                          float* __restrict__ dk, float* __restrict__ dv, int H, int Lq,
                          int Lk) {
  __shared__ float k_s[kF32Rows][DH + 1], v_s[kF32Rows][DH + 1];
  __shared__ float q_s[kF32Keys][DH], do_s[kF32Keys][DH];
  __shared__ float st_s[kF32Keys][3];

  const int bh = blockIdx.y, b = bh / H;
  const int j0 = blockIdx.x * kF32Rows, tid = threadIdx.x;
  const size_t qbase = (size_t)bh * Lq, kbase = (size_t)bh * Lk + j0;

  for (int i = tid; i < kF32Rows * DH; i += kF32Rows) {
    const bool in = j0 + i / DH < Lk;
    k_s[i / DH][i % DH] = in ? k[kbase * DH + i] : 0.f;
    v_s[i / DH][i % DH] = in ? v[kbase * DH + i] : 0.f;
  }
  const float bj = j0 + tid < Lk ? kbias[(size_t)b * Lk + j0 + tid] : kMasked;
  const float* kr = k_s[tid];
  const float* vr = v_s[tid];
  float acc_k[DH], acc_v[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc_k[d] = acc_v[d] = 0.f;

  for (int i0 = 0; i0 < Lq; i0 += kF32Keys) {
    const int ni = min(kF32Keys, Lq - i0);
    __syncthreads();
    for (int i = tid; i < kF32Keys * DH; i += kF32Rows) {
      const bool in = i / DH < ni;
      q_s[i / DH][i % DH] = in ? q[(qbase + i0) * DH + i] : 0.f;
      do_s[i / DH][i % DH] = in ? dout[(qbase + i0) * DH + i] : 0.f;
    }
    for (int i = tid; i < kF32Keys * 3; i += kF32Rows)
      st_s[i / 3][i % 3] = i / 3 < ni ? stats[(qbase + i0) * 3 + i] : 0.f;
    __syncthreads();
    for (int i = 0; i < kF32Keys; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        s = fmaf(kr[d], q_s[i][d], s);
        dp = fmaf(vr[d], do_s[i][d], dp);
      }
      // rows past Lq: zero q, 1/sum = 0, so P and dS are 0
      const float p = expf(s + bj - st_s[i][0]) * st_s[i][1];
      const float ds = p * (dp - st_s[i][2]);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        acc_k[d] = fmaf(ds, q_s[i][d], acc_k[d]);
        acc_v[d] = fmaf(p, do_s[i][d], acc_v[d]);
      }
    }
  }
  if (j0 + tid < Lk) {
    float* dkr = dk + (kbase + tid) * DH;
    float* dvr = dv + (kbase + tid) * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      dkr[d] = acc_k[d];
      dvr[d] = acc_v[d];
    }
  }
}

template <int DH>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, const float* kbias,
                       float* out, int B, int H, int Lq, int Lk, cudaStream_t s) {
  xattn_fwd_f32_kernel<DH><<<dim3((Lq + kF32Rows - 1) / kF32Rows, B * H), kF32Rows, 0, s>>>(
      q, k, v, kbias, out, H, Lq, Lk);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* dout,
                       const float* kbias, float* dq, float* dk, float* dv, float* stats,
                       int B, int H, int Lq, int Lk, cudaStream_t s) {
  xattn_bwd_dq_f32_kernel<DH><<<dim3((Lq + kF32Rows - 1) / kF32Rows, B * H), kF32Rows, 0, s>>>(
      q, k, v, dout, kbias, dq, stats, H, Lq, Lk);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  xattn_bwd_dkdv_f32_kernel<DH><<<dim3((Lk + kF32Rows - 1) / kF32Rows, B * H), kF32Rows, 0, s>>>(
      q, k, v, dout, kbias, stats, dk, dv, H, Lq, Lk);
  return cudaGetLastError();
}

}  // namespace

// K6 and K2 under fp32: q (pre-scaled), k, v fp32; kbias (B, Lk) fp32;
// out (B, H, Lq, Dh) fp32
extern "C" int xattn_fwd(const void* q, const void* k, const void* v, const void* kbias,
                         void* out, int B, int H, int Lq, int Lk, int Dh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* o = static_cast<float*>(out);
  if (Dh == 64) return launch_fwd<64>(f(q), f(k), f(v), f(kbias), o, B, H, Lq, Lk, s);
  if (Dh == 32) return launch_fwd<32>(f(q), f(k), f(v), f(kbias), o, B, H, Lq, Lk, s);
  return cudaErrorInvalidValue;
}

// K3 and K3-rect under fp32, any (Lq, Lk): fp32 q (pre-scaled), k, v,
// dout; fp32 dq, dk, dv and the (B, H, Lq, 3) row statistics (max, 1/sum,
// delta)
extern "C" int xattn_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const void* kbias, void* dq, void* dk, void* dv, void* stats,
                         int B, int H, int Lq, int Lk, int Dh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto m = [](void* p) { return static_cast<float*>(p); };
  if (Dh == 64)
    return launch_bwd<64>(f(q), f(k), f(v), f(dout), f(kbias), m(dq), m(dk), m(dv),
                          m(stats), B, H, Lq, Lk, s);
  if (Dh == 32)
    return launch_bwd<32>(f(q), f(k), f(v), f(dout), f(kbias), m(dq), m(dk), m(dv),
                          m(stats), B, H, Lq, Lk, s);
  return cudaErrorInvalidValue;
}
