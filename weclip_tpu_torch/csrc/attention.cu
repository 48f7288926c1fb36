// Self-attention forward (with and without the head-mean map) and the
// flash-style backward, for sm_90a.  Plain C entry points, loaded with ctypes
// by weclip_tpu_torch/kernels.py; wrappers in ops/attention_kernels.py.
//
// Replaces (weclip_tpu/ops/pallas_attention.py):
//   K1  attention_core_pallas(export_weights=True)   (_attn_kernel)
//   K2  attention_core_pallas(export_weights=False)  (_attn_kernel)
//   K3  attention_bwd_pallas                          (_attn_bwd_kernel)
//
// Numerics follow the Pallas kernels: q scaled in fp32 then rounded to the
// score type, fp32 scores and softmax, additive -1e30 key bias, all-masked
// row guard max(smax, -5e29), denominator >= 1e-30; under bf16 the matmul
// operands (q, P, dS, ...) are rounded to bf16 and every product
// accumulates in fp32.
//
// What bounds them on the H100: K1 at the eval shapes (B=8, H=12, L=1025,
// Dh=64) does 4*B*H*L^2*Dh = 25.8 GFLOP of products (26 us at the bf16
// tensor-core peak) and must write the (B, L, L) fp32 map (34 MB, 10 us at
// 3.35 TB/s): operations bound it.  Under bf16 the forward runs its two
// products on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32
// accumulate; wgmma and TMA are later work); under fp32 it runs fp32 FMA
// loops on the CUDA cores (67 TFLOP/s peak), which keeps fp32 parity with
// the plain version.  What the design keeps out of device memory: the
// (L, L) score rows of one query tile live in shared memory; the head sum
// of the map is kept in shared memory by a block that owns its query rows
// and loops over all heads itself, so the map is written once, without
// atomics, deterministically (the TPU kernel summed it in an output block
// revisited across a sequential head axis, which Hopper's unordered blocks
// cannot do).
//
// K3 is deterministic without atomics: one kernel per query tile computes
// each row's max, 1/sum and delta = rowsum(P * dP) and dQ; a second kernel
// per key tile loops over all query rows to sum dK and dV.  With the bf16
// score type both run their products on the tensor cores like the
// forward; with fp32 they are FMA loops.  Its least time at the GradCAM
// shape (B*MC = 32, H = 12, L = 1025, Dh = 64) is its 10*B*H*L^2*Dh =
// 258 GFLOP of products at the bf16 peak, 0.26 ms.

#include <math_constants.h>

#include "common.cuh"

using namespace weclip;

namespace {

constexpr int kThreads = 256;
constexpr int kTQ = 16;   // query rows per forward / dQ block
constexpr int kTK = 64;   // keys per staged K or V tile
constexpr int kBT = 32;   // keys per dK/dV block, and query rows per chunk there

// fp32 forward on the CUDA cores (the fp32 policy)
template <int DH, bool EXPORT>
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
  float* m_s = s_s + kTQ * L;                         // [kTQ][L] (EXPORT)
  __shared__ float row_scale[kTQ];

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
    // fp32 row softmax, one warp per row
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
      if (EXPORT) {
        float* mrow = m_s + (size_t)r * L;
        for (int j = lane; j < L; j += 32) {
          const float a = srow[j] * recip;
          mrow[j] = h == 0 ? a : mrow[j] + a;
          srow[j] = a;
        }
      }
      // the no-export variant normalizes after PV, like the TPU kernel
      if (lane == 0) row_scale[r] = EXPORT ? 1.f : recip;
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
      if (rb + r < nq) out[(base + q0 + rb + r) * DH + d] = acc[r] * row_scale[rb + r];
    }
    __syncthreads();
  }
  if (EXPORT) {
    const float inv_h = 1.f / (float)H;
    for (int r = 0; r < nq; ++r) {
      float* dst = map + ((size_t)b * L + q0 + r) * L;
      const float* src = m_s + (size_t)r * L;
      for (int j = tid; j < L; j += kThreads) dst[j] = src[j] * inv_h;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward on the tensor cores: mma.sync m16n8k16, fp32 accumulation.
// One block of 4 warps per (batch, 16 query rows), looping over the heads.
// K and V are staged 256 keys at a time (few block-wide round trips: with
// one or two blocks per SM, load latency is what these kernels wait on).
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

template <int DH, bool EXPORT>
__global__ void __launch_bounds__(kMmaThreads)
attn_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ kbias, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ map, int H, int L, int sp, float scale) {
  constexpr int QS = DH + 8;                   // bf16 row stride of q / k / v tiles
  constexpr int NT = DH / 8 / kMmaWarps;       // output column tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_s = reinterpret_cast<float*>(smem_raw);           // [kTQ][sp]
  float* m_s = s_s + kTQ * sp;                                // [kTQ][sp] (EXPORT)
  __nv_bfloat16* q_s =
      reinterpret_cast<__nv_bfloat16*>(s_s + (EXPORT ? 2 : 1) * kTQ * sp);  // [kTQ][QS]
  __nv_bfloat16* kv_s = q_s + kTQ * QS;                       // [kMmaTK][QS]
  __shared__ float row_scale[kTQ];

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
    // fp32 row softmax, one warp per row
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
      if (EXPORT) {
        float* mrow = m_s + (size_t)r * sp;
        for (int j = lane; j < L; j += 32) {
          const float a = srow[j] * recip;
          mrow[j] = h == 0 ? a : mrow[j] + a;
          srow[j] = round_bf16(a);
        }
      } else {
        for (int j = lane; j < L; j += 32) srow[j] = round_bf16(srow[j]);
      }
      for (int j = L + lane; j < l16; j += 32) srow[j] = 0.f;
      // the no-export variant normalizes after PV, like the TPU kernel
      if (lane == 0) row_scale[r] = EXPORT ? 1.f : recip;
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
      if (g < nq) {
        const float s = row_scale[g];
        *reinterpret_cast<__nv_bfloat162*>(out + (base + q0 + g) * DH + col) =
            __floats2bfloat162_rn(acc[nt][0] * s, acc[nt][1] * s);
      }
      if (g + 8 < nq) {
        const float s = row_scale[g + 8];
        *reinterpret_cast<__nv_bfloat162*>(out + (base + q0 + g + 8) * DH + col) =
            __floats2bfloat162_rn(acc[nt][2] * s, acc[nt][3] * s);
      }
    }
    __syncthreads();
  }
  if (EXPORT) {
    const float inv_h = 1.f / (float)H;
    for (int r = 0; r < nq; ++r) {
      float* dst = map + ((size_t)b * L + q0 + r) * L;
      const float* src = m_s + (size_t)r * sp;
      for (int j = tid; j < L; j += kMmaThreads) dst[j] = src[j] * inv_h;
    }
  }
}

// fp32 backward on the CUDA cores (the fp32 policy): dQ plus the per-row
// statistics (max, 1/sum, delta) the dK/dV pass reuses
template <int DH>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ kbias, float* __restrict__ dq,
                   float* __restrict__ stats, int H, int L) {
  constexpr int kRows = kTQ / (kThreads / kTK);
  constexpr int kRpt = kTQ * DH / kThreads;
  extern __shared__ float smem[];
  float* q_s = smem;                       // [kTQ][DH]
  float* do_s = q_s + kTQ * DH;            // [kTQ][DH]
  float* kv_s = do_s + kTQ * DH;           // [kTK][DH + 1]
  float* s_s = kv_s + kTK * (DH + 1);      // [kTQ][L]  scores, then P
  float* g_s = s_s + kTQ * L;              // [kTQ][L]  dP, then dS

  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * kTQ, nq = min(kTQ, L - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t base = (size_t)bh * L;
  const float* bias = kbias + (size_t)b * L;

  for (int i = tid; i < kTQ * DH; i += kThreads) {
    const int r = i / DH;
    const size_t at = (base + q0 + r) * DH + (i % DH);
    q_s[i] = r < nq ? q[at] : 0.f;
    do_s[i] = r < nq ? dout[at] : 0.f;
  }
  const int jj = tid % kTK, rg = (tid / kTK) * kRows;
  for (int j0 = 0; j0 < L; j0 += kTK) {
    const int nk = min(kTK, L - j0);
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {       // 0: S = q K^T, 1: dP = dO V^T
      const float* src = pass == 0 ? k : v;
      const float* lhs = pass == 0 ? q_s : do_s;
      float* dst = pass == 0 ? s_s : g_s;
      __syncthreads();
      for (int i = tid; i < kTK * DH; i += kThreads) {
        const int j = i / DH, d = i % DH;
        kv_s[j * (DH + 1) + d] = j < nk ? src[(base + j0 + j) * DH + d] : 0.f;
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
          for (int r = 0; r < kRows; ++r) acc[r] = fmaf(lhs[(rg + r) * DH + d], kd, acc[r]);
        }
        const float add = pass == 0 ? bias[j0 + jj] : 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) dst[(rg + r) * L + j0 + jj] = acc[r] + add;
      }
    }
  }
  __syncthreads();
  for (int r = warp; r < kTQ; r += kThreads / 32) {
    float* srow = s_s + (size_t)r * L;
    float* grow = g_s + (size_t)r * L;
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
    float delta = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float p = srow[j] * recip;
      srow[j] = p;
      delta = fmaf(p, grow[j], delta);
    }
    delta = warp_sum(delta);
    for (int j = lane; j < L; j += 32) grow[j] = srow[j] * (grow[j] - delta);
    if (lane == 0 && r < nq) {
      float* st = stats + (base + q0 + r) * 3;
      st[0] = mx;
      st[1] = recip;
      st[2] = delta;
    }
  }
  // dQ = dS K over staged K tiles
  const int d = tid % DH, rb = (tid / DH) * kRpt;
  float acc[kRpt];
#pragma unroll
  for (int r = 0; r < kRpt; ++r) acc[r] = 0.f;
  for (int j0 = 0; j0 < L; j0 += kTK) {
    const int nk = min(kTK, L - j0);
    __syncthreads();
    for (int i = tid; i < kTK * DH; i += kThreads) {
      const int j = i / DH, dd = i % DH;
      kv_s[j * (DH + 1) + dd] = j < nk ? k[(base + j0 + j) * DH + dd] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float kd = kv_s[j * (DH + 1) + d];
#pragma unroll
      for (int r = 0; r < kRpt; ++r) acc[r] = fmaf(g_s[(rb + r) * L + j0 + j], kd, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRpt; ++r) {
    if (rb + r < nq) dq[(base + q0 + rb + r) * DH + d] = acc[r];
  }
}

// dK = dS^T q and dV = P^T dO for one key tile, summed over all query rows
template <int DH>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ kbias, const float* __restrict__ stats,
                     float* __restrict__ dk, float* __restrict__ dv,
                     int H, int L) {
  constexpr int kJpt = kBT * DH / kThreads;   // keys per thread in the sums
  constexpr int kIpt = kBT * kBT / kThreads;  // (row, key) pairs per thread
  __shared__ float k_s[kBT][DH + 1], v_s[kBT][DH + 1];
  __shared__ float q_s[kBT][DH + 1], do_s[kBT][DH + 1];
  __shared__ float p_s[kBT][kBT + 1], ds_s[kBT][kBT + 1];
  __shared__ float st_s[kBT][3];

  const int bh = blockIdx.y, b = bh / H;
  const int j0 = blockIdx.x * kBT, nk = min(kBT, L - j0);
  const int tid = threadIdx.x;
  const size_t base = (size_t)bh * L;

  for (int i = tid; i < kBT * DH; i += kThreads) {
    const int j = i / DH, d = i % DH;
    const size_t at = (base + j0 + j) * DH + d;
    k_s[j][d] = j < nk ? k[at] : 0.f;
    v_s[j][d] = j < nk ? v[at] : 0.f;
  }
  const int pj = tid & 31, pi = (tid >> 5) * kIpt;
  const float bj = pj < nk ? kbias[(size_t)b * L + j0 + pj] : 0.f;
  const int od = tid % DH, jb = (tid / DH) * kJpt;
  float acc_k[kJpt], acc_v[kJpt];
#pragma unroll
  for (int t = 0; t < kJpt; ++t) acc_k[t] = acc_v[t] = 0.f;

  for (int i0 = 0; i0 < L; i0 += kBT) {
    const int ni = min(kBT, L - i0);
    __syncthreads();
    for (int i = tid; i < kBT * DH; i += kThreads) {
      const int r = i / DH, d = i % DH;
      const size_t at = (base + i0 + r) * DH + d;
      q_s[r][d] = r < ni ? q[at] : 0.f;
      do_s[r][d] = r < ni ? dout[at] : 0.f;
    }
    for (int i = tid; i < kBT * 3; i += kThreads) {
      const int r = i / 3;
      st_s[r][i % 3] = r < ni ? stats[(base + i0 + r) * 3 + i % 3] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kIpt; ++t) {
      const int i = pi + t;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) {
        s = fmaf(q_s[i][d], k_s[pj][d], s);
        dp = fmaf(do_s[i][d], v_s[pj][d], dp);
      }
      float p = 0.f, ds = 0.f;
      if (i < ni && pj < nk) {
        p = expf(s + bj - st_s[i][0]) * st_s[i][1];
        ds = p * (dp - st_s[i][2]);
      }
      p_s[i][pj] = p;
      ds_s[i][pj] = ds;
    }
    __syncthreads();
    for (int i = 0; i < ni; ++i) {
      const float qd = q_s[i][od], dod = do_s[i][od];
#pragma unroll
      for (int t = 0; t < kJpt; ++t) {
        acc_k[t] = fmaf(ds_s[i][jb + t], qd, acc_k[t]);
        acc_v[t] = fmaf(p_s[i][jb + t], dod, acc_v[t]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kJpt; ++t) {
    if (jb + t < nk) {
      const size_t at = (base + j0 + jb + t) * DH + od;
      dk[at] = acc_k[t];
      dv[at] = acc_v[t];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 backward on the tensor cores (mma.sync m16n8k16, fp32 accumulation).
// The fp32 inputs are rounded to bf16 as they are staged, which is the
// rounding of the bf16 score type; P and dS are rounded where they feed a
// product, as in the FMA kernels above.
// ---------------------------------------------------------------------------

// rows [0, nk) of a (DH)-wide fp32 tile into shared memory as bf16 (row
// stride DH + 8), zeros in rows [nk, nrows)
template <int DH>
__device__ __forceinline__ void load_tile_f32(__nv_bfloat16* dst, const float* src,
                                              int nk, int nrows, int tid) {
  constexpr int kVec = DH / 8;
  for (int i = tid; i < nrows * kVec; i += kMmaThreads) {
    const int j = i / kVec, c = (i % kVec) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (j < nk) {
      const float4 lo = *reinterpret_cast<const float4*>(src + (size_t)j * DH + c);
      const float4 hi = *reinterpret_cast<const float4*>(src + (size_t)j * DH + c + 4);
      x = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                     pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
    }
    *reinterpret_cast<uint4*>(dst + j * (DH + 8) + c) = x;
  }
}

// dQ plus the row statistics (max, 1/sum, delta) for 16 query rows of one
// (batch, head): S = q K^T and dP = dO V^T into shared memory, the
// statistics and dS = P (dP - delta) one warp per row, then dQ = dS K
template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
attn_bwd_dq_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ kbias, float* __restrict__ dq,
                       float* __restrict__ stats, int H, int L, int sp) {
  constexpr int QS = DH + 8;
  constexpr int NT = DH / 8 / kMmaWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_s = reinterpret_cast<float*>(smem_raw);            // [kTQ][sp] S, then P
  float* g_s = s_s + kTQ * sp;                                 // [kTQ][sp] dP, then dS
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(g_s + kTQ * sp);  // [kTQ][QS]
  __nv_bfloat16* do_s = q_s + kTQ * QS;                        // [kTQ][QS]
  __nv_bfloat16* kv_s = do_s + kTQ * QS;                       // [kMmaTK][QS]

  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * kTQ, nq = min(kTQ, L - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)bh * L;
  const float* bias = kbias + (size_t)b * L;
  const int l16 = (L + 15) & ~15;

  for (int i = tid; i < kTQ * DH; i += kMmaThreads) {
    const int r = i / DH, d = i % DH;
    const size_t at = (base + q0 + r) * DH + d;
    q_s[r * QS + d] = __float2bfloat16_rn(r < nq ? q[at] : 0.f);
    do_s[r * QS + d] = __float2bfloat16_rn(r < nq ? dout[at] : 0.f);
  }
  for (int pass = 0; pass < 2; ++pass) {       // 0: S = q K^T + bias, 1: dP = dO V^T
    const float* src = pass == 0 ? k : v;
    const __nv_bfloat16* a_s = pass == 0 ? q_s : do_s;
    float* dst = pass == 0 ? s_s : g_s;
    for (int j0 = 0; j0 < l16; j0 += kMmaTK) {
      __syncthreads();
      load_tile_f32<DH>(kv_s, src + (base + j0) * DH, min(kMmaTK, L - j0),
                        min(kMmaTK, l16 - j0), tid);
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < kMmaTK / kMmaWarps / 8; ++nt) {
        const int nb = warp * (kMmaTK / kMmaWarps) + nt * 8;
        if (j0 + nb >= l16) break;             // uniform across the warp
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < DH; kk += 16) {
          const __nv_bfloat16* ap = a_s + g * QS + kk + 2 * t;
          const __nv_bfloat16* bp = kv_s + (nb + g) * QS + kk + 2 * t;
          mma_bf16(c, ld_u32(ap), ld_u32(ap + 8 * QS), ld_u32(ap + 8),
                   ld_u32(ap + 8 * QS + 8), ld_u32(bp), ld_u32(bp + 8));
        }
        const int col = j0 + nb + 2 * t;
        float b0 = 0.f, b1 = 0.f;
        if (pass == 0) {
          b0 = col < L ? bias[col] : 0.f;
          b1 = col + 1 < L ? bias[col + 1] : 0.f;
        }
        *reinterpret_cast<float2*>(dst + g * sp + col) = make_float2(c[0] + b0, c[1] + b1);
        *reinterpret_cast<float2*>(dst + (g + 8) * sp + col) = make_float2(c[2] + b0, c[3] + b1);
      }
    }
  }
  __syncthreads();
  for (int r = warp; r < kTQ; r += kMmaWarps) {
    float* srow = s_s + (size_t)r * sp;
    float* grow = g_s + (size_t)r * sp;
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
    float delta = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float p = srow[j] * recip;
      srow[j] = p;
      delta = fmaf(p, grow[j], delta);
    }
    delta = warp_sum(delta);
    for (int j = lane; j < L; j += 32) grow[j] = round_bf16(srow[j] * (grow[j] - delta));
    for (int j = L + lane; j < l16; j += 32) grow[j] = 0.f;
    if (lane == 0 && r < nq) {
      float* st = stats + (base + q0 + r) * 3;
      st[0] = mx;
      st[1] = recip;
      st[2] = delta;
    }
  }
  // dQ = dS K
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int j0 = 0; j0 < l16; j0 += kMmaTK) {
    const int kend = min(kMmaTK, l16 - j0);
    __syncthreads();
    load_tile_f32<DH>(kv_s, k + (base + j0) * DH, min(kMmaTK, L - j0), kend, tid);
    __syncthreads();
    for (int kb = 0; kb < kend; kb += 16) {
      const float* p0 = g_s + g * sp + j0 + kb + 2 * t;
      const float* p1 = p0 + 8 * sp;
      const uint32_t a0 = pack_bf16(p0[0], p0[1]), a1 = pack_bf16(p1[0], p1[1]);
      const uint32_t a2 = pack_bf16(p0[8], p0[9]), a3 = pack_bf16(p1[8], p1[9]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kc = kv_s + (kb + 2 * t) * QS + (warp * NT + nt) * 8 + g;
        mma_bf16(acc[nt], a0, a1, a2, a3, pack_raw(kc[0], kc[QS]),
                 pack_raw(kc[8 * QS], kc[9 * QS]));
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = (warp * NT + nt) * 8 + 2 * t;
    if (g < nq)
      *reinterpret_cast<float2*>(dq + (base + q0 + g) * DH + col) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (g + 8 < nq)
      *reinterpret_cast<float2*>(dq + (base + q0 + g + 8) * DH + col) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
}

// dK = dS^T q and dV = P^T dO for 64 keys of one (batch, head), 16 per
// warp, summed over all query rows 16 at a time: S^T = K q^T and
// dP^T = V dO^T give P^T and dS^T from the row statistics, whose
// accumulator fragments are reused as the A operand of the next products
template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
attn_bwd_dkdv_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ kbias, const float* __restrict__ stats,
                         float* __restrict__ dk, float* __restrict__ dv, int H, int L) {
  constexpr int QS = DH + 8, KT = DH / 16, NT = DH / 8;
  constexpr int kKeys = 16 * kMmaWarps;        // keys per block
  constexpr int kRows = 64;                    // query rows staged per round
  __shared__ __align__(16) __nv_bfloat16 k_s[kKeys * QS];
  __shared__ __align__(16) __nv_bfloat16 v_s[kKeys * QS];
  __shared__ __align__(16) __nv_bfloat16 q_s[kRows * QS];
  __shared__ __align__(16) __nv_bfloat16 do_s[kRows * QS];
  __shared__ float st_s[kRows][3];

  const int bh = blockIdx.y, b = bh / H;
  const int j0 = blockIdx.x * kKeys, nk = min(kKeys, L - j0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)bh * L;

  load_tile_f32<DH>(k_s, k + (base + j0) * DH, nk, kKeys, tid);
  load_tile_f32<DH>(v_s, v + (base + j0) * DH, nk, kKeys, tid);
  __syncthreads();
  // this warp's 16 keys as A fragments, held for the whole sweep
  uint32_t ka[KT][4], va[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const __nv_bfloat16* kp = k_s + (warp * 16 + g) * QS + kk * 16 + 2 * t;
    const __nv_bfloat16* vp = v_s + (warp * 16 + g) * QS + kk * 16 + 2 * t;
    ka[kk][0] = ld_u32(kp);
    ka[kk][1] = ld_u32(kp + 8 * QS);
    ka[kk][2] = ld_u32(kp + 8);
    ka[kk][3] = ld_u32(kp + 8 * QS + 8);
    va[kk][0] = ld_u32(vp);
    va[kk][1] = ld_u32(vp + 8 * QS);
    va[kk][2] = ld_u32(vp + 8);
    va[kk][3] = ld_u32(vp + 8 * QS + 8);
  }
  const int key0 = j0 + warp * 16 + g, key1 = key0 + 8;
  // keys past L are masked like padded ones: their P is exactly 0
  const float bk[2] = {key0 < L ? kbias[(size_t)b * L + key0] : -1e30f,
                       key1 < L ? kbias[(size_t)b * L + key1] : -1e30f};

  float adk[NT][4], adv[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[nt][e] = adv[nt][e] = 0.f;

  for (int i0 = 0; i0 < L; i0 += kRows) {
    const int ni = min(kRows, L - i0);
    __syncthreads();
    load_tile_f32<DH>(q_s, q + (base + i0) * DH, ni, kRows, tid);
    load_tile_f32<DH>(do_s, dout + (base + i0) * DH, ni, kRows, tid);
    for (int i = tid; i < kRows * 3; i += kMmaThreads) {
      const int r = i / 3;
      // rows past L get 1/sum = 0, so their P and dS are 0
      st_s[r][i % 3] = r < ni ? stats[(base + i0 + r) * 3 + i % 3] : 0.f;
    }
    __syncthreads();
    for (int qb = 0; qb < ni; qb += 16) {
      float cs[2][4], cp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) cs[j][e] = cp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          const __nv_bfloat16* qp = q_s + (qb + 8 * j + g) * QS + kk * 16 + 2 * t;
          const __nv_bfloat16* dp = do_s + (qb + 8 * j + g) * QS + kk * 16 + 2 * t;
          mma_bf16(cs[j], ka[kk][0], ka[kk][1], ka[kk][2], ka[kk][3], ld_u32(qp),
                   ld_u32(qp + 8));
          mma_bf16(cp[j], va[kk][0], va[kk][1], va[kk][2], va[kk][3], ld_u32(dp),
                   ld_u32(dp + 8));
        }
      }
      // element (key row g + 8*half, query qb + 8*j + 2*t + e); fragment
      // a[2*j + half] of the 16-key x 16-query A operand
      uint32_t pa[4], sa[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float pv[2], sv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = qb + 8 * j + 2 * t + e;
            const float p = expf(cs[j][2 * half + e] + bk[half] - st_s[qi][0]) * st_s[qi][1];
            pv[e] = p;
            sv[e] = p * (cp[j][2 * half + e] - st_s[qi][2]);
          }
          pa[2 * j + half] = pack_bf16(pv[0], pv[1]);
          sa[2 * j + half] = pack_bf16(sv[0], sv[1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* qc = q_s + (qb + 2 * t) * QS + nt * 8 + g;
        const __nv_bfloat16* dc = do_s + (qb + 2 * t) * QS + nt * 8 + g;
        mma_bf16(adk[nt], sa[0], sa[1], sa[2], sa[3], pack_raw(qc[0], qc[QS]),
                 pack_raw(qc[8 * QS], qc[9 * QS]));
        mma_bf16(adv[nt], pa[0], pa[1], pa[2], pa[3], pack_raw(dc[0], dc[QS]),
                 pack_raw(dc[8 * QS], dc[9 * QS]));
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (key0 < L) {
      *reinterpret_cast<float2*>(dk + (base + key0) * DH + col) = make_float2(adk[nt][0], adk[nt][1]);
      *reinterpret_cast<float2*>(dv + (base + key0) * DH + col) = make_float2(adv[nt][0], adv[nt][1]);
    }
    if (key1 < L) {
      *reinterpret_cast<float2*>(dk + (base + key1) * DH + col) = make_float2(adk[nt][2], adk[nt][3]);
      *reinterpret_cast<float2*>(dv + (base + key1) * DH + col) = make_float2(adv[nt][2], adv[nt][3]);
    }
  }
}

size_t fwd_smem_bytes(int L, int dh, bool export_map) {
  return sizeof(float) * ((size_t)kTQ * dh + (size_t)kTK * (dh + 1) +
                          (size_t)kTQ * L * (export_map ? 2 : 1));
}

// fp32 row stride of the tensor-core kernels' score rows: L rounded up to
// whole 16-key steps, plus 4 to spread the rows over banks
int mma_row_stride(int L) { return (L + 15) / 16 * 16 + 4; }

size_t fwd_mma_smem_bytes(int L, int dh, bool export_map) {
  return sizeof(float) * (export_map ? 2 : 1) * kTQ * (size_t)mma_row_stride(L) +
         sizeof(__nv_bfloat16) * (size_t)(kTQ + kMmaTK) * (dh + 8);
}

size_t bwd_smem_bytes(int L, int dh) {
  return sizeof(float) * (2 * (size_t)kTQ * dh + (size_t)kTK * (dh + 1) +
                          2 * (size_t)kTQ * L);
}

size_t bwd_mma_smem_bytes(int L, int dh) {
  return sizeof(float) * 2 * kTQ * (size_t)mma_row_stride(L) +
         sizeof(__nv_bfloat16) * (size_t)(2 * kTQ + kMmaTK) * (dh + 8);
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

template <int DH, bool EXPORT>
cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v,
                           const void* kbias, void* out, void* map, int B, int H,
                           int L, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(L, DH, EXPORT);
  auto kern = attn_fwd_kernel<DH, EXPORT>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((L + kTQ - 1) / kTQ, B), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(kbias),
      static_cast<float*>(out), static_cast<float*>(map), H, L, scale);
  return cudaGetLastError();
}

template <int DH, bool EXPORT>
cudaError_t launch_fwd_bf16(const void* q, const void* k, const void* v,
                            const void* kbias, void* out, void* map, int B, int H,
                            int L, float scale, cudaStream_t stream) {
  const size_t smem = fwd_mma_smem_bytes(L, DH, EXPORT);
  auto kern = attn_fwd_mma_kernel<DH, EXPORT>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  using bf = __nv_bfloat16;
  kern<<<dim3((L + kTQ - 1) / kTQ, B), kMmaThreads, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const float*>(kbias),
      static_cast<bf*>(out), static_cast<float*>(map), H, L, mma_row_stride(L),
      scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* kbias, void* out, void* map, int B, int H,
                       int L, float scale, int bf16, int export_map,
                       cudaStream_t s) {
  if (bf16)
    return export_map
               ? launch_fwd_bf16<DH, true>(q, k, v, kbias, out, map, B, H, L, scale, s)
               : launch_fwd_bf16<DH, false>(q, k, v, kbias, out, map, B, H, L, scale, s);
  return export_map
             ? launch_fwd_f32<DH, true>(q, k, v, kbias, out, map, B, H, L, scale, s)
             : launch_fwd_f32<DH, false>(q, k, v, kbias, out, map, B, H, L, scale, s);
}

template <int DH>
cudaError_t launch_bwd(const float* q, const float* k, const float* v,
                       const float* dout, const float* kbias, float* dq,
                       float* dk, float* dv, float* stats, int B, int H, int L,
                       int bf16, cudaStream_t stream) {
  cudaError_t e;
  if (bf16) {                  // bf16 score type: the tensor-core kernels
    const size_t smem = bwd_mma_smem_bytes(L, DH);
    auto kern = attn_bwd_dq_mma_kernel<DH>;
    e = allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<dim3((L + kTQ - 1) / kTQ, B * H), kMmaThreads, smem, stream>>>(
        q, k, v, dout, kbias, dq, stats, H, L, mma_row_stride(L));
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    attn_bwd_dkdv_mma_kernel<DH>
        <<<dim3((L + 16 * kMmaWarps - 1) / (16 * kMmaWarps), B * H), kMmaThreads, 0,
           stream>>>(q, k, v, dout, kbias, stats, dk, dv, H, L);
    return cudaGetLastError();
  }
  const size_t smem = bwd_smem_bytes(L, DH);
  auto kern = attn_bwd_dq_kernel<DH>;
  e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((L + kTQ - 1) / kTQ, B * H), kThreads, smem, stream>>>(
      q, k, v, dout, kbias, dq, stats, H, L);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dkdv_kernel<DH><<<dim3((L + kBT - 1) / kBT, B * H), kThreads, 0, stream>>>(
      q, k, v, dout, kbias, stats, dk, dv, H, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" int attn_fwd(const void* q, const void* k, const void* v,
                        const void* kbias, void* out, void* map, int B, int H,
                        int L, int Dh, float scale, int bf16, int export_map,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh == 64)
    return launch_fwd<64>(q, k, v, kbias, out, map, B, H, L, scale, bf16, export_map, s);
  if (Dh == 32)
    return launch_fwd<32>(q, k, v, kbias, out, map, B, H, L, scale, bf16, export_map, s);
  return cudaErrorInvalidValue;
}

extern "C" int attn_bwd(const void* q, const void* k, const void* v,
                        const void* dout, const void* kbias, void* dq, void* dk,
                        void* dv, void* stats, int B, int H, int L, int Dh,
                        int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto m = [](void* p) { return static_cast<float*>(p); };
  if (Dh == 64)
    return launch_bwd<64>(f(q), f(k), f(v), f(dout), f(kbias), m(dq), m(dk), m(dv),
                          m(stats), B, H, L, bf16, s);
  if (Dh == 32)
    return launch_bwd<32>(f(q), f(k), f(v), f(dout), f(kbias), m(dq), m(dk), m(dv),
                          m(stats), B, H, L, bf16, s);
  return cudaErrorInvalidValue;
}
