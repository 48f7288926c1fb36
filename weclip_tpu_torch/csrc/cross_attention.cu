// Rectangular attention (Lq != Lk) for the CoMer CTI cross-attention, and
// the fp32 attention kernels, for sm_90a.  Plain C entry points, loaded
// with ctypes by weclip_tpu_torch/kernels.py; wrappers in
// ops/attention_kernels.py.  The bf16 K2 and backward are
// flash_attention.cu's.
//
// Replaces (weclip_tpu/ops/pallas_attention.py):
//   K6             cross_attention_core_pallas   (_attn_kernel, no export; :539, pallas_call :582)
//   K2             attention_core_pallas(export_weights=False) under the fp32
//                  score type (the eval decoder; :195, pallas_call :260)
//   K3, K3-rect    attention_bwd_pallas under the fp32 score type (_attn_bwd_kernel; :395)
//
// Numerics follow the Pallas kernels: q arrives pre-scaled, fp32 scores and
// softmax, additive -1e30 key bias, all-masked row guard max(smax, -5e29),
// denominator >= 1e-30; the forward normalizes after the value product and
// returns fp32; the backward recomputes the softmax (the forward saves no
// row statistics), takes delta = rowsum(P * dP) as the plain version does,
// and returns fp32 dq, dk, dv.  K6 under the bf16 score type runs its
// products on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate) with q, k, v and P in bf16; under fp32 the products are FMA
// loops on the CUDA cores, one query row (or key) per thread.
//
// Design: whole-row score buffers do not fit here (one 16-row fp32 score
// tile at Lk = 5376 is 345 KB, above a block's 227 KB), so every kernel
// loops over key tiles staged in shared memory and keeps scores in
// registers.  K6 under bf16 makes two sweeps: the row max over all keys,
// then exp against that final max, the sum, and P V accumulated in
// registers (each P fragment of S = q K^T is reused as the A operand of
// P V).  The fp32 forward makes one sweep with online softmax, its
// accumulator rescaled when a tile raises the row max.  The fp32
// backward's dQ kernel makes four sweeps (max; sum; P, dP and delta; dS
// and dQ = dS K) and writes each row's (max, 1/sum, delta); a second
// kernel per key tile loops over all query rows to sum dK and dV from
// those statistics.  Deterministic, no atomics.  The fp32 backward serves
// the fp32 policy's parity checks only.
//
// What bounds them on the H100: at the eval shape (16, 4, 5376, 64) x 1024
// keys K6 does 4*B*H*Lq*Lk*Dh = 90 GFLOP (0.09 ms at the bf16 peak) and
// moves 30 MB (9 us): operations.  K6 runs one warp per 16 rows without
// pipelining its loads.  The fp32 forward at the decoder's (16, 8, 1024,
// 32) does 17 GFLOP of FMA (0.26 ms at the fp32 peak), every operand read
// from shared memory: operations, and shared-memory bandwidth beside them.

#include <math_constants.h>

#include "common.cuh"

using namespace weclip;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;   // tensor-core kernels
constexpr int kRows = 16 * kWarps;      // query rows (or keys) per tensor-core block
constexpr int kKeys = 64;               // keys (or query rows) per staged tile there
constexpr int kF32Rows = 64;            // query rows (or keys) per FMA block, one per thread
constexpr int kF32Keys = 16;            // keys (or query rows) per staged tile there
constexpr int kF32FwdKeys = 32;         // keys per staged tile of the FMA forward
constexpr float kMasked = -1e30f;       // bias of a masked key, and of keys past Lk

// rows [0, n) of a DH-wide bf16 array into shared memory (row stride
// DH + 8), zeros in rows [n, nrows); 16-byte vectors
template <int DH>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int n, int nrows, int tid) {
  constexpr int kVec = DH / 8;
  for (int i = tid; i < nrows * kVec; i += kThreads) {
    const int j = i / kVec, c = (i % kVec) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (j < n) x = *reinterpret_cast<const uint4*>(src + (size_t)j * DH + c);
    *reinterpret_cast<uint4*>(dst + j * (DH + 8) + c) = x;
  }
}

// key biases [0, n) of a staged tile, kMasked for the rest
template <int NT>
__device__ __forceinline__ void stage_bias(float* dst, const float* src, int n, int tid,
                                           int nthreads) {
  for (int i = tid; i < NT; i += nthreads) dst[i] = i < n ? src[i] : kMasked;
}

// the A fragments (16 rows from row0, DH wide) of a staged bf16 tile
template <int DH>
__device__ __forceinline__ void load_a(uint32_t (&a)[DH / 16][4], const __nv_bfloat16* s,
                                       int row0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const __nv_bfloat16* p = s + (row0 + g) * (DH + 8) + kk * 16 + 2 * t;
    a[kk][0] = ld_u32(p);
    a[kk][1] = ld_u32(p + 8 * (DH + 8));
    a[kk][2] = ld_u32(p + 8);
    a[kk][3] = ld_u32(p + 8 * (DH + 8) + 8);
  }
}

// c = A (16 x DH) times rows [n0, n0 + 8) of a staged tile, transposed:
// the 16 x 8 block of S = q K^T (or dP = dO V^T) at columns n0
template <int DH>
__device__ __forceinline__ void product8(float (&c)[4], const uint32_t (&a)[DH / 16][4],
                                         const __nv_bfloat16* tile, int n0, int g, int t) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const __nv_bfloat16* p = tile + (n0 + g) * (DH + 8) + kk * 16 + 2 * t;
    mma_bf16(c, a[kk][0], a[kk][1], a[kk][2], a[kk][3], ld_u32(p), ld_u32(p + 8));
  }
}

// acc (16 x DH) += A (16 x 16, rows of the tile [k0, k0 + 16)) times those
// rows of a staged DH-wide tile: P V, or dS K
template <int DH>
__device__ __forceinline__ void accumulate(float (&acc)[DH / 8][4], const uint32_t (&a)[4],
                                           const __nv_bfloat16* tile, int k0, int g, int t) {
  constexpr int QS = DH + 8;
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    const __nv_bfloat16* p = tile + (k0 + 2 * t) * QS + nt * 8 + g;
    mma_bf16(acc[nt], a[0], a[1], a[2], a[3], pack_raw(p[0], p[QS]),
             pack_raw(p[8 * QS], p[9 * QS]));
  }
}

// fp32 (16 x DH) fragments to rows [r0, r0 + 16) of a row-major array, rows
// past `rows` skipped, each row times its scale
template <int DH>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[DH / 8][4], int r0,
                                           int rows, float s0, float s1, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (r0 + g < rows)
      *reinterpret_cast<float2*>(dst + (size_t)(r0 + g) * DH + col) =
          make_float2(acc[nt][0] * s0, acc[nt][1] * s0);
    if (r0 + g + 8 < rows)
      *reinterpret_cast<float2*>(dst + (size_t)(r0 + g + 8) * DH + col) =
          make_float2(acc[nt][2] * s1, acc[nt][3] * s1);
  }
}

// ---------------------------------------------------------------------------
// K6, bf16: one block of 4 warps per (batch, head, 64 query rows), 16 rows
// per warp; K and V staged 64 keys at a time
// ---------------------------------------------------------------------------

template <int DH>
__global__ void __launch_bounds__(kThreads)
xattn_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const float* __restrict__ kbias,
                     float* __restrict__ out, int H, int Lq, int Lk) {
  constexpr int QS = DH + 8, KT = DH / 16, NT = DH / 8;
  __shared__ __align__(16) __nv_bfloat16 q_s[kRows * QS];
  __shared__ __align__(16) __nv_bfloat16 k_s[kKeys * QS];
  __shared__ __align__(16) __nv_bfloat16 v_s[kKeys * QS];
  __shared__ float b_s[kKeys];

  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* kb = k + (size_t)bh * Lk * DH;
  const __nv_bfloat16* vb = v + (size_t)bh * Lk * DH;
  const float* bias = kbias + (size_t)b * Lk;

  stage_bf16<DH>(q_s, q + ((size_t)bh * Lq + q0) * DH, min(kRows, Lq - q0), kRows, tid);
  __syncthreads();
  uint32_t qa[KT][4];
  load_a<DH>(qa, q_s, warp * 16, g, t);

  // sweep 1: the row max (rows g and g + 8 of this warp's 16)
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
  for (int j0 = 0; j0 < Lk; j0 += kKeys) {
    const int nk = min(kKeys, Lk - j0);
    __syncthreads();
    stage_bf16<DH>(k_s, kb + (size_t)j0 * DH, nk, kKeys, tid);
    stage_bias<kKeys>(b_s, bias + j0, nk, tid, kThreads);
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
      float c[4];
      product8<DH>(c, qa, k_s, nt * 8, g, t);
      const float b0 = b_s[nt * 8 + 2 * t], b1 = b_s[nt * 8 + 2 * t + 1];
      m0 = fmaxf(m0, fmaxf(c[0] + b0, c[1] + b1));
      m1 = fmaxf(m1, fmaxf(c[2] + b0, c[3] + b1));
    }
  }
  m0 = fmaxf(quad_max(m0), -5e29f);
  m1 = fmaxf(quad_max(m1), -5e29f);

  // sweep 2: exp against the final max, the fp32 sum, P (bf16) V
  float l0 = 0.f, l1 = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int j0 = 0; j0 < Lk; j0 += kKeys) {
    const int nk = min(kKeys, Lk - j0);
    __syncthreads();
    stage_bf16<DH>(k_s, kb + (size_t)j0 * DH, nk, kKeys, tid);
    stage_bf16<DH>(v_s, vb + (size_t)j0 * DH, nk, kKeys, tid);
    stage_bias<kKeys>(b_s, bias + j0, nk, tid, kThreads);
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n0 = kc * 16 + half * 8;
        float c[4];
        product8<DH>(c, qa, k_s, n0, g, t);
        const float b0 = b_s[n0 + 2 * t], b1 = b_s[n0 + 2 * t + 1];
        const float e0 = expf(c[0] + b0 - m0), e1 = expf(c[1] + b1 - m0);
        const float e2 = expf(c[2] + b0 - m1), e3 = expf(c[3] + b1 - m1);
        l0 += e0 + e1;
        l1 += e2 + e3;
        pa[2 * half] = pack_bf16(e0, e1);       // row g
        pa[2 * half + 1] = pack_bf16(e2, e3);   // row g + 8
      }
      accumulate<DH>(acc, pa, v_s, kc * 16, g, t);
    }
  }
  const float r0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float r1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  store_rows<DH>(out + (size_t)bh * Lq * DH, acc, q0 + warp * 16, Lq, r0, r1, g, t);
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
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const float* kbias,
                       float* out, int B, int H, int Lq, int Lk, int bf16, cudaStream_t s) {
  if (bf16) {
    using bf = __nv_bfloat16;
    xattn_fwd_mma_kernel<DH><<<dim3((Lq + kRows - 1) / kRows, B * H), kThreads, 0, s>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        kbias, out, H, Lq, Lk);
  } else {
    xattn_fwd_f32_kernel<DH><<<dim3((Lq + kF32Rows - 1) / kF32Rows, B * H), kF32Rows, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), kbias, out, H, Lq, Lk);
  }
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

// K6, and K2 under fp32: q (pre-scaled), k, v in the score type (bf16 if
// bf16 else fp32); kbias (B, Lk) fp32; out (B, H, Lq, Dh) fp32
extern "C" int xattn_fwd(const void* q, const void* k, const void* v, const void* kbias,
                         void* out, int B, int H, int Lq, int Lk, int Dh, int bf16,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kb = static_cast<const float*>(kbias);
  float* o = static_cast<float*>(out);
  if (Dh == 64) return launch_fwd<64>(q, k, v, kb, o, B, H, Lq, Lk, bf16, s);
  if (Dh == 32) return launch_fwd<32>(q, k, v, kb, o, B, H, Lq, Lk, bf16, s);
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
