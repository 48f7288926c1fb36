// The fp32 attention kernels (FMA loops on the CUDA cores), for sm_90a:
// the forward for any (Lq, Lk) (K6, and K2, under fp32) and the backward
// for any (Lq, Lk) (K3 and K3-rect under fp32), and the forward of K1
// under fp32 (with each row's (max, 1/sum) written out for attention.cu's
// map kernel).  Plain C entry points,
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
//   K1             attention_core_pallas(export_weights=True): its forward
//                  and row statistics (the map: attention.cu)
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
// Head widths.  The kernels are compiled at Dh 16, 32, 64 and 128 (DH); a
// width between them (PAD) runs the next one up, its rows read with the
// true stride, zeros in the lanes past it, only its true columns written.
// Up to Dh 64 a thread holds its row's DH values of q (and of the
// accumulator) in registers.  At Dh 128 that would be 256 registers, so
// four adjacent threads share a row (SP = 4), each holding every fourth
// column; their partial dot products are summed with two shuffles (in the
// same order on all four, so they agree bit for bit) and each accumulates
// its own columns.  Those instances' tiles exceed 48 KB of static shared
// memory and take theirs dynamically (common.cuh::static_or_dynamic).
//
// What bounds them on the H100: operations.  The forward at the decoder's
// (16, 8, 1024, 32) does 17 GFLOP of FMA (0.26 ms at the 67 TFLOP/s fp32
// peak), every operand read from shared memory: operations, and
// shared-memory bandwidth beside them.

#include <math_constants.h>

#include "common.cuh"

using namespace weclip;

namespace {

constexpr int kF32Rows = 64;            // query rows (or keys) per FMA block
constexpr int kF32Keys = 16;            // keys (or query rows) per staged tile there
constexpr int kF32FwdKeys = 32;         // keys per staged tile of the FMA forward
constexpr float kMasked = -1e30f;       // bias of a masked key, and of keys past Lk

// threads that share one query row (or key): its columns d * SP + part
__host__ __device__ constexpr int split_of(int dh) { return dh > 64 ? 4 : 1; }

// The instances at Dh 32 and 64 (one thread a row, unpadded) stage their
// tiles with flat indices (the `kNarrow` branches), the statements they
// were first written with: stage_f32's row and column arithmetic, though
// equal, compiles them to other code (xattn_fwd_f32_kernel<64>: 245
// registers instead of 252 on sm_90a).
__host__ __device__ constexpr bool narrow(int dh, bool pad) {
  return !pad && (dh == 32 || dh == 64);
}

// the sum of a value over the SP adjacent lanes of a row, equal on all of them
template <int SP>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < SP; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// key biases [0, n) of a staged tile, kMasked for the rest
template <int NT>
__device__ __forceinline__ void stage_bias(float* dst, const float* src, int n, int tid,
                                           int nthreads) {
  for (int i = tid; i < NT; i += nthreads) dst[i] = i < n ? src[i] : kMasked;
}

// rows [0, rows) x DH of two tiles, a into da and (if `both`) b into db
// (row stride S), rows [0, n) read from a and b (row stride rw: DH, or
// under PAD the true width, with zeros past it), zeros in the rest
template <int DH, bool PAD, int S>
__device__ __forceinline__ void stage_f32(float* da, const float* a, float* db, const float* b,
                                          bool both, int rows, int n, int rw, int tid,
                                          int nthreads) {
  for (int i = tid; i < rows * DH; i += nthreads) {
    const int r = i / DH, c = i % DH;
    const bool in = PAD ? r < n && c < rw : r < n;
    const size_t at = PAD ? (size_t)r * rw + c : (size_t)i;
    da[r * S + c] = in ? a[at] : 0.f;
    if (both) db[r * S + c] = in ? b[at] : 0.f;
  }
}

// the dynamic layouts of each kernel's staged tiles at DH 128, where they
// outgrow static shared memory
constexpr int kMaxStaticDh = 64;

template <int DH>
struct FwdSmem {
  float q[kF32Rows][DH + split_of(DH)];
  float k[kF32FwdKeys][DH], v[kF32FwdKeys][DH];
};

// ---------------------------------------------------------------------------
// K6, K2 and K1's forward, fp32: SP threads per query row, q in registers,
// K and V staged 32 keys at a time (read by every row at once:
// shared-memory broadcasts); one sweep with online softmax.  STATS: each
// row's final (max, 1/sum), (B, H, Lq, 2)
// ---------------------------------------------------------------------------

template <int DH, bool PAD, bool STATS>
__global__ void __launch_bounds__(kF32Rows * split_of(DH))
xattn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ kbias,
                     float* __restrict__ out, float* __restrict__ stats, int H, int Lq,
                     int Lk, int ld) {
  constexpr int SP = split_of(DH), DW = DH / SP, NTH = kF32Rows * SP;
  constexpr bool kStatic = DH <= kMaxStaticDh;
  constexpr int D = kStatic ? DH : 1;
  __shared__ float q_st[kF32Rows][D + 1];
  __shared__ float k_st[kF32FwdKeys][D], v_st[kF32FwdKeys][D];
  __shared__ float b_s[kF32FwdKeys];
  auto& q_s = static_or_dynamic<kStatic>(q_st, dynamic_block<FwdSmem<DH>>().q);
  auto& k_s = static_or_dynamic<kStatic>(k_st, dynamic_block<FwdSmem<DH>>().k);
  auto& v_s = static_or_dynamic<kStatic>(v_st, dynamic_block<FwdSmem<DH>>().v);
  const int rw = PAD ? ld : DH;   // the row width in global memory

  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * kF32Rows, tid = threadIdx.x;
  const int row = tid / SP, part = tid % SP;
  const float* kb = k + (size_t)bh * Lk * rw;
  const float* vb = v + (size_t)bh * Lk * rw;
  const float* bias = kbias + (size_t)b * Lk;

  if constexpr (narrow(DH, PAD)) {
    for (int i = tid; i < kF32Rows * DH; i += kF32Rows) {
      const int r = i / DH;
      q_s[r][i % DH] = q0 + r < Lq ? q[((size_t)bh * Lq + q0) * DH + i] : 0.f;
    }
  } else {
    stage_f32<DH, PAD, DH + SP>(&q_s[0][0], q + ((size_t)bh * Lq + q0) * rw, nullptr, nullptr,
                                false, kF32Rows, Lq - q0, rw, tid, NTH);
  }
  __syncthreads();
  float qr[DW], acc[DW];
#pragma unroll
  for (int d = 0; d < DW; ++d) {
    qr[d] = q_s[row][d * SP + part];
    acc[d] = 0.f;
  }
  // the running max starts at the all-masked row guard
  float m = -5e29f, l = 0.f;
  for (int j0 = 0; j0 < Lk; j0 += kF32FwdKeys) {
    const int nk = min(kF32FwdKeys, Lk - j0);
    __syncthreads();
    if constexpr (narrow(DH, PAD)) {
      for (int i = tid; i < kF32FwdKeys * DH; i += kF32Rows) {
        const bool in = i / DH < nk;
        k_s[i / DH][i % DH] = in ? kb[(size_t)j0 * DH + i] : 0.f;
        v_s[i / DH][i % DH] = in ? vb[(size_t)j0 * DH + i] : 0.f;
      }
    } else {
      stage_f32<DH, PAD, DH>(&k_s[0][0], kb + (size_t)j0 * rw, &v_s[0][0], vb + (size_t)j0 * rw,
                             true, kF32FwdKeys, nk, rw, tid, NTH);
    }
    stage_bias<kF32FwdKeys>(b_s, bias + j0, nk, tid, NTH);
    __syncthreads();
    float sc[kF32FwdKeys];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kF32FwdKeys; ++j) {
      float x = 0.f;
#pragma unroll
      for (int d = 0; d < DW; ++d) x = fmaf(qr[d], k_s[j][d * SP + part], x);
      sc[j] = row_sum<SP>(x) + b_s[j];
      mx = fmaxf(mx, sc[j]);
    }
    const float a = expf(m - mx);   // 1 while the max holds
    m = mx;
    l *= a;
#pragma unroll
    for (int d = 0; d < DW; ++d) acc[d] *= a;
#pragma unroll
    for (int j = 0; j < kF32FwdKeys; ++j) {
      const float e = expf(sc[j] - m);
      l += e;
#pragma unroll
      for (int d = 0; d < DW; ++d) acc[d] = fmaf(e, v_s[j][d * SP + part], acc[d]);
    }
  }
  if (q0 + row < Lq) {
    const float r = 1.f / fmaxf(l, 1e-30f);
    float* dst = out + ((size_t)bh * Lq + q0 + row) * rw;
#pragma unroll
    for (int d = 0; d < DW; ++d)
      if (!PAD || d * SP + part < rw) dst[d * SP + part] = acc[d] * r;
    if (STATS && part == 0) {
      float* st = stats + ((size_t)bh * Lq + q0 + row) * 2;
      st[0] = m;
      st[1] = r;
    }
  }
}

// ---------------------------------------------------------------------------
// K3-rect, fp32 (the fp32 policy): dQ and the row statistics with SP
// threads per query row, then dK/dV with SP threads per key
// ---------------------------------------------------------------------------

template <int DH>
struct DqSmem {
  float q[kF32Rows][DH + split_of(DH)], d[kF32Rows][DH + split_of(DH)];
  float k[kF32Keys][DH], v[kF32Keys][DH];
};

template <int DH, bool PAD>
__global__ void __launch_bounds__(kF32Rows * split_of(DH))
xattn_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ kbias, float* __restrict__ dq,
                        float* __restrict__ stats, int H, int Lq, int Lk, int ld) {
  constexpr int SP = split_of(DH), DW = DH / SP, NTH = kF32Rows * SP;
  constexpr bool kStatic = DH <= kMaxStaticDh;
  constexpr int D = kStatic ? DH : 1;
  __shared__ float q_st[kF32Rows][D + 1], do_st[kF32Rows][D + 1];
  __shared__ float k_st[kF32Keys][D], v_st[kF32Keys][D];
  __shared__ float b_s[kF32Keys];
  auto& q_s = static_or_dynamic<kStatic>(q_st, dynamic_block<DqSmem<DH>>().q);
  auto& do_s = static_or_dynamic<kStatic>(do_st, dynamic_block<DqSmem<DH>>().d);
  auto& k_s = static_or_dynamic<kStatic>(k_st, dynamic_block<DqSmem<DH>>().k);
  auto& v_s = static_or_dynamic<kStatic>(v_st, dynamic_block<DqSmem<DH>>().v);
  const int rw = PAD ? ld : DH;

  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * kF32Rows, tid = threadIdx.x;
  const int row = tid / SP, part = tid % SP;
  const float* kb = k + (size_t)bh * Lk * rw;
  const float* vb = v + (size_t)bh * Lk * rw;
  const float* bias = kbias + (size_t)b * Lk;
  const size_t row0 = (size_t)bh * Lq + q0;

  if constexpr (narrow(DH, PAD)) {
    for (int i = tid; i < kF32Rows * DH; i += kF32Rows) {
      const bool in = q0 + i / DH < Lq;
      q_s[i / DH][i % DH] = in ? q[row0 * DH + i] : 0.f;
      do_s[i / DH][i % DH] = in ? dout[row0 * DH + i] : 0.f;
    }
  } else {
    stage_f32<DH, PAD, DH + SP>(&q_s[0][0], q + row0 * rw, &do_s[0][0], dout + row0 * rw, true,
                                kF32Rows, Lq - q0, rw, tid, NTH);
  }
  const float* qr = q_s[row];
  const float* dr = do_s[row];

  float m = -CUDART_INF_F, l = 0.f, rc = 0.f, delta = 0.f, acc[DW];
#pragma unroll
  for (int d = 0; d < DW; ++d) acc[d] = 0.f;
  // sweep 0: max; 1: sum; 2: delta = rowsum(P dP); 3: dS and dQ = dS K
  for (int sweep = 0; sweep < 4; ++sweep) {
    const bool want_dp = sweep >= 2;
    for (int j0 = 0; j0 < Lk; j0 += kF32Keys) {
      const int nk = min(kF32Keys, Lk - j0);
      __syncthreads();
      if constexpr (narrow(DH, PAD)) {
        for (int i = tid; i < kF32Keys * DH; i += kF32Rows) {
          const bool in = i / DH < nk;
          k_s[i / DH][i % DH] = in ? kb[(size_t)j0 * DH + i] : 0.f;
          if (want_dp) v_s[i / DH][i % DH] = in ? vb[(size_t)j0 * DH + i] : 0.f;
        }
      } else {
        stage_f32<DH, PAD, DH>(&k_s[0][0], kb + (size_t)j0 * rw, &v_s[0][0],
                               vb + (size_t)j0 * rw, want_dp, kF32Keys, nk, rw, tid, NTH);
      }
      stage_bias<kF32Keys>(b_s, bias + j0, nk, tid, NTH);
      __syncthreads();
      for (int j = 0; j < kF32Keys; ++j) {
        float s = b_s[j], sd = 0.f;
#pragma unroll
        for (int d = 0; d < DW; ++d) sd = fmaf(qr[d * SP + part], k_s[j][d * SP + part], sd);
        s += row_sum<SP>(sd);
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
        for (int d = 0; d < DW; ++d) dp = fmaf(dr[d * SP + part], v_s[j][d * SP + part], dp);
        dp = row_sum<SP>(dp);
        const float p = expf(s - m) * rc;
        if (sweep == 2) {
          delta = fmaf(p, dp, delta);
          continue;
        }
        const float ds = p * (dp - delta);
#pragma unroll
        for (int d = 0; d < DW; ++d) acc[d] = fmaf(ds, k_s[j][d * SP + part], acc[d]);
      }
    }
    if (sweep == 0) m = fmaxf(m, -5e29f);
    if (sweep == 1) rc = 1.f / fmaxf(l, 1e-30f);
  }
  if (q0 + row < Lq) {
    float* dst = dq + (row0 + row) * rw;
#pragma unroll
    for (int d = 0; d < DW; ++d)
      if (!PAD || d * SP + part < rw) dst[d * SP + part] = acc[d];
    if (part == 0) {
      float* st = stats + (row0 + row) * 3;
      st[0] = m;
      st[1] = rc;
      st[2] = delta;
    }
  }
}

template <int DH>
struct DkdvSmem {
  float k[kF32Rows][DH + split_of(DH)], v[kF32Rows][DH + split_of(DH)];
  float q[kF32Keys][DH], d[kF32Keys][DH];
};

template <int DH, bool PAD>
__global__ void __launch_bounds__(kF32Rows * split_of(DH))
xattn_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ kbias, const float* __restrict__ stats,
                          float* __restrict__ dk, float* __restrict__ dv, int H, int Lq,
                          int Lk, int ld) {
  constexpr int SP = split_of(DH), DW = DH / SP, NTH = kF32Rows * SP;
  constexpr bool kStatic = DH <= kMaxStaticDh;
  constexpr int D = kStatic ? DH : 1;
  __shared__ float k_st[kF32Rows][D + 1], v_st[kF32Rows][D + 1];
  __shared__ float q_st[kF32Keys][D], do_st[kF32Keys][D];
  __shared__ float st_s[kF32Keys][3];
  auto& k_s = static_or_dynamic<kStatic>(k_st, dynamic_block<DkdvSmem<DH>>().k);
  auto& v_s = static_or_dynamic<kStatic>(v_st, dynamic_block<DkdvSmem<DH>>().v);
  auto& q_s = static_or_dynamic<kStatic>(q_st, dynamic_block<DkdvSmem<DH>>().q);
  auto& do_s = static_or_dynamic<kStatic>(do_st, dynamic_block<DkdvSmem<DH>>().d);
  const int rw = PAD ? ld : DH;

  const int bh = blockIdx.y, b = bh / H;
  const int j0 = blockIdx.x * kF32Rows, tid = threadIdx.x;
  const int key = tid / SP, part = tid % SP;
  const size_t qbase = (size_t)bh * Lq, kbase = (size_t)bh * Lk + j0;

  if constexpr (narrow(DH, PAD)) {
    for (int i = tid; i < kF32Rows * DH; i += kF32Rows) {
      const bool in = j0 + i / DH < Lk;
      k_s[i / DH][i % DH] = in ? k[kbase * DH + i] : 0.f;
      v_s[i / DH][i % DH] = in ? v[kbase * DH + i] : 0.f;
    }
  } else {
    stage_f32<DH, PAD, DH + SP>(&k_s[0][0], k + kbase * rw, &v_s[0][0], v + kbase * rw, true,
                                kF32Rows, Lk - j0, rw, tid, NTH);
  }
  const float bj = j0 + key < Lk ? kbias[(size_t)b * Lk + j0 + key] : kMasked;
  const float* kr = k_s[key];
  const float* vr = v_s[key];
  float acc_k[DW], acc_v[DW];
#pragma unroll
  for (int d = 0; d < DW; ++d) acc_k[d] = acc_v[d] = 0.f;

  for (int i0 = 0; i0 < Lq; i0 += kF32Keys) {
    const int ni = min(kF32Keys, Lq - i0);
    __syncthreads();
    if constexpr (narrow(DH, PAD)) {
      for (int i = tid; i < kF32Keys * DH; i += kF32Rows) {
        const bool in = i / DH < ni;
        q_s[i / DH][i % DH] = in ? q[(qbase + i0) * DH + i] : 0.f;
        do_s[i / DH][i % DH] = in ? dout[(qbase + i0) * DH + i] : 0.f;
      }
    } else {
      stage_f32<DH, PAD, DH>(&q_s[0][0], q + (qbase + i0) * rw, &do_s[0][0],
                             dout + (qbase + i0) * rw, true, kF32Keys, ni, rw, tid, NTH);
    }
    for (int i = tid; i < kF32Keys * 3; i += NTH)
      st_s[i / 3][i % 3] = i / 3 < ni ? stats[(qbase + i0) * 3 + i] : 0.f;
    __syncthreads();
    for (int i = 0; i < kF32Keys; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DW; ++d) {
        s = fmaf(kr[d * SP + part], q_s[i][d * SP + part], s);
        dp = fmaf(vr[d * SP + part], do_s[i][d * SP + part], dp);
      }
      s = row_sum<SP>(s);
      dp = row_sum<SP>(dp);
      // rows past Lq: zero q, 1/sum = 0, so P and dS are 0
      const float p = expf(s + bj - st_s[i][0]) * st_s[i][1];
      const float ds = p * (dp - st_s[i][2]);
#pragma unroll
      for (int d = 0; d < DW; ++d) {
        acc_k[d] = fmaf(ds, q_s[i][d * SP + part], acc_k[d]);
        acc_v[d] = fmaf(p, do_s[i][d * SP + part], acc_v[d]);
      }
    }
  }
  if (j0 + key < Lk) {
    float* dkr = dk + (kbase + key) * rw;
    float* dvr = dv + (kbase + key) * rw;
#pragma unroll
    for (int d = 0; d < DW; ++d) {
      if (PAD && d * SP + part >= rw) continue;
      dkr[d * SP + part] = acc_k[d];
      dvr[d * SP + part] = acc_v[d];
    }
  }
}

template <int DH, bool PAD>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, const float* kbias,
                       float* out, float* stats, int B, int H, int Lq, int Lk, int ld,
                       cudaStream_t s) {
  const dim3 grid((Lq + kF32Rows - 1) / kF32Rows, B * H);
  constexpr int nth = kF32Rows * split_of(DH);
  int smem = 0;
  cudaError_t e;
  if (stats) {
    auto kern = xattn_fwd_f32_kernel<DH, PAD, true>;
    if ((e = smem_bytes<FwdSmem<DH>, (DH <= kMaxStaticDh)>(kern, &smem)) != cudaSuccess) return e;
    kern<<<grid, nth, smem, s>>>(q, k, v, kbias, out, stats, H, Lq, Lk, ld);
  } else {
    auto kern = xattn_fwd_f32_kernel<DH, PAD, false>;
    if ((e = smem_bytes<FwdSmem<DH>, (DH <= kMaxStaticDh)>(kern, &smem)) != cudaSuccess) return e;
    kern<<<grid, nth, smem, s>>>(q, k, v, kbias, out, nullptr, H, Lq, Lk, ld);
  }
  return cudaGetLastError();
}

template <int DH, bool PAD>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* dout,
                       const float* kbias, float* dq, float* dk, float* dv, float* stats,
                       int B, int H, int Lq, int Lk, int ld, cudaStream_t s) {
  constexpr int nth = kF32Rows * split_of(DH);
  int smem = 0;
  auto dq_kern = xattn_bwd_dq_f32_kernel<DH, PAD>;
  cudaError_t e = smem_bytes<DqSmem<DH>, (DH <= kMaxStaticDh)>(dq_kern, &smem);
  if (e != cudaSuccess) return e;
  dq_kern<<<dim3((Lq + kF32Rows - 1) / kF32Rows, B * H), nth, smem, s>>>(
      q, k, v, dout, kbias, dq, stats, H, Lq, Lk, ld);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  auto dkdv_kern = xattn_bwd_dkdv_f32_kernel<DH, PAD>;
  if ((e = smem_bytes<DkdvSmem<DH>, (DH <= kMaxStaticDh)>(dkdv_kern, &smem)) != cudaSuccess) return e;
  dkdv_kern<<<dim3((Lk + kF32Rows - 1) / kF32Rows, B * H), nth, smem, s>>>(
      q, k, v, dout, kbias, stats, dk, dv, H, Lq, Lk, ld);
  return cudaGetLastError();
}

}  // namespace

// K6, K2 and K1's forward under fp32: q (pre-scaled), k, v fp32, any Dh in
// [1, 128]; kbias (B, Lk) fp32; out (B, H, Lq, Dh) fp32; stats null, or
// (B, H, Lq, 2) fp32 for each row's (max, 1/sum)
extern "C" int xattn_fwd(const void* q, const void* k, const void* v, const void* kbias,
                         void* out, void* stats, int B, int H, int Lq, int Lk, int Dh,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* o = static_cast<float*>(out);
  float* st = static_cast<float*>(stats);
#define F(DH, PAD) launch_fwd<DH, PAD>(f(q), f(k), f(v), f(kbias), o, st, B, H, Lq, Lk, Dh, s)
  WECLIP_DISPATCH_DH(Dh, F);
#undef F
}

// K3 and K3-rect under fp32, any (Lq, Lk) and Dh in [1, 128]: fp32 q
// (pre-scaled), k, v, dout; fp32 dq, dk, dv and the (B, H, Lq, 3) row
// statistics (max, 1/sum, delta)
extern "C" int xattn_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const void* kbias, void* dq, void* dk, void* dv, void* stats,
                         int B, int H, int Lq, int Lk, int Dh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto m = [](void* p) { return static_cast<float*>(p); };
#define F(DH, PAD)                                                                         \
  launch_bwd<DH, PAD>(f(q), f(k), f(v), f(dout), f(kbias), m(dq), m(dk), m(dv), m(stats), \
                      B, H, Lq, Lk, Dh, s)
  WECLIP_DISPATCH_DH(Dh, F);
#undef F
}
