// Key-tiled attention on mma.sync for sm_90a: the fp32 forward and backward
// at every head width, as split-TF32 products on the tensor cores, and the
// bf16 forward and backward at head widths above 128.  Plain C entry
// points, loaded with ctypes by weclip_tpu_torch/kernels.py; wrappers in
// ops/attention_kernels.py.  Under fp32 these kernels run K2 (the eval
// decoder's attention under the default head_dtype "float32", at (16, 8,
// 1024, 32) and (16, 8, 625, 32) in every Evaluator.run), K6, K1's forward
// (with each row's (max, 1/sum) for attention.cu's map kernel), and K3 and
// K3-rect: every attention call of the fp32 policy, the CoMer functional
// check's CTI included.  Under bf16 they run K1's forward, K2, K3, K3-rect
// and K6 above head width 128 (flash_attention.cu and hopper_attention.cu
// take up to 128).
//
// Replaces (weclip_tpu/ops/pallas_attention.py), under fp32 (and bf16 above Dh 128):
//   K6             cross_attention_core_pallas   (_attn_kernel, no export; :539, pallas_call :582)
//   K2             attention_core_pallas(export_weights=False) (:195, pallas_call :260)
//   K3, K3-rect    attention_bwd_pallas (_attn_bwd_kernel; :395, pallas_call :441)
//   K1             attention_core_pallas(export_weights=True): its forward
//                  and row statistics (the map: attention.cu)
//
// Numerics follow the Pallas kernels: q scaled as it is staged (x * scale
// in fp32; bf16(float(x) * scale) under bf16), fp32 scores and softmax, an
// additive -1e30 key bias (padded with -1e30 to whole 64-key tiles by the
// wrapper), the all-masked row guard max(smax, -5e29), denominator >=
// 1e-30; the forward normalizes after P V; the backward recomputes the
// softmax, takes delta = rowsum(P * dP) as the plain version does, and
// returns fp32 dq, dk, dv.  Under fp32 every product A B is three
// tensor-core products (mma.sync m16n8k8 .tf32, fp32 accumulation) of the
// split operands x = hi + lo, hi = tf32(x) and lo = tf32(x - hi), both
// rounded to nearest (cvt.rna): lo B_hi + hi B_lo + hi B_hi, the lo lo
// term dropped, which leaves each product within about 2^-21 of its value
// (strict fp32: 2^-24).  The tensor cores truncate as they accumulate, so
// no sum runs long in one accumulator: the scores sum 32 columns at a
// time, their small terms apart from hi hi, and P V, dS K, dS^T q and P^T
// dO one tile at a time, each part then added in fp32 rounded to nearest
// (a gradient summed in one accumulator over 2100 queries drifted by 3e-5
// of its largest on the H100; tests/test_torch_attention.py::
// test_split_tf32_product_error models the scheme).  Under bf16 the
// operands (q, k, v, dO, P, dS) are bf16 as in flash_attention.cu.
//
// What bounds them on the H100: operations.  The fp32 forward at the
// decoder's (16, 8, 1024, 32) does 4*B*H*L^2*Dh = 17.2 GFLOP, three TF32
// products each: 0.10 ms at 494.7 / 3 TFLOP/s (the FMA loop it replaces
// was bound at 0.26 ms by the 67 TFLOP/s of fp32 FMA).
//
// Design: flash_attention.cu's.  A block of 4 warps (16 rows each) per
// (image, head, 64 rows, output slice) loops over tiles of the other side
// (32 or 64 rows), staged in shared memory by cp.async and double-buffered;
// scores stay in mma accumulators.  The operands are split as each fragment
// is loaded from shared memory (one cvt, one subtraction and one cvt per
// element): splitting as the tile is staged would double the tiles'
// shared memory.  An accumulator cannot be an m16n8k8 A operand in place
// (A holds columns t and t + 4 of a row, the accumulator 2t and 2t + 1), so
// the A operand takes the accumulator's columns in the order 0, 2, 4, 6,
// 1, 3, 5, 7 and the B operand's rows are read from shared memory in the
// same order (Ops<float>::from_acc, load_b): no shuffle and no trip through
// shared memory.
// - Forward: one sweep with online softmax; STATS writes each row's
//   (max, 1/sum).
// - dQ: two sweeps over the keys, the first for each row's (max, sum,
//   delta) online, the second for dS = P (dP - delta) and dQ = dS K; writes
//   (max, 1/sum, delta).
// - dK/dV: a block per 64 keys loops over the query tiles with those
//   statistics, S^T and dP^T recomputed, accumulators in mma fragments; at
//   Dh 128 as two launches, one for dK and one for dV.
// Deterministic, no atomics, any (Lq, Lk).
//
// Head widths.  Compiled at Dh 16, 32, 64 and 128 (DH); a width below 128
// that is not one of them (PAD) runs the next one up with zeros in the
// lanes past it.  Above 128 the DH 128 instance runs the row as slices of
// 128 columns: the grid has an axis over the output slices, and each block
// sums its scores (and dP) over every slice as a longer k-loop, staging q
// (and dO) with each 128-column chunk of a key tile (one tile in flight,
// so shared memory does not grow with the width), then writes its slice
// of O, dQ, dK or dV.  Rows whose width is a multiple of 4 (fp32) or 8
// (bf16) are staged by cp.async, other widths by plain loads.

#include "common.cuh"

using namespace weclip;
using namespace weclip::tc;

namespace {

using bf = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // query rows (dK/dV: keys) per block
constexpr int kSlice = 128;          // columns of a slice above Dh 128
constexpr float kFloor = -5e29f;     // the all-masked row guard of the max
constexpr int kBoth = 0, kOnlyDk = 1, kOnlyDv = 2;

// the key bias is padded to whole 64-key tiles
__host__ __device__ __forceinline__ int padded(int l) { return (l + 63) / 64 * 64; }

// rows of the other side per staged tile: 32 where a row is 256 bytes or
// more, so that two blocks of the forward fit an SM
template <typename T, int DH>
__host__ __device__ constexpr int tile_rows() { return sizeof(T) * DH >= 256 ? 32 : 64; }

// slices of a row ld wide
template <int DH>
__host__ __device__ __forceinline__ int slices(int ld) {
  return DH == kSlice ? (ld + kSlice - 1) / kSlice : 1;
}

// acc (16 x DH) += P (16 x KT, the accumulator tiles p) times the tile b
// (KT rows, DH columns).  The tile's product is summed in an accumulator of
// its own and then added in fp32, rounded to nearest: the tensor cores
// truncate as they accumulate, which over the hundreds of tiles of a long
// sum (dK and dV over 2100 queries in CTI's backward, dQ over 5376 keys)
// drifted by up to 3e-5 of the sum (measured on the H100).  The small
// terms share it (apart they took DH / 2 more registers and spilled at Dh
// 128), and it holds 64 columns at a time
template <typename T, int DH, int SS, int KT>
__device__ __forceinline__ void add_product(float (&acc)[DH / 8][4], const float (&p)[KT / 8][4],
                                            const T* b, int g, int t) {
  using M = Ops<T>;
  constexpr int kCols = DH > 64 ? 8 : DH / 8;   // column tiles summed at a time (32 registers)
#pragma unroll
  for (int n0 = 0; n0 < DH / 8; n0 += kCols) {
    float part[kCols][4];
    zero(part);
#pragma unroll
    for (int ks = 0; ks < KT / M::kK; ++ks) {
      typename M::A fa;
      M::from_acc(fa, &p[ks * M::kK / 8]);
#pragma unroll
      for (int nt = 0; nt < kCols; ++nt) {
        typename M::B fb;
        M::load_b(fb, b, SS, ks * M::kK, (n0 + nt) * 8, g, t);
        M::mma(part[nt], part[nt], fa, fb);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kCols; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n0 + nt][i] += part[nt][i];
  }
}

__device__ __forceinline__ void put2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void put2(bf* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void put1(float* p, float x) { *p = x; }
__device__ __forceinline__ void put1(bf* p, float x) { *p = __float2bfloat16_rn(x); }

// rows r0 + g (times r[0]) and r0 + g + 8 (times r[1]) of a 16 x DH
// accumulator into columns [c0, c0 + DH) of a row-major array (row stride
// ld), rows >= rows and (PAD) columns >= ld skipped
template <typename TO, int DH, bool PAD>
__device__ __forceinline__ void store_rows(TO* dst, const float (&acc)[DH / 8][4],
                                           const float (&r)[2], int r0, int rows, int ld,
                                           int c0, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    const int col = c0 + nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + g + 8 * half;
      if (row >= rows) continue;
      TO* p = dst + (size_t)row * ld + col;
      const float x = acc[nt][2 * half] * r[half], y = acc[nt][2 * half + 1] * r[half];
      if (!PAD) {
        put2(p, x, y);
      } else {
        if (col < ld) put1(p, x);
        if (col + 1 < ld) put1(p + 1, y);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Shared memory (dynamic) of each kernel
// ---------------------------------------------------------------------------

template <typename T, int DH>
struct FwdSmem {
  static constexpr int KT = tile_rows<T, DH>(), SS = DH + Ops<T>::kPad;
  T q[kRows * SS];
  T k[2][KT * SS];
  T v[2][KT * SS];
  float b[2][KT];
};

template <typename T, int DH>
struct DqSmem {
  static constexpr int KT = tile_rows<T, DH>(), SS = DH + Ops<T>::kPad;
  T q[kRows * SS], d[kRows * SS];
  T k[2][KT * SS];   // above Dh 128: the chunk, then the dQ slice
  T v[2][KT * SS];
  float b[2][KT];
};

template <typename T, int DH, int PART>
struct DkdvSmem {
  static constexpr int QT = tile_rows<T, DH>(), SS = DH + Ops<T>::kPad;
  T k[kRows * SS];
  T v[(PART == kOnlyDv ? 1 : kRows) * SS];
  T q[2][QT * SS];   // above Dh 128: the chunk, then the dK slice
  T d[2][QT * SS];   // above Dh 128: the chunk, then the dV slice
  float st[2][QT * 3];
};

template <typename Kernel>
cudaError_t opt_in(Kernel kern, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the units of a block's loop: (tile, chunk) pairs, chunk fastest.  One
// chunk (Dh <= 128): the next tile is staged while this one is used (two
// buffers).  Several (wide): each unit is staged and waited for in turn
// (buffer 0, and buffer 1 for the slice a product reads).
template <bool WIDE, typename Stage>
__device__ __forceinline__ void wait_unit(Stage& stage, int u, int units) {
  if (WIDE) {
    stage(u);
    cp_async_wait<0>();
  } else if (u + 1 < units) {
    stage(u + 1);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
}

// ---------------------------------------------------------------------------
// The forward: one block per (image, head, 64 query rows, output slice);
// one sweep over the key tiles with online softmax.  STATS: each row's
// final (max, 1/sum), (B, H, Lq, 2)
// ---------------------------------------------------------------------------

template <typename T, typename TO, int DH, bool PAD, bool WIDE, bool STATS>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ kbias, TO* __restrict__ out,
                float* __restrict__ stats, int H, int Lq, int Lk, int ld, float scale) {
  using L = FwdSmem<T, DH>;
  constexpr int KT = L::KT, SS = L::SS, NT = DH / 8, ST = KT / 8;
  L& sm = dynamic_block<L>();
  const int rw = PAD ? ld : DH;   // the row width in global memory
  const int nc = WIDE ? slices<DH>(rw) : 1;   // 128-column chunks of a row
  constexpr bool wide = WIDE;
  const int c_out = blockIdx.z * DH;   // this block's output columns

  const int bh = blockIdx.y, b = bh / H, q0 = blockIdx.x * kRows, nq = min(kRows, Lq - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* qb = q + ((size_t)bh * Lq + q0) * rw;
  const T* kb = k + (size_t)bh * Lk * rw;
  const T* vb = v + (size_t)bh * Lk * rw;
  const float* bias = kbias + (size_t)b * padded(Lk);
  const int units = (Lk + KT - 1) / KT * nc;

  auto stage = [&](int u) {
    const int it = u / nc, c = u % nc, j0 = it * KT, n = min(KT, Lk - j0);
    const int s = wide ? 0 : it & 1;
    if (wide || u == 0) stage_tile<T, DH, kRows, SS, kThreads>(sm.q, qb, nq, rw, c * DH, tid);
    stage_tile<T, DH, KT, SS, kThreads>(sm.k[s], kb + (size_t)j0 * rw, n, rw, c * DH, tid);
    if (c == nc - 1) {
      stage_tile<T, DH, KT, SS, kThreads>(sm.v[s], vb + (size_t)j0 * rw, n, rw, c_out, tid);
      if (tid < KT / 4) cp_async16(sm.b[s] + 4 * tid, bias + j0 + 4 * tid, 16);
    }
    cp_async_commit();
  };
  if (!wide) stage(0);

  // rows g and g + 8 of this warp's 16: running max, sum, P V
  float m0 = kFloor, m1 = kFloor, l0 = 0.f, l1 = 0.f;
  float o[NT][4], sc[ST][4];
  zero(o);
  for (int u = 0; u < units; ++u) {
    const int it = u / nc, c = u % nc, s = wide ? 0 : it & 1;
    wait_unit<WIDE>(stage, u, units);
    if (scale != 1.f && (wide || u == 0)) scale_tile<T, DH, kRows, SS, kThreads>(sm.q, scale, tid);
    __syncthreads();
    if (c == 0) zero(sc);
    product_bt<T, DH, SS>(sc, sm.q, warp * 16, sm.k[s], g, t);
    if (c == nc - 1) {
      const float* bs = sm.b[s];
      float n0 = m0, n1 = m1;
#pragma unroll
      for (int nt = 0; nt < ST; ++nt) {
        const float b0 = bs[nt * 8 + 2 * t], b1 = bs[nt * 8 + 2 * t + 1];
        sc[nt][0] += b0;
        sc[nt][1] += b1;
        sc[nt][2] += b0;
        sc[nt][3] += b1;
        n0 = fmaxf(n0, fmaxf(sc[nt][0], sc[nt][1]));
        n1 = fmaxf(n1, fmaxf(sc[nt][2], sc[nt][3]));
      }
      n0 = quad_max(n0);
      n1 = quad_max(n1);
      const float a0 = expf(m0 - n0), a1 = expf(m1 - n1);   // 1 while the max holds
      m0 = n0;
      m1 = n1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        o[nt][0] *= a0;
        o[nt][1] *= a0;
        o[nt][2] *= a1;
        o[nt][3] *= a1;
      }
#pragma unroll
      for (int nt = 0; nt < ST; ++nt) {
        sc[nt][0] = expf(sc[nt][0] - m0);
        sc[nt][1] = expf(sc[nt][1] - m0);
        sc[nt][2] = expf(sc[nt][2] - m1);
        sc[nt][3] = expf(sc[nt][3] - m1);
        l0 += sc[nt][0] + sc[nt][1];
        l1 += sc[nt][2] + sc[nt][3];
      }
      add_product<T, DH, SS, KT>(o, sc, sm.v[s], g, t);
    }
    __syncthreads();
  }
  const float r[2] = {1.f / fmaxf(quad_sum(l0), 1e-30f), 1.f / fmaxf(quad_sum(l1), 1e-30f)};
  const int r0 = q0 + warp * 16;
  store_rows<TO, DH, PAD>(out + (size_t)bh * Lq * rw, o, r, r0, Lq, rw, c_out, g, t);
  if (STATS && blockIdx.z == 0 && t == 0) {   // K1: each row's final (max, 1/sum)
    float* st = stats + ((size_t)bh * Lq + r0 + g) * 2;
    if (r0 + g < Lq) { st[0] = m0; st[1] = r[0]; }
    if (r0 + g + 8 < Lq) { st[16] = m1; st[17] = r[1]; }
  }
}

// ---------------------------------------------------------------------------
// dQ and the row statistics for 64 query rows of one (image, head) and one
// output slice: sweep 1 over the keys takes each row's max, sum and
// sum(exp * dP) online; sweep 2 forms dS and accumulates dQ = dS K
// ---------------------------------------------------------------------------

template <typename T, int DH, bool PAD, bool WIDE>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ kbias,
                   float* __restrict__ dq, float* __restrict__ stats, int H, int Lq, int Lk,
                   int ld, float scale) {
  using L = DqSmem<T, DH>;
  constexpr int KT = L::KT, SS = L::SS, NT = DH / 8, ST = KT / 8;
  L& sm = dynamic_block<L>();
  const int rw = PAD ? ld : DH;
  const int nc = WIDE ? slices<DH>(rw) : 1;   // 128-column chunks of a row
  constexpr bool wide = WIDE;
  const int c_out = blockIdx.z * DH;

  const int bh = blockIdx.y, b = bh / H, q0 = blockIdx.x * kRows, nq = min(kRows, Lq - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = (size_t)bh * Lq + q0;
  const T* kb = k + (size_t)bh * Lk * rw;
  const T* vb = v + (size_t)bh * Lk * rw;
  const float* bias = kbias + (size_t)b * padded(Lk);
  const int ntiles = (Lk + KT - 1) / KT, units = 2 * ntiles * nc;

  auto stage = [&](int u) {   // both sweeps in one pipeline
    const int it2 = u / nc, c = u % nc, j0 = (it2 % ntiles) * KT, n = min(KT, Lk - j0);
    const int s = wide ? 0 : it2 & 1;
    if (wide || u == 0) {
      stage_tile<T, DH, kRows, SS, kThreads>(sm.q, q + row0 * rw, nq, rw, c * DH, tid);
      stage_tile<T, DH, kRows, SS, kThreads>(sm.d, dout + row0 * rw, nq, rw, c * DH, tid);
    }
    stage_tile<T, DH, KT, SS, kThreads>(sm.k[s], kb + (size_t)j0 * rw, n, rw, c * DH, tid);
    stage_tile<T, DH, KT, SS, kThreads>(sm.v[s], vb + (size_t)j0 * rw, n, rw, c * DH, tid);
    if (c == nc - 1) {
      if (tid < KT / 4) cp_async16(sm.b[s] + 4 * tid, bias + j0 + 4 * tid, 16);
      if (wide && it2 >= ntiles)   // the slice of K that dQ's slice takes
        stage_tile<T, DH, KT, SS, kThreads>(sm.k[1], kb + (size_t)j0 * rw, n, rw, c_out, tid);
    }
    cp_async_commit();
  };
  if (!wide) stage(0);

  // rows g and g + 8: max, sum (then 1/sum), sum(exp * dP) (then delta)
  float m0 = kFloor, m1 = kFloor, l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;
  float acc[NT][4], sc[ST][4], dp[ST][4];
  zero(acc);
  for (int u = 0; u < units; ++u) {
    const int it2 = u / nc, c = u % nc, s = wide ? 0 : it2 & 1;
    wait_unit<WIDE>(stage, u, units);
    if (scale != 1.f && (wide || u == 0)) scale_tile<T, DH, kRows, SS, kThreads>(sm.q, scale, tid);
    __syncthreads();
    if (c == 0) {
      zero(sc);
      zero(dp);
    }
    product_bt<T, DH, SS>(sc, sm.q, warp * 16, sm.k[s], g, t);
    product_bt<T, DH, SS>(dp, sm.d, warp * 16, sm.v[s], g, t);
    if (c == nc - 1) {
      const float* bs = sm.b[s];
#pragma unroll
      for (int nt = 0; nt < ST; ++nt) {
        const float b0 = bs[nt * 8 + 2 * t], b1 = bs[nt * 8 + 2 * t + 1];
        sc[nt][0] += b0;
        sc[nt][1] += b1;
        sc[nt][2] += b0;
        sc[nt][3] += b1;
      }
      if (it2 < ntiles) {   // uniform across the block
        float n0 = m0, n1 = m1;
#pragma unroll
        for (int nt = 0; nt < ST; ++nt) {
          n0 = fmaxf(n0, fmaxf(sc[nt][0], sc[nt][1]));
          n1 = fmaxf(n1, fmaxf(sc[nt][2], sc[nt][3]));
        }
        n0 = quad_max(n0);
        n1 = quad_max(n1);
        const float a0 = expf(m0 - n0), a1 = expf(m1 - n1);
        m0 = n0;
        m1 = n1;
        l0 *= a0;
        d0 *= a0;
        l1 *= a1;
        d1 *= a1;
#pragma unroll
        for (int nt = 0; nt < ST; ++nt) {
          const float e0 = expf(sc[nt][0] - m0), e1 = expf(sc[nt][1] - m0);
          const float e2 = expf(sc[nt][2] - m1), e3 = expf(sc[nt][3] - m1);
          l0 += e0 + e1;
          l1 += e2 + e3;
          d0 = fmaf(e1, dp[nt][1], fmaf(e0, dp[nt][0], d0));
          d1 = fmaf(e3, dp[nt][3], fmaf(e2, dp[nt][2], d1));
        }
      } else {
        if (it2 == ntiles) {
          l0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
          l1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
          d0 = quad_sum(d0) * l0;
          d1 = quad_sum(d1) * l1;
        }
#pragma unroll
        for (int nt = 0; nt < ST; ++nt) {   // dS = P (dP - delta), in place of S
          sc[nt][0] = expf(sc[nt][0] - m0) * l0 * (dp[nt][0] - d0);
          sc[nt][1] = expf(sc[nt][1] - m0) * l0 * (dp[nt][1] - d0);
          sc[nt][2] = expf(sc[nt][2] - m1) * l1 * (dp[nt][2] - d1);
          sc[nt][3] = expf(sc[nt][3] - m1) * l1 * (dp[nt][3] - d1);
        }
        add_product<T, DH, SS, KT>(acc, sc, wide ? sm.k[1] : sm.k[s], g, t);
      }
    }
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  const int r0 = q0 + warp * 16;
  store_rows<float, DH, PAD>(dq + (size_t)bh * Lq * rw, acc, one, r0, Lq, rw, c_out, g, t);
  if (blockIdx.z == 0 && t == 0) {
    float* st = stats + ((size_t)bh * Lq + r0 + g) * 3;
    if (r0 + g < Lq) { st[0] = m0; st[1] = l0; st[2] = d0; }
    if (r0 + g + 8 < Lq) { st[24] = m1; st[25] = l1; st[26] = d1; }
  }
}

// ---------------------------------------------------------------------------
// dK = dS^T q and dV = P^T dO for 64 keys of one (image, head) and one
// output slice, 16 per warp, summed over the query tiles from the row
// statistics: S^T = K q^T and dP^T = V dO^T give P^T and dS^T in the
// accumulators, which are the next products' A operands.  PART: both
// (kBoth), or only dK or only dV (Dh 128 and above, two launches)
// ---------------------------------------------------------------------------

template <typename T, int DH, bool PAD, bool WIDE, int PART>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ kbias, const float* __restrict__ stats,
                     float* __restrict__ dk, float* __restrict__ dv, int H, int Lq, int Lk,
                     int ld, float scale) {
  using L = DkdvSmem<T, DH, PART>;
  constexpr int QT = L::QT, SS = L::SS, NT = DH / 8, ST = QT / 8;
  constexpr bool kDk = PART != kOnlyDv, kDv = PART != kOnlyDk;
  L& sm = dynamic_block<L>();
  const int rw = PAD ? ld : DH;
  const int nc = WIDE ? slices<DH>(rw) : 1;   // 128-column chunks of a row
  constexpr bool wide = WIDE;
  const int c_out = blockIdx.z * DH;

  const int bh = blockIdx.y, b = bh / H, j0 = blockIdx.x * kRows, nk = min(kRows, Lk - j0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t kbase = (size_t)bh * Lk + j0;
  const T* qb = q + (size_t)bh * Lq * rw;
  const T* db = dout + (size_t)bh * Lq * rw;
  const float* sb = stats + (size_t)bh * Lq * 3;
  const int ntiles = (Lq + QT - 1) / QT, units = ntiles * nc;

  auto stage = [&](int u) {
    const int it = u / nc, c = u % nc, i0 = it * QT, n = min(QT, Lq - i0);
    const int s = wide ? 0 : it & 1;
    if (wide || u == 0) {
      stage_tile<T, DH, kRows, SS, kThreads>(sm.k, k + kbase * rw, nk, rw, c * DH, tid);
      if (kDk) stage_tile<T, DH, kRows, SS, kThreads>(sm.v, v + kbase * rw, nk, rw, c * DH, tid);
    }
    stage_tile<T, DH, QT, SS, kThreads>(sm.q[s], qb + (size_t)i0 * rw, n, rw, c * DH, tid);
    if (kDk || !wide) stage_tile<T, DH, QT, SS, kThreads>(sm.d[s], db + (size_t)i0 * rw, n, rw, c * DH, tid);
    if (c == nc - 1) {
      // rows past Lq get zero statistics: 1/sum = 0, so their P and dS are 0
      for (int i = tid; i < QT * 3; i += kThreads) {
        const bool in = i < n * 3;
        cp_async4(sm.st[s] + i, sb + (size_t)i0 * 3 + (in ? i : 0), in ? 4 : 0);
      }
      if (wide) {   // the slices of q and dO that dK's and dV's slices take
        if (kDk) stage_tile<T, DH, QT, SS, kThreads>(sm.q[1], qb + (size_t)i0 * rw, n, rw, c_out, tid);
        if (kDv) stage_tile<T, DH, QT, SS, kThreads>(sm.d[1], db + (size_t)i0 * rw, n, rw, c_out, tid);
      }
    }
    cp_async_commit();
  };
  if (!wide) stage(0);

  // keys past Lk carry the padding's -1e30: their P and dS are exactly 0
  const int key0 = j0 + warp * 16 + g;
  const float bk[2] = {kbias[(size_t)b * padded(Lk) + key0],
                       kbias[(size_t)b * padded(Lk) + key0 + 8]};
  // a part's unused accumulator is never touched and takes no registers
  float adk[NT][4], adv[NT][4], cs[ST][4], cp[ST][4];
  if (kDk) zero(adk);
  if (kDv) zero(adv);
  for (int u = 0; u < units; ++u) {
    const int it = u / nc, c = u % nc, s = wide ? 0 : it & 1;
    wait_unit<WIDE>(stage, u, units);
    if (scale != 1.f) {
      scale_tile<T, DH, QT, SS, kThreads>(sm.q[s], scale, tid);
      if (kDk && wide && c == nc - 1) scale_tile<T, DH, QT, SS, kThreads>(sm.q[1], scale, tid);
    }
    __syncthreads();
    if (c == 0) {
      zero(cs);
      if (kDk) zero(cp);
    }
    product_bt<T, DH, SS>(cs, sm.k, warp * 16, sm.q[s], g, t);
    if (kDk) product_bt<T, DH, SS>(cp, sm.v, warp * 16, sm.d[s], g, t);
    if (c == nc - 1) {
      const float* st = sm.st[s];
      // element (key g + 8 half, query 8 nt + 2t + e) is cs[nt][2 half + e]
#pragma unroll
      for (int nt = 0; nt < ST; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float* sr = st + (nt * 8 + 2 * t + e) * 3;
            const float p = expf(cs[nt][2 * half + e] + bk[half] - sr[0]) * sr[1];
            if (kDk) cp[nt][2 * half + e] = p * (cp[nt][2 * half + e] - sr[2]);
            cs[nt][2 * half + e] = p;
          }
        }
      }
      if (kDk) add_product<T, DH, SS, QT>(adk, cp, wide ? sm.q[1] : sm.q[s], g, t);
      if (kDv) add_product<T, DH, SS, QT>(adv, cs, wide ? sm.d[1] : sm.d[s], g, t);
    }
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  if (kDk) store_rows<float, DH, PAD>(dk + (size_t)bh * Lk * rw, adk, one, j0 + warp * 16, Lk, rw,
                                      c_out, g, t);
  if (kDv) store_rows<float, DH, PAD>(dv + (size_t)bh * Lk * rw, adv, one, j0 + warp * 16, Lk, rw,
                                      c_out, g, t);
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

template <typename T, typename TO, int DH, bool PAD, bool WIDE = false>
cudaError_t launch_fwd(const T* q, const T* k, const T* v, const float* kbias, TO* out,
                       float* stats, int B, int H, int Lq, int Lk, int ld, float scale,
                       cudaStream_t s) {
  const dim3 grid((Lq + kRows - 1) / kRows, B * H, WIDE ? slices<DH>(ld) : 1);
  constexpr int smem = sizeof(FwdSmem<T, DH>);
  cudaError_t e;
  if (stats) {
    auto kern = attn_fwd_kernel<T, TO, DH, PAD, WIDE, true>;
    if ((e = opt_in(kern, smem)) != cudaSuccess) return e;
    kern<<<grid, kThreads, smem, s>>>(q, k, v, kbias, out, stats, H, Lq, Lk, ld, scale);
  } else {
    auto kern = attn_fwd_kernel<T, TO, DH, PAD, WIDE, false>;
    if ((e = opt_in(kern, smem)) != cudaSuccess) return e;
    kern<<<grid, kThreads, smem, s>>>(q, k, v, kbias, out, nullptr, H, Lq, Lk, ld, scale);
  }
  return cudaGetLastError();
}

template <typename T, int DH, bool PAD, bool WIDE, int PART>
cudaError_t launch_dkdv(const T* q, const T* k, const T* v, const T* dout, const float* kbias,
                        const float* stats, float* dk, float* dv, int B, int H, int Lq, int Lk,
                        int ld, float scale, cudaStream_t s) {
  auto kern = attn_bwd_dkdv_kernel<T, DH, PAD, WIDE, PART>;
  constexpr int smem = sizeof(DkdvSmem<T, DH, PART>);
  const cudaError_t e = opt_in(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((Lk + kRows - 1) / kRows, B * H, WIDE ? slices<DH>(ld) : 1), kThreads, smem, s>>>(
      q, k, v, dout, kbias, stats, dk, dv, H, Lq, Lk, ld, scale);
  return cudaGetLastError();
}

template <typename T, int DH, bool PAD, bool WIDE = false>
cudaError_t launch_bwd(const T* q, const T* k, const T* v, const T* dout, const float* kbias,
                       float* dq, float* dk, float* dv, float* stats, int B, int H, int Lq,
                       int Lk, int ld, float scale, cudaStream_t s) {
  auto kern = attn_bwd_dq_kernel<T, DH, PAD, WIDE>;
  constexpr int smem = sizeof(DqSmem<T, DH>);
  cudaError_t e = opt_in(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((Lq + kRows - 1) / kRows, B * H, WIDE ? slices<DH>(ld) : 1), kThreads, smem, s>>>(
      q, k, v, dout, kbias, dq, stats, H, Lq, Lk, ld, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if constexpr (DH < kSlice) {
    return launch_dkdv<T, DH, PAD, WIDE, kBoth>(q, k, v, dout, kbias, stats, dk, dv, B, H, Lq, Lk,
                                          ld, scale, s);
  } else {   // two 128-wide accumulators would spill: dK and dV in turn
    e = launch_dkdv<T, DH, PAD, WIDE, kOnlyDk>(q, k, v, dout, kbias, stats, dk, dv, B, H, Lq, Lk, ld,
                                         scale, s);
    if (e != cudaSuccess) return e;
    return launch_dkdv<T, DH, PAD, WIDE, kOnlyDv>(q, k, v, dout, kbias, stats, dk, dv, B, H, Lq, Lk,
                                            ld, scale, s);
  }
}

}  // namespace

// fp32 forward (K6, K2, and K1's first launch): q (unscaled: scaled by
// `scale` as it is staged), k, v (B, H, L*, Dh) fp32, any Dh >= 1; kbias
// (B, Lk rounded up to 64) fp32, -1e30 in the padding; out (B, H, Lq, Dh)
// fp32; stats null, or (B, H, Lq, 2) fp32 for each row's (max, 1/sum)
extern "C" int xattn_fwd(const void* q, const void* k, const void* v, const void* kbias,
                         void* out, void* stats, int B, int H, int Lq, int Lk, int Dh,
                         float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* o = static_cast<float*>(out);
  float* st = static_cast<float*>(stats);
  if (Dh > kSlice)
    return launch_fwd<float, float, kSlice, true, true>(f(q), f(k), f(v), f(kbias), o, st, B, H,
                                                        Lq, Lk, Dh, scale, s);
#define F(DH, PAD) \
  launch_fwd<float, float, DH, PAD>(f(q), f(k), f(v), f(kbias), o, st, B, H, Lq, Lk, Dh, scale, s)
  WECLIP_DISPATCH_DH(Dh, F);
#undef F
}

// bf16 forward above Dh 128 (K2, K1's first launch and K6): q (scaled as
// bf16(float(q) * scale) as it is staged), k, v bf16; kbias as above; out
// (B, H, Lq, Dh) bf16, or fp32 where out_f32 (K6); stats as above
extern "C" int xattn_fwd_bf16(const void* q, const void* k, const void* v, const void* kbias,
                              void* out, void* stats, int B, int H, int Lq, int Lk, int Dh,
                              float scale, int out_f32, void* stream) {
  if (Dh <= kSlice) return cudaErrorInvalidValue;   // flash_attention.cu, hopper_attention.cu
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto c = [](const void* p) { return static_cast<const bf*>(p); };
  const float* kb = static_cast<const float*>(kbias);
  float* st = static_cast<float*>(stats);
  if (out_f32)
    return launch_fwd<bf, float, kSlice, true, true>(c(q), c(k), c(v), kb,
                                                     static_cast<float*>(out), st, B, H, Lq, Lk,
                                                     Dh, scale, s);
  return launch_fwd<bf, bf, kSlice, true, true>(c(q), c(k), c(v), kb, static_cast<bf*>(out), st,
                                                B, H, Lq, Lk, Dh, scale, s);
}

// fp32 backward (K3 and K3-rect), any (Lq, Lk) and Dh >= 1: q (unscaled:
// the attention runs on q * scale), k, v, dout fp32; kbias (B, Lk rounded
// up to 64); fp32 dq, dk, dv (w.r.t. the scaled q) and the (B, H, Lq, 3)
// row statistics (max, 1/sum, delta)
extern "C" int xattn_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const void* kbias, void* dq, void* dk, void* dv, void* stats, int B,
                         int H, int Lq, int Lk, int Dh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto m = [](void* p) { return static_cast<float*>(p); };
  if (Dh > kSlice)
    return launch_bwd<float, kSlice, true, true>(f(q), f(k), f(v), f(dout), f(kbias), m(dq),
                                                 m(dk), m(dv), m(stats), B, H, Lq, Lk, Dh,
                                                 scale, s);
#define F(DH, PAD)                                                                        \
  launch_bwd<float, DH, PAD>(f(q), f(k), f(v), f(dout), f(kbias), m(dq), m(dk), m(dv),     \
                             m(stats), B, H, Lq, Lk, Dh, scale, s)
  WECLIP_DISPATCH_DH(Dh, F);
#undef F
}

// bf16 backward above Dh 128: q (taken as bf16(float(q) * scale)), k, v,
// dout bf16; the rest as xattn_bwd
extern "C" int xattn_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                              const void* kbias, void* dq, void* dk, void* dv, void* stats,
                              int B, int H, int Lq, int Lk, int Dh, float scale, void* stream) {
  if (Dh <= kSlice) return cudaErrorInvalidValue;   // flash_attention.cu
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto c = [](const void* p) { return static_cast<const bf*>(p); };
  const auto m = [](void* p) { return static_cast<float*>(p); };
  return launch_bwd<bf, kSlice, true, true>(c(q), c(k), c(v), c(dout),
                                            static_cast<const float*>(kbias), m(dq), m(dk),
                                            m(dv), m(stats), B, H, Lq, Lk, Dh, scale, s);
}
