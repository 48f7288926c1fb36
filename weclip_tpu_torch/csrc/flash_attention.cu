// Key-tiled ("flash") attention on the tensor cores for sm_90a: the bf16
// forward (K2, and K1 as that forward plus a map kernel) and the bf16
// backward for any (Lq, Lk) (K3 and K3-rect).  Plain C entry points,
// loaded with ctypes by weclip_tpu_torch/kernels.py; wrappers in
// ops/attention_kernels.py.  Under the fp32 score type, and under bf16
// above head width 128, K1's forward, K2 and the backward run
// cross_attention.cu's kernels, and K1's map attention.cu's.
//
// Replaces (weclip_tpu/ops/pallas_attention.py), under bf16:
//   K1       attention_core_pallas(export_weights=True)   (_attn_kernel; :195, pallas_call :260)
//   K2       attention_core_pallas(export_weights=False)  (the same kernel)
//   K3       attention_bwd_pallas, Lq == Lk               (_attn_bwd_kernel; :395, pallas_call :441)
//   K3-rect  attention_bwd_pallas, Lq != Lk               (the same function)
//
// Numerics follow the Pallas kernels: q rounded to bf16(float(q) * scale)
// as it is staged, fp32 scores and softmax, an additive -1e30 key bias
// (the wrapper pads it with -1e30 to whole 64-key tiles), the all-masked
// row guard max(smax, -5e29), denominator >= 1e-30.  Every product runs
// on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate) with
// its operands (q, k, v, dO, P, dS) in bf16.  The forward normalizes after
// P V with P rounded against the running max; the Pallas export path (K1,
// pallas_attention.py:141-145) normalizes first and then rounds P, so K1's
// output differs from it by at most one bf16 rounding of P, exactly as K2
// does (held to one bf16 ulp of the largest |out|).  K1's map is fp32 P
// from the forward's final (max, 1/sum).  The backward takes delta =
// sum(P * dP) as the plain version does, not rowsum(dO * O).
//
// What bounds them on the H100: operations.  K2 at (8, 12, 1025, 64) does
// 4*B*H*L^2*Dh = 25.8 GFLOP of products (26 us at the bf16 peak) and moves
// 25 MB (8 us).  K1 adds the (B, L, L) fp32 map (34 MB, 10 us) and its
// map kernel recomputes S (12.9 GFLOP) and one exp per score and head.  K3
// at the GradCAM shape (32, 12, 1025, 64) needs 10*B*H*L^2*Dh = 258 GFLOP
// (0.26 ms); this design runs 18*B*H*L^2*Dh (nine products where five are
// the minimum: S and dP three times each, for the row statistics, for dQ
// and for dK/dV), the price of determinism without atomics.
//
// Design.  No block keeps a whole score row: every kernel is one block of
// 4 warps (16 rows each) per (image, head or all heads, 64 rows), and
// loops over 64-row tiles of the other side (the map kernel: over heads),
// staged bf16 in shared memory with cp.async and double-buffered, so the
// next tile's loads run under this tile's products.  Scores live in mma
// accumulator registers, and each fragment is reused as the A operand of
// the next product (P V, dS K, P^T dO, dS^T q) without a trip through
// shared memory; B operands come from ldmatrix (.trans for the tiles read
// along keys).  A block needs under 47 KB of shared memory, so several fit
// on an SM, and any L runs.
// - K2, bf16: one sweep with online softmax; the accumulator is rescaled
//   when a tile raises the row max.
// - K1, bf16: K2's kernel instantiated with a statistics output (each
//   row's final max and 1/sum; K2's instantiation compiles without it),
//   then a map kernel per (image, 64 rows, 64 keys) that loops over the
//   heads in order, recomputes S bit-equal to the forward's, and keeps the
//   head sum of P in registers: one store of the map, deterministic, no
//   atomics.  (The TPU kernel summed the map in an output block revisited
//   across a sequential head axis, which Hopper's unordered blocks cannot.)
// - K3, bf16: a dQ kernel per 64 query rows makes two sweeps over the keys,
//   the first for each row's (max, sum, delta) online, the second for
//   dS = P (dP - delta) and dQ = dS K; it writes (max, 1/sum, delta).  A
//   dK/dV kernel per 64 keys loops over the query tiles with those
//   statistics.
//
// Head widths.  Every kernel is compiled at Dh 16, 32, 64 and 128 (DH).  A
// width Dh <= 128 that is not one of them (PAD) runs the next one up: its
// rows are read with the true row stride Dh, the lanes d >= Dh of every
// staged q, k, v and dO tile are zeros (which leave every product
// unchanged), and only the Dh true columns are written.  Rows whose width is
// a multiple of 8 are staged with cp.async as the exact widths are; other
// widths, whose rows are not 16-byte aligned, with plain loads.  At Dh 128
// the staged tiles outgrow the 48 KB of static shared memory, so those
// instances take theirs dynamically (common.cuh::static_or_dynamic); and
// the dK/dV kernel, whose two 128-wide accumulators would spill, runs as
// two launches, one for dK and one for dV, each recomputing S^T.  A wider
// head runs cross_attention.cu's bf16 kernels, in slices of 128 columns.

#include "common.cuh"

using namespace weclip;

namespace {

using bf = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // query rows (dK/dV: keys) per block
constexpr int kTile = 64;            // keys (dK/dV: query rows) per staged tile
constexpr float kFloor = -5e29f;     // the all-masked row guard of the max

// the key bias is padded to whole tiles
__device__ __forceinline__ int padded(int l) { return (l + kTile - 1) / kTile * kTile; }

__device__ __forceinline__ uint32_t scale2(uint32_t x, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack_bf16(f.x * s, f.y * s);
}

// eight bf16 values x -> bf16(float(x) * s)
__device__ __forceinline__ uint4 scale8(uint4 x, float s) {
  return make_uint4(scale2(x.x, s), scale2(x.y, s), scale2(x.z, s), scale2(x.w, s));
}

// eight bf16 values of columns [c, c + 8) of a row `ld` wide, zeros at
// columns >= ld; one 16-byte load where the row is 16-byte aligned
__device__ __forceinline__ uint4 load8(const bf* row, int c, int ld) {
  if (ld % 8 == 0) {
    if (c >= ld) return make_uint4(0u, 0u, 0u, 0u);
    return *reinterpret_cast<const uint4*>(row + c);
  }
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint16_t lo = c + 2 * i < ld ? reinterpret_cast<const uint16_t*>(row)[c + 2 * i] : 0;
    const uint16_t hi =
        c + 2 * i + 1 < ld ? reinterpret_cast<const uint16_t*>(row)[c + 2 * i + 1] : 0;
    w[i] = (uint32_t)lo | ((uint32_t)hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// rows [0, n) of a bf16 array into shared memory (row stride DH + 8) as
// bf16(x * scale), zeros in rows [n, kRows); plain loads.  The rows are DH
// wide, or (PAD) `ld` < DH wide with zeros staged in the lanes past ld
template <int DH, bool PAD>
__device__ __forceinline__ void stage_scaled(bf* dst, const bf* src, int n, int ld,
                                             float scale, int tid) {
  constexpr int kVec = DH / 8;
  for (int i = tid; i < kRows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (PAD) {
      if (r < n) x = scale8(load8(src + (size_t)r * ld, c, ld), scale);
    } else {
      if (r < n) x = scale8(*reinterpret_cast<const uint4*>(src + (size_t)r * DH + c), scale);
    }
    *reinterpret_cast<uint4*>(dst + r * (DH + 8) + c) = x;
  }
}

// the same without scaling, by cp.async (zeros in rows [n, kTile)); PAD
// rows whose width is not a multiple of 8 are copied by plain loads and
// stores, which the barrier that publishes the tile orders as it does the
// copies
template <int DH, bool PAD>
__device__ __forceinline__ void async_tile(bf* dst, const bf* src, int n, int ld, int tid) {
  constexpr int kVec = DH / 8;
  for (int i = tid; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    const bool in = r < n;
    if (!PAD) {
      cp_async16(dst + r * (DH + 8) + c, src + (size_t)(in ? r : 0) * DH + c, in ? 16 : 0);
    } else if (ld % 8 == 0) {
      const bool on = in && c < ld;
      cp_async16(dst + r * (DH + 8) + c, src + (size_t)(in ? r : 0) * ld + (on ? c : 0),
                 on ? 16 : 0);
    } else {
      *reinterpret_cast<uint4*>(dst + r * (DH + 8) + c) =
          in ? load8(src + (size_t)r * ld, c, ld) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// a tile staged by async_tile, rounded to bf16(x * scale) in place by the
// threads that copied each part (after their copies completed, before the
// barrier that publishes the tile)
template <int DH>
__device__ __forceinline__ void scale_tile(bf* tile, float scale, int tid) {
  constexpr int kVec = DH / 8;
  for (int i = tid; i < kTile * kVec; i += kThreads) {
    uint4* p = reinterpret_cast<uint4*>(tile + (i / kVec) * (DH + 8) + (i % kVec) * 8);
    *p = scale8(*p, scale);
  }
}

// the A fragments (rows [row0, row0 + 16), DH wide) of a staged tile
template <int DH>
__device__ __forceinline__ void load_a(uint32_t (&a)[DH / 16][4], const bf* s, int row0,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldsm_x4(a[kk], s + (row0 + (lane & 15)) * (DH + 8) + kk * 16 + (lane >> 4) * 8);
}

// c[h] = A (16 x DH) times rows [n0 + 8h, n0 + 8h + 8) of a staged tile,
// transposed: the 16 x 16 block of S = q K^T (or dP = dO V^T, or their
// transposes) at column n0
template <int DH>
__device__ __forceinline__ void product16(float (&c)[2][4], const uint32_t (&a)[DH / 16][4],
                                          const bf* tile, int n0, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) c[h][0] = c[h][1] = c[h][2] = c[h][3] = 0.f;
  const bf* p = tile + (n0 + (lane & 7) + (lane >> 4) * 8) * (DH + 8) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t b[4];
    ldsm_x4(b, p + kk * 16);
    mma_bf16(c[0], a[kk][0], a[kk][1], a[kk][2], a[kk][3], b[0], b[1]);
    mma_bf16(c[1], a[kk][0], a[kk][1], a[kk][2], a[kk][3], b[2], b[3]);
  }
}

// acc (16 x DH) += A (16 x 16) times rows [k0, k0 + 16) of a staged tile:
// P V, dS K, P^T dO or dS^T q
template <int DH>
__device__ __forceinline__ void accumulate(float (&acc)[DH / 8][4], const uint32_t (&a)[4],
                                           const bf* tile, int k0, int lane) {
  const bf* p = tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * (DH + 8) + (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < DH / 16; ++np) {
    uint32_t b[4];
    ldsm_x4_trans(b, p + np * 16);
    mma_bf16(acc[2 * np], a[0], a[1], a[2], a[3], b[0], b[1]);
    mma_bf16(acc[2 * np + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
  }
}

// fp32 (16 x DH) fragments to rows [r0, r0 + 16) of a row-major fp32 array
// (rows `ld` wide under PAD: only columns < ld), rows past `rows` skipped
template <int DH, bool PAD>
__device__ __forceinline__ void store_f32(float* dst, const float (&acc)[DH / 8][4], int r0,
                                          int rows, int ld, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (PAD) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + g + 8 * half;
        if (row >= rows) continue;
        float* p = dst + (size_t)row * ld + col;
        if (col < ld) p[0] = acc[nt][2 * half];
        if (col + 1 < ld) p[1] = acc[nt][2 * half + 1];
      }
      continue;
    }
    if (r0 + g < rows)
      *reinterpret_cast<float2*>(dst + (size_t)(r0 + g) * DH + col) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (r0 + g + 8 < rows)
      *reinterpret_cast<float2*>(dst + (size_t)(r0 + g + 8) * DH + col) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
}

template <int DH>
__device__ __forceinline__ void zero(float (&acc)[DH / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
}

// the dynamic layouts of each kernel's staged tiles at DH 128, where they
// outgrow static shared memory (row stride DH + 8)
constexpr int kMaxStaticDh = 64;

template <int DH>
struct FwdSmem {
  bf q[kRows * (DH + 8)];
  bf k[2][kTile * (DH + 8)];
  bf v[2][kTile * (DH + 8)];
};

template <int DH>
struct MapSmem {
  bf q[2][kRows * (DH + 8)];
  bf k[2][kTile * (DH + 8)];
};

template <int DH>
struct DqSmem {
  bf a[kRows * (DH + 8)];
  bf k[2][kTile * (DH + 8)];
  bf v[2][kTile * (DH + 8)];
};

template <int DH>
struct DkdvSmem {
  bf q[2][kTile * (DH + 8)];
  bf d[2][kTile * (DH + 8)];
};

// ---------------------------------------------------------------------------
// K2, bf16: one block per (image, head, 64 query rows); one sweep over
// 64-key tiles with online softmax
// ---------------------------------------------------------------------------

template <int DH, bool PAD, bool STATS>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const bf* __restrict__ q, const bf* __restrict__ k,
                     const bf* __restrict__ v, const float* __restrict__ kbias,
                     bf* __restrict__ out, float* __restrict__ stats, int H, int L,
                     int ld, float scale) {
  constexpr int KT = DH / 16, NT = DH / 8;
  constexpr bool kStatic = DH <= kMaxStaticDh;
  constexpr int QS = kStatic ? DH + 8 : 1;
  __shared__ __align__(16) bf q_st[kRows * QS];
  __shared__ __align__(16) bf k_st[2][kTile * QS];
  __shared__ __align__(16) bf v_st[2][kTile * QS];
  __shared__ __align__(16) float b_s[2][kTile];
  auto& q_s = static_or_dynamic<kStatic>(q_st, dynamic_block<FwdSmem<DH>>().q);
  auto& k_s = static_or_dynamic<kStatic>(k_st, dynamic_block<FwdSmem<DH>>().k);
  auto& v_s = static_or_dynamic<kStatic>(v_st, dynamic_block<FwdSmem<DH>>().v);
  const int rw = PAD ? ld : DH;   // the row width in global memory

  const int bh = blockIdx.y, b = bh / H, q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)bh * L;
  const bf* kb = k + base * rw;
  const bf* vb = v + base * rw;
  const float* bias = kbias + (size_t)b * padded(L);
  const int ntiles = (L + kTile - 1) / kTile;

  auto stage = [&](int it) {
    const int j0 = it * kTile, n = min(kTile, L - j0), s = it & 1;
    async_tile<DH, PAD>(k_s[s], kb + (size_t)j0 * rw, n, rw, tid);
    async_tile<DH, PAD>(v_s[s], vb + (size_t)j0 * rw, n, rw, tid);
    if (tid < kTile / 4) cp_async16(b_s[s] + 4 * tid, bias + j0 + 4 * tid, 16);
    cp_async_commit();
  };
  stage(0);
  stage_scaled<DH, PAD>(q_s, q + (base + q0) * rw, min(kRows, L - q0), rw, scale, tid);
  __syncthreads();
  uint32_t qa[KT][4];
  load_a<DH>(qa, q_s, warp * 16, lane);

  // rows g and g + 8 of this warp's 16: running max, sum, P V
  float m0 = kFloor, m1 = kFloor, l0 = 0.f, l1 = 0.f;
  float acc[NT][4];
  zero<DH>(acc);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it & 1;
    if (it + 1 < ntiles) {
      stage(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float sc[kTile / 16][2][4];
    float n0 = m0, n1 = m1;
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      product16<DH>(sc[kc], qa, k_s[s], kc * 16, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float b0 = b_s[s][kc * 16 + h * 8 + 2 * t], b1 = b_s[s][kc * 16 + h * 8 + 2 * t + 1];
        sc[kc][h][0] += b0;
        sc[kc][h][1] += b1;
        sc[kc][h][2] += b0;
        sc[kc][h][3] += b1;
        n0 = fmaxf(n0, fmaxf(sc[kc][h][0], sc[kc][h][1]));
        n1 = fmaxf(n1, fmaxf(sc[kc][h][2], sc[kc][h][3]));
      }
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
      acc[nt][0] *= a0;
      acc[nt][1] *= a0;
      acc[nt][2] *= a1;
      acc[nt][3] *= a1;
    }
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t pa[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float e0 = expf(sc[kc][h][0] - m0), e1 = expf(sc[kc][h][1] - m0);
        const float e2 = expf(sc[kc][h][2] - m1), e3 = expf(sc[kc][h][3] - m1);
        l0 += e0 + e1;
        l1 += e2 + e3;
        pa[2 * h] = pack_bf16(e0, e1);       // row g
        pa[2 * h + 1] = pack_bf16(e2, e3);   // row g + 8
      }
      accumulate<DH>(acc, pa, v_s[s], kc * 16, lane);
    }
    __syncthreads();
  }
  const float r0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float r1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  const int row = q0 + warp * 16 + g;
  bf* o = out + base * rw;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (PAD) {   // only the true columns
      const float x[4] = {acc[nt][0] * r0, acc[nt][1] * r0, acc[nt][2] * r1, acc[nt][3] * r1};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = row + 8 * (e >> 1), cc = col + (e & 1);
        if (rr < L && cc < rw) o[(size_t)rr * rw + cc] = __float2bfloat16_rn(x[e]);
      }
      continue;
    }
    if (row < L)
      *reinterpret_cast<__nv_bfloat162*>(o + (size_t)row * DH + col) =
          __floats2bfloat162_rn(acc[nt][0] * r0, acc[nt][1] * r0);
    if (row + 8 < L)
      *reinterpret_cast<__nv_bfloat162*>(o + (size_t)(row + 8) * DH + col) =
          __floats2bfloat162_rn(acc[nt][2] * r1, acc[nt][3] * r1);
  }
  if (STATS && t == 0) {   // K1: each row's final (max, 1/sum) for the map kernel
    float* st = stats + (base + row) * 2;
    if (row < L) { st[0] = m0; st[1] = r0; }
    if (row + 8 < L) { st[16] = m1; st[17] = r1; }
  }
}

// ---------------------------------------------------------------------------
// K1, bf16: the head-mean map from flash_fwd_mma_kernel's row statistics.
// One block per (image, 64 query rows, 64 keys), 16 rows per warp, looping
// over the heads in order 0..H-1; head h + 1's q rows, key tile and
// statistics are copied (cp.async) while head h's S = q K^T is recomputed
// exactly as the forward computes it (same staging, fragments and mma
// order, so each score is bit-equal and P <= 1/sum), and P = exp(s - max) *
// (1/sum) is added to a head sum held in registers
// ---------------------------------------------------------------------------

template <int DH, bool PAD>
__global__ void __launch_bounds__(kThreads)
attn_map_kernel(const bf* __restrict__ q, const bf* __restrict__ k,
                const float* __restrict__ kbias, const float* __restrict__ stats,
                float* __restrict__ map, int H, int L, int ld, float scale) {
  constexpr int KT = DH / 16;
  static_assert(kRows == kTile && kThreads == 2 * kRows,
                "q rows are staged as a key tile; one statistic per thread");
  constexpr bool kStatic = DH <= kMaxStaticDh;
  constexpr int QS = kStatic ? DH + 8 : 1;
  __shared__ __align__(16) bf q_st[2][kRows * QS];
  __shared__ __align__(16) bf k_st[2][kTile * QS];
  __shared__ __align__(16) float st_s[2][kRows * 2];
  __shared__ __align__(16) float b_s[kTile];
  auto& q_s = static_or_dynamic<kStatic>(q_st, dynamic_block<MapSmem<DH>>().q);
  auto& k_s = static_or_dynamic<kStatic>(k_st, dynamic_block<MapSmem<DH>>().k);
  const int rw = PAD ? ld : DH;

  const int b = blockIdx.z, q0 = blockIdx.y * kRows, j0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nq = min(kRows, L - q0), nk = min(kTile, L - j0);

  auto stage = [&](int h) {
    const size_t base = ((size_t)b * H + h) * L;
    const int s = h & 1;
    async_tile<DH, PAD>(q_s[s], q + (base + q0) * rw, nq, rw, tid);
    async_tile<DH, PAD>(k_s[s], k + (base + j0) * rw, nk, rw, tid);
    // rows past L get zero statistics (their map entries are not stored)
    const bool in = tid < nq * 2;
    cp_async4(st_s[s] + tid, stats + (base + q0) * 2 + (in ? tid : 0), in ? 4 : 0);
    cp_async_commit();
  };
  // the key bias (padded to whole tiles) is the same for every head
  if (tid < kTile / 4) cp_async16(b_s + 4 * tid, kbias + (size_t)b * padded(L) + j0 + 4 * tid, 16);
  stage(0);

  float acc[kTile / 16][2][4];
#pragma unroll
  for (int kc = 0; kc < kTile / 16; ++kc)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) acc[kc][hh][0] = acc[kc][hh][1] = acc[kc][hh][2] = acc[kc][hh][3] = 0.f;
  for (int h = 0; h < H; ++h) {
    const int s = h & 1;
    if (h + 1 < H) {
      stage(h + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    scale_tile<DH>(q_s[s], scale, tid);   // bf16(float(q) * scale), as the forward stages q
    __syncthreads();
    uint32_t qa[KT][4];
    load_a<DH>(qa, q_s[s], warp * 16, lane);
    const float* st = st_s[s] + (warp * 16 + g) * 2;
    const float m0 = st[0], r0 = st[1], m1 = st[16], r1 = st[17];
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      float sc[2][4];
      product16<DH>(sc, qa, k_s[s], kc * 16, lane);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float b0 = b_s[kc * 16 + hh * 8 + 2 * t], b1 = b_s[kc * 16 + hh * 8 + 2 * t + 1];
        acc[kc][hh][0] += expf((sc[hh][0] + b0) - m0) * r0;
        acc[kc][hh][1] += expf((sc[hh][1] + b1) - m0) * r0;
        acc[kc][hh][2] += expf((sc[hh][2] + b0) - m1) * r1;
        acc[kc][hh][3] += expf((sc[hh][3] + b1) - m1) * r1;
      }
    }
    __syncthreads();
  }
  const float inv_h = 1.f / (float)H;
  float* dst = map + (size_t)b * L * L;
#pragma unroll
  for (int kc = 0; kc < kTile / 16; ++kc) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int col = j0 + kc * 16 + hh * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = q0 + warp * 16 + g + 8 * half;
        if (row >= L) continue;
        float* p = dst + (size_t)row * L + col;
        const float x0 = acc[kc][hh][2 * half] * inv_h, x1 = acc[kc][hh][2 * half + 1] * inv_h;
        if (!(L & 1) && col + 1 < L) {   // even L: (row * L + col) is even, 8-byte aligned
          *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
        } else {
          if (col < L) p[0] = x0;
          if (col + 1 < L) p[1] = x1;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3, bf16: dQ and the row statistics for 64 query rows of one (image,
// head): sweep 1 over the keys takes each row's max, sum and
// sum(exp * dP) online; sweep 2 forms dS and accumulates dQ = dS K
// ---------------------------------------------------------------------------

template <int DH, bool PAD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf* __restrict__ q, const bf* __restrict__ k,
                    const bf* __restrict__ v, const bf* __restrict__ dout,
                    const float* __restrict__ kbias, float* __restrict__ dq,
                    float* __restrict__ stats, int H, int Lq, int Lk, int ld, float scale) {
  constexpr int KT = DH / 16, NT = DH / 8;
  constexpr bool kStatic = DH <= kMaxStaticDh;
  constexpr int QS = kStatic ? DH + 8 : 1;
  __shared__ __align__(16) bf a_st[kRows * QS];   // q, then dO
  __shared__ __align__(16) bf k_st[2][kTile * QS];
  __shared__ __align__(16) bf v_st[2][kTile * QS];
  __shared__ __align__(16) float b_s[2][kTile];
  auto& a_s = static_or_dynamic<kStatic>(a_st, dynamic_block<DqSmem<DH>>().a);
  auto& k_s = static_or_dynamic<kStatic>(k_st, dynamic_block<DqSmem<DH>>().k);
  auto& v_s = static_or_dynamic<kStatic>(v_st, dynamic_block<DqSmem<DH>>().v);
  const int rw = PAD ? ld : DH;

  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * kRows, nq = min(kRows, Lq - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf* kb = k + (size_t)bh * Lk * rw;
  const bf* vb = v + (size_t)bh * Lk * rw;
  const float* bias = kbias + (size_t)b * padded(Lk);
  const size_t row0 = (size_t)bh * Lq + q0;
  const int ntiles = (Lk + kTile - 1) / kTile;

  auto stage = [&](int it) {   // sweep-wide tile index: both sweeps in one pipeline
    const int j0 = (it % ntiles) * kTile, n = min(kTile, Lk - j0), s = it & 1;
    async_tile<DH, PAD>(k_s[s], kb + (size_t)j0 * rw, n, rw, tid);
    async_tile<DH, PAD>(v_s[s], vb + (size_t)j0 * rw, n, rw, tid);
    if (tid < kTile / 4) cp_async16(b_s[s] + 4 * tid, bias + j0 + 4 * tid, 16);
    cp_async_commit();
  };
  stage(0);
  uint32_t qa[KT][4], da[KT][4];
  stage_scaled<DH, PAD>(a_s, q + row0 * rw, nq, rw, scale, tid);
  __syncthreads();
  load_a<DH>(qa, a_s, warp * 16, lane);
  __syncthreads();
  stage_scaled<DH, PAD>(a_s, dout + row0 * rw, nq, rw, 1.f, tid);
  __syncthreads();
  load_a<DH>(da, a_s, warp * 16, lane);

  // rows g and g + 8: max, sum (then 1/sum), sum(exp * dP) (then delta)
  float m0 = kFloor, m1 = kFloor, l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;
  float acc[NT][4];
  zero<DH>(acc);
  for (int it = 0; it < 2 * ntiles; ++it) {
    const int s = it & 1;
    if (it + 1 < 2 * ntiles) {
      stage(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool stats_sweep = it < ntiles;   // uniform across the block
    if (it == ntiles) {
      l0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
      l1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
      d0 = quad_sum(d0) * l0;
      d1 = quad_sum(d1) * l1;
    }
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      float sc[2][4], dp[2][4];
      product16<DH>(sc, qa, k_s[s], kc * 16, lane);
      product16<DH>(dp, da, v_s[s], kc * 16, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float b0 = b_s[s][kc * 16 + h * 8 + 2 * t], b1 = b_s[s][kc * 16 + h * 8 + 2 * t + 1];
        sc[h][0] += b0;
        sc[h][1] += b1;
        sc[h][2] += b0;
        sc[h][3] += b1;
      }
      if (stats_sweep) {
        float n0 = m0, n1 = m1;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          n0 = fmaxf(n0, fmaxf(sc[h][0], sc[h][1]));
          n1 = fmaxf(n1, fmaxf(sc[h][2], sc[h][3]));
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
        for (int h = 0; h < 2; ++h) {
          const float e0 = expf(sc[h][0] - m0), e1 = expf(sc[h][1] - m0);
          const float e2 = expf(sc[h][2] - m1), e3 = expf(sc[h][3] - m1);
          l0 += e0 + e1;
          l1 += e2 + e3;
          d0 = fmaf(e1, dp[h][1], fmaf(e0, dp[h][0], d0));
          d1 = fmaf(e3, dp[h][3], fmaf(e2, dp[h][2], d1));
        }
      } else {
        uint32_t sa[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0 = expf(sc[h][0] - m0) * l0, p1 = expf(sc[h][1] - m0) * l0;
          const float p2 = expf(sc[h][2] - m1) * l1, p3 = expf(sc[h][3] - m1) * l1;
          sa[2 * h] = pack_bf16(p0 * (dp[h][0] - d0), p1 * (dp[h][1] - d0));
          sa[2 * h + 1] = pack_bf16(p2 * (dp[h][2] - d1), p3 * (dp[h][3] - d1));
        }
        accumulate<DH>(acc, sa, k_s[s], kc * 16, lane);
      }
    }
    __syncthreads();
  }
  store_f32<DH, PAD>(dq + (size_t)bh * Lq * rw, acc, q0 + warp * 16, Lq, rw, g, t);
  const int r = q0 + warp * 16 + g;
  if (t == 0) {
    float* st = stats + ((size_t)bh * Lq + r) * 3;
    if (r < Lq) { st[0] = m0; st[1] = l0; st[2] = d0; }
    if (r + 8 < Lq) { st[24] = m1; st[25] = l1; st[26] = d1; }
  }
}

// ---------------------------------------------------------------------------
// K3, bf16: dK = dS^T q and dV = P^T dO for 64 keys of one (image, head),
// 16 per warp, summed over 64-row query tiles from the row statistics:
// S^T = K q^T and dP^T = V dO^T give P^T and dS^T, reused as A operands.
// PART: both (kBoth), or only dK or only dV (Dh 128, two launches)
// ---------------------------------------------------------------------------

constexpr int kBoth = 0, kOnlyDk = 1, kOnlyDv = 2;

template <int DH, bool PAD, int PART>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const bf* __restrict__ q, const bf* __restrict__ k,
                      const bf* __restrict__ v, const bf* __restrict__ dout,
                      const float* __restrict__ kbias, const float* __restrict__ stats,
                      float* __restrict__ dk, float* __restrict__ dv, int H, int Lq, int Lk,
                      int ld, float scale) {
  constexpr int KT = DH / 16, NT = DH / 8;
  constexpr bool kDk = PART != kOnlyDv, kDv = PART != kOnlyDk;
  static_assert(kRows == kTile, "the key block is staged through a query tile buffer");
  constexpr bool kStatic = DH <= kMaxStaticDh;
  constexpr int QS = kStatic ? DH + 8 : 1;
  __shared__ __align__(16) bf q_st[2][kTile * QS];
  __shared__ __align__(16) bf do_st[2][kTile * QS];
  __shared__ __align__(16) float st_s[2][kTile * 3];
  auto& q_s = static_or_dynamic<kStatic>(q_st, dynamic_block<DkdvSmem<DH>>().q);
  auto& do_s = static_or_dynamic<kStatic>(do_st, dynamic_block<DkdvSmem<DH>>().d);
  const int rw = PAD ? ld : DH;

  const int bh = blockIdx.y, b = bh / H;
  const int j0 = blockIdx.x * kRows, nk = min(kRows, Lk - j0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qbase = (size_t)bh * Lq, kbase = (size_t)bh * Lk;
  const bf* qb = q + qbase * rw;
  const bf* dob = dout + qbase * rw;
  const float* sb = stats + qbase * 3;
  const int ntiles = (Lq + kTile - 1) / kTile;

  // this warp's 16 keys and values as A fragments, held for the whole loop
  stage_scaled<DH, PAD>(q_s[0], k + (kbase + j0) * rw, nk, rw, 1.f, tid);
  if (kDk) stage_scaled<DH, PAD>(do_s[0], v + (kbase + j0) * rw, nk, rw, 1.f, tid);
  __syncthreads();
  uint32_t ka[KT][4], va[KT][4];
  load_a<DH>(ka, q_s[0], warp * 16, lane);
  if (kDk) load_a<DH>(va, do_s[0], warp * 16, lane);
  const int key0 = j0 + warp * 16 + g;
  // keys past Lk carry the padding's -1e30: their P and dS are exactly 0
  const float bk[2] = {kbias[(size_t)b * padded(Lk) + key0],
                       kbias[(size_t)b * padded(Lk) + key0 + 8]};
  __syncthreads();

  auto stage = [&](int it) {
    const int i0 = it * kTile, n = min(kTile, Lq - i0), s = it & 1;
    async_tile<DH, PAD>(q_s[s], qb + (size_t)i0 * rw, n, rw, tid);
    async_tile<DH, PAD>(do_s[s], dob + (size_t)i0 * rw, n, rw, tid);
    // rows past Lq get zero statistics: 1/sum = 0, so their P and dS are 0
    for (int i = tid; i < kTile * 3; i += kThreads) {
      const bool in = i < n * 3;
      cp_async4(st_s[s] + i, sb + (size_t)i0 * 3 + (in ? i : 0), in ? 4 : 0);
    }
    cp_async_commit();
  };
  stage(0);

  // a part's unused accumulator is never touched and takes no registers
  float adk[NT][4], adv[NT][4];
  if (kDk) zero<DH>(adk);
  if (kDv) zero<DH>(adv);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it & 1;
    if (it + 1 < ntiles) {
      stage(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (scale != 1.f) scale_tile<DH>(q_s[s], scale, tid);
    __syncthreads();
    const int ni = min(kTile, Lq - it * kTile);
    for (int qc = 0; qc < ni; qc += 16) {
      float cs[2][4], cp[2][4];
      product16<DH>(cs, ka, q_s[s], qc, lane);
      if (kDk) product16<DH>(cp, va, do_s[s], qc, lane);
      // element (key g + 8 half, query qc + 8 j + 2 t + e) is fragment
      // a[2 j + half] of the 16-key x 16-query A operand
      uint32_t pa[4], sa[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float pv[2], sv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float* st = st_s[s] + (qc + 8 * j + 2 * t + e) * 3;
            const float p = expf(cs[j][2 * half + e] + bk[half] - st[0]) * st[1];
            pv[e] = p;
            if (kDk) sv[e] = p * (cp[j][2 * half + e] - st[2]);
          }
          pa[2 * j + half] = pack_bf16(pv[0], pv[1]);
          if (kDk) sa[2 * j + half] = pack_bf16(sv[0], sv[1]);
        }
      }
      if (kDk) accumulate<DH>(adk, sa, q_s[s], qc, lane);
      if (kDv) accumulate<DH>(adv, pa, do_s[s], qc, lane);
    }
    __syncthreads();
  }
  if (kDk) store_f32<DH, PAD>(dk + kbase * rw, adk, j0 + warp * 16, Lk, rw, g, t);
  if (kDv) store_f32<DH, PAD>(dv + kbase * rw, adv, j0 + warp * 16, Lk, rw, g, t);
}

template <int DH, bool PAD>
cudaError_t launch_fwd(const bf* q, const bf* k, const bf* v, const float* kbias, bf* out,
                       float* stats, int B, int H, int L, int ld, float scale,
                       cudaStream_t s) {
  const dim3 grid((L + kRows - 1) / kRows, B * H);
  int smem = 0;
  cudaError_t e;
  if (stats) {
    auto kern = flash_fwd_mma_kernel<DH, PAD, true>;
    if ((e = smem_bytes<FwdSmem<DH>, (DH <= kMaxStaticDh)>(kern, &smem)) != cudaSuccess) return e;
    kern<<<grid, kThreads, smem, s>>>(q, k, v, kbias, out, stats, H, L, ld, scale);
  } else {
    auto kern = flash_fwd_mma_kernel<DH, PAD, false>;
    if ((e = smem_bytes<FwdSmem<DH>, (DH <= kMaxStaticDh)>(kern, &smem)) != cudaSuccess) return e;
    kern<<<grid, kThreads, smem, s>>>(q, k, v, kbias, out, nullptr, H, L, ld, scale);
  }
  return cudaGetLastError();
}

template <int DH, bool PAD>
cudaError_t launch_map(const bf* q, const bf* k, const float* kbias, const float* stats,
                       float* map, int B, int H, int L, int ld, float scale, cudaStream_t s) {
  const int n = (L + kRows - 1) / kRows;
  auto kern = attn_map_kernel<DH, PAD>;
  int smem = 0;
  const cudaError_t e = smem_bytes<MapSmem<DH>, (DH <= kMaxStaticDh)>(kern, &smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(n, n, B), kThreads, smem, s>>>(q, k, kbias, stats, map, H, L, ld, scale);
  return cudaGetLastError();
}

template <int DH, bool PAD, int PART>
cudaError_t launch_dkdv(const bf* q, const bf* k, const bf* v, const bf* dout,
                        const float* kbias, const float* stats, float* dk, float* dv, int B,
                        int H, int Lq, int Lk, int ld, float scale, cudaStream_t s) {
  auto kern = flash_bwd_dkdv_kernel<DH, PAD, PART>;
  int smem = 0;
  const cudaError_t e = smem_bytes<DkdvSmem<DH>, (DH <= kMaxStaticDh)>(kern, &smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((Lk + kRows - 1) / kRows, B * H), kThreads, smem, s>>>(
      q, k, v, dout, kbias, stats, dk, dv, H, Lq, Lk, ld, scale);
  return cudaGetLastError();
}

template <int DH, bool PAD>
cudaError_t launch_bwd(const bf* q, const bf* k, const bf* v, const bf* dout,
                       const float* kbias, float* dq, float* dk, float* dv, float* stats,
                       int B, int H, int Lq, int Lk, int ld, float scale, cudaStream_t s) {
  auto kern = flash_bwd_dq_kernel<DH, PAD>;
  int smem = 0;
  cudaError_t e = smem_bytes<DqSmem<DH>, (DH <= kMaxStaticDh)>(kern, &smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((Lq + kRows - 1) / kRows, B * H), kThreads, smem, s>>>(
      q, k, v, dout, kbias, dq, stats, H, Lq, Lk, ld, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if constexpr (DH <= 64) {
    return launch_dkdv<DH, PAD, kBoth>(q, k, v, dout, kbias, stats, dk, dv, B, H, Lq, Lk, ld,
                                       scale, s);
  } else {   // two 128-wide accumulators would spill: dK and dV in turn
    e = launch_dkdv<DH, PAD, kOnlyDk>(q, k, v, dout, kbias, stats, dk, dv, B, H, Lq, Lk, ld,
                                      scale, s);
    if (e != cudaSuccess) return e;
    return launch_dkdv<DH, PAD, kOnlyDv>(q, k, v, dout, kbias, stats, dk, dv, B, H, Lq, Lk,
                                         ld, scale, s);
  }
}

}  // namespace

// K2 and K1's first launch, bf16: q (unscaled), k, v (B, H, L, Dh), any Dh
// in [1, 128]; kbias (B, L rounded up to 64) fp32, -1e30 in the padding;
// out (B, H, L, Dh) bf16; stats, null for K2, else (B, H, L, 2) fp32 for
// each row's (max, 1/sum)
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* kbias,
                         void* out, void* stats, int B, int H, int L, int Dh, float scale,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto c = [](const void* p) { return static_cast<const bf*>(p); };
  const float* kb = static_cast<const float*>(kbias);
  bf* o = static_cast<bf*>(out);
  float* st = static_cast<float*>(stats);
#define F(DH, PAD) launch_fwd<DH, PAD>(c(q), c(k), c(v), kb, o, st, B, H, L, Dh, scale, s)
  WECLIP_DISPATCH_DH(Dh, F);
#undef F
}

// K1's second launch, bf16: q (unscaled), k (B, H, L, Dh); kbias as above;
// stats from flash_fwd; map (B, L, L) fp32, the mean over heads of P
extern "C" int attn_map(const void* q, const void* k, const void* kbias, const void* stats,
                        void* map, int B, int H, int L, int Dh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto c = [](const void* p) { return static_cast<const bf*>(p); };
  const float* kb = static_cast<const float*>(kbias);
  const float* st = static_cast<const float*>(stats);
  float* m = static_cast<float*>(map);
#define F(DH, PAD) launch_map<DH, PAD>(c(q), c(k), kb, st, m, B, H, L, Dh, scale, s)
  WECLIP_DISPATCH_DH(Dh, F);
#undef F
}

// K3 / K3-rect, bf16: q (B, H, Lq, Dh), taken as bf16(q * scale); k, v
// (B, H, Lk, Dh); dout (B, H, Lq, Dh); kbias (B, Lk rounded up to 64) fp32;
// fp32 dq, dk, dv (w.r.t. the scaled q) and the (B, H, Lq, 3) row
// statistics (max, 1/sum, delta)
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const void* kbias, void* dq, void* dk, void* dv, void* stats,
                         int B, int H, int Lq, int Lk, int Dh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto c = [](const void* p) { return static_cast<const bf*>(p); };
  const auto m = [](void* p) { return static_cast<float*>(p); };
  const float* kb = static_cast<const float*>(kbias);
#define F(DH, PAD)                                                                        \
  launch_bwd<DH, PAD>(c(q), c(k), c(v), c(dout), kb, m(dq), m(dk), m(dv), m(stats), B, H, \
                      Lq, Lk, Dh, scale, s)
  WECLIP_DISPATCH_DH(Dh, F);
#undef F
}
