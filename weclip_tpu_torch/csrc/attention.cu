// The head-mean attention map of K1 under the fp32 score type, and under
// bf16 above head width 128, for sm_90a, on the tensor cores.  Plain C
// entry points, loaded with ctypes by weclip_tpu_torch/kernels.py; wrapper
// in ops/attention_kernels.py.  K1 under fp32 is two launches:
// cross_attention.cu's key-tiled forward, which writes each row's (max,
// 1/sum), then this map kernel.  Under bf16 K1 is flash_attention.cu's
// forward with row statistics plus its map kernel up to Dh 128, and
// cross_attention.cu's forward plus this map kernel above.
//
// Replaces (weclip_tpu/ops/pallas_attention.py), under fp32:
//   K1  attention_core_pallas(export_weights=True)   (_attn_kernel; :195, pallas_call :260)
//
// Numerics follow the Pallas kernel: q scaled as it is staged (x * scale in
// fp32; bf16(float(x) * scale) under bf16), fp32 scores, an additive -1e30
// key bias, and P = exp(s - max) * (1/sum) from the forward's final row
// statistics.  Each score is the forward's own: the same staging, the same
// products (common.cuh's weclip::tc::product_bt: three TF32 products of
// split operands under fp32, summed 32 columns at a time, each group added
// in fp32; one bf16 product a 128-column chunk under bf16) in the same
// order, so a score here equals the forward's bit for bit and P <= 1/sum
// (the operands are split by split_tf32_finite, cvt.rna's value for finite
// operands in fewer instructions).  A group of zero lanes past Dh adds
// exactly zero in the forward and is skipped here.
//
// What bounds it on the H100: operations.  At (4, 8, 1025, 128) it
// recomputes S, 2*B*H*L^2*Dh = 8.6 GFLOP, three TF32 products each (0.05 ms
// at 494.7 / 3 TFLOP/s), and writes the (B, L, L) map (17 MB, 5 us).
// Design: one block of 4 warps per (image, 64 query rows, 64 keys), 16 rows
// a warp, loops over the heads in order and over each head's row in units
// of one product group (32 columns, 16 at Dh <= 16; bf16: 128), staging
// the unit's q rows and keys (and, with a head's first unit, its row
// statistics) by cp.async, double-buffered, while the unit before is
// multiplied; the scores stay in mma accumulators, and each head's P is
// added to a head sum held in registers and stored once: any L, any Dh,
// deterministic, no atomics.  (The TPU kernel summed the map in an output
// block revisited across a sequential head axis.)

#include <type_traits>

#include "common.cuh"

using namespace weclip;
using namespace weclip::tc;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // query rows a block
constexpr int kKeys = 64;            // keys a block

// the key bias is padded to whole 64-key tiles
__host__ __device__ __forceinline__ int padded(int l) { return (l + 63) / 64 * 64; }

// a unit's tiles: UW columns of 64 query rows and 64 keys, two buffers;
// each head's row statistics, two buffers; the block's key bias
template <typename T, int UW>
struct MapSmem {
  static constexpr int SS = UW + Ops<T>::kPad;
  T q[2][kRows * SS];
  T k[2][kKeys * SS];
  float st[2][kRows * 2];
  float b[kKeys];
};

template <typename T, int UW>
__global__ void __launch_bounds__(kThreads)
attn_map_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const float* __restrict__ kbias, const float* __restrict__ stats,
                    float* __restrict__ map, int H, int L, int ld, float scale) {
  using S = MapSmem<T, UW>;
  constexpr int SS = S::SS, NK = kKeys / 8;
  // fp32: the forward's split for finite operands, in fewer instructions
  using M = std::conditional_t<sizeof(T) == 4, OpsFinite, Ops<T>>;
  S& sm = dynamic_block<S>();
  const int nc = (ld + UW - 1) / UW;   // units a head
  const int b = blockIdx.z, q0 = blockIdx.y * kRows, j0 = blockIdx.x * kKeys;
  const int nq = min(kRows, L - q0), nk = min(kKeys, L - j0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int units = H * nc;

  auto stage = [&](int u) {
    const int h = u / nc, c = u % nc, s = u & 1;
    const size_t base = ((size_t)b * H + h) * L;
    stage_tile<T, UW, kRows, SS, kThreads>(sm.q[s], q + (base + q0) * ld, nq, ld, c * UW, tid);
    stage_tile<T, UW, kKeys, SS, kThreads>(sm.k[s], k + (base + j0) * ld, nk, ld, c * UW, tid);
    if (c == 0) {   // rows past L get zero statistics (their map entries are not stored)
      static_assert(kThreads == kRows * 2, "one statistic a thread");
      const bool in = tid < nq * 2;
      cp_async4(sm.st[h & 1] + tid, stats + (base + q0) * 2 + (in ? tid : 0), in ? 4 : 0);
    }
    cp_async_commit();
  };
  // the key bias (padded to whole tiles) is the same for every head
  if (tid < kKeys / 4) cp_async16(sm.b + 4 * tid, kbias + (size_t)b * padded(L) + j0 + 4 * tid, 16);
  stage(0);

  float sc[NK][4], acc[NK][4];
  zero(acc);
  for (int u = 0; u < units; ++u) {
    const int h = u / nc, c = u % nc, s = u & 1;
    if (u + 1 < units) {
      stage(u + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (scale != 1.f) scale_tile<T, UW, kRows, SS, kThreads>(sm.q[s], scale, tid);
    __syncthreads();
    if (c == 0) zero(sc);
    product_bt<T, UW, SS, NK, M>(sc, sm.q[s], warp * 16, sm.k[s], g, t);
    if (c == nc - 1) {
      const float* st = sm.st[h & 1] + (warp * 16 + g) * 2;
      const float m0 = st[0], r0 = st[1], m1 = st[16], r1 = st[17];
#pragma unroll
      for (int nt = 0; nt < NK; ++nt) {
        const float b0 = sm.b[nt * 8 + 2 * t], b1 = sm.b[nt * 8 + 2 * t + 1];
        acc[nt][0] += expf((sc[nt][0] + b0) - m0) * r0;
        acc[nt][1] += expf((sc[nt][1] + b1) - m0) * r0;
        acc[nt][2] += expf((sc[nt][2] + b0) - m1) * r1;
        acc[nt][3] += expf((sc[nt][3] + b1) - m1) * r1;
      }
    }
    __syncthreads();
  }
  const float inv_h = 1.f / (float)H;
  float* dst = map + (size_t)b * L * L;
#pragma unroll
  for (int nt = 0; nt < NK; ++nt) {
    const int col = j0 + nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + warp * 16 + g + 8 * half;
      if (row >= L) continue;
      float* p = dst + (size_t)row * L + col;
      const float x0 = acc[nt][2 * half] * inv_h, x1 = acc[nt][2 * half + 1] * inv_h;
      if (!(L & 1) && col + 1 < L) {   // even L: (row * L + col) is even, 8-byte aligned
        *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
      } else {
        if (col < L) p[0] = x0;
        if (col + 1 < L) p[1] = x1;
      }
    }
  }
}

template <typename T, int UW>
cudaError_t launch_map(const T* q, const T* k, const float* kbias, const float* stats,
                       float* map, int B, int H, int L, int ld, float scale, cudaStream_t s) {
  auto kern = attn_map_mma_kernel<T, UW>;
  int smem = 0;
  const cudaError_t e = smem_bytes<MapSmem<T, UW>, false>(kern, &smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((L + kKeys - 1) / kKeys, (L + kRows - 1) / kRows, B), kThreads, smem, s>>>(
      q, k, kbias, stats, map, H, L, ld, scale);
  return cudaGetLastError();
}

}  // namespace

// K1's map under fp32: q (unscaled: scaled by `scale` as the forward
// staged it), k (B, H, L, Dh) fp32, any L and any Dh >= 1; kbias (B, L
// rounded up to 64) fp32, -1e30 in the padding; stats (B, H, L, 2) from
// cross_attention.cu's xattn_fwd; map (B, L, L) fp32, the mean over heads
// of P.  Units of 16 columns below Dh 17 (the forward's 16 instance), else
// of 32, the forward's product groups
extern "C" int attn_map_f32(const void* q, const void* k, const void* kbias, const void* stats,
                            void* map, int B, int H, int L, int Dh, float scale, void* stream) {
  if (Dh < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto c = [](const void* p) { return static_cast<const float*>(p); };
  float* m = static_cast<float*>(map);
  if (Dh <= 16)
    return launch_map<float, 16>(c(q), c(k), c(kbias), c(stats), m, B, H, L, Dh, scale, s);
  return launch_map<float, 32>(c(q), c(k), c(kbias), c(stats), m, B, H, L, Dh, scale, s);
}

// K1's map under bf16 above Dh 128: q (unscaled: taken as bf16(float(q) *
// scale)), k bf16; the rest as attn_map_f32, stats from cross_attention.cu's
// xattn_fwd_bf16; units of 128 columns, the forward's chunks
extern "C" int attn_map_bf16(const void* q, const void* k, const void* kbias, const void* stats,
                             void* map, int B, int H, int L, int Dh, float scale, void* stream) {
  if (Dh <= 128) return cudaErrorInvalidValue;   // flash_attention.cu's attn_map
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  return launch_map<bf16, 128>(qb, kb, f(kbias), f(stats), static_cast<float*>(map), B, H, L,
                               Dh, scale, s);
}
