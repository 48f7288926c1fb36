// The frozen ViT block's elementwise passes, fused, over a bf16 residual
// stream, for sm_90a.  Plain C entry points, loaded with ctypes by
// weclip_tpu_torch/kernels.py; wrappers and their plain twins in
// ops/block_epilogue.py; the caller is models/clip/vit.py::frozen_block_forward.
//
// Replaces no TPU kernel: on the TPU, XLA fuses these passes into the
// products' epilogues by itself (weclip_tpu/models/clip/vit.py::block_forward
// has no pallas_call).  On the card each of them was its own torch kernel
// (bias broadcast adds, head-split copies, fp32 LayerNorm round trips,
// QuickGELU as three passes): about 164 D bytes a token a block beside the
// products, which ran at 2-3 TB/s in unvectorized kernels.
//
//   qkv_bias_split   reads the qkv product (rows x 3D) once, adds in_b as
//                    torch's bf16 add rounds it, bf16(float(g) + float(b)),
//                    and writes q, k and v in the (B, H, L, Dh) layout the
//                    attention kernels take: 12 D bytes a token.
//   residual_ln      y = x + bf16(rowmask ? bf16(float(g) + float(b)) : 0)
//                    (each term optional), written as bf16, and LN(y) with
//                    fp32 statistics, fp32 gamma and beta and one rounding
//                    to bf16: 8 D bytes a token with every term.
//   bias_quick_gelu  h = bf16(g + b), bf16(h * bf16(sigmoid(bf16(1.702 h))))
//                    in one pass over the 4D-wide hidden, in place:
//                    16 D bytes a token.  The rounding points are torch's
//                    (x * torch.sigmoid(1.702 * x) on a bf16 tensor, whose
//                    sigmoid is 1 / (1 + exp(-x)) in fp32).
//
// All three are bound by bytes (a few operations a byte).  Each thread
// moves 16-byte vectors of 8 bf16 values; D must be a multiple of 8 (so
// every vector lies in one of q, k, v and in one row) and the pointers
// 16-byte aligned, which the wrappers check.  residual_ln keeps a row in
// registers (one to four vectors a thread, up to 1024 threads a row) so the
// row is read from memory once: D up to 32768.
#include "common.cuh"

using namespace weclip;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;   // threads a block of the elementwise kernels
constexpr int kMaxRowVecs = 4;  // vectors a thread of residual_ln holds

__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float (&f)[8]) {
  uint4 u;
  u.x = pack_bf16(f[0], f[1]);
  u.y = pack_bf16(f[2], f[3]);
  u.z = pack_bf16(f[4], f[5]);
  u.w = pack_bf16(f[6], f[7]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// grid (rows, column blocks): a thread adds the bias to one vector of a
// row of g and writes it to its head's row of q, k or v
__global__ void qkv_bias_split_kernel(const bf16* __restrict__ g, const bf16* __restrict__ bias,
                                      bf16* __restrict__ q, bf16* __restrict__ k,
                                      bf16* __restrict__ v, int L, int H, int Dh) {
  const int d = H * Dh;
  const int col = (blockIdx.y * kThreads + threadIdx.x) * 8;
  if (col >= 3 * d) return;
  const int row = blockIdx.x;
  float x[8], b[8];
  load8(g + (size_t)row * 3 * d + col, x);
  load8(bias + col, b);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] += b[i];
  const int t = col / d, e = col - t * d;
  bf16* out = t == 0 ? q : (t == 1 ? k : v);
  const int bi = row / L, l = row - bi * L;
  if (Dh % 8 == 0) {
    const int h = e / Dh;
    store8(out + (((size_t)bi * H + h) * L + l) * Dh + (e - h * Dh), x);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int h = (e + i) / Dh;
      out[(((size_t)bi * H + h) * L + l) * Dh + (e + i - h * Dh)] = __float2bfloat16_rn(x[i]);
    }
  }
}

// the sum of v over the block; every thread gets it
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red is free again
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (blockDim.x >> 5) ? red[lane] : 0.f;
  return warp_sum(v);
}

// one block a row; a thread holds NV vectors of it, vector j at column
// 8 * (threadIdx.x + j * blockDim.x)
template <int NV>
__global__ void residual_ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                                   const bf16* __restrict__ bias,
                                   const uint8_t* __restrict__ rowmask,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta, bf16* __restrict__ y,
                                   bf16* __restrict__ ln, int d, float eps) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const int nvec = d / 8;
  const bool keep = rowmask == nullptr || rowmask[row] != 0;
  float t[NV][8];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (threadIdx.x + j * blockDim.x) * 8;
    if (c >= 8 * nvec) continue;
    load8(g + row * d + c, t[j]);
    if (bias != nullptr) {
      float b[8];
      load8(bias + c, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) t[j][i] = round_bf16(t[j][i] + b[i]);
    }
    if (!keep) {
#pragma unroll
      for (int i = 0; i < 8; ++i) t[j][i] = 0.f;
    }
    if (x != nullptr) {
      float r[8];
      load8(x + row * d + c, r);
#pragma unroll
      for (int i = 0; i < 8; ++i) t[j][i] = round_bf16(r[i] + t[j][i]);
    }
    if (y != nullptr) store8(y + row * d + c, t[j]);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += t[j][i];
  }
  if (ln == nullptr) return;  // uniform over the block
  const float mean = block_sum(sum, red) / d;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if ((threadIdx.x + j * blockDim.x) * 8 >= 8 * nvec) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float c = t[j][i] - mean;
      sq += c * c;
    }
  }
  const float rstd = rsqrtf(block_sum(sq, red) / d + eps);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (threadIdx.x + j * blockDim.x) * 8;
    if (c >= 8 * nvec) continue;
    const float4 g0 = *reinterpret_cast<const float4*>(gamma + c);
    const float4 g1 = *reinterpret_cast<const float4*>(gamma + c + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(beta + c);
    const float4 b1 = *reinterpret_cast<const float4*>(beta + c + 4);
    const float ga[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float be[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = ga[i] * (rstd * (t[j][i] - mean)) + be[i];
    store8(ln + row * d + c, o);
  }
}

// grid (rows, column blocks), in place where out == g
__global__ void bias_quick_gelu_kernel(const bf16* g, const bf16* __restrict__ bias, bf16* out,
                                       int f) {
  const int col = (blockIdx.y * kThreads + threadIdx.x) * 8;
  if (col >= f) return;
  const size_t at = (size_t)blockIdx.x * f + col;
  float h[8], b[8];
  load8(g + at, h);
  load8(bias + col, b);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float hi = round_bf16(h[i] + b[i]);
    const float z = round_bf16(1.702f * hi);
    const float s = round_bf16(1.0f / (1.0f + expf(-z)));
    h[i] = hi * s;
  }
  store8(out + at, h);
}

}  // namespace

// q, k, v (B, H, L, Dh) from g (B * L, 3 H Dh) and in_b (3 H Dh), all bf16
extern "C" int qkv_bias_split(const void* g, const void* bias, void* q, void* k, void* v,
                              int B, int L, int H, int Dh, void* stream) {
  const int d = H * Dh;
  if (B < 1 || L < 1 || H < 1 || Dh < 1 || d % 8 != 0) return cudaErrorInvalidValue;
  const dim3 grid(B * L, (3 * d / 8 + kThreads - 1) / kThreads);
  qkv_bias_split_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(bias), static_cast<bf16*>(q),
      static_cast<bf16*>(k), static_cast<bf16*>(v), L, H, Dh);
  return cudaGetLastError();
}

// over rows of d: x, bias, rowmask (one byte a row), y and ln may each be
// null; gamma and beta (fp32) are read where ln is not
extern "C" int residual_ln(const void* x, const void* g, const void* bias, const void* rowmask,
                           const void* gamma, const void* beta, void* y, void* ln, int rows,
                           int d, float eps, void* stream) {
  if (rows < 1 || d < 8 || d % 8 != 0) return cudaErrorInvalidValue;
  if (y == nullptr && ln == nullptr) return cudaErrorInvalidValue;
  const int nvec = d / 8;
  int nv = 1;
  while (nv < kMaxRowVecs && (nvec + nv - 1) / nv > 1024) nv *= 2;
  const int per = (nvec + nv - 1) / nv;
  if (per > 1024) return cudaErrorInvalidValue;
  const int threads = (per + 31) / 32 * 32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *xp = static_cast<const bf16*>(x), *gp = static_cast<const bf16*>(g),
             *bp = static_cast<const bf16*>(bias);
  const uint8_t* mp = static_cast<const uint8_t*>(rowmask);
  const float *ga = static_cast<const float*>(gamma), *be = static_cast<const float*>(beta);
  bf16 *yp = static_cast<bf16*>(y), *lp = static_cast<bf16*>(ln);
  if (nv == 1)
    residual_ln_kernel<1><<<rows, threads, 0, s>>>(xp, gp, bp, mp, ga, be, yp, lp, d, eps);
  else if (nv == 2)
    residual_ln_kernel<2><<<rows, threads, 0, s>>>(xp, gp, bp, mp, ga, be, yp, lp, d, eps);
  else
    residual_ln_kernel<4><<<rows, threads, 0, s>>>(xp, gp, bp, mp, ga, be, yp, lp, d, eps);
  return cudaGetLastError();
}

// out (rows, f) = QuickGELU(g + bias), bf16; out may be g
extern "C" int bias_quick_gelu(const void* g, const void* bias, void* out, int rows, int f,
                               void* stream) {
  if (rows < 1 || f < 8 || f % 8 != 0) return cudaErrorInvalidValue;
  const dim3 grid(rows, (f / 8 + kThreads - 1) / kThreads);
  bias_quick_gelu_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(bias), static_cast<bf16*>(out), f);
  return cudaGetLastError();
}
