// PAR (pixel-adaptive refinement) affinity builder and propagation step, for
// sm_90a.  Plain C entry points, loaded with ctypes by
// weclip_tpu_torch/kernels.py; wrappers in refine/par_kernels.py.
//
// Replaces (weclip_tpu/refine/pallas_par.py):
//   K4  par_affinity_pallas  (_aff_kernel)
//   K5  par_refine_pallas    (_fused_kernel), one launch per Jacobi iteration
//
// Neighbours are the 8 offsets of refine/par.py::_OFFSETS at each dilation,
// dilation-major (the reference order); edge replication is a clamped index.
//
// What bounds them on the H100 (eval: B=8, 48 neighbours, 512x512 canvas):
// K4 reads the image once and writes B*48*H*W fp32 (403 MB, ~0.12 ms at
// 3.35 TB/s); its ~50 FLOP per neighbour and pixel are far below the
// compute roof, so it is bound by that write.  K5 reads the 403 MB of
// affinities once per iteration and the masks (~1+MC planes) through L1/L2,
// and writes the masks once: about 0.45 GB per iteration at bucket 4, bound
// by bytes.  The design reads each pixel's 48 affinity values once per
// iteration for all 1+MC channels (a thread owns one pixel and loops over the
// channels with the sums in registers), and ping-pongs two mask buffers
// between launches.  The TPU kernel's one-hot clamp matmul, rolls, halo
// pre-rotation and sorted-dy neighbour order were TPU layout devices and are
// not carried over.

#include <math_constants.h>

#include "common.cuh"

using namespace weclip;

namespace {

constexpr int kOffsets[8][2] = {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1},
                                {0, 1},   {1, -1}, {1, 0},  {1, 1}};
constexpr int kMaxDil = 6;
constexpr int kBlock = 128;

struct Shifts {
  int dy[8 * kMaxDil];
  int dx[8 * kMaxDil];
};

Shifts make_shifts(const int* dil, int n_dil) {
  Shifts s{};
  for (int i = 0; i < n_dil; ++i)
    for (int o = 0; o < 8; ++o) {
      s.dy[i * 8 + o] = kOffsets[o][0] * dil[i];
      s.dx[i * 8 + o] = kOffsets[o][1] * dil[i];
    }
  return s;
}

// One thread per output pixel: one-pass moments over the N neighbours
// (unbiased std), appearance logits averaged over RGB, softmax over the
// neighbours, plus the host-computed positional weights.
template <int N>
__global__ void __launch_bounds__(kBlock)
par_affinity_kernel(const float* __restrict__ img, float* __restrict__ aff,
                    const float* __restrict__ posw, Shifts sh, int H, int W,
                    float w1) {
  const int x = blockIdx.x * kBlock + threadIdx.x, y = blockIdx.y, b = blockIdx.z;
  if (x >= W) return;
  const size_t plane = (size_t)H * W;
  const float* im = img + (size_t)b * 3 * plane;
  float c0[3], s1[3] = {0.f, 0.f, 0.f}, s2[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 3; ++c) c0[c] = im[c * plane + (size_t)y * W + x];
  int off[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    off[k] = clampi(y + sh.dy[k], 0, H - 1) * W + clampi(x + sh.dx[k], 0, W - 1);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float s = im[c * plane + off[k]];
      s1[c] += s;
      s2[c] += s * s;
    }
  }
  float inv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float mean = s1[c] / (float)N;
    const float var = fmaxf((s2[c] - (float)N * mean * mean) / (float)(N - 1), 0.f);
    inv[c] = 1.f / ((sqrtf(var) + 1e-8f) * w1);
  }
  float logit[N];
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float t = fabsf(im[c * plane + off[k]] - c0[c]) * inv[c];
      acc += -(t * t);
    }
    logit[k] = acc / 3.f;
    mx = fmaxf(mx, logit[k]);
  }
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    logit[k] = expf(logit[k] - mx);
    sum += logit[k];
  }
  float* out = aff + (size_t)b * N * plane + (size_t)y * W + x;
#pragma unroll
  for (int k = 0; k < N; ++k) out[k * plane] = logit[k] / sum + posw[k];
}

// One Jacobi step: dst[c] = sum_k aff_k * src[c] at the clamped k-th
// neighbour, for every channel c of one pixel.
template <int CMAX>
__global__ void __launch_bounds__(kBlock)
par_propagate_kernel(const float* __restrict__ src, float* __restrict__ dst,
                     const float* __restrict__ aff, Shifts sh, int n, int C,
                     int H, int W) {
  const int x = blockIdx.x * kBlock + threadIdx.x, y = blockIdx.y, b = blockIdx.z;
  if (x >= W) return;
  const size_t plane = (size_t)H * W;
  const float* a = aff + (size_t)b * n * plane + (size_t)y * W + x;
  const float* m = src + (size_t)b * C * plane;
  float acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.f;
  for (int k = 0; k < n; ++k) {
    const float ak = a[k * plane];
    const float* mk = m + clampi(y + sh.dy[k], 0, H - 1) * W + clampi(x + sh.dx[k], 0, W - 1);
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C) acc[c] = fmaf(mk[c * plane], ak, acc[c]);
  }
  float* o = dst + (size_t)b * C * plane + (size_t)y * W + x;
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
    if (c < C) o[c * plane] = acc[c];
}

template <int N>
cudaError_t launch_affinity(const float* img, float* aff, const float* posw,
                            const Shifts& sh, int B, int H, int W, float w1,
                            cudaStream_t s) {
  const dim3 grid((W + kBlock - 1) / kBlock, H, B);
  par_affinity_kernel<N><<<grid, kBlock, 0, s>>>(img, aff, posw, sh, H, W, w1);
  return cudaGetLastError();
}

template <int CMAX>
cudaError_t launch_propagate(const float* src, float* dst, const float* aff,
                             const Shifts& sh, int n, int B, int C, int H, int W,
                             cudaStream_t s) {
  const dim3 grid((W + kBlock - 1) / kBlock, H, B);
  par_propagate_kernel<CMAX><<<grid, kBlock, 0, s>>>(src, dst, aff, sh, n, C, H, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" int par_affinity(const void* img, void* aff, const void* posw, int B,
                            int H, int W, const void* dilations, int n_dil,
                            float w1, void* stream) {
  if (n_dil < 1 || n_dil > kMaxDil) return cudaErrorInvalidValue;
  const Shifts sh = make_shifts(static_cast<const int*>(dilations), n_dil);
  const float* i = static_cast<const float*>(img);
  float* a = static_cast<float*>(aff);
  const float* p = static_cast<const float*>(posw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_dil) {
    case 1: return launch_affinity<8>(i, a, p, sh, B, H, W, w1, s);
    case 2: return launch_affinity<16>(i, a, p, sh, B, H, W, w1, s);
    case 3: return launch_affinity<24>(i, a, p, sh, B, H, W, w1, s);
    case 4: return launch_affinity<32>(i, a, p, sh, B, H, W, w1, s);
    case 5: return launch_affinity<40>(i, a, p, sh, B, H, W, w1, s);
    default: return launch_affinity<48>(i, a, p, sh, B, H, W, w1, s);
  }
}

extern "C" int par_propagate(const void* src, void* dst, const void* aff, int B,
                             int C, int H, int W, const void* dilations,
                             int n_dil, void* stream) {
  if (n_dil < 1 || n_dil > kMaxDil || C < 1 || C > 32) return cudaErrorInvalidValue;
  const Shifts sh = make_shifts(static_cast<const int*>(dilations), n_dil);
  const float* i = static_cast<const float*>(src);
  float* o = static_cast<float*>(dst);
  const float* a = static_cast<const float*>(aff);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = 8 * n_dil;
  if (C <= 4) return launch_propagate<4>(i, o, a, sh, n, B, C, H, W, s);
  if (C <= 8) return launch_propagate<8>(i, o, a, sh, n, B, C, H, W, s);
  if (C <= 16) return launch_propagate<16>(i, o, a, sh, n, B, C, H, W, s);
  return launch_propagate<32>(i, o, a, sh, n, B, C, H, W, s);
}
