// K7: the windowed bilateral message of the mean-field dense CRF, for
// sm_90a.  A plain C entry point, loaded with ctypes by
// weclip_tpu_torch/kernels.py; the wrapper is refine/crf_kernels.py.
//
// Replaces no pallas_call: the JAX package runs this sum as an XLA
// fori_loop over the (2r+1)^2 window offsets (weclip_tpu/refine/crf.py,
// mean_field_crf_jax, the windowed branch), about a dozen small ops per
// offset.  Eager PyTorch would launch each of them from the host, so the
// whole window sum is one launch here.
//
// For each image b and subsampled pixel p = (y, x), over every offset
// (dy, dx) in [-r, r]^2 (dy outer, dx inner: the reference's order):
//   k    = exp(-0.5 * ((dy^2 + dx^2) / sig^2 + |img_p - img_s|^2)) * inb
//   acc  += k * q[:, s],   norm += k
// where s = ((y - dy) mod hs, (x - dx) mod ws) is the rolled neighbour the
// reference reads (jnp.roll) and inb says whether (y + dy, x + dx) lies in
// the grid: the reference masks by the opposite offset.  Within r of an
// edge it therefore sums wrapped pixels and drops real neighbours; the
// interior is the exact window.  The port keeps that rule for parity.
//
// One thread per output pixel and channel chunk (at most kChunk channels,
// accumulated in registers); the grid is (pixel blocks, chunks, images).
// A warp reads 32 consecutive pixels of a row at each offset, so its loads
// of the image and of each channel are coalesced and served mostly from
// L1/L2 as the window slides.  Offsets whose (y + dy, x + dx) falls outside
// the grid add exactly zero in the reference and are skipped.
//
// What bounds it on the H100 (COCO, stride 4: B = 8, C = 81, 160 x 160,
// r = 32): about 8.6e8 in-bound pixel-offsets, each 2C flops of the
// message plus a dozen for the weight, 1.5e11 fp32 operations in all
// against 0.13 GB of tensors: bound by operations (2.2 ms at 67 TFLOP/s).
// This simple form is limited by its L1 loads (one per channel per
// pixel-offset) and recomputes the weight once per chunk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;     // channels a thread accumulates
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
crf_window_kernel(const float* __restrict__ q, const float* __restrict__ img,
                  float* __restrict__ acc, float* __restrict__ norm, int C,
                  int chunk, int hs, int ws, int r, float sig2) {
  const int n = hs * ws;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * chunk;
  const int cc = min(chunk, C - c0);        // 0 for the normalizer alone
  const int y = p / ws, x = p - y * ws;
  const float* im = img + (size_t)b * 3 * n;
  const float i0 = im[p], i1 = im[n + p], i2 = im[2 * n + p];
  const float* qb = q + ((size_t)b * C + max(c0, 0)) * n;
  float a[kChunk];
#pragma unroll
  for (int c = 0; c < kChunk; ++c) a[c] = 0.f;
  float nk = 0.f;
  // inb: 0 <= y + dy < hs and 0 <= x + dx < ws
  const int ylo = max(-r, -y), yhi = min(r, hs - 1 - y);
  const int xlo = max(-r, -x), xhi = min(r, ws - 1 - x);
  for (int dy = ylo; dy <= yhi; ++dy) {
    // y - dy lies in (-hs, 2 hs): one correction wraps it
    int sy = y - dy;
    sy += sy < 0 ? hs : (sy >= hs ? -hs : 0);
    for (int dx = xlo; dx <= xhi; ++dx) {
      int sx = x - dx;
      sx += sx < 0 ? ws : (sx >= ws ? -ws : 0);
      const int s = sy * ws + sx;
      const float d0 = i0 - __ldg(im + s);
      const float d1 = i1 - __ldg(im + n + s);
      const float d2 = i2 - __ldg(im + 2 * n + s);
      const float cd2 = d0 * d0 + d1 * d1 + d2 * d2;
      const float dist2 = (float)(dy * dy + dx * dx) / sig2;
      const float k = expf(-0.5f * (dist2 + cd2));
      nk += k;
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        if (c < cc) a[c] += __ldg(qb + (size_t)c * n + s) * k;
    }
  }
  float* ab = acc + ((size_t)b * C + max(c0, 0)) * n;
#pragma unroll
  for (int c = 0; c < kChunk; ++c)
    if (c < cc) ab[(size_t)c * n + p] = a[c];
  if (blockIdx.y == 0) norm[(size_t)b * n + p] = nk;
}

}  // namespace

// q (B, C, hs, ws) fp32 (may be null when C == 0), img (B, 3, hs, ws) fp32,
// acc (B, C, hs, ws) and norm (B, 1, hs, ws) fp32 outputs; sig2 = sigma^2
// of the spatial term on the subsampled grid.
extern "C" int crf_window(const void* q, const void* img, void* acc, void* norm,
                          int B, int C, int hs, int ws, int r, float sig2,
                          void* stream) {
  if (B <= 0 || C < 0 || hs <= 0 || ws <= 0 || r < 0) return (int)cudaErrorInvalidValue;
  const int chunks = C > 0 ? (C + kChunk - 1) / kChunk : 1;
  const int chunk = C > 0 ? (C + chunks - 1) / chunks : 0;   // balanced
  const dim3 grid((hs * ws + kThreads - 1) / kThreads, chunks, B);
  crf_window_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)img, (float*)acc, (float*)norm, C, chunk,
      hs, ws, r, sig2);
  return (int)cudaGetLastError();
}
