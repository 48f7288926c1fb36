// K7: the windowed bilateral message of the mean-field dense CRF, for
// sm_90a, as split-TF32 tensor-core products over a wrapped halo.  A plain
// C entry point, loaded with ctypes by weclip_tpu_torch/kernels.py; the
// wrapper is refine/crf_kernels.py.
//
// Replaces no pallas_call: the JAX package runs this sum as an XLA
// fori_loop over the (2r+1)^2 window offsets (weclip_tpu/refine/crf.py,
// mean_field_crf_jax, the windowed branch), about a dozen small ops per
// offset.  Eager PyTorch would launch each of them from the host, so the
// whole window sum is one launch here.
//
// For each image b and subsampled pixel p = (y, x), over every offset
// (dy, dx) in [-r, r]^2:
//   k    = exp(-0.5 * ((dy^2 + dx^2) / sig^2 + |img_p - img_s|^2)) * inb
//   acc  += k * q[:, s],   norm += k
// where s = ((y - dy) mod hs, (x - dx) mod ws) is the rolled neighbour the
// reference reads (jnp.roll) and inb says whether (y + dy, x + dx) lies in
// the grid: the reference masks by the opposite offset.  Within r of an
// edge it therefore sums wrapped pixels and drops real neighbours; the
// interior is the exact window.  The port keeps that rule for parity.
//
// The rule in virtual source coordinates: sy_v = y - dy reads row sy_v mod
// hs (a true modulo), and the pair counts iff |y - sy_v| <= r and 2y - hs <
// sy_v <= 2y (y + dy in the grid); columns alike.  A tile of output pixels
// then reads the halo [y0 - r, y1 + r] x [x0 - r, x1 + r] with modular
// addressing, every read inside the tensor for any r (r >= the grid
// included), and a pair mask zeroes the weights outside the window and the
// grid rule.  tests/test_torch_crf.py::test_halo_rule_matches_the_plain_twin
// states this form against window_message_plain.
//
// The message is a product: for a tile P of output pixels and the sources
// S of its halo, acc[p, c] = sum_s K[p, s] q[c, s], a (P x S) (S x C) GEMM
// whose A operand is computed.  mma.sync m16n8k8 .tf32: output pixels are
// M, sources K, channels N (all of a block's channels, padded to a multiple
// of 8, plus one column of ones, whose product is the normalizer; the
// normalizer alone is the same kernel with that column only).  Each
// (pixel, source) weight is computed once, in the A-fragment registers,
// from the staged image values and the offset, as 2^(-(kappa (dist2 +
// cd2))) with kappa = log2(e) / 2 (ex2.approx); a pair outside the mask
// gets an infinite exponent, so its weight is exactly 0.  B is q's own
// layout, q[c][s] (sources contiguous).  Under split-TF32 (x = hi + lo,
// hi = tf32(x), lo = tf32(x - hi), each rounded to nearest by
// split_tf32_finite: the weights and q are finite; lo B_hi + hi B_hi + hi
// B_lo) a product is within about 2^-21 of its value, and since the tensor cores truncate
// as they accumulate, each k-step of 8 sources is summed in a fresh
// accumulator and then added to the fp32 total, rounded to nearest
// (tests/test_torch_crf.py::test_split_tf32_window_sum_error models it).
//
// Design.  A block of 8 warps (2 x 4) takes 8 output rows x 32 columns; a
// warp 4 rows x 8 columns as two m16 tiles: fragment row g is pixel (y, x0
// + g), row g + 8 pixel (y + 1, x0 + g), so both tiles of a warp read the
// same B fragments.  The block walks its halo's source rows in order; each
// unit (a source row, or a piece of it where the halo is wider than shared
// memory holds) stages that row of q (the block's channels) and of the
// image by 4-byte cp.async through a table of wrapped columns, double-
// buffered, while the unit before is multiplied; the rows of ones and zeros
// past the channels are written once.  A warp skips the source rows and
// k-steps that no pair of its pixels counts.  Above 127 channels the grid
// has an axis over groups of 127, each recomputing the weights.  (Tried
// and not kept: splitting q into its parts once as it is staged, for the 8
// warps that read it, and one m16 tile a warp at 16 warps a block; neither
// was faster on the H100, PERF.md §6.)
//
// What bounds it on the H100 (COCO, stride 4: B = 8, C = 81, 160 x 160,
// r = 32): 7.0e8 in-bound pixel-offsets, each 2 C flops of the message on
// split-TF32 products (three TF32 products: 494.7 / 3 TFLOP/s, 0.69 ms) and
// a dozen for the weight on the CUDA cores (67 TFLOP/s, 0.13 ms), against
// 0.13 GB of tensors: bound by operations, 0.69 ms (chip_smoke.py::k7_bound;
// the FMA form this kernel replaces was bound at 1.81 ms).  The halo costs
// (8 + 2R) / (2r + 1) of the window's columns (R = r rounded up to 4) and
// (4 + 2r) / (2r + 1) of its rows, 1.17x at r 32, and C + 1 is padded to
// whole 8-column tiles (88 of 82 at C 81).

#include "common.cuh"

using namespace weclip;
using namespace weclip::tc;

namespace {

constexpr int kWarpsX = 4, kWarpsY = 2;
constexpr int kWarps = kWarpsX * kWarpsY;
constexpr int kThreads = 32 * kWarps;
constexpr int kTX = 8 * kWarpsX;   // output columns a block
constexpr int kTY = 4 * kWarpsY;   // output rows a block (4 a warp)
constexpr int kMaxCols = 127;      // channels a block: with the ones column, 16 n-tiles
constexpr float kKappa = 0.72134752044448170f;   // log2(e) / 2
constexpr int kSmemBudget = 112 * 1024;

// the launch geometry, computed on the host (crf_geometry)
struct Geo {
  int C, hs, ws, r;
  int R;         // r rounded up to a multiple of 4: the halo reaches R past the tile
  int W;         // halo columns, kTX + 2 R (a multiple of 8)
  int PW;        // halo columns a unit stages (a multiple of 8)
  int SW;        // row stride of a staged row in shared memory (== 4 mod 32)
  int pieces;    // units a source row, ceil(W / PW)
  int groups;    // channel groups of kMaxCols
  float cs;      // kappa / sig^2
};

__host__ __device__ __forceinline__ int mod(int v, int n) {
  const int m = v % n;
  return m < 0 ? m + n : m;
}

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// shared memory: two unit buffers of NR rows of channels (q, then a row of
// ones, then zeros) and 3 rows of the image, each SW floats; then the
// halo's wrapped columns
__host__ __device__ __forceinline__ int buffer_floats(int nr, int sw) { return (nr + 3) * sw; }

template <int NT>
__global__ void __launch_bounds__(kThreads)
crf_window_kernel(const float* __restrict__ q, const float* __restrict__ img,
                  float* __restrict__ acc, float* __restrict__ norm, const Geo geo) {
  constexpr int NR = NT * 8;
  extern __shared__ __align__(16) float smem[];
  const int C = geo.C, hs = geo.hs, ws = geo.ws, r = geo.r, SW = geo.SW, PW = geo.PW;
  const int n = hs * ws;
  float* const buf0 = smem;
  float* const buf1 = smem + buffer_floats(NR, SW);
  int* const colmap = reinterpret_cast<int*>(smem + 2 * buffer_floats(NR, SW));

  const int b = blockIdx.z / geo.groups, grp = blockIdx.z % geo.groups;
  const int c0 = grp * kMaxCols;
  const int cc = min(kMaxCols, C - c0);   // this block's channels (0: the normalizer alone)
  const int xb0 = blockIdx.x * kTX, yb0 = blockIdx.y * kTY;
  const int hx0 = xb0 - geo.R;            // virtual source column of halo column 0
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wx = warp % kWarpsX, wy = warp / kWarpsX;

  // the wrapped source column of each halo column; the constant rows
  for (int j = tid; j < geo.W; j += kThreads) colmap[j] = mod(hx0 + j, ws);
  for (int i = tid; i < (NR - cc) * PW; i += kThreads) {
    const int row = cc + i / PW, j = i % PW;
    const float v = row == cc ? 1.f : 0.f;
    buf0[row * SW + j] = v;
    buf1[row * SW + j] = v;
  }

  // the block's source rows: every sy_v that some pixel of its rows counts
  const int yb1 = min(yb0 + kTY, hs) - 1;
  const int row_lo = max(yb0 - r, 2 * yb0 - hs + 1), row_hi = min(yb1 + r, 2 * yb1);
  const int units = (row_hi - row_lo + 1) * geo.pieces;

  auto stage = [&](int u) {
    const int sy = mod(row_lo + u / geo.pieces, hs), jb = (u % geo.pieces) * PW;
    const int pw = min(PW, geo.W - jb);
    float* dst = (u & 1) ? buf1 : buf0;
    for (int row = warp; row < cc + 3; row += kWarps) {
      const float* src = row < cc ? q + ((size_t)b * C + c0 + row) * n
                                  : img + ((size_t)b * 3 + row - cc) * n;
      src += (size_t)sy * ws;
      float* d = dst + (row < cc ? row : NR + row - cc) * SW;
      for (int j = lane; j < pw; j += 32) cp_async4(d + j, src + colmap[jb + j], 4);
    }
    cp_async_commit();
  };
  __syncthreads();   // colmap
  stage(0);

  // this warp: rows yw0 .. yw0 + 3 (two m-tiles of two rows), column x
  const int yw0 = yb0 + 4 * wy, x0 = xb0 + 8 * wx, x = x0 + g;
  const bool active = yw0 < hs && x0 < ws;
  const int yw1 = min(yw0 + 4, hs) - 1, xw1 = min(x0 + 8, ws) - 1;
  const int wrow_lo = max(yw0 - r, 2 * yw0 - hs + 1), wrow_hi = min(yw1 + r, 2 * yw1);
  // its k-steps (8 halo columns each) that some pair counts
  const int kc_lo = (max(x0 - r, 2 * x0 - ws + 1) - hx0) >> 3;
  const int kc_hi = (min(xw1 + r, 2 * xw1) - hx0) >> 3;
  float pix[4][3];   // the image at this lane's pixels (clamped reads past the grid)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int yy = min(yw0 + i, hs - 1), xx = min(x, ws - 1);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) pix[i][ch] = img[((size_t)b * 3 + ch) * n + yy * ws + xx];
  }
  float tot[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) tot[mt][nt][i] = 0.f;

  for (int u = 0; u < units; ++u) {
    cp_async_wait<0>();
    __syncthreads();   // unit u staged; unit u - 1's buffer free
    if (u + 1 < units) stage(u + 1);
    const int sy_v = row_lo + u / geo.pieces, jb = (u % geo.pieces) * PW;
    const int k_lo = max(kc_lo, jb >> 3), k_hi = min(kc_hi, (jb + min(PW, geo.W - jb)) / 8 - 1);
    if (!active || sy_v < wrow_lo || sy_v > wrow_hi || k_lo > k_hi) continue;
    const float* bs = (u & 1) ? buf1 : buf0;
    const float* is = bs + NR * SW;
    // the row part of each pixel's exponent, -inf where the pair is masked
    float ey[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int y = yw0 + i, dy = y - sy_v;
      const bool ok = y < hs && abs(dy) <= r && 2 * y - sy_v >= 0 && 2 * y - sy_v < hs;
      ey[i] = ok ? -(float)(dy * dy) * geo.cs : -inf();
    }
    for (int kc = k_lo; kc <= k_hi; ++kc) {
      const int jj = kc * 8 - jb;   // the k-step's first column in the buffer
      // columns t and t + 4 of the k-step: the column part (+inf where
      // masked) and the source's image values
      float ex[2], src[2][3];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int sx_v = hx0 + kc * 8 + t + 4 * h, dx = x - sx_v;
        const bool ok = x < ws && abs(dx) <= r && 2 * x - sx_v >= 0 && 2 * x - sx_v < ws;
        ex[h] = ok ? (float)(dx * dx) * geo.cs : inf();
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) src[h][ch] = is[ch * SW + jj + t + 4 * h];
      }
      // A: a0 (row g: pixel row 2 mt, column t), a1 (row g + 8: pixel row
      // 2 mt + 1, column t), a2 and a3 the same at column t + 4
      OpsFinite::A fa[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 2 * mt + (e & 1), h = e >> 1;
          const float d0 = pix[i][0] - src[h][0], d1 = pix[i][1] - src[h][1];
          const float d2 = pix[i][2] - src[h][2];
          const float cd2 = fmaf(d2, d2, fmaf(d1, d1, d0 * d0));
          split_tf32_finite(ex2(fmaf(-kKappa, cd2, ey[i] - ex[h])), fa[mt].h[e], fa[mt].l[e]);
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        OpsFinite::B fb;
        OpsFinite::load_bt(fb, bs, SW, nt * 8, jj, g, t);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          OpsFinite::mma(part, part, fa[mt], fb);
#pragma unroll
          for (int i = 0; i < 4; ++i) tot[mt][nt][i] += part[i];
        }
      }
    }
  }
  if (!active || x >= ws) return;
  // c0, c1 at pixel row 2 mt (channels 2t, 2t + 1 of the tile), c2, c3 at row 2 mt + 1
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int y = yw0 + 2 * mt + half;
      if (y >= hs) continue;
      const size_t p = (size_t)y * ws + x;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * 8 + 2 * t + e;
          const float v = tot[mt][nt][2 * half + e];
          if (col < cc)
            acc[((size_t)b * C + c0 + col) * n + p] = v;
          else if (col == cc && grp == 0)
            norm[(size_t)b * n + p] = v;
        }
    }
}

// the n-tiles an instance holds: the smallest of these that takes cc + 1
constexpr int kInstances[] = {1, 2, 3, 4, 6, 8, 11, 16};

int pick_nt(int C) {
  const int need = ((C < kMaxCols ? C : kMaxCols) + 1 + 7) / 8;
  for (int nt : kInstances)
    if (nt >= need) return nt;
  return 16;
}

int row_stride(int pw) { return pw + ((4 - pw % 32) + 32) % 32; }

// the geometry of a launch, and its dynamic shared memory in bytes
int crf_geometry(int C, int hs, int ws, int r, float sig2, Geo* geo) {
  const int nr = 8 * pick_nt(C);
  geo->C = C;
  geo->hs = hs;
  geo->ws = ws;
  geo->r = r;
  geo->R = (r + 3) / 4 * 4;
  geo->W = kTX + 2 * geo->R;
  geo->groups = C > kMaxCols ? (C + kMaxCols - 1) / kMaxCols : 1;
  geo->cs = kKappa / sig2;
  // the widest piece (a multiple of 8) whose two buffers fit the budget
  int pw = geo->W;
  const auto bytes = [&](int p) { return 4 * (2 * buffer_floats(nr, row_stride(p)) + geo->W); };
  while (pw > 8 && bytes(pw) > kSmemBudget) pw -= 8;
  geo->PW = pw;
  geo->SW = row_stride(pw);
  geo->pieces = (geo->W + pw - 1) / pw;
  return bytes(pw);
}

template <int NT>
cudaError_t launch(const float* q, const float* img, float* acc, float* norm, int B,
                   const Geo& geo, int smem, cudaStream_t s) {
  auto kern = crf_window_kernel<NT>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((geo.ws + kTX - 1) / kTX, (geo.hs + kTY - 1) / kTY, B * geo.groups);
  kern<<<grid, kThreads, smem, s>>>(q, img, acc, norm, geo);
  return cudaGetLastError();
}

}  // namespace

// q (B, C, hs, ws) fp32 (may be null when C == 0), img (B, 3, hs, ws) fp32,
// acc (B, C, hs, ws) and norm (B, 1, hs, ws) fp32 outputs; sig2 = sigma^2
// of the spatial term on the subsampled grid.
extern "C" int crf_window(const void* q, const void* img, void* acc, void* norm,
                          int B, int C, int hs, int ws, int r, float sig2,
                          void* stream) {
  if (B <= 0 || C < 0 || hs <= 0 || ws <= 0 || r < 0 || (C > 0 && !q))
    return (int)cudaErrorInvalidValue;
  Geo geo;
  const int smem = crf_geometry(C, hs, ws, r, sig2, &geo);
  const float* qf = static_cast<const float*>(q);
  const float* im = static_cast<const float*>(img);
  float* a = static_cast<float*>(acc);
  float* nm = static_cast<float*>(norm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pick_nt(C)) {
#define CASE(NT) \
  case NT:       \
    return (int)launch<NT>(qf, im, a, nm, B, geo, smem, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(6) CASE(8) CASE(11) CASE(16)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

// the launch's shape for a call at (C, hs, ws, r): n-tiles of the instance,
// halo columns, columns a unit stages, its row stride, units a source row
// and dynamic shared memory in bytes, into out[0..5]
extern "C" int crf_window_geometry(int C, int hs, int ws, int r, int* out) {
  if (C < 0 || hs <= 0 || ws <= 0 || r < 0 || !out) return (int)cudaErrorInvalidValue;
  Geo geo;
  const int smem = crf_geometry(C, hs, ws, r, 1.f, &geo);
  const int vals[6] = {pick_nt(C), geo.W, geo.PW, geo.SW, geo.pieces, smem};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 0;
}
