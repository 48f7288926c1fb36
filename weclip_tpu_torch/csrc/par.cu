// PAR (pixel-adaptive refinement) affinity builder and propagation, for
// sm_90a.  Plain C entry points, loaded with ctypes by
// weclip_tpu_torch/kernels.py; wrappers in refine/par_kernels.py.
//
// Replaces (weclip_tpu/refine/pallas_par.py):
//   K4  par_affinity_pallas  (_aff_kernel)
//   K5  par_refine_pallas    (_fused_kernel); here one launch per Jacobi
//       iteration, all of them issued by one host call
//
// Neighbours are the 8 offsets of refine/par.py::_OFFSETS at each dilation,
// dilation-major (the reference order), with edge replication.
//
// Both kernels work on 2-D tiles of kTileW = 64 columns: a thread owns 4
// adjacent pixels of one row (16-byte global loads and stores), 16 threads
// a tile row.  The tile's rows plus a replicated halo of kHalo = 24 (the
// largest dilation) on every side are staged in shared memory with cp.async
// from clamped coordinates (16 bytes where a quad lies inside the image,
// else 4), so edge replication costs nothing afterwards and an image
// smaller than the halo is handled alike.  Staged rows are row-major, 112
// words.  A thread reads the 4 values at column offset dx as one 16-byte
// load where dx % 4 == 0, else as two aligned 16-byte loads and a register
// shift; dx % 4 is fixed per dilation (0, d % 4 or -d % 4), so each
// dilation runs one of four compiled variants.  A quarter-warp then reads
// 8 consecutive quads of one row (128 contiguous bytes): no bank conflicts.
//
// What bounds them on the H100 (eval: B = 8, 48 neighbours, 512 x 512):
// K4 reads the 25 MB image and writes B*48*H*W fp32 (403 MB): bound by that
// write (0.13 ms at 3.35 TB/s), written with 16-byte streaming stores.  An
// 8 x 64 tile's 3 channels are staged once; the moments sweep and two
// logits sweeps (8 x 4 logits in registers at a time: the softmax's running
// max and sum, then each weight) read them.  Its divisions (by 3, by the
// sum) are a reciprocal and one correction step, which round as the
// division does.
// K5 must stream the 403 MB of affinities in every iteration: they cannot
// stay on chip (50 MB of L2), so its floor is 20 x (403 + 2 x 42) MB at
// 3.35 TB/s = 2.9 ms at the eval shape.  A block walks down a column of
// 16 x 64 tiles with a ring of 80 staged rows a channel (36 KB): the 64 rows
// one tile reads and the 16 new rows of the next tile, staged while this
// one computes.  Up to 6 channels are staged at once; the block loops over
// the neighbours outermost, so each affinity is read from HBM once per
// iteration for all of them, with 16-byte evict-first loads (__ldcs) two
// dilations (16 neighbours) ahead in registers, across tile boundaries; the
// C x 4 sums stay in registers.  Above 6 channels the channels go in
// balanced chunks and the affinities are read once per chunk.  The TPU
// kernel's one-hot clamp matmul, rolls, halo pre-rotation and sorted-dy
// neighbour order were TPU layout devices and are not carried over.
//
// Any dilation set.  A dilation d at least max(H, W) - 1 reads the clamped
// edge in every direction, so the wrapper hands over min(d, max(H, W) - 1)
// (at least 1): the same neighbours.  The staged window keeps its halo of
// kHalo = 24 whatever the set, so the shared memory and K5's channel chunks
// stay as they are; a dilation above 24 reads its neighbours through L2
// from clamped coordinates (4 scalar loads a quad) instead of from the
// staged rows.  K4 reads the dilations and the positional weights from
// device memory.  K5 has two forms, which the wrapper picks per set: up to
// kMaxDil = 6 dilations of at most 24 (PAR's shipped (1, 2, 4, 8, 12, 24)
// on any image) run the packed form (par_propagate), the dilations packed 5
// bits each into one argument; any other set the far form
// (par_propagate_far), the dilations read from device memory.  At the
// shipped set the packed form is 1-4% faster (PERF.md §6).

#include <math_constants.h>

#include "common.cuh"

using namespace weclip;

namespace {

constexpr int kMaxDil = 6;
constexpr int kHalo = 24;                    // largest dilation taken
constexpr int kTileW = 64;                   // tile columns
constexpr int kQuads = kTileW / 4;           // threads per tile row
constexpr int kPitch = kTileW + 2 * kHalo;   // staged columns = words a row (112)
constexpr int kRowQuads = kPitch / 4;
constexpr int kAffRows = 8;                  // K4 tile rows (128 threads)
constexpr int kPropRows = 16;                // K5 tile rows (256 threads)
constexpr int kMaxSmem = 232448;             // opt-in shared memory a block

static_assert(kHalo % 4 == 0 && kPitch % 4 == 0, "16-byte aligned quads");

// neighbour o of a dilation: (dy, dx) = _OFFSETS[o] * d, and the offset of
// its first column inside an aligned quad when d % 4 == R
__host__ __device__ constexpr int dy_of(int o) { return o < 3 ? -1 : (o < 5 ? 0 : 1); }
__host__ __device__ constexpr int dx_of(int o) {
  return (o == 0 || o == 3 || o == 5) ? -1 : ((o == 1 || o == 6) ? 0 : 1);
}
__host__ __device__ constexpr int rv_of(int R, int o) {
  return dx_of(o) == 0 ? 0 : (dx_of(o) > 0 ? R : (4 - R) & 3);
}

// dilation g of the 5-bit packed list
__host__ __device__ constexpr int dil_of(int dpack, int g) { return (dpack >> (5 * g)) & 31; }

// the 4 staged values from column rv of the aligned quad at p on; rv is a
// constant wherever this is inlined (unrolled neighbour loops), so one or
// two 16-byte loads and no selects remain
__device__ __forceinline__ float4 quad_at(const float* p, int rv) {
  const float4 q0 = *reinterpret_cast<const float4*>(p);
  if (rv == 0) return q0;
  const float4 q1 = *reinterpret_cast<const float4*>(p + 4);
  if (rv == 1) return make_float4(q0.y, q0.z, q0.w, q1.x);
  if (rv == 2) return make_float4(q0.z, q0.w, q1.x, q1.y);
  return make_float4(q0.w, q1.x, q1.y, q1.z);
}

// the 4 staged values of neighbour o at dilation d (d % 4 == R) in the
// plane `plane` words on; rows[i] is where the thread's own 4 pixels would
// be in its staged row at dy = (i - 1) d
template <int R>
__device__ __forceinline__ float4 neighbour(const float* const (&rows)[3], int o, int d,
                                            int plane) {
  return quad_at(rows[dy_of(o) + 1] + plane + dx_of(o) * d - rv_of(R, o), rv_of(R, o));
}

// Staging: rows [l0, l1) of a tile column's staged window into shared
// memory, for planes [0, n) of the (H, W) planes at `src` (plane stride
// H*W).  Window row l is image row ytop + l and lands in shared row
// l % ROWS of its plane; its 112 columns are image columns x0 - 24 ...
// x0 + 87.  Rows and columns outside the image read the clamped border
// pixel; a quad inside the image is one 16-byte cp.async, else four
// 4-byte ones.  `vec`: W % 4 == 0 and src 16-byte aligned.  Commits
// nothing.
template <int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows(float* sm, const float* __restrict__ src, int n,
                                           int ytop, int l0, int l1, int x0, int H, int W,
                                           bool vec) {
  const size_t plane = (size_t)H * W;
  const int count = (l1 - l0) * kRowQuads;
  for (int p = 0; p < n; ++p)
    for (int e = threadIdx.x; e < count; e += THREADS) {
      const int l = l0 + e / kRowQuads, q = e % kRowQuads;
      const float* row = src + p * plane + (size_t)clampi(ytop + l, 0, H - 1) * W;
      float* dst = sm + (p * ROWS + l % ROWS) * kPitch + 4 * q;
      const int gx = x0 - kHalo + 4 * q;
      if (vec && gx >= 0 && gx + 3 < W) {
        cp_async16(dst, row + gx, 16);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) cp_async4(dst + j, row + clampi(gx + j, 0, W - 1), 4);
      }
    }
}

// 4 pixels of one row from global memory: one 16-byte load where the row
// allows it (vec), else up to 4 scalar loads; 0 outside the image
__device__ __forceinline__ float4 load_quad_cs(const float* p, int x, int W, bool ok,
                                               bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!ok || x >= W) return v;
  if (vec) return __ldcs(reinterpret_cast<const float4*>(p));
  v.x = __ldcs(p);
  if (x + 1 < W) v.y = __ldcs(p + 1);
  if (x + 2 < W) v.z = __ldcs(p + 2);
  if (x + 3 < W) v.w = __ldcs(p + 3);
  return v;
}

template <bool STREAM>
__device__ __forceinline__ void store_quad(float* p, float4 v, int x, int W, bool vec) {
  if (x >= W) return;
  if (vec) {
    if (STREAM) __stcs(reinterpret_cast<float4*>(p), v);
    else *reinterpret_cast<float4*>(p) = v;
    return;
  }
  p[0] = v.x;
  if (x + 1 < W) p[1] = v.y;
  if (x + 2 < W) p[2] = v.z;
  if (x + 3 < W) p[3] = v.w;
}

// x / y rounded to nearest from r = 1 / y: one correction step on x * r
// (Markstein) gives the correctly rounded quotient for finite x and y away
// from the overflow and underflow ranges, i.e. the value the IEEE division
// gives, in 3 operations instead of a division's call sequence
// (tests/test_torch_par.py holds it to x / y over the ranges K4 divides)
__device__ __forceinline__ float div_by(float x, float y, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, y, x), r, q);
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// ---------------------------------------------------------------- K4 ----

constexpr int kAffPW = (kAffRows + 2 * kHalo) * kPitch;  // words a staged plane

// one-pass moments of the 3 channels over dilation d's 8 neighbours
template <int R>
__device__ __forceinline__ void moments_group(float (&s1)[3][4], float (&s2)[3][4],
                                              const float* s, int d) {
  const float* const rows[3] = {s - d * kPitch, s, s + d * kPitch};
#pragma unroll
  for (int o = 0; o < 8; ++o)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float4 v = neighbour<R>(rows, o, d, c * kAffPW);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s1[c][j] += comp(v, j);
        s2[c][j] += comp(v, j) * comp(v, j);
      }
    }
}

// logits of dilation d's 8 neighbours: the mean over RGB of -(|I_k - I| inv)^2
template <int R>
__device__ __forceinline__ void logits_group(float (&logit)[8][4], const float* s, int d,
                                             const float (&c0)[3][4],
                                             const float (&inv)[3][4]) {
  const float* const rows[3] = {s - d * kPitch, s, s + d * kPitch};
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float4 v = neighbour<R>(rows, o, d, c * kAffPW);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t = fabsf(comp(v, j) - c0[c][j]) * inv[c][j];
        acc[j] += -(t * t);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) logit[o][j] = div_by(acc[j], 3.f, 1.f / 3.f);
  }
}

// neighbour o of dilation d for the 4 pixels (y, x..x+3) of plane p, read
// through L2 from clamped coordinates (dilations above kHalo)
__device__ __forceinline__ float4 far_quad(const float* __restrict__ p, int o, int d, int y,
                                           int x, int H, int W) {
  const float* row = p + (size_t)clampi(y + dy_of(o) * d, 0, H - 1) * W;
  const int x0 = x + dx_of(o) * d;
  return make_float4(__ldg(row + clampi(x0, 0, W - 1)), __ldg(row + clampi(x0 + 1, 0, W - 1)),
                     __ldg(row + clampi(x0 + 2, 0, W - 1)), __ldg(row + clampi(x0 + 3, 0, W - 1)));
}

// K4: per pixel, one-pass moments over the 8n neighbours (unbiased std),
// appearance logits averaged over RGB, softmax over the neighbours, plus
// the host-computed positional weights posw; n dilations dils, each at
// most kHalo read from the staged rows, larger ones through L2.  8 logits
// a pixel are held at a time: two sweeps over the dilations, the first for
// the softmax's running max and sum, the second recomputing each
// dilation's logits to write its weights.  One block per 8 x 64 tile.
__global__ void __launch_bounds__(kAffRows * kQuads)
par_affinity_kernel(const float* __restrict__ img, float* __restrict__ aff,
                    const float* __restrict__ posw, const int* __restrict__ dils, int n_dil,
                    int H, int W, float w1, bool vec_in, bool vec_out) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tx = threadIdx.x % kQuads, ty = threadIdx.x / kQuads;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kAffRows, b = blockIdx.z;
  const int x = x0 + 4 * tx, y = y0 + ty;
  const size_t plane = (size_t)H * W;
  const float* img_b = img + (size_t)b * 3 * plane;
  constexpr int kRows = kAffRows + 2 * kHalo;
  stage_rows<kRows, kAffRows * kQuads>(sm, img_b, 3, y0 - kHalo, 0, kRows, x0, H, W, vec_in);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (y >= H) return;
  const float* s = sm + (ty + kHalo) * kPitch + kHalo + 4 * tx;
  const int n = 8 * n_dil;

  float c0[3][4], s1[3][4], s2[3][4];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float4 v = quad_at(s + c * kAffPW, 0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c0[c][j] = comp(v, j);
      s1[c][j] = 0.f;
      s2[c][j] = 0.f;
    }
  }
  for (int g = 0; g < n_dil; ++g) {
    const int d = dils[g];
    if (d > kHalo) {
#pragma unroll
      for (int o = 0; o < 8; ++o)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float4 v = far_quad(img_b + c * plane, o, d, y, x, H, W);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s1[c][j] += comp(v, j);
            s2[c][j] += comp(v, j) * comp(v, j);
          }
        }
      continue;
    }
    switch (d & 3) {
      case 0: moments_group<0>(s1, s2, s, d); break;
      case 1: moments_group<1>(s1, s2, s, d); break;
      case 2: moments_group<2>(s1, s2, s, d); break;
      default: moments_group<3>(s1, s2, s, d); break;
    }
  }
  float inv[3][4];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float mean = s1[c][j] / (float)n;
      const float var = fmaxf((s2[c][j] - (float)n * mean * mean) / (float)(n - 1), 0.f);
      inv[c][j] = 1.f / ((sqrtf(var) + 1e-8f) * w1);
    }
  // the 8 logits of group g, from the staged rows or through L2
  float logit[8][4];
  const auto group_logits = [&](int g) {
    const int d = dils[g];
    if (d > kHalo) {
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float4 v = far_quad(img_b + c * plane, o, d, y, x, H, W);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float t = fabsf(comp(v, j) - c0[c][j]) * inv[c][j];
            acc[j] += -(t * t);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) logit[o][j] = div_by(acc[j], 3.f, 1.f / 3.f);
      }
      return;
    }
    switch (d & 3) {
      case 0: logits_group<0>(logit, s, d, c0, inv); break;
      case 1: logits_group<1>(logit, s, d, c0, inv); break;
      case 2: logits_group<2>(logit, s, d, c0, inv); break;
      default: logits_group<3>(logit, s, d, c0, inv); break;
    }
  };
  // pass 1: the softmax's max and sum over all groups, online
  float mx[4], sum[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mx[j] = -CUDART_INF_F;
    sum[j] = 0.f;
  }
  for (int g = 0; g < n_dil; ++g) {
    group_logits(g);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float m = mx[j];
#pragma unroll
      for (int o = 0; o < 8; ++o) m = fmaxf(m, logit[o][j]);
      float e = 0.f;
#pragma unroll
      for (int o = 0; o < 8; ++o) e += expf(logit[o][j] - m);
      sum[j] = sum[j] * expf(mx[j] - m) + e;
      mx[j] = m;
    }
  }
  float rsum[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) rsum[j] = 1.f / sum[j];
  // pass 2: each group's logits again, normalized, plus the positional term
  float* out = aff + (size_t)b * n * plane + (size_t)y * W + x;
  for (int g = 0; g < n_dil; ++g) {
    group_logits(g);
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const int k = 8 * g + o;
      const float pk = posw[k];
      float e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = div_by(expf(logit[o][j] - mx[j]), sum[j], rsum[j]) + pk;
      store_quad<true>(out + k * plane, make_float4(e[0], e[1], e[2], e[3]), x, W, vec_out);
    }
  }
}

// ---------------------------------------------------------------- K5 ----

// A K5 block walks down a column of 16 x 64 tiles.  Its shared window is a
// ring of kRing rows a plane: the 64 rows tile t reads (its rows and the
// halo) plus the 16 new rows of tile t + 1, staged while tile t computes,
// so each row is staged once and the staging hides behind the compute.
// The affinities stream two dilations ahead across tile boundaries.
constexpr int kRing = 2 * kPropRows + 2 * kHalo;       // 80 rows
constexpr int kRingPW = kRing * kPitch;
constexpr int kMaxChunk = kMaxSmem / (kRingPW * 4);    // 6 channels at once
static_assert(kMaxChunk >= 1, "a ring plane fits");

// acc[c] += aff_k * (neighbour k of channel c) for dilation d's 8
// neighbours, in k order; rows[i]: the thread's shared row at dy = (i - 1) d
template <int R, int CC>
__device__ __forceinline__ void propagate_group(float (&acc)[CC][4], const float4 (&a)[8],
                                                const float* const (&rows)[3], int d,
                                                int nc) {
#pragma unroll
  for (int c = 0; c < CC; ++c)
    if (c < nc) {
      // one channel's 8 neighbours together, so the quads that neighbours
      // at dx = -d, 0, +d of one row share are loaded once
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const float4 v = neighbour<R>(rows, o, d, c * kRingPW);
        acc[c][0] = fmaf(v.x, a[o].x, acc[c][0]);
        acc[c][1] = fmaf(v.y, a[o].y, acc[c][1]);
        acc[c][2] = fmaf(v.z, a[o].z, acc[c][2]);
        acc[c][3] = fmaf(v.w, a[o].w, acc[c][3]);
      }
    }
}

// the thread's 8 affinity quads of dilation g at tile t (zeros past the
// image or the block's last tile)
__device__ __forceinline__ void load_group(float4 (&a)[8], const float* aff_b, int t, int g,
                                           int t_end, int ty, int x, int H, int W,
                                           size_t plane, bool vec) {
  const int y = t * kPropRows + ty;
  const bool ok = t < t_end && y < H;
  const float* p = aff_b + (size_t)(ok ? y : 0) * W + x + (size_t)g * 8 * plane;
#pragma unroll
  for (int o = 0; o < 8; ++o) a[o] = load_quad_cs(p + o * plane, x, W, ok, vec);
}

// acc[c] += aff_k * (neighbour k of channel c) for dilation d's 8
// neighbours, read through L2 from clamped coordinates (dilations above
// kHalo, in the far form)
template <int CC>
__device__ __forceinline__ void propagate_far(float (&acc)[CC][4], const float4 (&a)[8],
                                              const float* __restrict__ src_c, size_t plane,
                                              int d, int y, int x, int H, int W, int nc) {
#pragma unroll
  for (int c = 0; c < CC; ++c)
    if (c < nc) {
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const float4 v = far_quad(src_c + c * plane, o, d, y, x, H, W);
        acc[c][0] = fmaf(v.x, a[o].x, acc[c][0]);
        acc[c][1] = fmaf(v.y, a[o].y, acc[c][1]);
        acc[c][2] = fmaf(v.z, a[o].z, acc[c][2]);
        acc[c][3] = fmaf(v.w, a[o].w, acc[c][3]);
      }
    }
}

// K5, one Jacobi step: dst[c] = sum_k aff_k * src[c] at the clamped k-th
// neighbour, summed in k order, for every channel c of 4 pixels.  Block
// (column, segment, image) walks the segment's tiles; channels go in chunks
// of CC (the last may hold fewer), each chunk one walk.  FAR: the far form
// (dilations from `dils`, those above kHalo read through L2); else they are
// unpacked from `dpack`.
template <int CC, bool FAR>
__global__ void __launch_bounds__(kPropRows * kQuads, 1)
par_propagate_kernel(const float* __restrict__ src, float* __restrict__ dst,
                     const float* __restrict__ aff, int dpack,
                     const int* __restrict__ dils, int n_dil, int C, int H, int W,
                     bool vec) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr int kThreads = kPropRows * kQuads;
  const int tx = threadIdx.x % kQuads, ty = threadIdx.x / kQuads;
  const int x0 = blockIdx.x * kTileW, x = x0 + 4 * tx, b = blockIdx.z;
  const int n_tiles = (H + kPropRows - 1) / kPropRows;
  const int t_begin = blockIdx.y * n_tiles / gridDim.y;
  const int t_end = (blockIdx.y + 1) * n_tiles / gridDim.y;
  if (t_begin >= t_end) return;
  const size_t plane = (size_t)H * W;
  const float* aff_b = aff + (size_t)b * 8 * n_dil * plane;
  const int ytop = t_begin * kPropRows - kHalo;  // image row of window row 0
  const float* col = sm + kHalo + 4 * tx;
  for (int c0 = 0; c0 < C; c0 += CC) {
    const int nc = min(CC, C - c0);
    const float* src_c = src + ((size_t)b * C + c0) * plane;
    if (c0 > 0) __syncthreads();  // the last chunk's reads are done
    stage_rows<kRing, kThreads>(sm, src_c, nc, ytop, 0, kRing - kPropRows, x0, H, W, vec);
    cp_async_commit();
    // the first two dilations' affinities are in flight while it lands
    float4 cur[8], nxt[8], far[8];
    load_group(cur, aff_b, t_begin, 0, t_end, ty, x, H, W, plane, vec);
    load_group(nxt, aff_b, n_dil > 1 ? t_begin : t_begin + 1, n_dil > 1 ? 1 : 0, t_end, ty,
               x, H, W, plane, vec);
    // (tile, dilation) of the step in nxt
    int t2 = n_dil > 1 ? t_begin : t_begin + 1, g2 = n_dil > 1 ? 1 : 0;
    for (int t = t_begin; t < t_end; ++t) {
      const int l0 = (t - t_begin) * kPropRows;  // window row of the tile's top halo row
      cp_async_wait<0>();
      __syncthreads();  // tile t's rows landed; tile t - 1's reads done
      if (t + 1 < t_end)
        stage_rows<kRing, kThreads>(sm, src_c, nc, ytop, l0 + kRing - kPropRows, l0 + kRing,
                                    x0, H, W, vec);
      cp_async_commit();
      const int mid = (l0 + kHalo + ty) % kRing;  // the thread's own row
      float acc[CC][4];
#pragma unroll
      for (int c = 0; c < CC; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[c][j] = 0.f;
      for (int g = 0; g < n_dil; ++g) {
        if (++g2 == n_dil) {
          g2 = 0;
          ++t2;
        }
        load_group(far, aff_b, t2, g2, t_end, ty, x, H, W, plane, vec);
        const int d = FAR ? dils[g] : dil_of(dpack, g);
        if (FAR && d > kHalo) {
          propagate_far(acc, cur, src_c, plane, d, t * kPropRows + ty, x, H, W, nc);
#pragma unroll
          for (int o = 0; o < 8; ++o) {
            cur[o] = nxt[o];
            nxt[o] = far[o];
          }
          continue;
        }
        int up = mid - d, down = mid + d;
        if (up < 0) up += kRing;
        if (down >= kRing) down -= kRing;
        const float* const rows[3] = {col + up * kPitch, col + mid * kPitch,
                                      col + down * kPitch};
        switch (d & 3) {
          case 0: propagate_group<0>(acc, cur, rows, d, nc); break;
          case 1: propagate_group<1>(acc, cur, rows, d, nc); break;
          case 2: propagate_group<2>(acc, cur, rows, d, nc); break;
          default: propagate_group<3>(acc, cur, rows, d, nc); break;
        }
#pragma unroll
        for (int o = 0; o < 8; ++o) {
          cur[o] = nxt[o];
          nxt[o] = far[o];
        }
      }
      const int y = t * kPropRows + ty;
      if (y < H) {
        float* out = dst + ((size_t)b * C + c0) * plane + (size_t)y * W + x;
#pragma unroll
        for (int c = 0; c < CC; ++c)
          if (c < nc)
            store_quad<false>(out + c * plane,
                              make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]), x,
                              W, vec);
      }
    }
  }
}

// ------------------------------------------------------------- launch ----

template <typename Kernel>
cudaError_t allow_smem(Kernel kern, int bytes) {
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// the dilations packed 5 bits each, or -1 if the packed form does not take
// them (more than kMaxDil, or one outside [1, kHalo])
int pack_dilations(const int* dil, int n_dil) {
  if (n_dil < 1 || n_dil > kMaxDil) return -1;
  int pack = 0;
  for (int i = 0; i < n_dil; ++i) {
    if (dil[i] < 1 || dil[i] > kHalo) return -1;
    pack |= dil[i] << (5 * i);
  }
  return pack;
}

// `num_iter` launches; iteration 0 reads src, and the buffers alternate so
// that the last iteration writes dst (tmp is scratch, unused at 1 iteration).
// Each tile column is cut into as many segments as leave one block per SM.
template <int CC, bool FAR>
cudaError_t launch_propagate(const float* src, float* dst, float* tmp, const float* aff,
                             int dpack, const int* dils, int n_dil, int B, int C, int H, int W,
                             int num_iter, bool vec, cudaStream_t s) {
  const int smem = CC * kRingPW * (int)sizeof(float);
  cudaError_t e = allow_smem(par_propagate_kernel<CC, FAR>, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  const int cols = (W + kTileW - 1) / kTileW, n_tiles = (H + kPropRows - 1) / kPropRows;
  const int segments = max(1, min(n_tiles, sms / (cols * B)));
  const dim3 grid(cols, segments, B);
  const float* in = src;
  for (int it = 0; it < num_iter; ++it) {
    float* out = (num_iter - 1 - it) % 2 == 0 ? dst : tmp;
    par_propagate_kernel<CC, FAR><<<grid, kPropRows * kQuads, smem, s>>>(
        in, out, aff, dpack, dils, n_dil, C, H, W, vec);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    in = out;
  }
  return cudaSuccess;
}

// num_iter Jacobi iterations from src (left untouched) into dst; tmp is a
// second buffer of src's size, needed when num_iter > 1.  FAR: the far
// form, the dilations read from `dils` (device); else the packed `dpack`.
template <bool FAR>
cudaError_t propagate(const void* src, void* dst, void* tmp, const void* aff, int B, int C,
                      int H, int W, int dpack, const int* dils, int n_dil, int num_iter,
                      void* stream) {
  if (n_dil < 1 || C < 1 || B < 1 || H < 1 || W < 1 || num_iter < 0 ||
      (num_iter > 1 && tmp == nullptr))
    return cudaErrorInvalidValue;
  const float* i = static_cast<const float*>(src);
  float* o = static_cast<float*>(dst);
  float* t = static_cast<float*>(tmp);
  const float* a = static_cast<const float*>(aff);
  const bool vec = W % 4 == 0 && aligned16(i) && aligned16(o) && aligned16(a) &&
                   (num_iter < 2 || aligned16(t));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // balanced chunks of at most kMaxChunk channels
  const int chunks = (C + kMaxChunk - 1) / kMaxChunk, cc = (C + chunks - 1) / chunks;
#define PAR_PROPAGATE(CC) \
  case CC: return launch_propagate<CC, FAR>(i, o, t, a, dpack, dils, n_dil, B, C, H, W, \
                                            num_iter, vec, s)
  switch (cc) {
    PAR_PROPAGATE(1);
    PAR_PROPAGATE(2);
    PAR_PROPAGATE(3);
    PAR_PROPAGATE(4);
    PAR_PROPAGATE(5);
    default: return launch_propagate<kMaxChunk, FAR>(i, o, t, a, dpack, dils, n_dil, B, C, H,
                                                     W, num_iter, vec, s);
  }
#undef PAR_PROPAGATE
}

}  // namespace

// K4, any set: dils, the n_dil dilations, and posw, the 8 * n_dil
// positional weights, both in device memory; each dilation in [1,
// max(H, W) - 1] (the wrapper clamps them; not checked here)
extern "C" int par_affinity(const void* img, void* aff, const void* posw, int B, int H, int W,
                            const void* dils, int n_dil, float w1, void* stream) {
  if (n_dil < 1 || B < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  const float* i = static_cast<const float*>(img);
  float* a = static_cast<float*>(aff);
  const bool vec_in = W % 4 == 0 && aligned16(i), vec_out = W % 4 == 0 && aligned16(a);
  const int smem = 3 * kAffPW * (int)sizeof(float);
  const cudaError_t e = allow_smem(par_affinity_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kAffRows - 1) / kAffRows, B);
  par_affinity_kernel<<<grid, kAffRows * kQuads, smem, static_cast<cudaStream_t>(stream)>>>(
      i, a, static_cast<const float*>(posw), static_cast<const int*>(dils), n_dil, H, W, w1,
      vec_in, vec_out);
  return cudaGetLastError();
}

// K5 in the packed form: at most kMaxDil dilations in [1, kHalo], in host
// memory
extern "C" int par_propagate(const void* src, void* dst, void* tmp, const void* aff,
                             int B, int C, int H, int W, const void* dilations,
                             int n_dil, int num_iter, void* stream) {
  const int dpack = pack_dilations(static_cast<const int*>(dilations), n_dil);
  if (dpack < 0) return cudaErrorInvalidValue;
  return propagate<false>(src, dst, tmp, aff, B, C, H, W, dpack, nullptr, n_dil, num_iter,
                          stream);
}

// K5 in the far form, any set (dils as for par_affinity)
extern "C" int par_propagate_far(const void* src, void* dst, void* tmp, const void* aff,
                                 int B, int C, int H, int W, const void* dils, int n_dil,
                                 int num_iter, void* stream) {
  return propagate<true>(src, dst, tmp, aff, B, C, H, W, 0, static_cast<const int*>(dils),
                         n_dil, num_iter, stream);
}
