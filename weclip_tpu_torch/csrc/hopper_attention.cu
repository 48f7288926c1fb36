// The bf16 attention forwards on Hopper's warpgroup tensor-core products
// (wgmma) and tensor-memory loads (TMA), for sm_90a: the CoMer CTI
// cross-attention forward (K6), and the self-attention forward of K1 (its
// first launch, the row statistics) and K2 at the widths and shapes
// ops/attention_kernels.py::forward_design gives it.  Plain C entry points,
// loaded with ctypes by weclip_tpu_torch/kernels.py; wrappers
// ops/attention_kernels.py::cross_attention_core and attention_core.
// Under fp32, and under bf16 above head width 128, K6 is
// cross_attention.cu's key-tiled forward; K1 and K2 elsewhere are
// flash_attention.cu's (bf16) or cross_attention.cu's.
//
// Replaces (weclip_tpu/ops/pallas_attention.py), under bf16:
//   K6  cross_attention_core_pallas   (_attn_kernel, no export; :539, pallas_call :582)
//   K1  attention_core_pallas(export_weights=True), its forward (:195, pallas_call :260)
//   K2  attention_core_pallas(export_weights=False)
//
// K6's numerics follow the Pallas kernel and flash_attention.cu's forward: q
// arrives pre-scaled (scale 1), fp32 scores and softmax, an additive -1e30
// key bias padded with -1e30 to whole 64-key tiles by the wrapper, the
// all-masked row guard max(smax, -5e29), denominator >= 1e-30, one sweep
// with online softmax, P rounded to bf16 against the running max (the
// plain version rounds against the final max: at most one bf16 rounding of
// P apart), normalized after P V, fp32 out.
//
// What bounds it on the H100: operations.  At the eval shape (16, 4, 5376,
// 64) x 1024 keys it does 4*B*H*Lq*Lk*Dh = 90 GFLOP (0.091 ms at the bf16
// peak) and moves 30 MB (9 us).  Only wgmma reaches the tensor cores' full
// rate, so the design is Hopper's: a block of two consumer warpgroups
// (64 query rows each) and one producer warp per (image, head, 128 query
// rows).  The producer's one thread copies the block's q rows once and then
// keeps a ring of three 64-key K/V tiles (and their key biases) full with
// TMA, each stage's arrival counted on an mbarrier, and waits on a second
// mbarrier per stage for the consumers to release it, so loads run under
// the products.  TMA writes each 64-row tile in the swizzled layout
// (128-byte swizzle for Dh 64, whose bf16 row is 128 bytes; 64-byte for Dh
// 32) that wgmma's shared-memory descriptors read: S = q K^T with both
// operands K-major from shared memory (K row-major is K-major for B), the
// online softmax on the accumulator registers, and O += P V with P as
// bf16 A fragments in registers (wgmma's register-A layout is its
// accumulator layout, so no shuffle) and V read through the descriptor's
// transpose bit (V is MN-major).  Rows past Lq and keys past Lk are
// zero-filled by TMA; the padded bias masks those keys and the epilogue
// skips those rows.
//
// Head widths.  The kernel is compiled at Dh 16, 32, 64 and 128 (DH), with
// the swizzle of a DH-wide bf16 row (32-, 64- and 128-byte).  A 128-wide
// row (256 bytes) is more than the 128-byte swizzle span, so each 64-row
// tile is two 64-column TMA boxes, one after the other, S = q K^T takes 8
// k-steps across both, and P V reads the two boxes of V as one N = 128
// operand (the descriptor's leading offset steps from one box to the next;
// at DH 128 one block fits an SM, so the accumulators get the registers of
// one block).  A width Dh that is a multiple of 8 and not one of these
// (PAD) runs the next one up: the tensor maps keep the true width, so TMA
// fills the lanes d >= Dh of every box with zeros, which leave the scores
// unchanged, and the epilogue writes the Dh true columns.  TMA needs the
// global row stride to be a multiple of 16 bytes, so other widths are
// refused here; the wrapper hands them over zero-padded to a multiple of 8.
// Above 128 the wrapper runs cross_attention.cu's bf16 forward, which
// stages q and K a 128-column chunk at a time: this kernel keeps the
// block's q and its K ring at full width, 255,800 bytes of shared memory
// at Dh 320 (q 81,920, three K stages 122,880, three 128-column V stages
// 49,152, biases, barriers and the alignment), past the 232,448 a block
// can have (Dh 256 would fit in 214,840).
//
// The self-attention forward (K1's first launch, K2).  Numerics are
// flash_attention.cu's forward: q staged as bf16(float(q) * scale) (TMA
// brings it unscaled; the consumer warpgroup scales the rows in shared
// memory once, then fences them over to the products' proxy), fp32
// scores, the padded -1e30 key bias, the guard max(smax, -5e29), the
// floor 1e-30, P rounded to bf16 against the running max, normalized after
// P V, bf16 out (B, H, L, Dh), and under K1 each row's (max, 1/sum) in
// `stats` for flash_attention.cu's map kernel.  exp(x) is 2^(x log2 e) on
// the SFU with the product folded into one fma: within a few fp32 ulps of
// expf, not bit-equal.  Design: K6's data path (a producer warp keeping a
// ring of four 64-key K/V tiles and their bias slices full with TMA; a
// consumer warpgroup of 64 query rows; S = q K^T as m64n64k16 from 128-byte
// swizzled shared memory; P fed back as the register A operand of
// O += P V), with the softmax taken off the products' path.  At head
// width 64 each score costs 256 FLOP of products and one exp: the tensor
// cores retire 3.9e12 scores/s at the bf16 peak, the SFU about 3.7e12
// exps/s, so a kernel that runs them in turn tops out near half of
// either.  Within the warpgroup, tile j's scores and tile j - 1's P V are
// issued as two commit groups; the softmax of tile j waits for the first
// (wgmma.wait_group 1) and runs under the second, its P kept in fp32 in
// the score registers until P V has read the last fragments.  A block is
// one warpgroup of 64 query rows (120 registers, 74 KB of shared memory):
// three blocks share an SM, and their warpgroups' products and softmaxes
// interleave.  Two warpgroups of a 128-row block taking turns through
// named barriers (the order FlashAttention-3 gives them) fit one block to
// an SM and ran 25% slower on the H100 (245 against 325 TFLOP/s at
// (8, 16, 1370, 64)); three of a 192-row block, 291 with turns and 292
// without; q in registers, or two 64-key tiles a step, made ptxas
// serialize the products; four blocks to an SM spilled.

#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time

#include "common.cuh"

using namespace weclip;

namespace {

constexpr int kConsumers = 2;                      // warpgroups of 64 query rows
constexpr int kRows = 64 * kConsumers;             // query rows per block
constexpr int kKeys = 64;                          // keys per staged tile
constexpr int kStages = 3;                         // K/V tiles in flight
constexpr int kThreads = 128 * kConsumers + 32;    // and one producer warp
constexpr int kMinBlocks = 2;                      // blocks per SM the registers allow (DH <= 64)
constexpr float kFloor = -5e29f;                   // the all-masked row guard of the max

// shared memory (bytes from a 1024-aligned base): ROWS q rows, the K
// ring, the V ring, the key-bias ring (STAGES tiles each), then the
// mbarriers (full[STAGES], empty[STAGES], q)
template <int DH, int ROWS = kRows, int STAGES = kStages>
struct Layout {
  static constexpr int kRowBytes = DH * 2;
  static constexpr int kSpan = DH > 64 ? 64 : DH;        // columns of one TMA box
  static constexpr int kBoxBytes = 64 * kSpan * 2;       // one box of 64 rows
  static constexpr int kBoxes = DH / kSpan;              // boxes across a row
  static constexpr int kTile = kKeys * kRowBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + ROWS * kRowBytes;
  static constexpr int kV = kK + STAGES * kTile;
  static constexpr int kBias = kV + STAGES * kTile;
  static constexpr int kBar = kBias + STAGES * kKeys * 4;
  static constexpr int kBytes = kBar + (2 * STAGES + 1) * 8;
  static_assert(kK % 1024 == 0 && kTile % 1024 == 0, "tiles stay on the swizzle period");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box of a 3-D tensor map (coordinates innermost first) into shared
// memory, counted on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes into shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a tile that TMA wrote with the
// swizzle of a box row (128-byte for Dh 64 and 128, 64-byte for Dh 32,
// 32-byte for Dh 16).  The stride offset is that of 8-row groups.  The
// leading offset is unused by a K-major operand (its 16-element K extent
// lies in one swizzle row) and by an MN-major one (V) whose N fits one box
// row; at Dh 128 V's N spans two boxes, and it is the offset between them.
template <int DH>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr int kSpan = Layout<DH>::kSpan;
  constexpr uint64_t kGroup = (8 * kSpan * 2) >> 4;
  constexpr uint64_t kLead = DH > 64 ? Layout<DH>::kBoxBytes >> 4 : kGroup;
  constexpr uint64_t kSwizzle = kSpan == 64 ? 1 : (kSpan == 32 ? 2 : 3);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (kLead << 16) | (kGroup << 32) | (kSwizzle << 62);
}

// byte offset of k-step kk (16 columns of Dh) in a staged 64-row tile
template <int DH>
__device__ __forceinline__ uint32_t kstep(int kk) {
  constexpr int kSpan = Layout<DH>::kSpan;
  return (kk * 16 / kSpan) * Layout<DH>::kBoxBytes + (kk * 16 % kSpan) * 2;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N of this warpgroup's committed product groups are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of these registers across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, fp32) (+)= A (64 x 16, shared memory) B^T (B: 64 x 16, shared
// memory), both K-major; d is zeroed first unless `accumulate`
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 registers) B (16 x 64, shared
// memory, MN-major: the descriptor's transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32, fp32) += A (64 x 16, bf16 registers) B (16 x 32, shared
// memory, MN-major: the descriptor's transpose bit)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 registers) B (16 x 128, shared
// memory, MN-major: the descriptor's transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 16, fp32) += A (64 x 16, bf16 registers) B (16 x 16, shared
// memory, MN-major: the descriptor's transpose bit)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&d)[DH / 2], const uint32_t* a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64], const uint32_t* a, uint64_t b) {
  wgmma_rs_n128(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_pv<16>(float (&d)[8], const uint32_t* a, uint64_t b) {
  wgmma_rs_n16(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32], const uint32_t* a, uint64_t b) {
  wgmma_rs_n64(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_pv<32>(float (&d)[16], const uint32_t* a, uint64_t b) {
  wgmma_rs_n32(d, a, b);
}

// the producer's one thread: the block's `groups` x 64 q rows once, then
// every 64-key K/V tile and its key-bias slice through a ring of STAGES,
// each stage refilled once the consumers' warps have released it
template <typename S, int STAGES>
__device__ __forceinline__ void produce(uint32_t base, const CUtensorMap* tq,
                                        const CUtensorMap* tk, const CUtensorMap* tv,
                                        const float* kbias, int b, int bh, int q0, int groups,
                                        int ntiles) {
  const uint32_t bars = base + S::kBar, qbar = bars + 16 * STAGES;
  mbar_expect_tx(qbar, groups * 64 * S::kRowBytes);
  for (int i = 0; i < groups; ++i)
    for (int x = 0; x < S::kBoxes; ++x)
      tma_load_3d(base + S::kQ + i * 64 * S::kRowBytes + x * S::kBoxBytes, tq, qbar,
                  x * S::kSpan, q0 + 64 * i, bh);
  const float* bias = kbias + (size_t)b * ntiles * kKeys;
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % STAGES, round = it / STAGES;
    const uint32_t full = bars + 8 * s, empty = bars + 8 * (STAGES + s);
    if (round > 0) mbar_wait(empty, (round - 1) & 1);
    mbar_expect_tx(full, 2 * S::kTile + kKeys * 4);
    for (int x = 0; x < S::kBoxes; ++x) {
      tma_load_3d(base + S::kK + s * S::kTile + x * S::kBoxBytes, tk, full, x * S::kSpan,
                  it * kKeys, bh);
      tma_load_3d(base + S::kV + s * S::kTile + x * S::kBoxBytes, tv, full, x * S::kSpan,
                  it * kKeys, bh);
    }
    bulk_load(base + S::kBias + s * kKeys * 4, bias + it * kKeys, kKeys * 4, full);
  }
}

// ---------------------------------------------------------------------------
// K6, bf16: one block per (image, head, 128 query rows); warps 0-7 are two
// consumer warpgroups, warp 8 the producer
// ---------------------------------------------------------------------------

template <int DH, bool PAD>
__global__ void __launch_bounds__(kThreads, DH > 64 ? 1 : kMinBlocks)
xattn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const float* __restrict__ kbias,
                       float* __restrict__ out, int H, int Lq, int Lk, int ld) {
  using S = Layout<DH>;
  const int rw = PAD ? ld : DH;   // the row width in global memory
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* sm = smem_raw + (base - raw);
  const uint32_t bars = base + S::kBar;
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t qbar = bars + 16 * kStages;

  const int bh = blockIdx.y, b = bh / H, q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntiles = (Lk + kKeys - 1) / kKeys;
  // the second warpgroup has no rows in a last block of at most 64
  const int groups = Lq - q0 > 64 ? 2 : 1;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * groups);   // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {
    if (lane == 0) produce<S, kStages>(base, &tq, &tk, &tv, kbias, b, bh, q0, groups, ntiles);
    return;
  }

  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;
  if (wg >= groups) return;
  const uint32_t qa = base + S::kQ + wg * 64 * S::kRowBytes;
  // rows 16 w + g and 16 w + g + 8 of this warpgroup's 64: running max,
  // sum, and the 64 x DH accumulator (DH / 8 column chunks of 4)
  float m0 = kFloor, m1 = kFloor, l0 = 0.f, l1 = 0.f;
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  mbar_wait(qbar, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kStages;
    mbar_wait(full(s), (it / kStages) & 1);
    const uint32_t kt = base + S::kK + s * S::kTile, vt = base + S::kV + s * S::kTile;
    float sc[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)   // 16 bf16 (32 bytes) of Dh per step
      wgmma_ss_n64(sc, desc<DH>(qa + kstep<DH>(kk)), desc<DH>(kt + kstep<DH>(kk)), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    // sc[4 i + e]: key 8 i + 2 t + (e & 1), row g (e < 2) or g + 8
    const float* bs = reinterpret_cast<const float*>(sm + S::kBias + s * kKeys * 4);
    float n0 = m0, n1 = m1;
#pragma unroll
    for (int i = 0; i < kKeys / 8; ++i) {
      const float b0 = bs[8 * i + 2 * t], b1 = bs[8 * i + 2 * t + 1];
      sc[4 * i] += b0;
      sc[4 * i + 1] += b1;
      sc[4 * i + 2] += b0;
      sc[4 * i + 3] += b1;
      n0 = fmaxf(n0, fmaxf(sc[4 * i], sc[4 * i + 1]));
      n1 = fmaxf(n1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
    n0 = quad_max(n0);
    n1 = quad_max(n1);
    const float a0 = expf(m0 - n0), a1 = expf(m1 - n1);   // 1 while the max holds
    m0 = n0;
    m1 = n1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i) {
      o[4 * i] *= a0;
      o[4 * i + 1] *= a0;
      o[4 * i + 2] *= a1;
      o[4 * i + 3] *= a1;
    }
    // P as A fragments: keys [16 c, 16 c + 16) are pa[4 c .. 4 c + 3]
    uint32_t pa[kKeys / 4];
#pragma unroll
    for (int i = 0; i < kKeys / 8; ++i) {
      const float e0 = expf(sc[4 * i] - m0), e1 = expf(sc[4 * i + 1] - m0);
      const float e2 = expf(sc[4 * i + 2] - m1), e3 = expf(sc[4 * i + 3] - m1);
      l0 += e0 + e1;
      l1 += e2 + e3;
      pa[2 * i] = pack_bf16(e0, e1);       // row g
      pa[2 * i + 1] = pack_bf16(e2, e3);   // row g + 8
    }
    wg_fence();
#pragma unroll
    for (int c = 0; c < kKeys / 16; ++c)   // 16 keys (16 V rows) per step
      wgmma_pv<DH>(o, pa + 4 * c, desc<DH>(vt + c * 16 * S::kSpan * 2));
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));   // this warp is done with stage s
  }
  const float r0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float r1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  const int row = q0 + 64 * wg + 16 * w + g;
  float* ob = out + (size_t)bh * Lq * rw;
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    const int col = 8 * i + 2 * t;
    if (PAD && col >= rw) continue;   // rw is a multiple of 8: col + 1 < rw too
    if (row < Lq)
      *reinterpret_cast<float2*>(ob + (size_t)row * rw + col) =
          make_float2(o[4 * i] * r0, o[4 * i + 1] * r0);
    if (row + 8 < Lq)
      *reinterpret_cast<float2*>(ob + (size_t)(row + 8) * rw + col) =
          make_float2(o[4 * i + 2] * r1, o[4 * i + 3] * r1);
  }
}

// ---------------------------------------------------------------------------
// K1's forward and K2, bf16: the self-attention forward on K6's data path,
// the softmax overlapped with the products.  One block per (image, head,
// 64 query rows): one consumer warpgroup, then the producer warp.  The
// kernel is K6's sibling under K6's name in a namespace of its own, so a
// profile's attention kernels (the benchmark's kernel list) are found by
// one name whichever of the two runs.
// ---------------------------------------------------------------------------

constexpr int kSelfStages = 4;                     // K/V tiles in flight
constexpr int kSelfThreads = 128 + 32;             // one consumer warpgroup, one producer warp
constexpr float kLog2e = 1.4426950408889634f;

// named barrier `ID` over `THREADS` threads
template <int ID, int THREADS>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(THREADS) : "memory");
}

// 2^x on the SFU (subnormal results flushed to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// sc (64 x 64 scores, fp32) = A (64 x DH, shared memory) K^T: one group of
// DH / 16 products, committed, not waited for
template <int DH>
__device__ __forceinline__ void scores(float (&sc)[32], uint32_t qa, uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss_n64(sc, desc<DH>(qa + kstep<DH>(kk)), desc<DH>(kt + kstep<DH>(kk)), kk > 0);
  wg_commit();
}

// o (64 x DH) += P (bf16 A fragments) V: one group of 4 products, committed
template <int DH>
__device__ __forceinline__ void values(float (&o)[DH / 2], const uint32_t (&pa)[kKeys / 4],
                                       uint32_t vt) {
#pragma unroll
  for (int c = 0; c < kKeys / 16; ++c)   // 16 keys (16 V rows) per step
    wgmma_pv<DH>(o, pa + 4 * c, desc<DH>(vt + c * 16 * Layout<DH>::kSpan * 2));
  wg_commit();
}

// The online softmax of one 64-key tile, in place: sc (rows g and g + 8 of
// each warp's 16; sc[4 i + e] is key 8 i + 2 t + (e & 1), row g + 8 (e >> 1))
// plus the key bias becomes P = exp(s - max) against the running max m,
// a = exp(m_old - m) the factor of what came before, l the running sum
// (this thread's columns).  exp(x) is taken as 2^(x log2 e), the product
// folded into one fma.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], const float* bs, int t,
                                             float& m0, float& m1, float& l0, float& l1,
                                             float& a0, float& a1) {
  float n0 = m0, n1 = m1;
#pragma unroll
  for (int i = 0; i < kKeys / 8; ++i) {
    const float b0 = bs[8 * i + 2 * t], b1 = bs[8 * i + 2 * t + 1];
    sc[4 * i] += b0;
    sc[4 * i + 1] += b1;
    sc[4 * i + 2] += b0;
    sc[4 * i + 3] += b1;
    n0 = fmaxf(n0, fmaxf(sc[4 * i], sc[4 * i + 1]));
    n1 = fmaxf(n1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
  }
  n0 = quad_max(n0);
  n1 = quad_max(n1);
  a0 = ex2((m0 - n0) * kLog2e);   // 1 while the max holds
  a1 = ex2((m1 - n1) * kLog2e);
  m0 = n0;
  m1 = n1;
  const float c0 = n0 * kLog2e, c1 = n1 * kLog2e;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int i = 0; i < kKeys / 8; ++i) {
    sc[4 * i] = ex2(fmaf(sc[4 * i], kLog2e, -c0));
    sc[4 * i + 1] = ex2(fmaf(sc[4 * i + 1], kLog2e, -c0));
    sc[4 * i + 2] = ex2(fmaf(sc[4 * i + 2], kLog2e, -c1));
    sc[4 * i + 3] = ex2(fmaf(sc[4 * i + 3], kLog2e, -c1));
    s0 += sc[4 * i] + sc[4 * i + 1];
    s1 += sc[4 * i + 2] + sc[4 * i + 3];
  }
  l0 = l0 * a0 + s0;
  l1 = l1 * a1 + s1;
}

// P (fp32, in the accumulator layout) as bf16 A fragments: keys [16 c,
// 16 c + 16) are pa[4 c .. 4 c + 3]
__device__ __forceinline__ void to_fragments(uint32_t (&pa)[kKeys / 4], const float (&sc)[32]) {
#pragma unroll
  for (int i = 0; i < kKeys / 8; ++i) {
    pa[2 * i] = pack_bf16(sc[4 * i], sc[4 * i + 1]);       // row g
    pa[2 * i + 1] = pack_bf16(sc[4 * i + 2], sc[4 * i + 3]);   // row g + 8
  }
}

template <int DH>
__device__ __forceinline__ void rescale(float (&o)[DH / 2], float a0, float a1) {
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    o[4 * i] *= a0;
    o[4 * i + 1] *= a0;
    o[4 * i + 2] *= a1;
    o[4 * i + 3] *= a1;
  }
}

namespace self {

template <int DH, bool STATS>
__global__ void __launch_bounds__(kSelfThreads, 2)
xattn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const float* __restrict__ kbias,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ stats, int H, int L,
                       float scale) {
  using S = Layout<DH, 64, kSelfStages>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t bars = base + S::kBar;
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (kSelfStages + s); };
  const uint32_t qbar = bars + 16 * kSelfStages;

  const int bh = blockIdx.y, b = bh / H, q0 = blockIdx.x * 64;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntiles = (L + kKeys - 1) / kKeys;

  if (tid == 0) {
    for (int s = 0; s < kSelfStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);   // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    if (lane == 0) produce<S, kSelfStages>(base, &tq, &tk, &tv, kbias, b, bh, q0, 1, ntiles);
    return;
  }

  // q as bf16(float(q) * scale), in place (the swizzle moves 16-byte
  // chunks, each scaled alone), then published to the products' (async)
  // proxy
  const int w = warp, g = lane >> 2, t = lane & 3;
  const uint32_t qa = base + S::kQ;
  mbar_wait(qbar, 0);
  {
    uint4* qs = reinterpret_cast<uint4*>(sm + S::kQ);
    for (int i = tid; i < 64 * S::kRowBytes / 16; i += 128) qs[i] = scale8(qs[i], scale);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync<1, 128>();
  }

  float m0 = kFloor, m1 = kFloor, l0 = 0.f, l1 = 0.f, a0, a1;
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float sc[32];
  uint32_t pa[kKeys / 4];
  const auto bias_of = [&](int s) {
    return reinterpret_cast<const float*>(sm + S::kBias + s * kKeys * 4);
  };

  // tile 0: its scores, then their softmax
  mbar_wait(full(0), 0);
  wg_fence();
  scores<DH>(sc, qa, base + S::kK);
  wg_wait<0>();
  fence_regs(sc);
  softmax_tile(sc, bias_of(0), t, m0, m1, l0, l1, a0, a1);
  to_fragments(pa, sc);
  // tile it: its scores and the previous tile's P V go out together; the
  // softmax of tile it runs under P V
  for (int it = 1; it < ntiles; ++it) {
    const int s = it % kSelfStages, p = (it - 1) % kSelfStages;
    mbar_wait(full(s), (it / kSelfStages) & 1);
    rescale<DH>(o, a0, a1);
    wg_fence();
    scores<DH>(sc, qa, base + S::kK + s * S::kTile);
    values<DH>(o, pa, base + S::kV + p * S::kTile);
    wg_wait<1>();
    fence_regs(sc);
    softmax_tile(sc, bias_of(s), t, m0, m1, l0, l1, a0, a1);
    wg_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(p));   // this warp is done with stage p
    to_fragments(pa, sc);
  }
  rescale<DH>(o, a0, a1);
  wg_fence();
  values<DH>(o, pa, base + S::kV + ((ntiles - 1) % kSelfStages) * S::kTile);
  wg_wait<0>();
  fence_regs(o);

  const float r0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float r1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  const int row = q0 + 16 * w + g;
  const size_t rows0 = (size_t)bh * L;
  __nv_bfloat16* ob = out + rows0 * DH;
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) {
    const int col = 8 * i + 2 * t;
    if (row < L)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * DH + col) =
          __floats2bfloat162_rn(o[4 * i] * r0, o[4 * i + 1] * r0);
    if (row + 8 < L)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)(row + 8) * DH + col) =
          __floats2bfloat162_rn(o[4 * i + 2] * r1, o[4 * i + 3] * r1);
  }
  if (STATS && t == 0) {   // K1: each row's final (max, 1/sum) for the map kernel
    float* st = stats + (rows0 + row) * 2;
    if (row < L) { st[0] = m0; st[1] = r0; }
    if (row + 8 < L) { st[16] = m1; st[17] = r1; }
  }
}

}  // namespace self

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched through the runtime's entry-point query (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (B * H, L, Dh) bf16 array as a 3-D tensor map of boxes of 64 rows and
// `span` columns in the swizzle wgmma reads; rows past L and columns past
// Dh read as zeros
bool tensor_map(CUtensorMap* map, const void* p, int Dh, int span, int L, int BH) {
  const cuuint64_t dims[3] = {(cuuint64_t)Dh, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)Dh * 2, (cuuint64_t)L * Dh * 2};
  const cuuint32_t box[3] = {(cuuint32_t)span, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = span == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : span == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims, strides,
                   box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH, bool PAD>
cudaError_t launch(const void* q, const void* k, const void* v, const float* kbias, float* out,
                   int B, int H, int Lq, int Lk, int Dh, cudaStream_t s) {
  if (encoder() == nullptr) return cudaErrorNotSupported;
  constexpr int span = Layout<DH>::kSpan;
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, Dh, span, Lq, B * H) || !tensor_map(&mk, k, Dh, span, Lk, B * H) ||
      !tensor_map(&mv, v, Dh, span, Lk, B * H))
    return cudaErrorInvalidValue;
  constexpr int smem = Layout<DH>::kBytes + 1024;   // and room to align the base
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        xattn_fwd_wgmma_kernel<DH, PAD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  xattn_fwd_wgmma_kernel<DH, PAD><<<dim3((Lq + kRows - 1) / kRows, B * H), kThreads, smem, s>>>(
      mq, mk, mv, kbias, out, H, Lq, Lk, Dh);
  return cudaGetLastError();
}

template <int DH, bool STATS>
cudaError_t launch_self(const void* q, const void* k, const void* v, const float* kbias,
                        __nv_bfloat16* out, float* stats, int B, int H, int L, float scale,
                        cudaStream_t s) {
  if (encoder() == nullptr) return cudaErrorNotSupported;
  constexpr int span = Layout<DH>::kSpan;
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, DH, span, L, B * H) || !tensor_map(&mk, k, DH, span, L, B * H) ||
      !tensor_map(&mv, v, DH, span, L, B * H))
    return cudaErrorInvalidValue;
  constexpr int smem = Layout<DH, 64, kSelfStages>::kBytes + 1024;   // and the alignment
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(self::xattn_fwd_wgmma_kernel<DH, STATS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               smem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  self::xattn_fwd_wgmma_kernel<DH, STATS>
      <<<dim3((L + 63) / 64, B * H), kSelfThreads, smem, s>>>(mq, mk, mv, kbias, out, stats, H,
                                                               L, scale);
  return cudaGetLastError();
}

// K1's instance (with statistics) or K2's
template <int DH>
cudaError_t launch_width(const void* q, const void* k, const void* v, const float* kbias,
                         __nv_bfloat16* out, float* stats, int B, int H, int L, float scale,
                         cudaStream_t s) {
  return stats ? launch_self<DH, true>(q, k, v, kbias, out, stats, B, H, L, scale, s)
               : launch_self<DH, false>(q, k, v, kbias, out, stats, B, H, L, scale, s);
}

}  // namespace

// K6, bf16: q (B, H, Lq, Dh) pre-scaled, k, v (B, H, Lk, Dh), all bf16,
// 16-byte aligned, Dh a multiple of 8 up to 128 (or 16); kbias (B, Lk
// rounded up to 64) fp32, -1e30 in the padding; out (B, H, Lq, Dh) fp32
extern "C" int xattn_fwd_wgmma(const void* q, const void* k, const void* v, const void* kbias,
                               void* out, int B, int H, int Lq, int Lk, int Dh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kb = static_cast<const float*>(kbias);
  float* o = static_cast<float*>(out);
  if (Dh == 64) return launch<64, false>(q, k, v, kb, o, B, H, Lq, Lk, Dh, s);
  if (Dh == 32) return launch<32, false>(q, k, v, kb, o, B, H, Lq, Lk, Dh, s);
  if (Dh == 16) return launch<16, false>(q, k, v, kb, o, B, H, Lq, Lk, Dh, s);
  if (Dh == 128) return launch<128, false>(q, k, v, kb, o, B, H, Lq, Lk, Dh, s);
  if (Dh < 8 || Dh > 128 || Dh % 8) return cudaErrorInvalidValue;
  if (Dh < 16) return launch<16, true>(q, k, v, kb, o, B, H, Lq, Lk, Dh, s);
  if (Dh < 32) return launch<32, true>(q, k, v, kb, o, B, H, Lq, Lk, Dh, s);
  if (Dh < 64) return launch<64, true>(q, k, v, kb, o, B, H, Lq, Lk, Dh, s);
  return launch<128, true>(q, k, v, kb, o, B, H, Lq, Lk, Dh, s);
}

// K1's forward and K2, bf16: q (unscaled), k, v (B, H, L, Dh) bf16, 16-byte
// aligned, Dh 32, 64 or 128; kbias (B, L rounded up to 64) fp32, -1e30 in
// the padding; out (B, H, L, Dh) bf16; stats (B, H, L, 2) fp32, each row's
// (max, 1/sum), or null (K2)
extern "C" int attn_fwd_wgmma(const void* q, const void* k, const void* v, const void* kbias,
                              void* out, void* stats, int B, int H, int L, int Dh, float scale,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kb = static_cast<const float*>(kbias);
  auto* o = static_cast<__nv_bfloat16*>(out);
  float* st = static_cast<float*>(stats);
  if (Dh == 64) return launch_width<64>(q, k, v, kb, o, st, B, H, L, scale, s);
  if (Dh == 32) return launch_width<32>(q, k, v, kb, o, st, B, H, L, scale, s);
  if (Dh == 128) return launch_width<128>(q, k, v, kb, o, st, B, H, L, scale, s);
  return cudaErrorInvalidValue;
}
