"""The rate and latency of ``mma.sync`` m16n8k8 TF32 products on this card,
the instruction the port's fp32 kernels (csrc/cross_attention.cu,
csrc/attention.cu, csrc/crf.cu) run their split-TF32 products on.

    python -m weclip_tpu_torch.tools.mma_rate

Builds a small benchmark with the package's ``nvcc`` flags into a
temporary directory and prints, for each launch shape, the TFLOP/s of
back-to-back products on independent accumulators (many warps: the card's
rate; one warp an SM: what one warp's chains reach) and the time between
dependent products of one warp (the latency).  The published dense TF32
peak (494.7 TFLOP/s on the H100 SXM) is ``wgmma``'s; this measures what
``mma.sync`` reaches.  Needs a CUDA card and the toolkit.
"""

from __future__ import annotations

import subprocess
import tempfile
from pathlib import Path

from weclip_tpu_torch import kernels

SOURCE = r"""
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>

template <int NACC>
__global__ void bench(float* out, int iters) {
  float c[NACC][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  b[0] = __float_as_uint(0.5f);
  b[1] = __float_as_uint(0.25f);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < NACC; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int NACC>
int run(int blocks, int threads, int iters) {
  float* out;
  if (cudaMalloc(&out, (size_t)blocks * threads * 4) != cudaSuccess) return 1;
  bench<NACC><<<blocks, threads>>>(out, 16);   // warm
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  bench<NACC><<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double mmas = (double)blocks * threads / 32 * iters * NACC;
  printf("%d independent accumulators a warp, %d blocks of %d threads: %.4f ms, "
         "%.1f TFLOP/s, %.2f ns between dependent products\n",
         NACC, blocks, threads, ms, mmas * 2048 / ms / 1e9, ms * 1e6 / iters);
  cudaFree(out);
  return cudaGetLastError() != cudaSuccess;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  int bad = 0;
  bad |= run<8>(sms * 4, 128, 20000);    // 16 warps an SM
  bad |= run<16>(sms * 4, 128, 10000);
  bad |= run<1>(sms, 32, 20000);         // one warp an SM: latency
  bad |= run<4>(sms, 32, 20000);
  bad |= run<8>(sms, 32, 20000);
  return bad;
}
"""


def main() -> int:
    with tempfile.TemporaryDirectory(prefix="weclip_mma_rate_") as tmp:
        src, exe = Path(tmp) / "mma_rate.cu", Path(tmp) / "mma_rate"
        src.write_text(SOURCE)
        flags = [f for f in kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
        subprocess.run([kernels.nvcc_path(), *flags, "-o", str(exe), str(src)], check=True,
                       timeout=600)
        return subprocess.run([str(exe)], timeout=600).returncode


if __name__ == "__main__":
    raise SystemExit(main())
