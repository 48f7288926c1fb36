#!/usr/bin/env python3
"""On-card smoke test of weclip_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and ``nvcc``; imports
nothing of JAX or of ``weclip_tpu``.  Phases, each of which fails the run:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``weclip_tpu_torch/csrc`` (one nvcc each,
   all at once);
3. each kernel (K1-K6, K3-rect) against its plain PyTorch version on the
   card, on seeded inputs at the shapes of the paths below, each output
   against its own stated tolerance (K1 also each of its two launches, at
   L 1025, 1370 and 4096, and its map bit-equal across two calls; K3 also against
   a float64 evaluation; ``AttentionCoreFn`` and ``CrossAttentionCoreFn``
   against their kernels and fp32 autograd; K4 and K5 at the eval and
   training shapes, 21 channels and a 20 x 28 image, with their registers
   and spills from ``cuobjdump``), timed beside its plain
   version, a PyTorch library call where one computes the same function
   (SDPA at every K2, K3, K3-rect and K6 shape), and the least time the
   card could take (``bound_ms``); then every attention kernel at head
   widths 8, 20, 48, 80, 128, 160, 256 and 320 in bf16 and fp32, forward
   and backward, the
   fp32 K1 at L 2048 and 4096 (K1 less K2 at each width printed: the map
   kernel's cost), and K4/K5 at dilation sets past the shipped
   one ((1, 2, 4, 8, 12, 24, 32, 48), (5,), (1, 2, 64)) on a 20 x 28 image
   and the eval canvas, each checked, timed and bounded the same way
   (``check_widths``); then K2's forward by each of its two designs
   (mma.sync, wgmma) at the cells' shapes, smaller grids and other widths,
   device and host time (``check_forward_designs``); then the frozen
   block's three fused passes
   (``csrc/block_epilogue.cu``) at ``vitl14-eval``'s scale-1 shape against
   their plain twins (``check_block_epilogue``);
4. ``WeCLIPPipeline(device="cuda")`` at full ViT-B/16 width with seeded
   random weights: ``pseudo_label_batch`` and ``segment_batch`` (msc +
   flip) on 8 synthetic VOC-sized images; then one image at the fp32
   policy on the card and on the CPU (plain versions), pseudo-label
   agreement required to be at least 99%;
5. the same two calls with the CoMer branch (``configs/voc_comer.yaml``,
   its zero-init gates opened);
6. the CoMer training step at full width (crop 320, batch 4): warm steps,
   timed steps, finite losses, every parameter moved, every CoMer leaf a
   nonzero gradient; then one fp32 step at batch 1 on the card and on the
   CPU (pseudo labels, loss, gradients, update);
7. K5 also at (1, 81, 512, 512), a COCO pseudo label without class ids
   (81 channels in 14 chunks), timed beside its bound and its plain
   version (in phase 3); then that pseudo label itself
   (``configs/coco.yaml``, fp32) on the card and on the CPU, label
   agreement at least 99%;
8. the training loop (``train/trainer.py::train``, ``configs/voc.yaml``,
   crop 320, batch 4) for 6 steps over 16 random crops through the
   ``PrefetchLoader``, validating on 8 labelled VOC-size images and saving
   a checkpoint every 3 steps and at the end; then 3 steps and a resumed
   run to 6, whose parameters must equal the uninterrupted run's; a timed
   validation, checkpoint save and restore, and loader batch;
9. ``WeCLIPPipeline(model_path=<the step-6 checkpoint>)`` segments as a
   pipeline given the same parameters through ``weights``;
10. ``Evaluator.run`` msc-flip over 8 labelled VOC-size images
   (``Config()``): warm images/s, idle share, mIoU, histogram totals equal
   to the labelled pixels; on 2 of them fp32 card against CPU, msc
   predictions agreeing on at least 99% of the labelled pixels;
11. two ``seg_step`` steps (crop 320, batch 4): finite losses, every
   parameter moved; one fp32 step at batch 1 on the card and the CPU,
   losses within 1e-4; then the CoMer functional check
   (``weclip_tpu_torch/tools/comer_benchmark.py``, 1 seed, 30 steps an
   arm) on the card: finite scores, K6 and K3-rect launched at head width
   128, each of those calls within 2e-5 of its plain version on the same
   arguments, the CoMer arm's first 4 steps' losses within 1e-4
   (relative) of the CPU's, two runs of 30 steps equal;
12. a seeded random ViT-B/16 checkpoint in OpenAI's key layout (fp16) and a
   synthetic merges file: ``load_clip`` infers ``Config().clip``'s widths,
   ``build_frozen`` on the card and the CPU, fp32 text features within
   1e-4;
13. the eval CLI (``weclip_tpu_torch.cli.eval_voc.main``) on 8 labelled
   VOC-size images held only in the decoded cache, that checkpoint as
   ``clip.pretrained_path`` and phase 8's as ``--model_path``: finite
   scores, histogram totals equal to the labelled pixels and equal to a
   direct ``Evaluator.run``, K1-K5 launched, warm images/s;
14. ``WeCLIPPipeline.cam`` by each of the 8 CAM methods (K1, and K3 for
   the gradient methods), card against CPU in fp32 through ``cam_single``,
   and ``generate_cams`` over the 8 cached images;
15. the dense CRF: K7 (``csrc/crf.cu``, the windowed bilateral message on
   split-TF32 tensor-core products) against its plain twin at (8, 81, 160,
   160) and (8, 21, 128, 128), r 32, the message and the normalizer alone
   timed beside the tensor-core bound and the FMA bound of the kernel it
   replaced, with each launch's geometry and its registers (``cuobjdump``);
   ``mean_field_crf`` on the card against the CPU
   in fp32 (dense (21, 512, 512) at stride 4, windowed (81, 640, 640) at
   stride 16); ``Evaluator.run(crf=True)`` on VOC-size images with
   ``crf_impl`` native (2 of them) and jax (8), and on 8 COCO-size images
   with jax (K7's path), histogram totals equal to the labelled pixels, the
   jax runs' wall time printed beside K7's time; the ``eval_voc`` CLI with
   ``--crf --crf_impl jax``;
16. data parallel: two gloo ranks sharing the card, spawned by
   ``torch.multiprocessing``: 3 fp32 train steps at full width (crop 320, 2
   crops a rank) against one process at batch 4, and ``Evaluator.run``'s
   summed histograms against one process's; a one-rank NCCL all-reduce and
   mesh.  Then model parallel: two gloo ranks as a mesh of data 1 x model
   2, the frozen MLPs split between them, against one process at full
   width: 3 fp32 steps, the ranks' gradients equal, GradCAM,
   ``Evaluator.run``'s histograms, one bf16 step (``run_model_parallel``);
   and the TensorBoard image helpers on the host;
17. one ``{"kernels": [...]}`` line, then as the last line
   ``{"ok": true, "device": {...}}``.

Launch counters are reset just before each call of phases 4-15 and read
just after it; every kernel must have launched on that main path.  Every
time is printed with the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# published peaks of one H100 SXM (dense): bytes/s of HBM3, FLOP/s.  The
# fp32 attention kernels take each product as three TF32 tensor-core
# products (csrc/cross_attention.cu): their rate is a third of TF32's
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "tf32x3": 494.7e12 / 3}
VOC_SIZES = [(375, 500), (500, 375), (333, 500), (500, 500)]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def spin_cycles_per_ms() -> float:
    """SM cycles per ms at the card's top SM clock (``nvidia-smi``): a spin
    of n ms in these cycles lasts at least n ms at any clock the card runs."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e3


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up.

    The card first spins for longer than the host takes to queue the
    ``reps`` calls, and the CUDA events around them then time the calls back
    to back: a call whose kernels take less time than the host needs to
    launch them is timed by its device work, not by the host."""
    import torch
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin_ms = min(2.0 * reps * host_ms + 5.0, 2000.0)
    torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, flops: float, kind: str):
    """Least time for the work: bytes over HBM rate vs operations over the
    peak rate of their type; returns (ms, what bounds it)."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def token_mask(b: int, canvas: int, patch: int = 16):
    """(b, 1 + g*g) validity of the VOC sizes resized long-side to
    ``canvas`` on a (g, g) grid, the masks the main path feeds attention."""
    import torch
    g = canvas // patch
    m = torch.zeros((b, 1 + g * g), dtype=torch.float32)
    for i in range(b):
        oh, ow = VOC_SIZES[i % len(VOC_SIZES)]
        r = canvas / max(oh, ow)
        gh, gw = int(oh * r) // patch, int(ow * r) // patch
        grid = torch.zeros((g, g))
        grid[:gh, :gw] = 1.0
        m[i, 0] = 1.0
        m[i, 1:] = grid.reshape(-1)
    return m.cuda()


def qkv(b, h, l, dh, gen, dtype):
    import torch
    return [torch.randn((b, h, l, dh), generator=gen, device="cuda").to(dtype)
            for _ in range(3)]


def attention_bwd_f64(q, k, v, do, kmask):
    """K3's arithmetic in float64 with the bf16 roundings of the score type
    (operands, P and dS where they feed a product): the exact evaluation
    that the kernel and its plain version (the same arithmetic in fp32)
    both approximate.  Returns (dq, dk, dv)."""
    import torch
    bf = torch.bfloat16

    def r(t):
        return t.to(bf).double()

    qs, ks, vs, dos = r(q), r(k), r(v), r(do)
    s = qs @ ks.transpose(-1, -2) + ((kmask.double() - 1.0) * 1e30)[:, None, None, :]
    ex = torch.exp(s - s.amax(dim=-1, keepdim=True).clamp_min(-5e29))
    p = ex * (1.0 / ex.sum(dim=-1, keepdim=True).clamp_min(1e-30))
    del s, ex
    dp = dos @ vs.transpose(-1, -2)
    ds = r(p * (dp - (p * dp).sum(dim=-1, keepdim=True)))
    del dp
    return ds @ ks, ds.transpose(-1, -2) @ qs, r(p).transpose(-1, -2) @ dos


def k3_accumulation_probe(qs, k, v, do):
    """Elementwise error of K3's two score-sized products, S = q K^T and
    dP = dO V^T.  With one valid key j per image, P is one-hot, so the row
    statistics the kernel writes are that key's S (row max) and dP (delta,
    a sum whose other terms are exactly 0).  Returns, for S and dP, the
    error against float64 of the bf16 tensor-core kernel, the fp32 kernel
    (three TF32 tensor-core products) and cuBLAS fp32: max |err| / max |value|, mean |err| / mean |value|, and
    the mean of err * sign(value) / mean |value| (negative: toward zero)."""
    import torch
    from weclip_tpu_torch.ops import attention_kernels as ak
    bf = torch.bfloat16
    b, h, l, dh = qs.shape
    keys = (torch.arange(b, device="cuda") * 97 + 5) % l
    km = torch.zeros((b, l), device="cuda")
    km[torch.arange(b, device="cuda"), keys] = 1.0
    ops = [t.to(bf).float().contiguous() for t in (qs, k, v, do)]
    sel = keys[:, None, None, None].expand(b, h, 1, dh)
    ref = {}
    for dt in (torch.float64, torch.float32):
        q_, k_, v_, do_ = (t.to(dt) for t in ops)
        ref[dt] = ((q_ @ k_.transpose(-1, -2)).gather(
                       -1, keys[:, None, None, None].expand(b, h, l, 1))[..., 0],
                   (do_ @ torch.gather(v_, 2, sel).transpose(-1, -2))[..., 0])
    got = {"cublas": ref[torch.float32]}
    for route, dt in (("mma", bf), ("tf32x3", torch.float32)):
        st = torch.empty((b, h, l, 3), device="cuda")
        ak.attention_bwd(*ops, km, dt, stats=st)
        got[route] = (st[..., 0], st[..., 2])
    out = {}
    for i, name in enumerate(("S", "dP")):
        ex = ref[torch.float64][i]
        mag = float(ex.abs().mean())
        out[name] = {route: {
            "max_rel": float((g[i].double() - ex).abs().max() / ex.abs().max()),
            "mean_rel": float((g[i].double() - ex).abs().mean() / mag),
            "mean_toward_zero": float(((g[i].double() - ex) * ex.sign()).mean() / mag)}
            for route, g in got.items()}
    return out


def k3_worst_flip(got, exact, qs, k, v, do, kmask):
    """Locates the kernel's largest dq and dk distances from the float64
    evaluation and tests whether one dS element explains both: for that
    (row i, key j) it returns the exact dS, its distance from the bf16
    rounding midpoint (in ulps), and one bf16 step of it times k[j] and
    q[i] beside the two distances."""
    import torch
    bf = torch.bfloat16
    err_q = (got[0][:exact[0].shape[0]].double() - exact[0]).abs()
    err_k = (got[1][:exact[1].shape[0]].double() - exact[1]).abs()
    bq, hq, i, dq_d = np.unravel_index(int(err_q.argmax()), tuple(err_q.shape))
    bk, hk, j, dk_d = np.unravel_index(int(err_k.argmax()), tuple(err_k.shape))
    qb, kb, vb, dob = (t[bq, hq].to(bf).double() for t in (qs, k, v, do))
    s = qb[i] @ kb.T + (kmask[bq].double() - 1.0) * 1e30
    p = torch.exp(s - s.max())
    p = p / p.sum()
    dp = dob[i] @ vb.T
    x = float((p * (dp - (p * dp).sum()))[j])
    ulp = bf16_ulp(abs(x))
    return {"same_image_head": bool((bq, hq) == (bk, hk)), "row": int(i),
            "key": int(j), "ds_exact": x,
            "ulps_from_midpoint": abs(x) / ulp % 1.0 - 0.5,
            "dq_distance": float(err_q.max()),
            "one_step_times_k": abs(ulp * float(kb[j, dq_d])),
            "dk_distance": float(err_k.max()),
            "one_step_times_q": abs(ulp * float(qb[i, dk_d]))}


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 numbers at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def record_kernel(records, name, source, replaces, checks, ms, plain_ms, bound,
                  lib_ms, shapes, **extra):
    """Append a kernel's record.  ``checks``: (what, max_abs_err, tol),
    each output held to its own tolerance; fails after printing them all."""
    replaces, tpu_kernel = replaces.split(" ", 1)
    bad = []
    for what, err, tol in checks:
        ok = err <= tol
        if not ok:
            bad.append((what, err, tol))
        print(f"[kernel] {name}: {what}: max_abs_err {err:.3e} (tol {tol:.3e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    print(f"[kernel] {name}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound[0]:.4f} ms ({bound[1]}), library "
          f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}; {shapes}",
          flush=True)
    if bad:
        raise AssertionError(f"{name}: {bad}")
    records.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "tpu_kernel": tpu_kernel.strip("()"),
                    "max_abs_err": max(c[1] for c in checks),
                    "checks": [{"what": w, "max_abs_err": e, "tol": t}
                               for w, e, t in checks],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                    "bound_by": bound[1], "library_ms": lib_ms,
                    "shapes": shapes, **extra})


def output_check(what, out, ref):
    """bf16 outputs: one bf16 ulp of the largest |ref| (a single rounding
    of the output may go the other way); fp32 outputs: 2e-5."""
    import torch
    if out.dtype == torch.bfloat16:
        tol = bf16_ulp(float(ref.float().abs().max()))
    else:
        tol = 2e-5
    return (what, max_err(out, ref), tol)


# K3's distance from the float64 evaluation may be at most these multiples
# of the plain version's, (max, mean).  The max is one element's fate: a dS
# within ~1e-7 (relative) of a bf16 rounding midpoint rounds either way
# under either fp32 arithmetic (k3_worst_flip).  The mean is systematic: the
# tensor cores round their sums toward zero (k3_accumulation_probe).
K3_F64_RATIO = (8.0, 2.5)


# K2's path shapes: (B, H, L, Dh, canvas, class token).  bf16: the frozen
# blocks on the flipped half (8 rows) and segment-only scale 1 (16 rows) at
# L 1025, scale 2 at 626, and ViT-L/14's (patch 14) flipped half at 1370
# and scale 2 at 842; fp32: the eval decoder at 1024 and 625.
K2_SHAPES = [(8, 12, 1025, 64, 512, True), (16, 12, 1025, 64, 512, True),
             (16, 12, 626, 64, 384 + 16, True), (8, 16, 1370, 64, 518, True),
             (16, 16, 842, 64, 406, True), (16, 8, 1024, 32, 512, False),
             (16, 8, 625, 32, 384 + 16, False)]
# K1's: (B, H, L, Dh, canvas, patch), ViT-B/16's and ViT-L/14's maps of
# the first 8 rows at scale 1
K1_SHAPES = [(8, 12, 1025, 64, 512, 16), (8, 16, 1370, 64, 518, 14)]


def k2_patch(l: int, canvas: int, cls: bool) -> int:
    """The patch of a K2 shape: its grid is L (less the class token) on a
    side squared."""
    return canvas // math.isqrt(l - cls)


def forward_ms(q, k, v, km, stats, reps: int) -> float:
    """The bf16 self-attention forward alone (K1's first launch with
    ``stats``, K2 without), by the design ``forward_design`` gives."""
    import torch
    from weclip_tpu_torch import kernels
    from weclip_tpu_torch.ops import attention_kernels as ak
    b, h, l, dh = q.shape
    out = torch.empty_like(q)
    bias = ak._padded_key_bias(km)
    st = None if stats is None else stats.data_ptr()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(), st, b,
            h, l, dh, ctypes.c_float(dh ** -0.5), torch.cuda.current_stream().cuda_stream)
    if ak.forward_design(q.dtype, dh) == ak.WGMMA:
        return cuda_ms(lambda: kernels.call("hopper_attention", "attn_fwd_wgmma", *args), reps)
    return cuda_ms(lambda: kernels.call("flash_attention", "flash_fwd", *args), reps)


# K3's: the GradCAM pullback of pseudo_label_batch(8) (B*MC = 32 rows,
# bucket 4, canvas 512) and of the training step (4 crops of 320, bucket 4)
K3_SHAPES = [("gradcam", 32, 1025, 512), ("train", 16, 401, None)]


def k2_times(q, k, v, km, reps: int):
    """K2 and SDPA with the same boolean key mask on the same inputs: (ms,
    library ms)."""
    import torch.nn.functional as F
    from weclip_tpu_torch.ops import attention_kernels as ak
    mask = km.bool()[:, None, None, :]
    return (cuda_ms(lambda: ak.attention_core(q, k, v, km, False), reps),
            cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                    reps))


def sdpa_bwd_ms(qs, k, v, do, km, reps: int) -> float:
    """PyTorch's memory-efficient attention backward on the same pre-scaled
    inputs in bf16, its forward outside the timed region."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    bf = torch.bfloat16
    ql, kl, vl = (t.to(bf).detach().requires_grad_(True) for t in (qs, k, v))
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        out = F.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=km.bool()[:, None, None, :], scale=1.0)
    do_l = do.to(bf)
    return cuda_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), do_l,
                                               retain_graph=True), reps)


def k3_inputs(b, l, canvas, gen, h: int = 12, dh: int = 64):
    """bf16 q, k, v (q unscaled), fp32 dO and the key mask of a K3 shape."""
    import torch
    q, k, v = qkv(b, h, l, dh, gen, torch.bfloat16)
    km = token_mask(b, canvas) if canvas else torch.ones((b, l), device="cuda")
    do = torch.randn((b, h, l, dh), generator=gen, device="cuda")
    return q, k, v, do, km


def k1_checks(q, k, v, km, what: str):
    """K1 (bf16) on one input: its output to one bf16 ulp of the plain
    version's largest |out|; its map to 2e-5 of the plain map; its two
    launches each against its plain version (the row statistics to 1e-5
    relative: fp32 sums of up to L terms taken in another order; the map
    launch, fed the kernel's own statistics, to 2e-5); and a second call's
    map bit-equal to the first.  Returns (checks, record fields)."""
    import torch
    from weclip_tpu_torch.ops import attention_kernels as ak
    b, h, l, _ = q.shape
    stats = torch.empty((b, h, l, 2), device="cuda")
    out, amap = ak.attention_core(q, k, v, km, export_weights=True, stats=stats)
    ref_out, ref_map = ak.attention_core_plain(q, k, v, km, export_weights=True)
    torch.cuda.synchronize()
    checks = [output_check(f"out {what} bf16", out, ref_out),
              (f"head-mean map {what} fp32 (largest {float(ref_map.max()):.3e})",
               max_err(amap, ref_map), 2e-5)]
    del ref_out, ref_map
    ref_st = ak.attention_row_stats_plain(q, k, km)
    rel = float(((stats - ref_st).abs() / ref_st.abs()).max())
    checks.append((f"row statistics (max, 1/sum) {what}, relative", rel, 1e-5))
    del ref_st
    checks.append((f"map launch {what} from the kernel's statistics",
                   max_err(amap, ak.attention_map_plain(q, k, km, stats)), 2e-5))
    _, again = ak.attention_core(q, k, v, km, export_weights=True)
    same = bool(torch.equal(amap, again))
    print(f"[kernel] attention_fwd_export {what}: map bit-equal across two calls: "
          f"{same}", flush=True)
    if not same:
        raise AssertionError(f"attention_fwd_export {what}: the map differs between calls")
    return checks, {"map_bit_equal_across_calls": same}


# PAR's path shapes, timed: (what, B, C, H, W), the eval canvas of
# pseudo_label_batch(8) at bucket 4 and the training crop at batch 4 (also
# bucket 4: background plus 4 class channels); and shapes that are checked
# only: a bucket of 20, an image smaller than the largest dilation
PAR_SHAPES = [("eval", 8, 5, 512, 512), ("train", 4, 5, 320, 320),
              ("coco 81", 1, 81, 512, 512)]
PAR_CHECK_SHAPES = [("bucket 20", 2, 21, 128, 160), ("clamp", 1, 21, 20, 28)]


def kernel_resources(name: str) -> dict:
    """Registers, stack and local memory (spills) of each kernel in the
    built library ``name``, read by ``cuobjdump -res-usage``
    (``weclip_tpu_torch/tools/kernel_resources.py``)."""
    from weclip_tpu_torch import kernels
    from weclip_tpu_torch.tools.kernel_resources import resources
    out = resources(kernels._lib_path(name))
    for fn, res in out.items():
        print(f"[resources] {name} {fn}: {res}", flush=True)
    return out


def check_kernels(reps: int = 10):
    """Phase 3: every kernel against its plain version; returns the
    kernels' records (without launches)."""
    import torch

    from weclip_tpu_torch import kernels
    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.core.config import ParConfig
    from weclip_tpu_torch.ops import attention_kernels as ak
    from weclip_tpu_torch.refine import par as par_plain
    from weclip_tpu_torch.refine import par_kernels as pk

    precision.strict_matmul()
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    records = []

    record = functools.partial(record_kernel, records)

    def attn_fwd_bytes(b, h, l, dh, export):
        n = 4 * b * h * l * dh * 2 + b * l * 4       # q, k, v in, out; mask
        return n + (b * l * l * 4 if export else 0)

    src_flash = "weclip_tpu_torch/csrc/flash_attention.cu"
    src_hopper = "weclip_tpu_torch/csrc/hopper_attention.cu"

    # K1: the frozen blocks' map export, first 8 rows at scale 1 (ViT-B/16,
    # L 1025; ViT-L/14, L 1370): the output, the map, and each of its two
    # launches (the forward's row statistics, the map from those
    # statistics) against its plain version; each timed, with its forward
    # alone and its map kernel alone
    checks, k1_ms, k1_fwd_ms, k1_bound, k1_plain = [], {}, {}, {}, {}
    stream = torch.cuda.current_stream().cuda_stream
    for b, h, l, dh, canvas, patch in K1_SHAPES:
        q, k, v = qkv(b, h, l, dh, gen, bf)
        km = token_mask(b, canvas, patch)
        what = f"{[b, h, l, dh]}"
        more, k1 = k1_checks(q, k, v, km, what)
        checks += more
        bias = ak._padded_key_bias(km)
        stats = torch.empty((b, h, l, 2), device="cuda")
        amap = torch.empty((b, l, l), device="cuda")
        ak.attention_core(q, k, v, km, True, stats=stats)
        k1.setdefault("map_kernel_ms_by_shape", {})[what] = cuda_ms(lambda: kernels.call(
            "flash_attention", "attn_map", q.data_ptr(), k.data_ptr(), bias.data_ptr(),
            stats.data_ptr(), amap.data_ptr(), b, h, l, dh, ctypes.c_float(dh ** -0.5),
            stream), reps)
        k1_fwd_ms[what] = forward_ms(q, k, v, km, stats, reps)
        k1_ms[what] = cuda_ms(lambda: ak.attention_core(q, k, v, km, True), reps)
        k1_plain[what] = cuda_ms(lambda: ak.attention_core_plain(q, k, v, km, True), reps)
        k1_bound[what] = bound_ms(attn_fwd_bytes(b, h, l, dh, True), 4 * b * h * l * l * dh,
                                  "bf16")
        print(f"[kernel] attention_fwd_export {what}: {k1_ms[what]:.4f} ms (forward "
              f"{k1_fwd_ms[what]:.4f} ms, {ak.forward_design(bf, dh)}; map kernel "
              f"{k1['map_kernel_ms_by_shape'][what]:.4f} ms), bound {k1_bound[what][0]:.4f} ms",
              flush=True)
        del amap, stats, bias
    first = f"{list(K1_SHAPES[0][:4])}"
    # ... past the fp32 kernel's whole-row length limit, with an image whose
    # keys are partly masked, untimed
    q2, k2, v2 = qkv(2, 12, 4096, 64, gen, bf)
    km2 = torch.ones((2, 4096), device="cuda")
    km2[1, 1500:] = 0.0
    checks += k1_checks(q2, k2, v2, km2, "[2, 12, 4096, 64]")[0]
    del q2, k2, v2, km2
    record("attention_fwd_export", src_flash,
           "weclip_tpu/ops/pallas_attention.py:195 (attention_core_pallas, "
           "export_weights=True; pallas_call :260)",
           checks, k1_ms[first], k1_plain[first], k1_bound[first],
           None, [list(s[:4]) for s in K1_SHAPES] + [[2, 12, 4096, 64]], timed_shape=first,
           ms_by_shape=k1_ms, forward_ms_by_shape=k1_fwd_ms, plain_ms_by_shape=k1_plain,
           bound_ms_by_shape={w: bd[0] for w, bd in k1_bound.items()},
           forward_source=src_hopper,
           fp32_source="weclip_tpu_torch/csrc/attention.cu", **k1)

    # K2 at its path shapes, each timed beside SDPA with the same
    # boolean key mask; then once past K1's whole-row limit, untimed
    checks, ms_by_shape, sdpa_by_shape, first = [], {}, {}, None
    plain_by_shape, bound_by_shape = {}, {}
    for (b, h, l, dh, canvas, cls) in K2_SHAPES:
        dtype = bf if dh == 64 else torch.float32
        q, k, v = qkv(b, h, l, dh, gen, dtype)
        km = token_mask(b, canvas, k2_patch(l, canvas, cls))
        if not cls:
            km = km[:, 1:]
        out, _ = ak.attention_core(q, k, v, km, export_weights=False)
        ref, _ = ak.attention_core_plain(q, k, v, km, export_weights=False)
        torch.cuda.synchronize()
        what = f"{[b, h, l, dh]} {str(dtype)[6:]}"
        checks.append(output_check(f"out {what}", out, ref))
        ms_by_shape[what], sdpa_by_shape[what] = k2_times(q, k, v, km, reps)
        plain_by_shape[what] = cuda_ms(
            lambda: ak.attention_core_plain(q, k, v, km, False), reps)
        sz = 2 if dtype == bf else 4
        bound_by_shape[what] = bound_ms(4 * b * h * l * dh * sz + b * l * 4,
                                        4 * b * h * l * l * dh,
                                        "bf16" if dtype == bf else "tf32x3")[0]
        print(f"[kernel] attention_fwd {what}: {ms_by_shape[what]:.4f} ms "
              f"({ak.forward_design(dtype, dh)}), SDPA {sdpa_by_shape[what]:.4f} ms, "
              f"bound {bound_by_shape[what]:.4f} ms", flush=True)
        if first is None:
            first = (q, k, v, km)
        del out, ref
    q, k, v = qkv(2, 12, 4096, 64, gen, bf)
    km = torch.ones((2, 4096), device="cuda")
    km[1, 1500:] = 0.0
    out, _ = ak.attention_core(q, k, v, km, export_weights=False)
    ref, _ = ak.attention_core_plain(q, k, v, km, export_weights=False)
    torch.cuda.synchronize()
    checks.append(output_check("out [2, 12, 4096, 64] bf16 (past K1's length limit)",
                               out, ref))
    del out, ref, q, k, v
    q, k, v, km = first
    b, h, l, dh = q.shape
    what = f"{[b, h, l, dh]} {str(q.dtype)[6:]}"
    record("attention_fwd", src_flash,
           "weclip_tpu/ops/pallas_attention.py:195 (attention_core_pallas, "
           "export_weights=False; pallas_call :260)",
           checks, ms_by_shape[what],
           cuda_ms(lambda: ak.attention_core_plain(q, k, v, km, False), reps),
           bound_ms(attn_fwd_bytes(b, h, l, dh, False), 4 * b * h * l * l * dh,
                    "bf16"),
           sdpa_by_shape[what], [list(s[:4]) for s in K2_SHAPES] + [[2, 12, 4096, 64]],
           timed_shape=what, ms_by_shape=ms_by_shape, library_ms_by_shape=sdpa_by_shape,
           plain_ms_by_shape=plain_by_shape, bound_ms_by_shape=bound_by_shape,
           forward_source=src_hopper, fp32_source="weclip_tpu_torch/csrc/cross_attention.cu")
    del first, q, k, v

    # K3: the GradCAM pullback, B*MC = 32 rows at L=1025 (bucket 4)
    _, b, l, canvas = K3_SHAPES[0]
    q, k, v, do, km = k3_inputs(b, l, canvas, gen)
    h, dh = q.shape[1], q.shape[3]
    scale = dh ** -0.5
    qs = q.float() * scale
    got = ak.attention_bwd(qs, k, v, do, km, bf)
    ref = ak.attention_bwd_plain(qs, k, v, do, km, bf)
    torch.cuda.synchronize()
    # Each gradient against its own largest magnitude.  Both versions round
    # P and dS to bf16 where they feed a product; where their fp32 sums
    # before that rounding differ in the last bits, a value rounds the other
    # way and moves a gradient element by one bf16 ulp of that term.  The
    # maximum is held to one bf16 ulp (2^-8) of the gradient's largest
    # magnitude, the mean (where a misplaced term shows) to 1e-5 of it.
    checks, k3 = [], {"mean_abs_err": {}, "float64_distance": {}}
    failed = []
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        sc = float(r.abs().max())
        checks.append((f"{name} (largest |{name}| {sc:.3e})", max_err(a, r),
                       2.0 ** -8 * sc))
        mean = float((a - r).abs().mean())
        k3["mean_abs_err"][name] = mean
        print(f"[kernel] attention_bwd: {name} mean abs error {mean:.3e} "
              f"(tol {1e-5 * sc:.3e})", flush=True)
        if mean > 1e-5 * sc:
            failed.append(f"{name} mean error {mean}")
    # where the kernel's error comes from, on the first 8 rows: the
    # elementwise error of its S and dP products, each gradient's distance
    # from the float64 evaluation beside the plain version's, and the one
    # dS element behind the largest distances
    n8 = 8
    exact = attention_bwd_f64(qs[:n8], k[:n8], v[:n8], do[:n8], km[:n8])
    probe = k3_accumulation_probe(qs[:n8], k[:n8], v[:n8], do[:n8])
    k3["accumulation_probe"] = probe
    for name, routes in probe.items():
        for route, m in routes.items():
            print(f"[kernel] attention_bwd: {name} elementwise vs float64, {route}: "
                  f"max {m['max_rel']:.3e}, mean {m['mean_rel']:.3e}, signed "
                  f"{m['mean_toward_zero']:+.3e} (relative)", flush=True)
    for name, a, r, e in zip(("dq", "dk", "dv"), got, ref, exact):
        dist = {side: (float((t[:n8].double() - e).abs().max()),
                       float((t[:n8].double() - e).abs().mean()))
                for side, t in (("kernel", a), ("plain", r))}
        k3["float64_distance"][name] = dist
        ratio = [dist["kernel"][i] / dist["plain"][i] for i in (0, 1)]
        print(f"[kernel] attention_bwd: {name} distance from float64: kernel "
              f"max {dist['kernel'][0]:.3e} mean {dist['kernel'][1]:.3e}, plain "
              f"max {dist['plain'][0]:.3e} mean {dist['plain'][1]:.3e}; kernel / "
              f"plain: max {ratio[0]:.2f} (at most {K3_F64_RATIO[0]}), mean "
              f"{ratio[1]:.2f} (at most {K3_F64_RATIO[1]})", flush=True)
        for what, got_r, most in zip(("max", "mean"), ratio, K3_F64_RATIO):
            if got_r > most:
                failed.append(f"{name} float64 {what} distance {got_r:.2f} x plain's")
    flip = k3_worst_flip(got, exact, qs[:n8], k[:n8], v[:n8], do[:n8], km[:n8])
    k3["worst_flip"] = flip
    print(f"[kernel] attention_bwd: largest dq and dk distances "
          f"{'share' if flip['same_image_head'] else 'do not share'} one "
          f"(image, head); row {flip['row']}, key {flip['key']}: exact dS "
          f"{flip['ds_exact']:.6e}, {flip['ulps_from_midpoint']:+.3e} ulp from "
          f"the bf16 rounding midpoint; one bf16 step x |k| "
          f"{flip['one_step_times_k']:.3e} (dq distance {flip['dq_distance']:.3e}), "
          f"x |q| {flip['one_step_times_q']:.3e} (dk distance "
          f"{flip['dk_distance']:.3e})", flush=True)
    del exact
    # the autograd.Function (K1 forward, K3 backward): under bf16 it must
    # give exactly K1's output and K3's gradients (dq times the scale);
    # under fp32 (split-TF32 kernels) it is held to autograd of the plain forward
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    out, _ = ak.AttentionCoreFn.apply(qg, kg, vg, km)
    g_fn = torch.autograd.grad(out, (qg, kg, vg), do.to(bf))
    want = ak.attention_bwd(qs, k, v, do.to(bf).float(), km, bf)
    want = ((want[0] * scale).to(bf), want[1].to(bf), want[2].to(bf))
    same = (torch.equal(out, ak.attention_core(q, k, v, km, True)[0])
            and all(torch.equal(a, w) for a, w in zip(g_fn, want)))
    print(f"[kernel] AttentionCoreFn bf16: output and gradients equal to K1's "
          f"and K3's: {same}", flush=True)
    if not same:
        failed.append("AttentionCoreFn differs from K1/K3")
    del g_fn, want, out
    q32, k32, v32 = (t[:n8].float().requires_grad_(True) for t in (q, k, v))
    out, _ = ak.AttentionCoreFn.apply(q32, k32, v32, km[:n8])
    g_fn = torch.autograd.grad(out, (q32, k32, v32), do[:n8])
    out_p, _ = ak.attention_core_plain(q32, k32, v32, km[:n8], True)
    g_pl = torch.autograd.grad(out_p, (q32, k32, v32), do[:n8])
    rel = max(max_err(a, r) / float(r.abs().max()) for a, r in zip(g_fn, g_pl))
    print(f"[kernel] AttentionCoreFn fp32 vs autograd of the plain forward: "
          f"max error / max |grad| = {rel:.3e} (tol 1e-4)", flush=True)
    if rel > 1e-4:
        failed.append(f"AttentionCoreFn fp32 gradient off by {rel}")
    del g_fn, g_pl, out, out_p, q32, k32, v32
    # the training step's pullback: checked like the GradCAM one
    k3["ms_by_shape"], k3["library_ms_by_shape"] = {}, {}
    for i, (what, b_, l_, canvas) in enumerate(K3_SHAPES):
        if i:
            q, k, v, do, km = k3_inputs(b_, l_, canvas, gen)
            qs = q.float() * scale
            got = ak.attention_bwd(qs, k, v, do, km, bf)
            ref = ak.attention_bwd_plain(qs, k, v, do, km, bf)
            torch.cuda.synchronize()
            for name, a, r in zip(("dq", "dk", "dv"), got, ref):
                sc = float(r.abs().max())
                checks.append((f"{what} {name} (largest |{name}| {sc:.3e})",
                               max_err(a, r), 2.0 ** -8 * sc))
                mean = float((a - r).abs().mean())
                k3["mean_abs_err"][f"{what} {name}"] = mean
                if mean > 1e-5 * sc:
                    failed.append(f"{what} {name} mean error {mean}")
            del got, ref
        # as AttentionCoreFn calls it: bf16 q unscaled with its scale, bf16 dO
        do_b = do.to(bf)
        k3["ms_by_shape"][what] = cuda_ms(
            lambda: ak.attention_bwd(q, k, v, do_b, km, bf, q_scale=scale), reps)
        k3["library_ms_by_shape"][what] = sdpa_bwd_ms(qs, k, v, do, km, reps)
        print(f"[kernel] attention_bwd {what} {[b_, h, l_, dh]}: "
              f"{k3['ms_by_shape'][what]:.4f} ms, SDPA memory-efficient backward "
              f"{k3['library_ms_by_shape'][what]:.4f} ms", flush=True)
        if i == 0:
            plain_ms = cuda_ms(lambda: ak.attention_bwd_plain(qs, k, v, do, km, bf), reps)
    # as AttentionCoreFn hands them over: q, k, v, dO bf16 in; dq, dk, dv
    # fp32 out; the key mask
    what, b, l, _ = K3_SHAPES[0]
    bwd_bytes = b * h * l * dh * (4 * 2 + 3 * 4) + b * l * 4
    record("attention_bwd", src_flash,
           "weclip_tpu/ops/pallas_attention.py:395 (attention_bwd_pallas; "
           "pallas_call :441)",
           checks, k3["ms_by_shape"][what], plain_ms,
           bound_ms(bwd_bytes, 10 * b * h * l * l * dh, "bf16"),
           k3["library_ms_by_shape"][what],
           [[s_[1], h, s_[2], dh] for s_ in K3_SHAPES], timed_shape=what, **k3)
    if failed:
        raise AssertionError(f"attention_bwd: {failed}")
    del q, k, v, do, do_b, qs
    torch.cuda.empty_cache()

    # K4 / K5: PAR at every shape of the paths, timed (PAR_SHAPES: eval,
    # training, and a COCO pseudo label without class ids, 81 channels in
    # 14 chunks), and at a bucket of 20 (21 channels, four channel chunks)
    # and an image smaller than the largest dilation, checked only
    cfg = ParConfig()
    n = 8 * len(cfg.dilations)
    src_par = "weclip_tpu_torch/csrc/par.cu"
    aff_checks, prop_checks, aff_ms, prop_ms = [], [], {}, {}
    timed = {s_[0] for s_ in PAR_SHAPES}
    for what, b, c, hh, ww in PAR_SHAPES + PAR_CHECK_SHAPES:
        imgs = torch.randn((b, 3, hh, ww), generator=gen, device="cuda")
        masks = torch.rand((b, c, hh, ww), generator=gen, device="cuda")
        aff = pk.par_affinity(imgs, cfg)
        aff_checks.append((f"{what} aff {[b, n, hh, ww]} fp32", max_err(
            aff, par_plain.par_affinity(imgs, cfg)), 2e-5))
        kept = masks.clone()
        got = pk.par_propagate(masks, aff, cfg)
        prop_checks.append((f"{what} masks {[b, c, hh, ww]} fp32 after {cfg.num_iter} "
                            f"iterations", max_err(got, par_plain.par_propagate(
                                masks, aff, cfg)), 2e-5))
        if not torch.equal(masks, kept):
            raise AssertionError("par_propagate wrote the caller's masks")
        if what in timed:
            aff_ms[what] = cuda_ms(lambda: pk.par_affinity(imgs, cfg), reps)
            prop_ms[what] = cuda_ms(lambda: pk.par_propagate(masks, aff, cfg),
                                    max(2, reps // 5))
            print(f"[kernel] par {[b, c, hh, ww]}: par_affinity {aff_ms[what]:.4f} ms, "
                  f"par_propagate {prop_ms[what]:.4f} ms ({cfg.num_iter} iterations)",
                  flush=True)
        if what == PAR_SHAPES[0][0]:
            plain_aff = cuda_ms(lambda: par_plain.par_affinity(imgs, cfg), reps)
            plain_prop = cuda_ms(lambda: par_plain.par_propagate(masks, aff, cfg), 2)
            eval_bytes = (b * 3 * hh * ww * 4, b * n * hh * ww * 4, b * c * hh * ww * 4)
            eval_flops = (31 * n * b * hh * ww, cfg.num_iter * 2 * n * b * c * hh * ww)
        if what == "coco 81":
            # each input read once: affinities, masks in, masks out
            cb = bound_ms(b * n * hh * ww * 4 + 2 * b * c * hh * ww * 4,
                          cfg.num_iter * 2 * n * b * c * hh * ww, "fp32")
            coco = {"shape": [b, c, hh, ww], "num_iter": cfg.num_iter,
                    "ms": prop_ms[what], "bound_ms": cb[0], "bound_by": cb[1],
                    "plain_ms": cuda_ms(lambda: par_plain.par_propagate(masks, aff, cfg), 2),
                    "max_abs_err": prop_checks[-1][1],
                    "chunks": -(-c // 6)}
        del imgs, masks, aff, got, kept
    res = kernel_resources("par")
    what = PAR_SHAPES[0][0]
    img_b, aff_b, mask_b = eval_bytes
    # per channel of one image against the 5-channel eval shape's
    eb, ec = PAR_SHAPES[0][1:3]
    coco["ms_per_channel_vs_eval"] = (coco["ms"] / coco["shape"][1]) / (prop_ms[what] / (eb * ec))
    print(f"[kernel] par_propagate {coco['shape']} ({coco['chunks']} chunks), "
          f"{cfg.num_iter} iterations: {coco['ms']:.4f} ms, plain {coco['plain_ms']:.4f} ms, "
          f"bound {coco['bound_ms']:.4f} ms ({coco['bound_by']}); per channel "
          f"{coco['ms_per_channel_vs_eval']:.3f}x the eval shape's", flush=True)
    record("par_affinity", src_par,
           "weclip_tpu/refine/pallas_par.py:210 (par_affinity_pallas; "
           "pallas_call :265)",
           aff_checks, aff_ms[what], plain_aff,
           bound_ms(img_b + aff_b, eval_flops[0], "fp32"), None,
           [[s_[1], 3, s_[3], s_[4]] for s_ in PAR_SHAPES + PAR_CHECK_SHAPES],
           timed_shape=what, ms_by_shape=aff_ms,
           resources={k: v for k, v in res.items() if "affinity" in k})
    # each input read once
    record("par_propagate", src_par,
           "weclip_tpu/refine/pallas_par.py:304 (par_refine_pallas; "
           "pallas_call :384)",
           prop_checks, prop_ms[what], plain_prop,
           bound_ms(aff_b + 2 * mask_b, eval_flops[1], "fp32"), None,
           [[s_[1], s_[2], s_[3], s_[4]] for s_ in PAR_SHAPES + PAR_CHECK_SHAPES],
           timed_shape=what, ms_by_shape=prop_ms, coco_81=coco,
           resources={k: v for k, v in res.items() if "propagate" in k})
    torch.cuda.empty_cache()
    return records


# head widths past the compiled instances' own (16, 32, 64, 128): each runs
# the next instance up with zero lanes, or above 128 slices of 128 columns
# (320: two whole slices and a half one); 128 is CTI's at the tiny config
WIDTHS = [8, 20, 48, 80, 128, 160, 256, 320]
# (B, H, L) of the width checks: a ViT-block-like square shape (K1, K2, K3)
# and CTI's training injection, (B, H, Lq) x Lk (K6, K3-rect)
WIDTH_SQUARE = (4, 8, 1025)
WIDTH_RECT = (4, 2, 2100, 400)
# the fp32 K1 past the length its whole-row design took
K1_F32_LENGTHS = [(2, 12, 2048, 64), (1, 12, 4096, 64)]
# PAR's dilation sets past the packed form (more than 6, or above 24), on
# a 20 x 28 image (checked) and at the eval canvas (timed)
PAR_DILATION_SETS = [(1, 2, 4, 8, 12, 24, 32, 48), (5,), (1, 2, 64)]


def add_checks(records, name, checks, **fields):
    """Hold ``checks`` ((what, max_abs_err, tol)) of an already recorded
    kernel, each to its own tolerance, and fold them and ``fields`` into
    its record; fails after printing them all."""
    rec = next(r for r in records if r["name"] == name)
    bad = []
    for what, err, tol in checks:
        ok = err <= tol
        if not ok:
            bad.append((what, err, tol))
        print(f"[kernel] {name}: {what}: max_abs_err {err:.3e} (tol {tol:.3e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    if bad:
        raise AssertionError(f"{name}: {bad}")
    rec["checks"] += [{"what": w, "max_abs_err": e, "tol": t} for w, e, t in checks]
    rec["max_abs_err"] = max(c["max_abs_err"] for c in rec["checks"])
    for key, value in fields.items():
        rec.setdefault(key, {}).update(value)


def sdpa_ms(q, k, v, km, reps: int, scale=None) -> float:
    """PyTorch's SDPA (its own choice of backend) with the same boolean key
    mask on the same inputs."""
    import torch.nn.functional as F
    mask = km.bool()[:, None, None, :]
    return cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                          scale=scale), reps)


def sdpa_any_bwd_ms(qs, k, v, do, km, reps: int) -> float:
    """SDPA's backward (its own choice of backend) on the same pre-scaled
    inputs in their own dtype, its forward outside the timed region."""
    import torch
    import torch.nn.functional as F
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (qs, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=km.bool()[:, None, None, :],
                                         scale=1.0)
    do_l = do.to(out.dtype)
    return cuda_ms(lambda: torch.autograd.grad(out, (ql, kl, vl), do_l,
                                               retain_graph=True), reps)


def k4_checks(what, aff, imgs, cfg):
    """K4's output against the plain version's at 2e-5 where the plain
    version is within 1e-5 of a float64 evaluation; and always the kernel's
    distance from that evaluation at most the larger of 2e-5 and the plain
    version's own.  With 8 neighbours a pixel's one-pass variance can
    cancel, and the two fp32 versions round it differently (the kernel's
    sum of squares is fused, the plain one's is not): there the plain
    version is no closer to the true value than the kernel."""
    from weclip_tpu_torch.refine import par as par_plain
    plain = par_plain.par_affinity(imgs, cfg)
    exact = par_plain.par_affinity(imgs.double(), cfg)
    dist = {"kernel": float((aff.double() - exact).abs().max()),
            "plain": float((plain.double() - exact).abs().max())}
    print(f"[kernel] par_affinity {what}: distance from float64: kernel "
          f"{dist['kernel']:.3e}, plain {dist['plain']:.3e}", flush=True)
    out = [(f"{what}: distance from float64", dist["kernel"], max(2e-5, dist["plain"]))]
    if dist["plain"] <= 1e-5:
        out.append((what, max_err(aff, plain), 2e-5))
    return out


def check_widths(records, reps: int = 5):
    """Phase 3, head widths, lengths and dilation sets past the main
    path's: every attention kernel at Dh 8, 20, 48, 80, 128, 160, 256 and
    320 in bf16 and fp32, forward and backward, each output to its own tolerance; the fp32
    K1 at L 2048 and 4096; K4 and K5 at PAR_DILATION_SETS, and K5's far
    form at the shipped set beside its packed form.  Each shape
    timed beside its plain version, SDPA where it computes the same
    function, and its bound; folded into the kernels' records.  Returns the
    attention libraries' registers and spills (``cuobjdump``)."""
    import torch

    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.core.config import ParConfig
    from weclip_tpu_torch.ops import attention_kernels as ak
    from weclip_tpu_torch.refine import par as par_plain
    from weclip_tpu_torch.refine import par_kernels as pk

    precision.strict_matmul()
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16
    times = {n: {} for n in ("attention_fwd_export", "attention_fwd", "attention_bwd",
                             "attention_bwd_rect", "cross_attention", "par_affinity",
                             "par_propagate")}
    checks = {n: [] for n in times}

    def timing(name, key, ms, plain, bound, lib):
        times[name][key] = {"ms": ms, "plain_ms": plain, "bound_ms": bound[0],
                            "bound_by": bound[1], "library_ms": lib}
        print(f"[kernel] {name} {key}: {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bound[0]:.4f} ms ({bound[1]}), library "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}", flush=True)

    def grad_checks(name, what, got, ref, dtype):
        rel = 2.0 ** -8 if dtype == bf else 2e-5
        out = []
        for g_name, a, r in zip(("dq", "dk", "dv"), got, ref):
            sc = float(r.abs().max())
            out.append((f"{what} {g_name} (largest {sc:.3e})", max_err(a, r), rel * sc))
            if dtype == bf:   # the mean, where a misplaced term shows
                out.append((f"{what} {g_name} mean", float((a - r).abs().mean()), 1e-5 * sc))
        return out

    b, h, l = WIDTH_SQUARE
    km = token_mask(b, 512)
    rb, rh, lq, lk = WIDTH_RECT
    km_rect = torch.ones((rb, lk), device="cuda")
    km_rect[1, lk // 2:] = 0.0
    for dh in WIDTHS:
        for dtype in (bf, torch.float32):
            sz, kind, tag = (2, "bf16", "bf16") if dtype == bf else (4, "tf32x3", "fp32")
            key = f"Dh {dh} {tag}"
            q, k, v = qkv(b, h, l, dh, gen, dtype)
            # K1 and K2: output (and map) against the plain version
            for export, name in ((True, "attention_fwd_export"), (False, "attention_fwd")):
                out, amap = ak.attention_core(q, k, v, km, export)
                ref, ref_map = ak.attention_core_plain(q, k, v, km, export)
                torch.cuda.synchronize()
                checks[name].append(output_check(f"out {[b, h, l, dh]} {tag}", out, ref))
                if export:
                    checks[name].append((f"map {[b, h, l, dh]} {tag}", max_err(amap, ref_map),
                                         2e-5))
                del out, amap, ref, ref_map
                n_bytes = 4 * b * h * l * dh * sz + b * l * 4 + (b * l * l * 4 if export else 0)
                timing(name, key, cuda_ms(lambda: ak.attention_core(q, k, v, km, export), reps),
                       cuda_ms(lambda: ak.attention_core_plain(q, k, v, km, export), reps),
                       bound_ms(n_bytes, 4 * b * h * l * l * dh, kind),
                       None if export else sdpa_ms(q, k, v, km, reps))
            # K3: the backward at the same shape
            do = torch.randn((b, h, l, dh), generator=gen, device="cuda")
            qs = q.float() * dh ** -0.5
            got = ak.attention_bwd(qs, k, v, do, km, dtype)
            ref = ak.attention_bwd_plain(qs, k, v, do, km, dtype)
            torch.cuda.synchronize()
            checks["attention_bwd"] += grad_checks("attention_bwd", f"{[b, h, l, dh]} {tag}",
                                                   got, ref, dtype)
            del got, ref
            n_bytes = b * h * l * dh * (4 * sz + 3 * 4) + b * l * 4
            qd = qs.to(dtype)
            timing("attention_bwd", key,
                   cuda_ms(lambda: ak.attention_bwd(qd, k, v, do, km, dtype), reps),
                   cuda_ms(lambda: ak.attention_bwd_plain(qs, k, v, do, km, dtype), reps),
                   bound_ms(n_bytes, 10 * b * h * l * l * dh, kind),
                   sdpa_any_bwd_ms(qd, k, v, do, km, reps))
            del q, k, v, do, qs, qd
            # K6 and K3-rect at CTI's training injection
            q = (torch.randn((rb, rh, lq, dh), generator=gen, device="cuda")
                 * dh ** -0.5).to(dtype)
            k, v = (torch.randn((rb, rh, lk, dh), generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            out = ak.cross_attention_core(q, k, v, km_rect)
            ref = ak.cross_attention_core_plain(q, k, v, km_rect)
            torch.cuda.synchronize()
            tol = bf16_ulp(float(ref.abs().max())) if dtype == bf else 2e-5
            checks["cross_attention"].append(
                (f"out {[rb, rh, lq, dh]} x {lk} {tag}", max_err(out, ref), tol))
            del out, ref
            n_bytes = rb * rh * (lq * dh * sz + 2 * lk * dh * sz + lq * dh * 4) + rb * lk * 4
            timing("cross_attention", key,
                   cuda_ms(lambda: ak.cross_attention_core(q, k, v, km_rect), reps),
                   cuda_ms(lambda: ak.cross_attention_core_plain(q, k, v, km_rect), reps),
                   bound_ms(n_bytes, 4 * rb * rh * lq * lk * dh, kind),
                   sdpa_ms(q, k, v, km_rect, reps, scale=1.0))
            do = torch.randn((rb, rh, lq, dh), generator=gen, device="cuda")
            got = ak.attention_bwd(q.float(), k, v, do, km_rect, dtype)
            ref = ak.attention_bwd_plain(q.float(), k, v, do, km_rect, dtype)
            torch.cuda.synchronize()
            checks["attention_bwd_rect"] += grad_checks(
                "attention_bwd_rect", f"{[rb, rh, lq, dh]} x {lk} {tag}", got, ref, dtype)
            del got, ref
            n_bytes = rb * rh * (lq * dh * (sz + 4 + 4) + 2 * lk * dh * (sz + 4)) + rb * lk * 4
            timing("attention_bwd_rect", key,
                   cuda_ms(lambda: ak.attention_bwd(q, k, v, do, km_rect, dtype), reps),
                   cuda_ms(lambda: ak.attention_bwd_plain(q, k, v, do, km_rect, dtype), reps),
                   bound_ms(n_bytes, 10 * rb * rh * lq * lk * dh, kind),
                   sdpa_any_bwd_ms(q, k, v, do, km_rect, reps))
            del q, k, v, do
            torch.cuda.empty_cache()

    # the fp32 K1 at lengths its whole-row design refused (one image with
    # masked keys)
    for b_, h_, l_, dh in K1_F32_LENGTHS:
        q, k, v = qkv(b_, h_, l_, dh, gen, torch.float32)
        km_l = torch.ones((b_, l_), device="cuda")
        km_l[-1, l_ // 3:] = 0.0
        out, amap = ak.attention_core(q, k, v, km_l, True)
        ref, ref_map = ak.attention_core_plain(q, k, v, km_l, True)
        torch.cuda.synchronize()
        checks["attention_fwd_export"] += [
            (f"out {[b_, h_, l_, dh]} fp32", max_err(out, ref), 2e-5),
            (f"map {[b_, h_, l_, dh]} fp32", max_err(amap, ref_map), 2e-5)]
        del out, amap, ref, ref_map
        n_bytes = 4 * b_ * h_ * l_ * dh * 4 + b_ * l_ * 4 + b_ * l_ * l_ * 4
        timing("attention_fwd_export", f"L {l_} fp32",
               cuda_ms(lambda: ak.attention_core(q, k, v, km_l, True), 2),
               cuda_ms(lambda: ak.attention_core_plain(q, k, v, km_l, True), 2),
               bound_ms(n_bytes, 4 * b_ * h_ * l_ * l_ * dh, "tf32x3"), None)
        del q, k, v
        torch.cuda.empty_cache()

    # K4 and K5 at dilation sets past the packed form: checked on a 20 x 28
    # image (dilations past the image) and at the eval canvas, timed there
    for dil in PAR_DILATION_SETS:
        cfg = ParConfig(dilations=dil)
        n = 8 * len(dil)
        for what, b_, c, hh, ww in (("20 x 28", 1, 5, 20, 28), ("eval", 8, 5, 512, 512)):
            imgs = torch.randn((b_, 3, hh, ww), generator=gen, device="cuda")
            masks = torch.rand((b_, c, hh, ww), generator=gen, device="cuda")
            aff = pk.par_affinity(imgs, cfg)
            checks["par_affinity"] += k4_checks(f"{dil} {what} aff {[b_, n, hh, ww]}", aff,
                                                imgs, cfg)
            got = pk.par_propagate(masks, aff, cfg)
            checks["par_propagate"].append(
                (f"{dil} {what} masks {[b_, c, hh, ww]}, {cfg.num_iter} iterations",
                 max_err(got, par_plain.par_propagate(masks, aff, cfg)), 2e-5))
            if what == "eval":
                key = f"{dil} {[b_, c, hh, ww]}"
                timing("par_affinity", key, cuda_ms(lambda: pk.par_affinity(imgs, cfg), reps),
                       cuda_ms(lambda: par_plain.par_affinity(imgs, cfg), 2),
                       bound_ms(b_ * 3 * hh * ww * 4 + b_ * n * hh * ww * 4,
                                31 * n * b_ * hh * ww, "fp32"), None)
                timing("par_propagate", key,
                       cuda_ms(lambda: pk.par_propagate(masks, aff, cfg), 2),
                       cuda_ms(lambda: par_plain.par_propagate(masks, aff, cfg), 2),
                       bound_ms(b_ * n * hh * ww * 4 + 2 * b_ * c * hh * ww * 4,
                                cfg.num_iter * 2 * n * b_ * c * hh * ww, "fp32"), None)
            del imgs, masks, aff, got
        torch.cuda.empty_cache()

    # K5's far form at the shipped set, beside the packed form that set
    # runs, at the eval canvas and the training crop: each form timed twice,
    # in the order packed, far, far, packed
    cfg = ParConfig()
    n = 8 * len(cfg.dilations)
    for what, b_, c, hh, ww in (("eval", 8, 5, 512, 512), ("train", 4, 5, 320, 320)):
        imgs = torch.randn((b_, 3, hh, ww), generator=gen, device="cuda")
        masks = torch.rand((b_, c, hh, ww), generator=gen, device="cuda")
        aff = pk.par_affinity(imgs, cfg)
        checks["par_propagate"].append(
            (f"far form {cfg.dilations} {what} masks {[b_, c, hh, ww]}, "
             f"{cfg.num_iter} iterations", max_err(pk.par_propagate(masks, aff, cfg, far=True),
                                                   par_plain.par_propagate(masks, aff, cfg)),
             2e-5))
        ms = {}
        for far in (False, True, True, False):
            ms.setdefault(far, []).append(
                cuda_ms(lambda: pk.par_propagate(masks, aff, cfg, far=far), 2))
        plain_ms = cuda_ms(lambda: par_plain.par_propagate(masks, aff, cfg), 2)
        bound = bound_ms(b_ * n * hh * ww * 4 + 2 * b_ * c * hh * ww * 4,
                         cfg.num_iter * 2 * n * b_ * c * hh * ww, "fp32")
        for far, tag in ((False, "packed"), (True, "far")):
            timing("par_propagate", f"{tag} form {cfg.dilations} {[b_, c, hh, ww]}",
                   sum(ms[far]) / 2, plain_ms, bound, None)
        print(f"[kernel] par_propagate {cfg.dilations} {what}: far / packed form "
              f"{sum(ms[True]) / sum(ms[False]):.4f} (packed {ms[False]}, far {ms[True]} ms)",
              flush=True)
        del imgs, masks, aff
        torch.cuda.empty_cache()
    # K1 less K2 at the same shape: the map kernel's cost where K1's forward
    # is K2's kernel with row statistics (fp32, and bf16 above 128)
    gaps = {}
    for key, k1 in times["attention_fwd_export"].items():
        k2 = times["attention_fwd"].get(key)
        if k2 is not None and (key.endswith("fp32") or int(key.split()[1]) > 128):
            gaps[key] = k1["ms"] - k2["ms"]
            print(f"[kernel] attention_fwd_export {key}: K1 {k1['ms']:.4f} ms - K2 "
                  f"{k2['ms']:.4f} ms = {gaps[key]:.4f} ms (the map); plain K1 "
                  f"{k1['plain_ms']:.4f} ms", flush=True)
    for name in times:
        add_checks(records, name, checks[name], extra_shapes=times[name])
    add_checks(records, "attention_fwd_export", [], map_gap_ms=gaps)
    # every attention instance's registers and spills (PAR's: check_kernels)
    return {lib: kernel_resources(lib) for lib in ("flash_attention", "hopper_attention",
                                                   "cross_attention", "attention")}


# (B, H, L, Dh) at which both designs of the bf16 self-attention forward
# are timed: the cells' shapes, smaller grids down to one block, and the
# other widths the wgmma kernel is built at
DESIGN_SHAPES = [(1, 1, 77, 64), (1, 12, 77, 64), (1, 12, 197, 64), (2, 12, 401, 64),
                 (4, 12, 401, 64), (16, 12, 401, 64), (16, 12, 626, 64), (8, 12, 1025, 64),
                 (16, 16, 842, 64), (8, 16, 1370, 64), (4, 12, 401, 32), (8, 12, 1025, 32),
                 (4, 12, 401, 128), (8, 12, 1025, 128)]


def check_forward_designs(reps: int = 20):
    """Phase 3: K2's forward by each design, flash_attention.cu's mma.sync
    kernel and hopper_attention.cu's wgmma kernel, on the same inputs (all
    keys valid) at DESIGN_SHAPES: device ms (CUDA events behind a spin),
    host microseconds a call (the launch with its tensor maps, queued
    without a wait), and which design ``forward_design`` picks.  Returns
    {shape: {design: {"ms", "host_us", "tflops"}, "picked"}}."""
    import torch
    from weclip_tpu_torch import kernels
    from weclip_tpu_torch.ops import attention_kernels as ak

    gen = torch.Generator(device="cuda").manual_seed(5)
    found = {}
    for b, h, l, dh in DESIGN_SHAPES:
        q, k, v = qkv(b, h, l, dh, gen, torch.bfloat16)
        km = torch.ones((b, l), device="cuda")
        bias = ak._padded_key_bias(km)
        out = torch.empty_like(q)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(), None,
                b, h, l, dh, ctypes.c_float(dh ** -0.5), torch.cuda.current_stream().cuda_stream)
        row = {"picked": ak.forward_design(torch.bfloat16, dh)}
        for design, lib, fn in ((ak.MMA, "flash_attention", "flash_fwd"),
                                (ak.WGMMA, "hopper_attention", "attn_fwd_wgmma")):
            call = functools.partial(kernels.call, lib, fn, *args)
            ms = cuda_ms(call, reps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                call()
            host_us = (time.perf_counter() - t0) / reps * 1e6
            torch.cuda.synchronize()
            row[design] = {"ms": ms, "host_us": host_us,
                           "tflops": 4 * b * h * l * l * dh / ms / 1e9}
        found[f"{[b, h, l, dh]}"] = row
        print(f"[design] {[b, h, l, dh]}: mma {row[ak.MMA]['ms']:.4f} ms "
              f"({row[ak.MMA]['tflops']:.0f} TFLOP/s, host {row[ak.MMA]['host_us']:.1f} us), "
              f"wgmma {row[ak.WGMMA]['ms']:.4f} ms ({row[ak.WGMMA]['tflops']:.0f} TFLOP/s, "
              f"host {row[ak.WGMMA]['host_us']:.1f} us); picked {row['picked']}", flush=True)
    return found


def cti_masks(b: int, canvas: int):
    """Key masks of the CTI attention on an eval canvas for the VOC sizes,
    as comer_forward builds them: the ViT patch grid (b, g*g) and the
    pyramid levels at 1/8, 1/16, 1/32 (b, L3 + L4 + L5), resized from the
    grid with half-pixel centres."""
    import torch
    import torch.nn.functional as F
    g = canvas // 16
    vp = token_mask(b, canvas)[:, 1:]
    sizes, n = [], canvas
    for _ in range(5):
        n = -(-n // 2)
        sizes.append(n)
    grid = vp.reshape(b, 1, g, g)
    ms = [(F.interpolate(grid, size=(n, n), mode="nearest-exact").reshape(b, -1) > 0.5)
          for n in sizes[2:]]
    return vp, torch.cat(ms, dim=1).float()


def check_cti_kernels(records, reps: int = 10):
    """K6 and K3-rect against their plain versions at every shape of the
    CoMer path (training crop 320 at batch 4; eval canvases 512 and 400 on
    the 16 flip-concatenated rows), in both score types; the
    autograd.Function that pairs them; appends their records."""
    import torch
    import torch.nn.functional as F

    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.ops import attention_kernels as ak

    precision.strict_matmul()
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16
    record = functools.partial(record_kernel, records)
    h, dh = 4, 64
    ones = lambda b, n: torch.ones((b, n), device="cuda")
    vp1, ms1 = cti_masks(16, 512)
    vp2, ms2 = cti_masks(16, 400)
    # (what, B, Lq, Lk, key mask): injection (pyramid queries, ViT keys)
    # and extraction (the reverse) of each program
    shapes = [("train inj", 4, 2100, 400, ones(4, 400)),
              ("train ext", 4, 400, 2100, ones(4, 2100)),
              ("eval s1 inj", 16, ms1.shape[1], vp1.shape[1], vp1),
              ("eval s1 ext", 16, vp1.shape[1], ms1.shape[1], ms1),
              ("eval s2 inj", 16, ms2.shape[1], vp2.shape[1], vp2),
              ("eval s2 ext", 16, vp2.shape[1], ms2.shape[1], ms2)]

    def qkv_rect(b, lq, lk, dtype):
        q = (torch.randn((b, h, lq, dh), generator=gen, device="cuda") * dh ** -0.5)
        k, v = (torch.randn((b, h, lk, dh), generator=gen, device="cuda")
                for _ in range(2))
        return q.to(dtype), k.to(dtype), v.to(dtype)

    # K6: every CTI shape in both score types, bf16 timed beside SDPA with
    # the same boolean key mask
    checks, ms_by_shape, lib_by_shape = [], {}, {}
    for what, b, lq, lk, km in shapes:
        for dtype in (bf, torch.float32):
            q, k, v = qkv_rect(b, lq, lk, dtype)
            out = ak.cross_attention_core(q, k, v, km)
            ref = ak.cross_attention_core_plain(q, k, v, km)
            torch.cuda.synchronize()
            tol = bf16_ulp(float(ref.abs().max())) if dtype == bf else 2e-5
            checks.append((f"{what} out {[b, h, lq, dh]} x {lk} keys "
                           f"{str(dtype)[6:]} fp32 out", max_err(out, ref), tol))
            if dtype == bf:
                ms_by_shape[what] = cuda_ms(lambda: ak.cross_attention_core(q, k, v, km),
                                            reps)
                mask = km.bool()[:, None, None, :]
                lib_by_shape[what] = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=1.0), reps)
                print(f"[kernel] cross_attention {what} {[b, h, lq, dh]} x {lk}: "
                      f"{ms_by_shape[what]:.4f} ms, SDPA {lib_by_shape[what]:.4f} ms",
                      flush=True)
            del out, ref
    what, b, lq, lk, km = shapes[2]
    q, k, v = qkv_rect(b, lq, lk, bf)
    k6_bytes = b * h * (lq * dh * 2 + 2 * lk * dh * 2 + lq * dh * 4) + b * lk * 4
    record("cross_attention", "weclip_tpu_torch/csrc/hopper_attention.cu",
           "weclip_tpu/ops/pallas_attention.py:539 (cross_attention_core_pallas; "
           "pallas_call :582)",
           checks, ms_by_shape[what],
           cuda_ms(lambda: ak.cross_attention_core_plain(q, k, v, km), reps),
           bound_ms(k6_bytes, 4 * b * h * lq * lk * dh, "bf16"), lib_by_shape[what],
           [[s[1], h, s[2], dh, s[3]] for s in shapes],
           timed_shape=what, ms_by_shape=ms_by_shape, library_ms_by_shape=lib_by_shape,
           fp32_source="weclip_tpu_torch/csrc/cross_attention.cu")
    del q, k, v
    torch.cuda.empty_cache()

    # K3-rect: the CTI backward of training, bf16 (held like K3: max to one
    # bf16 ulp, mean to 1e-5 of each gradient's largest magnitude) and fp32
    # (2e-5 of it)
    checks, failed, ms_by_shape, lib_by_shape, means = [], [], {}, {}, {}
    for what, b, lq, lk, km in shapes[:2]:
        for dtype in (bf, torch.float32):
            q, k, v = qkv_rect(b, lq, lk, dtype)
            do = torch.randn((b, h, lq, dh), generator=gen, device="cuda")
            got = ak.attention_bwd(q.float(), k, v, do, km, dtype)
            ref = ak.attention_bwd_plain(q.float(), k, v, do, km, dtype)
            torch.cuda.synchronize()
            for name, a, r in zip(("dq", "dk", "dv"), got, ref):
                sc = float(r.abs().max())
                rel = 2.0 ** -8 if dtype == bf else 2e-5
                label = f"{what} {name} {str(dtype)[6:]} (largest |{name}| {sc:.3e})"
                checks.append((label, max_err(a, r), rel * sc))
                if dtype == bf:
                    mean = float((a - r).abs().mean())
                    means[label] = mean
                    if mean > 1e-5 * sc:
                        failed.append(f"{label}: mean error {mean}")
            if dtype == bf:
                ms_by_shape[what] = cuda_ms(
                    lambda: ak.attention_bwd(q, k, v, do, km, bf), reps)
                lib_by_shape[what] = sdpa_bwd_ms(q, k, v, do, km, reps)
            del got, ref
    what, b, lq, lk, km = shapes[0]
    q, k, v = qkv_rect(b, lq, lk, bf)
    do = torch.randn((b, h, lq, dh), generator=gen, device="cuda")
    qf = q.float()
    plain_ms = cuda_ms(lambda: ak.attention_bwd_plain(q, k, v, do, km, bf), reps)
    # the autograd.Function: under bf16 exactly K6's output and K3-rect's
    # gradients in the primal dtype; under fp32 autograd of the plain forward
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = ak.CrossAttentionCoreFn.apply(qg, kg, vg, km)
    g_fn = torch.autograd.grad(out, (qg, kg, vg), do)
    want = [t.to(bf) for t in ak.attention_bwd(qf, k, v, do, km, bf)]
    same = (torch.equal(out, ak.cross_attention_core(q, k, v, km))
            and all(a.dtype == bf and torch.equal(a, w) for a, w in zip(g_fn, want)))
    print(f"[kernel] CrossAttentionCoreFn bf16: output and gradients equal to K6's "
          f"and K3-rect's: {same}", flush=True)
    if not same:
        failed.append("CrossAttentionCoreFn differs from K6/K3-rect")
    q32, k32, v32 = (t[:1].float().requires_grad_(True) for t in (q, k, v))
    out = ak.CrossAttentionCoreFn.apply(q32, k32, v32, km[:1])
    g_fn = torch.autograd.grad(out, (q32, k32, v32), do[:1])
    out_p = ak.cross_attention_core_plain(q32, k32, v32, km[:1])
    g_pl = torch.autograd.grad(out_p, (q32, k32, v32), do[:1])
    rel = max(max_err(a, r) / float(r.abs().max()) for a, r in zip(g_fn, g_pl))
    print(f"[kernel] CrossAttentionCoreFn fp32 vs autograd of the plain forward: "
          f"max error / max |grad| = {rel:.3e} (tol 1e-4)", flush=True)
    if rel > 1e-4:
        failed.append(f"CrossAttentionCoreFn fp32 gradient off by {rel}")
    # as CrossAttentionCoreFn hands them over: q, k, v bf16, dO fp32 in;
    # dq, dk, dv fp32 out; the key mask
    bwd_bytes = b * h * (lq * dh * 2 + 2 * lk * dh * 2 + lq * dh * 4
                         + lq * dh * 4 + 2 * lk * dh * 4) + b * lk * 4
    record("attention_bwd_rect", "weclip_tpu_torch/csrc/flash_attention.cu",
           "weclip_tpu/ops/pallas_attention.py:395 (attention_bwd_pallas with "
           "Lq != Lk; pallas_call :441)",
           checks, ms_by_shape[what], plain_ms,
           bound_ms(bwd_bytes, 10 * b * h * lq * lk * dh, "bf16"), lib_by_shape[what],
           [[s[1], h, s[2], dh, s[3]] for s in shapes[:2]],
           timed_shape=what, ms_by_shape=ms_by_shape, library_ms_by_shape=lib_by_shape,
           mean_abs_err=means,
           autograd_fn_bf16_exact=same, autograd_fn_fp32_rel_err=rel)
    if failed:
        raise AssertionError(f"attention_bwd_rect: {failed}")
    del q, k, v, do, qf, g_fn, g_pl, out, out_p
    torch.cuda.empty_cache()


def voc_images(n: int, seed: int):
    rng = np.random.default_rng(seed)
    ims, ids = [], []
    for i in range(n):
        oh, ow = VOC_SIZES[i % len(VOC_SIZES)]
        ims.append(rng.integers(0, 256, (oh, ow, 3)).astype(np.uint8))
        ids.append(sorted({int(rng.integers(0, 20)), 19}))
    return ims, ids


def run_pipeline():
    """Phase 4: the main path at full width; returns launches per call."""
    import torch

    from weclip_tpu_torch import kernels
    from weclip_tpu_torch.api import WeCLIPPipeline
    from weclip_tpu_torch.core.config import Config

    cfg = Config()
    ims, ids = voc_images(cfg.eval.batch_images, seed=1)
    pipe = WeCLIPPipeline(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()

    launches = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    labels = pipe.pseudo_label_batch(ims, class_ids=ids)
    torch.cuda.synchronize()
    t_pl = time.perf_counter() - t0
    launches["pseudo_label"] = dict(kernels.launches)
    kernels.reset_launches()
    t0 = time.perf_counter()
    segs = pipe.segment_batch(ims)
    torch.cuda.synchronize()
    t_seg = time.perf_counter() - t0
    launches["segment"] = dict(kernels.launches)
    print(f"[pipeline] pseudo_label_batch(8) {t_pl * 1e3:.1f} ms, "
          f"segment_batch(8) {t_seg * 1e3:.1f} ms (host clock, first call); "
          f"launches {json.dumps(launches)}", flush=True)

    for im, lab, seg, cid in zip(ims, labels, segs, ids):
        if lab.shape != im.shape[:2] or seg.shape != im.shape[:2]:
            raise AssertionError(f"output shapes {lab.shape}, {seg.shape} "
                                 f"for image {im.shape}")
        allowed = {0} | {c + 1 for c in cid}
        if not set(np.unique(lab).tolist()) <= allowed:
            raise AssertionError(f"pseudo labels {np.unique(lab)} outside {allowed}")
        if seg.min() < 0 or seg.max() >= cfg.dataset.num_classes:
            raise AssertionError(f"segmentation labels out of range: {np.unique(seg)}")
    steady = profile_pipeline(pipe, ims, ids)

    # fp32 policy: the card's kernels against the CPU's plain versions
    pipe_gpu = WeCLIPPipeline(cfg, device="cuda", precision_name="float32", seed=0)
    pipe_cpu = WeCLIPPipeline(cfg, device="cpu", precision_name="float32", seed=0)
    im, cid = ims[0], ids[0]
    lab_gpu = pipe_gpu.pseudo_label(im, class_ids=cid)
    lab_cpu = pipe_cpu.pseudo_label(im, class_ids=cid)
    seg_gpu = pipe_gpu.segment(im)
    seg_cpu = pipe_cpu.segment(im)
    agree = float((lab_gpu == lab_cpu).mean())
    agree_seg = float((seg_gpu == seg_cpu).mean())
    print(f"[pipeline] fp32 card vs CPU: pseudo-label agreement {agree:.6f}, "
          f"segmentation agreement {agree_seg:.6f} (need >= 0.99)", flush=True)
    if agree < 0.99 or agree_seg < 0.99:
        raise AssertionError("fp32 card and CPU outputs disagree")
    return launches, {"pseudo_label_ms": t_pl * 1e3, "segment_ms": t_seg * 1e3,
                      **steady,
                      "fp32_pseudo_label_agreement": agree,
                      "fp32_segment_agreement": agree_seg}


def open_comer_gates(params, seed: int):
    """Set the CoMer branch's zero-init output projections (every CTI
    attention's o_w and the branch's out_w) to seeded random values: at
    init the branch outputs exactly 0, whatever it computes."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    c = params["comer"]

    def rnd(t, std):
        return (torch.randn(t.shape, generator=gen) * std).to(t.device)

    for stage in c["cti"]:
        for d in ("inj", "ext"):
            stage[d]["o_w"] = rnd(stage[d]["o_w"], 0.02)
    c["out_w"] = rnd(c["out_w"], c["out_w"].shape[1] ** -0.5)
    return params


COMER_CONFIG = "configs/voc_comer.yaml"


def run_comer_pipeline():
    """Phase 5: the msc-flip inference path with the CoMer branch at full
    width (``configs/voc_comer.yaml``, gates opened); returns launches per
    call and the warm times and profile."""
    import torch

    from weclip_tpu_torch import kernels
    from weclip_tpu_torch.api import WeCLIPPipeline
    from weclip_tpu_torch.core.config import load_config

    cfg = load_config(COMER_CONFIG)
    ims, ids = voc_images(cfg.eval.batch_images, seed=1)
    pipe = WeCLIPPipeline(cfg, device="cuda", seed=0)
    open_comer_gates(pipe.params, seed=5)
    torch.cuda.synchronize()
    launches = {}
    kernels.reset_launches()
    labels = pipe.pseudo_label_batch(ims, class_ids=ids)
    torch.cuda.synchronize()
    launches["comer_pseudo_label"] = dict(kernels.launches)
    kernels.reset_launches()
    segs = pipe.segment_batch(ims)
    torch.cuda.synchronize()
    launches["comer_segment"] = dict(kernels.launches)
    print(f"[comer] launches {json.dumps(launches)}", flush=True)
    for im, lab, seg, cid in zip(ims, labels, segs, ids):
        allowed = {0} | {c + 1 for c in cid}
        if lab.shape != im.shape[:2] or not set(np.unique(lab).tolist()) <= allowed:
            raise AssertionError(f"CoMer pseudo labels {np.unique(lab)} outside {allowed}")
        if seg.shape != im.shape[:2] or seg.min() < 0 or seg.max() >= cfg.dataset.num_classes:
            raise AssertionError(f"CoMer segmentation out of range: {np.unique(seg)}")
    steady = profile_pipeline(pipe, ims, ids, tag="comer ")
    del pipe
    torch.cuda.empty_cache()
    return launches, steady


def synthetic_train_batch(cfg, b: int, seed: int):
    """``b`` normalized random crops with 1-3 random present classes each."""
    rng = np.random.default_rng(seed)
    crop = cfg.dataset.crop_size
    pix = rng.integers(0, 256, (b, crop, crop, 3)).astype(np.float32)
    img = (pix - np.asarray(cfg.dataset.mean)) / np.asarray(cfg.dataset.std)
    num_fg = cfg.dataset.num_classes - 1
    present = np.zeros((b, num_fg), bool)
    for i in range(b):
        present[i, rng.choice(num_fg, int(rng.integers(1, 4)), replace=False)] = True
    return {"img": img.transpose(0, 3, 1, 2).astype(np.float32), "present_mask": present}


def run_training(warm: int = 2, timed: int = 5):
    """Phase 6: the CoMer training step at full width (ViT-B/16,
    ``configs/voc_comer.yaml``, crop 320, batch 4, bf16 backbone policy,
    dropout on), gates opened; then one fp32-policy, dropout-off step on the
    card against the same step on the CPU at batch 1.  Returns launches of
    one step and the measurements."""
    import torch

    from weclip_tpu_torch import kernels
    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.core.config import load_config
    from weclip_tpu_torch.models import weclip
    from weclip_tpu_torch.train import step as step_mod
    from weclip_tpu_torch.train.trainer import make_batcher

    cfg = load_config(COMER_CONFIG)
    params = open_comer_gates(weclip.init_trainable_params(
        torch.Generator().manual_seed(0), cfg), seed=5)
    frozen = weclip.random_frozen_state(cfg, seed=0, device="cuda")
    state = step_mod.create_train_state(None, cfg, "cuda", params=params)
    step_fn = step_mod.make_train_step(cfg, precision.make_policy(cfg.precision.compute_dtype))
    host = synthetic_train_batch(cfg, cfg.train.samples_per_gpu, seed=2)
    batch, ci, ca = make_batcher(cfg, frozen, "cuda")(host)
    before = [t.detach().clone() for t in step_mod.param_leaves(state.params)]

    def one():
        _, m = step_fn(state, frozen, batch, rng=7, cls_idx=ci, cls_active=ca)
        return m

    metrics = [one() for _ in range(warm)]
    torch.cuda.synchronize()
    times = []
    for i in range(timed):
        if i == 0:
            kernels.reset_launches()
        t0 = time.perf_counter()
        metrics.append(one())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches = {"train_step": dict(kernels.launches)}
    step_ms = float(np.median(times))
    losses = [float(m.loss) for m in metrics]
    print(f"[train] {len(metrics)} steps at batch {cfg.train.samples_per_gpu}, crop "
          f"{cfg.dataset.crop_size}: losses {[round(x, 5) for x in losses]}; step "
          f"{step_ms:.1f} ms (median of {timed}, host clock), "
          f"{cfg.train.samples_per_gpu / step_ms * 1e3:.2f} img/s; launches of one "
          f"step {json.dumps(launches['train_step'])}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    after = step_mod.param_leaves(state.params)
    unchanged = sum(bool(torch.equal(a.detach(), b)) for a, b in zip(after, before))
    zero_grads = [i for i, t in enumerate(step_mod.param_leaves(state.params["comer"]))
                  if t.grad is None or float(t.grad.abs().max()) == 0.0]
    print(f"[train] parameters unchanged after {len(metrics)} steps: {unchanged} of "
          f"{len(after)} leaves; comer leaves with a zero gradient: {len(zero_grads)} "
          f"of {len(step_mod.param_leaves(state.params['comer']))}", flush=True)
    if unchanged or zero_grads:
        raise AssertionError(f"training did not move every parameter ({unchanged} "
                             f"unchanged) or comer leaves {zero_grads} got no gradient")
    busy, idle = trace(one, "train step")
    del state, before, after, batch
    torch.cuda.empty_cache()
    out = {"step_ms": step_ms, "images_per_s": cfg.train.samples_per_gpu / step_ms * 1e3,
           "step_times_ms": times, "losses": losses, "device_busy_ms": busy,
           "idle_share": idle, **compare_fp32_step(cfg, params)}
    return launches, out


def named_leaves(tree, prefix=""):
    """(path, tensor) of a parameter tree, in ``step.param_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in named_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in named_leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def compare_fp32_step(cfg, params):
    """One fp32-policy, dropout-off ``make_train_step`` step at batch 1 on
    the CPU (plain versions) and on the card (K1-K6 and K3-rect in fp32),
    lr at its full value from step 0 so that the update is visible.  Each
    device's pseudo labels (``forward_train``) are compared; then both steps
    train against the CPU's labels (the step's ``pseudo``), so that a pixel
    whose label flips in the CAM chain does not stand in for a difference in
    the gradients.  Each gradient leaf is held to its own largest magnitude,
    except the CTI key biases (``k_b``): the softmax cancels their gradient,
    which is rounding on either device; their readings are printed."""
    import dataclasses

    import torch

    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.models import weclip
    from weclip_tpu_torch.train import step as step_mod
    from weclip_tpu_torch.train.trainer import make_batcher

    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer,
                                                                 warmup_iter=0))
    host = synthetic_train_batch(cfg, 1, seed=3)
    step_fn = step_mod.make_train_step(cfg, precision.FP32)
    res = {}
    for device in ("cpu", "cuda"):
        frozen = weclip.random_frozen_state(cfg, seed=0, device=device)
        state = step_mod.create_train_state(None, cfg, device, params=params)
        batch, ci, ca = make_batcher(cfg, frozen, device)(host)
        t0 = time.perf_counter()
        with torch.no_grad():
            labels = weclip.forward_train(state.params, frozen, batch, cfg, False, None,
                                          precision.FP32, cls_idx=ci,
                                          cls_active=ca).cam_labels.cpu()
        pseudo = labels if device == "cpu" else res["cpu"]["labels"]
        _, m = step_fn(state, frozen, batch, cls_idx=ci, cls_active=ca,
                       pseudo=pseudo.to(device))
        leaves = named_leaves(state.params)
        res[device] = {"loss": float(m.loss), "labels": labels,
                       "grads": {n: t.grad.cpu() for n, t in leaves},
                       "params": {n: t.detach().cpu() for n, t in leaves}}
        print(f"[train] fp32 step at batch 1 on {device}: loss {res[device]['loss']:.6f}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del state, frozen, batch
    c, d = res["cpu"], res["cuda"]
    agree = float((c["labels"] == d["labels"]).float().mean())
    loss_rel = abs(d["loss"] - c["loss"]) / abs(c["loss"])
    key_bias = [n for n in c["grads"] if n.startswith("/comer/cti/") and n.endswith("/k_b")]
    for n in key_bias:
        kw = c["grads"][n[:-3] + "k_w"].abs().max()
        print(f"[train] {n} left out (softmax-cancelled): largest |grad| cpu "
              f"{float(c['grads'][n].abs().max()):.3e}, card "
              f"{float(d['grads'][n].abs().max()):.3e}; its k_w's {float(kw):.3e}",
              flush=True)
    held = [n for n in c["grads"] if n not in key_bias]
    grad_rel = {n: float((d["grads"][n] - c["grads"][n]).abs().max()
                         / c["grads"][n].abs().max().clamp_min(1e-30)) for n in held}
    worst = sorted(grad_rel.items(), key=lambda kv: -kv[1])[:3]
    # the update of an element whose gradient is well above its leaf's noise
    # floor (AdamW's first step moves every element by about lr * sign(g))
    settled = torch.cat([(c["grads"][n].abs() >= 1e-3 * c["grads"][n].abs().max())
                         .reshape(-1) for n in held])
    pdiff = torch.cat([(d["params"][n] - c["params"][n]).abs().reshape(-1) for n in held])
    close = float((pdiff[settled] <= 1e-6).float().mean())
    print(f"[train] fp32 card vs CPU: pseudo-label agreement {agree:.6f} (need >= 0.99); "
          f"on the CPU's labels: loss relative difference {loss_rel:.3e} (tol 1e-4); "
          f"gradient max error / the leaf's largest |grad| over {len(held)} leaves, "
          f"worst {', '.join(f'{n} {r:.3e}' for n, r in worst)} (tol 1e-3); updated "
          f"parameters within 1e-6 where the gradient is at least 1e-3 of its leaf's "
          f"largest: {close:.6f} of {int(settled.sum())} (need >= 0.999)", flush=True)
    if agree < 0.99 or loss_rel > 1e-4 or worst[0][1] > 1e-3 or close < 0.999:
        raise AssertionError("fp32 training step differs between the card and the CPU")
    return {"fp32_loss_cpu": c["loss"], "fp32_loss_card": d["loss"],
            "fp32_loss_rel_diff": loss_rel, "fp32_pseudo_label_agreement": agree,
            "fp32_grad_leaf_rel_err": grad_rel, "fp32_params_close_share": close}


COCO_CONFIG = "configs/coco.yaml"
VOC_CONFIG = "configs/voc.yaml"


def run_coco_pseudo_label():
    """Phase 7: a COCO pseudo label without class ids (81 classes, so PAR
    refines 81 channels) at full width, fp32, on the card and on the CPU
    (plain versions); label agreement at least 0.99.  Returns launches of
    the card's call and the measurements."""
    import torch

    from weclip_tpu_torch import kernels
    from weclip_tpu_torch.api import WeCLIPPipeline
    from weclip_tpu_torch.core.config import load_config

    cfg = load_config(COCO_CONFIG)
    im = voc_images(1, seed=4)[0][0]
    pipe = WeCLIPPipeline(cfg, device="cuda", precision_name="float32", seed=0)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    lab_gpu = pipe.pseudo_label(im)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    launches = {"coco_pseudo_label": dict(kernels.launches)}
    del pipe
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lab_cpu = WeCLIPPipeline(cfg, device="cpu", precision_name="float32",
                             seed=0).pseudo_label(im)
    cpu_s = time.perf_counter() - t0
    agree = float((lab_gpu == lab_cpu).mean())
    print(f"[coco] pseudo_label without class ids on {im.shape[:2]}, 81 classes, fp32: "
          f"card {card_ms:.1f} ms (first call), CPU {cpu_s:.1f} s; label agreement "
          f"{agree:.6f} (need >= 0.99); classes on the card "
          f"{sorted(np.unique(lab_gpu).tolist())[:12]}; launches "
          f"{json.dumps(launches['coco_pseudo_label'])}", flush=True)
    if lab_gpu.shape != im.shape[:2] or agree < 0.99:
        raise AssertionError(f"COCO pseudo labels: shape {lab_gpu.shape}, agreement {agree}")
    return launches, {"card_first_call_ms": card_ms, "cpu_s": cpu_s, "agreement": agree}


def labelled_voc_examples(n: int, seed: int, num_classes: int = 21):
    """``n`` synthetic VOC-size examples for ``Evaluator.run``: random
    pixels, a label of 2-3 rectangles of random classes on background, a
    strip of ignore, and the class set of the label."""
    rng = np.random.default_rng(seed)
    ims, _ = voc_images(n, seed)
    out = []
    for i, im in enumerate(ims):
        oh, ow = im.shape[:2]
        label = np.zeros((oh, ow), np.int32)
        for _ in range(int(rng.integers(2, 4))):
            y0, x0 = int(rng.integers(0, oh // 2)), int(rng.integers(0, ow // 2))
            label[y0:y0 + oh // 3, x0:x0 + ow // 3] = int(rng.integers(1, num_classes))
        label[-8:] = 255
        ids = np.unique(label)
        present = np.zeros(num_classes - 1, bool)
        present[ids[(ids > 0) & (ids < num_classes)] - 1] = True
        out.append({"name": f"syn{i}", "img_raw": im, "label": label,
                    "present_mask": present})
    return out


def run_train_loop(steps: int = 6, every: int = 3, keep: str = None):
    """Phase 8: ``train/trainer.py::train`` at full width
    (``configs/voc.yaml``: crop 320, batch 4), 16 random crops through the
    PrefetchLoader, 8 labelled VOC-size images for validation, a checkpoint
    and a validation every ``every`` steps and a final checkpoint; then
    ``every`` steps, and a resumed run to ``steps``, whose parameters must
    equal the uninterrupted run's.  Times a validation, a checkpoint save
    and restore and the loader's batches.  Phase 9 (a pipeline built from
    the last checkpoint) runs inside, while the checkpoints exist; a copy of
    that checkpoint goes to ``keep`` for phase 13.  Returns launches of the
    uninterrupted run and the measurements."""
    import dataclasses
    import logging
    import tempfile

    import torch

    from weclip_tpu_torch import kernels
    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.core.config import load_config
    from weclip_tpu_torch.data.loader import PrefetchLoader
    from weclip_tpu_torch.models import weclip
    from weclip_tpu_torch.train import checkpoint
    from weclip_tpu_torch.train import step as step_mod
    from weclip_tpu_torch.train.trainer import train, validate

    base = load_config(VOC_CONFIG)
    host = synthetic_train_batch(base, 16, seed=8)
    data = [{"img": host["img"][i], "present_mask": host["present_mask"][i]}
            for i in range(16)]
    val = labelled_voc_examples(8, seed=9)
    frozen = weclip.random_frozen_state(base, seed=base.train.seed, device="cuda")
    log = logging.getLogger("weclip_tpu_torch")
    log.setLevel(logging.INFO)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("[train-loop] %(message)s"))
    log.addHandler(handler)
    out = {}
    try:
        with tempfile.TemporaryDirectory(prefix="weclip_chip_smoke_") as work:
            def cfg_in(sub):
                return dataclasses.replace(
                    base, train=dataclasses.replace(base.train, eval_iters=every,
                                                    ckpt_start_iter=0, log_iters=every),
                    work_dir=dataclasses.replace(base.work_dir,
                                                 dir=os.path.join(work, sub)))

            kernels.reset_launches()
            t0 = time.perf_counter()
            full = train(cfg_in("full"), data, max_steps=steps, device="cuda",
                         frozen=frozen, val_dataset=val)
            torch.cuda.synchronize()
            out["run_s"] = time.perf_counter() - t0
            launches = {"train_loop": dict(kernels.launches)}
            part_cfg = cfg_in("part")
            train(part_cfg, data, max_steps=every, device="cuda", frozen=frozen,
                  val_dataset=val)
            resumed = train(part_cfg, data, max_steps=steps, device="cuda", frozen=frozen,
                            val_dataset=val, resume=True)
            pairs = [(a.detach(), b.detach()) for a, b in zip(
                step_mod.param_leaves(resumed.params), step_mod.param_leaves(full.params))]
            equal = all(torch.equal(a, b) for a, b in pairs)
            worst = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                        for a, b in pairs)
            print(f"[train-loop] {steps} steps (checkpoints and validation every {every}) "
                  f"in {out['run_s']:.1f} s; resumed at step {every} to {steps}: params "
                  f"bit-equal {equal}, largest difference / the leaf's largest |param| "
                  f"{worst:.3e} (tol 1e-6); launches {json.dumps(launches['train_loop'])}",
                  flush=True)
            if resumed.step != steps or (not equal and worst > 1e-6):
                raise AssertionError(f"resumed run differs: step {resumed.step}, {worst}")
            out.update(resume_bit_equal=equal, resume_max_rel_diff=worst)

            policy = precision.make_policy(base.precision.compute_dtype)
            validate(base, full.params, frozen, val, policy, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores = validate(base, full.params, frozen, val, policy, device="cuda")
            torch.cuda.synchronize()
            out["validate_ms"] = (time.perf_counter() - t0) * 1e3
            out["val_scores"] = {k: {m: float(v[m]) for m in ("pAcc", "mAcc", "miou")}
                                 for k, v in scores.items()}
            print(f"[train-loop] validate (8 images, single scale, CAM chain, warm) "
                  f"{out['validate_ms']:.1f} ms; scores {json.dumps(out['val_scores'])}",
                  flush=True)

            t0 = time.perf_counter()
            path = checkpoint.save(os.path.join(work, "timing"), steps, full.params,
                                   full.optimizer, full.scheduler)
            out["ckpt_save_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            checkpoint.restore(path, device="cuda")
            torch.cuda.synchronize()
            out["ckpt_restore_ms"] = (time.perf_counter() - t0) * 1e3
            out["ckpt_bytes"] = os.path.getsize(os.path.join(path, checkpoint.STATE_FILE))
            loader = PrefetchLoader(data, base.train.samples_per_gpu, seed=base.train.seed)
            try:
                next(loader)
                t0 = time.perf_counter()
                for _ in range(20):
                    next(loader)
                out["loader_ms_per_batch"] = (time.perf_counter() - t0) * 1e3 / 20
            finally:
                loader.close()
            print(f"[train-loop] checkpoint ({out['ckpt_bytes'] / 1e6:.1f} MB) save "
                  f"{out['ckpt_save_ms']:.1f} ms, restore to the card "
                  f"{out['ckpt_restore_ms']:.1f} ms; loader {out['loader_ms_per_batch']:.3f} "
                  f"ms a batch of {base.train.samples_per_gpu} in-memory crops", flush=True)
            last = os.path.join(work, "full", base.work_dir.ckpt_dir, f"step_{steps:08d}")
            if keep:
                shutil.copytree(last, os.path.join(keep, f"step_{steps:08d}"))
            ckpt_launches, out["model_path"] = run_model_path(base, last, full.params,
                                                              frozen)
            launches.update(ckpt_launches)
    finally:
        log.removeHandler(handler)
    del full, resumed
    torch.cuda.empty_cache()
    return launches, out


def run_model_path(cfg, path: str, params, frozen):
    """Phase 9: ``WeCLIPPipeline(model_path=path)`` segments one image as a
    pipeline given the same parameters through ``weights``."""
    import torch

    from weclip_tpu_torch import kernels
    from weclip_tpu_torch.api import WeCLIPPipeline

    im = voc_images(1, seed=10)[0][0]
    kernels.reset_launches()
    got = WeCLIPPipeline(cfg, model_path=path, device="cuda",
                         seed=cfg.train.seed).segment(im)
    torch.cuda.synchronize()
    launches = {"model_path_segment": dict(kernels.launches)}
    want = WeCLIPPipeline(cfg, device="cuda",
                          weights={"params": params, "frozen": frozen}).segment(im)
    equal = bool(np.array_equal(got, want))
    print(f"[model-path] segment from {os.path.basename(path)} equal to weights=: {equal}",
          flush=True)
    if not equal:
        raise AssertionError(f"model_path pipeline differs on {(got != want).mean()} of pixels")
    return launches, {"equal": equal}


def eval_predictions(ev, params, frozen, examples):
    """``Evaluator.run``'s per-batch steps, keeping the msc predictions:
    (pred_msc (n, Co, Co) on the host, (seg, msc, cam) histograms)."""
    from weclip_tpu_torch.evalx import metrics
    k = ev.cfg.dataset.num_classes
    hists = tuple(metrics.zero_hist(k, ev.device) for _ in range(3))
    preds = []
    bsz = ev.cfg.eval.batch_images
    for s in range(0, len(examples), bsz):
        sb1, sb2, sizes, labels, presents, ci, ca = ev.build_batch(examples[s:s + bsz])
        seg_single, seg_avg1, cam = ev.scale1_for(ci.shape[1])(params, frozen, sb1, presents,
                                                                sizes, ci, ca)
        seg_avg2 = ev.scale2(params, frozen, sb2, presents, sizes)
        _, pred, hists = ev.combine(seg_single, seg_avg1, seg_avg2, cam, labels, sizes, hists)
        preds.append(pred.cpu().numpy())
    return np.concatenate(preds), [h.cpu().numpy() for h in hists]


def run_evaluator(n: int = 8):
    """Phase 10: ``Evaluator.run`` msc-flip over ``n`` labelled VOC-size
    images at full width (``Config()``, resize_long 512): warm images/s,
    the device's idle share, the mIoU, every histogram counting exactly the
    labelled pixels; then the first 2 images at fp32 on the card and on the
    CPU (plain versions), the msc predictions agreeing on at least 0.99 of
    the labelled pixels.  Returns launches of one run and the measurements."""
    import dataclasses

    import torch

    from weclip_tpu_torch import kernels
    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.core.config import Config
    from weclip_tpu_torch.evalx.runner import Evaluator, make_prep
    from weclip_tpu_torch.models import weclip

    cfg = Config()
    examples = labelled_voc_examples(n, seed=11)
    n_gt = sum(int(((ex["label"] >= 0) & (ex["label"] < 21)).sum()) for ex in examples)
    prep = make_prep(cfg, max_ori=512, resize_long=cfg.eval.resize_long)

    def model(device):
        params = weclip.init_trainable_params(torch.Generator().manual_seed(0), cfg, device)
        frozen = weclip.random_frozen_state(cfg, seed=0, device=device)
        return params, frozen, frozen["visual"]["positional_embedding"].cpu().numpy()

    params, frozen, pe = model("cuda")
    ev = Evaluator(cfg, prep, pe, device="cuda")
    kernels.reset_launches()
    res = ev.run(params, frozen, examples, return_hists=True)
    torch.cuda.synchronize()
    launches = {"evaluator_run": dict(kernels.launches)}
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        ev.run(params, frozen, examples)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    warm_s = float(np.median(times))
    busy, idle = trace(lambda: ev.run(params, frozen, examples), f"Evaluator.run({n})")
    totals = {k: int(h.sum()) for k, h in res["hists"].items()}
    out = {"images_per_s": n / warm_s, "run_ms": warm_s * 1e3, "device_busy_ms": busy,
           "idle_share": idle, "miou": {k: float(res[k]["miou"]) for k in res if k != "hists"},
           "hist_totals": totals, "labelled_pixels": n_gt}
    print(f"[evaluator] Evaluator.run msc-flip over {n} images: {warm_s * 1e3:.1f} ms warm "
          f"(median of 3), {n / warm_s:.2f} images/s; mIoU {json.dumps(out['miou'])}; "
          f"histogram totals {totals} (labelled pixels {n_gt}); launches "
          f"{json.dumps(launches['evaluator_run'])}", flush=True)
    if any(t != n_gt for t in totals.values()):
        raise AssertionError(f"histogram totals {totals} != {n_gt} labelled pixels")
    del params, frozen, ev

    cfg2 = dataclasses.replace(cfg, eval=dataclasses.replace(cfg.eval, batch_images=2))
    got = {}
    for where, device in (("card", "cuda"), ("cpu", "cpu")):
        p, f, pe = model(device)
        ev = Evaluator(cfg2, prep, pe, policy=precision.FP32, device=device)
        got[where] = eval_predictions(ev, p, f, examples[:2])
        del p, f, ev
    (pg, hg), (pc, hc) = got["card"], got["cpu"]
    counted = np.stack([np.pad((ex["label"] >= 0) & (ex["label"] < 21),
                               [(0, prep.canvas_out - ex["label"].shape[0]),
                                (0, prep.canvas_out - ex["label"].shape[1])])
                        for ex in examples[:2]])
    agree = float((pg == pc)[counted].mean())
    hist_agree = float(np.minimum(hg[1], hc[1]).sum() / hc[1].sum())
    print(f"[evaluator] fp32 card vs CPU, first 2 images: msc predictions equal on "
          f"{agree:.6f} of labelled pixels, msc histograms share {hist_agree:.6f} of "
          f"their counts (need >= 0.99)", flush=True)
    if agree < 0.99 or hist_agree < 0.99:
        raise AssertionError(f"fp32 card and CPU evaluations disagree: {agree}, {hist_agree}")
    out.update(fp32_msc_agreement=agree, fp32_msc_hist_agreement=hist_agree)
    torch.cuda.empty_cache()
    return launches, out


def run_seg_steps():
    """Phase 11: two ``seg_step`` steps at full width (``configs/voc.yaml``,
    crop 320, batch 4, bf16 backbone) on random ground truth: finite losses,
    every parameter moved; then one fp32 step at batch 1 on the card and on
    the CPU, losses within 1e-4.  Returns launches of the two steps and the
    measurements."""
    import dataclasses

    import torch

    from weclip_tpu_torch import kernels
    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.core.config import load_config
    from weclip_tpu_torch.models import weclip
    from weclip_tpu_torch.train import seg_step
    from weclip_tpu_torch.train import step as step_mod
    from weclip_tpu_torch.train.trainer import make_batcher

    cfg = load_config(VOC_CONFIG)
    cfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer,
                                                                 warmup_iter=0))
    crop = cfg.dataset.crop_size
    rng = np.random.default_rng(12)
    label = rng.integers(0, 21, (4, crop, crop)).astype(np.int64)
    label[:, :16] = 255
    params = weclip.init_trainable_params(torch.Generator().manual_seed(0), cfg)
    host = synthetic_train_batch(cfg, 4, seed=13)

    def state_on(device, b):
        frozen = weclip.random_frozen_state(cfg, seed=0, device=device)
        state = seg_step.create_seg_train_state(None, cfg, device, params=params)
        batch, _, _ = make_batcher(cfg, frozen, device)({k: v[:b] for k, v in host.items()})
        return frozen, state, batch, torch.from_numpy(label[:b]).to(device)

    frozen, state, batch, lab = state_on("cuda", 4)
    fn = seg_step.make_seg_train_step(cfg, precision.make_policy(cfg.precision.compute_dtype))
    before = [t.detach().clone() for t in step_mod.param_leaves(state.params)]
    kernels.reset_launches()
    losses = []
    for _ in range(2):
        state, m = fn(state, frozen, batch, lab, rng=3)
        losses.append(float(m.loss))
    torch.cuda.synchronize()
    launches = {"seg_step": dict(kernels.launches)}
    moved = sum(not torch.equal(a.detach(), b)
                for a, b in zip(step_mod.param_leaves(state.params), before))
    print(f"[seg-step] 2 steps at batch 4, crop {crop}: losses {losses}, accuracy "
          f"{float(m.acc):.4f}; parameters moved {moved} of {len(before)}; launches "
          f"{json.dumps(launches['seg_step'])}", flush=True)
    if not all(math.isfinite(x) for x in losses) or moved != len(before):
        raise AssertionError(f"seg_step: losses {losses}, {moved} of {len(before)} moved")
    del frozen, state, batch
    fp32 = {}
    fn = seg_step.make_seg_train_step(cfg, precision.FP32)
    for where, device in (("cpu", "cpu"), ("card", "cuda")):
        frozen, state, batch, lab = state_on(device, 1)
        _, m = fn(state, frozen, batch, lab)
        fp32[where] = float(m.loss)
        del frozen, state, batch
    diff = abs(fp32["card"] - fp32["cpu"])
    print(f"[seg-step] fp32 step at batch 1: loss card {fp32['card']:.7f}, CPU "
          f"{fp32['cpu']:.7f}, difference {diff:.3e} (tol 1e-4)", flush=True)
    if diff > 1e-4:
        raise AssertionError(f"fp32 seg_step loss differs by {diff}")
    torch.cuda.empty_cache()
    return launches, {"losses": losses, "fp32_loss_cpu": fp32["cpu"],
                      "fp32_loss_card": fp32["card"], "fp32_loss_diff": diff}


def run_comer_benchmark(steps: int = 30, lockstep: int = 4, repeat: int = 30):
    """The CoMer functional check (``weclip_tpu_torch/tools/comer_benchmark``)
    on the card: 1 seed, ``steps`` steps an arm, through its ``main``.  The
    wrappers of K6 and K3/K3-rect are watched on the way: the CoMer arm
    must launch K6 and K3-rect at Dh 128 (CTI at the tiny config: 256 / 2
    heads), and every such call on the card is held against its plain
    version on the same arguments (K6's output to 2e-5, each gradient to
    2e-5 of its largest), at the shapes this path gives them.  Then the
    CoMer arm's first ``lockstep`` steps (fuse dropout off, the same seeded
    weights) on the card and on the CPU: each step's loss within 1e-4
    (relative).  At init CTI's output projections are zero, so the first
    step's loss does not depend on K6 and K3-rect sees dO = 0; the third
    step's loss runs through K6, the fourth's through the K3-rect
    gradients of the steps before (tests/test_torch_comer_benchmark.py::
    test_cti_attention_enters_the_loss).  Last, the CoMer arm twice for
    ``repeat`` steps under the settings ``main`` chose: equal losses (under
    cuDNN's default convolution algorithms two runs part within a few dozen
    steps).
    Returns launches of the check and the measurements."""
    import collections

    import torch

    from weclip_tpu_torch import kernels
    from weclip_tpu_torch.ops import attention_kernels as ak
    from weclip_tpu_torch.tools import comer_benchmark as tool

    widths = collections.defaultdict(collections.Counter)
    held = collections.defaultdict(collections.Counter)
    worst = collections.defaultdict(float)   # (wrapper, Dh) -> err / tol
    plain_of = {"cross_attention_core": ak.cross_attention_core_plain,
                "attention_bwd": ak.attention_bwd_plain}
    wrapped = {}

    def plain_args(name, args, kw):
        """The plain version's arguments for a wrapper call, or None where
        the call asks for what the plain version does not take."""
        if name == "cross_attention_core":
            return None if kw else args
        kw = dict(kw)
        sd = kw.pop("score_dtype", args[5] if len(args) > 5 else None)
        if kw.get("stats") is not None or kw.get("q_scale", 1.0) != 1.0 or len(args) > 6:
            return None
        return (*args[:5], sd)

    def hold(name, dh, got, args):
        """The call's outputs against the plain version's, on the card."""
        with torch.no_grad():
            ref = plain_of[name](*args)
        if name == "cross_attention_core":
            pairs = [("out", got, ref, 2e-5)]
        else:
            pairs = [(g, a, r, 2e-5 * float(r.abs().max()))
                     for g, a, r in zip(("dq", "dk", "dv"), got, ref)]
        for what, a, r, tol in pairs:
            err = max_err(a, r)
            if err > tol:
                raise AssertionError(f"comer_benchmark: {name} at Dh {dh} {what} "
                                     f"{list(a.shape)}: max_abs_err {err:.3e} > {tol:.3e}")
            key = f"{name} Dh {dh}"
            worst[key] = max(worst[key], err / tol if tol > 0 else 0.0)
        held[name][dh] += 1

    def logged(name, fn):
        def call(*args, **kw):
            q = args[0]
            out = fn(*args, **kw)
            if q.is_cuda:
                dh = int(q.shape[-1])
                widths[name][dh] += 1
                p_args = plain_args(name, args, kw) if name in plain_of else None
                if p_args is not None:
                    hold(name, dh, out, p_args)
            return out
        return call

    for name in ("attention_core", "attention_bwd", "cross_attention_core"):
        wrapped[name] = getattr(ak, name)
        setattr(ak, name, logged(name, wrapped[name]))
    cudnn_deterministic = torch.backends.cudnn.deterministic
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = tool.main(["--steps", str(steps), "--seeds", "1", "--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"comer_benchmark": dict(kernels.launches)}
    finally:
        for name, fn in wrapped.items():
            setattr(ak, name, fn)
    by_width = {k: dict(v) for k, v in widths.items()}
    print(f"[comer-benchmark] {steps} steps an arm on the card: {json.dumps(out)}; "
          f"{seconds:.1f} s; launches {json.dumps(launches['comer_benchmark'])}; wrapper "
          f"calls by head width {json.dumps(by_width)}", flush=True)
    if not (by_width.get("cross_attention_core", {}).get(128)
            and by_width.get("attention_bwd", {}).get(128)
            and launches["comer_benchmark"]["cross_attention"]
            and launches["comer_benchmark"]["attention_bwd_rect"]):
        raise AssertionError("comer_benchmark: K6 and K3-rect did not run at Dh 128")
    for name in plain_of:
        if held[name][128] != widths[name][128]:
            raise AssertionError(f"comer_benchmark: {held[name][128]} of "
                                 f"{widths[name][128]} {name} calls at Dh 128 held")
    print(f"[comer-benchmark] every K6 and K3/K3-rect call on the card held against its "
          f"plain version: {json.dumps({k: dict(v) for k, v in held.items()})}; worst "
          f"error / tolerance {json.dumps(dict(worst))}", flush=True)
    for key in ("plain_miou", "comer_miou", "plain_final_loss", "comer_final_loss"):
        if not math.isfinite(out[key]):
            raise AssertionError(f"comer_benchmark: {key} {out[key]}")
    losses = {device: tool.run_arm(True, lockstep, 4, 0, 0, device=device, dropout=False)[1]
              for device in ("cuda", "cpu")}
    rel = [abs(c - h) / abs(h) for c, h in zip(losses["cuda"], losses["cpu"])]
    print(f"[comer-benchmark] CoMer arm's first {lockstep} steps, card / CPU loss: "
          + ", ".join(f"{c:.7f} / {h:.7f} ({r:.3e})"
                      for c, h, r in zip(losses["cuda"], losses["cpu"], rel))
          + " (tol 1e-4 relative)", flush=True)
    if max(rel) > 1e-4:
        raise AssertionError(f"comer_benchmark: card and CPU losses differ by {rel}")
    try:   # main's settings still hold
        runs = [tool.run_arm(True, repeat, 4, 0, 1, device="cuda")[1] for _ in range(2)]
    finally:
        torch.backends.cudnn.deterministic = cudnn_deterministic
    parted = [i + 1 for i, (a, b) in enumerate(zip(*runs)) if a != b]
    print(f"[comer-benchmark] CoMer arm, seed 1, run twice for {repeat} steps: "
          f"{'equal losses' if not parted else f'losses part at step {parted[0]}'}",
          flush=True)
    if parted:
        raise AssertionError(f"comer_benchmark: two runs part at step {parted[0]}")
    return launches, {**out, "seconds": seconds, "wrapper_calls_by_head_width": by_width,
                      "held_calls": {k: dict(v) for k, v in held.items()},
                      "held_worst_err_over_tol": dict(worst),
                      "lockstep_loss_card": losses["cuda"], "lockstep_loss_cpu": losses["cpu"],
                      "lockstep_rel_diff": rel}


# OpenAI's ViT-B/16 checkpoint: vision 768 wide, 12 layers, patch 16, 197
# positions; text 512 wide (8 heads), 12 layers, context 77, vocabulary
# 49408; joint embedding 512
VIT_B16 = dict(vision_width=768, vision_layers=12, patch=16, grid=14, text_width=512,
               text_layers=12, context=77, vocab=49408, embed=512)
# a synthetic merges file: a version line and a few merges
MERGES = ["#version: 0.2", "o r", "a n", "i n", "e r</w>", "t h", "c l", "cl e", "an </w>",
          "o ri", "g a", "s e", "p e", "r s", "o n</w>", "a i", "t r", "d o"]


def clip_state_dict(seed: int, vision_width: int, vision_layers: int, patch: int,
                    grid: int, text_width: int, text_layers: int, context: int,
                    vocab: int, embed: int):
    """A seeded random CLIP state dict in OpenAI's key layout and fp16 (as
    OpenAI ships it), drawn on the card and returned on the CPU."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sd = {}

    def normal(shape, std, mean=0.0):
        t = torch.randn(shape, generator=gen, device="cuda") * std + mean
        return t.half().cpu()

    def ln(prefix, w):
        sd[prefix + ".weight"] = normal((w,), 0.1, 1.0)
        sd[prefix + ".bias"] = normal((w,), 0.1)

    def blocks(prefix, w, layers):
        for i in range(layers):
            p = f"{prefix}.{i}."
            sd[p + "attn.in_proj_weight"] = normal((3 * w, w), w ** -0.5)
            sd[p + "attn.in_proj_bias"] = normal((3 * w,), 0.02)
            sd[p + "attn.out_proj.weight"] = normal((w, w), w ** -0.5)
            sd[p + "attn.out_proj.bias"] = normal((w,), 0.02)
            sd[p + "mlp.c_fc.weight"] = normal((4 * w, w), w ** -0.5)
            sd[p + "mlp.c_fc.bias"] = normal((4 * w,), 0.02)
            sd[p + "mlp.c_proj.weight"] = normal((w, 4 * w), (4 * w) ** -0.5)
            sd[p + "mlp.c_proj.bias"] = normal((w,), 0.02)
            ln(p + "ln_1", w)
            ln(p + "ln_2", w)

    vw, tw = vision_width, text_width
    sd["visual.class_embedding"] = normal((vw,), vw ** -0.5)
    sd["visual.positional_embedding"] = normal((grid * grid + 1, vw), vw ** -0.5)
    sd["visual.proj"] = normal((vw, embed), vw ** -0.5)
    sd["visual.conv1.weight"] = normal((vw, 3, patch, patch), (3 * patch * patch) ** -0.5)
    ln("visual.ln_pre", vw)
    blocks("visual.transformer.resblocks", vw, vision_layers)
    ln("visual.ln_post", vw)
    sd["positional_embedding"] = normal((context, tw), 0.01)
    sd["text_projection"] = normal((tw, embed), tw ** -0.5)
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07)).half()
    sd["token_embedding.weight"] = normal((vocab, tw), 0.02)
    blocks("transformer.resblocks", tw, text_layers)
    ln("ln_final", tw)
    return sd


def run_clip_checkpoint(work: str, card: str):
    """Phase 12: a seeded random ViT-B/16 checkpoint in OpenAI's layout
    (fp16) and a synthetic merges file written to ``work``; ``load_clip``
    infers ``Config().clip``'s widths; ``build_frozen`` on the card and on
    the CPU, fp32 text features within 1e-4.  Returns the launches of the
    card's ``build_frozen`` (the text encoder runs the plain attention) and
    the measurements; sets ``WECLIP_BPE_PATH``."""
    import dataclasses
    import gzip

    import torch

    from weclip_tpu_torch import kernels
    from weclip_tpu_torch.core.config import Config
    from weclip_tpu_torch.models.clip import loader, prompts
    from weclip_tpu_torch.models.clip.tokenizer import Tokenizer
    from weclip_tpu_torch.train.trainer import build_frozen

    path = os.path.join(work, "ViT-B-16.pt")
    sd = clip_state_dict(0, **VIT_B16)
    torch.save(sd, path)
    n_params = sum(t.numel() for t in sd.values())
    del sd
    bpe = os.path.join(work, "bpe_vocab.txt.gz")
    with gzip.open(bpe, "wt") as f:
        f.write("\n".join(MERGES) + "\n")
    os.environ["WECLIP_BPE_PATH"] = bpe

    t0 = time.perf_counter()
    params, clip_cfg = loader.load_clip(path, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    want = Config().clip
    widths = ("vision_width", "vision_layers", "vision_heads", "patch_size", "embed_dim",
              "context_length", "vocab_size", "transformer_width", "transformer_heads",
              "transformer_layers")
    got = {k: getattr(clip_cfg, k) for k in widths}
    if got != {k: getattr(want, k) for k in widths}:
        raise AssertionError(f"infer_config gave {got}")
    t0 = time.perf_counter()
    prompts.build_text_features("voc", params["text"], clip_cfg, Tokenizer())
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    del params
    cfg = dataclasses.replace(Config(), clip=dataclasses.replace(Config().clip,
                                                                  pretrained_path=path))
    kernels.reset_launches()
    t0 = time.perf_counter()
    frozen_card, _, _ = build_frozen(cfg, device="cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = {"build_frozen": dict(kernels.launches)}
    t0 = time.perf_counter()
    frozen_cpu, _, _ = build_frozen(cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    errs = {k: max_err(frozen_card[k].cpu(), frozen_cpu[k]) for k in ("fg_text", "bg_text")}
    shapes = {k: tuple(frozen_card[k].shape) for k in ("fg_text", "bg_text")}
    size = os.path.getsize(path)
    print(f"[clip] checkpoint {n_params / 1e6:.2f} M parameters, {size / 1e6:.1f} MB fp16; "
          f"load_clip to the card {load_s:.2f} s, 45 VOC prompts encoded (fp32) "
          f"{encode_ms:.1f} ms; build_frozen card {card_s:.2f} s, CPU {cpu_s:.2f} s; text "
          f"features {shapes} card vs CPU max err {errs} (tol 1e-4); on {card}", flush=True)
    if shapes != {"fg_text": (20, 512), "bg_text": (25, 512)} or max(errs.values()) > 1e-4:
        raise AssertionError(f"text features: {shapes}, {errs}")
    del frozen_card, frozen_cpu
    torch.cuda.empty_cache()
    return path, launches, {"parameters": n_params, "file_bytes": size, "load_s": load_s,
                            "encode_ms": encode_ms, "build_frozen_card_s": card_s,
                            "build_frozen_cpu_s": cpu_s, "text_max_err": errs}


@contextlib.contextmanager
def cli_logging():
    """Removes the root-logger handlers a command-line ``main()`` adds, and
    its level, when the block ends."""
    import logging
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    try:
        yield
    finally:
        for h in root.handlers[:]:
            if h not in handlers:
                root.removeHandler(h)
                h.close()
        root.setLevel(level)


def write_voc_tree(work: str, examples, ckpt: str) -> str:
    """A VOC tree whose 8 images and labels sit only in the decoded cache
    (``.npy``, no JPEG to decode), its ``val`` list and image-level labels,
    and a config naming it and the CLIP checkpoint; returns the config's
    path."""
    root = os.path.join(work, "voc")
    cache = os.path.join(root, "decoded")
    lists = os.path.join(root, "lists")
    os.makedirs(cache)
    os.makedirs(lists)
    onehot = {}
    for ex in examples:
        np.save(os.path.join(cache, ex["name"] + ".npy"), ex["img_raw"])
        np.save(os.path.join(cache, ex["name"] + "_lab.npy"), ex["label"].astype(np.uint8))
        onehot[ex["name"]] = ex["present_mask"].astype(np.float32)
    np.save(os.path.join(lists, "cls_labels_onehot.npy"), onehot)
    with open(os.path.join(lists, "val.txt"), "w") as f:
        f.write("\n".join(ex["name"] for ex in examples))
    cfg = {"dataset": {"name": "voc", "root_dir": root, "name_list_dir": lists,
                       "num_classes": 21, "decoded_cache_dir": cache},
           "clip": {"pretrained_path": ckpt, "embedding_dim": 256},
           "work_dir": {"dir": os.path.join(work, "work")}}
    path = os.path.join(work, "voc_cli.yaml")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def run_eval_cli(work: str, ckpt: str, model_path: str, card: str):
    """Phase 13: ``python -m weclip_tpu_torch.cli.eval_voc`` through its
    ``main()``, on the card: the config of ``write_voc_tree`` (8 labelled
    VOC-size images, decoded cache only, ``clip.pretrained_path`` the phase
    12 checkpoint), ``--model_path`` phase 8's checkpoint, ``--save_preds
    --save_logits``.  Finite scores, histogram totals equal to the labelled
    pixels, K1-K5 launched, histograms equal to an ``Evaluator.run`` called
    directly on the same examples and weights, one PNG and one logit file
    an image; warm images/s.  Returns the launches of one CLI call, the
    config's path and the measurements."""
    import torch

    from weclip_tpu_torch import kernels
    from weclip_tpu_torch.cli import eval_voc
    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.core.config import load_config
    from weclip_tpu_torch.evalx.runner import Evaluator, make_prep
    from weclip_tpu_torch.train import checkpoint
    from weclip_tpu_torch.train.trainer import build_frozen

    examples = labelled_voc_examples(8, seed=14)
    cfg_path = write_voc_tree(work, examples, ckpt)
    n_gt = sum(int(((ex["label"] >= 0) & (ex["label"] < 21)).sum()) for ex in examples)
    out = os.path.join(work, "eval_out")
    argv = ["--config", cfg_path, "--model_path", model_path, "--save_preds", "--save_logits",
            "--work_dir", out, "--device", "cuda"]
    runs = []
    orig_run = Evaluator.run

    def run(self, *args, **kw):
        t0 = time.perf_counter()
        res = orig_run(self, *args, **dict(kw, return_hists=True))
        torch.cuda.synchronize()
        runs.append((res, time.perf_counter() - t0))
        return res

    Evaluator.run = run
    try:
        with cli_logging():
            kernels.reset_launches()
            t0 = time.perf_counter()
            scores = eval_voc.main(argv)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            launches = {"eval_voc_cli": dict(kernels.launches)}
            t0 = time.perf_counter()
            eval_voc.main(argv)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
    finally:
        Evaluator.run = orig_run
    hists = runs[-1][0]["hists"]
    run_s = runs[-1][1]
    totals = {k: int(h.sum()) for k, h in hists.items()}
    finite = all(math.isfinite(float(scores[k][m])) for k in ("seg", "msc_seg", "cam")
                 for m in ("pAcc", "miou"))
    missing = [k for k in ("attention_fwd_export", "attention_fwd", "attention_bwd",
                           "par_affinity", "par_propagate")
               if not launches["eval_voc_cli"][k]]
    saved = [len(os.listdir(os.path.join(out, d))) for d in ("prediction", "prediction_cmap",
                                                              "logit")]

    cfg = load_config(cfg_path)
    frozen, _, cfg = build_frozen(cfg, device="cuda")
    params = checkpoint.restore(model_path, device="cuda")[0]
    prep = make_prep(cfg, max_ori=512, resize_long=512)
    ev = Evaluator(cfg, prep, frozen["visual"]["positional_embedding"].float().cpu().numpy(),
                   policy=precision.make_policy(cfg.precision.compute_dtype), device="cuda")
    direct = ev.run(params, frozen, examples, return_hists=True)["hists"]
    equal = all(np.array_equal(direct[k], hists[k]) for k in ("seg", "msc_seg", "cam"))
    t0 = time.perf_counter()
    ev.run(params, frozen, examples)
    torch.cuda.synchronize()
    unsaved_s = time.perf_counter() - t0
    res = {"first_call_s": first_s, "warm_call_s": warm_s, "evaluator_run_ms": run_s * 1e3,
           "images_per_s": 8 / run_s, "cli_images_per_s": 8 / warm_s,
           "direct_run_without_saving_ms": unsaved_s * 1e3,
           "miou": {k: float(scores[k]["miou"]) for k in ("seg", "msc_seg", "cam")},
           "hist_totals": totals, "labelled_pixels": n_gt,
           "equal_to_direct_run": equal, "saved_files": saved}
    print(f"[eval-cli] eval_voc main() over 8 cached VOC-size images: first call "
          f"{first_s:.2f} s, warm call {warm_s:.2f} s ({8 / warm_s:.2f} images/s with "
          f"checkpoint loading), its Evaluator.run {run_s * 1e3:.1f} ms ({8 / run_s:.2f} "
          f"images/s; a direct warm run without saving {unsaved_s * 1e3:.1f} ms); mIoU "
          f"{json.dumps(res['miou'])}; histogram totals {totals} (labelled "
          f"{n_gt}); equal to a direct Evaluator.run: {equal}; files {saved}; launches "
          f"{json.dumps(launches['eval_voc_cli'])}; on {card}", flush=True)
    if (not finite or missing or any(t != n_gt for t in totals.values()) or not equal
            or saved != [8, 8, 8]):
        raise AssertionError(f"eval CLI: finite {finite}, not launched {missing}, totals "
                             f"{totals}, equal {equal}, files {saved}")
    del frozen, params, ev
    torch.cuda.empty_cache()
    return launches, cfg_path, res


CAM_METHODS = ("grad_cam", "grad_cam_pp", "xgrad_cam", "layer_cam", "eigen_cam",
               "eigen_grad_cam", "score_cam", "ablation_cam")


def run_cam_surface(cfg_path: str, work: str, card: str):
    """Phase 14: ``WeCLIPPipeline.cam`` by each of the 8 methods on one
    VOC-size image on the card (the phase 12 checkpoint): maps (20, H, W),
    finite, in [0, 1], K1 launched and K3 for the gradient methods (the
    perturbation methods at all 768 channels).  Then one image in fp32, card
    against CPU, on the same block-11 tokens (3 classes; ``score_cam`` and
    ``ablation_cam`` at ``top_channels=16``): every method's maps before the
    ReLU within 1e-3 of each map's largest magnitude (the eigen pair up to
    sign), and the finished maps of ``cam_single`` within 1e-3 (all but the
    eigen pair).  Then ``generate_cams`` over the 8
    cached images.  Returns launches per call and the measurements."""
    import torch

    from weclip_tpu_torch import kernels
    from weclip_tpu_torch.api import WeCLIPPipeline
    from weclip_tpu_torch.cam import variants
    from weclip_tpu_torch.cli import generate_cams
    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.core.config import load_config
    from weclip_tpu_torch.evalx.engine import prepare_scale1_images
    from weclip_tpu_torch.models import weclip
    from weclip_tpu_torch.models.clip import vit

    cfg = load_config(cfg_path)
    im = voc_images(1, seed=15)[0][0]
    pipe = WeCLIPPipeline(cfg, device="cuda")
    launches, times = {}, {}
    for method in CAM_METHODS:
        kernels.reset_launches()
        t0 = time.perf_counter()
        maps = pipe.cam(im, method=method)
        torch.cuda.synchronize()
        times[method] = (time.perf_counter() - t0) * 1e3
        launches[f"cam_{method}"] = dict(kernels.launches)
        ok = (maps.shape == (20,) + im.shape[:2] and np.isfinite(maps).all()
              and maps.min() >= 0.0 and maps.max() <= 1.0 + 1e-6)
        need = ["attention_fwd_export"] + (["attention_bwd"]
                                           if method in variants.GRADIENT_METHODS else [])
        missing = [k for k in need if not kernels.launches[k]]
        if not ok or missing:
            raise AssertionError(f"cam {method}: shape {maps.shape}, range "
                                 f"[{maps.min()}, {maps.max()}], not launched {missing}")
    warm = {}
    for method in ("grad_cam", "score_cam"):
        t0 = time.perf_counter()
        pipe.cam(im, method=method)
        torch.cuda.synchronize()
        warm[method] = (time.perf_counter() - t0) * 1e3
    print(f"[cam] WeCLIPPipeline.cam (20 classes, {im.shape[:2]}) first-call ms "
          f"{json.dumps({k: round(v, 1) for k, v in times.items()})}, warm grad_cam "
          f"{warm['grad_cam']:.1f} ms, score_cam (768 channels) {warm['score_cam']:.1f} ms; "
          f"launches {json.dumps({k: launches[f'cam_{k}'] for k in ('grad_cam', 'score_cam')})}"
          f"; on {card}", flush=True)

    # fp32, card against CPU, on the same block-11 tokens of one image
    ev = pipe._evaluator(max(im.shape[:2]), with_cam=True, msc=False)
    sb, _, sizes, _, presents, _, _ = ev.build_batch([pipe._example(im)])
    imgs = prepare_scale1_images(sb.img, sizes, cfg, ev.prep.canvas_in1)
    x11 = vit.vision_forward_frozen(pipe.frozen["visual"], imgs, sb.pos_emb, sb.valid,
                                    pipe.cfg.clip, policy=precision.FP32).layer_tokens[-1][0]
    text = torch.cat([pipe.frozen["fg_text"], pipe.frozen["bg_text"]])
    tmask = torch.ones(text.shape[0], dtype=torch.bool, device="cuda")
    ci = torch.tensor([2, 8, 14], device="cuda")
    frozen_cpu = weclip.tree_to(pipe.frozen, "cpu")
    errs, raw_errs, positive = {}, {}, {}
    for method in CAM_METHODS:
        got = {}
        top = 16 if method in ("score_cam", "ablation_cam") else None
        for dev, fz in (("cuda", pipe.frozen), ("cpu", frozen_cpu)):
            args = (fz["visual"], fz["logit_scale"], x11.to(dev), text.to(dev),
                    tmask.to(dev), sb.valid[0].to(dev), ci.to(dev), pipe.cfg.clip,
                    precision.FP32)
            raw = variants.raw_maps(method, *args, top_channels=top)
            got[dev] = (raw.cpu(), variants.cam_single(method, *args, top_channels=top).cpu())
        (a, fa), (b, fb) = got["cuda"], got["cpu"]
        positive[method] = float((fb > 0).float().mean())
        # the raw maps against each map's largest magnitude: the eigen pair's
        # up to the singular vector's sign, which LAPACK and cuSOLVER pick
        # apart; their finished maps then differ, and are not compared
        sign = (torch.sign((a * b).sum(dim=1, keepdim=True)) if method.startswith("eigen")
                else torch.ones(()))
        scale = b.abs().amax(dim=1)
        if not bool((scale > 0).all()):
            raise AssertionError(f"{method}: a raw CPU map is identically zero")
        raw_errs[method] = float(((sign * a - b).abs().amax(dim=1) / scale).max())
        if not method.startswith("eigen"):
            errs[method] = max_err(fa, fb)
    print(f"[cam] fp32 card vs CPU through cam_single, classes {ci.tolist()}, perturbation "
          f"pair at top_channels=16 (tol 1e-3): maps before ReLU and min-max, max err / "
          f"each map's largest {json.dumps({k: float(f'{v:.3e}') for k, v in raw_errs.items()})}"
          f" (eigen pair up to sign); finished maps max err "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}; share of positive "
          f"values in the CPU's finished maps "
          f"{json.dumps({k: round(v, 4) for k, v in positive.items()})}", flush=True)
    if max(list(errs.values()) + list(raw_errs.values())) > 1e-3:
        raise AssertionError(f"CAM methods: card and CPU differ: {raw_errs}, {errs}")
    del pipe, frozen_cpu
    torch.cuda.empty_cache()

    out = os.path.join(work, "cams")
    kernels.reset_launches()
    t0 = time.perf_counter()
    with cli_logging():
        generate_cams.main(["--config", cfg_path, "--split", "val", "--out", out,
                            "--device", "cuda"])
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches["generate_cams"] = dict(kernels.launches)
    examples = labelled_voc_examples(8, seed=14)
    for ex in examples:
        d = np.load(os.path.join(out, ex["name"] + ".npy"), allow_pickle=True).item()
        keys = np.where(ex["present_mask"])[0]
        hi = d["attn_highres"]
        if (not np.array_equal(d["keys"], keys) or hi.dtype != np.float16
                or hi.shape != (len(keys),) + ex["label"].shape
                or not np.isfinite(hi.astype(np.float32)).all()):
            raise AssertionError(f"generate_cams {ex['name']}: keys {d['keys']} vs {keys}, "
                                 f"{hi.dtype} {hi.shape}")
    if len(os.listdir(out)) != len(examples):
        raise AssertionError(f"generate_cams wrote {sorted(os.listdir(out))}")
    print(f"[cam] generate_cams over 8 cached images: {gen_s:.2f} s (first call, with "
          f"checkpoint loading); one fp16 npy an image, keys the present classes; launches "
          f"{json.dumps(launches['generate_cams'])}; on {card}", flush=True)
    return launches, {"first_call_ms": times, "warm_ms": warm, "fp32_card_vs_cpu": errs,
                      "fp32_raw_card_vs_cpu": raw_errs, "fp32_positive_share": positive,
                      "generate_cams_s": gen_s}


# K7's path shapes: (B, C, hs, ws, r, what).  COCO evaluation at stride 4
# (canvas 640, 81 classes) is the windowed path Evaluator.run takes; the
# 21-channel VOC canvas at stride 4 (512) is held too.
K7_SHAPES = ((8, 81, 160, 160, 32, "COCO canvas 640, stride 4"),
             (8, 21, 128, 128, 32, "VOC canvas 512, stride 4"))


def k7_bound(b: int, c: int, hs: int, ws: int, r: int):
    """K7's least time: each input read once and each output written once;
    per in-bound (pixel, offset) pair of this grid, 2 C flops of the message
    and 12 of the weight (3 differences, 3 squares, 2 sums, the distance,
    its sum, the scale and the exponential).  Returns the bound of the
    kernel as it runs (the message's flops at the split-TF32 rate, the
    weight's on the CUDA cores, the larger of those and the bytes' time),
    the bound of the kernel's earlier FMA form (every flop at fp32's 67
    TFLOP/s), each as (ms, what bounds it), and the pairs."""
    def along(n):
        return sum(min(r, n - 1 - y) - max(-r, -y) + 1 for y in range(n))
    pairs = b * along(hs) * along(ws)
    n_bytes = 4 * (2 * b * c * hs * ws + 3 * b * hs * ws + b * hs * ws)
    tc_bound = max(bound_ms(n_bytes, pairs * 2 * c, "tf32x3"),
                   bound_ms(n_bytes, pairs * 12, "fp32"))
    return tc_bound, bound_ms(n_bytes, pairs * (2 * c + 12), "fp32"), pairs


def check_crf_kernel(records, reps: int = 5):
    """K7 against its plain twin on the card at ``K7_SHAPES`` (the message
    and the normalizer, each within 1e-5 of its largest value), timed (the
    message, and the normalizer alone) beside the twin and both bounds
    (``k7_bound``), with each launch's geometry and the kernels' registers;
    appends K7's record."""
    import torch

    from weclip_tpu_torch.refine import crf_kernels as ck

    sig = 64.0 / 4                       # bi_xy_std / stride
    checks, times, shapes = [], {}, []
    for b, c, hs, ws, r, what in K7_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(7)
        q = torch.rand((b, c, hs, ws), generator=g, device="cuda")
        q = q / q.sum(dim=1, keepdim=True)
        img = torch.rand((b, 3, hs, ws), generator=g, device="cuda") * (255.0 / 5.0)
        acc, norm = ck.window_message(q, img, sig, r)
        _, norm_only = ck.window_message(None, img, sig, r)
        # the twin takes seconds a call: its time is that of this one call
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ref_acc, ref_norm = ck.window_message_plain(q, img, sig, r)
        end.record()
        torch.cuda.synchronize()
        plain = start.elapsed_time(end)
        for name, got, ref in (("message", acc, ref_acc), ("normalizer", norm, ref_norm),
                               ("normalizer alone", norm_only, ref_norm)):
            checks.append((f"{name} {[b, c, hs, ws]} r {r}", max_err(got, ref),
                           1e-5 * float(ref.abs().max())))
        ms = cuda_ms(lambda: ck.window_message(q, img, sig, r), reps)
        norm_ms = cuda_ms(lambda: ck.window_message(None, img, sig, r), reps)
        bound, fma_bound, pairs = k7_bound(b, c, hs, ws, r)
        geometry = {"message": ck.window_geometry(c, hs, ws, r),
                    "normalizer": ck.window_geometry(0, hs, ws, r)}
        times[what] = {"shape": [b, c, hs, ws], "r": r, "ms": ms, "normalizer_ms": norm_ms,
                       "plain_ms": plain, "bound_ms": bound[0], "bound_by": bound[1],
                       "fma_bound_ms": fma_bound[0], "pairs": pairs, "geometry": geometry}
        shapes.append([b, c, hs, ws])
        print(f"[kernel] crf_window {what} {[b, c, hs, ws]} r {r}: {ms:.4f} ms (normalizer "
              f"alone {norm_ms:.4f} ms), plain {plain:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]}; split-TF32 message, weights on the CUDA cores), FMA bound "
              f"{fma_bound[0]:.4f} ms, {pairs} in-bound pixel-offsets; launch geometry "
              f"{json.dumps(geometry)}", flush=True)
        del q, img, acc, norm, norm_only, ref_acc, ref_norm
    main = times[K7_SHAPES[0][5]]
    record_kernel(records, "crf_window", "weclip_tpu_torch/csrc/crf.cu",
                  "weclip_tpu/refine/crf.py:218 (mean_field_crf_jax windowed bilateral, "
                  "an XLA fori_loop; no pallas_call)",
                  checks, main["ms"], main["plain_ms"], (main["bound_ms"], main["bound_by"]),
                  None, shapes, timed_shape=K7_SHAPES[0][5], ms_by_shape=times,
                  fma_bound_ms=main["fma_bound_ms"], resources=kernel_resources("crf"))
    torch.cuda.empty_cache()
    return times


# the frozen block's passes at vitl14-eval's scale-1 shape: 16 rows (8
# images and their flips) of 1370 tokens at width 1024, 16 heads
EPILOGUE_SHAPE = (16, 1370, 1024, 16)


def check_block_epilogue(records, reps: int = 20):
    """The frozen block's fused passes (``ops/block_epilogue.py``) against
    their plain twins at ``EPILOGUE_SHAPE``: bias adds, residual and head
    split bit-equal, the LayerNorm and QuickGELU outputs within one bf16
    spacing of each element beyond the fp32 arithmetic's own spread; each
    timed beside its twin (the unfused torch
    sequence), a PyTorch call computing part of it where one does
    (``F.layer_norm`` on the residual sum for ``residual_ln``) and its bytes
    at the HBM rate; appends their records."""
    import torch
    import torch.nn.functional as F

    from weclip_tpu_torch.ops import block_epilogue as epi

    b, l, d, h = EPILOGUE_SHAPE
    rows = b * l
    gen = torch.Generator(device="cuda").manual_seed(18)
    bf = torch.bfloat16

    def randn(shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    def one_rounding(what, got, want):
        """(what, the largest gap in bf16 spacings at each element, 1): the
        fp32 arithmetic's own spread (2^-20 of the largest value, the
        statistics summed in another order) taken off the gap first."""
        a, r = got.float(), want.float()
        m = torch.maximum(a.abs(), r.abs()).clamp_min(2.0 ** -126)
        gap = ((a - r).abs() - 2.0 ** -20 * r.abs().max()).clamp_min(0.0)
        excess = (gap / torch.exp2(torch.floor(torch.log2(m)) - 7)).max()
        return (f"{what} (bf16 spacings)", float(excess), 1.0)

    source = "weclip_tpu_torch/csrc/block_epilogue.cu"
    replaces = ("none (no TPU kernel: XLA fuses the frozen block's elementwise work "
                "into its products, weclip_tpu/models/clip/vit.py::block_forward)")
    shapes = [list(EPILOGUE_SHAPE)]
    g3, in_b = randn((b, l, 3 * d)), randn((3 * d,), 0.5)
    got, want = epi.qkv_bias_split(g3, in_b, h), epi.qkv_bias_split_plain(g3, in_b, h)
    checks = [(f"{n} exact", max_err(x, y), 0.0) for n, x, y in zip("qkv", got, want)]
    record_kernel(records, "qkv_bias_split", source, replaces, checks,
                  cuda_ms(lambda: epi.qkv_bias_split(g3, in_b, h), reps),
                  cuda_ms(lambda: epi.qkv_bias_split_plain(g3, in_b, h), reps),
                  bound_ms(2 * rows * 3 * d * 2, 0.0, "bf16"), None, shapes)
    del g3, got, want

    x, g = randn((b, l, d)), randn((b, l, d))
    bias = randn((d,), 0.5)
    ln = (1.0 + randn((d,), 0.1, torch.float32), randn((d,), 0.1, torch.float32))
    valid = torch.zeros((b, l), dtype=torch.bool, device="cuda")
    for i in range(b):
        valid[i, :l - 37 * (i % 4)] = True
    ln16 = (ln[0].to(bf), ln[1].to(bf))
    y, lo = epi.residual_ln(g, ln, x=x, bias=bias, rowmask=valid)
    want_y, want_lo = epi.residual_ln_plain(g, ln, x=x, bias=bias, rowmask=valid)
    checks = [("y exact", max_err(y, want_y), 0.0), one_rounding("ln", lo, want_lo)]
    record_kernel(records, "residual_ln", source, replaces, checks,
                  cuda_ms(lambda: epi.residual_ln(g, ln, x=x, bias=bias, rowmask=valid), reps),
                  cuda_ms(lambda: epi.residual_ln_plain(g, ln, x=x, bias=bias,
                                                        rowmask=valid), reps),
                  bound_ms(4 * rows * d * 2 + rows, 0.0, "bf16"),
                  cuda_ms(lambda: F.layer_norm(y, (d,), ln16[0], ln16[1]), reps), shapes,
                  library_call="F.layer_norm on the bf16 sum alone, bf16 gain and bias")
    del x, g, y, lo, want_y, want_lo

    g4, fc_b = randn((b, l, 4 * d), 3.0), randn((4 * d,), 0.5)
    want = epi.bias_quick_gelu_plain(g4.clone(), fc_b)
    checks = [one_rounding("out", epi.bias_quick_gelu(g4.clone(), fc_b), want)]
    record_kernel(records, "bias_quick_gelu", source, replaces, checks,
                  cuda_ms(lambda: epi.bias_quick_gelu(g4, fc_b), reps),
                  cuda_ms(lambda: epi.bias_quick_gelu_plain(g4, fc_b), reps),
                  bound_ms(2 * rows * 4 * d * 2, 0.0, "bf16"), None, shapes,
                  resources=kernel_resources("block_epilogue"))
    del g4, want
    torch.cuda.empty_cache()


def crf_inputs(c: int, size: int, seed: int):
    """(probs (C, S, S), image (3, S, S) float 0..255) on the host: a
    VOC-like image of a few rectangles and noise, and the softmax of noisy
    logits that favour each rectangle's class."""
    rng = np.random.default_rng(seed)
    img = np.full((size, size, 3), 90.0)
    logits = rng.normal(0.0, 1.0, (c, size, size))
    for _ in range(4):
        y0, x0 = rng.integers(0, size // 2, 2)
        k = int(rng.integers(1, c))
        img[y0:y0 + size // 3, x0:x0 + size // 3] = rng.integers(0, 256, 3)
        logits[k, y0:y0 + size // 3, x0:x0 + size // 3] += 1.5
    img = np.clip(img + rng.normal(0.0, 12.0, img.shape), 0, 255)
    p = np.exp(logits - logits.max(0))
    return ((p / p.sum(0)).astype(np.float32),
            img.transpose(2, 0, 1).astype(np.float32))


def compare_mean_field(what, probs, img, cfg, stride, dense_max, reference):
    """``mean_field_crf`` on the card against ``reference(probs, img)``:
    probabilities within 1e-4, argmax agreement at least 0.999; returns the
    card's time and the readings."""
    import torch

    from weclip_tpu_torch.refine.crf import mean_field_crf

    p, im = torch.from_numpy(probs).cuda(), torch.from_numpy(img).cuda()
    run = lambda: mean_field_crf(p, im, cfg, bi_stride=stride, dense_max_points=dense_max)
    got = run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref = reference(probs, img).float().cpu()
    ref_s = time.perf_counter() - t0
    got = got.cpu()
    err = max_err(got, ref)
    agree = float((got.argmax(0) == ref.argmax(0)).float().mean())
    moved = float((ref.argmax(0) != torch.from_numpy(probs).argmax(0)).float().mean())
    print(f"[crf] mean_field_crf {what} {list(probs.shape)} stride {stride}: card "
          f"{ms:.1f} ms, reference {ref_s:.1f} s; max |dp| {err:.3e} (tol 1e-4), argmax "
          f"agreement {agree:.6f} (need >= 0.999); the CRF moved {moved:.4f} of the "
          f"unary argmax", flush=True)
    if not err <= 1e-4 or agree < 0.999:
        raise AssertionError(f"mean_field_crf {what}: {err}, {agree}")
    return {"card_ms": ms, "reference_s": ref_s, "max_abs_err": err, "argmax_agreement": agree,
            "moved_share": moved}


def coco_examples(n: int, seed: int):
    """``n`` synthetic labelled COCO-size examples (up to 640 a side, 81
    classes) for ``Evaluator.run``."""
    rng = np.random.default_rng(seed)
    sizes = [(480, 640), (640, 427), (427, 640), (640, 640)]
    out = []
    for i in range(n):
        oh, ow = sizes[i % len(sizes)]
        label = np.zeros((oh, ow), np.int32)
        for _ in range(3):
            y0, x0 = int(rng.integers(0, oh // 2)), int(rng.integers(0, ow // 2))
            label[y0:y0 + oh // 3, x0:x0 + ow // 3] = int(rng.integers(1, 81))
        label[-8:] = 255
        ids = np.unique(label)
        present = np.zeros(80, bool)
        present[ids[(ids > 0) & (ids < 81)] - 1] = True
        out.append({"name": f"coco{i}", "label": label, "present_mask": present,
                    "img_raw": rng.integers(0, 256, (oh, ow, 3)).astype(np.uint8)})
    return out


def run_crf(records, card: str):
    """Phase 15: the dense CRF.  K7 against its twin (``check_crf_kernel``);
    ``mean_field_crf`` on the card against the CPU in fp32, dense at
    (21, 512, 512) stride 4 and windowed at (81, 640, 640) stride 16 (the
    CPU's window sum at stride 4 would take minutes); ``Evaluator.run(crf=
    True)`` on VOC-size images with ``crf_impl`` native (2 images: the
    lattice takes seconds an image on the host) and jax (8), and on 8
    COCO-size images with jax (the windowed path: K7), every ``crf_seg``
    histogram totalling the labelled pixels.  Returns launches per call and
    the measurements."""
    import torch

    from weclip_tpu_torch import kernels
    from weclip_tpu_torch.core.config import Config, CrfConfig, coco_config
    from weclip_tpu_torch.evalx.runner import Evaluator, make_prep
    from weclip_tpu_torch.models import weclip
    from weclip_tpu_torch.refine import crf as crf_mod

    k7_times = check_crf_kernel(records)
    crf_cfg = CrfConfig()
    out = {}
    on_cpu = lambda s, d: (lambda p, im: crf_mod.mean_field_crf(
        torch.from_numpy(p), torch.from_numpy(im), crf_cfg, bi_stride=s, dense_max_points=d))
    probs, img = crf_inputs(21, 512, seed=21)
    out["dense_21x512_stride4"] = compare_mean_field(
        "dense", probs, img, crf_cfg, 4, 16384, on_cpu(4, 16384))
    probs, img = crf_inputs(81, 640, seed=81)
    out["windowed_81x640_stride16"] = compare_mean_field(
        "windowed", probs, img, crf_cfg, 16, 0, on_cpu(16, 0))

    # the spatial term: the separable convolution the port runs, against the
    # band-matrix product the JAX package runs, at (81, 640, 640)
    x = torch.from_numpy(probs).cuda()
    r_pos = max(int(round(3 * crf_cfg.pos_xy_std)), 1)
    idx = torch.arange(640, dtype=torch.float32, device="cuda")
    d = idx[:, None] - idx[None, :]
    band = torch.where(d.abs() <= r_pos, torch.exp(-0.5 * (d / crf_cfg.pos_xy_std) ** 2),
                       torch.zeros((), device="cuda"))
    band_fn = lambda: torch.matmul(torch.matmul(band, x), band.t())
    out["spatial_term_81x640"] = {
        "conv_ms": cuda_ms(lambda: crf_mod._sep_gauss(x, crf_cfg.pos_xy_std, r_pos), 5),
        "band_product_ms": cuda_ms(band_fn, 5),
        "max_abs_diff": max_err(crf_mod._sep_gauss(x, crf_cfg.pos_xy_std, r_pos), band_fn())}
    print(f"[crf] spatial term (81, 640, 640): separable {2 * r_pos + 1}-tap convolution "
          f"{out['spatial_term_81x640']['conv_ms']:.3f} ms, band-matrix product "
          f"{out['spatial_term_81x640']['band_product_ms']:.3f} ms, max |diff| "
          f"{out['spatial_term_81x640']['max_abs_diff']:.3e}; on {card}", flush=True)
    del x, band, d, idx

    launches = {}
    voc = labelled_voc_examples(8, seed=11)
    coco = coco_examples(8, seed=12)
    for name, cfg, examples, max_ori, impl in (
            ("evaluator_crf_native", Config(), voc[:2], 512, "native"),
            ("evaluator_crf_jax", Config(), voc, 512, "jax"),
            ("evaluator_crf_jax_coco", coco_config(), coco, 640, "jax")):
        k = cfg.dataset.num_classes
        params = weclip.init_trainable_params(torch.Generator().manual_seed(0), cfg, "cuda")
        frozen = weclip.random_frozen_state(cfg, seed=0, device="cuda")
        ev = Evaluator(cfg, make_prep(cfg, max_ori=max_ori, resize_long=cfg.eval.resize_long),
                       frozen["visual"]["positional_embedding"].cpu().numpy(),
                       with_cam=name != "evaluator_crf_jax_coco", device="cuda")
        if impl == "jax":                # warm: the device programs' first calls
            ev.run(params, frozen, examples[:1], crf=True, crf_impl=impl)
            torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = ev.run(params, frozen, examples, crf=True, crf_impl=impl, return_hists=True)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches[name] = dict(kernels.launches)
        n_gt = sum(int(((ex["label"] >= 0) & (ex["label"] < k)).sum()) for ex in examples)
        totals = {key: int(h.sum()) for key, h in res["hists"].items()}
        t0 = time.perf_counter()
        ev.run(params, frozen, examples, return_hists=True)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        out[name] = {"run_ms": run_s * 1e3, "run_without_crf_ms": plain_s * 1e3,
                     "crf_ms_per_image": (run_s - plain_s) * 1e3 / len(examples),
                     "crf_seg_miou": float(res["crf_seg"]["miou"]),
                     "msc_seg_miou": float(res["msc_seg"]["miou"]),
                     "hist_totals": totals, "labelled_pixels": n_gt}
        print(f"[crf] Evaluator.run(crf=True, crf_impl={impl!r}) over {len(examples)} "
              f"images (canvas {ev.prep.canvas_out}): {run_s * 1e3:.1f} ms, without the CRF "
              f"{plain_s * 1e3:.1f} ms; crf_seg mIoU {out[name]['crf_seg_miou']:.4f} (msc "
              f"{out[name]['msc_seg_miou']:.4f}); histogram totals {totals} (labelled "
              f"{n_gt}); launches {json.dumps(launches[name])}; on {card}", flush=True)
        if any(t != n_gt for t in totals.values()) or "crf_seg" not in totals:
            raise AssertionError(f"{name}: histogram totals {totals} != {n_gt}")
        del params, frozen, ev
        torch.cuda.empty_cache()
    if not launches["evaluator_crf_jax_coco"]["crf_window"]:
        raise AssertionError("K7 did not launch on the COCO crf_impl='jax' path")
    # the CRF evaluation's wall time beside K7's time at each grid
    for name, what in (("evaluator_crf_jax", K7_SHAPES[1][5]),
                       ("evaluator_crf_jax_coco", K7_SHAPES[0][5])):
        run, k7 = out[name], k7_times[what]
        print(f"[crf] {name}: Evaluator.run(crf=True, crf_impl='jax') {run['run_ms']:.1f} ms "
              f"over 8 images, {run['run_ms'] - run['run_without_crf_ms']:.1f} ms of it the CRF; "
              f"{launches[name]['crf_window']} K7 launches; K7 at {k7['shape']} r {k7['r']} "
              f"{k7['ms']:.4f} ms (normalizer {k7['normalizer_ms']:.4f} ms); on {card}",
              flush=True)
    return launches, out


def run_crf_cli(cfg_path: str, model_path: str, card: str):
    """The end of phase 15: the ``eval_voc`` CLI with ``--crf --crf_impl
    jax`` on phase 13's tree and checkpoints (8 images), its ``crf_seg``
    histogram totalling the labelled pixels.  Returns launches of the call
    and the measurements."""
    import torch

    from weclip_tpu_torch import kernels
    from weclip_tpu_torch.cli import eval_voc
    from weclip_tpu_torch.evalx.runner import Evaluator

    launches, out = {}, {}
    runs = []
    orig_run = Evaluator.run

    def run(self, *args, **kw):
        res = orig_run(self, *args, **dict(kw, return_hists=True))
        runs.append(res)
        return res

    Evaluator.run = run
    try:
        with cli_logging():
            kernels.reset_launches()
            t0 = time.perf_counter()
            scores = eval_voc.main(["--config", cfg_path, "--model_path", model_path, "--crf",
                                    "--crf_impl", "jax",
                                    "--work_dir", os.path.join(os.path.dirname(cfg_path),
                                                               "crf_out"),
                                    "--device", "cuda"])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            launches["eval_voc_cli_crf"] = dict(kernels.launches)
    finally:
        Evaluator.run = orig_run
    hist = runs[-1]["hists"]["crf_seg"]
    n_gt = int(runs[-1]["hists"]["msc_seg"].sum())
    out["eval_voc_cli_crf"] = {"call_s": cli_s, "crf_seg_miou": float(scores["crf_seg"]["miou"]),
                               "crf_hist_total": int(hist.sum()), "labelled_pixels": n_gt}
    print(f"[crf] eval_voc --crf --crf_impl jax over 8 cached images: {cli_s:.2f} s, "
          f"crf_seg mIoU "
          f"{out['eval_voc_cli_crf']['crf_seg_miou']:.4f}, crf histogram total "
          f"{int(hist.sum())} (labelled {n_gt}); on {card}", flush=True)
    if int(hist.sum()) != n_gt or not math.isfinite(float(scores["crf_seg"]["pAcc"])):
        raise AssertionError(f"eval_voc --crf: {out['eval_voc_cli_crf']}")
    return launches, out


# -- phase 16: data parallel ---------------------------------------------------

DP_WORLD = 2


def dp_config():
    """Full ViT-B/16 width, fp32, crop 320, 2 crops a rank; warm-up off and
    the rate at 1e-5, so that the steps move the parameters without the
    loss running away (at the full rate of 2e-4 it grows six-fold in three
    steps on this random model)."""
    import dataclasses

    from weclip_tpu_torch.core.config import Config
    cfg = Config()
    return dataclasses.replace(
        cfg, precision=dataclasses.replace(cfg.precision, compute_dtype="float32"),
        optimizer=dataclasses.replace(cfg.optimizer, learning_rate=1e-5, warmup_iter=0),
        train=dataclasses.replace(cfg.train, samples_per_gpu=2),
        eval=dataclasses.replace(cfg.eval, batch_images=2))


def block_labels(b: int, size: int, num_classes: int, seed: int):
    """(b, size, size) int64 labels: a random class per 32 x 32 block and
    one block row of ignore (255), the layout of a pseudo label."""
    rng = np.random.default_rng(seed)
    g = size // 32
    lab = rng.integers(0, num_classes, (b, g, g))
    lab[:, 0] = 255
    return np.repeat(np.repeat(lab, 32, axis=1), 32, axis=2).astype(np.int64)


def dp_steps(mesh, rows, steps: int = 3):
    """``steps`` fp32 train steps over ``rows`` of each global batch of 4
    on the card: (losses, first-step gradients on the host, seconds).  The
    steps train against fixed block labels (the step's ``pseudo``), so that
    a pixel whose label flips in the CAM chain between a batch of 2 and one
    of 4 does not stand in for a difference in the reduction."""
    import torch

    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.models import weclip
    from weclip_tpu_torch.train import step as step_mod
    from weclip_tpu_torch.train.trainer import make_batcher

    cfg = dp_config()
    frozen = weclip.random_frozen_state(cfg, seed=0, device="cuda")
    state = step_mod.create_train_state(torch.Generator().manual_seed(1), cfg, "cuda")
    step_fn = step_mod.make_train_step(cfg, precision.FP32, mesh)
    to_device = make_batcher(cfg, frozen, "cuda", mesh)
    losses, grads = [], None
    t0 = time.perf_counter()
    for s in range(steps):
        host = synthetic_train_batch(cfg, 4, seed=40 + s)
        batch, ci, ca = to_device({k: v[rows] for k, v in host.items()})
        pseudo = torch.from_numpy(block_labels(4, cfg.dataset.crop_size,
                                               cfg.dataset.num_classes, 50 + s)[rows])
        state, m = step_fn(state, frozen, batch, rng=9, cls_idx=ci, cls_active=ca,
                           pseudo=pseudo.cuda())
        losses.append(float(m.loss))
        if grads is None:
            grads = [(n, t.grad.cpu()) for n, t in named_leaves(state.params)]
    torch.cuda.synchronize()
    return losses, grads, time.perf_counter() - t0


def dp_evaluate():
    """``Evaluator.run`` msc-flip over phase 10's 8 images (2 a batch):
    the int64 histograms and seconds."""
    import torch

    from weclip_tpu_torch.evalx.runner import Evaluator, make_prep
    from weclip_tpu_torch.models import weclip
    from weclip_tpu_torch.core.config import Config
    import dataclasses
    cfg = Config()
    cfg = dataclasses.replace(cfg, eval=dataclasses.replace(cfg.eval, batch_images=2))
    params = weclip.init_trainable_params(torch.Generator().manual_seed(0), cfg, "cuda")
    frozen = weclip.random_frozen_state(cfg, seed=0, device="cuda")
    ev = Evaluator(cfg, make_prep(cfg, max_ori=512, resize_long=cfg.eval.resize_long),
                   frozen["visual"]["positional_embedding"].cpu().numpy(), device="cuda")
    t0 = time.perf_counter()
    res = ev.run(params, frozen, labelled_voc_examples(8, seed=11), return_hists=True)
    torch.cuda.synchronize()
    return res["hists"], time.perf_counter() - t0


def dp_child(rank: int, init_file: str, out_dir: str):
    """One rank of phase 16: gloo over a ``file://`` rendezvous, the card
    shared with the other rank."""
    import torch
    import torch.distributed as dist

    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.parallel import mesh as meshlib

    precision.strict_matmul()
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=DP_WORLD)
    try:
        mesh = meshlib.make_mesh(DP_WORLD)
        losses, grads, step_s = dp_steps(mesh, slice(2 * rank, 2 * rank + 2))
        hists, eval_s = dp_evaluate()
        torch.save({"losses": losses, "grads": grads, "hists": hists, "step_s": step_s,
                    "eval_s": eval_s}, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_data_parallel(work: str, card: str):
    """Phase 16: two gloo ranks on the one card, spawned by
    ``torch.multiprocessing``: 3 fp32 train steps at full width (crop 320, 2
    crops a rank) against one process at batch 4 (losses within 1e-4,
    first-step gradients within 1e-5 of each leaf's largest), and
    ``Evaluator.run`` over 8 images whose summed histograms equal one
    process's; then a one-rank NCCL group's all-reduce on the card.
    Returns the measurements."""
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.parallel import mesh as meshlib

    out_dir = os.path.join(work, "dp")
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    mp.spawn(dp_child, args=(os.path.join(out_dir, "rendezvous"), out_dir),
             nprocs=DP_WORLD, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(DP_WORLD)]
    precision.strict_matmul()
    losses, grads, step_s = dp_steps(None, slice(0, 4))
    hists, eval_s = dp_evaluate()
    loss_err = max(abs(a - b) for r in ranks for a, b in zip(r["losses"], losses))
    grad_rel = max(float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
                   for r in ranks for (_, g), (_, w) in zip(r["grads"], grads))
    hist_equal = all(np.array_equal(r["hists"][k], hists[k]) for r in ranks for k in hists)
    hist_diff = {k: int(np.abs(ranks[0]["hists"][k] - hists[k]).sum()) // 2 for k in hists}

    dist.init_process_group("nccl", init_method=f"file://{os.path.join(out_dir, 'nccl')}",
                            rank=0, world_size=1)
    try:
        x = torch.arange(8, dtype=torch.float32, device="cuda")
        y = x.clone()
        dist.all_reduce(y)
        dist.barrier()
        torch.cuda.synchronize()
        nccl_ok = (bool(torch.equal(x, y)) and dist.get_backend() == "nccl"
                   and meshlib.make_mesh(-1, 1) == meshlib.Mesh(data=1, rank=0))
    finally:
        dist.destroy_process_group()
    res = {"spawn_and_children_s": spawn_s, "losses_one_process": losses,
           "losses_ranks": [r["losses"] for r in ranks], "loss_max_abs_err": loss_err,
           "grad_max_rel_err": grad_rel, "hists_equal": hist_equal,
           "hist_pixels_apart": hist_diff, "nccl_round_trip": nccl_ok,
           "steps_s_rank": [r["step_s"] for r in ranks], "steps_s_one_process": step_s,
           "eval_s_rank": [r["eval_s"] for r in ranks], "eval_s_one_process": eval_s}
    print(f"[dp] 2 gloo ranks on one card ({spawn_s:.1f} s with start-up): 3 fp32 steps, "
          f"losses {json.dumps(res['losses_ranks'])} vs one process at batch 4 "
          f"{json.dumps(losses)}: max |dloss| {loss_err:.3e} (tol 1e-4); first-step "
          f"gradients max error / leaf's largest {grad_rel:.3e} (tol 1e-5); steps "
          f"{json.dumps(res['steps_s_rank'])} s a rank vs {step_s:.2f} s; Evaluator.run "
          f"histograms summed over the ranks equal to one process: {hist_equal} (pixels "
          f"apart {hist_diff}); eval {json.dumps(res['eval_s_rank'])} s a rank vs "
          f"{eval_s:.2f} s; NCCL one-rank all-reduce on the card: {nccl_ok}; on {card}",
          flush=True)
    if loss_err > 1e-4 or grad_rel > 1e-5 or not hist_equal or not nccl_ok:
        raise AssertionError(f"data parallel: {res}")
    torch.cuda.empty_cache()
    return res


MP_WORLD = 2          # the model-parallel run: data 1 x model 2


def mp_work(mesh, steps: int = 3):
    """What each rank of the model-parallel run and one process (``mesh``
    None) compute at full width on the card: the frozen MLP leaves' shapes;
    ``steps`` fp32 train steps at batch 2 on fixed block labels (losses,
    each step's gradients, the parameters before the first step and after
    the last, seconds);
    GradCAM of one crop, 20 classes, through ``cam_single`` (fp32);
    ``Evaluator.run`` (fp32) over 2 labelled VOC-size images; one bf16 step
    (loss, parameters)."""
    import torch

    from weclip_tpu_torch.cam import variants
    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.evalx.runner import Evaluator, make_prep
    from weclip_tpu_torch.models import weclip
    from weclip_tpu_torch.models.clip import vit
    from weclip_tpu_torch.parallel import mesh as meshlib
    from weclip_tpu_torch.train import step as step_mod
    from weclip_tpu_torch.train.trainer import make_batcher

    cfg = dp_config()
    crop, k = cfg.dataset.crop_size, cfg.dataset.num_classes
    frozen = weclip.random_frozen_state(cfg, seed=0, device="cuda")
    if mesh is not None:
        frozen = meshlib.shard_model(mesh, frozen)
    mlp = frozen["visual"]["blocks"]["mlp"]
    out = {"shapes": {n: tuple(t.shape) for n, t in mlp.items() if torch.is_tensor(t)}}
    to_device = make_batcher(cfg, frozen, "cuda", mesh)

    def train(policy, n):
        state = step_mod.create_train_state(torch.Generator().manual_seed(1), cfg, "cuda")
        start = [t.detach().cpu().clone() for t in step_mod.param_leaves(state.params)]
        step_fn = step_mod.make_train_step(cfg, policy, mesh)
        losses, grads = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(n):
            batch, ci, ca = to_device(synthetic_train_batch(cfg, 2, seed=60 + s))
            pseudo = torch.from_numpy(block_labels(2, crop, k, 70 + s)).cuda()
            state, m = step_fn(state, frozen, batch, rng=9, cls_idx=ci, cls_active=ca,
                               pseudo=pseudo)
            losses.append(float(m.loss))
            grads.append([(name, t.grad.cpu().clone()) for name, t in named_leaves(state.params)])
        torch.cuda.synchronize()
        return {"losses": losses, "grads": grads, "seconds": time.perf_counter() - t0,
                "start": start,
                "params": [t.detach().cpu().clone() for t in step_mod.param_leaves(state.params)]}

    out["fp32"] = train(precision.FP32, steps)
    batch, _, _ = to_device(synthetic_train_batch(cfg, 1, seed=80))
    x11 = vit.vision_forward_frozen(frozen["visual"], batch.img, batch.pos_emb, batch.valid,
                                    cfg.clip, policy=precision.FP32).layer_tokens[-1][0]
    text = torch.cat([frozen["fg_text"], frozen["bg_text"]])
    out["cams"] = variants.cam_single(
        "grad_cam", frozen["visual"], frozen["logit_scale"], x11, text,
        torch.ones(text.shape[0], dtype=torch.bool, device="cuda"), batch.valid[0],
        torch.arange(k - 1, device="cuda"), cfg.clip, precision.FP32).cpu()
    params = weclip.init_trainable_params(torch.Generator().manual_seed(0), cfg, "cuda")
    ev = Evaluator(cfg, make_prep(cfg, max_ori=512, resize_long=cfg.eval.resize_long),
                   frozen["visual"]["positional_embedding"].cpu().numpy(),
                   policy=precision.FP32, device="cuda")
    out["hists"] = ev.run(params, frozen, labelled_voc_examples(2, seed=11),
                          return_hists=True)["hists"]
    out["bf16"] = train(precision.make_policy("bfloat16"), 1)
    return out


def mp_child(rank: int, init_file: str, out_dir: str):
    """One rank of the model-parallel run: gloo over a ``file://``
    rendezvous, the card shared with the other rank; a collective that
    waits 600 s raises."""
    import datetime

    import torch
    import torch.distributed as dist

    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.parallel import mesh as meshlib

    precision.strict_matmul()
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=MP_WORLD, timeout=datetime.timedelta(seconds=600))
    try:
        mesh = meshlib.make_mesh(1, MP_WORLD)
        if (mesh.data, mesh.model, mesh.model_rank) != (1, MP_WORLD, rank):
            raise AssertionError(f"rank {rank}: mesh {mesh}")
        torch.save(mp_work(mesh), os.path.join(out_dir, f"mp_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_model_parallel(work: str, card: str):
    """Phase 16's model-parallel run: two gloo ranks sharing the card as a
    mesh of data 1 x model 2, the frozen MLPs split between them
    (``shard_model``), against one process with the whole tree, at full
    width (``mp_work``).  Holds: each rank's MLP leaves half of the whole;
    fp32 losses within 1e-5 (relative) and the first step's gradients
    within 1e-5 of each leaf's largest; the two ranks' gradients equal at
    every step; each
    leaf's update over 3 steps within 5e-2 relative (L2) of one process's;
    GradCAM within 1e-5; ``Evaluator.run``'s histograms totalling the
    labelled pixels and at most 1e-4 of them apart from one process's; the
    bf16 step within rtol 5e-3 / atol 5e-4 of one process's (the JAX
    package's bound: a partial rounded to bf16 before the sum).

    The parameters after 3 steps are also measured against the JAX
    package's elementwise bound for one step (rtol 5e-5, atol 1e-7), and
    so are the later steps' gradients, neither held: AdamW divides
    each element's gradient by its own size, so an element whose gradient
    sits at the fp32 noise floor (the decoder's key bias, which softmax
    ignores, has a true gradient of 0) moves by up to the learning rate in
    a direction that the summation order picks, and the next steps'
    gradients follow those parameters.  A CAM or logit near a tie flips
    with a rounding of 1e-7, hence the pixel budget.  The step times are a correctness
    set-up's, not a scaling figure: one card shared, and the MLP sums go
    through the host.  Returns the measurements."""
    import torch
    import torch.multiprocessing as mp

    from weclip_tpu_torch.core import precision

    out_dir = os.path.join(work, "mp")
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    mp.spawn(mp_child, args=(os.path.join(out_dir, "rendezvous"), out_dir),
             nprocs=MP_WORLD, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"mp_rank{r}.pt"), weights_only=False)
             for r in range(MP_WORLD)]
    precision.strict_matmul()
    one = mp_work(None)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    fp, one_fp = [r["fp32"] for r in ranks], one["fp32"]
    loss_rel = max(rel(a, b) for r in fp for a, b in zip(r["losses"], one_fp["losses"]))
    grad_rel = [max(float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
                    for r in fp for (_, g), (_, w) in zip(r["grads"][s], one_fp["grads"][s]))
                for s in range(len(one_fp["grads"]))]
    grads_equal = all(torch.equal(a, b) for ga, gb in zip(fp[0]["grads"], fp[1]["grads"])
                      for (_, a), (_, b) in zip(ga, gb))
    names = [n for n, _ in one_fp["grads"][0]]
    update_rel = {}
    for r in fp:
        for n, p0, a, b in zip(names, one_fp["start"], r["params"], one_fp["params"]):
            d = float(((a - p0) - (b - p0)).norm() / (b - p0).norm().clamp_min(1e-30))
            update_rel[n] = max(update_rel.get(n, 0.0), d)

    def excess(got, want, rtol, atol):
        """Largest |got - want| / (atol + rtol |want|) over the leaves (1:
        at the bound), and its leaf."""
        return max((float(((g - w).abs() / (atol + rtol * w.abs())).max()), n)
                   for n, g, w in zip(names, got, want))

    jax_bound = max(excess(r["params"], one_fp["params"], 5e-5, 1e-7) for r in fp)
    full, half = one["shapes"], ranks[0]["shapes"]
    halves = (all(r["shapes"] == half for r in ranks)
              and half["fc_w"][1] * 2 == full["fc_w"][1] and half["fc_b"][1] * 2 == full["fc_b"][1]
              and half["proj_w"][2] * 2 == full["proj_w"][2]
              and half["proj_b"] == full["proj_b"])
    cam_err = max(max_err(r["cams"], one["cams"]) for r in ranks)
    labelled = sum(int((ex["label"] != 255).sum()) for ex in labelled_voc_examples(2, seed=11))
    apart = {k: max(int(np.abs(r["hists"][k] - h).sum()) // 2 for r in ranks)
             for k, h in one["hists"].items()}
    totals = {k: int(h.sum()) for k, h in one["hists"].items()}
    totals_ok = all(int(h.sum()) == labelled for r in ranks + [one] for h in r["hists"].values())
    bf16_loss_rel = max(rel(r["bf16"]["losses"][0], one["bf16"]["losses"][0]) for r in ranks)
    bf16_excess = max(excess(r["bf16"]["params"], one["bf16"]["params"], 5e-3, 5e-4)
                      for r in ranks)
    res = {"spawn_and_children_s": spawn_s, "shapes_rank": half, "shapes_whole": full,
           "losses_ranks": [r["losses"] for r in fp], "losses_one_process": one_fp["losses"],
           "loss_max_rel_err": loss_rel, "grad_max_rel_err_by_step": grad_rel,
           "rank_grads_equal": grads_equal, "update_max_rel_l2": max(update_rel.values()),
           "update_rel_l2": update_rel, "params_jax_bound_excess": jax_bound,
           "cam_max_abs_err": cam_err, "hist_pixels_apart": apart, "hist_totals": totals,
           "labelled_pixels": labelled, "bf16_loss_rel_err": bf16_loss_rel,
           "bf16_param_excess_of_bound": bf16_excess,
           "steps_s_rank": [r["seconds"] for r in fp], "steps_s_one_process": one_fp["seconds"]}
    print(f"[mp] data 1 x model 2, 2 gloo ranks on one card ({spawn_s:.1f} s with start-up),"
          f" MLP leaves a rank {json.dumps(half)} of {json.dumps(full)}: 3 fp32 steps at "
          f"batch 2, losses {json.dumps(res['losses_ranks'])} vs one process "
          f"{json.dumps(one_fp['losses'])}: max rel err {loss_rel:.3e} (tol 1e-5); gradients "
          f"max err / leaf's largest by step {json.dumps([float(f'{g:.3e}') for g in grad_rel])} "
          f"(tol 1e-5 at the first), equal on the two ranks: {grads_equal}; 3-step update max rel L2 err "
          f"{res['update_max_rel_l2']:.3e} (tol 5e-2); parameters at {jax_bound[0]:.3f} of "
          f"the JAX bound rtol 5e-5 / atol 1e-7 (at {jax_bound[1]}; not held); GradCAM "
          f"(cam_single, 20 classes) max err {cam_err:.3e} (tol 1e-5); Evaluator.run fp32 "
          f"histograms pixels apart from one process {json.dumps(apart)} (tol "
          f"{labelled // 10000}), totals {json.dumps(totals)} of {labelled} labelled pixels; "
          f"bf16 step loss rel err {bf16_loss_rel:.3e} (tol 5e-3), parameters at "
          f"{bf16_excess[0]:.3f} of rtol 5e-3 / atol 5e-4; 3 fp32 steps took "
          f"{json.dumps(res['steps_s_rank'])} s a rank vs {one_fp['seconds']:.2f} s in one "
          f"process (a correctness set-up, not a scaling figure: one card shared, the MLP "
          f"sums through the host); on {card}", flush=True)
    if (loss_rel > 1e-5 or grad_rel[0] > 1e-5 or not grads_equal or not halves
            or res["update_max_rel_l2"] > 5e-2 or cam_err > 1e-5
            or max(apart.values()) > labelled // 10000
            or not totals_ok or bf16_loss_rel > 5e-3 or bf16_excess[0] > 1.0):
        raise AssertionError(f"model parallel: {res}")
    torch.cuda.empty_cache()
    return res


def run_tensorboard_helpers(card: str):
    """The TensorBoard image helpers of ``utils/imutils.py`` on seeded
    images, CAMs and attention maps, on this host (which may lack
    matplotlib: then the closed-form jet colours them): uint8 grids of the
    expected shapes.  Returns their shapes and whether matplotlib imported."""
    from weclip_tpu_torch.utils import imutils

    rng = np.random.default_rng(90)
    imgs = rng.standard_normal((4, 3, 320, 320)).astype(np.float32)
    cam = rng.uniform(0, 1, (4, 20, 20, 20)).astype(np.float32)
    attn = rng.uniform(0, 1, (14, 4, 400, 400)).astype(np.float32)
    attns = list(attn / attn.sum(-1, keepdims=True))
    labels = rng.integers(0, 21, (4, 320, 320))
    img_grid, cam_grid = imutils.tensorboard_image(imgs, cam)
    grids = {"image": img_grid, "cam": cam_grid,
             "edge": imutils.tensorboard_edge(cam[:, :1]),
             "attn": imutils.tensorboard_attn(attns),
             "label": imutils.tensorboard_label(labels)}
    attn2 = imutils.tensorboard_attn2(attns)
    want = {"image": (3, 646, 646), "cam": (3, 646, 646), "edge": (3, 454, 454),
            "attn": (3, 3166, 906), "label": (3, 646, 646)}
    shapes = {k: tuple(g.shape) for k, g in grids.items()}
    try:
        import matplotlib  # noqa: F401
        has_mpl = True
    except ImportError:
        has_mpl = False
    ok = (shapes == want and all(g.dtype == np.uint8 for g in grids.values())
          and len(attn2) == 8 and all(g.dtype == np.uint8 and g.shape[0] == 3 for g in attn2))
    print(f"[tb] TensorBoard helpers on the host (matplotlib imports: {has_mpl}): uint8 "
          f"grids {json.dumps(shapes)}, tensorboard_attn2 {len(attn2)} grids; {card}",
          flush=True)
    if not ok:
        raise AssertionError(f"TensorBoard helpers: {shapes} vs {want}, attn2 "
                             f"{[(g.dtype, g.shape) for g in attn2]}")
    return {"shapes": shapes, "matplotlib": has_mpl}


def profile_pipeline(pipe, ims, ids, reps: int = 3, tag: str = ""):
    """Warm host-clock times of the two calls (median of ``reps``), then
    one traced pair: device time by kernel and the device's idle share."""
    import torch

    def timed(fn):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    out = {"pseudo_label_warm_ms": timed(lambda: pipe.pseudo_label_batch(ims, ids)),
           "segment_warm_ms": timed(lambda: pipe.segment_batch(ims))}
    for name, fn in (("pseudo_label", lambda: pipe.pseudo_label_batch(ims, ids)),
                     ("segment", lambda: pipe.segment_batch(ims))):
        busy, idle = trace(fn, f"{tag}{name}")
        out[f"{name}_device_busy_ms"] = busy
        out[f"{name}_idle_share"] = idle
    print(f"[pipeline] {tag}warm: pseudo_label_batch(8) "
          f"{out['pseudo_label_warm_ms']:.1f} ms, segment_batch(8) "
          f"{out['segment_warm_ms']:.1f} ms (median of {reps})", flush=True)
    return out


def trace(fn, name: str, top_n: int = 12):
    """One traced call of ``fn``: prints the device time by kernel (top
    ``top_n``) and returns (device busy ms, idle share of the host wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device spans of kernels and copies; a range such as the optimizer's
    # step is mirrored onto the device timeline as an annotation, not work
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy = _union_ms([(e.time_range.start, e.time_range.end) for e in events])
    by_kernel = {}
    for e in events:
        by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                             + (e.time_range.end - e.time_range.start) / 1e3)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top_n]
    print(f"[profile] {name}: wall {wall:.1f} ms (traced), device busy "
          f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}", flush=True)
    for k, ms in top:
        print(f"[profile]   {ms:9.3f} ms  {k[:110]}", flush=True)
    return busy, 1 - busy / wall


def _union_ms(spans) -> float:
    """Total length (ms) of the union of (start, end) spans in us."""
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    from weclip_tpu_torch import kernels

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    took = kernels.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})", flush=True)
    records = check_kernels()
    check_cti_kernels(records)
    attention_resources = check_widths(records)
    forward_designs = check_forward_designs()
    check_block_epilogue(records)
    launches, pipeline = run_pipeline()
    results = {"pipeline": pipeline, "attention_resources": attention_resources,
               "forward_designs": forward_designs}
    work = tempfile.mkdtemp(prefix="weclip_chip_smoke_")
    try:
        for name, phase in (("comer_pipeline", run_comer_pipeline),
                            ("training", run_training),
                            ("coco_pseudo_label", run_coco_pseudo_label),
                            ("train_loop", lambda: run_train_loop(keep=work)),
                            ("evaluator", run_evaluator), ("seg_step", run_seg_steps),
                            ("comer_benchmark", run_comer_benchmark)):
            phase_launches, results[name] = phase()
            launches.update(phase_launches)
        ckpt, phase_launches, results["clip_checkpoint"] = run_clip_checkpoint(work, card)
        launches.update(phase_launches)
        phase_launches, cfg_path, results["eval_cli"] = run_eval_cli(
            work, ckpt, os.path.join(work, "step_00000006"), card)
        launches.update(phase_launches)
        phase_launches, results["cam"] = run_cam_surface(cfg_path, work, card)
        launches.update(phase_launches)
        phase_launches, results["crf"] = run_crf(records, card)
        launches.update(phase_launches)
        phase_launches, results["crf_cli"] = run_crf_cli(
            cfg_path, os.path.join(work, "step_00000006"), card)
        launches.update(phase_launches)
        results["data_parallel"] = run_data_parallel(work, card)
        results["model_parallel"] = run_model_parallel(work, card)
        results["tensorboard"] = run_tensorboard_helpers(card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for name in kernels.launches:
        if not sum(phase[name] for phase in launches.values()):
            raise AssertionError(f"kernel {name} never launched on the main path")
    for r in records:
        r["launches"] = sum(phase[r["name"]] for phase in launches.values())
        r["launches_by_call"] = {call: phase[r["name"]] for call, phase in launches.items()}
    seconds = time.perf_counter() - t_start
    print(f"[done] {seconds:.1f} s in all, on {card}", flush=True)
    print(json.dumps({"kernels": records, "card": card, **results, "seconds": seconds}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
