#!/usr/bin/env python3
"""On-card smoke test of weclip_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and ``nvcc``; imports
nothing of JAX or of ``weclip_tpu``.  Phases, each of which fails the run:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``weclip_tpu_torch/csrc`` (one nvcc each,
   all at once);
3. each kernel (K1-K5) against its plain PyTorch version on the card, on
   the same seeded inputs at the shapes of the msc-flip inference path,
   each output against its own stated tolerance (K3 also against a float64
   evaluation, and ``AttentionCoreFn`` against K1/K3 and fp32 autograd),
   timed beside its plain version, a PyTorch library call where one
   computes the same function, and the least time the card could take
   (``bound_ms``);
4. ``WeCLIPPipeline(device="cuda")`` at full ViT-B/16 width with seeded
   random weights: ``pseudo_label_batch`` and ``segment_batch`` (msc +
   flip) on 8 synthetic VOC-sized images, launch counters reset just before
   and read just after, every kernel required to have launched; then one
   image at the fp32 policy on the card and on the CPU (plain versions),
   pseudo-label agreement required to be at least 99%;
5. one ``{"kernels": [...]}`` line, then as the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

# published peaks of one H100 SXM (dense): bytes/s of HBM3, FLOP/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
VOC_SIZES = [(375, 500), (500, 375), (333, 500), (500, 500)]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
    error against float64 of the tensor-core kernel, the fp32 FMA kernel
    and cuBLAS fp32: max |err| / max |value|, mean |err| / mean |value|, and
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
    for route, dt in (("mma", bf), ("fma", torch.float32)):
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


# K3's distance from the float64 evaluation may be at most these multiples
# of the plain version's, (max, mean).  The max is one element's fate: a dS
# within ~1e-7 (relative) of a bf16 rounding midpoint rounds either way
# under either fp32 arithmetic (k3_worst_flip).  The mean is systematic: the
# tensor cores round their sums toward zero (k3_accumulation_probe).
K3_F64_RATIO = (8.0, 2.5)


def check_kernels(reps: int = 10):
    """Phase 3: every kernel against its plain version; returns the
    kernels' records (without launches)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.core.config import ParConfig
    from weclip_tpu_torch.ops import attention_kernels as ak
    from weclip_tpu_torch.refine import par as par_plain
    from weclip_tpu_torch.refine import par_kernels as pk

    precision.strict_matmul()
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    records = []

    def record(name, source, replaces, checks, ms, plain_ms, bound, lib_ms,
               shapes, **extra):
        """``checks``: (what, max_abs_err, tol), each output held to its own
        tolerance; fails after printing them all."""
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

    def out_check(what, out, ref):
        """bf16 outputs: one bf16 ulp of the largest |ref| (a single rounding
        of the output may go the other way); fp32 outputs: 2e-5."""
        if out.dtype == bf:
            tol = bf16_ulp(float(ref.float().abs().max()))
        else:
            tol = 2e-5
        return (what, max_err(out, ref), tol)

    def attn_fwd_bytes(b, h, l, dh, export):
        n = 4 * b * h * l * dh * 2 + b * l * 4       # q, k, v in, out; mask
        return n + (b * l * l * 4 if export else 0)

    src_attn = "weclip_tpu_torch/csrc/attention.cu"

    # K1: the frozen blocks' map export, first 8 rows at L=1025 (scale 1)
    b, h, l, dh = 8, 12, 1025, 64
    q, k, v = qkv(b, h, l, dh, gen, bf)
    km = token_mask(b, 512)
    out, amap = ak.attention_core(q, k, v, km, export_weights=True)
    ref_out, ref_map = ak.attention_core_plain(q, k, v, km, export_weights=True)
    torch.cuda.synchronize()
    checks = [out_check(f"out {[b, h, l, dh]} bf16", out, ref_out),
              (f"head-mean map {[b, l, l]} fp32 (largest "
               f"{float(ref_map.max()):.3e})", max_err(amap, ref_map), 2e-5)]
    record("attention_fwd_export", src_attn,
           "weclip_tpu/ops/pallas_attention.py:195 (attention_core_pallas, "
           "export_weights=True; pallas_call :260)",
           checks,
           cuda_ms(lambda: ak.attention_core(q, k, v, km, True), reps),
           cuda_ms(lambda: ak.attention_core_plain(q, k, v, km, True), reps),
           bound_ms(attn_fwd_bytes(b, h, l, dh, True), 4 * b * h * l * l * dh,
                    "bf16"),
           None, [[b, h, l, dh]])
    del out, amap, ref_out, ref_map

    # K2: flip half at scale 1, scale 2 (16 rows, L=626), eval decoder
    # (16 rows, 8 heads, Dh=32, L=1024 and 625, fp32)
    shapes = [(8, 12, 1025, 64, 512, True), (16, 12, 626, 64, 384 + 16, True),
              (16, 8, 1024, 32, 512, False), (16, 8, 625, 32, 384 + 16, False)]
    checks, first = [], None
    for (b, h, l, dh, canvas, cls) in shapes:
        dtype = bf if dh == 64 else torch.float32
        q, k, v = qkv(b, h, l, dh, gen, dtype)
        km = token_mask(b, canvas)
        if not cls:
            km = km[:, 1:]
        out, _ = ak.attention_core(q, k, v, km, export_weights=False)
        ref, _ = ak.attention_core_plain(q, k, v, km, export_weights=False)
        torch.cuda.synchronize()
        checks.append(out_check(f"out {[b, h, l, dh]} {str(dtype)[6:]}", out, ref))
        if first is None:
            first = (q, k, v, km)
    q, k, v, km = first
    b, h, l, dh = q.shape
    sdpa_mask = km.bool()[:, None, None, :]
    record("attention_fwd", src_attn,
           "weclip_tpu/ops/pallas_attention.py:195 (attention_core_pallas, "
           "export_weights=False; pallas_call :260)",
           checks,
           cuda_ms(lambda: ak.attention_core(q, k, v, km, False), reps),
           cuda_ms(lambda: ak.attention_core_plain(q, k, v, km, False), reps),
           bound_ms(attn_fwd_bytes(b, h, l, dh, False), 4 * b * h * l * l * dh,
                    "bf16"),
           cuda_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=sdpa_mask), reps),
           [list(s[:4]) for s in shapes])
    del first, q, k, v

    # K3: the GradCAM pullback, B*MC = 32 rows at L=1025 (bucket 4)
    b, h, l, dh = 32, 12, 1025, 64
    q, k, v = qkv(b, h, l, dh, gen, bf)
    km = token_mask(b, 512)
    do = torch.randn((b, h, l, dh), generator=gen, device="cuda")
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
    # under fp32 (FMA kernels) it is held to autograd of the plain forward
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
    # library yardstick: PyTorch's memory-efficient attention backward on
    # the same (pre-scaled) inputs in bf16, forward outside the timed region
    ql, kl, vl = (t.to(bf).detach().requires_grad_(True) for t in (qs, k, v))
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        out_l = F.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=km.bool()[:, None, None, :], scale=1.0)
    do_l = do.to(bf)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(out_l, (ql, kl, vl), do_l,
                                                 retain_graph=True), reps)
    del out_l, ql, kl, vl, do_l
    bwd_bytes = 7 * b * h * l * dh * 4 + b * l * 4   # q,k,v,do in; dq,dk,dv out
    record("attention_bwd", src_attn,
           "weclip_tpu/ops/pallas_attention.py:395 (attention_bwd_pallas; "
           "pallas_call :441)",
           checks,
           cuda_ms(lambda: ak.attention_bwd(qs, k, v, do, km, bf), reps),
           cuda_ms(lambda: ak.attention_bwd_plain(qs, k, v, do, km, bf), reps),
           bound_ms(bwd_bytes, 10 * b * h * l * l * dh, "bf16"),
           lib_ms, [[b, h, l, dh]], **k3)
    if failed:
        raise AssertionError(f"attention_bwd: {failed}")
    del got, ref, q, k, v, do, qs
    torch.cuda.empty_cache()

    # K4 / K5: PAR at the eval canvas, 8 images, bucket 4 (5 channels)
    cfg = ParConfig()
    b, hh, ww, c = 8, 512, 512, 5
    n = 8 * len(cfg.dilations)
    imgs = torch.randn((b, 3, hh, ww), generator=gen, device="cuda")
    aff = pk.par_affinity(imgs, cfg)
    ref = par_plain.par_affinity(imgs, cfg)
    torch.cuda.synchronize()
    src_par = "weclip_tpu_torch/csrc/par.cu"
    record("par_affinity", src_par,
           "weclip_tpu/refine/pallas_par.py:210 (par_affinity_pallas; "
           "pallas_call :265)",
           [(f"aff {[b, n, hh, ww]} fp32", max_err(aff, ref), 2e-5)],
           cuda_ms(lambda: pk.par_affinity(imgs, cfg), reps),
           cuda_ms(lambda: par_plain.par_affinity(imgs, cfg), reps),
           bound_ms(b * 3 * hh * ww * 4 + b * n * hh * ww * 4,
                    31 * n * b * hh * ww, "fp32"),
           None, [[b, 3, hh, ww]])
    del ref
    masks = torch.rand((b, c, hh, ww), generator=gen, device="cuda")
    got = pk.par_propagate(masks, aff, cfg)
    ref = par_plain.par_propagate(masks, aff, cfg)
    torch.cuda.synchronize()
    record("par_propagate", src_par,
           "weclip_tpu/refine/pallas_par.py:304 (par_refine_pallas; "
           "pallas_call :384)",
           [(f"masks {[b, c, hh, ww]} fp32 after {cfg.num_iter} iterations",
             max_err(got, ref), 2e-5)],
           cuda_ms(lambda: pk.par_propagate(masks, aff, cfg), max(2, reps // 5)),
           cuda_ms(lambda: par_plain.par_propagate(masks, aff, cfg), 2),
           bound_ms(b * n * hh * ww * 4 + 2 * b * c * hh * ww * 4,
                    cfg.num_iter * 2 * n * b * c * hh * ww, "fp32"),
           None, [[b, c, hh, ww], [b, n, hh, ww]])
    del imgs, aff, masks, got, ref
    torch.cuda.empty_cache()
    return records


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
    for name in kernels.launches:
        total = launches["pseudo_label"][name] + launches["segment"][name]
        if total == 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
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


def profile_pipeline(pipe, ims, ids, reps: int = 3):
    """Warm host-clock times of the two calls (median of ``reps``), then
    one traced pair: device time by kernel and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = _union_ms([(e.time_range.start, e.time_range.end) for e in events])
        by_kernel = {}
        for e in events:
            by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                                 + (e.time_range.end - e.time_range.start) / 1e3)
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
        print(f"[profile] {name}: wall {wall:.1f} ms (traced), device busy "
              f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}", flush=True)
        for k, ms in top:
            print(f"[profile]   {ms:9.3f} ms  {k[:110]}", flush=True)
        out[f"{name}_device_busy_ms"] = busy
        out[f"{name}_idle_share"] = 1 - busy / wall
    print(f"[pipeline] warm: pseudo_label_batch(8) {out['pseudo_label_warm_ms']:.1f} ms, "
          f"segment_batch(8) {out['segment_warm_ms']:.1f} ms (median of {reps})",
          flush=True)
    return out


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
    from weclip_tpu_torch import kernels

    print(card_line(), flush=True)
    t0 = time.perf_counter()
    took = kernels.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})", flush=True)
    records = check_kernels()
    launches, pipeline = run_pipeline()
    for r in records:
        r["launches"] = (launches["pseudo_label"][r["name"]]
                         + launches["segment"][r["name"]])
        r["launches_pseudo_label"] = launches["pseudo_label"][r["name"]]
        r["launches_segment"] = launches["segment"][r["name"]]
    print(json.dumps({"kernels": records, "pipeline": pipeline}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
