"""The evaluation mix: one ``Evaluator.run`` call, msc-flip, timed.

Set-up writes the pool as a VOC tree whose ``val`` list cycles it, builds
the evaluator as ``cli/eval_voc.py`` does (``VOCSegDataset``, ``make_prep``
at VOC's 512-pixel originals, the configuration's policy), and warms it with
a call of ``warm_batches`` batches.  The window's ``max_images`` is a fixed
amount of work: the whole batches of ``batch_images`` that last about
``--seconds`` at the traffic's ``sizing_images_per_s`` (measured when the
cell was made).  The window is one ``run`` over that many images, timed on
the host clock until the call returns (it reads its histograms back).  The
evaluator's ``combine`` is wrapped to keep the outputs of a seeded sample of
the window's batches for the check, and, with ``--trace 1``, to start and
stop the profiler around ``trace_batches`` batches from batch
``trace_from``.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from benchmark import check, harness, pool as pool_mod, weights, work
from benchmark.harness import Context, Run
from benchmark.trace import Stretch


def run(ctx: Context) -> Run:
    import dataclasses

    import torch

    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.data.voc import VOCSegDataset
    from weclip_tpu_torch.evalx.runner import Evaluator, make_prep
    from weclip_tpu_torch.models import weclip
    from weclip_tpu_torch.models.clip.loader import params_from_state_dict

    tp, dev, seed = ctx.traffic, ctx.device, ctx.seed
    harness.build_kernels(dev)
    num_fg = ctx.config["config"]["dataset"]["num_classes"] - 1
    t_build = time.perf_counter()
    pool = pool_mod.make_pool(seed, tp["pool_images"], tp["sizes"], tp["classes_per_image"],
                              num_fg, dev)
    n_pool = len(pool)
    root = harness.scratch_dir(ctx.cell_name)
    try:
        names = [pool[i % n_pool]["name"] for i in range(tp["list_length"])]
        paths = pool_mod.write_tree(root, pool, {"val": names})
        cfg, _ = harness.program_config(ctx, paths)
        policy = precision.make_policy(cfg.precision.compute_dtype)
        cfgd = ctx.cfg_dict()
        sd = weights.clip_state_dict(seed, cfgd["clip"], dev, cfgd["tower"], cfgd["published"])
        fg, bg = weights.class_features(seed, num_fg, ctx.config["text"]["num_bg"],
                                        cfg.clip.embed_dim, dev)
        visual = params_from_state_dict(
            sd, dataclasses.replace(cfg.clip, transformer_layers=1))["visual"]
        frozen = weclip.build_frozen_state(visual, sd["logit_scale"], fg, bg, dev)
        del visual
        layout = weclip.init_trainable_params(torch.Generator().manual_seed(0), cfg, "cpu")
        values = weights.trainable_values(
            seed, [(p, tuple(t.shape)) for p, t in weights.leaf_paths(layout)], dev)
        params = weights.fill_tree(layout, values)
        dataset = VOCSegDataset(cfg.dataset, split="val", stage="val")
        max_ori = tp["max_ori"]
        prep = make_prep(cfg, max_ori=max_ori, resize_long=cfg.eval.resize_long)
        pe = frozen["visual"]["positional_embedding"].float().cpu().numpy()
        with_cam = tp["with_cam"]
        ev = Evaluator(cfg, prep, pe, policy=policy, with_cam=with_cam, msc=True,
                       device=dev)
        bsz = cfg.eval.batch_images

        # warm-up: the evaluator's first call; then a window of a fixed size,
        # the whole batches that last about --seconds at the traffic's
        # sizing rate
        t_warm = time.perf_counter()
        ev.run(params, frozen, dataset, max_images=tp["warm_batches"] * bsz)
        n_batches = max(tp["min_batches"],
                        int(round(tp["sizing_images_per_s"] * ctx.seconds / bsz)))
        n_img = min(n_batches * bsz, len(dataset) // bsz * bsz)
        n_batches = n_img // bsz
        sample_rng = np.random.default_rng([int(seed) % (2 ** 63), 29])
        sample = set(int(i) for i in sample_rng.choice(
            n_batches, size=min(tp["checked_batches"], n_batches), replace=False))
        out = Run(spec=ctx.spec)
        out.e2e["setup_s"] = time.perf_counter() - ctx.t_start
        ctx.log(f"[setup] {out.e2e['setup_s']:.3f} s: to the kernels "
                f"{t_build - ctx.t_start:.3f}, pool, tree, weights "
                f"{t_warm - t_build:.3f}, warm-up {time.perf_counter() - t_warm:.3f}; "
                f"window of {n_img} images; checked batches {sorted(sample)}")

        # the window: one call; combine wrapped to keep samples and to trace
        stretch = Stretch() if ctx.trace else None
        t_from, t_n = tp["trace_from"], tp["trace_batches"]
        kept, batch_i = {}, [0]
        t_stretch = [0.0, 0.0]
        combine = ev.combine

        def combine_kept(seg_single, seg_avg1, seg_avg2, cam_labels, labels, sizes, hists):
            i = batch_i[0]
            res = combine(seg_single, seg_avg1, seg_avg2, cam_labels, labels, sizes, hists)
            if i in sample:
                kept[i] = {"seg_single": seg_single.clone(), "seg_avg1": seg_avg1.clone(),
                           "seg_avg2": seg_avg2.clone(), "cam_labels": cam_labels.clone(),
                           "pred_msc": res[1].clone()}
            if stretch is not None and i == t_from - 1:
                stretch.start()
                t_stretch[0] = time.perf_counter()
            if stretch is not None and i == t_from + t_n - 1:
                stretch.stop()
                t_stretch[1] = time.perf_counter()
            batch_i[0] += 1
            return res

        chain, gradcam_batch = weclip.pseudo_label_chain, weclip.gradcam_batch

        def gradcam_kept(*args, **kw):
            # the sampled batches' GradCAM CAMs and K1 map of block 11
            cam = gradcam_batch(*args, **kw)
            if batch_i[0] in sample:
                starts[batch_i[0]] = (cam.cams.clone(), cam.attn_last.clone())
            return cam

        par_refine = weclip.par_refine_auto

        def par_kept(*args, **kw):
            # the sampled batches' PAR scores (K4 and K5) on the chain's stack
            scores = par_refine(*args, **kw)
            if batch_i[0] in sample:
                pars[batch_i[0]] = scores.clone()
            return scores

        def chain_kept(*args, **kw):
            # the sampled batches' walk output, as the chain produces it
            labels, refined = chain(*args, **kw)
            if batch_i[0] in sample:
                walks[batch_i[0]] = refined.clone()
            return labels, refined

        walks, starts, pars = {}, {}, {}
        ev.combine = combine_kept
        weclip.pseudo_label_chain, weclip.gradcam_batch = chain_kept, gradcam_kept
        weclip.par_refine_auto = par_kept
        try:
            t0 = time.perf_counter()
            res = ev.run(params, frozen, dataset, max_images=n_img, return_hists=True)
            window = time.perf_counter() - t0
        finally:
            ev.combine = combine
            weclip.pseudo_label_chain, weclip.gradcam_batch = chain, gradcam_batch
            weclip.par_refine_auto = par_refine
        out.memory_peak_bytes = harness.peak_bytes(dev)
        out.attempted = n_img
        out.e2e["eval_images_per_s"] = n_img / window
        ctx.log(f"[clocks] {harness.clock_line()}")
        ctx.log(f"[window] {n_img} images in {window:.3f} s; peak memory "
                f"{out.memory_peak_bytes} bytes")

        def batch_ops(b):
            exs = [pool[(b * bsz + j) % n_pool] for j in range(bsz)]
            return work.eval_batch(cfgd, [ex["img_raw"].shape[:2] for ex in exs], with_cam,
                                   [int(ex["present_mask"].sum()) for ex in exs])

        traced = range(t_from, t_from + t_n) if stretch is not None else range(0)
        if stretch is not None:
            out.stretch, out.stretch_units = stretch, len(traced)
            out.stretch_ops = [o for b in traced for o in batch_ops(b)]
        out.untraced_s = window - (t_stretch[1] - t_stretch[0])
        out.untraced_units = n_batches - len(traced)
        out.untraced_ops = [o for b in range(n_batches) if b not in traced
                            for o in batch_ops(b)]

        # histograms: every labelled pixel of every image evaluated, once
        labelled = sum(int((pool[i % n_pool]["label"] < cfg.dataset.num_classes).sum())
                       for i in range(n_img))
        hist_gap = sum(abs(int(h.sum()) - labelled) for h in res["hists"].values())

        # the reference, once the program's state is freed
        del ev, frozen, params
        gc.collect()
        harness.free(dev)
        from benchmark.reference import drive
        t_ref = time.perf_counter()
        order = sorted(kept)
        batches = [[pool[(b * bsz + j) % n_pool] for j in range(bsz)] for b in order]
        if with_cam:
            for b in order:
                kept[b]["cams"], kept[b]["attn_last"] = starts[b]
                kept[b]["par"] = pars[b]
        ref = drive.eval_outputs(cfgd, sd, fg, bg, values, batches, with_cam, max_ori, dev,
                                 follow=[walks[b] for b in order] if with_cam else None)
        numbers = check.eval_numbers([kept[b] for b in order], ref, cfg.clip.patch_size,
                                     with_cam)
        if len(kept) != len(sample):
            numbers["logits"] = float("inf")
        numbers["hists"] = float(hist_gap)
        ctx.log(f"[reference] {time.perf_counter() - t_ref:.3f} s over {len(order)} batches")
        out.numbers = numbers
        ok, out.checks = check.verdict(numbers, ctx.cell["limits"])
        ctx.log("[numbers] " + " ".join(f"{k}={v!r}" for k, v in numbers.items()))
        out.failed = 0 if ok else len(order) * bsz
        return out
    finally:
        harness.remove(root)
