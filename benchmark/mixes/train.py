"""The training mix: ``train/trainer.py::train``'s loop, timed.

Set-up builds one training state (the benchmark's seeded weights), the
loader over the synthetic VOC tree (``VOCClsDataset``'s own augmentation,
``PrefetchLoader`` with the trainer's arguments) and ``make_batcher``, and
drives the step through its first ``warm_steps`` steps, the first three of
which the reference follows.  The window then runs the same loop body as
the trainer, on the same objects, until ``--seconds`` have passed, and ends
in a synchronize.  The 95th percentile of the host-clock intervals between
consecutive steps' returns (the traced stretch's left out) is a per-layer
metric: in this host-bound loop a step's interval is its time, and a stall
of the loader or a sync shows in it.
With ``--trace 1`` the profiler records ``trace_steps`` steps from step
``trace_from`` of the window.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np

from benchmark import check, harness, pool as pool_mod, weights, work
from benchmark.harness import Context, Run
from benchmark.trace import Stretch

CHECKED_STEPS = 3


def run(ctx: Context) -> Run:
    import torch

    from weclip_tpu_torch.core import precision
    from weclip_tpu_torch.models import weclip
    from weclip_tpu_torch.models.clip.loader import params_from_state_dict
    from weclip_tpu_torch.data.loader import PrefetchLoader
    from weclip_tpu_torch.parallel import mesh as meshlib
    from weclip_tpu_torch.train import step as step_mod
    from weclip_tpu_torch.train.trainer import build_dataset, make_batcher

    tp, dev, seed = ctx.traffic, ctx.device, ctx.seed
    harness.build_kernels(dev)
    num_fg = ctx.config["config"]["dataset"]["num_classes"] - 1
    t_build = time.perf_counter()
    pool = pool_mod.make_pool(seed, tp["pool_images"], tp["sizes"], tp["classes_per_image"],
                              num_fg, dev)
    root = harness.scratch_dir(ctx.cell_name)
    try:
        paths = pool_mod.write_tree(root, pool, {"train_aug": [ex["name"] for ex in pool]})
        t_pool = time.perf_counter()
        cfg, cfg_dict = harness.program_config(ctx, paths)

        # the program, as train() builds it, from the benchmark's weights
        pc = cfg.precision
        policy = precision.make_policy(pc.compute_dtype, pc.param_dtype, pc.softmax_dtype)
        mesh = meshlib.make_mesh(cfg.mesh.data_parallel, cfg.mesh.model_parallel)
        if dev.startswith("cuda"):
            precision.strict_matmul()
        cfgd = ctx.cfg_dict()
        sd = weights.clip_state_dict(seed, cfgd["clip"], dev, cfgd["tower"], cfgd["published"])
        fg, bg = weights.class_features(seed, num_fg, ctx.config["text"]["num_bg"],
                                        cfg.clip.embed_dim, dev)
        visual = params_from_state_dict(
            sd, dataclasses.replace(cfg.clip, transformer_layers=1))["visual"]
        frozen = meshlib.shard_model(mesh, weclip.build_frozen_state(
            visual, sd["logit_scale"], fg, bg, dev))
        del visual
        layout = weclip.init_trainable_params(torch.Generator().manual_seed(0), cfg, "cpu")
        values = weights.trainable_values(
            seed, [(p, tuple(t.shape)) for p, t in weights.leaf_paths(layout)], dev)
        params = weights.fill_tree(layout, values)
        state = step_mod.create_train_state(
            torch.Generator().manual_seed(cfg.train.seed), cfg, dev, params=params)
        del params
        step_fn = step_mod.make_train_step(cfg, policy, mesh)
        to_device = make_batcher(cfg, frozen, dev, mesh)
        loader = PrefetchLoader(build_dataset(cfg), cfg.train.samples_per_gpu,
                                seed=cfg.train.seed, start=state.step,
                                process_index=mesh.data_rank, process_count=mesh.data)
        leaves = step_mod.param_leaves(state.params)
        start = [t.detach().clone() for t in leaves]
        rng_step = cfg.train.seed + 1
        captured = {k: [] for k in ("loss", "images", "present", "seg", "refined", "labels",
                                    "par", "cams", "attn_last")}
        msum = None
        forward_train, gradcam_batch = weclip.forward_train, weclip.gradcam_batch
        par_refine = weclip.par_refine_auto

        def par_kept(*args, **kw):
            # PAR's scores (K4 and K5) on the chain's stack
            scores = par_refine(*args, **kw)
            captured["par"].append(scores.detach().clone())
            return scores

        def gradcam_kept(*args, **kw):
            # GradCAM's CAMs and K1's map of block 11, as the chain gets them
            cam = gradcam_batch(*args, **kw)
            captured["cams"].append(cam.cams.detach().clone())
            captured["attn_last"].append(cam.attn_last.detach().clone())
            return cam

        def forward_kept(*args, **kw):
            # the checked steps' forward outputs, as the step produces them
            fwd = forward_train(*args, **kw)
            captured["seg"].append(fwd.seg.detach().clone())
            captured["refined"].append(fwd.cams_refined.detach().clone())
            captured["labels"].append(fwd.cam_labels.detach().clone())
            return fwd

        def one_step(n_iter):
            nonlocal state, msum
            t0 = time.perf_counter()
            host = next(loader)
            batch, ci, ca = to_device(host)
            t1 = time.perf_counter()
            state, m = step_fn(state, frozen, batch, rng=rng_step, cls_idx=ci,
                               cls_active=ca, extra_iter_num=0)
            # the trainer's window sums, read back every log_iters steps
            msum = m if msum is None else step_mod.StepMetrics(
                *(a + b for a, b in zip(msum, m)))
            if (n_iter + 1) % cfg.train.log_iters == 0:
                [float(x) for x in msum]
                msum = None
            t2 = time.perf_counter()
            return host, m, t1 - t0, t2 - t1

        t_state = time.perf_counter()
        try:
            # set-up: the first steps, the first three recorded for the check
            mcs_seen = set()
            for k in range(tp["warm_steps"]):
                if k < CHECKED_STEPS:
                    weclip.forward_train, weclip.gradcam_batch = forward_kept, gradcam_kept
                    weclip.par_refine_auto = par_kept
                try:
                    host, m, _, _ = one_step(k)
                finally:
                    weclip.forward_train, weclip.gradcam_batch = forward_train, gradcam_batch
                    weclip.par_refine_auto = par_refine
                mcs_seen.add(int(host["present_mask"].any(0).sum()))
                if k < CHECKED_STEPS:
                    captured["loss"].append(m.loss)
                    captured["images"].append(host["img"].copy())
                    captured["present"].append(np.asarray(host["present_mask"]).copy())
                if k == 0:
                    beta1 = cfg.optimizer.betas[0]
                    captured["grad"] = [first_grad_norm(state.optimizer, t, beta1)
                                        for t in leaves]
                if k == CHECKED_STEPS - 1:
                    captured["change"] = [float((t.detach() - s).norm())
                                          for t, s in zip(leaves, start)]
                    del start
            captured["loss"] = [float(x) for x in captured["loss"]]
            harness.sync(dev)
            out = Run(spec=ctx.spec)
            out.e2e["setup_s"] = time.perf_counter() - ctx.t_start
            ctx.log(f"[setup] {out.e2e['setup_s']:.3f} s: to the kernels "
                    f"{t_build - ctx.t_start:.3f}, pool and tree {t_pool - t_build:.3f}, "
                    f"weights and state {t_state - t_pool:.3f}, {tp['warm_steps']} steps "
                    f"{time.perf_counter() - t_state:.3f}")

            # the window
            stretch = Stretch() if ctx.trace else None
            t_from, t_n = tp["trace_from"], tp["trace_steps"]
            ends = [time.perf_counter()]
            waits, calls, step_mcs = [], [], []
            traced_mcs, t_stretch, timed = [], 0.0, []
            n = 0
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < ctx.seconds:
                tracing = stretch is not None and t_from <= n < t_from + t_n
                if stretch is not None and n == t_from:
                    stretch.start()
                    ts0 = time.perf_counter()
                host, _, w, c = one_step(tp["warm_steps"] + n)
                mc = [int(x) for x in np.asarray(host["present_mask"]).sum(1)]
                # a step's interval after the stretch holds the profiler's stop
                timed.append(not tracing and not (stretch is not None and n == t_from + t_n))
                if tracing:
                    traced_mcs.append(mc)
                else:
                    step_mcs.append(mc)
                    waits.append(w)
                    calls.append(c)
                ends.append(time.perf_counter())
                n += 1
                if stretch is not None and n == t_from + t_n:
                    stretch.stop()
                    t_stretch = time.perf_counter() - ts0
            harness.sync(dev)
            window = time.perf_counter() - t0
            if stretch is not None and stretch.prof is not None:
                stretch.stop()
                t_stretch = time.perf_counter() - ts0
        finally:
            loader.close()
        out.memory_peak_bytes = harness.peak_bytes(dev)
        out.attempted = n
        out.e2e["train_step_ms"] = 1e3 * window / n
        steps_ms = [1e3 * (b - a) for a, b, keep in zip(ends, ends[1:], timed) if keep]
        out.step_p95_ms = float(np.percentile(steps_ms, 95))
        out.host = {"input_wait": waits, "step_call": calls}
        if stretch is not None:
            out.stretch, out.stretch_units = stretch, len(traced_mcs)
            out.stretch_ops = [o for mc in traced_mcs for o in work.train_step(cfgd, mc)]
        out.untraced_s = window - t_stretch
        out.untraced_units = n - len(traced_mcs)
        out.untraced_ops = [o for mc in step_mcs for o in work.train_step(cfgd, mc)]
        ctx.log(f"[clocks] {harness.clock_line()}")
        ctx.log(f"[window] {n} steps in {window:.3f} s; buckets seen in set-up "
                f"{sorted(mcs_seen)}; peak memory {out.memory_peak_bytes} bytes")

        # the reference, once the program's state is freed
        del state, step_fn, frozen, to_device, leaves
        gc.collect()
        harness.free(dev)
        from benchmark.reference import drive
        t_ref = time.perf_counter()
        ref = drive.train_readings(cfgd | {"train": cfg_dict["train"]}, sd, fg, bg, values,
                                   pool, CHECKED_STEPS, dev, follow=captured)
        numbers = check.train_numbers(captured, ref)
        ctx.log(f"[reference] {time.perf_counter() - t_ref:.3f} s; losses program "
                f"{captured['loss']} reference {ref['loss']}")
        out.numbers = numbers
        ok, out.checks = check.verdict(numbers, ctx.cell["limits"])
        ctx.log("[numbers] " + " ".join(f"{k}={v!r}" for k, v in numbers.items()))
        out.failed = 0 if ok else CHECKED_STEPS
        return out
    finally:
        harness.remove(root)


def first_grad_norm(opt, leaf, beta1: float) -> float:
    """The norm of a leaf's first gradient as AdamW holds it after one step
    (its first moment over 1 - beta1); 0 where it holds none."""
    st = opt.state.get(leaf, {})
    return float(st["exp_avg"].norm()) / (1 - beta1) if "exp_avg" in st else 0.0
