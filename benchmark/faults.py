"""Faults planted under the timed path, to show that ``correct`` catches
them (``benchmark/tests/test_bench_faults.py`` on the CPU, ``python3 -m
benchmark.readings --fault <name>`` on the card).  Each is a context
manager that patches the port's module for the run and restores it."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def unchanged():
    """A training step that returns its state unchanged."""
    from weclip_tpu_torch.train import step
    make = step.make_train_step

    def make_frozen(*a, **k):
        inner = make(*a, **k)

        def train_step(state, *args, **kw):
            state.optimizer.step = lambda *x, **y: None
            return inner(state, *args, **kw)
        return train_step

    return _patched(step, "make_train_step", make_frozen)


def half_batch():
    """The training loss taken over half of the batch."""
    from weclip_tpu_torch.train import step
    losses = step.train_losses

    def half(cfg, out, pseudo, rmask, reduce=None):
        h = out.seg.shape[0] // 2
        return losses(cfg, type(out)(*(t[:h] for t in out)), pseudo[:h], rmask, reduce)

    return _patched(step, "train_losses", half)


def altered_answer():
    """Evaluation's scale-1 output altered where it is produced: one class's
    logits raised on a corner of the grid, and the CAM labels of a corner
    moved to the next class."""
    from weclip_tpu_torch.evalx import runner
    make = runner.make_eval_scale1

    def make_altered(cfg, *a, **k):
        inner = make(cfg, *a, **k)
        k_cls = cfg.dataset.num_classes

        def scale1(*args):
            seg_single, seg_avg, cam = inner(*args)
            seg_avg = seg_avg.clone()
            seg_avg[:, 1, :2, :2] += 10.0
            cam = cam.clone()
            cam[:, :16, :16] = (cam[:, :16, :16] + 1) % k_cls
            return seg_single, seg_avg, cam
        return scale1

    return _patched(runner, "make_eval_scale1", make_altered)


def half_hists():
    """Half of each evaluation batch left out of the histograms."""
    from weclip_tpu_torch.evalx import runner
    make = runner.make_eval_combine

    def make_half(*a, **k):
        inner = make(*a, **k)

        def combine(seg_single, seg_avg1, seg_avg2, cam, labels, sizes, hists):
            labels = labels.clone()
            labels[labels.shape[0] // 2:] = 255
            return inner(seg_single, seg_avg1, seg_avg2, cam, labels, sizes, hists)
        return combine

    return _patched(runner, "make_eval_combine", make_half)


def _acts_and_grads_altered(alter):
    from weclip_tpu_torch.cam import gradcam
    inner = gradcam.acts_and_grads

    def altered(*args, **kw):
        return alter(*inner(*args, **kw))

    return _patched(gradcam, "acts_and_grads", altered)


def gradcam_rows_shifted():
    """GradCAM's backward (K3 over the class rows expanded onto the batch)
    writing each row's gradient into the next row."""
    def alter(a0, grads, attn, probs):
        b, mc = grads.shape[:2]
        rows = grads.reshape(b * mc, *grads.shape[2:]).roll(1, dims=0)
        return a0, rows.reshape(grads.shape), attn, probs

    return _acts_and_grads_altered(alter)


def map_transposed():
    """K1's head-mean map of block 11 written as (key, query)."""
    return _acts_and_grads_altered(
        lambda a0, grads, attn, probs: (a0, grads, attn.transpose(1, 2), probs))


def par_iteration_short():
    """PAR (K4 and K5) run one Jacobi iteration short in the pseudo-label
    chain."""
    import dataclasses

    from weclip_tpu_torch.models import weclip
    inner = weclip.par_refine_auto

    def short(imgs, masks, cfg):
        return inner(imgs, masks, dataclasses.replace(cfg, num_iter=cfg.num_iter - 1))

    return _patched(weclip, "par_refine_auto", short)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered_answer": altered_answer, "half_hists": half_hists,
          "gradcam_rows_shifted": gradcam_rows_shifted, "map_transposed": map_transposed,
          "par_iteration_short": par_iteration_short}
