"""Mean host ms a training step spends in ``zero_grad`` and the loss's
backward (``backward``, a span in ``train/step.py::train_step``), over the
window's untraced steps before the profiled stretch (the program's span
records, ``weclip_tpu_torch/utils/spans.py``)."""


def read(run):
    try:
        from weclip_tpu_torch.utils import spans
    except ImportError:       # a program without the recorder
        return None
    recs = spans.before_profiled(spans.window(run.untraced_units + run.stretch_units))
    if not recs:
        return None
    names = ("backward",)
    return 1e3 * sum(r.host_s(names) for r in recs) / len(recs)
