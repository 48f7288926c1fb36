"""Mean host ms an evaluation batch spends in scale 2 (``eval.scale2``, a
span in ``evalx/runner.py::Evaluator.run``), over the window's untraced
batches before the profiled stretch (the program's span records,
``weclip_tpu_torch/utils/spans.py``)."""


def read(run):
    try:
        from weclip_tpu_torch.utils import spans
    except ImportError:       # a program without the recorder
        return None
    recs = spans.before_profiled(spans.window(run.untraced_units + run.stretch_units))
    if not recs:
        return None
    names = ("eval.scale2",)
    return 1e3 * sum(r.host_s(names) for r in recs) / len(recs)
