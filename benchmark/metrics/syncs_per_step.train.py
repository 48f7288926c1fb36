"""Host-device synchronizations a step of the profiled stretch forces,
counted by the program's recorder while the profiler records
(``weclip_tpu_torch/utils/spans.py``: sync debug mode's warnings, by span
and source line)."""


def read(run):
    try:
        from weclip_tpu_torch.utils import spans
    except ImportError:       # a program without the recorder
        return None
    recs = spans.profiled(spans.window(run.untraced_units + run.stretch_units))
    if not recs or not run.stretch_units:
        return None
    return sum(r.count(spans.SYNC) for r in recs) / run.stretch_units
