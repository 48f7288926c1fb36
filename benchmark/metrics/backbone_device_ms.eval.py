"""Mean device ms an evaluation batch spends in the frozen ViT forward
(span ``backbone``, both scales, timed on the card by a CUDA event pair on
the current stream), over the window's untraced batches before the profiled
stretch (the program's span records, ``weclip_tpu_torch/utils/spans.py``).
Nothing from a program whose records hold no device time."""


def read(run):
    try:
        from weclip_tpu_torch.utils import spans
    except ImportError:       # a program without the recorder
        return None
    recs = spans.before_profiled(spans.window(run.untraced_units + run.stretch_units))
    got = [getattr(r, "device_s", lambda names: None)(("backbone",)) for r in recs]
    got = [s for s in got if s is not None]
    if not got:
        return None
    return 1e3 * sum(got) / len(got)
