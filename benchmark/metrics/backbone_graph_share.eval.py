"""Share of the frozen ViT forward's calls (``backbone``) served by a CUDA
graph's replay, in percent, over the window's untraced batches before the
profiled stretch: the program's counter ``backbone_graph``
(``weclip_tpu_torch/models/clip/graphs.py``; keys ``eager``, ``capture``,
``replay``, ``fallback``).  Nothing from a program without the counter."""


def read(run):
    try:
        from weclip_tpu_torch.utils import spans
    except ImportError:       # a program without the recorder
        return None
    recs = spans.before_profiled(spans.window(run.untraced_units + run.stretch_units))
    calls = replays = 0
    for r in recs:
        for (counter, key), n in r.keyed.items():
            if counter == "backbone_graph":
                calls += n
                replays += n if key == "replay" else 0
    if not calls:
        return None
    return 100.0 * replays / calls
