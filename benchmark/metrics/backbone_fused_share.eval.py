"""Share of the frozen ViT blocks run by the fused path
(``vit.frozen_block_forward``: bf16 weights cast once, three fused
elementwise passes), in percent, over the window's untraced batches before
the profiled stretch: the program's counter ``backbone_block``
(``weclip_tpu_torch/models/clip/vit.py``; one count a frozen block a
forward, keyed ``fused`` or ``plain``, graph replays included).
Nothing from a program without the counter."""


def read(run):
    try:
        from weclip_tpu_torch.utils import spans
    except ImportError:       # a program without the recorder
        return None
    recs = spans.before_profiled(spans.window(run.untraced_units + run.stretch_units))
    blocks = fused = 0
    for r in recs:
        for (counter, key), n in r.keyed.items():
            if counter == "backbone_block":
                blocks += n
                fused += n if key == "fused" else 0
    if not blocks:
        return None
    return 100.0 * fused / blocks
