"""Share of the bf16 self-attention forward calls (K1's first launch, K2)
run by the wgmma design (``csrc/hopper_attention.cu``) rather than the
mma.sync one, in percent, over the window's untraced batches before the
profiled stretch: the program's counter ``attention_fwd``
(``weclip_tpu_torch/ops/attention_kernels.py``; one count a bf16 forward
call, keyed ``wgmma`` or ``mma``, graph replays included).  Nothing from a
program without the counter."""


def read(run):
    try:
        from weclip_tpu_torch.utils import spans
    except ImportError:       # a program without the recorder
        return None
    recs = spans.before_profiled(spans.window(run.untraced_units + run.stretch_units))
    calls = wgmma = 0
    for r in recs:
        for (counter, key), n in r.keyed.items():
            if counter == "attention_fwd":
                calls += n
                wgmma += n if key == "wgmma" else 0
    if not calls:
        return None
    return 100.0 * wgmma / calls
