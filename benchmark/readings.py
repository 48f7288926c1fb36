"""The readings that the limits of the correctness check are set from.

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,3 [--control]

Without ``--control``: the cell's own runs, one a seed, each with a short
window (the numbers compared come from set-up's steps or from the sampled
batches, not from the window's length), all in one process; each prints
its numbers.  With ``--control``: the control, the plain reference put in
the program's place and computed one precision step lower (float8 e4m3 for
the bf16 products, TF32 for the fp32 ones), against the reference, on the
same inputs and as many steps or images as a run compares.  With
``--fault``: the cell's runs with a fault of ``faults.py`` planted.  It needs a
CUDA card, as the runs do; tests call ``control_numbers`` on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np

from benchmark import check, faults, harness, pool as pool_mod, weights, work
from benchmark.spec import Spec


def control_numbers(spec: Spec, cell_name: str, seed: int, device: str = "cuda") -> dict:
    """The control's numbers for one seed of ``cell_name``."""
    import torch

    from benchmark.reference import drive, precision

    cell = spec.workload(cell_name)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    cfg_dict = work.config_dict(config)
    num_fg = cfg_dict["dataset"]["num_classes"] - 1
    if device.startswith("cuda"):
        precision.strict_matmul()
    pool = pool_mod.make_pool(seed, traffic["pool_images"], traffic["sizes"],
                              traffic["classes_per_image"], num_fg, device)
    sd = weights.clip_state_dict(seed, cfg_dict["clip"], device, cfg_dict["tower"],
                                 cfg_dict["published"])
    fg, bg = weights.class_features(seed, num_fg, config["text"]["num_bg"],
                                    cfg_dict["clip"]["embed_dim"], device)
    shapes = [(p, tuple(t.shape)) for p, t in weights.leaf_paths(
        drive.weclip.init_trainable_params(torch.Generator().manual_seed(0),
                                           drive.from_dict(cfg_dict), "cpu"))]
    values = weights.trainable_values(seed, shapes, device)
    if traffic["mix"] == "train":
        d = json.loads(json.dumps(cfg_dict))
        d.setdefault("train", {})["seed"] = seed
        with precision.lower_precision():
            low = drive.train_readings(d, sd, fg, bg, values, pool, 3, device)
        ref = drive.train_readings(d, sd, fg, bg, values, pool, 3, device, follow=low)
        return check.train_numbers(low, ref)
    bsz = cfg_dict["eval"]["batch_images"]
    rng = np.random.default_rng([seed % (2 ** 63), 29])
    picks = rng.choice(64, size=traffic["checked_batches"], replace=False)
    batches = [[pool[(int(b) * bsz + j) % len(pool)] for j in range(bsz)] for b in picks]
    args = (cfg_dict, sd, fg, bg, values, batches, traffic["with_cam"], traffic["max_ori"],
            device)
    with precision.lower_precision():
        low = drive.eval_outputs(*args)
    follow = [rec["refined"] for rec in low] if traffic["with_cam"] else None
    ref = drive.eval_outputs(*args, follow=follow)
    for rec in low:
        rec["pred_msc"] = rec["msc"].argmax(1)
    patch = cfg_dict["clip"]["patch_size"]
    return check.eval_numbers(low, ref, patch, traffic["with_cam"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS),
                    help="plant this fault under the timed path of each run")
    args = ap.parse_args(argv)
    spec = Spec()
    from benchmark import run as run_mod
    run_mod.run_env(spec.folder.parent)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(f"[card] {harness.card_line()}", flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.control:
            numbers = control_numbers(spec, args.workload, seed)
        else:
            planted = faults.FAULTS[args.fault]() if args.fault else contextlib.nullcontext()
            with planted:
                run, _ = run_mod.measure(spec, args.workload, seed, args.seconds, False,
                                         t_start=time.perf_counter())
            numbers = dict(run.numbers, **run.e2e)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
